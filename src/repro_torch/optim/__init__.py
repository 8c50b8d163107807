from repro_torch.optim.adamw import adamw
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["adamw", "clip_by_global_norm", "cosine_schedule"]
