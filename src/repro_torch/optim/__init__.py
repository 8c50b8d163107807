from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = ["adafactor", "adamw", "clip_by_global_norm", "cosine_schedule",
           "linear_warmup"]
