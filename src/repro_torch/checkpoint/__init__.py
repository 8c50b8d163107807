from repro_torch.checkpoint.restore import latest_step, restore_checkpoint
from repro_torch.checkpoint.save import AsyncCheckpointer, save_checkpoint

__all__ = ["save_checkpoint", "AsyncCheckpointer", "restore_checkpoint",
           "latest_step"]
