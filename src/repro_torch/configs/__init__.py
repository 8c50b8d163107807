from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config

__all__ = ["ModelConfig", "ARCH_IDS", "get_config"]
