from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config

__all__ = ["MLAConfig", "ModelConfig", "ARCH_IDS", "get_config"]
