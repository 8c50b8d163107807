from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro_torch.configs.registry import ARCH_IDS, get_config

__all__ = ["MLAConfig", "ModelConfig", "MoEConfig", "ARCH_IDS", "get_config"]
