from repro_torch.distributed.compression import (
    error_feedback_int8,
    error_feedback_topk,
    init_residuals,
    int8_compress,
    int8_decompress,
    topk_compress,
)
from repro_torch.distributed.fault import StragglerWatchdog, TrainSupervisor
from repro_torch.distributed.pipeline import pipeline_forward

__all__ = [
    "StragglerWatchdog",
    "TrainSupervisor",
    "error_feedback_int8",
    "error_feedback_topk",
    "init_residuals",
    "int8_compress",
    "int8_decompress",
    "pipeline_forward",
    "topk_compress",
]
