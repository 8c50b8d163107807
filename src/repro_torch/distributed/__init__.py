from repro_torch.distributed.compression import (
    error_feedback_int8,
    error_feedback_topk,
    init_residuals,
    int8_compress,
    int8_decompress,
    topk_compress,
)

__all__ = [
    "error_feedback_int8",
    "error_feedback_topk",
    "init_residuals",
    "int8_compress",
    "int8_decompress",
    "topk_compress",
]
