"""Assigned input-shape set (same four cells for every LM-family arch).

``train_*`` lowers train_step; ``prefill_*`` lowers the forward pass;
``decode_*`` / ``long_*`` lower serve_step (one token against a KV cache of
seq_len). ``long_500k`` requires sub-quadratic sequence mixing and is run
only for the SSM/hybrid archs (DESIGN.md §4).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# archs whose sequence mixing is O(1)-state for decode (run long_500k)
SUBQUADRATIC_ARCHS = ("recurrentgemma-2b", "xlstm-1.3b")


def cells_for(arch: str):
    """The (arch x shape) cells this arch participates in."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in SUBQUADRATIC_ARCHS:
        names.append("long_500k")
    return [SHAPES[n] for n in names]
