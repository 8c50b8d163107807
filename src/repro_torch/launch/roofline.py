"""Three-term roofline of a counted program (the port of
``repro/launch/roofline.py``):

  compute_term    = sum over FLOP types of FLOPs per device / that type's
                    peak FLOP/s
  memory_term     = HBM bytes per device / HBM bandwidth
  collective_term = per-device collective wire bytes / link bandwidth

The counts come from ``launch/op_costs.py`` (per device, counted as the
program runs). Each collective is priced as ring-algorithm wire traffic
from its result bytes b and its group size g:

  all-gather         b * (g-1)/g
  reduce-scatter     b * (g-1)          (operand = g * result)
  all-reduce         2 * b * (g-1)/g
  all-to-all         b * (g-1)/g
  collective-permute b

Hardware model: one NVIDIA H100 SXM5 at NVIDIA's data-sheet peaks, which
assume its 700 W power limit (a card held to a lower limit runs slower
under load): dense, without sparsity, 989 TFLOP/s in bf16 and fp16 and
1,979 in fp8 and int8 on the tensor cores, 495 TFLOP/s in TF32 (float32
products with TF32 allowed), 67 TFLOP/s in float32 on the CUDA cores;
3.35 TB/s HBM3; 450 GB/s NVLink 4 each way. ``launch/op_costs.py`` sums
the FLOPs by type (``FLOP_TYPES``: a product by its operands' dtype, an
attention kernel's as float32), and each sum is priced at its own
peak. One link rate serves every mesh axis, as the
reference keeps one: a 16-wide 'model' axis spans two hosts of eight
cards, where the inter-host network is slower than NVLink, and the 'pod'
and 'data' axes cross hosts too, so the collective term is a lower bound
for those axes.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = {"bf16": 989e12, "fp8": 1979e12, "int8": 1979e12,
              "tf32": 495e12, "float32": 67e12}
HBM_BW = 3.35e12
LINK_BW = 450e9


def wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Ring wire bytes of one collective of ``result_bytes`` over
    ``group`` ranks (0 for a group of one)."""
    b, g = float(result_bytes), int(group)
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return b * (g - 1) / g
    if kind == "reduce-scatter":
        return b * (g - 1)
    if kind == "all-reduce":
        return 2 * b * (g - 1) / g
    if kind == "all-to-all":
        return b * (g - 1) / g
    if kind == "collective-permute":
        return b
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    step_s: float
    model_flops: float
    useful_flops_ratio: float
    coll_breakdown: dict
    transcendental_elems: float = 0.0

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(counts: dict, *, model_flops_per_device: float = 0.0) -> Roofline:
    """The roofline of ``counts`` (``OpCounter.totals()``; FLOPs with no
    ``flops_by_type`` are priced as bf16)."""
    flops, hbm, coll = counts["flops"], counts["bytes"], counts["coll"]
    by_type = dict(counts.get("flops_by_type") or {"bf16": flops})
    terms = {
        "compute": sum(f / PEAK_FLOPS[t] for t, f in by_type.items()),
        "memory": hbm / HBM_BW,
        "collective": coll / LINK_BW,
    }
    bottleneck = max(terms, key=terms.get)
    return Roofline(
        flops=flops,
        hbm_bytes=hbm,
        coll_bytes=coll,
        compute_s=terms["compute"],
        memory_s=terms["memory"],
        collective_s=terms["collective"],
        bottleneck=bottleneck,
        step_s=max(terms.values()),
        model_flops=model_flops_per_device,
        useful_flops_ratio=(model_flops_per_device / flops) if flops else 0.0,
        coll_breakdown=dict(counts["coll_breakdown"]),
        transcendental_elems=counts.get("transcendental_elems", 0.0),
    )


def model_flops_per_device(cfg, shape, n_devices: int) -> float:
    """MODEL_FLOPS = 6*N*D (train, N=active params, D=tokens) or 2*N*D
    (inference fwd) + attention KV term for decode, per device."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence + KV-cache attention reads
        tokens = shape.global_batch
        hd = cfg.resolved_head_dim()
        attn_layers = sum(1 for k in cfg.pattern_for() if k == "attn") \
            if not cfg.encoder_layers else cfg.decoder_layers
        span = min(shape.seq_len, cfg.window) if cfg.window else shape.seq_len
        kv_flops = 4.0 * attn_layers * cfg.num_heads * hd * span * tokens
        total = 2.0 * n_active * tokens + kv_flops
    return total / n_devices
