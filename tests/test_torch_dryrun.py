"""The port's dry-run path on the CPU: the attention wrappers' ``meta``
routes (the right shapes, the analytic cost reported, no plain tile loop),
the flash backward priced on ``meta``, ``constrain`` as the identity off
a mesh, and ``tests/test_roofline.py``'s small-mesh dry run in torch:
qwen2-0.5b smoke on a (4, 2) mesh over a fake process group, 8 x 64
tokens, train, prefill and decode (and kimi's MoE, xlstm's scan and
seamless's decode likewise), its JSON rendered by
``benchmarks/roofline_table.py:fmt_row``. The dry run goes in a
subprocess, so that no process group outlives the test.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.core import attention as core_attention  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels.decode import decode as decode_mod  # noqa: E402
from repro_torch.kernels.decode.ops import (  # noqa: E402
    decode_attention,
    fused_paged_decode_attention,
)
from repro_torch.kernels.flash import flash as flash_mod  # noqa: E402
from repro_torch.kernels.flash import prefill as prefill_mod  # noqa: E402
from repro_torch.kernels.flash.ops import (  # noqa: E402
    flash_attention_fwd,
    fused_paged_prefill_attention,
    prefill_attention,
)
from repro_torch.sharding.constraints import (  # noqa: E402
    constrain,
    gather_fsdp,
    model_axis_size,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, HKV, D, DV, S, C, PS = 2, 8, 2, 64, 64, 256, 16, 16


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def calls(monkeypatch):
    """Record the reported calls; make every plain version raise."""
    seen = []
    monkeypatch.setattr(costs, "COST_SINKS",
                        [lambda name, **kw: seen.append((name, kw))])

    def refuse(*a, **k):
        raise AssertionError("a meta call ran a plain version")

    for mod, name in ((flash_mod, "flash_fwd_plain"),
                      (decode_mod, "decode_fwd_plain"),
                      (decode_mod, "paged_decode_fwd_plain"),
                      (prefill_mod, "prefill_fwd_plain"),
                      (prefill_mod, "paged_prefill_fwd_plain"),
                      (flash_mod, "online_softmax_tile"),
                      (core_attention, "flash_ref")):
        monkeypatch.setattr(mod, name, refuse)
    return seen


def _flops(heads, q, kv, dq=D, dv=DV):
    return costs.analytic_attention_flops(q, kv, heads=heads, d_qk=dq,
                                          d_v=dv)


def test_flash_meta_route(calls):
    out = flash_attention_fwd(_meta(B, H, S, D), _meta(B, HKV, S, D),
                              _meta(B, HKV, S, D), block_k=512)
    assert out.device.type == "meta" and tuple(out.shape) == (B, H, S, D)
    assert out.dtype == torch.bfloat16
    (name, kw), = calls
    assert name == "flash" and kw["flops"] == B * _flops(H, S, S)
    assert kw["bytes"] == 2 * (2 * B * H * S * D + 2 * B * HKV * S * D)


def test_decode_meta_routes(calls):
    lengths = _meta(B, dtype=torch.int32)
    out = decode_attention(_meta(B, H, D), _meta(B, HKV, S, D),
                           _meta(B, HKV, S, DV), lengths)
    assert tuple(out.shape) == (B, H, DV)
    pool = _meta(64 * PS, HKV, D)
    bt = _meta(B, 8, dtype=torch.int32)
    out = fused_paged_decode_attention(_meta(B, H, D), pool, pool, bt,
                                       lengths, page_size=PS)
    assert tuple(out.shape) == (B, H, D)
    assert [n for n, _ in calls] == ["decode", "paged_decode"]
    assert calls[0][1]["flops"] == B * _flops(H, 1, S)
    assert calls[1][1]["flops"] == B * _flops(H, 1, 8 * PS)


def test_prefill_meta_routes(calls):
    lengths = _meta(B, dtype=torch.int32)
    q, kn = _meta(B, H, C, D), _meta(B, HKV, C, D)
    out = prefill_attention(q, _meta(B, HKV, S, D), _meta(B, HKV, S, D), kn,
                            kn, lengths, lengths)
    assert tuple(out.shape) == (B, H, C, DV)
    pool = _meta(64 * PS, HKV, D)
    out = fused_paged_prefill_attention(q, kn, kn, pool, pool,
                                        _meta(B, 8, dtype=torch.int32),
                                        lengths, lengths, page_size=PS)
    assert tuple(out.shape) == (B, H, C, D)
    assert [n for n, _ in calls] == ["prefill", "paged_prefill"]
    assert calls[0][1]["flops"] == B * _flops(H, C, S + C)
    assert calls[1][1]["flops"] == B * _flops(H, C, 8 * PS + C)


def test_flash_backward_priced_on_meta(calls):
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-0.5b", smoke=True)
    q = _meta(B, H, S, D).requires_grad_(True)
    k = _meta(B, HKV, S, D).requires_grad_(True)
    v = _meta(B, HKV, S, D).requires_grad_(True)
    o = core_attention.attention(q, k, v, cfg)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert [tuple(t.shape) for t in (dq, dk, dv)] == \
        [tuple(q.shape), tuple(k.shape), tuple(v.shape)]
    assert [n for n, _ in calls] == ["flash", "flash_backward"]
    assert calls[1][1]["flops"] == 3 * calls[0][1]["flops"]


def test_constrain_is_the_identity_off_a_mesh():
    x = torch.randn(4, 8, 16)
    assert constrain(x, "batch", "model", None) is x
    assert model_axis_size() == 0
    tree = {"w": torch.randn(3, 3)}
    assert gather_fsdp(tree) is tree

    from repro_torch.launch.mesh import set_mesh

    with set_mesh(object()):     # a mesh, but a plain tensor
        assert constrain(x, "batch", None, None) is x


def test_refused_view_is_resharded_and_counted():
    """A view DTensor refuses (an uneven unflatten here) is redistributed
    and viewed again, the gather counted."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.op_costs import OpCounter
    from repro_torch.sharding.layouts import FixedLayouts

    fake_process_group(8)
    try:
        mesh = make_debug_mesh(4, 2)
        x = DTensor.from_local(_meta(1, 28), mesh, (Shard(0), Shard(1)),
                               run_check=False)
        with pytest.raises(RuntimeError):
            x.view(4, 7, 8)
        with OpCounter() as c, FixedLayouts() as views:
            y = x.view(4, 7, 8)
    finally:
        dist.destroy_process_group()
    assert tuple(y.shape) == (4, 7, 8) and views.resharded == 1
    assert c.totals()["collectives"] == [("all-gather", 1 * 56 * 2, 2)]


_SMALL = r"""
import json, sys
sys.path.insert(0, "benchmarks")
from roofline_table import fmt_row
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.dryrun import lower_cell
import torch.distributed as dist
out = {}
for arch, kind in CELLS:
    counts, meta = lower_cell(arch, kind, multi_pod=False, smoke=True,
                              shape=ShapeSpec(kind, 64, 8, kind),
                              debug_mesh=(4, 2))
    assert not dist.is_initialized()
    out[arch + " " + kind] = dict(meta=meta, row=fmt_row(meta),
                                  calls=counts["attention_calls"],
                                  n_coll=len(counts["collectives"]))
print("SMALL_DRYRUN " + json.dumps(out))
"""
# qwen2-0.5b as tests/test_roofline.py's; kimi's MoE (balanced, scatter),
# xlstm's looped sLSTM scan and seamless's encoder-decoder decode too
CELLS = [("qwen2-0.5b", "train"), ("qwen2-0.5b", "prefill"),
         ("qwen2-0.5b", "decode"), ("kimi-k2-1t-a32b", "train"),
         ("kimi-k2-1t-a32b", "decode"), ("xlstm-1.3b", "train"),
         ("seamless-m4t-medium", "decode")]
CALLS = {"train": {"flash": 4, "flash_backward": 2}, "prefill": {"flash": 2},
         "decode": {"decode": 2}}


@pytest.fixture(scope="module")
def small_dryrun():
    r = subprocess.run(
        [sys.executable, "-c", f"CELLS = {CELLS!r}\n" + _SMALL],
        capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    line = [s for s in r.stdout.splitlines() if s.startswith("SMALL_DRYRUN")]
    assert line, r.stdout + r.stderr
    return json.loads(line[0].split(" ", 1)[1])


@pytest.mark.parametrize("arch,kind", CELLS)
def test_dryrun_roofline_small_mesh(small_dryrun, arch, kind):
    cell = small_dryrun[f"{arch} {kind}"]
    meta, rf = cell["meta"], cell["meta"]["roofline"]
    assert meta["kind"] == kind and meta["mesh"] == "4x2"
    assert meta["n_devices"] == 8 and meta["compile_s"] == 0.0
    assert rf["flops"] > 0 and rf["hbm_bytes"] > 0
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    assert rf["step_s"] == max(rf["compute_s"], rf["memory_s"],
                               rf["collective_s"])
    assert cell["n_coll"] > 0
    bpd = meta["bytes_per_device"]
    assert bpd["arguments"] > 0 and bpd["peak_estimate"] >= bpd["arguments"]
    assert set(meta) >= {"arch", "shape", "kind", "mesh", "n_devices",
                         "variant", "moe_impl", "params", "active_params",
                         "lower_s", "compile_s", "bytes_per_device",
                         "roofline"}
    assert cell["row"].startswith(arch)
    if arch == "xlstm-1.3b":          # no attention layer
        assert cell["calls"] == {}
    elif arch == "seamless-m4t-medium":   # 2 decoder layers' self-attention
        assert cell["calls"] == {"decode": 2}
    else:
        assert cell["calls"] == CALLS[kind]
