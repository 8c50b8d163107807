"""The port's roofline machinery against ``repro``'s: the model FLOPs of
every arch x cell x mesh float for float, the collectives' wire bytes
against ``repro.launch.roofline.collective_bytes`` on matching HLO lines,
and the op counter (``launch/op_costs.py``) by ``tests/test_roofline.py``'s
three checks in torch (a loop of matmuls, nested loops, a checkpointed
backward), then per device: a DTensor product on a fake 16 x 16 mesh
counts 1/256 of the global FLOPs and the collective its redistribution
needs.
"""
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro_torch.configs import ARCH_IDS, cells_for, get_config  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.op_costs import OpCounter  # noqa: E402


def _flops(fn, *args):
    with OpCounter() as c:
        fn(*args)
    return c.totals()["flops"]


# ---------------------------------------------------------------------------
# the model FLOPs and the wire formulas
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_repro(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape in cells_for(arch):
        for n in (256, 512):
            assert roofline.model_flops_per_device(cfg, shape, n) == \
                ref_roofline.model_flops_per_device(rcfg, shape, n), \
                (shape.name, n)


@pytest.mark.parametrize("kind,hlo", [
    ("all-gather", "all-gather(bf16[1,1024]{1,0} %p)"),
    ("reduce-scatter", "reduce-scatter(bf16[256,1024]{1,0} %p)"),
    ("all-reduce", "all-reduce(bf16[16,1024]{1,0} %p)"),
    ("all-to-all", "all-to-all(bf16[16,1024]{1,0} %p)"),
    ("collective-permute", "collective-permute(bf16[16,1024]{1,0} %p)"),
])
@pytest.mark.parametrize("group", [2, 16])
def test_wire_bytes_match_repro(kind, hlo, group):
    result = 16 * 1024 * 2        # bf16[16,1024]
    line = (f"  %c = bf16[16,1024]{{1,0}} {hlo}, "
            f"replica_groups=[{256 // group},{group}]<=[256]")
    total, breakdown = ref_roofline.collective_bytes(line)
    assert breakdown == {kind: total}
    assert roofline.wire_bytes(kind, result, group) == total


def test_hardware_model_is_one_h100():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        {"bf16": 989e12, "fp8": 1979e12, "int8": 1979e12, "tf32": 495e12,
         "float32": 67e12}, 3.35e12, 450e9)
    rf = roofline.analyze({"flops": 989e12, "bytes": 6.7e12, "coll": 45e9,
                           "coll_breakdown": {"all-gather": 45e9}},
                          model_flops_per_device=494.5e12)
    assert (rf.compute_s, rf.memory_s, rf.collective_s) == (1.0, 2.0, 0.1)
    # each type's FLOPs at its own peak: 1 s of bf16 and 3 s of float32
    typed = roofline.analyze({"flops": 989e12 + 201e12, "bytes": 0.0,
                              "coll": 0.0, "coll_breakdown": {},
                              "flops_by_type": {"bf16": 989e12,
                                                "float32": 201e12}})
    assert typed.compute_s == 1.0 + 201e12 / 67e12
    assert typed.bottleneck == "compute"
    assert rf.bottleneck == "memory" and rf.step_s == 2.0
    assert rf.useful_flops_ratio == 0.5
    assert set(rf.to_dict()) == set(ref_roofline.Roofline(
        0, 0, 0, 0, 0, 0, "", 0, 0, 0, {}).to_dict())


# ---------------------------------------------------------------------------
# the counter, by test_roofline.py's three checks
# ---------------------------------------------------------------------------
def test_looped_matmul_counts_each_trip():
    w, x = torch.randn(256, 256), torch.randn(256, 256)

    def looped(w, x):
        for _ in range(7):
            x = x @ w
        return x

    assert _flops(looped, w, x) == 7 * _flops(lambda w, x: x @ w, w, x)


def test_nested_loops_count_exactly():
    w, x = torch.randn(128, 128), torch.randn(128, 128)

    def nested(w, x):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    assert _flops(nested, w, x) == 12 * 2 * 128 ** 3


def test_checkpoint_backward_counts_recompute():
    w = torch.randn(128, 128, requires_grad=True)
    x = torch.randn(8, 128)

    def body(c):
        return torch.tanh(c @ w)

    def loss(w, x):
        for _ in range(6):
            x = checkpoint(body, x, use_reentrant=False)
        return x.sum()

    fwd = _flops(loss, w, x)
    bwd = _flops(lambda w, x: torch.autograd.grad(loss(w, x), w), w, x)
    assert bwd >= 2.5 * fwd, (fwd, bwd)


def test_looped_step_counts_its_trip_count():
    """``launch/op_costs.py:looped``: one step standing for n, forward and
    backward (the trip-count counting of the reference's HLO loops)."""
    from repro_torch.launch.op_costs import looped

    w = torch.randn(32, 32, requires_grad=True)
    x = torch.randn(4, 32, requires_grad=True)

    def step(h, w):
        return (torch.tanh(h @ w),)

    with OpCounter() as c:
        (y,) = looped(step, 9, x, w)
        fwd = c.totals()["flops"]
        y.sum().backward()
    assert fwd == 9 * 2 * 4 * 32 * 32
    assert c.totals()["flops"] == 3 * fwd      # dx and dw, each 9 times
    assert w.grad.shape == w.shape and x.grad.shape == x.shape


def test_counter_counts_bytes_and_transcendentals():
    x = torch.randn(64, 32)
    with OpCounter() as c:
        y = torch.exp(x)
        torch.softmax(y, dim=-1)
    t = c.totals()
    assert t["transcendental_elems"] == 2 * 64 * 32
    assert t["bytes"] == 4 * (64 * 32 * 2) * 2      # two ops, in and out
    assert t["coll"] == 0 and t["collectives"] == []


def test_counter_sums_flops_by_type(monkeypatch):
    """Each product's FLOPs under its operands' type (float32 as TF32 only
    where TF32 is allowed), an attention call's as float32, and the
    roofline prices each sum at its own peak."""
    from repro_torch.kernels import costs

    x, w = torch.randn(16, 32), torch.randn(32, 8)
    one = 2 * 16 * 32 * 8
    with OpCounter() as c:
        x @ w
        x.bfloat16() @ w.bfloat16()
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        x @ w
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
        costs.record_call("flash", flops=100.0, bytes=0.0)
    t = c.totals()
    assert t["flops_by_type"] == {"float32": one + 100.0, "bf16": one,
                                  "tf32": one}
    assert t["flops"] == 3 * one + 100.0
    rf = roofline.analyze(t)
    assert rf.compute_s == ((one + 100.0) / 67e12 + one / 989e12
                            + one / 495e12)


def test_counter_moves_no_number():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(33, 65, generator=g)
    w = torch.randn(65, 17, generator=g)
    plain = torch.tanh(x @ w).softmax(-1)
    with OpCounter():
        counted = torch.tanh(x @ w).softmax(-1)
    assert torch.equal(plain, counted)


# ---------------------------------------------------------------------------
# per device, on a fake 16 x 16 mesh
# ---------------------------------------------------------------------------
def test_dtensor_product_counts_per_device():
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import make_production_mesh

    fake_process_group(256)
    try:
        mesh = make_production_mesh()
        x = DTensor.from_local(
            torch.empty(8192 // 16, 896 // 16, device="meta"), mesh,
            (Shard(0), Shard(1)), run_check=False)
        w = DTensor.from_local(torch.empty(896, 4864 // 16, device="meta"),
                               mesh, (Replicate(), Shard(1)),
                               run_check=False)
        with OpCounter() as c:
            y = x @ w
        t = c.totals()
    finally:
        dist.destroy_process_group()
    assert tuple(y.shape) == (8192, 4864)
    assert t["flops"] == 2 * 8192 * 896 * 4864 / 256
    assert t["collectives"], "the redistribution's collective"
    assert t["coll"] > 0 and all(g == 16 for _, _, g in t["collectives"])
