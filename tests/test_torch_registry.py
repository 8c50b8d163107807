"""The port's attention backend registry (``repro_torch.kernels.registry``)
against ``repro``'s.

* ``resolved_backends`` over a grid of ``impl`` x {no serving impl named,
  each decode / prefill / paged impl of ``repro``'s tables} x ``kv_dtype``
  x ``paged``: the ``kind`` and ``requested`` columns equal ``repro``'s,
  and so does ``resolved``, but where the port declares its ``kernel``
  route (``pallas`` -> ``kernel``).
* ``attention_impls()`` holds every name of ``repro``'s; an unknown name
  raises a ``ValueError`` that lists the registered ones.
* Every entry the port adds under a ``repro`` name runs, on one small
  shape per table, against ``repro``'s entry of that name, through both
  registries' ``dispatch_*``: ``ref`` and ``flash_jnp`` (full sequence),
  ``masked_xla`` (prefill), ``xla`` (decode), ``gather_xla`` and
  ``gather_pallas`` (both paged tables), each at fp32 and int8 (its
  ``_q`` form), exact and ExpMul. ``repro``'s ``gather_pallas`` runs its
  contiguous Pallas kernels in interpret mode, as its own tests run them;
  the port's runs the contiguous kernels' plain versions (CPU tensors) on
  a gathered copy. Tolerance 1e-4 (``tests/cells.py``'s fp32 bound, and
  ``tests/test_conformance.py``'s pair bound): the same routes over the
  same operands differ only by float summation order.
* The dispatch counters count one registry call once, under the route's
  label, however many wrappers it reaches.
* A subprocess imports the new modules and finds neither ``jax`` nor
  ``repro`` in ``sys.modules``.
"""
import itertools
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.attention  # noqa: E402,F401
import repro.kernels.kvquant  # noqa: E402,F401
from repro.kernels import registry as jreg  # noqa: E402
from repro.kernels.paged import slot_rows as jslot_rows  # noqa: E402
from repro.numerics.quant import QuantKV as JQuantKV  # noqa: E402
from repro.numerics.quant import quantize_kv as jquantize  # noqa: E402
from repro_torch.kernels import build, registry as treg  # noqa: E402
from repro_torch.kernels.paged import slot_rows  # noqa: E402
from repro_torch.numerics.quant import QuantKV, quantize_kv  # noqa: E402
from repro_torch.serve.metrics import (  # noqa: E402
    MetricsRegistry,
    install_dispatch_counters,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
B, H, HKV, D = 2, 4, 2, 16
S, C, PS = 16, 8, 4


# -- resolution -------------------------------------------------------------

SERVING = ([{}]
           + [{"decode_impl": n} for n in ("xla", "pallas")]
           + [{"prefill_impl": n} for n in ("masked_xla", "pallas")]
           + [{"paged_impl": n} for n in ("gather_xla", "gather_pallas",
                                          "pallas")])
GRID = list(itertools.product(("ref", "flash_jnp", "pallas"), SERVING,
                              ("fp32", "int8", "fp8"), (False, True)))


@pytest.mark.parametrize("impl,named,kv_dtype,paged", GRID)
def test_resolved_backends_match_repro(impl, named, kv_dtype, paged):
    kw = dict(impl=impl, kv_dtype=kv_dtype, **named)
    ours = treg.resolved_backends(treg.AttentionSpec(**kw), paged=paged)
    theirs = jreg.resolved_backends(jreg.AttentionSpec(**kw), paged=paged)
    assert [(r["kind"], r["requested"]) for r in ours] == \
        [(r["kind"], r["requested"]) for r in theirs]
    for o, t in zip(ours, theirs):
        if o["resolved"] != t["resolved"]:
            # the port's declared kernel route, reported as a fallback
            assert t["resolved"].removesuffix("_q") == "pallas"
            assert o["resolved"] == t["resolved"].replace("pallas", "kernel")
            assert o["fallback"]
        else:
            assert not o["fallback"]


def _builtin(table):
    """The names ``repro``'s own modules register in ``table`` (a test
    helper may register more)."""
    return {n for n, fn in table.items() if fn.__module__.startswith("repro.")}


def test_names_cover_repro_and_unknown_raises():
    assert _builtin(jreg._ATTENTION_IMPLS) <= set(jreg.attention_impls())
    assert _builtin(jreg._ATTENTION_IMPLS) <= set(treg.attention_impls())
    for table in ("_PREFILL_IMPLS", "_DECODE_IMPLS", "_PAGED_PREFILL_IMPLS",
                  "_PAGED_DECODE_IMPLS"):
        assert _builtin(getattr(jreg, table)) <= set(getattr(treg, table))
    spec = treg.AttentionSpec(impl="no_such_impl")
    with pytest.raises(ValueError, match="registered: .*flash_jnp"):
        treg.dispatch_attention(spec, *(torch.zeros(1, 1, 2, 16),) * 3)
    with pytest.raises(ValueError, match="gather_pallas"):
        treg.check_spec(treg.AttentionSpec(paged_impl="nope"), paged=True)
    # a registered name of another table is unknown in this one
    with pytest.raises(ValueError, match="unknown decode"):
        treg.check_spec(treg.AttentionSpec(decode_impl="masked_xla"))


def test_config_names_and_labels():
    from repro_torch.configs.base import ATTENTION_IMPLS
    assert set(ATTENTION_IMPLS) == {
        n for n in treg.attention_impls() if not n.endswith("_q")}
    assert treg.route_label("paged decode", "pallas_q") == "kernel"
    assert treg.route_label("decode", "plain") == "plain"
    assert treg.route_label("paged prefill", "gather_pallas_q") == \
        "gather_pallas"


# -- entries against repro's ------------------------------------------------

def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _kv(arr_t, arr_j, kv_dtype):
    """The same values as a port operand and a repro operand (codes and
    scales from each package's bit-exact codec when quantized)."""
    if kv_dtype == "fp32":
        return torch.from_numpy(arr_t), jnp.asarray(arr_j)
    tq = quantize_kv(torch.from_numpy(arr_t), kv_dtype)
    jq = jquantize(jnp.asarray(arr_j), kv_dtype)
    return QuantKV(tq.codes, tq.scale), JQuantKV(jq.codes, jq.scale)


def _pair(rng, kv_dtype, *shape):
    a = _np(rng, *shape)
    return _kv(a, a, kv_dtype)


def _tables(rng):
    """Block tables of a pool of shuffled pages (sentinel past each row's
    pages), as int32 numpy."""
    mb = S // PS
    nblk = B * mb + 2
    perm = rng.permutation(nblk)[:B * mb].reshape(B, mb).astype(np.int32)
    perm[0, 3:] = nblk           # row 0 holds 12 tokens at most
    return perm, nblk


VARIANTS = ("exact", "expmul")
KEYS = {"full": "impl", "prefill": "prefill_impl", "decode": "decode_impl",
        "paged_prefill": "paged_impl", "paged_decode": "paged_impl"}


def _run(table, name, kv_dtype, window=None):
    """{variant: (port output, repro output)} of entry ``name`` of
    ``table``, both variants on one set of operands."""
    rng = np.random.default_rng(
        zlib.crc32(f"{table} {name} {kv_dtype}".encode()))
    kw = {"kv_dtype": kv_dtype, "window": window, "decode_block_k": PS,
          "block_k": 8, KEYS[table]: name}
    lengths = np.array([5, 9], np.int32)
    if table == "full":
        ops = [_np(rng, B, H, S, D), _np(rng, B, HKV, S, D),
               _np(rng, B, HKV, S, D)]
        targs, jargs = (list(map(f, ops))
                        for f in (torch.from_numpy, jnp.asarray))

        def call(reg, s, q, k, v):
            return reg.dispatch_attention(s, q, k, v)

    elif table == "prefill":
        cache = [_pair(rng, kv_dtype, B, HKV, S, D) for _ in "kv"]
        chunk = [_pair(rng, kv_dtype, B, HKV, C, D) for _ in "kv"]
        q, n_valid = _np(rng, B, H, C, D), np.array([8, 6], np.int32)
        targs = [torch.from_numpy(q), *(t for t, _ in cache + chunk),
                 torch.from_numpy(lengths), torch.from_numpy(n_valid)]
        jargs = [jnp.asarray(q), *(j for _, j in cache + chunk),
                 jnp.asarray(lengths), jnp.asarray(n_valid)]

        def call(reg, s, q, kc, vc, kn, vn, n, nv):
            return reg.dispatch_prefill(s, q, kc, vc, kn, vn, lengths=n,
                                        n_valid=nv)

    elif table == "decode":
        cache = [_pair(rng, kv_dtype, B, HKV, S, D) for _ in "kv"]
        q, lens = _np(rng, B, H, D), np.array([7, 16], np.int32)
        targs = [torch.from_numpy(q), *(t for t, _ in cache),
                 torch.from_numpy(lens)]
        jargs = [jnp.asarray(q), *(j for _, j in cache), jnp.asarray(lens)]

        def call(reg, s, q, k, v, n):
            return reg.dispatch_decode(s, q, k, v, n)

    else:
        bt, nblk = _tables(rng)
        pool = [_pair(rng, kv_dtype, nblk * PS, HKV, D) for _ in "kv"]
        tpool, jpool = [t for t, _ in pool], [j for _, j in pool]
        tbt, jbt = torch.from_numpy(bt), jnp.asarray(bt)
        if table == "paged_prefill":
            chunk = [_pair(rng, kv_dtype, B, HKV, C, D) for _ in "kv"]
            q, n_valid = _np(rng, B, H, C, D), np.array([6, 7], np.int32)
            pos = lengths[:, None] + np.arange(C)[None, :]
            valid = np.arange(C)[None, :] < n_valid[:, None]
            targs = [torch.from_numpy(q), *(t for t, _ in chunk), *tpool,
                     torch.from_numpy(lengths), torch.from_numpy(n_valid),
                     tbt]
            jargs = [jnp.asarray(q), *(j for _, j in chunk), *jpool,
                     jnp.asarray(lengths), jnp.asarray(pos),
                     jnp.asarray(valid), jbt]

            def call(reg, s, q, kn, vn, kp, vp, n, *rest):
                # the port's layers pass n_valid and the tables, no rows;
                # repro's pass the rows and the positional operands
                if reg is treg:
                    nv, bt = rest
                    return reg.dispatch_paged_prefill(
                        s, q, kn, vn, kp, vp, None, lengths=n, n_valid=nv,
                        block_tables=bt, page_size=PS)
                pos, valid, bt = rest
                return reg.dispatch_paged_prefill(
                    s, q, kn, vn, kp, vp, jslot_rows(bt, PS),
                    q_positions=pos, chunk_valid=valid, lengths=n,
                    block_tables=bt, page_size=PS)
        else:
            q, lens = _np(rng, B, H, D), np.array([12, 13], np.int32)
            targs = [torch.from_numpy(q), *tpool, torch.from_numpy(lens),
                     tbt]
            jargs = [jnp.asarray(q), *jpool, jnp.asarray(lens), jbt]

            def call(reg, s, q, kp, vp, n, bt):
                rows = None if reg is treg else jslot_rows(bt, PS)
                return reg.dispatch_paged_decode(s, q, kp, vp, rows, n,
                                                 block_tables=bt,
                                                 page_size=PS)

    got = [call(treg, treg.AttentionSpec(variant=v, **kw), *targs)
           for v in VARIANTS]
    # repro's side jitted, both variants in one compilation
    want = jax.jit(lambda *a: [call(jreg, jreg.AttentionSpec(variant=v, **kw),
                                    *a) for v in VARIANTS])(*jargs)
    return {v: (t, np.asarray(j)) for v, t, j in zip(VARIANTS, got, want)}


ENTRIES = [("full", "ref"), ("full", "flash_jnp"), ("prefill", "masked_xla"),
           ("decode", "xla"), ("paged_prefill", "gather_xla"),
           ("paged_decode", "gather_xla"), ("paged_prefill", "gather_pallas"),
           ("paged_decode", "gather_pallas")]


@pytest.mark.parametrize("table,name", ENTRIES)
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_entry_matches_repro(table, name, kv_dtype):
    """Exact and ExpMul (``_q`` forms at int8)."""
    for variant, (t, j) in _run(table, name, kv_dtype).items():
        assert t.shape == j.shape, variant
        np.testing.assert_allclose(t.numpy(), j, atol=TOL, rtol=TOL,
                                   err_msg=variant)


@pytest.mark.parametrize("table", ["paged_prefill", "paged_decode"])
def test_windowed_gather_routes_match_repro(table):
    """A window masks positions below ``lengths - window`` on the paged
    layout; the gather_pallas decode takes gather_xla there."""
    for t, j in _run(table, "gather_pallas", "fp32", window=5).values():
        np.testing.assert_allclose(t.numpy(), j, atol=TOL, rtol=TOL)


def test_one_registry_call_counts_once():
    """One dispatch counts once, under its route's label, whatever wrappers
    it reaches; "pallas" counts as "kernel", as the wrapper labels it."""
    rng = np.random.default_rng(0)
    bt, nblk = _tables(rng)
    pool = [QuantKV(*quantize_kv(torch.from_numpy(
        _np(rng, nblk * PS, HKV, D)), "int8")) for _ in "kv"]
    q = torch.from_numpy(_np(rng, B, H, D))
    m = MetricsRegistry()
    install_dispatch_counters(m)
    try:
        for name in ("gather_pallas", "gather_xla", "kernel", "pallas"):
            treg.dispatch_paged_decode(
                treg.AttentionSpec(paged_impl=name, kv_dtype="int8"), q,
                *pool, None, torch.tensor([3, 4], dtype=torch.int32),
                block_tables=torch.from_numpy(bt), page_size=PS)
        count = m.counter_value
        common = dict(kind="paged_decode", variant="exact", kv_dtype="int8",
                      layout="paged")
        for impl, n in (("gather_pallas", 1), ("gather_xla", 1),
                        ("kernel", 2)):
            assert count("attention_dispatch_total", impl=impl,
                         **common) == n
        snap = m.snapshot()["counters"]
        assert sum(v for k, v in snap.items()
                   if k.startswith("attention_dispatch_total")) == 4
    finally:
        install_dispatch_counters(None)
    assert build.DISPATCH_SINK is None


def test_gather_routes_compute_rows_from_tables():
    """Given the tables alone, a gather route reads the rows ``slot_rows``
    gives; given the rows alone, the ``kernel`` entries take the
    gather-then-kernel form."""
    rng = np.random.default_rng(3)
    bt, nblk = _tables(rng)
    bt = torch.from_numpy(bt)
    kp, vp = (torch.from_numpy(_np(rng, nblk * PS, HKV, D)) for _ in "kv")
    q = torch.from_numpy(_np(rng, B, H, D))
    lens = torch.tensor([12, 13], dtype=torch.int32)
    spec = treg.AttentionSpec(paged_impl="gather_pallas", variant="expmul",
                              decode_block_k=PS)
    by_tables = treg.dispatch_paged_decode(spec, q, kp, vp, None, lens,
                                           block_tables=bt, page_size=PS)
    by_rows = treg.dispatch_paged_decode(spec, q, kp, vp,
                                         slot_rows(bt, PS), lens)
    fused_rows = treg.dispatch_paged_decode(
        spec.replace(paged_impl="kernel"), q, kp, vp, slot_rows(bt, PS), lens)
    assert torch.equal(by_tables, by_rows) and torch.equal(by_rows,
                                                           fused_rows)


def test_new_modules_import_no_jax_and_no_repro():
    modules = ("kernels.registry", "kernels.kvquant", "kernels.flash.ref",
               "kernels.decode.ref", "core.attention", "serve", "optim",
               "configs.registry")
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module('repro_torch.' + m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\nprint('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env={**os.environ,
                            "PYTHONPATH": os.path.join(ROOT, "src")})
    assert r.returncode == 0 and "clean" in r.stdout, r.stdout + r.stderr
