"""Port parity of training: ``repro_torch``'s loss, gradients, train step,
optimizer functions, data and launcher against ``repro`` on converted
weights and the same synthetic batches, at smoke width in float32.

The reference side always runs ``attention_impl="pallas"`` (the Pallas
forward in interpret mode with the recompute-and-STE backward), the twin
of the port's training path; its launcher's default ``flash_jnp`` route
gives ExpMul queries and keys no gradient at all
(``tests/test_torch_flash.py``). Blocks of 16 query rows and 32 KV
columns over 80 tokens make the forward pad and the backward take 20-wide
blocks. Limits: the loss within 1e-5 of its value, every gradient within
1e-4 of its leaf's magnitude, losses and grad norms of three steps within
1e-4. After three steps every parameter is within 1e-4 of its own
magnitude. The zero-initialized ones (QKV biases, norm scales, ~9e-4
after three steps) may instead differ by up to 2e-6 absolute: the key
bias's gradient is float rounding alone (softmax does not change when
every key score of a row moves by the same q.b), and AdamW's early,
sign-like updates turn that rounding into gaps of 2.9e-7 to 1.16e-6
(1e-3 of its size; measured on the CPU, both variants); the query and
value biases and the norm scales stay within 3e-5 of their own size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.synthetic import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim.adamw import adamw as jax_adamw  # noqa: E402
from repro.optim.clip import clip_by_global_norm as jax_clip  # noqa: E402
from repro.optim.schedule import cosine_schedule as jax_cosine  # noqa: E402
from repro.train.step import build_train_step as jax_build_step  # noqa: E402
from repro.train.step import make_train_state as jax_make_state  # noqa: E402
from repro_torch.checkpoint.save import save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.layers.attention_layer import attn_apply  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.optim import adamw, clip_by_global_norm, cosine_schedule  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    build_train_step,
    make_train_state,
    value_and_grad,
)
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

SEQ, BATCH = 80, 2


def _models(variant):
    over = dict(dtype="float32", param_dtype="float32",
                attention_variant=variant, attention_block_k=32)
    jcfg = jax_get_config("qwen2-0.5b", smoke=True, attention_impl="pallas",
                          attention_block_q=16, **over)
    params = japi.init_model(jax.random.PRNGKey(0), jcfg)
    tcfg = get_config("qwen2-0.5b", smoke=True, **over)
    return jcfg, params, tcfg, _convert(params, tcfg)


def _convert(jtree, tcfg):
    """A repro parameter tree (or one of its gradient) in the port's
    layout, on the CPU."""
    return params_from_jax(jax.tree.map(np.asarray, jtree), tcfg,
                           device="cpu")


def _leaf_errors(got, want):
    """{path: (max |got - want|, max |want|)} over the leaves of two port
    trees."""
    out = {}
    for (path, a), (_, b) in zip(tree_leaves_with_path(got),
                                 tree_leaves_with_path(want)):
        out[path] = (float((a - b).abs().max()), float(b.abs().max()))
    return out


def _batch(i):
    return JaxDataset(256, SEQ, seed=0).batch(i, BATCH)


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_loss_and_grads_match_repro(variant):
    jcfg, params, tcfg, tparams = _models(variant)
    toks = _batch(0)
    jl, jg = jax.value_and_grad(japi.loss_fn)(
        params, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tg = value_and_grad(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    # the loss through loss_fn itself, with an explicit all-ones mask
    batch = {"tokens": torch.from_numpy(toks),
             "loss_mask": torch.ones(BATCH, SEQ)}
    assert abs(float(tapi.loss_fn(tparams, batch, tcfg)) - float(jl)) \
        <= 1e-5 * abs(float(jl))
    for path, (err, mag) in _leaf_errors(tg, _convert(jg, tcfg)).items():
        assert err <= 1e-4 * mag, path


@pytest.fixture(scope="module", params=["exact", "expmul"])
def jax_run(request):
    """Three steps of ``repro``'s jitted train step from PRNGKey(0) weights,
    driven as ``repro.launch.train.main`` drives it (the synthetic batches
    of steps 0-2 at seed 0, ``adamw(cosine_schedule(3e-3, 20, 3))``), with
    their metrics and the final state."""
    jcfg, params, tcfg, tparams = _models(request.param)
    jopt = jax_adamw(jax_cosine(3e-3, 20, 3))
    jstate = jax_make_state(params, jopt)
    jstep = jax.jit(jax_build_step(jcfg, jopt))
    metrics = []
    for i in range(3):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(_batch(i))})
        metrics.append({k: float(v) for k, v in jm.items()})
    return dict(variant=request.param, tcfg=tcfg, tparams=tparams,
                metrics=metrics, params=_convert(jstate["params"], tcfg))


def test_three_train_steps_match_repro(jax_run):
    tcfg, tparams = jax_run["tcfg"], jax_run["tparams"]
    topt = adamw(cosine_schedule(3e-3, 20, 3))
    tstate = make_train_state(tparams, topt)
    tstep = build_train_step(tcfg, topt)
    for i, jm in enumerate(jax_run["metrics"]):
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(_batch(i))})
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - jm[key]) <= 1e-4 * abs(jm[key]), \
                (i, key)
    assert int(tstate["opt"]["step"]) == 3
    errs = _leaf_errors(tstate["params"], jax_run["params"])
    zero_init = {path for path, leaf in tree_leaves_with_path(tparams)
                 if float(leaf.abs().max()) == 0.0}
    for path, (err, mag) in errs.items():
        limit = 1e-4 * mag
        if path in zero_init:
            limit = max(limit, 2e-6)
        assert err <= limit, path


def test_microbatches_match_full_batch():
    """As ``tests/test_train_step.py``'s accumulation test, on the port:
    two microbatches of 4 rows against one batch of 8."""
    cfg = get_config("qwen2-0.5b", smoke=True, dtype="float32",
                     param_dtype="float32")
    params = tapi.init_model(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    opt = adamw(1e-3)
    state = make_train_state(params, opt)
    batch = {"tokens": torch.from_numpy(
        SyntheticLMDataset(cfg.vocab_size, 32, seed=0).batch(0, 8))}
    st1, m1 = build_train_step(cfg, opt, microbatches=1)(state, batch)
    st2, m2 = build_train_step(cfg, opt, microbatches=2)(state, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    for (path, a), (_, b) in zip(tree_leaves_with_path(st1["params"]),
                                 tree_leaves_with_path(st2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4,
                                   rtol=2e-3, err_msg=str(path))
    with pytest.raises(ValueError, match="microbatches"):
        build_train_step(cfg, opt, microbatches=3)(state, batch)


def test_remat_changes_no_number():
    """``cfg.remat`` recomputes each layer in the backward (its flash
    forward runs twice) and leaves the loss and every gradient as they
    were."""
    cfg = get_config("qwen2-0.5b", smoke=True, dtype="float32",
                     param_dtype="float32")
    params = tapi.init_model(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    batch = {"tokens": torch.from_numpy(_batch(1))}
    out = {}
    for remat in (True, False):
        before = build.COUNTS["flash_plain"]
        out[remat] = value_and_grad(params, batch, cfg.replace(remat=remat))
        assert build.COUNTS["flash_plain"] - before == \
            cfg.num_layers * (2 if remat else 1)
    assert torch.equal(out[True][0], out[False][0])
    for (path, a), (_, b) in zip(tree_leaves_with_path(out[True][1]),
                                 tree_leaves_with_path(out[False][1])):
        assert torch.equal(a, b), path


def test_adamw_bf16_moments_match_repro():
    """The quadratic of ``tests/test_data_and_optim.py``'s bf16-moment
    test: the port's bfloat16 moments follow ``repro``'s and stay close to
    float32 ones."""
    def run(mdt, port):
        if port:
            opt, w = adamw(0.05, moment_dtype=mdt), {
                "w": torch.tensor([3.0, -2.0])}
        else:
            opt, w = jax_adamw(0.05, moment_dtype=mdt), {
                "w": jnp.array([3.0, -2.0])}
        st = opt.init(w)
        for _ in range(100):
            upd, st = opt.update({"w": 2 * w["w"]}, st, w)
            w = {"w": w["w"] + upd["w"]}
        return np.asarray(w["w"]), st

    got, st = run("bfloat16", True)
    assert st["m"]["w"].dtype == torch.bfloat16
    assert np.abs(got - run("bfloat16", False)[0]).max() < 1e-4
    assert np.abs(got - run("float32", True)[0]).max() < 0.15


def test_optimizer_schedule_clip_and_data_match_repro():
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "b": (8,), "s": (3, 4, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jopt = jax_adamw(jax_cosine(3e-3, 4, 10))
    topt = adamw(cosine_schedule(3e-3, 4, 10))
    jst, tst = jopt.init(jp), topt.init(tp)
    for i in range(8):   # warmup, then the cosine decay
        g = {k: (rng.standard_normal(s) * 10.0 ** (i % 3 - 1)).astype(
            np.float32) for k, s in shapes.items()}
        jg, jnorm = jax_clip({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        tg, tnorm = clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
        assert abs(float(tnorm) - float(jnorm)) <= 1e-6 * float(jnorm)
        ju, jst = jopt.update(jg, jst, jp)
        tu, tst = topt.update(tg, tst, tp)
        for k in shapes:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=1e-6, atol=0)
            assert float(np.abs(tu[k].numpy() - np.asarray(ju[k])).max()) \
                <= 1e-6 * float(np.abs(np.asarray(ju[k])).max())
            jp[k] = jp[k] + ju[k]
            tp[k] = tp[k] + tu[k]
        for k in ("m", "v"):
            for name in shapes:
                want = np.asarray(jst[k][name])
                assert float(np.abs(tst[k][name].numpy() - want).max()) \
                    <= 1e-6 * float(np.abs(want).max()), (k, name)
    for step in (0, 1, 3, 4, 7, 10, 12):
        want = float(jax_cosine(3e-3, 4, 10)(jnp.asarray(step, jnp.int32)))
        got = float(cosine_schedule(3e-3, 4, 10)(torch.tensor(
            step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * want, step
    for seed, step, n, seq in ((0, 0, 4, 80), (3, 17, 2, 33)):
        np.testing.assert_array_equal(
            SyntheticLMDataset(256, seq, seed=seed).batch(step, n),
            JaxDataset(256, seq, seed=seed).batch(step, n))


def test_launcher_matches_repro(jax_run, tmp_path):
    """Three steps of the port's launcher against ``repro``'s train step as
    its launcher drives it, from the same weights: the port's launcher
    resumes a step-0 checkpoint of the converted ``repro`` state.
    ``repro.launch.train.main`` itself stops at its first step under this
    JAX (a ``ShardingTypeError`` in the embedding gather under its mesh),
    so ``jax_run`` runs its loop without the mesh."""
    opt = adamw(cosine_schedule(3e-3, 20, 3))
    save_checkpoint(make_train_state(jax_run["tparams"], opt), str(tmp_path),
                    0)
    got = launch.main(["--steps", "3", "--batch", str(BATCH), "--seq",
                       str(SEQ), "--variant", jax_run["variant"],
                       "--log-every", "1", "--device", "cpu", "--ckpt-dir",
                       str(tmp_path)], cfg_override=jax_run["tcfg"])
    want = [m["loss"] for m in jax_run["metrics"]]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-4 * abs(b)


def test_training_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(SystemExit):
        launch.main(["--smoke", "--steps", "1"])
    cfg = get_config("qwen2-0.5b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.init_model(cfg)


def test_quantized_kv_training_raises():
    cfg = get_config("qwen2-0.5b", smoke=True, dtype="float32",
                     param_dtype="float32", kv_dtype="int8")
    params = tapi.init_model(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    x = torch.zeros(1, 8, cfg.d_model)
    with pytest.raises(NotImplementedError, match="kv_dtype"):
        attn_apply(params["layers"][0]["mix"], x, cfg)
