"""Port parity of the training launcher's per-arch behaviour: three steps
of ``repro_torch.launch.train.main`` against ``repro``'s jitted train step
driven as ``repro.launch.train.main`` drives it (its synthetic batches at
seed 0, ``adamw(cosine_schedule(3e-3, 20, 3), moment_dtype=
cfg.opt_state_dtype)``), from the same converted weights (the port's
launcher resumes a step-0 checkpoint of them), ExpMul, at smoke width in
float32; the losses of the three steps within 1e-4 of their values.

- arctic-480b keeps its AdamW moments in bfloat16, as ``repro`` does;
- llava-next-34b and seamless-m4t-medium get zero ``frontend_embeds`` of
  ``(batch, frontend_tokens, frontend_dim)``;
- qwen2-0.5b with ``--compress-grads`` runs its gradients through
  ``error_feedback_int8`` with the residuals carried step to step. Under
  ``jax.jit``, ``repro``'s launcher closes over its residual holder, so
  its compiled step keeps the first (zero) residuals and its new ones
  leak out as tracers; ``repro``'s side here passes the residuals in and
  out of the jitted step, the carried error feedback its launcher's code
  describes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.distributed.compression import (  # noqa: E402
    error_feedback_int8 as jax_error_feedback_int8,
    init_residuals as jax_init_residuals,
)
from repro.optim.adamw import adamw as jax_adamw  # noqa: E402
from repro.optim.schedule import cosine_schedule as jax_cosine  # noqa: E402
from repro.train.step import build_train_step as jax_build_step  # noqa: E402
from repro_torch.checkpoint.save import save_checkpoint  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.train.step import make_train_state  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_training import BATCH, SEQ, models  # noqa: E402

STEPS = 3


def _jax_losses(jcfg, jparams, compress):
    """The losses of ``repro``'s jitted step over STEPS steps."""
    jopt = jax_adamw(jax_cosine(3e-3, 20, STEPS),
                     moment_dtype=jcfg.opt_state_dtype)
    data = JaxDataset(jcfg.vocab_size, SEQ, seed=0)

    def step(state, batch, res):
        out = {}

        def grad_transform(grads):
            compressed, out["res"] = jax_error_feedback_int8(grads, res)
            return compressed

        state, metrics = jax_build_step(
            jcfg, jopt, grad_transform=grad_transform if compress
            else None)(state, batch)
        return state, metrics, out.get("res", res)

    step = jax.jit(step)
    state = {"params": jparams, "opt": jopt.init(jparams)}
    res = jax_init_residuals(jparams) if compress else None
    losses = []
    for i in range(STEPS):
        batch = {"tokens": jnp.asarray(data.batch(i, BATCH))}
        if jcfg.frontend:
            batch["frontend_embeds"] = jnp.zeros(
                (BATCH, jcfg.frontend_tokens, jcfg.frontend_dim), jcfg.dtype)
        state, metrics, res = step(state, batch, res)
        losses.append(float(metrics["loss"]))
    return losses


@pytest.mark.parametrize("arch,compress", [
    ("arctic-480b", False), ("llava-next-34b", False),
    ("seamless-m4t-medium", False), ("qwen2-0.5b", True)],
    ids=["arctic-bf16-moments", "llava-zero-frontend",
         "seamless-zero-frontend", "qwen2-compress-grads"])
def test_launcher_steps_match_repro(arch, compress, tmp_path, monkeypatch):
    jcfg, jparams, cfg, params = models(arch)
    want = _jax_losses(jcfg, jparams, compress)
    opt = adamw(cosine_schedule(3e-3, 20, STEPS),
                moment_dtype=cfg.opt_state_dtype)
    save_checkpoint(make_train_state(params, opt), str(tmp_path), 0)
    seen = []   # (state, batch) of every step the launcher runs
    build = launch.build_train_step

    def spy(*args, **kw):
        assert (kw["grad_transform"] is not None) == compress
        train_step = build(*args, **kw)

        def run(state, batch):
            seen.append((state, batch))
            return train_step(state, batch)
        return run

    monkeypatch.setattr(launch, "build_train_step", spy)
    argv = ["--steps", str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
            "--variant", "expmul", "--log-every", "1", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    got = launch.main(argv + (["--compress-grads"] if compress else []),
                      cfg_override=cfg)
    assert len(got) == len(want) == STEPS and len(seen) == STEPS
    for a, b in zip(got, want):
        assert np.isfinite(a) and abs(a - b) <= 1e-4 * abs(b), (got, want)
    moments = {leaf.dtype for leaf in tree_leaves(seen[-1][0]["opt"]["m"])}
    assert moments == {torch.bfloat16 if arch == "arctic-480b"
                       else torch.float32}
    fe = seen[-1][1].get("frontend_embeds")
    if cfg.frontend:
        assert fe.shape == (BATCH, cfg.frontend_tokens, cfg.frontend_dim)
        assert fe.dtype == torch.float32 and not fe.any()
    else:
        assert fe is None
