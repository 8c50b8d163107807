"""Port parity of training's loss and gradients for MLA (minicpm3-4b:
latents, V zero-padded to the qk width) and MoE (arctic-480b with its
dense residual, kimi-k2-1t-a32b at top-2 of 8 experts): the scatter into
(E, C, d) with capacity drops, the float32 combine: the port's
``value_and_grad`` against ``jax.value_and_grad`` of ``repro``'s
``loss_fn`` on converted weights, at smoke width in float32, exact and
ExpMul (``tests/torch_training.py``: ``repro`` at
``attention_impl="pallas"``; the loss within 1e-5 of its value, every
gradient leaf within 1e-4 of its leaf's magnitude).
"""
import pytest

pytest.importorskip("torch")

from torch_training import check_loss_and_grads  # noqa: E402


@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("arch", ["minicpm3-4b", "arctic-480b",
                                  "kimi-k2-1t-a32b"])
def test_loss_and_grads_match_repro(arch, variant):
    check_loss_and_grads(arch, variant)
