"""Port parity of training's loss and gradients for dense decoders: GQA
with a QKV bias (qwen2-0.5b), MHA (qwen1.5-0.5b), gemma-7b's scaled
embedding and GeGLU: the port's ``value_and_grad`` against
``jax.value_and_grad`` of ``repro``'s ``loss_fn`` on converted weights,
at smoke width in float32, exact and ExpMul
(``tests/torch_training.py``: ``repro`` at ``attention_impl="pallas"``;
the loss within 1e-5 of its value, every gradient leaf within 1e-4 of
its leaf's magnitude).
"""
import pytest

pytest.importorskip("torch")

from torch_training import check_loss_and_grads  # noqa: E402


@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen1.5-0.5b", "gemma-7b"])
def test_loss_and_grads_match_repro(arch, variant):
    check_loss_and_grads(arch, variant)
