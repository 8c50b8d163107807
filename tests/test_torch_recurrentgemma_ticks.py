"""recurrentgemma-2b's prefill and decode ticks in the port against
``repro`` at ``attention_impl="pallas"`` (interpret mode), at its smoke
config in float32 on converted weights, exact and ExpMul: the walks of
``test_torch_model.py`` with every RG-LRU layer's ``h`` and ``conv`` held
beside the KV caches (``hold_caches``). On the contiguous layout the
window is cut to 8, so that four chunks wrap the rolling buffer twice;
the engine streams of ``test_torch_recurrentgemma.py`` wrap the smoke
config's own window of 32 on both layouts.
"""
import pytest

pytest.importorskip("torch")

from test_torch_model import contiguous_ticks, paged_ticks  # noqa: E402

ARCH = "recurrentgemma-2b"


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_paged_ticks_match_repro(variant):
    paged_ticks(variant, "fp32", arch=ARCH)


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_contiguous_windowed_ticks_match_repro(variant):
    # rows of 19, 0 and 15 tokens over an 8-slot rolling buffer
    contiguous_ticks(variant, "fp32", 8, 24,
                     ([5, 0, 3], [5, 0, 5], [5, 0, 5], [4, 0, 2]), arch=ARCH)
