"""Parameters of a ``repro`` model, as numpy arrays, into the port's layout.

``params_from_jax(np_params, cfg)`` takes the pytree of ``repro``'s
``init_model`` with every leaf turned into a numpy array (for example
``jax.tree.map(np.asarray, params)``): ``units[pos]`` holds the blocks of
kind ``block_pattern[pos]``, each leaf stacked on a leading axis over the
``num_layers / len(block_pattern)`` units, so layer ``u * len(unit) + pos``
is ``units[pos][u]``. It returns the port's parameter dict, one entry a
layer in true layer order, with the same per-layer layouts (``wq (d, H,
hd)``, ``wo (H, hd, d)``, ...; MLA's
``q_norm`` and ``kv_norm`` stay dicts of their ``scale``; an MoE layer's
``ffn`` keeps ``router``, the expert stacks (E, ., .) and its nested
``dense`` MLP; an untied head ``embed.out`` comes along; a recurrent
layer keeps its leaves by name: RG-LRU's, mLSTM's ``w_up``, ``w_gate``,
``wqh``, ``wkh``, ``wvh``, ``w_i``, ``b_i``, ``w_f``, ``b_f``, ``w_down``,
sLSTM's ``w_*``, ``r_*``, ``b_*`` of each gate and its ``ffn_*``, and
an xLSTM block has no ``norm_ffn`` or ``ffn``), so both frameworks run
the same weights. Norms keep every leaf (a LayerNorm's ``bias`` too). A
frontend's ``frontend_proj`` comes along; an encoder-decoder's
``enc_units`` (stacked like ``units``, over ``encoder_layers``) become
``enc_layers``, its ``dec_units`` (one unit kind, stacked over
``decoder_layers``, each layer with ``norm_cross`` and ``cross``) become
``dec_layers``, and ``enc_final_norm`` comes along. This module imports
neither ``jax`` nor ``repro``: the arrays arrive as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.api import resolve_device


def _tensor(a, device):
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_params, cfg, *, device="cuda"):
    device = resolve_device(device)

    def whole(tree):
        return {name: whole(leaf) if isinstance(leaf, dict)
                else _tensor(leaf, device) for name, leaf in tree.items()}

    def layer(tree, i):  # nested dicts (norms, MLA's) keep their nesting
        return {name: layer(leaf, i) if isinstance(leaf, dict)
                else _tensor(leaf[i], device) for name, leaf in tree.items()}

    def layers(units, n_layers):
        if len(units) != len(cfg.block_pattern):
            raise ValueError(f"{len(units)} unit kinds for the block "
                             f"pattern {cfg.block_pattern}")
        n = len(units)
        return [layer(units[i % n], i // n) for i in range(n_layers)]

    out = {"embed": whole(np_params["embed"]),
           "final_norm": whole(np_params["final_norm"])}
    if "frontend_proj" in np_params:
        out["frontend_proj"] = _tensor(np_params["frontend_proj"], device)
    if not cfg.encoder_layers:
        out["layers"] = layers(np_params["units"], cfg.num_layers)
        return out
    out["enc_layers"] = layers(np_params["enc_units"], cfg.encoder_layers)
    out["enc_final_norm"] = whole(np_params["enc_final_norm"])
    out["dec_layers"] = [layer(np_params["dec_units"][0], i)
                         for i in range(cfg.decoder_layers)]
    return out
