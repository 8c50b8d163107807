"""Parameters of a ``repro`` model, as numpy arrays, into the port's layout.

``params_from_jax(np_params, cfg)`` takes the pytree of ``repro``'s
``init_model`` with every leaf turned into a numpy array (for example
``jax.tree.map(np.asarray, params)``): ``units[0]`` holds each leaf stacked
on a leading layer axis. It returns the port's parameter dict with the
same per-layer layouts (``wq (d, H, hd)``, ``wo (H, hd, d)``, ...; MLA's
``q_norm`` and ``kv_norm`` stay dicts of their ``scale``; an MoE layer's
``ffn`` keeps ``router``, the expert stacks (E, ., .) and its nested
``dense`` MLP; an untied head ``embed.out`` comes along), so both
frameworks run the same weights. This module imports neither ``jax``
nor ``repro``: the arrays arrive as numpy.
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
    if len(np_params["units"]) != 1:
        raise ValueError("the port converts attention-only models (one "
                         "unit kind)")
    stacked = np_params["units"][0]

    def layer(tree, i):  # nested dicts (MLA's norms) keep their nesting
        return {name: layer(leaf, i) if isinstance(leaf, dict)
                else _tensor(leaf[i], device) for name, leaf in tree.items()}

    return {
        "embed": {name: _tensor(w, device)
                  for name, w in np_params["embed"].items()},
        "final_norm": {"scale": _tensor(np_params["final_norm"]["scale"],
                                        device)},
        "layers": [layer(stacked, i) for i in range(cfg.num_layers)],
    }
