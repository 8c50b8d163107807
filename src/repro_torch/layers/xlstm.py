"""xLSTM blocks, the port of ``repro/layers/xlstm.py``: mLSTM (matrix
memory) and sLSTM (scalar memory).

mLSTM per head: C_t = f_t C_{t-1} + i_t k_t v_t^T ; n_t = f_t n_{t-1} + i_t k_t
               h_t = q_t^T C_t / max(|n_t . q_t|, 1)
with an exponential input gate and a sigmoid forget gate, stabilized by a
running max m_t = max(m_{t-1} + log f_t, i_t) (the stored C, n are the
true ones scaled by exp(-m)). Q/K/V are block-diagonal per head, after an
up-projection of 1.5 d; the output is gated by SiLU of a second
projection. sLSTM: a scalar cell at model width with block-diagonal
(per-head) input and recurrent gate weights, then a SiLU-gated FFN of
``int(4/3 d)`` whatever ``cfg.activation`` says.

The products run in the model dtype and the gates and recurrences in
float32, with the reference's casts: ``k`` is divided by ``sqrt(dh)`` in
the model dtype (the divisor rounded to it first, as JAX's weakly typed
scalar is), sLSTM's recurrent ``h`` is cast to the input's dtype before
the ``r_*`` products, and ``(h * g)`` to the input's dtype before
``w_down``.

Three forms of each recurrence:

* ``mlstm_apply`` (the full-sequence forward) runs the reference's
  chunkwise-parallel form: quadratic within a chunk of
  ``L = min(chunk, S)`` (or the largest divisor of S below it),
  recurrent across chunks (``jax.lax.cummax`` is ``torch.cummax``);
  ``slstm_apply`` scans the step over the sequence.
* ``mlstm_decode_step`` / ``slstm_decode_step`` advance one token.
* ``mlstm_prefill_step`` / ``slstm_prefill_step`` advance a chunk: the
  projections (and sLSTM's input products) run over the whole chunk at
  once, and only the float32 recurrence loops over the tokens (sLSTM's
  ``r_*`` products inside the loop, since they read the previous ``h``).
  A row's tokens at or past its ``n_valid`` leave the state unchanged
  (mLSTM: f = 1 and i = 0 in the update, m held; sLSTM: the old state
  selected), so an idle row's state does not move; each of them outputs
  what ``repro``'s gated scan of the decode step gives it, one ungated
  step from the last valid state (an idle row's logits read the first).
  sLSTM's FFN takes the chunk after the loop.

The serving forms update the cache in place (``C``, ``n``, ``m``; ``c``,
``n``, ``h``, ``m``), at fixed shapes and with no host read, so a tick of
them can be captured in a CUDA graph. There is no softmax here: the
paper's ExpMul precondition (x <= 0) does not hold for these signed gate
pre-activations, so the operator does not apply to this family.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.launch.op_costs import looped
from repro_torch.layers.common import activation_fn, dense_init
from repro_torch.sharding import regions
from repro_torch.sharding.constraints import constrain

_PROJ = 1.5      # mLSTM up-projection factor
_FFN_PF = 4 / 3  # sLSTM post-FFN factor
M_INIT = -1e30   # the stabilizer of a fresh state
_GATES = ("z", "i", "f", "o")


def _dims(cfg):
    nh = cfg.num_heads
    inner = int(_PROJ * cfg.d_model)
    inner -= inner % nh
    return inner, nh, inner // nh


def _sdims(cfg):
    nh, d = cfg.num_heads, cfg.d_model
    if d % nh:
        raise ValueError(f"d_model {d} is not a multiple of {nh} heads")
    return nh, d // nh, int(_FFN_PF * d)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_init(cfg, dtype, generator, device):
    """The reference's eight draws in its shapes; ``b_f = 3`` opens the
    forget gates at init."""
    d = cfg.d_model
    inner, nh, dh = _dims(cfg)

    def w(shape):
        return dense_init(shape, dtype, generator, device)

    return {
        "w_up": w((d, inner)),
        "w_gate": w((d, inner)),
        "wqh": w((nh, dh, dh)),      # block-diagonal
        "wkh": w((nh, dh, dh)),
        "wvh": w((nh, dh, dh)),
        "w_i": w((inner, nh)),
        "b_i": torch.zeros((nh,), dtype=dtype, device=device),
        "w_f": w((inner, nh)),
        "b_f": torch.full((nh,), 3.0, dtype=dtype, device=device),
        "w_down": w((inner, d)),
    }


def scale_k(k, dh):
    """``k / sqrt(dh)`` in k's dtype as ``repro`` computes it: JAX divides
    by a weakly typed float32 scalar, which it rounds to k's dtype first
    (27.75 in bfloat16 for sqrt(768))."""
    return k / float(torch.tensor(math.sqrt(dh), dtype=torch.float32)
                     .to(k.dtype))


def _log_sigmoid(x):
    """``F.logsigmoid``; on ``meta`` tensors (the dry run, no values) the
    same function as ``-softplus(-x)``: DTensor propagates log-sigmoid's
    saved buffer at a CUDA tensor's empty shape, which its backward then
    cannot redistribute on a mesh."""
    if x.device.type == "meta":
        return -F.softplus(-x)
    return F.logsigmoid(x)


def _mlstm_proj(params, x, cfg):
    """x (B, S, d) -> q, k, v (B, nh, S, dh) in float32, the input gate's
    pre-activation and log f (B, nh, S) in float32, the output gate g
    (B, S, inner) in float32."""
    f32 = torch.float32
    inner, nh, dh = _dims(cfg)
    B, S, _ = x.shape
    u = x @ params["w_up"]
    g = F.silu((x @ params["w_gate"]).to(f32))
    uh = u.reshape(B, S, nh, dh)
    q = torch.einsum("bshd,hde->bhse", uh, params["wqh"])
    k = scale_k(torch.einsum("bshd,hde->bhse", uh, params["wkh"]), dh)
    v = torch.einsum("bshd,hde->bhse", uh, params["wvh"])
    i_pre = (u @ params["w_i"]).to(f32) + params["b_i"].to(f32)
    f_pre = (u @ params["w_f"]).to(f32) + params["b_f"].to(f32)
    return (q.to(f32), k.to(f32), v.to(f32), i_pre.transpose(1, 2),
            _log_sigmoid(f_pre).transpose(1, 2), g)


def _mlstm_out(params, h, g, x):
    """h (B, nh, S, dh) float32 -> (B, S, d)."""
    B, nh, S, dh = h.shape
    h = h.transpose(1, 2).reshape(B, S, nh * dh)
    return (h * g).to(x.dtype) @ params["w_down"]


def mlstm_apply(params, x, cfg, *, chunk=256):
    """Chunkwise-parallel mLSTM over the full sequence x (B, S, d), from a
    fresh state."""
    B, S, _ = x.shape
    inner, nh, dh = _dims(cfg)
    q, k, v, i_pre, logf, g = _mlstm_proj(params, x, cfg)
    # on a mesh the chunks walk the sequence gathered whole once
    q, k, v = (constrain(t, "batch", None, None, None) for t in (q, k, v))
    i_pre, logf = (constrain(t, "batch", None, None) for t in (i_pre, logf))
    L = min(chunk, S)
    if S % L:
        L = next(n for n in range(L, 0, -1) if S % n == 0)
    dev = x.device
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
    C = torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=dev)
    n = torch.zeros((B, nh, dh), dtype=torch.float32, device=dev)
    m = torch.full((B, nh), M_INIT, dtype=torch.float32, device=dev)
    hs = []
    for c0 in range(0, S, L):
        # stored state is the true one scaled by exp(-m); with cum_t the
        # sum of log f_s (s <= t) and b_t = max_{s<=t} (i_s - cum_s), the
        # per-position stabilizer is m_t = cum_t + max(m_in, b_t)
        qc, kc, vc = (t[:, :, c0:c0 + L] for t in (q, k, v))
        ic, lfc = i_pre[..., c0:c0 + L], logf[..., c0:c0 + L]
        cum = torch.cumsum(lfc, dim=-1)
        bmax = regions.cummax(ic - cum, -1)
        mmax = torch.maximum(m[..., None], bmax)
        inter_w = torch.exp(m[..., None] - mmax)
        # pair weight (t, s <= t): exp(i_s - cum_s - mmax_t), exponents <= 0
        intra = torch.exp(ic[..., None, :] - cum[..., None, :]
                          - mmax[..., :, None])
        intra = torch.where(tri, intra, 0.0)
        sqk = qc @ kc.transpose(-1, -2)
        num = ((intra * sqk) @ vc
               + inter_w[..., None] * (qc @ C))
        den = (inter_w * (qc @ n[..., None])[..., 0]
               + torch.sum(intra * sqk, dim=-1))
        hs.append(num / torch.clamp(den.abs(), min=1.0)[..., None])
        # advance the state to the chunk's end
        m_out = cum[..., -1] + torch.maximum(m, bmax[..., -1])
        decay = torch.exp(m + cum[..., -1] - m_out)
        ins = torch.exp(ic + cum[..., -1:] - cum - m_out[..., None])
        C = (decay[..., None, None] * C
             + (ins[..., None] * kc).transpose(-1, -2) @ vc)
        n = decay[..., None] * n + torch.sum(ins[..., None] * kc, dim=-2)
        m = m_out
    return _mlstm_out(params, torch.cat(hs, dim=2), g, x)


def mlstm_init_cache(cfg, batch, dtype, device):
    del dtype
    inner, nh, dh = _dims(cfg)
    f32 = torch.float32
    return {"C": torch.zeros((batch, nh, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, nh, dh), dtype=f32, device=device),
            "m": torch.full((batch, nh), M_INIT, dtype=f32, device=device)}


def _mlstm_steps(cache, q, k, v, i_pre, logf, valid):
    """The recurrence over T tokens in the decode step's arithmetic,
    advancing ``cache`` in place; ``valid`` (B, T) gates the state (None:
    every token valid). Returns h (B, nh, T, dh) in float32."""
    C, m = cache["C"], cache["m"]
    T = q.shape[2]
    # the stabilizer, sequential in m: before each token (held where a
    # token is not valid) and its ungated value after it
    prev, cand = [], []
    cur = m
    for t in range(T):
        prev.append(cur)
        new = torch.maximum(cur + logf[..., t], i_pre[..., t])
        cand.append(new)
        cur = new if valid is None else torch.where(valid[:, None, t], new,
                                                    cur)
    prev, cand = torch.stack(prev, -1), torch.stack(cand, -1)
    fw = torch.exp(prev + logf - cand)                    # (B, nh, T)
    iw = torch.exp(i_pre - cand)
    if valid is None:
        fw_s, iw_s = fw, iw
    else:
        vb = valid[:, None, :]
        fw_s, iw_s = torch.where(vb, fw, 1.0), torch.where(vb, iw, 0.0)
    ki = iw_s[..., None] * k
    cq, ns = [], []
    n = cache["n"]
    for t in range(T):
        C.mul_(fw_s[..., t, None, None]).addcmul_(ki[:, :, t, :, None],
                                                  v[:, :, t, None, :])
        n = torch.addcmul(ki[:, :, t], n, fw_s[..., t, None])
        cq.append(torch.matmul(q[:, :, t, None, :], C)[..., 0, :])
        ns.append(n)
    cache["n"].copy_(n)
    m.copy_(cur)
    num = torch.stack(cq, 2)                              # (B, nh, T, dh)
    den = torch.sum(torch.stack(ns, 2) * q, dim=-1)       # (B, nh, T)
    if valid is not None:
        # a token past n_valid: one ungated step from the held state,
        # q^T (f C + i k v^T) = f (q^T C) + i (q . k) v
        qk = torch.sum(q * k, dim=-1)
        num = torch.where(vb[..., None], num,
                          fw[..., None] * num + (iw * qk)[..., None] * v)
        den = torch.where(vb, den, fw * den + iw * qk)
    return num / torch.clamp(den.abs(), min=1.0)[..., None]


def mlstm_decode_step(params, cache, x1, cfg):
    """x1 (B, d) -> (B, d): one token of every row; ``C``, ``n`` and ``m``
    advanced in place."""
    x = x1[:, None, :]
    q, k, v, i_pre, logf, g = _mlstm_proj(params, x, cfg)
    h = _mlstm_steps(cache, q, k, v, i_pre, logf, None)
    return cache, _mlstm_out(params, h, g, x)[:, 0]


def mlstm_prefill_step(params, cache, x, cfg, n_valid):
    """x (B, C, d) -> (B, C, d): each row's first ``n_valid`` (B,) tokens
    in order, the state advanced in place by exactly those; a token past
    them gives one ungated step from the last valid state."""
    q, k, v, i_pre, logf, g = _mlstm_proj(params, x, cfg)
    valid = (torch.arange(x.shape[1], device=x.device)[None, :]
             < n_valid.to(torch.int64)[:, None])
    h = _mlstm_steps(cache, q, k, v, i_pre, logf, valid)
    return cache, _mlstm_out(params, h, g, x)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_init(cfg, dtype, generator, device):
    """Per gate an input weight, a recurrent weight (std 0.02) and a bias
    (``b_f = 1``), then the FFN, in the reference's shapes."""
    d = cfg.d_model
    nh, dh, f = _sdims(cfg)
    p = {}
    for gate in _GATES:
        p[f"w_{gate}"] = dense_init((nh, dh, dh), dtype, generator, device)
        p[f"r_{gate}"] = dense_init((nh, dh, dh), dtype, generator, device,
                                    scale=0.02)
        p[f"b_{gate}"] = torch.full((d,), 1.0 if gate == "f" else 0.0,
                                    dtype=dtype, device=device)
    p["ffn_gate"] = dense_init((d, f), dtype, generator, device)
    p["ffn_up"] = dense_init((d, f), dtype, generator, device)
    p["ffn_down"] = dense_init((f, d), dtype, generator, device)
    return p


def _slstm_inputs(params, x, cfg):
    """The input products of every gate over x (B, S, d), each (B, S, d)
    in x's dtype."""
    nh, dh, _ = _sdims(cfg)
    B, S, d = x.shape
    xh = x.reshape(B, S, nh, dh)
    return {gate: torch.einsum("bshd,hde->bshe", xh,
                               params[f"w_{gate}"]).reshape(B, S, d)
            for gate in _GATES}


def _slstm_step(params, state, wx, cfg):
    """One step from (c, n, h, m) (B, d) float32 given the input products
    ``wx[gate]`` (B, d) of this token: the new state."""
    nh, dh, _ = _sdims(cfg)
    c, n, h, m = state
    B = h.shape[0]
    dt = wx["z"].dtype
    hh = h.reshape(B, nh, dh).to(dt)

    def pre(gate):
        r = torch.einsum("bhd,hde->bhe", hh, params[f"r_{gate}"])
        return ((wx[gate] + r.reshape(B, -1)).to(torch.float32)
                + params[f"b_{gate}"].to(torch.float32))

    z = torch.tanh(pre("z"))
    i_pre, f_pre, o = pre("i"), pre("f"), torch.sigmoid(pre("o"))
    logf = _log_sigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    iw = torch.exp(i_pre - m_new)
    fw = torch.exp(logf + m - m_new)
    c_new = fw * c + iw * z
    n_new = fw * n + iw
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def _slstm_ffn(params, h):
    act = activation_fn("swiglu")
    return ((act(h @ params["ffn_gate"]) * (h @ params["ffn_up"]))
            @ params["ffn_down"])


def _slstm_scan(params, state, x, cfg, valid=None):
    """Steps over x (B, S, d): (the final state, the outputs h (B, S, d)
    in x's dtype); ``valid`` (B, S) holds the state where a token is not
    valid. On ``meta`` tensors (the dry run) one step stands for the S
    (``launch/op_costs.py:looped``), on the sequence gathered whole on a
    mesh."""
    wx = _slstm_inputs(params, x, cfg)
    if x.device.type == "meta" and valid is None:
        names = [f"{k}_{g}" for k in "rb" for g in _GATES]

        def step(*a):
            return _slstm_step(dict(zip(names, a[8:])), a[:4],
                               dict(zip(_GATES, a[4:8])), cfg)

        new = looped(step, x.shape[1], *state,
                     *(constrain(wx[g], "batch", None, None)[:, 0]
                       for g in _GATES), *(params[k] for k in names))
        return new, new[2][:, None].expand(
            (-1, x.shape[1], -1)).to(x.dtype)
    hs = []
    for t in range(x.shape[1]):
        new = _slstm_step(params, state, {g: w[:, t] for g, w in wx.items()},
                          cfg)
        hs.append(new[2])
        if valid is not None:
            keep = valid[:, t, None]
            new = tuple(torch.where(keep, a, b) for a, b in zip(new, state))
        state = new
    return state, torch.stack(hs, 1).to(x.dtype)


def slstm_apply(params, x, cfg):
    """sLSTM over the full sequence x (B, S, d) from a fresh state."""
    B, _, d = x.shape
    z = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    state = (z, z, z, torch.full((B, d), M_INIT, dtype=torch.float32,
                                 device=x.device))
    _, h = _slstm_scan(params, state, x, cfg)
    return _slstm_ffn(params, h)


def slstm_init_cache(cfg, batch, dtype, device):
    del dtype
    d = cfg.d_model

    def full(v):
        return torch.full((batch, d), v, dtype=torch.float32, device=device)

    return {"c": full(0.0), "n": full(0.0), "h": full(0.0), "m": full(M_INIT)}


def _slstm_serve(params, cache, x, cfg, valid):
    names = ("c", "n", "h", "m")
    state, h = _slstm_scan(params, tuple(cache[k] for k in names), x, cfg,
                           valid)
    for k, t in zip(names, state):
        cache[k].copy_(t)
    return cache, _slstm_ffn(params, h)


def slstm_decode_step(params, cache, x1, cfg):
    """x1 (B, d) -> (B, d); the cache advanced in place."""
    cache, y = _slstm_serve(params, cache, x1[:, None, :], cfg, None)
    return cache, y[:, 0]


def slstm_prefill_step(params, cache, x, cfg, n_valid):
    """x (B, C, d) -> (B, C, d) as ``mlstm_prefill_step``: the first
    ``n_valid`` tokens of each row advance the state, in place; a token
    past them gives one ungated step from the last valid state."""
    valid = (torch.arange(x.shape[1], device=x.device)[None, :]
             < n_valid.to(torch.int64)[:, None])
    return _slstm_serve(params, cache, x, cfg, valid)
