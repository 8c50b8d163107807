"""Slot-based serving engine: chunked prefill plus continuous decode
batching over per-slot (contiguous) caches or a paged KV pool (the
decoder-only path of ``repro/serve/engine.py``, with the shared-prefix
cache off).

A fixed set of ``slots`` shares two model calls:

  prefill tick   every slot contributes up to ``chunk_size`` tokens: the
                 rest of its prompt while prefilling, its current token when
                 decode-ready (a decode is a 1-valid chunk), nothing when
                 idle. The tick that consumes a prompt's last token also
                 samples its first generated token.
  decode tick    when no slot is prefilling, one token for every active
                 slot (with ``chunk_size=1`` it also teacher-forces prompts).

``kv_layout="contiguous"`` (the default, as in ``repro``) gives each slot
its own cache of ``max_len`` slots, or a rolling buffer of
``min(max_len, window)`` for a windowed config; a slot reused by a new
request is masked by its length, never cleared. There is no pool, so no
preemption. ``kv_layout="paged"``: the host-side ``BlockPool`` grows each
slot's block table before the tick, oldest request first. When the pool
cannot cover a growth, the youngest active request is preempted: its
blocks are freed and it is requeued with prompt + generated tokens as its
new prompt (recompute resumption, which leaves temperature-0 streams
unchanged). An explicit ``pool_blocks`` is a byte budget counted in
unquantized blocks: a quantized pool spends the same bytes on
proportionally more blocks. Windowed configs keep absolute positions in
the pool and mask by the window.

Not ported yet (``repro`` has them): the prefix cache, metrics,
deadlines, cancellation, the NaN quarantine and snapshots.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ATTENTION_IMPLS
from repro_torch.models.api import (
    decode_step,
    decode_step_paged,
    init_decode_state,
    init_paged_state,
    prefill,
    prefill_paged,
    resolve_device,
)
from repro_torch.numerics.quant import KV_DTYPES
from repro_torch.serve.paged import BlockPool, blocks_for, kv_token_bytes
from repro_torch.serve.sampling import row_seed, sample_tokens


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str | None = None   # "length" once done
    pos: int = 0            # prefill cursor into ``prefill_toks``
    admit_order: int = -1   # admission sequence number (victim selection)
    # teacher-forced prefix: the prompt, extended with already-generated
    # tokens after a preemption (recompute resumption)
    prefill_toks: list = dataclasses.field(default_factory=list)
    submit_time: float | None = None       # host clock at submit()
    first_token_time: float | None = None  # host clock when out[0] arrived


class ServeEngine:
    def __init__(self, params, cfg, *, slots: int = 8, max_len: int = 512,
                 chunk_size: int = 64, temperature: float = 0.0,
                 seed: int = 0, kv_layout: str = "contiguous",
                 page_size: int | None = None,
                 pool_blocks: int | None = None,
                 kv_dtype: str | None = None,
                 attention_impl: str | None = None,
                 prefix_cache: bool | None = False,
                 device="cuda"):
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"kv_layout must be 'contiguous' or 'paged', "
                             f"got {kv_layout!r}")
        if prefix_cache:
            raise NotImplementedError("the port has no prefix cache yet; "
                                      "serve with prefix_cache=False")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2 (one prompt token plus "
                             f"one generated), got {max_len}")
        if int(chunk_size) < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        kv_dtype = kv_dtype or cfg.kv_dtype
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}; choose one of "
                             f"{KV_DTYPES}")
        cfg = cfg.replace(kv_dtype=kv_dtype)
        if attention_impl is not None:
            cfg = cfg.replace(attention_impl=attention_impl)
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of "
                             f"{ATTENTION_IMPLS}, got {cfg.attention_impl!r}")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.chunk_size = int(chunk_size)
        self.temperature = temperature
        self.seed = seed
        self.kv_layout = kv_layout
        self.paged = kv_layout == "paged"
        if self.paged:
            ps = int(page_size or cfg.page_size)
            max_blocks = blocks_for(max_len, ps)
            requested = int(pool_blocks or cfg.pool_blocks or 0)
            if requested:
                # an unquantized-equivalent byte budget (DESIGN.md §8)
                n_pool = max(1, requested * kv_token_bytes(cfg, "fp32")
                             // kv_token_bytes(cfg))
            else:
                n_pool = slots * max_blocks  # fully provisioned
            self.page_size = ps
            self.pool = BlockPool(n_pool, ps, slots, max_blocks)
            self.state = init_paged_state(cfg, slots, n_pool, ps,
                                          device=self.device)
        else:
            self.page_size = 0
            self.pool = None
            self.state = init_decode_state(cfg, slots, max_len,
                                           device=self.device)
        self.lengths = np.zeros((slots,), np.int32)
        self.cur_tok = np.zeros((slots,), np.int32)
        self.requests: list[Request | None] = [None] * slots
        self.queue: list[Request] = []
        self._admit_seq = 0
        self._next_rid = 0
        self._rids: set = set()
        self.ticks = 0
        self.prefill_steps = 0
        self.decode_steps = 0
        self.prompt_tokens = 0       # prompt tokens absorbed
        self.recompute_tokens = 0    # generated tokens re-prefilled
        self.tokens_generated = 0
        self.preemptions = 0

    # -- request lifecycle --------------------------------------------------
    def submit(self, prompt, max_new: int, rid: int | None = None) -> Request:
        """Queue a request; raises ValueError on an empty or oversized
        prompt, ``max_new < 1`` or a duplicate ``rid``."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt: a request needs at least one "
                             "token to produce logits")
        if len(prompt) > self.max_len - 1:
            raise ValueError(f"prompt length {len(prompt)} exceeds max_len "
                             f"- 1 = {self.max_len - 1}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if rid is None:
            rid = self._next_rid
        elif rid in self._rids:
            raise ValueError(f"duplicate rid {rid}")
        self._rids.add(rid)
        self._next_rid = max(self._next_rid, rid + 1)
        req = Request(rid, prompt, max_new, prefill_toks=list(prompt),
                      submit_time=time.perf_counter())
        self.queue.append(req)
        return req

    def _admit(self):
        for s in range(self.slots):
            if self.requests[s] is not None or not self.queue:
                continue
            req = self.queue[0]
            take = (min(self.chunk_size, len(req.prefill_toks))
                    if self.chunk_size > 1 else 1)
            if self.paged and not self.pool.can_admit(take):
                if self.pool.used_blocks == 0 and not any(
                        r is not None for r in self.requests):
                    raise RuntimeError(
                        f"KV pool too small: request {req.rid} needs {take} "
                        f"tokens for its first chunk but the whole pool "
                        f"holds {self.pool.pool_blocks * self.page_size}; "
                        f"raise pool_blocks")
                break  # pool too tight right now; retry as blocks free
            self.queue.pop(0)
            if req.admit_order < 0:
                # seniority survives preemption, so two requests that do not
                # fit together cannot evict each other forever
                req.admit_order = self._admit_seq
                self._admit_seq += 1
            self.requests[s] = req
            req.pos = 0
            self.lengths[s] = 0
            self.cur_tok[s] = req.prefill_toks[0]

    def _release_slot(self, s: int):
        """Finish the request in slot ``s`` (its length budget is spent)."""
        req = self.requests[s]
        req.done = True
        req.finish_reason = "length"
        self.requests[s] = None
        if self.paged:
            self.pool.free_slot(s)

    def _finish_or_continue(self, s, tok):
        """Record a sampled token for slot s; free the slot when done."""
        req = self.requests[s]
        if req.first_token_time is None:
            req.first_token_time = time.perf_counter()
        req.out.append(tok)
        self.cur_tok[s] = tok
        self.tokens_generated += 1
        if len(req.out) >= req.max_new or self.lengths[s] >= self.max_len - 1:
            self._release_slot(s)

    # -- paged capacity management ------------------------------------------
    def _preempt(self, s):
        """Evict slot s and requeue its request for recompute resumption."""
        req = self.requests[s]
        self.pool.evict_slot(s)
        self.requests[s] = None
        self.lengths[s] = 0
        req.prefill_toks = list(req.prompt) + list(req.out)
        req.pos = 0
        self.preemptions += 1
        self.queue.insert(0, req)  # resumes as soon as space frees up

    def _pick_victim(self, exclude):
        """Youngest active request (latest admitted) other than ``exclude``."""
        best = None
        for s in range(self.slots):
            if s == exclude or self.requests[s] is None:
                continue
            if best is None or (self.requests[s].admit_order
                                > self.requests[best].admit_order):
                best = s
        return best

    def _take_for(self, s) -> int:
        req = self.requests[s]
        if self.chunk_size > 1 and req.pos < len(req.prefill_toks):
            return min(self.chunk_size, len(req.prefill_toks) - req.pos)
        return 1

    def _reserve(self, active):
        """Grow block tables for this tick's writes, oldest request first;
        preempt youngest-first when the pool is exhausted. Returns the
        surviving active slots."""
        for s in sorted(active, key=lambda s: self.requests[s].admit_order):
            if self.requests[s] is None:
                continue  # preempted by an older request's reservation
            target = int(self.lengths[s]) + self._take_for(s)
            while not self.pool.alloc(s, target):
                victim = self._pick_victim(exclude=s)
                if victim is None:
                    raise RuntimeError(
                        f"KV pool exhausted: slot {s} needs {target} tokens "
                        f"({blocks_for(target, self.page_size)} blocks, "
                        f"pool={self.pool.pool_blocks}) with no one left "
                        f"to evict; raise pool_blocks")
                self._preempt(victim)
        return [s for s in range(self.slots) if self.requests[s] is not None]

    # -- engine steps -------------------------------------------------------
    def _tensor(self, a):
        return torch.tensor(a, device=self.device)

    def _sample(self, logits):
        seeds = [self.seed if r is None else
                 row_seed(self.seed, r.admit_order, len(r.out))
                 for r in self.requests]
        nxt = sample_tokens(seeds, logits, temperature=self.temperature)
        return nxt.cpu().numpy()

    def _prefill_tick(self, active):
        """One chunked step: prefilling slots absorb up to chunk_size prompt
        tokens; decode-ready slots ride along as 1-valid chunks."""
        C = self.chunk_size
        toks = np.zeros((self.slots, C), np.int32)
        nv = np.zeros((self.slots,), np.int32)
        for s in active:
            req = self.requests[s]
            if req.pos < len(req.prefill_toks):
                take = min(C, len(req.prefill_toks) - req.pos)
                toks[s, :take] = req.prefill_toks[req.pos:req.pos + take]
            else:
                take = 1
                toks[s, 0] = self.cur_tok[s]
            nv[s] = take
        args = (self.params, self.state, self._tensor(toks),
                self._tensor(self.lengths), self._tensor(nv))
        if self.paged:
            logits, self.state = prefill_paged(
                *args, self._tensor(self.pool.tables), self.cfg,
                page_size=self.page_size)
        else:
            logits, self.state = prefill(*args, self.cfg)
        nxt = self._sample(logits)
        self.ticks += 1
        self.prefill_steps += 1
        for s in active:
            req = self.requests[s]
            take = int(nv[s])
            self.lengths[s] += take
            if req.pos < len(req.prefill_toks):  # was prefilling this step
                recompute = max(0, min(req.pos + take, len(req.prefill_toks))
                                - max(req.pos, len(req.prompt)))
                req.pos += take
                self.prompt_tokens += take - recompute
                self.recompute_tokens += recompute
                if req.pos < len(req.prefill_toks):
                    continue                    # still mid-prompt: no sample
            self._finish_or_continue(s, int(nxt[s]))

    def _decode_tick(self, active):
        """Single-token step; with chunk_size=1 it also teacher-forces
        prompts."""
        args = (self.params, self.state, self._tensor(self.cur_tok),
                self._tensor(self.lengths))
        if self.paged:
            logits, self.state = decode_step_paged(
                *args, self._tensor(self.pool.tables), self.cfg,
                page_size=self.page_size)
        else:
            logits, self.state = decode_step(*args, self.cfg)
        nxt = self._sample(logits)
        self.ticks += 1
        self.decode_steps += 1
        for s in active:
            req = self.requests[s]
            if self.lengths[s] < len(req.prefill_toks):
                if self.lengths[s] < len(req.prompt):
                    self.prompt_tokens += 1
                else:
                    self.recompute_tokens += 1
            self.lengths[s] += 1
            req.pos = max(req.pos, int(self.lengths[s]))
            pos = int(self.lengths[s])
            if pos < len(req.prefill_toks):     # teacher-forcing (chunk=1)
                self.cur_tok[s] = req.prefill_toks[pos]
            else:
                self._finish_or_continue(s, int(nxt[s]))

    def tick(self) -> bool:
        """Advance the engine by one step (prefill or decode)."""
        self._admit()
        active = [s for s in range(self.slots) if self.requests[s] is not None]
        if not active:
            return False
        if self.paged:
            active = self._reserve(active)
            if not active:
                return bool(self.queue)
        prefilling = self.chunk_size > 1 and any(
            self.requests[s].pos < len(self.requests[s].prefill_toks)
            for s in active)
        if prefilling:
            self._prefill_tick(active)
        else:
            self._decode_tick(active)
        return True

    def run(self):
        """Tick until every request is done."""
        while self.tick() or self.queue:
            pass
