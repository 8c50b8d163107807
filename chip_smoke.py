#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--phases "build,kimi checks,..."]

from the repository root, on a machine with an NVIDIA Hopper card, PyTorch
built for CUDA and the CUDA toolkit. It imports nothing of JAX or of the
JAX package. It drives both serving KV layouts (the paged pool and the
per-slot contiguous caches with rolling windows) for qwen2-0.5b,
gemma-7b, minicpm3-4b (MLA: latent caches, expanded K/V at head dims
96 and 64), arctic-480b (MoE top-2 with a dense residual, head dim
128; depth cut to 2 of its 35 layers), kimi-k2-1t-a32b (MoE with 384
experts at top-8, head dim 112, GQA group 8, an untied head over 163,840
tokens; depth cut to 2 of its 61 layers), recurrentgemma-2b (RG-LRU
blocks beside local-attention MQA blocks: GQA group 10 at head dim 256,
a 2,048-token window), xlstm-1.3b (mLSTM and sLSTM blocks, no
attention layer, so no kernel: per-slot matrix memory on both layouts)
and llava-next-34b (576 projected image patches before the text; GQA
group 7 at head dim 128); it runs seamless-m4t-medium (an
encoder-decoder: LayerNorm, a GELU FFN, cross-attention over 1,024 stub
frames) through its encoder and decode steps, the training path (on one
device and through the train launcher's mesh path at world 1), and
the paper's demonstrations (the quickstart and the Table I study).
Phases (a failing check raises, and the script exits non-zero; the
``[phase]`` lines print each one's seconds; ``--phases`` runs the named
ones alone, in this order, and prints no kernels line and no result):

1. print the card's name and power limit; build the kernels from
   ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
2. hold each CUDA kernel against its plain PyTorch version on the card:
   {exact, expmul} x {bf16 values, int8 codes} x {float32, bfloat16 q} x
   head dims {16, 64}, with dyadic inputs (exact scores) and random
   N(0,1) inputs. Paged: shuffled, fragmented block tables with NaN in
   every unreferenced page, ragged lengths and an idle row. Contiguous:
   ragged lengths, an idle row, a length of exactly S and large finite
   stale rows past each length; prefill on fresh caches and on rolling
   buffers (wrapped, shorter than the span, a chunk longer than the span,
   a window narrower than the span, n_valid = 0). Then the edges of the
   redesigned contiguous kernels: decode at S = 2048 over lengths 0, 1,
   255, 256, 257 and 2048 (0 to 8 tiles of a thread-block cluster, so
   idle ranks too) for GQA groups 1, 7 and 32, and at S = 32768 (up to 16
   rounds of the cluster, the last one partly idle) for group 7 over
   float32 values and int8 codes; and prefill chunks of C in
   {1, 15, 100, 256} rows (not multiples of the 32-row query block),
   float32 and bfloat16 q over fp32 caches and int8 codes, n_valid 0 on
   one row. And the edges of the redesigned paged kernels: decode over
   lengths 0, 1, ps - 1, ps, ps + 1 and the table's full width, and a row
   with a sentinel inside its length, for GQA groups 1, 7 and 32 at pages
   of 16 and 32 over float32 values and int8 codes, and over a
   32,768-token context (2,048 pages of 16) for group 7; prefill chunks of
   C in {1, 15, 100, 256} over 0, 1 page and 1,000 tokens of history,
   float32 and bfloat16 q. Kernel and plain version walk the same tiles
   and sum both products in the same order
   (``kernels/flash/tile.py:fma_chain``), so each is held at
   ``checks.kernel_tol``: 1e-5 of the output's magnitude, or one bf16 ulp
   for the exact variant's bfloat16 output. Then each serving kernel on
   a poisoned page (``checks.poisoned_case``: NaN values, or int8 codes
   of -128 with NaN scales, in the first, a middle or the last page of a
   1,000-token sequence, or in its rows past the length; exact and
   ExpMul, f32 and int8): the kernel's non-finite output rows exactly its
   plain version's, its finite rows within ``kernel_tol``.
   The full-sequence flash forward likewise, over {exact, expmul} x
   {float32, bfloat16} x D {64, 128} x block_k {128, 512} x {dyadic,
   random}, B 2, 14 / 2 heads: Sq = Sk in {1024, 1000} causal, with and
   without a 256-token window, and non-causal 200 queries over 1000 keys;
   and at head dim 32 (the fidelity model's) its shape and a ragged
   causal 1000; and the edges of its register-tiled layout
   (``checks.flash_edge_cases``): Sq = Sk in {1, 31, 33, 65, 1000}, causal,
   with a window ending inside a 64-row sub-tile, and over keys past
   kv_len (causal and not), GQA groups 1 and 7, D {16, 32, 64, 128} x
   {float32, bfloat16} x {dyadic, random}; then the standalone ExpMul
   kernel bit for bit against its
   plain version and the frexp/ldexp oracle (raw bits), over the
   reference's sweep and (114688, 65), float32 and bfloat16, with the
   contract's edge values, and the merged [l, o] update through it; and
   for NaN and inf x, outside the contract, kernel bits equal to the plain
   version's on the card and on the host, a NaN x leaving v unchanged (as
   the reference's L_hat 0 does);
2b. the four serving kernels at gemma-7b's head dims, 32 (its smoke
   config) and 256, against their plain versions
   (``checks.head_dim_cases``: 16 / 16 heads, B 4, lengths across the
   256-wide decode tiles and the 512-wide prefill tiles, a length 0, a
   chunk with n_valid 0) over float32, bfloat16, int8 and fp8 KV, exact
   and ExpMul, float32 and bfloat16 q, and GQA group 4 at 256; the largest
   group each decode kernel takes at 256 by KV dtype, from its shared
   memory, and a float32 launch one group past it refused with a
   ValueError before any launch;
2c. the contiguous decode and prefill at minicpm3-4b's head dims (K rows
   of 96, V rows of 64) against their plain versions
   (``checks.mla_cases``: 4 / 4 heads, lengths 0, 1, 300 and S, a
   partial chunk and n_valid 0, stale rows past every length) over
   float32 and bfloat16 KV, exact and ExpMul, float32 and bfloat16 q; a
   NaN row inside or past a length (non-finite rows the plain version's);
   int8 codes at 96/64 and a pair not built refused before any launch;
2d. the four serving kernels at arctic-480b's head dim 128 (in phase
   2b's function): ``checks.head_dim_cases`` over every KV dtype, exact
   and ExpMul, GQA groups 1 (8 / 8 heads, float32 q), 7 (56 / 8,
   arctic's, bfloat16 q) and 32 (32 / 1, float32 q); a paged decode whose
   shared memory is over the card's limit (group 32 over float32 and
   bfloat16 pools) refused before its launch; each kernel on a poisoned
   page at 128; the largest group each decode kernel takes at 128 by KV
   dtype, and a float32 launch one group past it refused;
2e. the MoE router's top-k (a stable descending sort) on the card against
   the CPU's and ``jax.lax.top_k``'s known ids: ties, an all-NaN row,
   +-inf, and 2,048 x 128 logits on a 0.25 grid, top-2 and top-8, and
   2,048 x 384 (kimi's experts) at top-8;
2f. the four serving kernels at recurrentgemma-2b's local attention
   (``checks.windowed_cases``: 10 / 1 heads of 256, a 2,048-token window;
   histories of 1,024, 2,048, 2,049, 3,000 and 3,584 tokens, window
   floors inside a page and a tile, a rolling buffer of span 2,048 that
   every long history has wrapped, an idle row) against their plain
   versions, float32 and bfloat16 values and q, exact and ExpMul, at
   ``checks.kernel_tol``;
2g. the flash kernel non-causal at Sq != Sk, as cross-attention calls it
   (``checks.flash_cross_cases``: 1, 7 and 33 queries over 16 and 1,024
   keys, tiles of ``min(512, Sk)``) at D 64 group 1 and D 128 group 7,
   float32 and bfloat16, dyadic and random, exact and ExpMul, at
   ``checks.kernel_tol``; and the cross-attention decode's one-pass
   plain route on the card against the CPU;
2h. the four serving kernels at kimi-k2-1t-a32b's head dim 112
   (``checks.head_dim_cases``) over float32, bfloat16, int8 and fp8 KV,
   exact and ExpMul, dyadic and random inputs, at ``checks.kernel_tol``:
   GQA group 8 (64 / 8 heads, kimi's) with float32 and bfloat16 q, group
   1 and the largest group every decode kernel takes; each kernel on a
   poisoned page at 112; the largest group each decode kernel takes at
   112 by KV dtype, and a float32 launch one group past it refused before
   any launch;
2i. flash at head dims 96, 112 and 256 (``phase_flash_head_dim_checks``):
   causal 1,024 and windowed 1,000 at each arch's heads, recurrentgemma-2b's
   10 / 1 heads windowed at 2,048 over 3,000 tokens, the layout's edges
   (``checks.flash_edge_cases`` at 1, 33 and 1,000 tokens, groups 1 and
   7) and the cross shapes
   (``checks.flash_cross_cases``, groups 1 and 8), float32 and bfloat16,
   dyadic and random, exact and ExpMul, at ``checks.kernel_tol``;
3. qwen2-0.5b at full width in float32 (TF32 off), through the kernels and
   through the plain versions: on each layout one prefill tick, a second
   prefill tick over that history and one decode tick; then a windowed
   pair of prefill ticks (window 256, two 256-token chunks, so the
   contiguous rolling buffer wraps). Logits within 1e-3 of their
   magnitude for exact, the gap printed for ExpMul;
3b. gemma-7b at full width (head dim 256, GeGLU, scaled embeddings),
   depth cut to 4 layers for the plain runs, float32: the same ticks on a
   paged int8 pool and on contiguous fp32 caches, gated as in 3;
3c. minicpm3-4b at full width, depth 8 of 62 (bf16, ExpMul): the
   ticks of phase 3 on a paged int8-latent pool and on contiguous fp32
   caches, kernels against plain versions, ExpMul logits gated at 1e-3;
3d. arctic-480b at full width, depth 2 (bf16, ExpMul; run with its
   serving phase 4f on one draw of its weights, ``phase_moe``): the ticks
   of phase 3 on a paged int8 pool and on contiguous fp32 caches, kernels
   against plain versions; each MoE layer's routes compared first (top-k
   ids and kept copies, token by token): a token routed otherwise in a
   row that had not diverged must be within 1e-3 of a router tie, and
   the logits of rows routed alike are gated within 1e-3;
3g. kimi-k2-1t-a32b at full width, depth 2 (bf16, ExpMul, 384 experts at
   top-8, head dim 112; with its serving phase 4l on one draw of its
   weights): the ticks and gates of 3d;
3e. recurrentgemma-2b at full width, depth 13 of 26 (bf16, ExpMul):
   two prefill ticks of 1,152-token chunks (three rows past the window)
   and a decode tick on a paged fp32 pool and on contiguous fp32 caches
   (bf16 rows), kernels against plain versions: logits within 1e-3 of
   their magnitude, every RG-LRU layer's ``h`` and ``conv`` bit for bit
   before the first attention layer and within 1e-2 after it;
3f. llava-next-34b at full width, depth cut to 4 layers, float32: 576
   projected patches prepended to 64 text tokens through ``forward`` on
   the kernels and on the plain versions, exact and ExpMul (logits within
   1e-3, one flash launch a layer); then the ticks of phase 3 on a paged
   int8 pool and on contiguous fp32 caches, gated as in 3;
4. serving at full width: ``ServeEngine`` with 8 slots, 16 requests of
   128-1024 prompt tokens and 32 new tokens each, ExpMul, temperature 0,
   on three layouts: a paged int8 pool (its shared-prefix cache on, the
   default), then contiguous caches at kv_dtype fp32 (the CLI's default)
   and int8. Each layout is served with its ticks replaying CUDA graphs
   (the engine's default on the card, ``serve/graphs.py``) and, as a
   witness, with eager ticks (``eager_ticks=True``): the temp-0 streams
   must be equal. The kernel launch counts are set to 0 just before each
   run and read just after: the run's two kernels must have launched, and
   no other kernel or plain version; under graphs the counts must be each
   graph's replays times its captured launches. Each run and a profiled
   window of each (one prefill and four decode ticks, after the ticks that
   capture) print tokens/s, TTFT p50, the tick p50s, the idle share, the
   capture and warm-up ms, the graph pool's bytes and the peak memory,
   graphs beside eager. The eager runs' tokens/s and TTFT are printed
   beside their values before the paged kernels' redesign. The paged
   graph run is served once more, with the engine's dispatch counters off
   (streams gated equal), its tick p50s beside the first run's (on);
4b. the shared-prefix cache at full width, every tick replaying a CUDA
   graph (bf16, ExpMul, the same seed-2 weights), paged int8, pages of
   16, 8 slots, ``max_len`` 2048,
   temperature 0: a 1,024-token system prompt and 16 distinct tails of
   32-512 tokens, 32 new tokens each, served cold (cache off) and warm
   (cache on, first seeded with the system prompt plus one token), both
   traced. At chunk 256 the warm streams must equal the cold ones token
   for token, with at least 16 x 1,024 hit tokens; at chunk 200 (4
   requests) the chunk grid puts the resume cursor at 1,000, inside page
   62, so every warm request copies that page on write (at least 4
   copies) and the streams must still equal the cold ones. Each run is
   gated on the two paged kernels alone (counts set to 0 before it, read
   after), on ``check_consistency()`` and on no block left in use; it
   prints tokens/s, TTFT p50, prefill steps, prompt tokens prefilled and
   the tick spans' host-clock p50;
4c. fault-tolerant serving (DESIGN.md §13) at full width (bf16, ExpMul,
   the seed-2 weights), paged int8, pages of 16, 8 slots, ``max_len``
   2048, chunk 256, temperature 0, 8 requests of 128-512 prompt tokens
   and 32 new tokens each: (a) a fault-free baseline; (b) a delay storm
   (``pool_alloc``, ``admission`` and ``preempt`` at fixed
   opportunities), run twice: the two runs' streams equal token for
   token, every request "length", at least 4 preemptions and recomputed
   tokens, the agreement with the baseline printed; (c) ``kv_corrupt``
   on one request at a decode tick and ``logits`` on another: exactly
   those two "failed", 2 quarantined, every other stream the baseline's,
   under ExpMul and under exact; (d) the kv_corrupt victim's prompt
   again: "length" with the baseline's stream; (e) a ``deadline_steps``
   request finishes "deadline" with a prefix of its stream, one cancelled
   mid-prefill and one mid-decode, the rest the baseline's; (f) a
   snapshot after the first tick (slots prefilling and decoding) restored
   into a fresh engine on the card: the baseline's streams, paged int8
   and contiguous fp32, with the snapshot's bytes and save and restore
   times. Every run replays CUDA graphs, on its layout's two kernels
   alone, its pool consistent and empty after it; (a) is served once more
   with eager ticks, its streams gated equal to the graphs'; tokens/s,
   TTFT p50 and tick p50 of (a) and (b) printed;
4d. gemma-7b served at full width and depth (bf16, ExpMul, seed-2 random
   weights) as phase 4 serves qwen2-0.5b, on a paged int8 pool and on
   contiguous fp32 caches, each with graph ticks and eager ticks: streams
   gated equal, launches gated as in 4; tokens/s, TTFT p50, tick p50s and
   peak memory printed;
4e. minicpm3-4b served the same way (8 of 62 layers, bf16, ExpMul, seed-2
   weights), paged int8 latents and contiguous fp32: streams gated
   equal, and each run on the contiguous decode and prefill alone (an
   MLA pool holds latents, gathered and expanded each tick), neither
   paged kernel;
4f. arctic-480b served the same way at depth 2 (``phase_gemma_serve``
   with the cut; 27.7B parameters, seed-2 bf16 weights), paged int8 and
   contiguous fp32, graphs against eager, each run on its layout's two
   kernels alone, its paged graph ticks profiled (where an MoE tick's
   time goes);
4l. kimi-k2-1t-a32b served as 4f at depth 2 (36.4B parameters, 67.8 GiB
   of seed-2 bf16 weights), at head dim 112 on both layouts, with the
   weight draw's seconds and the phase's peak memory;
4g. recurrentgemma-2b served at full width (bf16, ExpMul, seed-2
   weights): (a) phase 4's traffic at depth 13 of 26 on a paged fp32 pool
   and on contiguous fp32 caches (bf16 rows; int8 is refused for a
   recurrent pattern), graphs against eager, each run on its layout's two
   kernels alone, once a tick in each of the 4 attention layers, the
   paged graph ticks profiled with the device time by kernel family (the
   recurrence loop's elementwise kernels, the GEMMs, attention); (b)
   windowed traffic at full depth, 8 requests of 2,304-3,840 prompt
   tokens (every rolling buffer wraps), 32 new each, ``max_len`` 4096,
   graph ticks on both layouts: every request finishes, launches gated,
   the layouts' stream agreement printed;
4h. xlstm-1.3b at full width, depth 8 of 48 (7 mLSTM, 1 sLSTM;
   bf16, seed-0 weights): two prefill ticks of 32-token chunks and a
   decode tick on a paged state and on contiguous caches, logits and
   every state leaf bit for bit equal; 8 requests served by a graph
   engine and an eager engine in lockstep on each layout, every tick's
   logits and recurrent state bit for bit, written in place; ``forward``
   against a ``decode_step`` loop over 288 tokens, float32 at depth 8
   gated at 1e-3 of the logits' magnitude, bf16 at depth 8 gated at 0.1
   (``phase_xlstm_ticks`` says why);
4i. xlstm-1.3b served at full width, depth 8 (bf16, seed-2 weights), 16
   requests of 32-128 prompt tokens, 32 new each, 8 slots, chunk 32, on a
   paged state and on contiguous caches under graphs: no kernel launched,
   the layouts' streams gated equal; tokens/s, TTFT, tick p50s, peak
   memory; one prefill and one decode tick profiled (busy time, idle
   share, top kernels);
4j. llava-next-34b served at full width, depth 8 of 60 (bf16,
   ExpMul, seed-2 weights; ``phase_gemma_serve``) as phase 4 serves
   qwen2-0.5b, paged int8 and contiguous fp32, graphs against eager,
   each run on its layout's two kernels alone; then one timed
   ``forward`` of 1 x (576 + 512) tokens with frontend embeddings on the
   served weights: one flash launch a layer and nothing else;
4k. seamless-m4t-medium at full width and depth (12 + 12 layers, bf16,
   ExpMul): a teacher-forced ``forward`` (36 flash launches: the
   encoder's 12 at 1,024 frames, each decoder layer's self-attention and
   cross-attention at 16 queries against 1,024), then 8 requests encoded
   once (``enc_len`` 640-1,024; 12 flash launches) and decoded greedily
   (prompts of 4-16 tokens, 32 new), kernels and plain versions in
   lockstep: encoder output and every step's logits within 1e-3, 12
   decode launches a step and nothing else, streams equal; encode ms,
   decode-step p50, tokens/s and peak memory printed;
5. per-kernel times at the serving shapes (int8 codes, ExpMul, 8
   sequences of 1024 tokens, 256-token chunks, bf16 q) and, for the flash
   forward, at the training shapes (8 x 1024 tokens, float32, causal,
   ExpMul, 512-wide tiles) and, for ExpMul, at the flash recurrence's
   state of the training shapes ((114688, 64) float32 and bfloat16,
   (114688, 65) float32): the median of 11 runs timed with CUDA events
   after warm-up, L2 flushed before each, beside the plain version's time
   (a median of 5),
   the least time the card could take and each kernel's time at commits
   d4109f5 (before the contiguous kernels' redesign), 35522df (before
   the paged kernels') and 1f2c920 (before the flash kernel's); flash's
   achieved rate beside the float32 CUDA-core rate and its TF32 bound;
   with the compiler's registers and spills of the four serving kernels'
   serving instantiations and flash's training one, and the shared memory
   a CTA of each is given, as the kernel's source reports it (the paged
   decode's at 1,024 and 32,768 tokens of context, gated equal); then the
   four serving kernels at gemma-7b's serving shapes (16 / 16 heads of
   256, the rest as above, the plain versions' median of 3 runs), with
   the registers, spills and shared memory of every KV dtype's head-dim
   256 instantiation;
5c. the contiguous decode and prefill at minicpm3-4b's serving shapes
   (bf16 expanded K/V at 96/64, ExpMul, bf16 q, 8 x 1,024 tokens, 40 /
   40 heads, chunk 256): device and launch times, the bound, the plain
   version, float32 K/V beside, the exact-bf16 yardstick against SDPA
   under each backend that takes Dv != D, registers, spills and shared
   memory;
5d. the four serving kernels at arctic-480b's serving shapes (56 / 8
   heads of 128, the rest as phase 5), with the registers, spills and
   shared memory (at its group of 7) of every KV dtype's head-dim 128
   instantiation;
5g. the four serving kernels at kimi-k2-1t-a32b's serving shapes (64 / 8
   heads of 112, the rest as phase 5), with the registers, spills and
   shared memory (at its group of 8) of every KV dtype's head-dim 112
   instantiation;
5e. the four serving kernels at recurrentgemma-2b's serving shapes (bf16
   values, ExpMul, bf16 q, 8 x 3,072 resident tokens, window 2,048, 10 /
   1 heads of 256, chunk 256): device and launch times, the bound from
   this run's windowed work, the plain version, the exact-bf16 yardstick
   against SDPA under the same windowed mask, and the shared memory a
   CTA at group 10;
5f. flash at this slice's new shapes (bf16, ExpMul): llava-next-34b's
   frontend forward (1 x 1,088, 56 / 8 heads of 128, causal),
   seamless-m4t-medium's encoder (8 x 1,024, 16 / 16 heads of 64,
   non-causal) and cross-attention (16 queries over 1,024), and the
   contiguous decode at seamless's self-attention (D 64, group 1): device
   and launch times, the plain version, the bound, the exact variant
   against SDPA;
5h. flash at the training shapes of head dims 256, 112 and 96
   (float32, ExpMul, 8 x 1,024, causal): gemma-7b's 16 / 16 heads of 256,
   kimi-k2-1t-a32b's 64 / 8 of 112, minicpm3-4b's 40 / 40 of 96: device
   and launch times, the plain version, the bound, float32 SDPA; their
   registers, spills and shared memory a CTA (in phase 5's resources);
6. training at full width: qwen2-0.5b in float32 (TF32 off) with random
   weights, ExpMul, synthetic batches of 8 x 1024 tokens, AdamW on a
   cosine schedule. One train step through the flash kernel and one
   through its plain version from the same weights: the loss within 1e-5
   and the grad norm within 1e-4 of their values. Then 3 steps through
   ``repro_torch.launch.train.main`` with the launch counts set to 0 just
   before and read just after: every loss finite, the flash kernel
   launched 48 times a step (24 layers, twice under remat), and no other
   kernel or plain version. Then the step time (p50 of 4 steps), tokens/s,
   peak memory, and a one-step profiler window with flash's device time
   and share of the step's busy time;
6b. gemma-7b (flash at head dim 256) and minicpm3-4b (MLA, flash at 96,
   V zero-padded to it) trained as phase 6 at full width, their depth cut
   to 2 of 28 and 4 of 62 layers (the functional step holds the old and
   the new state side by side), 3 launcher steps each gated on 2 x layers
   flash launches a step; the allocator's expandable segments on for
   these two phases only;
6c. every registered arch through ``launch.main([... "--smoke", "--steps",
   "2"])`` (2 x 64 tokens): finite losses, flash twice an attention call
   a step and nothing else (xlstm-1.3b none), bfloat16 moments for
   arctic-480b and kimi-k2-1t-a32b, zero frontend embeddings for the
   frontend archs, and qwen2-0.5b once more with ``--compress-grads``;
6d. the multi-device plan ("plan"): ``repro_torch.launch.dryrun``'s
   ``lower_cell`` on this host over a fake process group, for qwen2-0.5b
   train_4k on the 16 x 16 mesh and kimi-k2-1t-a32b decode_32k on
   2 x 16 x 16: each cell's compute, memory and collective seconds under
   the H100 roofline, its bottleneck and its GiB a device, gated on the
   attention calls it counts, on the plan itself (the ops it resharded
   for, the three terms and the GiB a device equal to the plan that
   ``python -m repro_torch.launch.dryrun`` counted for the cell on
   another torch, ``PLAN_CELLS``: a torch whose DTensor lays the cell
   out otherwise fails here) and no process group left behind;
6e. "counted step": one phase-6 qwen2-0.5b train step inside the op
   counter (``launch/op_costs.py``): its loss and grad norm bit for bit
   those of the same step uncounted, its counted flash calls the flash
   launches, its counted FLOPs 1-2x the model's 6ND, and the measured
   step p50 no faster than the roofline's step time (each FLOP type at
   its own peak: the float32 products and attention at 67 TFLOP/s),
   whose share is printed beside the card's name and power limit;
6f. "flash offset": the flash kernel at a query offset, as each rank of
   a query-split causal call runs it: at qwen2-0.5b's training shape
   (8 x 1,024, 14 / 2 heads of 64, causal, 512-wide tiles), exact and
   ExpMul, float32 and bfloat16, and at gemma-7b's head dim 256, the
   call on ``q[:, :, a:]`` at ``q_offset=a`` bit for bit rows a: of the
   whole call for a in 256, 512, 768, and at a = 100 within
   ``checks.kernel_tol`` of the plain version; the call at a = 512 timed
   beside the whole call, its plain version, its bound and SDPA;
6g. "mesh train": the train launcher's mesh path at world 1 over NCCL
   on a (1, 1) mesh (DTensor state, ``ShardedLoader``, the flash kernel
   per shard): qwen2-0.5b at full width and depth, float32, 3 steps of
   8 x 1,024 tokens with a checkpoint at step 2, then a resume from it on
   a fresh process group; the losses gated bit for bit against the
   one-device launcher's (phase 6's) and the resumed step against the
   uninterrupted one, the launches 48 flash a step and nothing else, no
   process group left; the resumed launcher runs on for 4 more steps
   with no checkpoint: the p50 of its steps 2-4 beside phase 6's and its
   step 5 profiled (device busy time and idle share beside phase 6's
   profiled step), and the peak memory printed;
7. ``python -m repro_torch.launch.quickstart`` and then ``python -m
   repro_torch.launch.fidelity`` on the card, the launch counts set to 0
   just before each and read just after: the quickstart must launch the
   ExpMul and flash kernels and no plain version, its outputs agreeing
   with the plain versions; the study (200 training steps, the four-row
   grid, the raw attention error) must launch flash only, with every
   perplexity finite; its table is printed, not gated;
8. one JSON line of kernels (each serving kernel with ``d256``,
   ``d128``, ``d112``, ``llava_d128``, ``rg_w2048`` and, for the
   contiguous pair, ``mla_96_64`` entries; flash with ``llava_frontend``,
   ``seamless_encoder``, ``seamless_cross``, and ``d256``, ``d112`` and
   ``d96`` with phase 6b's training runs, the counted step's and the
   mesh launcher's launches, and ``q_offset`` with phases 6f and 6g; the
   contiguous decode with ``seamless_d64_g1``), the card
   line, and as the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when no CUDA device is available
or when the package is not beside it.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 tensor cores (float32 in)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
KERNELS = {
    "paged_decode": ("src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/decode/decode.py:285"),
    "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                      "src/repro/kernels/flash/prefill.py:433"),
    "decode": ("src/repro_torch/csrc/decode.cu",
               "src/repro/kernels/decode/decode.py:144"),
    "prefill": ("src/repro_torch/csrc/prefill.cu",
                "src/repro/kernels/flash/prefill.py:245"),
    "flash": ("src/repro_torch/csrc/flash.cu",
              "src/repro/kernels/flash/flash.py:143"),
    "expmul": ("src/repro_torch/csrc/expmul.cu",
               "src/repro/kernels/expmul/expmul.py:57"),
}
PAGED, CONTIGUOUS = ("paged_decode", "paged_prefill"), ("decode", "prefill")
B, H, HKV, D, PS, MAX_LEN, CHUNK, CTX = 8, 14, 2, 64, 16, 2048, 256, 1024
# gemma-7b: 16 / 16 heads of 256 (the paper's largest head dim), and 32 in
# its smoke config
GEMMA, GEMMA_H, GEMMA_D, GEMMA_TICK_LAYERS = "gemma-7b", 16, 256, 4
# arctic-480b: 128 experts, top-2, a dense residual in parallel, 56 / 8
# heads of 128 (GQA group 7), an untied head; served at depth 2 of its 35
# layers (27.7B parameters, 55.4 GB in bf16)
ARCTIC, ARCTIC_H, ARCTIC_HKV, ARCTIC_D = "arctic-480b", 56, 8, 128
ARCTIC_GROUP, ARCTIC_LAYERS = ARCTIC_H // ARCTIC_HKV, 2
# kimi-k2-1t-a32b: 384 experts, top-8, no dense residual, 64 / 8 heads of
# 112 (GQA group 8), an untied head over 163,840 tokens; served at depth 2
# of its 61 layers (36.4B parameters, 67.8 GiB in bf16)
KIMI, KIMI_H, KIMI_HKV, KIMI_D = "kimi-k2-1t-a32b", 64, 8, 112
KIMI_GROUP, KIMI_LAYERS = KIMI_H // KIMI_HKV, 2
# minicpm3-4b: MLA, 40 / 40 heads, expanded K rows of 96 and V rows of 64;
# its ticks and serving at depth MLA_LAYERS of 62 (a cut that keeps the
# script inside its time limit; 16 until the multi-device phases came)
MLA, MLA_H, MLA_LAYERS = "minicpm3-4b", 40, 8
# recurrentgemma-2b: 18 RG-LRU blocks beside 8 local-attention blocks of
# 10 / 1 heads of 256 (GQA group 10), a 2,048-token window, a logit
# softcap; its ticks and phase 4's traffic at full width, depth RG_LAYERS
# of 26 (one unit of its pattern: 9 RG-LRU and 4 attention layers; a cut
# for the script's time), the windowed traffic at full depth. Its ticks'
# chunk (two of them pass the window) and its windowed serving shapes
RG, RG_H, RG_HKV, RG_D, RG_WINDOW = "recurrentgemma-2b", 10, 1, 256, 2048
RG_LAYERS = 13
RG_TICK_CHUNK, RG_CTX, RG_MAX_LEN = 1152, 3072, 4096
# xlstm-1.3b: 42 mLSTM and 6 sLSTM blocks, no attention layer, 4 heads
# (mLSTM heads of 768); ticked and served at full width, depth XLSTM_LAYERS
# of 48 (one unit of 7 mLSTM + 1 sLSTM; a cut for the script's time, two
# units until the multi-device phases came).
# Its ticks' and serving chunk, serving max_len, and the forward check's
# length (two chunkwise chunks of 144) and bf16 depth
XLSTM, XLSTM_CHUNK, XLSTM_MAX_LEN = "xlstm-1.3b", 32, 256
XLSTM_LAYERS = 8
XLSTM_FWD_SEQ, XLSTM_BF16_LAYERS = 288, 8
# llava-next-34b: a Yi-34B-class decoder, 56 / 8 heads of 128 (GQA group
# 7), an untied head, RoPE base 5e6, 576 projected patches prepended to the
# text; served at full width, depth LLAVA_SERVE_LAYERS of 60 (a cut for
# the script's time: all 60 are 64.07 GiB of bf16 weights, a peak of
# 66.4-68.2 GiB), its ticks at LLAVA_TICK_LAYERS in float32, its timed frontend
# forward over 576 patches and LLAVA_TEXT tokens on the served weights
LLAVA, LLAVA_TICK_LAYERS, LLAVA_TEXT = "llava-next-34b", 4, 512
LLAVA_SERVE_LAYERS = 8
# seamless-m4t-medium: 12 + 12 layers, 16 / 16 heads of 64, LayerNorm,
# non-gated GELU, cross-attention over 1,024 stub frames; 8 requests of
# prompts of 4-16 tokens, SEAMLESS_NEW greedy tokens each, and a
# teacher-forced forward of SEAMLESS_TEXT tokens
SEAMLESS, SEAMLESS_NEW, SEAMLESS_TEXT = "seamless-m4t-medium", 32, 16
TRAIN_SEQ, TRAIN_STEPS = 1024, 3   # 6 until the multi-device phases came
# training at full width, depth cut to keep a step's peak memory (weights,
# gradients, AdamW moments, the old and the new state side by side, and
# the float32 logits of 8 x 1,024 tokens) under ~70 GiB: gemma-7b at
# GEMMA_TRAIN_LAYERS of 28, minicpm3-4b at MLA_TRAIN_LAYERS of 62 (8 until
# the multi-device phases came); the launcher runs TRAIN_CUT_STEPS steps
# of each
GEMMA_TRAIN_LAYERS, MLA_TRAIN_LAYERS, TRAIN_CUT_STEPS = 2, 4, 3
FLASH_EDGE_SEQS = (1, 31, 33, 65, 1000)
# the reference's ExpMul sweep, and the flash recurrence's merged [l, o]
# rows at the training shapes (8 sequences x 14 heads x 1024 rows)
EXPMUL_SHAPES = [(1, 1), (3, 7), (8, 16), (32, 64), (128, 256), (257, 130),
                 (64, 1024), (114688, 65)]
EXPMUL_ROWS = B * H * TRAIN_SEQ
# each kernel's phase-5 time at commit d4109f5, before the contiguous
# kernels' redesign, at 35522df, before the paged kernels', and at 1f2c920,
# before the flash kernel's (as PERF.md records them; H100 80GB HBM3, 700
# W), ms
BEFORE_MS = {
    "d4109f5": {"paged_decode": 0.2399, "paged_prefill": 1.5433,
                "decode": 0.2962, "prefill": 1.2032, "flash": 1.7984,
                "expmul": 0.0272},
    "35522df": {"paged_decode": 0.2327, "paged_prefill": 1.5343,
                "decode": 0.0210, "prefill": 0.4999, "flash": 1.8059,
                "expmul": 0.0270},
    "1f2c920": {"paged_decode": 0.0279, "paged_prefill": 0.5774,
                "decode": 0.0213, "prefill": 0.5079, "flash": 1.8068,
                "expmul": 0.0272},
}
# the serving runs at 35522df, as PERF.md records them: tokens/s of the
# final tree's run, TTFT p50 (ms) of an earlier run of that change
BEFORE_SERVE = {"paged/int8": (254.2, 988.6), "contiguous/fp32": (273.4, 1089.4),
                "contiguous/int8": (227.3, 1202.2)}


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, flush, n=11, warmup=2, hide_host=True):
    """Median over ``n`` runs of ``fn`` between two CUDA events, the L2
    flushed before each. With ``hide_host`` a ~3 ms spin kernel runs
    first, so the host has enqueued ``fn``'s launches before the start
    event fires: the interval is then device time, launch overhead
    excluded, unless ``fn`` itself waits on the host (a plain version)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(5_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build(build):
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"[build] {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        lines = build.build_log(name).splitlines()
        regs = [int(l.split("Used ")[1].split()[0]) for l in lines
                if "Used " in l and "registers" in l]
        spills = [l.strip() for l in lines if "spill stores" in l
                  and not l.strip().startswith("0 bytes stack frame, 0 bytes")]
        log(f"[build] {name}: {len(regs)} instantiations, registers "
            f"{min(regs)}-{max(regs)}, spilling instantiations {len(spills)}")


def _hold(torch, checks, name, run, case, variant, q_dtype, idle, label,
          worst):
    """The kernel against its plain version on one case: within
    ``checks.kernel_tol``, and exactly 0 on the ``idle`` rows."""
    got = run(case, variant)
    ref = run(case, variant, plain=True)
    torch.cuda.synchronize()
    err = checks.rel_err(got, ref)
    tol = checks.kernel_tol(variant, q_dtype)
    idle_max = max([float(got[i].abs().max()) for i in idle], default=0.0)
    qn = str(q_dtype).split(".")[-1]
    log(f"[check] {name} {label} q {qn} {variant}: rel err {err:.3e} "
        f"(tol {tol:g}), idle rows max {idle_max}")
    if not err <= tol or idle_max != 0.0:
        raise AssertionError(f"{name} disagrees with its plain version")
    key = f"{name} {label.split()[-1]} q {qn} {variant}"
    worst[key] = max(worst.get(key, 0.0), err)


def phase_kernel_checks(torch, checks):
    shapes = [
        dict(D=16, H=4, Hkv=2, B=4, max_blocks=24, lengths=[37, 0, 200, 16],
             pf_lengths=[40, 0, 0, 129], n_valid=[70, 0, 33, 64], chunk=70),
        dict(D=16, H=4, Hkv=2, B=4, max_blocks=24, lengths=[37, 0, 200, 16],
             pf_lengths=[40, 0, 0, 129], n_valid=[70, 0, 33, 64], chunk=70,
             window=21),
        dict(D=64, H=H, Hkv=HKV, B=B, max_blocks=MAX_LEN // PS,
             lengths=[1024, 0, 517, 1, 800, 96, 1023, 333],
             pf_lengths=[768, 0, 0, 1000, 17, 512, 64, 250],
             n_valid=[256, 0, 100, 256, 17, 256, 1, 200], chunk=CHUNK),
    ]
    worst = {}
    rng = np.random.default_rng(0)
    for sh in shapes:
        for q_dtype in (torch.float32, torch.bfloat16):
            common = dict(B=sh["B"], H=sh["H"], Hkv=sh["Hkv"], D=sh["D"],
                          page_size=PS, max_blocks=sh["max_blocks"],
                          window=sh.get("window"), q_dtype=q_dtype,
                          device="cuda")
            for kv in ("bf16", "int8"):
                for dyadic in (True, False):
                    dec = checks.paged_case(rng, lengths=sh["lengths"],
                                            kv=kv, dyadic=dyadic, **common)
                    pre = checks.paged_case(rng, lengths=sh["pf_lengths"],
                                            n_valid=sh["n_valid"],
                                            chunk=sh["chunk"], kv=kv,
                                            dyadic=dyadic, **common)
                    kind = "dyadic" if dyadic else "random"
                    label = (f"D={sh['D']} {kv} window={sh.get('window')} "
                             f"{kind}")
                    for variant in ("exact", "expmul"):
                        for name, run, case in (
                                ("paged_decode", checks.run_decode, dec),
                                ("paged_prefill", checks.run_prefill, pre)):
                            _hold(torch, checks, name, run, case, variant,
                                  q_dtype, [1], label, worst)
    # contiguous caches: decode over S slots, then prefill on a fresh cache
    # and on rolling buffers (one wrapped, one shorter than its span, one
    # full, chunks longer than the span, a window narrower than the span,
    # and n_valid = 0); a fresh cache with a window skips whole tiles
    contiguous = [
        dict(D=16, H=4, Hkv=2, B=4, S=400, lengths=[37, 0, 400, 300],
             prefill=[
                 dict(S=600, lengths=[530, 0, 17, 600],
                      n_valid=[70, 0, 33, 64], chunk=70),
                 dict(S=600, lengths=[530, 0, 17, 200],
                      n_valid=[70, 0, 33, 64], chunk=70, window=21),
                 dict(S=64, lengths=[200, 0, 30, 64], n_valid=[70, 0, 7, 70],
                      chunk=70, window=64, rolling=True),
                 dict(S=64, lengths=[200, 0, 30, 64], n_valid=[70, 0, 7, 70],
                      chunk=70, window=21, rolling=True)]),
        dict(D=64, H=H, Hkv=HKV, B=B, S=MAX_LEN,
             lengths=[1024, 0, 517, 1, 800, 96, MAX_LEN, 333],
             prefill=[
                 dict(S=MAX_LEN, lengths=[768, 0, 0, 1000, 17, 512, 64, 1792],
                      n_valid=[256, 0, 100, 256, 17, 256, 1, 200],
                      chunk=CHUNK),
                 dict(S=256, lengths=[1000, 0, 100, 256, 255, 3, 700, 512],
                      n_valid=[300, 0, 256, 300, 1, 100, 300, 0], chunk=300,
                      window=256, rolling=True),
                 dict(S=256, lengths=[1000, 0, 100, 256, 255, 3, 700, 512],
                      n_valid=[300, 0, 256, 300, 1, 100, 300, 0], chunk=300,
                      window=100, rolling=True)]),
    ]
    for sh in contiguous:
        for q_dtype in (torch.float32, torch.bfloat16):
            common = dict(B=sh["B"], H=sh["H"], Hkv=sh["Hkv"], D=sh["D"],
                          q_dtype=q_dtype, device="cuda")
            for kv in ("bf16", "int8"):
                for dyadic in (True, False):
                    kind = "dyadic" if dyadic else "random"
                    dec = checks.contiguous_case(
                        rng, S=sh["S"], lengths=sh["lengths"], kv=kv,
                        dyadic=dyadic, **common)
                    cases = [("decode", checks.run_contiguous_decode, dec,
                              f"D={sh['D']} S={sh['S']} {kv} {kind}",
                              [i for i, n in enumerate(sh["lengths"])
                               if n == 0])]
                    for pf in sh["prefill"]:
                        cases.append((
                            "prefill", checks.run_contiguous_prefill,
                            checks.contiguous_case(
                                rng, dyadic=dyadic, kv=kv, **pf, **common),
                            f"D={sh['D']} S={pf['S']} rolling="
                            f"{pf.get('rolling', False)} window="
                            f"{pf.get('window')} {kv} {kind}",
                            [i for i, (n, m) in enumerate(
                                zip(pf["lengths"], pf["n_valid"]))
                             if n == 0 and m == 0]))
                    for variant in ("exact", "expmul"):
                        for name, run, case, label, idle in cases:
                            _hold(torch, checks, name, run, case, variant,
                                  q_dtype, idle, label, worst)
    # the redesign's edges: decode over 0-8 tiles of one cluster for GQA
    # groups 1, 7 and 32, and over up to 16 rounds of a cluster at S =
    # 32768 (Qwen2-0.5B's context); prefill chunks not a multiple of the
    # 32-row query block, float32 q over fp32 caches and int8 codes
    edges = [1, 255, 256, 257, MAX_LEN, 0]
    long_ctx = 32768
    decode_edges = [(group, kv, MAX_LEN, edges)
                    for group in (1, 7) for kv in ("f32", "bf16", "int8")]
    decode_edges += [(32, kv, MAX_LEN, edges) for kv in ("f32", "int8")]
    decode_edges += [(7, kv, long_ctx, [long_ctx, 2305, 20001, 0])
                     for kv in ("f32", "int8")]
    for group, kv, S, lengths in decode_edges:
        for q_dtype in (torch.float32, torch.bfloat16):
            dec = checks.contiguous_case(
                rng, B=len(lengths), H=HKV * group, Hkv=HKV, D=D, S=S,
                lengths=lengths, kv=kv, q_dtype=q_dtype, dyadic=False,
                device="cuda")
            for variant in ("exact", "expmul"):
                _hold(torch, checks, "decode", checks.run_contiguous_decode,
                      dec, variant, q_dtype, [len(lengths) - 1],
                      f"D={D} S={S} group={group} lengths {lengths} {kv} "
                      f"random", worst)
            del dec
    for C in (1, 15, 100, CHUNK):
        nv = [C, 0, max(1, C // 3), C]
        for kv in ("f32", "int8"):
            for q_dtype in (torch.float32, torch.bfloat16):
                pre = checks.contiguous_case(
                    rng, B=4, H=H, Hkv=HKV, D=D, S=MAX_LEN,
                    lengths=[700, 0, 1500, 64], n_valid=nv, chunk=C, kv=kv,
                    q_dtype=q_dtype, dyadic=False, device="cuda")
                for variant in ("exact", "expmul"):
                    _hold(torch, checks, "prefill",
                          checks.run_contiguous_prefill, pre, variant,
                          q_dtype, [1], f"D={D} S={MAX_LEN} C={C} "
                          f"n_valid={nv} {kv} random", worst)
    _paged_edges(torch, checks, rng, worst)
    _poisoned_pages(torch, checks, worst)
    # the training path's full-sequence forward
    flash = [dict(Sq=1024, Sk=1024, causal=True, window=None),
             dict(Sq=1024, Sk=1024, causal=True, window=256),
             dict(Sq=1000, Sk=1000, causal=True, window=None),
             dict(Sq=1000, Sk=1000, causal=True, window=256),
             dict(Sq=200, Sk=1000, causal=False, window=None)]
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            for sh in flash:
                for dyadic in (True, False):
                    case = checks.flash_case(
                        rng, B=2, H=H, Hkv=HKV, D=hd, dtype=dtype,
                        dyadic=dyadic, device="cuda", **sh)
                    for block_k in (128, 512):
                        case["block_k"] = block_k
                        label = (f"D={hd} Sq={sh['Sq']} Sk={sh['Sk']} "
                                 f"causal={sh['causal']} "
                                 f"window={sh['window']} bk={block_k} "
                                 f"{'dyadic' if dyadic else 'random'}")
                        for variant in ("exact", "expmul"):
                            _hold(torch, checks, "flash", checks.run_flash,
                                  case, variant, dtype, [], label, worst)
    # head dim 32, the fidelity study's: its shape (8 x 64 tokens, 4 / 2
    # heads, one 64-wide tile) and a ragged causal 1000 over 512-wide tiles
    for dtype in (torch.float32, torch.bfloat16):
        for b, hq, s, bk in ((8, 4, 64, 64), (2, H, 1000, 512)):
            for dyadic in (True, False):
                case = checks.flash_case(
                    rng, B=b, H=hq, Hkv=HKV, D=32, Sq=s, Sk=s, dtype=dtype,
                    dyadic=dyadic, causal=True, block_k=bk, device="cuda")
                label = (f"D=32 B={b} Sq={s} Sk={s} causal=True bk={bk} "
                         f"{'dyadic' if dyadic else 'random'}")
                for variant in ("exact", "expmul"):
                    _hold(torch, checks, "flash", checks.run_flash, case,
                          variant, dtype, [], label, worst)
    # the register-tiled layout's edges: Sq = Sk off the 32-row query block
    # and the 64-row sub-tile, a window ending inside a sub-tile, keys past
    # kv_len, GQA groups 1 and 7, every head dim
    for S in FLASH_EDGE_SEQS:
        for hd in (16, 32, 64, 128):
            for group in (1, 7):
                for dtype in (torch.float32, torch.bfloat16):
                    for dyadic in (True, False):
                        kind = "dyadic" if dyadic else "random"
                        for label, case in checks.flash_edge_cases(
                                rng, S=S, D=hd, group=group, dtype=dtype,
                                dyadic=dyadic, device="cuda"):
                            for variant in ("exact", "expmul"):
                                _hold(torch, checks, "flash", checks.run_flash,
                                      case, variant, dtype, [],
                                      f"D={hd} S={S} group={group} {label} "
                                      f"{kind}", worst)
    log(f"[check] worst rel err: {json.dumps(worst)}")


def _largest_groups(torch, checks, build, decode, rng, hd):
    """The largest GQA group each decode kernel takes at head dim ``hd``
    by KV dtype (its shared memory, from its own C query, within the
    card's limit; gated monotone in the group), and a float32 launch one
    group past it raising ``ValueError`` before any launch (past 32, the
    kernels' group bound refuses it)."""
    limit = decode.card_smem_limit(torch.device("cuda"))
    largest = {}
    for kv, dt in checks.KV_KINDS.items():
        for name, smem in (
                ("decode", lambda g: decode.contiguous_decode_smem(
                    g, hd, decode.BLOCK_K, dt)),
                ("paged_decode", lambda g: decode.paged_decode_smem(
                    g, hd, PS, MAX_LEN // PS, dt))):
            fits = [g for g in range(1, 33) if 0 < smem(g) <= limit]
            largest[f"{name} {kv}"] = max(fits)
            if fits != list(range(1, max(fits) + 1)):
                raise AssertionError(f"{name} {kv}: shared memory not "
                                     f"monotone in the group")
    log(f"[check] the largest GQA group a CTA takes at head dim {hd} "
        f"(limit {limit} B): {json.dumps(largest)}")
    for name, run in (("paged_decode", checks.run_decode),
                      ("decode", checks.run_contiguous_decode)):
        group = largest[f"{name} f32"] + 1
        kw = dict(B=2, H=group, Hkv=1, D=hd, lengths=[40, 7], kv="f32")
        case = (checks.paged_case(rng, page_size=PS, max_blocks=4, **kw)
                if name == "paged_decode" else
                checks.contiguous_case(rng, S=2 * decode.BLOCK_K, **kw))
        _refused(build, name, run, case,
                 f"group {group} float32 at head dim {hd}")
    return largest


def _refused(build, name, run, case, what):
    """``run`` must raise ``ValueError`` on ``case`` before any launch."""
    before = dict(build.COUNTS)
    try:
        run(case, "expmul")
    except ValueError as e:
        log(f"[check] {name} {what} refused before its launch: {e}")
    else:
        raise AssertionError(f"{name}: {what} was not refused")
    if dict(build.COUNTS) != before:
        raise AssertionError(f"{name}: a refused call launched")


def phase_head_dim_checks(torch, checks, build, decode):
    """The four serving kernels at head dims 32 (gemma-7b's smoke config),
    256 (its full width) and 128 (arctic-480b's) against their plain
    versions (``checks.head_dim_cases``: B 4, lengths across the 256-wide
    decode tiles and the 512-wide prefill tiles, a length 0, a chunk with
    n_valid 0) over float32, bfloat16, int8 and fp8 KV, exact and ExpMul,
    at ``checks.kernel_tol``: at 32 and 256, 16 / 16 heads, float32 and
    bfloat16 q, and GQA group 4 at 256; at 128, GQA groups 1 (8 / 8
    heads), 7 (56 / 8, arctic's, bfloat16 q) and 32 (32 / 1), where a
    paged decode whose shared memory is over the card's limit must be
    refused before its launch; then each serving kernel on a poisoned
    page at 128 (``_poisoned_pages``), and the largest group each decode
    kernel takes at 256 and at 128 (``_largest_groups``). Returns the
    largest groups by head dim."""
    rng = np.random.default_rng(12)
    worst, n = {}, 0
    cases = [(hd, kv, q_dtype, 1) for hd in (32, GEMMA_D)
             for kv in checks.KV_KINDS
             for q_dtype in (torch.float32, torch.bfloat16)]
    cases += [(GEMMA_D, kv, torch.bfloat16, 4) for kv in ("f32", "int8")]
    for hd, kv, q_dtype, group in cases:
        for name, run, case, idle, label in checks.head_dim_cases(
                rng, hd, kv=kv, q_dtype=q_dtype, group=group):
            for variant in ("exact", "expmul"):
                _hold(torch, checks, name, run, case, variant, q_dtype, idle,
                      label, worst)
                n += 1
    log(f"[check] head dims 32 and 256: {n} cases, worst rel err "
        f"{json.dumps(worst)}")
    largest = {GEMMA_D: _largest_groups(torch, checks, build, decode, rng,
                                        GEMMA_D)}
    # arctic-480b's head dim: groups 1, 7 (its own) and 32
    worst, n = {}, 0
    limit = decode.card_smem_limit(torch.device("cuda"))
    for group, q_dtype in ((1, torch.float32), (ARCTIC_GROUP, torch.bfloat16),
                           (32, torch.float32)):
        heads = ARCTIC_HKV * group if group < 32 else 32
        for kv, dt in checks.KV_KINDS.items():
            for name, run, case, idle, label in checks.head_dim_cases(
                    rng, ARCTIC_D, kv=kv, q_dtype=q_dtype, group=group,
                    H=heads):
                if (name == "paged_decode" and decode.paged_decode_smem(
                        group, ARCTIC_D, 16, case["block_tables"].shape[1],
                        dt) > limit):
                    _refused(build, name, run, case, label)
                    continue
                for variant in ("exact", "expmul"):
                    _hold(torch, checks, name, run, case, variant, q_dtype,
                          idle, label, worst)
                    n += 1
    log(f"[check] head dim {ARCTIC_D}: {n} cases, worst rel err "
        f"{json.dumps(worst)}")
    _poisoned_pages(torch, checks, worst, D=ARCTIC_D)
    largest[ARCTIC_D] = _largest_groups(torch, checks, build, decode, rng,
                                        ARCTIC_D)
    return largest


def phase_kimi_checks(torch, checks, build, decode):
    """The four serving kernels at kimi-k2-1t-a32b's head dim 112 (28
    feature groups: the prefills' value side padded to 128, the contiguous
    decode's K rows in two depth steps of 56) against their plain versions
    (``checks.head_dim_cases``) over float32, bfloat16, int8 and fp8 KV,
    exact and ExpMul, dyadic and random inputs, at ``checks.kernel_tol``:
    GQA group 8 (64 / 8 heads, kimi's) with float32 and bfloat16 q, group
    1 (8 / 8 heads, float32 q) and the largest group every decode kernel
    takes over every KV dtype (one KV head, bfloat16 q); each kernel on a
    poisoned page at 112; the largest group each decode kernel takes at
    112 by KV dtype, and a float32 launch one group past it refused before
    its launch. Returns the largest groups."""
    rng = np.random.default_rng(16)
    largest = _largest_groups(torch, checks, build, decode, rng, KIMI_D)
    top = min(largest.values())
    worst, n = {}, 0
    cases = [(KIMI_GROUP, KIMI_H, q_dtype) for q_dtype in (torch.float32,
                                                           torch.bfloat16)]
    cases += [(1, KIMI_HKV, torch.float32), (top, top, torch.bfloat16)]
    for group, heads, q_dtype in cases:
        for kv in checks.KV_KINDS:
            for dyadic in (True, False):
                for name, run, case, idle, label in checks.head_dim_cases(
                        rng, KIMI_D, kv=kv, q_dtype=q_dtype, group=group,
                        H=heads, dyadic=dyadic):
                    for variant in ("exact", "expmul"):
                        _hold(torch, checks, name, run, case, variant,
                              q_dtype, idle, label, worst)
                        n += 1
    log(f"[check] head dim {KIMI_D} (groups {KIMI_GROUP}, 1 and {top}): {n} "
        f"cases, worst rel err {json.dumps(worst)}")
    _poisoned_pages(torch, checks, worst, D=KIMI_D)
    return largest


def phase_rg_checks(torch, checks):
    """The four serving kernels at recurrentgemma-2b's local attention
    (``checks.windowed_cases``: 10 / 1 heads of 256, a 2,048-token window;
    histories of 1,024, 2,048, 2,049 and 3,584 tokens and one of 3,000
    whose window floor lies inside a page and a tile, a rolling buffer of
    span 2,048 that every long history has wrapped, an idle row) against
    their plain versions, over float32 and bfloat16 values, float32 and
    bfloat16 q, dyadic and random, exact and ExpMul, at
    ``checks.kernel_tol``."""
    rng = np.random.default_rng(13)
    worst, n = {}, 0
    for kv, q_dtype, dyadic in (("f32", torch.float32, True),
                                ("bf16", torch.bfloat16, False),
                                ("f32", torch.bfloat16, False),
                                ("bf16", torch.float32, True)):
        for name, run, case, idle, label in checks.windowed_cases(
                rng, kv=kv, q_dtype=q_dtype, dyadic=dyadic):
            for variant in ("exact", "expmul"):
                _hold(torch, checks, name, run, case, variant, q_dtype, idle,
                      label, worst)
                n += 1
            del case
    log(f"[check] {RG} windowed kernels (group {RG_H // RG_HKV}, head dim "
        f"{RG_D}, window {RG_WINDOW}): {n} cases, worst rel err "
        f"{json.dumps(worst)}")


def phase_mla_checks(torch, checks, build):
    """The contiguous decode and prefill at minicpm3-4b's head dims
    (``checks.MLA_DIMS``: K rows of 96, V rows of 64) against their plain
    versions (``checks.mla_cases``: 4 / 4 heads, lengths 0, 1, 300 and S
    for decode, a partial 70-token chunk and one with n_valid 0 for
    prefill, stale rows past every length) over float32 and bfloat16 KV,
    exact and ExpMul, float32 and bfloat16 q, dyadic and random, at
    ``checks.kernel_tol``; a NaN row in the first, a middle or the last 16
    rows of a 1,000-token sequence or past its length, the kernel's
    non-finite output rows exactly its plain version's (0 * NaN reaches
    the output); then int8 codes at (96, 64) and a pair not built
    (64, 32), each refused with a ``ValueError`` before any launch."""
    rng = np.random.default_rng(13)
    worst, n = {}, 0
    for kv in ("f32", "bf16"):
        for q_dtype in (torch.float32, torch.bfloat16):
            for dyadic in (True, False):
                for name, run, case, idle, label in checks.mla_cases(
                        rng, kv=kv, q_dtype=q_dtype, dyadic=dyadic):
                    for variant in ("exact", "expmul"):
                        _hold(torch, checks, name, run, case, variant,
                              q_dtype, idle, label, worst)
                        n += 1
    D, Dv = checks.MLA_DIMS
    for name in ("decode", "prefill"):
        errs = []
        for spot in checks.POISON_SPOTS:
            for kv in ("f32", "bf16"):
                case, run = checks.poisoned_case(
                    np.random.default_rng(11), name, spot, kv=kv, D=D, Dv=Dv,
                    H=4, Hkv=4, device="cuda")
                for variant in ("exact", "expmul"):
                    got = run(case, variant)
                    ref = run(case, variant, plain=True)
                    torch.cuda.synchronize()
                    err = checks.rows_rel_err(got, ref)
                    bad = int((~torch.isfinite(ref).all(-1)).sum())
                    if (not err <= checks.kernel_tol(variant, torch.float32)
                            or bad == 0
                            or not bool(torch.isfinite(ref[1:]).all())):
                        raise AssertionError(
                            f"{name} at {D}/{Dv} {spot} {kv} {variant}: the "
                            f"kernel's non-finite or finite rows disagree "
                            f"with its plain version (rows_rel_err {err})")
                    errs.append(err)
        n += len(errs)
        log(f"[check] {name} at {D}/{Dv}, a NaN row ({len(errs)} cases: "
            f"{', '.join(checks.POISON_SPOTS)} x f32/bf16 x exact/expmul): "
            f"non-finite rows equal to the plain version's, finite rows' "
            f"worst rel err {max(errs):.3e}")
    for what, kv, (dk, dv) in (("int8 codes at 96/64", "int8", (D, Dv)),
                               ("a pair not built, 64/32", "f32", (64, 32))):
        for name, run in (("decode", checks.run_contiguous_decode),
                          ("prefill", checks.run_contiguous_prefill)):
            pf = dict(n_valid=[5, 5], chunk=5) if name == "prefill" else {}
            case = checks.contiguous_case(rng, B=2, H=4, Hkv=4, D=dk, Dv=dv,
                                          S=64, lengths=[40, 7], kv=kv, **pf)
            before = dict(build.COUNTS)
            try:
                run(case, "expmul")
            except ValueError as e:
                log(f"[check] {name}: {what} refused before its launch: {e}")
            else:
                raise AssertionError(f"{name}: {what} was not refused")
            if dict(build.COUNTS) != before:
                raise AssertionError(f"{name}: a refused call launched")
    log(f"[check] MLA head dims {D}/{Dv}: {n} cases, worst rel err "
        f"{json.dumps(worst)}")


def _poisoned_pages(torch, checks, worst, D=D):
    """The ``kv_corrupt`` fault at the kernels: a poisoned page (NaN
    values, or int8 codes of -128 with NaN scales) in the first, a middle
    or the last page sequence 0 of three reads, or in its rows past the
    length (1,000 tokens, GQA 14 / 2, head dim ``D``, 64 by default, pages
    of 16; contiguous: 16 rows there, or the rows past the length). The
    kernel's non-finite output rows must be exactly its plain version's,
    its finite rows within ``kernel_tol`` (``checks.rows_rel_err``)."""
    for name in checks.SERVING_KERNELS:
        errs = []
        for spot in checks.POISON_SPOTS:
            for kv in ("f32", "int8"):
                case, run = checks.poisoned_case(
                    np.random.default_rng(11), name, spot, kv=kv, D=D,
                    device="cuda")
                for variant in ("exact", "expmul"):
                    got = run(case, variant)
                    ref = run(case, variant, plain=True)
                    torch.cuda.synchronize()
                    err = checks.rows_rel_err(got, ref)
                    bad = int((~torch.isfinite(ref).all(-1)).sum())
                    if (not err <= checks.kernel_tol(variant, torch.float32)
                            or bad == 0
                            or not bool(torch.isfinite(ref[1:]).all())):
                        raise AssertionError(
                            f"{name} {spot} {kv} {variant}: the kernel's "
                            f"non-finite rows or finite rows disagree with "
                            f"its plain version (rows_rel_err {err})")
                    errs.append(err)
                    key = f"{name} D={D} poisoned {kv} {variant}"
                    worst[key] = max(worst.get(key, 0.0), err)
        log(f"[check] {name} D={D} poisoned pages ({len(errs)} cases: "
            f"{', '.join(checks.POISON_SPOTS)} x f32/int8 x exact/expmul): "
            f"non-finite rows equal to the plain version's, finite rows' "
            f"worst rel err {max(errs):.3e}")


def _paged_edges(torch, checks, rng, worst):
    """The paged redesign's edges: decode over lengths 0, 1, ps - 1, ps,
    ps + 1 and the table's full width (2,048 tokens), and a row whose table
    holds a sentinel inside its length (clamped to the last pool block),
    for GQA groups 1, 7 and 32 at pages of 16 and 32 (one round of a
    cluster to 2,048 / (8 x 128) = 2 rounds, idle ranks), over float32
    values and int8 codes; a 32,768-token context (2,048 pages of 16: 32
    rounds) for group 7 over both; prefill chunks of C in {1, 15, 100,
    256} rows over 0, 1 page and 1,000 tokens of history, float32 and
    bfloat16 q, one row idle."""
    for ps in (PS, 2 * PS):
        mb = MAX_LEN // ps
        lengths = [0, 1, ps - 1, ps, ps + 1, mb * ps, 5 * ps + 3]
        for group in (1, 7, 32):
            for kv in ("f32", "int8"):
                for q_dtype in (torch.float32, torch.bfloat16):
                    dec = checks.paged_case(
                        rng, B=len(lengths), H=HKV * group, Hkv=HKV, D=D,
                        page_size=ps, max_blocks=mb, lengths=lengths, kv=kv,
                        q_dtype=q_dtype, dyadic=False, device="cuda")
                    checks.sentinel_within(dec, len(lengths) - 1, 2)
                    for variant in ("exact", "expmul"):
                        _hold(torch, checks, "paged_decode", checks.run_decode,
                              dec, variant, q_dtype, [0],
                              f"D={D} ps={ps} group={group} lengths {lengths} "
                              f"(a sentinel in the last) {kv} random", worst)
                    del dec
    long_ctx = 32768
    lengths = [long_ctx, 2305, 20001, 0]
    for kv in ("f32", "int8"):
        dec = checks.paged_case(
            rng, B=len(lengths), H=HKV * 7, Hkv=HKV, D=D, page_size=PS,
            max_blocks=long_ctx // PS, lengths=lengths, kv=kv,
            q_dtype=torch.bfloat16, dyadic=False, device="cuda")
        for variant in ("exact", "expmul"):
            _hold(torch, checks, "paged_decode", checks.run_decode, dec,
                  variant, torch.bfloat16, [3], f"D={D} ps={PS} group=7 "
                  f"lengths {lengths} {kv} random", worst)
        del dec
    for C in (1, 15, 100, CHUNK):
        nv = [C, C, max(1, C // 3), 0]
        for kv in ("f32", "int8"):
            for q_dtype in (torch.float32, torch.bfloat16):
                pre = checks.paged_case(
                    rng, B=4, H=H, Hkv=HKV, D=D, page_size=PS,
                    max_blocks=MAX_LEN // PS, lengths=[0, PS, 1000, 0],
                    n_valid=nv, chunk=C, kv=kv, q_dtype=q_dtype,
                    dyadic=False, device="cuda")
                for variant in ("exact", "expmul"):
                    _hold(torch, checks, "paged_prefill", checks.run_prefill,
                          pre, variant, q_dtype, [3], f"D={D} C={C} history "
                          f"[0, {PS}, 1000, 0] n_valid={nv} {kv} random",
                          worst)


def _bits_repr(torch, t):
    w = torch.int32 if t.dtype == torch.float32 else torch.int16
    mask = 0xFFFFFFFF if t.dtype == torch.float32 else 0xFFFF
    return [f"{float(a):g}/0x{int(b) & mask:x}" for a, b in
            zip(t.float().flatten().tolist(), t.view(w).flatten().tolist())]


def phase_expmul_checks(torch, checks, build, ops):
    """The ExpMul kernel bit for bit against its plain version and the
    frexp/ldexp oracle, on the card, over the reference's sweep and the
    merged [l, o] rows of the training shapes, in both dtypes, with the
    contract's edge values (``checks.expmul_case``); the merged update
    through the kernel against the bit path (two launches, logged and
    gated here; no entry point calls it); then NaN and inf x, outside the
    contract: kernel bits equal to the plain version's on the card and on
    the host, a NaN x leaving v unchanged (L_hat 0, as the reference)."""
    from repro_torch.kernels.expmul.expmul import expmul_fwd_plain
    from repro_torch.numerics.log2exp import expmul as expmul_bits

    rng = np.random.default_rng(10)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in EXPMUL_SHAPES:
            x, v = checks.expmul_case(rng, *shape, dtype=dtype)
            views = [("", v)]
            if shape == (257, 130):      # a misaligned, strided view
                views.append((" view[:, 1:]", v[:, 1:]))
            for label, vv in views:
                got, plain, oracle = checks.run_expmul(x, vv)
                torch.cuda.synchronize()
                ok = (checks.same_bits(got, plain)
                      and checks.same_bits(got, oracle))
                log(f"[expmul] {shape}{label} "
                    f"{str(dtype).split('.')[-1]}: kernel == plain == "
                    f"oracle bit for bit: {ok}")
                if not ok:
                    raise AssertionError("the ExpMul kernel disagrees")
    rows, d1 = EXPMUL_ROWS, D + 1
    o_star, v_star = (torch.randn(rows, d1, device="cuda") for _ in range(2))
    m_prev = torch.rand(rows, device="cuda") * 4 - 3
    m_cur = torch.maximum(m_prev, torch.rand(rows, device="cuda") * 4 - 3)
    s = m_cur - torch.rand(rows, device="cuda") * 18
    before = build.COUNTS["expmul"]
    got = ops.merged_output_update(o_star, v_star, m_prev, m_cur, s)
    per_update = build.COUNTS["expmul"] - before
    want = (expmul_bits((m_prev - m_cur)[:, None], o_star)
            + expmul_bits((s - m_cur)[:, None], v_star))
    torch.cuda.synchronize()
    ok = checks.same_bits(got, want)
    log(f"[expmul] merged [l, o] update ({rows}, {d1}): {per_update} "
        f"kernel launches, equal to the bit path bit for bit: {ok}")
    if not ok or per_update != 2:
        raise AssertionError("the merged update through the kernel")
    nan, inf = float("nan"), float("inf")
    x = torch.tensor([nan, inf, -inf, 0.0], device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        v = torch.tensor([[nan, inf, -inf, 1.0, -1.0]] * 4,
                         device="cuda").to(dtype)
        got, plain, _ = checks.run_expmul(x, v)
        host = expmul_fwd_plain(x.cpu(), v.cpu())
        for i, xi in enumerate(x.tolist()):
            ok = (checks.same_bits(got[i], plain[i])
                  and checks.same_bits(got[i].cpu(), host[i])
                  and (xi == xi or checks.same_bits(got[i], v[i])))
            log(f"[expmul] out of contract, {str(dtype).split('.')[-1]} "
                f"x={xi}: v {_bits_repr(torch, v[i])} -> kernel "
                f"{_bits_repr(torch, got[i])}; kernel == plain on the card "
                f"== plain on the host{', v unchanged' if xi != xi else ''}: "
                f"{ok}")
            if not ok:
                raise AssertionError("ExpMul out of contract: the kernel "
                                     "disagrees with its plain version")


def _ticks(torch, api, params, cfg, layout, bt, toks, chunks, tok1,
           keep_state=False):
    """Logits of prefill ticks over ``chunks`` (then one decode tick when
    ``tok1`` is given) on a fresh state of ``layout``, with the rows each
    tick's logits are defined for (and the state, with ``keep_state``).
    The contiguous caches hold as many tokens as a row of ``bt``."""
    if layout == "paged":
        state = api.init_paged_state(cfg, B, bt.numel(), PS, device="cuda")
    else:
        state = api.init_decode_state(cfg, B, bt.shape[1] * PS,
                                      device="cuda")
    lens = torch.zeros(B, dtype=torch.int32, device="cuda")
    out = []
    for tk, nv in zip(toks, chunks):
        nv = torch.tensor(nv, dtype=torch.int32, device="cuda")
        if layout == "paged":
            lg, state = api.prefill_paged(params, state, tk, lens, nv, bt,
                                          cfg, page_size=PS)
        else:
            lg, state = api.prefill(params, state, tk, lens, nv, cfg)
        out.append((lg, nv > 0))
        lens = lens + nv
    if tok1 is not None:
        if layout == "paged":
            lg, state = api.decode_step_paged(params, state, tok1, lens, bt,
                                              cfg, page_size=PS)
        else:
            lg, state = api.decode_step(params, state, tok1, lens, cfg)
        out.append((lg, torch.ones(B, dtype=torch.bool, device="cuda")))
    torch.cuda.synchronize()
    return (out, state) if keep_state else out


def _hold_ticks(torch, api, params, base, runs, bt, toks, tag="",
                variants=("exact", "expmul"), gated=("exact",)):
    """Each run (layout, window, kv_dtype, chunks, decode token) through the
    kernels and through the plain versions, in each of ``variants``:
    logits within 1e-3 of their magnitude for the ``gated`` variants, the
    gap printed for the others."""
    for layout, window, kv_dtype, chs, t1 in runs:
        ticks = (["prefill", "prefill over history"][:len(chs)]
                 + (["decode"] if t1 is not None else []))
        for variant in variants:
            logits = {}
            for impl in ("kernel", "plain"):
                cfg = base.replace(attention_variant=variant,
                                   attention_impl=impl, window=window,
                                   kv_dtype=kv_dtype)
                t0 = time.perf_counter()
                logits[impl] = _ticks(torch, api, params, cfg, layout, bt,
                                      toks, chs, t1)
                log(f"[model] {tag}{layout} {kv_dtype} window={window} "
                    f"{variant} {impl}: {len(logits[impl])} ticks in "
                    f"{time.perf_counter() - t0:.2f} s")
            for i, ((a, rows), (b, _)) in enumerate(zip(logits["kernel"],
                                                        logits["plain"])):
                a, b = a[rows].double(), b[rows].double()
                if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                    raise AssertionError("non-finite logits")
                gap = float((a - b).abs().max() / b.abs().max())
                log(f"[model] {tag}{layout} {kv_dtype} window={window} "
                    f"{variant} {ticks[i]}: max|dlogits| / max|logits| = "
                    f"{gap:.3e} (max|logits| {float(b.abs().max()):.3f}; "
                    f"{'gated at 1e-3' if variant in gated else 'not gated'})")
                if variant in gated and not gap <= 1e-3:
                    raise AssertionError("kernel logits disagree with plain")


def _tick_inputs(torch, rng, vocab):
    """Shuffled block tables, two chunks of token ids and one decode token
    a row, with the chunks' n_valid (8 rows: idle, ragged and full)."""
    mb = MAX_LEN // PS
    bt = torch.from_numpy(rng.permutation(B * mb).astype(np.int32)
                          .reshape(B, mb)).cuda()
    chunks = [[256, 0, 100, 256, 17, 256, 1, 200],
              [256, 0, 40, 256, 256, 10, 0, 256]]
    toks = [torch.from_numpy(rng.integers(1, vocab, (B, CHUNK))
                             .astype(np.int32)).cuda() for _ in chunks]
    tok1 = torch.from_numpy(rng.integers(1, vocab, B)
                            .astype(np.int32)).cuda()
    return bt, chunks, toks, tok1


def phase_model_ticks(torch, cfg_mod, api):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = cfg_mod.get_config("qwen2-0.5b", dtype="float32",
                              param_dtype="float32", kv_dtype="int8")
    params = api.init_model(base, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    bt, chunks, toks, tok1 = _tick_inputs(torch, np.random.default_rng(1),
                                          base.vocab_size)
    # the windowed pair: a 256-slot rolling buffer that the second chunk
    # wraps (rows of 356-512 tokens)
    runs = [("paged", None, "int8", chunks, tok1),
            ("contiguous", None, "int8", chunks, tok1),
            ("contiguous", 256, "int8", [chunks[0], [256, 0, 256, 256, 256,
                                                     10, 0, 256]], None)]
    _hold_ticks(torch, api, params, base, runs, bt, toks)
    del params
    torch.cuda.empty_cache()


def phase_gemma_ticks(torch, cfg_mod, api):
    """gemma-7b at full width (head dim 256, GeGLU, scaled embeddings),
    depth cut to 4 layers for the plain runs' time, float32 (TF32 off):
    the ticks of phase 3 on a paged int8 pool and on contiguous fp32
    caches, kernels against plain versions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = cfg_mod.get_config(GEMMA, dtype="float32", param_dtype="float32",
                              num_layers=GEMMA_TICK_LAYERS)
    params = api.init_model(base, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    bt, chunks, toks, tok1 = _tick_inputs(torch, np.random.default_rng(1),
                                          base.vocab_size)
    runs = [("paged", None, "int8", chunks, tok1),
            ("contiguous", None, "fp32", chunks, tok1)]
    _hold_ticks(torch, api, params, base, runs, bt, toks, tag=f"{GEMMA} ")
    del params
    torch.cuda.empty_cache()


def phase_mla_ticks(torch, cfg_mod, api):
    """minicpm3-4b at full width, depth ``MLA_LAYERS`` (bf16, ExpMul,
    random weights from seed 0): phase 3's two prefill ticks and a decode
    tick on a paged int8-latent pool and on contiguous fp32 caches (bf16
    latents), kernels against plain versions, the logits gated within 1e-3
    of their magnitude (phase 3b's bound, here on ExpMul). Either layout
    runs the contiguous decode and prefill at 96/64."""
    base = cfg_mod.get_config(MLA, num_layers=MLA_LAYERS)  # bf16, ExpMul
    assert base.attention_variant == "expmul" and base.dtype == "bfloat16"
    log(f"[config] {MLA} ticks: {base.param_count()} parameters; reduced: "
        f"num_layers {cfg_mod.get_config(MLA).num_layers} -> {MLA_LAYERS}")
    params = api.init_model(base, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    bt, chunks, toks, tok1 = _tick_inputs(torch, np.random.default_rng(1),
                                          base.vocab_size)
    runs = [("paged", None, "int8", chunks, tok1),
            ("contiguous", None, "fp32", chunks, tok1)]
    _hold_ticks(torch, api, params, base, runs, bt, toks, tag=f"{MLA} ",
                variants=("expmul",), gated=("expmul",))
    del params
    torch.cuda.empty_cache()


def phase_moe_routing(torch):
    """The MoE router's top-k on the card against the CPU's, and against
    ``jax.lax.top_k``'s ids where the reference's are known: rows with
    ties, an all-NaN row (a request poisoned by a NaN page), +-inf; then
    arctic's shape, 2,048 tokens over 128 experts, and kimi's, 2,048 over
    384 at top-8, logits on a 0.25 grid (ties in most rows) with NaN and
    inf rows. The card's stable sort must give the CPU's ids exactly."""
    from repro_torch.layers import moe
    nan, inf = float("nan"), float("inf")
    rows = [[1.0, 1.0, 0.2, 1.0], [nan] * 4, [inf, 0.5, -inf, inf],
            [-inf, -inf, 0.3, -inf], [0.1, 0.7, 0.7, 0.7]]
    jax_ids = {0: [0, 1], 1: [0, 1]}        # jax.lax.top_k on the CPU
    logits = torch.tensor(rows)
    cpu = moe.top_k(logits, 2)[1]
    card = moe.top_k(logits.cuda(), 2)[1].cpu()
    for i, want in jax_ids.items():
        if cpu[i].tolist() != want:
            raise AssertionError(f"top-k of {rows[i]}: {cpu[i].tolist()}, "
                                 f"jax.lax.top_k gives {want}")
    rng = np.random.default_rng(14)
    wide = {}
    for E in (128, 384):
        x = torch.from_numpy(np.round(rng.standard_normal((2048, E)) * 4)
                             / 4).float()
        x[5] = nan
        x[6, 3] = inf
        x[7, :] = -inf
        wide[E] = x
    same = [torch.equal(cpu, card)]
    for x, ks in ((logits, (2, 8)), (wide[128], (2, 8)), (wide[384], (8,))):
        for k in ks:
            same.append(torch.equal(moe.top_k(x, k)[1],
                                    moe.top_k(x.cuda(), k)[1].cpu()))
    log(f"[moe] routing ids on the card equal the CPU's: {all(same)} "
        f"({len(same)} cases; rows {rows} -> {card.tolist()}; 2048 x 128 "
        f"logits on a 0.25 grid with NaN and inf rows, top-2 and top-8; "
        f"2048 x 384, top-8)")
    if not all(same):
        raise AssertionError("the card's routing differs from the CPU's")


class _RouteLog:
    """Every MoE layer call's router logits, in call order, while active
    (``layers/moe.py:router_logits`` wrapped; nothing else changes)."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        inner = self.orig = self.moe.router_logits

        def logged(params, x2):
            out = inner(params, x2)
            self.calls.append(out.detach().clone())
            return out
        self.moe.router_logits = logged
        return self

    def __exit__(self, *exc):
        self.moe.router_logits = self.orig


def _free(torch, label):
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[memory] before {label}: {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        f"reserved")


def _moe_ticks(torch, api, params, base):
    """An MoE config (``base``: bf16, ExpMul) on ``params``: phase 3's two
    prefill ticks and a decode tick on a paged int8 pool and on contiguous
    fp32 caches (bf16 rows), through the kernels and through the plain
    versions. Routing is discontinuous (an attention output within
    ``kernel_tol`` can flip a near-tie of the router), so the two runs'
    routes are compared first, layer by layer: each token's top-k ids and
    kept copies. A row diverges at its first token routed otherwise (or a
    copy kept otherwise); a token routed otherwise in a row that had not
    diverged must sit within 1e-3 of a tie (its smallest gap between
    adjacent logits of its top k + 1), else the check fails. The logits of
    each row that never diverged are gated within 1e-3 of their
    magnitude."""
    from repro_torch.layers import moe
    arch, m, layers = base.name, base.moe, base.num_layers
    bt, chunks, toks, tok1 = _tick_inputs(torch, np.random.default_rng(1),
                                          base.vocab_size)
    kinds = [("prefill", c) for c in chunks] + [("decode", None)]
    for layout, kv_dtype in (("paged", "int8"), ("contiguous", "fp32")):
        runs = {}
        for impl in ("kernel", "plain"):
            cfg = base.replace(attention_impl=impl, kv_dtype=kv_dtype)
            t0 = time.perf_counter()
            with _RouteLog(moe) as routes:
                logits = _ticks(torch, api, params, cfg, layout, bt, toks,
                                chunks, tok1)
            runs[impl] = (logits, routes.calls)
            log(f"[model] {arch} {layout} {kv_dtype} expmul {impl}: "
                f"{len(logits)} ticks in {time.perf_counter() - t0:.2f} s")
        (lk, rk), (lp, rp) = runs["kernel"], runs["plain"]
        if len(rk) != len(rp) or len(rk) != len(kinds) * layers:
            raise AssertionError(f"{len(rk)} / {len(rp)} MoE calls")
        diverged = torch.zeros(B, dtype=torch.bool)
        for tick, (kind, nv) in enumerate(kinds):
            for layer in range(layers):
                a = rk[tick * layers + layer]
                b = rp[tick * layers + layer]
                T = a.shape[0]
                C = moe.capacity(T, m)
                ids_a = moe.top_k(a, m.top_k)[1]
                ids_b = moe.top_k(b, m.top_k)[1]
                keep_a = moe.dispatch(ids_a, m.num_experts, C)[1]
                keep_b = moe.dispatch(ids_b, m.num_experts, C)[1]
                flip = (ids_a != ids_b).any(-1).cpu()
                kept = (keep_a != keep_b).view(T, m.top_k).any(-1).cpu()
                per = T // B                     # tokens a row this call
                row = torch.arange(T) // per
                pos = torch.arange(T) % per
                valid = (pos < torch.tensor(nv)[row] if nv is not None
                         else torch.ones(T, dtype=torch.bool))
                top = torch.sort(b.float().cpu(), dim=-1,
                                 descending=True)[0][:, :m.top_k + 1]
                gaps = (top[:, :-1] - top[:, 1:]).min(-1)[0]
                root = flip & valid & ~diverged[row]
                for t in root.nonzero().flatten().tolist():
                    log(f"[model] {arch} {layout} tick {tick} ({kind}) "
                        f"layer {layer}: row {int(row[t])} token "
                        f"{int(pos[t])} routed otherwise, router-logit gap "
                        f"{float(gaps[t]):.3e}")
                    if not float(gaps[t]) <= 1e-3:
                        raise AssertionError("a route flipped away from a "
                                             "near-tie")
                newly = (flip | kept) & valid
                diverged[row[newly].unique()] = True
                log(f"[model] {arch} {layout} tick {tick} ({kind}) layer "
                    f"{layer}: T {T}, capacity {C}, "
                    f"{int((flip & valid).sum())} valid tokens routed "
                    f"otherwise, {int((kept & valid).sum())} with a copy "
                    f"kept otherwise, {int(keep_b.sum())} of "
                    f"{keep_b.numel()} copies kept; rows diverged "
                    f"{diverged.nonzero().flatten().tolist()}")
            (x, rows), (y, _) = lk[tick], lp[tick]
            rows = rows.cpu() & ~diverged
            if not rows.any():
                log(f"[model] {arch} {layout} tick {tick}: every row "
                    f"diverged, no logits gated")
                continue
            x, y = x[rows.cuda()].double(), y[rows.cuda()].double()
            if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
                raise AssertionError("non-finite logits")
            gap = float((x - y).abs().max() / y.abs().max())
            log(f"[model] {arch} {layout} {kv_dtype} expmul tick {tick} "
                f"({kind}): max|dlogits| / max|logits| = {gap:.3e} over "
                f"{int(rows.sum())} rows routed alike (max|logits| "
                f"{float(y.abs().max()):.3f}; gated at 1e-3)")
            if not gap <= 1e-3:
                raise AssertionError("kernel logits disagree with plain")
        del runs, lk, lp, rk, rp
        torch.cuda.empty_cache()


def phase_moe(torch, cfg_mod, api, build, ServeEngine, arch, num_layers):
    """An MoE arch at full width, depth cut to ``num_layers`` (bf16,
    ExpMul, random weights from seed 2, drawn once): its ticks, kernels
    against plain versions with the routes compared first (``_moe_ticks``),
    then served as phase 4 serves qwen2-0.5b (``phase_gemma_serve``: paged
    int8 and contiguous fp32, graphs against eager, each run on its
    layout's two kernels alone, the paged graph ticks profiled). Returns
    the serving runs' launches, with the draw's seconds and the peak
    memory of the whole phase."""
    _free(torch, f"{arch} ticks and serve")
    torch.cuda.reset_peak_memory_stats()
    full = cfg_mod.get_config(arch)
    base = full.replace(num_layers=num_layers)
    assert base.attention_variant == "expmul" and base.dtype == "bfloat16"
    m = base.moe
    log(f"[config] {arch}: d_model {base.d_model}, {base.num_heads} / "
        f"{base.num_kv_heads} heads of {base.resolved_head_dim()}, "
        f"{m.num_experts} experts top-{m.top_k} (d_ff {m.d_ff})"
        f"{f' + dense residual {m.dense_d_ff}' if m.dense_residual else ''}"
        f", vocab {base.vocab_size} untied; {base.param_count()} parameters "
        f"({base.param_count() * 2 / 2**30:.2f} GiB in bf16); reduced: "
        f"num_layers {full.num_layers} -> {num_layers}")
    t0 = time.perf_counter()
    params = api.init_model(
        base, torch.Generator(device="cuda").manual_seed(2), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"[config] {arch}: weights drawn in {init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    t0 = time.perf_counter()
    _moe_ticks(torch, api, params, base)
    log(f"[model] {arch}: ticks in {time.perf_counter() - t0:.1f} s, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    launches = phase_gemma_serve(torch, cfg_mod, api, build, ServeEngine,
                                 arch=arch, num_layers=num_layers,
                                 params=params)
    del params
    torch.cuda.empty_cache()
    launches["phase"] = dict(init_s=init_s, peak_gib=(
        torch.cuda.max_memory_allocated() / 2**30))
    log(f"[serve] {arch}: peak memory of the phase "
        f"{launches['phase']['peak_gib']:.2f} GiB")
    return launches


def phase_rg_ticks(torch, cfg_mod, api):
    """recurrentgemma-2b at full width, depth ``RG_LAYERS`` (bf16, ExpMul,
    random weights from seed 0): two prefill ticks of 1,152-token chunks
    (rows of 0 to 2,304 tokens, three past the 2,048-token window, so the
    contiguous rolling buffer wraps and the paged kernels skip pages below
    the floor) and a decode tick, on a paged pool and on contiguous caches
    at kv_dtype fp32 (bf16 rows), through the kernels and through the plain
    versions: logits within 1e-3 of their magnitude, and every RG-LRU
    layer's state after the ticks: bit for bit in the layers before the
    first attention layer, within 1e-2 of its magnitude after it (one
    bf16 step is 2^-8 of a value)."""
    _free(torch, f"{RG} ticks")
    base = cfg_mod.get_config(RG, num_layers=RG_LAYERS)  # bf16, ExpMul
    assert base.attention_variant == "expmul" and base.dtype == "bfloat16"
    kinds = base.pattern_for()
    log(f"[config] {RG}: d_model {base.d_model}, {base.num_heads} / "
        f"{base.num_kv_heads} heads of {base.resolved_head_dim()}, window "
        f"{base.window}, lru width {base.lru_width}, {kinds.count('rglru')} "
        f"RG-LRU and {kinds.count('attn')} attention layers, softcap "
        f"{base.logits_softcap}; {base.param_count()} parameters; reduced: "
        f"num_layers {cfg_mod.get_config(RG).num_layers} -> {RG_LAYERS}")
    params = api.init_model(
        base, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(1)
    C = RG_TICK_CHUNK
    mb = -(-(2 * C + 1) // PS) + 1
    bt = torch.from_numpy(rng.permutation(B * mb).astype(np.int32)
                          .reshape(B, mb)).cuda()
    chunks = [[C, 0, 300, C, 17, C, 1, 900], [C, 0, 40, C, C, 10, 0, C]]
    toks = [torch.from_numpy(rng.integers(1, base.vocab_size, (B, C))
                             .astype(np.int32)).cuda() for _ in chunks]
    tok1 = torch.from_numpy(rng.integers(1, base.vocab_size, B)
                            .astype(np.int32)).cuda()
    first_attn = kinds.index("attn")
    names = ["prefill", "prefill over history", "decode"]
    for layout in ("paged", "contiguous"):
        runs = {}
        for impl in ("kernel", "plain"):
            cfg = base.replace(attention_impl=impl)
            t0 = time.perf_counter()
            runs[impl] = _ticks(torch, api, params, cfg, layout, bt, toks,
                                chunks, tok1, keep_state=True)
            log(f"[model] {RG} {layout} fp32 expmul {impl}: 3 ticks in "
                f"{time.perf_counter() - t0:.2f} s")
        (lk, sk), (lp, sp) = runs["kernel"], runs["plain"]
        for i, ((a, rows), (b, _)) in enumerate(zip(lk, lp)):
            a, b = a[rows].double(), b[rows].double()
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError("non-finite logits")
            gap = float((a - b).abs().max() / b.abs().max())
            log(f"[model] {RG} {layout} expmul {names[i]}: max|dlogits| / "
                f"max|logits| = {gap:.3e} (max|logits| "
                f"{float(b.abs().max()):.3f}; gated at 1e-3)")
            if not gap <= 1e-3:
                raise AssertionError("kernel logits disagree with plain")
        gaps = {}
        for layer, kind in enumerate(kinds):
            if kind != "rglru":
                continue
            for name in ("h", "conv"):
                x = sk["caches"][layer][name].double()
                y = sp["caches"][layer][name].double()
                if layer < first_attn:
                    if not torch.equal(x, y):
                        raise AssertionError(f"layer {layer} {name}: state "
                                             f"before any attention differs")
                    continue
                gap = float((x - y).abs().max() / y.abs().max())
                gaps[f"{layer}/{name}"] = gap
                if not (torch.isfinite(x).all() and gap <= 1e-2):
                    raise AssertionError(f"layer {layer} {name}: recurrent "
                                         f"state gap {gap:.3e}")
        log(f"[model] {RG} {layout}: RG-LRU state after the ticks, layers "
            f"0-{first_attn - 1} bit for bit, the rest max|dstate| / "
            f"max|state| (gated at 1e-2): worst {max(gaps.values()):.3e}; "
            + json.dumps({k: float(f"{v:.3e}") for k, v in gaps.items()}))
        del runs, sk, sp
    del params
    torch.cuda.empty_cache()


def _serve_run(torch, build, ServeEngine, params, cfg, prompts, kw, pair,
               sink=True, tag=""):
    """Serve ``prompts`` (32 new tokens each) on a fresh engine with the
    launch counts set to 0 just before and read just after: the ``pair``
    of kernels of the layout must have launched, and nothing else (no
    other kernel, no plain version), once a tick in each attention layer
    (an empty ``pair``: a pattern with no attention layer, which launches
    no kernel).
    The engine's ticks replay CUDA graphs
    unless ``kw`` asks for eager ticks; the fresh engine captures its
    graphs at its first ticks, inside the measured run. ``sink=False``
    serves with the engine's dispatch counters off. Returns (counts,
    per-step launches, the streams, the run's numbers)."""
    mode = "eager" if kw.get("eager_ticks") else "graphs"
    label = (f"{tag}{kw['kv_layout']}/{kw['kv_dtype']} {mode}"
             + ("" if sink else " (no sink)"))
    warm = ServeEngine(params, cfg, **kw)              # cuBLAS, allocator
    for p in prompts[:2]:
        warm.submit(p[:300], 2)
    warm.run()
    del warm
    eng = ServeEngine(params, cfg, **kw)
    if not sink:
        eng.dispatch_sink = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, 32) for p in prompts]
    tick_ms = {"prefill": [], "decode": []}
    while True:           # eng.run(), with each tick timed by its kind
        before = eng.prefill_steps
        t = time.perf_counter()
        busy = eng.tick()
        torch.cuda.synchronize()
        if eng.ticks and busy:
            kind = "prefill" if eng.prefill_steps > before else "decode"
            tick_ms[kind].append((time.perf_counter() - t) * 1e3)
        if not (busy or eng.queue):
            break
    wall = time.perf_counter() - t0
    counts = dict(build.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    if not all(r.done and r.finish_reason == "length" and len(r.out) == 32
               for r in reqs):
        raise AssertionError(f"{label}: a request did not finish with "
                             f"'length'")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out):
        raise AssertionError(f"{label}: a sampled token is out of the "
                             f"vocabulary")
    if not all(counts.get(name, 0) > 0 for name in pair):
        raise AssertionError(f"{label}: the serving run missed a kernel: "
                             f"{counts}")
    if any(n for name, n in counts.items() if name not in pair):
        raise AssertionError(f"{label}: another kernel or a plain version "
                             f"ran while serving: {counts}")
    graphs = eng.graph_stats()
    n_attn = cfg.pattern_for().count("attn")
    if pair:
        dec, pre = pair
        if (counts[dec] != n_attn * eng.decode_steps
                or counts[pre] != n_attn * eng.prefill_steps):
            raise AssertionError(f"{label}: launches {counts} are not one a "
                                 f"tick in each of {n_attn} attention "
                                 f"layers")
    if mode == "graphs":
        # every tick replayed its kind's graph, whose captured launches are
        # the run's: replays x captured launches, kernel by kernel
        want = {}
        for kind in ("prefill", "decode"):
            st = graphs[kind]
            if st["replays"] != getattr(eng, f"{kind}_steps"):
                raise AssertionError(f"{label}: {st['replays']} {kind} "
                                     f"replays in {eng.ticks} ticks")
            for name, n in st["launches_per_replay"].items():
                want[name] = want.get(name, 0) + n * st["replays"]
        if want != counts:
            raise AssertionError(f"{label}: launches {counts} are not "
                                 f"replays x captured launches {want}")
    elif any(st["captured"] for st in graphs.values()):
        raise AssertionError(f"{label}: an eager engine captured a graph")
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in reqs]
    gen = eng.tokens_generated
    stats = dict(tokens_per_s=gen / wall, ttft_p50_ms=statistics.median(ttft),
                 prefill_p50_ms=statistics.median(tick_ms["prefill"]),
                 decode_p50_ms=statistics.median(tick_ms["decode"]),
                 peak_gib=peak / 2**30, graphs=graphs)
    log(f"[serve] {label}: {len(prompts)} requests, prompts "
        f"{min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens ({eng.prompt_tokens} in all), "
        f"32 new each: {eng.ticks} steps ({eng.prefill_steps} prefill, "
        f"{eng.decode_steps} decode), {gen} tokens generated in {wall:.3f} s "
        f"= {gen / wall:.1f} tokens/s; TTFT from submit p50 "
        f"{statistics.median(ttft):.1f} ms, max {max(ttft):.1f} ms; peak "
        f"memory {peak / 2**30:.2f} GiB; preemptions {eng.preemptions}")
    if sink and mode == "eager" and not tag:
        tps0, ttft0 = BEFORE_SERVE[label.split()[0]]
        log(f"[serve] {label}: at 35522df {tps0} tokens/s, TTFT p50 {ttft0} "
            f"ms (not gated)")
    log(f"[serve] {label}: launches {json.dumps(counts)}")
    log(f"[serve] {label}: tick wall time, ms: prefill p50 "
        f"{stats['prefill_p50_ms']:.2f} (sum "
        f"{sum(tick_ms['prefill']):.1f}), decode p50 "
        f"{stats['decode_p50_ms']:.2f} (sum "
        f"{sum(tick_ms['decode']):.1f})")
    if mode == "graphs":
        log(f"[serve] {label}: graphs " + json.dumps(graphs))
    per_step = ({dec: counts[dec] / eng.decode_steps,
                 pre: counts[pre] / eng.prefill_steps} if pair else {})
    return counts, per_step, [r.out for r in reqs], stats


def phase_serve(torch, cfg_mod, api, build, ServeEngine):
    """Each layout served with its ticks replaying CUDA graphs (the main
    path) and, as a witness, with eager ticks: the temp-0 streams must be
    equal; both profiled. The paged graph run is served once more, with
    the dispatch counters off, beside its first run (counters on)."""
    cfg = cfg_mod.get_config("qwen2-0.5b")          # bf16, ExpMul
    assert cfg.attention_variant == "expmul" and cfg.dtype == "bfloat16"
    params = api.init_model(cfg, torch.Generator(device="cuda").manual_seed(2),
                            device="cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(128, 1025, size=16)]
    kw = dict(kv_layout="paged", page_size=PS, kv_dtype="int8", slots=B,
              max_len=MAX_LEN, chunk_size=CHUNK, temperature=0.0,
              attention_impl="kernel", device="cuda")
    ckw = dict(kw, kv_layout="contiguous")
    del ckw["page_size"]
    layouts = (("paged/int8", kw, PAGED),
               ("contiguous/fp32", dict(ckw, kv_dtype="fp32"), CONTIGUOUS),
               ("contiguous/int8", ckw, CONTIGUOUS))
    launches, streams, sink_on = {}, {}, None
    for label, lkw, pair in layouts:
        runs, idle = {}, {}
        for mode in ("graphs", "eager"):
            mkw = dict(lkw, eager_ticks=mode == "eager")
            runs[mode] = _serve_run(torch, build, ServeEngine, params, cfg,
                                    prompts, mkw, pair)
            idle[mode] = phase_profile(torch, ServeEngine, params, cfg, mkw,
                                       prompts)
        (counts, per_step, out, g), (_, _, eager_out, e) = (runs["graphs"],
                                                            runs["eager"])
        same = sum(a == b for x, y in zip(out, eager_out)
                   for a, b in zip(x, y))
        log(f"[serve] {label}: graphs vs eager temp-0 streams, {same} of "
            f"{sum(map(len, out))} tokens equal")
        if out != eager_out:
            raise AssertionError(f"{label}: the graph engine's streams differ "
                                 f"from the eager engine's")
        streams[label] = out
        sink_on = g if label == "paged/int8" else sink_on
        gg = g["graphs"]
        log(f"[serve] {label}, graphs / eager: tokens/s "
            f"{g['tokens_per_s']:.1f} / {e['tokens_per_s']:.1f}; TTFT p50 "
            f"{g['ttft_p50_ms']:.1f} / {e['ttft_p50_ms']:.1f} ms; prefill "
            f"tick p50 {g['prefill_p50_ms']:.2f} / {e['prefill_p50_ms']:.2f} "
            f"ms; decode tick p50 {g['decode_p50_ms']:.2f} / "
            f"{e['decode_p50_ms']:.2f} ms; idle share prefill x1 "
            f"{idle['graphs'].get('prefill')} / {idle['eager'].get('prefill')}"
            f", decode x4 {idle['graphs'].get('decode')} / "
            f"{idle['eager'].get('decode')}; capture ms prefill "
            f"{gg['prefill']['capture_ms']:.1f} (warm-up "
            f"{gg['prefill']['warmup_ms']:.1f}), decode "
            f"{gg['decode']['capture_ms']:.1f} (warm-up "
            f"{gg['decode']['warmup_ms']:.1f}); graph pool "
            f"{gg['prefill']['pool_bytes'] + gg['decode']['pool_bytes']} "
            f"bytes; peak memory {g['peak_gib']:.2f} / {e['peak_gib']:.2f} "
            f"GiB")
        # the contiguous kernels' launches are those of the int8 run, which
        # the timings of phase 5 match; the fp32 run's are kept beside them
        for name in pair:
            key = "launches_fp32" if label == "contiguous/fp32" else "launches"
            launches.setdefault(name, {})[key] = counts[name]
            if key == "launches":
                launches[name]["launches_per_step"] = per_step[name]
    # the engine's dispatch counters cost host time on every replay: the
    # paged graph run without them, beside its first run with them (a
    # second run with them was cut for the script's time)
    *_, out, st = _serve_run(torch, build, ServeEngine, params, cfg,
                             prompts, kw, PAGED, sink=False)
    if out != streams["paged/int8"]:
        raise AssertionError("the dispatch sink changed the streams")
    sink_runs = [st, sink_on]
    log("[serve] paged/int8 graphs tick wall time p50 ms, sink off / on: "
        + "; ".join(f"{kind} " + " / ".join(
            f"{st[f'{kind}_p50_ms']:.2f}" for st in sink_runs)
            for kind in ("prefill", "decode")))
    same = sum(a == b for x, y in zip(streams["paged/int8"],
                                      streams["contiguous/int8"])
               for a, b in zip(x, y))
    first = sum(x[0] == y[0] for x, y in zip(streams["paged/int8"],
                                             streams["contiguous/int8"]))
    log(f"[serve] temp-0 agreement, paged int8 vs contiguous int8 (ExpMul "
        f"results depend on the tile width, so no gate): {same} of "
        f"{sum(map(len, streams['paged/int8']))} tokens at the same "
        f"position, first tokens {first} of {len(prompts)}")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_gemma_serve(torch, cfg_mod, api, build, ServeEngine, arch=GEMMA,
                      num_layers=None, params=None):
    """gemma-7b (or ``arch``) at full width and depth (``num_layers`` cuts
    the depth; bf16, ExpMul, random weights from seed 2) served as phase 4
    serves qwen2-0.5b: the same 16
    prompts' lengths, 32 new tokens each, 8 slots, ``max_len`` 2048, chunk
    256, temperature 0, on a paged int8 pool and on contiguous fp32 caches
    (bf16 rows, the compute dtype), each with CUDA-graph ticks and eager
    ticks: streams gated equal, each run on its layout's two kernels
    alone, in replays x captured launches under graphs. An MLA config's
    layers run the contiguous kernels on both layouts (its paged pool
    holds latents): each run must launch those two and neither paged
    kernel, and each layout's graph ticks are profiled (``phase_profile``:
    where an MLA tick's time goes beside the kernels). An MoE config's
    paged graph ticks are profiled too (where an MoE tick's time goes: its
    expert GEMMs read every expert's weights each tick). Returns the
    launches of each kernel under graphs, by layout for MLA. A hybrid
    config (RG-LRU blocks) is served on a paged pool at kv_dtype fp32 (int8
    is refused for a recurrent pattern), and its paged graph ticks are
    profiled too (where a hybrid tick's time goes: the recurrence loop,
    the GEMMs or attention). A config with a frontend (llava-next-34b)
    then times a frontend forward on the served weights
    (``llava_frontend_forward``), returned under "frontend_forward".
    ``params`` serves weights already drawn (the caller frees them)."""
    if params is None:
        _free(torch, f"{arch} serve")
    over = {} if num_layers is None else dict(num_layers=num_layers)
    cfg = cfg_mod.get_config(arch, **over)          # bf16, ExpMul
    assert cfg.attention_variant == "expmul" and cfg.dtype == "bfloat16"
    hybrid = set(cfg.block_pattern) != {"attn"}
    paged_kv = "fp32" if hybrid else "int8"
    if num_layers is not None:
        log(f"[config] {arch} served: {cfg.param_count()} parameters; "
            f"reduced: num_layers "
            f"{cfg_mod.get_config(arch).num_layers} -> {num_layers}")
    own = params is None
    if own:
        params = api.init_model(
            cfg, torch.Generator(device="cuda").manual_seed(2), device="cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(128, 1025, size=16)]
    kw = dict(kv_layout="paged", page_size=PS, kv_dtype=paged_kv, slots=B,
              max_len=MAX_LEN, chunk_size=CHUNK, temperature=0.0,
              attention_impl="kernel", device="cuda")
    ckw = dict(kw, kv_layout="contiguous", kv_dtype="fp32")
    del ckw["page_size"]
    launches = {}
    for label, lkw, pair in ((f"paged/{paged_kv}", kw,
                              CONTIGUOUS if cfg.mla else PAGED),
                             ("contiguous/fp32", ckw, CONTIGUOUS)):
        runs = {}
        for mode in ("graphs", "eager"):
            runs[mode] = _serve_run(torch, build, ServeEngine, params, cfg,
                                    prompts, dict(lkw, eager_ticks=mode ==
                                                  "eager"), pair,
                                    tag=f"{arch} ")
            torch.cuda.empty_cache()
        if cfg.mla or ((cfg.moe or hybrid) and label.startswith("paged")):
            phase_profile(torch, ServeEngine, params, cfg, lkw, prompts,
                          tag=f"{arch} ")
            torch.cuda.empty_cache()
        (counts, _, out, g), (_, _, eager_out, e) = (runs["graphs"],
                                                     runs["eager"])
        same = sum(a == b for x, y in zip(out, eager_out)
                   for a, b in zip(x, y))
        log(f"[serve] {arch} {label}: graphs vs eager temp-0 streams, "
            f"{same} of {sum(map(len, out))} tokens equal; tokens/s "
            f"{g['tokens_per_s']:.1f} / {e['tokens_per_s']:.1f}; TTFT p50 "
            f"{g['ttft_p50_ms']:.1f} / {e['ttft_p50_ms']:.1f} ms; tick p50 "
            f"prefill {g['prefill_p50_ms']:.2f} / {e['prefill_p50_ms']:.2f} "
            f"ms, decode {g['decode_p50_ms']:.2f} / {e['decode_p50_ms']:.2f} "
            f"ms; peak memory {g['peak_gib']:.2f} / {e['peak_gib']:.2f} GiB")
        if out != eager_out:
            raise AssertionError(f"{arch} {label}: the graph engine's "
                                 f"streams differ from the eager engine's")
        for name in pair:
            if cfg.mla:
                launches.setdefault(name, {})[label] = counts[name]
            else:
                launches[name] = counts[name]
    if cfg.frontend:
        launches["frontend_forward"] = llava_frontend_forward(
            torch, api, build, params, cfg)
    if own:
        del params
        torch.cuda.empty_cache()
    return launches


def phase_rg_windowed_serve(torch, cfg_mod, api, build, ServeEngine):
    """recurrentgemma-2b at full width and depth (bf16, ExpMul, seed-2
    weights) under windowed traffic: 8 requests of 2,304-3,840 prompt
    tokens (every one past the 2,048-token window, so every rolling buffer
    wraps and the paged kernels skip whole pages below the window floor),
    32 new tokens each, 8 slots, ``max_len`` 4096, chunk 256, graph ticks,
    on a paged fp32 pool and on contiguous fp32 caches (bf16 rows): every
    request finishes and each run launches its layout's two kernels alone,
    once a tick in each attention layer. The agreement of the two layouts'
    streams is printed, not gated (their kernels walk other tiles).
    Returns each run's numbers by layout."""
    _free(torch, f"{RG} windowed serve")
    cfg = cfg_mod.get_config(RG)
    params = api.init_model(cfg, torch.Generator(device="cuda").manual_seed(2),
                            device="cuda")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(2304, 3841, size=B)]
    assert min(map(len, prompts)) > cfg.window
    kw = dict(kv_layout="paged", page_size=PS, kv_dtype="fp32", slots=B,
              max_len=RG_MAX_LEN, chunk_size=CHUNK, temperature=0.0,
              attention_impl="kernel", device="cuda")
    ckw = dict(kw, kv_layout="contiguous")
    del ckw["page_size"]
    streams, stats = {}, {}
    for label, lkw, pair in (("paged/fp32", kw, PAGED),
                             ("contiguous/fp32", ckw, CONTIGUOUS)):
        counts, _, out, st = _serve_run(torch, build, ServeEngine, params,
                                        cfg, prompts, lkw, pair,
                                        tag=f"{RG} windowed ")
        streams[label], stats[label] = out, dict(st, launches=counts)
        torch.cuda.empty_cache()
    a, b = streams["paged/fp32"], streams["contiguous/fp32"]
    same = sum(x == y for p, q in zip(a, b) for x, y in zip(p, q))
    first = sum(p[0] == q[0] for p, q in zip(a, b))
    log(f"[serve] {RG} windowed: temp-0 agreement, paged vs contiguous (the "
        f"layouts' kernels walk other tiles, so no gate): {same} of "
        f"{sum(map(len, a))} tokens at the same position, first tokens "
        f"{first} of {len(prompts)}")
    del params
    torch.cuda.empty_cache()
    return stats


def _xlstm_lockstep(torch, ServeEngine, params, cfg, kw, prompts):
    """Serve ``prompts`` (4 new tokens each) on a graph engine and an eager
    engine in lockstep: each tick's logits and every recurrent state
    tensor after it equal bit for bit, the graph engine's state tensors at
    their addresses from before the capture (the replays write them in
    place), the two streams equal. Returns (ticks, replays by kind)."""
    engines = [ServeEngine(params, cfg, eager_ticks=eager, **kw)
               for eager in (False, True)]
    logits, reqs = ([], []), ([], [])
    for eng, out, rs in zip(engines, logits, reqs):
        chaos = eng._chaos_logits

        def hook(active, lg, chaos=chaos, out=out):
            out.append(lg.clone())
            return chaos(active, lg)

        eng._chaos_logits = hook
        rs.extend(eng.submit(p, 4, rid=i) for i, p in enumerate(prompts))
    addrs = [t.data_ptr() for t in engines[0]._recurrent]
    ticks = 0
    while any([e.tick() for e in engines]):
        torch.cuda.synchronize()
        ticks += 1
        g, e = engines
        if not torch.equal(logits[0][-1], logits[1][-1]):
            raise AssertionError(f"tick {ticks}: graph logits differ from "
                                 f"eager logits")
        for a, b in zip(g._recurrent, e._recurrent):
            if not torch.equal(a, b):
                raise AssertionError(f"tick {ticks}: graph state differs "
                                     f"from eager state")
    if [t.data_ptr() for t in engines[0]._recurrent] != addrs:
        raise AssertionError("a replay rebound the recurrent state")
    if ([r.out for r in reqs[0]] != [r.out for r in reqs[1]]
            or not all(r.finish_reason == "length" for r in reqs[0])):
        raise AssertionError("the lockstep engines' streams differ")
    st = engines[0].graph_stats()
    replays = {k: st[k]["replays"] for k in ("prefill", "decode")}
    if not (replays["prefill"] and replays["decode"]):
        raise AssertionError(f"the graph engine did not replay: {replays}")
    return ticks, replays


def phase_xlstm_ticks(torch, cfg_mod, api, ServeEngine):
    """xlstm-1.3b at full width, depth ``XLSTM_LAYERS`` (7 mLSTM, 1 sLSTM;
    bf16, random weights from seed 0; no attention layer, so no kernel):
    (a) two prefill ticks of ``XLSTM_CHUNK``-token chunks (rows idle,
    ragged and full) and a decode tick on a paged state and on contiguous
    caches: logits and every state leaf equal bit for bit (the same
    arithmetic: a recurrent layer ignores the layout); (b) 8 requests of
    20-70 prompt tokens, 4 new each, on a graph engine and an eager engine
    in lockstep on each layout: every tick's logits and recurrent state
    bit for bit, written in place; (c) ``api.forward`` (chunkwise mLSTM,
    two chunks of 144 at dh 768) against a loop of ``api.decode_step``
    from ``init_decode_state`` over ``XLSTM_FWD_SEQ`` tokens, 2 rows: in
    float32 at that depth (TF32 off), gated at 1e-3 of the logits'
    magnitude (``repro``'s own CPU test holds 3e-4 at its smoke config);
    in bf16 at depth ``XLSTM_BF16_LAYERS``, gated at 0.1: each layer's
    output is rounded to bf16 (2^-8 of a value) at places the two forms
    reach by other float32 sums, and the random-init model carries the
    flips through its depth (CPU proxies at depth 8: 0.015-0.021; at 48
    layers the two forms of ``repro`` itself differ by 0.48). Engine
    ticks are not compared with ``forward``: an admission zeroes the
    stabilizers ``m`` where a fresh state holds -1e30, as ``repro``'s
    does."""
    _free(torch, f"{XLSTM} ticks")
    base = cfg_mod.get_config(XLSTM, num_layers=XLSTM_LAYERS)   # bf16
    assert base.dtype == "bfloat16" and "attn" not in base.pattern_for()
    kinds = base.pattern_for()
    log(f"[config] {XLSTM}: d_model {base.d_model}, {base.num_heads} heads, "
        f"{kinds.count('mlstm')} mLSTM and {kinds.count('slstm')} sLSTM "
        f"layers, no attention layer; {base.param_count()} parameters; "
        f"reduced: num_layers {cfg_mod.get_config(XLSTM).num_layers} -> "
        f"{XLSTM_LAYERS}")
    params = api.init_model(
        base, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(12)
    C = XLSTM_CHUNK
    mb = -(-(2 * C + 1) // PS) + 1
    bt = torch.from_numpy(rng.permutation(B * mb).astype(np.int32)
                          .reshape(B, mb)).cuda()
    chunks = [[C, 0, 5, C, 17, C, 1, 20], [C, 0, 9, C, C, 3, 0, C]]
    toks = [torch.from_numpy(rng.integers(1, base.vocab_size, (B, C))
                             .astype(np.int32)).cuda() for _ in chunks]
    tok1 = torch.from_numpy(rng.integers(1, base.vocab_size, B)
                            .astype(np.int32)).cuda()
    runs = {}
    for layout in ("paged", "contiguous"):
        t0 = time.perf_counter()
        runs[layout] = _ticks(torch, api, params, base, layout, bt, toks,
                              chunks, tok1, keep_state=True)
        log(f"[model] {XLSTM} {layout}: 3 ticks in "
            f"{time.perf_counter() - t0:.2f} s")
    (lp, sp), (lc, sc) = runs["paged"], runs["contiguous"]
    for i, ((a, rows), (b, _)) in enumerate(zip(lp, lc)):
        if not torch.isfinite(a[rows]).all():
            raise AssertionError(f"{XLSTM} tick {i}: non-finite logits")
        if not torch.equal(a, b):
            raise AssertionError(f"{XLSTM} tick {i}: paged logits differ "
                                 f"from contiguous")
    n_leaves = 0
    for x, y in zip(sp["caches"], sc["caches"]):
        for name in x:
            n_leaves += 1
            if not torch.equal(x[name], y[name]):
                raise AssertionError(f"{XLSTM}: state {name} differs "
                                     f"between the layouts")
    log(f"[model] {XLSTM}: paged and contiguous ticks bit for bit (3 ticks' "
        f"logits, {n_leaves} state leaves)")
    del runs, sp, sc
    torch.cuda.empty_cache()
    prompts = [rng.integers(1, base.vocab_size, size=int(n)).tolist()
               for n in rng.integers(20, 71, size=B)]
    for layout in ("paged", "contiguous"):
        kw = dict(kv_layout=layout, kv_dtype="fp32", slots=B,
                  max_len=XLSTM_MAX_LEN, chunk_size=C, device="cuda")
        if layout == "paged":
            kw["page_size"] = PS
        t0 = time.perf_counter()
        ticks, replays = _xlstm_lockstep(torch, ServeEngine, params, base,
                                         kw, prompts)
        log(f"[model] {XLSTM} {layout}: graph and eager engines in lockstep, "
            f"{ticks} ticks ({replays['prefill']} prefill and "
            f"{replays['decode']} decode replays): logits and recurrent "
            f"state bit for bit, written in place "
            f"({time.perf_counter() - t0:.2f} s)")
        torch.cuda.empty_cache()
    del params
    _free(torch, f"{XLSTM} forward")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    toks = torch.from_numpy(rng.integers(1, base.vocab_size,
                                         (2, XLSTM_FWD_SEQ))
                            .astype(np.int32)).cuda()
    gaps = {}
    try:
        for dt, layers, gate in (("float32", base.num_layers, 1e-3),
                                 ("bfloat16", XLSTM_BF16_LAYERS, 0.1)):
            cfg = base.replace(dtype=dt, param_dtype=dt, num_layers=layers)
            params = api.init_model(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                device="cuda")
            t0 = time.perf_counter()
            with torch.no_grad():
                full = api.forward(params, {"tokens": toks}, cfg).float()
                state = api.init_decode_state(cfg, 2, XLSTM_FWD_SEQ,
                                              device="cuda")
                steps = []
                for t in range(XLSTM_FWD_SEQ):
                    lens = torch.full((2,), t, dtype=torch.int32,
                                      device="cuda")
                    lg, _ = api.decode_step(params, state, toks[:, t], lens,
                                            cfg)
                    steps.append(lg.float())
            loop = torch.stack(steps, 1)
            torch.cuda.synchronize()
            if not (torch.isfinite(full).all() and torch.isfinite(loop).all()):
                raise AssertionError(f"{XLSTM} {dt}: non-finite logits")
            gap = float((full - loop).abs().max() / loop.abs().max())
            agree = float((full.argmax(-1) == loop.argmax(-1)).float().mean())
            gaps[dt] = gap
            log(f"[model] {XLSTM} {dt}, {layers} layers: forward vs a "
                f"decode_step loop over {XLSTM_FWD_SEQ} tokens: max|dlogits| "
                f"/ max|logits| = {gap:.3e} (gated at {gate:g}), argmax "
                f"agreement {agree:.4f} ({time.perf_counter() - t0:.2f} s)")
            if not gap <= gate:
                raise AssertionError(f"{XLSTM} {dt}: forward and the decode "
                                     f"loop disagree")
            del params, state, full, loop, steps
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return gaps


def phase_xlstm_serve(torch, cfg_mod, api, build, ServeEngine):
    """xlstm-1.3b served at full width, depth ``XLSTM_LAYERS`` (bf16,
    seed-2 weights) on
    a paged state and on contiguous caches, both at kv_dtype fp32 (there
    is no KV; int8 is refused), with CUDA-graph ticks: 16 requests of
    32-128 prompt tokens, 32 new each, 8 slots, ``max_len`` 256, chunk
    ``XLSTM_CHUNK`` (a prefill tick steps the recurrence over every chunk
    token: 8 slots x 396.9 MB of mLSTM state, five passes a token), at
    temperature 0. Each run launches no kernel (the counts set to 0 just
    before and read just after); the two layouts' streams must be equal.
    Then one prefill tick and one decode tick of the paged graph engine
    profiled (``phase_profile``): device busy time, idle share and the top
    kernels. Returns each run's numbers."""
    _free(torch, f"{XLSTM} serve")
    cfg = cfg_mod.get_config(XLSTM, num_layers=XLSTM_LAYERS)
    params = api.init_model(cfg, torch.Generator(device="cuda").manual_seed(2),
                            device="cuda")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(32, 129, size=16)]
    kw = dict(kv_layout="paged", page_size=PS, kv_dtype="fp32", slots=B,
              max_len=XLSTM_MAX_LEN, chunk_size=XLSTM_CHUNK, temperature=0.0,
              device="cuda")
    ckw = dict(kw, kv_layout="contiguous")
    del ckw["page_size"]
    streams, stats = {}, {}
    for label, lkw in (("paged/fp32", kw), ("contiguous/fp32", ckw)):
        _, _, streams[label], st = _serve_run(torch, build, ServeEngine,
                                              params, cfg, prompts, lkw, (),
                                              tag=f"{XLSTM} ")
        stats[label] = st
        torch.cuda.empty_cache()
    if streams["paged/fp32"] != streams["contiguous/fp32"]:
        raise AssertionError(f"{XLSTM}: the layouts' streams differ")
    log(f"[serve] {XLSTM}: paged and contiguous temp-0 streams equal "
        f"({sum(map(len, streams['paged/fp32']))} tokens)")
    stats["idle"] = phase_profile(torch, ServeEngine, params, cfg, kw,
                                  prompts, tag=f"{XLSTM} ", decode_ticks=1)
    del params
    torch.cuda.empty_cache()
    return stats


def _prefix_run(torch, build, ServeEngine, params, cfg, system, tails,
                prefix_cache, chunk):
    """Serve ``system`` + each tail (32 new tokens each) on a fresh traced
    paged int8 engine; with the cache on it is first seeded with the
    system prompt plus one token. The launch counts are set to 0 just
    before the seeding and read just after the run: the two paged kernels
    must have launched, and nothing else. Returns (engine, streams)."""
    label = f"chunk {chunk}, cache {'on' if prefix_cache else 'off'}"
    eng = ServeEngine(params, cfg, kv_layout="paged", page_size=PS,
                      kv_dtype="int8", slots=B, max_len=MAX_LEN,
                      chunk_size=chunk, temperature=0.0,
                      attention_impl="kernel", prefix_cache=prefix_cache,
                      trace=True, device="cuda")
    torch.cuda.synchronize()
    build.reset_counts()
    if prefix_cache:
        eng.submit(system + [1], 1)
        eng.run()
    generated = eng.tokens_generated
    t0 = time.perf_counter()
    reqs = [eng.submit(system + t, 32) for t in tails]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.COUNTS)
    if not all(r.done and r.finish_reason == "length" and len(r.out) == 32
               for r in reqs):
        raise AssertionError(f"prefix {label}: a request did not finish")
    if not all(counts.get(name, 0) > 0 for name in PAGED) or any(
            n for name, n in counts.items() if name not in PAGED):
        raise AssertionError(f"prefix {label}: not the two paged kernels "
                             f"alone: {counts}")
    eng.pool.check_consistency()
    if eng.pool.used_blocks:
        raise AssertionError(f"prefix {label}: {eng.pool.used_blocks} "
                             f"blocks still used after the run")
    tps = (eng.tokens_generated - generated) / wall
    ttft = statistics.median((r.first_token_time - r.submit_time) * 1e3
                             for r in reqs)
    spans = {}
    for e in eng.metrics.events:
        if e["ph"] == "X":
            spans.setdefault(e["name"], []).append(e["dur"] / 1e3)
    st = eng.memory_stats()
    log(f"[prefix] {label}: {len(reqs)} requests of {len(system)} + "
        f"{min(map(len, tails))}-{max(map(len, tails))} tokens, 32 new "
        f"each: {tps:.1f} tokens/s, TTFT p50 {ttft:.1f} ms from submit; "
        f"{eng.prefill_steps} prefill + {eng.decode_steps} decode steps "
        f"(seeding included), {eng.prompt_tokens} prompt tokens prefilled; "
        f"tick span (host clock) p50 ms: " + ", ".join(
            f"{k} {statistics.median(v):.2f} (x{len(v)})"
            for k, v in sorted(spans.items())))
    log(f"[prefix] {label}: launches {json.dumps(counts)}; "
        + json.dumps({k: st[k] for k in (
            "cache_hits", "prefix_hit_tokens", "cow_copies",
            "kv_cached_blocks", "prefill_flops_skipped", "preemptions")
            if k in st}))
    return eng, [r.out for r in reqs]


def phase_prefix(torch, cfg_mod, api, build, ServeEngine):
    """The shared-prefix cache at full width: a 1,024-token system prompt
    and 16 distinct tails of 32-512 tokens, served cold (cache off) and
    warm (cache on, seeded). (a) At chunk 256 the warm streams must equal
    the cold ones and every request must hit the whole system prompt.
    (b) At chunk 200 the grid puts the cursor at 1,000, inside page 62,
    so each of 4 warm requests copies that page before writing it: the
    streams must still equal the cold ones."""
    cfg = cfg_mod.get_config("qwen2-0.5b")          # bf16, ExpMul
    params = api.init_model(cfg, torch.Generator(device="cuda").manual_seed(2),
                            device="cuda")
    rng = np.random.default_rng(5)
    system = rng.integers(1, cfg.vocab_size, size=1024).tolist()
    tails = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
             for n in rng.integers(32, 513, size=16)]
    for chunk, n in ((256, 16), (200, 4)):
        _, cold = _prefix_run(torch, build, ServeEngine, params, cfg,
                              system, tails[:n], False, chunk)
        eng, warm = _prefix_run(torch, build, ServeEngine, params, cfg,
                                system, tails[:n], True, chunk)
        same = sum(a == b for x, y in zip(cold, warm) for a, b in zip(x, y))
        log(f"[prefix] chunk {chunk}: warm vs cold, {same} of "
            f"{sum(map(len, cold))} tokens equal")
        if warm != cold:
            raise AssertionError(f"prefix chunk {chunk}: warm streams differ "
                                 f"from cold ones")
        st = eng.memory_stats()
        if chunk == 256 and st["prefix_hit_tokens"] < n * 1024:
            raise AssertionError(f"prefix: {st['prefix_hit_tokens']} hit "
                                 f"tokens, fewer than {n} x 1024")
        if chunk == 200 and st["cow_copies"] < n:
            raise AssertionError(f"prefix: {st['cow_copies']} copies on "
                                 f"write, fewer than {n}")
    del params
    torch.cuda.empty_cache()


def _fault_run(torch, build, faults, eng, prompts, label, pair, injector=None,
               deadlines=None, during=None, n_new=32):
    """Serve ``prompts`` (rids 0, 1, ...; ``n_new`` new tokens each) on
    ``eng`` with ``injector`` installed, the launch counts set to 0 just
    before and read just after: the ``pair`` of kernels of the layout must
    have launched, and nothing else. ``deadlines`` maps a rid to its
    ``deadline_steps``; ``during(eng, reqs)`` runs before every tick (the
    cancels). With no prompts the run drives the requests ``eng`` carries
    (a restored engine). After the run the pool must be consistent with no
    block in use. Returns (requests, stats)."""
    torch.cuda.synchronize()
    build.reset_counts()
    faults.install_fault_injector(injector)
    generated = eng.tokens_generated
    try:
        t0 = time.perf_counter()
        reqs = [eng.submit(p, n_new, rid=i,
                           deadline_steps=(deadlines or {}).get(i))
                for i, p in enumerate(prompts)] or [
                    r for r in eng.requests if r is not None] + eng.queue
        tick_ms = []
        while True:           # eng.run(), with each tick timed
            if during is not None:
                during(eng, reqs)
            t = time.perf_counter()
            busy = eng.tick()
            torch.cuda.synchronize()
            if busy:
                tick_ms.append((time.perf_counter() - t) * 1e3)
            if not (busy or eng.queue):
                break
        wall = time.perf_counter() - t0
    finally:
        faults.install_fault_injector(None)
    counts = dict(build.COUNTS)
    if not all(counts.get(name, 0) > 0 for name in pair) or any(
            n for name, n in counts.items() if name not in pair):
        raise AssertionError(f"faults {label}: not the layout's two kernels "
                             f"alone: {counts}")
    if not all(r.done and r.finish_reason is not None for r in reqs):
        raise AssertionError(f"faults {label}: a request did not finish")
    if not all(0 <= t < eng.cfg.vocab_size for r in reqs for t in r.out):
        raise AssertionError(f"faults {label}: a token out of the vocabulary")
    if eng.paged:
        eng.pool.check_consistency()
        if eng.pool.used_blocks:
            raise AssertionError(f"faults {label}: {eng.pool.used_blocks} "
                                 f"blocks still used after the run")
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in reqs
            if r.first_token_time is not None and r.submit_time is not None]
    snap = eng.metrics_snapshot()
    stats = dict(tokens_per_s=(eng.tokens_generated - generated) / wall,
                 ttft_p50_ms=statistics.median(ttft) if ttft else None,
                 tick_p50_ms=statistics.median(tick_ms), ticks=len(tick_ms),
                 preemptions=eng.preemptions,
                 recompute_tokens=eng.recompute_tokens,
                 quarantined=snap["quarantined"],
                 finish_reasons={k: v for k, v in
                                 snap["finish_reasons"].items() if v})
    log(f"[faults] {label}: {json.dumps(stats)}; launches "
        f"{json.dumps(counts)}" + ("" if injector is None else
                                   f"; chaos fired " + json.dumps(
                                       {p: injector.fired(p)
                                        for p in injector.POINTS
                                        if injector.fired(p)})))
    return reqs, stats


def _same_streams(label, reqs, baseline, skip=()):
    """Every request not in ``skip`` finished "length" with its baseline
    stream, token for token."""
    for r in reqs:
        if r.rid in skip:
            continue
        if r.finish_reason != "length" or r.out != baseline[r.rid]:
            same = sum(a == b for a, b in zip(r.out, baseline[r.rid]))
            raise AssertionError(
                f"faults {label}: request {r.rid} finished "
                f"{r.finish_reason!r} with {same} of {len(baseline[r.rid])} "
                f"baseline tokens in place")


def phase_faults(torch, cfg_mod, api, build, ServeEngine):
    """Fault-tolerant serving (DESIGN.md §13) at full width: qwen2-0.5b
    (bf16, seed-2 weights, ExpMul), paged int8, pages of 16, 8 slots,
    ``max_len`` 2048, chunk 256, temperature 0, 8 requests of 128-512
    prompt tokens and 32 new tokens each. (a) a fault-free baseline; (b) a
    delay storm (``pool_alloc``, ``admission`` and ``preempt`` at fixed
    opportunities), twice: the runs' streams equal, every request
    "length", >= 4 preemptions and recomputed tokens, the agreement with
    the baseline printed; (c) ``kv_corrupt`` on one request at a decode tick
    and ``logits`` on another: exactly those two "failed", 2 quarantined,
    every other stream the baseline's, under ExpMul and under exact (its own
    baseline); (d) the kv_corrupt victim's prompt again on that engine:
    "length" with the baseline's stream; (e) a ``deadline_steps`` request
    ("deadline", its tokens a prefix of the baseline's), one cancelled
    mid-prefill, one mid-decode, the rest the baseline's; (f) a snapshot
    after the first tick (slots prefilling and decoding), restored into a
    fresh engine on the card and run to the end: the baseline's streams,
    for paged int8 and for contiguous fp32. Every run on its layout's two
    kernels alone, its pool consistent and empty after it."""
    from repro_torch.serve import faults
    from repro_torch.serve.snapshot import restore_engine

    cfg = cfg_mod.get_config("qwen2-0.5b")          # bf16, ExpMul
    params = api.init_model(cfg, torch.Generator(device="cuda").manual_seed(2),
                            device="cuda")
    rng = np.random.default_rng(7)
    lens = rng.integers(128, 513, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    order = [int(i) for i in np.argsort(-lens, kind="stable")]
    kw = dict(kv_layout="paged", page_size=PS, kv_dtype="int8", slots=B,
              max_len=MAX_LEN, chunk_size=CHUNK, temperature=0.0,
              attention_impl="kernel", device="cuda")
    log(f"[faults] prompts of {sorted(map(int, lens))} tokens; rids by "
        f"length, longest first: {order}")

    def run(label, pair=PAGED, cfg_=cfg, ekw=None, **k):
        eng = ServeEngine(params, cfg_, **dict(kw, **(ekw or {})))
        reqs, stats = _fault_run(torch, build, faults, eng, prompts, label,
                                 pair, **k)
        return eng, reqs, stats

    # (a) the baseline, and its witness with eager ticks
    _, reqs, base_stats = run("(a) baseline")
    base = {r.rid: r.out for r in reqs}
    _, reqs, eager_stats = run("(a) baseline, eager ticks",
                               ekw={"eager_ticks": True})
    _same_streams("(a) eager ticks", reqs, base)
    # (b) the delay storm, twice: the two runs must agree token for token
    # (the schedule is a function of the opportunities alone); against the
    # baseline the agreement is printed, not gated: a token recomputed
    # after a preemption, or ridden along a prefill tick where the baseline
    # decoded it, runs another kernel and GEMM shape, whose last bits
    # ExpMul's rounded exponents and bf16 logits' near-ties can turn into
    # another token
    storms = []
    for i in (1, 2):
        inj = faults.ChaosInjector(at={"pool_alloc": [2, 9],
                                       "admission": [0, 3],
                                       "preempt": [20, 37, 54, 71]})
        eng, reqs, storm = run(f"(b) delay storm, run {i}", injector=inj)
        if not all(r.finish_reason == "length" and len(r.out) == 32
                   for r in reqs):
            raise AssertionError("faults (b): a request did not finish "
                                 "'length' with 32 tokens")
        storms.append(([r.out for r in reqs], [r.preemptions for r in reqs],
                       {p: inj.fired(p) for p in inj.POINTS}))
    if storms[0] != storms[1]:
        raise AssertionError("faults (b): two runs of one storm differ")
    if storm["preemptions"] < 4 or storm["recompute_tokens"] <= 0:
        raise AssertionError(f"faults (b): {storm['preemptions']} "
                             f"preemptions, {storm['recompute_tokens']} "
                             f"recomputed tokens")
    first = {r.rid: next((i for i, (a, b) in enumerate(zip(r.out,
                                                          base[r.rid]))
                          if a != b), None) for r in reqs}
    log(f"[faults] (b) the two storm runs agree token for token; against "
        f"the baseline {sum(v is None for v in first.values())} of 8 "
        f"streams equal, first differing token by rid (None: equal) "
        f"{json.dumps(first)}, preemptions by rid "
        f"{json.dumps(storms[0][1])} (not gated)")
    for name, st in (("baseline", base_stats), ("delay storm", storm),
                     ("baseline, eager ticks", eager_stats)):
        log(f"[faults] {name}: {st['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{st['ttft_p50_ms']:.1f} ms from submit, tick p50 "
            f"{st['tick_p50_ms']:.2f} ms over {st['ticks']} ticks")
    # (c) corruption, under ExpMul and exact; (d) the retry
    corrupt, poisoned = order[0], order[3]
    for variant in ("expmul", "exact"):
        vcfg = cfg.replace(attention_variant=variant)
        vbase = base
        if variant == "exact":
            _, reqs, _ = run("(c) exact baseline", cfg_=vcfg)
            vbase = {r.rid: r.out for r in reqs}
        inj = faults.ChaosInjector(
            at={"kv_corrupt": [6], "logits": [8]},
            rids={"kv_corrupt": {corrupt}, "logits": {poisoned}})
        label = f"(c) corruption {variant}"
        eng, reqs, st = run(label, cfg_=vcfg, injector=inj)
        failed = sorted(r.rid for r in reqs if r.finish_reason == "failed")
        if (failed != sorted((corrupt, poisoned)) or st["quarantined"] != 2
                or inj.fired("kv_corrupt") != 1 or inj.fired("logits") != 1):
            raise AssertionError(f"faults {label}: failed {failed}, "
                                 f"quarantined {st['quarantined']}")
        _same_streams(label, reqs, vbase, skip=(corrupt, poisoned))
        if variant == "expmul":
            build.reset_counts()
            retry = eng.submit(prompts[corrupt], 32)
            eng.run()
            counts = dict(build.COUNTS)
            eng.pool.check_consistency()
            if (retry.finish_reason != "length" or retry.out != base[corrupt]
                    or eng.pool.used_blocks or set(counts) != set(PAGED)):
                raise AssertionError(
                    f"faults (d): the retry of request {corrupt} finished "
                    f"{retry.finish_reason!r}, stream equal "
                    f"{retry.out == base[corrupt]}, launches {counts}")
            log(f"[faults] (d) retry of request {corrupt}: 'length', the "
                f"baseline's stream, prefix hit {retry.prefix_hit} tokens; "
                f"launches {json.dumps(counts)}")
    # (e) a deadline, a cancel mid-prefill, a cancel mid-decode
    late, mid_prefill, mid_decode = order[1], order[2], order[5]

    def cancels(eng, reqs):
        r = reqs[mid_prefill]
        if not r.done and 0 < r.pos < len(r.prefill_toks):
            eng.cancel(r.rid)
        r = reqs[mid_decode]
        if not r.done and len(r.out) >= 8:
            eng.cancel(r.rid)
    _, reqs, st = run("(e) deadline and cancels", deadlines={late: 12},
                      during=cancels)
    want = {late: "deadline", mid_prefill: "cancelled",
            mid_decode: "cancelled"}
    got = {rid: reqs[rid].finish_reason for rid in want}
    if got != want or reqs[late].out != base[late][:len(reqs[late].out)] \
            or not reqs[late].out or reqs[mid_prefill].out:
        raise AssertionError(f"faults (e): finish reasons {got}")
    if reqs[mid_decode].out != base[mid_decode][:len(reqs[mid_decode].out)]:
        raise AssertionError("faults (e): the mid-decode cancel's tokens are "
                             "not a prefix of its baseline stream")
    _same_streams("(e) deadline and cancels", reqs, base, skip=want)
    # (f) snapshot and restore, paged int8 and contiguous fp32
    ckw = dict(kv_layout="contiguous", kv_dtype="fp32", page_size=None)
    for label, pair, ekw in (("paged/int8", PAGED, {}),
                             ("contiguous/fp32", CONTIGUOUS, ckw)):
        lbase = base
        if pair is CONTIGUOUS:
            _, reqs, _ = run(f"(f) {label} baseline", pair, ekw=ekw)
            lbase = {r.rid: r.out for r in reqs}
        eng = ServeEngine(params, cfg, **dict(kw, **ekw))
        build.reset_counts()
        for i, p in enumerate(prompts):
            eng.submit(p, 32, rid=i)
        eng.tick()
        torch.cuda.synchronize()
        states = sorted({"prefilling" if r.pos < len(r.prefill_toks)
                         else "decoding" for r in eng.requests if r})
        if states != ["decoding", "prefilling"]:
            raise AssertionError(f"faults (f) {label}: slots {states} at "
                                 f"the snapshot")
        path = Path(tempfile.mkdtemp()) / "engine.npz"
        t = time.perf_counter()
        eng.save_snapshot(str(path))
        save_s = time.perf_counter() - t
        nbytes = path.stat().st_size
        del eng
        torch.cuda.empty_cache()
        t = time.perf_counter()
        restored = restore_engine(str(path), params, cfg, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        path.unlink()
        path.parent.rmdir()
        carried, st = _fault_run(torch, build, faults, restored, [],
                                 f"(f) {label} restored", pair)
        _same_streams(f"(f) {label} restored", carried, lbase)
        if len(carried) != len(prompts):
            raise AssertionError(f"faults (f) {label}: {len(carried)} "
                                 f"requests carried")
        log(f"[faults] (f) {label}: snapshot after tick 1 (slots "
            f"prefilling and decoding), {nbytes} bytes, saved in "
            f"{save_s * 1e3:.1f} ms, restored on the card in "
            f"{restore_s * 1e3:.1f} ms; {len(carried)} requests carried, "
            f"each finished with its baseline stream")
    del params
    torch.cuda.empty_cache()


def _profile_window(torch, fn, label, host=True):
    """Wall time, device busy time, idle share and the top six device
    kernels of one call of ``fn``, from torch.profiler, which traces the
    host's ops too unless ``host`` is false (then only the device's
    kernels: a DTensor step's host ops cost the profiler ~20 s to
    collect). Returns the busy time, {kernel name: (us, launches)} and the
    idle share, all empty or None when the profiler reported no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=([ProfilerActivity.CPU] if host else [])
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = sum(us for us, _ in kernels.values())
    if not busy:
        log(f"[profile] {label}: the profiler reported no device time")
        return 0.0, {}, None
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    idle = 1 - busy / wall_us
    log(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms in {sum(n for _, n in kernels.values())} "
        f"kernels, idle share {idle:.3f}; top "
        f"kernels (ms): " + "; ".join(f"{name[:60]} {us / 1e3:.3f}"
                                      for name, (us, _) in top))
    family = {}
    for name, (us, n) in kernels.items():
        low = name.lower()
        kind = ("attention" if "decode_kernel" in low
                or "prefill_kernel" in low or "flash_kernel" in low else
                "gemm" if any(w in low for w in ("gemm", "xmma", "cutlass",
                                                 "nvjet")) else "other")
        ms, k = family.get(kind, (0.0, 0))
        family[kind] = (ms + us / 1e3, k + n)
    log(f"[profile] {label}: busy ms (launches) by family: "
        + "; ".join(f"{k} {ms:.3f} ({n})" for k, (ms, n)
                    in sorted(family.items())))
    return busy, kernels, round(idle, 3)


def phase_profile(torch, ServeEngine, params, cfg, kw, prompts, tag="",
                  decode_ticks=4):
    """Device busy share and the top device kernels over one prefill tick
    and ``decode_ticks`` decode ticks of a serving path, from
    torch.profiler, after a request of one prefill and one decode tick
    (which capture the graphs). Returns {kind: idle share}."""
    eng = ServeEngine(params, cfg, **kw)
    eng.submit(prompts[8][:200], 2)
    eng.run()
    for p in prompts[:8]:
        eng.submit(p[:200], 8)
    mode = "eager" if kw.get("eager_ticks") else "graphs"
    idle = {}
    for kind, n in (("prefill", 1), ("decode", decode_ticks)):
        if kind == "decode":
            while any(r is not None and r.pos < len(r.prefill_toks)
                      for r in eng.requests):
                eng.tick()
        *_, idle[kind] = _profile_window(
            torch, lambda: [eng.tick() for _ in range(n)],
            f"{tag}{kw['kv_layout']}/{kw['kv_dtype']} {mode} {kind} x{n}")
    eng.run()
    return idle


def _attention_calls(cfg) -> int:
    """Full-sequence attention calls of one forward: one an attention
    layer, an encoder-decoder's decoder layer two (self and cross)."""
    if cfg.encoder_layers:
        return (cfg.pattern_for(cfg.encoder_layers).count("attn")
                + 2 * cfg.decoder_layers)
    return cfg.pattern_for().count("attn")


def phase_train(torch, cfg_mod, api, build, arch="qwen2-0.5b",
                num_layers=None, steps=TRAIN_STEPS):
    """Full-width training of ``arch`` (its depth cut to ``num_layers``
    when given), float32, TF32 off, ExpMul, 8 x 1,024 tokens: the kernel
    against the plain version on one step (loss within 1e-5, grad norm
    within 1e-4 of their values), the launcher's ``steps`` steps gated on
    2 x layers flash launches a step and no other kernel or plain version,
    then step time, tokens/s, peak memory and a profiled step with flash's
    share. Returns the flash kernel's launches and the numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = cfg_mod.get_config(arch)
    layers = num_layers or full.num_layers
    if num_layers:
        # a cut-depth model's step holds ~8 copies of its state and several
        # (8, 1,023, vocab) float32 logits tensors of many sizes: grow the
        # allocator's segments instead of caching fixed blocks, which left
        # 32 GiB reserved but unusable on gemma-7b (a failed 15.6 GiB
        # request), for this phase only
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
        try:
            return _train(torch, cfg_mod, api, build, arch, full, layers,
                          steps)
        finally:
            torch.cuda.empty_cache()
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:False")
    return _train(torch, cfg_mod, api, build, arch, full, layers, steps)


def _train(torch, cfg_mod, api, build, arch, full, layers, steps):
    """``phase_train``'s body, at ``layers`` of ``full``'s depth."""
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.launch import train as launch
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train.step import build_train_step, make_train_state

    base = full.replace(num_layers=layers, dtype="float32",
                        param_dtype="float32", attention_variant="expmul")
    assert base.remat and base.attention_block_k == 512 \
        and base.kv_dtype == "fp32"
    tag = f"[train {arch}]"
    log(f"{tag} {layers} of {full.num_layers} layers, "
        f"{base.param_count():,} parameters")
    data = SyntheticLMDataset(base.vocab_size, TRAIN_SEQ, seed=0)
    batch = {"tokens": torch.from_numpy(data.batch(0, B)).cuda()}
    params = api.init_model(base, torch.Generator(device="cuda").manual_seed(5),
                            device="cuda")
    opt = adamw(cosine_schedule(3e-3, 20, steps),
                moment_dtype=base.opt_state_dtype)

    # 1. one step through the kernel and one through the plain version
    metrics = {}
    for impl in ("kernel", "plain"):
        step = build_train_step(base.replace(attention_impl=impl), opt)
        t0 = time.perf_counter()
        new_state, m = step(make_train_state(params, opt), batch)
        metrics[impl] = {k: float(v) for k, v in m.items()}
        log(f"{tag} one step, attention {impl}: loss "
            f"{metrics[impl]['loss']:.7f}, grad norm "
            f"{metrics[impl]['grad_norm']:.7f} "
            f"({time.perf_counter() - t0:.2f} s)")
        del new_state, m
        torch.cuda.empty_cache()
    (lk, gk), (lp, gp) = ((metrics[i]["loss"], metrics[i]["grad_norm"])
                          for i in ("kernel", "plain"))
    dl, dg = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
    log(f"{tag} kernel vs plain: loss {dl:.3e} (limit 1e-5), grad norm "
        f"{dg:.3e} (limit 1e-4) of their values")
    if not (dl <= 1e-5 and dg <= 1e-4):
        raise AssertionError("the train step through the flash kernel "
                             "disagrees with the plain version")

    # 2. the launcher, with the launch counts gated
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    losses = launch.main(["--steps", str(steps), "--batch", str(B),
                          "--seq", str(TRAIN_SEQ), "--variant", "expmul",
                          "--log-every", "1"],
                         cfg_override=full.replace(num_layers=layers))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.COUNTS)
    log(f"{tag} launcher: {len(losses)} steps of {B} x {TRAIN_SEQ} "
        f"tokens in {wall:.2f} s (init included); losses "
        f"{json.dumps([round(x, 5) for x in losses])}; launches "
        f"{json.dumps(counts)}")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"the launcher's losses: {losses}")
    per_step = 2 * _attention_calls(base)
    if counts.get("flash", 0) != per_step * steps:
        raise AssertionError(f"flash launched {counts.get('flash', 0)} "
                             f"times, not {per_step} a step")
    if any(n for name, n in counts.items() if name != "flash"):
        raise AssertionError(f"another kernel or a plain version ran while "
                             f"training: {counts}")
    torch.cuda.empty_cache()

    # 3. step time, tokens/s, peak memory, one profiled step
    params = api.init_model(base, torch.Generator(device="cuda").manual_seed(5),
                            device="cuda")
    state = make_train_state(params, opt)
    del params
    step = build_train_step(base, opt)
    state, _ = step(state, batch)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(4):
        tb = {"tokens": torch.from_numpy(data.batch(i + 1, B)).cuda()}
        t = time.perf_counter()
        state, m = step(state, tb)
        float(m["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    p50 = statistics.median(times)
    log(f"{tag} step time, ms: p50 {p50:.1f} (steps "
        f"{', '.join(f'{x:.1f}' for x in times)}); {B * TRAIN_SEQ / p50 * 1e3:.1f} "
        f"tokens/s; peak memory {peak / 2**30:.2f} GiB")

    def one_step():
        nonlocal state
        state, m = step(state, batch)
        float(m["loss"])

    busy, kernels, idle = _profile_window(torch, one_step,
                                          f"train {arch} step x1")
    flash = [(us, n) for name, (us, n) in kernels.items()
             if "flash_kernel" in name]
    share = None
    if busy:
        us, n = sum(u for u, _ in flash), sum(c for _, c in flash)
        share = us / busy
        log(f"{tag} flash in the profiled step: {us / 1e3:.3f} ms of "
            f"{busy / 1e3:.2f} ms device busy ({share:.1%}), {n} "
            f"launches")
    del state
    torch.cuda.empty_cache()
    return {"flash": dict(launches=counts["flash"],
                          launches_per_step=per_step),
            "launcher_losses": losses,
            "step_p50_ms": p50, "tokens_per_s": B * TRAIN_SEQ / p50 * 1e3,
            "peak_gib": peak / 2**30, "flash_share": share, "idle": idle,
            "busy_ms": busy / 1e3, "layers": layers}


def phase_train_archs(torch, cfg_mod, build):
    """Every registered arch through ``launch.main([... "--smoke",
    "--steps", "2"])`` on the card (2 x 64 tokens): finite losses; flash
    launched 2 x its attention calls a step (none for xlstm-1.3b) and no
    other kernel or plain version; arctic-480b and kimi-k2-1t-a32b with
    bfloat16 AdamW moments, the frontend archs with zero frontend
    embeddings, qwen2-0.5b once more with ``--compress-grads``. Returns
    each run's flash launches."""
    from repro_torch.launch import train as launch
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    seen = {}
    build_step = launch.build_train_step

    def spy(*args, **kw):
        train_step = build_step(*args, **kw)

        def run(state, batch):
            seen["state"], seen["batch"] = state, batch
            seen["compress"] = kw.get("grad_transform") is not None
            return train_step(state, batch)
        return run

    launch.build_train_step = spy
    out = {}
    try:
        for arch, extra in [(a, []) for a in cfg_mod.ARCH_IDS] + [
                ("qwen2-0.5b", ["--compress-grads"])]:
            cfg = cfg_mod.get_config(arch, smoke=True)
            build.reset_counts()
            losses = launch.main(["--arch", arch, "--smoke", "--steps", "2",
                                  "--batch", "2", "--seq", "64",
                                  "--log-every", "1"] + extra)
            torch.cuda.synchronize()
            counts = dict(build.COUNTS)
            moments = {str(t.dtype).split(".")[-1]
                       for t in tree_leaves(seen["state"]["opt"]["m"])}
            fe = seen["batch"].get("frontend_embeds")
            label = " ".join([arch] + extra)
            log(f"[train archs] {label}: losses "
                f"{json.dumps([round(x, 5) for x in losses])}, launches "
                f"{json.dumps(counts)}, moments {sorted(moments)}, frontend "
                f"{None if fe is None else tuple(fe.shape)}")
            want = 2 * 2 * _attention_calls(cfg)
            if len(losses) != 2 or not all(np.isfinite(losses)):
                raise AssertionError(f"{label}: losses {losses}")
            if counts.get("flash", 0) != want or any(
                    n for name, n in counts.items() if name != "flash"):
                raise AssertionError(f"{label}: launches {counts}, not "
                                     f"{want} flash alone")
            if moments != {cfg.opt_state_dtype}:
                raise AssertionError(f"{label}: moments {moments}")
            if (fe is None) != (not cfg.frontend) or (
                    fe is not None and bool(fe.any())):
                raise AssertionError(f"{label}: frontend embeds {fe}")
            if seen["compress"] != bool(extra):
                raise AssertionError(f"{label}: grad transform")
            out[label] = counts.get("flash", 0)
    finally:
        launch.build_train_step = build_step
    return out


# the multi-device plan's two cells (``repro_torch.launch.dryrun``), each
# dry-run over a fake process group on this host, with the attention calls
# each must count: qwen2-0.5b's train step (24 layers: the forward twice
# under remat, the backward priced once a layer) and kimi-k2-1t-a32b's
# decode step (61 layers)
# (arch, shape, multi-pod, its attention calls, its plan: the ops the
# fixed layouts resharded for, compute / memory / collective seconds and
# the peak estimate in bytes, as the dry run counted them on torch 2.13)
PLAN_CELLS = (("qwen2-0.5b", "train_4k", False,
               {"flash": 48, "flash_backward": 24},
               (1173, (0.14395425262069222, 0.26477786816597015,
                       0.1512057791), 7810209228)),
              ("kimi-k2-1t-a32b", "decode_32k", True, {"decode": 61},
               (427, (0.0006351476583287808, 0.23988354341253731,
                      0.2861890491733333), 7586551968)))
PLAN_RTOL = 1e-6


def phase_plan():
    """The dry run of ``PLAN_CELLS`` on the card's host: each cell's
    compute, memory and collective seconds under the H100 roofline, its
    bottleneck and its GiB a device; gated on a positive count of each
    term's inputs, the attention calls, the plan against the one pinned
    in ``PLAN_CELLS`` (within ``PLAN_RTOL``), and no process group
    left."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import lower_cell

    out = {}
    for arch, shape, multi_pod, calls, plan in PLAN_CELLS:
        counts, meta = lower_cell(arch, shape, multi_pod=multi_pod)
        rf, bpd = meta["roofline"], meta["bytes_per_device"]
        log(f"[plan] {arch} {shape} on {meta['mesh']} ({meta['n_devices']} "
            f"ranks, moe {meta['moe_impl']}): compute {rf['compute_s']:.6f} "
            f"s, memory {rf['memory_s']:.6f} s, collective "
            f"{rf['collective_s']:.6f} s, bottleneck {rf['bottleneck']}, "
            f"{bpd['peak_estimate'] / 2**30:.2f} GiB a device (estimate), "
            f"model/counted FLOPs {rf['useful_flops_ratio']:.3f}, attention "
            f"calls {json.dumps(counts['attention_calls'])}, "
            f"{len(counts['collectives'])} collectives, "
            f"{counts['resharded_ops']} ops resharded for "
            f"({meta['lower_s']} s)")
        if not (rf["flops"] > 0 and rf["hbm_bytes"] > 0
                and rf["coll_bytes"] > 0):
            raise AssertionError(f"{arch} {shape}: an empty roofline term")
        if counts["attention_calls"] != calls:
            raise AssertionError(f"{arch} {shape}: attention calls "
                                 f"{counts['attention_calls']}, not {calls}")
        got = (counts["resharded_ops"], tuple(rf[k] for k in (
            "compute_s", "memory_s", "collective_s")), bpd["peak_estimate"])
        want = plan
        if not (got[0] == want[0] and all(
                math.isclose(g, w, rel_tol=PLAN_RTOL)
                for g, w in zip(got[1] + (got[2],), want[1] + (want[2],)))):
            raise AssertionError(f"{arch} {shape}: the plan (ops resharded "
                                 f"for, terms, peak bytes) {got} is not the "
                                 f"pinned {want}")
        if dist.is_initialized():
            raise AssertionError("the dry run left its process group")
        out[f"{arch} {shape}"] = {k: rf[k] for k in (
            "compute_s", "memory_s", "collective_s", "bottleneck")}
    return out


def phase_counted_step(torch, cfg_mod, api, build):
    """One full-width qwen2-0.5b train step (phase 6's: float32, TF32 off,
    ExpMul, 8 x 1,024 tokens) inside ``launch/op_costs.py``'s counter,
    gated on (a) its loss and grad norm bit for bit those of the same step
    uncounted, (b) the counted flash calls equal to the launches the
    dispatch counter records for it (2 x 24), (c) the counted FLOPs between
    1 and 2 times ``model_flops_per_device`` (the recompute and attention
    on top of 6ND), and (d) the measured step p50 (4 uncounted steps) no
    faster than the roofline's ``step_s`` under the H100 model (each FLOP
    type at its peak: with TF32 off the products are float32 ones), the
    share printed beside the card's name and power limit."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.launch.op_costs import OpCounter
    from repro_torch.launch.roofline import analyze, model_flops_per_device
    from repro_torch.optim import adamw
    from repro_torch.train.step import build_train_step, make_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = cfg_mod.get_config("qwen2-0.5b").replace(
        dtype="float32", param_dtype="float32", attention_variant="expmul")
    data = SyntheticLMDataset(base.vocab_size, TRAIN_SEQ, seed=0)
    batch = {"tokens": torch.from_numpy(data.batch(0, B)).cuda()}
    params = api.init_model(
        base, torch.Generator(device="cuda").manual_seed(5), device="cuda")
    opt = adamw(3e-4)
    step = build_train_step(base, opt)

    def run(counter=None):
        build.reset_counts()
        if counter is None:
            _, m = step(make_train_state(params, opt), batch)
        else:
            with counter:
                _, m = step(make_train_state(params, opt), batch)
        torch.cuda.synchronize()
        return m["loss"], m["grad_norm"], dict(build.COUNTS)

    loss0, gn0, _ = run()
    counter = OpCounter()
    loss1, gn1, launches = run(counter)
    counts = counter.totals()
    log(f"[counted step] loss {float(loss1):.7f} / {float(loss0):.7f} "
        f"uncounted, grad norm {float(gn1):.7f} / {float(gn0):.7f}; flash "
        f"counted {counts['attention_calls'].get('flash', 0)}, launched "
        f"{launches.get('flash', 0)}")
    if not (torch.equal(loss0, loss1) and torch.equal(gn0, gn1)):
        raise AssertionError("the counter moved the step's loss or grad norm")
    per_step = 2 * _attention_calls(base)
    if not (counts["attention_calls"].get("flash") == launches.get("flash")
            == per_step):
        raise AssertionError(f"counted flash calls "
                             f"{counts['attention_calls']} vs launches "
                             f"{launches}, not {per_step} each")
    shape = ShapeSpec("counted_step", TRAIN_SEQ, B, "train")
    model = model_flops_per_device(base, shape, 1)
    rf = analyze(counts, model_flops_per_device=model)
    ratio = counts["flops"] / model
    by_type = {k: round(v / 1e12, 3)
               for k, v in counts["flops_by_type"].items()}
    log(f"[counted step] counted {counts['flops'] / 1e12:.3f} TFLOP, "
        f"6ND {model / 1e12:.3f} TFLOP: counted/model {ratio:.4f}; "
        f"{counts['bytes'] / 1e9:.1f} GB read and written, "
        f"{counts['transcendental_elems'] / 1e9:.3f} G transcendentals; "
        f"TFLOP by type {json.dumps(by_type)}")
    if not 1.0 <= ratio <= 2.0:
        raise AssertionError(f"counted/model FLOPs {ratio:.4f} outside [1, 2]")

    state = make_train_state(params, opt)
    del params
    state, _ = step(state, batch)                    # warm-up
    times = []
    for i in range(4):
        tb = {"tokens": torch.from_numpy(data.batch(i + 1, B)).cuda()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, tb)
        float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    p50 = statistics.median(times)
    del state
    torch.cuda.empty_cache()
    share = rf.step_s / p50
    log(f"[counted step] step p50 {p50 * 1e3:.1f} ms against the H100 "
        f"roofline's {rf.step_s * 1e3:.1f} ms ({rf.bottleneck}-bound: compute "
        f"{rf.compute_s * 1e3:.1f} ms, memory {rf.memory_s * 1e3:.1f} ms): "
        f"{share:.1%} of the roofline, on {card_line()}")
    if not p50 >= rf.step_s > 0:
        raise AssertionError(f"a step of {p50:.4f} s beat its roofline "
                             f"{rf.step_s:.4f} s")
    return {"flash_counted": counts["attention_calls"]["flash"],
            "flash_launches": launches["flash"], "flops": counts["flops"],
            "model_flops": model, "counted_over_model": ratio,
            "bytes": counts["bytes"], "step_p50_s": p50,
            "roofline": rf.to_dict(), "roofline_share": share}


OFFSETS, ODD_OFFSET = (256, 512, 768), 100


def phase_flash_offset(torch, checks, F):
    """The flash kernel at a query offset, as each rank of a query-split
    causal call runs it (``sharding/regions.py:sharded_attention``): at
    qwen2-0.5b's training shape (8 x 1,024 tokens, 14 / 2 heads of 64,
    causal, 512-wide tiles), exact and ExpMul, float32 and bfloat16, and
    once at gemma-7b's head dim 256 (16 / 16 heads, float32, ExpMul): the
    call on ``q[:, :, a:]`` at ``q_offset=a`` equal bit for bit to rows
    a: of the whole call for a in ``OFFSETS`` (multiples of the reference's
    128-row query block), and at ``ODD_OFFSET`` within
    ``checks.kernel_tol`` of the plain version at that offset. Then the
    call at offset 512 (a rank's half of the queries over a 'model' axis
    of 2) timed beside the whole call, with its bound (its rows' causal
    pairs) and SDPA on the same rows as the library yardstick (a
    bottom-right-aligned causal mask over the whole keys)."""
    from repro_torch.kernels.flash.ops import flash_attention_fwd

    rng = np.random.default_rng(31)
    S = TRAIN_SEQ
    worst = 0.0
    shapes = [(H, HKV, D, dt, v) for dt in (torch.float32, torch.bfloat16)
              for v in ("exact", "expmul")]
    shapes.append((GEMMA_H, GEMMA_H, GEMMA_D, torch.float32, "expmul"))
    for h, hkv, d, dtype, variant in shapes:
        case = checks.flash_case(rng, B=B, H=h, Hkv=hkv, Sq=S, Sk=S, D=d,
                                 dtype=dtype, dyadic=False, causal=True,
                                 block_k=512, device="cuda")
        q, k, v = case["q"], case["k"], case["v"]

        def call(a, plain=False):
            return flash_attention_fwd(q[:, :, a:].contiguous(), k, v,
                                       causal=True, variant=variant,
                                       block_k=512, q_offset=a, plain=plain)

        whole = call(0)
        tag = (f"D={d} {h} / {hkv} heads {str(dtype).split('.')[-1]} "
               f"{variant}")
        for a in OFFSETS:
            if not torch.equal(call(a), whole[:, :, a:]):
                raise AssertionError(f"flash at q_offset={a} ({tag}) is not "
                                     f"rows {a}: of the whole call")
        got, ref = call(ODD_OFFSET), call(ODD_OFFSET, plain=True)
        torch.cuda.synchronize()
        err = checks.rel_err(got, ref)
        tol = checks.kernel_tol(variant, dtype)
        worst = max(worst, err)
        log(f"[flash offset] {tag}: offsets {list(OFFSETS)} equal to the "
            f"whole call's rows bit for bit; q_offset={ODD_OFFSET} vs the "
            f"plain version rel err {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"flash at q_offset={ODD_OFFSET} ({tag}) "
                                 f"disagrees with its plain version")
        del case, q, k, v, whole, got, ref

    # the offset call's time at the training shape, float32 ExpMul
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    a = 512
    case = checks.flash_case(rng, B=B, H=H, Hkv=HKV, Sq=S, Sk=S, D=D,
                             dtype=torch.float32, dyadic=False, causal=True,
                             block_k=512, device="cuda")
    q, k, v = case["q"], case["k"], case["v"]
    qa = q[:, :, a:].contiguous()

    def run(qq, off, plain=False):
        return flash_attention_fwd(qq, k, v, causal=True, variant="expmul",
                                   block_k=512, q_offset=off, plain=plain)

    ms = median_ms(torch, lambda: run(qa, a), flush)
    host_ms = median_ms(torch, lambda: run(qa, a), flush, hide_host=False)
    whole_ms = median_ms(torch, lambda: run(q, 0), flush)
    plain_ms = median_ms(torch, lambda: run(qa, a, plain=True), flush, n=3,
                         warmup=1)
    mask = (torch.arange(S, device="cuda")[None, :]
            <= torch.arange(a, S, device="cuda")[:, None])
    sdpa_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
        qa, k, v, attn_mask=mask, enable_gqa=True), flush)
    rows = S - a
    pairs = B * H * ((S * (S + 1) - a * (a + 1)) // 2)
    nbytes = 4 * (2 * B * H * rows * D + 2 * B * HKV * S * D)
    flops = 4 * D * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / TF32_FLOPS_PER_S
    share = pairs / (B * H * S * (S + 1) // 2)
    out = dict(q_offset=a, ms=ms, ms_with_launch=host_ms,
               whole_call_ms=whole_ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=sdpa_ms, pair_share=share,
               worst_rel_err_at_odd_offset=worst)
    log(f"[time] flash at q_offset={a} (float32, ExpMul, B={B}, rows "
        f"{a}-{S - 1} of {S}, {H} / {HKV} heads of {D}, causal, 512-wide "
        f"tiles): kernel {ms:.4f} ms on the device, {host_ms:.4f} ms with "
        f"its launch; the whole call {whole_ms:.4f} ms ({ms / whole_ms:.3f} "
        f"of it; its rows hold {share:.3f} of the causal pairs); plain "
        f"{plain_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}: {nbytes} B, {flops} flop at the TF32 rate), "
        f"library SDPA on the same rows {sdpa_ms:.4f} ms")
    return out


MESH_TRAIN_STEPS = 3
# the resumed mesh launcher's steps: the resumed one (gated; the warm-up),
# MESH_RESUME_STEPS - 2 timed, then one profiled; no checkpoint
MESH_RESUME_STEPS = 5


def phase_mesh_train(torch, cfg_mod, build, trained=None):
    """The train launcher's mesh path (``launch/train.py`` under a process
    group) at world 1 over NCCL on a (1, 1) mesh of this card: qwen2-0.5b
    at full width and depth, float32 (TF32 off), ExpMul, 8 x 1,024 tokens,
    DTensor state, ``ShardedLoader`` batches, the flash kernel per shard.
    The one-device launcher's losses for ``MESH_TRAIN_STEPS`` steps from the
    same seed (``trained``, phase 6's result, ran the same command; without
    it a run of its own), then the mesh launcher for as many with a
    checkpoint at step 2 (each rank's shards), then the mesh launcher
    again on a fresh process group, resuming from it for the last step.
    Gated: the mesh losses equal the one-device losses bit for bit; the
    resumed step's loss equal to the uninterrupted one bit for bit; flash
    launched 48 times a step (24 layers, twice under remat) and no other
    kernel or plain version; no process group left. The resumed launcher
    runs ``MESH_RESUME_STEPS`` steps with no checkpoint: the p50 of the
    steps between the first (the resumed one, a warm-up) and the last (run
    under the profiler, device kernels only: busy time, idle share). Prints
    that p50 beside the one-device one (phase 6's, 4 steps after a
    warm-up, or the own run's), the two profiled steps' device busy times
    and idle shares, and the peak memory of the gated run."""
    import os
    import shutil
    import socket

    import torch.distributed as dist

    from repro_torch.launch import train as launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = cfg_mod.get_config("qwen2-0.5b")
    per_step = 2 * full.pattern_for().count("attn")
    ckpt = tempfile.mkdtemp(prefix="mesh_train_")
    argv = ["--steps", str(MESH_TRAIN_STEPS), "--batch", str(B), "--seq",
            str(TRAIN_SEQ), "--variant", "expmul", "--log-every", "1"]
    times = []
    profiled = {"at": None}          # the step to profile, by its index
    build_step = launch.build_train_step

    def timed(*args, **kw):
        step = build_step(*args, **kw)

        def run(state, batch):
            torch.cuda.synchronize()
            if len(times) == profiled["at"]:
                out = []
                profiled.update(zip(("busy_us", "kernels", "idle"),
                                    _profile_window(
                                        torch, lambda: out.append(
                                            step(state, batch)),
                                        "mesh train step x1, world 1",
                                        host=False)), at=None)
                return out[0]
            t = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            return out
        return run

    def world1(args):
        """``launch.main(args)`` as rank 0 of a world of 1."""
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                   WORLD_SIZE="1", LOCAL_RANK="0")
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            return launch.main(args, cfg_override=full)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    launch.build_train_step = timed
    try:
        torch.cuda.empty_cache()
        if trained is not None and TRAIN_STEPS == MESH_TRAIN_STEPS:
            one = trained["launcher_losses"]
        else:
            one = launch.main(argv, cfg_override=full)
        one_times, times[:] = list(times), []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        build.reset_counts()
        t0 = time.perf_counter()
        mesh = world1(argv + ["--ckpt-dir", ckpt, "--ckpt-every", "2"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(build.COUNTS)
        peak = torch.cuda.max_memory_allocated()
        mesh_times, times[:] = list(times), []
        if dist.is_initialized():
            raise AssertionError("the mesh launcher left its process group")
        saved = sorted(os.listdir(ckpt))
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, d, f))
                         for d in saved for f in os.listdir(
                             os.path.join(ckpt, d)))
        torch.cuda.empty_cache()
        build.reset_counts()
        times[:] = []
        profiled["at"] = MESH_RESUME_STEPS - 1
        last = MESH_TRAIN_STEPS - 1 + MESH_RESUME_STEPS
        t0 = time.perf_counter()
        resumed = world1(["--steps", str(last)] + argv[2:] + [
            "--ckpt-dir", ckpt, "--ckpt-every", str(last + 1)])
        resume_wall = time.perf_counter() - t0
        resume_counts = dict(build.COUNTS)
        if dist.is_initialized():
            raise AssertionError("the resumed launcher left its process "
                                 "group")
        timing = times[1:]
    finally:
        launch.build_train_step = build_step
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()
    if len(timing) != MESH_RESUME_STEPS - 2 or profiled["at"] is not None:
        raise AssertionError(f"the resumed run timed {len(timing)} steps")
    p50 = statistics.median(timing)
    p50_one = (trained["step_p50_ms"] if trained is not None
               else statistics.median(one_times[1:]))
    busy_ms = profiled["busy_us"] / 1e3
    one_busy = (f"{trained['busy_ms']:.1f} ms (its window traced host ops "
                f"too), idle share {trained['idle']}, of its p50 "
                f"{1 - trained['busy_ms'] / p50_one:.3f}"
                if trained is not None else "not profiled")
    diffs = [abs(a - b) for a, b in zip(mesh, one)]
    log(f"[mesh train] world 1 over NCCL, a (1, 1) mesh, qwen2-0.5b full "
        f"width and depth, {B} x {TRAIN_SEQ} tokens: losses "
        f"{json.dumps(mesh)} against the one-device launcher's "
        f"{json.dumps(one)} (differences {json.dumps(diffs)}); resumed from "
        f"{saved} ({ckpt_bytes} bytes) on a fresh process group: "
        f"{json.dumps(resumed)}; launches {json.dumps(counts)}, resumed "
        f"{json.dumps(resume_counts)}")
    log(f"[mesh train] step wall ms: mesh p50 {p50:.1f} (resumed run, "
        f"steps 2-{MESH_RESUME_STEPS - 1}: "
        f"{', '.join(f'{x:.1f}' for x in timing)}; the gated run's steps "
        f"{', '.join(f'{x:.1f}' for x in mesh_times)}, the first a warm-up, "
        f"the last beside the checkpoint's write), one device p50 "
        f"{p50_one:.1f} ({'phase 6' if trained is not None else 'steps '}"
        f"{', '.join(f'{x:.1f}' for x in one_times)}), "
        f"{p50 / p50_one:.3f}x; profiled step (device kernels only): "
        f"mesh device busy {busy_ms:.1f} ms, idle share {profiled['idle']}, "
        f"of the p50 {1 - busy_ms / p50:.3f}; one device busy "
        f"{one_busy}; mesh run "
        f"{wall:.1f} s with its checkpoint, resumed run {resume_wall:.1f} s; "
        f"peak memory {peak / 2**30:.2f} GiB; {card_line()}")
    if len(mesh) != MESH_TRAIN_STEPS or mesh != one:
        raise AssertionError(f"the mesh launcher's losses {mesh} are not the "
                             f"one-device launcher's {one}")
    if saved != ["step_00000002"] or resumed[:1] != mesh[2:] \
            or len(resumed) != MESH_RESUME_STEPS:
        raise AssertionError(f"the resumed run {resumed} from {saved} is not "
                             f"the uninterrupted step {mesh[2:]}")
    for c, n in ((counts, MESH_TRAIN_STEPS),
                 (resume_counts, MESH_RESUME_STEPS)):
        if c.get("flash", 0) != per_step * n or any(
                v for name, v in c.items() if name != "flash"):
            raise AssertionError(f"launches {c}, not {per_step} flash a step "
                                 f"and nothing else")
    return {"flash": dict(launches=counts["flash"],
                          launches_per_step=per_step),
            "losses": mesh, "step_p50_ms": p50, "one_device_p50_ms": p50_one,
            "busy_ms": busy_ms, "idle": profiled["idle"],
            "peak_gib": peak / 2**30, "checkpoint_bytes": ckpt_bytes}


def _bounds(name, lengths, n_valid=None, h=H, hkv=HKV, d=D):
    """(bytes, flops) the function needs at these lengths: each input read
    once (q, the resident codes and scale rows, the chunk, the block
    tables of a paged kernel, the lengths), each output written once; 4*D
    flops per (query, key) pair; h / hkv heads of d."""
    L = np.asarray(lengths, np.int64)
    decode = name.endswith("decode")
    q_out = 2 * 2 * B * h * d * (1 if decode else CHUNK)
    cache = int((hkv * L * (2 * d + 2 * 4)).sum())          # codes + scales
    if name.startswith("paged"):
        meta = int((-(-L // PS) * 4).sum()) + 4 * B * 2
    else:
        meta = 4 * B * (1 if decode else 2)
    if decode:
        pairs = int((h * L).sum())
        return q_out + cache + meta, 4 * d * pairs
    nv = np.asarray(n_valid, np.int64)
    chunk = B * hkv * CHUNK * (2 * d + 2 * 4)
    pairs = int((h * (CHUNK * L + nv * (nv + 1) // 2)).sum())
    return q_out + cache + chunk + meta, 4 * d * pairs


def _time_serving(torch, checks, F, flush, rng, h=H, hkv=HKV, d=D,
                  plain_n=25, plain_warmup=3):
    """The four serving kernels at the serving shapes (int8 codes, ExpMul,
    bf16 q, B sequences of CTX tokens, CHUNK-token chunks) with h / hkv
    heads of d: device time, time with the launch, the plain version's time
    (the median of ``plain_n`` runs), the bound, and the yardstick."""
    common = dict(B=B, H=h, Hkv=hkv, D=d, q_dtype=torch.bfloat16,
                  dyadic=False, device="cuda")
    paged = dict(common, page_size=PS, max_blocks=MAX_LEN // PS)
    lens, nv = [CTX] * B, [CHUNK] * B
    pf = dict(lengths=lens, n_valid=nv, chunk=CHUNK)
    out = {}
    for name, run, make in (
            ("paged_decode", checks.run_decode,
             lambda kv: checks.paged_case(rng, kv=kv, lengths=lens, **paged)),
            ("paged_prefill", checks.run_prefill,
             lambda kv: checks.paged_case(rng, kv=kv, **pf, **paged)),
            ("decode", checks.run_contiguous_decode,
             lambda kv: checks.contiguous_case(rng, kv=kv, S=MAX_LEN,
                                               lengths=lens, **common)),
            ("prefill", checks.run_contiguous_prefill,
             lambda kv: checks.contiguous_case(rng, kv=kv, S=MAX_LEN, **pf,
                                               **common))):
        case = make("int8")
        got = run(case, "expmul")
        ref = run(case, "expmul", plain=True)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        rel = checks.rel_err(got, ref)
        if not rel <= checks.kernel_tol("expmul", torch.bfloat16):
            raise AssertionError(f"{name} disagrees at the serving shapes "
                                 f"(head dim {d})")
        ms = median_ms(torch, lambda: run(case, "expmul"), flush)
        host_ms = median_ms(torch, lambda: run(case, "expmul"), flush,
                            hide_host=False)
        plain_ms = median_ms(torch, lambda: run(case, "expmul", plain=True),
                             flush, n=plain_n, warmup=plain_warmup)
        nbytes, flops = _bounds(name, lens, nv, h, hkv, d)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        # the yardstick: the exact variant on bf16 values, and SDPA over a
        # dense bf16 copy of the same history (no paging, no quantization)
        case16 = make("bf16")
        exact_ms = median_ms(torch, lambda: run(case16, "exact"), flush)
        C = 1 if name.endswith("decode") else CHUNK
        q = torch.randn(B, h, C, d, device="cuda", dtype=torch.bfloat16)
        k = torch.randn(B, hkv, CTX + C - (C == 1), d, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn_like(k)
        mask = None
        if C > 1:    # chunk rows see the history and the chunk causally
            mask = (torch.arange(CTX + C, device="cuda")[None, :]
                    <= CTX + torch.arange(C, device="cuda")[:, None])
        sdpa_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), flush)
        del case, case16
        out[name] = dict(
            max_abs_err=err, ms=ms, ms_with_launch=host_ms,
            plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None,
            yardstick={"what": "exact variant, bf16 values vs SDPA over a "
                       "dense bf16 copy", "kernel_ms": exact_ms,
                       "library_ms": sdpa_ms})
        log(f"[time] {name} (int8 codes, ExpMul, B={B}, {h} / {hkv} heads "
            f"of {d}, ctx {CTX}{', chunk %d' % CHUNK if C > 1 else ''}): "
            f"kernel {ms:.4f} ms on the device, {host_ms:.4f} ms with its "
            f"launch, plain {plain_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops) * 1e3:.4f} ms ({out[name]['bound_by']}: "
            f"{nbytes} B, {flops} flop), max abs err {err:.3e} (rel "
            f"{rel:.3e}); yardstick exact bf16 kernel {exact_ms:.4f} ms vs "
            f"SDPA dense {sdpa_ms:.4f} ms")
    return out

def phase_flash_cross_checks(torch, checks):
    """The flash kernel non-causal at Sq != Sk, as an encoder-decoder's
    cross-attention calls it (``checks.flash_cross_cases``: 1, 7 and 33
    queries over 16 and 1,024 keys), at seamless-m4t-medium's D 64 group 1
    and llava-next-34b's D 128 group 7, float32 and bfloat16, dyadic and
    random, exact and ExpMul, against its plain version at
    ``checks.kernel_tol``; then the cross-attention decode's one-pass
    route (plain ops on every device) on the card against the CPU, at
    seamless's cross K/V (lengths 0, 1, 1,024 and ragged): float32 within
    1e-5, bfloat16 within one bf16 step."""
    from repro_torch.core.attention import decode_one_pass
    rng = np.random.default_rng(11)
    n, worst = 0, 0.0
    for D, group in ((64, 1), (128, 7)):
        for dtype in (torch.float32, torch.bfloat16):
            for dyadic in (True, False):
                for label, case in checks.flash_cross_cases(
                        rng, D=D, group=group, dtype=dtype, dyadic=dyadic):
                    for variant in ("exact", "expmul"):
                        got = checks.run_flash(case, variant)
                        ref = checks.run_flash(case, variant, plain=True)
                        rel = checks.rel_err(got, ref)
                        tol = checks.kernel_tol(variant, dtype)
                        worst = max(worst, rel / tol)
                        n += 1
                        if not rel <= tol:
                            raise AssertionError(
                                f"flash {label} D {D} group {group} "
                                f"{dtype} {variant} dyadic={dyadic}: rel "
                                f"{rel:.3e} over {tol:.1e}")
    log(f"[check] flash cross-attention shapes: {n} cases within "
        f"kernel_tol (worst {worst:.3f} of it)")
    names = ("q", "k", "v", "lengths")
    for dtype in (torch.float32, torch.bfloat16):
        case = checks.one_pass_case(rng, dtype=dtype)
        for variant in ("exact", "expmul"):
            ref = decode_one_pass(*(case[k] for k in names), variant=variant)
            got = decode_one_pass(*(case[k].cuda() for k in names),
                                  variant=variant).cpu()
            rel = checks.rel_err(got, ref)
            log(f"[check] one-pass cross decode {dtype} {variant}: card vs "
                f"CPU rel {rel:.3e}")
            # the card sums in another order than the CPU: a bfloat16
            # result may round one step apart (kernel_tol's bound for the
            # exact variant's bfloat16 output), under ExpMul too
            if not rel <= checks.kernel_tol("exact", dtype):
                raise AssertionError("the one-pass decode on the card "
                                     "disagrees with the CPU")


# flash's training head dims 256, 112 and 96: (D, H, Hkv) at each
# arch's heads; gemma-7b's 256 (16 / 16), kimi-k2-1t-a32b's 112 (64 / 8)
# and minicpm3-4b's 96 (40 / 40, V zero-padded to the qk width)
FLASH_NEW_DIMS = ((256, GEMMA_H, GEMMA_H), (112, KIMI_H, KIMI_HKV),
                  (96, MLA_H, MLA_H))
# their layout edges: under one 32-row query block, one row past it, and
# two 512-wide tiles with a partial last sub-tile
FLASH_NEW_EDGE_SEQS = (1, 33, 1000)


def phase_flash_head_dim_checks(torch, checks):
    """The flash kernel at head dims 96, 112 and 256 against its plain
    version at ``checks.kernel_tol``: causal 8 x 1,024 at the arch's own
    heads (B 1 at 40 or 64 query heads) and a ragged causal 1,000 with a
    256-token window; recurrentgemma-2b's windowed MQA (10 / 1 heads of
    256, a 2,048-token window over 3,000 tokens); the layout's edges
    (``checks.flash_edge_cases`` at 1, 33 and 1,000 tokens, GQA groups 1
    and 7) and the non-causal
    cross shapes (``checks.flash_cross_cases``, groups 1 and 8); float32
    and bfloat16, dyadic and random, exact and ExpMul. Returns the worst
    relative error by head dim."""
    rng = np.random.default_rng(18)
    worst, n = {}, 0

    def hold(case, D, dtype, label):
        nonlocal n
        for variant in ("exact", "expmul"):
            got = checks.run_flash(case, variant)
            ref = checks.run_flash(case, variant, plain=True)
            rel = checks.rel_err(got, ref)
            tol = checks.kernel_tol(variant, dtype)
            key = f"D {D} {str(dtype).split('.')[-1]} {variant}"
            worst[key] = max(worst.get(key, 0.0), rel)
            n += 1
            if not rel <= tol:
                raise AssertionError(f"flash D {D} {label} {dtype} {variant}: "
                                     f"rel {rel:.3e} over {tol:.1e}")

    for D, h, hkv in FLASH_NEW_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for dyadic in (True, False):
                kind = "dyadic" if dyadic else "random"
                for sq, window, b in ((1024, None, 1), (1000, 256, 1)):
                    case = checks.flash_case(
                        rng, B=b, H=h, Hkv=hkv, Sq=sq, Sk=sq, D=D, dtype=dtype,
                        dyadic=dyadic, causal=True, window=window,
                        block_k=512, device="cuda")
                    hold(case, D, dtype, f"{h} / {hkv} heads S {sq} window "
                         f"{window} {kind}")
                if D == RG_D:
                    case = checks.flash_case(
                        rng, B=1, H=RG_H, Hkv=RG_HKV, Sq=3000, Sk=3000, D=D,
                        dtype=dtype, dyadic=dyadic, causal=True,
                        window=RG_WINDOW, block_k=512, device="cuda")
                    hold(case, D, dtype, f"rg {RG_H} / {RG_HKV} heads S 3000 "
                         f"window {RG_WINDOW} {kind}")
                for S in FLASH_NEW_EDGE_SEQS:
                    for group in (1, 7):
                        for label, case in checks.flash_edge_cases(
                                rng, S=S, D=D, group=group, dtype=dtype,
                                dyadic=dyadic, device="cuda"):
                            hold(case, D, dtype, f"S {S} group {group} "
                                 f"{label} {kind}")
                for group in (1, 8):
                    for label, case in checks.flash_cross_cases(
                            rng, D=D, group=group, dtype=dtype,
                            dyadic=dyadic):
                        hold(case, D, dtype, f"cross {label} group {group} "
                             f"{kind}")
    log(f"[check] flash at head dims 96, 112, 256: {n} cases within "
        f"kernel_tol; worst rel err {json.dumps(worst)}")
    return worst


def phase_flash_head_dim_times(torch, checks, F):
    """The flash forward at the training shapes of gemma-7b (16 / 16 heads
    of 256), kimi-k2-1t-a32b (64 / 8 of 112) and minicpm3-4b (40 / 40 of
    96): as phase 5's flash row (8 x 1,024, float32, causal, ExpMul), the
    plain version's time a median of 5."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(19)
    return {f"d{D}": _time_flash(torch, checks, F, flush, rng, h=h, hkv=hkv,
                                 d=D, plain_n=5)
            for D, h, hkv in FLASH_NEW_DIMS}


def phase_llava_ticks(torch, cfg_mod, api, build):
    """llava-next-34b at full width, depth cut to 4 layers, float32 (TF32
    off), random weights from seed 0: 576 projected patches prepended to
    64 text tokens (2 sequences) through ``forward`` on the kernels and on
    the plain versions, exact and ExpMul: logits within 1e-3 of their
    magnitude, flash (or its plain version) launched once a layer and no
    other kernel; then phase 3's ticks on a paged int8 pool and on
    contiguous fp32 caches, gated as in 3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _free(torch, "llava ticks")
    base = cfg_mod.get_config(LLAVA, dtype="float32", param_dtype="float32",
                              num_layers=LLAVA_TICK_LAYERS)
    log(f"[config] {LLAVA}: d_model {base.d_model}, {base.num_heads} / "
        f"{base.num_kv_heads} heads of {base.resolved_head_dim()}, d_ff "
        f"{base.d_ff}, vocab {base.vocab_size} untied, {base.frontend_tokens}"
        f" patches of {base.frontend_dim}; {base.param_count()} parameters;"
        f" reduced: num_layers {cfg_mod.get_config(LLAVA).num_layers} -> "
        f"{LLAVA_TICK_LAYERS}")
    params = api.init_model(base, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(1, base.vocab_size, (2, 64),
                                     generator=gen, device="cuda"),
             "frontend_embeds": torch.randn(
                 (2, base.frontend_tokens, base.frontend_dim), generator=gen,
                 device="cuda")}
    for variant in ("exact", "expmul"):
        out = {}
        for impl in ("kernel", "plain"):
            cfg = base.replace(attention_variant=variant, attention_impl=impl)
            build.reset_counts()
            t0 = time.perf_counter()
            with torch.no_grad():
                out[impl] = api.forward(params, batch, cfg).double()
            torch.cuda.synchronize()
            counts = dict(build.COUNTS)
            name = "flash" if impl == "kernel" else "flash_plain"
            log(f"[model] {LLAVA} forward with frontend {variant} {impl}: "
                f"{tuple(out[impl].shape)} logits in "
                f"{time.perf_counter() - t0:.2f} s, launches {counts}")
            if counts != {name: base.num_layers}:
                raise AssertionError("the forward is not one flash launch a "
                                     "layer")
        a, b = out["kernel"], out["plain"]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("non-finite logits")
        gap = float((a - b).abs().max() / b.abs().max())
        log(f"[model] {LLAVA} forward with frontend {variant}: max|dlogits| "
            f"/ max|logits| = {gap:.3e} (max|logits| "
            f"{float(b.abs().max()):.3f}; gated at 1e-3)")
        if not gap <= 1e-3:
            raise AssertionError("kernel logits disagree with plain")
        del out, a, b
    bt, chunks, toks, tok1 = _tick_inputs(torch, np.random.default_rng(1),
                                          base.vocab_size)
    runs = [("paged", None, "int8", chunks, tok1),
            ("contiguous", None, "fp32", chunks, tok1)]
    _hold_ticks(torch, api, params, base, runs, bt, toks, tag=f"{LLAVA} ")
    del params
    torch.cuda.empty_cache()


def llava_frontend_forward(torch, api, build, params, cfg):
    """One timed ``forward`` of 1 x (576 patches + ``LLAVA_TEXT`` tokens)
    with frontend embeddings, on the served weights (bf16, ExpMul), after
    one untimed: flash launched once a layer and nothing else, finite
    logits of the whole sequence. Returns its launches and ms."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (1, LLAVA_TEXT),
                                     generator=gen, device="cuda"),
             "frontend_embeds": torch.randn(
                 (1, cfg.frontend_tokens, cfg.frontend_dim), generator=gen,
                 device="cuda").to(torch.bfloat16)}
    with torch.no_grad():
        api.forward(params, batch, cfg)
        torch.cuda.synchronize()
        build.reset_counts()
        t0 = time.perf_counter()
        logits = api.forward(params, batch, cfg)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(build.COUNTS)
    S = cfg.frontend_tokens + LLAVA_TEXT
    log(f"[model] {LLAVA} forward with frontend, bf16 ExpMul, "
        f"{cfg.num_layers} layers, 1 x ({cfg.frontend_tokens} + "
        f"{LLAVA_TEXT}) tokens: {ms:.1f} ms, launches {counts}")
    if counts != {"flash": cfg.num_layers}:
        raise AssertionError("the frontend forward is not one flash launch a "
                             "layer")
    if tuple(logits.shape) != (1, S, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("the frontend forward's logits are not finite "
                             "of the expected shape")
    return dict(launches=counts["flash"], forward_ms=ms)


def phase_seamless(torch, cfg_mod, api, build):
    """seamless-m4t-medium at full width and depth (12 + 12 layers, bf16,
    ExpMul, random weights from seed 0), through the kernels and through
    the plain versions from the same weights. A teacher-forced ``forward``
    of 16 text tokens over 8 x 1,024 stub frames: logits within 1e-3 of
    their magnitude, 36 flash launches (12 encoder layers non-causal at
    Sq = Sk = 1,024, then each decoder layer's causal self-attention and
    its cross-attention at Sq = 16 against 1,024). Then its serving path:
    8 requests of 1,024 frames with ``enc_len`` 640 to 1,024, encoded once
    (encoder outputs within 1e-3; 12 flash launches and nothing else),
    each text prompt of 4-16 tokens fed through ``decode_step``, then
    ``SEAMLESS_NEW`` greedy tokens, both paths in lockstep: every step's
    logits within 1e-3 (over the rows whose streams have not parted), 12
    ``decode`` launches a step and nothing else (the cross-attention
    decode is the reference's one-pass plain route), temp-0 streams
    equal. Prints encode ms, decode-step p50, tokens/s and peak memory;
    returns the launches."""
    _free(torch, "seamless")
    base = cfg_mod.get_config(SEAMLESS)              # bf16, ExpMul
    assert base.attention_variant == "expmul" and base.dtype == "bfloat16"
    L, V = base.decoder_layers, base.vocab_size
    log(f"[config] {SEAMLESS}: {base.encoder_layers} + {L} layers, d_model "
        f"{base.d_model}, {base.num_heads} / {base.num_kv_heads} heads of "
        f"{base.resolved_head_dim()}, d_ff {base.d_ff} GELU, {base.norm}, "
        f"vocab {V} tied, {base.frontend_tokens} frames of "
        f"{base.frontend_dim}; {base.param_count()} parameters (uncut)")
    params = api.init_model(base, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    rng = np.random.default_rng(12)
    Se = base.frontend_tokens
    frames = torch.from_numpy(rng.standard_normal(
        (B, Se, base.frontend_dim)).astype(np.float32)).cuda().to(
            torch.bfloat16)
    lo = Se * 5 // 8                                 # 640 of 1,024 frames
    enc_len = np.concatenate([[lo, Se], rng.integers(lo + 1, Se, B - 2)])
    lens_p = np.concatenate([[4, 16], rng.integers(4, 17, B - 2)])
    prompts = [rng.integers(1, V, int(n)).tolist() for n in lens_p]
    impls = ("kernel", "plain")
    cfgs = {impl: base.replace(attention_impl=impl) for impl in impls}
    names = {"kernel": ("flash", "decode"),
             "plain": ("flash_plain", "decode_plain")}

    def gate(label, a, b, quiet=False):
        a, b = a.double(), b.double()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{label}: non-finite values")
        gap = float((a - b).abs().max() / b.abs().max())
        if not quiet or not gap <= 1e-3:
            log(f"[model] {SEAMLESS} {label}: kernel vs plain max|d| / max| "
                f"| = {gap:.3e} (max {float(b.abs().max()):.3f}; gated at "
                f"1e-3)")
        if not gap <= 1e-3:
            raise AssertionError(f"{label}: kernels disagree with plain")
        return gap

    text = torch.from_numpy(rng.integers(1, V, (B, SEAMLESS_TEXT))).cuda()
    out = {}
    for impl in impls:
        build.reset_counts()
        with torch.no_grad():
            out[impl] = api.forward(params, {"tokens": text,
                                             "frontend_embeds": frames},
                                    cfgs[impl])
        torch.cuda.synchronize()
        n = base.encoder_layers + 2 * L
        if dict(build.COUNTS) != {names[impl][0]: n}:
            raise AssertionError(f"forward {impl}: launches "
                                 f"{dict(build.COUNTS)}, not {n} flash")
    gate(f"forward, {SEAMLESS_TEXT} tokens over {Se} frames", out["kernel"],
         out["plain"])
    del out
    steps = int(lens_p.max()) - 1 + SEAMLESS_NEW
    enc_t = torch.from_numpy(enc_len.astype(np.int32)).cuda()
    states, enc, encode_ms = {}, {}, {}
    for impl in impls:
        state = api.init_decode_state(cfgs[impl], B, steps + 1, enc_len=Se,
                                      device="cuda")
        with torch.no_grad():
            enc[impl] = api.encode(params, frames, cfgs[impl])
            torch.cuda.synchronize()
            build.reset_counts()
            t0 = time.perf_counter()
            states[impl] = api.encode_for_decode(params, state, frames, enc_t,
                                                 cfgs[impl])
            torch.cuda.synchronize()
        encode_ms[impl] = (time.perf_counter() - t0) * 1e3
        if dict(build.COUNTS) != {names[impl][0]: base.encoder_layers}:
            raise AssertionError(f"encode {impl}: launches "
                                 f"{dict(build.COUNTS)}")
    gate(f"encoder output, {B} x {Se} frames", enc["kernel"], enc["plain"])
    del enc
    torch.cuda.reset_peak_memory_stats()
    tok = {impl: torch.tensor([p[0] for p in prompts], dtype=torch.int32,
                              device="cuda") for impl in impls}
    streams = {impl: [[] for _ in range(B)] for impl in impls}
    parted = np.zeros(B, bool)
    step_ms, gaps = [], []
    for step in range(steps):
        lens = torch.full((B,), step, dtype=torch.int32, device="cuda")
        logits = {}
        for impl in impls:
            build.reset_counts()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits[impl], _ = api.decode_step(params, states[impl],
                                                  tok[impl], lens, cfgs[impl])
            torch.cuda.synchronize()
            if impl == "kernel":
                step_ms.append((time.perf_counter() - t0) * 1e3)
            if dict(build.COUNTS) != {names[impl][1]: L}:
                raise AssertionError(f"decode step {step} {impl}: launches "
                                     f"{dict(build.COUNTS)}, not {L} decode")
        rows = torch.from_numpy(~parted).cuda()
        gaps.append(gate(f"decode step {step}", logits["kernel"][rows],
                         logits["plain"][rows], quiet=True))
        for impl in impls:
            greedy = logits[impl].argmax(-1).cpu().numpy()
            nxt = []
            for b in range(B):
                if step + 1 < lens_p[b]:
                    nxt.append(prompts[b][step + 1])
                else:
                    if len(streams[impl][b]) < SEAMLESS_NEW:
                        streams[impl][b].append(int(greedy[b]))
                    nxt.append(int(greedy[b]))
            tok[impl] = torch.tensor(nxt, dtype=torch.int32, device="cuda")
        parted |= [a != b for a, b in zip(streams["kernel"],
                                          streams["plain"])]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[model] {SEAMLESS} decode steps: kernel vs plain logits, the "
        f"largest max|d| / max| | of {steps} steps {max(gaps):.3e}, median "
        f"{statistics.median(gaps):.3e} (each gated at 1e-3)")
    gen = sum(map(len, streams["kernel"]))
    same = sum(a == b for x, y in zip(streams["kernel"], streams["plain"])
               for a, b in zip(x, y))
    log(f"[serve] {SEAMLESS}: {B} requests, enc_len {int(enc_len.min())}-"
        f"{int(enc_len.max())} of {Se} frames, prompts {int(lens_p.min())}-"
        f"{int(lens_p.max())} tokens, {SEAMLESS_NEW} new each: encode "
        f"{encode_ms['kernel']:.2f} ms (plain {encode_ms['plain']:.2f}); "
        f"{steps} decode steps, p50 {statistics.median(step_ms):.2f} ms, "
        f"{gen} tokens generated at {gen / (sum(step_ms) / 1e3):.1f} "
        f"tokens/s over the steps (prompt feed included); peak memory "
        f"{peak:.2f} GiB (both paths' states); kernel vs plain temp-0 "
        f"streams {same} of {gen} tokens equal")
    if streams["kernel"] != streams["plain"] or gen != B * SEAMLESS_NEW:
        raise AssertionError("the kernel path's streams differ from the "
                             "plain path's")
    del params, states
    torch.cuda.empty_cache()
    return {"flash_encode": base.encoder_layers,
            "flash_forward": base.encoder_layers + 2 * L,
            "decode": L * steps, "encode_ms": encode_ms["kernel"],
            "decode_step_p50_ms": statistics.median(step_ms)}


def phase_frontend_times(torch, checks, F, build, flash, decode):
    """flash at this slice's new shapes (bf16, ExpMul, 512-wide tiles):
    llava-next-34b's frontend forward (1 x 1,088 tokens, 56 / 8 heads of
    128, causal), seamless-m4t-medium's encoder (8 x 1,024 frames, 16 / 16
    heads of 64, non-causal) and its cross-attention (16 queries against
    1,024 frames); and the contiguous decode at seamless's self-attention
    (8 x 16 / 16 heads of 64, bf16 cache of 64 slots, lengths 16-48):
    device time, time with the launch, the plain version (median of 5),
    the bound, the exact variant against SDPA on the same bf16 operands;
    each bf16 ExpMul instantiation's registers and spills, and the shared
    memory a CTA."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(13)
    S_llava = 576 + LLAVA_TEXT
    out = {"flash": {}}
    for label, kw in (
            ("llava_frontend", dict(B=1, H=ARCTIC_H, Hkv=ARCTIC_HKV,
                                    Sq=S_llava, Sk=S_llava, D=ARCTIC_D,
                                    causal=True)),
            ("seamless_encoder", dict(B=B, H=16, Hkv=16, Sq=1024, Sk=1024,
                                      D=64, causal=False)),
            ("seamless_cross", dict(B=B, H=16, Hkv=16, Sq=SEAMLESS_TEXT,
                                    Sk=1024, D=64, causal=False))):
        case = checks.flash_case(rng, dtype=torch.bfloat16, dyadic=False,
                                 block_k=512, device="cuda", **kw)
        got = checks.run_flash(case, "expmul")
        ref = checks.run_flash(case, "expmul", plain=True)
        rel = checks.rel_err(got, ref)
        if not rel <= checks.kernel_tol("expmul", torch.bfloat16):
            raise AssertionError(f"flash disagrees at {label}")
        def run(v="expmul", plain=False, case=case):
            return checks.run_flash(case, v, plain=plain)
        ms = median_ms(torch, run, flush)
        host_ms = median_ms(torch, run, flush, hide_host=False)
        plain_ms = median_ms(torch, lambda: run(plain=True), flush, n=5,
                             warmup=1)
        exact_ms = median_ms(torch, lambda: run("exact"), flush)
        q, k, v = case["q"], case["k"], case["v"]
        sdpa_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=kw["causal"], enable_gqa=True), flush)
        Bq, H, Sq, Sk, D = kw["B"], kw["H"], kw["Sq"], kw["Sk"], kw["D"]
        pairs = Bq * H * (Sq * (Sq + 1) // 2 if kw["causal"] else Sq * Sk)
        nbytes = 2 * (2 * Bq * H * Sq * D + 2 * Bq * kw["Hkv"] * Sk * D)
        flops = 4 * D * pairs
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        out["flash"][label] = dict(
            max_abs_err=float((got.float() - ref.float()).abs().max()),
            ms=ms, ms_with_launch=host_ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None,
            yardstick={"what": "exact variant vs SDPA, bf16",
                       "kernel_ms": exact_ms, "library_ms": sdpa_ms},
            ptxas=_ptxas(build, "flash",
                         f"flash_kernelI13__nv_bfloat16Li{D}ELb1EE"),
            smem_bytes=flash.smem_bytes(D, 512))
        log(f"[time] flash {label} (bf16, ExpMul, B={Bq}, {H} / "
            f"{kw['Hkv']} heads of {D}, Sq {Sq}, Sk {Sk}, "
            f"{'causal' if kw['causal'] else 'non-causal'}): kernel "
            f"{ms:.4f} ms on the device, {host_ms:.4f} ms with its launch, "
            f"plain {plain_ms:.4f} ms, bound "
            f"{out['flash'][label]['bound_ms']:.4f} ms "
            f"({out['flash'][label]['bound_by']}: {nbytes} B, {flops} flop "
            f"at the bf16 rate), {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
            f"rel err {rel:.3e}; exact variant {exact_ms:.4f} ms vs SDPA "
            f"{sdpa_ms:.4f} ms")
    lens = rng.integers(16, 49, B).tolist()
    case = checks.contiguous_case(rng, B=B, H=16, Hkv=16, D=64, S=64,
                                  lengths=lens, kv="bf16",
                                  q_dtype=torch.bfloat16, dyadic=False,
                                  device="cuda")
    def run(v="expmul", plain=False):
        return checks.run_contiguous_decode(case, v, plain=plain)
    got, ref = run(), run(plain=True)
    rel = checks.rel_err(got, ref)
    if not rel <= checks.kernel_tol("expmul", torch.bfloat16):
        raise AssertionError("decode disagrees at seamless's self-attention")
    ms = median_ms(torch, run, flush)
    host_ms = median_ms(torch, run, flush, hide_host=False)
    plain_ms = median_ms(torch, lambda: run(plain=True), flush, n=5,
                         warmup=1)
    exact_ms = median_ms(torch, lambda: run("exact"), flush)
    q = torch.randn(B, 16, 1, 64, device="cuda", dtype=torch.bfloat16)
    kd = torch.randn(B, 16, max(lens), 64, device="cuda", dtype=torch.bfloat16)
    vd = torch.randn_like(kd)
    sdpa_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
        q, kd, vd), flush)
    L = np.asarray(lens, np.int64)
    nbytes = 2 * 2 * B * 16 * 64 + int((16 * L * 2 * 64 * 2).sum()) + 4 * B
    flops = 4 * 64 * int((16 * L).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    out["decode"] = dict(
        max_abs_err=float((got.float() - ref.float()).abs().max()), ms=ms,
        ms_with_launch=host_ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
        yardstick={"what": "exact variant vs SDPA over a dense bf16 copy",
                   "kernel_ms": exact_ms, "library_ms": sdpa_ms},
        ptxas=_ptxas(build, "decode",
                     "decode_kernelI13__nv_bfloat16Li64ELi64ELb1EE"),
        smem_bytes=decode.contiguous_decode_smem(1, 64, decode.BLOCK_K,
                                                 torch.bfloat16))
    for label, r in [*out["flash"].items(), ("decode", out["decode"])]:
        log(f"[resources] {label}: {r['ptxas']}; {r['smem_bytes']} B of "
            f"shared memory a CTA")
    log(f"[time] decode seamless self-attention (bf16 cache, ExpMul, B={B}, "
        f"16 / 16 heads of 64, lengths {min(lens)}-{max(lens)} of 64): "
        f"kernel {ms:.4f} ms on the device, {host_ms:.4f} ms with its "
        f"launch, plain {plain_ms:.4f} ms, bound "
        f"{out['decode']['bound_ms']:.5f} ms ({out['decode']['bound_by']}: "
        f"{nbytes} B, {flops} flop), rel err {rel:.3e}; exact variant "
        f"{exact_ms:.4f} ms vs SDPA {sdpa_ms:.4f} ms")
    return out


def phase_times(torch, checks, F):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(4)
    # the plain versions a median of 5 runs (25 until the script outgrew
    # its time)
    out = _time_serving(torch, checks, F, flush, rng, plain_n=5,
                        plain_warmup=1)
    out["flash"] = _time_flash(torch, checks, F, flush, rng, plain_n=5)
    out["expmul"] = _time_expmul(torch, checks, flush, rng)
    for name, r in out.items():
        log(f"[time] {name}: {r['ms']:.4f} ms; " + ", ".join(
            f"at {commit} {ms[name]:.4f} ms ({ms[name] / r['ms']:.2f}x)"
            for commit, ms in BEFORE_MS.items()))
    return out


def phase_gemma_times(torch, checks, F):
    """The four serving kernels at gemma-7b's serving shapes: 16 / 16 heads
    of 256, the rest as phase 5 (the plain versions' median of 3 runs)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    return _time_serving(torch, checks, F, flush, np.random.default_rng(5),
                         h=GEMMA_H, hkv=GEMMA_H, d=GEMMA_D, plain_n=3,
                         plain_warmup=1)


def phase_arctic_times(torch, checks, F):
    """The four serving kernels at arctic-480b's serving shapes: 56 / 8
    heads of 128, the rest as phase 5 (the plain versions' median of 3
    runs)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    return _time_serving(torch, checks, F, flush, np.random.default_rng(7),
                         h=ARCTIC_H, hkv=ARCTIC_HKV, d=ARCTIC_D, plain_n=3,
                         plain_warmup=1)


def phase_kimi_times(torch, checks, F):
    """The four serving kernels at kimi-k2-1t-a32b's serving shapes: 64 / 8
    heads of 112, the rest as phase 5 (the plain versions' median of 3
    runs)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    return _time_serving(torch, checks, F, flush, np.random.default_rng(17),
                         h=KIMI_H, hkv=KIMI_HKV, d=KIMI_D, plain_n=3,
                         plain_warmup=1)


def phase_rg_times(torch, checks, F, decode, prefill):
    """The four serving kernels at recurrentgemma-2b's serving shapes: B
    sequences of RG_CTX resident tokens, a 2,048-token window (so 2,048
    keys a query; the contiguous cache a wrapped rolling buffer of span
    2,048), CHUNK-token chunks, 10 / 1 heads of 256, bf16 values and q,
    ExpMul: device time, time with the launch, the plain version's time
    (median of 3 runs), the least time the card could take for this run's
    work, the exact-variant yardstick against SDPA over a dense bf16 copy
    under the same windowed mask, and the shared memory a CTA takes at
    group 10."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(14)
    W, C, L, d = RG_WINDOW, CHUNK, RG_CTX, RG_D
    common = dict(B=B, H=RG_H, Hkv=RG_HKV, D=d, kv="bf16",
                  q_dtype=torch.bfloat16, dyadic=False, window=W,
                  device="cuda")
    mb = -(-(L + C) // PS) + 1
    lens, nv = [L] * B, [C] * B
    smem = {
        "paged_decode": decode.paged_decode_smem(RG_H // RG_HKV, d, PS, mb,
                                                 torch.bfloat16),
        "paged_prefill": prefill.paged_prefill_smem(d),
        "decode": decode.contiguous_decode_smem(RG_H // RG_HKV, d,
                                                decode.BLOCK_K,
                                                torch.bfloat16),
        "prefill": prefill.contiguous_prefill_smem(d, prefill.BLOCK_K)}
    out = {}
    for name, run, case in (
            ("paged_decode", checks.run_decode,
             checks.paged_case(rng, page_size=PS, max_blocks=mb,
                               lengths=lens, **common)),
            ("paged_prefill", checks.run_prefill,
             checks.paged_case(rng, page_size=PS, max_blocks=mb,
                               lengths=lens, n_valid=nv, chunk=C, **common)),
            ("decode", checks.run_contiguous_decode,
             checks.contiguous_case(rng, S=W, lengths=[W] * B, **common)),
            ("prefill", checks.run_contiguous_prefill,
             checks.contiguous_case(rng, S=W, lengths=lens, n_valid=nv,
                                    chunk=C, rolling=True, **common))):
        got = run(case, "expmul")
        ref = run(case, "expmul", plain=True)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        rel = checks.rel_err(got, ref)
        if not rel <= checks.kernel_tol("expmul", torch.bfloat16):
            raise AssertionError(f"{name} disagrees at {RG}'s serving shapes")
        ms = median_ms(torch, lambda: run(case, "expmul"), flush)
        host_ms = median_ms(torch, lambda: run(case, "expmul"), flush,
                            hide_host=False)
        plain_ms = median_ms(torch, lambda: run(case, "expmul", plain=True),
                             flush, n=3, warmup=1)
        exact_ms = median_ms(torch, lambda: run(case, "exact"), flush)
        # this run's work: every query sees W keys; the K/V read once are
        # the window's (the history's last W - 1 tokens and the chunk for
        # a prefill), q and the output once, the tables' window pages
        dec = name.endswith("decode")
        q_len = 1 if dec else C
        kv_rows = W if dec else (W - 1) + C
        nbytes = (B * RG_HKV * kv_rows * 2 * d * 2
                  + 2 * B * RG_H * q_len * d * 2
                  + (B * (-(-kv_rows // PS) + 1) * 4
                     if name.startswith("paged") else 0) + 4 * B * 2)
        flops = 4 * d * B * RG_H * q_len * W
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        q = torch.randn(B, RG_H, q_len, d, device="cuda", dtype=torch.bfloat16)
        k = torch.randn(B, RG_HKV, kv_rows + (0 if dec else 1), d,
                        device="cuda", dtype=torch.bfloat16)
        v = torch.randn_like(k)
        mask = None
        if not dec:    # chunk row i is key W + i - 1 + 1; it sees (i, W + i]
            j = torch.arange(k.shape[2], device="cuda")[None, :]
            i = torch.arange(C, device="cuda")[:, None]
            mask = (j > i) & (j <= W + i)
        sdpa_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), flush)
        out[name] = dict(
            max_abs_err=err, ms=ms, ms_with_launch=host_ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, smem_bytes_group_10=smem[name],
            yardstick={"what": "exact variant, bf16 values vs SDPA over a "
                       "dense bf16 copy, same windowed mask",
                       "kernel_ms": exact_ms, "library_ms": sdpa_ms})
        log(f"[time] {RG} {name} (bf16 values, ExpMul, B={B}, {RG_H} / "
            f"{RG_HKV} heads of {d}, ctx {L}, window {W}"
            f"{', chunk %d' % C if not dec else ''}): kernel {ms:.4f} ms on "
            f"the device, {host_ms:.4f} ms with its launch, plain "
            f"{plain_ms:.4f} ms, bound {max(t_bytes, t_ops) * 1e3:.4f} ms "
            f"({out[name]['bound_by']}: {nbytes} B, {flops} flop), max abs "
            f"err {err:.3e} (rel {rel:.3e}); yardstick exact bf16 kernel "
            f"{exact_ms:.4f} ms vs SDPA {sdpa_ms:.4f} ms; shared memory at "
            f"group {RG_H // RG_HKV}: {smem[name]} B")
        del case
    return out


def _sdpa_backends(torch, F, flush, q, k, v, mask):
    """SDPA over dense operands under each backend that takes them (K rows
    of 96, V rows of 64: flash attention needs Dv == D), in PyTorch's
    default order, and under the default dispatch: {backend: ms}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for be in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([be]):
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
                torch.cuda.synchronize()
        except RuntimeError:
            continue

        def run(be=be):
            with sdpa_kernel([be]):
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        out[be.name] = median_ms(torch, run, flush)
    out["default"] = median_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), flush)
    return out


def phase_mla_times(torch, checks, F, build, decode, prefill):
    """The contiguous decode and prefill at minicpm3-4b's serving shapes:
    bf16 expanded K (96) and V (64), ExpMul, bf16 q, 8 sequences of 1,024
    resident tokens, 40 / 40 heads, 256-token chunks; device time, time
    with the launch, the plain version's (median of 3), the bound (each
    input and output byte once at the HBM rate; 2 (D + Dv) operations a
    (query, key) pair at the bf16 peak), the exact-bf16 yardstick against
    SDPA over the same dense bf16 operands under each backend that takes
    Dv != D, and float32 K/V (what a dequantized int8 latent expands to,
    the paged int8 run's operands) beside; then each instantiation's
    registers, spills and shared memory a CTA."""
    D, Dv = checks.MLA_DIMS
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(6)
    lens, nv = [CTX] * B, [CHUNK] * B
    common = dict(B=B, H=MLA_H, Hkv=MLA_H, D=D, Dv=Dv, S=MAX_LEN,
                  lengths=lens, q_dtype=torch.bfloat16, dyadic=False,
                  device="cuda")
    L = np.asarray(lens, np.int64)
    out = {}
    for name, run, pf in (("decode", checks.run_contiguous_decode, {}),
                          ("prefill", checks.run_contiguous_prefill,
                           dict(n_valid=nv, chunk=CHUNK))):
        C = CHUNK if pf else 1
        case = checks.contiguous_case(rng, kv="bf16", **common, **pf)
        got = run(case, "expmul")
        ref = run(case, "expmul", plain=True)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        rel = checks.rel_err(got, ref)
        if not rel <= checks.kernel_tol("expmul", torch.bfloat16):
            raise AssertionError(f"{name} disagrees at minicpm3-4b's "
                                 f"serving shapes")
        ms = median_ms(torch, lambda: run(case, "expmul"), flush)
        host_ms = median_ms(torch, lambda: run(case, "expmul"), flush,
                            hide_host=False)
        plain_ms = median_ms(torch, lambda: run(case, "expmul", plain=True),
                             flush, n=3, warmup=1)
        # bytes: q and the output, the resident K/V rows and the chunk's,
        # the lengths (and n_valid); pairs: every resident key, and the
        # chunk's causal triangle
        kv_row = MLA_H * (D + Dv) * 2
        nbytes = (B * MLA_H * C * (D + Dv) * 2 + int(L.sum()) * kv_row
                  + (B * C * kv_row if pf else 0) + 4 * B * (2 if pf else 1))
        pairs = int((MLA_H * (C * L + (C * (C + 1) // 2 if pf else 0))).sum())
        flops = 2 * (D + Dv) * pairs
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        exact_ms = median_ms(torch, lambda: run(case, "exact"), flush)
        case32 = checks.contiguous_case(rng, kv="f32", **common, **pf)
        ms32 = median_ms(torch, lambda: run(case32, "expmul"), flush)
        del case32
        q = torch.randn(B, MLA_H, C, D, device="cuda", dtype=torch.bfloat16)
        k = torch.randn(B, MLA_H, CTX + C - (C == 1), D, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn(B, MLA_H, CTX + C - (C == 1), Dv, device="cuda",
                        dtype=torch.bfloat16)
        mask = None
        if C > 1:    # chunk rows see the history and the chunk causally
            mask = (torch.arange(CTX + C, device="cuda")[None, :]
                    <= CTX + torch.arange(C, device="cuda")[:, None])
        sdpa = _sdpa_backends(torch, F, flush, q, k, v, mask)
        del case, q, k, v
        entry = f"{name}_kernelI13__nv_bfloat16Li{D}ELi{Dv}ELb1EE"
        smem = (decode.contiguous_decode_smem(1, D, decode.BLOCK_K,
                                              torch.bfloat16, Dv)
                if name == "decode" else
                prefill.contiguous_prefill_smem(D, prefill.BLOCK_K, Dv))
        out[name] = dict(
            max_abs_err=err, ms=ms, ms_with_launch=host_ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, ms_f32_kv=ms32,
            yardstick={"what": "exact variant, bf16 values vs SDPA over the "
                       "same dense bf16 operands, by backend",
                       "kernel_ms": exact_ms, "library_ms": sdpa},
            ptxas=_ptxas(build, name, entry), smem_bytes=smem)
        log(f"[time] {name} at {D}/{Dv} (bf16 K/V, ExpMul, B={B}, "
            f"{MLA_H} / {MLA_H} heads, ctx {CTX}"
            f"{', chunk %d' % CHUNK if pf else ''}): kernel {ms:.4f} ms on "
            f"the device, {host_ms:.4f} ms with its launch, plain "
            f"{plain_ms:.4f} ms, bound {max(t_bytes, t_ops) * 1e3:.4f} ms "
            f"({out[name]['bound_by']}: {nbytes} B, {flops} flop), max abs "
            f"err {err:.3e} (rel {rel:.3e}); float32 K/V {ms32:.4f} ms; "
            f"yardstick exact bf16 kernel {exact_ms:.4f} ms vs SDPA "
            f"{json.dumps(sdpa)}; {entry}: {out[name]['ptxas']}, {smem} B of "
            f"shared memory a CTA")
    return out


# the main-path instantiations of the kernels, as the compiler names them:
# the serving kernels' (int8 codes, D 64, ExpMul) and flash's training one
# (float32, D 64, ExpMul)
MAIN_ENTRY = {"decode": "decode_kernelIaLi64ELi64ELb1EE",
              "prefill": "prefill_kernelIaLi64ELi64ELb1EE",
              "paged_decode": "paged_decode_kernelIaLi64ELb1EE",
              "paged_prefill": "paged_prefill_kernelIaLi64ELb1EE",
              "flash": "flash_kernelIfLi64ELb1EE"}


def phase_resources(build, decode, prefill, flash):
    """Registers and spills of the kernels' main-path instantiations
    (nvcc -Xptxas -v), and the shared memory each gives a CTA, as the
    kernel's own source computes it (its C query). The paged decode's must
    be the same at 1,024 and at 32,768 tokens of context. Returns flash's
    registers, spills and shared memory at the training shapes."""
    import torch
    smem = {}
    for group, dtype in ((H // HKV, torch.int8), (H // HKV, torch.float32),
                         (32, torch.float32)):
        smem[f"decode group {group} {dtype}"] = decode.contiguous_decode_smem(
            group, D, 256, dtype)
    smem["prefill bk 512"] = prefill.contiguous_prefill_smem(D, 512)
    for group, dtype in ((H // HKV, torch.int8), (H // HKV, torch.float32),
                         (32, torch.float32)):
        at = {ctx: decode.paged_decode_smem(group, D, PS, ctx // PS, dtype)
              for ctx in (CTX, 32768)}
        if len(set(at.values())) != 1 or min(at.values()) <= 0:
            raise AssertionError(f"paged_decode's shared memory grows with "
                                 f"the context: {at}")
        smem[f"paged_decode group {group} {dtype} (ctx {CTX} and 32768)"] = \
            at[CTX]
    smem["paged_prefill"] = prefill.paged_prefill_smem(D)
    for hd in flash.HEAD_DIMS:
        smem[f"flash D {hd} bk 512"] = flash.smem_bytes(hd, 512)
    info = {}
    for name, entry in MAIN_ENTRY.items():
        info[name] = _ptxas(build, name, entry)
        log(f"[resources] {name} ({entry}): {info[name]}")
    log(f"[resources] shared memory a CTA, B (any S or context): "
        f"{json.dumps(smem)}")
    out = {"flash": {"ptxas": info["flash"],
                     "smem_bytes": smem[f"flash D {D} bk 512"]}}
    # flash at head dims 256, 112 and 96, float32 and bfloat16, ExpMul
    for hd, _, _ in FLASH_NEW_DIMS:
        res = {"ptxas": {dt: _ptxas(build, "flash",
                                    f"flash_kernelI{mangled}Li{hd}ELb1EE")
                         for dt, mangled in (("f32", "f"),
                                             ("bf16", "13__nv_bfloat16"))},
               "smem_bytes": smem[f"flash D {hd} bk 512"]}
        log(f"[resources] flash at head dim {hd}, ExpMul: {json.dumps(res)}")
        out["flash"][f"d{hd}"] = res
    # gemma-7b's head dim: every KV dtype's ExpMul instantiation, group 1
    smem_256 = {
        "paged_decode": lambda dt: decode.paged_decode_smem(
            1, GEMMA_D, PS, CTX // PS, dt),
        "paged_prefill": lambda dt: prefill.paged_prefill_smem(GEMMA_D),
        "decode": lambda dt: decode.contiguous_decode_smem(
            1, GEMMA_D, decode.BLOCK_K, dt),
        "prefill": lambda dt: prefill.contiguous_prefill_smem(
            GEMMA_D, prefill.BLOCK_K)}
    for name in PAGED + CONTIGUOUS:
        d256 = {"ptxas": {}, "smem_bytes": {}}
        dims = f"Li{GEMMA_D}E" * (2 if name in CONTIGUOUS else 1)
        for kv, (mangled, dtype) in KV_MANGLED.items():
            d256["ptxas"][kv] = _ptxas(
                build, name, f"{name}_kernelI{mangled}{dims}Lb1EE")
            d256["smem_bytes"][kv] = smem_256[name](getattr(torch, dtype))
        log(f"[resources] {name} at head dim {GEMMA_D}, ExpMul, by KV "
            f"dtype: {json.dumps(d256)}")
        out[name] = {"d256": d256}
    # arctic-480b's head dim 128 and kimi-k2-1t-a32b's 112: every KV
    # dtype's ExpMul instantiation, at their GQA groups of 7 and 8
    for key, hd, group in (("d128", ARCTIC_D, ARCTIC_GROUP),
                           ("d112", KIMI_D, KIMI_GROUP)):
        smem_at = {
            "paged_decode": lambda dt: decode.paged_decode_smem(
                group, hd, PS, CTX // PS, dt),
            "paged_prefill": lambda dt: prefill.paged_prefill_smem(hd),
            "decode": lambda dt: decode.contiguous_decode_smem(
                group, hd, decode.BLOCK_K, dt),
            "prefill": lambda dt: prefill.contiguous_prefill_smem(
                hd, prefill.BLOCK_K)}
        for name in PAGED + CONTIGUOUS:
            res = {"ptxas": {}, "smem_bytes": {}}
            dims = f"Li{hd}E" * (2 if name in CONTIGUOUS else 1)
            for kv, (mangled, dtype) in KV_MANGLED.items():
                res["ptxas"][kv] = _ptxas(
                    build, name, f"{name}_kernelI{mangled}{dims}Lb1EE")
                res["smem_bytes"][kv] = smem_at[name](getattr(torch, dtype))
            log(f"[resources] {name} at head dim {hd}, ExpMul, by KV dtype "
                f"(group {group}): {json.dumps(res)}")
            out[name][key] = res
    return out


# the template arguments of a KV dtype as the compiler spells them
KV_MANGLED = {"f32": ("f", "float32"), "bf16": ("13__nv_bfloat16", "bfloat16"),
              "int8": ("a", "int8"), "fp8": ("13__nv_fp8_e4m3",
                                              "float8_e4m3fn")}


def _ptxas(build, name, entry) -> str:
    """The compiler's registers and spills line of one instantiation."""
    lines = build.build_log(name).splitlines()
    at = [i for i, l in enumerate(lines)
          if "Compiling entry function" in l and entry in l]
    if not at:
        raise AssertionError(f"no compiler report for {entry}")
    return " | ".join(l.split(":", 1)[-1].strip() if "ptxas" in l
                      else l.strip() for l in lines[at[0] + 1:at[0] + 5]
                      if "registers" in l or "spill" in l)


def _time_expmul(torch, checks, flush, rng):
    """The ExpMul kernel at the flash recurrence's state of the training
    shapes, rows = 8 x 14 x 1024: (rows, 64) float32 and bfloat16 and the
    merged (rows, 65) float32; bytes once each (x, v in, out) at the HBM
    rate; the yardstick is ``exact_expmul``, the paper's unfused baseline
    (``torch.exp``, then a broadcast multiply), a different function: no
    PyTorch call computes the quantized one."""
    from repro_torch.kernels.expmul.expmul import expmul_fwd, expmul_fwd_plain
    from repro_torch.numerics.log2exp import exact_expmul

    shapes = []
    for d, dtype in ((D, torch.float32), (D, torch.bfloat16),
                     (D + 1, torch.float32)):
        x, v = checks.expmul_case(rng, EXPMUL_ROWS, d, dtype=dtype)
        got, plain = expmul_fwd(x, v), expmul_fwd_plain(x, v)
        torch.cuda.synchronize()
        if not checks.same_bits(got, plain):
            raise AssertionError("expmul disagrees at the timing shapes")
        err = float((got.float() - plain.float()).abs().max())
        ms = median_ms(torch, lambda: expmul_fwd(x, v), flush)
        host_ms = median_ms(torch, lambda: expmul_fwd(x, v), flush,
                            hide_host=False)
        plain_ms = median_ms(torch, lambda: expmul_fwd_plain(x, v), flush)
        x2 = x[:, None]
        exact_ms = median_ms(torch, lambda: exact_expmul(x2, v), flush)
        nbytes = 4 * EXPMUL_ROWS + 2 * v.numel() * v.element_size()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        dt = str(dtype).split(".")[-1]
        shapes.append(dict(shape=[EXPMUL_ROWS, d], dtype=dt, max_abs_err=err,
                           ms=ms, ms_with_launch=host_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bytes=nbytes,
                           exact_expmul_ms=exact_ms))
        log(f"[time] expmul ({EXPMUL_ROWS}, {d}) {dt}: kernel {ms:.4f} ms on "
            f"the device ({nbytes / ms / 1e6:.0f} GB/s, "
            f"{bound_ms / ms:.1%} of the HBM bound), {host_ms:.4f} ms with "
            f"its launch, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"(bytes: {nbytes} B), max abs err {err:g}; yardstick "
            f"exact_expmul {exact_ms:.4f} ms")
        del x, v, got, plain
    first = shapes[0]
    return dict(max_abs_err=first["max_abs_err"], ms=first["ms"],
                ms_with_launch=first["ms_with_launch"],
                plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                bound_by="bytes", library_ms=None,
                yardstick={"what": "exact_expmul: torch.exp then a "
                           "broadcast multiply (the unfused baseline, not "
                           "the same function)",
                           "ms": first["exact_expmul_ms"]},
                shapes=shapes)


def _time_flash(torch, checks, F, flush, rng, h=H, hkv=HKV, d=D,
                plain_n=25):
    """The flash forward at the training shapes: 8 x 1024 tokens, ``h`` /
    ``hkv`` heads of ``d`` (14 / 2 of 64 by default), float32, causal,
    ExpMul, 512-wide tiles (the training path's min(512, S)); the library
    yardstick is SDPA on the same float32 q, k, v (the exact variant's
    function). The plain version's time is a median of ``plain_n``."""
    S, H, HKV, D = TRAIN_SEQ, h, hkv, d
    case = checks.flash_case(rng, B=B, H=H, Hkv=HKV, Sq=S, Sk=S, D=D,
                             dtype=torch.float32, dyadic=False, causal=True,
                             block_k=512, device="cuda")
    got = checks.run_flash(case, "expmul")
    ref = checks.run_flash(case, "expmul", plain=True)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = checks.rel_err(got, ref)
    if not rel <= checks.kernel_tol("expmul", torch.float32):
        raise AssertionError("flash disagrees at the training shapes")
    ms = median_ms(torch, lambda: checks.run_flash(case, "expmul"), flush)
    host_ms = median_ms(torch, lambda: checks.run_flash(case, "expmul"),
                        flush, hide_host=False)
    plain_ms = median_ms(torch, lambda: checks.run_flash(case, "expmul",
                                                         plain=True), flush,
                         n=plain_n, warmup=min(3, plain_n))
    exact_ms = median_ms(torch, lambda: checks.run_flash(case, "exact"),
                         flush)
    q, k, v = case["q"], case["k"], case["v"]
    sdpa_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), flush)
    # each input read once, the output written once; 4 * D operations per
    # causal (query, key) pair, at the card's peak for float32 inputs (TF32
    # tensor cores); the CUDA-core float32 rate the kernel runs at is a
    # yardstick only
    nbytes = 4 * (2 * B * H * S * D + 2 * B * HKV * S * D)
    flops = 4 * D * B * H * (S * (S + 1) // 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / TF32_FLOPS_PER_S
    f32_core_ms = flops / F32_FLOPS_PER_S * 1e3
    rate = flops / (ms * 1e-3)
    out = dict(max_abs_err=err, ms=ms, ms_with_launch=host_ms,
               plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=sdpa_ms, achieved_flop_per_s=rate,
               yardstick={"what": "exact variant vs SDPA, float32",
                          "kernel_ms": exact_ms, "library_ms": sdpa_ms,
                          "ops_ms_at_f32_cuda_core_rate": f32_core_ms})
    log(f"[time] flash (float32, ExpMul, B={B}, S={S}, {H} / {HKV} heads "
        f"of {D}, causal, 512-wide tiles): kernel {ms:.4f} ms on the "
        f"device, {host_ms:.4f} ms with its launch, plain {plain_ms:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}: {nbytes} B, {flops} "
        f"flop at the TF32 tensor-core rate; {f32_core_ms:.4f} ms at the "
        f"float32 CUDA-core rate, a yardstick), max abs err {err:.3e} (rel "
        f"{rel:.3e}); exact variant {exact_ms:.4f} ms, library SDPA "
        f"{sdpa_ms:.4f} ms")
    log(f"[time] flash achieved {rate / 1e12:.2f} TFLOP/s: "
        f"{rate / F32_FLOPS_PER_S:.1%} of the float32 CUDA-core rate "
        f"({F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s; {f32_core_ms:.4f} ms), "
        f"{out['bound_ms'] / ms:.2%} of the TF32 bound "
        f"({out['bound_ms']:.4f} ms)")
    return out


def phase_quickstart(torch, build):
    """``python -m repro_torch.launch.quickstart`` on the card, with the
    launch counts set to 0 just before and read just after: ExpMul and
    flash must have launched, and no plain version. Then its outputs: the
    operator's exact powers of two, and each flash output against the plain
    version on the same inputs."""
    from repro_torch.kernels.checks import kernel_tol, rel_err
    from repro_torch.kernels.flash.ops import flash_attention_fwd
    from repro_torch.launch import quickstart

    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    out = quickstart.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.COUNTS)
    log(f"[quickstart] {wall:.2f} s; launches {json.dumps(counts)}")
    if not (counts.get("expmul", 0) > 0 and counts.get("flash", 0) > 0):
        raise AssertionError(f"the quickstart missed a kernel: {counts}")
    if any(n for name, n in counts.items() if name not in ("expmul", "flash")):
        raise AssertionError(f"a plain version ran in the quickstart: "
                             f"{counts}")
    if out["expmul"][:, 0].tolist() != [0.75, 0.25, 0.0029296875]:
        raise AssertionError(f"ExpMul values {out['expmul'][:, 0]}")
    q, k, v = out["q"], out["k"], out["vv"]
    for name, variant, bk in (("o_exact", "exact", 128),
                              ("o_expmul", "expmul", 128),
                              ("o_api", "expmul", 256)):
        ref = flash_attention_fwd(q, k, v, causal=True, variant=variant,
                                  block_k=bk, plain=True)
        err = rel_err(out[name], ref)
        log(f"[quickstart] {name} against the plain version: rel err "
            f"{err:.3e}")
        if not (out[name].shape == (1, 4, 256, 64)
                and err <= kernel_tol(variant, torch.float32)):
            raise AssertionError(f"quickstart {name} disagrees")
    return counts


def phase_fidelity(torch, build):
    """``python -m repro_torch.launch.fidelity`` on the card (Table I:
    train table1-lm 200 steps, evaluate the grid), with the launch counts
    set to 0 just before and read just after: only the flash kernel may
    have launched, and every perplexity must be finite. The paper's claim
    (flat quality) is printed, not gated."""
    from repro_torch.launch import fidelity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    rows, attn_err = fidelity.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.COUNTS)
    log(f"[fidelity] {wall:.2f} s; launches {json.dumps(counts)}; rows "
        f"{json.dumps(rows)}; raw attention |err| mean {attn_err!r}")
    if set(counts) != {"flash"} or not counts["flash"] > 0:
        raise AssertionError(f"the fidelity study ran another kernel or a "
                             f"plain version: {counts}")
    if len(rows) != 4 or not all(np.isfinite(r["perplexity"]) for r in rows):
        raise AssertionError(f"the fidelity study's rows: {rows}")
    return counts


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of repro_torch on "
                                 "one card (every phase by default).")
    ap.add_argument("--phases", default="",
                    help="comma-separated phase names (as the [phase] lines "
                    "print them) to run alone, in their order: a quicker "
                    "partial run that prints no kernels line and no result")
    only = [p.strip() for p in ap.parse_args(argv).phases.split(",")
            if p.strip()]
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch import configs as cfg_mod
    from repro_torch.kernels import build, checks
    from repro_torch.kernels.expmul import ops as expmul_ops
    from repro_torch.kernels.decode import decode
    from repro_torch.kernels.flash import flash, prefill
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeEngine

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    phases = (
        ("build", lambda: phase_build(build)),
        ("kernel checks", lambda: phase_kernel_checks(torch, checks)),
        ("head dim checks", lambda: phase_head_dim_checks(torch, checks,
                                                          build, decode)),
        ("kimi checks", lambda: phase_kimi_checks(torch, checks, build,
                                                  decode)),
        ("mla checks", lambda: phase_mla_checks(torch, checks, build)),
        ("rg checks", lambda: phase_rg_checks(torch, checks)),
        ("moe routing", lambda: phase_moe_routing(torch)),
        ("expmul checks", lambda: phase_expmul_checks(torch, checks, build,
                                                      expmul_ops)),
        ("flash cross checks", lambda: phase_flash_cross_checks(torch,
                                                                checks)),
        ("flash head dim checks", lambda: phase_flash_head_dim_checks(
            torch, checks)),
        ("model ticks", lambda: phase_model_ticks(torch, cfg_mod, api)),
        ("gemma ticks", lambda: phase_gemma_ticks(torch, cfg_mod, api)),
        ("mla ticks", lambda: phase_mla_ticks(torch, cfg_mod, api)),
        ("rg ticks", lambda: phase_rg_ticks(torch, cfg_mod, api)),
        ("llava ticks", lambda: phase_llava_ticks(torch, cfg_mod, api, build)),
        ("serve", lambda: phase_serve(torch, cfg_mod, api, build,
                                      ServeEngine)),
        ("prefix", lambda: phase_prefix(torch, cfg_mod, api, build,
                                        ServeEngine)),
        ("faults", lambda: phase_faults(torch, cfg_mod, api, build,
                                        ServeEngine)),
        ("gemma serve", lambda: phase_gemma_serve(torch, cfg_mod, api, build,
                                                  ServeEngine)),
        ("mla serve", lambda: phase_gemma_serve(
            torch, cfg_mod, api, build, ServeEngine, arch=MLA,
            num_layers=MLA_LAYERS)),
        ("arctic", lambda: phase_moe(torch, cfg_mod, api, build,
                                     ServeEngine, ARCTIC, ARCTIC_LAYERS)),
        ("kimi", lambda: phase_moe(torch, cfg_mod, api, build, ServeEngine,
                                   KIMI, KIMI_LAYERS)),
        ("rg serve", lambda: phase_gemma_serve(
            torch, cfg_mod, api, build, ServeEngine, arch=RG,
            num_layers=RG_LAYERS)),
        ("rg windowed serve", lambda: phase_rg_windowed_serve(
            torch, cfg_mod, api, build, ServeEngine)),
        ("xlstm ticks", lambda: phase_xlstm_ticks(torch, cfg_mod, api,
                                                  ServeEngine)),
        ("xlstm serve", lambda: phase_xlstm_serve(torch, cfg_mod, api, build,
                                                  ServeEngine)),
        ("llava serve", lambda: phase_gemma_serve(
            torch, cfg_mod, api, build, ServeEngine, arch=LLAVA,
            num_layers=LLAVA_SERVE_LAYERS)),
        ("seamless", lambda: phase_seamless(torch, cfg_mod, api, build)),
        ("times", lambda: phase_times(torch, checks, F)),
        ("gemma times", lambda: phase_gemma_times(torch, checks, F)),
        ("mla times", lambda: phase_mla_times(torch, checks, F, build, decode,
                                              prefill)),
        ("arctic times", lambda: phase_arctic_times(torch, checks, F)),
        ("kimi times", lambda: phase_kimi_times(torch, checks, F)),
        ("rg times", lambda: phase_rg_times(torch, checks, F, decode,
                                            prefill)),
        ("frontend times", lambda: phase_frontend_times(
            torch, checks, F, build, flash, decode)),
        ("flash head dim times", lambda: phase_flash_head_dim_times(
            torch, checks, F)),
        ("resources", lambda: phase_resources(build, decode, prefill,
                                              flash)),
        ("train", lambda: phase_train(torch, cfg_mod, api, build)),
        ("gemma train", lambda: phase_train(
            torch, cfg_mod, api, build, arch=GEMMA,
            num_layers=GEMMA_TRAIN_LAYERS, steps=TRAIN_CUT_STEPS)),
        ("mla train", lambda: phase_train(
            torch, cfg_mod, api, build, arch=MLA, num_layers=MLA_TRAIN_LAYERS,
            steps=TRAIN_CUT_STEPS)),
        ("train archs", lambda: phase_train_archs(torch, cfg_mod, build)),
        ("plan", phase_plan),
        ("counted step", lambda: phase_counted_step(torch, cfg_mod, api,
                                                    build)),
        ("flash offset", lambda: phase_flash_offset(torch, checks, F)),
        ("mesh train", lambda: phase_mesh_train(torch, cfg_mod, build,
                                                results.get("train"))),
        ("quickstart", lambda: phase_quickstart(torch, build)),
        ("fidelity", lambda: phase_fidelity(torch, build)),
    )
    if only:
        unknown = set(only) - {name for name, _ in phases}
        if unknown:
            print(f"chip_smoke: no phase named {sorted(unknown)}",
                  file=sys.stderr)
            return 2
        phases = tuple((n, fn) for n, fn in phases if n in only)
    results = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        results[name] = fn()
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    if only:
        log(f"[total] {time.perf_counter() - t_start:.1f} s; a subset of the "
            f"phases ({', '.join(only)}): no kernels line, no result")
        return 0
    kernels = []
    launches = {**results["serve"], "flash": dict(results["train"]["flash"])}
    launches["flash"].update(
        launches_quickstart=results["quickstart"]["flash"],
        launches_fidelity=results["fidelity"]["flash"],
        launches_gemma_train=results["gemma train"]["flash"]["launches"],
        launches_mla_train=results["mla train"]["flash"]["launches"],
        launches_train_archs=results["train archs"],
        launches_counted_step=results["counted step"]["flash_launches"],
        launches_mesh_train=results["mesh train"]["flash"]["launches"])
    launches["expmul"] = dict(launches=results["quickstart"]["expmul"])
    # the serving kernels at gemma-7b's head dim: its serving run's
    # launches, its times, each KV dtype's resources
    for name in PAGED + CONTIGUOUS:
        results["resources"][name]["d256"].update(
            launches=results["gemma serve"][name],
            largest_group={kv: results["head dim checks"][GEMMA_D][
                f"{name} {kv}"] for kv in KV_MANGLED}
            if name.endswith("decode") else None,
            **results["gemma times"][name])
    # ... at arctic-480b's head dim 128 and kimi-k2-1t-a32b's 112: their
    # serving runs' launches, their times, each KV dtype's resources
    for key, arch, largest in (
            ("d128", "arctic", results["head dim checks"][ARCTIC_D]),
            ("d112", "kimi", results["kimi checks"])):
        for name in PAGED + CONTIGUOUS:
            results["resources"][name][key].update(
                launches=results[arch][name],
                largest_group={kv: largest[f"{name} {kv}"]
                               for kv in KV_MANGLED}
                if name.endswith("decode") else None,
                **results[f"{arch} times"][name])
    # ... at recurrentgemma-2b's local attention (group 10, head dim 256,
    # window 2048): its serving runs' launches (phase 4g), its times
    windowed = results["rg windowed serve"]
    for name in PAGED + CONTIGUOUS:
        layout = "paged/fp32" if name in PAGED else "contiguous/fp32"
        results["resources"][name]["rg_w2048"] = dict(
            launches=results["rg serve"][name],
            launches_windowed=windowed[layout]["launches"][name],
            **results["rg times"][name])
    # the contiguous kernels at minicpm3-4b's head dims 96/64: its serving
    # runs' launches (graphs, by layout), its times and resources
    for name in CONTIGUOUS:
        results["resources"][name]["mla_96_64"] = dict(
            launches=results["mla serve"][name], **results["mla times"][name])
    # llava-next-34b's serving runs (head dim 128, group 7, as arctic's
    # times), flash at this slice's new shapes (llava's frontend forward,
    # seamless-m4t-medium's encoder and cross-attention) and the contiguous
    # decode at seamless's self-attention (D 64, group 1)
    for name in PAGED + CONTIGUOUS:
        results["resources"][name]["llava_d128"] = dict(
            launches=results["llava serve"][name])
    sm, ft = results["seamless"], results["frontend times"]
    results["resources"]["flash"].update(
        llava_frontend=dict(**results["llava serve"]["frontend_forward"],
                            **ft["flash"]["llava_frontend"]),
        seamless_encoder=dict(launches_encode=sm["flash_encode"],
                              encode_ms=sm["encode_ms"],
                              **ft["flash"]["seamless_encoder"]),
        seamless_cross=dict(launches_forward=sm["flash_forward"],
                            **ft["flash"]["seamless_cross"]))
    results["resources"]["decode"]["seamless_d64_g1"] = dict(
        launches=sm["decode"], decode_step_p50_ms=sm["decode_step_p50_ms"],
        **ft["decode"])
    # flash at head dims 256, 112 and 96: its checks'
    # worst errors, times and resources, and the full-width training runs
    # at 256 (gemma-7b) and 96 (minicpm3-4b)
    worst = results["flash head dim checks"]
    for D, _, _ in FLASH_NEW_DIMS:
        key = f"d{D}"
        results["resources"]["flash"][key].update(
            worst_rel_err={k: v for k, v in worst.items()
                           if k.startswith(f"D {D} ")},
            **results["flash head dim times"][key])
    for key, phase in (("d256", "gemma train"), ("d96", "mla train")):
        results["resources"]["flash"][key]["training"] = {
            k: v for k, v in results[phase].items() if k != "flash"}
    # flash at a query offset (a rank's rows of a query-split call), and the
    # mesh launcher's steps through it
    results["resources"]["flash"]["q_offset"] = dict(
        **results["flash offset"], mesh_train={
            k: v for k, v in results["mesh train"].items() if k != "flash"})
    for name, (source, replaces) in KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, **launches[name],
                            **results["times"][name],
                            **results["resources"].get(name, {})))
    log(json.dumps({"kernels": kernels}))
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
