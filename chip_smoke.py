#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line is printed).
The ranks and the references "in a process of its own" of phases 8,
15-18, 20, 24, 25, 26 and 27 run in ``RankPool``'s four processes, kept from one
batch of ranks to the next within a stretch of phases, as do the ranks of
``train --ranks`` and ``train --pipeline --ranks``; ``serve --ranks``
spawns its own:

1. print the card's name and power limit (``nvidia-smi``), turn TF32 off,
   build the kernels from the sources in this checkout (one ``nvcc`` per
   CUDA C++ source, all started together: flash attention with ring
   attention's panel visit, the SSD scan, and RMSNorm forward and
   backward) and print the build seconds; print each CUDA kernel's
   registers and spill bytes (``-Xptxas -v``) and its HGMMA
   (``wgmma``) and HMMA (``mma.sync``) counts (``cuobjdump -sass``), and
   fail unless the six bf16 flash instantiations (both entries, dh 64, 112
   and 128) contain HGMMA, the product kernels of the bf16 SSD forward
   (``ssd_fwd_chunk_state_kernel``, ``ssd_fwd_chunk_scan_kernel``) and
   backward (``ssd_bwd_chunk_state_kernel``, ``ssd_bwd_chunk_grad_kernel``)
   contain HMMA, and the three ``ssd_fwd_`` and three ``ssd_bwd_`` kernels
   of the bf16 forward and backward spill nothing; print the CTAs per SM
   those six kernels reach; fail if an RMSNorm kernel is missing or
   spills, and print the RMSNorm backward's warps a CTA and CTAs per SM at
   the training widths, and the registers of the cta bodies (a row across
   a CTA, past d 2560) with their warps a CTA and CTAs per SM, forward and
   backward, bf16 and fp32, at d 4096-8192 (fail if either does not take
   those widths); a fourth ``nvcc`` builds the SSD scan without the bf16
   backward's dB/dC stores, which phase 7 times; print the flash
   backward's kernels (``flash_bwd_``: D, dK/dV and dQ, fp32 and bf16, dh
   64, 112 and 128) with their registers, spills and HGMMA count, fail if
   one is missing or a bf16 product kernel (``_wgmma_kernel``) has no HGMMA
   or spills, print those six kernels' CTAs per SM and any wgmma that
   ptxas serialised;
2. hold each kernel against its plain PyTorch version on the card at the
   serving and training paths' shapes (the flash forward also at the dense
   engine's decode: S 1, non-causal, kv_len from 1 to T, and at zamba2's
   shared block, H = KV = 32, dh 64: that decode at T 2048 and the causal
   prefill of 2 x 2048; the SSD scan also at zamba2's H 64, P 64, N 64;
   RMSNorm also at phase 12's decode rows, 8 x 1024, 2048 and 4096), with
   the stated tolerances (the
   backward kernels against ``torch.autograd`` of the plain versions; the
   fp32 SSD cases against the plain version in float64, beside the fp32
   plain version's own distance from it; ring attention's panel visit at
   qwen3-4b width with 8192 local queries and keys, for panels behind, on,
   ahead of and far from the q shard; both attention entries also at small
   sizes with GQA groups of 1, 5 and 8 and with dh 64); and log why the
   bf16 panel visit splits P into two bf16 terms: the plain arithmetic's
   acc error at the visible visit with P rounded to bf16 and with P split;
   RMSNorm also on a bf16 view at storage offset 1 (the kernels' unaligned
   body; also at d 6144), with w in fp32 beside bf16 x (d 6144), at odd d
   (3001), at d 12288 (the cta bodies' shared memory past 48 KB) and past
   the cta bodies (bf16 16392, fp32 8200: the looped kernels), both ways,
   its backward also at qwen2-72b's 4096 x 8192, and twice at 16384 x 2048,
   where dw must be the same bits both times, as must the SSD backward's gradients at the training
   shape, and at the QK-norm rows of the dense training shape (d
   128, 65536 and 262144 rows); the flash backward against its plain
   version and against ``torch.autograd`` of the plain forward, with the
   forward's row log-sum-exp against its plain version, at S = 100 (GQA
   groups of 1, 5 and 8, dh 64 and 128, causal or not, window 8 or none,
   fp32 and bf16) and at the dense training shape (B 2, S 4096, H 32, KV 8,
   dh 128, bf16, causal), run twice there: the same bits both times; and
   log why the bf16 backward rounds P and dS to bf16 for dV, dK and dQ:
   the plain backward's error at that shape with P and dS rounded and with
   them split into bf16 hi + lo, the rounding held within half the bf16
   tolerance; the flash kernels at whisper-medium's heads (H = KV = 16, dh
   64, 8 lanes): the encoder's non-causal S = T = 1500, cross-attention's
   32 and 1 queries over 1500 rows, the decoder's causal prefill of 32 and
   its decode over 448 slots; and (``phase_k13``) the flash kernels at
   kimi-k2-1t-a32b's heads (H 64, KV 8, dh 112, run in tiles padded to
   128 columns), bf16 and fp32 at the same gates: the forward at phase
   21's paged decode and prefill chunk, the dense engine's decode and a
   causal prefill of 2 x 256, the backward's S = 100 cases, the causal
   training shape (B 1, S 4096) for the forward with its row log-sum-exp
   and the backward (a second call the same bits), and the panel visit;
   and (``phase_k14``) the flash backward at S != T (K14: cross-attention,
   no mask) in bf16 and fp32 at ``REL_TOL``, against its plain version and
   ``torch.autograd`` of the plain forward: whisper-medium's cross shape
   (B 8, S 448 decoder tokens over T 1500 encoder frames, H = KV = 16, dh
   64; a second call the same bits), dh 112 and 128 with a GQA group of 4
   over the same 1500 keys, and S 200 over T 37; a causal mask at S != T
   must be refused; then the S == T backward and the forward with its row
   log-sum-exp at whisper-medium's training shapes (the encoder's
   non-causal S = T = 1500 and the decoder's causal S = T = 448, B 8, H =
   KV = 16, dh 64), bf16 and fp32 at the same gates, a second call the
   same bits;
3. serve full-width qwen3-4b (random bf16 weights from seed 0) through the
   paged continuous-batching engine: 12 requests, prompts of 33-400
   tokens, 16-32 new tokens each; every request must complete and both
   kernels must have launched on this path;
4. serve a reduced fp32 qwen3-4b on the card and on the CPU: the greedy
   tokens must be identical;
5. train full-width mamba2-370m (random bf16 weights from seed 0) through
   ``repro_torch.launch.train`` for 6 steps of 8 x 2048 synthetic tokens:
   finite losses, lower at the end, and the SSD scan and RMSNorm kernels,
   forward and backward, launched on this path; then time and profile the
   training step, with the device ms of each ``ssd_fwd_`` and ``ssd_bwd_``
   kernel, all six of which must show device time (the prefixes sort the
   SSD scan's time into forward and backward);
6. train a reduced fp32 mamba2-370m for three steps on the card and on the
   CPU: the losses must agree;
7. time each kernel, its plain version and the PyTorch library call for
   the same function at the paths' shapes (device time with the launches
   queued behind a spin kernel, and the time per call of back-to-back
   launches from Python), the bf16 SSD forward's and backward's three
   kernels apart (profiler; the forward must launch its three ``ssd_fwd_``
   kernels and no ``ssd_bwd_`` kernel) and the backward's chunk-grad
   kernel without its dB/dC stores, the flash backward's three kernels
   (``flash_bwd_delta``, ``flash_bwd_dkdv``, ``flash_bwd_dq``) apart at the
   dense training shape (profiler; each must show device time),
   with the least time the card could take (bytes over 3.35 TB/s or
   operations over the peak rate of the inputs' type), and the achieved
   TFLOP/s of the attention kernels and SDPA; and what one RMSNorm call at
   the decode shape costs the host, by piece, beside the device time of an
   empty kernel;
8. sequence-parallel attention at full qwen3-4b width: 4 ranks on the
   one card, joined by a gloo process group, each holding 8192 tokens of
   a 32768-token input,
   run one attention layer (random bf16 weights from seed 0, QK-norm) with
   ``impl="ring"``; the gathered output must lie within 2 bf16 ulps of the
   largest magnitude of single-process ``impl="flash"`` on the whole
   sequence, and the ring kernel must have launched 4 times on every rank.
   Each rank also times its 4 panel visits with CUDA events around each
   round's launch, apart from the rest of the call.  The 4 ranks share the
   card, so their kernels take turns on it;
9. train full-width qwen3-4b (random bf16 weights from seed 0, depth cut
   to ``DENSE_LAYERS`` of 36 layers so that the fp32 AdamW state fits the
   card) with remat on every layer through ``make_train_step`` for 6 steps
   of 2 x 4096 synthetic tokens: finite losses, lower at the end, the flash
   backward launched once a layer a step beside the flash forward (twice a
   layer: remat recomputes it) and RMSNorm both ways, and no plain version
   called; the step's ms, tokens/s, peak memory, model-FLOP share and
   device ms by kernel category (flash forward and backward apart); then
   two steps at 4 layers with and without remat, whose losses must agree
   and whose peaks are printed; and, as a witness for phase 9's lr, four
   steps at 4 layers and lr 3e-4 from the same weights through the flash
   kernels and through the plain attention autodiffed by torch (a
   check-only substitute; the losses are printed side by side);
10. train a reduced fp32 qwen3-4b for three steps through
   ``repro_torch.launch.train`` on the card and on the CPU, from the same
   weights: the losses must agree (the card runs the fp32 flash forward and
   the backward kernels, the CPU the plain attention);
11. the dense-cache engine (``repro_torch.launch.serve.serve``) at
   full-width qwen3-4b (random weights from seed 0; (a) and (b) at
   ``DENSE_SERVE_LAYERS``, 6 of 36 layers, for the script's time): (a)
   ``make_serve_step`` logits at every position of 2 lanes of 256 random
   tokens against ``make_prefill_step`` logits on the same tokens, in bf16
   within ``DECODE_VS_PREFILL_TOL`` of the largest logit, after the same
   comparison in fp32 over 64 tokens within 1e-4; (b) ``serve`` on 8 lanes
   of a 2048-token cache for 16 requests (prompts of 16-128 tokens, 32 new
   tokens each; more requests than lanes, so slots are recycled): every
   request completes, no plain version is called, the flash forward
   launches once a layer a step; one decode step at mixed positions is
   timed and profiled, and each of its flash launches (one a layer) must
   read its layer's cache in place, non-causal with a kv_len; then one
   request of 2040 + 32 tokens on one lane of the 2048-token cache, which
   wraps, on the model's first ``WRAP_LAYERS`` (4) layers;
   printed: step wall ms, device busy ms, kernels and flash launches a
   step, plain calls, tok/s, KV-cache bytes and peak memory; (c) reduced
   fp32 qwen3-4b through ``serve`` on the card and on the CPU from the same
   weights, one request wrapping the cache: identical greedy tokens; (d)
   the flash forward at the decode shape (B 8, S 1, T 2048, non-causal,
   mixed kv_len) beside its bound, its plain version and SDPA with the
   equivalent boolean mask; (e) ``make_prefill_step`` on full-width
   mamba2-370m (2 x 2048 tokens, bf16), which must launch the SSD forward
   once a layer and no backward, and on reduced fp32 mamba2-370m on the
   card against the CPU within 1e-4 of the largest logit;
12. SSM and hybrid serving at full width (random weights from seed 0, 8
   lanes) for mamba2-370m and zamba2-1.2b, depth cut to
   ``SSM_SERVE_LAYERS`` (6 of 48 and 12 of 38 layers, 2 calls of
   zamba2's shared attention block a token) for the script's time: (a)
   in fp32, then bf16, each mixer's decode against its prefill on the
   same input (the hidden state the prefill hands that layer, 2 lanes of
   ``LAYERWISE_T`` tokens) within
   ``REL_TOL`` of its dtype, and the logits of ``make_serve_step`` against
   ``make_prefill_step`` at every position as in phase 11 (a), gated in
   fp32 at ``SSM_LOGITS_FP32_TOL`` and printed in bf16 (the distance
   compounds with depth, in the reference too); (b) ``serve`` of 16
   requests (prompts of 16-128 tokens, 32 new tokens, zamba2's K/V caches
   of 2048 tokens; lanes recycled): every request completes, no plain
   version is called, no SSD scan is launched, the flash forward launches
   once a shared-block call a step, reading its cache in place; printed:
   tok/s, the decode step's wall and device-busy ms, kernels and flash
   launches a step, peak memory beside the SSM state's, conv history's and
   K/V caches' bytes; (c) reduced fp32 ``serve`` on the card and on the CPU
   from the same weights with recycled lanes: identical greedy tokens; (d)
   ``make_prefill_step`` on full-width zamba2-1.2b (2 x 2048 tokens, bf16),
   which must launch the SSD forward once a layer and the flash forward
   once a shared-block call, and reduced fp32 zamba2 on the card against
   the CPU within 1e-4 of the largest logit;
13. the paper's plan search driving the card: (a) the port's Galvatron-BMW
   search (NumPy, on the host; ``launch/train.py::search_plan``, the train
   driver's ``bmw`` settings with batch grid [2]) for phase 9's model
   (qwen3-4b at ``DENSE_LAYERS``, 2 x 4096 tokens) on one card of the
   ``8x-h100-sxm-nvlink`` preset; the plan must certify
   (``launch/search.py::certify_plans``: the plan linter and the schedule
   certifier); its summary and the cost model's ``est_iter_time`` and
   ``est_stage_mem`` are printed; (b) ``repro_torch.launch.train.main``
   with ``--plan`` for 3 steps at phase 9's lr: the remat it takes must be
   the plan's, as the JAX driver takes it (``strategies[0].ckpt``: on),
   its losses must be phase 9's first three bit for bit, no plain version
   may run, and the flash forward and backward and RMSNorm must launch as
   in phase 9; the step ms and peak memory are printed beside the
   estimates; (c) ``repro_torch.launch.search.main`` with ``--slo-sweep
   30 --max-context 2048`` for qwen3-4b on the same card writes a v3
   serving plan, and ``repro_torch.launch.serve.main`` with ``--plan``
   serves 8 requests of 16 new tokens at full width with ``--batch 8``:
   the engine's geometry must be the plan's with that override, its K/V
   pool the plan's ``kv_pool_pages`` on the card beside the weights, every
   request must complete, no plain version may run, and the flash forward
   and RMSNorm must launch; the measured per-token latency is printed
   beside the cost model's ``est_tok_ms``.  A plan that fails the lint,
   an out-of-memory error or a kernel that does not launch fails the
   phase.  (a') Between (a) and (b), per-layer times are profiled on the
   card (``core/profiler.py::profile_layerspecs``: the reference's fp32
   matmul chain of each layer's FLOPs, CUDA events, no rescale) and the
   same search is priced with them; the profiled plan must certify, and
   its ``est_iter_time`` is printed beside the analytic one and the
   measured step, with no limit on the ratios;
14. checkpoints: phase 5's run through ``train --ckpt-dir --ckpt-every 2``
   for 2 steps (``launch/train.py`` saves ``step_00000002`` in the JAX
   package's layout), a freshly built model and AdamW state (seed 1)
   restored from it on the card, then 2 more steps on the next batches:
   the four losses must be phase 5's first four bit for bit, the SSD scan
   and RMSNorm must launch both ways and no plain version run; the
   checkpoint's bytes on disk and the save and restore seconds are
   printed, and the directory is deleted;
15. the pipeline runtime at full qwen3-4b width, depth cut to 8 layers:
   (a) in a process of its own, the single-process ``lm_loss`` and its
   gradients (remat on every layer) on ``init_lm`` seed 0 and the train
   driver's first batch of 4 x 4096 tokens; (b) 4 gloo ranks sharing the
   card, each drawing its stage (``init_stage``), run gpipe, 1f1b, zb-h1
   (P 4) and 1f1b-interleaved (P 4, V 2) on that batch as 4 micro-batches:
   each loss within 2e-3 relative of (a)'s, each gradient leaf within 2e-2
   of (a)'s leaf's largest magnitude, gpipe's, 1f1b's and zb-h1's losses
   and gradients the same bits, the kernels launched as many times as the
   schedule's ticks ask and no plain version run; each rank's ticks worked
   and idle, busy and receive-wait ms and peak memory are printed; (c) the
   port's search (``search --devices 4 --max-pp 4 --batch-grid 16``) gives
   a pp 4 plan, and ``train --pipeline --ranks 4`` trains 2 steps with it
   (zb-h1, P 4, m 4, AdamW on each rank's leaves with the global grad
   norm): its first loss must be (b)'s for that schedule, bit for bit; its
   step ms and each rank's peak are printed.  The 4 ranks share one card,
   so their times are not a pipeline's speed;
16. the sharded executor at full qwen3-4b width, depth cut to 4 layers:
   (a) in a process of its own, the single-process ``lm_loss`` and its
   gradients (remat on every layer) on ``init_lm`` seed 0 and the train
   CLI's first batch of 4 x 4096 tokens, then 1 ``make_train_step``
   step at phase 9's lr (3 before phase 24 came, 2 before phase 25); (b) 4 gloo ranks
   sharing the card on a (data 2, model 2) ``make_local_mesh`` with
   ``ShardPolicy(tp=True, zero=True, remat_segments=(True,))``, each
   drawing its shards (``init_train_state(mesh=)``): the sharded loss
   within 2e-3 relative of
   (a)'s and each gathered gradient leaf within 2e-2 of (a)'s leaf's
   largest magnitude, with ``seq_shard`` off and on (on: the same bits as
   off, or within those gates, which the line says), then 1 sharded step
   whose losses are printed beside (a)'s and must be finite; the flash
   forward (2L), backward (L) and RMSNorm (8L+1, 4L+1) launched at exact
   counts a rank a call and a step, no plain version run; each rank's call
   and step ms, bytes sent through gloo and peak memory are printed; (c)
   the port's search for 4 cards of the H100 node at this model (a budget
   of 9 GB a card, batch grid [4]) and ``train --ranks 4 --plan``, 1
   step on ``make_local_mesh()`` (data 4, model 1): the policy it prints
   must be the plan's middle strategy's, its first loss within 2e-3
   relative of (a)'s, the kernels launched at their counts.  The 4 ranks
   share one card: no time there is sharded training's speed;
17. tensor parallelism for Mamba2 and the zamba2 hybrid, and sharded
   checkpoints, on 4 gloo ranks sharing the card on a (data 2, model 2)
   mesh with ``ShardPolicy(tp=True, zero=True, remat_segments=(True,))``:
   (a) full-width mamba2-370m, depth cut from 48 to
   ``SSMTP_MAMBA2_LAYERS`` (1) for the script's time: a
   spawned single process saves
   its ``lm_loss`` and gradients (remat on every layer) in fp32, and in
   bf16 its loss and 3 step losses, on the train driver's first batches of
   4 x 2048 tokens at lr 3e-4; the ranks hold their fp32 loss within 2e-3
   relative and each gathered fp32 gradient leaf within 2e-2 of its
   largest magnitude (phase 16's gates), then in bf16 their loss within
   2e-3 with ``seq_shard`` off and on (on: the same bits, or the loss
   within the gate, which the line says), then take 3 bf16 steps, saving
   the whole state after step 2 with ``save_sharded_train_state``.  The
   gradients are held in fp32 because in bf16 the 48-layer stack's
   gradients were chaotic in the rounding: the bf16 single process and the
   bf16 ranks, whose losses agreed to 5e-6, differed by 1.3 to 2.7 of each
   SSM leaf's largest magnitude, while in fp32 they agreed within 7.5e-3
   (NVIDIA H100 80GB HBM3, 700 W).  The SSD scan (forward 2L at 16 local
   heads, backward L) and RMSNorm (4L+1, 2L+1) are launched at exact
   counts a rank a call and a step, no plain version run; (c) 4 fresh
   ranks drawn from seed 1 restore into their shards
   (``restore_sharded_train_state``) and take step 3, whose loss must be
   (a)'s unbroken step 3 bit for bit; ``train --ranks 4 --plan
   --ckpt-dir --ckpt-every 2 --steps 2`` on the port's search for 4 cards
   at mamba2-370m writes step 2's checkpoint; one process restores
   (a)'s files with ``restore_train_state`` and takes step 3 (within 2e-3
   relative of the ranks'), then restores ``train --ranks``' files; the
   files (2.9 GB each at 24 layers) are deleted; (b) zamba2-1.2b at full width, depth
   cut from 38 to 6 layers (one shared attention call) and its steps to 1
   for the script's time, as (a) without saving: the flash forward and
   backward at 16 local heads and dh 64, the SSD scan at 32.  Each rank's
   call and step ms, gloo bytes sent and peak memory, and the save and
   restore seconds and bytes are printed.

18. sharded serving on 4 gloo ranks sharing the card on a (data 2, model
   2) ``make_local_mesh`` with ``ShardPolicy(tp=True, zero=False)``,
   each rank holding its shards (``init_serving_params``), against a
   spawned single process on the same weights (``init_lm`` seed 0): (a)
   the paged engine at full-width qwen3-4b, ``SS_BF16_LAYERS`` (4 of 36
   layers), bf16, on phase 3's
   geometry (the pools hold 4 of 8 KV heads a rank): the first prefill
   chunk's and a decode step's logits within ``SS_LOGIT_TOL`` of the
   largest, the flash forward launched at 16 query and 4 KV heads and
   RMSNorm as often as in the single process; phase 3's 12 requests, the
   last four arriving ``SS_ARRIVAL_S`` late (admission reads rank 0's
   clock), complete on every rank with the same tokens and the same page
   table at the end; in fp32 at ``SS_FP32_LAYERS`` layers the tokens are
   the single process's; (b) the dense-cache step on 8 lanes of 2048-token
   caches (lanes over ``data``, context over ``model``: each flash launch
   reads its rank's 1024 slots with a local kv_len and writes its row
   log-sum-exp, the parts merged over ``model``; SSM heads over
   ``model``) from the preset positions ``SS_INDEX`` (lane 0 starts at 0,
   wholly in model rank 0's slots; three lanes wrap), ``SS_STEPS`` steps:
   qwen3-4b (and once more with ``shard_cache_seq=False``, KV heads over
   ``model``), mamba2-370m and zamba2-1.2b (the shared block's caches
   split by context) in bf16 at ``SS_BF16_LAYERS`` (4 of 36, 4 of 48,
   12 of 38 layers, cut for the script's time), each at
   ``SS_FP32_LAYERS`` (zamba2 ``SS_ZAMBA2_FP32_LAYERS``) in fp32, where
   the logits must lie within ``REL_TOL`` and the greedy tokens and
   ``serve`` of ``SS_DENSE_REQUESTS`` requests must be the single
   process's; the sharded ``make_prefill_step`` on mamba2 and zamba2 (the
   SSD forward once a layer at 16 and 32 local heads, each rank its block
   of the logits); (c) ``serve --ranks 4`` (``launch/serve.py::
   serve_ranks``: data 4, model 1, the reference's serving policy) for
   both engines in fp32 at ``SS_FP32_LAYERS`` layers: the single
   process's tokens.  No plain version may run anywhere.  Each rank's
   decode step wall and busy ms, the bytes it sends through gloo, its
   peak memory beside its pools' or caches' bytes, and tok/s are printed.
   The 4 ranks share one card: no time here is sharded serving's speed.
19. mixture-of-experts: arctic-480b at full width (d 7168, 56 query and 8
   KV heads, 128 experts of d_ff 4864, top-2, a dense residual branch;
   random bf16 weights from seed 0, each expert drawn apart), depth cut
   from 35 to ``MOE_LAYERS`` (2: 55.4 GB), in this process right after
   phase 3: (a) the paged engine on phase 3's geometry and requests, twice:
   every request completes, the flash forward and RMSNorm launch as many
   times as the decode steps and prefill chunks ask, no plain version
   runs, and the second run gives the same tokens and the same bits of the
   first decode step's logits; a decode step's wall and busy ms, device ms
   by category and kernels are printed beside its bound (every weight read
   once), with tok/s and peak memory; (b) the dense-cache engine:
   ``make_serve_step`` against ``make_prefill_step`` on 2 lanes of 256
   tokens at the check-only capacity where nothing drops
   (``capacity_factor`` E / top_k), gated at ``MOE_DECODE_VS_PREFILL_TOL``
   on the positions whose top-k experts agree at every layer (the
   routings that differ are counted), the pairs the prefill drops at the
   config's capacity factor printed, then in fp32 at ``MOE_FP32_LAYERS``
   layer after the bf16 model is freed (64 tokens, ``REL_TOL``), and
   ``serve`` of ``MOE_DENSE_REQUESTS`` requests on 8 lanes of 2048 tokens:
   every one completes, the flash forward once a layer a step; (c) one
   full-width MoE layer on a prefill chunk (4 x 128) and a decode batch (8
   x 1): the sort, einsum and grouped dispatches within
   ``MOE_DISPATCH_TOL`` of the largest output, the same kept (row, token,
   expert) pairs, sort's and einsum's aux equal; (d) reduced fp32
   arctic-480b and kimi-k2-1t-a32b (16 experts: top-8, a shared expert, a
   dense first layer) on the card and the CPU from the same weights: the
   paged engine's and ``serve``'s greedy tokens identical, 3 steps of
   ``launch/train.py`` within ``TRAIN_LOSS_RTOL``.  Phase 19 keeps the
   first decode step of (a)'s first run and of (b)'s ``serve`` (logits,
   input tokens, each layer's top-2 experts) for phase 20.
20. MoE sharded, right after phase 19: 4 gloo ranks share the card. (a)
   phase 19's model under TP on a (data 1, model 4) mesh (a rank: 32 of
   128 experts a layer, 14 of 56 query and 2 of 8 KV heads, a quarter of
   the residual branch and of the vocabulary), phase 3's requests through
   the paged engine twice: every request completes, the same tokens and
   first-step logits (bits) on every rank and in both runs, flash once a
   layer a decode step or prefill chunk on the local heads, no plain
   version; the first decode step against phase 19's within
   ``MOE_SHARD_LOGIT_TOL`` on the lanes whose input token and top-2
   experts at every layer agree (the others counted); each rank's decode
   step wall and busy ms, gloo bytes and peak memory, and tok/s. (b) the
   same model under EP on a (data 1, expert 4) mesh (a rank: 32 experts a
   layer, the rest whole), ``serve`` of phase 19 (b)'s requests on 8 lanes
   of 2048 tokens, two a rank: the same logit gate on the first step,
   each rank's all-to-all bytes a step, step wall and busy ms, peak
   memory. (c) reduced fp32 and bf16 arctic-480b and kimi-k2 on the card
   under TP with ZeRO on (data 2, model 2) and EP on (data 1, expert 4):
   the loss and every gathered gradient leaf of one batch against one
   process on the card (bf16: phase 16's loss gate, and its leaf gate
   under EP; TP's bf16 leaves printed beside the single process's own
   bf16-against-fp32 distance) and on the CPU (fp32: 1e-5 for the loss and
   every leaf), the router's leaf printed apart.  ``--phases 20`` runs phase 19
   too.
21. kimi-k2-1t-a32b at full width (d 7168, 64 query and 8 KV heads of dh
   112, 384 experts of d_ff 2048, top-8, a shared expert), depth cut from
   61 to ``KIMI_LAYERS`` (2: the dense first layer and one MoE layer,
   about 39 GB, reckoned from the shapes and printed before the draw),
   bf16, random weights from seed 0: (a) phase 19 (a)'s paged run on
   phase 3's requests, twice, the flash forward at dh 112 once a layer a
   decode step and a prefill chunk, the decode step against its bound;
   (b) phase 19 (b)'s decode against prefill at
   ``MOE_DECODE_VS_PREFILL_TOL`` where the routing agrees, the flips
   counted.  ``--phases 21`` runs phase 2's dh 112 checks first.
22. whisper-medium's encoder-decoder serving path at full width (24 + 24
   layers, bf16, random weights from seed 0; ``models/encdec.py``), 8 lanes
   of random frames (8, 1500, 1024): ``init_encdec_decode_state`` (448
   slots) and 32 greedy steps of ``make_serve_step``, each step's logits
   against ``make_prefill_step`` teacher-forced on the same tokens within
   ``DECODE_VS_PREFILL_TOL`` of the largest logit; the flash forward the
   only attention (24 launches an encoder pass, 48 a decoder step: self
   plus cross at S != T), no plain version; a second decode the same bits;
   the same in fp32 at 4 + 4 layers within ``REL_TOL``; the encoder's ms,
   the decode step's wall and busy ms, tok/s, peak memory and the cross
   K/V bytes are printed.
23. whisper-medium training at full width (24 encoder layers, the
   decoder cut to 12 of 24 for the script's time, bf16, random weights
   from seed 0): (a) ``repro_torch.launch.train --arch whisper-medium
   --layers 12 --batch 8 --seq 448`` for 3 steps on the synthetic
   stream's frames (8, 1500, 1024), with the searched plan's remat and
   ``--ckpt-dir --ckpt-every 2``: finite losses; each step the flash
   backward 48 times (24 encoder, 12 decoder and 12 cross-attention
   layers), 12 of them at S != T (K14), the forward once an attention
   (twice under remat), no RMSNorm and no plain version; (d) a model and
   AdamW state drawn from seed 1, restored from step 2's checkpoint, take
   step 3: its loss must be (a)'s bit for bit (the files are deleted);
   two more steps are timed and one profiled (the busy share of their
   wall time); (b) step 1's loss and every gradient twice
   from ``init_encdec`` seed 0 on (a)'s first batch: the same bits, the
   loss (a)'s; (c) reduced fp32 whisper through ``launch/train.py::train``
   on the card and on the CPU from the same weights, 3 steps of 2 x 100
   tokens over 32 frames: losses within ``TRAIN_LOSS_RTOL``, the card's
   flash backward once an attention, a third at S != T.  Printed: the
   step's wall ms, decoder tokens/s, the device's busy share and ms by
   category (gemm, flash forward and backward, elementwise), peak memory,
   the checkpoint's bytes and save and restore seconds.  ``--phases 23``
   runs phase 2's K14 checks first.
24. sharded whisper-medium: full width, depth cut to 2 + 2 layers, bf16,
   random weights from seed 0, 4 gloo ranks sharing the card, against
   the single process in this process: (a) training on (data 2, model 2)
   with TP, ZeRO, remat and ``seq_shard`` and on (4, 1) with ZeRO, 8 x 448
   decoder tokens over 8 x 1500 frames: one sharded loss and gradients
   (the bf16 loss within ``SHARD_LOSS_RTOL``; the ranks' worst bf16 leaf
   within ``WSHARD_BF16_VS_FP32`` times the single process's own worst
   distance from the same weights' fp32 gradients; the same shards in
   fp32, every gathered leaf within ``REL_TOL`` of the single process's
   fp32 gradients), two AdamW steps; each rank's step ms, gloo bytes and
   peak; the flash launches a call, K14's at the TP-local shape (B 4, S
   448, T 1500, H 8, dh 64); (b) a sharded checkpoint after step 1,
   restored into a fresh draw, repeats step 2 bit for bit; (c) serving on
   (2, 2) without and with TP: ``init_encdec_decode_state`` of 8 lanes of
   1500 frames and 16 greedy ``make_serve_step`` steps on a 448-slot
   cache, the first step within phase 18's bf16 gate of the single
   process's, decode within phase 22's gate of the sharded teacher-forced
   ``make_prefill_step``, the same logits and tokens on every rank; each
   rank's step ms wall, gloo bytes a step and cross-K/V bytes; (d) reduced
   fp32 (2 + 2 layers, a vocabulary of 1001): the sharded loss within
   1e-5 and the decode logits within 1e-4 of the single process's, with
   its tokens.  Phase 2 holds the flash kernels at phase 24's rank-local
   shapes first: the forward (the encoder, cross-attention in training,
   prefill and decode, the causal self-attention; the serving decode over
   a rank's half of the self cache with its row log-sum-exp), K14 and
   the S == T backward at a TP rank's heads, in bf16 and fp32, each
   against its plain version and a second call the same bits.
25. internvl2-26b, the vision-language model (d 6144, 48 query heads over
   8 KV heads of dh 128, a GQA group of 6, d_ff 16384, an untied head over
   92553 tokens, 256 vision patches of d_vision 3200 through the 2-layer
   projector), bf16, random weights from seed 0: (a) at full depth (48
   layers, 39.84 GB) phase 3's 12 requests through the paged engine
   twice, text only as the reference serves a VLM (the same tokens and
   first-step bits, flash once a layer a decode step and a prefill
   chunk, a decode step's wall and busy ms beside its bound, tok/s, TTFT
   p50), ``make_prefill_step`` on 8 lanes of 256 random patches and 128
   tokens (logits (8, 128, 92553), a second call the same bits, other
   logits than without the patches), decode against prefill over 64
   tokens at phase 11's gate; (b) ``repro_torch.launch.train --arch
   internvl2-26b --layers 6 --batch 1 --seq 4096`` (4352 positions) for 3
   steps with the plan's remat: finite losses, the kernels' launches a
   step exact, no plain version, the step's wall ms, peak, the busy share
   and device ms by category of a profiled step, and step 1's loss and
   gradients twice the same bits; (c) 4 gloo ranks sharing the card at 1
   layer on (data 2, model 2) with TP, ZeRO-3 and remat, one step of
   ``make_train_step(mesh=, policy=)`` on 4 lanes of 256 + 1024: the loss
   within ``SHARD_LOSS_RTOL`` of the single process's, the ranks' worst
   bf16 gradient leaf within ``WSHARD_BF16_VS_FP32`` times the single
   process's own distance from fp32, the 92553-row head and table whole on
   every model rank, a rank's gloo bytes a step and peak; (d) reduced fp32
   (d 384, d_vision 192, 6 query heads over 1 KV head), card against CPU
   within ``REL_TOL``: loss, logits and every gradient, the projector's
   among them.  Phase 2 first holds the flash forward with its row
   log-sum-exp and the backward at (B 1, S 4352, H 48, KV 8, dh 128,
   causal), the forward at the paged decode and prefill at H 48 / KV 8,
   and RMSNorm at 8 x 6144 and 4352 x 6144 (its backward at 4352 x 6144),
   in bf16 and fp32, each against its plain version and a second call the
   same bits (``--phases 25`` runs these first); phase 7 times them.
26. the Qwen2/Qwen3 dense family (dh 128, 8 KV heads; untied heads over
   151936 or 152064 tokens), bf16, random weights from seed 0 with the
   QKV biases of qwen2.5-14b and qwen2-72b drawn after from a seeded
   normal of std 0.5 (the init's zeros would hide the add): the memory
   reckoned from the shapes and printed beside the card's free memory
   before each draw; (a) qwen3-8b (32 query heads, the QK-norm) at full
   depth, 36 layers, 16.38 GB, and (b) qwen2.5-14b (40 query heads: a GQA
   group of 5) at full depth, 48 layers, 29.54 GB, each with phase 3's 12
   requests through the paged engine twice (every request complete,
   flash and RMSNorm at the counted launches, no plain version, the same
   tokens and first-step bits, a decode step's wall and busy ms beside its
   bound: every weight read once); (b) also 10 requests through the
   dense-cache engine on 8 lanes of 2048, decode against the
   teacher-forced prefill over 64 tokens at phase 11's gate, and the
   prefill's logits with the biases zeroed more than that gate from the
   biased ones; (c) qwen2-72b (64 query heads, a group of 8) at full width
   and 40 of 80 layers (75.2 GB; 80 are 145.4), paged; (d)
   ``repro_torch.launch.train --arch qwen2.5-14b --layers 6 --batch 1
   --seq 4096 --lr 3e-6`` for 3 steps with the plan's remat (none for
   this model), the biases drawn after
   its ``init_train_state``: finite losses that fall, every bias leaf
   moved by each step, exact launches, no plain version, step ms, peak,
   busy share; a witness of 3 steps at lr 3e-5, where the loss rose,
   through the kernels and through the plain attention autodiffed by
   torch; step 1 twice the same bits; the checkpoint round trip of
   the biased model through the same CLI on the reduced bf16 config (at
   full width the table and head alone are 25 GB of files): the restored
   biases and the resumed step's loss bit for bit; (e) 4 gloo ranks at 1
   layer on (data 2, model 2) with TP, ZeRO-3 and remat against one
   process at phase 25 (c)'s gates, the bias leaves' distances printed;
   (f) reduced fp32 at a GQA group of 5 with biases (d 640, 10 heads over
   2 of dh 64), card against CPU within ``REL_TOL``: loss, logits, every
   gradient, 16 greedy decode steps' logits and the same tokens.  Phase
   2 first holds the flash forward with its row log-sum-exp and the
   backward at (B 1, S 4096, H 40, KV 8, dh 128, causal), the forward at
   the paged decode and prefill at H 40 / KV 8, and RMSNorm at 8 x 5120,
   4096 x 5120 and 8 x 8192 (its backward at 4096 x 5120), in bf16 and
   fp32, each against its plain version and a second call the same bits
   (``--phases 26`` runs these first); phase 7 times them.
27. the dry run (``launch/dryrun.py``, ``meta`` tensors on the host's
   CPU, its jobs dealt over ``RankPool``'s four processes): (a) one row
   for each of the 10 archs on the 256-card production mesh at the shape
   its family stresses, with its bottleneck, three terms and
   ``modeled_fits_80g``; (b) the dry run of phase 16's step (qwen3-4b at 4
   layers, 4 x 4096, (data 2, model 2), TP + ZeRO-3 + remat) on the mapping
   ``{"data": 2, "model": 2}``: its bytes a rank, in all and by opcode,
   must equal to the byte what each of phase 16's ranks sent in its step
   (with ``--phases 27`` the phase runs that 4-rank step itself); (c) its
   argument bytes must equal each rank's parameters, AdamW state and batch
   rows; (d) the dry run of phase 9's step on ``{"data": 1, "model": 1}``
   beside phase 9's measured step time and peak, as ratios, printed only.

Phase 2 also holds the kernels at phase 17's TP-local shapes against
their plain versions, and phase 7 times the SSD scan at a rank's mamba2
layer (B 2, S 2048, H 16) and the flash forward and backward at zamba2's
local heads (B 2, S 2048, H = KV = 16, dh 64).  Phase 2 holds the flash
forward's row log-sum-exp against its plain version at phase 18's
shapes (a rank's context slice: 4 lanes, T 1024, H 32, KV 8, dh 128,
kv_len 0 to 1024; the TP-local paged decode: 8 lanes, T 512, H 16, KV
4), the rows with no admissible key ``+inf``, and phase 7 times both.
Phase 2 also holds the flash forward at arctic-480b's heads (H 56, KV
8, dh 128, a GQA group of 7) at phase 19's shapes (the paged decode and
prefill, the dense engine's decode over 2048 slots, the causal prefill of
2 x 256) in bf16 and fp32, and RMSNorm at 8 x 7168 and 512 x 7168; phase
7 times the paged decode and prefill and both RMSNorm shapes.
Phase 7 also times the flash forward at kimi-k2's paged decode and
prefill chunk and, with the backward and a visible panel of 4096 keys,
at its causal training shape (B 1, S 4096, H 64, KV 8, dh 112), and the
forward at whisper-medium's encoder (8 x 1500, non-causal) and
cross-attention decode (8 queries over 1500 rows), and the backward at
phase 23's cross-attention (K14: 8 x 448 queries over 1500 keys, no
mask) beside autograd of SDPA without a mask, and the forward, backward
and K14 at phase 24's TP-local shapes (B 4, H = KV = 8: the encoder's S =
T = 1500 non-causal, cross-attention's 448 queries over 1500 keys); the
``kernels`` line gives K14 a row of its own
(``flash_attention_bwd_cross``: its launches are counted apart, and also
among ``flash_attention_bwd``'s).
Phase 7 also times the flash forward and backward at the dense training
shape as training launches them (causal, the forward writing its row
log-sum-exp) beside their plain versions and
``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` and its
autograd backward (the library yardsticks, never on the port's path).
The phases run in the order 1, 2, 7, 3, 19, 20, 21, 22, 23, 24, 25, 26, 4, 5,
14, 6, 9, 10, 11, 12, 13, 15, 16, 17, 18, 8, 27: phase 7
is the first to profile (``phase_timings`` says why), and its ``kernels``
line, which reads every path's launches, is printed at the end; the total
seconds, and each phase's in run order, are printed before the final
lines.

``python3 chip_smoke.py --phases 2,19`` runs phase 1 and the listed
phases in the order above (a phase that needs an earlier one's results
runs only with it) and prints no ``kernels`` line.

``python3 chip_smoke.py --compare-rmsnorm PARENT_DIR [--steps]`` runs none
of the phases: it times RMSNorm's forward and backward (``_rmsnorm_timing``,
``_rmsnorm_bwd_timing``) at the wide rows (``NORM_CMP_FWD``,
``NORM_CMP_BWD``) and at two register-body shapes, in the checkout at
PARENT_DIR and in this one, in turn parent, this, this, parent, each in its
own process after that tree's build, and prints a JSON line per run; each
run keeps its outputs on seeded inputs, and it exits 1 unless a tree's two
runs give the same bits, the register bodies' outputs are the parent's
bits and the wide rows' agree with the parent's within the tolerance of
``_norm_close``.  ``--steps`` then runs phases 25 and 26 in the parent and
in this tree with RMSNorm's device time sorted into forward and backward,
and prints both directions' ms in the profiled decode and training steps
of internvl2-26b and qwen2.5-14b.

``python3 chip_smoke.py --compare-flash-bwd PARENT_DIR`` runs none of
the phases: it times the bf16 flash backward at the dense training shape
with ``_flash_bwd_timing`` of the checkout at PARENT_DIR and of this one,
in turn parent, this, this, parent, each in its own process after that
tree's build, and prints a JSON line per run; each run also hashes the
backward's dq, dk and dv at S == T on seeded inputs (the dense training
shape and phase 2's S = 100 cases, both dtypes, dh 64, 112 and 128), and
it exits 1 unless every run of both trees gives the same bits.

The last three lines of standard output are the card's ``nvidia-smi``
name and power limit (also printed first), the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  It needs a CUDA device and the rest of
the checkout; without either it exits non-zero and prints no result.
"""
import contextlib
import copy
import ctypes
import dataclasses
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, tensor / vector

# the serving geometry of phase 3
PAGE_SIZE, MAX_CONTEXT, DECODE_SLOTS = 16, 512, 8
PREFILL_BATCH, PREFILL_CHUNK = 4, 128
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the training geometry of phase 5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 6
# backward kernels and the SSD scan against torch.autograd of the plain
# versions, relative to each reference's largest magnitude: fp32 sums of up
# to chunk x state x head-dim products in another order; bf16 rounding of
# inputs and outputs with fp32 inside.  The fp32 SSD cases are held against
# the plain version in float64 (the fp32 plain version is itself off by up
# to ~1e-4 in the gradients of dt and A, sums of differences of sums): the
# kernel passes within 1e-4 of float64, or no further from it than twice
# the fp32 plain version is
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the bf16 flash backward rounds P and dS to bf16 for its three products
# if that moves dq, dk and dv by at most half the bf16 tolerance at the
# dense training shape (phase 2 measures it), else it would split them
BWD_ROUND_TOL = REL_TOL["bfloat16"] / 2
# reduced fp32 training, card vs CPU: relative difference of each loss
TRAIN_LOSS_RTOL = 1e-4
# the sequence-parallel geometry of phase 8: qwen3-4b's native context
# split over 4 ranks on the one card
SP_RANKS, SP_SEQ = 4, 32768
SP_LOCAL = SP_SEQ // SP_RANKS
SP_TIMEOUT_S = 600
# ring attention's panel visit writes fp32 state whatever its input type:
# fp32 inputs within 1e-5 of the plain version relative to each output's
# largest magnitude; bf16 inputs within 2e-3 (the same bf16 values read by
# both, fp32 sums of 8192 terms in another order)
PARTIAL_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
# the flash backward's small cases (phase 2): (H, KV) for GQA groups of 1,
# 5 and 8, and the training path's masks (causal, window)
FLASH_BWD_GROUPS = [(2, 2), (10, 2), (16, 2)]
FLASH_BWD_MASKS = [(True, None), (False, None), (True, 8), (False, 8)]
# the dense training geometry of phase 9: qwen3-4b at full width, 2 x 4096
# tokens (4096 is Qwen3's general-stage pretraining length, Qwen3 Technical
# Report, arXiv:2505.09388), remat on every layer; depth cut from 36 to the
# most layers whose bf16 params and grads, fp32 AdamW master and moments
# (16 B a parameter) and the fp32 loss over 8192 x 151936 logits fit one
# 80 GB card
DENSE_BATCH, DENSE_SEQ, DENSE_STEPS, DENSE_LAYERS = 2, 4096, 6, 28
# AdamW's lr for phase 9, a tenth of the train CLI's default: the port's
# make_train_step has no warmup (nor has the JAX executor's), and from
# random weights at 28 layers the first step at 3e-4 raised the loss.
# Phase 9's witness trains REMAT_LAYERS layers at WITNESS_LR for
# WITNESS_STEPS steps twice from the same weights, once through the flash
# kernels and once through the plain attention autodiffed by torch
DENSE_LR = 3e-5
REMAT_LAYERS = 4
WITNESS_LR, WITNESS_STEPS = 3e-4, 4
# the dense-cache engine of phase 11 at full-width qwen3-4b: 8 lanes of a
# 2048-token cache, 16 requests with prompts of 16-128 tokens and 32 new
# tokens each; then one request of 2040 + 32 tokens on one lane, which
# wraps the cache (its prompt fed a token a step: 2071 steps), on the
# model's first WRAP_LAYERS layers: at 36 layers the request took 110 s
# of the script's time (NVIDIA H100 80GB HBM3, 700 W), and the wrap is a
# cache's, the same in every layer (depth cut since the MoE slice)
DENSE_SERVE_LANES, DENSE_SERVE_CONTEXT = 8, 2048
# (a) and (b)'s depth, cut from 36 for the whole script's time once phase
# 23 came (at 36 phase 11 took 50.1 and 74.4 s of scripts of 974.5 and
# 1260.9 s, NVIDIA H100 80GB HBM3, 700 W), and from 12 to 6 once phase 25
# came (the script 1215.1 s, phase 11 32.4 s of it)
DENSE_SERVE_LAYERS = 6
DENSE_SERVE_REQUESTS, DENSE_SERVE_NEW = 16, 32
WRAP_LAYERS = 4
# decode against prefill, bf16 at DENSE_SERVE_LAYERS: 2 lanes of 256
# tokens; at each position the largest |difference| of the logits over
# the largest |logit| of the prefill.  The two paths round differently
# (decode's (B,1,d) products and cache reads against prefill's (B,S,d)
# products and causal flash), a few bf16 ulps (2^-8) a layer compounding
# over the residual layers.  The gate was set at 36 layers, where the
# distance came to 2.67e-2 (1.77e-2 at 12; NVIDIA H100 80GB HBM3, 700 W).
# The same comparison in fp32 over 2 x 64 tokens, held at
# REL_TOL["float32"], witnesses that the bf16 distance is rounding
DECODE_VS_PREFILL_LANES, DECODE_VS_PREFILL_T = 2, 256
DECODE_VS_PREFILL_TOL = 5e-2
DECODE_VS_PREFILL_T_FP32 = 64
# phase 12, SSM and hybrid serving at full width: the archs, served on
# phase 11's geometry (8 lanes, 16 requests of 16-128 prompt tokens and 32
# new tokens; zamba2's shared-attention K/V caches of 2048 tokens); the
# zamba2 shared block's attention: MHA, H = KV = 32, dh 64
SSM_SERVE_ARCHS = ("mamba2-370m", "zamba2-1.2b")
ZAMBA2_HEADS = (32, 32, 64)
# the depth of (a) to (c), cut for the whole script's time once phase 23
# came: at 48 and 38 layers phase 12 took 77.6 s of the 974.5 s script,
# at 24 and 19 46.6 s of a 1260.9 s one (NVIDIA H100 80GB HBM3, 700 W);
# zamba2 at 12 layers makes 2 calls of its shared attention block; mamba2
# 12 -> 6 once phase 25 came (the script 1215.1 s, phase 12 24.2 s of
# it).  Part (d)'s prefill keeps the full depth
SSM_SERVE_LAYERS = {"mamba2-370m": 6, "zamba2-1.2b": 12}
# Decode against prefill on these random-weight SSM stacks compounds with
# depth: a mixer's distance of an ulp or two grows about a hundredfold over
# 48 layers, in the JAX package as in the port (tools/jax_decode_drift.py
# prints the reference's), so phase 11's bf16 gate of 5e-2 on the logits
# would fail the reference itself.  Phase 12 gates each mixer's decode
# against its prefill on the same input (the hidden state the prefill hands
# that layer, LAYERWISE_T tokens) at REL_TOL of its dtype; the logits'
# distance is printed in both dtypes, gated in fp32 at SSM_LOGITS_FP32_TOL
# and in bf16 not at all
LAYERWISE_T = 64
SSM_LOGITS_FP32_TOL = 1e-3
# phase 13, the paper's plan search driving the card: the training plan is
# searched for phase 9's model and tokens (DENSE_LAYERS, DENSE_BATCH x
# DENSE_SEQ) on one card of the H100 node with the train driver's bmw
# settings and batch grid [DENSE_BATCH]; train --plan runs PLAN_TRAIN_STEPS
# of phase 9's steps, whose losses must be phase 9's first ones, bit for
# bit (the same weights, batches, lr and remat; every kernel on the path is
# deterministic: no atomics in a backward, phase 2 checks the flash
# backward's and RMSNorm's dw bits twice).  The serving plan comes from
# search --slo-sweep PLAN_SLO_MS --max-context PLAN_MAX_CONTEXT on the same
# card; serve --plan runs PLAN_SERVE_REQUESTS requests of PLAN_SERVE_NEW
# new tokens with --batch PLAN_SERVE_LANES overriding the plan's lanes
PLAN_CLUSTER = "8x-h100-sxm-nvlink"
PLAN_TRAIN_STEPS = 3
PLAN_SLO_MS, PLAN_MAX_CONTEXT = 30, 2048
PLAN_SERVE_REQUESTS, PLAN_SERVE_LANES, PLAN_SERVE_NEW = 8, 8, 16
# phase 14, checkpoints: phase 5's run (mamba2-370m, TRAIN_BATCH x
# TRAIN_SEQ, bf16, nothing cut) saved after CKPT_STEPS steps by train
# --ckpt-dir, restored into a freshly built model and AdamW state, then
# CKPT_STEPS more steps: the losses must be phase 5's first 2 x CKPT_STEPS,
# bit for bit
CKPT_STEPS = 2
# phase 15, the pipeline runtime: qwen3-4b at full width, depth cut from 36
# to PIPE_LAYERS so that P x V = 8 (P 4 ranks, V 2 for the interleaved
# schedule) divides it; PIPE_RANKS gloo ranks share the card; the global
# batch is PIPE_MICRO micro-batches of one sequence of PIPE_SEQ tokens
# (8 rather than 16, for the whole script's time)
PIPE_LAYERS, PIPE_RANKS, PIPE_MICRO, PIPE_SEQ = 8, 4, 4, 4096
# the schedules in the order the check run takes them: the three flush
# schedules first (gpipe's gradients are kept to hold 1f1b's and zb-h1's
# against them, bit for bit), then the interleaved one on its own stages
PIPE_SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("zb-h1", 1),
                  ("1f1b-interleaved", 2))
# each schedule's loss within PIPE_LOSS_RTOL of the single-process loss
# (bf16, micro-batches of 1 sequence against one batch of 4: the same
# arithmetic in other groupings); each gradient leaf within PIPE_GRAD_TOL of
# the single-process leaf's largest magnitude (the rule of the JAX
# package's pipeline tests)
PIPE_LOSS_RTOL, PIPE_GRAD_TOL = 2e-3, 2e-2
PIPE_TIMEOUT_S = 900
# RankPool's processes, and the time a train CLI's ranks may take in them
POOL_SIZE, POOL_TIMEOUT_S = 4, 900
# train --pipeline: the plan of search --devices 4 on the H100 node with
# these flags, PIPE_TRAIN_STEPS steps at phase 9's lr
PIPE_SEARCH = ["--arch", "qwen3-4b", "--seq", str(PIPE_SEQ), "--cluster",
               PLAN_CLUSTER, "--devices", "4", "--budget", "24", "--max-pp",
               "4", "--schedules", "1f1b,zb-h1", "--batch-grid", "16"]
# 3 until phase 25 came (the whole script 1215.1 s, phase 15 95.7 s of it,
# NVIDIA H100 80GB HBM3, 700 W)
PIPE_TRAIN_STEPS = 2
# phase 16, the sharded executor: qwen3-4b at full width, depth cut from 36
# to SHARD_LAYERS so that the single-process reference (its fp32 loss over
# 16384 x 151936 logits beside 25.4 GB of bf16 params and grads and fp32
# AdamW state) fits the card alone, and the 4 ranks of (b) and (c) (each
# about 15 GB) fit it together; the train driver's first SHARD_STEPS
# batches of SHARD_BATCH x SHARD_SEQ tokens; SHARD_RANKS gloo ranks share
# the card on a (data, model) mesh of SHARD_MESH with TP, ZeRO and remat
# (8 until PR 33 added phase 23: at 8 the phase took 156.0 and 181.7 s of
# scripts of 974.5 and 1260.9 s, NVIDIA H100 80GB HBM3, 700 W).  The
# depth cannot go lower: at 2 layers no budget makes the CLI's searched
# plan shard the AdamW state (ZeRO), which (c) checks; so when phase 24
# came (the script 1226.5 s with it on a slow host, phase 16 150.1 s of
# it) the steps went from 3 to 2 instead, a step 6.1-8.0 s a rank, and
# to 1 once phase 25 came (the script 1215.1 s, phase 16 113.3 s of it)
SHARD_LAYERS, SHARD_RANKS, SHARD_BATCH, SHARD_SEQ = 4, 4, 4, 4096
SHARD_MESH, SHARD_STEPS = (2, 2), 1
# the sharded loss within SHARD_LOSS_RTOL of the single process's, each
# gathered gradient leaf within SHARD_GRAD_TOL of its largest magnitude
# (phase 15's gates: the same bf16 arithmetic, TP's partial sums rounded
# to bf16 before their fp32 sum)
SHARD_LOSS_RTOL, SHARD_GRAD_TOL = PIPE_LOSS_RTOL, PIPE_GRAD_TOL
SHARD_TIMEOUT_S = 900
# train --ranks: the plan of the port's search for SHARD_RANKS cards of the
# H100 node at this model, with a memory budget of SHARD_BUDGET_GB a card:
# the ranks share one card, and 4 replicas of the whole AdamW state (18.9
# GB each at 4 layers) would not fit it, so the budget is one that makes
# the searched plan's middle strategy, the one the driver applies, shard
# the state (at 4 layers 11 GB gives TP without ZeRO, 9 GB ZeRO; 11 GB at
# 8 layers)
SHARD_BUDGET_GB = 9
# phase 17, SSM and hybrid TP and sharded checkpoints: (a) mamba2-370m at
# full width, depth cut from 48 to SSMTP_MAMBA2_LAYERS, (b) zamba2-1.2b at
# full width, depth cut from 38 to SSMTP_ZAMBA2_LAYERS (one shared
# attention call at attn_every 6) and its
# steps to SSMTP_ZAMBA2_STEPS, for the whole script's time; the train
# driver's first batches of SSMTP_BATCH x SSMTP_SEQ tokens at the train
# CLI's lr, SSMTP_STEPS steps for (a); SSMTP_RANKS gloo ranks share the
# card on a (data, model) mesh of SSMTP_MESH with TP, ZeRO and remat, held
# to phase 16's gates; (a)'s ranks save after step SSMTP_SAVE_AT
SSMTP_RANKS, SSMTP_MESH, SSMTP_BATCH, SSMTP_SEQ = 4, (2, 2), 4, 2048
SSMTP_STEPS, SSMTP_SAVE_AT, SSMTP_LR = 3, 2, 3e-4
SSMTP_ZAMBA2_LAYERS, SSMTP_ZAMBA2_STEPS = 6, 1
# (a)'s depth: at 24 layers the whole script, phase 20 included, ran
# 1092.3 s, phase 17 277.6 s of it; at 12, with phases 21 and 22, 966.3
# and 1081.7 s in two runs, phase 17 233.6 and 255.8 s; at 6, with phase
# 24, 1226.5 s, phase 17 250.4 s on a slow host (NVIDIA H100 80GB HBM3,
# 700 W); at 2, with phase 25, 1215.1 s, phase 17 227.7 s; 1 since then
SSMTP_MAMBA2_LAYERS = 1
# a rank's batch rows and RMSNorm rows, and zamba2's TP-local (H, KV, dh)
SSMTP_LOCAL_BATCH = SSMTP_BATCH // SSMTP_MESH[0]
SSMTP_ROWS = SSMTP_LOCAL_BATCH * SSMTP_SEQ
ZAMBA2_TP_HEADS = (32 // SSMTP_MESH[1], 32 // SSMTP_MESH[1], 64)
# phase 18, sharded serving: SERVE_SHARD_RANKS gloo ranks share the card on
# a (data, model) mesh of SERVE_SHARD_MESH with ShardPolicy(tp=True,
# zero=False), held against a single process on the same weights (init_lm
# seed 0).  (a) the paged engine on phase 3's geometry and requests, the
# last four arriving SS_ARRIVAL_S late; (b) the dense-cache engine's step
# on 8 lanes of 2048-token caches from the preset positions SS_INDEX (lane
# 0 lies wholly in model rank 0's slots for its first steps; the last
# three lanes wrap), SS_STEPS steps, at SS_BF16_LAYERS in bf16 and
# SS_FP32_LAYERS (zamba2: SS_ZAMBA2_FP32_LAYERS, two shared-block calls)
# in fp32, then serve() of SS_DENSE_REQUESTS requests in fp32; the sharded
# make_prefill_step on SS_PREFILL_BATCH x SS_PREFILL_SEQ tokens; (c) serve
# --ranks 4 for both engines in fp32 at SS_FP32_LAYERS, SS_CLI_REQUESTS
# requests on 8 lanes of SS_CLI_CONTEXT tokens
SERVE_SHARD_RANKS, SERVE_SHARD_MESH = 4, (2, 2)
SERVE_SHARD_TIMEOUT_S = 900
SS_ARRIVAL_S = 0.5
SS_INDEX = [0, 5, 100, 1000, 1500, 2040, 2044, 2047]
SS_STEPS = {"bfloat16": 4, "float32": 16}
# the bf16 depth of (a) and (b), cut for the whole script's time: with (a)
# at 36 layers and (b) at 18, 24 and 18 the whole script, phase 20
# included, ran 1059.1 s, phase 18 197.3 s of it (NVIDIA H100 80GB HBM3,
# 700 W); qwen3-4b 9 -> 6 and mamba2-370m 12 -> 6 once phase 24 came
# (zamba2 keeps 12: two calls of its shared block), when the whole script
# ran 1226.5 s before any cut, phase 18 198.6 s of it, on a slow host;
# 6 -> 4 and 6 -> 4 once phase 25 came (1215.1 s, phase 18 159.5 s)
SS_BF16_LAYERS = {"qwen3-4b": 4, "mamba2-370m": 4, "zamba2-1.2b": 12}
# fp32's depth (zamba2 aside: two shared-block calls need 12), 4 until
# phase 24 came: with phase 24 the script ran 1142.4 s at 4 on a slow host
# (the fp32 parts of phase 18 took 30.3 s of a rank's 90.7 s in an
# earlier run of 198.6 s; NVIDIA H100 80GB HBM3, 700 W)
SS_FP32_LAYERS, SS_ZAMBA2_FP32_LAYERS = 2, 12
SS_DENSE_REQUESTS, SS_DENSE_NEW = 10, 8
SS_PREFILL_BATCH, SS_PREFILL_SEQ = 2, 1024
SS_CLI_REQUESTS, SS_CLI_CONTEXT = 12, 256
# the ranks' logits against the single process's, over its largest logit,
# in bf16: TP rounds each rank's partial row products (wo, w_down) to
# bf16 before their fp32 sum, one rounding more a layer than one process,
# and a random-weight stack compounds it with depth (2.0e-2 to 4.9e-2 at
# qwen3-4b's 36 layers on an H100 80GB HBM3 at 700 W, the same with
# context or KV heads over model, so not the merge); fp32 at
# SS_FP32_LAYERS layers at REL_TOL, the algebra's gate.  The SSM stacks'
# bf16 distance is printed (None: no gate), as phase 12 prints theirs: at
# 48 layers it is chaotic in the rounding (0.38 for mamba2 there)
SS_LOGIT_TOL = {"bfloat16": 1e-1, "float32": REL_TOL["float32"]}
SS_SSM_BF16_TOL = None
# phase 19, mixture-of-experts: arctic-480b (hf:Snowflake/snowflake-arctic-
# base) at full width (d 7168, 56 query and 8 KV heads of dh 128, 128
# experts of d_ff 4864, top-2, a dense residual branch of 4864), depth cut
# from 35 to MOE_LAYERS: one layer holds 13.61 B parameters (27.2 GB in
# bf16), two with the embedding and head 55.4 GB, three would not fit the
# card.  (a) serves phase 3's geometry and requests; (b) the dense-cache
# engine on MOE_DENSE_LANES lanes of DENSE_SERVE_CONTEXT tokens,
# MOE_DENSE_REQUESTS requests of 16-64 prompt tokens and MOE_DENSE_NEW new
# ones
MOE_ARCH, MOE_LAYERS, ARCTIC_HEADS = "arctic-480b", 2, (56, 8, 128)
MOE_DENSE_LANES, MOE_DENSE_REQUESTS, MOE_DENSE_NEW = 8, 10, 16
# decode against prefill needs a capacity at which no (token, choice)
# pair drops (check-only: capacity_factor E / top_k makes C = T); a decode
# group is one token (C = top_k: nothing drops), a prefill group of 256
# tokens at arctic's capacity_factor 1.25 has C = 5 against a mean load of
# 4.  bf16 noise near a top-k tie can route one hidden state to other
# experts in the two paths: the gate holds the positions whose routing
# agrees at every layer, at phase 11's tolerance, and the flips are
# counted; fp32 at MOE_FP32_LAYERS layer(s) and DECODE_VS_PREFILL_T_FP32
# tokens at REL_TOL
MOE_DECODE_VS_PREFILL_TOL = DECODE_VS_PREFILL_TOL
MOE_FP32_LAYERS = 1
# (c) the three dispatches of one full-width MoE layer agree within this
# of the largest output (sort and grouped run the same products on the
# same buffers; einsum combines in one fp32 sum where sort adds rounded
# bf16 terms)
MOE_DISPATCH_TOL = REL_TOL["bfloat16"]
# (d) reduced fp32 card vs CPU: arctic-480b's default reduction (4
# experts, top-2) and kimi-k2-1t-a32b's at 16 experts (top-8, a shared
# expert, its first layer dense)
MOE_REDUCED = (("arctic-480b", {}), ("kimi-k2-1t-a32b", {"n_experts": 16}))
# phase 20, MoE sharded: MOE_SHARD_RANKS gloo ranks share the card.  (a)
# phase 19's model under TP on a (data, model) mesh of MOE_TP_MESH,
# ShardPolicy(tp=True, zero=False): a rank holds 32 of the 128 experts a
# layer, 14 of the 56 query and 2 of the 8 KV heads, a quarter of the
# residual branch's columns and of the vocabulary; phase 3's requests
# through the paged engine, twice.  (b) the same model under EP on a
# (data, expert) mesh of MOE_EP_MESH: a rank holds 32 experts a layer and
# the rest whole; phase 19 (b)'s requests through serve() on
# MOE_DENSE_LANES lanes of DENSE_SERVE_CONTEXT tokens, two a rank.  (c)
# MOE_REDUCED on the card, under TP with ZeRO on MOE_TRAIN_TP_MESH and
# under EP on MOE_EP_MESH: one batch of MOE_TRAIN_BATCH x MOE_TRAIN_SEQ
# tokens against the single process on the CPU (the card's draw of the
# same weights)
MOE_SHARD_RANKS, MOE_TP_MESH, MOE_EP_MESH = 4, (1, 4), (1, 4)
ARCTIC_TP_HEADS = (ARCTIC_HEADS[0] // MOE_TP_MESH[1],
                   ARCTIC_HEADS[1] // MOE_TP_MESH[1], ARCTIC_HEADS[2])
MOE_EP_LANES = MOE_DENSE_LANES // (MOE_EP_MESH[0] * MOE_EP_MESH[1])
MOE_TRAIN_TP_MESH, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = (2, 2), 4, 64
MOE_SHARD_TIMEOUT_S = 600
# (a)'s and (b)'s first decode step against phase 19's single process,
# over its largest logit, on the lanes whose top-2 experts agree at every
# layer (paged: whose input token agrees too): phase 18's bf16 gate
MOE_SHARD_LOGIT_TOL = SS_LOGIT_TOL["bfloat16"]
# (c): the loss relative, each gathered gradient leaf over its largest
# magnitude, by (dtype, mesh).  bf16 gates the loss at phase 16's
# SHARD_LOSS_RTOL, and EP's leaves at SHARD_GRAD_TOL (a token's arithmetic
# under EP is the single process's); TP's bf16 leaves are printed (None: no
# gate): TP sums bf16 partials in fp32, so a state lies an ulp off, and a
# random-weight MoE's bf16 gradients are chaotic in that rounding (a token
# near a top-k tie routes to other experts; the router's leaf is a
# difference of near-equal terms): (c) prints how far one process's own
# bf16 gradients lie from the same weights' fp32 ones.  Every leaf is gated
# in fp32, as phase 17 gates SSM gradients
MOE_SHARD_TRAIN_TOL = {("bfloat16", "tp"): (SHARD_LOSS_RTOL, None),
                       ("bfloat16", "ep"): (SHARD_LOSS_RTOL, SHARD_GRAD_TOL),
                       ("float32", "tp"): (1e-5, 1e-5),
                       ("float32", "ep"): (1e-5, 1e-5)}
# which single process each dtype is gated against (both are printed): in
# bf16 the card's, as phase 16 (the CPU's bf16 products round otherwise);
# in fp32 the CPU's
MOE_SHARD_TRAIN_REF = {"bfloat16": "cuda", "float32": "cpu"}
# phase 21: kimi-k2-1t-a32b at full width (d 7168, 64 query and 8 KV heads
# of dh 7168 / 64 = 112, 384 experts of d_ff 2048, top-8, a shared expert,
# the first layer dense), depth cut from 61 to KIMI_LAYERS: the dense
# first layer and one MoE layer.  One MoE layer is 384 x 3 x 7168 x 2048
# = 16.9 B parameters (33.8 GB in bf16), the embedding and the untied head
# 163840 x 7168 each (2.35 GB each): two layers come to about 39 GB, and a
# third would leave too little room beside the check-only buffers of (b).
# Phase 2 (phase_k13) holds the dh 112 kernels at KIMI_HEADS first, the
# training shape at KIMI_TRAIN (B, S)
KIMI_ARCH, KIMI_LAYERS, KIMI_HEADS = "kimi-k2-1t-a32b", 2, (64, 8, 112)
KIMI_TRAIN = (1, 4096)
# phase 22: whisper-medium at full width (24 + 24 layers, d 1024, 16 heads
# of dh 64, d_ff 4096, vocab 51865), bf16: WHISPER_LANES lanes of random
# frames (WHISPER_LANES, WHISPER_FRAMES, 1024), a greedy decode of
# WHISPER_TOKENS tokens on a WHISPER_CONTEXT-slot cache (whisper's decoder
# window), each step's logits against the teacher-forced prefill's at
# DECODE_VS_PREFILL_TOL of the largest logit; the same in fp32 at
# WHISPER_FP32_LAYERS + WHISPER_FP32_LAYERS layers at REL_TOL
WHISPER_ARCH, WHISPER_HEADS = "whisper-medium", (16, 16, 64)
WHISPER_LANES, WHISPER_FRAMES, WHISPER_TOKENS = 8, 1500, 32
WHISPER_CONTEXT, WHISPER_FP32_LAYERS = 448, 4
# K14 (phase 2, phase_k14): the flash backward at S != T, (B, S, T, H, KV,
# dh): whisper-medium's cross-attention in training (WHISPER_LANES
# sequences of WHISPER_CONTEXT decoder tokens over WHISPER_FRAMES encoder
# frames), dh 112 and 128 with a GQA group of 4 over the same ragged keys,
# and more queries than keys
K14_CASES = [(WHISPER_LANES, WHISPER_CONTEXT, WHISPER_FRAMES,
              *WHISPER_HEADS),
             (2, 130, WHISPER_FRAMES, 16, 4, 112),
             (2, 130, WHISPER_FRAMES, 16, 4, 128),
             (2, 200, 37, 16, 4, 64)]
# beside K14 (phase_k14): the S == T flash backward at whisper-medium's
# training shapes, (B, S, H, KV, dh, causal): the encoder's self-attention
# (1500 = 23 x 64 + 28 queries and keys, ragged at both ends) and the
# decoder's causal self-attention over its WHISPER_CONTEXT tokens
WHISPER_SELF_BWD_CASES = [(WHISPER_LANES, WHISPER_FRAMES, *WHISPER_HEADS,
                           False),
                          (WHISPER_LANES, WHISPER_CONTEXT, *WHISPER_HEADS,
                           True)]
# phase 23: whisper-medium training at full width (24 + 24 layers, bf16,
# random weights from seed 0): WHISPER_TRAIN_STEPS steps of train --arch
# whisper-medium --batch WHISPER_LANES --seq WHISPER_CONTEXT (whisper's
# decoder window) on frames (WHISPER_LANES, WHISPER_FRAMES, 1024), the
# searched plan's remat, saved after step WHISPER_CKPT_AT; reduced fp32
# card vs CPU through the CLI on WHISPER_CPU_BATCH x WHISPER_CPU_SEQ
WHISPER_TRAIN_STEPS, WHISPER_CKPT_AT = 3, 2
# the decoder's depth in phase 23, 24 until phase 25 came: the whole
# script then ran 1215.1 s, phase 23 86.0 s of it, 49.3 s of which saved
# and restored its 12.22 GB checkpoint (NVIDIA H100 80GB HBM3, 700 W)
WHISPER_TRAIN_DEC_LAYERS = 12
WHISPER_CPU_BATCH, WHISPER_CPU_SEQ = 2, 100
# phase 24: sharded whisper-medium, WSHARD_RANKS gloo ranks sharing the
# card, at full width with the depth cut from 24 + 24 to WSHARD_LAYERS +
# WSHARD_LAYERS (phase 23 trains the whole depth; a sharded step's gloo
# bytes grow with it), on phase 23's batch (WHISPER_LANES x
# WHISPER_CONTEXT decoder tokens over WHISPER_FRAMES frames): (a)
# training on WSHARD_TP_MESH with TP, ZeRO, remat and seq_shard and on
# WSHARD_ZERO_MESH with ZeRO, one loss and gradients against the single
# process at phase 16's gates, then WSHARD_STEPS AdamW steps at WSHARD_LR;
# (c) serving on WSHARD_TP_MESH, WSHARD_TOKENS greedy steps of 8 lanes on
# a WHISPER_CONTEXT-slot cache, the first step against the single process
# at phase 18's bf16 gate, decode against the teacher-forced prefill at
# phase 22's; (d) the reduced fp32 model at WSHARD_FP32_LAYERS +
# WSHARD_FP32_LAYERS layers with a vocabulary of WSHARD_FP32_VOCAB, which
# no model axis splits: WSHARD_FP32_BATCH x WSHARD_FP32_SEQ tokens and
# WSHARD_FP32_STEPS greedy steps against the single process on the card
# (the depth 4 + 4 until phase 25 came: the whole script then ran
# 1215.1 s, phase 24 99.1 s of it, NVIDIA H100 80GB HBM3, 700 W)
WSHARD_RANKS, WSHARD_LAYERS, WSHARD_STEPS, WSHARD_LR = 4, 2, 2, 3e-4
WSHARD_TP_MESH, WSHARD_ZERO_MESH = (2, 2), (4, 1)
WSHARD_TOKENS, WSHARD_TIMEOUT_S = 16, 600
WSHARD_LOSS_RTOL = SHARD_LOSS_RTOL
WSHARD_LOGIT_TOL = SS_LOGIT_TOL["bfloat16"]
WSHARD_FP32_LAYERS, WSHARD_FP32_VOCAB = 2, 1001
WSHARD_FP32_BATCH, WSHARD_FP32_SEQ, WSHARD_FP32_STEPS = 4, 32, 8
WSHARD_FP32_LOSS_RTOL, WSHARD_FP32_LOGIT_TOL = 1e-5, 1e-4
# (a)'s bf16 gradient leaves are not held against the single process's
# bf16 leaves at SHARD_GRAD_TOL: at 4 + 4 layers its LayerNorm leaves lie
# up to 2.6e-2 from the same weights' fp32 gradients, and the ranks' from
# the single process's up to 3.5e-2 under TP and 2.5e-2 under ZeRO
# (NVIDIA H100 80GB HBM3, 700 W), sums of 3584 tokens rounded to bf16
# otherwise.  Both are held against fp32 instead (WSHARD_BF16_VS_FP32
# below).  Every leaf is gated in fp32 on the same weights (the loss at
# WSHARD_FP32_LOSS_RTOL, each leaf at WSHARD_FP32_GRAD_TOL of its largest
# magnitude: the card's fp32 tolerance), and the bf16 loss at
# WSHARD_LOSS_RTOL
WSHARD_FP32_GRAD_TOL = REL_TOL["float32"]
# a rank's (B, H, KV, dh) under TP on WSHARD_TP_MESH (phase 7 times the
# flash kernels there)
WHISPER_TP_LOCAL = (WHISPER_LANES // WSHARD_TP_MESH[0],
                    WHISPER_HEADS[0] // WSHARD_TP_MESH[1],
                    WHISPER_HEADS[1] // WSHARD_TP_MESH[1], WHISPER_HEADS[2])
# phase 2 holds the flash kernels at phase 24's rank-local shapes too: K14
# (B, S, T, H, KV, dh) and the S == T backward (B, S, H, KV, dh, causal)
# of a TP rank (the encoder's and the decoder's self-attention); the
# forward cases are whisper_rank_flash_cases()
WHISPER_TP_K14 = (WHISPER_TP_LOCAL[0], WHISPER_CONTEXT, WHISPER_FRAMES,
                  *WHISPER_TP_LOCAL[1:])
WHISPER_TP_SELF_BWD_CASES = [
    (WHISPER_TP_LOCAL[0], WHISPER_FRAMES, *WHISPER_TP_LOCAL[1:], False),
    (WHISPER_TP_LOCAL[0], WHISPER_CONTEXT, *WHISPER_TP_LOCAL[1:], True)]
# (a)'s bf16 gate on the gradient leaves: the ranks' worst leaf's distance
# from the same weights' fp32 gradients within WSHARD_BF16_VS_FP32 times
# the single process's own worst bf16-to-fp32 distance (at 4 + 4 layers
# the single process lies 2.63e-2 from fp32, TP's ranks 3.00e-2 and
# ZeRO's 1.29e-2, NVIDIA H100 80GB HBM3, 700 W)
WSHARD_BF16_VS_FP32 = 2.0
# phase 25: internvl2-26b (arXiv:2404.16821) at full width: d 6144, 48
# query heads over 8 KV heads of dh 128 (a GQA group of 6), d_ff 16384, an
# untied head over a vocabulary of 92553 (odd: no model axis splits it),
# 256 vision tokens of d_vision 3200 projected to d by the 2-layer MLP
# projector.  (a) serving at full depth (48 layers, 19.92 B parameters,
# 39.84 GB): phase 3's paged engine and requests (text only, as the
# reference serves a VLM), make_prefill_step on VLM_PREFILL_LANES lanes of
# 256 patches and VLM_PREFILL_TOKENS tokens, decode against prefill over
# VLM_DECODE_VS_PREFILL_T tokens at phase 11's gate; (b) training on one
# card through train --arch internvl2-26b --layers VLM_TRAIN_LAYERS
# --batch 1 --seq VLM_TRAIN_SEQ (256 + 4096 positions) for
# VLM_TRAIN_STEPS steps: 1.196 B fixed parameters (the embedding, the
# head, the projector) and 390.1 M a layer at 16 B a parameter with AdamW,
# so 6 layers hold 56.6 GB before activations; (c) VLM_SHARD_RANKS gloo
# ranks sharing the card at full width and VLM_SHARD_LAYERS layer on
# VLM_SHARD_MESH with TP, ZeRO-3 and remat (at 2 layers the four ranks'
# AdamW updates, each about 19 GB at its peak beside the whole table's and
# head's halves and their fp32 state, ran out of the card's memory: NVIDIA
# H100 80GB HBM3, 700 W), VLM_SHARD_STEPS step of 4
# lanes of 256 + VLM_SHARD_SEQ, its loss at SHARD_LOSS_RTOL of one
# process's and its worst bf16 gradient leaf within WSHARD_BF16_VS_FP32
# times one process's own bf16-to-fp32 distance; (d) the reduced fp32
# model with d_vision apart from d and a GQA group of 6, on the card
# against the CPU's plain versions at REL_TOL: loss, logits and the
# projector's gradients
VLM_ARCH, VLM_HEADS = "internvl2-26b", (48, 8, 128)
VLM_VISION = 256
VLM_PREFILL_LANES, VLM_PREFILL_TOKENS = 8, 128
VLM_DECODE_VS_PREFILL_T = 64
# (b)'s steps: 2 while the whole script ran 1077.0-1215.1 s, 3 again
# once RankPool brought it to 529.9 s (NVIDIA H100 80GB HBM3, 700 W)
VLM_TRAIN_LAYERS, VLM_TRAIN_STEPS, VLM_TRAIN_SEQ = 6, 3, 4096
VLM_SHARD_RANKS, VLM_SHARD_LAYERS, VLM_SHARD_MESH = 4, 1, (2, 2)
VLM_SHARD_LANES, VLM_SHARD_SEQ, VLM_SHARD_STEPS = 4, 1024, 1
VLM_SHARD_LR, VLM_SHARD_TIMEOUT_S = 3e-5, 600
VLM_FP32_BATCH, VLM_FP32_SEQ = 2, 64
# phase 2 holds the kernels at phase 25's shapes: the causal flash forward
# with its row log-sum-exp and the backward at (B, S, H, KV, dh) of (b)'s
# step (S = 256 + 4096 positions), and RMSNorm at d 6144 over a decode's
# 8 rows and (b)'s 4352
VLM_TRAIN_ATTN = (1, VLM_VISION + VLM_TRAIN_SEQ, *VLM_HEADS)
VLM_NORM_ROWS = (DECODE_SLOTS, VLM_VISION + VLM_TRAIN_SEQ)
# phase 26: the Qwen2/Qwen3 dense family at full width, bf16, random
# weights from seed 0, the QKV biases of qwen2.5-14b and qwen2-72b then
# drawn from a seeded normal of std QWEN_BIAS_STD (the init's zeros would
# hide a wrong add or slice).  bf16 weights reckoned from the shapes:
# qwen3-8b 16.38 GB at 36 layers, qwen2.5-14b 29.54 GB at 48, qwen2-72b
# 1.755 GB a layer beside 4.98 GB of table and head, 145.4 GB at 80: it
# is served at QWEN72_LAYERS (75.2 GB), the deepest cut that leaves the
# paged pools and activations QWEN72_HEADROOM_GB of the card's free
# memory.  (a) qwen3-8b and (b) qwen2.5-14b at full depth through the
# paged engine, (b) also the dense-cache engine and decode against the
# teacher-forced prefill over QWEN_DECODE_VS_PREFILL_T tokens; (c)
# qwen2-72b paged; (d) train --arch qwen2.5-14b --layers QWEN_TRAIN_LAYERS
# --batch 1 --seq QWEN_TRAIN_SEQ --lr QWEN_TRAIN_LR with the plan's remat
# (none: the plan keeps every activation): 0.778 B of table
# and 0.778 B of head beside 0.275 B a layer, 16 B a parameter with
# AdamW, so 6 layers hold 51.3 GB before activations; its checkpoint
# round trip runs on the reduced bf16 model through the same CLI
# (QWEN_CKPT_ARGV), since at full width the table and head alone come to
# 25 GB of files (phase 14 saved and restored about 0.6 GB/s: NVIDIA H100
# 80GB HBM3, 700 W); (e) QWEN_SHARD_RANKS gloo ranks at QWEN_SHARD_LAYERS
# layer on QWEN_SHARD_MESH with TP, ZeRO-3 and remat against one process
# at phase 25 (c)'s gates; (f) reduced fp32 at a GQA group of 5, card
# against CPU
QWEN3_8B, QWEN2_5_14B, QWEN2_72B = "qwen3-8b", "qwen2.5-14b", "qwen2-72b"
QWEN_HEADS = {QWEN3_8B: (32, 8, 128), QWEN2_5_14B: (40, 8, 128),
              QWEN2_72B: (64, 8, 128)}
QWEN_BIAS_STD, QWEN_BIAS_SEED = 0.5, 26
QWEN72_LAYERS, QWEN72_HEADROOM_GB = 40, 4.0
QWEN_DECODE_VS_PREFILL_T = 64
QWEN_TRAIN_LAYERS, QWEN_TRAIN_STEPS, QWEN_TRAIN_SEQ = 6, 3, 4096
# (d)'s lr, a tenth of phase 9's: from these random weights at 6 layers
# the CLI's losses went 12.45, 26.21, 14.86 at its default 3e-4 and
# 12.45, 17.04, 14.63 at phase 9's 3e-5 (NVIDIA H100 80GB HBM3, 700 W;
# qwen2.5-14b has no QK-norm, and AdamW's first step moves every weight
# by lr whatever its gradient, with no warmup here nor in the JAX
# executor); (d)'s witness repeats 3e-5 through the flash kernels and
# through the plain attention autodiffed by torch
QWEN_TRAIN_LR, QWEN_WITNESS_LR = 3e-6, 3e-5
QWEN_CKPT_AT = 2
QWEN_CKPT_ARGV = ["--arch", QWEN2_5_14B, "--reduced", "--steps", "3",
                  "--batch", "2", "--seq", "256", "--log-every", "1"]
QWEN_SHARD_RANKS, QWEN_SHARD_LAYERS, QWEN_SHARD_MESH = 4, 1, (2, 2)
QWEN_SHARD_LANES, QWEN_SHARD_SEQ, QWEN_SHARD_STEPS = 4, 1024, 1
QWEN_SHARD_LR, QWEN_SHARD_TIMEOUT_S = 3e-5, 600
QWEN_FP32_BATCH, QWEN_FP32_SEQ, QWEN_FP32_DECODE = 2, 64, 16
# phase 2 holds the kernels at qwen2.5-14b's training attention (G = 5)
# and serving shapes, and RMSNorm at the family's new widths
QWEN_TRAIN_ATTN = (1, QWEN_TRAIN_SEQ, *QWEN_HEADS[QWEN2_5_14B])
QWEN_NORM_FWD = [(DECODE_SLOTS, 5120), (QWEN_TRAIN_SEQ, 5120),
                 (DECODE_SLOTS, 8192)]
QWEN_NORM_BWD = (QWEN_TRAIN_SEQ, 5120)
# qwen2-72b's d 8192 over a training step's 4096 rows (phases 2 and 7)
QWEN72_NORM_BWD = (QWEN_TRAIN_SEQ, 8192)


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10):
    """Device time per call, without the host's launch path: the calls are
    queued behind a spin kernel (``torch.cuda._sleep``) and timed by CUDA
    events once the spin ends, so they run back to back.  A call that
    launches more kernels than the stream's queue holds blocks the host
    until the spin ends; then fewer calls are queued, and if even one
    call does not fit, its time from back-to-back launches is returned.
    Returns (ms, whether the calls ran queued)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0       # bounds one call's queueing
    for n in sorted({iters, max(1, iters // 4), 1}, reverse=True):
        spun, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        torch.cuda._sleep(int((2 * n * host_s + 1e-3) * 2e9))
        spun.record()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not spun.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / n, True
    return cuda_ms(fn, iters=iters, warmup=1), False


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


# ---------------------------------------------------------------------------
# phase 1: card, build
# ---------------------------------------------------------------------------

def same_bits(a, b) -> bool:
    """Whether two results (a tensor or a tuple of them) are equal bit for
    bit (a second call of a kernel on the same inputs)."""
    import torch
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def ptxas_report(text):
    """[(mangled kernel, registers, (spill store bytes, spill load bytes))]
    from an ``nvcc -Xptxas -v`` log."""
    out, fn, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), spill))
            fn = None
    return out


def mma_counts(lib):
    """{mangled kernel: (number of HGMMA (wgmma), number of HMMA
    (mma.sync) instructions)} in the library's SASS (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed on {lib}: {res.stderr}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = [0, 0]
        elif fn and "HGMMA" in line:
            counts[fn][0] += 1
        elif fn and "HMMA" in line:
            counts[fn][1] += 1
    return {fn: tuple(n) for fn, n in counts.items()}


# the bf16 SSD forward's and backward's kernels, in launch order; the
# state passes are the bandwidth-bound ones without products
SSD_FWD_KERNELS = ("ssd_fwd_chunk_state_kernel", "ssd_fwd_state_pass_kernel",
                   "ssd_fwd_chunk_scan_kernel")
SSD_BWD_KERNELS = ("ssd_bwd_chunk_state_kernel", "ssd_bwd_state_pass_kernel",
                   "ssd_bwd_chunk_grad_kernel")
# the RMSNorm kernels of csrc/rmsnorm.cu; phase 5 sorts their time into
# forward and backward by the prefixes rmsnorm_fwd and rmsnorm_bwd
RMSNORM_KERNELS = ("rmsnorm_fwd_kernel", "rmsnorm_fwd_row_kernel",
                   "rmsnorm_fwd_cta_kernel", "rmsnorm_fwd_wide_kernel",
                   "rmsnorm_bwd_kernel", "rmsnorm_bwd_cta_kernel",
                   "rmsnorm_bwd_wide_kernel", "rmsnorm_bwd_dw_sum_kernel")
# the widths past the register bodies (2560) that the models run: qwen3-8b
# and zamba2's gated norm, qwen2.5-14b, internvl2-26b, arctic-480b and
# kimi-k2, qwen2-72b; phase 1 prints the cta bodies' geometry at each
WIDE_NORM_D = (4096, 5120, 6144, 7168, 8192)
# the flash backward's three kernels by name prefix, in launch order
FLASH_BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
# the head dims csrc/flash_attention.cu instantiates, in the order of
# flash_attention_bwd_occupancy's output
FLASH_HEAD_DIMS = (64, 112, 128)
# built with it defined, the SSD scan skips the bf16 backward's dB/dC stores
NO_ADDS = ("SSD_BWD_NO_ADDS",)


def _kernel_name(mangled):
    """flash_fwd_wgmma_kernel<128,true> from its mangled name."""
    for m in re.finditer(r"(?=(\d{1,2})([a-z_]+kernel))", mangled):
        if int(m.group(1)) != len(m.group(2)):
            continue            # digits of a hash, not the name's length
        rest = mangled[m.start() + len(m.group(1)) + len(m.group(2)):]
        t = re.match(r"I(.*?)EEv", rest)
        if not t:
            return m.group(2)
        args = re.sub(r"Li(\d+)E", r"\1,", t.group(1))
        args = args.replace("Lb1E", "true,").replace("Lb0E", "false,")
        args = re.sub(r"^f", "float,", args).replace("13__nv_bfloat16",
                                                       "bf16,")
        return f"{m.group(2)}<{args.rstrip(',')}>"
    return mangled[:36]


def phase_build():
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    def nvcc(job):
        name, defines = job
        t0 = time.perf_counter()
        return name, _build.build(name, defines), time.perf_counter() - t0

    t0 = time.perf_counter()
    jobs = [("flash_attention", ()), ("ssd_scan", ()), ("rmsnorm", ()),
            ("ssd_scan", NO_ADDS)]
    with ThreadPoolExecutor(len(jobs)) as pool:   # one nvcc each, together
        built = list(pool.map(nvcc, jobs))
    log(f"[build] nvcc, in parallel: {time.perf_counter() - t0:.1f} s")
    for (name, lib, secs), (_, defines) in zip(built, jobs):
        log(f"[build] nvcc {name}.cu{''.join(' -D' + d for d in defines)}: "
            f"{secs:.1f} s -> {lib.relative_to(ROOT)}")
        if defines:
            continue
        mma = mma_counts(lib)
        report = {}
        for fn, regs, spill in ptxas_report(
                lib.with_suffix(".log").read_text()):
            hg, hm = mma.get(fn, (0, 0))
            report[_kernel_name(fn)] = (regs, spill, hg, hm)
            log(f"[build]   {_kernel_name(fn):36s} {regs:3d} registers, "
                f"spill stores/loads {spill[0]}/{spill[1]} bytes, "
                f"{hg} HGMMA, {hm} HMMA in SASS")
        if name == "flash_attention":
            # the bf16 instantiations (both entries, dh 64, 112 and 128)
            # must run their products on wgmma
            wgmma = {fn: n[0] for fn, n in mma.items()
                     if "flash_fwd_wgmma_kernel" in fn}
            check(len(wgmma) == 2 * len(FLASH_HEAD_DIMS)
                  and all(wgmma.values()),
                  f"bf16 flash kernels without HGMMA in their SASS: {wgmma}")
            # the backward: D for both dtypes, dK/dV and dQ on FMA for fp32
            # and on wgmma (HGMMA) for bf16, dh 64, 112 and 128; the bf16
            # product kernels spill nothing
            bwd = {k: v for k, v in report.items()
                   if k.startswith("flash_bwd_")}
            log("[build]   flash backward: " + "; ".join(
                f"{k} {v[0]} registers, spills {v[1][0]}/{v[1][1]}, "
                f"{v[2]} HGMMA" for k, v in sorted(bwd.items())))
            wg = {k: v for k, v in bwd.items() if "_wgmma_kernel" in k}
            n_dh = len(FLASH_HEAD_DIMS)
            check(len(bwd) == 6 * n_dh and len(wg) == 2 * n_dh and all(
                v[2] > 0 and v[1] == (0, 0) for v in wg.values()),
                  f"flash backward kernels missing, or bf16 ones without "
                  f"HGMMA or spilling: {bwd}")
            occ = (ctypes.c_int * (2 * n_dh))()
            check(ctypes.CDLL(str(lib)).flash_attention_bwd_occupancy(occ)
                  == 0, "flash_attention_bwd_occupancy failed")
            log("[build]   bf16 flash backward, CTAs of 256 threads per SM: "
                + ", ".join(f"{k} dh {dh} {n}" for (dh, k), n in zip(
                    [(dh, k) for dh in FLASH_HEAD_DIMS
                     for k in ("flash_bwd_dkdv_wgmma_kernel",
                               "flash_bwd_dq_wgmma_kernel")], occ)))
            # ptxas names a kernel whose wgmma it had to serialise
            for line in lib.with_suffix(".log").read_text().splitlines():
                if "serialized" in line:
                    log(f"[build]   ptxas: {line.strip()}")
        elif name == "rmsnorm":
            spilled = {k: v[1] for k, v in report.items() if v[1] != (0, 0)}
            missing = [k for k in RMSNORM_KERNELS
                       if not any(n.split("<")[0] == k for n in report)]
            check(not missing and not spilled,
                  f"RMSNorm kernels missing {missing} or spilling: {spilled}")
            for d in (1024, 2048):
                warps, per_sm, sms, _ = rmsnorm._bwd_config(0, d, 1)
                n = rmsnorm.bwd_grid(TRAIN_BATCH * TRAIN_SEQ, warps, per_sm,
                                     sms)
                log(f"[build]   RMSNorm backward, bf16 d {d}: {warps} warps "
                    f"a CTA, {per_sm} CTAs per SM, {n} CTAs (partials rows) "
                    f"at {TRAIN_BATCH * TRAIN_SEQ} rows")
            # the cta bodies past d 2560: a row across a CTA
            regs = {k: v[0] for k, v in report.items() if "_cta_kernel" in k}
            log(f"[build]   RMSNorm cta bodies' registers: {regs}")
            for dtype, code in (("bf16", 1), ("fp32", 0)):
                for d in WIDE_NORM_D:
                    f_threads, f_per_sm = rmsnorm._fwd_config(0, d, code)
                    rows, per_sm, sms, threads = rmsnorm._bwd_config(0, d,
                                                                     code)
                    check(f_threads > 0 and rows == 1,
                          f"RMSNorm at {dtype} d {d} does not take the cta "
                          f"bodies: forward {f_threads} threads, backward "
                          f"{rows} rows a CTA")
                    log(f"[build]   RMSNorm {dtype} d {d}: forward "
                        f"{f_threads // 32} warps a CTA, {f_per_sm} CTAs "
                        f"per SM; backward {threads // 32} warps a CTA, "
                        f"{per_sm} CTAs per SM ({per_sm * sms} partials "
                        f"rows)")
        else:
            # the bf16 forward and backward: products on mma.sync, no
            # spills
            for what, short, names in (
                    ("forward", "fwd", SSD_FWD_KERNELS),
                    ("backward", "bwd", SSD_BWD_KERNELS)):
                found = {k: v for k, v in report.items()
                         if any(k.startswith(n) for n in names)}
                check(len(found) >= 3 and all(
                    v[1] == (0, 0) for v in found.values()),
                      f"bf16 SSD {what} kernels missing or spilling: {found}")
                check(all(found.get(n, (0, 0, 0, 0))[3] > 0
                          for n in names if n != names[1]),
                      f"bf16 SSD {what} product kernels without HMMA: "
                      f"{found}")
                occ = (ctypes.c_int * 3)()
                entry = f"ssd_scan_{short}_occupancy"
                check(getattr(ctypes.CDLL(str(lib)), entry)(occ) == 0,
                      f"{entry} failed")
                log(f"[build]   bf16 SSD {what}, CTAs of 256 threads per SM: "
                    + ", ".join(f"{k} {n}" for k, n in zip(names, occ)))
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _i32(vals):
    import torch
    return torch.tensor(vals, dtype=torch.int32, device="cuda")


def flash_cases():
    """(name, B, S, T, kwargs): H=32, KV=8, dh=128 as in qwen3-4b."""
    return [
        ("prefill base 0", 4, 128, 512,
         dict(q_offset=_i32([0] * 4), kv_len=_i32([128, 100, 128, 0]))),
        ("prefill base 256", 4, 128, 512,
         dict(q_offset=_i32([256] * 4), kv_len=_i32([384, 300, 260, 0]))),
        ("decode mixed L", 8, 1, 512,
         dict(q_offset=_i32([0, 5, 100, 255, 256, 511, -1, 37]))),
        ("ragged S=77 T=333", 2, 77, 333, {}),
        ("window 100", 2, 300, 300, dict(window=100)),
        ("all-masked rows", 2, 128, 64, dict(window=1)),
        ("not causal, kv_len", 2, 64, 200,
         dict(causal=False, kv_len=_i32([200, 57]))),
        ("dense decode kv_len", 8, 1, DENSE_SERVE_CONTEXT,
         dict(causal=False, kv_len=_i32(
             [1, 2, 63, 64, 65, 1000, DENSE_SERVE_CONTEXT - 1,
              DENSE_SERVE_CONTEXT]))),
    ]


# (H, KV, dh) beside qwen3-4b's (32, 8, 128): GQA groups of 1, 5
# (qwen2.5-14b) and 8, which the bf16 kernel packs into one CTA's rows, and
# dh 64
GQA_SHAPES = [(8, 8, 128), (40, 8, 128), (16, 2, 128), (32, 8, 64),
              (10, 2, 64)]


def gqa_flash_cases():
    """(name, B, S, T, kwargs) at small sizes for every GQA_SHAPES entry:
    ragged S and T, a window, decode at positions from -1 to T - 1, and the
    dense engine's decode (non-causal, kv_len from 1 to T)."""
    return [("ragged S=77 T=333", 2, 77, 333, {}),
            ("window 50, lanes", 2, 130, 200,
             dict(window=50, q_offset=_i32([0, 3]), kv_len=_i32([200, 150]))),
            ("decode", 6, 1, 300,
             dict(q_offset=_i32([-1, 0, 5, 64, 200, 299]),
                  kv_len=_i32([300, 300, 3, 65, 150, 300]))),
            ("dense decode", 6, 1, 300,
             dict(causal=False, kv_len=_i32([1, 2, 64, 65, 150, 300])))]


def zamba2_flash_cases():
    """(name, B, S, T, kwargs) of zamba2's shared attention block (H = KV
    = 32, dh 64): the dense engine's decode over a 2048-token cache and the
    causal prefill of 2 x 2048 tokens."""
    return [("zamba2 decode kv_len", DENSE_SERVE_LANES, 1,
             DENSE_SERVE_CONTEXT, dict(causal=False, kv_len=_i32(
                 [1, 2, 63, 64, 65, 1000, DENSE_SERVE_CONTEXT - 1,
                  DENSE_SERVE_CONTEXT]))),
            ("zamba2 prefill", 2, 2048, 2048, {})]


def lse_flash_cases():
    """(name, B, S, T, H, KV, dh, kwargs) of phase 18's launches that
    write the row log-sum-exp or run on local heads: a rank's context
    slice of the dense engine's decode (4 lanes, 1024 of 2048 slots,
    kv_len 0 to 1024: a lane with no slot there gives +inf) and the
    TP-local paged decode (H 16, KV 4; an inactive lane at -1)."""
    return [("ctx-slice decode lse", 4, 1, 1024, 32, 8, 128,
             dict(causal=False, kv_len=_i32([0, 1, 500, 1024]))),
            ("TP paged decode lse", DECODE_SLOTS, 1, MAX_CONTEXT, 16, 4,
             128, dict(q_offset=_i32([0, 5, 100, 255, 256, 511, -1, 37]))),
            # phase 24's serving decode on a rank of WSHARD_TP_MESH: its 4
            # lanes over its half of the 448-slot self cache, every head
            ("whisper rank ctx-slice decode lse", WHISPER_TP_LOCAL[0], 1,
             WHISPER_CONTEXT // WSHARD_TP_MESH[1], *WHISPER_HEADS,
             dict(causal=False, kv_len=_i32(
                 [0, 1, 100, WHISPER_CONTEXT // WSHARD_TP_MESH[1]])))]


def moe_flash_cases(arch="arctic"):
    """(name, B, S, T, kwargs) of a MoE model's serving phase (19 for
    arctic-480b, 21 for kimi-k2), each name led by ``arch``: the paged
    decode (8 lanes, T 512) and prefill (4 x 128 at base 256), the dense
    engine's decode over a 2048-token cache and the causal prefill of 2 x
    256 tokens."""
    return [(f"{arch} decode", DECODE_SLOTS, 1, MAX_CONTEXT,
             dict(q_offset=_i32([0, 5, 100, 255, 256, 511, -1, 37]))),
            (f"{arch} prefill base 256", PREFILL_BATCH, PREFILL_CHUNK,
             MAX_CONTEXT, dict(q_offset=_i32([256] * PREFILL_BATCH),
                               kv_len=_i32([384, 300, 260, 0]))),
            (f"{arch} dense decode", DECODE_SLOTS, 1, DENSE_SERVE_CONTEXT,
             dict(causal=False, kv_len=_i32(
                 [1, 2, 63, 64, 65, 1000, DENSE_SERVE_CONTEXT - 1,
                  DENSE_SERVE_CONTEXT]))),
            (f"{arch} prefill 2 x 256", DECODE_VS_PREFILL_LANES,
             DECODE_VS_PREFILL_T, DECODE_VS_PREFILL_T, {})]


def whisper_flash_cases():
    """(name, B, S, T, kwargs) of phase 22 at whisper-medium's heads (H =
    KV = 16, dh 64), 8 lanes: the encoder's non-causal S = T = 1500 (a
    ragged tail of 28 keys past 23 tiles of 64), cross-attention's 32
    prefill queries and one decode query over the 1500 encoder rows, the
    decoder's causal prefill of 32 tokens and its decode over a
    448-slot cache."""
    F, L, C = WHISPER_FRAMES, WHISPER_TOKENS, WHISPER_CONTEXT
    return [("whisper encoder", WHISPER_LANES, F, F, dict(causal=False)),
            ("whisper cross prefill", WHISPER_LANES, L, F,
             dict(causal=False)),
            ("whisper cross decode", WHISPER_LANES, 1, F,
             dict(causal=False)),
            ("whisper self prefill", WHISPER_LANES, L, L, {}),
            ("whisper self decode", WHISPER_LANES, 1, C,
             dict(causal=False, kv_len=_i32(
                 [1, 2, 31, 32, 64, 65, 300, C])))]


def whisper_rank_flash_cases():
    """(name, B, S, T, kwargs) of phase 24 on a rank of WSHARD_TP_MESH at
    its TP-local heads (H = KV = 8, dh 64, 4 lanes): the encoder's
    non-causal S = T = 1500, cross-attention's 448 training queries, 16
    prefill queries and one decode query over the 1500 encoder rows, and
    the decoder's causal self-attention over 448 and 16 tokens."""
    B, F, C = WHISPER_TP_LOCAL[0], WHISPER_FRAMES, WHISPER_CONTEXT
    n = WSHARD_TOKENS
    return [("whisper rank encoder", B, F, F, dict(causal=False)),
            ("whisper rank cross train", B, C, F, dict(causal=False)),
            ("whisper rank cross prefill", B, n, F, dict(causal=False)),
            ("whisper rank cross decode", B, 1, F, dict(causal=False)),
            ("whisper rank self train", B, C, C, {}),
            ("whisper rank self prefill", B, n, n, {})]


def phase_kernels():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    g = torch.Generator(device="cuda").manual_seed(0)
    errs = {"flash_attention": 0.0, "rmsnorm": 0.0}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        cases = [(name, B, S, T, 32, 8, 128, kw)
                 for name, B, S, T, kw in flash_cases()]
        cases += [(name, B, S, T, H, KV, dh, kw)
                  for H, KV, dh in GQA_SHAPES
                  for name, B, S, T, kw in gqa_flash_cases()]
        cases += [(name, B, S, T, *ZAMBA2_HEADS, kw)
                  for name, B, S, T, kw in zamba2_flash_cases()]
        # phase 17: zamba2's shared block at its TP-local heads
        cases.append(("zamba2 TP-local", SSMTP_LOCAL_BATCH, SSMTP_SEQ,
                      SSMTP_SEQ, *ZAMBA2_TP_HEADS, {}))
        # phase 19: arctic-480b's GQA group of 7
        cases += [(name, B, S, T, *ARCTIC_HEADS, kw)
                  for name, B, S, T, kw in moe_flash_cases()]
        # phase 20: a TP rank's heads on the paged decode and prefill, an
        # EP rank's two lanes of the dense decode
        cases += [(f"{name} TP", B, S, T, *ARCTIC_TP_HEADS, kw)
                  for name, B, S, T, kw in moe_flash_cases()[:2]]
        cases.append(("arctic EP dense decode", MOE_EP_LANES, 1,
                      DENSE_SERVE_CONTEXT, *ARCTIC_HEADS,
                      dict(causal=False, kv_len=_i32([1, 1500]))))
        # phase 22: whisper-medium's encoder, decoder and cross-attention
        cases += [(name, B, S, T, *WHISPER_HEADS, kw)
                  for name, B, S, T, kw in whisper_flash_cases()]
        # phase 24: a TP rank's (a second call must give the same bits)
        cases += [(name, B, S, T, *WHISPER_TP_LOCAL[1:], kw)
                  for name, B, S, T, kw in whisper_rank_flash_cases()]
        for name, B, S, T, H, KV, dh, kw in cases:
            q = torch.randn(B, S, H, dh, generator=g, device="cuda").to(dt)
            k = torch.randn(B, T, KV, dh, generator=g, device="cuda").to(dt)
            v = torch.randn(B, T, KV, dh, generator=g, device="cuda").to(dt)
            out = flash_attention_cuda(q, k, v, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, **kw)
            err = (out.float() - want.float()).abs().max().item()
            log(f"[flash] {dtype:8s} H {H:2d} KV {KV} dh {dh:3d} {name:20s} "
                f"max|diff| {err:.3e} (tol {TOL[dtype]:.0e})")
            check(err <= TOL[dtype], f"flash {name} H {H} KV {KV} dh {dh} "
                  f"{dtype}: {err}")
            if name == "all-masked rows":
                check(bool((out[:, 64:] == 0).all()),
                      "rows with no admissible key are not exact zeros")
            if name == "decode":
                check(bool((out[0] == 0).all()),
                      "a decode row with no admissible key is not zeros")
            if name.startswith("whisper rank"):
                check(same_bits(out, flash_attention_cuda(q, k, v, **kw)),
                      f"flash {name} {dtype}: a second call gave other bits")
            errs["flash_attention"] = max(errs["flash_attention"], err)
        for name, B, S, T, H, KV, dh, kw in lse_flash_cases():
            q = torch.randn(B, S, H, dh, generator=g, device="cuda").to(dt)
            k = torch.randn(B, T, KV, dh, generator=g, device="cuda").to(dt)
            v = torch.randn(B, T, KV, dh, generator=g, device="cuda").to(dt)
            out, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, **kw)
            want_lse = ref.flash_attention_lse_ref(q, k, v, **kw)
            err = (out.float() - want.float()).abs().max().item()
            empty = want_lse == float("inf")
            e_lse = (lse - want_lse).masked_fill(empty, 0).abs().max().item()
            log(f"[flash] {dtype:8s} H {H:2d} KV {KV} dh {dh:3d} {name:20s} "
                f"max|diff| {err:.3e}, lse {e_lse:.3e} (tol "
                f"{TOL[dtype]:.0e}); {int(empty.sum())} rows with no key")
            check(err <= TOL[dtype] and e_lse <= TOL[dtype],
                  f"flash {name} {dtype}: out {err}, lse {e_lse}")
            check(bool(torch.equal(lse == float("inf"), empty))
                  and bool(empty.any()), f"flash {name} {dtype}: the rows "
                  "with no admissible key are not the +inf rows")
            if name.startswith("whisper rank"):
                check(same_bits((out, lse), flash_attention_cuda(
                    q, k, v, with_lse=True, **kw)), f"flash {name} {dtype}: "
                    "a second call gave other bits")
            errs["flash_attention"] = max(errs["flash_attention"], err)
        # serving: prefill and decode rows at d_model and head_dim, and
        # SSM decode rows (8 x 1024: mamba2's ln1; 8 x 2048: its gated norm
        # and zamba2's ln1; 8 x 4096: zamba2's gated norm); training: ln1 /
        # final_norm at d_model, the gated norm at d_inner; sequence
        # parallel: the QK-norm of one rank's q and k; phase 17: a rank's
        # rows of mamba2 (1024, 2048) and zamba2 (2048, 4096)
        for shape in [(SSMTP_ROWS, 1024), (SSMTP_ROWS, 2048),
                      (SSMTP_ROWS, 4096),
                      (PREFILL_BATCH * PREFILL_CHUNK, 2560),
                      (PREFILL_BATCH * PREFILL_CHUNK * 32, 128),
                      (DECODE_SLOTS, 2560), (DECODE_SLOTS * 32, 128),
                      (DECODE_SLOTS, 1024), (DECODE_SLOTS, 2048),
                      (DECODE_SLOTS, 4096),
                      (TRAIN_BATCH * TRAIN_SEQ, 1024),
                      (TRAIN_BATCH * TRAIN_SEQ, 2048),
                      (SP_LOCAL * 32, 128), (SP_LOCAL * 8, 128),
                      # phase 19: arctic-480b's decode and prefill rows
                      (DECODE_SLOTS, 7168),
                      (PREFILL_BATCH * PREFILL_CHUNK, 7168),
                      # phase 20: an EP rank's decode rows
                      (MOE_EP_LANES, 7168)]:
            x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dt)
            w = torch.randn(shape[-1], generator=g, device="cuda").to(dt)
            check_rmsnorm(x, w, dtype, str(shape), errs)
    # the unaligned body: rows of a bf16 view at storage offset 1
    x, w = unaligned_rows(g, 777, 2560, 3.0)
    check_rmsnorm(x, w, "bfloat16", "(777, 2560) at offset 1", errs)
    rmsnorm_edges(g, errs)
    return errs


def rmsnorm_edges(g, errs):
    """The forward past the register bodies where the cta body does not
    take the rows, which run the looped kernel: rows at storage offset 1
    and w in fp32 beside bf16 x at d 6144; odd d (3001); d past the cta
    body (bf16 16392, fp32 8200).  And the cta body at bf16 d 12288."""
    import torch

    x, w = unaligned_rows(g, 77, 6144, 3.0)
    check_rmsnorm(x, w, "bfloat16", "(77, 6144) at offset 1", errs)
    x = (torch.randn(33, 6144, generator=g, device="cuda") * 3).bfloat16()
    check_rmsnorm(x, torch.randn(6144, generator=g, device="cuda"),
                  "bfloat16", "(33, 6144) w fp32", errs)
    for dtype, shape in (("bfloat16", (65, 3001)), ("float32", (65, 3001)),
                         ("bfloat16", (5, 12288)), ("bfloat16", (9, 16392)),
                         ("float32", (9, 8200))):
        dt = getattr(torch, dtype)
        x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dt)
        w = torch.randn(shape[-1], generator=g, device="cuda").to(dt)
        check_rmsnorm(x, w, dtype, str(shape), errs)


def unaligned_rows(g, rows, d, scale):
    """x (rows, d) bf16, a view at storage offset 1 (its base and rows off
    the 16-byte grid), and w (d,) bf16."""
    import torch
    flat = (torch.randn(rows * d + 1, generator=g, device="cuda")
            * scale).bfloat16()
    x = flat[1:].view(rows, d)
    check(x.data_ptr() % 16 != 0, "the unaligned case is aligned")
    return x, torch.randn(d, generator=g, device="cuda").bfloat16()


def check_rmsnorm(x, w, dtype, what, errs):
    """The forward kernel against rmsnorm_ref: fp32 within TOL, bf16 within
    one ulp (fp32 math, one bf16 rounding)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    out = rmsnorm_cuda(x, w, 1e-6).float()
    torch.cuda.synchronize()
    want = ref.rmsnorm_ref(x, w, 1e-6).float()
    err = (out - want).abs().max().item()
    if dtype == "float32":
        ok, tol = err <= TOL[dtype], f"{TOL[dtype]:.0e}"
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - 7)
        ok, tol = bool(((out - want).abs() <= ulp).all()), "1 ulp"
    log(f"[rmsnorm] {dtype:8s} {what:14s} max|diff| {err:.3e} (tol {tol})")
    check(ok, f"rmsnorm {what} {dtype}: {err}")
    errs["rmsnorm"] = max(errs["rmsnorm"], err)


def partial_cases():
    """(delta, window) of the panel visits at S_loc = T_loc = 8192, causal:
    the diagonal visit, a panel wholly behind the q shard (fully visible),
    one just ahead and one far ahead (causally dead), and an offset off the
    64-row tiles; each also with a 4096-token window."""
    return [(delta, window) for delta in (0, SP_LOCAL, -SP_LOCAL,
                                          -3 * SP_LOCAL, 1000)
            for window in (None, 4096)]


def _partial_visit(q, k, v, delta, window, dtype, what, errs):
    """One panel visit of the kernel against its plain version: the rows
    with keys the same, empty rows exactly (0, -1e30, 0), the rest within
    PARTIAL_TOL."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ring_attention import flash_partial_cuda

    got = flash_partial_cuda(q, k, v, delta, causal=True, window=window)
    torch.cuda.synchronize()
    want = ref.flash_partial_ref(q, k, v, delta, causal=True, window=window)
    label = f"flash_partial {dtype} {what} delta {delta} window {window}"
    seen = want[2][..., 0] > 0
    check(torch.equal(got[2][..., 0] > 0, seen),
          f"{label}: rows with keys differ")
    empty = ~seen
    check(bool((got[0][empty] == 0).all()
               and (got[1][empty] == -1e30).all()
               and (got[2][empty] == 0).all()),
          f"{label}: empty rows are not exactly (0, -1e30, 0)")
    rel = [rel_err(a[seen], b[seen]) if seen.any() else 0.0
           for a, b in zip(got, want)]
    log(f"[flash_partial] {dtype:8s} {what:20s} delta {delta:6d} window "
        f"{str(window):4s}: rows with keys {seen.sum().item():7d} of "
        f"{seen.numel()}; max|diff|/max|ref| acc {rel[0]:.2e}, "
        f"m {rel[1]:.2e}, l {rel[2]:.2e} (tol "
        f"{PARTIAL_TOL[dtype]:.0e}); empty rows exact")
    check(max(rel) <= PARTIAL_TOL[dtype], f"{label}: {rel}")
    if seen.any():
        errs["flash_partial"] = max(errs.get("flash_partial", 0.0), *(
            (a[seen] - b[seen]).abs().max().item()
            for a, b in zip(got, want)))


def _partial_shapes(shapes, g, errs):
    """Panel visits for each (n, H, KV, dh, [(delta, window)]) of
    ``shapes``, B 1, S_loc = T_loc = n, in bf16 and fp32."""
    import torch
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for n, H, KV, dh, cases in shapes:
            q = torch.randn(1, n, H, dh, generator=g, device="cuda").to(dt)
            k = torch.randn(1, n, KV, dh, generator=g, device="cuda").to(dt)
            v = torch.randn(1, n, KV, dh, generator=g, device="cuda").to(dt)
            for delta, window in cases:
                _partial_visit(q, k, v, delta, window, dtype,
                               f"S=T={n} H {H} KV {KV} dh {dh}", errs)
            del q, k, v
    torch.cuda.empty_cache()


# a panel visit's small cases: (delta, window) at 300 local queries and keys
SMALL_VISITS = [(d, w) for d in (0, 300, -300, 37) for w in (None, 100)]


def phase_partial(errs):
    """Ring attention's panel-visit kernel against its plain version at
    qwen3-4b width (H 32, KV 8, dh 128), B 1, S_loc = T_loc = 8192, and at
    300 local queries and keys for every GQA_SHAPES entry."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(7)
    errs["flash_partial"] = 0.0
    _partial_shapes([(SP_LOCAL, 32, 8, 128, partial_cases())]
                    + [(300, H, KV, dh, SMALL_VISITS)
                       for H, KV, dh in GQA_SHAPES], g, errs)


def phase_bf16_p():
    """Why the bf16 panel-visit kernel splits P: the plain version's
    arithmetic on the visible 8192 x 8192 visit at qwen3-4b width, with P
    V taken from P rounded to bf16 (the usual tensor-core step) and from P
    split into bf16 P_hi + P_lo (the kernel's step), against fp32 P.  Logs
    each acc's error relative to its largest magnitude; the split must hold
    the bf16 panel tolerance."""
    import torch
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(8)
    S, H, KV, dh, delta = SP_LOCAL, 32, 8, 128, SP_LOCAL
    q = torch.randn(1, S, KV, H // KV, dh, generator=g, device="cuda")
    k = torch.randn(1, S, KV, dh, generator=g, device="cuda")
    v = torch.randn(1, S, KV, dh, generator=g, device="cuda")
    q, k, v = (x.bfloat16().float() for x in (q, k, v))
    s = torch.einsum("bskgd,btkd->bkgst", q, k).mul_(dh ** -0.5)
    mask = ref.attn_mask(1, S, S, q.device, causal=True, window=None,
                         q_offset=_i32([delta]), kv_len=None)[:, None, None]
    p = s.masked_fill_(~mask, ref.NEG_INF)
    p = p.sub_(p.amax(-1, keepdim=True)).exp_().masked_fill_(~mask, 0.0)
    del s, mask
    acc = torch.einsum("bkgst,btkd->bkgsd", p, v)
    hi = p.bfloat16().float()
    p.sub_(hi)                                  # p is now P - P_hi
    acc_hi = torch.einsum("bkgst,btkd->bkgsd", hi, v)
    del hi
    acc_split = acc_hi + torch.einsum("bkgst,btkd->bkgsd",
                                      p.bfloat16().float(), v)
    del p
    err_hi, err_split = rel_err(acc_hi, acc), rel_err(acc_split, acc)
    log(f"[bf16-P] visible visit S=T={S} H={H} KV={KV} dh={dh}: acc "
        f"max|diff|/max|ref| with P rounded to bf16 {err_hi:.2e}, with P "
        f"split into two bf16 terms {err_split:.2e} (panel tol "
        f"{PARTIAL_TOL['bfloat16']:.0e})")
    check(err_split <= PARTIAL_TOL["bfloat16"],
          f"split P misses the panel tolerance: {err_split}")
    del acc, acc_hi, acc_split
    torch.cuda.empty_cache()


def phase_bf16_pds():
    """Whether the bf16 flash backward may round P and dS to bf16 before
    dV = P^T dO, dQ = scale dS K and dK = scale dS^T Q: the plain
    backward's arithmetic (``flash_attention_bwd_ref``) at the dense
    training shape, with the three products taken from P and dS rounded to
    bf16 (the kernels' step) and from P and dS split into bf16 hi + lo,
    against fp32 P and dS.  Logs each gradient's error relative to its
    largest magnitude; rounding must stay within BWD_ROUND_TOL."""
    import torch
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(11)
    B, S, H, KV, dh = DENSE_BATCH, DENSE_SEQ, 32, 8, 128
    G, scale = H // KV, dh ** -0.5
    q, do = (torch.randn(B, S, H, dh, generator=g, device="cuda")
             .bfloat16().float() for _ in range(2))
    k, v = (torch.randn(B, S, KV, dh, generator=g, device="cuda")
            .bfloat16().float() for _ in range(2))
    o = ref.flash_attention_ref(q, k, v)
    lse = ref.flash_attention_lse_ref(q, k, v)
    qg, dog = (x.reshape(B, S, KV, G, dh) for x in (q, do))
    rows = lse.reshape(B, S, KV, G).permute(0, 2, 3, 1)[..., None]
    mask = ref.attn_mask(B, S, S, q.device, causal=True, window=None,
                         q_offset=None, kv_len=None)[:, None, None]
    p = torch.einsum("bskgd,btkd->bkgst", qg, k).mul_(scale)
    p = p.sub_(rows).exp_().masked_fill_(~mask, 0.0)
    del rows, mask
    dlt = (dog * o.reshape(B, S, KV, G, dh)).sum(-1)
    ds = torch.einsum("bskgd,btkd->bkgst", dog, v)
    ds = ds.sub_(dlt.permute(0, 2, 3, 1)[..., None]).mul_(p)

    def products(pp, dd):               # dq, dk, dv
        return (torch.einsum("bkgst,btkd->bskgd", dd, k).mul_(scale),
                torch.einsum("bkgst,bskgd->btkd", dd, qg).mul_(scale),
                torch.einsum("bkgst,bskgd->btkd", pp, dog))

    def bf16(x):
        return x.bfloat16().float()

    exact = products(p, ds)
    rounded = products(bf16(p), bf16(ds))
    e_round = [rel_err(a, b) for a, b in zip(rounded, exact)]
    del rounded
    p_hi, ds_hi = bf16(p), bf16(ds)
    hi = products(p_hi, ds_hi)
    p, ds = p.sub_(p_hi), ds.sub_(ds_hi)        # the low parts' exact values
    del p_hi, ds_hi
    lo = products(bf16(p), bf16(ds))
    e_split = [rel_err(a + b, c) for a, b, c in zip(hi, lo, exact)]
    del p, ds, hi, lo, exact
    torch.cuda.empty_cache()
    log(f"[bf16-PdS] flash backward B={B} S={S} H={H} KV={KV} dh={dh} "
        f"causal: dq, dk, dv max|diff|/max|ref| with P and dS rounded to "
        f"bf16 {', '.join(f'{e:.2e}' for e in e_round)}, split into two "
        f"bf16 terms {', '.join(f'{e:.2e}' for e in e_split)} (rule: round "
        f"within {BWD_ROUND_TOL:.0e}, half the bf16 tol); the kernels round")
    check(max(e_round) <= BWD_ROUND_TOL,
          f"P and dS rounded to bf16 miss {BWD_ROUND_TOL}: {e_round}")


def ssd_inputs(B, S, H, P, N, dtype, seed=0):
    """SSD scan inputs as ``models/ssm.py`` makes them: leaves that need
    gradients, and a function of the leaves giving what the scan takes (dt
    = softplus, A = -exp(A_log), Bm/Cm one (B,S,1,N) group for all heads)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(shape, dt=dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dt).requires_grad_()

    x, dt_raw = rand((B, S, H, P)), rand((B, S, H), torch.float32)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device="cuda"))
    a_log.requires_grad_()
    bg, cg = rand((B, S, 1, N), scale=0.5), rand((B, S, 1, N), scale=0.5)
    leaves = (x, dt_raw, a_log, bg, cg)

    def views(x, dt_raw, a_log, bg, cg):
        return x, F.softplus(dt_raw), -torch.exp(a_log), bg, cg

    return leaves, views


def ssd_cases():
    """(name, B, S, H, P, N, chunk, dtypes): the reduced and full widths,
    ragged S, S below a chunk, three heads of A from 1 to 16, one layer at
    the training shape, one zamba2 layer (H 64, P 64, N 64) at the
    prefill of phase 12, and the TP-local layers of phase 17 (a rank's 2 x
    2048 tokens on half the heads)."""
    return [
        ("reduced width", 2, 64, 8, 64, 16, 16, ("float32", "bfloat16")),
        ("ragged S=333", 2, 333, 8, 64, 128, 64, ("float32", "bfloat16")),
        ("S=40 < chunk", 1, 40, 4, 64, 128, 64, ("float32", "bfloat16")),
        ("S=100 H=3", 1, 100, 3, 64, 128, 64, ("float32",)),
        ("training layer", TRAIN_BATCH, TRAIN_SEQ, 32, 64, 128, 64,
         ("bfloat16",)),
        ("zamba2 prefill", 2, 2048, 64, 64, 64, 64, ("float32", "bfloat16")),
        ("mamba2 TP-local", SSMTP_LOCAL_BATCH, SSMTP_SEQ, 16, 64, 128, 64,
         ("bfloat16",)),
        ("zamba2 TP-local", SSMTP_LOCAL_BATCH, SSMTP_SEQ, 32, 64, 64, 64,
         ("bfloat16",)),
    ]


def phase_train_kernels(errs):
    """The training path's kernels against torch.autograd of their plain
    versions: the SSD scan forward and backward (at the training shape also
    bitwise-stable across two calls), the RMSNorm backward (also on
    unaligned views, with w in fp32, past d 2560 in the cta body and past
    it in the looped kernel, and dw bitwise-stable across two calls)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import RMSNorm, rmsnorm_bwd_cuda
    from repro_torch.kernels.ssd_scan import SSDScan

    errs.update(ssd_scan=0.0, ssd_scan_bwd=0.0, rmsnorm_bwd=0.0)
    for name, B, S, H, P, N, chunk, dtypes in ssd_cases():
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            leaves, views = ssd_inputs(B, S, H, P, N, dt)
            dy = torch.randn(B, S, H, P, device="cuda").to(dt)
            y = SSDScan.apply(*views(*leaves), chunk)
            grads = torch.autograd.grad(y, leaves, dy)
            torch.cuda.synchronize()
            check(all(g.shape == t.shape for g, t in zip(grads, leaves)),
                  f"ssd_scan_bwd {name} {dtype}: gradient shapes")
            y_ref = ref.ssd_scan_ref(*views(*leaves), chunk)
            grads_ref = torch.autograd.grad(y_ref, leaves, dy)
            outs, plain = (y, *grads), (y_ref, *grads_ref)
            if dtype == "float32":      # the float64 plain version decides
                leaves64 = tuple(t.detach().double().requires_grad_()
                                 for t in leaves)
                y64 = ref.ssd_scan_ref(*views(*leaves64), chunk)
                wit = (y64, *torch.autograd.grad(y64, leaves64, dy.double()))
                del leaves64, y64
            msg = []
            for gname, gk, gr, i in zip(("y", "dx", "ddt", "dA", "dB", "dC"),
                                        outs, plain, range(6)):
                kernel = "ssd_scan" if gname == "y" else "ssd_scan_bwd"
                if dtype == "float32":
                    err, err_plain = rel_err(gk, wit[i]), rel_err(gr, wit[i])
                    tol = max(REL_TOL[dtype], 2 * err_plain)
                    msg.append(f"{gname} {err:.2e} (fp32 plain "
                               f"{err_plain:.2e})")
                    errs[kernel] = max(errs[kernel], (
                        gk.double() - wit[i]).abs().max().item())
                else:
                    err, tol = rel_err(gk, gr), REL_TOL[dtype]
                    msg.append(f"{gname} {err:.2e}")
                    errs[kernel] = max(errs[kernel], (
                        gk.float() - gr.float()).abs().max().item())
                check(err <= tol, f"{kernel} {name} {dtype}: {gname} "
                      f"{err} > {tol}")
            oracle = ("float64 plain" if dtype == "float32"
                      else "fp32 plain")
            log(f"[ssd] {dtype:8s} {name:15s} B={B} S={S} H={H} P={P} N={N} "
                f"Q={chunk}: max|diff|/max|ref| vs the {oracle} version: "
                + ", ".join(msg) + f" (tol {REL_TOL[dtype]:.0e})")
            if name == "training layer":
                # each head's dB and dC terms written once and summed in a
                # fixed order: the same bits on a second call
                again = torch.autograd.grad(
                    SSDScan.apply(*views(*leaves), chunk), leaves, dy)
                same = all(torch.equal(a, b) for a, b in zip(again, grads))
                log(f"[ssd] {dtype:8s} {name:15s} gradients of a second "
                    f"call bitwise equal: {same}")
                check(same, f"ssd_scan_bwd {name}: the gradients differ "
                      "between two calls")
                del again
            del leaves, views, y, grads, y_ref, grads_ref, outs, plain
            if dtype == "float32":
                del wit
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    qk_rows = DENSE_BATCH * DENSE_SEQ * 8        # the k-norm; q-norm x 4
    for dtype, shape in (("bfloat16", (TRAIN_BATCH * TRAIN_SEQ, 1024)),
                         ("bfloat16", (TRAIN_BATCH * TRAIN_SEQ, 2048)),
                         ("bfloat16", (SSMTP_ROWS, 1024)),
                         ("bfloat16", (SSMTP_ROWS, 2048)),
                         ("bfloat16", (SSMTP_ROWS, 4096)),
                         ("bfloat16", (qk_rows, 128)),
                         ("bfloat16", (4 * qk_rows, 128)),
                         ("bfloat16", (3, 5, 2560)),
                         ("float32", (777, 2048)), ("float32", (5, 100)),
                         # past the register bodies: the cta body at
                         # qwen2-72b's width, at odd d (its scalar body)
                         # and at the edge of its shared memory; the
                         # looped kernel past it
                         ("bfloat16", QWEN72_NORM_BWD),
                         ("bfloat16", (65, 3001)), ("bfloat16", (5, 12288)),
                         ("float32", (300, 8192)), ("bfloat16", (9, 16392)),
                         ("float32", (9, 8200))):
        dt = getattr(torch, dtype)
        x = (torch.randn(shape, generator=g, device="cuda") * 2).to(dt)
        cases.append((dtype, str(shape), x,
                      torch.randn(shape[-1], generator=g,
                                  device="cuda").to(dt)))
    # the unaligned body: rows of a bf16 view at storage offset 1, and the
    # cta body's at d 6144; w in fp32 beside bf16 x
    cases.append(("bfloat16", "(777, 2560) at offset 1",
                  *unaligned_rows(g, 777, 2560, 2.0)))
    cases.append(("bfloat16", "(77, 6144) at offset 1",
                  *unaligned_rows(g, 77, 6144, 2.0)))
    cases.append(("bfloat16", "(33, 6144) w fp32",
                  (torch.randn(33, 6144, generator=g, device="cuda")
                   * 2).bfloat16(),
                  torch.randn(6144, generator=g, device="cuda")))
    for dtype, what, x, w in cases:
        dy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
        x.requires_grad_()
        w.requires_grad_()
        got = torch.autograd.grad(RMSNorm.apply(x, w, 1e-5), (x, w), dy)
        torch.cuda.synchronize()
        want = torch.autograd.grad(ref.rmsnorm_ref(x, w, 1e-5), (x, w), dy)
        e_dx, e_dw = rel_err(got[0], want[0]), rel_err(got[1], want[1])
        log(f"[rmsnorm_bwd] {dtype:8s} {what:14s} max|diff|/max|ref| "
            f"dx {e_dx:.2e}, dw {e_dw:.2e} (tol {REL_TOL[dtype]:.0e})")
        check(max(e_dx, e_dw) <= REL_TOL[dtype],
              f"rmsnorm_bwd {what} {dtype}: dx {e_dx}, dw {e_dw}")
        errs["rmsnorm_bwd"] = max(errs["rmsnorm_bwd"], *(
            (a.float() - b.float()).abs().max().item()
            for a, b in zip(got, want)))
        if what == str((TRAIN_BATCH * TRAIN_SEQ, 2048)):
            # a fixed partition and fixed-order sums: the same dw bits
            again = rmsnorm_bwd_cuda(dy, x.detach(), w.detach(), 1e-5)[1]
            same = torch.equal(again, got[1])
            log(f"[rmsnorm_bwd] {dtype:8s} {what:14s} dw of a second call "
                f"bitwise equal: {same}")
            check(same, f"rmsnorm_bwd {what}: dw differs between two calls")


def flash_bwd_check(q, k, v, do, causal, window, what, errs,
                    key="flash_attention_bwd"):
    """The forward with its row log-sum-exp and the backward kernels on one
    case, held against the plain versions (``flash_attention_lse_ref``,
    ``flash_attention_bwd_ref`` on the kernel's output and log-sum-exp)
    and against ``torch.autograd`` of ``flash_attention_ref``; the largest
    |difference| from the plain version goes to ``errs[key]``.  Returns
    (out, lse, (dq, dk, dv)) of the kernels."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)

    dtype = str(q.dtype).split(".")[1]
    kw = dict(causal=causal, window=window)
    out, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    e_lse = (lse - ref.flash_attention_lse_ref(q, k, v, **kw)).abs().max()
    e_lse = e_lse.item()
    plain = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, **kw)
    e_plain = [rel_err(a, b) for a, b in zip(got, plain)]
    errs[key] = max(errs.get(key, 0.0), *(
        (a.float() - b.float()).abs().max().item()
        for a, b in zip(got, plain)))
    del plain
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(ref.flash_attention_ref(*leaves, **kw),
                               leaves, do)
    e_auto = [rel_err(a, b) for a, b in zip(got, auto)]
    del auto, leaves
    log(f"[flash_bwd] {dtype:8s} {what:40s} max|diff|/max|ref| of dq, dk, "
        f"dv vs plain {', '.join(f'{e:.2e}' for e in e_plain)}; vs "
        f"autograd {', '.join(f'{e:.2e}' for e in e_auto)} (tol "
        f"{REL_TOL[dtype]:.0e}); lse max|diff| {e_lse:.2e} (tol "
        f"{TOL[dtype]:.0e})")
    check(max(e_plain + e_auto) <= REL_TOL[dtype],
          f"flash backward {what} {dtype}: {e_plain} {e_auto}")
    check(e_lse <= TOL[dtype], f"flash lse {what} {dtype}: {e_lse}")
    return out, lse, got


def phase_flash_bwd(errs):
    """The flash backward at S = 100 over the small cases, then at the dense
    training shape, run twice there: the same bits both times."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda

    errs["flash_attention_bwd"] = 0.0
    g = torch.Generator(device="cuda").manual_seed(9)

    def rand(dt, *shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for H, KV in FLASH_BWD_GROUPS:
            for dh in (64, 128):
                q, do = rand(dt, 2, 100, H, dh), rand(dt, 2, 100, H, dh)
                k, v = rand(dt, 2, 100, KV, dh), rand(dt, 2, 100, KV, dh)
                for causal, window in FLASH_BWD_MASKS:
                    flash_bwd_check(
                        q, k, v, do, causal, window,
                        f"S=100 H {H} KV {KV} dh {dh} "
                        f"{'causal' if causal else 'bidir'} window {window}",
                        errs)
    B, S, H, KV, dh = DENSE_BATCH, DENSE_SEQ, 32, 8, 128
    bf16 = torch.bfloat16
    q, do = rand(bf16, B, S, H, dh), rand(bf16, B, S, H, dh)
    k, v = rand(bf16, B, S, KV, dh), rand(bf16, B, S, KV, dh)
    out, lse, got = flash_bwd_check(q, k, v, do, True, None,
                                    f"B={B} S={S} H={H} KV={KV} dh={dh}", errs)
    again = flash_attention_bwd_cuda(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[flash_bwd] bfloat16 B={B} S={S}: dq, dk, dv of a second call "
        f"bitwise equal: {same}")
    check(same, "flash backward: a second call gave other bits")
    del q, do, k, v, out, lse, got, again
    # phase 17: zamba2's shared block at its TP-local heads
    B, S, (H, KV, dh) = SSMTP_LOCAL_BATCH, SSMTP_SEQ, ZAMBA2_TP_HEADS
    q, do = rand(bf16, B, S, H, dh), rand(bf16, B, S, H, dh)
    k, v = rand(bf16, B, S, KV, dh), rand(bf16, B, S, KV, dh)
    flash_bwd_check(q, k, v, do, True, None,
                    f"B={B} S={S} H={H} KV={KV} dh={dh}", errs)
    del q, do, k, v
    torch.cuda.empty_cache()


def phase_k13(errs):
    """The flash kernels at kimi-k2-1t-a32b's heads (H 64, KV 8, dh 112:
    tiles padded to 128 columns), bf16 and fp32, against their plain
    versions at phase 2's gates: the forward at phase 21's paged decode
    (8 lanes, T 512) and prefill chunk (4 x 128 at base 256), the dense
    engine's decode and phase 21 (b)'s causal prefill of 2 x 256; the
    backward's small cases at dh 112 (S 100, GQA groups of 1, 5 and 8, the
    training masks); the causal training shape (B 1, S 4096) for the
    forward with its row log-sum-exp and the backward, whose second call
    must give the same bits; ring attention's panel visit at 300 local
    queries and keys."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)

    t0 = time.perf_counter()
    for key in ("flash_attention", "flash_attention_bwd", "flash_partial"):
        errs.setdefault(key, 0.0)
    g = torch.Generator(device="cuda").manual_seed(13)

    def rand(dt, *shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    H, KV, dh = KIMI_HEADS
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for name, B, S, T, kw in moe_flash_cases("kimi"):
            q, k, v = rand(dt, B, S, H, dh), rand(dt, B, T, KV, dh), \
                rand(dt, B, T, KV, dh)
            out = flash_attention_cuda(q, k, v, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, **kw)
            err = (out.float() - want.float()).abs().max().item()
            log(f"[k13] {dtype:8s} H {H} KV {KV} dh {dh} {name:24s} "
                f"max|diff| {err:.3e} (tol {TOL[dtype]:.0e})")
            check(err <= TOL[dtype], f"flash {name} {dtype}: {err}")
            errs["flash_attention"] = max(errs["flash_attention"], err)
        for Hs, KVs in FLASH_BWD_GROUPS:
            q, do = rand(dt, 2, 100, Hs, dh), rand(dt, 2, 100, Hs, dh)
            k, v = rand(dt, 2, 100, KVs, dh), rand(dt, 2, 100, KVs, dh)
            for causal, window in FLASH_BWD_MASKS:
                flash_bwd_check(
                    q, k, v, do, causal, window,
                    f"S=100 H {Hs} KV {KVs} dh {dh} "
                    f"{'causal' if causal else 'bidir'} window {window}",
                    errs)
        B, S = KIMI_TRAIN
        q, do = rand(dt, B, S, H, dh), rand(dt, B, S, H, dh)
        k, v = rand(dt, B, S, KV, dh), rand(dt, B, S, KV, dh)
        out, lse, got = flash_bwd_check(
            q, k, v, do, True, None, f"B={B} S={S} H={H} KV={KV} dh={dh}",
            errs)
        again = flash_attention_bwd_cuda(q, k, v, out, do, lse)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"[k13] {dtype} B={B} S={S} H={H} KV={KV} dh={dh}: dq, dk, dv "
            f"of a second call bitwise equal: {same}")
        check(same, f"flash backward at dh {dh} {dtype}: a second call "
              "gave other bits")
        del q, do, k, v, out, lse, got, again
        torch.cuda.empty_cache()
    _partial_shapes([(300, H, KV, dh, SMALL_VISITS)], g, errs)
    log(f"[k13] the flash kernels at dh {dh} held against their plain "
        f"versions in {time.perf_counter() - t0:.1f} s")


def phase_k14(errs):
    """K14, the flash backward at S != T (cross-attention: no mask), bf16
    and fp32, against its plain version and ``torch.autograd`` of the
    plain forward at ``REL_TOL`` (:func:`flash_bwd_check`), at
    ``K14_CASES``: whisper-medium's decoder over its encoder (B 8, S 448,
    T 1500, H = KV = 16, dh 64; 1500 = 23 x 64 + 28 keys, ragged), dh 112
    and 128 with a GQA group of 4, S above T, and a TP rank's share of
    whisper's in phase 24 (``WHISPER_TP_K14``: B 4, H = KV = 8); at
    whisper's two shapes a second call must give the same bits, and every
    call counts as a cross launch.  A causal mask at S != T must be
    refused.  Then the S == T backward at ``WHISPER_SELF_BWD_CASES`` and
    ``WHISPER_TP_SELF_BWD_CASES`` (the shapes of whisper-medium's encoder
    and decoder self-attention in phase 23, and on a TP rank in phase 24),
    the forward's output
    against ``flash_attention_ref`` at ``TOL`` beside it, a second call the
    same bits, no call counted as a cross launch."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda

    t0 = time.perf_counter()
    errs.setdefault("flash_attention_bwd_cross", 0.0)
    g = torch.Generator(device="cuda").manual_seed(14)

    def rand(dt, *shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for i, case in enumerate(K14_CASES + [WHISPER_TP_K14]):
            B, S, T, H, KV, dh = case
            repeat = i == 0 or case == WHISPER_TP_K14
            q, do = rand(dt, B, S, H, dh), rand(dt, B, S, H, dh)
            k, v = rand(dt, B, T, KV, dh), rand(dt, B, T, KV, dh)
            before = flash_attention_bwd_cuda.cross_launches
            out, lse, got = flash_bwd_check(
                q, k, v, do, False, None,
                f"cross B={B} S={S} T={T} H={H} KV={KV} dh={dh}", errs,
                key="flash_attention_bwd_cross")
            if repeat:
                again = flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                                 causal=False)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                log(f"[k14] {dtype} B={B} S={S} T={T}: dq, dk, dv of a "
                    f"second call bitwise equal: {same}")
                check(same, f"flash backward at S != T {dtype}: a second "
                      "call gave other bits")
                del again
            n = flash_attention_bwd_cuda.cross_launches - before
            check(n == (2 if repeat else 1),
                  f"{n} cross launches counted for case {i}")
            del q, do, k, v, out, lse, got
        torch.cuda.empty_cache()
    q, k = rand(torch.bfloat16, 1, 8, 4, 64), rand(torch.bfloat16, 1, 6, 2, 64)
    try:
        flash_attention_bwd_cuda(q, k, k, q, q, torch.zeros(
            1, 8, 4, device="cuda"), causal=True)
        refused = False
    except ValueError:
        refused = True
    check(refused, "the backward took a causal mask at S != T")
    errs.setdefault("flash_attention_bwd", 0.0)
    errs.setdefault("flash_attention", 0.0)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for B, S, H, KV, dh, causal in (WHISPER_SELF_BWD_CASES
                                        + WHISPER_TP_SELF_BWD_CASES):
            what = (f"B={B} S=T={S} H={H} KV={KV} dh={dh} "
                    f"{'causal' if causal else 'bidir'}")
            q, do = rand(dt, B, S, H, dh), rand(dt, B, S, H, dh)
            k, v = rand(dt, B, S, KV, dh), rand(dt, B, S, KV, dh)
            before = flash_attention_bwd_cuda.cross_launches
            out, lse, got = flash_bwd_check(q, k, v, do, causal, None, what,
                                            errs)
            err = (out.float() - ref.flash_attention_ref(
                q, k, v, causal=causal).float()).abs().max().item()
            errs["flash_attention"] = max(errs["flash_attention"], err)
            again = flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                             causal=causal)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"[k14] {dtype:8s} whisper self-attention {what}: forward "
                f"max|diff| {err:.3e} (tol {TOL[dtype]:.0e}); dq, dk, dv of "
                f"a second call bitwise equal: {same}")
            check(err <= TOL[dtype], f"flash forward {what} {dtype}: {err}")
            check(same, f"flash backward {what} {dtype}: a second call gave "
                  "other bits")
            check(flash_attention_bwd_cuda.cross_launches == before,
                  f"{what}: an S == T call counted as a cross launch")
            del q, do, k, v, out, lse, got, again
        torch.cuda.empty_cache()
    log(f"[k14] the flash backward at S != T and at whisper's S == T "
        f"shapes held against its plain version in "
        f"{time.perf_counter() - t0:.1f} s; largest |diff| at S != T "
        f"{errs['flash_attention_bwd_cross']:.3e}")


def _model_kernels(tag, arch, heads, train_bs, norm_fwd, norm_bwd, errs):
    """The kernels at one model's shapes, bf16 and fp32, each against its
    plain version at phase 2's gates and a second call the same bits: the
    causal flash forward with its row log-sum-exp and the backward at
    (``train_bs``, ``heads``), also against ``torch.autograd`` of the
    plain forward (:func:`flash_bwd_check`); the forward at the paged
    decode and prefill chunk, the dense engine's decode and a causal
    prefill of 2 x 256 (:func:`moe_flash_cases`, named for ``arch``);
    RMSNorm's forward at each (rows, d) of ``norm_fwd`` and its backward
    at ``norm_bwd`` (d past 2560 runs the cta bodies, a row across a
    CTA)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.rmsnorm import (RMSNorm, rmsnorm_bwd_cuda,
                                             rmsnorm_cuda)

    t0 = time.perf_counter()
    for key in ("flash_attention", "flash_attention_bwd", "rmsnorm",
                "rmsnorm_bwd"):
        errs.setdefault(key, 0.0)
    g = torch.Generator(device="cuda").manual_seed(25)

    def rand(dt, *shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dt)

    H, KV, dh = heads
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for name, B, S, T, kw in moe_flash_cases(arch):
            q, k, v = rand(dt, B, S, H, dh), rand(dt, B, T, KV, dh), \
                rand(dt, B, T, KV, dh)
            out = flash_attention_cuda(q, k, v, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, **kw)
            err = (out.float() - want.float()).abs().max().item()
            same = same_bits(out, flash_attention_cuda(q, k, v, **kw))
            log(f"{tag} {dtype:8s} H {H} KV {KV} dh {dh} {name:28s} "
                f"max|diff| {err:.3e} (tol {TOL[dtype]:.0e}); a second call "
                f"the same bits {same}")
            check(err <= TOL[dtype], f"flash {name} {dtype}: {err}")
            check(same, f"flash {name} {dtype}: a second call gave other "
                  "bits")
            errs["flash_attention"] = max(errs["flash_attention"], err)
        B, S = train_bs
        q, do = rand(dt, B, S, H, dh), rand(dt, B, S, H, dh)
        k, v = rand(dt, B, S, KV, dh), rand(dt, B, S, KV, dh)
        out, lse, got = flash_bwd_check(
            q, k, v, do, True, None, f"B={B} S={S} H={H} KV={KV} dh={dh}",
            errs)
        err = (out.float() - ref.flash_attention_ref(q, k, v).float()
               ).abs().max().item()
        errs["flash_attention"] = max(errs["flash_attention"], err)
        again = flash_attention_bwd_cuda(q, k, v, out, do, lse)
        same_fwd = same_bits((out, lse), flash_attention_cuda(
            q, k, v, with_lse=True))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"{tag} {dtype:8s} B={B} S={S} H={H} KV={KV} dh={dh} "
            f"causal: forward max|diff| {err:.3e} (tol {TOL[dtype]:.0e}); "
            f"a second call's out and lse the same bits {same_fwd}, its dq, "
            f"dk, dv {same}")
        check(err <= TOL[dtype], f"flash forward at S {S} {dtype}: {err}")
        check(same_fwd and same, f"flash at S {S} {dtype}: a second call "
              "gave other bits")
        del q, do, k, v, out, lse, got, again
        torch.cuda.empty_cache()
        for rows, d in norm_fwd:
            x, w = rand(dt, rows, d, scale=3.0), rand(dt, d)
            check_rmsnorm(x, w, dtype, str((rows, d)), errs)
            check(same_bits(rmsnorm_cuda(x, w, 1e-6),
                            rmsnorm_cuda(x, w, 1e-6)),
                  f"rmsnorm {(rows, d)} {dtype}: a second call gave other "
                  "bits")
        rows, d = norm_bwd
        x = rand(dt, rows, d, scale=2.0).requires_grad_()
        w = rand(dt, d).requires_grad_()
        dy = rand(dt, rows, d)
        got = torch.autograd.grad(RMSNorm.apply(x, w, 1e-5), (x, w), dy)
        torch.cuda.synchronize()
        want = torch.autograd.grad(ref.rmsnorm_ref(x, w, 1e-5), (x, w), dy)
        e_dx, e_dw = rel_err(got[0], want[0]), rel_err(got[1], want[1])
        again = rmsnorm_bwd_cuda(dy, x.detach(), w.detach(), 1e-5)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"{tag} {dtype:8s} rmsnorm backward {(rows, d)}: "
            f"max|diff|/max|ref| dx {e_dx:.2e}, dw {e_dw:.2e} (tol "
            f"{REL_TOL[dtype]:.0e}); a second call's dx, dw the same bits "
            f"{same}")
        check(max(e_dx, e_dw) <= REL_TOL[dtype],
              f"rmsnorm_bwd at d {d} {dtype}: dx {e_dx}, dw {e_dw}")
        check(same, f"rmsnorm_bwd at d {d} {dtype}: a second call gave "
              "other bits")
        errs["rmsnorm_bwd"] = max(errs["rmsnorm_bwd"], *(
            (a.float() - b.float()).abs().max().item()
            for a, b in zip(got, want)))
        del x, w, dy, got, want, again
        torch.cuda.empty_cache()
    log(f"{tag} flash and RMSNorm at {arch}'s shapes held against their "
        f"plain versions in {time.perf_counter() - t0:.1f} s")


def phase_vlm_kernels(errs):
    """The kernels at internvl2-26b's shapes (phase 25): flash at
    ``VLM_TRAIN_ATTN`` (B 1, S 4352, H 48, KV 8, dh 128: a GQA group of
    6, 64 packed rows holding 10 positions of 6 heads and 4 rows of an
    11th) and its serving shapes; RMSNorm's forward at 8 x 6144 and 4352 x
    6144 and its backward at 4352 x 6144 (:func:`_model_kernels`)."""
    d = VLM_HEADS[0] * VLM_HEADS[2]
    _model_kernels("[vlm-kernels]", "internvl2", VLM_HEADS,
                   VLM_TRAIN_ATTN[:2], [(r, d) for r in VLM_NORM_ROWS],
                   (VLM_NORM_ROWS[1], d), errs)


def phase_qwen2_kernels(errs):
    """The kernels at qwen2.5-14b's shapes (phase 26): flash at
    ``QWEN_TRAIN_ATTN`` (B 1, S 4096, H 40, KV 8, dh 128: a GQA group of
    5, so a position's five heads straddle two CTAs' 64 packed rows) and
    its serving shapes; RMSNorm's forward at ``QWEN_NORM_FWD`` (qwen2.5-14b's
    d 5120 on a decode's 8 rows and a training step's 4096, qwen2-72b's
    8192 on 8 rows) and its backward at ``QWEN_NORM_BWD`` (4096 x 5120)
    (:func:`_model_kernels`)."""
    _model_kernels("[qwen2-kernels]", "qwen2.5-14b",
                   QWEN_HEADS[QWEN2_5_14B], QWEN_TRAIN_ATTN[:2],
                   QWEN_NORM_FWD, QWEN_NORM_BWD, errs)


# ---------------------------------------------------------------------------
# phase 3: full-width qwen3-4b through the paged engine
# ---------------------------------------------------------------------------

def phase_serve():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.models import init_lm
    from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

    cfg = get_config("qwen3-4b")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[serve] qwen3-4b: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{n_params / 1e9:.2f} B params ({n_params * 2 / 1e9:.2f} GB bf16), "
        f"init {time.perf_counter() - t0:.1f} s")
    ecfg = EngineConfig(page_size=PAGE_SIZE,
                        n_pages=DECODE_SLOTS * MAX_CONTEXT // PAGE_SIZE,
                        decode_slots=DECODE_SLOTS, max_context=MAX_CONTEXT,
                        prefill_batch=PREFILL_BATCH,
                        prefill_chunk=PREFILL_CHUNK)
    # warm-up: the allocator's pools and the backward's cached geometry are
    # set up here, not inside the measured run
    ServingEngine(cfg, params, ecfg, device="cuda").run(
        [ServeRequest(rid="warmup", prompt=list(range(1, 150)), max_new=3)])
    engine = ServingEngine(cfg, params, ecfg, device="cuda")
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(rid=f"r{i}",
                         prompt=rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(33, 401))
                                             ).tolist(),
                         max_new=int(rng.integers(16, 33)))
            for i in range(12)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts()
    metrics = engine.run(reqs)
    torch.cuda.synchronize()
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summ = metrics.summary()
    for r in reqs:
        check(r.done and len(r.tokens) == r.max_new,
              f"request {r.rid}: {len(r.tokens)} of {r.max_new} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid}: token out of range")
    check(summ["completed"] == len(reqs), f"completed {summ['completed']}")
    for name in ("flash_attention", "rmsnorm"):
        check(launches[name] > 0,
              f"{name} was never launched on the serving path")

    # one decode step and one prefill chunk, timed on the engine's pools
    P = ecfg.pages_per_slot
    rows = torch.arange(DECODE_SLOTS * P, dtype=torch.int32,
                        device="cuda").reshape(DECODE_SLOTS, P)
    tok = torch.zeros(DECODE_SLOTS, dtype=torch.int32, device="cuda")
    lens = torch.full((DECODE_SLOTS,), 300, dtype=torch.int32, device="cuda")
    ptok = torch.zeros(PREFILL_BATCH, PREFILL_CHUNK, dtype=torch.int32,
                       device="cuda")
    plen = torch.full((PREFILL_BATCH,), 400, dtype=torch.int32,
                      device="cuda")

    def decode():
        return engine._decode(params, engine.pools, tok, rows, lens)

    def prefill():
        return engine._prefill(params, engine.pools, ptok,
                               rows[:PREFILL_BATCH], 256, plen)

    def launches_of(step):
        before = (flash_attention_cuda.launches, rmsnorm_cuda.launches)
        out = step()
        return out, {"flash_attention":
                     flash_attention_cuda.launches - before[0],
                     "rmsnorm": rmsnorm_cuda.launches - before[1]}

    logits, per_decode = launches_of(decode)
    check(logits.shape == (DECODE_SLOTS, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "decode logits not finite")
    logits, per_prefill = launches_of(prefill)
    check(logits.shape == (PREFILL_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite")
    decode_ms = cuda_ms(decode, iters=10)
    prefill_ms = cuda_ms(prefill, iters=5, warmup=1)
    for name, step, ms in (("decode", decode, decode_ms),
                           ("prefill", prefill, prefill_ms)):
        profile_step(name, step, ms)
    result = {
        "requests": summ["completed"], "new_tokens": summ["new_tokens"],
        "decode_steps": summ["decode_steps"],
        "prefill_chunks": summ["prefill_chunks"],
        "wall_s": summ["wall_s"], "tok_per_s": summ["tok_per_s"],
        "ttft_ms_p50": summ["ttft_ms_p50"], "ttft_ms_p99": summ["ttft_ms_p99"],
        "tok_ms_p50": summ["tok_ms_p50"],
        "decode_step_ms": decode_ms, "prefill_chunk_ms": prefill_ms,
        "peak_mem_gb": peak_gb,
        "launches_per_decode_step": per_decode,
        "launches_per_prefill_chunk": per_prefill,
    }
    log("[serve] " + json.dumps(result))
    return launches


# name fragments of the kernels of each category of device time
KERNEL_CATEGORIES = {
    "flash_fwd": ("flash_fwd_",), "flash_bwd": ("flash_bwd_",),
    "rmsnorm_fwd": ("rmsnorm_fwd",), "rmsnorm_bwd": ("rmsnorm_bwd",),
    "gemm": ("gemm", "nvjet", "cutlass", "xmma", "cublas"),
    "elementwise": ("elementwise",), "reduce": ("reduce",)}


def _by_category(kernels, n=1):
    """Device ms of the profiler's CUDA events by KERNEL_CATEGORIES, over
    ``n`` runs."""
    out = {c: 0.0 for c in [*KERNEL_CATEGORIES, "other"]}
    for e in kernels:
        cat = next((c for c, keys in KERNEL_CATEGORIES.items()
                    if any(k in e.key for k in keys)), "other")
        out[cat] += e.self_device_time_total / 1e3 / n
    return out


def profile_step(name, step, step_ms, n=3):
    """Device time by kernel over ``n`` steps (torch.profiler), and the
    device's busy share of the step time measured without the profiler.
    Returns the device busy ms, the kernels of one step and its device ms
    by category."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    per_step = sum(e.count for e in kernels) // n
    cats = _by_category(kernels, n)
    log(f"[profile] {name} step: device busy {busy_ms:.3f} ms of "
        f"{step_ms:.3f} ms ({100 * busy_ms / step_ms:.1f}%), "
        f"{per_step} kernels per step; device ms by category: "
        + ", ".join(f"{c} {ms:.3f}" for c, ms in cats.items()) + "; top: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / n:.3f}"
                    f" ms x{e.count // n}" for e in top))
    return busy_ms, per_step, cats


# ---------------------------------------------------------------------------
# phase 4: reduced fp32 model, card vs CPU
# ---------------------------------------------------------------------------

def phase_cpu_vs_card():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

    cfg = get_config("qwen3-4b").reduced().with_(dtype=torch.float32)
    ecfg = EngineConfig(page_size=8, n_pages=48, decode_slots=4,
                        max_context=96, prefill_batch=2, prefill_chunk=16)
    params_cpu = init_lm(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to("cuda")
    rng = np.random.default_rng(1)
    spec = [(rng.integers(0, cfg.vocab_size, int(rng.integers(5, 61))
                          ).tolist(), int(rng.integers(4, 11)))
            for _ in range(6)]
    tokens = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        reqs = [ServeRequest(rid=str(i), prompt=p, max_new=n)
                for i, (p, n) in enumerate(spec)]
        ServingEngine(cfg, params, ecfg, device=dev).run(reqs)
        tokens[dev] = [r.tokens for r in reqs]
    same = tokens["cpu"] == tokens["cuda"]
    log(f"[cpu-vs-card] reduced fp32 qwen3-4b, {len(spec)} requests: greedy "
        f"tokens identical: {same}")
    check(same, f"card {tokens['cuda']} != cpu {tokens['cpu']}")


# ---------------------------------------------------------------------------
# phase 5: full-width mamba2-370m training
# ---------------------------------------------------------------------------

def _ssd_ops(B, S, H, P, N, Q):
    """fp32 operations of the chunked SSD scan (forward, backward) as the
    kernels compute it: per chunk the products C B^T, M x, C S^T and the
    state update forward; C B^T, dy x^T, the two products each of dx, dB
    and dC, the dS update and the recomputed state update backward."""
    per_chunk_fwd = 2 * (Q * Q * N + Q * Q * P + 2 * Q * N * P)
    per_chunk_bwd = 2 * (3 * Q * Q * N + 2 * Q * Q * P + 5 * Q * N * P)
    chunks = B * H * -(-S // Q)
    return per_chunk_fwd * chunks, per_chunk_bwd * chunks


def _zero_counts():
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.ring_attention import flash_partial_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
    fns = {"flash_attention": flash_attention_cuda,
           "flash_attention_bwd": flash_attention_bwd_cuda,
           "rmsnorm": rmsnorm_cuda,
           "rmsnorm_bwd": rmsnorm_bwd_cuda, "ssd_scan": ssd_scan_cuda,
           "ssd_scan_bwd": ssd_scan_bwd_cuda,
           "flash_partial": flash_partial_cuda}
    for fn in fns.values():
        fn.launches = 0
    flash_attention_bwd_cuda.cross_launches = 0
    # K14, the backward at S != T, counts its launches apart as well (they
    # are also among flash_attention_bwd's)
    return lambda: {**{name: fn.launches for name, fn in fns.items()},
                    "flash_attention_bwd_cross":
                        flash_attention_bwd_cuda.cross_launches}


def phase_train():
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_lm_batches
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime.executor import init_train_state, make_train_step

    cfg = get_config("mamba2-370m")
    argv = ["--arch", "mamba2-370m", "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1"]
    log(f"[train] python -m repro_torch.launch.train {' '.join(argv)}")
    counts = _zero_counts()
    t0 = time.perf_counter()
    history = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    losses = [h["loss"] for h in history]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"training losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name in ("rmsnorm", "rmsnorm_bwd", "ssd_scan", "ssd_scan_bwd"):
        check(launches[name] > 0, f"{name} was never launched on the "
              "training path")
    log(f"[train] {TRAIN_STEPS} steps in {wall:.1f} s (first step "
        f"included); losses {losses}; launches {launches}")
    del history
    gc.collect()
    torch.cuda.empty_cache()

    # the same step, timed and profiled after a warm-up step
    params, opt = init_train_state(cfg, seed=0, device="cuda")
    step = make_train_step(cfg)
    n_params = sum(p.numel() for p in params.parameters())
    gen = synthetic_lm_batches(DataConfig(seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH,
                                          vocab_size=cfg.vocab_size))
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                next(gen).items()} for _ in range(4)]
    step(params, opt, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = counts()
    step_ms = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        metrics = step(params, opt, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(metrics["loss"])), "loss not finite")
    per_step = {k: (v - before[k]) // len(step_ms)
                for k, v in counts().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt, batches[0])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def share(key):
        return sum(e.self_device_time_total for e in kernels
                   if key in e.key) / 1e3

    categories = {"ssd_scan": ("ssd_fwd_", "ssd_bwd_"),
                  "rmsnorm": ("rmsnorm_",),
                  "gemm": ("gemm", "nvjet", "cutlass", "xmma", "cublas"),
                  "elementwise": ("elementwise",), "reduce": ("reduce",)}
    by_category = {c: 0.0 for c in [*categories, "other"]}
    for e in kernels:
        cat = next((c for c, keys in categories.items()
                    if any(k in e.key for k in keys)), "other")
        by_category[cat] += e.self_device_time_total / 1e3

    mean_ms = sum(step_ms) / len(step_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    fwd_ops, bwd_ops = _ssd_ops(TRAIN_BATCH, TRAIN_SEQ, cfg.ssm_heads,
                                cfg.ssm_head_dim, cfg.ssm_state,
                                cfg.ssm_chunk)
    model_flop = 6 * n_params * tokens + cfg.n_layers * (fwd_ops + bwd_ops)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    result = {
        "params": n_params, "tokens_per_step": tokens,
        "losses": losses, "train_wall_s": wall,
        "step_ms": step_ms, "step_ms_mean": mean_ms,
        "tok_per_s": tokens / mean_ms * 1e3, "peak_mem_gb": peak_gb,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / mean_ms,
        "ssd_fwd_ms": share("ssd_fwd_"),
        "ssd_fwd_ms_by_kernel": {k: share(k) for k in SSD_FWD_KERNELS},
        "ssd_bwd_ms": share("ssd_bwd_"),
        "ssd_bwd_ms_by_kernel": {k: share(k) for k in SSD_BWD_KERNELS},
        "rmsnorm_fwd_ms": share("rmsnorm_fwd"),
        "rmsnorm_bwd_ms": share("rmsnorm_bwd"),
        "rmsnorm_ms_by_kernel": {k: share(k) for k in RMSNORM_KERNELS},
        "device_ms_by_category": by_category,
        "kernels_per_step": sum(e.count for e in kernels),
        "launches_per_step": per_step,
        "model_tflop_per_step": model_flop / 1e12,
        "model_flop_share_of_989_tflops": model_flop / (mean_ms / 1e3)
        / 989e12,
    }
    log("[train] " + json.dumps(result))
    check(all(result["ssd_fwd_ms_by_kernel"].values())
          and all(result["ssd_bwd_ms_by_kernel"].values()),
          "the profiled training step missed a bf16 SSD kernel: "
          f"{result['ssd_fwd_ms_by_kernel']} {result['ssd_bwd_ms_by_kernel']}")
    log("[profile] train step: top device kernels: " + "; ".join(
        f"{e.key[:70]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
        for e in top))
    del params, opt, step, batches, metrics, prof
    gc.collect()
    torch.cuda.empty_cache()
    return launches, losses


# ---------------------------------------------------------------------------
# phase 14: checkpoints of full-width mamba2-370m, save, restore, resume
# ---------------------------------------------------------------------------

def phase_ckpt(unbroken):
    """Phase 5's run through ``train --ckpt-dir``: CKPT_STEPS steps and a
    checkpoint, a freshly built model and AdamW state restored from it,
    CKPT_STEPS more steps on the next batches; the losses must be phase 5's
    (``unbroken``), bit for bit.  Returns the path's launches."""
    import gc

    import torch
    from repro_torch.checkpointing import restore_train_state
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_lm_batches
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.executor import init_train_state, make_train_step

    cfg = get_config("mamba2-370m")
    ck = ROOT / "build" / "ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--arch", "mamba2-370m", "--steps", str(CKPT_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1",
            "--ckpt-dir", str(ck), "--ckpt-every", str(CKPT_STEPS)]
    log(f"[ckpt] python -m repro_torch.launch.train {' '.join(argv)}")
    # check-only: time the save that launch/train.py makes
    real_save, save_s = train_cli.save_train_state, []

    def timed_save(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_save(*args, **kwargs)
        save_s.append(time.perf_counter() - t0)
        return out

    counts = _zero_counts()
    train_cli.save_train_state = timed_save
    try:
        with recorded_train_steps() as seen, plain_calls() as plain:
            hist = train_cli.main(argv)
    finally:
        train_cli.save_train_state = real_save
    losses = [h["loss"] for h in hist]
    saved = ck / f"step_{CKPT_STEPS:08d}"
    check(len(save_s) == 1 and saved.is_dir(), f"train --ckpt-dir wrote "
          f"{sorted(p.name for p in ck.iterdir()) if ck.exists() else []}")
    n_bytes = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
    del hist
    gc.collect()
    torch.cuda.empty_cache()

    opt_cfg = AdamWConfig(lr=3e-4)          # the train CLI's default lr
    remat = seen["remat_segments"][0]
    params, opt = init_train_state(cfg, seed=1, opt_cfg=opt_cfg,
                                   device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, step_no = restore_train_state(params, opt, ck)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(step_no == CKPT_STEPS and opt["step"] == CKPT_STEPS,
          f"restored step {step_no}, AdamW step {opt['step']}")
    check(all(p.is_cuda for p in params.parameters())
          and all(t.is_cuda for k in ("master", "m", "v") for t in opt[k]),
          "the restored state is not on the card")
    gen = synthetic_lm_batches(DataConfig(seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH,
                                          vocab_size=cfg.vocab_size))
    for _ in range(CKPT_STEPS):
        next(gen)
    step = make_train_step(cfg, opt_cfg, remat_segments=remat)
    with plain_calls() as plain_resumed:
        for _ in range(CKPT_STEPS):
            batch = {k: torch.from_numpy(v).to("cuda")
                     for k, v in next(gen).items()}
            losses.append(float(step(params, opt, batch)["loss"]))
    torch.cuda.synchronize()
    launches = counts()
    want = unbroken[:2 * CKPT_STEPS]
    check(not plain and not plain_resumed, f"plain versions ran on the "
          f"checkpoint path: {plain} {plain_resumed}")
    for name in ("rmsnorm", "rmsnorm_bwd", "ssd_scan", "ssd_scan_bwd"):
        check(launches[name] > 0, f"{name} was never launched on the "
              "checkpoint path")
    check(losses == want, f"saved, restored and resumed losses {losses} are "
          f"not phase 5's {want}: differences "
          f"{[a - b for a, b in zip(losses, want)]}")
    n_params = sum(p.numel() for p in params.parameters())
    log("[ckpt] " + json.dumps({
        "losses": losses, "phase5_losses": want, "losses_bit_identical": True,
        "restored_step": step_no, "remat_segments": remat,
        "checkpoint_bytes": n_bytes, "params": n_params,
        "bytes_per_param": n_bytes / n_params, "save_s": save_s[0],
        "restore_s": restore_s, "launches": launches}))
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ck, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 6: reduced fp32 mamba2 training, card vs CPU
# ---------------------------------------------------------------------------

def phase_train_cpu_vs_card():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_lm_batches
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.executor import init_train_state, make_train_step

    cfg = get_config("mamba2-370m").reduced().with_(dtype=torch.float32)
    params_cpu, opt_cpu = init_train_state(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to("cuda")
    opt_gpu = adamw_init(list(params_gpu.parameters()))
    step = make_train_step(cfg)
    gen = synthetic_lm_batches(DataConfig(seq_len=100, global_batch=2,
                                          vocab_size=cfg.vocab_size))
    launches = ssd_scan_bwd_cuda.launches
    losses = {"cpu": [], "cuda": []}
    for _ in range(3):
        batch = next(gen)
        for dev, params, opt in (("cpu", params_cpu, opt_cpu),
                                 ("cuda", params_gpu, opt_gpu)):
            m = step(params, opt, {k: torch.from_numpy(v).to(dev)
                                   for k, v in batch.items()})
            losses[dev].append(float(m["loss"]))
    check(ssd_scan_bwd_cuda.launches > launches,
          "the card's steps did not run the SSD backward kernel")
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                    losses["cpu"]))
    log(f"[train-cpu-vs-card] reduced fp32 mamba2-370m, 3 steps of 2 x 100: "
        f"card {losses['cuda']} cpu {losses['cpu']}; max relative diff "
        f"{worst:.2e} (tol {TRAIN_LOSS_RTOL:.0e})")
    check(worst <= TRAIN_LOSS_RTOL, f"losses differ by {worst}")


# ---------------------------------------------------------------------------
# phase 9: full-width qwen3-4b training, depth cut
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_calls():
    """Count the calls of every plain version (``kernels/ref.py``'s
    ``*_ref``, and ``models/attention.py::sdpa_ref``) through each module of
    the port that holds one, while the block runs."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as attn_mod

    calls, saved = {}, []
    for mod in (ref, ops, attn_mod):
        for name in dir(mod):
            fn = getattr(mod, name)
            if not (name.endswith("_ref") and callable(fn)):
                continue

            def counted(*args, _fn=fn, _name=name, **kwargs):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*args, **kwargs)

            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _dense_batches(cfg, n):
    import torch
    from repro_torch.data import DataConfig, synthetic_lm_batches

    gen = synthetic_lm_batches(DataConfig(seq_len=DENSE_SEQ,
                                          global_batch=DENSE_BATCH,
                                          vocab_size=cfg.vocab_size))
    return [{k: torch.from_numpy(v).to("cuda") for k, v in next(gen).items()}
            for _ in range(n)]


def _dense_remat_pair(cfg, batches):
    """Two steps from the same weights at ``cfg``'s depth, with remat on
    every layer and without: (losses, peak GB) of each."""
    import gc

    import torch
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.executor import init_train_state, make_train_step

    out = {}
    opt_cfg = AdamWConfig(lr=DENSE_LR)
    for remat in (True, False):
        params, opt = init_train_state(cfg, seed=0, opt_cfg=opt_cfg,
                                       device="cuda")
        step = make_train_step(cfg, opt_cfg,
                               remat_segments=[True] if remat else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(params, opt, b)["loss"]) for b in batches]
        torch.cuda.synchronize()
        out[remat] = (losses, torch.cuda.max_memory_allocated() / 1e9)
        del params, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_attention():
    """Check-only: ``ops.flash_attention`` becomes its plain version,
    autodiffed by torch, while the block runs."""
    from repro_torch.kernels import ops, ref

    saved = ops.flash_attention
    ops.flash_attention = lambda q, k, v, **kw: ref.flash_attention_ref(
        q, k, v, **kw)
    try:
        yield
    finally:
        ops.flash_attention = saved


def _dense_lr_witness(cfg, batches, lr=WITNESS_LR):
    """Losses of ``len(batches)`` steps at ``lr`` from the same weights (and
    drawn QKV biases where the config has them, :func:`_qwen_set_biases`)
    at ``cfg``'s depth with remat, through the flash kernels and through
    the plain attention: whether the loss rises there with the kernels'
    gradients and with torch's alike."""
    import gc

    import torch
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.executor import init_train_state, make_train_step

    out = {}
    opt_cfg = AdamWConfig(lr=lr)
    for name in ("kernels", "plain"):
        params, opt = init_train_state(cfg, seed=0, opt_cfg=opt_cfg,
                                       device="cuda")
        if cfg.qkv_bias:
            _qwen_set_biases(params, cfg, opt)
        step = make_train_step(cfg, opt_cfg, remat_segments=[True])
        with (plain_attention() if name == "plain"
              else contextlib.nullcontext()):
            out[name] = [float(step(params, opt, b)["loss"])
                         for b in batches]
        del params, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_dense_train():
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.executor import init_train_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-4b").with_(n_layers=DENSE_LAYERS)
    L = cfg.n_layers
    t0 = time.perf_counter()
    opt_cfg = AdamWConfig(lr=DENSE_LR)
    params, opt = init_train_state(cfg, seed=0, opt_cfg=opt_cfg,
                                   device="cuda")
    step = make_train_step(cfg, opt_cfg, remat_segments=[True])
    batches = _dense_batches(cfg, DENSE_STEPS)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[dense] qwen3-4b, {L} of 36 layers (depth cut to fit the card), d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.dh}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {n_params / 1e9:.4f} B "
        f"params, bf16, remat on every layer; {DENSE_STEPS} steps of "
        f"{DENSE_BATCH} x {DENSE_SEQ} tokens; init "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts()
    losses, step_ms, per_step = [], [], []
    with plain_calls() as plain:
        for b in batches:
            before = counts()
            t0 = time.perf_counter()
            metrics = step(params, opt, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            after = counts()
            per_step.append({k: after[k] - before[k] for k in after})
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"dense training losses {losses}")
    check(losses[-1] < losses[0], f"dense loss did not fall: {losses}")
    check(not plain, f"plain versions ran on the dense training path: {plain}")
    for i, n in enumerate(per_step):
        check(n["flash_attention_bwd"] == L and n["flash_attention"] == 2 * L,
              f"step {i}: flash launches {n}, not {L} backward and {2 * L} "
              "forward (remat recomputes it)")
        # ln1, ln2, q- and k-norm a layer (twice forward under remat) and
        # the final norm
        check(n["rmsnorm"] == 8 * L + 1 and n["rmsnorm_bwd"] == 4 * L + 1,
              f"step {i}: RMSNorm launches {n}, not {8 * L + 1} forward and "
              f"{4 * L + 1} backward")
    log(f"[dense] losses {losses}; step ms {step_ms}; launches a step "
        f"{per_step[-1]}; peak {peak_gb:.4f} GB")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt, batches[0])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_category = _by_category(kernels)
    bwd_by_kernel = {k: sum(e.self_device_time_total for e in kernels
                            if k in e.key) / 1e3
                     for k in FLASH_BWD_KERNELS}
    mean_ms = sum(step_ms[1:]) / len(step_ms[1:])   # the first warms up
    tokens = DENSE_BATCH * DENSE_SEQ
    attn_flop = (L * 12 * DENSE_BATCH * cfg.n_heads * DENSE_SEQ ** 2 / 2
                 * cfg.dh)
    # the input embedding is a lookup, not a matmul: the untied head has
    # its own matmul and stays in N
    n_matmul = n_params - (params.embed.numel() if params.head is not None
                           else 0)
    model_flop = 6 * n_matmul * tokens + attn_flop
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    result = {
        "layers": L, "layers_of": 36, "params": n_params,
        "params_in_6nt": n_matmul,
        "tokens_per_step": tokens, "losses": losses, "step_ms": step_ms,
        "step_ms_mean_after_first": mean_ms,
        "tok_per_s": tokens / mean_ms * 1e3, "peak_mem_gb": peak_gb,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / mean_ms,
        "device_ms_by_category": by_category,
        "flash_bwd_ms_by_kernel": bwd_by_kernel,
        "kernels_per_step": sum(e.count for e in kernels),
        "launches_per_step": per_step[-1],
        "model_tflop_per_step": model_flop / 1e12,
        "model_flop_share_of_989_tflops":
            model_flop / (mean_ms / 1e3) / 989e12,
    }
    log("[dense] " + json.dumps(result))
    MEASURED["dense_train"] = {"step_ms": mean_ms, "busy_ms": busy_ms,
                               "peak_bytes": peak_gb * 1e9}
    log("[profile] dense train step: top device kernels: " + "; ".join(
        f"{e.key[:70]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
        for e in top))
    check(by_category["flash_bwd"] > 0 and by_category["flash_fwd"] > 0,
          f"the profiled dense step shows no flash kernel: {by_category}")
    del params, opt, step, metrics, prof
    gc.collect()
    torch.cuda.empty_cache()

    pair = _dense_remat_pair(cfg.with_(n_layers=REMAT_LAYERS), batches[:2])
    (l_r, p_r), (l_n, p_n) = pair[True], pair[False]
    worst = max(abs(a - b) / abs(b) for a, b in zip(l_r, l_n))
    log(f"[dense] {REMAT_LAYERS} layers, 2 steps: losses with remat {l_r}, "
        f"without {l_n}; max relative diff {worst:.2e} (tol "
        f"{TOL['bfloat16']:.0e}); peak {p_r:.4f} GB with remat, {p_n:.4f} GB "
        "without")
    check(worst <= TOL["bfloat16"], f"remat changes the losses: {worst}")

    witness = _dense_lr_witness(cfg.with_(n_layers=REMAT_LAYERS),
                                batches[:WITNESS_STEPS])
    check(all(np.isfinite(v).all() for v in witness.values()),
          f"lr witness losses not finite: {witness}")
    log(f"[dense] lr witness, {REMAT_LAYERS} layers, remat, lr "
        f"{WITNESS_LR:g}, {WITNESS_STEPS} steps from the same weights: "
        f"losses through the flash kernels {witness['kernels']}, through "
        f"the plain attention autodiffed by torch {witness['plain']}")
    return launches, losses


# ---------------------------------------------------------------------------
# phase 10: reduced fp32 qwen3-4b training, card vs CPU
# ---------------------------------------------------------------------------

def phase_dense_cpu_vs_card():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.executor import init_train_state

    cfg = get_config("qwen3-4b").reduced().with_(dtype=torch.float32)
    argv = ["--reduced", "--arch", "qwen3-4b", "--steps", "3", "--batch",
            "2", "--seq", "100", "--log-every", "1"]
    params_cpu, _ = init_train_state(cfg, seed=0, device="cpu")

    def same_weights(cfg, *, seed, opt_cfg, device):
        """The CPU's random weights on either device (a CUDA generator draws
        other numbers from the same seed)."""
        params = copy.deepcopy(params_cpu).to(device)
        return params, adamw_init(list(params.parameters()), opt_cfg)

    launches = flash_attention_bwd_cuda.launches
    init, train_cli.init_train_state = (train_cli.init_train_state,
                                        same_weights)
    try:
        losses = {dev: [h["loss"] for h in train_cli.train(
                      cfg, train_cli.parse_args(argv + ["--device", dev]))]
                  for dev in ("cpu", "cuda")}
    finally:
        train_cli.init_train_state = init
    n = flash_attention_bwd_cuda.launches - launches
    check(n == 3 * cfg.n_layers, f"the card's steps launched the flash "
          f"backward {n} times, not {3 * cfg.n_layers}")
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                    losses["cpu"]))
    log(f"[dense-cpu-vs-card] reduced fp32 qwen3-4b through "
        f"repro_torch.launch.train, 3 steps of 2 x 100: card "
        f"{losses['cuda']} cpu {losses['cpu']}; max relative diff "
        f"{worst:.2e} (tol {TRAIN_LOSS_RTOL:.0e})")
    check(worst <= TRAIN_LOSS_RTOL, f"dense losses differ by {worst}")


# ---------------------------------------------------------------------------
# phase 11: the dense-cache engine at full-width qwen3-4b
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counted_serve_steps():
    """Count the decode steps ``launch/serve.py::serve`` runs while the
    block runs (its ``make_serve_step`` wrapped)."""
    from repro_torch.launch import serve as serve_mod

    steps = {"n": 0}
    real = serve_mod.make_serve_step

    def make(cfg, **kw):
        step = real(cfg, **kw)

        def counted(*args):
            steps["n"] += 1
            return step(*args)
        counted.shard = step.shard
        return counted

    serve_mod.make_serve_step = make
    try:
        yield steps
    finally:
        serve_mod.make_serve_step = real


@contextlib.contextmanager
def flash_routes():
    """Check-only: record, for every launch of the flash forward through
    ``ops.flash_attention`` while the block runs, the data pointer of its
    keys, whether it is causal and whether it has a kv_len."""
    from repro_torch.kernels import ops

    routes = []
    real = ops.flash_attention_cuda

    def recording(q, k, v, **kw):
        routes.append((k.data_ptr(), kw["causal"],
                       kw.get("kv_len") is not None))
        return real(q, k, v, **kw)

    ops.flash_attention_cuda = recording
    try:
        yield routes
    finally:
        ops.flash_attention_cuda = real


def _decode_vs_prefill(cfg, params, T, tol, tag="[dense-serve] (a)"):
    """Part (a): make_serve_step's logits at every position of 2 lanes of
    T random tokens against make_prefill_step's on the same tokens; the
    worst over positions of max |diff| / max |logit| must be within
    ``tol`` (None: printed, not gated)."""
    import torch
    from repro_torch.models import init_decode_state
    from repro_torch.runtime.executor import make_prefill_step, make_serve_step

    B = DECODE_VS_PREFILL_LANES
    g = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                         device="cuda", dtype=torch.int32)
    full = make_prefill_step(cfg)(params, {"tokens": toks}).float()
    step = make_serve_step(cfg)
    state = init_decode_state(cfg, B, T, device="cuda")
    errs = []
    for t in range(T):
        logits, state = step(params, state, toks[:, t])
        want = full[:, t]
        errs.append((logits.float() - want).abs().max() / want.abs().max())
    errs = torch.stack(errs).cpu()
    worst = errs.max().item()
    check(bool(torch.isfinite(full).all()), "prefill logits not finite")
    what = str(cfg.dtype).replace("torch.", "")
    log(f"{tag} decode vs prefill, {cfg.name} {B} x {T} tokens, {what}: "
        f"max |diff| / max |logit| per position: worst {worst:.3e} at "
        f"t={int(errs.argmax())}, mean {errs.mean().item():.3e} "
        + (f"(tol {tol:.0e})" if tol else "(not gated)"))
    check(tol is None or worst <= tol, f"{cfg.name} {what} decode and "
          f"prefill logits differ by {worst} of the largest")
    return worst


def _dense_decode_step(cfg, params, tag="dense decode"):
    """One decode step of 8 lanes over 2048-token caches at mixed
    positions: its wall ms, device busy ms and kernels (profiler), and the
    route of each flash launch, which must read its cache (one an
    attention call of the step: a layer's, or a hybrid's shared-block
    call's) in place, non-causal with a kv_len."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import init_decode_state
    from repro_torch.runtime.executor import make_serve_step

    B, C = DENSE_SERVE_LANES, DENSE_SERVE_CONTEXT
    step = make_serve_step(cfg)
    state = init_decode_state(cfg, B, C, device="cuda")
    state["index"] = _i32([16, 100, 300, 700, 1024, 1500, 2000, C - 1])
    tok = _i32(list(range(1, B + 1)))
    cache_ptrs = {c["k"].data_ptr() for c in state["caches"]}
    n_attn = len(state["caches"])
    before = flash_attention_cuda.launches
    with flash_routes() as routes, plain_calls() as plain:
        logits, _ = step(params, state, tok)
        torch.cuda.synchronize()
    flash = flash_attention_cuda.launches - before
    check(flash == n_attn, f"one {tag} step launched flash {flash} times, "
          f"not {n_attn}")
    check(not plain, f"a {tag} step called plain versions: {plain}")
    check(all(ptr in cache_ptrs and not causal and has_len
              for ptr, causal, has_len in routes)
          and len({ptr for ptr, _, _ in routes}) == n_attn,
          f"a flash launch of the {tag} step did not read its cache in "
          f"place, non-causal with a kv_len: {routes}")
    check(logits.shape == (B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{tag} logits not finite")
    ms = cuda_ms(lambda: step(params, state, tok), iters=10)
    busy, kernels, cats = profile_step(
        tag, lambda: step(params, state, tok), ms)
    return {"decode_step_ms": ms, "decode_busy_ms": busy,
            "decode_device_ms_by_category": cats,
            "kernels_per_step": kernels, "flash_per_step": flash,
            "flash_reads_cache_in_place": True}


def _dense_serve_cpu_vs_card():
    """Part (c): reduced fp32 qwen3-4b through serve on the card and on the
    CPU from the same weights, with requests that wrap the cache."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, serve
    from repro_torch.models import init_lm

    cfg = get_config("qwen3-4b").reduced().with_(dtype=torch.float32)
    params_cpu = init_lm(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to("cuda")
    rng = np.random.default_rng(2)
    spec = [(rng.integers(0, cfg.vocab_size, int(rng.integers(5, 45))
                          ).tolist(), int(rng.integers(4, 11)))
            for _ in range(6)]
    spec.append((rng.integers(0, cfg.vocab_size, 44).tolist(), 12))
    tokens = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        reqs = [Request(i, p, n) for i, (p, n) in enumerate(spec)]
        serve(cfg, reqs, 3, 48, verbose=False, device=dev, params=params)
        tokens[dev] = [r.generated for r in reqs]
    wraps = sum(len(p) + n > 48 for p, n in spec)
    same = tokens["cpu"] == tokens["cuda"]
    log(f"[dense-serve] (c) reduced fp32 qwen3-4b, {len(spec)} requests on 3 "
        f"lanes of a 48-token cache ({wraps} wrap it): greedy tokens "
        f"identical card vs cpu: {same}")
    check(wraps >= 1, "no request wraps the cache")
    check(same, f"card {tokens['cuda']} != cpu {tokens['cpu']}")


def _ssm_prefill(arch="mamba2-370m", tag="[dense-serve] (e)"):
    """make_prefill_step on ``arch``: at full width in bf16 (2 x 2048
    tokens), where every layer launches the SSD forward, a hybrid's every
    shared-block call the flash forward, and nothing else of either; and
    reduced in fp32 on the card against the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.runtime.executor import make_prefill_step

    cfg = get_config(arch)
    params = init_lm(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 2048), device="cuda",
                         generator=gen)
    n_attn = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    counts = _zero_counts()
    with plain_calls() as plain:
        logits = make_prefill_step(cfg)(params, {"tokens": toks})
        torch.cuda.synchronize()
    launches = counts()
    check(not plain, f"the {arch} prefill called plain versions: {plain}")
    check(launches["ssd_scan"] == cfg.n_layers
          and launches["flash_attention"] == n_attn
          and launches["ssd_scan_bwd"] == 0
          and launches["flash_attention_bwd"] == 0,
          f"the {arch} prefill launched {launches}")
    check(logits.shape == (2, 2048, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{arch} prefill not finite")
    del params, logits
    small = cfg.reduced().with_(dtype=torch.float32)
    p_cpu = init_lm(small, seed=0, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    toks = torch.randint(0, small.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(4))
    step = make_prefill_step(small)
    want = step(p_cpu, {"tokens": toks})
    got = step(p_gpu, {"tokens": toks.cuda()}).cpu()
    err = rel_err(got, want)
    log(f"{tag} {arch} prefill: full width 2 x 2048 bf16 launched "
        f"{launches['ssd_scan']} SSD forwards and "
        f"{launches['flash_attention']} flash forwards; reduced fp32 card vs "
        f"cpu logits {err:.2e} of the largest (tol "
        f"{REL_TOL['float32']:.0e})")
    check(err <= REL_TOL["float32"], f"{arch} prefill card vs cpu: {err}")
    return launches


def phase_dense_serve():
    """Phase 11.  Returns the launches of part (b)'s serve run, of the SSM
    prefill and the flash forward's times at the decode shape (part d)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, serve
    from repro_torch.models import LM, init_lm

    # (a) in fp32 first, as a witness that bf16's distance is rounding
    cfg = get_config("qwen3-4b").with_(n_layers=DENSE_SERVE_LAYERS)
    params = init_lm(cfg.with_(dtype=torch.float32), seed=0, device="cuda")
    worst_fp32 = _decode_vs_prefill(cfg.with_(dtype=torch.float32), params,
                                    DECODE_VS_PREFILL_T_FP32,
                                    REL_TOL["float32"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = init_lm(cfg, seed=0, device="cuda")
    worst = _decode_vs_prefill(cfg, params, DECODE_VS_PREFILL_T,
                               DECODE_VS_PREFILL_TOL)

    # (b) the engine: 16 requests on 8 lanes of 2048 tokens, after a warm-up
    lanes, context = DENSE_SERVE_LANES, DENSE_SERVE_CONTEXT
    serve(cfg, [Request(-1, [1, 2, 3], 2)], lanes, context, verbose=False,
          device="cuda", params=params)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(16, 129))).tolist(),
                    DENSE_SERVE_NEW) for i in range(DENSE_SERVE_REQUESTS)]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts()
    with counted_serve_steps() as steps, plain_calls() as plain:
        t0 = time.perf_counter()
        serve(cfg, reqs, lanes, context, verbose=False, device="cuda",
              params=params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in reqs:
        check(r.done and len(r.generated) == DENSE_SERVE_NEW,
              f"request {r.rid}: {len(r.generated)} of {DENSE_SERVE_NEW}")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"request {r.rid}: token out of range")
    check(not plain, f"the dense engine called plain versions: {plain}")
    n = steps["n"]
    check(launches["flash_attention"] == cfg.n_layers * n,
          f"{launches['flash_attention']} flash launches in {n} steps")
    for name in ("flash_attention", "rmsnorm"):
        check(launches[name] > 0, f"{name} was never launched on the dense "
              "engine's path")
    new = sum(len(r.generated) for r in reqs)
    kv_bytes = (cfg.n_layers * 2 * lanes * context * cfg.n_kv_heads * cfg.dh
                * torch.finfo(cfg.dtype).bits // 8)
    step = _dense_decode_step(cfg, params)

    # the wrap: one request whose prompt and new tokens pass the context,
    # on the first WRAP_LAYERS layers
    wrap = Request(0, rng.integers(0, cfg.vocab_size,
                                   context - 8).tolist(), DENSE_SERVE_NEW)
    shallow = LM(params.embed, list(params.blocks[:WRAP_LAYERS]),
                 params.final_norm, params.head)
    t0 = time.perf_counter()
    serve(cfg.with_(n_layers=WRAP_LAYERS), [wrap], 1, context,
          verbose=False, device="cuda", params=shallow)
    wrap_s = time.perf_counter() - t0
    del shallow
    check(wrap.done and len(wrap.generated) == DENSE_SERVE_NEW
          and all(0 <= t < cfg.vocab_size for t in wrap.generated),
          f"the wrapping request gave {wrap.generated}")
    result = {
        "decode_vs_prefill_rel_err": worst, "tol": DECODE_VS_PREFILL_TOL,
        "decode_vs_prefill_rel_err_fp32": worst_fp32,
        "requests": len(reqs), "lanes": lanes, "context": context,
        "new_tokens": new, "steps": n, "wall_s": wall, "tok_per_s": new / wall,
        "step_wall_ms": 1e3 * wall / n, **step,
        "rmsnorm_per_step": launches["rmsnorm"] / n,
        "plain_calls": sum(plain.values()), "kv_cache_bytes": kv_bytes,
        "peak_mem_gb": peak_gb,
        "wrap": f"{len(wrap.prompt)} + {DENSE_SERVE_NEW} tokens on one lane "
                f"of {context} at {WRAP_LAYERS} layers in {wrap_s:.2f} s",
    }
    log("[dense-serve] (b) " + json.dumps(result))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _dense_serve_cpu_vs_card()

    # (d) the kernel at the decode shape, mixed kv_len
    t = _flash_timing(DENSE_SERVE_LANES, 1, DENSE_SERVE_CONTEXT, None,
                      [16, 100, 300, 700, 1024, 1500, 2000, 2048],
                      causal=False)
    log(f"[dense-serve] (d) flash at {t['shape']}, mixed kv_len: "
        f"kernel {t['ms']:.4f} ms ({t['launch_ms']:.4f} a launch), bound "
        f"{t['bound_ms']:.5f} ({t['bound_by']}), plain {t['plain_ms']:.4f}, "
        f"SDPA {t['library_ms']:.4f}")
    prefill = _ssm_prefill()
    return launches, prefill, t


# ---------------------------------------------------------------------------
# phase 12: SSM and hybrid serving at full width
# ---------------------------------------------------------------------------

def _layerwise_decode_vs_prefill(cfg, params, T):
    """Each mixer's decode against its prefill on the same input: the
    hidden state that the prefill hands SSM layer i, (B,T,d), goes through
    the layer's full-sequence block and, a token at a time, through
    ``ssm_block_decode`` on a fresh state; likewise each shared-attention
    call of a hybrid through ``attention`` and ``attention_decode``.
    Returns max |diff| / max |prefill| of each mixer's output (before the
    residual), in call order.  Unlike the logits', this distance does not
    compound over the layers above."""
    import torch
    from repro_torch.models import init_decode_state
    from repro_torch.models import transformer as tr
    from repro_torch.models.attention import attention, attention_decode
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.ssm import ssm_block, ssm_block_decode

    B = DECODE_VS_PREFILL_LANES
    dev = params.embed.device
    g = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device=dev)
    errs = []
    with torch.inference_mode():
        x = tr.embed(params.embed, toks)
        pos = torch.arange(T, device=x.device).expand(B, T)
        state = init_decode_state(cfg, B, T, device=x.device)
        caches = iter(state["caches"])
        sa = params.shared_attn
        for _, i, j, shared in tr._segments(cfg):
            for blk, st in zip(params.blocks[i:j], state["ssm_states"][i:j]):
                h = rms_norm(x, blk.ln1, cfg.norm_eps)
                want = ssm_block(blk.ssm, h, cfg)
                got = torch.cat([ssm_block_decode(blk.ssm, h[:, t:t + 1], st,
                                                  cfg)[0] for t in range(T)],
                                dim=1)
                errs.append(rel_err(got, want))
                x = x + want
            if shared and sa is not None:
                h = rms_norm(x, sa.ln, cfg.norm_eps)
                want = attention(sa.attn, h, pos, cfg,
                                 window=cfg.sliding_window)
                cache = next(caches)
                got = torch.cat([attention_decode(
                    sa.attn, h[:, t:t + 1], cache, t, cfg,
                    window=cfg.sliding_window)[0] for t in range(T)], dim=1)
                errs.append(rel_err(got, want))
                x = x + want
    return errs


def _ssm_serve_cpu_vs_card(arch):
    """Part (c): reduced fp32 ``arch`` (zamba2 at 5 layers: two shared-block
    calls and a tail segment) through serve on the card and on the CPU from
    the same weights: 6 requests on 2 lanes, so lanes are recycled."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, serve
    from repro_torch.models import init_lm

    cfg = get_config(arch).reduced().with_(dtype=torch.float32)
    if cfg.attn_every:
        cfg = cfg.with_(n_layers=5)
    params_cpu = init_lm(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to("cuda")
    rng = np.random.default_rng(5)
    spec = [(rng.integers(0, cfg.vocab_size, int(rng.integers(3, 30))
                          ).tolist(), int(rng.integers(4, 11)))
            for _ in range(6)]
    tokens = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        reqs = [Request(i, p, n) for i, (p, n) in enumerate(spec)]
        serve(cfg, reqs, 2, 48, verbose=False, device=dev, params=params)
        tokens[dev] = [r.generated for r in reqs]
    same = tokens["cpu"] == tokens["cuda"]
    log(f"[ssm-serve] (c) reduced fp32 {arch} ({cfg.n_layers} layers), "
        f"{len(spec)} requests on 2 lanes (4 recycled): greedy tokens "
        f"identical card vs cpu: {same}")
    check(same, f"{arch}: card {tokens['cuda']} != cpu {tokens['cpu']}")


def _ssm_serve(arch):
    """Parts (a) to (c) for one arch.  Returns the launches of the serve
    run of part (b)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, serve
    from repro_torch.models import init_lm

    # (a) in fp32 first, as a witness that bf16's distance is rounding
    dist = {}
    for dtype, T, tol in (("float32", DECODE_VS_PREFILL_T_FP32,
                           SSM_LOGITS_FP32_TOL),
                          ("bfloat16", DECODE_VS_PREFILL_T, None)):
        cfg = get_config(arch).with_(n_layers=SSM_SERVE_LAYERS[arch],
                                     dtype=getattr(torch, dtype))
        params = init_lm(cfg, seed=0, device="cuda")
        dist[f"logits_{dtype}"] = _decode_vs_prefill(cfg, params, T, tol,
                                                     "[ssm-serve] (a)")
        layers = _layerwise_decode_vs_prefill(cfg, params, LAYERWISE_T)
        worst = max(layers)
        dist[f"layerwise_{dtype}"] = worst
        log(f"[ssm-serve] (a) {arch} {dtype}: each mixer's decode vs its "
            f"prefill on the same input, {len(layers)} mixers x "
            f"{LAYERWISE_T} tokens: worst {worst:.3e} (mixer "
            f"{layers.index(worst)}), median "
            f"{sorted(layers)[len(layers) // 2]:.3e} (tol "
            f"{REL_TOL[dtype]:.0e})")
        check(worst <= REL_TOL[dtype], f"{arch} {dtype}: a mixer's decode "
              f"differs from its prefill by {worst} of the largest")
        if dtype == "float32":
            del params
            gc.collect()
            torch.cuda.empty_cache()

    # (b) the engine: 16 requests on 8 lanes, after a warm-up
    lanes, context = DENSE_SERVE_LANES, DENSE_SERVE_CONTEXT
    serve(cfg, [Request(-1, [1, 2, 3], 2)], lanes, context, verbose=False,
          device="cuda", params=params)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(16, 129))).tolist(),
                    DENSE_SERVE_NEW) for i in range(DENSE_SERVE_REQUESTS)]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts()
    with counted_serve_steps() as steps, plain_calls() as plain:
        t0 = time.perf_counter()
        serve(cfg, reqs, lanes, context, verbose=False, device="cuda",
              params=params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in reqs:
        check(r.done and len(r.generated) == DENSE_SERVE_NEW,
              f"{arch} request {r.rid}: {len(r.generated)} of "
              f"{DENSE_SERVE_NEW}")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"{arch} request {r.rid}: token out of range")
    check(not plain, f"{arch} serving called plain versions: {plain}")
    n = steps["n"]
    n_attn = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    check(launches["flash_attention"] == n_attn * n,
          f"{arch}: {launches['flash_attention']} flash launches in {n} "
          f"steps, not {n_attn} a step")
    check(launches["rmsnorm"] > 0, f"rmsnorm was never launched serving "
          f"{arch}")
    check(launches["ssd_scan"] == 0 and launches["ssd_scan_bwd"] == 0,
          f"{arch} decode launched the SSD scan: {launches}")
    new = sum(len(r.generated) for r in reqs)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    state_bytes = {
        "ssm_state_bytes": cfg.n_layers * lanes * H * P * N * 4,
        "conv_bytes": (cfg.n_layers * lanes * (cfg.ssm_conv - 1)
                       * (cfg.d_inner + 2 * N) * 4),
        "kv_cache_bytes": (n_attn * 2 * lanes * context * cfg.n_kv_heads
                           * cfg.dh * torch.finfo(cfg.dtype).bits // 8
                           if n_attn else 0)}
    step = _dense_decode_step(cfg, params, f"{arch} decode")
    result = {
        "arch": arch, "layers": cfg.n_layers,
        **{f"decode_vs_prefill_{k}": v for k, v in dist.items()},
        "requests": len(reqs), "lanes": lanes, "context": context,
        "new_tokens": new, "steps": n, "wall_s": wall, "tok_per_s": new / wall,
        "step_wall_ms": 1e3 * wall / n, **step,
        "rmsnorm_per_step": launches["rmsnorm"] / n,
        "plain_calls": sum(plain.values()), **state_bytes,
        "peak_mem_gb": peak_gb,
    }
    log("[ssm-serve] (b) " + json.dumps(result))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _ssm_serve_cpu_vs_card(arch)
    return launches


def phase_ssm_serve():
    """Phase 12.  Returns {path: launches}: each arch's serve run (part b)
    and zamba2's full-width prefill (part d)."""
    launches = {f"{arch.split('-')[0]}_serve": _ssm_serve(arch)
                for arch in SSM_SERVE_ARCHS}
    launches["zamba2_prefill"] = _ssm_prefill("zamba2-1.2b",
                                              "[ssm-serve] (d)")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the paper's plan search in the port: search -> plan -> card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_train_steps(counts=None):
    """Check-only: record the ``remat_segments`` that
    ``launch/train.py`` gives ``make_train_step`` and each step's wall ms
    (host clock ending in a synchronize) while the block runs, and with
    ``counts`` (:func:`_zero_counts`' reader) each step's launches."""
    import torch
    from repro_torch.launch import train as train_cli

    seen = {"remat_segments": [], "step_ms": [], "launches": []}
    real = train_cli.make_train_step

    def make(cfg, opt_cfg=None, *, remat_segments=None):
        seen["remat_segments"].append(remat_segments)
        step = real(cfg, opt_cfg, remat_segments=remat_segments)

        def timed(*args):
            before = counts() if counts else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            seen["step_ms"].append((time.perf_counter() - t0) * 1e3)
            if counts:
                seen["launches"].append({k: v - before[k]
                                         for k, v in counts().items()})
            return out
        return timed

    train_cli.make_train_step = make
    try:
        yield seen
    finally:
        train_cli.make_train_step = real


@contextlib.contextmanager
def recorded_engines():
    """Check-only: keep the ``ServingEngine`` that ``launch/serve.py``
    builds while the block runs (its geometry, pools and metrics)."""
    from repro_torch.launch import serve as serve_mod

    engines = []
    real = serve_mod.ServingEngine

    def make(*args, **kwargs):
        engines.append(real(*args, **kwargs))
        return engines[-1]

    serve_mod.ServingEngine = make
    try:
        yield engines
    finally:
        serve_mod.ServingEngine = real


def _plan_train(run_dir, dense_losses):
    """(a) and (b): search and certify the one-card training plan, then
    ``train --plan`` with it; returns the path's launches."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import CLUSTERS
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.search import certify_plans

    cfg = get_config("qwen3-4b").with_(n_layers=DENSE_LAYERS)
    L = cfg.n_layers
    t0 = time.perf_counter()
    plan = train_cli.search_plan(
        cfg, DENSE_SEQ, cluster=CLUSTERS[PLAN_CLUSTER].with_devices(1),
        batch_grid=[DENSE_BATCH])
    search_s = time.perf_counter() - t0
    check(certify_plans([plan], log=log), "the searched training plan does "
          "not certify")
    path = run_dir / "train.plan.json"
    path.write_text(plan.dumps())
    est_mem = max(plan.est_stage_mem)
    log(f"[plan] (a) qwen3-4b, {L} layers, {DENSE_BATCH} x {DENSE_SEQ} "
        f"tokens on {PLAN_CLUSTER} x1, bmw, batch grid [{DENSE_BATCH}]: "
        f"{plan.summary()}; searched in {search_s:.3f} s and certified; "
        f"cost model: est_iter_time {plan.est_iter_time:.4f} s, "
        f"est_stage_mem {est_mem / 1e9:.2f} GB")
    profiled = _profiled_plan(cfg)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--plan", str(path), "--layers", str(L), "--seq", str(DENSE_SEQ),
            "--batch", str(DENSE_BATCH), "--steps", str(PLAN_TRAIN_STEPS),
            "--lr", str(DENSE_LR), "--log-every", "1"]
    log(f"[plan] (b) python -m repro_torch.launch.train {' '.join(argv)}")
    counts = _zero_counts()
    with recorded_train_steps() as seen, plain_calls() as plain:
        hist = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in hist]
    remat = seen["remat_segments"]
    check(remat == [[s.ckpt for s in plan.strategies[:1]]] == [[True]],
          f"train --plan took remat_segments {remat}, not the plan's "
          "strategies[0].ckpt (on)")
    check(not plain, f"plain versions ran on the plan's training path: "
          f"{plain}")
    n = PLAN_TRAIN_STEPS
    want = {"flash_attention": 2 * L * n, "flash_attention_bwd": L * n,
            "rmsnorm": (8 * L + 1) * n, "rmsnorm_bwd": (4 * L + 1) * n}
    check(all(launches[k] == v for k, v in want.items()),
          f"train --plan launches {launches}, not {want}")
    check(all(np.isfinite(losses)), f"train --plan losses {losses}")
    check(losses == dense_losses[:n], f"train --plan losses {losses} are "
          f"not phase 9's first {n} {dense_losses[:n]}: differences "
          f"{[a - b for a, b in zip(losses, dense_losses)]}")
    step_ms = seen["step_ms"]
    mean_ms = sum(step_ms[1:]) / len(step_ms[1:])
    log("[plan] " + json.dumps({
        "train_losses": losses, "phase9_losses": dense_losses[:n],
        "losses_bit_identical": True, "remat_segments": remat[0],
        "step_ms": step_ms, "step_ms_mean_after_first": mean_ms,
        "est_iter_time_ms": plan.est_iter_time * 1e3,
        "profiled_est_iter_time_ms": profiled["est_iter_time_ms"],
        "measured_over_analytic": mean_ms / (plan.est_iter_time * 1e3),
        "measured_over_profiled": mean_ms / profiled["est_iter_time_ms"],
        "peak_mem_gb": peak_gb, "est_stage_mem_gb": est_mem / 1e9,
        "launches": launches}))
    del hist
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _profiled_plan(cfg):
    """(a'): per-layer times profiled on this card
    (``core/profiler.py::profile_layerspecs``: the reference's fp32 matmul
    chain of each layer's FLOPs, timed with CUDA events, no rescale: the
    profiling host is the target) and the same search priced with them;
    its ``est_iter_time`` in ms, printed beside the analytic one."""
    from repro_torch.configs.specs import layerspecs_for
    from repro_torch.core import CLUSTERS
    from repro_torch.core.profiler import (measure_matmul_throughput,
                                           profile_layerspecs)
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.search import certify_plans

    specs = layerspecs_for(cfg, DENSE_SEQ)
    t0 = time.perf_counter()
    times = profile_layerspecs(specs, device="cuda")
    profile_s = time.perf_counter() - t0
    check(list(times) == list(dict.fromkeys(s.name for s in specs))
          and all(t >= 0 for t in times.values()),
          f"profile_layerspecs gave {times}")
    rate = measure_matmul_throughput(device="cuda")
    t0 = time.perf_counter()
    plan = train_cli.search_plan(
        cfg, DENSE_SEQ, cluster=CLUSTERS[PLAN_CLUSTER].with_devices(1),
        batch_grid=[DENSE_BATCH], profiled_times=times)
    search_s = time.perf_counter() - t0
    check(certify_plans([plan], log=log), "the profiled plan does not "
          "certify")
    distinct = {}
    for s in specs:
        distinct.setdefault(f"{times[s.name]:.6e}", []).append(s.name)
    out = {"est_iter_time_ms": plan.est_iter_time * 1e3,
           "summary": plan.summary(), "profile_s": profile_s,
           "search_s": search_s, "fp32_matmul_tflops_d1024": rate / 1e12,
           "s_per_sample_by_layers": {
               f"{v[0]}..{v[-1]} ({len(v)})" if len(v) > 1 else v[0]: float(t)
               for t, v in distinct.items()}}
    log(f"[plan] (a') profiled: {plan.summary()}; est_iter_time "
        f"{plan.est_iter_time:.4f} s; " + json.dumps(out))
    return out


def _plan_serve(run_dir):
    """(c): search the one-card serving plan through the search CLI, then
    ``serve --plan`` with it; returns the path's launches."""
    import gc

    import torch
    from repro_torch.analysis import load_plan_file
    from repro_torch.launch import search as search_cli
    from repro_torch.launch import serve as serve_mod

    path = run_dir / "serve.plan.json"
    argv = ["--arch", "qwen3-4b", "--cluster", PLAN_CLUSTER, "--devices",
            "1", "--slo-sweep", str(PLAN_SLO_MS), "--max-context",
            str(PLAN_MAX_CONTEXT), "--out", str(path)]
    log(f"[plan] (c) python -m repro_torch.launch.search {' '.join(argv)}")
    check(search_cli.main(argv) == 0, "the SLO search wrote no plan")
    plan, _ = load_plan_file(str(path))
    sv = plan.serving
    check(sv is not None, "the SLO plan has no serving section")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--plan", str(path), "--no-reduced", "--requests",
            str(PLAN_SERVE_REQUESTS), "--batch", str(PLAN_SERVE_LANES),
            "--max-new", str(PLAN_SERVE_NEW)]
    log(f"[plan] (c) python -m repro_torch.launch.serve {' '.join(argv)}")
    counts = _zero_counts()
    with recorded_engines() as engines, plain_calls() as plain:
        reqs = serve_mod.main(argv)
    torch.cuda.synchronize()
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(engines) == 1, f"serve --plan built {len(engines)} engines")
    engine = engines[0]
    ecfg = engine.ecfg
    want = dict(page_size=sv.page_size, n_pages=sv.kv_pool_pages,
                decode_slots=min(sv.decode_batch, PLAN_SERVE_LANES),
                max_context=sv.max_context,
                prefill_chunk=sv.prefill_chunk,
                prefill_batch=min(4, PLAN_SERVE_LANES))
    got = {k: getattr(ecfg, k) for k in want}
    check(got == want, f"the engine's geometry {got} is not the plan's with "
          f"--batch {PLAN_SERVE_LANES}: {want}")
    cfg = engine.cfg
    pool_bytes = sum(t.numel() * t.element_size()
                     for pool in engine.pools for t in pool.values())
    want_bytes = (cfg.n_layers * 2 * (sv.kv_pool_pages + 1) * sv.page_size
                  * cfg.n_kv_heads * cfg.dh * 2)
    check(all(t.is_cuda for pool in engine.pools for t in pool.values())
          and pool_bytes == want_bytes,
          f"the K/V pool holds {pool_bytes} bytes on "
          f"{engine.pools[0]['k'].device}, not the plan's {want_bytes} on "
          "the card")
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in engine.params.parameters())
    for r in reqs:
        check(r.done and len(r.generated) == PLAN_SERVE_NEW,
              f"request {r.rid}: {len(r.generated)} of {PLAN_SERVE_NEW} "
              "tokens")
    check(not plain, f"plain versions ran on the plan's serving path: "
          f"{plain}")
    for name in ("flash_attention", "rmsnorm"):
        check(launches[name] > 0, f"{name} was never launched by serve "
              "--plan")
    summ = engine.metrics.summary()
    check(summ["completed"] == PLAN_SERVE_REQUESTS,
          f"completed {summ['completed']}")
    log("[plan] " + json.dumps({
        "serving_section": sv.to_json(), "engine": dataclasses.asdict(ecfg),
        "kv_pool_gb": pool_bytes / 1e9, "weights_gb": weight_bytes / 1e9,
        "peak_mem_gb": peak_gb, "tok_ms_p50": summ["tok_ms_p50"],
        "tok_ms_p99": summ["tok_ms_p99"],
        "est_tok_ms": sv.est_tok_ms, "est_tok_ms_at_decode_batch":
            sv.decode_batch, "measured_lanes": ecfg.decode_slots,
        "ttft_ms_p50": summ["ttft_ms_p50"], "est_ttft_ms": sv.est_ttft_ms,
        "tok_per_s": summ["tok_per_s"], "est_tok_per_s": sv.est_tok_per_s,
        "decode_steps": summ["decode_steps"],
        "prefill_chunks": summ["prefill_chunks"], "launches": launches}))
    del engines, engine, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_plan(dense_losses):
    """Phase 13: search -> plan -> card for training and for serving."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_plans_") as d:
        run_dir = pathlib.Path(d)
        return {"plan_train": _plan_train(run_dir, dense_losses),
                "plan_serve": _plan_serve(run_dir)}


# ---------------------------------------------------------------------------
# phase 15: the pipeline runtime, 4 ranks on the card
# ---------------------------------------------------------------------------

PIPE_DIR = ROOT / "build" / "pipe"


class RankPool:
    """POOL_SIZE processes, started with spawn, that run the ranks of the
    phases between ``open`` and ``close`` in place of fresh processes: on
    the card's host a process spends seconds importing torch, and the
    first ``torch.utils.checkpoint`` call of a process seconds more
    importing ``torch._dynamo`` (``tools/rank_start_probe.py`` times
    both), once for each rank phase, a dozen times a run.  The processes
    import both while the script works on (no CUDA before their first
    task, so they hold no card memory until then) and are killed by
    ``close``.  Each task runs as in a fresh process: the torch flags a
    task may set back at their defaults, the peak memory statistics
    reset, its process group destroyed and its memory freed after it.  A
    failed, dead or late rank kills the pool and fails the phase."""

    def __init__(self):
        self.procs, self.tasks, self.results = [], [], None

    def open(self):
        if self.procs:
            return
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.results = ctx.Queue()
        self.tasks = [ctx.SimpleQueue() for _ in range(POOL_SIZE)]
        self.procs = [ctx.Process(target=_pool_worker, daemon=True,
                                  args=(i, self.tasks[i], self.results))
                      for i in range(POOL_SIZE)]
        for p in self.procs:
            p.start()

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(10)
        self.procs, self.tasks, self.results = [], [], None

    def run(self, fn, args, nprocs, what, timeout_s):
        import queue
        check(nprocs <= len(self.procs), f"{what}: {nprocs} ranks, a pool "
              f"of {len(self.procs)}")
        for r in range(nprocs):
            self.tasks[r].put((fn, r, args))
        pending, deadline = set(range(nprocs)), time.monotonic() + timeout_s
        try:
            while pending:
                try:
                    rank, err = self.results.get(timeout=1)
                except queue.Empty:
                    dead = [i for i in pending
                            if not self.procs[i].is_alive()]
                    check(not dead, f"{what}: rank {dead} died")
                    check(time.monotonic() < deadline,
                          f"{what}: ranks {sorted(pending)} still running "
                          f"after {timeout_s} s")
                    continue
                check(err is None, f"{what}: rank {rank} failed:\n{err}")
                pending.discard(rank)
        except BaseException:
            self.close()
            raise


def _pool_worker(idx, tasks, results):
    """A process of RankPool: the imports, then ``fn(rank, *args)`` for
    each task until a None; puts ``(rank, None or the traceback)``."""
    import gc
    import traceback

    import torch
    import torch._dynamo  # noqa: F401  (imported by checkpoint's first call)
    import torch.distributed as dist
    import repro_torch.runtime  # noqa: F401

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.get_num_threads())
    while (task := tasks.get()) is not None:
        fn, rank, args = task
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags[:2]
        torch.set_num_threads(flags[2])
        if torch.cuda.is_initialized():
            torch.cuda.reset_peak_memory_stats()
        err = None
        try:
            fn(rank, *args)
        except BaseException:
            err = traceback.format_exc()
        if dist.is_initialized():
            dist.destroy_process_group()
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        results.put((rank, err))


POOL = RankPool()
# what phases 9 and 16 measured, for phase 27's dry run beside them
MEASURED = {}


@contextlib.contextmanager
def pooled_train_ranks():
    """``train --ranks`` and ``train --pipeline --ranks`` run their ranks
    in RankPool's processes (``launch/mesh.py::run_ranks`` looked up at
    the call); ``serve --ranks`` keeps its own, so that the port's spawn
    of ranks runs on the card too."""
    from repro_torch.launch import mesh

    real = mesh.run_ranks

    def run_ranks(fn, args, nprocs, *, timeout_s=None):
        POOL.run(fn, args, nprocs, "train's ranks",
                 timeout_s or POOL_TIMEOUT_S)

    POOL.open()
    mesh.run_ranks = run_ranks
    try:
        yield
    finally:
        mesh.run_ranks = real


def spawn_ranks(fn, args, nprocs, what, timeout_s=PIPE_TIMEOUT_S):
    """``fn(rank, *args)`` in ``nprocs`` of RankPool's processes (started
    here if the pool is closed); a failed or late rank fails the phase.
    Returns the wall seconds."""
    t0 = time.perf_counter()
    POOL.open()
    POOL.run(fn, args, nprocs, what, timeout_s)
    return time.perf_counter() - t0


def _pipe_cfg():
    from repro_torch.configs import get_config
    return get_config("qwen3-4b").with_(n_layers=PIPE_LAYERS)


def _pipe_batch(cfg):
    """The train driver's first batch at the pipeline cell's geometry."""
    from repro_torch.data import DataConfig, synthetic_lm_batches
    return next(synthetic_lm_batches(DataConfig(
        seq_len=PIPE_SEQ, global_batch=PIPE_MICRO,
        vocab_size=cfg.vocab_size)))


def _pipe_launches(L, m, remat, steps=1):
    """Launches of one pipelined loss-and-grads summed over the ranks: per
    micro-batch each layer runs the flash forward once and its four norms
    (ln1, ln2, QK-norm) forward once, the last stage the final norm; a
    remat schedule recomputes each tick's forward in the backward."""
    f = 2 if remat else 1
    return {"flash_attention": L * m * f * steps,
            "flash_attention_bwd": L * m * steps,
            "rmsnorm": (4 * L + 1) * m * f * steps,
            "rmsnorm_bwd": (4 * L + 1) * m * steps}


def pipe_reference(_rank, run_dir):
    """Step 1, a process of its own: the single-process port's ``lm_loss``
    (remat on every layer) and its gradients on the pipeline's weights
    (``init_lm`` seed 0) and batch, saved for the ranks."""
    import torch
    from repro_torch.models.transformer import init_lm, lm_loss
    from repro_torch.optim import global_norm

    torch.cuda.set_device(0)
    cfg = _pipe_cfg()
    params = init_lm(cfg, seed=0, device="cuda")
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in _pipe_batch(cfg).items()}
    leaves = list(params.parameters())
    counts = _zero_counts()
    t0 = time.perf_counter()
    with plain_calls() as plain:
        loss = lm_loss(params, batch, cfg, remat_segments=[True])
        grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    torch.save({"loss": loss.item(), "grad_norm": global_norm(grads).item(),
                "grads": {n: g.cpu() for (n, _), g in
                          zip(params.named_parameters(), grads)},
                "params": sum(p.numel() for p in leaves),
                "wall_ms": wall_ms, "launches": counts(), "plain": plain,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9},
               f"{run_dir}/reference.pt")


def _leaf_err(g, r):
    """max|g - r| / max|r| of two tensors, in slices of 2^24 elements."""
    g, r = g.reshape(-1), r.reshape(-1)
    diff = top = 0.0
    for a in range(0, r.numel(), 1 << 24):
        rs = r[a:a + (1 << 24)].to(g.device).float()
        diff = max(diff, (g[a:a + (1 << 24)].float() - rs).abs().max().item())
        top = max(top, rs.abs().max().item())
    return diff / max(top, 1e-30)


def pipe_rank(rank, world, run_dir):
    """Step 2, one of PIPE_RANKS gloo ranks on the card: its stage of every
    schedule of PIPE_SCHEDULES on the check batch, after one untimed 1f1b
    call; each gradient leaf held against the reference's, the flush
    schedules' against gpipe's bit for bit.  Saves its results."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_pipeline_mesh
    from repro_torch.runtime.pipeline import (init_stage, make_pipeline_loss,
                                              pipeline_grad_norm)

    torch.cuda.set_device(0)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{run_dir}/rendezvous",
                     timeout_s=PIPE_TIMEOUT_S)
    try:
        cfg = _pipe_cfg()
        mesh = make_pipeline_mesh(PIPE_RANKS, 1)
        i = mesh.get_local_rank("pipe")
        ref = torch.load(f"{run_dir}/reference.pt", mmap=True)
        batch = {k: torch.from_numpy(v).reshape(PIPE_MICRO, 1, PIPE_SEQ)
                 for k, v in _pipe_batch(cfg).items()}
        out, stage, kept = {}, None, None
        for sched, V in PIPE_SCHEDULES:
            if stage is None or len(stage.chunks) != V:
                stage = kept = None
                gc.collect()
                torch.cuda.empty_cache()
                stage = init_stage(cfg, PIPE_RANKS, V, i, seed=0,
                                   device="cuda")
                if V == 1:      # warm-up: the first call's set-up untimed
                    make_pipeline_loss(cfg, mesh, PIPE_MICRO,
                                       schedule="1f1b")(stage, batch)
            loss_fn = make_pipeline_loss(cfg, mesh, PIPE_MICRO,
                                         schedule=sched, n_chunks=V)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            counts = _zero_counts()
            t0 = time.perf_counter()
            with plain_calls() as plain:
                loss, grads = loss_fn(stage, batch)
                gnorm = pipeline_grad_norm(stage, grads, mesh)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
            errs = {n: _leaf_err(g, ref["grads"][n])
                    for (n, _), g in zip(stage.named_parameters(), grads)}
            same = None
            if sched == "gpipe":
                kept = ([g.clone() for g in grads], loss.item())
            elif kept is not None:
                same = (loss.item() == kept[1]
                        and all(torch.equal(a, b)
                                for a, b in zip(grads, kept[0])))
            worst = max(errs, key=errs.get)
            out[sched] = {
                "loss": loss.item(), "grad_norm": gnorm.item(),
                "wall_ms": wall_ms, "peak_gb": peak, "launches": launches,
                "plain": plain, "stats": loss_fn.stats, "n_leaves": len(errs),
                "worst_leaf": worst, "worst_err": errs[worst],
                "bit_identical_to_gpipe": same, "layers": stage.chunks}
            del grads, loss
        pathlib.Path(f"{run_dir}/rank{rank}.json").write_text(
            json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def counted_pipeline_rank(rank, world, run_dir, cfg, layout, args):
    """Check-only: ``launch/train.py``'s rank of ``train --pipeline``, with
    the kernels' launches and any plain call counted in the rank and saved
    under PIPE_DIR."""
    from repro_torch.launch.train import _pipeline_rank

    counts = _zero_counts()
    with plain_calls() as plain:
        _pipeline_rank(rank, world, run_dir, cfg, layout, args)
    (PIPE_DIR / f"train_rank{rank}.json").write_text(json.dumps(
        {"launches": counts(), "plain": plain}))


def _pipe_train(check_losses):
    """Step 3: ``train --pipeline --ranks 4`` with the port's searched pp 4
    plan; its first loss must be the check run's for its schedule, bit for
    bit.  Returns the path's launches."""
    import tempfile

    import torch
    from repro_torch.analysis import load_plan_file
    from repro_torch.launch import search as search_cli
    from repro_torch.launch import train as train_cli

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pipe_") as d:
        path = pathlib.Path(d) / "pp.plan.json"
        argv = PIPE_SEARCH + ["--out", str(path)]
        log(f"[pipe] (c) python -m repro_torch.launch.search {' '.join(argv)}")
        check(search_cli.main(argv) == 0, "the search wrote no plan")
        plan, _ = load_plan_file(str(path))
        lay = train_cli.pipeline_layout(plan, PIPE_RANKS, PIPE_LAYERS,
                                        PIPE_MICRO)
        check(plan.pp_degree >= 2 and (lay.n_stages, lay.n_chunks,
                                       lay.n_micro, lay.n_data)
              == (PIPE_RANKS, 1, PIPE_MICRO, 1) and lay.schedule in
              check_losses, f"plan {plan.summary()} runs as {lay}")
        argv = ["--pipeline", "--ranks", str(PIPE_RANKS), "--plan",
                str(path), "--layers", str(PIPE_LAYERS), "--seq",
                str(PIPE_SEQ), "--batch", str(PIPE_MICRO), "--steps",
                str(PIPE_TRAIN_STEPS), "--lr", str(DENSE_LR), "--log-every",
                "1"]
        log(f"[pipe] (c) python -m repro_torch.launch.train {' '.join(argv)}")
        real = train_cli._pipeline_rank
        train_cli._pipeline_rank = counted_pipeline_rank
        try:
            t0 = time.perf_counter()
            with pooled_train_ranks():
                hist = train_cli.main(argv)
            wall_s = time.perf_counter() - t0
        finally:
            train_cli._pipeline_rank = real
    ranks = [json.loads((PIPE_DIR / f"train_rank{r}.json").read_text())
             for r in range(PIPE_RANKS)]
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    plain = [r["plain"] for r in ranks if r["plain"]]
    losses = [h["loss"] for h in hist]
    check(len(losses) == PIPE_TRAIN_STEPS
          and all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(not plain, f"plain versions ran in train --pipeline: {plain}")
    want = _pipe_launches(PIPE_LAYERS, PIPE_MICRO, lay.schedule != "gpipe",
                          PIPE_TRAIN_STEPS)
    check(all(launches[k] == v for k, v in want.items()),
          f"train --pipeline launches {launches}, not {want}")
    check(losses[0] == check_losses[lay.schedule], f"train --pipeline's "
          f"first loss {losses[0]} is not the check run's "
          f"{lay.schedule} loss {check_losses[lay.schedule]}")
    log("[pipe] " + json.dumps({
        "plan": plan.summary(), "layout": dataclasses.asdict(lay),
        "losses": losses, "first_loss_is_check_runs": True,
        "step_ms": [h["step_ms"] for h in hist],
        "peak_mem_gb_by_rank": [hist[-1][f"peak_mem_gb_rank{r}"]
                                for r in range(PIPE_RANKS)],
        "wall_s": wall_s, "launches": launches})
        + " (4 ranks share one card: not a pipeline's speed)")
    return launches


def phase_pipeline():
    """Phase 15: the single-process reference, the four schedules on 4
    ranks against it, then ``train --pipeline --ranks 4``."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    PIPE_DIR.mkdir(parents=True)
    cfg = _pipe_cfg()
    log(f"[pipe] qwen3-4b at full width, {PIPE_LAYERS} of 36 layers, "
        f"{PIPE_MICRO} micro-batches of 1 x {PIPE_SEQ} tokens, "
        f"{PIPE_RANKS} gloo ranks on one card")
    ref_s = spawn_ranks(pipe_reference, (str(PIPE_DIR),), 1,
                        "the single-process reference")
    ref = torch.load(PIPE_DIR / "reference.pt", mmap=True)
    check(not ref["plain"], f"plain versions ran in the reference: "
          f"{ref['plain']}")
    ref_launches = dict(ref["launches"])
    # one batch, every layer recomputed in the backward; the final norm,
    # outside the stack, is not
    L = PIPE_LAYERS
    want = {"flash_attention": 2 * L, "flash_attention_bwd": L,
            "rmsnorm": 2 * 4 * L + 1, "rmsnorm_bwd": 4 * L + 1}
    check(all(ref_launches[k] == v for k, v in want.items()),
          f"the reference's launches {ref_launches}, not {want}")
    log(f"[pipe] (a) single process: loss {ref['loss']!r}, grad norm "
        f"{ref['grad_norm']:.6f}, {ref['params'] / 1e9:.3f} B params, "
        f"{ref['wall_ms']:.1f} ms, peak {ref['peak_gb']:.2f} GB, process "
        f"{ref_s:.1f} s")
    ranks_s = spawn_ranks(pipe_rank, (PIPE_RANKS, str(PIPE_DIR)), PIPE_RANKS,
                          "pipeline ranks")
    res = [json.loads((PIPE_DIR / f"rank{r}.json").read_text())
           for r in range(PIPE_RANKS)]
    # the four schedules' launches only: the reference's are its own path
    launches = {k: 0 for k in ref_launches}
    check_losses = {}
    for sched, V in PIPE_SCHEDULES:
        rows = [r[sched] for r in res]
        loss = rows[0]["loss"]
        check(all(r["loss"] == loss for r in rows),
              f"{sched}: ranks disagree on the loss")
        check(not any(r["plain"] for r in rows), f"{sched}: plain versions "
              f"ran: {[r['plain'] for r in rows]}")
        rel = abs(loss - ref["loss"]) / abs(ref["loss"])
        worst = max(rows, key=lambda r: r["worst_err"])
        got = {k: sum(r["launches"][k] for r in rows)
               for k in rows[0]["launches"]}
        want = _pipe_launches(PIPE_LAYERS, PIPE_MICRO, sched != "gpipe")
        check(all(got[k] == v for k, v in want.items()),
              f"{sched}: launches {got}, not {want}")
        for k, v in got.items():
            launches[k] += v
        check(sum(r["n_leaves"] for r in rows) == len(ref["grads"]),
              f"{sched}: {[r['n_leaves'] for r in rows]} leaves")
        check(rel <= PIPE_LOSS_RTOL, f"{sched}: loss {loss} against the "
              f"single process's {ref['loss']} (rel {rel:.3e})")
        check(worst["worst_err"] <= PIPE_GRAD_TOL, f"{sched}: gradient "
              f"{worst['worst_leaf']} off by {worst['worst_err']:.3e} of its "
              "largest magnitude")
        if sched in ("1f1b", "zb-h1"):
            check(all(r["bit_identical_to_gpipe"] for r in rows),
                  f"{sched}: loss or gradients differ from gpipe's")
        check_losses[sched] = loss
        for r, row in enumerate(rows):
            st = row["stats"]
            check(st["work_ticks"] == PIPE_MICRO * V and st["bubble_ticks"]
                  == st["program_bubble_ticks"], f"{sched} rank {r}: {st}")
            log(f"[pipe] (b) {sched:16s} rank {r} layers {row['layers']}: "
                f"{st['work_ticks']} ticks worked, {st['bubble_ticks']} "
                f"bubble (program: {st['program_bubble_ticks']}); busy "
                f"{st['busy_s'] * 1e3:.1f} ms, receive wait "
                f"{st['recv_wait_s'] * 1e3:.1f} ms, call "
                f"{row['wall_ms']:.1f} ms; peak {row['peak_gb']:.2f} GB")
        log(f"[pipe] (b) {sched}: loss {loss!r} (single process "
            f"{ref['loss']!r}, rel {rel:.3e}); worst gradient leaf "
            f"{worst['worst_leaf']} at {worst['worst_err']:.3e} of its "
            f"largest magnitude; grad norm {rows[0]['grad_norm']:.6f} "
            f"(single process {ref['grad_norm']:.6f})"
            + ("; loss and gradients bit for bit gpipe's"
               if sched in ("1f1b", "zb-h1") else ""))
    log(f"[pipe] (b) the four schedules in {ranks_s:.1f} s")
    del ref
    train_launches = _pipe_train(check_losses)
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    return {"pipe_reference": ref_launches, "pipe": launches,
            "pipe_train": train_launches}


# ---------------------------------------------------------------------------
# phase 16: the sharded executor, 4 ranks on the card
# ---------------------------------------------------------------------------

SHARD_DIR = ROOT / "build" / "shard"


def _shard_cfg():
    from repro_torch.configs import get_config
    return get_config("qwen3-4b").with_(n_layers=SHARD_LAYERS)


def _shard_batches(cfg):
    """The train driver's first SHARD_STEPS batches, CPU tensors."""
    import torch
    from repro_torch.data import DataConfig, synthetic_lm_batches
    gen = synthetic_lm_batches(DataConfig(
        seq_len=SHARD_SEQ, global_batch=SHARD_BATCH,
        vocab_size=cfg.vocab_size))
    return [{k: torch.from_numpy(v) for k, v in next(gen).items()}
            for _ in range(SHARD_STEPS)]


def _held_bytes(params, opt, local):
    """Bytes of a rank's parameters, AdamW state (master and moments) and
    rows of the batch: what the dry run calls its argument bytes."""
    def n(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    return {"param_bytes": n(params.parameters()),
            "optimizer_bytes": n([*opt["master"], *opt["m"], *opt["v"]]),
            "input_bytes": n(local.values())}


def _shard_launches(L, calls=1):
    """Launches of ``calls`` losses and gradients with remat on every
    layer, on one rank or the single process: per layer the flash forward
    twice (remat recomputes it) and the backward once, four norms (ln1,
    ln2, QK-norm) twice forward and once backward; the final norm once
    each way."""
    return {"flash_attention": 2 * L * calls,
            "flash_attention_bwd": L * calls,
            "rmsnorm": (8 * L + 1) * calls,
            "rmsnorm_bwd": (4 * L + 1) * calls}


def shard_reference(_rank, run_dir):
    """(a), a process of its own: the single-process ``lm_loss`` and its
    gradients (remat on every layer) on ``init_lm`` seed 0 and the first
    batch, then SHARD_STEPS ``make_train_step`` steps at phase 9's lr on
    the driver's batches; saved for the ranks."""
    import torch
    from repro_torch.models.transformer import init_lm, lm_loss
    from repro_torch.optim import AdamWConfig, adamw_init, global_norm
    from repro_torch.runtime.executor import make_train_step

    torch.cuda.set_device(0)
    cfg = _shard_cfg()
    params = init_lm(cfg, seed=0, device="cuda")
    batches = [{k: v.to("cuda") for k, v in b.items()}
               for b in _shard_batches(cfg)]
    leaves = list(params.parameters())
    counts = _zero_counts()
    t0 = time.perf_counter()
    with plain_calls() as plain:
        loss = lm_loss(params, batches[0], cfg, remat_segments=[True])
        grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    saved = {"loss": loss.item(), "grad_norm": global_norm(grads).item(),
             "grads": {n: g.cpu() for (n, _), g in
                       zip(params.named_parameters(), grads)},
             "params": sum(p.numel() for p in leaves), "wall_ms": wall_ms,
             "launches": launches, "plain": plain}
    del grads, loss
    ocfg = AdamWConfig(lr=DENSE_LR)
    opt = adamw_init(leaves, ocfg)
    step = make_train_step(cfg, ocfg, remat_segments=[True])
    with plain_calls() as plain:
        saved["losses"] = [float(step(params, opt, b)["loss"])
                           for b in batches]
    saved["plain"].update(plain)
    saved["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.save(saved, f"{run_dir}/reference.pt")


def shard_rank(rank, world, run_dir):
    """(b), one of SHARD_RANKS gloo ranks on the card, on a SHARD_MESH
    (data, model) mesh with TP, ZeRO and remat: its drawn shards, the
    sharded loss and gradients with ``seq_shard`` off and on (each leaf
    gathered and, on rank 0, held against the reference's; with
    ``seq_shard`` on only when its bits differ from off's), then
    SHARD_STEPS sharded steps.  Saves its results."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (ShardPolicy, init_train_state,
                                     make_sharded_loss, make_train_step)

    torch.cuda.set_device(0)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{run_dir}/rendezvous",
                     timeout_s=SHARD_TIMEOUT_S)
    try:
        cfg = _shard_cfg()
        mesh = make_local_mesh(SHARD_MESH[1])
        pol = ShardPolicy(tp=True, zero=True, remat_segments=(True,))
        ocfg = AdamWConfig(lr=DENSE_LR)
        t0 = time.perf_counter()
        params, opt = init_train_state(cfg, mesh=mesh, policy=pol, seed=0,
                                       opt_cfg=ocfg, device="cuda")
        torch.cuda.synchronize()
        out = {"init_s": time.perf_counter() - t0,
               "coord": [mesh.get_local_rank("data"),
                         mesh.get_local_rank("model")],
               "params_local": sum(p.numel() for p in params.parameters())}
        ref = torch.load(f"{run_dir}/reference.pt", mmap=True)
        batches = _shard_batches(cfg)
        named = list(params.named_parameters())
        kept = None
        for seq in (False, True):
            loss_fn = make_sharded_loss(
                cfg, mesh, dataclasses.replace(pol, seq_shard=seq))
            torch.cuda.synchronize()
            dist.barrier()
            counts = _zero_counts()
            t0 = time.perf_counter()
            with plain_calls() as plain:
                loss, grads = loss_fn(params, batches[0])
            torch.cuda.synchronize()
            row = {"loss": loss.item(), "launches": counts(), "plain": plain,
                   "ms": (time.perf_counter() - t0) * 1e3,
                   "gloo_bytes": loss_fn.shard.traffic.bytes_sent,
                   "grad_norm": loss_fn.shard.grad_norm(named, grads).item()}
            if kept is None:
                kept = (loss.item(), grads)
            else:
                same = torch.tensor([int(loss.item() == kept[0] and all(
                    torch.equal(a, b) for a, b in zip(grads, kept[1])))])
                dist.all_reduce(same, op=dist.ReduceOp.MIN)
                row["same_bits"] = bool(same.item())
            if row.get("same_bits"):    # the same gradients: seq0's errors
                row.update({k: out["seq0"].get(k) for k in (
                    "n_leaves", "worst_leaf", "worst_err")})
            else:
                errs = {}
                for (n, _), g in zip(named, grads):
                    full = loss_fn.shard.gather_tensor(n, g)
                    if rank == 0:
                        errs[n] = _leaf_err(full, ref["grads"][n])
                    del full
                if rank == 0:
                    worst = max(errs, key=errs.get)
                    row.update(n_leaves=len(errs), worst_leaf=worst,
                               worst_err=errs[worst])
            out[f"seq{int(seq)}"] = row
            del grads, loss
        del kept
        step = make_train_step(cfg, ocfg, mesh=mesh, policy=pol)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        counts = _zero_counts()
        hist = []
        with plain_calls() as plain:
            for b in batches:
                sent = step.shard.traffic.bytes_sent
                per_op = dict(step.shard.traffic.per_op)
                t0 = time.perf_counter()
                m = step(params, opt, b)
                torch.cuda.synchronize()
                hist.append({"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "ms": (time.perf_counter() - t0) * 1e3,
                             "gloo_bytes": step.shard.traffic.bytes_sent
                             - sent,
                             "gloo_per_op": {
                                 k: v - per_op[k] for k, v in
                                 step.shard.traffic.per_op.items()}})
        out.update(steps=hist, launches=counts(), plain=plain,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   held=_held_bytes(params, opt, step.shard.local_batch(
                       batches[0], torch.device("cuda"))))
        pathlib.Path(f"{run_dir}/rank{rank}.json").write_text(
            json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def counted_sharded_rank(rank, world, run_dir, cfg, policy, args):
    """Check-only: ``launch/train.py``'s rank of ``train --ranks``, with the
    kernels' launches and any plain call counted in the rank and saved
    under SHARD_DIR."""
    from repro_torch.launch.train import _sharded_rank

    counts = _zero_counts()
    with plain_calls() as plain:
        _sharded_rank(rank, world, run_dir, cfg, policy, args)
    (SHARD_DIR / f"train_rank{rank}.json").write_text(json.dumps(
        {"launches": counts(), "plain": plain}))


def _shard_train(ref):
    """(c): the port's search for SHARD_RANKS cards of the H100 node at
    this model, then ``train --ranks 4 --plan``; the policy it prints must
    be the plan's, its first loss within SHARD_LOSS_RTOL of (a)'s.
    Returns the path's launches."""
    import io
    import tempfile

    from repro_torch.core import CLUSTERS
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.search import certify_plans

    cfg = _shard_cfg()
    cluster = dataclasses.replace(
        CLUSTERS[PLAN_CLUSTER].with_devices(SHARD_RANKS),
        memory_budget=SHARD_BUDGET_GB * 1e9)
    plan = train_cli.search_plan(cfg, SHARD_SEQ, cluster=cluster,
                                 batch_grid=[SHARD_BATCH])
    check(certify_plans([plan], log=log), "the searched plan does not "
          "certify")
    policy = train_cli.middle_strategy_policy(plan)
    log(f"[shard] (c) {PLAN_CLUSTER} x{SHARD_RANKS}, budget "
        f"{SHARD_BUDGET_GB} GB a card, batch grid [{SHARD_BATCH}]: "
        f"{plan.summary()}; the driver's policy {policy}")
    check(policy.zero, f"the plan's middle strategy replicates the state "
          f"({policy}): {SHARD_RANKS} replicas do not fit one card")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as d:
        path = pathlib.Path(d) / "shard.plan.json"
        path.write_text(plan.dumps())
        argv = ["--ranks", str(SHARD_RANKS), "--plan", str(path),
                "--layers", str(SHARD_LAYERS), "--seq", str(SHARD_SEQ),
                "--batch", str(SHARD_BATCH), "--steps", str(SHARD_STEPS),
                "--lr", str(DENSE_LR), "--log-every", "1"]
        log(f"[shard] (c) python -m repro_torch.launch.train "
            f"{' '.join(argv)}")
        real = train_cli._sharded_rank
        train_cli._sharded_rank = counted_sharded_rank
        printed = io.StringIO()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed), pooled_train_ranks():
                hist = train_cli.main(argv)
            wall_s = time.perf_counter() - t0
        finally:
            train_cli._sharded_rank = real
            log(printed.getvalue().rstrip())
    check(f"policy={policy}" in printed.getvalue()
          and f"mesh={{'data': {SHARD_RANKS}, 'model': 1}}"
          in printed.getvalue(), "train --ranks did not print the plan's "
          "policy on make_local_mesh()")
    ranks = [json.loads((SHARD_DIR / f"train_rank{r}.json").read_text())
             for r in range(SHARD_RANKS)]
    plain = [r["plain"] for r in ranks if r["plain"]]
    check(not plain, f"plain versions ran in train --ranks: {plain}")
    want = _shard_launches(SHARD_LAYERS, SHARD_STEPS)
    for r, res in enumerate(ranks):
        check(all(res["launches"][k] == v for k, v in want.items()),
              f"train --ranks rank {r} launches {res['launches']}, not "
              f"{want}")
    losses = [h["loss"] for h in hist]
    check(len(losses) == SHARD_STEPS
          and all(math.isfinite(x) for x in losses), f"losses {losses}")
    rel = abs(losses[0] - ref["loss"]) / abs(ref["loss"])
    check(rel <= SHARD_LOSS_RTOL, f"train --ranks' first loss {losses[0]} "
          f"against the single process's {ref['loss']} (rel {rel:.3e})")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    log("[shard] (c) " + json.dumps({
        "plan": plan.summary(), "policy": str(policy), "losses": losses,
        "single_process_losses": ref["losses"], "first_loss_rel": rel,
        "step_ms": [h["step_ms"] for h in hist],
        "gloo_bytes_sent_rank0": [h["gloo_bytes_sent"] for h in hist],
        "peak_mem_gb_by_rank": [hist[-1][f"peak_mem_gb_rank{r}"]
                                for r in range(SHARD_RANKS)],
        "wall_s": wall_s, "launches": launches})
        + " (4 ranks share one card: not sharded training's speed)")
    return launches


def phase_shard():
    """Phase 16: the single-process reference, the sharded step on a (data
    2, model 2) mesh against it, then ``train --ranks 4 --plan``."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    SHARD_DIR.mkdir(parents=True)
    L = SHARD_LAYERS
    log(f"[shard] qwen3-4b at full width, {L} of 36 layers, "
        f"{SHARD_BATCH} x {SHARD_SEQ} tokens, {SHARD_RANKS} gloo ranks on "
        f"one card")
    ref_s = spawn_ranks(shard_reference, (str(SHARD_DIR),), 1,
                        "the single-process reference",
                        timeout_s=SHARD_TIMEOUT_S)
    ref = torch.load(SHARD_DIR / "reference.pt", mmap=True)
    check(not ref["plain"], f"plain versions ran in the reference: "
          f"{ref['plain']}")
    want = _shard_launches(L)
    check(all(ref["launches"][k] == v for k, v in want.items()),
          f"the reference's launches {ref['launches']}, not {want}")
    check(all(math.isfinite(x) for x in ref["losses"]),
          f"the reference's losses {ref['losses']}")
    log(f"[shard] (a) single process: loss {ref['loss']!r}, grad norm "
        f"{ref['grad_norm']:.6f}, {ref['params'] / 1e9:.3f} B params, "
        f"{ref['wall_ms']:.1f} ms; {SHARD_STEPS} steps at lr {DENSE_LR}: "
        f"losses {ref['losses']}; peak {ref['peak_gb']:.2f} GB; process "
        f"{ref_s:.1f} s")
    ranks_s = spawn_ranks(shard_rank, (SHARD_RANKS, str(SHARD_DIR)),
                          SHARD_RANKS, "sharded ranks",
                          timeout_s=SHARD_TIMEOUT_S)
    res = [json.loads((SHARD_DIR / f"rank{r}.json").read_text())
           for r in range(SHARD_RANKS)]
    check([r["coord"] for r in res] == [[0, 0], [0, 1], [1, 0], [1, 1]],
          f"mesh coordinates {[r['coord'] for r in res]}")
    for seq in (0, 1):
        rows = [r[f"seq{seq}"] for r in res]
        tag = f"seq_shard={bool(seq)}"
        loss = rows[0]["loss"]
        check(all(r["loss"] == loss for r in rows),
              f"{tag}: ranks disagree on the loss")
        check(not any(r["plain"] for r in rows), f"{tag}: plain versions "
              f"ran: {[r['plain'] for r in rows]}")
        for r, row in enumerate(rows):
            check(all(row["launches"][k] == v for k, v in want.items()),
                  f"{tag} rank {r}: launches {row['launches']}, not {want}")
        rel = abs(loss - ref["loss"]) / abs(ref["loss"])
        check(rows[0]["n_leaves"] == len(ref["grads"]),
              f"{tag}: {rows[0]['n_leaves']} leaves")
        check(rel <= SHARD_LOSS_RTOL, f"{tag}: loss {loss} against the "
              f"single process's {ref['loss']} (rel {rel:.3e})")
        check(rows[0]["worst_err"] <= SHARD_GRAD_TOL, f"{tag}: gradient "
              f"{rows[0]['worst_leaf']} off by {rows[0]['worst_err']:.3e} "
              "of its largest magnitude")
        same = ""
        if seq:
            same = ("; loss and gradients the same bits as seq_shard=False"
                    if rows[0]["same_bits"] else "; NOT the same bits as "
                    "seq_shard=False, within the gates above")
        log(f"[shard] (b) {tag}: loss {loss!r} (single process "
            f"{ref['loss']!r}, rel {rel:.3e}); worst gradient leaf "
            f"{rows[0]['worst_leaf']} at {rows[0]['worst_err']:.3e} of its "
            f"largest magnitude; grad norm {rows[0]['grad_norm']:.6f} "
            f"(single process {ref['grad_norm']:.6f}); call ms by rank "
            f"{[round(r['ms'], 1) for r in rows]}, gloo bytes sent by rank "
            f"{[r['gloo_bytes'] for r in rows]}" + same)
    steps = [r["steps"] for r in res]
    losses = [h["loss"] for h in steps[0]]
    check(all([h["loss"] for h in s] == losses for s in steps),
          "ranks disagree on the step losses")
    check(all(math.isfinite(x) for x in losses), f"step losses {losses}")
    check(not any(r["plain"] for r in res), "plain versions ran in the "
          f"steps: {[r['plain'] for r in res]}")
    want_steps = _shard_launches(L, SHARD_STEPS)
    for r, row in enumerate(res):
        check(all(row["launches"][k] == v for k, v in want_steps.items()),
              f"steps rank {r}: launches {row['launches']}, not "
              f"{want_steps}")
        log(f"[shard] (b) rank {r} (data {row['coord'][0]}, model "
            f"{row['coord'][1]}): {row['params_local'] / 1e6:.1f} M params, "
            f"init {row['init_s']:.1f} s; step ms "
            f"{[round(h['ms'], 1) for h in row['steps']]}, gloo bytes sent "
            f"a step {[h['gloo_bytes'] for h in row['steps']]}; peak "
            f"{row['peak_gb']:.2f} GB")
    log(f"[shard] (b) {SHARD_STEPS} sharded steps: losses {losses} (single "
        f"process {ref['losses']}); ranks in {ranks_s:.1f} s (4 ranks share "
        "one card: not sharded training's speed)")
    launches = {k: sum(r["launches"][k] for r in res)
                for k in res[0]["launches"]}
    # phase 27 holds the dry run of this step against these ranks
    MEASURED["shard"] = [dict(r["held"], bytes_sent=r["steps"][0][
        "gloo_bytes"], per_op=r["steps"][0]["gloo_per_op"]) for r in res]
    train_launches = _shard_train(ref)
    ref_launches = dict(ref["launches"])
    del ref
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    return {"shard_reference": ref_launches, "shard": launches,
            "shard_train": train_launches}


# ---------------------------------------------------------------------------
# phase 17: SSM and hybrid TP, sharded checkpoints, 4 ranks on the card
# ---------------------------------------------------------------------------

SSMTP_DIR = ROOT / "build" / "ssm_tp"


def _ssmtp_cfg(arch, dtype="bfloat16"):
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch).with_(dtype=getattr(torch, dtype))
    if arch == "zamba2-1.2b":
        cfg = cfg.with_(n_layers=SSMTP_ZAMBA2_LAYERS)
    if arch == "mamba2-370m":
        cfg = cfg.with_(n_layers=SSMTP_MAMBA2_LAYERS)
    return cfg


def _ssmtp_steps(arch):
    return SSMTP_ZAMBA2_STEPS if arch == "zamba2-1.2b" else SSMTP_STEPS


def _ssmtp_batches(cfg):
    """The train driver's first batches, one a step of ``cfg``'s model
    (:func:`_ssmtp_steps`), CPU tensors."""
    import torch
    from repro_torch.data import DataConfig, synthetic_lm_batches
    gen = synthetic_lm_batches(DataConfig(
        seq_len=SSMTP_SEQ, global_batch=SSMTP_BATCH,
        vocab_size=cfg.vocab_size))
    return [{k: torch.from_numpy(v) for k, v in next(gen).items()}
            for _ in range(_ssmtp_steps(cfg.name))]


def _ssm_launches(cfg, calls=1, remat=True):
    """Launches of ``calls`` losses and gradients of an SSM or hybrid model,
    on one rank or the single process: per SSM layer the SSD forward and
    two norms (ln1, the gated norm) once each, twice under remat (the
    recompute), and the SSD backward and the norms' backward once; per
    shared attention call of the hybrid (not rematerialised) the flash
    forward, backward and its norm once each; the final norm once each
    way."""
    from repro_torch.models.transformer import _segments

    L, f = cfg.n_layers, 2 if remat else 1
    n_attn = sum(shared for *_, shared in _segments(cfg))
    return {"ssd_scan": f * L * calls, "ssd_scan_bwd": L * calls,
            "flash_attention": n_attn * calls,
            "flash_attention_bwd": n_attn * calls,
            "rmsnorm": (2 * f * L + n_attn + 1) * calls,
            "rmsnorm_bwd": (2 * L + n_attn + 1) * calls}


def _loss_and_grads(params, batch, cfg):
    """The single process's ``lm_loss`` and gradients, remat on every
    layer, with its launches and plain calls: a dict."""
    import torch
    from repro_torch.models.transformer import lm_loss
    from repro_torch.optim import global_norm

    leaves = list(params.parameters())
    counts = _zero_counts()
    t0 = time.perf_counter()
    with plain_calls() as plain:
        loss = lm_loss(params, batch, cfg, remat_segments=[True])
        grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return {"loss": loss.item(), "grad_norm": global_norm(grads).item(),
            "grads": {n: g.cpu() for (n, _), g in
                      zip(params.named_parameters(), grads)},
            "wall_ms": (time.perf_counter() - t0) * 1e3,
            "launches": counts(), "plain": plain}


def ssmtp_reference(_rank, run_dir, arch):
    """(a) and (b), a process of its own, on ``init_lm`` seed 0 and the
    driver's first batch: in fp32 the single-process ``lm_loss`` and its
    gradients (remat on every layer); in bf16 the same, then
    :func:`_ssmtp_steps` ``make_train_step`` steps at SSMTP_LR on the
    driver's batches; saved for the ranks."""
    import gc

    import torch
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.executor import make_train_step

    torch.cuda.set_device(0)
    saved = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _ssmtp_cfg(arch, dtype)
        params = init_lm(cfg, seed=0, device="cuda")
        batches = [{k: v.to("cuda") for k, v in b.items()}
                   for b in _ssmtp_batches(cfg)]
        row = _loss_and_grads(params, batches[0], cfg)
        row["params"] = sum(p.numel() for p in params.parameters())
        if dtype == "bfloat16":
            del row["grads"]        # the ranks' gradients are held in fp32
            ocfg = AdamWConfig(lr=SSMTP_LR)
            opt = adamw_init(list(params.parameters()), ocfg)
            step = make_train_step(cfg, ocfg, remat_segments=[True])
            with plain_calls() as plain:
                row["losses"] = [float(step(params, opt, b)["loss"])
                                 for b in batches]
            row["plain"].update(plain)
            row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del opt, step
        saved[dtype] = row
        del params, batches
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(saved, f"{run_dir}/{arch}.reference.pt")


def _dir_bytes(d):
    return sum(f.stat().st_size for f in pathlib.Path(d).rglob("*")
               if f.is_file())


def _sharded_call(cfg, mesh, pol, params, batch):
    """One sharded loss and gradients on this rank, timed to a
    synchronize after a barrier: (loss, grads, row, context)."""
    import torch
    import torch.distributed as dist
    from repro_torch.runtime import make_sharded_loss

    loss_fn = make_sharded_loss(cfg, mesh, pol)
    named = list(params.named_parameters())
    torch.cuda.synchronize()
    dist.barrier()
    counts = _zero_counts()
    t0 = time.perf_counter()
    with plain_calls() as plain:
        loss, grads = loss_fn(params, batch)
    torch.cuda.synchronize()
    row = {"loss": loss.item(), "launches": counts(), "plain": plain,
           "ms": (time.perf_counter() - t0) * 1e3,
           "gloo_bytes": loss_fn.shard.traffic.bytes_sent,
           "grad_norm": loss_fn.shard.grad_norm(named, grads).item()}
    return loss, grads, row, loss_fn.shard


def ssmtp_rank(rank, world, run_dir, arch, save):
    """(a) and (b), one of SSMTP_RANKS gloo ranks on the card, on a
    SSMTP_MESH (data, model) mesh with TP, ZeRO and remat.  In fp32: its
    drawn shards, the sharded loss and gradients, each leaf gathered and,
    on rank 0, held against the reference's.  In bf16: its drawn shards,
    the sharded loss and gradients with ``seq_shard`` off and on, then
    :func:`_ssmtp_steps` sharded steps; with ``save`` the state after step
    SSMTP_SAVE_AT is saved (``save_sharded_train_state``) under
    SSMTP_DIR/ckpt.  Saves its results."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.checkpointing import save_sharded_train_state
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (ShardPolicy, init_train_state,
                                     make_train_step)

    torch.cuda.set_device(0)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{run_dir}/rendezvous_{arch}",
                     timeout_s=SHARD_TIMEOUT_S)
    try:
        mesh = make_local_mesh(SSMTP_MESH[1])
        pol = ShardPolicy(tp=True, zero=True, remat_segments=(True,))
        ocfg = AdamWConfig(lr=SSMTP_LR)
        out = {"coord": [mesh.get_local_rank("data"),
                         mesh.get_local_rank("model")]}
        # fp32: the gradients, leaf by leaf
        cfg = _ssmtp_cfg(arch, "float32")
        params, _ = init_train_state(cfg, mesh=mesh, policy=pol, seed=0,
                                     opt_cfg=ocfg, device="cuda")
        batches = _ssmtp_batches(cfg)
        _, grads, row, ctx = _sharded_call(cfg, mesh, pol, params,
                                           batches[0])
        ref = torch.load(f"{run_dir}/{arch}.reference.pt", mmap=True)
        errs = {}
        for (n, _), g in zip(params.named_parameters(), grads):
            full = ctx.gather_tensor(n, g)
            if rank == 0:
                errs[n] = _leaf_err(full, ref["float32"]["grads"][n])
            del full
        if rank == 0:
            worst = max(errs, key=errs.get)
            row.update(n_leaves=len(errs), worst_leaf=worst,
                       worst_err=errs[worst])
        out["fp32"] = row
        del params, grads, ref, ctx
        gc.collect()
        torch.cuda.empty_cache()
        # bf16: the loss with seq_shard off and on, then the steps
        cfg = _ssmtp_cfg(arch)
        t0 = time.perf_counter()
        params, opt = init_train_state(cfg, mesh=mesh, policy=pol, seed=0,
                                       opt_cfg=ocfg, device="cuda")
        torch.cuda.synchronize()
        out.update(init_s=time.perf_counter() - t0,
                   params_local=sum(p.numel() for p in params.parameters()))
        kept = None
        for seq in (False, True):
            loss, grads, row, _ = _sharded_call(
                cfg, mesh, dataclasses.replace(pol, seq_shard=seq), params,
                batches[0])
            if kept is None:
                kept = (loss.item(), grads)
            else:
                same = torch.tensor([int(loss.item() == kept[0] and all(
                    torch.equal(a, b) for a, b in zip(grads, kept[1])))])
                dist.all_reduce(same, op=dist.ReduceOp.MIN)
                row["same_bits"] = bool(same.item())
            out[f"seq{int(seq)}"] = row
            del grads, loss
        del kept
        step = make_train_step(cfg, ocfg, mesh=mesh, policy=pol)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        counts = _zero_counts()
        hist = []
        with plain_calls() as plain:
            for i, b in enumerate(batches, 1):
                sent = step.shard.traffic.bytes_sent
                t0 = time.perf_counter()
                m = step(params, opt, b)
                torch.cuda.synchronize()
                hist.append({"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "ms": (time.perf_counter() - t0) * 1e3,
                             "gloo_bytes": step.shard.traffic.bytes_sent
                             - sent})
                if save and i == SSMTP_SAVE_AT:
                    sent = step.shard.traffic.bytes_sent
                    t0 = time.perf_counter()
                    save_sharded_train_state(i, params, opt, step.shard,
                                             SSMTP_DIR / "ckpt",
                                             extra={"arch": arch})
                    out["save"] = {"s": time.perf_counter() - t0,
                                   "gloo_bytes": step.shard.traffic.bytes_sent
                                   - sent}
        out.update(steps=hist, launches=counts(), plain=plain,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        pathlib.Path(f"{run_dir}/{arch}.rank{rank}.json").write_text(
            json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def ssmtp_resume_rank(rank, world, run_dir):
    """(c), one of 4 fresh ranks: shards drawn from seed 1, the saved state
    restored into them (``restore_sharded_train_state``), then step
    SSMTP_SAVE_AT + 1 on its batch.  Saves its results."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpointing import restore_sharded_train_state
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (ShardPolicy, init_train_state,
                                     make_train_step)

    torch.cuda.set_device(0)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{run_dir}/rendezvous_resume",
                     timeout_s=SHARD_TIMEOUT_S)
    try:
        cfg = _ssmtp_cfg("mamba2-370m")
        mesh = make_local_mesh(SSMTP_MESH[1])
        pol = ShardPolicy(tp=True, zero=True, remat_segments=(True,))
        ocfg = AdamWConfig(lr=SSMTP_LR)
        params, opt = init_train_state(cfg, mesh=mesh, policy=pol, seed=1,
                                       opt_cfg=ocfg, device="cuda")
        step = make_train_step(cfg, ocfg, mesh=mesh, policy=pol)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, at = restore_sharded_train_state(params, opt, step.shard,
                                               SSMTP_DIR / "ckpt")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        out = {"restored_step": at, "opt_step": opt["step"],
               "restore_s": restore_s}
        b = _ssmtp_batches(cfg)[SSMTP_SAVE_AT]
        dist.barrier()
        counts = _zero_counts()
        with plain_calls() as plain:
            m = step(params, opt, b)
        out.update(loss=float(m["loss"]), launches=counts(), plain=plain)
        pathlib.Path(f"{run_dir}/resume.rank{rank}.json").write_text(
            json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def ssmtp_ckpt_single(_rank, run_dir):
    """(c), a process of its own: (a)'s files restored with the one-process
    ``restore_train_state`` into a model drawn from seed 1, then step
    SSMTP_SAVE_AT + 1; then the checkpoint of ``train --ranks`` restored
    the same way.  Saves its results."""
    import torch
    from repro_torch.checkpointing import restore_train_state
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.executor import make_train_step

    torch.cuda.set_device(0)
    cfg = _ssmtp_cfg("mamba2-370m")
    out = {}
    for name, d in (("ranks", SSMTP_DIR / "ckpt"),
                    ("train", SSMTP_DIR / "train_ckpt")):
        params = init_lm(cfg, seed=1, device="cuda")
        ocfg = AdamWConfig(lr=SSMTP_LR)
        opt = adamw_init(list(params.parameters()), ocfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, at = restore_train_state(params, opt, d)
        torch.cuda.synchronize()
        row = {"restore_s": time.perf_counter() - t0, "step": at,
               "opt_step": opt["step"], "bytes": _dir_bytes(d),
               "master_rounds_to_params": all(
                   torch.equal(p, m.to(p.dtype)) for p, m in
                   zip(params.parameters(), opt["master"]))}
        if name == "ranks":
            step = make_train_step(cfg, ocfg, remat_segments=[True])
            b = {k: v.to("cuda")
                 for k, v in _ssmtp_batches(cfg)[SSMTP_SAVE_AT].items()}
            counts = _zero_counts()
            with plain_calls() as plain:
                row["loss"] = float(step(params, opt, b)["loss"])
            row.update(launches=counts(), plain=plain)
        out[name] = row
        del params, opt
    pathlib.Path(f"{run_dir}/ckpt_single.json").write_text(json.dumps(out))


def counted_ssmtp_rank(rank, world, run_dir, cfg, policy, args):
    """Check-only: ``launch/train.py``'s rank of ``train --ranks``, with the
    kernels' launches and any plain call counted in the rank and saved
    under SSMTP_DIR."""
    from repro_torch.launch.train import _sharded_rank

    counts = _zero_counts()
    with plain_calls() as plain:
        _sharded_rank(rank, world, run_dir, cfg, policy, args)
    (SSMTP_DIR / f"train_rank{rank}.json").write_text(json.dumps(
        {"launches": counts(), "plain": plain}))


def _ssmtp_check_ranks(arch, ref):
    """(a) and (b)'s gates on the ranks' results against the reference
    ``ref``: the fp32 loss and every gathered fp32 gradient leaf, the bf16
    loss with ``seq_shard`` off and on, the launches of every call and
    step, the step losses; returns the launches summed over ranks, rank 0's
    bf16 step losses and every rank's results."""
    cfg = _ssmtp_cfg(arch)
    res = [json.loads((SSMTP_DIR / f"{arch}.rank{r}.json").read_text())
           for r in range(SSMTP_RANKS)]
    check([r["coord"] for r in res] == [[0, 0], [0, 1], [1, 0], [1, 1]],
          f"{arch}: mesh coordinates {[r['coord'] for r in res]}")
    want = _ssm_launches(cfg)
    for key in ("fp32", "seq0", "seq1"):
        rows = [r[key] for r in res]
        dtype = "float32" if key == "fp32" else "bfloat16"
        tag = (f"[ssm-tp] {arch} {dtype}"
               + ("" if key == "fp32" else f" seq_shard={key == 'seq1'}"))
        want_loss = ref[dtype]["loss"]
        loss = rows[0]["loss"]
        check(all(r["loss"] == loss for r in rows),
              f"{tag}: ranks disagree on the loss")
        check(not any(r["plain"] for r in rows), f"{tag}: plain versions "
              f"ran: {[r['plain'] for r in rows]}")
        for r, row in enumerate(rows):
            check(all(row["launches"][k] == v for k, v in want.items()),
                  f"{tag} rank {r}: launches {row['launches']}, not {want}")
        rel = abs(loss - want_loss) / abs(want_loss)
        check(rel <= SHARD_LOSS_RTOL, f"{tag}: loss {loss} against the "
              f"single process's {want_loss} (rel {rel:.3e})")
        extra = ""
        if key == "fp32":
            check(rows[0]["n_leaves"] == len(ref[dtype]["grads"]),
                  f"{tag}: {rows[0]['n_leaves']} leaves")
            check(rows[0]["worst_err"] <= SHARD_GRAD_TOL, f"{tag}: gradient "
                  f"{rows[0]['worst_leaf']} off by "
                  f"{rows[0]['worst_err']:.3e} of its largest magnitude")
            extra = (f"; worst gradient leaf {rows[0]['worst_leaf']} at "
                     f"{rows[0]['worst_err']:.3e} of its largest magnitude "
                     f"({rows[0]['n_leaves']} leaves)")
        elif key == "seq1":
            extra = ("; loss and gradients the same bits as seq_shard=False"
                     if rows[0]["same_bits"] else "; NOT the same bits as "
                     "seq_shard=False, the loss within the gate above")
        log(f"{tag}: loss {loss!r} (single process {want_loss!r}, rel "
            f"{rel:.3e}); grad norm {rows[0]['grad_norm']:.6f} (single "
            f"process {ref[dtype]['grad_norm']:.6f}); call ms by rank "
            f"{[round(r['ms'], 1) for r in rows]}, gloo bytes sent by rank "
            f"{[r['gloo_bytes'] for r in rows]}" + extra)
    steps = [r["steps"] for r in res]
    losses = [h["loss"] for h in steps[0]]
    check(all([h["loss"] for h in s] == losses for s in steps),
          f"{arch}: ranks disagree on the step losses")
    check(all(math.isfinite(x) for x in losses),
          f"{arch}: step losses {losses}")
    check(not any(r["plain"] for r in res), f"{arch}: plain versions ran in "
          f"the steps: {[r['plain'] for r in res]}")
    want_steps = _ssm_launches(cfg, _ssmtp_steps(arch))
    for r, row in enumerate(res):
        check(all(row["launches"][k] == v for k, v in want_steps.items()),
              f"{arch} steps rank {r}: launches {row['launches']}, not "
              f"{want_steps}")
        log(f"[ssm-tp] {arch} rank {r} (data {row['coord'][0]}, model "
            f"{row['coord'][1]}): {row['params_local'] / 1e6:.1f} M params, "
            f"bf16 init {row['init_s']:.1f} s; step ms "
            f"{[round(h['ms'], 1) for h in row['steps']]}, gloo bytes sent "
            f"a step {[h['gloo_bytes'] for h in row['steps']]}; peak "
            f"{row['peak_gb']:.2f} GB")
    log(f"[ssm-tp] {arch}: {len(losses)} sharded bf16 steps: losses "
        f"{losses} (single process {ref['bfloat16']['losses']}; 4 ranks "
        "share one card: not sharded training's speed)")
    launches = {k: 0 for k in res[0]["launches"]}
    for r in res:
        for k in launches:
            launches[k] += r["launches"][k] + sum(
                r[key]["launches"][k] for key in ("fp32", "seq0", "seq1"))
    return launches, losses, res


def _ssmtp_reference(arch):
    """The single-process reference of ``arch`` in a process of its own,
    gated; returns it (mmap) and its launches."""
    import torch

    cfg = _ssmtp_cfg(arch)
    ref_s = spawn_ranks(ssmtp_reference, (str(SSMTP_DIR), arch), 1,
                        f"the {arch} single-process reference",
                        timeout_s=SHARD_TIMEOUT_S)
    ref = torch.load(SSMTP_DIR / f"{arch}.reference.pt", mmap=True)
    want = _ssm_launches(cfg)
    launches = {k: 0 for k in ref["float32"]["launches"]}
    for dtype in ("float32", "bfloat16"):
        row = ref[dtype]
        check(not row["plain"], f"plain versions ran in the {arch} {dtype} "
              f"reference: {row['plain']}")
        check(all(row["launches"][k] == v for k, v in want.items()),
              f"the {arch} {dtype} reference's launches {row['launches']}, "
              f"not {want}")
        for k in launches:
            launches[k] += row["launches"][k]
    bf = ref["bfloat16"]
    check(all(math.isfinite(x) for x in bf["losses"]),
          f"the {arch} reference's losses {bf['losses']}")
    log(f"[ssm-tp] {arch} single process: {bf['params'] / 1e9:.4f} B "
        f"params; fp32 loss {ref['float32']['loss']!r}, grad norm "
        f"{ref['float32']['grad_norm']:.6f}, {ref['float32']['wall_ms']:.1f} "
        f"ms; bf16 loss {bf['loss']!r}, grad norm {bf['grad_norm']:.6f}, "
        f"{bf['wall_ms']:.1f} ms; {len(bf['losses'])} bf16 steps at lr "
        f"{SSMTP_LR}: "
        f"losses {bf['losses']}; peak {bf['peak_gb']:.2f} GB; process "
        f"{ref_s:.1f} s")
    return ref, launches


def _ssmtp_train(ref):
    """(c): the port's search for SSMTP_RANKS cards of the H100 node at
    mamba2-370m, then ``train --ranks 4 --plan --ckpt-dir --ckpt-every 2
    --steps 2``; the policy it prints must be the plan's, its first loss
    within SHARD_LOSS_RTOL of (a)'s, the kernels launched at their counts,
    and it must write step 2's checkpoint.  Returns the path's
    launches."""
    import io
    import tempfile

    from repro_torch.core import CLUSTERS
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.search import certify_plans

    cfg = _ssmtp_cfg("mamba2-370m")
    cluster = CLUSTERS[PLAN_CLUSTER].with_devices(SSMTP_RANKS)
    plan = train_cli.search_plan(cfg, SSMTP_SEQ, cluster=cluster,
                                 batch_grid=[SSMTP_BATCH])
    check(certify_plans([plan], log=log), "the searched plan does not "
          "certify")
    policy = train_cli.middle_strategy_policy(plan)
    remat = bool(policy.remat_segments and policy.remat_segments[0])
    log(f"[ssm-tp] (c) {PLAN_CLUSTER} x{SSMTP_RANKS}, batch grid "
        f"[{SSMTP_BATCH}]: {plan.summary()}; the driver's policy {policy}")
    steps = SSMTP_SAVE_AT
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssm_tp_") as d:
        path = pathlib.Path(d) / "ssm.plan.json"
        path.write_text(plan.dumps())
        argv = ["--arch", "mamba2-370m", "--layers",
                str(SSMTP_MAMBA2_LAYERS), "--ranks", str(SSMTP_RANKS),
                "--plan", str(path), "--seq", str(SSMTP_SEQ), "--batch",
                str(SSMTP_BATCH), "--steps", str(steps), "--lr",
                str(SSMTP_LR), "--log-every", "1", "--ckpt-dir",
                str(SSMTP_DIR / "train_ckpt"), "--ckpt-every",
                str(SSMTP_SAVE_AT)]
        log(f"[ssm-tp] (c) python -m repro_torch.launch.train "
            f"{' '.join(argv)}")
        real = train_cli._sharded_rank
        train_cli._sharded_rank = counted_ssmtp_rank
        printed = io.StringIO()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed), pooled_train_ranks():
                hist = train_cli.main(argv)
            wall_s = time.perf_counter() - t0
        finally:
            train_cli._sharded_rank = real
            log(printed.getvalue().rstrip())
    check(f"policy={policy}" in printed.getvalue(), "train --ranks did not "
          "print the plan's policy")
    written = sorted(p.name for p in (SSMTP_DIR / "train_ckpt").iterdir())
    check(written == [f"step_{SSMTP_SAVE_AT:08d}"], f"train --ranks "
          f"--ckpt-dir wrote {written}")
    ranks = [json.loads((SSMTP_DIR / f"train_rank{r}.json").read_text())
             for r in range(SSMTP_RANKS)]
    plain = [r["plain"] for r in ranks if r["plain"]]
    check(not plain, f"plain versions ran in train --ranks: {plain}")
    want = _ssm_launches(cfg, steps, remat)
    for r, res in enumerate(ranks):
        check(all(res["launches"][k] == v for k, v in want.items()),
              f"train --ranks rank {r} launches {res['launches']}, not "
              f"{want}")
    losses = [h["loss"] for h in hist]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"losses {losses}")
    bf = ref["bfloat16"]
    rel = abs(losses[0] - bf["loss"]) / abs(bf["loss"])
    check(rel <= SHARD_LOSS_RTOL, f"train --ranks' first loss {losses[0]} "
          f"against the single process's {bf['loss']} (rel {rel:.3e})")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    log("[ssm-tp] (c) " + json.dumps({
        "plan": plan.summary(), "policy": str(policy), "losses": losses,
        "single_process_losses": bf["losses"][:steps],
        "first_loss_rel": rel, "step_ms": [h["step_ms"] for h in hist],
        "gloo_bytes_sent_rank0": [h["gloo_bytes_sent"] for h in hist],
        "peak_mem_gb_by_rank": [hist[-1][f"peak_mem_gb_rank{r}"]
                                for r in range(SSMTP_RANKS)],
        "checkpoint_bytes": _dir_bytes(SSMTP_DIR / "train_ckpt"),
        "wall_s": wall_s, "launches": launches})
        + " (4 ranks share one card: not sharded training's speed)")
    return launches


def phase_ssm_tp():
    """Phase 17: (a) full-width mamba2-370m, its single-process reference
    and 4 TP + ZeRO + remat ranks against it, saving after step 2; (c) 4
    fresh ranks restore and take step 3, ``train --ranks 4 --ckpt-dir``,
    and one process restores both checkpoints; (b) zamba2-1.2b at
    SSMTP_ZAMBA2_LAYERS layers and SSMTP_ZAMBA2_STEPS steps as (a), without
    saving."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(SSMTP_DIR, ignore_errors=True)
    SSMTP_DIR.mkdir(parents=True)
    t_phase = time.perf_counter()
    launches = {"ssm_tp_reference": None, "ssm_tp": None,
                "ssm_tp_resume": None, "ssm_tp_train": None}

    def add(path, counts):
        if launches[path] is None:
            launches[path] = dict(counts)
        else:
            for k, v in counts.items():
                launches[path][k] += v

    arch = "mamba2-370m"
    log(f"[ssm-tp] (a) {arch} at full width, {SSMTP_MAMBA2_LAYERS} of 48 "
        f"layers, {SSMTP_BATCH} x "
        f"{SSMTP_SEQ} tokens, {SSMTP_RANKS} gloo ranks on one card, (data "
        f"{SSMTP_MESH[0]}, model {SSMTP_MESH[1]}), TP + ZeRO + remat")
    ref, ref_launches = _ssmtp_reference(arch)
    add("ssm_tp_reference", ref_launches)
    spawn_ranks(ssmtp_rank, (SSMTP_RANKS, str(SSMTP_DIR), arch, True),
                SSMTP_RANKS, f"{arch} TP ranks", timeout_s=SHARD_TIMEOUT_S)
    counts, losses, res = _ssmtp_check_ranks(arch, ref)
    add("ssm_tp", counts)
    log(f"[ssm-tp] (a) at {time.perf_counter() - t_phase:.1f} s")
    ckpt_bytes = _dir_bytes(SSMTP_DIR / "ckpt")
    log(f"[ssm-tp] (c) save_sharded_train_state after step {SSMTP_SAVE_AT}: "
        f"{ckpt_bytes} bytes in s by rank "
        f"{[round(r['save']['s'], 2) for r in res]}, gloo bytes sent by rank "
        f"{[r['save']['gloo_bytes'] for r in res]}")

    spawn_ranks(ssmtp_resume_rank, (SSMTP_RANKS, str(SSMTP_DIR)),
                SSMTP_RANKS, "resuming ranks", timeout_s=SHARD_TIMEOUT_S)
    rows = [json.loads((SSMTP_DIR / f"resume.rank{r}.json").read_text())
            for r in range(SSMTP_RANKS)]
    want = losses[SSMTP_SAVE_AT]
    check(all(r["restored_step"] == SSMTP_SAVE_AT
              and r["opt_step"] == SSMTP_SAVE_AT for r in rows),
          "restored steps "
          f"{[(r['restored_step'], r['opt_step']) for r in rows]}")
    check(not any(r["plain"] for r in rows), "plain versions ran in the "
          f"resumed step: {[r['plain'] for r in rows]}")
    want_one = _ssm_launches(_ssmtp_cfg(arch))
    for r, row in enumerate(rows):
        check(all(row["launches"][k] == v for k, v in want_one.items()),
              f"resumed rank {r}: launches {row['launches']}, not "
              f"{want_one}")
        add("ssm_tp_resume", row["launches"])
    got = [r["loss"] for r in rows]
    check(all(x == want for x in got), f"the resumed step "
          f"{SSMTP_SAVE_AT + 1} losses {got} are not the unbroken run's "
          f"{want!r} bit for bit")
    log(f"[ssm-tp] (c) 4 fresh ranks (seed 1) restored step "
        f"{SSMTP_SAVE_AT} in s by rank "
        f"{[round(r['restore_s'], 2) for r in rows]}; step "
        f"{SSMTP_SAVE_AT + 1} loss {got[0]!r}: the unbroken run's bit for "
        "bit")
    log(f"[ssm-tp] (c) resumed at {time.perf_counter() - t_phase:.1f} s")
    add("ssm_tp_train", _ssmtp_train(ref))
    log(f"[ssm-tp] (c) train --ranks at {time.perf_counter() - t_phase:.1f} s")
    spawn_ranks(ssmtp_ckpt_single, (str(SSMTP_DIR),), 1,
                "the one-process restore", timeout_s=SHARD_TIMEOUT_S)
    single = json.loads((SSMTP_DIR / "ckpt_single.json").read_text())
    one, tr = single["ranks"], single["train"]
    check(one["step"] == one["opt_step"] == SSMTP_SAVE_AT
          and one["master_rounds_to_params"], f"one process restoring the "
          f"ranks' checkpoint: {one}")
    check(not one["plain"], f"plain versions ran in the one-process step: "
          f"{one['plain']}")
    check(all(one["launches"][k] == v for k, v in want_one.items()),
          f"one-process step launches {one['launches']}, not {want_one}")
    add("ssm_tp_reference", one["launches"])
    rel = abs(one["loss"] - want) / abs(want)
    check(rel <= SHARD_LOSS_RTOL, f"one process's step {SSMTP_SAVE_AT + 1} "
          f"loss {one['loss']} against the ranks' {want} (rel {rel:.3e})")
    check(tr["step"] == tr["opt_step"] == SSMTP_SAVE_AT
          and tr["master_rounds_to_params"], f"one process restoring train "
          f"--ranks' checkpoint: {tr}")
    log(f"[ssm-tp] (c) one process restored the ranks' {one['bytes']} bytes "
        f"in {one['restore_s']:.2f} s; step {SSMTP_SAVE_AT + 1} loss "
        f"{one['loss']!r} (ranks {want!r}, rel {rel:.3e}); it restored "
        f"train --ranks' {tr['bytes']} bytes in {tr['restore_s']:.2f} s "
        f"(step {tr['step']}, masters rounding to the parameters)")
    shutil.rmtree(SSMTP_DIR / "ckpt", ignore_errors=True)
    shutil.rmtree(SSMTP_DIR / "train_ckpt", ignore_errors=True)
    del ref
    log(f"[ssm-tp] (c) at {time.perf_counter() - t_phase:.1f} s")

    arch = "zamba2-1.2b"
    log(f"[ssm-tp] (b) {arch} at full width, {SSMTP_ZAMBA2_LAYERS} of 38 "
        f"layers, as (a), {SSMTP_ZAMBA2_STEPS} step, no save")
    ref, ref_launches = _ssmtp_reference(arch)
    add("ssm_tp_reference", ref_launches)
    spawn_ranks(ssmtp_rank, (SSMTP_RANKS, str(SSMTP_DIR), arch, False),
                SSMTP_RANKS, f"{arch} TP ranks", timeout_s=SHARD_TIMEOUT_S)
    add("ssm_tp", _ssmtp_check_ranks(arch, ref)[0])
    del ref
    shutil.rmtree(SSMTP_DIR, ignore_errors=True)
    log(f"[ssm-tp] phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 18: sharded serving, 4 ranks on the card
# ---------------------------------------------------------------------------

SERVE_SHARD_DIR = ROOT / "build" / "serve_shard"


def _ss_cfg(arch, dtype, layers=None):
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch).with_(dtype=getattr(torch, dtype))
    return cfg if layers is None else cfg.with_(n_layers=layers)


def _ss_ecfg():
    from repro_torch.serving import EngineConfig
    return EngineConfig(page_size=PAGE_SIZE,
                        n_pages=DECODE_SLOTS * MAX_CONTEXT // PAGE_SIZE,
                        decode_slots=DECODE_SLOTS, max_context=MAX_CONTEXT,
                        prefill_batch=PREFILL_BATCH,
                        prefill_chunk=PREFILL_CHUNK)


def _ss_requests(cfg):
    """Phase 3's 12 requests; the last 4 arrive SS_ARRIVAL_S late, so
    that admission reads the clock (rank 0's on the mesh)."""
    import numpy as np
    from repro_torch.serving import ServeRequest
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(rid=f"r{i}",
                         prompt=rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(33, 401))
                                             ).tolist(),
                         max_new=int(rng.integers(16, 33)))
            for i in range(12)]
    for r in reqs[8:]:
        r.arrival_s = SS_ARRIVAL_S
    return reqs


def _ss_dense_requests(cfg):
    """SS_DENSE_REQUESTS requests on the dense engine's 8 lanes (more than
    lanes: slots are recycled), prompts of 8-40 tokens, SS_DENSE_NEW new
    tokens each."""
    import numpy as np
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(3)
    return [Request(i, rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(8, 41))).tolist(),
                    SS_DENSE_NEW) for i in range(SS_DENSE_REQUESTS)]


def _ss_cli_args(engine):
    """(c)'s ``serve`` flags for one engine."""
    from repro_torch.launch import serve as serve_mod
    return serve_mod.parse_args([
        "--device", "cuda", "--engine", engine, "--requests",
        str(SS_CLI_REQUESTS), "--batch", str(DECODE_SLOTS), "--max-new",
        str(SS_DENSE_NEW), "--context", str(SS_CLI_CONTEXT), "--ranks",
        str(SERVE_SHARD_RANKS)])


@contextlib.contextmanager
def flash_shapes():
    """Check-only: record, for every launch of the flash forward through
    ``ops.flash_attention`` while the block runs, its (H, KV, T), whether
    it writes the row log-sum-exp, is causal and has a kv_len."""
    from repro_torch.kernels import ops

    seen = []
    real = ops.flash_attention_cuda

    def recording(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2], k.shape[1],
                     bool(kw.get("with_lse")), bool(kw.get("causal", True)),
                     kw.get("kv_len") is not None))
        return real(q, k, v, **kw)

    ops.flash_attention_cuda = recording
    try:
        yield seen
    finally:
        ops.flash_attention_cuda = real


def _ss_digest(t):
    import hashlib
    return hashlib.sha1(t.detach().float().cpu().numpy().tobytes()
                        ).hexdigest()


def _ss_same_on_ranks(value):
    """Whether every rank holds ``value`` (a collective; True without a
    default group)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return True
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, value)
    return all(g == got[0] for g in got)


def _ss_busy_ms(step, n=2):
    """Device busy ms a call of ``step`` over ``n`` calls (torch.profiler),
    or None when the profiler records no device time.  The calls run
    whatever the profiler does: on a rank they hold collectives that every
    rank must enter."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    except Exception as e:      # noqa: BLE001 - reported, never fatal
        log(f"[serve-shard] profiler unavailable: {e}")
        prof = None
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    if prof is None:
        return None
    try:
        prof.__exit__(None, None, None)
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    except Exception as e:      # noqa: BLE001 - reported, never fatal
        log(f"[serve-shard] profiler failed: {e}")
        return None
    return busy / 1e3 / n or None


def _ss_traffic(*steps):
    return sum(s.shard.traffic.bytes_sent for s in steps
               if getattr(s, "shard", None) is not None)


def _ss_paged(cfg, params, run=True, mesh=None, policy=None):
    """(a) on one process or a rank: the fixed prefill chunk and decode
    step on an engine's pools (logits, launches, flash shapes), the decode
    step's wall and busy ms and gloo bytes; with ``run``, the 12 requests
    through a fresh engine (tokens, metrics, the page table at the end)."""
    import numpy as np
    import torch
    from repro_torch.serving import ServingEngine

    ecfg = _ss_ecfg()
    engine = ServingEngine(cfg, params, ecfg, device="cuda", mesh=mesh,
                           policy=policy)
    P = ecfg.pages_per_slot
    rng = np.random.default_rng(1)
    rows = torch.arange(DECODE_SLOTS * P, dtype=torch.int32,
                        device="cuda").reshape(DECODE_SLOTS, P)
    ptok = _i32(rng.integers(0, cfg.vocab_size,
                             (PREFILL_BATCH, PREFILL_CHUNK)).tolist())
    plen = _i32([PREFILL_CHUNK, 100, 77, PREFILL_CHUNK])
    tok = _i32(rng.integers(0, cfg.vocab_size, DECODE_SLOTS).tolist())
    lens = _i32([PREFILL_CHUNK, 100, 77, PREFILL_CHUNK, -1, -1, -1, -1])
    out = {}
    for name, call in (
            ("prefill", lambda: engine._prefill(
                params, engine.pools, ptok, rows[:PREFILL_BATCH], 0, plen)),
            ("decode", lambda: engine._decode(params, engine.pools, tok,
                                              rows, lens))):
        counts = _zero_counts()
        sent = _ss_traffic(engine._decode, engine._prefill)
        with flash_shapes() as shapes, plain_calls() as plain:
            logits = call()
            torch.cuda.synchronize()
        out[name] = {"logits": logits.float().cpu(), "launches": counts(),
                     "shapes": sorted(set(shapes)), "plain": dict(plain),
                     "gloo_bytes": _ss_traffic(engine._decode,
                                               engine._prefill) - sent,
                     "digest": _ss_digest(logits)}
    decode = out["decode"]
    decode["ms"] = cuda_ms(lambda: engine._decode(params, engine.pools, tok,
                                                  rows, lens), iters=3,
                           warmup=1)
    decode["busy_ms"] = _ss_busy_ms(lambda: engine._decode(
        params, engine.pools, tok, rows, lens), n=1)
    out["pool_bytes"] = sum(t.numel() * t.element_size()
                            for pool in engine.pools for t in pool.values())
    if run:
        del engine
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine = ServingEngine(cfg, params, ecfg, device="cuda", mesh=mesh,
                               policy=policy)
        reqs = _ss_requests(cfg)
        counts = _zero_counts()
        sent = _ss_traffic(engine._decode, engine._prefill)
        with plain_calls() as plain:
            metrics = engine.run(reqs)
            torch.cuda.synchronize()
        st = engine.state
        summ = metrics.summary()
        out["run"] = {
            "tokens": [r.tokens for r in reqs],
            "done": [r.done for r in reqs], "launches": counts(),
            "plain": dict(plain), "summary": summ,
            "gloo_bytes": _ss_traffic(engine._decode, engine._prefill)
            - sent,
            "page_table": _ss_digest(torch.cat([
                t.reshape(-1).float() for t in st])),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return out


def _ss_dense(cfg, params, steps, mesh=None, policy=None, timed=False):
    """(b) on one process or a rank: ``steps`` decode steps of 8 lanes
    over 2048-token caches from the preset positions SS_INDEX (three lanes
    wrap) on fixed tokens: each step's logits, the launches and flash
    shapes; with ``timed``, one more step's wall and busy ms and gloo
    bytes."""
    import numpy as np
    import torch
    from repro_torch.models import init_decode_state
    from repro_torch.runtime.executor import make_serve_step

    step = make_serve_step(cfg, mesh=mesh, policy=policy)
    B, C = DENSE_SERVE_LANES, DENSE_SERVE_CONTEXT
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_decode_state(cfg, B, C, device="cuda", shard=step.shard)
    state["index"] = _i32(SS_INDEX)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (steps, B))
    logits = []
    counts = _zero_counts()
    sent = _ss_traffic(step)
    with flash_shapes() as shapes, plain_calls() as plain:
        for t in toks:
            lg, state = step(params, state, _i32(t.tolist()))
            logits.append(lg.float().cpu())
        torch.cuda.synchronize()
    out = {"logits": torch.stack(logits), "launches": counts(),
           "shapes": sorted(set(shapes)), "plain": dict(plain),
           "gloo_bytes": (_ss_traffic(step) - sent) / steps,
           "digest": _ss_digest(torch.stack(logits)),
           "state_bytes": sum(
               t.numel() * t.element_size() for part in
               (state["caches"], state.get("ssm_states", ()))
               for leaf in part for t in leaf.values()),
           "layout": str(state.get("layout"))}
    if timed:
        tok = _i32(toks[-1].tolist())
        out["ms"] = cuda_ms(lambda: step(params, state, tok), iters=2,
                            warmup=1)
        out["busy_ms"] = _ss_busy_ms(lambda: step(params, state, tok), n=1)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _ss_serve(cfg, params, mesh=None, policy=None):
    """(b) through ``launch/serve.py::serve``: SS_DENSE_REQUESTS requests
    on 8 lanes of 2048 tokens; the tokens and the ms a step."""
    import torch
    from repro_torch.launch.serve import serve

    reqs = _ss_dense_requests(cfg)
    counts = _zero_counts()
    t0 = time.perf_counter()
    with plain_calls() as plain:
        serve(cfg, reqs, DENSE_SERVE_LANES, DENSE_SERVE_CONTEXT,
              verbose=False, device="cuda", params=params, mesh=mesh,
              policy=policy)
        torch.cuda.synchronize()
    return {"tokens": [r.generated for r in reqs],
            "done": [r.done for r in reqs], "launches": counts(),
            "plain": dict(plain), "wall_s": time.perf_counter() - t0}


def _ss_prefill(cfg, params, mesh=None, policy=None):
    """The sharded ``make_prefill_step`` on SS_PREFILL_BATCH x
    SS_PREFILL_SEQ tokens: the last position's logits of each of this
    process's lanes and vocabulary columns, and the launches."""
    import numpy as np
    import torch
    from repro_torch.runtime.executor import make_prefill_step

    step = make_prefill_step(cfg, mesh=mesh, policy=policy)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (SS_PREFILL_BATCH, SS_PREFILL_SEQ)))
    counts = _zero_counts()
    with plain_calls() as plain:
        logits = step(params, {"tokens": tokens.to("cuda")})
        torch.cuda.synchronize()
    return {"last": logits[:, -1].float().cpu(), "launches": counts(),
            "plain": dict(plain), "shape": list(logits.shape)}


def _ss_parts():
    """(tag, arch, dtype, layers, policy kwargs, what runs) of (a) and
    (b), in the order every process runs them; consecutive parts of one
    model share its weights."""
    seq = dict(tp=True, zero=False)
    heads = dict(tp=True, zero=False, shard_cache_seq=False)
    L = SS_FP32_LAYERS
    qwen = SS_BF16_LAYERS["qwen3-4b"]
    return [
        ("paged bfloat16", "qwen3-4b", "bfloat16", qwen, seq, ("paged",)),
        ("qwen3-4b bf16", "qwen3-4b", "bfloat16", qwen, seq, ("steps",)),
        ("qwen3-4b bf16 heads", "qwen3-4b", "bfloat16", qwen, heads,
         ("steps",)),
        ("paged float32", "qwen3-4b", "float32", L, seq, ("paged",)),
        ("qwen3-4b fp32", "qwen3-4b", "float32", L, seq, ("steps", "serve")),
        ("qwen3-4b fp32 heads", "qwen3-4b", "float32", L, heads,
         ("steps", "serve")),
        ("mamba2-370m bf16", "mamba2-370m", "bfloat16",
         SS_BF16_LAYERS["mamba2-370m"], seq, ("steps", "prefill")),
        ("mamba2-370m fp32", "mamba2-370m", "float32", L, seq,
         ("steps", "serve")),
        ("zamba2-1.2b bf16", "zamba2-1.2b", "bfloat16",
         SS_BF16_LAYERS["zamba2-1.2b"], seq, ("steps", "prefill")),
        ("zamba2-1.2b fp32", "zamba2-1.2b", "float32", SS_ZAMBA2_FP32_LAYERS,
         seq, ("steps", "serve")),
    ]


def _ss_run_parts(mesh=None):
    """(a) and (b) on one process (``mesh`` None: the reference, on the
    whole model) or on a rank (its shards); returns {part: results}."""
    import gc

    import torch
    from repro_torch.models import init_lm
    from repro_torch.runtime import ShardPolicy, init_serving_params

    out, held, params = {}, None, None
    for tag, arch, dtype, layers, pk, what in _ss_parts():
        t0 = time.perf_counter()
        cfg = _ss_cfg(arch, dtype, layers)
        pol = ShardPolicy(**pk)
        if held != (arch, dtype, layers):
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            params = (init_lm(cfg, seed=0, device="cuda") if mesh is None
                      else init_serving_params(cfg, mesh=mesh, policy=pol,
                                               seed=0, device="cuda"))
            held = (arch, dtype, layers)
        kw = dict(mesh=mesh, policy=pol if mesh is not None else None)
        if "paged" in what:     # the reference runs the engine in fp32
            res = _ss_paged(cfg, params, run=mesh is not None
                            or dtype == "float32", **kw)
        else:
            res = {}
        if "steps" in what:
            res["steps"] = _ss_dense(cfg, params, SS_STEPS[dtype],
                                     timed=dtype == "bfloat16", **kw)
        if "serve" in what:
            res["serve"] = _ss_serve(cfg, params, **kw)
        if "prefill" in what:
            res["prefill"] = _ss_prefill(cfg, params, **kw)
        res["s"] = time.perf_counter() - t0
        out[tag] = res
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_shard_reference(_rank, run_dir):
    """(a), (b) and (c)'s reference in a process of its own: every part on
    the whole model (``init_lm`` seed 0), and (c)'s two engines through
    ``launch/serve.py`` on one card; saved for the ranks' checks."""
    import torch
    from repro_torch.launch import serve as serve_mod

    torch.cuda.set_device(0)
    out = _ss_run_parts()
    cfg = _ss_cfg("qwen3-4b", "float32", SS_FP32_LAYERS)
    for engine in ("paged", "dense"):
        args = _ss_cli_args(engine)
        reqs = serve_mod.synthetic_requests(cfg, args)
        serve_mod._run_engine(cfg, args, reqs, "cuda", verbose=False)
        out[f"cli {engine}"] = [r.generated for r in reqs]
    torch.save(out, f"{run_dir}/reference.pt")


def serve_shard_rank(rank, world, run_dir):
    """One of SERVE_SHARD_RANKS gloo ranks on a SERVE_SHARD_MESH (data,
    model) mesh: every part of (a) and (b) on its shards; each result's
    digest is compared over the ranks; rank 0 saves the logits, each rank
    its launches, shapes, times and bytes."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_local_mesh

    torch.cuda.set_device(0)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{run_dir}/rendezvous",
                     timeout_s=SERVE_SHARD_TIMEOUT_S)
    try:
        mesh = make_local_mesh(SERVE_SHARD_MESH[1])
        out = _ss_run_parts(mesh)
        same = {}
        for part, res in out.items():
            for key in ("digest", "tokens", "page_table"):
                for sub, r in ([(None, res)] + [(k, v) for k, v in
                                                res.items()
                                                if isinstance(v, dict)]):
                    if key in r:
                        same[f"{part}/{sub}/{key}"] = _ss_same_on_ranks(
                            r[key])
        out["same_on_ranks"] = same
        out["coord"] = [mesh.get_local_rank("data"),
                        mesh.get_local_rank("model")]
        if rank != 0:       # the logits are rank 0's (the same bits)
            for res in out.values():
                if isinstance(res, dict):
                    for r in [res] + [v for v in res.values()
                                      if isinstance(v, dict)]:
                        r.pop("logits", None)
        torch.save(out, f"{run_dir}/rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def counted_serve_rank(rank, world, run_dir, cfg, args, reqs):
    """Check-only: ``launch/serve.py``'s rank of ``serve --ranks``, with
    the kernels' launches, any plain call and the gloo bytes counted in
    the rank and saved under SERVE_SHARD_DIR."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.runtime import sharding

    sent = {"n": 0}
    real = sharding.Traffic.add

    def add(self, n, op):
        sent["n"] += n
        real(self, n, op)

    sharding.Traffic.add = add
    counts = _zero_counts()
    t0 = time.perf_counter()
    with plain_calls() as plain:
        serve_mod._serve_rank(rank, world, run_dir, cfg, args, reqs)
    (SERVE_SHARD_DIR / f"cli_{args.engine}_rank{rank}.json").write_text(
        json.dumps({"launches": counts(), "plain": plain,
                    "gloo_bytes": sent["n"],
                    "s": time.perf_counter() - t0}))


def _ss_cli(ref):
    """(c): ``serve --ranks 4`` (``launch/serve.py::serve_ranks``, the
    ``("data" 4, "model" 1)`` mesh) for both engines at the fp32 cut
    depth: every request completes with the single process's tokens.
    Returns the path's launches."""
    from repro_torch.launch import serve as serve_mod

    cfg = _ss_cfg("qwen3-4b", "float32", SS_FP32_LAYERS)
    launches = {}
    real = serve_mod._serve_rank
    serve_mod._serve_rank = counted_serve_rank
    try:
        for engine in ("paged", "dense"):
            args = _ss_cli_args(engine)
            reqs = serve_mod.synthetic_requests(cfg, args)
            t0 = time.perf_counter()
            serve_mod.serve_ranks(cfg, args, reqs, SERVE_SHARD_RANKS)
            wall = time.perf_counter() - t0
            got = [r.generated for r in reqs]
            check(all(len(g) == args.max_new for g in got),
                  f"serve --ranks {engine}: a request did not complete")
            check(got == ref[f"cli {engine}"], f"serve --ranks {engine}: "
                  "tokens differ from the single process's")
            ranks = [json.loads((SERVE_SHARD_DIR /
                                 f"cli_{engine}_rank{r}.json").read_text())
                     for r in range(SERVE_SHARD_RANKS)]
            check(not any(r["plain"] for r in ranks),
                  f"serve --ranks {engine}: plain versions ran")
            for r in ranks:
                check(r["launches"]["flash_attention"] > 0
                      and r["launches"]["rmsnorm"] > 0,
                      f"serve --ranks {engine}: a rank launched no kernel")
            n_new = sum(len(g) for g in got)
            log(f"[serve-shard] (c) serve --ranks {SERVE_SHARD_RANKS} "
                f"--engine {engine} (data {SERVE_SHARD_RANKS}, model 1; "
                f"qwen3-4b fp32 at {SS_FP32_LAYERS} layers): "
                f"{len(reqs)} requests, tokens the single process's; "
                f"{n_new} tokens in {wall:.1f} s with the ranks' start "
                f"({n_new / wall:.1f} tok/s); gloo bytes sent by rank "
                f"{[r['gloo_bytes'] for r in ranks]}; launches by rank "
                f"{[r['launches']['flash_attention'] for r in ranks]} "
                "flash")
            for k in ranks[0]["launches"]:
                launches[k] = launches.get(k, 0) + sum(
                    r["launches"][k] for r in ranks)
    finally:
        serve_mod._serve_rank = real
    return launches


def _ss_rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _ss_argmax_same(got, want):
    return bool((got.argmax(-1) == want.argmax(-1)).all())


def _ss_check(ref, res, rank0):
    """Gates of (a) and (b) on the ranks' results ``res`` against the
    reference; returns {path: launches summed over the ranks}."""
    launches = {"serve_tp": {}, "dense_serve_tp": {}}

    def add(path, counts):
        for k, v in counts.items():
            launches[path][k] = launches[path].get(k, 0) + v

    H, KV = 32, 8
    for dtype in ("bfloat16", "float32"):
        part = f"paged {dtype}"
        want = ref[part]
        for name in ("prefill", "decode"):
            rows = [r[part][name] for r in res]
            check(all(r["launches"] == want[name]["launches"] for r in rows),
                  f"(a) {dtype} {name}: launches by rank "
                  f"{[r['launches'] for r in rows]}, not the single "
                  f"process's {want[name]['launches']}")
            check(all(r["shapes"] and all(s[:2] == (H // 2, KV // 2)
                                          for s in r["shapes"])
                      for r in rows), f"(a) {dtype} {name}: flash shapes "
                  f"{rows[0]['shapes']}, not {H // 2} and {KV // 2} local "
                  "heads")
            check(not any(r["plain"] for r in rows) and not want[name][
                "plain"], f"(a) {dtype} {name}: plain versions ran")
            tol = SS_LOGIT_TOL[dtype]
            err = _ss_rel(rank0[part][name]["logits"],
                          want[name]["logits"])
            same_tok = _ss_argmax_same(rank0[part][name]["logits"],
                                       want[name]["logits"])
            log(f"[serve-shard] (a) paged TP {dtype} {name}: logits max "
                f"|diff| {err:.3e} of the largest (tol {tol:.0e}), greedy "
                f"tokens {'the same' if same_tok else 'DIFFERENT'}; "
                f"launches a rank {rows[0]['launches']}; flash shapes "
                f"(H, KV, T, lse, causal, kv_len) {rows[0]['shapes']}; gloo "
                f"bytes sent by rank {[r['gloo_bytes'] for r in rows]}")
            check(err <= tol, f"(a) {dtype} {name} logits off by {err:.3e}")
            if dtype == "float32":
                check(same_tok, f"(a) fp32 {name}: greedy tokens differ")
            for r in rows:
                add("serve_tp", r["launches"])
        dec = [r[part]["decode"] for r in res]
        log(f"[serve-shard] (a) paged TP {dtype} decode step: wall ms by "
            f"rank {[round(r['ms'], 2) for r in dec]}, busy ms by rank "
            f"{[r['busy_ms'] for r in dec]} (single process "
            f"{want['decode']['ms']:.2f} wall, "
            f"{want['decode']['busy_ms']} busy); pool bytes a rank "
            f"{res[0][part]['pool_bytes']} (single process "
            f"{want['pool_bytes']})")
        runs = [r[part]["run"] for r in res]
        for i, run in enumerate(runs):
            check(all(run["done"]) and all(
                len(t) == n for t, n in zip(
                    run["tokens"], [len(x) for x in runs[0]["tokens"]])),
                  f"(a) {dtype}: rank {i} did not complete every request")
            check(not run["plain"], f"(a) {dtype}: plain versions ran")
            add("serve_tp", run["launches"])
        check(all(run["tokens"] == runs[0]["tokens"] for run in runs),
              f"(a) {dtype}: the ranks' tokens differ")
        check(all(run["page_table"] == runs[0]["page_table"]
                  for run in runs), f"(a) {dtype}: the ranks' page tables "
              "differ at the end")
        if dtype == "float32":
            check(runs[0]["tokens"] == want["run"]["tokens"],
                  "(a) fp32: the ranks' tokens differ from the single "
                  "process's")
        summ = runs[0]["summary"]
        log(f"[serve-shard] (a) paged TP {dtype} engine: 12 requests done "
            f"on every rank, the same tokens and page table"
            + (", the single process's tokens" if dtype == "float32"
               else "") + f"; {summ['new_tokens']} tokens in "
            f"{summ['wall_s']:.2f} s ({summ['tok_per_s']:.1f} tok/s), "
            f"{summ['decode_steps']} decode steps, "
            f"{summ['prefill_chunks']} prefill chunks; gloo bytes sent by "
            f"rank {[r['gloo_bytes'] for r in runs]}; peak GB by rank "
            f"{[round(r['peak_gb'], 2) for r in runs]}; part "
            f"{res[0][part]['s']:.1f} s a rank")
    for tag, arch, dtype, layers, pk, what in _ss_parts():
        if "paged" in what:
            continue
        want, got = ref[tag], rank0[tag]
        rows = [r[tag] for r in res]
        tol = (SS_LOGIT_TOL[dtype] if arch == "qwen3-4b"
               or dtype == "float32" else SS_SSM_BF16_TOL)
        if "steps" in what:
            s_rows = [r["steps"] for r in rows]
            check(not any(r["plain"] for r in s_rows),
                  f"(b) {tag}: plain versions ran")
            check(all(r["launches"] == want["steps"]["launches"]
                      for r in s_rows), f"(b) {tag}: launches by rank "
                  f"{[r['launches'] for r in s_rows]}, not the single "
                  f"process's {want['steps']['launches']}")
            seq = pk.get("shard_cache_seq", True)
            for r in s_rows:
                for h, kv, T, lse, causal, has_len in r["shapes"]:
                    check(not causal and has_len and lse == seq
                          and T == DENSE_SERVE_CONTEXT // (2 if seq else 1),
                          f"(b) {tag}: a flash launch ({h}, {kv}, {T}, lse "
                          f"{lse}, causal {causal}, kv_len {has_len}) is "
                          "not on its rank's slice")
                add("dense_serve_tp", r["launches"])
            err = _ss_rel(got["steps"]["logits"], want["steps"]["logits"])
            same_tok = _ss_argmax_same(got["steps"]["logits"],
                                       want["steps"]["logits"])
            log(f"[serve-shard] (b) {tag} ({layers} layers, {pk}): "
                f"{SS_STEPS[dtype]} steps, logits max |diff| {err:.3e} of "
                f"the largest (tol {'printed only' if tol is None else f'{tol:.0e}'}), greedy tokens "
                f"{'the same' if same_tok else 'DIFFERENT'}; layout "
                f"{s_rows[0]['layout']}; state bytes a rank "
                f"{s_rows[0]['state_bytes']} (single process "
                f"{want['steps']['state_bytes']}); gloo bytes a step by rank "
                f"{[int(r['gloo_bytes']) for r in s_rows]}; flash shapes "
                f"{s_rows[0]['shapes']}; peak GB by rank "
                f"{[round(r['peak_gb'], 2) for r in s_rows]}"
                + ("" if "ms" not in s_rows[0] else
                   f"; step wall ms by rank "
                   f"{[round(r['ms'], 2) for r in s_rows]}, busy ms "
                   f"{[r['busy_ms'] for r in s_rows]} (single "
                   f"process {want['steps']['ms']:.2f} wall, "
                   f"{want['steps']['busy_ms']} busy)"))
            check(tol is None or err <= tol,
                  f"(b) {tag}: logits off by {err:.3e}")
            if dtype == "float32":
                check(same_tok, f"(b) {tag}: greedy tokens differ")
        if "serve" in what:
            sv = [r["serve"] for r in rows]
            check(all(all(r["done"]) for r in sv)
                  and all(r["tokens"] == sv[0]["tokens"] for r in sv),
                  f"(b) {tag} serve: ranks incomplete or disagree")
            check(sv[0]["tokens"] == want["serve"]["tokens"],
                  f"(b) {tag} serve: tokens differ from the single "
                  "process's")
            check(not any(r["plain"] for r in sv),
                  f"(b) {tag} serve: plain versions ran")
            for r in sv:
                add("dense_serve_tp", r["launches"])
            n_new = sum(len(t) for t in sv[0]["tokens"])
            log(f"[serve-shard] (b) {tag} serve: {SS_DENSE_REQUESTS} "
                f"requests, the single process's tokens; {n_new} tokens in "
                f"{sv[0]['wall_s']:.1f} s ({n_new / sv[0]['wall_s']:.1f} "
                f"tok/s; single process {want['serve']['wall_s']:.1f} s)")
        if "prefill" in what:
            pf = [r["prefill"] for r in rows]
            check(not any(r["plain"] for r in pf),
                  f"(b) {tag} prefill: plain versions ran")
            n_layers = _ss_cfg(arch, dtype, layers).n_layers
            check(all(r["launches"]["ssd_scan"] == n_layers
                      and r["launches"]["ssd_scan_bwd"] == 0 for r in pf),
                  f"(b) {tag} prefill: SSD launches "
                  f"{[r['launches'] for r in pf]}, not one a layer")
            full = want["prefill"]["last"]
            errs = []
            for r, rr in zip(pf, res):
                d, m = rr["coord"]
                lanes = full.shape[0] // SERVE_SHARD_MESH[0]
                cols = full.shape[1] // SERVE_SHARD_MESH[1]
                block = full[d * lanes:(d + 1) * lanes,
                             m * cols:(m + 1) * cols]
                errs.append(((r["last"] - block).abs().max()
                             / full.abs().max()).item())
                add("dense_serve_tp", r["launches"])
            log(f"[serve-shard] (b) {tag} sharded make_prefill_step "
                f"({SS_PREFILL_BATCH} x {SS_PREFILL_SEQ}): block "
                f"{pf[0]['shape']} a rank, the SSD forward once a layer; "
                f"last-position logits max |diff| by rank "
                f"{[f'{e:.3e}' for e in errs]} of the largest")
            check(tol is None or max(errs) <= tol,
                  f"(b) {tag} prefill off by {max(errs):.3e}")
        log(f"[serve-shard] (b) {tag}: part {rows[0]['s']:.1f} s a rank, "
            f"{want['s']:.1f} s in the single process")
    bad = [k for r in res for k, v in r["same_on_ranks"].items() if not v]
    check(not bad, f"the ranks' results differ: {sorted(set(bad))}")
    return launches


def phase_serve_shard():
    """Phase 18: the single-process reference, (a) and (b) on 4 gloo ranks
    on a (data 2, model 2) mesh against it, then (c) ``serve --ranks 4``."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(SERVE_SHARD_DIR, ignore_errors=True)
    SERVE_SHARD_DIR.mkdir(parents=True)
    ref_s = spawn_ranks(serve_shard_reference, (str(SERVE_SHARD_DIR),), 1,
                        "the single-process serving reference",
                        timeout_s=SERVE_SHARD_TIMEOUT_S)
    ref = torch.load(SERVE_SHARD_DIR / "reference.pt")
    log(f"[serve-shard] single-process reference in {ref_s:.1f} s")
    ranks_s = spawn_ranks(serve_shard_rank, (SERVE_SHARD_RANKS,
                                             str(SERVE_SHARD_DIR)),
                          SERVE_SHARD_RANKS, "sharded serving ranks",
                          timeout_s=SERVE_SHARD_TIMEOUT_S)
    res = [torch.load(SERVE_SHARD_DIR / f"rank{r}.pt")
           for r in range(SERVE_SHARD_RANKS)]
    check([r["coord"] for r in res] == [[0, 0], [0, 1], [1, 0], [1, 1]],
          f"mesh coordinates {[r['coord'] for r in res]}")
    log(f"[serve-shard] ranks in {ranks_s:.1f} s (4 ranks share one card: "
        "no time here is sharded serving's speed)")
    launches = _ss_check(ref, res, res[0])
    ref_launches = {}
    for part in ref.values():
        if not isinstance(part, dict):
            continue
        for r in [part] + [v for v in part.values() if isinstance(v, dict)]:
            for k, v in r.get("launches", {}).items():
                ref_launches[k] = ref_launches.get(k, 0) + v
    launches["serve_shard_reference"] = ref_launches
    launches["serve_ranks"] = _ss_cli(ref)
    del ref, res
    shutil.rmtree(SERVE_SHARD_DIR, ignore_errors=True)
    log(f"[serve-shard] phase 18 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 19: mixture-of-experts, full-width arctic-480b served on the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_routes():
    """Check-only: every ``models/moe.py::_route`` call's top-k experts
    (sorted along k) while the block runs, in call order."""
    from repro_torch.models import moe as moe_mod

    routes, real = [], moe_mod._route

    def recording(p, xf, cfg, *rest):
        out = real(p, xf, cfg, *rest)
        routes.append(out[1].sort(dim=-1).values.clone())
        return out

    moe_mod._route = recording
    try:
        yield routes
    finally:
        moe_mod._route = real


def _moe_cfg(dtype="bfloat16", layers=MOE_LAYERS, arch=MOE_ARCH):
    import torch
    from repro_torch.configs import get_config
    return get_config(arch).with_(n_layers=layers,
                                  dtype=getattr(torch, dtype))


def _moe_init(cfg, tag="[moe]"):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"{tag} {cfg.name} at full width, {cfg.n_layers} of "
        f"{get_config(cfg.name).n_layers} layers, "
        f"{str(cfg.dtype).replace('torch.', '')}: "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B params, "
        f"{sum(p.nbytes for p in params.parameters()) / 1e9:.2f} GB, drawn "
        f"in {time.perf_counter() - t0:.1f} s")
    return params


def _free_cuda():
    import gc

    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _moe_decode_bound(cfg, params):
    """The least time of phase 3's decode step (8 lanes at 300 positions)
    on this model: every weight read once (the embedding's 8 rows), the
    K/V read and the new token's written; or its operations: each expert
    on its whole capacity buffer (8 groups of C = top_k rows; a dense
    model has none), every other weight on 8 rows, QK and PV over 301
    keys.  Returns (GB, ms, by)."""
    from repro_torch.models.moe import _capacity
    experts = sum(p.numel() for n, p in params.named_parameters()
                  if n.split(".")[-1] in ("w_gate", "w_up", "w_down")
                  and ".moe." in n and ".moe.shared." not in n
                  and ".moe.dense_residual." not in n)
    other = sum(p.numel() for n, p in params.named_parameters()
                if n != "embed") - experts
    keys = 301
    kv = cfg.n_layers * DECODE_SLOTS * keys * 2 * cfg.n_kv_heads * cfg.dh
    n_bytes = 2 * (experts + other + kv + DECODE_SLOTS * cfg.d_model)
    rows = DECODE_SLOTS * _capacity(1, cfg) if experts else 0
    n_ops = (2 * rows * experts + 2 * DECODE_SLOTS * other
             + 4 * cfg.n_layers * DECODE_SLOTS * keys * cfg.n_heads * cfg.dh)
    return (n_bytes / 1e9, *_bound_ms(n_bytes, n_ops, "bfloat16"))


def _moe_ecfg():
    """Phase 3's paged geometry, for phases 19 (a) and 20 (a)."""
    from repro_torch.serving import EngineConfig
    return EngineConfig(page_size=PAGE_SIZE,
                        n_pages=DECODE_SLOTS * MAX_CONTEXT // PAGE_SIZE,
                        decode_slots=DECODE_SLOTS, max_context=MAX_CONTEXT,
                        prefill_batch=PREFILL_BATCH,
                        prefill_chunk=PREFILL_CHUNK)


def _moe_requests(cfg):
    """Phase 3's 12 requests, for phases 19 (a) and 20 (a)."""
    import numpy as np
    from repro_torch.serving import ServeRequest
    rng = np.random.default_rng(0)
    return [ServeRequest(rid=f"r{i}",
                         prompt=rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(33, 401))
                                             ).tolist(),
                         max_new=int(rng.integers(16, 33)))
            for i in range(12)]


def _moe_dense_requests(cfg):
    """MOE_DENSE_REQUESTS requests of 16-64 prompt tokens, for phases 19
    (b) and 20 (b)."""
    import numpy as np
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(5)
    return [Request(i, rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(16, 65))).tolist(),
                    MOE_DENSE_NEW) for i in range(MOE_DENSE_REQUESTS)]


def _first_call(step, rec):
    """``step`` recording, at its first call, the logits it returns, its
    token and length arguments and the top-k experts of every ``_route``
    call it makes (L layers: (L, lanes, 1, k); None for a dense model)."""
    import torch

    def first(*args):
        if "logits" in rec:
            return step(*args)
        with recorded_routes() as routes:
            out = step(*args)
        logits = out[0] if isinstance(out, tuple) else out
        rec.update(logits=logits.float().cpu(),
                   routes=torch.stack(routes).cpu() if routes else None,
                   args=[a.cpu() for a in args[2:]
                         if isinstance(a, torch.Tensor)])
        return out
    first.shard = getattr(step, "shard", None)
    return first


@contextlib.contextmanager
def first_decode(engine):
    """Check-only: the paged ``engine``'s first decode step while the
    block runs (:func:`_first_call`)."""
    rec, real = {}, engine._decode
    engine._decode = _first_call(real, rec)
    try:
        yield rec
    finally:
        engine._decode = real


@contextlib.contextmanager
def first_serve_step():
    """Check-only: the first decode step ``launch/serve.py::serve`` runs
    while the block runs (:func:`_first_call` on its ``make_serve_step``);
    ``rec["shard"]`` is the step's ``ShardContext``."""
    from repro_torch.launch import serve as serve_mod

    rec, real = {}, serve_mod.make_serve_step

    def make(cfg, **kw):
        step = real(cfg, **kw)
        wrapped = _first_call(step, rec)
        rec.setdefault("shard", step.shard)
        return wrapped

    serve_mod.make_serve_step = make
    try:
        yield rec
    finally:
        serve_mod.make_serve_step = real


def _moe_paged(cfg, params, tag="[moe] (a)"):
    """(a) Phase 3's requests through the paged engine, twice: every
    request completes, the flash forward and RMSNorm launch at the counts a
    decode step and a prefill chunk give, no plain version runs, and the
    second run gives the same tokens and the same bits of the first decode
    step's logits.  Then a decode step timed and profiled beside its
    bound (every weight read once).  Returns the launches and the first
    run's first decode step (:func:`first_decode`)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.serving import ServeRequest, ServingEngine

    ecfg = _moe_ecfg()
    ServingEngine(cfg, params, ecfg, device="cuda").run(
        [ServeRequest(rid="warmup", prompt=list(range(1, 150)), max_new=3)])

    def one_run():
        engine = ServingEngine(cfg, params, ecfg, device="cuda")
        reqs = _moe_requests(cfg)
        torch.cuda.synchronize()
        counts = _zero_counts()
        with first_decode(engine) as first, plain_calls() as plain:
            metrics = engine.run(reqs)
            torch.cuda.synchronize()
        return engine, reqs, metrics.summary(), counts(), plain, first

    torch.cuda.reset_peak_memory_stats()
    engine, reqs, summ, launches, plain, first = one_run()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in reqs:
        check(r.done and len(r.tokens) == r.max_new
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{tag} request {r.rid}: {r.tokens} of {r.max_new}")
    check(summ["completed"] == len(reqs), f"completed {summ['completed']}")
    check(not plain, f"{tag} the paged engine called plain versions: "
          f"{plain}")

    P = ecfg.pages_per_slot
    rows = torch.arange(DECODE_SLOTS * P, dtype=torch.int32,
                        device="cuda").reshape(DECODE_SLOTS, P)
    tok = torch.arange(1, DECODE_SLOTS + 1, dtype=torch.int32, device="cuda")
    lens = torch.full((DECODE_SLOTS,), 300, dtype=torch.int32, device="cuda")
    ptok = torch.zeros(PREFILL_BATCH, PREFILL_CHUNK, dtype=torch.int32,
                       device="cuda")
    plen = torch.full((PREFILL_BATCH,), 400, dtype=torch.int32,
                      device="cuda")

    def decode():
        return engine._decode(params, engine.pools, tok, rows, lens)

    def prefill():
        return engine._prefill(params, engine.pools, ptok,
                               rows[:PREFILL_BATCH], 256, plen)

    def per_call(step):
        before = (flash_attention_cuda.launches, rmsnorm_cuda.launches)
        out = step()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{tag} logits not finite")
        return (flash_attention_cuda.launches - before[0],
                rmsnorm_cuda.launches - before[1])

    per_decode, per_prefill = per_call(decode), per_call(prefill)
    calls = (summ["decode_steps"], summ["prefill_chunks"])
    for i, name in enumerate(("flash_attention", "rmsnorm")):
        want = per_decode[i] * calls[0] + per_prefill[i] * calls[1]
        check(launches[name] == want and launches[name] > 0,
              f"{tag} the paged run launched {name} {launches[name]} "
              f"times, not {want}")
    check(per_decode[0] == per_prefill[0] == cfg.n_layers,
          f"flash launches a decode step / prefill chunk: {per_decode[0]}, "
          f"{per_prefill[0]}, not {cfg.n_layers}")
    _, reqs2, _, _, _, first2 = one_run()
    same_tokens = [r.tokens for r in reqs2] == [r.tokens for r in reqs]
    same_bits = torch.equal(first2["logits"], first["logits"])
    log(f"{tag} second run: the same tokens {same_tokens}, the first "
        f"decode step's logits the same bits {same_bits}")
    check(same_tokens and same_bits, f"{tag} the serving forward is not "
          "deterministic run to run")

    ms = cuda_ms(decode, iters=10)
    busy, kernels, cats = profile_step(f"{tag} paged decode", decode, ms)
    prefill_ms = cuda_ms(prefill, iters=5, warmup=1)
    bound_gb, bound, by = _moe_decode_bound(cfg, params)
    result = {
        "requests": summ["completed"], "new_tokens": summ["new_tokens"],
        "decode_steps": summ["decode_steps"],
        "prefill_chunks": summ["prefill_chunks"], "wall_s": summ["wall_s"],
        "tok_per_s": summ["tok_per_s"], "ttft_ms_p50": summ["ttft_ms_p50"],
        "decode_step_ms": ms, "decode_busy_ms": busy,
        "decode_bound_ms": bound, "decode_bound_by": by,
        "decode_bound_gb": bound_gb,
        "decode_device_ms_by_category": cats, "kernels_per_step": kernels,
        "prefill_chunk_ms": prefill_ms, "peak_mem_gb": peak_gb,
        "launches_per_decode_step": dict(zip(("flash_attention", "rmsnorm"),
                                             per_decode)),
        "launches_per_prefill_chunk": dict(zip(
            ("flash_attention", "rmsnorm"), per_prefill)),
    }
    log(f"{tag} paged " + json.dumps(result))
    return launches, first


def _moe_decode_vs_prefill(cfg, params, T, tol, tag):
    """make_serve_step's logits at every position of 2 lanes of T random
    tokens against make_prefill_step's, at the check-only capacity where
    nothing drops; positions whose routing differs at some layer between
    the two (bf16 noise near a top-k tie) are counted and left out of the
    gate.  Returns (worst, flips, the prefill's routes)."""
    import torch
    from repro_torch.models import init_decode_state
    from repro_torch.runtime.executor import make_prefill_step, make_serve_step

    cfg = cfg.with_(capacity_factor=cfg.n_experts / cfg.top_k)
    B = DECODE_VS_PREFILL_LANES
    g = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                         device="cuda", dtype=torch.int32)
    with recorded_routes() as pre:
        full = make_prefill_step(cfg)(params, {"tokens": toks}).float()
    step = make_serve_step(cfg)
    state = init_decode_state(cfg, B, T, device="cuda")
    errs = []
    with recorded_routes() as dec:
        for t in range(T):
            logits, state = step(params, state, toks[:, t])
            want = full[:, t]
            errs.append((logits.float() - want).abs().amax(-1)
                        / want.abs().amax(-1))
    errs = torch.stack(errs, 1).cpu()                          # (B, T)
    L = len(pre)
    dec = torch.stack([torch.cat(dec[li::L], 1) for li in range(L)])
    pre = torch.stack(pre)                                     # (L,B,T,k)
    agree = (dec == pre).all(-1).all(0).cpu()                  # (B, T)
    flips = int((dec != pre).any(-1).sum())
    check(bool(torch.isfinite(full).all()), "MoE prefill not finite")
    check(bool(agree.any()), "no position's routing agrees")
    at = divmod(int(errs.masked_fill(~agree, -1).argmax()), T)
    worst = errs[agree].max().item()
    what = str(cfg.dtype).replace("torch.", "")
    log(f"{tag} decode vs prefill, {cfg.name} at {cfg.n_layers} layers, "
        f"{B} x {T} tokens, {what}, capacity_factor "
        f"{cfg.capacity_factor:g} (nothing drops): {flips} (layer, token) "
        f"routings differ, {int((~agree).sum())} positions left out; over "
        f"the rest max |diff| / max |logit| worst {worst:.3e} at (lane, t) "
        f"{at}, mean {errs[agree].mean().item():.3e}; over all positions "
        f"worst {errs.max().item():.3e} (tol {tol:.0e})")
    check(worst <= tol, f"{cfg.name} {what} decode and prefill logits "
          f"differ by {worst} of the largest where the routing agrees")
    return toks


def _moe_drops(cfg, params, toks):
    """make_prefill_step at the config's capacity_factor on the same
    tokens: how many (token, choice) pairs each layer drops."""
    import torch
    from repro_torch.models.moe import _capacity
    from repro_torch.runtime.executor import make_prefill_step

    with recorded_routes() as routes:
        logits = make_prefill_step(cfg)(params, {"tokens": toks})
    check(bool(torch.isfinite(logits).all()), "MoE prefill not finite")
    T = toks.shape[1]
    C = _capacity(T, cfg)
    drops = []
    for topi in routes:                                        # (B, T, k)
        counts = torch.nn.functional.one_hot(
            topi.flatten(1), cfg.n_experts).sum(1)             # (B, E)
        drops.append(int((counts - C).clamp_min(0).sum()))
    pairs = toks.numel() * cfg.top_k
    log(f"[moe] (b) prefill of {tuple(toks.shape)} at capacity_factor "
        f"{cfg.capacity_factor:g} (C = {C}): dropped (token, choice) pairs "
        f"by layer {drops} of {pairs} each")
    return drops


def _moe_dense_serve(cfg, params, tag="[moe] (b)"):
    """(b) serve on MOE_DENSE_LANES lanes of a DENSE_SERVE_CONTEXT-token
    cache: every request completes, the flash forward launches once a layer
    a step, no plain version runs.  Returns the launches and the first
    step (:func:`first_serve_step`)."""
    import torch
    from repro_torch.launch.serve import serve

    reqs = _moe_dense_requests(cfg)
    counts = _zero_counts()
    with counted_serve_steps() as steps, first_serve_step() as first, \
            plain_calls() as plain:
        t0 = time.perf_counter()
        serve(cfg, reqs, MOE_DENSE_LANES, DENSE_SERVE_CONTEXT, verbose=False,
              device="cuda", params=params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counts()
    for r in reqs:
        check(r.done and len(r.generated) == MOE_DENSE_NEW
              and all(0 <= t < cfg.vocab_size for t in r.generated),
              f"{tag} dense request {r.rid}: {r.generated}")
    check(not plain, f"{tag} the dense engine called plain versions: "
          f"{plain}")
    n = steps["n"]
    check(launches["flash_attention"] == cfg.n_layers * n,
          f"{launches['flash_attention']} flash launches in {n} steps")
    new = sum(len(r.generated) for r in reqs)
    log(f"{tag} serve: {len(reqs)} requests on {MOE_DENSE_LANES} lanes "
        f"of {DENSE_SERVE_CONTEXT}, {new} tokens in {wall:.2f} s "
        f"({new / wall:.1f} tok/s, {n} steps, {1e3 * wall / n:.2f} ms a "
        f"step); launches {launches}")
    return launches, first


def _moe_dispatch_identity(params, cfg):
    """(c) One full-width MoE layer on a prefill chunk and a decode batch:
    sort, einsum and grouped agree within MOE_DISPATCH_TOL of the largest
    output and keep the same (row, token, expert) pairs; sort's and
    einsum's aux the same."""
    import torch
    from repro_torch.models import moe as moe_mod

    moe = params.blocks[0].moe
    g = torch.Generator(device="cuda").manual_seed(6)
    for name, (G, T) in (("prefill", (PREFILL_BATCH, PREFILL_CHUNK)),
                         ("decode", (DECODE_SLOTS, 1))):
        x = torch.randn(G, T, cfg.d_model, generator=g,
                        device="cuda").to(cfg.dtype)
        # a token's signature: its row's sum in float64, unique here
        sig = {round(v, 6): (gi, t) for gi, row in enumerate(
            x.double().sum(-1).tolist()) for t, v in enumerate(row)}
        check(len(sig) == G * T, "token signatures collide")
        out, kept = {}, {}
        for dispatch in ("sort", "einsum", "grouped"):
            bufs, real = [], moe_mod._experts
            moe_mod._experts = lambda p, h: (bufs.append(h), real(p, h))[1]
            try:
                with torch.inference_mode():
                    out[dispatch] = moe_mod.moe_ffn(moe, x, cfg,
                                                    dispatch=dispatch)
            finally:
                moe_mod._experts = real
            (h,) = bufs
            E = cfg.n_experts
            h = h.reshape(E, G, -1, cfg.d_model)
            rows = h.double().sum(-1).cpu()                    # (E, G, C)
            full = h.abs().amax(-1) > 0
            kept[dispatch] = {(*sig[round(rows[e, gi, c].item(), 6)], e)
                              for e, gi, c in full.nonzero().tolist()}
        ref = out["sort"][0].float()
        errs = {d: ((o.float() - ref).abs().max() / ref.abs().max()).item()
                for d, (o, _) in out.items()}
        same_pairs = kept["sort"] == kept["einsum"] == kept["grouped"]
        aux = {d: a.item() for d, (_, a) in out.items()}
        log(f"[moe] (c) {name} {G} x {T}: max |diff| / max |out| against "
            f"sort: {errs} (tol {MOE_DISPATCH_TOL:.0e}); {len(kept['sort'])} "
            f"kept pairs of {G * T * cfg.top_k}, the same in all three "
            f"{same_pairs}; aux {aux}")
        check(max(errs.values()) <= MOE_DISPATCH_TOL and same_pairs
              and aux["sort"] == aux["einsum"],
              f"the MoE dispatches disagree at {name}")


def _moe_cpu_vs_card():
    """(d) Reduced fp32 arctic-480b and kimi-k2-1t-a32b on the card and on
    the CPU from the same weights: the paged engine's and serve's greedy
    tokens identical, and 3 steps of train's losses within
    TRAIN_LOSS_RTOL."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.serve import Request, serve
    from repro_torch.models import init_lm
    from repro_torch.optim import adamw_init
    from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

    counts = _zero_counts()
    for arch, kw in MOE_REDUCED:
        cfg = get_config(arch).reduced(**kw).with_(dtype=torch.float32)
        params_cpu = init_lm(cfg, seed=0, device="cpu")
        params_gpu = copy.deepcopy(params_cpu).to("cuda")
        rng = np.random.default_rng(1)
        spec = [(rng.integers(0, cfg.vocab_size, int(rng.integers(5, 41))
                              ).tolist(), int(rng.integers(4, 11)))
                for _ in range(6)]
        ecfg = EngineConfig(page_size=8, n_pages=48, decode_slots=4,
                            max_context=96, prefill_batch=2,
                            prefill_chunk=16)
        paged, dense = {}, {}
        for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
            reqs = [ServeRequest(rid=str(i), prompt=p, max_new=n)
                    for i, (p, n) in enumerate(spec)]
            ServingEngine(cfg, params, ecfg, device=dev).run(reqs)
            paged[dev] = [r.tokens for r in reqs]
            reqs = [Request(i, p, n) for i, (p, n) in enumerate(spec)]
            serve(cfg, reqs, 3, 48, verbose=False, device=dev, params=params)
            dense[dev] = [r.generated for r in reqs]
        log(f"[moe] (d) reduced fp32 {arch} (E {cfg.n_experts}, top-"
            f"{cfg.top_k}, first_k_dense {cfg.first_k_dense}), {len(spec)} "
            f"requests: paged tokens card = cpu {paged['cpu'] == paged['cuda']}"
            f", dense tokens card = cpu {dense['cpu'] == dense['cuda']}")
        check(paged["cpu"] == paged["cuda"] and dense["cpu"] == dense["cuda"],
              f"{arch}: card and CPU tokens differ")

        def same_weights(cfg, *, seed, opt_cfg, device):
            params = copy.deepcopy(params_cpu).to(device)
            return params, adamw_init(list(params.parameters()), opt_cfg)

        argv = ["--reduced", "--arch", arch, "--steps", "3", "--batch", "2",
                "--seq", "64", "--log-every", "1"]
        init, train_cli.init_train_state = (train_cli.init_train_state,
                                            same_weights)
        try:
            losses = {dev: [h["loss"] for h in train_cli.train(
                          cfg, train_cli.parse_args(argv + ["--device", dev]))]
                      for dev in ("cpu", "cuda")}
        finally:
            train_cli.init_train_state = init
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                        losses["cpu"]))
        log(f"[moe] (d) reduced fp32 {arch} through repro_torch.launch.train"
            f", 3 steps of 2 x 64: card {losses['cuda']} cpu "
            f"{losses['cpu']}; max relative diff {worst:.2e} (tol "
            f"{TRAIN_LOSS_RTOL:.0e})")
        check(worst <= TRAIN_LOSS_RTOL, f"{arch} losses differ by {worst}")
    launches = counts()
    check(launches["flash_attention"] > 0 and launches["flash_attention_bwd"]
          > 0 and launches["rmsnorm_bwd"] > 0,
          f"the reduced MoE runs on the card launched {launches}")
    return launches


def phase_moe():
    """Phase 19.  Returns {path: launches} and phase 20's reference: the
    first decode step of (a)'s first run and of (b)'s serve."""
    t_phase = time.perf_counter()
    _free_cuda()
    launches, ref = {}, {}
    cfg = _moe_cfg()
    params = _moe_init(cfg)
    launches["moe_serve"], ref["paged"] = _moe_paged(cfg, params)
    toks = _moe_decode_vs_prefill(cfg, params, DECODE_VS_PREFILL_T,
                                  MOE_DECODE_VS_PREFILL_TOL, "[moe] (b)")
    _moe_drops(cfg, params, toks)
    launches["moe_dense_serve"], ref["dense"] = _moe_dense_serve(cfg,
                                                                 params)
    _moe_dispatch_identity(params, cfg)
    del params
    _free_cuda()
    cfg32 = _moe_cfg("float32", MOE_FP32_LAYERS)
    params = _moe_init(cfg32)
    _moe_decode_vs_prefill(cfg32, params, DECODE_VS_PREFILL_T_FP32,
                           REL_TOL["float32"], "[moe] (b)")
    del params
    _free_cuda()
    launches["moe_cpu_vs_card"] = _moe_cpu_vs_card()
    log(f"[moe] phase 19 in {time.perf_counter() - t_phase:.1f} s")
    return launches, ref


# ---------------------------------------------------------------------------
# phase 20: MoE sharded, full-width arctic-480b on 4 ranks sharing the card
# ---------------------------------------------------------------------------

MOE_SHARD_DIR = ROOT / "build" / "moe_shard"


def _moe_train_cfgs():
    """(tag, config) of (c): each of MOE_REDUCED in bf16 and fp32."""
    import torch
    from repro_torch.configs import get_config
    return [(f"{arch} {dtype}", get_config(arch).reduced(**kw).with_(
                dtype=getattr(torch, dtype)))
            for arch, kw in MOE_REDUCED for dtype in ("bfloat16", "float32")]


def _moe_train_batch(cfg):
    import torch
    from repro_torch.data import DataConfig, synthetic_lm_batches
    b = next(synthetic_lm_batches(DataConfig(
        seq_len=MOE_TRAIN_SEQ, global_batch=MOE_TRAIN_BATCH,
        vocab_size=cfg.vocab_size, seed=0)))
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _moe_train_reference(run_dir):
    """(c)'s single process on the card and on the CPU, on the card's draw
    of ``init_lm`` seed 0 (the ranks draw on the card): the loss and every
    gradient of one batch, saved for rank 0."""
    import torch
    from repro_torch.models import init_lm, lm_loss

    def run(params, cfg, dev):
        batch = {k: v.to(dev) for k, v in _moe_train_batch(cfg).items()}
        loss = lm_loss(params, batch, cfg)
        named = list(params.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
        return {"loss": float(loss.detach()),
                "grads": {n: g.float().cpu() for (n, _), g in zip(named,
                                                                  grads)}}

    out = {}
    for tag, cfg in _moe_train_cfgs():
        params = init_lm(cfg, seed=0, device="cuda")
        if cfg.dtype == torch.bfloat16:     # the same weights in fp32
            out[f"{tag} fp32"] = run(copy.deepcopy(params).float(),
                                     cfg.with_(dtype=torch.float32), "cuda")
        for dev in ("cuda", "cpu"):
            out[f"{tag} {dev}"] = run(params.to(dev), cfg, dev)
    for tag, cfg in _moe_train_cfgs():
        if cfg.dtype == torch.bfloat16:
            own = out[f"{tag} cuda"]["grads"]
            exact = out.pop(f"{tag} fp32")["grads"]
            errs = {n: ((own[n] - g).abs().max() / g.abs().max()).item()
                    for n, g in exact.items()}
            worst = max(errs, key=errs.get)
            log(f"[moe-shard] (c) {tag}: one process on the card, its bf16 "
                f"gradients against the same weights' in fp32: worst leaf "
                f"{worst} {errs[worst]:.2e}, median "
                f"{sorted(errs.values())[len(errs) // 2]:.2e}")
    torch.save(out, f"{run_dir}/train_ref.pt")


def _moe_shard_paged(mesh):
    """(a) on a rank: full-width arctic-480b under TP through the paged
    engine, phase 3's requests twice (tokens, launches, plain calls, gloo
    bytes, peak memory and the first decode step of each run); then a
    decode step (8 lanes at 300 positions) and a prefill chunk: their
    launches and gloo bytes, the decode step's wall and busy ms."""
    import torch
    from repro_torch.runtime import ShardPolicy, init_serving_params
    from repro_torch.serving import ServingEngine

    cfg, pol = _moe_cfg(), ShardPolicy(tp=True, zero=False)
    t0 = time.perf_counter()
    params = init_serving_params(cfg, mesh=mesh, policy=pol, seed=0,
                                 device="cuda")
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0,
           "param_gb": sum(p.nbytes for p in params.parameters()) / 1e9,
           "runs": []}
    ecfg = _moe_ecfg()
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine = ServingEngine(cfg, params, ecfg, device="cuda", mesh=mesh,
                               policy=pol)
        reqs = _moe_requests(cfg)
        sent = _ss_traffic(engine._decode, engine._prefill)
        counts = _zero_counts()
        with first_decode(engine) as first, plain_calls() as plain:
            metrics = engine.run(reqs)
            torch.cuda.synchronize()
        res["runs"].append({
            "tokens": [r.tokens for r in reqs],
            "complete": all(r.done and len(r.tokens) == r.max_new
                            for r in reqs),
            "launches": counts(), "plain": dict(plain),
            "summary": metrics.summary(), "first": first,
            "gloo_bytes": _ss_traffic(engine._decode, engine._prefill)
            - sent, "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    P = ecfg.pages_per_slot
    rows = torch.arange(DECODE_SLOTS * P, dtype=torch.int32,
                        device="cuda").reshape(DECODE_SLOTS, P)
    tok = torch.arange(1, DECODE_SLOTS + 1, dtype=torch.int32, device="cuda")
    lens = torch.full((DECODE_SLOTS,), 300, dtype=torch.int32, device="cuda")
    ptok = torch.zeros(PREFILL_BATCH, PREFILL_CHUNK, dtype=torch.int32,
                       device="cuda")
    plen = torch.full((PREFILL_BATCH,), 400, dtype=torch.int32,
                      device="cuda")
    calls = {"decode": lambda: engine._decode(params, engine.pools, tok,
                                              rows, lens),
             "prefill": lambda: engine._prefill(
                 params, engine.pools, ptok, rows[:PREFILL_BATCH], 256,
                 plen)}
    for name, call in calls.items():
        sent = _ss_traffic(engine._decode, engine._prefill)
        counts = _zero_counts()
        call()
        torch.cuda.synchronize()
        res[f"per_{name}"] = counts()
        res[f"{name}_gloo_bytes"] = _ss_traffic(
            engine._decode, engine._prefill) - sent
    res["decode_ms"] = cuda_ms(calls["decode"], iters=3, warmup=1)
    res["decode_busy_ms"] = _ss_busy_ms(calls["decode"], n=1)
    return res


def _moe_shard_dense(mesh):
    """(b) on a rank: full-width arctic-480b under EP through ``serve``
    (tokens, launches, steps, all-to-all and gloo bytes a step, peak
    memory, the first step), then one step's wall and busy ms."""
    import torch
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_decode_state
    from repro_torch.runtime import (ShardPolicy, init_serving_params,
                                     make_serve_step)

    cfg, pol = _moe_cfg(), ShardPolicy(tp=False, zero=False)
    t0 = time.perf_counter()
    params = init_serving_params(cfg, mesh=mesh, policy=pol, seed=0,
                                 device="cuda")
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0,
           "param_gb": sum(p.nbytes for p in params.parameters()) / 1e9}
    reqs = _moe_dense_requests(cfg)
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts()
    with counted_serve_steps() as steps, first_serve_step() as first, \
            plain_calls() as plain:
        t0 = time.perf_counter()
        serve(cfg, reqs, MOE_DENSE_LANES, DENSE_SERVE_CONTEXT, verbose=False,
              device="cuda", params=params, mesh=mesh, policy=pol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ctx, n = first.pop("shard"), steps["n"]
    res.update(tokens=[r.generated for r in reqs],
               complete=all(r.done and len(r.generated) == MOE_DENSE_NEW
                            for r in reqs),
               launches=counts(), plain=dict(plain), steps=n, wall_s=wall,
               a2a_bytes_per_step=ctx.traffic.a2a_bytes / n,
               gloo_bytes_per_step=ctx.traffic.bytes_sent / n,
               lanes=ctx.lane_range(MOE_DENSE_LANES), first=first,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    step = make_serve_step(cfg, mesh=mesh, policy=pol)
    state = init_decode_state(cfg, MOE_DENSE_LANES, DENSE_SERVE_CONTEXT,
                              device="cuda", shard=step.shard)
    state["index"] = _i32([300] * MOE_DENSE_LANES)
    tok = _i32(list(range(1, MOE_DENSE_LANES + 1)))
    res["step_ms"] = cuda_ms(lambda: step(params, state, tok), iters=2,
                             warmup=1)
    res["step_busy_ms"] = _ss_busy_ms(lambda: step(params, state, tok), n=1)
    return res


def _moe_shard_train(tp_mesh, ep_mesh, run_dir):
    """(c) on a rank: each of MOE_REDUCED in bf16 and fp32 under TP with
    ZeRO and under EP, the loss and gradients of one batch; rank 0 holds
    each gathered leaf against the single process's."""
    import torch
    import torch.distributed as dist
    from repro_torch.runtime import (ShardPolicy, init_train_state,
                                     make_sharded_loss)

    ref = (torch.load(f"{run_dir}/train_ref.pt") if dist.get_rank() == 0
           else None)
    out = {}
    counts = _zero_counts()
    with plain_calls() as plain:
        for tag, cfg in _moe_train_cfgs():
            batch = _moe_train_batch(cfg)
            for name, mesh, pk in (("tp", tp_mesh, dict(tp=True, zero=True)),
                                   ("ep", ep_mesh, dict(tp=False,
                                                        zero=False))):
                pol = ShardPolicy(**pk)
                params, _ = init_train_state(cfg, mesh=mesh, policy=pol,
                                             seed=0, device="cuda")
                fn = make_sharded_loss(cfg, mesh, pol)
                loss, grads = fn(params, batch)
                errs = {"cuda": {}, "cpu": {}}
                for (n, _), g in zip(params.named_parameters(), grads):
                    whole = fn.shard.gather_tensor(n, g).float().cpu()
                    for dev in errs if ref is not None else ():
                        want = ref[f"{tag} {dev}"]["grads"][n]
                        errs[dev][n] = ((whole - want).abs().max()
                                        / want.abs().max().clamp_min(1e-30)
                                        ).item()
                out[f"{tag} {name}"] = {
                    "loss": float(loss), "errs": errs,
                    "ref_loss": None if ref is None else {
                        dev: ref[f"{tag} {dev}"]["loss"] for dev in errs}}
        torch.cuda.synchronize()
    out["launches"], out["plain"] = counts(), dict(plain)
    return out


def moe_shard_rank(rank, world, run_dir):
    """One of MOE_SHARD_RANKS gloo ranks sharing the card: (a) on a
    MOE_TP_MESH (data, model) mesh, (b) on a MOE_EP_MESH (data, expert)
    mesh, each model freed before the next is drawn, then (c); saves its
    results."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import (init_distributed, make_expert_mesh,
                                         make_local_mesh)

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{run_dir}/rendezvous",
                     timeout_s=MOE_SHARD_TIMEOUT_S)
    try:
        tp = make_local_mesh(MOE_TP_MESH[1])
        ep = make_expert_mesh(MOE_EP_MESH[1], MOE_EP_MESH[0])
        train_tp = make_local_mesh(MOE_TRAIN_TP_MESH[1])
        out = {"coord": [tp.get_local_rank("model"),
                         ep.get_local_rank("expert")]}
        t0 = time.perf_counter()
        out["a"] = _moe_shard_paged(tp)
        out["a"]["s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()              # (a)'s shards freed on every rank
        t0 = time.perf_counter()
        out["b"] = _moe_shard_dense(ep)
        out["b"]["s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["c"] = _moe_shard_train(train_tp, ep, run_dir)
        out["c"]["s"] = time.perf_counter() - t0
        torch.save(out, f"{run_dir}/rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _moe_logit_gate(tag, want, got, routes, keep):
    """The first decode step's logits ``got`` (lanes, V) against phase
    19's ``want`` on the lanes ``keep`` (bool, lanes) where the top-k
    experts ``routes`` (L, lanes, 1, k) of both agree at every layer;
    returns (worst, lanes compared, flips)."""
    agree = (routes == want["routes"]).all(-1).flatten(2).all(-1).all(0)
    flips = int((keep & ~agree).sum())
    use = keep & agree
    check(int(use.sum()) * 2 >= int(keep.sum()) and bool(use.any()),
          f"{tag}: the routing agrees on {int(use.sum())} of "
          f"{int(keep.sum())} lanes")
    w = want["logits"][use]
    worst = ((got[use] - w).abs().max() / w.abs().max()).item()
    log(f"[moe-shard] {tag} first decode step against the single process: "
        f"max |diff| / max |logit| {worst:.3e} over {int(use.sum())} lanes "
        f"(tol {MOE_SHARD_LOGIT_TOL:.0e}); {flips} lane(s) left out whose "
        f"top-{routes.shape[-1]} experts differ at some layer")
    check(worst <= MOE_SHARD_LOGIT_TOL, f"{tag}: logits off by {worst}")
    return worst, int(use.sum()), flips


def _moe_shard_check_a(ref, res, launches):
    """(a)'s gates over the ranks' results ``res``."""
    import torch
    L = MOE_LAYERS
    for r, a in enumerate(res):
        for i, run in enumerate(a["runs"]):
            check(run["complete"], f"(a) rank {r} run {i}: a request did "
                  "not complete")
            check(not run["plain"], f"(a) rank {r}: plain versions ran "
                  f"{run['plain']}")
            summ = run["summary"]
            for k in ("flash_attention", "rmsnorm"):
                want = (a["per_decode"][k] * summ["decode_steps"]
                        + a["per_prefill"][k] * summ["prefill_chunks"])
                check(run["launches"][k] == want > 0,
                      f"(a) rank {r} run {i}: {k} launched "
                      f"{run['launches'][k]} times, not {want}")
        check(a["per_decode"]["flash_attention"] == L
              == a["per_prefill"]["flash_attention"],
              f"(a) rank {r}: flash launches a decode step / prefill chunk "
              f"{a['per_decode']['flash_attention']} / "
              f"{a['per_prefill']['flash_attention']}, not {L}")
        for run in a["runs"]:
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
    runs = [run for a in res for run in a["runs"]]
    check(all(run["tokens"] == runs[0]["tokens"] for run in runs),
          "(a) the ranks' or the runs' tokens differ")
    firsts = [run["first"]["logits"] for run in runs]
    same_bits = all(torch.equal(f, firsts[0]) for f in firsts)
    check(same_bits, "(a) the first decode step's logits differ between "
          "runs or ranks")
    first = res[0]["runs"][0]["first"]
    tok, lens = first["args"][0], first["args"][2]
    keep = ((lens >= 0) & (ref["args"][2] >= 0)
            & (tok == ref["args"][0]))
    log(f"[moe-shard] (a) the first decode step's input token agrees with "
        f"the single process's on {int(keep.sum())} of "
        f"{int((lens >= 0).sum())} active lanes")
    _moe_logit_gate("(a) paged TP", ref, first["logits"], first["routes"],
                    keep)
    summ = res[0]["runs"][1]["summary"]
    log("[moe-shard] (a) paged TP on (data, model) " + json.dumps({
        "tok_per_s": summ["tok_per_s"], "wall_s": summ["wall_s"],
        "decode_steps": summ["decode_steps"],
        "prefill_chunks": summ["prefill_chunks"],
        "ttft_ms_p50": summ["ttft_ms_p50"],
        "same_bits_run_to_run_and_rank_to_rank": same_bits,
        "param_gb_by_rank": [a["param_gb"] for a in res],
        "init_s_by_rank": [a["init_s"] for a in res],
        "decode_step_ms_by_rank": [a["decode_ms"] for a in res],
        "decode_busy_ms_by_rank": [a["decode_busy_ms"] for a in res],
        "decode_gloo_bytes_by_rank": [a["decode_gloo_bytes"] for a in res],
        "prefill_gloo_bytes_by_rank": [a["prefill_gloo_bytes"]
                                       for a in res],
        "run_gloo_bytes_by_rank": [a["runs"][1]["gloo_bytes"] for a in res],
        "peak_gb_by_rank": [a["runs"][1]["peak_gb"] for a in res],
        "launches_per_decode_step": res[0]["per_decode"],
        "launches_per_prefill_chunk": res[0]["per_prefill"],
        "phase_s_by_rank": [a["s"] for a in res]}))


def _moe_shard_check_b(ref, res, launches):
    """(b)'s gates over the ranks' results ``res``."""
    import torch
    L = MOE_LAYERS
    for r, b in enumerate(res):
        check(b["complete"], f"(b) rank {r}: a request did not complete")
        check(not b["plain"], f"(b) rank {r}: plain versions ran "
              f"{b['plain']}")
        check(b["launches"]["flash_attention"] == L * b["steps"] > 0,
              f"(b) rank {r}: {b['launches']['flash_attention']} flash "
              f"launches in {b['steps']} steps")
        check(b["a2a_bytes_per_step"] > 0, f"(b) rank {r}: no all-to-all")
        for k, v in b["launches"].items():
            launches[k] = launches.get(k, 0) + v
    check(all(b["tokens"] == res[0]["tokens"] for b in res),
          "(b) the ranks' tokens differ")
    check([b["lanes"] for b in res] == [
        (2 * r, 2 * r + 2) for r in range(MOE_SHARD_RANKS)],
        f"(b) lanes by rank {[b['lanes'] for b in res]}")
    routes = torch.cat([b["first"]["routes"] for b in res], 1)
    keep = torch.ones(MOE_DENSE_LANES, dtype=torch.bool)
    _moe_logit_gate("(b) dense EP", ref, res[0]["first"]["logits"], routes,
                    keep)
    log("[moe-shard] (b) dense-cache serve, EP on (data, expert) "
        + json.dumps({
            "steps": res[0]["steps"], "wall_s": res[0]["wall_s"],
            "tok_per_s": MOE_DENSE_REQUESTS * MOE_DENSE_NEW
            / res[0]["wall_s"],
            "param_gb_by_rank": [b["param_gb"] for b in res],
            "init_s_by_rank": [b["init_s"] for b in res],
            "a2a_bytes_per_step_by_rank": [b["a2a_bytes_per_step"]
                                           for b in res],
            "gloo_bytes_per_step_by_rank": [b["gloo_bytes_per_step"]
                                            for b in res],
            "step_ms_by_rank": [b["step_ms"] for b in res],
            "step_busy_ms_by_rank": [b["step_busy_ms"] for b in res],
            "peak_gb_by_rank": [b["peak_gb"] for b in res],
            "phase_s_by_rank": [b["s"] for b in res]}))


def _moe_shard_check_c(res, launches):
    """(c)'s gates: rank 0's losses and gradient errors."""
    c = res[0]["c"]
    for r in res:
        check(not r["c"]["plain"], f"(c) plain versions ran "
              f"{r['c']['plain']}")
        for k, v in r["c"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    failed = []
    for key, v in c.items():
        if not isinstance(v, dict) or "errs" not in v:
            continue
        _, dtype, mesh = key.split()
        gated = MOE_SHARD_TRAIN_REF[dtype]
        loss_tol, grad_tol = MOE_SHARD_TRAIN_TOL[(dtype, mesh)]
        for dev, errs in v["errs"].items():
            want = v["ref_loss"][dev]
            rel = abs(v["loss"] - want) / abs(want)
            worst = max(errs, key=errs.get)
            router = max(e for n, e in errs.items()
                         if n.endswith(".moe.router"))
            log(f"[moe-shard] (c) {key} ranks on the card against one "
                f"process on the {dev}: loss {v['loss']:.6f} vs {want:.6f}, "
                f"relative {rel:.2e}; worst leaf {worst} {errs[worst]:.2e}, "
                f"router {router:.2e}" + (
                    f" (tol {loss_tol:.0e}, {grad_tol})" if dev == gated
                    else " (not gated)"))
            if dev == gated and (rel > loss_tol or (
                    grad_tol is not None and errs[worst] > grad_tol)):
                failed.append(f"{key} against the {dev}: loss {rel:.2e}, "
                              f"{worst} {errs[worst]:.2e}")
    check(not failed, f"(c) {failed}")
    check(all(launches.get(k, 0) > 0 for k in (
        "flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd")),
        f"(c) launches {launches}")
    log(f"[moe-shard] (c) launches over the ranks {launches}, "
        f"{[round(r['c']['s'], 1) for r in res]} s by rank")


def phase_moe_shard(ref):
    """Phase 20 on phase 19's reference ``ref``.  Returns {path:
    launches}."""
    import torch

    t_phase = time.perf_counter()
    _free_cuda()
    shutil.rmtree(MOE_SHARD_DIR, ignore_errors=True)
    MOE_SHARD_DIR.mkdir(parents=True)
    _moe_train_reference(MOE_SHARD_DIR)
    _free_cuda()
    ranks_s = spawn_ranks(moe_shard_rank, (MOE_SHARD_RANKS,
                                           str(MOE_SHARD_DIR)),
                          MOE_SHARD_RANKS, "MoE sharded ranks",
                          timeout_s=MOE_SHARD_TIMEOUT_S)
    res = [torch.load(MOE_SHARD_DIR / f"rank{r}.pt")
           for r in range(MOE_SHARD_RANKS)]
    check([r["coord"] for r in res] == [[r, r] for r in range(
        MOE_SHARD_RANKS)], f"mesh coordinates {[r['coord'] for r in res]}")
    log(f"[moe-shard] {MOE_SHARD_RANKS} ranks in {ranks_s:.1f} s (they "
        "share one card: no time here is sharded serving's speed)")
    launches = {"moe_tp_serve": {}, "moe_ep_serve": {},
                "moe_shard_train": {}}
    _moe_shard_check_a(ref["paged"], [r["a"] for r in res],
                       launches["moe_tp_serve"])
    _moe_shard_check_b(ref["dense"], [r["b"] for r in res],
                       launches["moe_ep_serve"])
    _moe_shard_check_c(res, launches["moe_shard_train"])
    shutil.rmtree(MOE_SHARD_DIR, ignore_errors=True)
    log(f"[moe-shard] phase 20 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 21: kimi-k2-1t-a32b at full width, attention at dh 112
# ---------------------------------------------------------------------------

def _param_footprint(cfg):
    """(parameters, GB in the config's dtype) of ``init_lm(cfg)``, from
    its shapes on the meta device."""
    from repro_torch.models import init_lm
    n = sum(p.numel() for p in init_lm(cfg, device="meta").parameters())
    return n, n * cfg.dtype.itemsize / 1e9


def phase_kimi():
    """Phase 21: kimi-k2-1t-a32b at full width, KIMI_LAYERS of 61 layers
    (the dense first layer and one MoE layer), bf16, random weights from
    seed 0.  The memory is reckoned from the shapes and printed before
    the draw.  (a) phase 3's 12 requests through the paged engine, twice
    (:func:`_moe_paged`: every request completes, flash at dh 112 once a
    layer a decode step and a prefill chunk, no plain version, the same
    tokens and first-step bits in both runs, the decode step against its
    bound); (b) ``make_serve_step`` against ``make_prefill_step`` on 2 x
    256 tokens where the routing agrees (384 experts, top-8, the shared
    expert), the flips counted.  Returns {path: launches}."""
    import torch
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    _free_cuda()
    cfg = _moe_cfg(layers=KIMI_LAYERS, arch=KIMI_ARCH)
    check((cfg.n_heads, cfg.n_kv_heads, cfg.dh) == KIMI_HEADS,
          f"kimi-k2's heads {(cfg.n_heads, cfg.n_kv_heads, cfg.dh)}")
    n, gb = _param_footprint(cfg)
    more = _param_footprint(cfg.with_(n_layers=KIMI_LAYERS + 1))[1] - gb
    free, total = torch.cuda.mem_get_info()
    log(f"[kimi] memory reckoned before the draw: {KIMI_LAYERS} of "
        f"{get_config(KIMI_ARCH).n_layers} layers, {n / 1e9:.3f} B params, "
        f"{gb:.2f} GB in bf16 (a further MoE layer {more:.2f} GB); the card "
        f"has {free / 1e9:.2f} of {total / 1e9:.2f} GB free")
    check(gb < free / 1e9, f"kimi-k2 at {KIMI_LAYERS} layers needs {gb:.2f} "
          f"GB, {free / 1e9:.2f} GB free")
    params = _moe_init(cfg, "[kimi]")
    launches = {}
    launches["kimi_serve"], _ = _moe_paged(cfg, params, "[kimi] (a)")
    _moe_decode_vs_prefill(cfg, params, DECODE_VS_PREFILL_T,
                           MOE_DECODE_VS_PREFILL_TOL, "[kimi] (b)")
    del params
    _free_cuda()
    log(f"[kimi] phase 21 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 22: whisper-medium's encoder-decoder serving path at full width
# ---------------------------------------------------------------------------

def _whisper_greedy(cfg, params, frames, first):
    """WHISPER_TOKENS greedy ``make_serve_step`` steps from token
    ``first`` (B,) on ``init_encdec_decode_state`` (WHISPER_CONTEXT slots):
    the logits (B, steps, V) in fp32, the tokens fed (B, steps) and the
    state."""
    import torch
    from repro_torch.models import init_encdec_decode_state
    from repro_torch.runtime.executor import make_serve_step

    step = make_serve_step(cfg)
    state = init_encdec_decode_state(params, frames, cfg, WHISPER_CONTEXT)
    tok, fed, out = first, [], []
    for _ in range(WHISPER_TOKENS):
        fed.append(tok)
        logits, state = step(params, state, tok)
        out.append(logits.float())
        tok = logits.argmax(-1).to(torch.int32)
    return torch.stack(out, 1), torch.stack(fed, 1), state


def _whisper_vs_prefill(cfg, params, frames, first, tol, tag):
    """The greedy decode (:func:`_whisper_greedy`) against
    ``make_prefill_step`` teacher-forced on the tokens it was fed: each
    step's logits within ``tol`` of the prefill's largest logit at that
    position.  Returns the decode's logits, tokens and state."""
    import torch
    from repro_torch.runtime.executor import make_prefill_step

    logits, fed, state = _whisper_greedy(cfg, params, frames, first)
    full = make_prefill_step(cfg)(params, {"tokens": fed,
                                           "frames": frames}).float()
    check(bool(torch.isfinite(full).all() and torch.isfinite(logits).all()),
          f"{tag}: logits not finite")
    err = ((logits - full).abs().amax(-1) / full.abs().amax(-1)).cpu()
    worst = err.max().item()
    at = divmod(int(err.argmax()), err.shape[1])
    log(f"{tag} {cfg.name} at {cfg.n_enc_layers} + {cfg.n_layers} layers, "
        f"{str(cfg.dtype).replace('torch.', '')}, {tuple(fed.shape)} tokens "
        f"greedy: each step's logits against the teacher-forced prefill's, "
        f"max |diff| / max |logit| worst {worst:.3e} at (lane, step) {at}, "
        f"mean {err.mean().item():.3e} (tol {tol:.0e}); first lane's tokens "
        f"{fed[0, :8].tolist()}...")
    check(worst <= tol, f"{tag}: decode and prefill logits differ by "
          f"{worst} of the largest")
    return logits, fed, state


def phase_whisper():
    """Phase 22: whisper-medium at full width (24 + 24 layers), bf16,
    random weights from seed 0, WHISPER_LANES lanes of random frames:
    (a) a greedy decode of WHISPER_TOKENS steps through ``make_serve_step``
    on ``init_encdec_decode_state``, each step's logits against
    ``make_prefill_step`` teacher-forced on the same tokens; the flash
    forward the only attention (24 launches an encoder pass, 48 a decoder
    step: self plus cross), no plain version; the encoder's ms, the decode
    step's wall and busy ms, tok/s, peak memory and the cross-K/V bytes;
    (b) a second decode gives the same bits; (c) fp32 at
    WHISPER_FP32_LAYERS + WHISPER_FP32_LAYERS layers at REL_TOL.  Returns
    {path: launches}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import encode, init_encdec
    from repro_torch.runtime.executor import make_serve_step

    t_phase = time.perf_counter()
    _free_cuda()
    cfg = get_config(WHISPER_ARCH)
    E, L = cfg.n_enc_layers, cfg.n_layers
    check((cfg.n_heads, cfg.n_kv_heads, cfg.dh) == WHISPER_HEADS,
          f"whisper's heads {(cfg.n_heads, cfg.n_kv_heads, cfg.dh)}")
    t0 = time.perf_counter()
    params = init_encdec(cfg, max_dec_len=WHISPER_CONTEXT, seed=0,
                         device="cuda")
    torch.cuda.synchronize()
    log(f"[whisper] {cfg.name} at full width, {E} + {L} layers, bf16: "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B params, "
        f"{sum(p.nbytes for p in params.parameters()) / 1e9:.2f} GB, drawn "
        f"in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(11)
    frames = torch.randn(WHISPER_LANES, WHISPER_FRAMES, cfg.d_model,
                         generator=g, device="cuda")
    first = torch.randint(0, cfg.vocab_size, (WHISPER_LANES,), generator=g,
                          device="cuda", dtype=torch.int32)

    counts = _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with plain_calls() as plain:
        logits, fed, state = _whisper_vs_prefill(
            cfg, params, frames, first, DECODE_VS_PREFILL_TOL,
            "[whisper] (a)")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = counts()
    check(not plain, f"the enc-dec path called plain versions: {plain}")
    # the state's encoder pass, the decode steps, the prefill's encoder
    # and decoder
    want = E + WHISPER_TOKENS * 2 * L + E + 2 * L
    check(launches["flash_attention"] == want,
          f"{launches['flash_attention']} flash launches, not {want}")

    def flash_of(fn):
        before = flash_attention_cuda.launches
        fn()
        torch.cuda.synchronize()
        return flash_attention_cuda.launches - before

    step, tok = make_serve_step(cfg), fed[:, -1]

    def decode():       # the step at position WHISPER_TOKENS, repeatable
        return step(params, state, tok)[0]

    @torch.inference_mode()
    def encoder():      # as init_encdec_decode_state runs it
        return encode(params, frames, cfg)

    per = {"encoder": flash_of(encoder), "decode_step": flash_of(decode)}
    check(per == {"encoder": E, "decode_step": 2 * L},
          f"flash launches an encoder pass / a decode step: {per}")
    encode_ms = cuda_ms(encoder, iters=5, warmup=1)
    step_ms = cuda_ms(decode, iters=10)
    busy, kernels, cats = profile_step("whisper decode", decode, step_ms)
    logits2, fed2, _ = _whisper_greedy(cfg, params, frames, first)
    same = torch.equal(logits2, logits) and torch.equal(fed2, fed)
    log(f"[whisper] (b) a second decode: the same tokens and logits bits "
        f"{same}")
    check(same, "the enc-dec decode is not deterministic run to run")
    cross = sum(k.nbytes + v.nbytes for k, v in state["cross_kv"])
    cache = sum(c["k"].nbytes + c["v"].nbytes for c in state["self_cache"])
    result = {
        "lanes": WHISPER_LANES, "frames": WHISPER_FRAMES,
        "tokens": WHISPER_TOKENS, "context": WHISPER_CONTEXT,
        "encode_ms": encode_ms, "decode_step_ms": step_ms,
        "decode_busy_ms": busy, "decode_device_ms_by_category": cats,
        "kernels_per_step": kernels,
        "decode_tok_per_s": WHISPER_LANES * 1e3 / step_ms,
        "run_s": wall, "peak_mem_gb": peak_gb, "cross_kv_bytes": cross,
        "self_cache_bytes": cache,
        "flash_per_encoder": per["encoder"],
        "flash_per_decode_step": per["decode_step"]}
    log("[whisper] (a) " + json.dumps(result))
    del params, state, logits, logits2
    _free_cuda()
    cfg32 = cfg.with_(n_layers=WHISPER_FP32_LAYERS,
                      n_enc_layers=WHISPER_FP32_LAYERS, dtype=torch.float32)
    params = init_encdec(cfg32, max_dec_len=WHISPER_CONTEXT, seed=0,
                         device="cuda")
    _whisper_vs_prefill(cfg32, params, frames, first, REL_TOL["float32"],
                        "[whisper] (c)")
    del params
    _free_cuda()
    log(f"[whisper] phase 22 in {time.perf_counter() - t_phase:.1f} s")
    return {"whisper_serve": launches}


# ---------------------------------------------------------------------------
# phase 23: whisper-medium training at full width
# ---------------------------------------------------------------------------

def _whisper_train_cpu_vs_card():
    """(c): reduced fp32 whisper-medium through ``launch/train.py::train``
    on the CPU and on the card from the same weights (the CPU's draw, as
    phase 10), three steps: the losses within ``TRAIN_LOSS_RTOL``, and the
    card's steps launch the flash backward once an attention, a third of
    them at S != T."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.executor import init_train_state

    cfg = get_config(WHISPER_ARCH).reduced().with_(dtype=torch.float32)
    argv = ["--reduced", "--arch", WHISPER_ARCH, "--steps", "3", "--batch",
            str(WHISPER_CPU_BATCH), "--seq", str(WHISPER_CPU_SEQ),
            "--log-every", "1"]
    params_cpu, _ = init_train_state(cfg, seed=0, device="cpu")

    def same_weights(cfg, *, seed, opt_cfg, device):
        params = copy.deepcopy(params_cpu).to(device)
        return params, adamw_init(list(params.parameters()), opt_cfg)

    counts = _zero_counts()
    init, train_cli.init_train_state = (train_cli.init_train_state,
                                        same_weights)
    try:
        losses = {}
        for dev in ("cpu", "cuda"):
            before = counts()
            losses[dev] = [h["loss"] for h in train_cli.train(
                cfg, train_cli.parse_args(argv + ["--device", dev]))]
            n = {k: v - before[k] for k, v in counts().items()}
    finally:
        train_cli.init_train_state = init
    E, L = cfg.n_enc_layers, cfg.n_layers
    want = (3 * (E + 2 * L), 3 * L)
    got = (n["flash_attention_bwd"], n["flash_attention_bwd_cross"])
    check(got == want, f"(c) the card's steps launched the flash backward "
          f"{got} times (all, at S != T), not {want}")
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                    losses["cpu"]))
    log(f"[whisper-train] (c) reduced fp32 {WHISPER_ARCH} ({E} + {L} "
        f"layers, {cfg.encoder_seq} frames) through repro_torch.launch."
        f"train, 3 steps of {WHISPER_CPU_BATCH} x {WHISPER_CPU_SEQ}: card "
        f"{losses['cuda']} cpu {losses['cpu']}; max relative diff "
        f"{worst:.2e} (tol {TRAIN_LOSS_RTOL:.0e}); the card's flash "
        f"backward launches (all, at S != T) {got}")
    check(worst <= TRAIN_LOSS_RTOL, f"(c) whisper losses differ by {worst}")


def phase_whisper_train():
    """Phase 23: whisper-medium training at full width (24 encoder layers
    and WHISPER_TRAIN_DEC_LAYERS of 24 decoder layers, bf16, random weights
    from seed 0).  (a) ``train --arch whisper-medium --layers
    WHISPER_TRAIN_DEC_LAYERS --batch 8 --seq 448`` (``--layers`` sets the
    decoder's depth) for WHISPER_TRAIN_STEPS steps on the synthetic
    stream's frames (8, 1500, 1024), with the searched plan's remat and a
    checkpoint after step WHISPER_CKPT_AT: finite losses; each step the
    flash backward once an attention (24 encoder, 12 decoder, 12 cross:
    48, of them 12 at S != T, K14), the forward once (twice under remat),
    no RMSNorm and no plain version; the step's wall ms, decoder tokens/s,
    peak memory.  (d) a model and AdamW state drawn from seed 1, restored
    from that checkpoint, take step 3: its loss must be (a)'s, bit for
    bit; save and restore seconds and bytes printed, the files deleted;
    then two more steps timed and one profiled: the device's busy share of
    those steps' wall time and its ms by category.  Tokens/s are step 2's,
    the warm step with no checkpoint around it.  (b) step 1's loss and gradients, twice from ``init_encdec``
    seed 0 on (a)'s first batch: the same bits both times, and the loss
    (a)'s.  (c) :func:`_whisper_train_cpu_vs_card`.  Returns {path:
    launches}."""
    import torch
    from repro_torch.checkpointing import restore_train_state
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models import encdec_loss, init_encdec
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.executor import init_train_state, make_train_step

    t_phase = time.perf_counter()
    _free_cuda()
    cfg = get_config(WHISPER_ARCH).with_(n_layers=WHISPER_TRAIN_DEC_LAYERS)
    E, L = cfg.n_enc_layers, cfg.n_layers
    ck = ROOT / "build" / "whisper_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--arch", WHISPER_ARCH, "--layers", str(L),
            "--steps", str(WHISPER_TRAIN_STEPS),
            "--batch", str(WHISPER_LANES), "--seq", str(WHISPER_CONTEXT),
            "--log-every", "1", "--ckpt-dir", str(ck), "--ckpt-every",
            str(WHISPER_CKPT_AT)]
    log(f"[whisper-train] (a) python -m repro_torch.launch.train "
        f"{' '.join(argv)}")
    # check-only: time the save that launch/train.py makes
    real_save, save_s = train_cli.save_train_state, []

    def timed_save(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_save(*args, **kwargs)
        save_s.append(time.perf_counter() - t0)
        return out

    counts = _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    train_cli.save_train_state = timed_save
    try:
        with recorded_train_steps(counts) as seen, plain_calls() as plain:
            hist = train_cli.main(argv)
    finally:
        train_cli.save_train_state = real_save
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = counts()
    losses = [h["loss"] for h in hist]
    remat = seen["remat_segments"][0]
    on = bool(remat and remat[0])
    check(len(losses) == WHISPER_TRAIN_STEPS and all(
        math.isfinite(x) for x in losses), f"(a) losses {losses}")
    check(not plain, f"(a) plain versions ran on the training path: {plain}")
    per_step = {"flash_attention": (E + 2 * L) * (2 if on else 1),
                "flash_attention_bwd": E + 2 * L,
                "flash_attention_bwd_cross": L, "rmsnorm": 0,
                "rmsnorm_bwd": 0}
    for i, n in enumerate(seen["launches"], 1):
        check(all(n[k] == v for k, v in per_step.items()),
              f"(a) step {i} launched {n}, not {per_step}")
    saved = ck / f"step_{WHISPER_CKPT_AT:08d}"
    wrote = sorted(x.name for x in ck.iterdir()) if ck.exists() else []
    check(len(save_s) == 1 and saved.is_dir(),
          f"(a) train --ckpt-dir wrote {wrote}")
    n_bytes = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
    step_ms = seen["step_ms"]
    # step 2: warm, and no checkpoint before it (step 3 follows the save)
    warm_ms = step_ms[1]
    tokens = WHISPER_LANES * WHISPER_CONTEXT
    del hist
    _free_cuda()

    # (d) restore into a fresh draw and take step 3
    opt_cfg = AdamWConfig(lr=train_cli.parse_args(argv).lr)
    params, opt = init_train_state(cfg, seed=1, opt_cfg=opt_cfg,
                                   device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, step_no = restore_train_state(params, opt, ck)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(step_no == WHISPER_CKPT_AT and opt["step"] == WHISPER_CKPT_AT,
          f"(d) restored step {step_no}, AdamW step {opt['step']}")
    shutil.rmtree(ck, ignore_errors=True)
    gen = train_cli.batches(cfg, train_cli.parse_args(argv))
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                next(gen).items()} for _ in range(WHISPER_TRAIN_STEPS)]
    check(batches[0]["frames"].shape == (WHISPER_LANES, WHISPER_FRAMES,
                                         cfg.d_model),
          f"(a) frames {tuple(batches[0]['frames'].shape)}")
    step = make_train_step(cfg, opt_cfg, remat_segments=remat)
    with plain_calls() as plain_resumed:
        resumed = float(step(params, opt, batches[WHISPER_CKPT_AT])["loss"])
    torch.cuda.synchronize()
    check(not plain_resumed, f"(d) plain versions ran: {plain_resumed}")
    log(f"[whisper-train] (d) restored step {step_no} into a fresh draw "
        f"(seed 1) in {restore_s:.2f} s ({n_bytes / 1e9:.2f} GB saved in "
        f"{save_s[0]:.2f} s); step {WHISPER_CKPT_AT + 1}'s loss "
        f"{resumed!r} against the unbroken run's "
        f"{losses[WHISPER_CKPT_AT]!r}: bit for bit "
        f"{resumed == losses[WHISPER_CKPT_AT]}")
    check(resumed == losses[WHISPER_CKPT_AT], "(d) the resumed step's loss "
          "is not the unbroken run's")
    # the busy share's wall time: the profiled step itself, on the same
    # state, timed without the profiler and with no checkpoint near it
    wall_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt, batches[0])
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    busy, kernels, cats = profile_step(
        "whisper train", lambda: step(params, opt, batches[0]),
        sum(wall_ms) / len(wall_ms), n=1)
    del params, opt, step
    _free_cuda()

    # (b) step 1's loss and gradients twice from the same state
    params = init_encdec(cfg, seed=0, device="cuda")
    leaves = list(params.parameters())
    runs = []
    for _ in range(2):
        loss = encdec_loss(params, batches[0], cfg, remat=on)
        runs.append((loss.detach(), torch.autograd.grad(loss, leaves)))
        del loss
    same = torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    first = float(runs[0][0])
    log(f"[whisper-train] (b) step 1 from the same state twice: loss and "
        f"{len(leaves)} gradient leaves bitwise equal {same}; loss "
        f"{first!r}, (a)'s step 1 {losses[0]!r}")
    check(same, "(b) step 1's loss or gradients differ run to run")
    check(first == losses[0], "(b) step 1's loss is not (a)'s")
    del params, leaves, runs, batches
    _free_cuda()

    _whisper_train_cpu_vs_card()
    result = {
        "arch": WHISPER_ARCH, "layers": [E, L], "batch": WHISPER_LANES,
        "decoder_tokens": WHISPER_CONTEXT, "frames": WHISPER_FRAMES,
        "remat_segments": remat, "losses": losses, "step_ms": step_ms,
        "step_ms_warm": warm_ms,
        "decoder_tok_per_s": tokens * 1e3 / warm_ms,
        "encoder_frames_per_s": WHISPER_LANES * WHISPER_FRAMES * 1e3
        / warm_ms, "profiled_step_wall_ms": wall_ms,
        "device_busy_ms": busy,
        "device_busy_share": busy * len(wall_ms) / sum(wall_ms),
        "device_ms_by_category": cats, "kernels_per_step": kernels,
        "peak_mem_gb": peak_gb, "launches_per_step": seen["launches"][0],
        "checkpoint_bytes": n_bytes, "save_s": save_s[0],
        "restore_s": restore_s, "phase_s": time.perf_counter() - t_phase}
    log("[whisper-train] " + json.dumps(result))
    return {"whisper_train": launches}


# ---------------------------------------------------------------------------
# phase 24: sharded whisper-medium, 4 ranks on the card
# ---------------------------------------------------------------------------

WSHARD_DIR = ROOT / "build" / "whisper_shard"


def _wshard_cfg(dtype="bfloat16"):
    """Phase 24's model: whisper-medium at full width, WSHARD_LAYERS +
    WSHARD_LAYERS layers; in fp32 (d) the reduced model with the odd
    vocabulary WSHARD_FP32_VOCAB."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(WHISPER_ARCH)
    if dtype == "float32":
        return cfg.reduced(n_layers=WSHARD_FP32_LAYERS).with_(
            vocab_size=WSHARD_FP32_VOCAB, dtype=torch.float32)
    return cfg.with_(n_layers=WSHARD_LAYERS, n_enc_layers=WSHARD_LAYERS)


def _wshard_batches(cfg):
    """The train CLI's first WSHARD_STEPS batches of WHISPER_LANES x
    WHISPER_CONTEXT decoder tokens with their frames, CPU tensors."""
    import torch
    from repro_torch.launch import train as train_cli
    gen = train_cli.batches(cfg, train_cli.parse_args([
        "--arch", WHISPER_ARCH, "--batch", str(WHISPER_LANES), "--seq",
        str(WHISPER_CONTEXT)]))
    return [{k: torch.from_numpy(v) for k, v in next(gen).items()}
            for _ in range(WSHARD_STEPS)]


def _wshard_fp32_batch(cfg):
    """(d)'s batch: WSHARD_FP32_BATCH x WSHARD_FP32_SEQ tokens over the
    reduced model's frames, from a seed, CPU tensors."""
    import torch
    g = torch.Generator().manual_seed(24)
    B, S = WSHARD_FP32_BATCH, WSHARD_FP32_SEQ
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
            "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
            "frames": torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                  generator=g)}


def _wshard_launches(L, E, remat, calls=1):
    """Flash launches of ``calls`` losses and gradients on one rank: the
    forward once an attention (twice under remat), the backward once, the
    decoder's cross-attention's at S != T (K14)."""
    n = E + 2 * L
    return {"flash_attention": n * (2 if remat else 1) * calls,
            "flash_attention_bwd": n * calls,
            "flash_attention_bwd_cross": L * calls, "rmsnorm": 0,
            "rmsnorm_bwd": 0}


@contextlib.contextmanager
def bwd_shapes():
    """Check-only: record (B, S, T, H, dh) of every flash backward launch
    through the training path's autograd function while the block runs."""
    from repro_torch.kernels import flash_attention as fa

    seen = []
    real = fa.flash_attention_bwd_cuda

    def recording(q, k, v, *args, **kw):
        seen.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                     q.shape[3]))
        return real(q, k, v, *args, **kw)

    fa.flash_attention_bwd_cuda = recording
    try:
        yield seen
    finally:
        fa.flash_attention_bwd_cuda = real


def _wshard_greedy(step, params, state, first, n):
    """``n`` greedy steps of ``step`` from token ``first``: the logits (B,
    n, V) fp32, the tokens fed (B, n), each step's wall ms and gloo bytes
    sent."""
    import torch
    tok, fed, out, ms, sent = first, [], [], [], []
    for _ in range(n):
        fed.append(tok)
        before = _ss_traffic(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = step(params, state, tok)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        sent.append(_ss_traffic(step) - before)
        out.append(logits.float())
        tok = logits.argmax(-1).to(torch.int32)
    return torch.stack(out, 1), torch.stack(fed, 1), ms, sent


def wshard_reference(run_dir):
    """The single process, in this process on the card: (a)'s loss and
    gradients on ``init_encdec`` seed 0 and the first batch, and
    WSHARD_STEPS AdamW steps; (c)'s first decode step on the serving
    frames; (d)'s fp32 loss and greedy decode.  Saved for the ranks."""
    import torch
    from repro_torch.models import (encdec_loss, init_encdec,
                                    init_encdec_decode_state)
    from repro_torch.optim import AdamWConfig, adamw_init, global_norm
    from repro_torch.runtime.executor import make_serve_step, make_train_step

    cfg = _wshard_cfg()
    batches = [{k: v.to("cuda") for k, v in b.items()}
               for b in _wshard_batches(cfg)]
    params = init_encdec(cfg, seed=0, device="cuda")
    leaves = list(params.parameters())
    counts = _zero_counts()
    with plain_calls() as plain:
        loss = encdec_loss(params, batches[0], cfg)
        grads = torch.autograd.grad(loss, leaves)
    launches = counts()
    saved = {"loss": loss.item(), "grad_norm": global_norm(grads).item(),
             "grads": {n: g.cpu() for (n, _), g in
                       zip(params.named_parameters(), grads)},
             "params": sum(p.numel() for p in leaves), "plain": plain,
             "launches": launches}
    del loss, grads
    # the same weights' gradients in fp32: how far bf16 rounding alone
    # moves each leaf
    params32 = copy.deepcopy(params).float()
    loss = encdec_loss(params32, batches[0], cfg.with_(dtype=torch.float32))
    saved["loss32"] = loss.item()
    saved["grads32"] = {n: g.cpu() for (n, _), g in zip(
        params32.named_parameters(),
        torch.autograd.grad(loss, list(params32.parameters())))}
    saved["single_vs_fp32"] = {n: _leaf_err(g, saved["grads32"][n])
                               for n, g in saved["grads"].items()}
    del loss, params32
    ocfg = AdamWConfig(lr=WSHARD_LR)
    opt = adamw_init(leaves, ocfg)
    step = make_train_step(cfg, ocfg)
    saved["losses"] = [float(step(params, opt, b)["loss"]) for b in batches]
    del params, opt, step, batches
    _free_cuda()
    # (c): the serving frames and first tokens, and the first decode step
    g = torch.Generator(device="cuda").manual_seed(11)
    frames = torch.randn(WHISPER_LANES, WHISPER_FRAMES, cfg.d_model,
                         generator=g, device="cuda")
    first = torch.randint(0, cfg.vocab_size, (WHISPER_LANES,), generator=g,
                          device="cuda", dtype=torch.int32)
    params = init_encdec(cfg, seed=0, device="cuda")
    state = init_encdec_decode_state(params, frames, cfg, WHISPER_CONTEXT)
    saved["first_logits"] = make_serve_step(cfg)(
        params, state, first)[0].float().cpu()
    torch.save({"frames": frames.cpu(), "first": first.cpu()},
               f"{run_dir}/serve_inputs.pt")
    del params, state
    _free_cuda()
    # (d): reduced fp32 with an odd vocabulary
    cfg32 = _wshard_cfg("float32")
    b32 = {k: v.to("cuda") for k, v in _wshard_fp32_batch(cfg32).items()}
    params = init_encdec(cfg32, seed=0, device="cuda")
    saved["fp32_loss"] = encdec_loss(params, b32, cfg32).item()
    state = init_encdec_decode_state(params, b32["frames"], cfg32,
                                     WSHARD_FP32_SEQ)
    logits, fed, _, _ = _wshard_greedy(make_serve_step(cfg32), params,
                                       state, b32["tokens"][:, 0],
                                       WSHARD_FP32_STEPS)
    saved["fp32_logits"], saved["fp32_tokens"] = logits.cpu(), fed.cpu()
    del params, state
    _free_cuda()
    torch.save(saved, f"{run_dir}/reference.pt")
    return saved


def _wshard_train(rank, cfg, mesh, pol, ocfg, batches, ref, run_dir,
                  ckpt):
    """(a) on one mesh: the drawn shards, one sharded loss and gradients
    (each leaf gathered and, on rank 0, held against the reference's), then
    WSHARD_STEPS sharded AdamW steps; with ``ckpt`` (b): a sharded save
    after step 1, a fresh draw (seed 1) restored from it takes step 2."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpointing import (restore_sharded_train_state,
                                           save_sharded_train_state)
    from repro_torch.runtime import init_train_state, make_train_step

    t0 = time.perf_counter()
    params, opt = init_train_state(cfg, mesh=mesh, policy=pol, seed=0,
                                   opt_cfg=ocfg, device="cuda")
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "params_local": sum(p.numel() for p in params.parameters())}
    with bwd_shapes() as shapes:
        _, grads, row, ctx = _sharded_call(cfg, mesh, pol, params,
                                           batches[0])
    row["bwd_shapes"] = sorted({tuple(s) for s in shapes})
    errs, errs32 = {}, {}
    for (n, _), g in zip(params.named_parameters(), grads):
        full = ctx.gather_tensor(n, g)
        if rank == 0:
            errs[n] = _leaf_err(full, ref["grads"][n])
            errs32[n] = (_leaf_err(full, ref["grads32"][n]),
                         ref["single_vs_fp32"][n])
        del full
    if rank == 0:
        worst = max(errs, key=errs.get)
        row.update(n_leaves=len(errs), worst_leaf=worst,
                   worst_err=errs[worst], embed_err=errs["embed"],
                   ref_loss32=ref["loss32"],
                   top=[(n, errs[n], *errs32[n]) for n in sorted(
                       errs, key=errs.get, reverse=True)[:8]],
                   worst_vs_fp32=max(e for e, _ in errs32.values()),
                   single_vs_fp32=max(e for _, e in errs32.values()))
    row["split_vocab"] = ctx.split_vocab
    out["call"] = row
    del grads
    # the same shards in fp32 (the single process's weights, exactly):
    # the gate on every leaf
    cfg32 = cfg.with_(dtype=torch.float32)
    p32 = copy.deepcopy(params).float()
    loss32, grads, row32, ctx = _sharded_call(cfg32, mesh, pol, p32,
                                              batches[0])
    errs = {}
    for (n, _), g in zip(p32.named_parameters(), grads):
        full = ctx.gather_tensor(n, g)
        if rank == 0:
            errs[n] = _leaf_err(full, ref["grads32"][n])
        del full
    if rank == 0:
        worst = max(errs, key=errs.get)
        row32.update(n_leaves=len(errs), worst_leaf=worst,
                     worst_err=errs[worst])
    out["call32"] = row32
    out["parts"] = [row["launches"], row32["launches"]]
    del grads, p32, loss32
    step = make_train_step(cfg, ocfg, mesh=mesh, policy=pol)
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    counts = _zero_counts()
    hist = []
    with plain_calls() as plain:
        for i, b in enumerate(batches, 1):
            sent = step.shard.traffic.bytes_sent
            t0 = time.perf_counter()
            m = step(params, opt, b)
            torch.cuda.synchronize()
            hist.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "ms": (time.perf_counter() - t0) * 1e3,
                         "gloo_bytes": step.shard.traffic.bytes_sent
                         - sent})
            if ckpt and i == 1:
                t0 = time.perf_counter()
                save_sharded_train_state(1, params, opt, step.shard, ckpt)
                out["save_s"] = time.perf_counter() - t0
    out.update(steps=hist, launches=counts(), plain=plain,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    out["parts"].append(out["launches"])
    del params, opt
    if ckpt:
        _free_cuda()
        params, opt = init_train_state(cfg, mesh=mesh, policy=pol, seed=1,
                                       opt_cfg=ocfg, device="cuda")
        t0 = time.perf_counter()
        _, _, at = restore_sharded_train_state(params, opt, step.shard, ckpt)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        counts = _zero_counts()
        resumed = float(step(params, opt, batches[1])["loss"])
        out["resume"] = {"step": at, "loss": resumed,
                         "launches": counts()}
        out["parts"].append(out["resume"]["launches"])
        del params, opt
    _free_cuda()
    return out


def _wshard_serve(rank, cfg, mesh, pol, inputs, ref):
    """(c) under one policy: ``init_encdec_decode_state`` on every lane's
    frames, WSHARD_TOKENS greedy ``make_serve_step`` steps on a
    WHISPER_CONTEXT-slot cache, then ``make_prefill_step`` teacher-forced
    on the tokens fed (the rank's lanes)."""
    import torch
    from repro_torch.runtime import (init_serving_params, make_prefill_step,
                                     make_serve_step)
    from repro_torch.models import init_encdec_decode_state

    params = init_serving_params(cfg, mesh=mesh, policy=pol, seed=0,
                                 device="cuda")
    step = make_serve_step(cfg, mesh=mesh, policy=pol)
    prefill = make_prefill_step(cfg, mesh=mesh, policy=pol)
    frames = inputs["frames"].to("cuda")
    first = inputs["first"].to("cuda")
    counts = _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with plain_calls() as plain:
        state = init_encdec_decode_state(params, frames, cfg,
                                         WHISPER_CONTEXT, shard=step.shard)
        torch.cuda.synchronize()
        state_ms = (time.perf_counter() - t0) * 1e3
        n_state = counts()["flash_attention"]
        logits, fed, ms, sent = _wshard_greedy(step, params, state, first,
                                               WSHARD_TOKENS)
        n_decode = counts()["flash_attention"] - n_state
        lo, hi = prefill.shard.lane_range(WHISPER_LANES)
        full = prefill(params, {"tokens": fed, "frames": frames}).float()
        torch.cuda.synchronize()
    launches = counts()
    mine = logits[lo:hi]
    err = (mine - full).abs().amax(-1) / full.abs().amax(-1)
    want = ref["first_logits"].to("cuda")
    first_err = ((logits[:, 0] - want).abs().max()
                 / want.abs().max()).item()
    lay = state["layout"]
    row = {"state_ms": state_ms, "step_ms": ms, "gloo_bytes": sent,
           "launches": launches, "plain": plain, "flash_state": n_state,
           "flash_decode": n_decode, "lanes": [lo, hi], "kv": lay.kv,
           "cross_kv_bytes": sum(k.nbytes + v.nbytes
                                 for k, v in state["cross_kv"]),
           "self_cache_bytes": sum(c["k"].nbytes + c["v"].nbytes
                                   for c in state["self_cache"]),
           "cross_kv_shape": list(state["cross_kv"][0][0].shape),
           "vs_prefill": err.max().item(), "first_vs_single": first_err,
           "logits_digest": _ss_digest(logits), "tokens": fed.tolist(),
           "finite": bool(torch.isfinite(logits).all()
                          and torch.isfinite(full).all()),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, state, logits, full
    _free_cuda()
    return row


def _wshard_fp32(cfg, mesh, ref):
    """(d): the reduced fp32 model's sharded loss on (data 2, model 2)
    with TP and ZeRO, and its greedy decode with TP, against the single
    process on the card."""
    import torch
    from repro_torch.models import init_encdec_decode_state
    from repro_torch.runtime import (ShardPolicy, init_serving_params,
                                     init_train_state, make_serve_step)

    pol = ShardPolicy(tp=True, zero=True, remat_segments=(True,))
    b = _wshard_fp32_batch(cfg)
    params, _ = init_train_state(cfg, mesh=mesh, policy=pol, seed=0,
                                 device="cuda")
    row = _sharded_call(cfg, mesh, pol, params, b)[2]
    del params
    pol = ShardPolicy(tp=True, zero=False)
    params = init_serving_params(cfg, mesh=mesh, policy=pol, seed=0,
                                 device="cuda")
    step = make_serve_step(cfg, mesh=mesh, policy=pol)
    frames = b["frames"].to("cuda")
    counts = _zero_counts()
    state = init_encdec_decode_state(params, frames, cfg, WSHARD_FP32_SEQ,
                                     shard=step.shard)
    logits, fed, _, _ = _wshard_greedy(step, params, state,
                                       b["tokens"][:, 0].to("cuda"),
                                       WSHARD_FP32_STEPS)
    want = ref["fp32_logits"].to("cuda")
    loss = row["loss"]
    out = {"loss": loss, "loss_rel": abs(loss - ref["fp32_loss"])
           / abs(ref["fp32_loss"]), "parts": [row["launches"], counts()],
           "logits_err": ((logits - want).abs().max()
                          / want.abs().max()).item(),
           "same_tokens": bool(torch.equal(fed.cpu(),
                                           ref["fp32_tokens"]))}
    del params, state
    _free_cuda()
    return out


def wshard_rank(rank, world, run_dir):
    """One of WSHARD_RANKS gloo ranks on the card: (a) and (b) on
    WSHARD_TP_MESH with TP, ZeRO, remat and ``seq_shard``, (a) on
    WSHARD_ZERO_MESH with ZeRO; (c) on WSHARD_TP_MESH without and with TP;
    (d).  The kernels' launches are counted from 0 before each part and
    read after it, and summed.  Saves its results."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import ShardPolicy

    torch.cuda.set_device(0)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{run_dir}/rendezvous",
                     timeout_s=WSHARD_TIMEOUT_S)
    try:
        cfg = _wshard_cfg()
        tp_mesh = make_local_mesh(WSHARD_TP_MESH[1])
        zero_mesh = make_local_mesh(WSHARD_ZERO_MESH[1])
        ref = torch.load(f"{run_dir}/reference.pt", mmap=True)
        batches = _wshard_batches(cfg)
        ocfg = AdamWConfig(lr=WSHARD_LR)
        out = {"coord": [tp_mesh.get_local_rank("data"),
                         tp_mesh.get_local_rank("model")]}
        out["tp"] = _wshard_train(
            rank, cfg, tp_mesh, ShardPolicy(tp=True, zero=True,
                                            remat_segments=(True,),
                                            seq_shard=True),
            ocfg, batches, ref, run_dir, f"{run_dir}/ckpt")
        out["zero"] = _wshard_train(
            rank, cfg, zero_mesh, ShardPolicy(tp=False, zero=True), ocfg,
            batches, ref, run_dir, None)
        inputs = torch.load(f"{run_dir}/serve_inputs.pt")
        for tag, pk in (("serve_rep", dict(tp=False, zero=False)),
                        ("serve_tp", dict(tp=True, zero=False))):
            out[tag] = _wshard_serve(rank, cfg, tp_mesh, ShardPolicy(**pk),
                                     inputs, ref)
            out[tag]["same_on_ranks"] = _ss_same_on_ranks(
                (out[tag]["logits_digest"], out[tag]["tokens"]))
        out["fp32"] = _wshard_fp32(_wshard_cfg("float32"), tp_mesh, ref)
        parts = (out["tp"]["parts"] + out["zero"]["parts"]
                 + [out["serve_rep"]["launches"],
                    out["serve_tp"]["launches"]] + out["fp32"]["parts"])
        out["launches"] = {k: sum(p[k] for p in parts) for k in parts[0]}
        pathlib.Path(f"{run_dir}/rank{rank}.json").write_text(
            json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _wshard_check_train(tag, res, ref, remat, fails):
    """(a)'s checks on one mesh's rows of every rank; its numeric gates'
    failures are added to ``fails``."""
    cfg = _wshard_cfg()
    E, L = cfg.n_enc_layers, cfg.n_layers
    rows = [r[tag] for r in res]
    call = [r["call"] for r in rows]
    loss = call[0]["loss"]
    check(all(c["loss"] == loss for c in call), f"({tag}) ranks disagree "
          "on the loss")
    check(not any(c["plain"] for c in call) and not any(
        r["plain"] for r in rows), f"({tag}) plain versions ran")
    want = _wshard_launches(L, E, remat)
    for r, c in enumerate(call + [r["call32"] for r in rows]):
        check(all(c["launches"][k] == v for k, v in want.items()),
              f"({tag}) rank {r % len(call)}: launches {c['launches']}, "
              f"not {want}")
    check(not any(c["split_vocab"] for c in call), f"({tag}) the "
          f"vocabulary of {cfg.vocab_size} split over model")
    rel = abs(loss - ref["loss"]) / abs(ref["loss"])
    worst, single = call[0]["worst_vs_fp32"], call[0]["single_vs_fp32"]
    if worst > WSHARD_BF16_VS_FP32 * single:
        fails.append(f"({tag}) the bf16 gradient leaves lie up to "
                     f"{worst:.3e} from fp32, above {WSHARD_BF16_VS_FP32} "
                     f"times the single process's {single:.3e}")
    c32 = rows[0]["call32"]
    check(call[0]["n_leaves"] == c32["n_leaves"] == len(ref["grads"]),
          f"({tag}) {call[0]['n_leaves']} leaves")
    if rel > WSHARD_LOSS_RTOL:
        fails.append(f"({tag}) loss {loss} against the single process's "
                     f"{ref['loss']} (rel {rel:.3e})")
    rel32 = abs(c32["loss"] - ref["loss32"]) / abs(ref["loss32"])
    if (rel32 > WSHARD_FP32_LOSS_RTOL
            or c32["worst_err"] > WSHARD_FP32_GRAD_TOL):
        fails.append(f"({tag}) fp32: loss rel {rel32:.3e}, gradient "
                     f"{c32['worst_leaf']} off by {c32['worst_err']:.3e}")
    steps = [[h["loss"] for h in r["steps"]] for r in rows]
    check(all(s == steps[0] for s in steps) and all(
        math.isfinite(x) for x in steps[0]), f"({tag}) step losses {steps}")
    want_steps = _wshard_launches(L, E, remat, WSHARD_STEPS)
    for r, row in enumerate(rows):
        check(all(row["launches"][k] == v for k, v in want_steps.items()),
              f"({tag}) steps rank {r}: launches {row['launches']}, not "
              f"{want_steps}")
    return rel, steps[0]


def _wshard_check_serve(tag, res, ref, fails):
    """(c)'s checks under one policy; its numeric gates' failures are
    added to ``fails``."""
    cfg = _wshard_cfg()
    E, L = cfg.n_enc_layers, cfg.n_layers
    rows = [r[tag] for r in res]
    check(all(r["same_on_ranks"] for r in rows), f"({tag}) the ranks' "
          "logits or tokens differ")
    check(all(r["finite"] for r in rows) and not any(
        r["plain"] for r in rows), f"({tag}) not finite, or plain versions "
          "ran")
    for r, row in enumerate(rows):
        got = (row["flash_state"], row["flash_decode"],
               row["launches"]["flash_attention"])
        want = (E, 2 * L * WSHARD_TOKENS, E + 2 * L * WSHARD_TOKENS + E
                + 2 * L)
        check(got == want, f"({tag}) rank {r}: flash launches (state, "
              f"decode, all) {got}, not {want}")
    first = max(r["first_vs_single"] for r in rows)
    if first > WSHARD_LOGIT_TOL:
        fails.append(f"({tag}) the first decode step's logits lie "
                     f"{first:.3e} from the single process's")
    vs = max(r["vs_prefill"] for r in rows)
    if vs > DECODE_VS_PREFILL_TOL:
        fails.append(f"({tag}) decode against the teacher-forced prefill: "
                     f"{vs:.3e}")
    return first, vs


def phase_whisper_shard():
    """Phase 24: whisper-medium at full width, WSHARD_LAYERS +
    WSHARD_LAYERS layers, bf16, on WSHARD_RANKS gloo ranks sharing the
    card, against the single process (this process, on the card).  (a)
    training on (data 2, model 2) with TP, ZeRO, remat and ``seq_shard``,
    and on (4, 1) with ZeRO: one sharded loss and gradients against the
    single process's (phase 16's gates), WSHARD_STEPS AdamW steps; the
    flash forward and backward launches, K14's apart at the TP-local
    shape; (b) a sharded checkpoint after step 1, restored into a fresh
    draw, repeats step 2 bit for bit; (c) serving on (2, 2) without and
    with TP: ``init_encdec_decode_state`` of 8 lanes of 1500 frames,
    WSHARD_TOKENS greedy steps on a 448-slot cache, the first step
    against the single process's, decode against the sharded teacher-forced
    prefill; (d) reduced fp32 with an odd vocabulary: the sharded loss and
    decode against the single process's.  Returns {path: launches}."""
    import torch

    t_phase = time.perf_counter()
    _free_cuda()
    shutil.rmtree(WSHARD_DIR, ignore_errors=True)
    WSHARD_DIR.mkdir(parents=True)
    cfg = _wshard_cfg()
    E, L = cfg.n_enc_layers, cfg.n_layers
    log(f"[whisper-shard] {cfg.name} at full width, {E} + {L} of 24 + 24 "
        f"layers, bf16, {WHISPER_LANES} x {WHISPER_CONTEXT} tokens over "
        f"{WHISPER_LANES} x {WHISPER_FRAMES} frames, {WSHARD_RANKS} gloo "
        "ranks on one card")
    t0 = time.perf_counter()
    ref = wshard_reference(str(WSHARD_DIR))
    check(not ref["plain"], f"plain versions ran in the reference: "
          f"{ref['plain']}")
    want = _wshard_launches(L, E, False)
    check(all(ref["launches"][k] == v for k, v in want.items()),
          f"the reference's launches {ref['launches']}, not {want}")
    log(f"[whisper-shard] single process: loss {ref['loss']!r}, grad norm "
        f"{ref['grad_norm']:.6f}, {ref['params'] / 1e6:.1f} M params; "
        f"{WSHARD_STEPS} steps at lr {WSHARD_LR}: {ref['losses']}; "
        f"{time.perf_counter() - t0:.1f} s")
    ranks_s = spawn_ranks(wshard_rank, (WSHARD_RANKS, str(WSHARD_DIR)),
                          WSHARD_RANKS, "sharded whisper ranks",
                          timeout_s=WSHARD_TIMEOUT_S)
    res = [json.loads((WSHARD_DIR / f"rank{r}.json").read_text())
           for r in range(WSHARD_RANKS)]
    check([r["coord"] for r in res] == [[0, 0], [0, 1], [1, 0], [1, 1]],
          f"mesh coordinates {[r['coord'] for r in res]}")
    local = (WHISPER_LANES // WSHARD_TP_MESH[0], WHISPER_CONTEXT,
             WHISPER_FRAMES, WHISPER_HEADS[0] // WSHARD_TP_MESH[1],
             WHISPER_HEADS[2])
    fails = []      # the numeric gates', reported together at the end
    for tag, remat in (("tp", True), ("zero", False)):
        rel, losses = _wshard_check_train(tag, res, ref, remat, fails)
        call0 = res[0][tag]["call"]
        flash = {k: v for k, v in call0["launches"].items()
                 if k.startswith("flash_attention")}
        log(f"[whisper-shard] (a) {tag}: loss {call0['loss']!r} (single "
            f"process {ref['loss']!r}, rel {rel:.3e}); worst gradient leaf "
            f"{call0['worst_leaf']} at {call0['worst_err']:.3e} of its "
            f"largest magnitude, embed {call0['embed_err']:.3e}; grad norm "
            f"{call0['grad_norm']:.6f} (single process "
            f"{ref['grad_norm']:.6f}); {WSHARD_STEPS} steps: {losses} "
            f"(single process {ref['losses']}); flash launches a call "
            f"{flash}; backward shapes (B, S, T, H, dh) "
            f"{call0['bwd_shapes']}")
        log(f"[whisper-shard] (a) {tag}: the bf16 leaves farthest from the "
            "single process (leaf, from it, from its fp32 gradients, the "
            f"single process's own bf16 from fp32): {call0['top']}; over "
            f"every leaf the ranks lie at most {call0['worst_vs_fp32']:.3e} "
            "from fp32, the single process "
            f"{call0['single_vs_fp32']:.3e} (gate: "
            f"{WSHARD_BF16_VS_FP32} times the single process's)")
        c32 = res[0][tag]["call32"]
        call_ms = [round(r[tag]["call32"]["ms"], 1) for r in res]
        log(f"[whisper-shard] (a) {tag} in fp32 (the same weights): loss "
            f"{c32['loss']!r} (single process {ref['loss32']!r}); worst "
            f"gradient leaf {c32['worst_leaf']} at {c32['worst_err']:.3e} "
            f"of its largest magnitude (tol {WSHARD_FP32_GRAD_TOL:.0e}); "
            f"call ms by rank {call_ms}")
        for r, row in enumerate(res):
            t = row[tag]
            log(f"[whisper-shard] (a) {tag} rank {r} (data "
                f"{row['coord'][0]}, model {row['coord'][1]}): "
                f"{t['params_local'] / 1e6:.1f} M params, init "
                f"{t['init_s']:.1f} s; call {t['call']['ms']:.1f} ms, "
                f"{t['call']['gloo_bytes']} gloo bytes; step ms "
                f"{[round(h['ms'], 1) for h in t['steps']]}, gloo bytes "
                f"sent a step {[h['gloo_bytes'] for h in t['steps']]}; "
                f"peak {t['peak_gb']:.2f} GB")
    cross = [tuple(s) for s in res[0]["tp"]["call"]["bwd_shapes"]
             if s[1] != s[2]]
    check(cross == [local], f"(a) K14 ran at {cross}, not the TP-local "
          f"shape {local}")
    tp = [r["tp"] for r in res]
    resumed = [t["resume"] for t in tp]
    check(all(x["step"] == 1 for x in resumed), "(b) restored step "
          f"{[x['step'] for x in resumed]}")
    same = all(x["loss"] == t["steps"][1]["loss"]
               for x, t in zip(resumed, tp))
    log(f"[whisper-shard] (b) sharded checkpoint after step 1: "
        f"{_dir_bytes(WSHARD_DIR / 'ckpt') / 1e9:.2f} GB saved in "
        f"{max(t['save_s'] for t in tp):.2f} s, restored into a fresh draw "
        f"(seed 1) in {max(t['restore_s'] for t in tp):.2f} s; step 2's "
        f"loss {resumed[0]['loss']!r} against the unbroken "
        f"{tp[0]['steps'][1]['loss']!r}: bit for bit {same}")
    check(same, "(b) the resumed step 2 is not the unbroken run's")
    for tag in ("serve_rep", "serve_tp"):
        first, vs = _wshard_check_serve(tag, res, ref, fails)
        row0 = res[0][tag]
        log(f"[whisper-shard] (c) {tag}: the first decode step against the "
            f"single process {first:.3e} of its largest logit (tol "
            f"{WSHARD_LOGIT_TOL:.0e}); decode against the sharded prefill "
            f"{vs:.3e} (tol {DECODE_VS_PREFILL_TOL:.0e}); caches split "
            f"{row0['kv']!r}; the same logits and tokens on every rank")
        for r, row in enumerate(res):
            s = row[tag]
            log(f"[whisper-shard] (c) {tag} rank {r}: lanes {s['lanes']}, "
                f"state {s['state_ms']:.1f} ms, step ms wall "
                f"{[round(x, 1) for x in s['step_ms'][1:]]} (mean "
                f"{sum(s['step_ms'][1:]) / (len(s['step_ms']) - 1):.1f}), "
                f"gloo bytes a step {s['gloo_bytes'][1]}; cross K/V "
                f"{s['cross_kv_bytes'] / 1e6:.1f} MB {s['cross_kv_shape']}, "
                f"self caches {s['self_cache_bytes'] / 1e6:.1f} MB; peak "
                f"{s['peak_gb']:.2f} GB")
    fp = [r["fp32"] for r in res]
    loss_rel = max(x["loss_rel"] for x in fp)
    err = max(x["logits_err"] for x in fp)
    log(f"[whisper-shard] (d) reduced fp32 ({WSHARD_FP32_LAYERS} + "
        f"{WSHARD_FP32_LAYERS} layers, vocab {WSHARD_FP32_VOCAB}): sharded "
        f"loss rel {loss_rel:.3e} (tol {WSHARD_FP32_LOSS_RTOL:.0e}), decode "
        f"logits {err:.3e} (tol {WSHARD_FP32_LOGIT_TOL:.0e}), the same "
        f"tokens {all(x['same_tokens'] for x in fp)}")
    if not (loss_rel <= WSHARD_FP32_LOSS_RTOL
            and err <= WSHARD_FP32_LOGIT_TOL
            and all(x["same_tokens"] for x in fp)):
        fails.append("(d) the reduced fp32 model's sharded loss or decode "
                     "is off")
    launches = {k: sum(r["launches"][k] for r in res)
                for k in res[0]["launches"]}
    log(f"[whisper-shard] launches over the ranks: {launches}; ranks "
        f"{ranks_s:.1f} s (4 ranks share one card: not a sharded run's "
        f"speed); phase 24 in {time.perf_counter() - t_phase:.1f} s")
    ref_launches = dict(ref["launches"])
    del ref
    shutil.rmtree(WSHARD_DIR, ignore_errors=True)
    check(not fails, "phase 24: " + "; ".join(fails))
    return {"whisper_shard_reference": ref_launches,
            "whisper_shard": launches}


# ---------------------------------------------------------------------------
# phase 25: internvl2-26b, the vision-language model, at full width
# ---------------------------------------------------------------------------

VLM_DIR = ROOT / "build" / "vlm_shard"


def _arch_cfg(arch, layers=None, dtype="bfloat16"):
    """``arch`` at full width, ``layers`` of its depth (all by default)."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch).with_(dtype=getattr(torch, dtype))
    return cfg if layers is None else cfg.with_(n_layers=layers)


def _dense_launches(L, remat, calls=1):
    """Launches of ``calls`` losses and gradients of L dense layers without
    QK-norm (internvl2-26b, qwen2.5-14b) on one process or rank: the flash
    forward once a layer (twice under remat) and its backward once;
    RMSNorm's forward on ln1 and ln2 of each layer (again under remat) and
    on the final norm, its backward once each."""
    k = 2 if remat else 1
    return {"flash_attention": L * k * calls,
            "flash_attention_bwd": L * calls,
            "flash_attention_bwd_cross": 0,
            "rmsnorm": (2 * L * k + 1) * calls,
            "rmsnorm_bwd": (2 * L + 1) * calls}


def _vlm_serve(cfg, params):
    """(a) at full depth: phase 3's requests through the paged engine twice
    (:func:`_moe_paged`: the decode step beside its bound, every weight
    read once); ``make_prefill_step`` on VLM_PREFILL_LANES lanes of 256
    random patches and VLM_PREFILL_TOKENS tokens, its logits (8, 128,
    92553), finite, the same bits on a second call, and not those of the
    same tokens without patches; the dense-cache decode against the
    prefill over VLM_DECODE_VS_PREFILL_T tokens at phase 11's gate.
    Returns the launches of the engine's run and the prefill calls."""
    import torch
    from repro_torch.runtime.executor import make_prefill_step

    launches, _ = _moe_paged(cfg, params, "[vlm] (a)")
    g = torch.Generator(device="cuda").manual_seed(25)
    B, T = VLM_PREFILL_LANES, VLM_PREFILL_TOKENS
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                         device="cuda", dtype=torch.int32)
    patches = torch.randn(B, VLM_VISION, cfg.d_vision, generator=g,
                          device="cuda")
    prefill = make_prefill_step(cfg)
    batch = {"tokens": toks, "patches": patches}
    prefill(params, batch)          # warm-up
    torch.cuda.synchronize()
    counts = _zero_counts()
    with plain_calls() as plain:
        t0 = time.perf_counter()
        first = prefill(params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        second = prefill(params, batch)
        text = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
    n = counts()
    check(not plain, f"[vlm] (a) plain versions ran in the prefill: {plain}")
    check(tuple(first.shape) == (B, T, cfg.vocab_size)
          and bool(torch.isfinite(first).all()),
          f"[vlm] (a) prefill logits {tuple(first.shape)}, or not finite")
    same = torch.equal(first, second)
    moved = ((first.float() - text.float()).abs().max()
             / text.float().abs().max()).item()
    want = {"flash_attention": 3 * cfg.n_layers,
            "rmsnorm": 3 * (2 * cfg.n_layers + 1)}
    log(f"[vlm] (a) make_prefill_step of {B} lanes x ({VLM_VISION} patches "
        f"+ {T} tokens): logits {tuple(first.shape)}, {ms:.1f} ms wall; a "
        f"second call the same bits {same}; against the same tokens "
        f"without patches max |diff| / max |logit| {moved:.3e}; launches "
        f"of the three calls {n} (flash and RMSNorm {want})")
    check(same, "[vlm] (a) the prefill with patches gave other bits on a "
          "second call")
    check(moved > DECODE_VS_PREFILL_TOL, "[vlm] (a) the patches do not "
          "move the prefill's logits: the projector is not wired in")
    check(all(n[k] == v for k, v in want.items()),
          f"[vlm] (a) the prefill calls launched {n}, not {want}")
    del first, second, text
    _decode_vs_prefill(cfg, params, VLM_DECODE_VS_PREFILL_T,
                       DECODE_VS_PREFILL_TOL, "[vlm] (a)")
    return {k: launches.get(k, 0) + n[k] for k in n}


def _vlm_train():
    """(b) ``train --arch internvl2-26b --layers VLM_TRAIN_LAYERS --batch 1
    --seq VLM_TRAIN_SEQ`` for VLM_TRAIN_STEPS steps on the synthetic
    stream's batches with their patches (1, 256, 3200), the searched
    plan's remat: finite losses; each step the flash backward once a
    layer, the forward once (twice under remat), RMSNorm as
    :func:`_vlm_launches`, no plain version; step ms and peak.  Then on a
    fresh draw two steps timed and one profiled (the busy share and device
    ms by category), and step 1's loss and gradients twice from seed 0:
    the same bits both times, the loss the CLI's.  Returns the CLI's
    launches."""
    import torch
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.executor import init_train_state, make_train_step

    cfg = _arch_cfg(VLM_ARCH, VLM_TRAIN_LAYERS)
    L = cfg.n_layers
    argv = ["--arch", VLM_ARCH, "--layers", str(L), "--batch", "1",
            "--seq", str(VLM_TRAIN_SEQ), "--steps", str(VLM_TRAIN_STEPS),
            "--log-every", "1"]
    n, gb = _param_footprint(cfg)
    log(f"[vlm] (b) python -m repro_torch.launch.train {' '.join(argv)}: "
        f"{n / 1e9:.3f} B params, {16 * n / 1e9:.2f} GB with AdamW's fp32 "
        f"master and moments")
    counts = _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    with recorded_train_steps(counts) as seen, plain_calls() as plain:
        hist = train_cli.main(argv)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = counts()
    losses = [h["loss"] for h in hist]
    remat = seen["remat_segments"][0]
    on = bool(remat and remat[0])
    check(len(losses) == VLM_TRAIN_STEPS and all(
        math.isfinite(x) for x in losses), f"(b) losses {losses}")
    check(not plain, f"(b) plain versions ran on the training path: {plain}")
    per_step = _dense_launches(L, on)
    for i, got in enumerate(seen["launches"], 1):
        check(all(got[k] == v for k, v in per_step.items()),
              f"(b) step {i} launched {got}, not {per_step}")
    del hist
    _free_cuda()
    opt_cfg = AdamWConfig(lr=train_cli.parse_args(argv).lr)
    gen = train_cli.batches(cfg, train_cli.parse_args(argv))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(gen).items()}
    check(tuple(batch["patches"].shape) == (1, VLM_VISION, cfg.d_vision),
          f"(b) patches {tuple(batch['patches'].shape)}")
    params, opt = init_train_state(cfg, seed=0, opt_cfg=opt_cfg,
                                   device="cuda")
    step = make_train_step(cfg, opt_cfg, remat_segments=remat)
    wall_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    busy, kernels, cats = profile_step(
        "internvl2 train", lambda: step(params, opt, batch),
        sum(wall_ms) / len(wall_ms), n=1)
    del params, opt, step
    _free_cuda()
    params = init_lm(cfg, seed=0, device="cuda")
    leaves = list(params.parameters())
    runs = []
    for _ in range(2):
        loss = lm_loss(params, batch, cfg, remat_segments=remat)
        runs.append((loss.detach(), torch.autograd.grad(loss, leaves)))
        del loss
    same = torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    first = float(runs[0][0])
    moved = float(runs[0][1][-4].float().abs().max())   # projector.w1
    log(f"[vlm] (b) step 1 from seed 0 twice: loss and {len(leaves)} "
        f"gradient leaves bitwise equal {same}; loss {first!r}, the CLI's "
        f"step 1 {losses[0]!r}; the projector's w1 gradient max |g| "
        f"{moved:.3e}")
    check(same, "(b) step 1's loss or gradients differ run to run")
    check(first == losses[0], "(b) step 1's loss is not the CLI's")
    check(moved > 0, "(b) the projector has no gradient")
    del params, leaves, runs, batch
    _free_cuda()
    tokens = VLM_TRAIN_SEQ
    result = {
        "arch": VLM_ARCH, "layers": L, "params": n,
        "positions": VLM_VISION + VLM_TRAIN_SEQ, "text_tokens": tokens,
        "remat_segments": remat, "losses": losses,
        "step_ms": seen["step_ms"], "text_tok_per_s":
            tokens * 1e3 / seen["step_ms"][-1],
        "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
        "device_busy_share": busy * len(wall_ms) / sum(wall_ms),
        "device_ms_by_category": cats, "kernels_per_step": kernels,
        "peak_mem_gb": peak_gb, "launches_per_step": seen["launches"][0]}
    log("[vlm] (b) " + json.dumps(result))
    return launches


@dataclasses.dataclass(frozen=True)
class LMShardCase:
    """A sharded decoder-only training run against one process (phases 25
    (c) and 26 (e)): ``cfg`` at full width on ``ranks`` gloo ranks of a
    (data, model) ``mesh`` with TP, ZeRO-3 and remat, ``steps`` steps at
    ``lr`` on the train CLI's first batch of ``lanes`` x ``seq``; the
    ranks report the local shapes of the leaves named in ``watch``."""
    tag: str
    cfg: object
    run_dir: str
    watch: tuple
    ranks: int
    mesh: tuple
    lanes: int
    seq: int
    steps: int
    lr: float
    timeout_s: int


def _lm_shard_batch(case):
    """The train CLI's first batch of ``case.lanes`` x ``case.seq`` tokens
    (with the VLM's patches), CPU tensors."""
    import torch
    from repro_torch.launch import train as train_cli
    gen = train_cli.batches(case.cfg, train_cli.parse_args([
        "--arch", case.cfg.name, "--batch", str(case.lanes), "--seq",
        str(case.seq)]))
    return {k: torch.from_numpy(v) for k, v in next(gen).items()}


def lm_shard_reference(case):
    """The single process, in this process on the card: the case's loss
    and gradients on ``init_lm`` seed 0 (with the drawn QKV biases where
    the config has them, :func:`_qwen_set_biases`) under remat, in bf16
    and, on the same weights, in fp32; each leaf's bf16-to-fp32 distance
    and the fp32 gradients' largest magnitudes, saved for the ranks with
    the fp32 gradients."""
    import torch
    from repro_torch.models import init_lm, lm_loss

    cfg = case.cfg
    batch = {k: v.to("cuda") for k, v in _lm_shard_batch(case).items()}
    params = init_lm(cfg, seed=0, device="cuda")
    if cfg.qkv_bias:
        _qwen_set_biases(params, cfg)
    leaves = list(params.parameters())
    names = [n for n, _ in params.named_parameters()]
    counts = _zero_counts()
    with plain_calls() as plain:
        loss = lm_loss(params, batch, cfg, remat_segments=[True])
        grads = torch.autograd.grad(loss, leaves)
    saved = {"loss": loss.item(), "launches": counts(), "plain": plain,
             "params": sum(p.numel() for p in leaves)}
    del loss
    params32 = copy.deepcopy(params).float()
    del params, leaves
    loss = lm_loss(params32, batch, cfg.with_(dtype=torch.float32),
                   remat_segments=[True])
    grads32 = torch.autograd.grad(loss, list(params32.parameters()))
    saved["loss32"] = loss.item()
    saved["single_vs_fp32"] = {n: _leaf_err(g, r) for n, g, r in
                               zip(names, grads, grads32)}
    saved["tops"] = {n: r.abs().max().item() for n, r in zip(names, grads32)}
    saved["grads32"] = {n: r.cpu() for n, r in zip(names, grads32)}
    del loss, params32, grads, grads32, batch
    _free_cuda()
    torch.save(saved, f"{case.run_dir}/reference.pt")
    return saved


def _shard_diff(g, want):
    """max |g - want| of a rank's gradient shard (on the card) and the
    same slice of a whole leaf (on the host), in slices of 2^24."""
    g, want = g.reshape(-1), want.reshape(-1)
    diff = 0.0
    for a in range(0, want.numel(), 1 << 24):
        w = want[a:a + (1 << 24)].to(g.device).float()
        diff = max(diff, (g[a:a + (1 << 24)].float() - w).abs().max().item())
    return diff


def lm_shard_rank(rank, world, case):
    """One gloo rank on the card: its shards of ``init_lm`` seed 0 on the
    case's mesh under TP, ZeRO-3 and remat (the rank's slices of the drawn
    biases set in them and in AdamW's master where the config has
    biases), then the case's steps of ``make_train_step(mesh=, policy=)``
    (launches counted from 0 before the steps); the first step's reduced
    gradient shards (kept check-only) against the same slices of the
    single process's fp32 gradients.  Saves its results."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (ShardPolicy, init_train_state,
                                     make_train_step)

    torch.cuda.set_device(0)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{case.run_dir}/rendezvous",
                     timeout_s=case.timeout_s)
    try:
        cfg = case.cfg
        mesh = make_local_mesh(case.mesh[1])
        pol = ShardPolicy(tp=True, zero=True, remat_segments=(True,))
        ocfg = AdamWConfig(lr=case.lr)
        ref = torch.load(f"{case.run_dir}/reference.pt", mmap=True)
        batch = _lm_shard_batch(case)
        t0 = time.perf_counter()
        params, opt = init_train_state(cfg, mesh=mesh, policy=pol, seed=0,
                                       opt_cfg=ocfg, device="cuda")
        step = make_train_step(cfg, ocfg, mesh=mesh, policy=pol)
        ctx, kept = step.shard, []
        if cfg.qkv_bias:
            _qwen_set_biases(params, cfg, opt, shard=ctx)
        torch.cuda.synchronize()
        out = {"coord": [mesh.get_local_rank("data"),
                         mesh.get_local_rank("model")],
               "init_s": time.perf_counter() - t0,
               "params_local": sum(p.numel() for p in params.parameters())}
        real = ctx.reduce_grads

        def keep(named, grads):     # check-only: the step's gradients
            reduced = real(named, grads)
            if not kept:
                kept.extend(reduced)
            return reduced

        ctx.reduce_grads = keep
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        counts = _zero_counts()
        hist = []
        with plain_calls() as plain:
            for _ in range(case.steps):
                sent = ctx.traffic.bytes_sent
                t0 = time.perf_counter()
                m = step(params, opt, batch)
                torch.cuda.synchronize()
                hist.append({"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "ms": (time.perf_counter() - t0) * 1e3,
                             "gloo_bytes": ctx.traffic.bytes_sent - sent})
        out.update(steps=hist, launches=counts(), plain=plain,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
                   tp=ctx.tp, split_vocab=ctx.split_vocab,
                   shapes={n: list(params.get_parameter(n).shape)
                           for n in case.watch})
        ctx.reduce_grads = real
        out["diffs"] = {n: _shard_diff(g, ctx.shard_tensor(
            n, ref["grads32"][n])) for (n, _), g in
            zip(params.named_parameters(), kept)}
        del kept, params, opt
        _free_cuda()
        pathlib.Path(f"{case.run_dir}/rank{rank}.json").write_text(
            json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _lm_shard(case, show=()):
    """The case's ranks sharing the card (:func:`lm_shard_rank`) against
    the single process (:func:`lm_shard_reference`): the loss at
    SHARD_LOSS_RTOL, the ranks' worst bf16 gradient leaf (its shards
    against the same slices of the single process's fp32 gradient, over
    the leaf's largest magnitude) within WSHARD_BF16_VS_FP32 times the
    single process's own worst bf16 leaf, the leaves named in ``show``
    printed beside the farthest; exact launch counts (:func:`
    _dense_launches`); a rank's gloo bytes a step and peak.  Returns the
    reference's and the ranks' launches and the ranks' results."""
    import torch

    tag, cfg, run_dir = case.tag, case.cfg, pathlib.Path(case.run_dir)
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    L = cfg.n_layers
    t0 = time.perf_counter()
    ref = lm_shard_reference(case)
    check(not ref["plain"], f"{tag} plain versions ran in the reference: "
          f"{ref['plain']}")
    want = _dense_launches(L, True)
    check(all(ref["launches"][k] == v for k, v in want.items()),
          f"{tag} the reference's launches {ref['launches']}, not {want}")
    single = max(ref["single_vs_fp32"].values())
    free, _ = torch.cuda.mem_get_info()
    log(f"{tag} single process: {cfg.name} at {L} layer(s), "
        f"{ref['params'] / 1e9:.3f} B params, {case.lanes} lanes of "
        f"{case.seq} tokens: loss {ref['loss']!r} (fp32 on the same "
        f"weights {ref['loss32']!r}); its bf16 gradient leaves lie up to "
        f"{single:.3e} from fp32; {time.perf_counter() - t0:.1f} s; the card "
        f"has {free / 1e9:.2f} GB free for the ranks")
    ranks_s = spawn_ranks(lm_shard_rank, (case.ranks, case),
                          case.ranks, f"sharded {cfg.name} ranks",
                          timeout_s=case.timeout_s)
    res = [json.loads((run_dir / f"rank{r}.json").read_text())
           for r in range(case.ranks)]
    shutil.rmtree(run_dir, ignore_errors=True)
    coords = [[d, m] for d in range(case.mesh[0])
              for m in range(case.mesh[1])]
    check([r["coord"] for r in res] == coords,
          f"{tag} mesh coordinates {[r['coord'] for r in res]}")
    check(not any(r["plain"] for r in res), f"{tag} plain versions ran")
    want = _dense_launches(L, True, case.steps)
    for r, row in enumerate(res):
        check(all(row["launches"][k] == v for k, v in want.items()),
              f"{tag} rank {r}: launches {row['launches']}, not {want}")
    losses = [[h["loss"] for h in r["steps"]] for r in res]
    check(all(x == losses[0] for x in losses) and all(
        math.isfinite(x) for x in losses[0]), f"{tag} step losses {losses}")
    rel = abs(losses[0][0] - ref["loss"]) / abs(ref["loss"])
    errs = {n: max(r["diffs"][n] for r in res) / max(ref["tops"][n], 1e-30)
            for n in ref["tops"]}
    worst = max(errs, key=errs.get)
    top = sorted(errs, key=errs.get, reverse=True)[:6]

    def pairs(names):
        return ", ".join(f"{n} {errs[n]:.3e} {ref['single_vs_fp32'][n]:.3e}"
                         for n in names)

    log(f"{tag} {case.ranks} ranks on (data, model) = {case.mesh}, TP + "
        f"ZeRO-3 + remat: step 1's loss {losses[0][0]!r} against the single "
        f"process's {ref['loss']!r} (rel {rel:.3e}, tol "
        f"{SHARD_LOSS_RTOL:.0e}); the ranks' worst bf16 gradient leaf "
        f"{worst} at {errs[worst]:.3e} of its fp32 largest magnitude, the "
        f"single process's own worst {single:.3e} (gate "
        f"{WSHARD_BF16_VS_FP32} x); (leaf, ranks, single process): "
        + (f"{pairs(show)}; farthest: " if show else "farthest: ")
        + pairs(top))
    for r, row in enumerate(res):
        log(f"{tag} rank {r} (data {row['coord'][0]}, model "
            f"{row['coord'][1]}): {row['params_local'] / 1e6:.1f} M params, "
            f"init {row['init_s']:.1f} s; step ms "
            f"{[round(h['ms'], 1) for h in row['steps']]}, gloo bytes sent "
            f"a step {[h['gloo_bytes'] for h in row['steps']]}; peak "
            f"{row['peak_gb']:.2f} GB ({row['reserved_gb']:.2f} reserved)")
    log(f"{tag} ranks {ranks_s:.1f} s ({case.ranks} ranks share one card: "
        "not a sharded run's speed)")
    check(rel <= SHARD_LOSS_RTOL, f"{tag} the sharded loss lies {rel:.3e} "
          "from the single process's")
    check(errs[worst] <= WSHARD_BF16_VS_FP32 * single,
          f"{tag} the ranks' bf16 gradient leaf {worst} lies "
          f"{errs[worst]:.3e} from fp32, above {WSHARD_BF16_VS_FP32} x "
          f"{single:.3e}")
    launches = {k: sum(r["launches"][k] for r in res)
                for k in res[0]["launches"]}
    return ref["launches"], launches, res


def _vlm_shard():
    """(c) VLM_SHARD_RANKS gloo ranks at VLM_SHARD_LAYERS layer on
    VLM_SHARD_MESH against one process (:func:`_lm_shard`): the whole head
    and table on every model rank (92553 splits over none), the
    projector's w1 the rank's columns.  Returns the ranks' launches."""
    cfg = _arch_cfg(VLM_ARCH, VLM_SHARD_LAYERS)
    case = LMShardCase("[vlm] (c)", cfg, str(VLM_DIR),
                       ("head", "projector.w1"), VLM_SHARD_RANKS,
                       VLM_SHARD_MESH, VLM_SHARD_LANES, VLM_SHARD_SEQ,
                       VLM_SHARD_STEPS, VLM_SHARD_LR, VLM_SHARD_TIMEOUT_S)
    _, launches, res = _lm_shard(case)
    d, dv = cfg.d_model, cfg.d_vision
    local = (2, {"head": [d // VLM_SHARD_MESH[0], cfg.vocab_size],
                 "projector.w1": [dv // VLM_SHARD_MESH[0],
                                  d // VLM_SHARD_MESH[1]]})
    got = [(r["tp"], r["shapes"]) for r in res]
    check(all(g == local for g in got) and not any(
        r["split_vocab"] for r in res), f"(c) TP degree, head and w1 shards "
          f"{got}, not {local}, or the vocabulary split")
    return launches


def _vlm_cpu_vs_card():
    """(d) reduced fp32 internvl2 with d_vision 192 apart from d 384 and
    6 query heads over 1 KV head (a GQA group of 6), 2 lanes of 16
    patches and VLM_FP32_SEQ tokens: the card's loss, logits and every
    gradient (the projector's among them) against the CPU's plain
    versions on the same weights, within REL_TOL of each one's largest
    magnitude; the card's call launches the flash forward and backward
    and RMSNorm."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm, lm_forward, lm_loss

    cfg = get_config(VLM_ARCH).reduced(d_model=384).with_(
        n_heads=6, n_kv_heads=1, head_dim=64, d_vision=192,
        dtype=torch.float32)
    g = torch.Generator().manual_seed(25)
    toks = torch.randint(0, cfg.vocab_size, (VLM_FP32_BATCH,
                                             VLM_FP32_SEQ + 1), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "patches": torch.randn(VLM_FP32_BATCH, cfg.vision_tokens,
                                    cfg.d_vision, generator=g)}
    params_cpu = init_lm(cfg, seed=0, device="cpu")
    out = {}
    for dev, params in (("cpu", params_cpu),
                        ("cuda", copy.deepcopy(params_cpu).to("cuda"))):
        b = {k: v.to(dev) for k, v in batch.items()}
        counts = _zero_counts()
        loss = lm_loss(params, b, cfg)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        with torch.no_grad():
            logits = lm_forward(params, b["tokens"], cfg,
                                patches=b["patches"])[0]
        out[dev] = (loss.item(), logits.cpu(), [x.cpu() for x in grads],
                    counts())
    names = [n for n, _ in params_cpu.named_parameters()]
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    e_logits = rel_err(out["cuda"][1], out["cpu"][1])
    e_grads = {n: rel_err(a, b) for n, a, b in
               zip(names, out["cuda"][2], out["cpu"][2])}
    worst = max(e_grads, key=e_grads.get)
    n = out["cuda"][3]
    log(f"[vlm] (d) reduced fp32 {VLM_ARCH} (d 384, d_vision 192, 6 query "
        f"heads over 1 KV head, {cfg.n_layers} layers), {VLM_FP32_BATCH} "
        f"lanes of {cfg.vision_tokens} patches + {VLM_FP32_SEQ} tokens: "
        f"card against the CPU: loss rel {rel:.3e}, logits {e_logits:.3e}, "
        f"worst gradient {worst} {e_grads[worst]:.3e}, the projector's "
        + ", ".join(f"{k} {v:.3e}" for k, v in e_grads.items()
                    if k.startswith("projector."))
        + f" (tol {REL_TOL['float32']:.0e}); the card's launches {n}")
    check(max(rel, e_logits, e_grads[worst]) <= REL_TOL["float32"],
          "(d) the reduced fp32 VLM differs between the card and the CPU")
    check(n["flash_attention"] > 0 and n["flash_attention_bwd"] > 0
          and n["rmsnorm"] > 0 and n["rmsnorm_bwd"] > 0,
          f"(d) the card's call launched {n}")


def phase_vlm():
    """Phase 25: internvl2-26b at full width, bf16, random weights from
    seed 0.  (a) serving at full depth (:func:`_vlm_serve`); (b) training
    on one card at VLM_TRAIN_LAYERS layers through the train CLI
    (:func:`_vlm_train`); (c) 4 gloo ranks at VLM_SHARD_LAYERS layers on
    (data 2, model 2) with TP, ZeRO-3 and remat (:func:`_vlm_shard`); (d)
    reduced fp32, card against CPU (:func:`_vlm_cpu_vs_card`).  Returns
    {path: launches}."""
    import torch

    t_phase = time.perf_counter()
    _free_cuda()
    cfg = _arch_cfg(VLM_ARCH)
    check((cfg.n_heads, cfg.n_kv_heads, cfg.dh) == VLM_HEADS,
          f"internvl2's heads {(cfg.n_heads, cfg.n_kv_heads, cfg.dh)}")
    n, gb = _param_footprint(cfg)
    free, total = torch.cuda.mem_get_info()
    log(f"[vlm] memory reckoned before the draw: {cfg.n_layers} layers, "
        f"{n / 1e9:.3f} B params, {gb:.2f} GB in bf16; the card has "
        f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free")
    check(gb < free / 1e9, f"internvl2 needs {gb:.2f} GB, "
          f"{free / 1e9:.2f} GB free")
    params = _moe_init(cfg, "[vlm]")
    launches = {"vlm_serve": _vlm_serve(cfg, params)}
    del params
    _free_cuda()
    t0 = time.perf_counter()
    launches["vlm_train"] = _vlm_train()
    log(f"[vlm] (b) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["vlm_shard"] = _vlm_shard()
    log(f"[vlm] (c) in {time.perf_counter() - t0:.1f} s")
    _vlm_cpu_vs_card()
    log(f"[vlm] phase 25 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 26: the Qwen2/Qwen3 dense family at full width
# ---------------------------------------------------------------------------

QWEN_DIR = ROOT / "build" / "qwen_shard"
QWEN_CKPT_DIR = ROOT / "build" / "qwen_ckpt"
BIAS_LEAVES = ("bq", "bk", "bv")


def _bias_names(params):
    return [n for n, _ in params.named_parameters()
            if n.rsplit(".", 1)[-1] in BIAS_LEAVES]


def _qwen_set_biases(params, cfg, opt=None, shard=None):
    """Check-only: fill each bq, bk and bv of ``params`` with a draw of
    std QWEN_BIAS_STD, leaf by leaf in the parameters' order from a CPU
    generator seeded with QWEN_BIAS_SEED (the same numbers in every
    process, whatever the depth before it), and AdamW's fp32 master copy
    in ``opt``; with a sharding context ``shard`` a rank keeps its slice
    of each whole draw.  Returns the names of the leaves set."""
    import torch
    g = torch.Generator().manual_seed(QWEN_BIAS_SEED)
    names = []
    with torch.no_grad():
        for i, (name, p) in enumerate(params.named_parameters()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf not in BIAS_LEAVES:
                continue
            whole = QWEN_BIAS_STD * torch.randn(
                cfg.q_dim if leaf == "bq" else cfg.kv_dim, generator=g)
            part = whole if shard is None else shard.shard_tensor(name, whole)
            p.copy_(part.to(p.device, p.dtype))
            if opt is not None:
                opt["master"][i].copy_(p.float())
            names.append(name)
    return names


def _bias_snapshot(params, opt):
    """AdamW's fp32 master copies of the bias leaves (the bf16 leaves are
    their roundings: at lr 3e-6 a step moves a bias of std 0.5 by less
    than half a bf16 ulp, 2^-10 to 2^-9 there, and may leave the whole
    bf16 leaf as it was)."""
    return {n: m.detach().cpu().clone() for (n, _), m in
            zip(params.named_parameters(), opt["master"])
            if n.rsplit(".", 1)[-1] in BIAS_LEAVES}


@contextlib.contextmanager
def biased_train_state(snapshots):
    """Check-only: ``launch/train.py``'s ``init_train_state`` followed by
    :func:`_qwen_set_biases` (the biases and AdamW's master copy), and a
    snapshot of the bias leaves' master copies (:func:`_bias_snapshot`)
    appended to ``snapshots`` after the draw and after each step, while
    the block runs."""
    from repro_torch.launch import train as train_cli

    real_init, real_make = train_cli.init_train_state, \
        train_cli.make_train_step

    def init(cfg, *args, **kwargs):
        params, opt = real_init(cfg, *args, **kwargs)
        _qwen_set_biases(params, cfg, opt)
        snapshots.append(_bias_snapshot(params, opt))
        return params, opt

    def make(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def stepped(params, opt, batch):
            out = step(params, opt, batch)
            snapshots.append(_bias_snapshot(params, opt))
            return out
        return stepped

    train_cli.init_train_state, train_cli.make_train_step = init, make
    try:
        yield snapshots
    finally:
        train_cli.init_train_state, train_cli.make_train_step = \
            real_init, real_make


def _moved_each_step(snapshots, tag):
    """Every bias leaf's master copy changes from each snapshot to the
    next."""
    import torch
    still = [(i, n) for i, (a, b) in enumerate(zip(snapshots, snapshots[1:]))
             for n in a if torch.equal(a[n], b[n])]
    check(len(snapshots) > 1 and not still,
          f"{tag} bias leaves that a step left as they were: {still[:6]}")


def _qwen_draw(arch, tag, layers=None):
    """The memory reckoned from the shapes and printed beside the card's
    free memory before the draw; ``init_lm`` seed 0 on the card, then the
    biases (:func:`_qwen_set_biases`).  Returns (cfg, params)."""
    import torch
    from repro_torch.configs import get_config

    cfg = _arch_cfg(arch, layers)
    check((cfg.n_heads, cfg.n_kv_heads, cfg.dh) == QWEN_HEADS[arch],
          f"{arch}'s heads {(cfg.n_heads, cfg.n_kv_heads, cfg.dh)}")
    n, gb = _param_footprint(cfg)
    layer = _param_footprint(cfg.with_(n_layers=cfg.n_layers + 1))[1] - gb
    fixed = gb - layer * cfg.n_layers
    # the table, drawn last, passes through an fp32 copy (layers.randn)
    draw = 4 * cfg.vocab_size * cfg.d_model / 1e9
    spare = max(QWEN72_HEADROOM_GB, draw)
    free, total = torch.cuda.mem_get_info()
    deepest = int((free / 1e9 - spare - fixed) // layer)
    log(f"{tag} memory reckoned before the draw: {cfg.n_layers} of "
        f"{get_config(arch).n_layers} layers, {n / 1e9:.3f} B params, "
        f"{gb:.2f} GB in bf16 ({layer:.3f} GB a layer beside {fixed:.2f} GB "
        f"of table, head and final norm); the card has {free / 1e9:.2f} of "
        f"{total / 1e9:.2f} GB free, so the deepest cut that leaves "
        f"{spare:.2f} GB (the table's fp32 draw {draw:.2f} GB, then pools "
        f"and activations at least {QWEN72_HEADROOM_GB:g}) is {deepest} "
        f"layers")
    check(cfg.n_layers <= deepest, f"{arch} at {cfg.n_layers} layers needs "
          f"{gb:.2f} GB, {free / 1e9:.2f} GB free")
    params = _moe_init(cfg, tag)
    if cfg.qkv_bias:
        names = _qwen_set_biases(params, cfg)
        check(len(names) == 3 * cfg.n_layers, f"{tag} {len(names)} bias "
              f"leaves in {cfg.n_layers} layers")
        log(f"{tag} {len(names)} QKV bias leaves drawn with std "
            f"{QWEN_BIAS_STD} from seed {QWEN_BIAS_SEED}")
    return cfg, params


def _qwen_biases_seen(cfg, params, tag):
    """``make_prefill_step`` on 2 x 64 random tokens with the drawn biases
    and with them zeroed (they are put back after): the logits must move
    by more than DECODE_VS_PREFILL_TOL of the largest, or the paths above
    proved nothing of the add."""
    import torch
    from repro_torch.runtime.executor import make_prefill_step

    g = torch.Generator(device="cuda").manual_seed(26)
    toks = torch.randint(0, cfg.vocab_size, (DECODE_VS_PREFILL_LANES,
                                             QWEN_DECODE_VS_PREFILL_T),
                         generator=g, device="cuda", dtype=torch.int32)
    prefill = make_prefill_step(cfg)
    biased = prefill(params, {"tokens": toks}).float()
    kept = {n: params.get_parameter(n).detach().clone()
            for n in _bias_names(params)}
    with torch.no_grad():
        for n in kept:
            params.get_parameter(n).zero_()
        plain = prefill(params, {"tokens": toks}).float()
        for n, t in kept.items():
            params.get_parameter(n).copy_(t)
    moved = ((biased - plain).abs().max() / biased.abs().max()).item()
    log(f"{tag} the prefill's logits with the biases zeroed lie {moved:.3e} "
        f"of the largest from the biased ones (must exceed "
        f"{DECODE_VS_PREFILL_TOL:.0e})")
    check(bool(torch.isfinite(biased).all()), f"{tag} prefill not finite")
    check(moved > DECODE_VS_PREFILL_TOL, f"{tag} the biases do not move "
          "the logits")


def _qwen_train():
    """(d) ``train --arch qwen2.5-14b --layers QWEN_TRAIN_LAYERS --batch 1
    --seq QWEN_TRAIN_SEQ --lr QWEN_TRAIN_LR`` for QWEN_TRAIN_STEPS steps
    with the searched plan's remat, the biases drawn after
    ``init_train_state``
    (:func:`biased_train_state`): finite losses that fall, every bias
    leaf's master copy changed by each step, the kernels' launches a step exact
    (:func:`_dense_launches`), no plain version, step ms and peak.  Then
    on a fresh draw with the same biases two steps timed and one profiled
    (the busy share and device ms by category); the lr witness at
    QWEN_WITNESS_LR (:func:`_dense_lr_witness`); and step 1's loss and gradients twice:
    the same bits both times, the loss the CLI's.  Returns the CLI's
    launches."""
    import torch
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.executor import init_train_state, make_train_step

    cfg = _arch_cfg(QWEN2_5_14B, QWEN_TRAIN_LAYERS)
    L = cfg.n_layers
    argv = ["--arch", QWEN2_5_14B, "--layers", str(L), "--batch", "1",
            "--seq", str(QWEN_TRAIN_SEQ), "--steps", str(QWEN_TRAIN_STEPS),
            "--lr", str(QWEN_TRAIN_LR), "--log-every", "1"]
    n, _ = _param_footprint(cfg)
    free, _ = torch.cuda.mem_get_info()
    log(f"[qwen2] (d) python -m repro_torch.launch.train {' '.join(argv)}: "
        f"{n / 1e9:.3f} B params, {16 * n / 1e9:.2f} GB with AdamW's fp32 "
        f"master and moments; the card has {free / 1e9:.2f} GB free")
    counts = _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    snaps = []
    with recorded_train_steps(counts) as seen, biased_train_state(snaps), \
            plain_calls() as plain:
        hist = train_cli.main(argv)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = counts()
    losses = [h["loss"] for h in hist]
    remat = seen["remat_segments"][0]
    on = bool(remat and remat[0])
    log(f"[qwen2] (d) losses {losses}, remat {remat}")
    check(len(losses) == QWEN_TRAIN_STEPS and all(
        math.isfinite(x) for x in losses), f"(d) losses {losses}")
    check(losses[-1] < losses[0], f"(d) the losses do not fall: {losses}")
    check(not plain, f"(d) plain versions ran on the training path: {plain}")
    _moved_each_step(snaps, "(d)")
    per_step = _dense_launches(L, on)
    for i, got in enumerate(seen["launches"], 1):
        check(all(got[k] == v for k, v in per_step.items()),
              f"(d) step {i} launched {got}, not {per_step}")
    del hist
    _free_cuda()
    opt_cfg = AdamWConfig(lr=train_cli.parse_args(argv).lr)
    gen = train_cli.batches(cfg, train_cli.parse_args(argv))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(gen).items()}
    params, opt = init_train_state(cfg, seed=0, opt_cfg=opt_cfg,
                                   device="cuda")
    _qwen_set_biases(params, cfg, opt)
    step = make_train_step(cfg, opt_cfg, remat_segments=remat)
    wall_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    busy, kernels, cats = profile_step(
        "qwen2.5-14b train", lambda: step(params, opt, batch),
        sum(wall_ms) / len(wall_ms), n=1)
    del params, opt, step
    _free_cuda()
    batches = [batch] + [{k: torch.from_numpy(v).to("cuda") for k, v in
                          next(gen).items()}
                         for _ in range(QWEN_TRAIN_STEPS - 1)]
    witness = _dense_lr_witness(cfg, batches, QWEN_WITNESS_LR)
    check(all(math.isfinite(x) for v in witness.values() for x in v),
          f"(d) lr witness losses not finite: {witness}")
    first_rel = abs(witness["kernels"][0] - witness["plain"][0]) / abs(
        witness["plain"][0])
    log(f"[qwen2] (d) lr witness, {L} layers, remat, lr "
        f"{QWEN_WITNESS_LR:g}, {QWEN_TRAIN_STEPS} steps from the same "
        f"weights and biases: losses through the flash kernels "
        f"{witness['kernels']}, through the plain attention autodiffed by "
        f"torch {witness['plain']}; step 1 rel {first_rel:.2e} (tol "
        f"{TOL['bfloat16']:.0e})")
    check(first_rel <= TOL["bfloat16"], "(d) the witness's first losses "
          "differ between the kernels and the plain attention")
    del batches
    params = init_lm(cfg, seed=0, device="cuda")
    _qwen_set_biases(params, cfg)
    leaves = list(params.parameters())
    runs = []
    for _ in range(2):
        loss = lm_loss(params, batch, cfg, remat_segments=remat)
        runs.append((loss.detach(), torch.autograd.grad(loss, leaves)))
        del loss
    same = torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    first = float(runs[0][0])
    names = [nm for nm, _ in params.named_parameters()]
    bias_g = max(float(g.float().abs().max()) for nm, g in
                 zip(names, runs[0][1]) if nm.rsplit(".", 1)[-1] in
                 BIAS_LEAVES)
    log(f"[qwen2] (d) step 1 from seed 0 twice: loss and {len(leaves)} "
        f"gradient leaves bitwise equal {same}; loss {first!r}, the CLI's "
        f"step 1 {losses[0]!r}; the bias gradients' max |g| {bias_g:.3e}")
    check(same, "(d) step 1's loss or gradients differ run to run")
    check(first == losses[0], "(d) step 1's loss is not the CLI's")
    check(bias_g > 0, "(d) the biases have no gradient")
    del params, leaves, runs, batch
    _free_cuda()
    result = {
        "arch": QWEN2_5_14B, "layers": L, "params": n,
        "tokens": QWEN_TRAIN_SEQ, "remat_segments": remat, "losses": losses,
        "step_ms": seen["step_ms"],
        "tok_per_s": QWEN_TRAIN_SEQ * 1e3 / seen["step_ms"][-1],
        "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
        "device_busy_share": busy * len(wall_ms) / sum(wall_ms),
        "device_ms_by_category": cats, "kernels_per_step": kernels,
        "peak_mem_gb": peak_gb, "launches_per_step": seen["launches"][0]}
    log("[qwen2] (d) " + json.dumps(result))
    return launches


def _qwen_ckpt():
    """(d) the checkpoint round trip of the biased model through the train
    CLI, on the reduced bf16 qwen2.5-14b (QWEN_CKPT_ARGV) with
    ``--ckpt-dir --ckpt-every QWEN_CKPT_AT``: a fresh draw (seed 1)
    restores the files, its bias leaves the saved step's bit for bit, and
    takes the next step: its loss is the unbroken run's, bit for bit (the
    biases' master copies compared); the files are deleted."""
    import torch
    from repro_torch.checkpointing import restore_train_state
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.executor import init_train_state, make_train_step

    ck = QWEN_CKPT_DIR
    shutil.rmtree(ck, ignore_errors=True)
    argv = [*QWEN_CKPT_ARGV, "--ckpt-dir", str(ck), "--ckpt-every",
            str(QWEN_CKPT_AT)]
    snaps = []
    with recorded_train_steps() as seen, biased_train_state(snaps), \
            plain_calls() as plain:
        hist = train_cli.main(argv)
    losses = [h["loss"] for h in hist]
    check(not plain, f"(d) plain versions ran: {plain}")
    check(all(math.isfinite(x) for x in losses), f"(d) losses {losses}")
    _moved_each_step(snaps, "(d) reduced")
    args = train_cli.parse_args(argv)
    cfg = train_cli.config_from_args(args)
    opt_cfg = AdamWConfig(lr=args.lr)
    params, opt = init_train_state(cfg, seed=1, opt_cfg=opt_cfg,
                                   device="cuda")
    _, _, at = restore_train_state(params, opt, ck)
    n_bytes = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
    shutil.rmtree(ck, ignore_errors=True)
    check(at == QWEN_CKPT_AT and opt["step"] == QWEN_CKPT_AT,
          f"(d) restored step {at}, AdamW step {opt['step']}")
    back = _bias_snapshot(params, opt)
    same_bias = all(torch.equal(back[n], snaps[at][n]) for n in back)
    gen = train_cli.batches(cfg, args)
    batches = [next(gen) for _ in range(at + 1)]
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in batches[at].items()}
    step = make_train_step(cfg, opt_cfg,
                           remat_segments=seen["remat_segments"][0])
    resumed = float(step(params, opt, batch)["loss"])
    log(f"[qwen2] (d) reduced {cfg.name} (d {cfg.d_model}, {cfg.n_heads} "
        f"heads over {cfg.n_kv_heads}, {cfg.n_layers} layers): saved after "
        f"step {at} ({n_bytes / 1e6:.1f} MB), restored into a fresh draw: "
        f"the {len(back)} bias leaves the saved ones bit for bit "
        f"{same_bias}; step {at + 1}'s loss {resumed!r} against the "
        f"unbroken run's {losses[at]!r}")
    check(same_bias, "(d) the restored biases are not the saved ones")
    check(resumed == losses[at], "(d) the resumed step's loss is not the "
          "unbroken run's")
    del params, opt, step
    _free_cuda()


def _qwen_shard():
    """(e) QWEN_SHARD_RANKS gloo ranks at QWEN_SHARD_LAYERS layer on
    QWEN_SHARD_MESH against one process (:func:`_lm_shard`), the drawn
    biases in both, the bias leaves printed (a rank's bias gradient is its
    heads' slice summed over ``model``, then cut over ``data``): the
    vocabulary split over ``model`` (152064 / 2), each bias's ZeRO half on
    every rank.  Returns the ranks' launches."""
    cfg = _arch_cfg(QWEN2_5_14B, QWEN_SHARD_LAYERS)
    case = LMShardCase("[qwen2] (e)", cfg, str(QWEN_DIR),
                       ("head", "blocks.0.attn.bq"), QWEN_SHARD_RANKS,
                       QWEN_SHARD_MESH, QWEN_SHARD_LANES, QWEN_SHARD_SEQ,
                       QWEN_SHARD_STEPS, QWEN_SHARD_LR, QWEN_SHARD_TIMEOUT_S)
    biases = [f"blocks.{i}.attn.{b}" for i in range(cfg.n_layers)
              for b in BIAS_LEAVES]
    _, launches, res = _lm_shard(case, show=biases)
    (data, model), d = QWEN_SHARD_MESH, cfg.d_model
    local = (model, {"head": [d // data, cfg.vocab_size // model],
                     "blocks.0.attn.bq": [cfg.q_dim // data]})
    got = [(r["tp"], r["shapes"]) for r in res]
    check(all(g == local for g in got) and all(
        r["split_vocab"] for r in res), f"(e) TP degree, head and bq shards "
          f"{got}, not {local}, or the vocabulary whole")
    return launches


def _qwen_cpu_vs_card():
    """(f) reduced fp32 qwen2.5-14b at d 640 with 10 query heads over 2 KV
    heads of dh 64 (a GQA group of 5; dh 64 as the card's kernels take 64,
    112 or 128) and the drawn biases, 2 lanes of QWEN_FP32_SEQ tokens: the
    card's loss, logits and every gradient (the biases' among them)
    against the CPU's plain versions on the same weights, within REL_TOL
    of each one's largest magnitude; QWEN_FP32_DECODE greedy
    ``make_serve_step`` steps from each lane's first token: the same
    tokens, the logits within REL_TOL; the card's calls launch the flash
    forward and backward and RMSNorm."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (init_decode_state, init_lm, lm_forward,
                                    lm_loss)
    from repro_torch.runtime.executor import make_serve_step

    cfg = get_config(QWEN2_5_14B).reduced(d_model=640).with_(
        n_heads=10, n_kv_heads=2, head_dim=64, dtype=torch.float32)
    g = torch.Generator().manual_seed(26)
    toks = torch.randint(0, cfg.vocab_size, (QWEN_FP32_BATCH,
                                             QWEN_FP32_SEQ + 1), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params_cpu = init_lm(cfg, seed=0, device="cpu")
    _qwen_set_biases(params_cpu, cfg)
    out = {}
    for dev, params in (("cpu", params_cpu),
                        ("cuda", copy.deepcopy(params_cpu).to("cuda"))):
        b = {k: v.to(dev) for k, v in batch.items()}
        counts = _zero_counts()
        loss = lm_loss(params, b, cfg)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        with torch.no_grad():
            logits = lm_forward(params, b["tokens"], cfg)[0]
            step = make_serve_step(cfg)
            state = init_decode_state(cfg, QWEN_FP32_BATCH, QWEN_FP32_DECODE,
                                      device=dev)
            tok, dec, picked = b["tokens"][:, 0], [], []
            for _ in range(QWEN_FP32_DECODE):
                lg, state = step(params, state, tok)
                tok = lg.argmax(-1)
                dec.append(lg.cpu())
                picked.append(tok.cpu())
        out[dev] = (loss.item(), logits.cpu(), [x.cpu() for x in grads],
                    torch.stack(dec), torch.stack(picked), counts())
    names = [n for n, _ in params_cpu.named_parameters()]
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    e_logits = rel_err(out["cuda"][1], out["cpu"][1])
    e_grads = {n: rel_err(a, b) for n, a, b in
               zip(names, out["cuda"][2], out["cpu"][2])}
    worst = max(e_grads, key=e_grads.get)
    e_dec = rel_err(out["cuda"][3], out["cpu"][3])
    same = torch.equal(out["cuda"][4], out["cpu"][4])
    n = out["cuda"][5]
    log(f"[qwen2] (f) reduced fp32 {QWEN2_5_14B} (d 640, 10 query heads "
        f"over 2 KV heads of dh 64, {cfg.n_layers} layers, biases of std "
        f"{QWEN_BIAS_STD}), {QWEN_FP32_BATCH} lanes of {QWEN_FP32_SEQ} "
        f"tokens: card against the CPU: loss rel {rel:.3e}, logits "
        f"{e_logits:.3e}, worst gradient {worst} {e_grads[worst]:.3e}, the "
        "biases' " + ", ".join(f"{k} {v:.3e}" for k, v in e_grads.items()
                               if k.rsplit(".", 1)[-1] in BIAS_LEAVES)
        + f"; {QWEN_FP32_DECODE} greedy decode steps: logits {e_dec:.3e}, "
        f"the same tokens {same} (tol {REL_TOL['float32']:.0e}); the card's "
        f"launches {n}")
    check(max(rel, e_logits, e_grads[worst], e_dec) <= REL_TOL["float32"],
          "(f) the reduced fp32 model differs between the card and the CPU")
    check(same, "(f) the card's greedy tokens are not the CPU's")
    check(n["flash_attention"] > 0 and n["flash_attention_bwd"] > 0
          and n["rmsnorm"] > 0 and n["rmsnorm_bwd"] > 0,
          f"(f) the card's calls launched {n}")


def phase_qwen2():
    """Phase 26: the Qwen2/Qwen3 dense family at full width, bf16, random
    weights from seed 0, the QKV biases drawn after (:func:`_qwen_draw`).
    (a) qwen3-8b at 36 layers and (b) qwen2.5-14b at 48 through the paged
    engine twice (:func:`_moe_paged`: every request complete, flash and
    RMSNorm at the counted launches, no plain version, the same tokens and
    first-step bits, a decode step's wall and busy ms beside its bound);
    (b) also the dense-cache engine (:func:`_moe_dense_serve`), decode
    against the teacher-forced prefill at phase 11's gate and the biases
    seen in the logits (:func:`_qwen_biases_seen`); (c) qwen2-72b at
    QWEN72_LAYERS of 80 layers, paged; (d) training (:func:`_qwen_train`)
    and the checkpoint round trip (:func:`_qwen_ckpt`); (e) 4 gloo ranks
    (:func:`_qwen_shard`); (f) reduced fp32 card against CPU
    (:func:`_qwen_cpu_vs_card`).  Returns {path: launches}."""
    t_phase = time.perf_counter()
    _free_cuda()
    launches = {}
    for arch, path, tag, layers in (
            (QWEN3_8B, "qwen3_8b_serve", "[qwen2] (a)", None),
            (QWEN2_5_14B, "qwen2_5_14b_serve", "[qwen2] (b)", None),
            (QWEN2_72B, "qwen2_72b_serve", "[qwen2] (c)", QWEN72_LAYERS)):
        t0 = time.perf_counter()
        cfg, params = _qwen_draw(arch, tag, layers)
        launches[path], _ = _moe_paged(cfg, params, tag)
        if arch == QWEN2_5_14B:
            launches["qwen2_5_14b_dense_serve"], _ = _moe_dense_serve(
                cfg, params, tag)
            _decode_vs_prefill(cfg, params, QWEN_DECODE_VS_PREFILL_T,
                               DECODE_VS_PREFILL_TOL, tag)
            _qwen_biases_seen(cfg, params, tag)
        del params
        _free_cuda()
        log(f"{tag} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["qwen2_5_14b_train"] = _qwen_train()
    _qwen_ckpt()
    log(f"[qwen2] (d) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["qwen2_5_14b_shard"] = _qwen_shard()
    log(f"[qwen2] (e) in {time.perf_counter() - t0:.1f} s")
    _qwen_cpu_vs_card()
    log(f"[qwen2] phase 26 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 8: sequence-parallel attention, 4 ranks on the card
# ---------------------------------------------------------------------------

def sp_inputs(cfg):
    """One full-width attention layer (random bf16 weights from seed 0,
    QK-norm) and the (1, 32768, d) bf16 input, the same in every process."""
    import torch
    from repro_torch.models.attention import init_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    layer = init_attention(cfg, generator=g, device="cuda")
    x = torch.randn(1, SP_SEQ, cfg.d_model, generator=g,
                    device="cuda").to(cfg.dtype)
    pos = torch.arange(SP_SEQ, dtype=torch.int32, device="cuda")[None]
    return layer, x, pos


def sp_rank(rank, world, run_dir):
    """One rank of phase 8: its 8192-token slice through
    ``attention(impl="ring")`` over the mesh's ``seq`` group.  Saves its
    output, the launches of the timed call, the call's wall time and each
    round's panel-visit time."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_distributed, make_ring_mesh
    from repro_torch.models.attention import attention
    from repro_torch.runtime.sequence import shard_sequence

    # CUDA events around each round's panel visit: the ring looks the kernel
    # up as ops.flash_partial at every round
    visits, panel_visit = [], ops.flash_partial

    def timed_visit(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = panel_visit(*args, **kwargs)
        end.record()
        visits.append((start, end))
        return out

    ops.flash_partial = timed_visit

    torch.cuda.set_device(0)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{run_dir}/rendezvous",
                     timeout_s=SP_TIMEOUT_S)
    try:
        mesh = make_ring_mesh(world)
        cfg = get_config("qwen3-4b")
        layer, x, pos = sp_inputs(cfg)
        xs, ps = shard_sequence(x, mesh), shard_sequence(pos, mesh)
        group = mesh.get_group("seq")

        def run():
            with torch.no_grad():
                return attention(layer, xs, ps, cfg, impl="ring",
                                 sp_group=group)

        run()                               # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        visits.clear()
        counts = _zero_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = counts()
        visit_ms = [a.elapsed_time(b) for a, b in visits]
        torch.save({"out": out.cpu(), "launches": launches,
                    "wall_ms": wall_ms, "visit_ms": visit_ms,
                    "backend": dist.get_backend(group),
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9},
                   f"{run_dir}/rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_sp():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.attention import attention

    cfg = get_config("qwen3-4b")
    run_dir = ROOT / "build" / "sp"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    torch.cuda.empty_cache()
    log(f"[sp] qwen3-4b attention layer, {SP_SEQ} tokens over {SP_RANKS} "
        f"gloo ranks on one card ({SP_LOCAL} each), impl='ring'")
    wall_s = spawn_ranks(sp_rank, (SP_RANKS, str(run_dir)), SP_RANKS,
                         "sp ranks", SP_TIMEOUT_S)
    ranks = [torch.load(run_dir / f"rank{r}.pt") for r in range(SP_RANKS)]
    for r, res in enumerate(ranks):
        check(res["backend"] == "gloo", f"rank {r}: {res['backend']}")
        check(res["launches"]["flash_partial"] == SP_RANKS,
              f"rank {r}: flash_partial launched "
              f"{res['launches']['flash_partial']} times, not {SP_RANKS}")
        check(res["launches"]["flash_attention"] == 0,
              f"rank {r}: flash_attention ran on the ring path")
    got = torch.cat([res["out"] for res in ranks], dim=1).to("cuda")

    layer, x, pos = sp_inputs(cfg)
    with torch.no_grad():
        t1 = time.perf_counter()
        want = attention(layer, x, pos, cfg, impl="flash")
        torch.cuda.synchronize()
        flash_ms = (time.perf_counter() - t1) * 1e3
    check(got.shape == want.shape == (1, SP_SEQ, cfg.d_model)
          and bool(torch.isfinite(got).all()), "ring output not finite")
    diff = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)     # bf16 at max|ref|
    log(f"[sp] ring vs single-process flash over {SP_SEQ} tokens: max|diff| "
        f"{diff:.4e}, max|ref| {top:.4e}, tol 2 bf16 ulps = {2 * ulp:.4e}")
    check(diff <= 2 * ulp, f"ring differs from flash by {diff}")
    launches = {k: sum(res["launches"][k] for res in ranks)
                for k in ranks[0]["launches"]}
    for r, res in enumerate(ranks):
        check(len(res["visit_ms"]) == SP_RANKS,
              f"rank {r}: {len(res['visit_ms'])} timed panel visits")
        log(f"[sp] rank {r}: ring call {res['wall_ms']:.2f} ms; panel visits "
            f"(CUDA events around each round's launch) "
            + ", ".join(f"{t:.3f}" for t in res["visit_ms"])
            + f" ms, sum {sum(res['visit_ms']):.2f} ms; the rest of the call "
            f"{res['wall_ms'] - sum(res['visit_ms']):.2f} ms")
    result = {
        "tokens": SP_SEQ, "ranks": SP_RANKS, "tokens_per_rank": SP_LOCAL,
        "backend": "gloo",
        "ring_call_wall_ms_by_rank": [res["wall_ms"] for res in ranks],
        "panel_visit_ms_by_rank": [res["visit_ms"] for res in ranks],
        "rest_of_call_ms_by_rank": [res["wall_ms"] - sum(res["visit_ms"])
                                    for res in ranks],
        "peak_mem_gb_by_rank": [res["peak_gb"] for res in ranks],
        "flash_reference_wall_ms": flash_ms, "phase_wall_s": wall_s,
        "max_abs_diff": diff, "launches": launches,
    }
    log("[sp] " + json.dumps(result) + " (the 4 ranks share one card)")
    shutil.rmtree(run_dir, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 7: timings and bounds
# ---------------------------------------------------------------------------

def _bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _times(kernel, plain, library, *, iters=20, plain_iters=None):
    """Device ms per call (:func:`device_ms`) and ms per call of
    back-to-back launches from Python (CUDA events) of the kernel, its plain
    version and the library call (None: there is none)."""
    pi = plain_iters or iters
    out, queued = {}, {}
    for key, fn, n in (("", kernel, iters), ("plain_", plain, pi),
                       ("library_", library, iters)):
        if fn is None:
            out.update({f"{key}ms": None, f"{key}launch_ms": None})
            continue
        out[f"{key}ms"], queued[key or "kernel"] = device_ms(fn, n)
        out[f"{key}launch_ms"] = cuda_ms(fn, iters=n, warmup=1)
    out["device_timed"] = {k.rstrip("_"): v for k, v in queued.items()}
    return out


def _flash_timing(B, S, T, q_offset, kv_len, causal=True,
                  heads=(32, 8, 128), with_lse=False):
    """Times of the kernel, its plain version and SDPA, and the bound, at
    one serving shape in bf16 (``heads`` (H, KV, dh): qwen3-4b's by
    default); non-causal takes no q_offset (the dense engine's decode);
    ``with_lse`` also writes the row log-sum-exp (the plain version also
    computes it; SDPA does not)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    H, KV, dh = heads
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(B, S, H, dh, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, T, KV, dh, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, T, KV, dh, generator=g, device="cuda").bfloat16()
    kw = dict(kv_len=_i32(kv_len))
    # admissible (query, key) pairs of these inputs, the keys read, and the
    # query rows read (those that admit a key); every output row written
    kpos = torch.arange(T, device="cuda")
    mask = (kpos[None, None, :] < kw["kv_len"].long()[:, None, None]).expand(
        B, S, T)
    if causal:
        kw["q_offset"] = _i32(q_offset)
        qpos = kw["q_offset"][:, None].long() + torch.arange(S, device="cuda")
        mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
    else:
        kw["causal"] = False
    pairs = mask.sum().item()
    keys = mask.any(1).sum().item()
    rows = mask.any(2).sum().item()     # query rows that admit a key
    n_bytes = (2 * (rows * H * dh + B * S * H * dh + 2 * keys * KV * dh)
               + 4 * B * (2 if causal else 1)
               + (4 * B * S * H if with_lse else 0))
    n_ops = 4 * pairs * H * dh
    bound, by = _bound_ms(n_bytes, n_ops, "bfloat16")
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_mask = mask[:, None]

    def plain():
        out = ref.flash_attention_ref(q, k, v, **kw)
        return (out, ref.flash_attention_lse_ref(q, k, v, **kw)) \
            if with_lse else out

    t = _times(lambda: flash_attention_cuda(q, k, v, with_lse=with_lse,
                                            **kw),
               plain,
               lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, attn_mask=sdpa_mask, enable_gqa=True))
    return dict(t, bound_ms=bound, bound_by=by, gflop=n_ops / 1e9,
                shape=f"B={B} S={S} T={T} H={H} KV={KV} dh={dh} bf16"
                + ("" if causal else " non-causal")
                + (" lse" if with_lse else ""))


def _flash_train_timing(B=DENSE_BATCH, S=DENSE_SEQ, H=32, KV=8, dh=128, *,
                        causal=True):
    """The forward as training launches it under autograd (by default the
    dense shape, B 2, S 4096, H 32, KV 8, dh 128; bf16, causal unless
    ``causal`` is False, no q_offset or kv_len, writing the row
    log-sum-exp); its plain version is ``flash_attention_ref`` and
    ``flash_attention_lse_ref`` on the same inputs, the library
    ``F.scaled_dot_product_attention(is_causal=causal, enable_gqa=True)``.
    The bound: q, k, v read and the output and lse written once, or 4 x
    admissible pairs x H x dh operations at 989 TFLOP/s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(B, S, H, dh, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(B, S, KV, dh, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    pairs = S * (S + 1) // 2 if causal else S * S
    n_ops = 4 * B * pairs * H * dh
    n_bytes = 2 * (2 * B * S * H * dh + 2 * B * S * KV * dh) + 4 * B * S * H
    bound, by = _bound_ms(n_bytes, n_ops, "bfloat16")
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    t = _times(lambda: flash_attention_cuda(q, k, v, with_lse=True,
                                            causal=causal),
               lambda: (ref.flash_attention_ref(q, k, v, causal=causal),
                        ref.flash_attention_lse_ref(q, k, v, causal=causal)),
               lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, is_causal=causal, enable_gqa=True),
               iters=10, plain_iters=2)
    return dict(t, bound_ms=bound, bound_by=by, gflop=n_ops / 1e9,
                shape=f"B={B} S={S} H={H} KV={KV} dh={dh} "
                + ("causal" if causal else "non-causal") + " lse bf16")


def _flash_bwd_timing(B=DENSE_BATCH, S=DENSE_SEQ, H=32, KV=8, dh=128, *,
                      T=None, causal=True):
    """The backward at a training shape (by default the dense one, B 2, S
    4096, H 32, KV 8, dh 128; bf16, causal; ``T`` keys, S by default, and
    at S != T no mask: K14): the kernels on the forward's output and
    log-sum-exp, the plain version on the same, and the autograd backward
    of ``F.scaled_dot_product_attention(is_causal=causal,
    enable_gqa=True)`` as the library yardstick.  The bound: the five
    products (dV, dP, dQ, dK and the recomputed S) over the admissible
    pairs at 989 TFLOP/s, or each of q, k, v, o, dO, lse read and dq, dk,
    dv written once at 3.35 TB/s.  Phase 9's profile splits the time by
    kernel."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)

    T = S if T is None else T
    g = torch.Generator(device="cuda").manual_seed(10)
    q, do = (torch.randn(B, S, H, dh, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, T, KV, dh, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    kw = dict(causal=causal)
    out, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    # admissible pairs of one head: causal S == T, or every (query, key)
    pairs = S * (S + 1) // 2 if causal else S * T
    n_ops = 5 * 2 * B * H * pairs * dh
    n_bytes = 2 * 4 * B * S * H * dh + 2 * 4 * B * T * KV * dh + 4 * B * S * H
    bound, by = _bound_ms(n_bytes, n_ops, "bfloat16")
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    y = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                       enable_gqa=True)
    dys = do.transpose(1, 2)
    t = _times(lambda: flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw),
               lambda: ref.flash_attention_bwd_ref(q, k, v, out, do, lse,
                                                   **kw),
               lambda: torch.autograd.grad(y, (qs, ks, vs), dys,
                                           retain_graph=True),
               iters=5, plain_iters=2)
    shape = (f"B={B} S={S} H={H} KV={KV} dh={dh} causal bf16" if causal
             else f"B={B} S={S} T={T} H={H} KV={KV} dh={dh} non-causal bf16")
    parts = _kernel_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, do,
                                                        lse, **kw),
                       FLASH_BWD_KERNELS)[0]
    check(all(parts.values()), f"flash backward kernels without device "
          f"time: {parts}")
    log(f"[time] flash_attention_bwd {shape}: device ms by kernel "
        "(profiler, 5 calls, mean a launch): " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts.items()))
    return dict(t, bound_ms=bound, bound_by=by, gflop=n_ops / 1e9,
                shape=shape, ms_by_kernel=parts)


def _partial_timing(delta, S=SP_LOCAL, heads=(32, 8, 128)):
    """Ring attention's panel visit at the phase-8 shape (by default S_loc
    = T_loc = 8192, H 32, KV 8, dh 128; bf16, causal) for one ``delta``:
    the kernel,
    its plain version and, as the library yardstick, SDPA over the same
    admissible pairs; SDPA writes the normalised output, not the state.  The
    bound counts the q rows that admit some key read (a dead visit needs no
    q), the K/V rows some query admits read, and the fp32 state written;
    operations 4 x pairs x H x dh."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.ring_attention import flash_partial_cuda

    H, KV, dh = heads
    g = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn(1, S, H, dh, generator=g, device="cuda").bfloat16()
    k = torch.randn(1, S, KV, dh, generator=g, device="cuda").bfloat16()
    v = torch.randn(1, S, KV, dh, generator=g, device="cuda").bfloat16()
    mask = ref.attn_mask(1, S, S, q.device, causal=True, window=None,
                          q_offset=_i32([delta]), kv_len=None)
    pairs = mask.sum().item()
    keys = mask.any(1).sum().item()
    rows = mask.any(2).sum().item()     # query rows that admit a key
    n_bytes = (2 * rows * H * dh + 2 * 2 * keys * KV * dh
               + 4 * S * H * (dh + 2))
    n_ops = 4 * pairs * H * dh
    bound, by = _bound_ms(n_bytes, n_ops, "bfloat16")
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    if pairs == mask.numel():
        sdpa_kw, lib_mask = {}, "none (every pair admissible)"
    elif delta == 0:
        sdpa_kw, lib_mask = dict(is_causal=True), "is_causal"
    else:
        sdpa_kw, lib_mask = dict(attn_mask=mask[:, None]), "boolean mask"
    t = _times(lambda: flash_partial_cuda(q, k, v, delta, causal=True),
               lambda: ref.flash_partial_ref(q, k, v, delta, causal=True),
               lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, enable_gqa=True, **sdpa_kw),
               iters=10, plain_iters=2)
    return dict(t, bound_ms=bound, bound_by=by, delta=delta, pairs=pairs,
                library_mask=lib_mask, gflop=n_ops / 1e9,
                shape=f"S=T={S} H={H} KV={KV} dh={dh} delta={delta} bf16")


def _rmsnorm_timing(rows, d):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(rows, d, generator=g, device="cuda").bfloat16()
    w = torch.randn(d, generator=g, device="cuda").bfloat16()
    bound, by = _bound_ms(2 * (2 * rows * d + d), 4 * rows * d, "bfloat16")
    t = _times(lambda: rmsnorm_cuda(x, w, 1e-6),
               lambda: ref.rmsnorm_ref(x, w, 1e-6),
               lambda: F.rms_norm(x, (d,), w, 1e-6))
    return dict(t, bound_ms=bound, bound_by=by,
                shape=f"rows={rows} d={d} bf16")


def _host_us(fn, n=2000):
    """Host microseconds per call of ``fn`` over n back-to-back calls, the
    device drained before and after (host clock)."""
    import torch
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def _rmsnorm_host_costs():
    """What one decode-shape call costs the host, by piece, under
    inference mode as in serving, and the device time of an empty kernel
    (``torch.cuda._sleep(0)``) queued back to back: the floor under the
    decode shape's device ms."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm

    x = torch.randn(DECODE_SLOTS, 1, 2560, device="cuda").bfloat16()
    w = torch.randn(2560, device="cuda").bfloat16()
    dev = x.device
    pieces = {
        "rmsnorm_cuda": lambda: rmsnorm.rmsnorm_cuda(x, w, 1e-6),
        "RMSNorm.apply": lambda: rmsnorm.RMSNorm.apply(x, w, 1e-6),
        "F.rms_norm": lambda: F.rms_norm(x, (2560,), w, 1e-6),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream getter": lambda: rmsnorm._stream(0),
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "argument checks": lambda: rmsnorm._check("f", x, w),
    }
    with torch.inference_mode():
        out = {k: _host_us(fn) for k, fn in pieces.items()}
    out["empty kernel device ms"] = device_ms(lambda: torch.cuda._sleep(0),
                                              20)[0]
    log("[time] rmsnorm host us per call at 8 x 2560: " + ", ".join(
        f"{k} {v:.2f}" for k, v in out.items() if "device" not in k)
        + f"; empty kernel device ms {out['empty kernel device ms']:.5f}")
    return out


def _rmsnorm_bwd_timing(rows, d):
    """The backward alone: the kernel on (dy, x, w); the plain version and
    the library as the autograd backward of rmsnorm_ref / F.rms_norm."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(rows, d, generator=g, device="cuda").bfloat16()
    w = torch.randn(d, generator=g, device="cuda").bfloat16()
    dy = torch.randn(rows, d, generator=g, device="cuda").bfloat16()
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y_plain = ref.rmsnorm_ref(xg, wg, 1e-5)
    y_lib = F.rms_norm(xg, (d,), wg, 1e-5)
    # x and dy read, dx written, w read, dw written; about 10 operations an
    # element (x^2, x*rstd, w*dy, the two sums, dx, dw)
    bound, by = _bound_ms(2 * (3 * rows * d + 2 * d), 10 * rows * d,
                          "bfloat16")
    t = _times(lambda: rmsnorm_bwd_cuda(dy, x, w, 1e-5),
               lambda: torch.autograd.grad(y_plain, (xg, wg), dy,
                                           retain_graph=True),
               lambda: torch.autograd.grad(y_lib, (xg, wg), dy,
                                           retain_graph=True))
    return dict(t, bound_ms=bound, bound_by=by,
                shape=f"rows={rows} d={d} bf16")


def _ssd_timing(B, S, H, P, N, Q, *, bwd=True):
    """Forward and (with ``bwd``) backward at one shape in bf16; the plain
    backward is the autograd backward of ssd_scan_ref.  No single PyTorch
    call computes the scan, so there is no library time."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda

    leaves, views = ssd_inputs(B, S, H, P, N, torch.bfloat16, seed=5)
    with torch.no_grad():
        args = [t.detach() for t in views(*leaves)]
    fwd_ops, bwd_ops = _ssd_ops(B, S, H, P, N, Q)
    # bytes of the distinct elements: x, y (dx), dt (ddt); B and C (dB,
    # dC) once per batch and position: one group for all heads
    seq = 2 * B * S * H * P + 4 * B * S * H + 2 * 2 * B * S * N + 4 * H
    shape = f"B={B} S={S} H={H} P={P} N={N} chunk={Q} bf16"
    fwd_bound, fwd_by = _bound_ms(seq + 2 * B * S * H * P, fwd_ops,
                                  "bfloat16")
    fwd = _times(lambda: ssd_scan_cuda(*args, Q),
                 lambda: ref.ssd_scan_ref(*args, Q), None, iters=10,
                 plain_iters=3)
    fwd_parts, names = _kernel_ms(lambda: ssd_scan_cuda(*args, Q),
                                  SSD_FWD_KERNELS)
    check(all(fwd_parts[k] > 0 for k in SSD_FWD_KERNELS)
          and not any("ssd_bwd_" in k for k in names),
          f"the bf16 SSD forward launched {names}, not the three "
          f"{SSD_FWD_KERNELS} alone")
    log(f"[time] ssd_scan        {shape}: device ms by kernel (profiler, "
        "5 calls, mean a launch): " + ", ".join(
            f"{k} {v:.4f}" for k, v in fwd_parts.items()))
    fwd = dict(fwd, bound_ms=fwd_bound, bound_by=fwd_by, shape=shape,
               gflop=fwd_ops / 1e9, ms_by_kernel=fwd_parts)
    if not bwd:
        return fwd, None
    dy = torch.randn(B, S, H, P, device="cuda").bfloat16()
    y_plain = ref.ssd_scan_ref(*views(*leaves), Q)
    bwd_bound, bwd_by = _bound_ms(2 * seq + 2 * B * S * H * P, bwd_ops,
                                  "bfloat16")
    bwd = _times(lambda: ssd_scan_bwd_cuda(dy, *args, Q),
                 lambda: torch.autograd.grad(y_plain, leaves, dy,
                                             retain_graph=True), None,
                 iters=5, plain_iters=3)
    parts = _ssd_bwd_parts(lambda: ssd_scan_bwd_cuda(dy, *args, Q))
    log(f"[time] ssd_scan_bwd    {shape}: device ms by kernel (profiler, "
        "5 calls, mean a launch): " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts.items()))
    return fwd, dict(bwd, bound_ms=bwd_bound, bound_by=bwd_by, shape=shape,
                     gflop=bwd_ops / 1e9, ms_by_kernel=parts)


def _kernel_ms(call, names, n=5, sessions=3):
    """Device ms per call of each kernel whose name holds one of ``names``
    (profiler over ``n`` calls, each launching it once: its device time over
    the launches the profiler recorded), and the names of every kernel the
    calls launched.  A session that records none of some kernel's launches
    (the profiler loses device events now and then) is run again, up to
    ``sessions`` in all; the last one's times are returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]

        def mean_ms(k):
            hits = [e for e in events if k in e.key]
            count = sum(e.count for e in hits)
            return (sum(e.self_device_time_total for e in hits) / 1e3
                    / max(count, 1))
        times = {k: mean_ms(k) for k in names}
        if all(times.values()):
            break
        log(f"[time] a profiler session recorded no device time of "
            f"{[k for k, v in times.items() if not v]}; profiling again")
    return times, [e.key for e in events]


def _ssd_bwd_parts(call):
    """Device ms per call of each bf16 SSD backward kernel (profiler), and
    of the chunk-grad kernel built without its dB/dC stores; their
    difference is what writing each head's terms costs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as mod

    parts = _kernel_ms(call, SSD_BWD_KERNELS)[0]
    lib, variant = mod._lib, _build.load("ssd_scan", NO_ADDS)
    for fn, argtypes in ((variant.ssd_scan_fwd, mod.FWD_ARGTYPES),
                         (variant.ssd_scan_bwd, mod.BWD_ARGTYPES)):
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    mod._lib = lambda: variant
    try:
        grad = _kernel_ms(call, SSD_BWD_KERNELS)[0][SSD_BWD_KERNELS[2]]
    finally:
        mod._lib = lib
    parts["chunk_grad_without_dbdc_stores"] = grad
    parts["dbdc_stores"] = parts[SSD_BWD_KERNELS[2]] - grad
    return parts


def phase_timings():
    """Phase 7's measurements: [(name, route, source, replaces, main shape,
    {shape: times})] and the host costs of a decode-shape RMSNorm call.

    It runs before every other phase that profiles: a torch.profiler
    session in a process whose first session lies far behind, in time or
    in kernels launched since, loses device events (on an H100, a session
    of 5 kernels recorded 5, then 4, 3 and 1 of them after 1.1, 3.1 and
    6.1 M launches, within a minute), and the short sessions of
    :func:`_kernel_ms` may then find none."""
    decode_L = [300] * DECODE_SLOTS
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ssd_fwd, ssd_bwd = _ssd_timing(TRAIN_BATCH, TRAIN_SEQ, 32, 64, 128, 64)
    zamba2_ssd = _ssd_timing(2, 2048, 64, 64, 64, 64, bwd=False)[0]
    # phase 17: a rank's mamba2 layer at tp 2 (half the heads)
    tp_fwd, tp_bwd = _ssd_timing(SSMTP_LOCAL_BATCH, SSMTP_SEQ, 16, 64, 128,
                                 64)
    table = [
        ("flash_attention", "cuda", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:143", "decode", {
             "decode": _flash_timing(DECODE_SLOTS, 1, MAX_CONTEXT, decode_L,
                                     [MAX_CONTEXT] * DECODE_SLOTS),
             "prefill": _flash_timing(PREFILL_BATCH, PREFILL_CHUNK,
                                      MAX_CONTEXT, [256] * PREFILL_BATCH,
                                      [384] * PREFILL_BATCH),
             "dense_train": _flash_train_timing(),
             # phase 12: zamba2's shared block, decode over 8 lanes of a
             # 2048-token cache and the causal prefill of 2 x 2048
             "zamba2_decode": _flash_timing(
                 DENSE_SERVE_LANES, 1, DENSE_SERVE_CONTEXT, None,
                 [16, 100, 300, 700, 1024, 1500, 2000, 2048], causal=False,
                 heads=ZAMBA2_HEADS),
             "zamba2_prefill": _flash_timing(2, 2048, 2048, [0, 0],
                                             [2048, 2048],
                                             heads=ZAMBA2_HEADS),
             # phase 17: a rank's shared block under autograd at tp 2
             "zamba2_tp_train": _flash_train_timing(
                 SSMTP_LOCAL_BATCH, SSMTP_SEQ, *ZAMBA2_TP_HEADS),
             # phase 18: a rank's context slice of the dense engine's
             # decode (4 lanes, 1024 of 2048 slots, writing the row
             # log-sum-exp) and the TP-local paged decode (H 16, KV 4)
             "ctx_slice_decode": _flash_timing(
                 DENSE_SERVE_LANES // SERVE_SHARD_MESH[0], 1,
                 DENSE_SERVE_CONTEXT // SERVE_SHARD_MESH[1], None,
                 [0, 300, 700, 1024], causal=False, with_lse=True),
             "tp_paged_decode": _flash_timing(
                 DECODE_SLOTS, 1, MAX_CONTEXT, decode_L,
                 [MAX_CONTEXT] * DECODE_SLOTS,
                 heads=(32 // SERVE_SHARD_MESH[1], 8 // SERVE_SHARD_MESH[1],
                        128)),
             # phase 19: arctic-480b's paged decode and prefill (H 56,
             # KV 8, dh 128)
             "arctic_decode": _flash_timing(
                 DECODE_SLOTS, 1, MAX_CONTEXT, decode_L,
                 [MAX_CONTEXT] * DECODE_SLOTS, heads=ARCTIC_HEADS),
             "arctic_prefill": _flash_timing(
                 PREFILL_BATCH, PREFILL_CHUNK, MAX_CONTEXT,
                 [256] * PREFILL_BATCH, [384] * PREFILL_BATCH,
                 heads=ARCTIC_HEADS),
             # phase 20: a TP rank's paged decode (H 14, KV 2)
             "arctic_tp_decode": _flash_timing(
                 DECODE_SLOTS, 1, MAX_CONTEXT, decode_L,
                 [MAX_CONTEXT] * DECODE_SLOTS, heads=ARCTIC_TP_HEADS),
             # phase 21: kimi-k2's paged decode and prefill chunk (H 64,
             # KV 8, dh 112), and its causal training shape under autograd
             "kimi_decode": _flash_timing(
                 DECODE_SLOTS, 1, MAX_CONTEXT, decode_L,
                 [MAX_CONTEXT] * DECODE_SLOTS, heads=KIMI_HEADS),
             "kimi_prefill": _flash_timing(
                 PREFILL_BATCH, PREFILL_CHUNK, MAX_CONTEXT,
                 [256] * PREFILL_BATCH, [384] * PREFILL_BATCH,
                 heads=KIMI_HEADS),
             "kimi_train": _flash_train_timing(*KIMI_TRAIN, *KIMI_HEADS),
             # phase 22: whisper-medium's encoder (8 x 1500, non-causal)
             # and cross-attention decode (8 queries over 1500 rows)
             "whisper_encoder": _flash_timing(
                 WHISPER_LANES, WHISPER_FRAMES, WHISPER_FRAMES, None,
                 [WHISPER_FRAMES] * WHISPER_LANES, causal=False,
                 heads=WHISPER_HEADS),
             "whisper_cross_decode": _flash_timing(
                 WHISPER_LANES, 1, WHISPER_FRAMES, None,
                 [WHISPER_FRAMES] * WHISPER_LANES, causal=False,
                 heads=WHISPER_HEADS),
             # phase 24: a TP rank's encoder self-attention under autograd
             # (B 4, S = T 1500, H = KV = 8, dh 64, non-causal, with lse)
             "whisper_tp_train": _flash_train_timing(
                 WHISPER_TP_LOCAL[0], WHISPER_FRAMES, *WHISPER_TP_LOCAL[1:],
                 causal=False),
             # phase 25: internvl2-26b's paged decode (H 48, KV 8, dh 128)
             # and its causal training shape under autograd (B 1, S 256 +
             # 4096)
             "internvl2_decode": _flash_timing(
                 DECODE_SLOTS, 1, MAX_CONTEXT, decode_L,
                 [MAX_CONTEXT] * DECODE_SLOTS, heads=VLM_HEADS),
             "internvl2_train": _flash_train_timing(*VLM_TRAIN_ATTN),
             # phase 26: qwen2.5-14b's paged decode (H 40, KV 8, dh 128: a
             # GQA group of 5) and its causal training shape (B 1, S 4096)
             "qwen2_5_14b_decode": _flash_timing(
                 DECODE_SLOTS, 1, MAX_CONTEXT, decode_L,
                 [MAX_CONTEXT] * DECODE_SLOTS, heads=QWEN_HEADS[QWEN2_5_14B]),
             "qwen2_5_14b_train": _flash_train_timing(*QWEN_TRAIN_ATTN)}),
        ("rmsnorm", "cuda", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm.py:33", "decode", {
             "decode": _rmsnorm_timing(DECODE_SLOTS, 2560),
             # phase 12's decode rows: mamba2's ln1 and gated norm (1024,
             # 2048), zamba2's ln1 and gated norm (2048, 4096)
             "ssm_decode_1024": _rmsnorm_timing(DECODE_SLOTS, 1024),
             "ssm_decode_2048": _rmsnorm_timing(DECODE_SLOTS, 2048),
             "ssm_decode_4096": _rmsnorm_timing(DECODE_SLOTS, 4096),
             "prefill": _rmsnorm_timing(PREFILL_BATCH * PREFILL_CHUNK, 2560),
             "prefill_qk": _rmsnorm_timing(
                 PREFILL_BATCH * PREFILL_CHUNK * 32, 128),
             "sp_q_norm": _rmsnorm_timing(SP_LOCAL * 32, 128),
             "train": _rmsnorm_timing(tokens, 1024),
             "train_gated": _rmsnorm_timing(tokens, 2048),
             # phase 19: arctic-480b's rows
             "arctic_decode": _rmsnorm_timing(DECODE_SLOTS, 7168),
             "arctic_prefill": _rmsnorm_timing(
                 PREFILL_BATCH * PREFILL_CHUNK, 7168),
             # phase 25: internvl2-26b's decode and training rows
             "internvl2_decode": _rmsnorm_timing(VLM_NORM_ROWS[0], 6144),
             "internvl2_train": _rmsnorm_timing(VLM_NORM_ROWS[1], 6144),
             # phase 26: qwen2.5-14b's decode and training rows (d 5120),
             # qwen2-72b's decode rows (d 8192)
             **{f"qwen2_{rows}x{d}": _rmsnorm_timing(rows, d)
                for rows, d in QWEN_NORM_FWD}}),
        ("rmsnorm_bwd", "cuda", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm.py:33", "train", {
             "train": _rmsnorm_bwd_timing(tokens, 1024),
             "train_gated": _rmsnorm_bwd_timing(tokens, 2048),
             "dense_k_norm": _rmsnorm_bwd_timing(
                 DENSE_BATCH * DENSE_SEQ * 8, 128),
             "dense_q_norm": _rmsnorm_bwd_timing(
                 DENSE_BATCH * DENSE_SEQ * 32, 128),
             # phase 25: internvl2-26b's training rows
             "internvl2_train": _rmsnorm_bwd_timing(VLM_NORM_ROWS[1],
                                                    6144),
             # phase 26: qwen2.5-14b's training rows; qwen2-72b's width
             # over as many
             "qwen2_5_14b_train": _rmsnorm_bwd_timing(*QWEN_NORM_BWD),
             "qwen2_72b_train": _rmsnorm_bwd_timing(*QWEN72_NORM_BWD)}),
        ("ssd_scan", "cuda", "src/repro_torch/csrc/ssd_scan.cu",
         "src/repro/kernels/ssd_scan.py:72", "train",
         {"train": ssd_fwd, "zamba2_prefill": zamba2_ssd,
          "mamba2_tp_local": tp_fwd}),
        ("ssd_scan_bwd", "cuda", "src/repro_torch/csrc/ssd_scan.cu",
         "src/repro/kernels/ssd_scan.py:72", "train",
         {"train": ssd_bwd, "mamba2_tp_local": tp_bwd}),
        ("flash_attention_bwd", "cuda",
         "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:143", "train",
         {"train": _flash_bwd_timing(),
          "zamba2_tp_train": _flash_bwd_timing(
              SSMTP_LOCAL_BATCH, SSMTP_SEQ, *ZAMBA2_TP_HEADS),
          "kimi_train": _flash_bwd_timing(*KIMI_TRAIN, *KIMI_HEADS),
          # phase 24: a TP rank's encoder self-attention
          "whisper_tp_train": _flash_bwd_timing(
              WHISPER_TP_LOCAL[0], WHISPER_FRAMES, *WHISPER_TP_LOCAL[1:],
              causal=False),
          # phase 25: internvl2-26b's causal training shape
          "internvl2_train": _flash_bwd_timing(*VLM_TRAIN_ATTN),
          # phase 26: qwen2.5-14b's causal training shape (G = 5)
          "qwen2_5_14b_train": _flash_bwd_timing(*QWEN_TRAIN_ATTN)}),
        # K14: the backward at S != T, phase 23's cross-attention (its
        # launches are also among flash_attention_bwd's)
        ("flash_attention_bwd_cross", "cuda",
         "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:143", "whisper_cross_train",
         {"whisper_cross_train": _flash_bwd_timing(
             WHISPER_LANES, WHISPER_CONTEXT, *WHISPER_HEADS,
             T=WHISPER_FRAMES, causal=False),
          # phase 24: a TP rank's cross-attention (B 4, S 448, T 1500,
          # H = KV = 8, dh 64)
          "whisper_tp_cross_train": _flash_bwd_timing(
              WHISPER_TP_LOCAL[0], WHISPER_CONTEXT, *WHISPER_TP_LOCAL[1:],
              T=WHISPER_FRAMES, causal=False)}),
        ("flash_partial", "cuda", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/ring_attention.py:110", "visible", {
             "diagonal": _partial_timing(0),
             "visible": _partial_timing(SP_LOCAL),
             "dead": _partial_timing(-SP_LOCAL),
             # kimi-k2's heads: a visible panel of 4096 local keys
             "kimi_visible": _partial_timing(KIMI_TRAIN[1], S=KIMI_TRAIN[1],
                                             heads=KIMI_HEADS)}),
    ]
    return table, _rmsnorm_host_costs()


def kernel_entries(timed, errs, launches, dense_decode):
    """The ``kernels`` JSON line's entries, and a ``[time]`` line a shape:
    ``timed`` from :func:`phase_timings`, ``launches`` {path: {kernel:
    count}} read after each path's run, ``dense_decode`` phase 11's flash
    times at the dense engine's decode shape."""
    table, host = timed
    kernels = []
    for name, route, source, replaces, main_shape, by_shape in table:
        if name == "flash_attention":
            by_shape["dense_decode"] = dense_decode
        by_path = {path: counts.get(name, 0)
                   for path, counts in launches.items()}
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": errs[name],
            **{k: by_shape[main_shape][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shapes": by_shape,
            **({"host_us_decode": host} if name == "rmsnorm" else {}),
        })
        for shape, t in by_shape.items():
            lib = ("-" if t["library_ms"] is None else
                   f"{t['library_ms']:.4f} ({t['library_launch_ms']:.4f})")
            untimed = [k for k, v in t["device_timed"].items() if not v]
            # achieved TFLOP/s of the operations the bound counts
            rate = "" if "gflop" not in t else (
                f"  achieved TFLOP/s: kernel {t['gflop'] / t['ms']:.2f}" + (
                    "" if t["library_ms"] is None else
                    f", library {t['gflop'] / t['library_ms']:.2f}"))
            log(f"[time] {name:15s} {shape:11s} {t['shape']:40s} device ms "
                f"(per launch): kernel {t['ms']:.4f} ({t['launch_ms']:.4f})"
                f"  plain {t['plain_ms']:.4f} ({t['plain_launch_ms']:.4f})"
                f"  library {lib}  bound {t['bound_ms']:.5f} "
                f"({t['bound_by']})" + rate
                + (f"; not queued, timed per launch: {', '.join(untimed)}"
                   if untimed else ""))
    return kernels


# run in each tree by compare_flash_bwd: the sha256 of the flash
# backward's dq, dk and dv bytes at S == T on seeded inputs, through the
# wrappers' interface, which the parent shares: the dense training shape
# (bf16, causal) and the S = 100 cases of phase 2 in both dtypes at dh 64,
# 112 and 128
_BWD_DIGEST_CODE = """
def _bwd_digests():
    import hashlib
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    cases = [("bfloat16", 2, 4096, 32, 8, 128, True, None)]
    for dtype in ("bfloat16", "float32"):
        for dh in (64, 112, 128):
            for H, KV in ((2, 2), (10, 2), (16, 2)):
                for causal, window in ((True, None), (False, None),
                                       (True, 8), (False, 8)):
                    cases.append((dtype, 2, 100, H, KV, dh, causal, window))
    out = {}
    for i, (dtype, B, S, H, KV, dh, causal, window) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(i)
        dt = getattr(torch, dtype)
        q, do = (torch.randn(B, S, H, dh, generator=g, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, S, KV, dh, generator=g, device="cuda").to(dt)
                for _ in range(2))
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
        h = hashlib.sha256()
        for t in flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        out[f"{dtype} B={B} S={S} H={H} KV={KV} dh={dh} causal={causal} "
            f"window={window}"] = h.hexdigest()
    return out
"""


def compare_flash_bwd(parent: str) -> int:
    """The bf16 flash backward at the dense training shape timed by
    ``_flash_bwd_timing`` of the parent checkout at ``parent`` and of this
    one, in turn parent, this, this, parent, each in a process of its own
    that first builds that tree's kernels (``phase_build``), with the
    digests of its S == T outputs (``_BWD_DIGEST_CODE``), which must be
    the same in every run: a change that leaves self-attention alone keeps
    its bits.  Prints one JSON line per run; returns 1 if a run fails or
    the digests differ."""
    code = ("import json, sys; sys.path[:0] = ['.', 'src']; "
            "import chip_smoke as cs; cs.phase_build(); "
            + _BWD_DIGEST_CODE + "\n"
            "t = cs._flash_bwd_timing(); print('RESULT ' + json.dumps("
            "{**{k: t.get(k) for k in ('ms', 'launch_ms', 'library_ms', "
            "'bound_ms', 'ms_by_kernel')}, 'digests': _bwd_digests()}))")
    digests = []
    for name, tree in (("parent", parent), ("this", str(ROOT)),
                       ("this", str(ROOT)), ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if res.returncode != 0 or not lines:
            print(f"chip_smoke: {name} tree failed:\n{res.stdout[-3000:]}"
                  f"\n{res.stderr[-3000:]}", file=sys.stderr)
            return 1
        out = json.loads(lines[-1][len("RESULT "):])
        digests.append(out.pop("digests"))
        log(json.dumps({"tree": name, "path": tree, **out}))
    differ = sorted(k for k in digests[0]
                    if len({d.get(k) for d in digests}) != 1)
    log(f"[compare-flash-bwd] {len(digests[0])} S == T cases: dq, dk, dv "
        f"the same bits in every run of both trees: {not differ}"
        + (f"; they differ at {differ}" if differ else ""))
    return 1 if differ else 0


# the shapes compare_rmsnorm times and checks (rows, d), bf16: the wide
# rows of the models (decode's 8, arctic-480b's prefill chunk, the
# training steps of qwen2.5-14b, internvl2-26b and qwen2-72b's width), and
# the register bodies' decode and training shapes, which must not change
NORM_CMP_FWD = [(DECODE_SLOTS, d) for d in WIDE_NORM_D] + [
    (PREFILL_BATCH * PREFILL_CHUNK, 7168), QWEN_NORM_FWD[1],
    (VLM_NORM_ROWS[1], 6144), (DECODE_SLOTS, 2560),
    (TRAIN_BATCH * TRAIN_SEQ, 1024)]
NORM_CMP_BWD = [QWEN_NORM_BWD, (VLM_NORM_ROWS[1], 6144), QWEN72_NORM_BWD,
                (TRAIN_BATCH * TRAIN_SEQ, 1024)]
NORM_CMP_DIR = ROOT / "build" / "compare_rmsnorm"
# the profiled steps of phases 25 and 26 whose RMSNorm device ms
# compare_rmsnorm --steps reads
NORM_CMP_STEPS = ("[vlm] (a) paged decode", "internvl2 train",
                  "[qwen2] (b) paged decode", "qwen2.5-14b train")

# run in each tree by compare_rmsnorm, through the wrappers' interface,
# which the parent shares: each output of the forward and the backward on
# seeded bf16 inputs at each shape, as the sha256 of its bytes, and every
# 64th row of y and dx with all of dw, saved to ``path`` for the tolerance
# between trees
_NORM_OUT_CODE = """
def _norm_outputs(fwd, bwd, path):
    import hashlib
    import torch
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
    digests, kept = {}, {}
    cases = [("fwd", r, d) for r, d in fwd] + [("bwd", r, d) for r, d in bwd]
    for i, (kind, rows, d) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        x = (torch.randn(rows, d, generator=g, device="cuda") * 2).bfloat16()
        w = torch.randn(d, generator=g, device="cuda").bfloat16()
        if kind == "fwd":
            outs = (rmsnorm_cuda(x, w, 1e-6),)
        else:
            dy = torch.randn(rows, d, generator=g, device="cuda").bfloat16()
            outs = rmsnorm_bwd_cuda(dy, x, w, 1e-5)
        key = f"{kind} {rows}x{d}"
        h = hashlib.sha256()
        for t in outs:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        digests[key] = h.hexdigest()
        kept[key] = [(t[::64] if t.dim() == 2 else t).float().cpu()
                     for t in outs]
    torch.save(kept, path)
    return digests
"""


def _norm_tree_run(tree, path):
    """One run of compare_rmsnorm in ``tree``: the build, the phase-7
    timings of both directions at NORM_CMP_FWD and NORM_CMP_BWD, then the
    outputs (``_NORM_OUT_CODE``).  Returns the RESULT dict, or None."""
    code = ("import json, sys; sys.path[:0] = ['.', 'src']; "
            "import chip_smoke as cs; cs.phase_build(); "
            + _NORM_OUT_CODE + "\n"
            f"fwd, bwd = {NORM_CMP_FWD!r}, {NORM_CMP_BWD!r}\n"
            "t = {f'fwd {r}x{d}': cs._rmsnorm_timing(r, d) for r, d in fwd}\n"
            "t.update({f'bwd {r}x{d}': cs._rmsnorm_bwd_timing(r, d) "
            "for r, d in bwd})\n"
            f"dig = _norm_outputs(fwd, bwd, {str(path)!r})\n"
            "print('RESULT ' + json.dumps({'ms': {k: v['ms'] for k, v in "
            "t.items()}, 'library_ms': {k: v['library_ms'] for k, v in "
            "t.items()}, 'bound_ms': {k: v['bound_ms'] for k, v in "
            "t.items()}, 'digests': dig}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    if res.returncode != 0 or not lines:
        print(f"chip_smoke: {tree} failed:\n{res.stdout[-3000:]}\n"
              f"{res.stderr[-3000:]}", file=sys.stderr)
        return None
    return json.loads(lines[-1][len("RESULT "):])


def _norm_close(a, b) -> bool:
    """Two trees' outputs of one case agree: y within two bf16 ulps of each
    other, elementwise (each is within one of rmsnorm_ref); dx and dw
    within REL_TOL of the larger magnitude (fp32 sums in another order)."""
    import torch
    if len(a) == 1:
        ulp = torch.exp2(torch.floor(torch.log2(
            b[0].abs().clamp_min(1e-30))) - 7)
        return bool(((a[0] - b[0]).abs() <= 2 * ulp).all())
    return all(rel_err(x, y) <= REL_TOL["bfloat16"] for x, y in zip(a, b))


def _norm_steps(tree, name):
    """Phases 25 and 26 in ``tree`` with RMSNorm's device time sorted into
    forward and backward (KERNEL_CATEGORIES as here): {step: (busy ms,
    forward ms, backward ms)} of NORM_CMP_STEPS, or None."""
    code = ("import sys; sys.path[:0] = ['.']; import chip_smoke as cs; "
            f"cs.KERNEL_CATEGORIES = {KERNEL_CATEGORIES!r}; "
            "sys.argv = ['chip_smoke.py', '--phases', '25,26']; "
            "sys.exit(cs.main())")
    res = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=1500)
    NORM_CMP_DIR.mkdir(parents=True, exist_ok=True)
    (NORM_CMP_DIR / f"steps_{name}.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        print(f"chip_smoke: phases 25, 26 failed in {tree}:\n"
              f"{res.stderr[-3000:]}", file=sys.stderr)
        return None
    out = {}
    for ln in res.stdout.splitlines():
        m = re.match(r"\[profile\] (.*?) step: device busy ([\d.]+) ms.*?"
                     r"rmsnorm_fwd ([\d.]+), rmsnorm_bwd ([\d.]+)", ln)
        if m and m.group(1) in NORM_CMP_STEPS:
            out[m.group(1)] = tuple(float(m.group(i)) for i in (2, 3, 4))
    return out


def compare_rmsnorm(parent: str, steps: bool) -> int:
    """RMSNorm's kernels of the parent checkout at ``parent`` and of this
    one at NORM_CMP_FWD and NORM_CMP_BWD, timed by ``_rmsnorm_timing`` and
    ``_rmsnorm_bwd_timing`` in turn parent, this, this, parent, each in a
    process of its own that first builds that tree's kernels
    (``phase_build``).  One JSON line a run.  Each run also keeps its
    outputs on seeded inputs (``_NORM_OUT_CODE``): a tree's two runs must
    give the same bits; the two trees' must agree within
    :func:`_norm_close` (the wide rows sum in another order) and, at the
    register bodies' shapes (d <= 2560), be the same bits.  With ``steps``,
    phases 25 and 26 then run in the parent and in this tree, and their
    profiled steps' RMSNorm forward and backward device ms are printed.
    Returns 1 if a run fails or a check does not hold."""
    import torch

    NORM_CMP_DIR.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, (name, tree) in enumerate((("parent", parent), ("this", str(ROOT)),
                                      ("this", str(ROOT)),
                                      ("parent", parent))):
        path = NORM_CMP_DIR / f"run{i}.pt"
        out = _norm_tree_run(tree, path)
        if out is None:
            return 1
        runs.append((name, out.pop("digests"), torch.load(path)))
        log(json.dumps({"tree": name, "path": tree, **out}))
    ok = True
    for a, b in ((0, 3), (1, 2)):
        differ = [k for k in runs[a][1] if runs[a][1][k] != runs[b][1][k]]
        log(f"[compare-rmsnorm] {runs[a][0]}: its two runs the same bits: "
            f"{not differ}" + (f"; they differ at {differ}" if differ else ""))
        ok = ok and not differ
    for key in runs[0][1]:
        d = int(key.split("x")[1])
        if d <= 2560:
            same = runs[0][1][key] == runs[1][1][key]
            log(f"[compare-rmsnorm] {key} (a register body): this tree's "
                f"bits the parent's: {same}")
            ok = ok and same
        else:
            close = _norm_close(runs[1][2][key], runs[0][2][key])
            log(f"[compare-rmsnorm] {key}: this tree within the tolerance "
                f"of the parent: {close}")
            ok = ok and close
    if steps:
        for name, tree in (("parent", parent), ("this", str(ROOT))):
            found = _norm_steps(tree, name)
            if found is None:
                return 1
            log(json.dumps({"tree": name, "steps": {
                k: dict(zip(("busy_ms", "rmsnorm_fwd_ms", "rmsnorm_bwd_ms"),
                            v)) for k, v in found.items()}}))
            ok = ok and len(found) == len(NORM_CMP_STEPS)
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# phase 27: the dry run beside the card's own ranks
# ---------------------------------------------------------------------------

DRY_DIR = ROOT / "build" / "dry"
DRY_TIMEOUT_S = 300
# (a) one row for each arch on the 256-card production mesh, at the shape
# its family stresses; the jobs are dealt by hand over the pool's four
# processes, the two 61- and 80-layer training rows alone, so that the
# phase takes about as long as its longest row: (b)'s dry run of phase
# 16's step ("shard") and (d)'s of phase 9's ("dense") ride along
DRY_JOBS = [
    [("row", "kimi-k2-1t-a32b", "train_4k")],
    [("row", "qwen2-72b", "train_4k")],
    [("row", "qwen3-4b", "train_4k"), ("dense",),
     ("row", "whisper-medium", "prefill_32k")],
    [("shard",), ("row", "arctic-480b", "prefill_32k"),
     ("row", "internvl2-26b", "decode_32k"),
     ("row", "qwen2.5-14b", "prefill_32k"), ("row", "qwen3-8b", "decode_32k"),
     ("row", "zamba2-1.2b", "long_500k"),
     ("row", "mamba2-370m", "long_500k")],
]


def _dry_policy():
    from repro_torch.runtime import ShardPolicy
    return ShardPolicy(tp=True, zero=True, remat_segments=(True,))


def dry_rank(rank, run_dir):
    """Phase 27: this pool process's share of DRY_JOBS, on the host's CPU
    (``meta`` tensors: no card, no process group); saves the results."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.common import InputShape

    out = []
    for job in DRY_JOBS[rank]:
        t0 = time.perf_counter()
        if job[0] == "row":
            res = dryrun.run_one(job[1], job[2], verbose=False)
        elif job[0] == "shard":
            c = dryrun.dry_step(
                _shard_cfg(), InputShape("shard", SHARD_SEQ, SHARD_BATCH,
                                         "train"),
                {"data": SHARD_MESH[0], "model": SHARD_MESH[1]},
                policy=_dry_policy())
            res = {"bytes_sent": c.traffic.bytes_sent,
                   "per_op": c.traffic.per_op, "param_bytes": c.param_bytes,
                   "optimizer_bytes": c.optimizer_bytes,
                   "input_bytes": c.input_bytes,
                   "argument_bytes": c.argument_bytes}
        else:
            res = dryrun.dry_row(
                get_config("qwen3-4b").with_(n_layers=DENSE_LAYERS),
                InputShape("dense_train", DENSE_SEQ, DENSE_BATCH, "train"),
                {"data": 1, "model": 1}, arch="qwen3-4b",
                policy=_dry_policy())
        out.append({"job": job, "s": time.perf_counter() - t0,
                    "result": res})
    pathlib.Path(f"{run_dir}/dry{rank}.json").write_text(json.dumps(out))


def dry_shard_rank(rank, world, run_dir):
    """Phase 27 without phase 16 (``--phases 27``): one of phase 16's
    ranks on the card, its one step, the bytes it sent and holds."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.runtime import init_train_state, make_train_step

    torch.cuda.set_device(0)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{run_dir}/rendezvous",
                     timeout_s=SHARD_TIMEOUT_S)
    try:
        cfg, pol = _shard_cfg(), _dry_policy()
        mesh = make_local_mesh(SHARD_MESH[1])
        params, opt = init_train_state(cfg, mesh=mesh, policy=pol, seed=0,
                                       device="cuda")
        step = make_train_step(cfg, mesh=mesh, policy=pol)
        batch = _shard_batches(cfg)[0]
        counts = _zero_counts()
        step(params, opt, batch)
        torch.cuda.synchronize()
        t = step.shard.traffic
        res = dict(_held_bytes(params, opt, step.shard.local_batch(
            batch, torch.device("cuda"))), bytes_sent=t.bytes_sent,
            per_op=dict(t.per_op), launches=counts())
        pathlib.Path(f"{run_dir}/shard{rank}.json").write_text(
            json.dumps(res))
    finally:
        dist.destroy_process_group()


def phase_dry_run():
    """Phase 27: (a) the dry run's production rows, (b) and (c) its bytes
    against phase 16's ranks, to the byte, (d) its one-card row beside
    phase 9's measured step, printed only."""
    t_phase = time.perf_counter()
    shutil.rmtree(DRY_DIR, ignore_errors=True)
    DRY_DIR.mkdir(parents=True)
    spawn_ranks(dry_rank, (str(DRY_DIR),), len(DRY_JOBS), "dry-run jobs",
                timeout_s=DRY_TIMEOUT_S)
    done = {}
    for r in range(len(DRY_JOBS)):
        for item in json.loads((DRY_DIR / f"dry{r}.json").read_text()):
            done[tuple(item["job"])] = item
    jobs_s = time.perf_counter() - t_phase
    log(f"[dry] {len(done)} dry runs on the host's CPU in {jobs_s:.1f} s "
        "(4 processes); seconds by job " + json.dumps(
            {" ".join(k): round(v["s"], 1) for k, v in done.items()}))

    # (a) the production rows
    for job in (j for group in DRY_JOBS for j in group if j[0] == "row"):
        row = done[job]["result"]
        terms = (row["t_compute_s"], row["t_memory_s"],
                 row["t_collective_s"])
        check(all(math.isfinite(t) and t >= 0 for t in terms)
              and row["hlo_flops"] > 0 and row["collective_bytes"] > 0,
              f"(a) {job}: {row}")
        check(row["bottleneck"] in ("compute", "memory", "collective"),
              f"(a) {job}: bottleneck {row['bottleneck']}")
        log(f"[dry] (a) {row['arch']} {row['shape']} on {row['mesh']} "
            f"({row['chips']} cards): bottleneck {row['bottleneck']}; "
            f"t_compute {row['t_compute_s']:.6f} s, t_memory "
            f"{row['t_memory_s']:.6f} s (modeled; unfused "
            f"{row['t_memory_unfused_s']:.6f}), t_collective "
            f"{row['t_collective_s']:.6f} s; modeled_fits_80g "
            f"{row['modeled_fits_80g']} (resident "
            f"{row['modeled_resident_bytes_per_device'] / 1e9:.2f} GB); "
            f"useful {row['useful_flops_ratio']:.3f}; per-opcode bytes a "
            f"card {row['per_op_collectives']}; argument "
            f"{row['memory']['argument_bytes'] / 1e9:.3f} GB, temp "
            f"{row['memory']['temp_bytes'] / 1e9:.3f} GB a card")

    # (b), (c): phase 16's ranks, or this phase's own run of that step
    dry = done[("shard",)]["result"]
    ranks = MEASURED.get("shard")
    source = "phase 16's ranks"
    if ranks is None:
        shard_dir = DRY_DIR / "shard"
        shard_dir.mkdir()
        spawn_ranks(dry_shard_rank, (SHARD_RANKS, str(shard_dir)),
                    SHARD_RANKS, "phase 16's step", timeout_s=SHARD_TIMEOUT_S)
        ranks = [json.loads((shard_dir / f"shard{r}.json").read_text())
                 for r in range(SHARD_RANKS)]
        want = _shard_launches(SHARD_LAYERS)
        for r, res in enumerate(ranks):
            check(all(res["launches"][k] == v for k, v in want.items()),
                  f"(b) rank {r}: launches {res['launches']}, not {want}")
        source = "phase 27's own run of phase 16's step"
    for r, res in enumerate(ranks):
        check(res["bytes_sent"] == dry["bytes_sent"]
              and res["per_op"] == dry["per_op"],
              f"(b) rank {r} sent {res['bytes_sent']} {res['per_op']}; the "
              f"dry run {dry['bytes_sent']} {dry['per_op']}")
        held = {k: res[k] for k in ("param_bytes", "optimizer_bytes",
                                    "input_bytes")}
        check(held == {k: dry[k] for k in held} and sum(held.values())
              == dry["argument_bytes"], f"(c) rank {r} holds {held}; the "
              f"dry run {dry}")
    log(f"[dry] (b) qwen3-4b at {SHARD_LAYERS} layers, {SHARD_BATCH} x "
        f"{SHARD_SEQ}, (data {SHARD_MESH[0]}, model {SHARD_MESH[1]}), TP + "
        f"ZeRO-3 + remat, one step: the dry run's {dry['bytes_sent']} bytes "
        f"a rank ({dry['per_op']}) equal, to the byte, what each of "
        f"{source} sent: {[r['bytes_sent'] for r in ranks]}")
    log(f"[dry] (c) argument bytes a rank: the dry run's "
        f"{dry['argument_bytes']} (params {dry['param_bytes']}, AdamW "
        f"{dry['optimizer_bytes']}, batch rows {dry['input_bytes']}) equal "
        f"each rank's")

    # (d) one card: the dry run beside phase 9's measured step
    row = done[("dense",)]["result"]
    meas = MEASURED.get("dense_train")
    resident = row["modeled_resident_bytes_per_device"]
    tracked = row["memory"]["argument_bytes"] + row["memory"]["temp_bytes"]
    line = (f"[dry] (d) qwen3-4b, {DENSE_LAYERS} layers, {DENSE_BATCH} x "
            f"{DENSE_SEQ}, remat, one card: t_compute "
            f"{row['t_compute_s'] * 1e3:.2f} ms ({row['hlo_flops'] / 1e12:.3f}"
            f" TFLOP: aten {row['aten_flops'] / 1e12:.3f}, kernels "
            f"{row['kernel_flops'] / 1e12:.3f}), t_memory modeled "
            f"{row['t_memory_s'] * 1e3:.2f} ms (unfused "
            f"{row['t_memory_unfused_s'] * 1e3:.2f} ms), modeled resident "
            f"{resident / 1e9:.2f} GB, argument "
            f"{row['memory']['argument_bytes'] / 1e9:.2f} GB + temp "
            f"{row['memory']['temp_bytes'] / 1e9:.2f} GB")
    if meas is None:
        log(line + "; phase 9 did not run: nothing measured beside it")
    else:
        step_s = meas["step_ms"] / 1e3
        log(line + f"; phase 9 measured a step of {meas['step_ms']:.2f} ms "
            f"({meas['busy_ms']:.2f} ms busy) and a peak of "
            f"{meas['peak_bytes'] / 1e9:.2f} GB: t_compute / step "
            f"{row['t_compute_s'] / step_s:.4f}, t_memory / step "
            f"{row['t_memory_s'] / step_s:.4f} (unfused "
            f"{row['t_memory_unfused_s'] / step_s:.4f}), modeled resident "
            f"/ peak {resident / meas['peak_bytes']:.4f}, (argument + temp) "
            f"/ peak {tracked / meas['peak_bytes']:.4f} (printed only: the "
            "memory model is analytic)")
    shutil.rmtree(DRY_DIR, ignore_errors=True)
    log(f"[dry] phase 27 in {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    if sys.argv[1:2] == ["--compare-flash-bwd"] and len(sys.argv) == 3:
        return compare_flash_bwd(sys.argv[2])
    if sys.argv[1:2] == ["--compare-rmsnorm"] and len(sys.argv) in (3, 4) \
            and sys.argv[3:] in ([], ["--steps"]):
        return compare_rmsnorm(sys.argv[2], sys.argv[3:] == ["--steps"])
    only = None
    if sys.argv[1:2] == ["--phases"] and len(sys.argv) == 3:
        only = {1, *(int(n) for n in sys.argv[2].split(","))}
        if 20 in only:          # phase 20 holds its ranks against phase 19
            only.add(19)

    def run(n):
        return only is None or n in only

    t_start = time.perf_counter()
    marks = [(1, t_start)]      # (phase, start) for the seconds by phase

    def begin(n):
        if run(n):
            marks.append((n, time.perf_counter()))
            return True
        return False

    kernels = None
    try:
        card = phase_build()
        errs, launches = {}, {}
        if begin(2):
            errs = phase_kernels()
            phase_partial(errs)
            phase_bf16_p()
            phase_bf16_pds()
            phase_train_kernels(errs)
            phase_flash_bwd(errs)
            phase_k13(errs)
            phase_k14(errs)
            phase_vlm_kernels(errs)
            phase_qwen2_kernels(errs)
        if begin(7):
            timed = phase_timings()
        if begin(3):
            launches["serve"] = phase_serve()
        # RankPool's processes import while the phases before their ranks
        # run, and are killed before a phase that wants the whole card
        if run(20):
            POOL.open()
        if begin(19):
            moe_launches, moe_ref = phase_moe()
            launches.update(moe_launches)
            if begin(20):
                launches.update(phase_moe_shard(moe_ref))
        POOL.close()
        if run(24):
            POOL.open()
        if begin(21):
            if not run(2):      # the dh 112 kernels first
                phase_k13(errs)
            launches.update(phase_kimi())
        if begin(22):
            launches.update(phase_whisper())
        if begin(23):
            if not run(2):      # K14 against its plain version first
                phase_k14(errs)
            launches.update(phase_whisper_train())
        if begin(24):
            launches.update(phase_whisper_shard())
        POOL.close()
        if run(25):
            POOL.open()
        if begin(25):
            if not run(2):      # the kernels at internvl2's shapes first
                phase_vlm_kernels(errs)
            launches.update(phase_vlm())
        POOL.close()
        if run(26):
            POOL.open()
        if begin(26):
            if not run(2):      # the kernels at qwen2.5-14b's shapes first
                phase_qwen2_kernels(errs)
            launches.update(phase_qwen2())
        POOL.close()
        if begin(4):
            phase_cpu_vs_card()
        if begin(5):
            launches["train"], train_losses = phase_train()
            if begin(14):
                launches["ckpt"] = phase_ckpt(train_losses)
        if begin(6):
            phase_train_cpu_vs_card()
        if begin(9):
            launches["dense_train"], dense_losses = phase_dense_train()
        if begin(10):
            phase_dense_cpu_vs_card()
        if begin(11):
            (launches["dense_serve"], launches["ssm_prefill"],
             dense_decode) = phase_dense_serve()
        if any(run(n) for n in (15, 16, 17, 18, 8, 27)):
            POOL.open()
        if begin(12):
            launches.update(phase_ssm_serve())
        if run(9) and begin(13):
            launches.update(phase_plan(dense_losses))
        if begin(15):
            launches.update(phase_pipeline())
        if begin(16):
            launches.update(phase_shard())
        if begin(17):
            launches.update(phase_ssm_tp())
        if begin(18):
            launches.update(phase_serve_shard())
        if begin(8):
            launches["sp"] = phase_sp()
        if begin(27):
            phase_dry_run()
        if only is None:
            kernels = kernel_entries(timed, errs, launches, dense_decode)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        POOL.close()
    ends = [t for _, t in marks[1:]] + [time.perf_counter()]
    log(f"[done] {'all phases' if only is None else f'phases {sorted(only)}'}"
        f" in {ends[-1] - t_start:.1f} s; seconds by phase, in run order, "
        "the build in phase 1 and the kernels line in the last: "
        + json.dumps({n: round(e - t, 1) for (n, t), e in zip(marks, ends)}))
    log(card)       # again, so that the end of the output names the card
    if kernels is not None:
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
