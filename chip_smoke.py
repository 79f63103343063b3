#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line is printed):

1. print the card's name and power limit (``nvidia-smi``), turn TF32 off,
   build the kernels from the sources in this checkout (one ``nvcc`` per
   CUDA C++ source, all started together: flash attention with ring
   attention's panel visit, the SSD scan, and RMSNorm forward and
   backward) and print the build seconds; print each CUDA kernel's
   registers and spill bytes (``-Xptxas -v``) and its HGMMA
   (``wgmma``) and HMMA (``mma.sync``) counts (``cuobjdump -sass``), and
   fail unless the four bf16 flash instantiations (both entries, dh 64 and
   128) contain HGMMA, the product kernels of the bf16 SSD forward
   (``ssd_fwd_chunk_state_kernel``, ``ssd_fwd_chunk_scan_kernel``) and
   backward (``ssd_bwd_chunk_state_kernel``, ``ssd_bwd_chunk_grad_kernel``)
   contain HMMA, and the three ``ssd_fwd_`` and three ``ssd_bwd_`` kernels
   of the bf16 forward and backward spill nothing; print the CTAs per SM
   those six kernels reach; fail if any RMSNorm kernel spills, and print
   the RMSNorm backward's warps a CTA and CTAs per SM at the training
   widths; a fourth ``nvcc`` builds the SSD scan without the bf16
   backward's dB/dC stores, which phase 7 times; print the flash
   backward's kernels (``flash_bwd_``: D, dK/dV and dQ, fp32 and bf16, dh
   64 and 128) with their registers, spills and HGMMA count, fail if one
   is missing or a bf16 product kernel (``_wgmma_kernel``) has no HGMMA or
   spills, print those four kernels' CTAs per SM and any wgmma that ptxas
   serialised;
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
   body), and its backward twice at 16384 x 2048, where dw must be the same
   bits both times, as must the SSD backward's gradients at the training
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
   tolerance;
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
   full-width qwen3-4b (random weights from seed 0, 36 layers): (a)
   ``make_serve_step`` logits at every position of 2 lanes of 256 random
   tokens against ``make_prefill_step`` logits on the same tokens, in bf16
   within ``DECODE_VS_PREFILL_TOL`` of the largest logit, after the same
   comparison in fp32 over 64 tokens within 1e-4; (b) ``serve`` on 8 lanes
   of a 2048-token cache for 16 requests (prompts of 16-128 tokens, 32 new
   tokens each; more requests than lanes, so slots are recycled): every
   request completes, no plain version is called, the flash forward
   launches once a layer a step; one decode step at mixed positions is
   timed and profiled, and each of its 36 flash launches must read its
   layer's cache in place, non-causal with a kv_len; then one request of
   2040 + 32 tokens on one lane of the 2048-token cache, which wraps, on
   the model's first ``WRAP_LAYERS`` (4) layers;
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
   lanes) for mamba2-370m (48 layers) and zamba2-1.2b (38 layers, 6 calls
   of the shared attention block a token): (a) in fp32, then bf16, each
   mixer's decode against its prefill on the same input (the hidden state
   the prefill hands that layer, 2 lanes of ``LAYERWISE_T`` tokens) within
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
   a pp 4 plan, and ``train --pipeline --ranks 4`` trains 3 steps with it
   (zb-h1, P 4, m 4, AdamW on each rank's leaves with the global grad
   norm): its first loss must be (b)'s for that schedule, bit for bit; its
   step ms and each rank's peak are printed.  The 4 ranks share one card,
   so their times are not a pipeline's speed;
16. the sharded executor at full qwen3-4b width, depth cut to 8 layers:
   (a) in a process of its own, the single-process ``lm_loss`` and its
   gradients (remat on every layer) on ``init_lm`` seed 0 and the train
   driver's first batch of 4 x 4096 tokens, then 3 ``make_train_step``
   steps at phase 9's lr; (b) 4 gloo ranks sharing the card on a (data 2,
   model 2) ``make_local_mesh`` with ``ShardPolicy(tp=True, zero=True,
   remat_segments=(True,))``, each drawing its shards
   (``init_train_state(mesh=)``): the sharded loss within 2e-3 relative of
   (a)'s and each gathered gradient leaf within 2e-2 of (a)'s leaf's
   largest magnitude, with ``seq_shard`` off and on (on: the same bits as
   off, or within those gates, which the line says), then 3 sharded steps
   whose losses are printed beside (a)'s and must be finite; the flash
   forward (2L), backward (L) and RMSNorm (8L+1, 4L+1) launched at exact
   counts a rank a call and a step, no plain version run; each rank's call
   and step ms, bytes sent through gloo and peak memory are printed; (c)
   the port's search for 4 cards of the H100 node at this model (a budget
   of 11 GB a card, batch grid [4]) and ``train --ranks 4 --plan``, 3
   steps on ``make_local_mesh()`` (data 4, model 1): the policy it prints
   must be the plan's middle strategy's, its first loss within 2e-3
   relative of (a)'s, the kernels launched at their counts.  The 4 ranks
   share one card: no time there is sharded training's speed;
17. tensor parallelism for Mamba2 and the zamba2 hybrid, and sharded
   checkpoints, on 4 gloo ranks sharing the card on a (data 2, model 2)
   mesh with ``ShardPolicy(tp=True, zero=True, remat_segments=(True,))``:
   (a) full-width mamba2-370m, depth cut from 48 to
   ``SSMTP_MAMBA2_LAYERS`` (24) for the script's time: a
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
   at mamba2-370m writes step 2's checkpoint; one spawned process restores
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
   the paged engine at full-width qwen3-4b, 36 layers, bf16, on phase 3's
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
   split by context) in bf16 at ``SS_BF16_LAYERS`` (18 of 36, 24 of 48,
   18 of 38 layers, cut for the script's time), each at
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
   ``launch/train.py`` within ``TRAIN_LOSS_RTOL``; and kimi-k2's dh 112
   attention at full width refused by the flash wrapper (no plain
   attention on the card).

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
Phase 7 also times the flash forward and backward at the dense training
shape as training launches them (causal, the forward writing its row
log-sum-exp) beside their plain versions and
``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` and its
autograd backward (the library yardsticks, never on the port's path).
The phases run in the order 1, 2, 7, 3, 19, 4, 5, 14, 6, 9, 10, 11, 12,
13, 15, 16, 17, 18, 8: phase 7
is the first to profile (``phase_timings`` says why), and its ``kernels``
line, which reads every path's launches, is printed at the end; the total
seconds are printed before the final lines.

``python3 chip_smoke.py --phases 2,19`` runs phase 1 and the listed
phases in the order above (a phase that needs an earlier one's results
runs only with it) and prints no ``kernels`` line.

``python3 chip_smoke.py --compare-flash-bwd PARENT_DIR`` runs none of
the phases: it times the bf16 flash backward at the dense training shape
with ``_flash_bwd_timing`` of the checkout at PARENT_DIR and of this one,
in turn parent, this, this, parent, each in its own process after that
tree's build, and prints a JSON line per run.

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
DENSE_SERVE_REQUESTS, DENSE_SERVE_NEW = 16, 32
WRAP_LAYERS = 4
# decode against prefill, bf16 at 36 layers: 2 lanes of 256 tokens; at each
# position the largest |difference| of the logits over the largest
# |logit| of the prefill.  The two paths round differently (decode's
# (B,1,d) products and cache reads against prefill's (B,S,d) products and
# causal flash), a few bf16 ulps (2^-8) a layer compounding over 36
# residual layers.  The same comparison in fp32 over 2 x 64 tokens, held
# at REL_TOL["float32"], witnesses that the bf16 distance is rounding
DECODE_VS_PREFILL_LANES, DECODE_VS_PREFILL_T = 2, 256
DECODE_VS_PREFILL_TOL = 5e-2
DECODE_VS_PREFILL_T_FP32 = 64
# phase 12, SSM and hybrid serving at full width: the archs, served on
# phase 11's geometry (8 lanes, 16 requests of 16-128 prompt tokens and 32
# new tokens; zamba2's shared-attention K/V caches of 2048 tokens); the
# zamba2 shared block's attention: MHA, H = KV = 32, dh 64
SSM_SERVE_ARCHS = ("mamba2-370m", "zamba2-1.2b")
ZAMBA2_HEADS = (32, 32, 64)
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
# train --pipeline: the plan of search --devices 4 on the H100 node with
# these flags, PIPE_TRAIN_STEPS steps at phase 9's lr
PIPE_SEARCH = ["--arch", "qwen3-4b", "--seq", str(PIPE_SEQ), "--cluster",
               PLAN_CLUSTER, "--devices", "4", "--budget", "24", "--max-pp",
               "4", "--schedules", "1f1b,zb-h1", "--batch-grid", "16"]
PIPE_TRAIN_STEPS = 3
# phase 16, the sharded executor: qwen3-4b at full width, depth cut from 36
# to SHARD_LAYERS so that the single-process reference (its fp32 loss over
# 16384 x 151936 logits beside 25.4 GB of bf16 params and grads and fp32
# AdamW state) fits the card alone, and the 4 ranks of (b) and (c) (each
# about 15 GB) fit it together; the train driver's first SHARD_STEPS
# batches of SHARD_BATCH x SHARD_SEQ tokens; SHARD_RANKS gloo ranks share
# the card on a (data, model) mesh of SHARD_MESH with TP, ZeRO and remat
SHARD_LAYERS, SHARD_RANKS, SHARD_BATCH, SHARD_SEQ = 8, 4, 4, 4096
SHARD_MESH, SHARD_STEPS = (2, 2), 3
# the sharded loss within SHARD_LOSS_RTOL of the single process's, each
# gathered gradient leaf within SHARD_GRAD_TOL of its largest magnitude
# (phase 15's gates: the same bf16 arithmetic, TP's partial sums rounded
# to bf16 before their fp32 sum)
SHARD_LOSS_RTOL, SHARD_GRAD_TOL = PIPE_LOSS_RTOL, PIPE_GRAD_TOL
SHARD_TIMEOUT_S = 900
# train --ranks: the plan of the port's search for SHARD_RANKS cards of the
# H100 node at this model, with a memory budget of SHARD_BUDGET_GB a card:
# the ranks share one card, and 4 replicas of the whole AdamW state (25.4
# GB each) would not fit it, so the budget is one that makes the searched
# plan's middle strategy, the one the driver applies, shard the state
SHARD_BUDGET_GB = 11
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
SSMTP_MAMBA2_LAYERS = 24
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
# (b)'s bf16 depth, cut by half for the whole script's time (the paged
# engine of (a) keeps all 36 layers)
SS_BF16_LAYERS = {"qwen3-4b": 18, "mamba2-370m": 24, "zamba2-1.2b": 18}
SS_FP32_LAYERS, SS_ZAMBA2_FP32_LAYERS = 4, 12
SS_DENSE_REQUESTS, SS_DENSE_NEW = 10, 8
SS_PREFILL_BATCH, SS_PREFILL_SEQ = 2, 1024
SS_CLI_REQUESTS, SS_CLI_CONTEXT = 12, 256
# the ranks' logits against the single process's, over its largest logit,
# in bf16: TP rounds each rank's partial row products (wo, w_down) to
# bf16 before their fp32 sum, one rounding more a layer than one process,
# and a random-weight stack compounds it with depth (2.0e-2 to 4.9e-2 at
# qwen3-4b's 36 layers on an H100 80GB HBM3 at 700 W, the same with
# context or KV heads over model, so not the merge); fp32 at 4 layers at
# REL_TOL, the algebra's gate.  The SSM stacks' bf16 distance is printed
# (None: no gate), as phase 12 prints theirs: at 48 layers it is chaotic
# in the rounding (0.38 for mamba2 there)
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
                   "rmsnorm_fwd_wide_kernel", "rmsnorm_bwd_kernel",
                   "rmsnorm_bwd_wide_kernel", "rmsnorm_bwd_dw_sum_kernel")
# the flash backward's three kernels by name prefix, in launch order
FLASH_BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
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
            # the bf16 instantiations (both entries, dh 64 and 128) must
            # run their products on wgmma
            wgmma = {fn: n[0] for fn, n in mma.items()
                     if "flash_fwd_wgmma_kernel" in fn}
            check(len(wgmma) == 4 and all(wgmma.values()),
                  f"bf16 flash kernels without HGMMA in their SASS: {wgmma}")
            # the backward: D for both dtypes, dK/dV and dQ on FMA for fp32
            # and on wgmma (HGMMA) for bf16, dh 64 and 128; the bf16
            # product kernels spill nothing
            bwd = {k: v for k, v in report.items()
                   if k.startswith("flash_bwd_")}
            log("[build]   flash backward: " + "; ".join(
                f"{k} {v[0]} registers, spills {v[1][0]}/{v[1][1]}, "
                f"{v[2]} HGMMA" for k, v in sorted(bwd.items())))
            wg = {k: v for k, v in bwd.items() if "_wgmma_kernel" in k}
            check(len(bwd) == 12 and len(wg) == 4 and all(
                v[2] > 0 and v[1] == (0, 0) for v in wg.values()),
                  f"flash backward kernels missing, or bf16 ones without "
                  f"HGMMA or spilling: {bwd}")
            occ = (ctypes.c_int * 4)()
            check(ctypes.CDLL(str(lib)).flash_attention_bwd_occupancy(occ)
                  == 0, "flash_attention_bwd_occupancy failed")
            log("[build]   bf16 flash backward, CTAs of 256 threads per SM: "
                + ", ".join(f"{k} dh {dh} {n}" for (dh, k), n in zip(
                    [(dh, k) for dh in (64, 128)
                     for k in ("flash_bwd_dkdv_wgmma_kernel",
                               "flash_bwd_dq_wgmma_kernel")], occ)))
            # ptxas names a kernel whose wgmma it had to serialise
            for line in lib.with_suffix(".log").read_text().splitlines():
                if "serialized" in line:
                    log(f"[build]   ptxas: {line.strip()}")
        elif name == "rmsnorm":
            spilled = {k: v[1] for k, v in report.items() if v[1] != (0, 0)}
            check(len(report) >= len(RMSNORM_KERNELS) and not spilled,
                  f"RMSNorm kernels missing or spilling: {spilled}")
            for d in (1024, 2048):
                warps, per_sm, sms = rmsnorm._bwd_config(0, d, 1)
                n = rmsnorm.bwd_grid(TRAIN_BATCH * TRAIN_SEQ, warps, per_sm,
                                     sms)
                log(f"[build]   RMSNorm backward, bf16 d {d}: {warps} warps "
                    f"a CTA, {per_sm} CTAs per SM, {n} CTAs (partials rows) "
                    f"at {TRAIN_BATCH * TRAIN_SEQ} rows")
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
             128, dict(q_offset=_i32([0, 5, 100, 255, 256, 511, -1, 37])))]


def arctic_flash_cases():
    """(name, B, S, T, kwargs) of phase 19 at arctic-480b's heads (H 56,
    KV 8, dh 128: a GQA group of 7): the paged decode (8 lanes, T 512) and
    prefill (4 x 128 at base 256), the dense engine's decode over a
    2048-token cache and the causal prefill of 2 x 256 tokens."""
    return [("arctic decode", DECODE_SLOTS, 1, MAX_CONTEXT,
             dict(q_offset=_i32([0, 5, 100, 255, 256, 511, -1, 37]))),
            ("arctic prefill base 256", PREFILL_BATCH, PREFILL_CHUNK,
             MAX_CONTEXT, dict(q_offset=_i32([256] * PREFILL_BATCH),
                               kv_len=_i32([384, 300, 260, 0]))),
            ("arctic dense decode", DECODE_SLOTS, 1, DENSE_SERVE_CONTEXT,
             dict(causal=False, kv_len=_i32(
                 [1, 2, 63, 64, 65, 1000, DENSE_SERVE_CONTEXT - 1,
                  DENSE_SERVE_CONTEXT]))),
            ("arctic prefill 2 x 256", DECODE_VS_PREFILL_LANES,
             DECODE_VS_PREFILL_T, DECODE_VS_PREFILL_T, {})]


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
                  for name, B, S, T, kw in arctic_flash_cases()]
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
                      (PREFILL_BATCH * PREFILL_CHUNK, 7168)]:
            x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dt)
            w = torch.randn(shape[-1], generator=g, device="cuda").to(dt)
            check_rmsnorm(x, w, dtype, str(shape), errs)
    # the unaligned body: rows of a bf16 view at storage offset 1
    x, w = unaligned_rows(g, 777, 2560, 3.0)
    check_rmsnorm(x, w, "bfloat16", "(777, 2560) at offset 1", errs)
    return errs


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


def phase_partial(errs):
    """Ring attention's panel-visit kernel against its plain version at
    qwen3-4b width (H 32, KV 8, dh 128), B 1, S_loc = T_loc = 8192, and at
    300 local queries and keys for every GQA_SHAPES entry."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ring_attention import flash_partial_cuda

    def visit(q, k, v, delta, window, dtype, what):
        got = flash_partial_cuda(q, k, v, delta, causal=True, window=window)
        torch.cuda.synchronize()
        want = ref.flash_partial_ref(q, k, v, delta, causal=True,
                                     window=window)
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
            errs["flash_partial"] = max(errs["flash_partial"], *(
                (a[seen] - b[seen]).abs().max().item()
                for a, b in zip(got, want)))

    g = torch.Generator(device="cuda").manual_seed(7)
    errs["flash_partial"] = 0.0
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        shapes = [(SP_LOCAL, 32, 8, 128, partial_cases())]
        shapes += [(300, H, KV, dh, [(d, w) for d in (0, 300, -300, 37)
                                     for w in (None, 100)])
                   for H, KV, dh in GQA_SHAPES]
        for n, H, KV, dh, cases in shapes:
            q = torch.randn(1, n, H, dh, generator=g, device="cuda").to(dt)
            k = torch.randn(1, n, KV, dh, generator=g, device="cuda").to(dt)
            v = torch.randn(1, n, KV, dh, generator=g, device="cuda").to(dt)
            for delta, window in cases:
                visit(q, k, v, delta, window, dtype,
                      f"S=T={n} H {H} KV {KV} dh {dh}")
            del q, k, v
    torch.cuda.empty_cache()


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
    bitwise-stable across two calls), the RMSNorm backward (also on an
    unaligned view, and dw bitwise-stable across two calls)."""
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
                         ("float32", (777, 2048)), ("float32", (5, 100))):
        dt = getattr(torch, dtype)
        x = (torch.randn(shape, generator=g, device="cuda") * 2).to(dt)
        cases.append((dtype, str(shape), x,
                      torch.randn(shape[-1], generator=g,
                                  device="cuda").to(dt)))
    # the unaligned body: rows of a bf16 view at storage offset 1
    cases.append(("bfloat16", "(777, 2560) at offset 1",
                  *unaligned_rows(g, 777, 2560, 2.0)))
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


def flash_bwd_check(q, k, v, do, causal, window, what, errs):
    """The forward with its row log-sum-exp and the backward kernels on one
    case, held against the plain versions (``flash_attention_lse_ref``,
    ``flash_attention_bwd_ref`` on the kernel's output and log-sum-exp)
    and against ``torch.autograd`` of ``flash_attention_ref``.  Returns
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
    errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], *(
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
    "rmsnorm": ("rmsnorm_",),
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
    return lambda: {name: fn.launches for name, fn in fns.items()}


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


def _dense_lr_witness(cfg, batches):
    """Losses of ``len(batches)`` steps at WITNESS_LR from the same weights
    at ``cfg``'s depth with remat, through the flash kernels and through
    the plain attention: whether the loss rises there with the kernels'
    gradients and with torch's alike."""
    import gc

    import torch
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.executor import init_train_state, make_train_step

    out = {}
    opt_cfg = AdamWConfig(lr=WITNESS_LR)
    for name in ("kernels", "plain"):
        params, opt = init_train_state(cfg, seed=0, opt_cfg=opt_cfg,
                                       device="cuda")
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
    cfg = get_config("qwen3-4b").with_(dtype=torch.float32)
    params = init_lm(cfg, seed=0, device="cuda")
    worst_fp32 = _decode_vs_prefill(cfg, params, DECODE_VS_PREFILL_T_FP32,
                                    REL_TOL["float32"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-4b")
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
        cfg = get_config(arch).with_(dtype=getattr(torch, dtype))
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
def recorded_train_steps():
    """Check-only: record the ``remat_segments`` that
    ``launch/train.py`` gives ``make_train_step`` and each step's wall ms
    (host clock ending in a synchronize) while the block runs."""
    import torch
    from repro_torch.launch import train as train_cli

    seen = {"remat_segments": [], "step_ms": []}
    real = train_cli.make_train_step

    def make(cfg, opt_cfg=None, *, remat_segments=None):
        seen["remat_segments"].append(remat_segments)
        step = real(cfg, opt_cfg, remat_segments=remat_segments)

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            seen["step_ms"].append((time.perf_counter() - t0) * 1e3)
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


def spawn_ranks(fn, args, nprocs, what, timeout_s=PIPE_TIMEOUT_S):
    """``launch/mesh.py::run_ranks``: ``fn(rank, *args)`` in ``nprocs``
    spawned processes, a failed or late rank failing the phase.  Returns
    the wall seconds."""
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    try:
        run_ranks(fn, args, nprocs, timeout_s=timeout_s)
    except RuntimeError as e:
        raise Failed(f"{what}: {e}") from e
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
                t0 = time.perf_counter()
                m = step(params, opt, b)
                torch.cuda.synchronize()
                hist.append({"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "ms": (time.perf_counter() - t0) * 1e3,
                             "gloo_bytes": step.shard.traffic.bytes_sent
                             - sent})
        out.update(steps=hist, launches=counts(), plain=plain,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
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
            with contextlib.redirect_stdout(printed):
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
            with contextlib.redirect_stdout(printed):
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
        ("paged bfloat16", "qwen3-4b", "bfloat16", None, seq, ("paged",)),
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

    def add(self, n):
        sent["n"] += n
        real(self, n)

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

    def recording(p, xf, cfg):
        out = real(p, xf, cfg)
        routes.append(out[1].sort(dim=-1).values.clone())
        return out

    moe_mod._route = recording
    try:
        yield routes
    finally:
        moe_mod._route = real


def _moe_cfg(dtype="bfloat16", layers=MOE_LAYERS):
    import torch
    from repro_torch.configs import get_config
    return get_config(MOE_ARCH).with_(n_layers=layers,
                                      dtype=getattr(torch, dtype))


def _moe_init(cfg):
    import torch
    from repro_torch.models import init_lm
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[moe] {cfg.name} at full width, {cfg.n_layers} of 35 layers, "
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
    on its whole capacity buffer (8 groups of C = top_k rows), every other
    weight on 8 rows, QK and PV over 301 keys.  Returns (GB, ms, by)."""
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
    rows = DECODE_SLOTS * _capacity(1, cfg)
    n_ops = (2 * rows * experts + 2 * DECODE_SLOTS * other
             + 4 * cfg.n_layers * DECODE_SLOTS * keys * cfg.n_heads * cfg.dh)
    return (n_bytes / 1e9, *_bound_ms(n_bytes, n_ops, "bfloat16"))


def _moe_paged(cfg, params):
    """(a) Phase 3's requests through the paged engine, twice: every
    request completes, the flash forward and RMSNorm launch at the counts a
    decode step and a prefill chunk give, no plain version runs, and the
    second run gives the same tokens and the same bits of the first decode
    step's logits.  Then a decode step timed and profiled beside its
    bound (every weight read once)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

    ecfg = EngineConfig(page_size=PAGE_SIZE,
                        n_pages=DECODE_SLOTS * MAX_CONTEXT // PAGE_SIZE,
                        decode_slots=DECODE_SLOTS, max_context=MAX_CONTEXT,
                        prefill_batch=PREFILL_BATCH,
                        prefill_chunk=PREFILL_CHUNK)
    ServingEngine(cfg, params, ecfg, device="cuda").run(
        [ServeRequest(rid="warmup", prompt=list(range(1, 150)), max_new=3)])

    def requests():
        rng = np.random.default_rng(0)
        return [ServeRequest(rid=f"r{i}",
                             prompt=rng.integers(0, cfg.vocab_size,
                                                 int(rng.integers(33, 401))
                                                 ).tolist(),
                             max_new=int(rng.integers(16, 33)))
                for i in range(12)]

    def one_run():
        engine = ServingEngine(cfg, params, ecfg, device="cuda")
        first, real = [], engine._decode

        def recording(*args):
            out = real(*args)
            if not first:
                first.append(out.clone())
            return out

        engine._decode = recording
        reqs = requests()
        torch.cuda.synchronize()
        counts = _zero_counts()
        with plain_calls() as plain:
            metrics = engine.run(reqs)
            torch.cuda.synchronize()
        engine._decode = real
        return engine, reqs, metrics.summary(), counts(), plain, first[0]

    torch.cuda.reset_peak_memory_stats()
    engine, reqs, summ, launches, plain, first = one_run()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in reqs:
        check(r.done and len(r.tokens) == r.max_new
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"moe request {r.rid}: {r.tokens} of {r.max_new}")
    check(summ["completed"] == len(reqs), f"completed {summ['completed']}")
    check(not plain, f"the MoE paged engine called plain versions: {plain}")

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
        check(bool(torch.isfinite(out).all()), "MoE logits not finite")
        return (flash_attention_cuda.launches - before[0],
                rmsnorm_cuda.launches - before[1])

    per_decode, per_prefill = per_call(decode), per_call(prefill)
    calls = (summ["decode_steps"], summ["prefill_chunks"])
    for i, name in enumerate(("flash_attention", "rmsnorm")):
        want = per_decode[i] * calls[0] + per_prefill[i] * calls[1]
        check(launches[name] == want and launches[name] > 0,
              f"the MoE paged run launched {name} {launches[name]} times, "
              f"not {want}")
    check(per_decode[0] == per_prefill[0] == cfg.n_layers,
          f"flash launches a decode step / prefill chunk: {per_decode[0]}, "
          f"{per_prefill[0]}, not {cfg.n_layers}")
    _, reqs2, _, _, _, first2 = one_run()
    same_tokens = [r.tokens for r in reqs2] == [r.tokens for r in reqs]
    same_bits = torch.equal(first2, first)
    log(f"[moe] (a) second run: the same tokens {same_tokens}, the first "
        f"decode step's logits the same bits {same_bits}")
    check(same_tokens and same_bits, "the MoE serving forward is not "
          "deterministic run to run")

    ms = cuda_ms(decode, iters=10)
    busy, kernels, cats = profile_step("moe paged decode", decode, ms)
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
    log("[moe] (a) paged " + json.dumps(result))
    return launches


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


def _moe_dense_serve(cfg, params):
    """(b) serve on MOE_DENSE_LANES lanes of a DENSE_SERVE_CONTEXT-token
    cache: every request completes, the flash forward launches once a layer
    a step, no plain version runs."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import Request, serve

    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(16, 65))).tolist(),
                    MOE_DENSE_NEW) for i in range(MOE_DENSE_REQUESTS)]
    counts = _zero_counts()
    with counted_serve_steps() as steps, plain_calls() as plain:
        t0 = time.perf_counter()
        serve(cfg, reqs, MOE_DENSE_LANES, DENSE_SERVE_CONTEXT, verbose=False,
              device="cuda", params=params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counts()
    for r in reqs:
        check(r.done and len(r.generated) == MOE_DENSE_NEW
              and all(0 <= t < cfg.vocab_size for t in r.generated),
              f"moe dense request {r.rid}: {r.generated}")
    check(not plain, f"the MoE dense engine called plain versions: {plain}")
    n = steps["n"]
    check(launches["flash_attention"] == cfg.n_layers * n,
          f"{launches['flash_attention']} flash launches in {n} steps")
    new = sum(len(r.generated) for r in reqs)
    log(f"[moe] (b) serve: {len(reqs)} requests on {MOE_DENSE_LANES} lanes "
        f"of {DENSE_SERVE_CONTEXT}, {new} tokens in {wall:.2f} s "
        f"({new / wall:.1f} tok/s, {n} steps, {1e3 * wall / n:.2f} ms a "
        f"step); launches {launches}")
    return launches


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


def _kimi_full_width_refused():
    """kimi-k2-1t-a32b's attention at full width (dh 7168 / 64 = 112) is
    refused by the flash kernel's wrapper, not sent to a plain version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cfg = get_config("kimi-k2-1t-a32b")
    q = torch.zeros(1, 4, cfg.n_heads, cfg.dh, dtype=torch.bfloat16,
                    device="cuda")
    kv = torch.zeros(1, 4, cfg.n_kv_heads, cfg.dh, dtype=torch.bfloat16,
                     device="cuda")
    try:
        ops.flash_attention(q, kv, kv)
    except ValueError as e:
        log(f"[moe] kimi-k2-1t-a32b at full width (dh {cfg.dh}): the flash "
            f"wrapper raises: {e}")
        check("K13" in str(e), "the refusal does not name its queue item")
        return
    raise Failed("kimi-k2-1t-a32b's dh 112 attention ran on the card")


def phase_moe():
    """Phase 19.  Returns {path: launches}."""
    t_phase = time.perf_counter()
    _free_cuda()
    launches = {}
    cfg = _moe_cfg()
    params = _moe_init(cfg)
    launches["moe_serve"] = _moe_paged(cfg, params)
    toks = _moe_decode_vs_prefill(cfg, params, DECODE_VS_PREFILL_T,
                                  MOE_DECODE_VS_PREFILL_TOL, "[moe] (b)")
    _moe_drops(cfg, params, toks)
    launches["moe_dense_serve"] = _moe_dense_serve(cfg, params)
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
    _kimi_full_width_refused()
    log(f"[moe] phase 19 in {time.perf_counter() - t_phase:.1f} s")
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


def _flash_train_timing(B=DENSE_BATCH, S=DENSE_SEQ, H=32, KV=8, dh=128):
    """The forward as training launches it under autograd (by default the
    dense shape, B 2, S 4096, H 32, KV 8, dh 128; bf16, causal, no
    q_offset or kv_len, writing the row log-sum-exp); its plain version is
    ``flash_attention_ref`` and
    ``flash_attention_lse_ref`` on the same inputs, the library
    ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``.
    The bound: q, k, v read and the output and lse written once, or 4 x
    causal pairs x H x dh operations at 989 TFLOP/s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(B, S, H, dh, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(B, S, KV, dh, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    n_ops = 4 * B * S * (S + 1) // 2 * H * dh
    n_bytes = 2 * (2 * B * S * H * dh + 2 * B * S * KV * dh) + 4 * B * S * H
    bound, by = _bound_ms(n_bytes, n_ops, "bfloat16")
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    t = _times(lambda: flash_attention_cuda(q, k, v, with_lse=True),
               lambda: (ref.flash_attention_ref(q, k, v),
                        ref.flash_attention_lse_ref(q, k, v)),
               lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, is_causal=True, enable_gqa=True),
               iters=10, plain_iters=2)
    return dict(t, bound_ms=bound, bound_by=by, gflop=n_ops / 1e9,
                shape=f"B={B} S={S} H={H} KV={KV} dh={dh} causal lse bf16")


def _flash_bwd_timing(B=DENSE_BATCH, S=DENSE_SEQ, H=32, KV=8, dh=128):
    """The backward at a training shape (by default the dense one, B 2, S
    4096, H 32, KV 8, dh 128; bf16, causal): the kernels on the forward's
    output and
    log-sum-exp, the plain version on the same, and the autograd backward
    of ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
    as the library yardstick.  The bound: the five products (dV, dP, dQ, dK
    and the recomputed S) over the admissible pairs at 989 TFLOP/s, or each
    of q, k, v, o, dO, lse read and dq, dk, dv written once at 3.35 TB/s.
    Phase 9's profile splits the time by kernel."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)

    g = torch.Generator(device="cuda").manual_seed(10)
    q, do = (torch.randn(B, S, H, dh, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, S, KV, dh, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    out, lse = flash_attention_cuda(q, k, v, with_lse=True)
    pairs = S * (S + 1) // 2                # causal pairs of one head
    n_ops = 5 * 2 * B * H * pairs * dh
    n_bytes = 2 * 4 * B * S * H * dh + 2 * 4 * B * S * KV * dh + 4 * B * S * H
    bound, by = _bound_ms(n_bytes, n_ops, "bfloat16")
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    y = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                       enable_gqa=True)
    dys = do.transpose(1, 2)
    t = _times(lambda: flash_attention_bwd_cuda(q, k, v, out, do, lse),
               lambda: ref.flash_attention_bwd_ref(q, k, v, out, do, lse),
               lambda: torch.autograd.grad(y, (qs, ks, vs), dys,
                                           retain_graph=True),
               iters=5, plain_iters=2)
    shape = f"B={B} S={S} H={H} KV={KV} dh={dh} causal bf16"
    parts = _kernel_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, do,
                                                        lse),
                       FLASH_BWD_KERNELS)[0]
    check(all(parts.values()), f"flash backward kernels without device "
          f"time: {parts}")
    log(f"[time] flash_attention_bwd {shape}: device ms by kernel "
        "(profiler, 5 calls, mean a launch): " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts.items()))
    return dict(t, bound_ms=bound, bound_by=by, gflop=n_ops / 1e9,
                shape=shape, ms_by_kernel=parts)


def _partial_timing(delta):
    """Ring attention's panel visit at the phase-8 shape (S_loc = T_loc =
    8192, H 32, KV 8, dh 128, bf16, causal) for one ``delta``: the kernel,
    its plain version and, as the library yardstick, SDPA over the same
    admissible pairs; SDPA writes the normalised output, not the state.  The
    bound counts the q rows that admit some key read (a dead visit needs no
    q), the K/V rows some query admits read, and the fp32 state written;
    operations 4 x pairs x H x dh."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.ring_attention import flash_partial_cuda

    S, H, KV, dh = SP_LOCAL, 32, 8, 128
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


def _kernel_ms(call, names, n=5):
    """Device ms per call of each kernel whose name holds one of ``names``
    (profiler over ``n`` calls, each launching it once: its device time over
    the launches the profiler recorded), and the names of every kernel the
    calls launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
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
    return {k: mean_ms(k) for k in names}, [e.key for e in events]


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
                 heads=ARCTIC_HEADS)}),
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
                 PREFILL_BATCH * PREFILL_CHUNK, 7168)}),
        ("rmsnorm_bwd", "cuda", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm.py:33", "train", {
             "train": _rmsnorm_bwd_timing(tokens, 1024),
             "train_gated": _rmsnorm_bwd_timing(tokens, 2048),
             "dense_k_norm": _rmsnorm_bwd_timing(
                 DENSE_BATCH * DENSE_SEQ * 8, 128),
             "dense_q_norm": _rmsnorm_bwd_timing(
                 DENSE_BATCH * DENSE_SEQ * 32, 128)}),
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
              SSMTP_LOCAL_BATCH, SSMTP_SEQ, *ZAMBA2_TP_HEADS)}),
        ("flash_partial", "cuda", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/ring_attention.py:110", "visible", {
             "diagonal": _partial_timing(0),
             "visible": _partial_timing(SP_LOCAL),
             "dead": _partial_timing(-SP_LOCAL)}),
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
        by_path = {path: counts[name] for path, counts in launches.items()}
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


def compare_flash_bwd(parent: str) -> int:
    """The bf16 flash backward at the dense training shape timed by
    ``_flash_bwd_timing`` of the parent checkout at ``parent`` and of this
    one, in turn parent, this, this, parent, each in a process of its own
    that first builds that tree's kernels (``phase_build``).  Prints one
    JSON line per run."""
    code = ("import json, sys; sys.path[:0] = ['.', 'src']; "
            "import chip_smoke as cs; cs.phase_build(); "
            "t = cs._flash_bwd_timing(); print('RESULT ' + json.dumps("
            "{k: t.get(k) for k in ('ms', 'launch_ms', 'library_ms', "
            "'bound_ms', 'ms_by_kernel')}))")
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
        log(json.dumps({"tree": name, "path": tree,
                        **json.loads(lines[-1][len("RESULT "):])}))
    return 0


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
    only = None
    if sys.argv[1:2] == ["--phases"] and len(sys.argv) == 3:
        only = {1, *(int(n) for n in sys.argv[2].split(","))}

    def run(n):
        return only is None or n in only

    t_start = time.perf_counter()
    kernels = None
    try:
        card = phase_build()
        errs, launches = {}, {}
        if run(2):
            errs = phase_kernels()
            phase_partial(errs)
            phase_bf16_p()
            phase_bf16_pds()
            phase_train_kernels(errs)
            phase_flash_bwd(errs)
        if run(7):
            timed = phase_timings()
        if run(3):
            launches["serve"] = phase_serve()
        if run(19):
            launches.update(phase_moe())
        if run(4):
            phase_cpu_vs_card()
        if run(5):
            launches["train"], train_losses = phase_train()
            if run(14):
                launches["ckpt"] = phase_ckpt(train_losses)
        if run(6):
            phase_train_cpu_vs_card()
        if run(9):
            launches["dense_train"], dense_losses = phase_dense_train()
        if run(10):
            phase_dense_cpu_vs_card()
        if run(11):
            (launches["dense_serve"], launches["ssm_prefill"],
             dense_decode) = phase_dense_serve()
        if run(12):
            launches.update(phase_ssm_serve())
        if run(9) and run(13):
            launches.update(phase_plan(dense_losses))
        if run(15):
            launches.update(phase_pipeline())
        if run(16):
            launches.update(phase_shard())
        if run(17):
            launches.update(phase_ssm_tp())
        if run(18):
            launches.update(phase_serve_shard())
        if run(8):
            launches["sp"] = phase_sp()
        if only is None:
            kernels = kernel_entries(timed, errs, launches, dense_decode)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[done] {'all phases' if only is None else f'phases {sorted(only)}'}"
        f" in {time.perf_counter() - t_start:.1f} s")
    log(card)       # again, so that the end of the output names the card
    if kernels is not None:
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
