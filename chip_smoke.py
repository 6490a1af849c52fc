"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: every kernel of the main path compiled from ``csrc/``, one
   ``nvcc`` each, all at once; a ptxas report of the Hopper kernels (K1's
   transpose and Gram kernels, K2's and K3's attention mainloop, K2's
   two f32 kernels, K4's variants: registers, spills, stack, shared
   memory), which must show no spill;
3. K1 held against its plain version on the card bit for bit, at the main
   path's chunk and ragged shapes (and against the exact integer Gram on
   the CPU at the ragged ones), its result exactly symmetric; timed beside
   its plain version, two ``torch._int_mm`` yardsticks and its bound, with
   its rate in TOP/s;
4. main path: ``mnist_random_fft.main`` with ``KEYSTONE_PLAN=1`` and
   ``KEYSTONE_GRAM_OP=int8`` at MNIST's size (60,000 train rows, D =
   16,384): the plan must pick int8, K1 must launch once per fit chunk,
   test error ≤ 1 %;
5. the same run with the fp32 Gram: ≥ 99.5 % of test predictions agree;
6. breakdown: the int8 fit's parts — planning (probe featurize and the
   quantization gate), the streamed accumulation, the Gram-form solve —
   timed cold and then warm in a fresh child process (``--breakdown``, for
   this script's own use);
7. K2 (flash attention) and K4 (int8-dequant matmul) against their plain
   versions at the LM path's shapes and ragged ones, timed beside their
   plain versions, a PyTorch library call and their bounds; K4 replayed
   three times from a CUDA graph gives its eager bits; K2 also at the
   scoring path's shapes (2, 16, 8,192, 64) and (2, 4, 8,192, 64) and at
   a tensor-parallel position's (8, 4, 2,048, 64); K2's tiled f32 kernel,
   causal, at (8, 16, 2,048, 64) and (8, 4, 2,048, 64), timed beside its
   plain version, SDPA f32 and its f32 bound;
8. LM main path: the bench's decode model (vocab 32,768, dim 1,024,
   depth 8, 16 heads, bf16, batch 8, 128-token prompts, 256 new tokens)
   made by ``TransformerLM.create`` on the card, in three legs — float,
   int8 weights through ``quantization.mm``, int8 weights through K4 —
   each timed by the delta method (prefill ms, ms per step, tokens/s).
   K2 must launch once per layer per prefill; K4 6·depth·255 times in the
   K4 leg and never in the others; each leg's decode profile, with K4's
   summed device ms per step in the K4 leg;
9. the same weights in f32: prefill and 32 teacher-forced decode steps
   through the kernels (flash, K4) and through the plain path (dense
   attention, ``quantization.mm``) give logits within 1e-4 of max|logit|
   and the same argmax on ≥ 99 % of positions;
10. serving: ``export_lm`` makes a ``DecodeLoop`` of 8 slots (s_max 512,
   int8 weights through K4, bf16) and captures its pooled step and each
   prefill bucket as CUDA graphs; it answers 16 requests of seeded prompt
   and answer lengths (tokens/s, slot fill). From one pool state with
   every slot busy, the graphed step against the eager one: 64 greedy
   steps give the same tokens, the graphed step is no slower (ms a step
   in turns), K4 48 launches a replay (counted by kernel name in a
   profiler trace: a replay calls no wrapper); each prefill bucket
   graphed against eager (ms, the same first token, K2 depth launches a
   replay);
11. K3 (the ring hop) against its plain version at the ring's hop shape
   (2, 16, 2,048, 64), bf16 in and f32 state — a diagonal, a past and a
   future hop, the future one bit for bit — and at a ragged f32 shape;
   timed beside its plain version and two bounds, f32 on CUDA cores and
   the 1 + 3 bf16 tensor-core passes, with its count of exponentials;
12. ring and Ulysses attention on ``create_mesh(data=4, devices=[card] *
   4)`` at (2, 16, 8,192, 64), causal: the ring (K3, 10 launches: the 6
   hops whose block comes from a later position have no live key and are
   not launched) against
   full-sequence K2 in f32 and against the plain ring, Ulysses (K2, 4
   launches) against full-sequence K2 in bf16; and in bf16, K2 against its
   plain version at the scoring path's own shapes — the local call (2, 16,
   8,192, 64), one Ulysses position's call (2, 4, 8,192, 64) and the
   Ulysses output;
13. LM scoring: ``evaluate_perplexity`` at the bench's LM width with rope
   (bf16) over 4 windows of 8,193 tokens from ``synthetic_corpus``, batch
   2, ``logit_chunk`` 2,048, in ``seq_mode`` ring, Ulysses and local on
   the same weights: loss, tokens/s, ms per forward, launches (K3 160 in
   the ring run and never in the others, K2 64 in the Ulysses run), and a
   profile of one forward of each; ring and Ulysses losses within 1e-4
   relative of local, and one window's bf16 logits within 5e-2 (ring) and
   8e-3 (Ulysses) of max|logit| of local;
14. the same weights in f32, one window: ring (K3) and local (K2) logits
   within 1e-4 of max|logit|, argmax agreement ≥ 99 %;
15. LM training, the bench's train step (vocab 32,768, dim 1,024, depth 8,
   16 heads, seq 2,048, batch 8, bf16, learned positions, AdamW at 3e-4,
   no remat, dense CE) through ``lm_transformer.main``: 40 steps, every
   loss finite, the mean of the last 5 at least 10 % below the first, K2
   depth × steps launches and K3 none (its blockwise backward reads K2's
   lse); then the same weights timed over steady steps (ms, tokens/s,
   TFLOP/s from ``train_step_flops`` and its share of the bf16 peak, peak
   memory), one step's profile by kernel bucket, and one layer's
   attention backward timed alone;
16. remat legs from the same weights and batches, "full" and "dots", 2
   steps each: the first loss within 8e-3 relative of no remat, K2 2·depth
   launches a step, peak memory;
17. the long-context step (seq 16,384, dim 512, depth 4, 8 heads, batch 1,
   rope, ``logit_chunk`` 4,096, bf16), 3 steps: finite losses, K2 depth
   launches a step, ms and tokens/s, peak memory;
18. sequence-parallel training at the scoring width (rope, seq 8,192,
   batch 2, ``logit_chunk`` 2,048) on ``create_mesh(data=4, devices=[card]
   * 4)``, 2 steps each in ring (K3 10·depth launches a step) and Ulysses
   (K2 4·depth); in f32 at depth 2 every leaf's gradient from ring and
   from Ulysses within 1e-4 of max|grad| of local (K2);
19. f32 at the flagship width, depth 2, seq 2,048, batch 2: every leaf's
   gradient through K2 and the ported backward, on its dense route and
   then its blockwise one (``KST_FLASH_DENSE_BWD_MAX=0``), within 1e-4 of
   max|grad| of dense attention under autograd.

20. HTTP serving: ``serve.server.build_app("lm")`` at the decode width
   (vocab 32,768, dim 1,024, depth 8, 16 heads, s_max 512, 8 slots,
   ``--quantize``: K4; f32, the CLI's default) and ``build_app("mnist")``
   at the main path's width (``--num-ffts 32``, D = 16,384,
   ``--synthetic 8192``), each on a ``ThreadingHTTPServer`` on
   127.0.0.1:0: 16 concurrent ``/generate`` (phase 10's requests) and 64
   concurrent ``/predict`` of 1–40 rows. Every request answered with its
   token count, tokens in range, ``/predict`` equal to the eager
   pipeline's classes, ``serve_aot_fallback`` 0; the ``/generate`` burst
   again under the profiler: K2 depth launches a prefill and K4 48 a step
   and a prefill of ≤ 64 rows, exactly (requests/s, p50/p99 latency,
   tokens/s).

21. TIMIT, streamed: ``timit_pipeline.main`` with ``KEYSTONE_PLAN=1`` and
   no ``KEYSTONE_GRAM_OP`` on 131,072 synthetic frames (26,214 test),
   8 cosine banks of 4,096 (D = 32,768, γ 0.05555, Gaussian W, λ 0, 5
   BCD epochs). First K1 against its plain version bit for bit at the
   fit's first chunk (8,192 × 32,768), timed beside its plain version,
   ``torch._int_mm`` and its bound, and the quantization gate on the
   plan's probe (256 × 32,768) timed against a copy of the per-column
   loop it replaced, the two equal. The run: the planner must pick int8
   by its cost model, K1 must launch once per fit chunk (16) and no other
   kernel at all, test error ≤ 5 %; the same run with the fp32 Gram
   agrees on ≥ 99.5 % of test predictions. Then the int8 fit's parts,
   warm: featurize (the scalers' pass), plan (probe and gate), stream,
   solve, and one stream under the profiler (K1's share of its device
   time);
22. TIMIT, classic: the same bank on 32,768 frames with ``--lam-sweep
   0.1,1,10`` (resident blocks, 4.3 GB): the sweep's λ and per-λ
   validation errors, test error of the refit ≤ 5 %.

23. MoE serving: the decode model's width with the FFN of every second
   block a top-2 MoE of 8 experts (ff ×4, capacity 1.25, groups of 4,096;
   bf16), ``generate`` in float and in int8 through K4 (the experts stay
   float): K2 once a layer a prefill, K4 40 times a step in the K4 leg
   only (ms a step, tokens/s, eager); the pool through ``export_lm`` (8
   slots, ``s_max`` 512, 16 requests, graphed): tokens/s and slot fill,
   64 graphed greedy steps give the eager tokens, K4 40 launches a
   replay and K2 8 a prefill replay (profiler trace), the 4 MoE layers'
   share of a graphed step's device time; the same weights in f32:
   prefill logits on the card within 1e-4 of max|logit| of the CPU's,
   the same top-2 experts wherever the router's logit gap exceeds 1e-4;
24. MoE training through ``lm_transformer.main --moe-every 2`` at the
   flagship shape (seq 2,048, batch 8, bf16, AdamW 3e-4), 20 steps: the
   mean of the last 5 losses at least 5 % below the first, K2 depth
   launches a step; the steady step (ms, tokens/s, TFLOP/s by
   ``train_step_flops``, peak memory, profile) and its parts timed alone
   (expert einsums, dispatch and combine, routing, attention backward,
   logits with the CE); f32 gradients of a depth-2 MoE model on the card
   within 1e-4 of max|grad| of the CPU's;
25. ``vit_ridge.main(["--synthetic", "50000"])`` (patch 8, dim 128, depth
   4, 4 heads, λ 1, chunks of 512, f32): K2 472 launches (118 chunks × 4
   blocks), test error ≤ 5 %, featurize and fit s, samples/s, cold and
   warm; ``cifar_linear_pixels.main`` at the same size, test error ≤ 5 %;
   ViT features on the card within 1e-4 of max|f| of the CPU's on 512
   images;
26. K2's f32 short-key kernel at ViT's shapes (512, 4, 16, 32) and the
   last train chunk's (336, 4, 16, 32), non-causal: out within 1e-5 of
   max|plain| and the lse within 1e-5 of its plain version's, timed beside
   it, SDPA on the same f32 tensors and its bound.

27. the conv CIFAR workloads on 50,000 + 10,000 synthetic images at the
   bench's 256 filters (2,048 features; patch 6, pool 14 / 13, α 0.25,
   chunks of 1,024, blocks of 4,096, λ 0): ``cifar_random_patch.main``,
   then ``cifar_random.main`` classic and with ``KEYSTONE_PLAN=1``; test
   error ≤ 5 % each, the two ``cifar_random`` fits agree on ≥ 99.5 % of
   test predictions, ``fusion_rewrites{rule="conv_rectify_pool"}`` once an
   ``optimize``; setup (the synthetic load apart), featurize, fit, total
   and samples/s, cold and warm; the whitener's SVD timed on the card;
   ``build_filters`` on the card within 1e-4 of max|filters| of the CPU's,
   the fused features within 1e-4 of max|f| on 512 images;
28. the featurizer at ``bench_cifar_conv``'s shape (4,096 × 32 × 32 × 3,
   256 filters, whitener means): the fused node, its unfused chain and
   the im2col Convolver's chain by device time beside the convolution's
   f32 bound (165.1 GFLOP), ``cifar_conv_samples_per_s`` as ``bench.py``
   computes it; fused and unfused within 2e-4 of max|out| of im2col;
29. text: ``newsgroups_pipeline.main`` on 11,314 synthetic documents,
   plain and ``--corenlp`` (naive Bayes on the card, test error ≤ 5 %),
   ``stupid_backoff_pipeline.main`` on 50,000 sentences (host only); the
   card's naive Bayes predictions equal the CPU's on the same counts, and
   its fit's device ms. Phases 27–29 launch no hand kernel except K1
   where the planner picks the int8 Gram for ``cifar_random``'s
   streamed fit.

30. VOC SIFT-Fisher: ``voc_sift_fisher.main`` with ``VOCConfig``'s
   defaults (256², 5 SIFT scales, step 3, bin 4; desc 80, vocab 256,
   1,000,000 PCA and GMM samples, 100 EM iterations, λ 0.5, chunks of 64,
   blocks of 4,096) on 1,024 + 256 synthetic images: load, SIFT, PCA, GMM,
   Fisher, featurize, fit, test and total s, samples/s, peak memory,
   train mAP > 0.3 (the JAX package's gate) and no hand kernel launched;
   10 EM iterations on the first 250,000 rows of the run's own GMM sample
   from the CPU's start, card against CPU: means within 1e-3 of
   max|mean|; the card's PCA of the
   run's sample against the CPU's by the projector onto its subspace; the
   JAX package's test configuration on the card and on the CPU from one
   set of artifacts: Fisher features within 1e-4 of max|f|, mAPs within
   1e-4;
31. SIFT at ``bench_sift``'s shape (16 × 256², ``default_rng(4)``):
   images/s, device ms and launches of a call (profiler), the bytes bound
   of the orientation planes' passes; the card's descriptors against the
   CPU's (all within ±1, ≥ 99.9 % equal) and both goldens on the card
   (≥ 99.5 % within ±1).

32. ImageNet SIFT + LCS Fisher vectors at ``ImageNetConfig``'s widths
   (desc 64, vocab 16, 5 SIFT scales, LCS stride 4, border 16, patch 6,
   λ 6e-5, mixture weight 0.25, blocks of 4,096, chunks of 32; D = 4,096
   features): ``imagenet_sift_lcs_fv.main`` eager on 1,024 + 256
   synthetic images of 8 classes (test top-1 error ≤ 5 %), then
   ``--streaming`` with ``KEYSTONE_PLAN=1`` on 2,048 + 512 images of
   1,000 classes (the solver at (D, C) = (4,096, 1,000); the planner's fit
   decisions and ``plan_featurize_passes_saved``); load, SIFT, LCS, PCA,
   GMM, Fisher, fit and test s, samples/s, peak memory; no hand kernel
   launched in either. A small configuration: LCS on the card within
   1e-5 of max of the CPU's, each branch's Fisher features from one set
   of descriptors and artifacts within 1e-4 of max|f| or 4 times what a
   1e-7 relative nudge of the descriptors moves the CPU's, where that is
   more;
33. the class-weighted solver alone at ``bench.py``'s two shapes
   (``bench_weighted``: N 32,768, D 1,024, C 147, 2 passes;
   ``weighted_imagenet_problem``: N 16,384, D 4,096, C 1,000, 1 pass): fit
   s, TFLOP/s by ``bench.py``'s count, the path taken, the class-chunk
   count, peak memory; the card's weights within 1e-4 of max|W| of the
   CPU's at reduced shapes taking the grid Woodbury, grid dense and
   masked paths.

34. native host code built from the repository's C++ sources by ``g++``:
   the port's CSV (5,000 MNIST-shaped rows) and CIFAR (10,000 records)
   readers against their numpy paths, exactly; ``SIFTExtractor(backend=
   "native")`` against the card's SIFT on 4 images of 256² (±1, ≥ 99.9 %
   equal); the native EM (20,000 × 32, k 16, 10 iterations) and Fisher
   vectors against the card's ``ops/gmm`` from the same start (EM 1e-3,
   weights 1e-4, Fisher 5e-4 absolute); host ms of each; no hand kernel;
35. the online-learning loop at the main path's width (MNIST random-FFT,
   ``num_ffts`` 32, D = 16,384, ``KEYSTONE_GRAM_OP=int8``):
   ``bootstrap_state`` on 40,000 rows, ``serve.server`` on the saved
   checkpoint over HTTP, ``RefitDaemon.run_once`` folding four chunks of
   5,000 rows and publishing, ``/admin/reload`` (the daemon's notify) and
   SIGHUP swapping while six threads hammer ``/predict``: zero client
   errors, ``model_swaps`` counting each swap, the served scores the
   folded model's, the folded state (and its file) bit for bit a fresh
   ``fit_stream`` of the same chunks, K1 once a fit chunk (5 + 4) and its
   first launch bit for bit, a negated-labels shadow candidate refused
   (409) and a clean one promoted (200); an fp32 leg whose published
   weights lie within 1e-5 of max|W| of one fit over the union; fold ms,
   publish s (finalize, state write), state bytes, swap ms (load, export,
   capture), requests/s and p99, peak memory;
36. checkpoint and resume: LM training at the flagship width, 8 steps with
   a checkpoint every 4, uninterrupted, preempted by ``train.preempt``
   after step 5 and resumed, stopped by a real SIGTERM
   (``train.sigterm``) in a ``lm_transformer`` subprocess and resumed:
   losses and every checkpointed leaf bit for bit (else within what two
   uninterrupted runs differ by, measured); save s and bytes; TIMIT's
   classic fit at phase 22's configuration with ``--checkpoint-every 1``,
   2 of 5 epochs and then resumed, against an uninterrupted fit bit for
   bit.

37. the serving fleet: ``serve.fleet`` with 3 replicas of phase 20's LM
   app (``python -m keystone_tpu_torch.serve.server lm`` at the decode
   width, ``--quantize``) on this card, the kernels built once by the
   router before any boot and no replica building one; each replica's
   ``/healthz`` names the card; a 60-request ``/generate`` burst from 4
   threads with ``fleet_game_day.json``'s router faults armed (a slow
   replica, a SIGKILLed replica, a reset connection), then a rolling
   restart under a second burst: no failed request, a failover, the
   killed replica relaunched and ``up``, every replica through the
   restart's probe gate, every reply the lone ``generate``'s tokens;
   cold starts, peak memory, requests/s, p50/p99 before, during and after
   the kill, a failover's added ms, the restart's seconds a replica, and
   K2/K4 a request (wrapper launches plus graph replays times phase 10's
   traced launches a replay);
38. guards and the watchdog at the flagship train width:
   ``train(guard="skip")`` with ``train.nan`` at step 2 of 6 leaves the
   parameters, both moments and the count bit for bit, later losses
   finite, K2 depth launches a step; ``guard="halt"`` raises; the guarded
   step's ms against the plain step's; the pipeline output guard raises on
   a ``batch.nan``-poisoned MNIST apply; a stalled step under
   ``step_timeout_s`` in a child logs the stacks and exits 114;
39. the game days through ``chaos.run_campaign`` on the card:
   ``train_game_day`` at the flagship train width cut to 8 steps with a
   checkpoint every 2 (supervisor relaunch, ENOSPC fallback,
   ``resume_bit_exact``), K2 depth launches a step of the last
   incarnation; ``refit_game_day`` at phase 35's MNIST width (D = 16,384,
   int8 forced), K1 once a fit and a fold chunk, its first launch bit for
   bit; every invariant PASS.

40. the planner's self-tuning at the main path's width (``MAIN_ARGV``,
   ``KEYSTONE_GRAM_OP=int8``): a fit under ``KEYSTONE_TUNE=1`` and a fresh
   ``KEYSTONE_PLAN_STORE`` (the tuner's windows and knobs printed, its
   flush persisting the record), then a second fit whose planned passes
   take ``source="store"`` decisions from it; K1 once a fit chunk in each,
   its first launch bit for bit; ``plan.fit_shared`` over two block
   solvers on one featurizer bank (the bank applied once, both counters
   ticked, weights within 1e-5 of max|W| of the naive fits); a K1 node's
   cost profile on the card against the CPU's (the same FLOPs, allocator
   bytes on the card only); ``plan.cli mnist-random-fft --fit`` and
   ``--learned`` naming the card;
41. the observability tools: ``lm_transformer.main`` at the flagship
   train width, 4 steps under ``KEYSTONE_OBSERVE_DIR`` with a
   ``KEYSTONE_PROFILE_STEPS`` window of two steps: its trace file, whole
   past the session's primer, K2 8 a step by kernel name in it (and its
   device ms), the device monitor's peak within 1 % of
   ``torch.cuda.max_memory_allocated``, then the report, ``top --once``
   and the dashboard over the run;
42. the launcher in subprocesses on the card: ``python -m
   keystone_tpu_torch --observe DIR mnist-random-fft --synthetic 10000``
   (planned, int8) beside ``plan mnist-random-fft``, then ``observe DIR``
   with the card's cost profiles.

43. two processes on one card: ``supervise --procs 2 -- chip_smoke.py
   --dp-worker DIR`` (for this script's own use), each process joining
   the process group over gloo on card 0 (NCCL refuses two ranks on one
   device): phase 4's MNIST int8 fit split 30,000 / 30,000 (K1 once a
   fit chunk on each rank, test error ≤ 1 %, ≥ 99.5 % of the test
   predictions as phase 4's, the weights' distance printed), and three
   flagship train steps split 4 / 4: in f32 at depth 2 against one
   process from the same weights (losses within 1e-5 relative, first-step
   gradients within 1e-5 of max|g|, weights within 5e-5 of max|w| of one
   process accumulating each gradient over the same row blocks, their
   distance to one process on the whole batch printed beside what
   reversing that run's batch rows moves it), in bf16 at depth 8 (K2 8 a
   step on each rank, a falling loss, ms a step on each rank); the
   class-weighted fit of a global batch at ``bench_weighted``'s shape
   (16,384 rows a rank, the masked layout, each sum over rows summed over
   the pair): in float64 within 1e-10 of max|W| of one process's float64
   fit of the same layout, in f32 within 3e-4 of max|W| of that fit, of
   one process's f32 fit of the same layout and of phase 33's grid fit,
   with the same grid fit under TF32 Grams beyond 3e-4 (the control that
   shows the limit would catch it); and the streamed
   MNIST fit under a plan budget below its state, whose materialized
   fallback featurizes 30,000 rows on each rank (rows and seconds a rank
   printed, test error ≤ 1 %).

44. tensor, pipeline and sequence parallelism at the flagship width. (a)
   One process, meshes naming the card 4 times (8 for the 3-axis one),
   f32 against the unsharded step from the same weights (losses within
   1e-5 relative, first-step gradients within 1e-5 of max|g|, the
   weights' RMS within 5e-5 of max|w|, their max printed beside what
   reversing the batch rows moves one process): TP (model 4) and pp × dp
   × tp on (2, 2, 2) at depth 2, GPipe (4 stages, n_micro 4) at depth 4;
   K2 exactly as each layout implies (8, 16 and 16 a step); then TP's
   bf16 ``train`` at depth 8 (K2 32 a step, a falling loss, ms a step,
   peak memory). (b) Two processes on the card over gloo through the
   supervisor (``--sp-worker DIR``, for this script's own use): ring and
   Ulysses scoring at seq 8,192 over the two (phase 13's model and
   windows) against the one-process ring and Ulysses on a mesh naming the
   card twice (losses within 1e-5 relative, K3 16 and 32 on ranks 0 and
   1, K2 16 a rank for Ulysses, the parameters hashing the same on both
   ranks), and one f32 TP step over a model axis of two against one
   process, as in (a).

45. serving a sharded model, one process on a mesh naming the card 4
   times. (a) f32 at depth 2 at the decode width: teacher-forced prefill
   (8 × 128) and 32 decode steps of ``shard_params(m)`` and of
   ``quantize_for_decode(shard_params(m))`` (K4 on) within 1e-5 of
   max|logit| of the unsharded pair from the same weights, K2 8 in the
   prefill and K4 1,536 in the int8 leg's steps, the sharded quantization's
   codes and scales (gathered, and the positions' pieces joined) equal to
   the whole model's bit for bit. (b) bf16 at depth 8:
   ``export_lm(shard_params(m), quantize=True, int8_kv=True)`` and
   ``export_lm(m, ...)``, 8 slots, 8 prompts of 128 tokens and 256 new
   tokens each: both graphed; by kernel name in a profiler trace, K4 192
   a step replay and K2 32 a prefill replay (48 and 8 unsharded; a weight
   piece that takes ``quantization.mm`` is printed and taken off); ms a
   pooled step in turns, tokens/s, peak memory; the sharded pool fed the
   unsharded pool's tokens picks the same next token at ≥ 99 % of the
   steps (the free-running agreement printed); K2 at (8, 4, 128, 64) and
   K4 at the pieces' shapes against their plain versions, timed beside
   them, their library calls and bounds. (c) ``ServeApp`` over (b)'s
   sharded loop answers 8 concurrent ``/generate``, all 200 with the
   loop's own tokens.

Phase 7 also holds K2 with its lse against its plain version at the train
steps' shapes, (8, 16, 2,048, 64) and (1, 8, 16,384, 64), bf16 causal.

``python3 chip_smoke.py --trace-windows N`` runs phase 41's train run ``N``
times in one process and prints each window's record: its K2 launches in
the trace, and the device records the primer took and any lost past it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without CUDA the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

# --- main path -------------------------------------------------------------
MAIN_ARGV = [
    "--synthetic", "60000", "--num-ffts", "32", "--block-size", "2048",
    "--lam", "0.01",
]
MAX_TEST_ERROR = 0.01
MIN_AGREEMENT = 0.995
K1_MAX_REL_ERR = 1e-6

# H100 SXM datasheet peaks (dense): int8 and bf16 tensor cores, HBM3
# bandwidth
INT8_PEAK_OPS = 1.979e15
BF16_PEAK_OPS = 9.89e14
HBM_BYTES_PER_S = 3.35e12

# --- LM path: the bench's decode model (bench.py LM_* and bench_lm_decode)
LM_CONF = dict(vocab=32_768, max_seq=2048, dim=1024, depth=8, num_heads=16)
LM_BATCH, LM_PROMPT, LM_MAX_NEW = 8, 128, 256
K2_BF16_TOL = 8e-3  # of max|plain|: one bf16 step after an f32 sum in another order
K2_F32_TOL = 1e-5
K2_LSE_TOL = 1e-5  # absolute
# the trainer's default attention call (the JAX package's LMConfig: seq 256,
# dim 256, 8 heads, f32), batch 8, causal: the tiled f32 kernel at D = 32
TRAINER_DEFAULT_HEADS = (8, 8, 256, 32)
K4_BF16_TOL = 8e-3
K4_F32_TOL = 1e-5
EQUIV_TOL = 1e-4  # of max|logit|, f32 kernel path vs plain path
EQUIV_ARGMAX = 0.99
EQUIV_STEPS = 32
SERVE_SLOTS, SERVE_S_MAX, SERVE_REQUESTS = 8, 512, 16
# --- HTTP path (phase 20): the server's own CLI arguments, the decode
# model's width with --quantize, and the main path's MNIST featurizer
HTTP_LM_ARGS = {"vocab": "32768", "dim": "1024", "depth": "8", "heads": "16",
                "s_max": "512", "slots": "8", "max_new": "32", "quantize": True}
HTTP_MNIST_ARGS = {"num_ffts": "32", "synthetic": "8192"}
HTTP_PREDICTS = 64

# --- scoring path: the same width with rope, 8,192 tokens over a 4-position
# ring on one card; each position holds a 2,048-token shard
SCORE_CONF = dict(LM_CONF, pos_encoding="rope")
SCORE_SEQ, SCORE_RING, SCORE_BATCH, SCORE_WINDOWS, SCORE_CHUNK = 8192, 4, 2, 4, 2048
HOP = (2, 16, SCORE_SEQ // SCORE_RING, 64)  # (B, H, S_local, D) of one ring hop
K3_TOL = 1e-5  # of max|plain|: f32 arithmetic summed in another order
RING_TOL = 1e-5  # of max|out|, f32 ring against full-sequence K2
SCORE_MODE_TOL = 1e-4  # relative, bf16 losses of ring and Ulysses against local
SCORE_LOGIT_TOL = 5e-2  # of max|logit|, bf16 ring (K3, f32 sums) against local (K2)
F32_PEAK_OPS = 6.7e13  # H100 SXM datasheet, f32 on CUDA cores
K3_PASSES = 1 + 3  # K3's bf16 tensor-core passes: Q·Kᵀ, then P·V as hi, mid, lo
RING_STEPS = SCORE_RING * (SCORE_RING + 1) // 2  # live hops of a causal ring

# --- training path: the bench's train step (bench.py:665-666, 863): the
# decode model's width, seq 2,048, batch 8, bf16, AdamW at 3e-4, no remat,
# dense CE; driven through lm_transformer.main
TRAIN_CONF = dict(vocab=32_768, dim=1024, depth=8, num_heads=16)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR, TRAIN_STEPS = 2048, 8, 3e-4, 40
TRAIN_ARGV = [
    "--vocab", "32768", "--dim", "1024", "--depth", "8", "--num-heads", "16",
    "--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--lr", str(TRAIN_LR),
    "--steps", str(TRAIN_STEPS), "--compute-dtype", "bfloat16", "--seed", "0",
]
TRAIN_LOSS_DROP = 0.10  # the mean of the last 5 losses at least 10 % below the first
TRAIN_TIMED_STEPS = 5
REMAT_LOSS_TOL = 8e-3  # relative, a remat leg's first bf16 loss against no remat
# the long-context step (bench.py:913, 941): seq 16,384, dim 512, depth 4,
# 8 heads, batch 1, rope, logit_chunk 4,096
LONG_CONF = dict(vocab=32_768, dim=512, depth=4, num_heads=8, pos_encoding="rope")
LONG_SEQ, LONG_CHUNK, LONG_STEPS = 16_384, 4096, 3
LONG_HEADS = (1, 8, LONG_SEQ, 64)  # K2's call in a long-context layer
SP_STEPS = 2  # sequence-parallel train steps per mode, at the scoring width
GRAD_TOL = 1e-4  # of max|grad| of a leaf, f32: ring/Ulysses vs local, kernel vs plain
GRAD_DEPTH = 2

# --- TIMIT path (phases 21-22): the reference's bank (4,096 cosine
# features, γ 0.05555, Gaussian W, λ 0, 5 epochs), 8 banks of its 50 (the
# (D, D) f32 state at 50 would be 168 GB), on synthetic frames
TIMIT_BANK = ["--num-cosines", "8", "--cosine-features", "4096", "--gamma", "0.05555",
              "--rf-type", "gaussian", "--lam", "0", "--num-epochs", "5"]
TIMIT_ARGV = ["--synthetic", "131072"] + TIMIT_BANK
TIMIT_SWEEP_ARGV = ["--synthetic", "32768", "--lam-sweep", "0.1,1,10"] + TIMIT_BANK
TIMIT_MAX_TEST_ERROR = 0.05


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps: int = 5, rounds: int = 3) -> float:
    """Median over ``rounds`` of the mean CUDA-event time of ``reps``
    back-to-back calls, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 20, rounds: int = 3) -> float | None:
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed, timed with CUDA events (median of ``rounds``). Unlike
    :func:`time_ms` it leaves out the host's cost of issuing each call,
    which for a microsecond kernel is most of an eager call. None if the
    function cannot be captured."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as exc:
        print(f"  (not capturable in a CUDA graph: {str(exc).splitlines()[0]})")
        torch.cuda.synchronize()
        return None
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    return smi


def _kernel_label(kernel, name: str):
    """The report's label of a compiled entry function and its dynamic
    shared memory, or None for a function the report does not cover."""
    import ctypes
    import re

    lib = kernel.lib()
    t = re.search(r"attention_kernelILi(\d+)ELi(\d+)E.*?(K2State|K3State)(I13__nv_bfloat16|If)?", name)
    if t:
        dmax, cons, state, out = t.groups()
        fn = getattr(lib, f"keystone_{kernel.name}_smem_bytes")
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
        return (f"{state}<D {dmax}, {cons} consumer warpgroups"
                + {"I13__nv_bfloat16": ", bf16 out", "If": ", f32 out"}.get(out, "") + ">",
                fn(int(dmax)))
    t = (re.search(r"flash_fwd_f32_shortILi(\d+)ELi(\d+)ELb(\d)E", name)
         or re.search(r"flash_fwd_f32ILi(\d+)ELb(\d)E", name))
    if t:
        fn = lib.keystone_flash_attention_f32_smem_bytes
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 5
        if t.lastindex == 2:
            dt, vec = map(int, t.groups())
            # its block at S_k = 65, D = DT (DT − 1 for 4-byte loads)
            return (f"K2 f32 tiled<D {dt}{', 16-byte loads' if vec else ', 4-byte loads'}>",
                    fn(1, 128, 65, dt if vec else dt - 1, vec))
        dt, kmax, vec = map(int, t.groups())
        # its block at S_q = S_k = the key tile, D = DT (ViT's, at D 32, 16 keys)
        return (f"K2 f32 short-key<D {dt}, {kmax} keys"
                f"{', 16-byte loads' if vec else ', 4-byte loads'}>",
                fn(4, kmax, kmax, dt if vec else dt - 1, vec))
    if "gram_kernel" in name:
        fn = lib.keystone_int8_gram_smem_bytes
        fn.restype, fn.argtypes = ctypes.c_int, []
        return "K1 gram_kernel<128 x 256 tiles, wgmma s8>", fn()
    t = re.search(r"transpose_kernelILb(\d)E", name)
    if t:
        return f"K1 transpose_kernel<{'16-byte' if t.group(1) == '1' else 'byte'} loads>", 0
    t = re.search(r"int8_matmul_kernelI(13__nv_bfloat16|f)Li(\d+)ELb(\d)ELb(\d)E", name)
    if t:
        dt, rows, vec, asy = t.groups()
        fn = lib.keystone_int8_matmul_smem_bytes
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
        bf16 = dt != "f"
        return (f"K4 int8_matmul_kernel<{'bf16' if bf16 else 'f32'}, {rows} rows"
                f"{', 16-byte loads' if vec == '1' else ''}{', cp.async y' if asy == '1' else ''}>",
                fn(int(rows) if bf16 else 0))
    return None


def ptxas_report(kernel) -> list:
    """Each Hopper kernel of ``kernel``'s build, as ptxas reports it:
    registers a thread, spill bytes, stack, static and dynamic shared
    memory of a block. Empty for a cached build."""
    import re

    rows, name = [], None
    for ln in kernel.ptxas_info.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            stack, st, ld = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            label = _kernel_label(kernel, name)
            if label is not None:
                static = re.search(r"(\d+) bytes smem", ln)
                rows.append({
                    "kernel": label[0], "registers": int(m.group(1)),
                    "spill_store_bytes": st, "spill_load_bytes": ld, "stack_bytes": stack,
                    "static_shared_bytes": int(static.group(1)) if static else 0,
                    "dynamic_shared_bytes": label[1],
                })
            name = None
    return rows


def phase_build(kernels) -> dict:
    from keystone_tpu_torch.core.kernels import build_all

    t0 = time.perf_counter()
    build_all(kernels)
    build_s = time.perf_counter() - t0
    print(f"build: {len(kernels)} kernel(s) in {build_s:.1f} s")
    for k in kernels:
        regs = [ln.strip() for ln in k.ptxas_info.splitlines() if "registers" in ln]
        print(f"  {k.name}: {'; '.join(regs) or 'cached build'}")
    report = [r for k in kernels for r in ptxas_report(k)]
    print("ptxas, Hopper kernels (K1, K2/K3 mainloop, K2's f32 kernels, K4): "
          + json.dumps(report))
    spilled = [r["kernel"] for r in report if r["spill_store_bytes"] or r["spill_load_bytes"]]
    check(not spilled, f"a Hopper kernel spills: {spilled}")
    return {"build_s": build_s, "ptxas": report}


def main_chunk_codes(device):
    """The centered, quantized first fit chunk of the main path: the
    synthetic train rows, the main path's featurizer (same seed), the
    fused fit's chunk size."""
    from keystone_tpu_torch.core.config import parse_config
    from keystone_tpu_torch.models import mnist_random_fft as m
    from keystone_tpu_torch.ops.gram import _quantize_cols
    from keystone_tpu_torch.plan.fused_fit import _DEFAULT_FIT_CHUNK

    conf = parse_config(m.MnistRandomFFTConfig, MAIN_ARGV)
    rows = torch.from_numpy(m._load(conf, "train").data[:_DEFAULT_FIT_CHUNK])
    bank = m.FeaturizerBank.create(
        conf.num_ffts, conf.block_size, conf.seed, rows.shape[-1], device
    )
    feats = torch.cat(bank(rows.to(device)), dim=-1)
    q, _ = _quantize_cols(feats - feats.mean(dim=0))
    return q.contiguous()


def phase_k1(device) -> dict:
    """K1 against its plain version, bit for bit: the main path's first
    chunk and ragged shapes (D ∈ {1, 127, 300, 1,000}, N % 16 ≠ 0, N = 0),
    the ragged ones also against the exact integer Gram on the CPU (the
    integer form of ``ata_int8_xla``); every result exactly symmetric.
    Timed at the main chunk beside its plain version, two ``torch._int_mm``
    yardsticks and its bound."""
    from keystone_tpu_torch.ops import gram

    q = main_chunk_codes(device)
    n, d = q.shape
    out = gram.int8_gram(q)
    torch.cuda.synchronize()
    ref = gram.int8_gram_plain(q)
    max_abs = float((out - ref).abs().max())
    rel = max_abs / float(ref.abs().max())
    exact = bool(torch.equal(out, ref))
    symmetric = bool(torch.equal(out, out.T))
    del ref
    print(f"K1 {n}x{d}: max|kernel-plain| = {max_abs:.3e}, relative {rel:.3e}, "
          f"bit for bit {exact}, symmetric {symmetric}")
    check(bool(torch.isfinite(out).all()), "K1 output not finite")
    check(rel <= K1_MAX_REL_ERR, f"K1 disagrees with its plain version ({rel:.3e})")
    check(exact, "K1 is not bit for bit its plain version at the main chunk")
    check(symmetric, "K1's result is not exactly symmetric")
    del out

    gen = torch.Generator(device=device).manual_seed(1)
    ragged, r_rel = {}, 0.0
    for rn, rd in ((1000, 300), (1037, 1), (515, 127), (517, 1000), (0, 300)):
        r = torch.randint(-127, 128, (rn, rd), dtype=torch.int8, device=device, generator=gen)
        r_out, r_ref = gram.int8_gram(r), gram.int8_gram_plain(r)
        torch.cuda.synchronize()
        integer = (r.cpu().long().T @ r.cpu().long()).float()
        same = (bool(torch.equal(r_out, r_ref)) and bool(torch.equal(r_out.cpu(), integer))
                and bool(torch.equal(r_out, r_out.T)))
        r_rel = max(r_rel, _rel(r_out, r_ref) if rn else 0.0)
        ragged[f"{rn}x{rd}"] = same
        check(same, f"K1 {rn}x{rd}: not bit for bit its plain version and the integer Gram")
    print(f"K1 ragged shapes bit for bit (plain, CPU integer Gram, symmetric): {ragged}")

    qt = q.t().contiguous()  # torch._int_mm takes row-major operands
    kernel_ms = time_ms(lambda: gram.int8_gram(q))
    plain_ms = time_ms(lambda: gram.int8_gram_plain(q), reps=2)
    # torch._int_mm(qt, q) hands cuBLASLt a row-major B it may copy first;
    # (qt, qt.t()) is A row-major, B column-major, the layouts its int8
    # path takes as they are
    int_mm_ms = {"torch._int_mm(qt, q)": time_ms(lambda: torch._int_mm(qt, q)),
                 "torch._int_mm(qt, qt.t())": time_ms(lambda: torch._int_mm(qt, qt.t()))}
    library = min(int_mm_ms, key=int_mm_ms.get)
    library_ms = int_mm_ms[library]
    # qᵀq is symmetric: its D(D+1)/2 distinct entries take N multiply-adds
    # each; the whole (D, D) f32 result is still written once
    ops = float(n) * d * (d + 1)
    traffic = n * d + 4.0 * d * d  # int8 codes read once, f32 Gram written once
    ops_ms, bytes_ms = 1e3 * ops / INT8_PEAK_OPS, 1e3 * traffic / HBM_BYTES_PER_S
    bound_ms = max(ops_ms, bytes_ms)
    tops = ops / kernel_ms / 1e9
    print(f"K1 times: kernel {kernel_ms:.3f} ms ({tops:.1f} TOP/s of the needed ops, "
          f"{tops / (INT8_PEAK_OPS / 1e12):.1%} of the int8 peak), plain {plain_ms:.3f} ms, "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in int_mm_ms.items())
          + f", bound {bound_ms:.3f} ms")
    return {
        "name": "int8_gram",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/int8_gram.cu",
        "replaces": "keystone_tpu/ops/gram.py:161",
        "shape": [n, d],
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_abs,
        "max_rel_err": rel,
        "bit_for_bit": exact,
        "ragged_max_rel_err": r_rel,
        "ragged_bit_for_bit": ragged,
        "ms": kernel_ms,
        "tops": tops,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
        "library": library,
        "int_mm_ms": int_mm_ms,
    }


def _rel(a, b) -> float:
    """max|a − b| / max|b|, in f32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def phase_k2(device) -> dict:
    """K2 against its plain version: the prefill shape, the model's
    max_seq, the scoring path's local call (2, 16, 8,192, 64), one
    Ulysses position's call (2, 4, 8,192, 64) and one tensor-parallel
    position's call at the train step (8, 4, 2,048, 64), and ragged f32
    cases with offsets (non-causal, and causal with fully masked rows) and
    the lse. Timed at those five shapes, each beside SDPA and its
    bound; and the tiled f32 kernel, causal, at (8, 16, 2,048, 64), (8,
    4, 2,048, 64), the trainer's default (8, 8, 256, 32) and (8, 16,
    2,048, 64) with the lse, each beside its plain version, SDPA f32 and
    its f32 bound."""
    import torch.nn.functional as F

    from keystone_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(2)

    def qkv(b, h, s_q, s_k, d, dtype):
        return tuple(
            torch.randn((b, h, s, d), generator=gen, device=device).to(dtype)
            for s in (s_q, s_k, s_k)
        )

    timed = {}
    for name, shape in (("prefill", (8, 16, 128, 64)), ("max_seq", (8, 16, 2048, 64)),
                        ("scoring_local", (2, 16, SCORE_SEQ, 64)),
                        ("scoring_ulysses_position", (2, 16 // SCORE_RING, SCORE_SEQ, 64)),
                        ("tp_position", (TRAIN_BATCH, TRAIN_CONF["num_heads"] // PAR_N,
                                         TRAIN_SEQ, 64))):
        b, h, s, d = shape
        q, k, v = qkv(b, h, s, s, d, torch.bfloat16)
        out = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal=True)
        err = _rel(out, ref)
        max_abs = float((out.float() - ref.float()).abs().max())
        print(f"K2 {shape} bf16 causal: max|kernel-plain| / max|plain| = {err:.3e}")
        check(bool(torch.isfinite(out).all()), f"K2 {shape} not finite")
        check(err <= K2_BF16_TOL, f"K2 {shape} disagrees with its plain version ({err:.3e})")
        kernel_ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=True))
        plain_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True),
                             reps=2 if s <= 2048 else 1)
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        eager_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True), reps=20)
        ops = 4.0 * b * h * d * s * (s + 1) / 2  # the causal triangle
        traffic = 4.0 * b * h * s * d * 2  # q, k, v read once, o written once
        ops_ms, bytes_ms = 1e3 * ops / BF16_PEAK_OPS, 1e3 * traffic / HBM_BYTES_PER_S
        timed[name] = {
            "shape": list(shape), "max_abs_err": max_abs, "max_rel_err": err,
            "ms": kernel_ms, "eager_call_ms": eager_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        }
        print(f"K2 {shape} device times: kernel {kernel_ms} ms, plain {plain_ms} ms, "
              f"sdpa {library_ms} ms, bound {max(ops_ms, bytes_ms):.4f} ms; "
              f"eager kernel call {eager_ms:.4f} ms")

    ragged = {}
    for causal, q_off, k_off in ((False, 5, 3), (True, 3, 40)):
        q, k, v = qkv(2, 3, 77, 50, 40, torch.float32)
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off, return_lse=True)
        out, lse = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
        err, lse_err = _rel(out, ref), float((lse - ref_lse).abs().max())
        dead = int((ref_lse[0, 0] <= -1e29).sum())
        print(f"K2 (2,3,77,40) vs S_k 50 f32 causal={causal} offsets ({q_off},{k_off}): "
              f"relative {err:.3e}, lse {lse_err:.3e}, fully masked rows {dead}")
        check(err <= K2_F32_TOL, f"K2 ragged f32 disagrees ({err:.3e})")
        check(lse_err <= K2_LSE_TOL, f"K2 lse disagrees ({lse_err:.3e})")
        check(not causal or dead > 0, "K2 ragged causal case has no fully masked row")
        check(bool((out[:, :, :dead] == 0).all()), "K2 fully masked rows are not 0")
        ragged[f"causal={causal}"] = {"max_rel_err": err, "lse_max_abs_err": lse_err,
                                      "fully_masked_rows": dead}
    # the train steps' shapes, with the lse their blockwise backward reads
    at_train = {}
    for name, shape in (("flagship_train", (8, 16, 2048, 64)), ("long_context", LONG_HEADS)):
        b, h, s, d = shape
        q, k, v = qkv(b, h, s, s, d, torch.bfloat16)
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
        err, lse_err = _rel(out, ref), float((lse - ref_lse).abs().max())
        print(f"K2 {shape} bf16 causal with lse: max|kernel-plain| / max|plain| = {err:.3e}, "
              f"lse max abs {lse_err:.3e}")
        check(bool(torch.isfinite(out).all()), f"K2 {shape} with lse not finite")
        check(err <= K2_BF16_TOL, f"K2 {shape} with lse disagrees ({err:.3e})")
        check(lse_err <= K2_LSE_TOL, f"K2 {shape} lse disagrees ({lse_err:.3e})")
        at_train[name] = {"shape": list(shape), "max_rel_err": err, "lse_max_abs_err": lse_err}
        del q, k, v, out, lse, ref, ref_lse
    # the tiled f32 kernel (S_k > 64), causal, at the f32 equivalence legs'
    # shapes (phases 9, 18, 44), the trainer's default, and the flagship
    # with the lse the blockwise backward reads: on CUDA cores, so bounded
    # by the f32 peak
    f32_tiled = {}
    for name, shape, with_lse in (
            ("flagship", (8, 16, 2048, 64), False),
            ("tp_position", (TRAIN_BATCH, TRAIN_CONF["num_heads"] // PAR_N, TRAIN_SEQ, 64), False),
            ("trainer_default", TRAINER_DEFAULT_HEADS, False),
            ("flagship_with_lse", (8, 16, 2048, 64), True)):
        b, h, s, d = shape
        q, k, v = qkv(b, h, s, s, d, torch.float32)
        kw = dict(causal=True, return_lse=with_lse)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, **kw)
        out, ref_out = (got[0], ref[0]) if with_lse else (got, ref)
        err = _rel(out, ref_out)
        lse_err = float((got[1] - ref[1]).abs().max()) if with_lse else None
        check(bool(torch.isfinite(out).all()), f"K2 {shape} f32 not finite")
        check(err <= K2_F32_TOL, f"K2 {shape} f32 causal disagrees with its plain version ({err:.3e})")
        check(lse_err is None or lse_err <= K2_LSE_TOL, f"K2 {shape} f32 lse disagrees ({lse_err})")
        kernel_ms = device_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=5)
        plain_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), reps=1)
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                               reps=5)
        ops = 4.0 * b * h * d * s * (s + 1) / 2  # the causal triangle
        # q, k, v read once, o (and the lse) written once, f32
        traffic = 4.0 * b * h * s * (4 * d + (1 if with_lse else 0))
        ops_ms, bytes_ms = 1e3 * ops / F32_PEAK_OPS, 1e3 * traffic / HBM_BYTES_PER_S
        bound_ms = max(ops_ms, bytes_ms)
        f32_tiled[name] = {
            "shape": list(shape), "max_rel_err": err, "lse_max_abs_err": lse_err,
            "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "scaled_dot_product_attention, f32",
            "bound_ms": bound_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_share": bound_ms / kernel_ms if kernel_ms else None,
        }
        print(f"K2 {shape} f32 causal{' with lse' if with_lse else ''} (tiled kernel): "
              f"max|kernel-plain| / max|plain| = {err:.3e}"
              + ("" if lse_err is None else f", lse max abs {lse_err:.3e}")
              + f"; device times kernel {kernel_ms} ms, plain {plain_ms} ms, sdpa "
              f"{library_ms} ms, bound {bound_ms:.4f} ms ({bound_ms / kernel_ms:.1%})")
        del q, k, v, got, ref, out, ref_out
    main = timed["prefill"]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/flash_attention.cu",
        "replaces": "keystone_tpu/ops/flash_attention.py:372",
        "shape": main["shape"],
        "launches": None,  # filled from the main path's run
        "max_abs_err": main["max_abs_err"],
        "max_rel_err": main["max_rel_err"],
        "ms": main["ms"],
        "eager_call_ms": main["eager_call_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True)",
        "timing": "device time, CUDA-graph replay; eager_call_ms is a Python call",
        "at_max_seq": timed["max_seq"],
        "at_scoring_shapes": {n: timed[n] for n in ("scoring_local", "scoring_ulysses_position")},
        "at_tp_position": timed["tp_position"],
        "ragged_f32": ragged,
        "at_train_shapes_with_lse": at_train,
        "f32_tiled": f32_tiled,
    }


def phase_k4(device) -> dict:
    """K4 against its plain version at the decode step's shapes (M = 8
    rows against the block matrices) and M = 64 and a ragged case, in
    f32 and bf16; timed at each M = 8 shape."""
    from keystone_tpu_torch.ops import int8_matmul as im
    from keystone_tpu_torch.ops.quantization import mm, quantize_int8

    gen = torch.Generator(device=device).manual_seed(3)
    cases = [(8, 1024, 1024), (8, 1024, 4096), (8, 4096, 1024), (64, 1024, 4096), (3, 1000, 300)]
    shapes = []
    for m, k, n in cases:
        w = quantize_int8(torch.randn((k, n), generator=gen, device=device))
        y32 = torch.randn((m, k), generator=gen, device=device)
        for dt, tol in ((torch.float32, K4_F32_TOL), (torch.bfloat16, K4_BF16_TOL)):
            y = y32.to(dt)
            out = im.mm_fused(y, w)
            torch.cuda.synchronize()
            ref = im.mm_fused_plain(y, w)
            err = _rel(out, ref)
            max_abs = float((out.float() - ref.float()).abs().max())
            check(out.dtype == dt and bool(torch.isfinite(out).all()), f"K4 {m}x{k}x{n} output")
            check(err <= tol, f"K4 {m}x{k}x{n} {dt} disagrees with its plain version ({err:.3e})")
            row = {"m": m, "k": k, "n": n, "dtype": str(dt).split(".")[-1],
                   "max_abs_err": max_abs, "max_rel_err": err}
            if m == 8:
                row["ms"] = device_ms(lambda: im.mm_fused(y, w))
                row["plain_ms"] = device_ms(lambda: im.mm_fused_plain(y, w))
                row["eager_call_ms"] = time_ms(lambda: im.mm_fused(y, w), reps=20)
                row["eager_mm_ms"] = time_ms(lambda: mm(y, w, dt), reps=20)
                traffic = k * n + y.element_size() * m * k + 4 * n + y.element_size() * m * n
                ops = 2.0 * m * k * n
                ops_ms = 1e3 * ops / (BF16_PEAK_OPS if dt == torch.bfloat16 else 6.7e13)
                bytes_ms = 1e3 * traffic / HBM_BYTES_PER_S
                row["bound_ms"] = max(ops_ms, bytes_ms)
                row["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
                row["two_call_ms"] = device_ms(lambda: (y @ w.q.to(dt)))
            print(f"K4 {m}x{k}x{n} {row['dtype']}: relative {err:.3e}"
                  + (f", device: kernel {row['ms']} ms, plain {row['plain_ms']} ms, "
                     f"bound {row['bound_ms']:.5f} ms, y @ q.to(dt) {row['two_call_ms']} ms; "
                     f"eager call: kernel {row['eager_call_ms']:.4f} ms, "
                     f"quantization.mm {row['eager_mm_ms']:.4f} ms"
                     if m == 8 else ""))
            shapes.append(row)

    # one launch, replayed: a CUDA graph of one call gives the eager bits
    # on every replay (nothing carried between launches)
    m, k, n = 8, 1024, 4096
    w = quantize_int8(torch.randn((k, n), generator=gen, device=device))
    y = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    eager = im.mm_fused(y, w)
    im.mm_fused(y, w)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = im.mm_fused(y, w)
    replays_equal = True
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays_equal &= bool(torch.equal(captured, eager))
    del graph
    print(f"K4 {m}x{k}x{n} bf16: 3 CUDA-graph replays give the eager bits: {replays_equal}")
    check(replays_equal, "K4 under CUDA-graph replay differs from its eager call")

    # the library yardstick: one PyTorch call for the same function, if
    # this build runs it on CUDA
    w = quantize_int8(torch.randn((k, n), generator=gen, device=device))
    y = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    q_nk, scales = w.q.t().contiguous(), w.scale[0].to(torch.bfloat16).contiguous()
    try:
        torch._weight_int8pack_mm(y, q_nk, scales)
        torch.cuda.synchronize()
        library_ms = device_ms(lambda: torch._weight_int8pack_mm(y, q_nk, scales))
        library = "torch._weight_int8pack_mm"
    except (RuntimeError, NotImplementedError) as exc:
        library_ms, library = None, f"no single PyTorch call ({type(exc).__name__})"
    print(f"K4 library: {library}, {library_ms}")
    main = next(r for r in shapes if (r["m"], r["k"], r["n"], r["dtype"]) == (8, 1024, 4096, "bfloat16"))
    return {
        "name": "int8_matmul",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "keystone_tpu/ops/int8_matmul.py:121",
        "shape": [main["m"], main["k"], main["n"]],
        "launches": None,  # filled from the main path's run
        "max_abs_err": main["max_abs_err"],
        "max_rel_err": main["max_rel_err"],
        "ms": main["ms"],
        "eager_call_ms": main["eager_call_ms"],
        "eager_mm_ms": main["eager_mm_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": library_ms,
        "library": library,
        "timing": "device time, CUDA-graph replay; eager_* are Python calls",
        "two_call_ms": main["two_call_ms"],
        "graph_replays_equal": replays_equal,
        "shapes": shapes,
    }


def _kernels() -> list:
    from keystone_tpu_torch.ops import flash_attention, gram, int8_matmul

    return [gram.INT8_GRAM, flash_attention.FLASH_ATTENTION,
            flash_attention.FLASH_ATTENTION_STEP, int8_matmul.INT8_MATMUL]


def _counts() -> dict:
    return {k.name: k.launches for k in _kernels()}


def _zero_counts() -> None:
    for k in _kernels():
        k.launches = 0


def _wall(fn, iters: int) -> float:
    """Seconds per call of an already warm ``fn``, as bench.py's _timed:
    ``iters`` calls and one synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def device_profile(step, steps: int, track: str = "int8_matmul") -> dict | None:
    """``steps`` calls of an already warm ``step`` under torch.profiler:
    the device's busy share of the wall time, kernels launched per call,
    the kernels that take the most device time, and the device time per
    call of the kernels whose name holds ``track``. None, with the reason
    printed, when the profiler shows no device time on this machine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies, memsets): an operator's row
    # also carries the device time of the kernels it launched, and summing
    # both would count that time twice
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        on_device = getattr(e, "device_type", None) == DeviceType.CUDA
        if us > 0 and (on_device or e.self_cpu_time_total == 0):
            rows.append((us, e.count, e.key))
    if not rows:
        print("profile: the profiler shows no device time here")
        return None
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    kernels = sum(r[1] for r in rows)
    tracked = [(us, c) for us, c, k in rows if track in k]
    return {
        "steps": steps,
        f"{track}_ms_per_step": sum(us for us, _ in tracked) / 1e3 / steps,
        f"{track}_launches_per_step": sum(c for _, c in tracked) / steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_kernels_per_step": kernels / steps,
        "top": [{"name": k[:80], "calls_per_step": c / steps, "ms_per_step": us / 1e3 / steps}
                for us, c, k in rows[:8]],
    }


def decode_profile(model, prompt, steps: int = 8) -> dict | None:
    """:func:`device_profile` of ``steps`` decode steps after a prefill."""
    from keystone_tpu_torch.models.lm import decode

    logits, cache = decode.prefill(model, prompt, LM_PROMPT + steps + 2)
    tok = logits.argmax(-1)
    state = {"cache": cache}
    for _ in range(2):
        _, state["cache"] = decode.decode_step(model, tok, state["cache"])

    def step():
        _, state["cache"] = decode.decode_step(model, tok, state["cache"])

    return device_profile(step, steps)


def phase_lm(device) -> dict:
    """The LM main path at the bench's width, three legs."""
    import numpy as np

    from keystone_tpu_torch.models.lm import TransformerLM, decode, generate, quantize_for_decode

    gen = torch.Generator(device=device).manual_seed(0)
    model = TransformerLM.create(**LM_CONF, compute_dtype="bfloat16", device=device,
                                 generator=gen)
    qmodel = quantize_for_decode(model)
    depth = LM_CONF["depth"]
    print(f"LM: {model.num_params():,} parameters, int8 model "
          f"{qmodel.num_params():,} values")
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(0, LM_CONF["vocab"], size=(LM_BATCH, LM_PROMPT))
    ).to(device)
    legs = {"float": model, "int8_mm": qmodel, "int8_kernel": qmodel.replace(int8_kernel="kernel")}
    res = {}
    for name, m in legs.items():
        generate(m, prompt, max_new=2)  # first use: cuBLAS, kernels loaded
        torch.cuda.synchronize()
        _zero_counts()
        generate(m, prompt, max_new=1)
        torch.cuda.synchronize()
        prefill_counts = _counts()
        # the main path's run: counts from zero, one generate
        _zero_counts()
        out = generate(m, prompt, max_new=LM_MAX_NEW)
        torch.cuda.synchronize()
        counts = _counts()
        k4_want = 6 * depth * (LM_MAX_NEW - 1) if name == "int8_kernel" else 0
        print(f"LM [{name}] launches: prefill {prefill_counts}, generate {counts}")
        check(prefill_counts["flash_attention"] == depth,
              f"{name}: K2 launched {prefill_counts['flash_attention']} times in a prefill")
        check(counts["flash_attention"] == depth, f"{name}: K2 launches {counts}")
        check(counts["int8_matmul"] == k4_want, f"{name}: K4 launched "
              f"{counts['int8_matmul']} times, want {k4_want}")
        check(out.shape == (LM_BATCH, LM_MAX_NEW) and out.dtype == torch.int32,
              f"{name}: output {tuple(out.shape)} {out.dtype}")
        check(bool(((out >= 0) & (out < LM_CONF["vocab"])).all()), f"{name}: token out of range")
        logits, cache = decode.prefill(m, prompt, LM_PROMPT + 2)
        nan = bool(torch.isnan(logits).any())
        logits, _ = decode.decode_step(m, out[:, 0], cache)
        check(not nan and not bool(torch.isnan(logits).any()), f"{name}: NaN logits")
        prof = decode_profile(m, prompt)
        if prof is not None:
            print(f"LM [{name}] decode step profile: wall {prof['wall_ms_per_step']:.3f} ms, "
                  f"K4 {prof['int8_matmul_ms_per_step']:.4f} ms in "
                  f"{prof['int8_matmul_launches_per_step']:.0f} launches, "
                  f"device busy {prof['device_busy_ms_per_step']:.3f} ms "
                  f"({prof['device_busy_share']:.1%}), {prof['device_kernels_per_step']:.0f} "
                  f"kernels a step; top: "
                  + "; ".join(f"{t['name'][:40]} {t['ms_per_step']:.3f} ms" for t in prof["top"][:4]))
        res[name] = {"decode_profile": prof, "launches": counts}

    # the legs in turns (float, mm, kernel, kernel, mm, float): the host's
    # load moves between calls, so each leg is read twice, apart
    for name in [*legs, *reversed(legs)]:
        m = legs[name]
        sec_prefill = _wall(lambda: generate(m, prompt, max_new=1), iters=2)
        sec_full = _wall(lambda: generate(m, prompt, max_new=LM_MAX_NEW), iters=1)
        step_s = max(sec_full - sec_prefill, 1e-9) / (LM_MAX_NEW - 1)
        res[name].setdefault("turns", []).append(
            {"prefill_ms": sec_prefill * 1e3, "generate_ms": sec_full * 1e3,
             "ms_per_step": step_s * 1e3})
        print(f"LM [{name}]: prefill {sec_prefill * 1e3:.2f} ms, {step_s * 1e3:.3f} ms/step, "
              f"{LM_BATCH / step_s:.1f} tokens/s")
    for name, r in res.items():
        for key in ("prefill_ms", "generate_ms", "ms_per_step"):
            r[key] = statistics.mean(t[key] for t in r["turns"])
        r["tokens_per_s"] = LM_BATCH / (r["ms_per_step"] / 1e3)
    return {
        "config": {**LM_CONF, "batch": LM_BATCH, "prompt": LM_PROMPT, "max_new": LM_MAX_NEW,
                   "compute_dtype": "bfloat16", "params": model.num_params()},
        "legs": res,
        "kernel_leg_launches": res["int8_kernel"]["launches"],
        "model": model,
        "qmodel": legs["int8_kernel"],
    }


class tiled_f32_tally:
    """Counts, while open, the launches of the tiled f32 kernel in this
    process, as K2's C entry point counts them where it launches that
    kernel: the route K2's f32 calls took, beside K2's own count of
    both routes."""

    def __enter__(self):
        import ctypes

        from keystone_tpu_torch.ops import flash_attention as fa

        self._read = fa.FLASH_ATTENTION.lib().keystone_flash_attention_f32_tiled_launches
        self._read.restype, self._read.argtypes = ctypes.c_longlong, []
        self._start, self.launches = self._read(), 0
        return self

    def __exit__(self, *exc):
        self.launches = self._read() - self._start


def phase_equivalence(device, model) -> dict:
    """The same weights in f32, int8: prefill plus teacher-forced decode
    steps through the kernels and through the plain path."""
    import numpy as np

    from keystone_tpu_torch.models.lm import decode, quantize_for_decode

    q32 = quantize_for_decode(model.replace(compute_dtype="float32"))
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, LM_CONF["vocab"],
                                          size=(LM_BATCH, LM_PROMPT + EQUIV_STEPS))
    ).to(device)
    s_max = LM_PROMPT + EQUIV_STEPS

    def run(m):
        logits, cache = decode.prefill(m, toks[:, :LM_PROMPT], s_max)
        out = [logits]
        for j in range(EQUIV_STEPS):
            logits, cache = decode.decode_step(m, toks[:, LM_PROMPT + j], cache)
            out.append(logits)
        return torch.stack(out)

    _zero_counts()
    with tiled_f32_tally() as tally:
        kern = run(q32.replace(int8_kernel="kernel"))
    counts = _counts()
    os.environ["KST_LOCAL_ATTN"] = "dense"
    try:
        plain = run(q32.replace(int8_kernel="mm"))
    finally:
        del os.environ["KST_LOCAL_ATTN"]
    check(counts["flash_attention"] == LM_CONF["depth"] and
          counts["int8_matmul"] == 6 * LM_CONF["depth"] * EQUIV_STEPS,
          f"equivalence: the kernel path launched {counts}")
    check(_counts() == counts, "equivalence: the plain path launched a kernel")
    err = _rel(kern, plain)
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"f32 equivalence, {EQUIV_STEPS} steps: max|kernel-plain| / max|logit| = "
          f"{err:.3e}, argmax agreement {agree:.4%}")
    check(bool(torch.isfinite(kern).all()), "equivalence: logits not finite")
    check(err <= EQUIV_TOL, f"equivalence: logits differ by {err:.3e} of max")
    check(agree >= EQUIV_ARGMAX, f"equivalence: argmax agreement {agree:.4%}")
    check(tally.launches == LM_CONF["depth"], f"equivalence: {tally.launches} tiled f32 launches")
    # the step that runs the tiled kernel: the f32 prefill, warm
    k32 = q32.replace(int8_kernel="kernel")
    prefill_ms = time_ms(lambda: decode.prefill(k32, toks[:, :LM_PROMPT], s_max), reps=3)
    print(f"  f32 prefill ({LM_BATCH} x {LM_PROMPT} tokens): {prefill_ms:.3f} ms, "
          f"{tally.launches} tiled f32 launches in the kernel path")
    return {"max_rel_err": err, "argmax_agreement": agree, "steps": EQUIV_STEPS,
            "tiled_f32_launches": tally.launches, "prefill_ms": prefill_ms}


def _serve_requests():
    """Phase 10's seeded requests: (prompts, answer lengths)."""
    import numpy as np

    rng = np.random.default_rng(5)
    lens = rng.integers(4, 257, size=SERVE_REQUESTS)
    news = rng.integers(32, 129, size=SERVE_REQUESTS)
    prompts = [rng.integers(0, LM_CONF["vocab"], size=int(n)) for n in lens]
    return prompts, [int(n) for n in news]


# K2 (f32 and bf16 entry kernels) and K4 by their names in a profiler trace
TRACE_NAMES = {"flash_attention": ("flash_fwd_f32", "attention_kernel"),
               "int8_matmul": ("int8_matmul_kernel",)}


TRACE_ATTEMPTS = 3
PRIMER_GAP_S = 0.002


def traced_launches(fn, margin_s: float = 0.0, reset=None) -> dict:
    """One call of ``fn`` under torch.profiler: the launches of K2 and K4
    counted by kernel name in the trace (CUDA-graph replays included,
    where the wrappers count nothing), the device's busy time and share
    of the wall. ``margin_s`` of idle time inside the trace before and
    after the call keep launches from other threads clear of the trace's
    start and stop.

    A session's first device records can come back stamped before it
    began and be dropped (ROADMAP §C): each session opens with
    ``core.profiling``'s primer, whose records take that loss, and only
    the device records that start after the primer's region ends count.

    A session whose trace holds no device activity at all is taken again,
    up to ``TRACE_ATTEMPTS`` sessions, after ``reset()`` where the call
    changes state: in one run of this script on the H100 (torch 2.11,
    CUDA 12.8) the session of one prefill replay came back with no device
    time, where every other run of the same phase recorded its kernels.
    The counts are read from the one session that recorded, and must be
    what they always had to be; ``empty_sessions`` says how many did not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from keystone_tpu_torch.core import profiling

    for attempt in range(TRACE_ATTEMPTS):
        if reset is not None and attempt:
            reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiling.prime()
            # the primer ends synchronized; the gap keeps the call's first
            # kernels clear of its region's end
            time.sleep(max(margin_s, PRIMER_GAP_S))
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(margin_s)
        events = prof.events()
        after = max(e.time_range.end for e in events if e.name == profiling.PRIMER_REGION)
        counts = dict.fromkeys(TRACE_NAMES, 0)
        busy_us, kernels, graph_launches = 0.0, 0, 0
        for e in events:
            if e.time_range.start <= after:
                continue
            if "cudaGraphLaunch" in e.name:
                graph_launches += 1
            if e.device_type == DeviceType.CUDA and e.time_range.elapsed_us() > 0:
                busy_us += e.time_range.elapsed_us()
                kernels += 1
                for k, names in TRACE_NAMES.items():
                    if any(n in e.name for n in names):
                        counts[k] += 1
        if busy_us > 0:
            break
        print(f"trace: session {attempt + 1} of {TRACE_ATTEMPTS} recorded no device time "
              f"({graph_launches} cudaGraphLaunch calls on the host side)")
    check(busy_us > 0, f"the profiler shows no device time in {TRACE_ATTEMPTS} sessions: "
          "graphed launches cannot be counted")
    return {"launches": counts, "device_kernels": kernels, "device_busy_ms": busy_us / 1e3,
            "wall_ms": wall * 1e3, "device_busy_share": busy_us / 1e6 / wall, "out": out,
            "empty_sessions": attempt}


def phase_serving(device, qmodel) -> dict:
    """The pool through ``export_lm``: every program captured as a CUDA
    graph by ``warm()``; seeded requests, aggregate tokens/s; then, from
    one pool state, the graphed step against the eager one (time, tokens
    over 64 steps) and each prefill bucket graphed against eager."""
    import numpy as np

    from keystone_tpu_torch.serve.export import export_lm

    prompts, news = _serve_requests()
    loop = export_lm(qmodel, slots=SERVE_SLOTS, s_max=SERVE_S_MAX, max_new=32)
    check(loop.graphed and len(loop._prefill_graphs) == len(loop.prefill_buckets),
          "serving: export_lm did not capture the pool's graphs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [loop.submit(p, max_new=n) for p, n in zip(prompts, news)]
    steps = 0
    while not all(f.done() for f in futs):
        if loop.step():
            steps += 1
        elif not loop.pending():
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [f.result(timeout=0) for f in futs]
    for o, n in zip(outs, news):
        check(len(o) == n, f"serving: a request got {len(o)} tokens, asked {n}")
        check(bool(((o >= 0) & (o < LM_CONF["vocab"])).all()), "serving: token out of range")
    tokens = loop.tokens_out
    check(tokens == sum(news), f"serving: tokens_out {tokens}")
    fill = loop.occupancy_steps / max(steps * SERVE_SLOTS, 1)
    print(f"serving (graphed): {SERVE_REQUESTS} requests, {loop.tokens_out} tokens in "
          f"{wall:.3f} s ({loop.tokens_out / wall:.1f} tokens/s), {steps} steps, mean slot "
          f"fill {fill:.3f}")

    # one pool state, every slot busy: the graphed step against the eager
    for p in prompts[:SERVE_SLOTS]:
        loop.submit(p, max_new=128)
    loop._admit()
    cache = loop.cache
    state = [t.clone() for t in (cache.k, cache.v, cache.pos)]
    tok = loop._tok.copy()

    def restore():
        for buf, saved in zip((cache.k, cache.v, cache.pos), state):
            buf.copy_(saved)

    def eager_step():
        return loop._pool_step(torch.from_numpy(tok).to(device))[0].cpu().numpy()

    step_fns = {"graphed": lambda: loop._run_step(tok), "eager": eager_step}
    step_ms: dict = {"graphed": [], "eager": []}
    prefill: dict = {}
    with torch.inference_mode():
        g = loop._step_graph
        tok0 = torch.from_numpy(tok).to(device)

        def greedy(graphed: bool):
            restore()
            t, out = tok0.clone(), []
            for _ in range(64):
                if graphed:
                    g.inputs[0].copy_(t)
                    g.graph.replay()
                    t = g.outputs[0].clone()
                else:
                    t = loop._pool_step(t)[0]
                out.append(t)
            return torch.stack(out)

        same_tokens = bool(torch.equal(greedy(True), greedy(False)))
        restore()
        g.inputs[0].copy_(tok0)
        g.graph.replay()
        g_logits = g.outputs[1].clone()
        restore()
        e_logits = loop._pool_step(tok0)[1]
        logit_err = _rel(g_logits, e_logits)
        # in turns (graphed, eager, eager, graphed), 50 steps each from the
        # same state; a step is the token copy-in, the step, the read-back
        for name in ("graphed", "eager", "eager", "graphed"):
            restore()
            step_ms[name].append(_wall(step_fns[name], iters=50) * 1e3)
        restore()
        step_trace = traced_launches(lambda: [loop._run_step(tok) for _ in range(8)],
                                     reset=restore)
        restore()
        rng = np.random.default_rng(6)
        for width in loop.prefill_buckets:
            n = width
            padded = np.zeros((1, width), np.int64)
            padded[0] = rng.integers(0, LM_CONF["vocab"], size=width)
            toks, lens = torch.from_numpy(padded).to(device), torch.tensor([n], device=device)
            fns = {"graphed": lambda: loop._run_prefill(padded, n)[0],
                   "eager": lambda: int(loop._prefill(toks, lens)[0][0])}
            same = fns["graphed"]() == fns["eager"]()
            ms: dict = {"graphed": [], "eager": []}
            for name in ("graphed", "eager", "eager", "graphed"):
                ms[name].append(_wall(fns[name], iters=10) * 1e3)
            trace = traced_launches(fns["graphed"])
            prefill[width] = {"graphed_ms": statistics.mean(ms["graphed"]),
                              "eager_ms": statistics.mean(ms["eager"]), "turns": ms,
                              "same_first_token": same, "launches": trace["launches"],
                              "device_busy_ms": trace["device_busy_ms"]}
            print(f"serving: prefill width {width}: graphed {prefill[width]['graphed_ms']:.3f} ms, "
                  f"eager {prefill[width]['eager_ms']:.3f} ms, launches {trace['launches']}")
            check(same, f"serving: prefill width {width}: graphed and eager first tokens differ")
            check(trace["launches"]["flash_attention"] == LM_CONF["depth"],
                  f"serving: prefill width {width}: K2 {trace['launches']} in one replay")
    graphed_ms = statistics.mean(step_ms["graphed"])
    eager_ms = statistics.mean(step_ms["eager"])
    k4_per_step = step_trace["launches"]["int8_matmul"] / 8
    print(f"serving: pooled step, {SERVE_SLOTS} slots busy: graphed {graphed_ms:.3f} ms, eager "
          f"{eager_ms:.3f} ms (turns {step_ms}), device busy "
          f"{step_trace['device_busy_ms'] / 8:.3f} ms a step ({step_trace['device_busy_share']:.1%} "
          f"of the replays' wall), {step_trace['device_kernels'] / 8:.0f} kernels and {k4_per_step:.0f} "
          f"K4 launches a replay (profiler); 64 greedy steps same tokens: {same_tokens}, first "
          f"step's logits {logit_err:.2e} of max")
    check(same_tokens, "serving: the graphed pool step does not reproduce the eager tokens")
    check(k4_per_step == 6 * LM_CONF["depth"], f"serving: K4 {k4_per_step} launches a replay")
    check(graphed_ms <= eager_ms, f"serving: graphed step {graphed_ms:.3f} ms slower than "
          f"eager {eager_ms:.3f} ms")
    return {"requests": SERVE_REQUESTS, "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall, "steps": steps, "mean_slot_fill": fill,
            "step_ms": {"graphed": graphed_ms, "eager": eager_ms, "turns": step_ms,
                        "device_busy_ms": step_trace["device_busy_ms"] / 8,
                        "device_kernels": step_trace["device_kernels"] / 8,
                        "k4_launches": k4_per_step, "launch_count": "profiler trace"},
            "same_tokens_64_steps": same_tokens, "first_step_logit_rel_err": logit_err,
            "prefill": prefill}


class _CountedGraph:
    """A captured graph whose replays are counted, so a profiler trace's
    kernel count can be held against the replays that ran."""

    def __init__(self, graph, key, counts: dict):
        self.graph, self.key, self.counts = graph, key, counts

    def replay(self):
        self.counts[self.key] = self.counts.get(self.key, 0) + 1
        self.graph.replay()


def count_replays(loop) -> dict:
    """Count the decode loop's graph replays from now on: {"step": n,
    width: n, ...}."""
    counts: dict = {}
    loop._step_graph = loop._step_graph._replace(
        graph=_CountedGraph(loop._step_graph.graph, "step", counts))
    for w, g in list(loop._prefill_graphs.items()):
        loop._prefill_graphs[w] = g._replace(graph=_CountedGraph(g.graph, w, counts))
    return counts


def _http(url: str, body: dict | None = None, timeout: float = 120.0):
    """(status, JSON payload or text, seconds) of one request."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read().decode()
        status = r.status
    sec = time.perf_counter() - t0
    return status, (json.loads(raw) if raw.startswith("{") else raw), sec


def _burst(calls) -> tuple:
    """Every call at once, one thread each: (answers in call order, wall
    seconds)."""
    import threading

    out = [None] * len(calls)

    def run(i):
        out[i] = calls[i]()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "http: a request never returned")
    check(all(o is not None for o in out), "http: a request failed on the client")
    return out, wall


def _latency(answers, wall: float) -> dict:
    secs = sorted(a[2] for a in answers)
    return {"requests": len(answers), "wall_s": wall, "requests_per_s": len(answers) / wall,
            "p50_ms": statistics.median(secs) * 1e3,
            "p99_ms": secs[min(len(secs) - 1, math.ceil(0.99 * len(secs)) - 1)] * 1e3}


def phase_http(device) -> dict:
    """The HTTP front end on the card: ``build_app("lm")`` at the decode
    width with ``--quantize`` and ``build_app("mnist")`` at the main
    path's width, each on a ThreadingHTTPServer on 127.0.0.1:0, driven by
    concurrent ``/generate`` and ``/predict`` requests."""
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np

    from keystone_tpu_torch.observe import metrics
    from keystone_tpu_torch.serve import server

    reg = metrics.get_registry()
    _zero_counts()
    t0 = time.perf_counter()
    lm_app = server.build_app("lm", HTTP_LM_ARGS, device=device)
    lm_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mnist_app = server.build_app("mnist", HTTP_MNIST_ARGS, device=device)
    mnist_build_s = time.perf_counter() - t0
    apps = (lm_app, mnist_app)
    httpds = [ThreadingHTTPServer(("127.0.0.1", 0), server._handler_for(a)) for a in apps]
    threads = [threading.Thread(target=h.serve_forever, kwargs={"poll_interval": 0.05},
                                daemon=True) for h in httpds]
    for t in threads:
        t.start()
    lm_url, mnist_url = (f"http://127.0.0.1:{h.server_address[1]}" for h in httpds)
    replays = count_replays(lm_app.loop)
    try:
        prompts, news = _serve_requests()
        gen_calls = [lambda p=p, n=n: _http(lm_url + "/generate", {"prompt": p.tolist(),
                                                                   "max_new": n})
                     for p, n in zip(prompts, news)]
        gen, gen_wall = _burst(gen_calls)
        steps = replays.get("step", 0)
        tokens = 0
        for (status, payload, _), n in zip(gen, news):
            check(status == 200, f"http: /generate answered {status}")
            toks = np.asarray(payload["tokens"])
            check(len(toks) == n, f"http: /generate gave {len(toks)} tokens, asked {n}")
            check(bool(((toks >= 0) & (toks < int(HTTP_LM_ARGS["vocab"]))).all()),
                  "http: token out of range")
            tokens += n
        generate = {**_latency(gen, gen_wall), "tokens": tokens,
                    "tokens_per_s": tokens / gen_wall, "step_replays": steps,
                    "wall_ms_per_step_replay": gen_wall * 1e3 / steps}
        print(f"http /generate: {len(gen)} concurrent, {tokens} tokens in {gen_wall:.3f} s "
              f"({generate['tokens_per_s']:.1f} tokens/s, {generate['requests_per_s']:.2f} "
              f"requests/s), p50 {generate['p50_ms']:.1f} ms, p99 {generate['p99_ms']:.1f} ms, "
              f"{steps} step replays ({generate['wall_ms_per_step_replay']:.3f} ms of wall each)")

        rng = np.random.default_rng(20)
        sizes = rng.integers(1, 41, size=HTTP_PREDICTS)
        rows = [rng.normal(size=(int(k), 784)).astype(np.float32) for k in sizes]
        pred, pred_wall = _burst([lambda r=r: _http(mnist_url + "/predict", {"rows": r.tolist()})
                                  for r in rows])
        with torch.inference_mode():
            pipe = mnist_app.exported.pipe
            for (status, payload, _), r in zip(pred, rows):
                check(status == 200, f"http: /predict answered {status}")
                want = pipe(torch.from_numpy(r).to(device)).cpu().numpy().tolist()
                check(payload["predictions"] == want,
                      "http: /predict differs from the eager pipeline's classes")
        predict = {**_latency(pred, pred_wall), "rows": int(sizes.sum())}
        print(f"http /predict: {len(pred)} concurrent, {int(sizes.sum())} rows in "
              f"{pred_wall:.3f} s ({predict['requests_per_s']:.1f} requests/s), p50 "
              f"{predict['p50_ms']:.1f} ms, p99 {predict['p99_ms']:.1f} ms")

        # the same /generate burst under the profiler: K2 and K4 launched by
        # the graphs' replays, counted by name
        replays.clear()
        trace = traced_launches(lambda: _burst(gen_calls), margin_s=0.25, reset=replays.clear)
        depth = int(HTTP_LM_ARGS["depth"])
        prefills = {w: n for w, n in replays.items() if w != "step"}
        # a prefill of at most 64 rows (its bucket's width) takes K4
        small = sum(n for w, n in prefills.items() if w <= 64)
        want = {"flash_attention": depth * sum(prefills.values()),
                "int8_matmul": 6 * depth * (replays.get("step", 0) + small)}
        print(f"http /generate traced: launches {trace['launches']} (want {want} from "
              f"{replays.get('step', 0)} step and {prefills} prefill replays), device busy "
              f"{trace['device_busy_ms']:.1f} ms of {trace['wall_ms']:.1f} "
              f"({trace['device_busy_share']:.1%})")
        check(sum(prefills.values()) == SERVE_REQUESTS, f"http: prefill replays {prefills}")
        check(trace["launches"] == want, f"http: graphed launches {trace['launches']}, want {want}")
        fallback = reg.snapshot().get("serve_aot_fallback", 0)
        check(fallback == 0, f"http: serve_aot_fallback {fallback}")
        health = {name: _http(url + "/healthz")[1] for name, url in
                  (("lm", lm_url), ("mnist", mnist_url))}
        metrics_text = _http(mnist_url + "/metrics")[1]
        check("serve_batches_total" in metrics_text and "serve_decode_steps_total" in metrics_text,
              "http: /metrics lacks the serving series")
    finally:
        for a in apps:
            a.shutdown()
        for h in httpds:
            h.shutdown()
            h.server_close()
        for t in threads:
            t.join(timeout=30)
    captured = _counts()
    check(captured["flash_attention"] > 0 and captured["int8_matmul"] > 0,
          f"http: the wrappers launched {captured} while the graphs were captured")
    # the same graphed f32 step driven from this thread, every slot busy,
    # with the server's threads stopped: the server's per-step wall less
    # this is what serving over HTTP adds
    loop = lm_app.loop
    with torch.inference_mode():
        for p in prompts[:SERVE_SLOTS]:
            loop.submit(p, max_new=128)
        loop._admit()
        tok = loop._tok.copy()
        solo_ms = _wall(lambda: loop._run_step(tok), iters=50) * 1e3
    print(f"http: the f32 graphed step alone, {SERVE_SLOTS} slots busy: {solo_ms:.3f} ms")
    return {"lm_args": HTTP_LM_ARGS, "mnist_args": HTTP_MNIST_ARGS,
            "lm_build_s": lm_build_s, "mnist_build_s": mnist_build_s,
            "generate": generate, "predict": predict, "f32_graphed_step_alone_ms": solo_ms,
            "traced_generate": {k: v for k, v in trace.items() if k != "out"},
            "captured_launches": captured, "serve_aot_fallback": fallback, "health": health}


def _state_rel(got, want) -> dict:
    """K3's error against its plain version: m on the rows some key
    reached (the others must keep their m bit for bit), l and acc
    everywhere, each relative to max|plain|."""
    m, l, acc = got
    m_ref, l_ref, acc_ref = want
    live = m_ref > -1e29
    check(torch.equal(m[~live], m_ref[~live]), "K3 changed m on a row no key reached")
    return {
        "m": _rel(m[live], m_ref[live]) if bool(live.any()) else 0.0,
        "l": _rel(l, l_ref),
        "acc": _rel(acc, acc_ref),
        "max_abs_err": max(float((g - w).abs().max()) if g.numel() else 0.0
                           for g, w in ((m[live], m_ref[live]), (l, l_ref), (acc, acc_ref))),
        "rows_no_key": int((~live).sum()),
    }


def phase_k3(device) -> dict:
    """K3 against its plain version at the ring's hop shape (bf16 in, f32
    state): a diagonal hop, a past hop, a future hop (bit for bit), and a
    ragged f32 shape causal and not, with rows no key reaches. Timed at
    the diagonal and past hops."""
    import torch.nn.functional as F

    from keystone_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(8)
    b, h, s, d = HOP

    def inputs(s_q, s_k, dd, dtype, fresh):
        q, k, v = (torch.randn((b, h, n, dd), generator=gen, device=device).to(dtype)
                   for n in (s_q, s_k, s_k))
        if fresh:
            st = (torch.full((b, h, s_q), -1e30, device=device),
                  torch.zeros((b, h, s_q), device=device),
                  torch.zeros((b, h, s_q, dd), device=device))
        else:  # a state some earlier hop left
            st = (torch.randn((b, h, s_q), generator=gen, device=device),
                  torch.rand((b, h, s_q), generator=gen, device=device) + 0.5,
                  torch.randn((b, h, s_q, dd), generator=gen, device=device))
        return (q, k, v), st

    hops = {}
    for name, (q_off, k_off, fresh) in (("diagonal", (s, s, True)), ("past", (2 * s, 0, False)),
                                        ("future", (0, s, False))):
        qkv, st = inputs(s, s, d, torch.bfloat16, fresh)
        kw = dict(q_offset=q_off, k_offset=k_off, causal=True)
        got = fa.flash_attention_step(*qkv, *st, **kw)
        torch.cuda.synchronize()
        ref = fa.flash_attention_step_plain(*qkv, *st, **kw)
        check(all(bool(torch.isfinite(x).all()) for x in got[1:]), f"K3 {name} hop not finite")
        row = {"offsets": [q_off, k_off], **_state_rel(got, ref)}
        if name == "future":
            same = all(torch.equal(g, x) for g, x in zip(got, st))
            check(same, "K3 future hop changed its state")
            row["state_unchanged_bit_for_bit"] = same
        else:
            check(max(row["m"], row["l"], row["acc"]) <= K3_TOL,
                  f"K3 {name} hop disagrees with its plain version {row}")
        # the operations these inputs need: valid (q, k) pairs × 4·D in f32,
        # or × 2·D per bf16 tensor-core pass (1 for Q·Kᵀ, 3 for the split
        # P·V), and one exponential per valid pair
        pairs = {"diagonal": s * (s + 1) / 2, "past": float(s) * s, "future": 0.0}[name]
        ops = 4.0 * b * h * d * pairs
        tc_ops = 2.0 * b * h * d * pairs * K3_PASSES
        state_bytes = 2 * 4.0 * b * h * s * (d + 2)  # m, l, acc read and written
        qkv_bytes = 2.0 * b * h * 3 * s * d if pairs else 0.0  # a masked hop needs none
        bytes_ms = 1e3 * (state_bytes + qkv_bytes) / HBM_BYTES_PER_S
        f32_ms, tc_ms = 1e3 * ops / F32_PEAK_OPS, 1e3 * tc_ops / BF16_PEAK_OPS
        row.update(bound_ms=max(tc_ms, bytes_ms),
                   bound_by="operations" if tc_ms >= bytes_ms else "bytes",
                   bound_ms_tensor_core=max(tc_ms, bytes_ms),
                   bound_ms_f32_cuda_core=max(f32_ms, bytes_ms),
                   exponentials=b * h * pairs)
        row["ms"] = device_ms(lambda: fa.flash_attention_step(*qkv, *st, **kw))
        row["eager_call_ms"] = time_ms(lambda: fa.flash_attention_step(*qkv, *st, **kw), reps=20)
        row["plain_ms"] = device_ms(lambda: fa.flash_attention_step_plain(*qkv, *st, **kw), reps=2)
        if name == "past":
            # a labelled yardstick, not the same function: SDPA over the
            # same (q, k) rectangle, bf16, without the carried state
            row["sdpa_rectangle_ms"] = device_ms(lambda: F.scaled_dot_product_attention(*qkv))
        if row["ms"]:
            row["needed_tflops"] = ops / row["ms"] / 1e9
        print(f"K3 {name} hop {HOP} bf16 offsets ({q_off},{k_off}): relative m {row['m']:.3e} "
              f"l {row['l']:.3e} acc {row['acc']:.3e}; device: kernel {row['ms']} ms, plain "
              f"{row['plain_ms']} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"tensor cores, {K3_PASSES} bf16 passes), f32 CUDA-core bound "
              f"{row['bound_ms_f32_cuda_core']:.4f} ms, {row['exponentials']:.3g} exponentials; "
              f"eager kernel call {row['eager_call_ms']:.4f} ms"
              + (f"; SDPA over the rectangle {row['sdpa_rectangle_ms']} ms" if name == "past" else ""))
        hops[name] = row

    ragged = {}
    for causal, q_off, k_off in ((True, 100, 300), (False, 0, 300)):
        qkv, st = inputs(777, 500, 40, torch.float32, causal)
        kw = dict(q_offset=q_off, k_offset=k_off, causal=causal)
        got = fa.flash_attention_step(*qkv, *st, **kw)
        torch.cuda.synchronize()
        row = _state_rel(got, fa.flash_attention_step_plain(*qkv, *st, **kw))
        print(f"K3 (2,16,777,40) vs S_k 500 f32 causal={causal} offsets ({q_off},{k_off}): "
              f"relative m {row['m']:.3e} l {row['l']:.3e} acc {row['acc']:.3e}, "
              f"rows no key reached {row['rows_no_key']}")
        check(max(row["m"], row["l"], row["acc"]) <= K3_TOL, f"K3 ragged disagrees {row}")
        check(not causal or row["rows_no_key"] > 0, "K3 ragged causal case has no masked row")
        ragged[f"causal={causal}"] = row
    main = hops["past"]
    return {
        "name": "flash_attention_step",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/flash_attention_step.cu",
        "replaces": "keystone_tpu/ops/flash_attention.py:544",
        "shape": list(HOP),
        "launches": None,  # filled from the main path's run
        "max_abs_err": main["max_abs_err"],
        "max_rel_err": max(main["m"], main["l"], main["acc"]),
        "ms": main["ms"],
        "eager_call_ms": main["eager_call_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "bound_ms_tensor_core": main["bound_ms_tensor_core"],
        "bound_ms_f32_cuda_core": main["bound_ms_f32_cuda_core"],
        "exponentials": main["exponentials"],
        "library_ms": None,
        "library": "none: no one PyTorch call updates a carried softmax state",
        "timing": "device time, CUDA-graph replay, of the past (fully live) hop; "
                  "eager_call_ms is a Python call",
        "hops": hops,
        "ragged_f32": ragged,
    }


def phase_ring(device) -> dict:
    """Ring and Ulysses attention on one card named four times, at the
    scoring path's attention shape."""
    from keystone_tpu_torch.ops import attention
    from keystone_tpu_torch.ops import flash_attention as fa
    from keystone_tpu_torch.parallel import create_mesh

    mesh = create_mesh(data=SCORE_RING, devices=[device] * SCORE_RING)
    b, h, _, d = HOP
    gen = torch.Generator(device=device).manual_seed(9)
    q, k, v = (torch.randn((b, h, SCORE_SEQ, d), generator=gen, device=device) for _ in range(3))
    _zero_counts()
    ring = attention.ring_attention(q, k, v, mesh, causal=True)
    torch.cuda.synchronize()
    counts = _counts()
    check(counts["flash_attention_step"] == RING_STEPS and counts["flash_attention"] == 0,
          f"ring launches {counts}")
    full = fa.flash_attention(q, k, v, causal=True)
    plain = attention.ring_attention(q, k, v, mesh, causal=True, use_flash=False)
    torch.cuda.synchronize()
    err_k2, err_plain = _rel(ring, full), _rel(ring, plain)
    print(f"ring {tuple(q.shape)} f32 causal over {SCORE_RING} positions: K3 launches "
          f"{counts['flash_attention_step']}; relative to full K2 {err_k2:.3e}, "
          f"to the plain ring {err_plain:.3e}")
    check(bool(torch.isfinite(ring).all()), "ring output not finite")
    check(err_k2 <= RING_TOL and err_plain <= RING_TOL, "ring disagrees")
    del plain

    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    _zero_counts()
    uly = attention.ulysses_attention(qb, kb, vb, mesh, causal=True)
    torch.cuda.synchronize()
    u_counts = _counts()
    full_b = fa.flash_attention(qb, kb, vb, causal=True)
    err_uly = _rel(uly, full_b)
    print(f"Ulysses bf16: K2 launches {u_counts['flash_attention']}, relative to full K2 "
          f"{err_uly:.3e}")
    check(u_counts["flash_attention"] == SCORE_RING and u_counts["flash_attention_step"] == 0,
          f"Ulysses launches {u_counts}")
    check(err_uly <= K2_BF16_TOL, f"Ulysses disagrees ({err_uly:.3e})")

    # K2 against its plain version at the scoring path's own shapes: the
    # local mode's call over all heads, and one Ulysses position's call over
    # its H/n heads of the full sequence (position 1's, as seq_to_heads
    # gathers them); the Ulysses result against the plain version too
    plain_b = fa.flash_attention_plain(qb, kb, vb, causal=True)
    hs = slice(h // SCORE_RING, 2 * h // SCORE_RING)
    qp, kp, vp = (x[:, hs].contiguous() for x in (qb, kb, vb))
    pos_out = fa.flash_attention(qp, kp, vp, causal=True)
    pos_plain = fa.flash_attention_plain(qp, kp, vp, causal=True)
    torch.cuda.synchronize()
    k2_plain = {
        "local": {"shape": list(qb.shape), "max_rel_err": _rel(full_b, plain_b),
                  "max_abs_err": float((full_b.float() - plain_b.float()).abs().max())},
        "ulysses_position": {"shape": list(qp.shape), "max_rel_err": _rel(pos_out, pos_plain),
                             "max_abs_err": float((pos_out.float() - pos_plain.float())
                                                  .abs().max())},
        "ulysses_output": {"shape": list(uly.shape), "max_rel_err": _rel(uly, plain_b)},
    }
    for name, r in k2_plain.items():
        print(f"K2 bf16 causal at the scoring shape, {name} {tuple(r['shape'])}: "
              f"max|kernel-plain| / max|plain| = {r['max_rel_err']:.3e}")
        check(r["max_rel_err"] <= K2_BF16_TOL,
              f"K2 {name} disagrees with its plain version ({r['max_rel_err']:.3e})")
    del plain_b, pos_plain
    times = {
        "ring_bf16_ms": time_ms(lambda: attention.ring_attention(qb, kb, vb, mesh, causal=True),
                                reps=2),
        "ulysses_bf16_ms": time_ms(lambda: attention.ulysses_attention(qb, kb, vb, mesh,
                                                                       causal=True), reps=2),
        "k2_full_bf16_ms": time_ms(lambda: fa.flash_attention(qb, kb, vb, causal=True), reps=2),
    }
    print("attention at (2,16,8192,64) bf16 causal, eager: "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return {"shape": list(q.shape), "positions": SCORE_RING, "ring_launches": counts,
            "ring_vs_k2_f32": err_k2, "ring_vs_plain_ring_f32": err_plain,
            "ulysses_launches": u_counts, "ulysses_vs_k2_bf16": err_uly,
            "k2_vs_plain_bf16": k2_plain, **times}


def phase_scoring(device) -> dict:
    """Held-out scoring at full width in the three attention modes, on
    the same weights."""
    import numpy as np

    from keystone_tpu_torch.evaluation import evaluate_perplexity
    from keystone_tpu_torch.models.lm import TransformerLM, synthetic_corpus
    from keystone_tpu_torch.parallel import create_mesh

    gen = torch.Generator(device=device).manual_seed(0)
    model = TransformerLM.create(**SCORE_CONF, compute_dtype="bfloat16", device=device,
                                 generator=gen)
    mesh = create_mesh(data=SCORE_RING, devices=[device] * SCORE_RING)
    window = SCORE_SEQ + 1
    held = synthetic_corpus(SCORE_WINDOWS * window, SCORE_CONF["vocab"], seed=7)
    forwards = -(-SCORE_WINDOWS // SCORE_BATCH)
    depth = SCORE_CONF["depth"]
    want = {"ring": {"flash_attention_step": forwards * depth * RING_STEPS},
            "ulysses": {"flash_attention": forwards * depth * SCORE_RING},
            "local": {"flash_attention": forwards * depth}}
    kw = dict(seq=SCORE_SEQ, batch=SCORE_BATCH, logit_chunk=SCORE_CHUNK)
    batch0 = torch.from_numpy(held[: SCORE_BATCH * window].reshape(SCORE_BATCH, window)).to(device)
    res = {}
    for mode in ("ring", "ulysses", "local"):
        m = model.replace(seq_mode=mode, mesh=None if mode == "local" else mesh)
        evaluate_perplexity(m, held[: SCORE_BATCH * window], **kw)  # warm
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        ev = evaluate_perplexity(m, held, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        expect = {k: want[mode].get(k, 0) for k in counts}
        check(counts == expect, f"scoring [{mode}]: launches {counts}, want {expect}")
        check(math.isfinite(ev["loss"]), f"scoring [{mode}]: loss {ev['loss']}")
        check(ev["tokens_scored"] == SCORE_WINDOWS * SCORE_SEQ, f"scoring [{mode}]: {ev}")

        def forward(m=m):
            with torch.inference_mode():
                m.backbone(batch0[:, :-1])

        prof = device_profile(forward, 1)
        res[mode] = {**ev, "wall_s": wall, "ms_per_forward": wall * 1e3 / forwards,
                     "tokens_per_s": ev["tokens_scored"] / wall, "launches": counts,
                     "backbone_profile": prof}
        print(f"scoring [{mode}]: loss {ev['loss']:.6f}, {ev['tokens_scored']} tokens in "
              f"{wall:.3f} s ({ev['tokens_scored'] / wall:.0f} tokens/s, "
              f"{wall * 1e3 / forwards:.1f} ms per forward), launches {counts}")
        if prof is not None:
            print(f"scoring [{mode}] backbone profile: wall {prof['wall_ms_per_step']:.2f} ms, "
                  f"device busy {prof['device_busy_ms_per_step']:.2f} ms "
                  f"({prof['device_busy_share']:.1%}), {prof['device_kernels_per_step']:.0f} "
                  f"kernels; top: " + "; ".join(f"{t['name'][:40]} {t['ms_per_step']:.2f} ms"
                                                for t in prof["top"][:4]))
    ref = res["local"]["loss"]
    with torch.inference_mode():
        toks = batch0[:1, :-1]
        local = model.replace(seq_mode="local", mesh=None)(toks)
        for mode, tol in (("ring", SCORE_LOGIT_TOL), ("ulysses", K2_BF16_TOL)):
            rel = abs(res[mode]["loss"] - ref) / ref
            logits = model.replace(seq_mode=mode, mesh=mesh)(toks)
            err = _rel(logits, local)
            agree = float((logits.argmax(-1) == local.argmax(-1)).float().mean())
            del logits
            res[mode].update(loss_rel_to_local=rel, logits_rel_to_local=err,
                             argmax_agreement_with_local=agree)
            print(f"scoring [{mode}] bf16 against local: loss {rel:.3e} relative, one "
                  f"window's logits {err:.3e} of max|logit|, argmax agreement {agree:.4%}")
            check(rel <= SCORE_MODE_TOL,
                  f"scoring [{mode}]: loss {res[mode]['loss']} vs local {ref}")
            check(err <= tol, f"scoring [{mode}]: bf16 logits differ from local by {err:.3e}")
        del local
    return {"config": {**SCORE_CONF, "seq": SCORE_SEQ, "ring_positions": SCORE_RING,
                       "batch": SCORE_BATCH, "windows": SCORE_WINDOWS,
                       "logit_chunk": SCORE_CHUNK, "compute_dtype": "bfloat16",
                       "params": model.num_params()},
            "modes": res, "model": model, "mesh": mesh, "held": held}


def phase_scoring_equivalence(device, model, mesh, held) -> dict:
    """The same weights in f32, one window: the ring (K3 every hop)
    against local attention (K2)."""
    toks = torch.from_numpy(held[: SCORE_SEQ].reshape(1, SCORE_SEQ)).to(device)
    f32 = model.replace(compute_dtype="float32")
    _zero_counts()
    with torch.inference_mode():
        ring = f32.replace(seq_mode="ring", mesh=mesh)(toks)
        torch.cuda.synchronize()
        counts = _counts()
        local = f32(toks)
    want = SCORE_CONF["depth"] * RING_STEPS
    check(counts["flash_attention_step"] == want and counts["flash_attention"] == 0,
          f"f32 ring launches {counts}")
    err = _rel(ring, local)
    agree = float((ring.argmax(-1) == local.argmax(-1)).float().mean())
    print(f"scoring f32 equivalence, {SCORE_SEQ} tokens: max|ring-local| / max|logit| = "
          f"{err:.3e}, argmax agreement {agree:.4%}")
    check(bool(torch.isfinite(ring).all()), "f32 ring logits not finite")
    check(err <= EQUIV_TOL, f"f32 ring and local logits differ by {err:.3e} of max")
    check(agree >= EQUIV_ARGMAX, f"f32 ring/local argmax agreement {agree:.4%}")
    return {"max_rel_err": err, "argmax_agreement": agree, "k3_launches": counts}


def _train_model(device, conf, seq, compute_dtype="bfloat16", **kw):
    """The model ``lm_transformer.run`` builds for ``conf`` at ``seq``,
    seed 0: the same weights on every call."""
    from keystone_tpu_torch.models.lm import TransformerLM

    return TransformerLM.create(**conf, max_seq=seq, compute_dtype=compute_dtype, device=device,
                                generator=torch.Generator(device=device).manual_seed(0), **kw)


def _kernel_class(name: str) -> str:
    """The train-step profile's bucket of a device kernel, by its name."""
    low = name.lower()
    if "K2State" in name:
        return "k2"
    if "K3State" in name:
        return "k3"
    if "multi_tensor_apply" in low:
        return "optimizer"
    if any(t in low for t in ("gemm", "xmma", "nvjet", "cutlass", "cublas")):
        return "gemm_f32" if any(t in low for t in ("sgemm", "f32f32_f32f32", "simt")) else "gemm_bf16"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise_and_reductions"


def train_step_profile(step) -> dict | None:
    """One call of an already warm ``step`` under torch.profiler: the
    device's busy share, device ms by bucket (:func:`_kernel_class`), and
    the kernels that take the most time. None when the profiler shows no
    device time here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        on_device = getattr(e, "device_type", None) == DeviceType.CUDA
        if us > 0 and (on_device or e.self_cpu_time_total == 0):
            rows.append((us, e.count, e.key))
    if not rows:
        print("profile: the profiler shows no device time here")
        return None
    rows.sort(reverse=True)
    buckets: dict = {}
    for us, _, key in rows:
        c = _kernel_class(key)
        buckets[c] = buckets.get(c, 0.0) + us / 1e3
    busy = sum(buckets.values())
    return {
        "wall_ms": wall * 1e3, "device_busy_ms": busy, "device_busy_share": busy / 1e3 / wall,
        "device_kernels": sum(r[1] for r in rows),
        "ms_by_bucket": dict(sorted(buckets.items(), key=lambda kv: -kv[1])),
        "top": [{"name": k[:90], "calls": c, "ms": us / 1e3} for us, c, k in rows[:12]],
    }


def step_parts(device, model, toks) -> dict:
    """Two parts of a flagship train step timed alone (CUDA events, device
    ms): one layer's blockwise attention backward (``_blockwise_grads``,
    torch ops, from K2's output and lse) at the step's attention shape,
    with its own profile buckets; and the f32 tied logits with the CE,
    forward and backward."""
    from keystone_tpu_torch.models.lm.losses import token_cross_entropy
    from keystone_tpu_torch.models.lm.model import _tied_logits
    from keystone_tpu_torch.ops import flash_attention as fa

    b, s = toks.shape[0], toks.shape[1] - 1
    h, d = model.num_heads, model.embed.shape[-1]
    gen = torch.Generator(device=device).manual_seed(31)
    q, k, v, g = (torch.randn((b, h, s, d // h), generator=gen, device=device)
                  .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)

    def attn_bwd():
        fa._blockwise_grads(q, k, v, g, out, lse, True, fa._bwd_block())

    x = torch.randn((b, s, d), generator=gen, device=device).to(model.cdt).requires_grad_(True)
    embed = model.embed.detach().clone().requires_grad_(True)

    def logits_ce():
        loss = token_cross_entropy(_tied_logits(x, embed, model.cdt), toks[:, 1:])
        torch.autograd.grad(loss, (x, embed))

    attn_ms = time_ms(attn_bwd, reps=3, rounds=1)
    prof = train_step_profile(attn_bwd)
    return {"attention_backward_ms_per_layer": attn_ms,
            "attention_backward_ms_by_bucket": prof and prof["ms_by_bucket"],
            "tied_logits_ce_ms": time_ms(logits_ce, reps=2, rounds=1)}


def _timed_steps(model, batches, logit_chunk: int = 0, lr: float = TRAIN_LR):
    """Fresh AdamW on ``model``, one step per batch: ([loss], [ms], the
    launch counts of each step, peak bytes allocated, the step function
    and state). Each step is timed on the host clock to a synchronize."""
    from keystone_tpu_torch.models.lm.train import make_optimizer, make_train_step

    opt = make_optimizer(lr)
    state = opt.init(model.leaves())
    step = make_train_step(opt, logit_chunk=logit_chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, counts = [], [], []
    for toks in batches:
        _zero_counts()
        t0 = time.perf_counter()
        _, state, loss = step(model, state, toks)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(_counts())
        losses.append(float(loss))
    return losses, ms, counts, torch.cuda.max_memory_allocated(), step, state


def phase_train(device) -> dict:
    """Phases 15–16: the flagship train step through ``lm_transformer.main``
    (the loss gate, K2's launches), its steady ms per step, rate, peak
    memory and profile, and the remat legs from the same weights."""
    import numpy as np

    from keystone_tpu_torch.models import lm_transformer
    from keystone_tpu_torch.models.lm import train_step_flops
    from keystone_tpu_torch.models.lm.train import _step_batch, synthetic_corpus

    depth = TRAIN_CONF["depth"]
    recorded = {}
    real_train = lm_transformer.train

    def recording_train(*args, **kw):  # observes the losses main() averages
        model, losses = real_train(*args, **kw)
        recorded["losses"] = losses
        return model, losses

    lm_transformer.train = recording_train
    _zero_counts()
    try:
        res = lm_transformer.main(list(TRAIN_ARGV))
        torch.cuda.synchronize()
    finally:
        lm_transformer.train = real_train
    counts = _counts()
    losses = recorded["losses"]
    last5 = float(np.mean(losses[-5:]))
    drop = 1 - last5 / losses[0]
    print(f"train [flagship] main(): {res['params']:,} parameters, {TRAIN_STEPS} steps, loss "
          f"{losses[0]:.4f} -> {last5:.4f} (mean of last 5, {drop:.1%} lower), "
          f"{res['tokens_per_s']:.0f} tokens/s over the run; launches {counts}")
    check(all(math.isfinite(x) for x in losses), f"train: a loss is not finite {losses}")
    check(drop >= TRAIN_LOSS_DROP, f"train: loss fell {drop:.1%}, want >= {TRAIN_LOSS_DROP:.0%}")
    check(counts["flash_attention"] == depth * TRAIN_STEPS and counts["flash_attention_step"] == 0,
          f"train: launches {counts}, want K2 {depth * TRAIN_STEPS} and no K3")
    del recorded

    corpus = synthetic_corpus(200_000, TRAIN_CONF["vocab"], seed=0)
    batches = [torch.from_numpy(_step_batch(corpus, 0, i, TRAIN_BATCH, TRAIN_SEQ)).to(device)
               for i in range(2 + TRAIN_TIMED_STEPS)]
    model = _train_model(device, TRAIN_CONF, TRAIN_SEQ)
    t_losses, t_ms, t_counts, peak, step, state = _timed_steps(model, batches)
    check(abs(t_losses[0] - losses[0]) <= 1e-5 * losses[0],
          f"train: the timed run's first loss {t_losses[0]} is not main()'s {losses[0]}")
    check(all(c["flash_attention"] == depth for c in t_counts), f"train: launches {t_counts}")
    step_ms = statistics.mean(t_ms[2:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_step_flops(model, TRAIN_BATCH, TRAIN_SEQ)
    prof = train_step_profile(lambda: step(model, state, batches[0]))
    parts = step_parts(device, model, batches[0])
    attn_bwd = parts["attention_backward_ms_per_layer"]
    flagship = {
        "params": res["params"], "steps": TRAIN_STEPS, "loss_first": losses[0],
        "loss_last5": last5, "loss_drop": drop, "losses": losses, "main_result": res,
        "launches": counts, "ms_per_step": step_ms, "step_ms": t_ms,
        "tokens_per_s": tokens / (step_ms / 1e3), "step_flops": flops,
        "tflops_per_s": flops / (step_ms / 1e3) / 1e12,
        "bf16_peak_share": flops / (step_ms / 1e3) / BF16_PEAK_OPS,
        "peak_bytes": peak, "profile": prof,
        **parts,
        "attention_backward_share": attn_bwd * depth / step_ms,
        "tied_logits_ce_share": parts["tied_logits_ce_ms"] / step_ms,
    }
    print(f"train [flagship] steady: {step_ms:.2f} ms a step ({t_ms}), "
          f"{flagship['tokens_per_s']:.0f} tokens/s, {flagship['tflops_per_s']:.1f} TFLOP/s "
          f"({flagship['bf16_peak_share']:.1%} of the bf16 peak), peak {peak / 2**30:.2f} GiB; "
          f"attention backward {attn_bwd:.2f} ms a layer, {flagship['attention_backward_share']:.1%}"
          f" of a step (by bucket {parts['attention_backward_ms_by_bucket']}); f32 tied logits "
          f"and CE {parts['tied_logits_ce_ms']:.2f} ms, {flagship['tied_logits_ce_share']:.1%}")
    if prof is not None:
        print("train [flagship] one step's profile: wall {:.1f} ms, device busy {:.1f} ms ({:.1%}), "
              "{} kernels; by bucket {}; top {}".format(
                  prof["wall_ms"], prof["device_busy_ms"], prof["device_busy_share"],
                  prof["device_kernels"], {k: round(v, 2) for k, v in prof["ms_by_bucket"].items()},
                  [(t["name"][:50], round(t["ms"], 2)) for t in prof["top"][:8]]))
    del model, state, step

    legs = {"none": {"first_loss": t_losses[0], "peak_bytes": peak, "ms_per_step": step_ms,
                     "k2_launches_per_step": t_counts[-1]["flash_attention"]}}
    for policy in ("full", "dots"):
        m = _train_model(device, TRAIN_CONF, TRAIN_SEQ).replace(remat=True, remat_policy=policy)
        r_losses, r_ms, r_counts, r_peak, *_ = _timed_steps(m, batches[:2])
        del m
        rel = abs(r_losses[0] - losses[0]) / losses[0]
        legs[policy] = {"first_loss": r_losses[0], "first_loss_rel_to_none": rel,
                        "losses": r_losses, "peak_bytes": r_peak, "ms_per_step": r_ms[1],
                        "k2_launches_per_step": [c["flash_attention"] for c in r_counts]}
        print(f"train [remat {policy}]: first loss {r_losses[0]:.5f} ({rel:.2e} relative to no "
              f"remat), step 2 {r_ms[1]:.2f} ms, peak {r_peak / 2**30:.2f} GiB, K2 "
              f"{legs[policy]['k2_launches_per_step']} a step")
        check(all(math.isfinite(x) for x in r_losses), f"remat {policy}: loss {r_losses}")
        check(rel <= REMAT_LOSS_TOL, f"remat {policy}: first loss {r_losses[0]} vs {losses[0]}")
        check(all(c["flash_attention"] == 2 * depth for c in r_counts),
              f"remat {policy}: K2 launches {r_counts}, want {2 * depth} a step")
    torch.cuda.empty_cache()
    return {"flagship": flagship, "remat": legs, "corpus": corpus}


def phase_long_context(device, corpus) -> dict:
    """Phase 17: the long-context train step, blockwise backward and
    checkpointed chunked CE."""
    from keystone_tpu_torch.models.lm.train import _step_batch

    model = _train_model(device, LONG_CONF, LONG_SEQ)
    batches = [torch.from_numpy(_step_batch(corpus, 0, i, 1, LONG_SEQ)).to(device)
               for i in range(LONG_STEPS)]
    losses, ms, counts, peak, *_ = _timed_steps(model, batches, logit_chunk=LONG_CHUNK)
    del model
    torch.cuda.empty_cache()
    step_ms = statistics.mean(ms[1:])
    print(f"train [long context]: losses {losses}, {ms} ms ({step_ms:.2f} ms a steady step, "
          f"{LONG_SEQ / (step_ms / 1e3):.0f} tokens/s), peak {peak / 2**30:.2f} GiB, "
          f"launches {counts[-1]}")
    check(all(math.isfinite(x) for x in losses), f"long context: losses {losses}")
    check(all(c["flash_attention"] == LONG_CONF["depth"] and c["flash_attention_step"] == 0
              for c in counts), f"long context: launches {counts}")
    return {"losses": losses, "step_ms": ms, "ms_per_step": step_ms,
            "tokens_per_s": LONG_SEQ / (step_ms / 1e3), "peak_bytes": peak,
            "launches_per_step": counts[-1]}


def _leaf_grads(model, toks, logit_chunk: int = 0) -> list:
    from keystone_tpu_torch.models.lm import next_token_loss

    params = model.leaves()
    for p in params:
        p.requires_grad_(True)
    return list(torch.autograd.grad(next_token_loss(model, toks, logit_chunk=logit_chunk),
                                    params, allow_unused=True))


def _grad_err(got, want) -> float:
    """The largest per-leaf max|got − want| / max|want| over non-empty leaves."""
    return max(_rel(g, w) for g, w in zip(got, want) if w is not None and w.numel())


def phase_train_sequence_parallel(device, corpus) -> dict:
    """Phase 18: ring and Ulysses train steps at the scoring width on one
    card named four times, and their f32 gradients against local's."""
    from keystone_tpu_torch.models.lm.train import _step_batch
    from keystone_tpu_torch.parallel import create_mesh

    mesh = create_mesh(data=SCORE_RING, devices=[device] * SCORE_RING)
    depth = SCORE_CONF["depth"]
    conf = {k: SCORE_CONF[k] for k in ("vocab", "dim", "depth", "num_heads", "pos_encoding")}
    batches = [torch.from_numpy(_step_batch(corpus, 0, i, SCORE_BATCH, SCORE_SEQ)).to(device)
               for i in range(SP_STEPS)]
    want = {"ring": {"flash_attention_step": depth * RING_STEPS, "flash_attention": 0},
            "ulysses": {"flash_attention_step": 0, "flash_attention": depth * SCORE_RING}}
    res = {}
    for mode in ("ring", "ulysses"):
        m = _train_model(device, conf, SCORE_SEQ, seq_mode=mode, mesh=mesh)
        losses, ms, counts, peak, *_ = _timed_steps(m, batches, logit_chunk=SCORE_CHUNK)
        del m
        torch.cuda.empty_cache()
        res[mode] = {"losses": losses, "step_ms": ms, "peak_bytes": peak,
                     "launches_per_step": counts,
                     "tokens_per_s": SCORE_BATCH * SCORE_SEQ / (ms[-1] / 1e3)}
        print(f"train [{mode}] {SCORE_BATCH}x{SCORE_SEQ}: losses {losses}, {ms} ms a step, peak "
              f"{peak / 2**30:.2f} GiB, launches {counts}")
        check(all(math.isfinite(x) for x in losses), f"train [{mode}]: losses {losses}")
        check(all({k: c[k] for k in want[mode]} == want[mode] for c in counts),
              f"train [{mode}]: launches {counts}, want {want[mode]} a step")

    f32 = _train_model(device, dict(conf, depth=GRAD_DEPTH), SCORE_SEQ, compute_dtype="float32")
    toks = batches[0][:1]
    local = _leaf_grads(f32, toks, SCORE_CHUNK)
    errs = {}
    for mode in ("ring", "ulysses"):
        _zero_counts()
        got = _leaf_grads(f32.replace(seq_mode=mode, mesh=mesh), toks, SCORE_CHUNK)
        torch.cuda.synchronize()
        counts = _counts()
        errs[mode] = {"max_rel_grad_err": _grad_err(got, local), "launches": counts}
        del got
        print(f"train [{mode}] f32 depth {GRAD_DEPTH}, 1x{SCORE_SEQ}: every leaf's gradient within "
              f"{errs[mode]['max_rel_grad_err']:.3e} of max|grad| of local; launches {counts}")
        check(errs[mode]["max_rel_grad_err"] <= GRAD_TOL, f"train [{mode}] f32 gradients {errs}")
    check(errs["ring"]["launches"]["flash_attention_step"] == GRAD_DEPTH * RING_STEPS
          and errs["ulysses"]["launches"]["flash_attention"] == GRAD_DEPTH * SCORE_RING,
          f"f32 gradients: launches {errs}")
    del f32, local
    torch.cuda.empty_cache()
    return {"modes": res, "f32_grads_vs_local": errs}


def phase_train_equivalence(device) -> dict:
    """Phase 19: f32, the flagship width at depth 2, seq 2,048, batch 2:
    every leaf's gradient through K2 and the ported backward (the dense
    route, then the blockwise one) against dense attention under
    autograd."""
    import numpy as np

    model = _train_model(device, dict(TRAIN_CONF, depth=GRAD_DEPTH), TRAIN_SEQ,
                         compute_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, TRAIN_CONF["vocab"], size=(2, TRAIN_SEQ + 1))).to(device)
    os.environ["KST_LOCAL_ATTN"] = "dense"
    try:
        plain = _leaf_grads(model, toks)
    finally:
        del os.environ["KST_LOCAL_ATTN"]
    res = {}
    for route, env in (("dense_route", None), ("blockwise_route", "0")):
        if env is not None:
            os.environ["KST_FLASH_DENSE_BWD_MAX"] = env
        try:
            _zero_counts()
            with tiled_f32_tally() as tally:
                got = _leaf_grads(model, toks)
                torch.cuda.synchronize()
            counts = _counts()
            step_ms = 1e3 * _wall(lambda: _leaf_grads(model, toks), 1)  # warm
        finally:
            os.environ.pop("KST_FLASH_DENSE_BWD_MAX", None)
        err = _grad_err(got, plain)
        del got
        res[route] = {"max_rel_grad_err": err, "launches": counts,
                      "tiled_f32_launches": tally.launches, "ms": step_ms}
        print(f"train f32 equivalence [{route}]: every leaf's gradient within {err:.3e} of "
              f"max|grad| of the plain path; launches {counts}, {tally.launches} of them the "
              f"tiled f32 kernel; {step_ms:.1f} ms a forward and backward")
        check(err <= GRAD_TOL, f"train equivalence [{route}]: {err:.3e}")
        check(counts["flash_attention"] == GRAD_DEPTH, f"train equivalence: launches {counts}")
        check(tally.launches == GRAD_DEPTH, f"train equivalence: {tally.launches} tiled f32")
    del model, plain
    torch.cuda.empty_cache()
    return res


def run_main(gram_op: str) -> dict:
    from keystone_tpu_torch.models import mnist_random_fft as m

    os.environ["KEYSTONE_PLAN"] = "1"
    os.environ["KEYSTONE_GRAM_OP"] = gram_op
    res = m.main(list(MAIN_ARGV))
    op = next(d for d in res["fit_decisions"] if d["action"] == "fit_operator")
    preds = res["test_predictions"]
    check(preds.shape == (res["n_test"],), f"test predictions shape {preds.shape}")
    check(math.isfinite(res["test_error"]), "test error not finite")
    print(f"main path [{gram_op}]: fit_operator op={op['op']} reason={op['reason']} "
          f"quantization_error={op['quantization_error']}; train error "
          f"{res['train_error']:.4%}, test error {res['test_error']:.4%}, "
          f"fit {res['fit_s']:.2f} s, {res['train_samples_per_s']:.0f} samples/s")
    return {**res, "fit_operator": op}


def fit_breakdown(device) -> dict:
    """The main path's streamed int8 fit, part by part, twice in one
    process: the first pass pays each part's first-use costs (cold), the
    second is warm. The process first touches what phases 2–3 touch before
    the main path (the CUDA context, cuBLAS, K1), so the cold pass starts
    where the main path's first fit starts."""
    from keystone_tpu_torch.core.config import parse_config
    from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator
    from keystone_tpu_torch.models import mnist_random_fft as m
    from keystone_tpu_torch.ops import gram
    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicators
    from keystone_tpu_torch.plan import fit_stream, plan_fit

    conf = parse_config(m.MnistRandomFFTConfig, MAIN_ARGV)
    train = m._load(conf, "train")
    x = torch.from_numpy(train.data)
    y = ClassLabelIndicators(num_classes=m.NUM_CLASSES)(train.labels)
    bank = m.FeaturizerBank.create(
        conf.num_ffts, conf.block_size, conf.seed, x.shape[-1], device
    )
    est = BlockLeastSquaresEstimator(block_size=conf.block_size, lam=conf.lam)
    chain = ChainedLabelEstimator(prefix=bank, est=est)
    probe = torch.cat(bank(x[:256].to(device)), dim=-1)
    gram.ata_int8(probe)
    torch.cuda.synchronize()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    parts = {"cold": {}, "warm": {}}
    for label in ("cold", "warm"):
        plan, plan_s = timed(lambda: plan_fit(
            chain, x, y, device=device, n_valid=len(train), gram="int8"))
        state, stream_s = timed(lambda: fit_stream(plan, x, y, n_valid=len(train)))
        _, solve_s = timed(lambda: est.fit_stats_finalize(state, widths=plan.fit.widths))
        parts[label].update(plan_s=plan_s, stream_s=stream_s, solve_s=solve_s)
    host = probe.cpu().numpy()
    _, gate_s = timed(lambda: gram.gram_quantization_error(host - host.mean(axis=0)))
    parts["warm"]["quantization_gate_s"] = gate_s
    return parts


def phase_breakdown() -> dict:
    """Run :func:`fit_breakdown` in a fresh process (this one is warm by
    now) and read its JSON line."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--breakdown"],
        capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0, f"breakdown process failed:\n{proc.stderr[-3000:]}")
    parts = json.loads(proc.stdout.strip().splitlines()[-1])
    for label, p in parts.items():
        print(f"int8 fit, {label}: " + ", ".join(f"{k} {v:.3f}" for k, v in p.items()))
    return parts


def timit_bank(device, argv):
    """The TIMIT path's fitted bank on the card, as ``timit_pipeline.run``
    makes it: the synthetic train rows, the featurizers drawn from the
    config's seed, the scalers fitted on every train row. Returns
    ``(conf, train, rows on the card, bank, seconds of the scalers' pass)``."""
    from keystone_tpu_torch.core.config import parse_config
    from keystone_tpu_torch.models import timit_pipeline as tm

    conf = parse_config(tm.TimitConfig, argv)
    train = tm._load(conf, "train")
    x = torch.from_numpy(train.data).to(device)
    feats = tm.make_featurizers(conf, device)
    (scalers, _), featurize_s = _host_s(lambda: tm.fit_scalers(feats, x, len(train), False))
    bank = tm.ScaledCosineBank(chains=tuple(f >> sc for f, sc in zip(feats, scalers)))
    return conf, train, x, bank, featurize_s


def gate_loop(a) -> float:
    """The per-column loop the vectorized quantization gate replaced
    (``keystone_tpu/ops/gram.py:gram_quantization_error``), kept here to
    time the two against each other."""
    import numpy as np

    a = np.abs(np.asarray(a, np.float32))
    if a.size == 0:
        return 0.0
    amax = a.max(axis=0)
    step_rms = amax / 127.0 / np.sqrt(12.0)
    worst = 0.0
    for j in range(a.shape[1]):
        col = a[:, j]
        nz = col[col > 0]
        if nz.size == 0:
            continue
        worst = max(worst, float(step_rms[j] / np.median(nz)))
    return worst


def _host_s(fn):
    """(result, seconds) of ``fn`` on the host clock, the card idle at
    both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def k1_at_chunk(q: torch.Tensor, label: str) -> dict:
    """K1 on a streamed fit's (N, D) chunk of int8 codes ``q`` against its
    plain version, bit for bit and symmetric, timed beside it,
    ``torch._int_mm`` and its bound."""
    from keystone_tpu_torch.ops import gram

    n, d = q.shape
    out = gram.int8_gram(q)
    ref = gram.int8_gram_plain(q)
    torch.cuda.synchronize()
    max_abs = float((out - ref).abs().max())
    exact = bool(torch.equal(out, ref))
    symmetric = bool(torch.equal(out, out.t()))
    del out, ref
    torch.cuda.empty_cache()
    print(f"K1 {n}x{d} ({label}): max|kernel-plain| = {max_abs:.3e}, bit for bit {exact}, "
          f"symmetric {symmetric}")
    check(exact, f"K1 is not bit for bit its plain version at the {label} chunk")
    check(symmetric, f"K1's Gram is not symmetric at the {label} chunk")
    kernel_ms = time_ms(lambda: gram.int8_gram(q))
    plain_ms = time_ms(lambda: gram.int8_gram_plain(q), reps=1, rounds=1)
    qt = q.t().contiguous()
    library_ms = time_ms(lambda: torch._int_mm(qt, qt.t()), reps=2)
    del qt
    torch.cuda.empty_cache()
    ops = float(n) * d * (d + 1)
    traffic = n * d + 4.0 * d * d
    ops_ms, bytes_ms = 1e3 * ops / INT8_PEAK_OPS, 1e3 * traffic / HBM_BYTES_PER_S
    bound_ms = max(ops_ms, bytes_ms)
    print(f"K1 times ({label}): kernel {kernel_ms:.3f} ms ({ops / kernel_ms / 1e9:.1f} TOP/s), "
          f"plain {plain_ms:.3f} ms, torch._int_mm(qt, qt.t()) {library_ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms")
    return {"shape": [n, d], "max_abs_err": max_abs, "bit_for_bit": exact,
            "symmetric": symmetric, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms, "library": "torch._int_mm(qt, qt.t())"}


def phase_timit_kernels(device) -> dict:
    """K1 at the TIMIT fit's first chunk (8,192 × 32,768) against its plain
    version, bit for bit, timed beside it, ``torch._int_mm`` and its bound;
    the quantization gate on the plan's probe against the loop it
    replaced."""
    from keystone_tpu_torch.ops import gram
    from keystone_tpu_torch.ops.gram import _quantize_cols
    from keystone_tpu_torch.plan.fused_fit import _DEFAULT_FIT_CHUNK

    _, _, x, bank, _ = timit_bank(device, TIMIT_ARGV)
    with torch.no_grad():
        chunk = torch.cat(bank(x[:_DEFAULT_FIT_CHUNK]), dim=-1)
        q = _quantize_cols(chunk - chunk.mean(dim=0))[0].contiguous()
        probe = torch.cat(bank(x[:256]), dim=-1).cpu().numpy()
    del chunk
    k1 = k1_at_chunk(q, "TIMIT")
    del q
    torch.cuda.empty_cache()

    centered = probe - probe.mean(axis=0)
    gate, gate_s = _host_s(lambda: gram.gram_quantization_error(centered))
    looped, loop_s = _host_s(lambda: gate_loop(centered))
    print(f"quantization gate on the {centered.shape[0]}x{centered.shape[1]} probe: "
          f"{gate!r} in {gate_s * 1e3:.1f} ms vectorized, {looped!r} in "
          f"{loop_s * 1e3:.1f} ms by the per-column loop")
    check(gate == looped, f"the vectorized gate reads {gate!r}, the loop {looped!r}")
    return {
        "k1": k1,
        "gate": {"probe": list(centered.shape), "value": gate, "vectorized_s": gate_s,
                 "loop_s": loop_s},
    }


def run_timit(argv, gram_op: str | None) -> dict:
    """``timit_pipeline.main`` on the card with ``KEYSTONE_PLAN=1`` (the
    streamed fit) and the Gram operator left to the planner (None) or
    asked for."""
    from keystone_tpu_torch.models import timit_pipeline as tm

    os.environ["KEYSTONE_PLAN"] = "1"
    if gram_op is None:
        os.environ.pop("KEYSTONE_GRAM_OP", None)
    else:
        os.environ["KEYSTONE_GRAM_OP"] = gram_op
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = tm.main(list(argv))
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    op = next(d for d in res["fit_decisions"] if d["action"] == "fit_operator")
    preds = res["test_predictions"]
    check(preds.shape == (res["n_test"],), f"TIMIT test predictions shape {preds.shape}")
    check(math.isfinite(res["test_error"]), "TIMIT test error not finite")
    print(f"TIMIT [{gram_op or 'auto'}]: fit_operator op={op['op']} reason={op['reason']} "
          f"quantization_error={op['quantization_error']}; train error "
          f"{res['train_error']:.4%}, test error {res['test_error']:.4%}; featurize "
          f"{res['featurize_s']:.2f} s, fit {res['fit_s']:.2f} s, "
          f"{res['train_samples_per_s']:.0f} samples/s, peak {res['peak_memory_bytes'] / 1e9:.2f} GB")
    return {**res, "fit_operator": op}


def timit_breakdown(device) -> dict:
    """The streamed int8 TIMIT fit part by part, warm (the main run came
    first): featurize (the scalers' pass over every bank), plan (the probe's
    featurize and the gate), stream, solve."""
    from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator
    from keystone_tpu_torch.models import timit_pipeline as tm
    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicators
    from keystone_tpu_torch.plan import fit_stream, plan_fit

    os.environ.pop("KEYSTONE_GRAM_OP", None)
    conf, train, x, bank, featurize_s = timit_bank(device, TIMIT_ARGV)
    y = ClassLabelIndicators(num_classes=tm.NUM_CLASSES)(train.labels).to(device)
    est = BlockLeastSquaresEstimator(block_size=conf.cosine_features, num_iter=conf.num_epochs, lam=conf.lam)
    chain = ChainedLabelEstimator(prefix=bank, est=est)
    plan, plan_s = _host_s(lambda: plan_fit(chain, x, y, device=device, n_valid=len(train)))
    check(plan.fit.gram == "int8", f"the warm TIMIT plan took {plan.fit.gram}")
    state, stream_s = _host_s(lambda: fit_stream(plan, x, y, n_valid=len(train)))
    _, solve_s = _host_s(lambda: est.fit_stats_finalize(state, widths=plan.fit.widths))
    parts = {"featurize_s": featurize_s, "plan_s": plan_s, "stream_s": stream_s,
             "solve_s": solve_s, "gram": plan.fit.gram}
    del state
    torch.cuda.empty_cache()
    print("TIMIT int8 fit, warm: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in parts.items()))
    # one whole stream (16 chunks) under the profiler: the share of K1
    # against the chunk's other device work
    prof = device_profile(lambda: fit_stream(plan, x, y, n_valid=len(train)), 1, track="gram_kernel")
    if prof is not None:
        print(f"TIMIT stream profile: device busy {prof['device_busy_ms_per_step']:.1f} ms of "
              f"{prof['wall_ms_per_step']:.1f} ms, K1 {prof['gram_kernel_ms_per_step']:.1f} ms in "
              f"{prof['gram_kernel_launches_per_step']:.0f} launches; top: "
              + "; ".join(f"{t['name'][:60]} {t['ms_per_step']:.1f} ms" for t in prof["top"]))
    torch.cuda.empty_cache()
    return {**parts, "stream_profile": prof}


def phase_timit(device) -> dict:
    """Phases 21 and 22: the TIMIT pipeline streamed (int8 by the cost
    model, then fp32) and classic with the λ sweep."""
    kernels = phase_timit_kernels(device)

    _zero_counts()
    res8 = run_timit(TIMIT_ARGV, None)
    counts = _counts()
    chunk = res8["fit_chunk_size"] or res8["n_train"]
    n_chunks = -(-res8["n_train"] // chunk)
    print(f"TIMIT launches: {counts} for {n_chunks} fit chunks")
    op = res8["fit_operator"]
    check((op["op"], op["reason"]) == ("int8", "cost_model"),
          f"the TIMIT plan did not pick int8 by its cost model: {op}")
    check(counts == {**{k: 0 for k in counts}, "int8_gram": n_chunks},
          f"TIMIT launches {counts}, expected K1 {n_chunks} times and nothing else")
    check(res8["test_error"] <= TIMIT_MAX_TEST_ERROR, f"TIMIT test error {res8['test_error']}")

    res32 = run_timit(TIMIT_ARGV, "fp32")
    check(res32["fit_operator"]["op"] == "fp32", "the fp32 TIMIT run did not pick fp32")
    check(_counts()["int8_gram"] == n_chunks, "K1 ran in the fp32 TIMIT fit")
    agree = float((res8["test_predictions"] == res32["test_predictions"]).mean())
    print(f"TIMIT int8 vs fp32 test predictions agree on {agree:.4%}")
    check(agree >= MIN_AGREEMENT, f"TIMIT int8/fp32 agreement {agree:.4%}")
    breakdown = timit_breakdown(device)

    os.environ.pop("KEYSTONE_PLAN", None)
    os.environ.pop("KEYSTONE_GRAM_OP", None)
    from keystone_tpu_torch.models import timit_pipeline as tm

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sweep_launches = _counts()
    sweep = tm.main(list(TIMIT_SWEEP_ARGV))
    sweep["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    check(_counts() == sweep_launches, "a kernel ran in the classic TIMIT fit")
    report = sweep["lam_sweep"]
    print(f"TIMIT λ sweep: best λ {report['best_lam']}, validation errors "
          f"{dict(zip(report['lams'], report['val_errors']))}; refit train error "
          f"{sweep['train_error']:.4%}, test error {sweep['test_error']:.4%}, fit "
          f"{sweep['fit_s']:.2f} s, peak {sweep['peak_memory_bytes'] / 1e9:.2f} GB")
    check(sweep["test_error"] <= TIMIT_MAX_TEST_ERROR, f"TIMIT sweep test error {sweep['test_error']}")

    keep = ("train_error", "test_error", "featurize_s", "fit_s", "total_s",
            "train_samples_per_s", "peak_memory_bytes")
    return {
        "k1_launches": counts["int8_gram"],
        "fit_chunks": n_chunks,
        "kernels": kernels,
        "streamed": {"int8": {k: res8[k] for k in keep}, "fp32": {k: res32[k] for k in keep},
                     "fit_operator": op, "agreement": agree, "int8_breakdown_warm": breakdown},
        "classic_sweep": {**{k: sweep[k] for k in keep}, "lam_sweep": report},
    }


# --- MoE path (phases 23-24): the decode model's width with the FFN of every
# second block a top-2 MoE of 8 experts (ff ×4, capacity 1.25, groups of
# 4,096: the JAX package's defaults, models/lm/model.py:348-349,
# ops/moe.py:46-51); the experts stay float under int8 weights
MOE_KW = dict(moe_every=2, num_experts=8, capacity_factor=1.25)
MOE_BLOCKS = LM_CONF["depth"] // MOE_KW["moe_every"]
K4_MOE_PER_STEP = 6 * LM_CONF["depth"] - 2 * MOE_BLOCKS  # no FFN pair in a MoE block
MOE_EQUIV_TOL = 1e-4  # of max|logit|, f32 prefill on the card against the CPU
MOE_ROUTE_MARGIN = 1e-4  # router-logit gap above which card and CPU must pick alike
MOE_GRAPHED_STEPS = 64
MOE_TRAIN_STEPS = 20
MOE_TRAIN_ARGV = [a for a in TRAIN_ARGV] + ["--moe-every", "2", "--num-experts", "8"]
MOE_TRAIN_ARGV[MOE_TRAIN_ARGV.index("--steps") + 1] = str(MOE_TRAIN_STEPS)
MOE_TRAIN_LOSS_DROP = 0.05
MOE_GRAD_SEQ = 512  # the f32 gradient check: depth 2, batch 2, seq 512

# --- ViT path (phases 25-26): vit_ridge's own defaults (patch 8, dim 128,
# depth 4, 4 heads, λ 1, chunks of 512, f32) on CIFAR-10's sizes
VIT_ARGV = ["--synthetic", "50000"]
VIT_CHUNK, VIT_DEPTH, VIT_TRAIN, VIT_TEST = 512, 4, 50_000, 10_000
VIT_K2_LAUNCHES = (-(-VIT_TRAIN // VIT_CHUNK) - (-VIT_TEST // VIT_CHUNK)) * VIT_DEPTH
VIT_MAX_TEST_ERROR = 0.05
VIT_FEAT_TOL = 1e-4  # of max|f|, features on the card against the CPU
VIT_K2_SHAPE = (VIT_CHUNK, 4, 16, 32)  # (B, H, S, D) of K2's call in a ViT block
VIT_K2_LAST_SHAPE = (VIT_TRAIN % VIT_CHUNK, 4, 16, 32)  # the last train chunk's call


# --- conv CIFAR path (phases 27-28): the configs' defaults (patch 6, pool
# 14 / stride 13, α 0.25, chunks of 1,024, blocks of 4,096, λ 0) at the
# bench's width (bench.py:224-226, CIFAR_FILTERS = 256) on CIFAR-10's sizes
CIFAR_ARGV = ["--synthetic", "50000", "--num-filters", "256"]
CIFAR_TRAIN, CIFAR_TEST, CIFAR_FILTERS = 50_000, 10_000, 256
CIFAR_FEATURES = 2 * 2 * 2 * CIFAR_FILTERS  # 2 × 2 pools × [pos | neg]
CIFAR_MAX_TEST_ERROR = 0.05
CIFAR_FILTER_TOL = 1e-4  # of max|filters|, build_filters on the card against the CPU
CIFAR_FEAT_TOL = 1e-4  # of max|f|, fused features on the card against the CPU
CIFAR_FEAT_IMAGES = 512
# bench_cifar_conv's featurizer (bench.py:492-536): 4,096 unit-normal
# images, 256 filters, patch 6, whitener means, α 0.25, pool 14 / 13
CONV_N, CONV_PATCH = 4096, 6
CONV_FLOPS = 2 * CONV_N * (32 - CONV_PATCH + 1) ** 2 * CONV_PATCH**2 * 3 * CIFAR_FILTERS
CONV_IMPL_TOL = 2e-4  # of max|out|: auto and unfused against im2col (tests/test_conv_fusion.py)

# --- text path (phase 29): 20 Newsgroups' train-split size, and Stupid
# Backoff on 50,000 synthetic sentences
NEWS_ARGV = ["--synthetic", "11314"]
NEWS_MAX_TEST_ERROR = 0.05
BACKOFF_ARGV = ["--synthetic", "50000"]


def _cpu_copy(model):
    """The same TransformerLM on the CPU, leaf for leaf."""
    from keystone_tpu_torch import convert

    def leaf(t):
        return t.detach().cpu().numpy()

    names = ("wq", "wk", "wv", "wo", "w1", "w2")
    leaves = {
        "embed": leaf(model.embed), "pos_embed": leaf(model.pos_embed),
        "blocks": [dict(zip(names, map(leaf, b.leaves()))) for b in model.blocks],
        "moe_layers": [None if m is None else
                       dict(zip(("w_router", "w1", "w2"), map(leaf, m.leaves())),
                            capacity_factor=m.capacity_factor, group_size=m.group_size)
                       for m in model.moe_layers],
    }
    return convert.transformer_lm(leaves, num_heads=model.num_heads,
                                  compute_dtype=model.compute_dtype, device="cpu")


def _record_routes(model):
    """Hooks on every MoE layer of ``model``: each call's top-2 experts and
    the top-1/top-2 and top-2/top-3 router-logit gaps of every token."""
    seen, hooks = [], []
    for m in model.experts:
        def hook(mod, args, out):
            y = args[0].float().reshape(-1, args[0].shape[-1])
            logits = y @ mod.w_router.float()
            top = logits.topk(3, dim=-1)
            seen.append((top.indices[:, :2].cpu(), (top.values[:, :2] - top.values[:, 1:]).cpu()))
        hooks.append(m.register_forward_hook(hook))
    return seen, hooks


def phase_moe_serving(device) -> dict:
    """Phase 23: the MoE LM at the bench's decode width: generate in float
    and in int8 through K4 (K2 depth a prefill, K4 40 a step), the pool
    graphed and eager, the MoE layers' share of a graphed step, and the f32
    prefill on the card against the CPU."""
    import numpy as np

    from keystone_tpu_torch.models.lm import TransformerLM, decode, generate, quantize_for_decode
    from keystone_tpu_torch.serve.export import export_lm

    depth = LM_CONF["depth"]
    model = TransformerLM.create(**LM_CONF, **MOE_KW, compute_dtype="bfloat16", device=device,
                                 generator=torch.Generator(device=device).manual_seed(0))
    qmodel = quantize_for_decode(model).replace(int8_kernel="kernel")
    expert_params = sum(p.numel() for m in model.experts for p in m.leaves())
    print(f"MoE LM: {model.num_params():,} parameters ({expert_params:,} in {MOE_BLOCKS} MoE "
          f"layers of {MOE_KW['num_experts']} experts), int8 model {qmodel.num_params():,} values")
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(0, LM_CONF["vocab"], size=(LM_BATCH, LM_PROMPT))
    ).to(device)
    legs = {"float": model, "int8_kernel": qmodel}
    res = {}
    for name, m in legs.items():
        generate(m, prompt, max_new=2)
        torch.cuda.synchronize()
        _zero_counts()
        generate(m, prompt, max_new=1)
        torch.cuda.synchronize()
        prefill_counts = _counts()
        _zero_counts()
        out = generate(m, prompt, max_new=LM_MAX_NEW)
        torch.cuda.synchronize()
        counts = _counts()
        k4_want = K4_MOE_PER_STEP * (LM_MAX_NEW - 1) if name == "int8_kernel" else 0
        print(f"MoE LM [{name}] launches: prefill {prefill_counts}, generate {counts}")
        check(prefill_counts["flash_attention"] == depth, f"MoE {name}: prefill {prefill_counts}")
        check(counts["flash_attention"] == depth, f"MoE {name}: K2 launches {counts}")
        check(counts["int8_matmul"] == k4_want,
              f"MoE {name}: K4 launched {counts['int8_matmul']} times, want {k4_want}")
        check(out.shape == (LM_BATCH, LM_MAX_NEW), f"MoE {name}: output {tuple(out.shape)}")
        check(bool(((out >= 0) & (out < LM_CONF["vocab"])).all()), f"MoE {name}: token range")
        res[name] = {"launches": counts, "prefill_launches": prefill_counts}
    for name in [*legs, *reversed(legs)]:
        m = legs[name]
        sec_prefill = _wall(lambda: generate(m, prompt, max_new=1), iters=2)
        sec_full = _wall(lambda: generate(m, prompt, max_new=LM_MAX_NEW), iters=1)
        step_s = max(sec_full - sec_prefill, 1e-9) / (LM_MAX_NEW - 1)
        res[name].setdefault("turns", []).append(
            {"prefill_ms": sec_prefill * 1e3, "generate_ms": sec_full * 1e3,
             "ms_per_step": step_s * 1e3})
    for name, r in res.items():
        for key in ("prefill_ms", "generate_ms", "ms_per_step"):
            r[key] = statistics.mean(t[key] for t in r["turns"])
        r["tokens_per_s"] = LM_BATCH / (r["ms_per_step"] / 1e3)
        print(f"MoE LM [{name}]: prefill {r['prefill_ms']:.2f} ms, {r['ms_per_step']:.3f} ms a "
              f"step, {r['tokens_per_s']:.1f} tokens/s (eager)")

    # the pool: every program captured by warm(), seeded requests
    prompts, news = _serve_requests()
    loop = export_lm(qmodel, slots=SERVE_SLOTS, s_max=SERVE_S_MAX, max_new=32)
    check(loop.graphed and len(loop._prefill_graphs) == len(loop.prefill_buckets),
          "MoE serving: export_lm did not capture the pool's graphs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [loop.submit(p, max_new=n) for p, n in zip(prompts, news)]
    steps = 0
    while not all(f.done() for f in futs):
        if loop.step():
            steps += 1
        elif not loop.pending():
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for f, n in zip(futs, news):
        o = f.result(timeout=0)
        check(len(o) == n and bool(((o >= 0) & (o < LM_CONF["vocab"])).all()),
              f"MoE serving: a request got {len(o)} tokens, asked {n}")
    check(loop.tokens_out == sum(news), f"MoE serving: tokens_out {loop.tokens_out}")
    fill = loop.occupancy_steps / max(steps * SERVE_SLOTS, 1)
    print(f"MoE serving (graphed): {SERVE_REQUESTS} requests, {loop.tokens_out} tokens in "
          f"{wall:.3f} s ({loop.tokens_out / wall:.1f} tokens/s), {steps} steps, mean slot "
          f"fill {fill:.3f}")

    # one pool state, every slot busy: graphed against eager
    for p in prompts[:SERVE_SLOTS]:
        loop.submit(p, max_new=128)
    loop._admit()
    cache = loop.cache
    state = [t.clone() for t in (cache.k, cache.v, cache.pos)]
    tok = loop._tok.copy()

    def restore():
        for buf, saved in zip((cache.k, cache.v, cache.pos), state):
            buf.copy_(saved)

    def eager_step():
        return loop._pool_step(torch.from_numpy(tok).to(device))[0].cpu().numpy()

    step_fns = {"graphed": lambda: loop._run_step(tok), "eager": eager_step}
    step_ms: dict = {"graphed": [], "eager": []}
    with torch.inference_mode():
        g = loop._step_graph
        tok0 = torch.from_numpy(tok).to(device)

        def greedy(graphed: bool):
            restore()
            t, out = tok0.clone(), []
            for _ in range(MOE_GRAPHED_STEPS):
                if graphed:
                    g.inputs[0].copy_(t)
                    g.graph.replay()
                    t = g.outputs[0].clone()
                else:
                    t = loop._pool_step(t)[0]
                out.append(t)
            return torch.stack(out)

        same_tokens = bool(torch.equal(greedy(True), greedy(False)))
        for name in ("graphed", "eager", "eager", "graphed"):
            restore()
            step_ms[name].append(_wall(step_fns[name], iters=50) * 1e3)
        restore()
        step_trace = traced_launches(lambda: [loop._run_step(tok) for _ in range(8)],
                                     reset=restore)
        restore()
        width = loop.prefill_buckets[-1]
        padded = np.zeros((1, width), np.int64)
        padded[0] = np.random.default_rng(6).integers(0, LM_CONF["vocab"], size=width)
        prefill_trace = traced_launches(lambda: loop._run_prefill(padded, width)[0])
        same_first = prefill_trace["out"] == int(loop._prefill(
            torch.from_numpy(padded).to(device), torch.tensor([width], device=device))[0][0])
        # the MoE layers alone at the pooled step's shape, as one graph
        y = torch.randn((SERVE_SLOTS, 1, LM_CONF["dim"]), device=device).to(torch.bfloat16)
        moe_ms = device_ms(lambda: [m(y) for m in qmodel.experts])
    graphed_ms, eager_ms = statistics.mean(step_ms["graphed"]), statistics.mean(step_ms["eager"])
    k4_per_step = step_trace["launches"]["int8_matmul"] / 8
    step_device_ms = step_trace["device_busy_ms"] / 8
    moe_share = moe_ms / step_device_ms if moe_ms else None
    print(f"MoE serving: pooled step, {SERVE_SLOTS} slots busy: graphed {graphed_ms:.3f} ms, eager "
          f"{eager_ms:.3f} ms (turns {step_ms}); device busy {step_device_ms:.3f} ms a step "
          f"({step_trace['device_busy_share']:.1%} of the replays' wall), "
          f"{step_trace['device_kernels'] / 8:.0f} kernels and {k4_per_step:.0f} K4 launches a "
          f"replay; the {MOE_BLOCKS} MoE layers alone {moe_ms} ms ({moe_share} of the step's "
          f"device time); {MOE_GRAPHED_STEPS} greedy steps same tokens: {same_tokens}; prefill "
          f"width {width} replay launches {prefill_trace['launches']}, same first token "
          f"{same_first}")
    check(same_tokens, "MoE serving: the graphed pool step does not reproduce the eager tokens")
    check(k4_per_step == K4_MOE_PER_STEP, f"MoE serving: K4 {k4_per_step} launches a replay")
    check(prefill_trace["launches"]["flash_attention"] == depth,
          f"MoE serving: K2 {prefill_trace['launches']} in a prefill replay")
    check(same_first, "MoE serving: graphed and eager prefill first tokens differ")
    del loop

    # f32 prefill: the card (K2, cuBLAS with TF32 off) against the CPU
    m32 = model.replace(compute_dtype="float32")
    cpu = _cpu_copy(m32)
    seen_dev, hooks = _record_routes(m32)
    dev_logits, _ = decode.prefill(m32, prompt, LM_PROMPT)
    for h in hooks:
        h.remove()
    seen_cpu, hooks = _record_routes(cpu)
    cpu_logits, _ = decode.prefill(cpu, prompt.cpu(), LM_PROMPT)
    for h in hooks:
        h.remove()
    err = _rel(dev_logits.cpu(), cpu_logits)
    clear = tight = differ = 0
    for (i_dev, _), (i_cpu, gap) in zip(seen_dev, seen_cpu):
        ok = gap.min(dim=-1).values > MOE_ROUTE_MARGIN
        clear += int(ok.sum())
        tight += int((~ok).sum())
        differ += int((i_dev[ok] != i_cpu[ok]).any(dim=-1).sum())
    print(f"MoE f32 prefill, card vs CPU: max|Δlogit| / max|logit| = {err:.3e}; top-2 experts "
          f"differ on {differ} of {clear} token-layers with a margin above {MOE_ROUTE_MARGIN} "
          f"({tight} below it)")
    check(differ == 0, f"MoE equivalence: {differ} clear-margin routes differ")
    check(err <= MOE_EQUIV_TOL, f"MoE equivalence: logits differ by {err:.3e} of max")
    del cpu, m32
    torch.cuda.empty_cache()
    return {
        "config": {**LM_CONF, **MOE_KW, "batch": LM_BATCH, "prompt": LM_PROMPT,
                   "max_new": LM_MAX_NEW, "compute_dtype": "bfloat16",
                   "params": model.num_params(), "expert_params": expert_params},
        "legs": res,
        "pool": {"requests": SERVE_REQUESTS, "tokens": sum(news), "wall_s": wall,
                 "tokens_per_s": sum(news) / wall, "steps": steps, "mean_slot_fill": fill},
        "step_ms": {"graphed": graphed_ms, "eager": eager_ms, "turns": step_ms,
                    "device_busy_ms": step_device_ms, "k4_launches": k4_per_step,
                    "moe_layers_device_ms": moe_ms, "moe_share_of_step_device": moe_share},
        "same_tokens_64_steps": same_tokens,
        "prefill_replay_launches": prefill_trace["launches"],
        "f32_equivalence": {"max_rel_err": err, "routes_clear": clear, "routes_tight": tight,
                            "routes_differ": differ},
    }


def moe_step_parts(device, layer, tokens: int) -> dict:
    """One MoE layer's forward and backward at the train step's shape, in
    three parts timed alone (CUDA events, device ms): the routing
    (router product, softmax, masks, the combine weights), the dispatch
    and combine einsums, and the expert einsums with their GELU."""
    import torch.nn.functional as F

    d, e = layer.w_router.shape
    gs = min(layer.group_size, tokens)
    ng, c = -(-tokens // gs), layer._capacity(gs)
    gen = torch.Generator(device=device).manual_seed(41)
    bf16 = torch.bfloat16
    x = torch.randn((ng, gs, d), generator=gen, device=device).to(bf16).requires_grad_(True)
    valid = torch.ones((ng, gs), dtype=torch.bool, device=device)
    probe = layer.replace(**{n: p.detach().clone() for n, p in
                             zip(("w_router", "w1", "w2"), layer.leaves())})
    w = [p.requires_grad_(True) for p in probe.leaves()]
    combine, dispatch, _, _ = probe.dispatch_weights(x, valid, c)
    combine = combine.detach().to(bf16).requires_grad_(True)
    dispatch = dispatch.detach()
    r_comb = torch.randn(combine.shape, generator=gen, device=device)
    exp_in = torch.randn((ng, e, c, d), generator=gen, device=device).to(bf16).requires_grad_(True)
    exp_out = torch.randn((ng, e, c, d), generator=gen, device=device).to(bf16).requires_grad_(True)
    g_in = torch.randn((ng, e, c, d), generator=gen, device=device).to(bf16)
    g_out = torch.randn((ng, gs, d), generator=gen, device=device).to(bf16)

    def routing():
        comb, _, aux, _ = probe.dispatch_weights(x, valid, c)
        torch.autograd.grad((comb * r_comb).sum() + aux.sum(), (x, w[0]))

    def dispatch_combine():
        a = torch.einsum("tgec,tgd->tecd", dispatch, x)
        b = torch.einsum("tgec,tecd->tgd", combine, exp_out)
        torch.autograd.grad(((a * g_in).sum(), (b * g_out).sum()), (x, combine, exp_out))

    def expert_products():
        h = F.gelu(torch.einsum("tecd,edf->tecf", exp_in, w[1].to(bf16)), approximate="tanh")
        out = torch.einsum("tecf,efd->tecd", h, w[2].to(bf16))
        torch.autograd.grad((out * g_in).sum(), (exp_in, w[1], w[2]))

    return {"routing_ms": time_ms(routing, reps=3, rounds=1),
            "dispatch_combine_ms": time_ms(dispatch_combine, reps=3, rounds=1),
            "expert_einsums_ms": time_ms(expert_products, reps=3, rounds=1),
            "groups": ng, "capacity": c}


def phase_moe_train(device) -> dict:
    """Phase 24: the MoE LM trained through ``lm_transformer.main`` at the
    flagship train shape (the loss gate, K2's launches), its steady step
    (ms, rate, TFLOP/s by ``train_step_flops``, peak memory, the profile
    and the step's parts), and the f32 gradients of a depth-2 MoE model on
    the card against the CPU."""
    import numpy as np

    from keystone_tpu_torch.models import lm_transformer
    from keystone_tpu_torch.models.lm import train_step_flops
    from keystone_tpu_torch.models.lm.train import _step_batch, synthetic_corpus

    depth = TRAIN_CONF["depth"]
    recorded = {}
    real_train = lm_transformer.train

    def recording_train(*args, **kw):
        model, losses = real_train(*args, **kw)
        recorded["losses"] = losses
        return model, losses

    lm_transformer.train = recording_train
    _zero_counts()
    try:
        res = lm_transformer.main(list(MOE_TRAIN_ARGV))
        torch.cuda.synchronize()
    finally:
        lm_transformer.train = real_train
    counts = _counts()
    losses = recorded.pop("losses")
    last5 = float(np.mean(losses[-5:]))
    drop = 1 - last5 / losses[0]
    print(f"MoE train main(): {res['params']:,} parameters, {MOE_TRAIN_STEPS} steps, loss "
          f"{losses[0]:.4f} -> {last5:.4f} (mean of last 5, {drop:.1%} lower), "
          f"{res['tokens_per_s']:.0f} tokens/s over the run; launches {counts}")
    check(all(math.isfinite(x) for x in losses), f"MoE train: a loss is not finite {losses}")
    check(drop >= MOE_TRAIN_LOSS_DROP,
          f"MoE train: loss fell {drop:.1%}, want >= {MOE_TRAIN_LOSS_DROP:.0%}")
    check(counts["flash_attention"] == depth * MOE_TRAIN_STEPS,
          f"MoE train: launches {counts}, want K2 {depth * MOE_TRAIN_STEPS}")

    corpus = synthetic_corpus(200_000, TRAIN_CONF["vocab"], seed=0)
    batches = [torch.from_numpy(_step_batch(corpus, 0, i, TRAIN_BATCH, TRAIN_SEQ)).to(device)
               for i in range(2 + TRAIN_TIMED_STEPS)]
    model = _train_model(device, TRAIN_CONF, TRAIN_SEQ, **MOE_KW)
    t_losses, t_ms, t_counts, peak, step, state = _timed_steps(model, batches)
    check(abs(t_losses[0] - losses[0]) <= 1e-5 * losses[0],
          f"MoE train: the timed run's first loss {t_losses[0]} is not main()'s {losses[0]}")
    step_ms = statistics.mean(t_ms[2:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_step_flops(model, TRAIN_BATCH, TRAIN_SEQ)
    prof = train_step_profile(lambda: step(model, state, batches[0]))
    parts = step_parts(device, model, batches[0])
    moe = moe_step_parts(device, model.experts[0], tokens)
    buckets = {
        "expert_einsums": moe["expert_einsums_ms"] * MOE_BLOCKS,
        "dispatch_combine": moe["dispatch_combine_ms"] * MOE_BLOCKS,
        "routing_elementwise": moe["routing_ms"] * MOE_BLOCKS,
        "attention_backward": parts["attention_backward_ms_per_layer"] * depth,
        "logits_ce": parts["tied_logits_ce_ms"],
    }
    out = {
        "params": res["params"], "steps": MOE_TRAIN_STEPS, "loss_first": losses[0],
        "loss_last5": last5, "loss_drop": drop, "losses": losses, "main_result": res,
        "launches": counts, "ms_per_step": step_ms, "step_ms": t_ms,
        "tokens_per_s": tokens / (step_ms / 1e3), "step_flops": flops,
        "tflops_per_s": flops / (step_ms / 1e3) / 1e12,
        "bf16_peak_share": flops / (step_ms / 1e3) / BF16_PEAK_OPS,
        "peak_bytes": peak, "profile": prof, "moe_layer_parts": moe,
        "parts_ms": buckets, "parts_share": {k: v / step_ms for k, v in buckets.items()},
    }
    print(f"MoE train steady: {step_ms:.2f} ms a step ({t_ms}), {out['tokens_per_s']:.0f} "
          f"tokens/s, {out['tflops_per_s']:.1f} TFLOP/s by train_step_flops "
          f"({out['bf16_peak_share']:.1%} of the bf16 peak), peak {peak / 2**30:.2f} GiB; parts "
          f"(ms a step, timed alone) {({k: round(v, 2) for k, v in buckets.items()})}")
    if prof is not None:
        print("MoE train one step's profile: wall {:.1f} ms, device busy {:.1f} ms ({:.1%}); by "
              "kernel bucket {}; top {}".format(
                  prof["wall_ms"], prof["device_busy_ms"], prof["device_busy_share"],
                  {k: round(v, 2) for k, v in prof["ms_by_bucket"].items()},
                  [(t["name"][:50], round(t["ms"], 2)) for t in prof["top"][:8]]))
    del model, state, step, batches
    torch.cuda.empty_cache()

    # f32 gradients, depth 2 (block 2 is the MoE one), card against the CPU
    m32 = _train_model(device, dict(TRAIN_CONF, depth=GRAD_DEPTH), MOE_GRAD_SEQ,
                       compute_dtype="float32", **MOE_KW)
    cpu = _cpu_copy(m32)
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, TRAIN_CONF["vocab"], size=(2, MOE_GRAD_SEQ + 1)))
    got = _leaf_grads(m32, toks.to(device))
    want = _leaf_grads(cpu, toks)
    err = _grad_err([None if g is None else g.cpu() for g in got], want)
    print(f"MoE train f32 gradients, depth {GRAD_DEPTH}, seq {MOE_GRAD_SEQ}: every leaf within "
          f"{err:.3e} of max|grad| of the CPU's")
    check(err <= GRAD_TOL, f"MoE train equivalence: {err:.3e}")
    out["f32_grad_max_rel_err"] = err
    del m32, cpu, got, want
    torch.cuda.empty_cache()
    return out


def phase_vit(device) -> dict:
    """Phase 25: ``vit_ridge.main`` on 50,000 + 10,000 synthetic images (K2
    f32, 472 launches) and ``cifar_linear_pixels.main`` beside it; ViT
    features on the card against the CPU's on 512 images."""
    import numpy as np

    from keystone_tpu_torch.models import cifar_linear_pixels, vit_ridge
    from keystone_tpu_torch.ops.vit import ViTBlock, ViTFeaturizer

    _zero_counts()
    res = vit_ridge.main(list(VIT_ARGV), device="cuda")
    torch.cuda.synchronize()
    counts = _counts()
    print(f"ViT-ridge: train error {res['train_error']:.4f}, test error {res['test_error']:.4f}, "
          f"featurize {res['featurize_s']:.3f} s, fit {res['fit_s']:.3f} s, total "
          f"{res['total_s']:.3f} s, {res['featurize_fit_samples_per_s']:.0f} samples/s; "
          f"launches {counts}")
    check(res["n_train"] == VIT_TRAIN and res["n_test"] == VIT_TEST, f"ViT sizes {res}")
    check(counts["flash_attention"] == VIT_K2_LAUNCHES,
          f"ViT: K2 launched {counts['flash_attention']} times, want {VIT_K2_LAUNCHES}")
    check(res["test_error"] <= VIT_MAX_TEST_ERROR, f"ViT test error {res['test_error']}")
    # a second run, warm: the featurize and fit without first-use costs;
    # featurize_s holds the synthetic load, timed here alone
    warm = vit_ridge.main(list(VIT_ARGV), device="cuda")
    t0 = time.perf_counter()
    vit_ridge._load(vit_ridge.LinearPixelsConfig(synthetic=VIT_TRAIN), "train")
    load_s = time.perf_counter() - t0
    print(f"ViT-ridge warm: featurize {warm['featurize_s']:.3f} s (the synthetic train load "
          f"alone {load_s:.3f} s), fit {warm['fit_s']:.3f} s, "
          f"{warm['featurize_fit_samples_per_s']:.0f} samples/s")

    lp = cifar_linear_pixels.main(list(VIT_ARGV), device="cuda")
    print(f"linear pixels: train error {lp['train_error']:.4f}, test error {lp['test_error']:.4f},"
          f" total {lp['total_s']:.3f} s")
    check(lp["test_error"] <= VIT_MAX_TEST_ERROR, f"linear pixels test error {lp['test_error']}")

    conf = vit_ridge.ViTRidgeConfig(synthetic=VIT_TRAIN)
    vit = vit_ridge.make_featurizer(conf, 32, device)
    cpu = ViTFeaturizer(
        patch_embed=vit.patch_embed.cpu(), pos_embed=vit.pos_embed.cpu(),
        blocks=tuple(ViTBlock(*(getattr(b, n).cpu() for n in ("wq", "wk", "wv", "wo", "w1", "w2")),
                              num_heads=b.num_heads) for b in vit.blocks))
    images = vit_ridge._load(vit_ridge.LinearPixelsConfig(synthetic=VIT_CHUNK), "train").images
    x = torch.from_numpy(images / np.float32(255.0))
    err = _rel(vit(x.to(device)).cpu(), cpu(x))
    print(f"ViT features, card (K2) vs CPU on {VIT_CHUNK} images: {err:.3e} of max|f|")
    check(err <= VIT_FEAT_TOL, f"ViT features differ by {err:.3e} of max")
    return {"vit_ridge": res, "vit_ridge_warm": warm, "train_load_s": load_s, "linear_pixels": lp,
            "launches": counts, "feature_max_rel_err": err}


def phase_k2_vit(device) -> dict:
    """Phase 26: K2's f32 short-key kernel at ViT's shapes, non-causal, a
    full chunk (512, 4, 16, 32) and the last train chunk (336, 4, 16, 32):
    out and lse against its plain version, timed beside it, SDPA on the
    same f32 tensors and its bound."""
    import torch.nn.functional as F

    from keystone_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(26)
    res = {}
    for name, shape in (("chunk", VIT_K2_SHAPE), ("last_train_chunk", VIT_K2_LAST_SHAPE)):
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device=device) for _ in range(3))
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q, k, v, return_lse=True)
        err, lse_err = _rel(out, ref), float((lse - ref_lse).abs().max())
        max_abs = float((out - ref).abs().max())
        check(err <= K2_F32_TOL, f"K2 at {shape} disagrees with its plain version ({err:.3e})")
        check(lse_err <= K2_LSE_TOL, f"K2's lse at {shape} disagrees ({lse_err:.3e})")
        kernel_ms = device_ms(lambda: fa.flash_attention(q, k, v))
        plain_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v))
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        ops = 4.0 * b * h * s * s * d
        traffic = 4.0 * b * h * s * d * 4  # q, k, v read once, o written once, f32
        ops_ms, bytes_ms = 1e3 * ops / F32_PEAK_OPS, 1e3 * traffic / HBM_BYTES_PER_S
        bound_ms = max(ops_ms, bytes_ms)
        print(f"K2 {shape} f32 non-causal (short-key kernel): max|kernel-plain| / max|plain| = "
              f"{err:.3e}, lse {lse_err:.3e}; device times kernel {kernel_ms} ms, plain "
              f"{plain_ms} ms, sdpa {library_ms} ms, bound {bound_ms:.5f} ms"
              + (f" ({bound_ms / kernel_ms:.1%} of it)" if kernel_ms else ""))
        res[name] = {"shape": list(shape), "dtype": "float32", "causal": False,
                     "max_abs_err": max_abs, "max_rel_err": err, "lse_max_abs_err": lse_err,
                     "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "library": "scaled_dot_product_attention, f32", "bound_ms": bound_ms,
                     "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        del q, k, v, out, lse, ref, ref_lse
    return {**res["chunk"], "last_train_chunk": res["last_train_chunk"]}


def _rows(res: dict) -> dict:
    """A run's result without its per-row arrays (for the JSON lines)."""
    return {k: v for k, v in res.items() if k not in ("test_predictions", "fit_decisions")}


def _print_cifar(name: str, res: dict) -> None:
    print(f"{name}: train error {res['train_error']:.4f}, test error {res['test_error']:.4f}, "
          f"setup {res['setup_s']:.3f} s (the synthetic load {res['load_s']:.3f} s), featurize "
          f"{res['featurize_s']:.3f} s, fit {res['fit_s']:.3f} s, total {res['total_s']:.3f} s, "
          f"{res['featurize_fit_samples_per_s']:.0f} samples/s")


def phase_cifar_conv(device) -> dict:
    """Phase 27: ``cifar_random_patch.main`` and ``cifar_random.main``
    (classic, then ``KEYSTONE_PLAN=1``) on 50,000 + 10,000 synthetic images
    at 256 filters; ``build_filters`` and the fused features on the card
    against the CPU; the whitener's SVD timed; K1 held against its plain
    version at the planned fit's first chunk."""
    import numpy as np

    from keystone_tpu_torch.models import cifar_random, cifar_random_patch
    from keystone_tpu_torch.observe import metrics
    from keystone_tpu_torch.ops.linalg import ZCAWhitenerEstimator

    rewrites = metrics.get_registry().counter("fusion_rewrites", rule="conv_rectify_pool")
    before = rewrites.value
    _zero_counts()
    rp = cifar_random_patch.main(list(CIFAR_ARGV), device="cuda")
    torch.cuda.synchronize()
    rp_counts = _counts()
    _print_cifar("random-patch CIFAR", rp)
    print(f"  launches {rp_counts}")
    check(rp["n_train"] == CIFAR_TRAIN and rp["n_test"] == CIFAR_TEST, f"CIFAR sizes {_rows(rp)}")
    check(rp["num_features"] == CIFAR_FEATURES, f"random-patch features {rp['num_features']}")
    check(rp["test_error"] <= CIFAR_MAX_TEST_ERROR, f"random-patch test error {rp['test_error']}")

    # the planner picks the planned fit's Gram by its cost model
    os.environ.pop("KEYSTONE_PLAN", None)
    os.environ.pop("KEYSTONE_GRAM_OP", None)
    _zero_counts()
    rc = cifar_random.main(list(CIFAR_ARGV), device="cuda")
    rc_counts = _counts()
    _print_cifar("random-filter CIFAR, classic", rc)
    os.environ["KEYSTONE_PLAN"] = "1"
    try:
        _zero_counts()
        rcp = cifar_random.main(list(CIFAR_ARGV), device="cuda")
        torch.cuda.synchronize()
        rcp_counts = _counts()
    finally:
        os.environ.pop("KEYSTONE_PLAN", None)
    _print_cifar("random-filter CIFAR, KEYSTONE_PLAN=1", rcp)
    fit_op = next(d for d in rcp["fit_decisions"] if d["action"] == "fit_operator")
    print(f"  plan's fit operator {fit_op}; launches classic {rc_counts}, planned {rcp_counts}")
    for res in (rc, rcp):
        check(res["test_error"] <= CIFAR_MAX_TEST_ERROR, f"random-filter test error {res['test_error']}")
    check(fit_op["op"] == "int8", f"the planned fit took {fit_op['op']}, not the int8 Gram")
    chunk = [d["size"] for d in rcp["fit_decisions"] if d["action"] == "chunk"][-1]
    chunk = chunk or rcp["n_train"]
    k1_want = -(-rcp["n_train"] // chunk)
    check(rcp_counts["int8_gram"] == k1_want and rc_counts["int8_gram"] == 0,
          f"K1 launched {rcp_counts['int8_gram']} times in the planned fit, want {k1_want}")
    agree = float((rc["test_predictions"] == rcp["test_predictions"]).mean())
    print(f"  classic vs planned test predictions agree on {agree:.4%}")
    check(agree >= MIN_AGREEMENT, f"random-filter classic/planned agreement {agree:.4%}")
    n_rewrites = rewrites.value - before
    check(n_rewrites == 3, f"fusion_rewrites{{conv_rectify_pool}} counted {n_rewrites} for 3 optimize")

    # warm, under the profiler: the same run without first-use costs
    # (cuDNN's plans, cuSOLVER), and the card's busy share of its wall
    runs = []
    prof = train_step_profile(lambda: runs.append(cifar_random_patch.main(list(CIFAR_ARGV),
                                                                          device="cuda")))
    warm = runs[0]
    _print_cifar("random-patch CIFAR warm", warm)
    if prof is not None:
        print(f"  the warm run under the profiler: wall {prof['wall_ms']:.1f} ms, card busy "
              f"{prof['device_busy_ms']:.1f} ms ({prof['device_busy_share']:.1%}); top "
              f"{[(t['name'][:40], round(t['ms'], 2)) for t in prof['top'][:5]]}")

    conf = cifar_random_patch.RandomCifarConfig(synthetic=CIFAR_TRAIN, num_filters=CIFAR_FILTERS)
    t0 = time.perf_counter()
    images = cifar_random_patch._load(cifar_random_patch.LinearPixelsConfig(
        synthetic=CIFAR_TRAIN), "train").images
    load_s = time.perf_counter() - t0
    base = cifar_random_patch.patch_sample(images, conf, np.random.default_rng(conf.seed), device)
    svd_s = []
    for _ in range(2):  # cold, warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ZCAWhitenerEstimator().fit(base)
        torch.cuda.synchronize()
        svd_s.append(time.perf_counter() - t0)
    print(f"  the synthetic train load alone {load_s:.3f} s; the whitener's fit (SVD of "
          f"{tuple(base.shape)} on the card) cold {svd_s[0]:.4f} s, warm {svd_s[1]:.4f} s")
    k1 = cifar_k1_chunk(images, chunk, device)
    filters, means = cifar_random_patch.build_filters(images, conf, device)
    cpu_filters, cpu_means = cifar_random_patch.build_filters(images, conf, "cpu")
    filter_err = _rel(filters.cpu(), cpu_filters)
    x = torch.from_numpy(images[:CIFAR_FEAT_IMAGES])
    feat = cifar_random_patch.make_featurizer(filters, means, conf)
    cpu_feat = cifar_random_patch.make_featurizer(filters.cpu(), means.cpu(), conf)
    feat_err = _rel(feat(x.to(device)).cpu(), cpu_feat(x))
    print(f"  build_filters card vs CPU {filter_err:.3e} of max|filters|; fused features card vs "
          f"CPU on {CIFAR_FEAT_IMAGES} images {feat_err:.3e} of max|f|")
    check(filter_err <= CIFAR_FILTER_TOL, f"build_filters differ by {filter_err:.3e}")
    check(feat_err <= CIFAR_FEAT_TOL, f"fused features differ by {feat_err:.3e}")
    return {"random_patch": _rows(rp), "random_patch_warm": _rows(warm),
            "random_filter_classic": _rows(rc), "random_filter_planned": _rows(rcp),
            "planned_fit_operator": fit_op, "agreement": agree,
            "launches": {"random_patch": rp_counts, "random_filter_classic": rc_counts,
                         "random_filter_planned": rcp_counts},
            "fusion_rewrites": n_rewrites, "train_load_s": load_s, "warm_profile": prof,
            "whitener_fit_s": {"cold": svd_s[0], "warm": svd_s[1], "rows": base.shape[0]},
            "filter_max_rel_err": filter_err, "feature_max_rel_err": feat_err, "k1": k1}


def cifar_k1_chunk(images, chunk: int, device) -> dict:
    """K1 at the planned ``cifar_random`` fit's first chunk: the train
    features through the fit's ``StandardScaler``, centred as
    ``normal_eq_update`` centres a full chunk, as int8 codes."""
    from keystone_tpu_torch.core.batching import apply_in_chunks
    from keystone_tpu_torch.models import cifar_random
    from keystone_tpu_torch.ops.gram import _quantize_cols
    from keystone_tpu_torch.ops.stats import StandardScaler

    conf = cifar_random.RandomCifarFilterConfig(synthetic=CIFAR_TRAIN, num_filters=CIFAR_FILTERS)
    _, filters = cifar_random.random_filters(conf, len(images))
    feat = cifar_random.make_featurizer(torch.from_numpy(filters).to(device), conf)
    with torch.no_grad():
        raw = apply_in_chunks(feat, images, conf.chunk_size, device)
        a = StandardScaler(normalize_std_dev=True).fit(raw, n_valid=len(images))(raw[:chunk])
        del raw
        q = _quantize_cols(a - a.sum(0) / a.shape[0])[0].contiguous()
    del a
    check(q.shape == (chunk, CIFAR_FEATURES), f"the CIFAR fit chunk is {tuple(q.shape)}")
    return k1_at_chunk(q, "CIFAR random filter")


def phase_conv_bench(device) -> dict:
    """Phase 28: the featurizer at ``bench_cifar_conv``'s shape — the
    fused node (``auto``), its ``unfused`` chain and the im2col
    (``xla``) Convolver's chain, each by device time, the first two held
    against the third."""
    import numpy as np

    from keystone_tpu_torch.core.fusion import optimize
    from keystone_tpu_torch.ops import images as im

    rng = np.random.default_rng(1)
    batch = torch.from_numpy(rng.normal(size=(CONV_N, 32, 32, 3)).astype(np.float32)).to(device)
    d = CONV_PATCH * CONV_PATCH * 3
    filters = torch.from_numpy(rng.normal(size=(CIFAR_FILTERS, d)).astype(np.float32)).to(device)
    means = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)).to(device)
    common = dict(filters=filters, whitener_means=means, patch_size=CONV_PATCH)
    tail = im.SymmetricRectifier(alpha=0.25) >> im.Pooler(stride=13, pool_size=14) >> im.ImageVectorizer()
    legs = {
        "auto": optimize(im.Convolver(**common) >> tail),
        "unfused": im.FusedConvRectifyPool(alpha=0.25, impl="unfused", **common)
        >> im.ImageVectorizer(),
        "xla": im.Convolver(impl="xla", **common) >> tail,
    }
    check(type(legs["auto"].nodes[0]).__name__ == "FusedConvRectifyPool", "optimize did not fuse")
    outs = {name: pipe(batch) for name, pipe in legs.items()}
    torch.cuda.synchronize()
    errs = {name: _rel(outs[name], outs["xla"]) for name in ("auto", "unfused")}
    del outs
    ms = {}
    for name, pipe in legs.items():
        ms[name] = device_ms(lambda p=pipe: p(batch), reps=5)
        check(ms[name] is not None, f"the {name} leg could not be captured in a CUDA graph")
    conv_only = device_ms(lambda: im.conv_convolver(batch, filters, patch_size=CONV_PATCH,
                                                    normalize_patches=True, var_constant=10.0,
                                                    whitener_means=means), reps=5)
    check(conv_only is not None, "the Convolver could not be captured in a CUDA graph")
    bound_ms = max(1e3 * CONV_FLOPS / F32_PEAK_OPS,
                   1e3 * 4.0 * (batch.numel() + CONV_N * 4 * 2 * CIFAR_FILTERS) / HBM_BYTES_PER_S)
    samples_per_s = CONV_N / (ms["auto"] / 1e3)
    tflops = CONV_FLOPS / (ms["auto"] / 1e3) / 1e12
    print(f"conv featurizer {(CONV_N, 32, 32, 3)}, {CIFAR_FILTERS} filters: device ms auto "
          f"{ms['auto']:.3f}, unfused {ms['unfused']:.3f}, xla (im2col) {ms['xla']:.3f}; the "
          f"Convolver alone {conv_only:.3f} ms; f32 bound {bound_ms:.3f} ms (operations, "
          f"{CONV_FLOPS / 1e9:.1f} GFLOP); cifar_conv_samples_per_s {samples_per_s:.1f}, "
          f"{tflops:.2f} TFLOP/s; auto vs xla {errs['auto']:.3e}, unfused vs xla "
          f"{errs['unfused']:.3e} of max|out|")
    for name, err in errs.items():
        check(err <= CONV_IMPL_TOL, f"conv {name} differs from im2col by {err:.3e}")
    return {"shape": [CONV_N, 32, 32, 3], "filters": CIFAR_FILTERS, "device_ms": ms,
            "convolver_ms": conv_only, "bound_ms": bound_ms, "bound_by": "operations",
            "conv_gflop": CONV_FLOPS / 1e9, "cifar_conv_samples_per_s": samples_per_s,
            "cifar_conv_tflops_per_chip": tflops, "max_rel_err_vs_xla": errs}


def phase_text(device) -> dict:
    """Phase 29: ``newsgroups_pipeline.main`` (plain, then ``--corenlp``)
    on 11,314 synthetic documents and ``stupid_backoff_pipeline.main`` on
    50,000 sentences; the card's naive Bayes predictions against the
    CPU's on the same counts, and its fit's device time."""
    from keystone_tpu_torch.models import newsgroups_pipeline as ng
    from keystone_tpu_torch.models import stupid_backoff_pipeline as sb
    from keystone_tpu_torch.ops.naive_bayes import NaiveBayesEstimator
    from keystone_tpu_torch.ops.sparse import CommonSparseFeatures

    _zero_counts()
    runs = {}
    for name, extra in (("plain", []), ("corenlp", ["--corenlp"])):
        res = ng.main(list(NEWS_ARGV) + extra, device="cuda")
        print(f"newsgroups {name}: train error {res['train_error']:.4f}, test error "
              f"{res['test_error']:.4f}, vocab {res['vocab_size']}, featurize (host) "
              f"{res['featurize_s']:.3f} s, fit {res['fit_s']:.4f} s, total {res['total_s']:.3f} s")
        check(res["device"].startswith(device.type), f"newsgroups ran on {res['device']}")
        check(res["test_error"] <= NEWS_MAX_TEST_ERROR, f"newsgroups {name} test error")
        runs[name] = _rows(res)
    backoff = sb.main(list(BACKOFF_ARGV))
    print(f"stupid backoff: {backoff['num_tokens']} tokens, vocab {backoff['vocab_size']}, "
          f"{backoff['num_ngrams']} n-grams, total {backoff['total_s']:.3f} s (host only)")
    check(backoff["num_ngrams"] > 0, "stupid backoff counted no n-gram")
    counts = _counts()

    conf = ng.NewsgroupsConfig(synthetic=int(NEWS_ARGV[1]))
    train, test = ng._load(conf, "train"), ng._load(conf, "test")
    feat = ng.make_featurizer(conf)
    train_tf = feat(train.data)
    vec = CommonSparseFeatures(conf.common_features).fit(train_tf)
    x, x_test = torch.from_numpy(vec(train_tf)), torch.from_numpy(vec(feat(test.data)))
    est = NaiveBayesEstimator(num_classes=ng.NUM_CLASSES)
    x_dev, y_dev = x.to(device), torch.from_numpy(train.labels).to(device)
    card = est.fit(x_dev, y_dev)(x_test.to(device)).argmax(1).cpu()
    cpu = est.fit(x, train.labels)(x_test).argmax(1)
    same = bool(torch.equal(card, cpu))
    fit_ms = device_ms(lambda: est.fit(x_dev, y_dev))
    check(fit_ms is not None, "the naive Bayes fit could not be captured in a CUDA graph")
    print(f"  naive Bayes on {tuple(x.shape)} counts: card and CPU test predictions equal: "
          f"{same}; fit device {fit_ms:.4f} ms; launches {counts}")
    check(same, "naive Bayes predictions differ between the card and the CPU")
    return {"newsgroups": runs, "stupid_backoff": backoff, "nb_counts_shape": list(x.shape),
            "nb_fit_device_ms": fit_ms, "nb_card_equals_cpu": same, "launches": counts}


# --- phases 30-31: the VOC SIFT-Fisher workload (voc_sift_fisher.VOCConfig's
# defaults: 256², 5 SIFT scales, desc 80, vocab 256, 1e6 PCA and GMM samples,
# 100 EM iterations, λ 0.5, chunks of 64, blocks of 4,096)
VOC_ARGV = ["--synthetic", "1024"]  # 1,024 train and 256 test images
VOC_MIN_TRAIN_MAP = 0.3  # the JAX package's own gate (tests/test_voc_pipeline.py)
# the JAX package's test configuration, run on the card and on the CPU
VOC_TINY = dict(synthetic=24, image_size=64, sift_scales=2, desc_dim=16, vocab_size=4,
                num_pca_samples=2000, num_gmm_samples=1000, lam=5.0, block_size=512,
                chunk_size=8)
VOC_TINY_FEAT_TOL = 1e-4  # of max|f|, Fisher features on the card against the CPU
VOC_TINY_MAP_TOL = 1e-4
VOC_EM_ITERS = 10
VOC_EM_ROWS = 250_000  # the CPU's EM check runs on the sample's first rows
VOC_EM_TOL = 1e-3  # of max|mean|, the card's EM against the CPU's from one start
SIFT_N, SIFT_HW = 16, 256  # bench.py's bench_sift shape (SIFT_N, SIFT_HW)
SIFT_MIN_EQUAL = 0.999  # card against CPU: ≥ 99.9 % of entries equal, all within ±1
SIFT_GOLDEN_MIN = 0.995  # the reference's golden gate: ≥ 99.5 % within ±1


def phase_voc(device) -> dict:
    """Phase 30: ``voc_sift_fisher.main`` at the reference's full width on
    1,024 + 256 synthetic images (the GMM and PCA samples it draws are
    kept for the gates); the card's EM from the CPU's start against the
    CPU's, on that GMM sample; the card's PCA against the CPU's by the
    projector onto the kept subspace; and the JAX package's test
    configuration on the card and on the CPU from one set of artifacts."""
    import tempfile

    from keystone_tpu_torch.core.config import parse_config
    from keystone_tpu_torch.core.kernels import BUILD_DIR
    from keystone_tpu_torch.models import fisher_common
    from keystone_tpu_torch.models import voc_sift_fisher as voc
    from keystone_tpu_torch.ops import gmm
    from keystone_tpu_torch.ops.images import GrayScaler, PixelScaler
    from keystone_tpu_torch.ops.sift import SIFTExtractor

    kept = {}
    estimator, compute_pca = fisher_common.GaussianMixtureModelEstimator, fisher_common.compute_pca

    class KeepingEstimator(estimator):
        def fit(self, samples):
            kept["gmm_sample"] = samples
            return super().fit(samples)

    def keeping_pca(data, dims):
        kept["pca_sample"] = data
        return compute_pca(data, dims)

    fisher_common.GaussianMixtureModelEstimator = KeepingEstimator
    fisher_common.compute_pca = keeping_pca
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    try:
        res = voc.main(list(VOC_ARGV), device="cuda")
        torch.cuda.synchronize()
    finally:
        fisher_common.GaussianMixtureModelEstimator = estimator
        fisher_common.compute_pca = compute_pca
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"VOC SIFT-Fisher {VOC_ARGV}: train mAP {res['train_map']:.4f}, test mAP "
          f"{res['test_map']:.4f}; load {res['load_s']:.3f} s, SIFT {res['sift_s']:.3f} s, PCA "
          f"{res['pca_s']:.3f} s, GMM {res['gmm_s']:.3f} s, Fisher {res['fisher_s']:.3f} s, "
          f"featurize {res['featurize_s']:.3f} s, fit {res['fit_s']:.3f} s, test "
          f"{res['test_s']:.3f} s, total {res['total_s']:.3f} s, "
          f"{res['featurize_fit_samples_per_s']:.1f} samples/s; peak memory {peak_gb:.2f} GiB; "
          f"features {res['num_features']}; launches {counts}")
    conf = parse_config(voc.VOCConfig, VOC_ARGV)
    check(res["n_train"] == conf.synthetic and res["n_test"] == conf.synthetic // 4,
          f"VOC sizes {res}")
    check(res["device"].startswith("cuda"), f"VOC ran on {res['device']}")
    check(res["train_map"] > VOC_MIN_TRAIN_MAP, f"VOC train mAP {res['train_map']}")
    check(not any(counts.values()), f"a hand kernel launched on the VOC path: {counts}")

    # EM from one start on the first rows of the run's own GMM sample, card
    # against CPU (the CPU's iterations are the cost: 13.7 s each at 1e6 rows)
    x = kept.pop("gmm_sample")[:VOC_EM_ROWS]
    x_cpu = x.cpu()
    init = gmm.gmm_init(x_cpu, conf.vocab_size, seed=42, var_floor=gmm.VAR_FLOOR)
    t0 = time.perf_counter()
    want = gmm.gmm_em(x_cpu, *init, VOC_EM_ITERS)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = gmm.gmm_em(x, *(a.to(device) for a in init), VOC_EM_ITERS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    em_err = _rel(got[0].cpu(), want[0])
    em_rows = int(x.shape[0])
    em_flops = 8.0 * em_rows * x.shape[1] * conf.vocab_size  # 4 products an iteration
    em_ms = 1e3 * card_s / VOC_EM_ITERS
    print(f"  EM on the run's GMM sample {tuple(x.shape)}, k {conf.vocab_size}, "
          f"{VOC_EM_ITERS} iterations from the CPU's start: card {em_ms:.2f} ms an iteration "
          f"({em_flops / (em_ms / 1e3) / 1e12:.2f} TFLOP/s of f32 products), CPU "
          f"{1e3 * cpu_s / VOC_EM_ITERS:.1f} ms; means card vs CPU {em_err:.3e} of max|mean|")
    check(em_err <= VOC_EM_TOL, f"the card's EM means differ from the CPU's by {em_err:.3e}")
    del x, x_cpu, got, want

    # the PCA of the run's own sample, card against CPU, by its projector
    sample = kept.pop("pca_sample")
    p_card = compute_pca(sample, conf.desc_dim).double()
    p_cpu = compute_pca(sample.cpu(), conf.desc_dim).double()
    pca_err = _rel((p_card @ p_card.T).cpu(), p_cpu @ p_cpu.T)
    print(f"  PCA of the run's sample {tuple(sample.shape)}: the card's projector onto its "
          f"{conf.desc_dim} directions vs the CPU's {pca_err:.3e} of max")
    del sample

    # the JAX package's test configuration: the CPU fits and writes the
    # artifacts, the card loads them
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        files = {k: os.path.join(tmp, f) for k, f in (
            ("pca_file", "pca.csv"), ("gmm_mean_file", "m.csv"), ("gmm_var_file", "v.csv"),
            ("gmm_wt_file", "w.csv"))}
        tiny = voc.VOCConfig(**VOC_TINY, **files)
        tiny_cpu = voc.run(tiny, device="cpu")
        tiny_card = voc.run(tiny, device="cuda")
        desc = (PixelScaler() >> GrayScaler() >> SIFTExtractor(num_scales=tiny.sift_scales))(
            torch.from_numpy(voc._load(tiny, "train").images))
        feats = []
        for dev in ("cpu", device):
            branch = fisher_common.FisherBranch(
                tiny.desc_dim, tiny.vocab_size, tiny.num_pca_samples, tiny.num_gmm_samples,
                tiny.seed, pca_file=files["pca_file"],
                gmm_files=(files["gmm_mean_file"], files["gmm_var_file"], files["gmm_wt_file"]),
                device=dev)
            branch.fit(desc.to(dev), tiny.chunk_size)
            feats.append(branch.featurize(desc.to(dev), tiny.chunk_size).cpu())
    feat_err = _rel(feats[1], feats[0])
    map_err = max(abs(tiny_card[k] - tiny_cpu[k]) for k in ("train_map", "test_map"))
    print(f"  the JAX package's test configuration: train mAP card {tiny_card['train_map']:.4f} "
          f"CPU {tiny_cpu['train_map']:.4f}, test mAP card {tiny_card['test_map']:.4f} CPU "
          f"{tiny_cpu['test_map']:.4f}; Fisher features card vs CPU {feat_err:.3e} of max|f|")
    check(feat_err <= VOC_TINY_FEAT_TOL, f"tiny VOC Fisher features differ by {feat_err:.3e}")
    check(map_err <= VOC_TINY_MAP_TOL, f"tiny VOC mAPs differ by {map_err:.3e}")
    return {"run": _rows(res), "peak_mem_gib": peak_gb, "launches": counts,
            "em_check": {"rows": em_rows,
                         "iters": VOC_EM_ITERS, "card_ms_per_iter": em_ms,
                         "cpu_ms_per_iter": 1e3 * cpu_s / VOC_EM_ITERS,
                         "tflops": em_flops / (em_ms / 1e3) / 1e12, "means_max_rel_err": em_err},
            "pca_projector_max_rel_err": pca_err,
            "tiny": {"card": _rows(tiny_card), "cpu": _rows(tiny_cpu),
                     "feature_max_rel_err": feat_err, "map_max_abs_err": map_err}}


def phase_sift_bench(device) -> dict:
    """Phase 31: SIFT at ``bench_sift``'s shape (16 × 256², ``default_rng(4)``
    images, the VOC defaults): images/s, device ms and launches of one
    call (profiler), a bytes bound for the orientation planes' passes; the
    card's descriptors against the CPU's, and both goldens on the card."""
    import pathlib

    import numpy as np

    from keystone_tpu_torch.ops.sift import NUM_ORIENTATIONS, SIFTExtractor

    imgs = np.random.default_rng(4).random((SIFT_N, SIFT_HW, SIFT_HW)).astype(np.float32)
    ext = SIFTExtractor()
    batch = torch.from_numpy(imgs).to(device)
    out = ext(batch)
    torch.cuda.synchronize()
    wall_s = _wall(lambda: ext(batch), 5)
    ms = time_ms(lambda: ext(batch))
    prof = train_step_profile(lambda: ext(batch))
    # per scale the (N, H, W, 8) planes are written once, read and written by
    # each of the triangular convolution's two passes, and read by the gather
    plane_bytes = 4.0 * SIFT_N * SIFT_HW * SIFT_HW * NUM_ORIENTATIONS
    bound_ms = 1e3 * 6 * plane_bytes * ext.num_scales / HBM_BYTES_PER_S
    cpu = ext(torch.from_numpy(imgs))
    got = out.cpu()
    equal = float((got == cpu).float().mean())
    max_diff = float((got - cpu).abs().max())
    goldens = {}
    gdir = pathlib.Path(__file__).resolve().parent / "tests" / "goldens"
    for name in ("synthetic", "voc000012"):
        golden = np.loadtxt(gdir / f"sift_{name}.csv", delimiter=",")
        img = np.loadtxt(gdir / f"sift_{name}_input.csv", delimiter=",").astype(np.float32)
        header = (gdir / f"sift_{name}.csv").read_text().splitlines()[0]
        p = dict(kv.split("=") for kv in header.lstrip("# ").split() if "=" in kv)
        g_ext = SIFTExtractor(step=int(p["step"]), bin_size=int(p["bin_size"]),
                              num_scales=int(p["num_scales"]), scale_step=int(p["scale_step"]))
        desc = g_ext(torch.from_numpy(img)[None].to(device))[0].T.cpu().numpy()
        check(desc.shape == golden.shape, f"golden {name}: {desc.shape} vs {golden.shape}")
        goldens[name] = float((np.abs(desc - golden) <= 1.0).mean())
    busy = prof and prof["device_busy_ms"]
    launches = prof and prof["device_kernels"]
    print(f"SIFT {(SIFT_N, SIFT_HW, SIFT_HW)} -> {tuple(out.shape)}: {SIFT_N / wall_s:.1f} "
          f"images/s ({1e3 * wall_s:.2f} ms a call wall, {ms:.2f} ms by CUDA events); device "
          f"busy {busy} ms over {launches} kernel launches a call; bytes bound of the "
          f"orientation planes' passes {bound_ms:.3f} ms; card vs CPU: {equal:.5%} equal, "
          f"max diff {max_diff}; goldens within ±1 {goldens}")
    check(max_diff <= 1.0 and equal >= SIFT_MIN_EQUAL,
          f"SIFT card vs CPU: {equal:.5%} equal, max diff {max_diff}")
    for name, frac in goldens.items():
        check(frac >= SIFT_GOLDEN_MIN, f"SIFT golden {name} on the card: {frac:.4%} within ±1")
    return {"shape": [SIFT_N, SIFT_HW, SIFT_HW], "descriptors": list(out.shape),
            "images_per_s": SIFT_N / wall_s, "wall_ms": 1e3 * wall_s, "event_ms": ms,
            "device_busy_ms": busy, "launches_per_call": launches, "bound_ms": bound_ms,
            "bound_by": "bytes", "profile": prof, "card_vs_cpu_equal": equal,
            "card_vs_cpu_max_diff": max_diff, "goldens_within_1": goldens}


# --- phases 32-33: the ImageNet SIFT + LCS Fisher workload at ImageNetConfig's
# widths (desc 64, vocab 16, 5 SIFT scales, LCS stride 4, border 16, patch 6,
# λ 6e-5, mixture weight 0.25, blocks of 4,096, chunks of 32: D = 2 branches ×
# 2·64·16 = 4,096 features), and the weighted solver at bench.py's two shapes
IMNET_ARGV = ["--synthetic", "1024"]  # 1,024 + 256 images, 8 classes (the default)
IMNET_MAX_TOP1 = 0.05  # the synthetic classes are far apart
IMNET_STREAM_ARGV = ["--synthetic", "2048", "--synthetic-classes", "1000", "--streaming"]
IMNET_FEATURES = 2 * 2 * 64 * 16
# a small configuration, featurized on the card and on the CPU from one set of
# descriptors and artifacts
IMNET_TINY = dict(synthetic=48, synthetic_classes=4, desc_dim=8, vocab_size=4,
                  num_pca_samples=2000, num_gmm_samples=1000, image_size=64, chunk_size=8,
                  stream_batch=16)
# the card's Fisher features against the CPU's, of max|f|: 1e-4, or 4 times
# what a 1e-7 relative (f32 round-off) perturbation of the descriptors moves
# the CPU's own features, where that is more. The projection is of
# uncentred descriptors (as in the reference), so a coordinate with a
# large common offset and a small spread loses digits to cancellation: at
# the small configuration the LCS branch moves 1.5e-3 under it (CPU).
IMNET_TINY_FEAT_TOL = 1e-4
IMNET_EPS_PERTURB = 1e-7
IMNET_FLOOR_MARGIN = 4.0
LCS_TOL = 1e-5  # of max, LCS descriptors on the card against the CPU
# bench.py:538 bench_weighted (TIMIT's class count) and :580
# weighted_imagenet_problem (ImageNet's solver block and class count)
WEIGHTED_BENCH = {
    "bench_weighted": dict(seed=3, n=32_768, d=1024, c=147, num_iter=2, class_chunk=16),
    "weighted_imagenet": dict(seed=5, n=16_384, d=4096, c=1000, num_iter=1, class_chunk=64),
}
# reduced shapes that take each solve path, the card's weights against the CPU's
WEIGHTED_CHECKS = {
    "grid_woodbury": dict(seed=11, n=4096, d=512, c=32, num_iter=2, class_chunk=16),
    "grid_dense": dict(seed=12, n=4096, d=128, c=8, num_iter=2, class_chunk=4),
    "masked": dict(seed=13, n=2048, d=96, c=6, num_iter=1, class_chunk=4, dominant=0.85),
}
WEIGHTED_TOL = 1e-4  # of max|W| (intercepts: of max(max|W|, max|b|), as tests/test_torch_weighted.py)
# the weighted fit of a global batch against one process's fits. In
# float64 it is one process's fit of the same (masked) layout up to
# rounding, WEIGHTED_F64_TOL of max|W| (intercepts: of max(max|W|, max|b|));
# the float64 fits take class chunks of at most WEIGHTED_F64_CHUNK (memory;
# each class's system is its own, so the chunk changes no sum)
WEIGHTED_F64_TOL = 1e-10
WEIGHTED_F64_CHUNK = 16
# in float32, a fixed limit a shape on each of its distances from one
# process's float64, masked and grid fits: above what a sound f32 fit
# summed in another order reads at that shape, below what the same fit
# with TF32 Grams reads (the control, printed and checked each run)
WEIGHTED_GLOBAL_TOL = {"bench_weighted": 3e-4, "weighted_imagenet": 2e-3}


def imagenet_small_checks(device) -> dict:
    """Phase 32's small configuration, card against CPU: LCS descriptors;
    each branch's Fisher features from one set of CPU descriptors, the
    branch fitted on the CPU (writing the PCA and GMM artifacts) and
    loaded on the card, held to :data:`IMNET_TINY_FEAT_TOL` or to
    :data:`IMNET_FLOOR_MARGIN` times the CPU's own move under a
    :data:`IMNET_EPS_PERTURB` relative perturbation of the descriptors;
    and ``run`` on both (errors printed)."""
    import tempfile

    from keystone_tpu_torch.core.kernels import BUILD_DIR
    from keystone_tpu_torch.models import fisher_common
    from keystone_tpu_torch.models import imagenet_sift_lcs_fv as imnet
    from keystone_tpu_torch.ops.lcs import LCSExtractor

    conf = imnet.ImageNetConfig(**IMNET_TINY)
    images = torch.from_numpy(imnet._load(conf, "train")[0].images)
    lcs_err = _rel(LCSExtractor()(images.to(device) / 255.0).cpu(), LCSExtractor()(images / 255.0))
    _, _, sift_fn, lcs_fn = imnet._extractors(conf)
    gen = torch.Generator().manual_seed(0)
    branches = {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        for name, fn in (("sift", sift_fn), ("lcs", lcs_fn)):
            desc = fn(images)
            files = [os.path.join(tmp, f"{name}_{k}.csv") for k in ("pca", "m", "v", "w")]
            feats = {}
            for dev in ("cpu", device):
                branch = fisher_common.FisherBranch(
                    conf.desc_dim, conf.vocab_size, conf.num_pca_samples, conf.num_gmm_samples,
                    conf.seed, pca_file=files[0], gmm_files=tuple(files[1:]), device=dev)
                branch.fit(desc.to(dev), conf.chunk_size)
                feats[str(dev)] = branch.featurize(desc.to(dev), conf.chunk_size).cpu()
                if dev == "cpu":
                    nudged = desc * (1 + IMNET_EPS_PERTURB * torch.randn(desc.shape, generator=gen))
                    feats["nudged"] = branch.featurize(nudged, conf.chunk_size)
            floor = _rel(feats["nudged"], feats["cpu"])
            err = _rel(feats[str(device)], feats["cpu"])
            tol = max(IMNET_TINY_FEAT_TOL, IMNET_FLOOR_MARGIN * floor)
            branches[name] = {"max_rel_err": err, "eps_floor": floor, "tol": tol}
    tiny_cpu, tiny_card = imnet.run(conf, device="cpu"), imnet.run(conf, device="cuda")
    errors = {k: (tiny_card[k], tiny_cpu[k]) for k in ("train_top1_error", "test_top1_error",
                                                      "test_top5_error")}
    print(f"  small configuration: LCS card vs CPU {lcs_err:.3e} of max; Fisher features from "
          f"one set of descriptors and artifacts, card vs CPU (and the CPU's move under a "
          f"{IMNET_EPS_PERTURB:g} relative nudge of the descriptors) {branches}; errors "
          f"(card, CPU) {errors}")
    check(lcs_err <= LCS_TOL, f"LCS on the card differs from the CPU's by {lcs_err:.3e}")
    for name, b in branches.items():
        check(b["max_rel_err"] <= b["tol"], f"ImageNet {name} features differ by {b}")
    return {"lcs_max_rel_err": lcs_err, "fisher_features": branches, "errors_card_cpu": errors}


def phase_imagenet(device) -> dict:
    """Phase 32: ``imagenet_sift_lcs_fv`` at ``ImageNetConfig``'s widths.
    (a) ``run``, eager, on 1,024 + 256 synthetic images of 8 classes:
    top-1 error ≤ 5 %, the parts' seconds, samples/s, peak memory;
    (b) ``run_streaming`` with ``KEYSTONE_PLAN=1`` on 2,048 + 512 images
    of 1,000 classes, the solver at (D, C) = (4,096, 1,000): the
    planner's fit decisions, ``plan_featurize_passes_saved``, both
    errors. No hand kernel launches in either leg. Then a small
    configuration: LCS on the card against the CPU, the Fisher features
    from one set of descriptors and artifacts on both, and ``run`` on
    both."""
    from keystone_tpu_torch.models import imagenet_sift_lcs_fv as imnet
    from keystone_tpu_torch.observe import metrics
    from keystone_tpu_torch.ops import weighted_linear

    legs = {}
    for name, argv in (("eager", IMNET_ARGV), ("streaming_planned", IMNET_STREAM_ARGV)):
        planned = name == "streaming_planned"
        os.environ["KEYSTONE_PLAN"] = "1" if planned else "0"
        saved = metrics.get_registry().counter("plan_featurize_passes_saved")
        saved_before = saved.value
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        try:
            res = imnet.main(list(argv), device="cuda")
            torch.cuda.synchronize()
        finally:
            os.environ.pop("KEYSTONE_PLAN", None)
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        times = {k: round(v, 3) for k, v in res.items() if k.endswith("_s")}
        print(f"ImageNet SIFT+LCS FV {argv}: train top-1/top-5 error "
              f"{res['train_top1_error']:.4f}/{res['train_top5_error']:.4f}, test "
              f"{res['test_top1_error']:.4f}/{res['test_top5_error']:.4f}; seconds {times}; "
              f"{res['samples_per_s']:.1f} samples/s; peak memory {peak_gb:.2f} GiB; features "
              f"{res['num_features']}; launches {counts}")
        check(res["device"].startswith("cuda"), f"ImageNet ran on {res['device']}")
        check(res["num_features"] == IMNET_FEATURES, f"ImageNet features {res['num_features']}")
        check(not any(counts.values()), f"a hand kernel launched on the ImageNet path: {counts}")
        leg = {"run": _rows(res), "peak_mem_gib": peak_gb, "launches": counts}
        if planned:
            decisions = res["fit_decisions"]
            passes_saved = saved.value - saved_before
            print(f"  the planner's fit decisions: {decisions}; "
                  f"plan_featurize_passes_saved +{passes_saved}")
            check(passes_saved == 1, f"plan_featurize_passes_saved moved by {passes_saved}")
            check(any(d["action"] in ("fit_fallback", "fuse_fit") for d in decisions),
                  f"no fit decision recorded: {decisions}")
            state = weighted_linear.BlockWeightedLeastSquaresEstimator.fit_stats_state_bytes(
                IMNET_FEATURES, 1000)
            leg.update(fit_decisions=decisions, passes_saved=passes_saved,
                       state_gb=state / 1e9)
        else:
            check(res["test_top1_error"] <= IMNET_MAX_TOP1,
                  f"ImageNet test top-1 error {res['test_top1_error']}")
        legs[name] = leg

    return {"legs": legs, "tiny": imagenet_small_checks(device)}


def weighted_problem(seed, n, d, c, dominant=None, **_):
    """``bench.py``'s weighted-solver data (:538, :580): class centers plus
    unit noise, ±1 indicators; ``dominant`` puts that share of the rows in
    class 0 (the masked layout)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cls = rng.integers(0, c, size=n)
    if dominant is not None:
        cls[: int(dominant * n)] = 0
    centers = rng.normal(size=(c, d)).astype(np.float32)
    data = (centers[cls] + rng.normal(size=(n, d))).astype(np.float32)
    labels = -np.ones((n, c), np.float32)
    labels[np.arange(n), cls] = 1.0
    return torch.from_numpy(data), torch.from_numpy(labels), cls


def weighted_flops(n, d, c, num_iter, cls) -> float:
    """``bench.py``'s FLOP count of a weighted fit (:566-570, :607-611):
    the population and class Grams, the Woodbury prep and G, and a pass's
    residual products and per-class solves."""
    import numpy as np

    l_pad = max(-(-int(np.bincount(cls).max()) // 64) * 64, 64)
    lp1 = l_pad + 1
    setup = 2 * n * d * d * 2 + 2 * c * d * d * lp1 + 2 * c * d * lp1**2
    per_pass = 2 * n * d * c + 8 * c * d * d
    return setup + num_iter * per_pass


def weighted_estimator(shape: dict, dtype=torch.float32, precision: str | None = None):
    """The weighted solver as phase 33 fits ``shape`` (a float64 fit's
    class chunk at most ``WEIGHTED_F64_CHUNK``; ``precision`` the
    solver's own)."""
    from keystone_tpu_torch.ops import weighted_linear as wl

    chunk = shape["class_chunk"]
    if dtype == torch.float64:
        chunk = min(chunk, WEIGHTED_F64_CHUNK)
    return wl.BlockWeightedLeastSquaresEstimator(
        block_size=shape["d"], num_iter=shape["num_iter"], lam=1e-3, mixture_weight=0.5,
        class_chunk=chunk, precision=precision)


def weighted_references(device, name: str) -> dict:
    """``WEIGHTED_BENCH[name]``'s fits in one process on ``device``, each
    as (W, b) on the CPU: the grid fit phase 33 times (``grid``), the fit
    of the same rows as a global batch of one process (``masked``: the
    layout and solves a fit across processes takes), that fit in float64
    (``f64``: the yardstick of every f32 fit and the reference of a
    float64 fit across processes), and the control: the grid fit with
    TF32 products (the solver's ``precision="high"``), of which only its
    distance from ``f64`` is kept (``tf32_gap``; a fit that fails counts
    as infinitely far). Prints each fit's seconds (``fit_s``), the first
    call of each layout included."""
    from keystone_tpu_torch.parallel.multihost import GlobalRows

    shape = WEIGHTED_BENCH[name]
    x, y, _ = weighted_problem(**shape)
    est, est64 = weighted_estimator(shape), weighted_estimator(shape, torch.float64)
    xd, yd = x.to(device), y.to(device)
    out, secs = {}, {}
    for tag, fit in (("grid", lambda: est.fit(xd, yd)),
                     ("masked", lambda: est.fit(GlobalRows(xd, shape["n"], 0), yd)),
                     ("f64", lambda: est64.fit(GlobalRows(xd.double(), shape["n"], 0),
                                               yd.double()))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = fit()
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t0
        out[tag] = (torch.cat(list(model.xs)).double().cpu(), model.b.double().cpu())
        del model
        torch.cuda.empty_cache()
    print(f"  weighted {name}, one process: the grid fit {secs['grid']:.3f} s, the masked "
          f"fit {secs['masked']:.3f} s, the masked fit in float64 {secs['f64']:.3f} s")
    out["fit_s"] = secs
    try:
        model = weighted_estimator(shape, precision="high").fit(xd, yd)
        gap = weighted_gap(out["f64"], (torch.cat(list(model.xs)).cpu(), model.b.cpu()))
        out["tf32_gap"] = gap if math.isfinite(gap) else math.inf
        del model
    except torch.linalg.LinAlgError as e:
        print(f"  weighted {name}: the TF32 control's fit failed ({e})")
        out["tf32_gap"] = math.inf
    del xd, yd
    torch.cuda.empty_cache()
    return out


def weighted_gap(ref: tuple, got: tuple) -> float:
    """``got``'s distance from ``ref``: the weights' in max|W_ref|, the
    intercepts' in max(max|W_ref|, max|b_ref|), the larger of the two."""
    (w, b), (gw, gb) = ref, (got[0].double(), got[1].double())
    scale = float(w.abs().max())
    return max(float((gw - w).abs().max()) / scale,
               float((gb - b).abs().max()) / max(scale, float(b.abs().max())))


def check_weighted(label: str, name: str, refs: dict, got: tuple, got64: tuple) -> dict:
    """Hold a fit of ``WEIGHTED_BENCH[name]`` across processes to one
    process's fits (:func:`weighted_references`): its float64 fit
    (``got64``) within ``WEIGHTED_F64_TOL`` of one process's; its f32 fit
    (``got``) within ``WEIGHTED_GLOBAL_TOL[name]`` of one process's float64,
    masked and grid fits; the TF32 control beyond that limit. Prints every
    distance, one process's f32 fits' own from float64 among them."""
    tol = WEIGHTED_GLOBAL_TOL[name]
    f64 = weighted_gap(refs["f64"], got64)
    gaps = {"vs_f64": weighted_gap(refs["f64"], got),
            "vs_masked": weighted_gap(refs["masked"], got),
            "vs_grid": weighted_gap(refs["grid"], got)}
    sound = {tag: weighted_gap(refs["f64"], refs[tag]) for tag in ("grid", "masked")}
    print(f"  {label}: float64 fit {f64:.3e} from one process's (limit {WEIGHTED_F64_TOL:.0e}); "
          f"f32 fit from one process's float64 fit {gaps['vs_f64']:.3e}, masked fit "
          f"{gaps['vs_masked']:.3e}, grid fit {gaps['vs_grid']:.3e} (limit {tol:.0e}); one "
          f"process's f32 grid and masked fits {sound['grid']:.3e} and {sound['masked']:.3e} "
          f"from its float64 fit, its grid fit with TF32 Grams {refs['tf32_gap']:.3e}")
    check(f64 <= WEIGHTED_F64_TOL, f"{label}: float64 fit {f64:.3e} from one process's")
    for tag, gap in gaps.items():
        check(gap <= tol, f"{label}: f32 fit {tag} {gap:.3e} (limit {tol:.0e})")
    check(refs["tf32_gap"] > tol, f"{label}: the TF32 control reads {refs['tf32_gap']:.3e}, "
          f"within the limit {tol:.0e}")
    return {**gaps, "f64_vs_f64": f64, "grid_vs_f64": sound["grid"],
            "masked_vs_f64": sound["masked"], "tf32_vs_f64": refs["tf32_gap"], "limit": tol,
            "f64_limit": WEIGHTED_F64_TOL, "one_process_fit_s": refs["fit_s"]}


def phase_weighted(device) -> dict:
    """Phase 33: the weighted solver alone at ``bench_weighted``'s and
    ``weighted_imagenet_problem``'s shapes: fit s (one warm fit, then the
    mean of timed ones), TFLOP/s by ``bench.py``'s count, the path taken,
    the class-chunk count, peak memory; then the card's weights against
    the CPU's at reduced shapes that take each path."""
    from keystone_tpu_torch.ops import weighted_linear as wl

    out = {}
    for name, shape in WEIGHTED_BENCH.items():
        x, y, cls = weighted_problem(**shape)
        est = weighted_estimator(shape)
        path = wl.fit_path(est, y, shape["d"])
        xd, yd = x.to(device), y.to(device)
        del x, y
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        est.fit(xd, yd)
        fit_s = _wall(lambda: est.fit(xd, yd), 2)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        counts = _counts()
        flops = weighted_flops(shape["n"], shape["d"], shape["c"], shape["num_iter"], cls)
        print(f"weighted fit {name} (N {shape['n']}, D {shape['d']}, C {shape['c']}, "
              f"{shape['num_iter']} passes): {fit_s:.4f} s, {flops / fit_s / 1e12:.2f} TFLOP/s of "
              f"{flops / 1e12:.3f} TFLOP; path {path}; peak memory {peak_gb:.2f} GiB; "
              f"launches {counts}")
        check(not any(counts.values()), f"a hand kernel launched in the weighted fit: {counts}")
        out[name] = {**shape, "fit_s": fit_s, "tflop": flops / 1e12,
                     "tflops_per_s": flops / fit_s / 1e12, "path": path, "peak_mem_gib": peak_gb}
        del xd, yd

    checks = {}
    for name, shape in WEIGHTED_CHECKS.items():
        x, y, _ = weighted_problem(**shape)
        est = weighted_estimator(shape)
        path = wl.fit_path(est, y, shape["d"])
        want = est.fit(x, y)
        got = est.fit(x.to(device), y.to(device))
        x_w, x_g = torch.cat(want.xs), torch.cat(got.xs).cpu()
        scale = float(x_w.abs().max())
        err = float((x_g - x_w).abs().max()) / scale
        b_err = float((got.b.cpu() - want.b).abs().max()) / max(scale, float(want.b.abs().max()))
        checks[name] = {"path": path, "max_rel_err": err, "intercept_max_rel_err": b_err}
        print(f"  weighted {name} {path}: card vs CPU weights {err:.3e} of max|W|, intercepts "
              f"{b_err:.3e} of max(max|W|, max|b|)")
        err = max(err, b_err)
        check(err <= WEIGHTED_TOL, f"weighted {name}: the card's weights differ by {err:.3e}")
    check({c["path"]["layout"] for c in checks.values()} == {"grid", "masked"}
          and {b["solve"] for c in checks.values() for b in c["path"]["blocks"]}
          >= {"woodbury", "dense_hoisted"}, f"the checks missed a path: {checks}")
    return {"bench": out, "card_vs_cpu": checks}


# --- phases 34-36: native host code, online learning, checkpoint and resume ------
NATIVE_CSV_ROWS = 5_000  # MNIST-shaped rows: a label and 784 pixel values
NATIVE_CIFAR_RECORDS = 10_000  # one CIFAR-10 batch file
NATIVE_SIFT_N, NATIVE_SIFT_HW = 4, 256
NATIVE_GMM = dict(n=20_000, d=32, k=16, iters=10)
NATIVE_FISHER_N, NATIVE_FISHER_M = 16, 1_000
# tests/test_torch_native.py: native against the device paths
NATIVE_EM_ATOL, NATIVE_W_ATOL, NATIVE_FV_ATOL = 1e-3, 1e-4, 5e-4

REFIT_BOOT_ROWS = 40_000
REFIT_CHUNK_ROWS, REFIT_CHUNKS = 5_000, 4
REFIT_THREADS = 6
REFIT_FP32_TOL = 1e-5  # of max|W|: the fp32 fold against one fit over the union
REFIT_UNION_CHUNKS = (8192, 5000, 2048)  # row groupings of the fp32 union fits
REFIT_SERVE_TOL = 1e-5  # of max|score|: served scores against the folded model, eager
SHADOW_REQUESTS, SHADOW_MIN_SAMPLES = 24, 20

RESUME_STEPS, RESUME_EVERY = 8, 4
RESUME_PREEMPT_AT, RESUME_SIGTERM_AT = 4, 2  # fault keys: the step index they follow
TIMIT_CKPT_ARGV = ["--synthetic", "32768"] + TIMIT_BANK + ["--checkpoint-every", "1"]
TIMIT_CKPT_CRASH_EPOCHS = 2


def _host_ms(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def phase_native(device) -> dict:
    """Phase 34: the host C++ paths built from the repository's sources —
    the CSV and CIFAR readers against their numpy paths, native dense SIFT
    against the card's, the native EM and Fisher vectors against the
    card's ``ops/gmm`` from one start — each timed on the host."""
    import tempfile

    import numpy as np

    from keystone_tpu_torch import native
    from keystone_tpu_torch.core.kernels import BUILD_DIR
    from keystone_tpu_torch.loaders import cifar
    from keystone_tpu_torch.native import enceval
    from keystone_tpu_torch.ops import gmm, sift

    _zero_counts()
    t0 = time.perf_counter()
    native.require_lib()
    enceval.ENCEVAL_LIB.require()
    res: dict = {"build_s": time.perf_counter() - t0,
                 "openmp": {"io": native.IO_LIB.openmp, "enceval": enceval.ENCEVAL_LIB.openmp}}
    print(f"native: host libraries built in {res['build_s']:.1f} s, OpenMP {res['openmp']}")
    rng = np.random.default_rng(34)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        mat = np.concatenate([rng.integers(1, 11, (NATIVE_CSV_ROWS, 1)),
                              rng.integers(0, 256, (NATIVE_CSV_ROWS, 784))], axis=1)
        path = os.path.join(tmp, "mnist.csv")
        np.savetxt(path, mat, fmt="%d", delimiter=",")
        got, nat_ms = _host_ms(lambda: native.native_load_csv(path))
        want, np_ms = _host_ms(lambda: np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2))
        check(got is not None and np.array_equal(got, want), "native CSV differs from np.loadtxt")
        res["csv"] = {"rows": NATIVE_CSV_ROWS, "native_ms": nat_ms, "numpy_ms": np_ms}
        recs = rng.integers(0, 256, (NATIVE_CIFAR_RECORDS, cifar.RECORD)).astype(np.uint8)
        recs[:, 0] = rng.integers(0, 10, NATIVE_CIFAR_RECORDS)
        path = os.path.join(tmp, "data_batch_1.bin")
        recs.tofile(path)
        got, nat_ms = _host_ms(lambda: native.native_load_cifar(path))
        want, np_ms = _host_ms(lambda: cifar._read_numpy(path))
        check(got is not None and all(np.array_equal(g, w) for g, w in zip(got, want)),
              "native CIFAR differs from the numpy reader")
        res["cifar"] = {"records": NATIVE_CIFAR_RECORDS, "native_ms": nat_ms, "numpy_ms": np_ms}
    print(f"native: CSV {res['csv']['native_ms']:.1f} ms against numpy "
          f"{res['csv']['numpy_ms']:.1f}; CIFAR {res['cifar']['native_ms']:.1f} ms against "
          f"{res['cifar']['numpy_ms']:.1f} (equal)")

    imgs = torch.from_numpy(rng.random((NATIVE_SIFT_N, NATIVE_SIFT_HW, NATIVE_SIFT_HW))
                            .astype(np.float32)).to(device)
    on_card = sift.SIFTExtractor()(imgs)
    torch.cuda.synchronize()
    ext = sift.SIFTExtractor(backend="native")
    host, sift_ms = _host_ms(lambda: ext(imgs))
    check(host.device == imgs.device, "native SIFT did not return on the caller's device")
    diff = (host - on_card).abs()
    equal = float((diff == 0).float().mean())
    print(f"native SIFT {tuple(host.shape)}: {sift_ms:.1f} host ms (card "
          f"{time_ms(lambda: sift.SIFTExtractor()(imgs), reps=2, rounds=1):.2f} ms), max "
          f"|native-card| {float(diff.max()):.0f}, {equal:.5%} equal")
    check(float(diff.max()) <= 1.0 and equal >= SIFT_MIN_EQUAL,
          f"native SIFT against the card's: max {float(diff.max())}, {equal:.5%} equal")
    res["sift"] = {"shape": list(host.shape), "host_ms": sift_ms, "equal": equal,
                   "max_abs": float(diff.max())}
    del imgs, on_card, host, diff

    g = NATIVE_GMM
    centers = rng.normal(scale=4, size=(g["k"], g["d"]))
    x = (centers[rng.integers(0, g["k"], g["n"])] + rng.normal(size=(g["n"], g["d"]))
         ).astype(np.float32)
    xc = torch.from_numpy(x).to(device)
    start = gmm.gmm_init(xc, g["k"], 42, gmm.VAR_FLOOR)
    card_fit = gmm.gmm_em(xc, *start, g["iters"])
    torch.cuda.synchronize()
    (mu, var, w), em_ms = _host_ms(lambda: enceval.gmm_em(
        x, g["k"], g["iters"], init=tuple(t.cpu() for t in start)))
    errs = [float((torch.from_numpy(h) - c.cpu()).abs().max())
            for h, c in zip((mu, var, w), card_fit)]
    batch = torch.from_numpy(rng.normal(size=(NATIVE_FISHER_N, g["d"], NATIVE_FISHER_M))
                             .astype(np.float32) * 3).to(device)
    model = gmm.GaussianMixtureModel(means=card_fit[0], variances=card_fit[1],
                                     weights=card_fit[2])
    fv_card = gmm.fisher_vectors(batch, model)
    fv_host, fv_ms = _host_ms(lambda: gmm.FisherVector(gmm=model, backend="native")(batch))
    fv_err = float((fv_host - fv_card).abs().max())
    print(f"native EM {g['iters']} iterations on {g['n']} x {g['d']} at k {g['k']}: "
          f"{em_ms:.1f} host ms, |native-card| means {errs[0]:.2e} variances {errs[1]:.2e} "
          f"weights {errs[2]:.2e}; Fisher ({NATIVE_FISHER_N}, {g['d']}, {NATIVE_FISHER_M}): "
          f"{fv_ms:.1f} host ms, |native-card| {fv_err:.2e}")
    check(errs[0] <= NATIVE_EM_ATOL and errs[1] <= NATIVE_EM_ATOL and errs[2] <= NATIVE_W_ATOL,
          f"native EM against the card's: {errs}")
    check(fv_err <= NATIVE_FV_ATOL, f"native Fisher vectors against the card's: {fv_err}")
    res["gmm_em"] = {**g, "host_ms": em_ms, "max_abs": dict(zip(("means", "variances",
                                                                  "weights"), errs))}
    res["fisher"] = {"shape": [NATIVE_FISHER_N, g["d"], NATIVE_FISHER_M], "host_ms": fv_ms,
                     "max_abs": fv_err}
    launched = {k: v for k, v in _counts().items() if v}
    check(not launched, f"phase 34 launched hand kernels: {launched}")
    return res


def _write_chunk(path: str, data, labels) -> None:
    """A labeled chunk as the refit daemon's producers drop it: a temp
    name, then a rename."""
    import numpy as np

    tmp = path + ".partial"
    with open(tmp, "wb") as f:
        np.savez(f, data=data, labels=labels)
    os.replace(tmp, path)


def _hammer(url: str, rows, threads: int):
    """``threads`` clients POSTing /predict of 1–40 rows until stopped:
    (stop event, answers list of (status, payload, s), errors list,
    threads)."""
    import threading

    import numpy as np

    stop, answers, errors = threading.Event(), [], []

    def client(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            a = int(r.integers(0, len(rows) - 40))
            n = int(r.integers(1, 41))
            try:
                status, payload, sec = _http(url + "/predict", {"rows": rows[a:a + n].tolist()})
                if status != 200 or len(payload["predictions"]) != n:
                    errors.append(f"status {status}, {len(payload['predictions'])} rows for {n}")
                answers.append((status, None, sec))
            except Exception as e:  # noqa: BLE001 — every client failure is counted
                errors.append(repr(e))

    ts = [threading.Thread(target=client, args=(s,), daemon=True) for s in range(threads)]
    for t in ts:
        t.start()
    return stop, answers, errors, ts


def _time_folds(daemon) -> list:
    """Time each of ``daemon``'s chunk folds (ms, the device synchronized
    on both sides) into the list returned."""
    fold_ms: list = []
    raw_fold = daemon.fold

    def timed_fold(fname):
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = raw_fold(fname)
        torch.cuda.synchronize()
        fold_ms.append((time.perf_counter() - t) * 1e3)
        return n

    daemon.fold = timed_fold
    return fold_ms


def _wait_swaps(app, url: str, n: int, timeout: float = 120.0) -> dict:
    """/healthz once the app's swapper has returned its ``n``-th swap."""
    deadline = time.monotonic() + timeout
    while (app.swapper.last or {}).get("swaps", 0) < n and time.monotonic() < deadline:
        time.sleep(0.05)
    return _http(url + "/healthz")[1]


def phase_refit(device) -> dict:
    """Phase 35: the online-learning loop at the main path's width (MNIST
    random-FFT, ``num_ffts`` 32, D = 16,384, the int8 Gram forced):
    ``bootstrap_state`` on 40,000 rows, ``serve.server`` on the saved
    checkpoint over HTTP, ``RefitDaemon.run_once`` folding four chunks of
    5,000 rows and publishing, ``/admin/reload`` (the daemon's notify) and
    SIGHUP swapping while six threads hammer ``/predict``; the folded
    state against a fresh ``fit_stream`` of the same chunks, an fp32 leg
    against one fit over the union, K1's launches and first launch, and
    the shadow gate (409 for negated labels, 200 for a clean candidate)."""
    import signal
    import tempfile
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np

    from keystone_tpu_torch.core.config import parse_config
    from keystone_tpu_torch.core.kernels import BUILD_DIR
    from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator, Pipeline
    from keystone_tpu_torch.core.serialization import load_fitted, save_fitted
    from keystone_tpu_torch.learn import refit
    from keystone_tpu_torch.learn.merge import load_fit_state
    from keystone_tpu_torch.models import mnist_random_fft as m
    from keystone_tpu_torch.ops import gram
    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator, NormalEqState
    from keystone_tpu_torch.ops.util import ClassLabelIndicators
    from keystone_tpu_torch.plan import fit_stream, plan_fit
    from keystone_tpu_torch.plan.fused_fit import _DEFAULT_FIT_CHUNK
    from keystone_tpu_torch.serve import server

    conf = parse_config(m.MnistRandomFFTConfig, MAIN_ARGV)
    train, test = m._load(conf, "train"), m._load(conf, "test")
    x = train.data
    y = ClassLabelIndicators(num_classes=m.NUM_CLASSES)(train.labels).numpy()
    nb, nc = REFIT_BOOT_ROWS, REFIT_CHUNK_ROWS
    chunks = [(x[nb + i * nc: nb + (i + 1) * nc], y[nb + i * nc: nb + (i + 1) * nc])
              for i in range(REFIT_CHUNKS)]
    bank = m.FeaturizerBank.create(conf.num_ffts, conf.block_size, conf.seed, x.shape[-1], device)
    est = BlockLeastSquaresEstimator(block_size=conf.block_size, lam=conf.lam)
    chain = ChainedLabelEstimator(prefix=bank, est=est)
    probe_rows = test.data[:32]
    res: dict = {"bootstrap_rows": nb, "chunk_rows": nc, "chunks": REFIT_CHUNKS}
    os.makedirs(BUILD_DIR, exist_ok=True)
    prev_gram = os.environ.get("KEYSTONE_GRAM_OP")
    os.environ["KEYSTONE_GRAM_OP"] = "int8"
    prev_hup = None
    first_q: list = []
    raw_int8_gram = gram.int8_gram

    def recording_int8_gram(q):
        if not first_q:
            first_q.append(q.clone())
        return raw_int8_gram(q)

    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        state_path = os.path.join(tmp, "state.ksts")
        watch, out = os.path.join(tmp, "chunks"), os.path.join(tmp, "models")
        os.makedirs(watch)
        os.makedirs(out)
        # ---- the main path: counts from 0 -------------------------------
        _zero_counts()
        gram.int8_gram = recording_int8_gram
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe0, _ = refit.bootstrap_state(chain, torch.from_numpy(x[:nb]),
                                             torch.from_numpy(y[:nb]), state_path, device=device)
            torch.cuda.synchronize()
            res["bootstrap_s"] = time.perf_counter() - t0
            boot_launches = gram.INT8_GRAM.launches
            current = os.path.join(out, refit.CURRENT_MODEL)
            save_fitted(pipe0, current, version=0, sample=x[:1])
            t0 = time.perf_counter()
            app = server.build_app(current, {}, device=device)
            res["serve_build_s"] = time.perf_counter() - t0
            httpd = ThreadingHTTPServer(("127.0.0.1", 0), server._handler_for(app))
            serve_thread = threading.Thread(target=httpd.serve_forever,
                                            kwargs={"poll_interval": 0.05}, daemon=True)
            serve_thread.start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            prev_hup = server.install_reload_signal(app)
            for i, (a, b) in enumerate(chunks):
                _write_chunk(os.path.join(watch, f"chunk_{i:04d}.npz"), a, b)
            boot_scores = pipe0(torch.from_numpy(probe_rows).to(device))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem_before = torch.cuda.memory_allocated()
            stop, answers, errors, clients = _hammer(url, test.data, REFIT_THREADS)
            t_burst = time.perf_counter()
            time.sleep(0.5)
            daemon = refit.RefitDaemon(state_path, watch, out_dir=out, notify_url=url,
                                       device=device)
            fold_ms = _time_folds(daemon)
            summary = daemon.run_once()
            fold_launches = gram.INT8_GRAM.launches - boot_launches
            reload_swap = dict(app.swapper.last or {})
            health = _wait_swaps(app, url, 1)
            os.kill(os.getpid(), signal.SIGHUP)
            health = _wait_swaps(app, url, 2)
            hup_swap = dict(app.swapper.last or {})
            time.sleep(0.5)
            stop.set()
            for t in clients:
                t.join(timeout=120)
            burst_wall = time.perf_counter() - t_burst
            peak = torch.cuda.max_memory_allocated()
        finally:
            gram.int8_gram = raw_int8_gram
        launches = _counts()
        # ---- checks and the replays (their launches do not count) ------
        check(not any(t.is_alive() for t in clients), "refit: a client never returned")
        check(summary["chunks_folded"] == REFIT_CHUNKS and summary["version"] == 1,
              f"refit: run_once {summary}")
        check(health["model_swaps"] == 2 and health["model_version"] == "1",
              f"refit: /healthz after the reload and SIGHUP {health}")
        check(not errors, f"refit: {len(errors)} client errors across the swaps: {errors[:3]}")
        n_boot_chunks = -(-nb // _DEFAULT_FIT_CHUNK)
        print(f"K1 launches on the refit path: bootstrap {boot_launches} for {n_boot_chunks} "
              f"fit chunks, folds {fold_launches} for {REFIT_CHUNKS} chunks of {nc}")
        check(boot_launches == n_boot_chunks and fold_launches == REFIT_CHUNKS,
              f"refit: K1 launched {boot_launches} + {fold_launches} times")
        check(launches["int8_gram"] == boot_launches + fold_launches and not any(
            v for k, v in launches.items() if k != "int8_gram"), f"refit: launches {launches}")
        res["k1_first_chunk"] = k1_at_chunk(first_q[0], "refit bootstrap")
        res["launches"] = {"bootstrap": boot_launches, "folds": fold_launches}

        served = np.asarray(_http(url + "/predict", {"rows": probe_rows.tolist()})[1]
                            ["predictions"], np.float32)
        folded = load_fitted(current, device=device)
        local = folded(torch.from_numpy(probe_rows).to(device)).cpu().numpy()
        scale = float(np.abs(local).max())
        vs_folded = float(np.abs(served - local).max()) / scale
        vs_boot = float(np.abs(served - boot_scores.cpu().numpy()).max()) / scale
        print(f"served scores after the fold: {vs_folded:.2e} of max|score| from the folded "
              f"model eager, {vs_boot:.2e} from the bootstrap model")
        check(vs_folded <= REFIT_SERVE_TOL and vs_boot > 10 * max(vs_folded, REFIT_SERVE_TOL),
              "refit: the served predictions do not come from the folded state")

        plan_b = plan_fit(chain, torch.from_numpy(x[:nb]), torch.from_numpy(y[:nb]), device=device)
        fresh = fit_stream(plan_b, torch.from_numpy(x[:nb]), torch.from_numpy(y[:nb]))
        plan_f = plan_fit(ChainedLabelEstimator(prefix=Pipeline(nodes=(bank,)), est=est), x[:1],
                          np.zeros((1, m.NUM_CLASSES), np.float32), device=device,
                          chunk_size=_DEFAULT_FIT_CHUNK, gram="int8")
        for a, b in chunks:
            fresh = fit_stream(plan_f, a, b, init_state=fresh)
        on_disk = load_fit_state(state_path, device=device).state
        fields = ("ata", "atb", "mean_a", "mean_b", "n")
        same = all(torch.equal(getattr(daemon.state, f), getattr(fresh, f)) and
                   torch.equal(getattr(on_disk, f), getattr(fresh, f)) for f in fields)
        print(f"folded int8 state (and its file) bit for bit a fresh fit_stream of the same "
              f"chunks: {same}")
        check(same, "refit: the folded int8 state is not a fresh fit_stream of the same chunks")

        # ---- shadow: a negated-labels candidate refused, a clean one promoted
        s = daemon.state
        neg = NormalEqState(ata=s.ata, atb=-s.atb, mean_a=s.mean_a, mean_b=-s.mean_b, n=s.n)
        neg_path, clean_path = os.path.join(tmp, "negated.kst"), os.path.join(tmp, "clean.kst")
        save_fitted(Pipeline.of(bank, est.fit_stats_finalize(neg, widths=plan_f.fit.widths)),
                    neg_path, version="negated", sample=x[:1])
        save_fitted(folded, clean_path, version="clean", sample=x[:1])
        shadow: dict = {}
        for name, path in (("negated", neg_path), ("clean", clean_path)):
            _http(url + "/admin/shadow", {"path": path, "sample_every": 1,
                                          "min_samples": SHADOW_MIN_SAMPLES})
            for i in range(SHADOW_REQUESTS):
                _http(url + "/predict", {"rows": test.data[8 * i: 8 * i + 8].tolist()})
            try:
                status, verdict, _ = _http(url + "/admin/promote", {})
            except Exception as e:  # noqa: BLE001 — a refusal answers 409
                status, verdict = getattr(e, "code", None), json.loads(e.read())
            shadow[name] = {"status": status, **{k: verdict.get(k) for k in (
                "samples", "mean_divergence", "promote", "promoted")}}
        print(f"shadow: negated {shadow['negated']}, clean {shadow['clean']}")
        check(shadow["negated"]["status"] == 409 and shadow["clean"]["status"] == 200,
              f"refit: shadow promote answered {shadow}")
        health = _http(url + "/healthz")[1]
        check(health["model_swaps"] == 3 and health["model_version"] == "clean",
              f"refit: /healthz after the promotion {health}")
        httpd.shutdown()
        httpd.server_close()
        app.shutdown()
        signal.signal(signal.SIGHUP, prev_hup)

        # ---- the fp32 leg: the published weights against a union fit ---
        os.environ["KEYSTONE_GRAM_OP"] = "fp32"
        before = gram.INT8_GRAM.launches
        state32, out32 = os.path.join(tmp, "state32.ksts"), os.path.join(tmp, "models32")
        refit.bootstrap_state(chain, torch.from_numpy(x[:nb]), torch.from_numpy(y[:nb]),
                              state32, device=device)
        d32 = refit.RefitDaemon(state32, watch, out_dir=out32, device=device)
        fold32_ms = _time_folds(d32)
        s32 = d32.run_once()
        w_fold = torch.cat(list(load_fitted(s32["model"], device=device).nodes[-1].xs)).double()
        n_union = nb + REFIT_CHUNKS * nc
        xu, yu = torch.from_numpy(x[:n_union]), torch.from_numpy(y[:n_union])
        w_union = {}
        for ch in REFIT_UNION_CHUNKS:
            plan_u = plan_fit(chain, xu, yu, device=device, chunk_size=ch)
            w_union[ch] = torch.cat(list(est.fit_stats_finalize(
                fit_stream(plan_u, xu, yu), widths=plan_u.fit.widths).xs)).double()
        w64 = _f64_union_fit(bank, est, xu, yu, plan_u.fit.widths, device)
        scale = float(w64.abs().max())
        fp32_err = float((w_fold - w_union[REFIT_UNION_CHUNKS[0]]).abs().max()
                         / w_union[REFIT_UNION_CHUNKS[0]].abs().max())
        fold_exact = float((w_fold - w64).abs().max()) / scale
        union_exact = {ch: float((w - w64).abs().max()) / scale for ch, w in w_union.items()}
        print(f"fp32 leg: folded-then-published weights within {fp32_err:.2e} of max|W| of one "
              f"fit over the union ({n_union} rows, chunks of {REFIT_UNION_CHUNKS[0]}); from the "
              f"f64 fit of the union: the fold {fold_exact:.2e}, fp32 union fits by chunk size "
              f"{union_exact}")
        check(gram.INT8_GRAM.launches == before, "refit: K1 launched in the fp32 leg")
        # 1e-5 of max|W| is under f32's floor at this width and λ: the fp32
        # union fits lie 2.9e-4 to 7.9e-4 of max|W| from the f64 fit by row
        # grouping alone (this phase's H100 run), so the fold is held to the
        # fp32 union fits' own distance from the f64 fit
        floor = max(REFIT_FP32_TOL, max(union_exact.values()))
        check(fold_exact <= floor, f"refit: the fp32 fold is {fold_exact:.2e} from the f64 "
                                   f"union fit, the fp32 union fits {union_exact}")
    if prev_gram is None:
        os.environ.pop("KEYSTONE_GRAM_OP", None)
    else:
        os.environ["KEYSTONE_GRAM_OP"] = prev_gram

    lat = _latency(answers, burst_wall)
    pub = daemon.last_publish
    res.update(
        fold_ms=fold_ms, fold_ms_fp32_no_http_load=fold32_ms, publish=pub,
        state_bytes=pub["state_bytes"],
        swaps={"reload": reload_swap, "sighup": hup_swap}, burst=lat,
        client_errors=len(errors), model_swaps=3, peak_memory_gib=peak / 2**30,
        memory_before_gib=mem_before / 2**30, served_vs_folded=vs_folded,
        served_vs_bootstrap=vs_boot, folded_state_bit_for_bit=same, fp32_vs_union=fp32_err,
        fp32_vs_f64_union={"fold": fold_exact, "union_by_chunk": union_exact},
        shadow=shadow,
    )
    print(f"refit: fold ms a chunk {[round(t, 1) for t in fold_ms]} under the HTTP burst (the "
          f"fp32 leg's, with no clients: {[round(t, 1) for t in fold32_ms]}); publish "
          f"{pub['wall_s']:.3f} s (finalize {pub['finalize_s']:.3f}, model write "
          f"{pub['model_write_s']:.3f}, state write {pub['state_write_s']:.3f}); state "
          f"{pub['state_bytes']} bytes; swaps: reload {reload_swap}, SIGHUP {hup_swap}; "
          f"{lat['requests']} requests, {lat['requests_per_s']:.1f}/s, p99 "
          f"{lat['p99_ms']:.1f} ms, 0 errors; peak {peak / 2**30:.2f} GiB "
          f"(before the swaps {mem_before / 2**30:.2f})")
    return res


def _f64_union_fit(bank, est, x, y, widths, device):
    """The union's weights from f64 statistics of the same features (each
    fit chunk featurized in f32 as the fit does, then widened), the same
    Gram-form finalize in f64: the reference an fp32 fit is measured
    against."""
    from keystone_tpu_torch.ops.linear import NormalEqState

    n, d = x.shape[0], sum(widths)
    f64 = dict(dtype=torch.float64, device=device)
    sa, sb = torch.zeros(d, **f64), torch.zeros(y.shape[1], **f64)
    gaa, gab = torch.zeros(d, d, **f64), torch.zeros(d, y.shape[1], **f64)
    for a in range(0, n, 8192):
        f = torch.cat(bank(x[a:a + 8192].to(device)), -1).double()
        b = y[a:a + 8192].to(device).double()
        sa += f.sum(0)
        sb += b.sum(0)
        gaa += f.T @ f
        gab += f.T @ b
        del f
    mu_a, mu_b = sa / n, sb / n
    state = NormalEqState(ata=gaa - n * torch.outer(mu_a, mu_a),
                          atb=gab - n * torch.outer(mu_a, mu_b), mean_a=mu_a, mean_b=mu_b,
                          n=torch.tensor(float(n), **f64))
    return torch.cat(list(est.fit_stats_finalize(state, widths=widths).xs))


def _resume_model(device):
    """The flagship train model as ``lm_transformer.main`` builds it from
    ``TRAIN_ARGV`` (seed 0)."""
    from keystone_tpu_torch.models.lm.model import TransformerLM

    return TransformerLM.create(
        vocab=TRAIN_CONF["vocab"], max_seq=TRAIN_SEQ, dim=TRAIN_CONF["dim"],
        depth=TRAIN_CONF["depth"], num_heads=TRAIN_CONF["num_heads"],
        compute_dtype="bfloat16", device=device,
        generator=torch.Generator(device=device).manual_seed(0),
    )


def _leaves_diff(a_dir: str, b_dir: str) -> float:
    from keystone_tpu_torch.core.checkpoint import read_step

    a, sa = read_step(a_dir)
    b, sb = read_step(b_dir)
    check(sa == sb == RESUME_STEPS, f"resume: final steps {sa}, {sb}")
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
               for x, y in zip(a, b))


def phase_resume(device) -> dict:
    """Phase 36: checkpoint and resume. (a) LM training at the flagship
    width (seq 2,048, batch 8, bf16, AdamW 3e-4), 8 steps with a checkpoint
    every 4: uninterrupted; preempted by ``train.preempt`` after step 5 and
    resumed; stopped by a real SIGTERM (``train.sigterm``) in a
    ``lm_transformer`` subprocess and resumed here — losses and the final
    checkpoint's leaves against the uninterrupted run's. (b) TIMIT's
    classic fit at phase 22's configuration with ``--checkpoint-dir
    --checkpoint-every 1``: a 2-epoch run, then the 5-epoch run on its
    directory, against an uninterrupted 5-epoch run."""
    import tempfile

    from keystone_tpu_torch.core.checkpoint import read_step
    from keystone_tpu_torch.core.kernels import BUILD_DIR
    from keystone_tpu_torch.models import timit_pipeline
    from keystone_tpu_torch.models.lm.train import synthetic_corpus, train
    from keystone_tpu_torch.observe import metrics
    from keystone_tpu_torch.resilience import faults

    reg = metrics.get_registry()
    corpus = synthetic_corpus(200_000, TRAIN_CONF["vocab"], seed=0)
    kw = dict(steps=RESUME_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, seed=0,
              checkpoint_every=RESUME_EVERY)
    res: dict = {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("whole", "preempt", "sigterm", "whole2")}
        saves_before = (reg.snapshot().get("ckpt_save_seconds") or {}).get("count", 0)
        t0 = time.perf_counter()
        _, whole = train(_resume_model(device), corpus, checkpoint_dir=dirs["whole"], **kw)
        torch.cuda.synchronize()
        res["uninterrupted_s"] = time.perf_counter() - t0
        faults.configure(f"train.preempt:@{RESUME_PREEMPT_AT}:0")
        try:
            train(_resume_model(device), corpus, checkpoint_dir=dirs["preempt"], **kw)
            check(False, "resume: train.preempt did not fire")
        except faults.SimulatedPreemption:
            pass
        finally:
            faults.reset()
        done_p = read_step(dirs["preempt"])[1]
        t0 = time.perf_counter()
        _, tail_p = train(_resume_model(device), corpus, checkpoint_dir=dirs["preempt"], **kw)
        res["resume_s"] = time.perf_counter() - t0
        argv = [a for a in TRAIN_ARGV]
        argv[argv.index("--steps") + 1] = str(RESUME_STEPS)
        here = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ, "KEYSTONE_FAULTS": f"train.sigterm:@{RESUME_SIGTERM_AT}:0",
               "PYTHONPATH": os.pathsep.join(filter(None, [here, os.environ.get("PYTHONPATH")]))}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "keystone_tpu_torch.models.lm_transformer", *argv,
             "--checkpoint-dir", dirs["sigterm"], "--checkpoint-every", str(RESUME_EVERY)],
            env=env, capture_output=True, text=True, timeout=600, cwd=here,
        )
        res["sigterm_subprocess_s"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"resume: the SIGTERM subprocess exited {proc.returncode}:\n"
                                    f"{proc.stderr[-3000:]}")
        done_s = read_step(dirs["sigterm"])[1]
        _, tail_s = train(_resume_model(device), corpus, checkpoint_dir=dirs["sigterm"], **kw)
        snap = reg.snapshot()
        saves = snap.get("ckpt_save_seconds") or {}
        res["checkpoint"] = {"saves": saves.get("count", 0) - saves_before,
                             "save_mean_s": saves.get("mean_s"),
                             "save_p50_s": saves.get("p50_s"),
                             "bytes": snap.get("ckpt_save_bytes")}
        print(f"resume: preempted after step {done_p}, SIGTERM stopped after step {done_s}; "
              f"losses {whole}; resumed tails {tail_p}, {tail_s}; checkpoint "
              f"{res['checkpoint']}")
        check(done_p == RESUME_PREEMPT_AT + 1 and done_s == RESUME_SIGTERM_AT + 1,
              f"resume: checkpoints at {done_p}, {done_s}")
        diffs = {"preempt": _leaves_diff(dirs["whole"], dirs["preempt"]),
                 "sigterm": _leaves_diff(dirs["whole"], dirs["sigterm"])}
        loss_diffs = {"preempt": max(abs(a - b) for a, b in zip(tail_p, whole[done_p:])),
                      "sigterm": max(abs(a - b) for a, b in zip(tail_s, whole[done_s:]))}
        exact = all(v == 0 for v in diffs.values()) and all(v == 0 for v in loss_diffs.values())
        res.update(losses=whole, resumed_losses={"preempt": tail_p, "sigterm": tail_s},
                   leaf_max_abs_diff=diffs, loss_max_abs_diff=loss_diffs, bit_for_bit=exact)
        if not exact:
            # measure what two uninterrupted runs differ by, and hold the
            # resumed runs to it
            _, whole2 = train(_resume_model(device), corpus, checkpoint_dir=dirs["whole2"], **kw)
            rr = _leaves_diff(dirs["whole"], dirs["whole2"])
            rr_loss = max(abs(a - b) for a, b in zip(whole, whole2))
            res["run_to_run"] = {"leaf_max_abs_diff": rr, "loss_max_abs_diff": rr_loss}
            print(f"resume: not bit for bit ({diffs}, losses {loss_diffs}); two uninterrupted "
                  f"runs differ by {rr:.3e} (losses {rr_loss:.3e})")
            check(max(diffs.values()) <= rr and max(loss_diffs.values()) <= rr_loss,
                  "resume: the resumed runs differ by more than two uninterrupted runs")
        else:
            print("resume: the preempted and the SIGTERM runs resumed bit for bit "
                  "(losses and every parameter and optimizer leaf)")
        torch.cuda.empty_cache()

        # ---- (b) TIMIT's classic fit, interrupted after 2 of 5 epochs ----
        t_dirs = {k: os.path.join(tmp, f"timit_{k}") for k in ("whole", "crash")}
        timed = {}
        t0 = time.perf_counter()
        r_whole = timit_pipeline.main(TIMIT_CKPT_ARGV + ["--checkpoint-dir", t_dirs["whole"]],
                                      device=device)
        timed["uninterrupted_s"] = time.perf_counter() - t0
        crash = [a for a in TIMIT_CKPT_ARGV]
        crash[crash.index("--num-epochs") + 1] = str(TIMIT_CKPT_CRASH_EPOCHS)
        t0 = time.perf_counter()
        timit_pipeline.main(crash + ["--checkpoint-dir", t_dirs["crash"]], device=device)
        timed["two_epochs_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r_resumed = timit_pipeline.main(TIMIT_CKPT_ARGV + ["--checkpoint-dir", t_dirs["crash"]],
                                        device=device)
        timed["resumed_s"] = time.perf_counter() - t0
        a, sa = read_step(t_dirs["whole"])
        b, sb = read_step(t_dirs["crash"])
        t_diff = max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))
        same_preds = bool((r_whole["test_predictions"] == r_resumed["test_predictions"]).all())
        print(f"TIMIT resume: steps {sa}, {sb}; max|resumed-uninterrupted| {t_diff:.3e}; test "
              f"predictions equal {same_preds}; test error {r_resumed['test_error']:.4%}; {timed}")
        check(sa == sb == 5 and t_diff == 0 and same_preds,
              "resume: TIMIT's resumed fit is not the uninterrupted one bit for bit")
        check(r_resumed["test_error"] <= TIMIT_MAX_TEST_ERROR,
              f"resume: TIMIT test error {r_resumed['test_error']}")
        res["timit"] = {**timed, "max_abs_diff": t_diff, "test_error": r_resumed["test_error"],
                        "fit_s": r_resumed["fit_s"]}
    return res


# --- phases 37-39: the resilience tier ------------------------------------------
# phase 37: a fleet of phase 20's LM replicas (the decode width, --quantize:
# K2 in prefill, K4 in decode) under fleet_game_day.json's faults
FLEET_N, FLEET_REQUESTS, FLEET_THREADS = 3, 60, 4
FLEET_PROMPTS, FLEET_PROMPT_LEN, FLEET_MAX_NEW = 8, 24, 16
FLEET_AFTER_REQUESTS = 24  # a burst once the killed replica is back
FLEET_LONG_NEW = 256  # the request in flight, mid-decode, when its replica is killed
FLEET_LAUNCH_REQUESTS = 12  # the clean burst whose launches are counted
FLEET_ARGS = ["--device", "cuda", "--vocab", HTTP_LM_ARGS["vocab"], "--dim", HTTP_LM_ARGS["dim"],
              "--depth", HTTP_LM_ARGS["depth"], "--heads", HTTP_LM_ARGS["heads"],
              "--s-max", HTTP_LM_ARGS["s_max"], "--slots", HTTP_LM_ARGS["slots"],
              "--max-new", str(FLEET_MAX_NEW), "--quantize"]
# phase 38: the guarded train step at the flagship train width
GUARD_STEPS, GUARD_NAN_AT, GUARD_TIMED = 6, 2, 4
# phase 39: the game days, widened for the card (the canned files stay)
GAMEDAY_TRAIN = dict(steps=8, every=2, batch=TRAIN_BATCH, seq=TRAIN_SEQ, vocab=TRAIN_CONF["vocab"],
                     dim=TRAIN_CONF["dim"], depth=TRAIN_CONF["depth"],
                     heads=TRAIN_CONF["num_heads"], lr=TRAIN_LR, compute_dtype="bfloat16",
                     timeout_s=600)
GAMEDAY_REFIT = dict(pipeline="mnist_fft", dim=784, labels=10, num_ffts=32, block_size=2048,
                     rows=16384, chunk_rows=4096, chunks=3, gram_op="int8")


def _replica_health(fleet) -> list:
    from keystone_tpu_torch.serve.fleet import http_transport

    out = []
    for r in fleet.replicas:
        status, health = http_transport(r, "GET", "/healthz", timeout=30.0)
        check(status == 200, f"fleet: replica {r.rid} /healthz answered {status}")
        out.append(health)
    return out


def _fleet_burst(fleet, bodies, threads: int, until=None) -> tuple:
    """``bodies`` through ``fleet.forward`` from ``threads`` client
    threads: ([{"i", "t0", "t1", "tokens" | "error"}], wall seconds). With
    ``until``, the threads go round ``bodies`` again until it returns True
    (``i`` counts on; ``bodies[i % len(bodies)]`` was sent)."""
    import itertools
    import threading

    order = itertools.count()
    lock = threading.Lock()
    out: list = []

    def worker():
        while True:
            with lock:
                i = next(order)
            if (until is None and i >= len(bodies)) or (until is not None and until()):
                return
            t0 = time.perf_counter()
            try:
                rec = {"tokens": fleet.forward("/generate", bodies[i % len(bodies)],
                                               kind="generate")["tokens"]}
            except Exception as e:  # noqa: BLE001 — the tally is the check
                rec = {"error": repr(e)}
            with lock:
                out.append({"i": i, "body": i % len(bodies), "t0": t0, "t1": time.perf_counter(),
                            **rec})

    pool = [threading.Thread(target=worker) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in pool), "fleet: a client request never returned")
    return sorted(out, key=lambda r: r["i"]), wall


def _check_captures(health, prefill: dict, k4_per_step: float) -> None:
    """Each replica's own count of the hand kernels' launches that one
    replay of each of its captured graphs makes (the wrapper counts that
    ticked while it captured the graph), held to the model: K2 once a
    block in a prefill, K4 six times a block in the pooled step and in a
    prefill of at most 64 rows; and to phase 10's profiler traces of the
    same graphs."""
    depth = int(HTTP_LM_ARGS["depth"])
    for i, h in enumerate(health):
        cap = h["captured_launches"]
        step = {k: cap["step"][k] for k in ("flash_attention", "int8_matmul")}
        check(step == {"flash_attention": 0, "int8_matmul": 6 * depth}
              and step["int8_matmul"] == k4_per_step,
              f"fleet: replica {i}'s step graph launches {cap['step']}")
        check(len(cap["prefill"]) > 0, f"fleet: replica {i} captured no prefill graph")
        for w, got in cap["prefill"].items():
            want = {"flash_attention": depth, "int8_matmul": 6 * depth if int(w) <= 64 else 0}
            got = {k: got[k] for k in want}
            check(got == want, f"fleet: replica {i}'s prefill graph at width {w} launches {got}, "
                  f"want {want}")
            if int(w) in prefill:
                check(got == prefill[int(w)]["launches"], f"fleet: replica {i}'s prefill graph at "
                      f"width {w}: {got} captured, {prefill[int(w)]['launches']} traced")


def _kill_mid_decode(fleet, body: dict, kill_inflight: list) -> dict:
    """``body`` (a long ``/generate``) through ``fleet.forward`` from a
    client thread; once a replica has it in flight and that replica's
    decode step graph has replayed for it, SIGKILL the replica. The
    request must come back whole from another replica. ``fleet``'s
    ``kill_replica`` appends the replica's in-flight dispatches at the
    kill to ``kill_inflight``."""
    import threading

    from keystone_tpu_torch.observe import metrics
    from keystone_tpu_torch.serve.fleet import http_transport

    def step_replays(r) -> int:
        return http_transport(r, "GET", "/healthz", timeout=30.0)[1]["graph_replays"]["step"]

    base = {r.rid: step_replays(r) for r in fleet.replicas}
    failover0 = metrics.get_registry().snapshot().get("fleet_failover", 0)
    out: dict = {}

    def send():
        t0 = time.perf_counter()
        try:
            out["tokens"] = fleet.forward("/generate", body, kind="generate")["tokens"]
        except Exception as e:  # noqa: BLE001 — checked below
            out["error"] = repr(e)
        out["wall_s"] = time.perf_counter() - t0

    client = threading.Thread(target=send)
    client.start()
    victim, deadline = None, time.monotonic() + 60
    while victim is None and client.is_alive() and time.monotonic() < deadline:
        victim = next((r for r in fleet.replicas if r.inflight > 0), None)
        time.sleep(0.0005)
    check(victim is not None, f"fleet: the long request never reached a replica ({out})")
    replays = 0
    while client.is_alive() and time.monotonic() < deadline:
        replays = step_replays(victim) - base[victim.rid]
        if replays > 0:
            break
        time.sleep(0.002)
    running = client.is_alive()
    fleet.kill_replica(victim)
    client.join(timeout=600)
    check(not client.is_alive(), "fleet: the long request never returned")
    check(running and replays > 0 and kill_inflight[-1] >= 1,
          f"fleet: the kill did not land mid-decode (request running {running}, {replays} step "
          f"replays, {kill_inflight[-1]} in flight)")
    check("error" not in out and len(out["tokens"]) == body["max_new"],
          f"fleet: the request in flight at the kill: {out.get('error', len(out.get('tokens', [])))}")
    failovers = metrics.get_registry().snapshot().get("fleet_failover", 0) - failover0
    check(failovers >= 1, "fleet: the request in flight at the kill did not fail over")
    res = {"body": body, "tokens": [int(t) for t in out["tokens"]], "replica": victim.rid,
           "inflight_at_kill": kill_inflight[-1], "step_replays_before_kill": replays,
           "wall_s": out["wall_s"], "failovers": failovers}
    print(f"fleet: replica {victim.rid} killed with {kill_inflight[-1]} request in flight after "
          f"{replays} of its {body['max_new']} decode step replays; the request came back whole "
          f"({len(out['tokens'])} tokens) from another replica in {out['wall_s']:.2f} s")
    return res


def _pcts(recs) -> dict:
    secs = sorted(r["t1"] - r["t0"] for r in recs)
    if not secs:
        return {"requests": 0}
    return {"requests": len(secs), "p50_ms": statistics.median(secs) * 1e3,
            "p99_ms": secs[min(len(secs) - 1, math.ceil(0.99 * len(secs)) - 1)] * 1e3}


def phase_fleet(device, prefill: dict, k4_per_step: float) -> dict:
    """Phase 37: ``serve.fleet`` with 3 replicas of phase 20's LM app
    (``python -m keystone_tpu_torch.serve.server lm`` at the decode width,
    ``--quantize``) on this card, the kernels built once by the router
    before any boot. A 60-request ``/generate`` burst from 4 threads with
    ``fleet_game_day.json``'s router faults armed (``fleet.slow_replica``,
    ``fleet.replica_kill``, ``fleet.conn_reset``), then a rolling restart
    under a second burst: no failed request, a failover, the killed replica
    relaunched and up, every replica through the restart's probe gate, and
    every reply's tokens those of the same prompt alone through
    ``generate`` on the card. Between the two, a replica is killed while a
    long ``/generate`` is in flight on it and its decode graph replays;
    that request is answered whole by another replica. The replicas' K2
    and K4 launches are their own counts: what one replay of each captured
    graph launches (held exactly to the model and to phase 10's traces, at
    boot and after the restart), and over a clean burst their wrapper
    launches plus what their replays launched (K2 exactly once a block a
    request, K4 exactly six times a block a step replay and a prefill)."""
    import tempfile

    import numpy as np

    from keystone_tpu_torch.core.kernels import BUILD_DIR
    from keystone_tpu_torch.models.lm.decode import generate, quantize_for_decode
    from keystone_tpu_torch.observe import events, metrics
    from keystone_tpu_torch.observe import spans as _spans
    from keystone_tpu_torch.resilience import chaos, faults
    from keystone_tpu_torch.serve import fleet as fl
    from keystone_tpu_torch.serve import server

    card = torch.cuda.get_device_name(0)
    reg = metrics.get_registry()
    rng = np.random.default_rng(37)
    prompts = [rng.integers(0, int(HTTP_LM_ARGS["vocab"]), FLEET_PROMPT_LEN).tolist()
               for _ in range(FLEET_PROMPTS)]
    bodies = [{"prompt": prompts[i % FLEET_PROMPTS], "max_new": FLEET_MAX_NEW}
              for i in range(FLEET_REQUESTS)]
    res: dict = {"replicas": FLEET_N, "requests": FLEET_REQUESTS, "threads": FLEET_THREADS,
                 "prompt_len": FLEET_PROMPT_LEN, "max_new": FLEET_MAX_NEW}
    res["router_build_s"] = fl.prebuild_kernels()
    os.makedirs(BUILD_DIR, exist_ok=True)

    def libraries():  # a build in flight shows as a tmp*.so beside them
        return sorted(f for f in os.listdir(BUILD_DIR) if f.endswith(".so"))

    built = libraries()
    fleet = fl.Fleet(cmd=fl.replica_command("lm", FLEET_ARGS), n=FLEET_N, poll_s=0.2,
                     grace_s=30.0, boot_timeout_s=600.0, deadline_ms=120_000.0)
    try:
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp, events.run(tmp) as log:
            t0, t_spawn = time.perf_counter(), time.time()
            fleet.start(wait_up=FLEET_N, timeout=600.0)
            res["boot_s"] = time.perf_counter() - t0
            health = _replica_health(fleet)
            # a replica's cold start: its app's build (the server's own
            # clock) and spawn to `up` on the router's poll (process start,
            # imports and CUDA context included)
            up_at = {}
            for e in log.records:
                if e.get("action") == "fleet_replica_state" and e.get("state") == "up":
                    up_at.setdefault(e["replica"], e["ts"])
            res["replica_health"] = [
                {**{k: h.get(k) for k in ("device", "device_name", "cold_start_s",
                                          "peak_memory_bytes")},
                 "spawn_to_up_s": up_at[r.rid] - t_spawn}
                for r, h in zip(fleet.replicas, health)]
            for h in res["replica_health"]:
                print(f"fleet replica on {h['device']} ({h['device_name']}): cold start "
                      f"{h['cold_start_s']:.2f} s (app build), {h['spawn_to_up_s']:.2f} s spawn to "
                      f"up, peak memory {h['peak_memory_bytes'] / 2**30:.2f} GiB")
            check(all(h["device"].startswith("cuda") and h["device_name"] == card
                      for h in res["replica_health"]), f"fleet: replica devices {health}")
            check(libraries() == built, "fleet: a replica built a kernel after the router's build")
            _check_captures(health, prefill, k4_per_step)

            # ---- the chaos burst: counts and faults from request 0 -------
            spec = chaos.load_campaign("fleet_game_day")
            check(fleet.next_rid == 0, "fleet: a request ran before the burst")
            failover0 = reg.snapshot().get("fleet_failover", 0)
            kill_inflight = []  # the router's dispatches in flight on a replica at its kill
            real_kill = fleet.kill_replica

            def kill(r):
                kill_inflight.append(r.inflight)
                real_kill(r)

            fleet.kill_replica = kill
            faults.configure(chaos.compile_schedule(spec))
            try:
                recs, wall = _fleet_burst(fleet, bodies, FLEET_THREADS)
            finally:
                faults.reset()
            deadline = time.monotonic() + 600
            while time.monotonic() < deadline and not (
                    sum(r.crash_restarts for r in fleet.replicas) >= 1
                    and all(r.state == "up" for r in fleet.replicas)):
                time.sleep(0.1)
            t_healed = time.perf_counter()
            failovers = reg.snapshot().get("fleet_failover", 0) - failover0
            after_kill, _ = _fleet_burst(fleet, bodies[:FLEET_AFTER_REQUESTS], FLEET_THREADS)
            # ---- a kill while a long /generate decodes on the replica ----
            import threading

            mid = _kill_mid_decode(fleet, {"prompt": prompts[0], "max_new": FLEET_LONG_NEW},
                                   kill_inflight)
            deadline = time.monotonic() + 600
            while time.monotonic() < deadline and not (
                    sum(r.crash_restarts for r in fleet.replicas) >= 2
                    and all(r.state == "up" for r in fleet.replicas)):
                time.sleep(0.1)
            mid["again"] = fleet.forward("/generate", mid["body"], kind="generate")["tokens"]
            # ---- the rolling restart under a second burst ---------------
            restart: dict = {}

            def roll():
                restart.update(fleet.rolling_restart())

            roller = threading.Thread(target=roll)
            roller.start()
            recs2, wall2 = _fleet_burst(fleet, bodies, FLEET_THREADS,
                                        until=lambda: not roller.is_alive())
            roller.join(timeout=900)
            check(not roller.is_alive(), "fleet: the rolling restart never finished")
            # ---- a clean burst: the replicas' launches -------------------
            before = _replica_health(fleet)
            _check_captures(before, prefill, k4_per_step)  # the restarted processes
            recs3, _ = _fleet_burst(fleet, bodies[:FLEET_LAUNCH_REQUESTS], FLEET_THREADS)
            after = _replica_health(fleet)
            records = list(log.records)
            span_recs = _spans.read_spans(log.run_dir)
    finally:
        fleet.shutdown(grace_s=30.0)

    # ---- checks --------------------------------------------------------------
    every = recs + after_kill + recs2 + recs3
    failed = [r for r in every if "error" in r]
    check(not failed, f"fleet: {len(failed)} failed client requests: {failed[:3]}")
    check(failovers >= 1, "fleet: no failover under the kill and the connection reset")
    kills = sorted((e for e in records if e.get("action") == "fleet_replica_kill"),
                   key=lambda e: e["ts"])
    check(len(kills) == 2, f"fleet: {len(kills)} replica kills (the burst's and the mid-decode's)")
    killed = kills[0]["replica"]
    relaunch = []
    for k in kills:
        up = [e for e in records if e.get("action") == "fleet_replica_state"
              and e.get("replica") == k["replica"] and e.get("state") == "up" and e["ts"] > k["ts"]]
        check(bool(up) and fleet.replicas[k["replica"]].restarts >= 1,
              f"fleet: replica {k['replica']} was not relaunched and back up")
        relaunch.append(up)
    mid["relaunch_s"] = min(e["ts"] for e in relaunch[1]) - kills[1]["ts"]
    res["kill_mid_decode"] = mid
    res["inflight_at_burst_kill"] = kill_inflight[0]
    probed = [e for e in records if e.get("action") == "fleet_restart"
              and e.get("stage") == "replica_up"]
    check(sorted(e["replica"] for e in probed) == list(range(FLEET_N))
          and all(e.get("probed") for e in probed),
          f"fleet: the restart's probe gate {probed}")
    # the replies against each prompt alone through generate on the card
    model = quantize_for_decode(server._build_lm(HTTP_LM_ARGS, device)).replace(
        int8_kernel="kernel")
    lone = [generate(model, torch.tensor([p], device=device), max_new=FLEET_MAX_NEW)[0].tolist()
            for p in prompts]
    again = [generate(model, torch.tensor([p], device=device), max_new=FLEET_MAX_NEW)[0].tolist()
             for p in prompts]
    lone_long = generate(model, torch.tensor([mid["body"]["prompt"]], device=device),
                         max_new=FLEET_LONG_NEW)[0].tolist()
    del model
    torch.cuda.empty_cache()
    replies = [(r["body"] % FLEET_PROMPTS, [int(t) for t in r["tokens"]]) for r in every]

    def agreement(pairs) -> tuple:
        """(equal sequences, share of equal positions, first differing
        positions) of (tokens, reference tokens) pairs."""
        pairs = list(pairs)
        same = sum(a == b for t, ref in pairs for a, b in zip(t, ref))
        first = sorted({next(j for j, (a, b) in enumerate(zip(t, ref)) if a != b)
                        for t, ref in pairs if t != ref})
        return (sum(t == ref for t, ref in pairs), same / sum(len(t) for t, _ in pairs), first)

    eq, share, first = agreement((t, lone[k]) for k, t in replies)
    lone_eq, lone_share, _ = agreement(zip(again, lone))
    res["tokens_vs_lone"] = {"replies": len(replies), "equal_replies": eq,
                             "position_agreement": share, "first_differing_positions": first,
                             "two_lone_runs": {"equal": lone_eq, "position_agreement": lone_share}}
    print(f"fleet: {eq}/{len(replies)} replies equal the lone generate's tokens ({share:.4%} of "
          f"positions); two lone generate runs agree on {lone_share:.4%}")
    check(lone_eq == FLEET_PROMPTS, "fleet: two lone generate runs differ")
    # the reply to the request in flight at the kill: the same tokens as
    # the same request served again once the tier healed; its agreement
    # with generate alone is reported beside the other replies'
    m_eq, m_share, m_first = agreement([(mid["tokens"], lone_long)])
    res["kill_mid_decode"]["vs_lone"] = {"equal": bool(m_eq), "position_agreement": m_share,
                                         "first_differing_positions": m_first}
    res["kill_mid_decode"]["equals_served_again"] = mid["tokens"] == [int(t) for t in mid["again"]]
    print(f"fleet: the request failed over mid-decode equals the same request served again: "
          f"{res['kill_mid_decode']['equals_served_again']}; equals generate alone: {bool(m_eq)} "
          f"({m_share:.4%} of {FLEET_LONG_NEW} positions)")
    check(res["kill_mid_decode"]["equals_served_again"],
          "fleet: the request failed over mid-decode differs from the same request served again")
    if eq != len(replies):
        # name the op: the same prompts alone through the replicas' own path
        # (one app, one request at a time: the bucketed prefill graph, the
        # pooled decode step)
        app = server.build_app("lm", {**HTTP_LM_ARGS, "max_new": str(FLEET_MAX_NEW)},
                               device=device)
        try:
            served = [[int(t) for t in app.generate(np.asarray(p), max_new=FLEET_MAX_NEW)]
                      for p in prompts]
        finally:
            app.shutdown()
        s_eq, s_share, s_first = agreement(zip(served, lone))
        res["tokens_vs_lone"]["served_alone_vs_generate"] = {
            "equal": s_eq, "position_agreement": s_share, "first_differing_positions": s_first}
        print(f"fleet: alone through the served path the prompts agree with generate on "
              f"{s_share:.4%} of positions, first differing at {s_first} (0: the prefill, K2 at "
              "the bucket's padded width; later: the pooled, graphed decode step through K4)")
        check(all(t == served[k] for k, t in replies),
              "fleet: a reply differs from the same prompt served alone")
        check(share >= s_share, f"fleet: agreement {share:.4%} below the served path's alone "
              f"{s_share:.4%}")

    # ---- numbers -------------------------------------------------------------
    t_kill = min(e["ts"] for e in kills)
    t_up = min(e["ts"] for e in relaunch[0])
    t_wall0 = time.time() - time.perf_counter()  # perf_counter → wall clock
    before_kill = [r for r in recs if r["t1"] + t_wall0 < t_kill]
    during = [r for r in recs if r["t1"] + t_wall0 >= t_kill and r["t0"] + t_wall0 < t_up]
    after_up = [r for r in recs if r["t0"] + t_wall0 >= t_up] + after_kill
    fo_rids = {e["rid"] for e in records if e.get("action") == "fleet_failover"}
    spans = [e for e in span_recs if e.get("name") == "fleet.request"]
    fo_wall = [e["wall_s"] for e in spans if e.get("rid") in fo_rids]
    plain_wall = [e["wall_s"] for e in spans if e.get("rid") not in fo_rids]
    res["chaos_burst"] = {
        "wall_s": wall, "requests_per_s": FLEET_REQUESTS / wall, "failovers": failovers,
        "killed_replica": killed, "relaunch_s": t_up - t_kill,
        "before_kill": _pcts(before_kill), "during_kill": _pcts(during),
        "after_relaunch": _pcts(after_up),
        "failover_added_ms": (statistics.mean(fo_wall) - statistics.median(plain_wall)) * 1e3
        if fo_wall and plain_wall else None,
        "healed_s_after_burst": t_healed - (recs[-1]["t1"] if recs else t_healed)}
    stages = {}
    for e in records:
        if e.get("action") == "fleet_restart" and e.get("replica") is not None:
            stages.setdefault(e["replica"], {})[e["stage"]] = e["ts"]
    res["rolling_restart"] = {
        "wall_s": restart.get("wall_s"), "restarted": restart.get("restarted"),
        "per_replica_s": {r: st["replica_up"] - st["drain"] for r, st in sorted(stages.items())
                          if "drain" in st and "replica_up" in st},
        "burst": {**_pcts(recs2), "wall_s": wall2, "requests_per_s": len(recs2) / wall2}}
    cb = res["chaos_burst"]
    print(f"fleet chaos burst: {FLEET_REQUESTS} requests in {wall:.2f} s "
          f"({cb['requests_per_s']:.2f} requests/s), {failovers} failovers, replica {killed} "
          f"killed and back up in {cb['relaunch_s']:.2f} s; p50/p99 ms before the kill "
          f"{cb['before_kill']}, during {cb['during_kill']}, after {cb['after_relaunch']}; "
          f"failover adds {cb['failover_added_ms']} ms")
    print(f"fleet rolling restart: {res['rolling_restart']['wall_s']} s, per replica "
          f"{res['rolling_restart']['per_replica_s']} s, burst under it "
          f"{res['rolling_restart']['burst']}")
    # the replicas' own counts over the clean burst: wrapper launches plus
    # what their graph replays launched, each replay counted at what its
    # graph's capture launched
    depth = int(HTTP_LM_ARGS["depth"])
    launches = {"flash_attention": 0, "int8_matmul": 0}
    wrapper = dict(launches)
    replays = {"prefill": 0, "step": 0}
    for b, a in zip(before, after):
        for kind in replays:
            replays[kind] += a["graph_replays"][kind] - b["graph_replays"][kind]
        for name in launches:
            wrapper[name] += a["kernel_launches"][name] - b["kernel_launches"][name]
            launches[name] += (a["kernel_launches"][name] - b["kernel_launches"][name]
                               + a["graph_launches"].get(name, 0)
                               - b["graph_launches"].get(name, 0))
    width = min(w for w in prefill if w >= FLEET_PROMPT_LEN)
    want = {"flash_attention": depth * FLEET_LAUNCH_REQUESTS,
            "int8_matmul": 6 * depth * (replays["step"]
                                        + (replays["prefill"] if width <= 64 else 0))}
    res["launches"] = {"clean_burst_requests": FLEET_LAUNCH_REQUESTS, "graph_replays": replays,
                       "prefill_width": width, "total": launches, "wrapper": wrapper,
                       "per_request": {k: v / FLEET_LAUNCH_REQUESTS for k, v in launches.items()},
                       "count": "each replica's own: wrapper launches + its graph replays at the "
                                "launches counted when it captured each graph"}
    print(f"fleet launches over {FLEET_LAUNCH_REQUESTS} clean requests, the replicas' own counts: "
          f"{replays} graph replays, K2 {launches['flash_attention']} (want "
          f"{want['flash_attention']}), K4 {launches['int8_matmul']} (want {want['int8_matmul']}), "
          f"of them from wrappers {wrapper}")
    check(replays["prefill"] == FLEET_LAUNCH_REQUESTS and replays["step"] > 0 and launches == want,
          f"fleet: the replicas' launches {res['launches']}, want {want}")
    return res


def _snapshot_train(model, state) -> list:
    return ([p.detach().clone() for p in model.leaves()] + [m.clone() for m in state.mu]
            + [v.clone() for v in state.nu] + [torch.as_tensor(state.count).clone()])


STALL_SCRIPT = """
import importlib, time
from keystone_tpu_torch.models import lm
train_mod = importlib.import_module("keystone_tpu_torch.models.lm.train")
real = train_mod.make_train_step
def make(*a, **kw):
    step, n = real(*a, **kw), [0]
    def stalled(*args):
        n[0] += 1
        if n[0] == 3:
            time.sleep(120)  # the stalled step
        return step(*args)
    return stalled
train_mod.make_train_step = make
model = lm.TransformerLM.create(vocab=256, max_seq=256, dim=256, depth=2, num_heads=4)
train_mod.train(model, lm.synthetic_corpus(20000, 256), steps=6, batch=4, seq=256,
                step_timeout_s=2.0)
"""


def phase_guards(device) -> dict:
    """Phase 38: the numerical guards and the step watchdog at the flagship
    train width (bench.py:863: seq 2,048, batch 8, bf16, AdamW 3e-4).
    ``train(guard="skip")`` with ``train.nan`` at step 2 of 6: the
    parameters, both moments and the count after the poisoned step equal
    those before it bit for bit, the later losses are finite and K2
    launches depth times a step, as in phase 15; ``guard="halt"`` raises;
    the guarded step's ms against the plain one's, in turns; the pipeline
    output guard on a ``batch.nan``-poisoned MNIST apply; a stalled step
    under ``step_timeout_s`` in a child process logs the stacks and exits
    with the watchdog's code."""
    import importlib

    import numpy as np

    from keystone_tpu_torch.models.lm.train import _step_batch, synthetic_corpus
    from keystone_tpu_torch.resilience import faults, guards
    from keystone_tpu_torch.resilience.watchdog import EXIT_WEDGED
    from keystone_tpu_torch.serve import server

    train_mod = importlib.import_module("keystone_tpu_torch.models.lm.train")
    depth = TRAIN_CONF["depth"]
    corpus = synthetic_corpus(200_000, TRAIN_CONF["vocab"], seed=0)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, seed=0)
    res: dict = {}
    real = train_mod.make_train_step
    snaps: dict = {}

    def snapshotting(*a, **k):
        step = real(*a, **k)
        if not k.get("guarded"):
            return step

        def step_with_snapshots(model, state, toks, poison):
            if poison:
                torch.cuda.synchronize()
                snaps["before"] = _snapshot_train(model, state)
            out = step(model, state, toks, poison)
            if poison:
                torch.cuda.synchronize()
                snaps["after"] = _snapshot_train(model, state)
            return out

        return step_with_snapshots

    # ---- the guarded run: counts from 0 ----------------------------------------
    _zero_counts()
    train_mod.make_train_step = snapshotting
    faults.configure(f"train.nan:@{GUARD_NAN_AT}:0")
    try:
        t0 = time.perf_counter()
        _, losses = train_mod.train(_resume_model(device), corpus, steps=GUARD_STEPS,
                                    guard="skip", **kw)
        torch.cuda.synchronize()
        res["guarded_run_s"] = time.perf_counter() - t0
    finally:
        faults.reset()
        train_mod.make_train_step = real
    counts = _counts()
    same = [torch.equal(a, b) for a, b in zip(snaps["before"], snaps["after"])]
    del snaps
    print(f"guards: train(guard='skip') with train.nan at step {GUARD_NAN_AT}: losses {losses}; "
          f"{sum(same)}/{len(same)} leaves (parameters, moments, count) unchanged by the "
          f"poisoned step; launches {counts}")
    check(all(same), "guards: the skipped step changed a parameter, a moment or the count")
    check(math.isnan(losses[GUARD_NAN_AT]) and all(
        math.isfinite(x) for i, x in enumerate(losses) if i != GUARD_NAN_AT),
        f"guards: losses {losses}")
    check(counts["flash_attention"] == depth * GUARD_STEPS and counts["flash_attention_step"] == 0,
          f"guards: launches {counts}, want K2 {depth * GUARD_STEPS} (phase 15's {depth} a step)")
    res.update(losses=losses, leaves_unchanged=len(same), launches=counts)
    torch.cuda.empty_cache()

    faults.configure("train.nan:@1:0")
    try:
        train_mod.train(_resume_model(device), corpus, steps=3,
                        guard=guards.GuardConfig(mode="halt", check_every=1), **kw)
        check(False, "guards: guard='halt' did not raise")
    except guards.NumericalHealthError as e:
        res["halt"] = str(e)
        print(f"guards: guard='halt' raised NumericalHealthError: {e}")
    finally:
        faults.reset()
    torch.cuda.empty_cache()

    # ---- the guard's price: plain and guarded steps in turns -------------------
    model = _resume_model(device)
    opt = train_mod.make_optimizer(TRAIN_LR)
    plain_state = opt.init(model.leaves())
    plain = train_mod.make_train_step(opt)
    guarded = train_mod.make_train_step(opt, guarded=True)
    g_state = opt.init(model.leaves())
    g_state.count = torch.zeros((), dtype=torch.int64, device=device)
    batches = [torch.from_numpy(_step_batch(corpus, 0, i, TRAIN_BATCH, TRAIN_SEQ)).to(device)
               for i in range(2)]
    ms: dict = {"plain": [], "guarded": []}
    for turn in range(2 + GUARD_TIMED):
        for name in (("plain", "guarded") if turn % 2 else ("guarded", "plain")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "plain":
                plain(model, plain_state, batches[turn % 2])
            else:
                guarded(model, g_state, batches[turn % 2], False)
            torch.cuda.synchronize()
            if turn >= 2:
                ms[name].append((time.perf_counter() - t0) * 1e3)
    del model, plain_state, g_state
    torch.cuda.empty_cache()
    res["ms_per_step"] = {k: statistics.mean(v) for k, v in ms.items()}
    res["ms_turns"] = ms
    overhead = res["ms_per_step"]["guarded"] - res["ms_per_step"]["plain"]
    print(f"guards: {res['ms_per_step']['guarded']:.2f} ms a guarded step against "
          f"{res['ms_per_step']['plain']:.2f} ms plain ({overhead:+.2f} ms, turns {ms})")

    # ---- the pipeline output guard on the card -----------------------------------
    pipe, _ = server._fit_mnist_demo(2048, num_ffts=4, device=device)
    x = torch.from_numpy(np.random.default_rng(38).normal(size=(64, 784)).astype(np.float32)
                         ).to(device)
    faults.configure("batch.nan:@0:0")
    try:
        poisoned = faults.poison("batch.nan", x)
    finally:
        faults.reset()
    check(bool(torch.isnan(poisoned[0]).all()) and bool(torch.isfinite(poisoned[1:]).all()),
          "guards: batch.nan did not poison the first row on the card")
    guards.set_output_guard("raise")
    try:
        pipe(x)
        try:
            pipe(poisoned)
            check(False, "guards: the output guard let a non-finite apply through")
        except guards.NumericalHealthError as e:
            res["output_guard"] = str(e)
            print(f"guards: the output guard raised on the poisoned MNIST apply: {e}")
    finally:
        guards.set_output_guard(None)
    del pipe

    # ---- the step watchdog -------------------------------------------------------
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "KEYSTONE_STEP_ESCALATE": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [here, os.environ.get("PYTHONPATH")]))}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", STALL_SCRIPT], env=env, capture_output=True,
                          text=True, timeout=300, cwd=here)
    res["watchdog"] = {"exit": proc.returncode, "wall_s": time.perf_counter() - t0,
                       "stacks_logged": "Thread" in proc.stderr and "stalled" in proc.stderr}
    print(f"guards: a stalled step under step_timeout_s 2 exited {proc.returncode} after "
          f"{res['watchdog']['wall_s']:.1f} s, stacks logged {res['watchdog']['stacks_logged']}")
    check(proc.returncode == EXIT_WEDGED and res["watchdog"]["stacks_logged"],
          f"guards: the watchdog child exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return res


def phase_game_days(device) -> dict:
    """Phase 39: ``chaos.run_campaign`` on the card. ``train_game_day``
    widened to the flagship train width and cut to 8 steps with a
    checkpoint every 2 (a supervised child: SIGKILL after step 6, ENOSPC at
    step 4's save, a dropped heartbeat); ``refit_game_day`` at phase 35's
    MNIST width (D = 16,384, the int8 Gram forced): every invariant PASS,
    the train run's K2 launches depth times each step its last incarnation
    ran, K1 once a fit and a fold chunk, its first launch bit for bit."""
    import tempfile

    from keystone_tpu_torch.core.kernels import BUILD_DIR
    from keystone_tpu_torch.ops import gram
    from keystone_tpu_torch.resilience import chaos

    res: dict = {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        spec = chaos.load_campaign("train_game_day")
        spec["workload"].update(GAMEDAY_TRAIN)
        r = chaos.run_campaign(spec, report_dir=os.path.join(tmp, "train"), device="cuda")
        w = r["workload"]
        print(chaos.render_report(r))
        check(r["passed"], f"game day: train_game_day failed: {[v for v in r['invariants']]}")
        ran = len(w["losses"])
        resumed_at = GAMEDAY_TRAIN["steps"] - ran
        saves_failed = sum(1 for site, _ in r["fired"] if site == "ckpt.disk_full")
        res["train"] = {"wall_s": r["wall_s"], "relaunches": w["relaunches"],
                        "resumed_at_step": resumed_at, "saves_failed": saves_failed,
                        "losses": w["losses"],
                        "launches_last_incarnation": w["launches"],
                        "invariants": [[v["name"], v["ok"], v["detail"]] for v in r["invariants"]],
                        "fired": r["fired"]}
        print(f"game day train: {r['wall_s']:.1f} s, {w['relaunches']} relaunch, resumed at step "
              f"{resumed_at} (the last intact checkpoint), {saves_failed} checkpoint saves hit the "
              f"full disk and fell back; the last incarnation's launches {w['launches']}")
        check(all(math.isfinite(x) for x in w["losses"]), f"game day: losses {w['losses']}")
        check(w["launches"]["flash_attention"] == GAMEDAY_TRAIN["depth"] * ran
              and w["launches"]["flash_attention_step"] == 0,
              f"game day: train launches {w['launches']} for {ran} steps")
        check(resumed_at == 2, f"game day: resumed at step {resumed_at}, want the last intact 2")

        spec = chaos.load_campaign("refit_game_day")
        spec["workload"].update(GAMEDAY_REFIT)
        first_q: list = []
        raw = gram.int8_gram

        def recording(q):
            if not first_q:
                first_q.append(q.clone())
            return raw(q)

        _zero_counts()
        gram.int8_gram = recording
        try:
            r = chaos.run_campaign(spec, report_dir=os.path.join(tmp, "refit"), device="cuda")
        finally:
            gram.int8_gram = raw
        counts = _counts()
        w = r["workload"]
        print(chaos.render_report(r))
        check(r["passed"], f"game day: refit_game_day failed: {r['invariants']}")
        boot_chunks = -(-GAMEDAY_REFIT["rows"] // 8192)
        folded = w["chunks_folded"]
        check(counts["int8_gram"] == boot_chunks + folded,
              f"game day: K1 {counts['int8_gram']} launches, want {boot_chunks} + {folded}")
        check(bool(first_q), "game day: K1 never ran on the refit path")
        first = gram.int8_gram(first_q[0])
        check(torch.equal(first, gram.int8_gram_plain(first_q[0])),
              "game day: K1's first refit launch differs from its plain version")
        res["refit"] = {"wall_s": r["wall_s"], "bootstrap_s": w["bootstrap_s"],
                        "fold_s": w["fold_s"], "fold_ms_per_chunk": w["fold_s"] * 1e3 / max(
                            folded, 1), "chunks_folded": folded,
                        "chunks_skipped": w["chunks_skipped"], "swaps": w["swaps_committed"],
                        "swap_failures": w["swap_failures"], "client_ok": w["client_ok"],
                        "k1_launches": counts["int8_gram"], "k1_first_launch_bit_for_bit": True,
                        "invariants": [[v["name"], v["ok"], v["detail"]] for v in r["invariants"]]}
        print(f"game day refit: {r['wall_s']:.1f} s, folds {res['refit']['fold_ms_per_chunk']:.1f} "
              f"ms a chunk ({folded} folded, {w['chunks_skipped']} skipped), K1 "
              f"{counts['int8_gram']} launches ({boot_chunks} bootstrap + {folded} folds), first "
              "launch bit for bit")
    torch.cuda.empty_cache()
    return res


# --- the planner's self-tuning and the observability tools (phases 40-42) ---
TUNE_WINDOW_S = "0.02"  # the autotuner's window: the fit's stream lasts about 0.15 s
SHARED_LAMS = (0.01, 0.1)  # fit_shared's two block solvers on one featurizer bank
SHARED_TOL = 1e-5  # of max|W|, shared fits against the naive fits
PROFILE_ROWS, PROFILE_COLS = 2048, 512  # the K1 node profiled on the card and the CPU
OBS_STEPS, OBS_WINDOW = 4, "1:2"  # train steps and the profiler window (start:steps)
OBS_PEAK_TOL = 0.01  # the monitor's peak against torch.cuda.max_memory_allocated
CLI_MNIST_ARGV = ["--synthetic", "10000", "--num-ffts", "8", "--block-size", "2048"]


def _env(**values):
    """Set environment variables (None unsets); returns the old values."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return old


def _k1_first_launch(leg: str, q: torch.Tensor) -> bool:
    """K1 on a fit's first chunk against its plain version, bit for bit."""
    from keystone_tpu_torch.ops import gram

    out, ref = gram.int8_gram(q), gram.int8_gram_plain(q)
    torch.cuda.synchronize()
    exact = bool(torch.equal(out, ref))
    print(f"K1 first launch of the {leg} fit ({q.shape[0]}x{q.shape[1]}): bit for bit {exact}")
    check(exact, f"self-tuning: K1's first launch of the {leg} fit is not its plain version")
    return exact


def phase_self_tuning(device) -> dict:
    """Phase 40: the main path's MNIST fit (``MAIN_ARGV``, int8 forced) under
    ``KEYSTONE_TUNE=1`` and a fresh ``KEYSTONE_PLAN_STORE``; the tuner's
    flush at the run's end persists the record; a second fit's planned
    passes take ``source="store"`` from it. K1 once a fit chunk in each,
    its first launch bit for bit; ``fit_shared`` over two solvers on one
    featurizer bank (prefix once, weights the naive fits'); a K1 node's
    cost profile on the card against the CPU; ``plan.cli`` for the card."""
    import contextlib
    import io
    import tempfile

    from keystone_tpu_torch import plan as plan_mod
    from keystone_tpu_torch.core.config import parse_config
    from keystone_tpu_torch.core.kernels import BUILD_DIR
    from keystone_tpu_torch.core.pipeline import ChainedLabelEstimator, Pipeline, transformer
    from keystone_tpu_torch.models import mnist_random_fft as m
    from keystone_tpu_torch.observe import cost, metrics
    from keystone_tpu_torch.ops import gram
    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicators
    from keystone_tpu_torch.plan import cli as plan_cli
    from keystone_tpu_torch.plan import store as plan_store
    from keystone_tpu_torch.plan import tune

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    res: dict = {"legs": {}}
    raw_int8_gram = gram.int8_gram
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as store_dir:
        old = _env(KEYSTONE_PLAN="1", KEYSTONE_GRAM_OP="int8", KEYSTONE_TUNE="1",
                   KEYSTONE_PLAN_STORE=store_dir, KEYSTONE_TUNE_WINDOW_S=TUNE_WINDOW_S)
        try:
            for leg in ("tuned", "stored"):
                tune.reset()
                first: list = []

                def spy(q, first=first):
                    if not first:
                        first.append(q.clone())
                    return raw_int8_gram(q)

                gram.int8_gram = spy
                _zero_counts()
                t0 = time.perf_counter()
                try:
                    run = m.main(list(MAIN_ARGV))
                    torch.cuda.synchronize()
                finally:
                    gram.int8_gram = raw_int8_gram
                wall = time.perf_counter() - t0
                counts = _counts()
                chunks = -(-run["n_train"] // (run["fit_chunk_size"] or run["n_train"]))
                tuner = tune.active()
                history = list(tuner.history)
                knobs = {k: tuner.value(k) for k in sorted(tuner.knobs)}
                if leg == "tuned":
                    tuner.flush()  # the run's teardown: persist the converged knobs
                decisions = run["apply_decisions"]["train"]
                seeded = [d for d in decisions if d.get("source") == "store"]
                print(f"self-tuning [{leg}]: {wall:.2f} s, test error {run['test_error']:.4%}, "
                      f"K1 {counts['int8_gram']} launches for {chunks} fit chunks; tuner "
                      f"windows {[(h.get('eval'), h.get('action'), h.get('knob')) for h in history]}"
                      f", knobs {knobs}; the train pass's store-seeded decisions {seeded}")
                check(counts["int8_gram"] == chunks and not any(
                    v for k, v in counts.items() if k != "int8_gram"),
                    f"self-tuning [{leg}]: launches {counts} for {chunks} chunks")
                check(run["test_error"] <= MAX_TEST_ERROR,
                      f"self-tuning [{leg}]: test error {run['test_error']}")
                check(history, f"self-tuning [{leg}]: the tuner judged no window")
                exact = _k1_first_launch(leg, first[0])
                leg_res = {"wall_s": wall, "test_error": run["test_error"],
                           "fit_chunk_size": run["fit_chunk_size"], "k1_launches": counts[
                               "int8_gram"], "fit_chunks": chunks, "k1_first_launch_bit_for_bit":
                           exact, "tuner_history": history, "knobs": knobs,
                           "apply_decisions": run["apply_decisions"]}
                if leg == "tuned":
                    q = first[0]
                    leg_res["k1_ms"] = time_ms(lambda: gram.int8_gram(q))
                    print(f"K1 at the tuned fit's chunk: {leg_res['k1_ms']:.3f} ms")
                    records = plan_store.entries(store_dir)
                    check(len(records) == 1 and records[0]["device_kind"] == kind,
                          f"self-tuning: the store holds {records}")
                    res["store_record"] = records[0]
                    print("store record: " + " | ".join(plan_store.describe(records[0])))
                else:
                    check(seeded and any(d["action"] == "learned" for d in decisions),
                          f"self-tuning: the second fit took nothing from the store {decisions}")
                del first
                res["legs"][leg] = leg_res
            tune.reset()
            # plan.cli for the card: the fit plan and the stored record
            outs = {}
            for flags in (["--fit"], ["--learned"]):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    plan_cli.main(["mnist-random-fft", *flags])
                outs[flags[0]] = buf.getvalue()
            check(f"device: {kind}" in outs["--fit"] and "gram=" in outs["--fit"],
                  f"plan cli --fit: {outs['--fit'][:400]}")
            check(f"device={kind}" in outs["--learned"] and "learned plan" in outs["--learned"],
                  f"plan cli --learned: {outs['--learned'][:400]}")
            print("plan cli --learned:\n" + outs["--learned"].rstrip())
            res["plan_cli"] = outs
        finally:
            tune.reset()
            _env(**old)

    # fit_shared: the featurizer bank paid once for two block solvers
    conf = parse_config(m.MnistRandomFFTConfig, list(MAIN_ARGV))
    train = m._load(conf, "train")
    x = torch.from_numpy(train.data)
    y = ClassLabelIndicators(num_classes=10)(train.labels)
    bank = m.FeaturizerBank.create(conf.num_ffts, conf.block_size, conf.seed, device=device)
    chains = [ChainedLabelEstimator(prefix=bank, est=BlockLeastSquaresEstimator(
        block_size=conf.block_size, num_iter=1, lam=lam)) for lam in SHARED_LAMS]
    reg = metrics.get_registry()
    before = {k: reg.snapshot().get(k, 0) for k in ("plan_prefix_shared",
                                                     "plan_featurize_passes_saved")}
    calls = []
    featurize = m.FeaturizerBank.__call__

    def counted(self, data):
        calls.append(int(data.shape[0]))
        return featurize(self, data)

    m.FeaturizerBank.__call__ = counted
    _zero_counts()
    t0 = time.perf_counter()
    try:
        shared = plan_mod.fit_shared(chains, x, y, device=device)
        torch.cuda.synchronize()
        shared_s = time.perf_counter() - t0
    finally:
        m.FeaturizerBank.__call__ = featurize
    shared_counts = _counts()
    ticks = {k: reg.snapshot().get(k, 0) - v for k, v in before.items()}
    t0 = time.perf_counter()
    naive = [c.fit(x.to(device), y.to(device)) for c in chains]
    torch.cuda.synchronize()
    naive_s = time.perf_counter() - t0
    gaps = []
    for got, want in zip(shared, naive):
        gw = torch.cat([b.reshape(-1) for b in got.nodes[-1].xs])
        ww = torch.cat([b.reshape(-1) for b in want.nodes[-1].xs])
        gaps.append(float((gw - ww).abs().max() / ww.abs().max()))
    print(f"fit_shared: {shared_s:.2f} s for two solvers (the naive fits {naive_s:.2f} s), "
          f"the bank applied {calls} (rows), counters {ticks}, weights against the naive "
          f"fits {gaps} of max|W|; launches {shared_counts}")
    check(calls == [len(train)], f"fit_shared: the shared prefix ran {calls}")
    check(ticks == {"plan_prefix_shared": 1, "plan_featurize_passes_saved": 1},
          f"fit_shared: counters {ticks}")
    check(max(gaps) <= SHARED_TOL, f"fit_shared: weights {gaps} of max|W| from the naive fits")
    res["fit_shared"] = {"s": shared_s, "naive_s": naive_s, "prefix_calls": calls,
                         "counters": ticks, "max_rel_gap": gaps, "launches": shared_counts}
    del shared, naive

    # a K1 node's cost profile on the card and on the CPU, the same rows
    probe = bank(x[:PROFILE_ROWS].to(device))[0][:, :PROFILE_COLS].contiguous()
    node = Pipeline.of(transformer(gram.ata_int8, name="int8_gram"))
    on_card = cost.record_pipeline_profile(node, probe)["00:int8_gram"]
    on_cpu = cost.record_pipeline_profile(node, probe.cpu())["00:int8_gram"]
    want = float(PROFILE_ROWS) * PROFILE_COLS * (PROFILE_COLS + 1)
    print(f"cost profile of a K1 node ({PROFILE_ROWS}x{PROFILE_COLS}): card {on_card}, "
          f"CPU flops {on_cpu['flops']:.6g}")
    check(on_card["flops"] == on_cpu["flops"] == want,
          f"cost: the K1 node reads {on_card['flops']} on the card, {on_cpu['flops']} on the CPU")
    check(on_card["peak_bytes"] is not None and on_cpu["peak_bytes"] is None,
          "cost: allocator bytes should be measured on the card only")
    res["k1_node_profile"] = {"card": on_card, "cpu_flops": on_cpu["flops"]}
    del bank, x, probe
    torch.cuda.empty_cache()
    res["s"] = time.perf_counter() - t_phase
    print(f"phase 40: {res['s']:.1f} s")
    return res


def _trace_kernels(path: str, names) -> tuple:
    """Kernel events in a Chrome trace whose name holds one of ``names``:
    their count and summed device ms."""
    with open(path) as f:
        trace = json.load(f)
    hits = [e for e in trace.get("traceEvents", [])
            if e.get("cat") == "kernel" and any(n in e.get("name", "") for n in names)]
    return len(hits), sum(float(e.get("dur", 0)) for e in hits) / 1e3


def _observed_train(base: str) -> tuple:
    """One ``lm_transformer.main`` at the flagship train width for
    ``OBS_STEPS`` steps under ``KEYSTONE_OBSERVE_DIR=base`` with the
    ``OBS_WINDOW`` profiler window: the run's result, its wall, the
    wrapper counts, ``max_memory_allocated``, the run directory and the
    tracer's record of its window."""
    from keystone_tpu_torch.models import lm_transformer
    from keystone_tpu_torch.observe import events, tracing

    argv = list(TRAIN_ARGV)
    argv[argv.index("--steps") + 1] = str(OBS_STEPS)
    tracers: list = []
    real_close = tracing.StepTracer.close

    def keep(self):
        real_close(self)
        tracers.append(self)

    old = _env(KEYSTONE_OBSERVE_DIR=base, KEYSTONE_PROFILE_STEPS=OBS_WINDOW,
               KEYSTONE_DEVMEM_INTERVAL_S="0", KEYSTONE_TRACE_DIR=None)
    tracing.StepTracer.close = keep
    try:
        events.reset()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        run = lm_transformer.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        run_dir = events.active().run_dir
    finally:
        tracing.StepTracer.close = real_close
        _env(**old)
        events.reset()  # closes the run's log
    (window,) = tracers[0].windows
    return run, wall, counts, peak, run_dir, window


def trace_window_census(runs: int) -> list:
    """``--trace-windows N``: phase 41's observed train run ``N`` times in
    one process, and for each window the tracer's record with its K2
    launches counted by kernel name in the trace: how many device records
    the primer took, and whether any record past it was lost."""
    import tempfile

    from keystone_tpu_torch.core.kernels import BUILD_DIR

    phase_build(_kernels())
    out = []
    os.makedirs(BUILD_DIR, exist_ok=True)
    for i in range(runs):
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            _, wall, counts, _, _, window = _observed_train(os.path.join(tmp, "obs"))
            k2 = _trace_kernels(window["path"], TRACE_NAMES["flash_attention"])[0]
        row = {"run": i, "status": window["status"], "k2_traced": k2,
               "k2_want": TRAIN_CONF["depth"] * window["steps"],
               "k2_launched": counts["flash_attention"], "device_events": window["device_events"],
               "lost": window["lost_device_events"], "primer_lost": window["primer_lost_events"],
               "wall_s": wall}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def phase_observe_tools(device) -> dict:
    """Phase 41: ``lm_transformer.main`` at the flagship train width for
    ``OBS_STEPS`` steps under ``KEYSTONE_OBSERVE_DIR`` with a
    ``KEYSTONE_PROFILE_STEPS`` window of two steps: the window's trace,
    K2 counted by kernel name in it, the device monitor's peak against
    the allocator's, then the report, ``top --once`` and the dashboard
    over the run. The run is taken again, up to ``TRACE_ATTEMPTS`` runs,
    when the tracer records its window as empty or incomplete (a trace
    that lacks the device record of a launch past the session's primer);
    the K2 count is read from a window that the tracer found whole."""
    import contextlib
    import io
    import tempfile
    import threading
    import urllib.request

    from keystone_tpu_torch.core.kernels import BUILD_DIR
    from keystone_tpu_torch.observe import collector, dashboard, events, report, top
    from keystone_tpu_torch.observe.telemetry import STEPS_FILE

    t_phase = time.perf_counter()
    depth = TRAIN_CONF["depth"]
    start, steps = (int(v) for v in OBS_WINDOW.split(":"))
    res: dict = {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        base = os.path.join(tmp, "obs")
        for attempt in range(TRACE_ATTEMPTS):
            run, wall, counts, peak, run_dir, window = _observed_train(base)
            print(f"observe: window {attempt + 1} of {TRACE_ATTEMPTS}: {window['status']}, "
                  f"{window['device_events']} device events, "
                  f"{window['lost_device_events']} lost past the primer, "
                  f"{window['primer_lost_events']} of the primer's lost")
            if window["status"] == "ok":
                break
        check(window["status"] == "ok" and os.path.isfile(window["path"]),
              f"observe: the profile window {window}")
        k2_traced, k2_ms = _trace_kernels(window["path"], TRACE_NAMES["flash_attention"])
        recs = events.read_jsonl(os.path.join(run_dir, STEPS_FILE))
        monitored = recs[-1].get("hbm_peak_bytes")
        print(f"observe: {OBS_STEPS} flagship steps in {wall:.2f} s ({run['tokens_per_s']:.0f} "
              f"tokens/s), launches {counts}; window {window}; K2 in the trace "
              f"{k2_traced} ({k2_ms / max(k2_traced, 1):.4f} device ms each); monitor peak "
              f"{monitored} against max_memory_allocated {peak}")
        check(counts["flash_attention"] == depth * OBS_STEPS,
              f"observe: K2 launched {counts['flash_attention']} times")
        check(k2_traced == depth * steps,
              f"observe: the window's trace holds {k2_traced} K2 launches, want {depth * steps}")
        check(monitored is not None and abs(monitored - peak) <= OBS_PEAK_TOL * peak,
              f"observe: monitor peak {monitored} against {peak}")
        check(len(recs) == OBS_STEPS and all(r.get("source") == "train" for r in recs),
              f"observe: steps.jsonl holds {len(recs)} records")

        # the tools over the run: report, top --once, the dashboard
        text = report.render(run_dir)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            top.main([run_dir, "--once"])
            collector.main([os.path.join(tmp, "collector"), "--watch", base, "--once"])
        screen = buf.getvalue()
        httpd = dashboard.serve(os.path.join(tmp, "collector"), port=0)
        server = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05})
        server.start()
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            with urllib.request.urlopen(url + "/api/summary", timeout=30) as r:
                summary = json.loads(r.read())
            with urllib.request.urlopen(url + "/", timeout=30) as r:
                page = r.read().decode()
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join(10)
        print("observe report (head):\n" + "\n".join(text.splitlines()[:12]))
        check("trace_window" in text or "telemetry" in text.lower() or "steps" in text,
              "observe: the report shows no run telemetry")
        check("loss" in screen.lower(), "observe: top --once shows no loss")
        check(summary.get("series") and "keystone fleet" in page,
              f"observe: the dashboard answered {summary}")
    res.update({"wall_s": wall, "tokens_per_s": run["tokens_per_s"], "launches": counts,
                "window": window, "window_attempts": attempt + 1, "k2_traced": k2_traced,
                "k2_device_ms": k2_ms / max(k2_traced, 1), "monitor_peak_bytes": monitored,
                "max_memory_allocated": peak, "dashboard_series": len(summary["series"]),
                "s": time.perf_counter() - t_phase})
    print(f"phase 41: {res['s']:.1f} s")
    return res


def phase_cli(device) -> dict:
    """Phase 42: ``python -m keystone_tpu_torch`` in subprocesses on the
    card: ``mnist-random-fft --synthetic …`` under ``--observe`` with the
    planner (K1 by ``KEYSTONE_GRAM_OP=int8``) beside ``plan
    mnist-random-fft``, then ``observe`` over the run, whose cost profiles
    carry the card's allocator bytes."""
    import tempfile

    from keystone_tpu_torch.core.kernels import BUILD_DIR

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("KEYSTONE_")}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        obs = os.path.join(tmp, "obs")

        def start(args, extra=None):
            return subprocess.Popen([sys.executable, "-m", "keystone_tpu_torch", *args],
                                    cwd=root, env=dict(env, **(extra or {})), text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)

        t0 = time.perf_counter()
        procs = {
            "mnist": start(["--observe", obs, "mnist-random-fft", *CLI_MNIST_ARGV],
                           {"KEYSTONE_PLAN": "1", "KEYSTONE_GRAM_OP": "int8"}),
            "plan": start(["plan", "mnist-random-fft"]),
        }
        outs = {name: (*p.communicate(timeout=300), p.returncode) for name, p in procs.items()}
        both_s = time.perf_counter() - t0
        for name, (out, err, rc) in outs.items():
            check(rc == 0, f"cli {name}: exit {rc}\n{err[-2000:]}")
        check("MnistRandomFFT: train err" in outs["mnist"][1], "cli mnist: no result line")
        check(f"device: {kind}" in outs["plan"][0], f"cli plan: {outs['plan'][0][:400]}")
        t0 = time.perf_counter()
        report = subprocess.run([sys.executable, "-m", "keystone_tpu_torch", "observe", obs],
                                cwd=root, env=env, capture_output=True, text=True, timeout=120)
        report_s = time.perf_counter() - t0
        check(report.returncode == 0, f"cli observe: exit {report.returncode}\n"
              f"{report.stderr[-2000:]}")
        rows = [line for line in report.stdout.splitlines() if line.startswith("00:FeaturizerBank")]
        print("cli observe:\n" + "\n".join(report.stdout.splitlines()[:8]))
        check(f"device={kind}" in report.stdout and rows and "MB_acc not measured" not in
              report.stdout, "cli observe: the report lacks the card's profiles")
    res = {"mnist_and_plan_s": both_s, "observe_s": report_s,
           "mnist_result": outs["mnist"][1].strip().splitlines()[-1],
           "plan_head": outs["plan"][0].splitlines()[:3], "observe_row": rows[0],
           "s": time.perf_counter() - t_phase}
    print(f"phase 42: {res['s']:.1f} s")
    return res


# --- two processes on one card (phase 43) ------------------------------------
# Two port processes under the run supervisor, both on card 0: the process
# group runs over gloo, because NCCL refuses two ranks on one device.
DP_PROCS = 2
DP_TRAIN_STEPS = 3
DP_F32_DEPTH = 2  # the f32 leg's depth, cut for the time limit
DP_LOSS_RTOL = 1e-5  # f32 losses, relative (tests/test_multihost.py's bar)
DP_GRAD_TOL = 1e-5  # f32 first-step gradients, of max|g| of each leaf
# f32 weights after the steps, of max|w| of a leaf (tests/test_multihost.py's
# bar), against one process that accumulates each step's gradient over the
# same row blocks the processes hold. Against one process on the whole
# batch, f32 summation order alone moves AdamW's first step by more than
# this at the flagship width (reversing one process's batch rows does):
# that distance is measured and printed, and only its RMS is held to 5e-5
DP_WEIGHT_TOL = 5e-5
DP_TIMEOUT_S = 420
# a plan budget below the fused MNIST fit's (D, D) f32 state at D = 16,384
# (1.07 GB): fit_streaming takes its materialized fallback, by row block
DP_FALLBACK_BUDGET_MB = 512
DP_WEIGHTED = "bench_weighted"


def _capture_weights(out: list):
    """Wrap the block solver's finalize so each fitted model's weights
    (D, K) land in ``out`` (a host copy); returns the undo."""
    from keystone_tpu_torch.ops.linear import BlockLeastSquaresEstimator

    real = BlockLeastSquaresEstimator.fit_stats_finalize

    def finalize(self, state, widths=None):
        model = real(self, state, widths)
        out.append(torch.cat(list(model.xs)).detach().float().cpu())
        return model

    BlockLeastSquaresEstimator.fit_stats_finalize = finalize
    return lambda: setattr(BlockLeastSquaresEstimator, "fit_stats_finalize", real)


def _dp_train(device, conf, compute_dtype, steps):
    """``train`` at the flagship shape from the seed-0 weights: (model,
    losses, wall s). In a process group it runs data-parallel."""
    from keystone_tpu_torch.models.lm.train import synthetic_corpus, train

    model = _train_model(device, conf, TRAIN_SEQ, compute_dtype=compute_dtype)
    corpus = synthetic_corpus(200_000, conf["vocab"], seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, losses = train(model, corpus, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                          lr=TRAIN_LR, seed=0)
    torch.cuda.synchronize()
    return model, losses, time.perf_counter() - t0


def _first_grads(device, rows=slice(None)) -> list:
    """Every leaf's gradient of the f32 leg's first step from the seed-0
    weights, on ``rows`` of its batch; in a process group, all-reduced to
    the global mean as the data-parallel step does it."""
    from keystone_tpu_torch.models.lm.losses import next_token_loss
    from keystone_tpu_torch.models.lm.train import _step_batch, allreduce_mean_, synthetic_corpus

    conf = dict(TRAIN_CONF, depth=DP_F32_DEPTH)
    model = _train_model(device, conf, TRAIN_SEQ, compute_dtype="float32")
    corpus = synthetic_corpus(200_000, conf["vocab"], seed=0)
    toks = torch.from_numpy(_step_batch(corpus, 0, 0, TRAIN_BATCH, TRAIN_SEQ)[rows].copy())
    params = model.leaves()
    for p in params:
        p.requires_grad_(True)
    loss = next_token_loss(model, toks.to(device))
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    allreduce_mean_(grads, loss.detach())
    return [g.detach() for g in grads]


def _one_process_train(device, rows, parts: int = 1) -> tuple:
    """The f32 leg in one process, each step's batch taken in ``rows``
    order and its gradient accumulated over ``parts`` equal row blocks
    (the sum over blocks in block order, then divided by ``parts``, as
    the data-parallel step's all-reduce does it): (leaves, losses)."""
    from keystone_tpu_torch.models.lm.losses import next_token_loss
    from keystone_tpu_torch.models.lm.train import _step_batch, make_optimizer, synthetic_corpus
    from keystone_tpu_torch.parallel.multihost import row_block

    conf = dict(TRAIN_CONF, depth=DP_F32_DEPTH)
    model = _train_model(device, conf, TRAIN_SEQ, compute_dtype="float32")
    corpus = synthetic_corpus(200_000, conf["vocab"], seed=0)
    optimizer = make_optimizer(TRAIN_LR, steps=DP_TRAIN_STEPS)
    state = optimizer.init(model.leaves())
    params = model.leaves()
    for p in params:
        p.requires_grad_(True)
    losses = []
    for i in range(DP_TRAIN_STEPS):
        toks = torch.from_numpy(_step_batch(corpus, 0, i, TRAIN_BATCH, TRAIN_SEQ)[rows].copy())
        toks = toks.to(device)
        grads, loss_sum = None, None
        for part in range(parts):
            lo, hi = row_block(TRAIN_BATCH, part, parts)
            loss = next_token_loss(model, toks[lo:hi])
            g = torch.autograd.grad(loss, params, allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x for x, p in zip(g, params)]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        optimizer.update([g.div_(parts) for g in grads], state, params)
        losses.append(float(loss_sum / parts))
    return [t.detach() for t in params], losses


def _leaf_dist(got, want) -> tuple:
    """(max over leaves of max|Δ| / max|want|, of RMS(Δ) / max|want|)."""
    worst = rms = 0.0
    for a, b in zip(got, want):
        d = a.to(b.device).float() - b.float()
        m = float(b.abs().max()) or 1.0
        worst = max(worst, float(d.abs().max()) / m)
        rms = max(rms, float(d.pow(2).mean().sqrt()) / m)
    return worst, rms


def f32_reference(device, procs: int) -> dict:
    """The f32 leg in one process, for ``procs`` processes to be held
    against: its losses and leaves on the whole batch, its first-step
    gradients, the leaves of a run accumulating over ``procs`` row blocks,
    and how far a run with reversed batch rows lies from the plain one."""
    model, losses, wall = _dp_train(device, dict(TRAIN_CONF, depth=DP_F32_DEPTH), "float32",
                                    DP_TRAIN_STEPS)
    leaves = [t.detach() for t in model.leaves()]
    del model
    grads = _first_grads(device)
    accumulated, _ = _one_process_train(device, slice(None), procs)
    floor = _leaf_dist(_one_process_train(device, slice(None, None, -1))[0], leaves)
    torch.cuda.empty_cache()
    return {"losses": losses, "leaves": leaves, "grads": grads, "accumulated": accumulated,
            "floor": floor, "wall_s": wall}


def check_f32_leg(ref: dict, ranks_losses: list, leaves: list, grads: list, procs: int) -> dict:
    """Hold a data-parallel f32 leg against the one-process ``ref``."""
    loss_err = max(abs(a - b) / abs(b) for got in ranks_losses for a, b in zip(got, ref["losses"]))
    grad_err = _leaf_dist(grads, ref["grads"])[0]
    w_max, w_rms = _leaf_dist(leaves, ref["accumulated"])
    plain_max, plain_rms = _leaf_dist(leaves, ref["leaves"])
    print(f"  f32 at depth {DP_F32_DEPTH}, {DP_TRAIN_STEPS} steps, {procs} processes against one "
          f"({ref['wall_s']:.2f} s): losses {ranks_losses[0]} vs {ref['losses']} "
          f"({loss_err:.2e} relative); first-step gradients within {grad_err:.2e} of max|g|; "
          f"weights within {w_max:.2e} of max|w| (RMS {w_rms:.2e}) of one process accumulating "
          f"over the same {procs} row blocks, {plain_max:.2e} (RMS {plain_rms:.2e}) of one "
          f"process on the whole batch, where reversing that run's rows moves it "
          f"{ref['floor'][0]:.2e} (RMS {ref['floor'][1]:.2e})")
    check(all(x == ranks_losses[0] for x in ranks_losses), "the ranks' f32 losses differ")
    check(loss_err <= DP_LOSS_RTOL, f"{procs} processes f32 losses {loss_err:.2e}")
    check(grad_err <= DP_GRAD_TOL, f"{procs} processes f32 first-step gradients {grad_err:.2e}")
    check(w_max <= DP_WEIGHT_TOL, f"{procs} processes f32 weights {w_max:.2e}")
    check(max(w_rms, plain_rms) <= DP_WEIGHT_TOL, f"{procs} processes f32 weights RMS "
          f"{w_rms:.2e}, {plain_rms:.2e}")
    return {"loss_rel_err": loss_err, "grad_err": grad_err, "weight_err": w_max,
            "weight_rms_err": w_rms, "weight_err_whole_batch": plain_max,
            "weight_rms_err_whole_batch": plain_rms, "reversed_rows_floor": ref["floor"][0],
            "reversed_rows_rms": ref["floor"][1],
            "losses": ranks_losses[0], "one_process_losses": ref["losses"]}


def dp_f32_leg(device, out_dir: str, rank: int) -> dict:
    """A process's f32 leg: its share of the first step's gradients
    all-reduced, then the three steps of ``train``; rank 0 saves both."""
    from keystone_tpu_torch.parallel.multihost import row_block

    grads = _first_grads(device, slice(*row_block(TRAIN_BATCH)))
    model, losses, _ = _dp_train(device, dict(TRAIN_CONF, depth=DP_F32_DEPTH), "float32",
                                 DP_TRAIN_STEPS)
    if rank == 0:
        torch.save({"grads": [g.cpu() for g in grads],
                    "leaves": [t.detach().cpu() for t in model.leaves()]},
                   os.path.join(out_dir, "f32.pt"))
    del model, grads
    torch.cuda.empty_cache()
    return {"losses": losses}


def weighted_rank_leg(device, out_dir: str, name: str) -> dict:
    """This process's part of the weighted fit of ``WEIGHTED_BENCH[name]``
    as a global batch: its row block through ``global_batch_from_local``,
    one f32 fit, its rows and seconds, and the all-reduces it made (count
    and the largest in bytes: a class chunk's Grams); then the same fit
    in float64 and its seconds. Rank 0 writes both models to
    ``weighted.pt`` under ``out_dir``."""
    from keystone_tpu_torch.parallel import multihost

    shape = WEIGHTED_BENCH[name]
    x, y, _ = weighted_problem(**shape)
    lo, hi = multihost.row_block(shape["n"])
    x_rank = x[lo:hi].clone()
    rows = multihost.global_batch_from_local(x_rank)
    labels = y[lo:hi].to(device)
    del x, y
    sizes: list = []
    real = multihost.all_reduce_

    def counted(t, *a, **kw):
        sizes.append(t.numel() * t.element_size())
        return real(t, *a, **kw)

    multihost.all_reduce_ = counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        model = weighted_estimator(shape).fit(rows, labels)
        torch.cuda.synchronize()
    finally:
        multihost.all_reduce_ = real
    fit_s = time.perf_counter() - t0
    saved = {"w": torch.cat(list(model.xs)).cpu(), "b": model.b.cpu()}
    del model, rows
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = weighted_estimator(shape, torch.float64).fit(
        multihost.global_batch_from_local(x_rank.double()), labels.double())
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    if multihost.process_index() == 0:
        torch.save({**saved, "w64": torch.cat(list(model.xs)).cpu(), "b64": model.b.cpu()},
                   os.path.join(out_dir, "weighted.pt"))
    del model, labels, x_rank
    torch.cuda.empty_cache()
    return {"rows": hi - lo, "fit_s": fit_s, "f64_fit_s": f64_s, "all_reduces": len(sizes),
            "max_all_reduce_bytes": max(sizes, default=0), "all_reduce_bytes": sum(sizes)}


def fallback_rank_leg() -> dict:
    """MNIST's streamed fit under a plan budget below its fused state
    (``DP_FALLBACK_BUDGET_MB``): ``fit_streaming``'s materialized fallback
    on this process's row block. Its rows (``plan_fit_materialized_rows``),
    seconds, the fallback's reason and the errors."""
    from keystone_tpu_torch.models import mnist_random_fft
    from keystone_tpu_torch.observe import metrics

    counter = metrics.get_registry().counter("plan_fit_materialized_rows")
    before = counter.value
    os.environ.update(KEYSTONE_PLAN="1", KEYSTONE_PLAN_BUDGET_MB=str(DP_FALLBACK_BUDGET_MB))
    os.environ.pop("KEYSTONE_GRAM_OP", None)
    try:
        run = mnist_random_fft.main(list(MAIN_ARGV))
    finally:
        os.environ.pop("KEYSTONE_PLAN_BUDGET_MB")
    fallback = next((d for d in run["fit_decisions"] if d["action"] == "fit_fallback"), {})
    torch.cuda.empty_cache()
    return {"rows": counter.value - before, "reason": fallback.get("reason"),
            **{k: run[k] for k in ("n_train", "train_error", "test_error", "fit_s", "total_s")}}


def dp_worker(out_dir: str) -> None:
    """``--dp-worker DIR``: one process of phase 43, under the supervisor's
    environment. Joins the group over gloo on card 0, runs the MNIST main
    path's int8 fit on its rows, the weighted fit of a global batch, the
    streamed fit's materialized fallback, then the f32 and bf16 train
    legs, and writes its record (and, on rank 0, the weights) under
    ``DIR``."""
    from keystone_tpu_torch.models import mnist_random_fft
    from keystone_tpu_torch.ops import gram
    from keystone_tpu_torch.parallel import multihost

    # NCCL refuses two ranks on one device: both processes share card 0
    device = multihost.initialize(backend="gloo", device="cuda:0")
    rank, world = multihost.process_index(), multihost.process_count()
    res = {"rank": rank, "world": world, "device": str(device), "backend": "gloo"}

    weights: list = []
    undo = _capture_weights(weights)
    os.environ.update(KEYSTONE_PLAN="1", KEYSTONE_GRAM_OP="int8")
    gram.INT8_GRAM.launches = 0
    try:
        run = mnist_random_fft.main(list(MAIN_ARGV))
    finally:
        undo()
    lo, hi = multihost.row_block(run["n_train"])
    rows = min(hi, run["n_train"]) - lo
    rank_chunk = run["fit_chunk_size"] // world
    res["mnist"] = {"k1_launches": gram.INT8_GRAM.launches, "rows": rows,
                    "rank_chunk": rank_chunk, "fit_chunks": -(-rows // rank_chunk),
                    **{k: run[k] for k in ("train_error", "test_error", "fit_s", "total_s",
                                           "processes", "fit_chunk_size")}}
    if rank == 0:
        torch.save({"pred": torch.from_numpy(run["test_predictions"]), "w": weights[-1]},
                   os.path.join(out_dir, "mnist.pt"))
    del run
    torch.cuda.empty_cache()
    res["weighted"] = weighted_rank_leg(device, out_dir, DP_WEIGHTED)
    res["fallback"] = fallback_rank_leg()

    res["f32"] = dp_f32_leg(device, out_dir, rank)
    _dp_train(device, TRAIN_CONF, "bfloat16", 1)  # the first step warms the allocator
    _zero_counts()
    model, losses, wall = _dp_train(device, TRAIN_CONF, "bfloat16", DP_TRAIN_STEPS)
    res["bf16"] = {"losses": losses, "launches": _counts(),
                   "ms_per_step": wall * 1e3 / DP_TRAIN_STEPS,
                   "peak_bytes": torch.cuda.max_memory_allocated()}
    del model
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    multihost.shutdown()


def check_weighted_ranks(name: str, ranks: list, refs: dict, saved: dict) -> dict:
    """Print each rank's part of the weighted fit of ``WEIGHTED_BENCH[name]``
    across processes and hold rank 0's models against the one-process
    fits (:func:`check_weighted`)."""
    label = f"weighted {name}"
    n = sum(r["rows"] for r in ranks)
    for i, r in enumerate(ranks):
        print(f"  rank {i} {label}: {r['rows']} rows, fit {r['fit_s']:.3f} s (float64 "
              f"{r['f64_fit_s']:.3f} s), {r['all_reduces']} "
              f"all-reduces, the largest {r['max_all_reduce_bytes'] / 1e6:.1f} MB (a class "
              f"chunk's Grams), {r['all_reduce_bytes'] / 1e6:.1f} MB in all")
    check(all(r["rows"] == ranks[0]["rows"] for r in ranks) and n == ranks[0]["rows"] * len(ranks),
          f"{label}: rows {[r['rows'] for r in ranks]}")
    out = check_weighted(f"{label} over {len(ranks)} processes", name, refs,
                         (saved["w"], saved["b"]), (saved["w64"], saved["b64"]))
    return {**out, "ranks": ranks}


def check_fallback_ranks(ranks: list, procs: int) -> dict:
    """Print and hold each rank's streamed fit that fell back to the
    materialized fit: the plan's reason, the rank's own row block
    featurized, the test error."""
    for i, r in enumerate(ranks):
        print(f"  rank {i} MNIST fallback ({r['reason']}, budget {DP_FALLBACK_BUDGET_MB} MB): "
              f"{r['rows']} rows featurized for the fit, fit {r['fit_s']:.2f} s, run "
              f"{r['total_s']:.2f} s, test error {r['test_error']:.4%}")
        check(r["reason"] == "state_over_budget", f"rank {i}: fallback {r['reason']}")
        check(r["rows"] == -(-r["n_train"] // procs), f"rank {i}: featurized {r['rows']} rows")
        check(r["test_error"] <= MAX_TEST_ERROR, f"rank {i}: fallback test error")
    return {"budget_mb": DP_FALLBACK_BUDGET_MB, "ranks": ranks}


def phase_two_processes(device, res8: dict, w8) -> dict:
    """Phase 43: two processes on one card through the supervisor
    (``supervise --procs 2 -- chip_smoke.py --dp-worker``), each joining
    the process group over gloo on card 0. MNIST's streamed int8 fit at
    the main path's size split 30,000 / 30,000 (K1 once a fit chunk on each
    rank, test error ≤ 1 %, ≥ 99.5 % of test predictions as phase 4's
    one-process int8 fit, the weights' distance printed); three flagship
    train steps split 4 / 4 in f32 at depth 2 against one process from the
    same weights (losses 1e-5 relative, first-step gradients 1e-5 of
    max|g|, weights within 5e-5 of max|w| of one process accumulating over
    the same row blocks, their distance to one process on the whole batch
    printed beside what reversing its rows moves it), and in bf16 at depth
    8 (K2 8 a step on each rank, a falling loss, ms a step)."""
    import tempfile

    from keystone_tpu_torch.core.kernels import BUILD_DIR

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    weighted_refs = weighted_references(device, DP_WEIGHTED)
    ref = f32_reference(device, DP_PROCS)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("KEYSTONE_", "KST_"))}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as out:
        t0 = time.perf_counter()
        sup = subprocess.run(
            [sys.executable, "-m", "keystone_tpu_torch", "supervise", "--procs", str(DP_PROCS),
             "--max-restarts", "0", "--grace", "5", "--",
             sys.executable, os.path.abspath(__file__), "--dp-worker", out],
            cwd=root, env=env, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
        pair_s = time.perf_counter() - t0
        check(sup.returncode == 0, f"two processes: supervise exit {sup.returncode}\n"
              f"{sup.stderr[-3000:]}")
        ranks = []
        for r in range(DP_PROCS):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        mnist = torch.load(os.path.join(out, "mnist.pt"))
        f32_saved = torch.load(os.path.join(out, "f32.pt"))
        weighted_saved = torch.load(os.path.join(out, "weighted.pt"))
    print("two processes on one card: gloo (NCCL refuses two ranks on one device); "
          f"{pair_s:.1f} s for the pair under the supervisor")
    for r in ranks:
        m = r["mnist"]
        print(f"  rank {r['rank']}/{r['world']} on {r['device']}: MNIST {m['rows']} rows, K1 "
              f"{m['k1_launches']} for {m['fit_chunks']} fit chunks of {m['rank_chunk']}, test "
              f"error {m['test_error']:.4%}, fit {m['fit_s']:.2f} s, run {m['total_s']:.2f} s; "
              f"bf16 K2 {r['bf16']['launches']['flash_attention']}, "
              f"{r['bf16']['ms_per_step']:.1f} ms a step, losses {r['bf16']['losses']}")
        check(r["world"] == DP_PROCS and m["processes"] == DP_PROCS, f"rank record {r}")
        check(m["k1_launches"] == m["fit_chunks"], f"rank {r['rank']}: K1 {m['k1_launches']} "
              f"launches for {m['fit_chunks']} fit chunks")
        check(m["test_error"] <= MAX_TEST_ERROR, f"two processes: test error {m['test_error']}")
        want_k2 = TRAIN_CONF["depth"] * DP_TRAIN_STEPS
        check(r["bf16"]["launches"]["flash_attention"] == want_k2,
              f"rank {r['rank']}: K2 {r['bf16']['launches']} for {want_k2}")
        losses = r["bf16"]["losses"]
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"rank {r['rank']}: bf16 losses {losses}")
    check(sum(r["mnist"]["rows"] for r in ranks) == res8["n_train"], "rows split")
    agree = float((mnist["pred"].numpy() == res8["test_predictions"]).mean())
    w_dist = float((mnist["w"] - w8).abs().max() / w8.abs().max())
    print(f"  MNIST int8, two processes against one: test predictions agree on {agree:.4%}, "
          f"weights {w_dist:.3e} of max|W| apart")
    check(agree >= MIN_AGREEMENT, f"two processes: agreement {agree:.4%}")
    weighted = check_weighted_ranks(DP_WEIGHTED, [r["weighted"] for r in ranks], weighted_refs,
                                    weighted_saved)
    fallback = check_fallback_ranks([r["fallback"] for r in ranks], DP_PROCS)
    f32 = check_f32_leg(ref, [r["f32"]["losses"] for r in ranks], f32_saved["leaves"],
                        f32_saved["grads"], DP_PROCS)
    res = {"backend": "gloo", "pair_s": pair_s,
           "ranks": [{"rank": r["rank"], "mnist": r["mnist"],
                      "bf16": {k: r["bf16"][k] for k in ("losses", "ms_per_step", "peak_bytes")},
                      "k2_launches": r["bf16"]["launches"]["flash_attention"]} for r in ranks],
           "mnist_agreement": agree, "mnist_weight_dist": w_dist, "f32": f32,
           "weighted": weighted, "fallback": fallback,
           "s": time.perf_counter() - t_phase}
    print(f"phase 43: {res['s']:.1f} s")
    return res


# --- phase 44: tensor, pipeline and sequence parallelism (one card)
PAR_N = 4  # model positions and pipeline stages of the one-process meshes
PAR_F32_DEPTH = 2  # the TP and pp × dp × tp f32 legs, cut for the time limit
PP_F32_DEPTH = 4  # the GPipe f32 leg: four stages take a depth divisible by 4
PP_MICRO = 4
PAR_STEPS = DP_TRAIN_STEPS
SP_PROCS = 2
SP_LOSS_RTOL = 1e-5  # two processes' scoring losses against one process


def _par_model(device, depth: int, compute_dtype: str):
    return _train_model(device, dict(TRAIN_CONF, depth=depth), TRAIN_SEQ,
                        compute_dtype=compute_dtype)


def _par_batches(steps: int, rows=slice(None)) -> list:
    """The flagship train batches of steps 0.. (seed 0), rows ``rows``."""
    from keystone_tpu_torch.models.lm.train import _step_batch, synthetic_corpus

    corpus = synthetic_corpus(200_000, TRAIN_CONF["vocab"], seed=0)
    return [torch.from_numpy(_step_batch(corpus, 0, i, TRAIN_BATCH, TRAIN_SEQ)[rows].copy())
            for i in range(steps)]


def _par_layout(device, name: str, model) -> tuple:
    """(model, loss of (model, tokens), step factory of an optimizer, K2
    launches a step per block) for a layout on one card named ``PAR_N``
    times (8 for the 3-axis mesh)."""
    from keystone_tpu_torch.models.lm import (
        make_pp_train_step,
        make_train_step,
        next_token_loss,
        next_token_loss_pp,
        shard_params,
    )
    from keystone_tpu_torch.parallel import Mesh, create_mesh

    if name in ("plain", "tp"):
        per_block = 1
        if name == "tp":
            model = shard_params(model, create_mesh(data=1, model=PAR_N, devices=[device] * PAR_N))
            per_block = PAR_N
        return model, next_token_loss, make_train_step, per_block
    if name == "pp":
        mesh = create_mesh(data=1, model=PAR_N, devices=[device] * PAR_N)
        kw = dict(n_micro=PP_MICRO)
        per_block = PP_MICRO
    else:  # pp × dp × tp on (2, 2, 2)
        mesh = Mesh([[[device] * 2] * 2] * 2, ("pipe", "data", "model"))
        model = shard_params(model, mesh)
        kw = dict(n_micro=2, axis="pipe", data_axis="data")
        per_block = 2 * 2 * 2  # microbatches × data rows × model positions
    return (model, lambda m, t: next_token_loss_pp(m, t, mesh, **kw),
            lambda opt: make_pp_train_step(opt, mesh, **kw), per_block)


def _par_leg(device, name: str, depth: int, batches) -> dict:
    """A layout's f32 leg from the seed-0 weights: every leaf's first-step
    gradient, then ``len(batches)`` steps; K2's launches over the steps
    held to the count the layout implies."""
    from keystone_tpu_torch.models.lm import make_optimizer

    model, loss_fn, make_step, per_block = _par_layout(
        device, name, _par_model(device, depth, "float32"))
    params = model.leaves()
    for p in params:
        p.requires_grad_(True)
    grads = torch.autograd.grad(loss_fn(model, batches[0].to(device)), params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g.detach() for g, p in zip(grads, params)]
    optimizer = make_optimizer(TRAIN_LR, steps=PAR_STEPS)
    state = optimizer.init(params)
    step = make_step(optimizer)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses = []
    for toks in batches:
        model, state, loss = step(model, state, toks.to(device))
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    want = depth * per_block * len(batches)
    check(counts["flash_attention"] == want and counts["flash_attention_step"] == 0,
          f"{name} f32 launches {counts}, want K2 {want}")
    return {"losses": [float(x) for x in losses], "leaves": [p.detach() for p in params],
            "grads": grads, "k2_launches": counts["flash_attention"],
            "k2_per_step": depth * per_block, "ms_per_step": wall * 1e3 / len(batches)}


def check_par_leg(label: str, got: dict, ref: dict, floor: tuple | None = None) -> dict:
    """Hold a parallel f32 leg against the one-process step from the same
    weights: losses within 1e-5 relative, first-step gradients within 1e-5
    of max|g|, the weights' RMS distance within 5e-5 of max|w| as
    ``check_f32_leg`` holds the whole-batch run; their max distance is
    printed beside the f32 floor (what reversing the batch rows moves one
    process's weights: AdamW's first step is lr·sign(g) where g sits at
    rounding level, ROADMAP §C)."""
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    grad_err = _leaf_dist(got["grads"], ref["grads"])[0]
    w_max, w_rms = _leaf_dist(got["leaves"], ref["leaves"])
    floor_s = ("" if floor is None else
               f", whose reversed rows move it {floor[0]:.2e} (RMS {floor[1]:.2e})")
    print(f"  {label}: losses {got['losses']} vs {ref['losses'][:len(got['losses'])]} "
          f"({loss_err:.2e} relative); first-step gradients within {grad_err:.2e} of max|g|; "
          f"weights {w_max:.2e} of max|w| (RMS {w_rms:.2e}) from one process{floor_s}; K2 "
          f"{got['k2_launches']} ({got['k2_per_step']} a step), {got['ms_per_step']:.1f} ms a "
          "step")
    check(loss_err <= DP_LOSS_RTOL, f"{label} f32 losses {loss_err:.2e}")
    check(grad_err <= DP_GRAD_TOL, f"{label} f32 first-step gradients {grad_err:.2e}")
    check(w_rms <= DP_WEIGHT_TOL, f"{label} f32 weights RMS {w_rms:.2e}")
    return {"loss_rel_err": loss_err, "grad_err": grad_err, "weight_err": w_max,
            "weight_rms_err": w_rms, "reversed_rows_floor": floor and floor[0],
            "reversed_rows_rms": floor and floor[1], "losses": got["losses"],
            "one_process_losses": ref["losses"], "k2_launches": got["k2_launches"],
            "k2_per_step": got["k2_per_step"], "ms_per_step": got["ms_per_step"]}


def par_reference(device, depth: int, steps: int = PAR_STEPS) -> tuple:
    """The one-process f32 leg at ``depth`` and the f32 floor beside it:
    (leg, (max, RMS) distance of the same run on reversed batch rows)."""
    ref = _par_leg(device, "plain", depth, _par_batches(steps))
    rev = _par_leg(device, "plain", depth, _par_batches(steps, slice(None, None, -1)))
    return ref, _leaf_dist(rev["leaves"], ref["leaves"])


def tp_bf16_leg(device, mesh, steps: int = PAR_STEPS) -> dict:
    """``train`` of the bf16 model at depth 8 sharded over ``mesh``'s model
    axis (a first call warms the allocator): losses, K2, ms a step and peak
    memory."""
    from keystone_tpu_torch.models.lm import shard_params, synthetic_corpus, train

    corpus = synthetic_corpus(200_000, TRAIN_CONF["vocab"], seed=0)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, seed=0, mesh=mesh)
    bf16 = lambda: shard_params(_par_model(device, TRAIN_CONF["depth"], "bfloat16"), mesh)  # noqa: E731
    train(bf16(), corpus, steps=1, **kw)
    model = bf16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    model, losses = train(model, corpus, steps=steps, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"losses": losses, "launches": _counts(), "ms_per_step": wall * 1e3 / steps,
            "peak_bytes": torch.cuda.max_memory_allocated(), "model": model}


def replicas_equal(tensors) -> bool:
    """True when ``tensors`` hash the same on every rank of the group."""
    import hashlib

    from keystone_tpu_torch.parallel import multihost

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    mine = torch.tensor([int.from_bytes(h.digest()[:7], "little")], dtype=torch.int64)
    return all(torch.equal(mine, o.cpu()) for o in multihost.all_gather_meta(mine))


def scoring_model(device):
    """Phases 12-13's scoring model (seed 0), its held-out stream and the
    ``evaluate_perplexity`` arguments."""
    from keystone_tpu_torch.models.lm import TransformerLM, synthetic_corpus

    model = TransformerLM.create(**SCORE_CONF, compute_dtype="bfloat16", device=device,
                                 generator=torch.Generator(device=device).manual_seed(0))
    held = synthetic_corpus(SCORE_WINDOWS * (SCORE_SEQ + 1), SCORE_CONF["vocab"], seed=7)
    return model, held, dict(seq=SCORE_SEQ, batch=SCORE_BATCH, logit_chunk=SCORE_CHUNK)


def score_modes(model, mesh, held, kw) -> dict:
    """Ring and Ulysses scoring of ``model`` over ``mesh`` (one window
    warms): loss, launches, ms a forward."""
    from keystone_tpu_torch.evaluation import evaluate_perplexity

    forwards = -(-SCORE_WINDOWS // SCORE_BATCH)
    out = {}
    for mode in ("ring", "ulysses"):
        m = model.replace(seq_mode=mode, mesh=mesh)
        evaluate_perplexity(m, held[: SCORE_BATCH * (SCORE_SEQ + 1)], **kw)
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        ev = evaluate_perplexity(m, held, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[mode] = {"loss": ev["loss"], "launches": _counts(),
                     "ms_per_forward": wall * 1e3 / forwards}
    return out


def dist_f32_leg(device, mesh, out_dir: str, tag: str, steps: int = PAR_STEPS,
                 pp: dict | None = None) -> dict:
    """A process's f32 leg at depth 2 sharded over ``mesh`` across
    processes: the first step's gradients (averaged over the data axis,
    gathered whole over the model axis), then ``steps`` steps of the
    data-parallel step on its data row's rows; rank 0 saves the whole
    gradients and leaves as ``<tag>.pt``. ``pp`` (``gpipe``'s keyword
    arguments) takes the pipeline-parallel loss and step instead, TP
    inside the stages, on the whole batch (the pipe splits it over the
    data axis itself)."""
    from keystone_tpu_torch.models.lm import (
        make_optimizer,
        make_pp_train_step,
        make_train_step,
        next_token_loss,
        next_token_loss_pp,
        shard_params,
        unshard_params,
    )
    from keystone_tpu_torch.models.lm.sharding import gather_leaf, leaf_dims
    from keystone_tpu_torch.models.lm.train import allreduce_mean_
    from keystone_tpu_torch.parallel import multihost

    n_data = mesh.shape["data"]
    tp = shard_params(_par_model(device, PAR_F32_DEPTH, "float32"), mesh)
    rows = slice(None) if pp is not None else slice(
        *multihost.row_block(TRAIN_BATCH, mesh.coords()["data"], n_data))
    batches = _par_batches(steps, rows)
    params = tp.leaves()
    for p in params:
        p.requires_grad_(True)
    if pp is None:
        loss = next_token_loss(tp, batches[0].to(device))
    else:
        loss = next_token_loss_pp(tp, batches[0].to(device), mesh, **pp)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    if n_data > 1 and pp is None:
        allreduce_mean_(grads, loss.detach(), mesh.axis_group("data"))
    grads = [gather_leaf(tp, g, d).cpu() for g, d in zip(grads, leaf_dims(tp))]
    optimizer = make_optimizer(TRAIN_LR, steps=PAR_STEPS)
    state = optimizer.init(params)
    if pp is None:
        step = make_train_step(optimizer, data_parallel=n_data > 1)
    else:
        step = make_pp_train_step(optimizer, mesh, **pp)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses = []
    for toks in batches:
        tp, state, loss = step(tp, state, toks.to(device))
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    leaves = [t.detach().cpu() for t in unshard_params(tp).leaves()]
    if multihost.process_index() == 0:
        torch.save({"grads": grads, "leaves": leaves}, os.path.join(out_dir, f"{tag}.pt"))
    return {"losses": [float(x) for x in losses], "launches": counts,
            "ms_per_step": wall * 1e3 / steps, "replicas_equal": replicas_equal(leaves)}


def load_dist_f32_leg(out_dir: str, tag: str, ranks: list, per_step: int) -> dict:
    """Rank 0's saved leg of :func:`dist_f32_leg` for :func:`check_par_leg`,
    after checking that every rank computed the same losses and holds the
    same parameters."""
    losses = [r[tag]["losses"] for r in ranks]
    check(all(x == losses[0] for x in losses), f"{tag}: the ranks' losses differ: {losses}")
    check(all(r[tag]["replicas_equal"] for r in ranks), f"{tag}: parameters differ across ranks")
    saved = torch.load(os.path.join(out_dir, f"{tag}.pt"))
    k2 = ranks[0][tag]["launches"]["flash_attention"]
    check(k2 == per_step * len(losses[0]), f"{tag}: K2 {k2} for {per_step} a step")
    return {"losses": losses[0], "leaves": saved["leaves"], "grads": saved["grads"],
            "k2_launches": k2, "k2_per_step": per_step,
            "ms_per_step": ranks[0][tag]["ms_per_step"]}


def sp_worker(out_dir: str) -> None:
    """``--sp-worker DIR``: one process of phase 44's pair on card 0 over
    gloo: ring and Ulysses scoring over the two processes, then one f32
    TP step over a model axis of two."""
    from keystone_tpu_torch.models.lm import (
        make_optimizer,
        make_train_step,
        next_token_loss,
        shard_params,
        unshard_params,
    )
    from keystone_tpu_torch.models.lm.sharding import gather_leaf, leaf_dims
    from keystone_tpu_torch.parallel import create_mesh, multihost

    device = multihost.initialize(backend="gloo", device="cuda:0")
    rank = multihost.process_index()
    model, held, kw = scoring_model(device)
    res = {"rank": rank, "scoring": score_modes(model, create_mesh(), held, kw),
           "scoring_replicas_equal": replicas_equal(model.leaves())}
    del model
    torch.cuda.empty_cache()

    res["tp"] = dist_f32_leg(device, create_mesh(data=1, model=SP_PROCS), out_dir, "tp", steps=1)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    multihost.shutdown()


def parallel_f32_legs(device) -> dict:
    """Phase 44's f32 legs on one card: TP and pp × dp × tp at depth 2 and
    GPipe at depth 4 against the unsharded step from the same weights, the
    tiled f32 kernel's launches counted over them (the references' too)."""
    torch.cuda.empty_cache()
    res = {}
    with tiled_f32_tally() as tally:
        ref2, floor2 = par_reference(device, PAR_F32_DEPTH)
        for name in ("tp", "pp_dp_tp"):
            got = _par_leg(device, name, PAR_F32_DEPTH, _par_batches(PAR_STEPS))
            res[name] = check_par_leg(f"{name} f32 depth {PAR_F32_DEPTH}", got, ref2, floor2)
            del got
        ref4, floor4 = par_reference(device, PP_F32_DEPTH)
        got = _par_leg(device, "pp", PP_F32_DEPTH, _par_batches(PAR_STEPS))
        res["pp"] = check_par_leg(f"GPipe f32 depth {PP_F32_DEPTH}, {PAR_N} stages, "
                                  f"n_micro {PP_MICRO}", got, ref4, floor4)
        del got, ref4, ref2
    torch.cuda.empty_cache()
    res["tiled_f32_launches"] = tally.launches
    print(f"  phase 44's f32 legs: {tally.launches} tiled f32 launches")
    return res


def f32_legs_summary(equiv: dict, train_equiv: dict, par_f32: dict) -> dict:
    """The tiled f32 kernel in the f32 legs: its launches and each leg's
    step, in ms."""
    legs = {"equivalence_prefill": (equiv["tiled_f32_launches"], equiv["prefill_ms"])}
    for route in ("dense_route", "blockwise_route"):
        r = train_equiv[route]
        legs[f"train_equivalence_{route}"] = (r["tiled_f32_launches"], r["ms"])
    for name in ("tp", "pp_dp_tp", "pp"):
        legs[f"parallel_{name}_step"] = (None, par_f32[name]["ms_per_step"])
    out = {"tiled_f32_launches": {"equivalence": equiv["tiled_f32_launches"],
                                  "train_equivalence": sum(train_equiv[r]["tiled_f32_launches"]
                                                           for r in ("dense_route",
                                                                     "blockwise_route")),
                                  "parallel": par_f32["tiled_f32_launches"]},
           "ms": {name: ms for name, (_, ms) in legs.items()}}
    for name, (launches, ms) in legs.items():
        print(f"  {name}: {ms:.2f} ms"
              + (f", {launches} tiled f32 launches" if launches is not None else ""))
    print(f"tiled f32 launches in the f32 legs: {json.dumps(out['tiled_f32_launches'])}")
    return out


def phase_parallel(device) -> dict:
    """Phase 44: tensor, pipeline and sequence parallelism on one card.
    (a) One process, meshes naming the card 4 times (8 for the 3-axis one),
    at the flagship width in f32 against the unsharded step from the same
    weights: TP (model 4) and pp × dp × tp on (2, 2, 2) at depth 2, GPipe
    (4 stages, n_micro 4) at depth 4; then TP's bf16 ``train`` at depth 8.
    (b) Two processes on the card over gloo (``--sp-worker``): ring and
    Ulysses scoring at seq 8,192 against the one-process ring and Ulysses
    on a mesh naming the card twice, and one f32 TP step (model 2)
    against one process; K3 per rank exactly."""
    import tempfile

    from keystone_tpu_torch.core.kernels import BUILD_DIR
    from keystone_tpu_torch.parallel import create_mesh

    t_phase = time.perf_counter()
    res: dict = {"f32": parallel_f32_legs(device)}

    mesh = create_mesh(data=1, model=PAR_N, devices=[device] * PAR_N)
    bf16 = tp_bf16_leg(device, mesh)
    del bf16["model"]
    want_k2 = TRAIN_CONF["depth"] * PAR_N * PAR_STEPS
    print(f"  TP bf16 depth {TRAIN_CONF['depth']} over {PAR_N} positions: losses "
          f"{bf16['losses']}, K2 {bf16['launches']['flash_attention']}, "
          f"{bf16['ms_per_step']:.1f} ms a step, peak {bf16['peak_bytes'] / 2**30:.2f} GiB")
    check(bf16["launches"]["flash_attention"] == want_k2, f"TP bf16 K2 {bf16['launches']}")
    check(all(math.isfinite(x) for x in bf16["losses"]) and bf16["losses"][-1] < bf16["losses"][0],
          f"TP bf16 losses {bf16['losses']}")
    res["tp_bf16"] = bf16
    torch.cuda.empty_cache()

    # (b) the one-process references, then two processes on the card
    model, held, kw = scoring_model(device)
    one = score_modes(model, create_mesh(data=SP_PROCS, devices=[device] * SP_PROCS), held, kw)
    del model
    tp_ref = _par_leg(device, "plain", PAR_F32_DEPTH, _par_batches(1))
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("KEYSTONE_", "KST_"))}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as out:
        t0 = time.perf_counter()
        sup = subprocess.run(
            [sys.executable, "-m", "keystone_tpu_torch", "supervise", "--procs", str(SP_PROCS),
             "--max-restarts", "0", "--grace", "5", "--",
             sys.executable, os.path.abspath(__file__), "--sp-worker", out],
            cwd=root, env=env, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
        pair_s = time.perf_counter() - t0
        check(sup.returncode == 0, f"phase 44 pair: supervise exit {sup.returncode}\n"
              f"{sup.stderr[-3000:]}")
        ranks = []
        for r in range(SP_PROCS):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        tp_got = load_dist_f32_leg(out, "tp", ranks, PAR_F32_DEPTH)
    forwards = -(-SCORE_WINDOWS // SCORE_BATCH)
    depth = SCORE_CONF["depth"]
    print(f"  two processes on one card over gloo: {pair_s:.1f} s for the pair")
    for mode in ("ring", "ulysses"):
        o = one[mode]
        print(f"  {mode} one process, the card named {SP_PROCS} times: loss {o['loss']:.6f}, "
              f"{o['ms_per_forward']:.1f} ms a forward, launches {o['launches']}")
        for r in ranks:
            g = r["scoring"][mode]
            rel = abs(g["loss"] - o["loss"]) / o["loss"]
            if mode == "ring":
                want = {"flash_attention_step": forwards * depth * (r["rank"] + 1)}
            else:
                want = {"flash_attention": forwards * depth}
            want = {k: want.get(k, 0) for k in g["launches"]}
            print(f"    rank {r['rank']}: loss {g['loss']:.6f} ({rel:.2e} relative), "
                  f"{g['ms_per_forward']:.1f} ms a forward, launches {g['launches']}")
            check(g["launches"] == want, f"{mode} rank {r['rank']}: {g['launches']} for {want}")
            check(rel <= SP_LOSS_RTOL, f"{mode} rank {r['rank']}: loss {rel:.2e} from one process")
    ring_total = sum(r["scoring"]["ring"]["launches"]["flash_attention_step"] for r in ranks)
    check(ring_total == one["ring"]["launches"]["flash_attention_step"],
          f"the ranks' K3 {ring_total} against one process's {one['ring']['launches']}")
    for r in ranks:
        check(r["scoring_replicas_equal"], f"rank {r['rank']}: parameters differ across ranks")
    res["two_processes"] = {
        "pair_s": pair_s, "one_process": one,
        "ranks": [{"rank": r["rank"], "scoring": r["scoring"]} for r in ranks],
        "tp_f32": check_par_leg(f"TP f32 over {SP_PROCS} processes", tp_got, tp_ref),
    }
    res["s"] = time.perf_counter() - t_phase
    print(f"phase 44: {res['s']:.1f} s")
    return res


# --- phase 45: serving a sharded model (one card named PAR_N times)
SHARD_F32_DEPTH = 2  # leg (a): f32 against the unsharded model, cut for the time limit
SHARD_F32_TOL = 1e-5  # of max|logit|, f32 sharded against unsharded from the same weights
SHARD_S_MAX = LM_PROMPT + LM_MAX_NEW  # 128 + 256
SHARD_TIMED_STEPS = 50


def shard_model(device, depth: int, compute_dtype: str):
    """Phase 45's model at the decode width (seed 0)."""
    from keystone_tpu_torch.models.lm import TransformerLM

    return TransformerLM.create(**dict(LM_CONF, depth=depth), compute_dtype=compute_dtype,
                                device=device, generator=torch.Generator(device=device).manual_seed(0))


def shard_tokens(device) -> torch.Tensor:
    """Leg (a)'s (8, 128 + 32) teacher-forced tokens (seed 45)."""
    import numpy as np

    return torch.from_numpy(np.random.default_rng(45).integers(
        0, LM_CONF["vocab"], size=(LM_BATCH, LM_PROMPT + EQUIV_STEPS))).to(device)


def shard_prompts() -> list:
    """Leg (b)'s 8 prompts of 128 tokens (seed 46)."""
    import numpy as np

    rng = np.random.default_rng(46)
    return [rng.integers(0, LM_CONF["vocab"], size=LM_PROMPT) for _ in range(LM_BATCH)]


def teacher_forced(model, toks) -> torch.Tensor:
    """Prefill of the first 128 tokens, then a decode step along each of
    the next 32: the (33, B, V) f32 logits."""
    from keystone_tpu_torch.models.lm import decode

    logits, cache = decode.prefill(model, toks[:, :LM_PROMPT], toks.shape[1] + 1)
    out = [logits]
    for j in range(LM_PROMPT, toks.shape[1]):
        logits, cache = decode.decode_step(model, toks[:, j], cache)
        out.append(logits)
    return torch.stack(out)


def same_quantization(sharded_q, whole_q) -> bool:
    """True when a sharded model's int8 codes and scales, gathered, equal
    the whole model's quantization bit for bit (and, in one process, the
    positions' pieces joined back equal them too)."""
    from keystone_tpu_torch.models.lm import unshard_params
    from keystone_tpu_torch.models.lm.sharding import leaf_dims
    from keystone_tpu_torch.ops.quantization import QTensor

    tp = sharded_q.tp
    same = True
    for got, mine, want, dim in zip(unshard_params(sharded_q).leaves(), sharded_q.leaves(),
                                    whole_q.leaves(), leaf_dims(sharded_q)):
        if not isinstance(want, QTensor):
            continue
        same &= torch.equal(got.q, want.q) and torch.equal(got.scale, want.scale)
        if dim is not None and not tp.local:
            pieces = [tp.part(mine, dim, p, None) for p in range(tp.n)]
            same &= torch.equal(torch.cat([x.q for x in pieces], dim=dim), want.q)
    return bool(same)


def shard_f32_legs(device, mesh) -> dict:
    """Phase 45 (a) on ``mesh``: f32 at depth 2, teacher-forced prefill and
    32 decode steps of the sharded model and of the sharded quantized
    model (``quantize_for_decode(shard_params(m))``, K4 on), each with
    the launches they counted: {"float": logits, "int8": logits,
    "launches": {...}, "codes_equal": bool}."""
    from keystone_tpu_torch.models.lm import quantize_for_decode, shard_params

    model = shard_model(device, SHARD_F32_DEPTH, "float32")
    toks = shard_tokens(device)
    sharded = shard_params(model, mesh)
    quant = quantize_for_decode(sharded)
    out = {"codes_equal": same_quantization(quant, quantize_for_decode(model)), "launches": {}}
    for name, m in (("float", sharded), ("int8", quant.replace(int8_kernel="kernel"))):
        torch.cuda.synchronize()
        _zero_counts()
        out[name] = teacher_forced(m, toks)
        torch.cuda.synchronize()
        out["launches"][name] = _counts()
    return out


def shard_f32_reference(device) -> dict:
    """The unsharded model's logits of leg (a), from the same weights."""
    from keystone_tpu_torch.models.lm import quantize_for_decode

    model = shard_model(device, SHARD_F32_DEPTH, "float32")
    toks = shard_tokens(device)
    return {"float": teacher_forced(model, toks),
            "int8": teacher_forced(quantize_for_decode(model).replace(int8_kernel="kernel"),
                                   toks)}


def check_shard_f32(label: str, got: dict, ref: dict, positions: int) -> dict:
    """Hold leg (a)'s logits within SHARD_F32_TOL of max|logit| of the
    unsharded model's, the codes bit for bit, and the launches: K2 once a
    block a position in the prefill, K4 six times a block a position in
    every decode step of the int8 leg (a prefill of 1,024 rows takes
    ``quantization.mm``)."""
    res = {"codes_equal": got["codes_equal"], "launches": got["launches"]}
    for name in ("float", "int8"):
        err = _rel(got[name], ref[name])
        agree = float((got[name].argmax(-1) == ref[name].argmax(-1)).float().mean())
        res[name] = {"max_rel_err": err, "argmax_agreement": agree}
        print(f"  {label} {name}: prefill + {EQUIV_STEPS} decode steps, max|sharded - "
              f"unsharded| / max|logit| = {err:.3e}, argmax agreement {agree:.4%}, launches "
              f"{got['launches'][name]}")
        check(bool(torch.isfinite(got[name]).all()), f"{label} {name}: logits not finite")
        check(err <= SHARD_F32_TOL, f"{label} {name}: logits {err:.3e} of max from unsharded")
    depth = SHARD_F32_DEPTH
    want = {"float": {"flash_attention": depth * positions, "int8_matmul": 0},
            "int8": {"flash_attention": depth * positions,
                     "int8_matmul": 6 * depth * positions * EQUIV_STEPS}}
    for name, w in want.items():
        got_l = {k: got["launches"][name][k] for k in w}
        check(got_l == w, f"{label} {name}: launches {got['launches'][name]}, want {w}")
    print(f"  {label}: the sharded quantization's codes and scales equal the whole model's "
          f"bit for bit: {got['codes_equal']}")
    check(got["codes_equal"], f"{label}: the sharded quantization differs from the whole one")
    return res


def k4_pieces(model) -> tuple:
    """(K4 launches a pooled step, the pieces that take ``quantization.mm``)
    of an int8 model under its layout: every weight's piece a position
    (the whole weight without a layout) whose (1, N) scale K4 takes."""
    from keystone_tpu_torch.models.lm.model import _WEIGHTS
    from keystone_tpu_torch.models.lm.sharding import leaf_dims
    from keystone_tpu_torch.ops.quantization import QTensor

    tp = model.tp
    dims = leaf_dims(model)[2:]
    k4, on_mm = 0, []
    for i, blk in enumerate(model.blocks):
        for j, (name, w) in enumerate(zip(_WEIGHTS, blk.leaves())):
            dim = dims[6 * i + j]
            split = tp is not None and dim is not None and not tp.local
            pieces = [tp.part(w, dim, p, None) for p in range(tp.n)] if split else [w]
            for p, piece in enumerate(pieces):
                if isinstance(piece, QTensor) and tuple(piece.scale.shape) == (1, piece.q.shape[1]):
                    k4 += 1
                else:
                    on_mm.append(f"block {i} {name} piece {p}")
    return k4, on_mm


def _pool_state(loop) -> list:
    c = loop.cache
    return [t.clone() for t in (c.k, c.v, c.k_scale, c.v_scale, c.pos)]


def _restore_pool(loop, state) -> None:
    c = loop.cache
    for buf, saved in zip((c.k, c.v, c.k_scale, c.v_scale, c.pos), state):
        buf.copy_(saved)


def shard_loop_leg(device, model, prompts) -> dict:
    """Phase 45 (b) for one model: ``export_lm(quantize=True,
    int8_kv=True)`` with 8 slots, the prompts run to 256 new tokens each
    (wall, tokens/s, peak memory), then one pool state with every slot
    busy: the graphed step's ms, and K4 and K2 by kernel name in a
    profiler trace of 8 step replays and of one prefill replay. Returns
    the leg, the loop (its slots busy, at that state) and the state."""
    import numpy as np

    from keystone_tpu_torch.serve.export import export_lm

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    loop = export_lm(model, slots=LM_BATCH, s_max=SHARD_S_MAX, quantize=True, int8_kv=True,
                     max_new=LM_MAX_NEW)
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = loop.run(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    tokens = sum(len(o) for o in outs)
    check(tokens == LM_BATCH * LM_MAX_NEW, f"sharded serving: {tokens} tokens")
    check(all(bool(((o >= 0) & (o < LM_CONF["vocab"])).all()) for o in outs),
          "sharded serving: a token out of range")
    leg = {"graphed": loop.graphed, "warm_s": warm_s, "wall_s": wall, "tokens": tokens,
           "tokens_per_s": tokens / wall, "peak_bytes": torch.cuda.max_memory_allocated(),
           "capture_launches": counts}
    k4_want, on_mm = k4_pieces(loop.model)
    leg["k4_pieces"], leg["pieces_on_mm"] = k4_want, on_mm
    with torch.inference_mode():
        for p in prompts:
            loop.submit(p, max_new=LM_MAX_NEW)
        loop._admit()
        state = _pool_state(loop)
        tok = loop._tok.copy()
        if loop.graphed:
            _restore_pool(loop, state)
            trace = traced_launches(lambda: [loop._run_step(tok) for _ in range(8)],
                                    reset=lambda: _restore_pool(loop, state))
            padded = np.asarray(prompts[0])[None]
            prefill = traced_launches(lambda: loop._run_prefill(padded, LM_PROMPT))
            leg["step_launches"] = {k: v / 8 for k, v in trace["launches"].items()}
            leg["prefill_launches"] = prefill["launches"]
            leg["step_device_busy_ms"] = trace["device_busy_ms"] / 8
            leg["step_kernels"] = trace["device_kernels"] / 8
        _restore_pool(loop, state)
    return leg, loop, state, outs


def _step_ms(loop, state, tok) -> float:
    with torch.inference_mode():
        _restore_pool(loop, state)
        return _wall(lambda: loop._run_step(tok), iters=SHARD_TIMED_STEPS) * 1e3


def shard_kernel_shapes(device, qmodel) -> dict:
    """K2 at one position's prefill call, (8, 4, 128, 64) bf16 causal, and
    K4 at the pieces' shapes, 8 rows in bf16 against the (1,024 × 256)
    column piece of ``wq``, the (256 × 1,024) row piece of ``wo`` and the
    (1,024 × 1,024) pieces of ``w1`` and ``w2``: each against its plain
    version, timed beside it, its library call and its bound."""
    import torch.nn.functional as F

    from keystone_tpu_torch.ops import flash_attention as fa
    from keystone_tpu_torch.ops import int8_matmul as im

    gen = torch.Generator(device=device).manual_seed(45)
    tp, blk = qmodel.tp, qmodel.blocks[0]
    k4 = {}
    for name, w, dim in (("wq_piece", blk.wq, 1), ("wo_piece", blk.wo, 0), ("w1_piece", blk.w1, 1),
                         ("w2_piece", blk.w2, 0)):
        piece = tp.part(w, dim, 1, device)
        k, n = piece.q.shape
        y = torch.randn((LM_BATCH, k), generator=gen, device=device).to(torch.bfloat16)
        out = im.mm_fused(y, piece)
        torch.cuda.synchronize()
        ref = im.mm_fused_plain(y, piece)
        err = _rel(out, ref)
        check(err <= K4_BF16_TOL, f"K4 at {name} {LM_BATCH}x{k}x{n} disagrees ({err:.3e})")
        q_nk, scales = piece.q.t().contiguous(), piece.scale[0].to(torch.bfloat16).contiguous()
        try:
            library_ms = device_ms(lambda: torch._weight_int8pack_mm(y, q_nk, scales))
        except (RuntimeError, NotImplementedError):
            library_ms = None
        traffic = k * n + 2 * LM_BATCH * k + 4 * n + 2 * LM_BATCH * n
        ops_ms = 1e3 * 2.0 * LM_BATCH * k * n / BF16_PEAK_OPS
        bytes_ms = 1e3 * traffic / HBM_BYTES_PER_S
        k4[name] = {"shape": [LM_BATCH, k, n], "max_abs_err": float((out.float() - ref.float())
                                                                    .abs().max()),
                    "max_rel_err": err, "ms": device_ms(lambda: im.mm_fused(y, piece)),
                    "plain_ms": device_ms(lambda: im.mm_fused_plain(y, piece)),
                    "library_ms": library_ms, "library": "torch._weight_int8pack_mm",
                    "bound_ms": max(ops_ms, bytes_ms),
                    "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        r = k4[name]
        print(f"  K4 {name} {r['shape']} bf16: relative {err:.3e}; device kernel {r['ms']} ms, "
              f"plain {r['plain_ms']} ms, library {library_ms} ms, bound {r['bound_ms']:.5f} ms")
    b, h, s, d = LM_BATCH, LM_CONF["num_heads"] // PAR_N, LM_PROMPT, 64
    q, kk, v = (torch.randn((b, h, s, d), generator=gen, device=device).to(torch.bfloat16)
                for _ in range(3))
    out = fa.flash_attention(q, kk, v, causal=True)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, kk, v, causal=True)
    err = _rel(out, ref)
    check(err <= K2_BF16_TOL, f"K2 at ({b}, {h}, {s}, {d}) disagrees ({err:.3e})")
    ops_ms = 1e3 * 4.0 * b * h * d * s * (s + 1) / 2 / BF16_PEAK_OPS
    bytes_ms = 1e3 * 4.0 * b * h * s * d * 2 / HBM_BYTES_PER_S
    k2 = {"shape": [b, h, s, d], "max_abs_err": float((out.float() - ref.float()).abs().max()),
          "max_rel_err": err, "ms": device_ms(lambda: fa.flash_attention(q, kk, v, causal=True)),
          "plain_ms": device_ms(lambda: fa.flash_attention_plain(q, kk, v, causal=True)),
          "library_ms": device_ms(lambda: F.scaled_dot_product_attention(q, kk, v,
                                                                          is_causal=True)),
          "library": "scaled_dot_product_attention", "bound_ms": max(ops_ms, bytes_ms),
          "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    print(f"  K2 {k2['shape']} bf16 causal: relative {err:.3e}; device kernel {k2['ms']} ms, "
          f"plain {k2['plain_ms']} ms, sdpa {k2['library_ms']} ms, bound {k2['bound_ms']:.5f} ms")
    return {"k2": k2, "k4": k4}


def phase_sharded_serving(device) -> dict:
    """Phase 45: serving a sharded model in one process on a mesh naming
    the card ``PAR_N`` times. (a) f32 at depth 2: teacher-forced prefill
    and 32 decode steps of ``shard_params(m)`` and of
    ``quantize_for_decode(shard_params(m))`` against the unsharded pair,
    within 1e-5 of max|logit|, the codes bit for bit. (b) bf16 at depth 8:
    ``export_lm(shard_params(m), quantize=True, int8_kv=True)`` against
    ``export_lm(m, ...)``, 8 prompts of 128 tokens and 256 new tokens
    each: both graphed, K4 a step replay and K2 a prefill replay by kernel
    name (4 × the unsharded counts), ms a pooled step in turns, tokens/s,
    peak memory, and the greedy tokens teacher-forced from the unsharded
    pool's (every step fed the unsharded tokens) ≥ 99 % equal; the
    free-running tokens' agreement printed. K2 and K4 at the new shapes
    against their plain versions. (c) ``ServeApp`` over (b)'s sharded
    loop answers 8 concurrent ``/generate`` with the loop's own tokens."""
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np

    from keystone_tpu_torch.models.lm import shard_params
    from keystone_tpu_torch.parallel import create_mesh
    from keystone_tpu_torch.serve import server

    t_phase = time.perf_counter()
    mesh = create_mesh(data=1, model=PAR_N, devices=[device] * PAR_N)
    res: dict = {"f32": check_shard_f32(f"sharded f32 depth {SHARD_F32_DEPTH} over {PAR_N}",
                                        shard_f32_legs(device, mesh), shard_f32_reference(device),
                                        PAR_N)}
    torch.cuda.empty_cache()

    model = shard_model(device, LM_CONF["depth"], "bfloat16")
    prompts = shard_prompts()
    legs, loops = {}, {}
    for name, m in (("unsharded", model), ("sharded", shard_params(model, mesh))):
        leg, loop, state, outs = shard_loop_leg(device, m, prompts)
        legs[name], loops[name] = leg, (loop, state, outs)
        check(leg["graphed"], f"sharded serving: the {name} loop was not graphed")
    tok = loops["unsharded"][0]._tok.copy()
    turns: dict = {"unsharded": [], "sharded": []}
    for name in ("unsharded", "sharded", "sharded", "unsharded"):
        loop, state, _ = loops[name]
        turns[name].append(_step_ms(loop, state, tok))
    forced = 0
    with torch.inference_mode():
        for loop, state, _ in loops.values():
            _restore_pool(loop, state)
        t = tok
        for _ in range(LM_MAX_NEW - 1):
            tu = loops["unsharded"][0]._run_step(t)
            ts = loops["sharded"][0]._run_step(t)
            forced += int((tu == ts).sum())
            t = tu
        for loop, _, _ in loops.values():
            for b in range(LM_BATCH):
                loop._retire(b)
    forced_agree = forced / (LM_BATCH * (LM_MAX_NEW - 1))
    free = [o_s == o_u for o_s, o_u in zip(loops["sharded"][2], loops["unsharded"][2])]
    free_agree = float(np.concatenate(free).mean())
    first_diff = [int(np.argmin(f)) if not f.all() else None for f in free]
    depth = LM_CONF["depth"]
    for name, leg in legs.items():
        leg["step_ms"] = statistics.mean(turns[name])
        leg["step_ms_turns"] = turns[name]
        print(f"  {name} loop (bf16 depth {depth}, int8 weights and KV, {LM_BATCH} slots): "
              f"{leg['tokens']} tokens in {leg['wall_s']:.3f} s ({leg['tokens_per_s']:.1f} "
              f"tokens/s), graphed step {leg['step_ms']:.3f} ms (turns {turns[name]}), device "
              f"busy {leg['step_device_busy_ms']:.3f} ms in {leg['step_kernels']:.0f} kernels a "
              f"step; launches a step replay "
              f"{leg['step_launches']}, a prefill replay {leg['prefill_launches']}; K4 pieces "
              f"{leg['k4_pieces']}, on quantization.mm {leg['pieces_on_mm']}; peak "
              f"{leg['peak_bytes'] / 2**30:.2f} GiB; warm {leg['warm_s']:.1f} s")
    for name, n in (("unsharded", 1), ("sharded", PAR_N)):
        leg = legs[name]
        check(leg["k4_pieces"] == 6 * depth * n - len(leg["pieces_on_mm"]),
              f"{name}: K4 pieces {leg['k4_pieces']}")
        check(leg["step_launches"]["int8_matmul"] == leg["k4_pieces"]
              and leg["step_launches"]["flash_attention"] == 0,
              f"{name}: a step replay launched {leg['step_launches']}, want K4 {leg['k4_pieces']}")
        check(leg["prefill_launches"]["flash_attention"] == depth * n,
              f"{name}: a prefill replay launched {leg['prefill_launches']}")
        check(leg["capture_launches"]["flash_attention"] > 0
              and leg["capture_launches"]["int8_matmul"] > 0,
              f"{name}: the wrappers launched {leg['capture_launches']} in export and run")
    print(f"  greedy tokens, sharded against unsharded: teacher-forced {forced_agree:.4%} of "
          f"{LM_BATCH * (LM_MAX_NEW - 1)} steps; free-running {free_agree:.4%} (first "
          f"differing position a prompt: {first_diff})")
    check(forced_agree >= EQUIV_ARGMAX, f"sharded serving: teacher-forced agreement "
          f"{forced_agree:.4%}")
    res["bf16"] = {"legs": legs, "teacher_forced_agreement": forced_agree,
                   "free_running_agreement": free_agree, "first_differing": first_diff}
    res["kernels"] = shard_kernel_shapes(device, loops["sharded"][0].model)

    sloop, _, souts = loops["sharded"]
    del loops
    app = server.ServeApp(decode_loop=sloop, device=device)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server._handler_for(app))
    thread = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                              daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"
    try:
        answers, wall = _burst([lambda p=p: _http(url, {"prompt": p.tolist(),
                                                        "max_new": LM_MAX_NEW})
                                for p in prompts])
    finally:
        app.shutdown()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    for (status, payload, _), want in zip(answers, souts):
        check(status == 200, f"sharded http: /generate answered {status}")
        check(payload["tokens"] == want.tolist(),
              "sharded http: /generate differs from the loop's own tokens")
    res["http"] = {**_latency(answers, wall), "tokens": LM_BATCH * LM_MAX_NEW,
                   "tokens_per_s": LM_BATCH * LM_MAX_NEW / wall}
    print(f"  http /generate over the sharded loop: {len(answers)} concurrent, all 200 with the "
          f"loop's tokens, {wall:.3f} s ({res['http']['tokens_per_s']:.1f} tokens/s), p50 "
          f"{res['http']['p50_ms']:.1f} ms")
    res["s"] = time.perf_counter() - t_phase
    print(f"phase 45: {res['s']:.1f} s")
    return res


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    from keystone_tpu_torch.core.runtime import resolve_device
    from keystone_tpu_torch.ops import gram

    device = resolve_device("cuda:0")
    if sys.argv[1:] == ["--breakdown"]:
        print(json.dumps(fit_breakdown(device)))
        return
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(sys.argv[2])
        return
    if sys.argv[1:2] == ["--sp-worker"]:
        sp_worker(sys.argv[2])
        return
    if sys.argv[1:2] == ["--trace-windows"]:
        rows = trace_window_census(int(sys.argv[2]))
        print(json.dumps({"windows": len(rows),
                          "whole": sum(r["status"] == "ok" and r["k2_traced"] == r["k2_want"]
                                       for r in rows),
                          "primer_lost_max": max(r["primer_lost"] or 0 for r in rows)}))
        return
    smi = phase_card()
    build = phase_build(_kernels())
    k1 = phase_k1(device)

    gram.INT8_GRAM.launches = 0
    w8: list = []
    undo = _capture_weights(w8)
    try:
        res8 = run_main("int8")
    finally:
        undo()
    launches = gram.INT8_GRAM.launches
    chunk = res8["fit_chunk_size"] or res8["n_train"]
    n_chunks = -(-res8["n_train"] // chunk)
    print(f"K1 launches on the main path: {launches} for {n_chunks} fit chunks")
    check(res8["fit_operator"]["op"] == "int8", "the plan did not pick the int8 Gram")
    check(launches == n_chunks, f"K1 launched {launches} times for {n_chunks} chunks")
    check(res8["test_error"] <= MAX_TEST_ERROR, f"test error {res8['test_error']}")
    k1["launches"] = launches

    res32 = run_main("fp32")
    check(res32["fit_operator"]["op"] == "fp32", "the fp32 run did not pick fp32")
    check(gram.INT8_GRAM.launches == launches, "K1 ran in the fp32 fit")
    agree = float((res8["test_predictions"] == res32["test_predictions"]).mean())
    print(f"int8 vs fp32 test predictions agree on {agree:.4%}")
    check(agree >= MIN_AGREEMENT, f"int8/fp32 agreement {agree:.4%}")

    breakdown = phase_breakdown()

    k2 = phase_k2(device)
    k1["ptxas"] = [r for r in build["ptxas"] if r["kernel"].startswith("K1")]
    k2["ptxas"] = [r for r in build["ptxas"] if r["kernel"].startswith(("K2State", "K2 "))]
    k4 = phase_k4(device)
    lm = phase_lm(device)
    k2["launches"] = lm["kernel_leg_launches"]["flash_attention"]
    k4["launches"] = lm["kernel_leg_launches"]["int8_matmul"]
    k4["ptxas"] = [r for r in build["ptxas"] if r["kernel"].startswith("K4")]
    k4_prof = lm["legs"]["int8_kernel"]["decode_profile"]
    k4["decode_step_ms"] = k4_prof and k4_prof["int8_matmul_ms_per_step"]
    equiv = phase_equivalence(device, lm.pop("model"))
    serving = phase_serving(device, lm.pop("qmodel"))
    print(json.dumps({"lm_path": {"card": smi, **lm, "equivalence": equiv,
                                  "serving": serving}}))

    k3 = phase_k3(device)
    k3["ptxas"] = [r for r in build["ptxas"] if r["kernel"].startswith("K3State")]
    ring = phase_ring(device)
    k2["at_scoring_seq"] = ring["k2_vs_plain_bf16"]
    scoring = phase_scoring(device)
    k3["launches"] = scoring["modes"]["ring"]["launches"]["flash_attention_step"]
    score_equiv = phase_scoring_equivalence(
        device, scoring.pop("model"), scoring.pop("mesh"), scoring.pop("held"))
    print(json.dumps({"scoring_path": {"card": smi, "ring_attention": ring, **scoring,
                                       "f32_equivalence": score_equiv}}))

    train = phase_train(device)
    corpus = train.pop("corpus")
    long_ctx = phase_long_context(device, corpus)
    seq_par = phase_train_sequence_parallel(device, corpus)
    train_equiv = phase_train_equivalence(device)
    k2["launches_train"] = {
        "flagship_main": train["flagship"]["launches"]["flash_attention"],
        "flagship_per_step": TRAIN_CONF["depth"],
        "remat_per_step": train["remat"]["dots"]["k2_launches_per_step"][-1],
        "long_context_per_step": long_ctx["launches_per_step"]["flash_attention"],
        "ulysses_per_step": seq_par["modes"]["ulysses"]["launches_per_step"][-1]["flash_attention"],
    }
    k3["launches_train"] = {
        "ring_per_step": seq_par["modes"]["ring"]["launches_per_step"][-1]["flash_attention_step"],
    }
    print(json.dumps({"train_path": {"card": smi, **train, "long_context": long_ctx,
                                     "sequence_parallel": seq_par,
                                     "f32_equivalence": train_equiv}}))

    http = phase_http(device)
    k2["launches_graphed"] = {
        "per_prefill_replay": serving["prefill"][SERVE_S_MAX]["launches"]["flash_attention"],
        "http_generate": http["traced_generate"]["launches"]["flash_attention"],
        "count": "kernel names in a torch.profiler trace",
    }
    k4["launches_graphed"] = {
        "per_step_replay": serving["step_ms"]["k4_launches"],
        "http_generate": http["traced_generate"]["launches"]["int8_matmul"],
        "count": "kernel names in a torch.profiler trace",
    }
    print(json.dumps({"http_path": {"card": smi, **http}}))

    timit = phase_timit(device)
    k1["launches_timit"] = timit["k1_launches"]
    k1["timit"] = timit["kernels"]["k1"]
    print(json.dumps({"timit_path": {"card": smi, **timit}}))

    moe_serving = phase_moe_serving(device)
    moe_train = phase_moe_train(device)
    k2["launches_moe"] = {"per_prefill": moe_serving["legs"]["float"]["prefill_launches"][
        "flash_attention"], "train_main": moe_train["launches"]["flash_attention"],
        "prefill_replay": moe_serving["prefill_replay_launches"]["flash_attention"]}
    k4["launches_moe"] = {"generate": moe_serving["legs"]["int8_kernel"]["launches"][
        "int8_matmul"], "per_step_replay": moe_serving["step_ms"]["k4_launches"]}
    print(json.dumps({"moe_path": {"card": smi, "serving": moe_serving, "train": moe_train}}))

    vit = phase_vit(device)
    k2["launches_vit"] = vit["launches"]["flash_attention"]
    k2["at_vit_shape"] = phase_k2_vit(device)
    print(json.dumps({"vit_path": {"card": smi, **vit, "k2_at_vit_shape": k2["at_vit_shape"]}}))

    cifar = phase_cifar_conv(device)
    k1["launches_cifar_random_planned"] = cifar["launches"]["random_filter_planned"]["int8_gram"]
    k1["cifar_random_planned"] = cifar["k1"]
    cifar["featurizer_at_bench_shape"] = phase_conv_bench(device)
    print(json.dumps({"cifar_conv_path": {"card": smi, **cifar}}))
    text = phase_text(device)
    print(json.dumps({"text_path": {"card": smi, **text}}))
    voc_path = phase_voc(device)
    voc_path["sift_at_bench_shape"] = phase_sift_bench(device)
    print(json.dumps({"voc_path": {"card": smi, **voc_path}}))
    imagenet = phase_imagenet(device)
    imagenet["weighted_solver"] = phase_weighted(device)
    print(json.dumps({"imagenet_path": {"card": smi, **imagenet}}))
    native_path = phase_native(device)
    print(json.dumps({"native_path": {"card": smi, **native_path}}))
    refit_path = phase_refit(device)
    k1["launches_refit"] = refit_path["launches"]
    k1["refit_first_chunk"] = refit_path.pop("k1_first_chunk")
    print(json.dumps({"refit_path": {"card": smi, **refit_path}}))
    resume_path = phase_resume(device)
    print(json.dumps({"resume_path": {"card": smi, **resume_path}}))
    fleet_path = phase_fleet(device, serving["prefill"], serving["step_ms"]["k4_launches"])
    k2["launches_fleet"] = {"per_request": fleet_path["launches"]["per_request"][
        "flash_attention"], "count": fleet_path["launches"]["count"]}
    k4["launches_fleet"] = {"per_request": fleet_path["launches"]["per_request"]["int8_matmul"],
                            "count": fleet_path["launches"]["count"]}
    print(json.dumps({"fleet_path": {"card": smi, **fleet_path}}))
    guard_path = phase_guards(device)
    k2["launches_guarded_train"] = {"total": guard_path["launches"]["flash_attention"],
                                    "steps": GUARD_STEPS}
    print(json.dumps({"guard_path": {"card": smi, **guard_path}}))
    game_days = phase_game_days(device)
    k1["launches_refit_game_day"] = game_days["refit"]["k1_launches"]
    k2["launches_train_game_day"] = game_days["train"]["launches_last_incarnation"][
        "flash_attention"]
    print(json.dumps({"game_day_path": {"card": smi, **game_days}}))
    tuning = phase_self_tuning(device)
    k1["launches_self_tuning"] = {leg: tuning["legs"][leg]["k1_launches"]
                                  for leg in ("tuned", "stored")}
    k1["launches_fit_shared"] = tuning["fit_shared"]["launches"]["int8_gram"]
    k1["self_tuning_chunk_ms"] = tuning["legs"]["tuned"]["k1_ms"]
    print(json.dumps({"self_tuning_path": {"card": smi, **tuning}}))
    observe_path = phase_observe_tools(device)
    k2["launches_traced_window"] = {"traced": observe_path["k2_traced"],
                                    "main": observe_path["launches"]["flash_attention"],
                                    "device_ms": observe_path["k2_device_ms"]}
    print(json.dumps({"observe_path": {"card": smi, **observe_path}}))
    cli_path = phase_cli(device)
    print(json.dumps({"cli_path": {"card": smi, **cli_path}}))
    dp_path = phase_two_processes(device, res8, w8[-1])
    k1["launches_two_processes"] = {"per_rank": [r["mnist"]["k1_launches"]
                                                 for r in dp_path["ranks"]]}
    k2["launches_two_processes"] = {"per_rank": [r["k2_launches"] for r in dp_path["ranks"]],
                                    "steps": DP_TRAIN_STEPS}
    print(json.dumps({"two_process_path": {"card": smi, **dp_path}}))
    par_path = phase_parallel(device)
    k2["launches_parallel"] = {
        "f32_per_step": {k: par_path["f32"][k]["k2_per_step"] for k in ("tp", "pp_dp_tp", "pp")},
        "tp_bf16_main": par_path["tp_bf16"]["launches"]["flash_attention"],
        "ulysses_pair_per_rank": [r["scoring"]["ulysses"]["launches"]["flash_attention"]
                                  for r in par_path["two_processes"]["ranks"]],
    }
    k3["launches_parallel"] = {
        "ring_pair_per_rank": [r["scoring"]["ring"]["launches"]["flash_attention_step"]
                               for r in par_path["two_processes"]["ranks"]],
        "ring_one_process": par_path["two_processes"]["one_process"]["ring"]["launches"][
            "flash_attention_step"],
    }
    print(json.dumps({"parallel_path": {"card": smi, **par_path}}))
    tiled_legs = f32_legs_summary(equiv, train_equiv, par_path["f32"])
    k2["launches_tiled_f32"] = tiled_legs["tiled_f32_launches"]
    print(json.dumps({"k2_tiled_f32_legs": {"card": smi, **tiled_legs}}))
    shard_path = phase_sharded_serving(device)
    legs = shard_path["bf16"]["legs"]
    k2["launches_sharded_serving"] = {
        "per_prefill_replay": legs["sharded"]["prefill_launches"]["flash_attention"],
        "unsharded_per_prefill_replay": legs["unsharded"]["prefill_launches"]["flash_attention"],
        "f32_prefill": shard_path["f32"]["launches"]["float"]["flash_attention"],
        "count": "kernel names in a torch.profiler trace"}
    k4["launches_sharded_serving"] = {
        "per_step_replay": legs["sharded"]["step_launches"]["int8_matmul"],
        "unsharded_per_step_replay": legs["unsharded"]["step_launches"]["int8_matmul"],
        "pieces_on_mm": legs["sharded"]["pieces_on_mm"],
        "f32_int8_decode": shard_path["f32"]["launches"]["int8"]["int8_matmul"],
        "count": "kernel names in a torch.profiler trace"}
    k2["at_sharded_serving"] = shard_path["kernels"]["k2"]
    k4["at_sharded_serving"] = shard_path["kernels"]["k4"]
    print(json.dumps({"sharded_serving_path": {"card": smi, **shard_path}}))

    summary = {
        "card": smi,
        "build_s": build["build_s"],
        "int8_fit_breakdown": breakdown,
        "int8": {k: res8[k] for k in ("train_error", "test_error", "fit_s",
                                      "train_samples_per_s", "total_s")},
        "fp32": {k: res32[k] for k in ("train_error", "test_error", "fit_s",
                                       "train_samples_per_s", "total_s")},
        "quantization_error": res8["fit_operator"]["quantization_error"],
        "fit_chunks": n_chunks,
        "agreement": agree,
    }
    print(json.dumps({"main_path": summary}))
    print(smi)
    print(json.dumps({"kernels": [k1, k2, k3, k4]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
