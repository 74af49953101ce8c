#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on a GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero, with
no result line, when either is missing or any phase fails.  It imports
nothing of JAX or of the JAX package ``repro``.

1. Environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions, TF32 flags.
2. Build: compiles every kernel of ``src/repro_torch/kernels/csrc/`` into
   ``build/kernels/`` (one ``nvcc`` per source, in parallel).
3. Kernels against their plain versions at the shapes of qwen2-0.5b's
   agent matmuls.  ``group_quantize`` on both routes (the main path's
   seven shapes and a ragged column tile on the vector route, in one
   launch; three SIMT shapes, one launch each) at bits 8, 4, 4 packed and
   3 packed, and once as one table of mixed bits (2, 3, 5, 6, 7, 8, ...,
   packed where <= 4, in one vector launch): codes, scales and packed
   nibbles ``torch.equal``; then one
   configure (42 matrices) timed as the one grouped launch, as one vector
   launch per matrix, and as the first design's kernel (the SIMT route)
   per matrix, beside the plain version and the byte bound.
   ``qmm``/``qmm_int4`` on their tensor-core route at M in {1, 64, 256,
   1024} (64: the sequential engine, 256: the batched one) within
   rtol = atol = 1e-4 (the tolerance of tests/test_kernels.py), and every
   row of M = 64 and M = 256 bitwise equal to the row computed alone; one
   G = 1 shape on the SIMT route against the plain version.  Times each
   kernel, its plain version and one library call (``torch.matmul`` on
   the dequantized weight), with CUDA events, L2 flushed before every
   launch; the qmm bound is the arithmetic the kernel issues (3 bf16
   passes, 3 x 2MNK at 989 TFLOP/s) against its bytes, with the f32-SIMT
   bound (2MNK at 67 TFLOP/s) printed beside it.
4. The main path: qwen2-0.5b at full width (24 layers, seeded random
   weights) served through ``CoInferenceEngine(path="kernel")`` at
   b̂ = 8, b̂ = 4 and the plan [4, 4, 4, 8, 8, 8], 4 requests x 64 tokens
   as one batch and one at a time, then once more at the codesign's
   choice for T0 = 3.5 s, E0 = 2 J.  Launch counters are zeroed just
   before and read just after; every agent matmul must have gone through
   a kernel (7 per agent layer per forward), all on the tensor-core
   route (0 SIMT launches), every server product and the head through
   ``tc_gemm`` (7 per server layer and 1 a forward: no float32 product
   reaches cuBLAS), and each configure must have quantized its weights
   in one vector-route ``group_quantize`` launch.  The boundary
   activation and the logits are then held against a forward on the
   card that runs the plain versions (tolerances at E2E_TOL and
   KERNEL_TOL below, its products through ``torch.matmul``), and each
   row of the batch is held bitwise equal to the request served alone.
5. Decode attention against its plain version at qwen2-0.5b's heads
   (H = 14 over KV = 2, dh = 64): B in {1, 4}, T in {128, 1024, 4096},
   b_kv in {4, 8, 16}, ragged lengths including 0, one sliding window;
   six rows at lengths on and beside the kernel's chunk boundaries
   {0, 1, C - 1, C, C + 1, T} at T = 1024, and at T = 4096 under windows
   of 100 and 1000; within DECODE_TOL x max|out|, every row of a batch
   bitwise equal to the row alone, T grown to 2T with the lengths fixed
   bitwise equal, and a second launch on the same inputs bitwise equal
   to the first (the arrival counters reset).  Past the shared-memory cap
   the combine once had: granite-34b's heads (48 over 1, dh = 128) at
   T = 32,768 (B = 2, rows alone bitwise) and qwen2-0.5b's at T = 524,288
   (B = 1, the reference's LONG_500K) against the plain version on
   4096-position tiles, within DECODE_TOL, each timed.  Times the kernel, its
   plain version and one library call (``scaled_dot_product_attention``
   on the already-dequantized f32 cache, ``enable_gqa=True``, a length
   mask: its time leaves the dequant out) at the decode path's widest
   shape, L2 flushed, and prints the kernel's ratio to it.
6. The row-independent GEMM (``row_gemm``, the decode step's projections
   and tied head) against its plain version (one product per row) at
   qwen2-0.5b's decode shapes, wq/wo 896 -> 896, wk/wv 896 -> 128,
   gate/up 896 -> 4864, down 4864 -> 896 (w row-major), the head 896 ->
   151936 (the embedding's transposed view) and the grouped launches
   q | k | v (with its biases) and gate | up, then at stablelm-3b's (K,
   N in 2560 / 6912, vocab 50304), at M in ROW_GEMM_M (1 to 128): within
   ROW_GEMM_TOL x max|y|, every row bitwise the row alone, each grouped
   output bitwise its own launch plus the bias.  Times the kernel, the
   parent commit's kernel (when its source is unpacked under
   build/parent; a group as the sum of its separate launches), the plain
   version and one library call (``torch.matmul``; a group on the
   concatenated weight, ``torch.addmm`` with the concatenated bias) at
   M = 4, L2 flushed, against the byte bound, per shape and summed over
   one token step's launches (97 at qwen2-0.5b; the parent's 169).
   Then the split forward's tensor-core GEMM (``tc_gemm``) at qwen2-0.5b's
   server products (896 -> 896, 896 -> 128, 896 -> 4864, 4864 -> 896 and
   the tied head 896 -> 151936) and stablelm-3b's (2560 -> 2560, 2560 ->
   6912, 6912 -> 2560 and the untied head 2560 -> 50304): within
   TC_GEMM_TOL x max|y| of its plain version (``torch.matmul``) at M =
   2,048, every row bitwise across M in TC_GEMM_M (the rows of M = 17,
   256 and 506 taken from other places of the 2,048), a CUDA-graph
   replay bitwise the eager launch; timed at M = 256 and 2,048, L2
   flushed, against ``torch.matmul`` and the bound (3 TF32 passes, 3 x
   2MNK at 495 TFLOP/s, against the bytes; the f32-SIMT bound beside),
   per shape and summed over one 4 x 64 forward's server products.
7. The decode path at full width, through CUDA graphs.  First one step
   from one state (B = 4, T = 1024, b_kv = 8): batched against alone and
   plain attention against the kernels, the logit differences the token
   rule allows for.  Then the captured token step and a captured 500-token
   prefill against the module's closures run eagerly on a copy of the
   same slot block: tokens and every buffer bitwise.  Prints the wall ms
   per token step inside a 16-step chunk (graph and eager), tokens/s,
   the graph's device time and busy share under ``torch.profiler``, the
   prefill wall per request and the decode kernel's device ms per step
   (CUDA events around each of one step's 24 launches), beside the
   ungrouped design's graph step (UNGROUPED_STEP).  Then ``DecodeEngine``
   (max_batch 4) serves six prompts of 100-500 tokens, 32 new tokens each,
   arriving so that admission is continuous and the cache buckets span
   256-1024; pinned at (b̂, b_kv) = (8, 8) after ``warmup(500, 32)`` (no
   capture while serving), then pinned at (4, 4) and (8, 16) and with
   ``auto=True`` under the CLI's two QoS classes, capturing lazily while
   serving.  Launch counts, zeroed just before each run and read just
   after: the graphs' replays (each graph's record times its replays)
   must be 24 decode attentions and 97 ``row_gemm`` per token step and
   24 flash launches per prefill, and the only launches outside a graph
   the eager warm-up runs of graphs captured while serving.  Every
   response is held against ``greedy_decode_reference`` at batch 1 (its
   graphs from one shared cache), and a run whose prefill and decode
   attentions are both the plain versions against the kernel run: tokens
   equal, or equal up to the first step whose top-2 logit margin (from an
   eager batch-1 run of the closures, taken only then) is below twice the
   logit difference measured on one step from the same state.
8. Flash attention against its plain version at qwen2-0.5b's heads
   (H = 14 over KV = 2, dh = 64), operands in the model's [B, S, H, dh]
   layout: B in {1, 4} x S = T in {64, 100, 512, 1024} causal, the
   training shape B = 8 x S = 128, one sliding window of 128,
   bidirectional with ragged ``kv_len``, bf16 input, dh = 128.  f32
   within rtol = atol = FLASH_TOL (the reference's own,
   tests/test_flash.py, elementwise), bf16 within one bf16 ulp; every
   row of a batch bitwise equal to the row alone, and a sequence
   right-padded inside its bucket bitwise equal on its real positions.
   A query chunk at an offset (FLASH_OFFSETS: half a sequence's queries
   against every key, causal, a window, bf16; offset 0 too) within the
   same tolerances of the plain version at that offset, and bitwise the
   whole sequence's call on the rows it covers.
   Times the kernel, its plain version and ``scaled_dot_product_attention
   (is_causal=True, enable_gqa=True)`` on f32 at the serve shape (B = 4,
   S = 64), the training shape (B = 8, S = 128) and S = 1024, B = 1,
   beside two bounds: the three TF32 passes the kernel issues at 495
   TFLOP/s (the JSON line's bound) and f32 outside the tensor cores.
   Phases 4 and 7 count its launches too: 24 per forward and per prefill,
   and phase 4's plain forward runs the plain attention through the
   model's ``attend`` hook.
9. Training at full width: ``Trainer.fit`` takes TRAIN_STEPS steps of
   qwen2-0.5b ``FULL`` at batch 8 x seq 128 (the CLI's defaults) with
   QAT at 8 bits and int8 error-feedback gradients; loss and grad norm
   finite at every step, flash launches exactly 2 x 24 per step (the
   forward and its recompute under remat).  Then one step from one state
   with the kernel and one with the plain attention: losses within 1e-4
   relative, grad norms within 1e-3, and at most 1e-3 of the updated
   parameters apart by more than 1e-3 lr (see ``train_path``).
10. Compiled batched serving at full width:
   ``BatchedCoInferenceEngine(path="kernel", compiled=True, max_batch=4)``
   over two QoS classes whose codesign picks b̂ = 4 and b̂ = 8
   (COMPILED_CLASSES); ``warmup(512)`` captures one CUDA graph per (class,
   sequence bucket 16..512), then 12 requests of 16-512 tokens are
   served.  Launch counters are zeroed before the engine is built and
   read after serving; a graph's kernels count once per replay (its
   capture launched nothing, its eager warm-up run counts as it ran).
   After warm-up no request may miss the cache; every response must equal
   the eager engine's at the same bucket bitwise and the request served
   alone, unpadded and eager, bitwise (the count is printed).  Then the
   4 x 64 forward's wall with and without the graph, and its device time
   and busy share under ``torch.profiler``.
11. The paper's theory and mixed precision at full width.
   - FC-DNN-16 at its published dims (784 -> ... -> 784, 16 matrices,
     seeded) on the card: Prop. 3.1 (chain bound >= measured output
     distortion) at bits 3, 4, 6, 8 on the uniform and pot-log codebooks,
     the bound non-increasing in the bits, and bound, measured and
     parameter distortion within FCDNN_TOL of the same on the CPU.
   - Rate-distortion: lambda-hat from the agent weights, Blahut-Arimoto at
     its defaults on the card, every point at rates in BA_WINDOW between
     D^L and D^U within BA_SLACK (tests/test_rate_distortion.py's); its
     wall time.
   - Mixed serving, kernel path: ``layer_stats()`` on the card against
     the same on the CPU (STATS_TOL); the two MIXED_CLASSES allocate plans
     holding int4- and int8-container layers and no 1-bit layer (asserted,
     printed), each served eagerly as one counted window (one
     ``group_quantize`` launch a configure, ``qmm``/``qmm_int4`` as
     ``launches_per_forward`` says) and held against the plain versions
     (KERNEL_TOL, E2E_TOL); then ``BatchedCoInferenceEngine(
     mixed_precision=True, compiled=True)`` as in phase 10 (no miss after
     warm-up, replay == eager bitwise, batched == alone bitwise);
     the 4 x 64 forward's graph wall and device time beside phase 10's
     int8 graph.
   - Mixed decode: ``DecodeEngine(mixed_precision=True)`` from CUDA graphs
     over DECODE_MIXED_CLASSES, ``warmup`` first, every response equal to
     ``greedy_decode_reference`` with the class's weights bitwise, the
     chosen (bits, b_kv) and the token step's wall from its graph printed.
   - The paper's proxies: one forward of blip2-proxy and of git-proxy
     ``FULL`` at the plan [4, 8] through the kernel path, against the
     plain versions as in phase 4.
   Each serving or decode run above is a counted window like phases 4, 7
   and 10; the proxies' forwards count nowhere.
12. Speculative decode from CUDA graphs at full width:
   ``SpeculativeDecodeEngine`` (max_batch 4) on phase 7's six prompts, 32
   new tokens each, (b̂, b_kv) pinned at (8, 8): (b_draft, k) = (4, 4)
   after ``warmup(500, 32)`` (no capture while serving), then (2, 4) and
   (4, 16), then the CLI's two classes through ``auto=True``
   (``solve_speculative``) and through ``mixed_precision=True``
   (``allocate_bits_speculative``) at the first rung of SPEC_BUDGETS
   where both are feasible, each capturing lazily.  Every response equals
   ``greedy_decode_reference`` at batch 1 bitwise; ``spec_stats()``, the
   wall per delivered token and tokens/s beside phase 7's pinned run, and
   the launches in each window (24 decode attentions and 97 ``row_gemm``
   per draft or verify step, 24 flash launches per prefill, the eager
   launches only the warm-up runs of graphs captured while serving).
   Before the engines, one round on a B = 4, T = 1024 block from the
   captured draft and verify steps against the closures run eagerly on a
   copy: tokens, counts, codes, scales and positions bitwise; the device
   ms of one draft and one verify step (CUDA events) and the wall per
   delivered token of a round, reading the active flag back after each
   verify step and with a fixed n_draft + 1 verify steps.
13. Adaptive serving from CUDA graphs at full width:
   ``AdaptiveCoInferenceEngine(path="kernel", compiled=True, max_batch=4)``
   over ADAPTIVE_CLASSES and phase 10's 12 requests spread over the
   ``edge-day`` trace (seed 0), once per policy (static, adaptive,
   oracle), ``warmup(512)`` first: the ``adaptive_report()``, the replans,
   the b̂ of every batch, the graphs captured while serving (a replan's
   new plan captures its buckets on first use) and the ``group_quantize``
   / ``qmm`` / ``qmm_int4`` / flash launches of each window.  Static never
   replans, adaptive replans at least once, no batch is served below 2
   bits and every logit is finite; one response per plan held against
   the plain path on the card (phase 4's tolerances).  Then on the
   ``constant`` trace the adaptive engine replays the batched engine's
   graphs and returns its responses bitwise.
14. A fleet at full width (``FleetCoInferenceEngine``, kernel path, mixed
   precision, CUDA graphs, ``max_batch`` 4, one shared codesign and one
   shared compile cache): FLEET_AGENTS, two qwen2-0.5b ``FULL`` agents over
   one params object (phase 4's; the kiosk adaptive under ``wifi-markov``)
   and one stablelm-3b ``FULL`` agent with its own seeded weights, six
   requests of 16-64 tokens each, through the joint allocator and then the
   equal split.  Every graph of the shared cache records 7 x split
   ``qmm``/``qmm_int4`` launches on the tensor-core route and one flash
   launch a layer, the eager launches are the captures' warm-up runs, one
   ``group_quantize`` launch per materialized weight set; every plan
   between 2 and 8 bits; the shares sum to at most 1 and the joint bound
   is at most the equal split's; one graph per (config, plan, bucket), the
   qwen agents sharing theirs; every member's responses equal a directly
   built engine's at its slice, with its own caches, bitwise; a one-agent
   fleet equals its direct engine bitwise; stablelm-3b's forward at its
   plan against the plain versions (phase 4's tolerances).  Prints each
   agent's share, plan, captures, and the 4 x 64 forward's device ms (CUDA
   events around one replay) and wall.  Phase 3 also holds
   ``qmm``/``qmm_int4`` at stablelm-3b's seven agent matmul shapes, and
   phase 8 flash at its heads (H = KV = 32, dh = 80).
15. Resilience at full width (qwen2-0.5b): the batched engine (phase 10's
   classes and requests, graphs) bare, supervised on a clean trace
   (bitwise the bare engine), then supervised and bare under
   ``examples/chaos_spec.json``, under the same spec with every time
   constant CHAOS_DILATION times longer (a full-width batch bills seconds,
   the spec spans 5 s), and under an uplink outage window longer than the
   retry budget (OUTAGE_WINDOW): delivered + failed + shed = submitted,
   nothing duplicated, no batch below 2 bits, at least one device-only
   failover (its operating point quantized and captured mid-traffic,
   counted); ``DecodeEngine`` and ``SpeculativeDecodeEngine``
   at (4, 4) on phase 7's prompts from graphs, with the server preempted in
   three windows (RESILIENT_CRASHES): every supervised stream equals its
   uninterrupted batch-1 reference bitwise, no token lost, at least one
   recovery (snapshot, wait, resume through the batch-1 graphs, timed),
   and the bare runs lose tokens; phase 14's joint fleet under agent
   dropout (RESILIENT_DROPOUT): one reallocation per membership edge,
   nothing lost; ``Trainer.fit`` (8 x 128, QAT 8, int8-EF) for 10 steps
   checkpointing every 5 (keep 1), then 5 steps and a fresh trainer that
   restores step 5 and runs to 10: the restored state bitwise the saved
   one, the losses against the uninterrupted run's (bitwise or within
   1e-4 relative, printed which), the checkpoint's bytes and its save and
   restore walls.
16. Decode at the reference's widths (qwen2-0.5b): ``DecodeEngine``
   at ``max_batch`` 32 serving 40 prompts from graphs, every response
   bitwise its batch-1 reference; then one token step at 32 slots of
   1,024 positions, one at the reference's ``DECODE_32K`` shape (B = 128,
   T = 32,768, ~27 GB of int8 cache) and one at ``LONG_500K`` (B = 1,
   T = 524,288), each from a seeded synthetic cache with ragged
   lengths: a few rows' logits alone bitwise the batched rows', the
   kernels against plain attention (logits within E2E_TOL, tokens equal
   wherever the plain run's top-2 margin exceeds twice the difference),
   the captured step against its closure run eagerly (tokens and written
   entries bitwise); device ms, wall, tokens/s and the memory the graph
   keeps (one attention workspace live at a time), its replays' and its
   capture's peaks printed, the capture saving only the entries its
   warm-up step writes (a copy of the whole block until ROADMAP C.10).
17. The wide dense decoders and the MoE decoders at their published
   widths (FAMILIES), one after another, each freed before the next:
   llava-next-mistral-7b (all 32 layers), granite-34b and internlm2-20b
   (16 layers), qwen3-moe-235b-a22b (2 layers, all 128 experts) and
   kimi-k2-1t-a32b (2 layers, 64 of 384 experts), seeded random weights;
   each cut printed as ``reduced: ...``.  For each: ``qmm``/``qmm_int4``
   (dense), ``row_gemm`` (every decode product, granite's down
   projection at K = 24,576 past 8 rows), decode attention and flash at
   its heads against their plain versions, rows alone bitwise, with
   kernel, plain, library and bound times; then the 4 x 64 forward (the
   dense three through the kernel path at b̂ = 8 and 4, launches asserted
   and held against the plain versions, llava with caption-proxy stub
   embeds for 32 of the 64 positions; an MoE model's fake-path agent
   against plain attention); then ``DecodeEngine`` from graphs over five
   prompts, 16 new tokens each (granite at 16 slots), every dense stream
   bitwise its batch-1 reference, and one token step on a seeded block
   (``wide_step``): kernels against plain attention, captured == eager,
   a dense model's rows alone bitwise (an MoE step past 8 experts shares
   the experts' capacity across its rows, as the reference's does).
   Prints each config's parameters, peak device memory and wall.
   The dense three also time one configure's ``group_quantize`` (every
   agent layer's matrices at b = 8) against the plain version and the
   byte bound, codes and scales equal.
18. The recurrent and encoder-decoder families, one at a time, seeded
   random weights, each freed before the next.  Flash at their heads
   against its plain version (FLASH_TOL, rows alone bitwise, beside SDPA
   and the bound): jamba's 64 over 8 at dh 128 causal, seamless's 16 at
   dh 64 bidirectional at S = T = 512 and as cross-attention at S = 256
   over T = 512 and S = 512 over T = 256.  One layer each of mLSTM,
   sLSTM (xlstm-350m's widths) and Mamba (jamba's) decoded token by token
   == its chunked forward over 64 inputs within 2e-3.  xlstm-350m
   ``FULL``: the 4 x 1024 forward, 64 tokens decoded from the zero state
   against it, ``prefill`` and 16 greedy steps, ``Trainer.fit`` at 8 x
   128 (QAT 8, int8 EF), every loss and grad norm finite.
   jamba-1.5-large-398b cut to one super-block (8 of 72 layers) and 4 of
   16 experts (2 if 4 do not fit): the 4 x 64 and 2 x 512 forwards, one
   flash launch each (counted), against plain attention with the kernel
   run's expert choices replayed; ``prefill`` and 16 greedy steps.
   seamless-m4t-large-v2 ``FULL`` over seeded stub frames: the 4 x (512
   frames, 256 tokens) forward, 72 flash launches (counted), against
   plain attention; ``prefill`` and 16 greedy steps; ``Trainer.fit`` at
   8 x (64, 64), 144 flash launches a step (counted).  Prints each
   model's walls, a decode step's device ms and the peak memory.
19. Training over a mesh of ranks, qwen2-0.5b ``FULL`` at phase 9's 8 x
   128 (QAT 8, int8 EF, seeded weights, MESH_STEPS steps a run): (a) a
   one-rank NCCL group and a (pod 1, data 1, model 1) mesh: the pod-wise
   step (its int8 all-gather over one rank) against phase 9's plain step
   from one state, params, m, v, residual and losses bitwise, its flash
   launches counted; (b) two ranks spawned on the one card as (pod 2,
   data 1, model 1) over gloo (NCCL takes one rank a GPU; gloo stages
   CUDA tensors through the host), each on its 4 rows: their losses,
   grad norms and every state leaf's bit fingerprint against the same two
   pods stepped in this process through the same functions (the
   all-gather replaced by stacking), bitwise, the params equal on both
   ranks after every step; the ranks' flash launches counted.  Prints the
   walls of each step and the peak memory of each rank.
20. The serving examples and the int8-resident forward.  (a) Each of the
   six ``examples/torch_*.py`` serving examples called in-process through
   its ``main([])`` on the card at its smoke config, ``co_inference_serve``
   three times (plain, ``--mixed-precision``, ``--compiled``): launch
   counts zeroed before each call and read after, every kernel that
   EXAMPLE_RUNS names for the call launched at least once (a graph's
   kernels count in its capture's eager warm-up run), the examples' own
   bitwise assertions (decode and speculative streams == the batch-1
   reference) held on the card; each call's printed lines, wall and peak
   memory, memory freed between calls.  (b) ``quantize_tree_stacked``
   over qwen2-0.5b ``FULL`` and stablelm-3b ``FULL`` (seeded weights, one
   model at a time) at int8 per-channel, at a per-layer plan cycling 2-8
   bits and at 12 bits (the int16 container): codes and scales bitwise
   the same call on a CPU copy of the weights (its first
   RESIDENT_HOST_LAYERS layers: each layer quantizes on its own, and the
   host's quantize was most of the phase); the 4 x 64 forward over
   each quantized tree bitwise the forward over its dequantized leaves,
   one flash launch a layer (counted); prints max |d logits| against the
   float forward, the quantized leaves' effective bytes against their
   float bytes, the quantize wall and the peak memory.
21. Tensor-parallel compute and MoE training over data-parallel ranks,
   each run spawned as phase 19 (b) spawns its ranks (gloo, sharing the
   card) and freed before the next.  (a) qwen2-0.5b ``FULL`` at phase 9's
   8 x 128 (QAT 8, int8 EF, TP_STEPS steps) over (data 1, model 2): each
   rank computes on its shards (7 of the 14 heads with their one KV
   head, half the MLP, half the vocabulary), its model-sharded leaves
   half their full size, the two ranks' parameters bitwise equal after
   every step; held against one rank's plain step on the card from the
   same seed: loss within 1e-4 relative each step, at most 0.1 % of the
   parameters beyond 1e-3 lr.  (b) qwen3-moe-235b-a22b at its published
   widths cut to 1 layer and 16 of 128 experts (top-8 kept), MOE_BATCH x
   MOE_SEQ over (data 2, model 1), MOE_STEPS steps: the global batch's
   512 tokens are one capacity group spanning both ranks (the queue
   counts exchanged), the router statistics summed; held against one
   rank's fit on the global batch by the same tolerances.  The state
   bytes of both runs are reckoned before they start.  Prints each
   rank's step walls, peak memory, the all-reduces and all-gathers a
   step (beside phase 19 (b)'s gathered run) and the flash launches
   (counted into the table).
22. The dry-run's accounting (``launch/opcount.py``, ``launch/dryrun.py``,
   ``launch/roofline.py``) on the card.  (a) For the co-inference forward
   4 x 64 at b̂ = 8 and 4 (each with its configure), the engine's B = 4
   token step over a seeded quantized cache (T = 1024), ``prefill`` 4 x
   64 and phase 9's 8 x 128 training step (QAT 8, int8 EF): the
   accountant over the real call on the card equals the accountant over
   the same call under ``FakeTensorMode`` (FLOPs, HBM and collective
   bytes exactly), its kernel ops' calls equal the launches counted, and
   the outputs under the accountant are bitwise the outputs without it;
   (e) the same call on ``meta`` tensors (the dry-run's) bills the same
   FLOPs, kernel-op calls and HBM bytes, op by op (``F.rms_norm`` one op
   on both, ``layers.rmsnorm``).
   (b) Each call's device ms (CUDA events, median of 5, L2 flushed)
   beside its compute and memory terms on the H100's constants (float32
   peak) and the ratio of the measured time to the bound.  (c)
   ``fused_attention_acct`` under ``flash_attention_mode`` on a one-rank
   mesh launches the flash kernel once and equals
   ``blockwise_attention`` bitwise.  (d) The dry-run in a subprocess:
   qwen2-0.5b x the four shapes x both meshes x {baseline, flash}, one
   cell of each other family (DRYRUN_OTHERS) and qwen2-0.5b's variant
   cells on both meshes (DRYRUN_VARIANTS: ``cacheshard``, ``notp``,
   ``seqshard``, ``int8w``), every record ``ok`` or ``skip``, written
   under chiprun_out/dryrun/; the roofline table and the phase's
   seconds.  The launches of phases 4-21 are printed before the phase's
   are added.
23. Tensor-parallel compute over (data 1, model 2) for the hybrid (jamba
   at one super-block), xlstm-350m and seamless-m4t-large-v2, and
   jamba-smoke's MoE over (data 2, model 1), two gloo ranks sharing the
   card, each held against one rank.
24. The dry-run's variants on real tensors, two gloo ranks sharing the
   card, against one rank.  (a) A cache whose sequence is split:
   qwen2-0.5b ``FULL`` over (data 1, model 2) on its tensor-parallel
   plan, prefill SEQ_PROMPT, the cache (every KV head) cut into halves of
   SEQ_T, then SEQ_NEW ``decode_step(..., cache_seq=)`` of the one-rank
   run's tokens; jamba (phase 23's cut, bfloat16) over (data 2, model 1)
   at B = 1, prefill JSEQ_PROMPT over JSEQ_T: logits within E2E_TOL of
   one rank's scale, greedy equal where clear, each step's write on the
   rank that owns its position only.  (b) ``notp``: phase 9's step over
   (data 1, model 2) with the sequence split (every part replicated, the
   per-token work on each rank's half, flash at the half's offset) held
   against one rank by phase 21's tolerances.  (c) ``int8w``: qwen2-0.5b's
   int8-resident prefill and one step over (model 2) within KERNEL_TOL of
   one rank's; each rank's held weight bytes.
25. Summary: one ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``; the per-shape numbers are printed
   in phases 3, 5, 6, 8, 17 and 18.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit),
# the port's one copy of them
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_FLOPS  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_F32 as F32_FLOPS  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_TF32 as TF32_FLOPS  # noqa: E402
QMM_PASSES = 3              # bf16 products per code on the wgmma route
QMM_M = (1, 64, 256, 1024)  # 64: the sequential engine, 256: the batch
KERNEL_TOL = 1e-4           # kernel vs plain: one matmul, the agent stage
E2E_TOL = 1e-2              # logits vs plain, relative to their max|.|
ROUTE_TIE = 1e-2            # an MoE token's expert choice may differ from
                            # the plain run's only between experts whose
                            # probabilities are this close, relative
B, S = 4, 64
SLEEP_CYCLES = 4_000_000    # ~2 ms of device time at H100 clocks
DECODE_TOL = 1e-5           # decode attention vs plain, x max|out|: f32
                            # sums over <= 4096 positions in another order
DECODE_PROMPTS = (240, 100, 330, 180, 450, 500)   # buckets 512 256 512 256
DECODE_ARRIVE = (0, 0, 8, 8, 16, 4)               # 512 1024; x one step
DECODE_NEW = 32
DECODE_BUDGET = (6.0, 2.0)  # (T0, E0) of the auto run: both CLI classes
                            # feasible at full width
# (what, B, T, H, KV, dh, lengths) of phase 5's caches past the old cap
LONG_DECODE_CASES = (("granite-34b heads", 2, 32768, 48, 1, 128,
                      [32768, 20001]),
                     ("qwen2-0.5b LONG_500K", 1, 524288, 14, 2, 64,
                      [524288 - 77]))
ROW_GEMM_TOL = 1e-5         # row_gemm vs plain, x max|y|: f32 sums over
                            # K <= 6912 in another order
ROW_GEMM_M = (1, 3, 4, 16, 17, 32, 128)
TC_GEMM_TOL = 1e-5          # tc_gemm vs plain, x max|y|: three TF32
                            # passes (~2^-22 a product), f32 sums over
                            # K <= 6912 in another order
TC_GEMM_M = (1, 17, 256, 506, 2048)   # 2048: a 4 x 512 bucket
TC_GEMM_TIMED_M = (256, 2048)         # 256: the 4 x 64 forward
# the parent commit's row_gemm.cu, when unpacked there (git archive of the
# parent into build/parent): phase 6 times it beside the kernel
PARENT_ROW_GEMM = ROOT / "build" / "parent" / "src" / "repro_torch" / \
    "kernels" / "csrc" / "row_gemm.cu"
# phase 16: DecodeEngine at 32 slots over 40 prompts of 16-96 tokens, 8 new
# each; one captured token step at 32 slots of 1,024 positions and at the
# reference's DECODE_32K (128 slots of 32,768 positions) and LONG_500K (1
# of 524,288) shapes (src/repro/configs/base.py), int8 cache (b_kv = 8)
WIDE_SLOTS, WIDE_PROMPTS, WIDE_PROMPT_LEN, WIDE_NEW = 32, 40, (16, 97), 8
WIDE_STEPS = (("32 slots", 32, 1024), ("DECODE_32K", 128, 32768),
              ("LONG_500K", 1, 524288))
# the graph token step (B = 4, T = 1024, b_kv = 8) as first captured, one
# row_gemm launch per product and the first row_gemm design (PERF.md
# section 5, H100 80GB HBM3, 700.00 W)
UNGROUPED_STEP = dict(wall_ms=5.568, tokens_s=718.4, device_ms=4.94)
FLASH_TOL = 2e-5            # flash vs plain, f32: tests/test_flash.py's
# flash at a query offset (B, T, offset, dtype, window): a chunk of T / 2
# queries; the first is phase 24 (b)'s notp chunk (8 x 128 over 2 ranks)
FLASH_OFFSETS = ((8, 128, 64, None, 0), (8, 128, 64, "bf16", 0),
                 (1, 1024, 512, None, 0), (2, 600, 300, None, 128),
                 (4, 256, 96, None, 0), (4, 128, 0, None, 0))
FLASH_PASSES = 3            # tf32 products per f32 product in the kernel
TC_GEMM_PASSES = 3          # and in tc_gemm
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 10
# (name, T0, E0) of the compiled serving phase: the codesign's b̂ is 4 and
# 8 for qwen2-0.5b's weights at the 4 x 64 workload (mid-region budgets)
COMPILED_CLASSES = (("int4", 1.3, 0.675), ("int8", 1.5, 0.775))
COMPILED_REQUESTS, COMPILED_SEQ = 12, (16, 512)
# (name, T0, E0) of the mixed-precision phase, between COMPILED_CLASSES'
# budgets: mean-bit budgets of 28 and 29 bits over the 6 agent layers
# (max_mean_bits 4.79 and 4.93, from the FLOP counts alone), so each plan
# holds int4-container (<= 4 bits) and int8-container (5-8 bits) layers
# and no 1-bit layer (ROADMAP C.7(c))
MIXED_CLASSES = (("mixed-a", 1.31, 0.68), ("mixed-b", 1.32, 0.68))
# the mixed decode run's classes: every b_kv rung they can take leaves a
# mean budget of at least 4.8 bits (no 1-bit layer)
DECODE_MIXED_CLASSES = (("mixed-a", 3.0, 1.2), ("mixed-b", 2.0, 1.5))
FCDNN_BITS = (3, 4, 6, 8)
FCDNN_TOL = 1e-4            # FC-DNN-16 card vs CPU: float32 products and
                            # sums over 16 layers in another order
STATS_TOL = 1e-5            # layer statistics card vs CPU: float32
                            # reductions over ~15 M weights a layer
BA_SLACK = (0.90, 1.10)     # tests/test_rate_distortion.py's, in its rate
BA_WINDOW = (0.5, 3.5)      # window
# phase 12's pinned draft schedules (b_draft, k) at (b̂, b_kv) = (8, 8),
# and the (T0, E0) ladder its auto and mixed runs take the first feasible
# rung of (the CLI's two decode classes around it)
SPEC_SCHEDULES = ((4, 4), (2, 4), (4, 16))
SPEC_BUDGETS = ((6.0, 2.0), (12.0, 4.0), (24.0, 8.0))
# phase 13's classes under edge-day at the 4 x 64 workload: b̂ = 6 and 8
# (the int8 kernels) at full clock and charge; under the thermal cap and
# the battery's derate no policy serves a batch below 2 bits (the
# controller's decisions are host math: checked on the CPU with the
# full-width FLOP counts and λ from 40 to 50)
ADAPTIVE_CLASSES = (("edge-a", 1.3, 1.2), ("edge-b", 1.5, 1.5))
# phase 14's fleet (name, arch, T0, E0, weight), mixed precision: each
# agent's constants carry its model's full-width FLOPs at the B x S
# workload, and under both allocators every member's mean-bit budget
# (max_mean_bits at its share; the kiosk's at each wifi-markov rate) lies
# in 4.2-5.7 bits, so its plans hold int4- and int8-container layers and
# none below 2 bits or above 8 (ROADMAP C.7(c); host math, checked on the
# CPU with these FLOP counts and the random weights' lambda, 45.0 and
# 69.5).  The drone's and the kiosk's good-link plans are the same, so
# they share graphs.
FLEET_AGENTS = (("drone", "qwen2-0.5b", 1.3, 0.775, 2.0),
                ("monitor", "stablelm-3b", 8.0, 3.0, 1.0),
                ("kiosk", "qwen2-0.5b", 1.3, 0.775, 1.0))
# the kiosk's uplink: 2 % of the 4 x 64 boundary's 16-bit bytes (a
# full-size boundary leaves no budget in wifi-markov's bad state), the
# good rate, a 0.25 W radio
FLEET_KIOSK_LINK = dict(emb_bytes_full=0.02 * B * S * 896 * 2.0,
                        link_bps=2.5e6, tx_power_w=0.25)
FLEET_REQUESTS, FLEET_SEQ, FLEET_GAP = 6, (16, 64), 8.0
SL_HEADS = dict(h=32, kv=32, dh=80)         # stablelm-3b's attention
# phase 17: the wide dense decoders and the MoE decoders at their published
# widths, one after another, (arch, layers kept (None: all), split, experts
# kept (None: all), decode slots).  Each cut keeps the model and the decode
# engine's fake-quantized copy of its layer stacks (and the serving
# engine's, for MoE) on one 80 GB card, with the transients of making that
# copy (a 3-layer qwen3-moe ran out of memory there on an H100 80GB);
# kimi-k2's full layer (67.6 GB of experts) alone does not fit.  granite-34b
# decodes at 16 slots, so its 24,576 -> 6144 product runs row_gemm at
# M = 16.
FAMILIES = (("llava-next-mistral-7b", None, 8, None, 4),
            ("granite-34b", 16, 4, None, 16),
            ("internlm2-20b", 16, 4, None, 4),
            ("qwen3-moe-235b-a22b", 2, 1, None, 4),
            ("kimi-k2-1t-a32b", 2, 1, 64, 4))
FAMILY_PROMPTS = (40, 100, 70, 150, 25)    # decode prompts' lengths
FAMILY_NEW = 16                            # new tokens each
FAMILY_QMM_M = (1, 256)                    # qmm's M at the new shapes
# phase 18: the recurrent and encoder-decoder families
XLSTM_FWD = (4, 1024)          # four 256-position chunks cross
XLSTM_TRAIN = (8, 128)
REC_CELL_STEPS = 64            # decoded tokens held against the forward
REC_TOL = 2e-3                 # the reference's decode == forward
REC_NEW = 16                   # greedy decode steps after prefill
JAMBA_EXPERTS = 4              # of 16, top-2 kept; 2 if 4 do not fit
JAMBA_HEADROOM = 5e9           # bytes the forwards and decode need beside
JAMBA_FWD = ((4, 64), (2, 512))    # 2 x 512: two Mamba chunks
SEAMLESS_FWD = (4, 512, 256)   # B, frames, tokens
SEAMLESS_TRAIN = (8, 64, 64)
# (name, B, S, T, H, KV, dh, causal): flash at the new families' heads
FLASH_RECURRENT = (
    ("jamba heads", 2, 512, 512, 64, 8, 128, True),
    ("seamless encoder", 4, 512, 512, 16, 16, 64, False),
    ("seamless cross S<T", 4, 256, 512, 16, 16, 64, False),
    ("seamless cross S>T", 4, 512, 256, 16, 16, 64, False))
# phase 15's batched runs also take examples/chaos_spec.json with every
# time constant (step, horizon, preemption's MTBF and MTTR) this many times
# longer, so that its faults land on seconds-long full-width batches
CHAOS_DILATION = 10
# phase 15's uplink outage window (virtual seconds) for the failover runs,
# and their class: its device-only failover and its split-served batches
# both land at b̂ = 4 (host math over the full-width FLOP counts: the
# deadline sets the first, the energy budget the second), so the failover
# batches serve through qmm_int4 (phase 10's classes fail over at 5 and 6,
# which the engine serves by the fake path)
OUTAGE_WINDOW = (0.5, 40.0)
OUTAGE_CLASS = ("failover", 1.21, 0.79)
# phase 15's dropout windows (virtual seconds) over the fleet's traffic
RESILIENT_DROPOUT = {"kiosk": (12.0, 24.0), "monitor": (30.0, 40.0)}
# phase 15's server preemption windows, as fractions of the uninterrupted
# decode run's virtual span: early, mid-stream and near retirement, as in
# the reference's parity matrix, but short enough (5 %) that no queued
# request waits past its shedding deadline (8 x T0) on top of its queueing
RESILIENT_CRASHES = ((0.10, 0.15), (0.40, 0.45), (0.75, 0.80))
# the recovery bills each resumed stream's remaining tokens one stream after
# another (the batch-1 reference), so a queued request waits for several
# streams; its shedding deadline is arrival + this x T0 (the supervisor's
# default 8 would shed a feasible request here)
RESILIENT_DEADLINE_FACTOR = 64.0


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, reps: int = 15) -> float:
    """Median device time of one call, L2 flushed before each launch.

    A device-side sleep between the flush and the start event keeps the
    card busy while the host enqueues the call, so the events bracket the
    call's device work, not the host's launch overhead."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, flops: float = F32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def agent_weight_shapes(cfg):
    """(name, K, N) of the matmuls of one agent layer: seven with the
    gated MLP, six with the non-gated one (granite-34b's wi)."""
    d, f = cfg.d_model, cfg.d_ff
    mlp = [("wi_gate", d, f), ("wi_up", d, f)] if cfg.act == "silu" \
        else [("wi", d, f)]
    return [("wq", d, cfg.q_dim), ("wk", d, cfg.kv_dim),
            ("wv", d, cfg.kv_dim), ("wo", cfg.q_dim, d)] + mlp \
        + [("ffn_wo", f, d)]


def check_kernels(cfg, dev, flush, detail, ms=QMM_M):
    """Phase 3 (and phase 17 at each dense config's widths, at the M in
    ``ms``); returns {kernel: summary numbers per forward}."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref

    shapes = agent_weight_shapes(cfg)
    split = cfg.split_layer
    gen = torch.Generator(device=dev).manual_seed(1)
    summary = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                       max_abs_err=0.0, bound_by={})
               for n in ("qmm", "qmm_int4")}
    seen = {}
    for name, k, n in shapes:
        key = (k, n)
        if key not in seen:
            w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
            x_all = torch.randn((1024, k), generator=gen, device=dev)
            seen[key] = per_shape(cfg, w, x_all[:max(ms)], flush, tk, ref,
                                  detail, ms)
        # one forward = this matmul once in each of the split agent layers
        for kern, rec in seen[key].items():
            s = summary[kern]
            for f in ("ms", "plain_ms", "bound_ms", "library_ms",
                      "bound_f32_ms"):
                if rec.get(f) is not None:
                    s.setdefault(f, 0.0)
                    s[f] += split * rec[f]
            s["max_abs_err"] = max(s["max_abs_err"], rec["max_abs_err"])
            by = s["bound_by"]
            by[rec["bound_by"]] = by.get(rec["bound_by"], 0.0) \
                + split * rec["bound_ms"]
    for s in summary.values():
        # the forward's bound is named by the side that holds most of it
        s["bound_by"] = max(s["bound_by"], key=s["bound_by"].get)
    return summary


def per_shape(cfg, w, x_all, flush, tk, ref, detail, ms=QMM_M):
    import torch
    k, n = w.shape
    g = 128
    out = {}
    for kern, bits in (("qmm", 8), ("qmm_int4", 4)):
        codes, scales = ref.group_quantize_ref(w, g, bits)
        if bits == 4:
            codes = ref.pack_int4_ref(codes)
        fn = getattr(tk, kern)
        plain = ref.qmm_ref if bits == 8 else ref.qmm_int4_ref
        w_deq = ref.dequantize_ref(ref.unpack_int4_ref(codes)
                                   if bits == 4 else codes, scales)
        assert qmm_module().route(k, n, g) == "wgmma"
        err = 0.0
        for m in ms:
            x = x_all[:m]
            before = fn.route_launches["wgmma"]
            got, want = fn(x, codes, scales), plain(x, codes, scales)
            torch.cuda.synchronize()
            assert fn.route_launches["wgmma"] == before + 1, kern
            err = max(err, float((got - want).abs().max()))
            torch.testing.assert_close(got, want, rtol=KERNEL_TOL,
                                       atol=KERNEL_TOL)
            if m in (64, 256):
                for i in range(m):
                    assert torch.equal(fn(x[i:i + 1], codes, scales)[0],
                                       got[i]), f"{kern} row {i} {k}x{n}"
        for m in ms:
            x = x_all[:m]
            n_bytes = m * k * 4 + codes.numel() + scales.numel() * 4 \
                + m * n * 4
            b, by = bound_ms(n_bytes, QMM_PASSES * 2.0 * m * n * k,
                             BF16_FLOPS)
            row = dict(ms=time_ms(lambda: fn(x, codes, scales), flush),
                       plain_ms=time_ms(lambda: plain(x, codes, scales),
                                        flush),
                       library_ms=time_ms(lambda: torch.matmul(x, w_deq),
                                          flush),
                       bound_ms=b, bound_by=by, max_abs_err=err,
                       bound_f32_ms=bound_ms(n_bytes, 2.0 * m * n * k)[0])
            detail.append(dict(kernel=kern, m=m, k=k, n=n, g=g, **row))
            if m == B * S:
                out[kern] = row
    return out


def configure_weights(cfg, dev, seed=1):
    """One configure's matrices: the seven of each agent layer, random
    weights at qwen2-0.5b's widths."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
            for _ in range(cfg.split_layer)
            for _, k, n in agent_weight_shapes(cfg)]


def check_group_quantize(cfg, dev, flush):
    """Phase 3, ``group_quantize``: both routes bitwise against the plain
    version, then one configure's time; returns its summary numbers."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import build
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import ref

    def plain(w, g, bits, pack):
        codes, scales = ref.group_quantize_ref(w, g, bits)
        return (ref.pack_int4_ref(codes) if pack and bits <= 4 else codes,
                scales)

    gen = torch.Generator(device=dev).manual_seed(3)
    mats = [(torch.randn((k, n), generator=gen, device=dev), g)
            for k, n, g in [(k, n, 128)
                            for _, k, n in agent_weight_shapes(cfg)[:5]]
            + [(4864, 896, 128),          # down
               (640, 132, 64),            # odd: a ragged column tile
               (192, 896, 1),             # SIMT: per-element groups
               (130, 7, 1), (256, 127, 64)]]
    mats[0][0][:128] = 0.0                # an all-zero group
    n_vec = sum(q.route(w.shape[0], w.shape[1], g) == "vector"
                for w, g in mats)
    assert n_vec == 7, n_vec
    for bits, pack in ((8, False), (4, False), (4, True), (3, True)):
        before = dict(tk.group_quantize.route_launches)
        got = q.group_quantize_many([w for w, _ in mats],
                                    [g for _, g in mats],
                                    [bits] * len(mats), pack=pack)
        torch.cuda.synchronize()
        routes = tk.group_quantize.route_launches
        assert routes["vector"] == before["vector"] + 1, routes
        assert routes["simt"] == before["simt"] + len(mats) - n_vec, routes
        for (w, g), (codes, scales) in zip(mats, got):
            want = plain(w, g, bits, pack)
            what = f"group_quantize {tuple(w.shape)} G={g} bits={bits} " \
                f"pack={pack}"
            assert torch.equal(codes, want[0]), what + ": codes"
            assert torch.equal(scales, want[1]), what + ": scales"
    # one table of mixed bit-widths (a mixed-precision configure), packed
    # where <= 4, in one vector launch
    mixed = [2, 3, 5, 6, 7, 8, 2, 3, 5, 7]
    before = dict(tk.group_quantize.route_launches)
    got = q.group_quantize_many([w for w, _ in mats], [g for _, g in mats],
                                mixed, pack=True)
    torch.cuda.synchronize()
    routes = tk.group_quantize.route_launches
    assert routes["vector"] == before["vector"] + 1, routes
    for (w, g), b, (codes, scales) in zip(mats, mixed, got):
        want = plain(w, g, b, True)
        what = f"group_quantize {tuple(w.shape)} G={g} bits={b} (mixed table)"
        assert torch.equal(codes, want[0]), what + ": codes"
        assert torch.equal(scales, want[1]), what + ": scales"
    print(f"group_quantize vs plain: ok, {len(mats)} matrices ({n_vec} on "
          f"the vector route in one launch, {len(mats) - n_vec} SIMT) at "
          f"bits 8, 4, 4 packed, 3 packed, and one table of bits {mixed} "
          f"(packed where <= 4): codes, scales and packed nibbles equal")

    # one configure at b = 8 (42 matrices), and at b = 4 packed
    ws = configure_weights(cfg, dev)
    groups = [128] * len(ws)
    simt = q._entry("group_quantize_f32")

    def first_design(bits=8):
        # the first kernel (the SIMT route) on every matrix, one launch each
        stream = torch.cuda.current_stream().cuda_stream
        for w in ws:
            codes = torch.empty(w.shape, dtype=torch.int8, device=dev)
            scales = torch.empty((w.shape[0] // 128, w.shape[1]),
                                 device=dev)
            build.check(simt(w.data_ptr(), codes.data_ptr(),
                             scales.data_ptr(), w.shape[0], w.shape[1], 128,
                             bits, stream), "group_quantize_f32")

    def grouped(bits=8, pack=False):
        return q.group_quantize_many(ws, groups, [bits] * len(ws), pack=pack)

    def per_matrix(bits=8):
        for w in ws:
            q.group_quantize_many([w], [128], [bits])

    def plain_all(bits=8):
        for w in ws:
            ref.group_quantize_ref(w, 128, bits)

    for a, b in zip(grouped(), [plain(w, 128, 8, False) for w in ws]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    n_el = sum(w.numel() for w in ws)
    n_bytes = 4 * n_el + n_el + 4 * n_el // 128
    b8, by = bound_ms(n_bytes, 2.0 * n_el)
    b4, _ = bound_ms(4 * n_el + n_el // 2 + 4 * n_el // 128, 2.0 * n_el)
    row = dict(ms=time_ms(grouped, flush),
               plain_ms=time_ms(plain_all, flush, reps=5),
               bound_ms=b8, bound_by=by, library_ms=None, max_abs_err=0.0)
    per = time_ms(per_matrix, flush)
    first = time_ms(first_design, flush)
    packed = time_ms(lambda: grouped(4, True), flush)
    print(f"  group_quantize per configure ({len(ws)} matrices, "
          f"{n_el / 1e6:.1f} M weights, G=128): grouped launch "
          f"ms={row['ms']:.4f} (int4 packed {packed:.4f}, bound {b4:.4f}) "
          f"per-matrix launches {per:.4f} first design (SIMT, "
          f"{len(ws)} launches) {first:.4f} plain={row['plain_ms']:.4f} "
          f"bound={b8:.4f} ({by}); {b8 / row['ms']:.1%} of the bound")
    row["first_design_ms"] = first
    return row


def qmm_module():
    """``repro_torch.kernels.qmm`` (the package's ``qmm`` is the wrapper)."""
    import importlib
    return importlib.import_module("repro_torch.kernels.qmm")


def check_qmm_simt(dev):
    """The SIMT route, held against the plain version at a per-element
    group layout (G = 1, as ``group_layout`` gives K = 192)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(2)
    k, n, g = 192, 896, 1
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    x = torch.randn((B * S, k), generator=gen, device=dev)
    err = 0.0
    for kern, bits in (("qmm", 8), ("qmm_int4", 4)):
        codes, scales = ref.group_quantize_ref(w, g, bits)
        if bits == 4:
            codes = ref.pack_int4_ref(codes)
        fn = getattr(tk, kern)
        plain = ref.qmm_ref if bits == 8 else ref.qmm_int4_ref
        assert qmm_module().route(k, n, g) == "simt"
        before = fn.route_launches["simt"]
        got = fn(x, codes, scales)
        torch.cuda.synchronize()
        assert fn.route_launches["simt"] == before + 1, kern
        want = plain(x, codes, scales)
        torch.testing.assert_close(got, want, rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL)
        err = max(err, float((got - want).abs().max()))
    print(f"qmm SIMT route (M={B * S} K={k} N={n} G={g}, int8 and int4) "
          f"vs plain: ok, max|d|={err:.3e}")


def plain_attend(cfg):
    """A model's ``attend`` through the flash kernel's plain version."""
    from repro_torch.kernels import ref

    def attend(q, k, v):
        return ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=cfg.sliding_window).transpose(1, 2)
    return attend


def plain_lm(cfg):
    """``DecoderLM`` whose full-sequence attention is the plain version
    (differentiable: autograd runs through it)."""
    from repro_torch.models.lm import DecoderLM

    class PlainLM(DecoderLM):
        def attend(self, q, k, v):
            return plain_attend(self.cfg)(q, k, v)
    return PlainLM(cfg)


def plain_agent_stage(eng, params, batch, layer_bits):
    """The agent stage of ``batch`` (a dict on the card: tokens, and a
    vision model's stub embeds) with every kernel replaced by its plain
    version (weights quantized by the plain quantizer, the plain
    attention)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import group_layout
    from repro_torch.models.lm import tree_map
    from repro_torch.runtime import fastpath as fp

    cfg = eng.cfg
    lp = params["layers"]
    x, pos = eng.model.embed(params, batch)
    side = fp.layer_side_tree(lp, cfg)
    for i, bits in enumerate(layer_bits):
        def quant(leaf):
            w = leaf[i].contiguous()
            codes, scales = ref.group_quantize_ref(
                w, group_layout(w.shape[0], 128), bits)
            if bits <= 4:
                codes = ref.pack_int4_ref(codes)
            return {"codes": codes, "scales": scales}
        w = {"attn": {n: quant(lp["attn"][n]) for n in
                      ("wq", "wk", "wv", "wo")},
             "ffn": {n: quant(lp["ffn"][n]) for n in
                     ("wi_gate", "wi_up", "wi", "wo") if n in lp["ffn"]}}
        mm = ref.qmm_int4_ref if bits <= 4 else ref.qmm_ref
        x = fp.quantized_block(cfg, lambda wd, h: mm(h, wd["codes"],
                                                    wd["scales"]),
                               w, tree_map(lambda a: a[i], side), x, pos,
                               plain_attend(cfg))
    return x, pos


def hold_against_plain(eng, plain_model, point, path, logits, tokens,
                       tok_dev, embeds=None):
    """The served forward ``logits`` (of ``tokens``, after a vision
    model's stub ``embeds`` when given, at ``point``, the engine
    configured there) against the plain-version forward on the card: the
    boundary activation within KERNEL_TOL of its scale, the logits within
    E2E_TOL of theirs, greedy tokens equal wherever the plain logits'
    top-2 margin exceeds twice the error.  Returns the line to print and
    the plain logits' scale."""
    import torch
    from repro_torch.core.quantization import QuantPlan
    cfg = eng.cfg
    batch, batch_dev = {"tokens": tokens}, {"tokens": tok_dev}
    if embeds is not None:
        batch = {"embeds": embeds, "tokens": tokens}
        batch_dev = {"embeds": torch.as_tensor(embeds, device=tok_dev.device),
                     "tokens": tok_dev}
    seq = tokens.shape[1] + (0 if embeds is None else embeds.shape[1])
    assert logits.shape == (tokens.shape[0], seq, cfg.vocab_size)
    assert torch.isfinite(logits).all(), f"{path}: non-finite logits"
    bits = point.layer_bit_list(cfg.split_layer) \
        if isinstance(point, QuantPlan) else [point] * cfg.split_layer
    emb, _ = eng.agent_stage(batch)
    emb_p, pos = plain_agent_stage(eng, eng.params, batch_dev, bits)
    emb_scale = float(emb_p.abs().max())
    emb_diff = float((emb - emb_p).abs().max())
    assert emb_diff <= KERNEL_TOL * emb_scale, \
        f"{path}: boundary activation differs by {emb_diff}"
    kernel_model, eng.model = eng.model, plain_model
    try:
        with plain_products():
            ref_logits = eng.server_stage(eng.transport(emb_p)[0], pos)
    finally:
        eng.model = kernel_model
    scale = float(ref_logits.abs().max())
    diff = float((logits - ref_logits).abs().max())
    assert diff <= E2E_TOL * scale, f"{path}: logits differ by {diff}"
    # a nearer tie than the measured error is a coin flip
    top2 = ref_logits.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * diff
    same = logits.argmax(-1) == ref_logits.argmax(-1)
    assert bool(same[clear].all()), f"{path}: greedy tokens differ"
    return (f"boundary max|d|={emb_diff:.3e} of {emb_scale:.3e}; logits "
            f"max|d|={diff:.3e} of {scale:.3e}; greedy equal at "
            f"{int(same.sum())}/{same.numel()} ({int(clear.sum())} clear)",
            scale)


def agent_products(cfg) -> int:
    """Matmuls of one agent layer: wq, wk, wv, wo and the MLP's (gate, up
    and down for the gated SiLU MLP; wi and wo for the non-gated one)."""
    return 7 if cfg.act == "silu" else 6


def launches_per_forward(agent_path: str, cfg):
    """(int8, int4) qmm launches one forward of ``cfg`` makes on this
    agent path: ``agent_products(cfg)`` a kernel layer."""
    if agent_path == "fake":
        return 0, 0
    if agent_path.startswith("kernel-mixed["):
        bits = [int(b) for b in agent_path[len("kernel-mixed["):-1]
                .split("/")]
    else:
        bits = [int(agent_path[len("kernel-int"):])] * cfg.split_layer
    per = agent_products(cfg)
    return (per * sum(4 < b <= 8 for b in bits),
            per * sum(b <= 4 for b in bits))


def tc_gemm_per_forward(agent_path: str, cfg) -> int:
    """``tc_gemm`` launches one split forward of ``cfg`` makes on this
    agent path: every product of a layer that is not on ``qmm`` (the
    server stage's, and the agent's on the fake path or a mixed plan's
    layers past 8 bits; an MoE layer's four attention products: its
    experts run as torch products) and the head."""
    if agent_path == "fake":
        fake = cfg.split_layer
    elif agent_path.startswith("kernel-mixed["):
        fake = sum(int(b) > 8 for b in
                   agent_path[len("kernel-mixed["):-1].split("/"))
    else:
        fake = 0
    per = 4 if cfg.n_experts else agent_products(cfg)
    return per * (cfg.n_layers - cfg.split_layer + fake) + 1


@contextlib.contextmanager
def plain_products():
    """The split forward's products through ``torch.matmul`` (the
    layers' plain ``matmul_group``) while a plain-version forward runs
    through an engine: its ``tc_gemm`` hooks are looked up at each call."""
    import torch
    from repro_torch.models import layers as L
    hooks = L.tc_matmul, L.tc_matmul_group
    L.tc_matmul, L.tc_matmul_group = torch.matmul, L.matmul_group
    try:
        yield
    finally:
        L.tc_matmul, L.tc_matmul_group = hooks


def decode_case(dev, b, t, b_kv, seed, lens, h=14, kv=2, dh=64):
    """q, codes, scales and lengths on the card, at qwen2-0.5b's heads."""
    import torch
    from repro_torch.kernels.quantize import kv_quantize
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, 1, h, dh), generator=gen, device=dev)
    k = torch.randn((b, t, kv, dh), generator=gen, device=dev)
    v = torch.randn((b, t, kv, dh), generator=gen, device=dev)
    if b_kv < 16:
        (kc, ks), (vc, vs) = kv_quantize(k, b_kv), kv_quantize(v, b_kv)
    else:
        kc, vc = k, v
        ks = vs = torch.ones(k.shape[:-1], device=dev)
    return q, kc, vc, ks, vs, torch.tensor(lens, dtype=torch.int32,
                                           device=dev)


def decode_bound(args, window: int = 0):
    """(ms, "bytes"|"operations") of one decode-attention call: q and the
    output once, and the codes and scales of every live position once
    (the kernel walks only tiles that hold one); 4 * G * dh f32 flops per
    live position and kv head."""
    q, kc, _, _, _, lens = args
    b, _, h, dh = q.shape
    t, kv = kc.shape[1], kc.shape[2]
    live = 0
    for n in lens.tolist():
        lo = max(n - window, 0) if window > 0 else 0
        live += max(min(n, t) - lo, 0)
    per_pos = kv * (2 * dh * kc.element_size() + 2 * 4)
    n_bytes = 2 * b * h * dh * 4 + b * 4 + live * per_pos
    return bound_ms(n_bytes, live * kv * 4.0 * (h // kv) * dh)


def check_decode_kernel(dev, flush):
    """Phase 5; returns the kernel's summary numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import CHUNK as c
    from repro_torch.kernels.decode_attn import smem_bytes
    from repro_torch.kernels.quantize import kv_dequantize

    err = 0.0
    cases = [(b, t, b_kv, 0, [0, 1, t // 2 + 3, t] if b == 4 else [t - 5])
             for b in (1, 4) for t in (128, 1024, 4096) for b_kv in (4, 8, 16)]
    cases.append((4, 1024, 8, 100, [0, 1, 1024 // 2 + 3, 1024]))
    # lengths on and beside the chunk boundaries; the long cache windowed
    cases += [(6, t, b_kv, window, [0, 1, c - 1, c, c + 1, t])
              for t, window in ((1024, 0), (4096, 100), (4096, 1000))
              for b_kv in (4, 8, 16)]
    for b, t, b_kv, window, lens in cases:
        args = decode_case(dev, b, t, b_kv, seed=t + b_kv, lens=lens)
        out = tk.quantized_decode_attention(*args, window=window)
        want = ref.quantized_decode_attention_ref(*args, window=window)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        diff = float((out - want).abs().max())
        assert diff <= DECODE_TOL * scale, \
            f"decode attention B={b} T={t} b_kv={b_kv} window={window}: " \
            f"{diff} of {scale}"
        err = max(err, diff)
        if b > 1:
            assert bool((out[0] == 0).all()), "cache_len 0 attended"
            for i in range(b):
                alone = tk.quantized_decode_attention(
                    *(a[i:i + 1] for a in args), window=window)
                assert torch.equal(alone[0], out[i]), \
                    f"decode attention row {i} alone != in batch (T={t})"
        q, kc, vc, ks, vs, ln = args
        pad = (0, 0, 0, 0, 0, t)
        grown = tk.quantized_decode_attention(
            q, F.pad(kc, pad), F.pad(vc, pad), F.pad(ks, pad[2:], value=1.0),
            F.pad(vs, pad[2:], value=1.0), ln, window=window)
        assert torch.equal(grown, out), \
            f"decode attention at 2T != at T={t} (B={b}, b_kv={b_kv})"
    # twice on the same inputs: the arrival counters were left at zero
    args = decode_case(dev, 4, 1024, 8, seed=8, lens=[1024, 800, 532, 300])
    before = tk.quantized_decode_attention.launches
    first = tk.quantized_decode_attention(*args)
    second = tk.quantized_decode_attention(*args)
    torch.cuda.synchronize()
    assert tk.quantized_decode_attention.launches == before + 2
    assert torch.equal(first, second), "decode attention: a second launch " \
        "on the same inputs changed bits"
    print(f"decode attention vs plain: ok over {len(cases)} cases (chunk "
          f"edges, windows 100 and 1000 at T=4096), max|d|={err:.3e}; rows "
          f"alone, T -> 2T and a second launch bitwise")

    # past the shared-memory cap the combine once had (T 21,632 at G = 48,
    # dh = 128; ~224K at qwen2's heads): the plain version on 4096-position
    # tiles (its tile changes its order of sums, not what it computes)
    for what, b, t, h, kv, dh, lens in LONG_DECODE_CASES:
        args = decode_case(dev, b, t, 8, seed=t, lens=lens, h=h, kv=kv,
                           dh=dh)
        out = tk.quantized_decode_attention(*args)
        want = ref.quantized_decode_attention_ref(*args, block_t=4096)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        diff = float((out - want).abs().max())
        assert diff <= DECODE_TOL * scale, \
            f"decode attention {what}: {diff} of {scale}"
        err = max(err, diff)
        for i in range(b if b > 1 else 0):
            alone = tk.quantized_decode_attention(*(a[i:i + 1]
                                                    for a in args))
            assert torch.equal(alone[0], out[i]), \
                f"decode attention {what}: row {i} alone != in batch"
        ms = time_ms(lambda: tk.quantized_decode_attention(*args), flush,
                     reps=5)
        print(f"  quantized_decode_attention {what} (B={b}, T={t}, H={h} "
              f"over KV={kv}, dh={dh}, b_kv=8, lengths {lens}, "
              f"{-(-max(lens) // c)} chunks for one combine): vs plain "
              f"max|d|={diff:.3e} of {scale:.3e}; ms={ms:.4f} "
              f"bound={decode_bound(args)[0]:.6f}; smem "
              f"{smem_bytes(h // kv, dh, t)} bytes a block")
        del args, out, want

    # times at the decode path's widest shape: B = 4 slots of a 1024
    # bucket, int8 codes, lengths as the path gives them
    rows = {}
    for b_kv in (8, 4, 16):
        args = decode_case(dev, 4, 1024, b_kv, seed=b_kv,
                           lens=[1024, 800, 532, 300])
        q, kc, vc, ks, vs, lens = args
        qh = q.transpose(1, 2)                             # [B, H, 1, dh]
        kd = kv_dequantize(kc, ks).transpose(1, 2).contiguous()
        vd = kv_dequantize(vc, vs).transpose(1, 2).contiguous()
        mask = (torch.arange(1024, device=dev)[None, :]
                < lens[:, None].long())[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask,
                                                  enable_gqa=True)

        lib_out = library().transpose(1, 2)
        kern_out = tk.quantized_decode_attention(*args)
        torch.cuda.synchronize()
        lib_d = float((lib_out - kern_out).abs().max())
        b_ms, by = decode_bound(args)
        rows[b_kv] = dict(
            ms=time_ms(lambda: tk.quantized_decode_attention(*args), flush),
            plain_ms=time_ms(
                lambda: ref.quantized_decode_attention_ref(*args), flush),
            library_ms=time_ms(library, flush), bound_ms=b_ms, bound_by=by,
            max_abs_err=err)
        r = rows[b_kv]
        print(f"  quantized_decode_attention B=4 T=1024 b_kv={b_kv:2d} "
              f"ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"sdpa={r['library_ms']:.4f} (f32 cache, dequant not "
              f"timed; max|d| vs kernel {lib_d:.2e}) kernel/sdpa="
              f"{r['ms'] / r['library_ms']:.3f} bound={b_ms:.6f} ({by})")
    return rows[8]


def row_gemm_launches(cfg):
    """(name, K, [N...], bias, kernel launches a token step, products the
    parent kernel launched a step, w layout) of the decode step's
    products: the kernel launches q | k | v and gate | up grouped, wo,
    down and the head, on the layout the model passes it (the tied
    ``tok.T``, "nk", or the untied ``unembed`` [D, V], "kn"); the single
    products' shapes are timed too (the parent launched each, 169 a
    qwen2-0.5b step)."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    head = "nk" if cfg.tie_embeddings else "kn"
    if cfg.q_dim == d:
        out = [("wq/wo", d, [d], False, L, 2 * L, "kn")]
    else:                       # qwen3-moe: 64 heads of 128 over d 4096
        out = [("wq", d, [cfg.q_dim], False, 0, L, "kn"),
               ("wo", cfg.q_dim, [d], False, L, L, "kn")]
    out.append(("wk/wv", d, [cfg.kv_dim], False, 0, 2 * L, "kn"))
    if cfg.n_experts:           # the experts run as torch products
        out.append(("router", d, [cfg.n_experts], False, L, L, "kn"))
    elif cfg.act == "silu":
        out += [("gate/up", d, [f], False, 0, 2 * L, "kn"),
                ("down", f, [d], False, L, L, "kn")]
    else:                       # granite-34b's non-gated MLP
        out += [("wi", d, [f], False, L, L, "kn"),
                ("down", f, [d], False, L, L, "kn")]
    out += [("head", d, [cfg.vocab_size], False, 1, 1, head),
            ("q|k|v", d, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], cfg.qkv_bias,
             L, 0, "kn")]
    if cfg.act == "silu" and not cfg.n_experts:
        out.append(("gate|up", d, [f, f], False, L, 0, "kn"))
    return out


def row_gemm_per_step(cfg) -> int:
    """``row_gemm`` launches of one decode token step: 4 a dense layer
    (q | k | v, wo, gate | up or wi, down), 3 an MoE layer (q | k | v, wo,
    the router), and the head."""
    return sum(e[4] for e in row_gemm_launches(cfg))


def parent_row_gemm():
    """The parent commit's kernel, built, as (launch closure factory), or
    None when its source is not unpacked under build/parent."""
    if not PARENT_ROW_GEMM.is_file():
        return None
    import importlib.util
    from repro_torch.kernels import build
    spec = importlib.util.spec_from_file_location(
        "row_gemm_tune", ROOT / "tools" / "row_gemm_tune.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    fn = tool.parent_library(build, PARENT_ROW_GEMM)
    return lambda x, w: tool.parent_call(fn, x, w, build)


def check_row_gemm(cfg, dev, flush, parent=None, seed=4):
    """Phase 6 at one config; returns the kernel's numbers summed over one
    B = 4 token step's launches (97 at qwen2-0.5b)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref
    from repro_torch.kernels.row_gemm import row_gemm_group

    gen = torch.Generator(device=dev).manual_seed(seed)
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, parent_ms=0.0,
                 matmul_parent_ms=0.0, n_bytes=0.0, n_ops=0.0,
                 max_abs_err=0.0, launches=0, parent_launches=0)
    for name, k, ns, bias, per, per_parent, layout in \
            row_gemm_launches(cfg):
        ws = [(torch.randn((k, n), generator=gen, device=dev) if layout ==
               "kn" else torch.randn((n, k), generator=gen, device=dev).T)
              * k ** -0.5 for n in ns]
        bs = [torch.randn((n,), generator=gen, device=dev) * 0.1
              for n in ns] if bias else None
        x_all = torch.randn((max(ROW_GEMM_M), k), generator=gen, device=dev)

        def kern(x):
            if len(ws) == 1:
                return [tk.row_gemm(x, ws[0])]
            return row_gemm_group(x, ws, bs)

        def plain(x):
            return ref.row_gemm_group_ref(x, ws, bs or [None] * len(ws))

        err = 0.0
        for m in ROW_GEMM_M:
            x = x_all[:m]
            before = tk.row_gemm.launches
            got, want = kern(x), plain(x)
            torch.cuda.synchronize()
            assert tk.row_gemm.launches == before + 1, name
            for i, (g, wnt) in enumerate(zip(got, want)):
                d = float((g - wnt).abs().max())
                scale = float(wnt.abs().max())
                assert d <= ROW_GEMM_TOL * scale, \
                    f"row_gemm {name} M={m}: {d} of {scale}"
                err = max(err, d)
                if len(ws) > 1:           # grouped == its own launch
                    alone = tk.row_gemm(x, ws[i])
                    assert torch.equal(g, alone + bs[i] if bias
                                       else alone), \
                        f"row_gemm {name} M={m}: product {i} grouped != " \
                        "alone"
            for r in range(m):
                row = kern(x[r:r + 1])
                assert all(torch.equal(a[0], g[r])
                           for a, g in zip(row, got)), \
                    f"row_gemm {name} M={m}: row {r} alone != in batch"
        x = x_all[:B]
        wcat = torch.cat(ws, dim=1) if len(ws) > 1 else ws[0]
        if bias:
            bcat = torch.cat(bs)
            library = lambda: torch.addmm(bcat, x, wcat)     # noqa: E731
        else:
            library = lambda: torch.matmul(x, wcat)          # noqa: E731
        n_tot = sum(ns)
        n_bytes = 4.0 * (B * k + k * n_tot + B * n_tot)
        n_ops = 2.0 * B * n_tot * k
        b_ms, by = bound_ms(n_bytes, n_ops)
        r = dict(ms=time_ms(lambda: kern(x), flush),
                 plain_ms=time_ms(lambda: plain(x), flush, reps=5),
                 library_ms=time_ms(library, flush))
        if parent is not None:
            calls = [parent(x, w)[0] for w in ws]
            r["parent_ms"] = sum(time_ms(c, flush) for c in calls)
        print(f"  row_gemm {cfg.name} {name:8s} M={B} K={k} N={ns} "
              f"({layout}) ms={r['ms']:.4f} parent="
              + (f"{r['parent_ms']:.4f}" if parent is not None
                 else "not measured")
              + f" plain={r['plain_ms']:.4f} library={r['library_ms']:.4f} "
              f"bound={b_ms:.6f} ({by}); x{per} a step (the parent "
              f"x{per_parent * len(ws)}); max|d| {err:.2e} over M in "
              f"{ROW_GEMM_M}")
        for f in ("ms", "plain_ms", "library_ms"):
            total[f] += per * r[f]
        if parent is not None:
            total["parent_ms"] += per_parent * r["parent_ms"]
        total["matmul_parent_ms"] += per_parent * r["library_ms"]
        total["parent_launches"] += per_parent * len(ws)
        total["n_bytes"] += per * n_bytes
        total["n_ops"] += per * n_ops
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["launches"] += per
    total["bound_ms"], total["bound_by"] = bound_ms(total["n_bytes"],
                                                    total["n_ops"])
    print(f"row_gemm vs plain ({cfg.name}): ok, within {ROW_GEMM_TOL} x "
          f"max|y| at M in {ROW_GEMM_M}, rows alone and grouped == alone "
          f"bitwise; one B={B} token step ({total['launches']} launches, "
          f"{total['n_bytes'] / 1e9:.3f} GB): ms={total['ms']:.4f} "
          f"(parent " + (f"{total['parent_ms']:.4f}" if parent is not None
                         else "not measured")
          + f") plain={total['plain_ms']:.4f} "
          f"library={total['library_ms']:.4f} (the parent's "
          f"{total['parent_launches']} products through torch.matmul "
          f"{total['matmul_parent_ms']:.4f}) "
          f"bound={total['bound_ms']:.4f} ({total['bound_by']}), "
          f"{total['bound_ms'] / total['ms']:.1%} of the bound; "
          f"{card_line()}")
    return total


def tc_gemm_shapes(cfg):
    """(name, K, N, w layout, launches of one split forward) of the server
    stage's products: q, k, v, wo, the MLP's and the head (the tied
    ``tok.T``, "nk", or the untied ``unembed`` [D, V], "kn")."""
    d, f = cfg.d_model, cfg.d_ff
    n_srv = cfg.n_layers - cfg.split_layer
    mlp = [("gate/up", d, f, "kn", 2 * n_srv)] if cfg.act == "silu" \
        else [("wi", d, f, "kn", n_srv)]
    return [("wq", d, cfg.q_dim, "kn", n_srv),
            ("wk/wv", d, cfg.kv_dim, "kn", 2 * n_srv),
            ("wo", cfg.q_dim, d, "kn", n_srv)] + mlp + [
            ("down", f, d, "kn", n_srv),
            ("head", d, cfg.vocab_size,
             "nk" if cfg.tie_embeddings else "kn", 1)]


def check_tc_gemm(cfg, dev, flush, seed=6):
    """Phase 6's tensor-core GEMM at one config's split-forward products:
    within TC_GEMM_TOL x max|y| of the plain version at every M of
    TC_GEMM_M, every row bitwise across them (the rows at M = 17, 256 and
    506 taken from other places of the 2,048, so that a row sits elsewhere
    in its 64-row tile; sampled rows at M = 1), a CUDA-graph replay
    bitwise the eager launch; timed at TC_GEMM_TIMED_M, L2 flushed,
    against torch.matmul and the bound (three TF32 passes at the tensor
    cores' peak vs the bytes; the f32 SIMT bound beside).  Returns the
    numbers summed over one 4 x 64 forward's server products."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref
    from repro_torch.runtime.fastpath import CapturedCall
    tg = importlib.import_module("repro_torch.kernels.tc_gemm")

    gen = torch.Generator(device=dev).manual_seed(seed)
    m_all = max(TC_GEMM_M)
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, n_bytes=0.0,
                 n_ops=0.0, max_abs_err=0.0, launches=0, ms_2048=0.0,
                 library_ms_2048=0.0)
    for name, k, n, layout, per in tc_gemm_shapes(cfg):
        w = (torch.randn((k, n), generator=gen, device=dev) if layout ==
             "kn" else torch.randn((n, k), generator=gen, device=dev).T) \
            * k ** -0.5
        x_all = torch.randn((m_all, k), generator=gen, device=dev)
        before = tk.tc_gemm.launches
        full = tk.tc_gemm(x_all, w)
        want = ref.tc_gemm_ref(x_all, w)
        torch.cuda.synchronize()
        assert tk.tc_gemm.launches == before + 1, name
        err = float((full - want).abs().max())
        scale = float(want.abs().max())
        assert err <= TC_GEMM_TOL * scale, \
            f"tc_gemm {cfg.name} {name}: {err} of {scale}"
        del want
        for m in TC_GEMM_M[1:-1]:
            off = {17: 31, 256: 100, 506: 1000}.get(m, 0)
            part = tk.tc_gemm(x_all[off:off + m], w)
            assert torch.equal(part, full[off:off + m]), \
                f"tc_gemm {cfg.name} {name}: rows {off}..{off + m} at " \
                f"M={m} != at M={m_all}"
        for r in (0, 1, 63, 64, 1000, m_all - 1):
            assert torch.equal(tk.tc_gemm(x_all[r:r + 1], w)[0], full[r]), \
                f"tc_gemm {cfg.name} {name}: row {r} alone != at M={m_all}"
        del full
        xs = x_all[:256].clone()
        call = CapturedCall(lambda: tk.tc_gemm(xs, w), dev)
        assert call.launches == {"tc_gemm": 1}, call.launches
        xs.copy_(x_all[256:512])
        assert torch.equal(call(), tk.tc_gemm(xs, w)), \
            f"tc_gemm {cfg.name} {name}: graph replay != eager"
        del call
        r = tg.route(k, n)
        line = []
        for m in TC_GEMM_TIMED_M:
            x = x_all[:m]
            n_bytes = 4.0 * (m * k + k * n + m * n)
            n_ops = 2.0 * m * n * k
            b_ms, by = bound_ms(n_bytes, TC_GEMM_PASSES * n_ops, TF32_FLOPS)
            simt_ms, _ = bound_ms(n_bytes, n_ops)
            t = dict(ms=time_ms(lambda: tk.tc_gemm(x, w), flush),
                     plain_ms=time_ms(lambda: ref.tc_gemm_ref(x, w), flush),
                     library_ms=time_ms(lambda: torch.matmul(x, w), flush))
            line.append(f"M={m} ms={t['ms']:.4f} plain={t['plain_ms']:.4f} "
                        f"torch.matmul={t['library_ms']:.4f} "
                        f"bound={b_ms:.4f} ({by}) f32-simt-bound="
                        f"{simt_ms:.4f} ({t['library_ms'] / t['ms']:.2f}x "
                        "torch.matmul's speed)")
            if m == B * S:
                for f_ in ("ms", "plain_ms", "library_ms"):
                    total[f_] += per * t[f_]
                total["n_bytes"] += per * n_bytes
                total["n_ops"] += per * n_ops
            else:
                total["ms_2048"] += per * t["ms"]
                total["library_ms_2048"] += per * t["library_ms"]
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["launches"] += per
        print(f"  tc_gemm {cfg.name} {name:7s} K={k} N={n} ({layout}, "
              f"route {tuple(r)}) x{per} a forward; max|d| {err:.2e} of "
              f"{scale:.2e}; " + "; ".join(line))
    total["bound_ms"], total["bound_by"] = bound_ms(
        total["n_bytes"], TC_GEMM_PASSES * total["n_ops"], TF32_FLOPS)
    total["bound_f32_ms"] = bound_ms(total["n_bytes"], total["n_ops"])[0]
    print(f"tc_gemm vs plain ({cfg.name}): ok, within {TC_GEMM_TOL} x "
          f"max|y| at M={m_all}, rows bitwise across M in {TC_GEMM_M}, "
          f"graph replay bitwise; one {B}x{S} forward's server products "
          f"({total['launches']} launches): ms={total['ms']:.4f} "
          f"plain={total['plain_ms']:.4f} "
          f"torch.matmul={total['library_ms']:.4f} "
          f"bound={total['bound_ms']:.4f} ({total['bound_by']}, "
          f"{TC_GEMM_PASSES} TF32 passes) f32-simt-bound="
          f"{total['bound_f32_ms']:.4f}; at 4x512: ms="
          f"{total['ms_2048']:.4f} torch.matmul="
          f"{total['library_ms_2048']:.4f}; {card_line()}")
    return total


def flash_case(dev, b, s, seed, dh=64, dtype=None, h=14, kv=2):
    """q, k, v at qwen2-0.5b's heads in the model's [B, S, H, dh] layout,
    seen as [B, H, S, dh] (strided views, as the path passes them)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, s, n, dh), generator=gen, device=dev)
               for n in (h, kv, kv))
    if dtype is not None:
        q, k, v = (x.to(dtype) for x in (q, k, v))
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def flash_bound(q, k, causal=True, passes=FLASH_PASSES, q_offset=0):
    """(ms, "bytes"|"operations") of one flash call: q, k, v and the
    output once each against 4 * dh flops per visible (query, key) pair,
    issued as ``passes`` TF32 tensor-core products each (3 for f32
    inputs; ``passes=None``: f32 outside the tensor cores).  Query row r
    sits at position ``q_offset + r``."""
    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    pairs = sum(min(q_offset + i + 1, t) for i in range(s)) if causal \
        else s * t
    n_bytes = q.element_size() * (2 * b * h * s * dh + 2 * b * kv * t * dh)
    n_ops = 4.0 * dh * pairs * b * h
    if passes is None:
        return bound_ms(n_bytes, n_ops)
    return bound_ms(n_bytes, passes * n_ops, TF32_FLOPS)


def check_flash_kernel(dev, flush):
    """Phase 8; returns the kernel's summary numbers at the serve shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref

    fwd = tk.flash_attention_fwd
    cases = [dict(b=b, s=s) for b in (1, 4) for s in (64, 100, 512, 1024)]
    cases += [dict(b=8, s=128),                      # the training shape
              dict(b=4, s=1024, window=128),
              dict(b=4, s=512, causal=False, kv_len=[512, 300, 77, 1]),
              dict(b=4, s=512, dtype=torch.bfloat16),
              dict(b=2, s=384, dh=128)]
    # stablelm-3b's heads: H = KV = 32 (no GQA sharing), dh = 80 on the
    # DH = 128 tile with zero-padded columns
    cases += [dict(b=4, s=64, **SL_HEADS), dict(b=1, s=100, **SL_HEADS),
              dict(b=2, s=512, **SL_HEADS)]
    err = 0.0
    for c in cases:
        b, s = c["b"], c["s"]
        causal, window = c.get("causal", True), c.get("window", 0)
        lens = c.get("kv_len")
        lens = None if lens is None else torch.tensor(lens, device=dev)
        q, k, v = flash_case(dev, b, s, seed=b * s, dh=c.get("dh", 64),
                             dtype=c.get("dtype"), h=c.get("h", 14),
                             kv=c.get("kv", 2))
        out = fwd(q, k, v, causal=causal, window=window, kv_len=lens)
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, kv_len=lens)
        torch.cuda.synchronize()
        d = (out.float() - want.float()).abs()
        what = f"flash attention {c}"
        if out.dtype == torch.bfloat16:
            # both round f32 results that agree to ~1e-6: one bf16 ulp
            assert bool((d <= want.float().abs() * 2.0 ** -7
                         + FLASH_TOL).all()), what
        else:
            torch.testing.assert_close(out, want, rtol=FLASH_TOL,
                                       atol=FLASH_TOL, msg=what)
            err = max(err, float(d.max()))
        if b > 1:
            for i in range(b):
                alone = fwd(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                            causal=causal, window=window,
                            kv_len=None if lens is None else lens[i:i + 1])
                assert torch.equal(alone[0], out[i]), f"{what}: row {i}"
    # right-padding inside the bucket: bitwise on the real positions
    for s, padded, causal, heads in ((100, 128, True, {}),
                                     (600, 1024, True, {}),
                                     (300, 512, False, {}),
                                     (40, 64, True, SL_HEADS)):
        q, k, v = flash_case(dev, 2, padded, seed=s, **heads)
        short = fwd(q[:, :, :s], k[:, :, :s], v[:, :, :s], causal=causal)
        long = fwd(q, k, v, causal=causal, kv_len=None if causal else s)
        assert torch.equal(long[:, :, :s], short), \
            f"flash attention: padding {s} -> {padded} changed bits"
    # a sequence chunk's queries at an offset (sequence-parallel
    # attention, phase 24 (b)): the plain version at the offset, and
    # bitwise the whole sequence's call on the rows the chunk covers
    n_off = 0
    for b, t, off, dtype, window in FLASH_OFFSETS:
        dtype = torch.bfloat16 if dtype == "bf16" else None
        q, k, v = flash_case(dev, b, t, seed=t + off, dtype=dtype)
        qc = q[:, :, off:off + t // 2]
        out = fwd(qc, k, v, causal=True, window=window, q_offset=off)
        want = ref.flash_attention_ref(qc, k, v, causal=True, window=window,
                                       q_offset=off)
        whole = fwd(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        what = f"flash attention at offset {off} of {b}x{t} {dtype} w{window}"
        d = (out.float() - want.float()).abs()
        if out.dtype == torch.bfloat16:
            assert bool((d <= want.float().abs() * 2.0 ** -7
                         + FLASH_TOL).all()), what
        else:
            torch.testing.assert_close(out, want, rtol=FLASH_TOL,
                                       atol=FLASH_TOL, msg=what)
            err = max(err, float(d.max()))
        assert torch.equal(out, whole[:, :, off:off + t // 2]), \
            f"{what}: rows != the whole call's"
        n_off += 1
    print(f"flash attention vs plain: ok over {len(cases)} cases and "
          f"{n_off} at a query offset, max|d|={err:.3e} (f32); rows alone, "
          f"bucket padding and an offset chunk's rows bitwise")

    rows = {}
    for b, s, heads in ((4, 64, {}), (8, 128, {}), (1, 1024, {}),
                        (4, 64, SL_HEADS)):
        q, k, v = flash_case(dev, b, s, seed=s, **heads)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        lib_d = float((library() - fwd(q, k, v)).abs().max())
        b_ms, by = flash_bound(q, k)
        simt_ms, simt_by = flash_bound(q, k, passes=None)
        rows[(b, s, bool(heads))] = r = dict(
            ms=time_ms(lambda: fwd(q, k, v), flush),
            plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v),
                             flush),
            library_ms=time_ms(library, flush), bound_ms=b_ms, bound_by=by,
            max_abs_err=err)
        hd = heads or dict(h=14, kv=2, dh=64)
        print(f"  flash_attention_fwd B={b} S=T={s} H={hd['h']} "
              f"KV={hd['kv']} dh={hd['dh']} f32 "
              f"ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"sdpa={r['library_ms']:.4f} (max|d| vs kernel {lib_d:.2e}) "
              f"bound={b_ms:.6f} ({by}, {FLASH_PASSES} tf32 passes) "
              f"f32-simt-bound={simt_ms:.6f} ({simt_by})")
    return rows[(B, S, False)], rows[(B, S, True)]


def decode_path(cfg, params, dev, kernel_ms: float):
    """Phase 7; returns {kernel: launches} over the engine runs (eager
    launches plus each graph's record times its replays), the graph token
    step's wall ms, and the pinned 8/8 engine run's (wall s, tokens)."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.kernels import ref
    from repro_torch.kernels.bucketing import seq_bucket
    from repro_torch.launch.serve import decode_classes, decode_system_params
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import (CompiledForwardCache, DecodeEngine,
                                     QosClass, greedy_decode_reference)
    from repro_torch.runtime import decode_engine as de

    class RefLM(DecoderLM):
        """The model with ``plain`` its attentions (prefill's and the
        decode step's) through the kernels' plain versions, and with
        ``record`` each eager step's top-2 logit margins noted."""

        def __init__(self, cfg, plain=False, record=False):
            super().__init__(cfg)
            self.plain, self.record = plain, record
            self.margins = []

        def _note(self, logits):
            if self.record:
                top2 = logits.topk(2, dim=-1).values
                self.margins.append(top2[:, 0] - top2[:, 1])

        def prefill(self, *a, **kw):
            logits, cache = super().prefill(*a, **kw)
            self._note(logits)
            return logits, cache

        def decode_step_q(self, *a, **kw):
            logits, cache = super().decode_step_q(*a, **kw)
            self._note(logits)
            return logits, cache

        def attend(self, q, k, v):
            if self.plain:
                return plain_attend(self.cfg)(q, k, v)
            return super().attend(q, k, v)

        def decode_attend(self, q, kc, vc, ks, vs, lens):
            if self.plain:
                return ref.quantized_decode_attention_ref(
                    q, kc, vc, ks, vs, lens, window=self.cfg.sliding_window)
            return super().decode_attend(q, kc, vc, ks, vs, lens)

    def eager_margins(w, prompt, b_kv):
        """The batch-1 greedy stream through the module's closures run
        eagerly (the kernels, no graph), with each step's top-2 margin."""
        lm = RefLM(cfg, record=True)
        buf = de._SlotBuffers(cfg, seq_bucket(prompt.size + DECODE_NEW), 1,
                              b_kv, dev)
        s_b = seq_bucket(prompt.size)
        padded = np.zeros((1, s_b), np.int32)
        padded[0, :prompt.size] = prompt
        io = buf.prefill_io(s_b)
        toks = [de._run_prefill(
            lambda: de._prefill_slot(lm, b_kv, w, buf, io), io, padded,
            prompt.size, 0)]
        blk, n = de._decode_chunk(
            lambda: de._decode_step(lm, b_kv, w, buf, buf.step_io),
            buf.step_io, np.ones(1, np.int32), DECODE_NEW - 1)
        toks += blk[0, :n].cpu().tolist()
        return (np.asarray(toks, np.int32),
                torch.cat(lm.margins).cpu().numpy())

    def held(got, want, margins, d, what):
        """Tokens equal, or equal up to the first step whose reference
        margin (``margins()``, computed only then) is below 2 d; returns
        that step or None."""
        if np.array_equal(got, want):
            return None
        m = margins()
        close = np.flatnonzero(m < 2.0 * d)
        upto = int(close[0]) if close.size else len(want)
        assert close.size and np.array_equal(got[:upto], want[:upto]), \
            f"{what}: tokens differ before step {upto}: {got} vs {want}"
        return upto

    model = DecoderLM(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in DECODE_PROMPTS]
    per_layer = cfg.active_param_count() / cfg.n_layers
    sysp = decode_system_params(cfg, SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * B * S,
        n_flop_server=2.0 * per_layer * (cfg.n_layers - cfg.split_layer)
        * B * S), 4, S, DECODE_NEW)
    pin = QosClass("interactive", *DECODE_BUDGET)

    # one step from the same state, batched against alone and plain
    # against kernel: the logit differences the token rule allows for
    w8 = DecodeEngine(model, params, sysp, classes=[pin], auto=False,
                      device=dev).class_params(pin.name)
    ref_cache = CompiledForwardCache()
    states = [greedy_decode_reference(
        model, w8, p, 2, b_kv=8, reserve_tokens=1024 - p.size,
        return_state=True, compile_cache=ref_cache, device=dev)[1]
        for p in prompts[:4]]

    def step(lm, rows):
        qc = {k: torch.from_numpy(np.concatenate(
            [states[i][k] for i in rows], axis=1)).to(dev)
            for k in ("k_codes", "v_codes", "k_scales", "v_scales")}
        pos = torch.tensor([int(states[i]["pos"]) for i in rows],
                           dtype=torch.int32, device=dev)
        tok = torch.tensor([[int(states[i]["last_token"])] for i in rows],
                           dtype=torch.int32, device=dev)
        return lm.decode_step_q(w8, {**qc, "len": pos},
                                {"token": tok, "pos": pos}, b_kv=8)[0]

    with torch.no_grad():
        full = step(model, range(4))
        alone = torch.cat([step(model, [i]) for i in range(4)])
        plain = step(RefLM(cfg, plain=True), range(4))
        torch.cuda.synchronize()
        d_batch = float((full - alone).abs().max())
        d_plain = float((full - plain).abs().max())
    print(f"decode step from one state (B=4, T=1024, b_kv=8): batched vs "
          f"alone max|d logits|={d_batch:.3e}, plain vs kernel "
          f"{d_plain:.3e}")

    # the captured step and prefill against the module's closures run
    # eagerly on a copy of the same slot block: tokens and buffers bitwise
    def slot_block():
        buf = de._SlotBuffers(cfg, 1024, 4, 8, dev)
        for k in ("k_codes", "v_codes", "k_scales", "v_scales"):
            getattr(buf, k).copy_(torch.from_numpy(np.concatenate(
                [st[k] for st in states], axis=1)))
        buf.pos.copy_(torch.tensor([int(st["pos"]) for st in states]))
        buf.tok.copy_(torch.tensor([int(st["last_token"]) for st in states]))
        return buf

    live = np.ones(4, np.int32)
    cache = CompiledForwardCache()
    graph_buf, eager_buf = slot_block(), slot_block()
    t0 = time.perf_counter()
    graph_step = de._step_call(cache, model, 8, w8, graph_buf)
    graph_prefill = de._prefill_call(cache, model, 8, w8, graph_buf, 512)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0

    def eager_step():
        de._decode_step(model, 8, w8, eager_buf, eager_buf.step_io)

    eio = eager_buf.prefill_io(512)

    def eager_prefill():
        de._prefill_slot(model, 8, w8, eager_buf, eio)

    padded = np.zeros((1, 512), np.int32)
    padded[0, :prompts[5].size] = prompts[5]
    first = [de._run_prefill(f, b.prefill_io(512), padded, prompts[5].size,
                             1)
             for f, b in ((graph_prefill, graph_buf),
                          (eager_prefill, eager_buf))]
    blocks = [de._decode_chunk(f, b.step_io, live, 8)[0].clone()
              for f, b in ((graph_step, graph_buf),
                           (eager_step, eager_buf))]
    torch.cuda.synchronize()
    assert first[0] == first[1], "captured prefill != eager"
    assert torch.equal(blocks[0], blocks[1]), "captured step != eager"
    for a, b in zip(graph_buf.written(), eager_buf.written()):
        assert torch.equal(a, b), "captured decode buffers != eager"
    assert graph_step.launches["row_gemm"] == row_gemm_per_step(cfg)
    print(f"captured == eager (B=4, T=1024, b_kv=8): the first token of a "
          f"{prompts[5].size}-token prefill into slot 1 and 8 token steps, "
          f"tokens and every buffer bitwise; step and prefill captured in "
          f"{t_capture:.2f}s; one step graph launches "
          f"{graph_step.launches}")

    # wall per token step inside a chunk of 16 (what the engine pays: 16
    # replays, then the token block read back), and eagerly
    def chunk(fn, buf, k=16):
        de._decode_chunk(fn, buf.step_io, live, k)[0].cpu()

    # (the eager step's device time is the graph's: the same kernels;
    # tools/torch_forward_profile.py --decode --eager traces it)
    walls = {}
    for name, fn, buf, reps in (("graph", graph_step, graph_buf, 7),
                                ("eager", eager_step, eager_buf, 2)):
        with torch.no_grad():
            chunk(fn, buf)
            ms = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                chunk(fn, buf)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3 / 16)
            busy = ""
            if name == "graph":
                wall, dev_ms, launched = device_busy(
                    lambda: chunk(fn, buf), n=2)
                busy = "; device time not measured" if dev_ms is None \
                    else (f"; {dev_ms / 16:.3f} device ms per step, "
                          f"{dev_ms / wall:.1%} busy traced, "
                          f"{dev_ms / 16 / statistics.median(ms):.1%} of "
                          f"the untraced wall, {launched / 16:.0f} launches "
                          "per step")
        walls[name] = statistics.median(ms)
        if name == "graph":
            busy += (f"; the ungrouped design's graph step "
                     f"{UNGROUPED_STEP['wall_ms']} ms, "
                     f"{UNGROUPED_STEP['tokens_s']} tokens/s, "
                     f"{UNGROUPED_STEP['device_ms']} device ms, "
                     f"{7 * cfg.n_layers + 1} row_gemm launches (now "
                     f"{row_gemm_per_step(cfg)})")
        print(f"decode token step {name} (B=4, T=1024, b_kv=8): "
              f"{walls[name]:.3f} ms wall per step in a 16-step chunk "
              f"(median of {reps}), {4e3 / walls[name]:.1f} tokens/s{busy}; "
              f"{card_line()}")
    prefill = {}
    for name, fn, buf in (("graph", graph_prefill, graph_buf),
                          ("eager", eager_prefill, eager_buf)):
        ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            de._run_prefill(fn, buf.prefill_io(512), padded,
                            prompts[5].size, 1)
            ms.append((time.perf_counter() - t0) * 1e3)
        prefill[name] = statistics.median(ms[1:])
    print(f"decode prefill of {prompts[5].size} tokens: graph "
          f"{prefill['graph']:.2f} ms, eager {prefill['eager']:.2f} ms per "
          f"request (median of 3)")

    class TimedLM(DecoderLM):
        """CUDA events around each decode-attention call of a step; a
        device-side sleep before each keeps the card busy while the host
        enqueues the call, so the events bracket its device work."""

        def __init__(self, cfg):
            super().__init__(cfg)
            self.events = []

        def decode_attend(self, *a):
            torch.cuda._sleep(SLEEP_CYCLES)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = super().decode_attend(*a)
            ev[1].record()
            self.events.append(ev)
            return out

    timed = TimedLM(cfg)
    with torch.no_grad():
        per_step = []
        for _ in range(3):
            timed.events.clear()
            step(timed, range(4))
            torch.cuda.synchronize()
            assert len(timed.events) == cfg.n_layers
            per_step.append(sum(a.elapsed_time(b) for a, b in timed.events))
    print(f"decode attention device {statistics.median(per_step):.4f} ms "
          f"per step ({cfg.n_layers} launches, CUDA events in the step, "
          f"median of 3; {cfg.n_layers} x the L2-flushed launch "
          f"{cfg.n_layers * kernel_ms:.4f})")

    # (name, classes, operating point, warm-up first): the warmed runs
    # capture every variant up front and may not capture while serving;
    # the others capture lazily, mid-traffic, with live rows in the block
    runs = [("pinned 8/8", [pin], (8, 8), True),
            ("pinned 4/4", [pin], (4, 4), False),
            ("pinned 8/16", [pin], (8, 16), False),
            ("auto", decode_classes(*DECODE_BUDGET), None, False),
            ("plain 8/8", [pin], (8, 8), False)]
    launches = dict.fromkeys(("quantized_decode_attention",
                              "flash_attention_fwd", "row_gemm"), 0)
    kernel_tokens = {}
    for name, classes, point, warm in runs:
        plain_run = name.startswith("plain")
        lm = RefLM(cfg, plain=True) if plain_run else model
        eng = DecodeEngine(lm, params, sysp, classes=classes,
                           auto=point is None, max_batch=4,
                           max_new_tokens=DECODE_NEW, device=dev)
        if point is not None:
            eng.set_operating_point(pin.name, *point)
        t0 = time.perf_counter()
        n_warm = eng.warmup(max(DECODE_PROMPTS), DECODE_NEW) if warm else 0
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        t_round = eng.decode_round_cost(classes[0].name, 512)[0]
        rids = {}
        for i, p in enumerate(prompts):
            qos = classes[i % len(classes)].name
            rids[eng.submit(p, qos, arrival_s=DECODE_ARRIVE[i] * t_round)] \
                = i
        cc = eng.compile_cache
        before = {k for k, _ in cc.items()}
        tk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        responses = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eager = tk.launch_counts()
        replayed = cc.kernel_launches()
        rep = eng.report()
        if warm:
            assert rep.compile_misses == n_warm, \
                f"{name}: {rep.compile_misses - n_warm} captures after warmup"
        # outside the graphs only the eager warm-up runs of the graphs
        # captured while serving launched (each once its record)
        new = [e for k, e in cc.items() if k not in before]
        assert eager == {k: sum(e.launches.get(k, 0) for e in new)
                         for k in eager}, f"{name}: eager launches {eager}"
        # every prefill replays one full-sequence pass (one flash launch a
        # layer), every token step 24 decode attentions and 169 products;
        # the plain run's attentions launch nothing
        want = {"quantized_decode_attention":
                0 if plain_run else cfg.n_layers * rep.decode_rounds,
                "flash_attention_fwd":
                0 if plain_run else cfg.n_layers * rep.prefills,
                "row_gemm": row_gemm_per_step(cfg) * rep.decode_rounds}
        assert {k: replayed.get(k, 0) for k in eager} == \
            {k: want.get(k, 0) for k in eager}, \
            f"{name}: replayed launches {replayed} != {want}, " \
            f"{rep.decode_rounds} token steps, {rep.prefills} prefills"
        counts = {k: eager[k] + replayed.get(k, 0) for k in eager}
        assert rep.requests_served == len(prompts)
        assert rep.tokens_generated == len(prompts) * DECODE_NEW
        points = ", ".join(f"{c.qos} b_hat={c.b_hat} b_kv={c.b_kv}"
                           for c in rep.classes)
        print(f"  decode {name:11s} {points}: "
              + (f"warmup {n_warm} graphs in {t_warm:.2f}s, 0 captures "
                 "after; " if warm else
                 f"{rep.compile_misses} graphs captured while serving; ")
              + f"{rep.prefills} prefills, {rep.decode_rounds} token steps, "
              f"{rep.tokens_generated} tokens in {wall:.2f}s wall; launches "
              f"{counts['quantized_decode_attention']} decode, "
              f"{counts['flash_attention_fwd']} flash, "
              f"{counts['row_gemm']} row_gemm")
        for k in launches:
            if not (plain_run and k != "row_gemm"):
                launches[k] += counts[k]
        if name == "pinned 8/8":
            engine_wall = (wall, rep.tokens_generated)
        for r in responses:
            i = rids[r.request_id]
            assert r.tokens.shape == (DECODE_NEW,)
            assert ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()
            w = eng.class_params(r.qos)
            if plain_run:
                want_toks = kernel_tokens[i]
                at = held(r.tokens, want_toks,
                          lambda: eager_margins(w, prompts[i], r.b_kv)[1],
                          d_plain, f"plain run request {i}")
            else:
                want_toks = greedy_decode_reference(
                    model, w, prompts[i], DECODE_NEW, b_kv=r.b_kv,
                    compile_cache=ref_cache, device=dev)
                at = held(r.tokens, want_toks,
                          lambda: eager_margins(w, prompts[i], r.b_kv)[1],
                          d_batch, f"{name} request {i}")
                if name == "pinned 8/8":
                    kernel_tokens[i] = r.tokens
            if at is not None:
                print(f"    request {i}: reference margin below the "
                      f"measured noise at step {at}; compared up to it")
        print(f"    tokens held to the "
              f"{'kernel run' if plain_run else 'batch-1 reference'}: ok")
    return launches, walls["graph"], engine_wall


def device_busy(fn, n: int = 3):
    """(wall ms, device ms, launches) per call of ``fn`` over ``n`` calls
    under ``torch.profiler``: device time is the kernels' own (None when
    the trace shows none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    dev_us, launches = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            dev_us += us
            launches += e.count
    return wall, (dev_us / 1e3 / n if dev_us else None), launches // n


def batched_graphs(cfg, model, params, sysp, dev, classes, mixed, check):
    """``BatchedCoInferenceEngine(path="kernel", compiled=True, max_batch=4,
    mixed_precision=mixed)`` over ``classes``: ``check(eng)`` on the
    solved classes, ``warmup(512)``, then COMPILED_REQUESTS requests of
    16-512 tokens.  Counters are zeroed before the engine is built and read
    after serving (a graph's kernels count once per replay).  After
    warm-up no request may miss the cache; every response must equal the
    eager engine's at the same bucket bitwise, and the request served
    alone, unpadded and eager, bitwise (``tc_gemm``'s rows do not depend
    on M).  Returns (engine, eager engine, launch counts)."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels.bucketing import seq_ladder
    from repro_torch.runtime import BatchedCoInferenceEngine, CoInferenceEngine

    rng = np.random.default_rng(6)
    lens = rng.integers(COMPILED_SEQ[0], COMPILED_SEQ[1] + 1,
                        size=COMPILED_REQUESTS)
    reqs = [(rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32),
             classes[i % 2].name) for i, n in enumerate(lens)]

    tk.reset_launch_counts()
    t0 = time.perf_counter()
    eng = BatchedCoInferenceEngine(model, params, sysp, classes=classes,
                                   max_batch=4, path="kernel", compiled=True,
                                   mixed_precision=mixed, device=dev)
    check(eng)
    n_graphs = eng.warmup(COMPILED_SEQ[1])
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    cc = eng.engine.compile_cache
    assert n_graphs == len(cc) == 2 * len(seq_ladder(COMPILED_SEQ[1]))
    misses = cc.misses
    sent = {eng.submit(t, q): (t, q) for t, q in reqs}
    t0 = time.perf_counter()
    batches = []
    while eng.pending():
        batches.append(eng.step())
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    counts = tk.launch_counts()
    for k, n in cc.kernel_launches().items():
        if k in counts:
            counts[k] += n
    assert cc.misses == misses, "a capture while serving after warmup"
    rep = eng.report()
    print(f"compiled batched serving{' (mixed precision)' if mixed else ''}:"
          f" {n_graphs} CUDA graphs captured in {t_warm:.1f}s "
          f"(warmup({COMPILED_SEQ[1]}), 2 classes x "
          f"{len(seq_ladder(COMPILED_SEQ[1]))} buckets), "
          f"{rep.requests_served} requests of "
          f"{int(lens.min())}-{int(lens.max())} tokens in "
          f"{rep.batches_served} batches in {t_serve:.2f}s, "
          f"{cc.replays()} replays, 0 misses after warmup "
          f"(compile cache {rep.compile_hits} hits / {rep.compile_misses} "
          f"misses); launches {counts}")
    for b in eng.batch_history:
        print(f"  [{b.qos}] n={b.batch_size} ({b.agent_path}) "
              f"padded={b.padded_tokens} occupancy={b.occupancy:.2f}")
    for name in ("group_quantize", "qmm", "qmm_int4",
                 "flash_attention_fwd", "tc_gemm"):
        assert counts[name] > 0, f"{name} never launched while serving"

    eager = CoInferenceEngine(model, params, sysp, path="kernel",
                              cache_weights=True, device=dev)
    exact = 0
    for rs in batches:
        qos = sent[rs[0].request_id][1]
        sol, plan = eng.solution_for(qos), eng.plan_for(qos)
        eager.configure(sol.b_hat if plan is None else plan, sol.f,
                        sol.f_server)
        toks = [sent[r.request_id][0] for r in rs]
        bp, sp = eng.engine.bucket_shape(len(rs), max(t.size for t in toks))
        padded = np.zeros((bp, sp), np.int32)
        real = [0] * bp
        for i, t in enumerate(toks):
            padded[i, :t.size], real[i] = t, t.size
        want, _ = eager.serve_batch({"tokens": padded}, lengths=real)
        for i, r in enumerate(rs):
            assert r.logits.shape == (real[i], cfg.vocab_size)
            assert torch.isfinite(r.logits).all()
            assert torch.equal(r.logits, want[i, :real[i]]), \
                f"request {r.request_id}: graph != eager at the bucket"
            alone, _ = eager.serve_batch({"tokens": toks[i][None]})
            assert torch.equal(r.logits, alone[0]), \
                f"request {r.request_id}: batched != alone, max|d| " \
                f"{float((r.logits - alone[0]).abs().max())}"
            exact += 1
    print(f"  graph replay == eager at the bucket: bitwise for all "
          f"{len(sent)} requests; batched == alone (unpadded, eager): "
          f"bitwise for {exact}/{len(sent)}")
    return eng, eager, counts


def forward_walls(graph_eng, eager, target, tokens, names):
    """The B x S forward's wall at ``target`` for each of ``names`` (of
    "eager" and "graph"), median of 7, and its device time and busy share
    over 3 traced calls.  Returns {name: (wall ms, device ms or None)}."""
    import torch
    eager.configure(target)
    graph_eng.engine.configure(target)
    rows = {}
    for name in names:
        e = eager if name == "eager" else graph_eng.engine

        def serve(e=e):
            e.serve_batch({"tokens": tokens})
        serve()
        walls = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall, dev_ms, launched = device_busy(serve)
        rows[name] = (statistics.median(walls), dev_ms)
        busy = "not measured" if dev_ms is None else \
            f"{dev_ms:.2f} device ms, {dev_ms / wall:.1%} busy"
        print(f"  serve_batch({B}x{S}) {e.agent_path} {name}: wall "
              f"{rows[name][0]:.2f} ms (median of 7); traced 3: wall "
              f"{wall:.2f} ms, {busy}, {launched} launches per forward")
    return rows


def compiled_serving(cfg, model, params, sysp, dev, tokens):
    """Phase 10; returns the kernel launches of its serving window (eager
    warm-up runs and graph replays) and the int8 forward's graph wall and
    device ms.  ``tokens``: phase 4's B x S batch, whose forward is timed
    with and without the graph."""
    from repro_torch.runtime import QosClass

    classes = [QosClass(n, t0, e0) for n, t0, e0 in COMPILED_CLASSES]

    def check(eng):
        assert [eng.solution_for(c.name).b_hat for c in classes] == [4, 8]

    eng, eager, counts = batched_graphs(cfg, model, params, sysp, dev,
                                        classes, False, check)
    # the 4 x 64 forward with and without the graph (after the counts
    # were read: these launches count nowhere)
    int8 = eng.solution_for(classes[1].name)
    rows = forward_walls(eng, eager, int8.b_hat, tokens, ("eager", "graph"))
    print(f"  graph / eager wall: {rows['graph'][0] / rows['eager'][0]:.3f}")
    return counts, rows["graph"]


def fcdnn_check(dev):
    """Phase 11, part 1: FC-DNN-16 at its published dims on the card.
    Prop. 3.1 (the chain bound over the largest row's measured output
    distortion, inputs on the unit L1 ball) at every bit-width of both
    codebooks; the bound non-increasing in the bits (strictly falling on
    the uniform codebook); bound, measured and parameter distortion within
    FCDNN_TOL of the same computation on the CPU."""
    import torch
    from repro_torch.core import distortion as td
    from repro_torch.core.quantization import QuantConfig, quantize_dequantize
    from repro_torch.models import fcdnn as fc

    gen = torch.Generator(device=dev).manual_seed(11)
    ws = fc.init_fcdnn(gen)
    x = torch.randn((16, fc.layer_dims()[0]), generator=gen, device=dev)
    x = x / torch.sum(torch.abs(x), dim=-1, keepdim=True)
    sides = {"cuda": (ws, x), "cpu": ([w.cpu() for w in ws], x.cpu())}
    worst = 0.0
    for scheme in ("uniform", "pot-log"):
        prev = float("inf")
        for bits in FCDNN_BITS:
            cfg = QuantConfig(bits=bits, scheme=scheme,
                              granularity="per-tensor")
            got = {}
            for side, (w, xs) in sides.items():
                wh = [quantize_dequantize(m, cfg) for m in w]
                out, out_hat = fc.apply_fcdnn(w, xs), fc.apply_fcdnn(wh, xs)
                got[side] = (
                    float(td.fc_chain_bound(w, wh)),
                    float(torch.max(torch.sum(torch.abs(out - out_hat),
                                              dim=-1))),
                    float(td.measured_output_distortion(fc.apply_fcdnn, w,
                                                        wh, xs)),
                    float(td.param_distortion(w, wh)))
            bound, measured = got["cuda"][:2]
            assert measured <= bound * (1 + 1e-5), \
                f"FC-DNN-16 {scheme} {bits} bits: {measured} > {bound}"
            assert bound <= prev * (1 + 1e-6), \
                f"FC-DNN-16 {scheme}: the bound grew at {bits} bits"
            if scheme == "uniform":
                assert bound < prev, f"FC-DNN-16 uniform {bits} bits"
            prev = bound
            for a, b in zip(got["cuda"], got["cpu"]):
                rel = abs(a - b) / abs(b)
                worst = max(worst, rel)
                assert rel <= FCDNN_TOL, \
                    f"FC-DNN-16 {scheme} {bits} bits: card {a} vs cpu {b}"
            print(f"  FC-DNN-16 {scheme:7s} {bits} bits: chain bound "
                  f"{bound:.4e} >= measured {measured:.4e} (mean "
                  f"{got['cuda'][2]:.4e}); ||W - W_hat||_1 "
                  f"{got['cuda'][3]:.4e}")
    print(f"FC-DNN-16 ({len(ws)} matrices, dims {fc.layer_dims()}): Prop. "
          f"3.1 holds at bits {FCDNN_BITS} on both codebooks, the bound "
          f"never rises with the bits (falls on the uniform codebook); card "
          f"vs CPU max rel {worst:.2e} (limit "
          f"{FCDNN_TOL})")


def rate_distortion_check(cfg, params, dev):
    """Phase 11, part 2: lambda-hat from the agent weights, Blahut-Arimoto
    at its defaults on the card, every swept point in BA_WINDOW between
    D^L and D^U within BA_SLACK; prints its wall time."""
    import numpy as np
    import torch
    from repro_torch.core import rate_distortion as rd
    from repro_torch.runtime.serve_engine import fit_lambda

    lam = fit_lambda(params, cfg.split_layer)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rd.blahut_arimoto_distortion_rate(lam, device=dev)
    t_ba = time.perf_counter() - t0
    finite = np.isfinite(res.rates)
    mask = finite & (res.rates > BA_WINDOW[0]) & (res.rates < BA_WINDOW[1])
    assert mask.sum() >= 5, f"Blahut-Arimoto: {mask.sum()} points in window"
    assert np.isfinite(res.distortions).all()
    for r, d in zip(res.rates[mask], res.distortions[mask]):
        dl = float(rd.distortion_lower_bound(r, lam))
        du = float(rd.distortion_upper_bound(r, lam))
        assert dl * BA_SLACK[0] <= d <= du * BA_SLACK[1], (r, d, dl, du)
    print(f"rate-distortion: lambda_hat={lam:.4f} (agent weights); "
          f"Blahut-Arimoto ({res.betas.size} multipliers x 300 iterations "
          f"on 256 x 256) in {t_ba:.3f}s wall; {int(mask.sum())} points at "
          f"rates in {BA_WINDOW} all within [D^L x {BA_SLACK[0]}, D^U x "
          f"{BA_SLACK[1]}]; {int((~finite).sum())} NaN rates (the output "
          f"marginal underflows at small multipliers, as in the reference)")


def mixed_serving(cfg, model, params, sysp, dev, tokens, int8_graph):
    """Phase 11, part 3: layer statistics on the card vs the CPU, then the
    two MIXED_CLASSES served eagerly (one counted window: one
    group_quantize launch per configure, qmm/qmm_int4 per
    ``launches_per_forward``, flash 24 per forward) and held against the
    plain versions, then from CUDA graphs through the batched engine in
    mixed mode (a second counted window), and the 4 x 64 forward's graph
    wall beside the int8 graph's.  Returns the windows' launch counts."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core import mixed_precision as mp
    from repro_torch.runtime import (CodesignCache, CoInferenceEngine,
                                     QosClass)

    split = cfg.split_layer
    eng = CoInferenceEngine(model, params, sysp, path="kernel",
                            cache_weights=True, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = eng.layer_stats()
    t_stats = time.perf_counter() - t0
    agent = {"layers": {part: {k: v[:split].cpu() for k, v in sub.items()}
                        for part, sub in params["layers"].items()}}
    t0 = time.perf_counter()
    stats_cpu = mp.decoder_layer_stats(agent, split)
    t_cpu = time.perf_counter() - t0
    d_lam = max(abs(a - b) / b for a, b in zip(stats.lam, stats_cpu.lam))
    d_sens = max(abs(a - b) / b for a, b in zip(stats.sens, stats_cpu.sens))
    assert d_lam <= STATS_TOL and d_sens <= STATS_TOL, (stats, stats_cpu)
    print(f"decoder_layer_stats ({split} agent layers): {t_stats * 1e3:.1f} "
          f"ms wall on the card ({t_cpu:.2f}s on the CPU); lambda "
          f"{[round(v, 4) for v in stats.lam]}, A "
          f"{[round(v, 6) for v in stats.sens]}; card vs CPU max rel "
          f"lambda {d_lam:.1e}, A {d_sens:.1e} (limit {STATS_TOL})")

    classes = [QosClass(n, t0_, e0_) for n, t0_, e0_ in MIXED_CLASSES]

    def check_bits(name, bits):
        assert min(bits) >= 2, f"{name}: a 1-bit layer {bits}"
        assert any(b <= 4 for b in bits) and any(4 < b <= 8 for b in bits), \
            f"{name}: {bits} lacks an int4 or an int8 layer"

    def check(e):
        for c in classes:
            check_bits(c.name, e.solution_for(c.name).bits)

    cache = CodesignCache()
    want = dict.fromkeys(tk.KERNELS, 0)
    served = []
    tk.reset_launch_counts()
    for c in classes:
        sol = eng.auto_configure_mixed(c, cache=cache)
        assert sol is not None, f"{c.name} infeasible"
        check_bits(c.name, sol.bits)
        want["group_quantize"] += 1
        logits, _ = eng.serve_batch({"tokens": tokens})
        n8, n4 = launches_per_forward(eng.agent_path, cfg)
        want["qmm"] += n8
        want["qmm_int4"] += n4
        want["flash_attention_fwd"] += cfg.n_layers
        want["tc_gemm"] += tc_gemm_per_forward(eng.agent_path, cfg)
        served.append((c, sol, eng.plan, eng.agent_path, logits))
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert counts == want, f"mixed launch counts {counts} != {want}"
    assert tk.group_quantize.route_launches["simt"] == 0
    tok_dev = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    plain_model = plain_lm(cfg)
    for c, sol, plan, path, logits in served:
        eng.configure(plan, sol.f, sol.f_server)
        held, _ = hold_against_plain(eng, plain_model, plan, path, logits,
                                     tokens, tok_dev)
        n8, n4 = launches_per_forward(path, cfg)
        print(f"  mixed class {c.name} (T0={c.t0}s, E0={c.e0}J): bits="
              f"{list(sol.bits)} (mean {sol.mean_bits:.2f}, uniform best "
              f"b_hat={sol.uniform_b}) bound={sol.objective:.3e} (uniform "
              f"{sol.uniform_objective:.3e}); {path}: {n8} qmm + {n4} "
              f"qmm_int4 launches a forward; {held}")
    print(f"mixed serving (eager): launches {counts}")

    graphs, eager, graph_counts = batched_graphs(
        cfg, model, params, sysp, dev, classes, True, check)
    for k in counts:
        counts[k] += graph_counts[k]
    rows = forward_walls(graphs, eager, graphs.plan_for(classes[0].name),
                         tokens, ("graph",))
    wall, dev_ms = rows["graph"]
    i8_wall, i8_dev = int8_graph
    fmt = (lambda v: "not measured" if v is None else f"{v:.2f}")
    print(f"  4x64 forward from its graph: {graphs.engine.agent_path} "
          f"{wall:.2f} ms wall, {fmt(dev_ms)} device ms; kernel-int8 (phase "
          f"10) {i8_wall:.2f} ms wall, {fmt(i8_dev)} device ms; "
          f"{card_line()}")
    return counts


def proxy_forwards(dev):
    """Phase 11, part 5: one forward of each paper proxy's ``FULL`` config
    (LayerNorm, tanh-GELU, full multi-head attention at dh = 32) through
    the kernel path at the plan [4, 8], held against the plain versions
    as in phase 4; git-proxy's d_model = 192 takes per-element groups (the
    SIMT routes of ``group_quantize`` and ``qmm``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.core.quantization import QuantPlan
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import CoInferenceEngine

    for arch in ("blip2-proxy", "git-proxy"):
        cfg = get_config(arch)
        model = DecoderLM(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(12))
        per_layer = cfg.active_param_count() / cfg.n_layers
        sysp = SystemParams(
            n_flop_agent=2.0 * per_layer * cfg.split_layer * B * S,
            n_flop_server=2.0 * per_layer
            * (cfg.n_layers - cfg.split_layer) * B * S)
        eng = CoInferenceEngine(model, params, sysp, path="kernel",
                                device=dev)
        plan = QuantPlan.from_layer_bits([4, 8])
        eng.configure(plan)
        tokens = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (2, 32)).astype(np.int32)
        logits, _ = eng.serve_batch({"tokens": tokens})
        tok_dev = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        held, _ = hold_against_plain(eng, plain_lm(cfg), plan,
                                     eng.agent_path, logits, tokens, tok_dev)
        print(f"  {arch} FULL ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}) "
              f"{eng.agent_path} 2x32: {held}")


def mixed_decode(cfg, model, params, dev):
    """Phase 11, part 4: ``DecodeEngine(mixed_precision=True)`` from CUDA
    graphs over DECODE_MIXED_CLASSES (``warmup`` first, no capture after),
    the six decode prompts, every response equal to
    ``greedy_decode_reference`` with the class's weights bitwise; launches
    counted over the drain.  Then the token step's wall from its graph at
    one class's plan.  Returns the drain's launch counts."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.launch.serve import decode_system_params
    from repro_torch.runtime import (CompiledForwardCache, DecodeEngine,
                                     QosClass, greedy_decode_reference)
    from repro_torch.runtime import decode_engine as de

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in DECODE_PROMPTS]
    per_layer = cfg.active_param_count() / cfg.n_layers
    sysp = decode_system_params(cfg, SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * B * S,
        n_flop_server=2.0 * per_layer * (cfg.n_layers - cfg.split_layer)
        * B * S), 4, S, DECODE_NEW)
    classes = [QosClass(n, t0, e0) for n, t0, e0 in DECODE_MIXED_CLASSES]
    eng = DecodeEngine(model, params, sysp, classes=classes, max_batch=4,
                       max_new_tokens=DECODE_NEW, mixed_precision=True,
                       device=dev)
    for c in classes:
        sol = eng.solution_for(c.name)
        assert min(sol.bits) >= 2, f"{c.name}: a 1-bit layer {sol.bits}"
        print(f"  mixed decode class {c.name} (T0={c.t0}s, E0={c.e0}J): "
              f"bits={list(sol.bits)} b_kv={sol.b_kv} "
              f"bound={sol.objective:.3e}")
    t0 = time.perf_counter()
    n_warm = eng.warmup(max(DECODE_PROMPTS), DECODE_NEW)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    t_round = eng.decode_round_cost(classes[0].name, 512)[0]
    rids = {eng.submit(p, classes[i % 2].name,
                       arrival_s=DECODE_ARRIVE[i] * t_round): i
            for i, p in enumerate(prompts)}
    cc = eng.compile_cache
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    responses = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    replayed = cc.kernel_launches()
    rep = eng.report()
    assert rep.compile_misses == n_warm, "a capture after warmup"
    assert {k: v for k, v in counts.items() if v} == {}, \
        f"launches outside the graphs: {counts}"
    want = {"quantized_decode_attention": cfg.n_layers * rep.decode_rounds,
            "flash_attention_fwd": cfg.n_layers * rep.prefills,
            "row_gemm": row_gemm_per_step(cfg) * rep.decode_rounds}
    for k in counts:
        counts[k] += replayed.get(k, 0)
        assert counts[k] == want.get(k, 0), (k, counts[k], want)
    ref_cache = CompiledForwardCache()
    for r in responses:
        i = rids[r.request_id]
        assert r.tokens.shape == (DECODE_NEW,)
        ref = greedy_decode_reference(
            model, eng.class_params(r.qos), prompts[i], DECODE_NEW,
            b_kv=r.b_kv, compile_cache=ref_cache, device=dev)
        assert np.array_equal(np.asarray(r.tokens), ref), \
            f"mixed decode request {i}: {r.tokens} vs {ref}"
    print(f"mixed decode: warmup {n_warm} graphs in {t_warm:.2f}s, 0 "
          f"captures after; {rep.prefills} prefills, {rep.decode_rounds} "
          f"token steps, {rep.tokens_generated} tokens in {wall:.2f}s wall; "
          f"all {len(responses)} responses == the batch-1 reference "
          f"bitwise; launches {counts}")

    # the token step's wall from its graph (B = 4, T = 1024) at the first
    # class's plan: a slot block filled from four batch-1 prefills
    c = classes[0]
    w, b_kv = eng.class_params(c.name), eng.b_kv_for(c.name)
    states = [greedy_decode_reference(
        model, w, p, 2, b_kv=b_kv, reserve_tokens=1024 - p.size,
        return_state=True, compile_cache=ref_cache, device=dev)[1]
        for p in prompts[:4]]
    buf = de._SlotBuffers(cfg, 1024, 4, b_kv, dev)
    for k in ("k_codes", "v_codes", "k_scales", "v_scales"):
        getattr(buf, k).copy_(torch.from_numpy(np.concatenate(
            [st[k] for st in states], axis=1)))
    buf.pos.copy_(torch.tensor([int(st["pos"]) for st in states]))
    buf.tok.copy_(torch.tensor([int(st["last_token"]) for st in states]))
    step = de._step_call(CompiledForwardCache(), model, b_kv, w, buf)
    live = np.ones(4, np.int32)

    def chunk():
        de._decode_chunk(step, buf.step_io, live, 16)[0].cpu()

    with torch.no_grad():
        chunk()
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunk()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / 16)
        traced, dev_ms, launched = device_busy(chunk, n=2)
    per = statistics.median(ms)
    busy = "device time not measured" if dev_ms is None else \
        f"{dev_ms / 16:.3f} device ms per step, {launched / 16:.0f} " \
        "launches per step"
    print(f"mixed decode token step (graph, B=4, T=1024, bits="
          f"{list(eng.solution_for(c.name).bits)}, b_kv={b_kv}): {per:.3f} "
          f"ms wall per step in a 16-step chunk (median of 5), "
          f"{4e3 / per:.1f} tokens/s; {busy}; {card_line()}")
    return counts


def train_path(cfg, dev):
    """Phase 9; returns the flash launches of the ``fit`` run.

    The kernel-vs-plain step: both start from one state and see one batch,
    so their losses differ only by the attention's rounding (1e-4
    relative).  Adam's first step moves every element by lr * g / (|g| +
    eps) (+ decay), at most lr in size whatever g is, so no bound on
    max |dp| can fail; it is printed, not checked.  An element whose
    int8-coded gradient rounds to another code in the two runs (a gradient
    within the attention's rounding of a rounding edge) moves differently;
    every other element moves the same up to rounding.  So at most
    PARAM_FLIP_SHARE of the elements may differ by more than 1e-3 lr.
    """
    import math

    import torch
    from repro_torch import kernels as tk
    from repro_torch.data import (MarkovLMConfig, MarkovLMDataset,
                                  ShardedLoader)
    from repro_torch.models.lm import DecoderLM, tree_leaves
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import TrainConfig, Trainer

    PARAM_FLIP_SHARE = 1e-3
    tc = TrainConfig(qat_bits=8, grad_compression="int8_ef", log_every=1)
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 20, TRAIN_STEPS))
    data = MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH))
    tr = Trainer(DecoderLM(cfg), opt, dev, tc)
    state0 = tr.init_state(0)
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, hist = tr.fit(ShardedLoader(data, device=dev), TRAIN_STEPS,
                         state=state0)
    torch.cuda.synchronize()
    del final
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    per_step = 2 * cfg.n_layers          # forward + recompute under remat
    assert tc.remat
    assert counts == {"group_quantize": 0, "qmm": 0, "qmm_int4": 0,
                      "quantized_decode_attention": 0,
                      "flash_attention_fwd": per_step * TRAIN_STEPS,
                      "row_gemm": 0, "tc_gemm": 0}, \
        f"training launches {counts}"
    assert [h["step"] for h in hist] == list(range(1, TRAIN_STEPS + 1))
    for h in hist:
        assert math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]), h
    step_ms = [1e3 / h["steps_per_s"] for h in hist]
    print(f"training {cfg.name} B={TRAIN_BATCH} S={TRAIN_SEQ} qat_bits=8 "
          f"int8_ef remat: {TRAIN_STEPS} steps in {wall:.2f}s, loss "
          f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, grad norm "
          f"{hist[0]['grad_norm']:.3f} -> {hist[-1]['grad_norm']:.3f}; "
          f"{step_ms[0]:.1f} ms first step, "
          f"{statistics.median(step_ms[1:]):.1f} ms per step after "
          f"(median); flash launches {counts['flash_attention_fwd']} "
          f"({per_step} per step)")

    # one step from state0 with the kernel and with the plain attention
    batch = next(ShardedLoader(data, device=dev))
    outs = []
    for model in (DecoderLM(cfg), plain_lm(cfg)):
        t = Trainer(model, opt, dev, tc)
        outs.append(t._step(*state0, batch))
        torch.cuda.synchronize()
    (pk, _, _, mk), (pp, _, _, mp) = outs
    lk, lp = float(mk["loss"]), float(mp["loss"])
    assert abs(lk - lp) <= 1e-4 * abs(lp), f"train loss {lk} vs {lp}"
    gk, gp = float(mk["grad_norm"]), float(mp["grad_norm"])
    assert abs(gk - gp) <= 1e-3 * gp, f"grad norm {gk} vs {gp}"
    lr = float(mk["lr"])
    worst, moved, n = 0.0, 0, 0
    for a, b in zip(tree_leaves(pk), tree_leaves(pp)):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        moved += int((d > 1e-3 * lr).sum())
        n += d.numel()
    print(f"train step kernel vs plain attention: loss {lk:.6f} vs "
          f"{lp:.6f}, grad norm {gk:.5f} vs {gp:.5f}; params max|d| "
          f"{worst:.3e} = {worst / lr:.3f} lr, {moved} of {n} elements "
          f"beyond 1e-3 lr")
    assert moved <= PARAM_FLIP_SHARE * n, f"{moved} of {n} params differ"
    return counts["flash_attention_fwd"]


def spec_block(cfg, model, w, prompts, dev, ref_cache):
    """A B = 4, T = 1024 slot block filled from four batch-1 prefills at
    b_kv = 8 (phase 7's state), made twice: for the graphs and for the
    closures run eagerly."""
    import numpy as np
    import torch
    from repro_torch.runtime import greedy_decode_reference
    from repro_torch.runtime import decode_engine as de
    states = [greedy_decode_reference(
        model, w, p, 2, b_kv=8, reserve_tokens=1024 - p.size,
        return_state=True, compile_cache=ref_cache, device=dev)[1]
        for p in prompts[:4]]
    bufs = []
    for _ in range(2):
        buf = de._SlotBuffers(cfg, 1024, 4, 8, dev)
        for k in ("k_codes", "v_codes", "k_scales", "v_scales"):
            getattr(buf, k).copy_(torch.from_numpy(np.concatenate(
                [st[k] for st in states], axis=1)))
        buf.pos.copy_(torch.tensor([int(st["pos"]) for st in states]))
        buf.tok.copy_(torch.tensor([int(st["last_token"]) for st in states]))
        bufs.append(buf)
    return bufs


def spec_rounds(cfg, model, w, wd, prompts, dev, ref_cache, step_wall):
    """Phase 12, part 1: one speculative round (b_draft 4, k 4) from the
    captured draft and verify steps against the same closures run eagerly
    on a copy of the same block, bitwise (delivered block, counts, codes,
    scales, positions, tokens); the device ms of one draft and one verify
    step (CUDA events); the wall per delivered token of a round with one
    flag read per verify step and with a fixed n_draft + 1 verify steps,
    beside phase 7's plain token step.  Returns (draft ms, verify ms)."""
    import numpy as np
    import torch
    from repro_torch.runtime import CompiledForwardCache
    from repro_torch.runtime import decode_engine as de

    graph_buf, eager_buf = spec_block(cfg, model, w, prompts, dev,
                                      ref_cache)
    cache = CompiledForwardCache()
    t0 = time.perf_counter()
    draft = de._spec_draft_call(cache, model, 8, wd, graph_buf)
    verify = de._spec_verify_call(cache, model, 8, w, graph_buf)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    assert draft.launches["row_gemm"] == verify.launches["row_gemm"] \
        == row_gemm_per_step(cfg)
    assert draft.launches["quantized_decode_attention"] == cfg.n_layers
    live = np.ones(4, np.int32)
    rem = np.full(4, DECODE_NEW - 1, np.int32)
    eio = eager_buf.spec_io()
    got = de._spec_round(draft, verify, graph_buf, live, rem, 4)
    want = de._spec_round(
        lambda: de._spec_draft_step(model, 8, wd, eio),
        lambda: de._spec_verify_step(model, 8, w, eager_buf, eio),
        eager_buf, live, rem, 4)
    torch.cuda.synchronize()
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b), "captured spec round != eager"
    for a, b in zip(graph_buf.written(), eager_buf.written()):
        assert torch.equal(a, b), "captured spec buffers != eager"
    print(f"spec round captured == eager (B=4, T=1024, b_kv=8, b_draft=4, "
          f"k=4): delivered {got[1].tolist()} ({got[2].tolist()} accepted) "
          f"in {got[3]} verify steps, block, counts and every buffer "
          f"bitwise; draft and verify steps captured in {t_capture:.2f}s")

    io = graph_buf.spec_io()

    def event_ms(fn, reset, reps=9):
        times = []
        for _ in range(reps):
            reset()
            torch.cuda._sleep(SLEEP_CYCLES)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        return statistics.median(times)

    draft_ms = event_ms(draft, io.di.zero_)
    verify_ms = event_ms(verify, io.i.zero_)
    walls = {}
    for read_flags in (True, False):
        per_tok, delivered = [], 0
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cnt, _, _ = de._spec_round(draft, verify, graph_buf, live,
                                          rem, 4, read_flags)
            ms = (time.perf_counter() - t0) * 1e3
            per_tok.append(ms / int(cnt.sum()))
            delivered += int(cnt.sum())
        walls[read_flags] = statistics.median(per_tok[1:])
    print(f"spec steps (graph, B=4, T=1024): draft {draft_ms:.3f} device "
          f"ms, verify {verify_ms:.3f} device ms (CUDA events, median of 9); "
          f"a round (k=4) {walls[True]:.3f} ms wall per delivered token "
          f"({1e3 / walls[True]:.1f} tokens/s) with one flag read per "
          f"verify step, {walls[False]:.3f} ms ({1e3 / walls[False]:.1f} "
          f"tokens/s) with a fixed n_draft + 1 verify steps; plain decode "
          f"step (phase 7) {step_wall / 4:.3f} ms per token "
          f"({4e3 / step_wall:.1f} tokens/s); {card_line()}")
    return draft_ms, verify_ms


def speculative_path(cfg, params, dev, step_wall, engine_wall):
    """Phase 12; returns {kernel: launches} over the engine runs (eager
    launches plus each graph's record times its replays)."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core import codesign as cd
    from repro_torch.core import mixed_precision as mp
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.launch.serve import decode_classes, decode_system_params
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import (CompiledForwardCache, QosClass,
                                     SpeculativeDecodeEngine,
                                     greedy_decode_reference)

    model = DecoderLM(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in DECODE_PROMPTS]
    per_layer = cfg.active_param_count() / cfg.n_layers
    sysp = decode_system_params(cfg, SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * B * S,
        n_flop_server=2.0 * per_layer * (cfg.n_layers - cfg.split_layer)
        * B * S), 4, S, DECODE_NEW, speculative=True)
    pin = QosClass("interactive", *DECODE_BUDGET)
    ref_cache = CompiledForwardCache()

    def engine(classes, **kw):
        return SpeculativeDecodeEngine(model, params, sysp, classes=classes,
                                       max_batch=4,
                                       max_new_tokens=DECODE_NEW,
                                       device=dev, **kw)

    first = engine([pin], auto=False)
    first.set_operating_point(pin.name, 8, 8, b_draft=4, k=4)
    t0 = time.perf_counter()
    n_warm = first.warmup(max(DECODE_PROMPTS), DECODE_NEW)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    draft_ms, verify_ms = spec_rounds(
        cfg, model, first.class_params(pin.name), first.spec_params(pin.name),
        prompts, dev, ref_cache, step_wall)

    # auto and mixed: the first budget of the ladder at which both of the
    # CLI's classes are feasible (the codesign's host math, before any
    # engine is built)
    menus = dict(kv_ladder=(4, 8, 16), draft_ladder=(2, 4, 8),
                 lookahead=(2, 4, 8))
    solved = {}
    for mode in ("auto", "mixed"):
        for budget in SPEC_BUDGETS:
            classes = decode_classes(*budget)
            if mode == "auto":
                sols = [cd.solve_speculative(first.lam, first.lam_kv, sysp,
                                             c.t0, c.e0, **menus)
                        for c in classes]
            else:
                sols = [mp.allocate_bits_speculative(
                    first.layer_stats(), first.lam_kv, sysp, c.t0, c.e0,
                    **menus) for c in classes]
            if all(s is not None for s in sols):
                solved[mode] = classes
                break
        assert mode in solved, f"{mode}: infeasible at every budget"

    runs = [("b_draft 4, k 4", first, True)]
    for b_draft, k in SPEC_SCHEDULES[1:]:
        eng = engine([pin], auto=False)
        eng.set_operating_point(pin.name, 8, 8, b_draft=b_draft, k=k)
        runs.append((f"b_draft {b_draft}, k {k}", eng, False))
    runs.append(("auto", engine(solved["auto"]), False))
    runs.append(("mixed", engine(solved["mixed"], mixed_precision=True),
                 False))
    launches = dict.fromkeys(("quantized_decode_attention",
                              "flash_attention_fwd", "row_gemm"), 0)
    plain_wall, plain_tokens = engine_wall
    for name, eng, warm in runs:
        classes = list(eng._classes)
        t_round = eng.decode_round_cost(classes[0], 512)[0]
        rids = {eng.submit(p, classes[i % len(classes)],
                           arrival_s=DECODE_ARRIVE[i] * t_round): i
                for i, p in enumerate(prompts)}
        cc = eng.compile_cache
        before = {k for k, _ in cc.items()}
        assert cc.replays() == 0      # each engine's graphs replay here only
        tk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        responses = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eager = tk.launch_counts()
        replayed = cc.kernel_launches()
        rep, st = eng.report(), eng.spec_stats()
        steps = sum(e.replays for k, e in cc.items()
                    if k[0].startswith("spec-"))
        if warm:
            assert rep.compile_misses == n_warm, \
                f"{name}: {rep.compile_misses - n_warm} captures after warmup"
        new = [e for k, e in cc.items() if k not in before]
        assert eager == {k: sum(e.launches.get(k, 0) for e in new)
                         for k in eager}, f"{name}: eager launches {eager}"
        # every draft and verify step replays 24 decode attentions and 169
        # products, every prefill 24 flash launches
        want = {"quantized_decode_attention": cfg.n_layers * steps,
                "flash_attention_fwd": cfg.n_layers * rep.prefills,
                "row_gemm": row_gemm_per_step(cfg) * steps}
        assert {k: replayed.get(k, 0) for k in launches} == want, \
            f"{name}: replayed launches {replayed} != {want}"
        counts = {k: eager[k] + want[k] for k in launches}
        assert rep.requests_served == len(prompts)
        assert rep.tokens_generated == len(prompts) * DECODE_NEW
        for r in responses:
            i = rids[r.request_id]
            assert r.tokens.shape == (DECODE_NEW,)
            ref = greedy_decode_reference(
                model, eng.class_params(r.qos), prompts[i], DECODE_NEW,
                b_kv=r.b_kv, compile_cache=ref_cache, device=dev)
            assert np.array_equal(np.asarray(r.tokens), ref), \
                f"speculative {name} request {i}: {r.tokens} vs {ref}"
        for k in launches:
            launches[k] += counts[k]
        points = ", ".join(
            f"{c} b_hat={eng._classes[c].b_hat}"
            + (f" bits={list(eng._classes[c].plan_bits)}"
               if eng.mixed_precision else "")
            + f" b_kv={eng.b_kv_for(c)} (b_draft, k)={eng.draft_schedule(c)}"
            for c in classes)
        print(f"  speculative {name:15s} {points}: "
              + (f"warmup {n_warm} graphs in {t_warm:.2f}s, 0 captures "
                 "after; " if warm else
                 f"{rep.compile_misses} graphs captured while serving; ")
              + f"{st.rounds} rounds, {steps} draft + verify steps, "
              f"acceptance {st.acceptance_rate:.3f}, "
              f"{st.tokens_per_round:.2f} tokens/round; "
              f"{rep.tokens_generated} tokens in {wall:.2f}s wall "
              f"({wall * 1e3 / rep.tokens_generated:.2f} ms/token, "
              f"{rep.tokens_generated / wall:.1f} tokens/s; plain decode "
              f"{plain_tokens / plain_wall:.1f}); launches "
              f"{counts['quantized_decode_attention']} decode, "
              f"{counts['flash_attention_fwd']} flash, "
              f"{counts['row_gemm']} row_gemm; all {len(responses)} "
              f"responses == the batch-1 reference bitwise")
        print(f"    spec_stats {st}")
    print(f"speculative: draft step {draft_ms:.3f} / verify step "
          f"{verify_ms:.3f} device ms; {card_line()}")
    return launches


def hold_plan(eager, plain_model, b_hat, f, fs, logits, toks, dev):
    """One response of an adaptive batch served at uniform ``b_hat``
    against the plain path on the card: through ``hold_against_plain``
    on the kernel path (b̂ = 4, 8), else (the fake path, whose only
    kernel is flash) against the same forward with the plain attention,
    at E2E_TOL of the logits' scale.  Returns the line to print."""
    import torch
    eager.configure(b_hat, f, fs)
    tokens = toks[None]
    tok_dev = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    if eager.agent_path != "fake":
        return hold_against_plain(eager, plain_model, b_hat,
                                  eager.agent_path, logits[None], tokens,
                                  tok_dev)[0]
    kernel_model, eager.model = eager.model, plain_model
    try:
        with plain_products():
            ref_logits, _ = eager.serve_batch({"tokens": tokens})
    finally:
        eager.model = kernel_model
    scale = float(ref_logits.abs().max())
    diff = float((logits - ref_logits[0]).abs().max())
    assert diff <= E2E_TOL * scale, f"fake b_hat={b_hat}: logits {diff}"
    return f"logits max|d|={diff:.3e} of {scale:.3e} (plain attention)"


def adaptive_path(cfg, model, params, sysp, dev):
    """Phase 13; returns {kernel: launches} over the three policies'
    serving windows (eager launches plus graph replays)."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.env import presets
    from repro_torch.runtime import (AdaptiveCoInferenceEngine,
                                     BatchedCoInferenceEngine,
                                     CoInferenceEngine, QosClass)

    classes = [QosClass(n, t0, e0) for n, t0, e0 in ADAPTIVE_CLASSES]
    rng = np.random.default_rng(6)
    lens = rng.integers(COMPILED_SEQ[0], COMPILED_SEQ[1] + 1,
                        size=COMPILED_REQUESTS)
    reqs = [(rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32),
             classes[i % 2].name) for i, n in enumerate(lens)]
    plain_model = plain_lm(cfg)
    eager = CoInferenceEngine(model, params, sysp, path="kernel",
                              cache_weights=True, device=dev)
    launches = dict.fromkeys(("group_quantize", "qmm", "qmm_int4",
                              "flash_attention_fwd", "tc_gemm"), 0)
    held = set()
    reports = {}
    for policy in ("static", "adaptive", "oracle"):
        env = presets.edge_day(seed=0)
        span = env.horizon_s * 0.9
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        eng = AdaptiveCoInferenceEngine(
            model, params, sysp, classes=classes, environment=env,
            policy=policy, max_batch=4, path="kernel", compiled=True,
            device=dev)
        n_warm = eng.warmup(COMPILED_SEQ[1])
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        cc = eng.engine.compile_cache
        sent = {eng.submit(t, q, arrival_s=i * span / len(reqs)): t
                for i, (t, q) in enumerate(reqs)}
        t0 = time.perf_counter()
        served = []
        while eng.pending():
            served.append((eng.step(), eng.batch_history[-1]))
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        counts = tk.launch_counts()
        for k, n in cc.kernel_launches().items():
            if k in counts:
                counts[k] += n
        rep = eng.adaptive_report()
        reports[policy] = rep
        captures = cc.misses - n_warm
        for k in launches:
            launches[k] += counts[k]
        bits = [b.b_hat for _, b in served]
        assert min(bits) >= 2, f"{policy}: a batch at 1 bit ({bits})"
        for rs, b in served:
            for r in rs:
                assert torch.isfinite(r.logits).all(), \
                    f"{policy}: non-finite logits at b_hat={b.b_hat}"
        print(f"  adaptive {policy:8s} (edge-day seed 0): {rep}")
        print(f"    {n_warm} graphs at warmup({COMPILED_SEQ[1]}) in "
              f"{t_warm:.1f}s, {captures} captured while serving; "
              f"{rep.requests_served} requests in {len(served)} batches in "
              f"{t_serve:.2f}s; b_hat per batch "
              f"{[(b.qos, b.b_hat, b.agent_path) for _, b in served]}; "
              f"launches group_quantize {counts['group_quantize']}, qmm "
              f"{counts['qmm']}, qmm_int4 {counts['qmm_int4']}, flash "
              f"{counts['flash_attention_fwd']}")
        for e in eng.replan_events:
            print(f"    t={e.t_s:6.2f}s [{e.qos}] {e.reason}: "
                  f"b {e.b_before:.0f} -> {e.b_after:.0f}"
                  + (" (degraded)" if e.degraded else ""))
        # one response per plan against the plain path (counted nowhere)
        for rs, b in served:
            if (b.b_hat, b.agent_path) in held:
                continue
            held.add((b.b_hat, b.agent_path))
            line = hold_plan(eager, plain_model, b.b_hat, b.f, b.f_server,
                             rs[0].logits, sent[rs[0].request_id], dev)
            print(f"    plan b_hat={b.b_hat} ({b.agent_path}) vs plain: "
                  f"{line}")
    assert reports["static"].replans == 0, "static replanned"
    assert reports["adaptive"].replans >= 1, "adaptive never replanned"

    # a constant trace: the adaptive engine replays the batched engine's
    # graphs (one compile cache) and returns its responses bitwise
    out = {}
    cache = None
    for name in ("batched", "adaptive"):
        kw = dict(classes=classes, max_batch=4, path="kernel",
                  compiled=True, device=dev, compile_cache=cache)
        if name == "batched":
            eng = BatchedCoInferenceEngine(model, params, sysp, **kw)
            eng.warmup(COMPILED_SEQ[1])
            cache = eng.engine.compile_cache
        else:
            eng = AdaptiveCoInferenceEngine(
                model, params, sysp, environment=presets.constant(), **kw)
        misses = cache.misses
        for i, (t, q) in enumerate(reqs):
            eng.submit(t, q, arrival_s=float(i))
        out[name] = (sorted(eng.drain(), key=lambda r: r.request_id),
                     eng.batch_history, cache.misses - misses)
    (rb, hb, _), (ra, ha, miss_a) = out["batched"], out["adaptive"]
    assert miss_a == 0 and ha == hb
    for x, y in zip(ra, rb):
        assert x.stats == y.stats and torch.equal(x.logits, y.logits), \
            f"constant trace: request {x.request_id} adaptive != batched"
    print(f"  adaptive on a constant trace == batched bitwise: all "
          f"{len(ra)} responses, the same graphs replayed (0 captures); "
          f"{card_line()}")
    return launches


def fleet_members(cfg, params, dev):
    """Phase 14's agents (FLEET_AGENTS) as ``FleetAgentSpec``s: the qwen2-0.5b
    agents share ``params`` (phase 4's, seed 0), stablelm-3b ``FULL`` gets
    its own seeded weights; each agent's constants carry its model's
    full-width FLOPs at the B x S workload, the kiosk's also its uplink
    (FLEET_KIOSK_LINK) under ``wifi-markov`` (seed 0)."""
    import dataclasses

    import torch
    from repro_torch.configs.stablelm_3b import FULL as SL
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.env import presets
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import FleetAgentSpec, QosClass

    sl_model = DecoderLM(SL)
    sl_params = sl_model.init(torch.Generator(device=dev).manual_seed(2))
    models = {"qwen2-0.5b": (DecoderLM(cfg), params),
              "stablelm-3b": (sl_model, sl_params)}

    def sysp_of(c):
        per_layer = c.active_param_count() / c.n_layers
        return SystemParams(
            n_flop_agent=2.0 * per_layer * c.split_layer * B * S,
            n_flop_server=2.0 * per_layer * (c.n_layers - c.split_layer)
            * B * S)

    specs = []
    for name, arch, t0, e0, weight in FLEET_AGENTS:
        model, p = models[arch]
        sysp = sysp_of(model.cfg)
        env = None
        if name == "kiosk":
            sysp = dataclasses.replace(sysp, **FLEET_KIOSK_LINK)
            env = presets.wifi_markov(seed=0)
        specs.append(FleetAgentSpec(
            name=name, model=model, params=p, sysp=sysp,
            qos=QosClass(name, t0, e0), weight=weight, environment=env))
    return specs


def fleet_traffic(specs):
    """FLEET_REQUESTS requests of FLEET_SEQ tokens per agent, the agent's
    j-th arriving at j x FLEET_GAP s (the kiosk's cross wifi states)."""
    import numpy as np
    rng = np.random.default_rng(14)
    out = []
    for s in specs:
        for j in range(FLEET_REQUESTS):
            n = int(rng.integers(FLEET_SEQ[0], FLEET_SEQ[1] + 1))
            out.append((s.name, rng.integers(
                0, s.model.cfg.vocab_size, size=n).astype(np.int32),
                j * FLEET_GAP))
    return out


# phase 20 (a): (example, argv, the kernels that must launch in the call).
# The examples run their smoke configs: quickstart, adaptive and fleet
# serve on the fake path (flash only), co_inference_serve's classes land
# on b̂ = 4 / 8 / 16 (a mixed class holds an int8-container layer),
# decode and speculative decode from the quantized cache
EXAMPLE_RUNS = (
    ("quickstart", [], ("flash_attention_fwd",)),
    ("co_inference_serve", [], ("group_quantize", "qmm", "qmm_int4",
                                "flash_attention_fwd")),
    ("co_inference_serve", ["--mixed-precision"],
     ("group_quantize", "qmm", "flash_attention_fwd")),
    ("co_inference_serve", ["--compiled"], ("group_quantize", "qmm",
                                            "qmm_int4",
                                            "flash_attention_fwd")),
    ("decode_serve", [], ("quantized_decode_attention", "row_gemm",
                          "flash_attention_fwd")),
    ("speculative_serve", [], ("quantized_decode_attention", "row_gemm",
                               "flash_attention_fwd")),
    ("adaptive_serve", [], ("flash_attention_fwd",)),
    ("fleet_serve", [], ("flash_attention_fwd",)),
)
# phase 20 (b): the per-layer bits of its mixed plan, cycled over the
# layers
RESIDENT_MIXED = (2, 3, 4, 5, 6, 7, 8)
RESIDENT_HOST_LAYERS = len(RESIDENT_MIXED)   # layers the CPU copy checks


def release_memory() -> str:
    """Collect garbage and free the allocator's cached blocks; the line
    to print: the card's memory in use and free."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return (f"cuda memory: {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
            f"GiB allocated, {torch.cuda.memory_reserved() / 2 ** 30:.2f} "
            f"GiB reserved, {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} "
            f"GiB free")


def open_window(cc=None):
    """Start a launch-count window: zero the wrappers' eager counts and
    return what the graphs of ``cc`` (a cache that may outlive the window)
    launched in their replays so far, for :func:`window_counts`."""
    from repro_torch import kernels as tk
    tk.reset_launch_counts()
    return {} if cc is None else cc.kernel_launches()


def window_counts(cc, before):
    """The window's launches, once the device has finished: (eager plus
    replayed, replayed), where a graph of ``cc`` replayed its record once
    a replay since :func:`open_window` returned ``before``."""
    import torch
    from repro_torch import kernels as tk
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    replayed = {k: n - before.get(k, 0)
                for k, n in cc.kernel_launches().items()}
    for k, n in replayed.items():
        if k in counts:
            counts[k] += n
    return counts, replayed


def hold_fleet_launches(fleet, counts):
    """Every graph of the fleet's cache: 7 x split ``qmm``/``qmm_int4``
    launches a forward, all on the tensor-core route, and one flash launch
    a layer; eager launches only the captures' warm-up runs; one
    ``group_quantize`` launch per materialized weight set."""
    from repro_torch import kernels as tk
    cc = fleet.compile_cache
    eager_qmm = 0
    for key, cf in cc.items():
        assert cf.graph is not None, f"{key[0].name}: a forward uncaptured"
        c = key[0]
        rec = cf.launches
        assert rec.get("qmm", 0) + rec.get("qmm_int4", 0) \
            == 7 * c.split_layer, (c.name, rec)
        assert rec.get("qmm.simt", 0) == rec.get("qmm_int4.simt", 0) == 0
        assert rec.get("flash_attention_fwd", 0) == c.n_layers, rec
        assert rec.get("tc_gemm", 0) == tc_gemm_per_forward("kernel", c), \
            (c.name, rec)
        eager_qmm += 7 * c.split_layer
    eager = tk.launch_counts()
    assert eager["qmm"] + eager["qmm_int4"] == eager_qmm, (eager, eager_qmm)
    for name in ("qmm", "qmm_int4"):
        assert getattr(tk, name).route_launches["simt"] == 0, name
    sets = [k for k in cc.buffer_keys() if k[0] == "agent-weights"]
    assert eager["group_quantize"] == len(sets), (eager, len(sets))
    assert counts["qmm"] > 0 and counts["qmm_int4"] > 0, counts
    assert counts["flash_attention_fwd"] > 0, counts


def run_fleet(specs, allocator, dev, traffic):
    """One fleet run (mixed precision, kernel path, CUDA graphs, max_batch
    4): warmup, then the traffic.  Returns (fleet, responses per agent,
    launches, warmup graphs, wall s)."""
    import torch
    from repro_torch.runtime import FleetCoInferenceEngine
    before = open_window()      # the fleet's cache is made in the window
    t0 = time.perf_counter()
    fleet = FleetCoInferenceEngine(specs, allocator=allocator, max_batch=4,
                                   path="kernel", mixed_precision=True,
                                   compiled=True, device=dev)
    n_warm = fleet.warmup(FLEET_SEQ[1])
    for name, toks, t in traffic:
        if name in fleet.engines:
            fleet.submit(name, toks, arrival_s=t)
    out = fleet.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, _ = window_counts(fleet.compile_cache, before)
    hold_fleet_launches(fleet, counts)
    for name, rs in out.items():
        eng = fleet.engines[name]
        for b in eng.batch_history:
            # a plan whose layers are all 4 or all 8 bits serves as b̂
            bits = b.plan_bits or (b.b_hat,)
            assert 2 <= min(bits) and max(bits) <= 8, (name, bits)
        for r in rs:
            assert torch.isfinite(r.logits).all(), (name, r.request_id)
    return fleet, out, counts, n_warm, wall


def fleet_path(cfg, params, dev):
    """Phase 14; returns the launches of the joint and equal-split fleet
    windows and the agents' specs (for phase 15)."""
    import numpy as np
    import torch
    from repro_torch.core import fleet as fl
    from repro_torch.core.quantization import QuantPlan
    from repro_torch.env import presets
    from repro_torch.runtime import (AdaptiveCoInferenceEngine,
                                     BatchedCoInferenceEngine,
                                     CoInferenceEngine,
                                     FleetCoInferenceEngine)

    specs = fleet_members(cfg, params, dev)
    traffic = fleet_traffic(specs)
    launches = dict.fromkeys(("group_quantize", "qmm", "qmm_int4",
                              "flash_attention_fwd", "tc_gemm"), 0)
    bounds = {}
    for allocator in ("joint", "equal"):
        fleet, out, counts, n_warm, wall = run_fleet(specs, allocator, dev,
                                                     traffic)
        for k in launches:
            launches[k] += counts[k]
        rep = fleet.report()
        bounds[allocator] = rep.aggregate_bound
        assert sum(rep.shares) <= 1.0 + 1e-9, rep.shares
        assert rep.requests_served == len(traffic)
        cc = fleet.compile_cache
        print(f"  fleet {allocator}: {len(specs)} agents, {n_warm} graphs at "
              f"warmup({FLEET_SEQ[1]}), {cc.misses - n_warm} captured while "
              f"serving; {rep.requests_served} requests in "
              f"{rep.batches_served} batches in {wall:.2f}s; shares "
              f"{[round(s, 4) for s in rep.shares]} (sum "
              f"{sum(rep.shares):.6f}); aggregate bound "
              f"{rep.aggregate_bound:.4e}; launches {counts}")
        for a in rep.per_agent:
            er = fleet.engines[a.name].report()
            print(f"    agent {a.name:8s} share={a.share:.4f} plan bits "
                  f"{list(a.plan_bits)} (b_hat {a.b_hat}) "
                  f"captures={er.compile_misses} hits={er.compile_hits} "
                  f"batches={a.batches_served} clock={a.clock_s:.3f}s "
                  f"violations={a.deadline_violations}")
        if allocator != "joint":
            continue
        # the compile-cache rule: one graph per (config, plan, bucket) --
        # the qwen agents over one params object share theirs, and
        # stablelm-3b's are its own
        keys = [k for k, _ in cc.items()]
        for c in {k[0] for k in keys}:
            mine = [k for k in keys if k[0] == c]
            assert len(mine) == len({(k[1], k[3]) for k in mine}), c.name
        q_caps = sum(fleet.engines[s.name].report().compile_misses
                     for s in specs if s.model.cfg == cfg)
        q_keys = sum(1 for k in keys if k[0] == cfg)
        assert q_caps == q_keys, (q_caps, q_keys)
        shared = sum(fleet.engines[s.name].report().compile_hits
                     for s in specs if s.model.cfg == cfg)
        print(f"    compile cache: {len(keys)} graphs, {q_keys} for the two "
              f"qwen2-0.5b agents (one per plan and bucket; the second "
              f"agent reused the first's graphs {shared} times), "
              f"{len(keys) - q_keys} for stablelm-3b")

        # each member against a directly built engine at its slice, with
        # its own caches: bitwise
        for s, share in zip(specs, fleet.allocation.shares):
            p = fl.shared_params(s.sysp, share)
            kw = dict(classes=[s.qos], max_batch=4, path="kernel",
                      mixed_precision=True, compiled=True, device=dev)
            if s.environment is not None:
                direct = AdaptiveCoInferenceEngine(
                    s.model, s.params, p, environment=presets.wifi_markov(
                        seed=0), policy=s.policy, **kw)
            else:
                direct = BatchedCoInferenceEngine(s.model, s.params, p, **kw)
            direct.warmup(FLEET_SEQ[1])
            for name, toks, t in traffic:
                if name == s.name:
                    direct.submit(toks, s.qos.name, arrival_s=t)
            got = {r.request_id: r for r in out[s.name]}
            for r in direct.drain():
                g = got.pop(r.request_id)
                assert torch.equal(g.logits, r.logits), \
                    f"{s.name} request {r.request_id}: fleet != direct"
                assert g.stats == r.stats, s.name
            assert not got
            del direct
        print(f"    every member's {FLEET_REQUESTS} responses == a directly "
              f"built engine at its slice with its own caches: bitwise")

        # per agent: device ms of one 4 x 64 replay (CUDA events, hot) and
        # the wall of serve_batch (after the counts were read)
        for s in specs:
            eng = fleet.engines[s.name]
            eng._configure_class(s.qos.name)
            toks = np.random.default_rng(1).integers(
                0, s.model.cfg.vocab_size, size=(B, S))
            exe = eng.engine._compiled_executable(B, S)
            dev_ms, walls = [], []
            for _ in range(7):
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                exe()
                b.record()
                b.synchronize()
                dev_ms.append(a.elapsed_time(b))
                t0 = time.perf_counter()
                eng.engine.serve_batch({"tokens": toks})
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            print(f"    agent {s.name:8s} ({s.model.cfg.name}, "
                  f"{eng.engine.agent_path}) forward {B}x{S}: "
                  f"{statistics.median(dev_ms):.3f} device ms (CUDA events "
                  f"around one replay, median of 7), "
                  f"{statistics.median(walls):.3f} ms wall serve_batch")

        # stablelm-3b's forward at its plan against the plain versions
        mon = specs[[s.name for s in specs].index("monitor")]
        plan = fleet.engines["monitor"].plan_for("monitor")
        eng = CoInferenceEngine(mon.model, mon.params, mon.sysp,
                                path="kernel", device=dev)
        eng.configure(plan)
        toks = np.random.default_rng(3).integers(
            0, mon.model.cfg.vocab_size, size=(B, S))
        logits, _ = eng.serve_batch({"tokens": toks})
        line, _ = hold_against_plain(
            eng, plain_lm(mon.model.cfg), plan, eng.agent_path, logits, toks,
            torch.as_tensor(toks, dtype=torch.long, device=dev))
        print(f"    stablelm-3b {eng.agent_path} vs plain: {line}")
        del eng, fleet
    assert bounds["joint"] <= bounds["equal"] * (1.0 + 1e-12), bounds

    # a one-agent fleet == its directly built engine, bitwise
    drone = specs[0]
    solo = FleetCoInferenceEngine([drone], max_batch=4, path="kernel",
                                  mixed_precision=True, compiled=True,
                                  device=dev)
    direct = BatchedCoInferenceEngine(
        drone.model, drone.params, drone.sysp, classes=[drone.qos],
        max_batch=4, path="kernel", mixed_precision=True, compiled=True,
        device=dev)
    assert solo.allocation.shares == (1.0,)
    for name, toks, t in traffic:
        if name == drone.name:
            solo.submit(name, toks, arrival_s=t)
            direct.submit(toks, drone.qos.name, arrival_s=t)
    for x, y in zip(solo.drain()[drone.name], direct.drain()):
        assert torch.equal(x.logits, y.logits) and x.stats == y.stats
    print(f"    one-agent fleet == its direct engine: bitwise "
          f"({FLEET_REQUESTS} responses); joint bound "
          f"{bounds['joint']:.4e} <= equal {bounds['equal']:.4e}")
    del solo, direct
    torch.cuda.empty_cache()
    return launches, specs


def resilient_batched(cfg, model, params, sysp, dev):
    """Phase 15, batched: COMPILED_CLASSES and phase 10's requests, bare,
    supervised on a clean trace, then supervised and bare under
    examples/chaos_spec.json, the spec CHAOS_DILATION times slower, and
    (the same requests in OUTAGE_CLASS) an outage window whose batches fail
    over to device-only serving.  Returns the windows' launches."""
    import numpy as np
    import torch
    from repro_torch.env import (ChaosTrace, LinkOutage, chaos_from_spec,
                                 presets)
    from repro_torch.obs import Tracer
    from repro_torch.runtime import (BatchedCoInferenceEngine,
                                     CompiledForwardCache, QosClass,
                                     ServingSupervisor)

    classes = [QosClass(n, t0, e0) for n, t0, e0 in COMPILED_CLASSES]
    outage = [QosClass(*OUTAGE_CLASS)]
    rng = np.random.default_rng(6)
    lens = rng.integers(COMPILED_SEQ[0], COMPILED_SEQ[1] + 1,
                        size=COMPILED_REQUESTS)
    reqs = [(rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32),
             classes[i % 2].name) for i, n in enumerate(lens)]
    spec = json.loads((ROOT / "examples" / "chaos_spec.json").read_text())
    # the spec's fault pattern on this workload's time scale: a full-width
    # batch bills seconds (C.9), the spec's horizon is 5 s of 1 ms steps
    k = CHAOS_DILATION
    slow = dict(spec, dt_s=spec["dt_s"] * k, horizon_s=spec["horizon_s"] * k,
                preemption={n: v * k for n, v in spec["preemption"].items()})
    # an uplink outage longer than the retry budget (the reference's sticky
    # outage, tests/test_chaos.py, made one window): batches fail over
    sticky = ChaosTrace(dt_s=0.1, horizon_s=60.0, seed=1,
                        link_outage=LinkOutage(p_fail=0.3, p_recover=0.05))
    sticky.link_up[:] = True
    sticky.link_up[sticky.index_at(OUTAGE_WINDOW[0]):
                   sticky.index_at(OUTAGE_WINDOW[1])] = False
    cache = CompiledForwardCache()
    launches = dict.fromkeys(("group_quantize", "qmm", "qmm_int4",
                              "flash_attention_fwd", "tc_gemm"), 0)
    per_forward = 7 * cfg.split_layer
    runs = {}
    failovers = 0
    for name, chaos, supervised, cls in (
            ("bare engine", None, None, classes),
            ("clean trace", presets.chaos_clean(), True, classes),
            ("chaos_spec supervised", chaos_from_spec(spec), True, classes),
            ("chaos_spec bare", chaos_from_spec(spec), False, classes),
            (f"chaos_spec x{k} supervised", chaos_from_spec(slow), True,
             classes),
            (f"chaos_spec x{k} bare", chaos_from_spec(slow), False, classes),
            ("outage window supervised", sticky, True, outage),
            ("outage window bare", sticky, False, outage)):
        before = open_window(cache)
        eng = BatchedCoInferenceEngine(model, params, sysp, classes=cls,
                                       max_batch=4, path="kernel",
                                       compiled=True, compile_cache=cache,
                                       device=dev)
        eng.warmup(COMPILED_SEQ[1])
        m0 = cache.misses
        tracer = Tracer()
        front = eng if chaos is None else ServingSupervisor(
            eng, chaos=chaos, supervised=supervised, seed=chaos.seed,
            tracer=tracer)
        ids = [front.submit(t, q if cls is classes else cls[0].name)
               for t, q in reqs]
        t0 = time.perf_counter()
        out = front.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, replayed = window_counts(cache, before)
        for k_ in launches:
            launches[k_] += counts[k_]
        got = [r.request_id for r in out]
        assert len(got) == len(set(got)) and set(got) <= set(ids), \
            f"{name}: duplicated or unknown responses"
        for r in out:
            assert torch.isfinite(r.logits).all(), name
        hist = eng.batch_history
        assert min(b.b_hat for b in hist) >= 2, \
            f"{name}: a batch below 2 bits ({[b.b_hat for b in hist]})"
        # one forward replayed per batch: 7 x split products on its
        # agent path's kernel (none on the fake path), a flash launch a
        # layer
        paths = [b.agent_path for b in hist]
        want = {"qmm": per_forward * paths.count("kernel-int8"),
                "qmm_int4": per_forward * paths.count("kernel-int4"),
                "flash_attention_fwd": cfg.n_layers * len(hist),
                "tc_gemm": sum(tc_gemm_per_forward(p, cfg) for p in paths)}
        assert {k_: replayed.get(k_, 0) for k_ in want} == want, \
            f"{name}: replayed {replayed} != {want} for batches {paths}"
        runs[name] = {r.request_id: r for r in out}
        line = f"{len(out)} delivered"
        if chaos is not None:
            rep = front.report()
            assert rep.delivered + rep.failed + rep.shed == len(reqs), rep
            assert rep.tokens_duplicated == 0
            line = (f"delivered {rep.delivered}/{rep.requests_total} (failed "
                    f"{rep.failed}, shed {rep.shed}) retries={rep.retries} "
                    f"retransmits={rep.retransmits} "
                    f"failovers={rep.failovers} faults={rep.faults_seen} "
                    f"clock={rep.clock_s:.3f}s")
            spans = [e["args"] for e in tracer.events
                     if e["name"] == "failover.local" and e["ph"] == "B"]
            assert len(spans) == rep.failovers, (spans, rep.failovers)
            if rep.failovers:
                # the failover batches serve at b̂ 4: every batch at 4 bits
                # ran kernel-int4, so each launched per_forward qmm_int4
                assert {s["b_hat"] for s in spans} == {4}, spans
                assert all(p == "kernel-int4" for b, p in zip(hist, paths)
                           if b.b_hat == 4), paths
                line += (f"; failover batches at b_hat "
                         f"{[s['b_hat'] for s in spans]} on kernel-int4, "
                         f"{per_forward} qmm_int4 launches each")
            if supervised:
                assert rep.failed == 0, rep
                failovers += rep.failovers
        print(f"  resilience batched {name:26s}: {line}; b_hat per batch "
              f"{[(b.b_hat, b.agent_path) for b in hist]}; "
              f"{cache.misses - m0} graphs captured while serving; "
              f"{wall:.2f}s wall; launches {counts}")
    for rid, r in runs["bare engine"].items():
        c = runs["clean trace"][rid]
        assert torch.equal(r.logits, c.logits) and r.stats == c.stats
    assert failovers >= 1, "no batch failed over to device-only serving"
    print(f"    clean trace == bare engine: bitwise ({len(reqs)} responses); "
          f"{failovers} device-only failovers, through qmm_int4")
    return launches


def resilient_decode(cfg, params, dev, speculative):
    """Phase 15, decode: phase 7's prompts at (8, 8) (speculative: draft
    (4, 4)) from CUDA graphs, uninterrupted, then with the server preempted
    for the middle of the run, supervised and bare.  Returns the windows'
    launches."""
    import numpy as np
    import torch
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.env import ChaosTrace, ServerPreemption
    from repro_torch.launch.serve import decode_system_params
    from repro_torch.models.lm import DecoderLM
    from repro_torch.obs import Tracer
    from repro_torch.runtime import (CompiledForwardCache, DecodeEngine,
                                     QosClass, ServingSupervisor,
                                     SpeculativeDecodeEngine,
                                     greedy_decode_reference)

    model = DecoderLM(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in DECODE_PROMPTS]
    per_layer = cfg.active_param_count() / cfg.n_layers
    sysp = decode_system_params(cfg, SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * B * S,
        n_flop_server=2.0 * per_layer * (cfg.n_layers - cfg.split_layer)
        * B * S), 4, S, DECODE_NEW, speculative=speculative)
    pin = QosClass("interactive", *DECODE_BUDGET)
    cache = CompiledForwardCache()
    kind = "speculative" if speculative else "decode"

    def engine():
        kw = dict(classes=[pin], auto=False, max_batch=4,
                  max_new_tokens=DECODE_NEW, compile_cache=cache, device=dev)
        if speculative:
            e = SpeculativeDecodeEngine(model, params, sysp, **kw)
            e.set_operating_point(pin.name, 8, 8, b_draft=4, k=4)
        else:
            e = DecodeEngine(model, params, sysp, **kw)
            e.set_operating_point(pin.name, 8, 8)
        return e

    launches = dict.fromkeys(("quantized_decode_attention",
                              "flash_attention_fwd", "row_gemm"), 0)
    eng0 = engine()
    eng0.warmup(max(DECODE_PROMPTS), DECODE_NEW)
    t_round = eng0.decode_round_cost(pin.name, 512)[0]
    arrivals = [a * t_round for a in DECODE_ARRIVE]
    refs = [greedy_decode_reference(model, eng0.class_params(pin.name), p,
                                    DECODE_NEW, b_kv=8, compile_cache=cache,
                                    device=dev) for p in prompts]
    for p, t in zip(prompts, arrivals):
        eng0.submit(p, pin.name, arrival_s=t)
    t0 = time.perf_counter()
    for r in eng0.drain():
        assert np.array_equal(r.tokens, refs[r.request_id])
    torch.cuda.synchronize()
    wall0 = time.perf_counter() - t0
    span = eng0.clock_s
    for supervised in (True, False):
        total = dict(recoveries=0, lost=0, delivered=0, crashes=0,
                     restored_crashes=0, wall=0.0, recover=0.0, d2h=0)
        for lo, hi in RESILIENT_CRASHES:
            chaos = ChaosTrace(dt_s=t_round, horizon_s=4.0 * span, seed=0,
                               preemption=ServerPreemption(mtbf_s=1e9,
                                                           mttr_s=1e9))
            i0 = chaos.index_at(lo * span)
            i1 = max(i0 + 1, chaos.index_at(hi * span))
            chaos.server_up[:] = True
            chaos.server_up[i0:i1] = False
            eng = engine()
            tracer = Tracer()
            sup = ServingSupervisor(
                eng, chaos=chaos, supervised=supervised, seed=3,
                deadline_factor=RESILIENT_DEADLINE_FACTOR, tracer=tracer)
            rids = {sup.submit(p, pin.name, arrival_s=t): i
                    for i, (p, t) in enumerate(zip(prompts, arrivals))}
            before = open_window(cache)
            d2h0 = eng.report().d2h_bytes
            t0 = time.perf_counter()
            out = sup.drain()
            torch.cuda.synchronize()
            total["wall"] += time.perf_counter() - t0
            counts, _ = window_counts(cache, before)
            for k in launches:
                launches[k] += counts[k]
            rep = sup.report()
            total["d2h"] += eng.report().d2h_bytes - d2h0
            total["recoveries"] += rep.recoveries
            total["lost"] += rep.tokens_lost
            total["delivered"] += rep.tokens_delivered
            # a crash's recovery on the tracer's clock: from its
            # preemption edge to the last stream it restored
            last = {}
            for e in tracer.events:
                if e["name"] == "fault.inject" and \
                        e["args"]["kind"] == "preemption":
                    edge = e["ts"]
                    last[edge] = None
                elif e["name"] == "recover.restore":
                    last[edge] = e["ts"]
            spans = [t - e for e, t in last.items() if t is not None]
            total["crashes"] += len(last)
            total["restored_crashes"] += len(spans)
            total["recover"] += sum(spans) * 1e-6
            assert rep.tokens_duplicated == 0, rep
            if supervised:
                assert rep.delivered == len(prompts) and rep.failed == 0, \
                    rep
                assert rep.tokens_lost == 0, rep
                for r in out:
                    assert np.array_equal(r.tokens,
                                          refs[rids[r.request_id]]), \
                        f"{kind}: resumed request {rids[r.request_id]} " \
                        "differs"
        if supervised:
            assert total["recoveries"] >= 1, total
        else:
            assert total["lost"] > 0, total
        print(f"  resilience {kind} {'supervised' if supervised else 'bare'}"
              f" over {len(RESILIENT_CRASHES)} crash windows "
              f"{RESILIENT_CRASHES} of the run: recoveries="
              f"{total['recoveries']}, tokens delivered/lost="
              f"{total['delivered']}/{total['lost']}, 0 duplicated; "
              f"{total['wall']:.2f}s wall (uninterrupted {wall0:.2f}s a "
              f"run); {total['crashes']} crash events, the "
              f"{total['restored_crashes']} that restored streams recovered "
              f"in {total['recover'] * 1e3:.1f} ms wall (preemption edge to "
              f"the last stream restored: snapshot, resume through the "
              f"batch-1 graphs), {total['d2h']} device-to-host bytes")
    print(f"    every supervised {kind} stream == its uninterrupted "
          f"batch-1 reference: bitwise ({len(prompts)} x {DECODE_NEW} "
          f"tokens)")
    return launches


def resilient_fleet(specs, dev):
    """Phase 15, fleet: phase 14's joint fleet under agent dropout
    (RESILIENT_DROPOUT): one reallocation per membership edge of the trace
    over the run, no request lost.  Returns the window's launches."""
    import torch
    from repro_torch.env import AgentDropout, ChaosTrace
    from repro_torch.obs import Tracer
    from repro_torch.runtime import FleetCoInferenceEngine, ServingSupervisor

    traffic = fleet_traffic(specs)
    fleet = FleetCoInferenceEngine(specs, allocator="joint", max_batch=4,
                                   path="kernel", mixed_precision=True,
                                   compiled=True, device=dev)
    n_warm = fleet.warmup(FLEET_SEQ[1])
    chaos = ChaosTrace(dt_s=0.5, horizon_s=60.0, seed=9,
                       n_agents=len(specs),
                       dropout=AgentDropout(p_drop=0.05, p_rejoin=0.3))
    # deterministic windows over the seeded trace: an agent away for a
    # stretch longer than any batch the frontier jumps by
    chaos.agents_up[:] = True
    names = [s.name for s in specs]
    for name, (lo, hi) in RESILIENT_DROPOUT.items():
        chaos.agents_up[names.index(name),
                        chaos.index_at(lo):chaos.index_at(hi)] = False
    tracer = Tracer()
    sup = ServingSupervisor(fleet, chaos=chaos, seed=3, tracer=tracer)
    for name, toks, t in traffic:
        sup.submit(name, toks, arrival_s=t)
    before = open_window(fleet.compile_cache)
    t0 = time.perf_counter()
    out = sup.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, _ = window_counts(fleet.compile_cache, before)
    rep = sup.report()
    # the membership edges of the trace up to the fleet's last clock
    end = chaos.index_at(max(e.clock_s for e in fleet.engines.values()))
    sets = [frozenset(n for i, n in enumerate(names) if chaos.agents_up[i, j])
            for j in range(end + 1)]
    edges = sum(a != b for a, b in zip(sets, sets[1:]))
    drops = sum(1 for e in tracer.events if e["name"] == "fault.inject"
                and e["args"]["kind"] == "dropout")
    assert rep.delivered == len(traffic) and rep.failed == 0, rep
    assert rep.reallocations == edges >= 1, (rep.reallocations, edges)
    assert drops == len(RESILIENT_DROPOUT), drops
    for r in out:
        assert torch.isfinite(r.logits).all()
    bits = [(n, b.plan_bits or (b.b_hat,)) for n, e in fleet.engines.items()
            for b in e.batch_history]
    assert all(min(pb) >= 2 for _, pb in bits), bits
    print(f"  resilience fleet under dropout {RESILIENT_DROPOUT}: "
          f"delivered {rep.delivered}/"
          f"{rep.requests_total}, failed {rep.failed}, reallocations "
          f"{rep.reallocations} == the trace's membership edges {edges} "
          f"({drops} dropouts seen), faults {rep.faults_seen}; "
          f"{fleet.compile_cache.misses - n_warm} graphs captured while "
          f"serving; {wall:.2f}s wall; launches {counts}")
    del fleet, sup
    torch.cuda.empty_cache()
    return counts


def resilient_training(cfg, dev):
    """Phase 15, training: ``Trainer.fit`` (B x S = TRAIN_BATCH x TRAIN_SEQ,
    QAT 8, int8-EF) for TRAIN_STEPS steps checkpointing every 5 (keep 1);
    then a run cut after step 7, whose step-5 checkpoint was written while
    steps 6 and 7 changed the state in place, and a fresh trainer that
    restores that asynchronous checkpoint and runs to TRAIN_STEPS: the
    restored state bitwise the state handed to ``save_async``, the losses
    against the uninterrupted run's, and a synchronous save of the same
    state timed in a directory of its own.  Checkpoints go to build/ckpt
    under the checkout and are deleted.  Returns the flash launches."""
    import math
    import shutil

    import torch
    from repro_torch import kernels as tk
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import (MarkovLMConfig, MarkovLMDataset,
                                  ShardedLoader)
    from repro_torch.models.lm import DecoderLM, tree_leaves
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import TrainConfig, Trainer

    def leaves(state):
        p, o, e = state
        return list(tree_leaves(p)) + [o.step] + list(tree_leaves(o.m)) \
            + list(tree_leaves(o.v)) + list(tree_leaves(e))

    class Keeping(CheckpointManager):
        """Keeps a device copy of each tree handed to ``save_async``,
        taken on the caller's thread before the manager's host snapshot:
        what the checkpoint must hold, whatever later steps do in place."""

        def save_async(self, step, tree, metadata=None):
            self.kept = (step, [t.clone() for t in leaves(
                (tree["params"], tree["opt"], tree["err"]))])
            super().save_async(step, tree, metadata)

    root = ROOT / "build" / "ckpt"
    shutil.rmtree(root, ignore_errors=True)
    tc = TrainConfig(qat_bits=8, grad_compression="int8_ef", log_every=1)
    data = MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH))

    def trainer(d, manager=CheckpointManager):
        return Trainer(DecoderLM(cfg),
                       AdamW(learning_rate=cosine_schedule(3e-4, 20,
                                                           TRAIN_STEPS)),
                       dev, tc, ckpt=manager(str(d), keep=1,
                                             save_interval=5))

    flash = 0
    try:
        tk.reset_launch_counts()
        full = trainer(root / "full")
        t0 = time.perf_counter()
        _, hist = full.fit(ShardedLoader(data, device=dev), TRAIN_STEPS)
        torch.cuda.synchronize()
        wall_full = time.perf_counter() - t0
        flash += tk.launch_counts()["flash_attention_fwd"]
        losses = [h["loss"] for h in hist]
        assert all(math.isfinite(x) for x in losses)
        del full, _
        shutil.rmtree(root / "full")
        torch.cuda.empty_cache()

        # the interrupted run: cut after step 7, its step-5 checkpoint
        # written asynchronously while steps 6 and 7 ran
        tk.reset_launch_counts()
        first = trainer(root / "cut", Keeping)
        _, hist_a = first.fit(ShardedLoader(data, device=dev), 7)
        torch.cuda.synchronize()
        step, kept = first.ckpt.kept
        assert step == 5, step
        del first, _
        torch.cuda.empty_cache()
        manifest = json.loads((root / "cut" / "step_5" /
                               "manifest.json").read_text())
        nbytes = manifest["bytes_raw"]
        second = trainer(root / "cut")
        like = second.init_state(0)
        t0 = time.perf_counter()
        restored = second.maybe_restore(*like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del like
        assert restored[3] == 5
        for a, b in zip(leaves(restored[:3]), kept):
            assert a.device == b.device and torch.equal(a, b), \
                "restored state != the state handed to save_async"
        del kept
        torch.cuda.empty_cache()
        # a synchronous save of the same state, timed alone in its own
        # directory
        sync = CheckpointManager(str(root / "sync"), keep=1)
        tree = {"params": restored[0], "opt": restored[1],
                "err": restored[2]}
        t0 = time.perf_counter()
        sync.save(5, tree, metadata={"data_step": 5})
        save_s = time.perf_counter() - t0
        shutil.rmtree(root / "sync")
        del tree
        loader = ShardedLoader(data, device=dev)
        loader.seek(restored[3])
        final, hist_b = second.fit(loader, TRAIN_STEPS - 5,
                                   state=restored[:3])
        torch.cuda.synchronize()
        del restored
        flash += tk.launch_counts()["flash_attention_fwd"]
        got = [h["loss"] for h in hist_a[:5] + hist_b]
        assert [h["step"] for h in hist_a[:5] + hist_b] == \
            list(range(1, TRAIN_STEPS + 1))
        assert [h["step"] for h in hist_a] == list(range(1, 8))
        cut = [h["loss"] for h in hist_a]
        bitwise = got == losses and cut == losses[:7]
        worst = max(abs(a - b) / abs(b)
                    for a, b in zip(got + cut, losses + losses[:7]))
        assert worst <= 1e-4, f"resumed losses {got} ({cut}) vs {losses}"
        print(f"  resilience training {cfg.name} B={TRAIN_BATCH} "
              f"S={TRAIN_SEQ} qat 8 int8_ef: uninterrupted {TRAIN_STEPS} "
              f"steps in {wall_full:.2f}s (async checkpoints at 5 and 10, "
              f"keep 1); checkpoint {nbytes} bytes; the cut run's async "
              f"step-5 checkpoint (written while steps 6-7 ran) restored "
              f"in {restore_s:.2f}s ({nbytes / restore_s / 1e9:.3f} GB/s: "
              f"read, sha256, host-to-device) == the state handed to "
              f"save_async: bitwise; a synchronous save of it "
              f"{save_s:.2f}s ({nbytes / save_s / 1e9:.3f} GB/s: "
              f"device-to-host copy, sha256, write); cut and resumed "
              f"losses == uninterrupted: "
              + ("bitwise" if bitwise else f"within {worst:.2e} relative "
                 f"(limit 1e-4), not bitwise")
              + f"; losses {[round(x, 6) for x in got]}")
        del final, second
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return flash


def wide_state(cfg, buf, lens, seed):
    """Fill a slot block with a seeded synthetic int8 cache (codes in
    [-127, 127], scales in [0.01, 0.03]) and ragged lengths."""
    import torch
    gen = torch.Generator(device=buf.device).manual_seed(seed)
    for i in range(cfg.n_layers):
        for t in (buf.k_codes[i], buf.v_codes[i]):
            t.random_(-127, 128, generator=gen)
    for t in (buf.k_scales, buf.v_scales):
        t.uniform_(0.01, 0.03, generator=gen)
    buf.pos.copy_(torch.as_tensor(lens, dtype=torch.int32))
    buf.tok.random_(0, cfg.vocab_size, generator=gen)


def wide_step(cfg, model, w8, what, b, t, lens, dev, rows_alone=True,
              peaks=None):
    """One token step at B slots over a T-position cache: batched vs rows
    alone (logits bitwise; skipped with ``rows_alone=False``, an MoE step
    past 8 experts, whose rows share the experts' capacity as in the
    reference), kernels vs plain attention (the token rule), the captured
    step vs its closure run eagerly (tokens and written entries bitwise);
    prints tokens/s, device ms and peak memory.  Returns {kernel:
    launches} of the captured step's part, counted: its capture's eager
    warm-up, the eager step it is held against and its 12 replays (the
    logits compared before it are not counted).  ``peaks``, a list, gets
    the step's peak device bytes."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import CompiledForwardCache
    from repro_torch.runtime import decode_engine as de

    class PlainLM(DecoderLM):
        def decode_attend(self, q, kc, vc, ks, vs, lens):
            return ref.quantized_decode_attention_ref(
                q, kc, vc, ks, vs, lens, window=self.cfg.sliding_window,
                block_t=4096)

    torch.cuda.reset_peak_memory_stats()
    buf = de._SlotBuffers(cfg, t, b, 8, dev)
    wide_state(cfg, buf, lens, seed=t + b)
    rows = torch.arange(b, device=dev)
    at = buf.pos.clamp(max=t - 1).long()

    def snapshot():
        return [x[:, rows, at].clone() for x in (
            buf.k_codes, buf.v_codes, buf.k_scales, buf.v_scales)] \
            + [buf.pos.clone(), buf.tok.clone()]

    def restore(snap):
        for x, v in zip((buf.k_codes, buf.v_codes, buf.k_scales,
                         buf.v_scales), snap):
            x[:, rows, at] = v
        buf.pos.copy_(snap[4])
        buf.tok.copy_(snap[5])

    def logits_of(lm, sl):
        pos, tok = buf.pos[sl], buf.tok[sl]
        return lm.decode_step_q(
            w8, {"k_codes": buf.k_codes[:, sl], "v_codes": buf.v_codes[:, sl],
                 "k_scales": buf.k_scales[:, sl],
                 "v_scales": buf.v_scales[:, sl], "len": pos},
            {"token": tok[:, None], "pos": pos}, b_kv=8)[0]

    snap = snapshot()
    with torch.no_grad():
        full = logits_of(model, slice(None))
        sample = sorted({0, b // 2, b - 1}) if rows_alone else []
        for i in sample:
            assert torch.equal(logits_of(model, slice(i, i + 1))[0],
                               full[i]), f"{what}: row {i} alone != batched"
        plain = logits_of(PlainLM(cfg), slice(None))
        torch.cuda.synchronize()
    assert bool(torch.isfinite(full).all()), f"{what}: logits not finite"
    d_plain = float((full - plain).abs().max())
    scale = float(plain.abs().max())
    assert d_plain <= E2E_TOL * scale, f"{what}: {d_plain} of {scale}"
    top2 = plain.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2.0 * d_plain
    same = full.argmax(-1) == plain.argmax(-1)
    assert bool(same[clear].all()), f"{what}: a token flipped where the " \
        "plain run's margin exceeds twice the logit difference"
    restore(snap)

    # the captured step's own peak: from here to the last replay
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    phase_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cache = CompiledForwardCache()
    t0 = time.perf_counter()
    graph = de._step_call(cache, model, 8, w8, buf)
    torch.cuda.synchronize()
    t_cap = time.perf_counter() - t0
    # the capture's transient peak: the entries its warm-up step writes,
    # saved and put back (ROADMAP C.10: a copy of the whole block until
    # then), and the graph's own buffers; what the graph keeps is what
    # stays after it
    capture_peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    capture_top = torch.cuda.max_memory_allocated()
    saved_kib = de._save_entries(buf, buf.canonical()[:4],
                                 buf.pos).nbytes / 2 ** 10
    graph_held = (torch.cuda.memory_allocated() - held) / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    live = np.ones(b, np.int32)
    blk_g = de._decode_chunk(graph, buf.step_io, live, 1)[0].clone()
    after_g = snapshot()
    restore(snap)
    blk_e = de._decode_chunk(
        lambda: de._decode_step(model, 8, w8, buf, buf.step_io),
        buf.step_io, live, 1)[0].clone()
    after_e = snapshot()
    torch.cuda.synchronize()
    assert torch.equal(blk_g, blk_e), f"{what}: captured step != eager"
    assert all(torch.equal(x, y) for x, y in zip(after_g, after_e)), \
        f"{what}: captured step's written entries != eager"
    assert torch.equal(blk_g[:, 0].long(), full.argmax(-1)), \
        f"{what}: the step's tokens != the batched logits' argmax"
    restore(snap)
    dev_ms = []
    for _ in range(3):
        torch.cuda._sleep(SLEEP_CYCLES)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        graph()
        ev[1].record()
        ev[1].synchronize()
        dev_ms.append(ev[0].elapsed_time(ev[1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    de._decode_chunk(graph, buf.step_io, live, 8)[0].cpu()
    wall = (time.perf_counter() - t0) * 1e3 / 8
    replay_peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    if peaks is not None:
        peaks.append(max(phase_peak, capture_top,
                         torch.cuda.max_memory_allocated()))
    eager = tk.launch_counts()
    replayed = {k: n * graph.replays for k, n in graph.launches.items()}
    assert replayed.get("row_gemm", 0) == 12 * row_gemm_per_step(cfg) and \
        replayed.get("quantized_decode_attention", 0) == 12 * cfg.n_layers, \
        f"{what}: replays launched {replayed}"
    counted = {k: n + replayed.get(k, 0) for k, n in eager.items()}
    kv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    ws_gb = b * kv * -(-t // 64) * g * (cfg.head_dim + 2) * 4 / 2 ** 30
    cache_gb = sum(x.numel() * x.element_size() for x in buf.canonical()) \
        / 2 ** 30
    print(f"  {what} (B={b}, T={t}, b_kv=8, lengths {min(lens)}-"
          f"{max(lens)}, mean {sum(lens) / len(lens):.0f}; {cache_gb:.2f} "
          f"GiB of cache): "
          + (f"rows {sample} alone bitwise" if rows_alone else
             "rows share the experts' capacity (not held alone)")
          + "; plain attention "
          f"max|d logits|={d_plain:.3e} of {scale:.2f}, "
          f"{int(same.sum())}/{b} tokens equal ({int(clear.sum())} "
          f"held); captured == eager bitwise (captured in {t_cap:.2f}s); "
          f"{statistics.median(dev_ms):.3f} device ms a step (CUDA events, "
          f"median of 3), {wall:.3f} ms wall a step in an 8-step chunk, "
          f"{b * 1e3 / wall:.1f} tokens/s; memory: the graph keeps "
          f"{graph_held:.3f} GiB (a decode-attention workspace "
          f"{ws_gb:.3f} GiB, {cfg.n_layers} a step: one live at a time), "
          f"its replays "
          f"{replay_peak:.3f} GiB more at peak, the capture "
          f"{capture_peak:.3f} GiB above what it found (it saves "
          f"{saved_kib:.1f} KiB of entries; a copy of the block, 25.73 GiB "
          f"at DECODE_32K, before), the phase {phase_peak / 2 ** 30:.2f} "
          f"GiB at peak with "
          f"the plain run; launches (the warm-up, the eager step, 12 "
          f"replays) {counted['row_gemm']} row_gemm, "
          f"{counted['quantized_decode_attention']} decode attention; "
          f"{card_line()}")
    del buf, graph, cache
    return counted


def pinned_decode_run(cfg, model, params, dev, slots, prompts, new,
                      batch_one=True):
    """``DecodeEngine`` at ``slots`` from graphs, pinned at (b̂, b_kv) = (8,
    8), serving ``prompts`` with ``new`` tokens each in one counted
    window: every token step's replay launches ``row_gemm_per_step(cfg)``
    row_gemm and one decode attention a layer, the eager launches are the
    captures' warm-up runs; with ``batch_one`` every response equals its
    batch-1 reference bitwise.  Returns (launches, report, wall s, the
    class's weights)."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.launch.serve import decode_system_params
    from repro_torch.runtime import (CompiledForwardCache, DecodeEngine,
                                     QosClass, greedy_decode_reference)

    per_layer = cfg.active_param_count() / cfg.n_layers
    sysp = decode_system_params(cfg, SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * B * S,
        n_flop_server=2.0 * per_layer * (cfg.n_layers - cfg.split_layer)
        * B * S), slots, S, new)
    pin = QosClass("interactive", *DECODE_BUDGET)
    eng = DecodeEngine(model, params, sysp, classes=[pin], auto=False,
                       max_batch=slots, max_new_tokens=new, device=dev)
    eng.set_operating_point(pin.name, 8, 8)
    rids = {eng.submit(p, pin.name, arrival_s=0.0): i
            for i, p in enumerate(prompts)}
    cc = eng.compile_cache
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    responses = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eager = tk.launch_counts()
    replayed = cc.kernel_launches()
    rep = eng.report()
    assert rep.requests_served == len(prompts)
    assert replayed.get("row_gemm", 0) == \
        row_gemm_per_step(cfg) * rep.decode_rounds, replayed
    assert replayed.get("quantized_decode_attention", 0) == \
        cfg.n_layers * rep.decode_rounds, replayed
    assert eager == {k: sum(e.launches.get(k, 0) for _, e in cc.items())
                     for k in eager}, f"eager launches {eager}"
    counts = {k: eager[k] + replayed.get(k, 0) for k in eager}
    for r in responses:
        assert len(r.tokens) == new and \
            all(0 <= int(t) < cfg.vocab_size for t in r.tokens)
    w8 = eng.class_params(pin.name)
    if batch_one:
        ref_cache = CompiledForwardCache()
        for r in responses:
            i = rids[r.request_id]
            want = greedy_decode_reference(model, w8, prompts[i], new,
                                           b_kv=8, compile_cache=ref_cache,
                                           device=dev)
            assert np.array_equal(r.tokens, want), \
                f"{cfg.name} request {i}: {r.tokens} != {want}"
    return counts, rep, wall, w8


def wide_decode(cfg, params, dev):
    """Phase 16; returns {kernel: launches} of its engine run (eager plus
    the graphs' replays) and of the steps' replays."""
    import numpy as np
    from repro_torch.models.lm import DecoderLM

    model = DecoderLM(cfg)
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(*WIDE_PROMPT_LEN, WIDE_PROMPTS)]
    counts, rep, wall, w8 = pinned_decode_run(cfg, model, params, dev,
                                              WIDE_SLOTS, prompts, WIDE_NEW)
    print(f"  DecodeEngine max_batch={WIDE_SLOTS}: {WIDE_PROMPTS} prompts "
          f"of {WIDE_PROMPT_LEN[0]}-{WIDE_PROMPT_LEN[1] - 1} tokens, "
          f"{WIDE_NEW} new each, {rep.prefills} prefills, "
          f"{rep.decode_rounds} token steps, {rep.compile_misses} graphs "
          f"captured, {wall:.2f}s wall; every response == its batch-1 "
          f"reference bitwise; launches {counts['row_gemm']} row_gemm, "
          f"{counts['quantized_decode_attention']} decode attention")
    print(f"  {release_memory()}")
    rng = np.random.default_rng(32)
    for what, b, t in WIDE_STEPS:
        lens = [t - 16] if b == 1 else \
            [t - 16, 5] + rng.integers(t // 16, t - 16, b - 2).tolist()
        for k, n in wide_step(cfg, model, w8, what, b, t, lens,
                              dev).items():
            counts[k] += n
        print(f"  {release_memory()}")
    return counts


def family_config(arch, layers, split, experts):
    """The published config of ``arch`` cut in depth (and expert count)
    only, and the ``reduced:`` line naming each cut."""
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(arch)
    cut = {"split_layer": split}
    notes = [f"split {split} (published {full.split_layer})"]
    if layers is not None:
        cut["n_layers"] = layers
        notes.append(f"{layers} of {full.n_layers} layers")
    if experts is not None:
        cut["n_experts"] = experts
        notes.append(f"{experts} of {full.n_experts} experts (top-"
                     f"{full.experts_per_token} kept)")
    return dataclasses.replace(full, **cut), "reduced: " + "; ".join(notes)


def check_family_attention(cfg, dev, flush):
    """Decode attention (B = 4, T = 1024, int8, ragged lengths) and flash
    (B = 4, S = 64, causal) at ``cfg``'s heads against their plain
    versions, every row bitwise alone; kernel, plain, library (SDPA) and
    bound times, L2 flushed.  Returns {kernel: row of numbers}."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantize import kv_dequantize

    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = {}
    args = decode_case(dev, 4, 1024, 8, seed=h + dh,
                       lens=[1024, 800, 532, 300], h=h, kv=kv, dh=dh)
    out = tk.quantized_decode_attention(*args)
    want = ref.quantized_decode_attention_ref(*args)
    torch.cuda.synchronize()
    scale, diff = float(want.abs().max()), float((out - want).abs().max())
    assert diff <= DECODE_TOL * scale, \
        f"decode attention {cfg.name}: {diff} of {scale}"
    for i in range(4):
        alone = tk.quantized_decode_attention(*(a[i:i + 1] for a in args))
        assert torch.equal(alone[0], out[i]), \
            f"decode attention {cfg.name}: row {i} alone != in batch"
    q, kc, vc, ks, vs, lens = args
    qh = q.transpose(1, 2)
    kd = kv_dequantize(kc, ks).transpose(1, 2).contiguous()
    vd = kv_dequantize(vc, vs).transpose(1, 2).contiguous()
    mask = (torch.arange(1024, device=dev)[None, :]
            < lens[:, None].long())[:, None, None, :]
    b_ms, by = decode_bound(args)
    rows["quantized_decode_attention"] = dict(
        ms=time_ms(lambda: tk.quantized_decode_attention(*args), flush),
        plain_ms=time_ms(lambda: ref.quantized_decode_attention_ref(*args),
                         flush, reps=5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qh, kd, vd, attn_mask=mask, enable_gqa=True), flush),
        bound_ms=b_ms, bound_by=by, max_abs_err=diff,
        shape=f"B=4 T=1024 H={h} KV={kv} G={h // kv} dh={dh} b_kv=8")
    del args, kd, vd
    q, k, v = flash_case(dev, 4, 64, seed=dh, dh=dh, h=h, kv=kv)
    out = tk.flash_attention_fwd(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, rtol=FLASH_TOL, atol=FLASH_TOL,
                               msg=f"flash attention {cfg.name}")
    for i in range(4):
        alone = tk.flash_attention_fwd(q[i:i + 1], k[i:i + 1], v[i:i + 1])
        assert torch.equal(alone[0], out[i]), \
            f"flash attention {cfg.name}: row {i} alone != in batch"
    b_ms, by = flash_bound(q, k)
    rows["flash_attention_fwd"] = dict(
        ms=time_ms(lambda: tk.flash_attention_fwd(q, k, v), flush),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v), flush,
                         reps=5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), flush),
        bound_ms=b_ms, bound_by=by,
        max_abs_err=float((out - want).abs().max()),
        shape=f"B=4 S=T=64 H={h} KV={kv} G={h // kv} dh={dh} f32 causal")
    for name, r in rows.items():
        print(f"  {name:26s} {cfg.name} {r['shape']}: ms={r['ms']:.4f} "
              f"plain={r['plain_ms']:.4f} sdpa={r['library_ms']:.4f} "
              f"bound={r['bound_ms']:.6f} ({r['bound_by']}) "
              f"max|d|={r['max_abs_err']:.2e}; rows alone bitwise")
    return rows


def family_batch(cfg):
    """The 4 x 64 serving batch: Markov tokens, or for the vision stub
    (llava) caption-proxy embeds for int(64 x vis_frac) // 16 x 16
    positions and caption tokens for the rest (the reference's
    ``input_specs`` split)."""
    from repro_torch.data import (CaptionProxyConfig, CaptionProxyDataset,
                                  MarkovLMConfig, MarkovLMDataset)
    if cfg.frontend == "none":
        return MarkovLMDataset(MarkovLMConfig(
            vocab_size=cfg.vocab_size, seq_len=S, batch_size=B)).batch_at(
                0)["tokens"], None
    n_vis = int(S * cfg.vis_frac) // 16 * 16
    batch = CaptionProxyDataset(CaptionProxyConfig(
        vocab_size=cfg.vocab_size, seq_len=S - n_vis, d_model=cfg.d_model,
        n_vis=n_vis, batch_size=B, n_images=16)).batch_at(0)
    return batch["tokens"], batch["embeds"]


def routed_model(base, hook: str, cfg, plain, replay=None):
    """``base`` (``DecoderLM``, whose MoE layers run in ``_ffn``, or
    ``HybridLM``, in ``moe``: the ``hook``) whose MoE layers log each
    call's expert choice (``log``, in layer order) and, given ``replay``
    (another run's log), take that run's choice instead of their own,
    noting each call where their own differed (``flips``: (probs, own,
    replayed)); ``plain`` (an ``attend(q, k, v)`` or None) replaces the
    flash kernel."""
    import torch
    from repro_torch.models import moe as M

    class Routed(base):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.log, self.flips = [], []

        def attend(self, q, k, v):
            if plain is not None:
                return plain(q, k, v)
            return super().attend(q, k, v)

        def routed_moe(self, p, h, tp=None, dp=None, products=None):
            n = len(self.log)

            def topk(probs, k):
                v, i = M.top_k(probs, k)
                if replay is not None:
                    if not torch.equal(i, replay[n]):
                        self.flips.append((probs, i, replay[n]))
                    i = replay[n]
                    v = torch.gather(probs, -1, i)
                self.log.append(i)
                return v, i
            return M.apply_moe(self.cfg, p, h, router_topk=topk, tp=tp,
                               dp=dp)

    setattr(Routed, hook, Routed.routed_moe)
    return Routed(cfg)


def routed_lm(cfg, plain: bool, replay=None):
    """:func:`routed_model` of ``DecoderLM``; ``plain`` attends through
    the flash kernel's plain version."""
    from repro_torch.models.lm import DecoderLM
    return routed_model(DecoderLM, "_ffn", cfg,
                        plain_attend(cfg) if plain else None, replay)


def hold_moe_against_plain(eng, cfg, batch, logits):
    """An MoE forward's served ``logits`` against the same forward with
    plain attention.  The router's top-k is discrete: where two experts'
    probabilities nearly tie, the attention's f32 differences (or a
    boundary element on an uplink rounding edge) can change a token's
    experts, and through the experts' capacity other tokens' slots, and
    the logits then differ by far more than the sums' rounding.  So the
    plain run replays the kernel run's expert choices, every choice of its
    own that differs is held to be a near tie (the two experts'
    probabilities within ROUTE_TIE of each other, relative), and then the
    logits are held as the dense models' (E2E_TOL, greedy tokens equal
    where the margin is clear).  Returns the line to print."""
    import torch
    kernel_model = eng.model
    rec = routed_lm(cfg, plain=False)
    try:
        eng.model = rec
        again, _ = eng.serve_batch(batch)
        ref = routed_lm(cfg, plain=True, replay=rec.log)
        eng.model = ref
        with plain_products():
            ref_logits, _ = eng.serve_batch(batch)
    finally:
        eng.model = kernel_model
    assert torch.equal(again, logits), f"{cfg.name}: a second forward " \
        "(expert choices logged) changed bits"
    assert len(rec.log) == cfg.n_layers
    flipped = near_ties(ref.flips, cfg.name)
    return (held_greedy(logits, ref_logits, cfg.name)
            + f" (plain attention, the kernel run's expert choices "
            f"replayed; {flipped} token-layer choices of its own differed, "
            f"each a near tie within {ROUTE_TIE})")


def near_ties(flips, what) -> int:
    """Every (probs, own, replayed) expert choice of a replaying run
    that differed from the replayed one must be a near tie: the two
    experts' probabilities within ROUTE_TIE, relative.  Returns the count
    of token-layer choices that differed."""
    import torch
    flipped = 0
    for probs, own, want in flips:
        p_own = torch.gather(probs, -1, own)
        p_want = torch.gather(probs, -1, want)
        rows = (own != want).any(-1)
        gap = ((p_own - p_want).abs() / p_own)[rows]
        assert float(gap.max()) <= ROUTE_TIE, \
            f"{what}: an expert choice differs by {float(gap.max())}"
        flipped += int(rows.sum())
    return flipped


def family_serving(cfg, model, params, sysp, dev):
    """The 4 x 64 forward: a dense model through the kernel path at b̂ = 8
    and 4 (qmm / qmm_int4 / group_quantize / flash launches asserted) held
    against the plain versions; an MoE model's agent on the fake path (the
    kernel path excludes MoE, as in the reference) held against the same
    forward with plain attention.  Returns the window's launches."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels.quantize import MAX_DESCS
    from repro_torch.runtime import CoInferenceEngine

    tokens, embeds = family_batch(cfg)
    batch = {"tokens": tokens} if embeds is None else \
        {"embeds": embeds, "tokens": tokens}
    tok_dev = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    plain_model = plain_lm(cfg)
    per_configure = -(-agent_products(cfg) * cfg.split_layer // MAX_DESCS)
    want = dict.fromkeys(tk.KERNELS, 0)
    tk.reset_launch_counts()
    eng = CoInferenceEngine(model, params, sysp, path="kernel")
    served = []
    if not cfg.n_experts:
        want["group_quantize"] += per_configure
    for point in (8, 4) if not cfg.n_experts else (8,):
        # an MoE agent's fake-quantized weights are a full copy of the
        # layer stacks: serve the engine's own b̂ = 8 rather than make a
        # second copy beside the first
        if not cfg.n_experts:
            eng.configure(point)
        assert eng.b_hat == point
        logits, stats = eng.serve_batch(batch)
        n8, n4 = launches_per_forward(eng.agent_path, cfg)
        if not cfg.n_experts:
            want["group_quantize"] += per_configure
        want["qmm"] += n8
        want["qmm_int4"] += n4
        want["flash_attention_fwd"] += cfg.n_layers
        want["tc_gemm"] += tc_gemm_per_forward(eng.agent_path, cfg)
        served.append((point, eng.agent_path, logits, stats))
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert counts == want, f"{cfg.name} launches {counts} != {want}"
    for name in ("qmm", "qmm_int4"):
        assert getattr(tk, name).route_launches["simt"] == 0, name
    for point, path, logits, stats in served:
        if not cfg.n_experts:
            eng.configure(point)
        if cfg.n_experts:
            assert path == "fake", path
            held = hold_moe_against_plain(eng, cfg, batch, logits)
        else:
            held, _ = hold_against_plain(eng, plain_model, point, path,
                                         logits, tokens, tok_dev, embeds)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.serve_batch(batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"  {cfg.name} {path} b_hat={point} {tuple(logits.shape)}"
              + ("" if embeds is None else f" ({embeds.shape[1]} stub embed "
                 "rows)")
              + f": {held}; serve_batch wall {statistics.median(walls):.2f}"
              f" ms (median of 3); emb_bytes={stats.emb_bytes}")
    del eng, served
    return counts


def family_decode(cfg, model, params, dev, slots, peaks):
    """``pinned_decode_run`` at ``slots`` over FAMILY_PROMPTS, 16 new
    tokens each (a dense model's every stream == its batch-1 reference),
    then one token step on a seeded block at the same slots
    (``wide_step``): kernels against plain attention, captured == eager, a
    dense model's rows alone bitwise.  Returns the launches."""
    import numpy as np
    import torch

    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in FAMILY_PROMPTS]
    rows_alone = cfg.n_experts <= 8
    counts, rep, wall, w8 = pinned_decode_run(
        cfg, model, params, dev, slots, prompts, FAMILY_NEW,
        batch_one=rows_alone)
    torch.cuda.synchronize()
    peaks.append(torch.cuda.max_memory_allocated())
    print(f"  {cfg.name} DecodeEngine max_batch={slots}: {len(prompts)} "
          f"prompts of {min(FAMILY_PROMPTS)}-{max(FAMILY_PROMPTS)} tokens, "
          f"{FAMILY_NEW} new each, {rep.decode_rounds} token steps, "
          f"{rep.compile_misses} graphs captured, {wall:.2f}s wall; "
          + ("every response == its batch-1 reference bitwise"
             if rows_alone else "rows share the experts' capacity at "
             f"{cfg.n_experts} experts (a reference property): the step is "
             "held against plain attention below")
          + f"; launches {counts['row_gemm']} row_gemm, "
          f"{counts['quantized_decode_attention']} decode attention, "
          f"{counts['flash_attention_fwd']} flash")
    lens = [1000, 5] + rng.integers(64, 1000, slots - 2).tolist()
    for k, n in wide_step(cfg, model, w8, f"{cfg.name} step", slots, 1024,
                          lens, dev, rows_alone=rows_alone,
                          peaks=peaks).items():
        counts[k] += n
    return counts


def family_path(arch, layers, split, experts, slots, dev, flush):
    """Phase 17 for one config: its kernels at its new shapes, then the
    model (seeded random weights) served and decoded; prints its peak
    device memory.  Returns {kernel: launches} of its counted windows."""
    import torch
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.models.lm import DecoderLM, tree_leaves

    t_cfg = time.perf_counter()
    cfg, reduced = family_config(arch, layers, split, experts)
    print(f"  {arch}: {reduced}; published widths: d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
          + (f"{cfg.n_experts} experts of {cfg.moe_d_ff} (top "
             f"{cfg.experts_per_token})" if cfg.n_experts else
             f"d_ff {cfg.d_ff} ({cfg.act}"
             + (", gated" if cfg.act == "silu" else ", not gated") + ")")
          + f", vocab {cfg.vocab_size}")
    torch.cuda.reset_peak_memory_stats()
    peaks = []
    if not cfg.n_experts:
        family_configure_time(cfg, dev, flush)
        detail = []
        check_kernels(cfg, dev, flush, detail, ms=FAMILY_QMM_M)
        for d in detail:
            print(f"  {d['kernel']:15s} {cfg.name} m={d['m']} k={d['k']} "
                  f"n={d['n']} ms={d['ms']:.4f} plain={d['plain_ms']:.4f} "
                  f"lib={d['library_ms']:.4f} bound={d['bound_ms']:.4f} "
                  f"({d['bound_by']}) err={d['max_abs_err']:.2e}")
    check_row_gemm(cfg, dev, flush, seed=17)
    check_family_attention(cfg, dev, flush)
    print(f"  {cfg.name} kernels: {time.perf_counter() - t_cfg:.1f}s")
    peaks.append(torch.cuda.max_memory_allocated())
    print(f"  {release_memory()}")

    t0 = time.perf_counter()
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(17))
    n_params = sum(x.numel() for x in tree_leaves(params))
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {n_params / 1e9:.3f} B parameters, "
          f"{4 * n_params / 1e9:.2f} GB at f32 (reckoned "
          f"{cfg.param_count() / 1e9:.3f} B), built in "
          f"{time.perf_counter() - t0:.1f}s")
    per_layer = cfg.active_param_count() / cfg.n_layers
    sysp = SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * B * S,
        n_flop_server=2.0 * per_layer * (cfg.n_layers - cfg.split_layer)
        * B * S)
    counts = family_serving(cfg, model, params, sysp, dev)
    torch.cuda.synchronize()
    peaks.append(torch.cuda.max_memory_allocated())
    print(f"  {release_memory()}")
    for k, n in family_decode(cfg, model, params, dev, slots, peaks).items():
        counts[k] += n
    del model, params
    print(f"  {cfg.name}: peak {max(peaks) / 2 ** 30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated over its kernels, serving and "
          f"decode); {time.perf_counter() - t_cfg:.1f}s wall; "
          f"{release_memory()}")
    return counts


def family_configure_time(cfg, dev, flush):
    """Phase 17, a dense config: one configure's agent matrices (every
    agent layer's, random weights at its widths, G = 128, b = 8)
    quantized as the engine does, ``torch.equal`` the plain version, timed
    against the plain version and the byte bound (PERF.md row 3b)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import ref

    ws = configure_weights(cfg, dev, seed=5)
    groups = [128] * len(ws)
    before = tk.group_quantize.launches
    got = q.group_quantize_many(ws, groups, [8] * len(ws))
    torch.cuda.synchronize()
    n_launch = tk.group_quantize.launches - before
    for w, (codes, scales) in zip(ws, got):
        want = ref.group_quantize_ref(w, 128, 8)
        assert torch.equal(codes, want[0]) and torch.equal(scales, want[1]), \
            f"group_quantize {cfg.name} {tuple(w.shape)}"
    del got
    n_el = sum(w.numel() for w in ws)
    b_ms, by = bound_ms(4 * n_el + n_el + 4 * n_el // 128, 2.0 * n_el)
    row = dict(
        ms=time_ms(lambda: q.group_quantize_many(ws, groups, [8] * len(ws)),
                   flush, reps=5),
        plain_ms=time_ms(lambda: [ref.group_quantize_ref(w, 128, 8)
                                  for w in ws], flush, reps=3),
        bound_ms=b_ms, bound_by=by, library_ms=None, max_abs_err=0.0)
    print(f"  group_quantize {cfg.name} one configure ({len(ws)} matrices, "
          f"{n_el / 1e6:.1f} M weights, G=128, b=8, {n_launch} launch(es)): "
          f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
          f"bound={b_ms:.4f} ({by}); {b_ms / row['ms']:.1%} of the bound; "
          f"codes and scales equal the plain version")
    return row


# ---------------------------------------------------------------------------
# phase 18: the recurrent and encoder-decoder families
# ---------------------------------------------------------------------------

def flash_pair(dev, b, s, t, h, kv, dh, seed):
    """q [B, H, S, dh] and k, v [B, KV, T, dh] as strided views of the
    models' [B, S, H, dh] layout."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, h, dh), generator=gen, device=dev)
    k, v = (torch.randn((b, t, kv, dh), generator=gen, device=dev)
            for _ in range(2))
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def check_flash_recurrent_shapes(dev, flush):
    """Flash at phase 18's new shapes against its plain version at
    FLASH_TOL, every row alone bitwise, timed beside SDPA and the bound
    (L2 flushed): jamba's heads (64 over 8, dh 128, causal) and
    seamless's (16 over 16, dh 64): bidirectional S = T = 512 and the
    cross-attention at S = 256 over T = 512 and S = 512 over T = 256."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref

    fwd = tk.flash_attention_fwd
    rows = []
    for name, b, s, t, h, kv, dh, causal in FLASH_RECURRENT:
        q, k, v = flash_pair(dev, b, s, t, h, kv, dh, seed=s + t + dh)
        out = fwd(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=FLASH_TOL, atol=FLASH_TOL,
                                   msg=f"flash attention {name}")
        for i in range(b):
            alone = fwd(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal)
            assert torch.equal(alone[0], out[i]), \
                f"flash attention {name}: row {i} alone != in batch"
        b_ms, by = flash_bound(q, k, causal=causal)
        r = dict(
            name=name, ms=time_ms(lambda: fwd(q, k, v, causal=causal), flush),
            plain_ms=time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal), flush, reps=5),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), flush),
            bound_ms=b_ms, bound_by=by,
            max_abs_err=float((out - want).abs().max()))
        rows.append(r)
        print(f"  flash_attention_fwd {name}: B={b} S={s} T={t} H={h} "
              f"KV={kv} dh={dh} {'causal' if causal else 'bidirectional'} "
              f"ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"sdpa={r['library_ms']:.4f} bound={b_ms:.6f} ({by}) "
              f"max|d|={r['max_abs_err']:.2e}; rows alone bitwise")
    return rows


def check_recurrent_cells(dev):
    """One layer each of mLSTM and sLSTM (xlstm-350m's widths) and Mamba
    (jamba's: d_model 8192, 128 heads of 128, state 16), seeded weights,
    decoded token by token from the zero state against the chunked
    forward (chunks of 16) over the same 64 inputs, within the
    reference's own 2e-3 (rtol and atol, tests/test_models.py)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as S

    xl, jb = get_config("xlstm-350m"), get_config("jamba-1.5-large-398b")
    for name, cfg, init, fwd, init_state, step, chunked in (
            ("mLSTM", xl, S.init_mlstm, S.mlstm_forward, S.mlstm_init_state,
             S.mlstm_decode_step, True),
            ("sLSTM", xl, S.init_slstm, S.slstm_forward, S.slstm_init_state,
             S.slstm_decode_step, False),
            ("Mamba", jb, S.init_mamba, S.mamba_forward, S.mamba_init_state,
             S.mamba_decode_step, True)):
        gen = torch.Generator(device=dev).manual_seed(23)
        p, _ = init(cfg, gen)
        x = torch.randn((2, REC_CELL_STEPS, cfg.d_model), generator=gen,
                        device=dev)
        kw = {"chunk": 16} if chunked else {}
        t0 = time.perf_counter()
        y_par = fwd(cfg, p, x, **kw)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        state = init_state(cfg, 2, device=dev)
        ys = []
        t0 = time.perf_counter()
        for t in range(REC_CELL_STEPS):
            y, state = step(cfg, p, x[:, t:t + 1], state)
            ys.append(y)
        y_seq = torch.cat(ys, 1)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        assert bool(torch.isfinite(y_par).all())
        torch.testing.assert_close(y_seq, y_par, rtol=REC_TOL, atol=REC_TOL,
                                   msg=f"{name}: decode != chunked forward")
        print(f"  {name} cell at {cfg.name}'s widths: {REC_CELL_STEPS} "
              f"tokens decoded == the chunked forward (chunks of 16), "
              f"max|d|={float((y_seq - y_par).abs().max()):.2e} of "
              f"{float(y_par.abs().max()):.2e} (tol {REC_TOL}); forward "
              f"{t_fwd * 1e3:.1f} ms wall, decode {t_dec * 1e3:.1f} ms")
        del p, x, y_par, y_seq, state


def held_greedy(logits, ref_logits, what):
    """Logits within E2E_TOL of the plain run's scale and greedy tokens
    equal wherever its top-2 margin exceeds twice the difference; returns
    the line to print."""
    import torch
    assert bool(torch.isfinite(logits).all()), f"{what}: non-finite"
    scale = float(ref_logits.abs().max())
    diff = float((logits - ref_logits).abs().max())
    assert diff <= E2E_TOL * scale, f"{what}: {diff} of {scale}"
    top2 = ref_logits.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * diff
    same = logits.argmax(-1) == ref_logits.argmax(-1)
    assert bool(same[clear].all()), f"{what}: tokens differ"
    return (f"logits max|d|={diff:.3e} of {scale:.3e}; greedy equal at "
            f"{int(same.sum())}/{same.numel()} ({int(clear.sum())} clear)")


def greedy_decode(model, params, cache, logits, start, steps, extra=None):
    """``steps`` greedy ``decode_step``s from ``logits`` at position
    ``start``; returns (tokens [B, steps], the last step's logits, the
    cache, the step call for timing)."""
    import torch
    toks = []
    b = logits.shape[0]
    for t in range(steps):
        tok = logits.argmax(-1)[:, None]
        toks.append(tok)
        batch = {"token": tok, "pos": torch.full(
            (b,), start + t, dtype=torch.int32, device=logits.device)}
        logits, cache = model.decode_step(params, cache, batch)
        assert bool(torch.isfinite(logits).all()), f"decode step {t}"
    return torch.cat(toks, 1), logits, cache, batch


def xlstm_path(dev):
    """Phase 18, xlstm-350m ``FULL``, whole (24 layers): the 4 x 1024
    forward; 64 tokens decoded from the zero state against the forward's
    logits over them; ``Trainer.fit`` for TRAIN_STEPS at 8 x 128, QAT 8
    and int8 error feedback; ``prefill`` then REC_NEW greedy steps."""
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import (MarkovLMConfig, MarkovLMDataset,
                                  ShardedLoader)
    from repro_torch.models.lm import tree_leaves, tree_map
    from repro_torch.models.xlstm_model import XLSTMModel
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = get_config("xlstm-350m")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = XLSTMModel(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(18))
    n_params = sum(x.numel() for x in tree_leaves(params))
    torch.cuda.synchronize()
    print(f"  {cfg.name} FULL: {cfg.n_layers} layers ({model.n_blocks} "
          f"super-blocks of {model.n_m} mLSTM + 1 sLSTM), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}: {n_params / 1e9:.3f} B parameters "
          f"({4 * n_params / 1e9:.2f} GB f32; reckoned "
          f"{cfg.param_count() / 1e9:.3f} B), built in "
          f"{time.perf_counter() - t0:.1f}s")
    b, s = XLSTM_FWD
    tokens = torch.as_tensor(MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=s, batch_size=b)).batch_at(0)[
            "tokens"], dtype=torch.long, device=dev)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    assert logits.shape == (b, s, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    # the recurrence token by token from the zero state against the
    # chunked forward over the same 64 tokens.  At random weights the
    # whole model amplifies float32 rounding with each position (the
    # mLSTM divides by its normalizer): a one-ulp change of its own
    # weights moves the forward's logits by ~1e-4 at the first position
    # and by ~0.2 of ~5 at the 57th (on the CPU, measured).  So the first
    # position, where no state has formed, is held at E2E_TOL; every
    # position's difference is printed beside that spread; the cells
    # above are held at 2e-3 position by position.
    cache = model.init_cache(b, 0, device=dev)
    dec = []
    for t in range(REC_CELL_STEPS):
        lg, cache = model.decode_step(params, cache,
                                      {"token": tokens[:, t:t + 1]})
        dec.append(lg)
    dec = torch.stack(dec, 1)
    fwd = logits[:, :REC_CELL_STEPS]
    assert bool(torch.isfinite(dec).all())
    held = held_greedy(dec[:, :1], fwd[:, :1],
                       f"{cfg.name} first decoded token vs forward")
    gen = torch.Generator(device=dev).manual_seed(5)
    nudged = tree_map(lambda w: w * (1 + 2.0 ** -23 * torch.randint(
        -1, 2, w.shape, generator=gen, device=dev).float()), params)
    moved = model.forward(nudged, {"tokens": tokens[:, :REC_CELL_STEPS]})[0]
    del nudged

    def envelope(d):
        return "/".join(f"{float(d[:, t].abs().max()):.2g}"
                        for t in range(0, REC_CELL_STEPS, 8))
    print(f"  {cfg.name} forward {b}x{s} ({s // 256} chunks of 256): "
          f"{statistics.median(walls):.1f} ms wall (median of 3); "
          f"{REC_CELL_STEPS} tokens decoded from the zero state: first "
          f"token vs the forward {held}; max|d| at positions 0, 8, ..., "
          f"56: decode vs forward {envelope(dec - fwd)}, the forward under "
          f"a one-ulp change of the weights {envelope(moved - fwd)} (of "
          f"{float(fwd.abs().max()):.2f})")
    del logits, dec, fwd, moved, cache

    # prefill (the reference's fresh zero-state cache) then greedy steps
    last, pcache = model.prefill(params, {"tokens": tokens[:, :64]})
    assert int(pcache["len"][0]) == 64 and not bool(pcache["mC"].any())
    toks, _, cache, step = greedy_decode(model, params, pcache, last, 64,
                                         REC_NEW)
    wall, dev_ms, launches = device_busy(
        lambda: model.decode_step(params, cache, step))
    print(f"  {cfg.name} prefill {b}x64 then {REC_NEW} greedy decode "
          f"steps: finite; one step {wall:.2f} ms wall, device "
          + (f"{dev_ms:.3f} ms" if dev_ms is not None else "not measured")
          + f", {launches} launches (eager)")

    # training
    tc = TrainConfig(qat_bits=8, grad_compression="int8_ef", log_every=1)
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 20, TRAIN_STEPS))
    tb, ts = XLSTM_TRAIN
    data = MarkovLMDataset(MarkovLMConfig(vocab_size=cfg.vocab_size,
                                          seq_len=ts, batch_size=tb))
    del params
    print(f"  {release_memory()}")
    tr = Trainer(model, opt, dev, tc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = tr.fit(ShardedLoader(data, device=dev), TRAIN_STEPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    assert [h["step"] for h in hist] == list(range(1, TRAIN_STEPS + 1))
    for h in hist:
        assert math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]), h
    step_ms = [1e3 / h["steps_per_s"] for h in hist]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {cfg.name} training B={tb} S={ts} qat_bits=8 int8_ef remat: "
          f"{TRAIN_STEPS} steps in {wall_s:.2f}s, loss {hist[0]['loss']:.4f}"
          f" -> {hist[-1]['loss']:.4f}, grad norm "
          f"{hist[0]['grad_norm']:.3f} -> {hist[-1]['grad_norm']:.3f}, all "
          f"finite; {step_ms[0]:.1f} ms first step, "
          f"{statistics.median(step_ms[1:]):.1f} ms per step after "
          f"(median); peak {peak:.2f} GiB (max_memory_allocated)")


def plain_attend_sliced(q, k, v, causal=True):
    """The flash kernel's plain version one (batch row, KV head) at a
    time, q [B, S, H, dh], k/v [B, T, KV, dh]: in one call its [.., bq,
    bk, dh] products at jamba's 64 heads of 128 over 512 positions take
    17 GB.  A row's values do not depend on the other rows or heads (its
    sums run over one axis), so the slices give the one call's values."""
    import torch
    from repro_torch.kernels import ref
    kv = k.shape[2]
    g = q.shape[2] // kv
    rows = []
    for i in range(q.shape[0]):
        heads = [ref.flash_attention_ref(
            q[i:i + 1, :, j * g:(j + 1) * g].transpose(1, 2),
            k[i:i + 1, :, j:j + 1].transpose(1, 2),
            v[i:i + 1, :, j:j + 1].transpose(1, 2),
            causal=causal).transpose(1, 2) for j in range(kv)]
        rows.append(torch.cat(heads, dim=2))
    return torch.cat(rows, dim=0)


def routed_hybrid(cfg, plain: bool, replay=None):
    """:func:`routed_model` of ``HybridLM``; ``plain`` attends through
    :func:`plain_attend_sliced`."""
    from repro_torch.models.hybrid import HybridLM
    return routed_model(HybridLM, "moe", cfg,
                        plain_attend_sliced if plain else None, replay)


def jamba_path(dev):
    """Phase 18, jamba-1.5-large-398b at one super-block (8 of 72 layers:
    7 Mamba, 1 attention, 4 MoE) and JAMBA_EXPERTS of 16 experts, top-2,
    published widths: the forward at each JAMBA_FWD shape through the
    flash kernel (one launch a forward, counted) against plain attention
    with the kernel run's expert choices replayed; ``prefill`` at 4 x 64
    then REC_NEW greedy steps.  Returns the counted flash launches."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.data import MarkovLMConfig, MarkovLMDataset
    from repro_torch.models.hybrid import HybridLM
    from repro_torch.models.lm import tree_leaves

    arch = "jamba-1.5-large-398b"
    experts = JAMBA_EXPERTS
    cfg, reduced = family_config(arch, 8, 8, experts)
    n_meta = sum(x.numel() for x in tree_leaves(
        HybridLM(cfg)._build(None, device="meta")))
    # what the allocator can hand out: the card's free memory and the
    # blocks it has reserved but not allocated
    free = torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved() \
        - torch.cuda.memory_allocated()
    if 4 * n_meta + JAMBA_HEADROOM > free:
        experts = 2
        cfg, reduced = family_config(arch, 8, 8, experts)
        reduced += (f" (cut to 2 experts: {4 * n_meta / 1e9:.1f} GB of "
                    f"weights at {JAMBA_EXPERTS} did not fit in "
                    f"{free / 1e9:.1f} GB free)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = routed_hybrid(cfg, plain=False)
    params = model.init(torch.Generator(device=dev).manual_seed(19))
    n_params = sum(x.numel() for x in tree_leaves(params))
    torch.cuda.synchronize()
    print(f"  {arch}: {reduced}; published widths: d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, Mamba "
          f"d_inner {cfg.d_model * cfg.mamba_expand} (heads of "
          f"{cfg.mamba_headdim}, state {cfg.mamba_d_state}), d_ff "
          f"{cfg.d_ff}, experts of {cfg.moe_d_ff}, vocab {cfg.vocab_size}: "
          f"{n_params / 1e9:.3f} B parameters ({4 * n_params / 1e9:.2f} GB "
          f"f32), built in {time.perf_counter() - t0:.1f}s")
    flash = 0
    for b, s in JAMBA_FWD:
        tokens = torch.as_tensor(MarkovLMDataset(MarkovLMConfig(
            vocab_size=cfg.vocab_size, seq_len=s, batch_size=b)).batch_at(
                1)["tokens"], dtype=torch.long, device=dev)
        model.log = []
        tk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, aux = model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = tk.launch_counts()
        want = dict.fromkeys(tk.KERNELS, 0)
        want["flash_attention_fwd"] = model.n_blocks
        assert counts == want, f"{cfg.name} forward launches {counts}"
        flash += counts["flash_attention_fwd"]
        assert len(model.log) == len(model.moe_slots) * model.n_blocks
        ref = routed_hybrid(cfg, plain=True, replay=model.log)
        ref_logits, ref_aux = ref.forward(params, {"tokens": tokens})
        what = f"{cfg.name} {b}x{s}"
        held = held_greedy(logits, ref_logits, what) + \
            f"; {near_ties(ref.flips, what)} token-layer expert choices " \
            f"of the plain run's own differed, each a near tie"
        assert bool(torch.isfinite(aux))
        print(f"  {cfg.name} forward {b}x{s}: {wall:.1f} ms wall (first "
              f"call), 1 flash launch (counted), aux {float(aux):.4f} "
              f"(plain {float(ref_aux):.4f}); vs plain attention: {held}")
        del logits, ref_logits, ref
    tokens = tokens.new_tensor(MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=64, batch_size=4)).batch_at(2)[
            "tokens"])
    last, cache = model.prefill(params, {"tokens": tokens})
    assert not bool(cache["ssm"].any()) and int(cache["len"][0]) == 64
    grown = model.init_cache(4, 64 + REC_NEW, device=dev)
    for k in ("k", "v"):
        grown[k][:, :, :64] = cache[k]
    toks, _, grown, step = greedy_decode(model, params, grown, last, 64,
                                         REC_NEW)
    wall, dev_ms, launches = device_busy(
        lambda: model.decode_step(params, grown, step))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {cfg.name} prefill 4x64 then {REC_NEW} greedy decode steps "
          f"(cache grown to {64 + REC_NEW}): finite; one step {wall:.2f} ms "
          f"wall, device "
          + (f"{dev_ms:.3f} ms" if dev_ms is not None else "not measured")
          + f", {launches} launches (eager); peak {peak:.2f} GiB "
          f"(max_memory_allocated)")
    del model, params, cache, grown
    return flash


class FramesDataset:
    """Seeded stub frame embeddings [B, S_enc, D] (standard normals) and
    Markov tokens and labels for the encoder-decoder, under the datasets'
    ``batch_at`` protocol."""

    def __init__(self, cfg, batch, frames, seq):
        from repro_torch.data import MarkovLMConfig, MarkovLMDataset
        self.d, self.b, self.frames = cfg.d_model, batch, frames
        self.lm = MarkovLMDataset(MarkovLMConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch))

    def batch_at(self, step):
        import numpy as np
        rng = np.random.default_rng(1000 + step)
        out = dict(self.lm.batch_at(step))
        out["embeds"] = rng.standard_normal(
            (self.b, self.frames, self.d)).astype(np.float32)
        return out


def seamless_path(dev):
    """Phase 18, seamless-m4t-large-v2 ``FULL``, whole (24 + 24 layers):
    the forward at SEAMLESS_FWD through the flash kernel (72 launches,
    counted) against plain attention; ``prefill`` then REC_NEW greedy
    steps; ``Trainer.fit`` for TRAIN_STEPS at SEAMLESS_TRAIN (flash
    launches counted).  Returns the counted flash launches."""
    import math

    import torch
    from repro_torch import kernels as tk
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader
    from repro_torch.models.encdec import EncDecModel
    from repro_torch.models.lm import tree_leaves
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import TrainConfig, Trainer

    class PlainEncDec(EncDecModel):
        def attend(self, q, k, v, causal):
            return plain_attend_sliced(q, k, v, causal)

    cfg = get_config("seamless-m4t-large-v2")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = EncDecModel(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(20))
    n_params = sum(x.numel() for x in tree_leaves(params))
    torch.cuda.synchronize()
    print(f"  {cfg.name} FULL: {cfg.n_enc_layers} + {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff} ({cfg.act}), vocab {cfg.vocab_size}: "
          f"{n_params / 1e9:.3f} B parameters ({4 * n_params / 1e9:.2f} GB "
          f"f32; reckoned {cfg.param_count() / 1e9:.3f} B), built in "
          f"{time.perf_counter() - t0:.1f}s")
    b, frames, s = SEAMLESS_FWD
    batch = {k: torch.as_tensor(v, device=dev) for k, v in FramesDataset(
        cfg, b, frames, s).batch_at(0).items() if k != "labels"}
    per_forward = cfg.n_enc_layers + 2 * cfg.n_layers
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = model.forward(params, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = tk.launch_counts()
    want = dict.fromkeys(tk.KERNELS, 0)
    want["flash_attention_fwd"] = per_forward
    assert counts == want, f"{cfg.name} forward launches {counts}"
    flash = counts["flash_attention_fwd"]
    assert logits.shape == (b, s, cfg.vocab_size)
    ref_logits, _ = PlainEncDec(cfg).forward(params, batch)
    held = held_greedy(logits, ref_logits, f"{cfg.name} forward")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.forward(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"  {cfg.name} forward {b}x({frames} frames, {s} tokens): "
          f"{statistics.median(walls):.1f} ms wall (median of 3; first "
          f"{wall:.1f}), {per_forward} flash launches (counted: "
          f"{cfg.n_enc_layers} encoder, {cfg.n_layers} causal self, "
          f"{cfg.n_layers} cross at S={s} over T={frames}); vs plain "
          f"attention: {held}")
    del logits, ref_logits
    n = min(64, s)
    pb = {"embeds": batch["embeds"], "tokens": batch["tokens"][:, :n]}
    last, cache = model.prefill(params, pb)
    grown = model.init_cache(b, 2 * (n + REC_NEW), device=dev)
    for k in ("k", "v"):
        grown[k][:, :, :n] = cache[k]
    grown.update(ek=cache["ek"], ev=cache["ev"], len=cache["len"])
    toks, _, grown, step = greedy_decode(model, params, grown, last, n,
                                         REC_NEW)
    wall, dev_ms, launches = device_busy(
        lambda: model.decode_step(params, grown, step))
    print(f"  {cfg.name} prefill {b}x({frames} frames, {n} tokens) then "
          f"{REC_NEW} greedy decode steps: finite; one step {wall:.2f} ms "
          f"wall, device "
          + (f"{dev_ms:.3f} ms" if dev_ms is not None else "not measured")
          + f", {launches} launches (eager)")
    del params, cache, grown, batch
    print(f"  {release_memory()}")

    tb, tf, ts = SEAMLESS_TRAIN
    tc = TrainConfig(log_every=1)
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 20, TRAIN_STEPS))
    tr = Trainer(model, opt, dev, tc)
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = tr.fit(ShardedLoader(FramesDataset(cfg, tb, tf, ts),
                                   device=dev), TRAIN_STEPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = tk.launch_counts()
    assert tc.remat
    want["flash_attention_fwd"] = 2 * per_forward * TRAIN_STEPS
    assert counts == want, f"{cfg.name} training launches {counts}"
    flash += counts["flash_attention_fwd"]
    for h in hist:
        assert math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]), h
    step_ms = [1e3 / h["steps_per_s"] for h in hist]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {cfg.name} training B={tb} ({tf} frames, {ts} tokens) remat: "
          f"{TRAIN_STEPS} steps in {wall_s:.2f}s, loss "
          f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, grad norm "
          f"{hist[0]['grad_norm']:.3f} -> {hist[-1]['grad_norm']:.3f}, all "
          f"finite; {step_ms[0]:.1f} ms first step, "
          f"{statistics.median(step_ms[1:]):.1f} ms per step after (median);"
          f" {2 * per_forward} flash launches a step (counted); peak "
          f"{peak:.2f} GiB (max_memory_allocated)")
    return flash


# ---------------------------------------------------------------------------
# phase 19: training over a mesh of ranks
# ---------------------------------------------------------------------------

MESH_AXES = ("pod", "data", "model")
MESH_STEPS = 3              # steps of each phase-19 run


def train_setup(cfg):
    """Phase 9's training: its config, optimizer and Markov data."""
    from repro_torch.data import MarkovLMConfig, MarkovLMDataset
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import TrainConfig
    tc = TrainConfig(qat_bits=8, grad_compression="int8_ef", log_every=1)
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 20, TRAIN_STEPS))
    data = MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH))
    return tc, opt, data


def fingerprint(t) -> int:
    """An exact fingerprint of a tensor's bits, on its device: the int64
    (wrapping) sum of its 32-bit words, each weighted by (its index mod
    65521) + 1.  Any one changed bit changes it.  Summed in slices of
    2^26 words (wrapping sums of slices wrap to the same total), so a
    leaf of several GB needs no int64 copy of itself."""
    import torch
    w = t.detach().contiguous().view(-1).view(torch.int32)
    total, step = 0, 1 << 26
    for lo in range(0, w.numel(), step):
        part = w[lo:lo + step].to(torch.int64)
        idx = torch.arange(lo, lo + part.numel(), device=w.device) \
            % 65521 + 1
        total += int((part * idx).sum())
    return (total + 2 ** 63) % 2 ** 64 - 2 ** 63


def state_prints(params, opt_state, errs):
    """Fingerprints of a training state's leaves (DTensors gathered):
    params, m, v, the step and each residual tree in ``errs``."""
    from repro_torch.models.lm import tree_leaves
    from repro_torch.parallel.sharding import gather
    trees = [params, opt_state.m, opt_state.v, *errs]
    return {"state": [fingerprint(gather(x)) for tree in trees[:3]
                      for x in tree_leaves(tree)] + [int(opt_state.step)],
            "err": [[fingerprint(gather(x)) for x in tree_leaves(e)]
                    for e in trees[3:]]}


def stepwise(tr, loader, state, steps):
    """``Trainer.fit`` a step at a time, synchronized: (state, losses,
    grad norms, walls ms, peak GiB)."""
    import torch
    losses, norms, walls = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = tr.fit(loader, 1, state=state)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(hist[-1]["loss"])
        norms.append(hist[-1]["grad_norm"])
    return state, losses, norms, walls, \
        torch.cuda.max_memory_allocated() / 2 ** 30


class StepClock:
    """Synchronized wall ms and calls of the functions a mesh training
    step reaches, by name: each wrapped call waits for the card before
    and after itself, so its time holds its own work and nothing queued
    before it.  ``exchange`` (``compress_tree``) holds the all-gathers.
    Used for one step after the checked ones (the waits slow it)."""

    SECTIONS = (("torch.distributed", "all_gather", "all_gather"),
                ("torch.distributed", "all_reduce", "all_reduce"),
                ("repro_torch.runtime.train_loop", "gather", "gather"),
                ("repro_torch.runtime.train_loop", "compress_tree",
                 "exchange"))

    def __init__(self, tr):
        import importlib
        self.ms, self.calls, self._undo = {}, {}, []
        for module, attr, name in self.SECTIONS:
            self._wrap(importlib.import_module(module), attr, name)
        self._wrap(type(tr.opt), "update", "adamw")   # a frozen dataclass

    def _wrap(self, owner, attr, name):
        import torch
        fn = getattr(owner, attr)
        self.ms[name], self.calls[name] = 0.0, 0

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.ms[name] += (time.perf_counter() - t0) * 1e3
                self.calls[name] += 1
        self._undo.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def close(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)

    def step(self, tr, loader, state):
        """One clocked ``Trainer.fit`` step: (state, its wall ms, a line
        of its sections)."""
        import torch
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = tr.fit(loader, 1, state=state)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            self.close()
        parts = "; ".join(f"{k} {self.calls[k]} calls {self.ms[k]:.1f} ms"
                          for k in self.ms)
        return state, wall, f"clocked step {wall:.1f} ms: {parts}"


def mesh_one_rank(cfg, dev):
    """Phase 19 (a): a one-rank NCCL group and a (pod 1, data 1, model 1)
    mesh.  Phase 9's plain step and the pod-wise step (its int8
    all-gather over one rank: sum s q / 1 is q s exactly) from one state
    for MESH_STEPS steps: params, m, v, residual and losses bitwise.
    Returns the pod-wise run's flash launches."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels as tk
    from repro_torch.data import ShardedLoader
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.models.lm import DecoderLM, tree_leaves
    from repro_torch.parallel.sharding import gather
    from repro_torch.runtime import Trainer

    tc, opt, data = train_setup(cfg)
    init_ranks(dev)
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    try:
        mesh = make_mesh((1, 1, 1), MESH_AXES, device=dev)
        plain = Trainer(DecoderLM(cfg), opt, dev, tc)
        state0 = plain.init_state(0)
        ploader = ShardedLoader(data, device=dev)
        want, wl, wn, pwalls, ppeak = stepwise(plain, ploader, state0,
                                               MESH_STEPS)
        podwise = Trainer(DecoderLM(cfg), opt, mesh=mesh, train_cfg=tc)
        assert podwise.podwise and podwise.device.type == "cuda"
        state = podwise.place_state(*state0)
        tk.reset_launch_counts()
        loader = ShardedLoader(data, device=dev, mesh=mesh)
        got, gl, gn, walls, peak = stepwise(podwise, loader, state,
                                            MESH_STEPS)
        torch.cuda.synchronize()
        counts = tk.launch_counts()
        per_step = 2 * cfg.n_layers       # forward + recompute
        assert counts == {"group_quantize": 0, "qmm": 0, "qmm_int4": 0,
                          "quantized_decode_attention": 0,
                          "flash_attention_fwd": per_step * MESH_STEPS,
                          "row_gemm": 0, "tc_gemm": 0}, \
            f"mesh training launches {counts}"
        assert gl == wl, f"pod-wise losses {gl} != plain {wl}"
        assert gn == wn, f"pod-wise grad norms {gn} != plain {wn}"

        def leaves(state):
            p, o, e = state
            return [gather(x) for t in (p, o.m, o.v, e)
                    for x in tree_leaves(t)] + [o.step]
        bad = sum(not torch.equal(a, b)
                  for a, b in zip(leaves(got), leaves(want)))
        assert bad == 0, f"{bad} leaves of the pod-wise state != plain"
        # one more step of each, clocked: where the pod-wise step's time
        # over the plain step's goes
        _, _, plain_clock = StepClock(plain).step(plain, ploader, want)
        _, _, pod_clock = StepClock(podwise).step(podwise, loader, got)
    finally:
        dist.destroy_process_group()
    print(f"  (a) one NCCL rank, mesh (pod 1, data 1, model 1), "
          f"{cfg.name} B={TRAIN_BATCH} S={TRAIN_SEQ} QAT 8 int8_ef: "
          f"{MESH_STEPS} pod-wise steps == the plain step bitwise (params, "
          f"m, v, residual, step; losses {[f'{x:.6f}' for x in gl]}); "
          f"walls pod-wise {[f'{w:.1f}' for w in walls]} ms, plain "
          f"{[f'{w:.1f}' for w in pwalls]} ms; peak {peak:.2f} GiB "
          f"(plain {ppeak:.2f}); flash launches "
          f"{counts['flash_attention_fwd']} ({per_step} a step); "
          f"{card_line()}")
    print(f"      plain {plain_clock}")
    print(f"      pod-wise {pod_clock}")
    return counts["flash_attention_fwd"]


def pod_rank_main(rank, world, store, out_dir):
    """Phase 19 (b), one rank (a spawned process): pod ``rank`` of a
    (pod 2, data 1, model 1) mesh over gloo, on the one card: MESH_STEPS
    steps of ``Trainer.fit`` on its half of the batch; writes per-step
    fingerprints, losses, walls and peak memory as JSON."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels as tk
    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.data import ShardedLoader
    from repro_torch.device import set_float32_numerics
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import Trainer

    set_float32_numerics()
    dev = init_ranks("cuda:0", backend="gloo", store_file=store, rank=rank,
                     world_size=world)
    mesh = make_mesh((world, 1, 1), MESH_AXES, device=dev)
    tc, opt, data = train_setup(FULL)
    tr = Trainer(DecoderLM(FULL), opt, mesh=mesh, train_cfg=tc)
    state = tr.init_state(0)
    loader = ShardedLoader(data, device=dev, mesh=mesh)
    out = {"rank": rank, "steps": [], "walls": []}
    tk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = tr.fit(loader, 1, state=state)
        torch.cuda.synchronize()
        out["walls"].append((time.perf_counter() - t0) * 1e3)
        out["steps"].append(dict(loss=hist[-1]["loss"],
                                 grad_norm=hist[-1]["grad_norm"],
                                 **state_prints(state[0], state[1],
                                                [state[2]])))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["launches"] = tk.launch_counts()
    out["backend"] = dist.get_backend()
    _, _, out["clock"] = StepClock(tr).step(tr, loader, state)
    with open(pathlib.Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def pods_in_one_process(cfg, dev, pods):
    """The (pod ``pods``, data 1, model 1) step in this one process
    through the same functions (``Trainer._loss_fn``,
    ``quantize_with_feedback``, ``pod_mean``, ``AdamW.update``), the
    all-gather replaced by stacking the pods' codes and scales: per step
    the fingerprints of params, m, v and each pod's residual, the loss
    and the grad norm."""
    import numpy as np
    import torch
    from repro_torch.models.lm import DecoderLM, tree_map
    from repro_torch.optim import global_norm, init_error_state
    from repro_torch.optim.grad_compress import (pod_mean,
                                                 quantize_with_feedback)
    from repro_torch.runtime import Trainer

    tc, opt, data = train_setup(cfg)
    tr = Trainer(DecoderLM(cfg), opt, dev, tc)
    params, ostate, _ = tr.init_state(0)
    errs = [init_error_state(params) for _ in range(pods)]
    rows = TRAIN_BATCH // pods
    steps = []
    for step in range(MESH_STEPS):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in data.batch_at(step).items()}
        grads, losses = [], []
        for p in range(pods):
            leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
            loss = tr._loss_fn(leaves, {k: v[p * rows:(p + 1) * rows]
                                        for k, v in batch.items()})
            loss.backward()
            grads.append(tree_map(lambda t: t.grad, leaves))
            losses.append(loss.detach())

        def exchange(*pairs):
            out = [quantize_with_feedback(g, e) for g, e in pairs]
            g_hat = pod_mean(torch.stack([q for q, _, _ in out]),
                             torch.stack([s.reshape(1) for _, s, _ in out]
                                         ).reshape(-1))
            return g_hat, [e for _, _, e in out]

        def walk(gs, es):
            if isinstance(gs[0], dict):
                res = {k: walk([g[k] for g in gs], [e[k] for e in es])
                       for k in gs[0]}
                return ({k: r[0] for k, r in res.items()},
                        [{k: r[1][p] for k, r in res.items()}
                         for p in range(pods)])
            return exchange(*zip(gs, es))

        g_hat, errs = walk(grads, errs)
        loss = sum(losses[1:], losses[0]) * float(
            np.float32(1.0) / np.float32(pods))
        params, ostate, metrics = tr.opt.update(
            g_hat, ostate, params, grad_norm=global_norm(g_hat))
        steps.append(dict(loss=float(loss),
                          grad_norm=float(metrics["grad_norm"]),
                          **state_prints(params, ostate, errs)))
    return steps


def mesh_two_ranks(cfg, dev):
    """Phase 19 (b): two ranks on the one card as (pod 2, data 1, model
    1) over gloo (NCCL takes one rank a GPU), spawned; their losses and
    state fingerprints held bitwise against the same two pods stepped in
    this process, the params equal on both ranks after every step.
    Returns the ranks' flash launches and a line of rank 0's walls, peak
    and clocked step."""
    import multiprocessing as mp
    import shutil

    out_dir = ROOT / "build" / "phase19"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    store = str(out_dir / "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=pod_rank_main,
                         args=(r, 2, store, str(out_dir)))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0, 0], f"phase 19 ranks exited {codes}"
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(2)]
    want = pods_in_one_process(cfg, dev, 2)
    for r in ranks:
        assert r["backend"] == "gloo", r["backend"]
        for s, (got, ref) in enumerate(zip(r["steps"], want)):
            assert got["state"] == ranks[0]["steps"][s]["state"], \
                f"step {s + 1}: rank {r['rank']}'s state != rank 0's"
            assert got["state"] == ref["state"], \
                f"step {s + 1}: rank {r['rank']}'s state != one process's"
            assert got["err"][0] == ref["err"][r["rank"]], \
                f"step {s + 1}: pod {r['rank']}'s residual != one process's"
            assert got["loss"] == ref["loss"] and \
                got["grad_norm"] == ref["grad_norm"], (s, got["loss"],
                                                       ref["loss"])
    assert ranks[0]["steps"][-1]["err"] != ranks[1]["steps"][-1]["err"]
    per_step = 2 * cfg.n_layers
    flash = 0
    for r in ranks:
        n = r["launches"]["flash_attention_fwd"]
        assert n == per_step * MESH_STEPS, r["launches"]
        flash += n
    print(f"  (b) two gloo ranks on one card, mesh (pod 2, data 1, model "
          f"1), {TRAIN_BATCH // 2} rows a pod: {MESH_STEPS} steps == the "
          f"two pods stepped in one process bitwise (params, m, v, each "
          f"pod's residual, losses "
          f"{[round(s['loss'], 6) for s in want]}, grad norms), params "
          f"equal on both ranks after every step, the residuals differ; "
          f"walls rank 0 {[f'{w:.1f}' for w in ranks[0]['walls']]} ms, "
          f"rank 1 {[f'{w:.1f}' for w in ranks[1]['walls']]} ms; peak "
          f"{ranks[0]['peak_gib']:.2f} / {ranks[1]['peak_gib']:.2f} GiB a "
          f"rank; flash launches {flash}; {ranks_s:.1f}s with start-up; "
          f"{card_line()}")
    for r in ranks:
        print(f"      rank {r['rank']} {r['clock']}")
    r = ranks[0]
    return flash, (f"rank 0 walls {[f'{w:.1f}' for w in r['walls']]} ms, "
                   f"peak {r['peak_gib']:.2f} GiB, {r['clock']}")



# ---------------------------------------------------------------------------
# phase 20: the serving examples and the int8-resident forward
# ---------------------------------------------------------------------------

def examples_path(dev):
    """Phase 20 (a): every serving example's ``main([])`` on the card, one
    counted window each; returns the launches summed over the calls."""
    import contextlib
    import importlib.util
    import io

    import torch
    from repro_torch import kernels as tk
    total = {}
    for name, argv, want in EXAMPLE_RUNS:
        path = ROOT / "examples" / f"torch_{name}.py"
        spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        print(f"  {release_memory()}")
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            mod.main(list(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = tk.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        what = " ".join([name] + list(argv))
        for line in out.getvalue().splitlines():
            if line.strip():
                print(f"    | {line}")
        print(f"  example {what}: wall {wall:.2f} s, peak {peak:.1f} MiB, "
              f"launches {counts}")
        for k in want:
            assert counts.get(k, 0) > 0, f"{what}: {k} never launched"
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return total


def resident_forward(cfg, dev, seed):
    """Phase 20 (b) for one config: ``quantize_tree_stacked`` on the card
    against a CPU copy, and the 4 x 64 forward over each quantized tree
    against the forward over its dequantized leaves; returns the flash
    launches of the quantized forwards."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.quantization import (QuantConfig, QuantizedTensor,
                                               QuantPlan,
                                               quantize_tree_stacked)
    from repro_torch.models.lm import DecoderLM, tree_leaves, tree_map

    def dequantized(tree):
        return tree_map(lambda a: a.dequantize()
                        if isinstance(a, QuantizedTensor) else a, tree)

    torch.cuda.reset_peak_memory_stats()
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    # the CPU copy holds the first RESIDENT_HOST_LAYERS layers of every
    # stacked leaf (a full cycle of the mixed plan: the stacks' widest
    # bits are the whole model's): the host's quantize is the phase's
    # cost, and each layer is quantized on its own
    host = tree_map(lambda a: (a[:RESIDENT_HOST_LAYERS] if a.ndim >= 3
                               else a).cpu(), params)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.
                           Generator().manual_seed(seed)).to(dev)
    with torch.no_grad():
        clean = model.forward(params, {"tokens": tokens})[0]
    plans = (
        ("int8 per-channel", QuantConfig(bits=8)),
        ("mixed " + "/".join(map(str, RESIDENT_MIXED)),
         QuantPlan.from_layer_bits(
             [RESIDENT_MIXED[i % len(RESIDENT_MIXED)]
              for i in range(cfg.n_layers)], default_bits=8)),
        ("12-bit per-channel (int16)", QuantConfig(bits=12)))
    flash = 0
    for what, qcfg in plans:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qt = quantize_tree_stacked(params, qcfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        qh = quantize_tree_stacked(host, qcfg)
        host_wall = time.perf_counter() - t0
        n_q = 0
        q_bytes = f_bytes = 0
        for a, h in zip(tree_leaves(qt), tree_leaves(qh)):
            if isinstance(a, QuantizedTensor):
                assert isinstance(h, QuantizedTensor) and a.bits == h.bits
                assert a.codes.dtype == h.codes.dtype, what
                n = h.codes.shape[0]
                assert torch.equal(a.codes[:n].cpu(), h.codes), \
                    f"{cfg.name} {what}: codes differ from the CPU's"
                assert torch.equal(a.scale[:n].cpu(), h.scale), \
                    f"{cfg.name} {what}: scales differ from the CPU's"
                n_q += 1
                q_bytes += a.nbytes_effective()
                f_bytes += a.codes.numel() * 4
        del qh
        tk.reset_launch_counts()
        with torch.no_grad():
            got = model.forward(qt, {"tokens": tokens})[0]
        torch.cuda.synchronize()
        n_flash = tk.launch_counts()["flash_attention_fwd"]
        assert n_flash == cfg.n_layers, (what, n_flash)
        flash += n_flash
        with torch.no_grad():
            deq = model.forward(dequantized(qt), {"tokens": tokens})[0]
        assert torch.isfinite(got).all(), what
        assert torch.equal(got, deq), \
            f"{cfg.name} {what}: int8-resident forward != dequantized tree's"
        delta = float((got - clean).abs().max())
        print(f"  {cfg.name} {what}: {n_q} leaves quantized, codes and "
              f"scales == CPU bitwise; forward == dequantized tree "
              f"bitwise, {n_flash} flash launches; max|d logits| vs float "
              f"{delta:.4e} (max|logits| {float(clean.abs().max()):.3f}); "
              f"{q_bytes / 2 ** 30:.3f} GiB effective vs "
              f"{f_bytes / 2 ** 30:.3f} GiB float ({q_bytes / f_bytes:.3f}"
              f"x); quantize wall {wall * 1e3:.1f} ms on the card, "
              f"{host_wall:.2f} s on the host")
        del qt, got, deq
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {cfg.name}: peak {peak:.2f} GiB")
    return flash


def int8_resident_path(dev):
    """Phase 20 (b): qwen2-0.5b and stablelm-3b ``FULL``, one at a time."""
    from repro_torch.configs.qwen2_0_5b import FULL as QWEN
    from repro_torch.configs.stablelm_3b import FULL as STABLELM
    flash = 0
    for seed, cfg in enumerate((QWEN, STABLELM)):
        print(f"  {release_memory()}")
        flash += resident_forward(cfg, dev, seed)
    return flash


# ---------------------------------------------------------------------------
# phase 21: tensor-parallel compute over model, MoE over data-parallel ranks
# ---------------------------------------------------------------------------

TP_STEPS = 3                # steps of phase 21 (a)
MOE_BATCH, MOE_SEQ, MOE_STEPS = 4, 128, 1    # phase 21 (b)
PARAM_FLIP_SHARE = 1e-3     # phase 9's: elements beyond 1e-3 lr


def moe_config():
    """Phase 21 (b)'s config: qwen3-moe-235b-a22b at its published widths,
    1 layer and 16 of its 128 experts (top-8 kept)."""
    return family_config("qwen3-moe-235b-a22b", 1, 1, 16)


class Collectives:
    """Counts of ``torch.distributed.all_reduce`` and ``all_gather`` calls
    (every collective of a training step goes through one of them)."""

    NAMES = ("all_reduce", "all_gather")

    def __init__(self):
        import torch.distributed as dist
        self.calls = dict.fromkeys(self.NAMES, 0)
        self._undo = []
        for name in self.NAMES:
            fn = getattr(dist, name)

            def counted(*args, _fn=fn, _name=name, **kwargs):
                self.calls[_name] += 1
                return _fn(*args, **kwargs)
            self._undo.append((name, fn))
            setattr(dist, name, counted)

    def take(self):
        out = dict(self.calls)
        self.calls = dict.fromkeys(self.NAMES, 0)
        return out

    def close(self):
        import torch.distributed as dist
        for name, fn in self._undo:
            setattr(dist, name, fn)


def state_bytes(cfg) -> int:
    """Bytes of one whole parameter tree of ``cfg`` (float32)."""
    import math
    from repro_torch.models.lm import DecoderLM, tree_leaves
    return 4 * sum(math.prod(t.shape)
                   for t in tree_leaves(DecoderLM(cfg).param_structs()))


def ranked_fit(rank, world, store, out_dir, what):
    """Phase 21, one rank (a spawned process): ``what`` is "tp" ((a):
    qwen2-0.5b ``FULL`` over (data 1, model 2), phase 9's training) or
    "moe" ((b): ``moe_config()`` over (data 2, model 1), plain AdamW);
    phase 23's (``tpf_setup``): an arch of TPF_SERVE ((b): its serving
    first, ``serve_on_ranks``, rank 0 saving the logits) or "hybrid-dp"
    ((c)).
    Steps ``Trainer.fit`` a step at a time; writes per step the loss,
    grad norm, wall, the collectives and every param's bit fingerprint,
    its peak memory, launches and the local shapes of its model-sharded
    leaves as JSON; rank 0 saves its final params (gathered) for the
    parent process to hold against one rank's fit."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels as tk
    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.data import ShardedLoader
    from repro_torch.device import set_float32_numerics
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.models.lm import tree_leaves
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.sharding import activation_sharding, gather
    from repro_torch.runtime import Trainer

    set_float32_numerics()
    dev = init_ranks("cuda:0", backend="gloo", store_file=store, rank=rank,
                     world_size=world)
    rules, spec = None, None
    if what in ("tp", "notp"):
        cfg, mesh = FULL, make_mesh((1, world), ("data", "model"),
                                    device=dev)
        tc, opt, data = train_setup(cfg)
        if what == "notp":      # phase 24 (b): the sequence split
            rules, spec = notp_rules(cfg), (("data",), "model")
    elif what == "moe":
        cfg, _ = moe_config()
        mesh = make_mesh((world, 1), ("data", "model"), device=dev)
        tc, opt, data = moe_setup(cfg)
    else:
        cfg, shape, tc, opt, data = tpf_setup(what)
        mesh = make_mesh(shape, ("data", "model"), device=dev)
    tr = Trainer(build_model(cfg), opt, mesh=mesh, train_cfg=tc,
                 rules=rules)
    state = tr.init_state(0)
    out = {"rank": rank, "steps": [], "backend": dist.get_backend(),
           "plan": None if tr.tp is None else {
               k: getattr(tr.tp, k) for k in ("size", "rank", "attn", "mlp",
                                              "vocab", "experts")},
           "flags": None if tr.tp is None else {
               k: getattr(tr.tp, k) for k in TPF_FLAGS},
           "dp": None if tr.dp is None else [tr.dp.size, tr.dp.index],
           "halves": []}
    if what in TPF_SERVE:
        logits, out["serve_flash"], out["serve_walls"], \
            out["serve_calls"] = serve_on_ranks(tr, state, out_dir)
        if rank == 0:
            torch.save({"logits": logits},
                       pathlib.Path(out_dir) / "serve.pt")
    if tr._local is not None:
        for p, d in zip(tree_leaves(state[0]), tree_leaves(tr._local)):
            if d is not None:
                out["halves"].append([list(p.to_local().shape),
                                      list(p.shape), d])
    loader = ShardedLoader(data, device=dev, mesh=mesh)
    tk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    calls = Collectives()
    steps = {"tp": TP_STEPS, "notp": NOTP_STEPS, "moe": MOE_STEPS,
             "hybrid-dp": HDP_STEPS}.get(what, TPF_STEPS)
    save_at = TPF_HELD.get(what, steps)
    try:
        with activation_sharding(spec):
            for step in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, hist = tr.fit(loader, 1, state=state)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                step_calls = calls.take()
                prints = [fingerprint(gather(x))
                          for x in tree_leaves(state[0])]
                out["steps"].append(dict(
                    wall=wall, loss=hist[-1]["loss"],
                    grad_norm=hist[-1]["grad_norm"], lr=hist[-1]["lr"],
                    calls=step_calls, params=prints))
                if step + 1 == save_at:
                    # the params the parent holds (a collective)
                    final = [gather(x).cpu()
                             for x in tree_leaves(state[0])]
                    if rank == 0:
                        torch.save(final,
                                   pathlib.Path(out_dir) / "params.pt")
                    del final
                calls.take()            # the fingerprints' gathers
    finally:
        calls.close()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["launches"] = tk.launch_counts()
    with open(pathlib.Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def moe_setup(cfg):
    """Phase 21 (b)'s training: plain AdamW on the linear schedule, Markov
    data at MOE_BATCH x MOE_SEQ."""
    from repro_torch.data import MarkovLMConfig, MarkovLMDataset
    from repro_torch.optim import AdamW, linear_schedule
    from repro_torch.runtime import TrainConfig
    return (TrainConfig(log_every=1),
            AdamW(learning_rate=linear_schedule(3e-4, 2, 20)),
            MarkovLMDataset(MarkovLMConfig(vocab_size=cfg.vocab_size,
                                           seq_len=MOE_SEQ,
                                           batch_size=MOE_BATCH)))


def spawn_ranks(what, world, timeout=900, target=None, tag="phase21"):
    """Start ``world`` ranks of ``target`` (:func:`ranked_fit`) on the
    card, wait for them; a failed rank fails the phase.  Returns (their
    JSONs, the wall with start-up, the output directory
    ``build/<tag><what>``, which keeps what the parent put there)."""
    import multiprocessing as mp

    target = ranked_fit if target is None else target
    out_dir = ROOT / "build" / f"{tag}{what}"
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    store = out_dir / "store"
    if store.exists():
        store.unlink()
    procs = [ctx.Process(target=target, args=(r, world, str(store),
                                              str(out_dir), what))
             for r in range(world)]
    t0 = time.perf_counter()
    # the ranks share the card: segments that grow in place keep each
    # rank's cached-but-free blocks from holding the other's headroom
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        for p in procs:
            p.start()
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    for p in procs:
        p.join(timeout=timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"{tag} ({what}) ranks exited {codes}"
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(world)]
    for r in ranks:
        assert r["backend"] == "gloo", r["backend"]
    return ranks, time.perf_counter() - t0, out_dir


def hold_ranked_fit(ranks, out_dir, tr, loader, steps):
    """The ranks' fit against one rank's fit from the same seed on the
    global batch: params bitwise equal across the ranks after every
    step; each step's loss within 1e-4 relative and grad norm within 1e-3;
    at most PARAM_FLIP_SHARE of the final params beyond 1e-3 lr.
    Returns (a line of the comparison, the reference's step walls)."""
    import torch
    from repro_torch.models.lm import tree_leaves
    for s in range(steps):
        for r in ranks[1:]:
            assert r["steps"][s]["params"] == ranks[0]["steps"][s]["params"], \
                f"step {s + 1}: rank {r['rank']}'s params != rank 0's"
    state, losses, norms, walls, _ = stepwise(tr, loader, tr.init_state(0),
                                              steps)
    got = [st["loss"] for st in ranks[0]["steps"]]
    gnorm = [st["grad_norm"] for st in ranks[0]["steps"]]
    for s, (a, b) in enumerate(zip(got, losses)):
        assert abs(a - b) <= 1e-4 * abs(b), f"step {s + 1} loss {a} vs {b}"
    for s, (a, b) in enumerate(zip(gnorm, norms)):
        assert abs(a - b) <= 1e-3 * b, f"step {s + 1} grad norm {a} vs {b}"
    lr = ranks[0]["steps"][-1]["lr"]
    mine = torch.load(out_dir / "params.pt")
    worst, moved, n = 0.0, 0, 0
    for a, b in zip(mine, tree_leaves(state[0])):
        d = (a.to(b.device) - b).abs()
        worst = max(worst, float(d.max()))
        moved += int((d > 1e-3 * lr).sum())
        n += d.numel()
    del state
    assert moved <= PARAM_FLIP_SHARE * n, f"{moved} of {n} params differ"
    return (f"losses {[f'{x:.6f}' for x in got]} vs one rank "
            f"{[f'{x:.6f}' for x in losses]}, grad norms "
            f"{[f'{x:.5f}' for x in gnorm]} vs {[f'{x:.5f}' for x in norms]};"
            f" params max|d| {worst:.3e}, {moved} of {n} beyond 1e-3 lr "
            f"(lr {lr:.3e})"), walls


def rank_lines(ranks, gathered=None):
    """Per rank: step walls, peak, collectives a step (and phase 19 (b)'s
    gathered run beside them)."""
    lines = []
    for r in ranks:
        calls = r["steps"][-1]["calls"]
        lines.append(
            f"      rank {r['rank']}: walls "
            f"{[f'{st['wall']:.1f}' for st in r['steps']]} ms; peak "
            f"{r['peak_gib']:.2f} GiB; a step {calls['all_reduce']} "
            f"all-reduces, {calls['all_gather']} all-gathers")
    if gathered is not None:
        lines.append(f"      beside phase 19 (b)'s gathered run "
                     f"(pod 2, data 1, model 1): {gathered}")
    return lines


def tensor_parallel_path(cfg, dev, gathered):
    """Phase 21 (a); returns the ranks' flash launches."""
    import torch
    from repro_torch.data import ShardedLoader
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import Trainer

    whole = state_bytes(cfg)
    print(f"  (a) reckoned: {cfg.name} params {whole / 2 ** 30:.2f} GiB "
          f"whole; a rank holds ~half of params, m, v and the residual "
          f"(~{2 * whole / 2 ** 30:.2f} GiB) and gathers nothing over "
          f"model; one rank's plain step after the ranks exit holds "
          f"~{4 * whole / 2 ** 30:.2f} GiB of state")
    ranks, wall, out_dir = spawn_ranks("tp", 2)
    for r in ranks:
        assert r["plan"] == dict(size=2, rank=r["rank"], attn=True,
                                 mlp=True, vocab=True, experts=False), r
        assert r["halves"] and all(
            2 * loc[d] == full[d] and loc[:d] + loc[d + 1:]
            == full[:d] + full[d + 1:] for loc, full, d in r["halves"]), \
            r["halves"]
    tc, opt, data = train_setup(cfg)
    line, ref_walls = hold_ranked_fit(
        ranks, out_dir, Trainer(DecoderLM(cfg), opt, dev, tc),
        ShardedLoader(data, device=dev), TP_STEPS)
    per_step = 2 * cfg.n_layers
    flash = 0
    for r in ranks:
        n = r["launches"]["flash_attention_fwd"]
        assert n == per_step * TP_STEPS, r["launches"]
        flash += n
    print(f"  (a) two gloo ranks on one card, mesh (data 1, model 2), "
          f"{cfg.name} B={TRAIN_BATCH} S={TRAIN_SEQ} QAT 8 int8_ef, "
          f"{TP_STEPS} steps: {len(ranks[0]['halves'])} leaves computed on "
          f"their half, params bitwise equal on both ranks after every "
          f"step; {line}; one rank's walls "
          f"{[f'{w:.1f}' for w in ref_walls]} ms; flash launches {flash}; "
          f"{wall:.1f}s with start-up; {card_line()}")
    for line in rank_lines(ranks, gathered):
        print(line)
    (out_dir / "params.pt").unlink()
    torch.cuda.empty_cache()
    return flash


def moe_parallel_path(dev):
    """Phase 21 (b); returns the ranks' flash launches."""
    import torch
    from repro_torch.data import ShardedLoader
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import Trainer

    cfg, reduced = moe_config()
    whole = state_bytes(cfg) / 2 ** 30
    held = 3 * whole / (2 if cfg.fsdp else 1)    # p, m, v (fsdp: halves)
    rank = 2 * held + 2 * whole    # + AdamW's new state, params, grads
    print(f"  (b) {reduced}; reckoned: params {whole:.2f} GiB; a rank "
          f"holds params, m, v {'halved over data (fsdp)' if cfg.fsdp else 'whole'}"
          f" ({held:.2f} GiB) and in a step the gathered params, their "
          f"gradients and AdamW's new state: ~{rank:.2f} GiB, two ranks "
          f"~{2 * rank:.2f} GiB; the one-rank fit after them "
          f"~{5 * whole:.2f} GiB")
    ranks, wall, out_dir = spawn_ranks("moe", 2)
    for r in ranks:
        assert r["dp"] == [2, r["rank"]] and r["plan"] is None, r
    tc, opt, data = moe_setup(cfg)
    tokens = MOE_BATCH * MOE_SEQ
    assert tokens <= 1024 and tokens % 2 == 0   # one group over both ranks
    line, ref_walls = hold_ranked_fit(
        ranks, out_dir, Trainer(DecoderLM(cfg), opt, dev, tc),
        ShardedLoader(data, device=dev), MOE_STEPS)
    per_step = 2 * cfg.n_layers
    flash = 0
    for r in ranks:
        n = r["launches"]["flash_attention_fwd"]
        assert n == per_step * MOE_STEPS, r["launches"]
        flash += n
    print(f"  (b) two gloo ranks on one card, mesh (data 2, model 1), "
          f"{cfg.name} 1 layer, 16 experts top-8, B={MOE_BATCH} "
          f"S={MOE_SEQ} ({tokens} tokens: one capacity group over both "
          f"ranks), {MOE_STEPS} steps: params bitwise equal on both ranks; "
          f"{line}; one rank's walls {[f'{w:.1f}' for w in ref_walls]} ms;"
          f" flash launches {flash}; {wall:.1f}s with start-up; "
          f"{card_line()}")
    for line in rank_lines(ranks):
        print(line)
    (out_dir / "params.pt").unlink()
    torch.cuda.empty_cache()
    return flash


# ---------------------------------------------------------------------------
# phase 23: tensor-parallel compute over model for the hybrid, xLSTM and
# encoder-decoder families, and the hybrid's MoE over data-parallel ranks
# ---------------------------------------------------------------------------

TPF_PROMPT = (2, 512)          # (a) jamba's prefill, B x S: two Mamba chunks
TPF_NEW = 16                   # (a) decode steps after it
TPF_SERVE = {"xlstm-350m": (2, 256, None),        # (b) B, tokens, frames
             "seamless-m4t-large-v2": (2, 128, 256)}
TPF_SERVE_NEW = 8              # (b) decode steps after the prefill
TPF_TRAIN = {"xlstm-350m": (4, 128, None),        # (b) B, tokens, frames
             "seamless-m4t-large-v2": (4, 64, 64)}
TPF_STEPS = 2                  # (b) training steps
# (b) the steps held against one rank, where fewer than TPF_STEPS: at
# xlstm-350m FULL's random weights the gradient norm reaches ~4e6 by step
# 2 and two float32 fits from one state part there (the one-ulp fit
# moved it by 0.9e6, the ranks by 2.8e6, measured), so only the first
# step, from the one state, compares one function; the later steps are
# held finite and bitwise equal across the ranks
TPF_HELD = {"xlstm-350m": 1}
# (c) jamba-smoke; held at phase 9's tolerance or twice the one-ulp
# fit's distance: the hybrid's smoke fit moves its step-2 grad norm by
# 1.4e-3 relative between two float32 runs (measured; the CPU tests hold
# a step's at 5e-4)
HDP_BATCH, HDP_SEQ, HDP_STEPS = 8, 64, 2
TPF_FLAGS = ("attn", "mlp", "vocab", "experts", "mamba", "mlstm", "slstm")


def tpf_jamba_config(dev):
    """Phase 23 (a)'s config: jamba's published widths at one super-block
    (8 layers: 7 Mamba, 1 attention, 4 MoE) and JAMBA_EXPERTS of its 16
    experts, or 2 where the two ranks' build does not fit: a rank holds
    about half the tree and builds it a part at a time (the largest part,
    the expert stacks, whole), one rank after the other.  Returns (cfg,
    the reduced line)."""
    import torch
    from repro_torch.models.hybrid import HybridLM
    from repro_torch.models.lm import tree_leaves

    def sizes(experts):
        cfg, reduced = family_config("jamba-1.5-large-398b", 8, 8, experts)
        tree = HybridLM(cfg).param_structs()
        whole = 4 * sum(x.numel() for x in tree_leaves(tree))
        moe = 4 * sum(x.numel() for x in tree_leaves(tree["blocks"]["moe"]))
        return cfg, reduced, whole, whole / 2 + whole / 2 + moe
    free = torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved() \
        - torch.cuda.memory_allocated()
    cfg, reduced, whole, ranks = sizes(JAMBA_EXPERTS)
    if max(whole, ranks) + JAMBA_HEADROOM > free:
        cut = (f" (cut to 2 experts: at {JAMBA_EXPERTS} the ranks' build "
               f"needs {ranks / 1e9:.1f} GB of {free / 1e9:.1f} GB free)")
        cfg, reduced, whole, ranks = sizes(2)
        reduced += cut
    return cfg, reduced, whole, ranks


def local_init(local):
    """Patch the hybrid's parameter initializers (in this process) so that
    each part, drawn whole from the model's generator in the model's
    order, keeps only this rank's shard of the leaves ``local`` (the
    plan's tree of split dimensions) names: the tree is then what the
    plan computes with, bitwise the whole tree's parts, and no more than
    one part is ever whole on the card."""
    import torch
    from repro_torch.models import layers as L, moe as M, ssm as S
    parts = (("embed", L, "init_embeddings"), ("mamba", S, "init_mamba"),
             ("attn", L, "init_attention"), ("mlp", L, "init_mlp"),
             ("moe", M, "init_moe"))
    tp_rank, size = local["_rank"], local["_size"]

    def wrap(name, fn):
        dims = local["embed"] if name == "embed" else local["blocks"][name]

        def init(cfg, generator, **kw):
            p, ax = fn(cfg, generator, **kw)
            if generator is None:
                return p, ax
            out = {}
            for k, v in p.items():
                d = dims.get(k)
                out[k] = v if d is None else \
                    v.chunk(size, d)[tp_rank].clone()
            del p
            torch.cuda.empty_cache()
            return out, ax
        return init
    for name, module, attr in parts:
        setattr(module, attr, wrap(name, getattr(module, attr)))


def tpf_jamba_rank(rank, world, store, out_dir, what):
    """Phase 23 (a), one rank: jamba at the parent's config (``spec.json``)
    over (data 1, model 2); the tree built a part at a time, one rank
    after the other; ``prefill`` at TPF_PROMPT and TPF_NEW decode steps of
    the parent's tokens, the parent's expert choices replayed; the flash
    launch's inputs held against the plain version at the sharded heads.
    Writes its logits (rank 0) and a JSON of counts, walls and peaks."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch import kernels as tk
    from repro_torch.configs import get_config
    from repro_torch.device import set_float32_numerics
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.models.hybrid import HybridLM
    from repro_torch.models.lm import tree_leaves
    from repro_torch.optim import AdamW
    from repro_torch.parallel.sharding import mesh_barrier
    from repro_torch.runtime import Trainer

    set_float32_numerics()
    dev = init_ranks("cuda:0", backend="gloo", store_file=store, rank=rank,
                     world_size=world)
    out_dir = pathlib.Path(out_dir)
    spec = json.loads((out_dir / "spec.json").read_text())
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"),
                              **spec["cut"])
    mesh = make_mesh((1, world), ("data", "model"), device=dev)
    tr = Trainer(HybridLM(cfg), AdamW(), mesh=mesh)
    tp = tr.tp
    one = torch.load(out_dir / "one.pt")
    model = routed_hybrid(cfg, plain=False,
                          replay=[i.to(dev) for i in one["log"]])
    seen = []
    base_attend = model.attend

    def attend(q, k, v):
        seen.append((q.detach(), k.detach(), v.detach()))
        return base_attend(q, k, v)
    model.attend = attend
    local = dict(tr._local, _rank=tp.rank, _size=tp.size)
    local_init(local)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for r in range(world):          # one rank's build at a time
        if r == rank:
            params = model.init(torch.Generator(device=dev).manual_seed(
                spec["seed"]))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        mesh_barrier(mesh)
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    held = sum(x.numel() for x in tree_leaves(params)) * 4 / 2 ** 30
    tokens = one["prompt"].to(dev)
    b, s = tokens.shape
    tk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    calls = Collectives()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": tokens}, tp=tp)
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t0) * 1e3
            pre_calls = calls.take()
            grown = model.init_cache(b, s + TPF_NEW, device=dev, tp=tp)
            for key in ("k", "v"):
                grown[key][:, :, :s] = cache[key]
            outs, walls = [logits.cpu()], []
            for t in range(TPF_NEW):
                batch = {"token": one["tokens"][:, t:t + 1].to(dev),
                         "pos": torch.full((b,), s + t, dtype=torch.int32,
                                           device=dev)}
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                logits, grown = model.decode_step(params, grown, batch,
                                                  tp=tp)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t1) * 1e3)
                outs.append(logits.cpu())
        step_calls = calls.take()
    finally:
        calls.close()
    launches = tk.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the one flash launch (the attention layer's prefill) at this rank's
    # heads, against the plain version on the same inputs (not counted)
    q, k, v = seen[0]
    flash = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=True)
    got = tk.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True)
    torch.testing.assert_close(got, flash, rtol=FLASH_TOL, atol=FLASH_TOL,
                               msg="phase 23 (a) flash at the rank's heads")
    if rank == 0:
        torch.save({"logits": outs}, out_dir / "ranks.pt")
    flips = [(p.cpu(), i.cpu(), w.cpu()) for p, i, w in model.flips]
    torch.save(flips, out_dir / f"flips{rank}.pt")
    res = {"rank": rank, "backend": dist.get_backend(),
           "flags": {f: getattr(tp, f) for f in TPF_FLAGS},
           "heads": [list(q.shape), list(k.shape)],
           "flash_err": float((got - flash).abs().max()),
           "launches": launches, "prefill_ms": pre_ms, "step_ms": walls,
           "prefill_calls": pre_calls, "step_calls": step_calls,
           "build_s": build_s, "build_peak_gib": build_peak,
           "held_gib": held, "peak_gib": peak}
    with open(out_dir / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def serve_on_ranks(tr, state, out_dir):
    """Phase 23 (b)'s serving on a rank: ``prefill`` of the parent's
    prompt and TPF_SERVE_NEW decode steps of its tokens under the
    trainer's plan, on the leaves it computes with (its shards where a
    part splits); returns (logits per call on the CPU, flash launches,
    walls ms, collectives of one decode step)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.runtime.train_loop import _gather, _zip_map
    one = torch.load(pathlib.Path(out_dir) / "one.pt")
    dev = tr.device
    leaves = _zip_map(_gather, state[0], tr._dims(state[0]))
    m, tp = tr.model, tr.tp
    prompt = {k: v.to(dev) for k, v in one["prompt"].items()}
    b, s = prompt["tokens"].shape
    tk.reset_launch_counts()
    calls = Collectives()
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = m.prefill(leaves, prompt, tp=tp)
            torch.cuda.synchronize()
            walls = [(time.perf_counter() - t0) * 1e3]
            flash = tk.launch_counts()["flash_attention_fwd"]
            cache = grown_cache(cache, one["grown"])
            outs = [logits.cpu()]
            calls.take()
            for t in range(TPF_SERVE_NEW):
                batch = {"token": one["tokens"][:, t:t + 1].to(dev),
                         "pos": torch.full((b,), s + t, dtype=torch.int32,
                                           device=dev)}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = m.decode_step(leaves, cache, batch, tp=tp)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                outs.append(logits.cpu())
                step_calls = calls.take()
    finally:
        calls.close()
    del leaves, cache
    return outs, flash, walls, step_calls


def grown_cache(cache, length):
    """A prefill's cache in one of ``length`` positions (room for the
    decode steps): the self-attention caches ``k``/``v`` [layers, B, S,
    KV, dh] (this rank's KV heads where attention splits) zero past the
    prompt, every other entry kept; a cache without ``k`` (the xLSTM's
    states) as it is."""
    out = dict(cache)
    for key in ("k", "v") if "k" in cache else ():
        c = cache[key]
        out[key] = c.new_zeros(c.shape[:2] + (length,) + c.shape[3:])
        out[key][:, :, :c.shape[2]] = c
    return out


def tpf_setup(what):
    """Phase 23 (b) and (c)'s training: (cfg, mesh shape, TrainConfig,
    AdamW, data): plain AdamW on phase 21 (b)'s linear schedule; (b) the
    arch's FULL config over (data 1, model 2) on Markov tokens (seamless:
    with stub frames); (c) jamba-smoke over (data 2, model 1)."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import MarkovLMConfig, MarkovLMDataset
    from repro_torch.optim import AdamW, linear_schedule
    from repro_torch.runtime import TrainConfig
    tc = TrainConfig(log_every=1)
    opt = AdamW(learning_rate=linear_schedule(3e-4, 2, 20))
    if what == "hybrid-dp":
        cfg = get_smoke("jamba-1.5-large-398b")
        return cfg, (2, 1), tc, opt, MarkovLMDataset(MarkovLMConfig(
            vocab_size=cfg.vocab_size, seq_len=HDP_SEQ,
            batch_size=HDP_BATCH))
    cfg = get_config(what)
    b, s, frames = TPF_TRAIN[what]
    data = (FramesDataset(cfg, b, frames, s) if frames else
            MarkovLMDataset(MarkovLMConfig(vocab_size=cfg.vocab_size,
                                           seq_len=s, batch_size=b)))
    return cfg, (1, 2), tc, opt, data


def perturbed(tree, seed):
    """``tree`` with each float element moved by -1, 0 or +1 units in the
    last place (seeded, on its device): a change no float32 computation
    can tell from rounding.  How far a model's outputs move under it is
    how much rounding the model amplifies (``tests/_torch_recurrent.py``
    holds the xLSTM so on the CPU)."""
    import torch
    from repro_torch.models.lm import tree_map

    def one(t):
        if not torch.is_floating_point(t):
            return t
        gen = torch.Generator(device=t.device).manual_seed(seed)
        step = torch.randint(-1, 2, t.shape, generator=gen,
                             device=t.device).to(t.dtype)
        return t * (1 + 2.0 ** -23 * step)
    return tree_map(one, tree)


def tpf_one_rank_serve(arch, dev, out_dir):
    """Phase 23 (b)'s one-rank serving: ``arch`` FULL from ``init_state``'s
    seed, ``prefill`` at TPF_SERVE then TPF_SERVE_NEW greedy steps; saves
    the prompt, tokens and logits for the ranks.  The same calls on the
    weights moved by one ulp (:func:`perturbed`, the same tokens) give
    the model's own rounding spread per call.  Returns (logits per call,
    spread per call, walls ms)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovLMConfig, MarkovLMDataset
    from repro_torch.models.registry import build_model
    cfg = get_config(arch)
    b, s, frames = TPF_SERVE[arch]
    if frames:
        prompt = FramesDataset(cfg, b, frames, s).batch_at(5)
        prompt = {k: prompt[k] for k in ("tokens", "embeds")}
    else:
        prompt = {"tokens": MarkovLMDataset(MarkovLMConfig(
            vocab_size=cfg.vocab_size, seq_len=s, batch_size=b)).batch_at(
                5)["tokens"]}
    prompt = {k: torch.as_tensor(v, dtype=torch.long if k == "tokens"
                                 else None) for k, v in prompt.items()}
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    grown = 2 * (s + TPF_SERVE_NEW) if frames else s + TPF_SERVE_NEW

    def serve(weights, tokens=None):
        """(logits per call, the greedy tokens, walls ms)."""
        toks, walls = [], []
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(
                weights, {k: v.to(dev) for k, v in prompt.items()})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            cache = grown_cache(cache, grown)
            outs = [logits.cpu()]
            for t in range(TPF_SERVE_NEW):
                tok = (logits.argmax(-1)[:, None] if tokens is None
                       else tokens[:, t:t + 1].to(dev))
                toks.append(tok.cpu())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = model.decode_step(weights, cache, {
                    "token": tok, "pos": torch.full((b,), s + t,
                                                    dtype=torch.int32,
                                                    device=dev)})
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                outs.append(logits.cpu())
        return outs, torch.cat(toks, 1), walls

    outs, tokens, walls = serve(params)
    moved, _, _ = serve(perturbed(params, 9), tokens)
    spread = [float((x - y).abs().max()) for x, y in zip(moved, outs)]
    torch.save({"prompt": prompt, "tokens": tokens, "grown": grown},
               pathlib.Path(out_dir) / "one.pt")
    del params
    torch.cuda.empty_cache()
    return outs, spread, walls


def hold_logits(ranks_logits, one_logits, what, spread=None):
    """Per call, the ranks' logits against one rank's: within E2E_TOL of
    the scale, or twice the model's own spread under a one-ulp change of
    its weights (``spread``, per call) where that is larger; greedy
    tokens equal where the top-2 margin exceeds twice the difference.
    Returns the line's numbers."""
    worst = wide = 0.0
    clear = same = n = 0
    for i, (a, b) in enumerate(zip(ranks_logits, one_logits)):
        scale = float(b.abs().max())
        diff = float((a - b).abs().max())
        floor = 0.0 if spread is None else 2.0 * spread[i]
        assert bool(a.isfinite().all()), f"{what} call {i}: non-finite"
        assert diff <= max(E2E_TOL * scale, floor), \
            f"{what} call {i}: {diff} of {scale} (spread {floor / 2})"
        worst = max(worst, diff / scale)
        wide = max(wide, floor / 2 / scale)
        top2 = b.topk(2, dim=-1).values
        c_ = (top2[..., 0] - top2[..., 1]) > 2 * diff
        s_ = a.argmax(-1) == b.argmax(-1)
        assert bool(s_[c_].all()), f"{what} call {i}: tokens differ"
        clear += int(c_.sum())
        same += int(s_.sum())
        n += s_.numel()
    return (f"logits max|d| {worst:.2e} of their scale over "
            f"{len(one_logits)} calls"
            + ("" if spread is None else
               f" (the model's own one-ulp spread {wide:.2e})")
            + f"; greedy equal at {same}/{n} ({clear} clear)")


def hold_ranked_fit_spread(ranks, out_dir, tr, loader, steps, held):
    """:func:`hold_ranked_fit` for a model that amplifies rounding: the
    one-rank fit is run twice, from the seed's weights and from them
    moved by one ulp (:func:`perturbed`), and each tolerance is the
    larger of phase 21's and twice the distance between those two fits
    (a step's loss and grad norm; the count of params beyond 1e-3 lr
    after step ``held``, which rank 0 saved).  The first ``held`` steps
    are held so; the later ones finite.  Params bitwise equal across the
    ranks after every step.  Returns (a line of the comparison, the
    one-rank walls)."""
    import math
    import torch
    from repro_torch.models.lm import tree_leaves
    for s in range(steps):
        for r in ranks[1:]:
            assert r["steps"][s]["params"] == ranks[0]["steps"][s]["params"], \
                f"step {s + 1}: rank {r['rank']}'s params != rank 0's"

    def fit(start):
        """The one-rank fit from ``start()``'s state (made in the call, so
        that no name holds it past the first step): (the params after
        step ``held`` on the host, losses, grad norms, walls)."""
        tr.step = 0
        loader.seek(0)
        state, losses, norms, walls, _ = stepwise(tr, loader, start(), held)
        at_held = [x.detach().cpu() for x in tree_leaves(state[0])]
        if steps > held:
            state, more_l, more_n, more_w, _ = stepwise(tr, loader, state,
                                                        steps - held)
            losses, norms, walls = (losses + more_l, norms + more_n,
                                    walls + more_w)
        del state
        torch.cuda.empty_cache()
        return at_held, losses, norms, walls

    def moved():
        params, opt_state, err = tr.init_state(0)
        return perturbed(params, 9), opt_state, err

    want, losses, norms, walls = fit(lambda: tr.init_state(0))
    own_p, m_losses, m_norms, _ = fit(moved)
    got = [st["loss"] for st in ranks[0]["steps"]]
    gnorm = [st["grad_norm"] for st in ranks[0]["steps"]]
    for s in range(steps):
        assert math.isfinite(got[s]) and math.isfinite(gnorm[s]), s
        if s >= held:
            continue
        tol = max(1e-4 * abs(losses[s]), 2 * abs(m_losses[s] - losses[s]))
        assert abs(got[s] - losses[s]) <= tol, \
            f"step {s + 1} loss {got[s]} vs {losses[s]} (tol {tol})"
        tol = max(1e-3 * norms[s], 2 * abs(m_norms[s] - norms[s]))
        assert abs(gnorm[s] - norms[s]) <= tol, \
            f"step {s + 1} grad norm {gnorm[s]} vs {norms[s]} (tol {tol})"
    lr = ranks[0]["steps"][held - 1]["lr"]
    mine = torch.load(out_dir / "params.pt")
    moved = own = n = 0
    worst = 0.0
    for a, b, c in zip(mine, want, own_p):        # on the host
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        moved += int((d > 1e-3 * lr).sum())
        own += int(((c - b).abs() > 1e-3 * lr).sum())
        n += d.numel()
    del own_p, want
    assert moved <= max(PARAM_FLIP_SHARE * n, 2 * own), \
        f"{moved} of {n} params differ (the one-ulp fit: {own})"
    return (f"held {held} of {steps} steps: losses "
            f"{[f'{x:.6f}' for x in got]} vs one rank "
            f"{[f'{x:.6f}' for x in losses]} (one ulp: "
            f"{[f'{x:.6f}' for x in m_losses]}), grad norms "
            f"{[f'{x:.5g}' for x in gnorm]} vs {[f'{x:.5g}' for x in norms]}"
            f" (one ulp: {[f'{x:.5g}' for x in m_norms]}); params after "
            f"step {held} max|d| {worst:.3e}, {moved} of {n} beyond 1e-3 lr"
            f" (the one-ulp fit: {own}; lr {lr:.3e})"), walls


def family_tp_path(dev):
    """Phase 23: (a) jamba serving at its published widths over (data 1,
    model 2) against one rank; (b) xlstm-350m and seamless-m4t-large-v2
    FULL, serving and TPF_STEPS training steps over (data 1, model 2)
    against one rank; (c) jamba-smoke's MoE over (data 2, model 1), two steps
    against one rank on the global batch.  Returns the flash launches of
    the ranks' main paths (the one-rank runs' are not counted)."""
    import shutil
    import torch
    from repro_torch import kernels as tk
    from repro_torch.data import ShardedLoader
    from repro_torch.models.hybrid import HybridLM
    from repro_torch.models.registry import build_model
    from repro_torch.runtime import Trainer

    flash = 0
    # (a) jamba serving at its published widths
    t0 = time.perf_counter()
    cfg, reduced, whole, ranks_need = tpf_jamba_config(dev)
    out_dir = ROOT / "build" / "phase23jamba"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    cut = {"n_layers": cfg.n_layers, "n_experts": cfg.n_experts,
           "split_layer": cfg.split_layer}
    (out_dir / "spec.json").write_text(json.dumps({"cut": cut,
                                                   "seed": 23}))
    print(f"  (a) {reduced}; reckoned: {whole / 4e9:.2f} G f32 parameters "
          f"({whole / 1e9:.1f} GB) on one rank; a rank holds about half "
          f"and builds its part with the largest part whole "
          f"(~{ranks_need / 1e9:.1f} GB for both while the second "
          f"builds)")
    model = routed_hybrid(cfg, plain=False)
    params = model.init(torch.Generator(device=dev).manual_seed(23))
    b, s = TPF_PROMPT
    tokens = torch.as_tensor(markov_tokens(cfg, b, s), dtype=torch.long,
                             device=dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        one_pre = (time.perf_counter() - t1) * 1e3
        grown = grown_cache(cache, s + TPF_NEW)
        del cache
        outs, toks, one_steps = [logits.cpu()], [], []
        for t in range(TPF_NEW):
            tok = logits.argmax(-1)[:, None]
            toks.append(tok.cpu())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, grown = model.decode_step(params, grown, {
                "token": tok, "pos": torch.full((b,), s + t,
                                                dtype=torch.int32,
                                                device=dev)})
            torch.cuda.synchronize()
            one_steps.append((time.perf_counter() - t1) * 1e3)
            outs.append(logits.cpu())
    one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.save({"prompt": tokens.cpu(), "tokens": torch.cat(toks, 1),
                "log": [i.cpu() for i in model.log]}, out_dir / "one.pt")
    assert len(model.log) == len(model.moe_slots) * (1 + TPF_NEW)
    del model, params, grown, logits
    torch.cuda.empty_cache()
    ranks, wall, _ = spawn_ranks("jamba", 2, target=tpf_jamba_rank,
                                 tag="phase23")
    got = torch.load(out_dir / "ranks.pt")["logits"]
    line = hold_logits(got, outs, f"{cfg.name} ranks")
    flipped = sum(near_ties(torch.load(out_dir / f"flips{r['rank']}.pt"),
                            f"{cfg.name} rank {r['rank']}") for r in ranks)
    want = dict.fromkeys(tk.KERNELS, 0)
    want["flash_attention_fwd"] = 1
    for r in ranks:
        assert r["flags"] == dict(attn=True, mlp=True, vocab=True,
                                  experts=True, mamba=True, mlstm=False,
                                  slstm=False), r["flags"]
        assert r["launches"] == want, r["launches"]
        assert r["heads"] == [[b, s, cfg.n_heads // 2, cfg.head_dim],
                              [b, s, cfg.n_kv_heads // 2, cfg.head_dim]]
        flash += r["launches"]["flash_attention_fwd"]
    print(f"  (a) {cfg.name} one super-block over (data 1, model 2), two "
          f"gloo ranks on the card: prefill {b}x{s} then {TPF_NEW} decode "
          f"steps of the one-rank run's greedy tokens, its expert choices "
          f"replayed ({flipped} token-layer choices of the ranks' own "
          f"differed, each a near tie): {line}; flash launched once a rank "
          f"at H {cfg.n_heads // 2} over KV {cfg.n_kv_heads // 2}, dh "
          f"{cfg.head_dim} (held against plain at {FLASH_TOL}: max|d| "
          f"{max(r['flash_err'] for r in ranks):.2e}); one rank: prefill "
          f"{one_pre:.1f} ms, a step {statistics.median(one_steps):.1f} ms "
          f"(median), peak {one_peak:.2f} GiB; {wall:.1f}s with start-up; "
          f"{card_line()}")
    for r in ranks:
        print(f"      rank {r['rank']}: holds {r['held_gib']:.2f} GiB of "
              f"parameters (built in {r['build_s']:.1f}s, peak "
              f"{r['build_peak_gib']:.2f} GiB); prefill "
              f"{r['prefill_ms']:.1f} ms ({r['prefill_calls']['all_reduce']}"
              f" all-reduces, {r['prefill_calls']['all_gather']} "
              f"all-gathers), a step "
              f"{statistics.median(r['step_ms']):.1f} ms (median; "
              f"{r['step_calls']['all_reduce'] // TPF_NEW} all-reduces, "
              f"{r['step_calls']['all_gather'] // TPF_NEW} all-gathers); "
              f"peak {r['peak_gib']:.2f} GiB")
    print(f"  (a) {time.perf_counter() - t0:.1f}s")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # (b) xlstm-350m and seamless-m4t-large-v2 FULL over (data 1, model 2)
    for arch in TPF_SERVE:
        t0 = time.perf_counter()
        out_dir = ROOT / "build" / f"phase23{arch}"
        shutil.rmtree(out_dir, ignore_errors=True)
        out_dir.mkdir(parents=True)
        one, spread, one_walls = tpf_one_rank_serve(arch, dev, out_dir)
        ranks, wall, _ = spawn_ranks(arch, 2, tag="phase23")
        got = torch.load(out_dir / "serve.pt")
        line = hold_logits(got["logits"], one, f"{arch} serving", spread)
        cfg, _, tc, opt, data = tpf_setup(arch)
        fit_line, ref_walls = hold_ranked_fit_spread(
            ranks, out_dir, Trainer(build_model(cfg), opt, dev, tc),
            ShardedLoader(data, device=dev), TPF_STEPS,
            TPF_HELD.get(arch, TPF_STEPS))
        per_fwd = (cfg.n_enc_layers + 2 * cfg.n_layers
                   if cfg.n_enc_layers else 0)
        for r in ranks:
            assert r["serve_flash"] == per_fwd, r["serve_flash"]
            assert r["launches"]["flash_attention_fwd"] == \
                2 * per_fwd * TPF_STEPS, r["launches"]
            flash += r["serve_flash"] + r["launches"]["flash_attention_fwd"]
        b, s, frames = TPF_SERVE[arch]
        print(f"  (b) {arch} FULL over (data 1, model 2), plan "
              f"{ {k: v for k, v in ranks[0]['flags'].items() if v} }: "
              f"prefill {b}x{s}"
              + (f" (+{frames} frames)" if frames else "")
              + f" then {TPF_SERVE_NEW} decode steps of one rank's greedy "
              f"tokens: {line}; one rank prefill {one_walls[0]:.1f} ms, a "
              f"step {statistics.median(one_walls[1:]):.1f} ms; ranks "
              f"prefill {ranks[0]['serve_walls'][0]:.1f} ms, a step "
              f"{statistics.median(ranks[0]['serve_walls'][1:]):.1f} ms "
              f"({ranks[0]['serve_calls']['all_reduce']} all-reduces, "
              f"{ranks[0]['serve_calls']['all_gather']} all-gathers a "
              f"step); flash launches a rank: {per_fwd} in the prefill"
              + (f" (H = KV = {cfg.n_heads // 2} a rank)" if per_fwd
                 else "") + "; "
              f"training {TPF_TRAIN[arch][:2]}, {TPF_STEPS} steps: params "
              f"bitwise equal on both ranks; {fit_line}; one rank's walls "
              f"{[f'{w:.1f}' for w in ref_walls]} ms; "
              f"{len(ranks[0]['halves'])} leaves computed on their half; "
              f"{wall:.1f}s with start-up; {card_line()}")
        for line in rank_lines(ranks):
            print(line)
        shutil.rmtree(out_dir, ignore_errors=True)
        torch.cuda.empty_cache()
        print(f"  (b) {arch}: {time.perf_counter() - t0:.1f}s")

    # (c) the hybrid's MoE over data-parallel ranks at jamba-smoke widths
    t0 = time.perf_counter()
    ranks, wall, out_dir = spawn_ranks("hybrid-dp", 2, tag="phase23")
    cfg, _, tc, opt, data = tpf_setup("hybrid-dp")
    for r in ranks:
        assert r["dp"] == [2, r["rank"]] and r["plan"] is None, r
    fit_line, ref_walls = hold_ranked_fit_spread(
        ranks, out_dir, Trainer(HybridLM(cfg), opt, dev, tc),
        ShardedLoader(data, device=dev), HDP_STEPS, HDP_STEPS)
    for r in ranks:
        assert r["launches"]["flash_attention_fwd"] == \
            2 * (cfg.n_layers // cfg.attn_period) * HDP_STEPS, r["launches"]
        flash += r["launches"]["flash_attention_fwd"]
    print(f"  (c) {cfg.name} ({cfg.n_experts} experts top-"
          f"{cfg.experts_per_token}) over (data 2, model 1), B={HDP_BATCH} "
          f"S={HDP_SEQ}, {HDP_STEPS} steps: the MoE layers' router "
          f"statistics over both ranks; params bitwise equal on both "
          f"ranks; {fit_line}; one rank's walls "
          f"{[f'{w:.1f}' for w in ref_walls]} ms; {wall:.1f}s with "
          f"start-up; {card_line()}; at jamba's widths one super-block's "
          f"AdamW state (~16 B a parameter, ~170 GB) does not fit one card: "
          f"the dry-run's jamba train_4k records show that step at full "
          f"width and depth")
    for line in rank_lines(ranks):
        print(line)
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"  (c) {time.perf_counter() - t0:.1f}s")
    return flash


def markov_tokens(cfg, b, s):
    """Markov tokens [b, s] of ``cfg``'s vocabulary (batch 1 of the
    dataset)."""
    from repro_torch.data import MarkovLMConfig, MarkovLMDataset
    return MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=s, batch_size=b)).batch_at(1)[
            "tokens"]


# ---------------------------------------------------------------------------
# phase 22: the dry-run's accounting on the card
# ---------------------------------------------------------------------------

#: the dry-run cells of (d) beside qwen2-0.5b's 16: one of each other family
DRYRUN_OTHERS = (("llava-next-mistral-7b", "prefill_32k"),      # vlm
                 ("seamless-m4t-large-v2", "prefill_32k"),      # encdec
                 ("qwen3-moe-235b-a22b", "decode_32k"),         # moe
                 ("xlstm-350m", "decode_32k"),                  # ssm
                 ("jamba-1.5-large-398b", "long_500k"))         # hybrid
#: (d)'s variant cells of qwen2-0.5b, both meshes: (variant, shapes)
DRYRUN_VARIANTS = (("cacheshard", "decode_32k"),
                   ("notp", "train_4k,prefill_32k"),
                   ("seqshard", "train_4k,prefill_32k"),
                   ("int8w", "prefill_32k,decode_32k"))
#: the launch counter each kernel op's calls count on
OP_LAUNCHES = {"qmm": "qmm", "qmm_int4": "qmm_int4",
               "group_quantize": "group_quantize",
               "quantized_decode_attention": "quantized_decode_attention",
               "flash_attention_fwd": "flash_attention_fwd",
               "row_gemm": "row_gemm", "row_gemm_group": "row_gemm",
               "tc_gemm": "tc_gemm"}


def fake_tree(conv, tree):
    """``tree`` with every tensor through ``conv``: a FakeTensorMode's
    ``from_tensor`` (fake copies on the card) or a move to ``meta`` (the
    dry-run's tensors): shapes and dtypes only."""
    from repro_torch.models.lm import tree_map
    return tree_map(conv, tree)


def held_equal(a, b) -> bool:
    """Whether two trees (dicts, lists, tuples, tensors, numbers) are
    bitwise equal."""
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(held_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(held_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and bool(
            torch.equal(a, b))
    return a == b


def account_call(what, real, fake, flush, counts):
    """Phase 22 (a) and (b) for one call: ``real()`` builds its inputs on
    the card and returns a function of none that runs the call (fresh
    inputs each time: calls that write their cache or cache their
    weights run on their own copies); ``fake(conv, device)`` the same
    on the tensors ``conv`` makes of the real ones, on ``device``.  The
    accountant's FLOPs, HBM and collective bytes of the real run must
    equal the run's under FakeTensorMode exactly, its kernel ops' calls
    the launches counted, and its outputs be bitwise the outputs of a run
    without the accountant.  The same run on ``meta`` tensors (the
    dry-run's) must give the same FLOPs, kernel-op calls and HBM bytes,
    op by op ((e): ``F.rms_norm`` is one op on both).  Then the call's
    device ms (CUDA events, median of 5) beside its compute, memory and
    bound terms on the H100's constants.  Adds the real runs' launches to
    ``counts``; returns a summary line's dict."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import kernels as tk
    from repro_torch.launch import opcount as oc

    start = tk.launch_counts()
    call = real()               # building it may launch (an engine's first
    torch.cuda.synchronize()    # configure): outside the accounted call
    before = tk.launch_counts()
    out_real, real_costs = oc.account(call)
    torch.cuda.synchronize()
    after = tk.launch_counts()
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    out_bare = real()()
    if not held_equal(out_real, out_bare):
        # held against the accountant only where the call repeats its own
        # bits: a second run without it must equal the first
        again = real()()
        assert not held_equal(out_bare, again), \
            f"{what}: the accountant changed the outputs"
        print(f"  {what}: not bitwise reproducible on the card run to run "
              "(with or without the accountant)")
    torch.cuda.synchronize()
    for k, n in tk.launch_counts().items():
        counts[k] += n - start[k]
    with FakeTensorMode() as fm:
        _, fake_costs = oc.account(fake(fm.from_tensor, None))
    for key in ("flops", "hbm_bytes", "collective_bytes"):
        assert getattr(real_costs, key) == getattr(fake_costs, key), \
            (what, key, getattr(real_costs, key), getattr(fake_costs, key))
    assert real_costs.kernel_calls == fake_costs.kernel_calls, what
    meta = torch.device("meta")
    _, meta_costs = oc.account(fake(lambda t: t.to(meta), meta))
    assert meta_costs.flops == real_costs.flops, (what, meta_costs.flops)
    assert meta_costs.kernel_calls == real_costs.kernel_calls, what
    ops = set(meta_costs.op_bytes) | set(real_costs.op_bytes)
    moved = sorted(((meta_costs.op_bytes.get(o, 0.0)
                     - real_costs.op_bytes.get(o, 0.0), o) for o in ops),
                   key=lambda x: -abs(x[0]))
    # (e) meta bills the card's bytes: ``F.rms_norm`` is one op both ways
    # (``layers.rmsnorm``'s ``repro_norm::rms_norm``)
    assert not (moved and moved[0][0]), (
        f"{what}: meta bills "
        f"{meta_costs.hbm_bytes - real_costs.hbm_bytes:.6g} B more than the "
        f"card; by op: "
        + ", ".join(f"{o} {d:+.4g}" for d, o in moved[:6] if d))
    assert meta_costs.hbm_bytes == real_costs.hbm_bytes, what
    by_counter = {}
    for op, n in real_costs.kernel_calls.items():
        by_counter[OP_LAUNCHES[op]] = by_counter.get(OP_LAUNCHES[op], 0) + n
    assert by_counter == launched, (what, by_counter, launched)

    fns = [real() for _ in range(6)]
    ms = time_ms(lambda: fns.pop()(), flush, reps=5)
    compute = real_costs.flops / F32_FLOPS * 1e3
    memory = real_costs.hbm_bytes / HBM_BYTES_PER_S * 1e3
    bound = max(compute, memory)
    line = dict(call=what, flops=real_costs.flops,
                hbm_bytes=real_costs.hbm_bytes, kernels=by_counter,
                ms=ms, compute_ms=compute, memory_ms=memory,
                bound_ms=bound, ratio=ms / bound)
    print(f"  {what:28s} flops={real_costs.flops:.6g} "
          f"hbm={real_costs.hbm_bytes:.6g} B fake == real == meta; "
          f"launches "
          f"{by_counter}; device ms={ms:.4f} compute={compute:.4f} "
          f"memory={memory:.4f} bound={bound:.4f} "
          f"measured/bound={ms / bound:.2f}")
    return line


def start_dryrun():
    """Phase 22 (d)'s dry-run, started in a process of its own (it needs
    the host's CPU only, so it runs beside phases 21-22): qwen2-0.5b x the
    four shapes x both meshes x {baseline, flash}, DRYRUN_OTHERS and
    DRYRUN_VARIANTS.  Returns (the process, its start, its records'
    directory); the process is killed at exit if still running."""
    import atexit
    out_dir = ROOT / "chiprun_out" / "dryrun"
    runs = [["--arch", "qwen2-0.5b", "--shape", "all", "--mesh", "both",
             "--variant", variant, "--out", str(out_dir)]
            for variant in ("baseline", "flash")]
    runs += [["--arch", arch, "--shape", shape_name, "--mesh", "both",
              "--out", str(out_dir)] for arch, shape_name in DRYRUN_OTHERS]
    runs += [["--arch", "qwen2-0.5b", "--shape", shapes, "--mesh", "both",
              "--variant", variant, "--out", str(out_dir)]
             for variant, shapes in DRYRUN_VARIANTS]
    code = ("from repro_torch.launch import dryrun\n"
            f"codes = [dryrun.main(a) for a in {runs!r}]\n"
            "assert codes == [0] * len(codes), codes\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, time.perf_counter(), out_dir


def dryrun_path(cfg, params, sysp, dev, flush, counts, dry):
    """Phase 22: (a) fake == real and (b) measured against the bound for
    the co-inference forward at b̂ = 8 and 4 (with its configure), the
    B = 4 token step over the quantized cache (T = 1024), prefill and
    phase 9's 8 x 128 training step; (c) flash through the accounting op;
    (d) the dry-run, in the subprocess ``dry`` (:func:`start_dryrun`).
    Adds the phase's launches to ``counts``."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.data import MarkovLMConfig, MarkovLMDataset
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import layers as L
    from repro_torch.models.lm import DecoderLM, tree_map
    from repro_torch.optim import AdamWState
    from repro_torch.parallel.sharding import flash_attention_mode
    from repro_torch.runtime import CoInferenceEngine, Trainer

    model = DecoderLM(cfg)
    tokens = torch.as_tensor(MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=S, batch_size=B)).batch_at(0)[
            "tokens"], dtype=torch.long, device=dev)
    lam = CoInferenceEngine(model, params, sysp, path="kernel").lam

    # (a), (b)
    lines = []
    for b_hat in (8, 4):
        def fwd_real(b_hat=b_hat):
            eng = CoInferenceEngine(model, params, sysp, path="kernel",
                                    lam=lam)

            def call():
                eng.configure(b_hat)
                return eng.serve_batch({"tokens": tokens})[0]
            return call

        def fwd_fake(conv, device, b_hat=b_hat):
            eng = CoInferenceEngine(model, fake_tree(conv, params), sysp,
                                    path="kernel", lam=lam, device=device)
            tok = conv(tokens)

            def call():
                eng.configure(b_hat)
                return eng.serve_batch({"tokens": tok})[0]
            return call
        lines.append(account_call(f"forward {B}x{S} b_hat={b_hat}",
                                  fwd_real, fwd_fake, flush, counts))

    t_cache = 1024
    shape = (cfg.n_layers, B, t_cache, cfg.n_kv_heads, cfg.head_dim)
    gen = torch.Generator(device=dev).manual_seed(22)
    cache0 = {"k_codes": torch.randint(-127, 128, shape, generator=gen,
                                       device=dev, dtype=torch.int8),
              "v_codes": torch.randint(-127, 128, shape, generator=gen,
                                       device=dev, dtype=torch.int8),
              "k_scales": torch.rand(shape[:-1], generator=gen,
                                     device=dev) * 0.02 + 0.01,
              "v_scales": torch.rand(shape[:-1], generator=gen,
                                     device=dev) * 0.02 + 0.01}
    lens = torch.tensor([700, 1000, 90, 513], dtype=torch.int32, device=dev)
    step_batch = {"token": tokens[:, :1], "pos": lens}

    def dec_real():
        qc = dict(tree_map(lambda t: t.clone(), cache0), len=lens.clone())
        return lambda: model.decode_step_q(params, qc, step_batch,
                                           b_kv=8)[0]

    def dec_fake(conv, device):
        qc = dict(fake_tree(conv, cache0), len=conv(lens))
        sb = fake_tree(conv, step_batch)
        pf = fake_tree(conv, params)
        return lambda: model.decode_step_q(pf, qc, sb, b_kv=8)[0]
    lines.append(account_call(f"token step B={B} T={t_cache}", dec_real,
                              dec_fake, flush, counts))

    def pre_real():
        return lambda: model.prefill(params, {"tokens": tokens})

    def pre_fake(conv, device):
        pf, tok = fake_tree(conv, params), conv(tokens)
        return lambda: model.prefill(pf, {"tokens": tok})
    lines.append(account_call(f"prefill {B}x{S}", pre_real, pre_fake,
                              flush, counts))

    tc, opt, data = train_setup(cfg)
    tr = Trainer(DecoderLM(cfg), opt, dev, tc)
    tr.build_step()
    tr_meta = Trainer(DecoderLM(cfg), opt, "meta", tc)
    tr_meta.build_step()
    state0 = tr.init_state(0)
    batch = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
             for k, v in data.batch_at(0).items()}

    # the step is a function of its state (AdamW and the compression
    # return new trees), so every run starts from state0
    def train_real():
        return lambda: tr._step(*state0, batch)

    def train_fake(conv, device):
        p, o, e = state0
        fake = (fake_tree(conv, p), AdamWState(
            conv(o.step), fake_tree(conv, o.m), fake_tree(conv, o.v)),
            fake_tree(conv, e))
        b = fake_tree(conv, batch)
        step = (tr if device is None else tr_meta)._step
        return lambda: step(*fake, b)
    lines.append(account_call(f"train step {TRAIN_BATCH}x{TRAIN_SEQ}",
                              train_real, train_fake, flush, counts))
    del state0
    torch.cuda.empty_cache()

    # (e) the norm the accountant bills as one op keeps F.rms_norm's bits,
    # forward and backward, at the training step's rows
    g = torch.Generator(device=dev).manual_seed(24)
    x, w, dy = (torch.randn(shape, generator=g, device=dev) for shape in (
        (TRAIN_BATCH * TRAIN_SEQ, cfg.d_model), (cfg.d_model,),
        (TRAIN_BATCH * TRAIN_SEQ, cfg.d_model)))
    ours = [t.clone().requires_grad_(True) for t in (x, w)]
    theirs = [t.clone().requires_grad_(True) for t in (x, w)]
    y0 = L.rmsnorm(*ours)
    y1 = torch.nn.functional.rms_norm(theirs[0], (cfg.d_model,), theirs[1],
                                      1e-6)
    y0.backward(dy)
    y1.backward(dy)
    assert torch.equal(y0, y1) and all(
        torch.equal(a.grad, b.grad) for a, b in zip(ours, theirs)), \
        "repro_norm::rms_norm != F.rms_norm"
    print(f"  (e) rms_norm as one op: meta's bytes == the card's in every "
          f"call above; y, dx, dgain bitwise F.rms_norm's at "
          f"{TRAIN_BATCH * TRAIN_SEQ} x {cfg.d_model}")
    del x, w, dy, ours, theirs, y0, y1

    # (c) flash through the accounting op, on a one-rank mesh
    g = torch.Generator(device=dev).manual_seed(23)
    q = torch.randn((B, S, cfg.n_heads, cfg.head_dim), generator=g,
                    device=dev)
    k, v = (torch.randn((B, S, cfg.n_kv_heads, cfg.head_dim), generator=g,
                        device=dev) for _ in range(2))
    before = tk.launch_counts()["flash_attention_fwd"]
    with flash_attention_mode(AbstractMesh((1, 1), ("data", "model"))):
        acct = L.blockwise_attention(q, k, v, causal=True)
    plain = L.blockwise_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    n = tk.launch_counts()["flash_attention_fwd"] - before
    assert n == 2, n
    counts["flash_attention_fwd"] += n
    assert torch.equal(acct, plain), "accounting op != blockwise_attention"
    print(f"  (c) fused_attention_acct {B}x{S}, one-rank mesh: 1 flash "
          f"launch, bitwise blockwise_attention")

    # (d) the dry-run beside the card, in the process start_dryrun began
    proc, t0, out_dir = dry
    stdout, stderr = proc.communicate(timeout=600)
    secs = time.perf_counter() - t0
    print("\n".join("    " + ln for ln in stdout.splitlines()
                    if ln.startswith("[")))
    assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    from repro_torch.launch import roofline
    recs = roofline.load_records(str(out_dir))
    n_var = sum(2 * len(shapes.split(",")) for _, shapes in DRYRUN_VARIANTS)
    assert len(recs) == 16 + 2 * len(DRYRUN_OTHERS) + n_var, len(recs)
    assert all(r["status"] in ("ok", "skip") for r in recs), \
        [(r["arch"], r["shape"], r["variant"], r.get("error"))
         for r in recs if r["status"] not in ("ok", "skip")]
    rows = sorted((t for r in recs if (t := roofline.roofline_terms(r))),
                  key=lambda r: (r["mesh"], r["arch"], r["shape"],
                                 r["variant"]))
    print(roofline.markdown_table(rows))
    print(f"  (d) dry-run: {len(recs)} records in {secs:.1f}s since its "
          f"start before phase 21")
    return lines


# ---------------------------------------------------------------------------
# phase 24: the dry-run's last variants on real tensors: the sequence-
# sharded KV cache, sequence-parallel training where nothing is split
# (notp) and the int8-resident tree over a mesh (int8w)
# ---------------------------------------------------------------------------

SEQ_PROMPT, SEQ_T = (4, 504), 1024     # (a) qwen2-0.5b: B x prompt; the
#                        cache's T over (model 2): the steps cross 512
JSEQ_PROMPT, JSEQ_T = 4088, 8192       # (a) jamba at B = 1: the prompt;
#                        the cache's T over (data 2): the steps cross 4096
SEQ_NEW = 16                           # (a) decode steps after each prompt
NOTP_STEPS = 2                         # (b) phase 9's steps, sequence split


def jamba_seq_config():
    """Phase 24 (a)'s jamba: phase 23's cut (one super-block, 2 of 16
    experts) in bfloat16, so that two whole copies (the data-parallel
    ranks hold every weight) and the one-rank run's fit the card; the
    reduced line."""
    import dataclasses
    cfg, reduced = family_config("jamba-1.5-large-398b", 8, 8, 2)
    return (dataclasses.replace(cfg, dtype="bfloat16",
                                param_dtype="bfloat16"),
            reduced + "; bfloat16 weights and compute")


def notp_rules(cfg):
    """The dry-run's ``notp`` rules: heads, KV, FFN and vocabulary
    replicated (``launch/dryrun.py``'s ``_account``)."""
    from repro_torch.parallel.sharding import default_rules
    rules = default_rules(cfg)
    rules.update(heads=None, kv=None, kv_heads=None, ffn=None, vocab=None)
    return rules


def seq_one_rank(dev, out_dir):
    """Phase 24's one-rank runs, saved for the ranks: (a) qwen2-0.5b FULL
    prefill at SEQ_PROMPT and SEQ_NEW greedy steps over a cache of SEQ_T,
    and jamba (:func:`jamba_seq_config`) likewise at JSEQ_PROMPT and
    JSEQ_T; (c) qwen2-0.5b's int8-resident prefill and one decode step
    (``quantize_tree_stacked`` at 8 bits per channel, phase 20 (b)'s
    forward).  Returns the logits per call of each, and walls."""
    import torch
    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.core.quantization import QuantConfig, \
        quantize_tree_stacked
    from repro_torch.models.hybrid import HybridLM
    from repro_torch.models.lm import DecoderLM

    out = {}

    def run(model, params, prompt, t_len):
        b, s = prompt.shape
        toks, outs = [], []
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": prompt})
            cache = grown_cache(cache, t_len)
            outs.append(logits.cpu())
            for t in range(SEQ_NEW):
                tok = logits.argmax(-1)[:, None]
                toks.append(tok.cpu())
                logits, cache = model.decode_step(params, cache, {
                    "token": tok, "pos": torch.full(
                        (b,), s + t, dtype=torch.int32, device=dev)})
                outs.append(logits.cpu())
        return outs, torch.cat(toks, 1)

    gen = torch.Generator().manual_seed(24)
    model = DecoderLM(FULL)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompt = torch.randint(0, FULL.vocab_size, SEQ_PROMPT, generator=gen)
    t0 = time.perf_counter()
    out["qwen"], tokens = run(model, params, prompt.to(dev), SEQ_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    qt = quantize_tree_stacked(params, QuantConfig(
        bits=8, granularity="per-channel"))
    del params
    with torch.no_grad():
        logits, cache = model.prefill(qt, {"tokens": prompt.to(dev)})
        cache = grown_cache(cache, SEQ_T)
        step, _ = model.decode_step(qt, cache, {
            "token": tokens[:, :1].to(dev),
            "pos": torch.full((SEQ_PROMPT[0],), SEQ_PROMPT[1],
                              dtype=torch.int32, device=dev)})
    out["int8w"] = [logits.cpu(), step.cpu()]
    del qt, cache
    torch.cuda.empty_cache()
    cfg, _ = jamba_seq_config()
    jam = HybridLM(cfg)
    jp = jam.init(torch.Generator(device=dev).manual_seed(1))
    jprompt = torch.randint(0, cfg.vocab_size, (1, JSEQ_PROMPT),
                            generator=gen)
    t0 = time.perf_counter()
    out["jamba"], jtokens = run(jam, jp, jprompt.to(dev), JSEQ_T)
    torch.cuda.synchronize()
    jwall = time.perf_counter() - t0
    del jp
    torch.cuda.empty_cache()
    torch.save({"prompt": prompt, "tokens": tokens, "jprompt": jprompt,
                "jtokens": jtokens}, pathlib.Path(out_dir) / "one.pt")
    return out, wall, jwall


def seq_rank(rank, world, store, out_dir, what):
    """Phase 24 (a) and (c), one rank of two sharing the card over gloo:
    (a) qwen2-0.5b FULL over (data 1, model 2) on its plan's leaves, the
    prefill's cache (this rank's KV head) gathered over ``model``, grown
    to SEQ_T and cut to this rank's half of the sequence, then SEQ_NEW
    ``decode_step(..., cache_seq=)`` of the one-rank run's tokens; jamba
    over (data 2, model 1) likewise, every weight whole, its attention
    cache's half of JSEQ_T; (c) qwen2-0.5b's int8-resident tree over
    (model 2): prefill and one decode step on the plan's leaves.  Writes
    the logits (rank 0 a file of them), the local positions each decode
    changed, the held weight bytes and walls as JSON."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.core.quantization import (QuantConfig, QuantizedTensor,
                                               quantize_tree_stacked)
    from repro_torch.device import set_float32_numerics
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.models.hybrid import HybridLM
    from repro_torch.models.lm import DecoderLM, tree_leaves
    from repro_torch.optim import AdamW
    from repro_torch.parallel.tensor_parallel import (SequenceShards,
                                                      shard_leaf)
    from repro_torch.runtime import Trainer
    from repro_torch.runtime.train_loop import _zip_map

    set_float32_numerics()
    dev = init_ranks("cuda:0", backend="gloo", store_file=store, rank=rank,
                     world_size=world)
    one = torch.load(pathlib.Path(out_dir) / "one.pt")
    mesh_m = make_mesh((1, world), ("data", "model"), device=dev)
    mesh_d = make_mesh((world, 1), ("data", "model"), device=dev)
    res = {"rank": rank, "backend": dist.get_backend()}
    logits_out = {}

    def decode(model, leaves, cache, tokens, start, shards, tp, key):
        """SEQ_NEW steps of ``tokens`` from ``start``; the logits and the
        local positions of the attention cache the steps changed."""
        b = tokens.shape[0]
        before = cache["k"].clone()
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for t in range(SEQ_NEW):
                logits, cache = model.decode_step(leaves, cache, {
                    "token": tokens[:, t:t + 1].to(dev),
                    "pos": torch.full((b,), start + t, dtype=torch.int32,
                                      device=dev)}, tp=tp, cache_seq=shards)
                outs.append(logits.cpu())
        torch.cuda.synchronize()
        res[key + "_wall_ms"] = (time.perf_counter() - t0) * 1e3 / SEQ_NEW
        moved = (cache["k"] != before).flatten(3).any(-1).any(0).any(0)
        res[key + "_written"] = torch.nonzero(moved).flatten().tolist()
        res[key + "_offset"] = shards.offset
        return outs

    # (a) qwen2-0.5b over (data 1, model 2), the cache's sequence on model
    tr = Trainer(DecoderLM(FULL), AdamW(learning_rate=1e-4), mesh=mesh_m)
    tp = tr.tp
    params = tr.model.init(torch.Generator(device=dev).manual_seed(0))
    leaves = _zip_map(lambda p, d: shard_leaf(p, d, tp), params,
                      tr._dims(params))
    prompt = one["prompt"].to(dev)
    b, s = prompt.shape
    with torch.no_grad():
        first, cache = tr.model.prefill(leaves, {"tokens": prompt}, tp=tp)
    shards = SequenceShards.of(mesh_m, ("model",), SEQ_T // world)
    whole = {}
    for key in ("k", "v"):                  # every KV head, then this half
        heads = [torch.empty_like(cache[key]) for _ in range(world)]
        dist.all_gather(heads, cache[key].contiguous(), group=tp.group)
        full = torch.zeros(cache[key].shape[:2] + (SEQ_T,)
                           + (FULL.n_kv_heads, FULL.head_dim), device=dev)
        full[:, :, :s] = torch.cat(heads, 3)
        whole[key] = full[:, :, shards.offset:shards.offset
                          + shards.length].clone()
    whole["len"] = cache["len"]
    del cache
    logits_out["qwen"] = [first.cpu()] + decode(
        tr.model, leaves, whole, one["tokens"], s, shards, tp, "qwen")

    # (c) the int8-resident tree over (model 2)
    qt = quantize_tree_stacked(params, QuantConfig(
        bits=8, granularity="per-channel"))
    del params, leaves, whole
    qleaves = _zip_map(lambda p, d: shard_leaf(p, d, tp), qt,
                       tr._dims(qt))
    del qt
    res["held_bytes"] = sum(
        (x.codes.numel() * x.codes.element_size()
         + x.scale.numel() * x.scale.element_size())
        if isinstance(x, QuantizedTensor) else x.numel() * x.element_size()
        for x in tree_leaves(qleaves))
    with torch.no_grad():
        q_first, cache = tr.model.prefill(qleaves, {"tokens": prompt},
                                          tp=tp)
        cache = grown_cache(cache, SEQ_T)
        step, _ = tr.model.decode_step(qleaves, cache, {
            "token": one["tokens"][:, :1].to(dev),
            "pos": torch.full((b,), s, dtype=torch.int32, device=dev)},
            tp=tp)
    logits_out["int8w"] = [q_first.cpu(), step.cpu()]
    del qleaves, cache, tr
    torch.cuda.empty_cache()

    # (a) jamba over (data 2, model 1), the attention cache's sequence on
    # data; every rank holds every weight
    cfg, _ = jamba_seq_config()
    jam = HybridLM(cfg)
    jp = jam.init(torch.Generator(device=dev).manual_seed(1))
    jprompt = one["jprompt"].to(dev)
    with torch.no_grad():
        jfirst, cache = jam.prefill(jp, {"tokens": jprompt})
    cache = grown_cache(cache, JSEQ_T)
    jshards = SequenceShards.of(mesh_d, ("data",), JSEQ_T // world)
    for key in ("k", "v"):
        cache[key] = cache[key][:, :, jshards.offset:jshards.offset
                                + jshards.length].clone()
    torch.cuda.empty_cache()
    logits_out["jamba"] = [jfirst.cpu()] + decode(
        jam, jp, cache, one["jtokens"], JSEQ_PROMPT, jshards, None,
        "jamba")
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del jp, cache
    torch.save(logits_out, pathlib.Path(out_dir) / f"logits{rank}.pt")
    with open(pathlib.Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def variants_path(cfg, dev):
    """Phase 24: (a) the sequence-sharded KV cache, (b) notp training and
    (c) the int8-resident tree over a mesh, two gloo ranks sharing the
    card each, against one rank; returns the flash launches."""
    import torch
    from repro_torch.data import ShardedLoader
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import Trainer

    out_dir = ROOT / "build" / "phase24seq"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    one, wall, jwall = seq_one_rank(dev, out_dir)
    print(f"  one rank: qwen2-0.5b prefill {SEQ_PROMPT[0]}x{SEQ_PROMPT[1]} "
          f"+ {SEQ_NEW} steps over T={SEQ_T} {wall:.2f}s, its "
          f"int8-resident prefill + 1 step; jamba ({jamba_seq_config()[1]})"
          f" prefill 1x{JSEQ_PROMPT} + {SEQ_NEW} steps over T={JSEQ_T} "
          f"{jwall:.2f}s; {time.perf_counter() - t0:.1f}s")
    print(f"  {release_memory()}")
    ranks, wall, _ = spawn_ranks("seq", 2, target=seq_rank, tag="phase24")
    got = [torch.load(out_dir / f"logits{r}.pt") for r in range(2)]
    for arch, half, prompt in (("qwen", SEQ_T // 2, SEQ_PROMPT[1]),
                               ("jamba", JSEQ_T // 2, JSEQ_PROMPT)):
        for r, g in zip(ranks, got):
            line = hold_logits(g[arch], one[arch], f"(a) {arch} rank "
                               f"{r['rank']}")
            # the steps' positions prompt .. prompt + SEQ_NEW - 1, each
            # written on the rank whose half holds it, nowhere else
            o = r[f"{arch}_offset"]
            want = [p - o for p in range(prompt, prompt + SEQ_NEW)
                    if o <= p < o + half]
            assert r[f"{arch}_written"] == want, (arch, r["rank"],
                                                  r[f"{arch}_written"])
        print(f"  (a) {arch}, cache sequence over "
              f"{'model' if arch == 'qwen' else 'data'} 2: {line}; writes "
              f"on their owners ({len(ranks[0][arch + '_written'])} + "
              f"{len(ranks[1][arch + '_written'])} positions); "
              f"{ranks[0][arch + '_wall_ms']:.2f} ms a step")
    for r, g in zip(ranks, got):
        for a, b_ in zip(g["int8w"], one["int8w"]):
            scale = float(b_.abs().max())
            diff = float((a - b_).abs().max())
            assert diff <= KERNEL_TOL * scale, ("(c)", r["rank"], diff)
    print(f"  (c) int8-resident prefill + 1 step over (model 2) vs one "
          f"rank: logits within {KERNEL_TOL} of scale; held weight bytes "
          f"per rank {[r['held_bytes'] for r in ranks]}; peaks "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; {wall:.1f}s "
          f"with start-up")
    print(f"  {release_memory()}")

    # (b) notp: phase 9's step over (data 1, model 2), the sequence split
    ranks, wall, nout = spawn_ranks("notp", 2, tag="phase24")
    for r in ranks:
        assert r["flags"] == dict.fromkeys(TPF_FLAGS, False), r["flags"]
    tc, opt, data = train_setup(cfg)
    line, ref_walls = hold_ranked_fit(
        ranks, nout, Trainer(DecoderLM(cfg), opt, dev, tc),
        ShardedLoader(data, device=dev), NOTP_STEPS)
    flash = 0
    for r in ranks:
        n = r["launches"]["flash_attention_fwd"]
        assert n == 2 * cfg.n_layers * NOTP_STEPS, r["launches"]
        flash += n
    print(f"  (b) notp over (data 1, model 2), the sequence split: "
          f"{line}; flash launches {flash} (at offset {TRAIN_SEQ // 2} on "
          f"rank 1); {wall:.1f}s with start-up; {card_line()}")
    for ln in rank_lines(ranks):
        print(ln)
    (nout / "params.pt").unlink()
    torch.cuda.empty_cache()
    return flash


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py needs a GPU",
              file=sys.stderr)
        return 1
    from repro_torch import kernels as tk
    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.core.quantization import QuantPlan
    from repro_torch.data import MarkovLMConfig, MarkovLMDataset
    from repro_torch.device import set_float32_numerics
    from repro_torch.kernels import build
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import CoInferenceEngine, QosClass

    t_start = time.perf_counter()
    # 1. environment
    card = card_line()
    dev = torch.device("cuda")
    set_float32_numerics()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(f"peaks used for bounds: {HBM_BYTES_PER_S / 1e12} TB/s HBM, "
          f"{F32_FLOPS / 1e12} TFLOP/s non-tensor f32 (H100 SXM data "
          "sheet, 700 W)")

    # 2. build
    secs = build.build_all(verbose=True)
    print(f"build: {secs:.1f}s for {', '.join(build.SOURCES)}")

    # 3. kernels against their plain versions
    cfg = FULL
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)   # > 50 MB of L2
    detail = []
    t0 = time.perf_counter()
    summary = check_kernels(cfg, dev, flush, detail)
    check_qmm_simt(dev)
    summary["group_quantize"] = check_group_quantize(cfg, dev, flush)
    print(f"kernels vs plain: ok in {time.perf_counter() - t0:.1f}s")
    for name in ("qmm", "qmm_int4"):
        s = summary[name]
        print(f"  {name} per forward (M={B * S}, {7 * cfg.split_layer} "
              f"launches): ms={s['ms']:.4f} torch.matmul={s['library_ms']:.4f}"
              f" plain={s['plain_ms']:.4f} bound={s['bound_ms']:.4f} "
              f"({s['bound_by']}, {QMM_PASSES} bf16 passes) "
              f"f32-simt-bound={s['bound_f32_ms']:.4f}")
    for d in detail:
        shape = f"m={d.get('m', '-')} k={d['k']} n={d['n']}"
        print(f"  {d['kernel']:15s} {shape:22s} ms={d['ms']:.4f} "
              f"plain={d['plain_ms']:.4f} lib={d['library_ms']} "
              f"bound={d['bound_ms']:.4f} ({d['bound_by']}) "
              + (f"f32-simt-bound={d['bound_f32_ms']:.4f} "
                 if "bound_f32_ms" in d else "")
              + f"err={d['max_abs_err']:.2e}")

    # stablelm-3b's seven agent matmul shapes (K, N in 2560 / 6912), the
    # same checks: the tensor-core route, KERNEL_TOL, rows bitwise alone
    from repro_torch.configs.stablelm_3b import FULL as SL_FULL
    t0 = time.perf_counter()
    sl_detail = []
    sl_qmm = check_kernels(SL_FULL, dev, flush, sl_detail)
    print(f"stablelm-3b agent matmuls vs plain: ok in "
          f"{time.perf_counter() - t0:.1f}s")
    for name in ("qmm", "qmm_int4"):
        s_ = sl_qmm[name]
        print(f"  {name} per stablelm-3b forward (M={B * S}, "
              f"{7 * SL_FULL.split_layer} launches): ms={s_['ms']:.4f} "
              f"torch.matmul={s_['library_ms']:.4f} "
              f"plain={s_['plain_ms']:.4f} bound={s_['bound_ms']:.4f} "
              f"({s_['bound_by']}) f32-simt-bound={s_['bound_f32_ms']:.4f}")
    for d in sl_detail:
        if d.get("m") == B * S:
            print(f"  {d['kernel']:15s} stablelm k={d['k']} n={d['n']} "
                  f"ms={d['ms']:.4f} plain={d['plain_ms']:.4f} "
                  f"lib={d['library_ms']:.4f} bound={d['bound_ms']:.4f} "
                  f"err={d['max_abs_err']:.2e}")

    # 4. the main path at full width
    t0 = time.perf_counter()
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    per_layer = cfg.active_param_count() / cfg.n_layers
    sysp = SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * B * S,
        n_flop_server=2.0 * per_layer * (cfg.n_layers - cfg.split_layer)
        * B * S)
    tokens = MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=S, batch_size=B)).batch_at(0)[
            "tokens"]
    torch.cuda.synchronize()
    print(f"model init: {time.perf_counter() - t0:.1f}s")

    plan = QuantPlan.from_layer_bits([4, 4, 4, 8, 8, 8])
    points = [(8, "kernel-int8"), (4, "kernel-int4"),
              (plan, "kernel-mixed[4/4/4/8/8/8]")]
    served = []
    want = dict.fromkeys(tk.KERNELS, 0)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    eng = CoInferenceEngine(model, params, sysp, path="kernel")
    want["group_quantize"] += 1       # one launch quantizes a configure
    for point, path in points:
        eng.configure(point)
        want["group_quantize"] += 1
        assert eng.agent_path == path, (eng.agent_path, path)
        logits, stats = eng.serve_batch({"tokens": tokens})
        alone = [eng.serve_batch({"tokens": tokens[i:i + 1]})[0]
                 for i in range(B)]
        n8, n4 = launches_per_forward(path, cfg)
        want["qmm"] += n8 * (1 + B)
        want["qmm_int4"] += n4 * (1 + B)
        want["flash_attention_fwd"] += cfg.n_layers * (1 + B)
        want["tc_gemm"] += tc_gemm_per_forward(path, cfg) * (1 + B)
        served.append((point, path, logits, alone, stats))
    sol = eng.auto_configure(QosClass("interactive", t0=3.5, e0=2.0))
    assert sol is not None, "(P1) infeasible at T0=3.5s E0=2J"
    if eng.agent_path != "fake":
        want["group_quantize"] += 1
    auto_logits, _ = eng.serve_batch({"tokens": tokens})
    n8, n4 = launches_per_forward(eng.agent_path, cfg)
    want["qmm"] += n8
    want["qmm_int4"] += n4
    want["flash_attention_fwd"] += cfg.n_layers
    want["tc_gemm"] += tc_gemm_per_forward(eng.agent_path, cfg)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    print(f"main path: {time.perf_counter() - t0:.1f}s, launches {counts}")
    assert counts == want, f"launch counts {counts} != expected {want}"
    for name, way in (("qmm", "wgmma"), ("qmm_int4", "wgmma"),
                      ("group_quantize", "vector")):
        routes = getattr(tk, name).route_launches
        assert routes == {way: counts[name], "simt": 0}, (name, routes)
    for name in ("group_quantize", "qmm", "qmm_int4", "flash_attention_fwd",
                 "tc_gemm"):
        assert counts[name] > 0, f"{name} never launched on the main path"
    print(f"auto_configure: b_hat={sol.b_hat} f={sol.f / 1e9:.3f}GHz "
          f"f~={sol.f_server / 1e9:.3f}GHz agent_path={eng.agent_path}")
    assert torch.isfinite(auto_logits).all()

    # the served forward against the plain-version forward on the card
    # (plain quantizer and matmuls, plain attention through the model's
    # attend hook in both stages).  The boundary activation (agent stage
    # output) is held at the kernel tolerance, relative to its scale.  The
    # logits are held at E2E_TOL relative to theirs: the b_emb = 8 uplink
    # quantizer rounds, so a boundary element that sits within the
    # kernels' ~1e-6 relative error of a rounding edge moves by a whole
    # quantization step, and that step reaches the logits through 18
    # server layers.  Each row of the batch is bitwise the request served
    # alone (every kernel of the path is row-independent).
    tok_dev = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    plain_model = plain_lm(cfg)
    for point, path, logits, alone, stats in served:
        eng.configure(point)
        held, _ = hold_against_plain(eng, plain_model, point, path,
                                         logits, tokens, tok_dev)
        for i in range(B):
            assert torch.equal(logits[i], alone[i][0]), \
                f"{path}: batch row {i} != alone, max|d| " \
                f"{float((logits[i] - alone[i][0]).abs().max())}"
        print(f"  {path:26s} {held}; batch rows == alone: bitwise; "
              f"emb_bytes={stats.emb_bytes}")

    # wall time of one served forward per operating point (after the
    # launch counts were read: these launches count nowhere)
    for point, path, *_ in served:
        eng.configure(point)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.serve_batch({"tokens": tokens})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"  {path:26s} serve_batch({B}x{S}) wall "
              f"{statistics.median(walls):.2f} ms (median of 5)")

    # 5. decode attention against its plain version
    t0 = time.perf_counter()
    summary["quantized_decode_attention"] = check_decode_kernel(dev, flush)
    print(f"decode kernel phase: {time.perf_counter() - t0:.1f}s")

    # 6. the row-independent GEMM against its plain version, at qwen2-0.5b's
    # and stablelm-3b's decode shapes, beside the parent's kernel
    t0 = time.perf_counter()
    parent = parent_row_gemm()
    summary["row_gemm"] = check_row_gemm(cfg, dev, flush, parent)
    check_row_gemm(SL_FULL, dev, flush, parent, seed=5)
    print(f"row_gemm phase: {time.perf_counter() - t0:.1f}s")
    # and the split forward's tensor-core GEMM at qwen2-0.5b's and
    # stablelm-3b's server products
    t0 = time.perf_counter()
    summary["tc_gemm"] = check_tc_gemm(cfg, dev, flush)
    check_tc_gemm(SL_FULL, dev, flush, seed=7)
    print(f"tc_gemm phase: {time.perf_counter() - t0:.1f}s")

    # 7. the decode path at full width, through CUDA graphs
    t0 = time.perf_counter()
    decoded, step_wall, engine_wall = decode_path(
        cfg, params, dev, summary["quantized_decode_attention"]["ms"])
    print(f"decode path: {time.perf_counter() - t0:.1f}s")
    for name in ("quantized_decode_attention", "row_gemm"):
        counts[name] = decoded[name]

    # 8. flash attention against its plain version
    t0 = time.perf_counter()
    summary["flash_attention_fwd"], _ = check_flash_kernel(dev, flush)
    print(f"flash kernel phase: {time.perf_counter() - t0:.1f}s")

    # 9. training at full width
    t0 = time.perf_counter()
    flash_train = train_path(cfg, dev)
    print(f"train path: {time.perf_counter() - t0:.1f}s")
    counts["flash_attention_fwd"] += decoded["flash_attention_fwd"] \
        + flash_train

    # 10. compiled batched serving at full width
    t0 = time.perf_counter()
    served, int8_graph = compiled_serving(cfg, model, params, sysp, dev,
                                          tokens)
    print(f"compiled serving: {time.perf_counter() - t0:.1f}s")
    for name in ("group_quantize", "qmm", "qmm_int4", "flash_attention_fwd",
                 "tc_gemm"):
        counts[name] += served[name]

    # 11. the paper's theory and mixed precision at full width
    t0 = time.perf_counter()
    fcdnn_check(dev)
    rate_distortion_check(cfg, params, dev)
    theory = mixed_serving(cfg, model, params, sysp, dev, tokens, int8_graph)
    mixed_dec = mixed_decode(cfg, model, params, dev)
    proxy_forwards(dev)
    for name in counts:
        counts[name] += theory[name] + mixed_dec[name]
    print(f"theory and mixed precision: {time.perf_counter() - t0:.1f}s")

    # 12. speculative decode from CUDA graphs at full width
    t0 = time.perf_counter()
    spec = speculative_path(cfg, params, dev, step_wall, engine_wall)
    for name, n in spec.items():
        counts[name] += n
    print(f"speculative decode: {time.perf_counter() - t0:.1f}s")

    # 13. adaptive serving from CUDA graphs at full width
    t0 = time.perf_counter()
    adapt = adaptive_path(cfg, model, params, sysp, dev)
    for name, n in adapt.items():
        counts[name] += n
    print(f"adaptive serving: {time.perf_counter() - t0:.1f}s")

    # 14. a fleet of three full-width agents of two families
    t0 = time.perf_counter()
    print(f"  {release_memory()}")
    fleet, fleet_specs = fleet_path(cfg, params, dev)
    for name, n in fleet.items():
        counts[name] += n
    print(f"fleet serving: {time.perf_counter() - t0:.1f}s")

    # 15. resilience: supervised serving, crash-recoverable decode,
    # checkpoint/restart training; each part starts from the memory the
    # earlier phases released (a capture that has to free cached memory
    # for its pool is invalidated)
    t0 = time.perf_counter()
    print(f"  {release_memory()}")
    for name, n in resilient_fleet(fleet_specs, dev).items():
        counts[name] += n
    del fleet_specs
    for part in (lambda: resilient_batched(cfg, model, params, sysp, dev),
                 lambda: resilient_decode(cfg, params, dev, False),
                 lambda: resilient_decode(cfg, params, dev, True)):
        print(f"  {release_memory()}")
        for name, n in part().items():
            if name in counts:
                counts[name] += n
    print(f"  {release_memory()}")
    counts["flash_attention_fwd"] += resilient_training(cfg, dev)
    print(f"resilience: {time.perf_counter() - t0:.1f}s")

    # 16. decode at the reference's widths: 32 slots, DECODE_32K, LONG_500K
    t0 = time.perf_counter()
    print(f"  {release_memory()}")
    for name, n in wide_decode(cfg, params, dev).items():
        counts[name] += n
    print(f"wide decode: {time.perf_counter() - t0:.1f}s")

    # 17. the wide dense decoders and the MoE decoders, one at a time
    t0 = time.perf_counter()
    print(f"  {release_memory()}")
    for fam in FAMILIES:
        for name, n in family_path(*fam, dev, flush).items():
            counts[name] += n
    print(f"families: {time.perf_counter() - t0:.1f}s")

    # 18. the recurrent and encoder-decoder families, one at a time
    t0 = time.perf_counter()
    print(f"  {release_memory()}")
    check_flash_recurrent_shapes(dev, flush)
    check_recurrent_cells(dev)
    print(f"  {release_memory()}")
    xlstm_path(dev)
    print(f"  {release_memory()}")
    counts["flash_attention_fwd"] += jamba_path(dev)
    print(f"  {release_memory()}")
    counts["flash_attention_fwd"] += seamless_path(dev)
    print(f"  {release_memory()}")
    print(f"recurrent and encoder-decoder families: "
          f"{time.perf_counter() - t0:.1f}s")

    # 19. training over a mesh of ranks: one NCCL rank, then two gloo
    # ranks on the one card
    t0 = time.perf_counter()
    print(f"  {release_memory()}")
    counts["flash_attention_fwd"] += mesh_one_rank(cfg, dev)
    print(f"  {release_memory()}")
    flash_pods, gathered = mesh_two_ranks(cfg, dev)
    counts["flash_attention_fwd"] += flash_pods
    print(f"training over a mesh: {time.perf_counter() - t0:.1f}s")

    # 20. the serving examples on the card, and the int8-resident forward
    # at full width
    t0 = time.perf_counter()
    for name, n in examples_path(dev).items():
        if name in counts:
            counts[name] += n
    print(f"  serving examples: {time.perf_counter() - t0:.1f}s")
    t1 = time.perf_counter()
    counts["flash_attention_fwd"] += int8_resident_path(dev)
    print(f"  {release_memory()}")
    print(f"  int8-resident forward: {time.perf_counter() - t1:.1f}s")
    print(f"examples and int8-resident forward: "
          f"{time.perf_counter() - t0:.1f}s")

    # 22 (d)'s dry-run needs the host's CPU only: it runs beside 21-22
    dry = start_dryrun()

    # 21. tensor-parallel compute over model, then MoE training over
    # data-parallel ranks, two gloo ranks sharing the card each
    t0 = time.perf_counter()
    print(f"  {release_memory()}")
    counts["flash_attention_fwd"] += tensor_parallel_path(cfg, dev,
                                                          gathered)
    print(f"  {release_memory()}")
    counts["flash_attention_fwd"] += moe_parallel_path(dev)
    print(f"  {release_memory()}")
    print(f"tensor and MoE data parallelism: "
          f"{time.perf_counter() - t0:.1f}s")

    # 22. the dry-run's accounting on the card
    t0 = time.perf_counter()
    print(f"  {release_memory()}")
    print(f"  launches of phases 4-21: {dict(counts)}")
    dryrun_path(cfg, params, sysp, dev, flush, counts, dry)
    print(f"dry-run accounting: {time.perf_counter() - t0:.1f}s")

    # 23. tensor-parallel compute for the hybrid, xLSTM and
    # encoder-decoder families, the hybrid's MoE over data-parallel ranks
    t0 = time.perf_counter()
    print(f"  {release_memory()}")
    counts["flash_attention_fwd"] += family_tp_path(dev)
    print(f"  {release_memory()}")
    print(f"family tensor parallelism: {time.perf_counter() - t0:.1f}s")

    # 24. the sequence-sharded KV cache, notp training and the
    # int8-resident tree over a mesh, two gloo ranks sharing the card
    t0 = time.perf_counter()
    print(f"  {release_memory()}")
    counts["flash_attention_fwd"] += variants_path(cfg, dev)
    print(f"  {release_memory()}")
    print(f"dry-run variants on the card: {time.perf_counter() - t0:.1f}s")

    # 25. summary
    names = {"group_quantize": ("csrc/group_quantize.cu",
                                "src/repro/kernels/quantize.py:35"),
             "qmm": ("csrc/qmm.cu", "src/repro/kernels/qmm.py:67"),
             "qmm_int4": ("csrc/qmm.cu", "src/repro/kernels/qmm.py:140"),
             "quantized_decode_attention": (
                 "csrc/decode_attn.cu",
                 "src/repro/kernels/decode_attn.py:129"),
             "flash_attention_fwd": ("csrc/flash_attn.cu",
                                     "src/repro/kernels/flash.py:93"),
             # the port's own: no TPU kernel; it stands for XLA's batched
             # dot in the reference's decode step
             "row_gemm": ("csrc/row_gemm.cu",
                          "none (port-own; stands for the XLA dots of "
                          "src/repro/models/lm.py:346 decode_step_q)"),
             # the port's own: no TPU kernel; it stands for XLA's dots in
             # the reference's split forward
             "tc_gemm": ("csrc/tc_gemm.cu",
                         "none (port-own; stands for the XLA dots of "
                         "src/repro/models/lm.py:166 run_layers_window)")}
    kernels = []
    for name, (src, replaces) in names.items():
        s = summary[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/{src}", replaces=replaces,
            launches=counts[name], max_abs_err=s["max_abs_err"],
            ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"]))
    # tc_gemm counts its op calls: tc_gemm_kernel once a call, and where
    # the route splits K one tc_gemm_combine after it
    tcg = next(k for k in kernels if k["name"] == "tc_gemm")
    tcg["launches_are"] = "calls; a split-K route adds one tc_gemm_combine"
    print(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
