#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one card

Five main paths, gated block-sparse decoding of qwen3_0_6b at full width
and 16 of its 28 layers (``DECODE_LAYERS``; its training runs all 28):
the contiguous path through ``DecodeEngine.generate`` (kernels
``gate_select`` and ``block_sparse_decode``), the paged continuous-
batching path through ``DecodeEngine.serve`` (kernels
``gate_select_paged`` and ``block_sparse_decode_paged``), the same
``serve`` over int8 page pools, ``DecodeOptions(quantize="int8")``
(kernels ``gate_select_paged`` and ``block_sparse_decode_paged_quant``),
the head-sharded ``serve`` with split-K decode,
``DecodeOptions(split_k=4)`` on an engine with a one-rank NCCL process
group, over fp and int8 pools (kernels ``gate_select_paged`` and
``block_sparse_decode_paged_splitk``, or ``..._splitk_quant``); the rest
of the decode API over the same kernels (Quest with its metadata cache,
the oracle, the sliding window and selection schedules on ``generate``;
Quest over fp and int8 pools and per-request budgets and sampling on
``serve``); the pressure and failure paths of ``serve`` (RaaS page
eviction with ghost rows and replay, over fp, int8 and sharded pools, the
bounded swap tier with its disk spill, fault injection and the open-loop
traffic frontend); and gate distillation training, ``train.loop.run_training`` in distill
mode (kernel ``gate_gt_attention``, TPU kernel 6, on every layer of every
forward). Then the other dense configs of the port at full width,
``gemma_2b`` (MQA 8 x 256), ``granite_20b`` (MQA 48 x 128) and
``deepseek_coder_33b`` (56 / 8 x 128), each cut in depth
(``OTHER_CONFIGS``), through ``generate`` and ``serve`` and, for the
first two, distill training. Then the MoE and vision families
(``FAMILY_CONFIGS``): ``deepseek_moe_16b`` (MHA 16 x 128, 64 experts, top
6) at 2 of its 28 layers through ``generate`` and ``serve``,
``kimi_k2_1t_a32b`` (64 / 8 x 128, 384 experts, top 8) at one layer and
``llama_3_2_vision_11b`` (32 / 8 x 128, a cross-attention layer every 5)
at 5 of its 40 layers through ``generate``. Then the recurrent families
(``RECURRENT_CONFIGS``) at full width: ``zamba2_1_2b`` (38 Mamba2 layers
and a gated shared attention block, MHA 32 x 64, after every 6 of them)
at 14 of its 38 layers (2 of its 6 units) through ``generate`` and
``serve`` (fp, int8, eviction), and ``falcon_mamba_7b`` (Mamba1 layers, no
attention: no kernel runs) at 8 of its 64 layers through ``generate``
and ``serve``, its prompts cut
to 4096 tokens. Then
the distillation of ``deepseek_moe_16b`` (2 layers) and ``zamba2_1_2b``
(kernel 6 on the gated shared block, Dh 64, once a unit), and
pretraining, ``run_training`` in pretrain mode (no kernel: the plain
attention and scans, differentiated, as in the reference): ``qwen3_0_6b``
at full width and half its depth, ``hubert_xlarge`` (the audio encoder)
at full width and a quarter of its depth, and ``falcon_mamba_7b`` cut to 4
layers (``PRETRAIN_CONFIGS``). Last, the
user's entry points: the serving launcher (``repro_torch.launch.serve``)
at full width, the four examples (``repro_torch.examples``) at their own
reduced scale, the head-sharded engine with a selection schedule,
request budgets, sampling and open-loop arrivals, and training under a
``Shard`` (tensor-parallel distillation and pretraining on the one-rank
NCCL group, kernel 6 on the rank's heads; the training launcher under
torchrun's environment); then falcon_mamba_7b, zamba2_1_2b and
deepseek_moe_16b on a sharded engine (the Mamba mixers and their slot
state at the rank's channels or heads, the routed experts
expert-parallel); then the dry-run (``repro_torch.launch.dryrun``),
its predictions over fake tensors held against two real qwen3_0_6b steps;
and last the data axis beside the model axis on one-rank groups.
The contiguous int8 kernel ``block_sparse_decode_quant`` lies on no model
path (in the reference neither): it is checked and timed on the generate
path's layer-0 blocks, quantized per block. Phases (any failure exits
non-zero):

  1. the card's name and power limit (nvidia-smi); build the CUDA kernels
     from ``src/repro_torch/kernels/csrc`` (one nvcc per source, started
     together) and print the build seconds and ptxas register/spill info;
  2. small-input agreement: the tiny config decoded on the card against
     the same engine on the CPU (plain PyTorch path, itself held against
     the JAX reference by the CPU tests): ``generate`` tokens equal and
     logits close; ``serve`` with an ample and a tight (preempting) pool,
     fp and int8 pools, tokens equal and logits close; then the sharded
     paths through the one-rank NCCL group against the same unsharded CPU
     runs: head-sharded ``serve`` (fp at split_k 1 and 2, int8 at split_k
     2, and a preempting pool; the rank's parameter bytes against the sum
     of ``local_shape`` over the layout, and the collectives a decode
     step, printed) and sequence-sharded ``generate``; and the
     tiny config's 3 distill train steps on the card against the CPU's
     from the same state (KL and gate parameters within 1e-4); then each
     other config's ``reduced()`` geometry and a one-layer model at its
     own heads (8 x 256, 48 x 128, 56 / 8 x 128), fp32, card against CPU:
     ``generate`` tokens equal, logits within 1e-4, #1 and #2 at every
     layer and step; at ``reduced()`` also ``serve`` with an ample and a
     preempting pool, the same checks through #3 and #4; the same for the
     family configs (``small_geometries``: the MoE ones also at their
     published routers, whose capacity drops assignments, with ``serve``
     at both geometries; the vision one with the same seeded image
     embeddings on both devices, one unit of a self and a cross layer at
     its own heads, ``generate`` only, #1 and #2 at every self layer);
     then each family's reduced() model (dense, MoE, vision, Mamba1,
     hybrid, audio; ``SMALL_PRETRAIN``) takes one pretrain loss and
     gradient on the card against the CPU: the loss within 1e-5
     relative, every gradient leaf within 1e-4 of its largest entry, the
     leaves the loss does not read zero on both, no kernel launched;
  3. kernel vs plain on the card, on the tensors the main path gives
     layer 0 in its first decode step (captured from a real prefill +
     step): gate select for budget/threshold x force flags x n_valid
     full/partial/1 (ids equal up to swaps of near-tied blocks), the same
     cases on exact ties at the same shapes (integer qg and Kg rows drawn
     from 7 distinct ones: budget ids bitwise the plain version's), and the
     block-sparse decode with -1 padding, a partial last block and a
     peaked softmax (max abs error within 8 bf16 ulps of the plain
     output's largest element, and within 2e-2); each kernel, its plain
     version and the library yardstick timed with CUDA events (median of
     30 runs onto an idle card, the host's enqueue of a call counted
     where it is the longer: see ``time_ms``); #2 must beat dense SDPA so
     timed; for information, the gate select's CTAs and threads, its
     device work with the host's enqueue hidden and its host enqueue, its
     share of the bound at both times and, as context, einsum +
     torch.topk on the same inputs; #2's and SDPA's times with the host's
     enqueue hidden behind a spin kernel, #2's host enqueue of one call,
     its split plan (segments, CTAs), its rate (the bound's bytes over
     its time) and share of the bound at both times, and a sweep of the
     split count;
  4. end to end: ``generate`` on qwen3_0_6b in bf16 with random weights
     from a seed, every launch counter set to 0 just before and read just
     after; each kernel must launch layers x decode steps times; all
     logits finite;
  5. profile, after the timed run so that it cannot slow it: a few decode
     steps before, under and after torch.profiler, the top device kernels,
     the device's busy share and the gate select's device time a call;
  6. serve: ``serve`` on qwen3_0_6b in bf16 (seed-0 weights, 4 slots, six
     requests of 16384/12345/8191/4097/1500/63 numpy-seeded prompt tokens
     and 32/24/40/16/48/8 new tokens), once with the default (ample) pool
     and once with 644 pages, which forces a preemption. Launch counters
     set to 0 just before each run and read just after: each paged kernel
     must launch layers x decode steps times, the contiguous pair never;
     every request retires with its tokens, the active rows' logits are
     finite, the tight run preempts and resumes and reproduces the ample
     run's tokens and logits;
  7. the paged kernels against their plain versions on the tensors layer
     0 of the ample run's first decode step gave them (captured during
     that run), with the decode limit of phase 3, the gate select also on
     exact ties and both bitwise equal over shuffled pages, and timed and
     reported the same way;
     the library yardstick of the paged decode is dense SDPA over the
     slots' ``gather_kv`` view, masked at each slot's length, which #4
     must beat; #4's plan, rate, bound share and sweep as #2's;
  8. serve profile: the four longest requests on 4 slots, torch.profiler
     over three whole decode iterations (model step and host scheduling),
     the top device kernels, the device's busy share and the gate
     select's device time a call;
  9. int8 serve: phase 6's requests and pools with int8 K/V pages; each
     run must launch the int8 paged decode and the paged gate select
     layers x decode steps times and nothing else, swap the int8 bytes plus
     the scale rows (the fp run's bytes in the ratio of the page sizes),
     and reproduce the ample run bitwise under the tight pool; the share
     of tokens equal to the fp run's is printed, for information only;
     then phase 8's profile over int8 pools;
 10. the int8 kernels (2q, 4q: the int8 instances of #2 and #4's body,
     at the same split plan) against their plain versions: the paged one
     on the tensors layer 0 of the int8 ample run's first decode step gave
     it (with the decode limit of phase 3, and bitwise equal over shuffled
     pages), the contiguous one on phase 3's caches quantized per block;
     both timed as in phase 3, with their host-hidden time, host enqueue,
     split plan, rate, bound share and split sweep as #2's. No single
     PyTorch call dequantizes and attends, so their library time is null;
     dense SDPA over a pre-dequantized gathered view is printed for
     context;
 11. sharded serve: phase 6's requests and pools with
     ``DecodeOptions(split_k=4)`` on the one-rank NCCL group
     (4 splits x 8 KV heads x 4 slots = 128 CTAs); each run must launch
     the split-K decode and the paged gate select layers x decode steps
     times and nothing else, preempt and swap as phase 6 did, reproduce
     the ample run bitwise under the tight pool, and measure the same
     sparsity by request as phase 6; its first decode step's logits must
     lie within 8 bf16 ulps of max|logit| of phase 6's (split-K only
     reorders fp32 sums); the share of equal tokens is printed; then phase
     8's profile of the same engine, to set beside phase 8's; the rank's
     parameter bytes (equal to the layout's sum) and the collectives a
     decode step printed;
 12. the same over int8 pools, ample pool only;
 13. kernels 5 and 5q (the paged fp and int8 instances of #4's body at
     the caller's num_splits) against their plain versions on the tensors
     layer 0 of phases 11 and 12's first decode steps gave them, at
     num_splits 2, 4, 8 and nsel + 3, with the decode limit of phase 3,
     bitwise equal over shuffled pages and bitwise equal to #4 / #4q at the
     same num_splits; timed at num_splits 4 and reported as #4 is (time
     with the host hidden, host enqueue, rate, bound share, a sweep of the
     split count); bound = #4's bytes plus the f32 partials written and
     read once; library yardstick (fp) the masked dense SDPA of phase 7;
 14. Quest on generate: phase 4's batch with ``QuestPolicy`` (the
     incremental metadata cache) and with ``QuestRecomputePolicy``, 8
     decode steps each, counters at 0 just before each: only #2 launches,
     28 x steps; the tokens, and every layer's ids in the first decode
     step, bitwise equal between the two; the measured sparsity equal to
     phase 4's; #2 against its plain version on layer 0's Quest lists (score
     order, with -1 holes in the middle, with a budget-masked -1 tail),
     each call timed as in phase 3; the Quest step's wall and device busy
     time as phase 5 takes them;
 15. the oracle, SlidingWindowPolicy(sink_blocks=1), the gate under
     SelectionSchedule(dense_first_n=2, select_layer=2,
     correction_layers=(14,)) and under unify_heads=True, 3 decode steps
     each from copies of one prefilled state: the launches their stages
     predict (gate select at selecting layers only, none under
     unify_heads; #2 at every non-dense layer); the oracle at a budget of
     every block against DensePolicy: at layer 0 every visible block
     selected and #2 over them within phase 3's decode limit of the dense
     decode attention on the same inputs, and the first-step logits
     within 8 bf16 ulps of max|logit| of DensePolicy's (phase 11's rule);
     #2 on layer 0's window lists as in phase 14;
 16. Quest on serve: phase 6's requests with fp pools at the default 1029
     pages and at 644 (which preempts): tight == ample (tokens, logits),
     only #4 launching, the swapped bytes those of phase 6's tight run
     plus each page's two f32 metadata rows; #4 on layer 0's captured Quest
     lists and on window lists for its slots, plain and with holes and
     tails; then once over int8 pools (ample), only 4q launching, 4q on
     its lists likewise, and the share of tokens equal to the fp Quest
     run's (information only);
 17. request overrides on serve: phase 6's requests, rids 0 and 1 capped
     at 1024 tokens, rids 2 and 3 sampling at temperature 0.7, top-k 50,
     top-p 0.9, ample and tight pools: each capped request selects exactly
     16 blocks at every step, the tight run reproduces every request's
     tokens (the stochastic ones too); #4 on the captured capped lists;
     each of phases 14-17 prints its seconds, and its errors join the
     kernels' max_abs_err;
 18. training: ``run_training`` on qwen3_0_6b in bf16 (seed-0 weights),
     distill mode, batch 4 x 4096 tokens (the launcher's sequence; its
     batch 16 cut to 4 to bound time and memory), documents of mean
     length 2048, 4 steps with a checkpoint every 2 and a failure
     injected before step 3. Launch counters set to 0 just before and
     read just after: ``gate_gt_attention`` must launch 28 x the forwards
     run (5: the failed step restores the step-2 checkpoint and replays
     step 2), every other kernel never; every KL finite, the base
     parameters bitwise those of the seed, the gate moved, the replayed
     loss equal; wall time and peak memory printed; the last checkpoint
     (the final state, saved by the port) lists the JAX package's leaves
     in its count, order, shapes and dtypes (derived here from its
     flatten rule, without JAX) and reads back bitwise;
 19. a training step's time before torch.profiler and under it, its top
     device kernels and the device's busy share;
 20. kernel 6 (its bf16 tensor-core body) against its plain version on
     the tensors layer 0 of the first training step gave it, with the
     packed segments and without: o within the decode limit of phase 3,
     blockmax exactly -1e30 in the same places and elsewhere within 1e-4
     of max|blockmax|; kernel and plain timed (median of 10), and causal
     SDPA on the same q/k/v as context (it computes no blockmax and no
     packing mask, so the library time is null); bound from the bytes and
     the causal pairs within documents; the share of (query tile, key
     tile) pairs the kernel skips, and its rate over the operations it
     issues; then the same at 128-key blocks on the same tensors;
 21. each other config (``OTHER_CONFIGS``) at full width, bf16, seed-0
     weights, the decode plan of its group printed (``bsd.group_plan``):
     phase 3's checks and timings of #1, #2 and 2q on layer 0 of its
     ``generate`` (#2 against dense SDPA printed, not required: dense SDPA
     reads one KV head for 8 or 48 query heads); phase 4's ``generate``
     (#1 and #2 layers x steps) and phase 5's profile; phase 6's ``serve``
     (ample and 644 pages, tight == ample, #3 and #4 layers x steps);
     phase 7's checks of #3 and #4, then 5 (phase 13's checks at 2, 4, 8
     and nsel + 3 splits, bitwise #4) on the serve's layer-0 tensors, and
     4q and 5q (phases 10 and 13) on them quantized per page; one JSON
     line of its kernels' numbers;
 22. distill training of gemma_2b (kernel 6 at head dim 256) and
     granite_20b (48 heads on one KV head) at their depths, and (after
     phase 34) of deepseek_moe_16b at 2 layers and zamba2_1_2b at full
     depth (its shared block's 32 KV heads of one query head, Dh 64, 6
     units): 3 steps of 4 x 4096 tokens, kernel 6 gated layers (units) x
     steps and nothing else, KL finite, base frozen, gate moved; phase
     20's check of kernel 6 on the first step's layer-0 (unit-0 shared
     block) tensors, with its device work alone (the host hidden). The
     launches of phases 21-22's main paths join the counts of the kernels
     line, their errors its max_abs_err.

The MoE and vision families (phases 30-32, after phase 22; the launches
of their main paths join the counts of the kernels line, their errors
its max_abs_err):

 30. ``deepseek_moe_16b`` at full width, 2 of its 28 layers, through
     phase 21's steps: #1, #2 and 2q on layer 0 of its ``generate`` (G 1:
     16 KV heads of one query head each); ``generate`` (#1 and #2 2 x 31
     times);
     its profile, with the expert FFN's share of the step's device busy
     time (one layer's ``moe_mlp`` on its captured decode input, the
     host hidden, times the layers) and the floor of the routed experts'
     bytes; ``serve`` at the default pool and at 644 pages, where the
     tight run must equal the ample run, tokens and logits bitwise, only
     up to the first decode step whose (slot, request) set differs (the
     experts' capacity couples the rows of a step, in the reference
     too: ``check_coupled_serve``); #3, #4, 5 at 2, 4, 8 and nsel + 3
     splits, 4q and 5q on the serve's layer-0 tensors;
 31. ``kimi_k2_1t_a32b`` at one layer (G 8 at 8 KV heads, 384 experts),
     its prompt cut to 8192 tokens and its query chunk to 256: the
     layer-0 kernel checks and ``generate`` (#1 and #2 31 times), its
     profile and expert FFN share;
 32. ``llama_3_2_vision_11b`` at 5 of its 40 layers (G 4) with
     numpy-seeded image embeddings: the kernel checks on self layer 0,
     ``generate`` (#1 and #2 4 self layers x 31 steps), its profile, and
     a cross layer's dense decode attention over the 1601 image tokens
     timed (plain PyTorch, as in the reference, SDPA beside it).

The recurrent families (phases 33-34, after phase 32; the launches of
their main paths join the counts of the kernels line, their errors its
max_abs_err). Phase 2 also runs each one's reduced() model (zamba2_1_2b
at 3 layers: a unit and a tail layer; falcon_mamba_7b with 8-token
pages) card against CPU, fp32: ``generate`` tokens equal, logits within
1e-4, #1 and #2 units x steps (none for falcon); ``serve`` ample and at 8
pages, the same checks through #3 and #4, the swapped bytes equal.

 33. ``zamba2_1_2b`` at full width, 14 of its 38 layers (G 1 at 32 KV
     heads, Dh 64, Dg 64; 2 of its 6 units and the tail): phase 3's checks
     and timings of #1, #2 and 2q on unit 0's shared-block tensors of
     ``generate``'s first decode step (#2 against dense SDPA printed, not
     required); ``generate`` (#1 and #2 2 units x 31 steps = 62 times) and
     its profile; ``serve`` with phase 6's requests at the default pool
     and at 644 pages (#3 and #4 2 x decode steps, one preemption swapping the pages and the
     request's recurrent rows, tight == ample bitwise: the rows are not
     coupled); the same over int8 pools (#3 and 4q, the swapped bytes in
     the int8/fp page ratio beside the recurrent rows); eviction under a
     RESIDENT_CAP-page resident cap (replays > 0, bitwise the ample run);
     #3, #4 and 5 at 2, 4, 8 and nsel + 3 splits on the fp serve's
     layer-0 tensors, 4q and 5q on the int8 serve's;
 34. ``falcon_mamba_7b`` at full width, 8 of its 64 Mamba1 layers (no
     attention), its prompts cut to 4096 tokens: ``generate`` (every
     launch counter 0, logits finite) and its profile; ``serve`` at the
     default pool and at the first four cut prompts' pages + 2 (every
     counter 0, tight == ample bitwise, the swapped bytes the preempted
     request's recurrent rows alone).

Pretraining (phases 35-37, last; ``PRETRAIN_CONFIGS``): ``run_training``
in pretrain mode, bf16, the configs' remat (a checkpoint a layer),
weights from seed 0, lr 1e-2, 4 steps, the launch counters at 0 just
before and read just after: no kernel launches; every loss finite; every
leaf the loss reads moved from the seed, every leaf it does not read (the
gate; the audio encoder's embed) bitwise its seed value after AdamW's
weight decay alone; then one step's time before the profiler, one step
under it (top device kernels, device busy) and the peak memory.

 35. ``qwen3_0_6b`` at full width, 14 of its 28 layers, 4 x 4096 tokens, a
     checkpoint every 2 steps and a failure before step 3: the replayed
     step's loss equal, the last checkpoint in the reference's layout
     (its moments fp32 trees shaped like the parameters) and read back
     bitwise;
 36. ``hubert_xlarge`` at full width, 12 of its 48 layers (d 1280, Dh 80,
     non-causal), 16 x 1024 frames, the same checkpoint and failure;
 37. ``falcon_mamba_7b`` cut to 4 of its 64 layers (its weights and
     AdamW's fp32 moments do not fit one card whole), batch 1 x 2048,
     no checkpoint.

The serving launcher, the examples and the sharded engine with every
decode option (phases 38-40, after pretraining), each run with the launch
counters at 0 just before and read just after; their launches join the
kernels line and their kernel errors its max_abs_err:

 38. ``python -m repro_torch.launch.serve``'s ``main`` at full width
     (``LAUNCH_ARGV``: qwen3_0_6b, nothing cut, 4 x 16384 tokens, 32 new,
     GatePolicy at a 4096-token budget), then with ``--policy quest``: #2
     launches 28 x the decode steps, #1 as often under the gate and never
     under Quest; the gate run's own engine holds the seed-0 parameters
     built here bitwise and measures the sparsity printed, and the two
     runs' prefill tokens are equal;
     ms/step and tok/s printed with the card's name and power limit;
 39. each example through its entry point at its own reduced scale
     (bf16, head dim 16, 16-token gate blocks): ``serve_sparse`` (generate;
     ``--paged``; ``--paged --eviction`` at EXAMPLE_EVICT_PAGES pages, which
     evicts; ``--paged --quantize int8``), ``serve_stream``, ``quickstart``
     (QUICKSTART_STEPS) and ``distill_and_eval --size small``
     (DISTILL_STEPS, checkpoints in a temporary directory): each kernel it
     reaches launches, and is held against its plain version on the
     tensors of its first call with the limits of phases 3, 7 and 16 (#1
     and #3 ids bitwise on exact ties, near-tie swaps only on the captured
     inputs); each kernel's first run at that shape timed beside its plain
     version;
 40. the head-sharded engine on the one-rank NCCL group at full width with
     the SHARD_SCHEDULE schedule and phase 17's budgets and sampling on
     phase 6's requests: at split_k 1 tokens and logits bitwise the
     unsharded engine's same run (steps, sparsity and selected blocks by
     request equal); at SPLIT_K the first decode step within DECODE_ULPS
     bf16 ulps; #3, #4 and 5 on the first selecting layer's call (the plan
     the later layers carry, under the budget caps) against their plain
     versions; then phase 29's trace through ``ServingFrontend`` on the
     sharded engine, streaming phase 29's tokens at its steps; the rank's
     parameter bytes and each sharded serve's collectives a decode step
     printed;
 41. training under a ``Shard``, tensor-parallel over the one-rank NCCL
     group (every collective runs; every block is the whole leaf), each
     case SHARD_TRAIN_STEPS steps sharded and unsharded from the same seed
     state on the same batches, every metric, parameter and moment
     bitwise, launch counters at 0 just before the sharded steps and read
     just after: (a) qwen3_0_6b distillation, TRAIN_BATCH x TRAIN_SEQ,
     kernel 6 28 launches a forward; (b) deepseek_moe_16b pretraining,
     expert-parallel, at SHARD_MOE_LAYERS of its 28 layers, SHARD_MOE_SEQ,
     no kernel; (c) zamba2_1_2b distillation at one unit, kernel 6 (Dh 64)
     once a forward; kernel 6 against its plain version on (a)'s and (c)'s
     first call (the rank's heads); the step times side by side with the
     card; (d) ``python -m repro_torch.launch.train`` (LAUNCH_TRAIN_ARGV)
     in a subprocess under a one-rank torchrun environment: exit 0, its
     checkpoint the full tree in the reference's layout;
 42. the recurrent families and expert parallelism on a sharded engine,
     over the one-rank NCCL group at full width and the depths of phases
     30, 33 and 34 (the engine keeps the rank's block of every Mamba mixer
     and routed expert, a one-rank block being the whole leaf):
     falcon_mamba_7b's serve (phase 34's requests at its tight pool,
     preempting) and generate; zamba2_1_2b's serve over fp pools (the
     tight pool), int8 pools, and at split_k 2 over fp and int8 pools, and
     its generate (the shared block's sequence-sharded step);
     deepseek_moe_16b's serve (phase 30's requests, the ample pool), each
     rank computing its experts and gathering their outputs. Each run is
     bitwise phase 30's, 33's or 34's unsharded run of the same requests
     and pool (tokens, every step's logits and the scheduling and swap
     stats), except where the decode is another arithmetic: split_k 2 and
     the hybrid's sequence-sharded generate, whose every step reached from
     equal histories stays within DECODE_ULPS bf16 ulps of the unsharded
     run's (``drift_ulps``). The paged kernels launch layers x steps on
     the hybrid's and the MoE model's serves and nothing launches
     elsewhere; #3, #4, 4q, 5 and 5q on the first call of the hybrid's
     sharded serves against their plain versions (phase 40's checks).
     Printed beside the card: ms a decode step, collectives a decode step
     and their host time, device busy over three profiled steps of each
     model's first serve, the rank's slot-state bytes, its routed-expert
     bytes and its parameter bytes (equal to the layout's sum).
 43. the dry-run (``repro_torch.launch.dryrun``), grounded on the card at
     full width of qwen3_0_6b on the local mesh (one card, no shard): its
     predictions over fake tensors on the CPU (traced in worker processes
     while phase 1 builds the kernels), then the same two cells for
     real. The distill cell (TRAIN_BATCH x TRAIN_SEQ, phase 14's
     size; ``make_train_step``), its state allocated fresh from a
     baseline with nothing else of the phase alive: the predicted
     argument bytes equal the real state's and batch's exactly, the
     step's ``max_memory_allocated`` less the baseline within
     DRYRUN_PEAK_REL of the predicted peak, the predicted kernel calls
     equal the launch counters' deltas over the step (kernel 6: 28). The
     decode cell (BATCH rows at phase 4's context, one ``decode_step``
     with telemetry off on a zeroed cache at PROMPT_LEN tokens, the distill
     cell's parameters): the predicted argument bytes (parameters, decode
     state, token) equal the real ones, the predicted calls of #1 and #2
     the deltas (28 each). For information, each cell's roofline time
     (the largest of its three computed terms) beside the step's
     measured device busy and wall. Last, the record of one production
     cell, kimi_k2_1t_a32b x decode_32k at ``--mesh single``.
 44. the data axis (``sharding.data_model_shards(1, 1)``: a one-rank NCCL
     data group beside a one-rank NCCL model group): qwen3_0_6b
     distillation at phase 14's shape (kernel 6 launched and counted, on
     the data replica's rows, against its plain version) and its
     pretraining at PRETRAIN_CONFIGS' depth (a one-rank data group slices
     no moment and sends no gradient), SHARD_TRAIN_STEPS steps each
     bitwise the unsharded steps; ``generate`` at batch BATCH and at batch
     1 (DATA_GEN_PROMPT-token prompts, DATA_GEN_NEW tokens, DECODE_LAYERS
     layers) bitwise the engine with the model group alone; phase 43's two
     local-mesh cells log no collective. Two NCCL ranks cannot share the
     card: ``check_nccl_cards(2, "nccl")`` must raise.
 45. the MoE's expert dispatch as the reference shards it
     (``phase_moe_dispatch``): deepseek_moe_16b at full width and
     SHARD_MOE_LAYERS layers over the one-rank NCCL data and model groups,
     three ways (MOE_WAYS: the default dispatch with the capacity's slots
     split over data, ``dispatch="shard_map"``, the EP-major layout): a
     distill and a pretrain step (SHARD_TRAIN_STEPS each on SHARD_MOE_SEQ)
     and ``generate`` at batch BATCH (DATA_GEN_PROMPT-token prompts,
     DATA_GEN_NEW tokens), each held against the model-only run (metrics
     within MOE_WAY_REL, tokens equal; bitwise or not is printed), with
     the collectives and all-to-alls a step and their host time; kernel 6
     launched on the distill steps, #1 and #2 on EP-major's generate (the
     others take the sequence-sharded step, no kernel), each held against
     its plain version.

The pressure and failure paths of ``serve`` (phases 23-29) run after
phase 13, on qwen3_0_6b at full width and phase 6's requests unless
stated, each with the launch counters at 0 just before and read just
after: the paged gate select and the decode kernel launch layers x
(decode steps + replayed attempts) times, and their launches join the
kernels line. Under eviction every table handed to the decode kernel is
checked to hold no id past the pool, and the first layer call whose raw
table held ghost ids is captured: #3 over the ghost-extended Kg pool
(near-tie swaps only, bitwise on exact ties) and the decode kernel over
the clamped table (phase 3's limit) against their plain versions, their
errors joining max_abs_err.

 23. RaaS page eviction, ``EvictionConfig()``, at 644 pages: tokens and
     every step's logits bitwise phase 6's ample run, no more preemptions
     than phase 6's tight run; evictions, restores, replays, ghost rows
     used, swapped bytes and ms/step printed;
 24. eviction under a resident cap of RESIDENT_CAP pages a request, the
     default pool: replays > 0, no ``restore_thrash``, bitwise phase 6's
     ample run; #3 and #4 on the captured ghost call;
 25. int8 eviction under the cap at 644 pages, against phase 9's ample
     run: logits within 8 bf16 ulps of max|logit| (phase 11's rule) up to
     each request's first differing token, the equal-token share printed
     (a replay requantizes the trailing page from its codes, in the
     reference too); #3 and 4q on the captured ghost call;
 26. sharded eviction under the cap at 644 pages (split_k 4, the one-rank
     NCCL group): over fp pools bitwise phase 11's sharded ample run, over
     int8 pools held to phase 12's by phase 25's rule; #3 and 5 / 5q on
     the captured ghost call;
 27. a bounded swap tier (a host bound of SWAP_HOST_BYTES under the
     preempted request's bytes, a temporary disk tier) at 644 pages: the
     request goes through the disk tier and resumes bitwise phase 6's
     ample run; the pinned and pageable host <-> device copy rates printed
     beside the swap cost model's ``offload.PCIE_BW``;
 28. a fault storm (FAULT_PLAN over ``page_alloc``, swap put/pop and
     ``logits``) over phase 6's requests with prompts of at most 4097
     tokens at FAULT_PAGES pages: serve() returns, at least one request
     fails alone with its partial tokens, the others are bitwise the run
     without faults;
 29. the traffic frontend: a seeded Poisson trace of 16 requests in two
     SLO tiers (``default_tiers``) through ``ServingFrontend`` with
     streaming, twice: the same streams at the same virtual steps; TTFT
     and TPOT p50/p99 by tier, in steps and ms, printed.

The line before the last is a JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device, or outside the repository, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

# torch.profiler (Kineto) leaves CUPTI's callbacks subscribed after a
# profiled window unless it is told to tear CUPTI down, and every launch
# after the first window then pays for them: a host-bound step grows by
# that much for the rest of the run. Set before torch is imported
os.environ.setdefault("TEARDOWN_CUPTI", "1")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.config import (MoEConfig, OptimConfig, ShapeConfig, TrainConfig,  # noqa: E402
                                reduced)
from repro_torch.convert import params_to, train_state_to  # noqa: E402
from repro_torch.core.policy import (STAGE_DENSE, STAGE_SELECT, DecodeOptions,  # noqa: E402
                                     DensePolicy, OraclePolicy, QuestPolicy,
                                     QuestRecomputePolicy, SelectionInputs,
                                     SelectionSchedule, SlidingWindowPolicy)
from repro_torch.distributed.sharding import (Shard, check_nccl_cards,  # noqa: E402
                                              data_model_shards, decode_layout, local_shape,
                                              state_layouts)
from repro_torch.examples import (distill_and_eval, quickstart, serve_sparse,  # noqa: E402
                                  serve_stream)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import specs as dryrun_specs  # noqa: E402
from repro_torch.data.pipeline import DataState, image_embeds, make_batch  # noqa: E402
from repro_torch.kernels import block_sparse_decode as bsd  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import gate_gt_fwd as gt  # noqa: E402
from repro_torch.kernels import gate_select as gs  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.common import decode_attention  # noqa: E402
from repro_torch.models.registry import get_api  # noqa: E402
from repro_torch.models.transformer import init_lm, n_self_layers  # noqa: E402
from repro_torch.core.policy import default_tiers  # noqa: E402
from repro_torch.serve import offload, traffic  # noqa: E402
from repro_torch.serve import paging as pg  # noqa: E402
from repro_torch.serve.engine import DecodeEngine  # noqa: E402
from repro_torch.serve.eviction import EvictionConfig  # noqa: E402
from repro_torch.serve.faults import FaultInjector  # noqa: E402
from repro_torch.serve.frontend import ServingFrontend  # noqa: E402
from repro_torch.serve.offload import SwapConfig  # noqa: E402
from repro_torch.serve.sampling import SamplingParams  # noqa: E402
from repro_torch.serve.scheduler import pages_needed  # noqa: E402
from repro_torch.train import loop as tl  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
DECODE_TOL = 2e-2          # absolute cap on the decode kernel's error ...
DECODE_ULPS = 8            # ... which must also stay within this many ulps
                           # of max|o_plain| in the output dtype
TIE_REL = 1e-5            # a gate-select swap is accepted only below this gap
# the main path: batch 4, a 16384-token prompt, 32 tokens per row (1 from
# prefill + 31 decode steps), random weights and prompt from seed 0
BATCH, PROMPT_LEN, NEW_TOKENS, SEED = 4, 16384, 32, 0
# the serve phase: 4 slots, six requests (prompt tokens, new tokens) with
# prompts from numpy seed 1, run with the default pool and with 644 pages
# (the first four prompts' 642 pages, the null page and one more), which
# the scheduler alone predicts to cost 62 decode steps either way and one
# preemption (and resume) of the 16384-token request in the tight run
SERVE_SLOTS, SERVE_SEED, TIGHT_PAGES = 4, 1, 644
SERVE_SPECS = ((16384, 32), (12345, 24), (8191, 40), (4097, 16), (1500, 48), (63, 8))
# qwen3_0_6b's decode phases (3-17 and 23-29, and phase 40, which holds
# its frontend to phase 29's stream) run 16 of its 28 layers: the host's
# per-layer glue sets their time, and the script must stay inside its
# limit (full depth until the sharded engine's per-layer collectives
# joined the script). Phase 40's schedule corrects at layer 14, so 15 at
# the least. Training and the launcher keep all 28.
DECODE_LAYERS = 16
# the sharded serve phase: split-K over 4 segments (4 x 8 KV heads x 4
# slots = 128 CTAs on the 132 SMs); kernels 5/5q checked at these splits
SPLIT_K = 4
SPLITS_CHECKED = (2, 4, 8)          # and nsel + 3 (empty segments)
# the training phase: distill mode at full width, batch 4 x 4096 tokens
# (the launcher's seq; its batch 16 cut to 4), documents of mean length
# 2048, 4 steps, a checkpoint every 2 and one failure injected before step 3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 4, 4096, 4, 2, 3
DRYRUN_PEAK_REL = 0.10    # phase 43: the distill step's measured peak within this share
GT_BM_REL = 1e-4          # kernel 6's blockmax: error within this share of max|blockmax|
# the decode API phases: Quest on generate (phase 4's batch, 8 decode
# steps), the other policies and schedules (3 steps each, from one
# prefill), and serve with two requests capped at 1024 tokens (16 blocks)
# and two sampling at temperature 0.7, top-k 50, top-p 0.9
QUEST_NEW, POLICY_STEPS = 9, 3
OVERRIDE_BUDGET = 1024
OVERRIDE_SAMPLING = SamplingParams(temperature=0.7, top_k=50, top_p=0.9)
# the other dense configs, each at full width (widths, heads, head dim,
# d_ff, vocab and gate as in its file), bf16, weights from seed 0, on the
# main path's generate and serve cells; the one cut: granite_20b (52
# layers, 56 GB of bf16 weights) and deepseek_coder_33b (62 layers, 66 GB)
# to 2 layers, so that weights, caches and prefill fit one card and the
# time limit (their prefill keeps the config's query chunks of 1024: the
# fp32 scores of a chunk over 16384 keys, 13-15 GB at 48 and 56 heads,
# fit beside them; 8 layers until the MoE and vision phases joined the
# script, 4 until phase 41 did); gemma_2b runs 5 of its 18 layers (all 18
# until the launcher, example and sharded-option phases 38-40 joined the
# script, 9 until phase 41 did)
OTHER_CONFIGS = {
    "gemma_2b": dict(num_layers=5),
    "granite_20b": dict(num_layers=2),
    "deepseek_coder_33b": dict(num_layers=2),
}
# distill training of gemma_2b (kernel 6 at head dim 256) and granite_20b
# (its 48-head MQA group, head pairs) at those depths: the qwen3 phase's
# batch 4 x 4096 tokens (the launcher's batch 16 cut to 4), 3 steps, no
# checkpoint; then kernel 6 at 128-key blocks on qwen3_0_6b's tensors
# the MoE and vision families (phases 30-32), each at full width (widths,
# heads, experts and router as in its file), bf16, weights from seed 0:
# deepseek_moe_16b cut to 2 of its 28 layers on the generate and serve
# cells; kimi_k2_1t_a32b cut to one layer (its 384 experts hold 33.8 GB a
# layer) on generate alone, with its prompt cut to 8192 tokens and its
# query chunk to 256 (the prefill's expert buffers grow with batch x
# prompt x top-k rows of 7168, the fp32 scores with 64 heads x chunk x
# prompt); llama_3_2_vision_11b cut to 5 of its 40 layers (one unit of 4
# self layers and a cross layer) on generate alone (the reference has no
# paged step for cross-attention), with numpy-seeded image embeddings.
# deepseek_moe_16b and llama_3_2_vision_11b ran at full depth until the
# recurrent phases 33-34 joined the script (deepseek_moe_16b at 8 until
# the launcher, example and sharded-option phases 38-40 joined it, both
# at 4 and 10 until phase 41 did): their depth was cut so that the script
# stays inside its time limit
FAMILY_CONFIGS = {
    "deepseek_moe_16b": dict(num_layers=2),
    "kimi_k2_1t_a32b": dict(num_layers=1, q_chunk=256),
    "llama_3_2_vision_11b": dict(num_layers=5),
}
FAMILY_PROMPT = {"kimi_k2_1t_a32b": 8192}
FAMILY_SERVE = ("deepseek_moe_16b",)
# the recurrent families (phases 33-34), each at full width (widths, state
# sizes, heads and gate as in its file), bf16, weights from
# seed 0: zamba2_1_2b (38 Mamba2 layers in 6 units of 6 and a tail of 2,
# the gated shared attention block after each unit: 32 KV heads of one
# query head, Dh 64, Dg 64; 2.34 GB of bf16 weights) on the generate cell
# and on serve with phase 6's requests (fp at both pools, int8, eviction
# under RESIDENT_CAP); falcon_mamba_7b (64 Mamba1 layers, 14.56 GB, no
# attention: no kernel runs on its paths) cut to 8 layers (RECURRENT_CUTS;
# full depth until the pretrain phases 35-37 joined the script, 32 until
# phases 38-40 did, 16 until phase 41 did: the script must stay inside its
# time limit) and zamba2_1_2b cut to 14 layers, 2 of its 6 units and the
# tail (full depth until phases 38-40 joined the script, 20 until phase 41
# did) on generate and serve, falcon's
# prompts cut to FAMILY_PROMPT tokens (the plain PyTorch selective scan's
# log-depth rounds over [batch, 256, 8192, 16] fp32 chunks take most of
# its prefill) and its tight pool the first four cut prompts' pages, the
# null page and one more (``tight_pool_pages``), as phase 6's 644
RECURRENT_CONFIGS = ("zamba2_1_2b", "falcon_mamba_7b")
# phase 42: the configs it runs on a sharded engine, at the depths of
# phases 30, 33 and 34, and those phases' unsharded runs it holds them to
SHARDED_FAMILIES = ("falcon_mamba_7b", "zamba2_1_2b", "deepseek_moe_16b")
BASE_RUNS: dict = {}
SHARDED_SPLIT_K = 2
RECURRENT_CUTS = {"falcon_mamba_7b": dict(num_layers=8), "zamba2_1_2b": dict(num_layers=14)}
FAMILY_PROMPT["falcon_mamba_7b"] = 4096
# distill training (phase 22) also runs deepseek_moe_16b at the 2 layers
# of FAMILY_CONFIGS and zamba2_1_2b at full depth (kernel 6 on the shared
# block's 32 KV heads of one query head, Dh 64, once a unit)
OTHER_TRAIN = ("gemma_2b", "granite_20b", "deepseek_moe_16b", "zamba2_1_2b")
OTHER_TRAIN_STEPS = 3
GT_BLOCK_BIG = 128
# the pressure and failure paths of serve (phases 23-29), on the serve
# phase's requests unless stated. RESIDENT_CAP pages a request on the card
# under eviction: under the 64 blocks each head selects a step, so the
# pages evicted to meet it before a request's first decode step are
# selected, and that step is replayed after their restore. The bounded
# swap tier holds SWAP_HOST_BYTES on the host, under the tight run's
# 3,787,456,512 swapped bytes, so the preempted request goes to disk.
RESIDENT_CAP = 16
SWAP_HOST_BYTES = 1 << 30
# the fault storm: the requests with prompts of at most 4097 tokens, at the
# pool of their prompts' 65 + 24 + 1 pages and the null page (the first
# page growth preempts), faults planned at every serve site: a stalled
# admission and a failed growth (page_alloc), a transient swap put and pop
# (retried), a non-finite logits row (the request fails alone)
FAULT_PAGES = 91
FAULT_PLAN = {"page_alloc": [1, 4], "swap_put": [0], "swap_pop": [0], "logits": [3]}
# the frontend: 16 requests on a seeded Poisson trace at 0.5 a decode
# step, prompts of 64-4096 tokens and 8-48 new ones, a quarter in the
# latency tier (reserved pages, priority, a budget of 4 x 4096 tokens), the
# rest in the throughput tier (lazy, 4096 tokens), default_tiers
TRAFFIC_N, TRAFFIC_RATE, TRAFFIC_SEED = 16, 0.5, 3
TRAFFIC_PROMPT, TRAFFIC_OUTPUT = (64, 4096), (8, 48)
TRAFFIC_TIERS = {"latency": 0.25, "throughput": 0.75}
# pretraining (phases 35-37), bf16 with the configs' remat
# ("nothing_saveable": a checkpoint a layer), weights from seed 0:
# {arch: (cuts, batch, sequence, checkpoints and an injected failure)}.
# qwen3_0_6b at full width, 14 of its 28 layers (full depth until phase 41
# joined the script), the distill phase's 4 x 4096 tokens (its tied
# 151936-token logits in fp32, 10 GB, are the largest tensor);
# hubert_xlarge at full width, 16 x 1024 frames (the same 16384
# a step; a row is 20 s of audio at HuBERT's 50 frames a second, near the
# 250k-sample, 15.6 s crops it pretrains on); falcon_mamba_7b cut to 4 of its 64
# layers and batch 1 x 2048 (its 7.3 G parameters with AdamW's two fp32
# moments, 87 GB, do not fit one card), steps only. The learning rate is
# 1e-2 so that every leaf the loss reads moves in bf16 on the first step
# (a norm's scale of 1.0 moves by lr, and bf16 holds 1 - 2**-8 below it).
# hubert_xlarge ran at full depth until phases 38-40 joined the script,
# at 24 layers until phase 41 did; it runs a quarter of its layers so that
# the script stays inside its limit
PRETRAIN_CONFIGS = {
    "qwen3_0_6b": (dict(num_layers=14), 4, 4096, True),
    "hubert_xlarge": (dict(num_layers=12), 16, 1024, True),
    "falcon_mamba_7b": (dict(num_layers=4), 1, 2048, False),
}
PRETRAIN_STEPS, PRETRAIN_LR = 4, 1e-2
# the serving launcher (phase 38): its command line at full width, nothing
# cut, the main path's batch, prompt and new tokens, GatePolicy at a
# 4096-token budget (then --policy quest)
LAUNCH_BUDGET = 4096
LAUNCH_ARGV = ["--arch", "qwen3_0_6b", "--batch", str(BATCH), "--prefill", str(PROMPT_LEN),
               "--new", str(NEW_TOKENS), "--budget", str(LAUNCH_BUDGET)]
# the examples (phase 39), each at its own reduced scale: serve_sparse's
# undersized pool under eviction (its ragged requests need 34 pages at
# its default pool of 39), quickstart's pretrain and distill steps (a few:
# its kernels' first calls and launches are what is checked) and
# distill_and_eval's steps (a checkpoint at step 50)
EXAMPLE_EVICT_PAGES = 20
QUICKSTART_STEPS = (4, 4)
DISTILL_STEPS = 60
# the sharded engine with every decode option (phase 40): the dense 2 /
# select 2 / correction 14 schedule on phase 17's overridden requests
SHARD_SCHEDULE = SelectionSchedule(dense_first_n=2, select_layer=2, correction_layers=(14,))
# phase 2's small pretrain agreement: every family's reduced() model
SHARD_TRAIN_STEPS = 2                 # phase 41: steps a case, sharded and not
SHARD_MOE_LAYERS = 2                  # of deepseek_moe_16b's 28
# phase 44's generate over the data axis: prompt tokens, new tokens (one
# batch of BATCH rows and one of 1, at DECODE_LAYERS layers)
DATA_GEN_PROMPT, DATA_GEN_NEW = 2048, 8
SHARD_MOE_SEQ = (1, 2048)             # its pretraining batch, rows x tokens
# phase 45's three ways of the MoE's dispatch: name -> (dispatch, EP-major)
MOE_WAYS = {"slot ranges": ("gspmd", False), "shard_map": ("shard_map", False),
            "ep_major": ("shard_map", True)}
MOE_WAY_REL = 1e-3     # a way's metrics against the model-only run's, where not bitwise
LAUNCH_TRAIN_ARGV = ["--arch", "qwen3_0_6b", "--reduced", "--steps", "4", "--ckpt-every", "2"]
SMALL_PRETRAIN = ("qwen3_0_6b", "deepseek_moe_16b", "llama_3_2_vision_11b",
                  "falcon_mamba_7b", "zamba2_1_2b", "hubert_xlarge")


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


_SPIN_PER_MS = []


def spin_cycles_per_ms() -> float:
    """Cycles of torch.cuda._sleep (a spin kernel) per ms on this card."""
    if not _SPIN_PER_MS:
        n = 10_000_000
        torch.cuda._sleep(n // 10)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(n)
        b.record()
        b.synchronize()
        _SPIN_PER_MS.append(n / a.elapsed_time(b))
    return _SPIN_PER_MS[0]


def time_ms(fn, runs: int = 30, warmup: int = 3, hide_host: bool = False) -> float:
    """Median time of one call, from CUDA events around each call the host
    enqueues onto an idle card: where the host's enqueue of the call is
    longer than its device work, as for a decode kernel of a few tens of
    us, the host's part counts. Every recorded ``ms``, the table of
    PERF.md and every check here use this.

    ``hide_host`` (printed beside #2's and #4's times, for information
    only): a spin kernel holds the card busy while the host enqueues each
    call (twice the host's enqueue time of one call), so the events see
    the call's device work back to back and not the host's launch
    overhead."""
    for _ in range(warmup):
        fn()
    spin = 0
    if hide_host:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        spin = int((2 * host_ms + 0.05) * spin_cycles_per_ms())
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare_ids(k_idx, p_idx, scores):
    """-> (swaps, max |score gap| over differing slots). Fails unless every
    difference is a swap of two blocks whose plain fp32 scores differ by
    less than TIE_REL relative."""
    k_idx, p_idx, scores = (t.cpu().numpy() for t in (k_idx, p_idx, scores))
    if k_idx.shape != p_idx.shape:
        fail(f"gate_select shape {k_idx.shape} != plain {p_idx.shape}")
    swaps, gap = 0, 0.0
    for pos in zip(*np.nonzero(k_idx != p_idx)):
        a, b = int(k_idx[pos]), int(p_idx[pos])
        if a < 0 or b < 0:
            fail(f"gate_select differs at {pos}: kernel {a}, plain {b}")
        sa, sb = float(scores[pos[:-1] + (a,)]), float(scores[pos[:-1] + (b,)])
        if abs(sa - sb) > TIE_REL * max(abs(sa), abs(sb), 1e-30):
            fail(f"gate_select differs at {pos}: kernel {a} ({sa}), plain {b} ({sb})")
        swaps += 1
        gap = max(gap, abs(sa - sb))
    return swaps, gap


def tie_inputs(qg, kg, seed: int = 0):
    """Integer-valued copies of a gate select's qg and Kg (contiguous [B,
    Hkv, nb, Dg], or a pool [P, Hkv, Dg]) in their dtype: values in [-3, 3],
    exact in bf16, and every dot an integer below 2**24, so the scores are
    exact in any summation order; each (b, kv-head)'s rows (a pool's: all
    rows) drawn from 7 distinct ones, so many blocks tie exactly."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randint(-3, 4, tuple(qg.shape), generator=g)
    if kg.dim() == 4:
        b, h, nb, dg = kg.shape
        rows = torch.randint(-3, 4, (b, h, 7, dg), generator=g)
        k = rows[:, :, torch.randint(0, 7, (nb,), generator=g)]
    else:
        rows = torch.randint(-3, 4, (7,) + tuple(kg.shape[1:]), generator=g)
        k = rows[torch.randint(0, 7, (kg.shape[0],), generator=g)]
    return q.to(qg.device, qg.dtype), k.to(kg.device, kg.dtype)


def gate_cases(name, kernel, plain, scores, nv, nb, gcfg, exact=False, shuffled=None):
    """#1 or #3 against its plain version, each called as ``fn(n_valid,
    cfg)``, over budget/threshold x force flags x n_valid full/partial/1:
    ids equal up to swaps of near-tied blocks (compare_ids, against
    ``scores(n_valid, cfg)``), or, ``exact`` (inputs whose scores are
    exact), bitwise for the budget method; given ``shuffled`` (the kernel
    over pools whose pages are shuffled under the table), bitwise equal to
    it. Returns (cases, swaps, largest swap gap)."""
    checks = swaps = 0
    gap = 0.0
    part = torch.clamp(nv // 2 + 1, max=nb).to(torch.int32)
    for method in ("budget", "threshold"):
        for ff, fl in ((True, True), (False, True), (False, False)):
            c = dataclasses.replace(gcfg, method=method, always_first_block=ff,
                                    always_last_block=fl)
            for n_valid in (nv, part, torch.ones_like(nv)):
                k_idx, p_idx = kernel(n_valid, c), plain(n_valid, c)
                same = None if shuffled is None else torch.equal(k_idx, shuffled(n_valid, c))
                torch.cuda.synchronize()
                if same is False:
                    fail(f"{name}: shuffled pages changed the ids")
                if exact and method == "budget":
                    if not torch.equal(k_idx, p_idx):
                        fail(f"{name}: ids differ from plain on exact ties (budget, force "
                             f"first {ff}, last {fl}, n_valid {n_valid.tolist()})")
                else:
                    sw, gp = compare_ids(k_idx, p_idx, scores(n_valid, c))
                    swaps += sw
                    gap = max(gap, gp)
                checks += 1
    return checks, swaps, gap


def report_gate(name, t_k, call, nbytes, b_ms, ctas, context):
    """Gate select's CTAs and threads, its share of the bound at the
    recorded time ``t_k`` and with the host's enqueue hidden, the host's
    enqueue of one call, and, for context only, ``context`` (einsum +
    torch.topk: two calls, no mask, pins or cutoff) with the host hidden.
    (``src/repro_torch/launch/gate_phases.py`` splits its device time by
    phase and CTA size.)"""
    t_dev = time_ms(call, hide_host=True)
    t_host = host_enqueue_ms(call)
    t_ctx = time_ms(context, hide_host=True)
    share = lambda t: f"{100 * b_ms / t:.2f}% of the bound"
    print(f"{name}: {ctas} CTAs of {gs.cta_threads()} threads; {nbytes / 1e6:.3f} MB; at "
          f"the recorded {t_k:.4f} ms {share(t_k)}; device work alone (host enqueue hidden) "
          f"{t_dev:.4f} ms {share(t_dev)}; host enqueue of one call {t_host:.4f} ms; context, "
          f"einsum + torch.topk (device work alone): {t_ctx:.4f} ms")


def gate_profile(kernels, steps: int) -> str:
    """Gate select's per-call device time in a profile's device kernels."""
    g = [e for e in kernels if "gate_select_kernel" in e.key]
    n = sum(e.count for e in g)
    t = sum(e.self_device_time_total for e in g)
    if n == 0:
        fail("the profile holds no gate select kernel")
    return (f"gate select {t / n:.2f} µs a call, {n / steps:.0f} calls and "
            f"{t / 1e3 / steps:.3f} ms of device time a step")


def decode_limit(o_plain):
    """-> (limit, ulp, max|o_plain|). The limit is DECODE_ULPS units in the
    last place of max|o_plain| in the output dtype, capped at DECODE_TOL.
    Kernel and plain both round fp32 results to that dtype, so they may
    differ by about one such ulp; a fault in the mathematics (a wrong
    rescale or scale factor, a skipped block) moves the output by a
    fraction of its own size, far more than a few ulps."""
    top = float(o_plain.float().abs().max())
    ulp = torch.finfo(o_plain.dtype).eps * 2.0 ** math.floor(math.log2(top)) if top > 0 else 0.0
    return min(DECODE_TOL, DECODE_ULPS * ulp), ulp, top


def bound_ms(nbytes, ops_n):
    """-> (least ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the bf16 tensor-core rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_n / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def gate_work(qg, nv, k_sel):
    """(bytes, operations) of gate select: q, the visible Kg rows, n_valid
    and the ids written."""
    es = qg.element_size()
    b, h, dg = qg.shape
    rows = int(nv.sum().item()) * h
    nbytes = qg.numel() * es + rows * dg * es + nv.numel() * 4 + b * h * k_sel * 4
    return nbytes, 2 * rows * dg


def gate_bound_ms(qg, nv, k_sel):
    return bound_ms(*gate_work(qg, nv, k_sel))


def decode_work(q, idx, kv_len, block_size, kv_es=None):
    """(bytes, operations) of the block-sparse decode: q and the output,
    the ids, kv_len, and the K and V rows of the valid tokens of the
    selected blocks (what this run's data needs). ``kv_es`` is the K/V
    element size when it is not q's; int8 K/V (kv_es 1) also read a K and
    a V f32 scale for each selected block that holds valid tokens."""
    es = q.element_size()
    b, h, g, dh = q.shape
    ix = idx.long().cpu()
    lens = kv_len.long().cpu()[:, None, None]
    tokens = torch.clamp(lens - ix * block_size, 0, block_size)
    tokens = torch.where(ix >= 0, tokens, 0)
    n_tok = int(tokens.sum())
    kv_bytes = 2 * n_tok * dh * (kv_es or es)
    if kv_es == 1:
        kv_bytes += 8 * int((tokens > 0).sum())
    nbytes = 2 * q.numel() * es + idx.numel() * 4 + b * 4 + kv_bytes
    return nbytes, 4 * g * dh * n_tok


def paged_decode_work(q, idx, kv_len, block_size, kv_es=None, num_splits=1):
    """(bytes, operations): the contiguous decode's work plus one 4-byte
    page-table entry for each distinct (slot, block) that holds valid
    tokens; split-K (``num_splits`` > 1, kernels 5/5q, whose partials the
    reference's entry point writes too) adds its f32 partials (acc [G, Dh],
    m and l [G] per segment), written once and read once."""
    nbytes, ops_n = decode_work(q, idx, kv_len, block_size, kv_es)
    ix = idx.long().cpu()
    live = (ix >= 0) & (ix * block_size < kv_len.long().cpu()[:, None, None])
    b, hkv, g, dh = q.shape
    keys = torch.where(live, torch.arange(b)[:, None, None] * (1 << 32) + ix, -1)
    n_entries = int(torch.unique(keys[keys >= 0]).numel())
    if num_splits > 1:
        nbytes += 2 * b * hkv * num_splits * (g * dh + 2 * g) * 4
    return nbytes + 4 * n_entries, ops_n


def paged_decode_bound_ms(q, idx, kv_len, block_size, kv_es=None, num_splits=1):
    return bound_ms(*paged_decode_work(q, idx, kv_len, block_size, kv_es, num_splits))


SPLIT_SWEEP = (1, 2, 4, 8, 16, 32)


def host_enqueue_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    """Median host time of one call onto an idle card: perf_counter around
    the call, the card synchronised before it and after it, not inside."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return float(np.median(times))


def report_decode(name, q, idx, t_k, t_dev, nbytes, b_ms, kernel, ns=None):
    """The sm90 decode body's split count (the split plan's for #2, #4 and
    the int8 2q, 4q, whose ``nbytes`` count 1-byte K/V and their scales;
    the caller's ``ns`` for 5, 5q), its achieved rate (the bound's bytes
    over the time) and share of the bound, at the recorded time ``t_k`` and
    at the time with the host's enqueue hidden ``t_dev``, the host's
    enqueue of one call, and, for information, a sweep of the split count,
    ``kernel(num_splits)`` timed with the host hidden."""
    b, hkv, g, dh = q.shape
    nsel = idx.shape[-1]
    what = "split plan" if ns is None else "num_splits (the caller's)"
    if ns is None:
        ns = bsd.split_plan(b, hkv, nsel, bsd.n_sm(q.device))
    segs = bsd.split_segments(nsel, ns)
    plan = bsd.group_plan(g, dh, 64, q.dtype)   # the CTAs over the group and the head
    cut = plan["ngc"] * plan["ncs"]
    cuts = f" x {cut} (gp {plan['gp']} rows a CTA)" if cut > 1 else ""
    t_host = host_enqueue_ms(kernel)
    sweep = {n: time_ms(lambda n=n: kernel(n), hide_host=True) for n in SPLIT_SWEEP}
    rate = lambda t: f"{nbytes / (t * 1e-3) / 1e9:.1f} GB/s, {100 * b_ms / t:.1f}% of the bound"
    print(f"{name}: {what} {ns} segments of {segs[0][1] - segs[0][0]} entries "
          f"({b * hkv * ns * cut} CTAs, B {b} x Hkv {hkv} x {ns}{cuts}, "
          f"on {bsd.n_sm(q.device)} SMs"
          f"{'' if ns == 1 else ', + 1 combine launch'}); {nbytes / 1e6:.2f} MB: at the "
          f"recorded {t_k:.4f} ms {rate(t_k)}; with the host's enqueue hidden {t_dev:.4f} ms "
          f"{rate(t_dev)}; host enqueue of one call {t_host:.4f} ms; sweep (information "
          f"only, host hidden): " + ", ".join(f"{n} splits {t:.4f} ms" for n, t in sweep.items()))
    return ns


def decode_cases(q, idx, thr=None):
    """The decode checks' inputs, as (label, q, ids): the captured
    selection, its second half set to -1 padding, a threshold selection
    (natural -1 padding) when given, and the captured selection with q x 8
    (exact in bf16), whose peaked softmax leans on the running-max
    rescale."""
    pad = idx.clone()
    pad[:, :, idx.shape[-1] // 2:] = -1
    cases = [("captured", q, idx), ("half -1 padding", q, pad)]
    if thr is not None:
        cases.append(("threshold", q, thr))
    return cases + [("q x 8", q * 8, idx)]


def check_decode(name, kernel, plain, cases, shuffled=None):
    """A decode kernel against its plain version, both called as
    ``fn(q, ids)``, over ``cases``: within decode_limit, and, given
    ``shuffled`` (the kernel over pools whose physical pages are shuffled
    under the table), bitwise equal to it. Returns the largest error."""
    worst = 0.0
    for label, qq, ix in cases:
        o_k, o_p = kernel(qq, ix), plain(qq, ix)
        same = None if shuffled is None else torch.equal(o_k, shuffled(qq, ix))
        torch.cuda.synchronize()
        if same is False:
            fail(f"{name} [{label}]: shuffled pages changed the output")
        err = float((o_k.float() - o_p.float()).abs().max())
        lim, ulp, top = decode_limit(o_p)
        print(f"{name} [{label}, {int((ix < 0).sum())} padding slots]: max abs err {err:.3e} = "
              f"{err / ulp if ulp else 0.0:.3g} ulp of max|o_plain| {top:.4f} (limit {lim:.3e} "
              f"= min({DECODE_ULPS} ulp, {DECODE_TOL}))"
              + ("; shuffled pages bitwise equal" if same else ""))
        if not err <= lim:
            fail(f"{name} disagrees with plain [{label}]: {err} > {lim}")
        worst = max(worst, err)
    return worst


def shuffled_pages(table, *pools):
    """(table, *pools) with the pools' physical pages permuted under a
    remapped table (page 0, the trash page, stays): a kernel that reads
    through the table must give the same bits. The permutation is seeded,
    so two calls over pools of one size agree."""
    n = pools[0].shape[0]
    perm = torch.cat([torch.zeros(1, dtype=torch.long),
                      1 + torch.randperm(n - 1, generator=torch.Generator().manual_seed(0))]
                     ).to(table.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=table.device)
    return (perm[table.long()].int(), *(p[inv] for p in pools))


def sdpa_masked_ms(q, kc, vc, kv_len, hide_host: bool = False):
    """Time of dense SDPA over head-major caches [B, Hkv, S, Dh] in q's
    dtype, each row masked at its length, K/V heads expanded (the
    expansion not timed); ``hide_host`` as ``time_ms``."""
    b, hkv, g, dh = q.shape
    ke, ve = kc.repeat_interleave(g, dim=1), vc.repeat_interleave(g, dim=1)
    mask = (torch.arange(kc.shape[2], device=q.device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return time_ms(lambda: sdpa(q.reshape(b, hkv * g, 1, dh), ke, ve, attn_mask=mask),
                   hide_host=hide_host)


def phase_build():
    t0 = time.perf_counter()
    secs = build.build(verbose=True)
    for name in build.SOURCES:
        build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items()) or 'cached'})")


def decode_kernel(options) -> str:
    """The paged decode kernel a serve() with these options launches."""
    return ("block_sparse_decode_paged" + ("_splitk" if options.split_k > 1 else "")
            + ("_quant" if options.quantize else ""))


def stage_counts(options, n_layers, steps, paged=True):
    """Every kernel's launches over ``steps`` decode steps with these
    options, from the stages of their schedule: the gate select at each
    selecting layer of the gate (none under unify_heads, which scores in
    plain PyTorch), the decode kernel at each layer that is not dense."""
    sched = options.schedule
    stages = (sched.layer_stages(n_layers) if sched.needs_plan
              else (STAGE_SELECT,) * n_layers)
    want = dict.fromkeys(ops.KERNELS, 0)
    if options.policy.dense:
        return want
    gate_name = "gate_select_paged" if paged else "gate_select"
    if options.policy.needs_gate and not sched.unify_heads:
        want[gate_name] = steps * sum(st == STAGE_SELECT for st in stages)
    want[decode_kernel(options) if paged else "block_sparse_decode"] = \
        steps * sum(st != STAGE_DENSE for st in stages)
    return want


def phase_small(shard):
    """Tiny config on the card vs the CPU plain path: same tokens, close
    logits; then the sharded paths through ``shard`` against the same CPU
    runs."""
    cfg = reduced(configs.get("qwen3_0_6b")).replace(dtype="float32")
    cfg = cfg.replace(gate=dataclasses.replace(cfg.gate, block_size=8, d_gate=16,
                                               token_budget=32))
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 41))
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = DecodeEngine(cfg, params_to(params, dev), max_len=64, device=dev)
        tok, st = eng.prefill({"tokens": toks})
        lgs, tks = [], []
        for _ in range(12):
            tok, lg, st, _ = eng._step(eng.params, st, tok)
            lgs.append(lg.float().cpu())
            tks.append(tok.cpu())
        runs[dev] = (torch.stack(lgs), torch.stack(tks))
    err = float((runs["cpu"][0] - runs["cuda"][0]).abs().max())
    if not torch.equal(runs["cpu"][1], runs["cuda"][1]) or err > 1e-4:
        fail(f"small-input agreement: tokens equal {torch.equal(runs['cpu'][1], runs['cuda'][1])}, "
             f"logits max abs diff {err:.3e} (limit 1e-4)")
    print(f"small-input agreement (tiny qwen3, fp32, 2x41 prompt, 12 steps): "
          f"tokens equal, logits max abs diff {err:.3e}")

    # serve(): three ragged requests on 3 slots, ample pool and 8 pages,
    # fp and int8 pools; int8 allows for one int8 code flipped by a 1-ulp
    # difference upstream (tests/test_torch_quant.py's tolerance)
    r = np.random.default_rng(4)
    reqs = [{"rid": i, "max_new_tokens": m,
             "tokens": r.integers(0, cfg.vocab_size, size=(p,)).astype(np.int32)}
            for i, (p, m) in enumerate([(20, 12), (18, 10), (22, 9)])]
    cpu_runs = {}
    for quant, tol in ((None, 1e-4), ("int8", 1e-3)):
        opts = DecodeOptions(quantize=quant)
        engines = {dev: DecodeEngine(cfg, params_to(params, dev), max_len=64, device=dev,
                                     options=opts) for dev in ("cpu", "cuda")}
        for pool in (None, 8):
            res = {dev: e.serve(reqs, n_slots=3, num_pages=pool, collect_logits=True)
                   for dev, e in engines.items()}
            cpu_runs[quant, pool] = res["cpu"]
            same = all(res["cpu"][i] == res["cuda"][i] for i in range(len(reqs)))
            err = max(float(np.abs(res["cpu"]["logits"][i] - res["cuda"]["logits"][i]).max())
                      for i in range(len(reqs)))
            pre = res["cuda"]["stats"]["preemptions"]
            swap_ok = (res["cpu"]["stats"]["swapped_out_bytes"]
                       == res["cuda"]["stats"]["swapped_out_bytes"])
            if not same or err > tol or (pre > 0) != (pool is not None) or not swap_ok:
                fail(f"small serve agreement ({quant or 'fp'} pools, pool {pool}): tokens "
                     f"equal {same}, logits max abs diff {err:.3e} (limit {tol}), "
                     f"preemptions {pre}, swap bytes equal {swap_ok}")
            print(f"small serve agreement ({quant or 'fp'} pools, pool {pool or 'default'}, "
                  f"3 requests on 3 slots): tokens equal, logits max abs diff {err:.3e} "
                  f"(limit {tol}), preemptions {pre}")
    phase_small_sharded(cfg, params, toks, reqs, cpu_runs, shard)


def phase_small_sharded(cfg, params, toks, reqs, cpu_runs, shard):
    """The sharded paths of the tiny config through the one-rank NCCL group
    against phase 2's unsharded CPU runs: head-sharded serve (fp at split_k
    1 and 2, fp split_k 2 under the preempting pool, int8 at split_k 2):
    tokens equal, logits within the unsharded comparison's limits, the
    same preemptions and swap bytes, and each decode step's layers through
    the paged gate select and the decode kernel of its options; then
    sequence-sharded generate (budget and threshold): tokens equal to the
    CPU's unsharded run. The threshold gate gets a budget of all 8 blocks:
    the sharded path caps its candidates at the local cap and the
    unsharded one at the budget, which agree where neither binds."""
    gpu_params = params_to(params, "cuda")
    for quant, split_k, pool, tol in ((None, 1, None, 1e-4), (None, 2, None, 1e-4),
                                      (None, 2, 8, 1e-4), ("int8", 2, None, 1e-3)):
        eng = DecodeEngine(cfg, gpu_params, max_len=64, shard=shard,
                           options=DecodeOptions(quantize=quant, split_k=split_k))
        label = (f"small sharded serve ({quant or 'fp'} pools, split_k {split_k}, pool "
                 f"{pool or 'default'})")
        if split_k == 1:
            rank_params(label, cfg, gpu_params, eng, shard)
        want = cpu_runs[quant, pool]
        ops.reset_launch_counts()
        with collectives_counted(eng, shard) as (coll, pre):
            got = eng.serve(reqs, n_slots=3, num_pages=pool, collect_logits=True)
        counts = ops.launch_counts()
        print_step_collectives(label, coll, pre, got["stats"])
        n = cfg.num_layers * got["stats"]["decode_steps"]
        expect = {**dict.fromkeys(ops.KERNELS, 0), "gate_select_paged": n,
                  decode_kernel(eng.options): n}
        same = all(got[i] == want[i] for i in range(len(reqs)))
        err = max(float(np.abs(got["logits"][i] - want["logits"][i]).max())
                  for i in range(len(reqs)))
        stats_ok = all(got["stats"][k] == want["stats"][k]
                       for k in ("preemptions", "swapped_out_bytes", "decode_steps"))
        if counts != expect or not same or err > tol or not stats_ok:
            fail(f"small sharded serve ({quant or 'fp'} pools, split_k {split_k}, pool "
                 f"{pool}): launch counts {counts} (expected {expect}), tokens equal "
                 f"{same}, logits max abs diff {err:.3e} (limit {tol}), stats equal {stats_ok}")
        print(f"small sharded serve (one NCCL rank, {quant or 'fp'} pools, split_k {split_k}, "
              f"pool {pool or 'default'}): tokens equal to the unsharded CPU run, logits max "
              f"abs diff {err:.3e} (limit {tol}), preemptions {got['stats']['preemptions']}, "
              f"{n} launches of {decode_kernel(eng.options)}")
    for method in ("budget", "threshold"):
        c = cfg.replace(gate=dataclasses.replace(
            cfg.gate, method=method, threshold=2e-2,
            token_budget=32 if method == "budget" else 64))
        want = DecodeEngine(c, params, max_len=64, device="cpu").generate({"tokens": toks}, 13)
        coll, uncount = counting_collectives(shard)
        try:
            got = DecodeEngine(c, gpu_params, max_len=64,
                               shard=shard).generate({"tokens": toks}, 13)
        finally:
            uncount()
        if not torch.equal(got["tokens"].cpu(), want["tokens"]):
            fail(f"small sequence-sharded generate ({method}): tokens differ from the CPU's")
        print(f"small sequence-sharded generate (one NCCL rank, {method}, 2x41 prompt, 12 "
              f"steps): tokens equal to the unsharded CPU run; {coll['n']} collectives over "
              f"the prefill, the cut to the sequence and 12 steps")


def capture_layer0(eng, batch):
    """Prefill + one decode step; the kernel arguments of layer 0 of that step."""
    seen = {}
    real = (ops.gate_select, ops.sparse_decode)

    def grab(name, fn):
        def wrapper(*a, **kw):
            seen.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return wrapper

    ops.gate_select = grab("gate_select", real[0])
    ops.sparse_decode = grab("sparse_decode", real[1])
    try:
        tok, state = eng.prefill(batch)
        eng._step(eng.params, state, tok)
    finally:
        ops.gate_select, ops.sparse_decode = real
    torch.cuda.synchronize()
    return seen, state


def phase_kernels(seen, vs_sdpa: bool = True):
    """Kernel vs plain on the main path's layer-0 tensors; timings. With
    ``vs_sdpa`` #2 must beat dense SDPA (qwen3_0_6b's main path); without,
    the comparison is printed only (the other configs' MQA groups, where
    dense SDPA reads one KV head for 8 or 48 query heads)."""
    (qg, kg, nv, gcfg, ms), _ = seen["gate_select"]
    (q, kc, vc, idx, kv_len), kw = seen["sparse_decode"]
    bs = kw["block_size"]
    nb = kg.shape[2]
    print(f"layer-0 shapes: qg {tuple(qg.shape)} kg {tuple(kg.shape)} n_valid "
          f"{nv.tolist()} | q {tuple(q.shape)} caches {tuple(kc.shape)} idx "
          f"{tuple(idx.shape)} kv_len {kv_len.tolist()} ({kc.dtype})")

    # gate select: budget/threshold x force flags x n_valid full/partial/1,
    # on the captured tensors and on exact ties at their shapes
    def gate_checks(q_, k_, exact):
        return gate_cases("gate_select", lambda n, c: gs.gate_select_cuda(q_, k_, n, c, ms),
                          lambda n, c: gs.gate_select_plain(q_, k_, n, c, ms),
                          lambda n, c: gs.gate_scores_plain(q_, k_, n, c), nv, nb, gcfg,
                          exact=exact)
    checks, swaps, gate_err = gate_checks(qg, kg, False)
    print(f"gate_select: {checks} cases (budget/threshold x force flags x n_valid "
          f"full/partial/1) equal to plain; near-tie swaps {swaps}")
    checks, swaps, _ = gate_checks(*tie_inputs(qg, kg), True)
    print(f"gate_select: exact ties (integer qg and Kg, rows from 7 distinct ones): {checks} "
          f"cases, budget ids bitwise those of plain, threshold near-tie swaps {swaps}")

    # block-sparse decode; kv_len leaves a partial block
    thr = gs.gate_select_plain(qg, kg, nv, dataclasses.replace(gcfg, method="threshold"), ms)
    dec_err = check_decode(
        "block_sparse_decode",
        lambda qq, ix: bsd.sparse_decode_cuda(qq, kc, vc, ix, kv_len, block_size=bs),
        lambda qq, ix: bsd.sparse_decode_plain(qq, kc, vc, ix, kv_len, block_size=bs),
        decode_cases(q, idx, thr))
    if int(kv_len[0]) % bs == 0:
        fail("expected a partial last block at the captured kv_len")

    # timings (median of 30 CUDA-event-timed calls each: see time_ms)
    t_gk = time_ms(lambda: gs.gate_select_cuda(qg, kg, nv, gcfg, ms))
    t_gp = time_ms(lambda: gs.gate_select_plain(qg, kg, nv, gcfg, ms))
    dec = lambda ns=None: bsd.sparse_decode_cuda(q, kc, vc, idx, kv_len, block_size=bs,
                                                 num_splits=ns)
    t_dk = time_ms(dec)
    t_dp = time_ms(lambda: bsd.sparse_decode_plain(q, kc, vc, idx, kv_len, block_size=bs))
    b, hkv, g, dh = q.shape
    n = int(kv_len.max())
    qs = q.reshape(b, hkv * g, 1, dh)
    ks, vs = kc[:, :, :n], vc[:, :, :n]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_call = lambda: sdpa(qs, ks, vs, enable_gqa=True)
    t_lib = time_ms(lib_call)
    k_sel = gs.n_selected(gcfg, nb, ms)
    gb, gby = gate_bound_ms(qg, nv, k_sel)
    dbytes, dops = decode_work(q, idx, kv_len, bs)
    db, dby = bound_ms(dbytes, dops)
    print(f"gate_select: kernel {t_gk:.4f} ms, plain {t_gp:.4f} ms, bound {gb:.5f} ms ({gby})")
    report_gate("gate_select", t_gk, lambda: gs.gate_select_cuda(qg, kg, nv, gcfg, ms),
                gate_work(qg, nv, k_sel)[0], gb, qg.shape[0] * qg.shape[1],
                lambda: torch.topk(torch.einsum("bhd,bhnd->bhn", qg.float(), kg.float()),
                                   k_sel))
    t_dk_dev, t_lib_dev = time_ms(dec, hide_host=True), time_ms(lib_call, hide_host=True)
    print(f"block_sparse_decode: kernel {t_dk:.4f} ms, plain {t_dp:.4f} ms, "
          f"bound {db:.5f} ms ({dby}), SDPA dense over {n} tokens {t_lib:.4f} ms; "
          f"with the host's enqueue hidden (information only): kernel {t_dk_dev:.4f} ms, "
          f"SDPA {t_lib_dev:.4f} ms")
    report_decode("block_sparse_decode", q, idx, t_dk, t_dk_dev, dbytes, db, dec)
    print(f"block_sparse_decode: {t_dk:.4f} ms against dense SDPA {t_lib:.4f} ms: "
          f"{'faster' if t_dk < t_lib else 'NOT faster'}")
    if vs_sdpa and not t_dk < t_lib:
        fail(f"block_sparse_decode {t_dk:.4f} ms is not faster than dense SDPA {t_lib:.4f} ms")
    return {
        "gate_select": dict(max_abs_err=gate_err, ms=t_gk, plain_ms=t_gp,
                            bound_ms=gb, bound_by=gby, library_ms=None),
        "block_sparse_decode": dict(max_abs_err=dec_err, ms=t_dk, plain_ms=t_dp,
                                    bound_ms=db, bound_by=dby, library_ms=t_lib),
    }


def cuda_kernels(ka):
    """The CUDA kernels' rows of torch.profiler key averages ``ka``, and
    their device time in ms."""
    kernels = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    return kernels, sum(e.self_device_time_total for e in kernels) / 1e3


def profiled(fn):
    """``fn()`` under torch.profiler, synchronised: (its result, the key
    averages, the CUDA kernels' rows, their device time in ms)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    return (out, ka, *cuda_kernels(ka))


def phase_profile(eng, batch, steps: int = 3, label: str = "decode step"):
    """Where a decode step's time goes, after the end-to-end run so that
    the profiler cannot touch its timing: a fresh prefill, the wall time
    of a few plain steps, torch.profiler over as many more (top device
    kernels, device busy share), then as many plain steps again, which
    shows what the profiler leaves behind. Returns (wall ms a step before
    the profiler, device busy ms a step)."""
    def run():
        nonlocal tok, state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, _, state, _ = eng._step(eng.params, state, tok)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / steps

    tok, state = eng.prefill(batch)
    before = run()
    under, ka, kernels, busy = profiled(run)
    busy /= steps   # ms/step
    after = run()
    print(ka.table(sort_by="self_device_time_total", row_limit=15))
    gate = (gate_profile(kernels, steps) if eng.options.policy.needs_gate
            else "no gate select")
    print(f"profile: {label} {before:.2f} ms wall before the profiler, "
          f"{under:.2f} ms under it, {after:.2f} ms after it; device busy "
          f"{busy:.2f} ms/step = {100 * busy / under:.1f}% of the profiled wall; "
          f"{sum(e.count for e in kernels) / steps:.0f} kernel launches/step; {gate}")
    return before, busy


def host_launch_us(n: int = 2000) -> float:
    """Host time to enqueue one tiny CUDA op, in µs: the pace of a
    host-bound decode step, which launches a few thousand of them."""
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def phase_end_to_end(eng, batch, n_new, n_layers, keep=None):
    """generate() with every launch counter at 0 just before; logits
    checked. ``keep`` (a dict) gets the tokens and every decode step's
    logits, for phase 42 to hold its sharded run to."""
    print(f"host: {host_launch_us():.2f} µs to enqueue a tiny CUDA op, "
          f"{os.cpu_count()} CPUs, load average {os.getloadavg()[0]:.2f}")
    finite, logits = [], []
    step = eng._step

    def checked_step(*a):
        out = step(*a)
        finite.append(torch.isfinite(out[1]).all())
        if keep is not None:
            logits.append(out[1].clone())
        return out

    eng._step = checked_step
    ops.reset_launch_counts()
    res = eng.generate(batch, n_new)
    counts = ops.launch_counts()
    eng._step = step
    stats = eng.sparsity_stats()
    n_steps = n_new - 1
    b = batch["tokens"].shape[0]
    print(f"end to end: prefill {res['prefill_s']:.2f} s, decode "
          f"{1e3 * res['decode_s'] / n_steps:.2f} ms/step, {res['tok_per_s']:.1f} tok/s "
          f"(batch {b}, {n_steps} steps), measured sparsity {stats['sparsity']:.4f} "
          f"(sel {stats['sel_blocks']:.1f} of {stats['vis_blocks']:.1f} blocks), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print(f"launch counts over generate: {counts} (expected {n_layers} x {n_steps} = "
          f"{n_layers * n_steps} for each contiguous fp kernel, 0 for the others)")
    for name, c in counts.items():
        want = n_layers * n_steps if name in ("gate_select", "block_sparse_decode") else 0
        if c != want:
            fail(f"{name} launched {c} times, expected {want}")
    if len(finite) != n_steps or not bool(torch.stack(finite).all()):
        fail("non-finite logits in the decode steps")
    toks = res["tokens"]
    if tuple(toks.shape) != (b, n_new) or int(toks.min()) < 0 \
            or int(toks.max()) >= eng.cfg.vocab_size:
        fail(f"bad tokens: shape {tuple(toks.shape)}")
    if keep is not None:
        keep.update(tokens=toks.cpu(), logits=torch.stack(logits).float().cpu())
    return counts, stats["sparsity"]


def serve_requests(vocab, prompt_cut=None):
    """Phase 6's requests; ``prompt_cut`` shortens each prompt to at most
    that many of its tokens."""
    rng = np.random.default_rng(SERVE_SEED)
    reqs = [{"rid": i, "max_new_tokens": m,
             "tokens": rng.integers(0, vocab, size=(p,)).astype(np.int32)}
            for i, (p, m) in enumerate(SERVE_SPECS)]
    if prompt_cut is not None:
        for r in reqs:
            r["tokens"] = r["tokens"][:prompt_cut]
    return reqs


def tight_pool_pages(reqs, page_size):
    """The tight pool of phase 6's rule: the first four prompts' pages,
    the null page and one more (644 for phase 6's requests)."""
    return sum(-(-r["tokens"].size // page_size) for r in reqs[:SERVE_SLOTS]) + 2


def capture_first(names):
    """Patch ``ops.<name>`` for each of ``names`` so that its FIRST call
    (layer 0 of the first decode step, or of the first forward) keeps
    clones of its arguments: pools and caches are updated in place later.
    Returns (seen, restore)."""
    seen = {}
    real = {name: getattr(ops, name) for name in names}

    def copy(x):
        return x.clone() if torch.is_tensor(x) else x

    def grab(name, fn):
        def wrapper(*a, **kw):
            if name not in seen:
                seen[name] = (tuple(map(copy, a)), {k: copy(v) for k, v in kw.items()})
            return fn(*a, **kw)
        return wrapper

    for name, fn in real.items():
        setattr(ops, name, grab(name, fn))

    def restore():
        for name, fn in real.items():
            setattr(ops, name, fn)
    return seen, restore


PAGED_CALLS = ("gate_select_paged", "paged_sparse_decode", "paged_sparse_decode_splitk")


def run_serve(eng, reqs, num_pages, n_layers, **kw):
    """One serve() with the launch counters at 0 just before and read just
    after, and the prefill time taken apart (synchronised). The paged gate
    select and the paged decode of the engine's options (fp or int8 pools,
    single-pass or split-K) must launch what ``stage_counts`` predicts
    (layers x decode steps times each, for the gate under the trivial
    schedule; a replayed attempt of a step under eviction launches as a
    step does), and no other kernel. ``kw`` goes to serve() (eviction,
    swap_config)."""
    prefill = eng._paged_prefill
    spent = [0.0]

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(*a, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    eng._paged_prefill = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        res = eng.serve(reqs, n_slots=SERVE_SLOTS, num_pages=num_pages, collect_logits=True,
                        **kw)
    finally:
        counts = ops.launch_counts()
        eng._paged_prefill = prefill
    st = res["stats"]
    steps = st["decode_steps"]
    decode_s = st["wall_s"] - spent[0]
    decode_toks = st["generated_tokens"] - st["admitted"]
    print(f"serve (pool {st['num_pages']} pages): wall {st['wall_s']:.2f} s, prefill "
          f"{spent[0]:.2f} s, {steps} decode steps, decode {1e3 * decode_s / steps:.2f} ms/step, "
          f"{decode_toks / decode_s:.1f} decode tok/s, {st['tok_per_s']:.1f} tok/s over the "
          f"wall; peak pages {st['peak_pages_used']}, preemptions {st['preemptions']}, resumed "
          f"{st['resumed']}, swapped out {st['swapped_out_bytes']} B, in "
          f"{st['swapped_in_bytes']} B; mean active slots {st['mean_active_slots']:.2f}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print(f"serve measured sparsity by rid: "
          + ", ".join(f"{k}: {v:.4f}" for k, v in st["sparsity_by_rid"].items())
          + f"; launch counts {counts}")
    want = stage_counts(eng.options, n_layers, steps + st["replay_steps"])
    if counts != want:
        fail(f"serve launch counts {counts}, expected {want}")
    if st["retired"] != len(reqs) or st["failed"] or st["errors"]:
        fail(f"serve: retired {st['retired']} of {len(reqs)}, errors {st['errors']}")
    for r in reqs:
        got = res[r["rid"]]
        if len(got) != r["max_new_tokens"] or min(got) < 0 or max(got) >= eng.cfg.vocab_size:
            fail(f"serve rid {r['rid']}: {len(got)} tokens, expected {r['max_new_tokens']}")
        if not np.isfinite(res["logits"][r["rid"]]).all():
            fail(f"serve rid {r['rid']}: non-finite logits")
    return res, counts, spent[0]


def phase_serve(cfg, params, options=DecodeOptions(), shard=None, tight_pool=True,
                reqs=None, tight_pages=TIGHT_PAGES):
    """serve() at full width, ample pool then (``tight_pool``) ``tight_pages``
    pages; layer-0 paged kernel arguments captured from the ample run's
    first decode step. Int8 pools (``options.quantize``), sharded runs and
    the recurrent families must reproduce the ample run bitwise under the
    tight pool (the swap moves the raw bytes and the recurrent rows back).
    ``reqs`` defaults to ``serve_requests``. Returns (launch counts,
    captured arguments, ample, tight or None)."""
    reqs = reqs if reqs is not None else serve_requests(cfg.vocab_size)
    eng = DecodeEngine(cfg, params, max_len=max(r["tokens"].size + r["max_new_tokens"]
                                                for r in reqs),
                       options=options, shard=shard)
    n_layers = get_api(cfg).paged_attn_layers(cfg)
    seen, restore = capture_first(PAGED_CALLS)
    coupled = cfg.family == "moe"
    traces = ({}, {})
    if shard is not None:
        rank_params("sharded serve", cfg, params, eng, shard)
    try:
        with (collectives_counted(eng, shard) if shard is not None
              else contextlib.nullcontext((None, None))) as (coll, pre):
            ample, counts, _ = run_serve(eng, reqs, None, n_layers,
                                         **slot_trace(traces[0]) if coupled else {})
    finally:
        restore()
    if shard is not None:
        print_step_collectives("sharded serve (ample pool)", coll, pre, ample["stats"])
    if ample["stats"]["preemptions"]:
        fail("the ample pool preempted")
    if not tight_pool:
        return counts, seen, ample, None
    tight, _, _ = run_serve(eng, reqs, tight_pages, n_layers,
                            **slot_trace(traces[1]) if coupled else {})
    if coupled:
        check_coupled_serve(reqs, ample, tight, *traces)
        return counts, seen, ample, tight
    st = tight["stats"]
    if st["preemptions"] < 1 or st["resumed"] != st["preemptions"]:
        fail(f"tight pool: preemptions {st['preemptions']}, resumed {st['resumed']}")
    if st["swapped_out_bytes"] != st["swapped_in_bytes"]:
        fail(f"tight pool: swapped out {st['swapped_out_bytes']} B, in {st['swapped_in_bytes']} B")
    worst = 0.0
    for r in reqs:
        rid = r["rid"]
        if tight[rid] != ample[rid]:
            fail(f"tight pool changed rid {rid}'s tokens")
        worst = max(worst, bf16_ulps(ample["logits"][rid], tight["logits"][rid]))
    bitwise = options.quantize or shard is not None or cfg.family in ("ssm", "hybrid")
    if worst > (0 if bitwise else DECODE_ULPS):
        fail(f"tight pool logits differ by {worst:.2f} bf16 ulps")
    print(f"tight pool reproduces the ample run: tokens equal for every rid, logits "
          + ("bitwise equal" if worst == 0 else f"within {worst:.2f} bf16 ulps"))
    return counts, seen, ample, tight


def slot_trace(trace):
    """serve() kwargs recording, for every token, its decode step and the
    (slot, rid) that produced it: ``trace[rid]`` = [(step, index)], and
    ``trace["steps"][step]`` the set of (slot, rid) pairs that decoded at
    that step (the prefill's tokens excluded)."""
    trace["steps"] = {}

    def on_token(req, token, index, step):
        trace.setdefault(req.rid, []).append(step)
        if index > 0:
            trace["steps"].setdefault(step, set()).add((req.slot, req.rid))
    return {"on_token": on_token}


def check_coupled_serve(reqs, ample, tight, t_ample, t_tight):
    """A MoE model's tight run against its ample run: its experts' capacity
    couples the rows of a step (every slot, active or not, routes in one
    call), so a request's output depends on which slots are active, in the
    reference too. The runs must agree bitwise, tokens and logits, on every
    token produced before the first decode step whose (slot, request) set
    differs, and the tight run must preempt and resume and swap its bytes
    back."""
    st = tight["stats"]
    if st["preemptions"] < 1 or st["resumed"] != st["preemptions"]:
        fail(f"tight pool: preemptions {st['preemptions']}, resumed {st['resumed']}")
    if st["swapped_out_bytes"] != st["swapped_in_bytes"]:
        fail(f"tight pool: swapped out {st['swapped_out_bytes']} B, in {st['swapped_in_bytes']} B")
    steps = sorted(set(t_ample["steps"]) | set(t_tight["steps"]))
    first = next((s for s in steps if t_ample["steps"].get(s) != t_tight["steps"].get(s)),
                 steps[-1] + 1)
    held = same = total = 0
    for r in reqs:
        rid = r["rid"]
        n = min(sum(1 for step in t[rid] if step < first) for t in (t_ample, t_tight))
        if tight[rid][:n] != ample[rid][:n] or not np.array_equal(
                tight["logits"][rid][:n], ample["logits"][rid][:n]):
            fail(f"tight pool changed rid {rid} before step {first}, where the active "
                 f"slots still agree")
        held += n
        total += len(ample[rid])
        same += sum(a == b for a, b in zip(ample[rid], tight[rid]))
    print(f"tight pool against the ample run (MoE: rows coupled by the experts' capacity): "
          f"the (slot, request) sets first differ at decode step {first}; the {held} tokens "
          f"before it equal, logits bitwise; {same} of {total} tokens equal over the whole "
          f"runs (information only)")


def check_int8_serve(cfg, fp, q8, n_layers=None, state_bytes=0):
    """The int8 runs against the fp runs of phase 6: the same scheduling
    (decode steps, peak pages, preemptions), swap bytes in the ratio of the
    int8 page (codes, bf16 Kg row, two f32 scales per kv head) to the fp
    page, and, for information only, the share of tokens equal to fp's.
    ``n_layers`` (default all) the layers the pools hold; ``state_bytes``
    a recurrent family's rows a preempted request swaps beside its pages,
    taken off both runs' bytes before the ratio."""
    (fa, ft), (qa, qt) = fp, q8
    n_layers = n_layers or cfg.num_layers
    for key in ("decode_steps", "peak_pages_used", "preemptions"):
        for f, q in ((fa, qa), (ft, qt)):
            if f["stats"][key] != q["stats"][key]:
                fail(f"int8 serve {key} {q['stats'][key]} != fp {f['stats'][key]}")
    ps, dh, hkv = cfg.gate.block_size, cfg.resolved_head_dim, cfg.n_kv_heads
    es = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    kg = cfg.gate.d_gate * es
    per_fp, per_q8 = hkv * (2 * ps * dh * es + kg), hkv * (2 * ps * dh + kg + 8)
    rec = state_bytes * qt["stats"]["preemptions"]
    fb, qb = ft["stats"]["swapped_out_bytes"] - rec, qt["stats"]["swapped_out_bytes"] - rec
    if qb * per_fp != fb * per_q8:
        fail(f"int8 swap {qb} B is not fp's {fb} B x {per_q8}/{per_fp}")
    pages = qb // (n_layers * per_q8)
    same = total = 0
    for rid in range(len(SERVE_SPECS)):
        a, b = np.asarray(fa[rid]), np.asarray(qa[rid])
        same += int((a == b).sum())
        total += len(a)
    n_pages = qa["stats"]["num_pages"]
    kv = n_pages * n_layers * hkv * ps * dh * 2
    print(f"int8 serve: swapped {qb} B each way = {pages} pages x {n_layers} layers x "
          f"{per_q8} B (fp: {fb} B), beside {rec} B of recurrent rows; K/V pools at {n_pages} pages {kv / 1e9:.2f} GB "
          f"(fp {kv * es / 1e9:.2f} GB); tokens equal to the fp run {same}/{total} "
          f"(information only)")


def check_sharded_serve(cfg, base, sharded):
    """A sharded serve (ample, and tight or None) against the unsharded
    runs of the same pools (``base``: ample, tight): the same decode steps,
    peak pages, preemptions, swap bytes and measured sparsity by request;
    the first decode step's logits of the requests admitted at once
    within DECODE_ULPS bf16 ulps of max|logit| (split-K only reorders fp32
    sums); the share of equal tokens printed, for information only."""
    for b, sh in zip(base, sharded):
        if sh is None:
            continue
        for key in ("decode_steps", "peak_pages_used", "preemptions", "resumed",
                    "swapped_out_bytes", "swapped_in_bytes", "sparsity_by_rid"):
            if b["stats"][key] != sh["stats"][key]:
                fail(f"sharded serve {key} {sh['stats'][key]} != unsharded {b['stats'][key]}")
    (ba, sa) = base[0], sharded[0]
    worst = 0.0
    for rid in range(SERVE_SLOTS):                 # admitted at step 0: same step
        worst = max(worst, bf16_ulps(ba["logits"][rid][1], sa["logits"][rid][1]))
    if worst > DECODE_ULPS:
        fail(f"sharded serve: first decode step's logits {worst:.2f} bf16 ulps from the "
             f"unsharded run's (limit {DECODE_ULPS})")
    same = sum(int((np.asarray(ba[r]) == np.asarray(sa[r])).sum())
               for r in range(len(SERVE_SPECS)))
    total = sum(len(ba[r]) for r in range(len(SERVE_SPECS)))
    print(f"sharded serve vs unsharded: steps, pages, preemptions, swap bytes "
          f"({sa['stats']['swapped_out_bytes']} B out on the ample run, "
          f"{sharded[1]['stats']['swapped_out_bytes'] if sharded[1] else 'no tight run'} on the "
          f"tight run) and sparsity by rid equal; first decode step's logits within "
          f"{worst:.3f} bf16 ulps of max|logit| (limit {DECODE_ULPS}); tokens equal {same}/"
          f"{total} (information only)")


def phase_splitk_kernels(seen, source: str = "sharded serve"):
    """Kernel 5 (fp pools) or 5q (int8 pools), the paged instances of the
    sm90 body at the caller's num_splits, vs plain on a serve's (by
    default the sharded serve's) layer-0 tensors at several num_splits,
    and over shuffled pages; bitwise
    equal to #4 / #4q at the same num_splits; timed at SPLIT_K and reported
    as the other sm90 instances are; bound and library yardstick."""
    (qg, kgp, pt, nv, gcfg, ms), _ = seen["gate_select_paged"]
    (q, kp, vp, idx, pt_d, kv_len), kw = seen["paged_sparse_decode_splitk"]
    bs, ks, vs = kw["block_size"], kw.get("k_scales"), kw.get("v_scales")
    quant = ks is not None
    name = "block_sparse_decode_paged_splitk" + ("_quant" if quant else "")
    single_name = "block_sparse_decode_paged" + ("_quant (#4q)" if quant else " (#4)")
    nsel = idx.shape[-1]
    print(f"{name}: {source} layer-0 shapes: q {tuple(q.shape)} pools {tuple(kp.shape)} "
          f"({kp.dtype}) idx {tuple(idx.shape)} kv_len {kv_len.tolist()}")

    def kernel(qq, ix, ns, pools=(pt_d, kp, vp, ks, vs)):
        table, k, v, ksc, vsc = pools
        if quant:
            return bsd.sparse_decode_paged_splitk_quant_cuda(
                qq, k, v, ix, table, kv_len, block_size=bs, num_splits=ns, k_scales=ksc,
                v_scales=vsc)
        return bsd.sparse_decode_paged_splitk_cuda(qq, k, v, ix, table, kv_len, block_size=bs,
                                                   num_splits=ns)

    def plain(qq, ix, ns):
        return bsd.sparse_decode_paged_splitk_plain(qq, kp, vp, ix, pt_d, kv_len, block_size=bs,
                                                    num_splits=ns, k_scales=ks, v_scales=vs)

    def single(qq, ix, ns):
        if quant:
            return bsd.sparse_decode_paged_quant_cuda(qq, kp, vp, ix, pt_d, kv_len, block_size=bs,
                                                      k_scales=ks, v_scales=vs, num_splits=ns)
        return bsd.sparse_decode_paged_cuda(qq, kp, vp, ix, pt_d, kv_len, block_size=bs,
                                            num_splits=ns)

    thr = gs.gate_select_paged_plain(qg, kgp, pt, nv,
                                     dataclasses.replace(gcfg, method="threshold"), ms)
    cases = decode_cases(q, idx, thr)
    shuffled = shuffled_pages(pt_d, kp, vp, *((ks, vs) if quant else ()))
    if not quant:
        shuffled = shuffled + (None, None)
    err = 0.0
    for ns in SPLITS_CHECKED + (nsel + 3,):
        err = max(err, check_decode(
            f"{name} [num_splits {ns}]", lambda qq, ix: kernel(qq, ix, ns),
            lambda qq, ix: plain(qq, ix, ns), cases,
            lambda qq, ix: kernel(qq, ix, ns, shuffled)))
        # one body at the same segment boundaries: 5 at ns is #4 at ns
        for label, qq, ix in cases:
            if not torch.equal(kernel(qq, ix, ns), single(qq, ix, ns)):
                fail(f"{name} [num_splits {ns}, {label}] is not bitwise {single_name} at "
                     f"the same num_splits")
    print(f"{name}: bitwise equal to {single_name} at num_splits "
          f"{', '.join(map(str, SPLITS_CHECKED + (nsel + 3,)))} on all {len(cases)} cases")
    if int(kv_len[0]) % bs == 0:
        fail("expected a partial last block at the captured kv_len")
    del shuffled
    dec = lambda ns=SPLIT_K: kernel(q, idx, ns)
    t_k, t_k_dev = time_ms(dec), time_ms(dec, hide_host=True)
    t_p = time_ms(lambda: plain(q, idx, SPLIT_K))
    dbytes, dops = paged_decode_work(q, idx, kv_len, bs, kv_es=1 if quant else None,
                                     num_splits=SPLIT_K)
    b_ms, b_by = bound_ms(dbytes, dops)
    k_view = pg.gather_kv(kp, pt_d, ks).to(q.dtype)
    v_view = pg.gather_kv(vp, pt_d, vs).to(q.dtype)
    t_lib = sdpa_masked_ms(q, k_view, v_view, kv_len)
    del k_view, v_view
    print(f"{name}: kernel {t_k:.4f} ms at num_splits {SPLIT_K}, plain {t_p:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by}); with the host's enqueue hidden (information only): kernel "
          f"{t_k_dev:.4f} ms; SDPA dense over the {'pre-dequantized ' if quant else ''}gathered "
          f"view (masked at kv_len{', dequant not timed, context only' if quant else ''}) "
          f"{t_lib:.4f} ms")
    report_decode(name, q, idx, t_k, t_k_dev, dbytes, b_ms, dec, ns=SPLIT_K)
    return {name: dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None if quant else t_lib)}


def nccl_shard(store_dir: str) -> Shard:
    """A one-rank NCCL process group on this card, as the ``model`` axis of
    the sharded paths; the rendezvous goes through a file store in
    ``store_dir`` (no network port)."""
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store_dir}/store", rank=0,
                            world_size=1)
    return Shard()


def phase_paged_kernels(seen, vs_sdpa: bool = True):
    """Paged kernels vs plain on the serve path's layer-0 tensors; timings;
    ``vs_sdpa`` as in ``phase_kernels``."""
    (qg, kgp, pt, nv, gcfg, ms), _ = seen["gate_select_paged"]
    (q, kp, vp, idx, pt_d, kv_len), kw = seen["paged_sparse_decode"]
    bs = kw["block_size"]
    npt = pt.shape[1]
    print(f"serve layer-0 shapes: qg {tuple(qg.shape)} kg_pages {tuple(kgp.shape)} page_table "
          f"{tuple(pt.shape)} n_valid {nv.tolist()} | q {tuple(q.shape)} pools "
          f"{tuple(kp.shape)} idx {tuple(idx.shape)} kv_len {kv_len.tolist()} ({kp.dtype})")
    # the kernels read through the table, so shuffled pages must not move
    # their outputs
    pt_s, kgp_s = shuffled_pages(pt, kgp)

    def gate_checks(q_, pool, pool_s, exact):
        return gate_cases(
            "gate_select_paged", lambda n, c: gs.gate_select_paged_cuda(q_, pool, pt, n, c, ms),
            lambda n, c: gs.gate_select_paged_plain(q_, pool, pt, n, c, ms),
            lambda n, c: gs.gate_scores_plain(q_, pg.gather_kg(pool, pt), n, c), nv, npt,
            gcfg, exact=exact,
            shuffled=lambda n, c: gs.gate_select_paged_cuda(q_, pool_s, pt_s, n, c, ms))
    checks, swaps, gate_err = gate_checks(qg, kgp, kgp_s, False)
    print(f"gate_select_paged: {checks} cases (budget/threshold x force flags x n_valid "
          f"captured/partial/1) equal to plain, and to the kernel over shuffled pages; "
          f"near-tie swaps {swaps}")
    tq, tk = tie_inputs(qg, kgp)
    checks, swaps, _ = gate_checks(tq, tk, shuffled_pages(pt, tk)[1], True)
    print(f"gate_select_paged: exact ties (integer qg and Kg pool, rows from 7 distinct ones): "
          f"{checks} cases, budget ids bitwise those of plain, threshold near-tie swaps {swaps}, "
          f"all bitwise equal over shuffled pages")
    del kgp_s, tq, tk

    thr = gs.gate_select_paged_plain(qg, kgp, pt, nv,
                                     dataclasses.replace(gcfg, method="threshold"), ms)
    pt_ds, kp_s, vp_s = shuffled_pages(pt_d, kp, vp)
    dec_err = check_decode(
        "block_sparse_decode_paged",
        lambda qq, ix: bsd.sparse_decode_paged_cuda(qq, kp, vp, ix, pt_d, kv_len, block_size=bs),
        lambda qq, ix: bsd.sparse_decode_paged_plain(qq, kp, vp, ix, pt_d, kv_len,
                                                     block_size=bs),
        decode_cases(q, idx, thr),
        lambda qq, ix: bsd.sparse_decode_paged_cuda(qq, kp_s, vp_s, ix, pt_ds, kv_len,
                                                    block_size=bs))
    if int(kv_len[0]) % bs == 0:
        fail("expected a partial last block at the captured kv_len")
    del kp_s, vp_s

    t_gk = time_ms(lambda: gs.gate_select_paged_cuda(qg, kgp, pt, nv, gcfg, ms))
    t_gp = time_ms(lambda: gs.gate_select_paged_plain(qg, kgp, pt, nv, gcfg, ms))
    dec = lambda ns=None: bsd.sparse_decode_paged_cuda(
        q, kp, vp, idx, pt_d, kv_len, block_size=bs, num_splits=ns)
    t_dk, t_dk_dev = time_ms(dec), time_ms(dec, hide_host=True)
    t_dp = time_ms(lambda: bsd.sparse_decode_paged_plain(q, kp, vp, idx, pt_d, kv_len,
                                                         block_size=bs))
    # yardstick: dense SDPA over the slots' gathered view (the gather is
    # not timed), each slot masked at its length
    k_view, v_view = pg.gather_kv(kp, pt_d), pg.gather_kv(vp, pt_d)
    t_lib = sdpa_masked_ms(q, k_view, v_view, kv_len)
    t_lib_dev = sdpa_masked_ms(q, k_view, v_view, kv_len, hide_host=True)
    del k_view, v_view
    k_sel = gs.n_selected(gcfg, npt, ms)
    gbytes, gops = gate_work(qg, nv, k_sel)
    gb, gby = bound_ms(gbytes + 4 * int(nv.sum()), gops)     # + page-table entries
    dbytes, dops = paged_decode_work(q, idx, kv_len, bs)
    db, dby = bound_ms(dbytes, dops)
    print(f"gate_select_paged: kernel {t_gk:.4f} ms, plain {t_gp:.4f} ms, bound {gb:.5f} ms ({gby})")
    kg_view = pg.gather_kg(kgp, pt)
    report_gate("gate_select_paged", t_gk,
                lambda: gs.gate_select_paged_cuda(qg, kgp, pt, nv, gcfg, ms),
                gbytes + 4 * int(nv.sum()), gb, qg.shape[0] * qg.shape[1],
                lambda: torch.topk(torch.einsum("bhd,bhnd->bhn", qg.float(), kg_view.float()),
                                   k_sel))
    del kg_view
    print(f"block_sparse_decode_paged: kernel {t_dk:.4f} ms, plain {t_dp:.4f} ms, bound "
          f"{db:.5f} ms ({dby}), SDPA dense over the gathered view (masked at kv_len) "
          f"{t_lib:.4f} ms; with the host's enqueue hidden (information only): kernel "
          f"{t_dk_dev:.4f} ms, SDPA {t_lib_dev:.4f} ms")
    report_decode("block_sparse_decode_paged", q, idx, t_dk, t_dk_dev, dbytes, db, dec)
    print(f"block_sparse_decode_paged: {t_dk:.4f} ms against masked SDPA {t_lib:.4f} ms: "
          f"{'faster' if t_dk < t_lib else 'NOT faster'}")
    if vs_sdpa and not t_dk < t_lib:
        fail(f"block_sparse_decode_paged {t_dk:.4f} ms is not faster than masked SDPA "
             f"{t_lib:.4f} ms")
    return {
        "gate_select_paged": dict(max_abs_err=gate_err, ms=t_gk, plain_ms=t_gp,
                                  bound_ms=gb, bound_by=gby, library_ms=None),
        "block_sparse_decode_paged": dict(max_abs_err=dec_err, ms=t_dk, plain_ms=t_dp,
                                          bound_ms=db, bound_by=dby, library_ms=t_lib),
    }


def phase_paged_quant_kernels(seen):
    """The int8 paged decode (TPU body 4q) vs plain on the int8 serve
    path's layer-0 tensors, and over shuffled pages; timings and bound."""
    (qg, kgp, pt, nv, gcfg, ms), _ = seen["gate_select_paged"]
    (q, kp, vp, idx, pt_d, kv_len), kw = seen["paged_sparse_decode"]
    bs, ks, vs = kw["block_size"], kw["k_scales"], kw["v_scales"]
    print(f"int8 serve layer-0 shapes: q {tuple(q.shape)} pools {tuple(kp.shape)} ({kp.dtype}) "
          f"scale rows {tuple(ks.shape)} ({ks.dtype}) idx {tuple(idx.shape)} kv_len "
          f"{kv_len.tolist()}")

    def kernel(qq, ix, pools=(pt_d, kp, vp, ks, vs), num_splits=None):
        table, k, v, ksc, vsc = pools
        return bsd.sparse_decode_paged_quant_cuda(qq, k, v, ix, table, kv_len, block_size=bs,
                                                  k_scales=ksc, v_scales=vsc,
                                                  num_splits=num_splits)

    def plain(qq, ix):
        return bsd.sparse_decode_paged_plain(qq, kp, vp, ix, pt_d, kv_len, block_size=bs,
                                             k_scales=ks, v_scales=vs)

    thr = gs.gate_select_paged_plain(qg, kgp, pt, nv,
                                     dataclasses.replace(gcfg, method="threshold"), ms)
    shuffled = shuffled_pages(pt_d, kp, vp, ks, vs)
    err = check_decode("block_sparse_decode_paged_quant", kernel, plain,
                       decode_cases(q, idx, thr), lambda qq, ix: kernel(qq, ix, shuffled))
    if int(kv_len[0]) % bs == 0:
        fail("expected a partial last block at the captured kv_len")
    del shuffled
    dec = lambda ns=None: kernel(q, idx, num_splits=ns)
    t_k, t_k_dev = time_ms(dec), time_ms(dec, hide_host=True)
    t_p = time_ms(lambda: plain(q, idx))
    t_ctx = sdpa_masked_ms(q, pg.gather_kv(kp, pt_d, ks).to(q.dtype),
                           pg.gather_kv(vp, pt_d, vs).to(q.dtype), kv_len)
    dbytes, dops = paged_decode_work(q, idx, kv_len, bs, kv_es=1)
    b_ms, b_by = bound_ms(dbytes, dops)
    print(f"block_sparse_decode_paged_quant: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by}); with the host's enqueue hidden (information only): kernel "
          f"{t_k_dev:.4f} ms; context only: SDPA dense over the pre-dequantized gathered view "
          f"(masked at kv_len, dequant not timed) {t_ctx:.4f} ms")
    report_decode("block_sparse_decode_paged_quant", q, idx, t_k, t_k_dev, dbytes, b_ms, dec)
    return {"block_sparse_decode_paged_quant": dict(
        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None)}


def phase_quant_kernels(seen):
    """The contiguous int8 decode (TPU body 2q) vs plain on the generate
    path's layer-0 caches quantized per cache block (no model path runs
    it); timings and bound."""
    (q, kc, vc, idx, kv_len), kw = seen["sparse_decode"]
    bs = kw["block_size"]
    b, hkv, s_max, dh = kc.shape
    every = torch.ones((), dtype=torch.bool, device=kc.device)
    (kq, ks), (vq, vs) = (
        (c.reshape(kc.shape), sc[..., 0]) for c, sc in
        (pg.quantize_block(x.reshape(b, hkv, s_max // bs, bs, dh), every) for x in (kc, vc)))
    print(f"int8 contiguous caches from the generate path's layer 0: {tuple(kq.shape)} "
          f"({kq.dtype}), scales {tuple(ks.shape)}")

    def kernel(qq, ix, num_splits=None):
        return bsd.sparse_decode_quant_cuda(qq, kq, vq, ix, kv_len, block_size=bs,
                                            k_scales=ks, v_scales=vs, num_splits=num_splits)

    def plain(qq, ix):
        return bsd.sparse_decode_plain(qq, kq, vq, ix, kv_len, block_size=bs, k_scales=ks,
                                       v_scales=vs)

    err = check_decode("block_sparse_decode_quant", kernel, plain, decode_cases(q, idx))
    dec = lambda ns=None: kernel(q, idx, num_splits=ns)
    t_k, t_k_dev = time_ms(dec), time_ms(dec, hide_host=True)
    t_p = time_ms(lambda: plain(q, idx))
    n = int(kv_len.max())
    deq = [pg.dequantize_block(c.reshape(b, hkv, s_max // bs, bs, dh), sc[..., None])
           .reshape(kc.shape)[:, :, :n].to(q.dtype) for c, sc in ((kq, ks), (vq, vs))]
    t_ctx = sdpa_masked_ms(q, *deq, kv_len)
    del deq
    dbytes, dops = decode_work(q, idx, kv_len, bs, kv_es=1)
    b_ms, b_by = bound_ms(dbytes, dops)
    print(f"block_sparse_decode_quant: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by}); with the host's enqueue hidden (information only): kernel "
          f"{t_k_dev:.4f} ms; context only: SDPA dense over the pre-dequantized cache "
          f"({n} tokens, masked at kv_len, dequant not timed) {t_ctx:.4f} ms")
    report_decode("block_sparse_decode_quant", q, idx, t_k, t_k_dev, dbytes, b_ms, dec)
    return {"block_sparse_decode_quant": dict(
        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None)}


def profiled_window(eng, skip: int = 2, steps: int = 3):
    """Profile decode steps ``skip`` to ``skip + steps`` of the engine's
    next serve with torch.profiler, from the start of one step to the
    start of another, so that the window holds whole iterations (the model
    step, the argmax copy and the host's scheduling): returns the window's
    record, which ``window_stats`` reads once the serve ran, and a
    function that unwraps the engine's step. The record's ``wall`` is the
    window's steps, its ``span`` that and the profiler's start and stop
    (what the window adds to the serve's wall)."""
    from torch.profiler import ProfilerActivity, profile
    real = eng.api
    rec = {"prof": profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]),
           "steps": steps, "wall": 0.0, "span": 0.0}
    calls = [0]

    def step(*a, **kw):
        if calls[0] == skip:
            rec["span"] = time.perf_counter()
            rec["prof"].start()
            torch.cuda.synchronize()
            rec["wall"] = time.perf_counter()
        elif calls[0] == skip + steps:
            torch.cuda.synchronize()
            rec["wall"] = time.perf_counter() - rec["wall"]
            rec["prof"].stop()
            rec["span"] = time.perf_counter() - rec["span"]
            rec["done"] = True
        calls[0] += 1
        return real.decode_step_paged(*a, **kw)

    eng.api = real._replace(decode_step_paged=step)

    def undo():
        eng.api = real
    return rec, undo


def window_stats(rec) -> dict:
    """A closed ``profiled_window``'s key averages and device kernels, and a
    step's numbers: its wall under the profiler, device busy and the NCCL
    kernels' part of it (ms), kernel launches, collectives and their host
    time (ms)."""
    if not rec.get("done"):
        fail("the profiled window did not close: the serve ran too few steps")
    steps = rec["steps"]
    ka = rec["prof"].key_averages()
    kernels, busy = cuda_kernels(ka)
    # the profiler marks every c10d collective with one record_param_comms
    comms = [e for e in ka if e.key == "record_param_comms"]
    return {"ka": ka, "kernels": kernels, "per_step": 1e3 * rec["wall"] / steps,
            "busy": busy / steps,
            "nccl": sum(e.self_device_time_total for e in kernels
                        if "nccl" in e.key.lower()) / 1e3 / steps,
            "launches": sum(e.count for e in kernels) / steps,
            "collectives": sum(e.count for e in comms) / steps,
            "comm_ms": sum(e.self_cpu_time_total for e in comms) / 1e3 / steps}


def phase_serve_profile(cfg, params, options=DecodeOptions(), shard=None,
                        label: str = "serve", skip: int = 2, steps: int = 3):
    """Where a serve() decode iteration's time goes: ``profiled_window``
    over decode steps ``skip`` to ``skip + steps``, with every slot busy.
    Prints the top device kernels and host ops, the device's busy share
    and the launches and collectives per iteration."""
    reqs = [dict(r, max_new_tokens=skip + steps + 2)
            for r in serve_requests(cfg.vocab_size)[:SERVE_SLOTS]]
    eng = DecodeEngine(cfg, params, max_len=max(p for p, _ in SERVE_SPECS) + 8,
                       options=options, shard=shard)
    rec, _ = profiled_window(eng, skip, steps)
    eng.serve(reqs, n_slots=SERVE_SLOTS)
    w = window_stats(rec)
    print(w["ka"].table(sort_by="self_device_time_total", row_limit=15))
    print(w["ka"].table(sort_by="self_cpu_time_total", row_limit=12))
    print(f"{label} profile ({SERVE_SLOTS} slots busy, {steps} iterations): "
          f"{w['per_step']:.2f} ms per iteration under the profiler; device busy "
          f"{w['busy']:.2f} ms/iteration = {100 * w['busy'] / w['per_step']:.1f}% of it; "
          f"{w['launches']:.0f} kernel launches/iteration; "
          f"{w['collectives']:.0f} collectives/iteration, "
          f"{w['comm_ms']:.2f} ms/iteration of host time in them; "
          f"{gate_profile(w['kernels'], steps)}")

# ---------------------------------------------------------------------------
# the rest of the decode API: Quest, the oracle, the sliding window, the
# SelectionSchedule, per-request budgets and sampling
# ---------------------------------------------------------------------------

def holes(idx):
    """The list widened to 2k with a -1 after every entry: -1 holes in the
    middle of a list, as the sliding window leaves them."""
    return torch.stack([idx, torch.full_like(idx, -1)], dim=-1).reshape(
        *idx.shape[:-1], 2 * idx.shape[-1])


def budget_tail(idx):
    """Rows capped at k/4, k/2, 1 and k slots in turn, -1 past the cap, as
    the per-request budget mask leaves them."""
    k = idx.shape[-1]
    caps = torch.tensor([max(1, k // 4), max(1, k // 2), 1, k],
                        device=idx.device).repeat(idx.shape[0])[:idx.shape[0]]
    keep = torch.arange(k, device=idx.device)[None, None, :] < caps[:, None, None]
    return torch.where(keep, idx, -1)


def window_ids(kv_len, k_cache=None, k_pages=None, page_table=None):
    """SlidingWindowPolicy(sink_blocks=1)'s ids for these lengths: the
    trailing block, the sink, then the window backwards."""
    inp = SelectionInputs(q_nope=None, qr=None, pos=None, new_len=kv_len, k_cache=k_cache,
                          k_pages=k_pages, page_table=page_table)
    cfg = configs.get("qwen3_0_6b")
    return SlidingWindowPolicy(sink_blocks=1).select(inp, cfg)


def check_new_lists(name, kernel, plain, q, cases, kv_len, bs, paged=False, kv_es=None):
    """A decode kernel (``kernel(q, ids)``) against its plain version on
    the id lists of the decode API's other paths (score or window order,
    -1 holes in the middle, a budget-masked -1 tail), within phase 3's
    limit, each call timed as phase 3 times it, with its bound."""
    err = check_decode(name, kernel, plain, cases)
    work = paged_decode_work if paged else decode_work
    for label, qq, ix in cases:
        t_k = time_ms(lambda: kernel(qq, ix))
        t_p = time_ms(lambda: plain(qq, ix))
        b_ms, by = bound_ms(*work(qq, ix, kv_len, bs, kv_es))
        print(f"{name} [{label}]: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
              f"{b_ms:.5f} ms ({by}); {int((ix >= 0).sum())} of {ix.numel()} entries live")
    return err


def generate_capture(eng, batch, n_new, n_layers):
    """generate() with the launch counters at 0 just before and read just
    after; the ids of every layer's sparse decode in the first decode
    step, and layer 0's arguments, kept."""
    ids, layer0 = [], {}
    real = ops.sparse_decode

    def grab(q, kc, vc, idx, kv_len, **kw):
        if len(ids) < n_layers:
            if not ids:
                layer0.update(q=q, kc=kc, vc=vc, idx=idx.clone(), kv_len=kv_len.clone(),
                              bs=kw["block_size"])
            ids.append(idx.clone())
        return real(q, kc, vc, idx, kv_len, **kw)

    ops.sparse_decode = grab
    ops.reset_launch_counts()
    try:
        torch.cuda.synchronize()
        res = eng.generate(batch, n_new)
    finally:
        counts = ops.launch_counts()
        ops.sparse_decode = real
    return res, counts, ids, layer0


def phase_quest_generate(cfg, params, batch, max_len, gate_sparsity):
    """Quest on generate at full width, against QuestRecomputePolicy on the
    card: equal tokens, bitwise equal ids at every layer of the first
    decode step, only #2 launching (28 x steps), the gate run's measured
    sparsity; #2 on the Quest lists; then the step's wall and device busy
    time."""
    t0 = time.perf_counter()
    steps = QUEST_NEW - 1
    runs = {}
    for name, pol in (("quest", QuestPolicy()), ("quest_recompute", QuestRecomputePolicy())):
        eng = DecodeEngine(cfg, params, max_len=max_len, options=DecodeOptions(policy=pol))
        res, counts, ids, layer0 = generate_capture(eng, batch, QUEST_NEW, cfg.num_layers)
        want = stage_counts(eng.options, cfg.num_layers, steps, paged=False)
        if counts != want:
            fail(f"{name} generate launch counts {counts}, expected {want}")
        stats = eng.sparsity_stats()
        print(f"{name} generate: decode {1e3 * res['decode_s'] / steps:.2f} ms/step "
              f"({steps} steps, batch {BATCH}), measured sparsity {stats['sparsity']:.6f} (sel "
              f"{stats['sel_blocks']:.1f} of {stats['vis_blocks']:.1f} blocks); launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        runs[name] = (res["tokens"], ids, stats["sparsity"], eng, layer0)
    (tq, iq, sq, eng, layer0), (tr, ir, sr, _, _) = runs["quest"], runs["quest_recompute"]
    if not torch.equal(tq, tr):
        fail("quest generate tokens differ from quest_recompute's")
    bad = [i for i, (a, b) in enumerate(zip(iq, ir)) if not torch.equal(a, b)]
    if len(iq) != cfg.num_layers or bad:
        fail(f"quest first-step ids differ from quest_recompute's at layers {bad}")
    if not sq == sr == gate_sparsity:
        fail(f"quest measured sparsity {sq} (recompute {sr}) != the gate run's {gate_sparsity}")
    print(f"quest generate: tokens and the first decode step's ids at all {cfg.num_layers} "
          f"layers bitwise those of quest_recompute; measured sparsity {sq:.6f} equal to the "
          f"gate run's")
    del runs
    q, kc, vc, idx, kv_len, bs = (layer0[k] for k in ("q", "kc", "vc", "idx", "kv_len", "bs"))
    err = check_new_lists(
        "block_sparse_decode (Quest lists)",
        lambda qq, ix: bsd.sparse_decode_cuda(qq, kc, vc, ix, kv_len, block_size=bs),
        lambda qq, ix: bsd.sparse_decode_plain(qq, kc, vc, ix, kv_len, block_size=bs), q,
        [("quest score order", q, idx), ("quest, -1 holes in the middle", q, holes(idx)),
         ("quest, budget-masked tail", q, budget_tail(idx))], kv_len, bs)
    del layer0, q, kc, vc
    torch.cuda.empty_cache()
    wall, busy = phase_profile(eng, batch, label="quest decode step")
    print(f"phase quest generate: {time.perf_counter() - t0:.1f} s; step {wall:.2f} ms wall, "
          f"device busy {busy:.2f} ms")
    return err


def phase_policy_generate(cfg, params, batch, max_len):
    """The oracle, the sliding window and two gate schedules on generate at
    full width, each from a copy of one prefilled state: every run's
    launches those its stages predict. The oracle at a budget of every
    block against DensePolicy: at layer 0 of the first step it selects
    every visible block, and #2 over them agrees with the dense decode
    attention DensePolicy runs, on the same q/K/V, within phase 3's decode
    limit; the first-step logits, after 28 layers of such differences in
    bf16, within DECODE_ULPS bf16 ulps of max|logit| (phase 11's rule for
    logits whose sums are only reordered). #2 on the window's lists."""
    t0 = time.perf_counter()
    base = DecodeEngine(cfg, params, max_len=max_len)
    tok0, state0 = base.prefill(batch)
    del base
    variants = [
        ("oracle", DecodeOptions(policy=OraclePolicy()), POLICY_STEPS),
        ("sliding_window(sink_blocks=1)",
         DecodeOptions(policy=SlidingWindowPolicy(sink_blocks=1)), POLICY_STEPS),
        ("gate, dense 2 / select 2 / correction 14", DecodeOptions(
            schedule=SelectionSchedule(dense_first_n=2, select_layer=2,
                                       correction_layers=(14,))), POLICY_STEPS),
        ("gate, unify_heads", DecodeOptions(schedule=SelectionSchedule(unify_heads=True)),
         POLICY_STEPS),
        ("oracle, every block", DecodeOptions(policy=OraclePolicy(), budget_override=max_len), 1),
        ("dense", DecodeOptions(policy=DensePolicy()), 1),
    ]
    first, layer0 = {}, {}
    for name, opts, steps in variants:
        eng = DecodeEngine(cfg, params, max_len=max_len, options=opts)
        state = state0._replace(**{f: getattr(state0, f).clone() for f in
                                   ("k_cache", "v_cache", "kg_cache", "kg_n", "cur_len")})
        tok = tok0
        seen = []
        real = ops.sparse_decode
        if name.startswith(("sliding", "oracle, every")):
            def grab(q, kc, vc, idx, kv_len, **kw):
                if not seen:
                    seen.append((q, kc, vc, idx.clone(), kv_len.clone(), kw["block_size"]))
                return real(q, kc, vc, idx, kv_len, **kw)
            ops.sparse_decode = grab
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        try:
            for i in range(steps):
                tok, lg, state, aux = eng._step(eng.params, state, tok)
                if i == 0:
                    first[name] = lg.float()
            torch.cuda.synchronize()
        finally:
            counts = ops.launch_counts()
            ops.sparse_decode = real
        ms = 1e3 * (time.perf_counter() - t1) / steps
        want = stage_counts(opts, cfg.num_layers, steps, paged=False)
        print(f"{name} generate: {steps} steps, {ms:.2f} ms/step, measured sparsity of the "
              f"last step {float(aux['sparsity']):.4f}; launches "
              f"{ {k: v for k, v in counts.items() if v} } (expected from the stages)")
        if counts != want:
            fail(f"{name}: launch counts {counts}, expected {want}")
        if not torch.isfinite(first[name]).all():
            fail(f"{name}: non-finite logits")
        if seen:
            layer0[name] = seen[0]
        del state, eng
    del state0
    q, kc, vc, idx, kv_len, bs = layer0.pop("oracle, every block")
    vis = -(-kv_len // bs)
    every = torch.arange(idx.shape[-1], device=idx.device)[None, None, :] < vis[:, None, None]
    ar = torch.arange(idx.shape[-1], device=idx.device, dtype=idx.dtype)
    if not bool((torch.sort(idx, dim=-1).values
                 == torch.where(every, ar, -1).sort(dim=-1).values).all()):
        fail(f"the oracle at a budget of every block did not select every visible block: "
             f"{idx[:, 0].tolist()} (visible {vis.tolist()})")
    b, hkv, g, dh = q.shape
    o_k = bsd.sparse_decode_cuda(q, kc, vc, idx, kv_len, block_size=bs).reshape(b, 1, -1, dh)
    o_d = decode_attention(q.reshape(b, 1, hkv * g, dh), kc, vc, kv_len)
    err = float((o_k.float() - o_d.float()).abs().max())
    lim, ulp, top = decode_limit(o_d)
    print(f"oracle at a budget of every block, layer 0: all {int(vis.max())} visible blocks "
          f"selected; #2 over them vs DensePolicy's dense decode attention: max abs err "
          f"{err:.3e} = {err / ulp:.3g} ulp of max|o| {top:.4f} (limit {lim:.3e})")
    if not err <= lim:
        fail(f"oracle at full budget: layer 0 attention {err} from dense (limit {lim})")
    a, d = first["oracle, every block"], first["dense"]
    err = float((a - d).abs().max())
    ulp = 2.0 ** -7 * 2.0 ** math.floor(math.log2(float(d.abs().max())))
    print(f"oracle at a budget of every block vs dense: first-step logits max abs diff "
          f"{err:.3e} = {err / ulp:.3g} bf16 ulps of max|logit| {float(d.abs().max()):.4f} "
          f"(limit {DECODE_ULPS})")
    if not err <= DECODE_ULPS * ulp:
        fail(f"oracle at full budget: logits {err / ulp:.2f} bf16 ulps from dense's")
    del o_k, o_d, q, kc, vc
    q, kc, vc, idx, kv_len, bs = layer0.pop("sliding_window(sink_blocks=1)")
    w_err = check_new_lists(
        "block_sparse_decode (window lists)",
        lambda qq, ix: bsd.sparse_decode_cuda(qq, kc, vc, ix, kv_len, block_size=bs),
        lambda qq, ix: bsd.sparse_decode_plain(qq, kc, vc, ix, kv_len, block_size=bs), q,
        [("window order", q, idx), ("window, -1 holes in the middle", q, holes(idx)),
         ("window, budget-masked tail", q, budget_tail(idx))], kv_len, bs)
    del layer0, q, kc, vc
    torch.cuda.empty_cache()
    print(f"phase policy generate: {time.perf_counter() - t0:.1f} s")
    return w_err


def paged_new_lists(name, seen):
    """#4 or 4q on a serve's captured layer-0 tensors with its captured
    ids and the window, hole and tail lists made from them."""
    (q, kp, vp, idx, pt_d, kv_len), kw = seen["paged_sparse_decode"]
    bs, ks, vs = kw["block_size"], kw.get("k_scales"), kw.get("v_scales")
    quant = ks is not None
    if quant:
        kernel = lambda qq, ix: bsd.sparse_decode_paged_quant_cuda(
            qq, kp, vp, ix, pt_d, kv_len, block_size=bs, k_scales=ks, v_scales=vs)
    else:
        kernel = lambda qq, ix: bsd.sparse_decode_paged_cuda(qq, kp, vp, ix, pt_d, kv_len,
                                                             block_size=bs)
    plain = lambda qq, ix: bsd.sparse_decode_paged_plain(qq, kp, vp, ix, pt_d, kv_len,
                                                         block_size=bs, k_scales=ks,
                                                         v_scales=vs)
    win = window_ids(kv_len, k_pages=kp, page_table=pt_d)
    cases = [("captured", q, idx), ("captured, -1 holes in the middle", q, holes(idx)),
             ("captured, budget-masked tail", q, budget_tail(idx)),
             ("window, sink 1", q, win), ("window, -1 holes in the middle", q, holes(win))]
    return check_new_lists(name, kernel, plain, q, cases, kv_len, bs, paged=True,
                           kv_es=1 if quant else None)


def phase_quest_serve(cfg, params, gate_tight_stats):
    """Quest on serve at full width over fp pools (1029 pages, then 644,
    which preempts): tight == ample bitwise (the metadata rows survive the
    swap), the swapped bytes those of the gate run plus the two f32
    metadata rows of each page, only #4 launching; #4 on the captured Quest
    lists; then once over int8 pools (ample), only 4q launching, 4q on its
    lists, and the share of its tokens equal to the fp run's."""
    t0 = time.perf_counter()
    quest = DecodeOptions(policy=QuestPolicy())
    counts, seen, qa, qt = phase_serve(cfg, params, quest)
    ps, dh, hkv = cfg.gate.block_size, cfg.resolved_head_dim, cfg.n_kv_heads
    es = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    per_gate = hkv * (2 * ps * dh * es + cfg.gate.d_gate * es)
    per_quest = per_gate + hkv * 2 * dh * 4
    gb, qb = gate_tight_stats["swapped_out_bytes"], qt["stats"]["swapped_out_bytes"]
    if qb * per_gate != gb * per_quest or not qb:
        fail(f"quest swap {qb} B is not the gate run's {gb} B x {per_quest}/{per_gate}")
    print(f"quest serve: swapped {qb} B each way, the gate run's {gb} B with each page's two "
          f"f32 metadata rows ({per_quest} B a page and layer, gate {per_gate})")
    err = paged_new_lists("block_sparse_decode_paged (Quest serve)", seen)
    del seen
    q8 = quest.replace(quantize="int8")
    q8_counts, seen, q8a, _ = phase_serve(cfg, params, q8, tight_pool=False)
    same = sum(int((np.asarray(qa[r]) == np.asarray(q8a[r])).sum())
               for r in range(len(SERVE_SPECS)))
    total = sum(len(qa[r]) for r in range(len(SERVE_SPECS)))
    print(f"quest int8 serve: {q8_counts['block_sparse_decode_paged_quant']} launches of "
          f"block_sparse_decode_paged_quant; tokens equal to the fp Quest run {same}/{total} "
          f"(information only)")
    err_q = paged_new_lists("block_sparse_decode_paged_quant (Quest int8 serve)", seen)
    del seen
    torch.cuda.empty_cache()
    print(f"phase quest serve: {time.perf_counter() - t0:.1f} s")
    return err, err_q


def phase_request_overrides(cfg, params):
    """serve with per-request overrides at full width: rids 0 and 1 with a
    budget of OVERRIDE_BUDGET tokens, rids 2 and 3 sampling at
    OVERRIDE_SAMPLING, ample and tight pools: each capped request selects
    exactly its cap in blocks at every step, the tight run reproduces the
    ample one (the stochastic requests too); #4 on the captured capped
    lists."""
    t0 = time.perf_counter()
    reqs = serve_requests(cfg.vocab_size)
    for rid in (0, 1):
        reqs[rid]["budget"] = OVERRIDE_BUDGET
    for rid in (2, 3):
        reqs[rid]["sampling"] = OVERRIDE_SAMPLING
    _, seen, ample, tight = phase_serve(cfg, params, reqs=reqs)
    cap = OVERRIDE_BUDGET // cfg.gate.block_size
    st = ample["stats"]
    for rid in (0, 1):
        if st["sel_blocks_by_rid"][rid] != cap:
            fail(f"rid {rid}: {st['sel_blocks_by_rid'][rid]} blocks selected a step, cap {cap}")
    print(f"request overrides: rids 0, 1 (budget {OVERRIDE_BUDGET}) select {cap} blocks at "
          f"every step, sparsity " + ", ".join(f"{r}: {st['sparsity_by_rid'][r]:.4f}"
                                                  for r in range(len(reqs)))
          + f"; rids 2, 3 sample at {OVERRIDE_SAMPLING}; tight pool "
          f"({tight['stats']['preemptions']} preemptions) reproduces every request's tokens")
    err = paged_new_lists("block_sparse_decode_paged (budget-capped serve)", seen)
    del seen
    torch.cuda.empty_cache()
    print(f"phase request overrides: {time.perf_counter() - t0:.1f} s")
    return err


# ---------------------------------------------------------------------------
# gate distillation training (TPU kernel 6)
# ---------------------------------------------------------------------------

def tiny_cfg():
    cfg = reduced(configs.get("qwen3_0_6b")).replace(dtype="float32")
    return cfg.replace(gate=dataclasses.replace(cfg.gate, block_size=8, d_gate=16,
                                                token_budget=32))


def small_train_agreement(dev: str = "cuda"):
    """The tiny config (fp32) takes 3 distill steps on ``dev`` and on the
    CPU from the same state. Returns the KL history on ``dev``, the largest
    KL difference relative to the CPU's, the largest gate parameter
    difference, and the launch counts with those expected (each forward's
    layers through kernel 6, nothing else)."""
    cfg = tiny_cfg()
    tcfg = TrainConfig(optim=OptimConfig(lr=3e-3, warmup_steps=2, total_steps=8))
    state = tl.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg)
    states = {"cpu": state, dev: train_state_to(state, dev)}
    step = tl.make_train_step(cfg, tcfg)
    kls = {"cpu": [], dev: []}
    ops.reset_launch_counts()
    for i in range(3):
        for d in ("cpu", dev):
            batch = make_batch(cfg, 2, 64, DataState(0, i), device=d)
            states[d], m = step(states[d], batch)
            kls[d].append(float(m["kl"]))
    counts = ops.launch_counts()
    kl_err = max(abs(a - b) / abs(b) for a, b in zip(kls[dev], kls["cpu"]))
    g_err = max(float((states[dev].gate[k].cpu() - t).abs().max())
                for k, t in states["cpu"].gate.items())
    want = {**dict.fromkeys(ops.KERNELS, 0), "gate_gt_attention": 3 * cfg.num_layers}
    return kls[dev], kl_err, g_err, counts, want


def phase_small_train():
    """Small-input agreement of training: KL per step within 1e-4
    relative, gate parameters within 1e-4 (the CPU run is held against the
    JAX reference by tests/test_torch_train.py; an Adam update is ~lr =
    3e-3 an entry, so a gradient sign flipped by rounding would show)."""
    kls, kl_err, g_err, counts, want = small_train_agreement("cuda")
    if counts != want or not kl_err <= 1e-4 or not g_err <= 1e-4:
        fail(f"small train agreement: launch counts {counts} (expected {want}), KL rel diff "
             f"{kl_err:.3e} (limit 1e-4), gate max abs diff {g_err:.3e} (limit 1e-4)")
    print(f"small train agreement (tiny qwen3, fp32, 2x64 tokens, 3 distill steps): KL "
          f"{[round(x, 6) for x in kls]}, rel diff to the CPU {kl_err:.3e}, gate max "
          f"abs diff {g_err:.3e}, {counts['gate_gt_attention']} launches of gate_gt_attention")


def capture_gt_layer0(params, batch, cfg):
    """One distill forward; the arguments of its first gate_gt_attention
    call (layer 0; the hybrid's unit-0 shared block), which the training
    run's first step repeats."""
    seen = {}
    real = ops.gate_gt_attention

    def grab(*a, **kw):
        seen.setdefault("gate_gt_attention", (tuple(t.clone() for t in a),
                                              {k: (v.clone() if torch.is_tensor(v) else v)
                                               for k, v in kw.items()}))
        return real(*a, **kw)

    ops.gate_gt_attention = grab
    try:
        with torch.no_grad():
            get_api(cfg).forward(params, batch, cfg, mode="distill")
    finally:
        ops.gate_gt_attention = real
    torch.cuda.synchronize()
    return seen["gate_gt_attention"]


def gt_work(q, k, seg, block_size):
    """(bytes, operations) of kernel 6 on these inputs: q, k, v, o and
    seg read or written once, blockmax written once; two matmuls over the
    (query, key) pairs this data needs, the causal pairs within each
    document: 4 * Dh * H * sum over documents of n (n + 1) / 2."""
    b, l, h, dh = q.shape
    nb = l // block_size
    es = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * es + b * h * l * nb * 4 + seg.numel() * 4
    _, counts = torch.unique_consecutive(seg.cpu().long() + (torch.arange(b)[:, None] << 32),
                                         return_counts=True)
    n = counts.double()
    pairs = float((n * (n + 1) / 2).sum())
    return nbytes, 4 * dh * h * pairs


def gt_tile_pairs(seg):
    """(pairs, causal pairs): the (query tile, key tile) pairs of each
    (batch row, head) that kernel 6's bf16 body computes, summed over the
    batch rows, and the causal pairs it would compute without skipping. A
    pair is skipped when the two tiles' segment-id ranges do not overlap
    (they share no document)."""
    s = seg.cpu().numpy()
    b, l = s.shape
    nt = -(-l // gt.TILE)
    tiles = np.pad(s, ((0, 0), (0, nt * gt.TILE - l)), mode="edge").reshape(b, nt, gt.TILE)
    lo, hi = tiles.min(-1), tiles.max(-1)
    causal = np.tril(np.ones((nt, nt), bool))
    overlap = (lo[:, :, None] <= hi[:, None, :]) & (lo[:, None, :] <= hi[:, :, None])
    return int((overlap & causal).sum()), b * int(causal.sum())


def gt_agreement(q, k, v, bs, qc, seg, label):
    """Kernel 6 against its plain version on one input: o within phase 3's
    decode limit, blockmax NEG_INF in the same places and within GT_BM_REL
    of max|blockmax| elsewhere; fails otherwise. Returns o's max abs
    error."""
    o_k, bm_k = gt.gate_gt_attention_cuda(q, k, v, block_size=bs, segment_ids=seg)
    o_p, bm_p = gt.gate_gt_attention_plain(q, k, v, block_size=bs, q_chunk=qc,
                                           segment_ids=seg)
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    lim, ulp, top = decode_limit(o_p)
    dead = bm_p <= -1e29
    same_dead = torch.equal(bm_k <= -1e29, dead) and bool((bm_k[dead] == -1e30).all())
    bm_top = float(bm_p[~dead].abs().max())
    bm_err = float((bm_k[~dead] - bm_p[~dead]).abs().max())
    print(f"gate_gt_attention [{label}]: o max abs err {err:.3e} = "
          f"{err / ulp if ulp else 0.0:.3g} ulp of max|o_plain| {top:.4f} (limit {lim:.3e}); "
          f"blockmax NEG_INF in the same {int(dead.sum())} places: {same_dead}, max abs err "
          f"{bm_err:.3e} of max|blockmax| {bm_top:.3f} (limit {GT_BM_REL:g} of it)")
    if not err <= lim or not same_dead or not bm_err <= GT_BM_REL * bm_top:
        fail(f"gate_gt_attention disagrees with plain [{label}]")
    return err


def phase_gt_kernel(args, kw):
    """Kernel 6 against its plain version on layer 0's tensors of the first
    training step, with the packing segments and without; timings, the
    share of tile pairs skipped and the rate over the operations issued."""
    q, k, v = args
    seg, bs, qc = kw["segment_ids"], kw["block_size"], kw["q_chunk"]
    b, l, h, dh = q.shape
    heads = 2 if (h // k.shape[2]) % 2 == 0 and dh <= 128 else 1
    smem = (heads + 4) * gt.TILE * (dh + 8) * 2 + 2 * gt.TILE * 4 + 8 * -(-l // gt.TILE)
    print(f"kernel 6 inputs (layer 0, step 0): q {tuple(q.shape)} k/v {tuple(k.shape)} "
          f"{q.dtype}, block {bs}, {int((seg[:, 1:] != seg[:, :-1]).sum()) + b} documents "
          f"in {b} rows; bf16 tensor-core body: CTAs of 4 warps over {gt.TILE} rows x "
          f"{heads} heads, {smem} B of dynamic shared memory")
    worst = max(gt_agreement(q, k, v, bs, qc, sg, label)
                for label, sg in (("packed segments", seg), ("no segments", None)))
    t_k = time_ms(lambda: gt.gate_gt_attention_cuda(q, k, v, block_size=bs, segment_ids=seg),
                  runs=10, warmup=2)
    t_k0 = time_ms(lambda: gt.gate_gt_attention_cuda(q, k, v, block_size=bs), runs=10, warmup=2)
    t_dev = time_ms(lambda: gt.gate_gt_attention_cuda(q, k, v, block_size=bs, segment_ids=seg),
                    runs=10, warmup=2, hide_host=True)
    t_p = time_ms(lambda: gt.gate_gt_attention_plain(q, k, v, block_size=bs, q_chunk=qc,
                                                     segment_ids=seg), runs=10, warmup=2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), runs=10, warmup=2)
    nbytes, ops_n = gt_work(q, k, seg, bs)
    bound, by = bound_ms(nbytes, ops_n)
    causal_ops = 4 * dh * b * h * l * (l + 1) / 2
    pairs, all_pairs = gt_tile_pairs(seg)
    tile_ops = 4 * dh * h * gt.TILE * gt.TILE       # the products of one pair, all heads
    print(f"gate_gt_attention: kernel {t_k:.4f} ms (device work alone {t_dev:.4f} ms; no "
          f"segments {t_k0:.4f} ms), plain "
          f"{t_p:.3f} ms, bound {bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {ops_n:.4g} "
          f"operations within documents; all causal pairs {causal_ops:.4g}, "
          f"{1e3 * causal_ops / BF16_OPS_PER_S:.4f} ms); context: SDPA causal, no segments, "
          f"no blockmax {t_lib:.4f} ms")
    print(f"gate_gt_attention: {pairs} of {all_pairs} causal (query tile, key tile) pairs "
          f"computed, {1 - pairs / all_pairs:.3f} skipped; operations issued "
          f"{pairs * tile_ops:.4g} at {pairs * tile_ops / t_k / 1e9:.1f} TFLOP/s; without "
          f"segments {all_pairs * tile_ops:.4g} at {all_pairs * tile_ops / t_k0 / 1e9:.1f} "
          f"TFLOP/s; SDPA {causal_ops / t_lib / 1e9:.1f} TFLOP/s")
    return {"gate_gt_attention": dict(max_abs_err=worst, ms=t_k, plain_ms=t_p, bound_ms=bound,
                                      bound_by=by, library_ms=None)}


def phase_train(cfg):
    """run_training at full width in distill mode (bf16, random weights
    from seed 0): TRAIN_STEPS steps, a checkpoint every TRAIN_CKPT_EVERY,
    one failure injected before step TRAIN_FAIL_AT. Launch counters at 0
    just before, read just after: gate_gt_attention 28 x the forwards run,
    every other kernel 0. Every KL finite, the base parameters bitwise
    those of the seed, the gate moved, the replayed step's loss equal to
    the first run's. Then kernel 6 on layer 0's tensors, and a profile."""
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tcfg = TrainConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                           seed=SEED, checkpoint_every=TRAIN_CKPT_EVERY,
                           checkpoint_dir=ckpt_dir, log_every=1,
                           optim=OptimConfig(total_steps=TRAIN_STEPS, warmup_steps=1))
        print(f"training: qwen3_0_6b distill, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
              f"{TRAIN_STEPS} steps, checkpoint every {TRAIN_CKPT_EVERY}, failure before "
              f"step {TRAIN_FAIL_AT}; {tcfg.optim}")
        seed_state = tl.init_train_state(torch.Generator(device="cuda").manual_seed(SEED),
                                         cfg, tcfg)
        batch0 = make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, DataState(SEED, 0), device="cuda")
        captured = capture_gt_layer0(seed_state.params, batch0, cfg)
        del batch0
        armed = [True]

        def fail_at(i):
            if i == TRAIN_FAIL_AT and armed[0]:
                armed[0] = False
                raise RuntimeError("injected node failure")

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = tl.run_training(cfg, tcfg, fail_at=fail_at, device="cuda")
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = [h["step"] for h in hist]
        n_fwd = len(hist)
        print(f"training: {n_fwd} forwards (steps {steps}) in {wall:.2f} s wall, including "
              f"init, batches, checkpoints and the restore; peak memory {peak:.1f} GiB; "
              f"launch counts {counts}")
        want = {**dict.fromkeys(ops.KERNELS, 0), "gate_gt_attention": cfg.num_layers * n_fwd}
        if counts != want:
            fail(f"training launch counts {counts}, expected {want}")
        if steps != [0, 1, 2, 2, 3] or int(state.step) != TRAIN_STEPS:
            fail(f"training steps {steps}, final step {int(state.step)}")
        if not all(math.isfinite(h["kl"]) and math.isfinite(h["loss"]) for h in hist):
            fail("non-finite KL in training")
        first, replay = (h["loss"] for h in hist if h["step"] == TRAIN_CKPT_EVERY)
        if not abs(first - replay) <= 1e-6 * abs(first):
            fail(f"replayed step {TRAIN_CKPT_EVERY}: loss {replay} != {first}")
        seed_leaves = dict(tl._walk(seed_state.params))
        frozen = all(torch.equal(t, seed_leaves[p])
                     for p, t in tl._walk(state.params) if not tl.is_gate_path(p))
        moved = sum(not torch.equal(state.gate[k], seed_state.gate[k]) for k in state.gate)
        if not frozen or moved == 0:
            fail(f"base params bitwise unchanged: {frozen}; gate leaves moved: {moved}")
        print(f"training: KL by step {[(h['step'], round(h['kl'], 6)) for h in hist]}; "
              f"replayed step {TRAIN_CKPT_EVERY} loss {'bitwise ' if first == replay else ''}"
              f"equal; base params bitwise unchanged; {moved} of {len(state.gate)} gate "
              f"leaves moved")
        check_train_checkpoint(ckpt_dir, state, cfg)
        del seed_state
        torch.cuda.empty_cache()
        phase_train_profile(cfg, tcfg, state)
        del state
        torch.cuda.empty_cache()
        return counts["gate_gt_attention"], captured
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def reference_leaves(state):
    """[(path, shape, dtype)] of the train state's checkpoint tree
    {"params", "gate", "opt"} as the JAX package holds and flattens it:
    dict keys sorted at every level, the per-layer "blocks" list as one
    dict of [L, ...] leaves, the gate and moment keys "blocks/<i>/<rest>"
    as "blocks/<rest>" of [L, ...], AdamWState's fields in order (m, v,
    count; ef None holds none); in pretrain (gate None, no leaves) the
    moments are fp32 trees shaped like the parameters. Written from that
    rule alone, not from the port's checkpoint code."""
    def tree(t, path):
        if isinstance(t, dict):
            return [x for key in sorted(t) for x in tree(t[key], f"{path}/{key}")]
        if isinstance(t, list):     # the layer list: stacked
            return [(p, [len(t)] + shape, dt) for p, shape, dt in tree(t[0], path)]
        return [(path, list(t.shape), t.dtype)]

    def layered(d, path):           # {"blocks/<i>/<rest>": t} -> "blocks/<rest>" [L, ...]
        rest = {}
        for key, t in d.items():
            _, i, r = key.split("/", 2)
            rest.setdefault(r, []).append(t)
        return [(f"{path}/blocks/{r}", [len(ts)] + list(ts[0].shape), ts[0].dtype)
                for r, ts in sorted(rest.items(), key=lambda kv: f"blocks/{kv[0]}")]

    opt = state.opt
    count = [("opt/count", list(opt.count.shape), opt.count.dtype)]
    params = tree(state.params, "params")
    if state.gate is None:          # pretrain: the moments nested like params, fp32
        return ([(f"opt/{k}{p[len('params'):]}", shape, torch.float32)
                 for k in ("m", "v") for p, shape, _ in params] + count + params)
    return (layered(state.gate, "gate") + layered(opt.m, "opt/m") + layered(opt.v, "opt/v")
            + count + params)


def check_train_checkpoint(ckpt_dir, state, cfg):
    """The last checkpoint of run_training (the final state, saved by the
    port), distill or pretrain: its manifest lists the reference's leaves
    (count, order, shapes, dtypes), and read back it is the final state
    bitwise."""
    step = ckpt.latest_step(ckpt_dir)
    with open(os.path.join(ckpt_dir, f"step_{step}", "manifest.json")) as f:
        manifest = json.load(f)
    want = reference_leaves(state)
    names = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.int32: "int32"}
    if (manifest["n_leaves"] != len(want)
            or manifest["shapes"] != [shape for _, shape, _ in want]
            or manifest["dtypes"] != [names[dt] for _, _, dt in want]):
        fail(f"checkpoint step {step}: {manifest['n_leaves']} leaves {manifest['shapes']} "
             f"{manifest['dtypes']}, the reference's layout has {len(want)}: {want}")
    tree, _ = ckpt.restore(ckpt_dir, step, tl.checkpoint_tree(state), cfg=cfg)
    back = tl.state_from_checkpoint_tree(tree, state.step)
    got, opt = dict(tl._walk(back.params)), back.opt
    equal = (all(torch.equal(got[p], t) for p, t in tl._walk(state.params))
             and all(torch.equal(opt.m[k], state.opt.m[k]) and torch.equal(opt.v[k], state.opt.v[k])
                     for k in state.opt.m)
             and int(opt.count) == int(state.opt.count))
    if not equal:
        fail(f"checkpoint step {step} read back differs from the final state")
    print(f"training checkpoint step {step}: the reference's layout, {len(want)} leaves in "
          f"its order ({want[0][0]} .. {want[-1][0]}), {sum(math.prod(sh) for _, sh, _ in want)} "
          f"numbers; read back bitwise equal to the final state")


def phase_train_profile(cfg, tcfg, state, steps: int = 2, label: str = "training"):
    """Step time before the profiler (host clock around synchronised
    steps), then one step under torch.profiler: top device kernels and the
    device's busy share of the step. Returns (step seconds before the
    profiler, device busy seconds of the profiled step)."""
    step_fn = tl.make_train_step(cfg, tcfg)
    batch = make_batch(cfg, tcfg.global_batch, tcfg.seq_len, DataState(SEED, tcfg.steps),
                       device="cuda")
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])
        times.append(time.perf_counter() - t0)

    def one_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        float(out[1]["loss"])
        return out, time.perf_counter() - t0
    ((state, m), under), ka, kernels, busy = profiled(one_step)
    busy /= 1e3   # s
    print(ka.table(sort_by="self_device_time_total", row_limit=15))
    print(f"{label} step profile: {', '.join(f'{t:.3f}' for t in times)} s a step before the "
          f"profiler, {under:.3f} s under it; device busy {busy:.3f} s = "
          f"{100 * busy / under:.1f}% of the profiled step; "
          f"{sum(e.count for e in kernels)} kernel launches")
    return times, busy


# ---------------------------------------------------------------------------
# the other dense configs: gemma_2b, granite_20b, deepseek_coder_33b
# ---------------------------------------------------------------------------

def other_config(arch):
    """(config, the cuts as printed) of one of OTHER_CONFIGS, FAMILY_CONFIGS
    or RECURRENT_CONFIGS (uncut)."""
    full = configs.get(arch)
    cut = {**OTHER_CONFIGS, **FAMILY_CONFIGS}.get(arch, {})
    cfg = full.replace(**cut)
    reduced_list = [f"{k} {getattr(full, k)} -> {v}" for k, v in cut.items()]
    if arch in FAMILY_PROMPT:
        reduced_list.append(f"prompt {PROMPT_LEN} -> {FAMILY_PROMPT[arch]}")
    return cfg, reduced_list


def small_geometries(arch):
    """(label, fp32 config) of the small card-vs-CPU cases of one config:
    its reduced() geometry, and a one-layer model at its own heads (a MoE
    config also at its own router: E, top-k, shared experts and capacity
    as published, experts of width 64; a vision model one unit of a self
    and a cross layer). A recurrent config has its reduced() geometry
    alone: zamba2_1_2b at 3 layers (one unit of 2 Mamba2 layers and the
    shared block, then a tail layer: both layer kinds), falcon_mamba_7b
    with its (disabled) gate's block cut to 8, the page size serve pages
    at."""
    full = configs.get(arch)
    if full.family == "hybrid":
        return [("reduced", reduced(full, num_layers=3).replace(dtype="float32"))]
    if full.family == "ssm":
        cfg = reduced(full).replace(dtype="float32")
        return [("reduced", cfg.replace(gate=dataclasses.replace(cfg.gate, block_size=8)))]
    own = dict(n_heads=full.n_heads, n_kv_heads=full.n_kv_heads, head_dim=full.head_dim,
               num_layers=2 if full.cross_attn_period else 1)
    label = "own heads, 1 layer"
    if full.family == "moe":
        m = full.moe
        own["moe"] = MoEConfig(n_experts=m.n_experts, top_k=m.top_k,
                               n_shared_experts=m.n_shared_experts, expert_d_ff=64,
                               capacity_factor=m.capacity_factor)
        label = f"own heads and router ({m.n_experts} experts, top {m.top_k}), 1 layer"
    elif full.cross_attn_period:
        label = "own heads, 1 unit (a self and a cross layer)"
    return [("reduced", reduced(full).replace(dtype="float32")),
            (label, reduced(full, **own).replace(dtype="float32"))]


def phase_small_configs():
    """Each other config's, each family config's and each recurrent
    config's reduced() geometry (fp32, gate block 8) and, but for the
    recurrent ones, a small model at its own head geometry (8 x
    256 MQA, 48 x 128 MQA, 56 / 8 x 128; MHA 16 x 128 and 64 / 8 x 128
    with their published routers; 32 / 8 x 128 with a cross layer) on the
    card against the CPU plain path: generate (2 x 41 prompt, a vision
    model with the same seeded image embeddings on both devices, 12 steps,
    tokens equal, logits within 1e-4, each step's attention layers (self
    layers; the hybrid's shared-block units; none for the Mamba1 LM)
    through #1 and #2), and serve with an ample and a preempting pool
    (tokens equal, logits within 1e-4, swapped bytes equal, each step's
    attention layers through #3 and #4) at reduced() for the dense and
    recurrent configs and at both geometries for the MoE ones (the
    reference has no paged step for a vision model)."""
    for arch in (*OTHER_CONFIGS, *FAMILY_CONFIGS, *RECURRENT_CONFIGS):
        for label, cfg in small_geometries(arch):
            api = get_api(cfg)
            n_attn = api.paged_attn_layers(cfg)
            params = api.init_params(torch.Generator().manual_seed(0), cfg)
            batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 41))}
            if cfg.cross_attn_period:
                batch["image_embeds"] = image_embeds(cfg, 2, DataState(SEED, 0),
                                                     device="cpu").numpy()
            runs = {}
            for dev in ("cpu", "cuda"):
                eng = DecodeEngine(cfg, params_to(params, dev), max_len=64, device=dev)
                ops.reset_launch_counts()
                tok, st = eng.prefill(batch)
                lgs, tks = [], []
                for _ in range(12):
                    tok, lg, st, _ = eng._step(eng.params, st, tok)
                    lgs.append(lg.float().cpu())
                    tks.append(tok.cpu())
                runs[dev] = (torch.stack(lgs), torch.stack(tks), ops.launch_counts())
            n = n_attn * 12
            want = {**dict.fromkeys(ops.KERNELS, 0), "gate_select": n,
                    "block_sparse_decode": n}
            same = torch.equal(runs["cpu"][1], runs["cuda"][1])
            err = float((runs["cpu"][0] - runs["cuda"][0]).abs().max())
            if not same or err > 1e-4 or runs["cuda"][2] != want:
                fail(f"{arch} small generate ({label}): tokens equal {same}, logits max abs "
                     f"diff {err:.3e} (limit 1e-4), launches {runs['cuda'][2]} (expected "
                     f"{want})")
            msg = (f"{arch} small agreement ({label}: {cfg.num_layers} layers, "
                   f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.resolved_head_dim}, fp32): "
                   f"generate tokens equal, logits max abs diff {err:.3e}, {n} launches each "
                   f"of #1 and #2 ({n_attn} attention layers x 12 steps)")
            if (label == "reduced" or cfg.family == "moe") and not cfg.cross_attn_period:
                r = np.random.default_rng(4)
                reqs = [{"rid": i, "max_new_tokens": m,
                         "tokens": r.integers(0, cfg.vocab_size, size=(p,)).astype(np.int32)}
                        for i, (p, m) in enumerate([(20, 12), (18, 10), (22, 9)])]
                for pool in (None, 8):
                    out = {}
                    for dev in ("cpu", "cuda"):
                        eng = DecodeEngine(cfg, params_to(params, dev), max_len=64, device=dev)
                        ops.reset_launch_counts()
                        out[dev] = (eng.serve(reqs, n_slots=3, num_pages=pool,
                                              collect_logits=True), ops.launch_counts())
                    got, counts = out["cuda"]
                    want_r = out["cpu"][0]
                    n = n_attn * got["stats"]["decode_steps"]
                    expect = {**dict.fromkeys(ops.KERNELS, 0), "gate_select_paged": n,
                              "block_sparse_decode_paged": n}
                    same = all(got[i] == want_r[i] for i in range(len(reqs)))
                    err = max(float(np.abs(got["logits"][i] - want_r["logits"][i]).max())
                              for i in range(len(reqs)))
                    pre = got["stats"]["preemptions"]
                    swap = (got["stats"]["swapped_out_bytes"], want_r["stats"]["swapped_out_bytes"])
                    if counts != expect or not same or err > 1e-4 \
                            or (pre > 0) != (pool is not None) or swap[0] != swap[1]:
                        fail(f"{arch} small serve (pool {pool}): launches {counts} (expected "
                             f"{expect}), tokens equal {same}, logits max abs diff {err:.3e}, "
                             f"preemptions {pre}, swapped bytes {swap}")
                    msg += (f"; serve (pool {pool or 'default'}) tokens equal, logits max abs "
                            f"diff {err:.3e}, preemptions {pre}, swapped {swap[0]} B")
            print(msg)


def quantized_pools(seen):
    """The captured fp serve tensors with their K/V pools quantized per
    page (one page is one gate block: the int8 pools' own rule, with every
    row counted, as phase 10 quantizes the generate caches per block),
    shaped as a capture of the int8 serve: (seen for 4q and 5q)."""
    (q, kp, vp, idx, pt_d, kv_len), kw = seen["paged_sparse_decode"]
    every = torch.ones((), dtype=torch.bool, device=kp.device)
    (kq, ks), (vq, vs) = pg.quantize_block(kp, every), pg.quantize_block(vp, every)
    print(f"int8 pools from the serve's layer-0 fp pools, quantized per page: "
          f"{tuple(kq.shape)} ({kq.dtype}), scale rows {tuple(ks.shape)}")
    return {"gate_select_paged": seen["gate_select_paged"],
            "paged_sparse_decode": ((q, kq, vq, idx, pt_d, kv_len),
                                    dict(kw, k_scales=ks, v_scales=vs))}


def phase_config(arch):
    """One of the other dense configs or the family configs at full width
    (depth and prompt cut as OTHER_CONFIGS, FAMILY_CONFIGS and
    FAMILY_PROMPT say): phase 3's kernel checks of #1, #2 and 2q on layer 0
    of generate's first decode step (a vision model also times its cross
    layers' dense attention on the prefill's image K/V); generate (batch
    4, 16384-token prompts, 31 decode steps, GatePolicy at budget 4096; a
    vision model with seeded image embeddings) with the counters at 0 just
    before, #1 and #2 launching self layers x steps; its profile (a MoE
    model's with the expert FFN's share of the device's busy time); then,
    for the dense configs and FAMILY_SERVE, serve with the default and the
    644-page pool (tight == ample, or, for MoE, tight == ample up to the
    first step whose active slots differ; #3 and #4 launching layers x
    steps); #3 and #4 on the ample run's layer-0 tensors (plain and
    shuffled pages), 5 on them at 2, 4, 8 and nsel + 3 splits (bitwise #4
    at the same count), and 4q and 5q on them quantized per page (5q
    bitwise 4q). Returns (launch counts of the generate and the ample
    serve, {kernel: numbers})."""
    t0 = time.perf_counter()
    free_card()
    cfg, cuts = other_config(arch)
    bs = cfg.gate.block_size
    prompt = FAMILY_PROMPT.get(arch, PROMPT_LEN)
    nl = n_self_layers(cfg)
    max_len = -(-(prompt + NEW_TOKENS) // bs) * bs
    family = ""
    if cfg.family == "moe":
        m = cfg.moe
        family = (f"; {m.n_experts} routed experts of d_ff {m.expert_d_ff}, top {m.top_k}, "
                  f"{m.n_shared_experts} shared, capacity factor {m.capacity_factor}")
    if cfg.cross_attn_period:
        family = (f"; a cross-attention layer every {cfg.cross_attn_period} ({nl} self, "
                  f"{cfg.num_layers - nl} cross) into {cfg.n_image_tokens} image tokens")
    print(f"{arch}: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads x {cfg.resolved_head_dim}, d_ff {cfg.d_ff} ({cfg.activation}), vocab "
          f"{cfg.vocab_size}, tied embeddings {cfg.tie_embeddings}, {cfg.dtype}{family}; gate "
          f"block {bs}, d_gate {cfg.gate.d_gate}, budget {cfg.gate.token_budget}; batch "
          f"{BATCH}, prompt {prompt}, {NEW_TOKENS} new tokens; reduced {cuts}")
    for name, quant in (("fp", False), ("int8", True)):
        plan = bsd.group_plan(cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim, bs,
                              torch.bfloat16, quant)
        print(f"{arch}: decode plan ({name} K/V, bf16 q): {plan}")
    t1 = time.perf_counter()
    params = init_lm(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tl._walk(params))
    print(f"{arch}: random weights (seed {SEED}) {n_params / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card, "
          f"{time.perf_counter() - t1:.1f} s")
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, prompt)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.cross_attn_period:
        batch["image_embeds"] = image_embeds(cfg, BATCH, DataState(SEED, 0), device="cuda")
    eng = DecodeEngine(cfg, params, max_len=max_len)
    moe_call, restore = capture_moe_call()
    try:
        seen, state = capture_layer0(eng, batch)
    finally:
        restore()
    numbers = phase_kernels(seen, vs_sdpa=False)
    numbers.update(phase_quant_kernels(seen))
    if cfg.cross_attn_period:
        cross_attention_times(cfg, params, state)
    del seen, state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts, _ = phase_end_to_end(eng, batch, NEW_TOKENS, nl)
    _, busy = phase_profile(eng, batch)
    if cfg.family == "moe":
        moe_ffn_share(cfg, moe_call, busy)
    del eng, moe_call
    torch.cuda.empty_cache()
    if arch not in OTHER_CONFIGS and arch not in FAMILY_SERVE:
        del params
        torch.cuda.empty_cache()
        why = ("the reference has no paged step for cross-attention" if cfg.cross_attn_period
               else "generate only at this cut")
        print(f"{arch}: no serve ({why})")
        print(json.dumps({"config": arch, "reduced": cuts, "kernels": numbers}))
        print(f"phase {arch}: {time.perf_counter() - t0:.1f} s")
        return counts, numbers
    serve_counts, seen, *runs = phase_serve(cfg, params)
    if arch in SHARDED_FAMILIES:
        BASE_RUNS[arch] = {"serve": runs}
    del params, runs
    torch.cuda.empty_cache()
    numbers.update(phase_paged_kernels(seen, vs_sdpa=False))
    seen["paged_sparse_decode_splitk"] = seen["paged_sparse_decode"]
    numbers.update(phase_splitk_kernels(seen, source=f"{arch} serve"))
    q_seen = quantized_pools(seen)
    del seen
    numbers.update(phase_paged_quant_kernels(q_seen))
    q_seen["paged_sparse_decode_splitk"] = q_seen["paged_sparse_decode"]
    numbers.update(phase_splitk_kernels(q_seen, source=f"{arch} serve, quantized per page"))
    del q_seen
    torch.cuda.empty_cache()
    counts = {**counts, **{k: serve_counts[k] for k in
                           ("gate_select_paged", "block_sparse_decode_paged")}}
    print(json.dumps({"config": arch, "reduced": cuts, "kernels": numbers}))
    print(f"phase {arch}: {time.perf_counter() - t0:.1f} s")
    return counts, numbers


def free_card():
    """Collect the reference cycles an engine leaves (the timing wrappers
    hold it through its bound methods), which would keep a finished
    config's weights and pools on the card, and return the cached blocks:
    a family config's weights take up to 40 GB."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"card memory before the next config: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")


def cross_attention_times(cfg, params, state):
    """A vision model's cross layers at decode: the dense decode attention
    of one token over unit 0's image K/V (plain PyTorch, as in the
    reference; no TPU kernel), timed as ``time_ms`` times a kernel, with
    SDPA on the same inputs as context, and its cross blocks' share of the
    weights printed."""
    ck, cv = state.cross_k[0], state.cross_v[0]
    b, hkv, n_img, dh = ck.shape
    q = torch.randn(b, 1, cfg.n_heads, dh, generator=torch.Generator(device="cuda")
                    .manual_seed(SEED), device="cuda").to(ck.dtype)
    n = torch.full((b,), n_img, dtype=torch.int32, device="cuda")
    t_plain = time_ms(lambda: decode_attention(q, ck, cv, n))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q[:, 0].reshape(b, cfg.n_heads, 1, dh)
    t_lib = time_ms(lambda: sdpa(qs, ck, cv, enable_gqa=True))
    nbytes = 2 * ck.numel() * ck.element_size()
    o_p = decode_attention(q, ck, cv, n).reshape(b, cfg.n_heads, 1, dh).float()
    err = float((sdpa(qs, ck, cv, enable_gqa=True).float() - o_p).abs().max())
    print(f"{cfg.arch_id} cross layer at decode: dense attention of {b} x {cfg.n_heads} "
          f"heads over {n_img} image tokens ({hkv} KV heads x {dh}), plain {t_plain:.4f} ms, "
          f"SDPA {t_lib:.4f} ms (max abs diff {err:.2e}), bound "
          f"{bound_ms(nbytes, 0)[0]:.5f} ms (the image K/V's {nbytes} B); "
          f"{cfg.num_layers - n_self_layers(cfg)} such layers a step")


def capture_moe_call():
    """Patch ``moe_mlp`` so that its first call at decode (BATCH rows:
    layer 0 of the first decode step) keeps its arguments. Returns
    (captured dict, restore)."""
    captured = {}
    real = moe_mod.moe_mlp

    def grab(p, x, *a, **kw):
        if x.shape[0] == BATCH:
            captured.setdefault("call", (p, x.clone(), a, kw))
        return real(p, x, *a, **kw)

    moe_mod.moe_mlp = grab

    def restore():
        moe_mod.moe_mlp = real
    return captured, restore


def moe_ffn_share(cfg, captured, busy_ms):
    """A MoE model's expert FFN at decode: the device time of one layer's
    ``moe_mlp`` (routing, dispatch, the einsums over all experts, the
    gather and the shared experts) on the input layer 0 of a decode step
    gave it (``capture_moe_call``), with the host's enqueue hidden, times
    the layers, against the decode step's device busy time from the
    profile; and the floor of its bytes (every routed expert's weights,
    read by the einsums at any capacity) at the card's memory rate."""
    p, x, a, kw = captured["call"]
    fn = lambda: moe_mod.moe_mlp(p, x, *a, **kw)  # noqa: E731
    t_wall = time_ms(fn)
    t_dev = time_ms(fn, hide_host=True)
    n_layers = n_self_layers(cfg)
    w_bytes = sum(p[k].numel() * p[k].element_size() for k in ("wi_gate", "wi_up", "wo"))
    floor = n_layers * w_bytes / HBM_BYTES_PER_S * 1e3
    _, top_i, _ = moe_mod.route(x, p["router"]["w"], cfg.moe.top_k)
    keep = moe_mod.dispatch(top_i, cfg.moe)[2]
    print(f"{cfg.arch_id} expert FFN at decode ({x.shape[0]} rows, capacity "
          f"{moe_mod.capacity(x.shape[0], cfg.moe)} an expert, {int((~keep).sum())} of "
          f"{keep.numel()} assignments dropped at layer 0): {t_wall:.4f} ms a layer timed, "
          f"{t_dev:.4f} ms device work alone; x {n_layers} layers = {n_layers * t_dev:.2f} ms "
          f"of the step's {busy_ms:.2f} ms device busy "
          f"({100 * n_layers * t_dev / busy_ms:.1f}%); the routed experts' weights, "
          f"{w_bytes / 1e9:.3f} GB a layer, need >= {floor:.2f} ms a step at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")


def phase_config_train(arch):
    """run_training in distill mode on one of OTHER_TRAIN (its depth as in
    OTHER_CONFIGS or FAMILY_CONFIGS; zamba2_1_2b whole), OTHER_TRAIN_STEPS
    steps of TRAIN_BATCH x TRAIN_SEQ, no checkpoint: kernel 6 launches
    gated layers (the hybrid's units) x steps and nothing else does; every
    KL finite, the base bitwise the seed's, the gate moved; then kernel 6
    against its plain version on the first step's layer-0 (unit-0 shared
    block) tensors (phase 20). Returns (launches of kernel 6, its
    numbers)."""
    t0 = time.perf_counter()
    free_card()
    cfg, cuts = other_config(arch)
    tcfg = TrainConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=OTHER_TRAIN_STEPS,
                       seed=SEED, checkpoint_every=0, log_every=1,
                       optim=OptimConfig(total_steps=OTHER_TRAIN_STEPS, warmup_steps=1))
    print(f"{arch} training: distill, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
          f"{OTHER_TRAIN_STEPS} steps, no checkpoint; reduced {cuts} and batch 16 -> "
          f"{TRAIN_BATCH}")
    seed_state = tl.init_train_state(torch.Generator(device="cuda").manual_seed(SEED),
                                     cfg, tcfg)
    batch0 = make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, DataState(SEED, 0), device="cuda")
    captured = capture_gt_layer0(seed_state.params, batch0, cfg)
    del batch0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    state, hist = tl.run_training(cfg, tcfg, device="cuda")
    wall = time.perf_counter() - t1
    counts = ops.launch_counts()
    gated = get_api(cfg).paged_attn_layers(cfg)
    want = {**dict.fromkeys(ops.KERNELS, 0), "gate_gt_attention": gated * OTHER_TRAIN_STEPS}
    if counts != want:
        fail(f"{arch} training launch counts {counts}, expected {want}")
    if not all(math.isfinite(h["kl"]) and math.isfinite(h["loss"]) for h in hist):
        fail(f"{arch}: non-finite KL in training")
    seed_leaves = dict(tl._walk(seed_state.params))
    frozen = all(torch.equal(t, seed_leaves[p])
                 for p, t in tl._walk(state.params) if not tl.is_gate_path(p))
    moved = sum(not torch.equal(state.gate[k], seed_state.gate[k]) for k in state.gate)
    if not frozen or moved == 0:
        fail(f"{arch}: base params bitwise unchanged: {frozen}; gate leaves moved: {moved}")
    print(f"{arch} training: {len(hist)} steps in {wall:.2f} s wall (init and batches "
          f"included), peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; KL "
          f"by step {[(h['step'], round(h['kl'], 6)) for h in hist]}; base params bitwise "
          f"unchanged; {moved} of {len(state.gate)} gate leaves moved; launch counts {counts}")
    del state, seed_state
    torch.cuda.empty_cache()
    numbers = phase_gt_kernel(*captured)
    del captured
    torch.cuda.empty_cache()
    print(f"phase {arch} training: {time.perf_counter() - t0:.1f} s")
    return counts["gate_gt_attention"], numbers


# ---------------------------------------------------------------------------
# pretraining (phase 2's small agreement, phases 35-37)
# ---------------------------------------------------------------------------

def small_pretrain_cfg(arch):
    """A family's reduced() model in fp32 (the hybrid at 5 layers: two
    units of 2 Mamba2 layers, then a tail layer)."""
    cfg = reduced(configs.get(arch)).replace(dtype="float32")
    return cfg.replace(num_layers=5) if cfg.family == "hybrid" else cfg


def small_pretrain_agreement(dev: str = "cuda"):
    """Each of SMALL_PRETRAIN's reduced() models takes one pretrain loss and
    gradient (``train.loop.pretrain_value_and_grad``) on ``dev`` and on the
    CPU, from the same seed-0 parameters and batch (2 x 64). Returns, per
    config: (arch, the loss's relative difference, the largest gradient
    difference as a share of its leaf's largest entry, whether the leaves
    zero on the CPU (the gate, the audio embed) are zero on ``dev``, the
    number of leaves, the launch counts of the ``dev`` runs)."""
    out = []
    for arch in SMALL_PRETRAIN:
        cfg = small_pretrain_cfg(arch)
        params = get_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
        batch = make_batch(cfg, 2, 64, DataState(SEED, 0), device="cpu")
        res = {"cpu": tl.pretrain_value_and_grad(params, batch, cfg)}
        ops.reset_launch_counts()
        res[dev] = tl.pretrain_value_and_grad(params_to(params, dev),
                                              {k: v.to(dev) for k, v in batch.items()}, cfg)
        counts = ops.launch_counts()
        want = float(res["cpu"][0])
        loss_err = abs(float(res[dev][0]) - want) / abs(want)
        g_err, zeros_ok = 0.0, True
        for k, g in res["cpu"][2].items():
            got = res[dev][2][k].cpu()
            top = float(g.abs().max())
            if top == 0:
                zeros_ok = zeros_ok and not bool(got.any())
                continue
            g_err = max(g_err, float((got - g).abs().max()) / top)
        out.append((arch, loss_err, g_err, zeros_ok, len(res["cpu"][2]), counts))
    return out


def phase_small_pretrain():
    """Phase 2's pretraining agreement: the dense, MoE, vision, Mamba1,
    hybrid and audio families' reduced() models (fp32), one pretrain loss
    and gradient on the card against the CPU's plain path (itself held
    against the JAX reference by tests/test_torch_pretrain.py and
    tests/test_torch_train_recurrent.py): the loss within 1e-5 relative,
    every gradient leaf within 1e-4 of its leaf's largest entry, the
    unread leaves zero on both, and no kernel launched (the pretrain
    attention is the plain chunked attention, as in the reference)."""
    none = dict.fromkeys(ops.KERNELS, 0)
    for arch, loss_err, g_err, zeros_ok, n, counts in small_pretrain_agreement("cuda"):
        if counts != none or not loss_err <= 1e-5 or not g_err <= 1e-4 or not zeros_ok:
            fail(f"{arch} small pretrain: loss rel diff {loss_err:.3e} (limit 1e-5), gradient "
                 f"max diff {g_err:.3e} of its leaf's max (limit 1e-4), zero leaves zero "
                 f"{zeros_ok}, launches {counts}")
        print(f"{arch} small pretrain agreement (reduced, fp32, 2 x 64): loss rel diff "
              f"{loss_err:.3e}, {n} gradient leaves within {g_err:.3e} of their max, "
              f"unread leaves zero on both, no kernel launched")


def phase_pretrain(arch):
    """Phases 35-37: run_training in pretrain mode on one of
    PRETRAIN_CONFIGS (bf16, the config's remat, seed-0 weights, lr
    PRETRAIN_LR), PRETRAIN_STEPS steps; with checkpoints, one every
    TRAIN_CKPT_EVERY steps and a failure injected before step
    TRAIN_FAIL_AT. Launch counters at 0 just before, read just after: no
    kernel launches. Every loss finite; every leaf the loss reads moved
    from the seed; every leaf it does not read (the gate, the audio
    encoder's embed) equal to its seed value after AdamW's weight decay
    alone at each step's lr (zero gradient and moments: p - lr * wd * p,
    rounded to its dtype, bitwise); the replayed step's loss equal; the
    last checkpoint in the reference's layout and read back bitwise; wall
    time, peak memory, then the step time and the device's busy share
    (phase 19's profile)."""
    t0 = time.perf_counter()
    free_card()
    cut, bsz, seq, with_ckpt = PRETRAIN_CONFIGS[arch]
    full = configs.get(arch)
    cfg = full.replace(**cut)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
    try:
        tcfg = TrainConfig(mode="pretrain", seq_len=seq, global_batch=bsz,
                           steps=PRETRAIN_STEPS, seed=SEED,
                           checkpoint_every=TRAIN_CKPT_EVERY if with_ckpt else 0,
                           checkpoint_dir=ckpt_dir, log_every=1,
                           optim=OptimConfig(lr=PRETRAIN_LR, total_steps=PRETRAIN_STEPS,
                                             warmup_steps=1))
        cuts = [f"{k} {getattr(full, k)} -> {v}" for k, v in cut.items()]
        print(f"{arch} pretraining: {cfg.num_layers} layers, d {cfg.d_model}, "
              f"{cfg.dtype}, remat {cfg.remat}; batch {bsz} x {seq}, {PRETRAIN_STEPS} "
              f"steps" + (f", checkpoint every {TRAIN_CKPT_EVERY}, failure before step "
                          f"{TRAIN_FAIL_AT}" if with_ckpt else ", no checkpoint")
              + (f"; reduced {cuts}" if cuts else "") + f"; {tcfg.optim}")
        # run_training draws the same weights from the same seed
        seed = dict(tl._walk(get_api(cfg).init_params(
            torch.Generator(device="cuda").manual_seed(SEED), cfg)))
        armed = [with_ckpt]

        def fail_at(i):
            if i == TRAIN_FAIL_AT and armed[0]:
                armed[0] = False
                raise RuntimeError("injected node failure")

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        state, hist = tl.run_training(cfg, tcfg, fail_at=fail_at, device="cuda")
        wall = time.perf_counter() - t1
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = [h["step"] for h in hist]
        print(f"{arch} pretraining: {len(hist)} steps {steps} in {wall:.2f} s wall, "
              f"including init, batches, checkpoints and the restore; peak memory "
              f"{peak:.1f} GiB; launch counts {counts}")
        if counts != dict.fromkeys(ops.KERNELS, 0):
            fail(f"{arch} pretraining launched kernels: {counts}")
        want_steps = ([0, 1, 2, 2, 3] if with_ckpt else list(range(PRETRAIN_STEPS)))
        if steps != want_steps or int(state.step) != PRETRAIN_STEPS:
            fail(f"{arch} pretraining steps {steps}, final step {int(state.step)}")
        if not all(math.isfinite(h["loss"]) and math.isfinite(h["ce"]) for h in hist):
            fail(f"{arch}: non-finite loss in pretraining")
        if with_ckpt:
            first, replay = (h["loss"] for h in hist if h["step"] == TRAIN_CKPT_EVERY)
            if not abs(first - replay) <= 1e-6 * abs(first):
                fail(f"{arch} replayed step {TRAIN_CKPT_EVERY}: loss {replay} != {first}")
        unread = [p for p in seed if tl.is_gate_path(p)
                  or (cfg.family == "audio" and p == "embed/w")]
        lrs = [h["lr"] for h in sorted({h["step"]: h for h in hist}.values(),
                                       key=lambda h: h["step"])]
        wd = tcfg.optim.weight_decay
        final = dict(tl._walk(state.params))
        still = [p for p, t in final.items() if p not in unread and torch.equal(t, seed[p])]
        decayed = 0
        for p in unread:
            e = seed[p]
            for lr in lrs:
                p32 = e.float()
                e = (p32 - torch.tensor(lr, dtype=torch.float32, device=p32.device)
                     * (wd * p32)).to(e.dtype)
            decayed += torch.equal(final[p], e)
        if still or decayed != len(unread):
            fail(f"{arch}: read leaves unmoved {still}; {decayed} of {len(unread)} unread "
                 f"leaves at their weight-decay value")
        moved_unread = sum(not torch.equal(final[p], seed[p]) for p in unread)
        print(f"{arch} pretraining: loss by step "
              f"{[(h['step'], round(h['loss'], 5)) for h in hist]}"
              + ("; replayed step loss equal" if with_ckpt else "")
              + f"; all {len(final) - len(unread)} leaves the loss reads moved; the "
              f"{len(unread)} it does not read ({'gate' if cfg.gate.enabled else 'embed'}) "
              f"at their weight-decay values, bitwise ({moved_unread} of them changed in "
              f"{cfg.dtype})")
        del seed, final
        if with_ckpt:
            check_train_checkpoint(ckpt_dir, state, cfg)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        torch.cuda.empty_cache()
        times, busy = phase_train_profile(cfg, tcfg, state, steps=1,
                                          label=f"{arch} pretraining")
        print(f"phase {arch} pretraining: {time.perf_counter() - t0:.1f} s; step "
              f"{min(times):.3f} s, device busy {busy:.3f} s, peak memory {peak:.1f} GiB "
              f"({card_line()})")
        del state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# training under a Shard (phase 41)
# ---------------------------------------------------------------------------

def capture_first_gt():
    """Wrap ``ops.gate_gt_attention`` to keep a copy of its first call's
    arguments (a list that holds one (args, kwargs) once it ran); returns
    (the list, a function that unwraps it)."""
    seen, real = [], ops.gate_gt_attention

    def grab(*a, **kw):
        if not seen:
            seen.append((tuple(t.clone() for t in a),
                         {k: (v.clone() if torch.is_tensor(v) else v) for k, v in kw.items()}))
        return real(*a, **kw)

    def undo():
        ops.gate_gt_attention = real
    ops.gate_gt_attention = grab
    return seen, undo


def timed_steps(step_fn, state, batches):
    """Each batch through ``step_fn``: (final state, metrics by step as
    floats, host seconds a step, each ended by reading the metrics)."""
    hist, secs = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        hist.append({k: float(v) for k, v in m.items()})
        secs.append(time.perf_counter() - t0)
    return state, hist, secs


def counting_collectives(shard):
    """Wrap the shard's collectives (``all_sum``, ``all_max``,
    ``all_gather``, ``all_to_all``) to count them and their host time: (the
    counts {"n", "host_s", and of the all-to-alls apart "a2a", "a2a_s"}, a
    function that unwraps them)."""
    stats = {"n": 0, "host_s": 0.0, "a2a": 0, "a2a_s": 0.0}
    names = ("all_sum", "all_max", "all_gather", "all_to_all")

    def wrap(fn, name):
        def counted(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                stats["n"] += 1
                stats["host_s"] += dt
                if name == "all_to_all":
                    stats["a2a"] += 1
                    stats["a2a_s"] += dt
        return counted

    for name in names:
        setattr(shard, name, wrap(getattr(shard, name), name))

    def undo():
        for name in names:
            delattr(shard, name)
    return stats, undo


def same_state(a, b) -> bool:
    """Every parameter, moment and counter of two full train states equal,
    bitwise."""
    pa, pb = dict(tl._walk(a.params)), dict(tl._walk(b.params))
    return (pa.keys() == pb.keys() and all(torch.equal(pa[k], t) for k, t in pb.items())
            and all(torch.equal(getattr(a.opt, f)[k], t) for f in ("m", "v")
                    for k, t in getattr(b.opt, f).items())
            and int(a.opt.count) == int(b.opt.count) and int(a.step) == int(b.step))


def shard_train_case(label, cfg, tcfg, bsz, seq, shard, n_gt, data=None, phase="41"):
    """The sharded ``make_train_step`` on the one-rank group (with a
    ``data`` axis too: phase 44's one-rank data group, which slices no
    moments and sends no gradient) and the unsharded one, SHARD_TRAIN_STEPS steps each from the same seed state
    on the same batches: every metric, parameter and moment bitwise;
    launch counters at 0 just before the sharded run and read just after:
    kernel 6 ``n_gt`` a forward, nothing else; the collectives a step and
    their host time; kernel 6 against its plain version on the sharded
    first step's first call (the rank's heads). Returns (kernel 6
    launches, its error or None). The sharded run goes first and is
    gathered before the unsharded one starts from the seed, so that the
    card holds at most three states (a state of deepseek_moe_16b's two
    layers with its moments is 11.5 GB)."""
    t0 = time.perf_counter()
    free_card()
    seed = tl.init_train_state(torch.Generator(device="cuda").manual_seed(SEED), cfg, tcfg)
    batches = [make_batch(cfg, bsz, seq, DataState(SEED, i), device="cuda")
               for i in range(tcfg.steps)]
    box = [tl.shard_state(seed, cfg, shard, data)]
    if data is not None:
        n_zero = len(tl.zero1_map(box[0].params, cfg, shard, data)) if tcfg.mode == "pretrain" \
            else 0
        why = ("pretraining" if n_zero else "a one-rank data group slices nothing"
               if tcfg.mode == "pretrain" else "the gate moments stay whole")
        print(f"{label}: {n_zero} leaves' moments at the data rank's ZeRO-1 slice ({why})")
    step = tl.make_train_step(cfg, tcfg, shard, data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    seen, undo = capture_first_gt()
    coll, uncount = counting_collectives(shard)
    dcoll, duncount = counting_collectives(data) if data is not None else ({"n": 0,
                                                                            "host_s": 0.0},
                                                                           lambda: None)
    try:
        local, s_hist, s_secs = timed_steps(step, box.pop(), batches)
    finally:
        undo()
        uncount()
        duncount()
    counts = ops.launch_counts()
    want = {**dict.fromkeys(ops.KERNELS, 0), "gate_gt_attention": n_gt * tcfg.steps}
    if counts != want:
        fail(f"{label} sharded training launch counts {counts}, expected {want}")
    full = tl.gather_state(local, cfg, shard, data)
    del local
    box.append(seed)
    del seed
    plain, p_hist, p_secs = timed_steps(tl.make_train_step(cfg, tcfg), box.pop(), batches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    same = s_hist == p_hist and same_state(full, plain)
    if not same or not all(math.isfinite(h["loss"]) for h in s_hist):
        fail(f"{label}: the sharded steps differ from the unsharded ones: {s_hist} vs "
             f"{p_hist}")
    key = "kl" if tcfg.mode == "distill" else "ce"
    print(f"{label}: {tcfg.steps} steps of {bsz} x {seq} on the one-rank NCCL group bitwise "
          f"the unsharded steps ({key} {[round(h[key], 6) for h in s_hist]}, every one of "
          f"{len(dict(tl._walk(full.params)))} parameter leaves and their moments); step s "
          f"sharded {', '.join(f'{t:.3f}' for t in s_secs)} against unsharded "
          f"{', '.join(f'{t:.3f}' for t in p_secs)}; {coll['n'] / tcfg.steps:.0f} "
          f"collectives a step, {1e3 * coll['host_s'] / tcfg.steps:.2f} ms of host time a "
          f"step in them" + ("" if data is None else
                             f"; over the data group {dcoll['n'] / tcfg.steps:.0f} a step, "
                             f"{1e3 * dcoll['host_s'] / tcfg.steps:.2f} ms of host time")
          + f"; peak memory {peak:.1f} GiB; launch counts {counts} ({card_line()})")
    del full, plain, batches
    err = None
    if n_gt:
        (q, k, v), kw = seen[0]
        print(f"{label}: kernel 6 on the rank's heads, q {tuple(q.shape)} k/v {tuple(k.shape)} "
              f"{q.dtype}, block {kw['block_size']}")
        err = gt_agreement(q, k, v, kw["block_size"], kw["q_chunk"], kw["segment_ids"],
                           f"{label}, step 0 layer 0, local heads")
    del seen
    torch.cuda.empty_cache()
    print(f"phase {phase} {label}: {time.perf_counter() - t0:.1f} s")
    return counts["gate_gt_attention"], err


def launcher_under_torchrun():
    """``python -m repro_torch.launch.train --arch qwen3_0_6b --reduced
    --steps 4 --ckpt-every 2`` in a subprocess under a one-rank torchrun
    environment (the launcher joins an NCCL group and trains through its
    shard): exit 0, and its last checkpoint the full tree in the
    reference's layout (leaf count, order, shapes and dtypes)."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_launch_train_")
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(filter(None, [os.path.join(root, "src"),
                                                            os.environ.get("PYTHONPATH")])))
        argv = [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH_TRAIN_ARGV,
                "--ckpt-dir", ckpt_dir]
        out = subprocess.run(argv, env=env, cwd=root, capture_output=True, text=True,
                             timeout=600)
        print(out.stdout.strip())
        if out.returncode != 0 or "ranks=1 (data 1 x model 1)" not in out.stdout:
            print(out.stderr[-4000:], file=sys.stderr)
            fail(f"the training launcher under torchrun's environment exited "
                 f"{out.returncode}")
        cfg = reduced(configs.get("qwen3_0_6b"))
        want = reference_leaves(tl.init_train_state(torch.Generator().manual_seed(0), cfg,
                                                    TrainConfig()))
        step = ckpt.latest_step(ckpt_dir)
        with open(os.path.join(ckpt_dir, f"step_{step}", "manifest.json")) as f:
            manifest = json.load(f)
        names = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.int32: "int32"}
        if (step != 4 or manifest["shapes"] != [sh for _, sh, _ in want]
                or manifest["dtypes"] != [names[dt] for _, _, dt in want]):
            fail(f"the launcher's checkpoint step {step} is not the full tree: "
                 f"{manifest['shapes']} {manifest['dtypes']}")
        print(f"launch.train under a one-rank torchrun environment: exit 0; checkpoint step "
              f"{step}, the full tree in the reference's layout ({len(want)} leaves); "
              f"{time.perf_counter() - t0:.1f} s with the process's start")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def phase_sharded_train(shard):
    """Phase 41: training under a Shard, tensor-parallel over the one-rank
    NCCL group: (a) qwen3_0_6b distillation at full width and depth, (b)
    deepseek_moe_16b pretraining, expert-parallel, at SHARD_MOE_LAYERS
    layers, (c) zamba2_1_2b distillation at one unit, each bitwise the
    unsharded steps (``shard_train_case``), then (d) the training launcher
    under torchrun's environment. Returns (kernel 6 launches, its
    errors)."""
    t0 = time.perf_counter()
    distill = TrainConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                          steps=SHARD_TRAIN_STEPS, seed=SEED, checkpoint_every=0,
                          optim=OptimConfig(total_steps=SHARD_TRAIN_STEPS, warmup_steps=1))
    n, errs = 0, []
    qwen = configs.get("qwen3_0_6b")
    moe = configs.get("deepseek_moe_16b").replace(num_layers=SHARD_MOE_LAYERS)
    hybrid = configs.get("zamba2_1_2b")
    hybrid = hybrid.replace(num_layers=hybrid.hybrid_period)
    pretrain = dataclasses.replace(distill, mode="pretrain", seq_len=SHARD_MOE_SEQ[1],
                                   global_batch=SHARD_MOE_SEQ[0],
                                   optim=dataclasses.replace(distill.optim, lr=PRETRAIN_LR))
    for label, cfg, tcfg, n_gt in (
            ("qwen3_0_6b distill (a)", qwen, distill, qwen.num_layers),
            ("deepseek_moe_16b pretrain, expert-parallel (b)", moe, pretrain, 0),
            ("zamba2_1_2b distill, one unit (c)", hybrid, distill, 1)):
        got, err = shard_train_case(label, cfg, tcfg, tcfg.global_batch, tcfg.seq_len, shard,
                                    n_gt)
        n += got
        errs += [] if err is None else [err]
    launcher_under_torchrun()
    print(f"phase 41 (training under a Shard): {time.perf_counter() - t0:.1f} s")
    return n, errs


# ---------------------------------------------------------------------------
# the data axis (phase 44)
# ---------------------------------------------------------------------------

def data_generate_case(label, cfg, params, toks, model, data):
    """``generate`` of ``toks`` on an engine over the one-rank data and
    model groups (the rows over the data group, the MoE routing global)
    and on the engine with the model group alone, every launch counter at
    0 just before each run: tokens and every decode step's logits bitwise,
    no kernel launched (the sequence-sharded step is plain PyTorch, as the
    reference's jnp). Returns the data run's host seconds."""
    bs = cfg.gate.block_size
    max_len = -(-(toks.shape[1] + DATA_GEN_NEW) // bs) * bs
    runs = []
    for d in (data, None):
        eng = DecodeEngine(cfg, params, max_len=max_len, shard=model, data=d)
        logits, step = [], eng._step

        def keep(*a, step=step, logits=logits):
            out = step(*a)
            logits.append(out[1].clone())
            return out
        eng._step = keep
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate({"tokens": toks}, DATA_GEN_NEW)
        torch.cuda.synchronize()
        runs.append((res["tokens"].cpu(), torch.stack(logits).float().cpu(),
                     ops.launch_counts(), time.perf_counter() - t0))
        del eng, logits
    (ta, la, ca, sa), (tb, lb, cb, sb) = runs
    if any(ca.values()) or any(cb.values()):
        fail(f"{label}: a kernel launched on the sequence-sharded generate: {ca} {cb}")
    if not (torch.equal(ta, tb) and torch.equal(la, lb)):
        fail(f"{label}: the run over the data group is not bitwise the model group's")
    print(f"{label}: batch {toks.shape[0]} x {toks.shape[1]} prompt, {DATA_GEN_NEW} tokens, "
          f"bitwise the engine without the data axis (tokens and {la.shape[0]} steps' "
          f"logits); {sa:.2f} s against {sb:.2f} s ({card_line()})")
    return sa


def phase_data_axis(dryrun_preds):
    """Phase 44: the data axis on the card, over a one-rank NCCL data group
    and a one-rank NCCL model group (``data_model_shards(1, 1)``): (a)
    qwen3_0_6b distillation at phase 14's shape (kernel 6 launched and
    counted) and (b) its pretraining at PRETRAIN_CONFIGS' depth (no
    ZeRO-1 slice at one data rank), each bitwise the unsharded steps
    (``shard_train_case``);
    (c) ``generate`` at batch BATCH and at batch 1 bitwise the engine
    with the model group alone; (d) phase 43's two local-mesh cells carry
    no data axis (their predictions phase 43 held to the card). Two NCCL
    ranks cannot share one card: a data group of two raises. Returns
    (kernel 6 launches, its errors)."""
    t0 = time.perf_counter()
    model, data = data_model_shards(1, 1)
    try:
        check_nccl_cards(2, "nccl")
        if torch.cuda.device_count() < 2:
            fail("phase 44: two NCCL ranks on one card did not raise")
    except ValueError as e:
        print(f"phase 44: a data group of two on this card refused: {e}")
    qwen = configs.get("qwen3_0_6b")
    distill = TrainConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                          steps=SHARD_TRAIN_STEPS, seed=SEED, checkpoint_every=0,
                          optim=OptimConfig(total_steps=SHARD_TRAIN_STEPS, warmup_steps=1))
    cut, bsz, seq, _ = PRETRAIN_CONFIGS["qwen3_0_6b"]
    pretrain = TrainConfig(mode="pretrain", seq_len=seq, global_batch=bsz,
                           steps=SHARD_TRAIN_STEPS, seed=SEED, checkpoint_every=0,
                           optim=OptimConfig(lr=PRETRAIN_LR, total_steps=SHARD_TRAIN_STEPS,
                                             warmup_steps=1))
    n, errs = 0, []
    for label, cfg, tcfg, n_gt in (
            ("qwen3_0_6b distill over data 1 x model 1 (a)", qwen, distill, qwen.num_layers),
            (f"qwen3_0_6b pretrain over data 1 x model 1, {cut['num_layers']} layers (b)",
             qwen.replace(**cut), pretrain, 0)):
        got, err = shard_train_case(label, cfg, tcfg, tcfg.global_batch, tcfg.seq_len, model,
                                    n_gt, data=data, phase="44")
        n += got
        errs += [] if err is None else [err]
    free_card()
    cfg = qwen.replace(num_layers=DECODE_LAYERS)
    params = init_lm(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    rng = np.random.default_rng(SEED)
    for b in (BATCH, 1):
        toks = rng.integers(0, cfg.vocab_size, (b, DATA_GEN_PROMPT)).astype(np.int32)
        data_generate_case(f"phase 44 qwen3_0_6b ({cfg.num_layers} layers) generate over "
                           f"data 1 x model 1 (c)", cfg, params, toks, model, data)
    del params
    free_card()
    for label in ("distill", "decode"):
        rec = dryrun_preds[label]
        if rec.get("collectives_by_axis") != {} or rec["collectives"]["_count"]:
            fail(f"phase 44: phase 43's {label} cell at the local mesh logged collectives "
                 f"{rec.get('collectives_by_axis')}")
    print("phase 44 (d): phase 43's distill and decode cells at the local mesh carry no data "
          "or model axis (no collective logged); phase 43 held their predictions to the card")
    print(f"phase 44 (the data axis): {time.perf_counter() - t0:.1f} s")
    return n, errs


# ---------------------------------------------------------------------------
# the MoE's expert dispatch over data x model (phase 45)
# ---------------------------------------------------------------------------

def moe_way(cfg, dispatch, ep_major):
    """``cfg`` at one of phase 45's dispatches."""
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch), ep_major=ep_major)


def exchange_line(coll, n) -> str:
    """Collectives a step (of ``n``) and their host time, all-to-alls apart."""
    return (f"{coll['n'] / n:.0f} collectives a step ({coll['a2a'] / n:.0f} all-to-alls), "
            f"{1e3 * coll['host_s'] / n:.2f} ms of host a step in them "
            f"({1e3 * coll['a2a_s'] / n:.2f} in the all-to-alls)")


def same_or_close(label, got_hist, want_hist, got_state, want_state) -> str:
    """Phase 45's rule for a training way against the model-only run:
    every metric within MOE_WAY_REL relative; whether it is bitwise is
    reported, else the largest parameter difference."""
    for g, w in zip(got_hist, want_hist):
        for k in w:
            if not math.isfinite(g[k]) or abs(g[k] - w[k]) > MOE_WAY_REL * max(abs(w[k]), 1e-12):
                fail(f"{label}: metric {k} {g[k]} against the model-only run's {w[k]}")
    if got_hist == want_hist and same_state(got_state, want_state):
        return "bitwise the model-only steps"
    pa, pb = dict(tl._walk(got_state.params)), dict(tl._walk(want_state.params))
    gap = max(float((pa[k].float() - t.float()).abs().max()) for k, t in pb.items())
    return (f"metrics within {MOE_WAY_REL:g} relative of the model-only steps (not bitwise: "
            f"largest parameter difference {gap:.3e})")


def moe_train_way(label, cfg, tcfg, model, data, batches, want, n_gt):
    """One phase-45 training way: ``make_train_step(cfg, tcfg, model,
    data)`` from the seed state on ``batches``, the launch counters at 0
    just before and read just after (kernel 6 ``n_gt`` a forward, nothing
    else), held against the model-only run ``want`` (hist, state); kernel
    6 against its plain version on its first call. Returns (kernel 6
    launches, its error or None)."""
    # the only reference to the start state is timed_steps': each step's
    # state frees the one before (a pretrain state of these two layers with
    # its moments is 11.5 GB, and the model-only run's final one is kept)
    box = [tl.shard_state(tl.init_train_state(torch.Generator(device="cuda").manual_seed(SEED),
                                              cfg, tcfg), cfg, model, data)]
    step = tl.make_train_step(cfg, tcfg, model, data)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    seen, undo = capture_first_gt()
    mcoll, muncount = counting_collectives(model)
    dcoll, duncount = counting_collectives(data)
    try:
        local, hist, secs = timed_steps(step, box.pop(), batches)
    finally:
        undo()
        muncount()
        duncount()
    counts = ops.launch_counts()
    expect = {**dict.fromkeys(ops.KERNELS, 0), "gate_gt_attention": n_gt * tcfg.steps}
    if counts != expect:
        fail(f"{label}: launch counts {counts}, expected {expect}")
    # one rank on each axis holds the whole state: no gathered copy
    full = local if model.world == data.world == 1 else tl.gather_state(local, cfg, model, data)
    del local
    verdict = same_or_close(label, hist, want[0], full, want[1])
    key = "kl" if tcfg.mode == "distill" else "ce"
    print(f"{label}: {verdict} ({key} {[round(h[key], 6) for h in hist]}); step s "
          f"{', '.join(f'{t:.3f}' for t in secs)}; model group: "
          f"{exchange_line(mcoll, tcfg.steps)}; data group: {exchange_line(dcoll, tcfg.steps)}; "
          f"kernel 6 launches {counts['gate_gt_attention']} ({card_line()})")
    del full
    err = None
    if n_gt:
        (q, k, v), kw = seen[0]
        err = gt_agreement(q, k, v, kw["block_size"], kw["q_chunk"], kw["segment_ids"],
                           f"{label}, step 0 layer 0")
    del seen
    free_card()
    return counts["gate_gt_attention"], err


def moe_generate_way(label, cfg, params, toks, model, data, want):
    """One phase-45 ``generate`` (the launch counters at 0 just before and
    read just after; the first #1 and #2 calls kept): with ``want`` (the
    model-only run's tokens and logits) its tokens must equal them, the
    logits' largest difference reported. Returns (tokens, logits, launch
    counts, the kept kernel calls, ms a decode step)."""
    bs = cfg.gate.block_size
    max_len = -(-(toks.shape[1] + DATA_GEN_NEW) // bs) * bs
    eng = DecodeEngine(cfg, params, max_len=max_len, shard=model, data=data)
    logits, step = [], eng._step

    def keep(*a, step=step, logits=logits):
        out = step(*a)
        logits.append(out[1].clone())
        return out
    eng._step = keep
    seen, restore = capture_first(["gate_select", "sparse_decode"])
    colls = [counting_collectives(g) for g in (model, data) if g is not None]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    try:
        res = eng.generate({"tokens": toks}, DATA_GEN_NEW)
        torch.cuda.synchronize()
    finally:
        restore()
        for _, undo in colls:
            undo()
    counts = ops.launch_counts()
    tokens, lg = res["tokens"].cpu(), torch.stack(logits).float().cpu()
    ms = 1e3 * res["decode_s"] / (DATA_GEN_NEW - 1)
    coll = {k: sum(c[k] for c, _ in colls) for k in ("n", "host_s", "a2a", "a2a_s")}
    line = (f"{ms:.2f} ms a decode step; {coll['n']} collectives ({coll['a2a']} all-to-alls) "
            f"over the prefill and {DATA_GEN_NEW - 1} steps, {1e3 * coll['host_s']:.2f} ms of "
            f"host in them ({1e3 * coll['a2a_s']:.2f} in the all-to-alls); launches of #1 "
            f"{counts['gate_select']}, #2 {counts['block_sparse_decode']} ({card_line()})")
    if want is None:
        print(f"{label}: {line}")
    else:
        if not torch.equal(tokens, want[0]):
            fail(f"{label}: tokens differ from the model-only run's")
        gap = float((lg - want[1]).abs().max())
        print(f"{label}: tokens equal to the model-only run's; logits "
              + ("bitwise" if gap == 0.0 else f"max |diff| {gap:.3e}") + f"; {line}")
    del eng, logits
    return tokens, lg, counts, seen, ms


def phase_moe_dispatch():
    """Phase 45: the MoE's expert dispatch as the reference shards it, on
    deepseek_moe_16b at full width and SHARD_MOE_LAYERS layers over a
    one-rank NCCL data group beside a one-rank NCCL model group
    (``data_model_shards(1, 1)``), three ways (MOE_WAYS): the default
    dispatch with the capacity's slots split over data, ``dispatch=
    "shard_map"`` (the large-T all-to-all body on training and prefill
    rows, the decode-size body on decode rows) and the EP-major layout.
    (a) a distill and (b) a pretrain step, SHARD_TRAIN_STEPS each on
    SHARD_MOE_SEQ, each way held against the model-only run (kernel 6
    launched on the distill steps and held against its plain version);
    (c) ``generate`` at batch BATCH (DATA_GEN_PROMPT-token prompts,
    DATA_GEN_NEW tokens), tokens equal to the model-only engine's: the
    default dispatch and ``shard_map`` take the sequence-sharded step
    (plain PyTorch, no kernel), EP-major the engine's own rows through #1
    and #2, held against the engine without a shard and, on its first
    decode step's layer 0, against their plain versions. Returns
    ({kernel: launches}, {kernel: [errors]})."""
    t0 = time.perf_counter()
    free_card()
    model, data = data_model_shards(1, 1)
    cfg = configs.get("deepseek_moe_16b").replace(num_layers=SHARD_MOE_LAYERS)
    m = cfg.moe
    print(f"phase 45: deepseek_moe_16b at {cfg.num_layers} of 28 layers, d {cfg.d_model}, "
          f"{m.n_experts} routed experts of d_ff {m.expert_d_ff}, top {m.top_k}, "
          f"{m.n_shared_experts} shared, capacity factor {m.capacity_factor}; data 1 x model 1 "
          f"(one NCCL rank each)")
    distill = TrainConfig(seq_len=SHARD_MOE_SEQ[1], global_batch=SHARD_MOE_SEQ[0],
                          steps=SHARD_TRAIN_STEPS, seed=SEED, checkpoint_every=0,
                          optim=OptimConfig(total_steps=SHARD_TRAIN_STEPS, warmup_steps=1))
    pretrain = dataclasses.replace(distill, mode="pretrain",
                                   optim=dataclasses.replace(distill.optim, lr=PRETRAIN_LR))
    counts = dict.fromkeys(("gate_select", "block_sparse_decode", "gate_gt_attention"), 0)
    errs = {name: [] for name in counts}
    for mode, tcfg, n_gt in (("distill (a)", distill, cfg.num_layers),
                             ("pretrain (b)", pretrain, 0)):
        batches = [make_batch(cfg, tcfg.global_batch, tcfg.seq_len, DataState(SEED, i),
                              device="cuda") for i in range(tcfg.steps)]
        box = [tl.init_train_state(torch.Generator(device="cuda").manual_seed(SEED), cfg, tcfg)]
        plain, hist, secs = timed_steps(tl.make_train_step(cfg, tcfg, model), box.pop(), batches)
        print(f"phase 45 {mode}, model-only: step s {', '.join(f'{t:.3f}' for t in secs)}")
        want = (hist, plain)
        for way, (dispatch, ep) in MOE_WAYS.items():
            n, err = moe_train_way(f"phase 45 {mode}, {way}", moe_way(cfg, dispatch, ep), tcfg,
                                   model, data, batches, want, n_gt)
            counts["gate_gt_attention"] += n
            errs["gate_gt_attention"] += [] if err is None else [err]
        del plain, want, batches
        free_card()
    params = init_lm(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                (BATCH, DATA_GEN_PROMPT)).astype(np.int32)
    base = {}
    for name, shard in (("model-only", model), ("no shard", None)):
        tokens, lg, _, _, _ = moe_generate_way(f"phase 45 generate (c), {name}", cfg, params,
                                               toks, shard, None, None)
        base[name] = (tokens, lg)
    for way, (dispatch, ep) in MOE_WAYS.items():
        label = f"phase 45 generate (c), {way}"
        want = base["no shard" if ep else "model-only"]
        _, _, c, seen, _ = moe_generate_way(label, moe_way(cfg, dispatch, ep), params, toks,
                                            model, data, want)
        expect = cfg.num_layers * (DATA_GEN_NEW - 1) if ep else 0
        if c != {**dict.fromkeys(ops.KERNELS, 0), "gate_select": expect,
                 "block_sparse_decode": expect}:
            fail(f"{label}: launch counts {c}, expected #1 and #2 {expect} each")
        counts["gate_select"] += c["gate_select"]
        counts["block_sparse_decode"] += c["block_sparse_decode"]
        if ep:
            (qg, kg, nv, gcfg, msel), _ = seen["gate_select"]
            checks, swaps, gerr = gate_cases(
                "gate_select", lambda n, gc: gs.gate_select_cuda(qg, kg, n, gc, msel),
                lambda n, gc: gs.gate_select_plain(qg, kg, n, gc, msel),
                lambda n, gc: gs.gate_scores_plain(qg, kg, n, gc), nv, kg.shape[2], gcfg)
            print(f"{label}: #1 on layer 0 of the first decode step, {checks} cases equal to "
                  f"plain, near-tie swaps {swaps}")
            (q, kc, vc, idx, kv_len), kw = seen["sparse_decode"]
            bs = kw["block_size"]
            derr = check_decode(
                "block_sparse_decode",
                lambda qq, ix: bsd.sparse_decode_cuda(qq, kc, vc, ix, kv_len, block_size=bs),
                lambda qq, ix: bsd.sparse_decode_plain(qq, kc, vc, ix, kv_len, block_size=bs),
                decode_cases(q, idx))
            errs["gate_select"].append(gerr)
            errs["block_sparse_decode"].append(derr)
        del seen
    del params, base
    free_card()
    print(f"phase 45 (the MoE's expert dispatch): {time.perf_counter() - t0:.1f} s")
    return counts, errs


# ---------------------------------------------------------------------------
# the recurrent families and expert parallelism on a sharded engine (phase 42)
# ---------------------------------------------------------------------------

def counted_prefills(eng, coll):
    """Count apart the collectives the engine's paged prefills make (a
    prefill's Mamba sums and expert gathers): returns {"n"}, kept up to
    date while ``coll`` (``counting_collectives``' counts) runs."""
    inside, real = {"n": 0}, eng._paged_prefill

    def prefill(*a, **kw):
        n0 = coll["n"]
        try:
            return real(*a, **kw)
        finally:
            inside["n"] += coll["n"] - n0
    eng._paged_prefill = prefill
    return inside


@contextlib.contextmanager
def collectives_counted(eng, shard):
    """The shard's collectives counted while the block runs (a ``serve``
    of ``eng``), those of the engine's paged prefills apart: yields
    (``counting_collectives``' counts, ``counted_prefills``')."""
    coll, uncount = counting_collectives(shard)
    pre = counted_prefills(eng, coll)
    try:
        yield coll, pre
    finally:
        uncount()
        del eng._paged_prefill


def print_step_collectives(label, coll, pre, st):
    """A counted serve's collectives a decode step (its stats ``st``)."""
    steps = st["decode_steps"] + st["replay_steps"]
    print(f"{label}: {(coll['n'] - pre['n'] - 1) / steps:.1f} collectives a decode step "
          f"({pre['n']} in the {st['admitted']} prefills, 1 for the stats), "
          f"{1e3 * coll['host_s'] / steps:.3f} ms of host time a step in all of them")


def rank_params(label, cfg, params, eng, shard):
    """A sharded engine's parameter bytes on this rank beside the sum, over
    the full tree ``params``, of each leaf's ``local_shape`` under its
    ``decode_layout`` (the phase fails unless they are equal), and a
    two-rank engine's by the same layout (computed, not measured)."""
    full = list(tl._walk(params))

    def laid(world):
        return sum(math.prod(local_shape(t.shape, decode_layout(path, tuple(t.shape), cfg,
                                                                world), world))
                   * t.element_size() for path, t in full)
    held = sum(t.numel() * t.element_size() for _, t in tl._walk(eng.params))
    want = laid(shard.world)
    if held != want:
        fail(f"{label}: this rank holds {held} B of parameters, the layout {want} B")
    print(f"{label}: this rank's parameters {held} B = the sum of local_shape over the "
          f"layout at world size {shard.world}; at two ranks {laid(2)} B a rank of the "
          f"unsharded {laid(1)} B (computed)")


def sharded_serve(label, eng, reqs, num_pages, n_layers, shard, profiled=False):
    """One ``run_serve`` of the sharded engine (launch counters checked
    there), with the first call of each paged kernel captured and the
    collectives counted (those of the prefills apart); ``profiled``: three
    decode steps under torch.profiler (``profiled_window``), left out of
    the ms a decode step. Returns (result, launch counts, captured
    arguments)."""
    coll, uncount = counting_collectives(shard)
    pre = counted_prefills(eng, coll)
    seen, restore = capture_first(PAGED_CALLS)
    rec, unprofile = profiled_window(eng) if profiled else (None, lambda: None)
    try:
        res, counts, prefill_s = run_serve(eng, reqs, num_pages, n_layers)
    finally:
        unprofile()
        restore()
        uncount()
        del eng._paged_prefill
    st = res["stats"]
    steps = st["decode_steps"] + st["replay_steps"]
    decode_s, n, window = st["wall_s"] - prefill_s, st["decode_steps"], ""
    if rec is not None:
        w = window_stats(rec)
        decode_s, n = decode_s - rec["span"], n - rec["steps"]
        window = (f"; profiled over {rec['steps']} steps: {w['per_step']:.2f} ms a step under "
                  f"the profiler, device busy {w['busy']:.2f} ms = "
                  f"{100 * w['busy'] / w['per_step']:.1f}%, of which NCCL kernels "
                  f"{w['nccl']:.3f} ms; {w['launches']:.0f} kernel launches and "
                  f"{w['collectives']:.0f} collectives a step, {w['comm_ms']:.2f} ms of host "
                  f"time in them")
    print(f"{label}: {1e3 * decode_s / n:.2f} ms a decode step"
          + (" outside the profiled window" if rec is not None else "")
          + f"; {(coll['n'] - pre['n'] - 1) / steps:.1f} collectives a decode step "
          f"({pre['n']} in the {st['admitted']} prefills, 1 for the stats), "
          f"{1e3 * coll['host_s'] / steps:.3f} ms of host time a step in all of them"
          f"{window} ({card_line()})")
    return res, counts, seen


def held_serve(label, base, run, reqs, bitwise=True):
    """``run`` against the unsharded ``base`` of the same requests and
    pool: the same scheduling, swap and sparsity stats, and the tokens and
    every step's logits bitwise, or (split-K reorders the softmax sums)
    every step reached from equal histories within DECODE_ULPS bf16 ulps
    of max|logit| (``drift_ulps``)."""
    for key in ("decode_steps", "peak_pages_used", "preemptions", "resumed",
                "swapped_out_bytes", "swapped_in_bytes", "sparsity_by_rid", "replay_steps"):
        if run["stats"][key] != base["stats"][key]:
            fail(f"{label}: {key} {run['stats'][key]} != the unsharded run's "
                 f"{base['stats'][key]}")
    if bitwise:
        same_run(label, base, run, reqs)
        held = "bitwise the unsharded run (tokens, every step's logits"
    else:
        worst, same, total = drift_ulps(base, run, reqs)
        if worst > DECODE_ULPS:
            fail(f"{label}: logits {worst:.2f} bf16 ulps from the unsharded run's "
                 f"(limit {DECODE_ULPS})")
        held = (f"within {worst:.3f} bf16 ulps of max|logit| of the unsharded run up to each "
                f"request's first differing token (limit {DECODE_ULPS}; tokens equal "
                f"{same}/{total}")
    print(f"{label}: {held}, steps, pages, preemptions {run['stats']['preemptions']}, swap "
          f"bytes {run['stats']['swapped_out_bytes']}, sparsity by request)")


def sharded_generate(label, eng, batch, base, bitwise):
    """The sharded engine's ``generate`` of phase 33's or 34's batch with
    every launch counter at 0 just before (nothing launches: the Mamba1 LM
    has no attention, the hybrid's shared block takes the sequence-sharded
    step, plain PyTorch as the reference's jnp), held to the unsharded
    run: bitwise, or every decode step reached from equal histories within
    DECODE_ULPS bf16 ulps (``drift_ulps``, each row a request)."""
    logits, step = [], eng._step

    def keep(*a):
        out = step(*a)
        logits.append(out[1].clone())
        return out
    eng._step = keep
    ops.reset_launch_counts()
    try:
        res = eng.generate(batch, NEW_TOKENS)
    finally:
        del eng._step
    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"{label}: a kernel launched on the sequence-sharded generate: {counts}")
    toks, lg = res["tokens"].cpu(), torch.stack(logits).float().cpu()
    n_steps = NEW_TOKENS - 1
    if bitwise:
        if not (torch.equal(toks, base["tokens"]) and torch.equal(lg, base["logits"])):
            fail(f"{label}: not bitwise the unsharded generate")
        held = "bitwise the unsharded run (tokens and every step's logits)"
    else:
        if not torch.equal(toks[:, 0], base["tokens"][:, 0]):
            fail(f"{label}: the prefill's tokens differ from the unsharded run's")
        rows = [{"rid": b} for b in range(toks.shape[0])]

        def as_serve(t, lgs):
            # row b's decoded tokens and the logits that chose them
            return {**{b: t[b, 1:].tolist() for b in range(t.shape[0])},
                    "logits": {b: lgs[:, b].numpy() for b in range(t.shape[0])}}
        worst, same, total = drift_ulps(as_serve(base["tokens"], base["logits"]),
                                        as_serve(toks, lg), rows)
        if worst > DECODE_ULPS:
            fail(f"{label}: decode logits {worst:.2f} bf16 ulps from the unsharded run's "
                 f"(limit {DECODE_ULPS})")
        held = (f"every decode step reached from equal histories within {worst:.3f} bf16 ulps "
                f"of max|logit| of the unsharded run's (limit {DECODE_ULPS}); decoded tokens "
                f"equal {same}/{total}")
    print(f"{label}: prefill {res['prefill_s']:.2f} s, decode "
          f"{1e3 * res['decode_s'] / n_steps:.2f} ms/step ({n_steps} steps, batch "
          f"{toks.shape[0]}); {held} ({card_line()})")


def rank_bytes(cfg, eng, shard):
    """Print a request's recurrent rows and the routed experts' leaves as
    this rank holds them, beside the unsharded sizes and (computed from
    the layouts, not measured) a two-rank engine's."""
    api = get_api(cfg)
    if api.init_slot_state is not None:
        rows = [sum(t.numel() * t.element_size() for t in api.init_slot_state(
            cfg, 1, device="meta", shard=sh)) for sh in (shard, None)]
        conv_l, h_l = state_layouts(cfg, 2)
        st = api.init_slot_state(cfg, 1, device="meta")
        two = sum(math.prod(local_shape(t.shape, lay, 2)) * t.element_size()
                  for t, lay in zip(st, (conv_l, h_l)))
        print(f"{cfg.arch_id}: a request's recurrent rows on this rank {rows[0]} B of the "
              f"unsharded {rows[1]} B; at two ranks {two} B a rank (computed)")
    experts = [(path, t) for path, t in tl._walk(eng.params)
               if "/moe/" in path and path.split("/moe/")[1] in ("wi_gate", "wi_up", "wo")]
    if experts:
        nb = sum(t.numel() * t.element_size() for _, t in experts)
        e = cfg.moe.n_experts
        print(f"{cfg.arch_id}: this rank's routed experts {experts[0][1].shape[0]} of {e} a "
              f"layer, {nb / 1e9:.3f} GB in {len(experts)} leaves; at two ranks "
              f"{nb * (e // 2) // experts[0][1].shape[0] / 1e9:.3f} GB a rank (computed)")


def check_splitk_first(label, seen):
    """Kernel 5 or 5q against its plain version on its first call of a
    sharded serve, at the serve's split count (phase 11's limits)."""
    (q, kp, vp, idx, pt, kv_len), kw = seen["paged_sparse_decode_splitk"]
    bs, ks, vs, ns = kw["block_size"], kw.get("k_scales"), kw.get("v_scales"), kw["num_splits"]
    quant = ks is not None
    name = "block_sparse_decode_paged_splitk" + ("_quant" if quant else "")

    def kernel(qq, ix):
        if quant:
            return bsd.sparse_decode_paged_splitk_quant_cuda(
                qq, kp, vp, ix, pt, kv_len, block_size=bs, num_splits=ns, k_scales=ks,
                v_scales=vs)
        return bsd.sparse_decode_paged_splitk_cuda(qq, kp, vp, ix, pt, kv_len, block_size=bs,
                                                   num_splits=ns)

    def plain(qq, ix):
        return bsd.sparse_decode_paged_splitk_plain(qq, kp, vp, ix, pt, kv_len, block_size=bs,
                                                    num_splits=ns, k_scales=ks, v_scales=vs)
    print(f"{label}: {name} q {tuple(q.shape)} {q.dtype}, pools {tuple(kp.shape)} {kp.dtype}, "
          f"num_splits {ns}")
    return {name: check_decode(f"{label}: {name} [num_splits {ns}]", kernel, plain,
                               decode_cases(q, idx))}


def phase_sharded_families(shard):
    """Phase 42: falcon_mamba_7b, zamba2_1_2b and deepseek_moe_16b on a
    sharded engine over the one-rank NCCL group, each held to phase 34's,
    33's or 30's unsharded run of the same requests and pool
    (``BASE_RUNS``), the hybrid's paged kernels against their plain
    versions on their first sharded call. Returns (launch counts of the
    sharded serves, {kernel: [max_abs_err]})."""
    t_all = time.perf_counter()
    total, errs = dict.fromkeys(ops.KERNELS, 0), {}
    for arch in SHARDED_FAMILIES:
        t0 = time.perf_counter()
        free_card()
        full = configs.get(arch)
        cfg = full.replace(**{**FAMILY_CONFIGS, **RECURRENT_CUTS}.get(arch, {}))
        api = get_api(cfg)
        n_attn = api.paged_attn_layers(cfg)
        base = BASE_RUNS.pop(arch)
        params = api.init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg)
        prompt = FAMILY_PROMPT.get(arch, PROMPT_LEN)
        reqs = serve_requests(cfg.vocab_size, None if prompt == PROMPT_LEN else prompt)
        max_len = max(r["tokens"].size + r["max_new_tokens"] for r in reqs)
        print(f"phase 42 {arch}: {cfg.num_layers} of {full.num_layers} layers on the one-rank "
              f"NCCL group ({shard})")
        # (name, options, pool pages, the unsharded run held to): a recurrent
        # family's fp serve at its tight pool (preempting: the rank's rows
        # through the swap), the MoE model's at the ample one; the first
        # run with three decode steps profiled
        if cfg.family == "moe":
            runs = [("fp", DecodeOptions(), None, base["serve"][0])]
        else:
            tight = tight_pool_pages(reqs, cfg.gate.block_size)
            runs = [("fp", DecodeOptions(), tight, base["serve"][1])]
        if cfg.family == "hybrid":
            q8, ns = base["int8"][0], SHARDED_SPLIT_K
            runs += [("int8", DecodeOptions(quantize="int8"), None, q8),
                     (f"fp, split_k {ns}", DecodeOptions(split_k=ns), None, base["serve"][0]),
                     (f"int8, split_k {ns}", DecodeOptions(quantize="int8", split_k=ns), None,
                      q8)]
        for i, (name, opts, pages, want) in enumerate(runs):
            label = (f"phase 42 {arch} sharded serve ({name}"
                     + (f", {pages} pages)" if pages is not None else ")"))
            eng = DecodeEngine(cfg, params, max_len=max_len, options=opts, shard=shard)
            if i == 0:
                rank_bytes(cfg, eng, shard)
                rank_params(f"phase 42 {arch}", cfg, params, eng, shard)
            run, counts, seen = sharded_serve(label, eng, reqs, pages, n_attn, shard,
                                              profiled=i == 0)
            for k, n in counts.items():
                total[k] += n
            held_serve(label, want, run, reqs, bitwise=opts.split_k == 1)
            if pages is not None and run["stats"]["preemptions"] < 1:
                fail(f"{label}: the tight pool preempted nothing")
            if cfg.family == "hybrid":
                found = (check_splitk_first(label, seen) if opts.split_k > 1
                         else check_example_kernels(label, seen))
                for k, e in found.items():
                    errs.setdefault(k, []).append(e)
            del eng, run, seen
            torch.cuda.empty_cache()
        if base.get("generate"):
            toks = np.random.default_rng(SEED).integers(
                0, cfg.vocab_size, (BATCH, prompt)).astype(np.int32)
            bs = cfg.gate.block_size
            eng = DecodeEngine(cfg, params, max_len=-(-(prompt + NEW_TOKENS) // bs) * bs,
                               shard=shard)
            coll, uncount = counting_collectives(shard)
            try:
                sharded_generate(f"phase 42 {arch} sharded generate", eng, {"tokens": toks},
                                 base["generate"], bitwise=not n_attn)
            finally:
                uncount()
            print(f"phase 42 {arch} sharded generate: {coll['n']} collectives over the "
                  f"prefill and {NEW_TOKENS - 1} steps, {1e3 * coll['host_s']:.1f} ms of host "
                  f"time in them")
            del eng
        del params, base
        torch.cuda.empty_cache()
        print(f"phase 42 {arch}: {time.perf_counter() - t0:.1f} s")
    print(f"phase 42 (the recurrent families and expert parallelism on a sharded engine): "
          f"{time.perf_counter() - t_all:.1f} s; launches {total}")
    return total, errs


# ---------------------------------------------------------------------------
# the recurrent families: zamba2_1_2b, falcon_mamba_7b (phases 33-34)
# ---------------------------------------------------------------------------

def recurrent_row_bytes(cfg):
    """The bytes of one request's recurrent rows (conv windows in the
    working dtype, fp32 hidden states) over every Mamba layer."""
    st = get_api(cfg).init_slot_state(cfg, 1, device="meta")
    return sum(t.numel() * t.element_size() for t in st)


def phase_recurrent(arch):
    """Phase 33 (zamba2_1_2b) or 34 (falcon_mamba_7b) at full width, at
    the depth of RECURRENT_CUTS (zamba2_1_2b whole). The hybrid: phase 3's checks and timings of #1, #2 and 2q on
    unit 0's shared-block tensors of generate's first decode step (#2
    against dense SDPA printed, not required); generate (batch 4, phase 4's
    prompt, 31 decode steps) with the counters at 0 just before, #1 and #2
    launching units x steps; its profile; serve with phase 6's requests at
    the default pool and at 644 pages (tight == ample bitwise, #3 and #4
    units x steps), over int8 pools likewise (#3 and 4q), and under
    eviction at a resident cap of RESIDENT_CAP pages (replays > 0, bitwise
    the ample run); #3, #4, 5 at 2, 4, 8 and nsel + 3 splits on the fp
    serve's layer-0 tensors, 4q and 5q on the int8 serve's. The Mamba1 LM:
    generate and serve (both pools, tight == ample bitwise, the swapped
    bytes the recurrent rows alone) with every counter at 0, and its
    profile. Returns (launch counts of the paths, {kernel: numbers})."""
    t0 = time.perf_counter()
    free_card()
    full = configs.get(arch)
    cut = RECURRENT_CUTS.get(arch, {})
    cfg = full.replace(**cut)
    api = get_api(cfg)
    n_attn = api.paged_attn_layers(cfg)
    prompt = FAMILY_PROMPT.get(arch, PROMPT_LEN)
    cuts = [f"{k} {getattr(full, k)} -> {v}" for k, v in cut.items()]
    cuts += [f"prompt {PROMPT_LEN} -> {prompt}"] if prompt != PROMPT_LEN else []
    bs = cfg.gate.block_size
    ssm = cfg.ssm
    di = ssm.expand * cfg.d_model
    row_b = recurrent_row_bytes(cfg)
    attn = (f"; the shared attention block after every {cfg.hybrid_period} Mamba2 layers "
            f"({n_attn} units, {cfg.num_layers - n_attn * cfg.hybrid_period} tail layers): "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.resolved_head_dim}, d_ff "
            f"{cfg.d_ff}; gate block {bs}, d_gate {cfg.gate.d_gate}, budget "
            f"{cfg.gate.token_budget}" if n_attn else "; no attention, gate disabled")
    print(f"{arch}: {cfg.num_layers} Mamba{ssm.version} layers, d {cfg.d_model}, d_inner "
          f"{di}, state {ssm.state_dim}, conv {ssm.conv_dim}, scan chunk {ssm.chunk_size}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}{attn}; a request's recurrent rows {row_b} B; "
          f"batch {BATCH}, prompt {prompt}, {NEW_TOKENS} new tokens; reduced {cuts}")
    if n_attn:
        for name, quant in (("fp", False), ("int8", True)):
            plan = bsd.group_plan(cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim, bs,
                                  torch.bfloat16, quant)
            print(f"{arch}: decode plan ({name} K/V, bf16 q): {plan}")
    t1 = time.perf_counter()
    params = api.init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tl._walk(params))
    print(f"{arch}: random weights (seed {SEED}) {n_params / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
          f"{time.perf_counter() - t1:.1f} s")
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, prompt)).astype(np.int32)
    batch = {"tokens": toks}
    max_len = -(-(prompt + NEW_TOKENS) // bs) * bs
    eng = DecodeEngine(cfg, params, max_len=max_len)
    numbers = {}
    if n_attn:
        seen, state = capture_layer0(eng, batch)
        numbers.update(phase_kernels(seen, vs_sdpa=False))
        numbers.update(phase_quant_kernels(seen))
        del seen, state
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = BASE_RUNS[arch] = {"generate": {}}
    counts, _ = phase_end_to_end(eng, batch, NEW_TOKENS, n_attn, keep=base["generate"])
    phase_profile(eng, batch)
    del eng
    torch.cuda.empty_cache()

    reqs = serve_requests(cfg.vocab_size, None if prompt == PROMPT_LEN else prompt)
    tight = tight_pool_pages(reqs, bs)
    print(f"{arch} serve: {SERVE_SLOTS} slots, (prompt, new tokens) "
          f"{[(r['tokens'].size, r['max_new_tokens']) for r in reqs]}; default pool, then "
          f"{tight} pages")
    serve_counts, seen, *fp_runs = phase_serve(cfg, params, reqs=reqs, tight_pages=tight)
    base["serve"] = fp_runs
    st = fp_runs[1]["stats"]
    if not n_attn:
        if st["swapped_out_bytes"] != st["preemptions"] * row_b:
            fail(f"{arch}: swapped {st['swapped_out_bytes']} B, expected the recurrent rows "
                 f"alone, {st['preemptions']} x {row_b} B")
        print(f"{arch}: the tight run swapped {st['swapped_out_bytes']} B = "
              f"{st['preemptions']} preemptions x {row_b} B of recurrent rows alone")
        if any(n for n in counts.values()) or any(n for n in serve_counts.values()):
            fail(f"{arch}: a kernel launched on an attention-free model: {counts}, "
                 f"{serve_counts}")
        print(json.dumps({"config": arch, "reduced": cuts, "kernels": {}}))
        print(f"phase {arch}: {time.perf_counter() - t0:.1f} s")
        return counts, numbers
    print(f"{arch}: the tight run swapped {st['swapped_out_bytes']} B ({st['preemptions']} "
          f"preemptions, {row_b} B of recurrent rows each)")
    numbers.update(phase_paged_kernels(seen, vs_sdpa=False))
    seen["paged_sparse_decode_splitk"] = seen["paged_sparse_decode"]
    numbers.update(phase_splitk_kernels(seen, source=f"{arch} serve"))
    del seen
    torch.cuda.empty_cache()
    print(f"{arch} int8 serve: the same requests and pools, quantize='int8'")
    q8_counts, seen, *q8_runs = phase_serve(cfg, params, DecodeOptions(quantize="int8"),
                                            reqs=reqs, tight_pages=tight)
    check_int8_serve(cfg, fp_runs, q8_runs, n_layers=n_attn, state_bytes=row_b)
    base["int8"] = q8_runs
    numbers.update(phase_paged_quant_kernels(seen))
    seen["paged_sparse_decode_splitk"] = seen["paged_sparse_decode"]
    numbers.update(phase_splitk_kernels(seen, source=f"{arch} int8 serve"))
    del seen, q8_runs
    torch.cuda.empty_cache()
    cap = EvictionConfig(max_resident_pages=RESIDENT_CAP)
    print(f"{arch} eviction: {RESIDENT_CAP} pages a request, default pool")
    eng = DecodeEngine(cfg, params, max_len=max(r["tokens"].size + r["max_new_tokens"]
                                                for r in reqs))
    res, ev_counts, _ = run_pressure(f"{arch} eviction under the cap", eng, reqs, None,
                                     n_attn, eviction=cap)
    if res["stats"]["replay_steps"] < 1:
        fail(f"{arch}: the resident cap forced no replay")
    same_run(f"{arch} eviction under the cap", fp_runs[0], res, reqs)
    print(f"{arch} eviction under the cap reproduces the ample run bitwise with "
          f"{res['stats']['replay_steps']} replayed steps")
    del eng, params, fp_runs
    torch.cuda.empty_cache()
    counts = {name: counts[name] + serve_counts[name] + q8_counts[name] + ev_counts[name]
              for name in counts}
    print(json.dumps({"config": arch, "reduced": cuts, "kernels": numbers}))
    print(f"phase {arch}: {time.perf_counter() - t0:.1f} s")
    return counts, numbers


# ---------------------------------------------------------------------------
# the pressure and failure paths of serve (phases 23-29)
# ---------------------------------------------------------------------------

def same_run(name, base, run, reqs):
    """Fail unless ``run`` reproduces ``base``'s tokens and per-step logits
    bitwise for every request."""
    for r in reqs:
        rid = r["rid"]
        if run[rid] != base[rid]:
            fail(f"{name}: rid {rid}'s tokens differ from the run without pressure")
        if not np.array_equal(run["logits"][rid], base["logits"][rid]):
            fail(f"{name}: rid {rid}'s logits differ from the run without pressure")


def bf16_ulps(a, b) -> float:
    """max|a - b| in bf16 ulps of max|a| (0 where they are equal)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ulp = 2.0 ** -7 * 2.0 ** math.floor(math.log2(float(np.abs(a).max())))
    return float(np.abs(a - b).max()) / ulp


def drift_ulps(base, run, reqs):
    """-> (worst bf16 ulps of max|logit| over the steps both runs reached
    from equal histories, tokens equal, tokens in all): the logits of each
    request compared up to and including its first differing token."""
    worst, same, total = 0.0, 0, 0
    for r in reqs:
        rid = r["rid"]
        a, b = np.asarray(base[rid]), np.asarray(run[rid])
        eq = a == b
        n = len(a) if eq.all() else int(np.argmin(eq)) + 1
        same += int(eq.sum())
        total += len(a)
        worst = max(worst, bf16_ulps(base["logits"][rid][:n], run["logits"][rid][:n]))
    return worst, same, total


class TableWatch:
    """Wraps the paged gate select and the paged decode dispatch for one
    serve: keeps each call's largest table id on the device (read once at
    the end), and copies the arguments of the first gate call whose RAW
    table holds a ghost id (>= the K/V pool's pages) and of the decode
    call of the same layer right after it."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.real = (ops.gate_select_paged, ops.paged_sparse_decode_splitk)
        self.gate_max, self.decode_max, self.seen = [], [], {}
        self.arm = False

    def __enter__(self):
        real_gate, real_dec = self.real

        def copy(x):
            return x.clone() if torch.is_tensor(x) else x

        def gate(qg, kg_pages, page_table, n_valid, cfg, max_selected=None):
            self.gate_max.append(page_table.max())
            if "gate" not in self.seen and int(page_table.max()) >= self.n_pages:
                self.seen["gate"] = tuple(map(copy, (qg, kg_pages, page_table, n_valid,
                                                     cfg, max_selected)))
                self.arm = True
            return real_gate(qg, kg_pages, page_table, n_valid, cfg, max_selected)

        def decode(*a, **kw):
            self.decode_max.append(a[4].max())
            if self.arm:
                self.seen["decode"] = (tuple(map(copy, a)), {k: copy(v) for k, v in kw.items()})
                self.arm = False
            return real_dec(*a, **kw)
        ops.gate_select_paged, ops.paged_sparse_decode_splitk = gate, decode
        return self

    def __exit__(self, *exc):
        ops.gate_select_paged, ops.paged_sparse_decode_splitk = self.real

    def check(self, name):
        """-> the largest table ids the gate select and the decode kernel
        got; fails if the decode kernel got one past the pool."""
        top_dec = int(torch.stack(self.decode_max).max())
        top_gate = int(torch.stack(self.gate_max).max())
        if top_dec >= self.n_pages:
            fail(f"{name}: a table handed to the decode kernel holds id {top_dec} >= "
                 f"the pool's {self.n_pages} pages")
        return top_gate, top_dec


def run_pressure(label, eng, reqs, num_pages, n_layers, **kw):
    """run_serve under a TableWatch, ghost rows counted through
    ``paging.copy_gate_rows``; prints the eviction, swap and replay
    telemetry. Returns (result, launch counts, watch)."""
    real_copy = pg.copy_gate_rows
    ghosts = set()

    def copy_gate_rows(pages, src, dst):
        ghosts.update(int(x) for x in dst.tolist() if x > 0)
        return real_copy(pages, src, dst)
    pg.copy_gate_rows = copy_gate_rows
    if num_pages is None:                  # serve's default pool, named for the watch
        num_pages = SERVE_SLOTS * max(pages_needed(r["tokens"].size, r["max_new_tokens"],
                                                   eng.cfg.gate.block_size) for r in reqs) + 1
    watch = TableWatch(num_pages)
    try:
        with watch:
            res, counts, prefill_s = run_serve(eng, reqs, num_pages, n_layers, **kw)
    finally:
        pg.copy_gate_rows = real_copy
    st = res["stats"]
    top_gate, top_dec = watch.check(label)
    steps = st["decode_steps"]
    sw = st["swap"]
    print(f"{label}: evictions {st['evictions']}, page restores {st['page_restores']}, "
          f"replayed steps {st['replay_steps']}, ghost rows used {len(ghosts)}, preemptions "
          f"{st['preemptions']}; swapped out {st['swapped_out_bytes']} B, in "
          f"{st['swapped_in_bytes']} B (host tier peak {sw['peak_host_bytes']} B, disk tier "
          f"peak {sw['peak_disk_bytes']} B, demotions {sw['demotions']}, promotions "
          f"{sw['promotions']}); {steps} decode steps, "
          f"{1e3 * (st['wall_s'] - prefill_s) / steps:.2f} ms/step with the replays and "
          f"swaps; largest table id to the gate select {top_gate}, to the decode kernel "
          f"{top_dec} (pool {st['num_pages']} pages)")
    return res, counts, watch


def check_ghost_kernels(name, watch, decode_kernel_fn, decode_plain_fn):
    """#3 and a decode kernel against their plain versions on the first
    layer call whose raw table held ghost ids (``watch.seen``): #3 over
    the ghost-extended Kg pool through the raw table (near-tie swaps only,
    and bitwise on exact ties), the decode kernel through the clamped
    table (phase 3's limit). Returns (gate error, decode error)."""
    if "gate" not in watch.seen:
        fail(f"{name}: no step read a ghost id")
    qg, kgp, pt, nv, gcfg, ms = watch.seen["gate"]
    (q, kp, vp, idx, pt_kv, kv_len), kw = watch.seen["decode"]
    kw = {k: kw[k] for k in ("block_size", "k_scales", "v_scales") if kw.get(k) is not None}
    n_ghost = int((pt >= kp.shape[0]).sum())
    print(f"{name}: layer 0 of the first attempt with ghost ids: {n_ghost} table entries "
          f"past the pool's {kp.shape[0]} pages, Kg pool {tuple(kgp.shape)}; the decode's "
          f"table clamped at {int(pt_kv.max())}")

    def gate_checks(q_, pool, exact):
        return gate_cases(
            f"{name} gate_select_paged",
            lambda n, c: gs.gate_select_paged_cuda(q_, pool, pt, n, c, ms),
            lambda n, c: gs.gate_select_paged_plain(q_, pool, pt, n, c, ms),
            lambda n, c: gs.gate_scores_plain(q_, pg.gather_kg(pool, pt), n, c), nv,
            pt.shape[1], gcfg, exact=exact)
    checks, swaps, gate_err = gate_checks(qg, kgp, False)
    tq, tk = tie_inputs(qg, kgp)
    t_checks, t_swaps, _ = gate_checks(tq, tk, True)
    print(f"{name} gate_select_paged over ghost rows: {checks} cases equal to plain "
          f"(near-tie swaps {swaps}); exact ties {t_checks} cases, budget ids bitwise, "
          f"threshold swaps {t_swaps}")
    dec_err = check_decode(f"{name} {decode_kernel_fn.__name__} (clamped table)",
                           lambda qq, ix: decode_kernel_fn(qq, kp, vp, ix, pt_kv, kv_len, **kw),
                           lambda qq, ix: decode_plain_fn(qq, kp, vp, ix, pt_kv, kv_len, **kw),
                           decode_cases(q, idx))
    return gate_err, dec_err


def copy_rates(nbytes: int = 1 << 30):
    """Host <-> device copy rates in GB/s over ``nbytes``, pinned and
    pageable host memory (CUDA events, median of 5), beside the swap cost
    model's ``offload.PCIE_BW``."""
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = {}
    for kind, host in (("pinned", torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)),
                       ("pageable", torch.empty(nbytes, dtype=torch.uint8))):
        for way, (dst, src) in (("h2d", (dev, host)), ("d2h", (host, dev))):
            t = time_ms(lambda: dst.copy_(src, non_blocking=True), runs=5, warmup=1)
            out[f"{kind} {way}"] = nbytes / t / 1e6
        del host
    del dev
    return out


def phase_pressure(cfg, params, shard, fp_runs, q8_ample, sh_ample, shq_ample):
    """Phases 23-27: serve's eviction (fp at the tight pool and under a
    resident cap, int8 and sharded fp and int8 under the cap) and its
    bounded swap tier, held to phase 6, 9, 11 and 12's runs. Returns
    (launch counts of the paths, the kernels' errors on the eviction
    path)."""
    reqs = serve_requests(cfg.vocab_size)
    max_len = max(p + m for p, m in SERVE_SPECS)
    n = cfg.num_layers
    fp_ample, fp_tight = fp_runs
    counts = dict.fromkeys(ops.KERNELS, 0)
    errs = {}

    def add(c):
        for k, v in c.items():
            counts[k] += v

    def join(name, err):
        errs.setdefault(name, []).append(err)

    t0 = time.perf_counter()
    eng = DecodeEngine(cfg, params, max_len=max_len)
    print(f"eviction (phase 23): EvictionConfig() at {TIGHT_PAGES} pages")
    res, c, _ = run_pressure("eviction at the tight pool", eng, reqs, TIGHT_PAGES, n,
                             eviction=EvictionConfig())
    add(c)
    same_run("eviction at the tight pool", fp_ample, res, reqs)
    if res["stats"]["preemptions"] > fp_tight["stats"]["preemptions"]:
        fail(f"eviction preempted {res['stats']['preemptions']} requests, the tight run "
             f"{fp_tight['stats']['preemptions']}")
    print(f"eviction at the tight pool reproduces phase 6's ample run bitwise (tokens, "
          f"logits) with {res['stats']['preemptions']} preemptions against the tight run's "
          f"{fp_tight['stats']['preemptions']}")

    cap = EvictionConfig(max_resident_pages=RESIDENT_CAP)
    print(f"eviction under a resident cap (phase 24): {RESIDENT_CAP} pages a request, "
          f"default pool")
    res, c, watch = run_pressure("eviction under the cap", eng, reqs, None, n, eviction=cap)
    add(c)
    st = res["stats"]
    if st["replay_steps"] < 1:
        fail("the resident cap forced no replay")
    same_run("eviction under the cap", fp_ample, res, reqs)
    g_err, d_err = check_ghost_kernels("eviction under the cap", watch,
                                       bsd.sparse_decode_paged_cuda,
                                       bsd.sparse_decode_paged_plain)
    join("gate_select_paged", g_err)
    join("block_sparse_decode_paged", d_err)
    print(f"eviction under the cap reproduces phase 6's ample run bitwise with "
          f"{st['replay_steps']} replayed steps and no restore_thrash")
    del eng, watch
    torch.cuda.empty_cache()

    print(f"int8 eviction (phase 25): the cap at {TIGHT_PAGES} pages, quantize='int8'")
    eng = DecodeEngine(cfg, params, max_len=max_len, options=DecodeOptions(quantize="int8"))
    res, c, watch = run_pressure("int8 eviction", eng, reqs, TIGHT_PAGES, n, eviction=cap)
    add(c)
    if res["stats"]["replay_steps"] < 1:
        fail("int8 eviction replayed no step")
    worst, same, total = drift_ulps(q8_ample, res, reqs)
    if worst > DECODE_ULPS:
        fail(f"int8 eviction: logits {worst:.2f} bf16 ulps from phase 9's ample run "
             f"(limit {DECODE_ULPS})")
    print(f"int8 eviction against phase 9's ample run: logits within {worst:.3f} bf16 ulps "
          f"of max|logit| up to each request's first differing token (limit {DECODE_ULPS}; "
          f"a replay requantizes the trailing page, as in the reference); tokens equal "
          f"{same}/{total}")
    g_err, d_err = check_ghost_kernels("int8 eviction", watch,
                                       bsd.sparse_decode_paged_quant_cuda,
                                       bsd.sparse_decode_paged_plain)
    join("gate_select_paged", g_err)
    join("block_sparse_decode_paged_quant", d_err)
    del eng, watch
    torch.cuda.empty_cache()

    for quantize, kernel, base in ((None, bsd.sparse_decode_paged_splitk_cuda, sh_ample),
                                   ("int8", bsd.sparse_decode_paged_splitk_quant_cuda,
                                    shq_ample)):
        label = "sharded eviction" + (" (int8)" if quantize else "")
        print(f"{label} (phase 26): the cap at {TIGHT_PAGES} pages, split_k={SPLIT_K}, "
              f"one NCCL rank")
        eng = DecodeEngine(cfg, params, max_len=max_len, shard=shard,
                           options=DecodeOptions(split_k=SPLIT_K, quantize=quantize))
        res, c, watch = run_pressure(label, eng, reqs, TIGHT_PAGES, n, eviction=cap)
        add(c)
        if res["stats"]["replay_steps"] < 1:
            fail(f"{label} replayed no step")
        if quantize is None:
            same_run(label, base, res, reqs)
            print(f"{label} reproduces phase 11's sharded ample run bitwise")
        else:
            worst, same, total = drift_ulps(base, res, reqs)
            if worst > DECODE_ULPS:
                fail(f"{label}: logits {worst:.2f} bf16 ulps from phase 12's ample run")
            print(f"{label} against phase 12's sharded int8 ample run: logits within "
                  f"{worst:.3f} bf16 ulps up to each request's first differing token (limit "
                  f"{DECODE_ULPS}); tokens equal {same}/{total}")
        name = decode_kernel(eng.options)
        splitk = lambda *a, kernel=kernel, **kw: kernel(*a, num_splits=SPLIT_K, **kw)
        splitk.__name__ = name
        g_err, d_err = check_ghost_kernels(
            label, watch, splitk,
            lambda *a, **kw: bsd.sparse_decode_paged_splitk_plain(*a, num_splits=SPLIT_K,
                                                                  **kw))
        join("gate_select_paged", g_err)
        join(name, d_err)
        del eng, watch
        torch.cuda.empty_cache()

    print(f"bounded swap (phase 27): {TIGHT_PAGES} pages, a host tier of {SWAP_HOST_BYTES} B "
          f"over a temporary disk tier")
    rates = copy_rates()
    print("host <-> device copies, GB/s (1 GiB, CUDA events): "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + f"; the swap cost model's PCIE_BW {offload.PCIE_BW / 1e9:.0f} GB/s (PCIe Gen5 "
          f"x16, each way)")
    eng = DecodeEngine(cfg, params, max_len=max_len)
    disk = tempfile.mkdtemp(prefix="chip_smoke_swap_")
    try:
        res, c, _ = run_pressure("bounded swap", eng, reqs, TIGHT_PAGES, n,
                                 swap_config=SwapConfig(host_capacity_bytes=SWAP_HOST_BYTES,
                                                        disk_dir=disk))
    finally:
        shutil.rmtree(disk, ignore_errors=True)
    add(c)
    sw = res["stats"]["swap"]
    if sw["peak_disk_bytes"] <= 0 or sw["peak_host_bytes"] > SWAP_HOST_BYTES:
        fail(f"bounded swap: disk peak {sw['peak_disk_bytes']} B, host peak "
             f"{sw['peak_host_bytes']} B")
    same_run("bounded swap", fp_ample, res, reqs)
    print(f"bounded swap: the preempted request went through the disk tier "
          f"({sw['peak_disk_bytes']} B) and resumed bitwise")
    del eng
    torch.cuda.empty_cache()
    print(f"pressure phases 23-27: {time.perf_counter() - t0:.1f} s; launch counts {counts}")
    return counts, errs


def phase_faults(cfg, params):
    """Phase 28: a fault storm over ``page_alloc``, swap put/pop and
    ``logits`` (FAULT_PLAN) on the requests of phase 6 with prompts of
    at most 4097 tokens, at a pool of FAULT_PAGES that preempts: serve()
    returns, every request retires or fails alone, and each one that did
    not fail is bitwise the same run without faults."""
    t0 = time.perf_counter()
    reqs = [r for r in serve_requests(cfg.vocab_size) if r["tokens"].size <= 4097]
    eng = DecodeEngine(cfg, params, max_len=max(p + m for p, m in SERVE_SPECS))
    kw = dict(n_slots=SERVE_SLOTS, num_pages=FAULT_PAGES, collect_logits=True)
    clean = eng.serve(reqs, **kw)
    ops.reset_launch_counts()
    res = eng.serve(reqs, faults=FaultInjector(FAULT_PLAN), **kw)
    counts = ops.launch_counts()
    st = res["stats"]
    if st["retired"] + st["failed"] != len(reqs) or st["failed"] < 1:
        fail(f"fault storm: retired {st['retired']}, failed {st['failed']} of {len(reqs)}")
    for r in reqs:
        rid = r["rid"]
        if rid in st["errors"]:
            continue
        if res[rid] != clean[rid] or not np.array_equal(res["logits"][rid],
                                                        clean["logits"][rid]):
            fail(f"fault storm: surviving rid {rid} differs from the run without faults")
    want = stage_counts(eng.options, cfg.num_layers, st["decode_steps"])
    if counts != want:
        fail(f"fault storm launch counts {counts}, expected {want}")
    print(f"fault storm (phase 28): {len(reqs)} requests (prompts "
          f"{[r['tokens'].size for r in reqs]}), {FAULT_PAGES} pages, plan {FAULT_PLAN}: "
          f"errors {st['errors']}, partial tokens "
          f"{ {rid: len(res[rid]) for rid in st['errors']} }, fired {st['faults']['fired']}, "
          f"preemptions {st['preemptions']}, swap retries {st['swap']['retries_used']}; the "
          f"survivors bitwise the fault-free run; {time.perf_counter() - t0:.1f} s")
    return counts


def phase_frontend(cfg, params):
    """Phase 29: a seeded open-loop trace (TRAFFIC_*) in two SLO tiers
    through ``ServingFrontend`` with streaming, twice: equal streams and
    virtual-step stamps, the launches of the first run (layers x the decode
    steps it ran); TTFT/TPOT p50/p99 by tier in decode steps and ms
    printed. Returns (launch counts, the streamed (rid, token, index,
    step) events), which phase 40's sharded frontend must reproduce."""
    t0 = time.perf_counter()
    trace = traffic.poisson_trace(TRAFFIC_N, TRAFFIC_RATE, seed=TRAFFIC_SEED,
                                  prompt_len=TRAFFIC_PROMPT, output_len=TRAFFIC_OUTPUT,
                                  tiers=TRAFFIC_TIERS)
    eng = DecodeEngine(cfg, params, max_len=TRAFFIC_PROMPT[1] + TRAFFIC_OUTPUT[1])
    # an open-loop gap ticks the step clock with no step run: count the
    # steps the engine runs
    real_api, ran = eng.api, [0]

    def step(*a, **kw):
        ran[0] += 1
        return real_api.decode_step_paged(*a, **kw)
    runs = []
    for i in range(2):
        fe = ServingFrontend(eng, tier_policy=default_tiers(cfg), n_slots=SERVE_SLOTS)
        if i == 0:
            eng.api = real_api._replace(decode_step_paged=step)
            ops.reset_launch_counts()
        try:
            runs.append(fe.run(trace, collect_events=True))
        finally:
            eng.api = real_api
        if i == 0:
            counts = ops.launch_counts()
    a, b = runs
    st = a["stats"]
    if st["errors"] or b["stats"]["errors"]:
        fail(f"frontend: errors {st['errors']} / {b['stats']['errors']}")
    for e in trace:
        if a[e.rid] != b[e.rid] or len(a[e.rid]) != e.output_len:
            fail(f"frontend: rid {e.rid}'s stream differs between runs or is short")
    ev = [[(x.rid, x.token, x.index, x.step) for x in r["events"]] for r in runs]
    if ev[0] != ev[1] or len(ev[0]) != sum(e.output_len for e in trace):
        fail("frontend: the streamed events differ between the two runs")
    want = stage_counts(eng.options, cfg.num_layers, ran[0])
    if counts != want:
        fail(f"frontend launch counts {counts}, expected {want}")
    print(f"frontend (phase 29): {TRAFFIC_N} requests, Poisson at {TRAFFIC_RATE} a decode "
          f"step (seed {TRAFFIC_SEED}), prompts {TRAFFIC_PROMPT}, outputs {TRAFFIC_OUTPUT}, "
          f"tiers {TRAFFIC_TIERS} under default_tiers; {st['decode_steps']} steps on the "
          f"clock, {ran[0]} of them decode steps, "
          f"wall {st['wall_s']:.2f} / {b['stats']['wall_s']:.2f} s; two runs stream the same "
          f"{len(ev[0])} tokens at the same steps")
    for tier, row in st["tiers"].items():
        print(f"frontend tier {tier}: n {row['n']:.0f}, TTFT p50/p99 "
              f"{row['ttft_steps_p50']:.1f}/{row['ttft_steps_p99']:.1f} steps, "
              f"{row['ttft_ms_p50']:.1f}/{row['ttft_ms_p99']:.1f} ms; TPOT p50/p99 "
              f"{row['tpot_steps_p50']:.3f}/{row['tpot_steps_p99']:.3f} steps, "
              f"{row['tpot_ms_p50']:.1f}/{row['tpot_ms_p99']:.1f} ms; "
              f"{row['tok_per_s']:.1f} tok/s")
    print(f"frontend: {time.perf_counter() - t0:.1f} s")
    return counts, ev[0]


# ---------------------------------------------------------------------------
# the serving launcher, the examples and the sharded engine with every
# decode option (phases 38-40)
# ---------------------------------------------------------------------------

EXAMPLE_CALLS = ("gate_select", "sparse_decode", "gate_select_paged", "paged_sparse_decode",
                 "gate_gt_attention")


def first_run_line(name, label, kernel, plain):
    """Print a kernel's time at an example's shape beside its plain
    version's (``time_ms``) and the card."""
    print(f"{name} [{label}]: kernel {time_ms(kernel):.4f} ms, plain {time_ms(plain):.4f} ms "
          f"({card_line()})")


def check_example_kernels(label, seen):
    """Every kernel an example reached, against its plain version on the
    tensors its first call got (``capture_first``), with the limits of
    phases 3, 7 and 16: #1 and #3 ids equal up to near-tie swaps and
    bitwise on exact ties at the same shapes (#3 also over shuffled
    pages), the decode kernels within DECODE_ULPS of max|o_plain|, kernel 6
    as phase 16 holds it. Each kernel's first run at this shape is timed
    beside its plain version. Returns {kernel: max_abs_err}."""
    errs = {}
    if "gate_select" in seen:
        (qg, kg, nv, gcfg, ms), _ = seen["gate_select"]
        nb, worst = kg.shape[2], 0.0
        for exact, (q_, k_) in ((False, (qg, kg)), (True, tie_inputs(qg, kg))):
            checks, swaps, gap = gate_cases(
                f"{label}: gate_select", lambda n, c: gs.gate_select_cuda(q_, k_, n, c, ms),
                lambda n, c: gs.gate_select_plain(q_, k_, n, c, ms),
                lambda n, c: gs.gate_scores_plain(q_, k_, n, c), nv, nb, gcfg, exact=exact)
            worst = max(worst, gap)
            print(f"{label}: gate_select {'exact ties, budget ids bitwise' if exact else 'captured'}"
                  f" ({tuple(qg.shape)}, Kg {tuple(kg.shape)} {kg.dtype}): {checks} cases, "
                  f"near-tie swaps {swaps}")
        first_run_line("gate_select", label, lambda: gs.gate_select_cuda(qg, kg, nv, gcfg, ms),
                       lambda: gs.gate_select_plain(qg, kg, nv, gcfg, ms))
        errs["gate_select"] = worst
    if "sparse_decode" in seen:
        (q, kc, vc, idx, kv_len), kw = seen["sparse_decode"]
        bs = kw["block_size"]
        kernel = lambda qq, ix: bsd.sparse_decode_cuda(qq, kc, vc, ix, kv_len, block_size=bs)
        plain = lambda qq, ix: bsd.sparse_decode_plain(qq, kc, vc, ix, kv_len, block_size=bs)
        print(f"{label}: block_sparse_decode q {tuple(q.shape)} {q.dtype}, caches "
              f"{tuple(kc.shape)}, block {bs}, plan {bsd.group_plan(q.shape[2], q.shape[3], bs, q.dtype)}")
        errs["block_sparse_decode"] = check_decode(f"{label}: block_sparse_decode", kernel,
                                                   plain, decode_cases(q, idx))
        first_run_line("block_sparse_decode", label, lambda: kernel(q, idx),
                       lambda: plain(q, idx))
    if "gate_select_paged" in seen:
        (qg, kgp, pt, nv, gcfg, ms), _ = seen["gate_select_paged"]
        npt, worst = pt.shape[1], 0.0
        pt_s, kgp_s = shuffled_pages(pt, kgp)
        tq, tk = tie_inputs(qg, kgp)
        for exact, (q_, pool, pool_s) in ((False, (qg, kgp, kgp_s)),
                                          (True, (tq, tk, shuffled_pages(pt, tk)[1]))):
            checks, swaps, gap = gate_cases(
                f"{label}: gate_select_paged",
                lambda n, c: gs.gate_select_paged_cuda(q_, pool, pt, n, c, ms),
                lambda n, c: gs.gate_select_paged_plain(q_, pool, pt, n, c, ms),
                lambda n, c: gs.gate_scores_plain(q_, pg.gather_kg(pool, pt), n, c), nv, npt,
                gcfg, exact=exact,
                shuffled=lambda n, c: gs.gate_select_paged_cuda(q_, pool_s, pt_s, n, c, ms))
            worst = max(worst, gap)
            print(f"{label}: gate_select_paged {'exact ties, budget ids bitwise' if exact else 'captured'}"
                  f" (qg {tuple(qg.shape)}, pool {tuple(kgp.shape)} {kgp.dtype}): {checks} "
                  f"cases, near-tie swaps {swaps}, bitwise over shuffled pages")
        first_run_line("gate_select_paged", label,
                       lambda: gs.gate_select_paged_cuda(qg, kgp, pt, nv, gcfg, ms),
                       lambda: gs.gate_select_paged_plain(qg, kgp, pt, nv, gcfg, ms))
        errs["gate_select_paged"] = worst
    if "paged_sparse_decode" in seen:
        (q, kp, vp, idx, pt_d, kv_len), kw = seen["paged_sparse_decode"]
        bs, ks, vs = kw["block_size"], kw.get("k_scales"), kw.get("v_scales")
        quant = ks is not None
        name = "block_sparse_decode_paged" + ("_quant" if quant else "")
        if quant:
            kernel = lambda qq, ix, p=(pt_d, kp, vp, ks, vs): bsd.sparse_decode_paged_quant_cuda(
                qq, p[1], p[2], ix, p[0], kv_len, block_size=bs, k_scales=p[3], v_scales=p[4])
        else:
            kernel = lambda qq, ix, p=(pt_d, kp, vp): bsd.sparse_decode_paged_cuda(
                qq, p[1], p[2], ix, p[0], kv_len, block_size=bs)
        plain = lambda qq, ix: bsd.sparse_decode_paged_plain(
            qq, kp, vp, ix, pt_d, kv_len, block_size=bs, k_scales=ks, v_scales=vs)
        shuffled = shuffled_pages(pt_d, kp, vp, *((ks, vs) if quant else ()))
        print(f"{label}: {name} q {tuple(q.shape)} {q.dtype}, pools {tuple(kp.shape)} "
              f"{kp.dtype}, block {bs}")
        errs[name] = check_decode(f"{label}: {name}", kernel, plain, decode_cases(q, idx),
                                  lambda qq, ix: kernel(qq, ix, shuffled))
        del shuffled
        first_run_line(name, label, lambda: kernel(q, idx), lambda: plain(q, idx))
    if "gate_gt_attention" in seen:
        errs["gate_gt_attention"] = phase_gt_kernel(*seen["gate_gt_attention"])[
            "gate_gt_attention"]["max_abs_err"]
    return errs


def param_leaves(tree):
    """The tensors of nested dicts and lists of parameters, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in param_leaves(v)]
    return [tree]


def run_counted(fn, *a, names=EXAMPLE_CALLS, **kw):
    """``fn(*a, **kw)`` with every launch counter at 0 just before and the
    first-call arguments of each dispatcher in ``names`` captured: (its
    result, the launch counts read just after, the captured arguments)."""
    seen, restore = capture_first(names)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    try:
        out = fn(*a, **kw)
    finally:
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        restore()
    return out, counts, seen


def phase_launcher():
    """Phase 38: the serving launcher's command line at full width
    (``LAUNCH_ARGV``: qwen3_0_6b, nothing cut, GatePolicy at a 4096-token
    budget, then ``--policy quest``), each with the launch counters at 0
    just before and read just after: #2 launches layers x decode steps
    times, #1 as many under the gate and none under Quest. The gate run's
    own engine (recorded as the launcher builds it) holds parameters
    bitwise those built here from seed 0 and measures the sparsity the
    launcher printed; the two runs share their dense prefill, so their
    first tokens are equal."""
    t0 = time.perf_counter()
    cfg = launch_serve.launch_config("qwen3_0_6b", budget=LAUNCH_BUDGET)
    steps = NEW_TOKENS - 1
    runs, engines, total = {}, {}, dict.fromkeys(ops.KERNELS, 0)
    real_engine = launch_serve.DecodeEngine
    for policy in ("gate", "quest"):
        made = []

        def recording(*a, **kw):
            made.append(real_engine(*a, **kw))
            return made[-1]
        launch_serve.DecodeEngine = recording
        try:
            res, counts, _ = run_counted(launch_serve.main,
                                         LAUNCH_ARGV + ["--policy", policy])
        finally:
            launch_serve.DecodeEngine = real_engine
        want = dict.fromkeys(ops.KERNELS, 0)
        want["block_sparse_decode"] = cfg.num_layers * steps
        if policy == "gate":
            want["gate_select"] = cfg.num_layers * steps
        if counts != want:
            fail(f"launcher --policy {policy}: launch counts {counts}, expected {want}")
        toks = res["tokens"]
        if tuple(toks.shape) != (BATCH, NEW_TOKENS) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab_size:
            fail(f"launcher --policy {policy}: bad tokens {tuple(toks.shape)}")
        print(f"launcher (phase 38) --policy {policy}: prefill {res['prefill_ms']:.1f} ms, "
              f"decode {res['decode_ms'] / steps:.2f} ms/step, {res['tok_per_s']:.1f} tok/s, "
              f"measured sparsity {res['sparsity']:.4f}; launches {counts}; {card_line()}")
        runs[policy], engines[policy] = res, made
        for name, n in counts.items():
            total[name] += n
    if len(engines["gate"]) != 1:
        fail(f"launcher: built {len(engines['gate'])} engines, expected 1")
    eng = engines["gate"][0]
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    mine, theirs = param_leaves(params), param_leaves(eng.params)
    if len(mine) != len(theirs) or not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
        fail("launcher: its parameters are not the seed-0 parameters built here")
    stats = eng.sparsity_stats()
    if not stats["measured"] or stats["sparsity"] != runs["gate"]["sparsity"]:
        fail(f"launcher: printed sparsity {runs['gate']['sparsity']}, its engine measured "
             f"{stats['sparsity']}")
    if not torch.equal(runs["gate"]["tokens"][:, 0], runs["quest"]["tokens"][:, 0]):
        fail("launcher: the gate and Quest runs' prefill tokens differ")
    print(f"launcher: its engine's parameters bitwise the seed-0 ones built here, measured "
          f"sparsity {stats['sparsity']:.4f} as printed, prefill tokens equal across policies; "
          f"phase 38 {time.perf_counter() - t0:.1f} s")
    del eng, engines, params, mine, theirs, runs
    torch.cuda.empty_cache()
    return total


def phase_examples():
    """Phase 39: each example at its own reduced scale (bf16, head dim 16,
    16-token gate blocks), through its entry point, with the launch
    counters at 0 just before and read just after: every kernel it
    reaches launches at least once, and is held against its plain version
    on the tensors of its first call (``check_example_kernels``).
    ``serve_sparse``: generate, ``--paged``, ``--paged --eviction`` at an
    undersized pool (evictions happen), ``--paged --quantize int8``;
    ``serve_stream`` (its default Poisson trace); ``quickstart``
    (QUICKSTART_STEPS); ``distill_and_eval --size small`` (DISTILL_STEPS,
    its checkpoints in a temporary directory, removed after). Returns
    (launch counts, {kernel: [max_abs_err]})."""
    t_all = time.perf_counter()
    total, errs = dict.fromkeys(ops.KERNELS, 0), {}
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_distill_")
    runs = [
        ("serve_sparse", serve_sparse.main, ([],), {}, ("gate_select", "block_sparse_decode")),
        ("serve_sparse --paged", serve_sparse.main, (["--paged"],), {},
         ("gate_select_paged", "block_sparse_decode_paged")),
        ("serve_sparse --paged --eviction", serve_sparse.main,
         (["--paged", "--pool-pages", str(EXAMPLE_EVICT_PAGES), "--eviction"],), {},
         ("gate_select_paged", "block_sparse_decode_paged")),
        ("serve_sparse --paged --quantize int8", serve_sparse.main,
         (["--paged", "--quantize", "int8"],), {},
         ("gate_select_paged", "block_sparse_decode_paged_quant")),
        ("serve_stream", serve_stream.main, (["--quiet"],), {},
         ("gate_select_paged", "block_sparse_decode_paged")),
        ("quickstart", quickstart.quickstart, (),
         dict(pretrain_steps=QUICKSTART_STEPS[0], distill_steps=QUICKSTART_STEPS[1]),
         ("gate_gt_attention", "gate_select", "block_sparse_decode")),
        ("distill_and_eval --size small", distill_and_eval.distill_and_eval, ("small",),
         dict(steps=DISTILL_STEPS, ckpt_dir=ckpt_dir), ("gate_gt_attention",)),
    ]
    try:
        for label, fn, a, kw, reached in runs:
            t0 = time.perf_counter()
            res, counts, seen = run_counted(fn, *a, **kw)
            missing = [k for k in reached if counts[k] < 1]
            if missing:
                fail(f"{label}: no launch of {missing} (counts {counts})")
            if label.endswith("--eviction") and res["stats"]["evictions"] < 1:
                fail(f"{label}: the pool of {EXAMPLE_EVICT_PAGES} pages evicted nothing")
            if "--paged" in label or label == "serve_stream":
                st = res["stats"]
                if st["errors"]:
                    fail(f"{label}: errors {st['errors']}")
            if label == "quickstart" and not all(math.isfinite(x) for x in res["ce"] + res["kl"]):
                fail("quickstart: non-finite loss")
            if label.startswith("distill_and_eval"):
                if not all(math.isfinite(h["kl"]) for h in res["history"]):
                    fail("distill_and_eval: non-finite KL")
                print(f"{label}: recalls by token budget {res['recalls']}")
            t_run = time.perf_counter() - t0
            for name, err in check_example_kernels(label, seen).items():
                errs.setdefault(name, []).append(err)
            print(f"{label} (phase 39): {t_run:.1f} s, launches "
                  + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
            for name, n in counts.items():
                total[name] += n
            del res, seen
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 39: {time.perf_counter() - t_all:.1f} s")
    return total, errs


def sharded_option_requests(vocab):
    """Phase 6's requests with phase 17's overrides: rids 0 and 1 capped
    at OVERRIDE_BUDGET tokens, rids 2 and 3 sampling at OVERRIDE_SAMPLING."""
    reqs = serve_requests(vocab)
    for rid in (0, 1):
        reqs[rid]["budget"] = OVERRIDE_BUDGET
    for rid in (2, 3):
        reqs[rid]["sampling"] = OVERRIDE_SAMPLING
    return reqs


def phase_sharded_options(shard, frontend_stream):
    """Phase 40: the head-sharded engine at full width on the one-rank
    NCCL group with every decode option: the SHARD_SCHEDULE schedule,
    phase 17's budgets and sampling on phase 6's requests. At split_k 1
    the tokens and logits are bitwise the unsharded engine's same run,
    its stats equal; at SPLIT_K the first decode step's logits lie within
    DECODE_ULPS bf16 ulps (phase 11's rule). Each with the launch counters
    at 0 just before and read just after (``stage_counts``). #3 and #4
    (5 at SPLIT_K) on the captured layer-0 call of a selecting layer's
    carried plan and budget caps against their plain versions. Then phase
    29's Poisson trace on the sharded engine through ``ServingFrontend``:
    its stream equals phase 29's unsharded ``frontend_stream``. Returns (launch counts,
    {kernel: [max_abs_err]})."""
    t_all = time.perf_counter()
    cfg = configs.get("qwen3_0_6b").replace(num_layers=DECODE_LAYERS)
    params = init_lm(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    reqs = sharded_option_requests(cfg.vocab_size)
    max_len = max(r["tokens"].size + r["max_new_tokens"] for r in reqs)
    opts = DecodeOptions(schedule=SHARD_SCHEDULE)
    total, errs, res = dict.fromkeys(ops.KERNELS, 0), {}, {}
    for label, o, sh in (("unsharded", opts, None), ("sharded", opts, shard),
                         (f"sharded, split_k {SPLIT_K}", opts.replace(split_k=SPLIT_K), shard)):
        eng = DecodeEngine(cfg, params, max_len=max_len, options=o, shard=sh)
        if sh is not None and o.split_k == 1:
            rank_params(f"phase 40 {label}", cfg, params, eng, sh)
        with (collectives_counted(eng, sh) if sh is not None
              else contextlib.nullcontext((None, None))) as (coll, pre):
            out, counts, seen = run_counted(
                eng.serve, [dict(r) for r in reqs],
                names=EXAMPLE_CALLS + ("paged_sparse_decode_splitk",), n_slots=SERVE_SLOTS,
                collect_logits=True)
        st = out["stats"]
        if sh is not None:
            print_step_collectives(f"phase 40 {label}", coll, pre, st)
        want = stage_counts(o, cfg.num_layers, st["decode_steps"])
        if counts != want:
            fail(f"phase 40 {label}: launch counts {counts}, expected {want}")
        if st["errors"] or st["retired"] != len(reqs):
            fail(f"phase 40 {label}: errors {st['errors']}")
        print(f"phase 40 {label} serve: wall {st['wall_s']:.2f} s, {st['decode_steps']} decode "
              f"steps, sparsity by rid " + ", ".join(f"{k}: {v:.4f}" for k, v in
                                                  st["sparsity_by_rid"].items())
              + f"; sel blocks by rid {st['sel_blocks_by_rid']}; launches {counts}")
        if sh is not None:
            if o.split_k == 1:
                first_ids = seen["paged_sparse_decode"][0][3].cpu()
            for name, n in counts.items():
                total[name] += n
            for name, err in check_example_kernels(f"phase 40 {label}", seen).items():
                errs.setdefault(name, []).append(err)
            if "paged_sparse_decode_splitk" in seen:
                errs.setdefault("block_sparse_decode_paged_splitk", []).append(
                    phase_splitk_kernels(seen, source=f"phase 40 {label}")[
                        "block_sparse_decode_paged_splitk"]["max_abs_err"])
        res[label] = out
        del eng, seen
    base, one, split = res["unsharded"], res["sharded"], res[f"sharded, split_k {SPLIT_K}"]
    for r in reqs:
        rid = r["rid"]
        if one[rid] != base[rid] or not np.array_equal(one["logits"][rid], base["logits"][rid]):
            fail(f"phase 40: the sharded run's rid {rid} is not bitwise the unsharded run's")
    for key in ("decode_steps", "peak_pages_used", "preemptions", "sparsity_by_rid",
                "sel_blocks_by_rid"):
        if one["stats"][key] != base["stats"][key]:
            fail(f"phase 40: sharded {key} {one['stats'][key]} != {base['stats'][key]}")
    # rids 0 and 1 hold slots 0 and 1 at the first decode step: the first
    # selecting layer's lists (the plan the next layers carry) keep their cap
    cap = OVERRIDE_BUDGET // cfg.gate.block_size
    live = (first_ids >= 0).sum(-1)
    if not bool((live[:2] == cap).all()) or not bool((live[2:] > cap).all()):
        fail(f"phase 40: live entries a list at the first selecting layer {live.tolist()}, "
             f"expected {cap} for the capped rids 0 and 1 and more for the others")
    worst = 0.0
    for rid in range(SERVE_SLOTS):                 # admitted at step 0: same step
        worst = max(worst, bf16_ulps(base["logits"][rid][1], split["logits"][rid][1]))
    if worst > DECODE_ULPS:
        fail(f"phase 40: split_k {SPLIT_K}'s first decode step {worst:.2f} bf16 ulps from the "
             f"unsharded run's (limit {DECODE_ULPS})")
    print(f"phase 40: sharded at split_k 1 bitwise the unsharded run (tokens, logits, steps, "
          f"sparsity and selected blocks by rid) under {SHARD_SCHEDULE}, budgets on rids 0, 1 "
          f"and sampling on rids 2, 3; split_k {SPLIT_K} first decode step within {worst:.3f} "
          f"bf16 ulps of max|logit| (limit {DECODE_ULPS})")
    del res, base, one, split
    # open-loop arrivals on the sharded engine: phase 29's trace, against
    # phase 29's stream (``frontend_stream``)
    trace = traffic.poisson_trace(TRAFFIC_N, TRAFFIC_RATE, seed=TRAFFIC_SEED,
                                  prompt_len=TRAFFIC_PROMPT, output_len=TRAFFIC_OUTPUT,
                                  tiers=TRAFFIC_TIERS)
    eng = DecodeEngine(cfg, params, max_len=TRAFFIC_PROMPT[1] + TRAFFIC_OUTPUT[1], shard=shard)
    fe = ServingFrontend(eng, tier_policy=default_tiers(cfg), n_slots=SERVE_SLOTS)
    out, counts, _ = run_counted(fe.run, trace, collect_events=True)
    if out["stats"]["errors"]:
        fail(f"phase 40 frontend: errors {out['stats']['errors']}")
    stream = [(x.rid, x.token, x.index, x.step) for x in out["events"]]
    if stream != frontend_stream:
        fail("phase 40: the sharded frontend's stream differs from phase 29's")
    for name, n in counts.items():
        total[name] += n
    tiers = {t: (row["ttft_steps_p99"], row["tpot_steps_p99"])
             for t, row in out["stats"]["tiers"].items()}
    print(f"phase 40 frontend (sharded): {len(stream)} tokens streamed at phase 29's steps, "
          f"{out['stats']['decode_steps']} steps, wall {out['stats']['wall_s']:.2f} s, TTFT/TPOT "
          f"p99 in steps by tier {tiers}; launches {counts}; phase 40 "
          f"{time.perf_counter() - t_all:.1f} s")
    del eng, fe, out
    del params
    torch.cuda.empty_cache()
    return total, errs


def timed_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def dryrun_cells():
    """Phase 43's cells as ``dryrun.run_cell`` takes them: qwen3_0_6b's
    distill (TRAIN_BATCH x TRAIN_SEQ) and decode (BATCH rows at phase 4's
    context) cells on the local mesh, and one production cell."""
    cfg = configs.get("qwen3_0_6b")
    bs = cfg.gate.block_size
    max_len = -(-(PROMPT_LEN + NEW_TOKENS) // bs) * bs
    return {"distill": (cfg, ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train"), "local"),
            "decode": (cfg, ShapeConfig("decode", max_len, BATCH, "decode"), "local"),
            "production": ("kimi_k2_1t_a32b", "decode_32k", "single")}


def hide_card() -> None:
    """A tracing worker's start: no CUDA device is visible to it."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def trace_dryrun_cells(during):
    """Phase 43's predictions: its cells traced over fake tensors on the
    CPU, one worker process each, while ``during()`` runs (the kernels'
    build, which leaves CPU cores idle); the workers see no card and are
    gone on return. {label: record}."""
    import concurrent.futures
    import multiprocessing
    cells = dryrun_cells()
    with concurrent.futures.ProcessPoolExecutor(
            len(cells), mp_context=multiprocessing.get_context("spawn"),
            initializer=hide_card) as pool:
        futures = {k: pool.submit(dryrun.run_cell, *c, verbose=False) for k, c in cells.items()}
        during()
        return {k: f.result() for k, f in futures.items()}


def phase_dryrun(preds):
    """Phase 43: the dry-run's predictions (``trace_dryrun_cells``) held
    against the card. Returns the launch counters' deltas over the two
    real steps."""
    t_all = time.perf_counter()
    cfg, decode_shape, _ = dryrun_cells()["decode"]
    measured = dryrun_on_card(cfg, decode_shape.seq_len)
    for label, rec in preds.items():
        if not rec["ok"]:
            fail(f"phase 43: the dry-run of the {label} cell failed: {rec['error']}\n"
                 f"{rec['traceback']}")
        print(f"phase 43 {label} cell predicted (fake tensors, {rec['t_trace_s']:.1f} s): "
              f"arguments {rec['argument_size_in_bytes']} B, peak {rec['peak_bytes']} B, "
              f"kernels {rec['kernels']}, flops {rec['flops']:.4e}, bytes {rec['bytes']:.4e}")
    for label in ("distill", "decode"):
        rec, (real_args, counts, peak, busy, wall) = preds[label], measured[label]
        if real_args != rec["argument_size_in_bytes"]:
            fail(f"phase 43 {label}: predicted argument bytes {rec['argument_size_in_bytes']} "
                 f"!= the card's {real_args}")
        want = {**dict.fromkeys(ops.KERNELS, 0), **rec["kernels"]}
        if counts != want:
            fail(f"phase 43 {label}: launches {counts} != the predicted calls {want}")
        line = (f"phase 43 {label}: arguments {real_args} B on the card, predicted "
                f"{rec['argument_size_in_bytes']} (equal); launches equal the predicted calls "
                f"{rec['kernels']}")
        if peak is not None:
            rel = abs(peak - rec["peak_bytes"]) / rec["peak_bytes"]
            line += (f"; peak over the step {peak} B measured (max_memory_allocated less the "
                     f"baseline) against {rec['peak_bytes']} predicted ({100 * rel:.2f}% apart, "
                     f"limit {100 * DRYRUN_PEAK_REL:.0f}%)")
            if rel > DRYRUN_PEAK_REL:
                fail(f"phase 43: the distill step's peak {peak} B is {100 * rel:.2f}% from "
                     f"the predicted {rec['peak_bytes']}")
        print(line)
        terms = {k: rec[f"t_{k}"] for k in ("compute", "memory", "collective")}
        print(f"phase 43 {label}: roofline {1e3 * max(terms.values()):.3f} ms "
              f"({rec['bottleneck']}; computed from the data sheet: compute "
              f"{1e3 * terms['compute']:.3f}, memory {1e3 * terms['memory']:.3f}, collective "
              f"{1e3 * terms['collective']:.3f} ms) | measured device busy {busy:.3f} ms, "
              f"wall {wall:.3f} ms ({card_line()})")
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"phase 43: the card's total_memory {total} B, the dry-run's fits limit "
          f"{dryrun.HBM_BYTES} B ({'equal' if total == dryrun.HBM_BYTES else 'they differ'}; "
          f"{card_line()})")
    print(f"phase 43 production cell: {json.dumps(preds['production'])}")
    print(f"phase 43: {time.perf_counter() - t_all:.1f} s")
    return {name: sum(measured[c][1][name] for c in ("distill", "decode"))
            for name in ops.KERNELS}


def dryrun_on_card(cfg, max_len):
    """Phase 43's two cells for real: {label: (argument bytes, launch
    deltas over the step, the step's peak less the baseline or None,
    device busy ms of a second step, wall ms of the first)}."""
    out = {}
    # the distill cell: its state allocated fresh from a baseline with
    # nothing else of the phase alive
    free_card()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    tcfg = dryrun_specs.default_train_cfg(cfg)
    state = tl.init_train_state(torch.Generator(device="cuda").manual_seed(SEED), cfg, tcfg)
    batch = make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, DataState(SEED, 0), device="cuda")
    real_args = dryrun.storage_bytes((state, batch))
    step = tl.make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = []
    wall = timed_ms(lambda: res.append(step(state, batch)))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    if not math.isfinite(float(res[0][1]["loss"])):
        fail("phase 43: the distill step's loss is not finite")
    del res
    busy = profiled(lambda: step(state, batch))[3]
    out["distill"] = (real_args, counts, peak, busy, wall)

    # the decode cell, on the distill cell's parameters: a zeroed cache at
    # PROMPT_LEN tokens
    params = state.params
    del state, batch, step
    free_card()
    bs = cfg.gate.block_size
    options = dryrun_specs.decode_options(cfg)
    api = get_api(cfg)
    dstate = api.init_decode_state(cfg, BATCH, max_len, None, options, device="cuda")
    dstate.cur_len.fill_(PROMPT_LEN)
    dstate.kg_n.fill_(PROMPT_LEN // bs)
    token = torch.zeros((BATCH,), dtype=torch.int32, device="cuda")
    real_args = dryrun.storage_bytes((params, dstate, token))

    def one_step():
        with torch.no_grad():
            return api.decode_step(params, dstate, token, cfg, options=options)
    ops.reset_launch_counts()
    logits = []
    wall = timed_ms(lambda: logits.append(one_step()[0]))
    counts = ops.launch_counts()
    if not bool(torch.isfinite(logits[0]).all()):
        fail("phase 43: the decode step's logits are not finite")
    busy = profiled(one_step)[3]
    out["decode"] = (real_args, counts, None, busy, wall)
    del params, dstate, token, logits
    free_card()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(card_line())
    dryrun_preds = trace_dryrun_cells(phase_build)
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        shard = nccl_shard(store_dir)
        try:
            return run_phases(shard, dryrun_preds)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def run_phases(shard, dryrun_preds) -> int:
    marks = [("start", time.perf_counter())]

    def mark(label):
        marks.append((label, time.perf_counter()))

    phase_small(shard)
    phase_small_train()
    phase_small_configs()
    phase_small_pretrain()
    mark("2 small agreement")

    full = configs.get("qwen3_0_6b")
    cfg = full.replace(num_layers=DECODE_LAYERS)
    bs = cfg.gate.block_size
    max_len = -(-(PROMPT_LEN + NEW_TOKENS) // bs) * bs
    print(f"qwen3_0_6b: {cfg.num_layers} of {full.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads x {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}; gate block {bs}, d_gate {cfg.gate.d_gate}, "
          f"budget {cfg.gate.token_budget}; batch {BATCH}, prompt {PROMPT_LEN}, "
          f"max_len {max_len} ({max_len // bs} blocks), {NEW_TOKENS} new tokens")
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    print(f"random weights (seed {SEED}): {time.perf_counter() - t0:.1f} s")
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)
    batch = {"tokens": toks}
    eng = DecodeEngine(cfg, params, max_len=max_len)

    seen, state = capture_layer0(eng, batch)
    numbers = phase_kernels(seen)
    numbers.update(phase_quant_kernels(seen))
    del seen, state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mark("3 kernels")

    counts, gate_sparsity = phase_end_to_end(eng, batch, NEW_TOKENS, cfg.num_layers)
    phase_profile(eng, batch)
    del eng
    torch.cuda.empty_cache()
    mark("4-5 generate")

    print(f"serve: {SERVE_SLOTS} slots, (prompt, new tokens) {list(SERVE_SPECS)}, "
          f"prompts from seed {SERVE_SEED}; default pool, then {TIGHT_PAGES} pages")
    serve_counts, seen, *fp_runs = phase_serve(cfg, params)
    numbers.update(phase_paged_kernels(seen))
    del seen
    counts = {**counts, **{k: serve_counts[k] for k in
                           ("gate_select_paged", "block_sparse_decode_paged")}}
    torch.cuda.empty_cache()
    phase_serve_profile(cfg, params)
    mark("6-8 serve")

    print("int8 serve: the same requests and pools, quantize='int8'")
    q8_counts, seen, *q8_runs = phase_serve(cfg, params, DecodeOptions(quantize="int8"))
    check_int8_serve(cfg, fp_runs, q8_runs)
    numbers.update(phase_paged_quant_kernels(seen))
    del seen
    counts["block_sparse_decode_paged_quant"] = q8_counts["block_sparse_decode_paged_quant"]
    torch.cuda.empty_cache()
    phase_serve_profile(cfg, params, DecodeOptions(quantize="int8"), label="int8 serve")
    mark("9 int8 serve")

    print(f"sharded serve: the same requests and pools, split_k={SPLIT_K}, "
          f"one NCCL rank ({shard})")
    sh_counts, seen, *sh_runs = phase_serve(cfg, params, DecodeOptions(split_k=SPLIT_K), shard)
    check_sharded_serve(cfg, fp_runs, sh_runs)
    numbers.update(phase_splitk_kernels(seen))
    gate_tight_stats = fp_runs[1]["stats"]
    sh_ample = sh_runs[0]
    del seen, sh_runs
    torch.cuda.empty_cache()
    phase_serve_profile(cfg, params, DecodeOptions(split_k=SPLIT_K), shard,
                        label=f"sharded serve (split_k {SPLIT_K})")
    print(f"int8 sharded serve: the same requests, default pool, quantize='int8', "
          f"split_k={SPLIT_K}")
    shq_counts, seen, *shq_runs = phase_serve(
        cfg, params, DecodeOptions(quantize="int8", split_k=SPLIT_K), shard, tight_pool=False)
    check_sharded_serve(cfg, q8_runs, shq_runs)
    numbers.update(phase_splitk_kernels(seen))
    q8_ample, shq_ample = q8_runs[0], shq_runs[0]
    del seen, shq_runs, q8_runs
    for name, runs in (("block_sparse_decode_paged_splitk", sh_counts),
                       ("block_sparse_decode_paged_splitk_quant", shq_counts)):
        counts[name] = runs[name]
    # the contiguous int8 kernel lies on no model path
    counts["block_sparse_decode_quant"] = 0
    torch.cuda.empty_cache()
    mark("10-13 sharded serve")

    # the pressure and failure paths: their launches join the counts, the
    # eviction path's kernel errors the kernels' max_abs_err
    more, ev_errs = phase_pressure(cfg, params, shard, fp_runs, q8_ample, sh_ample, shq_ample)
    del fp_runs, q8_ample, sh_ample, shq_ample
    fe_counts, frontend_stream = phase_frontend(cfg, params)
    for c in (more, phase_faults(cfg, params), fe_counts):
        for name, n in c.items():
            counts[name] += n
    for name, more_errs in ev_errs.items():
        numbers[name]["max_abs_err"] = max([numbers[name]["max_abs_err"], *more_errs])
    torch.cuda.empty_cache()
    mark("23-29 pressure, faults, frontend")

    # the rest of the decode API; the errors on its id lists join the
    # kernels' max_abs_err
    errs = {"block_sparse_decode": [phase_quest_generate(cfg, params, batch, max_len,
                                                         gate_sparsity),
                                    phase_policy_generate(cfg, params, batch, max_len)]}
    fp_err, q8_err = phase_quest_serve(cfg, params, gate_tight_stats)
    errs["block_sparse_decode_paged"] = [fp_err, phase_request_overrides(cfg, params)]
    errs["block_sparse_decode_paged_quant"] = [q8_err]
    for name, more in errs.items():
        numbers[name]["max_abs_err"] = max([numbers[name]["max_abs_err"], *more])
    del params
    torch.cuda.empty_cache()
    mark("14-17 decode API")

    counts["gate_gt_attention"], captured = phase_train(full)
    numbers.update(phase_gt_kernel(*captured))
    print(f"kernel 6 at {GT_BLOCK_BIG}-key blocks on the same tensors:")
    more = {"gate_gt_attention": [
        phase_gt_kernel(captured[0], dict(captured[1], block_size=GT_BLOCK_BIG))
        ["gate_gt_attention"]["max_abs_err"]]}
    del captured
    torch.cuda.empty_cache()
    mark("18-20 distill training, kernel 6")

    # the other dense configs: their launches join the counts, their
    # errors the kernels' max_abs_err
    for arch in (*OTHER_CONFIGS, *FAMILY_CONFIGS):
        c, nums = phase_config(arch)
        for name, n in c.items():
            counts[name] += n
        for name, nb in nums.items():
            more.setdefault(name, []).append(nb["max_abs_err"])
    mark("21, 30-32 other configs")
    # the recurrent families: the same
    for arch in RECURRENT_CONFIGS:
        c, nums = phase_recurrent(arch)
        for name, n in c.items():
            counts[name] += n
        for name, nb in nums.items():
            more.setdefault(name, []).append(nb["max_abs_err"])
    mark("33-34 recurrent")
    for arch in OTHER_TRAIN:
        n, nums = phase_config_train(arch)
        counts["gate_gt_attention"] += n
        more["gate_gt_attention"].append(nums["gate_gt_attention"]["max_abs_err"])
    for name, errs in more.items():
        numbers[name]["max_abs_err"] = max([numbers[name]["max_abs_err"], *errs])
    # pretraining: no kernel (plain attention and scans, as in the reference)
    mark("22 other configs' training")
    for arch in PRETRAIN_CONFIGS:
        phase_pretrain(arch)
    mark("35-37 pretraining")
    # the serving launcher, the examples and the sharded engine with every
    # decode option: their launches join the counts, their errors the
    # kernels' max_abs_err
    c38 = phase_launcher()
    c39, e39 = phase_examples()
    c40, e40 = phase_sharded_options(shard, frontend_stream)
    mark("38-40 launcher, examples, sharded options")
    for c in (c38, c39, c40):
        for name, n in c.items():
            counts[name] += n
    for e in (e39, e40):
        for name, errs in e.items():
            numbers[name]["max_abs_err"] = max([numbers[name]["max_abs_err"], *errs])
    # training under the shard: kernel 6 on the rank's heads
    n41, e41 = phase_sharded_train(shard)
    counts["gate_gt_attention"] += n41
    mark("41 sharded training")
    numbers["gate_gt_attention"]["max_abs_err"] = max(
        [numbers["gate_gt_attention"]["max_abs_err"], *e41])
    # the recurrent families and expert parallelism on a sharded engine
    c42, e42 = phase_sharded_families(shard)
    for name, n in c42.items():
        counts[name] += n
    for name, errs in e42.items():
        numbers[name]["max_abs_err"] = max([numbers[name]["max_abs_err"], *errs])
    mark("42 sharded families")
    # the dry-run against the card: its steps' launches join the counts
    for name, n in phase_dryrun(dryrun_preds).items():
        counts[name] += n
    mark("43 dry-run")
    # the data axis: kernel 6 on the data replica's rows
    n44, e44 = phase_data_axis(dryrun_preds)
    counts["gate_gt_attention"] += n44
    numbers["gate_gt_attention"]["max_abs_err"] = max(
        [numbers["gate_gt_attention"]["max_abs_err"], *e44])
    mark("44 data axis")
    # the MoE's expert dispatch: #1, #2 and kernel 6 on its paths
    c45, e45 = phase_moe_dispatch()
    for name, n in c45.items():
        counts[name] += n
    for name, errs in e45.items():
        numbers[name]["max_abs_err"] = max([numbers[name]["max_abs_err"], *errs])
    mark("45 MoE dispatch")
    print("seconds by group of phases: " + ", ".join(
        f"{label} {t - t_prev:.1f}" for (_, t_prev), (label, t) in zip(marks, marks[1:]))
        + f"; run_phases {marks[-1][1] - marks[0][1]:.1f}")

    meta = {
        "gate_select": ("src/repro_torch/kernels/csrc/gate_select.cu",
                        "src/repro/kernels/gate_select.py:133"),
        "block_sparse_decode": ("src/repro_torch/kernels/csrc/block_sparse_decode_sm90.cu",
                                "src/repro/kernels/block_sparse_decode.py:222"),
        "gate_select_paged": ("src/repro_torch/kernels/csrc/gate_select.cu",
                              "src/repro/kernels/gate_select.py:218"),
        "block_sparse_decode_paged": (
            "src/repro_torch/kernels/csrc/block_sparse_decode_sm90.cu",
            "src/repro/kernels/block_sparse_decode.py:285"),
        "block_sparse_decode_quant": ("src/repro_torch/kernels/csrc/block_sparse_decode_sm90.cu",
                                      "src/repro/kernels/block_sparse_decode.py:170"),
        "block_sparse_decode_paged_quant": (
            "src/repro_torch/kernels/csrc/block_sparse_decode_sm90.cu",
            "src/repro/kernels/block_sparse_decode.py:190"),
        "block_sparse_decode_paged_splitk": (
            "src/repro_torch/kernels/csrc/block_sparse_decode_sm90.cu",
            "src/repro/kernels/block_sparse_decode.py:407"),
        "block_sparse_decode_paged_splitk_quant": (
            "src/repro_torch/kernels/csrc/block_sparse_decode_sm90.cu",
            "src/repro/kernels/block_sparse_decode.py:393"),
        "gate_gt_attention": ("src/repro_torch/kernels/csrc/gate_gt_fwd.cu",
                              "src/repro/kernels/gate_gt_fwd.py:87"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[name], **numbers[name])
               for name, (src, rep) in meta.items()]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
