"""Drive the PyTorch port's serving, training and multi-rank training
paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed N] [--calibration-out DIR]
    python3 chip_smoke.py --decode-times ROOT [--seed N]
    python3 chip_smoke.py --step-times ROOT [--seed N]
    python3 chip_smoke.py --searched-only RUNS [--seed N]
                          [--calibration-out DIR]
    python3 chip_smoke.py --pipeline-only [--seed N]
    python3 chip_smoke.py --bert-only [--seed N]
    python3 chip_smoke.py --sync-only RUNS [--seed N]
    python3 chip_smoke.py --serve-only RUNS [--seed N]
    python3 chip_smoke.py --zoo-only [--seed N]
    python3 chip_smoke.py --always-on-only [--seed N]
    python3 chip_smoke.py --obs-only [--seed N]
    python3 chip_smoke.py --frontends-only [--seed N]
    python3 chip_smoke.py --entry-points-only [--seed N]
    python3 chip_smoke.py --zoo-ranks-only [--seed N]
    python3 chip_smoke.py --split-views-only [--seed N]

The second form only times the decode kernels of the checkout at ROOT
(its own ``flexflow_tpu_torch``, built from its own sources) at phase
3's serving shape with phase 3's timer, and prints one JSON line; the
third times phase 6's training step of that checkout, captured and
eager, with the flash kernels' launches per step.  Run either for two
checkouts in one process order (parent, change, change, parent) to
compare two commits on one card.  The fourth builds the kernels and
runs phase 9 alone RUNS times, against phase 6's first step taken
alone; on a machine with four cards it measures the searched path and
the link constants of ``MachineSpec.h100_sxm``.  ``--calibration-out``
keeps each phase 9 run's calibration table.  The fifth builds the
kernels and runs phase 10 alone, against phase 6's first step taken
alone.  The sixth builds the kernels and runs phase 11 alone.  The
seventh builds the kernels and runs phase 12 alone RUNS times, against
phase 6's first step taken alone.  The eighth builds the kernels and
runs phase 13 alone RUNS times.  The ninth runs phase 14 alone (no CUDA
kernel of the port lies on its path, so nothing is built).  The tenth
builds the kernels and runs phase 15 alone, the eleventh phase 16.
The twelfth runs phase 17 alone (nothing on its path launches a CUDA
kernel of the port, so nothing is built), the thirteenth builds the
kernels and runs phase 18 alone, the fourteenth runs phase 19 alone
and the fifteenth phase 20 (no CUDA kernel of the port lies on either
path: nothing is built).

Phases, each of which ends the run with a non-zero exit when it fails:

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them;
2. build: compile every CUDA kernel of both paths from ``csrc/`` with
   nvcc (sm_90a), all sources at once, and print the build seconds;
   then check with ``cuobjdump`` that the bf16 flash kernels (the
   forward ``flash_fwd_tc_kernel``, both values of Partial, and the
   backward pair ``flash_bwd_dq_tc_kernel`` and
   ``flash_bwd_dkv_tc_kernel``, each at both padded head dims D' = 64
   and 128) run their products as HGMMA (tensor-core) instructions and
   spill nothing to local memory, and print their registers; the same
   for the decode kernels at the serving head dim 64
   (``rpa_split_kernel`` on fp32 and bf16 pools,
   ``rpa_quant_split_kernel`` on int8 pools: bound by bytes, so no HGMMA
   is asked of them): no spills, registers and resident blocks per SM
   printed;
3. kernels: call each kernel at its main path's shapes (the decode
   kernel on fp32 and bf16 pools, the int8 decode kernel on the same
   pages quantized, with its drift from the fp32 pool; the three flash
   kernels in bf16, the training path's dtype, and in fp32; the partial
   flash forward at the zigzag ring's half-chunk shape, B 2, Sq = Sk =
   512, H 12, D 64, causal and not, bf16 and fp32) and hold it
   against its plain PyTorch version on the same inputs (the flash
   kernels also at the per-rank shapes of phase 8's legs, causal, bf16
   and fp32: Megatron's B 4, S 1024, H 6 and Ulysses' B 2, S 4096,
   H 3, D 64); time the
   kernel, the plain version and one PyTorch library call that computes
   the same function (a yardstick the port never calls), each with CUDA
   events as the median of 25 runs with the L2 cache flushed before
   each; compute the bound from this run's inputs; hold the flash
   kernels' outputs row by row as well (each row's error over that
   row's largest plain value: the forwards' out and acc, the backward's
   dq, dk and dv); check that two calls of the backward pair at the
   training shape give bit-equal gradients; check that the decode
   kernels (fp32, bf16 and int8 pools) give bit-equal outputs on two
   calls at the serving shape and the same bits for the 1024-token
   sequence alone as in the batch, and hold them against their plain
   versions at lengths on the split edges (0, 1, split - 1, split,
   split + 1, around two splits, the cap - 1 and the cap); sweep each
   kernel over odd shapes (including lengths that cross a 64-row tile
   edge by one) and check that head dims it does not take are refused;
4. serving path: build the repo's GPT decode model at GPT-2-small widths
   (12 layers, hidden 768, 12 heads, vocab 32000, 32 frame slots, pages
   of 16 tokens, 1024-token sequences) with random weights from the
   seed, compile it on the card and serve 48 seeded requests through
   ``ContinuousBatchingExecutor``, each frame a replay of the captured
   frame graph (compiler/graphs.py; warmed up and captured before the
   run), then the same requests again eagerly under ``eager()``; check
   the kernel ran 12 times per frame on both sides (captured: 12 per
   replay x one replay per frame), that both sides give the same
   tokens and the same logits bit for bit (every frame's fingerprint,
   the first 8 frames whole), hold the first 8 frames' logits against
   the same path with the plain attention, and check batched serving is
   token-identical to serving 2 of the requests alone; print both
   sides' frame p50/p99 and tokens/s; then profile 20 steady frames on
   each side (``torch.profiler``): device busy time and idle share,
   kernels per frame, the largest device-time items;
5. serving lane: the same model with int8 KV pools
   (``FFConfig(kv_precision="int8", prefill_chunk=32,
   serve_slo_classes="interactive:1:0,batch:0:0")``), prompts through
   the chunked prefill lane, radix prefix sharing with copy-on-write,
   SLO classes, the event bus and the request tracer armed: 48 batch
   requests at frame 0 (24 behind a shared 256-token system prompt, one
   diverging mid-page, one with a 1-frame deadline) and 4 interactive
   ones at frame 1 that preempt, with frames and chunk passes replaying
   their captured graphs; check every served request's tokens, the
   int8 kernel's 12 launches per frame (12 per replay), a replay per
   chunk pass, the prefill tokens counted from the admissions, the
   preemptions, the expiry, the copy-on-write, the prefix hits, every
   span tree and event, the first 8 frames against the plain attention,
   and 2 sharers served alone; then the same traffic eagerly, checked
   bit for bit against the captured run (tokens, every frame's logits,
   the schedule); print both sides' frame and TTFT times (split into
   queue, prefill and first frame), TPOT, tokens/s and each chunk
   pass's host and device ms; profile 20 frames on each side;
6. training path: free the serving model; build the repo's GPT at its
   full default widths (``build_gpt``: 12 layers, hidden 768, 12 heads,
   ff 3072, vocab 32000, seq 1024) with batch 8, bf16 compute, Adam,
   per-position sparse CCE and accuracy; compare the first batch's loss
   and gradients on the flash route with the ``use_flash=False`` route;
   from the same start weights run 4 steps captured, 4 eagerly and one
   ``train_steps`` call over the 4 batches stacked, and check their
   losses and weights bit-equal; ``fit`` 2 epochs over 20 seeded
   batches (40 steps) captured, with ``trace_steps=4`` and eagerly,
   each from the start weights, and check their step losses and final
   weights bit-equal, that each flash kernel launched 12 times per step
   (captured: 12 per replay of a step, 48 per replay of 4), that every
   step's loss is finite and that the loss on the first batch fell;
   print each fit's tokens/s and MFU (3 x the graph's forward FLOPs
   against the card's dense bf16 peak) and both sides' step time
   p50/p99; profile 3 steady steps on each side;
7. sequence-parallel training path: the same widths at 6 layers, seq
   4096, batch 2,
   split over 4 ranks (``runtime.distributed.spawn``: one card each with
   NCCL on a 4-card machine, else all on card 0 with the shared-card
   transport, gloo with counted host hops; an exclusive compute mode
   fails), every MHA on the zigzag ring; ``fit`` 2 steps (SP_STEPS) and
   check that
   the partial kernel launched 6 x 9 times per step on every rank and
   the flash kernels of phase 6 never, that the loss fell, and that the
   first step's loss equals a one-process run's on the flash route
   (fp32 at 2 layers within 1e-5, bf16 at 6 layers within 5e-3); print
   the transport, step p50/p99, tokens/s, MFU, peak memory and every
   collective's calls, bytes and host hops per rank; profile 1 step on
   rank 0;
8. hybrid-parallel training path, 4 ranks spawned as phase 7's: (a)
   Megatron dp 2 x tp 2 of phase 6's model on phase 6's batches (MHA (2,
   1, 1) r 2 with 6 heads per rank, ff1 (2, 1, 2), ff2 (2, 1, 1) r 2,
   every other op batch-split), ``fit`` 3 steps, then 2 synchronised
   steps and a profile of 1 on rank 0; check rows 1-3 launched 12 times
   per rank per step and row 4 never, every loss finite and falling, the
   first step's loss against one process (fp32 at 2 layers within 1e-5,
   bf16 at full width, phase 6's first step, within 5e-3), and every
   replica of every weight block bit-equal after the last step; print
   the transport, step p50/p99, tokens/s, MFU over the cards used, peak
   memory per rank and every collective's calls, bytes and host hops per
   rank per step; (b) Ulysses at phase 7's shape (sp 4,
   ``sp_mode="ulysses"`` on every MHA, 3 heads per rank) on phase 7's
   batches, ``fit`` 2 steps: rows 1-3 6 launches per rank per step, row
   4 none, all-to-all exchanges, the first step's loss against phase 7's
   one-process bf16 loss within 5e-3;
9. searched training path, 4 ranks spawned as phase 7's: (a) calibrate
   phase 6's model for 4 ranks on the card (``FFConfig(calibrate=True)``
   inside ``search.driver.optimize_strategy``: one forward per (op,
   view) at its per-rank shapes, CUDA events, L2 flushed) and check
   every record finite and positive, the attention probes' launches of
   the flash forward (row 1) and two records measured again (their
   spread printed); (b) the search on ``MachineSpec.h100_sxm(4)`` with
   that table (no deadline, the proposal flags off, the native engines
   required): print the calibration and search seconds apart, the
   one-rank search's seconds, the views per op class and the
   simulator's step (calibrated and roofline) for the searched, the
   data-parallel and phase 8's Megatron strategies, then export the
   strategy; (c) the ranks compile with ``strategy=None`` (rank 0's
   search served by (b)'s cost cache, sent to every rank) and ``fit``
   3 steps: every rank holds (b)'s graph digest and one set of views,
   the first step's loss within 5e-3 of phase 6's, losses finite and
   falling, every weight replica bit-equal, and the attention kernels'
   launches as the views imply (rows 1-3 12 per step; a sequence split
   of degree s on the ring 12 x (2 s + 1) of row 4 instead); then the
   same model under data parallelism and under ``compile(strategy=None)``
   with FFConfig's defaults (the uncalibrated search; its graph digest
   checked against (b)'s roofline search and its first-step loss within
   5e-3 of phase 6's), 2 synchronised steps of each of the three in
   blocks of SEARCH_TIMED_BLOCK (1) in the order A B C C B A: each
   strategy's step p50, its two blocks' p50s and their spread, beside
   its predicted step (on the shared card labelled as the shared-card
   transport); with NCCL the
   link probes (a 4-byte all-reduce's device time per ring hop, 5
   replays; one 128 KB reshard's host time beyond its bytes, median and
   p10-p90 of 200); (d) each rank imports (b)'s exported strategy file
   onto its compiled graph and checks it gives the same views.  Before
   the ranks spawn, the flash kernels are held to their plain versions
   (phase 3's limits) at every per-rank shape the calibration launched
   and the three strategies imply; every launch of the ranks is
   recorded, and a shape beyond that prediction is checked after;
10. pipeline and inter-op placement, 4 ranks spawned as phase 7's:
   phase 6's model on phase 6's batches (a) pipelined,
   ``compile(pipeline=PipelineConfig(2, 4))`` (pp 2 x dp 2, GPipe over
   point-to-point sends), and (b) placed, the embeddings and layers 0-5
   on ranks 0-1 and layers 6-11 and the head on ranks 2-3 (two
   ``start_part`` blocks, each data-parallel): each ``fit`` 3 steps
   with the counts set to 0 just before, then 2 synchronised steps;
   checked: the lowering, the first step's loss within 5e-3 of phase
   6's, losses finite and falling, rows 1-3 launched exactly 24 (a) and
   6 (b) times per rank per step and row 4 never, every weight held by
   some rank and every replica bit-equal; printed: step p50/p99 (the
   slowest rank's), host bytes and collectives per rank per step, peak
   memory per rank; (c) ``compile(strategy=None)`` with FFConfig's
   defaults (both proposal flags on, ``MachineSpec.h100_sxm(4)``, no
   calibration, no deadline) and 2 ``fit`` steps: the lowering and
   graph digest the search gives here in the parent (the CPU tests pin
   the same pick), rows 1-3 12 per step; (d) ``__graft_entry__.py``'s
   search-discovered pipeline leg on ``h100_sxm(4)`` cut to two hosts
   of 2 with 48 MB: it lowers pipelined and its first step's loss is
   within 1e-5 of one process's.  Before the ranks spawn, the flash
   kernels are held to their plain versions at the legs' per-rank
   shapes; a launched shape beyond them is checked after;
11. BERT-base through ``fit``, one card: ``build_bert`` at its
   defaults (vocab 30522, 12 layers, hidden 768, 12 heads, ff 3072,
   seq 512, 2 classes, attention dropout 0.1), batch 8, bf16 compute,
   Adam, seeded weights, random ids and labels.  Rows 1-3 first meet
   their plain versions at the validation passes' shape (B 8, S 512,
   H 12, not causal), and after the phase at any other shape it
   launched them at.  (a) ``fit`` 2 epochs
   of 16 captured steps with ``validation_data`` (2 batches), a
   ``checkpoint_dir`` and a counting callback; rows 1-3 never launch in
   a dropout training step and row 1 runs 12 times per validation
   batch (Sk = 512: the flash route); printed: step p50/p99
   (synchronised captured steps), tokens/s, MFU, peak memory (each
   peak above the allocation before its model was built), the host
   seconds of a checkpoint save and the device ms of one layer's mask
   draw; (b) a fresh model resumes from epoch 1's snapshot: its epoch-2
   losses and weights equal (a)'s bit for bit; (c) remat on against
   off, 4 steps: losses and weights bit-equal, remat's peak memory
   lower; (d) ``grad_accum_steps=2`` against 1, 4 steps: losses within
   bf16 5e-3, its peak memory lower; (e) the captured step against eager with dropout, 4
   steps: bit-equal; two seeds on one batch draw different masks (the
   losses differ), one seed twice the same;
12. gradient sync, 4 ranks spawned as phase 7's: phase 6's model and
   batches under dp 4, each leg a fresh model through ``fit`` with the
   counts set to 0 just before: (a) the monolithic fp32 sum, 2 steps;
   (b) ``zero_dp_shard=True``, 2 steps: its first loss equal to (a)'s,
   its later losses and its weights within SYNC_LOSS_TOL and
   SYNC_WEIGHT_TOL of (a)'s (its gradient is reduce-scattered where
   (a)'s is all-reduced, so the summation order differs), about 1/4 of
   (a)'s optimizer-slot bytes per rank; (c) ``sync_precision="int8"``
   with ``sync_ef="auto"``, 4 steps: every compressed group int8_ef
   with residuals, the first loss within 5e-3 of phase 6's, the loss
   falling, one compressed sum of a real gradient within
   ``allreduce_error_bound`` of the fp32 sum, fewer than half of (a)'s
   bytes, then 2 bf16 steps; (d) ``sync_schedule="search"`` on two
   hosts of two cards: the schedule this process chose on the same spec
   (printed with each bucket's predicted exposed seconds), staged
   plans, the weights against (a)'s as (b)'s; (e) ``compile(strategy=
   None)`` with ``co_search=True``: one search on rank 0, every rank
   the same digest, views and comm plan, 2 steps, the exported
   ``__meta__`` equal to the lowered plan and its views re-imported.
   The searches of (a)-(c) price the link the ranks use (on the shared
   card, SYNC_SHARED_LINK_BW); (e)'s is FFConfig's default,
   ``h100_sxm(4)``.  Every leg: rows 1-3 12 launches
   per rank per step, row 4 none, every loss finite, the same losses on
   every rank, every weight replica bit-equal.  Printed: each leg's
   step, host and wire bytes per rank per step against (a)'s, slot
   bytes and peak memory per rank, and the card;
13. serving over ranks, 4 ranks spawned as phase 7's: phase 4's model
   (full width, 32 frame slots, bf16 compute, seeded weights) serving
   the first 32 of phase 4's seeded requests, one per frame slot, cut
   in depth (``serve_requests``: prompts to 32 tokens, at most 24 new
   tokens, r5 still filling its sequence; on the shared card every
   collective is a host round trip that waits for the card's other
   contexts, so the phase keeps to its time) in four legs, each a
   fresh compile with the counts set to 0 just before the run; prompts
   go through phase 5's chunked prefill (chunks of 32): (a) head split
   4 (the decode ops at replica degree 4, 3 heads per rank; every
   other op whole), bf16 pools; (b) batch split 4 (8 slots per rank,
   each rank holding its slots' quarter of the fp32 pools, every
   rank's block of slots serving live sequences); (c) head split 4 on
   int8 pools through phase 5's lane (also prefix sharing and SLO
   classes); (d) ``compile(strategy=None)`` with ``objective="serve"``,
   ``kv_precision="search"``, ``serve_disaggregation="search"`` and
   ``serve_fleet="search"`` on ``h100_sxm(4)``: one search on rank 0,
   the requests served through what it adopts (a fleet over rank
   blocks, ``runtime/fleet.py``, where it adopts one; disaggregation
   is priced, not executed).  Each leg is held to one process's
   captured run of its configuration: every call of each replica's
   run (chunk passes, page copies, frames) replayed through one
   process, every frame's logits within SERVE_PATH_TOL of the leg's
   on the leg's own tokens; the tokens of every request, except where
   the one-process top-2 logit margin at the first differing token is
   at most that measured difference (printed: requests and tokens
   excused); rows 5 and 6 against their plain versions at every
   per-rank shape the legs run ([32, 3] bf16 and int8, [8, 12] fp32,
   and (d)'s); 12 launches of the leg's kernel per rank per frame and
   none of the other; each rank's pool bytes, read after the run, 1/4
   of one process's (int8 scales replicated over the head split);
   every rank the same tokens; one request record per request; the
   routing the same on every rank and one ``fleet.route`` event per
   request.  Printed: every replica's frame p50/p99, TTFT p50/p99 over
   every request (a fleet's merged records), tokens/s, host bytes per
   rank per frame (``comm_counts()``), pool bytes, live slots per rank
   block;
14. the model zoo, one card, cuDNN deterministic and without its
   autotuner for the phase (put back after), every builder at
   bench_zoo.py's shapes (bench_zoo.py:36-68) with seeded weights, SGD
   at FFConfig's rate, random data: (a) ResNet-50 at its defaults
   (224x224, layers (3, 4, 6, 3), 1000 classes, 25.6 M parameters),
   batch 64, bf16, through ``fit`` 20 steps (5 epochs of 4 batches)
   captured and again eagerly from the same start: losses and weights
   bit-equal, the losses finite and the last epoch's mean below the
   first's, the first step's loss within ZOO_BF16_TOL of the same
   weights' fp32 forward (TF32 off); printed: captured and eager step
   p50/p90 (20 synchronised steps each), images/s, MFU (3 x the ops'
   forward FLOPs against the card's dense bf16 peak), device busy and
   idle share and the top five kernels over 3 profiled steps, peak
   memory above the allocation before the model was built; (b) every
   other builder 3 ``fit`` steps (AlexNet-CIFAR10 64, ResNeXt-50 16,
   Inception-v3 at 299 64, DLRM with 4 tables of 1 M rows 64, XDL,
   CANDLE-Uno, the MLP and the MoE 64, each at its defaults), losses
   finite, step p50 of 3 synchronised steps and samples/s; (c) DLRM
   through ``compile(strategy=None)``, 3 ``fit`` steps: at (b)'s tables
   the search's pick is printed (it keeps the plain lookups there), and
   with tables of ZOO_SMALL_ROWS rows the graph holds the search's
   batched embedding (stack, batched lookup, unstack), whose first loss
   is within ZOO_SEARCHED_TOL of the unrewritten graph's on the same
   weights; (d) ``__graft_entry__.py``'s ep-MoE leg at
   moe.cc's defaults over 4 ranks spawned as phase 7's (the expert dim
   of the dispatch and the expert MLP split 4 ways), fp32, 3 steps: the
   first loss within 1e-5 of one process's, each rank one expert's
   slots, every replica bit-equal.  Rows 1-6 launch no time in the
   phase.  Printed as ``zoo path: {...}``;
15. the always-on loop (``runtime.controller.TrainingController``):
   (a) phase 6's GPT (GPT-2-small widths, seq 1024, batch 8, bf16, SGD)
   on one card through ``TrainingController.run`` for AO_STEPS steps,
   captured, under the seeded plan AO_FAULTS: calibration drift at step
   6 (re-search and hot swap), a collective failure at step 10 past the
   retry budget (the monolithic fp32 fallback, a second swap) and a
   torn newest snapshot at step 16 with saves every AO_CKPT_EVERY steps
   (the restore drill rewinds to the newest complete one and replays);
   then the same run without the torn snapshot: the faulted run's loss
   history, replayed steps included, bit-equal to it; rows 1-3 launch
   12 times per executed step, replays counted (the re-search's
   probes, which the controller's ``research_detail`` counts, apart),
   rows 4-6 none; printed: swap and restore seconds (the controller's
   ``stats``), the allocated memory before and after each swap and at
   the run's end (no swap grows it, nor may a later program past the
   first swap's, by AO_MEMORY_SLACK_GB), the counters; (b) the same widths at AO_LOSS_LAYERS layers over AO_RANKS
   ranks spawned as phase 7's under data parallelism, a device loss of
   2 ranks at step AO_LOSS_AT: the survivors re-search, re-home and take
   the rest of AO_LOSS_STEPS steps, the lost ranks return at the fault
   and exit 0; the survivors' first loss after the shrink within
   AO_SHRINK_TOL of a fresh 2-rank model restored from the snapshot
   saved just before the fault (the same batch and seed); rows 1-3's
   launches per rank, 2 per executed step; (c) the rewrite proofs
   (``analysis.proofgen.verify_registry_generated`` and the hand zoo's
   ``verify_registry``) with the card as the evaluation device, fp32,
   TF32 off: no EQV3xx finding, the same findings and stats as the CPU
   run of the same seed, and the seeded unsound rewrite's EQV301 on
   both with max abs diffs within AO_PROOF_TOL.  Printed as
   ``always-on path: {...}``;
16. the measured side of the loop (obs/, runtime/profiler.py): (a)
   phase 6's GPT (GPT-2-small widths, seq 1024, batch 8, bf16, Adam)
   through ``fit`` with ``profiling``, ``device_trace_dir``,
   ``obs_log_file``, ``obs_trace_file`` and both dot exports, 2 steps
   before the capture, 1 under the profiler that opens no window (its
   warm-up) and 4 captured (``torch.profiler``, CPU and CUDA activity,
   the step a replay of its CUDA graph): the capture holds 4
   ``ff.phase/step`` windows on the device, each with rows 1-3's kernels
   12 times (the counters' 12 per step), rows 4-6 none; the
   ``StepProfiler`` summary, the bus log (every event valid under the
   port's schemas, which equal the reference's and tools/ffobs.py's:
   the CPU tests run ffobs on a port log), the predicted timeline and
   the graphviz files; printed per step window: the device-busy share
   (the union of device operations over the window) and the ten device
   operations that took the most time; then a warm-up frame and
   OBS_FRAMES frames of phase 4's executor (its captured frame) under
   ``device_trace``: 8
   ``ff.phase/decode_frame`` windows, row 5 12 times in each; (b)
   ``MetricsServer`` on a free loopback port, ``/metrics`` scraped once
   with ``urllib`` and its families parsed (``fit``'s among them); (c)
   phase 12's leg (d) (the searched, bucketed, issue-ordered and staged
   schedule at dp 4, ranks spawned as phase 7's) with ``profiling`` and
   ``device_trace_dir``, 1 + 1 + 3 steps, the capture after the first,
   its windows after the profiler's warm-up step: on
   every rank the ``lane_drift_report`` matches every predicted lane,
   3 samples each, every measured sync time above 0, its ``source``
   printed, and the controller's drift watch takes it from the model.
   Printed as ``observability path: {...}``;
17. the frontends, keras and the command line, one card, every leg's
   ``FFConfig`` from ``FFConfig.parse_args`` on a fixed argv (``-b``,
   ``-e``, ``--seed``, ``-ll:tpu 1``, ``--only-data-parallel``; fields
   no flag sets, as the compute dtype, by ``dataclasses.replace``), the
   parsed fields printed: (a) ``FxBert``, a plain-torch module shaped
   like ``transformers.BertModel`` (word, position and token-type
   embeddings, post-LN layers with separate q, k and v Linears,
   non-causal ``scaled_dot_product_attention``, exact GELU; a mean-pool,
   a tanh pooler and a 2-class head) at ``build_bert``'s widths (vocab
   30522, 12 layers, hidden 768, 12 heads, ff 3072, seq 512), batch 8,
   seeded weights, on the card, imported by ``PyTorchModel(module,
   example_inputs=[ids on the card]).torch_to_ff`` (its attention
   decomposed into ``batch_matmul`` and ``softmax``: no MHA op),
   compiled with Adam at bf16 compute, its weights carried by
   ``transfer_torch_weights``; ``predict`` on one batch within
   ZOO_BF16_TOL (of the largest logit) of the module's own fp32
   forward; ``fit`` 20 steps captured (rows 1-6 never launch), 4
   captured steps against 4 eager from one start (bit-equal); printed:
   step p50/p90 (10 synchronised captured steps), tokens/s, MFU (3 x the
   graph's forward FLOPs against the card's dense bf16 peak), peak
   memory, device ms per step by kind of kernel over 3 profiled steps,
   and phase 11's ``build_bert`` step beside it when phase 11 ran; (b)
   ``flexflow_tpu_torch.keras``: the models of
   examples/keras_mnist_mlp.py, keras_cifar10_cnn.py (with
   ``ModelCheckpoint`` and ``EarlyStopping``) and keras_reuters_mlp.py
   at their shapes on the datasets' synthetic fallback (its warnings
   printed), the CNN's last snapshot restored into a fresh keras model
   predicting bit-equal, and the keras MNIST accuracy gate
   (tests/test_accuracy.py:44-66: 1024 rows, Dense 64 relu then Dense
   10, SGD 0.1, batch 64, 8 epochs, fp32) with ``VerifyMetrics`` at
   0.85; (c) examples/onnx_import.py's CNN written by the port's
   ``onnx_minimal`` and imported by ``ONNXModel``: its forward within
   1e-5 (fp32) of an ``F.conv2d``/``F.linear`` composition on the card,
   then 3 ``fit`` steps.  Printed as ``frontends path: {...}``;
18. the repo's entry points on one card (``flexflow_tpu_torch/examples``
   and ``tools``), each example called as a user would, ``main(argv)``
   on a fixed argv, its parsed config and wall time printed: (a)
   ``examples.gpt`` at the reference's TPU widths (vocab 32000, 12
   layers, hidden 768, 12 heads, ff 3072, seq 512; ``-b 8 -e 1``):
   every step's loss, rows 1-3 at exactly 12 launches per step each
   (rows 4-6 none), the step p50/p90 over 5 synchronised captured
   steps, tokens/s, MFU, and one batch's loss on the flash route within
   LOSS_PATH_TOL (bf16) of the plain-attention route of the same model
   from a copy of its weights; (b) ``examples.transformer`` (the
   12-layer encoder, hidden 512, 8 heads, ff 2048, seq 512, not causal)
   the same way, its event bus writing a log (``--obs-log``), but its
   SGD diverges at this size, so only its first EP_STABLE_STEPS losses
   must be finite; its model is built again from the seed and trained
   on the same batches on the plain-attention route at bf16 and on both
   routes at fp32, each route's losses printed, its first
   EP_STABLE_STEPS finite and the first step's loss of the flash route
   within LOSS_PATH_TOL of the plain route's at either precision; (c)
   every other example at its card size on tests/test_examples.py's
   argv with ``-ll:tpu 1 --only-data-parallel`` (its throughput line
   or final loss printed), ``pytorch_bert``, ``tf_keras_import`` and
   ``digits_accuracy`` only where ``transformers.utils.fx`` (HuggingFace's
   fx tracer), TensorFlow and scikit-learn can be imported (else ``not
   run on this host: no <module>``), then ``placed_dlrm`` over 2 ranks and ``ulysses_sp``
   and ``staged_pipeline`` over 4 (spawned by ``main``, sharing the
   card as phases 7-10 do; the placed and staged lowerings checked);
   (d) the port's tools with no JAX on the host: ``ffobs report``,
   ``validate`` (exit 0), ``metrics`` and ``trace`` on (b)'s log,
   ``fflint registry --devices 4`` (the proofs on the card) and
   ``fflint cache COST_CACHE.json`` (exit 0), ``mfu_probe`` and each
   ``mfu_variants`` variant (only ``flash`` launches rows 1-3), their
   times printed; then rows 1-3 against their plain versions, as phase
   3 checks them, at every shape the phase launched them at in this
   process (EP_FLASH_SHAPES at least).  Printed as ``entry points
   path: {...}``;
19. the zoo over ranks: ZR_RANKS ranks spawned once for every leg
   (sharing the card, as phases 7-10 do; NCCL on a machine with a card
   per rank).  (a) ResNet-50, Inception-v3, DLRM (4 tables of 1 M
   rows), the MoE and candle_uno at bench_zoo.py's shapes (batch 64,
   bf16) under ``compile(strategy=None)`` on ``MachineSpec.h100_sxm(4)``
   (rank 0 searches and sends every rank its pick; the pipeline and
   placement proposals off: the flat pick), (b) ResNet-50 at batch 8,
   224x224, with the stem and its first stage (``conv1``, ``bn1``,
   ``pool1``, ``s0b*``) split (1, 2, 2, 1) over H and W and the rest
   (4, 1, 1, 1): the halo exchange of ops/conv.py.  For each leg: the
   pick's views counted by kind, ZR_STEPS ``fit`` steps, the first
   step's loss within ZR_LOSS_TOL (bf16) of one process's first step
   of the same model from the same seeded weights, every weight a rank
   holds whole bit-equal across ranks (digests), the step's p50 over
   the last ZR_STEPS - 1 steps (each step one synchronised ``fit``
   call; the first warms up) against data parallelism's p50 over
   ZR_DP_STEPS calls after the pick's (the pick's own when it is data
   parallelism), beside the simulator's prediction of both, the
   transport, ``comm_counts()`` bytes per rank per step and peak memory
   per rank; on (b) also the halo bytes per rank per step equal to the
   halo slabs the shapes imply and the whole-gather bytes they replace,
   both computed from the shapes.  (c) The halo's contents on the
   transport: the stem's conv and max pool alone (ZR_HALO_CASES, split
   (1, 2, 2, 1), fp32, TF32 off) against the unsplit op on the same
   tensors, the output and the input's and kernel's gradients within
   ZR_HALO_TOL, the halo bytes exact.  Each rank zeroes the launch
   counts of rows 1-6 before its legs and returns them after: none
   launches, on any rank or in the one-process side.  Printed as
   ``zoo over ranks path: {...}``;
20. the split views over ranks: SV_RANKS ranks spawned once (as phase
   19's).  (a) ResNeXt-50 32x4d (``build_resnext50`` at its defaults,
   bench_zoo.py's batch 16, 224x224, 1000 classes, bf16) under its
   ``compile(strategy=None)`` pick on ``h100_sxm(4)``, as a phase 19
   leg: SV_STEPS ``fit`` steps of the pick and SV_DP_STEPS of dp 4, the
   grouped convs' views counted by kind, the step p50s beside the
   simulator's prediction of each, ``comm_counts()`` calls and bytes
   per rank per step, peak memory per rank; (b) the same model with
   every grouped conv at each SV_OUT_VIEWS view (an out-channel split,
   alone and with a batch split) and every other op at dp 4's,
   SV_OUT_STEPS steps each; (c) the keras-style MNIST MLP (SV_MLP, the
   head ``dense(10, activation="softmax")``, batch 64, fp32) under its
   ``h100_sxm(4)`` pick, which must split the head's out dim, 2 steps;
   (d) a depthwise conv (SV_DEPTHWISE, fp32) split by out channel
   against the unsplit op on each rank: output, input gradient and the
   rank's block of the kernel gradient within SV_DEPTHWISE_TOL.  The
   first loss of (a) and (b) within ZR_LOSS_TOL (bf16) of one process's
   first step of the same model from the same seeded weights, (c)'s
   within SV_MLP_TOL (fp32); every weight a rank holds whole bit-equal
   across ranks; rows 1-6 launch on no rank and not in the one-process
   side.  Printed as ``split views path: {...}``;
21. print one JSON line listing every ported kernel.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script imports torch and the port, never JAX or the JAX package.
It needs one card; with four it runs phases 7-10, 12, 13, 14's
ep-MoE leg, 15's device-loss leg, 16 (c), 19 and 20 one rank per card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# GPT-2-small widths with the repo's vocab, post-LN/ReLU blocks: the
# defaults of build_gpt (models/transformer.py), served through its
# decode twin
FULL = dict(vocab=32000, num_layers=12, hidden=768, num_heads=12,
            ff_dim=3072, page_size=16, pages_per_seq=64)
FRAME_SLOTS = 32
MAX_SEQ = FULL["page_size"] * FULL["pages_per_seq"]  # 1024

KERNEL_TOL = 1e-4  # fp32 math in both; only the summation order differs
# the reference's int8 accuracy contract (tests/test_kv.py:292): decode
# attention over the int8 pool against the fp32 pool on the same pages
INT8_DRIFT_TOL = 0.05
PATH_TOL = 5e-2  # bf16 compute: a bf16 rounding of the attention output
N_REQUESTS = 48
# the int8 serving lane (phase 5): 48 batch requests at frame 0, the
# first 24 behind a shared 256-token system prompt, one of them
# diverging mid-page from the first (a copy-on-write), one with a
# 1-frame deadline; 4 interactive requests at frame 1, which preempt
LANE_SLO_CLASSES = "interactive:1:0,batch:0:0"
LANE_CHUNK = 32
LANE_SYS_TOKENS = 256
LANE_SHARERS = 24
LANE_BATCH = 48
LANE_INTERACTIVE = 4
LANE_COW = 7  # shares the first sharer's 17th page for 8 tokens
LANE_COW_TOKENS = 8
LANE_EXPIRING = 40
LANE_PROFILE_WARM = 40
PARITY_FRAMES = 8
TIMING_RUNS = 25
# about 0.1 ms of device spin before each timed run (time_ms): longer
# than a slow host's dispatch of one wrapper call, which otherwise lands
# in the window of a kernel as short as the decode pair's
SPIN_CYCLES = 200_000
PROFILE_WARM_FRAMES = 300  # past the first admissions: slots full
PROFILE_FRAMES = 20

# the training path: build_gpt at its defaults (models/transformer.py),
# batch 8; token ids drawn from the first TOKEN_RANGE ids of the vocab,
# so that a few dozen steps visibly lower the loss
TRAIN = dict(vocab=32000, num_layers=12, hidden=768, num_heads=12,
             ff_dim=3072, seq_len=1024)
TRAIN_BATCH = 8
TRAIN_BATCHES = 20
TRAIN_EPOCHS = 2
TOKEN_RANGE = 512
ADAM_ALPHA = 3e-4
TIMED_STEPS = 10
TRACE_STEPS = 4  # fit(trace_steps=4) against fit(trace_steps=1)
PROFILE_STEPS = 3
# (Sq, Sk) pairs that cross a 64-row tile edge by one, in both sweeps
TILE_EDGE_PAIRS = ((63, 65), (65, 63), (64, 64), (128, 129), (129, 128))
# flash kernels vs their plain versions, max abs error over
# max(1, max |plain|): fp32 math in both, the order of the sums differs;
# in bf16 the kernel rounds p to bf16 relative to its running row max,
# the plain version relative to the final row max, and bf16 outputs
# round once more (2^-8 relative)
FLASH_TOL = {"fp32": 1e-4, "bf16": 2e-2}
# the forward's out and the partial forward's acc row by row: each row's
# max abs error over that row's max |plain|, so that rows deep in a
# causal sequence (|out| ~ 0.06 at the training shape) are held as
# tightly as the first ones (|out| up to ~4).  bf16: one bf16 ulp of a
# row's largest value is 2^-8 to 2^-7 of it, and the two sides round
# their fp32 outs independently; worst readings on an H100 over seeds 0
# and 1, main shapes and sweeps: out 9.7e-3, acc 6.0e-3 (PERF.md
# section 6), so the limit is two ulps, 1.65x the worst.  fp32: worst
# 3.2e-6, the limit FLASH_TOL's
ROW_TOL = {"fp32": 1e-4, "bf16": 1.6e-2}
# the bf16 backward kernels' dq, dk and dv row by row, so that small
# gradient rows (late keys under a causal mask, deep query rows) are held
# as tightly as the largest: each row's max abs error over the larger of
# its max |plain| and GRAD_ROW_FLOOR (``row_err``).  The floor: the
# operands are unit normals and the gradients of order 1; a row that is
# exactly zero in exact arithmetic (a query row with one live key, such
# as the first causal row, or every row when Sk = 1: a softmax over one
# key has no gradient) holds only the fp32 rounding of dp - delta on
# both sides, up to about 5e-6 on an H100, while the smallest rows that
# are not (the last keys' dk and dv at the training shape, about 3e-4 of
# the largest, 1.3e-3) lie above 2^-10.  The limit: both sides round ds
# to bf16 before ds k and ds^T q, and where their fp32 ds differ in the
# last bits (other summation orders of dp) a value can round the other
# way, one bf16 ulp of that term; then each output rounds once.  Worst
# readings on an H100 over seeds 0 and 1, training shape and sweep
# (PERF.md section 6): dq 7.8e-3, dk 1.47e-2 (its rows sum up to 1000
# such terms), dv 7.6e-3; so 2^-5, 2.1x the worst.  fp32 (the scalar
# kernels) is printed, not held: its dq and dk rows of exact zeros carry
# the same rounding noise (up to 2.7e-2 of the floor) against a plain
# fp32 reference
GRAD_ROW_FLOOR = 2.0 ** -10
BWD_ROW_TOL = {"bf16": 2.0 ** -5}
# the flash route vs the use_flash=False route on the training path's
# first batch: loss relative error, and per weight the gradient's error
# norm over the use_flash=False gradient's norm.  fp32 compute: the
# same function, summation order only; but in this post-LN stack at a
# random init the gradients shrink toward the first layers while the
# rounding noise each layer adds does not, so the relative error grows
# with depth (1.4e-3 at layer 0, against round-off at the top).  bf16
# compute: the two routes round p to bf16 at different points (flash:
# unnormalised, before p.v; attn_core: the normalised probs, which its
# backward reuses), and the q/k gradients pass through
# ds = p (dp - delta), a difference of close numbers at a random init's
# near-uniform attention, which magnifies those roundings most in the
# first layer's wq/wk
LOSS_PATH_TOL = {"bf16": 1e-3, "fp32": 1e-5}
GRAD_PATH_TOL = {"bf16": 0.1, "fp32": 1e-2}

# the sequence-parallel path: build_gpt at its default widths, cut to 6
# layers to keep the script inside its time limit, with seq 4096 and
# batch 2 (the 8192 tokens a step of phase 6 trains) split over
# SP_RANKS ranks (the sp degree of __graft_entry__.py:152-155);
# every MHA runs the zigzag ring, whose blocks are half chunks of
# 4096 / (2 x 4) = 512 positions, 2n + 1 = 9 partial-kernel calls per
# layer and step
SP = dict(vocab=32000, num_layers=6, hidden=768, num_heads=12,
          ff_dim=3072, seq_len=4096)
SP_BATCH = 2
SP_RANKS = 4
SP_HALF_CHUNK = SP["seq_len"] // (2 * SP_RANKS)
SP_STEPS = 2  # kept short: the whole script stays inside its time limit
SP_TIMED_STEPS = 1  # kept short, as SP_STEPS
SP_PROFILE_STEPS = 1
SP_PARITY_LAYERS = 2
SP_TIMEOUT_S = 600
# the first step's loss, the SP ring against one process on the flash
# route, same weights and batch: fp32 at SP_PARITY_LAYERS layers differs
# in summation order only; bf16 at full width also rounds p to bf16 at
# other points (the ring: unnormalised blocks merged in fp32; the flash
# kernel: one normalised output) in each of 12 layers
SP_LOSS_TOL = {"fp32": 1e-5, "bf16": 5e-3}
# the hybrid-parallel path (phase 8): Megatron dp 2 x tp 2 of phase 6's
# model, seq 1024 and batch 8 (phase 6's tokens per step) over HYB_RANKS
# ranks: MHA (2, 1, 1) r 2 (6 heads per rank), ff1 (2, 1, 2), ff2 (2, 1,
# 1) r 2, every other op batch-split 2 ways; then Ulysses at phase 7's
# shape (seq 4096, batch 2, sp 4, 3 heads per rank).  First-step losses
# against one process with phase 7's tolerances
HYB_RANKS = 4
HYB_STEPS = 3  # kept short, as SP_STEPS
HYB_TIMED_STEPS = 2
HYB_PROFILE_STEPS = 1
HYB_PARITY_LAYERS = 2
ULYSSES_STEPS = 2
# the per-rank attention shapes of phase 8's legs, (leg, B, S, H) at D
# 64: Megatron's local batch and heads at phase 6's sequence, Ulysses'
# whole sequence at H / sp heads
HYB_FLASH_SHAPES = (
    ("megatron", TRAIN_BATCH // 2, TRAIN["seq_len"], TRAIN["num_heads"] // 2),
    ("ulysses", SP_BATCH, SP["seq_len"], SP["num_heads"] // HYB_RANKS))

# phase 9, the searched path: phase 6's model and batches over 4 ranks,
# the strategy chosen by compile(strategy=None)
SEARCH_RANKS = 4
SEARCH_STEPS = 3  # fit steps under the searched strategy
# then 2 synchronised steps per strategy (searched, data parallel and
# the uncalibrated default search's pick) in two blocks of
# SEARCH_TIMED_BLOCK, in the order A B C C B A: each strategy is timed
# early and late, and its two blocks give the spread of one strategy
SEARCH_TIMED_BLOCK = 1  # kept short, as SP_STEPS
CAL_BUDGET_S = 60.0  # FFConfig.calibration_budget_s's default
CAL_REPROBES = 2  # records measured again for their spread
LINK_PROBE_RUNS = 200  # calls timed by each link probe (NCCL only)
LINK_PROBE_REPEATS = 5  # replays of the captured all-reduces, each timed
RESHARD_PROBE_SHAPE = (8, 8, 512)  # a 128 KB fp32 activation
SEARCH_TIMEOUT_S = 1200

# published peaks (NVIDIA data sheets): device-memory bytes/s, dense
# fp32 (non-tensor-core) operations/s and dense bf16 tensor-core
# operations/s, by card
# phase 10, pipeline and inter-op placement: phase 6's model and
# batches over PIPE_RANKS ranks, pipelined (pp PIPE_STAGES x dp 2,
# PIPE_MICRO microbatches), placed (embeddings and layers 0-5 on the
# first half of the ranks, the rest on the second), and as
# compile(strategy=None) picks with FFConfig's defaults
PIPE_RANKS = 4
PIPE_STAGES = 2
PIPE_MICRO = 4
PIPE_LAYERS_A = 6
PIPE_STEPS = 3  # kept short, as SP_STEPS
PIPE_TIMED_STEPS = 2
PIPE_DEFAULT_STEPS = 2
# phase 11: build_bert at its defaults, the OSDI'22 BERT configuration
BERT = dict(vocab=30522, num_layers=12, hidden=768, num_heads=12,
            ff_dim=3072, seq_len=512, num_classes=2, dropout=0.1)
BERT_BATCH = 8
BERT_BATCHES = 16  # steps per epoch
BERT_EPOCHS = 2
BERT_VAL_BATCHES = 2
BERT_CMP_STEPS = 4  # remat, accumulation and capture comparisons
BERT_TIMED_STEPS = 10
BERT_GA_TOL = 5e-3  # bf16 compute, relative loss
# phase 12, gradient sync: phase 6's model and batches under dp 4, legs
# (a) the monolithic fp32 sum, (b) ZeRO-1, (c) int8 with error feedback
# and a short bf16 leg, (d) the searched, bucketed and staged schedule
# on two hosts of two ranks, (e) the co-search
SYNC_RANKS = 4
SYNC_STEPS = 2  # fit steps per leg, kept short as SP_STEPS
SYNC_INT8_STEPS = 4  # enough for the loss to fall
SYNC_BF16_STEPS = 2
# the link the legs' searches price on the shared card: gloo through
# host copies runs at a few GB/s per rank (phase 8's Megatron step moved
# 0.974 GB each way per rank in about 1.2 s), not NVLink's 450 GB/s
SYNC_SHARED_LINK_BW = 2e9
# weights of a leg against leg (a): their fp32 gradient sums order the 4
# ranks' shares otherwise (a reduce-scatter, a bucket or a staged plan
# against gloo's or NCCL's all-reduce), so a sum may differ in its last
# place; an Adam update is about lr in size whatever the gradient's, so
# an element whose summed gradient is within that rounding of zero can
# flip its update: up to 2 lr per step
SYNC_WEIGHT_TOL = 2 * ADAM_ALPHA * SYNC_STEPS
SYNC_LOSS_TOL = 1e-4  # relative, the later steps' losses against (a)
# phase 13, serving over ranks: phase 4's model and requests over
# SERVE_RANKS ranks, four legs (serve_legs)
SERVE_RANKS = 4
# the first of phase 4's requests, one per frame slot, so that every
# rank's block of slots serves live sequences under a batch split; each
# cut in depth to keep the phase inside the time limit (on the shared
# card every collective is a host round trip): prompts to their first
# SERVE_PROMPT_TOKENS tokens, at most SERVE_NEW_TOKENS tokens each, and
# r5 still fills its sequence (its prompt repeated to the rest)
SERVE_REQUESTS = FRAME_SLOTS
SERVE_PROMPT_TOKENS = 32  # one chunk pass (LANE_CHUNK) each
SERVE_NEW_TOKENS = 16
# logits of every frame of a leg against one process's on the same calls:
# bf16 compute over ranks sums in another order (the first 8 frames
# measured 5.0e-3 to 6.0e-3 on an H100 over 4 ranks, one card or four)
SERVE_PATH_TOL = 2e-2
# phase 14: the model zoo at bench_zoo.py's shapes (bench_zoo.py:36-68)
ZOO_RESNET_BATCH = 64
ZOO_RESNET_STEPS = 20  # through fit, captured; and again eagerly
ZOO_DATA_BATCHES = 4  # the batches fit cycles over (5 epochs of 4)
ZOO_PROFILE_STEPS = 3
ZOO_LR = 0.01  # SGD, FFConfig.learning_rate's default
ZOO_FIT_STEPS = 3
ZOO_TIMED = 3
ZOO_ID_RANGE = 1000  # ids below every table's rows
ZOO_OTHERS = {  # key -> (builder, batch)
    "alexnet_cifar10": ("build_alexnet_cifar10", 64),
    "resnext50": ("build_resnext50", 16),
    "inception_v3": ("build_inception_v3", 64),
    "dlrm": ("build_dlrm", 64),
    "xdl": ("build_xdl", 64),
    "candle_uno": ("build_candle_uno", 64),
    "mlp": ("build_mlp_unify", 64),
    "moe": ("build_moe", 64),
}
# builders' widths other than their defaults: DLRM's 4 tables of 1 M
# rows (bench_zoo.py's cut of the reference's 8)
ZOO_WIDTHS = {"build_dlrm": dict(embedding_sizes=(1000000,) * 4)}
# the first bf16 step's loss against the same weights' fp32 forward
# (TF32 off): bf16 products through 53 convs and their batch norms
ZOO_BF16_TOL = 2e-2
# the searched DLRM's first loss against the unrewritten graph's on the
# same weights: the same bf16 products, the gathers exact
ZOO_SEARCHED_TOL = 1e-5
ZOO_SMALL_ROWS = 1000  # tables the search batches on h100_sxm(1)
# device time of a ResNet-50 step by kind of kernel (name fragments)
ZOO_KERNEL_GROUPS = {
    "conv (cuDNN, cuBLAS)": ("cudnn", "conv", "xmma", "sm90_", "sm80_",
                             "gemm", "cutlass", "implicit"),
    "pool": ("pool",),
    "reduction (batch norm, loss)": ("reduce_kernel", "Reduce", "norm"),
    "elementwise and casts": ("elementwise", "copy", "fill", "Memset",
                              "Memcpy"),
    "index and scatter": ("index", "scatter", "gather"),
}
ZOO_EP_RANKS = 4
ZOO_EP_BATCH = 64
ZOO_EP_TOL = 1e-5  # fp32, TF32 off: the CPU tests' bound
# phase 19, the zoo over ranks: (leg, builder, batch, widths)
ZR_RANKS = 4
ZR_LEGS = (
    ("resnet50", "build_resnet", 64, {}),
    ("inception_v3", "build_inception_v3", 64, {}),
    ("dlrm", "build_dlrm", 64, {"embedding_sizes": (1000000,) * 4}),
    ("moe", "build_moe", 64, {}),
    ("candle_uno", "build_candle_uno", 64, {}),
)
# the attribute-parallel leg: these ops split (1, 2, 2, 1) over H and W
ZR_ATTR = ("resnet50_attribute", "build_resnet", 8, {})
ZR_ATTR_OPS = ("conv1", "bn1", "pool1")
ZR_ATTR_PREFIX = "s0b"  # the first stage's blocks
# one fit call each: the first warms up, the rest are timed (3 to leave
# phase 20 its time in the script's limit)
ZR_STEPS = 3
# dp 4's calls follow the pick's in the same ranks, which warmed the
# shared card's cuDNN and allocator: p50 of all of them (2; a slower
# first call, as NCCL's first collectives of a new model make it, then
# weighs half)
ZR_DP_STEPS = 2
# the batches each leg's data holds, whatever the calls: ``zoo_data``
# draws the labels after every input, so the first batch, on which the
# first loss is held to one process's, keeps its labels
ZR_DATA_BATCHES = 4
ZR_DTYPE = "bfloat16"
ZR_LOSS_TOL = 5e-3  # bf16, relative: phase 7's SP_LOSS_TOL["bf16"]
# the halo's contents on the card: the stem's conv and max pool of the
# attribute leg at its batch, split (1, 2, 2, 1), fp32 with TF32 off,
# against the unsplit op: (op, kind, input (H, W), channels, window)
ZR_HALO_CASES = (
    ("conv1", "conv", (224, 224), 3, dict(out=64, k=7, s=2, p=3)),
    ("pool1", "max", (112, 112), 64, dict(k=3, s=2, p=1)),
)
ZR_HALO_TOL = 1e-5  # the CPU tests' (zr_halo_check says of what)
# phase 20, the split views over ranks: (a) ResNeXt-50 32x4d under its
# h100_sxm(4) pick, (b) its grouped convs under out-channel splits, (c)
# the keras-style MNIST MLP whose pick splits the softmax head, (d) a
# depthwise conv split by out channel
SV_RANKS = 4
SV_RESNEXT = ("resnext50", "build_resnext50", 16, {})  # bench_zoo.py's
SV_STEPS, SV_DP_STEPS = 4, 3  # (a)'s fit calls of the pick and of dp 4
SV_OUT_VIEWS = ((1, 1, 1, 4), (2, 1, 1, 2))  # (b): every grouped conv
SV_OUT_WIDTHS = {}  # (b)'s depth: build_resnext50's (3, 4, 6, 3) blocks
SV_OUT_STEPS = 2
SV_MLP = (784, 512, 512, 10)
SV_MLP_BATCH = 64
SV_MLP_TOL = 1e-5  # fp32, TF32 off, relative
# (d): [batch, H, W, channels] through a 3x3 depthwise conv, out split
SV_DEPTHWISE = ((8, 56, 56, 128), (1, 1, 1, 4))
SV_DEPTHWISE_TOL = 1e-5  # phase 19 (c)'s |d| / (1 + |want|)
# phase 17: the frontends; FxBert at build_bert's widths (BERT above)
FX_BERT = dict(vocab=30522, num_layers=12, hidden=768, num_heads=12,
               ff_dim=3072, seq_len=512)
FX_BATCH = 8
FX_STEPS = 20  # fit, captured
FX_CMP_STEPS = 4  # captured against eager
FX_TIMED_STEPS = 10
FX_PROFILE_STEPS = 3
FX_REUTERS_WORDS = 2000  # examples/keras_reuters_mlp.py's NUM_WORDS
FX_GATE_ACCURACY = 0.85  # tests/test_accuracy.py's keras MNIST gate
FX_ONNX_STEPS = 3
FX_LR_ROWS, FX_LR_BATCH = 512, 64  # the keras lr schedule's 2 epochs
FX_ONNX_TOL = 1e-5  # fp32, TF32 off
# device time of an imported BERT step by kind of kernel (name fragments,
# the first match wins; the port's layer norm is reductions and
# elementwise passes, Adam's update multi-tensor kernels)
FX_KERNEL_GROUPS = {
    "matmul (cuBLAS)": ("gemm", "nvjet", "cutlass", "xmma", "sm90_",
                        "sm80_", "cublas"),
    "softmax": ("softmax", "SoftMax"),
    "embedding, index and scatter": ("embedding", "index", "scatter",
                                     "gather"),
    "optimizer (multi-tensor)": ("multi_tensor_apply",),
    "reduction (mean, norm, loss)": ("reduce_kernel", "Reduce"),
    "elementwise and casts": ("elementwise", "copy", "fill", "Memset",
                              "Memcpy"),
}
# phase 18: the repo's entry points (flexflow_tpu_torch/examples, tools)
EP_TRAIN_ARGV = ("-b", "8", "-e", "1")  # gpt and transformer, full width
EP_FLASH_LAYERS = 12  # rows 1-3 launch this many times per step in both
EP_FLASH_ROWS = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
# rows 1-3's shapes in phase 18, (kind, B, Sq, Sk, H, causal) at D 64:
# gpt's, the transformer's and mfu_variants' flash variant's
EP_FLASH_SHAPES = (("full", 8, 512, 512, 12, True),
                   ("full", 8, 512, 512, 8, False),
                   ("full", 64, 256, 256, 8, False))
EP_TIMED_STEPS = 5
# (b)'s example diverges at this size: its SGD (lr 0.01) on MSE against
# unit-normal targets through 12 layers without layer norm.  Its first
# EP_STABLE_STEPS steps come before the blow-up and must be finite on
# every route; the later ones are printed.  The routes trained from the
# example's weights beside it: (name, compute dtype, use_flash)
EP_STABLE_STEPS = 3
EP_ROUTES = (("bf16_plain", "bfloat16", False),
             ("fp32_flash", "float32", True),
             ("fp32_plain", "float32", False))
EP_SINGLE = (  # tests/test_examples.py's argv (-b 8 for inception)
    ("alexnet", ("-b", "8", "-e", "1")),
    ("resnet", ("-b", "4", "-e", "1")),
    ("inception", ("-b", "8", "-e", "1")),
    ("dlrm", ("-b", "8", "-e", "1")),
    ("xdl", ("-b", "8", "-e", "1")),
    ("candle_uno", ("-b", "8", "-e", "1")),
    ("mlp_unify", ("-b", "16", "-e", "1")),
    ("moe", ("-b", "8", "-e", "1")),
    ("keras_mnist_mlp", ("-b", "16", "-e", "1")),
    ("keras_cifar10_cnn", ("-b", "16", "-e", "1")),
    ("keras_reuters_mlp", ("-b", "16", "-e", "1")),
    ("pytorch_import", ("-b", "8", "-e", "1")),
    ("onnx_import", ("-b", "16", "-e", "1")),
)
EP_OPTIONAL = (  # (example, the module it needs, argv)
    ("pytorch_bert", "transformers.utils.fx", ("-b", "8", "-e", "1")),
    ("tf_keras_import", "tensorflow", ("-b", "8", "-e", "1")),
    ("digits_accuracy", "sklearn", ("-b", "32", "-e", "12")),
)
EP_MULTI = (  # (example, argv, the lowering it must pick)
    ("placed_dlrm", ("-b", "32", "-e", "1", "-ll:tpu", "2"),
     "PlacedCompiledModel"),
    ("ulysses_sp", ("-b", "8", "-e", "1", "-ll:tpu", "4"), None),
    ("staged_pipeline", ("-b", "16", "-e", "1", "-ll:tpu", "4"),
     "StagedPipelinedModel"),
)
# phase 15: the always-on loop
OBS_WARM_STEPS = 2  # phase 16 (a): steps before the capture
OBS_PROFILER_WARM = 1  # the step under the profiler that opens no window
OBS_CAPTURED_STEPS = 4
OBS_FRAMES = 8
OBS_SYNC_STEPS = 3  # phase 16 (c): captured steps after the first
AO_STEPS = 24
AO_BATCHES = 8  # the distinct batches the controller cycles over
AO_FAULTS = ("calibration_drift@6,collective_failure@10:99,"
             "corrupt_checkpoint@16")
AO_CLEAN = "calibration_drift@6,collective_failure@10:99"
AO_CKPT_EVERY = 4
AO_RANKS = 4
AO_LOSS_LAYERS = 2
AO_LOSS_STEPS = 8
AO_LOSS_AT = 4
AO_SHRINK_TOL = 5e-3  # bf16 compute, relative
AO_PROOF_TOL = 1e-3  # the messages carry 4 significant digits
# below one stream's cuBLAS workspaces (2 x 32 MiB = 0.067 GB), so a
# program that leaves its capture stream's workspaces behind shows
AO_MEMORY_SLACK_GB = 0.03
# the restore drill's warning, the one phase 15 (a) expects
AO_TORN_WARNING = r"checkpoint step\(s\) .* are truncated"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_peaks(name: str):
    """(bytes/s, fp32 operations/s, bf16 tensor-core operations/s), the
    port's published table (``core.machine.CARD_PEAKS``)."""
    from flexflow_tpu_torch.core import machine

    peaks = machine.card_peaks(name)
    check(peaks is not None, f"no published peaks for {name!r} in "
          f"flexflow_tpu_torch.core.machine.CARD_PEAKS")
    return peaks


# the card's name and power limit, as nvidia-smi prints them
CARD_LINE = ["not read"]


# ---------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    CARD_LINE[0] = smi.stdout.strip().splitlines()[0]
    print(CARD_LINE[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    return name


def phase_build():
    from flexflow_tpu_torch.kernels.build import build

    t0 = time.perf_counter()
    paths = build(["ragged_paged_attention", "flash_attention"])
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(p.name for p in paths.values())}")
    return paths


def sass_report(lib, kernels):
    """label -> {symbol, hgmma, stl, REG, STACK, SHARED, LOCAL} for each
    SASS function of ``lib`` whose mangled name holds every fragment of
    ``kernels[label]`` (exactly one must), from ``cuobjdump -sass`` and
    ``-res-usage``."""
    from flexflow_tpu_torch.kernels.build import cuda_tool

    tool = cuda_tool("cuobjdump")
    dumps = {}
    for flag in ("-sass", "-res-usage"):
        run = subprocess.run([tool, flag, str(lib)], capture_output=True,
                             text=True, timeout=300)
        check(run.returncode == 0, f"cuobjdump {flag} failed: "
              f"{run.stderr.strip()[-2000:]}")
        dumps[flag] = run.stdout
    sass = {}
    name = None
    for line in dumps["-sass"].splitlines():
        found = re.match(r"\s*Function : (\S+)", line)
        if found:
            name = found.group(1)
            sass[name] = []
        elif name is not None:
            sass[name].append(line)
    usage = {m.group(1): {k: int(v) for k, v in re.findall(
        r"(REG|STACK|SHARED|LOCAL):(\d+)", m.group(2))}
        for m in re.finditer(r"Function (\S+):\s*\n(.*)",
                             dumps["-res-usage"])}
    report = {}
    for label, keys in kernels.items():
        names = [n for n in sass if all(k in n for k in keys)]
        check(len(names) == 1, f"{len(names)} SASS functions match {keys}")
        lines = sass[names[0]]
        hgmma = sum("HGMMA" in ln for ln in lines)
        stl = sum(re.search(r"\bSTL(\.|\s)", ln) is not None
                  for ln in lines)
        res = usage.get(names[0], {})
        report[label] = {"symbol": names[0], "hgmma": hgmma, "stl": stl,
                         **res}
    return report


def check_no_spills(report):
    for r in report.values():
        check(r["stl"] == 0 and r.get("LOCAL", 0) == 0,
              f"{r['symbol']} spills to local memory: {r['stl']} STL, "
              f"LOCAL {r.get('LOCAL')}")


def phase_sass(libs):
    """The bf16 flash kernels' products run on the tensor cores: the SASS
    of the forward ``flash_fwd_tc_kernel`` (both values of Partial) and of
    the backward pair ``flash_bwd_dq_tc_kernel`` and
    ``flash_bwd_dkv_tc_kernel``, each at D' = 64 (head dims up to 64) and
    D' = 128 (80 to 128), holds HGMMA instructions, and no instance
    spills to local memory (``cuobjdump -res-usage`` LOCAL 0 and no STL
    in the SASS).  The decode kernels at the serving head dim 64
    (``rpa_split_kernel`` on fp32 and bf16 pools,
    ``rpa_quant_split_kernel`` on int8; bound by bytes, so no HGMMA is
    expected) spill nothing either; their registers and resident blocks
    per SM are printed."""
    from flexflow_tpu_torch.kernels.ragged_paged_attention import (
        blocks_per_sm,
    )

    kernels = {}
    for dp, partial in itertools.product((64, 128), (False, True)):
        kernels[f"fwd D'={dp} partial={partial}"] = (
            f"flash_fwd_tc_kernelILi{dp}ELb{int(partial)}E",)
    for kind, dp in itertools.product(("dq", "dkv"), (64, 128)):
        kernels[f"{kind} D'={dp}"] = (f"flash_bwd_{kind}_tc_kernelILi{dp}E",)
    report = sass_report(libs["flash_attention"], kernels)
    print("bf16 flash SASS: " + json.dumps(report))
    for r in report.values():
        check(r["hgmma"] > 0, f"no HGMMA in {r['symbol']}: its products do "
              f"not run on the tensor cores")
    check_no_spills(report)

    decode = sass_report(libs["ragged_paged_attention"], {
        "fp32": ("16rpa_split_kernelIfLi64E",),
        "bf16": ("16rpa_split_kernelI", "bfloat16", "Li64E"),
        "int8": ("22rpa_quant_split_kernelILi64E",)})
    for pool, r in decode.items():
        r["blocks_per_sm"] = blocks_per_sm(pool, 64)
    print("decode SASS (D=64): " + json.dumps(decode))
    check_no_spills(decode)


# ---------------------------------------------------------------------------
def time_ms(fn, flush, read_flush=False):
    """Median milliseconds of ``fn`` over TIMING_RUNS CUDA-event-timed
    runs, the L2 cache flushed before each (each layer's pool is cold
    when the real decode step reaches it): by zeroing ``flush``, which
    leaves the L2 full of dirty lines whose write-back may land in the
    window, or with ``read_flush`` by reading it (clean lines).  Between
    the flush and the start event the device spins for SPIN_CYCLES, so
    that the host has issued ``fn``'s launches before the device reaches
    the start event: the window times the device, not the host's
    dispatch."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMING_RUNS):
        if read_flush:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rpa_bound_ms(lens, page_size, cap, h, d, kv_bytes, name,
                 scale_bytes=0):
    """Least time for the work this run's inputs need: each live token's
    k and v row read once per head (and, for an int8 pool, its k and v
    scales once: ``scale_bytes`` per token), q read and out written
    once, the live page-table entries and seq_lens read once; against
    the fp32 operations (2 per element for q.k, 2 for p.v)."""
    live = np.clip(lens, 0, cap).astype(np.int64)
    b = len(lens)
    nbytes = (live.sum() * (h * d * 2 * kv_bytes + scale_bytes)
              + 2 * b * h * d * 4 + (-(-live // page_size)).sum() * 4
              + b * 4)
    ops = 4.0 * live.sum() * h * d
    bw, fp32, _ = card_peaks(name)
    t_bytes, t_ops = nbytes / bw * 1e3, ops / fp32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def serving_operands(seed):
    """Phase 3's decode operands at the serving shape: (lens, q, k, v,
    page_table, seq_lens), fp32 pools, on the card."""
    b, h = FRAME_SLOTS, FULL["num_heads"]
    d = FULL["hidden"] // h
    ps, pps = FULL["page_size"], FULL["pages_per_seq"]
    num_pages = b * pps
    rng = np.random.default_rng(seed)
    table = rng.permutation(num_pages)[:b * pps].reshape(b, pps)
    lens = rng.integers(1, MAX_SEQ + 1, size=b)
    lens[:6] = (0, 1, 15, 16, 17, MAX_SEQ)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, d), generator=gen, device=dev)
    k32 = torch.randn((num_pages, ps, h, d), generator=gen, device=dev)
    v32 = torch.randn((num_pages, ps, h, d), generator=gen, device=dev)
    pt = torch.as_tensor(table, dtype=torch.int32, device=dev)
    sl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    return lens, q, k32, v32, pt, sl


def flush_buffer():
    return torch.empty(64 << 20, dtype=torch.float32, device="cuda")  # 256 MB


def phase_kernels(name, seed):
    from flexflow_tpu_torch.kernels.ragged_paged_attention import (
        gather_kv_pages,
        gather_kv_pages_quant,
        ragged_paged_attention,
        ragged_paged_attention_quant,
        ragged_paged_attention_quant_reference,
        ragged_paged_attention_reference,
    )
    from flexflow_tpu_torch.ops.decode_attention import _quantize_kv

    b, h = FRAME_SLOTS, FULL["num_heads"]
    d = FULL["hidden"] // h
    ps, pps = FULL["page_size"], FULL["pages_per_seq"]
    num_pages = b * pps
    lens, q, k32, v32, pt, sl = serving_operands(seed)
    flush = flush_buffer()
    pos = torch.arange(MAX_SEQ, device=q.device)
    mask = (pos[None, :] < sl[:, None])[:, None, None, :]  # [B,1,1,S]
    results = {}
    for pool in ("fp32", "bf16"):
        dt = torch.float32 if pool == "fp32" else torch.bfloat16
        kp, vp = k32.to(dt), v32.to(dt)
        ref = ragged_paged_attention_reference(q, kp, vp, pt, sl)
        got = ragged_paged_attention(q, kp, vp, pt, sl)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"kernel gave non-finite values on the {pool} pool")
        err = float((got - ref).abs().max())
        check(bool(got[0].abs().max() == 0),
              "a sequence of length 0 must give zeros")
        check(err <= KERNEL_TOL,
              f"kernel vs plain version on the {pool} pool: max abs err "
              f"{err:.3e} > {KERNEL_TOL}")
        check_deterministic(
            ragged_paged_attention, got,
            lambda rows: (q[rows], kp, vp, pt[rows], sl[rows]), pool)
        kd = gather_kv_pages(kp, pt).transpose(1, 2).contiguous()
        vd = gather_kv_pages(vp, pt).transpose(1, 2).contiguous()
        qd = q.to(dt)[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        kernel_ms = time_ms(
            lambda: ragged_paged_attention(q, kp, vp, pt, sl), flush)
        read_flush_ms = time_ms(
            lambda: ragged_paged_attention(q, kp, vp, pt, sl), flush,
            read_flush=True)
        plain_ms = time_ms(
            lambda: ragged_paged_attention_reference(q, kp, vp, pt, sl),
            flush)
        library_ms = time_ms(lambda: sdpa(qd, kd, vd, attn_mask=mask), flush)
        bound_ms, bound_by = rpa_bound_ms(lens, ps, MAX_SEQ, h, d,
                                          kp.element_size(), name)
        results[pool] = dict(max_abs_err=err, ms=kernel_ms,
                             ms_read_flush=read_flush_ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        print(f"kernel ragged_paged_attention [{pool} pool, B={b} H={h} "
              f"D={d} ps={ps} pps={pps} P={num_pages}, "
              f"{int(np.clip(lens, 0, MAX_SEQ).sum())} live tokens]: "
              + json.dumps(results[pool]))
        del kd, vd

    # the int8 pool: the same pages quantized per token, as the decode
    # op stores them
    kq, ks = _quantize_kv(k32)
    vq, vs = _quantize_kv(v32)
    args = (q, kq, vq, ks, vs, pt, sl)
    ref = ragged_paged_attention_quant_reference(*args)
    got = ragged_paged_attention_quant(*args)
    fp32_out = ragged_paged_attention_reference(q, k32, v32, pt, sl)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()),
          "int8 kernel gave non-finite values")
    check(bool(got[0].abs().max() == 0),
          "int8 kernel: a sequence of length 0 must give zeros")
    err = float((got - ref).abs().max())
    rel = err / max(1.0, float(ref.abs().max()))
    check(rel <= KERNEL_TOL, f"int8 kernel vs plain version: error "
          f"{rel:.3e} > {KERNEL_TOL} of max(1, |plain|)")
    drift = float((got - fp32_out).abs().max())
    check(drift < INT8_DRIFT_TOL, f"int8 vs fp32 pool drift {drift:.3e} >= "
          f"{INT8_DRIFT_TOL}")
    check_deterministic(
        ragged_paged_attention_quant, got,
        lambda rows: (q[rows], kq, vq, ks, vs, pt[rows], sl[rows]), "int8")
    kd = gather_kv_pages_quant(kq, ks, pt).transpose(1, 2).contiguous()
    vd = gather_kv_pages_quant(vq, vs, pt).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bound_ms, bound_by = rpa_bound_ms(lens, ps, MAX_SEQ, h, d, 1, name,
                                      scale_bytes=8)
    results["int8"] = dict(
        max_abs_err=err, rel_err=rel, drift_vs_fp32_pool=drift,
        ms=time_ms(lambda: ragged_paged_attention_quant(*args), flush),
        ms_read_flush=time_ms(lambda: ragged_paged_attention_quant(*args),
                              flush, read_flush=True),
        plain_ms=time_ms(
            lambda: ragged_paged_attention_quant_reference(*args), flush),
        library_ms=time_ms(lambda: sdpa(q[:, :, None, :], kd, vd,
                                        attn_mask=mask), flush),
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"kernel ragged_paged_attention_quant [int8 pool, B={b} H={h} "
          f"D={d} ps={ps} pps={pps} P={num_pages}, "
          f"{int(np.clip(lens, 0, MAX_SEQ).sum())} live tokens]: "
          + json.dumps(results["int8"]))
    del kd, vd
    check_split_edges(seed)
    sweep_kernel_shapes(seed)
    return results


def decode_times(root, seed):
    """``--decode-times ROOT``: the decode kernels of the checkout at
    ``root`` (its ``flexflow_tpu_torch``) on phase 3's serving operands,
    each pool's kernel timed by ``time_ms`` after a zeroing and after a
    reading flush, with its max abs error against that checkout's plain
    version (int8: of max(1, |plain|))."""
    sys.path.insert(0, os.path.abspath(root))
    import flexflow_tpu_torch
    from flexflow_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_quant,
        ragged_paged_attention_quant_reference,
        ragged_paged_attention_reference,
    )
    from flexflow_tpu_torch.ops.decode_attention import _quantize_kv

    package = os.path.dirname(os.path.abspath(flexflow_tpu_torch.__file__))
    check(package == os.path.join(os.path.abspath(root),
                                  "flexflow_tpu_torch"),
          f"--decode-times {root}: imported the package at {package}")
    _, q, k32, v32, pt, sl = serving_operands(seed)
    kq, ks = _quantize_kv(k32)
    vq, vs = _quantize_kv(v32)
    flush = flush_buffer()
    report = {"package": package}
    for pool, kernel, plain, operands in (
            ("fp32", ragged_paged_attention, ragged_paged_attention_reference,
             (q, k32, v32, pt, sl)),
            ("bf16", ragged_paged_attention, ragged_paged_attention_reference,
             (q, k32.bfloat16(), v32.bfloat16(), pt, sl)),
            ("int8", ragged_paged_attention_quant,
             ragged_paged_attention_quant_reference,
             (q, kq, vq, ks, vs, pt, sl))):
        ref = plain(*operands)
        err = float((kernel(*operands) - ref).abs().max())
        if pool == "int8":
            err /= max(1.0, float(ref.abs().max()))
        check(err <= KERNEL_TOL, f"--decode-times {root}, {pool} pool: "
              f"error {err:.3e} > {KERNEL_TOL}")
        report[pool] = dict(
            max_err=err, ms=time_ms(lambda: kernel(*operands), flush),
            ms_read_flush=time_ms(lambda: kernel(*operands), flush,
                                  read_flush=True))
    print("decode times: " + json.dumps(report))


def step_times(root, seed):
    """Phase 6's training step (its model, batch and optimizer) of the
    checkout at ``root``: after one warm step (the capture) each, the
    flash kernels' launches per step and the synchronised step time over
    TIMED_STEPS steps, captured and eager; one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import flexflow_tpu_torch
    from flexflow_tpu_torch import AdamOptimizer, FFConfig
    from flexflow_tpu_torch.compiler.graphs import eager
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.models import build_gpt

    package = os.path.dirname(os.path.abspath(flexflow_tpu_torch.__file__))
    check(package == os.path.join(os.path.abspath(root),
                                  "flexflow_tpu_torch"),
          f"--step-times {root}: imported the package at {package}")
    cfg = FFConfig(batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                   seed=seed)
    model = build_gpt(cfg, **TRAIN)
    model.compile(optimizer=AdamOptimizer(alpha=ADAM_ALPHA),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    rng = np.random.default_rng(seed + 3)  # phase 6's batches
    ids = rng.integers(0, TOKEN_RANGE, size=(
        TRAIN_BATCHES * TRAIN_BATCH, TRAIN["seq_len"] + 1)).astype(np.int32)
    dev = model.compiled.device
    batches = [([torch.from_numpy(ids[i:i + TRAIN_BATCH, :-1]).to(dev)],
                torch.from_numpy(ids[i:i + TRAIN_BATCH, 1:]).to(dev))
               for i in range(0, TIMED_STEPS * TRAIN_BATCH, TRAIN_BATCH)]
    kernels = (fa.flash_forward, fa.flash_backward_dq,
               fa.flash_backward_dkv)

    def train_step(batch):
        model.params, model.opt_state, model.state, loss, _ = (
            model.compiled.train_step(model.params, model.opt_state,
                                      model.state, *batch))
        return loss

    report = {"package": package}
    for tag, ctx in (("captured", contextlib.nullcontext()),
                     ("eager", eager())):
        with ctx:
            train_step(batches[0])
            for kn in kernels:
                kn.launches = 0
            times = []
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = train_step(batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(loss)), f"--step-times {root} {tag}: "
              f"the loss is not finite")
        launches = ({k: v for k, v in captured_launches(
            model.compiled.step_graph).items()
            if k in {kn.__name__ for kn in kernels}}
            if tag == "captured" else
            {kn.__name__: kn.launches / len(batches) for kn in kernels})
        report[tag] = {"steps": len(times),
                       "p50_ms": float(np.median(times)) * 1e3,
                       "p99_ms": float(np.quantile(times, 0.99)) * 1e3,
                       "flash_launches_per_step": launches}
    print("step times: " + json.dumps(report))


def bits(t):
    return t.contiguous().view(torch.int32)


def check_deterministic(kernel, got, operands, pool):
    """At the serving shape: a second call gives the same bits, and the
    1024-token sequence (row 5) alone gives the same bits as its row in
    the 32-row batch (its splits do not depend on the batch)."""
    every = slice(None)
    again = kernel(*operands(every))
    alone = kernel(*operands(slice(5, 6)))
    torch.cuda.synchronize()
    check(bool(torch.equal(bits(again), bits(got))),
          f"two calls on the {pool} pool differ")
    check(bool(torch.equal(bits(alone[0]), bits(got[5]))),
          f"the {pool} pool's 1024-token row differs alone and in the batch")


def check_split_edges(seed):
    """Sequence lengths at the kernels' split edges (0, 1, split - 1,
    split, split + 1, the same around two splits, the cap - 1 and the
    cap) at the serving widths, on fp32, bf16 and int8 pools, against
    the plain versions."""
    from flexflow_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_quant,
        ragged_paged_attention_quant_reference,
        ragged_paged_attention_reference,
        split_tokens,
    )
    from flexflow_tpu_torch.ops.decode_attention import _quantize_kv

    split = split_tokens()
    lens = (0, 1, split - 1, split, split + 1, 2 * split - 1, 2 * split,
            2 * split + 1, MAX_SEQ - 1, MAX_SEQ)
    h = FULL["num_heads"]
    d = FULL["hidden"] // h
    ps, pps = FULL["page_size"], FULL["pages_per_seq"]
    b = len(lens)
    num_pages = b * pps
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    q = torch.randn((b, h, d), generator=gen, device=dev)
    k = torch.randn((num_pages, ps, h, d), generator=gen, device=dev)
    v = torch.randn((num_pages, ps, h, d), generator=gen, device=dev)
    pt = torch.randperm(num_pages, generator=gen, device=dev).reshape(
        b, pps).to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    errs = {}
    for pool, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        kp, vp = k.to(dt), v.to(dt)
        got = ragged_paged_attention(q, kp, vp, pt, sl)
        ref = ragged_paged_attention_reference(q, kp, vp, pt, sl)
        torch.cuda.synchronize()
        errs[pool] = float((got - ref).abs().max())
        check(bool(got[0].abs().max() == 0),
              f"{pool} pool: a sequence of length 0 must give zeros")
    kq, ks = _quantize_kv(k)
    vq, vs = _quantize_kv(v)
    args = (q, kq, vq, ks, vs, pt, sl)
    got = ragged_paged_attention_quant(*args)
    ref = ragged_paged_attention_quant_reference(*args)
    torch.cuda.synchronize()
    errs["int8"] = float((got - ref).abs().max()) / max(
        1.0, float(ref.abs().max()))
    check(bool(got[0].abs().max() == 0),
          "int8 pool: a sequence of length 0 must give zeros")
    print(f"kernel split edges (split {split} tokens, lengths {lens}): "
          + json.dumps(errs))
    for pool, err in errs.items():
        check(err <= KERNEL_TOL, f"split edges, {pool} pool: error "
              f"{err:.3e} > {KERNEL_TOL}")


def sweep_kernel_shapes(seed):
    """Every head dim the kernels take (multiples of 32 up to 256) and
    odd page sizes, on fp32, bf16 and int8 pools, against the plain
    versions; head dims they do not take are refused; an out-of-range
    page id gives a NaN row instead of a read outside the pool."""
    from flexflow_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_quant,
        ragged_paged_attention_quant_reference,
        ragged_paged_attention_reference,
    )
    from flexflow_tpu_torch.ops.decode_attention import _quantize_kv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    b, h, pps = 3, 2, 5
    worst, worst_int8 = 0.0, 0.0
    for d in range(32, 257, 32):
        for ps in (1, 5, 16, 32):
            cap = ps * pps
            num_pages = b * pps + 1
            q = torch.randn((b, h, d), generator=gen, device=dev)
            k = torch.randn((num_pages, ps, h, d), generator=gen, device=dev)
            v = torch.randn((num_pages, ps, h, d), generator=gen, device=dev)
            pt = torch.randperm(num_pages, generator=gen, device=dev)[
                :b * pps].reshape(b, pps).to(torch.int32)
            sl = torch.tensor([0, cap // 2 + 1, cap], dtype=torch.int32,
                              device=dev)
            for dt in (torch.float32, torch.bfloat16):
                kp, vp = k.to(dt), v.to(dt)
                got = ragged_paged_attention(q, kp, vp, pt, sl)
                ref = ragged_paged_attention_reference(q, kp, vp, pt, sl)
                err = float((got - ref).abs().max())
                check(err <= KERNEL_TOL, f"D={d} ps={ps} {dt}: max abs err "
                      f"{err:.3e} > {KERNEL_TOL}")
                worst = max(worst, err)
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            qargs = (q, kq, vq, ks, vs, pt, sl)
            ref = ragged_paged_attention_quant_reference(*qargs)
            err = float((ragged_paged_attention_quant(*qargs) - ref).abs(
                ).max()) / max(1.0, float(ref.abs().max()))
            check(err <= KERNEL_TOL, f"int8 D={d} ps={ps}: error {err:.3e} "
                  f"> {KERNEL_TOL}")
            worst_int8 = max(worst_int8, err)
    bad_pt = pt.clone()
    bad_pt[1, 0] = num_pages  # one past the pool
    got = ragged_paged_attention(q, k, v, bad_pt, sl)
    check(bool(got[1].isnan().all()) and bool(torch.isfinite(got[2]).all()),
          "an out-of-range page id must give a NaN row, and only there")
    try:
        ragged_paged_attention(q[..., :48].contiguous(), k[..., :48],
                               v[..., :48], pt, sl)
        fail("head dim 48 was not refused")
    except ValueError:
        pass
    for bad_d in (8, 144):
        zq = torch.zeros((1, 1, bad_d), device=dev)
        zp = torch.zeros((2, 4, 1, bad_d), dtype=torch.int8, device=dev)
        zs = torch.zeros((2, 4), device=dev)
        try:
            ragged_paged_attention_quant(
                zq, zp, zp, zs, zs, torch.zeros((1, 2), dtype=torch.int32,
                                                device=dev),
                torch.ones(1, dtype=torch.int32, device=dev))
            fail(f"int8 kernel: head dim {bad_d} was not refused")
        except ValueError:
            pass
    torch.cuda.synchronize()
    print(f"kernel shape sweep: D 32..256 x page sizes 1, 5, 16, 32: "
          f"fp32/bf16 pools max abs err {worst:.3e}, int8 pool error "
          f"{worst_int8:.3e} of max(1, |plain|); bad page id -> NaN row; "
          f"D=48 refused, int8 D=8 and D=144 refused")


# ---------------------------------------------------------------------------
def make_requests(seed, vocab):
    from flexflow_tpu_torch.runtime.decode import DecodeRequest

    rng = np.random.default_rng(seed + 1)
    reqs = []
    for i in range(N_REQUESTS):
        if i == 5:  # one request fills its sequence exactly
            plen, new = MAX_SEQ - 128, 128
        else:
            plen = int(rng.integers(8, 257))
            new = int(rng.integers(16, 129))
        prompt = rng.integers(0, vocab, size=plen).tolist()
        reqs.append(DecodeRequest(rid=f"r{i}", prompt=prompt,
                                  max_new_tokens=new))
    return reqs


def set_op_attr(model, op_type: str, attr: str, value) -> None:
    """Set ``attr`` on every op of the model's graph of ``op_type``."""
    from flexflow_tpu_torch.core.optype import OperatorType

    for node in model.graph.topo_order():
        if node.op.op_type == OperatorType(op_type):
            node.op.attrs[attr] = value


def zero_state(model):
    for t in model.state.values():
        t.zero_()


def fingerprint(logits):
    """A device int64 sum of the logits' bit patterns, one per frame:
    a changed bit changes it, so two runs' frames compare without
    keeping every frame's logits."""
    t = logits.contiguous()
    return t.view(torch.int16 if t.element_size() == 2
                  else torch.int32).sum(dtype=torch.int64)


def replays(graph) -> int:
    """Replays of a ``StepGraph`` so far, over its keys."""
    return sum(r["replays"] for r in graph.report())


def captured_launches(graph) -> dict:
    """Kernel launches per replay of a ``StepGraph`` captured for one
    input-shape key."""
    rep = graph.report()
    check(len(rep) == 1, f"{len(rep)} captured keys, wanted 1")
    return rep[0]["captured_launches"]


def phase_main_path(seed):
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.compiler.graphs import eager
    from flexflow_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention,
    )
    from flexflow_tpu_torch.models import build_gpt_decode
    from flexflow_tpu_torch.runtime.decode import (
        ContinuousBatchingExecutor,
        DecodeRequest,
        compiled_decode_step,
    )

    t0 = time.perf_counter()
    cfg = FFConfig(batch_size=FRAME_SLOTS, compute_dtype="bfloat16",
                   seed=seed)
    model = build_gpt_decode(cfg, **FULL)
    model.compile(comp_mode="inference")
    torch.cuda.synchronize()
    n_params = sum(w.numel() for ws in model.params.values()
                   for w in ws.values())
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in model.state.values())
    print(f"main path: compiled in {time.perf_counter() - t0:.2f} s, "
          f"{n_params} parameters, KV pools {pool_bytes / 1e9:.3f} GB")

    def executor(step):
        return ContinuousBatchingExecutor(
            step, max_seqs=FRAME_SLOTS, page_size=FULL["page_size"],
            pages_per_seq=FULL["pages_per_seq"])

    step = compiled_decode_step(model)
    # warm-up, off the clock: library handles, allocator pools, the
    # frame's capture, and the eager path's own first calls
    t0 = time.perf_counter()
    executor(step).run([DecodeRequest(rid="warm", prompt=[1, 2, 3],
                                      max_new_tokens=4)])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    with eager():
        executor(step).run([DecodeRequest(rid="warm", prompt=[1, 2, 3],
                                          max_new_tokens=4)])
    per_replay = captured_launches(step.graph)
    reqs = make_requests(seed, FULL["vocab"])

    def serve():
        """The requests from an empty cache; the first frames' logits
        and every frame's fingerprint recorded."""
        zero_state(model)
        recorded, prints = [], []

        def recording_step(ids, table, lens):
            logits = step(ids, table, lens)
            prints.append(fingerprint(logits))
            if len(recorded) < PARITY_FRAMES:
                recorded.append((ids.copy(), table.copy(), lens.copy(),
                                 logits.float().clone()))
            return logits

        ex = executor(recording_step)
        ragged_paged_attention.launches = 0
        replays0 = replays(step.graph)
        t0 = time.perf_counter()
        out = ex.run(reqs, max_frames=20_000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        summ = ex.summary()
        tokens = sum(len(v) for v in out.values())
        report = {
            "frames": ex.frame, "requests_finished": len(out),
            "frame_p50_ms": summ["measured_p50_s"] * 1e3,
            "frame_p99_ms": summ["measured_p99_s"] * 1e3,
            "generated_tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "kernel_launches": ragged_paged_attention.launches,
            "graph_replays": replays(step.graph) - replays0}
        return out, recorded, torch.stack(prints).cpu(), report

    out, recorded, prints, report = serve()
    report["captured_launches_per_replay"] = per_replay
    report["warm_up_and_capture_s"] = capture_s
    print("main path (captured): " + json.dumps(report))
    with eager():
        out_e, recorded_e, prints_e, report_e = serve()
    print("main path (eager): " + json.dumps(report_e))
    frames, launches = report["frames"], report["kernel_launches"]
    check(len(out) == N_REQUESTS,
          f"{len(out)} of {N_REQUESTS} requests finished")
    for r in reqs:
        got = out[r.rid]
        check(len(got) == r.max_new_tokens,
              f"{r.rid}: {len(got)} tokens, wanted {r.max_new_tokens}")
        check(all(0 <= t < FULL["vocab"] for t in got),
              f"{r.rid}: token id outside the vocab")
    layers = FULL["num_layers"]
    check(per_replay == {"ragged_paged_attention": layers},
          f"captured launches per frame {per_replay}, wanted {layers}")
    check(report["graph_replays"] == frames
          and launches == layers * report["graph_replays"],
          f"{launches} kernel launches for {report['graph_replays']} "
          f"replays of {frames} frames of {layers} layers")
    check(report_e["graph_replays"] == 0
          and report_e["kernel_launches"] == layers * report_e["frames"],
          f"eager: {report_e['kernel_launches']} launches, "
          f"{report_e['graph_replays']} replays for {report_e['frames']} "
          f"frames")
    check(out_e == out, "eager serving gives other tokens than captured")
    check(torch.equal(prints_e, prints),
          "eager frames' logits differ in bits from the captured frames'")
    check(all(torch.equal(a[-1], b[-1]) for a, b in zip(recorded,
                                                         recorded_e)),
          "eager first frames' logits differ from the captured ones")
    print(f"main path: captured == eager, bit for bit: tokens of "
          f"{len(out)} requests, logits of {frames} frames")
    check(len(recorded) == PARITY_FRAMES,
          f"{len(recorded)} frames recorded for the parity replay")
    for *_, logits in recorded:
        check(tuple(logits.shape) == (FRAME_SLOTS, 1, FULL["vocab"]),
              f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")

    # the same path with the plain attention, replayed over the first
    # frames from an empty cache
    zero_state(model)
    set_op_attr(model, "decode_attention", "use_kernel", False)
    plain = compiled_decode_step(model)
    diff = 0.0
    for ids, table, lens, logits in recorded:
        diff = max(diff, float((plain(ids, table, lens).float()
                                - logits).abs().max()))
    set_op_attr(model, "decode_attention", "use_kernel", True)
    print(f"main path vs plain attention, first {len(recorded)} frames: "
          f"logits max abs diff {diff:.3e} (tol {PATH_TOL})")
    check(diff <= PATH_TOL, f"logits differ by {diff:.3e} > {PATH_TOL}")

    # batched serving equals serving a request alone
    shortest = sorted(reqs, key=lambda r: len(r.prompt) + r.max_new_tokens)
    for r in shortest[:2]:
        zero_state(model)
        alone = executor(compiled_decode_step(model)).run([r])
        check(alone[r.rid] == out[r.rid],
              f"{r.rid}: served alone gives other tokens than batched")
    print(f"main path: batched == solo for "
          f"{[r.rid for r in shortest[:2]]}")

    for tag, ctx in (("captured", contextlib.nullcontext()),
                     ("eager", eager())):
        zero_state(model)
        with ctx:
            prof = profile_frames(executor(compiled_decode_step(model)),
                                  reqs)
        print(f"main path profile ({tag}): " + json.dumps(prof))
    return launches


def profile_frames(ex, reqs, warm=PROFILE_WARM_FRAMES,
                   frames=PROFILE_FRAMES):
    """Where a steady decode frame's time goes: ``torch.profiler`` over
    ``frames`` frames after ``warm`` frames of the same traffic."""
    ex.submit(reqs)
    for _ in range(warm):
        ex.step()
    return profile_window(ex.step, frames, "frame")


def profile_window(step, n, unit, groups=None):
    """``torch.profiler`` over ``n`` calls of ``step``.  Reports the host
    wall time of the window, the device busy time (the union of kernel
    and copy intervals) and its share, device kernels per ``unit``, and
    the largest device-time items, and the decode-attention kernels'
    (``rpa_*``) device time and share of busy; with ``groups`` (group ->
    name fragments, first match wins, the rest "other"), each group's
    device ms per ``unit``.  The device-side spans of
    the executor's phase annotations (``ff.phase/...``, when armed) cover
    kernels rather than being kernels: they are reported apart, as the
    device time each phase spans per ``unit``.  An empty device trace is
    reported as not measured."""
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.obs.annotate import PHASE_PREFIX

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, phases = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith(PHASE_PREFIX):
            phases[e.name] = phases.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / n / 1e3
        else:
            dev.append(e)
    if not dev:
        return {"device_time": "not measured (no device events traced)"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    decode = sum(t for name, t in by_name.items() if "rpa_" in name)
    grouped = {}
    for name, t in by_name.items():
        g = next((g for g, frags in (groups or {}).items()
                  if any(f in name for f in frags)), "other")
        grouped[g] = grouped.get(g, 0.0) + t / n / 1e3
    return {
        f"{unit}s": n,
        f"{unit}_wall_ms": wall_us / n / 1e3,
        f"device_busy_ms_per_{unit}": busy / n / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        f"device_kernels_per_{unit}": len(dev) / n,
        f"top_device_ms_per_{unit}": {
            name[:60]: t / n / 1e3 for name, t in top},
        f"phase_span_device_ms_per_{unit}": phases,
        f"decode_attention_ms_per_{unit}": decode / n / 1e3,
        "decode_attention_share_of_busy": decode / busy,
        **({f"device_ms_per_{unit}_by_group": grouped} if groups else {}),
    }


# ---------------------------------------------------------------------------
def make_lane_requests(seed, vocab):
    """(batch requests, interactive requests) of the int8 lane phase.
    Each sharer's own tokens start with a token no other sharer's do,
    so the only mid-page match is the planted one."""
    from flexflow_tpu_torch.runtime.decode import DecodeRequest

    rng = np.random.default_rng(seed + 6)
    system = rng.integers(0, vocab, size=LANE_SYS_TOKENS).tolist()
    batch, first_own = [], None
    for i in range(LANE_BATCH):
        new = int(rng.integers(16, 129))
        if i < LANE_SHARERS:
            own = rng.integers(0, vocab, size=int(rng.integers(17, 129)))
            own = own.tolist()
            own[0] = vocab - 1 - i
            if i == 0:
                first_own = own
            elif i == LANE_COW:
                own = (first_own[:LANE_COW_TOKENS]
                       + [(first_own[LANE_COW_TOKENS] + 1) % vocab]
                       + own[LANE_COW_TOKENS + 1:])
            prompt = system + own
        else:
            prompt = rng.integers(0, vocab, size=int(
                rng.integers(8, 257))).tolist()
        batch.append(DecodeRequest(
            rid=f"b{i}", prompt=prompt, max_new_tokens=new, slo="batch",
            deadline_frames=1 if i == LANE_EXPIRING else None))
    interactive = [DecodeRequest(
        rid=f"i{j}", prompt=rng.integers(0, vocab, size=int(
            rng.integers(8, 65))).tolist(),
        max_new_tokens=int(rng.integers(16, 129)), slo="interactive")
        for j in range(LANE_INTERACTIVE)]
    return batch, interactive


def claimed_prefix(i: int) -> int:
    """Prompt tokens batch request ``i`` finds cached at its first
    admission: the system prompt for every sharer after the first, and
    the planted mid-page match on top for the copy-on-write one."""
    if not 0 < i < LANE_SHARERS:
        return 0
    return LANE_SYS_TOKENS + (LANE_COW_TOKENS if i == LANE_COW else 0)


def lane_executor(step, cfg):
    from flexflow_tpu_torch.runtime.decode import (
        ContinuousBatchingExecutor,
        SLOClass,
    )

    return ContinuousBatchingExecutor(
        step, max_seqs=FRAME_SLOTS, page_size=FULL["page_size"],
        pages_per_seq=FULL["pages_per_seq"], prefill_fn=step.prefill,
        prefill_chunk=cfg.prefill_chunk, prefix_sharing=True,
        copy_page_fn=step.copy_page,
        slo_classes=[SLOClass(c["name"], c["priority"],
                              c["deadline_frames"], c["quantile"])
                     for c in cfg.serve_slo_classes])


def drive_lane(ex, batch, interactive, frames=None):
    """The lane's traffic: ``batch`` at frame 0, ``interactive`` at
    frame 1, then frames to the end (or ``frames`` in all).  Returns
    the tokens of every sequence preempted at frame 1, as re-queued."""
    ex.submit(batch)
    ex.step()
    ex.submit(interactive)
    ex.step()
    requeued = [list(e.tokens) for e in ex.queue if e.preempted]
    if frames is None:
        ex.run(max_frames=20_000)
    else:
        for _ in range(frames - 2):
            ex.step()
    return requeued


def recording(step, log, frames, passes, prints):
    """``step`` with its ``prefill`` and ``copy_page``, logging every
    call in order (and each frame's logits) until ``frames`` frames ran,
    so that the run's start can be replayed from an empty cache; every
    frame's logits fingerprint is appended to ``prints`` and every chunk
    pass's host seconds and CUDA events around it to ``passes``."""
    def frames_logged():
        return sum(kind == "step" for kind, *_ in log)

    def rec_step(ids, table, lens):
        logits = step(ids, table, lens)
        prints.append(fingerprint(logits))
        if frames_logged() < frames:
            log.append(("step", (ids.copy(), table.copy(), lens.copy()),
                        logits.float().clone()))
        return logits

    def rec_prefill(ids, positions, table):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        start.record()
        step.prefill(ids, positions, table)
        end.record()
        passes.append((time.perf_counter() - t0, start, end))
        if frames_logged() < frames:
            log.append(("prefill", (ids.copy(), positions.copy(),
                                    table.copy()), None))

    def rec_copy(src, dst):
        step.copy_page(src, dst)
        if frames_logged() < frames:
            log.append(("copy", (src, dst), None))

    rec_step.prefill = rec_prefill
    rec_step.copy_page = rec_copy
    return rec_step


def run_lane(model, step, cfg, batch, interactive):
    """The lane's traffic through ``step`` from an empty cache, with the
    event bus and the request tracer armed; returns the executor, the
    bus's events, the preempted sequences' tokens, the call log, the
    frames' fingerprints and a report."""
    import tempfile

    from flexflow_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention_quant,
    )
    from flexflow_tpu_torch.obs.events import BUS
    from flexflow_tpu_torch.obs.tracing import TRACER

    zero_state(model)
    log, passes, prints = [], [], []
    ex = lane_executor(recording(step, log, PARITY_FRAMES, passes, prints),
                       cfg)
    with tempfile.TemporaryDirectory() as tmp:
        obs_log = f"{tmp}/lane_obs.jsonl"
        BUS.configure(obs_log)
        TRACER.reset()
        TRACER.enabled = True
        try:
            ragged_paged_attention_quant.launches = 0
            replays0 = (replays(step.graph), replays(step.prefill_graph))
            t0 = time.perf_counter()
            requeued = drive_lane(ex, batch, interactive)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ragged_paged_attention_quant.launches
            BUS.flush()
            with open(obs_log) as f:
                events = [json.loads(line) for line in f]
        finally:
            BUS.close()
            TRACER.enabled = False
    out, summ = dict(ex.finished), ex.summary()
    tokens = sum(len(v) for v in out.values())
    report = {
        "frames": ex.frame, "requests_finished": len(out),
        "chunk_passes": summ["prefill_chunks"],
        "prefill_tokens": summ["prefill_tokens"],
        "prefix_hits": summ["prefix_hits"],
        "shared_pages": summ["shared_pages"],
        "prefix_tokens": summ["prefix_tokens"],
        "cow_copies": summ["cow_copies"], "preempted": summ["preempted"],
        "expired": summ["expired"],
        "frame_p50_ms": summ["measured_p50_s"] * 1e3,
        "frame_p99_ms": summ["measured_p99_s"] * 1e3,
        "generated_tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "kernel_launches": launches,
        "frame_replays": replays(step.graph) - replays0[0],
        "chunk_replays": replays(step.prefill_graph) - replays0[1]}
    for key in ("ttft", "queue", "prefill", "first_frame", "tpot", "e2e"):
        for q in ("p50", "p99"):
            v = summ.get(f"{key}_{q}_s")
            report[f"{key}_{q}_ms"] = None if v is None else v * 1e3
    # where the wall time went: decode frames (step + argmax) and the
    # chunk passes run at admission: host seconds of each pass's call
    # (a captured pass returns once its replay is queued) and device ms
    # between CUDA events around it
    report["decode_frames_s"] = sum(ex.frame_seconds)
    report["prefill_s"] = sum(t for t, *_ in passes)
    report["ms_per_chunk_pass"] = float(np.mean(
        [t for t, *_ in passes])) * 1e3
    report["device_ms_per_chunk_pass"] = float(np.mean(
        [a.elapsed_time(b) for _, a, b in passes]))
    report["slo_classes"] = summ["slo_classes"]
    return dict(ex=ex, out=out, events=events, requeued=requeued, log=log,
                prints=torch.stack(prints).cpu(), report=report)


def phase_serving_lane(seed):
    """The int8 KV lane at full width: chunked prefill, prefix sharing
    with copy-on-write, SLO classes with expiry and preemption, the
    event bus and the request tracer armed; captured, then eager."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.compiler.graphs import eager
    from flexflow_tpu_torch.models import build_gpt_decode
    from flexflow_tpu_torch.obs import annotate
    from flexflow_tpu_torch.obs.events import validate_event
    from flexflow_tpu_torch.obs.tracing import TRACER
    from flexflow_tpu_torch.runtime.decode import (
        ContinuousBatchingExecutor,
        DecodeRequest,
        compiled_decode_step,
    )

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = FFConfig(batch_size=FRAME_SLOTS, compute_dtype="bfloat16",
                   seed=seed, kv_precision="int8", prefill_chunk=LANE_CHUNK,
                   serve_slo_classes=LANE_SLO_CLASSES)
    model = build_gpt_decode(cfg, **FULL)
    model.compile(comp_mode="inference")
    torch.cuda.synchronize()
    pools = {k: (t.dtype, tuple(t.shape)) for k, t in model.state.items()
             if k.startswith("layer0_mha/")}
    check(pools["layer0_mha/k_cache"][0] == torch.int8
          and pools["layer0_mha/k_scale"] == (
              torch.float32, pools["layer0_mha/k_cache"][1][:2]),
          f"int8 lane pools: {pools}")
    pool_gb = sum(t.numel() * t.element_size()
                  for t in model.state.values()) / 1e9
    print(f"serving lane: compiled in {time.perf_counter() - t0:.2f} s, "
          f"int8 KV pools with scales {pool_gb:.3f} GB")

    # warm-up, off the clock: library handles, allocator pools, the
    # frame's and the chunk pass's captures, the eager path's first calls
    step = compiled_decode_step(model, prefill_chunk=LANE_CHUNK)
    warm = [DecodeRequest(rid="warm", prompt=list(range(1, 40)),
                          max_new_tokens=4)]
    lane_executor(step, cfg).run(warm)
    with eager():
        lane_executor(step, cfg).run(warm)
    per_frame = captured_launches(step.graph)
    per_chunk = captured_launches(step.prefill_graph)

    batch, interactive = make_lane_requests(seed, FULL["vocab"])
    cap = run_lane(model, step, cfg, batch, interactive)
    ex, out, report = cap["ex"], cap["out"], cap["report"]
    summ, frames = ex.summary(), ex.frame
    report["kv_pool_gb"] = pool_gb
    report["captured_launches_per_frame"] = per_frame
    report["captured_launches_per_chunk_pass"] = per_chunk
    print("serving lane (captured): " + json.dumps(report))

    layers = FULL["num_layers"]
    launches, requeued, events = (report["kernel_launches"], cap["requeued"],
                                  cap["events"])
    expired = batch[LANE_EXPIRING].rid
    served = [r for r in batch + interactive if r.rid != expired]
    check(set(ex.expired) == {expired} and summ["expired"] == 1,
          f"expired {sorted(ex.expired)}, wanted [{expired!r}]")
    check(set(out) == {r.rid for r in served},
          f"{len(out)} of {len(served)} requests finished")
    for r in served:
        check(len(out[r.rid]) == r.max_new_tokens,
              f"{r.rid}: {len(out[r.rid])} tokens, wanted "
              f"{r.max_new_tokens}")
        check(all(0 <= t < FULL["vocab"] for t in out[r.rid]),
              f"{r.rid}: token id outside the vocab")
    check(per_frame == {"ragged_paged_attention_quant": layers}
          and per_chunk == {},
          f"captured launches per frame {per_frame}, per chunk pass "
          f"{per_chunk}")
    check(report["frame_replays"] == frames
          and launches == layers * report["frame_replays"],
          f"{launches} int8 kernel launches for {report['frame_replays']} "
          f"replays of {frames} frames of {layers} layers")
    check(report["chunk_replays"] == summ["prefill_chunks"],
          f"{report['chunk_replays']} chunk-pass replays for "
          f"{summ['prefill_chunks']} chunk passes")
    want_prefill = sum(len(r.prompt) - 1 - claimed_prefix(i)
                       for i, r in enumerate(batch) if r.rid != expired)
    want_prefill += sum(len(r.prompt) - 1 for r in interactive)
    want_prefill += sum(len(t) - 1 for t in requeued)
    check(summ["prefill_chunks"] > 0
          and summ["prefill_tokens"] == want_prefill,
          f"prefill tokens {summ['prefill_tokens']}, counted "
          f"{want_prefill} from the admissions")
    check(summ["preempted"] >= 1 and len(requeued) == summ["preempted"],
          f"preempted {summ['preempted']}, re-queued {len(requeued)}")
    check(summ["cow_copies"] >= 1, "no copy-on-write page copy")
    check(summ["prefix_hits"] >= LANE_SHARERS - 1,
          f"{summ['prefix_hits']} prefix hits, wanted >= "
          f"{LANE_SHARERS - 1}")
    bad = [e for e in events if validate_event(e)]
    check(not bad, f"{len(bad)} events fail their schema: {bad[:2]}")
    recs = {r["rid"]: r for r in ex.request_records
            if r.get("phase") == "finish"}
    problems = []
    for tid in TRACER.trace_ids():
        rec = recs.get(tid.split("#", 1)[0])
        problems += TRACER.validate_trace(
            tid, e2e_s=rec["e2e_s"] if rec else None)
    check(not problems and len(TRACER.trace_ids()) == len(served) + 1,
          f"span trees: {len(TRACER.trace_ids())} traces, problems "
          f"{problems[:3]}")
    print(f"serving lane: {len(TRACER.trace_ids())} request span trees "
          f"valid, 0 orphans; {len(events)} events valid")

    with eager():
        eag = run_lane(model, step, cfg, batch, interactive)
    print("serving lane (eager): " + json.dumps(eag["report"]))
    rep_e = eag["report"]
    check(rep_e["frame_replays"] == rep_e["chunk_replays"] == 0
          and rep_e["kernel_launches"] == layers * rep_e["frames"],
          f"eager lane: {rep_e['kernel_launches']} launches, "
          f"{rep_e['frame_replays']} + {rep_e['chunk_replays']} replays "
          f"for {rep_e['frames']} frames")
    check(eag["out"] == out, "the eager lane gives other tokens")
    check(eag["requeued"] == requeued and all(
        rep_e[k] == report[k] for k in (
            "frames", "chunk_passes", "prefill_tokens", "prefix_hits",
            "cow_copies", "preempted", "expired")),
          "the eager lane schedules otherwise")
    check(torch.equal(eag["prints"], cap["prints"]) and all(
        (a[2] is None) == (b[2] is None)
        and (a[2] is None or torch.equal(a[2], b[2]))
        for a, b in zip(cap["log"], eag["log"])),
          "the eager lane's logits differ in bits from the captured lane's")
    print(f"serving lane: captured == eager, bit for bit: tokens of "
          f"{len(out)} requests, logits of {frames} frames")

    # the first frames again from an empty cache, with the plain
    # attention: every prefill pass, page copy and frame in order
    log = cap["log"]
    zero_state(model)
    set_op_attr(model, "decode_attention", "use_kernel", False)
    plain = compiled_decode_step(model, prefill_chunk=LANE_CHUNK)
    diff = 0.0
    for kind, args, logits in log:
        if kind == "step":
            diff = max(diff, float((plain(*args).float() - logits).abs()
                                   .max()))
        elif kind == "prefill":
            plain.prefill(*args)
        else:
            plain.copy_page(*args)
    set_op_attr(model, "decode_attention", "use_kernel", True)
    print(f"serving lane vs plain attention, first {PARITY_FRAMES} frames "
          f"({len(log)} calls): logits max abs diff {diff:.3e} "
          f"(tol {PATH_TOL})")
    check(sum(k == "step" for k, *_ in log) == PARITY_FRAMES,
          "the parity replay lacks frames")
    check(diff <= PATH_TOL, f"lane logits differ by {diff:.3e} > {PATH_TOL}")

    # two sharers that claimed the whole system prompt, served alone
    # without sharing (chunk windows line up: 256 is a multiple of 32)
    sharers = sorted((r for i, r in enumerate(batch[:LANE_SHARERS])
                      if claimed_prefix(i) == LANE_SYS_TOKENS),
                     key=lambda r: len(r.prompt) + r.max_new_tokens)[:2]
    for r in sharers:
        zero_state(model)
        solo = compiled_decode_step(model, prefill_chunk=LANE_CHUNK)
        alone = ContinuousBatchingExecutor(
            solo, max_seqs=FRAME_SLOTS, page_size=FULL["page_size"],
            pages_per_seq=FULL["pages_per_seq"], prefill_fn=solo.prefill,
            prefill_chunk=LANE_CHUNK).run([DecodeRequest(
                rid=r.rid, prompt=r.prompt,
                max_new_tokens=r.max_new_tokens)])
        check(alone[r.rid] == out[r.rid],
              f"{r.rid}: served alone gives other tokens than shared")
    print(f"serving lane: shared == solo for {[r.rid for r in sharers]}")

    annotate.arm()
    try:
        for tag, ctx in (("captured", contextlib.nullcontext()),
                         ("eager", eager())):
            zero_state(model)
            with ctx:
                prof_ex = lane_executor(compiled_decode_step(
                    model, prefill_chunk=LANE_CHUNK), cfg)
                drive_lane(prof_ex, batch, interactive,
                           frames=LANE_PROFILE_WARM)
                prof = profile_window(prof_ex.step, PROFILE_FRAMES, "frame")
            print(f"serving lane profile ({tag}): " + json.dumps(prof))
    finally:
        annotate.disarm()
    return launches, report


# ---------------------------------------------------------------------------
def rel_err(got, ref) -> float:
    """max |got - ref| over max(1, max |ref|), in fp32."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def row_err(got, ref, floor=1e-30) -> float:
    """Max over rows (all but the last dim) of the row's max |got - ref|
    over the larger of the row's max |ref| and ``floor``, in fp32."""
    got, ref = got.float(), ref.float()
    worst = (got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(floor)
    return float(worst.max())


def live_pairs(b, h, sq, sk, causal) -> int:
    """(query, key) pairs the causal end-aligned mask leaves live."""
    if not causal:
        return b * h * sq * sk
    off = sk - sq
    rows = np.clip(np.arange(sq) + off + 1, 0, sk)
    dead = int((np.arange(sq) + off < 0).sum())  # uniform over all keys
    return b * h * (int(rows.sum()) + dead * sk)


def flash_bound_ms(kind, b, h, sq, sk, d, causal, elem_bytes, name):
    """Least time for one kernel's work on this card: each operand read
    once and each output written once (lse and delta fp32 [B, H, Sq]; the
    partial forward's acc fp32 [B, H, Sq, D] and m, l fp32 [B, H, Sq]),
    against the peak rate of the inputs' type (dense bf16 tensor cores;
    fp32 outside the tensor cores) for the products over live pairs:
    2D operations per pair and product, 2 products in the forwards, 3 in
    dq, 4 in dkv."""
    bw, fp32, bf16 = card_peaks(name)
    peak = bf16 if elem_bytes == 2 else fp32
    q_el, k_el = b * sq * h * d, b * sk * h * d
    rows = b * h * sq * 4
    nbytes, products = {
        "fwd": ((2 * q_el + 2 * k_el) * elem_bytes + rows, 2),
        "dq": ((3 * q_el + 2 * k_el) * elem_bytes + 2 * rows, 3),
        "dkv": ((2 * q_el + 4 * k_el) * elem_bytes + 2 * rows, 4),
        "partial": ((q_el + 2 * k_el) * elem_bytes + q_el * 4 + 2 * rows, 2),
    }[kind]
    ops = 2.0 * d * products * live_pairs(b, h, sq, sk, causal)
    t_bytes, t_ops = nbytes / bw * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_operands(b, sq, sk, h, d, dtype, gen):
    dev = torch.device("cuda")
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, h, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, h, d), generator=gen, device=dev).to(dtype)
    do = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
    return q, k, v, do


def flash_errors(q, k, v, do, causal, scale):
    """Each flash kernel against its plain version on the same inputs:
    the backward kernels and their plain versions both take the
    forward kernel's lse and the delta of its output."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    out, lse = fa.flash_forward(q, k, v, causal, scale)
    r_out, r_lse = fa.flash_forward_reference(q, k, v, causal, scale)
    delta = fa._delta(out, do).contiguous()
    args = (q, k, v, do, lse, delta, causal, scale)
    dq = fa.flash_backward_dq(*args)
    dk, dv = fa.flash_backward_dkv(*args)
    r_dq = fa.flash_backward_dq_reference(*args)
    r_dk, r_dv = fa.flash_backward_dkv_reference(*args)
    torch.cuda.synchronize()
    for t in (out, lse, dq, dk, dv):
        check(bool(torch.isfinite(t).all()), "a flash kernel gave "
              "non-finite values")
    return {
        "fwd": max(rel_err(out, r_out), rel_err(lse, r_lse)),
        "fwd_row": row_err(out, r_out),
        "dq": rel_err(dq, r_dq),
        "dkv": max(rel_err(dk, r_dk), rel_err(dv, r_dv)),
        "bwd_row": {"dq": row_err(dq, r_dq, GRAD_ROW_FLOOR),
                    "dk": row_err(dk, r_dk, GRAD_ROW_FLOOR),
                    "dv": row_err(dv, r_dv, GRAD_ROW_FLOOR)},
        "abs": {"fwd": float((out.float() - r_out.float()).abs().max()),
                "dq": float((dq.float() - r_dq.float()).abs().max()),
                "dkv": max(float((dk.float() - r_dk.float()).abs().max()),
                           float((dv.float() - r_dv.float()).abs().max()))},
        "ref_max": {"out": float(r_out.float().abs().max()),
                    "dq": float(r_dq.float().abs().max()),
                    "dk": float(r_dk.float().abs().max()),
                    "dv": float(r_dv.float().abs().max())},
    }


def check_bwd_rows(errs, tag, where):
    """The bf16 backward kernels' dq, dk and dv row by row (``row_err``
    with GRAD_ROW_FLOOR); fp32's readings are printed, not held."""
    if tag not in BWD_ROW_TOL:
        return
    for out, err in errs["bwd_row"].items():
        check(err <= BWD_ROW_TOL[tag],
              f"flash backward {out} vs plain version ({tag}, {where}): "
              f"error {err:.3e} of a row's max > {BWD_ROW_TOL[tag]}")


def bit_equal_backward(q, k, v, do, causal, scale):
    """Two calls of each backward kernel on the same inputs give
    bit-equal dq, dk and dv (each element is written by one block in a
    fixed order, with no atomics)."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    out, lse = fa.flash_forward(q, k, v, causal, scale)
    delta = fa._delta(out, do).contiguous()
    args = (q, k, v, do, lse, delta, causal, scale)
    first = (fa.flash_backward_dq(*args), *fa.flash_backward_dkv(*args))
    second = (fa.flash_backward_dq(*args), *fa.flash_backward_dkv(*args))
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, second))


def phase_flash_kernels(name, seed):
    """The three flash kernels at the training path's shape (B 8, S 1024,
    H 12, D 64, causal) in bf16 and fp32: errors against the plain
    versions, and in each dtype the kernel, plain and library times with
    the bound.  Library: ``scaled_dot_product_attention(is_causal=True)``
    forward for the forward kernel; its backward (dq, dk and dv
    together) for the two backward kernels."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    b, s, h = TRAIN_BATCH, TRAIN["seq_len"], TRAIN["num_heads"]
    d = TRAIN["hidden"] // h
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        q, k, v, do = flash_operands(b, s, s, h, d, dt, gen)
        errs = flash_errors(q, k, v, do, True, scale)
        for kind in ("fwd", "dq", "dkv"):
            check(errs[kind] <= FLASH_TOL[tag],
                  f"flash {kind} kernel vs plain version ({tag}): error "
                  f"{errs[kind]:.3e} > {FLASH_TOL[tag]}")
        check(errs["fwd_row"] <= ROW_TOL[tag],
              f"flash fwd kernel vs plain version ({tag}): out error "
              f"{errs['fwd_row']:.3e} of a row's max > {ROW_TOL[tag]}")
        check_bwd_rows(errs, tag, "training shape")
        check(bit_equal_backward(q, k, v, do, True, scale),
              f"flash backward ({tag}): two calls on the same inputs gave "
              f"different dq, dk or dv")
        out, lse = fa.flash_forward(q, k, v, True, scale)
        delta = fa._delta(out, do).contiguous()
        args = (q, k, v, do, lse, delta, True, scale)
        # the library call on [B, H, S, D] views; with Sq = Sk its
        # top-left causal mask is the end-aligned one
        ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        lib_out = sdpa(ql, kl, vl, is_causal=True)
        dol = do.transpose(1, 2)
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), dol, retain_graph=True), flush)
        timed = {
            "fwd": (lambda: fa.flash_forward(q, k, v, True, scale),
                    lambda: fa.flash_forward_reference(q, k, v, True, scale),
                    time_ms(lambda: sdpa(ql.detach(), kl.detach(),
                                         vl.detach(), is_causal=True),
                            flush)),
            "dq": (lambda: fa.flash_backward_dq(*args),
                   lambda: fa.flash_backward_dq_reference(*args),
                   lib_bwd_ms),
            "dkv": (lambda: fa.flash_backward_dkv(*args),
                    lambda: fa.flash_backward_dkv_reference(*args),
                    lib_bwd_ms),
        }
        for kind, (kernel, plain, library_ms) in timed.items():
            bound_ms, bound_by = flash_bound_ms(kind, b, h, s, s, d, True,
                                                q.element_size(), name)
            results[(kind, tag)] = dict(
                max_abs_err=errs["abs"][kind], rel_err=errs[kind],
                row_err=(errs["fwd_row"] if kind == "fwd" else
                         errs["bwd_row"]["dq"] if kind == "dq" else
                         max(errs["bwd_row"]["dk"], errs["bwd_row"]["dv"])),
                ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush),
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
            print(f"kernel flash_{kind} [{tag}, B={b} S={s} H={h} D={d} "
                  f"causal, {live_pairs(b, h, s, s, True)} live pairs]: "
                  + json.dumps(results[(kind, tag)]))
        print(f"flash plain-version magnitudes [{tag}]: "
              + json.dumps(errs["ref_max"]) + "; backward row errors "
              + json.dumps(errs["bwd_row"]) + "; two calls bit-equal")
    results["sweep"] = sweep_flash_shapes(seed)
    results["hybrid_shapes"] = check_hybrid_flash_shapes(seed)
    return results


def check_hybrid_flash_shapes(seed):
    """The three flash kernels at the per-rank shapes of phase 8's legs
    (HYB_FLASH_SHAPES, causal), bf16 and fp32, against their plain
    versions with the limits of the training shape."""
    out = check_flash_shapes(seed + 12, [
        ("full", b, s, s, h, True) for _, b, s, h in HYB_FLASH_SHAPES])
    print("flash kernels at phase 8's per-rank shapes vs plain versions: "
          + json.dumps(out))
    return out


FULL_ENTRIES = ("ffflash_fwd", "ffflash_bwd_dq", "ffflash_bwd_dkv")


def check_flash_shapes(seed, shapes):
    """Each (kind, B, Sq, Sk, H, causal) of ``shapes`` at D 64, bf16 and
    fp32, against the plain versions: kind "full" is rows 1-3 with the
    training shape's limits (FLASH_TOL, ROW_TOL, BWD_ROW_TOL), kind
    "partial" row 4 with phase 3's partial-kernel limits.  Returns
    {shape key: errors}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = TRAIN["hidden"] // TRAIN["num_heads"]
    scale = 1.0 / math.sqrt(d)
    out = {}
    for kind, b, sq, sk, h, causal in shapes:
        for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            q, k, v, do = flash_operands(b, sq, sk, h, d, dt, gen)
            where = (f"{kind} B={b} Sq={sq} Sk={sk} H={h} D={d} "
                     f"causal={causal}")
            if kind == "partial":
                err, ml_err, _, acc_row = partial_error(q, k, v, causal,
                                                        scale)
                check(err <= FLASH_TOL[tag] and ml_err <= KERNEL_TOL
                      and acc_row <= ROW_TOL[tag],
                      f"partial kernel vs plain version ({tag}, {where}): "
                      f"acc error {err:.3e} > {FLASH_TOL[tag]}, acc row "
                      f"error {acc_row:.3e} > {ROW_TOL[tag]} or m/l error "
                      f"{ml_err:.3e} > {KERNEL_TOL}")
                got = {"acc": err, "acc_row": acc_row, "m_l": ml_err}
            else:
                errs = flash_errors(q, k, v, do, causal, scale)
                for row in ("fwd", "dq", "dkv"):
                    check(errs[row] <= FLASH_TOL[tag],
                          f"flash {row} kernel vs plain version ({tag}, "
                          f"{where}): error {errs[row]:.3e} > "
                          f"{FLASH_TOL[tag]}")
                check(errs["fwd_row"] <= ROW_TOL[tag],
                      f"flash fwd kernel vs plain version ({tag}, {where}): "
                      f"out error {errs['fwd_row']:.3e} of a row's max > "
                      f"{ROW_TOL[tag]}")
                check_bwd_rows(errs, tag, where)
                got = {r: errs[r] for r in ("fwd", "fwd_row", "dq", "dkv",
                                            "bwd_row")}
            key = f"{kind}_{b}x{sq}x{sk}x{h}{'_causal' if causal else ''}"
            out[f"{key}_{tag}"] = got
            del q, k, v, do
    return out


@contextlib.contextmanager
def recorded_flash_launches(into):
    """While open, adds (kernel library entry, B, Sq, Sk, H, causal) of
    every flash kernel launch in this process to the set ``into``.  The
    wrappers' launch counts are untouched."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    launch = fa._launch

    def record(name, tensors, q, k, causal, scale):
        b, sq, h, _ = q.shape
        into.add((name, b, sq, k.shape[1], h, bool(causal)))
        return launch(name, tensors, q, k, causal, scale)

    fa._launch = record
    try:
        yield into
    finally:
        fa._launch = launch


def launches_to_shapes(launches):
    """Recorded launches -> the check_flash_shapes entries covering
    them."""
    return sorted({("partial" if name == "ffflash_fwd_partial" else "full",
                    b, sq, sk, h, causal)
                   for name, b, sq, sk, h, causal in launches})


def shapes_to_launches(shapes):
    """check_flash_shapes entries -> the launches they hold to their
    plain versions."""
    out = set()
    for kind, b, sq, sk, h, causal in shapes:
        for name in (("ffflash_fwd_partial",) if kind == "partial"
                     else FULL_ENTRIES):
            out.add((name, b, sq, sk, h, causal))
    return out


def strategy_flash_shapes(graph, views):
    """The check_flash_shapes entries of the flash launches the views'
    attention ops make on each rank: a whole sequence on B / dp rows and
    H / r heads (Ulysses: H / (r s) heads) takes rows 1-3; the zigzag
    ring of degree s takes row 4 on half chunks of S / 2s, causal on the
    diagonal blocks and not on the others."""
    out = set()
    for guid, v in views.items():
        op = graph.nodes[guid].op
        if op.op_type.value != "multihead_attention" or not op.uses_flash():
            continue
        bdeg, s, _ = v.dim_degrees
        b = op.input_shapes[0].sizes[0] // bdeg
        seq = op.input_shapes[0].sizes[1]
        h = op.attrs["num_heads"] // v.replica_degree
        causal = bool(op.attrs["causal"])
        if s > 1 and not op._use_ulysses(s):
            half = seq // (2 * s)
            out |= {("partial", b, half, half, h, c) for c in {causal, False}}
        else:
            out.add(("full", b, seq, seq, h // s, causal))
    return sorted(out)


def sweep_flash_shapes(seed):
    """Every head dim the flash kernels take (16 to 128 by 16), causal
    and not, Sq = Sk, Sq < Sk and Sq > Sk, ragged lengths, bf16 and
    fp32, against the plain versions; head dims 8 and 144 are refused."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    pairs = ((1, 1), (17, 17), (100, 100), (1000, 1000), (17, 100),
             (100, 17), (1, 1000), (1000, 1), (130, 64)) + TILE_EDGE_PAIRS
    worst = {"fp32": 0.0, "bf16": 0.0}
    worst_row = {"fp32": 0.0, "bf16": 0.0}
    worst_bwd_row = {tag: dict.fromkeys(("dq", "dk", "dv"), 0.0)
                     for tag in ("fp32", "bf16")}
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for causal in (False, True):
            for sq, sk in pairs:
                for d in fa.HEAD_DIMS:
                    q, k, v, do = flash_operands(2, sq, sk, 2, d, dt, gen)
                    errs = flash_errors(q, k, v, do, causal,
                                        1.0 / math.sqrt(d))
                    err = max(errs[kind] for kind in ("fwd", "dq", "dkv"))
                    where = f"sweep causal={causal} Sq={sq} Sk={sk} D={d}"
                    check(err <= FLASH_TOL[tag]
                          and errs["fwd_row"] <= ROW_TOL[tag],
                          f"flash {where} {tag}: error {err:.3e} > "
                          f"{FLASH_TOL[tag]} or fwd row error "
                          f"{errs['fwd_row']:.3e} > {ROW_TOL[tag]}")
                    check_bwd_rows(errs, tag, where)
                    worst[tag] = max(worst[tag], err)
                    worst_row[tag] = max(worst_row[tag], errs["fwd_row"])
                    for out, e in errs["bwd_row"].items():
                        worst_bwd_row[tag][out] = max(
                            worst_bwd_row[tag][out], e)
    for d in (8, 144):
        q = torch.zeros((1, 4, 1, d), device="cuda")
        try:
            fa.flash_forward(q, q, q, False, 1.0)
            fail(f"flash head dim {d} was not refused")
        except ValueError:
            pass
    print(f"flash shape sweep: D 16..128 x causal/not x (Sq, Sk) in "
          f"{list(pairs)} x fp32/bf16, worst error {json.dumps(worst)}, "
          f"worst fwd row error {json.dumps(worst_row)}, worst backward "
          f"row error {json.dumps(worst_bwd_row)}; D=8 and D=144 refused")
    return {"worst": worst, "worst_fwd_row": worst_row,
            "worst_bwd_row": worst_bwd_row}


# ---------------------------------------------------------------------------
def partial_error(q, k, v, causal, scale):
    """The partial forward kernel against its plain version: (error of
    acc over max(1, |plain acc|), worst of m and l likewise, max abs
    error of acc, acc's error row by row (``row_err``))."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    got = fa.flash_forward_partial(q, k, v, causal, scale)
    ref = fa.flash_forward_partial_reference(q, k, v, causal, scale)
    torch.cuda.synchronize()
    for t in got:
        check(bool(torch.isfinite(t).all()), "the partial kernel gave "
              "non-finite values")
    return (rel_err(got[0], ref[0]),
            max(rel_err(got[1], ref[1]), rel_err(got[2], ref[2])),
            float((got[0] - ref[0]).abs().max()), row_err(got[0], ref[0]))


def phase_partial_kernel(name, seed):
    """Kernel row 4, the partial-output flash forward, at the zigzag
    ring's half-chunk shape on the SP path (B 2, Sq = Sk = SP seq / 2n =
    512, H 12, D 64), bf16 (the path's dtype) and fp32, causal (the
    diagonal blocks) and not (the others): errors against the plain
    version, and the kernel, plain and library times with the bound.  No
    PyTorch call returns (acc, m, l): the library figure is
    ``scaled_dot_product_attention``'s forward at the same shape, the
    nearest one.  Then a sweep over head dims and (Sq, Sk) pairs."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    b, s, h = SP_BATCH, SP_HALF_CHUNK, SP["num_heads"]
    d = SP["hidden"] // h
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        q, k, v, _ = flash_operands(b, s, s, h, d, dt, gen)
        ql, kl, vl = (t.transpose(1, 2) for t in (q, k, v))
        for causal in (False, True):
            err, ml_err, abs_err, acc_row = partial_error(q, k, v, causal,
                                                          scale)
            check(err <= FLASH_TOL[tag] and ml_err <= KERNEL_TOL
                  and acc_row <= ROW_TOL[tag],
                  f"partial kernel vs plain version ({tag}, causal="
                  f"{causal}): acc error {err:.3e} > {FLASH_TOL[tag]}, "
                  f"acc row error {acc_row:.3e} > {ROW_TOL[tag]} or m/l "
                  f"error {ml_err:.3e} > {KERNEL_TOL}")
            bound_ms, bound_by = flash_bound_ms(
                "partial", b, h, s, s, d, causal, q.element_size(), name)
            key = f"{tag}{'_causal' if causal else ''}"
            results[key] = dict(
                max_abs_err=abs_err, rel_err=err, row_err=acc_row,
                m_l_rel_err=ml_err,
                ms=time_ms(lambda: fa.flash_forward_partial(
                    q, k, v, causal, scale), flush),
                plain_ms=time_ms(lambda: fa.flash_forward_partial_reference(
                    q, k, v, causal, scale), flush),
                library_ms=time_ms(lambda: sdpa(ql, kl, vl,
                                                is_causal=causal), flush),
                library_call="scaled_dot_product_attention forward (returns "
                             "the normalized output, not (acc, m, l))",
                bound_ms=bound_ms, bound_by=bound_by)
            print(f"kernel flash_forward_partial [{key}, B={b} Sq=Sk={s} "
                  f"H={h} D={d}, {live_pairs(b, h, s, s, causal)} live "
                  f"pairs]: " + json.dumps(results[key]))
    results["sweep"] = sweep_partial_shapes(seed)
    return results


def sweep_partial_shapes(seed):
    """Every head dim the kernel takes, causal and not, Sq <= Sk pairs
    (the ring's calls) and Sq > Sk ones (rows with no live key, which
    must give the XLA twin's m = -1e30, l = Sk, acc = sum of v), bf16 and
    fp32, against the plain version; head dims 8 and 144 are refused."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    pairs = ((1, 1), (17, 17), (100, 100), (512, 512), (17, 100),
             (1, 1000), (64, 512), (130, 1000), (100, 17),
             (130, 64)) + TILE_EDGE_PAIRS
    worst = {"fp32": 0.0, "bf16": 0.0}
    worst_row = {"fp32": 0.0, "bf16": 0.0}
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for causal in (False, True):
            for sq, sk in pairs:
                for d in fa.HEAD_DIMS:
                    q, k, v, _ = flash_operands(2, sq, sk, 2, d, dt, gen)
                    err, ml_err, _, acc_row = partial_error(
                        q, k, v, causal, 1.0 / math.sqrt(d))
                    check(err <= FLASH_TOL[tag] and ml_err <= KERNEL_TOL
                          and acc_row <= ROW_TOL[tag],
                          f"partial sweep {tag} causal={causal} Sq={sq} "
                          f"Sk={sk} D={d}: acc error {err:.3e}, acc row "
                          f"error {acc_row:.3e}, m/l error {ml_err:.3e}")
                    worst[tag] = max(worst[tag], err, ml_err)
                    worst_row[tag] = max(worst_row[tag], acc_row)
    for d in (8, 144):
        q = torch.zeros((1, 4, 1, d), device="cuda")
        try:
            fa.flash_forward_partial(q, q, q, False, 1.0)
            fail(f"partial kernel: head dim {d} was not refused")
        except ValueError:
            pass
    print(f"partial shape sweep: D 16..128 x causal/not x (Sq, Sk) in "
          f"{list(pairs)} x fp32/bf16, worst error {json.dumps(worst)}, "
          f"worst acc row error {json.dumps(worst_row)}; D=8 and D=144 "
          f"refused")
    return {"worst": worst, "worst_acc_row": worst_row}


# ---------------------------------------------------------------------------
def path_parity(model, inputs, labels):
    """The first batch's loss and gradients on the flash route against
    the use_flash=False route (``attn_core``), at the same weights, in
    the model's bf16 compute and again in fp32 compute; and each route's
    time for that forward and backward (synchronised, median of 3 after
    one warm-up call)."""
    compiled = model.compiled

    def run(flash):
        set_op_attr(model, "multihead_attention", "use_flash", flash)
        out = compiled.loss_and_grads(model.params, model.state, inputs,
                                      labels)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compiled.loss_and_grads(model.params, model.state, inputs,
                                    labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        set_op_attr(model, "multihead_attention", "use_flash", True)
        return out[0], out[3], float(np.median(times)) * 1e3

    report = {}
    for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        compiled.compute_dtype = dt
        loss_f, g_f, ms_f = run(True)
        loss_x, g_x, ms_x = run(False)
        worst, worst_name, by_group = 0.0, "", {}
        for op, ws in g_x.items():
            for w, ref in ws.items():
                err = float((g_f[op][w] - ref).norm()
                            / ref.norm().clamp_min(1e-30))
                group = op.split("_")[0]  # layer<i>, or the op itself
                by_group[group] = max(by_group.get(group, 0.0), err)
                if err > worst:
                    worst, worst_name = err, f"{op}/{w}"
        report[tag] = {
            "loss_flash": float(loss_f), "loss_plain_route": float(loss_x),
            "loss_rel_err": abs(float(loss_f) - float(loss_x))
            / abs(float(loss_x)),
            "grad_worst_rel_norm_err": worst, "grad_worst_weight": worst_name,
            "grad_worst_rel_norm_err_by_op_group": by_group,
            "fwd_bwd_ms_flash": ms_f, "fwd_bwd_ms_plain_route": ms_x}
        del g_f, g_x
    compiled.compute_dtype = model.config.torch_compute_dtype
    return report


def train_tensors(model):
    """Every tensor a training step updates in place: the weights, then
    the optimizer state."""
    from torch.utils import _pytree as pytree

    return [t for t in pytree.tree_leaves((model.params, model.opt_state))
            if isinstance(t, torch.Tensor)]


@torch.no_grad()
def restore(model, snapshot):
    """Put the weights and the optimizer state back, in place (the
    captured steps hold their addresses)."""
    for t, s in zip(train_tensors(model), snapshot):
        t.copy_(s)


def same_bits(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_train(seed, name):
    from flexflow_tpu_torch import AdamOptimizer, FFConfig
    from flexflow_tpu_torch.compiler.graphs import eager
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.models import build_gpt

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = FFConfig(batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                   seed=seed)
    model = build_gpt(cfg, **TRAIN)
    model.compile(optimizer=AdamOptimizer(alpha=ADAM_ALPHA),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    torch.cuda.synchronize()
    n_params = sum(w.numel() for ws in model.params.values()
                   for w in ws.values())
    flops = sum(n.op.flops() for n in model.graph.nodes.values())
    print(f"training path: compiled in {time.perf_counter() - t0:.2f} s, "
          f"{n_params} parameters, forward FLOPs per step {flops:.6e}")

    rng = np.random.default_rng(seed + 3)
    ids = rng.integers(0, TOKEN_RANGE, size=(
        TRAIN_BATCHES * TRAIN_BATCH, TRAIN["seq_len"] + 1)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    dev = model.compiled.device
    first = ([torch.from_numpy(x[:TRAIN_BATCH]).to(dev)],
             torch.from_numpy(y[:TRAIN_BATCH]).to(dev))
    parity = path_parity(model, *first)
    print("training path vs use_flash=False route, first batch: "
          + json.dumps(parity))
    del first

    kernels = (fa.flash_forward, fa.flash_backward_dq,
               fa.flash_backward_dkv)
    layers = TRAIN["num_layers"]
    start = [t.clone() for t in train_tensors(model)]
    graph = model.compiled.step_graph
    batches = [([torch.from_numpy(x[i:i + TRAIN_BATCH]).to(dev)],
                torch.from_numpy(y[i:i + TRAIN_BATCH]).to(dev))
               for i in range(0, TIMED_STEPS * TRAIN_BATCH, TRAIN_BATCH)]

    def train_step(batch):
        model.params, model.opt_state, model.state, loss, _ = (
            model.compiled.train_step(model.params, model.opt_state,
                                      model.state, *batch))
        return loss

    # k steps captured (the first call captures), eager, and as one
    # train_steps call over the stacked batches (its capture): bit-equal
    # losses and weights
    k = TRACE_STEPS
    stepwise = {}
    for tag, ctx in (("captured", contextlib.nullcontext()),
                     ("eager", eager())):
        restore(model, start)
        with ctx:
            losses = [train_step(b).clone() for b in batches[:k]]
        stepwise[tag] = (torch.stack(losses).cpu(),
                         [t.clone() for t in train_tensors(model)])
    restore(model, start)
    *_, stacked, _ = model.compiled.train_steps(
        model.params, model.opt_state, model.state,
        [torch.stack([b[0][0] for b in batches[:k]])],
        torch.stack([b[1] for b in batches[:k]]))
    stepwise["train_steps"] = (stacked.cpu(),
                               [t.clone() for t in train_tensors(model)])
    ref_losses, ref_tensors = stepwise["captured"]
    for tag, (ls, ts) in stepwise.items():
        check(torch.equal(ls, ref_losses) and same_bits(ts, ref_tensors),
              f"{k} training steps {tag}: losses {ls.tolist()} or weights "
              f"differ in bits from the captured steps' "
              f"{ref_losses.tolist()}")
    print(f"training path: {k} steps captured == eager == one "
          f"train_steps({k}) call, losses and weights bit for bit: "
          f"{ref_losses.tolist()}")
    del stepwise, ref_tensors
    per_replay = {r["shapes"][0][0]: r["captured_launches"]
                  for r in graph.report()}
    want = {n: {kn.__name__: layers * n for kn in kernels} for n in (1, k)}
    check(per_replay == want,
          f"captured launches per replay {per_replay}, wanted {want}")

    def fit(tag, trace_steps, eager_fit):
        """``fit`` over the seeded batches from the start weights, with
        the launch counts set to 0 just before."""
        restore(model, start)
        model.config.trace_steps = trace_steps
        for kn in kernels:
            kn.launches = 0
        replays0 = replays(graph)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with eager() if eager_fit else contextlib.nullcontext():
            history = model.fit(x, y, batch_size=TRAIN_BATCH,
                                epochs=TRAIN_EPOCHS, shuffle=False,
                                verbose=False)
        wall = time.perf_counter() - t0
        model.config.trace_steps = 1
        losses = model.step_losses
        launches = {kn.__name__: kn.launches for kn in kernels}
        bf16_peak = card_peaks(name)[2]
        report = {
            "fit": tag, "trace_steps": trace_steps, "steps": len(losses),
            "fit_wall_s": wall, "samples_per_s": model.last_throughput,
            "tokens_per_s": model.last_throughput * TRAIN["seq_len"],
            "mfu_vs_dense_bf16_peak": 3.0 * flops * model.last_throughput
            / TRAIN_BATCH / bf16_peak,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss_first_step": losses[0], "loss_last_step": losses[-1],
            "epoch_history": history, "kernel_launches": launches,
            "graph_replays": replays(graph) - replays0}
        print(f"training path ({tag}): " + json.dumps(report))
        steps = len(losses)
        check(steps == TRAIN_EPOCHS * TRAIN_BATCHES,
              f"{tag}: {steps} steps ran")
        calls = 0 if eager_fit else steps // trace_steps
        check(report["graph_replays"] == calls,
              f"{tag}: {report['graph_replays']} replays, wanted {calls}")
        for kname, n in launches.items():
            check(n == layers * steps,
                  f"{tag}: {kname}: {n} launches for {steps} steps of "
                  f"{layers} layers")
            if not eager_fit:
                each = per_replay.get(trace_steps, {}).get(kname)
                check(each is not None and n == each * calls,
                      f"{tag}: {kname}: {n} launches, not {each} per "
                      f"replay x {calls} replays")
        check(bool(np.isfinite(losses).all()),
              f"{tag}: a step's loss is not finite")
        return losses, [t.clone() for t in train_tensors(model)], report

    losses, after, report = fit("captured", 1, False)
    final = model.evaluate(x[:TRAIN_BATCH], y[:TRAIN_BATCH])
    print("training path step losses: "
          + json.dumps([round(v, 5) for v in losses]))
    check(final["loss"] < losses[0],
          f"first batch's loss did not fall: {losses[0]:.4f} at step 1, "
          f"{final['loss']:.4f} after training")
    launches = report["kernel_launches"]
    for tag, n, eager_fit in ((f"trace_steps={k}", k, False),
                              ("eager", 1, True)):
        got, got_after, _ = fit(tag, n, eager_fit)
        check(got == losses and same_bits(got_after, after),
              f"fit {tag}: step losses or weights differ in bits from "
              f"fit with trace_steps=1, captured")
    print(f"training path: fit captured == fit trace_steps={k} == fit "
          f"eager, {len(losses)} step losses and the weights bit for bit")
    del after

    # step time: synchronised steps over the first batches
    for tag, ctx in (("captured", contextlib.nullcontext()),
                     ("eager", eager())):
        restore(model, start)
        times = []
        with ctx:
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            print(f"training path step time ({tag}, synchronised steps): "
                  + json.dumps({
                      "steps": len(times),
                      "p50_ms": float(np.median(times)) * 1e3,
                      "p99_ms": float(np.quantile(times, 0.99)) * 1e3}))
            it = iter(batches)
            print(f"training path profile ({tag}): " + json.dumps(
                profile_window(lambda: train_step(next(it)), PROFILE_STEPS,
                               "step")))

    for tag, par in parity.items():
        check(par["loss_rel_err"] <= LOSS_PATH_TOL[tag],
              f"{tag}: flash route loss differs from the use_flash=False "
              f"route by {par['loss_rel_err']:.3e} > {LOSS_PATH_TOL[tag]}")
        check(par["grad_worst_rel_norm_err"] <= GRAD_PATH_TOL[tag],
              f"{tag}: flash route gradient of {par['grad_worst_weight']} "
              f"differs by {par['grad_worst_rel_norm_err']:.3e} > "
              f"{GRAD_PATH_TOL[tag]}")
    return launches, losses[0]


# ---------------------------------------------------------------------------
def sp_strategy(model, n):
    """The pure sequence-parallel strategy: every op whose output has a
    sequence dim split n ways on it, the rest trivial."""
    from flexflow_tpu_torch.core.machine import MachineView

    views = {}
    for node in model.graph.topo_order():
        nd = node.op.output_shapes[0].ndim
        views[node.guid] = (MachineView((1, n) + (1,) * (nd - 2))
                            if nd >= 2 else MachineView.trivial(nd))
    return views


def gpt_model(seed, dtype, layers, widths, batch, num_devices, strategy,
              sp_mode=None):
    from flexflow_tpu_torch import AdamOptimizer, FFConfig
    from flexflow_tpu_torch.models import build_gpt

    cfg = FFConfig(batch_size=batch, compute_dtype=dtype, seed=seed,
                   num_devices=num_devices)
    model = build_gpt(cfg, **dict(widths, num_layers=layers))
    if sp_mode:
        set_op_attr(model, "multihead_attention", "sp_mode", sp_mode)
    model.compile(optimizer=AdamOptimizer(alpha=ADAM_ALPHA),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"],
                  strategy=strategy(model) if strategy else None)
    return model


def _sp_rank(rank, seed, ids):
    """One rank of the SP phase: the fp32 parity step at
    SP_PARITY_LAYERS layers, then the full-width bf16 model through
    ``fit`` for SP_STEPS steps with the launch and host-hop counts set to
    0 just before, then synchronised steps and (rank 0) a profile."""
    import torch.distributed as dist

    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel import mesh
    from flexflow_tpu_torch.runtime.distributed import (
        local_seq_slice,
        transport,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    x, y = ids[:, :-1], ids[:, 1:]

    def strategy(model):
        return sp_strategy(model, n)

    model = gpt_model(seed, "float32", SP_PARITY_LAYERS, SP, SP_BATCH, n,
                      strategy)
    model.fit(x[:SP_BATCH], y[:SP_BATCH], shuffle=False, verbose=False)
    loss_fp32 = model.step_losses[0]
    del model
    gc.collect()
    torch.cuda.empty_cache()

    model = gpt_model(seed, "bfloat16", SP["num_layers"], SP, SP_BATCH, n,
                      strategy)
    flops = sum(nd.op.flops() for nd in model.graph.nodes.values())
    kernels = (fa.flash_forward_partial, fa.flash_forward,
               fa.flash_backward_dq, fa.flash_backward_dkv)
    for k in kernels:
        k.launches = 0
    mesh.reset_comm_counts()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    history = model.fit(x[:SP_STEPS * SP_BATCH], y[:SP_STEPS * SP_BATCH],
                        batch_size=SP_BATCH, shuffle=False, verbose=False)
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    hops = mesh.comm_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    rows = slice(*local_seq_slice(SP["seq_len"]))
    dev = model.compiled.device
    batches = [([torch.from_numpy(np.ascontiguousarray(
        x[i:i + SP_BATCH, rows])).to(dev)], torch.from_numpy(
            np.ascontiguousarray(y[i:i + SP_BATCH, rows])).to(dev))
        for i in range(0, (SP_TIMED_STEPS + SP_PROFILE_STEPS) * SP_BATCH,
                       SP_BATCH)]

    def train_step(batch):
        model.params, model.opt_state, model.state, loss, _ = (
            model.compiled.train_step(model.params, model.opt_state,
                                      model.state, *batch))
        return loss

    times = []
    for batch in batches[:SP_TIMED_STEPS]:
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    it = iter(batches[SP_TIMED_STEPS:])
    profile = None
    if rank == 0:
        profile = profile_window(lambda: train_step(next(it)),
                                 SP_PROFILE_STEPS, "step")
    else:
        for batch in it:
            train_step(batch)
    torch.cuda.synchronize()
    return {"transport": transport(), "device": str(torch.cuda.current_device()),
            "loss_fp32_first_step": loss_fp32,
            "losses": list(model.step_losses), "history": history,
            "fit_wall_s": fit_wall, "samples_per_s": model.last_throughput,
            "launches": launches, "host_hops": hops, "peak_memory_gb": peak_gb,
            "step_times_s": times, "profile": profile, "flops": flops}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_sp_train(seed, name):
    """Sequence-parallel training of the full-width GPT at seq 4096 over
    SP_RANKS ranks (one process each, ``torch.multiprocessing`` spawn):
    one card per rank with NCCL when the machine has SP_RANKS cards,
    else every rank on card 0 with the shared-card transport (gloo, host
    hops).  First the one-process references of the first step's loss on
    the flash route (fp32 at SP_PARITY_LAYERS layers, bf16 at full
    width) in this process, then the ranks."""
    from flexflow_tpu_torch.runtime.distributed import spawn

    gc.collect()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    shared = cards < SP_RANKS
    if shared:
        mode = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.split()
        check(bool(mode) and mode[0] == "Default",
              f"compute mode {mode}: {SP_RANKS} ranks cannot share card 0 "
              f"unless it is Default")
    rng = np.random.default_rng(seed + 9)
    ids = rng.integers(0, TOKEN_RANGE, size=(
        max(SP_STEPS, SP_TIMED_STEPS + SP_PROFILE_STEPS) * SP_BATCH,
        SP["seq_len"] + 1)).astype(np.int32)

    refs = {}
    for tag, dtype, layers in (("fp32", "float32", SP_PARITY_LAYERS),
                               ("bf16", "bfloat16", SP["num_layers"])):
        model = gpt_model(seed, dtype, layers, SP, SP_BATCH, 1, None)
        check(all(nd.op.uses_flash() for nd in model.graph.nodes.values()
                  if hasattr(nd.op, "uses_flash")),
              "the one-process reference must take the flash route")
        dev = model.compiled.device
        loss, _ = model.compiled.eval_step(
            model.params, model.state,
            [torch.from_numpy(ids[:SP_BATCH, :-1]).to(dev)],
            torch.from_numpy(ids[:SP_BATCH, 1:]).to(dev))
        refs[tag] = float(loss)
        del model, loss
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn(_sp_rank, SP_RANKS, (seed, ids),
                  init_method=f"tcp://localhost:{free_port()}",
                  device="cuda", timeout=SP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    want_transport = "gloo-host" if shared else "nccl"
    cards_used = 1 if shared else SP_RANKS
    losses = r0["losses"]
    steps = len(losses)
    step_max = [max(r["step_times_s"][i] for r in ranks)
                for i in range(SP_TIMED_STEPS)]
    bf16_peak = card_peaks(name)[2]
    samples_per_s = r0["samples_per_s"]
    parity = {
        "fp32": {"layers": SP_PARITY_LAYERS, "one_process": refs["fp32"],
                 "sp": r0["loss_fp32_first_step"]},
        "bf16": {"layers": SP["num_layers"], "one_process": refs["bf16"],
                 "sp": losses[0]}}
    for tag, par in parity.items():
        par["rel_err"] = abs(par["sp"] - par["one_process"]) / abs(
            par["one_process"])
        par["tol"] = SP_LOSS_TOL[tag]
    report = {
        "ranks": SP_RANKS, "cards_used": cards_used,
        "transport": [r["transport"] for r in ranks],
        "rank_devices": [r["device"] for r in ranks],
        "steps": steps, "phase_wall_s": wall,
        "fit_wall_s": [r["fit_wall_s"] for r in ranks],
        "samples_per_s": samples_per_s,
        "tokens_per_s": samples_per_s * SP["seq_len"],
        "mfu_vs_dense_bf16_peak": 3.0 * r0["flops"] * samples_per_s
        / SP_BATCH / (bf16_peak * cards_used),
        "step_p50_ms": float(np.median(step_max)) * 1e3,
        "step_p99_ms": float(np.quantile(step_max, 0.99)) * 1e3,
        "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in ranks],
        "collectives_per_rank_per_step": [
            {k: {u: c / steps for u, c in v.items()}
             for k, v in r["host_hops"].items() if v["calls"]}
            for r in ranks],
        "kernel_launches_per_rank": [r["launches"] for r in ranks],
        "loss_first_step": losses[0], "loss_last_step": losses[-1],
        "ln_token_range": math.log(TOKEN_RANGE),
        "first_step_parity": parity, "epoch_history": r0["history"]}
    print("sp training path: " + json.dumps(report))
    print("sp training path step losses: "
          + json.dumps([round(v, 5) for v in losses]))
    print("sp training path profile (rank 0): " + json.dumps(r0["profile"]))

    want_partial = SP["num_layers"] * (2 * SP_RANKS + 1) * steps
    check(steps == SP_STEPS, f"{steps} SP steps ran")
    for i, r in enumerate(ranks):
        check(r["transport"] == want_transport,
              f"rank {i}: transport {r['transport']}, want {want_transport}")
        check(r["losses"] == losses, f"rank {i} reports other losses")
        got = r["launches"]
        check(got["flash_forward_partial"] == want_partial,
              f"rank {i}: {got['flash_forward_partial']} partial-kernel "
              f"launches for {steps} steps, want {want_partial}")
        for k in ("flash_forward", "flash_backward_dq", "flash_backward_dkv"):
            check(got[k] == 0, f"rank {i}: {k} launched {got[k]} times on "
                  f"the SP path")
        hopped = r["host_hops"]["ppermute"]["host_hops"]
        check((hopped > 0) == shared, f"rank {i}: {hopped} host hops with "
              f"transport {r['transport']}")
    check(bool(np.isfinite(losses).all()), "an SP step's loss is not finite")
    check(losses[-1] < losses[0], f"SP loss did not fall: {losses[0]:.4f} "
          f"at step 1, {losses[-1]:.4f} at step {steps}")
    for tag, par in parity.items():
        check(par["rel_err"] <= par["tol"],
              f"SP {tag} first-step loss {par['sp']:.6f} vs one process "
              f"{par['one_process']:.6f}: {par['rel_err']:.3e} > "
              f"{par['tol']}")
    return r0["launches"], report, refs


# ---------------------------------------------------------------------------
def megatron_strategy(model):
    """Megatron dp 2 x tp 2: MHA (2, 1, 1) r 2, ff1 (2, 1, 2), ff2 (2, 1,
    1) r 2, every other op split 2 ways on its batch dim where it can
    be."""
    from flexflow_tpu_torch.core.machine import MachineView

    views = {}
    for node in model.graph.topo_order():
        op = node.op
        nd = op.output_shapes[0].ndim
        degs = [1] * nd
        if nd and 0 in op.splittable_output_dims():
            degs[0] = 2
        views[node.guid] = MachineView(tuple(degs))
        if op.op_type.value == "multihead_attention" or op.name.endswith(
                "_ff2"):
            views[node.guid] = MachineView((2, 1, 1), replica_degree=2)
        elif op.name.endswith("_ff1"):
            views[node.guid] = MachineView((2, 1, 2))
    return views


def weight_blocks(model):
    """Per weight: (this rank's block coordinates, sha1 of its bits)."""
    import hashlib

    c = model.compiled
    out = {}
    for op, ws in model.params.items():
        for w, t in ws.items():
            pl = c.weight_placement(op, w)
            key = [c.mesh.index(axes) if axes else 0 for axes in pl.dims]
            raw = t.detach().contiguous().view(torch.uint8).cpu().numpy()
            out[f"{op}/{w}"] = (key, hashlib.sha1(raw.tobytes()).hexdigest())
    return out


def _hybrid_rank(rank, seed, ids, ids_u):
    """One rank of the hybrid phase: Megatron dp x tp (the fp32 parity step at
    HYB_PARITY_LAYERS layers, then the full-width bf16 model through
    ``fit`` for HYB_STEPS steps with the launch and collective counts
    set to 0 just before, synchronised steps, a profile on rank 0, the
    weight blocks' digests), then Ulysses (``fit`` for ULYSSES_STEPS
    steps, counts set to 0 just before)."""
    import torch.distributed as dist

    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel import mesh
    from flexflow_tpu_torch.runtime.distributed import transport

    torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    x, y = ids[:, :-1], ids[:, 1:]
    kernels = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv,
               fa.flash_forward_partial)

    def drive(model, xs, ys, batch):
        """``fit`` with every count set to 0 just before: (wall s,
        launches, collectives, history)."""
        for k in kernels:
            k.launches = 0
        mesh.reset_comm_counts()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        history = model.fit(xs, ys, batch_size=batch, shuffle=False,
                            verbose=False)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0,
                {k.__name__: k.launches for k in kernels},
                mesh.comm_counts(), history)

    model = gpt_model(seed, "float32", HYB_PARITY_LAYERS, TRAIN,
                         TRAIN_BATCH, n, megatron_strategy)
    model.fit(x[:TRAIN_BATCH], y[:TRAIN_BATCH], shuffle=False, verbose=False)
    loss_fp32 = model.step_losses[0]
    del model
    gc.collect()
    torch.cuda.empty_cache()

    model = gpt_model(seed, "bfloat16", TRAIN["num_layers"], TRAIN,
                         TRAIN_BATCH, n, megatron_strategy)
    heads = {nd.op.name: model.params[nd.op.name]["wq"].shape[1]
             for nd in model.graph.nodes.values()
             if nd.op.op_type.value == "multihead_attention"}
    flops = sum(nd.op.flops() for nd in model.graph.nodes.values())
    wall, launches, comms, history = drive(
        model, x[:HYB_STEPS * TRAIN_BATCH], y[:HYB_STEPS * TRAIN_BATCH],
        TRAIN_BATCH)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = list(model.step_losses)
    samples_per_s = model.last_throughput
    c, dev = model.compiled, model.compiled.device

    def local(a, rows, labels=False):
        blk = a[rows]
        sl = c.label_slices(blk.shape) if labels else c.input_slices(
            0, blk.shape)
        return torch.from_numpy(np.ascontiguousarray(blk[sl])).to(dev)

    batches = []
    for i in range(HYB_TIMED_STEPS + HYB_PROFILE_STEPS):
        rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        batches.append(([local(x, rows)], local(y, rows, labels=True)))

    def train_step(batch):
        model.params, model.opt_state, model.state, loss, _ = c.train_step(
            model.params, model.opt_state, model.state, *batch)
        return loss

    times = []
    for batch in batches[:HYB_TIMED_STEPS]:
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    it = iter(batches[HYB_TIMED_STEPS:])
    profile = None
    if rank == 0:
        profile = profile_window(lambda: train_step(next(it)),
                                 HYB_PROFILE_STEPS, "step")
    else:
        for batch in it:
            train_step(batch)
    torch.cuda.synchronize()
    megatron = {"transport": transport(), "losses": losses,
                "loss_fp32_first_step": loss_fp32, "history": history,
                "fit_wall_s": wall, "samples_per_s": samples_per_s,
                "launches": launches, "collectives": comms,
                "peak_memory_gb": peak_gb, "step_times_s": times,
                "profile": profile,
                "local_heads": sorted(set(heads.values())), "flops": flops,
                "blocks": weight_blocks(model)}
    del model, c
    gc.collect()
    torch.cuda.empty_cache()

    def sp_views(model):
        return sp_strategy(model, n)

    model = gpt_model(seed, "bfloat16", SP["num_layers"], SP, SP_BATCH, n,
                         sp_views, sp_mode="ulysses")
    heads_u = sorted({nd.op.attrs["num_heads"] // n
                      for nd in model.graph.nodes.values()
                      if nd.op.op_type.value == "multihead_attention"})
    wall_u, launches_u, comms_u, _ = drive(
        model, ids_u[:, :-1], ids_u[:, 1:], SP_BATCH)
    ulysses = {"losses": list(model.step_losses), "fit_wall_s": wall_u,
               "samples_per_s": model.last_throughput,
               "launches": launches_u, "collectives": comms_u,
               "local_heads": heads_u,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    return {"megatron": megatron, "ulysses": ulysses,
            "device": str(torch.cuda.current_device())}


def phase_hybrid_train(seed, name, first_loss_bf16, sp_refs):
    """Hybrid-parallel training over HYB_RANKS ranks (spawned as phase
    7's: one card each with NCCL on a 4-card machine, else all on card 0
    through gloo with counted host hops): Megatron dp 2 x tp 2 of phase
    6's model on phase 6's batches, then Ulysses at phase 7's shape on
    phase 7's batches.  The one-process references: phase 6's first
    step (bf16, full width) and phase 7's (bf16 at seq 4096), and the
    fp32 first step at HYB_PARITY_LAYERS layers, computed here."""
    from flexflow_tpu_torch.runtime.distributed import spawn

    gc.collect()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    shared = cards < HYB_RANKS
    rng = np.random.default_rng(seed + 3)  # phase 6's batches
    ids = rng.integers(0, TOKEN_RANGE, size=(
        TRAIN_BATCHES * TRAIN_BATCH, TRAIN["seq_len"] + 1)).astype(np.int32)
    ids = ids[:max(HYB_STEPS, HYB_TIMED_STEPS + HYB_PROFILE_STEPS)
              * TRAIN_BATCH]
    rng = np.random.default_rng(seed + 9)  # phase 7's batches
    ids_u = rng.integers(0, TOKEN_RANGE, size=(
        ULYSSES_STEPS * SP_BATCH, SP["seq_len"] + 1)).astype(np.int32)

    model = gpt_model(seed, "float32", HYB_PARITY_LAYERS, TRAIN,
                         TRAIN_BATCH, 1, None)
    check(all(nd.op.uses_flash() for nd in model.graph.nodes.values()
              if hasattr(nd.op, "uses_flash")),
          "the one-process reference must take the flash route")
    dev = model.compiled.device
    loss, _ = model.compiled.eval_step(
        model.params, model.state,
        [torch.from_numpy(ids[:TRAIN_BATCH, :-1]).to(dev)],
        torch.from_numpy(ids[:TRAIN_BATCH, 1:]).to(dev))
    ref_fp32 = float(loss)
    del model, loss
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn(_hybrid_rank, HYB_RANKS, (seed, ids, ids_u),
                  init_method=f"tcp://localhost:{free_port()}",
                  device="cuda", timeout=SP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    want_transport = "gloo-host" if shared else "nccl"
    cards_used = 1 if shared else HYB_RANKS
    bf16_peak = card_peaks(name)[2]
    meg = [r["megatron"] for r in ranks]
    uly = [r["ulysses"] for r in ranks]
    m0, u0 = meg[0], uly[0]
    steps, steps_u = len(m0["losses"]), len(u0["losses"])
    step_max = [max(r["step_times_s"][i] for r in meg)
                for i in range(HYB_TIMED_STEPS)]
    parity = {
        "megatron_fp32": {"layers": HYB_PARITY_LAYERS,
                          "one_process": ref_fp32,
                          "hybrid": m0["loss_fp32_first_step"]},
        "megatron_bf16": {"layers": TRAIN["num_layers"],
                          "one_process": first_loss_bf16,
                          "hybrid": m0["losses"][0]},
        "ulysses_bf16": {"layers": SP["num_layers"],
                         "one_process": sp_refs["bf16"],
                         "hybrid": u0["losses"][0]}}
    for tag, par in parity.items():
        par["rel_err"] = abs(par["hybrid"] - par["one_process"]) / abs(
            par["one_process"])
        par["tol"] = SP_LOSS_TOL["fp32" if tag.endswith("fp32") else "bf16"]

    def per_step(counts, k):
        return {c: {u: v / k for u, v in cnt.items()}
                for c, cnt in counts.items() if cnt["calls"]}

    report = {
        "ranks": HYB_RANKS, "cards_used": cards_used,
        "transport": [r["megatron"]["transport"] for r in ranks],
        "rank_devices": [r["device"] for r in ranks],
        "phase_wall_s": wall,
        "megatron": {
            "strategy": "dp 2 x tp 2", "steps": steps,
            "local_heads": m0["local_heads"],
            "fit_wall_s": [r["fit_wall_s"] for r in meg],
            "samples_per_s": m0["samples_per_s"],
            "tokens_per_s": m0["samples_per_s"] * TRAIN["seq_len"],
            "mfu_vs_dense_bf16_peak": 3.0 * m0["flops"]
            * m0["samples_per_s"] / TRAIN_BATCH / (bf16_peak * cards_used),
            "step_p50_ms": float(np.median(step_max)) * 1e3,
            "step_p99_ms": float(np.quantile(step_max, 0.99)) * 1e3,
            "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in meg],
            "collectives_per_rank_per_step": [
                per_step(r["collectives"], steps) for r in meg],
            "kernel_launches_per_rank": [r["launches"] for r in meg],
            "loss_first_step": m0["losses"][0],
            "loss_last_step": m0["losses"][-1],
            "epoch_history": m0["history"]},
        "ulysses": {
            "strategy": "sp 4, sp_mode ulysses", "steps": steps_u,
            "local_heads": u0["local_heads"],
            "fit_wall_s": [r["fit_wall_s"] for r in uly],
            "samples_per_s": u0["samples_per_s"],
            "tokens_per_s": u0["samples_per_s"] * SP["seq_len"],
            "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in uly],
            "collectives_per_rank_per_step": [
                per_step(r["collectives"], steps_u) for r in uly],
            "kernel_launches_per_rank": [r["launches"] for r in uly],
            "losses": u0["losses"]},
        "first_step_parity": parity}
    print("hybrid training path: " + json.dumps(report))
    print("hybrid training path step losses (megatron): "
          + json.dumps([round(v, 5) for v in m0["losses"]]))
    print("hybrid training path profile (megatron, rank 0): "
          + json.dumps(m0["profile"]))

    layers = TRAIN["num_layers"]
    check(steps == HYB_STEPS, f"{steps} Megatron steps ran")
    check(steps_u == ULYSSES_STEPS, f"{steps_u} Ulysses steps ran")
    rows = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
    for i, (m, u) in enumerate(zip(meg, uly)):
        check(m["transport"] == want_transport,
              f"rank {i}: transport {m['transport']}, want {want_transport}")
        check(m["losses"] == m0["losses"] and u["losses"] == u0["losses"],
              f"rank {i} reports other losses")
        for leg, r, k, n in (("megatron", m, steps, layers),
                             ("ulysses", u, steps_u, SP["num_layers"])):
            for kname in rows:
                check(r["launches"][kname] == n * k,
                      f"rank {i} {leg}: {kname} launched "
                      f"{r['launches'][kname]} times in {k} steps, want "
                      f"{n * k}")
            check(r["launches"]["flash_forward_partial"] == 0,
                  f"rank {i} {leg}: the partial kernel launched")
        hopped = m["collectives"]["all_reduce_sum"]["host_hops"]
        check((hopped > 0) == shared, f"rank {i}: {hopped} host hops with "
              f"transport {m['transport']}")
        check(u["collectives"]["all_to_all"]["calls"] > 0,
              f"rank {i}: the Ulysses leg ran no all-to-all")
    check(m0["local_heads"] == [TRAIN["num_heads"] // 2],
          f"Megatron local heads {m0['local_heads']}")
    check(u0["local_heads"] == [SP["num_heads"] // HYB_RANKS],
          f"Ulysses local heads {u0['local_heads']}")
    for leg, ls in (("megatron", m0["losses"]), ("ulysses", u0["losses"])):
        check(bool(np.isfinite(ls).all()), f"a {leg} step's loss is not "
              f"finite")
        check(ls[-1] < ls[0], f"{leg} loss did not fall: {ls[0]:.4f} at "
              f"step 1, {ls[-1]:.4f} at step {len(ls)}")
    blocks = {}
    for i, m in enumerate(meg):
        for wname, (key, digest) in m["blocks"].items():
            seen = blocks.setdefault((wname, tuple(key)), digest)
            check(seen == digest, f"rank {i}: replica of {wname} block "
                  f"{key} differs in bits after the last step")
    print(f"hybrid training path: {len(blocks)} weight blocks, every "
          f"replica bit-equal after "
          f"{steps + HYB_TIMED_STEPS + HYB_PROFILE_STEPS} steps")
    for tag, par in parity.items():
        check(par["rel_err"] <= par["tol"],
              f"{tag} first-step loss {par['hybrid']:.6f} vs one process "
              f"{par['one_process']:.6f}: {par['rel_err']:.3e} > "
              f"{par['tol']}")
    return ({k: m0["launches"][k] for k in rows},
            {k: u0["launches"][k] for k in rows}, report)


# ---------------------------------------------------------------------------
def search_config(seed, num_devices, **kw):
    """Phase 9's FFConfig: phase 6's dtype and batch, the H100 spec at
    ``num_devices`` (FFConfig's default), the proposal flags off and no
    search deadline, so every search of the phase is the same function
    of the graph and the calibration table."""
    from flexflow_tpu_torch import FFConfig

    return FFConfig(batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                    seed=seed, num_devices=num_devices, search_timeout_s=0,
                    enable_pipeline_search=False,
                    enable_placement_search=False, **kw)


def views_by_class(graph, views):
    """Op class -> {view: count}."""
    out = {}
    for guid, v in views.items():
        kind = graph.nodes[guid].op.op_type.value
        out.setdefault(kind, {})
        out[kind][str(v)] = out[kind].get(str(v), 0) + 1
    return out


def expected_attention_launches(graph, views, steps):
    """Kernel launches the views' attention ops make in ``steps``
    training steps: a sequence split of degree s on the zigzag ring is
    2 s + 1 partial-forward (row 4) calls per layer per step, a whole
    sequence one call of each of rows 1-3."""
    want = {"flash_forward": 0, "flash_backward_dq": 0,
            "flash_backward_dkv": 0, "flash_forward_partial": 0}
    for guid, v in views.items():
        op = graph.nodes[guid].op
        if op.op_type.value != "multihead_attention":
            continue
        s = v.dim_degrees[1]
        if s > 1 and not op._use_ulysses(s):
            want["flash_forward_partial"] += (2 * s + 1) * steps
        else:
            for k in ("flash_forward", "flash_backward_dq",
                      "flash_backward_dkv"):
                want[k] += steps
    return want


def link_probes(mesh):
    """On NCCL: {"link_latency_s": [per replay], "reshard_overhead_s":
    {median, p10, p90}, "allreduce_4b_host_s": median}.  The link
    latency is the device's: LINK_PROBE_RUNS 4-byte all-reduces captured
    in one CUDA graph, its replay timed between two CUDA events
    (LINK_PROBE_REPEATS replays, each timed), each all-reduce over its 2
    (n - 1) ring hops.  The reshard overhead is the host's: one
    batch-split to replicated reshard of a 128 KB activation, timed by
    the host clock to its synchronise (LINK_PROBE_RUNS calls), less its
    bytes at NVLink's and HBM's rates: what a boundary costs an eager
    step beyond its bytes."""
    import torch.distributed as dist

    from flexflow_tpu_torch.core.machine import MachineSpec
    from flexflow_tpu_torch.parallel.mesh import Placement, reshard

    n = dist.get_world_size()
    spec = MachineSpec.h100_sxm(n)

    def host_s(fn):
        for _ in range(5):
            fn()
        times = []
        for _ in range(LINK_PROBE_RUNS):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return np.asarray(times)

    x = torch.ones(1, device="cuda")
    allreduce_host = float(np.median(host_s(lambda: dist.all_reduce(x))))
    # the device's time alone: the all-reduces captured in one CUDA graph,
    # so no host gap between them lands in the window
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            dist.all_reduce(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LINK_PROBE_RUNS):
            dist.all_reduce(x)
    graph.replay()
    hop = []
    for _ in range(LINK_PROBE_REPEATS):
        dist.barrier()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        hop.append(start.elapsed_time(end) * 1e-3 / LINK_PROBE_RUNS
                   / (2 * (n - 1)))
    act = torch.ones(RESHARD_PROBE_SHAPE, device="cuda")
    nd = len(RESHARD_PROBE_SHAPE)
    src = Placement((tuple(mesh.names),) + ((),) * (nd - 1))
    shard = act.narrow(0, 0, RESHARD_PROBE_SHAPE[0] // n).contiguous()
    t = host_s(lambda: reshard(shard, src, Placement.replicated(nd), mesh))
    nbytes = act.numel() * act.element_size()
    beyond = (t - nbytes * (n - 1) / n / spec.ici_bandwidth
              - 2.0 * nbytes / spec.hbm_bandwidth)
    return {"link_latency_s": hop,
            "reshard_overhead_s": {
                "median": float(np.median(beyond)),
                "p10": float(np.quantile(beyond, 0.1)),
                "p90": float(np.quantile(beyond, 0.9))},
            "allreduce_4b_host_s": allreduce_host}


def _searched_rank(rank, seed, ids, cal_path, cache_path, strat_path):
    """One rank of phase 9: compile(strategy=None) (rank 0 searches with
    the table, here served by the search's cost cache, and sends every
    rank its export), the export's round trip, ``fit`` SEARCH_STEPS
    steps with the launch and collective counts set to 0 just before,
    the weight blocks; then the same model under data parallelism and
    under compile(strategy=None) with FFConfig's defaults (no
    calibration: the roofline search), 2 x SEARCH_TIMED_BLOCK synchronised
    steps of each in blocks (A B C C B A); every flash launch's shape;
    on NCCL the link probes."""
    import torch.distributed as dist

    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.models import build_gpt
    from flexflow_tpu_torch.parallel import mesh
    from flexflow_tpu_torch.runtime import distributed
    from flexflow_tpu_torch.runtime.distributed import transport
    from flexflow_tpu_torch.search.cost_cache import stable_graph_digest
    from flexflow_tpu_torch.search.strategy_io import import_strategy

    torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    x, y = ids[:, :-1], ids[:, 1:]
    kernels = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv,
               fa.flash_forward_partial)
    compile_kw = dict(optimizer=AdamOptimizer(alpha=ADAM_ALPHA),
                      loss_type="sparse_categorical_crossentropy",
                      metrics=["accuracy"])
    shapes = set()

    def timed_steps(model, k):
        """k synchronised steps: (seconds, loss) each."""
        c, dev = model.compiled, model.compiled.device
        out = []
        for i in range(k):
            rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
            xb, yb = x[rows], y[rows]
            ins = [torch.from_numpy(np.ascontiguousarray(
                xb[c.input_slices(0, xb.shape)])).to(dev)]
            lab = torch.from_numpy(np.ascontiguousarray(
                yb[c.label_slices(yb.shape)])).to(dev)
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.params, model.opt_state, model.state, loss, _ = (
                c.train_step(model.params, model.opt_state, model.state,
                             ins, lab))
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0, float(loss)))
        return out

    cfg = search_config(seed, n, calibration_file=cal_path,
                        cost_cache_file=cache_path)
    model = build_gpt(cfg, **TRAIN)
    t0 = time.perf_counter()
    model.compile(**compile_kw)
    compile_s = time.perf_counter() - t0
    graph, views = model.graph, model.strategy
    imported = import_strategy(strat_path, graph)
    flops = sum(nd.op.flops() for nd in graph.nodes.values())
    for k in kernels:
        k.launches = 0
    mesh.reset_comm_counts()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    with recorded_flash_launches(shapes):
        history = model.fit(x, y, batch_size=TRAIN_BATCH, shuffle=False,
                            verbose=False)
    torch.cuda.synchronize()
    out = {"transport": transport(), "device": str(torch.cuda.current_device()),
           "digest": stable_graph_digest(graph),
           "round_trip": {g: str(v) for g, v in imported.items()}
           == {g: str(v) for g, v in views.items()},
           "views": {graph.nodes[g].op.name: str(v) for g, v in views.items()},
           "search_stats": model.search_stats, "compile_s": compile_s,
           "fit_wall_s": time.perf_counter() - t0, "history": history,
           "losses": list(model.step_losses),
           "samples_per_s": model.last_throughput,
           "launches": {k.__name__: k.launches for k in kernels},
           "want_launches": expected_attention_launches(
               graph, views, len(model.step_losses)),
           "collectives": mesh.comm_counts(),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "flops": flops}
    out["blocks"] = weight_blocks(model)

    dp = build_gpt(search_config(seed, n), **TRAIN)
    dp.compile(strategy=data_parallel_strategy(dp.graph, n), **compile_kw)
    default = build_gpt(search_config(seed, n), **TRAIN)
    default.compile(**compile_kw)
    out["default_digest"] = stable_graph_digest(default.graph)
    out["default_views"] = {default.graph.nodes[g].op.name: str(v)
                            for g, v in default.strategy.items()}
    # one untimed step each on the first batch: the default pick's is
    # its first-step loss
    out["warmup"] = {tag: timed_steps(m, 1)[0]
                     for tag, m in (("data_parallel", dp),
                                    ("default", default))}
    models = {"searched": model, "data_parallel": dp, "default": default}
    out["timed"] = {tag: [] for tag in models}
    order = list(models) + list(models)[::-1]
    with recorded_flash_launches(shapes):
        for tag in order:
            out["timed"][tag].append(timed_steps(models[tag],
                                                 SEARCH_TIMED_BLOCK))
    out["timed_order"] = order
    out["flash_shapes"] = sorted(shapes)
    del model, dp, default, models
    gc.collect()
    torch.cuda.empty_cache()
    out["link_probes"] = (link_probes(distributed.mesh())
                          if out["transport"] == "nccl" else None)
    return out


def first_step_loss(seed):
    """Phase 6's first step alone: its model, first batch and loss (one
    process, bf16, eager), for a run of phase 9 without phases 1-8."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig
    from flexflow_tpu_torch.compiler.graphs import eager
    from flexflow_tpu_torch.models import build_gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_gpt(FFConfig(batch_size=TRAIN_BATCH,
                               compute_dtype="bfloat16", seed=seed), **TRAIN)
    model.compile(optimizer=AdamOptimizer(alpha=ADAM_ALPHA),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    rng = np.random.default_rng(seed + 3)
    ids = rng.integers(0, TOKEN_RANGE, size=(
        TRAIN_BATCH, TRAIN["seq_len"] + 1)).astype(np.int32)
    dev = model.compiled.device
    with eager():
        loss = model.compiled.train_step(
            model.params, model.opt_state, model.state,
            [torch.from_numpy(ids[:, :-1]).to(dev)],
            torch.from_numpy(ids[:, 1:]).to(dev))[3]
    first = float(loss)
    print(f"phase 6's first step alone: loss {first}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return first


def phase_searched_train(seed, name, first_loss_bf16, calibration_out=None):
    """Phase 9, the searched path: (a) calibrate phase 6's model for
    SEARCH_RANKS ranks on the card, (b) run the strategy search on
    ``MachineSpec.h100_sxm(4)`` with that table, and the uncalibrated
    (roofline) search of FFConfig's defaults, then hold the flash
    kernels to their plain versions at every shape the calibration
    launched and the strategies will, (c) spawn the ranks (as phases
    7-8) to compile with ``strategy=None`` and train, and (d) round-trip
    the exported strategy.  Copies the calibration table to
    ``calibration_out`` when given.  Returns each attention kernel's
    launches: the calibration's, and rank 0's under the searched
    strategy."""
    import shutil
    import tempfile

    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
    from flexflow_tpu_torch.core.machine import MachineView
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.models import build_gpt
    from flexflow_tpu_torch.obs.metrics import METRICS
    from flexflow_tpu_torch.runtime.distributed import spawn
    from flexflow_tpu_torch.search import driver, strategy_io
    from flexflow_tpu_torch.search.calibration import (
        CalibrationTable,
        measure_op_view,
    )
    from flexflow_tpu_torch.search.cost_cache import stable_graph_digest
    from flexflow_tpu_torch.search.simulator import Simulator
    from flexflow_tpu_torch import native

    gc.collect()
    torch.cuda.empty_cache()
    check(native.get_lib() is not None,
          "the native search engines did not build (g++ from native/src)")
    cards = torch.cuda.device_count()
    shared = cards < SEARCH_RANKS
    tmp = tempfile.TemporaryDirectory()
    cal_path = os.path.join(tmp.name, "calibration.json")
    cache_path = os.path.join(tmp.name, "cost_cache.json")
    strat_path = os.path.join(tmp.name, "strategy.json")

    # (a) + (b): one optimize_strategy call, which probes first and
    # reports the two times apart, as the reference's does
    cfg = search_config(seed, SEARCH_RANKS, calibrate=True,
                        calibration_file=cal_path,
                        calibration_budget_s=CAL_BUDGET_S,
                        cost_cache_file=cache_path)
    frontend = build_gpt(cfg, **TRAIN)
    probes = METRICS.counter("calibration.probes")
    native_hits = METRICS.counter("dp.native_hits")
    probes0, hits0 = probes.value, native_hits.value
    for k in (fa.flash_forward, fa.flash_forward_partial):
        k.launches = 0
    cal_shapes = set()
    t0 = time.perf_counter()
    with recorded_flash_launches(cal_shapes):
        graph, views = driver.optimize_strategy(frontend.graph, cfg,
                                                return_graph=True)
    wall = time.perf_counter() - t0
    stats = dict(driver.LAST_SEARCH_STATS)
    cal_launches = {k.__name__: k.launches
                    for k in (fa.flash_forward, fa.flash_forward_partial)}
    table = CalibrationTable.load(cal_path)
    if calibration_out:
        shutil.copyfile(cal_path, calibration_out)
    records = dict(table._t)
    check(table.backend == "cuda", f"calibration backend {table.backend}")
    check(len(records) > 0, "calibration measured no record")
    check(all(math.isfinite(v) and v > 0 for v in records.values()),
          "a calibration record is not finite and positive")
    check(cal_launches["flash_forward"] > 0,
          "the attention probes never launched the flash forward (row 1)")
    spread = {}  # CAL_REPROBES records measured again
    for node in frontend.graph.topo_order():
        kind = node.op.op_type.value
        if kind not in ("multihead_attention", "linear") or kind in spread:
            continue
        mv = views.get(node.guid)
        if mv is None or table.get(node.op, mv) is None:
            mv = MachineView.trivial(node.op.output_shapes[0].ndim)
        recorded = table.get(node.op, mv)
        check(recorded is not None,
              f"no calibration record for {node.op.name} at {mv}")
        with recorded_flash_launches(cal_shapes):
            again = measure_op_view(node.op, mv, device="cuda",
                                    compute_dtype=torch.bfloat16)
        spread[kind] = {"op": node.op.name, "view": str(mv),
                        "recorded_ms": recorded * 1e3,
                        "again_ms": again * 1e3, "ratio": again / recorded}
    check(len(spread) == CAL_REPROBES, f"re-probed {sorted(spread)}")
    # the uncalibrated search of FFConfig's defaults: what
    # compile(strategy=None) picks on 4 cards unless asked to calibrate
    dcfg = search_config(seed, SEARCH_RANKS)
    dgraph, dviews = driver.optimize_strategy(
        build_gpt(dcfg, **TRAIN).graph, dcfg, return_graph=True)
    default_s = driver.LAST_SEARCH_STATS["search_seconds"]
    cal = Simulator.for_config(search_config(seed, SEARCH_RANKS),
                               calibration=table)
    roof = Simulator.for_config(search_config(seed, SEARCH_RANKS))
    dp_views = data_parallel_strategy(frontend.graph, SEARCH_RANKS)
    meg_views = megatron_strategy(frontend)
    predicted = {}
    for tag, sim in (("calibrated", cal), ("roofline", roof)):
        predicted[tag] = {
            "searched_ms": sim.simulate(graph, views) * 1e3,
            "data_parallel_ms": sim.simulate(frontend.graph, dp_views) * 1e3,
            "default_ms": sim.simulate(dgraph, dviews) * 1e3,
            "megatron_dp2_tp2_ms": sim.simulate(frontend.graph,
                                                meg_views) * 1e3}
    digest = stable_graph_digest(graph)
    default_digest = stable_graph_digest(dgraph)
    strategy_io.export_strategy(strat_path, graph, views)
    one = search_config(seed, 1)
    driver.optimize_strategy(build_gpt(one, **TRAIN).graph, one,
                             return_graph=True)
    one_rank_s = driver.LAST_SEARCH_STATS["search_seconds"]
    search = {
        "machine": "h100_sxm(4)", "wall_s": wall,
        "calibration_seconds": stats["calibration_seconds"],
        "search_seconds": stats["search_seconds"],
        "one_rank_search_seconds": one_rank_s,
        "default_search_seconds": default_s,
        "calibration_probes": probes.value - probes0,
        "calibration_records": len(records),
        "calibration_row1_launches": cal_launches["flash_forward"],
        "reprobe_spread": spread,
        "native_dp_hits": native_hits.value - hits0,
        "full_sims": stats["full_sims"], "delta_sims": stats["delta_sims"],
        "rewritten": graph.num_nodes != frontend.graph.num_nodes,
        "nodes": [frontend.graph.num_nodes, graph.num_nodes],
        "views_by_op_class": views_by_class(graph, views),
        "default_views_by_op_class": views_by_class(dgraph, dviews),
        "predicted_step": predicted, "digest": digest,
        "default_digest": default_digest}
    print("searched path, calibration and search: " + json.dumps(search))
    check(search["native_dp_hits"] > 0, "the native DP engine never served")

    # the flash kernels against their plain versions at every per-rank
    # shape of this phase: the calibration's launches and the three
    # strategies the ranks will train
    shapes = set(launches_to_shapes(cal_shapes))
    for g, v in ((graph, views), (dgraph, dviews),
                 (frontend.graph, dp_views)):
        shapes.update(strategy_flash_shapes(g, v))
    shapes = sorted(shapes)
    flash_checks = check_flash_shapes(seed + 13, shapes)
    checked = shapes_to_launches(shapes)
    print(f"flash kernels at phase 9's {len(shapes)} per-rank shapes vs "
          f"plain versions: " + json.dumps(flash_checks))
    plain = stable_graph_digest(frontend.graph)
    dp_strs = {g: str(v) for g, v in dp_views.items()}
    searched_is_dp = digest == plain and {
        g: str(v) for g, v in views.items()} == dp_strs
    default_is_dp = default_digest == plain and {
        g: str(v) for g, v in dviews.items()} == dp_strs
    del frontend, table
    gc.collect()

    # (c) + (d): the ranks
    rng = np.random.default_rng(seed + 3)  # phase 6's batches
    ids = rng.integers(0, TOKEN_RANGE, size=(
        TRAIN_BATCHES * TRAIN_BATCH, TRAIN["seq_len"] + 1)).astype(np.int32)
    ids = ids[:SEARCH_STEPS * TRAIN_BATCH]
    t0 = time.perf_counter()
    ranks = spawn(_searched_rank, SEARCH_RANKS,
                  (seed, ids, cal_path, cache_path, strat_path),
                  init_method=f"tcp://localhost:{free_port()}",
                  device="cuda", timeout=SEARCH_TIMEOUT_S)
    phase_wall = time.perf_counter() - t0
    tmp.cleanup()
    r0 = ranks[0]
    # shapes the ranks launched that the prediction above missed: held
    # to their plain versions here
    ran = set()
    for r in ranks:
        ran.update(tuple(x) for x in r["flash_shapes"])
    unpredicted = launches_to_shapes(ran - checked)
    if unpredicted:
        print(f"flash kernels at shapes the ranks ran beyond the "
              f"prediction {unpredicted} vs plain versions: "
              + json.dumps(check_flash_shapes(seed + 14, unpredicted)))
    want_transport = "gloo-host" if shared else "nccl"
    cards_used = 1 if shared else SEARCH_RANKS
    steps = len(r0["losses"])
    tokens = TRAIN_BATCH * TRAIN["seq_len"]
    bf16_peak = card_peaks(name)[2]
    pred = predicted["calibrated"]
    timing = {}
    for tag in ("searched", "data_parallel", "default"):
        blocks = [[max(r["timed"][tag][j][i][0] for r in ranks)
                   for i in range(SEARCH_TIMED_BLOCK)] for j in range(2)]
        p50 = float(np.median(blocks[0] + blocks[1]))
        halves = [float(np.median(b)) for b in blocks]
        timing[tag] = {
            "steps": 2 * SEARCH_TIMED_BLOCK, "step_p50_ms": p50 * 1e3,
            "block_p50_ms": [t * 1e3 for t in halves],
            "block_spread": abs(halves[0] - halves[1]) / p50,
            "tokens_per_s": tokens / p50,
            "predicted_ms": pred[f"{tag}_ms"],
            "predicted_roofline_ms": predicted["roofline"][f"{tag}_ms"],
            "predicted_over_measured": pred[f"{tag}_ms"] / (p50 * 1e3)}
    timing["searched"]["mfu_vs_dense_bf16_peak"] = (
        3.0 * r0["flops"] / (timing["searched"]["step_p50_ms"] * 1e-3)
        / (bf16_peak * cards_used))
    first = r0["losses"][0]
    parity = {"one_process": first_loss_bf16, "searched": first,
              "rel_err": abs(first - first_loss_bf16) / abs(first_loss_bf16),
              "default": r0["warmup"]["default"][1],
              "default_rel_err": abs(r0["warmup"]["default"][1]
                                     - first_loss_bf16)
              / abs(first_loss_bf16),
              "tol": SP_LOSS_TOL["bf16"]}
    transport_tag = ("nccl, one card per rank" if not shared else
                     "shared-card transport (gloo, host copies): not the "
                     "NVLink the simulator prices")
    probes_nccl = r0["link_probes"]
    report = {
        "ranks": SEARCH_RANKS, "cards_used": cards_used,
        "transport": [r["transport"] for r in ranks],
        "rank_devices": [r["device"] for r in ranks],
        "phase_wall_s": phase_wall, "steps": steps,
        "compile_s": [r["compile_s"] for r in ranks],
        "result_cache_hit": r0["search_stats"].get("result_cache_hit"),
        "fit_wall_s": [r["fit_wall_s"] for r in ranks],
        "samples_per_s": r0["samples_per_s"],
        "timed_order": r0["timed_order"], "timing": timing,
        "searched_over_data_parallel": timing["searched"]["step_p50_ms"]
        / timing["data_parallel"]["step_p50_ms"],
        "default_over_data_parallel": timing["default"]["step_p50_ms"]
        / timing["data_parallel"]["step_p50_ms"],
        "searched_is_data_parallel": searched_is_dp,
        "default_is_data_parallel": default_is_dp,
        "ratio_transport": transport_tag,
        "link_probes": probes_nccl,
        "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in ranks],
        "collectives_per_rank_per_step": [
            {c: {u: v / steps for u, v in cnt.items()}
             for c, cnt in r["collectives"].items() if cnt["calls"]}
            for r in ranks],
        "kernel_launches_per_rank": [r["launches"] for r in ranks],
        "flash_shapes_ran": launches_to_shapes(ran),
        "loss_first_step": first, "loss_last_step": r0["losses"][-1],
        "first_step_parity": parity, "epoch_history": r0["history"]}
    print("searched training path: " + json.dumps(report))
    print("searched training path step losses: "
          + json.dumps([round(v, 5) for v in r0["losses"]]))

    check(steps == SEARCH_STEPS, f"{steps} searched steps ran")
    for i, r in enumerate(ranks):
        check(r["transport"] == want_transport,
              f"rank {i}: transport {r['transport']}, want {want_transport}")
        check(r["digest"] == digest,
              f"rank {i}: graph digest {r['digest']}, the search's {digest}")
        check(r["views"] == r0["views"], f"rank {i} lowered other views")
        check(r["default_digest"] == default_digest
              and r["default_views"] == r0["default_views"],
              f"rank {i}: the default compile's graph digest "
              f"{r['default_digest']}, the roofline search's "
              f"{default_digest}, or other views than rank 0's")
        check(r["round_trip"], f"rank {i}: the exported strategy imported "
              f"into other views")
        check(r["losses"] == r0["losses"], f"rank {i} reports other losses")
        for k, want in r["want_launches"].items():
            check(r["launches"][k] == want,
                  f"rank {i}: {k} launched {r['launches'][k]} times in "
                  f"{steps} steps, want {want}")
    check(bool(np.isfinite(r0["losses"]).all()),
          "a searched step's loss is not finite")
    check(r0["losses"][-1] < r0["losses"][0],
          f"searched loss did not fall: {r0['losses'][0]:.4f} at step 1, "
          f"{r0['losses'][-1]:.4f} at step {steps}")
    check(parity["rel_err"] <= parity["tol"],
          f"searched first-step loss {first:.6f} vs one process "
          f"{first_loss_bf16:.6f}: {parity['rel_err']:.3e} > {parity['tol']}")
    check(parity["default_rel_err"] <= parity["tol"],
          f"the default search's first-step loss {parity['default']:.6f} "
          f"vs one process {first_loss_bf16:.6f}: "
          f"{parity['default_rel_err']:.3e} > {parity['tol']}")
    for tag, blocks in r0["timed"].items():
        check(all(math.isfinite(loss) for b in blocks for _, loss in b),
              f"a timed {tag} step's loss is not finite")
    blocks = {}
    for i, r in enumerate(ranks):
        for wname, (key, dig) in r["blocks"].items():
            seen = blocks.setdefault((wname, tuple(key)), dig)
            check(seen == dig, f"rank {i}: replica of {wname} block {key} "
                  f"differs in bits after the last step")
    print(f"searched training path: {len(blocks)} weight blocks, every "
          f"replica bit-equal after {steps} steps")
    return cal_launches, r0["launches"]


# ---------------------------------------------------------------------------
def placed_strategy(model, ranks):
    """Phase 10's placed strategy: the embeddings and layers 0-5 on ranks
    [0, ranks/2) and layers 6-11 and the head on [ranks/2, ranks), each
    block data-parallel over its ranks (``start_part`` 0 and ranks/2)."""
    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
    from flexflow_tpu_torch.core.machine import MachineView

    half = ranks // 2
    views = data_parallel_strategy(model.graph, half)
    last = PIPE_LAYERS_A - 1
    seen_b = False
    for node in model.graph.topo_order():
        name = node.op.name
        if name.startswith("layer") and int(name[5:name.index("_")]) > last:
            seen_b = True
        if seen_b:
            v = views[node.guid]
            views[node.guid] = MachineView(dim_degrees=v.dim_degrees,
                                           replica_degree=v.replica_degree,
                                           start_part=half)
    return views


def pipe_model(seed, dtype, ranks, strategy=None, pipeline=None, **cfg):
    """Phase 6's model and optimizer over ``ranks`` ranks, compiled with
    ``strategy(model)`` or ``pipeline``."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig
    from flexflow_tpu_torch.models import build_gpt

    model = build_gpt(FFConfig(batch_size=TRAIN_BATCH, compute_dtype=dtype,
                               seed=seed, num_devices=ranks, **cfg), **TRAIN)
    model.compile(optimizer=AdamOptimizer(alpha=ADAM_ALPHA),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"],
                  strategy=strategy(model) if strategy else None,
                  pipeline=pipeline)
    return model


def pipe_weight_blocks(model):
    """Per weight this rank holds: (its block's coordinates on the mesh
    that holds it, sha1 of its bits)."""
    import hashlib

    c = model.compiled
    out = {}
    for op, ws in model.params.items():
        mesh = (c.segments[c._op_segment[op]].comp.mesh
                if hasattr(c, "segments") else c.mesh)
        for w, t in ws.items():
            pl = c.weight_placement(op, w)
            key = [mesh.index(axes) if axes else 0 for axes in pl.dims]
            raw = t.detach().contiguous().view(torch.uint8).cpu().numpy()
            out[f"{op}/{w}"] = (key, hashlib.sha1(raw.tobytes()).hexdigest())
    return out


def leg_model(ranks, **cfg):
    """``__graft_entry__.py``'s search-discovered pipeline leg: four
    memory-bound prime-width blocks and a head, fp32, batch 16."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer

    model = FFModel(FFConfig(batch_size=16, num_devices=ranks,
                             compute_dtype="float32", search_timeout_s=0,
                             **cfg))
    t = model.create_tensor([16, 1021])
    for i in range(4):
        t = model.dense(t, 1021, activation="relu", name=f"layer{i}_fc")
    model.dense(t, 1021, name="head")
    model.compile(optimizer=SGDOptimizer(lr=0.01),
                  loss_type="mean_squared_error", metrics=[])
    return model


def leg_spec():
    """``MachineSpec.h100_sxm(4)`` cut to two hosts of 2 cards with the
    leg's 48 MB of device memory: no flat strategy fits, so the search
    must propose a pipeline (the leg's own spec is a CPU one with the
    same cut)."""
    import dataclasses

    from flexflow_tpu_torch.core.machine import MachineSpec

    return dataclasses.replace(MachineSpec.h100_sxm(PIPE_RANKS),
                               devices_per_host=PIPE_RANKS // 2,
                               hbm_capacity=48e6)


def _pipeline_rank(rank, seed, ids, leg_x, leg_y):
    """One rank of phase 10: the pipelined lowering (pp 2 x dp 2, M 4),
    then the placed one (two blocks of 2 ranks), each through ``fit``
    for PIPE_STEPS steps with the launch and collective counts set to 0
    just before and PIPE_TIMED_STEPS synchronised steps after, with the
    weight blocks' digests; then ``compile(strategy=None)`` with
    FFConfig's defaults and PIPE_DEFAULT_STEPS ``fit`` steps; then the
    search-discovered leg's one step.  Every flash launch's shape is
    recorded."""
    import torch.distributed as dist

    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel import mesh
    from flexflow_tpu_torch.parallel.pipeline import PipelineConfig
    from flexflow_tpu_torch.runtime.distributed import transport
    from flexflow_tpu_torch.search.cost_cache import stable_graph_digest

    torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    x, y = ids[:, :-1], ids[:, 1:]
    kernels = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv,
               fa.flash_forward_partial)
    shapes = set()

    def drive(model, steps):
        """``fit`` with every count set to 0 just before."""
        for k in kernels:
            k.launches = 0
        mesh.reset_comm_counts()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        with recorded_flash_launches(shapes):
            history = model.fit(x[:steps * TRAIN_BATCH],
                                y[:steps * TRAIN_BATCH],
                                batch_size=TRAIN_BATCH, shuffle=False,
                                verbose=False)
        torch.cuda.synchronize()
        return {"fit_wall_s": time.perf_counter() - t0,
                "launches": {k.__name__: k.launches for k in kernels},
                "collectives": mesh.comm_counts(), "history": history,
                "losses": list(model.step_losses),
                "samples_per_s": model.last_throughput,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}

    def timed(model, first, k):
        """k synchronised steps on the batches from ``first`` on."""
        c, dev = model.compiled, model.compiled.device
        out = []
        for i in range(first, first + k):
            rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
            xb, yb = x[rows], y[rows]
            ins = [torch.from_numpy(np.ascontiguousarray(
                xb[c.input_slices(0, xb.shape)])).to(dev)]
            lab = torch.from_numpy(np.ascontiguousarray(
                yb[c.label_slices(yb.shape)])).to(dev)
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorded_flash_launches(shapes):
                model.params, model.opt_state, model.state, loss, _ = (
                    c.train_step(model.params, model.opt_state, model.state,
                                 ins, lab))
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    out = {"transport": transport(), "device": str(torch.cuda.current_device())}
    legs = (("pipelined", dict(pipeline=PipelineConfig(
                 num_stages=PIPE_STAGES, num_microbatches=PIPE_MICRO))),
            ("placed", dict(strategy=lambda m: placed_strategy(m, n))))
    for leg, kw in legs:
        t0 = time.perf_counter()
        model = pipe_model(seed, "bfloat16", n, **kw)
        res = {"compile_s": time.perf_counter() - t0,
               "kind": type(model.compiled).__name__,
               "held": sorted(model.params)}
        res.update(drive(model, PIPE_STEPS))
        res["step_times_s"] = timed(model, PIPE_STEPS, PIPE_TIMED_STEPS)
        res["blocks"] = pipe_weight_blocks(model)
        out[leg] = res
        del model
        gc.collect()
        torch.cuda.empty_cache()

    model = pipe_model(seed, "bfloat16", n, search_timeout_s=0)
    res = {"kind": type(model.compiled).__name__,
           "digest": stable_graph_digest(model.graph),
           "views": sorted({str(v) for v in model.strategy.values()})}
    res.update(drive(model, PIPE_DEFAULT_STEPS))
    out["default"] = res
    del model
    gc.collect()
    torch.cuda.empty_cache()

    model = leg_model(n, machine_spec=leg_spec())
    c, dev = model.compiled, model.compiled.device
    ins = [torch.from_numpy(np.ascontiguousarray(
        leg_x[c.input_slices(0, leg_x.shape)])).to(dev)]
    lab = torch.from_numpy(np.ascontiguousarray(
        leg_y[c.label_slices(leg_y.shape)])).to(dev)
    loss = c.train_step(model.params, model.opt_state, model.state, ins,
                        lab)[3]
    p = getattr(c, "pipeline", None)
    out["leg"] = {"kind": type(c).__name__, "loss": float(loss),
                  "pipeline": None if p is None else [p.num_stages,
                                                      p.num_microbatches]}
    out["flash_shapes"] = sorted(shapes)
    return out


def phase_pipeline_train(seed, name, first_loss_bf16):
    """Phase 10, pipeline and inter-op placement over PIPE_RANKS ranks
    (spawned as phases 7-9): phase 6's model on phase 6's batches,
    pipelined (pp 2 x dp 2, M 4), placed (two blocks of 2 ranks), and
    lowered as ``compile(strategy=None)`` picks with FFConfig's
    defaults; then the search-discovered pipeline leg.  Before the ranks
    spawn, the flash kernels are held to their plain versions at every
    per-rank shape the legs imply, and the default pick is computed here
    for the ranks' to equal.  Returns each attention kernel's launches
    per rank under the pipelined and the placed legs."""
    import dataclasses

    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.models import build_gpt
    from flexflow_tpu_torch.runtime.distributed import spawn
    from flexflow_tpu_torch.search import strategy_io
    from flexflow_tpu_torch.search.cost_cache import stable_graph_digest

    gc.collect()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    shared = cards < PIPE_RANKS
    rng = np.random.default_rng(seed + 3)  # phase 6's batches
    ids = rng.integers(0, TOKEN_RANGE, size=(
        TRAIN_BATCHES * TRAIN_BATCH, TRAIN["seq_len"] + 1)).astype(np.int32)
    ids = ids[:(PIPE_STEPS + PIPE_TIMED_STEPS) * TRAIN_BATCH]
    rng = np.random.default_rng(seed + 11)
    leg_x = rng.normal(size=(16, 1021)).astype(np.float32)
    leg_y = rng.normal(size=(16, 1021)).astype(np.float32)

    # the default pick, searched here as rank 0 will
    dcfg = FFConfig(batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                    seed=seed, num_devices=PIPE_RANKS, search_timeout_s=0)
    graph, export, _, proposal = build_gpt(dcfg, **TRAIN)._search("training")
    meta = export.get(strategy_io.META_KEY) or {}
    want_default = ("PlacedCompiledModel" if "placement" in meta else
                    "StagedPipelinedModel" if proposal is not None else
                    "PipelinedCompiledModel" if "pipeline" in meta else
                    "CompiledModel")
    want_digest = stable_graph_digest(graph)
    views = strategy_io.strategy_from_dict(export, graph)
    dp_default = {v.dim_degrees[0] for v in views.values()
                  if v.dim_degrees}
    per_rank = TRAIN_BATCH // max(dp_default)

    # the leg's one-process step (fp32, no TF32) and its proposal
    one = leg_model(1, only_data_parallel=True,
                    machine_spec=dataclasses.replace(leg_spec(),
                                                     num_devices=1))
    dev = one.compiled.device
    leg_ref = float(one.compiled.train_step(
        one.params, one.opt_state, one.state,
        [torch.from_numpy(leg_x).to(dev)], torch.from_numpy(leg_y).to(dev))[3])
    del one

    heads = TRAIN["num_heads"]
    micro = TRAIN_BATCH // (PIPE_RANKS // PIPE_STAGES) // PIPE_MICRO
    predicted = [("full", micro, TRAIN["seq_len"], TRAIN["seq_len"], heads,
                  True),
                 ("full", TRAIN_BATCH // (PIPE_RANKS // 2), TRAIN["seq_len"],
                  TRAIN["seq_len"], heads, True),
                 ("full", per_rank, TRAIN["seq_len"], TRAIN["seq_len"],
                  heads, True)]
    predicted = sorted(set(predicted))
    flash_errs = check_flash_shapes(seed, predicted)
    print("flash kernels at phase 10's per-rank shapes vs plain versions: "
          + json.dumps(flash_errs))

    t0 = time.perf_counter()
    ranks = spawn(_pipeline_rank, PIPE_RANKS, (seed, ids, leg_x, leg_y),
                  init_method=f"tcp://localhost:{free_port()}",
                  device="cuda", timeout=SP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    want_transport = "gloo-host" if shared else "nccl"
    cards_used = 1 if shared else PIPE_RANKS
    bf16_peak = card_peaks(name)[2]
    layers = TRAIN["num_layers"]
    rows = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
    want_launches = {"pipelined": layers // PIPE_STAGES * PIPE_MICRO,
                     "placed": layers // 2,
                     "default": layers}
    report = {"ranks": PIPE_RANKS, "cards_used": cards_used,
              "transport": [r["transport"] for r in ranks],
              "rank_devices": [r["device"] for r in ranks],
              "phase_wall_s": wall}
    flops = sum(nd.op.flops() for nd in graph.nodes.values())
    for leg in ("pipelined", "placed", "default"):
        legs = [r[leg] for r in ranks]
        r0 = legs[0]
        steps = len(r0["losses"])
        entry = {"kind": r0["kind"], "steps": steps,
                 "fit_wall_s": [r["fit_wall_s"] for r in legs],
                 "samples_per_s": r0["samples_per_s"],
                 "peak_memory_gb_per_rank": [r["peak_memory_gb"]
                                             for r in legs],
                 "kernel_launches_per_rank": [r["launches"] for r in legs],
                 "launches_per_rank_per_step": {
                     k: r0["launches"][k] / steps for k in rows},
                 "collectives_per_rank_per_step": [
                     {c: {u: v / steps for u, v in cnt.items()}
                      for c, cnt in r["collectives"].items() if cnt["calls"]}
                     for r in legs],
                 "host_bytes_per_rank_per_step": [
                     sum(cnt["host_bytes"] for cnt in r["collectives"]
                         .values()) / steps for r in legs],
                 "loss_first_step": r0["losses"][0],
                 "loss_last_step": r0["losses"][-1],
                 "first_step_rel_err_vs_one_process": abs(
                     r0["losses"][0] - first_loss_bf16) / abs(
                         first_loss_bf16)}
        if "step_times_s" in r0:
            step_max = [max(r["step_times_s"][i] for r in legs)
                        for i in range(PIPE_TIMED_STEPS)]
            entry["step_p50_ms"] = float(np.median(step_max)) * 1e3
            entry["step_p99_ms"] = float(np.quantile(step_max, 0.99)) * 1e3
            entry["tokens_per_s"] = (TRAIN_BATCH * TRAIN["seq_len"]
                                     / float(np.median(step_max)))
            entry["mfu_vs_dense_bf16_peak"] = (
                3.0 * flops / float(np.median(step_max))
                / (bf16_peak * cards_used))
            entry["held_ops_per_rank"] = [len(r["held"]) for r in legs]
        if leg == "default":
            entry.update({"digest": r0["digest"], "views": r0["views"],
                          "want_kind": want_default,
                          "want_digest": want_digest})
        report[leg] = entry
    leg0 = ranks[0]["leg"]
    report["search_proposes"] = dict(
        leg0, one_process_loss=leg_ref,
        rel_err=abs(leg0["loss"] - leg_ref) / abs(leg_ref),
        spec="h100_sxm(4), 2 hosts of 2, hbm 48e6")
    print("pipeline training path: " + json.dumps(report))

    for i, r in enumerate(ranks):
        check(r["transport"] == want_transport,
              f"rank {i}: transport {r['transport']}, want {want_transport}")
    for leg, kind in (("pipelined", "PipelinedCompiledModel"),
                      ("placed", "PlacedCompiledModel"),
                      ("default", want_default)):
        legs = [r[leg] for r in ranks]
        r0 = legs[0]
        steps = len(r0["losses"])
        want_steps = PIPE_DEFAULT_STEPS if leg == "default" else PIPE_STEPS
        check(steps == want_steps, f"{leg}: {steps} steps ran")
        for i, r in enumerate(legs):
            check(r["kind"] == kind, f"rank {i} {leg}: lowered {r['kind']}, "
                  f"want {kind}")
            check(r["losses"] == r0["losses"],
                  f"rank {i} {leg}: reports other losses")
            for kname in rows:
                got = r["launches"][kname]
                check(got == want_launches[leg] * steps,
                      f"rank {i} {leg}: {kname} launched {got} times in "
                      f"{steps} steps, want {want_launches[leg] * steps}")
            check(r["launches"]["flash_forward_partial"] == 0,
                  f"rank {i} {leg}: the partial kernel launched")
            hops = sum(c["host_hops"] for c in r["collectives"].values())
            check((hops > 0) == shared,
                  f"rank {i} {leg}: {hops} host hops with transport "
                  f"{ranks[i]['transport']}")
        ls = r0["losses"]
        check(bool(np.isfinite(ls).all()), f"a {leg} step's loss is not "
              f"finite")
        rel = abs(ls[0] - first_loss_bf16) / abs(first_loss_bf16)
        check(rel <= SP_LOSS_TOL["bf16"],
              f"{leg} first-step loss {ls[0]:.6f} vs one process "
              f"{first_loss_bf16:.6f}: {rel:.3e} > {SP_LOSS_TOL['bf16']}")
        if leg != "default":
            check(ls[-1] < ls[0], f"{leg} loss did not fall: {ls[0]:.4f} "
                  f"at step 1, {ls[-1]:.4f} at step {len(ls)}")
            blocks = {}
            for i, r in enumerate(legs):
                for wname, (key, digest) in r["blocks"].items():
                    seen = blocks.setdefault((wname, tuple(key)), digest)
                    check(seen == digest,
                          f"rank {i} {leg}: replica of {wname} block {key} "
                          f"differs in bits after the last step")
            check({w for w, _ in blocks} == {
                f"{nd.op.name}/{ws.name}" for nd in graph.nodes.values()
                for ws in nd.op._weight_specs},
                f"{leg}: the ranks do not hold every weight")
            print(f"pipeline training path ({leg}): {len(blocks)} weight "
                  f"blocks, every replica bit-equal after "
                  f"{steps + PIPE_TIMED_STEPS} steps")
    d0 = ranks[0]["default"]
    for i, r in enumerate(ranks):
        check(r["default"]["digest"] == want_digest,
              f"rank {i}: the default pick's graph digest "
              f"{r['default']['digest']} is not the search's {want_digest}")
        check(r["default"]["views"] == d0["views"],
              f"rank {i}: the default pick's views differ from rank 0's")
    leg_rel = report["search_proposes"]["rel_err"]
    for i, r in enumerate(ranks):
        check(r["leg"]["kind"] == "PipelinedCompiledModel",
              f"rank {i}: the search-discovered leg lowered "
              f"{r['leg']['kind']}")
        check(r["leg"]["loss"] == leg0["loss"],
              f"rank {i}: the leg reports another loss")
    check(leg_rel <= SP_LOSS_TOL["fp32"],
          f"the search-discovered leg's loss {leg0['loss']:.7f} vs one "
          f"process {leg_ref:.7f}: {leg_rel:.3e} > {SP_LOSS_TOL['fp32']}")
    extra = sorted(set(launches_to_shapes(ranks[0]["flash_shapes"]))
                   - set(predicted))
    for r in ranks[1:]:
        extra = sorted(set(extra) | (set(launches_to_shapes(
            r["flash_shapes"])) - set(predicted)))
    if extra:
        print("flash kernels at launched shapes beyond the prediction: "
              + json.dumps(check_flash_shapes(seed, extra)))
    return {leg: {k: ranks[0][leg]["launches"][k] for k in
                  rows + ("flash_forward_partial",)}
            for leg in ("pipelined", "placed")}


# ---------------------------------------------------------------------------
class CountingCallback:
    """A keras-protocol callback that records what ``fit`` calls."""

    def __init__(self):
        self.model = None
        self.calls = []

    def set_model(self, model):
        self.model = model
        self.calls.append("set_model")

    def on_train_begin(self, logs=None):
        self.calls.append("on_train_begin")

    def on_epoch_begin(self, epoch, logs=None):
        self.calls.append(f"on_epoch_begin:{epoch}")

    def on_epoch_end(self, epoch, logs=None):
        self.calls.append(f"on_epoch_end:{epoch}:{sorted(logs)}")

    def on_train_end(self, logs=None):
        self.calls.append("on_train_end")


def bert_model(seed, **cfg):
    from flexflow_tpu_torch import AdamOptimizer, FFConfig
    from flexflow_tpu_torch.models import build_bert

    model = build_bert(FFConfig(batch_size=BERT_BATCH,
                                compute_dtype="bfloat16", seed=seed, **cfg),
                       **BERT)
    model.compile(optimizer=AdamOptimizer(alpha=ADAM_ALPHA),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    return model


def free_models():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def bert_steps(model, batches, seed0, ctx=None, base=0):
    """One ``train_step`` per batch, step i with seed seed0 + i: (the
    losses on the host, the peak memory in GB of the steps above
    ``base`` bytes, the allocation before the model was built)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    with ctx or contextlib.nullcontext():
        for i, (ins, lab) in enumerate(batches):
            model.params, model.opt_state, model.state, loss, _ = (
                model.compiled.train_step(model.params, model.opt_state,
                                          model.state, ins, lab,
                                          seed=seed0 + i))
            losses.append(loss.clone())
    torch.cuda.synchronize()
    return (torch.stack(losses).cpu(),
            (torch.cuda.max_memory_allocated() - base) / 1e9)


def mask_draw_ms(seed):
    """Device ms of one layer's attention-dropout mask draw at phase
    11's shape (ops/base.py's hash over [B, H, S, S]), CUDA events,
    median of TIMING_RUNS."""
    from flexflow_tpu_torch.ops.base import draw_keep_mask, stream_key

    shape = (BERT_BATCH, BERT["num_heads"], BERT["seq_len"],
             BERT["seq_len"])
    key = stream_key(torch.full((), seed + 1, dtype=torch.int64,
                                device="cuda"), "layer0_mha")

    def draw():
        return draw_keep_mask(key, 1.0 - BERT["dropout"], shape,
                              (0, 0, 0, 0), shape)

    mask = draw()
    kept = float(mask.float().mean())
    for _ in range(3):
        draw()
    times = []
    for _ in range(TIMING_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        draw()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), kept


def phase_bert_train(seed, name):
    """Phase 11 (module docstring): returns the flash rows' launches in
    (a)'s ``fit`` and the report.  Rows 1-3 are held to their plain
    versions at the validation passes' shape (``evaluate`` has no
    dropout, and Sk 512 takes the flash route), and at any other shape
    the phase launches them at."""
    seq, heads = BERT["seq_len"], BERT["num_heads"]
    check(BERT["hidden"] // heads == TRAIN["hidden"] // TRAIN["num_heads"],
          "check_flash_shapes holds the kernels at phase 6's head width")
    predicted = [("full", BERT_BATCH, seq, seq, heads, False)]
    print("bert path: flash kernels at the validation passes' shape vs "
          "plain versions: " + json.dumps(check_flash_shapes(seed, predicted)))
    shapes = set()
    with recorded_flash_launches(shapes):
        fit_launches, report = bert_legs(seed, name)
    extra = sorted(set(launches_to_shapes(shapes)) - set(predicted))
    if extra:
        print("bert path: flash kernels at launched shapes beyond the "
              "prediction: " + json.dumps(check_flash_shapes(seed, extra)))
    report["flash_shapes"] = sorted(shapes)
    print("bert path: " + json.dumps(report))
    return fit_launches, report


def bert_legs(seed, name):
    """Phase 11's (a)-(f): the flash rows' launches in (a)'s ``fit``
    and the report."""
    import shutil
    import tempfile

    from flexflow_tpu_torch.compiler.graphs import eager
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    free_models()
    rows = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)
    layers = BERT["num_layers"]
    rng = np.random.default_rng(seed + 11)
    n_train = BERT_BATCHES * BERT_BATCH
    n_val = BERT_VAL_BATCHES * BERT_BATCH
    ids = rng.integers(0, BERT["vocab"], size=(n_train + n_val,
                                               BERT["seq_len"])
                       ).astype(np.int32)
    labels = rng.integers(0, BERT["num_classes"],
                          size=(n_train + n_val,)).astype(np.int32)
    x, y = ids[:n_train], labels[:n_train]
    vx, vy = ids[n_train:], labels[n_train:]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = bert_model(seed)
    torch.cuda.synchronize()
    n_params = sum(w.numel() for ws in model.params.values()
                   for w in ws.values())
    flops = sum(n.op.flops() for n in model.graph.nodes.values())
    print(f"bert path: compiled in {time.perf_counter() - t0:.2f} s, "
          f"{n_params} parameters, forward FLOPs per step {flops:.6e}")
    dev = model.compiled.device
    batches = [([torch.from_numpy(x[i:i + BERT_BATCH]).to(dev)],
                torch.from_numpy(y[i:i + BERT_BATCH]).to(dev))
               for i in range(0, n_train, BERT_BATCH)]

    # (a) fit with validation, checkpoints and a callback
    ckpt_dir = tempfile.mkdtemp(prefix="bert_ckpt_")
    cb = CountingCallback()
    for kn in rows:
        kn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = model.fit(x, y, batch_size=BERT_BATCH, epochs=BERT_EPOCHS,
                        shuffle=True, verbose=False, callbacks=[cb],
                        validation_data=(vx, vy), checkpoint_dir=ckpt_dir)
    fit_wall = time.perf_counter() - t0
    fit_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    fit_launches = {kn.__name__: kn.launches for kn in rows}
    losses_a = list(model.step_losses)
    after_a = [t.clone() for t in train_tensors(model)]
    val_batches = BERT_VAL_BATCHES * BERT_EPOCHS
    check(len(losses_a) == BERT_EPOCHS * BERT_BATCHES,
          f"fit ran {len(losses_a)} steps")
    check(fit_launches == {"flash_forward": layers * val_batches,
                           "flash_backward_dq": 0,
                           "flash_backward_dkv": 0},
          f"fit launched {fit_launches}: want row 1 {layers} times per "
          f"validation batch ({val_batches}) and rows 1-3 never in a "
          f"dropout training step")
    want_calls = (["set_model", "on_train_begin"]
                  + [c for e in range(BERT_EPOCHS) for c in (
                      f"on_epoch_begin:{e}",
                      f"on_epoch_end:{e}:{sorted(history[e])}")]
                  + ["on_train_end"])
    check(cb.calls == want_calls, f"callbacks saw {cb.calls}")
    check(all("val_loss" in h and "val_accuracy" in h for h in history),
          f"history lacks val_* keys: {history}")
    check(bool(np.isfinite(losses_a).all()), "a BERT step's loss is not "
          "finite")
    mgr = CheckpointManager(ckpt_dir)
    check(mgr.all_steps() == [0, 1], f"snapshots {mgr.all_steps()}")
    t0 = time.perf_counter()
    mgr.save(99, model)
    save_s = time.perf_counter() - t0
    draw_ms, kept = mask_draw_ms(seed)

    # step time: synchronised captured steps (their own seeds)
    start = [t.clone() for t in train_tensors(model)]
    times = []
    graph = model.compiled.step_graph
    for i in range(BERT_TIMED_STEPS):
        ins, lab = batches[i]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.params, model.opt_state, model.state, _, _ = (
            model.compiled.train_step(model.params, model.opt_state,
                                      model.state, ins, lab,
                                      seed=1000 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    p50 = float(np.median(times))
    bf16_peak = card_peaks(name)[2]

    # (e) capture against eager with dropout; seeds draw new masks
    cmp = batches[:BERT_CMP_STEPS]
    runs = {}
    for tag, ctx in (("captured", None), ("eager", eager())):
        restore(model, start)
        ls, _ = bert_steps(model, cmp, 2000, ctx)
        runs[tag] = (ls, [t.clone() for t in train_tensors(model)])
    check(torch.equal(runs["captured"][0], runs["eager"][0])
          and same_bits(runs["captured"][1], runs["eager"][1]),
          f"captured steps {runs['captured'][0].tolist()} differ from "
          f"eager {runs['eager'][0].tolist()} with dropout")
    del runs
    seed_losses = []
    for sd in (3000, 3001, 3000):
        restore(model, start)
        ls, _ = bert_steps(model, cmp[:1], sd)
        seed_losses.append(float(ls[0]))
    check(seed_losses[0] != seed_losses[1],
          f"two seeds drew the same masks: losses {seed_losses}")
    check(seed_losses[0] == seed_losses[2],
          f"one seed twice drew different masks: losses {seed_losses}")
    del start

    # (b) resume from epoch 1's snapshot
    resume_dir = tempfile.mkdtemp(prefix="bert_resume_")
    shutil.copytree(os.path.join(ckpt_dir, "step_0"),
                    os.path.join(resume_dir, "step_0"))
    del model, graph
    free_models()
    resumed = bert_model(seed)
    hist_b = resumed.fit(x, y, batch_size=BERT_BATCH, epochs=BERT_EPOCHS,
                         shuffle=True, verbose=False,
                         validation_data=(vx, vy), checkpoint_dir=resume_dir,
                         resume=True)
    losses_b = list(resumed.step_losses)
    check(len(hist_b) == 1 and losses_b == losses_a[BERT_BATCHES:]
          and same_bits([t.clone() for t in train_tensors(resumed)],
                        after_a),
          f"resumed epoch-2 losses {losses_b} or weights differ in bits "
          f"from the uninterrupted run's {losses_a[BERT_BATCHES:]}")
    del resumed, after_a
    free_models()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    shutil.rmtree(resume_dir, ignore_errors=True)

    # (c) remat, (d) accumulation: fresh models from the seed's weights
    # peak memory: the captured steps' (their first call runs eagerly,
    # then captures into the graph's own pool) and then that of eager
    # steps alone, each above the allocation before its model was built
    # (the earlier legs' weights, kept for the comparisons, excluded)
    legs = {}
    for tag, cfg in (("plain", {}), ("remat", {"remat": True}),
                     ("ga2", {"grad_accum_steps": 2})):
        base = torch.cuda.memory_allocated()
        m = bert_model(seed, **cfg)
        ls, peak = bert_steps(m, cmp, 4000, base=base)
        legs[tag] = (ls, [t.clone() for t in train_tensors(m)], peak)
        del m
        free_models()
        base = torch.cuda.memory_allocated()
        m = bert_model(seed, **cfg)
        _, peak_eager = bert_steps(m, cmp[:2], 4000, eager(), base=base)
        legs[tag] += (peak_eager,)
        del m
        free_models()
    check(torch.equal(legs["plain"][0], legs["remat"][0])
          and same_bits(legs["plain"][1], legs["remat"][1]),
          f"remat losses {legs['remat'][0].tolist()} or weights differ "
          f"in bits from {legs['plain'][0].tolist()}")
    for i, kind in ((2, "captured"), (3, "eager")):
        for tag in ("remat", "ga2"):
            check(legs[tag][i] < legs["plain"][i],
                  f"{tag} peak memory ({kind}) {legs[tag][i]:.3f} GB not "
                  f"below plain's {legs['plain'][i]:.3f}")
    ga_rel = float(((legs["ga2"][0] - legs["plain"][0]).abs()
                    / legs["plain"][0].abs()).max())
    check(ga_rel <= BERT_GA_TOL, f"grad_accum_steps=2 losses "
          f"{legs['ga2'][0].tolist()} vs {legs['plain'][0].tolist()}: "
          f"{ga_rel:.3e} > {BERT_GA_TOL}")

    report = {
        "config": dict(BERT, batch=BERT_BATCH, compute="bfloat16",
                       optimizer="adam"),
        "parameters": n_params,
        "fit_steps": len(losses_a), "fit_wall_s": fit_wall,
        "step_p50_ms": p50 * 1e3,
        "step_p99_ms": float(np.quantile(times, 0.99)) * 1e3,
        "tokens_per_s": BERT_BATCH * BERT["seq_len"] / p50,
        "mfu_vs_dense_bf16_peak": 3.0 * flops / p50 / bf16_peak,
        "peak_memory_gb_fit": fit_peak,
        "checkpoint_save_host_s": save_s,
        "mask_draw_ms_one_layer": draw_ms,
        "mask_kept_fraction": kept,
        "mask_draw_share_of_step": layers * draw_ms / (p50 * 1e3),
        "fit_launches": fit_launches,
        "history": history,
        "loss_first_step": losses_a[0], "loss_last_step": losses_a[-1],
        "seed_losses": seed_losses,
        "peak_memory_gb_captured": {k: v[2] for k, v in legs.items()},
        "peak_memory_gb_eager": {k: v[3] for k, v in legs.items()},
        "losses_4_steps": {k: v[0].tolist() for k, v in legs.items()},
        "ga2_rel_loss_err": ga_rel,
        "phase_wall_s": time.perf_counter() - t_phase}
    return fit_launches, report


# ---------------------------------------------------------------------------
def sync_spec(shared, two_level=False):
    """The machine phase 12's searches price: ``h100_sxm`` at
    SYNC_RANKS; on the shared card its link is the host-copy transport
    (SYNC_SHARED_LINK_BW); ``two_level``: two hosts of SYNC_RANKS / 2
    cards (NVLink within a host, the NIC across)."""
    import dataclasses

    from flexflow_tpu_torch.core.machine import MachineSpec

    spec = MachineSpec.h100_sxm(SYNC_RANKS)
    if two_level:
        return dataclasses.replace(spec, devices_per_host=SYNC_RANKS // 2)
    if shared:
        spec = dataclasses.replace(spec, ici_bandwidth=SYNC_SHARED_LINK_BW)
    return spec


def sync_legs(shared, export_path):
    """Phase 12's legs: name -> (FFConfig options, fit steps)."""
    dp = dict(only_data_parallel=True, machine_spec=sync_spec(shared))
    return {
        "a_monolithic": (dp, SYNC_STEPS),
        "b_zero": (dict(dp, zero_dp_shard=True), SYNC_STEPS),
        "c_int8_ef": (dict(dp, sync_precision="int8", sync_ef="auto"),
                      SYNC_INT8_STEPS),
        "c_bf16": (dict(dp, sync_precision="bf16"), SYNC_BF16_STEPS),
        "d_schedule": (dict(only_data_parallel=True,
                            machine_spec=sync_spec(shared, two_level=True),
                            sync_schedule="search"), SYNC_STEPS),
        "e_co_search": (dict(co_search=True,
                             search_timeout_s=0,
                             enable_pipeline_search=False,
                             enable_placement_search=False,
                             export_strategy_file=export_path), SYNC_STEPS),
    }


def sync_model(seed, **cfg):
    from flexflow_tpu_torch import AdamOptimizer, FFConfig
    from flexflow_tpu_torch.models import build_gpt

    model = build_gpt(FFConfig(batch_size=TRAIN_BATCH,
                               compute_dtype="bfloat16", seed=seed,
                               num_devices=SYNC_RANKS, **cfg), **TRAIN)
    model.compile(optimizer=AdamOptimizer(alpha=ADAM_ALPHA),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    return model


def _sync_rank(rank, seed, ids, shared, export_path):
    """One rank of phase 12: every leg in order, each a fresh model of
    phase 6's weights through ``fit`` with the launch and collective
    counts set to 0 just before and read just after; leg (a)'s weights
    kept on the host to hold the others to."""
    import torch.distributed as dist

    from flexflow_tpu_torch.comm import (
        allreduce_error_bound,
        quantized_allreduce,
    )
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel import mesh
    from flexflow_tpu_torch.runtime.distributed import transport
    from flexflow_tpu_torch.search import strategy_io
    from flexflow_tpu_torch.search.cost_cache import stable_graph_digest

    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = ids[:, :-1], ids[:, 1:]
    kernels = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv,
               fa.flash_forward_partial)
    out, ref_w = {"transport": transport()}, None

    def drive(model, steps):
        for k in kernels:
            k.launches = 0
        mesh.reset_comm_counts()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        model.fit(x[:steps * TRAIN_BATCH], y[:steps * TRAIN_BATCH],
                  batch_size=TRAIN_BATCH, shuffle=False, verbose=False)
        torch.cuda.synchronize()
        return {"fit_wall_s": time.perf_counter() - t0, "steps": steps,
                "launches": {k.__name__: k.launches for k in kernels},
                "collectives": mesh.comm_counts(),
                "losses": list(model.step_losses),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "slot_bytes": sum(t.numel() * t.element_size()
                                  for k in ("m", "v")
                                  for ws in model.opt_state[k].values()
                                  for t in ws.values()),
                "map": dict(model.sync_precision_map),
                "zero_groups": list(model.zero_groups),
                "schedule": (None if model.compiled.sync_schedule is None
                             else model.compiled.sync_schedule.to_jsonable()),
                "ef_residuals": sum(k.endswith("/ef_residual")
                                    for k in model.state),
                "blocks": weight_blocks(model)}

    def max_diff(model):
        return max(float((t.detach().float() - ref_w[op][w].to(
            t.device)).abs().max()) for op, ws in model.params.items()
            for w, t in ws.items())

    for leg, (cfg, steps) in sync_legs(shared, export_path).items():
        model = sync_model(seed, **cfg)
        if leg == "e_co_search":
            out["e_search"] = {
                "digest": stable_graph_digest(model.graph),
                "views": sorted((model.graph.nodes[g].op.name,
                                 tuple(v.dim_degrees), v.replica_degree)
                                for g, v in model.strategy.items()),
                "meta": model.sync_meta(),
                "search_seconds": model.search_stats.get("search_seconds")}
        r = drive(model, steps)
        if ref_w is None:
            ref_w = {op: {w: t.detach().float().cpu().clone()
                          for w, t in ws.items()}
                     for op, ws in model.params.items()}
        elif leg in ("b_zero", "d_schedule"):
            r["max_weight_diff_vs_a"] = max_diff(model)
        if leg == "c_int8_ef":
            # one compressed sum of a real gradient against the fp32 sum
            c = model.compiled
            dev = c.device
            bx, by = x[:TRAIN_BATCH], y[:TRAIN_BATCH]
            g = c.loss_and_grads(
                model.params, model.state,
                [torch.from_numpy(np.ascontiguousarray(
                    bx[c.input_slices(0, bx.shape)])).to(dev)],
                torch.from_numpy(np.ascontiguousarray(
                    by[c.label_slices(by.shape)])).to(dev),
                seed=torch.zeros((), dtype=torch.int64), sync=False)[3]
            share = g["layer0_ff1"]["kernel"].float()
            got = quantized_allreduce(share, c.mesh.names, c.mesh, "int8")
            exact = mesh.all_reduce_sum(share, c.mesh.names, c.mesh)
            amax = mesh.all_gather(share.abs().max().reshape(1), 0,
                                   c.mesh.names, c.mesh)
            r["quantized_check"] = {
                "weight": "layer0_ff1/kernel",
                "elements": share.numel(),
                "max_abs_err": float((got - exact).abs().max()),
                "bound": allreduce_error_bound(
                    [a.reshape(1).cpu().numpy() for a in amax], "int8")}
        if leg == "e_co_search":
            dist.barrier()  # rank 0 wrote the export at compile
            r["exported_meta"] = {
                k: v for k, v in strategy_io.read_meta(export_path).items()
                if k in ("sync_precision", "sync_schedule", "zero_groups")}
            imported = strategy_io.import_strategy(export_path, model.graph)
            r["import_equal"] = all(
                (tuple(v.dim_degrees), v.replica_degree)
                == (tuple(model.strategy[g].dim_degrees),
                    model.strategy[g].replica_degree)
                for g, v in imported.items())
        out[leg] = r
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_sync_train(seed, name, first_loss_bf16):
    """Phase 12: gradient sync over SYNC_RANKS ranks spawned as phase 7's
    (one card each with NCCL on a 4-card machine, else all on card 0
    through gloo with counted host hops), phase 6's model and batches
    under dp 4: (a) the monolithic fp32 sum, (b) ZeRO-1, (c) int8 with
    error feedback and a short bf16 leg, (d) the searched, bucketed,
    issue-ordered and staged schedule on two hosts of two ranks, (e)
    ``compile(strategy=None)`` with ``co_search``.  Before the ranks
    spawn, (d)'s schedule is chosen here on the same spec, with its
    buckets' predicted exposed seconds."""
    import tempfile

    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
    from flexflow_tpu_torch.models import build_gpt
    from flexflow_tpu_torch.runtime.distributed import spawn
    from flexflow_tpu_torch.search.driver import _build_sync_schedule
    from flexflow_tpu_torch.search.simulator import Simulator
    from flexflow_tpu_torch.search.sync_schedule import (
        build_bucketed_schedule,
        synced_weight_groups,
    )

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    shared = torch.cuda.device_count() < SYNC_RANKS
    tmp = tempfile.TemporaryDirectory()
    export_path = os.path.join(tmp.name, "sync_strategy.json")
    legs = sync_legs(shared, export_path)
    most = max(steps for _, steps in legs.values())
    rng = np.random.default_rng(seed + 3)  # phase 6's batches
    ids = rng.integers(0, TOKEN_RANGE, size=(
        TRAIN_BATCHES * TRAIN_BATCH, TRAIN["seq_len"] + 1)).astype(np.int32)
    ids = ids[:most * TRAIN_BATCH]

    # (d)'s schedule, chosen here as every rank will, and its prices
    cfg_d = FFConfig(batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                     num_devices=SYNC_RANKS, **legs["d_schedule"][0])
    graph = build_gpt(cfg_d, **TRAIN).graph
    views = data_parallel_strategy(graph, SYNC_RANKS)
    sim = Simulator.for_config(cfg_d)
    sched = _build_sync_schedule(graph, views, sim, cfg_d)
    check(sched is not None, "the schedule search on two hosts kept the "
          "monolithic sum: nothing to stage")
    mono = build_bucketed_schedule(
        synced_weight_groups(graph, views, sim.cost), {}, math.inf)
    bd_s, bd_m = {}, {}
    sim.simulate(graph, views, breakdown=bd_m, sync_schedule=mono)
    sim.simulate(graph, views, breakdown=bd_s, sync_schedule=sched)
    predicted = {
        "buckets": [{"name": b["name"], "ops": len(b["ops"]),
                     "precision": b["precision"], "plan": b["plan"],
                     "sync_s": b["sync_s"], "exposed_s": b["exposed_s"]}
                    for b in bd_s["sync_buckets"]],
        "sync_exposed_s": bd_s["sync_exposed_s"],
        "monolithic_sync_exposed_s": bd_m["sync_exposed_s"],
        "step_s": bd_s["total_s"], "monolithic_step_s": bd_m["total_s"]}
    del graph, sim

    t0 = time.perf_counter()
    ranks = spawn(_sync_rank, SYNC_RANKS, (seed, ids, shared, export_path),
                  init_method=f"tcp://localhost:{free_port()}",
                  device="cuda", timeout=SP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    tmp.cleanup()
    r0 = ranks[0]
    want_transport = "gloo-host" if shared else "nccl"

    def per_step(r):
        return sum(c["host_bytes"] for c in r["collectives"].values()) \
            / r["steps"]

    def wire_per_step(r):
        return sum(c["bytes"] for c in r["collectives"].values()) \
            / r["steps"]

    a = r0["a_monolithic"]
    report = {"card": CARD_LINE[0], "ranks": SYNC_RANKS,
              "transport": r0["transport"], "phase_wall_s": None,
              "ranks_wall_s": wall, "legs": {}}
    for leg in legs:
        r = r0[leg]
        report["legs"][leg] = {
            "steps": r["steps"], "losses": r["losses"],
            "fit_wall_s": [rr[leg]["fit_wall_s"] for rr in ranks],
            "step_s": max(rr[leg]["fit_wall_s"] for rr in ranks)
            / r["steps"],
            "host_bytes_per_rank_per_step": per_step(r),
            "host_bytes_vs_a": per_step(r) / max(per_step(a), 1.0),
            "wire_bytes_per_rank_per_step": wire_per_step(r),
            "wire_bytes_vs_a": wire_per_step(r) / wire_per_step(a),
            "slot_bytes_per_rank": r["slot_bytes"],
            "slot_bytes_vs_a": r["slot_bytes"] / a["slot_bytes"],
            "peak_memory_gb_per_rank": [rr[leg]["peak_memory_gb"]
                                        for rr in ranks],
            "launches_per_rank_per_step": {
                k: v / r["steps"] for k, v in r["launches"].items()},
            "max_weight_diff_vs_a": r.get("max_weight_diff_vs_a"),
            "compressed_groups": len(r["map"]),
            "precisions": sorted(set(r["map"].values())),
            "ef_residuals": r["ef_residuals"],
            "zero_groups": len(r["zero_groups"]),
            "buckets": (None if r["schedule"] is None
                        else len(r["schedule"]["buckets"]))}
    report["d_predicted"] = predicted
    report["c_quantized_check"] = r0["c_int8_ef"]["quantized_check"]
    report["e_search"] = {k: r0["e_search"][k]
                          for k in ("digest", "search_seconds")}
    report["e_search"]["meta_keys"] = sorted(r0["e_search"]["meta"])
    report["phase_wall_s"] = time.perf_counter() - t_phase
    print("gradient sync path: " + json.dumps(report))
    print(f"gradient sync path, card: {CARD_LINE[0]}")

    rows = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
    layers = TRAIN["num_layers"]
    blocks = {}
    for i, r in enumerate(ranks):
        check(r["transport"] == want_transport,
              f"rank {i}: transport {r['transport']}, want {want_transport}")
        for leg in legs:
            rl = r[leg]
            check(rl["losses"] == r0[leg]["losses"],
                  f"rank {i} {leg}: other losses than rank 0's")
            check(len(rl["losses"]) == rl["steps"],
                  f"rank {i} {leg}: {len(rl['losses'])} steps ran")
            check(bool(np.isfinite(rl["losses"]).all()),
                  f"rank {i} {leg}: a loss is not finite")
            for k in rows:
                check(rl["launches"][k] == layers * rl["steps"],
                      f"rank {i} {leg}: {k} launched {rl['launches'][k]} "
                      f"times in {rl['steps']} steps, want "
                      f"{layers * rl['steps']}")
            check(rl["launches"]["flash_forward_partial"] == 0,
                  f"rank {i} {leg}: the partial kernel launched")
            for wname, (key, digest) in rl["blocks"].items():
                seen = blocks.setdefault((leg, wname, tuple(key)), digest)
                check(seen == digest, f"rank {i} {leg}: replica of "
                      f"{wname} block {key} differs in bits")
            hopped = sum(c["host_hops"] for c in rl["collectives"].values())
            check((hopped > 0) == shared, f"rank {i} {leg}: {hopped} host "
                  f"hops with transport {r['transport']}")
    # (b) ZeRO-1 against (a)
    b = r0["b_zero"]
    check(b["losses"][0] == a["losses"][0],
          "ZeRO-1's first loss differs from the monolithic sum's")
    for leg in ("b_zero", "d_schedule"):
        r = r0[leg]
        check(r["max_weight_diff_vs_a"] <= SYNC_WEIGHT_TOL,
              f"{leg}: weights {r['max_weight_diff_vs_a']:.3e} from leg "
              f"(a)'s, limit {SYNC_WEIGHT_TOL}")
        for la, lb in zip(a["losses"][1:], r["losses"][1:]):
            check(abs(la - lb) <= SYNC_LOSS_TOL * abs(la),
                  f"{leg}: loss {lb} against (a)'s {la}")
    check(b["slot_bytes"] <= 0.3 * a["slot_bytes"],
          f"ZeRO-1 holds {b['slot_bytes']} slot bytes per rank against "
          f"(a)'s {a['slot_bytes']}")
    check(b["zero_groups"] == [] and a["zero_groups"] == [],
          "zero_dp_shard arms every op without a per-group map")
    # (c) int8 with error feedback, and bf16
    c = r0["c_int8_ef"]
    rel = abs(c["losses"][0] - first_loss_bf16) / abs(first_loss_bf16)
    check(rel <= 5e-3, f"int8 leg's first loss {c['losses'][0]:.6f} vs "
          f"phase 6's {first_loss_bf16:.6f}: {rel:.3e} > 5e-3")
    check(c["losses"][-1] < c["losses"][0], "the int8 leg's loss did not "
          f"fall: {c['losses']}")
    check(c["map"] and set(c["map"].values()) == {"int8_ef"},
          f"int8 leg's map {c['map']}: want int8_ef groups")
    check(c["ef_residuals"] > 0, "the int8 leg carries no residual")
    q = c["quantized_check"]
    check(q["max_abs_err"] <= q["bound"], f"the compressed sum of "
          f"{q['weight']} is {q['max_abs_err']:.3e} from the fp32 sum, "
          f"bound {q['bound']:.3e}")
    check(per_step(c) < 0.5 * per_step(a) if shared
          else wire_per_step(c) < 0.5 * wire_per_step(a),
          "the int8 leg moved at least half of (a)'s bytes")
    check(r0["c_bf16"]["map"] and set(r0["c_bf16"]["map"].values())
          == {"bf16"}, f"bf16 leg's map {r0['c_bf16']['map']}")
    # (d) the searched schedule
    d = r0["d_schedule"]
    check(d["schedule"] == sched.to_jsonable(),
          "the ranks lowered another schedule than the one chosen here")
    check(any(bk.get("plan") for bk in d["schedule"]["buckets"]),
          "no bucket of the schedule carries a staged plan")
    # (e) the co-search
    for i, r in enumerate(ranks):
        check(r["e_search"] == r0["e_search"],
              f"rank {i} lowered another graph, strategy or comm plan "
              f"than rank 0")
    e = r0["e_co_search"]
    check(e["exported_meta"] == r0["e_search"]["meta"],
          "the exported __meta__ differs from the lowered comm plan")
    check(e["import_equal"], "the exported strategy imports other views")
    check(bool(r0["e_search"]["meta"]), "the co-search lowered no comm "
          "plan (no schedule, no ZeRO groups)")
    return {leg: {k: r0[leg]["launches"][k] / r0[leg]["steps"]
                  for k in rows} for leg in legs}


def serve_legs():
    """Phase 13's legs: name -> (the decode op's (batch, head) degrees,
    or None for the serve-objective search's pick; FFConfig options;
    the executor: "chunked" (phase 4's with the chunked prefill of
    phase 5) or "lane" (phase 5's: also prefix sharing and SLO
    classes))."""
    lane = dict(prefill_chunk=LANE_CHUNK, serve_slo_classes=LANE_SLO_CLASSES)
    return {
        "a_head": ((1, SERVE_RANKS), dict(kv_precision="bf16"), "chunked"),
        "b_batch": ((SERVE_RANKS, 1), {}, "chunked"),
        "c_head_int8_lane": ((1, SERVE_RANKS),
                             dict(lane, kv_precision="int8"), "lane"),
        "d_searched": (None, dict(
            lane, objective="serve", kv_precision="search",
            serve_disaggregation="search", serve_fleet="search"), "lane"),
    }


def serve_requests(seed):
    """Phase 13's traffic: the first SERVE_REQUESTS of phase 4's
    requests, cut in depth (SERVE_PROMPT_TOKENS, SERVE_NEW_TOKENS); r5,
    the one that fills its sequence, keeps filling it."""
    import dataclasses

    out = []
    for req in make_requests(seed, FULL["vocab"])[:SERVE_REQUESTS]:
        new = min(req.max_new_tokens, SERVE_NEW_TOKENS)
        if len(req.prompt) + req.max_new_tokens == MAX_SEQ:
            reps = -(-(MAX_SEQ - new) // len(req.prompt))
            prompt = (req.prompt * reps)[:MAX_SEQ - new]
        else:
            prompt = req.prompt[:SERVE_PROMPT_TOKENS]
        out.append(dataclasses.replace(req, prompt=prompt,
                                       max_new_tokens=new))
    return out


def serve_views(model, b, r):
    """The decode ops at (b, 1, 1) with replica degree r, every other
    op split b ways on its batch dim."""
    from flexflow_tpu_torch.core.machine import MachineView
    from flexflow_tpu_torch.core.optype import OperatorType

    views = {}
    for node in model.graph.topo_order():
        op = node.op
        nd = op.output_shapes[0].ndim
        if op.op_type == OperatorType.DECODE_ATTENTION:
            views[node.guid] = MachineView((b, 1, 1), replica_degree=r)
        else:
            views[node.guid] = MachineView((b,) + (1,) * (nd - 1))
    return views


def serve_executor(step, cfg, lane):
    """Phase 4's executor with phase 5's chunked prefill (``lane ==
    "chunked"``), or phase 5's lane (also prefix sharing and SLO
    classes)."""
    from flexflow_tpu_torch.runtime.decode import ContinuousBatchingExecutor

    if lane == "lane":
        return lane_executor(step, cfg)
    return ContinuousBatchingExecutor(
        step, max_seqs=FRAME_SLOTS, page_size=FULL["page_size"],
        pages_per_seq=FULL["pages_per_seq"], prefill_fn=step.prefill,
        prefill_chunk=LANE_CHUNK)


def local_decode_shapes(step):
    """(frame rows, heads, pool dtype) the decode kernels of this rank's
    ``compiled_decode_step`` take."""
    from flexflow_tpu_torch.ops.decode_attention import DecodeAttentionOp

    out = set()
    c = step.compiled
    for node in c.graph.topo_order():
        op = node.op
        if not isinstance(op, DecodeAttentionOp):
            continue
        rows = c._in_pl[node.guid][0].local_sizes(
            op.input_shapes[0].sizes, c.mesh)[0]
        heads = step.state["state"][f"{op.name}/k_cache"].shape[2]
        out.add((int(rows), int(heads), op.kv_dtype))
    return sorted(out)


def watching(step, live):
    """``step`` that adds the slots of ``live["ex"]`` (its executor, set
    once built) live at each frame to ``live["slots"]``."""
    def watch(ids, table, lens):
        live["slots"].update(i for i, s in enumerate(live["ex"].slots)
                             if s is not None)
        return step(ids, table, lens)

    watch.prefill = step.prefill
    watch.copy_page = step.copy_page
    return watch


def _serve_rank(rank, seed, obs_dir):
    """One rank of phase 13: every leg in order, each a fresh model of
    phase 4's weights serving phase 4's requests, the counts set to 0
    just before the run and read just after; every call of the run
    logged (with each frame's logits) on the first rank of each
    replica and saved under ``obs_dir``, for the parent to replay
    through one process."""
    import torch.distributed as dist

    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.kernels import ragged_paged_attention as rpa
    from flexflow_tpu_torch.models import build_gpt_decode
    from flexflow_tpu_torch.obs.events import BUS
    from flexflow_tpu_torch.parallel import mesh
    from flexflow_tpu_torch.runtime.decode import (
        ContinuousBatchingExecutor,
        DecodeRequest,
        compiled_decode_step,
    )
    from flexflow_tpu_torch.runtime.distributed import transport
    from flexflow_tpu_torch.runtime.fleet import fleet_over_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = (rpa.ragged_paged_attention, rpa.ragged_paged_attention_quant)
    reqs = serve_requests(seed)

    def moved():
        counts = mesh.comm_counts().values()
        return (sum(c["bytes"] for c in counts),
                sum(c["host_bytes"] for c in counts))

    def counting(step, acc):
        """``step`` whose chunk passes add their collectives' bytes to
        ``acc``, so the frames' own bytes can be told apart."""
        inner = step.prefill

        def prefill(*args):
            before = moved()
            inner(*args)
            after = moved()
            acc["passes"] += 1
            acc["bytes"] += after[0] - before[0]
            acc["host_bytes"] += after[1] - before[1]

        step.prefill = prefill
        return step
    warm = [DecodeRequest(rid="warm", prompt=list(range(1, 40)),
                          max_new_tokens=4)]
    out = {"transport": transport()}
    for leg, (degrees, opts, lane) in serve_legs().items():
        t0 = time.perf_counter()
        cfg = FFConfig(batch_size=FRAME_SLOTS, compute_dtype="bfloat16",
                       seed=seed, num_devices=SERVE_RANKS, **opts)
        model = build_gpt_decode(cfg, **FULL)
        model.compile(comp_mode="inference",
                      strategy=None if degrees is None
                      else serve_views(model, *degrees))
        compile_s = time.perf_counter() - t0
        fleet = model.fleet if (model.fleet is not None
                                and model.fleet.adopted) else None
        logs, lives = {}, {}
        chunks = {"passes": 0, "bytes": 0, "host_bytes": 0}
        aligned = lane != "lane"  # the lane shares prefixes: a free list

        def executor(step, index, first):
            """The leg's executor over ``step``, replica ``index``;
            logged when this rank is the first of its block."""
            step = counting(step, chunks)
            if first:
                logs[index] = []
                step = recording(step, logs[index], 10 ** 9, [], [])
            live = lives[index] = {"slots": set()}
            ex = live["ex"] = serve_executor(watching(step, live), cfg,
                                             lane)
            return ex

        if fleet is None:
            step = compiled_decode_step(
                model, prefill_chunk=LANE_CHUNK, slot_aligned=aligned)
            serve_executor(step, cfg, lane).run(warm)
            runner = executor(step, 0, rank == 0)
            steps = [step]
        else:
            built = {}
            firsts = {rep.index: rep.start + rep.prefill_devices
                      for rep in fleet.replicas}

            def make(step, index):
                built[index] = step
                return executor(step, index, firsts[index] == rank)

            runner = fleet_over_ranks(
                model, fleet, make, prefill_chunk=LANE_CHUNK,
                slot_aligned=aligned, seed=seed)
            steps = list(built.values())
            for step in steps:
                serve_executor(step, cfg, lane).run(warm)
        for k in kernels:
            k.launches = 0
        chunks.update(passes=0, bytes=0, host_bytes=0)
        mesh.reset_comm_counts()
        BUS.configure(os.path.join(obs_dir, f"{leg}_rank{rank}.jsonl"))
        dist.barrier()
        t0 = time.perf_counter()
        try:
            tokens = runner.run(reqs, max_frames=20_000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            BUS.flush()
        finally:
            BUS.close()
        # read after the run: a layout changed mid-serve shows here
        pool_bytes = sum(t.numel() * t.element_size()
                         for step in steps
                         for t in step.state["state"].values())
        local = ([runner] if fleet is None else
                 [ex for ex in runner.replicas
                  if not type(ex).__name__ == "RemoteReplica"])
        frames = sum(ex.frame for ex in local)
        summ = runner.summary()
        per_replica = ([summ] if fleet is None else summ["per_replica"])
        recs = [x for x in runner.request_records
                if x.get("phase") == "finish"]
        q = ContinuousBatchingExecutor._quantile
        ttft = [x["ttft_s"] for x in recs if x.get("ttft_s") is not None]
        log_files = {}
        for index, log in logs.items():
            path = os.path.join(obs_dir, f"{leg}_replica{index}.pt")
            torch.save([(kind, args, None if lg is None else lg.cpu())
                        for kind, args, lg in log], path)
            log_files[index] = path
        r = {"compile_s": compile_s, "wall_s": wall, "tokens": tokens,
             "frames": frames, "chunk_passes": chunks,
             "launches": {k.__name__: k.launches for k in kernels},
             "collectives": mesh.comm_counts(),
             "pool_bytes": pool_bytes,
             "decode_shapes": sorted({s for step in steps
                                      for s in local_decode_shapes(step)}),
             "frame_p50_s": [x.get("measured_p50_s") for x in per_replica],
             "frame_p99_s": [x.get("measured_p99_s") for x in per_replica],
             "ttft_p50_s": q(ttft, 0.5), "ttft_p99_s": q(ttft, 0.99),
             "requests_recorded": len(recs),
             "slo_classes": summ.get("slo_classes"),
             "live_slots": {i: sorted(v["slots"])
                            for i, v in lives.items()},
             "strategy": sorted({(tuple(v.dim_degrees), v.replica_degree)
                                 for v in model.strategy.values()}),
             "kv_meta": model.serve_meta.get("kv"),
             "fleet": None if fleet is None else fleet.to_meta(),
             "disaggregation": (None if model.disaggregation is None
                                else model.disaggregation.to_meta()),
             "logs": log_files}
        if fleet is not None:
            r["assignments"] = dict(runner.assignments)
        out[leg] = r
        del model, steps, runner, logs, lives
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def check_decode_shapes(seed, shapes):
    """Rows 5 and 6 against their plain versions at each (frame rows,
    heads, pool) a rank of phase 13 runs them at: phase 3's serving
    operands cut to those rows and heads, within phase 3's limits."""
    from flexflow_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_quant,
        ragged_paged_attention_quant_reference,
        ragged_paged_attention_reference,
    )
    from flexflow_tpu_torch.ops.decode_attention import _quantize_kv

    lens, q, k32, v32, pt, sl = serving_operands(seed)
    errs = {}
    for rows, heads, pool in shapes:
        qs = q[:rows, :heads].contiguous()
        ks = k32[:, :, :heads].contiguous()
        vs = v32[:, :, :heads].contiguous()
        pts, sls = pt[:rows].contiguous(), sl[:rows].contiguous()
        if pool == "int8":
            kq, kscale = _quantize_kv(ks)
            vq, vscale = _quantize_kv(vs)
            args = (qs, kq, vq, kscale, vscale, pts, sls)
            got = ragged_paged_attention_quant(*args)
            ref = ragged_paged_attention_quant_reference(*args)
            err = float((got - ref).abs().max()) / max(
                1.0, float(ref.abs().max()))
        else:
            dt = torch.float32 if pool == "fp32" else torch.bfloat16
            args = (qs, ks.to(dt), vs.to(dt), pts, sls)
            got = ragged_paged_attention(*args)
            ref = ragged_paged_attention_reference(*args)
            err = float((got - ref).abs().max())
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"decode kernel at "
              f"[{rows}, {heads}] {pool}: non-finite values")
        check(err <= KERNEL_TOL, f"decode kernel at [{rows}, {heads}] "
              f"{pool} vs its plain version: {err:.3e} > {KERNEL_TOL}")
        errs[f"[{rows}, {heads}] {pool}"] = err
    print("serving over ranks, decode kernels at the per-rank shapes vs "
          "plain: " + json.dumps(errs))
    return errs


def serve_reference(seed, cfg_opts, dtype, lane):
    """One process of phase 4's model (this leg's pool dtype and
    executor) serving phase 4's requests, captured: (tokens, per
    request the top-2 logit margin of each generated token, the model
    and its step for replays)."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.models import build_gpt_decode
    from flexflow_tpu_torch.runtime.decode import (
        DecodeRequest,
        compiled_decode_step,
    )

    opts = {k: v for k, v in cfg_opts.items()
            if k in ("prefill_chunk", "serve_slo_classes")}
    cfg = FFConfig(batch_size=FRAME_SLOTS, compute_dtype="bfloat16",
                   seed=seed, kv_precision=dtype, **opts)
    model = build_gpt_decode(cfg, **FULL)
    model.compile(comp_mode="inference")
    step = compiled_decode_step(model, prefill_chunk=LANE_CHUNK)
    serve_executor(step, cfg, lane).run([DecodeRequest(
        rid="warm", prompt=list(range(1, 40)), max_new_tokens=4)])
    zero_state(model)
    margins, pending = {}, []
    box = {}

    def rec_step(ids, table, lens):
        logits = step(ids, table, lens)
        top = logits[:, 0].float().topk(2, dim=-1).values
        # rows whose output this frame extends a request's tokens
        rows = [(i, live.req.rid) for i, live in enumerate(
            box["ex"].slots) if live is not None
            and live.cached + 1 >= len(live.tokens)]
        pending.append((rows, top[:, 0] - top[:, 1]))
        return logits

    rec_step.prefill = getattr(step, "prefill", None)
    rec_step.copy_page = step.copy_page
    ex = box["ex"] = serve_executor(rec_step, cfg, lane)
    tokens = ex.run(serve_requests(seed), max_frames=20_000)
    for rows, margin in pending:
        m = margin.cpu().numpy()
        for i, rid in rows:
            margins.setdefault(rid, []).append(float(m[i]))
    return tokens, margins, model, step


def replay_diff(model, step, log):
    """A leg's logged run (every chunk pass, page copy and frame, in
    order) replayed through one process from an empty cache, so each
    frame's logits are compared on the leg's own tokens: (the largest
    |logit| difference, frames, frame rows whose argmax differs)."""
    zero_state(model)
    diff, frames, flips = 0.0, 0, 0
    for kind, args, logits in log:
        if kind == "step":
            got = step(*args).float().cpu()
            diff = max(diff, float((got - logits).abs().max()))
            flips += int((got.argmax(-1) != logits.argmax(-1)).sum())
            frames += 1
        elif kind == "prefill":
            step.prefill(*args)
        else:
            step.copy_page(*args)
    return diff, frames, flips


def token_parity(got, ref, margins, diff):
    """Requests whose tokens equal one process's, and those excused:
    their first differing token's one-process top-2 margin is at most
    the legs' measured logit difference.  Returns (checked, excused
    request ids, excused tokens)."""
    excused, lost = [], 0
    for rid, want in ref.items():
        have = got.get(rid)
        check(have is not None and len(have) == len(want),
              f"{rid}: {None if have is None else len(have)} tokens, "
              f"want {len(want)}")
        if have == want:
            continue
        p = next(i for i, (a, b) in enumerate(zip(have, want)) if a != b)
        margin = margins[rid][p]
        check(margin <= diff, f"{rid}: token {p} is {have[p]}, one "
              f"process gives {want[p]} with a top-2 margin of "
              f"{margin:.4e} above the measured logit difference "
              f"{diff:.4e}")
        excused.append(rid)
        lost += len(want) - p
    return len(ref) - len(excused), excused, lost


def phase_serve_ranks(seed, name):
    """Phase 13: phase 4's model and requests served over SERVE_RANKS
    ranks spawned as phase 7's (one card each with NCCL on a 4-card
    machine, else all on card 0 through gloo with counted host hops) in
    four legs: (a) head split 4, bf16 pools; (b) batch split 4, fp32
    pools; (c) head split 4, int8 pools through phase 5's lane; (d)
    ``compile(strategy=None)`` under the serve objective with the KV
    lane, disaggregation and fleet searched, the requests served
    through what it adopts (a fleet over rank blocks where it adopts
    one).  Each leg is held to one process's run of its configuration:
    every frame's logits, replaying each replica's whole run; the
    tokens, where the one-process top-2 margin exceeds that
    difference; rows 5/6 against their plain versions at the per-rank
    shapes; launches per rank per frame; per-rank pool bytes; under
    the batch split, live sequences in every rank's block of slots."""
    import tempfile

    from flexflow_tpu_torch.runtime.distributed import spawn

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    shared = torch.cuda.device_count() < SERVE_RANKS
    legs = serve_legs()
    heads, layers = FULL["num_heads"], FULL["num_layers"]
    # the known legs' per-rank decode shapes, before the ranks spawn
    check_decode_shapes(seed, [
        (FRAME_SLOTS, heads // SERVE_RANKS, "bf16"),
        (FRAME_SLOTS // SERVE_RANKS, heads, "fp32"),
        (FRAME_SLOTS, heads // SERVE_RANKS, "int8")])
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    ranks = spawn(_serve_rank, SERVE_RANKS, (seed, tmp.name),
                  init_method=f"tcp://localhost:{free_port()}",
                  device="cuda", timeout=SP_TIMEOUT_S)
    ranks_wall = time.perf_counter() - t0
    events = {}
    for leg in legs:
        for rk in range(SERVE_RANKS):
            with open(os.path.join(tmp.name,
                                   f"{leg}_rank{rk}.jsonl")) as f:
                events[(leg, rk)] = [json.loads(line) for line in f]
    r0 = ranks[0]
    want_transport = "gloo-host" if shared else "nccl"
    one_pool = {  # one process's pool bytes per dtype (phase 4's shape)
        dt: FULL["num_layers"] * 2 * FRAME_SLOTS * FULL["pages_per_seq"]
        * FULL["page_size"] * FULL["hidden"] * size
        for dt, size in (("fp32", 4), ("bf16", 2), ("int8", 1))}
    scales = (FULL["num_layers"] * 2 * FRAME_SLOTS * FULL["pages_per_seq"]
              * FULL["page_size"] * 4)
    report = {"card": CARD_LINE[0], "ranks": SERVE_RANKS,
              "transport": r0["transport"], "ranks_wall_s": ranks_wall,
              "legs": {}}
    check_decode_shapes(seed, sorted({s for r in ranks for leg in legs
                                      for s in (r[leg]["decode_shapes"]
                                                or ())}))
    refs = {}
    ms = lambda x: None if x is None else x * 1e3  # noqa: E731
    for leg, (degrees, opts, lane) in legs.items():
        rl = r0[leg]
        kv = rl["kv_meta"]["dtype"] if rl["kv_meta"] else opts.get(
            "kv_precision", "fp32")
        key = (kv, lane)
        if key not in refs:
            if refs:
                old = refs.pop(next(iter(refs)))
                del old
                gc.collect()
                torch.cuda.empty_cache()
            refs[key] = serve_reference(seed, opts, kv, lane)
        ref_tokens, margins, model, step = refs[key]
        # every replica's whole run, logged on its block's first rank
        logged = {i: path for r in ranks for i, path in r[leg]["logs"].items()}
        n_replicas = 1 if rl["fleet"] is None else len(rl["fleet"]["replicas"])
        check(sorted(logged) == list(range(n_replicas)),
              f"{leg}: logs of replicas {sorted(logged)}, want "
              f"{n_replicas}")
        diff, replayed, flips = 0.0, 0, 0
        for path in logged.values():
            d, n, f = replay_diff(model, step,
                                  torch.load(path, weights_only=False))
            diff, replayed, flips = max(diff, d), replayed + n, flips + f
        want_frames = sum(r[leg]["frames"] for r in ranks
                          if r[leg]["logs"])
        check(replayed == want_frames, f"{leg}: {replayed} frames "
              f"replayed, the logged ranks ran {want_frames}")
        check(diff <= SERVE_PATH_TOL, f"{leg}: a frame's logits differ "
              f"from one process's on the same calls by {diff:.3e} > "
              f"{SERVE_PATH_TOL}")
        checked, excused, lost = token_parity(rl["tokens"], ref_tokens,
                                              margins, diff)
        kernel = ("ragged_paged_attention_quant" if kv == "int8"
                  else "ragged_paged_attention")
        other = ("ragged_paged_attention" if kv == "int8"
                 else "ragged_paged_attention_quant")
        host = [(sum(c["host_bytes"]
                     for c in r[leg]["collectives"].values())
                 - r[leg]["chunk_passes"]["host_bytes"])
                / max(r[leg]["frames"], 1) for r in ranks]
        chunk_host = [r[leg]["chunk_passes"]["host_bytes"]
                      / max(r[leg]["chunk_passes"]["passes"], 1)
                      for r in ranks]
        per_frame = [r[leg]["launches"][kernel] / max(r[leg]["frames"], 1)
                     for r in ranks]
        gen = sum(len(v) for v in rl["tokens"].values())
        report["legs"][leg] = {
            "strategy": rl["strategy"], "kv_dtype": kv,
            "fleet": rl["fleet"], "disaggregation": rl["disaggregation"],
            "decode_shapes": rl["decode_shapes"],
            "frames_per_rank": [r[leg]["frames"] for r in ranks],
            # one entry per replica (every replica's, gathered)
            "frame_p50_ms": [ms(x) for x in rl["frame_p50_s"]],
            "frame_p99_ms": [ms(x) for x in rl["frame_p99_s"]],
            # over every request of the leg (a fleet's merged records)
            "ttft_p50_ms": ms(rl["ttft_p50_s"]),
            "ttft_p99_ms": ms(rl["ttft_p99_s"]),
            "requests_recorded": rl["requests_recorded"],
            "slo_classes": rl["slo_classes"],
            "tokens_generated": gen,
            "tokens_per_s": gen / max(r[leg]["wall_s"] for r in ranks),
            "wall_s": max(r[leg]["wall_s"] for r in ranks),
            "compile_s": max(r[leg]["compile_s"] for r in ranks),
            "host_bytes_per_frame_per_rank": host,
            "chunk_passes_per_rank": [r[leg]["chunk_passes"]["passes"]
                                      for r in ranks],
            "host_bytes_per_chunk_pass_per_rank": chunk_host,
            "launches_per_rank_per_frame": per_frame,
            "pool_bytes_per_rank": [r[leg]["pool_bytes"] for r in ranks],
            "one_process_pool_bytes": one_pool[kv]
            + (scales if kv == "int8" else 0),
            "live_slots_per_replica": {i: len(v) for i, v in
                                       rl["live_slots"].items()},
            "frames_replayed": replayed,
            "logit_diff_every_frame": diff,
            "frame_rows_argmax_differs": flips,
            "requests_checked": checked, "requests_excused": excused,
            "tokens_excused": lost}
        check(rl["requests_recorded"] == SERVE_REQUESTS,
              f"{leg}: {rl['requests_recorded']} request records, want "
              f"{SERVE_REQUESTS}")
        for i, r in enumerate(ranks):
            check(r["transport"] == want_transport, f"rank {i}: transport "
                  f"{r['transport']}, want {want_transport}")
            check(r[leg]["tokens"] == rl["tokens"],
                  f"rank {i} {leg}: other tokens than rank 0's")
            check(r[leg]["launches"][kernel] == layers * r[leg]["frames"],
                  f"rank {i} {leg}: {kernel} launched "
                  f"{r[leg]['launches'][kernel]} times in "
                  f"{r[leg]['frames']} frames, want {layers} per frame")
            check(r[leg]["launches"][other] == 0,
                  f"rank {i} {leg}: {other} launched")
            hopped = sum(c["host_hops"]
                         for c in r[leg]["collectives"].values())
            if degrees is not None or rl["fleet"] is None:
                check((hopped > 0) == shared, f"rank {i} {leg}: {hopped} "
                      f"host hops with transport {r['transport']}")
        if degrees is not None:
            b, hsplit = degrees
            payload = one_pool[kv] / (b * hsplit)
            want = payload + (scales / b if kv == "int8" else 0)
            for i, r in enumerate(ranks):
                check(r[leg]["pool_bytes"] == want, f"rank {i} {leg}: "
                      f"pool {r[leg]['pool_bytes']} bytes, want {want}")
            # each batch coordinate's block of slots served live
            # sequences (rank i holds block i of a batch split)
            block = FRAME_SLOTS // b
            live = rl["live_slots"][0]
            per_block = [sum(j * block <= x < (j + 1) * block for x in live)
                         for j in range(b)]
            lr = report["legs"][leg]
            lr["live_slots_per_rank_block"] = per_block
            check(all(per_block), f"{leg}: live slots per rank block "
                  f"{per_block}: a rank served no live sequence")
        if rl["fleet"] is not None:
            routes = [e for (lg, rk), evs in events.items() if lg == leg
                      and rk == 0 for e in evs
                      if e.get("kind") == "fleet.route"]
            check(len(routes) == SERVE_REQUESTS, f"{leg}: {len(routes)} "
                  f"fleet.route events on rank 0, want {SERVE_REQUESTS}")
            for i, r in enumerate(ranks):
                check(r[leg]["assignments"] == rl["assignments"],
                      f"rank {i} {leg}: another routing than rank 0's")
    tmp.cleanup()
    report["phase_wall_s"] = time.perf_counter() - t_phase
    print("serving over ranks: " + json.dumps(report))
    print(f"serving over ranks, card: {CARD_LINE[0]}")
    for leg, lr in report["legs"].items():
        print(f"serving over ranks, {leg}: {lr['requests_checked']} "
              f"requests token-equal to one process, "
              f"{len(lr['requests_excused'])} excused at a near-tie "
              f"({lr['tokens_excused']} tokens); every frame replayed "
              f"({lr['frames_replayed']}): logit difference "
              f"{lr['logit_diff_every_frame']:.3e}, "
              f"{lr['frame_rows_argmax_differs']} frame rows with "
              f"another argmax")
    refs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return {leg: {"ragged_paged_attention": r0[leg]["launches"][
        "ragged_paged_attention"], "ragged_paged_attention_quant":
        r0[leg]["launches"]["ragged_paged_attention_quant"]}
        for leg in legs}


# ---------------------------------------------------------------------------
def zoo_data(model, n, seed):
    """``n`` samples for each frontend input of ``model`` (float inputs
    normal, ids below ZOO_ID_RANGE) and labels for its loss: class ids
    below the sink's width, or uniform [0, 1) targets of its shape."""
    rng = np.random.default_rng(seed)
    from flexflow_tpu_torch.core.ptensor import DataType

    xs = []
    for t in model._input_tensors:
        shape = (n,) + tuple(t.sizes[1:])
        if DataType.from_any(t.dtype).value.startswith("int"):
            xs.append(rng.integers(0, ZOO_ID_RANGE, size=shape).astype(
                np.int32))
        else:
            xs.append(rng.normal(size=shape).astype(np.float32))
    out = model.graph.sinks()[-1].op.output_shapes[0].sizes
    if out[-1] == 1:
        y = rng.uniform(0, 1, size=(n,) + tuple(out[1:])).astype(np.float32)
    else:
        y = rng.integers(0, out[-1], size=(n,)).astype(np.int32)
    return xs, y


def zoo_model(build, batch, seed, dtype="bfloat16", widths=None, **cfg):
    """``build`` from ``flexflow_tpu_torch.models`` at its defaults (or
    ZOO_WIDTHS', or ``widths``), compiled with SGD for its loss: CCE
    with accuracy for a classifier, MSE for a one-wide output."""
    from flexflow_tpu_torch import FFConfig, SGDOptimizer
    from flexflow_tpu_torch import models

    kw = dict(ZOO_WIDTHS.get(build, {}) if widths is None else widths)
    opts = dict(only_data_parallel=True)
    opts.update(cfg)
    strategy = opts.pop("strategy", {})
    model = getattr(models, build)(FFConfig(
        batch_size=batch, compute_dtype=dtype, seed=seed, **opts), **kw)
    wide = model.graph.sinks()[-1].op.output_shapes[0].sizes[-1]
    loss = (dict(loss_type="mean_squared_error",
                 metrics=["mean_squared_error"]) if wide == 1 else
            dict(loss_type="sparse_categorical_crossentropy",
                 metrics=["accuracy"]))
    model.compile(optimizer=SGDOptimizer(lr=ZOO_LR), strategy=strategy,
                  **loss)
    return model


def zoo_tensors(model):
    """The weights, the optimizer slots and the model state (batch-norm
    statistics): what a training step updates in place."""
    return train_tensors(model) + [t for t in model.state.values()
                                   if isinstance(t, torch.Tensor)]


def timed_steps(model, batches, n):
    """Host seconds of ``n`` synchronised ``train_step`` calls over
    ``batches`` in turn (captured unless inside ``eager()``), each with
    its own step seed (AlexNet's dropout draws masks from it)."""
    times = []
    for i in range(n):
        ins, lab = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.params, model.opt_state, model.state, _, _ = (
            model.compiled.train_step(model.params, model.opt_state,
                                      model.state, ins, lab,
                                      seed=10_000 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def device_batches(model, xs, y, batch):
    dev = model.compiled.device
    return [([torch.from_numpy(x[i:i + batch]).to(dev) for x in xs],
             torch.from_numpy(y[i:i + batch]).to(dev))
            for i in range(0, len(y), batch)]


def zoo_resnet50(seed, name):
    """Phase 14 (a): ResNet-50 at its defaults through ``fit``, captured
    and eagerly, against the same weights' fp32 forward."""
    from flexflow_tpu_torch.compiler.graphs import eager
    from flexflow_tpu_torch.losses import compute_loss

    b = ZOO_RESNET_BATCH
    free_models()
    # the fp32 forward of the same weights (seeded by name) on batch 0,
    # training-mode batch norm, no gradient; TF32 is off (phase 1)
    ref = zoo_model("build_resnet", b, seed, dtype="float32")
    xs, y = zoo_data(ref, ZOO_DATA_BATCHES * b, seed + 14)
    (ins, lab), = device_batches(ref, [xs[0][:b]], y[:b], b)
    with torch.no_grad():
        logits, _ = ref.compiled.apply(ref.params, ref.state, ins,
                                       train=True)
        fp32_loss = float(compute_loss(ref.compiled.loss_type, logits, lab))
    del ref, logits, ins, lab
    free_models()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = zoo_model("build_resnet", b, seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(w.numel() for ws in model.params.values()
                   for w in ws.values())
    flops = sum(n.op.flops() for n in model.graph.nodes.values())
    check(all(w.is_cuda for ws in model.params.values()
              for w in ws.values()), "ResNet-50's weights are not on the "
          "card")
    start = [t.clone() for t in zoo_tensors(model)]
    epochs = ZOO_RESNET_STEPS // ZOO_DATA_BATCHES
    runs = {}
    for tag, ctx in (("captured", None), ("eager", eager())):
        with torch.no_grad():
            for t, s in zip(zoo_tensors(model), start):
                t.copy_(s)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with ctx or contextlib.nullcontext():
            model.fit(xs, y, batch_size=b, epochs=epochs, shuffle=False,
                      verbose=False)
        torch.cuda.synchronize()
        runs[tag] = dict(
            losses=list(model.step_losses),
            tensors=[t.clone() for t in train_tensors(model)],
            fit_wall_s=time.perf_counter() - t0,
            images_per_s_fit=model.last_throughput,
            peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
    cap, eag = runs["captured"], runs["eager"]
    losses = cap["losses"]
    check(len(losses) == ZOO_RESNET_STEPS, f"fit ran {len(losses)} steps")
    check(bool(np.isfinite(losses).all()), f"ResNet-50 losses {losses}")
    first = np.mean(losses[:ZOO_DATA_BATCHES])
    last = np.mean(losses[-ZOO_DATA_BATCHES:])
    check(last < first, f"ResNet-50's loss did not fall over {epochs} "
          f"epochs: {first:.4f} -> {last:.4f}")
    bf16_err = abs(losses[0] - fp32_loss) / abs(fp32_loss)
    check(bf16_err <= ZOO_BF16_TOL, f"the first bf16 step's loss "
          f"{losses[0]:.6f} is {bf16_err:.3e} from the fp32 forward's "
          f"{fp32_loss:.6f} (> {ZOO_BF16_TOL})")
    equal = losses == eag["losses"] and same_bits(cap["tensors"],
                                                  eag["tensors"])
    diff = max(float((a.float() - c.float()).abs().max())
               for a, c in zip(cap["tensors"], eag["tensors"]))
    check(equal, f"captured ResNet-50 steps differ from eager under "
          f"deterministic cuDNN: losses {losses} vs {eag['losses']}, "
          f"largest weight difference {diff:.3e}")
    del start
    batches = device_batches(model, xs, y, b)
    times = {}
    for tag, ctx in (("captured", None), ("eager", eager())):
        with ctx or contextlib.nullcontext():
            timed_steps(model, batches, 2)  # warm
            times[tag] = timed_steps(model, batches, ZOO_RESNET_STEPS)
    graph = model.compiled.step_graph
    prof = profile_window(
        lambda: timed_steps(model, batches, 1), ZOO_PROFILE_STEPS, "step",
        groups=ZOO_KERNEL_GROUPS)
    p50 = float(np.median(times["captured"]))
    bf16_peak = card_peaks(name)[2]
    report = {
        "config": dict(model="build_resnet", image=224,
                       layers=[3, 4, 6, 3], classes=1000, batch=b,
                       compute="bfloat16", optimizer=f"sgd {ZOO_LR}"),
        "parameters": n_params, "forward_flops": flops,
        "build_compile_s": build_s,
        "fit_steps": len(losses),
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_first_epoch_mean": float(first),
        "loss_last_epoch_mean": float(last),
        "fp32_forward_loss": fp32_loss, "bf16_vs_fp32_rel": bf16_err,
        "captured_equals_eager": True,
        "captured_replays": replays(graph),
        "cudnn": {"deterministic": torch.backends.cudnn.deterministic,
                  "benchmark": torch.backends.cudnn.benchmark,
                  "allow_tf32": torch.backends.cudnn.allow_tf32},
        "step_p50_ms": {k: float(np.median(v)) * 1e3
                        for k, v in times.items()},
        "step_p90_ms": {k: float(np.quantile(v, 0.9)) * 1e3
                        for k, v in times.items()},
        "images_per_s": b / p50,
        "images_per_s_fit": {k: r["images_per_s_fit"]
                             for k, r in runs.items()},
        "mfu_vs_dense_bf16_peak": 3.0 * flops / p50 / bf16_peak,
        "peak_memory_gb_fit": {k: r["peak_gb"] for k, r in runs.items()},
        "fit_wall_s": {k: r["fit_wall_s"] for k, r in runs.items()},
        "profile": {k: v for k, v in prof.items()
                    if not k.startswith(("decode_attention",
                                         "phase_span"))},
    }
    if "top_device_ms_per_step" in prof:
        report["top5_device_ms_per_step"] = dict(list(
            prof["top_device_ms_per_step"].items())[:5])
    del model, graph, batches
    free_models()
    return report


def zoo_others(seed):
    """Phase 14 (b): every other builder at bench_zoo.py's shapes,
    ZOO_FIT_STEPS ``fit`` steps, then ZOO_TIMED synchronised captured
    steps."""
    out = {}
    for key, (build, batch) in ZOO_OTHERS.items():
        free_models()
        t0 = time.perf_counter()
        model = zoo_model(build, batch, seed)
        build_s = time.perf_counter() - t0
        xs, y = zoo_data(model, ZOO_FIT_STEPS * batch, seed + 15)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model.fit(xs, y, batch_size=batch, epochs=1, shuffle=False,
                  verbose=False)
        losses = list(model.step_losses)
        check(len(losses) == ZOO_FIT_STEPS and bool(
            np.isfinite(losses).all()), f"{key}: fit losses {losses}")
        times = timed_steps(model, device_batches(model, xs, y, batch),
                            ZOO_TIMED)
        p50 = float(np.median(times))
        out[key] = {
            "build": build, "batch": batch,
            "parameters": sum(w.numel() for ws in model.params.values()
                              for w in ws.values()),
            "build_compile_s": build_s, "losses": losses,
            "step_p50_ms": p50 * 1e3, "samples_per_s": batch / p50,
            "samples_per_s_fit": model.last_throughput,
            "peak_memory_gb": (torch.cuda.max_memory_allocated() - base)
            / 1e9}
        del model
    free_models()
    return out


def zoo_searched_dlrm(seed):
    """Phase 14 (c): DLRM through ``compile(strategy=None)`` on one card.
    At bench_zoo's 4 tables of 1 M rows the search keeps the plain
    lookups (the CPU search on ``h100_sxm(1)`` picks the same); with
    tables of ZOO_SMALL_ROWS rows it applies the batched embedding,
    which trains, its first loss within ZOO_SEARCHED_TOL of the
    unrewritten graph's on the same weights (the K tables stacked)."""
    b = ZOO_OTHERS["dlrm"][1]
    free_models()
    report = {}
    t0 = time.perf_counter()
    bench = zoo_model("build_dlrm", b, seed, only_data_parallel=False,
                      strategy=None)
    compile_s = time.perf_counter() - t0
    xs, y = zoo_data(bench, ZOO_FIT_STEPS * b, seed + 16)
    bench.fit(xs, y, batch_size=b, epochs=1, shuffle=False, verbose=False)
    check(bool(np.isfinite(bench.step_losses).all()),
          f"the searched bench DLRM's losses {bench.step_losses}")
    report["bench_tables"] = {
        "op_types": sorted({n.op.op_type.value
                            for n in bench.graph.topo_order()}),
        "compile_with_search_s": compile_s,
        "search_s": bench.search_stats.get("search_seconds"),
        "losses": list(bench.step_losses)}
    del bench
    free_models()
    small = dict(embedding_sizes=(ZOO_SMALL_ROWS,) * 4)
    plain = zoo_model("build_dlrm", b, seed, widths=small)
    t0 = time.perf_counter()
    searched = zoo_model("build_dlrm", b, seed, widths=small,
                         only_data_parallel=False, strategy=None)
    compile_s = time.perf_counter() - t0
    kinds = sorted({n.op.op_type.value for n in searched.graph.topo_order()})
    check({"stack", "batched_embedding", "unstack"} <= set(kinds)
          and "embedding" not in kinds,
          f"the searched DLRM holds no batched-embedding rewrite: {kinds}")
    be = next(n.op.name for n in searched.graph.topo_order()
              if n.op.op_type.value == "batched_embedding")
    tables = sorted(k for k in plain.params if k.startswith("embed_"))
    with torch.no_grad():
        for op, ws in plain.params.items():
            if op in searched.params:
                for w, v in ws.items():
                    searched.params[op][w].copy_(v)
        searched.params[be]["table"].copy_(torch.stack(
            [plain.params[k]["table"] for k in tables]))
    xs, y = zoo_data(plain, ZOO_FIT_STEPS * b, seed + 16)
    batches = device_batches(plain, xs, y, b)
    first = []
    for m in (plain, searched):
        ins, lab = batches[0]
        m.params, m.opt_state, m.state, loss, _ = m.compiled.train_step(
            m.params, m.opt_state, m.state, ins, lab)
        first.append(float(loss))
    rel = abs(first[1] - first[0]) / abs(first[0])
    check(rel <= ZOO_SEARCHED_TOL, f"the searched DLRM's first loss "
          f"{first[1]} is {rel:.3e} from the unrewritten graph's "
          f"{first[0]}")
    del plain
    searched.fit(xs, y, batch_size=b, epochs=1, shuffle=False,
                 verbose=False)
    losses = list(searched.step_losses)
    check(bool(np.isfinite(losses).all()), f"searched DLRM losses {losses}")
    times = timed_steps(searched, batches, ZOO_TIMED)
    p50 = float(np.median(times))
    report["small_tables"] = {
        "rows": ZOO_SMALL_ROWS, "op_types": kinds,
        "batched_embedding": be, "tables": len(tables),
        "compile_with_search_s": compile_s,
        "search_s": searched.search_stats.get("search_seconds"),
        "first_loss_unrewritten": first[0],
        "first_loss_searched": first[1], "first_loss_rel": rel,
        "losses": losses, "step_p50_ms": p50 * 1e3,
        "samples_per_s": b / p50}
    del searched, batches
    free_models()
    return report


def _zoo_ep_rank(rank, seed, xs, y):
    """One rank of phase 14 (d): ``build_moe`` at moe.cc's defaults in
    fp32 with the expert dim of ``dispatch``, ``expert_fc1`` and
    ``expert_fc2`` split ZOO_EP_RANKS ways, ZOO_FIT_STEPS SGD steps."""
    from flexflow_tpu_torch import FFConfig, SGDOptimizer
    from flexflow_tpu_torch.core.machine import MachineView
    from flexflow_tpu_torch.models import build_moe
    from flexflow_tpu_torch.parallel import mesh
    from flexflow_tpu_torch.runtime.distributed import transport

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = ZOO_EP_RANKS
    model = build_moe(FFConfig(batch_size=ZOO_EP_BATCH,
                               compute_dtype="float32", seed=seed,
                               num_devices=n),
                      **ZOO_WIDTHS.get("build_moe", {}))
    views = {nd.guid: MachineView.trivial(nd.op.output_shapes[0].ndim)
             for nd in model.graph.topo_order()}
    for op in ("dispatch", "expert_fc1", "expert_fc2"):
        nd = model.node_by_name(op)
        degs = [1] * nd.op.output_shapes[0].ndim
        degs[0] = n
        views[nd.guid] = MachineView(tuple(degs))
    model.compile(optimizer=SGDOptimizer(lr=ZOO_LR), strategy=views,
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    c = model.compiled
    dispatch = model.node_by_name("dispatch")
    mesh.reset_comm_counts()
    losses = []
    for i in range(ZOO_FIT_STEPS):
        sl = slice(i * ZOO_EP_BATCH, (i + 1) * ZOO_EP_BATCH)
        x, lab = xs[sl], y[sl]
        ins = [torch.from_numpy(x[c.input_slices(0, x.shape)]).to(c.device)]
        lab = torch.from_numpy(lab[c.label_slices(lab.shape)]).to(c.device)
        model.params, model.opt_state, model.state, loss, _ = c.train_step(
            model.params, model.opt_state, model.state, ins, lab)
        losses.append(float(loss))
    return {"transport": transport(), "losses": losses,
            "local_experts": c._out_pl[dispatch.guid][0].local_sizes(
                dispatch.op.output_shapes[0].sizes, c.mesh)[0],
            "weights": {op: {w: t.detach().cpu().numpy()
                             for w, t in ws.items()}
                        for op, ws in model.params.items()},
            "collectives": mesh.comm_counts()}


def zoo_ep_moe(seed):
    """Phase 14 (d): the ep-MoE leg over ZOO_EP_RANKS ranks (spawned as
    phase 7's), against one process's first-step loss (fp32, TF32 off)
    within ZOO_EP_TOL; every replicated weight bit-equal on every
    rank."""
    from flexflow_tpu_torch.runtime.distributed import spawn

    free_models()
    one = zoo_model("build_moe", ZOO_EP_BATCH, seed, dtype="float32")
    xs, y = zoo_data(one, ZOO_FIT_STEPS * ZOO_EP_BATCH, seed + 17)
    ins, lab = device_batches(one, xs, y, ZOO_EP_BATCH)[0]
    *_, loss, _ = one.compiled.train_step(one.params, one.opt_state,
                                          one.state, ins, lab)
    one_loss = float(loss)
    del one
    free_models()
    t0 = time.perf_counter()
    ranks = spawn(_zoo_ep_rank, ZOO_EP_RANKS, (seed, xs[0], y),
                  init_method=f"tcp://localhost:{free_port()}",
                  device="cuda", timeout=SP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    err = abs(r0["losses"][0] - one_loss) / abs(one_loss)
    check(err <= ZOO_EP_TOL, f"the ep-MoE's first loss {r0['losses'][0]} "
          f"is {err:.3e} from one process's {one_loss}")
    for r in ranks:
        check(r["losses"] == r0["losses"], "the ranks' losses differ")
        check(r["local_experts"] == 1,
              f"a rank holds {r['local_experts']} experts' slots")
        for op, ws in r0["weights"].items():
            for w, v in ws.items():
                check(r["weights"][op][w].tobytes() == v.tobytes(),
                      f"ep-MoE replica {op}/{w} differs between ranks")
    check(bool(np.isfinite(r0["losses"]).all()), "ep-MoE losses")
    return {"ranks": ZOO_EP_RANKS, "transport": r0["transport"],
            "losses": r0["losses"], "one_process_first_loss": one_loss,
            "first_loss_rel": err, "ranks_wall_s": wall,
            "collectives_rank0": r0["collectives"]}


def phase_zoo(seed, name):
    """Phase 14 (module docstring): the model zoo, one card (the ep-MoE
    leg over ranks on it).  cuDNN runs deterministic, without its
    autotuner, for the phase (the captured-against-eager comparison),
    and its settings are put back after."""
    from flexflow_tpu_torch.compiler.graphs import COUNTED

    t_phase = time.perf_counter()
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for k in COUNTED:
        k.launches = 0
    try:
        report = {"card": CARD_LINE[0]}
        t0 = time.perf_counter()
        report["a_resnet50"] = zoo_resnet50(seed, name)
        report["a_resnet50"]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["b_builders"] = zoo_others(seed)
        report["b_wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["c_searched_dlrm"] = zoo_searched_dlrm(seed)
        report["c_wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["d_ep_moe"] = zoo_ep_moe(seed)
        report["d_wall_s"] = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    launched = {k.__name__: k.launches for k in COUNTED}
    check(not any(launched.values()), f"the zoo launched rows 1-6: "
          f"{launched} (no TPU kernel lies on its path)")
    report["kernel_rows_launched"] = launched
    report["phase_wall_s"] = time.perf_counter() - t_phase
    print("zoo path: " + json.dumps(report))
    return report


# ---------------------------------------------------------------------------
# phase 15: the always-on loop
def ao_table(path):
    """A calibration table of probe records, coherent with any machine
    (no backend): the signature the controller watches."""
    from flexflow_tpu_torch.search.calibration import CalibrationTable

    t = CalibrationTable()
    t._t[("('probe', 16, 32)", (1, 1), 1)] = 1e-4
    t._t[("('probe', 16, 32)", (2, 1), 1)] = 6e-5
    t.backend = None
    t.save(path)


def ao_model(seed, layers, num_devices, mesh=None, **cfg):
    """Phase 6's GPT at ``layers`` layers, bf16, SGD at FFConfig's rate
    (no optimizer slots: the snapshots stay the weights'), data
    parallel; ``mesh``: lowered on that block of the job's ranks."""
    from flexflow_tpu_torch import FFConfig, SGDOptimizer
    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
    from flexflow_tpu_torch.models import build_gpt

    model = build_gpt(FFConfig(batch_size=TRAIN_BATCH, seed=seed,
                               num_devices=num_devices,
                               only_data_parallel=True, cost_cache_file="",
                               **cfg),
                      **dict(TRAIN, num_layers=layers))
    model._compile(optimizer=SGDOptimizer(lr=ZOO_LR),
                   loss_type="sparse_categorical_crossentropy",
                   metrics=["accuracy"],
                   strategy=(data_parallel_strategy(model.graph, num_devices)
                             if mesh is not None else None), mesh=mesh)
    return model


def ao_ids(seed, n):
    rng = np.random.default_rng(seed + 18)
    return rng.integers(0, TOKEN_RANGE, size=(
        n * TRAIN_BATCH, TRAIN["seq_len"] + 1)).astype(np.int32)


def ao_run(seed, spec, workdir, tag):
    """Phase 15 (a)'s run of fault plan ``spec``: the controller's
    output, the launches, and what the wrappers recorded."""
    from flexflow_tpu_torch.compiler.graphs import COUNTED
    from flexflow_tpu_torch.runtime import FaultPlan, TrainingController

    free_models()
    cal = os.path.join(workdir, f"calibration_{tag}.json")
    ao_table(cal)
    model = ao_model(seed, TRAIN["num_layers"], 1, calibration_file=cal)
    ctl = TrainingController(
        model, faults=FaultPlan.parse(spec, seed=seed),
        checkpoint_dir=os.path.join(workdir, f"ckpt_{tag}"),
        checkpoint_every=AO_CKPT_EVERY, max_retries=1,
        drift_window=4 * AO_STEPS)  # only the injected drift re-searches
    swaps = []
    swap = model.swap_strategy

    def swapping(*a, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = swap(*a, **kw)
        torch.cuda.synchronize()
        swaps.append({
            "allocated_before_gb": before / 1e9,
            "allocated_after_gb": torch.cuda.memory_allocated() / 1e9,
            "max_allocated_during_gb":
                torch.cuda.max_memory_allocated() / 1e9})
        return out

    model.swap_strategy = swapping
    ids = ao_ids(seed, AO_BATCHES)
    for k in COUNTED:
        k.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=AO_TORN_WARNING)
        out = ctl.run(ids[:, :-1], ids[:, 1:], steps=AO_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k.__name__: k.launches for k in COUNTED}
    mem = {"swaps": swaps,
           "allocated_end_gb": torch.cuda.memory_allocated() / 1e9}
    del model, ctl
    free_models()
    return out, launched, mem, wall


def always_on_one_card(seed, workdir):
    """Phase 15 (a)."""
    faulted, launched, mem, wall = ao_run(seed, AO_FAULTS, workdir,
                                          "faulted")
    clean, _, _, clean_wall = ao_run(seed, AO_CLEAN, workdir,
                                     "uninterrupted")
    st = faulted["stats"]
    steps = [h["step"] for h in faulted["history"]]
    check(steps == list(range(AO_STEPS)), f"faulted run's steps {steps}")
    triggers = [d["trigger"] for d in st["research_detail"]]
    counters = {k: st[k] for k in ("steps", "swaps", "recoveries",
                                   "retries", "fallbacks", "restores")}
    want = {"steps": AO_STEPS + 4, "swaps": 2, "recoveries": 1,
            "retries": 2, "fallbacks": 1, "restores": 1}
    check(counters == want and triggers == ["calibration_drift"],
          f"phase 15 (a): counters {counters} (want {want}), re-search "
          f"triggers {triggers}")
    got = [h["loss"] for h in faulted["history"]]
    ref = [h["loss"] for h in clean["history"]]
    check(got == ref, f"phase 15 (a): the drilled history {got} is not "
          f"bit-equal to the uninterrupted run's {ref}")
    check(bool(np.isfinite(got).all()), f"phase 15 (a): losses {got}")
    executed = counters["steps"]
    probes = {k: sum(d["launches"][k] for d in st["research_detail"])
              for k in launched}
    in_steps = {k: v - probes[k] for k, v in launched.items()}
    for wrapper in ("flash_forward", "flash_backward_dq",
                    "flash_backward_dkv"):
        check(in_steps[wrapper] == TRAIN["num_layers"] * executed,
              f"phase 15 (a): {wrapper} launched {in_steps[wrapper]} "
              f"times in {executed} executed steps (want "
              f"{TRAIN['num_layers']} per step; all {launched}, in the "
              f"re-search's probes {probes})")
    others = {k: v for k, v in launched.items()
              if k not in ("flash_forward", "flash_backward_dq",
                           "flash_backward_dkv")}
    check(not any(others.values()), f"phase 15 (a): rows 4-6 {others}")
    # the baseline is read at the first swap, after the re-search, so it
    # holds what the probes leave behind once (the profiler's L2-flush
    # buffer, the default stream's cuBLAS workspace); a swap must not
    # grow memory, nor may a later program once it has captured its
    # step (the end of the run is after the last program's capture)
    sw = mem["swaps"]
    for i, m in enumerate(sw):
        check(m["allocated_after_gb"] <= m["allocated_before_gb"]
              + AO_MEMORY_SLACK_GB,
              f"phase 15 (a): swap {i} grew allocated memory {m}")
    later = [m["allocated_before_gb"] for m in sw[1:]] + [
        mem["allocated_end_gb"]]
    check(max(later) <= sw[0]["allocated_before_gb"] + AO_MEMORY_SLACK_GB,
          f"phase 15 (a): allocated memory {later} GB at the later swaps "
          f"and the run's end grows past the first swap's "
          f"{sw[0]['allocated_before_gb']} GB")
    return {
        "steps": AO_STEPS, "executed_steps": executed, "counters": counters,
        "research_triggers": triggers, "losses": got,
        "swap_seconds": st["swap_seconds"],
        "research_seconds": st["research_seconds"],
        "restore_seconds": st["restore_seconds"], "swaps_memory": sw,
        "allocated_end_gb": mem["allocated_end_gb"],
        "launches": in_steps,
        "launches_research_probes": probes,
        "research_detail": st["research_detail"],
        "run_wall_s": wall, "uninterrupted_run_wall_s": clean_wall,
        "uninterrupted_swap_seconds": clean["stats"]["swap_seconds"]}


def _always_on_rank(rank, seed, ids, ckpt_dir):
    """One rank of phase 15 (b): data parallel over AO_RANKS ranks, the
    device loss at AO_LOSS_AT; the survivors then hold their first
    post-shrink loss to a fresh 2-rank model restored from the snapshot
    saved before the fault."""
    from flexflow_tpu_torch.compiler.graphs import COUNTED
    from flexflow_tpu_torch.runtime import FaultPlan, TrainingController
    from flexflow_tpu_torch.runtime import distributed
    from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager

    model = ao_model(seed, AO_LOSS_LAYERS, AO_RANKS)
    for k in COUNTED:
        k.launches = 0
    ctl = TrainingController(
        model, faults=FaultPlan.parse(f"device_loss@{AO_LOSS_AT}:2",
                                      seed=seed),
        checkpoint_dir=ckpt_dir, checkpoint_every=AO_LOSS_AT)
    x, y = ids[:, :-1], ids[:, 1:]
    t0 = time.perf_counter()
    out = ctl.run(x, y, steps=AO_LOSS_STEPS)
    torch.cuda.synchronize()
    res = {"rank": rank, "transport": distributed.transport(),
           "losses": [h["loss"] for h in out["history"]],
           "counters": {k: out["stats"][k] for k in ("steps", "swaps",
                                                     "recoveries")},
           "swap_seconds": out["stats"]["swap_seconds"],
           "lost": model.compiled is None,
           "launches": {k.__name__: k.launches for k in COUNTED},
           "run_wall_s": time.perf_counter() - t0}
    if res["lost"]:
        return res
    fresh = ao_model(seed, AO_LOSS_LAYERS, 2,
                     mesh=distributed.mesh_over(start=0, width=2))
    CheckpointManager(ckpt_dir).restore(fresh, step=AO_LOSS_AT - 1)
    c = fresh.compiled
    b = AO_LOSS_AT % (len(y) // TRAIN_BATCH)
    sl = slice(b * TRAIN_BATCH, (b + 1) * TRAIN_BATCH)
    ins = [torch.from_numpy(np.ascontiguousarray(
        x[sl][c.input_slices(0, x[sl].shape)])).to(c.device)]
    lab = torch.from_numpy(np.ascontiguousarray(
        y[sl][c.label_slices(y[sl].shape)])).to(c.device)
    fresh._rng_counter += 1
    *_, loss, _ = c.train_step(fresh.params, fresh.opt_state, fresh.state,
                               ins, lab, seed=fresh._rng_counter)
    res["fresh_first_loss"] = float(loss)
    return res


def always_on_ranks(seed, workdir):
    """Phase 15 (b)."""
    from flexflow_tpu_torch.runtime.distributed import spawn

    free_models()
    ids = ao_ids(seed + 1, AO_BATCHES)
    t0 = time.perf_counter()
    ranks = spawn(_always_on_rank, AO_RANKS,
                  (seed, ids, os.path.join(workdir, "ckpt_ranks")),
                  init_method=f"tcp://localhost:{free_port()}",
                  device="cuda", timeout=SP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    per_layer = AO_LOSS_LAYERS
    for r in ranks:
        lost = r["rank"] >= 2
        executed = r["counters"]["steps"]
        check(r["lost"] == lost and executed == (
            AO_LOSS_AT if lost else AO_LOSS_STEPS)
            and r["counters"]["recoveries"] == 1
            and r["counters"]["swaps"] == 1,
              f"phase 15 (b): rank {r['rank']}: lost {r['lost']}, "
              f"counters {r['counters']}")
        for wrapper in ("flash_forward", "flash_backward_dq",
                        "flash_backward_dkv"):
            check(r["launches"][wrapper] == per_layer * executed,
                  f"phase 15 (b): rank {r['rank']}: {wrapper} launched "
                  f"{r['launches'][wrapper]} times in {executed} steps")
        check(bool(np.isfinite(r["losses"]).all()),
              f"phase 15 (b): rank {r['rank']}: losses {r['losses']}")
    shrink = []
    for r in ranks[:2]:
        got, ref = r["losses"][AO_LOSS_AT], r["fresh_first_loss"]
        rel = abs(got - ref) / abs(ref)
        check(rel <= AO_SHRINK_TOL, f"phase 15 (b): rank {r['rank']}'s "
              f"first loss after the shrink {got} is {rel:.3e} from the "
              f"fresh 2-rank run's {ref}")
        shrink.append({"rank": r["rank"], "controller": got, "fresh": ref,
                       "rel": rel})
    return {"ranks": AO_RANKS, "layers": AO_LOSS_LAYERS,
            "transport": ranks[0]["transport"],
            "first_loss_after_shrink": shrink,
            "losses": {r["rank"]: r["losses"] for r in ranks},
            "swap_seconds": {r["rank"]: r["swap_seconds"] for r in ranks},
            "launches_per_rank": {r["rank"]: {
                k: v for k, v in r["launches"].items() if v}
                for r in ranks},
            "lost_ranks_returned": [r["rank"] for r in ranks if r["lost"]],
            "wall_s": wall}


def always_on_proofs(seed):
    """Phase 15 (c): the rewrite proofs evaluated on the card."""
    import flexflow_tpu_torch as tff
    from flexflow_tpu_torch.analysis.equivalence import (
        verify_registry,
        verify_rewrite,
    )
    from flexflow_tpu_torch.analysis.proofgen import verify_registry_generated
    from flexflow_tpu_torch.core.optype import OperatorType
    from flexflow_tpu_torch.search.substitution import GraphXfer, _bypass_node

    def drop_relu():
        def matcher(graph, node):
            return (node.op.op_type is OperatorType.RELU
                    and graph.in_edges[node.guid]
                    and graph.out_edges[node.guid])

        def apply_fn(graph, node):
            g = graph.copy()
            return g if _bypass_node(g, node.guid) is not None else None

        return GraphXfer(name="drop_relu_unsound", matcher=matcher,
                         apply_fn=apply_fn)

    def keyed(findings):
        return sorted((f.code, f.node, f.op, f.severity) for f in findings)

    out = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        gen, stats = verify_registry_generated(8, seed=seed, device=dev)
        zoo = verify_registry(8, seed=seed, device=dev)
        m = tff.FFModel(tff.FFConfig(batch_size=8, num_devices=8,
                                     only_data_parallel=True, device="cpu"))
        t = m.dense(m.create_tensor([8, 16], name="eq_x"), 16, name="eq_fc")
        m.dense(m.relu(t, name="eq_act"), 4, name="eq_head")
        xf = drop_relu()
        unsound = verify_rewrite(m.graph, xf, xf.find_matches(m.graph)[0],
                                 seed=seed, device=dev)
        diffs = [float(d.group(1)) for d in (
            re.search(r"max abs diff ([-+0-9.e]+)\)", f.message)
            for f in unsound) if d]
        out[dev] = {"findings": keyed(gen + zoo), "stats": stats,
                    "unsound": keyed(unsound), "unsound_diffs": diffs,
                    "seconds": time.perf_counter() - t0}
    cpu, card = out["cpu"], out["cuda"]
    check(not any(c.startswith("EQV3") for c, *_ in card["findings"]),
          f"phase 15 (c): the card's proofs found {card['findings']}")
    check(card["findings"] == cpu["findings"]
          and card["stats"] == cpu["stats"],
          f"phase 15 (c): the card's findings {card['findings']} and stats "
          f"{card['stats']} differ from the CPU's {cpu['findings']} "
          f"{cpu['stats']}")
    check(card["unsound"] == cpu["unsound"] and card["unsound"]
          and all(c == "EQV301" for c, *_ in card["unsound"]),
          f"phase 15 (c): the unsound rewrite gave {card['unsound']} on "
          f"the card, {cpu['unsound']} on the CPU")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card["unsound_diffs"],
                                                  cpu["unsound_diffs"]))
    check(rel <= AO_PROOF_TOL, f"phase 15 (c): the unsound rewrite's "
          f"diffs {card['unsound_diffs']} on the card, "
          f"{cpu['unsound_diffs']} on the CPU")
    return {"stats": card["stats"], "findings": card["findings"],
            "unsound_eqv301": card["unsound"],
            "unsound_diffs": {"cuda": card["unsound_diffs"],
                              "cpu": cpu["unsound_diffs"]},
            "seconds": {"cpu": cpu["seconds"], "cuda": card["seconds"]}}


def phase_always_on(seed, name):
    """Phase 15: the always-on loop, on one card and over AO_RANKS ranks,
    and the rewrite proofs on the card."""
    import tempfile

    t_phase = time.perf_counter()
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as workdir:
        report = {"card": CARD_LINE[0]}
        report["a_one_card"] = always_on_one_card(seed, workdir)
        report["b_device_loss"] = always_on_ranks(seed, workdir)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            report["c_proofs"] = always_on_proofs(seed)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
    report["phase_wall_s"] = time.perf_counter() - t_phase
    print("always-on path: " + json.dumps(report))
    return report



# ---------------------------------------------------------------------------
# phase 16: the measured side of the loop
def trace_doc_events(path):
    """The ``X`` rows of a Chrome-trace file."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if isinstance(e, dict) and e.get("ph") == "X"]


DEVICE_OP_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_windows(path, phase):
    """Each device-side window of ``phase`` (the ``gpu_user_annotation``
    copy of the range) in a ``torch.profiler`` capture: its length, the
    union of the device operations inside it over its length (the busy
    share), the ten operations that took the most device time in it,
    and every operation's count by name."""
    rows = trace_doc_events(path)
    ops = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"]) for e in rows
                  if e.get("cat") in DEVICE_OP_CATS),
                 key=lambda o: o[0])
    out = []
    for w in sorted((e for e in rows if e["name"] == phase
                     and e.get("cat") == "gpu_user_annotation"),
                    key=lambda e: e["ts"]):
        s, e = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        inside = [o for o in ops if s <= o[0] < e]
        busy, cur = 0.0, None
        for a, b, _ in inside:
            b = min(b, e)
            if cur is None or a > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
        if cur is not None:
            busy += cur[1] - cur[0]
        by_name, counts = {}, {}
        for a, b, name in inside:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
            counts[name] = counts.get(name, 0) + 1
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        out.append({"window_ms": (e - s) / 1e3,
                    "device_busy_share": busy / max(e - s, 1e-9),
                    "device_ops": len(inside),
                    "top_device_ms": [[n[:160], t / 1e3] for n, t in top],
                    "counts": counts})
    return out


@contextlib.contextmanager
def timed_capture():
    """Time ``DeviceTrace``'s start and stop (the profiler's start and
    its trace's export) and the model's ingest while the block runs:
    yields a dict of lists of seconds."""
    from flexflow_tpu_torch import model as model_mod
    from flexflow_tpu_torch.runtime.profiler import DeviceTrace

    spent = {"start_s": [], "stop_s": [], "ingest_s": []}
    saved = (DeviceTrace.start, DeviceTrace.stop,
             model_mod.FFModel._ingest_device_trace)

    def timing(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key].append(time.perf_counter() - t0)
        return run

    DeviceTrace.start = timing(saved[0], "start_s")
    DeviceTrace.stop = timing(saved[1], "stop_s")
    model_mod.FFModel._ingest_device_trace = timing(saved[2], "ingest_s")
    try:
        yield spent
    finally:
        (DeviceTrace.start, DeviceTrace.stop,
         model_mod.FFModel._ingest_device_trace) = saved


def kernel_count(window, fragment):
    return sum(c for n, c in window["counts"].items() if fragment in n)


FLASH_SYMBOLS = {"flash_forward": "flash_fwd_tc_kernel",
                 "flash_backward_dq": "flash_bwd_dq_tc_kernel",
                 "flash_backward_dkv": "flash_bwd_dkv_tc_kernel"}


def obs_fit(seed, workdir):
    """Phase 16 (a), training: phase 6's model through ``fit`` with
    ``profiling``, ``device_trace_dir``, the bus, the predicted timeline
    and both dot exports; OBS_WARM_STEPS steps before the capture (a
    ``fit`` of one step without ``device_trace_dir``, then the captured
    ``fit``'s first call), the profiler's warm-up step, then
    OBS_CAPTURED_STEPS captured."""
    from flexflow_tpu_torch import AdamOptimizer, FFConfig
    from flexflow_tpu_torch.compiler.graphs import COUNTED
    from flexflow_tpu_torch.models import build_gpt
    from flexflow_tpu_torch.obs.annotate import STEP_PHASE
    from flexflow_tpu_torch.obs.events import BUS, validate_event
    from flexflow_tpu_torch.obs.trace_ingest import find_trace_file, ingest

    free_models()
    files = {k: os.path.join(workdir, name) for k, name in (
        ("obs_log_file", "bus.jsonl"), ("obs_trace_file", "predicted.json"),
        ("export_strategy_computation_graph_file", "graph.dot"),
        ("export_strategy_task_graph_file", "taskgraph.dot"))}
    cap_dir = os.path.join(workdir, "fit_trace")
    model = build_gpt(FFConfig(batch_size=TRAIN_BATCH,
                               compute_dtype="bfloat16", seed=seed,
                               profiling=True, **files), **TRAIN)
    model.compile(optimizer=AdamOptimizer(alpha=ADAM_ALPHA),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    rng = np.random.default_rng(seed + 3)  # phase 6's batches
    steps = OBS_WARM_STEPS + OBS_PROFILER_WARM + OBS_CAPTURED_STEPS
    ids = rng.integers(0, TOKEN_RANGE, size=(
        steps * TRAIN_BATCH, TRAIN["seq_len"] + 1)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    model.fit(x[:TRAIN_BATCH], y[:TRAIN_BATCH], batch_size=TRAIN_BATCH,
              shuffle=False, verbose=False)  # the step's capture
    model.config.device_trace_dir = cap_dir
    for k in COUNTED:
        k.launches = 0
    t0 = time.perf_counter()
    with timed_capture() as capture_cost:
        model.fit(x[TRAIN_BATCH:], y[TRAIN_BATCH:], batch_size=TRAIN_BATCH,
                  shuffle=False, verbose=False)
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    launched = {k.__name__: k.launches for k in COUNTED}
    BUS.close()
    trace_file = find_trace_file(cap_dir, "rank0")
    check(trace_file is not None, "phase 16 (a): fit wrote no capture")
    t0 = time.perf_counter()
    got = ingest(trace_file, emit=False)
    windows = device_windows(trace_file, STEP_PHASE)
    read_s = time.perf_counter() - t0
    layers = TRAIN["num_layers"]
    fit_steps = steps - 1
    check(len(got.step_spans) == OBS_CAPTURED_STEPS
          and len(windows) == OBS_CAPTURED_STEPS
          and got.source == "device_trace",
          f"phase 16 (a): {len(got.step_spans)} step windows "
          f"({len(windows)} on the device, source {got.source}), want "
          f"{OBS_CAPTURED_STEPS} from the device copies")
    for wrapper, symbol in FLASH_SYMBOLS.items():
        check(launched[wrapper] == layers * fit_steps,
              f"phase 16 (a): {wrapper} counted {launched[wrapper]} "
              f"launches in {fit_steps} steps, want {layers} per step")
        seen = [kernel_count(w, symbol) for w in windows]
        check(seen == [layers] * OBS_CAPTURED_STEPS,
              f"phase 16 (a): {symbol} in the step windows {seen}, want "
              f"{layers} in each (the counters' {layers} per step)")
    others = {k: v for k, v in launched.items() if k not in FLASH_SYMBOLS}
    check(not any(others.values()), f"phase 16 (a): rows 4-6 {others}")
    prof = model.profile_summary
    check(prof is not None and prof["steps"] == fit_steps - 1
          and not prof["includes_compile"],
          f"phase 16 (a): StepProfiler summary {prof}")
    with open(files["obs_log_file"]) as f:
        events = [json.loads(line) for line in f if line.strip()]
    bad = [e for e in events if validate_event(e)]
    kinds = sorted({e.get("kind") for e in events})
    check(not bad and "profile.summary" in kinds and "drift.report" in kinds,
          f"phase 16 (a): bus log kinds {kinds}, {len(bad)} invalid")
    with open(files["obs_trace_file"]) as f:
        predicted = json.load(f)
    check(predicted["otherData"]["simulated_step_s"] > 0
          and any(e.get("ph") == "X" for e in predicted["traceEvents"]),
          "phase 16 (a): the predicted timeline is empty")
    for k in ("export_strategy_computation_graph_file",
              "export_strategy_task_graph_file"):
        with open(files[k]) as f:
            check(f.read().startswith("digraph"),
                  f"phase 16 (a): {k} is not graphviz")
    report = {
        "captured_steps": len(windows), "source": got.source,
        "trace_events": got.events,
        "trace_mb": os.path.getsize(trace_file) / 1e6,
        "ingest_and_read_s": read_s, "fit_wall_s": fit_wall,
        "capture_cost": capture_cost,
        "launches": launched, "profile": prof,
        "drift_ratio": model.drift_report.ratio
        if model.drift_report is not None else None,
        "predicted_step_s": predicted["otherData"]["simulated_step_s"],
        "bus_events": len(events), "bus_kinds": kinds,
        "windows": [{k: w[k] for k in ("window_ms", "device_busy_share",
                                       "device_ops", "top_device_ms")}
                    for w in windows]}
    del model
    free_models()
    return report


def obs_serve(seed, workdir):
    """Phase 16 (a), serving: OBS_FRAMES frames of phase 4's executor
    (its captured frame, replayed) under ``device_trace``, after one
    frame under it with the annotations disarmed (the profiler's
    warm-up, as ``fit``'s)."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention,
    )
    from flexflow_tpu_torch.models import build_gpt_decode
    from flexflow_tpu_torch.obs import annotate
    from flexflow_tpu_torch.obs.annotate import DECODE_PHASE
    from flexflow_tpu_torch.obs.trace_ingest import ingest
    from flexflow_tpu_torch.runtime.decode import (
        ContinuousBatchingExecutor,
        DecodeRequest,
        compiled_decode_step,
    )
    from flexflow_tpu_torch.runtime.profiler import device_trace

    free_models()
    model = build_gpt_decode(FFConfig(batch_size=FRAME_SLOTS,
                                      compute_dtype="bfloat16", seed=seed),
                             **FULL)
    model.compile(comp_mode="inference")
    step = compiled_decode_step(model)

    def executor():
        return ContinuousBatchingExecutor(
            step, max_seqs=FRAME_SLOTS, page_size=FULL["page_size"],
            pages_per_seq=FULL["pages_per_seq"])

    executor().run([DecodeRequest(rid="warm", prompt=[1, 2, 3],
                                  max_new_tokens=4)])  # the capture
    zero_state(model)
    ex = executor()
    ex.submit(make_requests(seed, FULL["vocab"]))
    ragged_paged_attention.launches = 0
    replays0 = replays(step.graph)
    with device_trace(os.path.join(workdir, "serve_trace"),
                      model.compiled.device) as trace:
        annotate.disarm()  # the profiler's warm-up frame, no window
        ex.step()
        torch.cuda.synchronize()
        annotate.arm()
        for _ in range(OBS_FRAMES):
            ex.step()
    launches = ragged_paged_attention.launches - FULL["num_layers"]
    frames = replays(step.graph) - replays0 - OBS_PROFILER_WARM
    got = ingest(trace.trace_file, emit=False)
    windows = device_windows(trace.trace_file, DECODE_PHASE)
    layers = FULL["num_layers"]
    seen = [kernel_count(w, "rpa_split_kernel") for w in windows]
    check(len(got.phases.get(DECODE_PHASE, ())) == OBS_FRAMES
          and got.source == "device_trace" and frames == OBS_FRAMES,
          f"phase 16 (a): {len(got.phases.get(DECODE_PHASE, ()))} decode "
          f"frame spans ({got.source}), {frames} replays, want "
          f"{OBS_FRAMES} on the device")
    check(seen == [layers] * OBS_FRAMES and launches == layers * frames,
          f"phase 16 (a): rpa_split_kernel in the frame windows {seen}, "
          f"{launches} counted, want {layers} per frame")
    report = {"frames": frames, "source": got.source,
              "launches": launches,
              "windows": [{k: w[k] for k in ("window_ms",
                                             "device_busy_share",
                                             "device_ops")}
                          for w in windows],
              "top_device_ms_first_frame": (windows[0]["top_device_ms"]
                                            if windows else None)}
    del model, step, ex
    free_models()
    return report


def obs_scrape():
    """Phase 16 (b): the metrics registry's text over loopback."""
    import urllib.request

    from flexflow_tpu_torch.obs.exposition import MetricsServer

    server = MetricsServer(0)  # a free loopback port
    try:
        url = f"http://{server.host}:{server.port}/metrics"
        t0 = time.perf_counter()
        with urllib.request.urlopen(url, timeout=30) as r:
            status, body = r.status, r.read().decode()
        scrape_s = time.perf_counter() - t0
    finally:
        server.close()
    families = {}
    for line in body.splitlines():
        if line.startswith("# TYPE "):
            _, _, fam, kind = line.split(" ", 3)
            families[fam] = kind
    check(status == 200 and families.get("flexflow_tpu_fit_steps")
          == "counter" and families.get("flexflow_tpu_fit_step_s")
          == "summary",
          f"phase 16 (b): /metrics gave {status} with families "
          f"{sorted(families)}")
    return {"port": server.port, "families": len(families),
            "bytes": len(body), "scrape_s": scrape_s,
            "fit_families": sorted(f for f in families if "_fit_" in f)}


def _obs_sync_rank(rank, seed, ids, shared, trace_dir):
    """One rank of phase 16 (c): phase 12's leg (d) with profiling and
    ``device_trace_dir``, 2 + OBS_SYNC_STEPS steps (the capture starts
    after the first, its windows after the profiler's warm-up step)."""
    import torch.distributed as dist

    from flexflow_tpu_torch.compiler.graphs import COUNTED
    from flexflow_tpu_torch.obs.annotate import LANES
    from flexflow_tpu_torch.runtime.controller import TrainingController

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _ = sync_legs(shared, None)["d_schedule"]
    model = sync_model(seed, profiling=True, device_trace_dir=trace_dir,
                       **cfg)
    x, y = ids[:, :-1], ids[:, 1:]
    for k in COUNTED:
        k.launches = 0
    dist.barrier()
    t0 = time.perf_counter()
    with timed_capture() as capture_cost:
        model.fit(x, y, batch_size=TRAIN_BATCH, shuffle=False,
                  verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    report = model.lane_drift_report
    windows = None
    if rank == 0:  # where a shared-card dp 4 step's device time goes
        from flexflow_tpu_torch.obs.annotate import STEP_PHASE
        from flexflow_tpu_torch.obs.trace_ingest import find_trace_file

        windows = [{k: w[k] for k in ("window_ms", "device_busy_share",
                                      "device_ops", "top_device_ms")}
                   for w in device_windows(
                       find_trace_file(trace_dir, "rank0"), STEP_PHASE)]
    ctl = TrainingController(model)
    ctl._watch_drift(0)  # the drift watch reads the model's report
    return {"report": None if report is None else report.to_dict(),
            "controller_read": report is not None
            and ctl._lane_seen is report,
            "recorder": {k: [(b - a) for a, b in v]
                         for k, v in LANES.spans().items()},
            "launches": {k.__name__: k.launches for k in COUNTED},
            "losses": list(model.step_losses), "fit_wall_s": wall,
            "schedule": model.compiled.sync_schedule.to_jsonable(),
            "profile": model.profile_summary, "capture_cost": capture_cost,
            "windows": windows}


def obs_sync(seed, workdir):
    """Phase 16 (c): the searched, bucketed, issue-ordered schedule at
    dp 4 (phase 12's leg (d)) captured for OBS_SYNC_STEPS steps."""
    from flexflow_tpu_torch.runtime.distributed import spawn

    free_models()
    shared = torch.cuda.device_count() < SYNC_RANKS
    rng = np.random.default_rng(seed + 3)  # phase 6's batches
    ids = rng.integers(0, TOKEN_RANGE, size=(
        (OBS_SYNC_STEPS + 1 + OBS_PROFILER_WARM) * TRAIN_BATCH,
        TRAIN["seq_len"] + 1)).astype(np.int32)
    trace_dir = os.path.join(workdir, "sync_trace")
    t0 = time.perf_counter()
    ranks = spawn(_obs_sync_rank, SYNC_RANKS,
                  (seed, ids, shared, trace_dir),
                  init_method=f"tcp://localhost:{free_port()}",
                  device="cuda", timeout=SP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    layers = TRAIN["num_layers"]
    out = {"ranks_wall_s": wall, "per_rank": []}
    for i, r in enumerate(ranks):
        rep = r["report"]
        check(rep is not None and rep["matched_all"]
              and rep["steps"] == OBS_SYNC_STEPS,
              f"phase 16 (c) rank {i}: lane report {rep}")
        check(all(row["measured_sync_s"] is not None
                  and row["measured_sync_s"] > 0
                  and row["samples"] == OBS_SYNC_STEPS
                  for row in rep["lanes"]),
              f"phase 16 (c) rank {i}: lanes {rep['lanes']}")
        check(r["controller_read"], f"phase 16 (c) rank {i}: the "
              f"controller did not take the model's lane report")
        check(r["schedule"] == ranks[0]["schedule"]
              and r["losses"] == ranks[0]["losses"]
              and bool(np.isfinite(r["losses"]).all()),
              f"phase 16 (c) rank {i}: schedule or losses differ")
        for wrapper in FLASH_SYMBOLS:
            check(r["launches"][wrapper]
                  == layers * (OBS_SYNC_STEPS + 1 + OBS_PROFILER_WARM),
                  f"phase 16 (c) rank {i}: {wrapper} launched "
                  f"{r['launches'][wrapper]} times")
        print(f"phase 16 (c) rank {i}: lane source {rep['source']}, "
              f"{rep['matched']}/{len(rep['lanes'])} lanes matched")
        out["per_rank"].append({
            "source": rep["source"], "matched": rep["matched"],
            "measured_step_s": rep["measured_step_s"],
            "predicted_total_s": rep["predicted_total_s"],
            "lanes": [{k: row[k] for k in (
                "lane", "samples", "predicted_issue_s", "predicted_sync_s",
                "measured_issue_s", "measured_sync_s", "sync_frac_ratio")}
                for row in rep["lanes"]],
            "stale_lanes": rep["stale_lanes"],
            "recorder_sync_s": r["recorder"], "fit_wall_s": r["fit_wall_s"],
            "profile": r["profile"], "capture_cost": r["capture_cost"],
            "launches": {k: r["launches"][k] for k in FLASH_SYMBOLS}})
    out["rank0_step_windows"] = ranks[0]["windows"]
    return out


def phase_observability(seed, name):
    """Phase 16: the measured side of the loop."""
    import tempfile

    t_phase = time.perf_counter()
    report = {"card": CARD_LINE[0]}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as workdir:
        t0 = time.perf_counter()
        report["a_fit"] = obs_fit(seed, workdir)
        report["a_serve"] = obs_serve(seed, workdir)
        report["a_s"] = time.perf_counter() - t0
        report["b_scrape"] = obs_scrape()
        t0 = time.perf_counter()
        report["c_sync"] = obs_sync(seed, workdir)
        report["c_s"] = time.perf_counter() - t0
    report["phase_wall_s"] = time.perf_counter() - t_phase
    print("observability path: " + json.dumps(report))
    return report

# ---------------------------------------------------------------------------
# phase 17: the frontends, keras and the command line
class FxBertEmbeddings(torch.nn.Module):
    """``transformers.BertModel``'s embeddings: word, position and
    token-type tables summed, then LayerNorm.  The position and
    token-type ids are buffers of the sequence's length (the importer
    folds them into constants)."""

    def __init__(self, vocab, hidden, seq_len, eps):
        super().__init__()
        self.word = torch.nn.Embedding(vocab, hidden)
        self.position = torch.nn.Embedding(seq_len, hidden)
        self.token_type = torch.nn.Embedding(2, hidden)
        self.norm = torch.nn.LayerNorm(hidden, eps=eps)
        self.register_buffer("position_ids", torch.arange(seq_len)[None])
        self.register_buffer("token_type_ids",
                             torch.zeros(1, seq_len, dtype=torch.long))

    def forward(self, ids):
        e = (self.word(ids) + self.position(self.position_ids)
             + self.token_type(self.token_type_ids))
        return self.norm(e)


class FxBertLayer(torch.nn.Module):
    """A post-LN BERT encoder layer: separate q, k and v Linears,
    non-causal ``scaled_dot_product_attention``, the output projection,
    then the exact-erf GELU feed-forward."""

    def __init__(self, hidden, heads, ff_dim, eps):
        super().__init__()
        self.heads = heads
        self.query = torch.nn.Linear(hidden, hidden)
        self.key = torch.nn.Linear(hidden, hidden)
        self.value = torch.nn.Linear(hidden, hidden)
        self.attn_out = torch.nn.Linear(hidden, hidden)
        self.attn_norm = torch.nn.LayerNorm(hidden, eps=eps)
        self.ff_in = torch.nn.Linear(hidden, ff_dim)
        self.act = torch.nn.GELU()
        self.ff_out = torch.nn.Linear(ff_dim, hidden)
        self.ff_norm = torch.nn.LayerNorm(hidden, eps=eps)

    def forward(self, x):
        b, s, h = x.shape
        d = h // self.heads
        q = self.query(x).view(b, s, self.heads, d).transpose(1, 2)
        k = self.key(x).view(b, s, self.heads, d).transpose(1, 2)
        v = self.value(x).view(b, s, self.heads, d).transpose(1, 2)
        a = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        a = a.transpose(1, 2).reshape(b, s, h)
        x = self.attn_norm(x + self.attn_out(a))
        return self.ff_norm(x + self.ff_out(self.act(self.ff_in(x))))


class FxBert(torch.nn.Module):
    """A plain-torch module shaped like ``transformers.BertModel`` (the
    card's host has no ``transformers``), with a mean-pool, a tanh
    pooler and a classification head; weights drawn as BERT's are
    (normal, std 0.02; biases 0) from ``seed``, on the CPU."""

    def __init__(self, vocab, num_layers, hidden, num_heads, ff_dim,
                 seq_len, num_classes=2, eps=1e-12, seed=0):
        super().__init__()
        self.embeddings = FxBertEmbeddings(vocab, hidden, seq_len, eps)
        self.layers = torch.nn.ModuleList(
            FxBertLayer(hidden, num_heads, ff_dim, eps)
            for _ in range(num_layers))
        self.pooler = torch.nn.Linear(hidden, hidden)
        self.head = torch.nn.Linear(hidden, num_classes)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (torch.nn.Linear, torch.nn.Embedding)):
                    m.weight.normal_(0.0, 0.02, generator=gen)
                if isinstance(m, torch.nn.Linear):
                    m.bias.zero_()

    def forward(self, ids):
        x = self.embeddings(ids)
        for layer in self.layers:
            x = layer(x)
        return self.head(torch.tanh(self.pooler(x.mean(dim=1))))


def fx_argv(seed, batch, epochs, *extra):
    """A leg's fixed command line: one card, its batch, epochs and seed."""
    return ["-b", str(batch), "-e", str(epochs), "--seed", str(seed),
            "-ll:tpu", "1", "--only-data-parallel", *extra]


def parsed_config(argv, **replaced):
    """``FFConfig.parse_args(argv)``, with ``replaced`` fields (those no
    flag sets, as the compute dtype), and the fields the leg uses."""
    import dataclasses

    from flexflow_tpu_torch import FFConfig

    cfg = dataclasses.replace(FFConfig.parse_args(argv), **replaced)
    used = {k: getattr(cfg, k) for k in (
        "batch_size", "epochs", "seed", "num_devices", "only_data_parallel",
        "learning_rate", "device", "compute_dtype")}
    return cfg, {"argv": list(argv), "fields": used}


def kernel_launches():
    from flexflow_tpu_torch.compiler.graphs import COUNTED

    return {k.__name__: k.launches for k in COUNTED}


def frontends_bert(seed, name, bert_step_ms=None):
    """Phase 17 (a): BERT-base widths imported through torch.fx from a
    module on the card, carried weights, ``predict`` against the
    module's own fp32 forward, ``fit`` captured, captured against eager
    and the step's device time by kind of kernel."""
    from flexflow_tpu_torch import AdamOptimizer, FFModel
    from flexflow_tpu_torch.compiler.graphs import eager
    from flexflow_tpu_torch.core.optype import OperatorType
    from flexflow_tpu_torch.frontends import (
        PyTorchModel,
        transfer_torch_weights,
    )

    b, seq = FX_BATCH, FX_BERT["seq_len"]
    cfg, parsed = parsed_config(fx_argv(seed, b, 1))
    free_models()
    base = torch.cuda.memory_allocated()
    dev = cfg.torch_device()
    rng = np.random.default_rng(seed + 17)
    ids = rng.integers(0, FX_BERT["vocab"], size=(FX_STEPS * b, seq)
                       ).astype(np.int32)
    labels = rng.integers(0, 2, size=(FX_STEPS * b,)).astype(np.int32)
    t0 = time.perf_counter()
    source = FxBert(**FX_BERT, seed=seed).to(dev).eval()
    example = torch.from_numpy(ids[:b]).long().to(dev)
    model = FFModel(cfg)
    x = model.create_tensor([b, seq], dtype="int32", name="ids")
    t1 = time.perf_counter()
    outs = PyTorchModel(source, example_inputs=[example]).torch_to_ff(
        model, [x])
    import_s = time.perf_counter() - t1
    check([tuple(o.sizes) for o in outs] == [(b, 2)],
          f"imported outputs {[o.sizes for o in outs]}")
    model.compile(optimizer=AdamOptimizer(alpha=ADAM_ALPHA),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    copied = transfer_torch_weights(source, model)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    kinds = {}
    for n in model.graph.nodes.values():
        kinds[n.op.op_type.name] = kinds.get(n.op.op_type.name, 0) + 1
    layers = FX_BERT["num_layers"]
    check(OperatorType.MULTIHEAD_ATTENTION.name not in kinds
          and kinds.get(OperatorType.BATCH_MATMUL.name) == 2 * layers
          and kinds.get(OperatorType.SOFTMAX.name) == layers,
          f"the imported graph's attention is not decomposed as the "
          f"importer's records say: {kinds}")
    want = 16 * layers + 5 + 4  # Linears and norms per layer; embeddings,
    check(copied == want, f"transfer_torch_weights copied {copied} "
          f"arrays, want {want}")  # their norm; pooler and head
    check(all(w.is_cuda for ws in model.params.values()
              for w in ws.values()), "the imported weights are not on the "
          "card")
    n_params = sum(w.numel() for ws in model.params.values()
                   for w in ws.values())
    flops = sum(n.op.flops() for n in model.graph.nodes.values())
    # predict (bf16 compute) against the source module's fp32 forward
    got = model.predict(ids[:b])
    with torch.no_grad():
        ref = source(example).float().cpu().numpy()
    pred_err = float(np.abs(got - ref).max() / np.abs(ref).max())
    check(pred_err <= ZOO_BF16_TOL, f"the imported BERT's predict is "
          f"{pred_err:.3e} (of its largest logit) from the source module's "
          f"fp32 forward (> {ZOO_BF16_TOL})")
    del source, example
    free_models()

    start = [t.clone() for t in train_tensors(model)]
    before = kernel_launches()  # the phase's count runs on across legs
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(ids, labels, batch_size=b, epochs=1, shuffle=False,
              verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in kernel_launches().items()}
    fit_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    losses = list(model.step_losses)
    check(len(losses) == FX_STEPS, f"fit ran {len(losses)} steps")
    check(bool(np.isfinite(losses).all()), f"imported BERT losses {losses}")
    check(not any(launched.values()), f"the imported BERT launched rows "
          f"1-6: {launched} (its attention is decomposed)")
    # FX_CMP_STEPS captured steps against eager ones, from one start
    runs = {}
    cmp_x, cmp_y = ids[:FX_CMP_STEPS * b], labels[:FX_CMP_STEPS * b]
    for tag, ctx in (("captured", None), ("eager", eager())):
        restore(model, start)
        with ctx or contextlib.nullcontext():
            model.fit(cmp_x, cmp_y, batch_size=b, epochs=1, shuffle=False,
                      verbose=False)
        runs[tag] = (list(model.step_losses),
                     [t.clone() for t in train_tensors(model)])
    cap, eag = runs["captured"], runs["eager"]
    check(cap[0] == eag[0] and same_bits(cap[1], eag[1]),
          f"{FX_CMP_STEPS} captured steps of the imported BERT differ from "
          f"eager: losses {cap[0]} vs {eag[0]}")
    check(cap[0] == losses[:FX_CMP_STEPS], f"the comparison's captured "
          f"losses {cap[0]} are not fit's first {losses[:FX_CMP_STEPS]}")
    del start, runs, cap, eag
    batches = device_batches(model, [ids], labels, b)
    timed_steps(model, batches, 2)  # warm
    times = timed_steps(model, batches, FX_TIMED_STEPS)
    prof = profile_window(lambda: timed_steps(model, batches, 1),
                          FX_PROFILE_STEPS, "step", groups=FX_KERNEL_GROUPS)
    p50 = float(np.median(times))
    report = {
        "command_line": parsed,
        "config": dict(FX_BERT, batch=b, compute=cfg.compute_dtype,
                       optimizer=f"adam {ADAM_ALPHA}"),
        "parameters": n_params, "forward_flops": flops,
        "graph_ops_by_type": kinds,
        "import_s": import_s, "build_import_compile_transfer_s": build_s,
        "weights_transferred": copied,
        "predict_vs_fp32_module_rel": pred_err,
        "fit_steps": len(losses), "fit_wall_s": fit_s,
        "loss_first": losses[0], "loss_last": losses[-1],
        "captured_equals_eager_steps": FX_CMP_STEPS,
        "step_p50_ms": p50 * 1e3,
        "step_p90_ms": float(np.quantile(times, 0.9)) * 1e3,
        "tokens_per_s": b * seq / p50,
        "mfu_vs_dense_bf16_peak": 3.0 * flops / p50 / card_peaks(name)[2],
        "peak_memory_gb_fit": fit_peak,
        "kernel_rows_launched_fit": launched,
        "phase11_build_bert_step_p50_ms": (
            bert_step_ms if bert_step_ms is not None
            else "not measured in this run"),
        "profile": {k: v for k, v in prof.items()
                    if not k.startswith(("decode_attention", "phase_span"))},
    }
    del model, batches
    free_models()
    return report


def frontends_keras(seed):
    """Phase 17 (b): the keras examples' models at their shapes on the
    datasets' synthetic fallback, the accuracy gate and a checkpoint
    restored into a fresh model."""
    import tempfile

    from flexflow_tpu_torch import keras
    from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager

    free_models()
    report = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (mx, my), _ = keras.datasets.mnist.load_data()
        (cx, cy), _ = keras.datasets.cifar10.load_data()
        (rx, ry), _ = keras.datasets.reuters.load_data(
            num_words=FX_REUTERS_WORDS, maxlen=100)
    fallback = [str(w.message) for w in caught
                if "SYNTHETIC" in str(w.message)]
    for msg in fallback:
        print("frontends path: " + msg)
    report["synthetic_fallback_warnings"] = len(fallback)
    check(len(fallback) == 3 or not fallback, f"{len(fallback)} of the 3 "
          f"loaders fell back to synthetic data")

    def leg(tag, cfg_argv, layers, optimizer, x, y, callbacks=(),
            **replaced):
        cfg, parsed = parsed_config(cfg_argv, **replaced)
        model = keras.Sequential(layers)
        model.compile(optimizer=optimizer,
                      loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"], config=cfg)
        check(all(w.is_cuda for ws in model.ffmodel.params.values()
                  for w in ws.values()), f"keras {tag}: weights not on "
              f"the card")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = model.fit(x, y, epochs=cfg.epochs, verbose=False,
                         callbacks=list(callbacks))
        torch.cuda.synchronize()
        losses = model.ffmodel.step_losses
        check(bool(np.isfinite(losses).all()), f"keras {tag}: losses "
              f"{losses}")
        report[tag] = {"command_line": parsed, "epochs_run": len(hist),
                       "steps": len(losses), "fit_wall_s":
                       time.perf_counter() - t0, "history": hist,
                       "samples_per_s_fit": model.ffmodel.last_throughput}
        return model, cfg

    L = keras.layers
    # examples/keras_mnist_mlp.py
    b = 64
    x = (mx[:b * 16].astype(np.float32) / 255.0).reshape(-1, 784)
    leg("mnist_mlp", fx_argv(seed, b, 2),
        [L.Dense(256, activation="relu", input_shape=(784,)),
         L.Dense(128, activation="relu"), L.Dropout(0.1), L.Dense(10)],
        keras.optimizers.SGD(0.05), x, my[:b * 16].astype(np.int32),
        [keras.callbacks.EarlyStopping(monitor="loss", patience=2)])
    # examples/keras_cifar10_cnn.py, with a checkpoint and early stopping
    b = 32
    x = (cx[:b * 16].transpose(0, 2, 3, 1) / 255.0).astype(np.float32)
    y = cy[:b * 16].astype(np.int32)

    def cifar_layers():
        return [L.Conv2D(32, (3, 3), activation="relu", padding="same",
                         input_shape=(32, 32, 3)),
                L.MaxPooling2D((2, 2)),
                L.Conv2D(64, (3, 3), activation="relu", padding="same"),
                L.MaxPooling2D((2, 2)), L.Flatten(),
                L.Dense(128, activation="relu"), L.Dropout(0.25),
                L.Dense(10)]

    with tempfile.TemporaryDirectory(prefix="keras_ckpt_") as ckpt_dir:
        cnn, cnn_cfg = leg(
            "cifar10_cnn", fx_argv(seed, b, 2), cifar_layers(),
            keras.optimizers.SGD(0.02), x, y,
            [keras.callbacks.ModelCheckpoint(ckpt_dir),
             keras.callbacks.EarlyStopping(monitor="loss", patience=3)])
        fresh = keras.Sequential(cifar_layers())
        fresh.compile(optimizer=keras.optimizers.SGD(0.02),
                      loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"], config=cnn_cfg)
        step = CheckpointManager(ckpt_dir).restore(fresh.ffmodel)
        want, got = cnn.predict(x[:2 * b]), fresh.predict(x[:2 * b])
        check(np.array_equal(want, got), f"the keras CNN restored from "
              f"ModelCheckpoint's step {step} predicts differently: largest "
              f"difference {float(np.abs(want - got).max()):.3e}")
        report["cifar10_cnn"]["checkpoint"] = {
            "restored_step": step, "predict_bit_equal": True,
            "snapshots": sorted(os.listdir(ckpt_dir))}
    del cnn, fresh
    # examples/keras_reuters_mlp.py
    b = 32
    seqs = rx[:b * 16]
    x = np.zeros((len(seqs), FX_REUTERS_WORDS), np.float32)
    for i, row in enumerate(seqs):
        row = np.asarray(row)
        x[i, row[row < FX_REUTERS_WORDS]] = 1.0
    leg("reuters_mlp", fx_argv(seed, b, 2),
        [L.Dense(256, activation="relu", input_shape=(FX_REUTERS_WORDS,)),
         L.Dropout(0.2), L.Dense(46)],
        keras.optimizers.Adam(1e-3), x, ry[:b * 16].astype(np.int32))
    # the accuracy gate (tests/test_accuracy.py:44-66), fp32
    x = (mx[:1024].astype(np.float32) / 255.0).reshape(-1, 784)
    gate = keras.callbacks.VerifyMetrics(metric="accuracy",
                                         threshold=FX_GATE_ACCURACY)
    leg("accuracy_gate", fx_argv(seed, 64, 8),
        [L.Dense(64, activation="relu", input_shape=(784,)), L.Dense(10)],
        keras.optimizers.SGD(learning_rate=0.1), x,
        my[:1024].astype(np.int32), [gate], compute_dtype="float32")
    acc = report["accuracy_gate"]["history"][-1]["accuracy"]
    check(acc >= FX_GATE_ACCURACY, f"keras MNIST gate: accuracy {acc} < "
          f"{FX_GATE_ACCURACY}")
    report["accuracy_gate"]["accuracy"] = acc
    report["lr_scheduler"] = {
        opt: keras_lr_schedule(seed, keras, opt, lrs, x[:FX_LR_ROWS],
                               my[:FX_LR_ROWS].astype(np.int32))
        for opt, lrs in (("sgd", (0.1, 0.02)), ("adam", (1e-3, 2e-4)))}
    free_models()
    return report


def keras_lr_schedule(seed, keras, opt, lrs, x, y):
    """``LearningRateScheduler`` on captured steps: the lr changes at
    epoch 1, which must drop the captured graphs (they hold the lr they
    were captured with).  The captured run is bit-equal to an eager one
    from the same start and differs from a run that keeps epoch 0's
    lr."""
    from flexflow_tpu_torch.compiler.graphs import eager

    cfg, parsed = parsed_config(fx_argv(seed, FX_LR_BATCH, 2),
                                compute_dtype="float32")
    L = keras.layers
    model = keras.Sequential([
        L.Dense(64, activation="relu", input_shape=(x.shape[1],)),
        L.Dense(10)])
    make = {"sgd": keras.optimizers.SGD, "adam": keras.optimizers.Adam}
    model.compile(optimizer=make[opt](lrs[0]),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], config=cfg)
    fm = model.ffmodel
    start = [t.clone() for t in train_tensors(fm)]
    runs, replays = {}, None
    for tag, ctx, schedule in (
            ("captured", None, lambda e: lrs[min(e, 1)]),
            ("eager", eager(), lambda e: lrs[min(e, 1)]),
            ("epoch0_lr", None, lambda e: lrs[0])):
        restore(fm, start)
        with ctx or contextlib.nullcontext():
            model.fit(x, y, epochs=cfg.epochs, shuffle=False,
                      verbose=False, callbacks=[
                          keras.callbacks.LearningRateScheduler(schedule)])
        runs[tag] = (list(fm.step_losses),
                     [t.clone() for t in train_tensors(fm)])
        if tag == "captured":
            replays = fm.compiled.step_graph.report()
    per_epoch = len(x) // FX_LR_BATCH
    check(len(runs["captured"][0]) == 2 * per_epoch, f"keras lr schedule "
          f"({opt}): {len(runs['captured'][0])} steps")
    check(sum(r["replays"] for r in replays) == per_epoch - 1,
          f"keras lr schedule ({opt}): epoch 1's steps were not captured "
          f"once and replayed: {replays}")
    cap, eag, flat = runs["captured"], runs["eager"], runs["epoch0_lr"]
    check(cap[0] == eag[0] and same_bits(cap[1], eag[1]),
          f"keras lr schedule ({opt}): the captured run differs from "
          f"eager after the lr change: losses {cap[0]} vs {eag[0]}")
    check(cap[0][:per_epoch] == flat[0][:per_epoch]
          and not same_bits(cap[1], flat[1]), f"keras lr schedule "
          f"({opt}): the epoch-1 lr change did not change the weights")
    return {"command_line": parsed, "lr_by_epoch": list(lrs),
            "steps": len(cap[0]), "captured_replays_epoch1": replays,
            "captured_bit_equal_eager": True,
            "loss_last": {k: v[0][-1] for k, v in runs.items()}}


def onnx_demo_cnn(path, seed):
    """examples/onnx_import.py's CNN, written by the port's
    ``onnx_minimal``; returns its weights."""
    from flexflow_tpu_torch.frontends.onnx_minimal import (
        TensorProto,
        helper,
        numpy_helper,
        save,
    )

    rng = np.random.default_rng(seed)
    w = {"wc": rng.normal(size=(8, 3, 3, 3)).astype(np.float32) * 0.2,
         "bc": np.zeros(8, np.float32),
         "wl": rng.normal(size=(10, 8 * 8 * 8)).astype(np.float32) * 0.1,
         "bl": np.zeros(10, np.float32)}
    nodes = [
        helper.make_node("Conv", ["x", "wc", "bc"], ["h1"], name="conv1",
                         kernel_shape=[3, 3], strides=[1, 1],
                         pads=[1, 1, 1, 1]),
        helper.make_node("Relu", ["h1"], ["h2"], name="relu1"),
        helper.make_node("MaxPool", ["h2"], ["h3"], name="pool1",
                         kernel_shape=[2, 2], strides=[2, 2]),
        helper.make_node("Flatten", ["h3"], ["h4"], name="flat"),
        helper.make_node("Gemm", ["h4", "wl", "bl"], ["y"], name="fc",
                         transB=1),
    ]
    g = helper.make_graph(
        nodes, "demo_cnn",
        [helper.make_tensor_value_info("x", TensorProto.FLOAT,
                                       (0, 3, 16, 16))],
        [helper.make_tensor_value_info("y", TensorProto.FLOAT, (0, 10))],
        [numpy_helper.from_array(a, n) for n, a in w.items()])
    save(helper.make_model(g), path)
    return w


def frontends_onnx(seed):
    """Phase 17 (c): the ONNX example's CNN imported, its forward against
    an ``F.conv2d``/``F.linear`` composition in fp32, then fit."""
    import tempfile

    import torch.nn.functional as F

    from flexflow_tpu_torch import FFModel, SGDOptimizer
    from flexflow_tpu_torch.frontends import ONNXModel

    b = 16
    cfg, parsed = parsed_config(fx_argv(seed, b, 1),
                                compute_dtype="float32")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "demo_cnn.onnx")
        w = onnx_demo_cnn(path, seed)
        om = ONNXModel(path)
    model = FFModel(cfg)
    x = model.create_tensor([b, 3, 16, 16], name="x")
    om.apply(model, {om.model.graph.input[0].name: x})
    model.compile(optimizer=SGDOptimizer(lr=0.05),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    copied = om.transfer_onnx_weights(model)
    check(copied == 4, f"transfer_onnx_weights copied {copied}, want 4")
    rng = np.random.default_rng(seed + 18)
    xs = rng.normal(size=(FX_ONNX_STEPS * b, 3, 16, 16)).astype(np.float32)
    ys = rng.integers(0, 10, FX_ONNX_STEPS * b).astype(np.int32)
    got = model.predict(xs[:b])
    dev = cfg.torch_device()
    t = {k: torch.from_numpy(v).to(dev) for k, v in w.items()}
    with torch.no_grad():
        h = F.max_pool2d(F.relu(F.conv2d(torch.from_numpy(xs[:b]).to(dev),
                                         t["wc"], t["bc"], padding=1)), 2)
        ref = F.linear(h.flatten(1), t["wl"], t["bl"]).cpu().numpy()
    err = float(np.abs(got - ref).max())
    tol = FX_ONNX_TOL * max(1.0, float(np.abs(ref).max()))
    check(err <= tol, f"the imported ONNX CNN is {err:.3e} from the "
          f"F.conv2d/F.linear composition (> {tol:.3e})")
    model.fit(xs, ys, batch_size=b, epochs=1, shuffle=False, verbose=False)
    losses = list(model.step_losses)
    check(len(losses) == FX_ONNX_STEPS and bool(np.isfinite(losses).all()),
          f"ONNX CNN fit losses {losses}")
    return {"command_line": parsed, "weights_transferred": copied,
            "forward_max_abs_err": err, "forward_tol": tol,
            "fit_losses": losses}


def phase_frontends(seed, name, bert_step_ms=None):
    """Phase 17 (module docstring): the frontends, keras and the command
    line on one card.  Rows 1-6 launch no time in the phase."""
    from flexflow_tpu_torch.compiler.graphs import COUNTED

    t_phase = time.perf_counter()
    for k in COUNTED:
        k.launches = 0
    report = {"card": CARD_LINE[0]}
    for key, fn in (("a_torch_fx_bert", lambda: frontends_bert(
            seed, name, bert_step_ms)),
                    ("b_keras", lambda: frontends_keras(seed)),
                    ("c_onnx", lambda: frontends_onnx(seed))):
        t0 = time.perf_counter()
        report[key] = fn()
        report[key]["wall_s"] = time.perf_counter() - t0
    launched = kernel_launches()
    check(not any(launched.values()), f"the frontends phase launched rows "
          f"1-6: {launched} (no import here has an MHA op)")
    report["kernel_rows_launched"] = launched
    report["phase_wall_s"] = time.perf_counter() - t_phase
    print("frontends path: " + json.dumps(report))
    return report


def entry_training(model, tag, parsed, wall, launched, xs, y, name,
                   parity=True):
    """Phase 18 (a)/(b): ``model`` after its example's ``fit``: every
    step's loss, rows 1-3 at EP_FLASH_LAYERS launches per step (rows
    4-6 none), the step p50 over EP_TIMED_STEPS synchronised captured
    steps, tokens/s and MFU; with ``parity``, every loss finite and one
    batch's loss on the flash route against the plain-attention route
    (``use_flash=False``) of the same model from a copy of its weights
    (``interop.params_from_numpy``); without (the diverging leg (b),
    whose routes ``entry_routes`` compares from its first weights), the
    first EP_STABLE_STEPS losses finite."""
    from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy

    losses = list(model.step_losses)
    steps = len(losses)
    finite = np.isfinite(losses)
    check(steps == 8 and bool(finite[:steps if parity
                                      else EP_STABLE_STEPS].all()),
          f"{tag}: fit's losses {losses}")
    want = {k: (EP_FLASH_LAYERS * steps if k in EP_FLASH_ROWS else 0)
            for k in launched}
    check(launched == want, f"{tag}: the kernels launched {launched} in "
          f"fit's {steps} steps, want {want}")
    b = model.config.batch_size
    seq = model._input_tensors[0].sizes[1]
    batches = device_batches(model, xs, y, b)
    timed_steps(model, batches, 1)  # warm (fit captured the step)
    times = timed_steps(model, batches, EP_TIMED_STEPS)
    p50 = float(np.median(times))
    flops = sum(n.op.flops() for n in model.graph.nodes.values())
    report = {}
    if parity:
        ins, lab = batches[0]
        full = params_to_numpy(model.params, model.compiled)
        loss_flash = float(model.compiled.loss_and_grads(
            model.params, model.state, ins, lab)[0])
        set_op_attr(model, "multihead_attention", "use_flash", False)
        copied = params_from_numpy(full, str(model.compiled.device),
                                   model.compiled)
        loss_plain = float(model.compiled.loss_and_grads(
            copied, model.state, ins, lab)[0])
        set_op_attr(model, "multihead_attention", "use_flash", True)
        rel = abs(loss_flash - loss_plain) / abs(loss_plain)
        check(rel <= LOSS_PATH_TOL["bf16"], f"{tag}: the flash route's "
              f"loss {loss_flash} is {rel:.3e} from the plain route's "
              f"{loss_plain} (> {LOSS_PATH_TOL['bf16']})")
        report = {"loss_flash_route": loss_flash,
                  "loss_plain_route": loss_plain, "loss_rel_err": rel,
                  "loss_tol": LOSS_PATH_TOL["bf16"]}
        del copied, full
    del batches
    return {"command_line": parsed, "wall_s": wall,
            "step_losses": losses, "finite_losses": int(finite.sum()),
            "kernel_rows_launched_fit": launched,
            "flash_launches_per_step": {
                k: launched[k] / steps for k in EP_FLASH_ROWS},
            "throughput_fit_samples_per_s": model.last_throughput,
            "step_p50_ms": p50 * 1e3,
            "step_p90_ms": float(np.quantile(times, 0.9)) * 1e3,
            "tokens_per_s": b * seq / p50,
            "mfu_vs_dense_bf16_peak": 3.0 * flops / p50 / card_peaks(name)[2],
            "forward_flops": flops,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            **report}


def entry_run(example, argv):
    """(the value ``main`` returned, its parsed config, wall seconds, the
    kernels it launched) for ``flexflow_tpu_torch.examples.<example>``
    called as a user would, ``main(argv)``, with the config parsed from
    ``argv``."""
    import importlib

    mod = importlib.import_module(f"flexflow_tpu_torch.examples.{example}")
    cfg, parsed = parsed_config(list(argv))
    free_models()
    torch.cuda.reset_peak_memory_stats()
    before = kernel_launches()
    t0 = time.perf_counter()
    out = mod.main(list(argv), cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in kernel_launches().items()}
    return out, parsed, wall, launched


def entry_gpt(seed, name):
    """Phase 18 (a): ``examples.gpt`` at the reference's TPU widths."""
    from flexflow_tpu_torch.examples import common, gpt

    argv = (*EP_TRAIN_ARGV, "--seed", str(seed))
    model, parsed, wall, launched = entry_run("gpt", argv)
    size = gpt.sizes(model.config)
    check(size == dict(vocab=32000, num_layers=12, hidden=768, num_heads=12,
                       ff_dim=3072, seq_len=512), f"gpt's widths {size}")
    x, y = common.lm_sequence_data(8 * model.config.batch_size,
                                   size["seq_len"], size["vocab"], seed=seed)
    report = entry_training(model, "gpt", parsed, wall, launched, [x], y,
                            name)
    report["widths"] = size
    del model
    free_models()
    return report


def entry_transformer(seed, name, obs_log):
    """Phase 18 (b): ``examples.transformer`` at the reference's TPU
    size, its event bus writing ``obs_log`` (``--obs-log``)."""
    from flexflow_tpu_torch.examples import common, transformer
    from flexflow_tpu_torch.obs.events import BUS

    argv = (*EP_TRAIN_ARGV, "--seed", str(seed), "--obs-log", obs_log)
    try:
        model, parsed, wall, launched = entry_run("transformer", argv)
    finally:
        BUS.close()
    size = transformer.sizes(model.config)
    check(size == dict(num_layers=12, hidden=512, num_heads=8, ff_dim=2048,
                       seq_len=512), f"transformer's size {size}")
    n = 8 * model.config.batch_size
    xs = common.synthetic_inputs(model, n)
    y = common.synthetic_labels(model, n, "mean_squared_error")
    report = entry_training(model, "transformer", parsed, wall, launched,
                            xs, y, name, parity=False)
    report["widths"] = size
    config, losses = model.config, list(model.step_losses)
    del model
    report["routes"] = entry_routes(config, size, losses)
    return report


def entry_routes(config, size, losses):
    """Phase 18 (b): the transformer example's model built again from
    its config (so from its first weights: they are drawn from the
    seed) on each of EP_ROUTES and trained as the example trains it
    (``run_example``: the same batches in the same order): every step's
    loss of each route beside the example's own (bf16, flash route);
    each route's first EP_STABLE_STEPS losses finite, and the first
    step's loss of the flash route against the plain route's within
    LOSS_PATH_TOL at bf16 and at fp32."""
    import dataclasses

    from flexflow_tpu_torch.examples.common import run_example
    from flexflow_tpu_torch.models import build_transformer

    out = {"bf16_flash": losses}
    for route, dtype, flash in EP_ROUTES:
        free_models()
        model = build_transformer(dataclasses.replace(
            config, compute_dtype=dtype, obs_log_file=None), **size)
        set_op_attr(model, "multihead_attention", "use_flash", flash)
        run_example(model, f"transformer {route}", loss="mean_squared_error",
                    metrics=["mean_squared_error"])
        out[route] = list(model.step_losses)
        del model
    free_models()
    for route, got in out.items():
        check(len(got) == len(losses)
              and bool(np.isfinite(got[:EP_STABLE_STEPS]).all()),
              f"transformer, route {route}: losses {got}")
    rel = {}
    for prec in ("bf16", "fp32"):
        a, b = out[f"{prec}_flash"][0], out[f"{prec}_plain"][0]
        rel[prec] = abs(a - b) / abs(b)
        check(rel[prec] <= LOSS_PATH_TOL[prec], f"transformer: the flash "
              f"route's first loss {a} is {rel[prec]:.3e} from the plain "
              f"route's {b} at {prec} (> {LOSS_PATH_TOL[prec]})")
    return {"step_losses": out, "first_loss_rel_err": rel,
            "loss_tol": {p: LOSS_PATH_TOL[p] for p in rel},
            "finite_steps": {r: int(np.isfinite(v).sum())
                             for r, v in out.items()}}


def entry_leg(example, argv, kind=None):
    """Phase 18 (c): one example through ``main(argv)``: its throughput
    line's number, or its final loss, and for a multi-rank example rank
    0's lowering, views and losses."""
    out, parsed, wall, launched = entry_run(example, argv)
    report = {"command_line": parsed, "wall_s": wall}
    if isinstance(out, dict):  # rank 0's job_summary
        losses = out["losses"]
        report.update(lowering=out["kind"], num_stages=out["num_stages"],
                      num_microbatches=out["num_microbatches"],
                      ranks=parsed["fields"]["num_devices"])
        check(kind is None or out["kind"] == kind,
              f"{example} lowered {out['kind']}, want {kind}")
    else:
        model = getattr(out, "ffmodel", out)
        losses = list(model.step_losses)
        report["throughput_samples_per_s"] = model.last_throughput
        del model
    check(len(losses) > 0 and bool(np.isfinite(losses).all()),
          f"{example}: losses {losses}")
    report["final_loss"] = losses[-1]
    report["kernel_rows_launched"] = launched
    del out
    free_models()
    print(f"entry point {example}: " + json.dumps(report))
    return report


def entry_tools(obs_log):
    """Phase 18 (d): the port's tools on the card's host: ffobs on leg
    (b)'s event log, fflint's registry proofs (on the card) and the
    committed cost cache, then mfu_probe and each mfu_variants
    variant."""
    import io

    from flexflow_tpu_torch.tools import fflint, ffobs, mfu_probe, mfu_variants

    def run(main, argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        lines = buf.getvalue().splitlines()
        return {"argv": argv, "rc": rc, "wall_s": time.perf_counter() - t0,
                "lines": len(lines), "first_lines": lines[:3],
                "last_line": lines[-1] if lines else ""}

    report = {}
    for cmd in ("report", "validate", "metrics", "trace"):
        report[f"ffobs_{cmd}"] = run(ffobs.main, [cmd, obs_log])
    check(report["ffobs_validate"]["rc"] == 0,
          f"ffobs validate: {report['ffobs_validate']}")
    root = os.path.dirname(os.path.abspath(__file__))
    report["fflint_registry"] = run(fflint.main, ["registry", "--devices",
                                                  "4"])
    report["fflint_cache"] = run(fflint.main, [
        "cache", os.path.join(root, "COST_CACHE.json")])
    for k in ("fflint_registry", "fflint_cache"):
        check(report[k]["rc"] == 0, f"{k}: {report[k]}")
    free_models()
    before = kernel_launches()
    t0 = time.perf_counter()
    report["mfu_probe"] = mfu_probe.main([])
    report["mfu_probe"]["wall_s"] = time.perf_counter() - t0
    report["mfu_probe"]["kernel_rows_launched"] = {
        k: n - before[k] for k, n in kernel_launches().items()}
    for variant in mfu_variants.VARIANTS:
        free_models()
        before = kernel_launches()
        t0 = time.perf_counter()
        r = mfu_variants.main([variant])
        r["wall_s"] = time.perf_counter() - t0
        r["kernel_rows_launched"] = launched = {
            k: n - before[k] for k, n in kernel_launches().items()}
        flash = variant == "flash"
        check(all((launched[k] > 0) == flash for k in EP_FLASH_ROWS)
              and not any(v for k, v in launched.items()
                          if k not in EP_FLASH_ROWS),
              f"mfu_variants {variant} launched {launched}")
        report[f"mfu_variants_{variant}"] = r
    free_models()
    return report


def installed(module: str) -> bool:
    """True when ``module`` can be imported here (its parents too)."""
    import importlib.util

    try:
        return importlib.util.find_spec(module) is not None
    except ModuleNotFoundError:  # a parent package is missing
        return False


def phase_entry_points(seed, name):
    """Phase 18 (module docstring): the repo's entry points on one card,
    each called as ``main(argv)`` with its config parsed from ``argv``."""
    import tempfile

    from flexflow_tpu_torch.compiler.graphs import COUNTED

    t_phase = time.perf_counter()
    for k in COUNTED:
        k.launches = 0
    report = {"card": CARD_LINE[0]}
    recorded = set()  # every flash launch of the phase in this process
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ep_") as tmp, \
            recorded_flash_launches(recorded):
        obs_log = os.path.join(tmp, "transformer_obs.jsonl")
        for key, fn in (("a_gpt", lambda: entry_gpt(seed, name)),
                        ("b_transformer",
                         lambda: entry_transformer(seed, name, obs_log))):
            report[key] = fn()
            print(f"entry point {key}: " + json.dumps(report[key]))
        launched = kernel_launches()
        report["kernel_rows_launched_a_b"] = launched
        others = {}
        for example, argv in EP_SINGLE:
            others[example] = entry_leg(
                example, (*argv, "--seed", str(seed), "-ll:tpu", "1",
                          "--only-data-parallel"))
        for example, package, argv in EP_OPTIONAL:
            if not installed(package):
                others[example] = f"not run on this host: no {package}"
                print(f"entry point {example}: {others[example]}")
            else:
                others[example] = entry_leg(
                    example, (*argv, "--seed", str(seed), "-ll:tpu", "1",
                              "--only-data-parallel"))
        # the multi-rank examples at once, each ``main`` spawning its own
        # ranks on the shared card: their start-ups (about 8 s a
        # process) overlap
        with concurrent.futures.ThreadPoolExecutor(len(EP_MULTI)) as pool:
            multi = {example: pool.submit(
                entry_leg, example, (*argv, "--seed", str(seed)), kind)
                for example, argv, kind in EP_MULTI}
        for example, leg in multi.items():
            others[example] = leg.result()  # a failed check raises here
        report["c_examples"] = others
        report["d_tools"] = entry_tools(obs_log)
    # the kernels against their plain versions at every shape the phase
    # launched them at: (a)'s causal [8, 512, 12], (b)'s [8, 512, 8]
    # and the flash variant's [64, 256, 8], neither causal
    shapes = launches_to_shapes(recorded)
    check(set(EP_FLASH_SHAPES) <= set(shapes), f"phase 18 launched the "
          f"flash kernels at {shapes}, want at least {EP_FLASH_SHAPES}")
    report["flash_shapes_vs_plain"] = check_flash_shapes(seed + 18, shapes)
    print("flash kernels at phase 18's shapes vs plain versions: "
          + json.dumps(report["flash_shapes_vs_plain"]))
    report["phase_wall_s"] = time.perf_counter() - t_phase
    print("entry points path: " + json.dumps(report))
    return report


# ---------------------------------------------------------------------------
# phase 19: the zoo over ranks
def zr_model(build, batch, seed, widths, n, strategy):
    """``build`` at ``widths`` for ``n`` ranks (bf16, SGD), compiled
    under ``strategy``: None searches on ``h100_sxm(ZR_RANKS)`` (the
    pipeline and placement proposals off), a callable is given the
    model and returns the views, {} is one process's."""
    from flexflow_tpu_torch import FFConfig, SGDOptimizer, models
    from flexflow_tpu_torch.core.machine import MachineSpec

    model = getattr(models, build)(FFConfig(
        batch_size=batch, compute_dtype=ZR_DTYPE, seed=seed,
        num_devices=n, machine_spec=MachineSpec.h100_sxm(ZR_RANKS),
        enable_pipeline_search=False, enable_placement_search=False),
        **widths)
    wide = model.graph.sinks()[-1].op.output_shapes[0].sizes[-1]
    loss = (dict(loss_type="mean_squared_error", metrics=[]) if wide == 1
            else dict(loss_type="sparse_categorical_crossentropy",
                      metrics=[]))
    if callable(strategy):
        strategy = strategy(model)
    model.compile(optimizer=SGDOptimizer(lr=ZOO_LR), strategy=strategy,
                  **loss)
    return model


def attribute_views(model, n):
    """Phase 19 (b)'s strategy: ZR_ATTR_OPS and the ZR_ATTR_PREFIX
    blocks split (1, 2, 2, 1), every other op's batch n ways where it
    splits (the image stays whole on every rank, which slices it)."""
    from flexflow_tpu_torch.core.machine import MachineView

    views = {}
    for node in model.graph.topo_order():
        op = node.op
        nd = op.output_shapes[0].ndim
        if op.name in ZR_ATTR_OPS or op.name.startswith(ZR_ATTR_PREFIX):
            views[node.guid] = MachineView((1, 2, 2, 1))
        elif op.op_type.value != "input" and 0 in op.splittable_output_dims():
            views[node.guid] = MachineView((n,) + (1,) * (nd - 1))
        else:
            views[node.guid] = MachineView.trivial(nd)
    return views


def pick_kinds(graph, views):
    """The views counted by kind (batch: dim 0; out: a later dim;
    replica: partial sums or a replicated input; none) and the
    non-batch ones by (op type, degrees, replica degree)."""
    kinds, splits = {}, {}
    for node in graph.topo_order():
        v = views[node.guid]
        degs, r = tuple(v.dim_degrees), v.replica_degree
        tags = ([("batch" if i == 0 else "out") for i, d in enumerate(degs)
                 if d > 1] + (["replica"] if r > 1 else [])) or ["none"]
        for tag in set(tags):
            kinds[tag] = kinds.get(tag, 0) + 1
        if set(tags) - {"batch", "none"}:
            key = f"{node.op.op_type.value} {degs} r{r}"
            splits[key] = splits.get(key, 0) + 1
    return kinds, splits


def grouped_conv_views(graph, views):
    """The grouped convs' views counted by (degrees, replica degree)."""
    out = {}
    for node in graph.topo_order():
        if (node.op.op_type.value == "conv2d"
                and node.op.attrs["groups"] > 1):
            v = views[node.guid]
            key = f"{tuple(v.dim_degrees)} r{v.replica_degree}"
            out[key] = out.get(key, 0) + 1
    return out


def attribute_halo_bytes(graph, views, n):
    """Per rank, per training step: (the halo slabs' bytes its
    exchanges send, forward and backward, and the bytes the replaced
    whole gather handed the transport: the input's H and W gathered
    over their axes in the forward and its gradient summed over them in
    the backward), from the shapes.  A split H takes the view's first
    axes, W the next: rank r is at (r // nw, r % nw)
    (``ops.conv.halo_cells``, the CPU tests' count too)."""
    from flexflow_tpu_torch.core.ptensor import DataType
    from flexflow_tpu_torch.ops.conv import halo_cells

    halo = [0] * n
    gather = 0
    for node in graph.topo_order():
        op = node.op
        if op.op_type.value not in ("conv2d", "pool2d"):
            continue
        degs = tuple(views[node.guid].dim_degrees)
        nh, nw = degs[1], degs[2]
        if nh == nw == 1:
            continue
        a = op.attrs
        nb, h, w, c = op.input_shapes[0].sizes
        elem = DataType.from_any(op.input_shapes[0].dtype).itemsize
        unit = (nb // degs[0]) * c * elem
        src = graph.in_edges[node.guid][0].src
        grad = graph.nodes[src].op.op_type.value != "input"
        for r in range(n):
            f, b = halo_cells((h, w), (nh, nw),
                              (a["kernel_h"], a["kernel_w"]),
                              (a["stride_h"], a["stride_w"]),
                              (a["padding_h"], a["padding_w"]), r)
            halo[r] += (f + (b if grad else 0)) * unit
        block = (h // nh) * (w // nw)
        gather += ((block + (h * (w // nw) if nh > 1 and nw > 1 else 0))
                   + (h * w if grad else 0)) * unit
    return halo, gather


def weight_digests(model):
    """sha1 of every weight this rank holds whole (its local shape is
    the weight's), by op/weight."""
    import hashlib

    whole = {(nd.op.name, s.name): tuple(s.shape)
             for nd in model.graph.topo_order()
             for s in nd.op._weight_specs}
    out = {}
    for op, ws in model.params.items():
        for w, t in ws.items():
            if tuple(t.shape) == whole[(op, w)]:
                out[f"{op}/{w}"] = hashlib.sha1(
                    t.detach().cpu().numpy().tobytes()).hexdigest()
    return out


def fit_steps(model, xs, y, batch):
    """One ``fit`` call per batch of (xs, y), each synchronised: the
    losses and each call's host seconds."""
    losses, secs = [], []
    for i in range(0, len(y), batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit([x[i:i + batch] for x in xs], y[i:i + batch],
                  batch_size=batch, epochs=1, shuffle=False, verbose=False)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses += list(model.step_losses)
    return losses, secs


def zr_leg(seed, leg, build, batch, widths, steps=ZR_STEPS,
           dp_steps=ZR_DP_STEPS):
    """One leg of phase 19 on this rank (module docstring): ``steps``
    ``fit`` calls of the pick, ``dp_steps`` of dp 4."""
    import torch.distributed as dist

    from flexflow_tpu_torch import models
    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
    from flexflow_tpu_torch.parallel import mesh
    from flexflow_tpu_torch.search.cost_cache import stable_graph_digest
    from flexflow_tpu_torch.search.simulator import Simulator

    n = dist.get_world_size()
    attribute = leg == ZR_ATTR[0]
    free_models()
    dist.barrier()
    t0 = time.perf_counter()
    model = zr_model(build, batch, seed, widths, n,
                     (lambda m: attribute_views(m, n)) if attribute
                     else None)
    compile_s = time.perf_counter() - t0
    graph, views = model.graph, model.strategy
    kinds, splits = pick_kinds(graph, views)
    grouped = grouped_conv_views(graph, views)
    xs, y = zoo_data(model, ZR_DATA_BATCHES * batch, seed + 19)
    rows = steps * batch
    mesh.reset_comm_counts()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    losses, secs = fit_steps(model, [x[:rows] for x in xs], y[:rows], batch)
    counts = mesh.comm_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = {"digest": stable_graph_digest(graph), "kinds": kinds,
           "splits": splits, "grouped_conv_views": grouped,
           "compile_s": compile_s,
           "search_s": (model.search_stats or {}).get("search_seconds"),
           "losses": losses, "step_s": secs,
           "step_ms": float(np.median(secs[1:])) * 1e3,
           "bytes_per_step": {k: v["bytes"] / steps
                              for k, v in counts.items() if v["bytes"]},
           "calls_per_step": {k: v["calls"] / steps
                              for k, v in counts.items() if v["calls"]},
           "host_bytes_per_step": sum(v["host_bytes"] for v in
                                      counts.values()) / steps,
           "halo_calls": counts["halo_exchange"]["calls"],
           "peak_memory_gb": peak, "weights": weight_digests(model)}
    dp_views = data_parallel_strategy(graph, n)
    out["pick_is_data_parallel"] = all(
        str(views[g]) == str(v) for g, v in dp_views.items())
    sim = Simulator.for_config(model.config)
    out["predicted_ms"] = sim.simulate(graph, views) * 1e3
    plain = getattr(models, build)(model.config, **widths).graph
    out["dp_predicted_ms"] = sim.simulate(
        plain, data_parallel_strategy(plain, n)) * 1e3
    del model
    if out["pick_is_data_parallel"]:
        out["dp_step_ms"], out["dp_step_s"] = out["step_ms"], secs
    else:
        free_models()
        dp = zr_model(build, batch, seed, widths, n,
                      lambda m: data_parallel_strategy(m.graph, n))
        rows = dp_steps * batch
        out["dp_step_s"] = fit_steps(dp, [x[:rows] for x in xs], y[:rows],
                                     batch)[1]
        out["dp_step_ms"] = float(np.median(out["dp_step_s"])) * 1e3
        del dp
    free_models()
    return out


def zr_halo_check(seed):
    """Phase 19's halo contents on this rank: each ZR_HALO_CASES op
    alone under (1, 2, 2, 1), fp32, from seeded weights, input and
    cotangent, against the unsplit op on the same tensors (plain
    PyTorch on this rank, one process's computation): the output, the
    input's gradient as max |got - want| / (1 + |want|), the kernel's
    (the ranks' addends summed) as max |got - want| / max |want| (a sum
    of batch x output cells' terms, which fp32 rounds on that scale,
    split or not), and the halo bytes this rank sent
    (forward and backward) beside the slabs the shapes imply."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.core.machine import MachineView
    from flexflow_tpu_torch.interop import params_from_numpy
    from flexflow_tpu_torch.ops.conv import halo_cells
    from flexflow_tpu_torch.parallel import mesh as pmesh

    n, rank = dist.get_world_size(), dist.get_rank()
    batch = ZR_ATTR[2]

    def err(got, want):
        return float(((got - want).abs() / (1 + want.abs())).max())

    out = {}
    for name, kind, (h, w), c, a in ZR_HALO_CASES:
        m = FFModel(FFConfig(batch_size=batch, num_devices=n,
                             compute_dtype="float32", seed=seed))
        x = m.create_tensor([batch, h, w, c], name="x")
        if kind == "conv":
            m.conv2d(x, a["out"], a["k"], a["k"], a["s"], a["s"], a["p"],
                     a["p"], use_bias=False, name=name)
        else:
            m.pool2d(x, a["k"], a["k"], a["s"], a["s"], a["p"], a["p"],
                     pool_type=kind, name=name)
        m.compile(strategy={
            nd.guid: (MachineView((1, 2, 2, 1)) if nd.op.name == name
                      else MachineView.trivial(nd.op.output_shapes[0].ndim))
            for nd in m.graph.topo_order()},
            loss_type="mean_squared_error", metrics=[])
        rng = np.random.default_rng(seed + 19)
        xn = rng.normal(size=(batch, h, w, c)).astype(np.float32)
        whole = {op: {wn: (rng.normal(size=tuple(t.shape)) * 0.1).astype(
                          np.float32) for wn, t in ws.items()}
                 for op, ws in m.params.items()}
        params = params_from_numpy(whole, "cuda", m.compiled)
        for ws in params.values():
            for t in ws.values():
                t.requires_grad_()
        xt = torch.from_numpy(xn).cuda().requires_grad_()
        pmesh.reset_comm_counts()
        y, _ = m.compiled.apply(params, m.state, [xt], train=True)
        got = m.compiled.gather_output(y.detach())
        cot = torch.from_numpy(rng.normal(size=tuple(got.shape)).astype(
            np.float32)).cuda()
        y.backward(cot[tuple(m.compiled._sink_pl.local_slices(
            cot.shape, m.compiled.mesh))])
        sent = pmesh.comm_counts()["halo_exchange"]["bytes"]
        xr = torch.from_numpy(xn).cuda().requires_grad_()
        if kind == "conv":
            kr = torch.from_numpy(whole[name]["kernel"]).cuda()
            kr.requires_grad_()
            want = F.conv2d(xr.permute(0, 3, 1, 2), kr.permute(3, 2, 0, 1),
                            stride=a["s"], padding=a["p"])
        else:
            want = F.max_pool2d(xr.permute(0, 3, 1, 2), a["k"], a["s"],
                                a["p"])
        want = want.permute(0, 2, 3, 1)
        want.backward(cot)
        f, b = halo_cells((h, w), (2, 2), (a["k"],) * 2, (a["s"],) * 2,
                          (a["p"],) * 2, rank)
        row = {"output_err": err(got, want.detach()),
               "input_grad_err": err(xt.grad, xr.grad),
               "halo_bytes": sent, "halo_bytes_expected": (f + b) * batch
               * c * 4}
        if kind == "conv":
            g = params[name]["kernel"].grad.detach()
            g = pmesh.all_reduce_sum(g, m.compiled.mesh.names,
                                     m.compiled.mesh)
            # a sum over batch x output cells: held to its scale
            row["kernel_grad_err"] = float((g - kr.grad).abs().max()
                                           / kr.grad.abs().max())
        out[name] = row
        del m, params, xt, xr, y, want, got, cot
    free_models()
    return out


def _zoo_ranks_rank(rank, seed):
    """One rank of phase 19: every leg in turn, then the halo contents,
    with the launch counts of rows 1-6 zeroed before and read after."""
    from flexflow_tpu_torch.compiler.graphs import COUNTED
    from flexflow_tpu_torch.runtime.distributed import transport

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"transport": transport(), "legs": {}}
    for k in COUNTED:
        k.launches = 0
    for leg, build, batch, widths in ZR_LEGS + (ZR_ATTR,):
        t0 = time.perf_counter()
        out["legs"][leg] = zr_leg(seed, leg, build, batch, widths)
        out["legs"][leg]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["halo"] = zr_halo_check(seed)
    out["halo_wall_s"] = time.perf_counter() - t0
    out["launched"] = {k.__name__: k.launches for k in COUNTED}
    return out


def zr_one_process(seed):
    """Phase 19's one-process side: each leg's first-step loss (its
    model alone, from the same seeded weights and batch), and the halo
    and whole-gather bytes the attribute leg's shapes imply."""
    one, expect = {}, None
    for leg, build, batch, widths in ZR_LEGS + (ZR_ATTR,):
        free_models()
        m = zr_model(build, batch, seed, widths, 1, {})
        xs, y = zoo_data(m, ZR_DATA_BATCHES * batch, seed + 19)
        ins, lab = device_batches(m, [x[:batch] for x in xs], y[:batch],
                                  batch)[0]
        *_, loss, _ = m.compiled.train_step(m.params, m.opt_state,
                                            m.state, ins, lab)
        one[leg] = float(loss)
        if leg == ZR_ATTR[0]:
            expect = attribute_halo_bytes(
                m.graph, attribute_views(m, ZR_RANKS), ZR_RANKS)
        del m, ins, lab, xs, y
    free_models()
    return one, expect


def phase_zoo_ranks(seed, name):
    """Phase 19 (module docstring): the legs over ZR_RANKS ranks spawned
    once, and meanwhile, while the ranks start and rank 0 searches,
    one process's side of each leg in this process."""
    from concurrent.futures import ThreadPoolExecutor

    from flexflow_tpu_torch.compiler.graphs import COUNTED
    from flexflow_tpu_torch.runtime.distributed import spawn

    t_phase = time.perf_counter()
    for k in COUNTED:  # this process's side: one process's legs
        k.launches = 0
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(spawn, _zoo_ranks_rank, ZR_RANKS, (seed,),
                          init_method=f"tcp://localhost:{free_port()}",
                          device="cuda", timeout=SP_TIMEOUT_S)
        one, expect = zr_one_process(seed)
        one_wall = time.perf_counter() - t_phase
        ranks = job.result()  # re-raises a rank's failure
    ranks_wall = time.perf_counter() - t_phase
    r0 = ranks[0]
    report = {"card": CARD_LINE[0], "ranks": ZR_RANKS,
              "transport": r0["transport"], "ranks_wall_s": ranks_wall,
              "one_process_wall_s": one_wall, "legs": {}}
    for leg, build, batch, _ in ZR_LEGS + (ZR_ATTR,):
        got = r0["legs"][leg]
        losses = got["losses"]
        check(len(losses) == ZR_STEPS and bool(np.isfinite(losses).all()),
              f"phase 19 {leg}: fit losses {losses}")
        rel = abs(losses[0] - one[leg]) / abs(one[leg])
        check(rel <= ZR_LOSS_TOL, f"phase 19 {leg}: the first loss "
              f"{losses[0]} is {rel:.3e} from one process's {one[leg]}")
        for r in ranks[1:]:
            other = r["legs"][leg]
            check(other["digest"] == got["digest"]
                  and other["splits"] == got["splits"]
                  and other["kinds"] == got["kinds"],
                  f"phase 19 {leg}: the ranks lowered different picks")
            check(other["losses"] == losses,
                  f"phase 19 {leg}: the ranks' losses differ")
            for key in set(other["weights"]) & set(got["weights"]):
                check(other["weights"][key] == got["weights"][key],
                      f"phase 19 {leg}: the whole weight {key} differs "
                      f"between ranks")
        row = {"build": build, "batch": batch, "views": got["kinds"],
               "non_batch_splits": got["splits"],
               "pick_is_data_parallel": got["pick_is_data_parallel"],
               "losses": losses, "one_process_first_loss": one[leg],
               "first_loss_rel": rel,
               "whole_weights_bit_equal": len(got["weights"]),
               "step_p50_ms": got["step_ms"],
               "dp_step_p50_ms": got["dp_step_ms"],
               "predicted_ms": got["predicted_ms"],
               "dp_predicted_ms": got["dp_predicted_ms"],
               "bytes_per_rank_per_step": [
                   r["legs"][leg]["bytes_per_step"] for r in ranks],
               "host_bytes_per_rank_per_step": [
                   r["legs"][leg]["host_bytes_per_step"] for r in ranks],
               "peak_memory_gb_per_rank": [
                   r["legs"][leg]["peak_memory_gb"] for r in ranks],
               "compile_s": got["compile_s"], "search_s": got["search_s"],
               "step_s": got["step_s"], "dp_step_s": got["dp_step_s"],
               "wall_s": got["wall_s"]}
        if leg == ZR_ATTR[0]:
            halo, gather = expect
            sent = [r["legs"][leg]["bytes_per_step"].get("halo_exchange", 0)
                    for r in ranks]
            check(sent == halo and got["halo_calls"] > 0,
                  f"phase 19 {leg}: halo bytes per rank per step {sent}, "
                  f"the shapes imply {halo}")
            row["halo_bytes_per_rank_per_step"] = sent
            row["whole_gather_bytes_replaced_per_rank_per_step"] = gather
        report["legs"][leg] = row
    for name, *_ in ZR_HALO_CASES:
        rows = [r["halo"][name] for r in ranks]
        for rank, row in enumerate(rows):
            for key, e in row.items():
                if key.endswith("_err"):
                    check(e <= ZR_HALO_TOL, f"phase 19 halo {name} rank "
                          f"{rank}: {key} {e:.3e} > {ZR_HALO_TOL}")
            check(row["halo_bytes"] == row["halo_bytes_expected"],
                  f"phase 19 halo {name} rank {rank}: sent "
                  f"{row['halo_bytes']} bytes, the shapes imply "
                  f"{row['halo_bytes_expected']}")
        report.setdefault("halo_contents", {})[name] = {
            key: max(row[key] for row in rows)
            for key in rows[0] if key.endswith("_err")}
        report["halo_contents"][name]["halo_bytes_per_rank"] = [
            row["halo_bytes"] for row in rows]
    report["halo_contents_wall_s"] = r0["halo_wall_s"]
    for rank, r in enumerate(ranks):
        check(not any(r["launched"].values()), f"phase 19 rank {rank} "
              f"launched rows 1-6: {r['launched']} (no TPU kernel lies on "
              f"its path)")
    one_launched = {k.__name__: k.launches for k in COUNTED}
    check(not any(one_launched.values()), f"phase 19's one-process side "
          f"launched rows 1-6: {one_launched}")
    report["kernel_rows_launched_per_rank"] = [r["launched"] for r in ranks]
    report["kernel_rows_launched_one_process"] = one_launched
    report["phase_wall_s"] = time.perf_counter() - t_phase
    print("zoo over ranks path: " + json.dumps(report))
    return report


def out_channel_views(model, n, view):
    """Phase 20 (b)'s strategy: every grouped conv at ``view``, every
    other op at data parallelism's view."""
    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
    from flexflow_tpu_torch.core.machine import MachineView

    views = data_parallel_strategy(model.graph, n)
    for node in model.graph.topo_order():
        if (node.op.op_type.value == "conv2d"
                and node.op.attrs["groups"] > 1):
            views[node.guid] = MachineView(view)
    return views


def sv_out_leg(seed, view):
    """Phase 20 (b) on this rank: ResNeXt-50 at SV_OUT_WIDTHS with every
    grouped conv at ``view``, SV_OUT_STEPS ``fit`` steps on phase 20
    (a)'s first batches."""
    import torch.distributed as dist

    from flexflow_tpu_torch.parallel import mesh

    n = dist.get_world_size()
    _, build, batch, _ = SV_RESNEXT
    free_models()
    dist.barrier()
    model = zr_model(build, batch, seed, SV_OUT_WIDTHS, n,
                     lambda m: out_channel_views(m, n, view))
    xs, y = zoo_data(model, ZR_DATA_BATCHES * batch, seed + 19)
    rows = SV_OUT_STEPS * batch
    mesh.reset_comm_counts()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    losses, secs = fit_steps(model, [x[:rows] for x in xs], y[:rows], batch)
    counts = mesh.comm_counts()
    out = {"grouped_conv_views": grouped_conv_views(model.graph,
                                                    model.strategy),
           "losses": losses, "step_s": secs,
           "bytes_per_step": {k: v["bytes"] / SV_OUT_STEPS
                              for k, v in counts.items() if v["bytes"]},
           "calls_per_step": {k: v["calls"] / SV_OUT_STEPS
                              for k, v in counts.items() if v["calls"]},
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "weights": weight_digests(model)}
    del model
    free_models()
    return out


def sv_mlp(seed, n):
    """The keras-style MNIST MLP (SV_MLP, the head a softmax dense), fp32,
    SGD, compiled for ``n`` ranks under ``compile(strategy=None)`` on
    ``h100_sxm(SV_RANKS)`` (one process: unsplit), and its data: 2
    batches of normal features and class ids."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.core.machine import MachineSpec

    d_in, h1, h2, classes = SV_MLP
    b = SV_MLP_BATCH
    m = FFModel(FFConfig(batch_size=b, compute_dtype="float32", seed=seed,
                         num_devices=n,
                         machine_spec=MachineSpec.h100_sxm(SV_RANKS),
                         enable_pipeline_search=False,
                         enable_placement_search=False))
    x = m.create_tensor([b, d_in], name="x")
    t = m.dense(x, h1, activation="relu", name="fc1")
    t = m.dense(t, h2, activation="relu", name="fc2")
    m.dense(t, classes, activation="softmax", name="head")
    m.compile(optimizer=SGDOptimizer(lr=ZOO_LR),
              strategy=None if n > 1 else {},
              loss_type="sparse_categorical_crossentropy", metrics=[])
    rng = np.random.default_rng(seed + 20)
    return m, (rng.normal(size=(2 * b, d_in)).astype(np.float32),
               rng.integers(0, classes, 2 * b).astype(np.int32))


def sv_mlp_leg(seed):
    """Phase 20 (c) on this rank: the MLP's pick and its 2 ``fit``
    steps."""
    import torch.distributed as dist

    free_models()
    m, (x, y) = sv_mlp(seed, dist.get_world_size())
    views = {nd.op.name: [list(m.strategy[nd.guid].dim_degrees),
                          m.strategy[nd.guid].replica_degree]
             for nd in m.graph.topo_order()}
    losses, secs = fit_steps(m, [x], y, SV_MLP_BATCH)
    del m
    return {"views": views, "losses": losses, "step_s": secs}


def sv_depthwise_check(seed):
    """Phase 20 (d) on this rank: SV_DEPTHWISE's 3x3 depthwise conv alone
    under its out-channel view, fp32, from seeded weights, input and
    cotangent, against the unsplit op on the same tensors (plain
    PyTorch, one process's computation): the output and the input's
    gradient as max |got - want| / (1 + |want|), this rank's block of
    the kernel's gradient (a sum over batch x output cells) as max
    |got - want| / max |want|."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.core.machine import MachineView
    from flexflow_tpu_torch.interop import params_from_numpy

    (b, h, w, c), view = SV_DEPTHWISE
    n = dist.get_world_size()

    def err(got, want):
        return float(((got - want).abs() / (1 + want.abs())).max())

    m = FFModel(FFConfig(batch_size=b, num_devices=n,
                         compute_dtype="float32", seed=seed))
    x = m.create_tensor([b, h, w, c], name="x")
    m.conv2d(x, c, 3, 3, 1, 1, 1, 1, groups=c, name="dw")
    m.compile(strategy={
        nd.guid: (MachineView(view) if nd.op.name == "dw"
                  else MachineView.trivial(nd.op.output_shapes[0].ndim))
        for nd in m.graph.topo_order()},
        loss_type="mean_squared_error", metrics=[])
    rng = np.random.default_rng(seed + 20)
    xn = rng.normal(size=(b, h, w, c)).astype(np.float32)
    whole = {"dw": {spec.name: (rng.normal(size=spec.shape) * 0.1).astype(
                        np.float32)
                    for spec in m.node_by_name("dw").op._weight_specs}}
    params = params_from_numpy(whole, "cuda", m.compiled)
    for ws in params.values():
        for t in ws.values():
            t.requires_grad_()
    xt = torch.from_numpy(xn).cuda().requires_grad_()
    y, _ = m.compiled.apply(params, m.state, [xt], train=True)
    got = m.compiled.gather_output(y.detach())
    cot = torch.from_numpy(rng.normal(size=tuple(got.shape)).astype(
        np.float32)).cuda()
    y.backward(cot[tuple(m.compiled._sink_pl.local_slices(
        cot.shape, m.compiled.mesh))])
    xr = torch.from_numpy(xn).cuda().requires_grad_()
    kr = torch.from_numpy(whole["dw"]["kernel"]).cuda().requires_grad_()
    want = F.conv2d(xr.permute(0, 3, 1, 2), kr.permute(3, 2, 0, 1),
                    torch.from_numpy(whole["dw"]["bias"]).cuda(),
                    padding=1, groups=c).permute(0, 2, 3, 1)
    want.backward(cot)
    mine = params["dw"]["kernel"]
    lo = mine.shape[-1] * m.compiled.mesh.index(  # the output is dw's
        m.compiled._sink_pl.dims[3])
    kg = kr.grad[..., lo:lo + mine.shape[-1]]
    out = {"output_err": err(got, want.detach()),
           "input_grad_err": err(xt.grad, xr.grad),
           "kernel_grad_err": float((mine.grad - kg).abs().max()
                                    / kg.abs().max()),
           "kernel_block": list(mine.shape)}
    del m, params, xt, xr, y, want, got, cot
    free_models()
    return out


def _split_views_rank(rank, seed):
    """One rank of phase 20: legs (a)-(d) in turn, with the launch counts
    of rows 1-6 zeroed before and read after."""
    from flexflow_tpu_torch.compiler.graphs import COUNTED
    from flexflow_tpu_torch.runtime.distributed import transport

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"transport": transport(), "wall_s": {}}
    for k in COUNTED:
        k.launches = 0
    legs = (("a", lambda: zr_leg(seed, *SV_RESNEXT, steps=SV_STEPS,
                                 dp_steps=SV_DP_STEPS)),
            ("b", lambda: {str(v): sv_out_leg(seed, v)
                           for v in SV_OUT_VIEWS}),
            ("c", lambda: sv_mlp_leg(seed)),
            ("d", lambda: sv_depthwise_check(seed)))
    for key, run in legs:
        t0 = time.perf_counter()
        out[key] = run()
        out["wall_s"][key] = time.perf_counter() - t0
    out["launched"] = {k.__name__: k.launches for k in COUNTED}
    return out


def sv_one_process(seed):
    """Phase 20's one-process side: ResNeXt-50's first-step loss (at (b)'s
    widths too, where they differ) and the MLP's, each model alone from
    the same seeded weights and first batch."""
    one = {}
    _, build, batch, widths = SV_RESNEXT
    todo = [("a", widths)] + ([("b", SV_OUT_WIDTHS)]
                              if SV_OUT_WIDTHS != widths else [])
    for key, w in todo:
        free_models()
        m = zr_model(build, batch, seed, w, 1, {})
        xs, y = zoo_data(m, ZR_DATA_BATCHES * batch, seed + 19)
        ins, lab = device_batches(m, [x[:batch] for x in xs], y[:batch],
                                  batch)[0]
        *_, loss, _ = m.compiled.train_step(m.params, m.opt_state,
                                            m.state, ins, lab)
        one[key] = float(loss)
        del m, ins, lab, xs, y
    one.setdefault("b", one["a"])
    free_models()
    m, (x, y) = sv_mlp(seed, 1)
    ins, lab = device_batches(m, [x[:SV_MLP_BATCH]], y[:SV_MLP_BATCH],
                              SV_MLP_BATCH)[0]
    *_, loss, _ = m.compiled.train_step(m.params, m.opt_state, m.state,
                                        ins, lab)
    one["c"] = float(loss)
    del m, ins, lab
    free_models()
    return one


def phase_split_views(seed, name):
    """Phase 20 (module docstring): legs (a)-(d) over SV_RANKS ranks
    spawned once, and meanwhile one process's side in this process."""
    from concurrent.futures import ThreadPoolExecutor

    from flexflow_tpu_torch.compiler.graphs import COUNTED
    from flexflow_tpu_torch.runtime.distributed import spawn

    t_phase = time.perf_counter()
    for k in COUNTED:  # this process's side: one process's legs
        k.launches = 0
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(spawn, _split_views_rank, SV_RANKS, (seed,),
                          init_method=f"tcp://localhost:{free_port()}",
                          device="cuda", timeout=SP_TIMEOUT_S)
        one = sv_one_process(seed)
        one_wall = time.perf_counter() - t_phase
        ranks = job.result()  # re-raises a rank's failure
    r0 = ranks[0]
    report = {"card": CARD_LINE[0], "ranks": SV_RANKS,
              "transport": r0["transport"], "one_process_wall_s": one_wall,
              "legs_wall_s": r0["wall_s"]}

    def same_on_every_rank(leg, got, others, what):
        for r in others:
            check(r["losses"] == got["losses"],
                  f"phase 20 {leg}: the ranks' losses differ")
            for key in set(r["weights"]) & set(got["weights"]):
                check(r["weights"][key] == got["weights"][key],
                      f"phase 20 {leg}: the whole weight {key} differs "
                      f"between ranks ({what})")

    def first_loss(leg, losses, want, tol):
        check(bool(np.isfinite(losses).all()),
              f"phase 20 {leg}: fit losses {losses}")
        rel = abs(losses[0] - want) / abs(want)
        check(rel <= tol, f"phase 20 {leg}: the first loss {losses[0]} is "
              f"{rel:.3e} from one process's {want}")
        return rel

    # (a) ResNeXt-50 under its pick, and dp 4
    a = r0["a"]
    check(len(a["losses"]) == SV_STEPS, f"phase 20 (a): {a['losses']}")
    for r in ranks[1:]:
        check(r["a"]["digest"] == a["digest"]
              and r["a"]["grouped_conv_views"] == a["grouped_conv_views"],
              "phase 20 (a): the ranks lowered different picks")
    same_on_every_rank("(a)", a, [r["a"] for r in ranks[1:]], "the pick")
    report["a_resnext50"] = {
        "build": SV_RESNEXT[1], "batch": SV_RESNEXT[2],
        "grouped_conv_views": a["grouped_conv_views"],
        "views": a["kinds"], "non_batch_splits": a["splits"],
        "pick_is_data_parallel": a["pick_is_data_parallel"],
        "losses": a["losses"], "one_process_first_loss": one["a"],
        "first_loss_rel": first_loss("(a)", a["losses"], one["a"],
                                     ZR_LOSS_TOL),
        "whole_weights_bit_equal": len(a["weights"]),
        "step_p50_ms": a["step_ms"], "dp_step_p50_ms": a["dp_step_ms"],
        "predicted_ms": a["predicted_ms"],
        "dp_predicted_ms": a["dp_predicted_ms"],
        "calls_per_rank_per_step": [r["a"]["calls_per_step"]
                                    for r in ranks],
        "bytes_per_rank_per_step": [r["a"]["bytes_per_step"]
                                    for r in ranks],
        "host_bytes_per_rank_per_step": [r["a"]["host_bytes_per_step"]
                                         for r in ranks],
        "peak_memory_gb_per_rank": [r["a"]["peak_memory_gb"]
                                    for r in ranks],
        "search_s": a["search_s"], "compile_s": a["compile_s"],
        "step_s": a["step_s"], "dp_step_s": a["dp_step_s"]}
    # (b) every grouped conv under each out-channel view
    report["b_out_channel"] = {}
    for view in SV_OUT_VIEWS:
        b = r0["b"][str(view)]
        views = b["grouped_conv_views"]
        check(list(views) == [f"{view} r1"],
              f"phase 20 (b) {view}: grouped convs at {views}")
        same_on_every_rank(f"(b) {view}", b,
                           [r["b"][str(view)] for r in ranks[1:]], view)
        report["b_out_channel"][str(view)] = {
            "grouped_convs": views[f"{view} r1"], "losses": b["losses"],
            "one_process_first_loss": one["b"],
            "first_loss_rel": first_loss(f"(b) {view}", b["losses"],
                                         one["b"], ZR_LOSS_TOL),
            "whole_weights_bit_equal": len(b["weights"]),
            "step_s": b["step_s"],
            "calls_per_rank_per_step": [r["b"][str(view)]["calls_per_step"]
                                        for r in ranks],
            "bytes_per_rank_per_step": [r["b"][str(view)]["bytes_per_step"]
                                        for r in ranks],
            "peak_memory_gb_per_rank": [r["b"][str(view)]["peak_memory_gb"]
                                        for r in ranks]}
    # (c) the MLP's pick splits the softmax head
    c = r0["c"]
    head = c["views"]["head"]
    check(head[0][-1] > 1, f"phase 20 (c): the pick keeps the softmax "
          f"head's out dim whole: {c['views']}")
    for r in ranks[1:]:
        check(r["c"]["views"] == c["views"] and r["c"]["losses"]
              == c["losses"], "phase 20 (c): the ranks differ")
    report["c_mlp"] = {"views": c["views"], "losses": c["losses"],
                       "one_process_first_loss": one["c"],
                       "first_loss_rel": first_loss("(c)", c["losses"],
                                                    one["c"], SV_MLP_TOL),
                       "step_s": c["step_s"]}
    # (d) the depthwise conv's contents
    rows = [r["d"] for r in ranks]
    for rank, row in enumerate(rows):
        for key, e in row.items():
            if key.endswith("_err"):
                check(e <= SV_DEPTHWISE_TOL, f"phase 20 (d) rank {rank}: "
                      f"{key} {e:.3e} > {SV_DEPTHWISE_TOL}")
    report["d_depthwise"] = {
        "shape": list(SV_DEPTHWISE[0]), "view": list(SV_DEPTHWISE[1]),
        "kernel_block": rows[0]["kernel_block"],
        **{k: max(row[k] for row in rows) for k in rows[0]
           if k.endswith("_err")}}
    for rank, r in enumerate(ranks):
        check(not any(r["launched"].values()), f"phase 20 rank {rank} "
              f"launched rows 1-6: {r['launched']} (no TPU kernel lies on "
              f"its path)")
    one_launched = {k.__name__: k.launches for k in COUNTED}
    check(not any(one_launched.values()), f"phase 20's one-process side "
          f"launched rows 1-6: {one_launched}")
    report["kernel_rows_launched_per_rank"] = [r["launched"] for r in ranks]
    report["kernel_rows_launched_one_process"] = one_launched
    report["phase_wall_s"] = time.perf_counter() - t_phase
    print("split views path: " + json.dumps(report))
    return report


def main(argv=None) -> int:
    t_script = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-times", metavar="ROOT", default=None,
                    help="only time the decode kernels of the checkout "
                         "at ROOT at phase 3's serving shape")
    ap.add_argument("--step-times", metavar="ROOT", default=None,
                    help="only time phase 6's training step of the "
                         "checkout at ROOT, captured and eager")
    ap.add_argument("--searched-only", metavar="RUNS", type=int,
                    default=None,
                    help="only run phase 9, RUNS times, against one "
                         "process's first training step")
    ap.add_argument("--pipeline-only", action="store_true",
                    help="only run phase 10, against phase 6's first "
                         "step taken alone")
    ap.add_argument("--bert-only", action="store_true",
                    help="only run phase 11, BERT-base through fit")
    ap.add_argument("--sync-only", metavar="RUNS", type=int, default=None,
                    help="only run phase 12, RUNS times, against phase "
                         "6's first step taken alone")
    ap.add_argument("--serve-only", metavar="RUNS", type=int, default=None,
                    help="only run phase 13, serving over ranks, RUNS "
                         "times")
    ap.add_argument("--zoo-only", action="store_true",
                    help="only run phase 14, the model zoo")
    ap.add_argument("--always-on-only", action="store_true",
                    help="only run phase 15, the always-on loop")
    ap.add_argument("--obs-only", action="store_true",
                    help="only run phase 16, the measured side of the "
                         "loop")
    ap.add_argument("--frontends-only", action="store_true",
                    help="only run phase 17, the frontends, keras and "
                         "the command line")
    ap.add_argument("--entry-points-only", action="store_true",
                    help="only run phase 18, the repo's entry points")
    ap.add_argument("--zoo-ranks-only", action="store_true",
                    help="only run phase 19, the zoo over ranks")
    ap.add_argument("--split-views-only", action="store_true",
                    help="only run phase 20, the split views over ranks")
    ap.add_argument("--calibration-out", metavar="DIR", default=None,
                    help="keep each phase 9 run's calibration table in "
                         "DIR as calibration_<run>.json")
    args = ap.parse_args(argv)
    if args.decode_times is not None:
        phase_device()
        decode_times(args.decode_times, args.seed)
        return 0
    if args.step_times is not None:
        phase_device()
        step_times(args.step_times, args.seed)
        return 0
    if args.calibration_out:
        os.makedirs(args.calibration_out, exist_ok=True)

    def calibration_out(run):
        return (os.path.join(args.calibration_out, f"calibration_{run}.json")
                if args.calibration_out else None)

    if args.searched_only is not None:
        name = phase_device()
        phase_build()
        first = first_step_loss(args.seed)
        for run in range(1, args.searched_only + 1):
            print(f"phase 9, run {run} of {args.searched_only}")
            phase_searched_train(args.seed, name, first,
                                 calibration_out(run))
        return 0

    if args.bert_only:
        name = phase_device()
        phase_build()
        phase_bert_train(args.seed, name)
        return 0

    if args.zoo_only:  # no CUDA kernel of the port lies on its path
        phase_zoo(args.seed, phase_device())
        return 0

    if args.zoo_ranks_only:  # no CUDA kernel of the port on its path
        phase_zoo_ranks(args.seed, phase_device())
        return 0

    if args.split_views_only:  # no CUDA kernel of the port on its path
        phase_split_views(args.seed, phase_device())
        return 0

    if args.frontends_only:  # no CUDA kernel of the port on its path
        phase_frontends(args.seed, phase_device())
        return 0

    if args.entry_points_only:
        name = phase_device()
        phase_build()
        phase_entry_points(args.seed, name)
        return 0

    if args.always_on_only:
        name = phase_device()
        phase_build()
        phase_always_on(args.seed, name)
        return 0

    if args.obs_only:
        name = phase_device()
        phase_build()
        phase_observability(args.seed, name)
        return 0

    if args.sync_only is not None:
        name = phase_device()
        phase_build()
        first = first_step_loss(args.seed)
        for run in range(1, args.sync_only + 1):
            print(f"phase 12, run {run} of {args.sync_only}")
            phase_sync_train(args.seed, name, first)
        return 0

    if args.serve_only is not None:
        name = phase_device()
        phase_build()
        for run in range(1, args.serve_only + 1):
            print(f"phase 13, run {run} of {args.serve_only}")
            phase_serve_ranks(args.seed, name)
        return 0

    if args.pipeline_only:
        name = phase_device()
        phase_build()
        phase_pipeline_train(args.seed, name, first_step_loss(args.seed))
        return 0

    name = phase_device()
    libs = phase_build()
    phase_sass(libs)
    rpa = phase_kernels(name, args.seed)
    flash = phase_flash_kernels(name, args.seed)
    partial = phase_partial_kernel(name, args.seed)
    rpa_launches = phase_main_path(args.seed)
    quant_launches, _ = phase_serving_lane(args.seed)
    flash_launches, first_loss = phase_train(args.seed, name)
    sp_launches, _, sp_refs = phase_sp_train(args.seed, name)
    megatron_launches, ulysses_launches, _ = phase_hybrid_train(
        args.seed, name, first_loss, sp_refs)
    cal_launches, searched_launches = phase_searched_train(
        args.seed, name, first_loss, calibration_out(1))
    pipe_launches = phase_pipeline_train(args.seed, name, first_loss)
    bert_launches, bert = phase_bert_train(args.seed, name)
    sync_launches = phase_sync_train(args.seed, name, first_loss)
    serve_launches = phase_serve_ranks(args.seed, name)
    phase_zoo(args.seed, name)
    always_on = phase_always_on(args.seed, name)
    obs = phase_observability(args.seed, name)
    frontends = phase_frontends(args.seed, name, bert["step_p50_ms"])
    entry = phase_entry_points(args.seed, name)
    phase_zoo_ranks(args.seed, name)
    split_views = phase_split_views(args.seed, name)

    def entry_launches(kernel):
        """``kernel``'s launches in phase 18: leg (a)'s and (b)'s fit,
        and mfu_variants' flash variant."""
        return {"gpt_fit": entry["a_gpt"]["kernel_rows_launched_fit"][kernel],
                "transformer_fit": entry["b_transformer"][
                    "kernel_rows_launched_fit"][kernel],
                "mfu_variants_flash": entry["d_tools"][
                    "mfu_variants_flash"]["kernel_rows_launched"][kernel]}
    def split_launches(kernel):
        """``kernel``'s launches on each rank of phase 20."""
        return [r[kernel] for r in
                split_views["kernel_rows_launched_per_rank"]]
    fp32, int8 = rpa["fp32"], rpa["int8"]
    kernels = [{
        "name": "ragged_paged_attention",
        "kernel": {"fp32": "rpa_split_kernel<float, 64>",
                   "bf16": "rpa_split_kernel<__nv_bfloat16, 64>"},
        "route": "cuda",
        "source": "flexflow_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "flexflow_tpu/kernels/ragged_paged_attention.py:132",
        "launches": rpa_launches,
        "launches_observability_frames": obs["a_serve"]["launches"],
        "launches_frontends": frontends["kernel_rows_launched"][
            "ragged_paged_attention"],
        "launches_entry_points": entry_launches("ragged_paged_attention"),
        "launches_split_views_per_rank": split_launches(
            "ragged_paged_attention"),
        "launches_serving_per_rank": {
            leg: ls["ragged_paged_attention"]
            for leg, ls in serve_launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in rpa.values()),
        "ms": fp32["ms"],
        "plain_ms": fp32["plain_ms"],
        "bound_ms": fp32["bound_ms"],
        "bound_by": fp32["bound_by"],
        "library_ms": fp32["library_ms"],
        "bf16_pool": rpa["bf16"],
    }, {
        "name": "ragged_paged_attention_quant",
        "kernel": "rpa_quant_split_kernel<64>",
        "route": "cuda",
        "source": "flexflow_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "flexflow_tpu/kernels/ragged_paged_attention.py:233",
        "launches": quant_launches,
        "launches_frontends": frontends["kernel_rows_launched"][
            "ragged_paged_attention_quant"],
        "launches_entry_points": entry_launches(
            "ragged_paged_attention_quant"),
        "launches_split_views_per_rank": split_launches(
            "ragged_paged_attention_quant"),
        "launches_serving_per_rank": {
            leg: ls["ragged_paged_attention_quant"]
            for leg, ls in serve_launches.items()},
        "max_abs_err": int8["max_abs_err"],
        "ms": int8["ms"],
        "plain_ms": int8["plain_ms"],
        "bound_ms": int8["bound_ms"],
        "bound_by": int8["bound_by"],
        "library_ms": int8["library_ms"],
        "drift_vs_fp32_pool": int8["drift_vs_fp32_pool"],
    }]
    # the CUDA symbols at the main path's head dim 64 (D' = 64)
    for kind, wrapper, line, symbols in (
            ("fwd", "flash_forward", 66,
             ("flash_fwd_tc_kernel<64, false>",
              "flash_fwd_kernel<float, 64, false>")),
            ("dq", "flash_backward_dq", 194,
             ("flash_bwd_dq_tc_kernel<64>", "flash_bwd_dq_kernel<float, 64>")),
            ("dkv", "flash_backward_dkv", 242,
             ("flash_bwd_dkv_tc_kernel<64>",
              "flash_bwd_dkv_kernel<float, 64>"))):
        bf16 = flash[(kind, "bf16")]
        kernels.append({
            "name": wrapper,
            "kernel": dict(zip(("bf16", "fp32"), symbols)),
            "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"flexflow_tpu/kernels/flash_attention.py:{line}",
            "launches": flash_launches[wrapper],
            "launches_megatron_per_rank": megatron_launches[wrapper],
            "launches_ulysses_per_rank": ulysses_launches[wrapper],
            "launches_searched_per_rank": searched_launches[wrapper],
            "launches_pipelined_per_rank": pipe_launches["pipelined"][
                wrapper],
            "launches_placed_per_rank": pipe_launches["placed"][wrapper],
            "launches_bert_fit": bert_launches[wrapper],
            "launches_sync_per_rank_per_step": {
                leg: ls[wrapper] for leg, ls in sync_launches.items()},
            "launches_calibration": cal_launches.get(wrapper, 0),
            "launches_always_on": always_on["a_one_card"]["launches"][
                wrapper],
            "launches_always_on_per_rank": {
                rank: ls[wrapper] for rank, ls in always_on[
                    "b_device_loss"]["launches_per_rank"].items()},
            "launches_observability_fit": obs["a_fit"]["launches"][wrapper],
            "launches_observability_sync_per_rank": [
                r["launches"][wrapper] for r in obs["c_sync"]["per_rank"]],
            "launches_frontends": frontends["kernel_rows_launched"][wrapper],
            "launches_entry_points": entry_launches(wrapper),
            "launches_split_views_per_rank": split_launches(wrapper),
            "max_abs_err": bf16["max_abs_err"],
            "ms": bf16["ms"],
            "plain_ms": bf16["plain_ms"],
            "bound_ms": bf16["bound_ms"],
            "bound_by": bf16["bound_by"],
            "library_ms": bf16["library_ms"],
            "fp32": flash[(kind, "fp32")],
        })
    main_row = partial["bf16"]  # most ring blocks carry no mask
    kernels.append({
        "name": "flash_forward_partial",
        "kernel": {"bf16": "flash_fwd_tc_kernel<64, true>",
                   "fp32": "flash_fwd_kernel<float, 64, true>"},
        "route": "cuda",
        "source": "flexflow_tpu_torch/csrc/flash_attention.cu",
        "replaces": "flexflow_tpu/kernels/flash_attention.py:527",
        "launches": sp_launches["flash_forward_partial"],
        "launches_searched_per_rank": searched_launches[
            "flash_forward_partial"],
        "launches_pipelined_per_rank": pipe_launches["pipelined"][
            "flash_forward_partial"],
        "launches_placed_per_rank": pipe_launches["placed"][
            "flash_forward_partial"],
        "launches_calibration": cal_launches["flash_forward_partial"],
        "launches_frontends": frontends["kernel_rows_launched"][
            "flash_forward_partial"],
        "launches_entry_points": entry_launches("flash_forward_partial"),
        "launches_split_views_per_rank": split_launches(
            "flash_forward_partial"),
        "max_abs_err": max(r["max_abs_err"] for k, r in partial.items()
                           if k.startswith("bf16")),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library_call": main_row["library_call"],
        "bf16_causal": partial["bf16_causal"],
        "fp32": partial["fp32"],
        "fp32_causal": partial["fp32_causal"],
    })
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
