#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mpi4dl_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # the full run, a few minutes on one H100
    python3 chip_smoke.py --profile       # + a torch.profiler breakdown of one step of each path
    python3 chip_smoke.py --spatial-only  # only the build and phase s (for a 4-card host)
    python3 chip_smoke.py --pipeline-only # only the build and phase p (with g's 2-rank part)
    python3 chip_smoke.py --gems-only     # only the build and phases p, q and g (for a 4-card host)
    python3 chip_smoke.py --tools-only    # only the build and the run tooling (t, e, s9)
    python3 chip_smoke.py --serve-only    # only the build and the serving phase r
    python3 chip_smoke.py --fleet-only    # only the build and the fleet phase f (f1-f3)
    python3 chip_smoke.py --analysis-only # only the build and the analyzers' phase n (n3-n10)

Phases (any failure exits non-zero; nothing is caught):

  a. build every kernel of the main paths from ``mpi4dl_tpu_torch/ops/csrc``
     (one nvcc per source, all started together) and print each kernel's
     registers, shared memory and spills as ptxas reports them;
  b. small-input references, one f32 training step each on the card (TF32
     off) against the same step on the CPU (plain versions): loss and
     per-leaf-normalised gradients. AmoebaNet-D 3L/32F @64 bs2 and
     ResNet-v2 depth 20 @32 bs2. Then each step once more on the card under
     ``MPI4DL_TPU_BN_BWD=fused`` (the BN-moments backward in the input
     dtype) against the default: the loss bit-equal, each gradient within
     ``BN_BWD_ATOL + BN_BWD_RTOL`` x its leaf's max;
  c. the main paths, each through ``Trainer.train_step`` with bf16
     compute / f32 params, SGD momentum 0.9, random weights from a seed,
     no recomputation: AmoebaNet-D 18L/416F @1024 bs2, then ResNet-110 v2
     @1024 bs2. The first warm-up step of each records every shape the
     kernels are called with; then every kernel's launch count is set to
     0, the timed steps run, and the counts are read (each kernel of the
     path must be > 0); then the first step once more with f32 compute
     (TF32 off), the spatial paths' reference; then a fresh trainer's first
     two steps under ``MPI4DL_TPU_BN_BWD=fused``: the first loss bit-equal
     to the default backward's, the first step's gradients at most
     ``GRAD_DIST_RATIO`` times as far from the f32 step's as the default's,
     K1-K3 launched as often, ResNet-110's second loss within
     ``BN_BWD_LOSS_RTOL`` (AmoebaNet-D's printed), peak memory printed;
  r. serving (``mpi4dl_tpu_torch.serve``):
     r1. phase b's small f32 models (TF32 off), statistics from
         ``collect_batch_stats`` on the card, a ``SingleChipPredictor``'s
         buckets ``R_BUCKETS`` captured (a CUDA graph each): each replay
         within ``R_CPU_TOL`` of max |logit| of the CPU predict (plain
         versions) and bit-equal to the eager forward of the same bucket on
         the card (else within ``R_EAGER_TOL``, and the line says so);
     r2. AmoebaNet-D 18L/416F @1024 bf16 (phase c's seed), statistics over
         ``R_CAL_BATCHES`` batches, a ``ServingEngine`` with buckets
         ``R_BUCKETS``: per bucket the warm-up and capture s, the graph
         pool's bytes, the peak memory, and a replay beside the eager
         forward (ms, CUDA events, median of ``R_TIMED``); then
         ``R_BURST`` requests at once and ``R_SINGLES`` one by one through
         ``submit``: every response bit-equal to its row of the eager
         forward of the padded batch it rode in, ``assert_warm`` passes and
         no graph is captured after warm-up; served count, batches and
         p50/p90/p99 printed;
     r3. (in phase s's ranks, after v3; with ``--serve-only`` in a 4-rank
         world of its own) s1's small f32 spatial ResNet-v2 @32 through a
         ``ShardedPredictor`` (buckets ``R_SP_BUCKETS``) against the
         single-device CPU predict (``R_CPU_TOL``); then ``resnet_sp`` with
         v3's statistics behind a ``ServingEngine`` on rank 0 (the other
         ranks follow its broadcasts; each bucket two graphs, the join
         between them eager): K4 launched in each bucket's capture on every
         rank, a replay's host wall per bucket (median of ``R_SP_TIMED``),
         ``R_SP_REQUESTS`` requests, each bit-equal to its row of the eager
         spatial predict of its padded batch;
     r4. r2's model and statistics saved as a checkpoint, then
         ``mpi4dl_tpu_torch.serve.__main__.main`` in this process on it
         (``R4_FLAGS``: open loop at 20 req/s for 5 s, a serial baseline,
         availability and latency SLOs, ``--metrics-port 0``) while a thread
         scrapes ``/metrics``, ``/healthz`` and ``/alertz`` once under load:
         exit 0, the last line with the JAX report's keys (``R4_KEYS``),
         ``/metrics`` 200 with ``serve_requests_total``, ``/healthz`` 200,
         ``/alertz`` parses, an SLO verdict, no capture after warm-up;
     r5. tiled serving of ResNet-110 v2: a. f32 @1024 (TF32 off), tile
         ``R5_TILE`` (ragged edge tiles), the tiled logits within ``R5_TOL``
         of max |logit| of the monolithic eager forward; b. bf16 @``R5_SIZE``
         with the default tile behind a ``tiled_engine``, ``R5_REQUESTS``
         requests and one monolithic forward: the tiled request's peak
         (``max_memory_allocated`` plus the graph pool) under half of the
         monolithic forward's, and the engine's ``lint_report()`` clean
         (the single-chip zero-collectives rule); tiles, stitch and stream
         s, latency and the bf16 difference printed;
     r6. (beside r5) ``python -m mpi4dl_tpu_torch.serve --mesh 2x2
         --requests 8 --serial 0`` as a subprocess (4 rank processes, K4
         inside each bucket's graphs): exit 0, one report line, mesh [2, 2];
     r7. the bench's ``serving_amoebanet3_32px`` extra
         (``bench.measure_serving``) in this process: throughput above 0, an
         SLO verdict, ``lint_ok`` true and no ``lint_findings``,
         ``attribution`` with attributed batches and no error (its device
         share printed), and ``sched_ab`` with both arms' tight-class p99
         and rps and no deadline miss (EDF's and FIFO's tight p99, their
         ratio and rps printed, not gated); then the trace's cost on the
         extra's throughput, read on one engine of its own (its closed loop
         alternately untraced and traced, ``R7_TRACE_PAIRS`` pairs; printed,
         not gated);
  t. ``mpi4dl_tpu_torch.profile_step.main`` on ResNet-110 v2 @1024 bs2 (its
     default ``cell_save``, 2 warm-up and 2 traced steps) in this process,
     K1-K4's counts set to 0 just before and read after: its two
     ``mpi4dl_capture`` windows each hold one ``mpi4dl_train_step``; K2's
     and K3's kernel events in its trace are the traced steps' share of
     their launches, the same a step as on phase c's ResNet-110 path; the
     report's tables printed;
  e. the supervisor: the ResNet LP twin as a subprocess (ResNet-11 v2 @64,
     batch 4 in 2 micro-batches, 2 ranks, bf16, ``--max-steps 4``, a
     checkpoint every step), ``--max-restarts 1``, every rank exiting at
     step 2 of the fresh run (``MPI4DL_TPU_CRASH_AT_STEP=2``) and
     ``--trace-dir``: exit 0, "restarting (1/1)" and "resumed from step 2"
     printed, the newest checkpoint at step 4, one Chrome trace a rank, each
     with CUDA kernel events. Then the same supervision of the ResNet SP
     twin (ResNet-11 v2 @64, its front on a 2x2 grid of 32 px tiles,
     split 2, 4 ranks, ``E_SP_ARGV``) with ``MPI4DL_TPU_RUN_REPORT``: the
     same gates, and K4 launched on every rank in the restarted run's
     steps after its first (its world opens fresh K4 rings); its wall time
     printed. It times nothing and runs with ``--tools-only`` only (the
     full run left it out to keep inside its time limit). Its lines read
     ``[e] supervised`` and ``[e]`` and the twins' output; phase e of d-g
     below, K2's checks, is another;
  m. the bench's slice, in this process:
     m1. ``python -m mpi4dl_tpu_torch.bench``'s 2048 px training points
         through the functions it calls (``bench.measure_amoeba``,
         ``bench.measure_resnet``): AmoebaNet-D 18L/416F @2048 bs2 (two bs1
         chunks, grad_accum=2) and bs1, ResNet-110 v2 @2048 bs1, remat=False,
         2 warm-up and 3 timed steps each. The first warm-up records the
         kernels' call shapes (phases d-g gate and time them); every kernel
         of the point must launch in its timed steps, chunks times as often
         a step as on phase c's path; img/s, step p50/p90/p99, MFU and peak
         memory printed;
     m2. every ported remat policy on both main paths @1024 bs2 (AmoebaNet-D
         at ``M2_LAYERS`` layers, its width kept, to save time): the first
         step's loss bit-equal to remat=False's and the same K1-K3 launches
         a step; peak memory and a step's time printed. Then phase b's
         small f32 models under each policy on the card against remat=False
         (loss equal, gradients within ``REMAT_GRAD_TOL``);
     m3. (beside m2 and w1, whose printed step times then include it)
         ``python -m mpi4dl_tpu_torch.bench`` as a subprocess
         (BENCH_MODEL=amoebanet BENCH_STEPS=3 BENCH_TIME_BUDGET=1
         BENCH_SERVING=0 BENCH_TILED=0 BENCH_HLO=0 BENCH_ATTRIBUTION=0,
         the serving extra is r7's, the analyzers' keys phase n's): every
         JSON line parses, the last is ``amoebanetd_1024px_bs2_train_gpu``
         with a value, an MFU and a ``telemetry`` snapshot, exit 0 (phase
         n7 reads that line);
  w. the peak-pixel walk's slice, in this process:
     w1. ResNet-110 v2 @1024 bs2 under ``scan2``, ``scan2`` with
         ``MPI4DL_TPU_SCAN2_OFFLOAD=1``, ``scanlog``, ``scanq``, ``scanq``
         with a store budget, ``scan_save`` with a save budget and ``scan``
         with a no-checkpoint budget (``WALK_VARIANTS``): the first step's
         loss bit-equal to remat=False's (phase m2's) and the same K2/K3
         launches a step; peak memory, a step's time and the budgets'
         grants printed. Then phase b's small f32 models and ResNet-v1
         depth 44 @32 bs2 (runs of 6 cells) under each variant against
         remat=False (loss equal, gradients within ``REMAT_GRAD_TOL``);
     w2. the walk's steps past what remat=False fits, ResNet-110 v2 bs1:
         @3072 under ``scanlog`` and @4096 under ``scanq`` with the bench's
         3000 MB store budget, one step each. It records the kernels'
         call shapes (phases d-g gate and time them: x up to
         [1,4096,4096,64], 2^31 bytes); every count is set to 0 before it
         and read after it: K2 and K3 launch as often as on phase c's
         ResNet-110 path; peak memory and the step's time printed;
     w3. (after phase g) K1 at AmoebaNet-D 18L/416F @4096 bs1's shapes
         (phase m1's @2048 bs1 shapes, H and W doubled) and K2/K3 at
         ResNet-110's stage-0 shapes @8192 bs1 (x[1,8192,8192,64], 2^32
         elements), bf16, against their plain versions (K1 exact, K2/K3
         within phases e-f's tolerances; K2's and K3's dw, sums of 2^26
         products, held against a float64 sum, their errors against the f32
         plain version printed beside it), then timed beside the library
         call and the bound;
  v. the eval and checkpoint slice (v3 runs inside phase s's ranks):
     v1. ``python -m mpi4dl_tpu_torch.convergence_run`` as a subprocess at
         its defaults (ResNet-20 v2 @32 bs64, 300 steps on
         ``ClassPatternImages``, a checkpoint every 50; phase A SIGKILLed
         after step 150, phase B resumes): exit 0 (A killed, B clean, the
         three checks true) and K2 and K3 launched in both phases; the
         curve's ends, the final accuracy and the wall seconds printed;
     v2. AmoebaNet-D 18L/416F @1024 bs2 (phase c's model, seed and bf16 /
         f32 set-up) on ``ClassPatternImages(2, 1024, 10, seed=SEED)``: two
         steps, ``save_checkpoint`` with ``model_metadata``,
         ``rebuild_from_checkpoint`` into a fresh model and Trainer (params,
         momentum and step bit-equal), one more step on both on one batch
         (losses within ``RESUME_LOSS_RTOL``, K1-K3 at phase c's per-step
         counts in the resumed step), then ``collect_batch_stats`` over 2
         batches and ``evaluate`` over 2 more; checkpoint bytes, save and
         restore s, calibration and eval ms a batch printed. Then phase b's
         small f32 models: calibration and eval on the card against the
         CPU (loss ``EVAL_LOSS_RTOL``, statistics ``EVAL_STAT_TOL``);
     v3. (in phase s's ranks, after s2) spatial ResNet-110 v2 @1024 bs2 on
         the 2x2 tiles: ``spatial_collect_batch_stats`` over 2 batches and
         ``spatial_evaluate`` over 2 (K4 must launch in every rank's eval
         forward); rank 0 saves, every rank rebuilds a fresh spatial Trainer
         from the checkpoint (bit-equal on every rank); then s1's small f32
         spatial models, calibration and eval on the tiles against
         single-device eval on the CPU (``SP_EVAL_TOL``);
  f. the replica fleet (``mpi4dl_tpu_torch.fleet``): two supervised
     replicas (``python -m mpi4dl_tpu_torch.fleet.worker``, each a
     ``ServingEngine`` of ResNet-110 v2 @1024 f32, TF32 off, weights from
     seed 0, a captured graph for buckets 1 and 2) on the card, one router
     process with its journal, federation on; in the full run they start
     beside phase v1 and f1-f2 run after it:
     f1. ``F1_REQUESTS`` requests, ``F_CONCURRENCY`` at a time, of
         ``F_IMAGES`` seeded images through ``RouterSetClient``: every
         answer within ``R_EAGER_TOL`` of max |logit| of this process's own
         predict of the same image with the same model on the card; the
         federated ``/metrics`` of an aggregator over the replicas counts
         ``F_REPLICAS`` up and as many served as the client; each
         replica's cold-start phases (import, construct, compile, warm,
         ready) and capture peak printed;
     f2. ``F2_REQUESTS`` more, ``kill:1`` (SIGKILL replica 1) once a
         quarter is answered and replica 1 holds requests in the router's
         in-flight ledger: every request answered once (distinct trace
         ids; none served twice in the replicas' span logs), the router
         requeued at least one, the supervisor records one restart and the
         replacement reaches ready, ``/incidentz`` opened one incident whose
         first cause is the kill and closed it after recovery; then
         ``F1_REQUESTS`` on the restored fleet; answers as f1's; the
         recovery s and its phases, req/s before, during and after, p50,
         p90 and p99 printed;
     f3. (``--fleet-only`` alone) the wedge drill (replica 0's batcher
         blocked: its watchdog trips, its heartbeat goes stale, the
         supervisor replaces it; every request answered), the corrupt drill
         (bits flipped in replica 1's live parameters: its fence trips
         within the canary interval and ``/predict`` answers 503, the
         federation's numerics page names it, it is replaced), and one
         ``--mesh 2x2`` replica (4 rank processes) of the synthetic
         ResNet-v1 depth 8 @``F_MESH_SIZE`` behind a router: K4 launched in
         its captures, its answers within ``R_CPU_TOL`` of max |logit| of
         the single-device predict on the card. Phase f's lines read
         ``[f]``, ``[f1]``-``[f3]``; phase f of d-g below, K3's checks, is
         another;
  s. the spatial slice in 4 rank processes (``parallel.multihost.spawn``)
     on a 2x2 tile grid. With 4 or more cards, one rank per card and
     NCCL; with fewer, the ranks share card 0 over a gloo group, and K4's
     CUDA IPC transport stores into another process's buffer on the same
     card:
     s1. small spatial references, f32 (TF32 off), 2x2 tiles: ResNet-v2
         depth 20 @32 bs2 (every cell but the head on the tiles) and
         AmoebaNet-D 3L/32F @128 bs2 (4 cells on the tiles: the normal
         cell runs on 8-px tiles, the least at which every exchanged
         extent is twice its halo), each against the single-device step
         on the CPU with the same weights and batch (loss and per-leaf
         gradients, 1e-3);
     s2. the spatial main paths: ResNet-110 v2 (``resnet_sp``) and then
         AmoebaNet-D ``SP_LAYERS``L/416F (``amoebanet_sp``; 3L, 18L before
         phase r came, 6L before n7) @1024 bs2, every cell but
         the head on the tiles, bf16 compute / f32 params, SGD momentum
         0.9, random weights from the seed of phase c, remat=False,
         ``SP_WARMUP`` warm-up and ``SP_STEPS`` timed steps each. The first
         warm-up records the kernels' call shapes and the halo exchanges (K4 runs their axis
         phases, one launch each); the step time of each timed step is its
         slowest rank's; every kernel of the path must launch in every
         rank's steps. The first warm-up also holds every avg-pool window
         sum, output and input gradient, against float64 (``WS_BOUND``),
         and every cached avg-pool divisor must be exact after the timed
         steps. Then the first step once more with f32 compute (TF32
         off), whose loss must be within ``F32_LOSS_RTOL`` of the
         single-device f32 first step of the same depth, weights and batch
         (phase c's for ResNet-110, one at ``SP_LAYERS`` for AmoebaNet-D), and
         whose gradients give the bf16 first step's distance from f32
         (the median leaf's max |err| / max |ref|);
     s7. the D2 fused-halo paths, as s2: ResNet-110 v2 D2
         (``resnet_sp_d2``, ``get_resnet_v2_d2`` with ``fused_layers=2``:
         23 exchanges a forward against D1's 73) and AmoebaNet-D
         ``SP_LAYERS``L/416F D2 (``amoebanet_sp_d2``, ``halo_d2=True``); K1 (AmoebaNet), K2, K3
         and K4 must launch in every rank's steps, the f32 first step must
         be within ``F32_LOSS_RTOL`` of the single-device one, and K4's
         phase launches a step are printed beside the D1 twin's. Against
         the D1 twin in bf16: the first step's loss within
         ``BF16_FIRST_LOSS_RTOL``, ResNet's every step within
         ``BF16_LOSS_RTOL``, AmoebaNet-D's first-step distance from f32
         at most ``GRAD_DIST_RATIO`` times the twin's (s8 too); then s1's
         small f32 references in their D2 form (ResNet-v2 D2 depth 20 @32
         with 4 D1 cells on the tiles, AmoebaNet-D D2 3L/32F @128) against
         the single-device step on the CPU (1e-3);
     s8. the decomposed arm: ``resnet_sp`` and ``amoebanet_sp`` again with
         ``MPI4DL_TPU_CONV_OVERLAP=decomposed`` (``resnet_sp_dec``,
         ``amoebanet_sp_dec``): every padded spatial conv and pool runs its
         interior while K4 runs on the rings' exchange stream, then its
         boundary strips. Every kernel must launch, the exchanges must have
         run deferred on the exchange stream, and the f32 first-step loss
         must be within ``DEC_LOSS_RTOL`` of the monolithic arm's; both
         arms' step times are printed (with 4 ranks time-sliced on one
         card no overlap can show); then s1's small f32 references in the
         decomposed form against the single-device step on the CPU (1e-3);
     s3. K4 against its plain version: at every recorded exchange shape of
         every spatial path (one-axis exchanges and the D2 widths too) a
         whole exchange (output and input gradient) against the whole-grid
         ``halo_exchange_reference`` of all ranks' tiles, made from the
         seed on every rank, bf16 and f32, fills 0 and −inf; the plain swap
         (``halo_swap``) at every strip those exchanges send against
         ``swap_reference``; exchanges against a pad and slice of the full
         image (one with a tile extent of twice the halo): all exact;
     s4. a one-word flag round trip between two ranks' arenas; one whole
         exchange (forward, and backward where the step differentiates it)
         at every recorded shape beside NCCL's ``batch_isend_irecv`` of the
         same strips (one rank per card only) and the bound (bytes over the
         card's and NVLink's rates plus half a round trip a phase), and their
         launch-weighted sum per step of each path; the timed exchange's plain
         distributed version (CPU tensors over gloo); one swap of the
         largest strip pair beside NCCL;
     s5. K4's time-bounded wait: a swap that only rank 0 makes must end
         after its wait limit with the error word set;
     s6. three exchanges, forward and backward, captured in one CUDA graph
         on every rank and replayed 3 times on new inputs, each replay
         exactly equal to the plain version;
     s9. (last in the ranks, as p1 runs its twins) the four halo twins'
         ``main`` (``mpi4dl_tpu_torch.benchmarks.communication.halo``) at
         their JAX scripts' defaults with ``--impl kernel`` (the timed two
         at ``--iterations 20 --warmup 3``), and the raw exchange's
         ``--impl plain`` at the reference's documented configuration
         (1024 px, halo 3, vertical 4): every validation passes and K4
         launches on every rank of each kernel run; each median (slowest
         rank, CUDA events) printed beside K4's row; with ``--tools-only``
         in a 4-rank world of their own;
  p. the LP/PP pipeline (``parallel.pipeline.PipelineTrainer``), 2 stages
     on 2 rank processes: one rank per card with 2 or more cards (NCCL),
     else both on card 0 over a gloo group with the wires staged through
     pinned host buffers. AmoebaNet-D 3L/416F (``PIPE_LAYERS``) and
     ResNet-38 v2 (``PIPE_RESNET_DEPTH``) @1024 from the seed, batch 4 in 4
     micro-batches, GPipe and interleaved 1F1B (v=2):
     p2. (first) in the phase's 2 ranks, f32 (TF32 off): each
         schedule's first step, whose loss must be within ``PP_LOSS_RTOL``
         of ``Trainer(grad_accum=4)``'s on the same weights and batch (run
         by rank 0), GPipe's within ``PP_SCHED_RTOL`` of 1F1B's, whose
         gradients (SGD's momentum buffers, gathered to rank 0) must be
         within ``PP_GRAD_TOL`` of the Trainer's in each virtual stage
         (relative L2 norm), and whose K1/K2/K3 launches summed over the
         ranks must equal the Trainer step's; every tick is probed: an
         idle tick (no stage work) runs no op on the card and launches no
         K1-K3. The GPipe step records the kernels' call shapes (phases
         d-g check and time them). Then ResNet-38's checkpoint: a step,
         ``save_checkpoint`` (rank 0 writes the JAX pipeline layout), a
         step; a new trainer restores it and its step's loss must be
         bit-equal on every rank;
     p1. then, in the same 2 ranks, each LP twin under each schedule
         (``MPI4DL_TPU_PIPELINE_SCHEDULE``; the ``main`` of
         ``mpi4dl_tpu_torch.benchmarks.layer_parallelism.benchmark_{
         amoebanet,resnet}_lp`` as ``torchrun`` would start it: each run
         joins a process group of its own, so the runs share the ranks'
         start but not their set-up; bf16, ``--max-steps 2``): its
         Mean/Median/MFU line. For each model and schedule (the ranks'
         ``MPI4DL_TPU_RUN_REPORT`` records): the step (slowest rank) and
         img/s, per-rank K1/K2/K3 launches a step (their sum must equal the
         Trainer's of p2), peak memory per rank, the analytic bubble and
         the transport;
  q. the spatial front ahead of the pipeline (SP+LP,
     ``parallel.pipeline.PipelineTrainer`` on a ``RankLayout``), LOCAL_DP_LP,
     SP+DP and skewed SP, on 4 rank processes laid out as phase s's (one
     rank per card with 4 cards over NCCL, else all on card 0 over gloo):
     q1. (in the ranks) small f32 references (TF32 off), ResNet-v2 depth 20
         @32 from the seed: SP+LP on vertical 2 tiles x split 3 (batch 2,
         parts 2: the front split over the 2 pipe coordinates), LOCAL_DP_LP
         on square 4 tiles x split 2 (batch 8, ``local_dp`` 4), SP+DP on
         the ``Trainer`` (vertical 2 tiles x 2 replicas, batch 4) and skewed
         SP ``(4, 2)`` x split 3, each one step on the card against the
         port's CPU step on the same weights and batch (rank 0:
         ``Trainer(grad_accum=parts·replicas)``, or LOCAL_DP_LP's grouping,
         the front over each micro-batch and the back over each slice):
         loss and per-leaf gradients, 1e-3;
     q2. (in the ranks) phase p's models in f32 (TF32 off), ResNet-38 v2 and
         AmoebaNet-D 3L/416F @1024, vertical 2 tiles x split 3, batch 2 in 2
         micro-batches: the first step's loss within ``PP_LOSS_RTOL`` of
         ``Trainer(grad_accum=2)``'s on the same weights, both the spatial
         one on pipe coordinate 0's tile grid (its 2 ranks) and the one on
         one device (rank 0), the front's and each virtual stage's
         gradients within ``PP_GRAD_TOL`` of the spatial Trainer's
         (relative L2, the pipeline's SGD momentum gathered to rank 0), and
         of the one-device Trainer's for ResNet-38 (``Q_GRAD_GATED``), K4
         launched on every rank, and K1-K3 launched, their launches summed
         over the ranks equal to the tile count times the Trainer's (the
         front runs once a micro-batch on each tile, the back on each tile
         rank); the call shapes are recorded for phases d-g;
     q3. (in the ranks, as p1 runs its twins) each SP twin's ``main``
         (bf16, ``--max-steps 2``, ``MPI4DL_TPU_RUN_REPORT``): ResNet-38
         and AmoebaNet-D 3L/416F SP+LP (vertical 2 tiles, split 3, batch 2,
         parts 2) and ResNet-38 LOCAL_DP_LP (square 4 tiles, split 2,
         batch 4, ``--local-DP 4``), @1024: the Mean/Median/MFU
         line; the step (slowest rank), img/s, per-rank K1-K4 launches a
         step (K4 on every rank) and peak memory, and the transport;
  g1-g3. GEMS-MASTER (``parallel.pipeline.GemsMasterTrainer``: the
     pipeline in both directions over the same ranks, ``2·times`` chunks of
     the batch a step, the odd ones on the mirror placement), in phase p's
     and phase q's worlds: p's 2 rank processes run g2 (after p2's steps of
     each model), g1's LP layouts and g3's LP twins (after p1's), q's 4 run
     g1's SP layouts (after q2) and g3's SP+GEMS twins (after q3's). Its
     sub-phases are g1-g3; the kernel timings below keep the name g:
     g1. small f32 references (TF32 off), ResNet-v2
         depth 20 @32 from the seed: LP GEMS split 2 with ``times`` 1 (2
         chunks of 2 images) and 2 (4 chunks of 1 image), the mirror
         placement alone (``PipelineTrainer(mirror=True)``), and SP+GEMS on
         vertical 2 tiles x split 3 (2 chunks of 1 image), each one step on
         the card against the port's CPU
         ``Trainer(grad_accum=chunks·parts)`` on the same weights and the
         same ``chunks·batch`` rows: loss and per-leaf gradients, 1e-3; and
         SP+GEMS on 2 chunks of 2 images, its loss and the front's and each
         stage's gradients in relative L2 (``PP_GRAD_TOL``);
     g2. phase p's models in f32 (TF32 off),
         ResNet-38 v2 and AmoebaNet-D 3L/416F @1024, GEMS ``times`` 1
         on split 2, 2 chunks of 2 images in 2 micro-batches (4 images): the
         first step's loss within ``PP_LOSS_RTOL`` of
         ``Trainer(grad_accum=4)``'s on one device (rank 0) and within
         ``G_PP_LOSS_RTOL`` of ``PipelineTrainer(parts=4)``'s gpipe step on
         the same weights and batch (p2's steps), each stage's gradients
         (the first step's SGD momentum, gathered) within ``PP_GRAD_TOL`` of
         the Trainer's (relative L2), K1-K3 launched on every rank and their
         sum over the ranks equal to the Trainer's; the call shapes are
         recorded for phases d-g;
     g3. (as p1 and q3 run their twins) each GEMS twin's ``main`` (bf16,
         ``--times 1``, ``--max-steps 2``, ``MPI4DL_TPU_RUN_REPORT``): LP
         GEMS ResNet-38 and AmoebaNet-D 3L/416F (split 2, batch 2, parts 2,
         2 ranks) and SP+GEMS (vertical 2 tiles x split 3, batch 2, parts
         2, 4 ranks), @1024: the Mean/Median/MFU line; every kernel of the
         path launched on every rank (K4 on every SP+GEMS rank), K1-K3 a
         step summed over the ranks equal to the tile count (1 for LP) times
         ``Trainer(grad_accum=4)``'s of the twin's model and depth (g2's);
         the step (slowest rank), img/s (``2·times·batch`` images a step),
         per-rank K1-K4 launches, peak memory and mirror exchange bytes, and
         the transport;
  d. K1 (max-pool backward) against its plain PyTorch version at every
     recorded main-path shape (the halo-extended tiles of the spatial path,
     p = 0, also with a −inf outer ring, as a tile at the image's edge
     has), then at a few edge shapes (``K1_EDGE``), on tie-heavy integer
     data: exact equality;
  e. K2 (stride-1 weight gradient) against its plain version at every
     recorded shape of the paths (phase m1's too), bf16 and f32 (tolerance
     below);
  f. K3 (fused 1x1-conv backward) against its plain version at every
     recorded shape of the paths (tolerances below);
  g. per-kernel times (kernel, plain version, one library call) at the
     largest main-path shape of each, beside the bound the card's peaks give;
     then K1, K2 and K3 at every recorded call shape of the paths (kernel,
     library call, bound, launches per step of each path there) and each
     path's launch-weighted sum per step, and the layout copies that
     ``MaxPool.backward`` makes in front of K1 on the main path;
  h. the card's name and power limit from nvidia-smi, the run tooling's
     seconds (t, e and s9), each path's MFU (``mpi4dl_tpu_torch.flops``: 3x
     the forward's conv and dense FLOPs an image, over the card's bf16
     peak), and where the script's seconds went: each phase tag's seconds,
     from its first line to the next tag's first line;
  n. the analyzers (``mpi4dl_tpu_torch.analysis``):
     n1. (in phase t) phase t's trace through
         ``analysis.trace.analyze_trace_dir``: 2 attributed steps, each
         step's compute + collective + transfer + host gap equal to its wall,
         K2's and K3's kernel events ``compute``, no collective time; and
         the collective log of profile_step's 4 single-device steps linted
         as one device's program: no collective, ``single-chip-collectives``
         silent. The per-step buckets printed;
     n2. (in phase s's ranks) the last warm-up step of every spatial path
         under ``collective_log()``, linted against its trainer's deltas:
         ``resnet_sp`` passes ``halo-permute-count`` against
         ``Trainer.halo_shift_count``, and its log's permutes are 2 x K4's
         launches in that step (an axis phase is JAX's two shifts); every
         path's inventory printed;
     n3. (``--analysis-only``) ``python -m mpi4dl_tpu_torch.analyze`` as a
         subprocess on ``N3_RUNS`` at the main paths' widths, @1024 bs2
         (one device ResNet-v1 depth 110 and AmoebaNet-D 18L/416F, the 2x2
         spatial ResNet-v1 in 4 ranks, ``--dp 2``): exit 0, the
         JSON report with the JAX report's keys (``N3_KEYS``), no error;
     n4. (``--analysis-only``) ``analyze sp-overlap`` with both arms on
         ResNet-v1 depth 110 @1024 bs2, bf16, 4 ranks: per arm the measured
         overlap ratio, collective s, step time and K4's kernel events,
         which equal K4's launches in the traced steps; no lint error;
     n5. (``--analysis-only``) ``analyze pipeline`` with GPipe and 1F1B on
         2 ranks, ResNet-v1 depth 110 @1024, 4 micro-batches of 1, bf16:
         exit 0 (no lint error, the wires at their exact budget, the
         ticks' idle slots within the crosscheck's tolerance of the
         analytic bubble: the tick loop runs the schedule); each arm's slot
         bubble beside the analytic one, and each rank's measured
         device-idle share of the traced steps (on one card the ranks take
         turns on it, so that share also holds the other rank's time);
     n6. (``--analysis-only``) ``analyze serving-sharded`` with both arms,
         ResNet-v1 depth 110 @1024 f32 (the harness turns TF32 off: with
         TF32 cuDNN's convs over the decomposed arm's shapes round
         otherwise), bucket 4,
         16 requests, 4 ranks: the arms' logits bit-equal, K4's kernels in
         the trace of the replays, no lint error;
     n7. (in the full run, after phase f) the pure-JSON subcommands of
         ``python -m mpi4dl_tpu_torch.analyze`` on what the run wrote:
         ``tail`` and ``incident`` over phase f's fleet telemetry (the kill
         incident's first cause ``chaos.injected``), ``trace-export`` over
         the same logs, ``coldstart`` over the fleet workers' ledger dumps
         (its manifest lists phase f's buckets), ``bench-history`` over
         m3's result line against itself (no regression), and
         ``memory-plan --ledger`` over the ledger phase c's steps record
         through ``Trainer.record_memory_footprint`` (every peak fits the
         card): each exits 0;
     n8. (``--analysis-only``) ``analyze numerics`` live: ResNet-v1 depth
         110 @1024 f32 (TF32 off) through the single-chip, the sharded
         (``--mesh 2x2``, 4 ranks, K4 in its captures) and the tiled
         predictor: the parameter checksums agree, every pair within the
         JAX ``pair_atol``; each pair's max-abs and max-ulp printed;
     n9. (``--analysis-only``) ``analyze memory-plan`` in plan mode: the
         train probes of ResNet-110 v2 @2048 bs1 and AmoebaNet-D 18L/416F
         @1024 bs2, each within ``N9_PEAK_RTOL`` of the peak that the bench's
         ``train_throughput`` (m1's and phase c's code) measures for the
         same point in a process of its own; ``--bisect px`` over
         1024,2048,4096 with the limit between the 2048 probe's peak and the
         card answers 2048; ``--program serve --bisect bucket`` on
         AmoebaNet-D @1024 with the limit between buckets 2's and 4's
         capture peaks answers 2;
     n10. (``--analysis-only``) ``analyze costmodel`` live on the 2x2
         spatial ResNet-v1 110 @1024 bf16 step, ``--interconnect nvlink``:
         exit 0, the prediction's collective count equal to n3's lint of
         the same step, no ``cost-model-crosscheck`` error; the predicted
         comms seconds printed beside the trace's measured collective
         seconds. Speed is never gated in phase n.

The last lines are the ``{"kernels": [...]}`` line and then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import gc
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
# f32 instructions per second outside the tensor cores: the data sheet's
# 67 TFLOP/s counts an FMA as two flops; a compare is one instruction.
F32_SIMT_OPS = 33.5e12
NVLINK_BYTES_PER_S = 450e9  # each way, to the other cards of the host

# K2 and K3, as max|err| / max|ref|: the kernel and the plain version sum
# the same products in f32 in different orders. In bf16, K3's dx is then
# rounded to bf16 (relative step 2^-8), hence 1e-2; every dw stays in f32
# (bf16 products are exact in f32), so it is held to the f32 bound whatever
# the input dtype.
K3_DX_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
DW_TOL = 1e-5
SMALL_GRAD_TOL = 1e-3  # per-leaf-normalised, as tests/test_torch_amoebanet.py
# A spatial path's first-step loss with f32 compute against its single-device
# path's, relative. Measured on an H100: AmoebaNet-D 18L/416F 6.7e-4 apart,
# ResNet-110 v2 equal to 6 digits; in bf16 the two AmoebaNet-D losses are
# 0.063 apart, and bf16 moves each from its f32 value by 0.013-0.052.
F32_LOSS_RTOL = 5e-3
ZERO_GRAD = 1e-4  # of the cell's largest gradient, as tests/test_torch_resnet.py

DEVICE = "cuda"
SEED = 0
# Phases b and c under MPI4DL_TPU_BN_BWD=fused (the BN-moments backward in
# the input dtype) against the default one. Phase b: f32 gradients within
# the JAX test's tolerance (tests/test_spatial_layers.py:205) of each leaf's
# max. Phase c (bf16): the first step's loss bit-equal (the same forward),
# its gradients' distance from the f32 step's (the median leaf's max |err| /
# max |ref|) at most GRAD_DIST_RATIO times the default backward's, and
# ResNet-110's second loss within BN_BWD_LOSS_RTOL. AmoebaNet-D's losses
# after an update move by rounding alone (see BF16_LOSS_RTOL): its second
# loss under fused read 2.95e-2 from the default's on an H100, so it is
# printed, not gated.
BN_FUSED = {"MPI4DL_TPU_BN_BWD": "fused"}
BN_BWD_RTOL, BN_BWD_ATOL = 1e-5, 1e-6
BN_BWD_LOSS_RTOL = {"resnet": 1e-2}
SIZE, BATCH = 1024, 2
WARMUP, STEPS = 2, 5
# The main paths: AmoebaNet-D 18L/416F (bench.py's headline) and ResNet-110
# v2 with the head pool at size // 4 (bench.py's BENCH_MODEL=resnet), both
# @1024 bs2 without recomputation.
LAYERS, FILTERS = 18, 416
RESNET_DEPTH = 110  # utils.get_depth(2, 12)
# The spatial paths: ResNet-110 v2 and AmoebaNet-D 18L/416F on a 2x2 grid of
# tiles, one per rank, every cell but the head on the tiles.
SP_GRID, SP_RANKS = (2, 2), 4
DEC_ENV = {"MPI4DL_TPU_CONV_OVERLAP": "decomposed"}  # s8's arm
# s2 (D1, monolithic), s7 (D2) and s8 (D1, decomposed): path -> (model,
# environment). The rank processes run them in this order.
SP_SPECS = {
    "resnet_sp": ("resnet", {}),
    "amoebanet_sp": ("amoebanet", {}),
    "resnet_sp_d2": ("resnet_d2", {}),
    "amoebanet_sp_d2": ("amoebanet_d2", {}),
    "resnet_sp_dec": ("resnet", DEC_ENV),
    "amoebanet_sp_dec": ("amoebanet", DEC_ENV),
}
SP_PATHS = tuple(SP_SPECS)
# Warm-up and timed steps of a spatial path (2 and 3 before phase p came, 1
# and 2 before phase n7 came; cut to keep the whole script inside its time
# limit: the checks made at every step, such as ResNet's bf16 losses against
# the D1 twin, now see 2 steps, and a path's step time is its one timed
# step's).
SP_WARMUP, SP_STEPS = 1, 1
# AmoebaNet-D's depth on the spatial paths (amoebanet_sp, _d2, _dec; 18L
# before phase r came, 6L before phase n7 came, cut to keep the whole script
# inside its time limit; the width is kept).
# Their f32 first step is held to a single-device f32 first step of the
# same depth, weights and batch, run before phase s.
SP_LAYERS = 3
# Phase m2's AmoebaNet-D depth (its width kept): the policies' bit-equality
# and launch gates at 18L cost about a minute the script needs elsewhere.
M2_LAYERS = 3
D2_FUSED = 2  # the D2 ResNet's fused_layers
# s8: the decomposed arm's f32 first-step loss against the monolithic arm's,
# relative (the same math; cuDNN may pick other algorithms for the interior
# and the strips than for the whole tile).
DEC_LOSS_RTOL = 1e-4
# s2/s7/s8 bf16 gates. A window sum (the avg pools', ``layers.window_sum``)
# rounded once to bf16 is off by at most 2^-8 of its window's |x| sum (its
# input gradient: of the transposed window's |dy| sum). Every window sum of a
# path's first step, output and input gradient, is held to that against
# float64.
WS_BOUND = 2.0 ** -8 + 1e-6
# The first bf16 step's loss (a forward, before any update) of a D2 or
# decomposed path against its D1 monolithic twin's, relative. Measured on an
# H100 (this script): AmoebaNet-D D2 equal, decomposed 8.5e-3; ResNet-110
# D2 equal, decomposed 1.7e-4.
BF16_FIRST_LOSS_RTOL = {"resnet": 2e-3, "amoebanet": 2e-2}
# ResNet-110's bf16 losses at every warm-up and timed step against the D1
# twin's, relative (measured up to 5.3e-4 on one card, 6.2e-4 on four).
# AmoebaNet-D's part after the first update, by up to 45%: its bf16 step
# gradients are mostly rounding, in the JAX package too
# (tests/test_torch_amoebanet.py). There the first step's gradients are held
# instead: the median leaf's max |err| / max |ref| against the path's own
# f32 step may exceed its D1 twin's by this factor at most (measured:
# AmoebaNet-D D1 1.379, D2 1.384, decomposed 1.393).
BF16_LOSS_RTOL = {"resnet": 2e-3}
GRAD_DIST_RATIO = 1.25
K4_TIMING_ITERS = 5  # timed calls an exchange shape (one takes about 18 ms on one card)
K4_TIMEOUT_S = 0.5  # phase s5's wait limit
K4_ROUND_TRIPS = {"nccl": 1000, "gloo": 20}  # flag round trips timed in one launch
# K4's timed exchange: the tile of the 128 px stage, whose W-phase strips
# are the a, b [2,130,1,256] of the swap timed before the exchange was one
# kernel.
K4_TIMED = (2, 256, 128, 128)
KERNELS = ("pool_bwd", "wgrad", "dot1x1_bwd", "halo_swap")
# Phase m1: the training points ``python -m mpi4dl_tpu_torch.bench`` adds at
# 2048 px, (path, model, image size, batch, chunks); AmoebaNet-D @2048 bs2
# runs as two bs1 chunks (grad_accum=2), as bench.py does.
BENCH_POINTS = [
    ("amoebanet_2048_bs2", "amoebanet", 2048, 2, 2),
    ("amoebanet_2048_bs1", "amoebanet", 2048, 1, 1),
    ("resnet_2048_bs1", "resnet", 2048, 1, 1),
]
BENCH_STEPS = 3  # timed steps of a phase m1 point, after WARMUP
# The kernels each path must launch (the spatial paths: per rank).
_MODEL_KERNELS = {"amoebanet": ("pool_bwd", "wgrad", "dot1x1_bwd"),
                  "resnet": ("wgrad", "dot1x1_bwd")}
PATH_KERNELS = {
    **_MODEL_KERNELS,
    **{path: _MODEL_KERNELS[model.split("_")[0]] + ("halo_swap",)
       for path, (model, _) in SP_SPECS.items()},
    **{path: _MODEL_KERNELS[model] for path, model, *_ in BENCH_POINTS},
}
# Timed steps behind each path's launch counts (STEPS unless listed).
STEPS_IN_RUN = {path: BENCH_STEPS for path, *_ in BENCH_POINTS}
STEPS_IN_RUN.update(dict.fromkeys(SP_PATHS, SP_STEPS))
# Phase m2: the first step's loss of every ported remat policy must equal
# remat=False's bit for bit (the forward is the same), and the small f32
# models' gradients must match remat=False's within this, per leaf
# normalised (the backward sums the same products; only cuDNN's data
# gradient may order them differently).
REMAT_GRAD_TOL = 1e-5
# Phase w1: the peak-pixel walk's policies and the budgets, each (policy,
# environment), on ResNet-110 v2 @1024 bs2. Its runs' carries are 0.74,
# 1.48 and 2.95 GB, so a 1000 MB store grants the last run only; the save
# and no-checkpoint budgets likewise grant some runs, not all.
WALK_VARIANTS = [
    ("scan2", {}), ("scan2", {"MPI4DL_TPU_SCAN2_OFFLOAD": "1"}), ("scanlog", {}),
    ("scanq", {}), ("scanq", {"MPI4DL_TPU_SCANQ_STORE_MB": "1000"}),
    ("scan_save", {"MPI4DL_TPU_SAVE_BUDGET_MB": "2000"}),
    ("scan", {"MPI4DL_TPU_NOCKPT_BUDGET_MB": "4000"}),
]
# Phase w2: (path, image size, policy, environment) of the walk's steps past
# what remat=False fits, ResNet-110 v2 bs1 (the 4096 one with the bench's
# scanq store budget).
WALK_POINTS = [
    ("resnet_walk_3072", 3072, "scanlog", {}),
    ("resnet_walk_4096", 4096, "scanq", {"MPI4DL_TPU_SCANQ_STORE_MB": "3000"}),
]
PATH_KERNELS.update({path: _MODEL_KERNELS["resnet"] for path, *_ in WALK_POINTS})
STEPS_IN_RUN.update({path: 1 for path, *_ in WALK_POINTS})
# Phase v: the eval and checkpoint slice. The paths behind its launch counts:
# the convergence run's ResNet-20 v2 steps (both processes, per step), the
# resumed AmoebaNet-D step (v2) and the spatial ResNet-110 eval forward (v3,
# per eval batch: forward exchanges only).
V_BATCHES = 2  # calibration batches, and eval batches
PATH_KERNELS.update({"convergence": ("wgrad", "dot1x1_bwd"),
                     "amoebanet_resumed": _MODEL_KERNELS["amoebanet"],
                     "resnet_sp_eval": ("halo_swap",)})
STEPS_IN_RUN.update({"amoebanet_resumed": 1, "resnet_sp_eval": V_BATCHES})
# The resumed step against the uninterrupted one: bit-equal where cuDNN
# picks the same algorithms, else within this, relative.
RESUME_LOSS_RTOL = 1e-3
# Phase v2's small f32 models, calibration and eval on the card against the
# CPU: eval loss relative, statistics per leaf normalised (TF32 off).
EVAL_LOSS_RTOL = 1e-4
EVAL_STAT_TOL = 1e-3
# Phase v3's small f32 spatial models against single-device eval on the CPU
# (statistics per leaf normalised, loss relative).
SP_EVAL_TOL = 1e-3
# Phase p: the LP/PP pipeline (``PipelineTrainer``), ``PP_RANKS`` stages of
# AmoebaNet-D ``PIPE_LAYERS``L/416F and ResNet-v2 ``PIPE_RESNET_DEPTH`` @1024, batch
# ``PP_BATCH`` in ``PP_PARTS`` micro-batches, each schedule. p2 holds each
# schedule's f32 first step to Trainer(grad_accum=PP_PARTS)'s on the same
# weights (loss within ``PP_LOSS_RTOL``, each virtual stage's gradients
# within ``PP_GRAD_TOL`` of the Trainer's, K1-K3 launches summed over the
# ranks equal) and GPipe's loss to 1F1B's
# (``PP_SCHED_RTOL``). p1 runs each LP twin through its own entry point under
# each schedule: bf16, one warm-up step and ``PP_STEPS - 1`` timed and counted.
PP_RANKS = 2
PP_BATCH, PP_PARTS = 4, 4
PP_STEPS = 2
PP_SCHEDULES = ("gpipe", "1f1b")
PP_LOSS_RTOL = 1e-4
# p2's steps take the LP twins' learning rate. After a first step SGD's
# momentum buffer is the step's gradient; each virtual stage's gradients
# (all its leaves as one vector) are held to the Trainer's in relative L2
# norm. A gradient wire that is dropped or carries another micro-batch's
# gradient puts every stage upstream of it at 1 or more (1.0-2.0 measured
# with such faults injected, ResNet-v2 d20 and AmoebaNet-D 3L/32F on the
# CPU); f32 rounding alone gave at most 5.3e-3 there. A per-leaf gate cannot
# be set: leaves whose f32 gradient is mostly rounding differ by up to 1.9 of
# their own size where the stage differs by 6e-6.
PP_LR = 0.001
PP_GRAD_TOL = 0.05
PP_SCHED_RTOL = 1e-5
PP_PATHS = {f"{m}_pp_{s}": (m, s) for m in ("amoebanet", "resnet") for s in PP_SCHEDULES}
PATH_KERNELS.update({path: _MODEL_KERNELS[m] for path, (m, _) in PP_PATHS.items()})
STEPS_IN_RUN.update(dict.fromkeys(PP_PATHS, PP_STEPS - 1))
# AmoebaNet-D's depth in phase p, in q3's SP+LP twin and in g3's GEMS twins
# (18L before phase g came; cut to keep the whole script inside its time
# limit). A twin run's rank draws the whole model on the host, which took
# 9-23 s of its set-up at 18L on an H100's host. q2's and g2's f32 gates
# take it too (18L before the serving phases r4-r7 came: the whole script
# took 1109.2 s of its 1200 on a slow card with them at 18L).
# 6L before the analyzers came, when the whole script took 1195-1246 s of
# its 1200 on a slow card.
PIPE_LAYERS = 3
# ResNet-v2's depth in phases p, q and g, their f32 gates and their twins
# (``MPI4DL_TPU_RESNET_N``; 9n+2 layers): 110 (n 12, phase c's) until then.
# Phases c and s and the serving phases keep ResNet-110, at the same widths.
PIPE_RESNET_N = 4
PIPE_RESNET_DEPTH = 9 * PIPE_RESNET_N + 2
# The AmoebaNet-D depth of a path where it is not ``LAYERS`` (phase h's MFU).
PATH_LAYERS = {path: PIPE_LAYERS for path in (
    "amoebanet_pp_gpipe", "amoebanet_pp_1f1b", "amoebanet_sp_lp", "amoebanet_gems",
    "amoebanet_gems_sp")}
PATH_LAYERS.update(dict.fromkeys(("amoebanet_sp", "amoebanet_sp_d2", "amoebanet_sp_dec"),
                                 SP_LAYERS))
# The ResNet-v2 depth of a path where it is not ``RESNET_DEPTH`` (phase h's).
PATH_DEPTH = dict.fromkeys(("resnet_pp_gpipe", "resnet_pp_1f1b", "resnet_sp_lp",
                            "resnet_local_dp", "resnet_gems", "resnet_gems_sp"),
                           PIPE_RESNET_DEPTH)
# The path whose slice ported each kernel: a kernels row's ``launches`` is
# that path's count per step (``launches_per_step`` gives every path's).
HOME_PATH = {"pool_bwd": "amoebanet", "dot1x1_bwd": "amoebanet", "wgrad": "resnet",
             "halo_swap": "resnet_sp"}
# The shapes each kernel is timed at: the largest of the main paths.
K1_TIMED = ((2, 512, 512, 208), 3, 3, 2, 2, 1, 1)
# K1's other forms, checked after the main-path shapes, with x aligned and
# one element off a 16-byte boundary (one element a thread): tiles that do
# not divide the image, C not a multiple of 8, pixels no window covers, and
# geometries the kernel takes only at run time.
K1_EDGE = [
    ((2, 37, 45, 208), 3, 3, 1, 1, 1, 1), ((1, 67, 41, 52), 3, 3, 1, 1, 1, 1),
    ((2, 34, 30, 24), 3, 3, 2, 2, 1, 1), ((2, 33, 35, 64), 3, 3, 2, 2, 1, 1),
    ((1, 21, 23, 40), 2, 2, 2, 2, 0, 0), ((1, 19, 20, 24), 3, 3, 3, 3, 0, 0),
    ((1, 20, 18, 20), 3, 3, 3, 3, 1, 1), ((1, 17, 19, 16), 3, 2, 1, 2, 1, 0),
]
K2_TIMED = ((2, 1024, 1024, 64), 16, 3, 3, 1, 1)
K3_TIMED = ((2, 512, 512, 104), 208)


# Where the script's seconds went: [tag, seconds] in order, a tag's time
# running from its first line to the next tag's first line.
_PHASE_SECONDS: list = []
_PHASE_AT = [None]


def log(*args):
    text = " ".join(str(a) for a in args)
    if text.startswith("[") and "]" in text:
        tag, now = text[1:text.index("]")], time.time()
        if _PHASE_AT[0] is not None:
            _PHASE_SECONDS[-1][1] += now - _PHASE_AT[0]
        if not _PHASE_SECONDS or _PHASE_SECONDS[-1][0] != tag:
            _PHASE_SECONDS.append([tag, 0.0])
        _PHASE_AT[0] = now
    print(*args, flush=True)


def phase_seconds() -> str:
    """Each phase tag's seconds, in the order the tags first ran (a tag
    that ran in several stretches sums them)."""
    if _PHASE_AT[0] is not None and _PHASE_SECONDS:
        _PHASE_SECONDS[-1][1] += time.time() - _PHASE_AT[0]
        _PHASE_AT[0] = time.time()
    total: dict = {}
    for tag, sec in _PHASE_SECONDS:
        total[tag] = total.get(tag, 0.0) + sec
    return ", ".join(f"{tag} {sec:.1f}" for tag, sec in total.items())


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> float:
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / max(scale, 1e-30)


# The seed's parameter values by model signature, in this process
# (:func:`_seeded`).
_SEED_VALUES = {}


def _seeded(model):
    """``weights.init(model)`` from ``SEED``: the same values, drawn once in
    this process for each signature (the sequence of initialized modules'
    types and parameter shapes, which alone set what ``init`` draws) and
    copied after that. A rank builds the same model several times, and a
    draw of AmoebaNet-D 18L's 312M parameters takes seconds."""
    import torch

    from mpi4dl_tpu_torch.weights import _OWN_INIT, init

    mods = [m for m in model.modules() if isinstance(m, _OWN_INIT)]
    key = tuple((type(m), tuple((tuple(p.shape), p.dtype) for p in m.parameters()))
                for m in mods)
    values = _SEED_VALUES.get(key)
    if values is None:
        init(model, torch.Generator().manual_seed(SEED))
        _SEED_VALUES[key] = [[p.detach().clone() for p in m.parameters()] for m in mods]
        return model
    with torch.no_grad():
        for m, vals in zip(mods, values):
            for p, v in zip(m.parameters(), vals):
                p.copy_(v)
    return model


def phase_build():
    from mpi4dl_tpu_torch.ops import _build

    t0 = time.time()
    reports = _build.build_all()
    log(f"[a] built {', '.join(_build.SOURCES)} for sm_90a in {time.time() - t0:.1f} s")
    for name in _build.SOURCES:
        if name not in reports:
            log(f"[a]   {name}: current build reused, no ptxas report")
        for fn, info in reports.get(name, {}).items():
            log(f"[a]   {name} {fn}: {info}")


def small_models():
    """(name, builder, image size) of the small f32 references."""
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2

    return [
        ("AmoebaNet-D 3L/32F @64 bs2", lambda: amoebanetd(10, 3, 32), 64),
        ("ResNet-v2 depth 20 @32 bs2", lambda: get_resnet_v2(20, 10, pool_kernel=8), 32),
    ]


def small_batch(size):
    """The small references' batch, from the seed with numpy."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    return (rng.standard_normal((2, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, size=(2,)))


def small_step(build, size, device, **trainer_kwargs):
    """(loss, per-cell gradients) of one f32 step of a small model with
    weights from the seed (``build`` may take a grid: see phase s1)."""
    import torch

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import flax_arrays

    x, y = small_batch(size)
    model = _seeded(build())
    cfg = ParallelConfig(batch_size=2, image_size=size, **trainer_kwargs.pop("config", {}))
    trainer = Trainer(model, cfg, learning_rate=0.1, device=device, **trainer_kwargs)
    out = trainer.train_step(x, y)
    return float(out["loss"]), [flax_arrays(c, grads=True) for c in trainer.model]


def check_small(name, got, want, tol=SMALL_GRAD_TOL, loss_rtol=1e-4):
    """Hold a small model's (loss, gradients) to a reference run's (the
    CPU's, unless phase m2's): loss within ``loss_rtol``, gradients
    per-leaf normalised within ``tol``. Returns the worst normalised
    error."""
    import numpy as np

    (l_got, g_got), (l_want, g_want) = got, want
    if not abs(l_got - l_want) <= loss_rtol * abs(l_want):
        raise AssertionError(f"{name} loss: {l_got} vs reference {l_want} (rtol {loss_rtol:g})")
    worst, leaf = _worst_leaf(name, g_got, g_want)
    if worst > tol:
        raise AssertionError(f"{name} gradients: normalised max |err| {worst:.3g} at {leaf} "
                             f"(tolerance {tol:g})")
    return worst


def _worst_leaf(name, g_got, g_want):
    """The largest per-leaf normalised gradient error (max |err| / max |ref|
    of the leaf) and its ``cell <i> <name>``; a leaf whose reference is 0
    (under ``ZERO_GRAD`` of its cell's largest) must be 0 in both."""
    import numpy as np

    worst, leaf = 0.0, None
    for i, (gg, gc) in enumerate(zip(g_got, g_want)):
        if not gc:  # a cell without parameters (a D2 HaloExchange)
            continue
        cell = max(float(np.abs(v).max()) for v in gc.values())
        for k in gc:
            scale = float(np.abs(gc[k]).max())
            if scale < ZERO_GRAD * cell:
                # A conv bias that reaches the loss only through batch-stat
                # BN: its exact gradient is 0 and both runs give f32 noise.
                if not float(np.abs(gg[k]).max()) < ZERO_GRAD * cell:
                    raise AssertionError(f"{name} {k}: gradient should be 0")
                continue
            err = float(np.abs(gg[k] - gc[k]).max()) / scale
            if err >= worst:
                worst, leaf = err, f"cell {i} {k}"
    return worst, leaf


def phase_small_reference(name, build, size):
    """One f32 training step of a small model on the card vs the CPU; then
    the same step on the card under ``MPI4DL_TPU_BN_BWD=fused`` against the
    default (``xla``) one: loss bit-equal, each gradient within
    ``BN_BWD_ATOL + BN_BWD_RTOL`` x its leaf's max."""
    import numpy as np

    got, want = small_step(build, size, DEVICE), small_step(build, size, "cpu")
    worst = check_small(name, got, want)
    log(f"[b] small reference {name} f32: loss card {got[0]:.6f} CPU {want[0]:.6f}; "
        f"gradients normalised max|err| {worst:.2e} (tolerance {SMALL_GRAD_TOL:g})")
    with _env(BN_FUSED):
        fused = small_step(build, size, DEVICE)
    if fused[0] != got[0]:
        raise AssertionError(f"{name} under {BN_FUSED}: loss {fused[0]!r} against the default "
                             f"backward's {got[0]!r} (must be bit-equal: the same forward)")
    worst = 0.0
    for i, (gf, gx) in enumerate(zip(fused[1], got[1])):
        for k in gx:
            scale = float(np.abs(gx[k]).max())
            err = float(np.abs(gf[k] - gx[k]).max())
            if err > BN_BWD_ATOL + BN_BWD_RTOL * scale:
                raise AssertionError(f"{name} under {BN_FUSED}: cell {i} {k} gradient max|err| "
                                     f"{err:.3g} against the default backward's (leaf max "
                                     f"{scale:.3g}; rtol {BN_BWD_RTOL:g}, atol {BN_BWD_ATOL:g})")
            worst = max(worst, err / (BN_BWD_ATOL + BN_BWD_RTOL * scale))
    log(f"[b] {name} f32 under MPI4DL_TPU_BN_BWD=fused: loss {fused[0]:.6f} bit-equal to the "
        f"default backward's; gradients' worst leaf at {worst:.3f} of its tolerance "
        f"(atol {BN_BWD_ATOL:g} + rtol {BN_BWD_RTOL:g} x the leaf's max)")


def _on_meta(args) -> bool:
    """Whether a call is on meta tensors: a shape walk (the Trainer's slot
    sizing, the scan planner), which launches nothing."""
    return any(getattr(a, "is_meta", False) for a in args)


def _recording(module, name, key, sink):
    """Wrap ``module.name`` so each call that is not on meta tensors counts
    ``key(*args, **kwargs)`` in the Counter ``sink``; returns the function
    that restores the original."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        if not _on_meta(args):
            sink[key(*args, **kwargs)] += 1
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def _counters():
    from mpi4dl_tpu_torch.ops import dot1x1_kernel, halo_kernel, pool_kernel, wgrad_kernel

    return {"pool_bwd": pool_kernel, "wgrad": wgrad_kernel, "dot1x1_bwd": dot1x1_kernel,
            "halo_swap": halo_kernel}


def _new_calls():
    """Per kernel, a Counter of call shape -> calls (one recorded step)."""
    return {name: collections.Counter() for name in KERNELS}


def _record_shapes(shapes):
    """Count the call shapes of K1, K2, K3 and K4 (for K4, the halo
    exchanges, whose axis phases it runs) into ``shapes`` (from
    :func:`_new_calls`); returns the functions that restore the originals."""
    from mpi4dl_tpu_torch.ops import fastconv, pool_kernel
    from mpi4dl_tpu_torch.parallel import halo

    return [
        _recording(pool_kernel, "pool_bwd",
                   lambda x, dy, *geom: (tuple(x.shape),) + geom, shapes["pool_bwd"]),
        _recording(fastconv, "wgrad",
                   lambda x, dy, *geom: (tuple(x.shape), dy.shape[3]) + geom, shapes["wgrad"]),
        _recording(fastconv, "bwd_1x1",
                   lambda x, dy, w2: (tuple(x.shape), w2.shape[1]), shapes["dot1x1_bwd"]),
        _recording(halo, "halo_exchange", _exchange_key, shapes["halo_swap"]),
    ]


def _record_k1_layout(counts, copies):
    """Count into the Counter ``counts``, per K1 call through ``MaxPool``,
    whether its x and dy already lie channels_last (the kernel reads them in
    place) or are copied first, and the bytes copied; count each copied
    tensor's (name, dtype, shape, strides, storage offset) into
    ``copies``. Returns the function that restores the original backward."""
    import torch

    from mpi4dl_tpu_torch.ops import pool_kernel

    cls = pool_kernel.MaxPool
    orig = cls.__dict__["backward"]

    def backward(ctx, dy):
        for name, t in (("x", ctx.saved_tensors[0]), ("dy", dy)):
            if t.is_contiguous(memory_format=torch.channels_last):
                counts[f"{name} in place"] += 1
            else:
                counts[f"{name} copied"] += 1
                counts[f"{name} bytes copied"] += t.numel() * t.element_size()
                copies[(name, str(t.dtype), tuple(t.shape), t.stride(), t.storage_offset())] += 1
        return orig.__func__(ctx, dy)

    cls.backward = staticmethod(backward)
    return lambda: setattr(cls, "backward", orig)


def main_batch(device):
    """The main paths' batch, the same on every path and rank."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    x = torch.randn((BATCH, SIZE, SIZE, 3), generator=gen, device=device).to(torch.bfloat16)
    y = torch.randint(0, 10, (BATCH,), generator=gen, device=device)
    return x, y


def main_models():
    """(path, description, builder taking the compute dtype) of the main
    paths."""
    import torch

    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2

    return [
        ("amoebanet", f"AmoebaNet-D {LAYERS}L/{FILTERS}F @{SIZE} bs{BATCH}",
         lambda dtype: amoebanetd(10, LAYERS, FILTERS, dtype=dtype)),
        ("resnet", f"ResNet-{RESNET_DEPTH} v2 @{SIZE} bs{BATCH}",
         lambda dtype: get_resnet_v2(RESNET_DEPTH, 10, pool_kernel=SIZE // 4, dtype=dtype)),
    ]


@contextlib.contextmanager
def whole_card(device, share=1.0):
    """The block may take ``share`` of the card (all of it by default), not
    only the rank's share (``multihost.card_share``): a reference that one
    rank (or ``1/share`` ranks) runs while its card-mates wait, their caches
    emptied."""
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.parallel.multihost import card_share

    share = card_share(dist.get_world_size(), torch.cuda.device_count())
    if device.type != "cuda" or share is None:
        yield
        return
    torch.cuda.set_per_process_memory_fraction(share, device)
    try:
        yield
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(share, device)


def f32_first_loss(model, device, config=None, grads=False, **trainer_kwargs):
    """The loss of a main path's first step with f32 compute (TF32 off):
    the seed's weights and the main batch, as the bf16 path's first step,
    without bf16's rounding. ``config``: extra ``ParallelConfig`` fields.
    ``grads``: return ``(loss, {parameter name: gradient})``."""
    import torch

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.train import Trainer

    _seeded(model)
    cfg = ParallelConfig(batch_size=BATCH, image_size=SIZE, **(config or {}))
    trainer = Trainer(model, cfg, learning_rate=0.0, device=device, **trainer_kwargs)
    x, y = main_batch(device)
    loss = float(trainer.train_step(x.float(), y)["loss"])
    got = {n: p.grad for n, p in trainer.model.named_parameters()} if grads else None
    del trainer, model, x, y
    gc.collect()  # the trainer's reference cycles, before the cache is returned
    torch.cuda.empty_cache()
    return (loss, got) if grads else loss


def phase_main(path, desc, build, shapes, profile=False, ledger=None):
    """Train one main path; returns its launches in the timed steps, its
    first step's loss in bf16 and f32 (:func:`f32_first_loss`), the layout
    copies in front of K1 in its first step (see :func:`_record_k1_layout`)
    and its img/s, and counts the kernels' call shapes of its first step
    into ``shapes`` (from :func:`_new_calls`). With a ``ledger``, one more
    step records its peak there (``Trainer.record_memory_footprint``, as
    ``<path>_train_step``) for phase n7."""
    import torch

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import meta_built

    t0 = time.time()
    model = _seeded(meta_built(build, torch.bfloat16))
    n_params = sum(p.numel() for p in model.parameters())
    cfg = ParallelConfig(batch_size=BATCH, image_size=SIZE)
    trainer = Trainer(model, cfg, learning_rate=0.001, momentum=0.9, device=DEVICE)
    x, y = main_batch(DEVICE)
    log(f"[c] {desc} bf16 compute, f32 params ({n_params} params), remat=False; "
        f"set-up {time.time() - t0:.1f} s")
    first_loss = None
    warm_losses = []
    k1_layout, k1_copies = collections.Counter(), collections.Counter()
    for i in range(WARMUP):
        restore = []
        if i == 0:
            restore = _record_shapes(shapes) + [_record_k1_layout(k1_layout, k1_copies)]
        t = time.time()
        loss = float(trainer.train_step(x, y)["loss"])
        for undo in restore:
            undo()
        first_loss = loss if first_loss is None else first_loss
        warm_losses.append(loss)
        if i == 0:  # the first step's gradients, against the f32 step's (phase_bn_fused),
            # held on the host so that the device's peak memory stays the step's own
            first_grads = {n: p.grad.cpu() for n, p in trainer.model.named_parameters()}
        log(f"[c] warm-up step {i}: loss {loss:.4f} ({time.time() - t:.2f} s)")
    if k1_layout:
        log(f"[c] K1 inputs in warm-up step 0 (channels_last in place, or copied first): "
            f"{dict(sorted(k1_layout.items()))}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for mod in counters.values():
        mod.launch_count = 0
    times, losses = [], []
    for _ in range(STEPS):
        t = time.perf_counter()
        losses.append(float(trainer.train_step(x, y)["loss"]))
        times.append(time.perf_counter() - t)
    launches = {name: mod.launch_count for name, mod in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{desc}: non-finite loss: {losses}")
    for name in PATH_KERNELS[path]:
        n = launches[name]
        if n == 0 or n % STEPS:
            raise AssertionError(f"{desc}: kernel {name} launched {n} times in {STEPS} steps")
    if profile:
        profile_step(trainer, x, y)
    if ledger is not None:
        entry = trainer.record_memory_footprint(x, y, ledger=ledger,
                                                program=f"{path}_train_step")
        log(f"[c] Trainer.record_memory_footprint: {entry['program']} peak "
            f"{entry['peak_bytes'] / 2**30:.2f} GiB (one more step, measure_peak)")
    ms = sorted(times)[len(times) // 2] * 1e3
    log(f"[c] losses {['%.4f' % v for v in losses]}")
    log(f"[c] step time median {ms:.1f} ms (all: {[round(t * 1e3, 1) for t in times]}), "
        f"{BATCH / (ms / 1e3):.3f} img/s, peak memory allocated {peak / 2**30:.2f} GiB")
    log(f"[c] launches per step: " + ", ".join(
        f"{name} {launches[name] // STEPS}" for name in counters))
    del trainer, model, x, y
    gc.collect()  # trainers hold reference cycles
    torch.cuda.empty_cache()
    f32_loss, f32_grads = f32_first_loss(meta_built(build, torch.float32), DEVICE, grads=True)
    f32_grads = {n: g.cpu() for n, g in f32_grads.items()}
    gc.collect()
    torch.cuda.empty_cache()
    phase_bn_fused(path, desc, build, warm_losses, _median_leaf_error(first_grads, f32_grads),
                   f32_grads, launches, peak)
    del first_grads, f32_grads
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[c] first step loss with f32 compute (TF32 off, same weights and batch): "
        f"{f32_loss:.6f} (bf16 {first_loss:.6f})")
    return launches, (first_loss, f32_loss), k1_copies, BATCH / (ms / 1e3)


def phase_bn_fused(path, desc, build, xla_losses, xla_dist, f32_grads, xla_launches, xla_peak):
    """A main path under ``MPI4DL_TPU_BN_BWD=fused``: a fresh trainer from
    the seed takes the first two steps. The first loss must be bit-equal to
    the default backward's warm-up step 0, the first step's gradients no
    farther from the f32 step's (``f32_grads``) than ``GRAD_DIST_RATIO``
    times the default backward's distance ``xla_dist``, K1-K3 must launch as
    often a step, and ResNet-110's second loss must be within
    ``BN_BWD_LOSS_RTOL`` of the default's. Peak memory over the second step
    is printed beside the default backward's over its timed steps."""
    import torch

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import meta_built

    t0 = time.time()
    with _env(BN_FUSED):
        model = _seeded(meta_built(build, torch.bfloat16))
        trainer = Trainer(model, ParallelConfig(batch_size=BATCH, image_size=SIZE),
                          learning_rate=0.001, momentum=0.9, device=DEVICE)
        x, y = main_batch(DEVICE)
        counters = _counters()
        for mod in counters.values():
            mod.launch_count = 0
        losses = [float(trainer.train_step(x, y)["loss"])]
        dist = _median_leaf_error({n: p.grad.cpu() for n, p in trainer.model.named_parameters()},
                                  f32_grads)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses.append(float(trainer.train_step(x, y)["loss"]))
        peak = torch.cuda.max_memory_allocated()
        launches = {name: mod.launch_count for name, mod in counters.items()}
    del trainer, model, x, y
    gc.collect()
    torch.cuda.empty_cache()
    if losses[0] != xla_losses[0]:
        raise AssertionError(f"{desc} under {BN_FUSED}: first loss {losses[0]!r} against the "
                             f"default backward's {xla_losses[0]!r} (must be bit-equal)")
    if not dist <= GRAD_DIST_RATIO * xla_dist:
        raise AssertionError(f"{desc} under {BN_FUSED}: first-step gradients {dist} from the "
                             f"f32 step's, the default backward's {xla_dist} (at most "
                             f"{GRAD_DIST_RATIO:g}x)")
    rel = abs(losses[1] - xla_losses[1]) / abs(xla_losses[1])
    rtol = BN_BWD_LOSS_RTOL.get(path)
    if rtol is not None and not rel <= rtol:
        raise AssertionError(f"{desc} under {BN_FUSED}: second loss {losses[1]} against "
                             f"{xla_losses[1]} (rtol {rtol:g})")
    for name in PATH_KERNELS[path]:
        if launches[name] != 2 * (xla_launches[name] // STEPS):
            raise AssertionError(f"{desc} under {BN_FUSED}: {name} launched {launches[name]} "
                                 f"times in 2 steps, {xla_launches[name] // STEPS} a step by "
                                 "default")
    log(f"[c] {desc} under MPI4DL_TPU_BN_BWD=fused: first loss {losses[0]:.6f} bit-equal to "
        f"the default backward's; first-step gradients from the f32 step's: median leaf "
        f"{dist:.4f} against the default's {xla_dist:.4f} (at most {GRAD_DIST_RATIO:g}x); "
        f"second loss {losses[1]:.6f} against {xla_losses[1]:.6f}, relative {rel:.2e}"
        + (f" (rtol {rtol:g})" if rtol is not None else " (not gated: see BN_BWD_LOSS_RTOL)")
        + f"; K1-K3 launches a step as the default's; peak memory allocated "
        f"{peak / 2**30:.2f} GiB in its second step against the default backward's "
        f"{xla_peak / 2**30:.2f} GiB in its timed steps; {time.time() - t0:.1f} s")


def profile_step(trainer, x, y, top=15, tag="c", emit=log):
    """One more step under torch.profiler: device time by kernel, the
    K1-K4 shares, the head's avg pool (the step's only ``mean``, forward
    and backward), and the device's idle share of the step's wall time
    (this process's kernels only), written through ``emit``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpi4dl_tpu_torch.profile_step import kernel_of

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        float(trainer.train_step(x, y)["loss"])
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    # NCCL's "nccl:*" ranges on the device timeline span the NCCL kernels
    # inside them: counting both would count that time twice.
    kernels = [e for e in events if getattr(e, "device_time_total", 0) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("nccl:")]
    head_pool = sum(e.device_time_total for e in events if e.key == "aten::mean"
                    or e.key.startswith("autograd::engine::evaluate_function: MeanBackward")) / 1e3
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)

    def total(*names):
        return sum(e.device_time_total for e in kernels if any(n in e.key for n in names)) / 1e3

    def port(kernel):  # by profile_step's kernel symbols
        return sum(e.device_time_total for e in kernels if kernel_of(e.key) == kernel) / 1e3

    busy = total("")
    emit(f"[{tag}] profiled step: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
         f"(idle {100 * (1 - busy / wall_ms):.1f}%), K1 {port('K1 pool_bwd'):.1f} ms, "
         f"K2 {port('K2 wgrad'):.1f} ms, "
         f"K3 {port('K3 dot1x1_bwd'):.1f} ms, "
         f"K4 {port('K4 halo_swap'):.1f} ms, "
         f"NCCL {total('ncclDevKernel'):.1f} ms, slice sums {total('::sum_splits('):.1f} ms, head pool {head_pool:.3f} ms, "
         f"{sum(e.count for e in kernels)} kernel launches")
    for e in kernels[:top]:
        emit(f"[{tag}]   {e.device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:110]}")


def _bench_hooks(path, shapes, launches, losses):
    """The context-manager factories ``bench.train_throughput`` wraps its
    first warm-up step and its timed steps in: the first records the
    kernels' call shapes into ``shapes``; the second zeroes every launch
    count, keeps each timed step's loss in ``losses`` and writes the counts
    into ``launches[path]`` at the end."""
    import contextlib

    from mpi4dl_tpu_torch.train import Trainer

    @contextlib.contextmanager
    def first_step():
        restore = _record_shapes(shapes)
        try:
            yield
        finally:
            for undo in restore:
                undo()

    @contextlib.contextmanager
    def timed_steps():
        orig = Trainer.train_step

        def train_step(self, x, y):
            out = orig(self, x, y)
            losses.append(out["loss"])
            return out

        counters = _counters()
        for mod in counters.values():
            mod.launch_count = 0
        Trainer.train_step = train_step
        try:
            yield
        finally:
            Trainer.train_step = orig
        launches[path] = {name: mod.launch_count for name, mod in counters.items()}

    return first_step, timed_steps


def phase_bench_points(calls, launches):
    """Phase m1: ``python -m mpi4dl_tpu_torch.bench``'s 2048 px training
    points through the function it calls (``bench.measure_amoeba`` and
    ``measure_resnet``), remat=False, WARMUP + BENCH_STEPS steps each. The
    first warm-up counts the kernels' call shapes into ``calls[path]`` (for
    phases d-g); every kernel of the point must launch in its timed steps,
    chunks times as often a step as on phase c's path of the same model."""
    import torch

    from mpi4dl_tpu_torch import bench

    device = torch.device(DEVICE)
    for path, model, size, batch, chunks in BENCH_POINTS:
        calls[path] = _new_calls()
        losses = []
        first_step, timed_steps = _bench_hooks(path, calls[path], launches, losses)
        kw = dict(device=device, steps=BENCH_STEPS, remats=[False], first_step=first_step,
                  timed_steps=timed_steps)
        torch.cuda.empty_cache()
        t0 = time.time()
        if model == "amoebanet":
            entry = bench.measure_amoeba(size, batch, **kw)
        else:
            entry = bench.measure_resnet(size, batch, bench.RESNET_2048_BASELINE, **kw)
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v) for v in losses]
        if len(losses) != BENCH_STEPS or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{path}: timed-step losses {losses}")
        if entry.get("grad_accum", 1) != chunks:
            raise AssertionError(f"{path}: grad_accum {entry.get('grad_accum')}, want {chunks}")
        per_step = {name: n // BENCH_STEPS for name, n in launches[path].items()}
        for name in PATH_KERNELS[path]:
            want = chunks * launches[model][name] // STEPS
            if launches[path][name] != want * BENCH_STEPS:
                raise AssertionError(f"{path}: {name} launched {launches[path][name]} times in "
                                     f"{BENCH_STEPS} steps, want {want} a step")
        t = entry["step_time_s"]
        desc = (f"AmoebaNet-D {LAYERS}L/{FILTERS}F" if model == "amoebanet"
                else f"ResNet-{RESNET_DEPTH} v2")
        if chunks > 1:
            desc += f" as {chunks} bs{batch // chunks} chunks (grad_accum)"
        log(f"[m1] {path}: {desc} @{size} bs{batch}, bf16 compute, f32 params, "
            f"remat={entry['remat']}: {entry['value']:.3f} img/s, step p50 {t['p50']:.4f} s "
            f"(p90 {t['p90']:.4f}, p99 {t['p99']:.4f}), MFU {entry['mfu']}, vs_baseline "
            f"{entry.get('vs_baseline')}, peak memory allocated {peak / 2**30:.2f} GiB; "
            f"losses {['%.4f' % v for v in losses]}; launches per step {per_step}; "
            f"{time.time() - t0:.1f} s in all")
    torch.cuda.empty_cache()


def _remat_step(build, policy, path):
    """Phase m2's run of one policy on a main path: the first step's loss,
    then one more step's time, its K1-K3 launches and the peak memory
    allocated over both."""
    import torch

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import meta_built

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = _seeded(meta_built(build, torch.bfloat16))
    trainer = Trainer(model, ParallelConfig(batch_size=BATCH, image_size=SIZE),
                      learning_rate=0.001, momentum=0.9, device=DEVICE, remat=policy)
    x, y = main_batch(DEVICE)
    first = float(trainer.train_step(x, y)["loss"])
    counters = {name: mod for name, mod in _counters().items() if name in PATH_KERNELS[path]}
    for mod in counters.values():
        mod.launch_count = 0
    t = time.perf_counter()
    loss = float(trainer.train_step(x, y)["loss"])
    ms = (time.perf_counter() - t) * 1e3
    launches = {name: mod.launch_count for name, mod in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if not math.isfinite(loss):
        raise AssertionError(f"{path} remat={policy!r}: second-step loss {loss}")
    grants = {key: {i: round(v / 1e6, 1) for i, v in getattr(trainer, key).items()}
              for key in ("save_grants", "nockpt_grants", "scanq_grant_bytes")
              if getattr(trainer, key)}
    del trainer, model, x, y
    return first, ms, launches, peak, grants


def phase_remat(policies):
    """Phase m2: every ported remat policy at full width on the two main
    paths @1024 bs2, AmoebaNet-D at ``M2_LAYERS`` (the first step's loss
    bit-equal to remat=False's, the
    same K1-K3 launches a step; peak memory and a step's time printed), then
    phase b's small f32 models under each policy against remat=False on
    the card (loss equal, gradients within REMAT_GRAD_TOL). Returns each
    path's remat=False first-step loss and launches."""
    import torch

    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd

    bases = {}
    models = [(path, desc, build) if path != "amoebanet" else (
        path, f"AmoebaNet-D {M2_LAYERS}L/{FILTERS}F @{SIZE} bs{BATCH}",
        lambda dtype: amoebanetd(10, M2_LAYERS, FILTERS, dtype=dtype))
        for path, desc, build in main_models()]
    for path, desc, build in models:
        base = None
        for policy in (False,) + tuple(policies):
            first, ms, launches, peak, _ = _remat_step(build, policy, path)
            if base is None:
                base = bases[path] = first, launches
            elif first != base[0] or launches != base[1]:
                raise AssertionError(
                    f"{desc} remat={policy!r}: first-step loss {first!r} and launches {launches} "
                    f"against remat=False's {base[0]!r} and {base[1]}")
            log(f"[m2] {desc} remat={policy!r}: first-step loss {first:.6f}"
                f"{' (bit-equal to remat=False)' if policy is not False else ''}, "
                f"a step {ms:.1f} ms, peak memory allocated {peak / 2**30:.2f} GiB, "
                f"launches a step {launches}")
    torch.cuda.empty_cache()
    for name, build, size in small_models():
        want = small_step(build, size, DEVICE)
        for policy in policies:
            got = small_step(build, size, DEVICE, remat=policy)
            worst = check_small(f"{name} remat={policy!r}", got, want, tol=REMAT_GRAD_TOL,
                                loss_rtol=0.0)
            log(f"[m2] small {name} f32 on the card, remat={policy!r}: loss {got[0]:.6f} equal "
                f"to remat=False's; gradients normalised max|err| {worst:.2e} (tolerance "
                f"{REMAT_GRAD_TOL:g})")
    return bases


def start_bench_cli():
    """Phase m3, started: ``python -m mpi4dl_tpu_torch.bench`` as a
    subprocess in a session of its own with BENCH_MODEL=amoebanet
    BENCH_STEPS=3 BENCH_TIME_BUDGET=1 BENCH_SERVING=0 BENCH_TILED=0
    BENCH_HLO=0 BENCH_ATTRIBUTION=0 (phase r7 runs the serving extra; the
    analyzers' keys are held on the CPU and phase n traces and lints the
    paths). It runs beside m2 and w1: their gates are exact, and the
    printed step times of all three include the company."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_MODEL="amoebanet", BENCH_STEPS="3", BENCH_TIME_BUDGET="1",
               BENCH_SERVING="0", BENCH_TILED="0", BENCH_HLO="0", BENCH_ATTRIBUTION="0",
               PYTHONPATH=here + os.pathsep + env.get("PYTHONPATH", ""))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", "mpi4dl_tpu_torch.bench"], cwd=here, env=env,
                            stdout=out, stderr=err, text=True, start_new_session=True)
    return proc, out, err, time.time()


def finish_bench_cli(started):
    """Phase m3's gates: every JSON line parses, the last is the headline
    with a value, an MFU and a telemetry snapshot, exit 0. Returns that
    line."""
    proc, out, err, t0 = started
    try:
        rc = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        stop_session(started)
        raise
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    lines = stdout.splitlines()
    records = [json.loads(line) for line in lines if line.startswith("{")]
    if rc != 0 or not records:
        raise AssertionError(f"bench exited {rc} with {len(records)} JSON lines: "
                             f"{stdout[-2000:]} {stderr[-2000:]}")
    last = records[-1]
    if not (last.get("metric") == "amoebanetd_1024px_bs2_train_gpu"
            and (last.get("value") or 0) > 0 and last.get("mfu")):
        raise AssertionError(f"bench's last line: {last}")
    if not (last.get("telemetry") or {}).get("metrics"):
        raise AssertionError(f"bench's last line has no telemetry snapshot: {sorted(last)}")
    for line in lines:
        if not line.startswith("{"):
            log(f"[m3] bench: {line}")
    shown = {k: v for k, v in last.items() if k != "telemetry"}
    log(f"[m3] python -m mpi4dl_tpu_torch.bench (BENCH_MODEL=amoebanet BENCH_STEPS=3 "
        f"BENCH_TIME_BUDGET=1 BENCH_SERVING=0 BENCH_TILED=0 BENCH_HLO=0 BENCH_ATTRIBUTION=0): "
        f"exit 0, {len(records)} JSON line(s) in {time.time() - t0:.1f} s (beside m2 and w1), "
        f"the last: {json.dumps(shown)} (and a telemetry snapshot of "
        f"{len(last['telemetry']['metrics'])} metrics)")
    return last


def _env(values):
    """A context manager that sets the environment variables ``values`` for
    its block and restores what was there before."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        before = {k: os.environ.get(k) for k in values}
        os.environ.update(values)
        try:
            yield
        finally:
            for k, v in before.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    return scope()


def _variant(policy, env):
    return f"remat={policy!r}" + "".join(f" {k}={v}" for k, v in env.items())


def walk_small_models():
    """Phase b's small f32 models and ResNet-v1 depth 44 @32 bs2, whose
    planned runs of 6 cells take scan2's chunks and scanq's sweep."""
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1

    return small_models() + [("ResNet-v1 depth 44 @32 bs2",
                              lambda: get_resnet_v1(44, 10, pool_kernel=8), 32)]


def phase_walk_policies(base):
    """Phase w1: ResNet-110 v2 @1024 bs2 under each of ``WALK_VARIANTS``
    (a remat policy and its budgets): the first step's loss bit-equal to
    remat=False's and K2/K3 launching as often a step (``base``: phase m2's
    remat=False first loss and launches); peak memory, a step's time and
    the budgets' grants printed. Then the small f32 models under each
    variant on the card against remat=False (loss equal, gradients within
    ``REMAT_GRAD_TOL``)."""
    import torch

    desc, build = next((d, b) for p, d, b in main_models() if p == "resnet")
    for policy, env in WALK_VARIANTS:
        with _env(env):
            first, ms, launches, peak, grants = _remat_step(build, policy, "resnet")
        if first != base[0] or launches != base[1]:
            raise AssertionError(
                f"{desc} {_variant(policy, env)}: first-step loss {first!r} and launches "
                f"{launches} against remat=False's {base[0]!r} and {base[1]}")
        log(f"[w1] {desc} {_variant(policy, env)}: first-step loss {first:.6f} (bit-equal to "
            f"remat=False), a step {ms:.1f} ms, peak memory allocated {peak / 2**30:.2f} GiB, "
            f"launches a step {launches}; grants {grants}")
    torch.cuda.empty_cache()
    for name, build, size in walk_small_models():
        want = small_step(build, size, DEVICE)
        for policy, env in WALK_VARIANTS:
            with _env(env):
                got = small_step(build, size, DEVICE, remat=policy)
            worst = check_small(f"{name} {_variant(policy, env)}", got, want,
                                tol=REMAT_GRAD_TOL, loss_rtol=0.0)
            log(f"[w1] small {name} f32 on the card, {_variant(policy, env)}: loss "
                f"{got[0]:.6f} equal to remat=False's; gradients normalised max|err| "
                f"{worst:.2e} (tolerance {REMAT_GRAD_TOL:g})")


def phase_walk_steps(calls, launches):
    """Phase w2: the walk's steps past what remat=False fits, ResNet-110 v2
    bs1 bf16: @3072 under scanlog and @4096 under scanq (with the bench's
    store budget), one step each. The step records the kernels' call
    shapes into ``calls[path]``; every count is set to 0 just before it
    and read just after it, and K2 and K3 must launch as often as on phase
    c's ResNet-110 path a step; peak memory and the step's time printed."""
    import torch

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.train import Trainer

    for path, size, policy, env in WALK_POINTS:
        calls[path] = _new_calls()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _env(env):
            model = _seeded(get_resnet_v2(RESNET_DEPTH, 10, pool_kernel=size // 4,
                                       dtype=torch.bfloat16))
            trainer = Trainer(model, ParallelConfig(batch_size=1, image_size=size),
                              learning_rate=0.001, momentum=0.9, device=DEVICE, remat=policy)
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
            x = torch.randn((1, size, size, 3), generator=gen, device=DEVICE).to(torch.bfloat16)
            y = torch.randint(0, 10, (1,), generator=gen, device=DEVICE)
            counters = _counters()
            restore = _record_shapes(calls[path])
            for mod in counters.values():
                mod.launch_count = 0
            t = time.perf_counter()
            try:
                loss = float(trainer.train_step(x, y)["loss"])
            finally:
                for undo in restore:
                    undo()
            step_s = time.perf_counter() - t
            launches[path] = {name: mod.launch_count for name, mod in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        if not math.isfinite(loss):
            raise AssertionError(f"{path}: loss {loss}")
        for name in PATH_KERNELS[path]:
            want = launches["resnet"][name] // STEPS
            if launches[path][name] != want:
                raise AssertionError(f"{path}: {name} launched {launches[path][name]} times in "
                                     f"a step, want {want} (phase c's ResNet-110 a step)")
        log(f"[w2] {path}: ResNet-{RESNET_DEPTH} v2 @{size} bs1, bf16 compute, f32 params, "
            f"{_variant(policy, env)}: loss {loss:.4f}; the first step {step_s:.2f} s (its "
            f"set-up included: a cold step, not a throughput); peak memory allocated "
            f"{peak / 2**30:.2f} GiB; scanq store grants {trainer.scanq_grant_bytes}; launches "
            f"a step {launches[path]}")
        del trainer, model, x, y
        gc.collect()  # trainers hold reference cycles
    torch.cuda.empty_cache()


def walk_large_shapes(calls):
    """Phase w3's shapes: K1 at AmoebaNet-D 18L/416F @4096 bs1's (phase
    m1's @2048 bs1 call shapes with H and W doubled: the model is fully
    convolutional), K2 and K3 at ResNet-110's stage-0 shapes @8192 bs1
    (every tensor past 2^31 elements or bytes)."""
    k1 = sorted({((b, 2 * h, 2 * w, c),) + tuple(geom)
                 for (b, h, w, c), *geom in calls["amoebanet_2048_bs1"]["pool_bwd"]})
    k2 = [((1, 8192, 8192, 3), 16, 3, 3, 1, 1), ((1, 8192, 8192, 16), 16, 3, 3, 1, 1),
          ((1, 8192, 8192, 64), 16, 3, 3, 1, 1)]
    k3 = [((1, 8192, 8192, 16), 64)]
    return {"pool_bwd": k1, "wgrad": k2, "dot1x1_bwd": k3}


def dw_f64(x, dy, kh, kw, ph, pw, band=512):
    """K2's dw (and K3's, as 1x1) summed in float64 over bands of ``band``
    output rows: the exact sum of the bf16 products, to the last f32 bit.
    At 8192 px a dw entry sums 2^26 products, and the f32 plain version's
    own rounding comes within a factor of the gate."""
    import torch
    import torch.nn.functional as F

    c, o = x.shape[3], dy.shape[3]
    h, ho, wo = x.shape[1], dy.shape[1], dy.shape[2]
    dw = torch.zeros((kh, kw, c, o), dtype=torch.float64, device=x.device)
    for r0 in range(0, ho, band):
        r1 = min(r0 + band, ho)
        lo, hi = r0 - ph, r1 + kh - 1 - ph  # the x rows the band's outputs read
        xb = F.pad(x[:, max(lo, 0):min(hi, h)].double(),
                   (0, 0, pw, pw, max(-lo, 0), max(hi - h, 0)))
        dyb = dy[:, r0:r1].reshape(-1, o).double()
        for u in range(kh):
            for v in range(kw):
                dw[u, v] += xb[:, u:u + r1 - r0, v:v + wo, :].reshape(-1, c).t() @ dyb
        del xb, dyb
    return dw


def rel_err64(got, want) -> float:
    """:func:`rel_err` in float64 (for a float64 reference)."""
    scale = float(want.double().abs().max())
    return float((got.double() - want.double()).abs().max()) / max(scale, 1e-300)


def phase_walk_large(gen, calls):
    """Phase w3: K1, K2 and K3 against their plain versions at
    :func:`walk_large_shapes`, bf16 (K1 exact on tie-heavy integers; K2's
    dw and K3's dx and dw within the tolerances of phases e-f), then each
    timed beside its library call and its bound. K2's and K3's dw are
    held against :func:`dw_f64`; their errors against the f32 plain
    version, and that version's own error, are printed beside it. (Phases
    d-g cover the ResNet-110 @3072 and @4096 shapes phase w2 recorded.)"""
    import torch

    from mpi4dl_tpu_torch.ops import dot1x1_kernel, pool_kernel, wgrad_kernel

    shapes = walk_large_shapes(calls)
    for shape, kh, kw, sh, sw, ph, pw in shapes["pool_bwd"]:
        b, h, w, c = shape
        ho, wo = pool_kernel.out_size(h, kh, sh, ph), pool_kernel.out_size(w, kw, sw, pw)
        x = torch.randint(0, 3, shape, generator=gen, device=DEVICE).to(torch.bfloat16)
        dy = torch.randint(-64, 64, (b, ho, wo, c), generator=gen, device=DEVICE)
        dy = dy.to(torch.bfloat16)
        got = pool_kernel.pool_bwd(x, dy, kh, kw, sh, sw, ph, pw)
        want = pool_kernel.pool_bwd_reference(x, dy, kh, kw, sh, sw, ph, pw)
        if not torch.equal(got, want):
            err = float((got.float() - want.float()).abs().max())
            raise AssertionError(f"K1 x{list(shape)} {kh}x{kw} s({sh},{sw}) p({ph},{pw}): "
                                 f"max |err| {err}")
        log(f"[w3] K1 x{list(shape)} {kh}x{kw} s({sh},{sw}) p({ph},{pw}) bf16: equal to the "
            f"plain version (tie-heavy ints)")
        del x, dy, got, want
    for (b, h, w, c), o, kh, kw, ph, pw in shapes["wgrad"]:
        x = torch.randn((b, h, w, c), generator=gen, device=DEVICE).to(torch.bfloat16)
        dy = torch.randn((b, h, w, o), generator=gen, device=DEVICE).to(torch.bfloat16)
        dw = wgrad_kernel.wgrad(x, dy, kh, kw, ph, pw)
        ref32 = wgrad_kernel.wgrad_reference(x, dy, kh, kw, ph, pw)
        ref64 = dw_f64(x, dy, kh, kw, ph, pw)
        err, err32, ref_err = rel_err64(dw, ref64), rel_err(dw, ref32), rel_err64(ref32, ref64)
        if not err <= DW_TOL:
            raise AssertionError(f"K2 x[{b},{h},{w},{c}]->{o} bf16: max|err|/max|ref| "
                                 f"{err:.3g} against float64 (tolerance {DW_TOL})")
        log(f"[w3] K2 x[{b},{h},{w},{c}]->{o} {kh}x{kw} p({ph},{pw}) bf16 ({x.numel()} "
            f"elements, {x.numel() * 2} bytes): max|err|/max|ref| {err:.2e} against float64 "
            f"(tolerance {DW_TOL}); {err32:.2e} against the f32 plain version, whose own is "
            f"{ref_err:.2e}")
        del x, dy, dw, ref32, ref64
        torch.cuda.empty_cache()
    for (b, h, w, c), o in shapes["dot1x1_bwd"]:
        x = torch.randn((b, h, w, c), generator=gen, device=DEVICE).to(torch.bfloat16)
        dy = torch.randn((b, h, w, o), generator=gen, device=DEVICE).to(torch.bfloat16)
        w2 = (torch.randn((c, o), generator=gen, device=DEVICE) / c**0.5).to(torch.bfloat16)
        dx, dw = dot1x1_kernel.bwd_1x1(x, dy, w2)
        rdx, rdw = dot1x1_kernel.bwd_1x1_reference(x, dy, w2)
        rdw64 = dw_f64(x, dy, 1, 1, 0, 0).view(rdw.shape)
        e_dx, e_dw = rel_err(dx, rdx), rel_err64(dw, rdw64)
        e_dw32, ref_err = rel_err(dw, rdw), rel_err64(rdw, rdw64)
        if not (e_dx <= K3_DX_TOL["bfloat16"] and e_dw <= DW_TOL):
            raise AssertionError(f"K3 x[{b},{h},{w},{c}]->{o} bf16: dx {e_dx:.3g}, dw {e_dw:.3g} "
                                 f"against float64")
        log(f"[w3] K3 x[{b},{h},{w},{c}]->{o} bf16 (dy {dy.numel()} elements): max|err|/max|ref| "
            f"dx {e_dx:.1e}, dw {e_dw:.2e} against float64 (tolerances "
            f"{K3_DX_TOL['bfloat16']}, {DW_TOL}); dw {e_dw32:.2e} against the f32 plain "
            f"version, whose own is {ref_err:.2e}")
        del x, dy, w2, dx, dw, rdx, rdw, rdw64
        torch.cuda.empty_cache()
    for name, make in (("pool_bwd", _k1_case), ("wgrad", _k2_case), ("dot1x1_bwd", _k3_case)):
        for shape in shapes[name]:
            case = make(gen, shape)
            ms, lib = cuda_ms(case["kernel"], iters=3), cuda_ms(case["library"], iters=3)
            log(f"[w3] {name} {case['desc']}: kernel {ms:.4f} ms, library {lib:.4f} ms, bound "
                f"{case['bound']['bound_ms']:.4f} ms ({case['bound']['bound_by']})")
            del case
            torch.cuda.empty_cache()


# -- phase v: eval, checkpoints and data --------------------------------------

def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_convergence(calls, launches):
    """Phase v1: ``python -m mpi4dl_tpu_torch.convergence_run`` at its
    defaults as a subprocess, in a temporary directory: phase A ends by
    SIGKILL after the checkpoint at step 150, phase B resumes and exits 0,
    all three checks hold (exit 0), and K2 and K3 launch in both phases.
    Adds its launches as the path ``convergence``; one more step of its
    model in this process records the kernels' call shapes into
    ``calls["convergence"]`` (phases d-g gate and time them), and its
    launches must equal the run's per step."""
    from mpi4dl_tpu_torch import convergence_run
    from mpi4dl_tpu_torch.data import ClassPatternImages
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory(prefix="mpi4dl-convergence-") as tmp:
        t0 = time.time()
        out = subprocess.run(
            [sys.executable, "-m", "mpi4dl_tpu_torch.convergence_run", "--device", DEVICE,
             "--workdir", tmp, "--out", os.path.join(tmp, "convergence.json")],
            cwd=here, env=env, capture_output=True, text=True, timeout=900)
        wall = time.time() - t0
        if out.returncode != 0:
            raise AssertionError(f"convergence_run exited {out.returncode}: "
                                 f"{out.stdout[-2000:]} {out.stderr[-3000:]}")
        with open(os.path.join(tmp, "convergence.json")) as f:
            art = json.load(f)
    lines = out.stdout.strip().splitlines()
    counts = json.loads(lines[-2])["launches"]
    for phase, c in counts.items():
        for kernel in PATH_KERNELS["convergence"]:
            if not c[kernel] > 0:
                raise AssertionError(f"convergence run {phase}: {kernel} never launched: {c}")
    steps = art["config"]["steps"]
    launches["convergence"] = {k: sum(c[k] for c in counts.values()) for k in KERNELS}
    STEPS_IN_RUN["convergence"] = steps
    log(f"[v1] python -m mpi4dl_tpu_torch.convergence_run ({art['config']['model']} "
        f"@{art['config']['image_size']} bs{art['config']['batch_size']}, lr "
        f"{art['config']['lr']}, {steps} steps, {art['config']['kill']}, "
        f"{art['config']['platform']}): phase A SIGKILLed, phase B exit 0; first loss "
        f"{art['curve'][0]['loss']:.4f}, first-5 mean {art['initial_loss_mean5']}, final-20 "
        f"mean {art['final_loss_mean20']}, final accuracy {art['final_accuracy_mean20']}; "
        f"resume jump {art['resume_jump']} (band {art['resume_band']}); checks {art['checks']}; "
        f"training {art['wall_seconds']} s, {wall:.1f} s in all; {card()}")
    per_step = ", ".join(f"{k} {launches['convergence'][k] / steps:g}"
                         for k in PATH_KERNELS["convergence"])
    log(f"[v1] launches by phase: {json.dumps(counts)} ({per_step} a step)")
    cfg = art["config"]
    depth, size, batch = int(cfg["model"].split("-")[1]), cfg["image_size"], cfg["batch_size"]
    trainer = convergence_run.build_trainer(depth, size, batch, lr=cfg["lr"], device=DEVICE)
    calls["convergence"] = _new_calls()
    restore = _record_shapes(calls["convergence"])
    try:
        trainer.train_step(*ClassPatternImages(batch, size, 10, seed=SEED).batch(0))
    finally:
        for undo in restore:
            undo()
    for kernel in PATH_KERNELS["convergence"]:
        n = sum(calls["convergence"][kernel].values())
        if n * steps != launches["convergence"][kernel]:
            raise AssertionError(f"convergence run: {kernel} {launches['convergence'][kernel]} "
                                 f"launches in {steps} steps, {n} in the recorded step")


def _state_equal(a, b) -> bool:
    """Whether two trainers hold the same params and momentum bit for bit."""
    import torch

    (pa, ma, sa), (pb, mb, sb) = a.state_tensors(), b.state_tensors()
    return sa == sb and all(torch.equal(x[k], y[k]) for x, y in zip(pa + ma, pb + mb) for k in x)


def phase_checkpoint(launches):
    """Phase v2: AmoebaNet-D 18L/416F @1024 bs2 (phase c's model, seed and
    bf16 compute / f32 params) on ``ClassPatternImages(2, 1024, 10,
    seed=SEED)``: two steps, ``save_checkpoint`` with ``model_metadata``,
    ``rebuild_from_checkpoint`` into a fresh model and Trainer (params and
    momentum bit-equal), one more step on both on the same batch (the
    resumed one with K1-K3 at phase c's per-step counts), then calibration
    over 2 batches and eval over 2 more, timed. Then the small f32 models:
    calibration and eval on the card against the CPU."""
    import shutil

    import torch

    from mpi4dl_tpu_torch.checkpoint import model_metadata, rebuild_from_checkpoint, save_checkpoint
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.data import ClassPatternImages
    from mpi4dl_tpu_torch.evaluate import collect_batch_stats, evaluate
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import meta_built

    desc = f"AmoebaNet-D {LAYERS}L/{FILTERS}F @{SIZE} bs{BATCH}"
    ds = ClassPatternImages(BATCH, SIZE, 10, seed=SEED)
    cfg = ParallelConfig(batch_size=BATCH, image_size=SIZE)
    model = _seeded(meta_built(amoebanetd, 10, LAYERS, FILTERS, dtype=torch.bfloat16))
    trainer = Trainer(model, cfg, learning_rate=0.001, momentum=0.9, device=DEVICE)
    losses = [float(trainer.train_step(*ds.batch(i))["loss"]) for i in range(2)]
    tmp = tempfile.mkdtemp(prefix="mpi4dl-ckpt-")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, trainer, metadata=model_metadata(
            "amoebanet", SIZE, num_classes=10, num_layers=LAYERS, num_filters=FILTERS,
            dtype=torch.bfloat16))
        save_s = time.perf_counter() - t0
        nbytes = {f: os.path.getsize(os.path.join(path, f)) for f in sorted(os.listdir(path))}
        t0 = time.perf_counter()
        _, resumed, _, meta = rebuild_from_checkpoint(tmp, device=DEVICE, config=cfg,
                                                      learning_rate=0.001, momentum=0.9)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not (resumed.step == trainer.step == 2 and _state_equal(resumed, trainer)):
        raise AssertionError(f"{desc}: the rebuilt trainer's params / momentum / step differ")
    log(f"[v2] {desc} on ClassPatternImages(seed={SEED}), bf16 compute, f32 params: losses "
        f"{['%.4f' % v for v in losses]}; checkpoint at step 2 {sum(nbytes.values())} bytes "
        f"({nbytes}), save {save_s:.2f} s, rebuild_from_checkpoint on the card {restore_s:.2f} s "
        f"(model {meta['model']}); params, momentum and step bit-equal; {card()}")
    x, y = ds.batch(2)
    loss_a = float(trainer.train_step(x, y)["loss"])
    del trainer, model
    gc.collect()  # trainers hold reference cycles
    torch.cuda.empty_cache()
    counters = _counters()
    for mod in counters.values():
        mod.launch_count = 0
    loss_b = float(resumed.train_step(x, y)["loss"])
    launches["amoebanet_resumed"] = {name: mod.launch_count for name, mod in counters.items()}
    for name in PATH_KERNELS["amoebanet_resumed"]:
        want = launches["amoebanet"][name] // STEPS
        if launches["amoebanet_resumed"][name] != want:
            raise AssertionError(f"{desc} resumed step: {name} launched "
                                 f"{launches['amoebanet_resumed'][name]} times, want {want}")
    diff = abs(loss_a - loss_b)
    if not diff <= RESUME_LOSS_RTOL * abs(loss_a):
        raise AssertionError(f"{desc}: step 3 loss {loss_a} uninterrupted, {loss_b} resumed")
    log(f"[v2] step 3 on the same batch: uninterrupted {loss_a:.6f}, resumed {loss_b:.6f}, "
        f"difference {diff:.3g} ({'bit-equal' if diff == 0 else f'within {RESUME_LOSS_RTOL:g} relative'}); "
        f"resumed step's launches {launches['amoebanet_resumed']}")
    t0 = time.perf_counter()
    cal = [ds.batch(3 + i)[0] for i in range(V_BATCHES)]
    data_s = (time.perf_counter() - t0) / V_BATCHES
    test = [ds.batch(3 + V_BATCHES + i) for i in range(V_BATCHES)]
    collect_batch_stats(resumed, cal[:1])  # warm-up (untimed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = collect_batch_stats(resumed, cal)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    evaluate(resumed, stats, test[:1])  # warm-up (untimed)
    t0 = time.perf_counter()
    res = evaluate(resumed, stats, test)
    eval_s = time.perf_counter() - t0
    if not (math.isfinite(res["loss"]) and 0 <= res["accuracy"] <= 1
            and res["count"] == V_BATCHES * BATCH):
        raise AssertionError(f"{desc} eval: {res}")
    log(f"[v2] ClassPatternImages batch on the host {data_s * 1e3:.1f} ms (not timed below); "
        f"collect_batch_stats over {V_BATCHES} batches {cal_s / V_BATCHES * 1e3:.1f} ms a "
        f"batch; evaluate over {V_BATCHES} {eval_s / V_BATCHES * 1e3:.1f} ms a batch, "
        f"{res['count'] / eval_s:.3f} img/s; eval loss {res['loss']:.4f}, accuracy "
        f"{res['accuracy']:.2f} (random weights after 3 steps); {card()}")
    del resumed, stats
    gc.collect()  # trainers hold reference cycles
    torch.cuda.empty_cache()
    for name, build, size in small_models():
        got, want = small_eval(build, size, DEVICE), small_eval(build, size, "cpu")
        worst = check_small_eval(f"[v2] {name}", got, want, EVAL_STAT_TOL, EVAL_LOSS_RTOL)
        log(f"[v2] small reference {name} f32: calibration + eval loss card "
            f"{got[1]['loss']:.6f} CPU {want[1]['loss']:.6f} (rtol {EVAL_LOSS_RTOL:g}); "
            f"statistics normalised max|err| {worst:.2e} (tolerance {EVAL_STAT_TOL:g})")
    return {"save_s": save_s, "restore_s": restore_s, "bytes": sum(nbytes.values()),
            "cal_ms": cal_s / V_BATCHES * 1e3, "eval_ms": eval_s / V_BATCHES * 1e3}


def eval_batches(size, batch=2):
    """Calibration inputs and eval (x, y) batches of the small references,
    from the seed with numpy."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)
    cal = [rng.standard_normal((batch, size, size, 3)).astype(np.float32)
           for _ in range(V_BATCHES)]
    test = [(rng.standard_normal((batch, size, size, 3)).astype(np.float32),
             rng.integers(0, 10, size=(batch,))) for _ in range(V_BATCHES)]
    return cal, test


def _numpy_stats(tree):
    if isinstance(tree, dict):
        return {k: _numpy_stats(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def small_eval(build, size, device, **trainer_kwargs):
    """(statistics as numpy, eval result) of a small f32 model with weights
    from the seed: calibration and eval through its Trainer (spatial when
    ``trainer_kwargs`` say so: see phase v3)."""
    import torch

    from mpi4dl_tpu_torch import evaluate
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.train import Trainer

    cal, test = eval_batches(size)
    model = _seeded(build())
    cfg = ParallelConfig(batch_size=2, image_size=size, **trainer_kwargs.pop("config", {}))
    trainer = Trainer(model, cfg, device=device, **trainer_kwargs)
    if trainer.n_spatial:
        stats = evaluate.spatial_collect_batch_stats(trainer, cal)
        res = evaluate.spatial_evaluate(trainer, stats, test)
    else:
        stats = evaluate.collect_batch_stats(trainer, cal)
        res = evaluate.evaluate(trainer, stats, test)
    return [_numpy_stats(s) for s in stats], res


def check_small_eval(name, got, want, stat_tol, loss_rtol):
    """Hold (statistics, eval result) to a reference's: every leaf per leaf
    normalised within ``stat_tol``, loss within ``loss_rtol``, accuracy
    equal. Returns the worst normalised statistics error."""
    import numpy as np

    worst = 0.0

    def walk(g, w, path):
        nonlocal worst
        if isinstance(w, dict):
            if set(g) != set(w):
                raise AssertionError(f"{name} statistics {path}: keys {sorted(g)} != {sorted(w)}")
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
        else:
            worst = max(worst, float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30))

    for i, (g, w) in enumerate(zip(got[0], want[0])):
        walk(g, w, str(i))
    if worst > stat_tol:
        raise AssertionError(f"{name} statistics: normalised max|err| {worst:.3g} "
                             f"(tolerance {stat_tol:g})")
    (rg, rw) = got[1], want[1]
    if not (abs(rg["loss"] - rw["loss"]) <= loss_rtol * abs(rw["loss"])
            and rg["accuracy"] == rw["accuracy"] and rg["count"] == rw["count"]):
        raise AssertionError(f"{name} eval: {rg} against {rw} (loss rtol {loss_rtol:g})")
    return worst



def sp_small_models():
    """(name, image size, spatial cells, builder taking the grid (None:
    the plain model)) of phase s1's small references."""
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2

    return [
        # stem + 6 cells on the tiles, the head after the join
        ("ResNet-v2 depth 20 @32 bs2", 32, 7,
         lambda grid: get_resnet_v2(20, 10, spatial_cells=7 if grid else 0, pool_kernel=8,
                                    grid=grid)),
        # stem, 2 reduction cells and a normal cell (its 1x7/7x1 on 8-px tiles)
        ("AmoebaNet-D 3L/32F @128 bs2", 128, 4,
         lambda grid: amoebanetd(10, 3, 32, spatial_cells=4 if grid else 0, grid=grid)),
    ]


def sp_small_d2_models():
    """Phase s7's small references, s1's in their D2 form: (name, image
    size, builder taking the grid (None: the plain twin) and returning
    (model, spatial cells)). Every exchanged extent is at least twice its
    halo. The ResNet is ``tests/test_d2.py``'s front (4 D1 cells on the
    tiles: the stem, stage 0's fused pair on 16-px tiles with halo 4, the
    stride-2 cell): with more cells on the tiles, or at @64, the f32
    single-device step's own gradients move by 1-2% of a leaf between runs
    that only sum in another order (D1 too; float64 runs agree within
    1.2e-7). The AmoebaNet's normal cell runs on 8-px tiles (halo 3)."""
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2_d2
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid

    def resnet(grid):
        cells, plain, n = get_resnet_v2_d2(20, 10, spatial_cells=4, fused_layers=D2_FUSED,
                                           pool_kernel=8, grid=grid or TileGrid(SP_GRID, 0))
        return (cells, n) if grid else (plain, 0)

    return [
        (f"ResNet-v2 D2 depth 20 @32 bs2 (fused_layers {D2_FUSED})", 32, resnet),
        ("AmoebaNet-D D2 3L/32F @128 bs2", 128,
         lambda grid: (amoebanetd(10, 3, 32, spatial_cells=4 if grid else 0, halo_d2=True,
                                  grid=grid), 4 if grid else 0)),
    ]


def _sp_small(grid, device):
    """Phases s1, s7 and s8 in one rank: each small spatial step's (loss,
    gradients): D1, D2, then D1 in the decomposed form."""
    config = dict(spatial_size=1, num_spatial_parts=SP_RANKS)

    def d1():
        return [small_step(lambda: build(grid), size, device, config=config,
                           num_spatial_cells=cells, grid=grid)
                for _, size, cells, build in sp_small_models()]

    d2 = []
    for _, size, build in sp_small_d2_models():
        model, cells = build(grid)
        d2.append(small_step(lambda: model, size, device, config=dict(config, halo_d2=True),
                             num_spatial_cells=cells, grid=grid))
    with _env(DEC_ENV):
        dec = d1()
    return d1(), d2, dec


def _count_calls(cls, name, box):
    """Count calls of the static method ``cls.name`` that are not on meta
    tensors in ``box[0]``; returns the function that restores it."""
    orig = cls.__dict__[name]

    def wrapper(*args):
        if not _on_meta(args):
            box[0] += 1
        return orig.__func__(*args)

    setattr(cls, name, staticmethod(wrapper))
    return lambda: setattr(cls, name, orig)


def _exchange_key(x, halo_h, halo_w, grid, fill_value=0.0, join=True):
    """A ``halo_exchange`` call's shape: (tile shape, strides, halos,
    whether the step differentiates it)."""
    return (tuple(x.shape), x.stride(), halo_h, halo_w, x.requires_grad)


def _exchange_desc(key):
    shape, _, hh, hw, grad = key
    return (f"x[{','.join(map(str, shape))}] h({hh},{hw}) "
            f"{'forward+backward' if grad else 'forward'}")


def _exchange_strips(key):
    """The NHWC (axis, shape, strides) of the strips an exchange at ``key``
    sends: the tile's rows in the H phase, the H-extended tile's columns
    (channels_last) in the W phase."""
    (b, c, h, w), stride, hh, hw, _ = key
    out = []
    if hh:
        out.append(("tile_h", (b, hh, w, c), (stride[0], stride[2], stride[3], stride[1])))
    if hw:
        hx, wx = h + 2 * hh, w + 2 * hw
        out.append(("tile_w", (b, hx, hw, c), (hx * wx * c, wx * c, c, 1)))
    return out


def _exchange_traffic(key, backend):
    """(device-memory bytes, NVLink bytes, axis phases) of one bf16
    exchange at ``key``: the tile read and the extended tile written once
    (the gradient the same way back); each phase's two strips leave over
    NVLink with one rank a card, or are stored and read again on a card
    the ranks share."""
    (b, c, h, w), _, hh, hw, grad = key
    passes = 2 if grad else 1
    tile = b * c * h * w * 2
    ext = b * c * (h + 2 * hh) * (w + 2 * hw) * 2
    strips = 2 * b * c * 2 * (hh * w + (h + 2 * hh) * hw)
    phases = passes * ((hh > 0) + (hw > 0))
    if backend == "nccl":
        return passes * (tile + ext), passes * strips, phases
    return passes * (tile + ext + 2 * strips), 0, phases


def _exchange_inputs(key, dtype, device, seed):
    """Every rank's tile and output cotangent of an exchange at ``key``,
    the same on every rank (from ``seed``); tiles with the key's strides."""
    import torch

    (b, c, h, w), stride, hh, hw, _ = key
    gen = torch.Generator(device=device).manual_seed(seed)
    tiles, cts = [], []
    for _ in range(SP_RANKS):
        t = torch.empty_strided((b, c, h, w), stride, dtype=dtype, device=device)
        tiles.append(t.copy_(torch.randn((b, c, h, w), generator=gen, device=device)))
        g = torch.randn((b, c, h + 2 * hh, w + 2 * hw), generator=gen, device=device)
        cts.append(g.to(dtype).contiguous(memory_format=torch.channels_last))
    return tiles, cts


def _exchange_reference(tiles, cts, key, fill):
    """(outputs, input gradients) of every rank's exchange through the
    whole-grid plain version, ``halo_exchange_reference``."""
    import torch

    from mpi4dl_tpu_torch.parallel.halo import halo_exchange_reference

    _, _, hh, hw, _ = key
    xs = [t.detach().clone().requires_grad_(True) for t in tiles]
    th, tw = SP_GRID
    ext = halo_exchange_reference([xs[i * tw:(i + 1) * tw] for i in range(th)], hh, hw, fill)
    outs = [e for row in ext for e in row]
    return [e.detach() for e in outs], torch.autograd.grad(outs, xs, cts)


def _exchange_case(rank, grid, key, tiles, cts, fill):
    """This rank's (output, input gradient) of the exchange (K4)."""
    import torch

    from mpi4dl_tpu_torch.parallel.halo import halo_exchange

    _, _, hh, hw, _ = key
    x = tiles[rank].detach().clone().requires_grad_(True)
    e = halo_exchange(x, hh, hw, grid, fill)
    (dx,) = torch.autograd.grad(e, x, cts[rank])
    return e.detach(), dx


def _sp_exchange_times(grid, device, exchanges, backend, round_trip_ms=None):
    """Phase s4 per shape in one rank: one whole bf16 ``halo_exchange``
    (forward, and backward where the step differentiates it) at every
    recorded exchange shape, beside NCCL's ``batch_isend_irecv`` of the
    same strips (one rank per card only) and the bound: bytes over the
    card's and NVLink's rates, plus one one-way flag hop (half the
    measured round trip) a phase."""
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.parallel.halo import halo_exchange

    rows = []
    for key, per_step in exchanges:
        shape, stride, hh, hw, grad = key
        b, c, h, w = shape
        x = torch.empty_strided(shape, stride, dtype=torch.bfloat16, device=device).normal_()
        x.requires_grad_(grad)
        g = torch.randn((b, c, h + 2 * hh, w + 2 * hw), device=device).to(torch.bfloat16)
        g = g.contiguous(memory_format=torch.channels_last)

        def exchange():
            e = halo_exchange(x, hh, hw, grid)
            if grad:
                torch.autograd.grad(e, x, g)

        dist.barrier()
        row = {"shape": _exchange_desc(key), "ms": cuda_ms(exchange, iters=K4_TIMING_ITERS),
               "launches_per_step": per_step, "library_ms": None}
        if backend == "nccl":
            strips = [torch.randn((b, hh, w, c), device=device).to(torch.bfloat16)] * (hh > 0)
            strips += [torch.randn((b, h + 2 * hh, hw, c), device=device).to(torch.bfloat16)] * (hw > 0)
            axes = ["tile_h"] * (hh > 0) + ["tile_w"] * (hw > 0)
            recv = [(torch.empty_like(s), torch.empty_like(s)) for s in strips]

            def nccl_exchange():
                for _ in range(2 if grad else 1):
                    for s, (ra, rb), axis in zip(strips, recv, axes):
                        prev, nxt = grid.prev(axis), grid.next(axis)
                        for req in dist.batch_isend_irecv([
                            dist.P2POp(dist.isend, s, prev), dist.P2POp(dist.isend, s, nxt),
                            dist.P2POp(dist.irecv, ra, nxt), dist.P2POp(dist.irecv, rb, prev),
                        ]):
                            req.wait()

            dist.barrier()
            row["library_ms"] = cuda_ms(nccl_exchange, iters=K4_TIMING_ITERS)
        hbm, nvlink, phases = _exchange_traffic(key, backend)
        row["bound_ms"] = (hbm / HBM_BYTES_PER_S + nvlink / NVLINK_BYTES_PER_S) * 1e3
        row["bound_by"] = "bytes"
        if round_trip_ms is not None:
            # The phases are serial (the W phase sends the H phase's halo
            # rows), and each needs at least one flag to travel one way.
            row["bound_ms"] += phases * round_trip_ms / 2
            row["bound_by"] = "bytes + one-way flag hops"
        rows.append(row)
        del x, g
    return rows


def sp_models():
    """Per spatial path, (description, builder taking the grid and the
    compute dtype and returning (model, spatial cells)): the model of the
    single-device path on the tiles, every cell but the head spatial (D1,
    or D2 where the path says so), and the environment it runs in."""
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2, get_resnet_v2_d2

    def all_but_head(model):
        return model, len(model) - 1

    models = {
        "resnet": (f"ResNet-{RESNET_DEPTH} v2", lambda grid, dtype: all_but_head(get_resnet_v2(
            RESNET_DEPTH, 10, spatial_cells=10**6, pool_kernel=SIZE // 4, dtype=dtype,
            grid=grid))),
        "amoebanet": (f"AmoebaNet-D {SP_LAYERS}L/{FILTERS}F", lambda grid, dtype: all_but_head(
            amoebanetd(10, SP_LAYERS, FILTERS, spatial_cells=10**6, dtype=dtype, grid=grid))),
        "resnet_d2": (f"ResNet-{RESNET_DEPTH} v2 D2 (fused_layers {D2_FUSED})",
                      lambda grid, dtype: get_resnet_v2_d2(
                          RESNET_DEPTH, 10, spatial_cells=10**6, fused_layers=D2_FUSED,
                          pool_kernel=SIZE // 4, dtype=dtype, grid=grid)[::2]),
        "amoebanet_d2": (f"AmoebaNet-D {SP_LAYERS}L/{FILTERS}F D2", lambda grid, dtype: all_but_head(
            amoebanetd(10, SP_LAYERS, FILTERS, spatial_cells=10**6, halo_d2=True, dtype=dtype,
                       grid=grid))),
    }
    out = {}
    for path, (model, env) in SP_SPECS.items():
        desc, build = models[model]
        if env:
            desc += ", " + ", ".join(f"{k}={v}" for k, v in env.items())
        out[path] = (desc, build, env)
    return out


def _check_window_sums(box):
    """Make ``layers.window_sum`` (the avg pools') also hold each call's
    output, and in the backward its input gradient, against the same sum in
    float64, as max |err| over the window's |x| (|dy|) sum; keeps the calls
    and the worst error in ``box`` (``WS_BOUND``). The step computes what
    it computes without the check. Returns the undo."""
    import torch

    from mpi4dl_tpu_torch.models import amoebanet
    from mpi4dl_tpu_torch.ops import layers

    real = layers.window_sum

    def note(err):
        worst = float(err.max())
        box["calls"] = box.get("calls", 0) + 1
        box["max"] = max(box.get("max", 0.0), worst)
        box["finite"] = box.get("finite", True) and math.isfinite(worst)

    class Checked(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, geom):
            y = real(x, *geom)
            x64 = x.double()
            note((y.double() - real(x64, *geom)).abs() / real(x64.abs(), *geom).clamp_min(1e-30))
            fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
                   else torch.contiguous_format)
            ctx.geom = (x.shape, x.dtype, x.device, fmt, geom)
            return y

        @staticmethod
        def backward(ctx, dy):
            shape, dtype, device, fmt, geom = ctx.geom

            def input_grad(cot, dt):
                # The sum is linear: its input gradient does not read x.
                z = torch.zeros(shape, dtype=dt, device=device).contiguous(memory_format=fmt)
                z.requires_grad_(True)
                with torch.enable_grad():
                    return torch.autograd.grad(real(z, *geom), z, cot)[0]

            dx = input_grad(dy, dtype)
            want = input_grad(dy.double(), torch.float64)
            note((dx.double() - want).abs()
                 / input_grad(dy.double().abs(), torch.float64).clamp_min(1e-30))
            return dx, None

    def checked(x, kh, kw, sh=1, sw=1, ph=0, pw=0):
        if x.is_meta:
            return real(x, kh, kw, sh, sw, ph, pw)
        return Checked.apply(x, (kh, kw, sh, sw, ph, pw))

    layers.window_sum = amoebanet.window_sum = checked

    def undo():
        layers.window_sum = amoebanet.window_sum = real
    return undo


def _wrong_divisors(model) -> list:
    """Names of the avg pools whose cached divisor on the card differs from
    the same count of in-image taps made on the CPU in float64."""
    import torch

    from mpi4dl_tpu_torch.models.amoebanet import PoolD2

    wrong = []
    for name, m in model.named_modules():
        for key, d in list(getattr(m, "_divisors", {}).items()):
            if not d.is_cuda:
                continue
            x = torch.empty((1, 1) + key[0], dtype=torch.float64)
            want = m._divisor(x) if isinstance(m, PoolD2) else m._divisor(x, *key[1])
            if not torch.equal(d.cpu().double(), want):
                wrong.append(name)
    return wrong


def _median_leaf_error(got, want) -> float:
    """The median over parameters of max |got - want| / max |want|."""
    errs = sorted(float((got[k] - want[k]).abs().max() / want[k].abs().max())
                  for k in want if float(want[k].abs().max()) > 0)
    return errs[len(errs) // 2]


def _sp_main(rank, grid, device, profile, path):
    """Phases s2, s7 and s8 in one rank: one spatial path."""
    _, build, env = sp_models()[path]
    with _env(env):
        return _sp_path(rank, grid, device, profile, build)


def _sp_path(rank, grid, device, profile, build):
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.analysis.expectations import compose
    from mpi4dl_tpu_torch.analysis.inventory import collective_log
    from mpi4dl_tpu_torch.analysis.report import analyze_records
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.ops import halo_kernel, layers
    from mpi4dl_tpu_torch.parallel import halo
    from mpi4dl_tpu_torch.train import Trainer, spatial_exchanges
    from mpi4dl_tpu_torch.weights import meta_built

    t0 = time.time()
    model, cells = meta_built(build, grid, torch.bfloat16)
    _seeded(model)
    cfg = ParallelConfig(batch_size=BATCH, image_size=SIZE, spatial_size=1,
                         num_spatial_parts=SP_RANKS)
    trainer = Trainer(model, cfg, learning_rate=0.001, momentum=0.9, device=device,
                      num_spatial_cells=cells, grid=grid)
    x, y = main_batch(device)
    out = {"setup_s": time.time() - t0, "warm": [], "losses": [], "times": [],
           "cells": cells, "exchanges_per_forward": len(spatial_exchanges(
               trainer.model, cells, (BATCH, 3, SIZE // SP_GRID[0], SIZE // SP_GRID[1])))}
    shapes = _new_calls()
    bn_reduces = [0]
    out["window_sums"] = {}
    for i in range(SP_WARMUP):
        restore = []
        if i == 0:
            restore = _record_shapes(shapes) + [
                _count_calls(layers._GridMean, "forward", bn_reduces),
                _count_calls(layers._GridMean, "backward", bn_reduces),
                _check_window_sums(out["window_sums"])]
        t = time.time()
        k4 = halo_kernel.launch_count
        # Phase n2: the last warm-up step under the collective log.
        with collective_log() if i == SP_WARMUP - 1 else contextlib.nullcontext() as clog:
            loss = float(trainer.train_step(x, y)["loss"])
        for undo in restore:
            undo()
        out["warm"].append((loss, time.time() - t))
        if clog is not None:
            rep = analyze_records(clog.records,
                                  expected=compose(trainer.collective_deltas(tuple(x.shape))),
                                  program="train_step")
            out["lint"] = {"summary": rep.summary_line(), "findings": rep.findings,
                           "inventory": {k: v for k, v in rep.inventory.items() if v},
                           "halo_permutes": clog.count("collective-permute", "halo"),
                           "k4_launches": halo_kernel.launch_count - k4,
                           "halo_shifts": trainer.halo_shift_count(tuple(x.shape))}
        if i == 0:  # the first step's gradients, against the f32 step's below
            first_grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    out["slot_bytes"] = grid.rings.slot_bytes if grid.rings else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for mod in counters.values():
        mod.launch_count = 0
    halo.deferred_count = 0
    for _ in range(SP_STEPS):
        t = time.perf_counter()
        out["losses"].append(float(trainer.train_step(x, y)["loss"]))
        out["times"].append(time.perf_counter() - t)
    out["launches"] = {name: mod.launch_count for name, mod in counters.items()}
    out["deferred"] = halo.deferred_count
    out["peak"] = torch.cuda.max_memory_allocated()
    out["divisors_wrong"] = _wrong_divisors(trainer.model)
    if profile:
        # Every rank profiles, so no rank's exchanges wait out the others'
        # profiler set-up and read-out; rank 0 prints.
        profile_step(trainer, x, y, tag=f"s2 {path}", emit=log if rank == 0 else lambda *a: None)
        dist.barrier()
    out["shapes"] = {name: sorted(v.items()) for name, v in shapes.items()}
    # The exchanges that move data (a 1x1 conv's has no halo).
    out["exchanges"] = [(k, n) for k, n in out["shapes"]["halo_swap"] if k[2] or k[3]]
    out["bn_allreduces"] = bn_reduces[0]
    del trainer, model, x, y
    gc.collect()  # trainers hold reference cycles
    torch.cuda.empty_cache()
    out["f32_loss"], f32_grads = f32_first_loss(
        meta_built(build, grid, torch.float32)[0], device, config=dict(spatial_size=1,
                                                           num_spatial_parts=SP_RANKS),
        grads=True, num_spatial_cells=cells, grid=grid)
    out["grad_dist"] = _median_leaf_error(first_grads, f32_grads)
    return out


def _sp_k4_check(rank, grid, device, exchanges):
    """Phase s3 in one rank: the exchange (K4) against the whole-grid plain
    version at every recorded exchange shape, output and input gradient,
    bf16 and f32, fills 0 and −inf; the plain swap (``halo_swap``) against
    ``swap_reference`` at every strip those exchanges send; a whole
    exchange against a pad and slice of the full image. All exact."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from mpi4dl_tpu_torch.ops import halo_kernel
    from mpi4dl_tpu_torch.parallel.halo import halo_exchange, strip_bytes

    lines, worst = [], 0.0
    key = max((k for k, _ in exchanges), key=lambda k: strip_bytes(k[0], k[2], k[3]))
    widest = strip_bytes(key[0], key[2], key[3])
    if not halo_kernel.SLOT_BYTES < widest <= grid.rings.slot_bytes:
        raise AssertionError(f"K4's slot {grid.rings.slot_bytes}: the widest f32 strip "
                             f"{widest} should exceed the default {halo_kernel.SLOT_BYTES}")
    lines.append(f"[s3] K4's receive slot {grid.rings.slot_bytes} bytes (default "
                 f"{halo_kernel.SLOT_BYTES}) takes the widest f32 strip of every path, "
                 f"{widest} bytes, of {_exchange_desc(key)}; checked with the others below")
    for idx, (key, _) in enumerate(exchanges):
        for dtype in (torch.bfloat16, torch.float32):
            for fill in (0.0, float("-inf")):
                tiles, cts = _exchange_inputs(key, dtype, device, SEED + idx)
                want_e, want_g = _exchange_reference(tiles, cts, key, fill)
                dist.barrier()
                e, dx = _exchange_case(rank, grid, key, tiles, cts, fill)
                torch.cuda.synchronize()
                grid.rings.check()  # a wait that ran out raises here, not as a mismatch
                worst = max(worst, float((dx.float() - want_g[rank].float()).abs().max()))
                if not (torch.equal(e, want_e[rank]) and torch.equal(dx, want_g[rank])):
                    raise AssertionError(f"K4 exchange {_exchange_desc(key)} {dtype} fill {fill}: "
                                         f"rank {rank} differs from the plain version")
                del tiles, cts, want_e, want_g, e, dx
        lines.append(f"[s3] K4 exchange {_exchange_desc(key)}: output and input gradient, bf16 "
                     "and f32, fills 0 and -inf, equal to the plain version on every rank")
    strips = sorted({s for key, _ in exchanges for s in _exchange_strips(key)})
    for idx, (axis, shape, stride) in enumerate(strips):
        ring = grid.ring(axis)
        k = ring.index(rank)
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=device).manual_seed(SEED + idx)
            a_all = [torch.randn(shape, generator=gen, device=device).to(dtype)
                     for _ in range(SP_RANKS)]
            b_all = [torch.randn(shape, generator=gen, device=device).to(dtype)
                     for _ in range(SP_RANKS)]
            a = torch.empty_strided(shape, stride, dtype=dtype, device=device).copy_(a_all[rank])
            b = torch.empty_strided(shape, stride, dtype=dtype, device=device).copy_(b_all[rank])
            ra, rb = halo_kernel.halo_swap(a, b, grid, axis)
            torch.cuda.synchronize()
            grid.rings.check()
            want_a, want_b = halo_kernel.swap_reference([a_all[r] for r in ring],
                                                        [b_all[r] for r in ring])
            if not (torch.equal(ra, want_a[k]) and torch.equal(rb, want_b[k])):
                raise AssertionError(f"K4 swap {axis} {list(shape)} {dtype}: rank {rank} differs "
                                     "from the plain version")
        lines.append(f"[s3] K4 swap {axis} strip {list(shape)} strides {stride}: bf16 and f32 "
                     "equal to the plain version on every rank")
    i, j = grid.coords
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=device).manual_seed(SEED)
        image = torch.randn((2, 16, 64, 64), generator=gen, device=device).to(dtype)
        image = image.contiguous(memory_format=torch.channels_last)
        for size, hh, hw, fill in ((64, 1, 1, 0.0), (64, 2, 2, float("-inf")), (8, 2, 2, 0.0)):
            t = size // 2  # the 4 px tiles of the 8 px image: extent exactly twice the halo
            tile = image[:, :, i * t:(i + 1) * t, j * t:(j + 1) * t]
            tile = tile.contiguous(memory_format=torch.channels_last)
            got = halo_exchange(tile, hh, hw, grid, fill)
            want = F.pad(image[:, :, :size, :size], (hw, hw, hh, hh), value=fill)[
                :, :, i * t:i * t + t + 2 * hh, j * t:j * t + t + 2 * hw]
            if not torch.equal(got, want):
                raise AssertionError(f"halo_exchange x[2,16,{size},{size}] h({hh},{hw}) fill "
                                     f"{fill} {dtype}: rank {rank} differs from pad-and-slice")
            if not got.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError("halo_exchange lost the channels_last layout")
    lines.append("[s3] halo_exchange of a 2x2 grid, x[2,16,64,64] h(1,1) fill 0 and h(2,2) fill "
                 "-inf, x[2,16,8,8] h(2,2) fill 0, bf16 and f32: equal to pad-and-slice of the "
                 "full image")
    return lines, worst


def _sp_k4_time(rank, grid, device, exchanges, backend, plain_group):
    """Phase s4 in one rank: the flag round trip; every exchange shape
    (:func:`_sp_exchange_times`); the timed exchange's plain distributed
    version (CPU tensors over gloo); one plain swap of the largest strip
    pair beside NCCL's ``batch_isend_irecv`` (one rank per card only)."""
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.ops import halo_kernel
    from mpi4dl_tpu_torch.parallel.halo import exchange_plain, exchange_plain_bwd

    dist.barrier()
    # On a card the ranks share, each hop waits for a context switch.
    rt = [grid.rings.round_trip_ms("tile_w", K4_ROUND_TRIPS[backend])]
    dist.broadcast_object_list(rt, src=0)
    out = {"round_trip_ms": rt[0], "backend": backend,
           "exchanges": _sp_exchange_times(grid, device, exchanges, backend, rt[0])}

    key = next(k for k, _ in exchanges if k[0] == K4_TIMED and k[4])
    tiles, cts = _exchange_inputs(key, torch.bfloat16, device, SEED)
    x, g = tiles[rank].cpu(), cts[rank].cpu()
    _, _, hh, hw, _ = key

    def plain():
        exchange_plain(x, hh, hw, grid, 0.0, plain_group)
        exchange_plain_bwd(g, hh, hw, grid, plain_group)

    plain()
    dist.barrier(plain_group)
    t = time.perf_counter()
    for _ in range(3):
        plain()
    out["plain_ms"] = (time.perf_counter() - t) * 1e3 / 3
    out["key"] = key

    axis, shape, stride = max((s for k, _ in exchanges for s in _exchange_strips(k)),
                              key=lambda s: math.prod(s[1]))
    a = torch.empty_strided(shape, stride, dtype=torch.bfloat16, device=device).normal_()
    b = torch.empty_strided(shape, stride, dtype=torch.bfloat16, device=device).normal_()
    swap = {"axis": axis, "shape": list(shape), "nbytes": 2 * a.numel() * a.element_size()}
    dist.barrier()
    swap["ms"] = cuda_ms(lambda: halo_kernel.halo_swap(a, b, grid, axis), iters=K4_TIMING_ITERS)
    swap["library_ms"] = None
    if backend == "nccl":
        a2, b2 = a.contiguous(), b.contiguous()
        ra, rb = torch.empty_like(a2), torch.empty_like(b2)
        prev, nxt = grid.prev(axis), grid.next(axis)

        def nccl_swap():
            for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, a2, prev), dist.P2POp(dist.isend, b2, nxt),
                dist.P2POp(dist.irecv, ra, nxt), dist.P2POp(dist.irecv, rb, prev),
            ]):
                req.wait()

        swap["library_ms"] = cuda_ms(nccl_swap, iters=K4_TIMING_ITERS)
    out["swap"] = swap
    return out


def _sp_graph(rank, grid, device, exchanges):
    """Phase s6 in one rank: three exchanges, forward and backward, captured
    in one CUDA graph; each of 3 replays on new inputs (copied into the
    captured tensors) held exactly against the plain version."""
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.parallel.halo import halo_exchange

    keys = sorted((k for k, _ in exchanges), key=lambda k: math.prod(k[0]))[:3]
    fills = (0.0, float("-inf"), 0.0)
    dtype = torch.bfloat16
    inputs = [_exchange_inputs(k, dtype, device, SEED) for k in keys]
    xs = [tiles[rank].requires_grad_(True) for tiles, _ in inputs]
    gs = [cts[rank] for _, cts in inputs]
    del inputs

    def step():
        outs = []
        for k, x, g, fill in zip(keys, xs, gs, fills):
            e = halo_exchange(x, k[2], k[3], grid, fill)
            outs.append((e, torch.autograd.grad(e, x, g)[0]))
        return outs

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream, as torch.cuda.graph asks
        step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for replay in range(3):
        wants = []
        for k, x, g, fill in zip(keys, xs, gs, fills):
            tiles, cts = _exchange_inputs(k, dtype, device, SEED + 100 + replay)
            with torch.no_grad():
                x.copy_(tiles[rank])
                g.copy_(cts[rank])
            want_e, want_g = _exchange_reference(tiles, cts, k, fill)
            wants.append((want_e[rank], want_g[rank]))
        torch.cuda.synchronize()
        dist.barrier()
        graph.replay()
        torch.cuda.synchronize()
        grid.rings.check()
        for k, (e, dx), (want_e, want_g) in zip(keys, outs, wants):
            if not (torch.equal(e, want_e) and torch.equal(dx, want_g)):
                raise AssertionError(f"graph replay {replay}, exchange {_exchange_desc(k)}: rank "
                                     f"{rank} differs from the plain version")
    del graph
    return [_exchange_desc(k) for k in keys]


def _sp_k4_timeout(rank, device):
    """Phase s5 in one rank: on rings of their own with a short wait, only
    rank 0 makes a swap. Its wait must run out, set the error word the
    step's sync reads, and end; the card then goes on with phases d-g."""
    import torch

    from mpi4dl_tpu_torch.ops import halo_kernel
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid

    grid = TileGrid(SP_GRID, rank)
    rings = halo_kernel.open_rings(grid, device, timeout_s=K4_TIMEOUT_S)
    out = None
    if rank == 0:  # the neighbours never make the matching swap
        a = torch.zeros((1, 1, 8, 8), device=device)
        t = time.perf_counter()
        halo_kernel.halo_swap(a, a.clone(), grid, "tile_h")
        torch.cuda.synchronize()
        out = {"s": time.perf_counter() - t, "error": rings.error()}
    halo_kernel.close_rings(grid)
    return out


def _sp_eval(rank, grid, device, ckpt_dir, keep):
    """Phase v3 in one rank: spatial ResNet-110 v2 @1024 bs2 (phase s2's
    model and seed, bf16 compute) calibrated over 2 ``ClassPatternImages``
    batches and evaluated over 2 more on the tiles (K4's phase launches of
    the eval counted from 0); rank 0 saves it and every rank rebuilds a
    fresh spatial Trainer from the checkpoint; then s1's small f32 spatial
    models, calibration and eval on the tiles."""
    import torch

    from mpi4dl_tpu_torch import evaluate
    from mpi4dl_tpu_torch.checkpoint import model_metadata, rebuild_from_checkpoint, save_checkpoint
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.data import ClassPatternImages
    from mpi4dl_tpu_torch.train import Trainer

    model, cells = sp_models()["resnet_sp"][1](grid, torch.bfloat16)
    _seeded(model)
    cfg = ParallelConfig(batch_size=BATCH, image_size=SIZE, spatial_size=1,
                         num_spatial_parts=SP_RANKS)
    trainer = Trainer(model, cfg, learning_rate=0.001, momentum=0.9, device=device,
                      num_spatial_cells=cells, grid=grid)
    ds = ClassPatternImages(BATCH, SIZE, 10, seed=SEED)
    counters = _counters()
    out = {}
    cal = [ds.batch(i)[0] for i in range(V_BATCHES)]
    test = [ds.batch(V_BATCHES + i) for i in range(V_BATCHES)]
    for mod in counters.values():
        mod.launch_count = 0
    t0 = time.perf_counter()
    stats = evaluate.spatial_collect_batch_stats(trainer, cal)
    out["cal_s"] = time.perf_counter() - t0
    out["cal_launches"] = {name: mod.launch_count for name, mod in counters.items()}
    for mod in counters.values():
        mod.launch_count = 0
    t0 = time.perf_counter()
    out["eval"] = evaluate.spatial_evaluate(trainer, stats, test)
    out["eval_s"] = time.perf_counter() - t0
    out["launches"] = {name: mod.launch_count for name, mod in counters.items()}
    t0 = time.perf_counter()
    save_checkpoint(ckpt_dir, trainer, batch_stats=stats, metadata=model_metadata(
        "resnet_v2", SIZE, depth=RESNET_DEPTH, num_classes=10, pool_kernel=SIZE // 4,
        dtype=torch.bfloat16, spatial_cells=cells))
    out["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, rebuilt, stats2, _ = rebuild_from_checkpoint(ckpt_dir, device=device, grid=grid,
                                                    config=cfg)
    out["restore_s"] = time.perf_counter() - t0
    out["equal"] = _state_equal(rebuilt, trainer) and rebuilt.n_spatial == trainer.n_spatial
    out["stats_equal"] = all(
        (a == b).all() for a, b in zip(_flat_leaves([_numpy_stats(s) for s in stats]),
                                       _flat_leaves(stats2)))
    keep["stats"] = stats  # phase r3 serves with them
    del trainer, rebuilt, model, stats, stats2
    gc.collect()  # trainers hold reference cycles
    torch.cuda.empty_cache()
    out["small"] = [small_eval(lambda: build_small(grid), size, device,
                               config=dict(spatial_size=1, num_spatial_parts=SP_RANKS),
                               num_spatial_cells=cells, grid=grid)
                    for _, size, cells, build_small in sp_small_models()]
    return out


def _flat_leaves(stats):
    out = []

    def walk(t):
        for k in sorted(t):
            walk(t[k]) if isinstance(t[k], dict) else out.append(t[k])

    for s in stats:
        walk(s)
    return out


def _sp_worker(rank, world, backend, profile, ckpt_dir, twins):
    """Every spatial phase in one rank of the 4-rank world, then phase s9's
    halo twins ``twins`` (:func:`_launched_twins`, which ends the world's
    group)."""
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.ops import halo_kernel
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device())
    grid = TileGrid(SP_GRID, rank)
    plain_group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    halo_kernel.open_rings(grid, device)
    out = {"small": _sp_small(grid, device)}
    # Every exchange shape of the paths, with its count per step on each.
    exchanges = {}
    for path in SP_PATHS:
        # Each phase starts on every rank together: a rank that is late on
        # the host by more than K4's wait limit fails its neighbours'
        # exchanges.
        dist.barrier()
        out[path] = _sp_main(rank, grid, device, profile, path)
        for key, n in out[path]["exchanges"]:
            exchanges.setdefault(key, dict.fromkeys(SP_PATHS, 0))[path] = n
    exchanges = sorted(exchanges.items())
    dist.barrier()
    keep = {}
    out["eval"] = _sp_eval(rank, grid, device, ckpt_dir, keep)
    dist.barrier()
    out["serve"] = _sp_serve(rank, grid, device, keep.pop("stats"))
    dist.barrier()
    out["k4_lines"], out["k4_err"] = _sp_k4_check(rank, grid, device, exchanges)
    dist.barrier()
    out["k4_time"] = _sp_k4_time(rank, grid, device, exchanges, backend, plain_group)
    dist.barrier()
    out["graph"] = _sp_graph(rank, grid, device, exchanges)
    halo_kernel.close_rings(grid)
    out["k4_timeout"] = _sp_k4_timeout(rank, device)
    out["twins"] = _launched_twins(rank, world, twins)
    return out


def phase_spatial(calls, profile, first_loss):
    """Phase s: spawn the 4 ranks, run every spatial phase, report. Counts
    each spatial path's call shapes (rank 0's first step) into
    ``calls[path]``; ``first_loss`` holds phase c's first-step losses by
    path. Returns the paths' launches (rank 0's, per kernel), their img/s,
    the cards the ranks ran on, and K4's timing (slowest rank)."""
    import torch

    from mpi4dl_tpu_torch.benchmarks.common import rank_layout
    from mpi4dl_tpu_torch.parallel import multihost

    backend, desc, env = rank_layout(SP_RANKS, DEVICE)
    log(f"[s] rank layout: {desc}, 2x2 tile grid")
    torch.cuda.empty_cache()
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="mpi4dl-sp-ckpt-") as ckpt_dir:
        twins = _twin_specs(_halo_runs(), ckpt_dir)
        ranks = multihost.spawn(_sp_worker, SP_RANKS,
                                args=(backend, profile, ckpt_dir, _worker_twins(twins)),
                                backend=backend, timeout=900, env=env)
        log(f"[s] 4 ranks ran phases s1-s8, v3, r3 and s9 in {time.time() - t0:.1f} s")
        halo_twins = phase_halo_twins(twins, [out["twins"] for out in ranks])

    for i, (name, size, _, build) in enumerate(sp_small_models()):
        want = small_step(lambda: build(None), size, "cpu")
        worst = max(check_small(f"spatial rank {r} {name}", out["small"][0][i], want)
                    for r, out in enumerate(ranks))
        log(f"[s1] small spatial reference {name} f32, 2x2 tiles: loss "
            f"{ranks[0]['small'][0][i][0]:.6f}, single-device CPU {want[0]:.6f}; gradients "
            f"normalised max|err| {worst:.2e} over the ranks (tolerance {SMALL_GRAD_TOL:g})")
    for i, (name, size, build) in enumerate(sp_small_d2_models()):
        want = small_step(lambda: build(None)[0], size, "cpu")
        worst = max(check_small(f"spatial rank {r} {name}", out["small"][1][i], want)
                    for r, out in enumerate(ranks))
        log(f"[s7] small spatial reference {name} f32, 2x2 tiles: loss "
            f"{ranks[0]['small'][1][i][0]:.6f}, single-device CPU {want[0]:.6f}; gradients "
            f"normalised max|err| {worst:.2e} over the ranks (tolerance {SMALL_GRAD_TOL:g})")
    for i, (name, size, _, build) in enumerate(sp_small_models()):
        want = small_step(lambda: build(None), size, "cpu")
        worst = max(check_small(f"decomposed rank {r} {name}", out["small"][2][i], want)
                    for r, out in enumerate(ranks))
        log(f"[s8] small spatial reference {name} f32, 2x2 tiles, decomposed: loss "
            f"{ranks[0]['small'][2][i][0]:.6f}, single-device CPU {want[0]:.6f}; gradients "
            f"normalised max|err| {worst:.2e} over the ranks (tolerance {SMALL_GRAD_TOL:g})")

    launches, ips = {}, {}
    launches["resnet_sp_eval"] = phase_spatial_eval([out["eval"] for out in ranks])
    phase_serve_sharded([out["serve"] for out in ranks])
    for path in SP_PATHS:
        name = sp_models()[path][0]
        model, env = SP_SPECS[path]
        tag = "[s8]" if env else "[s7]" if model.endswith("_d2") else "[s2]"
        mains = [out[path] for out in ranks]
        for r, m in enumerate(mains):
            if not all(math.isfinite(v) for v in m["losses"] + [w[0] for w in m["warm"]]):
                raise AssertionError(f"{path} rank {r}: non-finite loss {m['losses']}")
            for kernel in PATH_KERNELS[path]:
                n = m["launches"][kernel]
                if n == 0 or n % SP_STEPS:
                    raise AssertionError(f"{path} rank {r}: {kernel} launched {n} times in "
                                         f"{SP_STEPS} steps")
            if bool(m["deferred"]) != bool(env):
                raise AssertionError(f"{path} rank {r}: {m['deferred']} exchanges deferred on "
                                     f"the exchange stream in {SP_STEPS} steps")
            ws = m["window_sums"]
            if not (ws.get("finite", True) and ws.get("max", 0.0) <= WS_BOUND):
                raise AssertionError(f"{path} rank {r}: a window sum {ws} off by "
                                     f"more than {WS_BOUND:g} of its window's sum of |x|")
            if m["divisors_wrong"]:
                raise AssertionError(f"{path} rank {r}: wrong avg-pool divisors after "
                                     f"{SP_WARMUP + SP_STEPS} steps: {m['divisors_wrong']}")
        slowest = [max(m["times"][i] for m in mains) for i in range(SP_STEPS)]
        ms = _median_step_ms(mains)
        ips[path] = BATCH / (ms / 1e3)
        m0 = mains[0]
        log(f"{tag} {path}: {name} @{SIZE} bs{BATCH}, 2x2 tiles of {SIZE // 2}x{SIZE // 2}, "
            f"bf16 compute, f32 params, remat=False; set-up {m0['setup_s']:.1f} s; warm-up "
            f"steps {[f'{loss:.4f} ({t:.2f} s)' for loss, t in m0['warm']]}; K4 receive slot "
            f"{m0['slot_bytes']} bytes; {m0['exchanges_per_forward']} exchanges a forward")
        single = model.split("_")[0]
        first = ("f32 %.6f" % first_loss[single][1] if single in first_loss else "not run")
        if single in first_loss:
            want = first_loss[single][1]
            if not abs(m0["f32_loss"] - want) <= F32_LOSS_RTOL * abs(want):
                raise AssertionError(f"{path}: f32 first-step loss {m0['f32_loss']} against the "
                                     f"single-device {want} (rtol {F32_LOSS_RTOL})")
        log(f"{tag} {path} first step loss: spatial bf16 {m0['warm'][0][0]:.6f}, f32 "
            f"{m0['f32_loss']:.6f} (TF32 off); single-device (same depth, weights "
            f"and batch) {first} (f32 within {F32_LOSS_RTOL:g})")
        if env:
            mono = ranks[0][f"{single}_sp"]
            if not abs(m0["f32_loss"] - mono["f32_loss"]) <= DEC_LOSS_RTOL * abs(mono["f32_loss"]):
                raise AssertionError(f"{path}: f32 first-step loss {m0['f32_loss']} against the "
                                     f"monolithic arm's {mono['f32_loss']} (rtol {DEC_LOSS_RTOL})")
            log(f"{tag} {path} f32 first-step loss {m0['f32_loss']:.6f} against the monolithic "
                f"arm's {mono['f32_loss']:.6f} (within {DEC_LOSS_RTOL:g}); "
                f"{[m['deferred'] // SP_STEPS for m in mains]} exchanges a step by rank ran "
                "deferred on the exchange stream beside the interior's compute")
        log(f"{tag} {path} losses {['%.4f' % v for v in m0['losses']]}")
        ws = m0["window_sums"]
        log(f"{tag} {path} first step: {ws.get('calls', 0)} window sums a rank (outputs and "
            f"input gradients) against float64, worst over the ranks "
            f"{max(m['window_sums'].get('max', 0.0) for m in mains):.4e} of the window's sum "
            f"of |x| (bound {WS_BOUND:.4e}); avg-pool divisors exact after every step; bf16 "
            f"gradients against the f32 step's: median leaf {m0['grad_dist']:.4f}")
        log(f"{tag} {path} step time median {ms:.1f} ms (slowest rank per step: "
            f"{[round(t * 1e3, 1) for t in slowest]}), {ips[path]:.3f} img/s, peak memory "
            f"allocated per rank {[round(m['peak'] / 2**30, 2) for m in mains]} GiB")
        lint = m0["lint"]
        log(f"[n2] {path} rank 0, its last warm-up step: {lint['summary']}; inventory "
            f"{lint['inventory']}; halo permutes {lint['halo_permutes']} in the window "
            f"[{lint['halo_shifts']}, {2 * lint['halo_shifts']}] of halo_shift_count "
            f"{lint['halo_shifts']}; K4 launches {lint['k4_launches']}; findings "
            f"{[(f['rule'], f['severity']) for f in lint['findings']]}")
        if path == "resnet_sp":
            for r, m in enumerate(mains):
                ln = m["lint"]
                if (any(f["rule"] == "halo-permute-count" for f in ln["findings"])
                        or ln["halo_permutes"] != 2 * ln["k4_launches"]
                        or not ln["k4_launches"]):
                    raise AssertionError(f"[n2] {path} rank {r}: {ln}")
        log(f"{tag} {path} launches per rank per step: " + "; ".join(
            ", ".join(f"{k} {v // SP_STEPS}" for k, v in m["launches"].items()) for m in mains)
            + f"; BN all-reduces per step {m0['bn_allreduces']}; exchanges per step "
            f"{sum(n for _, n in m0['exchanges'])} (K4 launches are their axis phases)")
        twin = f"{single}_sp"
        if path != twin:
            d1 = ranks[0][twin]
            mine = [w[0] for w in m0["warm"]] + m0["losses"]
            theirs = [w[0] for w in d1["warm"]] + d1["losses"]
            rel = [abs(a - b) / abs(b) for a, b in zip(mine, theirs)]
            if not rel[0] <= BF16_FIRST_LOSS_RTOL[single]:
                raise AssertionError(f"{path}: bf16 first-step loss {mine[0]} against {twin}'s "
                                     f"{theirs[0]} (rtol {BF16_FIRST_LOSS_RTOL[single]:g})")
            if single in BF16_LOSS_RTOL and not max(rel) <= BF16_LOSS_RTOL[single]:
                raise AssertionError(f"{path}: bf16 losses {mine} against {twin}'s {theirs} "
                                     f"(rtol {BF16_LOSS_RTOL[single]:g})")
            if single not in BF16_LOSS_RTOL and not (
                    m0["grad_dist"] <= GRAD_DIST_RATIO * d1["grad_dist"]):
                raise AssertionError(f"{path}: bf16 first-step gradients {m0['grad_dist']} from "
                                     f"the f32 step's, {twin}'s {d1['grad_dist']} (at most "
                                     f"{GRAD_DIST_RATIO:g}x)")
            log(f"{tag} {path} bf16 losses against {twin}'s, relative, warm-up and timed "
                f"steps: {['%.2e' % v for v in rel]} (first step within "
                f"{BF16_FIRST_LOSS_RTOL[single]:g}"
                + (f", every step within {BF16_LOSS_RTOL[single]:g}" if single in BF16_LOSS_RTOL
                   else "") + f"); first-step gradients' median leaf from f32 "
                f"{m0['grad_dist']:.4f} against {d1['grad_dist']:.4f}"
                + ("" if single in BF16_LOSS_RTOL else f" (at most {GRAD_DIST_RATIO:g}x)"))
            log(f"{tag} {path} against its D1 monolithic twin {twin}: K4 phase launches a rank "
                f"and step {m0['launches']['halo_swap'] // SP_STEPS} / "
                f"{d1['launches']['halo_swap'] // SP_STEPS}, exchanges a forward "
                f"{m0['exchanges_per_forward']} / {d1['exchanges_per_forward']}, step "
                f"{ms:.1f} / {_median_step_ms([out[twin] for out in ranks]):.1f} ms (slowest "
                f"rank; 4 ranks time-sliced on one card show no overlap)")
        for kernel in KERNELS:
            calls[path][kernel].update(dict(m0["shapes"][kernel]))
            for m in mains[1:]:  # every rank's shapes are checked; counts are rank 0's
                for key, _ in m["shapes"][kernel]:
                    calls[path][kernel].setdefault(key, 0)
        launches[path] = {kernel: m0["launches"][kernel] for kernel in PATH_KERNELS[path]}
    for line in ranks[0]["k4_lines"]:
        log(line)
    timing = exchange_rows(ranks)
    log(f"[s6] {len(ranks[0]['graph'])} exchanges ({'; '.join(ranks[0]['graph'])}), forward "
        "and backward, captured in one CUDA graph on every rank: 3 replays on new inputs, "
        "each equal to the plain version")
    timeout = ranks[0]["k4_timeout"]
    if timeout["error"] is None or not timeout["s"] < K4_TIMEOUT_S + 5:
        raise AssertionError(f"K4's unmatched wait: {timeout}")
    log(f"[s5] an unmatched swap on rank 0 (wait limit {K4_TIMEOUT_S:g} s) ended after "
        f"{timeout['s']:.2f} s with its error word set: {timeout['error']!r}")
    timing["max_abs_err"] = max(out["k4_err"] for out in ranks)
    timing["plain_ms"] = max(out["k4_time"]["plain_ms"] for out in ranks)
    timing["round_trip_ms"] = ranks[0]["k4_time"]["round_trip_ms"]
    timing["key"] = ranks[0]["k4_time"]["key"]
    swap = dict(ranks[0]["k4_time"]["swap"])
    for key in ("ms", "library_ms"):
        if swap[key] is not None:
            swap[key] = max(out["k4_time"]["swap"][key] for out in ranks)
    timing["swap"] = swap
    timing["layout"] = desc
    timing["backend"] = backend
    timing["halo_twins"] = halo_twins
    timing["halo_twins_s"] = sum(wall for _, wall, _ in ranks[0]["twins"])
    cards = 1 if backend == "gloo" else SP_RANKS
    return launches, ips, cards, timing


def _median_step_ms(mains):
    slowest = [max(m["times"][i] for m in mains) for i in range(SP_STEPS)]
    return sorted(slowest)[SP_STEPS // 2] * 1e3


def phase_spatial_eval(evals):
    """Phase v3's gates and lines from every rank's :func:`_sp_eval`:
    finite eval results equal on every rank, K4 launched in every rank's
    eval forward, the rebuilt trainer bit-equal on every rank, the small
    spatial models within ``SP_EVAL_TOL`` of single-device eval on the CPU.
    Returns rank 0's eval launches."""
    e0 = evals[0]
    for r, e in enumerate(evals):
        same = (e["eval"]["accuracy"] == e0["eval"]["accuracy"]
                and abs(e["eval"]["loss"] - e0["eval"]["loss"]) <= 1e-6 * abs(e0["eval"]["loss"]))
        if not (e["launches"]["halo_swap"] > 0 and e["equal"] and e["stats_equal"]
                and math.isfinite(e["eval"]["loss"]) and same):
            raise AssertionError(f"v3 rank {r}: eval {e['eval']} (rank 0 {e0['eval']}), "
                                 f"launches {e['launches']}, rebuilt equal {e['equal']}, "
                                 f"statistics equal {e['stats_equal']}")
    log(f"[v3] resnet_sp: ResNet-{RESNET_DEPTH} v2 @{SIZE} bs{BATCH} on 2x2 tiles, bf16 compute: "
        f"spatial_collect_batch_stats over {V_BATCHES} ClassPatternImages batches "
        f"{max(e['cal_s'] for e in evals) / V_BATCHES * 1e3:.1f} ms a batch, spatial_evaluate "
        f"over {V_BATCHES} {max(e['eval_s'] for e in evals) / V_BATCHES * 1e3:.1f} ms a batch "
        f"({V_BATCHES * BATCH / max(e['eval_s'] for e in evals):.3f} img/s; slowest rank); "
        f"loss {e0['eval']['loss']:.4f}, accuracy {e0['eval']['accuracy']:.2f}, the same on "
        f"every rank; K4 phase launches per eval batch (forward exchanges only) "
        f"{[e['launches']['halo_swap'] / V_BATCHES for e in evals]} by rank, per calibration "
        f"batch {[e['cal_launches']['halo_swap'] / V_BATCHES for e in evals]}; {card()}")
    log(f"[v3] rank 0 saved (with the statistics) in {e0['save_s']:.2f} s; every rank rebuilt a "
        f"spatial Trainer from it in {max(e['restore_s'] for e in evals):.2f} s (slowest): params, "
        f"momentum, step and statistics bit-equal on every rank; {card()}")
    for i, (name, size, _, build) in enumerate(sp_small_models()):
        want = small_eval(lambda: build(None), size, "cpu")
        worst = max(check_small_eval(f"v3 rank {r} {name}", e["small"][i], want, SP_EVAL_TOL,
                                     SP_EVAL_TOL) for r, e in enumerate(evals))
        log(f"[v3] small spatial reference {name} f32, 2x2 tiles: calibration + eval loss "
            f"{e0['small'][i][1]['loss']:.6f}, single-device CPU {want[1]['loss']:.6f}; "
            f"statistics normalised max|err| {worst:.2e} over the ranks (tolerance "
            f"{SP_EVAL_TOL:g})")
    return e0["launches"]


def exchange_rows(ranks):
    """Phase s4's per-shape exchange times (slowest rank at each shape)
    and their launch-weighted sums per step of each spatial path, logged."""
    rows = []
    sums = {path: {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "exchanges": 0}
            for path in SP_PATHS}
    rt = ranks[0]["k4_time"]["round_trip_ms"]
    log(f"[s4] one-word flag round trip between two ranks' arenas (tile_w ring, mean of "
        f"{K4_ROUND_TRIPS[ranks[0]['k4_time']['backend']]} in one launch): {rt * 1e3:.2f} us")
    for i, row in enumerate(ranks[0]["k4_time"]["exchanges"]):
        row = dict(row)
        for key in ("ms", "library_ms"):
            if row[key] is not None:
                row[key] = max(out["k4_time"]["exchanges"][i][key] for out in ranks)
        for path, n in row["launches_per_step"].items():
            sums[path]["exchanges"] += n
            for key in ("ms", "bound_ms", "library_ms"):
                sums[path][key] += n * (row[key] or 0.0)
        lib = row["library_ms"]
        log(f"[s4] halo_exchange {row['shape']} bf16: {row['ms']:.4f} ms, NCCL strips "
            f"{'%.4f ms' % lib if lib is not None else 'n/a (ranks share a card)'}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); a rank and step "
            f"{row['launches_per_step']}")
        rows.append(row)
    for path, t in sums.items():
        if t["library_ms"] == 0.0:
            t["library_ms"] = None
        log(f"[s4] halo_exchange on {path} per rank and step, launch-weighted: {t['exchanges']} "
            f"exchanges, {t['ms']:.3f} ms, NCCL strips "
            f"{'%.3f ms' % t['library_ms'] if t['library_ms'] is not None else 'n/a'}, "
            f"bound {t['bound_ms']:.3f} ms")
    return {"exchanges": rows, "exchange_per_step": sums}


def halo_row(timing, launches):
    """The kernels line's K4 row: one exchange, forward and backward, at
    the timed shape (``timing`` from phases s3-s4)."""
    timed = next(r for r in timing["exchanges"] if r["shape"] == _exchange_desc(timing["key"]))
    swap = timing["swap"]
    row = {
        "name": "halo_swap", "route": "cuda",
        "source": "mpi4dl_tpu_torch/ops/csrc/halo_swap.cu",
        "replaces": "mpi4dl_tpu/ops/halo_pallas.py:174",
        **_launch_fields("halo_swap", launches),
        "max_abs_err": timing["max_abs_err"],
        "ms": timed["ms"], "plain_ms": timing["plain_ms"], "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"], "library_ms": timed["library_ms"],
        "shape": f"{timed['shape']} bf16 (one exchange: 4 phase launches)",
        "layout": timing["layout"], "round_trip_ms": timing["round_trip_ms"],
        "exchanges": timing["exchanges"], "exchange_per_step": timing["exchange_per_step"],
        "swap": swap, "halo_twins_median_ms": timing["halo_twins"],
    }
    lib = row["library_ms"]
    log(f"[s4] K4 at its timed exchange, {row['shape']}: kernel {row['ms']:.3f} ms, plain (CPU, "
        f"gloo) {row['plain_ms']:.3f} ms, library (NCCL batch_isend_irecv of the strips) "
        f"{'%.3f ms' % lib if lib is not None else 'n/a (ranks share a card)'}, bound "
        f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}); launches per step "
        f"{row['launches_per_step']}")
    log(f"[s9] beside K4's row, the halo twins' medians (ms): " + ", ".join(
        f"{path} {ms:.4f}" for path, ms in timing["halo_twins"].items()))
    slib = swap["library_ms"]
    log(f"[s4] halo_swap a, b [{','.join(map(str, swap['shape']))}] bf16 along {swap['axis']}, "
        f"{swap['nbytes']} bytes a rank: kernel {swap['ms']:.3f} ms, library (NCCL "
        f"batch_isend_irecv) {'%.3f ms' % slib if slib is not None else 'n/a (ranks share a card)'}")
    return row


# -- phase p: the LP/PP pipeline ------------------------------------------------

def pp_batch(device):
    """The pipeline paths' batch of ``PP_BATCH`` images, from the seed."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    x = torch.randn((PP_BATCH, SIZE, SIZE, 3), generator=gen, device=device).to(torch.bfloat16)
    y = torch.randint(0, 10, (PP_BATCH,), generator=gen, device=device)
    return x, y


def pp_builders():
    """model -> builder taking the compute dtype of phase p: AmoebaNet-D at
    ``PIPE_LAYERS`` and ResNet-v2 at ``PIPE_RESNET_DEPTH``, phase c's
    widths."""
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2

    return {
        "amoebanet": lambda dtype: amoebanetd(10, PIPE_LAYERS, FILTERS, dtype=dtype),
        "resnet": lambda dtype: get_resnet_v2(PIPE_RESNET_DEPTH, 10, pool_kernel=SIZE // 4,
                                              dtype=dtype),
    }


def _tick_probe(box, device):
    """A ``PipelineTrainer.on_tick`` that appends, per tick, (direction,
    tick, work items, ops run on ``device``, K1-K3 launches) to ``box``:
    every aten op with a tensor argument on ``device``'s type counts (a
    ``TorchDispatchMode``)."""
    import contextlib

    from torch.utils._python_dispatch import TorchDispatchMode

    counters = _counters()

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            import torch

            leaves = torch.utils._pytree.tree_leaves((args, kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.device.type == device.type
                   for t in leaves):
                self.n += 1
            return func(*args, **(kwargs or {}))

    @contextlib.contextmanager
    def tick(direction, t, work):
        before = sum(counters[k].launch_count for k in ("pool_bwd", "wgrad", "dot1x1_bwd"))
        ops = Ops()
        with ops:
            yield
        after = sum(counters[k].launch_count for k in ("pool_bwd", "wgrad", "dot1x1_bwd"))
        box.append((direction, t, len(work), ops.n, after - before))

    return tick


def _pp_step(model, config, device, x, y, schedule=None, probe=None, shapes=None,
             accum=None, gems=False):
    """One step at ``PP_LR`` from the model's current weights: a
    ``PipelineTrainer`` (``schedule``; collective), with ``gems`` a
    ``GemsMasterTrainer`` (collective), or, with ``accum``,
    ``Trainer(grad_accum=accum)``. Returns (loss, this rank's K1-K3
    launches, the step's gradients, its SGD momentum buffers, per cell as
    numpy: a pipeline's gathered to rank 0, None on the other ranks, and a
    pipeline's cells of each virtual stage); ``probe`` (a list) gets
    the ticks, ``shapes`` (from :func:`_new_calls`) the kernels' call
    shapes."""
    import torch

    from mpi4dl_tpu_torch.parallel.pipeline import GemsMasterTrainer, PipelineTrainer
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import unstack_pipeline

    if accum:
        tr = Trainer(model, config, learning_rate=PP_LR, device=device, grad_accum=accum)
    elif gems:
        tr = GemsMasterTrainer(model, config, learning_rate=PP_LR, device=device)
    else:
        tr = PipelineTrainer(model, config, learning_rate=PP_LR, device=device,
                             schedule=schedule)
        if probe is not None:
            tr.on_tick = _tick_probe(probe, device)
    counters = _counters()
    for mod in counters.values():
        mod.launch_count = 0
    restore = _record_shapes(shapes) if shapes is not None else []
    try:
        loss = float(tr.train_step(x, y)["loss"])
    finally:
        for undo in restore:
            undo()
    launches = {k: counters[k].launch_count for k in ("pool_bwd", "wgrad", "dot1x1_bwd")}
    if accum:
        grads = tr.state_tensors()[1]
    else:
        stacked = tr.stacked_rows("momentum")
        grads = (None if stacked is None
                 else unstack_pipeline(stacked, tr.model, tr.stages, tr.placement))
    if grads is not None:
        grads = [{k: v.detach().cpu().numpy() for k, v in cell.items()} for cell in grads]
    stages = None if accum else tr.stages
    del tr
    gc.collect()  # trainers hold reference cycles
    torch.cuda.empty_cache()
    return loss, launches, grads, stages


def _stage_errors(got, want, stages) -> list:
    """Per virtual stage (its cells' indices in ``stages``), the relative L2
    norm of ``got - want`` over every leaf of its cells (per cell
    ``{name: array}``), in float64."""
    import numpy as np

    out = []
    for cells in stages:
        diff = ref = 0.0
        for i in cells:
            for k, w in want[i].items():
                w = w.astype(np.float64)
                diff += float(((got[i][k] - w) ** 2).sum())
                ref += float((w ** 2).sum())
        out.append((diff / ref) ** 0.5)
    return out


def _pp_resume(model, config, device, x, y, ckpt_dir):
    """Checkpoint and resume: a gpipe step, ``save_checkpoint`` (rank 0
    writes), a second step; then a new trainer restores the checkpoint and
    takes the second step again. Returns both second losses and the
    checkpoint's bytes."""
    import torch

    from mpi4dl_tpu_torch import checkpoint
    from mpi4dl_tpu_torch.parallel.pipeline import PipelineTrainer

    tr = PipelineTrainer(model, config, learning_rate=0.001, device=device)
    tr.train_step(x, y)
    t0 = time.time()
    path = checkpoint.save_checkpoint(ckpt_dir, tr)
    save_s = time.time() - t0
    first = float(tr.train_step(x, y)["loss"])
    del tr
    tr = PipelineTrainer(model, config, learning_rate=0.001, device=device)
    t0 = time.time()
    checkpoint.restore_checkpoint(path, tr)
    restore_s = time.time() - t0
    step = tr.step
    again = float(tr.train_step(x, y)["loss"])
    nbytes = os.path.getsize(os.path.join(path, "state.msgpack"))
    del tr
    gc.collect()  # trainers hold reference cycles
    torch.cuda.empty_cache()
    return {"loss": first, "resumed_loss": again, "step": step, "bytes": nbytes,
            "save_s": save_s, "restore_s": restore_s}


def _pp_worker(rank, world, ckpt_dir, twins):
    """Phase p in one rank of its 2-rank world, with phase g's 2-rank part.
    p2: per model, one f32 step of each schedule from the seed's weights
    (the first with the kernels' call shapes recorded and every tick
    probed), then g2's GEMS step (:func:`_g_gems_step`), then rank 0 takes
    ``Trainer(grad_accum=PP_PARTS)``'s step on the same weights while the
    other ranks wait and holds each schedule's and the GEMS step's gradients
    to its (:func:`_stage_errors`); on ResNet-110, the checkpoint and
    resume. Then g1's LP layouts (:func:`_g_small`), and last the twins
    ``twins``, p1's and g3's LP ones (:func:`_launched_twins`). g's records
    go under ``"g"``: per model g2's, and ``g_small``."""
    import copy

    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.weights import meta_built

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = (torch.device("cuda", torch.cuda.current_device()) if DEVICE == "cuda"
              else torch.device(DEVICE))
    cfg = ParallelConfig(batch_size=PP_BATCH, parts=PP_PARTS, split_size=PP_RANKS,
                         image_size=SIZE)
    x, y = pp_batch(device)
    x = x.float()
    out, gems = {}, {}
    for name, build in pp_builders().items():
        t0 = time.time()
        model = _seeded(meta_built(build, torch.float32))
        start = copy.deepcopy(model.state_dict())
        res = {"setup_s": time.time() - t0, "shapes": _new_calls()}
        grads = {}
        for schedule in PP_SCHEDULES:
            model.load_state_dict(start)
            probe = []
            dist.barrier()
            loss, launches, g, stages = _pp_step(
                model, cfg, device, x, y, schedule=schedule, probe=probe,
                shapes=res["shapes"] if schedule == "gpipe" else None)
            res[schedule] = (loss, launches)
            grads[schedule] = (g, stages)
            del g
            res[f"{schedule}_ticks"] = probe
        g_res, g_grads = _g_gems_step(model, start, device, x, y)
        g_res.update(setup_s=res["setup_s"], gpipe=res["gpipe"])
        gems[name] = g_res
        dist.barrier()
        if rank == 0:
            model.load_state_dict(start)
            with whole_card(device):
                loss, launches, want, _ = _pp_step(
                    model, ParallelConfig(batch_size=PP_BATCH, image_size=SIZE), device, x, y,
                    accum=PP_PARTS)
            res["trainer"] = (loss, launches)
            for schedule, (g, stages) in grads.items():
                res[f"{schedule}_grad_err"] = _stage_errors(g, want, stages)
            g_res.update(trainer=res["trainer"],
                         gems_grad_err=_stage_errors(g_grads[0], want, g_grads[1]))
            del want, g
        del g_grads
        dist.barrier()
        if name == "resnet":
            model.load_state_dict(start)
            res["resume"] = _pp_resume(model, cfg, device, x, y, ckpt_dir)
        del model, start, grads
        gc.collect()  # trainers hold reference cycles
        torch.cuda.empty_cache()
        out[name] = res
    t0 = time.time()
    gems["g_small"] = _g_small(rank, device, G_SMALL_LP)
    gems["g_small_s"] = time.time() - t0
    out["g"] = gems
    out["twins"] = _launched_twins(rank, world, twins)
    return out


def phase_pipeline(calls, launches, ips, cards):
    """Phase p with phase g's 2-rank part: spawn the 2-rank world
    (:func:`_pp_worker`), then check p2 (:func:`phase_pipeline_gates`), p1
    (:func:`phase_pipeline_cli`), g1's LP layouts
    (:func:`phase_gems_small`), g2 (:func:`phase_gems_gates`) and g3's LP
    twins (:func:`phase_gems_cli`). Returns g2's ``Trainer(grad_accum=4)``
    launches per model, to which phase q holds g3's SP+GEMS twins."""
    import torch

    from mpi4dl_tpu_torch.benchmarks.common import rank_layout
    from mpi4dl_tpu_torch.parallel import multihost

    backend, desc, env = rank_layout(PP_RANKS, DEVICE)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="mpi4dl-pp-") as tmp:
        n_p1 = len(_p1_runs())
        twins = _twin_specs(_p1_runs() + _g3_runs(G_RANKS), tmp)
        ranks = multihost.spawn(_pp_worker, PP_RANKS,
                                args=(os.path.join(tmp, "ckpt"), _worker_twins(twins)),
                                backend=backend, timeout=900, env=env)
        outs = ranks[0]["twins"]
        log(f"[p] {desc}: p2's f32 steps of both schedules, g2's GEMS steps, Trainer(grad_accum="
            f"{PP_PARTS}) and the checkpoint, g1's LP layouts "
            f"({ranks[0]['g']['g_small_s']:.1f} s), then p1's {n_p1} and g3's "
            f"{len(twins) - n_p1} twin runs, in {time.time() - t0:.1f} s")
        want = phase_pipeline_gates(calls, ranks)
        phase_pipeline_cli(launches, ips, cards, want, twins[:n_p1], outs[:n_p1], desc)
        phase_gems_small(ranks[0]["g"]["g_small"])
        g_want = phase_gems_gates(calls, [r["g"] for r in ranks])
        phase_gems_cli(launches, ips, cards, g_want, twins[n_p1:], outs[n_p1:], desc)
    return g_want


def phase_pipeline_gates(calls, ranks):
    """Phase p2: hold the pipeline to ``Trainer`` from the ranks' records
    (:func:`_pp_worker`); counts each model's gpipe call shapes (summed over
    the ranks) into ``calls[<model>_pp_gpipe]``. Returns, per model, the
    K1-K3 launches of ``Trainer(grad_accum=PP_PARTS)``'s step."""
    for name in pp_builders():
        per = [r[name] for r in ranks]
        path = f"{name}_pp_gpipe"
        calls[path] = _new_calls()
        for r in per:
            for k, c in r["shapes"].items():
                calls[path][k].update(c)
        want_loss, want_launch = per[0]["trainer"]
        losses = {s: per[0][s][0] for s in PP_SCHEDULES}
        for s in PP_SCHEDULES:
            if any(r[s][0] != losses[s] for r in per):
                raise AssertionError(f"{name} {s}: the ranks' losses differ: {[r[s][0] for r in per]}")
            got = {k: sum(r[s][1][k] for r in per) for k in want_launch}
            if got != want_launch:
                raise AssertionError(f"{name} {s}: K1-K3 launches summed over the ranks {got}, "
                                     f"Trainer(grad_accum={PP_PARTS}) {want_launch}")
            if not abs(losses[s] - want_loss) <= PP_LOSS_RTOL * abs(want_loss):
                raise AssertionError(f"{name} {s}: f32 first-step loss {losses[s]!r}, "
                                     f"Trainer(grad_accum={PP_PARTS}) {want_loss!r}")
            grad_err = per[0][f"{s}_grad_err"]
            if not all(e <= PP_GRAD_TOL for e in grad_err):
                raise AssertionError(f"{name} {s}: each virtual stage's gradients {grad_err} (L2, "
                                     f"relative) from Trainer(grad_accum={PP_PARTS})'s "
                                     f"(tolerance {PP_GRAD_TOL:g})")
            idle = busy = 0
            for rank, r in enumerate(per):
                for direction, t, n_work, ops, k_launches in r[f"{s}_ticks"]:
                    if n_work == 0:
                        idle += 1
                        if ops or k_launches:
                            raise AssertionError(f"{name} {s} rank {rank}: idle {direction} tick "
                                                 f"{t} ran {ops} ops, {k_launches} K1-K3")
                    else:
                        busy += 1
                        if not ops:
                            raise AssertionError(f"{name} {s} rank {rank}: busy {direction} "
                                                 f"tick {t} shows no op (the probe sees nothing)")
            log(f"[p2] {name} {s}: f32 first-step loss {losses[s]:.7f} (Trainer(grad_accum="
                f"{PP_PARTS}) {want_loss:.7f}, rel {abs(losses[s] - want_loss) / abs(want_loss):.2e}"
                f", gate {PP_LOSS_RTOL:g}); virtual stages' gradients {['%.2e' % e for e in grad_err]}"
                f" from the Trainer's, relative L2 (gate {PP_GRAD_TOL:g}); K1-K3 a step summed "
                f"over the ranks {got} (the Trainer's {want_launch}); {idle} idle ticks ran no "
                f"op, {busy} busy ticks did")
        rel = abs(losses["gpipe"] - losses["1f1b"]) / abs(losses["gpipe"])
        if rel > PP_SCHED_RTOL:
            raise AssertionError(f"{name}: gpipe loss {losses['gpipe']!r}, 1f1b "
                                 f"{losses['1f1b']!r} (rtol {PP_SCHED_RTOL:g})")
        log(f"[p2] {name}: gpipe and 1f1b f32 losses {rel:.2e} apart (gate {PP_SCHED_RTOL:g}); "
            f"set-up {max(r['setup_s'] for r in per):.1f} s")
        if name == "resnet":
            res = per[0]["resume"]
            for rank, r in enumerate(per):
                if r["resume"]["resumed_loss"] != res["loss"] or r["resume"]["step"] != 1:
                    raise AssertionError(f"rank {rank}: resumed step {r['resume']}, want loss "
                                         f"{res['loss']!r} at step 1")
            log(f"[p2] ResNet-{PIPE_RESNET_DEPTH} gpipe checkpoint {res['bytes']} bytes, save "
                f"{res['save_s']:.2f} s, restore {max(r['resume']['restore_s'] for r in per):.2f} s;"
                f" resumed step's loss {res['resumed_loss']!r}, bit-equal on every rank")
    return {name: ranks[0][name]["trainer"][1] for name in pp_builders()}


# -- the benchmark twins, run in a phase's own world ----------------------------

def _free_ports(n: int) -> list:
    """``n`` distinct free TCP ports on this host: a twin run's
    ``MASTER_PORT`` each."""
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _twin_specs(runs, tmp) -> list:
    """``runs`` ((path, twin module under ``mpi4dl_tpu_torch.benchmarks``,
    ranks, argv, environment)) made ready for :func:`_launched_twins`: each
    gets a ``MPI4DL_TPU_RUN_REPORT`` folder under ``tmp``, ResNet-v2 at
    ``PIPE_RESNET_DEPTH`` (``MPI4DL_TPU_RESNET_N``) and a free ``MASTER_PORT``. Returns
    (path, twin, ranks, argv, environment, port, report folder) each."""
    out = []
    for (path, twin, n_ranks, argv, env), port in zip(runs, _free_ports(len(runs))):
        report = os.path.join(tmp, path)
        out.append((path, twin, n_ranks, argv,
                    dict(env, MPI4DL_TPU_RUN_REPORT=report, MPI4DL_TPU_RESNET_N=str(PIPE_RESNET_N)),
                    port, report))
    return out


def _worker_twins(twins) -> list:
    """What a rank needs of :func:`_twin_specs`'s runs: (twin, argv,
    environment, port) each."""
    return [(twin, argv, env, port) for _, twin, _, argv, env, port, _ in twins]


def _twin_argv(flags, model, steps, layers=PIPE_LAYERS) -> list:
    """A twin's arguments: ``flags``, the image size, ``--max-steps steps``,
    ``--verbose``, and AmoebaNet-D's ``layers`` and filters."""
    extra = (["--num-layers", str(layers), "--num-filters", str(FILTERS)]
             if model == "amoebanet" else [])
    return [*flags, "--image-size", str(SIZE), "--max-steps", str(steps), "--verbose", *extra]


def _launched_twins(rank, world, twins) -> list:
    """The twin runs ``twins`` ((twin, argv, environment, port) each) in one
    rank of a spawned world, each through the twin module's ``main`` as a
    rank that ``torchrun`` started runs it (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): it joins a process
    group of its own and ends it. The world's group ends first. The ranks
    share the start of their processes, not the twin's set-up. Returns per
    run (this rank's standard output, the seconds of its ``main``, and
    K1-K4's launches in it: every count is set to 0 just before the run)."""
    import importlib
    import io

    import torch
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    out = []
    for twin, argv, env, port in twins:
        saved = dict(os.environ)
        os.environ.update(env, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        buf = io.StringIO()
        counters = _counters()
        for mod in counters.values():
            mod.launch_count = 0
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(buf):
                rc = importlib.import_module(f"mpi4dl_tpu_torch.benchmarks.{twin}").main(argv)
        finally:
            os.environ.clear()
            os.environ.update(saved)
        if rc != 0:
            raise AssertionError(f"{twin}: main returned {rc}: {buf.getvalue()[-2000:]}")
        out.append((buf.getvalue(), time.time() - t0,
                    {name: mod.launch_count for name, mod in counters.items()}))
        gc.collect()  # trainers hold reference cycles
        torch.cuda.empty_cache()
    return out


def _twin_reports(tag, path, twin, n_ranks, report, stdout) -> list:
    """One twin run's outcome: its closing Mean/Median/MFU line in rank 0's
    ``stdout`` (every line logged under ``tag``), and its ranks' run
    reports, which it returns."""
    name = twin.split(".")[-1]
    final = [ln for ln in stdout.splitlines() if ln.startswith(f"{name}: Mean")]
    if not final or "MFU" not in final[-1]:
        raise AssertionError(f"{path}: no Mean/Median/MFU line: {stdout[-2000:]}")
    for ln in stdout.splitlines():
        log(f"[{tag}] {path}: {ln}")
    reports = []
    for r in range(n_ranks):
        with open(os.path.join(report, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def _p1_runs() -> list:
    """Phase p1's twin runs: each LP twin under each schedule."""
    return [(path, f"layer_parallelism.benchmark_{name}_lp", PP_RANKS,
             _twin_argv(["--batch-size", str(PP_BATCH), "--parts", str(PP_PARTS),
                         "--split-size", str(PP_RANKS)], name, PP_STEPS),
             {"MPI4DL_TPU_PIPELINE_SCHEDULE": schedule})
            for path, (name, schedule) in PP_PATHS.items()]


def _pp_path_report(path, reports, desc, want, launches, ips, cards, note):
    """Check and print one pipeline path's bf16 run from its ranks' records
    (the ``MPI4DL_TPU_RUN_REPORT`` form): finite losses, every kernel of the
    path launched, K1-K3 a step summed over the ranks equal to ``want`` (the
    Trainer's); records the run's launches, img/s and cards."""
    import torch

    steps = reports[0]["counted_steps"]
    losses = reports[0]["losses"]
    if steps != PP_STEPS - 1 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{path}: {steps} counted steps, losses {losses}")
    runs = {k: sum(r["launches"][mod] for r in reports)
            for k, mod in (("pool_bwd", "pool_kernel"), ("wgrad", "wgrad_kernel"),
                           ("dot1x1_bwd", "dot1x1_kernel"), ("halo_swap", "halo_kernel"))}
    for k in PATH_KERNELS[path]:
        if runs[k] == 0 or runs[k] % steps:
            raise AssertionError(f"{path}: {k} launched {runs[k]} times in {steps} steps")
    per_step = {k: runs[k] // steps for k in want}
    if per_step != want:
        raise AssertionError(f"{path}: K1-K3 a step summed over the ranks {per_step}, "
                             f"Trainer(grad_accum={PP_PARTS}) {want}")
    launches[path] = runs
    # A step's time is its slowest rank's.
    step_s = [max(r["step_s"][i] for r in reports) for i in range(1, PP_STEPS)]
    ms = sorted(step_s)[len(step_s) // 2] * 1e3
    ips[path] = PP_BATCH / (ms / 1e3)
    cards[path] = min(PP_RANKS, torch.cuda.device_count())
    per_rank = "; ".join(
        f"rank {r['rank']}: K1 {r['launches']['pool_kernel'] // steps}, K2 "
        f"{r['launches']['wgrad_kernel'] // steps}, K3 {r['launches']['dot1x1_kernel'] // steps}"
        f" a step, peak {(r['peak_bytes'] or 0) / 2**30:.2f} GiB" for r in reports)
    log(f"[p] {path} ({desc}, transport {reports[0]['transport']}): step {ms:.1f} ms "
        f"(slowest rank; all {[round(t * 1e3, 1) for t in step_s]}; warm-up "
        f"{max(r['step_s'][0] for r in reports) * 1e3:.1f} ms, after "
        f"{max(r['setup_s'] for r in reports):.1f} s of rank set-up), {ips[path]:.3f} img/s; "
        f"analytic bubble {reports[0]['bubble']:.4f}; {per_rank}; losses "
        f"{['%.4f' % v for v in losses]}{note}")


def phase_pipeline_cli(launches, ips, cards, want, twins, outs, desc):
    """Phase p1: each LP twin under each schedule (``MPI4DL_TPU_PIPELINE_
    SCHEDULE``), bf16, ``PP_RANKS`` stages, ``--max-steps PP_STEPS``, run
    through its entry point in phase p's world (:func:`_launched_twins`;
    rank 0's ``outs``). Each run's ranks report through
    ``MPI4DL_TPU_RUN_REPORT`` (:func:`_pp_path_report`); ``want[model]`` is
    the Trainer's K1-K3 a step (phase p2)."""
    for (path, twin, n_ranks, _, _, _, report), (stdout, wall, _) in zip(twins, outs):
        reports = _twin_reports("p1", path, twin, n_ranks, report, stdout)
        _pp_path_report(path, reports, desc, want[PP_PATHS[path][0]], launches, ips, cards,
                        note=f"; through the twin's main, {wall:.1f} s in the world")


# -- phase q: the spatial front ahead of the pipeline (SP+LP) -------------------

def q_batch(n, size, seed=SEED + 3):
    """A batch of ``n`` NHWC f32 images and labels, from the seed with numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, size=(n,)))


def _q_small_model(spatial_cells, grid):
    """Phase q1's model: ResNet-v2 depth 20 @32 (phase s1's), its first
    ``spatial_cells`` cells on ``grid``."""
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2

    return get_resnet_v2(20, 10, spatial_cells=spatial_cells, pool_kernel=8, grid=grid)


def _q_spatial_cells(config, build):
    """The front's cells of ``config`` for the model ``build(0, None)``
    makes (the Trainer's spatial layout: every cell but the head)."""
    import torch

    from mpi4dl_tpu_torch.parallel.pipeline import PipelineTrainer

    with torch.device("meta"):
        n = len(build(0, None))
    if config.split_size == config.spatial_size:
        return n - 1
    return PipelineTrainer.spatial_cell_count(n, config)


def _named_grads(cells, grads=None):
    """Per cell, ``{torch name: numpy}`` of the parameters' ``.grad`` (or of
    ``grads``, per cell ``{name: tensor}``)."""
    if grads is None:
        grads = [{n: p.grad for n, p in c.named_parameters()} for c in cells]
    return [{n: g.detach().float().cpu().numpy() for n, g in cell.items()} for cell in grads]


def _q_trainer(model, config, device, layout, n_spatial, lr=PP_LR):
    """The layout's trainer: ``Trainer`` when every spatial stage is the
    whole split, else ``PipelineTrainer``."""
    from mpi4dl_tpu_torch.parallel.pipeline import PipelineTrainer
    from mpi4dl_tpu_torch.train import Trainer

    if config.split_size == config.spatial_size:
        return Trainer(model, config, learning_rate=lr, device=device,
                       num_spatial_cells=n_spatial, grid=layout.grid)
    return PipelineTrainer(model, config, learning_rate=lr, device=device, layout=layout)


def _q_grads(tr):
    """A step's gradients per cell on rank 0 (a pipeline's are its first
    step's SGD momentum, gathered; collective), None elsewhere."""
    import torch.distributed as dist

    if getattr(tr, "is_pipeline", False):
        got = tr.unstack_params("momentum")
        return None if got is None else _named_grads(None, got)
    return _named_grads(tr.model) if dist.get_rank() == 0 else None


def _local_dp_reference(model, n_front, x, y, parts, ldp, device):
    """LOCAL_DP_LP's step on one device (the JAX golden's grouping,
    ``tests/test_pipeline.py:160-211``): each micro-batch's front over the
    whole micro-batch, the back over each of its ``ldp`` slices; the summed
    cross-entropy over the batch. Returns (loss, per-cell gradients)."""
    import torch

    from mpi4dl_tpu_torch.train import cross_entropy_sum

    model = model.to(device)
    x = torch.as_tensor(x).to(device).permute(0, 3, 1, 2).contiguous()
    y = torch.as_tensor(y).to(device, torch.long)
    b = x.shape[0]
    mb = b // parts
    total = 0.0
    for g in range(parts):
        h = x[g * mb:(g + 1) * mb]
        for i in range(n_front):
            h = model[i](h)
        k = mb // ldp
        for d in range(ldp):
            hs = h[d * k:(d + 1) * k]
            for i in range(n_front, len(model)):
                hs = model[i](hs)
            loss = cross_entropy_sum(hs, y[g * mb + d * k:g * mb + (d + 1) * k]) / b
            loss.backward(retain_graph=True)
            total += float(loss.detach())
    return total, _named_grads(model)


# q1: (name, config fields, batch); every one on Q_RANKS ranks.
Q_RANKS = 4
Q_SMALL = [
    ("SP+LP vertical 2 x split 3", dict(batch_size=2, parts=2, split_size=3, spatial_size=1,
                                        num_spatial_parts=2, slice_method="vertical")),
    ("LOCAL_DP_LP square 4 x split 2", dict(batch_size=8, parts=1, split_size=2,
                                            spatial_size=1, num_spatial_parts=4,
                                            slice_method="square", local_dp=4)),
    ("SP+DP vertical 2 x DP 2", dict(batch_size=4, split_size=1, spatial_size=1,
                                     num_spatial_parts=2, slice_method="vertical",
                                     data_parallel=2)),
    ("skewed SP (4, 2) x split 3", dict(batch_size=2, parts=2, split_size=3, spatial_size=2,
                                        num_spatial_parts=(4, 2), slice_method="square")),
]
# q2 and q3's layout: vertical 2 tiles, split 3 (2 pipeline stages), batch 2
# in 2 micro-batches; q3's steps (the first not counted).
Q_CONFIG = dict(batch_size=2, parts=2, split_size=3, spatial_size=1, num_spatial_parts=2,
                slice_method="vertical")
Q_STEPS = 2
# q3: path -> (model, CLI flags beyond the image size); AmoebaNet-D at
# ``PIPE_LAYERS``.
Q_CLI = {
    "resnet_sp_lp": ("resnet", ["--batch-size", "2", "--parts", "2", "--split-size", "3",
                                "--spatial-size", "1", "--num-spatial-parts", "2",
                                "--slice-method", "vertical"]),
    "amoebanet_sp_lp": ("amoebanet", ["--batch-size", "2", "--parts", "2", "--split-size", "3",
                                      "--spatial-size", "1", "--num-spatial-parts", "2",
                                      "--slice-method", "vertical"]),
    "resnet_local_dp": ("resnet", ["--batch-size", "4", "--parts", "1", "--split-size", "2",
                                   "--spatial-size", "1", "--num-spatial-parts", "4",
                                   "--slice-method", "square", "--local-DP", "4"]),
}
PATH_KERNELS.update({path: _MODEL_KERNELS[m] + ("halo_swap",) for path, (m, _) in Q_CLI.items()})
STEPS_IN_RUN.update(dict.fromkeys(Q_CLI, Q_STEPS - 1))
# q2 holds the SP+LP step's loss and gradients, the front's and each virtual
# stage's, to the spatial Trainer(grad_accum=2) on pipe coordinate 0's tile
# grid (its front on the same tiles, so the same f32 sums), and its loss to
# Trainer(grad_accum=2)'s on one device. Against the one-device step the f32
# gradients also move with the order of the tiles' sums (halo convs, BN
# moments averaged over the tiles), amplified through the untrained model:
# AmoebaNet-D 18L/416F @1024 read 0.27-0.46 a stage there on an H100,
# ResNet-110 8.6e-3 at most. Those are gated for these models only.
Q_GRAD_GATED = ("resnet",)
# q2's f32 first steps are recorded under these paths for phases d-g.
Q_F32_PATHS = {"resnet": "resnet_sp_lp_f32", "amoebanet": "amoebanet_sp_lp_f32"}
PATH_KERNELS.update({path: _MODEL_KERNELS[m] + ("halo_swap",) for m, path in Q_F32_PATHS.items()})


def _q_small(rank, device):
    """Phase q1 in one rank: each small layout's f32 step on the card
    (rank 0 returns (loss, per-cell gradients) of each), then rank 0 takes
    the port's CPU step of the same weights and batch (``Trainer(grad_accum=
    parts·D)``, or LOCAL_DP_LP's grouping) while the other ranks wait."""
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.ops.halo_kernel import close_rings
    from mpi4dl_tpu_torch.parallel.multihost import RankLayout
    from mpi4dl_tpu_torch.train import Trainer

    out = []
    for name, fields in Q_SMALL:
        cfg = ParallelConfig(image_size=32, **fields)
        n_sp = _q_spatial_cells(cfg, _q_small_model)
        x, y = q_batch(cfg.batch_size, 32)
        layout = RankLayout(cfg.mesh_shape)
        model = _seeded(_q_small_model(n_sp, layout.grid))
        tr = _q_trainer(model, cfg, device, layout, n_sp)
        dist.barrier()
        loss = float(tr.train_step(x, y)["loss"])
        got = _q_grads(tr)
        close_rings(layout.grid)
        del tr, model
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            plain = _seeded(_q_small_model(0, None))
            if cfg.local_dp > 1:
                want = _local_dp_reference(plain, n_sp, x, y, cfg.parts, cfg.local_dp, "cpu")
            else:
                ref = Trainer(plain, ParallelConfig(batch_size=cfg.batch_size, image_size=32),
                              learning_rate=PP_LR, device="cpu",
                              grad_accum=cfg.parts * cfg.data_parallel)
                want = (float(ref.train_step(x, y)["loss"]), _named_grads(ref.model))
            out.append((name, (loss, got), want))
        dist.barrier()
    return out


def _q_full(rank, device, shapes_by_model):
    """Phase q2 in one rank: per model, rank 0 first takes
    ``Trainer(grad_accum=2)``'s f32 step on one device (the other ranks
    wait), then the ranks of pipe coordinate 0 (one tile grid) the spatial
    ``Trainer(grad_accum=2)``'s on that grid (the front's cells on the
    tiles, the rest joined; ``Q_RANKS / tiles`` of the card each), then
    every rank the SP+LP pipeline's f32 step on the same weights and batch,
    with its K1-K4 call shapes recorded (``shapes_by_model``) and its
    launches counted (the back stages' apart: those of its backward ticks)."""
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.ops.halo_kernel import close_rings
    from mpi4dl_tpu_torch.parallel.multihost import RankLayout
    from mpi4dl_tpu_torch.parallel.pipeline import PipelineTrainer
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import meta_built

    cfg = ParallelConfig(image_size=SIZE, **Q_CONFIG)
    spatial_cfg = ParallelConfig(image_size=SIZE, batch_size=cfg.batch_size, split_size=1,
                                 spatial_size=1, num_spatial_parts=cfg.num_spatial_parts,
                                 slice_method=cfg.slice_method)
    layout = RankLayout(cfg.mesh_shape)
    tiles = len(layout.grid.ranks)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    x = torch.randn((cfg.batch_size, SIZE, SIZE, 3), generator=gen, device=device)
    y = torch.randint(0, 10, (cfg.batch_size,), generator=gen, device=device)
    counters = _counters()
    out = {}
    for name, build in pp_builders().items():
        res = {}
        t0 = time.time()
        with torch.device("meta"):
            n_sp = PipelineTrainer.spatial_cell_count(len(build(torch.float32)), cfg)
        if rank == 0:
            with whole_card(device):
                model = _seeded(meta_built(build, torch.float32))
                ref = Trainer(model, ParallelConfig(batch_size=cfg.batch_size, image_size=SIZE),
                              learning_rate=PP_LR, device=device, grad_accum=cfg.parts)
                for mod in counters.values():
                    mod.launch_count = 0
                res["trainer_loss"] = float(ref.train_step(x, y)["loss"])
                res["trainer_launches"] = {k: counters[k].launch_count
                                           for k in ("pool_bwd", "wgrad", "dot1x1_bwd")}
                want_plain = _named_grads(ref.model)
                del ref, model
        dist.barrier()
        if layout.p == 0:
            with whole_card(device, share=tiles / Q_RANKS):
                model = _seeded(meta_built(_q_full_model, name, n_sp, layout.grid))
                ref = Trainer(model, spatial_cfg, learning_rate=PP_LR, device=device,
                              grad_accum=cfg.parts, num_spatial_cells=n_sp, grid=layout.grid)
                res["spatial_loss"] = float(ref.train_step(x, y)["loss"])
                want = _named_grads(ref.model) if rank == 0 else None
                close_rings(layout.grid)
                del ref, model
        dist.barrier()
        model = _seeded(meta_built(_q_full_model, name, n_sp, layout.grid))
        tr = PipelineTrainer(model, cfg, learning_rate=PP_LR, device=device, layout=layout)
        res["setup_s"] = time.time() - t0
        back = collections.Counter()
        tr.on_tick = _q_back_probe(back, counters)
        for mod in counters.values():
            mod.launch_count = 0
        restore = _record_shapes(shapes_by_model[name])
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        dist.barrier()
        t0 = time.time()
        try:
            res["loss"] = float(tr.train_step(x, y)["loss"])
        finally:
            for undo in restore:
                undo()
        res["step_s"] = time.time() - t0
        res["launches"] = {k: mod.launch_count for k, mod in counters.items()}
        res["back_launches"] = dict(back)
        res["peak_bytes"] = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                             else 0)
        got = _q_grads(tr)
        if rank == 0:
            stages = [list(range(tr.n_spatial_cells))] + tr.stages
            res["grad_err"] = _stage_errors(got, want, stages)
            res["grad_err_plain"] = _stage_errors(got, want_plain, stages)
            del want, want_plain
        del got, tr, model
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = res
    close_rings(layout.grid)
    return out


def _q_full_model(name, spatial_cells, grid):
    """Phase p's model ``name`` in f32 with its first ``spatial_cells`` cells
    on ``grid``."""
    import torch

    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2

    if name == "amoebanet":
        return amoebanetd(10, PIPE_LAYERS, FILTERS, spatial_cells=spatial_cells, grid=grid,
                          dtype=torch.float32)
    return get_resnet_v2(PIPE_RESNET_DEPTH, 10, pool_kernel=SIZE // 4,
                         spatial_cells=spatial_cells, grid=grid, dtype=torch.float32)


def _q_back_probe(box, counters):
    """A ``PipelineTrainer.on_tick`` that adds the K1-K3 launches of every
    backward tick (the back stages' backward) into the Counter ``box``."""
    import contextlib

    @contextlib.contextmanager
    def tick(direction, t, work):
        before = {k: counters[k].launch_count for k in ("pool_bwd", "wgrad", "dot1x1_bwd")}
        yield
        if direction == "bwd":
            for k, n in before.items():
                box[k] += counters[k].launch_count - n

    return tick


def _q_worker(rank, world, twins):
    """Phases q1 and q2 in one rank of the 4-rank world, then g1's SP
    layouts (:func:`_g_small`), then the twin runs ``twins``, q3's and g3's
    SP+GEMS ones (:func:`_launched_twins`)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = (torch.device("cuda", torch.cuda.current_device()) if DEVICE == "cuda"
              else torch.device(DEVICE))
    t0 = time.time()
    small = _q_small(rank, device)
    small_s = time.time() - t0
    shapes = {name: _new_calls() for name in pp_builders()}
    full = _q_full(rank, device, shapes)
    t0 = time.time()
    g_small = _g_small(rank, device, G_SMALL_SP)
    return {"small": small, "small_s": small_s, "full": full, "shapes": shapes,
            "g_small": g_small, "g_small_s": time.time() - t0,
            "twins": _launched_twins(rank, world, twins)}


def phase_sp_lp(calls, launches, ips, cards, g_want):
    """Phase q with phase g's 4-rank part: spawn the 4-rank world
    (:func:`_q_worker`), then check q1 and q2 (:func:`phase_sp_lp_gates`),
    q3 (:func:`phase_sp_lp_cli`), g1's SP layouts
    (:func:`phase_gems_small`) and g3's SP+GEMS twins
    (:func:`phase_gems_cli`, held to ``g_want``: phase p's g2 launches)."""
    import torch

    from mpi4dl_tpu_torch.benchmarks.common import rank_layout
    from mpi4dl_tpu_torch.parallel import multihost

    backend, desc, env = rank_layout(Q_RANKS, DEVICE)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="mpi4dl-q-") as tmp:
        n_q3 = len(Q_CLI)
        twins = _twin_specs(
            [(path, f"spatial_parallelism.benchmark_{name}_sp", Q_RANKS,
              _twin_argv(flags, name, Q_STEPS), {}) for path, (name, flags) in Q_CLI.items()]
            + _g3_runs(Q_RANKS), tmp)
        ranks = multihost.spawn(_q_worker, Q_RANKS, args=(_worker_twins(twins),),
                                backend=backend, timeout=900, env=env)
        outs = ranks[0]["twins"]
        log(f"[q] {desc}: q1, q2, g1's SP layouts, q3's {n_q3} and g3's {len(twins) - n_q3} twin "
            f"runs in {time.time() - t0:.1f} s (q1 {ranks[0]['small_s']:.1f} s, g1 "
            f"{ranks[0]['g_small_s']:.1f} s)")
        phase_sp_lp_gates(calls, ranks)
        phase_sp_lp_cli(launches, ips, cards, twins[:n_q3], outs[:n_q3], desc)
        phase_gems_small(ranks[0]["g_small"])
        phase_gems_cli(launches, ips, cards, g_want, twins[n_q3:], outs[n_q3:], desc)


def phase_sp_lp_gates(calls, ranks):
    """Phases q1 and q2: hold each layout to its CPU or single-device
    reference from the ranks' records (:func:`_q_worker`), and count q2's
    call shapes (summed over the ranks) into ``calls[Q_F32_PATHS[model]]``."""
    from mpi4dl_tpu_torch.config import ParallelConfig

    for name, got, want in ranks[0]["small"]:
        worst = check_small(f"q1 {name}", got, want)
        log(f"[q1] {name}, ResNet-v2 depth 20 @32 f32: loss card {got[0]:.6f} CPU "
            f"{want[0]:.6f}; gradients normalised max|err| {worst:.2e} (tolerance "
            f"{SMALL_GRAD_TOL:g})")
    th, tw = ParallelConfig(image_size=SIZE, **Q_CONFIG).tile_shape
    tiles = th * tw
    for name in pp_builders():
        per = [r["full"][name] for r in ranks]
        path = Q_F32_PATHS[name]
        calls[path] = _new_calls()
        for r in ranks:
            for k, c in r["shapes"][name].items():
                calls[path][k].update(c)
        want_loss, want_launch = per[0]["trainer_loss"], per[0]["trainer_launches"]
        loss, spatial_loss = per[0]["loss"], per[0]["spatial_loss"]
        if any(r["loss"] != loss for r in per):
            raise AssertionError(f"q2 {name}: the ranks' losses differ: {[r['loss'] for r in per]}")
        for what, want_l in (("one device", want_loss), ("spatial", spatial_loss)):
            if not abs(loss - want_l) <= PP_LOSS_RTOL * abs(want_l):
                raise AssertionError(f"q2 {name}: f32 first-step loss {loss!r}, Trainer(grad_"
                                     f"accum={Q_CONFIG['parts']}) ({what}) {want_l!r}")
        grad_err, grad_err_plain = per[0]["grad_err"], per[0]["grad_err_plain"]
        for what, errs in (("the spatial", grad_err), ("the one-device", grad_err_plain)):
            if (what == "the spatial" or name in Q_GRAD_GATED) and not all(
                    e <= PP_GRAD_TOL for e in errs):
                raise AssertionError(f"q2 {name}: the front's and each virtual stage's gradients "
                                     f"{errs} (L2, relative) from {what} Trainer(grad_accum="
                                     f"{Q_CONFIG['parts']})'s (tolerance {PP_GRAD_TOL:g})")
        got = {k: sum(r["launches"][k] for r in per) for k in want_launch}
        back = {k: sum(r["back_launches"].get(k, 0) for r in per) for k in want_launch}
        want = {k: tiles * n for k, n in want_launch.items()}
        for k in PATH_KERNELS[path]:
            for rank, r in enumerate(per):
                if k == "halo_swap" and not r["launches"][k]:
                    raise AssertionError(f"q2 {name} rank {rank}: K4 did not launch")
            if k != "halo_swap" and not got[k]:
                raise AssertionError(f"q2 {name}: {k} did not launch")
        if got != want:
            raise AssertionError(f"q2 {name}: K1-K3 summed over the ranks {got}, want {tiles} "
                                 f"tiles x the Trainer's {want_launch} (the front once a "
                                 f"micro-batch on each tile, the back on each tile rank)")
        log(f"[q2] {name} SP+LP ({Q_CONFIG['num_spatial_parts']} {Q_CONFIG['slice_method']} "
            f"tiles x {Q_CONFIG['split_size'] - 1} stages, batch {Q_CONFIG['batch_size']}, "
            f"parts {Q_CONFIG['parts']}) f32: first-step loss {loss:.7f} (Trainer(grad_accum="
            f"{Q_CONFIG['parts']}) spatial {spatial_loss:.7f}, rel "
            f"{abs(loss - spatial_loss) / abs(spatial_loss):.2e}; one device {want_loss:.7f}, rel "
            f"{abs(loss - want_loss) / abs(want_loss):.2e}; gate {PP_LOSS_RTOL:g}); front and "
            f"virtual stages' gradients {['%.2e' % e for e in grad_err]} from the spatial "
            f"Trainer's (gate {PP_GRAD_TOL:g}), {['%.2e' % e for e in grad_err_plain]} from the "
            f"one-device Trainer's ("
            f"{'gate %g' % PP_GRAD_TOL if name in Q_GRAD_GATED else 'not gated: Q_GRAD_GATED'})"
            f"; K1-K3 "
            f"summed over the ranks {got} = {tiles} x the Trainer's {want_launch} (back stages "
            f"{back}, front {({k: got[k] - back[k] for k in got})}); K4 per rank "
            f"{[r['launches']['halo_swap'] for r in per]}; step "
            f"{max(r['step_s'] for r in per):.1f} s, set-up {max(r['setup_s'] for r in per):.1f}"
            f" s; peak per rank {[round(r['peak_bytes'] / 2**30, 2) for r in per]} GiB")


def phase_sp_lp_cli(launches, ips, cards, twins, outs, desc):
    """Phase q3: each SP twin run (bf16, ``--max-steps Q_STEPS``,
    ``MPI4DL_TPU_RUN_REPORT``) through its entry point in phase q's world
    (:func:`_launched_twins`; rank 0's ``outs``): its Mean/Median/MFU line;
    from the ranks' records the step (slowest rank), img/s, per-rank
    launches and peak memory, and the transport."""
    import torch

    for (path, twin, n_ranks, argv, _, _, report), (stdout, wall, _) in zip(twins, outs):
        reports = _twin_reports("q3", path, twin, n_ranks, report, stdout)
        steps = reports[0]["counted_steps"]
        losses = reports[0]["losses"]
        if steps != Q_STEPS - 1 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{path}: {steps} counted steps, losses {losses}")
        runs = {k: sum(r["launches"][mod] for r in reports)
                for k, mod in (("pool_bwd", "pool_kernel"), ("wgrad", "wgrad_kernel"),
                               ("dot1x1_bwd", "dot1x1_kernel"), ("halo_swap", "halo_kernel"))}
        for k in PATH_KERNELS[path]:
            if runs[k] == 0 or runs[k] % steps:
                raise AssertionError(f"{path}: {k} launched {runs[k]} times in {steps} steps")
        for r in reports:
            if "halo_swap" in PATH_KERNELS[path] and not r["launches"]["halo_kernel"]:
                raise AssertionError(f"{path}: K4 did not launch on rank {r['rank']}")
        launches[path] = runs
        step_s = [max(r["step_s"][i] for r in reports) for i in range(1, Q_STEPS)]
        ms = sorted(step_s)[len(step_s) // 2] * 1e3
        batch = int(argv[argv.index("--batch-size") + 1])
        ips[path] = batch / (ms / 1e3)
        cards[path] = min(n_ranks, torch.cuda.device_count())
        per_rank = "; ".join(
            f"rank {r['rank']}: K1 {r['launches']['pool_kernel'] // steps}, K2 "
            f"{r['launches']['wgrad_kernel'] // steps}, K3 {r['launches']['dot1x1_kernel'] // steps}"
            f", K4 {r['launches']['halo_kernel'] // steps} a step, peak "
            f"{(r['peak_bytes'] or 0) / 2**30:.2f} GiB" for r in reports)
        log(f"[q3] {path} ({desc}, transport {reports[0]['transport']}): step {ms:.1f} ms "
            f"(slowest rank; all {[round(t * 1e3, 1) for t in step_s]}; warm-up "
            f"{max(r['step_s'][0] for r in reports) * 1e3:.1f} ms, after "
            f"{max(r['setup_s'] for r in reports):.1f} s of rank set-up), {ips[path]:.3f} img/s; "
            f"analytic bubble {reports[0]['bubble']}; {per_rank}; losses "
            f"{['%.4f' % v for v in losses]}; through the twin's main, {wall:.1f} s in the "
            f"world")


# -- phase g: GEMS-MASTER, the pipeline in both directions ----------------------

# g1: small f32 layouts, (name, config fields, trainer kind), ResNet-v2
# depth 20 @32 from the seed; the LP ones on G_RANKS ranks, the SP one on
# Q_RANKS.
G_RANKS = 2
G_SMALL_LP = [
    ("LP GEMS split 2, times 1", dict(batch_size=2, parts=2, split_size=2, times=1), "gems"),
    # Four chunks of one image: the images of times 1. Of @32's first 8, one
    # has a single-image BN gradient that f32 gets ~10% off float64 in a leaf
    # of ResNet-v2's third stack (either layout, on the CPU), which a
    # per-leaf gate cannot hold.
    ("LP GEMS split 2, times 2", dict(batch_size=1, parts=1, split_size=2, times=2), "gems"),
    ("the mirror placement alone, split 2", dict(batch_size=2, parts=2, split_size=2),
     "mirror"),
]
# SP+GEMS twice: two chunks of one image (q1's two images) held per leaf,
# and two chunks of 2 images in 2 micro-batches (4 images: g2 and g3's
# shape) held per stage in relative L2 (``PP_GRAD_TOL``): through the tiles'
# f32 sums a per-leaf gate does not hold there (an H100 read 0.0965 of a
# leaf where the LP layouts on the same 4 images read 5.4e-6).
_G_SP = dict(split_size=3, spatial_size=1, num_spatial_parts=2, slice_method="vertical",
             times=1)
G_SMALL_SP = [
    ("SP+GEMS vertical 2 x split 3, 2 chunks of 1 image", dict(_G_SP, batch_size=1, parts=1),
     "gems"),
    ("SP+GEMS vertical 2 x split 3, 2 chunks of 2 images", dict(_G_SP, batch_size=2, parts=2),
     "gems_stages"),
]
# g2 and g3's LP layout: split 2, ``times`` 1, a chunk of 2 images in 2
# micro-batches, so 4 images a step: phase p's batch (``PP_BATCH``) in as
# many micro-batches (``PP_PARTS``), on which g2's references, phase p's
# ``PipelineTrainer(parts=4)`` and ``Trainer(grad_accum=4)``, run.
G_CONFIG = dict(batch_size=2, parts=2, split_size=G_RANKS, times=1)
G_CHUNKS = 2 * G_CONFIG["times"]
if (G_RANKS, G_CHUNKS * G_CONFIG["batch_size"], G_CHUNKS * G_CONFIG["parts"]) != (
        PP_RANKS, PP_BATCH, PP_PARTS):
    raise AssertionError("g2's references take phase p's ranks, batch and micro-batches")
# g2: GEMS's f32 loss against PipelineTrainer(parts=4)'s on the same 4 images,
# relative (the same micro-batches, BN over each; the sums of the loss and of
# the mirrored stages' gradients associate otherwise).
G_PP_LOSS_RTOL = 1e-6
G_STEPS = 2
# g3: path -> (model, twin module, ranks, CLI flags beyond the image size).
_G_SP_FLAGS = ["--batch-size", "2", "--parts", "2", "--split-size", "3", "--spatial-size", "1",
               "--num-spatial-parts", "2", "--slice-method", "vertical", "--times", "1"]
_G_LP_FLAGS = ["--batch-size", "2", "--parts", "2", "--split-size", str(G_RANKS),
               "--times", "1"]
G_CLI = {
    "resnet_gems": ("resnet", "gems_master_model.benchmark_resnet_gems_master", G_RANKS,
                    _G_LP_FLAGS),
    "amoebanet_gems": ("amoebanet", "gems_master_model.benchmark_amoebanet_gems_master",
                       G_RANKS, _G_LP_FLAGS),
    "resnet_gems_sp": ("resnet", "gems_master_with_spatial_parallelism."
                       "benchmark_resnet_gems_master_with_sp", Q_RANKS, _G_SP_FLAGS),
    "amoebanet_gems_sp": ("amoebanet", "gems_master_with_spatial_parallelism."
                          "benchmark_amoebanet_gems_master_with_sp", Q_RANKS, _G_SP_FLAGS),
}
PATH_KERNELS.update({path: _MODEL_KERNELS[m] + (("halo_swap",) if ranks == Q_RANKS else ())
                     for path, (m, _, ranks, _) in G_CLI.items()})
STEPS_IN_RUN.update(dict.fromkeys(G_CLI, G_STEPS - 1))
# g2's f32 GEMS steps are recorded under these paths for phases d-g.
G_F32_PATHS = {"resnet": "resnet_gems_f32", "amoebanet": "amoebanet_gems_f32"}
PATH_KERNELS.update({path: _MODEL_KERNELS[m] for m, path in G_F32_PATHS.items()})


def _g_small(rank, device, cases):
    """Phase g1 in one rank: each small layout's f32 step on the card (rank
    0 returns its (loss, per-cell gradients), the gradients a pipeline's
    first-step SGD momentum gathered to rank 0), then rank 0 takes the
    port's CPU ``Trainer(grad_accum=chunks·parts)`` step of the same weights
    on the same ``chunks·batch`` rows while the other ranks wait."""
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.ops.halo_kernel import close_rings
    from mpi4dl_tpu_torch.parallel.multihost import RankLayout
    from mpi4dl_tpu_torch.parallel.pipeline import GemsMasterTrainer, PipelineTrainer
    from mpi4dl_tpu_torch.train import Trainer

    out = []
    for name, fields, kind in cases:
        cfg = ParallelConfig(image_size=32, **fields)
        chunks = 2 * cfg.times if kind.startswith("gems") else 1
        n_sp = _q_spatial_cells(cfg, _q_small_model)
        x, y = q_batch(chunks * cfg.batch_size, 32)
        layout = RankLayout(cfg.mesh_shape)
        model = _seeded(_q_small_model(n_sp, layout.grid))
        if kind.startswith("gems"):
            tr = GemsMasterTrainer(model, cfg, learning_rate=PP_LR, device=device,
                                   layout=layout)
        else:
            tr = PipelineTrainer(model, cfg, learning_rate=PP_LR, device=device, layout=layout,
                                 mirror=True)
        stages = [list(range(tr.n_spatial_cells))] * bool(tr.n_spatial_cells) + tr.stages
        dist.barrier()
        loss = float(tr.train_step(x, y)["loss"])
        got = _q_grads(tr)
        close_rings(layout.grid)
        del tr, model
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            plain = _seeded(_q_small_model(0, None))
            ref = Trainer(plain, ParallelConfig(batch_size=chunks * cfg.batch_size,
                                                image_size=32),
                          learning_rate=PP_LR, device="cpu", grad_accum=chunks * cfg.parts)
            want = (float(ref.train_step(x, y)["loss"]), _named_grads(ref.model))
            out.append((name, kind, stages, (loss, got), want))
        dist.barrier()
    return out


def _g_gems_step(model, start, device, x, y):
    """g2's GEMS step (``G_CONFIG``: 2 chunks of 2 of phase p's 4 images)
    from the weights ``start``, its call shapes recorded: ``({"g_shapes",
    "gems": (loss, K1-K3 launches, seconds)}, (gradients, stages))``."""
    import torch.distributed as dist

    from mpi4dl_tpu_torch.config import ParallelConfig

    res = {"g_shapes": _new_calls()}
    model.load_state_dict(start)
    dist.barrier()
    t0 = time.time()
    loss, launches, g, stages = _pp_step(model, ParallelConfig(image_size=SIZE, **G_CONFIG),
                                         device, x, y, gems=True, shapes=res["g_shapes"])
    res["gems"] = (loss, launches, time.time() - t0)
    return res, (g, stages)


def _g3_runs(n_ranks) -> list:
    """Phase g3's twin runs on ``n_ranks`` ranks (``G_CLI``), for
    :func:`_twin_specs`: the LP ones in phase p's world, the SP+GEMS ones in
    phase q's."""
    return [(path, twin, n, _twin_argv(flags, name, G_STEPS), {})
            for path, (name, twin, n, flags) in G_CLI.items() if n == n_ranks]


def phase_gems_small(small):
    """Phase g1: hold each small layout of ``small`` (rank 0's records,
    :func:`_g_small`) to its CPU reference."""
    for name, kind, stages, got, want in small:
        if kind == "gems_stages":
            if not abs(got[0] - want[0]) <= 1e-4 * abs(want[0]):
                raise AssertionError(f"g1 {name} loss: {got[0]} vs reference {want[0]}")
            errs = _stage_errors(got[1], want[1], stages)
            if not all(e <= PP_GRAD_TOL for e in errs):
                raise AssertionError(f"g1 {name}: the front's and each stage's gradients {errs} "
                                     f"(L2, relative; tolerance {PP_GRAD_TOL:g})")
            worst, leaf = _worst_leaf(f"g1 {name}", got[1], want[1])
            gate = (f"the front's and stages' gradients {['%.2e' % e for e in errs]}, relative "
                    f"L2 (gate {PP_GRAD_TOL:g}); worst leaf {worst:.2e} at {leaf} (not gated)")
        else:
            worst = check_small(f"g1 {name}", got, want)
            gate = f"gradients normalised max|err| {worst:.2e} (tolerance {SMALL_GRAD_TOL:g})"
        log(f"[g1] {name}, ResNet-v2 depth 20 @32 f32: loss card {got[0]:.6f} CPU "
            f"{want[0]:.6f}; {gate}; against the CPU Trainer(grad_accum=chunks x parts)")


def phase_gems_gates(calls, lp_ranks):
    """Phase g2: hold each model's GEMS step in the records ``lp_ranks``
    (phase p's ranks', :func:`_pp_worker`) to its references, and count its
    call shapes (summed over the ranks) into ``calls[G_F32_PATHS[model]]``.
    Returns, per model, the K1-K3 launches of ``Trainer(grad_accum=4)``'s
    step at g3's depth (g2's)."""
    trainer = {}
    for name in pp_builders():
        per = [r[name] for r in lp_ranks]
        path = G_F32_PATHS[name]
        calls[path] = _new_calls()
        for r in per:
            for k, c in r["g_shapes"].items():
                calls[path][k].update(c)
        want_loss, want_launch = per[0]["trainer"]
        loss, pp_loss = per[0]["gems"][0], per[0]["gpipe"][0]
        for what, got_l in (("GEMS", [r["gems"][0] for r in per]),
                            ("PipelineTrainer", [r["gpipe"][0] for r in per])):
            if any(v != got_l[0] for v in got_l):
                raise AssertionError(f"g2 {name} {what}: the ranks' losses differ: {got_l}")
        if not abs(loss - want_loss) <= PP_LOSS_RTOL * abs(want_loss):
            raise AssertionError(f"g2 {name}: GEMS f32 first-step loss {loss!r}, "
                                 f"Trainer(grad_accum=4) {want_loss!r} (rtol {PP_LOSS_RTOL:g})")
        if not abs(loss - pp_loss) <= G_PP_LOSS_RTOL * abs(pp_loss):
            raise AssertionError(f"g2 {name}: GEMS f32 first-step loss {loss!r}, "
                                 f"PipelineTrainer(parts=4) {pp_loss!r} (rtol "
                                 f"{G_PP_LOSS_RTOL:g})")
        grad_err = per[0]["gems_grad_err"]
        if not all(e <= PP_GRAD_TOL for e in grad_err):
            raise AssertionError(f"g2 {name}: each stage's gradients {grad_err} (L2, relative) "
                                 f"from Trainer(grad_accum=4)'s (tolerance {PP_GRAD_TOL:g})")
        got = {k: sum(r["gems"][1][k] for r in per) for k in want_launch}
        if got != want_launch:
            raise AssertionError(f"g2 {name}: GEMS K1-K3 summed over the ranks {got}, "
                                 f"Trainer(grad_accum=4) {want_launch}")
        for k in PATH_KERNELS[path]:
            for rank, r in enumerate(per):
                if not r["gems"][1][k]:
                    raise AssertionError(f"g2 {name} rank {rank}: {k} did not launch")
        trainer[name] = want_launch
        log(f"[g2] {name} GEMS (split {G_RANKS}, 2 chunks of {G_CONFIG['batch_size']} images in "
            f"{G_CONFIG['parts']} micro-batches) f32: first-step loss {loss:.7f} (Trainer(grad_"
            f"accum=4) {want_loss:.7f}, rel {abs(loss - want_loss) / abs(want_loss):.2e}, gate "
            f"{PP_LOSS_RTOL:g}; PipelineTrainer(parts=4) {pp_loss:.7f}, rel "
            f"{abs(loss - pp_loss) / abs(pp_loss):.2e}, gate {G_PP_LOSS_RTOL:g}); stages' "
            f"gradients {['%.2e' % e for e in grad_err]} from the Trainer's, relative L2 (gate "
            f"{PP_GRAD_TOL:g}); K1-K3 per rank {[r['gems'][1] for r in per]}, summed {got} (the "
            f"Trainer's {want_launch}); GEMS step {max(r['gems'][2] for r in per):.1f} s, "
            f"set-up {max(r['setup_s'] for r in per):.1f} s")
    return trainer


def phase_gems_cli(launches, ips, cards, want, twins, outs, desc):
    """Phase g3: each GEMS twin run of ``twins`` (bf16, ``--times 1``,
    ``--max-steps G_STEPS``, ``MPI4DL_TPU_RUN_REPORT``) through its entry
    point in phase p's or q's world (:func:`_launched_twins`; rank 0's
    ``outs``, in order): its Mean/Median/MFU line; every kernel of the path
    launched on every rank; K1-K3 a step summed over the ranks equal to the
    tile count (1 for an LP twin) times ``want[model]``, the launches of
    ``Trainer(grad_accum=4)`` of the twin's model and depth (the front runs
    on each tile, the back on each tile rank); the step (slowest rank),
    img/s (``2·times·batch`` images a step), per-rank launches, peak memory
    and mirror exchange bytes, and the transport."""
    import torch

    for (path, twin, n_ranks, argv, _, _, report), (stdout, wall, _) in zip(twins, outs):
        name = G_CLI[path][0]
        reports = _twin_reports("g3", path, twin, n_ranks, report, stdout)
        steps = reports[0]["counted_steps"]
        losses = reports[0]["losses"]
        if steps != G_STEPS - 1 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{path}: {steps} counted steps, losses {losses}")
        mods = (("pool_bwd", "pool_kernel"), ("wgrad", "wgrad_kernel"),
                ("dot1x1_bwd", "dot1x1_kernel"), ("halo_swap", "halo_kernel"))
        for r in reports:
            for k, mod in mods:
                if k in PATH_KERNELS[path] and (not r["launches"][mod]
                                                or r["launches"][mod] % steps):
                    raise AssertionError(f"{path} rank {r['rank']}: {k} launched "
                                         f"{r['launches'][mod]} times in {steps} steps")
        runs = {k: sum(r["launches"][mod] for r in reports) for k, mod in mods}

        def flag(f, default=0):
            return int(argv[argv.index(f) + 1]) if f in argv else default

        tiles = n_ranks // (flag("--split-size") - flag("--spatial-size"))
        per_step = {k: runs[k] // steps for k in want[name]}
        if per_step != {k: tiles * v for k, v in want[name].items()}:
            raise AssertionError(f"{path}: K1-K3 a step summed over the ranks {per_step}, want "
                                 f"{tiles} x Trainer(grad_accum=4)'s {want[name]}")
        images = reports[0]["images"]
        if images != 2 * flag("--times") * flag("--batch-size"):
            raise AssertionError(f"{path}: {images} images a step, want 2 x times x batch")
        launches[path] = runs
        step_s = [max(r["step_s"][i] for r in reports) for i in range(1, G_STEPS)]
        ms = sorted(step_s)[len(step_s) // 2] * 1e3
        ips[path] = images / (ms / 1e3)
        cards[path] = min(n_ranks, torch.cuda.device_count())
        per_rank = "; ".join(
            f"rank {r['rank']}: K1 {r['launches']['pool_kernel'] // steps}, K2 "
            f"{r['launches']['wgrad_kernel'] // steps}, K3 {r['launches']['dot1x1_kernel'] // steps}"
            f", K4 {r['launches']['halo_kernel'] // steps} a step, peak "
            f"{(r['peak_bytes'] or 0) / 2**30:.2f} GiB, mirror exchange {r['mirror_bytes']} bytes"
            for r in reports)
        log(f"[g3] {path} ({desc}, transport {reports[0]['transport']}): step "
            f"{ms:.1f} ms (slowest rank; all {[round(t * 1e3, 1) for t in step_s]}; warm-up "
            f"{max(r['step_s'][0] for r in reports) * 1e3:.1f} ms, after "
            f"{max(r['setup_s'] for r in reports):.1f} s of rank set-up), {ips[path]:.3f} img/s "
            f"({images} images a step); analytic bubble {reports[0]['bubble']}; K1-K3 summed "
            f"{per_step} = {tiles} x Trainer(grad_accum=4)'s; {per_rank}; losses "
            f"{['%.4f' % v for v in losses]}; through the twin's main, {wall:.1f} s in the "
            f"world")


# -- the run tooling: the halo twins (s9), the supervisor (e), profile_step (t) --

HALO = "communication.halo.benchmark_sp_halo_exchange"
_HALO_TIMED = ["--iterations", "20", "--warmup", "3"]
# Phase s9: (path, twin module under ``mpi4dl_tpu_torch.benchmarks``, argv),
# each at its JAX script's defaults (K4: ``--impl kernel``); the plain arm
# at the reference's documented configuration.
HALO_RUNS = [
    ("halo_exchange", HALO, _HALO_TIMED),
    ("halo_with_compute", f"{HALO}_with_compute", _HALO_TIMED),
    ("halo_with_compute_val", f"{HALO}_with_compute_val", []),
    ("halo_conv", f"{HALO}_conv", []),
    ("halo_exchange_plain", HALO,
     ["--impl", "plain", "--image-size", "1024", "--halo-len", "3", "--slice-method",
      "vertical", "--num-spatial-parts", "4", *_HALO_TIMED]),
]
# The lines each twin prints when every validation passed (and its timing).
HALO_PASSED = {
    HALO: ("validation: PASSED", "halo exchange["),
    f"{HALO}_with_compute": ("validation (weights=1, ref parity trick): EXACT", "halo+conv[",
                             "sequential full-image conv: mean"),
    f"{HALO}_with_compute_val": ("recv-halo validation: PASSED",
                                 "conv validation (weights=bias=1.0): EXACT",
                                 "ALL VALIDATIONS PASSED"),
    f"{HALO}_conv": ("val-recv (kernel 3x3, halo (1,1)): PASSED", "val-conv: max|err|",
                     "val-small-conv: PASSED", "ALL VALIDATIONS PASSED"),
}


def _halo_runs() -> list:
    """Phase s9's runs for :func:`_twin_specs` (``SP_RANKS`` ranks each)."""
    return [(path, twin, SP_RANKS, argv, {}) for path, twin, argv in HALO_RUNS]


def phase_halo_twins(twins, outs) -> dict:
    """Phase s9: the four halo twins (and the raw exchange's plain arm) run
    through their ``main`` in phase s's 4-rank world (:func:`_launched_twins`;
    ``outs`` by rank). Gates: each printed its passed validations, and K4
    launched on every rank of each ``--impl kernel`` run. Returns each run's
    printed median ms (the slowest rank's, CUDA events) by path."""
    medians = {}
    for i, (path, twin, _, argv, _, _, _) in enumerate(twins):
        stdout, wall, _ = outs[0][i]
        for ln in stdout.splitlines():
            log(f"[s9] {path}: {ln}")
        missing = [want for want in HALO_PASSED[twin] if want not in stdout]
        if missing:
            raise AssertionError(f"{path}: no {missing} in {stdout[-2000:]}")
        k4 = [out[i][2]["halo_swap"] for out in outs]
        if "plain" not in argv and not all(k4):
            raise AssertionError(f"{path}: K4 launched {k4} times by rank")
        timed = [ln for ln in stdout.splitlines() if ln.startswith(("halo exchange[", "halo+conv["))]
        if timed:
            medians[path] = float(timed[0].split("median ")[1].split(" ms")[0])
        log(f"[s9] {path}: {wall:.1f} s in the world; K4 launches by rank {k4}")
    smi = card()
    log(f"[s9] halo twins' medians (slowest rank, CUDA events, ms) on {smi}: "
        + ", ".join(f"{path} {ms:.4f}" for path, ms in medians.items()))
    return medians


def phase_halo_world():
    """Phase s9 in a 4-rank world of its own (``--tools-only``: phase s
    does not run)."""
    from mpi4dl_tpu_torch.benchmarks.common import rank_layout
    from mpi4dl_tpu_torch.parallel import multihost

    backend, desc, env = rank_layout(SP_RANKS, DEVICE)
    with tempfile.TemporaryDirectory(prefix="mpi4dl-halo-") as tmp:
        twins = _twin_specs(_halo_runs(), tmp)
        outs = multihost.spawn(_launched_twins, SP_RANKS, args=(_worker_twins(twins),),
                               backend=backend, timeout=900, env=env)
        log(f"[s9] {desc}")
        return phase_halo_twins(twins, outs)


LP_RESNET = "mpi4dl_tpu_torch.benchmarks.layer_parallelism.benchmark_resnet_lp"
E_ARGV = ["--batch-size", "4", "--parts", "2", "--split-size", "2", "--image-size", "64",
          "--max-steps", "4", "--checkpoint-every", "1", "--max-restarts", "1", "--verbose"]
E_ENV = {"MPI4DL_TPU_RESNET_N": "1", "MPI4DL_TPU_CRASH_AT_STEP": "2"}
E_RANKS = 2
# Phase e's spatial twin: ResNet-11 v2 @64 with its front on a 2x2 grid of
# 32 px tiles (split 2, spatial 1: 4 ranks, the back stage on the tile
# ranks), the same supervision, crash and checkpoints as the LP twin's.
SP_RESNET = "mpi4dl_tpu_torch.benchmarks.spatial_parallelism.benchmark_resnet_sp"
E_SP_ARGV = ["--batch-size", "2", "--parts", "2", "--split-size", "2", "--spatial-size", "1",
             "--num-spatial-parts", "4", "--slice-method", "square", "--image-size", "64",
             "--max-steps", "4", "--checkpoint-every", "1", "--max-restarts", "1", "--verbose"]
E_SP_RANKS = 4


def start_supervised(module=LP_RESNET, argv=E_ARGV):
    """Phase e, started: a ResNet twin (``module``: by default the LP one,
    ResNet-11 v2 @64, 2 ranks) supervised on the card as a user starts it,
    a subprocess: ``--max-restarts 1``, every rank exiting at step 2 of the
    fresh run (``MPI4DL_TPU_CRASH_AT_STEP``), a checkpoint every step,
    ``--trace-dir`` and ``MPI4DL_TPU_RUN_REPORT`` (only the run that ends
    writes one). Returns what :func:`finish_supervised` reads. Each twin's
    processes start and end in 54-71 s on an H100 80GB HBM3 at 700 W and
    time nothing."""
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory(prefix="mpi4dl-e-")
    ckpt, traces = os.path.join(tmp.name, "ckpt"), os.path.join(tmp.name, "trace")
    env = dict(os.environ, **E_ENV, MPI4DL_TPU_RUN_REPORT=os.path.join(tmp.name, "report"),
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", module, *argv, "--checkpoint-dir", ckpt,
           "--trace-dir", traces, *([] if DEVICE == "cuda" else ["--device", DEVICE])]
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, time.time()


def _end_supervisor(proc) -> None:
    """End phase e's supervisor if it still runs: an interrupt, on which it
    kills its child and the child's ranks (``elastic.supervise``), then a
    kill."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


def stop_supervised(started) -> None:
    """Phase e abandoned (another phase failed): its processes ended, its
    folder removed."""
    proc, tmp, _ = started
    _end_supervisor(proc)
    tmp.cleanup()


def finish_supervised(started, ranks=E_RANKS, desc="ResNet-11 v2 LP twin @64 (2 ranks",
                      k4=False):
    """Phase e, waited for and checked: exit 0; "restarting (1/1)" and
    "resumed from step 2" printed; the newest checkpoint at step 4; one
    Chrome trace a rank (the crashed run's ranks wrote none), each with
    CUDA kernel events. With ``k4`` (the spatial twin): every rank's run
    report, written by the restarted run, counts K4 launches in its steps
    after the first. Returns the seconds it waited."""
    from mpi4dl_tpu_torch.checkpoint import all_checkpoints
    from mpi4dl_tpu_torch.profile_step import kernel_of, summarize, trace_events

    proc, tmp, t0 = started
    t_wait = time.time()
    with tmp:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            _end_supervisor(proc)
        wall = time.time() - t0
        ckpt, traces = os.path.join(tmp.name, "ckpt"), os.path.join(tmp.name, "trace")
        for ln in stdout.splitlines():
            log(f"[e] {ln}")
        if proc.returncode != 0:
            raise AssertionError(f"phase e exited {proc.returncode}: {stderr[-3000:]}")
        for want in ("restarting (1/1)", "resumed from step 2"):
            if want not in stdout:
                raise AssertionError(f"phase e: no {want!r} in {stdout[-2000:]}")
        steps = [step for step, _ in all_checkpoints(ckpt)]
        if not steps or steps[-1] != 4:
            raise AssertionError(f"phase e: checkpoints at steps {steps}, the newest not 4")
        files = sorted(os.listdir(traces))
        if sorted(f.split("-")[1] for f in files) != sorted(f"rank{r}" for r in range(ranks)):
            raise AssertionError(f"phase e: traces {files}, not one a rank")
        parts = []
        for f in files:
            path = os.path.join(traces, f)
            events = trace_events(path)
            kernels = sum(1 for e in events if e.get("cat") == "kernel")
            if DEVICE == "cuda" and not kernels:
                raise AssertionError(f"phase e: no CUDA kernel events in {f}")
            s = summarize(events)
            mine = collections.Counter()
            for name, (_, count) in s["by_name"].items():
                mine[kernel_of(name)] += count
            parts.append(f"{f.split('-')[1]} {os.path.getsize(path) / 2**20:.1f} MiB, "
                         f"{kernels} kernel events, {s['total_ms']:.1f} ms device self time, "
                         f"K2 {mine['K2 wgrad']} / K3 {mine['K3 dot1x1_bwd']}"
                         + (f" / K4 {mine['K4 halo_swap']}" if k4 else "") + " launches")
        after = ""
        if k4:
            reports = []
            for r in range(ranks):
                with open(os.path.join(tmp.name, "report", f"rank{r}.json")) as fh:
                    reports.append(json.load(fh))
            k4_runs = [rep["launches"]["halo_kernel"] for rep in reports]
            counted = [rep["counted_steps"] for rep in reports]
            if DEVICE == "cuda" and not (all(k4_runs) and all(c >= 1 for c in counted)):
                raise AssertionError(f"phase e: K4 launches after the restart {k4_runs} in "
                                     f"{counted} counted steps a rank")
            after = (f"; K4 launched after the restart, in the restarted run's steps after "
                     f"its first: {k4_runs} a rank over {counted} step(s)")
    waited = time.time() - t_wait
    log(f"[e] supervised {desc}, crash at step 2, --max-restarts 1): exit 0 in {wall:.1f} s "
        f"({waited:.1f} s of it waited for), restarted once, resumed from step 2, checkpoints "
        f"at steps {steps}{after}; traces: {'; '.join(parts)}")
    return waited


def phase_supervised():
    """Phase e (``--tools-only``): the supervised LP twin, then the
    supervised spatial twin (``E_SP_ARGV``, 4 ranks on a 2x2 tile grid,
    whose restarted world opens fresh K4 rings). Returns the seconds."""
    t0 = time.time()
    finish_supervised(start_supervised())
    finish_supervised(start_supervised(SP_RESNET, E_SP_ARGV), ranks=E_SP_RANKS,
                      desc="ResNet-11 v2 SP twin @64 (2x2 tiles of 32 px, split 2, 4 ranks",
                      k4=True)
    return time.time() - t0


T_ARGV = ["--model", "resnet", "--image-size", str(SIZE), "--batch", str(BATCH), "--steps", "2"]
T_WARM = 2  # profile_step's warm-up steps before the traced ones
T_KERNELS = ("wgrad", "dot1x1_bwd")  # launch on ResNet-110's path, in the trace too
_T_SYMBOLS = {"wgrad": "K2 wgrad", "dot1x1_bwd": "K3 dot1x1_bwd"}


def phase_profile_step(launches):
    """Phase t: ``profile_step.main`` on ResNet-110 v2 @1024 bs2 (its
    default ``cell_save``) in this process, K1-K4's counts set to 0 just
    before and read after. Gates: its two ``mpi4dl_capture`` windows each
    hold one ``mpi4dl_train_step``; K2's and K3's kernel events in the trace
    are the traced steps' share of their launches (2 of the 4 steps), the
    same a step as on phase c's ResNet-110 path (``launches``, when phase c
    ran). Prints the report's tables."""
    import io

    from mpi4dl_tpu_torch import profile_step
    from mpi4dl_tpu_torch.analysis.inventory import collective_log

    steps = int(T_ARGV[T_ARGV.index("--steps") + 1])
    counters = _counters()
    for mod in counters.values():
        mod.launch_count = 0
    with tempfile.TemporaryDirectory(prefix="mpi4dl-t-") as out_dir:
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf), collective_log() as clog:
            rc = profile_step.main([*T_ARGV, "--out", out_dir,
                                    *([] if DEVICE == "cuda" else ["--device", DEVICE])])
        wall = time.time() - t0
        counts = {name: mod.launch_count for name, mod in counters.items()}
        if rc != 0:
            raise AssertionError(f"profile_step returned {rc}: {buf.getvalue()[-2000:]}")
        for ln in buf.getvalue().splitlines():
            log(f"[t] {ln}")
        path = profile_step.newest_trace(out_dir)
        events = profile_step.trace_events(path)
        caps = profile_step.step_windows(events, "mpi4dl_capture")
        train = profile_step.step_windows(events, "mpi4dl_train_step")
        inside = [sum(1 for t in train if c[0] <= t[0] and t[1] <= c[1]) for c in caps]
        if [c[2] for c in caps] != list(range(steps)) or inside != [1] * steps:
            raise AssertionError(f"profile_step: capture windows {caps}, train-step windows "
                                 f"{train} inside each {inside}")
        s = profile_step.summarize(events)
        size = os.path.getsize(path)
        del events
        phase_trace_lens(out_dir, steps, s, clog.records)
    in_trace = collections.Counter()
    for name, (_, count) in s["by_name"].items():
        in_trace[profile_step.kernel_of(name)] += count
    for k in T_KERNELS:
        per_step, rest = divmod(counts[k], T_WARM + steps)
        traced = in_trace[_T_SYMBOLS[k]]
        if not per_step or rest or traced != steps * per_step:
            raise AssertionError(f"profile_step: {k} launched {counts[k]} times in "
                                 f"{T_WARM + steps} steps, {traced} kernel events in the trace")
        if "resnet" in launches and per_step != launches["resnet"][k] // STEPS:
            raise AssertionError(f"profile_step: {k} {per_step} a step, phase c "
                                 f"{launches['resnet'][k] // STEPS}")
    log(f"[t] profile_step {' '.join(T_ARGV)}: {wall:.1f} s; trace {size / 2**20:.1f} MiB, "
        f"{len(caps)} mpi4dl_capture windows each holding one mpi4dl_train_step; kernel events "
        f"in the trace: K2 {in_trace['K2 wgrad']}, K3 {in_trace['K3 dot1x1_bwd']} "
        f"(= {steps} x the launches a step)")


def phase_trace_lens(out_dir, steps, tables, records):
    """Phase n1 (inside phase t): the trace of profile_step's ``steps``
    captured steps through ``analysis.trace.analyze_trace_dir``, and the
    lint of the collective log ``records`` of its single-device steps (see
    the docstring)."""
    from mpi4dl_tpu_torch import profile_step
    from mpi4dl_tpu_torch.analysis.expectations import compose, single_chip_delta
    from mpi4dl_tpu_torch.analysis.report import analyze_records
    from mpi4dl_tpu_torch.analysis.trace import analyze_trace_dir, categorize

    t0 = time.time()
    summary = analyze_trace_dir(out_dir, "mpi4dl_capture")
    if summary["n_steps"] != steps:
        raise AssertionError(f"[n1] {summary['n_steps']} attributed steps, want {steps}")
    for st in summary["steps"]:
        parts = st["compute_s"] + st["collective_s"] + st["transfer_s"] + st["host_gap_s"]
        if abs(parts - st["wall_s"]) > 1e-9 or st["collective_s"] != 0.0:
            raise AssertionError(f"[n1] step {st['step']}: buckets {st}")
    mine = [n for n in tables["by_name"] if profile_step.kernel_of(n) in _T_SYMBOLS.values()]
    wrong = [n for n in mine if categorize(n, "kernel") != "compute"]
    if len(mine) < len(_T_SYMBOLS) or wrong:
        raise AssertionError(f"[n1] K2/K3 kernel names {mine}, not compute: {wrong}")
    rep = analyze_records(records, expected=compose(single_chip_delta()), program="train_step")
    if rep.overlap["n_collectives"] or any(f["rule"] == "single-chip-collectives"
                                           for f in rep.findings):
        raise AssertionError(f"[n1] a single-device step's collectives: {rep.inventory}, "
                             f"findings {rep.findings}")
    for st in summary["steps"]:
        log(f"[n1] step {st['step']}: wall {st['wall_s'] * 1e3:.3f} ms = compute "
            f"{st['compute_s'] * 1e3:.3f} + collective {st['collective_s'] * 1e3:.3f} + "
            f"transfer {st['transfer_s'] * 1e3:.3f} + host gap {st['host_gap_s'] * 1e3:.3f} ms "
            f"(device busy {st['device_busy_s'] / st['wall_s']:.1%})")
    log(f"[n1] {summary['n_device_slices']} device slices; K2/K3 kernels {len(mine)} names, "
        f"all compute; the collective log of profile_step's {T_WARM + steps} steps: "
        f"{rep.summary_line()}; analyzed in {time.time() - t0:.1f} s")


def phase_k1(gen, shapes):
    """K1 vs its plain version at every main-path shape (a halo-extended
    tile, p = 0 with overlapping windows, also with a −inf outer ring), then
    at the edge shapes, bf16 and f32; returns the main-path shapes' worst
    error."""
    import torch

    from mpi4dl_tpu_torch.ops import pool_kernel

    worst = 0.0
    for i, (shape, kh, kw, sh, sw, ph, pw) in enumerate(list(shapes) + K1_EDGE):
        edge = i >= len(shapes)
        # The spatial paths' pools run on halo-extended tiles with no padding;
        # a tile at the image's edge has −inf in its outer ring there.
        extended = not edge and (ph, pw) == (0, 0) and (kh > sh or kw > sw)
        b, h, w, c = shape
        ho, wo = pool_kernel.out_size(h, kh, sh, ph), pool_kernel.out_size(w, kw, sw, pw)
        for dtype, offset, ring in [(d, o, r) for d in (torch.bfloat16, torch.float32)
                                    for o in ((0, 1) if edge else (0,))
                                    for r in ((False, True) if extended else (False,))]:
            x = torch.randint(0, 3, shape, generator=gen, device=DEVICE).to(dtype)
            if offset:  # one element past a 16-byte boundary: the one-element path
                x = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(shape)
            if ring:
                x[:, 0] = x[:, -1] = x[:, :, 0] = x[:, :, -1] = float("-inf")
            dy = torch.randint(-64, 64, (b, ho, wo, c), generator=gen, device=DEVICE).to(dtype)
            got = pool_kernel.pool_bwd(x, dy, kh, kw, sh, sw, ph, pw)
            want = pool_kernel.pool_bwd_reference(x, dy, kh, kw, sh, sw, ph, pw)
            err = float((got.float() - want.float()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"K1 x{list(shape)} {kh}x{kw} s({sh},{sw}) p({ph},{pw}) "
                                     f"{dtype} offset {offset} ring {ring}: max |err| {err}")
            if not edge:
                worst = max(worst, err)
        log(f"[d] K1 {'edge ' if edge else ''}x{list(shape)} {kh}x{kw} s({sh},{sw}) p({ph},{pw}): "
            f"bf16 and f32{', aligned and not,' if edge else ''}"
            f"{', with and without a -inf outer ring,' if extended else ''} equal to the plain "
            f"version (tie-heavy ints)")
    return worst


def phase_k2(gen, shapes):
    """K2 vs its plain version at every main-path shape, bf16 and f32."""
    import torch

    from mpi4dl_tpu_torch.ops import wgrad_kernel

    worst = 0.0
    for (b, h, w, c), o, kh, kw, ph, pw in shapes:
        ho, wo = wgrad_kernel.out_size(h, kh, ph), wgrad_kernel.out_size(w, kw, pw)
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((b, h, w, c), generator=gen, device=DEVICE).to(dtype)
            dy = torch.randn((b, ho, wo, o), generator=gen, device=DEVICE).to(dtype)
            got = wgrad_kernel.wgrad(x, dy, kh, kw, ph, pw)
            want = wgrad_kernel.wgrad_reference(x, dy, kh, kw, ph, pw)
            if got.dtype != torch.float32 or got.shape != want.shape:
                raise AssertionError(f"K2 output {got.dtype} {tuple(got.shape)}")
            err = rel_err(got, want)
            if not err <= DW_TOL:
                raise AssertionError(
                    f"K2 x[{b},{h},{w},{c}]->{o} {kh}x{kw} p({ph},{pw}) {dtype}: "
                    f"max|err|/max|ref| {err:.3g} (tolerance {DW_TOL})")
            if dtype == torch.bfloat16:
                worst = max(worst, float((got - want).abs().max()))
            errs.append(f"{str(dtype).split('.')[-1]} {err:.1e}")
            del x, dy, got, want
        log(f"[e] K2 x[{b},{h},{w},{c}]->{o} {kh}x{kw} p({ph},{pw}): max|err|/max|ref| "
            f"{'; '.join(errs)} (tolerance {DW_TOL})")
    return worst


def phase_k3(gen, shapes):
    """K3 vs its plain version at every main-path shape, bf16 and f32."""
    import torch

    from mpi4dl_tpu_torch.ops import dot1x1_kernel

    worst = 0.0
    for (b, h, w, c), o in shapes:
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            tol = K3_DX_TOL[str(dtype).split(".")[-1]]
            x = torch.randn((b, h, w, c), generator=gen, device=DEVICE).to(dtype)
            dy = torch.randn((b, h, w, o), generator=gen, device=DEVICE).to(dtype)
            w2 = (torch.randn((c, o), generator=gen, device=DEVICE) / c**0.5).to(dtype)
            dx, dw = dot1x1_kernel.bwd_1x1(x, dy, w2)
            rdx, rdw = dot1x1_kernel.bwd_1x1_reference(x, dy, w2)
            if dx.dtype != dtype or dw.dtype != torch.float32:
                raise AssertionError(f"K3 output dtypes {dx.dtype} {dw.dtype}")
            e_dx, e_dw = rel_err(dx, rdx), rel_err(dw, rdw)
            if not (e_dx <= tol and e_dw <= DW_TOL):
                raise AssertionError(
                    f"K3 x[{b},{h},{w},{c}]->{o} {dtype}: dx {e_dx:.3g} (tolerance {tol}), "
                    f"dw {e_dw:.3g} (tolerance {DW_TOL})")
            if dtype == torch.bfloat16:
                worst = max(worst, float((dx.float() - rdx.float()).abs().max()),
                            float((dw - rdw).abs().max()))
            errs.append(f"{str(dtype).split('.')[-1]} dx {e_dx:.1e} dw {e_dw:.1e}")
        log(f"[f] K3 x[{b},{h},{w},{c}]->{o}: max|err|/max|ref| {'; '.join(errs)} "
            f"(tolerances: dx {K3_DX_TOL}, dw {DW_TOL})")
    return worst


def _launch_fields(name, launches):
    steps = {path: STEPS_IN_RUN.get(path, STEPS) for path in launches
             if name in PATH_KERNELS[path]}
    per_step = {path: launches[path][name] // n for path, n in steps.items()}
    return {
        "launches": per_step[HOME_PATH[name]],
        "launches_path": HOME_PATH[name],
        "launches_per_step": per_step,
        "launches_in_run": {path: launches[path][name] for path in per_step},
        "steps_in_run": steps,
    }


def _bound(nbytes, ops, rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _k1_case(gen, shape):
    """K1 at one call shape in bf16, as :func:`_k2_case` (the library call
    is ``F.max_pool2d``'s backward through autograd, on channels_last
    views of the same tensors; its forward is not timed)."""
    import torch
    import torch.nn.functional as F

    from mpi4dl_tpu_torch.ops import pool_kernel

    (b, h, w, c), kh, kw, sh, sw, ph, pw = shape
    ho, wo = pool_kernel.out_size(h, kh, sh, ph), pool_kernel.out_size(w, kw, sw, pw)
    x = torch.randn((b, h, w, c), generator=gen, device=DEVICE).to(torch.bfloat16)
    dy = torch.randn((b, ho, wo, c), generator=gen, device=DEVICE).to(torch.bfloat16)
    xc = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
    yc = F.max_pool2d(xc, (kh, kw), (sh, sw), (ph, pw))
    dyc = dy.permute(0, 3, 1, 2)
    ops = b * ho * wo * c * kh * kw  # one f32 compare per tap per window
    return {
        "kernel": lambda: pool_kernel.pool_bwd(x, dy, kh, kw, sh, sw, ph, pw),
        "plain": lambda: pool_kernel.pool_bwd_reference(x, dy, kh, kw, sh, sw, ph, pw),
        "library": lambda: torch.autograd.grad(yc, xc, dyc, retain_graph=True),
        "bound": _bound((2 * x.numel() + dy.numel()) * 2, ops, F32_SIMT_OPS),
        "desc": f"x[{b},{h},{w},{c}] bf16 {kh}x{kw} s{sh} p{ph}",
    }


def _k2_case(gen, shape):
    """K2 at one call shape in bf16: the kernel, its plain version and the
    library call (cuDNN's dw-only ``convolution_backward``) as thunks on
    one set of random inputs, the bound, and a description."""
    import torch

    from mpi4dl_tpu_torch.ops import wgrad_kernel

    (b, h, w, c), o, kh, kw, ph, pw = shape
    ho, wo = wgrad_kernel.out_size(h, kh, ph), wgrad_kernel.out_size(w, kw, pw)
    x = torch.randn((b, h, w, c), generator=gen, device=DEVICE).to(torch.bfloat16)
    dy = torch.randn((b, ho, wo, o), generator=gen, device=DEVICE).to(torch.bfloat16)
    xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)  # channels_last views
    wc = torch.empty((o, c, kh, kw), dtype=torch.bfloat16, device=DEVICE)
    wc = wc.contiguous(memory_format=torch.channels_last)
    flops = 2 * b * ho * wo * kh * kw * c * o
    return {
        "kernel": lambda: wgrad_kernel.wgrad(x, dy, kh, kw, ph, pw),
        "plain": lambda: wgrad_kernel.wgrad_reference(x, dy, kh, kw, ph, pw),
        "library": lambda: torch.ops.aten.convolution_backward(
            dyc, xc, wc, None, (1, 1), (ph, pw), (1, 1), False, (0, 0), 1,
            (False, True, False)),
        "bound": _bound((x.numel() + dy.numel()) * 2 + kh * kw * c * o * 4, flops,
                        BF16_TENSOR_FLOPS),
        "desc": f"x[{b},{h},{w},{c}]->{o} bf16 {kh}x{kw} p({ph},{pw})",
    }


def _k3_case(gen, shape):
    """K3 at one call shape in bf16, as :func:`_k2_case` (the library call
    is two ``torch.matmul``)."""
    import torch

    from mpi4dl_tpu_torch.ops import dot1x1_kernel

    (b, h, w, c), o = shape
    m = b * h * w
    x = torch.randn((b, h, w, c), generator=gen, device=DEVICE).to(torch.bfloat16)
    dy = torch.randn((b, h, w, o), generator=gen, device=DEVICE).to(torch.bfloat16)
    w2 = (torch.randn((c, o), generator=gen, device=DEVICE) / c**0.5).to(torch.bfloat16)
    x2, dy2 = x.view(m, c), dy.view(m, o)
    return {
        "kernel": lambda: dot1x1_kernel.bwd_1x1(x, dy, w2),
        "plain": lambda: dot1x1_kernel.bwd_1x1_reference(x, dy, w2),
        "library": lambda: (torch.matmul(dy2, w2.t()), torch.matmul(x2.t(), dy2)),
        "bound": _bound((2 * m * c + m * o + c * o) * 2 + c * o * 4, 4 * m * c * o,
                        BF16_TENSOR_FLOPS),
        "desc": f"x[{b},{h},{w},{c}]->{o} bf16",
    }


def phase_shape_times(gen, calls):
    """Phase g's per-shape part: K1, K2 and K3 timed at every recorded call
    shape of the three paths (kernel, library call, bound, launches per
    step of each path at that shape), and each path's launch-weighted sum
    per step. Returns, per kernel, the fields its kernels row gains."""
    import torch

    out = {}
    for name, make in (("pool_bwd", _k1_case), ("wgrad", _k2_case), ("dot1x1_bwd", _k3_case)):
        shapes = sorted(set().union(*(c[name] for c in calls.values())))
        rows = []
        sums = {path: {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "launches": 0}
                for path in calls if name in PATH_KERNELS[path]}
        for shape in shapes:
            case = make(gen, shape)
            per_step = {path: calls[path][name].get(shape, 0) for path in sums}
            row = {"shape": case["desc"], "ms": cuda_ms(case["kernel"]),
                   "library_ms": cuda_ms(case["library"]), **case["bound"],
                   "launches_per_step": per_step}
            rows.append(row)
            for path, n in per_step.items():
                for key in ("ms", "library_ms", "bound_ms"):
                    sums[path][key] += n * row[key]
                sums[path]["launches"] += n
            log(f"[g] {name} {row['shape']}: kernel {row['ms']:.4f} ms, library "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
                f"launches per step {per_step}")
            del case
            torch.cuda.empty_cache()
        for path, t in sums.items():
            log(f"[g] {name} on {path}, launch-weighted per step: {t['launches']} launches, "
                f"kernel {t['ms']:.3f} ms, library {t['library_ms']:.3f} ms, "
                f"bound {t['bound_ms']:.3f} ms")
        out[name] = {"shapes": rows, "per_step": sums}
    return out


def phase_k1_copies(gen, copies):
    """Phase g's layout copies in front of K1: each x or dy that a main path
    hands ``MaxPool.backward`` in another layout than channels_last (per
    path, from :func:`_record_k1_layout`), timed as the copy the backward
    makes on a tensor of the same shape, strides and offset, beside its
    bound (read once, written once). Returns the fields K1's kernels row
    gains."""
    import torch

    rows, sums = [], {}
    for path, counter in copies.items():
        for (name, dtype, shape, stride, offset), n in sorted(counter.items()):
            extent = offset + sum((sz - 1) * st for sz, st in zip(shape, stride)) + 1
            base = torch.randn(extent, generator=gen, device=DEVICE).to(getattr(torch, dtype[6:]))
            t = base.as_strided(shape, stride, offset)
            row = {"tensor": name, "shape": list(shape), "stride": list(stride), "dtype": dtype,
                   "ms": cuda_ms(lambda: t.contiguous(memory_format=torch.channels_last)),
                   **_bound(2 * t.numel() * t.element_size(), 0, 1.0), "path": path,
                   "per_step": n}
            rows.append(row)
            sums[path] = sums.get(path, 0.0) + n * row["ms"]
            log(f"[g] K1's {name} copied to channels_last on {path}, {dtype[6:]} "
                f"{list(shape)} strides {list(stride)}: {row['ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms; {n} a step")
            del base, t
    for path, ms in sums.items():
        log(f"[g] K1's layout copies on {path}, per step: {ms:.3f} ms")
    return {"layout_copies": rows, "layout_copy_ms_per_step": sums}


def phase_kernel_times(gen, launches, errs):
    """Phase g's timed-shape part: each kernel at the largest main-path
    shape, beside its plain version, one library call and the bound."""
    rows = []
    case = _k1_case(gen, K1_TIMED)
    rows.append({
        "name": "pool_bwd", "route": "cuda",
        "source": "mpi4dl_tpu_torch/ops/csrc/pool_bwd.cu",
        "replaces": "mpi4dl_tpu/ops/pool_pallas.py:406",
        **_launch_fields("pool_bwd", launches),
        "max_abs_err": errs["pool_bwd"],
        "ms": cuda_ms(case["kernel"]),
        "plain_ms": cuda_ms(case["plain"], iters=3),
        **case["bound"],
        "library_ms": cuda_ms(case["library"]),
        "shape": case["desc"],
    })
    del case

    case = _k2_case(gen, K2_TIMED)
    rows.append({
        "name": "wgrad", "route": "cuda",
        "source": "mpi4dl_tpu_torch/ops/csrc/wgrad.cu",
        "replaces": "mpi4dl_tpu/ops/wgrad_pallas.py:166",
        **_launch_fields("wgrad", launches),
        "max_abs_err": errs["wgrad"],
        "ms": cuda_ms(case["kernel"]),
        "plain_ms": cuda_ms(case["plain"], iters=3),
        **case["bound"],
        "library_ms": cuda_ms(case["library"]),
        "shape": case["desc"],
    })
    del case

    case = _k3_case(gen, K3_TIMED)
    rows.append({
        "name": "dot1x1_bwd", "route": "cuda",
        "source": "mpi4dl_tpu_torch/ops/csrc/dot1x1_bwd.cu",
        "replaces": "mpi4dl_tpu/ops/dot1x1_pallas.py:156",
        **_launch_fields("dot1x1_bwd", launches),
        "max_abs_err": errs["dot1x1_bwd"],
        "ms": cuda_ms(case["kernel"]),
        "plain_ms": cuda_ms(case["plain"]),
        **case["bound"],
        "library_ms": cuda_ms(case["library"]),
        "shape": case["desc"],
    })
    del case
    for r in rows:
        log(f"[g] {r['name']} {r['shape']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"library {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}); "
            f"launches per step {r['launches_per_step']}")
    return rows


# Phase r: serving. r1 and r2 in this process, r3 in phase s's ranks (or,
# with --serve-only, in a 4-rank world of its own).
R_BUCKETS = (1, 2, 4)  # r1's and r2's engine buckets
R_SP_BUCKETS = (1, 2)  # r3's
R_CPU_TOL = 1e-4  # r1 and r3 f32: a replay against the CPU predict, of max |logit|
# r1: a replay against the eager forward of the same bucket on the card is
# held bit-equal; only if cuDNN picks another algorithm under capture is it
# held to this, of max |logit|, and the line says so.
R_EAGER_TOL = 1e-6
R_TIMED = 10  # replays and eager forwards timed a bucket (median, CUDA events)
R_SP_TIMED = 3  # r3's replays timed a bucket (4 ranks time-slice one card)
R_BURST, R_SINGLES = 12, 20  # r2's requests: a burst, then one by one
R_SP_REQUESTS = 8  # r3's
R_CAL_BATCHES = 2  # r2's calibration batches


def _median_ms(fn, n=R_TIMED):
    """Median device time of ``n`` calls of ``fn``, each between CUDA events."""
    import torch

    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def _row_key(row) -> bytes:
    import hashlib

    return hashlib.sha1(row.tobytes()).digest()


def phase_serve_small():
    """Phase r1: phase b's small f32 models, calibrated on the card; a
    ``SingleChipPredictor``'s buckets captured; each replay against the CPU
    predict (plain versions) and against the eager forward on the card."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch import evaluate
    from mpi4dl_tpu_torch.serve import SingleChipPredictor

    rng = np.random.default_rng(SEED + 5)
    exact = True
    for name, build, size in small_models():
        cpu = _seeded(build())
        model = copy.deepcopy(cpu).to(DEVICE, memory_format=torch.channels_last)
        cal, _ = eval_batches(size)
        stats = evaluate.collect_batch_stats(model, cal)
        stats_np = [_numpy_stats(s) for s in stats]
        pred = SingleChipPredictor(model, stats, (size, size, 3), torch.float32)
        parts = []
        for b in R_BUCKETS:
            captured = pred.compile_bucket(b)
            x = rng.standard_normal((b, size, size, 3)).astype(np.float32)
            got = pred.run(captured, x)
            eager = evaluate.make_predict(model)(stats, x)
            want = evaluate.make_predict(cpu)(stats_np, x)
            cpu_err = rel_err(got.cpu(), want)
            if not cpu_err <= R_CPU_TOL:
                raise AssertionError(f"r1 {name} bucket {b}: replay against the CPU predict "
                                     f"{cpu_err:.3g} of max |logit| (tolerance {R_CPU_TOL:g})")
            same = torch.equal(got, eager)
            if not same:
                exact = False
                err = rel_err(got, eager)
                if not err <= R_EAGER_TOL:
                    raise AssertionError(f"r1 {name} bucket {b}: replay against the eager "
                                         f"forward {err:.3g} of max |logit| (not bit-equal; "
                                         f"tolerance {R_EAGER_TOL:g})")
            t = pred.compile_timings[b]
            parts.append(f"bucket {b}: CPU {cpu_err:.2e}, eager "
                         + ("bit-equal" if same else f"NOT bit-equal, {rel_err(got, eager):.2e}")
                         + f" (warm-up {t['trace_s']:.3f} s, capture {t['compile_s']:.3f} s)")
        log(f"[r1] {name} f32 (TF32 off), statistics from collect_batch_stats on the card, "
            f"SingleChipPredictor buckets {R_BUCKETS} captured: " + "; ".join(parts)
            + f" (CPU tolerance {R_CPU_TOL:g} of max |logit|)")
        del pred, model, stats
    gc.collect()
    torch.cuda.empty_cache()
    return exact


def phase_serve_main():
    """Phase r2: AmoebaNet-D 18L/416F @1024 bf16 (phase c's seed) behind a
    ``ServingEngine`` with buckets ``R_BUCKETS``: per bucket the warm-up,
    the capture, the pool and the replay beside the eager forward; then
    ``R_BURST`` requests at once and ``R_SINGLES`` one by one, each response
    bit-equal to its row of the eager forward of the padded batch it rode
    in, and no capture after warm-up."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch import evaluate
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.serve import ServingEngine
    from mpi4dl_tpu_torch.serve.engine import to_host
    from mpi4dl_tpu_torch.weights import meta_built

    t0 = time.time()
    model = _seeded(meta_built(lambda: amoebanetd(10, LAYERS, FILTERS, dtype=torch.bfloat16)))
    model = model.to(DEVICE, memory_format=torch.channels_last)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    cal = [torch.randn((BATCH, SIZE, SIZE, 3), generator=gen, device=DEVICE).to(torch.bfloat16)
           for _ in range(R_CAL_BATCHES)]
    stats = evaluate.collect_batch_stats(model, cal)
    del cal
    setup_s = time.time() - t0
    captures = [0]
    begin = torch.cuda.CUDAGraph.capture_begin

    def counted(self, *args, **kwargs):
        captures[0] += 1
        return begin(self, *args, **kwargs)

    torch.cuda.CUDAGraph.capture_begin = counted
    try:
        t0 = time.time()
        eng = ServingEngine(model, stats, (SIZE, SIZE, 3), dtype=torch.bfloat16,
                            buckets=R_BUCKETS, default_deadline_s=300.0)
        warm_wall = time.time() - t0
        warm_captures = captures[0]
        pred = eng._predictor
        predict = evaluate.make_predict(model)
        rng = np.random.default_rng(SEED + 7)
        rows = []
        for b in eng.buckets:
            x = torch.as_tensor(rng.standard_normal((b, SIZE, SIZE, 3)).astype(np.float32))
            x = x.to(DEVICE)
            captured = eng._compiled[b]
            replay = _median_ms(lambda: captured(x))
            xb = x.to(torch.bfloat16)
            eager = _median_ms(lambda: predict(stats, xb))
            e = eng.memory_ledger.get(pred.program, bucket=b)
            rows.append(f"bucket {b}: warm-up {e['trace_s']:.3f} s, capture {e['compile_s']:.3f} "
                        f"s, first replay {e['warm_s']:.3f} s, pool {e['pool_bytes']} bytes, peak "
                        f"{e['peak_bytes'] / 2**30:.2f} GiB; replay {replay:.3f} ms against the "
                        f"eager forward's {eager:.3f} ms")
        staged = []
        stage = pred.stage

        def recording(batch):
            staged.append(np.array(batch))
            return stage(batch)

        pred.stage = recording
        xs = [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
              for _ in range(R_BURST + R_SINGLES)]
        t0 = time.time()
        eng.start()
        try:
            futures = [eng.submit(x) for x in xs[:R_BURST]]
            res = [f.result(timeout=300) for f in futures]
            for x in xs[R_BURST:]:
                res.append(eng.submit(x).result(timeout=300))
        finally:
            eng.stop()
        serve_s = time.time() - t0
        eng.assert_warm()
        after = captures[0] - warm_captures
    finally:
        torch.cuda.CUDAGraph.capture_begin = begin
    if after or warm_captures != len(R_BUCKETS):
        raise AssertionError(f"r2: {warm_captures} captures in warm-up, {after} after it")
    index = {_row_key(x): i for i, x in enumerate(xs)}
    matched = 0
    for batch in staged:
        want = to_host(predict(stats, torch.as_tensor(batch).to(DEVICE, torch.bfloat16)))
        for r, row in enumerate(batch):
            i = index.get(_row_key(row))
            if i is None:
                continue  # a pad row
            if not (res[i].shape == want[r].shape and np.array_equal(res[i], want[r])):
                raise AssertionError(f"r2: request {i}'s response differs from row {r} of the "
                                     f"eager forward of its padded bucket-{len(batch)} batch")
            matched += 1
    if matched != len(xs) or not all(np.isfinite(v).all() for v in res):
        raise AssertionError(f"r2: {matched} of {len(xs)} responses matched eager rows")
    st = eng.stats()
    if st["served"] != len(xs):
        raise AssertionError(f"r2: served {st['served']} of {len(xs)}: {st}")
    lat = st["latency_s"]
    log(f"[r2] AmoebaNet-D {LAYERS}L/{FILTERS}F @{SIZE} bf16 (phase c's seed), statistics over "
        f"{R_CAL_BATCHES} calibration batches of {BATCH}; set-up {setup_s:.1f} s; ServingEngine "
        f"buckets {eng.buckets} warm in {warm_wall:.1f} s ({warm_captures} captures, the load "
        f"checksum and canary references included); {card()}")
    for row in rows:
        log(f"[r2] {row} (median of {R_TIMED}, CUDA events; a replay copies the batch in and "
            "the logits out)")
    log(f"[r2] {len(xs)} requests ({R_BURST} at once, then {R_SINGLES} one by one) in "
        f"{serve_s:.2f} s: served {st['served']} in {st['batches']} batches (mean "
        f"{st.get('mean_batch_size', 0):.2f}, by bucket {st['bucket_dispatches']}), latency p50 "
        f"{lat['p50'] * 1e3:.1f} ms, p90 {lat['p90'] * 1e3:.1f} ms, p99 {lat['p99'] * 1e3:.1f} ms; "
        f"every response bit-equal to its row of the eager forward of its padded batch; "
        f"assert_warm passed, no capture after warm-up")
    del eng, pred
    # r4 serves this model and its statistics again, from a checkpoint.
    from mpi4dl_tpu_torch.checkpoint import model_metadata, save_checkpoint
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.train import Trainer

    t0 = time.time()
    ckpt = tempfile.mkdtemp(prefix="mpi4dl-serve-ckpt-")
    trainer = Trainer(model, ParallelConfig(batch_size=1, image_size=SIZE), device=DEVICE)
    save_checkpoint(ckpt, trainer, batch_stats=stats, metadata=model_metadata(
        "amoebanet", SIZE, num_classes=10, num_layers=LAYERS, num_filters=FILTERS,
        dtype=torch.bfloat16))
    log(f"[r2] saved the model and its statistics as a checkpoint in {time.time() - t0:.1f} s "
        f"(for r4)")
    del trainer, model, stats
    gc.collect()
    torch.cuda.empty_cache()
    return ckpt


# r4-r7: the serving entry points of the port, after r2.
R4_FLAGS = ["--max-batch", "4", "--mode", "open", "--rate", "20", "--duration", "5",
            "--serial", "8", "--slo-availability", "99.9", "--slo-latency-ms", "500",
            "--slo-interval", "0.5", "--metrics-port", "0"]
# The report keys of the JAX CLI (``mpi4dl_tpu/serve/__main__.py:471-545``) with
# a serial baseline, a metrics port and an SLO, as r4 runs it.
R4_KEYS = {"model", "buckets", "mesh", "metrics_port", "serial", "loadgen", "slo",
           "speedup_vs_serial"}
R5_TILE = 384  # r5a's core: 1024 = 384 + 384 + 256, ragged edge tiles
R5_TOL = 5e-6  # r5a f32: the tiled logits against the monolithic forward, of max |logit|
R5_SIZE = 8192  # r5b
R5_REQUESTS = 2


class _Tee:
    """A text stream that writes through to ``stream`` and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _scrape_once(tee_err, got, done):
    """r4's scraper: wait for the CLI's metrics URL on stderr, then for the
    load (the first served request on ``/metrics``), then read ``/metrics``,
    ``/healthz`` and ``/alertz`` once into ``got``."""
    import re
    import urllib.error
    import urllib.request

    def fetch(url):
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    base = None
    while not done.is_set() and base is None:
        m = re.search(r"# metrics: (http://127\.0\.0\.1:\d+)/metrics", tee_err.text())
        base = m.group(1) if m else None
        time.sleep(0.05)
    while base is not None and not done.is_set():
        status, body = fetch(base + "/metrics")
        if status == 200 and 'serve_requests_total{outcome="served"}' in body:
            got["metrics"] = (status, body)
            got["healthz"] = fetch(base + "/healthz")
            got["alertz"] = fetch(base + "/alertz")
            return
        time.sleep(0.1)


def phase_serve_cli(ckpt):
    """Phase r4: ``python -m mpi4dl_tpu_torch.serve``'s ``main`` in this
    process on r2's checkpoint (AmoebaNet-D 18L/416F @1024 bf16), open loop
    under an availability and a latency SLO with a live ``/metrics``; a
    thread scrapes ``/metrics``, ``/healthz`` and ``/alertz`` once while the
    load runs."""
    import threading

    import torch

    from mpi4dl_tpu_torch.serve.__main__ import main as serve_main

    captures = [0]
    begin = torch.cuda.CUDAGraph.capture_begin

    def counted(self, *args, **kwargs):
        captures[0] += 1
        return begin(self, *args, **kwargs)

    tee_out, tee_err = _Tee(sys.stdout), _Tee(sys.stderr)
    got, done = {}, threading.Event()
    scraper = threading.Thread(target=_scrape_once, args=(tee_err, got, done), daemon=True)
    torch.cuda.CUDAGraph.capture_begin = counted
    t0 = time.time()
    try:
        scraper.start()
        with contextlib.redirect_stdout(tee_out), contextlib.redirect_stderr(tee_err):
            rc = serve_main(["--ckpt", ckpt, *R4_FLAGS])
    finally:
        done.set()
        torch.cuda.CUDAGraph.capture_begin = begin
        scraper.join(timeout=30)
    wall = time.time() - t0
    lines = [ln for ln in tee_out.text().splitlines() if ln.strip()]
    rep = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    if rc != 0 or rep is None or set(rep) != R4_KEYS:
        raise AssertionError(f"r4: exit {rc}, last line keys "
                             f"{sorted(rep) if rep else None} (want {sorted(R4_KEYS)})")
    if captures[0] != len(rep["buckets"]):
        raise AssertionError(f"r4: {captures[0]} graphs captured for buckets {rep['buckets']}: "
                             "a capture after warm-up")
    status, body = got.get("metrics", (None, ""))
    if status != 200 or "serve_requests_total" not in body:
        raise AssertionError(f"r4: /metrics answered {status} ({len(body)} bytes)")
    if got["healthz"][0] != 200:
        raise AssertionError(f"r4: /healthz answered {got['healthz']}")
    alertz = json.loads(got["alertz"][1])
    if got["alertz"][0] != 200 or "alerts" not in alertz:
        raise AssertionError(f"r4: /alertz answered {got['alertz'][0]}")
    lg = rep["loadgen"]
    if not (rep.get("slo") and "ok" in rep["slo"]) or lg["served"] <= 0:
        raise AssertionError(f"r4: slo {rep.get('slo')}, served {lg['served']}")
    lat = lg["latency_s"]
    log(f"[r4] python -m mpi4dl_tpu_torch.serve --ckpt <r2's AmoebaNet-D {LAYERS}L/{FILTERS}F "
        f"@{SIZE} bf16> {' '.join(R4_FLAGS)} in this process: exit 0 in {wall:.1f} s, buckets "
        f"{rep['buckets']} ({captures[0]} captures, none after warm-up); offered "
        f"{lg['offered']}, served {lg['served']} ({lg['rejected_queue_full']} rejected, "
        f"{lg['deadline_misses']} late, {lg['errors']} errors), latency p50 "
        f"{lat['p50'] * 1e3:.1f} ms, p90 {lat['p90'] * 1e3:.1f} ms, p99 {lat['p99'] * 1e3:.1f} ms; "
        f"serial bs1 {rep['serial']['throughput_rps']:.2f} req/s, speedup_vs_serial "
        f"{rep['speedup_vs_serial']:.2f} (an offered 20 req/s bounds the open loop); "
        f"slo {json.dumps(rep['slo'])}; {card()}")
    log(f"[r4] scraped while the load ran: /metrics 200 ({len(body)} bytes, "
        f"serve_requests_total present), /healthz {got['healthz'][0]}, /alertz "
        f"{got['alertz'][0]} ({len(alertz['alerts'])} alerts, states "
        f"{sorted({a['state'] for a in alertz['alerts']})})")


def phase_serve_tiled():
    """Phase r5: tiled serving of ResNet-110 v2. a: f32 @1024 (TF32 off) with
    a ragged tile, the tiled logits against the monolithic eager forward
    (``R5_TOL``); b: bf16 @8192 with the default tile behind a
    ``tiled_engine``, ``R5_REQUESTS`` requests, then one monolithic forward;
    the tiled request's peak memory under half of the monolithic one's."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch import evaluate
    from mpi4dl_tpu_torch.evaluate import _pool_bytes
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.serve.tiled import TiledPredictor, tiled_engine
    from mpi4dl_tpu_torch.weights import meta_built

    def build(size, dtype):
        model = _seeded(meta_built(lambda: get_resnet_v2(
            RESNET_DEPTH, 10, pool_kernel=size // 4, dtype=dtype)))
        return model.to(DEVICE, memory_format=torch.channels_last)

    rng = np.random.default_rng(SEED + 8)
    t0 = time.time()
    model = build(SIZE, torch.float32)
    stats = evaluate.collect_batch_stats(
        model, [rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)])
    pred = TiledPredictor(model, stats, (SIZE, SIZE, 3), R5_TILE)
    handle = pred.compile_bucket(1)
    g = pred.geometry
    x = rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    got = torch.as_tensor(pred.run(handle, x)[0])
    want = evaluate.make_predict(model)(stats, x)[0].float().cpu()
    err = rel_err(got, want)
    if not (torch.isfinite(got).all() and err <= R5_TOL):
        raise AssertionError(f"r5a: tiled against monolithic {err:.3g} of max |logit| "
                             f"(tolerance {R5_TOL:g})")
    log(f"[r5a] ResNet-{RESNET_DEPTH} v2 @{SIZE} f32 (TF32 off), tile {R5_TILE}: grid "
        f"{list(g.grid)}, cores {[t[1] for t in g.tiles_h]}, margin {list(g.margin_hw)}, window "
        f"{list(g.window_hw)}, {len(g.ops)} recorded ops; tiled logits against the monolithic "
        f"forward {err:.2e} of max |logit| (tolerance {R5_TOL:g}) in {time.time() - t0:.1f} s; "
        f"{card()}")
    del pred, handle, model
    gc.collect()
    torch.cuda.empty_cache()

    # b: bf16 at 8192, statistics from a 1024 px twin with the same weights.
    t0 = time.time()
    twin = build(SIZE, torch.bfloat16)
    stats = evaluate.collect_batch_stats(
        twin, [torch.randn((BATCH, SIZE, SIZE, 3), generator=torch.Generator(DEVICE).manual_seed(
            SEED + 9), device=DEVICE).to(torch.bfloat16)])
    model = build(R5_SIZE, torch.bfloat16)
    del twin
    eng = tiled_engine(model, stats, (R5_SIZE, R5_SIZE, 3), tile=None, dtype=torch.bfloat16,
                       max_queue=4, default_deadline_s=600.0, watchdog_factor=None)
    warm_s = time.time() - t0
    g = eng._predictor.geometry
    tile_e = eng.memory_ledger.get("serve_tiled_tile", bucket=1)
    head_e = eng.memory_ledger.get("serve_tiled_head")
    pool = _pool_bytes(eng._predictor._pool) or 0
    xs = [rng.standard_normal((R5_SIZE, R5_SIZE, 3), dtype=np.float32)
          for _ in range(R5_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng.start()
    try:
        t1 = time.time()
        outs = [eng.submit(x).result(timeout=600) for x in xs]
        serve_s = time.time() - t1
    finally:
        eng.stop()
    torch.cuda.synchronize()
    tiled_alloc = int(torch.cuda.max_memory_allocated())
    # Replays allocate nothing: the captures' intermediates live in the pool.
    tiled_peak = tiled_alloc + pool
    lint = eng.lint_report()
    if not lint.ok:
        raise AssertionError(f"r5b: the tiled engine's lint: {lint.findings}")
    st = eng.stats()
    t = st["tiled"]
    lat = st["latency_s"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    mono = evaluate.make_predict(model)(stats, torch.as_tensor(xs[-1][None]).to(
        DEVICE, torch.bfloat16))[0].float().cpu()
    torch.cuda.synchronize()
    mono_s = time.time() - t1
    mono_peak = int(torch.cuda.max_memory_allocated())
    err = rel_err(torch.as_tensor(outs[-1]), mono)
    if not (all(np.isfinite(o).all() for o in outs) and t["requests"] == R5_REQUESTS):
        raise AssertionError(f"r5b: {t['requests']} tiled requests, finite "
                             f"{[bool(np.isfinite(o).all()) for o in outs]}")
    if not tiled_peak < 0.5 * mono_peak:
        raise AssertionError(f"r5b: tiled peak {tiled_peak} bytes is not under half of the "
                             f"monolithic forward's {mono_peak}")
    log(f"[r5b] ResNet-{RESNET_DEPTH} v2 @{R5_SIZE} bf16, default tile {list(g.tile_hw)}: "
        f"{t['tiles_per_request']} tiles a request (grid {t['grid']}, window {t['window']}, "
        f"margin {t['margin']}, feature map {t['feature_hw']}x{t['feature_channels']}); engine "
        f"built and warm in {warm_s:.1f} s (tile capture peak "
        f"{tile_e['peak_bytes'] / 2**30:.2f} GiB, head capture peak "
        f"{head_e['peak_bytes'] / 2**30:.2f} GiB, graph pool {pool} bytes); {R5_REQUESTS} "
        f"requests in {serve_s:.1f} s, latency p50 {lat['p50']:.2f} s, stitch p50 "
        f"{t['stitch_s']['p50']:.3f} s, tile stream p50 {t['tile_stream_s']['p50']:.3f} s; "
        f"lint ok ({sum(lint.inventory.values())} collectives, rule single-chip-collectives); "
        f"{card()}")
    log(f"[r5b] peak memory: tiled {tiled_peak / 2**30:.2f} GiB (max_memory_allocated "
        f"{tiled_alloc / 2**30:.2f} GiB + the graph pool) against the monolithic forward's "
        f"{mono_peak / 2**30:.2f} GiB ({mono_s:.1f} s), under half; bf16 tiled logits against "
        f"the monolithic forward {err:.2e} of max |logit|")
    del model, stats, outs
    gc.collect()
    torch.cuda.empty_cache()


def start_serve_mesh_cli():
    """Phase r6, started: ``python -m mpi4dl_tpu_torch.serve --mesh 2x2
    --requests 8 --serial 0`` as a subprocess in a session of its own
    (synthetic ResNet-v1 @32, 4 rank processes). Most of its wall is its
    ranks reaching the card, so it runs beside r5."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", "mpi4dl_tpu_torch.serve", "--mesh", "2x2",
                             "--requests", "8", "--serial", "0"], cwd=here, env=env,
                            stdout=out, stderr=err, text=True, start_new_session=True)
    return proc, out, err, time.time()


def stop_session(started):
    """Kill a started subprocess's session (r6's ranks too, or m3's bench)
    after a failure elsewhere."""
    proc = started[0]
    if proc.poll() is None:
        os.killpg(proc.pid, 9)
    proc.wait()


def finish_serve_mesh_cli(started):
    """Phase r6's gates: exit 0, one report line (rank 0's), mesh [2, 2]."""
    proc, out, err, t0 = started
    try:
        rc = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        stop_session(started)
        raise
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    records = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
    if rc != 0 or len(records) != 1 or records[0]["mesh"] != [2, 2]:
        raise AssertionError(f"r6: exit {rc}, {len(records)} report lines: "
                             f"{stdout[-2000:]} {stderr[-3000:]}")
    rep = records[0]
    lg = rep["loadgen"]
    log(f"[r6] python -m mpi4dl_tpu_torch.serve --mesh 2x2 --requests 8 --serial 0 "
        f"(synthetic ResNet-v1 @32, beside r5): exit 0 in {time.time() - t0:.1f} s, one "
        f"report line, mesh {rep['mesh']}, buckets {rep['buckets']}, served {lg['served']} of "
        f"{lg['offered']}, p50 {lg['latency_s']['p50'] * 1e3:.1f} ms; "
        f"{[ln for ln in stderr.splitlines() if ln.startswith('# mesh')]}; {card()}")


def phase_serve_bench():
    """Phase r7: the bench's ``serving_amoebanet3_32px`` extra in this
    process: throughput above 0 and an SLO verdict; the engine's lint clean
    (``lint_ok``, no ``lint_findings``); ``attribution`` with attributed
    batches and no error (its device share printed); ``sched_ab`` with both
    arms' tight-class p99 and rps and no deadline miss (the arms' tight p99,
    their ratio and rps printed; whether EDF wins is not gated, as the JAX
    bench does not gate it)."""
    import torch

    from mpi4dl_tpu_torch import bench

    t0 = time.time()
    out = bench.measure_serving(torch.device(DEVICE))
    if not ((out.get("value") or 0) > 0 and "ok" in (out.get("slo") or {})):
        raise AssertionError(f"r7: serving extra {out}")
    if out.get("lint_ok") is not True or "lint_findings" in out:
        raise AssertionError(f"r7: lint_ok {out.get('lint_ok')}, findings "
                             f"{out.get('lint_findings')}")
    attr = out.get("attribution") or {}
    if "error" in attr or not (attr.get("n_steps") or 0) > 0:
        raise AssertionError(f"r7: attribution {attr}")
    ab = out.get("sched_ab") or {}
    arms = ab.get("arms") or {}
    if set(arms) != {"edf", "fifo"} or any(
            a.get("tight_p99_ms") is None or a.get("rps") is None or a.get("deadline_misses")
            for a in arms.values()):
        raise AssertionError(f"r7: sched_ab {ab}")
    step = attr["per_step_mean"] or {}
    share = step["device_busy_s"] / step["wall_s"] if step.get("wall_s") else None
    log(f"[r7] bench.measure_serving (serving_amoebanet3_32px): {out['value']} req/s against "
        f"serial bs1 {out['serial_bs1_rps']} req/s ({out['speedup_vs_serial']}x), latency ms "
        f"{out['latency_ms']}, mean batch {out['mean_batch_size']}, slo ok "
        f"{out['slo']['ok']}, lint ok, in {time.time() - t0:.1f} s; {card()}")
    log(f"[r7] attribution: {attr['n_steps']} mpi4dl_serve_batch steps, a step's mean "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in step.items())
        + (f"; device busy {share:.4f} of a step" if share is not None else "")
        + f"; overlap verdict {attr['overlap']['verdict']}, crosscheck {attr['crosscheck']}")
    log(f"[r7] sched_ab ({ab['classes']}, mix {ab['mix']}, {ab['trials']} trials of "
        f"{ab['requests_per_trial']} requests, medians): tight p99 EDF "
        f"{arms['edf']['tight_p99_ms']} ms against FIFO {arms['fifo']['tight_p99_ms']} ms "
        f"(ratio {ab.get('tight_p99_ratio')}, EDF better: {ab.get('tight_p99_improved')}); "
        f"bulk p99 {arms['edf']['bulk_p99_ms']} / {arms['fifo']['bulk_p99_ms']} ms; rps "
        f"{arms['edf']['rps']} / {arms['fifo']['rps']} ({ab.get('rps_delta_pct')}%); no "
        "deadline miss")
    _r7_trace_cost()


R7_TRACE_PAIRS = 3  # r7's trace-cost A/B: untraced/traced pairs of closed loops


def _r7_trace_cost():
    """r7's trace cost: the serving extra's closed loop (384 requests at
    concurrency 96) on one engine built as ``bench.measure_serving`` builds
    it, ``2·R7_TRACE_PAIRS`` times after a warm-up loop, alternately
    untraced and under ``profiling.trace(all_threads=True)`` (untraced,
    traced, traced, untraced, ...): each arm's median req/s and p99 and the
    trace's cost printed, not gated (the extra's ``value`` is read under
    the trace, as the JAX bench reads it)."""
    import statistics

    import torch

    from mpi4dl_tpu_torch import bench
    from mpi4dl_tpu_torch.profiling import trace
    from mpi4dl_tpu_torch.serve.loadgen import run_closed_loop

    t0 = time.time()
    engine = bench._serving_engine(*bench._serving_model(torch.device(DEVICE)))
    arms = {False: [], True: []}
    engine.start()
    try:
        run_closed_loop(engine, 384, concurrency=96, deadline_s=30.0)
        for i in range(2 * R7_TRACE_PAIRS):
            traced = i % 4 in (1, 2)
            with tempfile.TemporaryDirectory(prefix="mpi4dl-r7-") as tmp:
                with trace(tmp, all_threads=True) if traced else contextlib.nullcontext():
                    rep = run_closed_loop(engine, 384, concurrency=96, deadline_s=30.0)
            arms[traced].append((rep["throughput_rps"], rep["latency_s"]["p99"] * 1e3))
    finally:
        engine.stop()
    rps = {arm: statistics.median(r for r, _ in runs) for arm, runs in arms.items()}
    p99 = {arm: statistics.median(p for _, p in runs) for arm, runs in arms.items()}
    log(f"[r7] the trace's cost ({R7_TRACE_PAIRS} pairs of 384-request closed loops on one "
        f"engine, alternating): untraced {rps[False]:.1f} req/s (p99 {p99[False]:.2f} ms; all "
        f"{[round(r, 1) for r, _ in arms[False]]}), under profiling.trace(all_threads=True) "
        f"{rps[True]:.1f} req/s (p99 {p99[True]:.2f} ms; all "
        f"{[round(r, 1) for r, _ in arms[True]]}): traced / untraced req/s "
        f"{rps[True] / rps[False]:.4f}, in {time.time() - t0:.1f} s; {card()}")


def _sp_serve(rank, grid, device, sp_stats):
    """Phase r3 in one rank: s1's small f32 spatial ResNet-v2 @32 through a
    ``ShardedPredictor`` against the single-device CPU predict; then
    ``resnet_sp`` (bf16) with ``sp_stats`` behind a ``ServingEngine`` on rank
    0 (buckets ``R_SP_BUCKETS``): replay ms a bucket, ``R_SP_REQUESTS``
    requests, then every rank's eager spatial predict of the batches they
    rode in. Returns what rank 0 checks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch import evaluate
    from mpi4dl_tpu_torch.parallel.halo import split_tiles
    from mpi4dl_tpu_torch.serve.batching import pad_batch
    from mpi4dl_tpu_torch.serve.engine import to_host
    from mpi4dl_tpu_torch.serve.sharded import (
        ShardedPredictor,
        serve_or_follow,
        serving_mesh_config,
    )
    from mpi4dl_tpu_torch.train import Trainer

    t0 = time.time()
    out = {}
    name, size, cells, build = sp_small_models()[0]
    plain = _seeded(build(None))
    cal, _ = eval_batches(size)
    stats = [_numpy_stats(s) for s in evaluate.collect_batch_stats(plain, cal)]
    trainer = Trainer(_seeded(build(grid)), serving_mesh_config(SP_GRID, size), learning_rate=0.0,
                      device=device, num_spatial_cells=cells, grid=grid)
    pred = ShardedPredictor(trainer, stats, (size, size, 3))
    if rank == 0:
        rng = np.random.default_rng(SEED + 8)
        errs = []
        for b in R_SP_BUCKETS:
            captured = pred.compile_bucket(b)
            x = rng.standard_normal((b, size, size, 3)).astype(np.float32)
            errs.append(rel_err(pred.run(captured, x).cpu(),
                                evaluate.make_predict(plain)(stats, x)))
        pred.stop()
        out["small"] = (name, errs)
    else:
        pred.follow()
    out["small_k4"] = dict(pred.capture_halo_launches)
    del trainer, pred
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()

    model, cells = sp_models()["resnet_sp"][1](grid, torch.bfloat16)
    _seeded(model)
    trainer = Trainer(model, serving_mesh_config(SP_GRID, SIZE), learning_rate=0.0,
                      device=device, num_spatial_cells=cells, grid=grid)
    pred = ShardedPredictor(trainer, sp_stats, (SIZE, SIZE, 3), dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED + 9)
    xs = [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32) for _ in range(R_SP_REQUESTS)]
    t1 = time.time()
    eng = serve_or_follow(pred, buckets=R_SP_BUCKETS, default_deadline_s=300.0)
    plan = None
    if eng is not None:
        out["warm_s"] = time.time() - t1
        out["warmup"] = eng.warmup_stats()
        out["replay_ms"] = {}
        for b in eng.buckets:
            x = rng.standard_normal((b, SIZE, SIZE, 3)).astype(np.float32)
            times = []
            for _ in range(R_SP_TIMED):
                t = time.perf_counter()
                pred.run(eng._compiled[b], x)
                times.append((time.perf_counter() - t) * 1e3)
            out["replay_ms"][b] = sorted(times)[R_SP_TIMED // 2]
        index = {_row_key(x): i for i, x in enumerate(xs)}
        plan = []  # per staged batch, its request index per row (None: a pad row)
        stage = pred.stage

        def recording(batch):
            plan.append([index.get(_row_key(row)) for row in batch])
            return stage(batch)

        pred.stage = recording
        t = time.time()
        eng.start()
        try:
            futures = [eng.submit(x) for x in xs]
            out["responses"] = [f.result(timeout=300) for f in futures]
        finally:
            eng.stop()  # releases the followers
        out["serve_s"] = time.time() - t
        out["stats"] = eng.stats()
        out["mean_batch"] = out["stats"].get("mean_batch_size")
        del eng
    out["k4"] = dict(pred.capture_halo_launches)
    box = [plan]
    dist.broadcast_object_list(box, src=0)
    stats_dev = evaluate._device_stats(sp_stats, device)
    eager = []
    for rows in box[0]:
        batch = pad_batch([xs[i] for i in rows if i is not None], len(rows), np.float32)
        dist.barrier()
        with evaluate._running(trainer.model, stats_dev):
            logits = trainer.forward(trainer.input_to_device(
                split_tiles(torch.as_tensor(batch).to(torch.bfloat16), grid)))
        eager.append(to_host(logits))
    evaluate._check_rings(trainer)
    if rank == 0:
        out["plan"], out["eager"] = box[0], eager
    out["s"] = time.time() - t0
    del trainer, pred, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_sharded(outs):
    """Phase r3's gates and lines from every rank's :func:`_sp_serve`."""
    import numpy as np

    o = outs[0]
    name, errs = o["small"]
    if not max(errs) <= R_CPU_TOL:
        raise AssertionError(f"r3 {name}: sharded replays against the CPU predict {errs} of max "
                             f"|logit| (tolerance {R_CPU_TOL:g})")
    for r, out in enumerate(outs):
        if sorted(out["k4"]) != list(R_SP_BUCKETS) or min(out["k4"].values()) <= 0:
            raise AssertionError(f"r3 rank {r}: K4 launches recorded in the captures {out['k4']}")
        if sorted(out["small_k4"]) != list(R_SP_BUCKETS) or min(out["small_k4"].values()) <= 0:
            raise AssertionError(f"r3 rank {r}: small model's K4 launches in the captures "
                                 f"{out['small_k4']}")
    seen = 0
    for rows, want in zip(o["plan"], o["eager"]):
        for r, i in enumerate(rows):
            if i is None:
                continue
            got = o["responses"][i]
            if not (got.shape == want[r].shape and np.array_equal(got, want[r])):
                raise AssertionError(f"r3: request {i}'s response differs from row {r} of the "
                                     f"eager spatial predict of its padded batch")
            seen += 1
    if seen != R_SP_REQUESTS or o["stats"]["served"] != R_SP_REQUESTS:
        raise AssertionError(f"r3: {seen} rows matched, {o['stats']['served']} served of "
                             f"{R_SP_REQUESTS}")
    log(f"[r3] {name} f32 (TF32 off), 2x2 tiles, ShardedPredictor buckets {R_SP_BUCKETS}: "
        f"against the single-device CPU predict {['%.2e' % e for e in errs]} of max |logit| "
        f"(tolerance {R_CPU_TOL:g}); K4 phase launches in each bucket's capture "
        f"{o['small_k4']} (rank 0)")
    w = o["warmup"]["buckets"]
    log(f"[r3] resnet_sp: ResNet-{RESNET_DEPTH} v2 @{SIZE} bf16 on 2x2 tiles with v3's "
        f"statistics behind a ServingEngine on rank 0 (the others follow), buckets "
        f"{R_SP_BUCKETS} warm in {o['warm_s']:.1f} s: "
        + "; ".join(f"bucket {b}: warm-up {w[str(b)]['trace_s']:.2f} s, capture "
                    f"{w[str(b)]['compile_s']:.2f} s, replay {o['replay_ms'][b]:.1f} ms (host "
                    f"wall with the broadcast, the eager join and the rings' check, median of "
                    f"{R_SP_TIMED})" for b in R_SP_BUCKETS)
        + f"; K4 phase launches in each bucket's capture by rank "
        f"{[out['k4'] for out in outs]}; {card()}")
    lat = o["stats"]["latency_s"]
    log(f"[r3] {R_SP_REQUESTS} requests at once in {o['serve_s']:.2f} s: served "
        f"{o['stats']['served']} in {o['stats']['batches']} batches, latency p50 "
        f"{lat['p50'] * 1e3:.1f} ms, p99 {lat['p99'] * 1e3:.1f} ms; every response bit-equal to its "
        f"row of the eager spatial predict of its padded batch; phase r3 "
        f"{max(out['s'] for out in outs):.1f} s in the ranks")


def _serve_world(rank, world):
    """Phase r3 in a 4-rank world of its own (``--serve-only``): v3's
    statistics (``spatial_collect_batch_stats`` of ``resnet_sp`` over
    ``V_BATCHES`` ClassPatternImages batches), then :func:`_sp_serve`."""
    import torch

    from mpi4dl_tpu_torch import evaluate
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.data import ClassPatternImages
    from mpi4dl_tpu_torch.ops import halo_kernel
    from mpi4dl_tpu_torch.parallel.multihost import TileGrid
    from mpi4dl_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device())
    grid = TileGrid(SP_GRID, rank)
    halo_kernel.open_rings(grid, device)
    model, cells = sp_models()["resnet_sp"][1](grid, torch.bfloat16)
    _seeded(model)
    cfg = ParallelConfig(batch_size=BATCH, image_size=SIZE, spatial_size=1,
                         num_spatial_parts=SP_RANKS)
    trainer = Trainer(model, cfg, device=device, num_spatial_cells=cells, grid=grid)
    ds = ClassPatternImages(BATCH, SIZE, 10, seed=SEED)
    stats = evaluate.spatial_collect_batch_stats(trainer, [ds.batch(i)[0]
                                                           for i in range(V_BATCHES)])
    del trainer, model
    gc.collect()
    out = _sp_serve(rank, grid, device, stats)
    halo_kernel.close_rings(grid)
    return out


def phase_serve_world():
    from mpi4dl_tpu_torch.benchmarks.common import rank_layout
    from mpi4dl_tpu_torch.parallel import multihost

    backend, desc, env = rank_layout(SP_RANKS, DEVICE)
    log(f"[r3] {desc}, 2x2 tile grid")
    outs = multihost.spawn(_serve_world, SP_RANKS, backend=backend, timeout=600, env=env)
    phase_serve_sharded(outs)


# Phase f: the replica fleet (``mpi4dl_tpu_torch.fleet``). In the full run its
# replicas start beside phase v1 (which, like phase e beside it, times
# nothing) and f1-f2 run after phase e ends; ``--fleet-only`` adds f3.
F_REPLICAS = 2
F_MAX_BATCH = 2
F_CANARY_S = 2.0  # the replicas' numerics-sentinel interval
F_IMAGES = 6  # distinct seeded images the loads cycle through
F_CONCURRENCY = 4
F1_REQUESTS = 12  # the steady load before the fault, and again after recovery
F2_REQUESTS = 24  # the kill drill's load: kill:1 after a quarter of it is answered
F_TIMEOUT = 300.0  # every wait on a replica, a router, a future
F_HEARTBEAT_S = 5.0  # the supervisor's heartbeat staleness limit
# /healthz 503s in a row before the supervisor replaces a replica (10 s at its
# 0.25 s tick): longer than the heartbeat limit, so a wedge takes the
# heartbeat path.
F_UNHEALTHY_PROBES = 40
F_WEDGE_REQUESTS = 16
F_FENCE_SLACK_S = 3.0  # a canary probe's own forward and the scrape, past the interval
F_MESH_SIZE = 32  # f3's mesh replica: the synthetic ResNet-v1 depth 8, 2 spatial cells
F_MESH_REQUESTS = 6


def _f_env():
    here = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


def _f_worker_args(tele, size, depth, extra=()):
    return ["--image-size", str(size), "--depth", str(depth), "--max-batch", str(F_MAX_BATCH),
            "--no-tf32", "--canary-interval", str(F_CANARY_S), "--watchdog-min-timeout", "2",
            "--default-deadline-s", str(F_TIMEOUT), "--telemetry-dir", tele,
            *([] if DEVICE == "cuda" else ["--device", DEVICE]), *extra]


def _f_get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def _f_wait(cond, what, timeout_s=F_TIMEOUT, poll_s=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(poll_s)
    if not cond():
        raise AssertionError(f"f: {what} not within {timeout_s:.0f} s")


def start_fleet():
    """Phase f, started: two supervised ResNet-110 v2 @1024 f32 replicas
    (``python -m mpi4dl_tpu_torch.fleet.worker``, a captured graph per
    bucket 1 and 2) and one router process with its journal, federation
    and its autoscale gauge on. Returns what :func:`finish_fleet` reads."""
    import types

    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.fleet.supervisor import FleetSupervisor
    from mpi4dl_tpu_torch.telemetry.autoscale import AutoscaleConfig

    tmp = tempfile.TemporaryDirectory(prefix="mpi4dl-f-")
    tele = os.path.join(tmp.name, "tele")
    events = telemetry.JsonlWriter(tele, filename="fleet-events.jsonl")
    sup = FleetSupervisor(
        _f_worker_args(tele, SIZE, RESNET_DEPTH), routers=1,
        router_args=["--image-size", str(SIZE), "--max-attempts", "4",
                     "--inflight-per-replica", "2", "--health-interval", "0.1",
                     "--default-deadline-s", str(F_TIMEOUT), "--telemetry-dir", tele],
        replicas=F_REPLICAS, max_replicas=F_REPLICAS,
        federation=telemetry.SLOConfig(availability=0.999, interval_s=0.5, autoscale=(
            AutoscaleConfig(min_replicas=F_REPLICAS, max_replicas=F_REPLICAS))),
        env=_f_env(), events=events, base_dir=os.path.join(tmp.name, "fleet"),
        reconcile_interval_s=0.25, heartbeat_timeout_s=F_HEARTBEAT_S,
        unhealthy_after=F_UNHEALTHY_PROBES, backoff_base_s=0.1, backoff_max_s=0.5,
        spawn_timeout_s=F_TIMEOUT)
    t0 = time.time()
    sup.start()
    return types.SimpleNamespace(sup=sup, tmp=tmp, tele=tele, events=events, t0=t0)


def stop_fleet(started) -> None:
    """Phase f's processes ended (SIGTERM, then SIGKILL) and its folder removed."""
    try:
        started.sup.close()
    finally:
        started.events.close()
        started.tmp.cleanup()


def _f_reference(images):
    """The parent's own predict of each image with the replicas' model: the
    ResNet-110 v2 @1024 of ``fleet/worker.py``, weights from seed 0,
    calibrated on ``default_rng(0)``'s batch of 4, on the card (TF32 off)."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch import evaluate
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.serve.engine import to_host
    from mpi4dl_tpu_torch.weights import init

    model = get_resnet_v2(RESNET_DEPTH, 10, pool_kernel=SIZE // 4)
    init(model, torch.Generator().manual_seed(0))
    model = model.to(DEVICE, memory_format=torch.channels_last if DEVICE == "cuda"
                     else torch.contiguous_format)
    rng = np.random.default_rng(0)
    stats = evaluate.collect_batch_stats(
        model, [rng.standard_normal((4, SIZE, SIZE, 3)).astype(np.float32)])
    predict = evaluate.make_predict(model)
    out = [to_host(predict(stats, x[None]))[0] for x in images]
    del model, stats
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _f_load(client, images, n, tag, on_answer=None):
    """A closed loop of ``n`` requests through ``client``, ``F_CONCURRENCY``
    at a time, each its own trace id ``f-<tag>-<i>``: returns the answers
    ``(i, trace_id, logits, latency_s, done_at)`` and the wall seconds."""
    import threading

    answers, errors = [], []
    lock = threading.Lock()

    def worker(w):
        for i in range(w, n, F_CONCURRENCY):
            tid = f"f-{tag}-{i}"
            t = time.perf_counter()
            try:
                out = client.submit(images[i % len(images)], deadline_s=F_TIMEOUT,
                                    trace_id=tid).result(timeout=F_TIMEOUT)
            except Exception as e:  # noqa: BLE001 — every failure fails the phase below
                errors.append(f"{tid}: {type(e).__name__}: {e}")
                continue
            done = time.perf_counter()
            with lock:
                answers.append((i, tid, out, done - t, done))
                k = len(answers)
            if on_answer is not None:
                on_answer(k)

    threads = [threading.Thread(target=worker, args=(w,), name=f"f-load-{w}")
               for w in range(F_CONCURRENCY)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * F_TIMEOUT)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"f {tag}: the load did not end")
    if errors or len(answers) != n:
        raise AssertionError(f"f {tag}: {len(answers)} of {n} answered; {errors[:4]}")
    return answers, time.perf_counter() - t0


def _f_check_answers(answers, want, tag):
    """Every answer within ``R_EAGER_TOL`` of max |logit| of the parent's
    predict of its image (a row rides in bucket 1 or 2)."""
    import numpy as np

    worst = 0.0
    for i, tid, got, _, _ in answers:
        ref = want[i % len(want)]
        err = float(np.max(np.abs(np.asarray(got) - ref)) / np.max(np.abs(ref)))
        worst = max(worst, err)
        if not err <= R_EAGER_TOL:
            raise AssertionError(f"f {tag}: {tid} is {err:.3e} of max |logit| from the "
                                 f"parent's predict (tolerance {R_EAGER_TOL:g})")
    return worst


def _f_metric(text, line_start):
    """The value of the Prometheus sample whose line starts with ``line_start``."""
    for ln in text.splitlines():
        if ln.startswith(line_start + " "):
            return float(ln.rsplit(" ", 1)[1])
    return None


def _f_peak(slot):
    """A replica's largest bucket capture peak and graph pool, from the
    footprint ledger its ready handshake names."""
    path = (slot.ports or {}).get("ledger")
    entries = json.load(open(path))["entries"] if path and os.path.exists(path) else []
    peaks = [e.get("peak_bytes") or 0 for e in entries]
    pools = [e.get("pool_bytes") or 0 for e in entries]
    return (max(peaks) / 2**30 if peaks else 0.0), (max(pools) / 2**30 if pools else 0.0)


def _f_snapshot_value(url, metric, **labels):
    snap = json.loads(_f_get(url + "/snapshotz"))
    total = 0.0
    for s in snap.get("metrics", {}).get(metric, {}).get("series", ()):
        if all(s.get("labels", {}).get(k) == v for k, v in labels.items()):
            total += s.get("value", 0)
    return total


def _f_log_tails(folder, max_bytes=3000):
    """Print the end of each replica's and router's log in ``folder``."""
    for name in sorted(os.listdir(folder)) if os.path.isdir(folder) else ():
        if name.endswith(".log"):
            with open(os.path.join(folder, name), "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - max_bytes))
                tail = f.read().decode("utf-8", "replace")
            log(f"[f] {name}, its end:\n{tail}")


def _f_served_twice(tele):
    """Trace ids served more than once across the replicas' span logs (the
    flight recorder's dumps repeat spans of the log, and are left out)."""
    from mpi4dl_tpu_torch.telemetry.incident import collect_events

    logs = [os.path.join(tele, f) for f in sorted(os.listdir(tele))
            if f.endswith(".jsonl") and not f.startswith("flight-")]
    served = collections.Counter(
        e["trace_id"] for e in collect_events(logs)
        if e.get("kind") == "span" and e.get("name") == "serve.request"
        and e["attrs"].get("outcome") == "served")
    return {t: n for t, n in served.items() if n > 1}, len(served)


def finish_fleet(started, drills=False, keep=None):
    """Phase f's f1-f2 (and f3 with ``drills``) on the fleet
    :func:`start_fleet` started; the fleet is closed in every case. With
    ``keep`` (a directory), the fleet's telemetry and the serving
    replicas' ledger dumps are copied there (``tele/``, ``ledgers/``) for
    phase n7 before the fleet's folder goes. Returns the seconds spent
    here."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch import telemetry
    from mpi4dl_tpu_torch.fleet.chaos import inject, parse_chaos_spec
    from mpi4dl_tpu_torch.fleet.frontdoor import RouterSetClient
    from mpi4dl_tpu_torch.profiling import percentiles
    from mpi4dl_tpu_torch.telemetry.federation import FederatedAggregator

    sup, tele = started.sup, started.tele
    t_here = time.time()
    agg = client = mesh = None
    try:
        if drills:
            mesh = _f_start_mesh()  # f3's mesh replica starts beside f1-f2
        rng = np.random.default_rng(SEED + 11)
        images = [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
                  for _ in range(F_IMAGES)]
        want = _f_reference(images)
        sup.wait_ready(timeout_s=F_TIMEOUT)
        up_s = time.time() - started.t0
        slots = [sup.slot_by_index(i) for i in range(F_REPLICAS)]
        first = {s.name: (s.pid, dict(s.ports.get("phases") or {}), _f_peak(s)) for s in slots}
        log(f"[f] fleet up {up_s:.1f} s after its start ({time.time() - t_here:.1f} s waited "
            f"here, the parent's reference predicts included): {F_REPLICAS} replicas of "
            f"ResNet-{RESNET_DEPTH} v2 @{SIZE} f32 (TF32 off, buckets 1 and {F_MAX_BATCH}, a "
            f"captured graph each), 1 router process with its journal; cold start (worker "
            "phases, s): " + "; ".join(
                f"{n} " + ", ".join(f"{k} {v:.2f}" for k, v in ph.items())
                + f", capture peak {pk:.2f} GiB, graph pool {pl:.2f} GB"
                for n, (_, ph, (pk, pl)) in first.items()))
        # The drill's scorer: its own aggregator over the serving replicas (a
        # fast scrape; the supervisor's deregisters a dead slot at once).
        agg = FederatedAggregator(replicas={
            s.name: f"http://127.0.0.1:{s.ports['metrics_port']}" for s in slots},
            events=telemetry.JsonlWriter(tele, filename="incidents-f.jsonl"),
            interval_s=0.05, timeout_s=2.0)
        agg.incidents.telemetry_dir = tele
        agg.start()
        fed = agg.serve(port=0)
        client = RouterSetClient(sup.router_submit_urls(), example_shape=(SIZE, SIZE, 3),
                                 default_deadline_s=F_TIMEOUT, telemetry_dir=tele)

        # f1: steady load; the federated /metrics counts both replicas and
        # the requests they served.
        a1, wall1 = _f_load(client, images, F1_REQUESTS, "f1")
        err1 = _f_check_answers(a1, want, "f1")

        def fed_served():
            text = _f_get(f"http://127.0.0.1:{fed.port}/metrics")
            return (_f_metric(text, 'federation_replicas{state="up"}'),
                    _f_metric(text, 'serve_requests_total{outcome="served"}'))

        _f_wait(lambda: fed_served() == (F_REPLICAS, F1_REQUESTS),
                f"the federated /metrics at {F_REPLICAS} replicas up and {F1_REQUESTS} served "
                f"(last {fed_served()})", timeout_s=30)
        log(f"[f1] {F1_REQUESTS} requests ({F_CONCURRENCY} at a time, {F_IMAGES} seeded images) "
            f"through RouterSetClient in {wall1:.2f} s, {F1_REQUESTS / wall1:.2f} req/s; every "
            f"answer within {err1:.2e} of max |logit| of the parent's predict (tolerance "
            f"{R_EAGER_TOL:g}); the federated /metrics: {F_REPLICAS} replicas up, "
            f"{F1_REQUESTS} served, as the client counted")

        # f2: kill -9 replica 1 once a quarter of the load is answered and
        # the router has requests in its in-flight ledger.
        import threading

        router_url = next(iter(sup.router_metrics_urls().values()))
        requeued0 = _f_snapshot_value(router_url, "fleet_requeues_total")
        victim = slots[1].pid
        killed, kill_lock = {}, threading.Lock()

        def kill_once(k):
            with kill_lock:
                if (k >= F2_REQUESTS // 4 and not killed and _f_snapshot_value(
                        router_url, "fleet_inflight", replica="r1") > 0):
                    killed["t"] = time.perf_counter()
                    killed["k"] = k
                    killed["record"] = inject(parse_chaos_spec("kill:1"), sup)

        a2, wall2 = _f_load(client, images, F2_REQUESTS, "f2", on_answer=kill_once)
        if not killed or killed["record"]["pid"] != victim:
            raise AssertionError(f"f2: the kill did not land on r1 ({killed})")
        err2 = _f_check_answers(a2, want, "f2")
        t_kill = killed["t"]
        before = [a for a in a2 if a[4] <= t_kill]
        during = [a for a in a2 if a[4] > t_kill]
        t_first = min(a[4] - a[3] for a in a2)
        end2 = max(a[4] for a in a2)
        requeued = _f_snapshot_value(router_url, "fleet_requeues_total") - requeued0
        if requeued < 1:
            raise AssertionError(f"f2: the router requeued {requeued} requests, not >= 1")
        _f_wait(lambda: sup.running_count() == F_REPLICAS and sup.slot_by_index(1).pid != victim
                and sup.last_recovery_s is not None, "the replacement of r1 ready")
        if sup.restarts != 1:
            raise AssertionError(f"f2: the supervisor recorded {sup.restarts} restarts, not 1")
        recovery_s, phases = sup.last_recovery_s, dict(sup.last_recovery_phases or {})
        new = sup.slot_by_index(1)
        # The incident: the availability page opened it; the replacement
        # joins the scrape, the page resolves and the incident closes.
        _f_wait(lambda: agg.incidents.opened_total >= 1, "an incident open", timeout_s=60)
        agg.add_replica("r1", f"http://127.0.0.1:{new.ports['metrics_port']}")
        _f_wait(lambda: agg.incidents.closed_total >= 1, "the incident closed", timeout_s=60)
        incidentz = json.loads(_f_get(f"http://127.0.0.1:{fed.port}/incidentz"))
        pm = incidentz["closed"][-1]
        cause = pm.get("first_cause") or {}
        if (incidentz["counts"] != {"opened": 1, "closed": 1}
                or cause.get("event") != "chaos.injected"
                or not str(cause.get("attrs", {}).get("op", "")).startswith("kill:r1")):
            raise AssertionError(f"f2: /incidentz {incidentz['counts']}, first cause {cause}")
        # After: the same steady load on the restored fleet.
        a3, wall3 = _f_load(client, images, F1_REQUESTS, "f2-after")
        err3 = _f_check_answers(a3, want, "f2 after")
        lat = percentiles([a[3] for a in a1 + a2 + a3])
        log(f"[f2] kill:1 (SIGKILL r1, pid {victim}, requests in its in-flight ledger) after "
            f"{killed['k']} of {F2_REQUESTS} answers: every request answered once ({F2_REQUESTS} distinct trace ids), "
            f"{int(requeued)} requeued by the router, answers within {max(err2, err3):.2e} of "
            f"max |logit|; 1 restart, the replacement (pid {new.pid}) ready {recovery_s:.2f} s "
            "after the death (" + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
            + f" s); req/s before {F1_REQUESTS / wall1:.2f}, during "
            f"{len(during) / max(end2 - t_kill, 1e-9):.2f} (the {len(during)} answers after the "
            f"kill over {end2 - t_kill:.2f} s; the load's first quarter "
            f"{len(before) / max(t_kill - t_first, 1e-9):.2f}), after {F1_REQUESTS / wall3:.2f}; "
            f"latency p50 {lat['p50'] * 1e3:.0f}, p90 {lat['p90'] * 1e3:.0f}, p99 "
            f"{lat['p99'] * 1e3:.0f} ms; incident {pm['incident']['id']} opened by "
            f"{pm['incident']['opened_by']}, first cause {cause.get('label')!r}, MTTA "
            f"{pm['incident'].get('mtta_s')} s, MTTR {pm['incident'].get('mttr_s')} s; "
            f"replacement capture peak {_f_peak(new)[0]:.2f} GiB; {card()}")
        if drills:
            _f_wedge(sup, client, images, want, agg)
            _f_corrupt(sup, agg)
            _f_finish_mesh(mesh)
            mesh = None
        client.close()
        client = None
        agg.close()
        agg = None
        if keep is not None:  # the dumps sit in the run folder close() removes
            os.makedirs(os.path.join(keep, "ledgers"), exist_ok=True)
            for i in range(F_REPLICAS):
                dump = (sup.slot_by_index(i).ports or {}).get("ledger")
                if dump and os.path.exists(dump):
                    shutil.copy(dump, os.path.join(keep, "ledgers", f"r{i}.ledger.json"))
        sup.close()  # every replica's span log flushed
        if keep is not None:
            shutil.copytree(tele, os.path.join(keep, "tele"))
        twice, n_spans = _f_served_twice(tele)
        twice = {t: n for t, n in twice.items() if t.startswith(("f-f1-", "f-f2-"))}
        if twice:
            raise AssertionError(f"f: trace ids served more than once: {twice}")
        log(f"[f] no trace id of f1-f2 served twice in the replicas' span logs ({n_spans} "
            "served spans; a killed replica's unflushed spans die with it)")
        stop_fleet(started)
        started = None
    finally:
        if client is not None:
            client.close()
        if agg is not None:
            agg.close()
        if mesh is not None:
            _f_stop_mesh(mesh)
        if started is not None:  # a gate failed: show the processes' own logs
            _f_log_tails(os.path.join(started.tmp.name, "fleet"))
            stop_fleet(started)
    torch.cuda.empty_cache()
    return time.time() - t_here


def _f_wedge(sup, client, images, want, agg):
    """f3, the wedge drill: replica 0's batcher blocks mid-dispatch (its HTTP
    and heartbeat threads alive); its watchdog trips with work outstanding,
    the health-gated heartbeat goes stale and the supervisor kills and
    replaces it; the requests it held are requeued and answered."""
    from mpi4dl_tpu_torch.fleet.chaos import inject, parse_chaos_spec

    victim = sup.slot_by_index(0)
    pid = victim.pid
    hb0 = sup.registry.get("fleet_replica_restarts_total").value(replica="r0",
                                                                  reason="heartbeat") or 0
    t0 = time.perf_counter()
    inject(parse_chaos_spec("wedge:0"), sup)
    answers, wall = _f_load(client, images, F_WEDGE_REQUESTS, "f3-wedge")
    worst = _f_check_answers(answers, want, "f3 wedge")
    _f_wait(lambda: (sup.registry.get("fleet_replica_restarts_total").value(
        replica="r0", reason="heartbeat") or 0) > hb0, "r0 replaced on a stale heartbeat")
    t_kill = time.perf_counter() - t0
    _f_wait(lambda: sup.running_count() == F_REPLICAS and sup.slot_by_index(0).pid != pid,
            "r0's replacement ready")
    new = sup.slot_by_index(0)
    agg.add_replica("r0", f"http://127.0.0.1:{new.ports['metrics_port']}")
    log(f"[f3] wedge:0 (r0's batcher blocked, pid {pid}): {F_WEDGE_REQUESTS} requests all "
        f"answered in {wall:.2f} s (within {worst:.2e} of max |logit|); the watchdog tripped, "
        f"the heartbeat went stale (limit {F_HEARTBEAT_S:g} s) and the supervisor killed r0 "
        f"{t_kill:.2f} s after the wedge (reason heartbeat); its replacement (pid {new.pid}) "
        f"ready {sup.last_recovery_s:.2f} s after the death: the hang detector end to end")


def _f_corrupt(sup, agg):
    """f3, the corrupt drill: bits flipped in replica 1's live parameters,
    which its captured graphs read; its numerics fence trips within the
    canary interval (``/healthz`` fenced, ``/predict`` 503), the federation's
    numerics-skew page names it and the supervisor replaces it."""
    import numpy as np

    from mpi4dl_tpu_torch.fleet.chaos import inject, parse_chaos_spec
    from mpi4dl_tpu_torch.fleet.replica import ReplicaUnreachable

    slot = sup.slot_by_index(1)
    pid, client = slot.pid, slot.client
    health = f"http://127.0.0.1:{slot.ports['metrics_port']}/healthz"
    t0 = time.perf_counter()
    record = inject(parse_chaos_spec("corrupt:1"), sup)
    fenced = {}

    def fence_seen():
        import urllib.error

        try:
            payload = json.loads(_f_get(health))
        except urllib.error.HTTPError as e:  # 503: unhealthy, the payload says why
            payload = json.loads(e.read().decode())
        except OSError:
            return False
        if payload.get("fenced"):
            fenced["t"] = time.perf_counter() - t0
            return True
        return False

    try:
        _f_wait(fence_seen, "r1's numerics fence", timeout_s=F_CANARY_S + F_FENCE_SLACK_S,
                poll_s=0.02)
    except AssertionError as e:
        raise AssertionError(f"{e}; r1's numerics view {_f_get(health)[-1500:]}") from None
    try:
        client.predict(np.zeros((SIZE, SIZE, 3), np.float32), "f3-corrupt-probe", 30.0, 60.0)
        answer = "an answer"
    except ReplicaUnreachable as e:
        answer = str(e)
    reasons = sup.registry.get("fleet_replica_restarts_total")
    if "numerics_fenced" not in answer and not reasons.value(replica="r1", reason="numerics"):
        raise AssertionError(f"f3 corrupt: /predict gave {answer!r} after the fence")
    _f_wait(lambda: agg.numerics_alert.state == "firing" or any(
        t["attrs"]["to"] == "firing" for t in agg.numerics_transitions),
        "the numerics_divergence page", timeout_s=30)
    firing = [t for t in agg.numerics_transitions if t["attrs"]["to"] == "firing"]
    if not firing or firing[0]["attrs"]["replica"] != "r1":
        raise AssertionError(f"f3 corrupt: the numerics page named "
                             f"{[t['attrs']['replica'] for t in firing]}, not r1")
    _f_wait(lambda: (reasons.value(replica="r1", reason="numerics") or 0) >= 1
            and sup.running_count() == F_REPLICAS and sup.slot_by_index(1).pid != pid,
            "r1 quarantined and replaced")
    log(f"[f3] corrupt:1 ({record['forensics']['bits']} bits of "
        f"{record['forensics']['leaf']} in r1's live parameters, which its graphs read): the "
        f"fence tripped {fenced['t']:.2f} s after (canary interval {F_CANARY_S:g} s), /predict "
        f"then {answer.split(': ', 1)[-1]!r}; the numerics_divergence page named r1 "
        f"({firing[0]['attrs']['evidence']}); replaced under reason numerics")


def _f_start_mesh():
    """f3's mesh replica, started: one ``--mesh 2x2`` replica (four rank
    processes on the card, K4 in its graphs) of the synthetic ResNet-v1
    depth 8 @``F_MESH_SIZE`` behind an in-process router."""
    import types

    from mpi4dl_tpu_torch.fleet import Router
    from mpi4dl_tpu_torch.fleet.supervisor import FleetSupervisor

    tmp = tempfile.TemporaryDirectory(prefix="mpi4dl-f3-")
    router = Router(example_shape=(F_MESH_SIZE, F_MESH_SIZE, 3), max_attempts=2,
                    default_deadline_s=F_TIMEOUT, health_interval_s=0.2)
    sup = FleetSupervisor(
        _f_worker_args(tmp.name, F_MESH_SIZE, 8, ["--mesh", "2x2"]), router=router,
        replicas=1, max_replicas=1, env=_f_env(), base_dir=tmp.name,
        reconcile_interval_s=0.25, heartbeat_timeout_s=30.0, spawn_timeout_s=F_TIMEOUT)
    sup.start()
    return types.SimpleNamespace(sup=sup, router=router, tmp=tmp, t0=time.time())


def _f_stop_mesh(mesh):
    try:
        mesh.sup.close()
        mesh.router.stop(drain=False)
    finally:
        mesh.tmp.cleanup()


def _f_finish_mesh(mesh):
    """f3's mesh replica, checked: K4 launched in its bucket captures, and
    its answers within ``R_CPU_TOL`` of max |logit| of the single-device
    predict of the same seeded model on the card, as phase r3 holds them."""
    import numpy as np
    import torch

    from mpi4dl_tpu_torch import evaluate
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
    from mpi4dl_tpu_torch.serve.engine import to_host
    from mpi4dl_tpu_torch.weights import init

    try:
        mesh.sup.wait_ready(timeout_s=F_TIMEOUT)
        up_s = time.time() - mesh.t0
        slot = mesh.sup.slot_by_index(0)
        h = json.loads(_f_get(f"http://127.0.0.1:{slot.ports['metrics_port']}/healthz"))
        rng = np.random.default_rng(SEED + 12)
        xs = [rng.standard_normal((F_MESH_SIZE, F_MESH_SIZE, 3)).astype(np.float32)
              for _ in range(F_MESH_REQUESTS)]
        futs = [mesh.router.submit(x, deadline_s=F_TIMEOUT) for x in xs]
        got = [f.result(timeout=F_TIMEOUT) for f in futs]
    finally:
        _f_stop_mesh(mesh)
    plain = get_resnet_v1(8, 10, pool_kernel=F_MESH_SIZE // 4)
    init(plain, torch.Generator().manual_seed(0))
    plain = plain.to(DEVICE, memory_format=torch.channels_last if DEVICE == "cuda"
                     else torch.contiguous_format)
    cal = np.random.default_rng(0).standard_normal((4, F_MESH_SIZE, F_MESH_SIZE, 3))
    stats = evaluate.collect_batch_stats(plain, [cal.astype(np.float32)])
    want = to_host(evaluate.make_predict(plain)(stats, np.stack(xs)))
    errs = [float(np.max(np.abs(g - w)) / np.max(np.abs(w))) for g, w in zip(got, want)]
    if h.get("mesh") != [2, 2] or not h.get("halo_shifts"):
        raise AssertionError(f"f3 mesh: /healthz mesh {h.get('mesh')}, K4 launches in the "
                             f"captures {h.get('halo_shifts')}")
    if not max(errs) <= R_CPU_TOL:
        raise AssertionError(f"f3 mesh: answers {max(errs):.3e} of max |logit| from the "
                             f"single-device predict (tolerance {R_CPU_TOL:g})")
    log(f"[f3] one --mesh 2x2 replica (4 rank processes on the card) of the synthetic "
        f"ResNet-v1 depth 8 @{F_MESH_SIZE} f32 behind a router, ready {up_s:.1f} s after its "
        f"start: K4 launched {h['halo_shifts']} times in its largest bucket's capture; "
        f"{F_MESH_REQUESTS} answers within {max(errs):.2e} of max |logit| of the "
        f"single-device predict (tolerance {R_CPU_TOL:g})")


# Phase n3: the lint CLI's configurations, at the main paths' widths and
# size: ResNet-v1 depth 110 (the JAX CLI builds v1) and AmoebaNet-D
# 18L/416F, @1024 bs2 (f32, the CLI's step).
_N3_RESNET = ["--model", "resnet", "--depth", str(RESNET_DEPTH), "--size", str(SIZE),
              "--batch", str(BATCH)]
N3_RUNS = {
    "resnet one device": [*_N3_RESNET, "--dp", "1", "--spatial-parts", "0"],
    "amoebanet one device": ["--model", "amoebanet", "--layers", str(LAYERS), "--filters",
                             str(FILTERS), "--size", str(SIZE), "--batch", str(BATCH),
                             "--dp", "1"],
    "resnet 2x2 spatial": _N3_RESNET,
    "resnet --dp 2": [*_N3_RESNET, "--spatial-parts", "0", "--dp", "2"],
}
N3_KEYS = {"module_name", "is_scheduled", "platform", "config", "inventory", "collectives",
           "overlap", "memory", "findings", "max_severity", "ok"}
# Phases n4-n6: the A/B harnesses at the main paths' size (ResNet-v1 depth
# 110 @1024, as the JAX harnesses build v1).
N_MODEL = ["--size", str(SIZE), "--depth", str(RESNET_DEPTH)]
N4_ARGV = ["sp-overlap", *N_MODEL, "--batch", str(BATCH), "--steps", "2", "--bf16"]
N5_ARGV = ["pipeline", *N_MODEL, "--batch", "4", "--parts", "4", "--steps", "2", "--bf16"]
N6_ARGV = ["serving-sharded", *N_MODEL, "--bucket", "4", "--requests", "16"]
# Phase n8: the cross-predictor audit at the main paths' size, f32.
N8_ARGV = ["numerics", *N_MODEL, "--mesh", "2x2"]
# Phase n9: the train probes beside the bench's own measurement of the same
# point (``peak_pixels --one``: ``bench.train_throughput``, remat=False
# first), then the two bisections.
N9_PEAK_RTOL = 0.02
N9_TRAIN = [
    ("resnet_2048", ["--model", "resnet", "--resnet-version", "2", "--depth",
                     str(RESNET_DEPTH), "--size", "2048", "--batch", "1", "--dtype", "bfloat16"],
     ["--one", "2048", "--model", "resnet", "--batch", "1"]),
    ("amoebanet_1024", ["--model", "amoebanet", "--layers", str(LAYERS), "--filters",
                        str(FILTERS), "--size", str(SIZE), "--batch", str(BATCH), "--dtype",
                        "bfloat16"],
     ["--one", str(SIZE), "--model", "amoebanet", "--batch", str(BATCH)]),
]
N9_BISECT_PX = ["--program", "train", *N9_TRAIN[0][1], "--bisect", "px",
                "--px-candidates", "1024,2048,4096"]
N9_SERVE = ["--program", "serve", "--model", "amoebanet", "--layers", str(LAYERS),
            "--filters", str(FILTERS), "--size", str(SIZE), "--dtype", "bfloat16"]
# Phase n10: the cost model of n3's 2x2 spatial step, in bf16.
N10_ARGV = ["costmodel", "--interconnect", "nvlink", "--size", str(SIZE), "--batch",
            str(BATCH), "--depth", str(RESNET_DEPTH), "--bf16", "--steps", "2"]


def _analyze(argv, timeout=900):
    """``python -m mpi4dl_tpu_torch.analyze`` with ``argv`` as a subprocess:
    (exit code, its last JSON line or None, stdout, stderr, wall s)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("MPI4DL_TPU_CONV_OVERLAP", None)
    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", "mpi4dl_tpu_torch.analyze", *argv], cwd=here,
                         env=env, capture_output=True, text=True, timeout=timeout)
    last = next((json.loads(ln) for ln in reversed(out.stdout.splitlines())
                 if ln.startswith("{")), None)
    return out.returncode, last, out.stdout, out.stderr, time.time() - t0


def phase_lint_cli():
    """Phase n3: the lint CLI on ``N3_RUNS`` (see the docstring); returns
    each run's report."""
    reports = {}
    for name, flags in N3_RUNS.items():
        with tempfile.TemporaryDirectory(prefix="mpi4dl-n3-") as tmp:
            path = os.path.join(tmp, "report.json")
            rc, _, stdout, stderr, wall = _analyze([*flags, "--json", path])
            if rc != 0 or not os.path.exists(path):
                raise AssertionError(f"[n3] analyze {' '.join(flags)} exited {rc}: "
                                     f"{stdout[-2000:]} {stderr[-2000:]}")
            with open(path) as f:
                rep = json.load(f)
        if not N3_KEYS <= set(rep) or not rep["ok"]:
            raise AssertionError(f"[n3] analyze {' '.join(flags)}: keys {sorted(rep)}, "
                                 f"ok {rep.get('ok')}")
        log(f"[n3] analyze {' '.join(flags)} ({name}): exit 0 in {wall:.1f} s; "
            f"{stdout.strip().splitlines()[-1] if stdout.strip() else ''}; inventory "
            f"{ {k: v for k, v in rep['inventory'].items() if v} }; window "
            f"{rep['config'].get('halo_shifts')}; peak "
            f"{(rep['memory'] or {}).get('peak_bytes')} B; findings "
            f"{[(f['rule'], f['severity']) for f in rep['findings']]}")
        reports[name] = rep
    return reports


def _n_arms(tag, argv, out, stderr):
    for line in stderr.splitlines():
        if line.startswith("# "):
            log(f"[{tag}] {line[2:]}")
    if out is None:
        raise AssertionError(f"[{tag}] analyze {' '.join(argv)} printed no JSON: "
                             f"{stderr[-3000:]}")
    for arm, rec in out["arms"].items():
        if rec["hlolint_errors"]:
            raise AssertionError(f"[{tag}] {arm}: lint errors {rec['hlolint_errors']}")
    return out["arms"]


def phase_sp_overlap():
    """Phase n4: ``analyze sp-overlap`` (see the docstring)."""
    rc, out, _, stderr, wall = _analyze(N4_ARGV)
    arms = _n_arms("n4", N4_ARGV, out, stderr)
    for arm, rec in arms.items():
        if rec["k4_events"] != rec["k4_launches"] or not rec["k4_launches"]:
            raise AssertionError(f"[n4] {arm}: {rec['k4_events']} K4 kernel events in the "
                                 f"traces, {rec['k4_launches']} launches in the traced steps")
        log(f"[n4] {arm}: trace_overlap_ratio {rec['trace_overlap_ratio']}, collective_s "
            f"{rec['collective_s']}, step_time_s {rec['step_time_s']}, K4 events "
            f"{rec['k4_events']} = launches {rec['k4_launches']} in {rec['n_steps']} traced "
            f"steps; permutes {rec['permutes']} (halo_shift_count {rec['halo_shifts']}); "
            f"crosscheck {[(f['rule'], f['severity']) for f in rec['crosscheck']]}")
    if rc != 0:
        raise AssertionError(f"[n4] sp-overlap exited {rc}")
    log(f"[n4] {' '.join(N4_ARGV)}: exit 0 in {wall:.1f} s ({out['config']['ranks']}); "
        f"overlap_improved {out.get('overlap_improved')}, step_time_speedup "
        f"{out.get('step_time_speedup')} (recorded, not gated)")


def phase_pipeline_lens():
    """Phase n5: ``analyze pipeline`` (see the docstring)."""
    rc, out, _, stderr, wall = _analyze(N5_ARGV)
    arms = _n_arms("n5", N5_ARGV, out, stderr)
    if rc != 0:
        raise AssertionError(f"[n5] pipeline exited {rc}: {json.dumps(out)[-2000:]}")
    for arm, rec in arms.items():
        log(f"[n5] {arm}: the ticks' slot bubble {rec['bubble_fraction']} (per rank "
            f"{rec['idle_slot_share_by_rank']}), analytic {rec['analytic_bubble_fraction']}; "
            f"measured device-idle share {rec['device_idle_share']} (per rank "
            f"{rec['device_idle_share_by_rank']}); "
            f"{rec['img_per_s']} img/s; stage device s {rec['stage_device_seconds']}; wires "
            f"{rec['permutes']} of budget {rec['permute_budget']}; warm-up loss "
            f"{rec['warm_loss']}; transport {rec['transport']}")
    log(f"[n5] {' '.join(N5_ARGV)}: exit 0 in {wall:.1f} s ({out['config']['ranks']}); "
        f"bubble_improved {out.get('bubble_improved')} (slots), device_idle_improved "
        f"{out.get('device_idle_improved')}, loss_equal {out.get('loss_equal')}, "
        f"img/s 1f1b/gpipe {out.get('img_per_s_ratio')} (recorded, not gated)")


def phase_serving_overlap():
    """Phase n6: ``analyze serving-sharded`` (see the docstring)."""
    rc, out, _, stderr, wall = _analyze(N6_ARGV)
    arms = _n_arms("n6", N6_ARGV, out, stderr)
    if not out["bit_identical_arms"]:
        raise AssertionError(f"[n6] the arms' logits differ by {out['arms_max_rel_diff']:.3e} "
                             "of max |logit|")
    for arm, rec in arms.items():
        if not rec["k4_events"]:
            raise AssertionError(f"[n6] {arm}: no K4 kernel in the trace of the replays")
        log(f"[n6] {arm}: trace_overlap_ratio {rec['trace_overlap_ratio']}, latency "
            f"{rec['latency_ms']} ms, {rec['throughput_rps']} req/s, {rec['n_steps']} batches "
            f"attributed; K4 kernel events in the replays' trace {rec['k4_events']} (K4 "
            f"launches in a capture {rec['k4_capture_launches']}); permutes "
            f"{rec['permutes']} of halo_shift_count {rec['halo_shifts']}")
    if rc != 0:
        raise AssertionError(f"[n6] serving-sharded exited {rc}")
    log(f"[n6] {' '.join(N6_ARGV)}: exit 0 in {wall:.1f} s ({out['config']['ranks']}); the "
        f"arms' logits bit-equal; overlap_improved {out.get('overlap_improved')} (not gated)")


def _n_run(tag, argv, timeout=900):
    """``analyze`` with ``argv``, which must exit 0: (stdout, wall s)."""
    rc, _, stdout, stderr, wall = _analyze(argv, timeout=timeout)
    if rc != 0:
        raise AssertionError(f"[{tag}] analyze {' '.join(argv)} exited {rc}: "
                             f"{stdout[-2000:]} {stderr[-2000:]}")
    return stdout, wall


def phase_json_analyzers(keep, m3_line):
    """Phase n7: the pure-JSON subcommands on what the full run wrote
    (``keep``: phase f's ``tele/`` and ``ledgers/``, phase c's
    ``c.ledger.json``; ``m3_line``: m3's last result line)."""
    tele = os.path.join(keep, "tele")
    out, wall = _n_run("n7", ["tail", tele, "--top", "3"], timeout=120)
    rows = [ln for ln in out.splitlines() if ln.strip()]
    log(f"[n7] analyze tail <phase f's telemetry> --top 3: exit 0 in {wall:.1f} s; "
        f"{len(rows)} lines, the first {rows[0] if rows else None!r}")

    out, wall = _n_run("n7", ["incident", tele, "--json"], timeout=120)
    pms = json.loads(out)
    kills = [pm for pm in pms if (pm.get("first_cause") or {}).get("event") == "chaos.injected"
             and str(pm["first_cause"].get("attrs", {}).get("op", "")).startswith("kill:r1")]
    if not kills:
        raise AssertionError(f"[n7] incident: no incident blames the kill: "
                             f"{[(pm.get('first_cause') or {}).get('event') for pm in pms]}")
    inc = kills[0]["incident"]
    log(f"[n7] analyze incident <phase f's telemetry> --json: exit 0 in {wall:.1f} s; "
        f"{len(pms)} incident(s), {inc['id']} first cause chaos.injected "
        f"{kills[0]['first_cause']['attrs']['op']}, MTTR {inc.get('mttr_s')} s, "
        f"{len(kills[0].get('timeline') or [])} timeline events")

    chrome = os.path.join(keep, "chrome.json")
    _, wall = _n_run("n7", ["trace-export", tele, "-o", chrome], timeout=120)
    with open(chrome) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    if not spans:
        raise AssertionError("[n7] trace-export wrote no span")
    log(f"[n7] analyze trace-export <phase f's telemetry>: exit 0 in {wall:.1f} s; "
        f"{len(spans)} spans across {len({e['pid'] for e in spans})} processes")

    ledgers = sorted(glob.glob(os.path.join(keep, "ledgers", "*.json")))
    manifest = os.path.join(keep, "manifest.json")
    _, wall = _n_run("n7", ["coldstart", *ledgers, "--artifact", manifest], timeout=120)
    with open(manifest) as f:
        names = {g["executable"] for g in json.load(f)["executables"]}
    want = {f"serve_predict[{b}]" for b in (1, F_MAX_BATCH)}
    if not want <= names:
        raise AssertionError(f"[n7] coldstart: the manifest lists {sorted(names)}, not "
                             f"phase f's buckets {sorted(want)}")
    log(f"[n7] analyze coldstart <{len(ledgers)} replicas' ledger dumps>: exit 0 in "
        f"{wall:.1f} s; executables {sorted(names)}")

    rounds = []
    for n in (1, 2):
        rounds.append(os.path.join(keep, f"BENCH_r0{n}.json"))
        with open(rounds[-1], "w") as f:
            json.dump({"n": n, "rc": 0, "parsed": m3_line}, f)
    out, wall = _n_run("n7", ["bench-history", *rounds], timeout=120)
    if "0 regression(s)" not in out:
        raise AssertionError(f"[n7] bench-history: {out[-1000:]}")
    log(f"[n7] analyze bench-history <m3's line as rounds 1 and 2>: exit 0 in {wall:.1f} s; "
        f"{out.strip().splitlines()[-1]}")

    limit = _card_bytes()
    out, wall = _n_run("n7", ["memory-plan", "--ledger", os.path.join(keep, "c.ledger.json"),
                              "--limit-bytes", str(limit)], timeout=120)
    log(f"[n7] analyze memory-plan --ledger <phase c's ledger> --limit-bytes {limit}: exit 0 "
        f"in {wall:.1f} s; " + "; ".join(ln.strip() for ln in out.splitlines()[1:]))


def phase_numerics():
    """Phase n8: ``analyze numerics`` live (see the docstring)."""
    with tempfile.TemporaryDirectory(prefix="mpi4dl-n8-") as tmp:
        path = os.path.join(tmp, "numerics.json")
        rc, _, stdout, stderr, wall = _analyze([*N8_ARGV, "--json", path])
        rep = None
        if os.path.exists(path):
            with open(path) as f:
                rep = json.load(f)
    if rep is None:
        raise AssertionError(f"[n8] numerics exited {rc} with no report: {stderr[-3000:]}")
    for p in rep["pairs"]:
        log(f"[n8] {p['a']} | {p['b']}: max_abs {p['max_abs']:.3e}, max_ulp {p['max_ulp']}, "
            f"atol {p['atol']:g}: {'ok' if p['ok'] else 'BREACH'}")
    sharded = rep["predictors"]["sharded"]
    log(f"[n8] analyze {' '.join(N8_ARGV)}: exit {rc} in {wall:.1f} s ({rep['config']['ranks']}, "
        f"TF32 off); checksums {sorted({v['params_checksum'] for v in rep['predictors'].values()})}"
        f"; K4 launches in the sharded predictor's capture {sharded['halo_launches']}")
    if rc != 0 or not rep["ok"] or not rep["checksums_agree"]:
        raise AssertionError(f"[n8] numerics: exit {rc}, ok {rep['ok']}, checksums agree "
                             f"{rep['checksums_agree']}")
    if not sharded["halo_launches"]:
        raise AssertionError("[n8] no K4 launch in the sharded predictor's capture")


def _n9_plan(argv):
    """``analyze memory-plan`` in plan mode: (exit code, plan)."""
    with tempfile.TemporaryDirectory(prefix="mpi4dl-n9-") as tmp:
        path = os.path.join(tmp, "plan.json")
        rc, _, stdout, stderr, wall = _analyze(["memory-plan", *argv, "--json", path])
        if not os.path.exists(path):
            raise AssertionError(f"[n9] memory-plan {' '.join(argv)} exited {rc} with no plan: "
                                 f"{stdout[-1500:]} {stderr[-1500:]}")
        with open(path) as f:
            plan = json.load(f)
    log(f"[n9] analyze memory-plan {' '.join(argv)}: exit {rc} in {wall:.1f} s; "
        + "; ".join(f"{e['key']} peak {e['peak_bytes']} B fits {e['fits']}"
                    for e in plan["entries"]))
    return rc, plan


def phase_memory_plan():
    """Phase n9: ``analyze memory-plan`` in plan mode (see the docstring)."""
    from mpi4dl_tpu_torch.peak_pixels import child_result

    peaks = {}
    for name, flags, ref_argv in N9_TRAIN:
        rc, plan = _n9_plan(["--program", "train", *flags])
        predicted = plan["predicted"]["peak_bytes"]
        ref, code = child_result("mpi4dl_tpu_torch.peak_pixels", ref_argv, 900)
        if rc != 0 or ref is None or not ref["ok"] or ref["remat"] is not False:
            raise AssertionError(f"[n9] {name}: plan exit {rc}, the reference {ref} ({code})")
        measured = ref["peak_gib"] * 2**30
        err = abs(predicted - measured) / measured
        log(f"[n9] {name}: predicted peak {predicted / 2**30:.3f} GiB, the bench's "
            f"train_throughput in a process of its own {measured / 2**30:.3f} GiB "
            f"({err:.2%}, tolerance {N9_PEAK_RTOL:.0%})")
        if err > N9_PEAK_RTOL:
            raise AssertionError(f"[n9] {name}: predicted {predicted} B, measured {measured} B")
        peaks[name] = predicted
    total = _card_bytes()
    limit = (peaks["resnet_2048"] + total) // 2
    rc, plan = _n9_plan([*N9_BISECT_PX, "--limit-bytes", str(limit)])
    if rc != 0 or plan["bisect"]["max_feasible"] != 2048:
        raise AssertionError(f"[n9] --bisect px: exit {rc}, {plan['bisect']}")
    serve = {}
    for b in (2, 4):
        rc, plan = _n9_plan([*N9_SERVE, "--bucket", str(b), "--limit-bytes", str(total)])
        if rc != 0:
            raise AssertionError(f"[n9] serve bucket {b}: exit {rc}")
        serve[b] = plan["predicted"]["peak_bytes"]
    if not serve[2] < serve[4]:
        raise AssertionError(f"[n9] serve capture peaks {serve}: bucket 4 not above bucket 2")
    rc, plan = _n9_plan([*N9_SERVE, "--bisect", "bucket", "--max-bucket", "4",
                         "--limit-bytes", str((serve[2] + serve[4]) // 2)])
    if rc != 0 or plan["bisect"]["max_feasible"] != 2:
        raise AssertionError(f"[n9] --bisect bucket: exit {rc}, {plan['bisect']}")
    log(f"[n9] --bisect px answered 2048 under {limit / 2**30:.2f} GiB; --bisect bucket "
        f"answered 2 under {(serve[2] + serve[4]) / 2 / 2**31:.3f} GiB (capture peaks: bucket 2 "
        f"{serve[2] / 2**30:.3f}, bucket 4 {serve[4] / 2**30:.3f} GiB)")


def _card_bytes() -> int:
    import torch

    return int(torch.cuda.get_device_properties(0).total_memory)


def phase_costmodel(lint_reports):
    """Phase n10: ``analyze costmodel`` live (see the docstring)."""
    with tempfile.TemporaryDirectory(prefix="mpi4dl-n10-") as tmp:
        path = os.path.join(tmp, "costmodel.json")
        rc, _, stdout, stderr, wall = _analyze([*N10_ARGV, "--json", path])
        if rc != 0 or not os.path.exists(path):
            raise AssertionError(f"[n10] costmodel exited {rc}: {stdout[-2000:]} "
                                 f"{stderr[-2000:]}")
        with open(path) as f:
            out = json.load(f)
    pred = out["prediction"]
    want = lint_reports["resnet 2x2 spatial"]["overlap"]["n_collectives"]
    errors = [f for f in out["crosscheck"] if f["severity"] == "error"]
    measured = out["measured"]["collective_s"]
    log(f"[n10] analyze {' '.join(N10_ARGV)}: exit 0 in {wall:.1f} s; {pred['n_collectives']} "
        f"collectives priced (n3's lint of the step: {want}; {pred['per_op']}); predicted "
        f"comms {pred['comms_s'] * 1e3:.4f} ms a step against the trace's measured collective "
        f"{'%.4f ms' % (measured * 1e3) if measured is not None else 'n/a'}; overlap claim "
        f"{pred['overlap_claim']}; crosscheck {[(f['rule'], f['severity']) for f in out['crosscheck']]}")
    if pred["n_collectives"] != want or errors:
        raise AssertionError(f"[n10] {pred['n_collectives']} collectives against the lint's "
                             f"{want}; crosscheck errors {errors}")


def phase_analysis():
    """Phases n3-n6 and n8-n10 (``--analysis-only``)."""
    t0 = time.time()
    reports = phase_lint_cli()
    log(f"[n3] phase n3 in {time.time() - t0:.1f} s")
    for tag, run in (("n4", phase_sp_overlap), ("n5", phase_pipeline_lens),
                     ("n6", phase_serving_overlap), ("n8", phase_numerics),
                     ("n9", phase_memory_plan), ("n10", lambda: phase_costmodel(reports))):
        t0 = time.time()
        run()
        log(f"[{tag}] phase {tag} in {time.time() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra step of each main path (torch.profiler; the "
                         "spatial path's on rank 0)")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--spatial-only", action="store_true",
                      help="run only the build and the spatial phase s (for a 4-card host)")
    only.add_argument("--pipeline-only", action="store_true",
                      help="run only the build and the pipeline phase p, with phase g's 2-rank "
                           "part (one rank per card on a host with a card for each)")
    only.add_argument("--gems-only", action="store_true",
                      help="run only the build and phases p and q (the spatial front ahead of "
                           "the pipeline) with phase g, GEMS-MASTER, in their worlds (q's "
                           "SP+GEMS twins are held to p's GEMS steps; one rank per card on a "
                           "host with 4 cards)")
    only.add_argument("--tools-only", action="store_true",
                      help="run only the build and the run tooling: phases t, e and s9 (the "
                           "halo twins in a 4-rank world of their own)")
    only.add_argument("--serve-only", action="store_true",
                      help="run only the build and the serving phase r (r3 in a 4-rank world "
                           "of its own)")
    only.add_argument("--fleet-only", action="store_true",
                      help="run only the build and the fleet phase f, f3's drills included")
    only.add_argument("--analysis-only", action="store_true",
                      help="run only the build and the analyzers' phases n3-n6 (the lint CLI "
                           "and the three A/B harnesses)")
    args = ap.parse_args(argv)
    picked = [f for f in ("spatial", "pipeline", "gems", "tools", "serve", "fleet", "analysis")
              if getattr(args, f"{f}_only")]
    if "gems" in picked:  # phase g runs in phase p's and q's worlds
        picked += ["pipeline", "sp_lp"]
    only = bool(picked)

    def runs(phase):
        return not only or phase in picked

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    import mpi4dl_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from mpi4dl_tpu_torch.train import PEAK_PIXEL_POLICIES, REMAT_POLICIES

    # f32 checks compare full-f32 products; the bf16 main paths are unaffected.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    phase_build()
    calls = {}  # path -> kernel -> Counter of call shape -> calls in one step
    launches, rows, first_loss, k1_copies, ips = {}, [], {}, {}, {}
    cards = dict.fromkeys(("amoebanet", "resnet"), 1)
    n7_dir = tempfile.TemporaryDirectory(prefix="mpi4dl-n7-")
    if not only:
        from mpi4dl_tpu_torch.telemetry.memory import FootprintLedger

        for name, build, size in small_models():
            phase_small_reference(name, build, size)
        c_ledger = FootprintLedger()
        for path, desc, build in main_models():
            calls[path] = _new_calls()
            launches[path], first_loss[path], k1_copies[path], ips[path] = phase_main(
                path, desc, build, calls[path], args.profile, ledger=c_ledger)
        c_ledger.dump(os.path.join(n7_dir.name, "c.ledger.json"))
    if runs("serve"):
        t0 = time.time()
        r1_exact = phase_serve_small()
        ckpt = phase_serve_main()
        log(f"[r] phases r1 and r2 in {time.time() - t0:.1f} s; r1's replays "
            + ("bit-equal to eager" if r1_exact else
               f"NOT all bit-equal to eager (held to {R_EAGER_TOL:g} of max |logit|)"))
        t0 = time.time()
        try:
            phase_serve_cli(ckpt)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        t1 = time.time()
        mesh = start_serve_mesh_cli()
        try:
            phase_serve_tiled()
        except BaseException:
            stop_session(mesh)
            raise
        t2 = time.time()
        finish_serve_mesh_cli(mesh)
        t3 = time.time()
        phase_serve_bench()
        log(f"[r] phases r4-r7 in {time.time() - t0:.1f} s (r4 {t1 - t0:.1f}, r5 {t2 - t1:.1f} "
            f"with r6 beside it, r6's wait after r5 {t3 - t2:.1f}, r7 {time.time() - t3:.1f})")
    tools_s = 0.0
    if runs("tools"):
        t0 = time.time()
        phase_profile_step(launches)
        tools_s += time.time() - t0
        log(f"[t] phase t in {time.time() - t0:.1f} s")
    if only and runs("tools"):
        tools_s += phase_supervised()
    if not only:
        phase_bench_points(calls, launches)
        m3 = start_bench_cli()  # phase m3's subprocess runs beside m2 and w1
        try:
            bases = phase_remat([p for p in REMAT_POLICIES
                                 if p is not False and p not in PEAK_PIXEL_POLICIES])
            phase_walk_policies(bases["resnet"])
        except BaseException:
            stop_session(m3)
            raise
        m3_line = finish_bench_cli(m3)
        phase_walk_steps(calls, launches)
        fleet = start_fleet()  # phase f's replicas start beside v1
        try:
            phase_convergence(calls, launches)
        except BaseException:
            stop_fleet(fleet)
            raise
        fleet_s = finish_fleet(fleet, keep=n7_dir.name)
        log(f"[f] phase f in {fleet_s:.1f} s after phase v1 (its replicas started beside v1)")
        t0 = time.time()
        phase_json_analyzers(n7_dir.name, m3_line)
        log(f"[n7] phase n7 in {time.time() - t0:.1f} s")
        phase_checkpoint(launches)
    if only and runs("fleet"):
        fleet_s = finish_fleet(start_fleet(), drills=True)
        log(f"[f] phase f (f1-f3) in {fleet_s:.1f} s")
    if only and runs("analysis"):
        t0 = time.time()
        phase_analysis()
        log(f"[n] phases n3-n6 and n8-n10 in {time.time() - t0:.1f} s")
    k4_timing = None
    if runs("spatial"):
        if "amoebanet" in first_loss:  # the single-device reference at the SP depth
            from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
            from mpi4dl_tpu_torch.weights import meta_built

            first_loss = dict(first_loss, amoebanet=(None, f32_first_loss(meta_built(
                lambda dtype: amoebanetd(10, SP_LAYERS, FILTERS, dtype=dtype), torch.float32),
                DEVICE)))
        for path in SP_PATHS:
            calls[path] = _new_calls()
        sp_launches, sp_ips, sp_cards, k4_timing = phase_spatial(calls, args.profile, first_loss)
        tools_s += k4_timing["halo_twins_s"]
        launches.update(sp_launches)
        ips.update(sp_ips)
        cards.update(dict.fromkeys(SP_PATHS, sp_cards))
    elif runs("tools"):
        t0 = time.time()
        phase_halo_world()
        log(f"[s9] phase s9 in {time.time() - t0:.1f} s")
        tools_s += time.time() - t0
    elif runs("serve"):
        t0 = time.time()
        phase_serve_world()
        log(f"[r3] phase r3 in {time.time() - t0:.1f} s")
    # Phase g runs in phase p's and q's worlds; q's SP+GEMS twins are held
    # to p's g2 launches.
    if runs("pipeline"):
        t0 = time.time()
        g_want = phase_pipeline(calls, launches, ips, cards)
        log(f"[p] phase p in {time.time() - t0:.1f} s (with phase g's 2-rank part)")
    if runs("sp_lp"):
        t0 = time.time()
        phase_sp_lp(calls, launches, ips, cards, g_want)
        log(f"[q] phase q in {time.time() - t0:.1f} s (with phase g's 4-rank part)")
    if not only:
        shapes = {name: sorted(set().union(*(c[name] for c in calls.values())))
                  for name in KERNELS}
        for name, timed in (("pool_bwd", K1_TIMED), ("wgrad", K2_TIMED),
                            ("dot1x1_bwd", K3_TIMED)):
            if timed not in shapes[name]:
                raise AssertionError(f"the timed {name} shape {timed} is not a main-path shape")
        errs = {
            "pool_bwd": phase_k1(gen, shapes["pool_bwd"]),
            "wgrad": phase_k2(gen, shapes["wgrad"]),
            "dot1x1_bwd": phase_k3(gen, shapes["dot1x1_bwd"]),
        }
        rows = phase_kernel_times(gen, launches, errs)
        per_shape = phase_shape_times(gen, calls)
        per_shape["pool_bwd"].update(phase_k1_copies(gen, k1_copies))
        for row in rows:
            row.update(per_shape.get(row["name"], {}))
        phase_walk_large(gen, calls)
    if k4_timing is not None:
        rows.append(halo_row(k4_timing, launches))
    smi = card()
    if runs("tools"):
        log(f"[h] the run tooling added {tools_s:.1f} s (phases t and s9"
            + (", and e" if only else "; e runs with --tools-only") + ")")
    log(f"[h] {time.time() - t_start:.1f} s in all; seconds by phase tag: {phase_seconds()}")
    n7_dir.cleanup()
    log(smi)
    log(phase_mfu(ips, cards, smi))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def phase_mfu(ips, cards, smi):
    """Phase h's MFU line: per path, the training FLOPs an image of its plain
    model (``mpi4dl_tpu_torch.flops``, counted on the meta device) times its
    img/s over the bf16 peak of the cards it ran on."""
    import torch

    from mpi4dl_tpu_torch import flops
    from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2

    with torch.device("meta"):
        models = {("amoebanet", n): amoebanetd(10, n, FILTERS)
                  for n in {LAYERS, *PATH_LAYERS.values()}}
        models.update({("resnet", n): get_resnet_v2(n, 10, pool_kernel=SIZE // 4)
                       for n in {RESNET_DEPTH, *PATH_DEPTH.values()}})
    per_image = {key: flops.train_flops_per_image(m, SIZE) for key, m in models.items()}
    peak = flops.peak_flops()
    parts = []
    for path, v in ips.items():
        name = path.split("_")[0]
        fpi = per_image[name, PATH_LAYERS.get(path, LAYERS) if name == "amoebanet"
                        else PATH_DEPTH.get(path, RESNET_DEPTH)]
        mfu = flops.mfu(v, fpi, cards[path])
        parts.append(f"{path} {'%.2f%%' % (100 * mfu) if mfu is not None else 'n/a'} "
                     f"({fpi / 1e12:.3f} TFLOP an image, {v:.3f} img/s, {cards[path]} card(s))")
    return (f"[h] MFU on {smi} (training FLOPs = 3x the forward's conv and dense FLOPs, "
            f"bf16 peak {'%g TFLOP/s a card' % (peak / 1e12) if peak else 'unknown'}): "
            + "; ".join(parts))


if __name__ == "__main__":
    sys.exit(main())
