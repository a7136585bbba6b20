#!/usr/bin/env python3
"""Drive horovod_tpu_torch on one NVIDIA GPU and hold its kernels to
their plain PyTorch versions.

    python3 chip_smoke.py             # from the root of a checkout
    python3 chip_smoke.py --profile   # also print profile tables

Phases (a failure in any one exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the four CUDA kernel libraries from
   ``horovod_tpu_torch/ops/csrc`` (``scale_cast.cu``,
   ``flash_attention.cu`` with ``flash_sm90.cu``, ``quantize.cu``,
   ``conv_bn.cu`` with ``conv_bn_sm90.cu``) with nvcc for sm_90a, all at
   once; report ptxas's registers, spills and stack per kernel of
   ``conv_bn_sm90.cu`` and its kernels' dynamic shared memory;
3. ``scale_cast_batched`` against its plain version, bit for bit:
   single tensors of 1, 4095, 4097 and 25.6 M elements in five dtype
   pairs at three factors, a pack/unpack round trip over the 161
   ResNet-50 gradient shapes, and a pack of a ragged list longer than
   one launch holds (unaligned offsets, empty members); then its time
   on the 161 tensors, its bound, the plain version's time, one
   ``torch.mul`` on one flat tensor of the same size as the library
   yardstick, and the kernel on that flat tensor;
4. the main path: ``horovod_tpu_torch.run(train, np=2)`` on the card
   (stacked mode), each rank training full-width ResNet-50 (bf16
   compute, random weights from one numpy seed) through
   ``broadcast_parameters`` and ``DistributedOptimizer(SGD)`` for 6
   steps on its own batch of 64 x 224 x 224 x 3, rolled to new images
   at every step (``step_batch``).  Checks: finite
   losses, the first step's averaged gradients equal the plain average
   of the two ranks' local gradients bit for bit, both ranks' parameters
   bit-identical after the steps, the pack and unpack launch counts
   equal to buckets x ranks at every step; the device's busy share of
   one profiled steady step of rank 0 (left out of the steady mean).
   Then a plain single-process torch step on the same 128 images as the
   overhead yardstick;
5. ``MeshExecutor`` in process-group mode over NCCL at world size 1:
   the ResNet-50 gradient list as one fused bucket with pre/post scale,
   against the plain version; then the same bucket through
   ``allreduce_quantized`` on the int8 and the int4 wire (encode on the
   card, codes and bf16 scales gathered over NCCL, decode), against the
   plain codec bit for bit;
6. the three flash-attention kernels (forward, dq, dk/dv) against their
   plain versions: f32 and bf16, head dims 64 and 128, S 128, 1000 and
   2048, BH 3 and 40, windows None, 1, 100 and S-1, each output held
   elementwise and in relative L2 to the bounds of
   ``flash_attention.error_ratio``; then each kernel's time at the LM's
   shape (B 5, S 2048, H 8, D 128, bf16, causal), its achieved TFLOP/s
   and share of its bound, its plain version's time and, as the library
   yardstick, ``scaled_dot_product_attention`` forward (for the forward
   kernel) and PyTorch's flash backward, one call for dq, dk and dv (for
   both backward kernels), with the CUDA kernels each yardstick ran (the
   SDPA backend it took);
7. the LM path: ``make_lm_train_step(attention_impl="flash")`` trains
   the full-width 436M transformer LM (24 x 1024, 8 heads x 128, d_ff
   4096, vocab 32000, random weights from one numpy seed) on 5 x 2048
   tokens for 6 steps.  Checks: finite losses, step 1's loss within 0.1
   of ln 32000 + 1024 * 0.02**2 / 2 (the expected cross entropy of the
   init's logits), 24 launches of each flash kernel per step, and one
   step of the dense model (``attention_impl="ring"``) on the same
   weights and tokens giving step 1's loss within 2e-3 and every
   gradient within a relative L2 of max(2e-2, twice the dense step's own
   distance from the f32 gradient of the same step, which an f32 dense
   model in plain torch computes), with the flash step
   no further from the f32 gradients, over all parameters, than 1.25 x
   the dense step (bf16 rounding alone puts either bf16 step about 3%
   from f32).  Then the same LM at 2 layers trains at np=2 through
   ``DistributedOptimizer(AdamW)`` (2 x 2048 tokens per rank, 3 steps):
   step 1's averaged gradients equal the plain average bit for bit and
   both ranks' parameters are bit-identical at the end;
8. the wire codec kernels B2-B5 (``quantize.cu``: int8 and int4 encode
   and decode) against their plain versions, bit for bit: 1, 255, 256,
   257, 70,000 and 25,557,032 elements (the ResNet-50 gradient) in f32,
   bf16 and f16, decoded to f32 and bf16, plus zero, subnormal-scale,
   tie and clip blocks and blocks holding NaN or +-inf (all-NaN after
   decode on both sides); then each kernel's time on the 25,557,032 f32
   elements, its bound, its plain version's time and, for the int8
   decode, one ``torch.mul`` of the codes by their scales as the library
   yardstick;
9. the main path over the quantized wire: phase 4's run (full-width
   ResNet-50, 2 rank threads, 6 steps) through
   ``DistributedOptimizer(compression=Compression.int8)`` and then
   ``.int4``.  Checks: finite losses; both ranks' parameters
   bit-identical at the end; at step 1 every bucket's encoded rows and
   ``allreduce_quantized`` result, and every error-feedback residual,
   equal the plain codec applied to the recorded fusion rows and local
   gradients, bit for bit; the encode and decode launches of every step
   equal buckets x 2 ranks + 161 parameters x 2 ranks (error feedback);
   logical / actual wire bytes above 3.9 (int8) and 7.5 (int4).  It
   prints step 1's averaged gradient's relative L2 distance from the
   exact f32 average (gross sanity: below 0.05 for int8, 0.5 for int4)
   and the steady step time beside phase 4's;
10. the fused 1x1-conv + BN kernels B9 (forward) and B10 (backward)
    against their plain versions, on both routes (``conv_bn.route``):
    the 13 distinct (M, K, N, fold) of a full-width ResNet-50 rank step
    (from (200704, 64, 64) to (3136, 512, 2048), M = 3136 with a 64-row
    tail) in bf16 (``conv_bn_sm90.cu``) and f32 (``conv_bn.cu``'s WMMA
    kernels), small and odd shapes (M 16, 48, 96, 1040; K and N off
    multiples of 16) with and without the fold, and three more bf16
    shapes of the sm90 route (``CONV_BN_SM90_ODD``), each output within
    the bounds of ``conv_bn.fwd_error`` and ``conv_bn.bwd_error`` (the
    route's summation depths), each call on the route the rule names,
    each sm90 plan equal to the library's, and four reruns
    bit-identical; then each step shape's time, bound, plain version's
    time, dw partial bytes and, labelled as the matmul part only,
    ``torch.matmul`` on the same bf16 products, summed over the 33
    launches of one rank step;
11. the fused main path: phase 4's run with ``ResNet50(fused=True)`` on
    the same weights (``fused_from_unfused``).  Checks: finite losses,
    step 1's averaged gradients equal the plain average bit for bit,
    both ranks' parameters bit-identical, per step 66 launches of B9 and
    of B10 (33 per rank), every one on the sm90 route, and 6 calls on the
    plain path (the 3 strided projections per rank); then one fused, one
    unfused and one f32 unfused step on rank 0's images with the BN
    scales drawn away from zero: the loss and every gradient within the
    bounds of ``FUSED_REL_L2``, ``FUSED_GLOBAL`` and ``FUSED_LOSS``, and
    the steady step time and the device's busy share (one profiled step
    of rank 0, left out of the mean) beside phase 4's;
12. the compiled step (``make_compiled_train_step``, one CUDA graph a
    step), cuDNN on deterministic algorithms.  First the grouped reducer
    at world size 2: the 161 ResNet-50 gradients (largest first) through
    ``CompiledGroupedAllreduce`` grouped (B1 packs and unpacks) and
    bucketized (4 MB buckets pushed in reverse order), full width, bf16,
    int8 and int4 with error feedback, 2 calls each, bit for bit; then
    (a) bench.py's configuration, ``run(train, np=1)`` on 128 images
    staged by ``place_batch``, (b) phase 4's, 2 rank threads on 64
    images each, a new batch every step, and (c) (b) with
    ``ResNet50(fused=True)``, SGD momentum 0.9 at lr 0.1, 6 steps each.
    Checks: finite losses; one program miss, one capture and 5 replays
    a part; the 6 losses (read after the 6 steps), final parameters and
    BN statistics equal bit for bit the same program run uncaptured;
    (b)'s and (c)'s parameters within ``COMPILED_REL_L2`` of phases 4's
    and 11's; in (c) the capture records phase 11's per-step B9/B10
    launches, all on the sm90 route, and a profiled replay runs their
    kernels.  It prints each part's steady step time, img/s, the ratios
    to the plain step and to phase 4 (11), the busy share of one
    profiled replay, warm-up plus capture seconds and the program
    cache's hits and misses, and the reference's 103.55 img/s per GPU;
13. the weight-update sharded main path: phase 4's run (full-width
    ResNet-50, 2 rank threads x 64 images, SGD momentum 0.9, phase 4's
    weights and batches, 6 steps) through ``DistributedOptimizer``, a
    dense leg and then ``sharded=True`` on the f32, bf16, int8 and int4
    wires (gradients out by a grouped reducescatter, each rank updating
    its half of the parameters and momentum, the parameters back by a
    grouped allgather), cuDNN on deterministic algorithms.  Checks: on
    the f32 wire each rank's step-1 gradient shard equals the matching
    slice of the dense leg's averaged gradient bit for bit and the
    parameters after 6 steps are within ``SHARDED_PARAM_BOUND`` of the
    dense leg's (and says whether bit for bit); on every wire finite
    losses and both ranks' parameters bit-identical; on int8/int4 step
    1's shards within ``WIRE_REL_L2`` of the exact f32 average and the
    logical / actual bytes of the reducescatter plus the parameter
    allgather above ``WIRE_RATIO``; the momentum per rank half the dense
    leg's (to one element per bucket); one sharded update per rank and
    step; B1 launched on every leg, B2/B3 on int8, B4/B5 on int4.  It
    prints each leg's steady step time and img/s beside the dense leg's,
    the state bytes, the peak device memory and the launches;
14. the weight-update sharded compiled step
    (``make_compiled_train_step(sharded=True, wire_dtype=...)``, one CUDA
    graph a step), cuDNN on deterministic algorithms, 6 steps a leg
    (``SHARDED_LEGS``): (a) phase 12 (b)'s ResNet-50 configuration on the
    f32, bf16, int8 and int4 wires; (b) the f32 and int8 legs with 4 MiB
    segments (``HOROVOD_OVERLAP_BUCKET_BYTES``); (c)
    ``ResNet50(fused=True)`` on the f32 wire; (d) the full-width 436M LM
    (bf16, flash attention, AdamW 1e-3, 2 rank threads x 5 x 2048
    tokens) through a dense compiled leg, then sharded on the f32 and
    int8 wires.  Checks: finite losses; one program miss, one capture and
    5 replays a leg; the losses, parameters, every rank's optimizer
    shards and the residuals bit for bit the same program run
    uncaptured; (a) f32's parameters within ``SHARDED_PARAM_BOUND`` of
    phase 12 (b)'s and phase 13's f32 leg's, (d) f32's of the dense LM
    leg's (and says whether bit for bit); (b) bit for bit (a)'s matching
    leg; on int8/int4 step 1's reduced shards within ``WIRE_REL_L2`` of
    the exact f32 average and step 2's residual non-zero; each rank's
    optimizer state the dense state / 2 to within the padding; in (c)
    and (d) the capture records the step's B9/B10 (phase 11's counts, all
    sm90) or 24 x 2 launches of each of B6-B8, the replays launch nothing
    through the wrappers, and a profiled replay runs their kernels.  It
    prints each leg's steady step time, img/s or tok/s, the ratio to the
    matching dense step, the busy share of one profiled replay, warm-up
    plus capture seconds, the state bytes per rank and the peak device
    memory (per step, and what the leg found held);
15. the rest of the collective contract and the MoE LM: (a) an 8-expert
    top-2 MoE at the 436M's width (``MOE``: capacity factor 1.25,
    expert hidden 2048, 1.34 B parameters, bf16, AdamW 1e-3) trains 6
    steps on phase 7's tokens through ``make_lm_train_step(
    attention_impl="flash")``.  Checks: finite losses; 24 launches of
    each of B6-B8 a step; step 1's loss within 2e-3 of the same weights'
    dense-attention loss; phase 7's flash-against-dense rule on the same
    model ``MOE_GATE_LAYERS`` deep; B6-B8 against their plain versions on
    layer 0's attention inputs.  It prints the step time, tok/s, model
    TFLOP/s at the dense twin's FLOPs, the busy share of one profiled
    step, dropped choices per step, the peak memory, the ratio to phase
    7's step and the loss gap to phase 7's model.  (b) At ``A2A_NP`` rank
    threads each rank routes its own 5 x 2048 tokens through layer 0's
    router and ``moe_dispatch``; the (8, 3200, 1024) slots, in f32 by
    destination, cross ``hvd.alltoall`` on every wire of ``A2A_WIRES``
    (int8/int4 with error feedback over two calls and stateless) and
    ``CompiledAlltoall`` on int8/int4.  Checks: the f32 wire is the
    plain permutation bit for bit, the bf16 wire its bf16 rounding; on
    int8/int4 each received slot is the plain codec's decode of what its
    sender sent and every residual ``padded - decode(encode(padded))``,
    bit for bit; the wire ratios above ``WIRE_RATIO``; B2-B5 launched.
    Then one MoE FFN at ep = 2 through ``HorovodAlltoall`` forward and
    backward against ``capacity_moe_apply`` with all 8 experts on the
    same tokens (``EP_REL_L2``).  (c) Phase 4's run where rank 1 joins
    after step 3: rank 0's step-4 gradients the join rule's average bit
    for bit, join's value, barriers; an allreduce on
    ``add_process_set([0, 2])`` among 4 rank threads and its removal;
16. the multi-process path, one rank per process: two jobs of the port's
    ``launch_procs`` (``chip_smoke.py --worker16``, processes that report
    through files and never print the last line) on phase 4's weights,
    batches and ``step_batch`` sequence, 6 steps, each within
    ``PHASE16_TIMEOUT``.  (a) np=1 over NCCL, cuDNN deterministic: the
    gradients averaged by ``grouped_allreduce_`` (B1 at world size 1),
    the parameters bit for bit the same steps of plain torch SGD in this
    process.  In one np=2 job on ``cuda:0`` with
    ``HOROVOD_GPU_OPERATIONS=gloo``: (b) phase 4's run through
    ``DistributedOptimizer``, the two processes' parameters bit for bit
    each other and within ``COMPILED_REL_L2`` of phase 4's; (c) the same
    on ``Compression.int8``, replicas bit for bit, step 1's averaged
    gradient within ``WIRE_REL_L2["int8"]`` of the exact average; (d)
    the collective matrix on CUDA tensors (allreduce Sum, Average, Min,
    Max with pre/post scale, int32, uneven allgather, broadcast from rank
    1, uneven alltoall, reducescatter, grouped allreduce, barrier, a
    process set, join with rank 0 early), each exact against its host
    formula, and which of gloo's collectives take CUDA tensors, against
    ``dist_ops.GLOO_CUDA_COLLECTIVES``.  Per leg it prints the steady
    median step time and img/s, rank 0's busy share of one profiled
    step, the host ms inside the collective per step, the seconds to the
    first step, and each process's B1/B2/B3 launches;
17. the compiled path across processes, as more legs of phase 16's two
    jobs (``PHASE16_JOBS``; the parent frees what it holds on the card
    first).  In the np=1 job over NCCL, cuDNN deterministic: (e)
    bench.py's configuration (128 images through ``place_batch``)
    through ``make_compiled_train_step``, one CUDA graph a step with
    the NCCL allreduces inside it: 1 capture and 5 replays, the
    collectives issued at warm-up and recorded at capture and none by a
    replay, bit for bit the same program uncaptured; (f) the 436M LM
    (phase 7's weights and tokens, AdamW 1e-3) in one graph with NCCL
    and B6-B8, its 6 losses within ``P17_LM_LOSS`` of phase 7's; (g)
    ``CompiledGroupedAllreduce(force_program=True)`` over the ResNet-50
    gradients bit for bit the engine's ``grouped_allreduce``, B1
    launched.  In the np=2 job over gloo on CUDA tensors (uncaptured by
    the capture rule), cuDNN deterministic in (h)-(i): (h) phase 12
    (b)'s configuration through the dense compiled step, replicas bit
    for bit, and bit for bit (or within ``COMPILED_REL_L2`` of) phase 12
    (b)'s parameters; (i) the sharded step on the f32 and int8 wires,
    replicas bit for bit, f32 within ``SHARDED_PARAM_BOUND`` of (h), int8
    bit for bit phase 14 (a)'s, the optimizer state per process phase
    14's per rank; (j) ``CompiledAlltoall`` at ep = 2 on phase 15 (b)'s
    slots (f32, int8, int4 with error feedback) equal to phase 15 (b)'s
    exchanges by digest, B2-B5 launched, and
    ``CompiledGroupedAllreduce.stream`` over the ResNet-50 gradients in
    backward order bit for bit the engine's sums, B1 launched; (k) a
    mismatched ``compiled_allreduce`` signature raising ``ValueError``
    on both processes within ``P17_SIG_TIMEOUT``.  Per leg it prints the
    steady step time, img/s or tok/s, busy share, warm-up plus capture
    seconds, host ms in the compiled group's collectives and each
    process's peak device memory;
18. the hybrid layout and the negotiation bypass, four jobs of the
    port's ``launch_procs`` (``PHASE18_JOBS``, ``chip_smoke.py
    --worker18``) on phase 4's weights and batches, 6 steps.  First a
    4-rank-thread stacked run here, the reference.  (a) np=4 as 2
    processes x 2 rank threads over gloo on cuda:0, full-width ResNet-50
    (bf16, SGD momentum 0.9, 32 images a rank: bench.py's 128) through
    ``DistributedOptimizer(groups=1)`` in two jobs, the bypass off, then
    on at K = ``P18_K``: the runs' parameters bit for bit on every rank,
    within ``COMPILED_REL_L2`` of the stacked run, bypass hits and fewer
    coordinator requests with it on, B1 launched in every process.  (b)
    phase 16 (d)'s matrix at 2 x 2 and at np=3 with
    ``ranks_per_proc="host"`` (``-H localhost:2,127.0.0.1:1``), exact,
    with an int8-wire allreduce (B2/B3).  (c) ``--ranks-per-worker 2`` at
    np=2 (one process, NCCL over a group of one, two stacked rows): phase
    4's run bit for bit phase 4's parameters.  (d) phase 12 (b)'s compiled
    step at 2 x 2, uncaptured over gloo, within ``COMPILED_REL_L2`` of the
    stacked run.  (e) runs in phase 16: its np=2 job (the bypass on by
    default) and one more job of leg (b) with the bypass off, each
    process's coordinator requests counted per step, and the seconds
    the un-armed bypass tracker took in the job with it on.  Per leg it
    prints
    the step times, img/s, busy share, coordinator requests a step,
    bypass hits and fallbacks, and each process's peak memory and B1
    launches;
19. workers on a remote host: two jobs of the port's ``launch_procs`` with
    a ``-H`` that names ``192.0.2.1`` (``P19_REMOTE``, an address that is
    not this machine's), whose workers the launcher spawns through
    ``ssh`` with the env handoff on stdin.  The remote end is a stub
    ``ssh`` (``STUB_SSH``) first on the launcher's PATH for the two jobs
    only: it records its argv and runs the remote command here in an
    emptied environment, so the numbers are this card's and loopback's,
    not a network's.  (a) Phase 16 (b)'s job (``--worker16 b``: np=2 over
    gloo on cuda:0, phase 4's weights and batches, full-width ResNet-50
    through ``DistributedOptimizer``, 6 steps) with ``-H
    localhost:1,192.0.2.1:1``, rank 1 through ssh: exit codes [0, 0],
    one ssh call for the remote host with no secret in its argv, rank
    1's rendezvous address the launcher's ``local_ip()``, its forwarded
    keys present and a launcher-only key absent, the replicas bit for
    bit and within ``COMPILED_REL_L2`` of phase 4's, B1 launched in both
    processes.  (b) ``selfcheck.run_engine_selfcheck`` at np=4 on cuda:0
    over gloo with ``-H localhost:2,192.0.2.1:2``, two workers through
    ssh: every assert of its worker, the slot table's local and cross
    ranks and sizes (2 and 2) among them, within ``P19_TIMEOUT``.  It
    prints (a)'s steady median step time, img/s, busy share, seconds to
    the first step and B1 launches per process, and both jobs' walls;
20. elastic training: two jobs of the port's ``horovodrun`` in elastic
    mode (``--min-np 1 --max-np 2 --host-discovery-script``, its CLI run
    with the driver's log on stderr) whose workers (``chip_smoke.py
    --worker20``, one a slot, both on cuda:0 over gloo) train phase 4's
    full-width bf16 ResNet-50 (weights and batches, 64 images a rank)
    through ``DistributedOptimizer(SGD, momentum 0.9)`` inside
    ``hvd_torch.elastic.run`` with a ``TorchState`` committed after
    every step, 6 steps.  (a) ``-np 2``, discovery ``localhost:1`` and
    ``127.0.0.1:1``: the 127.0.0.1 worker exits 17 before step 3's
    allreduce in round 1; the job exits 0 after exactly one more round,
    of size 1, the host blacklisted, the survivor running steps 3-5 at
    size 1 from the commit after step 2.  (b) ``-np 1``, discovery adding
    ``127.0.0.1:1`` once step 2 is committed: the first worker takes
    ``HostsUpdatedInterrupt`` at that commit and re-initializes in place
    (one start, one pid), the newcomer's sync leaves the replicas bit
    for bit the same before step 3 and at the end, steps 3-5 run at size
    2.  In both, what the steps changed (parameters and momentum) is
    within ``P20_REL_L2`` of an in-process replay at the same sizes.  It
    prints each round's median step ms, the commit's ms, the seconds
    from the exit or the discovery change to the next round's first
    step, the rounds and resets, B1 launches per process and each job's
    wall;
21. the control plane's faults, driven by seeded fault plans.  (a) Two
    jobs of the port's ``launch_procs`` (``chip_smoke.py --worker21``,
    np=2 processes on cuda:0 over gloo, ``HOROVOD_CONTROL_PLANE_TIER=
    host``: process 0 hosts the host's aggregator and both route their
    control traffic through it), phase 4's full-width bf16 ResNet-50
    through ``DistributedOptimizer(SGD, momentum 0.9, groups=1)`` (one
    grouped allreduce a step, B1 on the path), the negotiation bypass
    armed after ``P21_K`` stable cycles, ``P21_STEPS`` steps, then a
    ``hvd.barrier()``.  The first job runs ``P21_PLAN`` with a
    coordinator journal: ``agg_restart`` on the aggregator's 10th
    request (1.5 s down), ``coord_restart`` (3 s down, rebuilt from the
    journal on the same port) on the coordinator's first ``clock``
    request, which rank 0 sends once the bypass armed; the second runs
    undisturbed.  Gates: both jobs exit 0; every replica (parameters and
    momentum) bit for bit the others, across the jobs too; the workers
    read coordinator epoch 2 after the faults, and aggregator epoch 2
    unless they fell back to the coordinator's route; no
    ``dead`` record in the journal; steps ran while the coordinator was
    down, all on the bypass.  (b) Phase 20 (a)'s elastic job with its
    failure from a plan: ``kill`` on the 127.0.0.1 worker's
    ``P21_KILL_AT``-th collective (step 3's first: the state's sync,
    then 161 a step), not the worker's own exit; the same rounds, the
    blacklisting and the survivor's steps 3-5 at size 1 as 20 (a), bit
    for bit phase 20 (a)'s in-process replay.  It prints each step's ms,
    the outages, the seconds from the coordinator's restart to the first
    reply, the epochs, the steps during the outage, B1 launches per
    process and the killed injector's fired record;
22. the rest of the torch frontend and the LM's memory path, in this
    process, cuDNN deterministic for (a) and (b).  (a) Adasum: phase
    4's run in f32 (full-width ResNet-50, 2 rank threads x 64 images)
    through ``DistributedOptimizer(SGD, momentum 0.9, op=Adasum)`` for
    ``P22_STEPS`` steps at the default fusion threshold (replicas bit
    for bit, the loss falls), again at ``HOROVOD_FUSION_THRESHOLD=0``
    (step 1's reduced gradients bit for bit a per-tensor
    ``adasum_reduce`` of the two ranks' local gradients), and through
    ``make_compiled_train_step(op=Adasum)`` as one CUDA graph (step 1's
    update within ``P22_COMPILED_REL_L2`` of the same per-leaf
    reference, replicas bit for bit).  (b) SyncBatchNorm: every
    ``BatchNorm`` of that f32 ResNet-50 swapped for
    ``hvd_torch.SyncBatchNorm`` (``swap_batch_norm``), 2 rank threads x
    64 images, ``P22_STEPS - 1`` steps, every backward on its rank's own
    thread, under a stall shutdown of ``P22_STALL_S``, and the same in
    f64 for 2 steps: the losses and averaged gradients of steps 1 and 2
    (step 1 moves the zero-init last scale of every block, so step 2's
    gradients are nonzero everywhere) against two plain steps on the
    128 images with ``torch.nn.BatchNorm2d`` in the same dtype (the
    bounds at ``P22_SYNC_BN_REL_L2``: in f64 all within
    ``P22_SYNC_BN_F64``; in f32 step 1 within ``P22_SYNC_BN_REL_L2``, and
    both steps no further from the f64 plain step than
    ``P22_SYNC_BN_VS_PLAIN`` times the f32 plain step), parameters and
    running statistics bit for bit across ranks.  (c) Sparse gradients:
    ``nn.Embedding(32000, 1024, sparse=True)``, a mean over positions
    and a linear head, 2 rank threads x 5 x 2048 seeded tokens, SGD,
    ``P22_STEPS - 1`` steps on the sparse path and with
    ``sparse_as_dense=True``: replicas bit for bit, the two paths'
    weights within ``P22_SPARSE_REL`` of each other.  (d) The 436M LM
    of phase 7 on its weights and tokens through
    ``make_lm_train_step(fused_ce=True)``, ``P22_LM_STEPS`` steps each
    with no remat and with the ``"full"``, ``"dots"`` and
    ``"dots_flash"`` policies: step 1's loss within ``P22_LOSS_ABS`` of
    phase 7's, every remat leg's losses and step-1 gradients bit for bit
    the no-remat leg's, flash launches per step (forward 24 without
    remat and under ``"dots_flash"``, 48 under ``"full"`` and
    ``"dots"``; dq and dk/dv 24), each leg's peak memory above what the
    process held before its steps below phase 7's.  B2-B5 and B9-B10
    are read before and after the phase, and must not have launched.  It
    prints every comparison, B1 launches per leg and, per LM leg, each
    step's ms and ``cudaMalloc`` calls, the median step from step 2 on as
    ms, tok/s and model TFLOP/s, the peak memory and the caching
    allocator's retries;
23. the topology-aware allreduce (hierarchical and torus, a per-hop
    wire pair), on phase 4's weights and batches cut to 4 ranks x 32
    images (bench.py's global 128): full-width ResNet-50, bf16, SGD
    momentum 0.9 through ``DistributedOptimizer(groups=1)``, 6 steps
    (``p18_train``).  (a) 4 rank threads with
    ``HOROVOD_TORUS_ALLREDUCE=1`` on one host (a 2 x 2 torus) beside the
    same run flat: replicas bit for bit, parameters within
    ``COMPILED_REL_L2`` of the flat run's, ``algo_runs["torus"]`` > 0, no
    cross-host byte, B1 launched.  (b) The same with the host map
    ``[0, 0, 1, 1]`` patched onto the engine, ``HOROVOD_HIERARCHICAL_
    ALLREDUCE=1`` and the wire pair (inner bf16, outer int8): the cross
    hop's bytes of the 161 gradients at most half the logical bytes at
    full width and a further >= 1.9x fewer under int8 (the JAX test's
    budget), each step's loss within ``P23_LOSS_REL`` (relative) of the
    flat run's.  (c) (b)'s run as a launcher job at ``-H
    P23_HOSTS``: 2 processes x 2 rank threads over gloo on cuda:0, the
    second host through ``STUB_SSH`` (``chip_smoke.py --worker23``):
    exit codes [0, 0] and the parameters bit for bit (b)'s.  (d)
    ``CompiledGroupedAllreduce(algorithm="torus")`` and the hint
    ``TopologyHint(("dp", "tp"), (2, 2))`` over the 161 gradient shapes
    at 4 rank threads: bit for bit the engine's torus, the hint's cross
    bytes half its logical bytes, the int4 outer wire's residual carried
    across 3 calls.  (e) ``make_compiled_train_step(sharded=True,
    topology_hint=TopologyHint(("dp", "tp"), (2, 2)))`` at 4 rank
    threads, captured as phase 14's step is, within ``COMPILED_REL_L2``
    of the flat sharded step on the same batches.  Each leg prints its
    steady ms a step (median of steps 2 on) and B1 launches beside the
    card line.

The two lines before the last are the card line and a JSON summary of
the kernels (with B1-B5's launches per phase-13 leg under
``sharded_launches``, every kernel's launches recorded by each phase-14
leg's capture under ``compiled_sharded``, each kernel's launches in
phase 15 under ``phase15_launches``, B1-B3's per phase-16 leg and
process under ``phase16_launches``, every kernel's per phase-17 leg
and process, through its wrapper, under ``phase17_launches``,
B1-B3's per phase-18 leg and process under ``phase18_launches``, B1's
per phase-19 (a) process under ``phase19_launches``, B1's per
phase-20 leg and process, localhost's then 127.0.0.1's, under
``phase20_launches``, and B1's per phase-21 (a) job and process and
per (b) process under ``phase21_launches``, every kernel's per
phase-22 leg under ``phase22_launches``, and every kernel's per phase-23
leg under ``phase23_launches``, a line of its own too); the last
line is ``{"ok": true, "device": {...}}``.  With ``--profile`` phases 4,
7, 9, 11, 12, 14 and 15, and phase 22 (d)'s no-remat and
``"dots_flash"`` legs, also print the profile tables of one steady step
each.  ``--phase22`` builds the kernels and runs phases 7 and 22 alone,
``--phase23`` phase 23 alone (no kernels line, no last line: not the
contract's run).
"""

import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 6
BATCH = 64
NP = 2
SEED = 0
# NVIDIA's H100 SXM data sheet: HBM3 rate, f32 rate outside the tensor
# cores (both at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
# the 436M LM of benchmarks/lm_mfu_bench.py:37-39, bf16 activations
LM = dict(vocab_size=32000, d_model=1024, n_layers=24, n_heads=8,
          d_ff=4096, max_seq_len=2048)
LM_BATCH = 5
LM_HVD_LAYERS, LM_HVD_BATCH, LM_HVD_STEPS = 2, 2, 3
# the four codec kernels: (name, TPU kernel it replaces, wire)
CODEC = (("quantize_blockwise", "horovod_tpu/ops/pallas_kernels.py:129",
          "int8"),
         ("dequantize_blockwise", "horovod_tpu/ops/pallas_kernels.py:149",
          "int8"),
         ("quantize_blockwise_int4",
          "horovod_tpu/ops/pallas_kernels.py:222", "int4"),
         ("dequantize_blockwise_int4",
          "horovod_tpu/ops/pallas_kernels.py:244", "int4"))
# gross sanity bounds on step 1's averaged gradient's relative L2
# distance from the exact f32 average
WIRE_REL_L2 = {"int8": 0.05, "int4": 0.5}
WIRE_RATIO = {"int8": 3.9, "int4": 7.5}
FLASH = (("flash_fwd", "horovod_tpu/ops/pallas_kernels.py:453"),
         ("flash_bwd_dq", "horovod_tpu/ops/pallas_kernels.py:498"),
         ("flash_bwd_dkv", "horovod_tpu/ops/pallas_kernels.py:514"))
# the 16-bit flash kernels are flash_sm90.cu's (wgmma, TMA): the file and
# kernel each route takes at the main path's bf16 shapes
FLASH_SOURCE = {
    "flash_fwd": "horovod_tpu_torch/ops/csrc/flash_sm90.cu",
    "flash_bwd_dq": "horovod_tpu_torch/ops/csrc/flash_sm90.cu",
    "flash_bwd_dkv": "horovod_tpu_torch/ops/csrc/flash_sm90.cu"}
FLASH_KERNEL = {"flash_fwd": "flash_fwd_sm90_kernel",
                "flash_bwd_dq": "flash_dq_sm90_kernel",
                "flash_bwd_dkv": "flash_dkv_sm90_kernel"}
# the fused conv+BN kernels: (name, TPU kernel it replaces); at the main
# path's bf16 shapes they take the sm90 route (conv_bn_sm90.cu), whose
# per-CTA sums end in its colsum4_kernel
CONV_BN = (("conv1x1_bn_fwd", "horovod_tpu/ops/pallas_conv_bn.py:125"),
           ("conv1x1_bn_bwd", "horovod_tpu/ops/pallas_conv_bn.py:204"))
CONV_BN_KERNEL = {
    "conv1x1_bn_fwd": "conv_bn_fwd_sm90_kernel + colsum4_kernel",
    "conv1x1_bn_bwd": "conv_bn_dx_sm90_kernel + conv_bn_dw_sm90_kernel + "
                      "colsum4_kernel"}
# fused 1x1 convolutions of one ResNet-50 rank step (16 blocks x conv1
# and conv3, and the first block's non-strided projection)
FUSED_CONVS = 33
# small and odd shapes of phase 10: M off the 64-row tile, K and N off
# multiples of 16
CONV_BN_ODD = ((16, 64, 64), (48, 24, 40), (1040, 72, 8),
               (1040, 256, 100), (96, 1, 3))
# bf16 shapes of phase 10 for the sm90 route beyond the step's: a 64-row
# tail past the last 128-row tile (the second consumer warpgroup wholly
# past M), 133 tiles (a CTA walks two), K 192 (dw's second k tile has one
# warpgroup) with 64-wide tiles
CONV_BN_SM90_ODD = ((320, 64, 128), (17000, 64, 64), (1000, 192, 320))
# phase 11's yardstick, fused against unfused bf16 steps: every gradient
# within a relative L2 of max(FUSED_REL_L2, twice the unfused step's own
# distance from the f32 step), the fused step no further from the f32
# gradients over all parameters than FUSED_GLOBAL x the unfused step, the
# losses within max(FUSED_LOSS, twice the unfused step's distance from
# the f32 loss).  The stem BN's bias is left out of the per-tensor bound
# (reported, and inside the global one): its gradient is the row sum of
# block 0's input gradient, which BN's mean removal nearly cancels, and
# the fused backward rounds every ytot element to bf16 before that sum,
# as the TPU kernel does (on the CPU, at 16-32 images, 1.9-3.3x the
# unfused step's error, growing with the batch; 1.0x with ytot unrounded)
FUSED_REL_L2, FUSED_GLOBAL, FUSED_LOSS = 3e-2, 1.25, 1e-2
FUSED_EXEMPT = ("bn_init.bias",)
# phase 12: the reference's ResNet-50 rate per GPU (bench.py:35,
# docs/benchmarks.rst:43: 1656.82 img/s on 16 Pascal GPUs), a label only
REFERENCE_IMG_S = 1656.82 / 16
# phase 12: bound on the relative L2 distance, over all parameters, of
# (b)'s and (c)'s parameters after 6 steps from phases 4's and 11's eager
# DistributedOptimizer runs on the same weights and batches.  Measured 0
# on an H100 (the same products in the same order); the margin is for
# cuDNN's algorithm choice, deterministic in phase 12 only
COMPILED_REL_L2 = 1e-3
# phase 12's grouped-reducer check: the bucket size of the bucketized
# leg; phase 14 (b): the segment size of the sharded step's scatter and
# gather (HOROVOD_OVERLAP_BUCKET_BYTES)
COMPILED_BUCKET_BYTES = 4 << 20
# phase 14's legs: (label, model, fused, sharded, wire, segment bytes)
SHARDED_LEGS = (("a f32", "resnet", False, True, None, 0),
                ("a bf16", "resnet", False, True, "bf16", 0),
                ("a int8", "resnet", False, True, "int8", 0),
                ("a int4", "resnet", False, True, "int4", 0),
                ("b f32", "resnet", False, True, None, COMPILED_BUCKET_BYTES),
                ("b int8", "resnet", False, True, "int8",
                 COMPILED_BUCKET_BYTES),
                ("c f32", "resnet", True, True, None, 0),
                ("d dense", "lm", False, False, None, 0),
                ("d f32", "lm", False, True, None, 0),
                ("d int8", "lm", False, True, "int8", 0))
# phases 13 and 14: bound on max |delta| of the sharded f32 leg's
# parameters after 6 steps from the dense leg's (tests/test_sharded.py's
# bar), where they are not bit for bit
SHARDED_PARAM_BOUND = 2e-6
# phase 15: the MoE LM at the 436M's width, docs/parallelism.md:219-221
# (8 experts, top 2, capacity factor 1.25) with lm_bench.py:237's
# per-expert hidden width 4 * d_model / K
MOE = dict(LM, d_ff=2048, num_experts=8, expert_top_k=2,
           moe_capacity_factor=1.25)
# phase 15 (a): depth of the flash-against-dense gradient gate (phase 7's
# rule: its f32 yardstick of the 24-layer MoE would not fit beside it)
MOE_GATE_LAYERS = 4
# phase 16: the bound on each leg's job (its workers' whole run)
PHASE16_TIMEOUT = 240
# phase 16: the codec kernels on its int8 leg and their launch counters
PHASE16_CODEC = {"quantize_blockwise": "quantize",
                 "dequantize_blockwise": "dequantize"}
# phases 16 and 17: the legs of the two launcher jobs (np=1 over NCCL,
# np=2 over gloo on cuda:0), and the legs that run cuDNN deterministic
PHASE16_JOBS = (("aefg", 1, {}),
                ("bcdhijk", 2, {"HOROVOD_GPU_OPERATIONS": "gloo"}),
                ("B", 2, {"HOROVOD_GPU_OPERATIONS": "gloo",
                          "HOROVOD_BYPASS_AFTER_CYCLES": "0"}))
DETERMINISTIC_LEGS = "aefghi"
# phase 17 (f): bound on |loss - phase 7's loss| at each of the 6 steps,
# phase 7's bar for two bf16 LM steps of the same weights and tokens
P17_LM_LOSS = 2e-3
# phase 17 (k): the signature exchange's timeout in the np=2 job (s)
P17_SIG_TIMEOUT = 60
# phase 18: the hybrid layout's rank count, images a rank and the
# bypass's stable cycles in (a)'s bypass-on job; its launcher jobs:
# (label, legs, np, ranks per worker, hosts, environment)
P18_NP = 4
P18_BATCH = 32
P18_K = 3
_GLOO = {"HOROVOD_GPU_OPERATIONS": "gloo"}
PHASE18_JOBS = (
    ("2 x 2, bypass off", "omd", 4, 2, "localhost:1,127.0.0.1:1",
     {**_GLOO, "HOROVOD_BYPASS_AFTER_CYCLES": "0"}),
    ("2 x 2, bypass on", "n", 4, 2, "localhost:1,127.0.0.1:1",
     {**_GLOO, "HOROVOD_BYPASS_AFTER_CYCLES": str(P18_K)}),
    ("host 2 + 1", "m", 3, "host", "localhost:2,127.0.0.1:1", _GLOO),
    ("--ranks-per-worker 2, NCCL", "c", 2, 2, None, {}))
# phase 19: the "remote" host, an address that is not this machine's
# (RFC 5737 TEST-NET-1: a literal resolves without a lookup, and no packet
# goes to it: the stub ssh runs the remote command here); the two jobs'
# hosts, the bound on each job, and the keys each worker reports from its
# environment (P19_LAUNCHER_ONLY is set in the launcher's own environment
# only, with no forwarded prefix, so it must not reach a remote worker)
P19_REMOTE = "192.0.2.1"
P19_HOSTS_A = f"localhost:1,{P19_REMOTE}:1"
P19_HOSTS_B = f"localhost:2,{P19_REMOTE}:2"
P19_TIMEOUT = 240
P19_LAUNCHER_ONLY = "HVD19_LAUNCHER_ONLY"
# phase 23: (b)'s and (c)'s engine configuration (hierarchical, inner hop
# bf16, outer hop int8), (c)'s hosts (the second through the stub ssh),
# the host map (b) patches onto its engine, and the bound on the relative
# distance of (b)'s losses from the flat run's at every step: the
# bf16/int8 wire moves each update by its rounding, which 6 steps of a
# random ResNet-50 amplify
P23_HIER_ENV = {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                "HOROVOD_WIRE_INNER": "bf16", "HOROVOD_WIRE_OUTER": "int8"}
P23_HOSTS = f"localhost:2,{P19_REMOTE}:2"
P23_HOST_MAP = [0, 0, 1, 1]
P23_LOSS_REL = 5e-2
P23_HINT = (("dp", "tp"), (2, 2))
# phase 20: elastic jobs through the port's horovodrun (``P20_LAUNCHER``
# runs its CLI with the elastic driver's INFO log on stderr, where the
# rounds and the blacklisting are read).  One worker a slot, both slots on
# cuda:0 over gloo; in (a) the worker on ``P20_DYING`` exits with
# ``P20_EXIT`` before step 3's allreduce in round 1; the blacklist's
# cooldown outlasts the job, so the host stays out.  (b)'s first worker
# holds at the commit after step 2 (at most ``P20_HOLD_S``) until the
# driver's new round reaches it, so steps 3-5 run at size 2.  Each job
# must end within ``P20_TIMEOUT``; the change the six steps made is held
# to an in-process replay within ``P20_REL_L2`` (relative L2).
P20_TIMEOUT = 300
P20_HOLD_S = 120
P20_DYING = "127.0.0.1"
P20_EXIT = 17
P20_REL_L2 = 1e-3
P20_LAUNCHER = (
    "import logging, sys\n"
    "logging.basicConfig(level=logging.INFO, stream=sys.stderr, "
    "format='%(asctime)s %(name)s %(message)s')\n"
    "from horovod_tpu_torch.runner.launch import run_commandline\n"
    "sys.exit(run_commandline(sys.argv[1:]))\n")
P20_DISCOVERY = {
    "a": "#!/bin/sh\necho localhost:1\necho 127.0.0.1:1\n",
    # the second host appears once the log shows step 2 committed; the
    # first time it does, the script stamps the change's time
    "b": ("#!/bin/sh\necho localhost:1\n"
          "if grep -q 'committed 2 ' {tmp}/commits.log 2>/dev/null; then\n"
          "  [ -f {tmp}/t_change ] || date +%s.%N > {tmp}/t_change\n"
          "  echo 127.0.0.1:1\nfi\n")}
P20_LEGS = {"a": ["-np", "2", "--min-np", "1", "--max-np", "2"],
            "b": ["-np", "1", "--min-np", "1", "--max-np", "2"]}
# phase 21: (a)'s steps, the bypass's stable cycles, the bound on each
# job, and its fault plan: the aggregator restarts on its 10th request
# (1.5 s down), the coordinator from its journal on its first ``clock``
# request (3 s down), which rank 0 sends once the bypass armed.  (b):
# phase 20 (a)'s job with the kill from a plan, on the 127.0.0.1
# worker's (proc 0 of round 1) ``P21_KILL_AT``-th collective: the
# elastic state's sync reports 271 (161 parameters and 110 buffers and
# objects), then each step 161, so step 3's first collective is
# 271 + 3 x 161 + 1 (counted on the CPU with the same model and state)
P21_STEPS = 8
P21_K = 2
P21_TIMEOUT = 240
P21_PLAN = {"seed": 21, "events": [
    {"kind": "agg_restart", "proc": 0, "after": 10, "ms": 1500},
    {"kind": "coord_restart", "verb": "clock", "after": 1, "ms": 3000}]}
P21_KILL_AT = 271 + 3 * 161 + 1
P21_KILL_PLAN = {"seed": 21, "events": [
    {"kind": "kill", "proc": 0, "after_collectives": P21_KILL_AT}]}
P20_DISCOVERY["k"] = P20_DISCOVERY["a"]
P20_LEGS["k"] = P20_LEGS["a"] + ["--fault-plan", json.dumps(P21_KILL_PLAN)]
# phase 22: the steps of (a) ((b) f32 and (c) run one fewer, (d)
# ``P22_LM_STEPS`` a leg), the stall
# shutdown that turns a hung SyncBatchNorm collective into an error, and
# the bounds: (a) the compiled step's step-1 update against the per-leaf
# reference, relative L2 per tensor (its gradients come from
# ``torch.autograd.grad`` over ``functional_call``, the reference's from
# the eager model's backward); (b) SyncBatchNorm against one plain step on
# the 128 images: the loss, and the gradients over all parameters, within
# ``P22_SYNC_BN_REL_L2`` (relative L2), each nonzero tensor within
# ``P22_SYNC_BN_TENSOR``; the f64 runs within ``P22_SYNC_BN_F64`` (the
# algorithm itself: on an NVIDIA H100 they agree to 1.7e-14 a tensor).
# In f32 this random ResNet-50's gradients are ill-conditioned: at step 2
# the plain f32 step itself lies 1.42e-3 (all parameters) and up to
# 0.0329 (a tensor) from the f64 one, so past step 1 the f32 run is held
# to ``P22_SYNC_BN_VS_PLAIN`` times the plain f32 step's own distance
# from the f64 step (read 1.39-1.79x) rather than to a fixed bound;
# (c) the sparse and the dense path's weights after the steps, relative
# L2 of their difference to the change the steps made (two summation
# orders of the same duplicates); (d) the fused loss against phase 7's
# unfused step-1 loss (the same f32 logits, chunked)
P22_STEPS = 4
P22_STALL_S = 120
P22_COMPILED_REL_L2 = 1e-3
P22_SYNC_BN_REL_L2 = 1e-3
P22_SYNC_BN_TENSOR = 1e-2
P22_SYNC_BN_F64 = 1e-8
P22_SYNC_BN_VS_PLAIN = 3.0
P22_LM_STEPS = 5
P22_SPARSE = dict(vocab=32000, width=1024, classes=16, lr=0.5)
P22_SPARSE_REL = 1e-4
P22_LOSS_ABS = 1e-4
P22_POLICIES = (None, "full", "dots", "dots_flash")
REPORTED_ENV = ("HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_TPU_COORDINATOR",
                "HOROVOD_HOSTNAME", "HOROVOD_GPU_OPERATIONS",
                "HOROVOD_SECRET_KEY", "CUDA_VISIBLE_DEVICES", "PYTHONPATH",
                P19_LAUNCHER_ONLY)
# phase 19: the stand-in for ssh that the launcher finds first on its PATH:
# it records its argv (NUL-separated, one file a call) and runs the last
# argument, the remote command, under sh with a login-like environment
# (HOME, TMPDIR, a system PATH) and ssh's stdin, so the worker gets only
# what the env handoff on stdin gives it; through exec the worker keeps
# the ssh client's PID, which the launcher terminates
STUB_SSH = """#!/bin/sh
printf '%s\\0' "$@" > "{log}/call.$$"
for last; do :; done
exec env -i HOME="$HOME" TMPDIR="${{TMPDIR:-/tmp}}" \\
    PATH=/usr/local/bin:/usr/bin:/bin sh -c "$last"
"""
# phase 15 (b): rank threads of the dispatch wire (ep = 2: 4 experts a
# rank), its wires, and the bound on the relative L2 distance of the
# ep = 2 FFN's output and gradients from the one-rank layer (bf16: the two
# run their expert products at other batch shapes)
A2A_NP = 2
A2A_WIRES = (None, "bf16", "int8", "int4")
EP_REL_L2 = 1e-2


#: a launcher worker's tag on its lines (phase 18's workers run phase
#: 4's code, whose lines would otherwise read as phase 4's own)
LOG_PREFIX = ""


def log(*a):
    if LOG_PREFIX:
        a = (LOG_PREFIX,) + a
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ptxas_kernels(log_text, marker):
    """``[(kernel, report)]`` of the kernels whose mangled name holds
    ``marker`` in an ``nvcc -Xptxas -v`` log: registers, spills, stack,
    with a template's bool and int arguments spelled out."""
    import re
    out, name = [], None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if marker in ln else None
        elif name and ("spill" in ln or "registers" in ln):
            label = name
            # the mangled <length><name> of the kernel, then its template
            # arguments: Lb0E / Lb1E (bool), Li<n>E (int)
            for m in re.finditer(r"\d+", name):
                for j in range(len(m.group())):
                    cand = name[m.end():m.end() + int(m.group()[j:])]
                    if cand.endswith("_kernel"):
                        args = re.match(r"I(Lb([01])E)?(Li(\d+)E)?",
                                        name[m.end() + len(cand):])
                        label = cand + ("<" + ", ".join(
                            v for v in (args.group(2) and ("false", "true")[
                                int(args.group(2))], args.group(4)) if v)
                            + ">" if args else "")
                        break
                if label != name:
                    break
            if out and out[-1][0] == label:
                out[-1] = (label, out[-1][1] + "; " + ln.split(":", 1)[-1]
                           .strip())
            else:
                out.append((label, ln.split(":", 1)[-1].strip()))
    return out


def cuda_ms(fn, iters=20, warmup=3):
    """(device ms, host ms) per call of ``fn``.  The device time is taken
    with the launches queued behind a spinning kernel, so that the host's
    enqueue cost (Python, table build) leaves no gaps between them; the
    host time is the enqueue cost itself."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # spin for 1.5x the enqueue time (at <= 2 GHz SM clock)
    torch.cuda._sleep(int(host_s * 1.5 * 2e9) + 1_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3 / iters


def resnet50_grad_shapes():
    from horovod_tpu_torch.models.resnet import ResNet50
    import torch
    with torch.device("meta"):
        model = ResNet50(num_classes=1000)
    return [tuple(p.shape) for p in model.parameters()]


# ---------------------------------------------------------------------------
# phase 3

def phase_kernel(dev):
    import torch
    from horovod_tpu_torch.ops import cuda_kernels as K

    g = torch.Generator(device="cpu").manual_seed(SEED)
    pairs = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.float32, torch.float16), (torch.bfloat16, torch.float32),
             (torch.float64, torch.float64)]
    cases = mismatches = 0
    max_err = 0.0
    for n in (1, 4095, 4097, 25_600_000):
        base = torch.randn(n, generator=g, dtype=torch.float64)
        for in_dt, out_dt in pairs:
            x = base.to(in_dt).to(dev)
            for factor in (1.0, 0.5, 1.0 / 3.0):
                got = K.fused_scale_cast(x, factor, out_dt)
                want = K.plain_scale_cast(x, factor, out_dt)
                torch.cuda.synchronize()
                cases += 1
                err = float((got.double() - want.double()).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    mismatches += 1
                    log(f"  MISMATCH n={n} {in_dt}->{out_dt} "
                        f"factor={factor}: max |diff| {err}")
    # pack/unpack round trip over the ResNet-50 gradient list
    shapes = resnet50_grad_shapes()
    grads = [torch.randn(s, generator=g).to(dev) for s in shapes]
    offsets, total = [], 0
    for t in grads:
        offsets.append(total)
        total += t.numel()
    for buf_dt, pre, post in ((torch.float32, 0.5, 2.0),
                              (torch.bfloat16, 1.0 / 3.0, 3.0)):
        buf = torch.empty(total, dtype=buf_dt, device=dev)
        ref = torch.empty_like(buf)
        K.pack_scale_cast(grads, buf, offsets, pre)
        for t, off in zip(grads, offsets):
            ref[off:off + t.numel()] = K.plain_scale_cast(
                t.reshape(-1), pre, buf_dt)
        outs = [torch.empty_like(t) for t in grads]
        K.unpack_scale_cast(buf, outs, offsets, post)
        torch.cuda.synchronize()
        cases += 2
        if not torch.equal(buf, ref):
            mismatches += 1
            log(f"  MISMATCH pack {buf_dt}")
        bad = sum(not torch.equal(o, K.plain_scale_cast(
            buf[off:off + o.numel()], post, o.dtype).view_as(o))
            for o, off in zip(outs, offsets))
        if bad:
            mismatches += 1
            log(f"  MISMATCH unpack {buf_dt}: {bad} tensors")
        max_err = max(max_err, float((buf.double() - ref.double()).abs().max()))
    # a ragged list longer than one launch holds: most offsets off the
    # 16-byte vector alignment, every seventh member empty
    rag = [torch.randn((i * 37) % 300 * (i % 7 != 0) + (i % 3 == 0) * 5000,
                       generator=g).to(dev)
           for i in range(2 * K.MAX_ENTRIES + 88)]
    roffs, rtotal = [], 0
    for t in rag:
        roffs.append(rtotal)
        rtotal += t.numel()
    rbuf = torch.empty(rtotal, dtype=torch.bfloat16, device=dev)
    K.pack_scale_cast(rag, rbuf, roffs, 1.0 / 3.0)
    rref = torch.cat([K.plain_scale_cast(t, 1.0 / 3.0, torch.bfloat16)
                      for t in rag])
    torch.cuda.synchronize()
    cases += 1
    if not torch.equal(rbuf, rref):
        mismatches += 1
        log(f"  MISMATCH pack of {len(rag)} ragged members")
    del rag, rbuf, rref
    log(f"phase 3: {cases} kernel-vs-plain cases, {mismatches} mismatches, "
        f"max |kernel - plain| = {max_err}")
    if mismatches:
        raise SystemExit("phase 3 failed: the kernel disagrees with its "
                         "plain version")

    # timing at the main path's work: one pack of the whole f32 gradient
    # list (25.56 M elements, 161 tensors)
    buf = torch.empty(total, dtype=torch.float32, device=dev)
    kernel_ms, kernel_host_ms = cuda_ms(
        lambda: K.pack_scale_cast(grads, buf, offsets, 0.5))

    def plain_pack():
        for t, off in zip(grads, offsets):
            buf[off:off + t.numel()] = K.plain_scale_cast(
                t.reshape(-1), 0.5, torch.float32)
    plain_ms, plain_host_ms = cuda_ms(plain_pack)
    flat = torch.randn(total, generator=g).to(dev)
    out = torch.empty_like(flat)
    library_ms, _ = cuda_ms(lambda: torch.mul(flat, 0.5, out=out))
    single_ms, _ = cuda_ms(lambda: K.pack_scale_cast([flat], out, [0], 0.5))
    nbytes = 2 * 4 * total
    bound_ms = max(nbytes / HBM_BYTES_PER_S, total / F32_FLOPS) * 1e3
    log(f"phase 3 timing, f32 pack of {len(grads)} tensors / {total} "
        f"elements ({nbytes} bytes moved), device ms per call: kernel "
        f"{kernel_ms:.4f}, bound {bound_ms:.4f} (bytes), plain "
        f"{plain_ms:.4f}, torch.mul on one flat tensor {library_ms:.4f}, "
        f"kernel on that flat tensor {single_ms:.4f}; host ms per call: "
        f"kernel wrapper {kernel_host_ms:.4f}, plain {plain_host_ms:.4f}")
    return {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "library_ms": library_ms,
            "elements": total}


# ---------------------------------------------------------------------------
# phase 4

def make_batches(n_ranks):
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    xs = [rng.standard_normal((BATCH, 224, 224, 3), dtype=np.float32)
          for _ in range(n_ranks)]
    ys = [rng.integers(0, 1000, size=BATCH) for _ in range(n_ranks)]
    return xs, ys


def step_batch(x, y, step):
    """A rank's batch at ``step`` from its base batch on the card: the
    images rolled by 16 pixels a step along the width, the labels by one,
    so that every step trains on new data (and a program that kept
    reading an earlier step's inputs would be caught) while phases 4, 11
    and 12 see the same batches."""
    import torch
    return (torch.roll(x, shifts=16 * step, dims=2),
            torch.roll(y, shifts=step, dims=0))


def profile_summary(prof, window_s, tables=True):
    """Device busy share of a profiled window (union of kernel
    intervals over the wall window), returned, and (``tables``) the
    kernels by device time."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    log(f"profile: {len(spans)} device events; device busy "
        f"{busy / 1e3:.2f} ms of a {window_s * 1e3:.2f} ms window "
        f"(busy share {busy / 1e6 / window_s:.3f})")
    if tables:
        table = prof.key_averages()
        log(table.table(sort_by="device_time_total", row_limit=12))
        log(table.table(sort_by="self_cpu_time_total", row_limit=20))
    return busy / 1e6 / window_s


def phase_main_path(dev, state, batches, profile=False, fused=False):
    """Phase 4 (``fused=False``) or phase 11 (``fused=True``: the same
    run with ``ResNet50(fused=True)`` on the same weights, moved by
    ``fused_from_unfused``, counting the fused kernels' launches and the
    route each took).  One steady step of rank 0 runs under
    torch.profiler for the device's busy share (its tables printed with
    ``profile``) and is left out of the steady mean."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.models.resnet import ResNet50, fused_from_unfused
    from horovod_tpu_torch.ops import conv_bn as CB
    from horovod_tpu_torch.ops import cuda_kernels as K

    phase = "phase 11" if fused else "phase 4"
    if fused:
        state = fused_from_unfused(state)
    xs, ys = batches
    barrier = threading.Barrier(NP)
    local_grads = {}
    records = []
    busy_share = []

    def train():
        r = hvd.rank()
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         fused=fused).to(dev)
        # every rank but the root starts from other weights, so the
        # broadcast has work to do
        model.load_state_dict({k: v if r == 0 else v + 1.0
                               for k, v in state.items()})
        hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
        params = list(model.parameters())
        capture = [p.register_post_accumulate_grad_hook(
            lambda p, i=i: local_grads.setdefault(r, {}).__setitem__(
                i, p.grad.clone())) for i, p in enumerate(params)]
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        x0 = torch.from_numpy(xs[r]).to(dev)
        y0 = torch.from_numpy(ys[r]).to(dev)
        eng = hvd.engine()
        losses, times, counts = [], [], []
        for step in range(STEPS):
            x, y = step_batch(x0, y0, step)
            barrier.wait()
            prof = None
            if r == 0 and step == STEPS - 2:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            if step == 0:
                opt.synchronize()
                for h in capture:
                    h.remove()
                barrier.wait()
                avg = [(local_grads[0][i] + local_grads[1][i]) * 0.5
                       for i in range(len(params))]
                bad = sum(not torch.equal(p.grad, a)
                          for p, a in zip(params, avg))
                if bad:
                    raise AssertionError(
                        f"rank {r}: {bad} averaged gradients differ from "
                        f"the plain average of the ranks' local gradients")
                with opt.skip_synchronize():
                    opt.step()
            else:
                opt.step()
            losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if prof is not None:
                prof.__exit__(None, None, None)
                log(f"profile: {phase}, one steady step of rank 0")
                busy_share.append(profile_summary(prof, times[-1],
                                                  tables=profile))
            barrier.wait()
            if r == 0:
                counts.append((eng.allreduce_buckets,
                               K.launches["pack_scale_cast"],
                               K.launches["unpack_scale_cast"],
                               CB.launches["conv1x1_bn_fwd"],
                               CB.launches["conv1x1_bn_bwd"],
                               CB.plain_calls["conv1x1_bn"],
                               CB.route_launches["conv1x1_bn_fwd_sm90"],
                               CB.route_launches["conv1x1_bn_bwd_sm90"]))
            barrier.wait()
        records.append((r, losses, times, counts))
        return {k: p.detach().clone() for k, p in model.named_parameters()}

    K.reset_launches()
    CB.reset_launches()
    results = hvd.run(train, np=NP, device=dev)
    launches = dict(K.launches)
    conv_launches = dict(CB.launches)

    by_rank = {r: (losses, times, counts) for r, losses, times, counts
               in records}
    for r in range(NP):
        if not all(math.isfinite(v) for v in by_rank[r][0]):
            raise AssertionError(f"{phase} rank {r}: non-finite loss "
                                 f"{by_rank[r][0]}")
    diff = [k for k in results[0]
            if not torch.equal(results[0][k], results[1][k])]
    if diff:
        raise AssertionError(f"{phase}: ranks' parameters differ after "
                             f"{STEPS} steps: {diff[:5]}")
    counts = by_rank[0][2]
    prev = (0,) * 8
    per_step, conv_per_step = [], []
    # per rank and step: 33 fused 1x1 convolutions, every one of them on
    # the sm90 route, 3 strided projections on the plain path (none on the
    # unfused model)
    want_conv = (FUSED_CONVS * NP, FUSED_CONVS * NP, 3 * NP,
                 FUSED_CONVS * NP, FUSED_CONVS * NP) if fused \
        else (0,) * 5
    for step, cur in enumerate(counts):
        buckets, pack, unpack, *conv = (c - p for c, p in zip(cur, prev))
        per_step.append(buckets)
        conv_per_step.append(conv)
        if buckets < 1 or pack != buckets * NP or unpack != buckets * NP:
            raise AssertionError(
                f"{phase} step {step}: {buckets} buckets but {pack} pack "
                f"and {unpack} unpack launches (want buckets x {NP} ranks)")
        if tuple(conv) != want_conv:
            raise AssertionError(
                f"{phase} step {step}: conv1x1_bn_fwd, conv1x1_bn_bwd, "
                f"plain-path calls, sm90-route fwd and bwd {conv}, want "
                f"{want_conv}")
        prev = cur
    if launches["fused_scale_cast"] != 0:
        raise AssertionError(f"{phase}: the main path launched "
                             f"fused_scale_cast")
    step_s = [max(by_rank[r][1][i] for r in range(NP))
              for i in range(STEPS)]
    # steady: after the warm-up step, without the profiled step
    timed = [t for i, t in enumerate(step_s)
             if i > 0 and i != STEPS - 2]
    steady = sum(timed) / len(timed)
    img_s = NP * BATCH / steady
    log(f"{phase}: losses rank0 {by_rank[0][0]}")
    log(f"{phase}: losses rank1 {by_rank[1][0]}")
    log(f"{phase}: buckets per step {per_step}; launches {launches}; "
        f"step 1 averaged gradients equal the plain average; parameters "
        f"of both ranks bit-identical after {STEPS} steps")
    if fused:
        log(f"{phase}: per step conv1x1_bn_fwd, conv1x1_bn_bwd launches, "
            f"plain-path calls and sm90-route fwd, bwd launches "
            f"{conv_per_step[0]} (all steps equal); in all {conv_launches}, "
            f"by route {dict(CB.route_launches)}")
    log(f"{phase}: step times (s) {[round(t, 4) for t in step_s]}; steady "
        f"{steady * 1e3:.2f} ms/step = {img_s:.1f} img/s on one card "
        f"({NP} ranks x {BATCH} images)")
    return {"launches": launches["pack_scale_cast"]
            + launches["unpack_scale_cast"], "steady_s": steady,
            "img_s": img_s, "buckets": per_step,
            "conv_launches": conv_launches, "busy_share": busy_share[0],
            "params": {k: v.cpu() for k, v in results[0].items()}}


def phase_plain_step(dev, state, batches):
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.models.resnet import ResNet50

    xs, ys = batches
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16).to(dev)
    model.load_state_dict(state)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    x = torch.cat([torch.from_numpy(a) for a in xs]).to(dev)
    y = torch.cat([torch.from_numpy(a) for a in ys]).to(dev)
    times = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    steady = sum(times[1:]) / (STEPS - 1)
    log(f"phase 4 yardstick: plain single-process step on the same "
        f"{x.shape[0]} images: {steady * 1e3:.2f} ms = "
        f"{x.shape[0] / steady:.1f} img/s")
    return steady


def phase_plain_threads(dev, state, batches):
    """Diagnostic (--profile): the same two rank threads, each training
    its own model on its own batch with plain torch and no horovod --
    what two threads sharing one card and one interpreter cost alone."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.models.resnet import ResNet50

    xs, ys = batches
    barrier = threading.Barrier(NP)
    times = {}

    def worker(r):
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16).to(dev)
        model.load_state_dict(state)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        x = torch.from_numpy(xs[r]).to(dev)
        y = torch.from_numpy(ys[r]).to(dev)
        out = []
        for _ in range(STEPS):
            barrier.wait()
            t0 = time.perf_counter()
            opt.zero_grad()
            F.cross_entropy(model(x), y).backward()
            opt.step()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
            barrier.wait()
        times[r] = out

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(NP)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    step_s = [max(times[r][i] for r in range(NP)) for i in range(STEPS)]
    steady = sum(step_s[1:]) / (STEPS - 1)
    log(f"profile: {NP} threads of plain torch, no horovod: "
        f"{steady * 1e3:.2f} ms/step = {NP * BATCH / steady:.1f} img/s")


# ---------------------------------------------------------------------------
# phase 5

def plain_encode(x, wire):
    from horovod_tpu_torch.ops import quantize as qz
    return qz.plain_quantize_blockwise_int4(x) if wire == "int4" \
        else qz.plain_quantize_blockwise(x)


def plain_decode(q, scales, n, wire, out_dtype=None):
    import torch
    from horovod_tpu_torch.ops import quantize as qz
    dec = qz.plain_dequantize_blockwise_int4 if wire == "int4" \
        else qz.plain_dequantize_blockwise
    return dec(q, scales, n, out_dtype or torch.float32)


def phase_nccl(dev):
    import torch
    import torch.distributed as dist
    from horovod_tpu_torch.core.message import ReduceOp
    from horovod_tpu_torch.ops import cuda_kernels as K
    from horovod_tpu_torch.ops import quantize_kernels as QK
    from horovod_tpu_torch.ops.dist_ops import MeshExecutor

    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    grads = [torch.randn(s, generator=g).to(dev)
             for s in resnet50_grad_shapes()]
    offsets, total = [], 0
    for t in grads:
        offsets.append(total)
        total += t.numel()
    pre, post = 1.0 / 3.0, 0.25
    wired = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            ex = MeshExecutor(dev, 1, group=dist.group.WORLD)
            buf = torch.empty(total, device=dev)
            K.pack_scale_cast(grads, buf, offsets, pre)
            (y,) = ex.reduce([buf], ReduceOp.SUM)
            outs = [torch.empty_like(t) for t in grads]
            K.unpack_scale_cast(y, outs, offsets, post)
            # the same bucket on the quantized wires: packed with factor
            # 1, encoded on the card, gathered, decoded, scaled in f32
            raw = torch.empty(total, device=dev)
            K.pack_scale_cast(grads, raw, offsets, 1.0)
            for bits, wire in ((8, "int8"), (4, "int4")):
                q, sc = QK.encode(raw, wire)
                (yq,) = ex.allreduce_quantized([q], [sc], ReduceOp.AVERAGE,
                                               pre, post, nbits=bits,
                                               n_elems=total)
                wired[wire] = (q, sc, yq)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    bad = sum(not torch.equal(o, K.plain_scale_cast(
        K.plain_scale_cast(t, pre, torch.float32), post, torch.float32))
        for o, t in zip(outs, grads))
    if bad:
        raise AssertionError(f"phase 5: {bad} tensors differ from the plain "
                             f"pre/post-scaled allreduce")
    for wire, (q, sc, yq) in wired.items():
        pq, ps = plain_encode(raw, wire)
        want = plain_decode(pq, ps, total, wire) * (pre * post)
        if not (torch.equal(q, pq) and torch.equal(sc, ps)
                and torch.equal(yq, want)):
            raise AssertionError(f"phase 5: the {wire} allreduce over NCCL "
                                 f"differs from the plain codec")
    log(f"phase 5: NCCL allreduce of {len(grads)} tensors ({total} f32) "
        f"as one fused bucket, pre {pre} post {post}: equal to the plain "
        f"version; allreduce_quantized of the same bucket on the int8 and "
        f"int4 wires (Average): codes, scales and result equal to the "
        f"plain codec")


# ---------------------------------------------------------------------------
# phase 6

def flash_bound_ms(BH, S, D, itemsize):
    """Each kernel's least time on the card for causal attention: the
    larger of its tensor-core flops over the S(S+1)/2 visible pairs of
    each row at the bf16 peak, and its bytes (each input read once, each
    output written once) at the HBM rate.  ``{name: (ms, "operations" or
    "bytes", flops)}``."""
    pairs = BH * S * (S + 1) // 2
    tile, rows = BH * S * D * itemsize, BH * S * 4
    work = {"flash_fwd": (4 * D * pairs, 3 * tile + tile + rows),
            "flash_bwd_dq": (6 * D * pairs, 4 * tile + 2 * rows + tile),
            "flash_bwd_dkv": (8 * D * pairs, 4 * tile + 2 * rows + 2 * tile)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_op, t_mem = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        out[name] = (max(t_op, t_mem) * 1e3,
                     "operations" if t_op >= t_mem else "bytes", flops)
    return out


def cuda_kernel_names(fn):
    """Names of the CUDA kernels one call of ``fn`` runs (profiled)."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if e.device_time_total > 0]


def phase_flash_kernels(dev):
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device="cpu").manual_seed(SEED + 3)
    cases, failures, main_err = 0, [], {}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 128):
            for S in (128, 1000, 2048):
                for BH in (3, 40):
                    q, k, v, do = (torch.randn(BH, S, D, generator=g)
                                   .to(dev, dtype) for _ in range(4))
                    for window in (None, 1, 100, S - 1):
                        out, lse = FA.flash_fwd(q, k, v, window)
                        r_out, r_lse = FA.plain_flash_fwd(q, k, v, window)
                        delta = (do.float() * r_out.float()).sum(-1)
                        dq = FA.flash_bwd_dq(q, k, v, do, r_lse, delta,
                                             window)
                        dk, dv = FA.flash_bwd_dkv(q, k, v, do, r_lse,
                                                  delta, window)
                        r_dq = FA.plain_flash_bwd_dq(q, k, v, do, r_lse,
                                                     delta, window)
                        r_dk, r_dv = FA.plain_flash_bwd_dkv(
                            q, k, v, do, r_lse, delta, window)
                        sc = FA.plain_error_scales(q, k, v, do, r_out,
                                                   r_lse, delta, window)
                        torch.cuda.synchronize()
                        errs = {}
                        for name, got, want, t_dtype, rss, noise in (
                                ("out", out, r_out, dtype, sc["rss_out"],
                                 None),
                                # f32 for every input dtype
                                ("lse", lse, r_lse, torch.float32, None,
                                 None),
                                ("dq", dq, r_dq, dtype, sc["rss_dq"],
                                 sc["noise_dq"]),
                                ("dk", dk, r_dk, dtype, sc["rss_dk"],
                                 sc["noise_dk"]),
                                ("dv", dv, r_dv, dtype, sc["rss_dv"],
                                 None)):
                            err, ratio = FA.error_ratio(got, want, t_dtype,
                                                        rss, noise)
                            errs[name] = err
                            worst[dtype] = max(worst[dtype], ratio)
                            if not ratio <= 1.0:
                                failures.append(
                                    f"{dtype} D={D} S={S} BH={BH} "
                                    f"window={window} {name}: max |diff| "
                                    f"{err}, {ratio} of its bound")
                        del sc
                        cases += 1
                        if (dtype, D, S, BH, window) == (
                                torch.bfloat16, 128, 2048, 40, None):
                            main_err = {
                                "flash_fwd": errs["out"],
                                "flash_bwd_dq": errs["dq"],
                                "flash_bwd_dkv": max(errs["dk"],
                                                     errs["dv"])}
                    del q, k, v, do, out, lse, r_out, r_lse, delta
                    del dq, dk, dv, r_dq, r_dk, r_dv
    torch.cuda.empty_cache()
    log(f"phase 6: {cases} cases x 3 kernels against their plain "
        f"versions, {len(failures)} failures; worst error / bound "
        f"(elementwise or relative L2, see FA.error_ratio): f32 "
        f"{worst[torch.float32]:.4f}, bf16 {worst[torch.bfloat16]:.4f}; "
        f"max |kernel - plain| at the LM's shape (bf16): {main_err}")
    for f in failures[:20]:
        log(f"  MISMATCH {f}")
    if failures:
        raise SystemExit("phase 6 failed: a flash kernel disagrees with "
                         "its plain version")

    # timing at the LM's shape
    B, S, H, D = LM_BATCH, LM["max_seq_len"], LM["n_heads"], \
        LM["d_model"] // LM["n_heads"]
    q, k, v, do = (torch.randn(B * H, S, D, generator=g)
                   .to(dev, torch.bfloat16) for _ in range(4))
    out, lse = FA.flash_fwd(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    calls = {
        "flash_fwd": (lambda: FA.flash_fwd(q, k, v),
                      lambda: FA.plain_flash_fwd(q, k, v)),
        "flash_bwd_dq": (
            lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta),
            lambda: FA.plain_flash_bwd_dq(q, k, v, do, lse, delta)),
        "flash_bwd_dkv": (
            lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta),
            lambda: FA.plain_flash_bwd_dkv(q, k, v, do, lse, delta))}
    bounds = flash_bound_ms(B * H, S, D, 2)
    res, tflops = {}, {}
    for name, (kern, plain) in calls.items():
        ms, _ = cuda_ms(kern)
        plain_ms, _ = cuda_ms(plain, iters=5, warmup=1)
        res[name] = {"ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1],
                     "max_abs_err": main_err[name], "library_ms": None}
        tflops[name] = bounds[name][2] / ms / 1e9
    q4, k4, v4, do4 = (t.view(B, H, S, D) for t in (q, k, v, do))
    sdpa_ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
    sdpa_fb_ms, _ = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, is_causal=True), leaves,
        do4))
    # PyTorch's flash backward alone: one call gives dq, dk and dv from
    # the output and logsumexp of its own forward on the same q, k, v
    aten = torch.ops.aten
    o4, lse4, cq, ck, mq, mk, seed, offset, _ = \
        aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, True)
    sdpa_b_ms, _ = cuda_ms(
        lambda: aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, True, seed,
            offset))
    res["flash_fwd"]["library_ms"] = sdpa_ms
    res["flash_bwd_dq"]["library_ms"] = sdpa_b_ms
    res["flash_bwd_dkv"]["library_ms"] = sdpa_b_ms
    for name, r in res.items():
        log(f"phase 6 timing {name} (BH {B * H}, S {S}, D {D}, bf16, "
            f"causal): kernel {r['ms']:.4f} ms = {tflops[name]:.1f} "
            f"TFLOP/s, {r['bound_ms'] / r['ms']:.3f} of its bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms")
    fwd_names = cuda_kernel_names(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    fb_names = cuda_kernel_names(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, is_causal=True), leaves,
        do4))
    log(f"phase 6 yardstick kernels: scaled_dot_product_attention forward "
        f"ran {fwd_names}; forward+backward ran {fb_names}")
    total = sum(r["ms"] for r in res.values())
    log(f"phase 6 timing: the three kernels {total:.4f} ms; "
        f"scaled_dot_product_attention forward {sdpa_ms:.4f} ms, "
        f"forward+backward {sdpa_fb_ms:.4f} ms; flash backward alone "
        f"(dq, dk and dv in one call) {sdpa_b_ms:.4f} ms")
    FA.reset_launches()
    return res


# ---------------------------------------------------------------------------
# phase 7

def lm_flops_per_token(cfg):
    """benchmarks/lm_mfu_bench.py:42-49: 6 x (block + logits matmul
    params) + the causal attention matmuls, forward and backward."""
    d, f, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    n_block = L * (4 * d * d + 3 * d * f)
    attn = 6 * L * cfg.max_seq_len * d * 0.5
    return 6 * (n_block + V * d) + attn


def phase_lm(dev, profile=False):
    import numpy as np
    import torch
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, lm_loss, numpy_init)
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.parallel import make_lm_train_step

    cfg = TransformerConfig(dtype=torch.bfloat16, **LM)
    with torch.device("meta"):
        shell = TransformerLM(cfg)
    t0 = time.perf_counter()
    weights = numpy_init(shell, SEED)
    init_s = time.perf_counter() - t0
    tokens = np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab_size, size=(LM_BATCH, cfg.max_seq_len))
    tok = torch.from_numpy(tokens).to(dev)
    names = [n for n, _ in FLASH]

    init, step = make_lm_train_step(cfg, attention_impl="flash", device=dev)
    state = init(weights)
    n_params = sum(p.numel() for p in state["model"].parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what the process held before the steps (the model, and whatever
    # earlier phases left): the steps' own peak is the peak above it
    held = torch.cuda.memory_allocated()
    losses, times, per_step, grads = [], [], [], None
    prev = [0, 0, 0]
    FA.reset_launches()
    for i in range(STEPS):
        prof = None
        if profile and i == STEPS - 2:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        state, loss = step(state, tok)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if prof is not None:
            prof.__exit__(None, None, None)
            profile_summary(prof, times[-1])
        losses.append(float(loss))
        cur = [FA.launches[n] for n in names]
        per_step.append([c - p for c, p in zip(cur, prev)])
        prev = cur
        if i == 0:
            grads = {n: p.grad.detach().cpu() for n, p in
                     state["model"].named_parameters()}
    launches = dict(FA.launches)
    peak = torch.cuda.max_memory_allocated()

    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 7: non-finite loss {losses}")
    # random init: unit-RMS hidden states against a normal(0.02)
    # embedding give logits of variance d_model * 0.02**2, whose expected
    # cross entropy is ln V + variance / 2
    want = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    if abs(losses[0] - want) > 0.1:
        raise AssertionError(f"phase 7: step 1 loss {losses[0]} is not "
                             f"within 0.1 of {want:.4f}")
    if any(c != [cfg.n_layers] * 3 for c in per_step):
        raise AssertionError(f"phase 7: flash launches per step {per_step}, "
                             f"want {cfg.n_layers} of each")
    timed = [t for i, t in enumerate(times)
             if i > 0 and not (profile and i == STEPS - 2)]
    steady = sum(timed) / len(timed)
    tok_s = LM_BATCH * cfg.max_seq_len / steady
    tflops = lm_flops_per_token(cfg) * tok_s / 1e12
    log(f"phase 7: {n_params} parameters (numpy init {init_s:.1f} s); "
        f"losses {losses}; flash launches per step {per_step[0]} "
        f"(all steps equal); {launches}")
    log(f"phase 7: step times (s) {[round(t, 4) for t in times]}; steady "
        f"{steady * 1e3:.2f} ms/step = {tok_s:.1f} tok/s = {tflops:.1f} "
        f"model TFLOP/s ({lm_flops_per_token(cfg) / 1e9:.3f} GFLOP/token); "
        f"peak memory {peak / 2**30:.2f} GiB, "
        f"{(peak - held) / 2**30:.2f} GiB above what the process held "
        f"before the steps")

    # the dense model, one step from the same weights and tokens
    del state, loss
    gc.collect()
    torch.cuda.empty_cache()
    init_d, step_d = make_lm_train_step(cfg, attention_impl="ring",
                                        device=dev)
    state = init_d(weights)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, loss_d = step_d(state, tok)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    dense_peak = torch.cuda.max_memory_allocated()
    loss_d = float(loss_d)
    grads_d = {n: p.grad.detach() for n, p in
               state["model"].named_parameters()}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # the same step's f32 gradients (dense attention in plain torch, no
    # TF32, none of the port's kernels): the yardstick of the two bf16
    # steps' own noise
    with torch.device("meta"):
        ref = TransformerLM(TransformerConfig(dtype=torch.float32, **LM))
    ref.to_empty(device=dev)
    ref.load_state_dict(weights)
    torch.cuda.reset_peak_memory_stats()
    loss_r = lm_loss(ref(tok)[:, :-1], tok[:, 1:])
    loss_r.backward()
    loss_r = float(loss_r.detach())
    ref_peak = torch.cuda.max_memory_allocated()
    fd, f_ref, d_ref, sq = {}, {}, {}, [0.0, 0.0, 0.0]
    for n, p in ref.named_parameters():
        r, gf, gd = p.grad, grads[n].to(dev).float(), grads_d[n].float()
        rn = float(r.norm())
        fd[n] = float((gf - gd).norm() / gd.norm())
        f_ref[n] = float((gf - r).norm()) / rn
        d_ref[n] = float((gd - r).norm()) / rn
        for j, x in enumerate((gf - r, gd - r, r)):
            sq[j] += float(x.norm()) ** 2
    glob_f, glob_d = math.sqrt(sq[0] / sq[2]), math.sqrt(sq[1] / sq[2])
    bad = [n for n in fd if fd[n] > max(2e-2, 2 * d_ref[n])]
    worst = max(fd, key=lambda n: fd[n] / max(2e-2, 2 * d_ref[n]))
    log(f"phase 7 dense step (batch {LM_BATCH}): loss {loss_d} vs flash "
        f"{losses[0]} (|diff| {abs(loss_d - losses[0]):.3g}, bound 2e-3), "
        f"f32 dense loss {loss_r}; first step {dense_s * 1e3:.1f} ms, "
        f"peak memory {dense_peak / 2**30:.2f} GiB (f32 dense step "
        f"{ref_peak / 2**30:.2f} GiB)")
    log(f"phase 7 gradients, relative L2 per tensor: flash vs dense worst "
        f"{fd[worst]:.4g} ({worst}; bound max(2e-2, 2 x dense vs f32 = "
        f"{2 * d_ref[worst]:.4g})), median "
        f"{sorted(fd.values())[len(fd) // 2]:.4g}; "
        f"against f32, all parameters: flash {glob_f:.4g}, dense "
        f"{glob_d:.4g} (bound flash <= 1.25 x dense); worst tensor flash "
        f"{max(f_ref.values()):.4g}, dense {max(d_ref.values()):.4g}")
    if abs(loss_d - losses[0]) > 2e-3 or bad or glob_f > 1.25 * glob_d:
        raise AssertionError(f"phase 7: the flash step disagrees with the "
                             f"dense step beyond bf16 noise: {bad[:5]}")
    del ref, grads, grads_d, loss_r
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "steady_s": steady, "tok_s": tok_s,
            "tflops": tflops, "peak": peak, "step_peak": peak - held,
            "weights": weights, "losses": losses, "tokens": tokens}


def phase_lm_hvd(dev):
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, lm_loss, numpy_init)
    from horovod_tpu_torch.ops import cuda_kernels as K
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.parallel.train import adamw

    cfg = TransformerConfig(dtype=torch.bfloat16,
                            **{**LM, "n_layers": LM_HVD_LAYERS})
    with torch.device("meta"):
        shell = TransformerLM(cfg)
    weights = numpy_init(shell, SEED + 5)
    rng = np.random.default_rng(SEED + 6)
    toks = [rng.integers(0, cfg.vocab_size,
                         size=(LM_HVD_BATCH, cfg.max_seq_len))
            for _ in range(NP)]
    barrier = threading.Barrier(NP)
    local, losses = {}, {}

    def train():
        r = hvd.rank()
        with torch.device("meta"):
            model = TransformerLM(cfg, attention_fn=FA.flash_attention)
        model.to_empty(device=dev)
        model.load_state_dict({k: v if r == 0 else v + 1.0
                               for k, v in weights.items()})
        hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
        params = list(model.parameters())
        capture = [p.register_post_accumulate_grad_hook(
            lambda p, i=i: local.setdefault(r, {}).__setitem__(
                i, p.grad.clone())) for i, p in enumerate(params)]
        opt = hvd_torch.DistributedOptimizer(
            adamw(1e-3)(params), named_parameters=model.named_parameters())
        t = torch.from_numpy(toks[r]).to(dev)
        for step in range(LM_HVD_STEPS):
            opt.zero_grad()
            loss = lm_loss(model(t)[:, :-1], t[:, 1:])
            loss.backward()
            opt.synchronize()
            if step == 0:
                for h in capture:
                    h.remove()
                barrier.wait()
                bad = sum(not torch.equal(
                    p.grad, (local[0][i] + local[1][i]) * 0.5)
                    for i, p in enumerate(params))
                if bad:
                    raise AssertionError(
                        f"rank {r}: {bad} averaged LM gradients differ "
                        f"from the plain average of the ranks' local "
                        f"gradients")
            with opt.skip_synchronize():
                opt.step()
            losses.setdefault(r, []).append(float(loss.detach()))
        return {k: p.detach().clone() for k, p in model.named_parameters()}

    K.reset_launches()
    FA.reset_launches()
    results = hvd.run(train, np=NP, device=dev)
    flash = dict(FA.launches)
    packs = K.launches["pack_scale_cast"]
    diff = [k for k in results[0]
            if not torch.equal(results[0][k], results[1][k])]
    if diff:
        raise AssertionError(f"phase 7 np={NP}: ranks' LM parameters "
                             f"differ after {LM_HVD_STEPS} steps: {diff[:5]}")
    want = LM_HVD_LAYERS * NP * LM_HVD_STEPS
    if any(flash[n] != want for n, _ in FLASH) or packs < LM_HVD_STEPS * NP:
        raise AssertionError(f"phase 7 np={NP}: flash launches {flash} "
                             f"(want {want} each), {packs} packs")
    if not all(math.isfinite(x) for v in losses.values() for x in v):
        raise AssertionError(f"phase 7 np={NP}: non-finite loss {losses}")
    log(f"phase 7 np={NP}: {LM_HVD_LAYERS}-layer full-width LM through "
        f"DistributedOptimizer(AdamW), {LM_HVD_STEPS} steps; losses "
        f"{losses}; step 1 averaged gradients equal the plain average; "
        f"parameters of both ranks bit-identical; flash launches {flash}, "
        f"{packs} pack launches")
    del results
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8

def codec_inputs(n, seed):
    """n normal values whose scale varies over six decades across blocks."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    nb = -(-n // 256)
    scale = np.repeat(10.0 ** rng.uniform(-3, 3, nb).astype(np.float32),
                      256)[:n]
    return torch.from_numpy(rng.standard_normal(n, dtype=np.float32) * scale)


def codec_edge_blocks(qmax):
    """Zero, subnormal-scale, tie and clip blocks and a ragged tail (the
    edge blocks of tests/test_torch_quantize.py)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    ties = ((np.arange(256) % (2 * qmax)) - qmax + 0.5) * 0.25
    ties[0] = qmax * 0.25
    clip = np.linspace(-1.0, 1.0, 256) * (qmax + 1) * 2.0 ** -133
    blocks = [np.zeros(256), rng.standard_normal(256) * 1e-38, ties, clip,
              rng.standard_normal(100)]
    return torch.from_numpy(np.concatenate(blocks).astype(np.float32))


def codec_bound_ms(n, bits, decode):
    """Least time of one encode or decode of n f32 elements: its bytes
    (f32 values, codes of the nb padded blocks, f32 scales; each read or
    written once) at the HBM rate, against its f32 operations (encode:
    abs, max, divide, round and two clamps; decode: one multiply) at the
    f32 rate."""
    nb = -(-n // 256)
    code_bytes = nb * 256 if bits == 8 else nb * 128
    nbytes = 4 * n + code_bytes + 4 * nb
    ops = n * (1 if decode else 6)
    t_mem, t_op = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_mem, t_op) * 1e3, "bytes" if t_mem >= t_op else "operations"


def _bits_equal(a, b):
    import torch
    if a.dtype.is_floating_point:
        iv = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.view(iv), b.view(iv)
    return torch.equal(a, b)


def phase_codec(dev):
    import torch
    from horovod_tpu_torch.ops import quantize_kernels as QK

    n_main = sum(math.prod(s) for s in resnet50_grad_shapes())
    names = {8: ("quantize_blockwise", "dequantize_blockwise"),
             4: ("quantize_blockwise_int4", "dequantize_blockwise_int4")}
    cases, failures = 0, []
    err = {name: 0.0 for name, _, _ in CODEC}
    inputs = [(n, codec_inputs(n, n)) for n in
              (1, 255, 256, 257, 70_000, n_main)]
    for bits, wire in ((8, "int8"), (4, "int4")):
        enc_name, dec_name = names[bits]
        edge = codec_edge_blocks(127 if bits == 8 else 7)
        nonfinite = codec_inputs(1024, 4)
        nonfinite[256 + 17] = float("nan")
        nonfinite[512 + 200] = float("inf")
        nonfinite[768 + 3] = float("-inf")
        for label, base in inputs + [("edge", edge),
                                     ("nan/inf", nonfinite)]:
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                if label == "nan/inf" and dt != torch.float32:
                    continue
                x = base.to(dt).to(dev)
                n = x.numel()
                q, s = QK.encode(x, wire)
                pq, ps = plain_encode(x, wire)
                outs = [(od, QK.decode(q, s, n, bits, od),
                         plain_decode(pq, ps, n, wire, od))
                        for od in (torch.float32, torch.bfloat16)]
                torch.cuda.synchronize()
                cases += 1
                tag = f"{wire} {label} {dt}"
                if label == "nan/inf":
                    # codes of a NaN or inf block are not compared; every
                    # decoded value of those blocks is NaN on both sides
                    ok = (torch.equal(q[:q.numel() // 4], pq[:q.numel() // 4])
                          and all(_bits_equal(g.view(4, 256)[0],
                                              w.view(4, 256)[0])
                                  and g.view(4, 256)[1:].isnan().all()
                                  and w.view(4, 256)[1:].isnan().all()
                                  for _, g, w in outs))
                    if not ok:
                        failures.append(tag)
                    continue
                err[enc_name] = max(err[enc_name], float(
                    (q.int() - pq.int()).abs().max()) if n else 0.0,
                    float((s - ps).abs().max()) if n else 0.0)
                if not (torch.equal(q, pq) and _bits_equal(s, ps)):
                    failures.append(f"{tag} encode")
                for od, got, want in outs:
                    if n:
                        err[dec_name] = max(err[dec_name], float(
                            (got.float() - want.float()).abs().max()))
                    if not _bits_equal(got, want):
                        failures.append(f"{tag} decode to {od}")
    log(f"phase 8: {cases} codec cases (encode, decode to f32 and bf16) "
        f"against the plain versions, {len(failures)} failures; max "
        f"|kernel - plain| {err}")
    for f in failures[:20]:
        log(f"  MISMATCH {f}")
    if failures:
        raise SystemExit("phase 8 failed: a codec kernel disagrees with its "
                         "plain version")

    # timing on the ResNet-50 gradient's length, f32
    x = inputs[-1][1].to(dev)
    res = {}
    for bits, wire in ((8, "int8"), (4, "int4")):
        enc_name, dec_name = names[bits]
        q, s = QK.encode(x, wire)
        calls = {
            enc_name: (lambda: QK.encode(x, wire),
                       lambda: plain_encode(x, wire), False),
            dec_name: (lambda: QK.decode(q, s, n_main, bits),
                       lambda: plain_decode(q, s, n_main, wire), True)}
        for name, (kern, plain, decode) in calls.items():
            ms, host_ms = cuda_ms(kern)
            plain_ms, _ = cuda_ms(plain, iters=5, warmup=1)
            bound, by = codec_bound_ms(n_main, bits, decode)
            res[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by, "max_abs_err": err[name],
                         "library_ms": None, "host_ms": host_ms}
        if bits == 8:
            rows, sc = q.view(-1, 256), s.unsqueeze(1)
            res[dec_name]["library_ms"], _ = cuda_ms(
                lambda: torch.mul(rows, sc))
    for name, r in res.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms (torch.mul of the codes by the scales)"
        log(f"phase 8 timing {name} ({n_main} f32 elements): kernel "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
            f"{lib}; wrapper host {r['host_ms']:.4f} ms")
    del x, q, s
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 9

def phase_wire_path(dev, state, batches, wire, profile=False):
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import quantize as qz
    from horovod_tpu_torch.ops import quantize_kernels as QK

    xs, ys = batches
    enc_name, dec_name = [name for name, _, w in CODEC if w == wire]
    barrier = threading.Barrier(NP)
    local, residuals, averaged, wire_bytes = {}, {}, {}, []
    rec = {"on": True}
    records = []

    def train():
        r = hvd.rank()
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16).to(dev)
        model.load_state_dict({k: v if r == 0 else v + 1.0
                               for k, v in state.items()})
        hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
        params = list(model.parameters())
        capture = [p.register_post_accumulate_grad_hook(
            lambda p, i=i: local.setdefault(r, {}).__setitem__(
                i, p.grad.clone())) for i, p in enumerate(params)]
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters(),
            compression=getattr(hvd_torch.Compression, wire))
        x = torch.from_numpy(xs[r]).to(dev)
        y = torch.from_numpy(ys[r]).to(dev)
        eng = hvd.engine()
        if r == 0:
            # record step 1's buckets: the packed rows and their codes as
            # the engine encodes them, and the executor's result
            encode = eng._encode_quantized_rows
            ex = eng.get_process_set(0).executor
            reduce_q = ex.allreduce_quantized

            def encode_spy(rows, logical, w):
                out = encode(rows, logical, w)
                if rec["on"]:
                    records.append({"rows": [t.clone() for t in rows],
                                    "q": out[0], "s": out[1]})
                return out

            def reduce_spy(q_rows, s_rows, op, pre, post, **kw):
                out = reduce_q(q_rows, s_rows, op, pre, post, **kw)
                if rec["on"]:
                    records[-1].update(y=out[0], post=(op, pre, post))
                return out
            eng._encode_quantized_rows = encode_spy
            ex.allreduce_quantized = reduce_spy
        losses, times, counts = [], [], []
        for step in range(STEPS):
            barrier.wait()
            prof = None
            if profile and r == 0 and step == STEPS - 2:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            if step == 0:
                opt.synchronize()
                for h in capture:
                    h.remove()
                averaged[r] = [p.grad.clone() for p in params]
                residuals[r] = [opt._residuals[p].clone() for p in params]
                barrier.wait()
                rec["on"] = False
                with opt.skip_synchronize():
                    opt.step()
            else:
                opt.step()
            losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if prof is not None:
                prof.__exit__(None, None, None)
                log(f"profile: phase 9 {wire}, one steady step of rank 0")
                profile_summary(prof, times[-1])
            barrier.wait()
            if r == 0:
                counts.append((eng.allreduce_buckets, QK.launches[enc_name],
                               QK.launches[dec_name]))
            barrier.wait()
        if r == 0:
            wire_bytes.append((eng.logical_wire_bytes, eng.actual_wire_bytes,
                               eng.quantized_bucket_runs))
        return losses, times, counts, \
            {k: p.detach().clone() for k, p in model.named_parameters()}

    QK.reset_launches()
    results = hvd.run(train, np=NP, device=dev)
    launches = dict(QK.launches)
    torch.cuda.synchronize()

    for r, (losses, *_rest) in enumerate(results):
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"phase 9 {wire}: rank {r} non-finite loss "
                                 f"{losses}")
    diff = [k for k in results[0][3]
            if not torch.equal(results[0][3][k], results[1][3][k])]
    if diff:
        raise AssertionError(f"phase 9 {wire}: ranks' parameters differ "
                             f"after {STEPS} steps: {diff[:5]}")
    # step 1 against the plain codec
    n_params = len(local[0])
    for b, rc in enumerate(records):
        n = rc["rows"][0].numel()
        decoded = []
        for row, q, s in zip(rc["rows"], rc["q"], rc["s"]):
            pq, ps = plain_encode(row, wire)
            if not (torch.equal(q, pq) and torch.equal(s, ps)):
                raise AssertionError(f"phase 9 {wire}: bucket {b}'s codes "
                                     f"differ from the plain codec")
            decoded.append(plain_decode(pq, ps, n, wire))
        op, pre, post = rc["post"]
        want = (decoded[0] + decoded[1]) * (pre * post / NP)
        if not torch.equal(rc["y"], want):
            raise AssertionError(f"phase 9 {wire}: bucket {b}'s "
                                 f"allreduce_quantized result differs from "
                                 f"the plain codec's")
    bad = sum(not torch.equal(residuals[r][i], local[r][i]
                              - qz.plain_fake_quantize_wire(local[r][i],
                                                            wire))
              for r in range(NP) for i in range(n_params))
    if bad:
        raise AssertionError(f"phase 9 {wire}: {bad} error-feedback "
                             f"residuals differ from the plain codec's")
    # launches: per step, one encode and one decode per bucket and rank
    # on the wire, and per parameter and rank for the residual
    counts = results[0][2]
    prev = (0, 0, 0)
    per_step = []
    for step, cur in enumerate(counts):
        nb, n_enc, n_dec = (c - p for c, p in zip(cur, prev))
        per_step.append(nb)
        want = nb * NP + n_params * NP
        if nb < 1 or n_enc != want or n_dec != want:
            raise AssertionError(
                f"phase 9 {wire} step {step}: {nb} buckets but {n_enc} "
                f"encode and {n_dec} decode launches (want {want})")
        prev = cur
    logical, actual, runs = wire_bytes[0]
    ratio = logical / actual
    if ratio <= WIRE_RATIO[wire] or runs != sum(per_step):
        raise AssertionError(f"phase 9 {wire}: wire ratio {ratio} (floor "
                             f"{WIRE_RATIO[wire]}), {runs} quantized runs "
                             f"for {sum(per_step)} buckets")
    exact_sq = err_sq = 0.0
    for i in range(n_params):
        exact = (local[0][i] + local[1][i]) * 0.5
        exact_sq += float(exact.double().norm()) ** 2
        err_sq += float((averaged[0][i] - exact).double().norm()) ** 2
    rel = math.sqrt(err_sq / exact_sq)
    if not rel < WIRE_REL_L2[wire]:
        raise AssertionError(f"phase 9 {wire}: step 1's averaged gradient is "
                             f"{rel} (relative L2) from the exact average")
    step_s = [max(results[r][1][i] for r in range(NP)) for i in range(STEPS)]
    # steady: after the warm-up step, without the profiled step
    timed = [t for i, t in enumerate(step_s)
             if i > 0 and not (profile and i == STEPS - 2)]
    steady = sum(timed) / len(timed)
    log(f"phase 9 {wire}: losses rank0 {results[0][0]}")
    log(f"phase 9 {wire}: buckets per step {per_step}; {enc_name} and "
        f"{dec_name} launches {launches[enc_name]} and {launches[dec_name]} "
        f"(buckets x {NP} + {n_params} x {NP} per step); step 1's "
        f"{len(records)} buckets and {NP * n_params} residuals equal the "
        f"plain codec; parameters of both ranks bit-identical; wire bytes "
        f"logical {logical} / actual {actual} = {ratio:.4f}; step 1's "
        f"averaged gradient is {rel:.6f} (relative L2) from the exact f32 "
        f"average")
    log(f"phase 9 {wire}: step times (s) {[round(t, 4) for t in step_s]}; "
        f"steady {steady * 1e3:.2f} ms/step = {NP * BATCH / steady:.1f} "
        f"img/s")
    del records, local, residuals, averaged, results
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "steady_s": steady, "ratio": ratio,
            "rel_l2": rel}


# ---------------------------------------------------------------------------
# phase 10

def fused_step_shapes(batch=BATCH):
    """(M, K, N, fold) of each fused 1x1 convolution of one ResNet-50
    rank step on ``batch`` images of 224 x 224, in model order: conv1 (on
    the block's input), conv3 (after the 3x3, folding bn2) and, where it
    is not strided, the projection."""
    shapes, h, cin = [], 56, 64
    for i, count in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** i
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            m = batch * h * h
            shapes.append((m, cin, f, False))
            h //= stride
            shapes.append((batch * h * h, f, 4 * f, True))
            if cin != 4 * f and stride == 1:
                shapes.append((m, cin, 4 * f, False))
            cin = 4 * f
    return shapes


def conv_bn_bound_ms(m, k, n, backward):
    """Least time of one B9 or B10 call: bytes (each input read once,
    each output written once) at the HBM rate against the bf16 products'
    flops at the tensor cores' rate.  Forward: x, w, a, b in, y, s1, s2
    out, 2MKN flops; backward: x, w, a, b, y, dy, ds1, ds2 in, dx, dw
    (f32), da, db out, 4MKN flops."""
    if backward:
        nbytes = 2 * (2 * m * k + k * n + 2 * m * n) + 4 * (k * n + 2 * n
                                                            + 4 * k)
        flops = 4 * m * k * n
    else:
        nbytes = 2 * (m * k + k * n + m * n) + 4 * (2 * k + 2 * n)
        flops = 2 * m * k * n
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3


def conv_bn_problem(m, k, n, dtype, dev, seed):
    """Seeded inputs of one B9/B10 call: x (M, K), w (K, N) at LeCun
    scale, a in [0.5, 1.5), b, and cotangents dy, ds1, ds2 of the sizes a
    BN backward hands over."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape, np.float32)
                                 * np.float32(scale))).to(dev)
    x = t(m, k).to(dtype)
    w = t(k, n, scale=k ** -0.5).to(dtype)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, k).astype(np.float32)).to(dev)
    b = t(k, scale=0.5)
    return x, a, b, w, t(m, n, scale=1e-3).to(dtype), t(n, scale=1e-5), \
        t(n, scale=1e-5)


def phase_conv_bn_kernels(dev):
    import torch
    from collections import Counter
    from horovod_tpu_torch.ops import conv_bn as CB

    step = Counter(fused_step_shapes())
    cases, failures, worst = 0, [], {}
    routes = Counter()
    main_err = {"conv1x1_bn_fwd": 0.0, "conv1x1_bn_bwd": 0.0}
    plan = [(m, k, n, fold, dt, True) for (m, k, n, fold) in step
            for dt in (torch.bfloat16, torch.float32)]
    plan += [(m, k, n, fold, dt, False) for (m, k, n) in CONV_BN_ODD
             for fold in (False, True)
             for dt in (torch.bfloat16, torch.float32)]
    plan += [(m, k, n, fold, torch.bfloat16, False)
             for (m, k, n) in CONV_BN_SM90_ODD for fold in (False, True)]
    # reruns: the first sm90 and WMMA cases, and the sm90 route's M tails
    # under the fold, at a step shape and at K 192
    rerun = {0, 1, plan.index((3136, 512, 2048, True, torch.bfloat16, True)),
             plan.index((1000, 192, 320, True, torch.bfloat16, False))}
    for i, (m, k, n, fold, dt, at_step) in enumerate(plan):
        x, a, b, w, dy, ds1, ds2 = conv_bn_problem(m, k, n, dt, dev, i)
        route = CB.route(dt, k, n)
        if route == "sm90":
            lib_route, lib_plan = CB.kernel_plan(dt, m, k, n)
            want = CB.sm90_plan(m, k, n)
            if lib_route != "sm90" or any(lib_plan[f] != v
                                          for f, v in want.items()):
                failures.append(f"M={m} K={k} N={n}: conv_bn.sm90_plan "
                                f"{want} differs from the library's "
                                f"{lib_route} {lib_plan}")
        CB.reset_launches()
        fwd = CB.conv1x1_bn_fwd(x, a, b, w, fold)
        bwd = CB.conv1x1_bn_bwd(x, a, b, w, fwd[0], dy, ds1, ds2, fold)
        torch.cuda.synchronize()
        took = {name for name, v in CB.route_launches.items() if v}
        if took != {f"conv1x1_bn_fwd_{route}", f"conv1x1_bn_bwd_{route}"}:
            failures.append(f"{dt} M={m} K={k} N={n}: routes {took}, want "
                            f"{route}")
        routes[(route, str(dt))] += 1
        errs = CB.fwd_error(x, a, b, w, fold, fwd)
        errs.update(CB.bwd_error(x, a, b, w, fwd[0], dy, ds1, ds2, fold,
                                 bwd))
        cases += 1
        for name, (err, ratio) in errs.items():
            if ratio >= worst.get(dt, (0.0,))[0]:
                worst[dt] = (ratio, f"{name} at M={m} K={k} N={n} "
                                    f"fold={fold}")
            if not ratio <= 1.0:
                failures.append(f"{dt} M={m} K={k} N={n} fold={fold} "
                                f"{name}: max |diff| {err}, {ratio} of its "
                                f"bound")
            if at_step and dt == torch.bfloat16:
                key = "conv1x1_bn_fwd" if name in ("y", "s1", "s2") \
                    else "conv1x1_bn_bwd"
                main_err[key] = max(main_err[key], err)
        if i in rerun:
            # fixed-order sums: a rerun repeats every bit
            again = (*CB.conv1x1_bn_fwd(x, a, b, w, fold),
                     *CB.conv1x1_bn_bwd(x, a, b, w, fwd[0], dy, ds1, ds2,
                                        fold))
            if not all(torch.equal(p, q) for p, q in zip(
                    (*fwd, *bwd), again) if p is not None):
                failures.append(f"{dt} M={m} K={k} N={n} fold={fold}: a "
                                f"rerun differs")
        del x, a, b, w, dy, ds1, ds2, fwd, bwd, errs
    torch.cuda.empty_cache()
    log(f"phase 10: {cases} cases x (B9, B10) against their plain "
        f"versions (the {len(step)} distinct step shapes in bf16 and f32, "
        f"{len(CONV_BN_ODD)} odd shapes x fold x dtype, "
        f"{len(CONV_BN_SM90_ODD)} sm90-route odd shapes x fold in bf16), "
        f"{len(failures)} failures; cases by route {dict(routes)} (every "
        f"route as conv_bn.route says, every sm90 plan as the library's); "
        f"worst error / bound (CB.fwd_error, CB.bwd_error): "
        f"{ {str(k): (round(v[0], 4), v[1]) for k, v in worst.items()} }; max "
        f"|kernel - plain| at the step shapes (bf16): {main_err}; "
        f"{len(rerun)} reruns bit-identical")
    for f in failures[:20]:
        log(f"  MISMATCH {f}")
    if failures:
        raise SystemExit("phase 10 failed: a conv+BN kernel disagrees with "
                         "its plain version")

    # timing: each distinct step shape (bf16), summed over one rank
    # step's launches
    total = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_bytes": 0.0,
                    "bound_ops": 0.0, "bound_ms": 0.0, "matmul_ms": 0.0}
             for name, _ in CONV_BN}
    for i, ((m, k, n, fold), count) in enumerate(sorted(step.items())):
        x, a, b, w, dy, ds1, ds2 = conv_bn_problem(m, k, n, torch.bfloat16,
                                                   dev, 100 + i)
        y = CB.conv1x1_bn_fwd(x, a, b, w, fold)[0]
        xh = (CB._fold_input(x, a, b) if fold else x).contiguous()
        yt = (dy.float() + ds1 + 2.0 * y.float() * ds2).to(torch.bfloat16)
        calls = {
            "conv1x1_bn_fwd": (
                lambda: CB.conv1x1_bn_fwd(x, a, b, w, fold),
                lambda: CB.reference(x, a, b, w, fold),
                lambda: torch.matmul(xh, w), False),
            "conv1x1_bn_bwd": (
                lambda: CB.conv1x1_bn_bwd(x, a, b, w, y, dy, ds1, ds2, fold),
                lambda: CB.plain_bwd(x, a, b, w, y, dy, ds1, ds2, fold),
                lambda: (torch.matmul(yt, w.t()), torch.matmul(xh.t(), yt)),
                True)}
        row = []
        for name, (kern, plain, mm, backward) in calls.items():
            ms, _ = cuda_ms(kern, iters=10)
            plain_ms, _ = cuda_ms(plain, iters=3, warmup=1)
            mm_ms, _ = cuda_ms(mm, iters=10)
            t_mem, t_op = conv_bn_bound_ms(m, k, n, backward)
            tot = total[name]
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["matmul_ms"] += count * mm_ms
            tot["bound_ms"] += count * max(t_mem, t_op)
            tot["bound_bytes"] += count * t_mem
            tot["bound_ops"] += count * t_op
            row.append(f"{name} {ms:.4f} (bound {max(t_mem, t_op):.4f} "
                       f"{'ops' if t_op >= t_mem else 'bytes'}, plain "
                       f"{plain_ms:.4f}, matmul part {mm_ms:.4f})")
        log(f"phase 10 timing M={m} K={k} N={n} fold={fold} x{count} per "
            f"rank step, ms per call: {'; '.join(row)}; dw partials "
            f"{CB.dw_partial_bytes(torch.bfloat16, m, k, n) / 1e6:.2f} MB "
            f"(the WMMA route's "
            f"{CB.dw_partial_bytes(torch.float32, m, k, n) / 1e6:.2f})")
        del x, a, b, w, dy, ds1, ds2, y, xh, yt
    torch.cuda.empty_cache()
    res = {}
    for name, tot in total.items():
        by = "operations" if tot["bound_ops"] >= tot["bound_bytes"] \
            else "bytes"
        res[name] = {"ms": tot["ms"], "plain_ms": tot["plain_ms"],
                     "bound_ms": tot["bound_ms"], "bound_by": by,
                     "max_abs_err": main_err[name], "library_ms": None,
                     "matmul_ms": tot["matmul_ms"]}
        log(f"phase 10 timing {name}, summed over the {FUSED_CONVS} "
            f"launches of one rank step (bf16, 64 images): kernel "
            f"{tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms (bytes "
            f"{tot['bound_bytes']:.4f}, operations {tot['bound_ops']:.4f}; "
            f"{by}), plain {tot['plain_ms']:.4f} ms; the matmul part alone "
            f"(torch.matmul, cuBLAS, bf16) {tot['matmul_ms']:.4f} ms")
    CB.reset_launches()
    return res


def phase_fused_yardstick(dev, state, batches):
    """Phase 11's yardstick: one fused step, one unfused step and one f32
    unfused step (plain torch, TF32 off) on rank 0's images and the same
    weights, with the BN scales drawn away from zero: each block's last
    BN from [0.1, 0.3), every other from [0.5, 1.5).  (numpy_init's zero
    last-BN scales would zero most gradients; unit scales there make the
    random 16-block network chaotic, its bf16 gradients nearly
    uncorrelated with the f32 ones.)"""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.models.resnet import ResNet50, fused_from_unfused

    rng = np.random.default_rng(SEED + 7)

    def scale(k, v):
        if not (k.endswith("weight") and v.dim() == 1):
            return v
        lo, hi = (0.1, 0.3) if ".BatchNorm_2." in k else (0.5, 1.5)
        return torch.from_numpy(rng.uniform(lo, hi, v.shape).astype(
            np.float32))
    ystate = {k: scale(k, v) for k, v in state.items()}
    x = torch.from_numpy(batches[0][0]).to(dev)
    y = torch.from_numpy(batches[1][0]).to(dev)

    def one_step(fused, dtype):
        model = ResNet50(num_classes=1000, dtype=dtype, fused=fused).to(dev)
        model.load_state_dict(fused_from_unfused(ystate) if fused
                              else ystate)
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        grads = {k: p.grad.detach().float() for k, p in
                 model.named_parameters()}
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return float(loss.detach()), grads

    loss_f, g_f = one_step(True, torch.bfloat16)
    loss_u, g_u = one_step(False, torch.bfloat16)
    loss_r, g_r = one_step(False, torch.float32)
    g_u, g_r = fused_from_unfused(g_u), fused_from_unfused(g_r)
    fu, u_r, f_r, sq = {}, {}, {}, [0.0, 0.0, 0.0]
    for k, r in g_r.items():
        gf, gu = g_f[k], g_u[k]
        rn = float(r.norm())
        fu[k] = float((gf - gu).norm()) / max(float(gu.norm()), 1e-30)
        u_r[k] = float((gu - r).norm()) / max(rn, 1e-30)
        f_r[k] = float((gf - r).norm()) / max(rn, 1e-30)
        for j, t in enumerate((gf - r, gu - r, r)):
            sq[j] += float(t.norm()) ** 2
    glob_f, glob_u = math.sqrt(sq[0] / sq[2]), math.sqrt(sq[1] / sq[2])
    bound = {k: max(FUSED_REL_L2, 2 * u_r[k]) for k in fu}
    held = [k for k in fu if k not in FUSED_EXEMPT]
    bad = [k for k in held if fu[k] > bound[k]]
    worst = max(held, key=lambda k: fu[k] / bound[k])
    loss_bound = max(FUSED_LOSS, 2 * abs(loss_u - loss_r))
    log(f"phase 11 yardstick (rank 0's {BATCH} images, BN scales drawn "
        f"away from zero): loss fused {loss_f}, unfused {loss_u}, f32 unfused "
        f"{loss_r} (|fused - unfused| {abs(loss_f - loss_u):.3g}, bound "
        f"{loss_bound:.3g})")
    log(f"phase 11 gradients, relative L2 per tensor: fused vs unfused "
        f"worst {fu[worst]:.4g} ({worst}; bound max({FUSED_REL_L2}, 2 x "
        f"unfused vs f32 = {2 * u_r[worst]:.4g})), median "
        f"{sorted(fu.values())[len(fu) // 2]:.4g}; against f32, all "
        f"parameters: fused {glob_f:.4g}, unfused {glob_u:.4g} (bound fused "
        f"<= {FUSED_GLOBAL} x unfused); worst tensor fused "
        f"{max(f_r.values()):.4g}, unfused {max(u_r.values()):.4g}; not "
        f"held per tensor: " + ", ".join(
            f"{k} fused vs unfused {fu[k]:.4g}, fused vs f32 {f_r[k]:.4g}, "
            f"unfused vs f32 {u_r[k]:.4g}" for k in FUSED_EXEMPT))
    if abs(loss_f - loss_u) > loss_bound or bad \
            or glob_f > FUSED_GLOBAL * glob_u \
            or not all(math.isfinite(v) for v in f_r.values()):
        raise AssertionError(f"phase 11: the fused step disagrees with the "
                             f"unfused step beyond bf16 noise: {bad[:5]}")


# ---------------------------------------------------------------------------
# phase 12

def compiled_run(dev, state, bases, fused, np_, staged, capture,
                 profile=False):
    """6 steps of ResNet-50 through ``make_compiled_train_step`` at
    ``np_`` rank threads: rank r trains on ``step_batch`` of ``bases[r]``
    (or, ``staged``, one rank on all of ``bases`` through
    ``place_batch``).  ``capture=False`` runs the step's function
    uncaptured.  Returns the losses (read after the 6 steps, so that a
    loss a later replay overwrote would show), step times, final
    parameters and statistics, the program, per-step conv+BN launch
    counts, and (captured) one profiled replay's busy share and kernel
    names."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import conv_bn as CB
    from horovod_tpu_torch.parallel.train import sgd

    with torch.device("meta"):
        names = {k for k, _ in ResNet50(num_classes=1000,
                                        fused=fused).named_parameters()}
    params = {k: v for k, v in state.items() if k in names}
    aux = {k: v for k, v in state.items() if k not in names}
    barrier = threading.Barrier(np_)
    out = {"progs": [], "counts": [], "busy": None, "kernels": set()}

    def snapshot():
        return (CB.launches["conv1x1_bn_fwd"], CB.launches["conv1x1_bn_bwd"],
                CB.plain_calls["conv1x1_bn"],
                CB.route_launches["conv1x1_bn_fwd_sm90"],
                CB.route_launches["conv1x1_bn_bwd_sm90"])

    def train():
        r = hvd.rank()
        with torch.device("meta"):
            model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                             fused=fused)

        def loss_fn(p, a, batch):
            x, y = batch
            logits = torch.func.functional_call(model, {**p, **a}, (x,))
            return F.cross_entropy(logits, y), a

        step = hvd.make_compiled_train_step(
            loss_fn, sgd(0.1, momentum=0.9), has_aux=True)
        step.capture = capture
        st = step.init_state(params, aux=aux)
        feed = step.place_batch((torch.cat([x for x, _ in bases]),
                                 torch.cat([y for _, y in bases]))) \
            if staged else None
        losses, times = [], []
        for i in range(STEPS):
            batch = feed if staged else step_batch(*bases[r], i)
            barrier.wait()
            before = snapshot()
            prof = None
            if r == 0 and capture and i == STEPS - 2:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            st, loss = step(st, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            if prof is not None:
                prof.__exit__(None, None, None)
                out["busy"] = profile_summary(prof, times[-1],
                                              tables=profile)
                out["kernels"] = {e.name for e in prof.events()
                                  if e.device_type
                                  == torch.autograd.DeviceType.CUDA}
            barrier.wait()
            if r == 0:
                out["counts"].append(tuple(
                    a - b for a, b in zip(snapshot(), before)))
        out["progs"].append(step._prog)
        if r == 0:
            out["losses"] = [float(v) for v in losses]
            out["times"] = times
            out["params"] = {k: v.detach().clone()
                             for k, v in st["params"].items()}
            out["aux"] = {k: v.clone() for k, v in st["aux"].items()}

    from horovod_tpu_torch.ops import compiled as C
    before = C.program_cache_stats()
    hvd.run(train, np=np_, device=dev)
    out["cache"] = tuple(a - b for a, b in
                         zip(C.program_cache_stats(), before))
    out["prog"] = next(p for p in out.pop("progs") if p is not None)
    return out


def phase_compiled_reducer(dev):
    """Phase 12's reducer check at world size 2 on the card: the 161
    ResNet-50 gradient shapes (25.6 M f32 values a rank) through
    ``CompiledGroupedAllreduce`` grouped (B1 packs and unpacks each rank's
    fusion buffer) and bucketized (``COMPILED_BUCKET_BYTES``, pushed in
    reverse order through ``stream``), on the full-width, bf16, int8 and
    int4 wires (error feedback on the quantized ones), 2 calls each: the
    two legs bit for bit, and the full-width result bit for bit the plain
    average."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as K

    # largest first: the quantized wires close a bucket only where the
    # running element count is a multiple of the 256-element block, which
    # in the model's own order no 4 MB boundary is (one bucket)
    shapes = sorted(resnet50_grad_shapes(), key=math.prod, reverse=True)
    rng = np.random.default_rng(SEED + 12)
    grads = [[torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                               * 1e-2).to(dev) for s in shapes]
             for _ in range(NP)]
    plain = [(a + b) * 0.5 for a, b in zip(*grads)]
    wires = (None, "bf16", "int8", "int4")
    buckets = {}

    def reduce():
        r = hvd.rank()
        g = grads[r]
        for wire in wires:
            ef = wire in ("int8", "int4")
            grouped = hvd.CompiledGroupedAllreduce(
                wire_dtype=wire, error_feedback=ef, name=f"g{wire}",
                bucket_bytes=0)
            bucketed = hvd.CompiledGroupedAllreduce(
                wire_dtype=wire, error_feedback=ef, name=f"b{wire}",
                bucket_bytes=COMPILED_BUCKET_BYTES)
            for call in range(2):
                a = grouped(g)
                st = bucketed.stream(g)
                for i in reversed(range(len(g))):
                    st.push(i, g[i])
                b = st.result()
                buckets[wire] = len(st.buckets)
                if len(st.buckets) < 2:
                    raise AssertionError(
                        f"phase 12 reducer, wire {wire}: one bucket")
                bad = [i for i, (x, y) in enumerate(zip(a, b))
                       if not torch.equal(x, y)]
                if bad:
                    raise AssertionError(
                        f"phase 12 reducer, wire {wire}, call {call}: "
                        f"bucketized differs from grouped at {bad[:5]}")
                if wire is None and not all(
                        torch.equal(x, y) for x, y in zip(a, plain)):
                    raise AssertionError(
                        "phase 12 reducer: the full-width result differs "
                        "from the plain average")
        return True

    K.reset_launches()
    t0 = time.perf_counter()
    hvd.run(reduce, np=NP, device=dev)
    log(f"phase 12 reducer ({card_line()}): {len(shapes)} ResNet-50 "
        f"gradients x {NP} "
        f"ranks, wires {[w or 'f32' for w in wires]}, 2 calls each: "
        f"bucketized ({buckets} buckets of {COMPILED_BUCKET_BYTES} B) "
        f"equals grouped bit for bit, full width equals the plain average "
        f"bit for bit; B1 launches {dict(K.launches)} "
        f"({time.perf_counter() - t0:.2f} s)")
    if not (K.launches["pack_scale_cast"] and K.launches["unpack_scale_cast"]):
        raise AssertionError("phase 12 reducer: B1 was not launched")
    del grads, plain


def phase_compiled(dev, card, state, batches, unfused_ref, fused_ref,
                   plain_s, profile=False):
    """Phase 12: the compiled train step, one CUDA graph a step.  (a)
    bench.py's configuration: ``run(train, np=1)``, BATCH 128 of
    224 x 224 x 3 through ``place_batch``; (b) phase 4's: ``np=2``, 64
    images a rank, a new batch every step; (c) (b) with
    ``ResNet50(fused=True)`` on the same weights, B9/B10 inside the
    graph.  Each part trains 6 steps captured and 6 uncaptured."""
    import torch
    from horovod_tpu_torch.models.resnet import fused_from_unfused
    from horovod_tpu_torch.ops import conv_bn as CB

    t_phase = time.perf_counter()
    phase_compiled_reducer(dev)
    bases = [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
             for x, y in zip(*batches)]
    # bit equality of a graph against the uncaptured run needs each run
    # to be reproducible: cuDNN's deterministic algorithms, in both
    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    parts = (("a", False, 1, True, unfused_ref),
             ("b", False, NP, False, unfused_ref),
             ("c", True, NP, False, fused_ref))
    summary = {}
    try:
        for label, fused, np_, staged, ref in parts:
            sd = fused_from_unfused(state) if fused else state
            got = compiled_run(dev, sd, bases, fused, np_, staged, True,
                               profile=profile)
            want = compiled_run(dev, sd, bases, fused, np_, staged, False)
            prog = got["prog"]
            name = f"phase 12 ({label}, {card})"
            if not all(math.isfinite(v) for v in got["losses"]):
                raise AssertionError(f"{name}: non-finite loss "
                                     f"{got['losses']}")
            if got["cache"][1] != 1 or prog.captures != 1 \
                    or prog.replays != STEPS - 1:
                raise AssertionError(
                    f"{name}: program misses {got['cache'][1]}, captures "
                    f"{prog.captures}, replays {prog.replays} (want 1, 1, "
                    f"{STEPS - 1})")
            diff = [k for k in got["params"]
                    if not torch.equal(got["params"][k], want["params"][k])]
            diff += [k for k in got["aux"]
                     if not torch.equal(got["aux"][k], want["aux"][k])]
            if got["losses"] != want["losses"] or diff:
                raise AssertionError(
                    f"{name}: the captured step differs from the same "
                    f"program uncaptured: losses {got['losses']} vs "
                    f"{want['losses']}; tensors {diff[:5]}")
            steady_i = [i for i in range(2, STEPS) if i != STEPS - 2]
            steady = sum(got["times"][i] for i in steady_i) / len(steady_i)
            img = NP * BATCH
            line = (f"{name}: losses {got['losses']} (= uncaptured, bit for "
                    f"bit, with the final parameters and BN statistics); "
                    f"steady {steady * 1e3:.2f} ms/step = {img / steady:.1f} "
                    f"img/s; x {steady / plain_s:.3f} the plain step; x "
                    f"{steady / ref['steady_s']:.3f} phase "
                    f"{'11' if fused else '4'}; busy share "
                    f"{got['busy']:.3f} of one profiled replay; warm-up + "
                    f"capture {prog.compile_seconds:.2f} s (step times "
                    f"{[round(t, 4) for t in got['times']]}); program "
                    f"cache hits, misses {got['cache']} (uncaptured "
                    f"{want['cache']})")
            log(line)
            if label != "a":
                num = sum(float((got["params"][k].cpu()
                                 - ref["params"][k]).norm()) ** 2
                          for k in got["params"])
                den = sum(float(v.norm()) ** 2
                          for v in ref["params"].values())
                rel = math.sqrt(num / den)
                log(f"{name}: parameters after {STEPS} steps at relative "
                    f"L2 {rel:.3g} from phase {'11' if fused else '4'}'s "
                    f"eager run (bound {COMPILED_REL_L2})")
                if not rel <= COMPILED_REL_L2:
                    raise AssertionError(
                        f"{name}: parameters {rel:.3g} from the eager run")
            if fused:
                want_c = (FUSED_CONVS * NP, FUSED_CONVS * NP, 3 * NP,
                          FUSED_CONVS * NP, FUSED_CONVS * NP)
                counts = got["counts"]
                if counts[1] != want_c or any(any(c) for c in counts[2:]):
                    raise AssertionError(
                        f"{name}: conv+BN launches per step {counts}; the "
                        f"capture must record {want_c} (phase 11's) and a "
                        f"replay launch nothing through the wrappers")
                kern = {k for k in ("conv_bn_fwd_sm90_kernel",
                                    "conv_bn_dx_sm90_kernel",
                                    "conv_bn_dw_sm90_kernel")
                        if any(k in n for n in got["kernels"])}
                if len(kern) != 3:
                    raise AssertionError(
                        f"{name}: the profiled replay ran {sorted(kern)} "
                        f"of the B9/B10 kernels")
                log(f"{name}: B9/B10 recorded at capture: "
                    f"conv1x1_bn_fwd, conv1x1_bn_bwd, plain-path calls, "
                    f"sm90 fwd, sm90 bwd {counts[1]} (phase 11's per "
                    f"step), none launched through the wrappers by the "
                    f"{STEPS - 2} replays; the profiled replay ran "
                    f"{sorted(kern)}; by route "
                    f"{dict(CB.route_launches)}")
            if label == "a":
                log(f"{name}: reference (bench.py:35, 16 Pascal GPUs): "
                    f"{REFERENCE_IMG_S:.2f} img/s per GPU; this card "
                    f"x {img / steady / REFERENCE_IMG_S:.2f}")
            summary[label] = {"steady_s": steady, "busy": got["busy"],
                              "compile_s": prog.compile_seconds,
                              "params": {k: v.cpu() for k, v in
                                         got["params"].items()}}
            del got, want, prog
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = old_det
    log(f"phase 12 ({card}): {time.perf_counter() - t_phase:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# phase 13

def sharded_leg(dev, state, batches, sharded, wire):
    """One leg of phase 13: phase 4's run (full-width ResNet-50, bf16
    compute, 2 rank threads x 64 images, SGD momentum 0.9, phase 4's
    weights and batches, 6 steps) through ``DistributedOptimizer``, dense
    (``sharded=False``) or ``sharded=True`` on ``wire``.  Returns the
    losses, step times, both ranks' final parameters, the gradients the
    update saw at step 1 (the dense leg's averaged ``p.grad`` by name;
    the sharded leg's shard per bucket and rank), the optimizer state
    bytes per rank, the shard plan, the engine's wire counters and
    sharded-update count over the leg, the kernels' launches and the
    peak device memory."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import cuda_kernels as K
    from horovod_tpu_torch.ops import quantize_kernels as QK

    xs, ys = batches
    barrier = threading.Barrier(NP)
    out = {"losses": {}, "times": {}, "params": {}, "step1": {},
           "state_bytes": {}}

    def train():
        r = hvd.rank()
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16).to(dev)
        model.load_state_dict({k: v if r == 0 else v + 1.0
                               for k, v in state.items()})
        hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters(),
            compression=getattr(hvd_torch.Compression, wire),
            sharded=sharded)
        x0 = torch.from_numpy(xs[r]).to(dev)
        y0 = torch.from_numpy(ys[r]).to(dev)
        eng = hvd.engine()
        barrier.wait()
        if r == 0:
            # every count to 0 just before the path is driven
            K.reset_launches()
            QK.reset_launches()
            torch.cuda.reset_peak_memory_stats(dev)
            out["wire0"] = (eng.logical_wire_bytes, eng.actual_wire_bytes,
                            eng.sharded_update_runs)
        barrier.wait()
        losses, times = [], []
        for step in range(STEPS):
            x, y = step_batch(x0, y0, step)
            barrier.wait()
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if step == 0:
                out["step1"][r] = (
                    [t.grad.clone() for _, t in opt._shadow_params]
                    if sharded else {k: p.grad.clone() for k, p in
                                     model.named_parameters()})
        barrier.wait()
        if r == 0:
            out["launches"] = {**K.launches, **QK.launches}
            out["peak"] = torch.cuda.max_memory_allocated(dev)
            out["wire"] = tuple(a - b for a, b in zip(
                (eng.logical_wire_bytes, eng.actual_wire_bytes,
                 eng.sharded_update_runs), out.pop("wire0")))
        if sharded:
            out["state_bytes"][r] = opt._updater.state_bytes["shard"]
            out["plan"] = opt._updater.plan
        else:
            out["state_bytes"][r] = sum(
                v.numel() * v.element_size() for st in opt.state.values()
                for v in st.values() if torch.is_tensor(v))
        out["losses"][r] = losses
        out["times"][r] = times
        out["params"][r] = {k: p.detach().clone()
                            for k, p in model.named_parameters()}

    hvd.run(train, np=NP, device=dev)
    step_s = [max(out["times"][r][i] for r in range(NP))
              for i in range(STEPS)]
    out["steady_s"] = sum(step_s[1:]) / (STEPS - 1)
    out["step_s"] = step_s
    return out


def phase_sharded(dev, card, state, batches):
    """Phase 13: the weight-update sharded main path.  A dense leg, then
    ``DistributedOptimizer(sharded=True)`` on the f32, bf16, int8 and
    int4 wires, all under cuDNN's deterministic algorithms (the legs must
    see the same local gradients).  Gates: on the f32 wire each rank's
    step-1 gradient shard equals the matching slice of the dense leg's
    averaged gradient bit for bit, and the parameters after 6 steps are
    within ``SHARDED_PARAM_BOUND`` of the dense leg's (the line says
    whether they are bit for bit); on every wire both ranks' parameters
    bit-identical and the losses finite; on int8/int4 step 1's shards
    within ``WIRE_REL_L2`` of the exact f32 average and the wire ratio of
    the reducescatter plus the parameter allgather above ``WIRE_RATIO``;
    the optimizer state per rank half the dense leg's to within one f32
    element per bucket; B1 launched on every leg, B2/B3 on int8, B4/B5 on
    int4; one sharded update per rank and step."""
    import torch

    t_phase = time.perf_counter()
    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    legs = (("dense", False, "none"), ("f32", True, "none"),
            ("bf16", True, "bf16"), ("int8", True, "int8"),
            ("int4", True, "int4"))
    res = {}
    try:
        for label, sharded, wire in legs:
            leg = sharded_leg(dev, state, batches, sharded, wire)
            res[label] = leg
            name = f"phase 13 {label} ({card})"
            if not all(math.isfinite(v) for r in range(NP)
                       for v in leg["losses"][r]):
                raise AssertionError(f"{name}: non-finite loss "
                                     f"{leg['losses']}")
            diff = [k for k in leg["params"][0] if not torch.equal(
                leg["params"][0][k], leg["params"][1][k])]
            if diff:
                raise AssertionError(f"{name}: ranks' parameters differ "
                                     f"after {STEPS} steps: {diff[:5]}")
            launches = leg["launches"]
            b1 = sum(launches[k] for k in ("fused_scale_cast",
                                           "pack_scale_cast",
                                           "unpack_scale_cast"))
            if b1 == 0:
                raise AssertionError(f"{name}: B1 was not launched")
            for enc, dec, w in (("quantize_blockwise",
                                 "dequantize_blockwise", "int8"),
                                ("quantize_blockwise_int4",
                                 "dequantize_blockwise_int4", "int4")):
                if wire == w and not (launches[enc] and launches[dec]):
                    raise AssertionError(f"{name}: {enc} {launches[enc]}, "
                                         f"{dec} {launches[dec]} launches")
            dense = res["dense"]
            line = (f"{name}: losses rank0 {leg['losses'][0]}; steady "
                    f"{leg['steady_s'] * 1e3:.2f} ms/step = "
                    f"{NP * BATCH / leg['steady_s']:.1f} img/s (x "
                    f"{leg['steady_s'] / dense['steady_s']:.3f} the dense "
                    f"leg's {dense['steady_s'] * 1e3:.2f} ms); step times "
                    f"(s) {[round(t, 4) for t in leg['step_s']]}; optimizer "
                    f"state per rank {leg['state_bytes']} B; peak device "
                    f"memory {leg['peak']} B; B1 launches {b1}, launches "
                    f"{launches}")
            if sharded:
                plan = leg["plan"]
                logical, actual, runs = leg["wire"]
                if runs != STEPS * NP:
                    raise AssertionError(f"{name}: {runs} sharded updates "
                                         f"for {STEPS} steps x {NP} ranks")
                slack = 4 * len(plan.buckets)
                for r in range(NP):
                    if abs(leg["state_bytes"][r] * NP
                           - dense["state_bytes"][r]) > NP * slack:
                        raise AssertionError(
                            f"{name}: rank {r} holds "
                            f"{leg['state_bytes'][r]} B of optimizer state "
                            f"against the dense leg's "
                            f"{dense['state_bytes'][r]} B")
                num = den = 0.0
                exact = True
                for r in range(NP):
                    for b, g in zip(plan.buckets, leg["step1"][r]):
                        s, e = b.shard_slice(r)
                        want = plan.pack(b, dense["step1"][0])[s:e]
                        exact = exact and torch.equal(g, want)
                        num += float((g.double() - want.double()).norm()) ** 2
                        den += float(want.double().norm()) ** 2
                rel = math.sqrt(num / den)
                worst = max(float((leg["params"][0][k].float()
                                   - dense["params"][0][k].float())
                                  .abs().max()) for k in dense["params"][0])
                bitwise = all(torch.equal(leg["params"][0][k],
                                          dense["params"][0][k])
                              for k in dense["params"][0])
                line += (f"; {len(plan.buckets)} buckets; step 1's shards "
                         f"{'equal' if exact else 'differ from'} the dense "
                         f"leg's averaged gradient (relative L2 {rel:.6g}); "
                         f"parameters after {STEPS} steps "
                         f"{'bit for bit' if bitwise else 'not bit for bit'}"
                         f" the dense leg's, max |delta| {worst:.3g}; wire "
                         f"bytes logical {logical} / actual {actual} = "
                         f"{logical / actual:.4f}")
                if wire == "none" and (not exact
                                       or worst > SHARDED_PARAM_BOUND):
                    raise AssertionError(
                        f"{name}: step 1's shards equal the dense average: "
                        f"{exact}; parameters {worst:.3g} from the dense "
                        f"leg's (bound {SHARDED_PARAM_BOUND})")
                if wire in WIRE_REL_L2 and not (
                        rel < WIRE_REL_L2[wire]
                        and logical / actual >= WIRE_RATIO[wire]):
                    raise AssertionError(
                        f"{name}: step 1's shards at relative L2 {rel:.4g} "
                        f"(bound {WIRE_REL_L2[wire]}), wire ratio "
                        f"{logical / actual:.4f} (floor {WIRE_RATIO[wire]})")
            log(line)
            if label == "f32":
                f32_params = {k: v.cpu() for k, v in
                              leg["params"][0].items()}
            for k in ("params", "step1"):
                if label != "dense":
                    leg.pop(k)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = old_det
    log(f"phase 13 ({card}): {time.perf_counter() - t_phase:.1f} s")
    return {label: {"launches": leg["launches"], "steady_s": leg["steady_s"]}
            for label, leg in res.items()}, f32_params


# ---------------------------------------------------------------------------
# phase 14

def wrapper_counts():
    """Every kernel wrapper's launch count, by kernel name (B1-B10)."""
    from horovod_tpu_torch.ops import conv_bn as CB
    from horovod_tpu_torch.ops import cuda_kernels as K
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.ops import quantize_kernels as QK
    return {**K.launches, **QK.launches, **FA.launches,
            **CB.launches, **CB.route_launches,
            "conv1x1_bn_plain": CB.plain_calls["conv1x1_bn"]}


def sharded_compiled_run(dev, build, feed, capture, bucket_bytes=0,
                         profile=False):
    """6 steps at ``NP`` rank threads of the compiled step ``build()``
    returns as ``(step, state)`` (built per rank inside ``run``), rank r
    training on ``feed(r, i)`` at step i.  ``capture=False`` runs the
    step's function uncaptured.  ``HOROVOD_OVERLAP_BUCKET_BYTES`` is
    ``bucket_bytes`` for the run.  Returns rank 0's losses (read after
    the 6 steps), step times, final parameters, every tensor of the
    optimizer state (all ranks' shards) and the residuals; the momentum
    after step 1 (SGD: the reduced gradient of step 1) and the residuals
    after step 2; each rank's optimizer-state bytes; the wrapper launches
    per step; the program, the program cache's (hits, misses), peak
    device memory and, captured, one profiled replay's busy share and
    kernel names."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import compiled as C

    barrier = threading.Barrier(NP)
    out = {"progs": [], "counts": [], "busy": None, "kernels": set(),
           "state_bytes": {}}

    def snap_tensors(state):
        return [t.detach().clone() for t in C._optimizer_tensors(state)]

    def train():
        r = hvd.rank()
        step, st = build()
        step.capture = capture
        losses, times = [], []
        barrier.wait()
        if r == 0:
            torch.cuda.synchronize()
            out["held"] = torch.cuda.memory_allocated(dev)
            out["peaks"] = []
        for i in range(STEPS):
            batch = feed(r, i)
            barrier.wait()
            if r == 0:
                torch.cuda.reset_peak_memory_stats(dev)
            before = wrapper_counts()
            prof = None
            if r == 0 and capture and i == STEPS - 2:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            st, loss = step(st, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            if prof is not None:
                prof.__exit__(None, None, None)
                out["busy"] = profile_summary(prof, times[-1],
                                              tables=profile)
                out["kernels"] = {e.name for e in prof.events()
                                  if e.device_type
                                  == torch.autograd.DeviceType.CUDA}
            barrier.wait()
            if r == 0:
                out["peaks"].append(torch.cuda.max_memory_allocated(dev))
                after = wrapper_counts()
                out["counts"].append({k: after[k] - before.get(k, 0)
                                      for k in after
                                      if after[k] != before.get(k, 0)})
                so = st["opt_state"]
                if i == 0 and isinstance(so, C.ShardedOptState) \
                        and "momentum_buffer" in so.optimizers[0].state[
                            so.rank_params(0)[0]]:
                    # in the parameters' own element order
                    out["step1"] = {
                        k: step._layout(v.numel(), NP, v.device).natural(
                            v.view(NP, -1))[:st["params"][k].numel()].cpu()
                        for k, v in so.flat("momentum_buffer").items()}
                if i == 1:
                    out["ef2"] = {k: int(v.count_nonzero()) for k, v in
                                  st.get("grad_ef", {}).items()}
            barrier.wait()
        out["progs"].append(step._prog)
        so = st["opt_state"]
        out["state_bytes"][r] = so.state_bytes(r) \
            if isinstance(so, C.ShardedOptState) else sum(
                v.numel() * v.element_size() for s in so.state.values()
                for v in s.values() if torch.is_tensor(v))
        if r == 0:
            out["peak"] = max(out["peaks"])
            out["losses"] = [float(v) for v in losses]
            out["times"] = times
            out["params"] = {k: v.detach().clone()
                             for k, v in st["params"].items()}
            out["opt"] = snap_tensors(st)
            out["ef"] = {k: v.clone() for k, v in
                         st.get("grad_ef", {}).items()}
            out["step"] = step

    old = os.environ.get("HOROVOD_OVERLAP_BUCKET_BYTES")
    os.environ["HOROVOD_OVERLAP_BUCKET_BYTES"] = str(bucket_bytes)
    before = C.program_cache_stats()
    try:
        hvd.run(train, np=NP, device=dev)
    finally:
        if old is None:
            os.environ.pop("HOROVOD_OVERLAP_BUCKET_BYTES")
        else:
            os.environ["HOROVOD_OVERLAP_BUCKET_BYTES"] = old
    out["cache"] = tuple(a - b for a, b in
                         zip(C.program_cache_stats(), before))
    # the program's counts, then the program (and a graph's memory) goes
    prog = next(p for p in out.pop("progs") if p is not None)
    out["captures"] = getattr(prog, "captures", 0)
    out["replays"] = getattr(prog, "replays", 0)
    out["compile_s"] = prog.compile_seconds
    out["step"]._prog = None
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    steady_i = [i for i in range(2, STEPS) if i != STEPS - 2]
    out["steady_s"] = sum(out["times"][i] for i in steady_i) / len(steady_i)
    return out


def resnet_leg(dev, state, bases, fused, sharded, wire):
    """(build, feed) of phase 12 (b)'s configuration: ResNet-50 (bf16
    compute) through ``make_compiled_train_step``, SGD momentum 0.9 at lr
    0.1, rank r on ``step_batch`` of ``bases[r]``."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.parallel.train import sgd

    with torch.device("meta"):
        names = {k for k, _ in ResNet50(num_classes=1000,
                                        fused=fused).named_parameters()}
    params = {k: v for k, v in state.items() if k in names}
    aux = {k: v for k, v in state.items() if k not in names}

    def build():
        with torch.device("meta"):
            model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                             fused=fused)

        def loss_fn(p, a, batch):
            x, y = batch
            logits = torch.func.functional_call(model, {**p, **a}, (x,))
            return F.cross_entropy(logits, y), a

        step = hvd.make_compiled_train_step(
            loss_fn, sgd(0.1, momentum=0.9), has_aux=True, sharded=sharded,
            wire_dtype=wire)
        return step, step.init_state(params, aux=aux)

    return build, lambda r, i: step_batch(*bases[r], i)


def lm_leg(dev, weights, tokens, sharded, wire):
    """(build, feed) of the full-width 436M LM (bf16, flash attention)
    through ``make_compiled_train_step``, AdamW 1e-3 (the JAX package's
    ``lm_mfu_bench.py:68-98`` without fused CE or remat), rank r on its
    own ``tokens[r]``."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, lm_loss)
    from horovod_tpu_torch.ops.flash_attention import flash_attention
    from horovod_tpu_torch.parallel.train import adamw

    cfg = TransformerConfig(dtype=torch.bfloat16, **LM)

    def build():
        with torch.device("meta"):
            model = TransformerLM(cfg, attention_fn=flash_attention)

        def loss_fn(p, t):
            logits = torch.func.functional_call(model, p, (t,))
            return lm_loss(logits[:, :-1], t[:, 1:])

        step = hvd.make_compiled_train_step(
            loss_fn, adamw(1e-3), sharded=sharded, wire_dtype=wire)
        return step, step.init_state(weights)

    return build, lambda r, i: tokens[r]


def _same(a, b):
    """Names (or indices) where two dicts (lists) of tensors differ."""
    if isinstance(a, dict):
        return [k for k in a if not torch_equal(a[k], b[k])]
    return [i for i, (x, y) in enumerate(zip(a, b)) if not torch_equal(x, y)]


def torch_equal(x, y):
    import torch
    return x.shape == y.shape and torch.equal(x.to(y.device), y)


def max_delta(a, b):
    return max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max())
               for k in a)


def phase_compiled_sharded(dev, card, state, batches, refs, lm_weights,
                           profile=False):
    """Phase 14: the weight-update-sharded compiled step, one CUDA graph a
    step, cuDNN on deterministic algorithms.  (a) phase 12 (b)'s ResNet-50
    configuration ``sharded=True`` on the f32, bf16, int8 and int4 wires;
    (b) the f32 and int8 legs again with 4 MiB segments; (c)
    ``ResNet50(fused=True)`` on the f32 wire; (d) the 436M LM, a dense
    compiled leg, then ``sharded=True`` on f32 and int8.  Each leg trains
    6 steps captured and 6 uncaptured.  ``refs``: phase 12 (b)'s and
    (c)'s dense compiled parameters and steady times and phase 13's eager
    sharded f32 parameters."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    bases = [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
             for x, y in zip(*batches)]
    tokens = [torch.from_numpy(np.random.default_rng(SEED + 14 + r).integers(
        0, LM["vocab_size"], size=(LM_BATCH, LM["max_seq_len"]))).to(dev)
        for r in range(NP)]
    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    res, summary = {}, {}
    try:
        for label, kind, fused, sharded, wire, bb in SHARDED_LEGS:
            if kind == "resnet":
                from horovod_tpu_torch.models.resnet import fused_from_unfused
                sd = fused_from_unfused(state) if fused else state
                build, feed = resnet_leg(dev, sd, bases, fused, sharded,
                                         wire)
            else:
                build, feed = lm_leg(dev, lm_weights, tokens, sharded, wire)
            got = sharded_compiled_run(dev, build, feed, True, bb,
                                       profile=profile)
            want = sharded_compiled_run(dev, build, feed, False, bb)
            name = f"phase 14 ({label}, {card})"
            if not all(math.isfinite(v) for v in got["losses"]):
                raise AssertionError(f"{name}: non-finite loss "
                                     f"{got['losses']}")
            if got["cache"][1] != 1 or got["captures"] != 1 \
                    or got["replays"] != STEPS - 1:
                raise AssertionError(
                    f"{name}: program misses {got['cache'][1]}, captures "
                    f"{got['captures']}, replays {got['replays']} (want 1, "
                    f"1, {STEPS - 1})")
            diff = _same(got["params"], want["params"])
            odiff = _same(got["opt"], want["opt"])
            ediff = _same(got["ef"], want["ef"])
            if got["losses"] != want["losses"] or diff or odiff or ediff:
                raise AssertionError(
                    f"{name}: the captured step differs from the same "
                    f"program uncaptured: losses {got['losses']} vs "
                    f"{want['losses']}; params {diff[:5]}; optimizer "
                    f"tensors {odiff[:5]}; residuals {ediff[:5]}")
            step = got["step"]
            n_img = NP * BATCH if kind == "resnet" \
                else NP * LM_BATCH * LM["max_seq_len"]
            unit = "img/s" if kind == "resnet" else "tok/s"
            if kind == "resnet":
                dense_s = refs["c" if fused else "b"]["steady_s"]
                dense_label = f"phase 12 ({'c' if fused else 'b'})"
            elif label == "d dense":
                dense_s, dense_label = got["steady_s"], "itself"
            else:
                dense_s, dense_label = res["d dense"]["steady_s"], \
                    "the dense LM leg"
            line = (f"{name}: losses {got['losses']} (= uncaptured, bit "
                    f"for bit, with the parameters, {len(got['opt'])} "
                    f"optimizer tensors of both ranks and "
                    f"{len(got['ef'])} residuals); steady "
                    f"{got['steady_s'] * 1e3:.2f} ms/step = "
                    f"{n_img / got['steady_s']:.1f} {unit}; x "
                    f"{got['steady_s'] / dense_s:.3f} {dense_label} "
                    f"({dense_s * 1e3:.2f} ms); busy share "
                    f"{got['busy']:.3f} of one profiled replay; warm-up + "
                    f"capture {got['compile_s']:.2f} s; step times "
                    f"{[round(t, 4) for t in got['times']]}; program cache "
                    f"hits, misses {got['cache']}; optimizer state per "
                    f"rank {got['state_bytes']} B; peak device memory "
                    f"{got['peak']} B (held at the start {got['held']} B; "
                    f"per step {got['peaks']})")
            # state per rank: the dense state / R, to within the padding
            if sharded:
                so_names = list(got["params"])
                itemsize = {"resnet": 4, "lm": 8}[kind]
                train = [k for k in so_names
                         if got["params"][k].is_floating_point()]
                n_all = sum(got["params"][k].numel() for k in train)
                pad_all = sum(step._shard_pad(got["params"][k].numel(), NP)
                              for k in train)
                dense_b = itemsize * n_all
                extra = 0 if kind == "resnet" else 4 * len(train)
                for r in range(NP):
                    b = got["state_bytes"][r]
                    if not (dense_b / NP <= b - extra
                            <= itemsize * pad_all / NP):
                        raise AssertionError(
                            f"{name}: rank {r} holds {b} B of optimizer "
                            f"state; dense / {NP} = {dense_b / NP:.0f} B, "
                            f"padded {itemsize * pad_all / NP:.0f} B")
                line += (f"; dense state {dense_b} B, / {NP} = "
                         f"{dense_b // NP} B, padding "
                         f"{itemsize * (pad_all - n_all) // NP} B a rank")
            # against the dense steps
            if label == "a f32":
                for ref_name, ref in (("phase 12 (b)", refs["b"]["params"]),
                                      ("phase 13 f32", refs["13"])):
                    d = max_delta(got["params"], ref)
                    bit = not _same(got["params"], ref)
                    line += (f"; parameters {'bit for bit' if bit else 'not bit for bit'} "
                             f"{ref_name}'s, max |delta| {d:.3g}")
                    if d > SHARDED_PARAM_BOUND:
                        raise AssertionError(
                            f"{name}: parameters {d:.3g} from {ref_name}'s "
                            f"(bound {SHARDED_PARAM_BOUND})")
            if label == "c f32":
                d = max_delta(got["params"], refs["c"]["params"])
                line += f"; parameters max |delta| {d:.3g} from phase 12 (c)"
            if label == "d f32":
                ref = res["d dense"]["params"]
                d = max_delta(got["params"], ref)
                bit = not _same(got["params"], ref)
                line += (f"; parameters {'bit for bit' if bit else 'not bit for bit'} "
                         f"the dense LM leg's, max |delta| {d:.3g}")
                if d > SHARDED_PARAM_BOUND:
                    raise AssertionError(
                        f"{name}: parameters {d:.3g} from the dense LM "
                        f"leg's (bound {SHARDED_PARAM_BOUND})")
            # segmented against unsegmented
            if label.startswith("b "):
                twin = res["a " + label[2:]]
                diff = _same(got["params"], twin["params"]) \
                    + _same(got["ef"], twin["ef"])
                segs = max(len(step._layout(v.numel(), NP, dev).segs)
                           for v in got["params"].values())
                if diff or got["losses"] != twin["losses"] or segs < 2:
                    raise AssertionError(
                        f"{name}: {COMPILED_BUCKET_BYTES} B segments (up to {segs} "
                        f"a leaf) differ from the unsegmented leg: "
                        f"{diff[:5]}")
                line += (f"; {COMPILED_BUCKET_BYTES} B segments (up to {segs} a "
                         f"leaf) bit for bit the unsegmented leg")
            # the wire's error and its residual
            if wire in ("int8", "int4") and kind == "resnet":
                exact = res["a f32"]["step1"]
                num = sum(float((got["step1"][k] - exact[k]).double()
                                .norm()) ** 2 for k in exact)
                den = sum(float(v.double().norm()) ** 2
                          for v in exact.values())
                rel = math.sqrt(num / den)
                nz = sum(got["ef2"].values())
                line += (f"; step 1's reduced shards at relative L2 "
                         f"{rel:.4g} from the exact f32 average (bound "
                         f"{WIRE_REL_L2[wire]}); step 2's residual non-zero "
                         f"at {nz} elements")
                if not rel < WIRE_REL_L2[wire] or nz == 0:
                    raise AssertionError(f"{name}: wire error {rel:.4g}, "
                                         f"{nz} non-zero residuals")
            if wire == "int8" and kind == "lm":
                nz = sum(got["ef2"].values())
                line += f"; step 2's residual non-zero at {nz} elements"
                if nz == 0:
                    raise AssertionError(f"{name}: the residual is zero")
            # the kernels inside the graph
            cap = got["counts"][1]
            if fused or kind == "lm":
                if kind == "lm":
                    want_c = {k: LM["n_layers"] * NP for k, _ in FLASH}
                    kern = {FLASH_KERNEL[k] for k, _ in FLASH}
                else:
                    want_c = {"conv1x1_bn_fwd": FUSED_CONVS * NP,
                              "conv1x1_bn_bwd": FUSED_CONVS * NP,
                              "conv1x1_bn_fwd_sm90": FUSED_CONVS * NP,
                              "conv1x1_bn_bwd_sm90": FUSED_CONVS * NP,
                              "conv1x1_bn_plain": 3 * NP}
                    kern = {"conv_bn_fwd_sm90_kernel",
                            "conv_bn_dx_sm90_kernel",
                            "conv_bn_dw_sm90_kernel"}
                seen = {k for k in kern if any(k in n for n in got["kernels"])}
                if any(cap.get(k, 0) != v for k, v in want_c.items()) \
                        or any(c for c in got["counts"][2:]) \
                        or seen != kern:
                    raise AssertionError(
                        f"{name}: launches at capture {cap} (want "
                        f"{want_c}), through the wrappers at the replays "
                        f"{got['counts'][2:]}; the profiled replay ran "
                        f"{sorted(seen)} of {sorted(kern)}")
                line += (f"; recorded at capture {cap}, none through the "
                         f"wrappers at the {STEPS - 2} replays; the profiled "
                         f"replay ran {sorted(seen)}")
            log(line)
            summary[label] = {"steady_s": got["steady_s"], "capture": cap,
                              "peak": got["peak"],
                              "state_bytes": [got["state_bytes"][r]
                                              for r in range(NP)]}
            if label == "a int8":
                # phase 17 (i) holds the process-group step to it
                summary[label]["params"] = {
                    k: v.cpu() for k, v in got["params"].items()}
            keep = {"steady_s": got["steady_s"], "losses": got["losses"]}
            if label in ("a f32", "a int8", "d dense"):
                keep.update(params=got["params"], ef=got["ef"],
                            step1=got.get("step1"))
            res[label] = keep
            del got, want, step
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = old_det
    log(f"phase 14 ({card}): {time.perf_counter() - t_phase:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# phase 15

def moe_gate(dev, tokens):
    """Phase 7's rule on the MoE at full width and MOE_GATE_LAYERS deep:
    one flash step and one dense step (bf16) against the f32 gradients of
    the dense model in plain torch on the same weights and tokens."""
    import torch
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, lm_loss, numpy_init)
    from horovod_tpu_torch.parallel import make_lm_train_step

    kw = dict(MOE, n_layers=MOE_GATE_LAYERS)
    cfg = TransformerConfig(dtype=torch.bfloat16, **kw)
    with torch.device("meta"):
        shell = TransformerLM(cfg)
    weights = numpy_init(shell, SEED + 15)
    grads, loss = {}, {}
    for impl in ("flash", "ring"):
        init, step = make_lm_train_step(cfg, attention_impl=impl,
                                        device=dev)
        state = init(weights)
        state, l_ = step(state, tokens)
        loss[impl] = float(l_)
        grads[impl] = {n: p.grad.detach().float() for n, p in
                       state["model"].named_parameters()}
        del state
    with torch.device("meta"):
        ref = TransformerLM(TransformerConfig(dtype=torch.float32, **kw))
    ref.to_empty(device=dev)
    ref.load_state_dict(weights)
    loss_r = lm_loss(ref(tokens)[:, :-1], tokens[:, 1:])
    loss_r.backward()
    fd, d_ref, sq = {}, {}, [0.0, 0.0, 0.0]
    for n, p in ref.named_parameters():
        r, gf, gd = p.grad, grads["flash"][n], grads["ring"][n]
        rn = max(float(r.norm()), 1e-30)
        fd[n] = float((gf - gd).norm()) / max(float(gd.norm()), 1e-30)
        d_ref[n] = float((gd - r).norm()) / rn
        for j, x in enumerate((gf - r, gd - r, r)):
            sq[j] += float(x.norm()) ** 2
    glob_f, glob_d = math.sqrt(sq[0] / sq[2]), math.sqrt(sq[1] / sq[2])
    bad = [n for n in fd if fd[n] > max(2e-2, 2 * d_ref[n])]
    worst = max(fd, key=lambda n: fd[n] / max(2e-2, 2 * d_ref[n]))
    log(f"phase 15 (a) gate, {MOE_GATE_LAYERS} layers at full width: loss "
        f"flash {loss['flash']} dense {loss['ring']} f32 "
        f"{float(loss_r.detach())}; gradients flash vs dense worst "
        f"{fd[worst]:.4g} ({worst}; bound max(2e-2, 2 x dense vs f32 = "
        f"{2 * d_ref[worst]:.4g})), median "
        f"{sorted(fd.values())[len(fd) // 2]:.4g}; against f32, all "
        f"parameters: flash {glob_f:.4g}, dense {glob_d:.4g} (bound flash "
        f"<= 1.25 x dense)")
    if not abs(loss["flash"] - loss["ring"]) <= 2e-3 or bad \
            or not glob_f <= 1.25 * glob_d:
        raise AssertionError(f"phase 15 (a): the flash MoE step disagrees "
                             f"with the dense step beyond bf16 noise: "
                             f"{bad[:5]}")
    del ref, grads, weights
    gc.collect()
    torch.cuda.empty_cache()


def moe_flash_check(dev, qkv):
    """B6-B8 against their plain versions (FA.error_ratio, phase 6's rule)
    on the q, k, v that layer 0 of the MoE LM handed its attention, with
    a random output gradient."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as FA

    B, S, H, D = qkv[0].shape
    q, k, v = (t.permute(0, 2, 1, 3).reshape(B * H, S, D).contiguous()
               for t in qkv)
    g = torch.Generator(device="cpu").manual_seed(SEED + 16)
    do = torch.randn(B * H, S, D, generator=g).to(dev, q.dtype)
    out, lse = FA.flash_fwd(q, k, v)
    r_out, r_lse = FA.plain_flash_fwd(q, k, v)
    delta = (do.float() * r_out.float()).sum(-1)
    dq = FA.flash_bwd_dq(q, k, v, do, r_lse, delta)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, r_lse, delta)
    r_dq = FA.plain_flash_bwd_dq(q, k, v, do, r_lse, delta)
    r_dk, r_dv = FA.plain_flash_bwd_dkv(q, k, v, do, r_lse, delta)
    sc = FA.plain_error_scales(q, k, v, do, r_out, r_lse, delta)
    ratios = {}
    for name, got, want, t_dtype, rss, noise in (
            ("out", out, r_out, q.dtype, sc["rss_out"], None),
            ("lse", lse, r_lse, torch.float32, None, None),
            ("dq", dq, r_dq, q.dtype, sc["rss_dq"], sc["noise_dq"]),
            ("dk", dk, r_dk, q.dtype, sc["rss_dk"], sc["noise_dk"]),
            ("dv", dv, r_dv, q.dtype, sc["rss_dv"], None)):
        ratios[name] = FA.error_ratio(got, want, t_dtype, rss, noise)[1]
    log(f"phase 15 (a): B6-B8 on layer 0's attention inputs (BH {B * H}, "
        f"S {S}, D {D}, {q.dtype}) against their plain versions, error / "
        f"bound {ratios}")
    if not all(r <= 1.0 for r in ratios.values()):
        raise AssertionError(f"phase 15 (a): a flash kernel disagrees with "
                             f"its plain version on the MoE's inputs: "
                             f"{ratios}")


def phase_moe_lm(dev, lm, profile=False):
    """Phase 15 (a): the MoE LM (MOE) through make_lm_train_step(
    attention_impl="flash") for STEPS steps on phase 7's tokens."""
    import torch
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, dense_causal_attention, lm_loss,
        numpy_init)
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.parallel import make_lm_train_step

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = TransformerConfig(dtype=torch.bfloat16, **MOE)
    tok = torch.from_numpy(lm["tokens"]).to(dev)
    moe_gate(dev, tok)

    with torch.device("meta"):
        shell = TransformerLM(cfg)
    t0 = time.perf_counter()
    weights = numpy_init(shell, SEED + 14)
    init_s = time.perf_counter() - t0
    del shell
    init, step = make_lm_train_step(cfg, attention_impl="flash", device=dev)
    state = init(weights)
    del weights
    model = state["model"]
    n_params = sum(p.numel() for p in model.parameters())
    n_expert = sum(p.numel() for n, p in model.named_parameters()
                   if ".moe.w" in n)
    # the full-depth loss of the dense model on the same weights (no
    # gradient: one layer's scores at a time), before the first step
    flash_fn = model.layers[0].attn.attention_fn
    with torch.no_grad():
        for blk in model.layers:
            blk.attn.attention_fn = dense_causal_attention
        dense_loss = float(lm_loss(model(tok)[:, :-1], tok[:, 1:]))
        for blk in model.layers:
            blk.attn.attention_fn = flash_fn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launches()
    losses, times, drops, busy = [], [], [], None
    for i in range(STEPS):
        prof = None
        if i == STEPS - 2:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        state, loss = step(state, tok)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if prof is not None:
            prof.__exit__(None, None, None)
            log("profile: phase 15 (a), one steady step of the MoE LM")
            busy = profile_summary(prof, times[-1], tables=profile)
        losses.append(float(loss))
        drops.append(sum(int(b.moe.moe_dropped) for b in model.layers))
    launches = {n: FA.launches[n] for n, _ in FLASH}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 15 (a): non-finite loss {losses}")
    if any(launches[n] != STEPS * cfg.n_layers for n in launches):
        raise AssertionError(f"phase 15 (a): flash launches {launches}, "
                             f"want {STEPS * cfg.n_layers} of each")
    if not abs(dense_loss - losses[0]) <= 2e-3:
        raise AssertionError(f"phase 15 (a): step 1's flash loss "
                             f"{losses[0]} and the dense model's "
                             f"{dense_loss} differ by more than 2e-3")
    timed = [t for i, t in enumerate(times) if i > 0 and i != STEPS - 2]
    steady = sum(timed) / len(timed)
    n_tok = LM_BATCH * cfg.max_seq_len
    tok_s = n_tok / steady
    dense_cfg = TransformerConfig(dtype=torch.bfloat16, **LM)
    tflops = lm_flops_per_token(dense_cfg) * tok_s / 1e12
    cap = -(-int(cfg.moe_capacity_factor * n_tok * cfg.expert_top_k)
            // cfg.num_experts)
    gap = abs(losses[-1] - lm["losses"][-1]) / lm["losses"][-1]
    log(f"phase 15 (a): MoE LM {n_params} parameters ({n_expert} in "
        f"experts; numpy init {init_s:.1f} s), {cfg.num_experts} experts "
        f"top {cfg.expert_top_k}, capacity {cap} slots an expert; held "
        f"{held / 1e9:.2f} GB at the phase's start")
    log(f"phase 15 (a): losses {losses}; step 1's loss on the dense model "
        f"{dense_loss} (|diff| {abs(dense_loss - losses[0]):.3g}, bound "
        f"2e-3); dropped choices per step {drops} of "
        f"{n_tok * cfg.expert_top_k * cfg.n_layers}; flash launches "
        f"{launches}")
    log(f"phase 15 (a): step times (s) {[round(t, 4) for t in times]}; "
        f"steady {steady * 1e3:.2f} ms/step = {tok_s:.1f} tok/s = "
        f"{tflops:.1f} model TFLOP/s at the dense twin's "
        f"{lm_flops_per_token(dense_cfg) / 1e9:.3f} GFLOP/token (the "
        f"experts also multiply the {cfg.moe_capacity_factor}x capacity "
        f"padding); busy share {busy:.3f}; peak memory {peak / 1e9:.2f} GB")
    log(f"phase 15 (a): x {steady / lm['steady_s']:.3f} phase 7's dense "
        f"step ({lm['steady_s'] * 1e3:.2f} ms); loss after {STEPS} steps "
        f"{losses[-1]} vs phase 7's {lm['losses'][-1]} on the same "
        f"tokens: gap {gap:.4f} (the repo's bar for a trained pair, "
        f"docs/parallelism.md: <= 0.01; a finding, not a gate)")
    # layer 0 and the embedding go on to (b); the rest is released
    keep = {"embed": model.embed.detach().clone(),
            "block": model.layers[0], "angles": model.angles(dev)}
    qkv = []

    def capture(q, k, v, **kw):
        qkv.extend(t.detach() for t in (q, k, v))
        return flash_fn(q, k, v, **kw)
    with torch.no_grad():
        keep["block"].attn.attention_fn = capture
        model(tok)
        keep["block"].attn.attention_fn = flash_fn
    moe_flash_check(dev, qkv)
    del qkv
    for p in keep["block"].parameters():
        p.grad = None
    del state, model, loss
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "keep": keep}


def phase_moe_wire(dev, moe):
    """Phase 15 (b): each of A2A_NP rank threads routes its own tokens
    through layer 0's router and moe_dispatch, and the (E, C, M) slots
    cross hvd.alltoall on every wire, CompiledAlltoall on int8/int4, and
    HorovodAlltoall forward and backward in an ep = 2 FFN."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import compiled as CM
    from horovod_tpu_torch.ops import quantize as qz
    from horovod_tpu_torch.ops import quantize_kernels as QK
    from horovod_tpu_torch.parallel import moe as M

    blk, embed = moe["keep"]["block"], moe["keep"]["embed"]
    angles = moe["keep"]["angles"]
    E, K, cf = MOE["num_experts"], MOE["expert_top_k"], \
        MOE["moe_capacity_factor"]
    rng = np.random.default_rng(SEED + 17)
    toks = [torch.from_numpy(rng.integers(0, MOE["vocab_size"],
                                          size=(LM_BATCH, LM["max_seq_len"])))
            .to(dev) for _ in range(A2A_NP)]
    experts = [getattr(blk.moe, n).detach().to(torch.bfloat16)
               for n in ("wi_gate", "wi_up", "wo")]
    router = blk.moe.router.weight.detach().t().contiguous()    # (M, E)
    E_loc = E // A2A_NP
    barrier = threading.Barrier(A2A_NP)
    failures, report = [], {}

    def plain_round(x, wire):
        enc = qz.plain_quantize_blockwise_int4 if wire == "int4" \
            else qz.plain_quantize_blockwise
        dec = qz.plain_dequantize_blockwise_int4 if wire == "int4" \
            else qz.plain_dequantize_blockwise
        q, s = enc(x)
        return dec(q, s, x.numel())

    def hidden(r):
        with torch.no_grad():
            x = embed[toks[r]].to(torch.bfloat16)
            x = x + blk.attn(blk.ln_attn(x), angles[:x.shape[1]])
            return blk.ln_mlp(x).reshape(-1, x.shape[-1])

    def fn():
        r = hvd.rank()
        eng = basics.engine()
        h = hidden(r)
        w, idx = M.top_k_gating(h.float() @ router, K)
        cap = M.expert_capacity(h.shape[0], E, K, cf)
        pos, keep, dropped = M.make_dispatch_plan(idx, E, cap)
        slots = M.moe_dispatch(h, idx, pos, keep, E, cap)
        send = slots.float().reshape(A2A_NP, -1)      # f32, by destination
        barrier.wait()
        # the same permutation in plain torch: what the wire must deliver
        shared[r] = send
        barrier.wait()
        plain = torch.cat([shared[src][r] for src in range(A2A_NP)])
        out = {}
        for wire in A2A_WIRES:
            for ef in ((True, False) if wire in ("int8", "int4")
                       else (True,)):
                tag = f"{wire or 'f32'}{'' if ef else ' stateless'}"
                before = (eng.logical_wire_bytes, eng.actual_wire_bytes)
                prev_res = None
                got, ms = [], []
                for call in range(2 if ef and wire in ("int8", "int4")
                                  else 1):
                    barrier.wait()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    y, recv = hvd.alltoall(send, wire_dtype=wire,
                                           error_feedback=ef,
                                           name=f"moe.{tag}.{call}")
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    res = eng._a2a_ef.get((0, r))
                    got.append((y, res))
                    barrier.wait()
                    if wire in ("int8", "int4"):
                        padded = send.reshape(-1) if prev_res is None \
                            else send.reshape(-1) + prev_res
                        rt = plain_round(padded, wire)
                        shared[r] = rt.view(A2A_NP, -1)
                        barrier.wait()
                        want = torch.cat([shared[src][r]
                                          for src in range(A2A_NP)])
                        barrier.wait()
                        if not torch.equal(y.reshape(-1), want):
                            failures.append(f"rank {r} {tag} call {call}: "
                                            f"received slots differ from "
                                            f"the plain codec's decode")
                        if ef and not torch.equal(res, padded - rt):
                            failures.append(f"rank {r} {tag} call {call}: "
                                            f"residual differs")
                        if not ef and res is not None:
                            failures.append(f"rank {r} {tag}: a stateless "
                                            f"exchange kept a residual")
                        prev_res = padded - rt
                    elif wire == "bf16":
                        if not torch.equal(
                                y.reshape(-1),
                                plain.to(torch.bfloat16).float()):
                            failures.append(f"rank {r} bf16 wire differs")
                    elif not torch.equal(y.reshape(-1), plain):
                        failures.append(f"rank {r} f32 wire is not the "
                                        f"plain permutation")
                    if recv.tolist() != [1] * A2A_NP:
                        failures.append(f"rank {r} {tag}: received splits "
                                        f"{recv.tolist()}")
                lg = eng.logical_wire_bytes - before[0]
                ac = eng.actual_wire_bytes - before[1]
                out[tag] = {"ms": ms, "ratio": lg / max(ac, 1)}
        # CompiledAlltoall, error feedback on, two calls
        for wire in ("int8", "int4"):
            a2a = hvd.CompiledAlltoall(name="moe.dispatch", wire_dtype=wire,
                                       error_feedback=True)
            prev_res, ms = None, []
            for call in range(2):
                barrier.wait()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = a2a(send)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                padded = send.reshape(-1) if prev_res is None \
                    else send.reshape(-1) + prev_res
                rt = plain_round(padded, wire)
                shared[r] = rt.view(A2A_NP, -1)
                barrier.wait()
                want = torch.cat([shared[src][r] for src in range(A2A_NP)])
                barrier.wait()
                key = [k for k in a2a._ef_keys][0]
                if not torch.equal(y.reshape(-1), want) \
                        or not torch.equal(CM._A2A_EF[key], padded - rt):
                    failures.append(f"rank {r} CompiledAlltoall {wire} call "
                                    f"{call} differs from the plain codec")
                digests[f"{wire}.{call}.{r}"] = _digest(y)
                prev_res = padded - rt
            out[f"compiled {wire}"] = {"ms": ms,
                                       "ratio": a2a.last_logical_bytes
                                       / a2a.last_wire_bytes}
            a2a.reset_wire_state()
        shared[r] = None
        # what phase 17 (j) sends across processes, and the f32 exchange
        # it must deliver (the plain permutation)
        sends[r] = send.cpu()
        digests[f"f32.0.{r}"] = _digest(plain)
        # the ep = 2 FFN: dispatch and combine through HorovodAlltoall
        lo = r * E_loc
        loc = [t[lo:lo + E_loc] for t in experts]
        x = h.detach().clone().requires_grad_()
        rw = router.clone().requires_grad_()
        w, idx = M.top_k_gating(x.float() @ rw, K)
        pos, keep, _ = M.make_dispatch_plan(idx, E, cap)
        sl = M.moe_dispatch(x, idx, pos, keep, E, cap)
        recv = hvd_torch.alltoall(sl.reshape(A2A_NP, E_loc, cap, -1))
        mine = recv.transpose(0, 1).reshape(E_loc, A2A_NP * cap, -1)
        y_loc = M.expert_swiglu(mine, *loc)
        back = y_loc.reshape(E_loc, A2A_NP, cap, -1).transpose(0, 1)
        ye = hvd_torch.alltoall(back.contiguous()).reshape(E, cap, -1)
        y = M.moe_combine(ye, idx, pos, keep, w).to(x.dtype)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(r)
                        ).to(dev, y.dtype)
        # each rank's backward on its own thread: autograd's one worker
        # thread for the card would run one rank's blocking alltoall while
        # the other rank's waits behind it
        with torch.autograd.set_multithreading_enabled(False):
            (y.float() * g.float()).sum().backward()
        x_ref = h.detach().clone().requires_grad_()
        rw_ref = router.clone().requires_grad_()
        y_ref, aux = M.capacity_moe_apply(x_ref, rw_ref, *experts, topk=K,
                                          capacity_factor=cf)
        (y_ref.float() * g.float()).sum().backward()

        def rel(a, b):
            a, b = a.detach(), b.detach()
            return float((a.float() - b.float()).norm()
                         / b.float().norm().clamp_min(1e-30))
        out["ep2"] = {"y": rel(y, y_ref), "y_bits": torch.equal(y, y_ref),
                      "dx": rel(x.grad, x_ref.grad),
                      "drouter": rel(rw.grad, rw_ref.grad),
                      "finite": [bool(torch.isfinite(t).all()) for t in (
                          y, y_ref, x.grad, x_ref.grad, rw.grad,
                          rw_ref.grad)],
                      "dropped": int(dropped), "cap": cap}
        return out

    shared = [None] * A2A_NP
    sends, digests = [None] * A2A_NP, {}
    QK.reset_launches()
    results = hvd.run(fn, np=A2A_NP, device=dev)
    launches = dict(QK.launches)
    r0 = results[0]
    n_tok = LM_BATCH * LM["max_seq_len"]
    for tag, v in r0.items():
        if tag == "ep2":
            continue
        log(f"phase 15 (b) {tag}: ms per exchange ({A2A_NP} x {n_tok} "
            f"tokens routed to {E} x {r0['ep2']['cap']} slots x "
            f"{MOE['d_model']}, f32, rank 0's host clock) "
            f"{[round(m, 3) for m in v['ms']]}; wire ratio "
            f"{v['ratio']:.4f}")
    for wire, floor in WIRE_RATIO.items():
        if r0[wire]["ratio"] < floor:
            failures.append(f"{wire} wire ratio {r0[wire]['ratio']} below "
                            f"{floor}")
    for r, res in enumerate(results):
        ep = res["ep2"]
        log(f"phase 15 (b) rank {r} ep = {A2A_NP} FFN through "
            f"HorovodAlltoall: output vs the one-rank layer relative L2 "
            f"{ep['y']:.3g} (bit for bit: {ep['y_bits']}), gradients of "
            f"the tokens {ep['dx']:.3g} and the router {ep['drouter']:.3g} "
            f"(bound {EP_REL_L2}); {ep['dropped']} dropped choices; all "
            f"finite (y, y_ref, dx, dx_ref, dr, dr_ref): {ep['finite']}")
        if not all(ep["finite"]) or not all(
                v <= EP_REL_L2 for v in (ep["y"], ep["dx"], ep["drouter"])):
            failures.append(f"rank {r}: ep = 2 FFN off the one-rank layer")
    log(f"phase 15 (b): codec launches {launches}")
    for f in failures[:20]:
        log(f"  MISMATCH {f}")
    if failures or any(launches[n] == 0 for n, _, _ in CODEC):
        raise AssertionError("phase 15 (b) failed: the dispatch wire "
                             "disagrees with its plain version or a codec "
                             "kernel did not run")
    del moe["keep"]
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "sends": sends, "digests": digests}


def phase_join(dev, state, batches):
    """Phase 15 (c): phase 4's run where rank 1 joins after step 3 and
    rank 0 trains on to step 6, between two barriers; then an allreduce on
    a process set of ranks 0 and 2 among 4 rank threads, and its
    removal."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import cuda_kernels as K

    xs, ys = batches
    last_step = {0: STEPS, 1: 3}
    checked = []

    def train():
        r = hvd.rank()
        hvd.barrier()
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16).to(dev)
        model.load_state_dict(state)
        params = list(model.parameters())
        local = {}
        capture = [p.register_post_accumulate_grad_hook(
            lambda p, i=i: local.__setitem__(i, p.grad.clone()))
            for i, p in enumerate(params)] if r == 0 else []
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        x0 = torch.from_numpy(xs[r]).to(dev)
        y0 = torch.from_numpy(ys[r]).to(dev)
        for step in range(last_step[r]):
            x, y = step_batch(x0, y0, step)
            opt.zero_grad()
            F.cross_entropy(model(x), y).backward()
            if r == 0 and step == 3:
                # rank 1 joined: its row is zeros, the average (g + 0) / 2
                opt.synchronize()
                for h in capture:
                    h.remove()
                want = [torch.stack([local[i], torch.zeros_like(local[i])])
                        .sum(0) * 0.5 for i in range(len(params))]
                bad = sum(not torch.equal(p.grad, w)
                          for p, w in zip(params, want))
                checked.append(bad)
                with opt.skip_synchronize():
                    opt.step()
            else:
                opt.step()
        torch.cuda.synchronize()
        last = hvd.join()
        hvd.barrier()
        return last

    K.reset_launches()
    lasts = hvd.run(train, np=NP, device=dev)
    launches = K.launches["pack_scale_cast"] + K.launches["unpack_scale_cast"]
    if checked != [0] or lasts != [0, 0]:
        raise AssertionError(f"phase 15 (c): {checked} averaged gradients "
                             f"off the join rule, join returned {lasts} "
                             f"(want the last rank to join, 0)")
    log(f"phase 15 (c): rank 1 joined after step 3, rank 0 trained steps "
        f"4-{STEPS}: step 4's averaged gradients equal the plain stacked "
        f"sum with rank 1's row zero, times 1/2, bit for bit; join returned "
        f"{lasts} (the last rank to join); barriers before and after; "
        f"pack and unpack launches {launches}")

    def subset():
        r = hvd.rank()
        hvd.barrier()
        ps = hvd.add_process_set([0, 2])
        x = torch.arange(1000, device=dev, dtype=torch.float32) * (r + 1)
        out = hvd.allreduce(x, op=hvd.Sum, name="ps02", process_set=ps) \
            if r in (0, 2) else None
        removed = hvd.remove_process_set(ps)
        sets = sorted(hvd.engine().process_sets)
        hvd.barrier()
        ok = out is None or torch.equal(
            out, torch.arange(1000, device=dev, dtype=torch.float32) * 4)
        return ok and removed and sets == [0]

    oks = hvd.run(subset, np=4, device=dev)
    if not all(oks):
        raise AssertionError(f"phase 15 (c): process set [0, 2]: {oks}")
    log("phase 15 (c): allreduce on add_process_set([0, 2]) among 4 rank "
        "threads equal to ranks 0 and 2's sum, bit for bit; the set removed "
        "by all four, its executor gone")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 16

def coord_counts():
    """This process's coordinator requests so far (ready POSTs, polls),
    its negotiation bypass's hits and fallbacks, the seconds of its
    armed cycles' votes and executions and the seconds its un-armed
    tracker took (all 0 without a coordinator)."""
    import horovod_tpu_torch as hvd
    eng = hvd.engine()
    ctl = eng.controller
    req = ctl.client.coord_requests if ctl is not None else {}
    return {"ready": req.get("ready", 0), "poll": req.get("poll", 0),
            "hits": eng.bypass_hits, "fallbacks": eng.bypass_fallbacks,
            "bypass_s": eng.bypass_cycle_seconds,
            "track_s": eng.bypass_track_seconds}


def counts_delta(before):
    now = coord_counts()
    return {k: now[k] - before[k] for k in now}


def phase16_worker(legs, tmp):
    """One process of a phase-16/17 job (``chip_smoke.py --worker16
    <legs> <dir>``), launched by the port's ``launch_procs``: rank
    ``HOROVOD_RANK`` of the job, running ``legs`` in turn (cuDNN
    deterministic in ``DETERMINISTIC_LEGS``).  It reports through files
    in ``dir`` and never prints the ``{"ok": ...}`` line; any failure
    exits non-zero, which fails the launcher's job and so the phase."""
    import torch
    sys.path.insert(0, ROOT)
    import horovod_tpu_torch as hvd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda:0")
    hvd.init(device=dev)
    # the job's first leg counts from the launch, later ones from their
    # own start
    t_start = float(os.environ["HVD16_T_LAUNCH"])
    for leg in legs:
        torch.backends.cudnn.deterministic = leg in DETERMINISTIC_LEGS
        out = {"leg": leg, "rank": hvd.rank()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = wrapper_counts()
        if leg == "d":
            out.update(phase16_matrix(dev))
        elif leg in "abcB":
            out.update(phase16_train(leg, tmp, dev, t_start))
        else:
            out.update(PHASE17_LEGS[leg](tmp, dev))
            after = wrapper_counts()
            out["launches"] = {k: after[k] - before.get(k, 0)
                               for k in after}
        torch.cuda.synchronize()
        out["peak"] = torch.cuda.max_memory_allocated(dev)
        out["env"] = {k: os.environ.get(k) for k in REPORTED_ENV}
        with open(os.path.join(tmp, f"{leg}_{hvd.rank()}.json"), "w") as f:
            json.dump(out, f)
        t_start = time.time()
        gc.collect()
        torch.cuda.empty_cache()
    hvd.shutdown()
    return 0


def phase16_train(leg, tmp, dev, t_start):
    """Legs (a)-(c): phase 4's run in this process (rank 0 alone in
    (a)); the final parameters and, in (c), step 1's local and averaged
    gradients go to files.  Leg B is (b) in a job whose negotiation
    bypass is off (phase 18 (e)); per step each leg counts this
    process's coordinator requests (ready POSTs and polls) and its
    bypass hits and fallbacks."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import cuda_kernels as K
    from horovod_tpu_torch.ops import quantize_kernels as QK

    r = hvd.rank()
    out = {}
    ex = hvd.engine().get_process_set(0).executor
    state = torch.load(os.path.join(tmp, "state.pt"))
    x0, y0 = (t.to(dev) for t in torch.load(os.path.join(tmp,
                                                          f"batch{r}.pt")))
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16).to(dev)
    model.load_state_dict({k: v if r == 0 else v + 1.0
                           for k, v in state.items()})
    hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
    params = list(model.parameters())
    local = {}
    capture = [p.register_post_accumulate_grad_hook(
        lambda p, i=i: local.__setitem__(i, p.grad.clone()))
        for i, p in enumerate(params)] if leg == "c" else []
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    if leg != "a":
        # at one process the optimizer reduces nothing (the reference's
        # rule), so leg (a) averages its gradients through the engine
        opt = hvd_torch.DistributedOptimizer(
            opt, named_parameters=model.named_parameters(),
            compression=getattr(hvd_torch.Compression,
                                "int8" if leg == "c" else "none"))
    K.reset_launches()
    QK.reset_launches()
    losses, times, coll_ms, requests = [], [], [], []
    for step in range(STEPS):
        x, y = step_batch(x0, y0, step)
        hvd.barrier()
        if step == 0:
            out["to_first_step_s"] = time.time() - t_start
        q0 = coord_counts()
        c0 = ex.collective_seconds
        prof = None
        if r == 0 and step == STEPS - 2:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        if leg == "a":
            hvd.grouped_allreduce_([p.grad for p in params], name="grads")
            opt.step()
        elif step == 0 and leg == "c":
            opt.synchronize()
            for h in capture:
                h.remove()
            torch.save({"local": [local[i] for i in range(len(params))],
                        "averaged": [p.grad for p in params]},
                       os.path.join(tmp, f"c_grads{r}.pt"))
            with opt.skip_synchronize():
                opt.step()
        else:
            opt.step()
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if prof is not None:
            prof.__exit__(None, None, None)
            out["busy_share"] = profile_summary(prof, times[-1],
                                                tables=False)
        coll_ms.append((ex.collective_seconds - c0) * 1e3)
        requests.append(counts_delta(q0))
    out.update(losses=losses, times=times, collective_ms=coll_ms,
               requests=requests, launches={
                   "pack": K.launches["pack_scale_cast"],
                   "unpack": K.launches["unpack_scale_cast"],
                   "quantize": QK.launches["quantize_blockwise"],
                   "dequantize": QK.launches["dequantize_blockwise"]})
    torch.save({k: p.detach().cpu() for k, p in model.named_parameters()},
               os.path.join(tmp, f"{leg}_params{r}.pt"))
    return out


def phase16_matrix(dev):
    """Leg (d): the cross-process collective contract on CUDA tensors,
    each result against its host formula, exactly (small integers and
    power-of-two scales: every value is exact in f32); then which of
    gloo's collectives take CUDA tensors, probed on the job's group."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import dist_ops

    r, s = hvd.rank(), hvd.size()
    checks = []

    def check(name, got, want):
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        if not np.array_equal(np.asarray(got), np.asarray(want)):
            raise AssertionError(f"phase 16 (d) rank {r}: {name} {got}, "
                                 f"want {want}")
        checks.append(name)

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    base = np.arange(12, dtype=np.float32)
    ranks = np.arange(s, dtype=np.float32)
    for op, name, fold in ((hvd.Sum, "sum", lambda v: v.sum(0)),
                           (hvd.Average, "average", lambda v: v.mean(0)),
                           (hvd.Min, "min", lambda v: v.min(0)),
                           (hvd.Max, "max", lambda v: v.max(0))):
        rows = np.stack([base * (q + 1) - 3 * q for q in range(s)])
        got = hvd.allreduce(T(rows[r]), op=op, prescale_factor=2.0,
                            postscale_factor=0.25, name=f"ar_{name}")
        check(f"allreduce {name} x2 x0.25", got, fold(rows * 2.0) * 0.25)
    i32 = np.arange(6, dtype=np.int32) * (r + 3)
    check("allreduce int32 sum", hvd.allreduce(T(i32), op=hvd.Sum,
                                                 name="ar_i32"),
          sum(np.arange(6, dtype=np.int32) * (q + 3) for q in range(s)))
    check("allgather uneven", hvd.allgather(
        T(np.full((r + 1, 3), float(r), np.float32)), name="ag"),
        np.concatenate([np.full((q + 1, 3), float(q), np.float32)
                        for q in range(s)]))
    check("broadcast from rank 1", hvd.broadcast(
        T(np.full(5, float(r), np.float32)), root_rank=1, name="bc"),
        np.ones(5, np.float32))
    send = np.arange(3, dtype=np.float32).reshape(3, 1) + 10 * r
    a2a, recv = hvd.alltoall(T(send), splits=[1, 2] if r == 0 else [2, 1],
                             name="a2a")
    check("alltoall uneven", a2a.ravel(),
          [0.0, 10.0, 11.0] if r == 0 else [1.0, 2.0, 12.0])
    check("alltoall received splits", recv, [1, 2] if r == 0 else [2, 1])
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    check("reducescatter sum", hvd.reducescatter(
        T(x * (r + 1)), op=hvd.Sum, name="rs"),
        (x * ranks.sum() + x * s)[:3] if r == 0
        else (x * ranks.sum() + x * s)[3:])
    g = hvd.grouped_allreduce([T(np.full(3, float(r), np.float32)),
                               T(np.full((2, 2), 1.0, np.float32))],
                              op=hvd.Sum, name="grp")
    check("grouped allreduce [0]", g[0], np.full(3, ranks.sum()))
    check("grouped allreduce [1]", g[1], np.full((2, 2), float(s)))
    hvd.barrier()
    checks.append("barrier")
    ps = hvd.add_process_set([1])
    if r == 1:
        check("process set [1]", hvd.allreduce(
            T(np.full(4, 7.0, np.float32)), op=hvd.Sum, name="ps1",
            process_set=ps), np.full(4, 7.0))
    if not hvd.remove_process_set(ps):
        raise AssertionError("phase 16 (d): remove_process_set failed")
    if r == 0:
        last = hvd.join()
    else:
        check("allreduce after rank 0 joined", hvd.allreduce(
            T(np.ones(2, np.float32)), op=hvd.Sum, name="tail"),
            np.ones(2, np.float32))
        last = hvd.join()
    check("join returns the last rank to join", np.asarray(last), 1)
    # which collectives gloo takes on CUDA tensors: each called directly
    # on the job's group (all processes in the same order; gloo refuses
    # by argument checks, before any traffic)
    pg = dist.group.WORLD
    t = torch.ones(8, device=dev)
    calls = {
        "allreduce": lambda: pg.allreduce([t]),
        "broadcast": lambda: pg.broadcast([t], dist.BroadcastOptions()),
        "allgather": lambda: pg.allgather(
            [[torch.empty_like(t) for _ in range(s)]], [t]),
        "alltoall_base": lambda: pg.alltoall_base(
            torch.empty_like(t), t, [], [], dist.AllToAllOptions()),
        "reduce_scatter": lambda: pg.reduce_scatter(
            [torch.empty(4, device=dev)], [list(t.view(s, 4).unbind(0))],
            dist.ReduceScatterOptions()),
    }
    takes = {}
    for name, call in calls.items():
        torch.cuda.synchronize()
        try:
            call().wait()
            takes[name] = True
        except RuntimeError as exc:
            takes[name] = str(exc).splitlines()[0][:120]
    wrong = [n for n in dist_ops.GLOO_CUDA_COLLECTIVES
             if takes.get(n) is not True]
    if wrong:
        raise AssertionError(f"phase 16 (d): gloo refuses CUDA tensors "
                             f"for {wrong}, which the executor hands it: "
                             f"{takes}")
    return {"checks": checks, "gloo_cuda": takes}


# ---------------------------------------------------------------------------
# phase 17: the compiled path across processes (legs of phase 16's jobs)

def p17_resnet(tmp, dev, sharded=False, wire=None, staged=False,
               capture=True, profile=False, n_batches=NP):
    """Phase 12's ResNet-50 configuration in this process of a launcher
    job through ``make_compiled_train_step`` (SGD momentum 0.9 at lr 0.1,
    bf16 compute, phase 4's weights): rank r on ``step_batch`` of its
    phase-4 batch, or (``staged``) one rank on both ranks' 128 images
    through ``place_batch``; 6 steps.  Returns the losses (read after the
    6 steps), step times, host ms in the compiled group's collectives a
    step and the collectives issued, the final parameters on the host,
    the program, rank r's optimizer-state bytes and (``profile``) the busy
    share of step 5.  ``n_batches``: the ranks' batch files
    (``batch<q>.pt``) in ``tmp``."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import compiled as C
    from horovod_tpu_torch.parallel.train import sgd

    r = hvd.rank()
    state = torch.load(os.path.join(tmp, "state.pt"))
    with torch.device("meta"):
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16)
    names = {k for k, _ in model.named_parameters()}
    params = {k: v for k, v in state.items() if k in names}
    aux = {k: v for k, v in state.items() if k not in names}

    def loss_fn(p, a, batch):
        x, y = batch
        logits = torch.func.functional_call(model, {**p, **a}, (x,))
        return F.cross_entropy(logits, y), a

    step = hvd.make_compiled_train_step(
        loss_fn, sgd(0.1, momentum=0.9), has_aux=True, sharded=sharded,
        wire_dtype=wire)
    step.capture = capture
    st = step.init_state(params, aux=aux)
    bases = [tuple(t.to(dev) for t in torch.load(
        os.path.join(tmp, f"batch{q}.pt"))) for q in range(n_batches)]
    feed = step.place_batch((torch.cat([x for x, _ in bases]),
                             torch.cat([y for _, y in bases]))) \
        if staged else None
    ex = hvd.engine().get_process_set(0).compiled_executor
    losses, times, coll_ms, colls = [], [], [], []
    busy = None
    for i in range(STEPS):
        batch = feed if staged else step_batch(*bases[r], i)
        hvd.barrier()
        c0, n0 = ex.collective_seconds, ex.collectives
        prof = None
        if profile and r == 0 and i == STEPS - 2:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        st, loss = step(st, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        if prof is not None:
            prof.__exit__(None, None, None)
            busy = profile_summary(prof, times[-1], tables=False)
        coll_ms.append((ex.collective_seconds - c0) * 1e3)
        colls.append(ex.collectives - n0)
    so = st["opt_state"]
    return {"losses": [float(v) for v in losses], "times": times,
            "coll_ms": coll_ms, "colls": colls, "busy": busy,
            "params": {k: v.detach().cpu() for k, v in st["params"].items()},
            "prog": step._prog, "backend": C.executor_backend(ex, dev),
            "state_bytes": so.state_bytes(r)
            if isinstance(so, C.ShardedOptState) else None}


def _steady_ms(times):
    """Mean of steps 3-6 but the profiled step 5, in ms."""
    steady_i = [i for i in range(2, STEPS) if i != STEPS - 2]
    return sum(times[i] for i in steady_i) / len(steady_i) * 1e3


def _rules():
    from horovod_tpu_torch.ops import compiled as C
    return C.program_cache_stats(by_rule=True)


def _rules_delta(before):
    after = _rules()
    return {k: after[k] - before[k] for k in after}


def p17_e(tmp, dev):
    """(e) bench.py's configuration at np=1 over NCCL: one CUDA graph a
    step with the NCCL allreduces inside it, bit for bit the same program
    uncaptured."""
    import torch
    before = _rules()
    got = p17_resnet(tmp, dev, staged=True, profile=True)
    want = p17_resnet(tmp, dev, staged=True, capture=False)
    rules = _rules_delta(before)
    prog = got.pop("prog")
    name = "phase 17 (e)"
    if got["backend"] != "nccl" or rules["graph"] != 1 \
            or rules["reference"] != 1:
        raise AssertionError(f"{name}: backend {got['backend']}, programs "
                             f"by rule {rules}")
    if (prog.captures, prog.replays) != (1, STEPS - 1):
        raise AssertionError(f"{name}: captures {prog.captures}, replays "
                             f"{prog.replays}")
    # collectives: issued by the warm-up and recorded by the capture,
    # none by the replays (they run inside the graph)
    if got["colls"][0] == 0 or got["colls"][1] != got["colls"][0] \
            or any(got["colls"][2:]):
        raise AssertionError(f"{name}: collectives a step {got['colls']}")
    diff = [k for k in got["params"]
            if not torch.equal(got["params"][k], want["params"][k])]
    if got["losses"] != want["losses"] or diff:
        raise AssertionError(f"{name}: captured differs from uncaptured: "
                             f"{got['losses']} vs {want['losses']}; "
                             f"{diff[:5]}")
    torch.save(got.pop("params"), os.path.join(tmp, "e_params.pt"))
    return {"losses": got["losses"], "times": got["times"],
            "busy": got["busy"], "colls": got["colls"],
            "compile_s": prog.compile_seconds, "rules": rules,
            "captures": prog.captures, "replays": prog.replays}


def p17_f(tmp, dev):
    """(f) the full-width 436M LM (phase 7's weights and tokens, bf16,
    flash attention, AdamW 1e-3) through ``make_compiled_train_step`` at
    np=1 over NCCL: NCCL and B6-B8 in one graph; the 6 losses against
    phase 7's eager run."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, lm_loss, numpy_init)
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.ops.flash_attention import flash_attention
    from horovod_tpu_torch.parallel.train import adamw

    cfg = TransformerConfig(dtype=torch.bfloat16, **LM)
    with torch.device("meta"):
        model = TransformerLM(cfg, attention_fn=flash_attention)
    weights = numpy_init(model, SEED)
    tok = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab_size, size=(LM_BATCH, cfg.max_seq_len))).to(dev)

    def loss_fn(p, t):
        logits = torch.func.functional_call(model, p, (t,))
        return lm_loss(logits[:, :-1], t[:, 1:])

    before = _rules()
    step = hvd.make_compiled_train_step(loss_fn, adamw(1e-3))
    st = step.init_state(weights)
    del weights
    gc.collect()
    ex = hvd.engine().get_process_set(0).compiled_executor
    names = [n for n, _ in FLASH]
    losses, times, per_step, colls = [], [], [], []
    busy = None
    for i in range(STEPS):
        n0 = ex.collectives
        c0 = [FA.launches[n] for n in names]
        prof = None
        if i == STEPS - 2:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        st, loss = step(st, tok)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if prof is not None:
            prof.__exit__(None, None, None)
            busy = profile_summary(prof, times[-1], tables=False)
            kern = {e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA}
        losses.append(loss)
        per_step.append([FA.launches[n] - c for n, c in zip(names, c0)])
        colls.append(ex.collectives - n0)
    losses = [float(v) for v in losses]
    rules = _rules_delta(before)
    prog = step._prog
    ref = json.load(open(os.path.join(tmp, "p17_refs.json")))["lm_losses"]
    name = "phase 17 (f)"
    gap = max(abs(a - b) for a, b in zip(losses, ref))
    ran = sorted(k for k in (FLASH_KERNEL[n] for n in names)
                 if any(k in e for e in kern))
    if not all(math.isfinite(v) for v in losses) or gap > P17_LM_LOSS \
            or (prog.captures, prog.replays) != (1, STEPS - 1) \
            or rules["graph"] != 1 \
            or per_step[1] != [cfg.n_layers] * 3 \
            or any(any(c) for c in per_step[2:]) \
            or colls[1] == 0 or any(colls[2:]) or len(ran) != 3:
        raise AssertionError(
            f"{name}: losses {losses} vs phase 7's {ref} (gap {gap:.3g}, "
            f"bound {P17_LM_LOSS}); captures {prog.captures}, replays "
            f"{prog.replays}, rules {rules}; flash launches per step "
            f"{per_step}; collectives per step {colls}; the profiled "
            f"replay ran {ran}")
    steady = _steady_ms(times)
    return {"losses": losses, "ref": ref, "gap": gap, "times": times,
            "busy": busy, "per_step": per_step, "colls": colls,
            "compile_s": prog.compile_seconds, "ran": ran,
            "tflops": lm_flops_per_token(cfg) * LM_BATCH * cfg.max_seq_len
            / steady / 1e9}


def p17_g(tmp, dev):
    """(g) ``CompiledGroupedAllreduce(force_program=True)`` over the 161
    ResNet-50 gradients at np=1 over NCCL: B1 packs and unpacks, and the
    sums bit for bit the engine's ``grouped_allreduce``."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as K

    rng = np.random.default_rng(SEED + 17)
    grads = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                              * 1e-2).to(dev)
             for s in resnet50_grad_shapes()]
    k0 = dict(K.launches)
    got = hvd.CompiledGroupedAllreduce(op=hvd.Sum, force_program=True,
                                       name="p17g")(grads)
    b1 = {k: K.launches[k] - k0.get(k, 0)
          for k in ("pack_scale_cast", "unpack_scale_cast")}
    want = hvd.grouped_allreduce(grads, op=hvd.Sum, name="p17g")
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if not torch.equal(a, b)]
    if bad or min(b1.values()) <= 0:
        raise AssertionError(f"phase 17 (g): differs from the engine at "
                             f"{bad[:5]}; B1 launches {b1}")
    return {"b1": b1, "n": len(grads)}


def p17_h(tmp, dev):
    """(h) phase 12 (b)'s configuration through the dense compiled step,
    one rank a process over gloo on CUDA tensors: uncaptured by the
    capture rule."""
    import torch
    import horovod_tpu_torch as hvd
    before = _rules()
    got = p17_resnet(tmp, dev, profile=True)
    rules = _rules_delta(before)
    if got["backend"] != "gloo" or rules["uncaptured"] != 1 \
            or rules["graph"] != 0 or hasattr(got["prog"], "captures"):
        raise AssertionError(f"phase 17 (h): backend {got['backend']}, "
                             f"programs by rule {rules}")
    torch.save(got.pop("params"),
               os.path.join(tmp, f"h_params{hvd.rank()}.pt"))
    got.pop("prog")
    got["rules"] = rules
    return got


def p17_i(tmp, dev):
    """(i) the sharded compiled step on the f32 and int8 wires (phase 14
    (a)'s legs), one rank a process over gloo."""
    import torch
    import horovod_tpu_torch as hvd
    out = {}
    for wire in (None, "int8"):
        got = p17_resnet(tmp, dev, sharded=True, wire=wire)
        got.pop("prog")
        torch.save(got.pop("params"), os.path.join(
            tmp, f"i{wire or 'f32'}_params{hvd.rank()}.pt"))
        out[wire or "f32"] = got
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _digest(t):
    """SHA-256 of a tensor's bytes: an exact comparison across processes
    and phases without keeping the tensor."""
    import hashlib
    import torch
    flat = t.detach().contiguous().cpu().reshape(-1)
    return hashlib.sha256(flat.view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def p17_j(tmp, dev):
    """(j) ``CompiledAlltoall`` at ep = 2 across the two processes on
    phase 15 (b)'s layer-0 slots, f32, int8 and int4 (error feedback,
    two calls), against phase 15 (b)'s exchanges by digest; then
    ``CompiledGroupedAllreduce.stream`` over the ResNet-50 gradients
    pushed in backward order, bit for bit the engine's sums."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as K
    from horovod_tpu_torch.ops import quantize_kernels as QK

    r = hvd.rank()
    send = torch.load(os.path.join(tmp, f"a2a_send{r}.pt")).to(dev)
    ref = json.load(open(os.path.join(tmp, "p17_refs.json")))["a2a"]
    q0 = dict(QK.launches)
    ms, bad = {}, []
    for wire in (None, "int8", "int4"):
        a2a = hvd.CompiledAlltoall(name="moe.dispatch", wire_dtype=wire,
                                   error_feedback=wire is not None)
        tag = wire or "f32"
        ms[tag] = []
        for call in range(1 if wire is None else 2):
            hvd.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = a2a(send)
            torch.cuda.synchronize()
            ms[tag].append((time.perf_counter() - t0) * 1e3)
            if _digest(y) != ref[f"{tag}.{call}.{r}"]:
                bad.append(f"{tag} call {call}")
        a2a.reset_wire_state()
    codec = {k: QK.launches[k] - q0.get(k, 0) for k in QK.launches}
    del send
    rng = np.random.default_rng(SEED + 170 + r)
    grads = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                              * 1e-2).to(dev)
             for s in resnet50_grad_shapes()]
    k0 = dict(K.launches)
    red = hvd.CompiledGroupedAllreduce(op=hvd.Sum, name="p17j",
                                       bucket_bytes=COMPILED_BUCKET_BYTES)
    st = red.stream(grads)
    for i in reversed(range(len(grads))):
        st.push(i, grads[i])
    got = st.result()
    b1 = {k: K.launches[k] - k0.get(k, 0)
          for k in ("pack_scale_cast", "unpack_scale_cast")}
    want = hvd.grouped_allreduce(grads, op=hvd.Sum, name="p17j")
    sbad = [i for i, (a, b) in enumerate(zip(got, want))
            if not torch.equal(a, b)]
    if bad or sbad or min(b1.values()) <= 0 \
            or any(codec[n] <= 0 for n, _, _ in CODEC):
        raise AssertionError(
            f"phase 17 (j) rank {r}: exchanges differing from phase 15 "
            f"(b)'s {bad}; stream differing from the engine at "
            f"{sbad[:5]}; B1 {b1}; B2-B5 {codec}")
    return {"ms": ms, "codec": codec, "b1": b1,
            "buckets": len(st.buckets)}


def p17_k(tmp, dev):
    """(k) a mismatched ``compiled_allreduce`` signature raises
    ``ValueError`` on both processes within the exchange's timeout."""
    import torch
    import horovod_tpu_torch as hvd
    r = hvd.rank()
    ok = hvd.compiled_allreduce(torch.full((4,), float(r + 1), device=dev),
                                op=hvd.Sum)
    if not torch.equal(ok.cpu(), torch.full((4,), 3.0)):
        raise AssertionError(f"phase 17 (k): {ok}")
    t0 = time.monotonic()
    try:
        hvd.compiled_allreduce(torch.ones(4 if r == 0 else 5, device=dev))
    except ValueError as exc:
        if "signature mismatch across processes" not in str(exc):
            raise
        dt = time.monotonic() - t0
        if dt >= P17_SIG_TIMEOUT:
            raise AssertionError(f"phase 17 (k): raised after {dt:.1f} s")
        return {"raised_s": dt, "error": str(exc).splitlines()[0][:200]}
    raise AssertionError("phase 17 (k): the mismatch did not raise")


PHASE17_LEGS = {"e": p17_e, "f": p17_f, "g": p17_g, "h": p17_h,
                "i": p17_i, "j": p17_j, "k": p17_k}


def phase_multiprocess(dev, card, state, batches, phase4_params, refs):
    """Phases 16 and 17: the multi-process path, eager (16) and compiled
    (17, ``refs``: what earlier phases measured that phase 17 is held
    to; see :func:`phase17_report`).  Each leg is a job of the
    port's ``launch_procs`` running ``chip_smoke.py --worker16``: (a)
    np=1 over NCCL, cuDNN deterministic, phase 4's rank-0 run with the
    gradients averaged by ``grouped_allreduce_``, bit for bit the same
    steps of plain torch SGD here; (b) np=2 processes on cuda:0 with
    ``HOROVOD_GPU_OPERATIONS=gloo``, phase 4's run through
    ``DistributedOptimizer``: replicas bit for bit, within
    ``COMPILED_REL_L2`` of phase 4; (c) (b) on the int8 wire
    (``Compression.int8``): replicas bit for bit, step 1's averaged
    gradient within ``WIRE_REL_L2["int8"]`` of the exact average; (d)
    np=2, the collective matrix on CUDA tensors, exact.  Legs (b)-(d)
    run in one job, one after the other."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.runner.proc_run import launch_procs

    xs, ys = batches
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(state, os.path.join(tmp, "state.pt"))
        for r in range(NP):
            torch.save((torch.from_numpy(xs[r]), torch.from_numpy(ys[r])),
                       os.path.join(tmp, f"batch{r}.pt"))
            torch.save(refs["a2a_sends"][r],
                       os.path.join(tmp, f"a2a_send{r}.pt"))
        with open(os.path.join(tmp, "p17_refs.json"), "w") as f:
            json.dump({"lm_losses": refs["lm_losses"],
                       "a2a": refs["a2a_digests"]}, f)
        walls = {}
        for legs, np_, env in PHASE16_JOBS:
            t0 = time.perf_counter()
            codes = launch_procs(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--worker16", legs, tmp], np=np_,
                env={**env, "HVD16_T_LAUNCH": repr(time.time()),
                     "HOROVOD_COMPILED_SIG_TIMEOUT": str(P17_SIG_TIMEOUT),
                     "PYTHONPATH": ROOT},
                start_timeout=PHASE16_TIMEOUT)
            if codes != [0] * np_:
                raise AssertionError(f"phase 16 ({legs}): workers exited "
                                     f"{codes}")
            walls[legs] = time.perf_counter() - t0
            for leg in legs:
                reports = []
                for r in range(np_):
                    with open(os.path.join(tmp, f"{leg}_{r}.json")) as f:
                        reports.append(json.load(f))
                res[leg] = {"reports": reports}
                if leg in "abcB":
                    res[leg]["params"] = [torch.load(os.path.join(
                        tmp, f"{leg}_params{r}.pt")) for r in range(np_)]
        c_grads = [torch.load(os.path.join(tmp, f"c_grads{r}.pt"))
                   for r in range(NP)]
        p17_params = {"e": torch.load(os.path.join(tmp, "e_params.pt"))}
        for leg in ("h", "if32", "iint8"):
            p17_params[leg] = [torch.load(os.path.join(
                tmp, f"{leg}_params{r}.pt")) for r in range(NP)]

    # (a) against plain torch SGD in this process, cuDNN deterministic
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16).to(dev)
        model.load_state_dict(state)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        x0 = torch.from_numpy(xs[0]).to(dev)
        y0 = torch.from_numpy(ys[0]).to(dev)
        for step in range(STEPS):
            x, y = step_batch(x0, y0, step)
            opt.zero_grad()
            F.cross_entropy(model(x), y).backward()
            opt.step()
        plain = {k: p.detach().cpu() for k, p in model.named_parameters()}
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = False
    del model, opt
    diff = [k for k in plain if not torch.equal(plain[k],
                                                res["a"]["params"][0][k])]
    if diff:
        raise AssertionError(f"phase 16 (a): {len(diff)} parameters differ "
                             f"from plain torch SGD: {diff[:5]}")
    for leg in "bcB":
        p0, p1 = res[leg]["params"]
        diff = [k for k in p0 if not torch.equal(p0[k], p1[k])]
        if diff:
            raise AssertionError(f"phase 16 ({leg}): the two processes' "
                                 f"parameters differ: {diff[:5]}")
    num = sum(float((res["b"]["params"][0][k].float()
                     - phase4_params[k].float()).norm()) ** 2
              for k in phase4_params)
    den = sum(float(v.float().norm()) ** 2 for v in phase4_params.values())
    rel_b = math.sqrt(num / den)
    if not rel_b <= COMPILED_REL_L2:
        raise AssertionError(f"phase 16 (b): parameters {rel_b:.3g} "
                             f"(relative L2) from phase 4's, bound "
                             f"{COMPILED_REL_L2}")
    exact_sq = err_sq = 0.0
    for i in range(len(c_grads[0]["local"])):
        exact = (c_grads[0]["local"][i].float()
                 + c_grads[1]["local"][i].float()) * 0.5
        exact_sq += float(exact.double().norm()) ** 2
        err_sq += float((c_grads[0]["averaged"][i].float()
                         - exact).double().norm()) ** 2
    rel_c = math.sqrt(err_sq / exact_sq)
    if not rel_c < WIRE_REL_L2["int8"]:
        raise AssertionError(f"phase 16 (c): step 1's averaged gradient is "
                             f"{rel_c} (relative L2) from the exact average")
    launches = {}
    for leg in "abcB":
        launches[leg] = [rep["launches"] for rep in res[leg]["reports"]]
        for rep in res[leg]["reports"]:
            b1 = rep["launches"]["pack"] + rep["launches"]["unpack"]
            b23 = (rep["launches"]["quantize"], rep["launches"]["dequantize"])
            if b1 <= 0 or (leg == "c" and min(b23) <= 0):
                raise AssertionError(f"phase 16 ({leg}) rank {rep['rank']}: "
                                     f"launches {rep['launches']}")
    d = res["d"]["reports"]
    log(f"phase 16 ({card}): np=1 NCCL (a) parameters bit for bit plain "
        f"torch SGD after {STEPS} steps (cuDNN deterministic); np=2 "
        f"processes on one card over gloo: (b) replicas bit for bit, "
        f"{rel_b:.3g} (relative L2) from phase 4's 2-rank-thread run "
        f"(bound {COMPILED_REL_L2}); (c) int8 wire replicas bit for bit, "
        f"step 1's averaged gradient {rel_c:.6f} from the exact f32 average "
        f"(bound {WIRE_REL_L2['int8']}); (d) {len(d[0]['checks'])} + "
        f"{len(d[1]['checks'])} checks exact; job walls (s) "
        f"{ {k: round(v, 1) for k, v in walls.items()} }")
    log(f"phase 16 (d): gloo on CUDA tensors, per collective (True = "
        f"taken): {d[0]['gloo_cuda']}")
    out = {"launches": launches}
    for leg in "abcB":
        reps = res[leg]["reports"]
        np_ = len(reps)
        step_s = [max(rep["times"][i] for rep in reps)
                  for i in range(STEPS)]
        timed = sorted(t for i, t in enumerate(step_s)
                       if i > 0 and i != STEPS - 2)
        med = timed[len(timed) // 2] if len(timed) % 2 else \
            0.5 * (timed[len(timed) // 2 - 1] + timed[len(timed) // 2])
        log(f"phase 16 ({leg}) np={np_}: step times (s) "
            f"{[round(t, 4) for t in step_s]}; steady median "
            f"{med * 1e3:.2f} ms/step = {np_ * BATCH / med:.1f} img/s; "
            f"rank 0's busy share of one profiled step "
            f"{reps[0]['busy_share']:.3f}; host ms inside the collective "
            f"per step, per rank "
            f"{[[round(v, 2) for v in rep['collective_ms']] for rep in reps]}; "
            f"s to the first step from "
            f"{'the launch' if leg in 'abB' else 'the leg start'} "
            f"{[round(rep['to_first_step_s'], 2) for rep in reps]}; "
            f"B1/B2/B3 launches per rank {launches[leg]}")
        out[leg] = {"steady_ms": med * 1e3, "img_s": np_ * BATCH / med}
    # phase 18 (e): the coordinator's requests a step in (b) (the bypass
    # armed by default, K = 5) and in B, the same run with it off
    for leg, label in (("b", "on (default, K = 5)"), ("B", "off")):
        reps = res[leg]["reports"]
        per = [[q["ready"] + q["poll"] for q in rep["requests"]]
               for rep in reps]
        log(f"phase 18 (e) ({card}): phase 16 (b)'s np=2 job with the "
            f"bypass {label}: coordinator requests (ready + poll) a step, "
            f"per process {per}; bypass hits "
            f"{[sum(q['hits'] for q in rep['requests']) for rep in reps]}, "
            f"fallbacks "
            f"{[sum(q['fallbacks'] for q in rep['requests']) for rep in reps]}"
            f"; host ms a step in the un-armed bypass tracker per process "
            f"{[[round(q['track_s'] * 1e3, 3) for q in rep['requests']] for rep in reps]}")
    same = all(torch.equal(res["b"]["params"][0][k],
                           res["B"]["params"][0][k])
               for k in res["b"]["params"][0])
    log(f"phase 18 (e): (b)'s parameters {'equal' if same else 'differ from'}"
        f" the bypass-off job's bit for bit (cuDNN not deterministic in "
        f"either)")
    out["e_requests"] = {leg: [[q["ready"] + q["poll"]
                                for q in rep["requests"]]
                               for rep in res[leg]["reports"]]
                         for leg in "bB"}
    out["phase17"] = phase17_report(card, res, p17_params, refs,
                                    walls, out["b"]["steady_ms"])
    return out


# ---------------------------------------------------------------------------
# phase 18: the hybrid layout and the negotiation bypass

def p18_images(xs, ys, r):
    """Rank r's images of phase 18: phase 4's batches cut in halves,
    ``P18_BATCH`` a rank, so four ranks take bench.py's 128."""
    lo = (r % 2) * P18_BATCH
    return xs[r // 2][lo:lo + P18_BATCH], ys[r // 2][lo:lo + P18_BATCH]


def p18_train(dev, state, xs, ys, nloc):
    """Phase 18 (a)'s run on this process's ``nloc`` rank threads (all
    four in the stacked reference): full-width ResNet-50, bf16, phase 4's
    weights broadcast from rank 0, SGD momentum 0.9 through
    ``DistributedOptimizer(groups=1)`` (one grouped allreduce a step: the
    periodic response list the bypass serves), ``P18_BATCH`` images a
    rank, 6 steps.  No negotiated op between steps: a barrier is a cycle
    of its own that no bypass takes, so the local threads meet at a
    threading barrier.  Returns per rank its losses, step times and
    parameters, and local rank 0's per-step coordinator requests, bypass
    counts and busy share of one profiled step."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.models.resnet import ResNet50

    barrier = threading.Barrier(nloc)
    per_step, busy = [], []

    def train():
        r = hvd.rank()
        lead = r == hvd.engine().rank_offset
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16).to(dev)
        model.load_state_dict({k: v if r == 0 else v + 1.0
                               for k, v in state.items()})
        hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters(), groups=1)
        x, y = p18_images(xs, ys, r)
        x0, y0 = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        losses, times = [], []
        for step in range(STEPS):
            x, y = step_batch(x0, y0, step)
            barrier.wait()
            q0 = coord_counts() if lead else None
            prof = None
            if lead and step == STEPS - 2:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if prof is not None:
                prof.__exit__(None, None, None)
                busy.append(profile_summary(prof, times[-1], tables=False))
            barrier.wait()
            if lead:
                per_step.append(counts_delta(q0))
        return {"rank": r, "losses": losses, "times": times,
                "params": {k: p.detach().cpu()
                           for k, p in model.named_parameters()}}

    results = hvd.run(train, np=nloc, device=dev)
    return {"ranks": results, "per_step": per_step, "busy": busy[0]}


def phase18_matrix(dev):
    """Phase 18 (b): phase 16 (d)'s checks at the job's size, on CUDA
    tensors, each exact against its host formula (small integers and
    power-of-two scales: every value exact in f32), run by every rank
    thread: allreduce Sum, Min, Max with pre/post scale, Average where
    the rank count is a power of two, int32, the int8 wire on values its
    codec holds exactly (B2/B3), uneven allgather, broadcast from the
    last rank (in the last process), uneven alltoall, reducescatter,
    grouped allreduce, barrier, a set [1, 2] spanning processes, join
    with rank 0 early.  Returns the checks made."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    def one():
        r, s = hvd.rank(), hvd.size()
        checks = []

        def check(name, got, want):
            got = got.cpu().numpy() if isinstance(got, torch.Tensor) \
                else got
            if not np.array_equal(np.asarray(got), np.asarray(want)):
                raise AssertionError(f"phase 18 (b) rank {r} of {s}: "
                                     f"{name} {got}, want {want}")
            checks.append(name)

        T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        base = np.arange(12, dtype=np.float32)
        rows = np.stack([base * (q + 1) - 3 * q for q in range(s)])
        folds = [(hvd.Sum, "sum", lambda v: v.sum(0)),
                 (hvd.Min, "min", lambda v: v.min(0)),
                 (hvd.Max, "max", lambda v: v.max(0))]
        if s & (s - 1) == 0:
            folds.append((hvd.Average, "average", lambda v: v.mean(0)))
        for op, name, fold in folds:
            got = hvd.allreduce(T(rows[r]), op=op, prescale_factor=2.0,
                                postscale_factor=0.25, name=f"ar_{name}")
            check(f"allreduce {name} x2 x0.25", got,
                  fold(rows * 2.0) * 0.25)
        i32 = np.arange(6, dtype=np.int32) * (r + 3)
        check("allreduce int32 sum", hvd.allreduce(
            T(i32), op=hvd.Sum, name="ar_i32"),
            sum(np.arange(6, dtype=np.int32) * (q + 3) for q in range(s)))
        # block absmax 127 * 2**q: the codec's scale is 2**q, every code
        # an integer, every decode exact
        q8 = np.clip(np.arange(512, dtype=np.float32) % 256 - 128, -127,
                     127)
        check("allreduce int8 wire sum", hvd.allreduce(
            T(q8 * 2.0 ** r), op=hvd.Sum, name="ar_int8",
            wire_dtype="int8"), sum(q8 * 2.0 ** q for q in range(s)))
        check("allgather uneven", hvd.allgather(
            T(np.full((r + 1, 3), float(r), np.float32)), name="ag"),
            np.concatenate([np.full((q + 1, 3), float(q), np.float32)
                            for q in range(s)]))
        x0 = np.full(5, float(r), np.float32)
        t0 = T(x0)
        check("broadcast from the last rank", hvd.broadcast(
            t0, root_rank=s - 1, name="bc"),
            np.full(5, float(s - 1), np.float32))
        check("broadcast input untouched", t0, x0)
        splits = [[(q + j) % 3 for j in range(s)] for q in range(s)]
        send = np.arange(sum(splits[r]), dtype=np.float32) + 100 * r
        a2a, recv = hvd.alltoall(T(send.reshape(-1, 1)), splits=splits[r],
                                 name="a2a")
        want = [100.0 * q + sum(splits[q][:r]) + i for q in range(s)
                for i in range(splits[q][r])]
        check("alltoall uneven", a2a.ravel(), want)
        check("alltoall received splits", recv,
              [splits[q][r] for q in range(s)])
        x = np.arange(2 * (s + 1), dtype=np.float32).reshape(-1, 2)
        chunks = [(s + 1) // s + (1 if q < (s + 1) % s else 0)
                  for q in range(s)]
        lo = sum(chunks[:r])
        total = x * sum(q + 1 for q in range(s))
        check("reducescatter sum", hvd.reducescatter(
            T(x * (r + 1)), op=hvd.Sum, name="rs"),
            total[lo:lo + chunks[r]])
        g = hvd.grouped_allreduce([T(np.full(3, float(r), np.float32)),
                                   T(np.full((2, 2), 1.0, np.float32))],
                                  op=hvd.Sum, name="grp")
        check("grouped allreduce [0]", g[0],
              np.full(3, float(sum(range(s)))))
        check("grouped allreduce [1]", g[1], np.full((2, 2), float(s)))
        hvd.barrier()
        checks.append("barrier")
        ps = hvd.add_process_set([1, 2])
        if r in (1, 2):
            check("process set [1, 2]", hvd.allreduce(
                T(np.full(4, r + 0.5, np.float32)), op=hvd.Sum, name="ps",
                process_set=ps), np.full(4, 4.0))
        if not hvd.remove_process_set(ps):
            raise AssertionError("phase 18 (b): remove_process_set failed")
        if r == 0:
            last = hvd.join()
        else:
            check("allreduce after rank 0 joined", hvd.allreduce(
                T(np.ones(2, np.float32)), op=hvd.Sum, name="tail"),
                np.full(2, float(s - 1), np.float32))
            last = hvd.join()
        if not 0 < int(last) < s:
            raise AssertionError(f"phase 18 (b): join returned {last}")
        checks.append("join")
        return checks

    return hvd.run(one)


def p18_compiled(tmp, dev):
    """Phase 18 (d): phase 12 (b)'s configuration through the dense
    compiled step at 2 processes x 2 rank threads over gloo on CUDA
    tensors (uncaptured by the capture rule), on phase 18's images; the
    local replicas must agree bit for bit."""
    import torch
    import horovod_tpu_torch as hvd
    before = _rules()
    outs = hvd.run(lambda: p17_resnet(tmp, dev, profile=True,
                                      n_batches=P18_NP))
    rules = _rules_delta(before)
    if outs[0]["backend"] != "gloo" or rules["uncaptured"] != 1 \
            or rules["graph"] != 0:
        raise AssertionError(f"phase 18 (d): backend {outs[0]['backend']},"
                             f" programs by rule {rules}")
    for o in outs[1:]:
        diff = [k for k in o["params"]
                if not torch.equal(o["params"][k], outs[0]["params"][k])]
        if diff or o["losses"] != outs[0]["losses"]:
            raise AssertionError(f"phase 18 (d): local replicas differ: "
                                 f"{diff[:5]}")
    proc = env_proc()
    torch.save(outs[0]["params"], os.path.join(tmp, f"d_params{proc}.pt"))
    out = {k: v for k, v in outs[0].items() if k not in ("params", "prog")}
    out["rules"] = rules
    return out


def env_proc():
    """This worker's process index in its launcher job."""
    return int(os.environ.get("HOROVOD_TPU_PROC_INDEX", "0"))


def phase18_worker(legs, tmp):
    """One process of a phase-18 job (``chip_smoke.py --worker18 <legs>
    <dir>``), launched by the port's ``launch_procs`` with its rank
    threads per process: (o)/(n) phase 18 (a)'s run with the bypass off
    or on (the job's environment decides), (m) the collective matrix,
    (d) the compiled step, (c) phase 4's run (its own checks, as in
    phase 4).  Reports through files in ``dir``; any failure exits
    non-zero, which fails the launcher's job and so the phase."""
    import torch
    sys.path.insert(0, ROOT)
    import horovod_tpu_torch as hvd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = False
    global LOG_PREFIX
    dev = torch.device("cuda:0")
    hvd.init(device=dev)
    proc = env_proc()
    LOG_PREFIX = f"[phase 18 worker, legs {legs}, process {proc}]"
    eng = hvd.engine()
    state = torch.load(os.path.join(tmp, "state.pt"))
    base = torch.load(os.path.join(tmp, "phase4_batches.pt"))
    xs = [x.numpy() for x in base[0]]
    ys = [y.numpy() for y in base[1]]
    for leg in legs:
        out = {"leg": leg, "proc": proc, "ranks": list(range(
            eng.rank_offset, eng.rank_offset + eng.num_local))}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = wrapper_counts()
        t0 = time.perf_counter()
        if leg in "on":
            got = p18_train(dev, state, xs, ys, eng.num_local)
            first = got["ranks"][0]["params"]
            for rec in got["ranks"][1:]:
                diff = [k for k in first
                        if not torch.equal(first[k], rec["params"][k])]
                if diff:
                    raise AssertionError(f"phase 18 (a) {leg}: local "
                                         f"replicas differ: {diff[:5]}")
            torch.save(first, os.path.join(tmp, f"{leg}_params{proc}.pt"))
            out.update(per_step=got["per_step"], busy=got["busy"],
                       losses=[rec["losses"] for rec in got["ranks"]],
                       times=[rec["times"] for rec in got["ranks"]])
        elif leg == "m":
            out["checks"] = phase18_matrix(dev)
        elif leg == "d":
            out.update(p18_compiled(tmp, dev))
        elif leg == "c":
            got = phase_main_path(dev, state, (xs, ys))
            torch.save(got["params"],
                       os.path.join(tmp, f"c_params{proc}.pt"))
            out.update(steady_s=got["steady_s"], busy=got["busy_share"],
                       backend=hvd.engine().get_process_set(0)
                       .executor.group.name())
        out["seconds"] = time.perf_counter() - t0
        after = wrapper_counts()
        out["launches"] = {k: after[k] - before.get(k, 0) for k in after}
        torch.cuda.synchronize()
        out["peak"] = torch.cuda.max_memory_allocated(dev)
        with open(os.path.join(tmp, f"{leg}_{proc}.json"), "w") as f:
            json.dump(out, f)
        gc.collect()
        torch.cuda.empty_cache()
    hvd.shutdown()
    return 0


def phase_hybrid(dev, card, state, batches, phase4_params):
    """Phase 18: the hybrid layout (several rank threads per process,
    across processes) and the steady-state negotiation bypass, as jobs of
    the port's ``launch_procs`` (``PHASE18_JOBS``) running ``chip_smoke.py
    --worker18``, with phase 18 (a)'s stacked reference run here first.
    Checks: (a) a run with the bypass off and one with it on: their
    parameters bit for bit each other (every rank of both jobs), within
    ``COMPILED_REL_L2`` of the 4-rank-thread stacked run on the same
    batches, the bypass on engaged (hits) with fewer coordinator requests
    than off, B1 launched in every process; (b) the matrix exact at 2 x 2
    and at np=3 with ``ranks_per_proc="host"``, B2/B3 launched; (c) ``--ranks-per-worker
    2`` at np=2 (one process, NCCL over a group of one, two stacked rows)
    bit for bit phase 4's parameters; (d) the compiled step at 2 x 2,
    uncaptured over gloo, within ``COMPILED_REL_L2`` of (a)'s stacked
    reference."""
    import torch
    from horovod_tpu_torch.runner.proc_run import launch_procs

    xs, ys = batches
    t_phase = time.perf_counter()
    ref = p18_train(dev, state, xs, ys, P18_NP)
    ref_params = ref["ranks"][0]["params"]
    for rec in ref["ranks"][1:]:
        if any(not torch.equal(ref_params[k], rec["params"][k])
               for k in ref_params):
            raise AssertionError("phase 18 (a): the stacked reference's "
                                 "ranks differ")
    ref_steps = [max(rec["times"][i] for rec in ref["ranks"])
                 for i in range(STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    res, walls, params = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(state, os.path.join(tmp, "state.pt"))
        torch.save(([torch.from_numpy(x) for x in xs],
                    [torch.from_numpy(y) for y in ys]),
                   os.path.join(tmp, "phase4_batches.pt"))
        for r in range(P18_NP):
            x, y = p18_images(xs, ys, r)
            torch.save((torch.from_numpy(x), torch.from_numpy(y)),
                       os.path.join(tmp, f"batch{r}.pt"))
        for label, legs, np_, rpw, hosts, env in PHASE18_JOBS:
            t0 = time.perf_counter()
            codes = launch_procs(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--worker18", legs, tmp], np=np_, ranks_per_proc=rpw,
                hosts=hosts, env={**env, "PYTHONPATH": ROOT},
                start_timeout=PHASE16_TIMEOUT)
            if any(codes):
                raise AssertionError(f"phase 18 job {label} ({legs}): "
                                     f"workers exited {codes}")
            walls[label] = time.perf_counter() - t0
            for leg in legs:
                key = leg if leg != "m" else f"m{np_}"
                res[key] = [json.load(open(os.path.join(
                    tmp, f"{leg}_{p}.json"))) for p in range(len(codes))]
                if leg in "ondc":
                    params[key] = [torch.load(os.path.join(
                        tmp, f"{leg}_params{p}.pt"))
                        for p in range(len(codes))]

    # (a): both runs' every rank bit for bit, near the stacked reference
    runs = ("o", "n")
    first = params["o"][0]
    for k in first:
        if not all(torch.equal(first[k], p[k]) for run in runs
                   for p in params[run]):
            raise AssertionError(f"phase 18 (a): {k} differs between the "
                                 f"processes or between the bypass-off "
                                 f"and bypass-on runs")
    rel_a = _rel_l2(first, ref_params)
    if not rel_a <= COMPILED_REL_L2:
        raise AssertionError(f"phase 18 (a): parameters {rel_a:.3g} "
                             f"(relative L2) from the stacked run's, bound "
                             f"{COMPILED_REL_L2}")
    req = {}
    for leg in runs:
        req[leg] = [[q["ready"] + q["poll"] for q in rep["per_step"]]
                    for rep in res[leg]]
        for rep in res[leg]:
            b1 = rep["launches"]["pack_scale_cast"] \
                + rep["launches"]["unpack_scale_cast"]
            if b1 <= 0:
                raise AssertionError(f"phase 18 (a) {leg} process "
                                     f"{rep['proc']}: B1 launches "
                                     f"{rep['launches']}")
    hits = [sum(q["hits"] for q in rep["per_step"]) for rep in res["n"]]
    o_req, n_req = (sum(map(sum, req[run])) for run in runs)
    if min(hits) <= 0 or n_req >= o_req:
        raise AssertionError(f"phase 18 (a): bypass hits {hits}, requests "
                             f"{req}")
    # (b)
    for key in ("m4", "m3"):
        for rep in res[key]:
            b23 = (rep["launches"]["quantize_blockwise"],
                   rep["launches"]["dequantize_blockwise"])
            if min(b23) <= 0:
                raise AssertionError(f"phase 18 (b) {key} process "
                                     f"{rep['proc']}: launches {b23}")
    # (c)
    diff = [k for k in phase4_params
            if not torch.equal(phase4_params[k], params["c"][0][k])]
    if diff:
        raise AssertionError(f"phase 18 (c): {len(diff)} parameters differ "
                             f"from phase 4's: {diff[:5]}; relative L2 "
                             f"{_rel_l2(params['c'][0], phase4_params):.3g}")
    # (d)
    d0, d1 = params["d"]
    if any(not torch.equal(d0[k], d1[k]) for k in d0):
        raise AssertionError("phase 18 (d): the processes' parameters "
                             "differ")
    rel_d = _rel_l2(d0, ref_params)
    if not rel_d <= COMPILED_REL_L2:
        raise AssertionError(f"phase 18 (d): parameters {rel_d:.3g} from "
                             f"(a)'s stacked reference, bound "
                             f"{COMPILED_REL_L2}")

    def steps_of(reps):
        return [max(max(t[i] for t in rep["times"]) for rep in reps)
                for i in range(STEPS)]
    lines = []
    for leg, label in (("o", "off"), ("n", f"on, K = {P18_K}")):
        st = steps_of(res[leg])
        lines.append(
            f"phase 18 (a) ({card}): np=4 as 2 processes x 2 rank threads "
            f"over gloo, bypass {label}: step ms "
            f"{[round(t * 1e3, 2) for t in st]}, steady "
            f"{_steady_ms(st):.2f} ms = {P18_NP * P18_BATCH * 1e3 / _steady_ms(st):.1f} img/s; "
            f"busy share of one profiled step per process "
            f"{[round(rep['busy'], 3) for rep in res[leg]]}; coordinator "
            f"requests (ready + poll) a step per process {req[leg]}; "
            f"ms a step in the armed cycles' votes and executions "
            f"{[[round(q['bypass_s'] * 1e3, 1) for q in rep['per_step']] for rep in res[leg]]}; "
            f"bypass hits / fallbacks per process "
            f"{[[sum(q['hits'] for q in rep['per_step']), sum(q['fallbacks'] for q in rep['per_step'])] for rep in res[leg]]}; "
            f"peak memory per process {[rep['peak'] for rep in res[leg]]} B;"
            f" B1 launches per process "
            f"{[rep['launches']['pack_scale_cast'] + rep['launches']['unpack_scale_cast'] for rep in res[leg]]}")
    for line in lines:
        log(line)
    log(f"phase 18 (a): the 2 x 2 runs' parameters bit for bit each other "
        f"with the bypass off and on (every rank of both runs), "
        f"{rel_a:.3g} (relative "
        f"L2) from the 4-rank-thread stacked run (bound {COMPILED_REL_L2}; "
        f"stacked steady {_steady_ms(ref_steps):.2f} ms, busy "
        f"{ref['busy']:.3f})")
    log(f"phase 18 (b): the collective matrix exact at 2 x 2 "
        f"({[len(c) for rep in res['m4'] for c in rep['checks']]} checks a "
        f"rank) and at np=3 as -H localhost:2,127.0.0.1:1 "
        f"({[len(c) for rep in res['m3'] for c in rep['checks']]}); B2/B3 "
        f"launches per process "
        f"{[(rep['launches']['quantize_blockwise'], rep['launches']['dequantize_blockwise']) for rep in res['m4'] + res['m3']]}")
    log(f"phase 18 (c): --ranks-per-worker 2 at np=2 (one process, "
        f"{res['c'][0]['backend']} over a group of one, two stacked rows): "
        f"parameters bit for bit phase 4's; steady "
        f"{res['c'][0]['steady_s'] * 1e3:.2f} ms, busy "
        f"{res['c'][0]['busy']:.3f}")
    dst = [max(rep["times"][i] for rep in res["d"]) for i in range(STEPS)]
    log(f"phase 18 (d): the compiled step at 2 x 2 over gloo "
        f"({res['d'][0]['rules']}): step ms "
        f"{[round(t * 1e3, 2) for t in dst]}, steady {_steady_ms(dst):.2f} "
        f"ms; busy {res['d'][0]['busy']:.3f}; parameters {rel_d:.3g} from "
        f"(a)'s "
        f"stacked reference; host ms in the compiled group a step "
        f"{[[round(v, 1) for v in rep['coll_ms']] for rep in res['d']]}; "
        f"peak memory per process {[rep['peak'] for rep in res['d']]} B")
    log(f"phase 18 ({card}): job walls (s) "
        f"{ {k: round(v, 1) for k, v in walls.items()} }; "
        f"{time.perf_counter() - t_phase:.1f} s in all")
    launches = {}
    for key, reps in res.items():
        launches[key] = [rep["launches"] for rep in reps]
    return {"launches": launches,
            "steady_ms": {leg: _steady_ms(steps_of(res[leg]))
                          for leg in runs}}


def _rel_l2(a, b):
    num = sum(float((a[k].float() - b[k].float()).norm()) ** 2 for k in b)
    den = sum(float(v.float().norm()) ** 2 for v in b.values())
    return math.sqrt(num / den)


def stub_ssh_calls(log_dir):
    """The stub ssh's calls so far, each its argv (without ``ssh``)."""
    calls = []
    for name in sorted(os.listdir(log_dir)):
        if name.startswith("call."):
            with open(os.path.join(log_dir, name), "rb") as f:
                calls.append([a.decode() for a in f.read().split(b"\0")[:-1]])
    return calls


def phase_remote(dev, card, state, batches, phase4_params):
    """Phase 19: workers on a remote host, spawned by the port's
    ``launch_procs`` through ``ssh`` with the env handoff on stdin.  The
    remote end is :data:`STUB_SSH`, first on the launcher's PATH for the
    two jobs only, so the numbers are this card's and loopback's, not a
    network's.  (a) Phase 16 (b)'s job (``chip_smoke.py --worker16 b``:
    np=2 over gloo on cuda:0, phase 4's weights and batches, full-width
    ResNet-50 bf16 through ``DistributedOptimizer``, 6 steps) with ``-H
    localhost:1,192.0.2.1:1``: exit codes [0, 0]; exactly one ssh call,
    for the remote host, with no secret in its argv; rank 1's rendezvous
    address the launcher's ``local_ip()``, its forwarded keys present and
    the launcher-only key absent; the processes' parameters bit for bit
    each other and within ``COMPILED_REL_L2`` of phase 4's; B1 launched in
    both.  (b) The engine self-check (``selfcheck.run_engine_selfcheck``)
    at np=4 over ``-H localhost:2,192.0.2.1:2`` on cuda:0 over gloo, two
    workers through ssh: every assert of its worker holds (the slot
    table's local and cross ranks and sizes among them), exit 0 within
    ``P19_TIMEOUT``."""
    import torch
    from horovod_tpu_torch.runner.hosts import (
        get_host_assignments, parse_hosts)
    from horovod_tpu_torch.runner.http.http_server import local_ip
    from horovod_tpu_torch.runner.proc_run import launch_procs
    from horovod_tpu_torch.selfcheck import run_engine_selfcheck

    xs, ys = batches
    t_phase = time.perf_counter()
    old_path = os.environ.get("PATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        stub_dir = os.path.join(tmp, "stub")
        logs = {leg: os.path.join(tmp, f"log_{leg}") for leg in "ab"}
        os.makedirs(stub_dir)
        for d in logs.values():
            os.makedirs(d)
        torch.save(state, os.path.join(tmp, "state.pt"))
        for r in range(NP):
            torch.save((torch.from_numpy(xs[r]), torch.from_numpy(ys[r])),
                       os.path.join(tmp, f"batch{r}.pt"))
        cvd = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
        walls = {}
        os.environ[P19_LAUNCHER_ONLY] = "1"
        try:
            with open(os.path.join(stub_dir, "ssh"), "w") as f:
                f.write(STUB_SSH.format(log=logs["a"]))
            os.chmod(os.path.join(stub_dir, "ssh"), 0o755)
            os.environ["PATH"] = stub_dir + os.pathsep + old_path
            t0 = time.perf_counter()
            codes = launch_procs(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--worker16", "b", tmp], np=NP, hosts=P19_HOSTS_A,
                env={**_GLOO, "HVD16_T_LAUNCH": repr(time.time()),
                     "CUDA_VISIBLE_DEVICES": cvd, "PYTHONPATH": ROOT},
                start_timeout=P19_TIMEOUT)
            walls["a"] = time.perf_counter() - t0
            if codes != [0] * NP:
                raise AssertionError(f"phase 19 (a): workers exited {codes}")
            reps = [json.load(open(os.path.join(tmp, f"b_{r}.json")))
                    for r in range(NP)]
            params = [torch.load(os.path.join(tmp, f"b_params{r}.pt"))
                      for r in range(NP)]
            with open(os.path.join(stub_dir, "ssh"), "w") as f:
                f.write(STUB_SSH.format(log=logs["b"]))
            t0 = time.perf_counter()
            run_engine_selfcheck(4, start_timeout=P19_TIMEOUT,
                                 device="cuda:0", hosts=P19_HOSTS_B,
                                 env=_GLOO)
            walls["b"] = time.perf_counter() - t0
        finally:
            os.environ["PATH"] = old_path
            os.environ.pop(P19_LAUNCHER_ONLY, None)
        calls = {leg: stub_ssh_calls(d) for leg, d in logs.items()}

    # (a)
    secret = reps[1]["env"]["HOROVOD_SECRET_KEY"]
    if len(calls["a"]) != 1 or P19_REMOTE not in calls["a"][0] \
            or any(secret in arg for arg in calls["a"][0]):
        raise AssertionError(f"phase 19 (a): ssh calls {calls['a']}")
    env1 = reps[1]["env"]
    want = {"HOROVOD_GLOO_RENDEZVOUS_ADDR": local_ip(),
            "HOROVOD_HOSTNAME": P19_REMOTE, "HOROVOD_GPU_OPERATIONS": "gloo",
            "CUDA_VISIBLE_DEVICES": cvd, "PYTHONPATH": ROOT,
            P19_LAUNCHER_ONLY: None}
    bad = {k: (env1[k], v) for k, v in want.items() if env1[k] != v}
    if bad or reps[0]["env"][P19_LAUNCHER_ONLY] != "1":
        raise AssertionError(f"phase 19 (a): rank 1's environment (got, "
                             f"want) {bad}; rank 0's launcher-only key "
                             f"{reps[0]['env'][P19_LAUNCHER_ONLY]}")
    p0, p1 = params
    diff = [k for k in p0 if not torch.equal(p0[k], p1[k])]
    if diff:
        raise AssertionError(f"phase 19 (a): the two processes' parameters "
                             f"differ: {diff[:5]}")
    rel_a = _rel_l2(p0, phase4_params)
    if not rel_a <= COMPILED_REL_L2:
        raise AssertionError(f"phase 19 (a): parameters {rel_a:.3g} "
                             f"(relative L2) from phase 4's, bound "
                             f"{COMPILED_REL_L2}")
    b1 = [rep["launches"]["pack"] + rep["launches"]["unpack"]
          for rep in reps]
    if min(b1) <= 0:
        raise AssertionError(f"phase 19 (a): B1 launches per process {b1}")
    # (b): the slot table the workers held their topology to
    slots = get_host_assignments(parse_hosts(P19_HOSTS_B), 4)
    table = [(s.hostname, s.local_rank, s.local_size, s.cross_rank,
              s.cross_size) for s in slots]
    if {s[2] for s in table} != {2} or {s[4] for s in table} != {2}:
        raise AssertionError(f"phase 19 (b): slot table {table}")
    if len(calls["b"]) != 2 or any(P19_REMOTE not in c for c in calls["b"]):
        raise AssertionError(f"phase 19 (b): ssh calls {calls['b']}")

    step_s = [max(rep["times"][i] for rep in reps) for i in range(STEPS)]
    timed = sorted(t for i, t in enumerate(step_s)
                   if i > 0 and i != STEPS - 2)
    med = timed[len(timed) // 2] if len(timed) % 2 else \
        0.5 * (timed[len(timed) // 2 - 1] + timed[len(timed) // 2])
    log(f"phase 19 (a) ({card}): np=2 over gloo on cuda:0 with -H "
        f"{P19_HOSTS_A}, rank 1 through the stub ssh: step times (s) "
        f"{[round(t, 4) for t in step_s]}; steady median {med * 1e3:.2f} "
        f"ms/step = {NP * BATCH / med:.1f} img/s; rank 0's busy share of "
        f"one profiled step {reps[0]['busy_share']:.3f}; s to the first "
        f"step from the launch {[round(rep['to_first_step_s'], 2) for rep in reps]}"
        f"; B1 launches per process {b1}; replicas bit for bit, "
        f"{rel_a:.3g} (relative L2) from phase 4's (bound "
        f"{COMPILED_REL_L2}); one ssh call for {P19_REMOTE}, no secret in "
        f"its argv; rank 1's rendezvous address "
        f"{env1['HOROVOD_GLOO_RENDEZVOUS_ADDR']} (the launcher's "
        f"local_ip()), store {env1['HOROVOD_TPU_COORDINATOR']}")
    log(f"phase 19 (b) ({card}): the engine self-check at np=4 on cuda:0 "
        f"over gloo with -H {P19_HOSTS_B}, two workers through the stub "
        f"ssh: every assert held; slot table (host, local rank, local "
        f"size, cross rank, cross size) {table}")
    log(f"phase 19 ({card}): job walls (s) "
        f"{ {k: round(v, 1) for k, v in walls.items()} }; "
        f"{time.perf_counter() - t_phase:.1f} s in all")
    return {"launches": b1, "steady_ms": med * 1e3}


def phase17_report(card, res, params, refs, walls, b16_ms):
    """Phase 17's checks across the processes and against the earlier
    phases (each worker already held its own leg: captures, replays,
    uncaptured twins, digests, the engine's sums), and its lines.
    ``refs``: phase 12 (a)'s and (b)'s parameters and steady seconds,
    the plain step's seconds, phase 14 (a) int8's parameters and state
    bytes per rank (f32 and int8), phase 14 (d)'s dense LM steady
    seconds, phase 7's losses and steady seconds.  Returns each kernel's
    launches per phase-17 leg and process."""
    import torch
    rep = {leg: res[leg]["reports"] for leg in "efghijk"}
    name = f"phase 17 ({card})"
    # (e)
    e = rep["e"][0]
    e_ms = _steady_ms(e["times"])
    rel_e = _rel_l2(params["e"], refs["a_params"])
    bit_e = all(torch.equal(params["e"][k], refs["a_params"][k])
                for k in refs["a_params"])
    log(f"{name} (e) np=1 NCCL, bench.py's 128 staged images: losses "
        f"{e['losses']} (= uncaptured, bit for bit, with the parameters); "
        f"1 capture, {e['replays']} replays; collectives a step "
        f"{e['colls']} (issued at warm-up, recorded at capture, none at "
        f"the replays: NCCL inside the graph); programs by rule "
        f"{e['rules']}; steady {e_ms:.2f} ms/step = "
        f"{2 * BATCH / e_ms * 1e3:.1f} img/s; x "
        f"{e_ms / (refs['a_steady_s'] * 1e3):.3f} phase 12 (a) "
        f"({refs['a_steady_s'] * 1e3:.2f} ms), x "
        f"{e_ms / (refs['plain_s'] * 1e3):.3f} the plain step; busy share "
        f"{e['busy']:.3f}; warm-up + capture {e['compile_s']:.2f} s; "
        f"parameters {'bit for bit' if bit_e else 'not bit for bit'} "
        f"phase 12 (a)'s, relative L2 {rel_e:.3g}; peak "
        f"{e['peak']} B")
    # (f)
    f = rep["f"][0]
    f_ms = _steady_ms(f["times"])
    n_tok = LM_BATCH * LM["max_seq_len"]
    log(f"{name} (f) np=1 NCCL, the 436M LM in one graph: losses "
        f"{f['losses']} vs phase 7's eager {f['ref']} (max |gap| "
        f"{f['gap']:.3g}, bound {P17_LM_LOSS}); flash launches per step "
        f"{f['per_step']} (warm-up, capture, then none: the replays run "
        f"them inside the graph, the profiled replay ran {f['ran']}); "
        f"collectives a step {f['colls']}; steady {f_ms:.2f} ms/step = "
        f"{n_tok / f_ms * 1e3:.1f} tok/s = {f['tflops']:.1f} model "
        f"TFLOP/s; x {f_ms / (refs['lm7_steady_s'] * 1e3):.3f} phase 7's "
        f"eager step, x {f_ms / (refs['lm14_steady_s'] * 1e3):.3f} phase "
        f"14 (d)'s dense step at 2 rank threads; busy share "
        f"{f['busy']:.3f}; warm-up + capture {f['compile_s']:.2f} s; peak "
        f"{f['peak']} B")
    g = rep["g"][0]
    log(f"{name} (g) np=1 NCCL: CompiledGroupedAllreduce(force_program) "
        f"over the {g['n']} ResNet-50 gradients bit for bit the engine's "
        f"grouped_allreduce; B1 launches {g['b1']}")
    # (h): replicas, and phase 12 (b)
    h0, h1 = params["h"]
    diff = [k for k in h0 if not torch.equal(h0[k], h1[k])]
    if diff:
        raise AssertionError(f"{name} (h): replicas differ: {diff[:5]}")
    rel_h = _rel_l2(h0, refs["b_params"])
    bit_h = all(torch.equal(h0[k], refs["b_params"][k])
                for k in refs["b_params"])
    if not bit_h and not rel_h <= COMPILED_REL_L2:
        raise AssertionError(f"{name} (h): {rel_h:.3g} from phase 12 "
                             f"(b)'s parameters (bound {COMPILED_REL_L2})")
    h = rep["h"]
    h_ms = max(_steady_ms(x["times"]) for x in h)
    log(f"{name} (h) np=2 processes, gloo on CUDA (uncaptured by the "
        f"rule; programs by rule {h[0]['rules']}): replicas bit for bit; "
        f"parameters {'bit for bit' if bit_h else 'not bit for bit'} "
        f"phase 12 (b)'s (relative L2 {rel_h:.3g}); losses "
        f"{h[0]['losses']}; steady {h_ms:.2f} ms/step = "
        f"{NP * BATCH / h_ms * 1e3:.1f} img/s (x "
        f"{h_ms / b16_ms:.3f} phase 16 (b)'s eager step); busy "
        f"share {h[0]['busy']:.3f}; host ms in the compiled group's "
        f"collectives a step "
        f"{[[round(v, 2) for v in x['coll_ms']] for x in h]}, collectives "
        f"a step {h[0]['colls']}; peak per process "
        f"{[x['peak'] for x in h]} B")
    # (i): replicas, f32 against (h), int8 against phase 14 (a)
    i = rep["i"]
    for wire in ("f32", "int8"):
        p0, p1 = params["i" + wire]
        diff = [k for k in p0 if not torch.equal(p0[k], p1[k])]
        if diff:
            raise AssertionError(f"{name} (i) {wire}: replicas differ: "
                                 f"{diff[:5]}")
        sb = [x[wire]["state_bytes"] for x in i]
        want_sb = refs["state_bytes"][wire]
        if sb != want_sb:
            raise AssertionError(f"{name} (i) {wire}: optimizer state "
                                 f"{sb} B a process, phase 14's {want_sb}")
        if wire == "f32":
            d = max_delta(p0, h0)
            line = (f"max |delta| {d:.3g} from (h)'s (bound "
                    f"{SHARDED_PARAM_BOUND}; bit for bit: "
                    f"{not _same(p0, h0)})")
            if d > SHARDED_PARAM_BOUND:
                raise AssertionError(f"{name} (i) f32: {line}")
        else:
            bad = _same(p0, refs["i8_params"])
            line = (f"{'bit for bit' if not bad else 'NOT bit for bit'} "
                    f"phase 14 (a) int8's")
            if bad:
                d = max_delta(p0, refs["i8_params"])
                raise AssertionError(f"{name} (i) int8: parameters differ "
                                     f"from phase 14 (a)'s at {bad[:5]} "
                                     f"(max |delta| {d:.3g})")
        ms = max(_steady_ms(x[wire]["times"]) for x in i)
        log(f"{name} (i) sharded {wire}, np=2 gloo: replicas bit for bit; "
            f"parameters {line}; optimizer state per process {sb} B (= "
            f"phase 14's per rank); losses {i[0][wire]['losses']}; steady "
            f"{ms:.2f} ms/step = {NP * BATCH / ms * 1e3:.1f} img/s (x "
            f"{ms / h_ms:.3f} (h)); collectives a step "
            f"{i[0][wire]['colls']}, host ms in them "
            f"{[[round(v, 2) for v in x[wire]['coll_ms']] for x in i]}")
    log(f"{name} (i): peak device memory per process {[x['peak'] for x in i]}"
        f" B (both wires' legs)")
    j = rep["j"]
    log(f"{name} (j) CompiledAlltoall at ep = 2 across the processes on "
        f"phase 15 (b)'s slots: f32, int8, int4 (two calls, error "
        f"feedback) equal phase 15 (b)'s exchanges by digest; ms per "
        f"exchange {[x['ms'] for x in j]}; B2-B5 per process "
        f"{[x['codec'] for x in j]}; .stream over the ResNet-50 gradients "
        f"({j[0]['buckets']} buckets of {COMPILED_BUCKET_BYTES} B, pushed "
        f"in backward order) bit for bit the engine's grouped_allreduce; "
        f"B1 {[x['b1'] for x in j]}")
    k = rep["k"]
    log(f"{name} (k): the mismatched signature raised ValueError on both "
        f"processes after {[round(x['raised_s'], 3) for x in k]} s (timeout "
        f"{P17_SIG_TIMEOUT} s): {k[0]['error']}")
    log(f"{name}: job walls (s) {walls}")
    out = {"launches": {leg: [x["launches"] for x in rep[leg]]
                        for leg in "efghijk"},
           "e_ms": e_ms, "f_ms": f_ms, "h_ms": h_ms}
    return out


# ---------------------------------------------------------------------------
# phase 20: elastic training

def _b1_launches():
    from horovod_tpu_torch.ops import cuda_kernels as K
    return sum(K.launches[k] for k in ("fused_scale_cast", "pack_scale_cast",
                                       "unpack_scale_cast"))


def _elastic_snapshot(model, opt):
    """A replica's parameters and momentum buffers, on the CPU, by name."""
    return {"params": {k: p.detach().cpu() for k, p in
                       model.named_parameters()},
            "momentum": {k: opt.state[p]["momentum_buffer"].detach().cpu()
                         for k, p in model.named_parameters()
                         if "momentum_buffer" in opt.state.get(p, {})}}


def _snapshot_digest(snap):
    """One digest over every tensor of a snapshot: replicas compare
    exactly across processes."""
    import hashlib
    h = hashlib.sha256()
    for part in ("params", "momentum"):
        for k in sorted(snap[part]):
            h.update(f"{part}/{k}:{_digest(snap[part][k])}".encode())
    return h.hexdigest()


def phase20_worker(leg, tmp):
    """One process of a phase-20 job (``chip_smoke.py --worker20 <leg>
    <dir>``), spawned by the port's elastic driver for a slot: phase 4's
    full-width bf16 ResNet-50 (weights and batches from ``dir``) through
    ``DistributedOptimizer(SGD, momentum 0.9)`` inside
    ``hvd_torch.elastic.run`` with ``TorchState(model, optimizer,
    batch=0)``, a commit after every step, ``STEPS`` steps, rank r
    training on batch r.  A round of one process averages its gradients
    through the engine itself (``grouped_allreduce_``: the optimizer
    reduces nothing at one process), so B1 runs in every round.  It
    reports through ``events_<host>.jsonl`` and ``commits.log`` in
    ``dir``; a failure exits non-zero.  Leg ``k`` (phase 21 (b)) is leg
    ``a`` whose failure comes from the fault plan's ``kill`` instead of
    the worker's own exit; it logs the plan's collectives counter at
    each step's start."""
    import torch
    sys.path.insert(0, ROOT)
    import horovod_tpu_torch as hvd
    t_start = time.time()
    hvd.init(device=torch.device("cuda:0"))
    import torch.nn.functional as F
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.exceptions import (
        HorovodInternalError, HostsUpdatedInterrupt)
    from horovod_tpu_torch import chaos
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import cuda_kernels as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    dev = hvd.device()
    host = os.environ["HOROVOD_HOSTNAME"]
    events = open(os.path.join(tmp, f"events_{host}.jsonl"), "a")

    def ev(kind, **kw):
        events.write(json.dumps({"ev": kind, "t": time.time(),
                                 "pid": os.getpid(),
                                 "round": basics._elastic_round,
                                 **kw}) + "\n")
        events.flush()

    ev("start", t_start=t_start, rank=hvd.rank(), size=hvd.size())
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16).to(dev)
    model.load_state_dict(torch.load(os.path.join(tmp, "state.pt")))
    opt = hvd_torch.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    st = hvd_torch.elastic.TorchState(model=model, optimizer=opt, batch=0)
    st.register_reset_callbacks([lambda: ev(
        "reset", batch=st.batch, rank=hvd.rank(), size=hvd.size())])
    data = [tuple(t.to(dev) for t in torch.load(
        os.path.join(tmp, f"batch{r}.pt"))) for r in range(NP)]
    params = list(model.parameters())
    marker = os.path.join(tmp, "exited")
    K.reset_launches()

    @hvd_torch.elastic.run
    def train(st):
        digested = False
        while st.batch < STEPS:
            step, r, s = st.batch, hvd.rank(), hvd.size()
            if leg == "k":
                # the fault plan's collectives counter at the step's start
                ev("begin", step=step, rank=r, size=s,
                   coll=chaos.current()._collectives, b1=_b1_launches())
            if leg == "a" and step == 3 and s == 2 and host == P20_DYING \
                    and not os.path.exists(marker):
                open(marker, "w").close()
                ev("exit", step=step, rank=r, size=s, b1=_b1_launches())
                os._exit(P20_EXIT)
            if leg == "b" and step == 3 and s == 2 and not digested:
                # what the newcomer's sync made of the replicas
                digested = True
                ev("digest", step=step, rank=r, digest=_snapshot_digest(
                    _elastic_snapshot(model, opt)))
            x, y = step_batch(*data[r], step)
            torch.cuda.synchronize()
            t0 = time.time()
            try:
                opt.zero_grad()
                loss = F.cross_entropy(model(x), y)
                loss.backward()
                if s == 1:
                    hvd.grouped_allreduce_([p.grad for p in params],
                                           name="p20.grads")
                opt.step()
                torch.cuda.synchronize()
            except HorovodInternalError as exc:
                ev("internal_error", step=step, rank=r, size=s,
                   error=str(exc)[:300])
                raise
            ev("step", step=step, rank=r, size=s, t0=t0,
               ms=(time.time() - t0) * 1e3, loss=float(loss.detach()))
            st.batch += 1
            t1 = time.time()
            try:
                st.commit()
                ev("commit", step=step, ms=(time.time() - t1) * 1e3)
                with open(os.path.join(tmp, "commits.log"), "a") as f:
                    f.write(f"committed {step} size {s} host {host}\n")
                if leg == "b" and step == 2 and s == 1:
                    # hold at this commit until the driver's new round
                    # (the discovery script adds the second host on
                    # reading the line above) reaches this worker
                    deadline = time.monotonic() + P20_HOLD_S
                    while time.monotonic() < deadline:
                        st.check_host_updates()
                        time.sleep(0.02)
                    raise AssertionError(
                        f"phase 20 (b): no new round within {P20_HOLD_S} s")
            except HostsUpdatedInterrupt:
                ev("interrupt", step=step, rank=r, size=s)
                raise

    train(st)
    snap = _elastic_snapshot(model, opt)
    torch.save(snap, os.path.join(tmp, f"final_{host}.pt"))
    ev("done", rank=hvd.rank(), size=hvd.size(), b1=_b1_launches(),
       digest=_snapshot_digest(snap))
    hvd.shutdown()
    return 0


def p20_job(leg, tmp):
    """One elastic job through the port's CLI, in a session of its own
    so that every process it starts is stopped at the end.  Returns
    (exit code, stderr, wall seconds)."""
    import signal
    disc = os.path.join(tmp, "discover.sh")
    with open(disc, "w") as f:
        f.write(P20_DISCOVERY[leg].format(tmp=tmp))
    os.chmod(disc, 0o755)
    cmd = [sys.executable, "-c", P20_LAUNCHER, *P20_LEGS[leg],
           "--host-discovery-script", disc,
           "--blacklist-cooldown-range", "600", "600",
           "--start-timeout", "120", "--", sys.executable,
           os.path.join(ROOT, "chip_smoke.py"), "--worker20", leg, tmp]
    env = {**os.environ, **_GLOO, "PYTHONPATH": ROOT,
           "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES",
                                                  "0")}
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=P20_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        raise AssertionError(f"phase 20 ({leg}): the job outlived "
                             f"{P20_TIMEOUT} s; stderr:\n{err[-4000:]}")
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return p.returncode, out + err, time.perf_counter() - t0


def p20_replay(dev, state, batches, sizes):
    """The job's six steps in this process: steps 0-2 at ``sizes[0]``
    rank threads, then steps 3-5 at ``sizes[1]`` from the state the
    first segment left (rank r on batch r, a one-rank segment averaging
    through the engine as the workers do).  Returns the final snapshot."""
    import copy
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.models.resnet import ResNet50

    xs, ys = batches
    carry = {"model": state}

    def segment(steps, np_):
        def fn():
            r = hvd.rank()
            model = ResNet50(num_classes=1000, dtype=torch.bfloat16).to(dev)
            model.load_state_dict(carry["model"])
            opt = hvd_torch.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
                named_parameters=model.named_parameters())
            if "opt" in carry:
                # a copy each: load_state_dict keeps the tensors it is
                # given, and two ranks must not share momentum buffers
                opt.load_state_dict(copy.deepcopy(carry["opt"]))
            params = list(model.parameters())
            x0 = torch.from_numpy(xs[r]).to(dev)
            y0 = torch.from_numpy(ys[r]).to(dev)
            for step in steps:
                x, y = step_batch(x0, y0, step)
                opt.zero_grad()
                loss = F.cross_entropy(model(x), y)
                loss.backward()
                if np_ == 1:
                    hvd.grouped_allreduce_([p.grad for p in params],
                                           name="p20.grads")
                opt.step()
            torch.cuda.synchronize()
            if r == 0:
                return ({k: v.detach().cpu().clone()
                         for k, v in model.state_dict().items()},
                        copy.deepcopy(opt.state_dict()),
                        _elastic_snapshot(model, opt))
            return None
        out = hvd.run(fn, np=np_, device=dev)[0]
        carry["model"], carry["opt"], snap = out
        return snap

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        segment(range(3), sizes[0])
        return segment(range(3, STEPS), sizes[1])
    finally:
        torch.backends.cudnn.deterministic = det


def p20_change_error(got, want, init):
    """Relative L2 distance of what the six steps changed in the job
    (``got``) from what they changed in the replay (``want``): parameters
    final minus initial, momentum (zero at the start) as it ends; and
    whether the two are bit for bit."""
    num = den = 0.0
    exact = True
    for part in ("params", "momentum"):
        if set(got[part]) != set(want[part]):
            raise AssertionError(f"phase 20: {part} names differ")
        for k, w in want[part].items():
            g = got[part][k]
            exact = exact and torch_equal(g, w)
            base = init[k].to(w.dtype).float() if part == "params" \
                else 0.0
            dg, dw = g.float() - base, w.float() - base
            num += float((dg - dw).norm()) ** 2
            den += float(dw.norm()) ** 2
    return math.sqrt(num / den), exact


def _p20_events(tmp, host):
    path = os.path.join(tmp, f"events_{host}.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _p20_rounds(log_text):
    """(round, size) of every round the driver started, from its log."""
    import re
    return [(int(m.group(1)), int(m.group(2))) for m in re.finditer(
        r"round (\d+): (\d+) workers", log_text)]


def _median(v):
    v = sorted(v)
    if not v:
        return float("nan")
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def phase_elastic(dev, card, state, batches):
    """Phase 20: elastic training through the port's ``horovodrun``
    (``--min-np``/``--max-np``/``--host-discovery-script``), two jobs of
    ``chip_smoke.py --worker20`` on cuda:0 over gloo.  (a) ``-np 2
    --min-np 1 --max-np 2``, discovery ``localhost:1`` and
    ``127.0.0.1:1``: in round 1 the worker on 127.0.0.1 exits 17 before
    step 3's allreduce; the job exits 0 after exactly one more round, of
    size 1, with 127.0.0.1 blacklisted, and the survivor ran steps 3-5 at
    size 1 from the commit after step 2.  (b) ``-np 1 --min-np 1
    --max-np 2``, discovery adding 127.0.0.1:1 once step 2 is committed:
    the first worker takes ``HostsUpdatedInterrupt`` at that commit and
    re-initializes in place (one start, one pid), the newcomer's
    ``TorchState.sync`` leaves the replicas bit for bit the same before
    step 3 and at the end, steps 3-5 run at size 2, the job exits 0.  In
    both, what the six steps changed (parameters and momentum) is within
    ``P20_REL_L2`` of an in-process replay (a: 2 rank threads then 1;
    b: 1 then 2), bit for bit or not as printed."""
    import torch
    xs, ys = batches
    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for leg in "ab":
            d = os.path.join(tmp, leg)
            os.makedirs(d)
            torch.save(state, os.path.join(d, "state.pt"))
            for r in range(NP):
                torch.save((torch.from_numpy(xs[r]),
                            torch.from_numpy(ys[r])),
                           os.path.join(d, f"batch{r}.pt"))
            code, text, wall = p20_job(leg, d)
            with open(os.path.join(d, "commits.log")) as f:
                commits = f.read()
            res[leg] = {
                "code": code, "text": text, "wall": wall,
                "commits": commits,
                "events": {h: _p20_events(d, h)
                           for h in ("localhost", P20_DYING)},
                "final": {h: torch.load(os.path.join(d, f"final_{h}.pt"))
                          for h in ("localhost", P20_DYING)
                          if os.path.exists(os.path.join(d, f"final_{h}.pt"))},
                "t_change": float(open(os.path.join(d, "t_change")).read())
                if os.path.exists(os.path.join(d, "t_change")) else None}
            if code != 0:
                raise AssertionError(
                    f"phase 20 ({leg}): the job exited {code}; log:\n"
                    f"{text[-6000:]}")
    torch.cuda.empty_cache()
    replay = {"a": p20_replay(dev, state, batches, (2, 1)),
              "b": p20_replay(dev, state, batches, (1, 2))}
    out = {"launches": {}, "steady_ms": {}}
    for leg in "ab":
        r = res[leg]
        rounds = _p20_rounds(r["text"])
        ev = r["events"]
        steps = {h: [e for e in ev[h] if e["ev"] == "step"] for h in ev}
        by_round = {}
        for h in ev:
            for e in steps[h]:
                by_round.setdefault((e["round"], e["size"]), []).append(
                    e["ms"])
        step_ms = {f"round {k[0]} (size {k[1]})": round(_median(v), 2)
                   for k, v in sorted(by_round.items())}
        commit_ms = _median([e["ms"] for h in ev for e in ev[h]
                             if e["ev"] == "commit"])
        # the next round's first step begins once its last process is in
        first_next = max(min(e["t0"] for e in steps[h] if e["round"] == 2)
                         for h in ev
                         if any(e["round"] == 2 for e in steps[h]))
        done = {h: [e for e in ev[h] if e["ev"] == "done"] for h in ev}
        b1 = {h: (done[h] or [e for e in ev[h] if e["ev"] == "exit"]
                  or [{"b1": 0}])[-1]["b1"] for h in ev}
        resets = {h: [e for e in ev[h] if e["ev"] == "reset"] for h in ev}
        if leg == "a":
            surv = ev["localhost"]
            exits = [e for e in ev[P20_DYING] if e["ev"] == "exit"]
            late = [(e["step"], e["size"], e["round"])
                    for e in steps["localhost"] if e["step"] >= 3]
            bad = []
            if rounds != [(1, 2), (2, 1)]:
                bad.append(f"rounds {rounds}")
            if "blacklisting host 127.0.0.1" not in r["text"]:
                bad.append("127.0.0.1 was not blacklisted")
            if len(exits) != 1 or exits[0]["step"] != 3:
                bad.append(f"exits {exits}")
            if late != [(3, 1, 2), (4, 1, 2), (5, 1, 2)]:
                bad.append(f"survivor's steps 3-5 (step, size, round) "
                           f"{late}")
            if [e["batch"] for e in resets["localhost"]] != [3]:
                bad.append(f"survivor's resets {resets['localhost']}")
            if bad:
                raise AssertionError("phase 20 (a): " + "; ".join(bad))
            t_event = exits[0]["t"]
            final = r["final"]["localhost"]
            pids = sorted({e["pid"] for e in surv})
        else:
            first = ev["localhost"]
            starts = [e for e in first if e["ev"] == "start"]
            intr = [e for e in first if e["ev"] == "interrupt"]
            digs = [e["digest"] for h in ev for e in ev[h]
                    if e["ev"] == "digest"]
            ends = [done[h][-1]["digest"] for h in ev if done[h]]
            late = sorted((e["step"], e["size"], e["round"])
                          for h in ev for e in steps[h] if e["step"] >= 3)
            bad = []
            if rounds != [(1, 1), (2, 2)]:
                bad.append(f"rounds {rounds}")
            if len(starts) != 1 or len({e["pid"] for e in first}) != 1:
                bad.append(f"the first worker started {len(starts)} times "
                           f"with pids {sorted({e['pid'] for e in first})}")
            if [(e["step"], e["size"]) for e in intr] != [(2, 1)]:
                bad.append(f"interrupts {intr}")
            if len(digs) != 2 or len(set(digs)) != 1:
                bad.append(f"replicas after the sync: digests {digs}")
            if len(ends) != 2 or len(set(ends)) != 1:
                bad.append(f"final replicas: digests {ends}")
            if late != sorted([(s, 2, 2) for s in (3, 4, 5)] * 2):
                bad.append(f"steps 3-5 (step, size, round) {late}")
            if bad:
                raise AssertionError("phase 20 (b): " + "; ".join(bad))
            t_event = r["t_change"]
            final = r["final"]["localhost"]
            pids = sorted({e["pid"] for e in first})
        err, exact = p20_change_error(final, replay[leg], state)
        if not err <= P20_REL_L2:
            raise AssertionError(
                f"phase 20 ({leg}): the change is {err:.3g} (relative L2) "
                f"from the replay's, bound {P20_REL_L2}")
        to_next = first_next - t_event
        out["launches"][leg] = [b1["localhost"], b1[P20_DYING]]
        out["steady_ms"][leg] = step_ms
        log(f"phase 20 ({leg}) ({card}): rounds (round, size) {rounds}; "
            f"resets {[(e['batch'], e['size']) for h in ev for e in resets[h]]} "
            f"(batch restored or kept, new size); median step ms by round "
            f"{step_ms}; median commit ms {commit_ms:.1f} (save and spill); "
            f"{to_next:.2f} s from the "
            f"{'worker exit' if leg == 'a' else 'discovery change'} to the "
            f"next round's first step; first worker's pids {pids}; B1 "
            f"launches (localhost, 127.0.0.1) {out['launches'][leg]}; "
            f"change vs the replay {err:.3g} (relative L2, bound "
            f"{P20_REL_L2}), bit for bit: {exact}; job wall {r['wall']:.1f} s")
    log(f"phase 20 ({card}): {time.perf_counter() - t_phase:.1f} s")
    out["replay_a"] = replay["a"]
    return out


def phase21_worker(label, tmp):
    """One process of a phase-21 (a) job (``chip_smoke.py --worker21
    <label> <dir>``): phase 4's full-width bf16 ResNet-50 through
    ``DistributedOptimizer(SGD, momentum 0.9, groups=1)``, rank r on
    batch r, ``P21_STEPS`` steps, then ``hvd.barrier()``.  In the
    faulted job (label ``f``) rank 0 sends the coordinator one ``clock``
    request once the bypass armed (from a thread of its own, so that its
    steps go on), the plan's ``coord_restart`` trigger.  Reports to
    ``<label>_<rank>.json`` and ``<label>_final<rank>.pt``."""
    import threading
    import torch
    sys.path.insert(0, ROOT)
    import horovod_tpu_torch as hvd
    t_start = time.time()
    hvd.init(device=torch.device("cuda:0"))
    import torch.nn.functional as F
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import cuda_kernels as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    dev = hvd.device()
    r = hvd.rank()
    eng = hvd.engine()
    ctl = eng.controller
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16).to(dev)
    model.load_state_dict(torch.load(os.path.join(tmp, "state.pt")))
    opt = hvd_torch.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(), groups=1)
    x0, y0 = (t.to(dev) for t in torch.load(os.path.join(
        tmp, f"batch{r}.pt")))
    K.reset_launches()
    steps, t_clock = [], None
    for step in range(P21_STEPS):
        x, y = step_batch(x0, y0, step)
        torch.cuda.synchronize()
        t0 = time.time()
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        t1 = time.time()
        steps.append({"step": step, "t0": t0, "t1": t1,
                      "ms": (t1 - t0) * 1e3, "hits": eng.bypass_hits,
                      "loss": float(loss.detach())})
        if label == "f" and r == 0 and t_clock is None \
                and eng.bypass_hits >= 1:
            t_clock = time.time()
            threading.Thread(target=ctl.client.coord,
                             args=("clock", {}), daemon=True).start()
    t_barrier = time.time()
    hvd.barrier()
    t_reply = time.time()
    snap = _elastic_snapshot(model, opt)
    torch.save(snap, os.path.join(tmp, f"{label}_final{r}.pt"))
    out = {"rank": r, "t_start": t_start, "steps": steps,
           "t_clock": t_clock, "t_barrier": t_barrier, "t_reply": t_reply,
           "epoch": ctl.epoch, "agg_epoch": ctl.agg_epoch,
           "via_agg": getattr(ctl.client, "via_agg", None),
           "hits": eng.bypass_hits, "fallbacks": eng.bypass_fallbacks,
           "requests": dict(ctl.client.coord_requests),
           "b1": _b1_launches(), "digest": _snapshot_digest(snap)}
    with open(os.path.join(tmp, f"{label}_{r}.json"), "w") as f:
        json.dump(out, f)
    hvd.shutdown()
    return 0


def _p21_job(label, tmp):
    """One phase-21 (a) job through ``launch_procs`` in this process (the
    coordinator, its journal and its fault runner live here); the
    faulted one (``f``) with ``P21_PLAN``.  Returns the workers' reports
    and the job's wall seconds."""
    from horovod_tpu_torch.runner.proc_run import launch_procs
    env = {**_GLOO, "PYTHONPATH": ROOT,
           "HOROVOD_CONTROL_PLANE_TIER": "host",
           "HOROVOD_BYPASS_AFTER_CYCLES": str(P21_K)}
    if label == "f":
        env.update({
            "HOROVOD_FAULT_PLAN": json.dumps(P21_PLAN),
            "HOROVOD_COORD_JOURNAL": os.path.join(tmp, "journal.jsonl"),
            "HOROVOD_FAULT_COORD_LOG": os.path.join(tmp, "coord.log"),
            "HOROVOD_FAULT_AGG_LOG": os.path.join(tmp, "agg.log")})
    t0 = time.perf_counter()
    codes = launch_procs(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--worker21",
         label, tmp], np=NP, env=env, start_timeout=P21_TIMEOUT)
    wall = time.perf_counter() - t0
    if codes != [0] * NP:
        raise AssertionError(f"phase 21 (a) job {label}: workers exited "
                             f"{codes}")
    reps = []
    for r in range(NP):
        with open(os.path.join(tmp, f"{label}_{r}.json")) as f:
            reps.append(json.load(f))
    return reps, wall


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def phase_chaos(dev, card, state, batches, replay_a):
    """Phase 21: the control plane's faults from seeded fault plans (see
    the module docstring).  (a) ``P21_PLAN``'s job and the undisturbed
    one; (b) phase 20 (a)'s elastic job with its kill from
    ``P21_KILL_PLAN``, held to phase 20 (a)'s replay (``replay_a``)."""
    import re
    import torch
    xs, ys = batches
    t_phase = time.perf_counter()
    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(state, os.path.join(tmp, "state.pt"))
        for r in range(NP):
            torch.save((torch.from_numpy(xs[r]), torch.from_numpy(ys[r])),
                       os.path.join(tmp, f"batch{r}.pt"))
        faulted, wall_f = _p21_job("f", tmp)
        calm, wall_c = _p21_job("u", tmp)
        coord = _jsonl(os.path.join(tmp, "coord.log"))
        agg = _jsonl(os.path.join(tmp, "agg.log"))
        journal = _jsonl(os.path.join(tmp, "journal.jsonl"))
    bad = []
    if [(c["kind"], c["n"]) for c in coord] != [("coord_restart", 1.0)]:
        bad.append(f"coordinator faults {coord}")
    if [(a["kind"], a["n"], a["agg"]) for a in agg] != \
            [("agg_restart", 10.0, 0)]:
        bad.append(f"aggregator faults {agg}")
    if bad:
        raise AssertionError("phase 21 (a): " + "; ".join(bad))
    t_stop, t_start = coord[0]["t_stop"], coord[0]["t_start"]
    digests = {d for rep in faulted + calm for d in [rep["digest"]]}
    # steps that ended while the coordinator was down
    during = [[s["step"] for s in rep["steps"]
               if t_stop < s["t1"] < t_start] for rep in faulted]
    unarmed = [[s["step"] for s in rep["steps"]
                if t_stop < s["t1"] < t_start and s["hits"] < 1]
               for rep in faulted]
    dead = [rec for rec in journal if rec.get("k") == "log"
            and rec["r"].get("kind") == "dead"]
    epochs = [rec["epoch"] for rec in journal if rec.get("k") == "epoch"]
    if len(digests) != 1:
        bad.append(f"replicas differ: digests {sorted(digests)}")
    # a worker is on the aggregator's successor (agg_epoch 2), or fell
    # back to the coordinator (no agg_epoch) if the outage outlasted its
    # retries
    if any(rep["epoch"] != 2 or (rep["agg_epoch"], rep["via_agg"])
           not in ((2, True), (None, False)) for rep in faulted):
        bad.append(f"epochs after the faults (coord, agg, via the "
                   f"aggregator) {[(rep['epoch'], rep['agg_epoch'], rep['via_agg']) for rep in faulted]}")
    if epochs != [1, 2]:
        bad.append(f"journal epochs {epochs}")
    if dead:
        bad.append(f"declared dead: {dead}")
    if not all(during) or any(unarmed):
        bad.append(f"steps during the outage {during}, unarmed {unarmed}")
    if dev.type == "cuda" and not all(rep["b1"] > 0
                                      for rep in faulted + calm):
        bad.append(f"B1 launches per process "
                   f"{[rep['b1'] for rep in faulted + calm]}")
    if bad:
        raise AssertionError("phase 21 (a): " + "; ".join(bad))
    out["launches"]["a"] = {"faulted": [rep["b1"] for rep in faulted],
                            "undisturbed": [rep["b1"] for rep in calm]}
    ms = {lbl: [[round(s["ms"], 2) for s in rep["steps"]] for rep in reps]
          for lbl, reps in (("faulted", faulted), ("undisturbed", calm))}
    # the barrier is each rank's first negotiated request after the
    # steps: its reply, counted from the restart (or from the barrier's
    # own start when the coordinator was back before it)
    first_reply = [round(rep["t_reply"] - max(t_start, rep["t_barrier"]),
                         3) for rep in faulted]
    log(f"phase 21 (a) ({card}): np=2 over gloo on cuda:0, "
        f"--control-plane-tier host, bypass after {P21_K} cycles, "
        f"{P21_STEPS} steps; step ms per rank {ms}; aggregator outage "
        f"{agg[0]['t_start'] - agg[0]['t_stop']:.3f} s; coordinator "
        f"outage {t_start - t_stop:.3f} s (restart from the journal, "
        f"epochs {epochs}); s from the restart to the first reply (each "
        f"rank's barrier, from its start if later) {first_reply}; steps during the outage per "
        f"rank {during} (ended while it was down), all armed; epochs after "
        f"(coord, agg, via the aggregator) "
        f"{[(rep['epoch'], rep['agg_epoch'], rep['via_agg']) for rep in faulted]}; "
        f"bypass hits / fallbacks {[(rep['hits'], rep['fallbacks']) for rep in faulted]}; "
        f"coordinator requests per rank {[rep['requests'] for rep in faulted]}; "
        f"declared dead: none; replicas bit for bit each other and the "
        f"undisturbed job's; B1 launches per process {out['launches']['a']}; "
        f"job walls {wall_f:.1f} / {wall_c:.1f} s")

    # (b) the elastic job with its kill from the plan
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "k")
        os.makedirs(d)
        torch.save(state, os.path.join(d, "state.pt"))
        for r in range(NP):
            torch.save((torch.from_numpy(xs[r]), torch.from_numpy(ys[r])),
                       os.path.join(d, f"batch{r}.pt"))
        code, text, wall = p20_job("k", d)
        if code != 0:
            raise AssertionError(f"phase 21 (b): the job exited {code}; "
                                 f"log:\n{text[-6000:]}")
        ev = {h: _p20_events(d, h) for h in ("localhost", P20_DYING)}
        final_path = os.path.join(d, "final_localhost.pt")
        final = torch.load(final_path) if os.path.exists(final_path) \
            else None
    rounds = _p20_rounds(text)
    fired = [{"kind": m.group(1), "event": int(m.group(2)),
              "trigger": m.group(3), "n": int(m.group(4))}
             for m in re.finditer(
                 r"chaos: injecting (\w+) \(event #(\d+), (\w+)=(\d+), "
                 r"proc 0\)", text)]
    begins = [e for e in ev[P20_DYING] if e["ev"] == "begin"]
    late = [(e["step"], e["size"], e["round"]) for e in ev["localhost"]
            if e["ev"] == "step" and e["step"] >= 3]
    resets = [e["batch"] for e in ev["localhost"] if e["ev"] == "reset"]
    dying_done = [e for e in ev[P20_DYING] if e["ev"] == "done"]
    bad = []
    if rounds != [(1, 2), (2, 1)]:
        bad.append(f"rounds {rounds}")
    if "blacklisting host 127.0.0.1" not in text:
        bad.append("127.0.0.1 was not blacklisted")
    if fired != [{"kind": "kill", "event": 0, "trigger": "collectives",
                  "n": P21_KILL_AT}]:
        bad.append(f"fired {fired}")
    if not begins or (begins[-1]["step"], begins[-1]["coll"]) != \
            (3, P21_KILL_AT - 1) or dying_done:
        bad.append(f"the killed worker's last step start "
                   f"{begins[-1:] if begins else None}, done {dying_done}")
    if late != [(3, 1, 2), (4, 1, 2), (5, 1, 2)]:
        bad.append(f"survivor's steps 3-5 (step, size, round) {late}")
    if resets != [3]:
        bad.append(f"survivor's resets {resets}")
    if final is None:
        bad.append("no final state from the survivor")
    if bad:
        raise AssertionError("phase 21 (b): " + "; ".join(bad) +
                             f"; log:\n{text[-3000:]}")
    err, exact = p20_change_error(final, replay_a, state)
    if not exact:
        raise AssertionError(f"phase 21 (b): the survivor is not bit for "
                             f"bit the replay ({err:.3g} relative L2)")
    done = [e for e in ev["localhost"] if e["ev"] == "done"]
    out["launches"]["b"] = [done[-1]["b1"], begins[-1]["b1"]]
    exit_t = max(e["t"] for e in begins)
    first_next = min(e["t0"] for e in ev["localhost"]
                     if e["ev"] == "step" and e["round"] == 2)
    log(f"phase 21 (b) ({card}): phase 20 (a)'s elastic job, the failure "
        f"from the plan's kill (after_collectives {P21_KILL_AT}); rounds "
        f"{rounds}; the killed injector's fired record {fired} (from its "
        f"log line: SIGKILL follows the record at once); its last step "
        f"start {(begins[-1]['step'], begins[-1]['coll'])} (step, "
        f"collectives); survivor's resets {resets}, steps 3-5 {late}; "
        f"{first_next - exit_t:.2f} s from the killed worker's last step "
        f"start to the survivor's next step; bit for bit phase 20 (a)'s "
        f"replay: {exact}; B1 launches (survivor, the killed worker at its "
        f"last step start) {out['launches']['b']}; "
        f"job wall {wall:.1f} s")
    log(f"phase 21 ({card}): {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 22

def swap_batch_norm(model, make):
    """Every ``models.resnet.BatchNorm`` of ``model`` replaced by
    ``make(channels)`` carrying its ``weight``, ``bias`` and running
    statistics (the port's momentum 0.9 on the old value is torch's 0.1;
    eps 1e-5 both)."""
    import torch
    from horovod_tpu_torch.models.resnet import BatchNorm

    for mod in list(model.modules()):
        for name, child in list(mod.named_children()):
            if isinstance(child, BatchNorm):
                bn = make(child.weight.numel()).to(child.weight.device,
                                                   child.weight.dtype)
                with torch.no_grad():
                    bn.weight.copy_(child.weight)
                    bn.bias.copy_(child.bias)
                    bn.running_mean.copy_(child.running_mean)
                    bn.running_var.copy_(child.running_var)
                setattr(mod, name, bn)
    return model


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _rel_all(got, want):
    """Relative L2 of two lists of tensors taken as one vector, in f64."""
    num = sum(float((a.double() - b.double()).norm()) ** 2
              for a, b in zip(got, want))
    den = sum(float(b.double().norm()) ** 2 for b in want)
    return math.sqrt(num / den)


def as_f64(model):
    """``model`` (a ``models.resnet.ResNet``) computing in f64: its
    parameters and buffers in f64, its convolutions in f64, and its head
    fed f64 (the model's own forward feeds it f32)."""
    import torch
    import torch.nn.functional as F

    model.double()
    for mod in model.modules():
        if hasattr(mod, "dtype"):
            mod.dtype = torch.float64
    head = model.head
    head.forward = lambda x: F.linear(x.double(), head.weight, head.bias)
    return model


def p22_resnet_ranks(dev, state, batches, steps, op=None, sync_bn=False,
                     f64=False, keep=(0,)):
    """``steps`` steps of the f32 (``f64``: f64) ResNet-50 at 2 rank
    threads through ``DistributedOptimizer(SGD, momentum 0.9)`` with
    ``op`` (and, with ``sync_bn``, every BatchNorm swapped for
    ``SyncBatchNorm``, each rank's backward on its own thread).  Returns
    per rank the losses, step times, step 1's local gradients, the
    reduced gradients of each step in ``keep`` (0-based), and the final
    parameters and buffers, with B1's launches."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.models.resnet import ResNet50

    xs, ys = batches
    out = {}

    def train():
        r = hvd.rank()
        model = ResNet50(num_classes=1000, dtype=torch.float32).to(dev)
        model.load_state_dict(state)
        if f64:
            as_f64(model)
        if sync_bn:
            swap_batch_norm(model, hvd_torch.SyncBatchNorm)
        params = list(model.parameters())
        local = {}
        capture = [p.register_post_accumulate_grad_hook(
            lambda p, i=i: local.__setitem__(i, p.grad.clone()))
            for i, p in enumerate(params)]
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(params, lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters(),
            op=op if op is not None else hvd.Average)
        x0 = torch.from_numpy(xs[r]).to(dev)
        y0 = torch.from_numpy(ys[r]).to(dev)
        losses, times, reduced = [], [], {}
        with torch.autograd.set_multithreading_enabled(not sync_bn):
            for step in range(steps):
                x, y = step_batch(x0, y0, step)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                opt.zero_grad()
                loss = F.cross_entropy(model(x), y)
                loss.backward()
                for h in capture:
                    h.remove()
                capture = []
                if step in keep:
                    opt.synchronize()
                    reduced[step] = [p.grad.clone() for p in params]
                    with opt.skip_synchronize():
                        opt.step()
                else:
                    opt.step()
                losses.append(float(loss.detach()))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        out[r] = {"losses": losses, "times": times,
                  "local": [local[i] for i in range(len(params))],
                  "reduced": reduced,
                  "state": {k: v.detach().clone()
                            for k, v in model.state_dict().items()}}

    b1 = _b1_launches()
    hvd.run(train, np=NP, device=dev)
    out["b1"] = _b1_launches() - b1
    return out


def p22_adasum_reference(local):
    """Per tensor, ``adasum_reduce`` of the two ranks' local gradients."""
    import torch
    from horovod_tpu_torch.ops.adasum import adasum_reduce
    return [adasum_reduce(torch.stack([a.reshape(-1), b.reshape(-1)]))
            .view(a.shape) for a, b in zip(local[0], local[1])]


def p22_adasum_compiled(dev, state, batches):
    """``make_compiled_train_step(op=Adasum)`` on the f32 ResNet-50 at 2
    rank threads, ``P22_STEPS`` steps (step 1 warms up, step 2 captures,
    the rest replay).  Returns the parameters after step 1 and at the end
    per rank, the losses, the program."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.parallel.train import sgd

    xs, ys = batches
    with torch.device("meta"):
        names = {k for k, _ in ResNet50(num_classes=1000).named_parameters()}
    params = {k: v for k, v in state.items() if k in names}
    aux = {k: v for k, v in state.items() if k not in names}
    out = {"progs": []}

    def train():
        r = hvd.rank()
        with torch.device("meta"):
            model = ResNet50(num_classes=1000, dtype=torch.float32)

        def loss_fn(p, a, batch):
            x, y = batch
            logits = torch.func.functional_call(model, {**p, **a}, (x,))
            return F.cross_entropy(logits, y), a

        step = hvd.make_compiled_train_step(
            loss_fn, sgd(0.1, momentum=0.9), has_aux=True, op=hvd.Adasum)
        st = step.init_state(params, aux=aux)
        x0 = torch.from_numpy(xs[r]).to(dev)
        y0 = torch.from_numpy(ys[r]).to(dev)
        losses, times, first = [], [], None
        for i in range(P22_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, loss = step(st, step_batch(x0, y0, i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            if i == 0:
                first = {k: v.detach().clone()
                         for k, v in st["params"].items()}
        out["progs"].append(step._prog)
        out[r] = {"first": first, "losses": [float(v) for v in losses],
                  "times": times,
                  "final": {k: v.detach().clone()
                            for k, v in st["params"].items()}}

    b1 = _b1_launches()
    hvd.run(train, np=NP, device=dev)
    out["b1"] = _b1_launches() - b1
    out["prog"] = next(p for p in out.pop("progs") if p is not None)
    return out


def p22_plain_bn_steps(dev, state, batches, steps, f64=False):
    """``steps`` plain single-process steps (SGD, momentum 0.9, as
    ``p22_resnet_ranks``) of the f32 (``f64``: f64) ResNet-50 with every
    BatchNorm swapped for ``torch.nn.BatchNorm2d``, each on the 128 images
    of both ranks' batches of that step: the losses and each step's
    gradients."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.models.resnet import ResNet50

    xs, ys = batches
    model = ResNet50(num_classes=1000, dtype=torch.float32).to(dev)
    model.load_state_dict(state)
    if f64:
        as_f64(model)
    swap_batch_norm(model, torch.nn.BatchNorm2d)
    params = list(model.parameters())
    opt = torch.optim.SGD(params, lr=0.1, momentum=0.9)
    losses, grads = [], []
    for step in range(steps):
        pairs = [step_batch(torch.from_numpy(a).to(dev),
                            torch.from_numpy(b).to(dev), step)
                 for a, b in zip(xs, ys)]
        x = torch.cat([p[0] for p in pairs])
        y = torch.cat([p[1] for p in pairs])
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append([p.grad.clone() for p in params])
        opt.step()
    return losses, grads


def p22_sparse(dev, sparse_as_dense):
    """``P22_STEPS - 1`` SGD steps of an ``nn.Embedding(32000, 1024,
    sparse=True)``, a mean over positions and a linear head, at 2 rank
    threads on 5 x 2048 seeded tokens each.  Returns per rank the losses,
    the final weights and the step times, with B1's launches."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch

    cfg = P22_SPARSE
    rng = np.random.default_rng(SEED + 22)
    emb0 = rng.standard_normal((cfg["vocab"], cfg["width"]),
                               dtype=np.float32) * np.float32(0.02)
    head0 = rng.standard_normal((cfg["classes"], cfg["width"]),
                                dtype=np.float32) * np.float32(0.02)
    tokens = [rng.integers(0, cfg["vocab"], size=(LM_BATCH, LM["max_seq_len"]))
              for _ in range(NP)]
    labels = [rng.integers(0, cfg["classes"], size=LM_BATCH)
              for _ in range(NP)]
    out = {}

    def train():
        r = hvd.rank()
        emb = torch.nn.Embedding(cfg["vocab"], cfg["width"],
                                 sparse=True).to(dev)
        head = torch.nn.Linear(cfg["width"], cfg["classes"],
                               bias=False).to(dev)
        with torch.no_grad():
            emb.weight.copy_(torch.from_numpy(emb0))
            head.weight.copy_(torch.from_numpy(head0))
        named = [("emb.weight", emb.weight), ("head.weight", head.weight)]
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD([emb.weight, head.weight], lr=cfg["lr"]),
            named_parameters=named, sparse_as_dense=sparse_as_dense)
        tok = torch.from_numpy(tokens[r]).to(dev)
        lab = torch.from_numpy(labels[r]).to(dev)
        losses, times, kinds = [], [], set()
        for step in range(P22_STEPS - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = F.cross_entropy(head(emb(tok).mean(dim=1)), lab)
            loss.backward()
            kinds.add(emb.weight.grad.is_sparse)
            opt.step()
            losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[r] = {"losses": losses, "times": times, "sparse": kinds,
                  "emb": emb.weight.detach().clone(),
                  "head": head.weight.detach().clone()}

    b1 = _b1_launches()
    hvd.run(train, np=NP, device=dev)
    out["b1"] = _b1_launches() - b1
    out["emb0"] = torch.from_numpy(emb0)
    out["head0"] = torch.from_numpy(head0)
    return out


def p22_lm_leg(dev, weights, tokens, policy, profile=False):
    """``P22_LM_STEPS`` steps of phase 7's LM through
    ``make_lm_train_step(fused_ce=True)``, remat ``policy`` (None: off).
    Returns the losses, step 1's gradients (copied to the host, so that
    they hold no device memory in the steps after), the step times, the
    caching allocator's ``cudaMalloc`` calls a step, flash launches per
    step, the peak memory above what the process held before the steps
    (the model, and whatever earlier phases left), and the allocator's
    retries over the steps.  With ``profile`` the last step runs under
    torch.profiler (its tables printed) and is left out of the times."""
    import torch
    from horovod_tpu_torch.models.transformer import TransformerConfig
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.parallel import make_lm_train_step

    cfg = TransformerConfig(dtype=torch.bfloat16, remat=policy is not None,
                            remat_policy=policy or "full", **LM)
    init, step = make_lm_train_step(cfg, attention_impl="flash", device=dev,
                                    fused_ce=True)
    state = init(weights)
    tok = torch.from_numpy(tokens).to(dev)
    names = [n for n, _ in FLASH]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    free_before = torch.cuda.mem_get_info()[0]
    held = torch.cuda.memory_allocated()
    stats0 = torch.cuda.memory_stats()
    losses, times, mallocs, per_step, grads = [], [], [], [], None
    for i in range(P22_LM_STEPS):
        prof = None
        if profile and i == P22_LM_STEPS - 1:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        before = [FA.launches[n] for n in names]
        m0 = torch.cuda.memory_stats().get("num_device_alloc", 0)
        t0 = time.perf_counter()
        state, loss = step(state, tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mallocs.append(torch.cuda.memory_stats().get("num_device_alloc", 0)
                       - m0)
        if prof is None:
            times.append(wall)
        else:
            prof.__exit__(None, None, None)
            log(f"phase 22 (d) {policy or 'no remat'}: profiled step "
                f"{wall * 1e3:.2f} ms")
            profile_summary(prof, wall)
        per_step.append([FA.launches[n] - b for n, b in zip(names, before)])
        losses.append(float(loss))
        if i == 0:
            grads = [p.grad.detach().cpu()
                     for p in state["model"].parameters()]
    peak = torch.cuda.max_memory_allocated() - held
    stats = torch.cuda.memory_stats()
    retries = stats.get("num_alloc_retries", 0) - stats0.get(
        "num_alloc_retries", 0)
    del state
    return {"cfg": cfg, "losses": losses, "grads": grads, "times": times,
            "mallocs": mallocs, "per_step": per_step, "peak": peak,
            "retries": retries, "free_before": free_before}


def phase_frontend(dev, card, state, batches, lm, profile=False):
    """Phase 22 (see the module docstring).  Returns B1's launches per
    leg of (a)-(c), the flash kernels' per step of each (d) leg, and
    under ``"others"`` the launches of B2-B5 and B9-B10 over the whole
    phase (0: none of them is on its path)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import flash_attention as FA

    t_phase = time.perf_counter()
    launches, failed = {}, []
    others = [n for n, *_ in CODEC] + [n for n, _ in CONV_BN]
    counts0 = wrapper_counts()
    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    saved_env = {k: os.environ.get(k) for k in (
        "HOROVOD_FUSION_THRESHOLD", "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS")}
    os.environ["HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"] = str(P22_STALL_S)
    try:
        # (a) Adasum, eager at the default fusion, then one tensor a bucket
        fused = p22_resnet_ranks(dev, state, batches, P22_STEPS,
                                 op=hvd.Adasum)
        os.environ["HOROVOD_FUSION_THRESHOLD"] = "0"
        try:
            single = p22_resnet_ranks(dev, state, batches, P22_STEPS,
                                      op=hvd.Adasum)
        finally:
            os.environ.pop("HOROVOD_FUSION_THRESHOLD")
        ref = p22_adasum_reference([single[0]["local"],
                                    single[1]["local"]])
        names = [k for k, _ in _resnet_named_params()]
        for label, run in (("default fusion", fused),
                           ("fusion threshold 0", single)):
            for r in range(NP):
                if not all(math.isfinite(v) for v in run[r]["losses"]):
                    raise AssertionError(f"phase 22 (a) {label}: rank {r} "
                                         f"non-finite loss")
                if not run[r]["losses"][-1] < run[r]["losses"][0]:
                    raise AssertionError(
                        f"phase 22 (a) {label}: rank {r}'s loss did not "
                        f"fall: {run[r]['losses']}")
            # the parameters (each rank's BatchNorm statistics are its own)
            diff = [k for k in names
                    if not torch.equal(run[0]["state"][k],
                                       run[1]["state"][k])]
            if diff:
                raise AssertionError(f"phase 22 (a) {label}: replicas "
                                     f"differ: {diff[:5]}")
        bad = [i for i, (g, want) in enumerate(zip(single[0]["reduced"][0],
                                                   ref))
               if not torch.equal(g, want)
               or not torch.equal(single[1]["reduced"][0][i], want)]
        if bad:
            raise AssertionError(
                f"phase 22 (a): with fusion off, {len(bad)} reduced "
                f"gradients differ from the per-tensor adasum_reduce "
                f"(first: parameter {bad[0]})")
        if not all(torch.equal(a, b) for a, b in
                   zip(fused[0]["local"], single[0]["local"])):
            raise AssertionError("phase 22 (a): step 1's local gradients "
                                 "differ between the two eager runs")
        bucket_gap = max(_rel(g, w)
                         for g, w in zip(fused[0]["reduced"][0], ref))
        comp = p22_adasum_compiled(dev, state, batches)
        prog = comp["prog"]
        if prog.captures != 1:
            raise AssertionError(f"phase 22 (a) compiled: {prog.captures} "
                                 f"captures, want 1")
        first = comp[0]["first"]
        gaps = []
        for k, g in zip(names, ref):
            p0 = state[k].to(dev)
            want = p0.add(g, alpha=-0.1)
            moved = float((first[k].double() - p0.double()).norm())
            gaps.append(float((first[k].double() - want.double()).norm())
                        / max(moved, 1e-300))
        exact = all(torch.equal(first[k], state[k].to(dev).add(
            g, alpha=-0.1)) for k, g in zip(names, ref))
        if max(gaps) > P22_COMPILED_REL_L2:
            raise AssertionError(
                f"phase 22 (a) compiled: step 1's update {max(gaps):.3g} "
                f"from the per-leaf reference (bound "
                f"{P22_COMPILED_REL_L2})")
        if not all(torch.equal(comp[0]["final"][k], comp[1]["final"][k])
                   for k in names):
            raise AssertionError("phase 22 (a) compiled: replicas differ")
        if not comp[0]["losses"][-1] < comp[0]["losses"][0]:
            raise AssertionError(f"phase 22 (a) compiled: the loss did not "
                                 f"fall: {comp[0]['losses']}")
        launches["a"] = {"default": fused["b1"], "fusion0": single["b1"],
                         "compiled": comp["b1"]}
        for label, run in (("default fusion", fused),
                           ("fusion threshold 0", single)):
            t = [max(run[r]["times"][i] for r in range(NP))
                 for i in range(P22_STEPS)]
            log(f"phase 22 (a) Adasum eager, {label}: losses rank0 "
                f"{run[0]['losses']} rank1 {run[1]['losses']}; step times "
                f"(s) {[round(v, 4) for v in t]}; B1 launches {run['b1']}; "
                f"replicas bit for bit")
        log(f"phase 22 (a): fusion off, step 1's reduced gradients bit for "
            f"bit the per-tensor adasum_reduce of the ranks' local "
            f"gradients ({len(ref)} tensors); at the default fusion the "
            f"per-bucket combine lies up to {bucket_gap:.4g} (relative L2, "
            f"a tensor) from it")
        log(f"phase 22 (a) Adasum compiled, one CUDA graph (captures "
            f"{prog.captures}, replays {prog.replays}): losses "
            f"{comp[0]['losses']}; step times (s) "
            f"{[round(v, 4) for v in comp[0]['times']]}; step 1's update "
            f"{max(gaps):.3g} from the per-leaf reference (bound "
            f"{P22_COMPILED_REL_L2}; bit for bit: {exact}); replicas bit "
            f"for bit; B1 launches {comp['b1']}; {card}")
        del fused, single, comp, ref
        gc.collect()
        torch.cuda.empty_cache()

        # (b) SyncBatchNorm against plain steps on the 128 images, in f32
        # and in f64 (the f64 plain steps are the truth both f32 runs are
        # read against)
        runs = {}
        for f64 in (False, True):
            steps = P22_STEPS - 1 if not f64 else 2
            sbn = p22_resnet_ranks(dev, state, batches, steps, sync_bn=True,
                                   f64=f64, keep=(0, 1))
            diff = [k for k in sbn[0]["state"]
                    if not torch.equal(sbn[0]["state"][k],
                                       sbn[1]["state"][k])]
            if diff:
                raise AssertionError(
                    f"phase 22 (b) {'f64' if f64 else 'f32'}: replicas "
                    f"(parameters or running statistics) differ: "
                    f"{diff[:5]}")
            plain_losses, plain_grads = p22_plain_bn_steps(
                dev, state, batches, 2, f64=f64)
            runs[f64] = {"sbn": sbn, "losses": plain_losses,
                         "grads": plain_grads}
        # every reading is printed before a failed bound fails the phase
        # (at its end, after (c) and (d)).  f64: the loss and the
        # gradients, over all parameters and each nonzero tensor, within
        # P22_SYNC_BN_F64 of the plain steps.  f32: the loss within
        # P22_SYNC_BN_REL_L2 at both steps; step 1's gradients within
        # P22_SYNC_BN_REL_L2 over all parameters and each nonzero tensor
        # within P22_SYNC_BN_TENSOR; at both steps SyncBatchNorm's
        # gradients no further from the f64 plain step's, over all
        # parameters, than P22_SYNC_BN_VS_PLAIN times the f32 plain
        # step's own distance from it.  A tensor 0 in a plain step is 0.
        truth = runs[True]["grads"]
        for f64, run in runs.items():
            label = "f64" if f64 else "f32"
            sbn = run["sbn"]
            for step in (0, 1):
                got, want = sbn[0]["reduced"][step], run["grads"][step]
                loss = sum(sbn[r]["losses"][step] for r in range(NP)) / NP
                loss_gap = abs(loss - run["losses"][step]) / abs(
                    run["losses"][step])
                glob = _rel_all(got, want)
                nonzero = [i for i, w in enumerate(want) if bool(w.any())]
                zero_bad = [names[i] for i, g in enumerate(got)
                            if i not in nonzero and bool(g.any())]
                gaps = {i: _rel(got[i], want[i]) for i in nonzero}
                worst = max(gaps, key=gaps.get)
                med = sorted(gaps.values())[len(gaps) // 2]
                line = (f"phase 22 (b) {label} step {step + 1}: loss "
                        f"{loss:.9g} vs the plain BatchNorm2d step "
                        f"{run['losses'][step]:.9g} (relative "
                        f"{loss_gap:.3g}); gradients relative L2 over all "
                        f"parameters {glob:.3g}; {len(nonzero)} nonzero "
                        f"tensors: worst {gaps[worst]:.3g} "
                        f"({names[worst]}), median {med:.3g}; "
                        f"{len(want) - len(nonzero)} tensors 0 in both")
                if f64:
                    bad = max(loss_gap, glob, gaps[worst]) > P22_SYNC_BN_F64
                    line += f" (bound {P22_SYNC_BN_F64} on each)"
                else:
                    # each f32 run against the f64 truth
                    e_sbn = {i: _rel(got[i], truth[step][i])
                             for i in nonzero}
                    e_cud = {i: _rel(want[i], truth[step][i])
                             for i in nonzero}
                    ws = max(e_sbn, key=e_sbn.get)
                    wc = max(e_cud, key=e_cud.get)
                    mid = len(nonzero) // 2
                    far_s = _rel_all(got, truth[step])
                    far_c = _rel_all(want, truth[step])
                    bad = loss_gap > P22_SYNC_BN_REL_L2 \
                        or far_s > P22_SYNC_BN_VS_PLAIN * far_c
                    if step == 0:
                        bad = bad or glob > P22_SYNC_BN_REL_L2 \
                            or gaps[worst] > P22_SYNC_BN_TENSOR
                        line += (f" (bounds {P22_SYNC_BN_REL_L2} on the "
                                 f"loss and over all parameters, "
                                 f"{P22_SYNC_BN_TENSOR} a tensor)")
                    else:
                        line += f" (bound {P22_SYNC_BN_REL_L2} on the loss)"
                    line += (f"; against the f64 plain step, over all "
                             f"parameters: SyncBatchNorm {far_s:.3g}, "
                             f"BatchNorm2d {far_c:.3g} (x "
                             f"{far_s / far_c:.3g}; bound x "
                             f"{P22_SYNC_BN_VS_PLAIN}); a tensor at the "
                             f"median SyncBatchNorm "
                             f"{sorted(e_sbn.values())[mid]:.3g}, "
                             f"BatchNorm2d "
                             f"{sorted(e_cud.values())[mid]:.3g}; worst "
                             f"SyncBatchNorm {e_sbn[ws]:.3g} "
                             f"({names[ws]}), BatchNorm2d {e_cud[wc]:.3g} "
                             f"({names[wc]}); at the f32 gap's worst "
                             f"tensor SyncBatchNorm {e_sbn[worst]:.3g}, "
                             f"BatchNorm2d {e_cud[worst]:.3g}")
                if bad or zero_bad:
                    failed.append(f"{line}; nonzero where the plain step "
                                  f"is 0: {zero_bad[:5]}")
                log(line + f"; {card}")
            t = [max(sbn[r]["times"][i] for r in range(NP))
                 for i in range(len(sbn[0]["times"]))]
            log(f"phase 22 (b) SyncBatchNorm {label}: losses rank0 "
                f"{sbn[0]['losses']} rank1 {sbn[1]['losses']}; parameters "
                f"and running statistics bit for bit across ranks; step "
                f"times (s) {[round(v, 4) for v in t]}; B1 launches "
                f"{sbn['b1']}; {card}")
        launches["b"] = runs[False]["sbn"]["b1"]
        launches["b f64"] = runs[True]["sbn"]["b1"]
        del runs, truth, sbn, got, want
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = old_det
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # (c) sparse gradients, on the sparse path and densified
    sp = {mode: p22_sparse(dev, mode) for mode in (False, True)}
    for mode, run in sp.items():
        label = "sparse_as_dense" if mode else "sparse"
        if run[0]["sparse"] != {True}:
            raise AssertionError(f"phase 22 (c) {label}: the embedding's "
                                 f"gradient was not sparse")
        if not (torch.equal(run[0]["emb"], run[1]["emb"])
                and torch.equal(run[0]["head"], run[1]["head"])):
            raise AssertionError(f"phase 22 (c) {label}: replicas differ")
        if not all(math.isfinite(v) for v in run[0]["losses"]):
            raise AssertionError(f"phase 22 (c) {label}: non-finite loss")
    gaps = {}
    for key in ("emb", "head"):
        w0 = sp[True][key + "0"].to(dev)
        moved = float((sp[True][0][key].double() - w0.double()).norm())
        gaps[key] = float((sp[False][0][key].double()
                           - sp[True][0][key].double()).norm()) / moved
    if max(gaps.values()) > P22_SPARSE_REL:
        raise AssertionError(f"phase 22 (c): the sparse and the dense "
                             f"path's weights differ by {gaps} of the "
                             f"change (bound {P22_SPARSE_REL})")
    launches["c"] = {"sparse": sp[False]["b1"],
                     "sparse_as_dense": sp[True]["b1"]}
    for mode, run in sp.items():
        t = [max(run[r]["times"][i] for r in range(NP))
             for i in range(P22_STEPS - 1)]
        log(f"phase 22 (c) {'sparse_as_dense' if mode else 'sparse path'}: "
            f"losses {run[0]['losses']}; step times (s) "
            f"{[round(v, 4) for v in t]}; B1 launches {run['b1']}; "
            f"replicas bit for bit")
    log(f"phase 22 (c): sparse against sparse_as_dense, difference over "
        f"the change: embedding {gaps['emb']:.3g}, head {gaps['head']:.3g} "
        f"(bound {P22_SPARSE_REL}); {card}")
    del sp
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the 436M LM through the fused loss, without and with remat
    legs, base = {}, None
    for policy in P22_POLICIES:
        leg = p22_lm_leg(dev, lm["weights"], lm["tokens"], policy,
                         profile=profile and policy in (None, "dots_flash"))
        label = policy or "no remat"
        n = leg["cfg"].n_layers
        # "full" and "dots" replay every block's flash forward in the
        # backward; "dots_flash" saves its outputs
        want = [2 * n if policy in ("full", "dots") else n, n, n]
        if any(c != want for c in leg["per_step"]):
            raise AssertionError(
                f"phase 22 (d) {label}: flash launches per step "
                f"{leg['per_step']}, want {want}")
        if leg["peak"] >= lm["step_peak"]:
            raise AssertionError(
                f"phase 22 (d) {label}: the steps' peak memory "
                f"{leg['peak']} B is not below phase 7's "
                f"{lm['step_peak']} B")
        if policy is None:
            base = leg
            if abs(leg["losses"][0] - lm["losses"][0]) > P22_LOSS_ABS:
                raise AssertionError(
                    f"phase 22 (d): the fused step-1 loss {leg['losses'][0]}"
                    f" is not within {P22_LOSS_ABS} of phase 7's "
                    f"{lm['losses'][0]}")
        else:
            same_g = all(torch.equal(a, b)
                         for a, b in zip(leg["grads"], base["grads"]))
            if leg["losses"] != base["losses"] or not same_g:
                raise AssertionError(
                    f"phase 22 (d) {label}: losses {leg['losses']} against "
                    f"{base['losses']} without remat; step 1's gradients "
                    f"bit for bit: {same_g}")
            leg["grads"] = None
        # the median of steps 2 on: a step that grows the allocator's
        # pool (cudaMalloc calls, printed) can take several times the rest
        steady = sorted(leg["times"][1:])[(len(leg["times"]) - 2) // 2]
        tok_s = LM_BATCH * LM["max_seq_len"] / steady
        tflops = lm_flops_per_token(leg["cfg"]) * tok_s / 1e12
        launches["d " + label] = leg["per_step"]
        legs[label] = (steady, tok_s, tflops, leg["peak"])
        log(f"phase 22 (d) {label}: losses {leg['losses']}; flash launches "
            f"per step {leg['per_step'][0]} (all steps equal); step times "
            f"(s) {[round(v, 4) for v in leg['times']]}; cudaMalloc calls "
            f"a step {leg['mallocs']}; median of steps 2 on "
            f"{steady * 1e3:.2f} ms/step = {tok_s:.1f} tok/s = "
            f"{tflops:.1f} model TFLOP/s (recompute not counted); peak "
            f"memory above what the process held before the steps "
            f"{leg['peak'] / 2**30:.2f} GiB against phase 7's "
            f"{lm['step_peak'] / 2**30:.2f} GiB; {leg['free_before'] / 2**30:.2f}"
            f" GiB free on the card before the steps; allocator retries "
            f"{leg['retries']}; {card}")
        del leg
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 22 (d): fused step-1 loss {base['losses'][0]} against "
        f"phase 7's {lm['losses'][0]} (|diff| "
        f"{abs(base['losses'][0] - lm['losses'][0]):.3g}, bound "
        f"{P22_LOSS_ABS}); every remat leg's losses and step-1 gradients "
        f"bit for bit the no-remat leg's; peak memory saved against phase "
        f"7: " + ", ".join(f"{k} {(lm['step_peak'] - v[3]) / 2**30:.2f} "
                           f"GiB" for k, v in legs.items()))
    del base
    gc.collect()
    torch.cuda.empty_cache()
    counts1 = wrapper_counts()
    launches["others"] = {n: counts1[n] - counts0[n] for n in others}
    if any(launches["others"].values()):
        raise AssertionError(f"phase 22: kernels off its path launched: "
                             f"{launches['others']}")
    log(f"phase 22: launches of B2-B5 and B9-B10 over the phase (read "
        f"before and after it) {launches['others']}")
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 23: the topology-aware allreduce


def _p23_counters(eng):
    return {"algo_runs": dict(eng.algo_runs),
            "logical": eng.logical_wire_bytes,
            "actual": eng.actual_wire_bytes,
            "cross": eng.cross_wire_bytes,
            "hops": {f"{h}/{w}": v for (h, w), v in
                     eng.hop_wire_bytes.items()}}


def _p23_delta(after, before):
    out = {k: after[k] - before[k] for k in ("logical", "actual", "cross")}
    out["algo_runs"] = {a: n - before["algo_runs"].get(a, 0)
                        for a, n in after["algo_runs"].items()
                        if n != before["algo_runs"].get(a, 0)}
    out["hops"] = {h: n - before["hops"].get(h, 0)
                   for h, n in after["hops"].items()
                   if n != before["hops"].get(h, 0)}
    return out


def _p23_replicas(label, ranks):
    """The rank threads' parameters, checked bit for bit each other."""
    import torch
    first = ranks[0]["params"]
    for rec in ranks[1:]:
        diff = [k for k in first
                if not torch.equal(first[k], rec["params"][k])]
        if diff:
            raise AssertionError(f"phase 23 {label}: replicas differ: "
                                 f"{diff[:5]}")
    return first


def _p23_steady_ms(times_by_rank):
    step_s = [max(t[i] for t in times_by_rank) for i in range(STEPS)]
    return _median(step_s[1:]) * 1e3, step_s


def p23_budget(dev):
    """(b)'s byte budget on its engine (the host map patched): one
    grouped hierarchical allreduce of the 161 ResNet-50 gradient shapes
    at full width on both hops, then with the int8 outer hop; returns the
    (logical, cross) byte deltas of each."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    shapes = resnet50_grad_shapes()
    eng = hvd.engine()
    out = {}
    for label, outer in (("f32", "f32"), ("int8", "int8")):
        before = _p23_counters(eng)

        def fn():
            rng = np.random.default_rng(SEED + 23 + hvd.rank())
            g = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                  * 1e-2).to(dev) for s in shapes]
            hvd.grouped_allreduce(g, name=f"p23.budget.{label}",
                                  algorithm="hierarchical",
                                  wire_dtype=outer, wire_inner="f32")
            torch.cuda.synchronize()
            return True
        hvd.run(fn, np=P18_NP, device=dev)
        out[label] = _p23_delta(_p23_counters(eng), before)
    return out


def p23_engine_run(dev, state, xs, ys, env, host_map=None, budget=False):
    """``p18_train`` at 4 rank threads in this process on an engine
    started under ``env`` (its ``Config`` reads the algorithm and the
    wires at init), with ``host_map`` patched onto the engine's topology;
    returns the run, the engine's byte and algorithm counter deltas, the
    kernels' launches and (``budget``) :func:`p23_budget`'s counts."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.topology import Topology

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        hvd.run(lambda: None, np=P18_NP, device=dev, keep_alive=True)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        eng = hvd.engine()
        if host_map is not None:
            eng.topology = Topology(size=P18_NP, host_of_rank=host_map)
        c0, w0 = _p23_counters(eng), wrapper_counts()
        got = p18_train(dev, state, xs, ys, P18_NP)
        w1 = wrapper_counts()
        got["counters"] = _p23_delta(_p23_counters(eng), c0)
        got["launches"] = {k: w1[k] - w0.get(k, 0) for k in w1}
        if budget:
            got["budget"] = p23_budget(dev)
    finally:
        hvd.shutdown()
    got["params"] = _p23_replicas("run", got["ranks"])
    got["steady_ms"], got["step_s"] = _p23_steady_ms(
        [rec["times"] for rec in got["ranks"]])
    got["losses"] = [sum(rec["losses"][i] for rec in got["ranks"])
                     / P18_NP for i in range(STEPS)]
    return got


def phase23_worker(tmp):
    """One process of phase 23 (c)'s job (``chip_smoke.py --worker23
    <dir>``): (b)'s run on this process's 2 rank threads, on the engine
    the launcher's environment configured (hierarchical, the wire pair)
    and host map (``-H``) laid out.  Reports through files in ``dir``;
    any failure exits non-zero."""
    import torch
    sys.path.insert(0, ROOT)
    import horovod_tpu_torch as hvd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    global LOG_PREFIX
    dev = torch.device("cuda:0")
    hvd.init(device=dev)
    proc = env_proc()
    LOG_PREFIX = f"[phase 23 worker, process {proc}]"
    eng = hvd.engine()
    state = torch.load(os.path.join(tmp, "state.pt"))
    base = torch.load(os.path.join(tmp, "phase4_batches.pt"))
    xs = [x.numpy() for x in base[0]]
    ys = [y.numpy() for y in base[1]]
    c0, w0 = _p23_counters(eng), wrapper_counts()
    got = p18_train(dev, state, xs, ys, eng.num_local)
    w1 = wrapper_counts()
    first = _p23_replicas(f"(c) process {proc}", got["ranks"])
    torch.save(first, os.path.join(tmp, f"params{proc}.pt"))
    out = {"proc": proc, "hosts": list(eng.topology.host_of_rank),
           "algorithm": eng.config.algorithm,
           "wires": [eng.config.wire_inner, eng.config.wire_dtype],
           "layout": [list(p) for p in
                      eng.get_process_set(0).executor.proc_positions],
           "counters": _p23_delta(_p23_counters(eng), c0),
           "launches": {k: w1[k] - w0.get(k, 0) for k in w1},
           "times": [rec["times"] for rec in got["ranks"]],
           "losses": [rec["losses"] for rec in got["ranks"]]}
    with open(os.path.join(tmp, f"w23_{proc}.json"), "w") as f:
        json.dump(out, f)
    hvd.shutdown()
    return 0


def p23_job(dev, state, batches):
    """Phase 23 (c): the launcher job through the stub ssh."""
    import torch
    from horovod_tpu_torch.runner.proc_run import launch_procs

    xs, ys = batches
    old_path = os.environ.get("PATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        stub_dir, log_dir = os.path.join(tmp, "stub"), os.path.join(tmp,
                                                                   "log")
        os.makedirs(stub_dir)
        os.makedirs(log_dir)
        torch.save(state, os.path.join(tmp, "state.pt"))
        torch.save(([torch.from_numpy(x) for x in xs],
                    [torch.from_numpy(y) for y in ys]),
                   os.path.join(tmp, "phase4_batches.pt"))
        with open(os.path.join(stub_dir, "ssh"), "w") as f:
            f.write(STUB_SSH.format(log=log_dir))
        os.chmod(os.path.join(stub_dir, "ssh"), 0o755)
        cvd = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
        os.environ["PATH"] = stub_dir + os.pathsep + old_path
        t0 = time.perf_counter()
        try:
            codes = launch_procs(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--worker23", tmp], np=P18_NP, ranks_per_proc="host",
                hosts=P23_HOSTS,
                env={**_GLOO, **P23_HIER_ENV, "CUDA_VISIBLE_DEVICES": cvd,
                     "PYTHONPATH": ROOT},
                start_timeout=P19_TIMEOUT)
        finally:
            os.environ["PATH"] = old_path
        wall = time.perf_counter() - t0
        if codes != [0, 0]:
            raise AssertionError(f"phase 23 (c): workers exited {codes}")
        reps = [json.load(open(os.path.join(tmp, f"w23_{p}.json")))
                for p in range(2)]
        params = [torch.load(os.path.join(tmp, f"params{p}.pt"))
                  for p in range(2)]
        calls = stub_ssh_calls(log_dir)
    return {"reps": reps, "params": params, "calls": calls, "wall": wall}


def p23_reducer(dev):
    """Phase 23 (d): the compiled reducer over the 161 ResNet-50 gradient
    shapes at 4 rank threads on one host (a 2 x 2 torus)."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    shapes = resnet50_grad_shapes()
    rng = np.random.default_rng(SEED + 230)
    grads = [[torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                               * 1e-2).to(dev) for s in shapes]
             for _ in range(P18_NP)]
    hint = hvd.TopologyHint(*P23_HINT)
    out = {}

    def fn():
        r = hvd.rank()
        g = grads[r]
        ref = hvd.grouped_allreduce(g, name="p23.engine", algorithm="torus")
        torus = hvd.CompiledGroupedAllreduce(algorithm="torus",
                                             name="p23.torus")
        flat = hvd.CompiledGroupedAllreduce(name="p23.flat")
        hinted = hvd.CompiledGroupedAllreduce(topology_hint=hint,
                                              name="p23.hint")
        t_ms = {"flat": [], "torus": []}
        for _ in range(3):
            for label, red in (("flat", flat), ("torus", torus)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a = red(g)
                torch.cuda.synchronize()
                t_ms[label].append((time.perf_counter() - t0) * 1e3)
        b = hinted(g)
        bad = [i for i, (x, y, z) in enumerate(zip(ref, a, b))
               if not (torch.equal(x, y) and torch.equal(x, z))]
        if bad:
            raise AssertionError(f"phase 23 (d) rank {r}: the compiled "
                                 f"torus differs from the engine's at "
                                 f"{bad[:5]}")
        if torus.last_algorithm != "torus" \
                or hinted.last_cross_bytes * 2 != hinted.last_logical_bytes:
            raise AssertionError(
                f"phase 23 (d): algorithm {torus.last_algorithm}, hint "
                f"cross {hinted.last_cross_bytes} logical "
                f"{hinted.last_logical_bytes}")
        ef = hvd.CompiledGroupedAllreduce(
            algorithm="torus", wire_dtype="int4", error_feedback=True,
            name="p23.ef")
        res, outs = [], []
        for _ in range(3):
            outs.append(ef(g))
            res.append({k: v.clone() for k, v in ef._residuals.items()})
        if not res[0] or any(set(x) != set(res[0]) for x in res) \
                or any(torch.equal(res[0][k], res[1][k]) for k in res[0]):
            raise AssertionError(f"phase 23 (d) rank {r}: the int4 "
                                 f"residuals were not carried")
        shard = [tuple(v.shape) for v in res[0].values()]
        if r == 0:
            out.update(ms=t_ms, shard=shard,
                       cross=hinted.last_cross_bytes,
                       logical=hinted.last_logical_bytes,
                       ef_moved=not all(torch.equal(x, y) for x, y in
                                        zip(outs[0], outs[1])))
        return True

    w0 = wrapper_counts()
    hvd.run(fn, np=P18_NP, device=dev)
    w1 = wrapper_counts()
    out["launches"] = {k: w1[k] - w0.get(k, 0) for k in w1}
    return out


def p23_sharded(dev, state, xs, ys, hint):
    """Phase 23 (e): ResNet-50 (bf16 compute, SGD momentum 0.9) through
    ``make_compiled_train_step(sharded=True)`` at 4 rank threads, rank r
    on ``p18_images``, 6 steps, captured; ``hint`` decomposes it."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.parallel.train import sgd

    with torch.device("meta"):
        names = {k for k, _ in ResNet50(num_classes=1000).named_parameters()}
    params = {k: v for k, v in state.items() if k in names}
    aux = {k: v for k, v in state.items() if k not in names}
    barrier = threading.Barrier(P18_NP)
    out = {}

    def train():
        r = hvd.rank()
        with torch.device("meta"):
            model = ResNet50(num_classes=1000, dtype=torch.bfloat16)

        def loss_fn(p, a, batch):
            x, y = batch
            logits = torch.func.functional_call(model, {**p, **a}, (x,))
            return F.cross_entropy(logits, y), a

        step = hvd.make_compiled_train_step(
            loss_fn, sgd(0.1, momentum=0.9), has_aux=True, sharded=True,
            topology_hint=hint)
        st = step.init_state(params, aux=aux)
        x, y = p18_images(xs, ys, r)
        x0, y0 = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        times, losses = [], []
        for i in range(STEPS):
            batch = step_batch(x0, y0, i)
            barrier.wait()
            t0 = time.perf_counter()
            st, loss = step(st, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        barrier.wait()
        if r == 0:
            out.update(times=times, losses=losses,
                       params={k: v.detach().cpu()
                               for k, v in st["params"].items()})
        # the program sits on the step object of the rank thread whose
        # call led the rendezvous, whichever that was
        return times, step._prog

    w0 = wrapper_counts()
    got = hvd.run(train, np=P18_NP, device=dev)
    w1 = wrapper_counts()
    out["launches"] = {k: w1[k] - w0.get(k, 0) for k in w1}
    out["steady_ms"], _ = _p23_steady_ms([t for t, _ in got])
    out["captures"] = getattr(next(p for _, p in got if p is not None),
                              "captures", 0)
    del got
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _p23_b1(launches):
    return sum(launches.get(k, 0) for k in ("fused_scale_cast",
                                            "pack_scale_cast",
                                            "unpack_scale_cast"))


def phase_topology(dev, card, state, batches):
    """Phase 23 (see the module docstring): legs (a)-(e) in turn, their
    checks, and per leg the steady ms a step and every kernel's
    launches."""
    import torch
    import horovod_tpu_torch as hvd

    xs, ys = batches
    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = False
    launches, steady = {}, {}
    # (a)
    flat = p23_engine_run(dev, state, xs, ys, {})
    torus = p23_engine_run(dev, state, xs, ys,
                           {"HOROVOD_TORUS_ALLREDUCE": "1"})
    rel_a = _rel_l2(torus["params"], flat["params"])
    ct = torus["counters"]
    if not rel_a <= COMPILED_REL_L2:
        raise AssertionError(f"phase 23 (a): torus parameters {rel_a:.3g} "
                             f"(relative L2) from the flat run's, bound "
                             f"{COMPILED_REL_L2}")
    if ct["algo_runs"].get("torus", 0) <= 0 or ct["cross"] != 0 \
            or flat["counters"]["algo_runs"].get("torus", 0) != 0:
        raise AssertionError(f"phase 23 (a): torus counters {ct}, flat "
                             f"{flat['counters']}")
    for label, run in (("flat", flat), ("torus", torus)):
        if _p23_b1(run["launches"]) <= 0:
            raise AssertionError(f"phase 23 (a) {label}: B1 launches "
                                 f"{run['launches']}")
        launches[f"a {label}"] = run["launches"]
        steady[f"a {label}"] = run["steady_ms"]
    log(f"phase 23 (a) ({card}): 4 rank threads x {P18_BATCH} images, "
        f"one host; flat steady {flat['steady_ms']:.2f} ms/step (step "
        f"times {[round(t, 4) for t in flat['step_s']]}), torus "
        f"{torus['steady_ms']:.2f} ms/step ({[round(t, 4) for t in torus['step_s']]}); "
        f"torus counters {ct}; parameters {rel_a:.3g} (relative L2) from "
        f"the flat run's (bound {COMPILED_REL_L2}); B1 launches flat "
        f"{_p23_b1(flat['launches'])}, torus {_p23_b1(torus['launches'])}")
    gc.collect()
    torch.cuda.empty_cache()
    # (b)
    hier = p23_engine_run(dev, state, xs, ys, P23_HIER_ENV,
                          host_map=P23_HOST_MAP, budget=True)
    ch, bud = hier["counters"], hier["budget"]
    dl, dc = bud["f32"]["logical"], bud["f32"]["cross"]
    dc8 = bud["int8"]["cross"]
    if not (dl > 0 and dc <= dl / 2 * 1.01 + 64 and dc8 <= dc / 1.9):
        raise AssertionError(f"phase 23 (b): byte budget {bud}")
    if ch["algo_runs"].get("hierarchical", 0) <= 0 \
            or not 0 < ch["cross"] <= ch["logical"] / 2:
        raise AssertionError(f"phase 23 (b): counters {ch}")
    gaps = [abs(a - b) / abs(b) for a, b in zip(hier["losses"],
                                                 flat["losses"])]
    if not all(math.isfinite(v) for v in hier["losses"]) \
            or max(gaps) > P23_LOSS_REL:
        raise AssertionError(f"phase 23 (b): losses {hier['losses']} vs "
                             f"flat {flat['losses']} (bound "
                             f"{P23_LOSS_REL} relative)")
    if _p23_b1(hier["launches"]) <= 0:
        raise AssertionError(f"phase 23 (b): B1 launches "
                             f"{hier['launches']}")
    launches["b"], steady["b"] = hier["launches"], hier["steady_ms"]
    log(f"phase 23 (b) ({card}): host map {P23_HOST_MAP}, "
        f"{P23_HIER_ENV}: steady {hier['steady_ms']:.2f} ms/step (step "
        f"times {[round(t, 4) for t in hier['step_s']]}); training "
        f"counters {ch}; budget of one grouped allreduce of the 161 "
        f"gradients: full width logical {dl} B, cross {dc} B (x "
        f"{dc / dl:.4f}), int8 outer cross {dc8} B (x {dc / dc8:.3f} "
        f"fewer); mean losses {hier['losses']} vs flat {flat['losses']} "
        f"(largest relative gap {max(gaps):.3g}, bound {P23_LOSS_REL}); "
        f"B1 launches {_p23_b1(hier['launches'])}")
    gc.collect()
    torch.cuda.empty_cache()
    # (c)
    job = p23_job(dev, state, batches)
    p0, p1 = job["params"]
    for label, p in (("process 0", p0), ("process 1", p1)):
        diff = [k for k in hier["params"]
                if not torch.equal(hier["params"][k], p[k])]
        if diff:
            raise AssertionError(
                f"phase 23 (c) {label}: {len(diff)} parameters differ from "
                f"(b)'s: {diff[:5]}; relative L2 "
                f"{_rel_l2(p, hier['params']):.3g}")
    for rep in job["reps"]:
        if rep["hosts"] != P23_HOST_MAP or rep["algorithm"] != \
                "hierarchical" or rep["wires"] != ["bf16", "int8"] \
                or rep["counters"]["algo_runs"].get("hierarchical", 0) <= 0 \
                or _p23_b1(rep["launches"]) <= 0:
            raise AssertionError(f"phase 23 (c) process {rep['proc']}: "
                                 f"{ {k: rep[k] for k in rep if k not in ('times', 'losses')} }")
    if len(job["calls"]) != 1 or P19_REMOTE not in job["calls"][0]:
        raise AssertionError(f"phase 23 (c): ssh calls {job['calls']}")
    c_ms, c_steps = _p23_steady_ms([t for rep in job["reps"]
                                    for t in rep["times"]])
    launches["c"] = [rep["launches"] for rep in job["reps"]]
    steady["c"] = c_ms
    log(f"phase 23 (c) ({card}): -H {P23_HOSTS}, 2 processes x 2 rank "
        f"threads over gloo on cuda:0, process 1 through the stub ssh; "
        f"layout {job['reps'][0]['layout']}; exit codes [0, 0]; steady "
        f"{c_ms:.2f} ms/step (step times {[round(t, 4) for t in c_steps]}); "
        f"parameters bit for bit (b)'s in both processes; counters per "
        f"process {[rep['counters'] for rep in job['reps']]}; B1 launches "
        f"per process {[_p23_b1(rep['launches']) for rep in job['reps']]}; "
        f"job wall {job['wall']:.1f} s")
    del job, p0, p1
    gc.collect()
    torch.cuda.empty_cache()
    # (d)
    red = p23_reducer(dev)
    launches["d"], steady["d"] = red["launches"], \
        _median(red["ms"]["torus"][1:])
    if _p23_b1(red["launches"]) <= 0 or not red["ef_moved"]:
        raise AssertionError(f"phase 23 (d): {red}")
    log(f"phase 23 (d) ({card}): the compiled torus over the 161 "
        f"ResNet-50 gradients x 4 rank threads bit for bit the engine's "
        f"and the hint's; hint cross {red['cross']} B of {red['logical']} "
        f"B logical; int4 residual shards {red['shard'][:1]} carried over "
        f"3 calls; ms a call (rank 0's clock, the 4 threads meeting) "
        f"{ {k: [round(t, 3) for t in v] for k, v in red['ms'].items()} }; "
        f"B1 launches {_p23_b1(red['launches'])}")
    gc.collect()
    torch.cuda.empty_cache()
    # (e)
    torch.backends.cudnn.deterministic = True
    try:
        s_flat = p23_sharded(dev, state, xs, ys, None)
        s_hint = p23_sharded(dev, state, xs, ys,
                             hvd.TopologyHint(*P23_HINT))
    finally:
        torch.backends.cudnn.deterministic = False
    rel_e = _rel_l2(s_hint["params"], s_flat["params"])
    # the sharded step reduces with torch ops inside its graph (B1 0, as
    # in phase 14)
    if not rel_e <= COMPILED_REL_L2 or s_hint["captures"] != 1:
        raise AssertionError(f"phase 23 (e): {rel_e:.3g} (relative L2) "
                             f"from the flat sharded step, bound "
                             f"{COMPILED_REL_L2}; captures "
                             f"{s_hint['captures']}")
    launches["e flat"], steady["e flat"] = s_flat["launches"], \
        s_flat["steady_ms"]
    launches["e hint"], steady["e hint"] = s_hint["launches"], \
        s_hint["steady_ms"]
    log(f"phase 23 (e) ({card}): the sharded compiled step at 4 rank "
        f"threads, captured: flat {s_flat['steady_ms']:.2f} ms/step, "
        f"hint {P23_HINT} {s_hint['steady_ms']:.2f} ms/step; losses "
        f"{s_hint['losses']} vs {s_flat['losses']}; parameters "
        f"{rel_e:.3g} (relative L2) from the flat step's (bound "
        f"{COMPILED_REL_L2}); B1 launches flat "
        f"{_p23_b1(s_flat['launches'])}, hint "
        f"{_p23_b1(s_hint['launches'])}")
    log(f"phase 23 ({card}): steady ms a step per leg "
        f"{ {k: round(v, 2) for k, v in steady.items()} }; "
        f"{time.perf_counter() - t_phase:.1f} s in all")
    return {"launches": launches, "steady_ms": steady}


def _resnet_named_params():
    import torch
    from horovod_tpu_torch.models.resnet import ResNet50
    with torch.device("meta"):
        return list(ResNet50(num_classes=1000).named_parameters())


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "horovod_tpu_torch")):
        print("chip_smoke: horovod_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--worker16"]:
        return phase16_worker(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--worker18"]:
        return phase18_worker(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--worker20"]:
        return phase20_worker(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--worker21"]:
        return phase21_worker(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--worker23"]:
        return phase23_worker(sys.argv[2])
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    # stated and set: no TF32 in f32 convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t_all = time.perf_counter()
    log(f"phase 1: {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}; CUDA {torch.version.cuda}; python "
        f"{sys.version.split()[0]}; TF32 off (cudnn and matmul)")

    from horovod_tpu_torch.ops import (_build, conv_bn, cuda_kernels,
                                       flash_attention, quantize_kernels)
    t0 = time.perf_counter()
    libs = (cuda_kernels._lib, flash_attention._lib, quantize_kernels._lib,
            conv_bn._lib)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib) for lib in libs]:
            f.result()
    log(f"phase 2: {len(libs)} libraries built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in ("hvd_scale_cast", "hvd_flash", "hvd_quantize",
                 "hvd_conv_bn"):
        info = _build.build_info[name]
        lines = info["log"].splitlines()
        regs = [ln.split(":", 1)[1].strip() for ln in lines
                if "registers" in ln]
        spills = [ln.strip() for ln in lines
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        log(f"phase 2: built {os.path.basename(info['path'])} in "
            f"{info['seconds']:.2f} s; ptxas, per kernel: {regs}; "
            f"spills: {spills}")
    for kernel, report in ptxas_kernels(
            _build.build_info["hvd_conv_bn"]["log"], "_sm90_kernel"):
        log(f"phase 2: {kernel}: {report}")
    for (m, k, n), (_, plan) in ((mkn, conv_bn.kernel_plan(
            torch.bfloat16, *mkn)) for mkn in ((200704, 64, 256),
                                               (3136, 512, 2048))):
        log(f"phase 2: conv_bn_sm90.cu dynamic shared memory at M={m} "
            f"K={k} N={n}: forward {plan['fwd_smem']} B (tile 128 x "
            f"{plan['fwd_bn']}), dx {plan['dx_smem']} B (128 x "
            f"{plan['dx_bk']}), dw {plan['dw_smem']} B (128 x "
            f"{plan['dw_bn']}); one CTA per SM")

    from horovod_tpu_torch.models.resnet import ResNet50, numpy_init
    with torch.device("meta"):
        shell = ResNet50(num_classes=1000)
    state = numpy_init(shell, SEED)
    batches = make_batches(NP)
    if "--phase22" in sys.argv[1:]:
        # phase 22 and the phase 7 it reads, alone; not the contract's run
        lm = phase_lm(dev, profile="--profile" in sys.argv[1:])
        launches = phase_frontend(dev, card, state, batches, lm,
                                  profile="--profile" in sys.argv[1:])
        log(f"phases 7 and 22 passed in {time.perf_counter() - t_all:.1f} "
            f"s; launches {launches}")
        return 0
    if "--phase23" in sys.argv[1:]:
        # phase 23 alone; not the contract's run
        topo = phase_topology(dev, card, state, batches)
        log(json.dumps({"phase23_launches": topo["launches"]}))
        log(f"phase 23 passed in {time.perf_counter() - t_all:.1f} s")
        return 0

    kern = phase_kernel(dev)
    main_path = phase_main_path(dev, state, batches,
                                profile="--profile" in sys.argv[1:])
    torch.cuda.empty_cache()
    plain_s = phase_plain_step(dev, state, batches)
    log(f"phase 4: framework step / plain step = "
        f"{main_path['steady_s'] / plain_s:.3f}")
    if "--profile" in sys.argv[1:]:
        phase_plain_threads(dev, state, batches)
        # the interpreter hands the GIL over every 5 ms by default; the
        # gradient hooks run on autograd's device thread and wait for it
        old = sys.getswitchinterval()
        sys.setswitchinterval(0.0005)
        try:
            log("profile: main path again with sys.setswitchinterval(0.0005)")
            phase_main_path(dev, state, batches)
        finally:
            sys.setswitchinterval(old)
    phase_nccl(dev)
    torch.cuda.empty_cache()
    flash = phase_flash_kernels(dev)
    lm = phase_lm(dev, profile="--profile" in sys.argv[1:])
    phase_lm_hvd(dev)
    codec = phase_codec(dev)
    wired = {wire: phase_wire_path(dev, state, batches, wire,
                                   profile="--profile" in sys.argv[1:])
             for wire in ("int8", "int4")}
    for wire, w in wired.items():
        log(f"phase 9: steady step {wire} {w['steady_s'] * 1e3:.2f} ms vs "
            f"phase 4's f32 wire {main_path['steady_s'] * 1e3:.2f} ms "
            f"(x {w['steady_s'] / main_path['steady_s']:.3f})")
    conv = phase_conv_bn_kernels(dev)
    fused = phase_main_path(dev, state, batches,
                            profile="--profile" in sys.argv[1:], fused=True)
    log(f"phase 11: steady step fused {fused['steady_s'] * 1e3:.2f} ms "
        f"(device busy share {fused['busy_share']:.3f}) vs phase 4's "
        f"unfused {main_path['steady_s'] * 1e3:.2f} ms (busy share "
        f"{main_path['busy_share']:.3f}); x "
        f"{fused['steady_s'] / main_path['steady_s']:.3f}; fused launches "
        f"{fused['conv_launches']} (all on the sm90 route)")
    torch.cuda.empty_cache()
    phase_fused_yardstick(dev, state, batches)
    torch.cuda.empty_cache()
    compiled = phase_compiled(dev, card, state, batches, main_path, fused,
                              plain_s, profile="--profile" in sys.argv[1:])
    torch.cuda.empty_cache()
    shard, shard_f32 = phase_sharded(dev, card, state, batches)
    torch.cuda.empty_cache()
    compiled["13"] = shard_f32
    cs = phase_compiled_sharded(dev, card, state, batches, compiled,
                                lm["weights"],
                                profile="--profile" in sys.argv[1:])
    # what phase 17 is held to
    p17_refs = {
        "a_params": compiled["a"]["params"],
        "a_steady_s": compiled["a"]["steady_s"],
        "b_params": compiled["b"]["params"], "plain_s": plain_s,
        "i8_params": cs["a int8"].pop("params"),
        "state_bytes": {"f32": cs["a f32"]["state_bytes"],
                        "int8": cs["a int8"]["state_bytes"]},
        "lm14_steady_s": cs["d dense"]["steady_s"],
        "lm7_steady_s": lm["steady_s"], "lm_losses": lm["losses"]}
    del compiled
    moe = phase_moe_lm(dev, lm, profile="--profile" in sys.argv[1:])
    moe_wire = phase_moe_wire(dev, moe)
    moe_launches = moe["launches"]
    p17_refs["a2a_sends"] = moe_wire.pop("sends")
    p17_refs["a2a_digests"] = moe_wire.pop("digests")
    join = phase_join(dev, state, batches)
    # the jobs share the card with this process: hand back what it holds
    del moe
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phases 16-17: this process holds "
        f"{torch.cuda.memory_allocated(dev)} B allocated, "
        f"{torch.cuda.memory_reserved(dev)} B reserved on the card")
    phase4_params = main_path.pop("params")
    multi = phase_multiprocess(dev, card, state, batches, phase4_params,
                               p17_refs)
    del p17_refs
    gc.collect()
    torch.cuda.empty_cache()
    hybrid = phase_hybrid(dev, card, state, batches, phase4_params)
    log(f"phase 18 (a) against phase 16 (b): 2 x 2 steady "
        f"{hybrid['steady_ms']['o']:.2f} ms (bypass off), "
        f"{hybrid['steady_ms']['n']:.2f} ms (on) for 128 images; np=2 "
        f"{multi['b']['steady_ms']:.2f} ms for 128 images")
    gc.collect()
    torch.cuda.empty_cache()
    remote = phase_remote(dev, card, state, batches, phase4_params)
    log(f"phase 19 (a) against phase 16 (b): {remote['steady_ms']:.2f} ms "
        f"with rank 1 through ssh, {multi['b']['steady_ms']:.2f} ms with "
        f"both local")
    gc.collect()
    torch.cuda.empty_cache()
    elastic = phase_elastic(dev, card, state, batches)
    gc.collect()
    torch.cuda.empty_cache()
    faults = phase_chaos(dev, card, state, batches,
                         elastic.pop("replay_a"))
    gc.collect()
    torch.cuda.empty_cache()
    frontend = phase_frontend(dev, card, state, batches, lm,
                              profile="--profile" in sys.argv[1:])
    del lm["weights"]
    gc.collect()
    torch.cuda.empty_cache()
    topo = phase_topology(dev, card, state, batches)
    log(json.dumps({"phase23_launches": topo["launches"]}))
    del state, batches, phase4_params
    p17 = multi["phase17"]["launches"]

    def phase17_launches(*names):
        """Launches of the named kernels in each phase-17 leg, per
        process."""
        return {leg: [sum(x.get(n, 0) for n in names) for x in per]
                for leg, per in p17.items()}

    def phase18_launches(*names):
        """Launches of the named kernels in each phase-18 leg, per
        process."""
        return {leg: [sum(x.get(n, 0) for n in names) for x in per]
                for leg, per in hybrid["launches"].items()}

    def phase23_launches(*names):
        """Launches of the named kernels in each phase-23 leg ((c): per
        process)."""
        def total(x):
            return sum(x.get(n, 0) for n in names)
        return {leg: [total(x) for x in v] if isinstance(v, list)
                else total(v) for leg, v in topo["launches"].items()}

    def at_capture(*names):
        """Launches of the named kernels each phase-14 leg's capture
        recorded."""
        return {leg: sum(v["capture"].get(n, 0) for n in names)
                for leg, v in cs.items()}
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")

    log(card)
    kernels = [{
        "name": "scale_cast_batched", "route": "cuda",
        "source": "horovod_tpu_torch/ops/csrc/scale_cast.cu",
        "kernel": "scale_cast_batched",
        "replaces": "horovod_tpu/ops/pallas_kernels.py:67",
        "launches": main_path["launches"],
        "sharded_launches": {leg: sum(
            v["launches"][k] for k in ("fused_scale_cast", "pack_scale_cast",
                                       "unpack_scale_cast"))
            for leg, v in shard.items()},
        "compiled_sharded": at_capture("fused_scale_cast", "pack_scale_cast",
                                       "unpack_scale_cast"),
        "phase15_launches": join["launches"],
        "phase16_launches": {leg: [v["pack"] + v["unpack"] for v in per]
                             for leg, per in multi["launches"].items()},
        "phase17_launches": phase17_launches(
            "fused_scale_cast", "pack_scale_cast", "unpack_scale_cast"),
        "phase18_launches": phase18_launches(
            "fused_scale_cast", "pack_scale_cast", "unpack_scale_cast"),
        "phase19_launches": remote["launches"],
        "phase20_launches": elastic["launches"],
        "phase21_launches": faults["launches"],
        "phase22_launches": {leg: frontend[leg]
                             for leg in ("a", "b", "b f64", "c")},
        "phase23_launches": phase23_launches(
            "fused_scale_cast", "pack_scale_cast", "unpack_scale_cast"),
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": "bytes", "library_ms": kern["library_ms"]}]
    for name, replaces in FLASH:
        r = flash[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": FLASH_SOURCE[name], "kernel": FLASH_KERNEL[name],
            "replaces": replaces, "launches": lm["launches"][name],
            "compiled_sharded": at_capture(name),
            "phase15_launches": moe_launches[name],
            "phase17_launches": phase17_launches(name),
            "phase22_launches": {
                leg[2:]: [c[[n for n, _ in FLASH].index(name)] for c in per]
                for leg, per in frontend.items() if leg.startswith("d ")},
            "phase23_launches": phase23_launches(name),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for name, replaces, wire in CODEC:
        r = codec[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/quantize.cu",
            "replaces": replaces,
            "launches": wired[wire]["launches"][name],
            "sharded_launches": {leg: v["launches"][name]
                                 for leg, v in shard.items()},
            "compiled_sharded": at_capture(name),
            "phase15_launches": moe_wire["launches"][name],
            "phase17_launches": phase17_launches(name),
            **({"phase16_launches": {
                leg: [v[PHASE16_CODEC[name]] for v in per]
                for leg, per in multi["launches"].items()},
                "phase18_launches": phase18_launches(name)}
               if name in PHASE16_CODEC else {}),
            "phase22_launches": frontend["others"][name],
            "phase23_launches": phase23_launches(name),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for name, replaces in CONV_BN:
        r = conv[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/conv_bn_sm90.cu",
            "kernel": CONV_BN_KERNEL[name], "replaces": replaces,
            "launches": fused["conv_launches"][name],
            "compiled_sharded": at_capture(name),
            "phase15_launches": 0,
            "phase17_launches": phase17_launches(name),
            "phase22_launches": frontend["others"][name],
            "phase23_launches": phase23_launches(name),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
