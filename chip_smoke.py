#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100):

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. device: CUDA must be there; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them;
2. build: compiles every kernel source of ``ops/csrc`` with ``nvcc``, one
   process per source, all started together, each timed;
3. kernels: ``conv3x3_bn_relu`` against its plain PyTorch version on the
   card at each of ResNet-18's five fused shapes, at n = 128 and n = 3, in
   bf16 and fp32 (fp32: rtol 1e-4, atol 1e-4 against the plain version in
   full fp32, TF32 off; bf16: rtol 1.6e-2, atol 1e-2 against the plain
   version in fp32 on the same bf16-rounded inputs); rows 0..k of the
   n = 128 output must equal the n = k output bit for bit at every serving
   bucket, k = 1, 3, 8, 32 (multi-image tiles change which tile holds a
   row); CUDA-event times of the kernel at its plan, of its mma.sync path
   at the same bf16 site (the design every site ran before the wgmma path),
   of the plain version and of the library yardstick (``F.conv2d`` in
   channels_last + affine + ReLU, never called by the port), beside the
   least time the card could take (``bound``);
4. slice: ResNet-18 at full width served by ``InferenceEngine`` (bf16,
   buckets 1/8/32/128, seeded random weights) behind ``MicroBatcher`` under
   ``run_load`` (8 clients x 256 requests of 1..8 images), with the
   kernel's launch count reset just before and read
   just after: it must be 6 x the engine's forwards; then the served logits
   against the same weights run by the port on the CPU (fp32 engine: rtol
   1e-3, atol 1e-4, since cuDNN and the kernel sum in another order than
   the CPU; bf16 engine: max abs difference <= 2% of the largest logit).

Then the training slice and its two kernels:

5. gather: ``dma_row_gather`` (K1) against its plain version, bit for bit,
   on the epoch gather of the main path (50,176 int32 indices over
   ``(50000, 32, 32, 3)`` uint8, the 16-byte path), on float32 rows of
   12,288 bytes (the 16-byte path at four times the row), on float32 rows
   of 252 bytes and on a uint8 base 1 byte off alignment (the byte path);
   times of the kernel, the plain version, ``index_select`` and a
   contiguous ``copy_`` of the same bytes (the card's practical ceiling
   for this work, a yardstick only), and the bound;
6. moments: ``fused_moments`` (K2) at ResNet-18's four BN shapes at
   n = 512 in bf16 and fp32: values against the plain version in float64
   (rtol 1e-4, atol 1e-5), two launches bit-identical, the gradient
   through its ``autograd.Function`` against autograd of the plain version
   (atol 1e-6), one device kernel a call as ``torch.profiler`` counts
   them; times of the kernel, the plain version and
   ``torch.batch_norm_stats``, and the bound; then C = 130 and a view one
   element off 16-byte alignment (the scalar path), values, determinism
   and the kernel count;
7. train: ``Trainer.fit`` on ``synthetic_cifar10(50000, 10000)``, ResNet-18
   at full width, batch 512, bf16, device data, ``dma_gather`` on,
   2 epochs, ``cosine_t_max`` 2, with the launch counts reset just before
   and read just after: K1 once per epoch (and K3 six times per eval
   forward); each epoch's count 50,000, finite losses, the second epoch's
   train loss below the first's and the final eval accuracy above 50%;
   then a third epoch dispatched under ``torch.cuda.set_sync_debug_mode
   ("error")``, which fails on any host sync, its totals fetched after;
8. bn_bench: the ResNet-18 b512 bf16 train step on one fixed batch,
   10 steps with stock BN moments and 10 under
   ``bn_moments_impl(fused_moments)`` (in turns stock, fused, fused,
   stock), K2 launched 0 times in the stock runs and 20 times per forward
   in the fused runs; and, in fp32 from the same start, one fused step
   against one stock step: running stats within rtol 1e-4, atol 1e-6, and
   parameters no further from a float64-compute step than twice the stock
   step is (an fp32 step is accurate only to a few percent of its update
   on its worst tensor: BN's backward subtracts nearly equal terms);
9. card vs CPU: one ResNet-18 step (augment off, TF32 off) from the same
   weights and batch on the card and on the CPU, within rtol 1e-3, atol
   1e-5: in fp32 the metrics and running stats, in float64 compute
   (fp32 parameters) the parameters too.

Then the zoo slice (GoogLeNet, MobileNet) and its kernels:

10. pool: ``max_pool3x3_s1`` (K4) against its plain version, bit for bit
    (a NaN equal to a NaN): the forward without and with the uint8 winner
    map, the map, and the backward on integer cotangents, at GoogLeNet's
    six pool shapes at n = 512 and at ``(3, 5, 5, 130)`` (narrow vectors),
    in bf16 and fp32; there also an all-ties input, NaNs (every window
    holding one must return it, as ``F.max_pool2d`` does) and a ``-inf``
    map, an odd C and a view one element off alignment (the narrowest
    vectors); at the first n = 512 shape inputs planted on the forward's band
    edges (two NaNs in one window, +-0 ties, ``-inf`` rows, ``-inf``
    borders), and on the backward's with -0, NaN and infinite cotangents
    there, the forward's output and the gradient held as raw bits; output
    and gradient equal to ``F.max_pool2d``'s; times of the
    kernels, the plain version and ``F.max_pool2d`` forward and backward
    (channels_last), and the byte bounds;
11. stencil: ``depthwise_stencil`` (K5) against its plain version at
    MobileNet's five stride-1 depthwise shapes at n = 128 (k = 3), at
    ``(512, 32, 32, 44)`` with k = 5 and 7 and at ``(2, 8, 8, 130)``, in
    bf16 and fp32 (tolerances in :func:`phase_stencil`); times of the
    kernel, the plain version and ``F.conv2d(groups=C)``, and the bound;
12. site_googlenet: phase 3 again at the 24 distinct shapes of GoogLeNet's
    28 fused sites (cin from 3 to 192, cout from 32 to 384, maps 32, 16, 8);
13. slice, for GoogLeNet and then MobileNet (8 clients x 64 requests):
    launches reset just before and read just after, K4 = 9 and K3 = 28 per
    GoogLeNet forward, K5 = 9 and K3 = 1 per MobileNet forward; served
    logits against the CPU as in phase 4;
14. googlenet_train: phase 7 for GoogLeNet on
    ``synthetic_cifar10(10240, 2048)`` (20 steps per epoch): K1 once per
    epoch, K4 forward 9 and backward 9 per train step and forward 9 per
    eval forward, K3 28 per eval forward; counts, finite and falling loss,
    the sync-checked third epoch, img/s and peak memory;
15. pool_step: one fp32 GoogLeNet step (batch 64) with K4 against one with
    ``F.max_pool2d`` from the same start, both against the float64-compute
    step (see :func:`phase_pool_step`);

Then the train CLI's default model:

16. simpledla: SimpleDLA (``TrainConfig``'s default) at full width: phase
    3 at the shapes of its 12 fused sites (among them 16 -> 16 and
    16 -> 32 at 32x32, cout padded to the wgmma tile's 64); served at
    buckets 8 and 128 (8 clients x 64 requests, 12 K3 launches a forward,
    logits against the CPU as in phase 4); phase 7 on
    ``synthetic_cifar10(10240, 2048)`` (20 steps an epoch; depth cut from
    the recipe's 200 epochs to 2), K3 12 per eval forward.

Then checkpoints (the JAX package's format v2), on ResNet-18 at full width,
batch 512, bf16, ``synthetic_cifar10(10240, 2048)``, in a temporary
``output_dir`` under ``runs/``:

17. ckpt: (a) run A, uninterrupted, 2 epochs; (b) run B calls
    ``request_stop()`` before ``fit``, stops after epoch 0 and writes
    ``last.msgpack`` and ``ckpt.msgpack``; (c) ``Trainer(resume=True)``
    restores them: its params, BN stats, momentum buffers and step equal
    B's live state as raw bits, on the card, each buffer in its
    parameter's memory format; it starts at epoch 1, launches K1 once and
    K3 6 times per eval forward, its epoch-1 train loss is finite and
    within 1% relative of A's (cuDNN's backward is not bit-reproducible),
    and ``last.msgpack`` is gone when it completes; (d)
    ``InferenceEngine.from_checkpoint`` serves 256 test images in bf16, 6
    K3 launches per forward, logits within 2% of the largest logit of the
    same weights on the CPU in fp32; (e) ``Trainer(evaluate=True)``
    reproduces the sidecar's ``best_acc`` within 2 of 2,048 images. Then
    three timed saves of B's state through the async writer and three
    restores: the payload's bytes, the save's stall on the calling thread,
    the commit on the writer and the restore, in ms, beside the card's
    name and power limit and the output directory's filesystem.

Then data parallelism, through the train CLI (``train_main``, ranks of
``torch.distributed``, one process per card):

18. dp: (a) NCCL at world = the visible cards, capped at 4 (``--num_devices
    N``, spawned; on one card ``--distributed`` with a world of 1, which
    still makes the process group and runs every collective), ResNet-18 at
    full width, global batch 512, bf16, ``synthetic_cifar10(50000,
    10000)``, device data, K1 gather, 2 epochs, ``cosine_t_max`` 2; each
    rank's launches counted over its ``fit``, from 0 in its fresh process:
    K1 once per epoch and K3 six times per eval forward per rank, K2 none;
    the global counts 50,000 and 10,000 per epoch, finite and falling
    losses, eval accuracy above 50%, the same metrics and (SHA-256 of the
    params, BN and momentum buffers) the same state on every rank; after
    ``fit`` each rank takes one bf16 b512 step under cross-replica BN with
    ``bn_moments_impl(fused_moments)``, K2 launched 20 times, times its
    step's flat all-reduce (gradients and BN buffers) and dispatches one
    more epoch under ``torch.cuda.set_sync_debug_mode("error")``. (b) On a
    one-card machine, where NCCL refuses two ranks on one card, also two
    gloo ranks, both on ``cuda:0``, the group made by the script with the
    gloo backend (the trainer itself takes NCCL on CUDA), on
    ``synthetic_cifar10(10240, 2048)``, with the same checks but the
    accuracy and the sync check (gloo copies CUDA tensors through the
    host). (c) At the first world of 2 or more that ran (the gloo pair on
    one card): one fp32 and one float64-compute step of a seeded
    ResNet-18 under cross-replica BN on each rank's shard of a 64-image
    batch (5 padded rows on the last rank), against one process's steps on
    the whole batch: metrics and BN buffers within rtol 1e-4, atol 1e-5,
    the float64-compute step's parameters within rtol 1e-3, atol 1e-5 (as
    in phase 9). (d) That run's ranks write a format v3 ``last.msgpack``
    (one shard each), and a one-process ``--resume`` restores its state as
    raw bits. Prints img/s and the flat all-reduce's ms per step of each
    run, beside the card's name and power limit.

Then the depthwise slice (DLA, MobileNetV2, EfficientNetB0, ShuffleNetV2,
PNASNet A and B), run after phase 16:

19. stencil_zoo: K5 (phase 11's checks and tolerances) at every distinct
    ``(h, w, c, k)`` of the depthwise families' stride-1 depthwise sites at
    n = 128 (38 shapes: k = 3, 5 and 7, maps from 32x32 to 2x2 of 24 to
    1,152 channels, ShuffleNetV2's 58 / 116 / 232 / 244 and PNASNetA's 44
    on the narrow vectors), bf16 and fp32, each row with the launches per
    forward of every model that has it; pool_zoo: K4 (phase 10's
    per-shape checks, as raw bits) at PNASNet's six pool inputs at n =
    512; site_zoo: K3 (phase 3) at the new stems (3 -> 24, 32, 44; DLA's
    sites are SimpleDLA's, held in phase 16);
20. slices: DLA, MobileNetV2, EfficientNetB0, PNASNetA, PNASNetB and
    ShuffleNetV2_1 served as in phase 4 at buckets 8 and 128 (8 clients x
    64 requests), every launch count per forward pinned: (K3, K4, K5) =
    (12, 0, 0), (1, 0, 14), (0, 0, 12), (1, 18, 18), (1, 18, 54), (1, 0,
    13), no K4 backward;
21. efficientnetb0_train and pnasnetb_train: phase 7 on
    ``synthetic_cifar10(10240, 2048)`` at full width (EfficientNetB0 with
    its drop-connect and dropout masks drawn from the train state's model
    stream; PNASNetB with 18 K4 forwards and 18 backwards a step): K1 once
    an epoch, the eval forwards' K3 / K4 / K5 launches, finite and falling
    losses, the sync-checked third epoch, epoch 1's wall apart;
22. moments_efficientnet: one b512 bf16 EfficientNetB0 step under
    ``bn_moments_impl``: K2 at its 48 live BNs (2x2 maps of 1,152
    channels among them), each launch's moments within rtol 1e-4, atol
    1e-5 of float64, a finite loss;
23. ``depthwise_s``: each of these phases' seconds (``phase_s`` prints
    every phase's).

Then the zoo's last families (VGG, PreActResNet, SENet, ResNeXt, RegNet,
DenseNet, DPN, ShuffleNet G2/G3), run after phase 23:

24. site_zoo_rest: K3 (phase 3's checks) at VGG16's nine site shapes at
    n = 128, 3 -> 64 at 32x32 down to 512 -> 512 at 2x2 (PreActResNet18/
    50's and SENet18's shapes are among them), bf16 and fp32, each row with
    the launches per forward of each of the four models that has it;
    stencil_zoo_rest: K5 (phase 11's checks) at ShuffleNet G2/G3's six
    stride-1 shapes at n = 128 (C = 50, 100, 200 and 60, 120, 240 at
    16x16, 8x8 and 4x4);
25. slices: VGG16, PreActResNet18, SENet18, ResNeXt29_2x64d,
    RegNetY_400MF, DenseNet121, DPN26 and ShuffleNetG2 served as in phase
    4 at buckets 8 and 128 (8 clients x 64 requests), (K3, K4, K5) a
    forward pinned: (13, 0, 0), (5, 0, 0), (6, 0, 0), (0, 0, 0), (1, 0,
    0), (0, 0, 0), (1, 0, 0), (0, 0, 13);
26. vgg16_train and densenet121_train: phase 7 on
    ``synthetic_cifar10(10240, 2048)`` at full width (DenseNet121 on its
    shared-stats path): K1 once an epoch, 13 K3 launches a VGG16 eval
    forward, finite and falling losses, the sync-checked third epoch,
    epoch 1's wall apart;
27. moments_densenet: one b512 bf16 DenseNet121 step under
    ``bn_moments_impl``: K2 at its 120 moments (the stem's output, 58 new
    chunks, 3 transitions' outputs, 58 ``bn2`` inputs), as many launches as
    the same step makes ``bn_batch_moments`` calls on the CPU, each within
    rtol 1e-4, atol 1e-5 of float64, the path (16-byte vectors or scalar)
    each took, K2's times at the step's shapes beside
    ``torch.batch_norm_stats``, K2 at DenseNetCifar's chunk widths (C = 12
    on its scalar path, and 24) against float64; then an fp32
    shared-stats step's loss within rtol 1e-5 of the per-layer step's
    from the same start;
28. ``zoo_rest_s``: each of these phases' seconds.

Then the rest of the trainer, run after phase 28, each on ResNet-18 at full
width, b512, on googlenet_train's cut split (10,240 / 2,048, 20 steps an
epoch), with the launch counts reset just before each run of the main path
and read just after:

29. sentinel: ``Trainer.fit`` (bf16, device data, K1 gather, the default
    ``sentinel="skip"``) for 2 epochs with ``faults.inject("nan_loss",
    25)``: K1 twice, 6 K3 per eval forward, ``fault_stats`` naming step
    25 alone, every parameter finite; one more guarded epoch dispatched
    under ``torch.cuda.set_sync_debug_mode("error")``; the poisoned step
    run alone from the state the run left: params, momentum and BN buffers
    equal to it as raw bits, the step counter + 1; a ``rollback`` run with
    ``sentinel_budget=1`` and step 23 poisoned, whose state after epoch 1
    equals the epoch-0 checkpoint (``ckpt-e00000.msgpack``) byte for byte;
    the guarded and the unguarded bf16 b512 step's wall and device ms at
    ResNet-18 and SimpleDLA (``tools/profile_train.py``'s method, in
    turns);
30. remat: one fp32 step (TF32 off, cuDNN deterministic) of ResNet-18 at
    b512 and of EfficientNetB0 at b128 (drop-connect drawn and replayed)
    from one state with ``remat`` off and on: the largest gradient
    difference within 1e-5 of each tensor's largest gradient, the BN
    running stats as raw bits, then 3 warm steps' ms and the peak memory
    each way;
31. host_loader: the train CLI with ``--no-device_data`` for 2 epochs,
    with ``--async_input`` on (and ``--metrics_out``, ``--trace_out``),
    off, and with ``--host_augment``: no K1, 6 K3 per eval forward, every
    image once an epoch, a falling loss; epoch 0's first 8 batches' SHA-256
    equal with async on and off; the warm epoch's img/s against phase 29's
    device-resident run; ``data.prefetch_depth`` and the
    ``train.input_wait_ms`` p50; the JSONL and trace files parse and hold
    the JAX trainer's names.

Serving over the wire, run right after phase 4:

32. wire: (1) ResNet-18 at full width (seeded weights, bf16, buckets
    1/8/32/128) behind ``MicroBatcher(max_wait_ms=2, continuous=True)``,
    its ``BatcherBackend`` behind a ``ServingFrontend`` and an
    ``EdgeFrontend``, each on ``127.0.0.1:0``; requests of n = 1, 7, 32
    and 100 images sent one at a time in the binary frame, JSON-base64 and
    JSON lists through each edge, each answer equal to ``engine.predict``
    of the same images bit for bit, one batch and one forward a request,
    6 K3 launches a batch (the launch count reset just before and read
    just after), ``compile_count`` unmoved; (2) ``run_load`` (8 clients x
    64 requests of U[1, 8] images) through ``HttpTarget`` in the mixed,
    binary and JSON wires through each edge, ``run_async_load`` (64
    logical clients x 16 requests, mixed) through the event edge, and the
    same ``run_load`` on the batcher before and after them: no failed
    request, 6 K3 launches a batch, img/s, p50/p99, ``http_vs_inproc``,
    binary-vs-JSON and the engine's mean ``serve.device_ms`` of each run;
    (3) two replica processes (``python -m pytorch_cifar_tpu_torch.serve
    --model ResNet18 --http_port 0 --seed 0``, started at the phase's
    start) and a ``Router`` over them: single requests of (1) through each
    replica, the router on both transports, equal to this process's
    ``engine.predict`` bit for bit; one client's 1-image requests direct
    and through the router's frontend (the router's cost at p50); (2)'s
    mixed-wire ``run_load`` against replica 1 directly (the clients in
    another process than the server) and through the router; then
    mixed-priority load (8 clients x 48 requests, 30% bulk) through the
    router's frontend with replica 0 SIGKILLed after 96 requests: every
    request answered or failed with an error (none lost), replica 0
    evicted, a further 8 x 32 with no failure (its p99 the post-eviction
    p99); the survivor SIGTERMed: exit 0, one JSON line, no error
    answered, K3 launched 6 times a forward (warmup and batches).

The checkpoint life cycle; phase 33 runs right after phase 3, phases 34
and 35 after phase 18:

33. k3_nan: K3 against its plain version (cuDNN off: its fp32
    algorithm spreads a NaN pixel over the whole image; its NaN count is
    recorded beside) with one NaN planted in an input
    pixel, a weight, a scale or a bias entry, at ResNet-18's stem (the
    mma.sync path in both dtypes), 32x32 x 64 and 4x4 x 512 sites (the
    wgmma path in bf16, whole images a tile at 4x4; the mma.sync path in
    fp32), n = 8: NaN at exactly the plain version's positions, the finite
    outputs at phase 3's tolerances; and the bits of ``relu(-0)`` from the
    kernel and the plain version, recorded;
34. reload: two seeded ResNet-18 states A and B committed by the port's
    ``save_checkpoint``; an engine (bf16, buckets 1/8/32/128) from a live
    dir holding A behind ``MicroBatcher`` and ``BatcherBackend(watcher=)``;
    the ``CheckpointWatcher``'s poll loop (every 0.05 s, each swap timed)
    while rounds of ``run_load`` (8 clients x 64 requests of U[1, 8]
    images) run; then in order: B published (one reload), A's payload
    under B's sidecar (skipped), A published under a tombstone (refused),
    a watcher on a staging dir (refused): no failed request, every device
    batch equal to A's or B's engine on the same padded batch bit for bit
    (never a mix), ``/healthz``'s epoch B's after the reload, the compile
    count unmoved, 6 K3 launches a forward (reset just before the load and
    read just after); the swap's ms and the requests' p99 across it;
35. canary: A (2 epochs) and B (A resumed for 2 more on one cosine
    schedule) trained by ``Trainer.fit`` on googlenet_train's cut split;
    A published live; ``python -m pytorch_cifar_tpu_torch.tools.pipeline_run
    --epochs 0 --golden eval --min_shadow 64 --max_flip_frac 1.0``
    (ResNet-18, bf16, the live and the canary engine on the one card) under 3 clients' mixed-priority
    HTTP load (30% bulk); staged in turn: B NaN'd (``faults.regress_checkpoint(nan=True)``),
    bit-flipped (raw copy), regressed (``scale=2.0``), with one NaN in
    layer1.0.bn1's running variance (a K3 site: ``faults.nan_leaf``), and B
    itself: each of the first four quarantined (the tombstone lands, the
    live dir's bytes, ``/predict``'s bits and the generation unchanged; the
    K3-site NaN as "nonfinite"), B promoted after its golden eval and a
    soak of at least 64 teed interactive requests with no shadow error (the
    live sidecar carries B's epoch and generation 1, the watcher reloads
    it, ``/predict`` gives the bits of an engine built from B in this
    process); the soak's shadow counts (rows, argmax flips, bit-identical
    requests) and live p50/p99 during it; how many rows of A's engine in
    this process keep their bits when the same images run at another
    bucket (what a shadow comparison across buckets can expect); SIGTERM:
    exit 0,
    ``rejected == 4``, ``promotions == 1``, no failed client request, K3
    launched 6 times a forward of the launcher's two engines; interactive
    p50/p99 idle and while a candidate is vetted, ``canary.golden_ms`` and
    ``canary.promote_ms``. Then one pipeline run (``--epochs 3``, the
    trainer child on the same card, 2 clients): exit 0, at least one
    promotion, no failed request; the trainer's img/s from its
    ``train.log``, the card's peak memory in use
    (``torch.cuda.mem_get_info``) and the serving process's
    ``max_memory_allocated``. (The same trainer run alone beside it was
    cut to make room for phase 42.)

The int8 lane and the multi-tenant zoo server, after phase 35:

36. int8: ResNet-18 at full width served by ``InferenceEngine(int8=True)``
    (weight-only int8, one scale per output channel, dequantized at the
    compute dtype into the same folded forward) in bf16 and in fp32,
    buckets 1/8/32/128, behind ``MicroBatcher`` under ``run_load`` (8
    clients x 32 requests of U[1, 8] images), K3's count reset just before
    and read just after: 6 a forward; no failed request and
    ``serve.int8_images`` equal to the images served; the served logits
    against the port's int8 engine on the CPU on the same weights (fp32:
    rtol 1e-3, atol 1e-4; bf16: 2% of the largest logit); padded equal to
    direct at n = 7 in bf16, and in fp32 wherever the float fp32 engine
    keeps its own bits (recorded beside); ``weights_host`` (the float
    originals) swapped back in gives the same bits. Printed, not gated: ``memory_allocated`` of
    the int8 engine against a float engine of the same dtype and the bytes
    of each folded tree, the bucket-128 device ms of each forward (CUDA
    events), and the dequantization's device and host ms a forward;
37. zoo: a ``ModelZooServer`` of ResNet18 (from a seeded checkpoint
    under ``runs/``), GoogLeNet, MobileNet and SimpleDLA at full width,
    bf16, buckets 1/8/32/128, ``max_resident`` 2, priors from the card's
    sweep (``load_cost_priors``): under ``run_load`` (8 clients x 16
    requests of U[1, 8] images, each request's model drawn from
    ``zipf_mix`` over the priors), with K3, K4 and K5 reset just before
    the zoo is built and read just after the load: each count equal to the
    tenants' forwards times their launches a forward (ResNet18 6/0/0,
    GoogLeNet 28/9/0, MobileNet 1/0/9, SimpleDLA 12/0/0), every tenant
    run, no failed request, at least one eviction; then every tenant's
    answer bit for bit a dedicated engine's built in this process; an
    admit -> evict cycle (MobileNet admitted over ResNet18, ResNet18
    re-admitted over MobileNet; no garbage collection in between): the
    bytes the live tensors requested (``memory_stats``) within 1 MiB of
    their value before MobileNet's admission (``memory_allocated``, whose
    blocks carry up to 1 MiB of slack each, printed beside), the evicted
    engine object gone, ResNet18's bits unmoved; the zoo
    behind ``ServingFrontend`` over wire v2 (each tenant's bits, a 404 for
    an unknown model); a NaN candidate staged to ResNet18 through
    ``enable_canary`` quarantined with every tenant's bits unchanged. The
    zoo under the load runs on a fresh cold-start cache
    (``aot_cache_dir``): every admission after a tenant's first imports
    it (``compile_count == 0``, a hit per bucket), and every tenant runs
    forwards on imported weights (their K3, K4 and K5 launches printed).
    Before it, the same zoo without the cache, its admissions first from
    this thread alone, then under the same load: after each ``close()``
    the bytes its live tensors still request, and again once the cuBLAS
    workspaces are freed. The zoo's img/s and p50/p99 with and without
    the cache beside a dedicated ResNet-18's under the same load,
    admission ms (first and re-admission), and evictions are printed.

The fleet control plane, after phase 37: replica processes of the serving
CLI on the one card, spawned by the port's launchers (``python -m
pytorch_cifar_tpu_torch.tools.fleet_run`` / ``...router_run``), ResNet-18
at full width, bf16, buckets 1/8/32, from a seeded checkpoint under
``runs/``, on a shared cold-start cache (``--aot_cache``): every replica
spawned after the first of its weight set (its generation) joins with
``compiles == 0``. Each replica counts its own launches from 0 and
reports them in the JSON record it prints when drained, which the
launcher forwards on stderr as ``[replica i] {...}``; every replica of a
phase, found in ``/proc`` by its command line, must be gone at the
phase's end (else a failed ``orphan_pids`` check, and it is killed):

38. fleet: ``fleet_run`` with min 1, max 3 (band 3-10 in flight a
    replica, up after 0.5 s), under ``run_async_load`` rounds of 3 s: 4
    clients (the fleet must hold at 1), 32 (it scales up; once 2 serve,
    replica 0 is SIGKILLed at once; the stage ends when the corpse is
    reaped and a replacement serves), 4 again (until a scale-down). No failed
    request in any stage; every replica that ever served answers a
    32-image probe (alone in its batch) bit for bit as an in-process bf16
    engine does, and so does the router; at least 2 scale-ups, 1
    scale-down, 1 replica failure; SIGTERM: exit 0, every replica exits 0,
    each drained replica's K3 launches 6 x (batches + 3 warm-ups). The
    replica count over time, ``spawn_ms``/``drain_ms`` p50, each
    replica's warm-up and each stage's img/s and p50/p99 are printed;
39. rollout: the split deployment: this process hosts
    ``Router(allow_empty=True)``, a ``ServingFrontend`` and a
    ``JournalFollower``; the controller is ``fleet_run --role controller
    --journal --rollouts`` (min 2, max 3, the scaling band parked wide
    open). Generation 1 (seeded) published; the controller seeds 2
    replicas; under 4 clients' load generation 2 (every weight moved by
    0.5% of its spread) is published; the controller is SIGKILLed at its
    ``rollout-surge`` line; the edge serves on headless; ``--resume``
    adopts exactly the journal-live pids (``/proc`` agrees, no double
    spawn) and converts the fleet to generation 2, bit for bit a
    generation-2 engine's; generation 3 (generation 2 with one NaN in a
    K3 site's BN variance, CRC-valid) is refused at surge ("non-finite"),
    ``.prev`` restored (live generation 2), the fleet still on the
    generation-2 bits; no failed request; exit 0 with 1 rollout, 1
    rollback, no scale event; the journal replays to 1 rollout, 1
    rollback, no live replica, no pending intent;
40. zoo_fleet: ``router_run --models ResNet18,MobileNet,GoogLeNet
    --max_resident 2`` with 2 replicas (ResNet18 from a checkpoint, the
    others at seed 0): each model's answer bit for bit the same on both
    replicas and the router, over JSON and binary, twice (evict and
    re-admit between); 4 clients of a zipf mix, replica 0 SIGKILLed
    mid-load: no failed request, the corpse evicted, the answers unmoved;
    SIGTERM: exit 0; the survivor's K3, K4, K5 launches all above 0, K4 and
    K5 in nines, its ResNet-18 share of K3 in sixes. Replica 1, spawned
    after replica 0 filled the cache, starts with every resident tenant
    at ``compiles == 0``; at the end every tenant of the survivor admitted
    twice or more serves an engine with ``compiles == 0``.

The cold-start cache, after phase 40:

41. cold_start: ResNet-18 from a seeded checkpoint, buckets 1/8/32/128,
    in two fresh processes of ``python -m
    pytorch_cifar_tpu_torch.tools.cold_start --lanes fp int8`` on one
    cache dir, each building the bf16 engine and then the int8 one: the
    first prepares and exports (4 compiles, 4 misses a lane), the second
    imports (0 compiles, 4 hits), each bucket's logits on fixed inputs bit
    for bit the first's, K3 launched 6 times a forward in the second; each
    process's and engine's split (``import torch``, the CUDA context, the kernel
    libraries, the checkpoint's read and decode, the model, the fold, the
    int8 plan, or the cache's read and transfer; each bucket's first and
    second forward) is printed. Then bucket 8's entry tampered (its probe
    negated, its manifest valid): an engine in this process poisons it,
    prepares from the checkpoint (4 compiles) and keeps the first
    process's bits; the next one takes the other 3 buckets from the cache
    and leaves the tombstone.

The port's drill, after phase 41:

42. chaos: ``python -m pytorch_cifar_tpu_torch.tools.chaos_run`` as two
    child processes side by side at ResNet-18 (fp32 trainer children,
    5,120 / 1,024 images, batch 128): ``--mode sigkill --epochs 3`` must
    print ``"match": true`` at 1e-6, with the kill inside the run (rc -9,
    the resume starting above epoch 0 and below the last); ``--mode serve
    --epochs 2`` must print ``"match": true``, and its relaunched serving
    process (bf16, buckets 1/4/8) must have launched K3 6 times a forward,
    warm-ups included.

Serving over a device group, after phase 42:

43. mesh: on the one card, a seeded ResNet-18 checkpoint (buckets 1/8/32)
    served by two ranks of one logical replica (``python -m
    pytorch_cifar_tpu_torch.serve --mesh_procs 2``, fp32, over gloo on
    cuda:0): its answers at n = 1, 2, 3, 5, 8, 11, 16, 19, 33 bit for bit
    a one-process fp32 replica's on the same card (the same CLI, so the
    same library settings, TF32 among them); its ``/healthz`` mesh block
    at 2 processes, barrier generation 1; drained by a SIGTERM to the leader,
    both ranks exit 0 with K3 launched 6 times a forward (warm-ups and
    barrier probes included). Then ``router_run --replicas 2 --mesh_procs
    2`` (bf16) on a cold-start cache beside a one-process bf16 replica:
    replica 1 joins with ``compiles == 0`` on both ranks; the two leaders
    and the router answer bit for bit alike over both encodings, within 2%
    of the largest logit of the one-process replica (whether the bits held
    is printed); 8 clients against the one-process replica, then the
    router (img/s, p50, p99); under load one follower SIGKILLed: its
    leader exits rc 70 within ``--mesh_timeout_s`` + 10 s, no request
    fails, the router evicts it; the drain exits 0. The serving forwards'
    dense layer (``models.common.folded_dense``) is timed at bucket 128
    beside ``F.linear`` on the same inputs (ResNet-18's and DenseNet121's
    heads).

Elastic training, after phase 43:

44. elastic: (a) ``ElasticTrainRunner(procs=1)`` over the train CLI
    (``--device cuda --model ResNet18``, full width, batch 512, bf16,
    ``--synthetic_data`` at 10,240 / 2,048 images, device data, 4 epochs,
    ``--metrics_out``), its rank SIGKILLed after its first durable
    checkpoint: the record completed, 1 restart, the events
    ``preempted:rank0:rc-9`` then ``completed``, both at world 1; the
    second generation resumed at the saved epoch + 1 (its metrics:
    ``checkpoint.restores`` 1, ``train.epochs`` the epochs left); finite
    losses; the record's ``best_acc`` ``ckpt.json``'s. (b) That run's best
    checkpoint re-cut to a two-shard v3 set (``reshard_checkpoint``) and
    resumed by one elastic rank on the card for one epoch: resumed at the
    saved epoch + 1, ``checkpoint.reshards`` 1 (its span's ms printed),
    the layout left v2, finite losses. Each generation's start (spawn to
    ``fit``) and the phase's seconds are printed; every rank is reaped.

Spatial partitioning, beside phase 44 (which runs on a thread while it
does; both train in child processes and hold no time, so the step times
this phase prints in the whole script are read beside phase 44's
training; ``--only spatial`` reads them alone):

45. spatial: (0) K3 and K4 on the halo-extended slabs the spatial path
    hands them (``tools/spatial_runs.slab_shapes``): every extended shape
    of ResNet-18's fused sites and of GoogLeNet's 3x3 / stride 1 pools at
    ``(data, spatial, spatial_w)`` = (1, 2, 1), (1, 4, 1) and (1, 2, 2)
    ((2, 2, 1) cuts as (1, 2, 1)), bf16 and fp32, the edge's pad value
    along slab borders: K3 within phase 3's tolerances of its plain
    version, K4's forward, winner map and backward bit for bit. Then two
    gloo ranks on ``cuda:0`` (NCCL refuses two ranks on one card), each
    image's height cut in two (``--spatial_devices 2``; halos through the
    host, as gloo takes no CUDA tensor point to point). (1) A seeded
    ResNet-18 at full width, b512 (5 rows labelled -1): the fp32 eval
    forward (TF32 off; K3 at its 6 fused sites on the extended slabs, on
    every rank) against one process's on the same batch (rtol 1e-3, atol
    1e-4; each spatial group's ranks the same bits), then one fp32 step,
    augmentation off, then on, each against the one-process step on the
    same global batch from the same start: the loss within rtol 1e-5,
    every parameter within atol 5e-4, every BN running stat within atol
    1e-5 (JAX's ``tests/test_spatial.py``), both ranks' states equal as
    raw bits; 3 more steps time each on every rank, in a window opened
    and closed by an all-reduce the card has finished, beside the
    one-process step's. (2) The train CLI (``tools/spatial_runs.fit_argv``:
    ResNet-18, b512, bf16, device data, K1, 2 epochs on
    ``synthetic_cifar10(5120, 2048)``, cut from 10,240 training images to
    pay for (0)'s and (4)'s checks) as that pair: a falling loss,
    every image once an epoch, K1 twice and K3 6 times an eval forward
    (36) on each rank, the same metrics on both; its checkpoint restored
    by one process's ``--evaluate`` to the run's accuracy within 2 of
    2,048 images. (3) GoogLeNet at b32 as in (1), K4's forward and
    backward launched on both ranks. (4) SimpleDLA, the train CLI's
    default, at full width, b32, as in (1) with its step in float64
    compute (fp32 parameters; its fp32 step is no closer than 5e-4 to
    its own float64 one), K3 12 times in each rank's eval forward. (0)
    also holds K3 at SimpleDLA's and VGG16's extended slab shapes, K4 at
    PNASNet's, and K5 at every extended slab shape of MobileNet's and
    PNASNet's stencil sites (k = 3, 5, 7; n = 32, zeros along the slab
    edges) within phase 3's tolerances, and the input gradient of
    ShuffleNet's 3 / 2 / 1 average pool (whole and on a slab) on a
    channels_last tensor within 1e-6 of the CPU's float64 one
    (``common._avg_pool2d`` pools an NCHW copy: the library's channels_last
    backward of an overlapping pool is wrong on the card). Prints each
    step's ms on the slowest rank (and the ranks' range) beside one
    process's, a rank's halo exchanges a step and the bytes it sent, and
    the phase's seconds.

``python3 chip_smoke.py --only dp`` runs phases 1, 2 and 18 alone, over
every visible card (the four-card call); it prints neither the kernels
nor the ok line. ``--only mesh`` runs phases 1, 2 and 43's device-group
checks over every visible card: an in-process engine over all of them
(fp32 bit for bit a one-card engine's, bf16 within 2%, K3 6 times a
forward on each card), then the replica as one rank a card against a
one-process fp32 replica; no router, no kernels or ok line. ``--only
elastic`` runs phases 1, 2 and 44: (a) and (b) on one card; on two or
more, (c) JAX's preemption-and-growth scenario at ResNet-18 over NCCL
instead (world 2, rank 1 SIGKILLed after the first durable checkpoint,
world 1, a host added once that rank's ``fit`` began, world 2 to the
end): the survivor exits 75 on its own (its rc, its seconds to leave the
dead collective and which path ended it are printed), no rank but the
killed one is SIGKILLed, the world-1 rank stops cleanly (rc 0), the grown
world resumes and re-cuts both candidates (``checkpoint.reshards`` 2),
and the final checkpoint is two shards. ``--only spatial`` runs phases 1,
2 and 45: on four or more cards over NCCL instead (halos card to card),
one rank a card: (0) as on one card, (1)'s fp32 ResNet-18 eval forward
and step at ``(data, spatial, spatial_w)`` = (1, 4, 1), (1, 2, 2) and
(2, 2, 1), then (2)'s run at (2, 2, 1) (``--num_devices 4
--spatial_devices 2``, K3 6 times an eval forward on each of the 4
ranks); no GoogLeNet or SimpleDLA step. ``--only spatial_zoo`` runs
phases 1, 2 and the model families held beside ResNet, LeNet and
GoogLeNet (``tools/spatial_runs.ZOO``: one registry name a family, at
full width) on the gloo pair on one card as 45 (1) runs ResNet-18, at
b64: the fp32 eval forward against one process's, every rank launching
K3, K4 and K5 as one process's forward does, and one step against one
process's (in float64 compute where ``ZOO`` says so; one process's fp32
step against its float64 one printed as the step's own noise where K4,
which takes bf16 and fp32, is not on the path); each family's halo
exchanges and bytes a step on each rank.

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
"device": ...}`` line — only when every phase passed. Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import base64
import functools
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import weakref

import numpy as np
import torch
import torch.nn.functional as F

# the port's bench helpers: absent outside a checkout of the repository
from pytorch_cifar_tpu_torch.tools._bench import (
    POOL_ODD,
    POOL_SHAPES,
    RESNET18_SITES as SITES,
    STENCIL_SHAPES,
    card_line,
    fused_sites,
    library_pool,
    pool_sites,
    stencil_sites,
    time_ms,
)

# dense peaks (no sparsity) from NVIDIA's data sheets: bf16 tensor-core and
# fp32 CUDA-core FLOP/s, HBM bytes/s. The fp32 kernel runs on the CUDA
# cores (no TF32), so its operation bound uses the fp32 rate.
PEAKS = {
    "H100 SXM": {"bf16": 989e12, "fp32": 67e12, "bytes": 3.35e12},
    "H100 PCIe": {"bf16": 756e12, "fp32": 51e12, "bytes": 2.0e12},
    "H100 NVL": {"bf16": 835e12, "fp32": 60e12, "bytes": 3.9e12},
}

BUCKETS = (1, 8, 32, 128)
INVARIANCE_NS = (1, 3, 8, 32)  # batch sizes held against rows of n = 128
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


class Failures(list):
    def check(self, ok: bool, msg: str) -> bool:
        if not ok:
            self.append(msg)
            print(f"FAIL: {msg}", flush=True)
            print(f"FAIL: {msg}", file=sys.stderr, flush=True)
        return ok


def peaks_for(name: str) -> dict:
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[f"H100 {key}"]
    return PEAKS["H100 SXM"]


def phase_device() -> str:
    smi = card_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return smi


def phase_build(build) -> dict:
    t0 = time.perf_counter()
    secs = build.build_all()
    for name in build.ENTRY_POINTS:
        build.load(name)
    out = {"sources_s": secs, "wall_s": time.perf_counter() - t0}
    print("build " + json.dumps(out), flush=True)
    return out


def phase_kernels(K, peaks, fails: Failures, sites=None, tag="site",
                  runs: int = 25):
    """Per-site rows: correctness at n = 3 and 128 in both dtypes, batch
    invariance at n = 1, 3, 8, 32 against n = 128, and times at n = 128.
    ``sites`` defaults to ResNet-18's."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    rows = []
    for site, h, w, cin, cout, per_fwd in (SITES if sites is None else sites):
        for dname, dt in DTYPES.items():
            x = torch.randn(128, h, w, cin, generator=g).to("cuda", dt)
            wt = (torch.randn(3, 3, cin, cout, generator=g)
                  / (9 * cin) ** 0.5).to("cuda", dt)
            scale = (torch.rand(cout, generator=g) + 0.5).cuda()
            bias = (0.1 * torch.randn(cout, generator=g)).cuda()
            err = 0.0
            outs = {}
            for n in (128, 3):
                xn = x[:n].contiguous()
                out = K.conv3x3_bn_relu(xn, wt, scale, bias)
                torch.cuda.synchronize()
                ref = K.conv3x3_bn_relu_reference(
                    xn.float(), wt.float(), scale, bias
                )
                diff = (out.float() - ref).abs()
                rtol, atol = (1e-4, 1e-4) if dname == "fp32" else (1.6e-2, 1e-2)
                fails.check(
                    bool((diff <= atol + rtol * ref.abs()).all()),
                    f"{site} {dname} n={n}: kernel vs plain max abs "
                    f"{diff.max().item():.3g} over tolerance",
                )
                fails.check(bool(torch.isfinite(out).all()),
                            f"{site} {dname} n={n}: non-finite output")
                err = max(err, diff.max().item())
                outs[n] = out
            inv = True
            for n in INVARIANCE_NS:
                if n not in outs:
                    outs[n] = K.conv3x3_bn_relu(x[:n].contiguous(), wt,
                                                scale, bias)
                same = torch.equal(outs[128][:n], outs[n])
                inv &= same
                fails.check(same, f"{site} {dname}: rows 0..{n - 1} of "
                                  f"n=128 differ from the n={n} output")
            p = K.plan(h, w, cin, cout, dt)

            nbytes = (x.numel() + wt.numel() + outs[128].numel()) \
                * x.element_size() + 2 * cout * 4
            flops = 2 * 128 * h * w * cin * cout * 9
            t_bytes = nbytes / peaks["bytes"] * 1e3
            t_ops = flops / peaks[dname] * 1e3
            x_cl = x.permute(0, 3, 1, 2)
            w_cl = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last
            )
            s4 = scale.to(dt).view(1, -1, 1, 1)
            b4 = bias.to(dt).view(1, -1, 1, 1)
            row = {
                "site": site, "dtype": dname, "n": 128,
                "x": [h, w, cin], "cout": cout, "launches_per_forward": per_fwd,
                "max_abs_err": err, "batch_invariant": inv,
                "plan": dataclasses.asdict(p),
                "ms": time_ms(lambda: K.conv3x3_bn_relu(x, wt, scale, bias),
                              runs),
                # the mma.sync path at this site: the design it replaced
                "sync_path_ms": time_ms(
                    lambda: K.launch(x, wt, scale, bias,
                                     dataclasses.replace(p, path="sync")),
                    runs),
                "plain_ms": time_ms(
                    lambda: K.conv3x3_bn_relu_reference(x, wt, scale, bias),
                    runs,
                ),
                "library_ms": time_ms(
                    lambda: torch.relu(F.conv2d(x_cl, w_cl, padding=1) * s4
                                       + b4), runs,
                ),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            }
            row["tflops"] = flops / row["ms"] / 1e9
            rows.append(row)
            print(f"{tag} " + json.dumps(row), flush=True)
    return rows


def phase_slice(K, smi: str, fails: Failures, model: str = "ResNet18",
                per_forward=None, requests: int = 256,
                buckets=BUCKETS) -> dict:
    """Serve ``model`` at full width under ``run_load`` at ``buckets``.
    ``per_forward`` lists (kernel module, its launch counter's name,
    launches per forward); every counter is reset just before the main
    path and read just after."""
    from pytorch_cifar_tpu_torch.obs import MetricsRegistry
    from pytorch_cifar_tpu_torch.serve import (
        InferenceEngine,
        MicroBatcher,
        run_load,
    )

    if per_forward is None:
        per_forward = [(K, "LAUNCHES", 6)]
    registry = MetricsRegistry()
    for mod, counter, _ in per_forward:
        setattr(mod, counter, 0)  # the main path starts here
    t0 = time.perf_counter()
    engine = InferenceEngine.from_random(
        model, seed=0, buckets=buckets, compute_dtype=torch.bfloat16,
        registry=registry,
    )
    build_s = time.perf_counter() - t0
    rs = np.random.RandomState(0)
    n_off = next(b for b in buckets if b > 1) - 1  # the padded path pads
    x = rs.randint(0, 256, size=(n_off, 32, 32, 3)).astype(np.uint8)
    padded, direct = engine.predict(x), engine.direct_forward(x)
    pad_identical = bool(np.array_equal(padded, direct))
    pad_diff = float(np.max(np.abs(padded - direct)))
    batcher = MicroBatcher(engine, max_wait_ms=2.0, registry=registry)
    try:
        report = run_load(
            batcher, clients=8, requests_per_client=requests, images_max=8,
            seed=0,
        )
    finally:
        batcher.close()
    forwards = engine.forward_count  # the main path ends here
    counts = {f"{mod.__name__.rsplit('.', 1)[-1]}.{counter}":
              getattr(mod, counter) for mod, counter, _ in per_forward}
    for (name, got), (_, _, per) in zip(counts.items(), per_forward):
        fails.check(
            got == per * forwards,
            f"slice {model}: {name} = {got} for {forwards} forwards "
            f"(want {per} per forward)",
        )
    launches = next(iter(counts.values()))
    fails.check(forwards > len(buckets),
                f"slice {model}: no request reached the engine")
    fails.check(engine.compile_count == len(buckets),
                f"slice {model}: compile_count {engine.compile_count}")
    fails.check(report["failed"] == 0,
                f"slice {model}: {report['failed']} failed")
    fails.check(report["requests"] == 8 * requests,
                f"slice {model}: {report['requests']} of {8 * requests} "
                "requests answered")

    # the served logits against the same weights on the CPU (plain path)
    xs = rs.randint(0, 256, size=(5, 32, 32, 3)).astype(np.uint8)
    cpu = InferenceEngine.from_random(
        model, seed=0, buckets=(8,), compute_dtype=torch.float32,
        device="cpu",
    )
    want = cpu.predict(xs)
    got16 = engine.predict(xs)
    got32 = InferenceEngine.from_random(
        model, seed=0, buckets=(8,), compute_dtype=torch.float32,
    ).predict(xs)
    err16 = float(np.max(np.abs(got16 - want)))
    err32 = float(np.max(np.abs(got32 - want)))
    top = float(np.max(np.abs(want)))
    fails.check(
        got16.shape == (5, 10) and bool(np.isfinite(got16).all()),
        f"slice {model}: bf16 logits not finite (5, 10)",
    )
    fails.check(err16 <= 0.02 * top,
                f"slice {model}: bf16 logits off the CPU by {err16:.3g} "
                f"(max |logit| {top:.3g})")
    fails.check(
        bool(np.allclose(got32, want, rtol=1e-3, atol=1e-4)),
        f"slice {model}: fp32 logits off the CPU by {err32:.3g}",
    )
    out = {
        "card": smi,
        "model": model, "dtype": "bf16", "buckets": list(buckets),
        "engine_build_and_warmup_s": build_s,
        "forwards": forwards, "kernel_launches": launches,
        "launches": counts,
        "compiles": engine.compile_count,
        "padded_vs_direct_bit_identical": pad_identical,
        "padded_vs_direct_max_abs_diff": pad_diff, "padded_n": n_off,
        "bf16_vs_cpu_fp32_max_abs": err16, "fp32_vs_cpu_fp32_max_abs": err32,
        "max_abs_logit": top,
        **{k: report[k] for k in (
            "clients", "requests", "images", "failed", "rejected",
            "elapsed_s", "img_per_sec", "request_per_sec", "p50_ms",
            "p95_ms", "p99_ms")},
        "device_ms_p50": registry.summary().get("serve.device_ms.p50"),
        "batches": batcher.stats["batches"],
    }
    print("slice " + json.dumps(out), flush=True)
    return out

# ResNet-18's BatchNorm inputs at n = 512: (h, w, c, BNs per forward)
BN_SHAPES = [(32, 32, 64, 5), (16, 16, 128, 5), (8, 8, 256, 5),
             (4, 4, 512, 5)]
EPOCH_ROWS, TRAIN_N, TEST_N, BATCH = 50_176, 50_000, 10_000, 512


def bound(nbytes: float, ops: float, peaks, ops_rate: str):
    t_bytes = nbytes / peaks["bytes"] * 1e3
    t_ops = ops / peaks[ops_rate] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def launches_bound(rows, per) -> tuple:
    """The bound of a sequence of launches: each launch's own bound (the
    larger of its bytes and operations times) times its count, summed, as
    no two launches overlap; bound by what bounds the larger part."""
    total = sum(r["bound_ms"] * k for r, k in zip(rows, per))
    by_bytes = sum(r["bound_ms"] * k for r, k in zip(rows, per)
                   if r["bound_by"] == "bytes")
    return total, "bytes" if 2 * by_bytes >= total else "operations"


def phase_gather(G, peaks, fails: Failures) -> dict:
    """K1: bit-exact against the plain version on the main path's epoch
    gather and on two byte-path inputs; times at the main path's shape."""
    g = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (TRAIN_N, 32, 32, 3), generator=g,
                           dtype=torch.uint8).cuda()
    order = torch.randperm(TRAIN_N, generator=g)
    idx = order[torch.arange(EPOCH_ROWS) % TRAIN_N].to(torch.int32).cuda()
    out = G.dma_row_gather(images, idx)
    torch.cuda.synchronize()
    ref = G.dma_row_gather_reference(images, idx)
    ok = torch.equal(out, ref)
    err = (out.int() - ref.int()).abs().max().item()
    fails.check(ok and G.vector_path(images, out),
                "K1: epoch gather differs from the plain version (or did "
                "not take the 16-byte path)")
    # 16-byte path at another row size: 12,288-byte float32 rows
    wide = torch.randn(1000, 32, 32, 3, generator=g).cuda()
    ridx = torch.randint(0, 1000, (3000,), generator=g,
                         dtype=torch.int32).cuda()
    got = G.dma_row_gather(wide, ridx)
    torch.cuda.synchronize()
    fails.check(G.vector_path(wide, got)
                and torch.equal(got, G.dma_row_gather_reference(wide, ridx)),
                "K1 12,288-byte rows: differ from the plain version (or did "
                "not take the 16-byte path)")
    # byte path: 252-byte float32 rows, and a base 1 byte off alignment
    rows = torch.randn(1000, 7, 9, generator=g).cuda()
    off = torch.empty(64 * 3072 + 1, dtype=torch.uint8, device="cuda")[1:]
    off = off.view(64, 32, 32, 3)
    off.copy_(images[:64])
    oidx = ridx[:500] % 64
    for name, src, i in (("252-byte rows", rows, ridx),
                         ("misaligned base", off, oidx)):
        got = G.dma_row_gather(src, i)
        torch.cuda.synchronize()
        fails.check(not G.vector_path(src, got),
                    f"K1 {name}: expected the byte path")
        fails.check(torch.equal(got, G.dma_row_gather_reference(src, i)),
                    f"K1 {name}: differs from the plain version")
    nbytes = 2 * EPOCH_ROWS * 3072 + 4 * EPOCH_ROWS
    b_ms, b_by = bound(nbytes, 0, peaks, "fp32")
    flat = torch.empty_like(out)
    row = {
        "images": [TRAIN_N, 32, 32, 3], "idx": EPOCH_ROWS, "exact": ok,
        "max_abs_err": err,
        "ms": time_ms(lambda: G.dma_row_gather(images, idx)),
        "plain_ms": time_ms(lambda: G.dma_row_gather_reference(images, idx)),
        "library_ms": time_ms(lambda: torch.index_select(images, 0, idx)),
        # the same bytes read and written in one contiguous run: what the
        # card gives this work at best (never the port's gather)
        "copy_ms": time_ms(lambda: flat.copy_(out)),
        "bound_ms": b_ms, "bound_by": b_by, "mbytes": nbytes / 1e6,
    }
    print("gather " + json.dumps(row), flush=True)
    return row


def _moments_checks(M, x, what: str, fails: Failures) -> tuple:
    """K2 on ``x`` against the plain version in float64 (rtol 1e-4, atol
    1e-5) and against itself (two launches bit-identical); returns (the
    largest difference, deterministic)."""
    m1, s1 = M.fused_moments(x)
    m2, s2 = M.fused_moments(x)
    torch.cuda.synchronize()
    rm, rs = M.fused_moments_reference(x.double())
    err = 0.0
    for got, ref in ((m1, rm), (s1, rs)):
        diff = (got.double() - ref).abs()
        err = max(err, diff.max().item())
        fails.check(bool((diff <= 1e-5 + 1e-4 * ref.abs()).all()),
                    f"K2 {what}: off the float64 moments by "
                    f"{diff.max().item():.3g}")
    det = torch.equal(m1, m2) and torch.equal(s1, s2)
    fails.check(det, f"K2 {what}: two launches differ")
    return err, det


def kernels_per_call(fns, calls: int = 4) -> tuple:
    """Device kernels that ``calls`` warm calls of each of ``fns`` launch,
    per call, as one ``torch.profiler`` session records them, and their
    names. A session that records no device event at all captured nothing
    (the profiler dropped it) and is taken once more; a count other than
    zero is the result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return len(names) / (calls * len(fns)), sorted(set(names))


def phase_moments(M, peaks, fails: Failures) -> list:
    """K2 at ResNet-18's four BN shapes at n = 512, bf16 and fp32: values
    vs float64, determinism, the gradient and times; then an odd C and a
    view off 16-byte alignment (the scalar path); then device kernels per
    call over all of them (one)."""
    g = torch.Generator().manual_seed(2)
    rows = []
    for h, w, c, per_fwd in BN_SHAPES:
        for dname, dt in DTYPES.items():
            x = (torch.randn(BATCH, h, w, c, generator=g) + 0.5).to("cuda", dt)
            what = f"{dname} {(BATCH, h, w, c)}"
            err, det = _moments_checks(M, x, what, fails)
            a = torch.randn(c, generator=g).cuda()
            b = torch.randn(c, generator=g).cuda()
            grads = []
            for fn in (M.fused_moments, M.fused_moments_reference):
                xr = x.detach().requires_grad_()
                mm, ss = fn(xr)
                (gx,) = torch.autograd.grad((mm * a).sum() + (ss * b).sum(),
                                            xr)
                grads.append(gx.float())
            gerr = (grads[0] - grads[1]).abs().max().item()
            fails.check(gerr <= 1e-6, f"K2 {what}: gradient off by {gerr:.3g}")
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last NCHW view
            nbytes = x.numel() * x.element_size() + 2 * c * 4
            b_ms, b_by = bound(nbytes, 3 * x.numel(), peaks, "fp32")
            with torch.no_grad():
                row = {
                    "x": [BATCH, h, w, c], "dtype": dname,
                    "launches_per_forward": per_fwd, "max_abs_err": err,
                    "deterministic": det, "grad_max_abs_err": gerr,
                    "ms": time_ms(lambda: M.fused_moments(x)),
                    "plain_ms": time_ms(
                        lambda: M.fused_moments_reference(x)),
                    "library_ms": time_ms(
                        lambda: torch.batch_norm_stats(x_nchw, 1e-5)),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "mbytes": nbytes / 1e6,
                }
            rows.append(row)
            print("moments " + json.dumps(row), flush=True)
    scalar = []  # the scalar path: an odd C and a view off alignment
    for dname, dt in DTYPES.items():
        odd = (torch.randn(64, 16, 16, 130, generator=g) + 0.5).to("cuda", dt)
        off = torch.empty(64 * 16 * 16 * 128 + 1, dtype=dt, device="cuda")[1:]
        off = off.view(64, 16, 16, 128)
        off.copy_(torch.randn(off.shape, generator=g) + 0.5)
        for what, v in (("C = 130", odd), ("offset view", off)):
            err, det = _moments_checks(M, v, f"{dname} {what}", fails)
            rows.append({"x": list(v.shape), "dtype": dname, "case": what,
                         "max_abs_err": err, "deterministic": det})
            print("moments " + json.dumps(rows[-1]), flush=True)
            scalar.append(v)
    # every case above, bf16 and fp32, vector and scalar paths, in one
    # profiled session: one device kernel a call, the moments kernel
    xs = [torch.randn(BATCH, h, w, c, generator=g).to("cuda", dt)
          for h, w, c, _ in BN_SHAPES for dt in DTYPES.values()] + scalar
    per_call, names = kernels_per_call(
        [lambda v=v: M.fused_moments(v) for v in xs])
    fails.check(per_call == 1 and all("moments_kernel" in n for n in names),
                f"K2: {per_call} device kernels a call (want 1): {names}")
    for r in rows:
        r["kernels_per_call"] = per_call
    print("moments " + json.dumps({"kernels_per_call": per_call,
                                   "kernels": names, "cases": len(xs)}),
          flush=True)
    return rows


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal element for element, a NaN equal to a NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest absolute difference, 0 where both hold the same value (an
    infinity, or a NaN on both sides); inf where only one side is NaN."""
    d = (a.float() - b.float()).abs()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(d), d)
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def raw_bits(a: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as integers: -0 differs from +0 there."""
    return a.view(torch.int16 if a.element_size() == 2 else torch.int32)


def _pool_checks(P, x, g, what: str, fails: Failures) -> tuple:
    """Kernel against plain version, bit for bit: the forward without and
    with the winner map (as raw bits: the output is the winner's own bits),
    the map itself, and the gradient of ``g``. Returns the measured largest
    differences of the forward and of the backward."""
    ref, ridx = P.max_pool3x3_s1_reference(x, True)
    out = P.max_pool3x3_s1(x)  # no gradient asked for: no map
    out_m, idx = P._forward(x, True)
    gi = P._backward(g, idx)
    torch.cuda.synchronize()
    fails.check(torch.equal(raw_bits(out), raw_bits(ref))
                and torch.equal(raw_bits(out_m), raw_bits(ref)),
                f"K4 {what}: forward differs from the plain version")
    fails.check(torch.equal(idx, ridx),
                f"K4 {what}: winner map differs from the plain version")
    gref = P.max_pool3x3_s1_backward_reference(g, ridx)
    num = ~torch.isnan(gref)  # elsewhere as raw bits: -0 differs from +0
    fails.check(same_bits(gi, gref)
                and torch.equal(raw_bits(gi)[num], raw_bits(gref)[num]),
                f"K4 {what}: backward differs from the plain version")
    xr = x.detach().requires_grad_()
    (ga,) = torch.autograd.grad(P.max_pool3x3_s1(xr), xr, g)
    fails.check(same_bits(ga, gi),
                f"K4 {what}: autograd's gradient differs from the kernel's")
    return (max(max_abs_diff(out, ref), max_abs_diff(out_m, ref)),
            max(max_abs_diff(gi, gref), max_abs_diff(ga, gref)))


def pool_edge_input(P, shape, dt, g, backward: bool = False) -> torch.Tensor:
    """A random input with, on the first band edge of the forward's plan
    (with ``backward``, of the backward's: rows e - 1 | e, which two blocks
    compute), what the kernels must get right: two NaNs in one window
    (image 0), +-0 ties (image 1), -inf rows (image 2); and -inf along
    every border (image 3: windows whose real taps are all -inf keep tap
    0, in the halo, and drop their gradient)."""
    n, h, w, c = shape
    x = torch.randn(shape, generator=g).to("cuda", dt)
    e = P.plan(h, w, c, x.element_size(), 16 // x.element_size(),
               backward=backward).rows
    x[0, e - 1, 3] = float("nan")  # across the edge, one window apart
    x[0, e, 4] = float("nan")
    x[0, e, 10:12] = float("nan")  # two in one row
    signs = torch.randint(0, 2, (4, w, c), generator=g).bool()
    x[1, e - 2:e + 2] = torch.where(signs, 0.0, -0.0).to("cuda", dt)
    x[2, e - 1:e + 1] = float("-inf")
    for border in (np.s_[:2], np.s_[-2:]):
        x[3, border] = float("-inf")
        x[3, :, border] = float("-inf")
    return x


def phase_pool(P, peaks, fails: Failures) -> list:
    """K4 forward (with and without map) and backward against the plain
    version at GoogLeNet's six pool shapes at n = 512 and at an odd shape,
    bf16 and fp32; edge inputs; times beside ``F.max_pool2d`` and the
    bound."""
    g = torch.Generator().manual_seed(5)
    rows = []
    for dname, dt in DTYPES.items():
        # edge inputs at the odd shape (2-byte and 4-byte vectors)
        x = torch.randn(POOL_ODD, generator=g).to("cuda", dt)
        cot = torch.randint(0, 9, POOL_ODD, generator=g).to("cuda", dt)
        nan = x.clone()
        nan[0, 2, 3, 7] = float("nan")
        nan[1, 0, 0, 129] = float("nan")
        for what, v in (("random", x), ("all ties", torch.ones_like(x)),
                        ("NaN", nan),
                        ("-inf map", torch.full_like(x, float("-inf")))):
            _pool_checks(P, v, cot, f"{dname} {POOL_ODD} {what}", fails)
        out = P.max_pool3x3_s1(nan)
        fails.check(int(torch.isnan(out[..., 7]).sum()) == 9
                    and int(torch.isnan(out[..., 129]).sum()) == 4,
                    f"K4 {dname}: a NaN did not win every window holding it")
        lib = library_pool(nan)
        fails.check(torch.equal(torch.isnan(out), torch.isnan(lib)),
                    f"K4 {dname}: NaNs spread otherwise than F.max_pool2d's")
        # the narrowest vectors (2 bytes in bf16, 4 in fp32): an odd C, and
        # a view one element off 16-byte alignment
        odd = torch.randn((3, 5, 5, 33), generator=g).to("cuda", dt)
        off = torch.empty(x.numel() + 1, dtype=dt, device="cuda")[1:]
        off = off.view(POOL_ODD)
        off.copy_(x)
        for what, v in (("C = 33", odd), ("offset view", off)):
            cot = torch.randint(0, 9, v.shape, generator=g).to("cuda", dt)
            _pool_checks(P, v, cot, f"{dname} {tuple(v.shape)} {what}", fails)
        shape = (BATCH, *POOL_SHAPES[0][:3])
        cot = torch.randint(0, 9, shape, generator=g).to("cuda", dt)
        _pool_checks(P, pool_edge_input(P, shape, dt, g), cot,
                     f"{dname} {shape} band edges", fails)
        # the backward's band edges, with cotangents that must not spread:
        # -0 rows across the edge, NaNs and infinities beside it
        e = P.plan(*shape[1:], x.element_size(), 16 // x.element_size(),
                   backward=True).rows
        cot = torch.randint(0, 9, shape, generator=g).to("cuda", dt)
        cot[:, e - 1:e + 1, ::2] = -0.0
        cot[0, e, 5:9] = float("nan")
        cot[1, e - 1, 3] = float("inf")
        cot[2, e - 2:e + 2, 7] = float("-inf")
        _pool_checks(P, pool_edge_input(P, shape, dt, g, backward=True), cot,
                     f"{dname} {shape} backward band edges", fails)
        rows += _pool_rows(P, peaks, fails, POOL_SHAPES, dname, dt, g)
    return rows


def _pool_rows(P, peaks, fails: Failures, shapes, dname: str, dt, g,
               tag: str = "pool") -> list:
    """K4 at each ``(h, w, c, pools per forward)`` of ``shapes`` at n =
    512 in ``dt``: forward with and without map and backward against the
    plain version (``_pool_checks``), against ``F.max_pool2d``, and timed
    beside it and the byte bounds."""
    rows = []
    for h, w, c, per_fwd in shapes:
        shape = (BATCH, h, w, c)
        x = torch.randn(shape, generator=g).to("cuda", dt)
        cot = torch.randint(0, 9, shape, generator=g).to("cuda", dt)
        fwd_err, bwd_err = _pool_checks(P, x, cot, f"{dname} {shape}",
                                        fails)
        # the library pool and its backward compute the same function
        xr = x.detach().requires_grad_()
        lib = library_pool(xr)
        (glib,) = torch.autograd.grad(lib, xr, cot, retain_graph=True)
        _, idx = P._forward(x, True)
        gi = P._backward(cot, idx)
        fails.check(torch.equal(lib.detach(), P.max_pool3x3_s1(x))
                    and torch.equal(glib, gi),
                    f"K4 {dname} {shape}: differs from F.max_pool2d "
                    "(integer cotangents)")
        e, s = x.numel(), x.element_size()
        t_train = (2 * s + 1) * e / peaks["bytes"] * 1e3
        with torch.no_grad():
            row = {
                "x": list(shape), "dtype": dname,
                "pools_per_forward": per_fwd,
                "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_err,
                "fwd_ms": time_ms(lambda: P._forward(x, False), 7, 3),
                "fwd_map_ms": time_ms(lambda: P._forward(x, True), 7, 3),
                "bwd_ms": time_ms(lambda: P._backward(cot, idx), 7, 3),
                "plain_fwd_map_ms": time_ms(
                    lambda: P.max_pool3x3_s1_reference(x, True), 3, 2),
                "plain_bwd_ms": time_ms(
                    lambda: P.max_pool3x3_s1_backward_reference(cot, idx),
                    3, 2),
                "library_fwd_ms": time_ms(lambda: library_pool(x), 7, 3),
                "bound_fwd_ms": 2 * s * e / peaks["bytes"] * 1e3,
                "bound_fwd_map_ms": t_train, "bound_bwd_ms": t_train,
                "mbytes_train_each_way": (2 * s + 1) * e / 1e6,
            }
        row["library_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(lib, xr, cot, retain_graph=True),
            7, 3)
        rows.append(row)
        print(f"{tag} " + json.dumps(row), flush=True)
        del x, cot, xr, lib, glib, idx, gi
    return rows


def phase_stencil(D, peaks, fails: Failures) -> list:
    """K5 against its plain version at MobileNet's five stride-1 depthwise
    shapes (n = 128, k = 3), PNASNet's (k = 5, 7) and a narrow-vector
    shape, bf16 and fp32 (tolerances in :func:`_stencil_row`)."""
    g = torch.Generator().manual_seed(6)
    rows = []
    for n, h, w, c, k, per_fwd in STENCIL_SHAPES:
        for dname, dt in DTYPES.items():
            row = _stencil_row(D, peaks, fails, g, (n, h, w, c), k, dname,
                               dt)
            row["sites_per_forward"] = per_fwd
            rows.append(row)
            print("stencil " + json.dumps(row), flush=True)
    return rows


def _stencil_row(D, peaks, fails: Failures, g, shape, k: int, dname: str,
                 dt, runs: int = 9) -> dict:
    """K5 at one shape against its plain version: fp32 rtol/atol 2e-5 (the
    fp32 sums' order); bf16 against the fp32 plain version on the same
    bf16-rounded inputs, rtol 2^-7 (one bf16 ulp: half for the rounding,
    the rest for a rounding flipped by the sums' order), atol 1e-4. Times
    of the kernel, the plain version and ``F.conv2d(groups=C)``, and the
    bound."""
    n, h, w, c = shape
    x = torch.randn(n, h, w, c, generator=g).to("cuda", dt)
    wt = (torch.randn(k, k, c, generator=g) / k).to("cuda", dt)
    out = D.depthwise_stencil(x, wt)
    torch.cuda.synchronize()
    ref = D.depthwise_stencil_reference(x.float(), wt.float())
    diff = (out.float() - ref).abs()
    rtol, atol = (2e-5, 2e-5) if dname == "fp32" else (2.0 ** -7, 1e-4)
    what = f"K5 {dname} {(n, h, w, c)} k={k}"
    fails.check(bool((diff <= atol + rtol * ref.abs()).all()),
                f"{what}: off the plain version by {diff.max().item():.3g}")
    fails.check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    x_cl = x.permute(0, 3, 1, 2)
    w_cl = wt.permute(2, 0, 1).unsqueeze(1).contiguous()
    s = x.element_size()
    b_ms, b_by = bound(2 * s * x.numel() + wt.numel() * s,
                       2 * k * k * x.numel(), peaks, "fp32")
    return {
        "x": [n, h, w, c], "k": k, "dtype": dname,
        "max_abs_err": diff.max().item(),
        "ms": time_ms(lambda: D.depthwise_stencil(x, wt), runs, 3),
        "plain_ms": time_ms(
            lambda: D.depthwise_stencil_reference(x, wt), 3, 2),
        "library_ms": time_ms(
            lambda: F.conv2d(x_cl, w_cl, padding=k // 2, groups=c), runs, 3),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def phase_pool_step(P, fails: Failures) -> dict:
    """One fp32 GoogLeNet train step (batch 64, augment off, TF32 off) with
    the pools through K4 against one with them through ``F.max_pool2d``,
    from the same start. K4 changes no value of the forward; its backward
    sums a position's windows in another order than the library's, and the
    step amplifies last-bit differences (BN's backward), so both are also
    held against the library-pool step computed in float64 (fp32
    parameters): K4's worst error, in units of each tensor's update, at
    most twice the library step's; the running stats, the forward's work,
    within rtol 1e-5. The direct difference is reported."""
    from pytorch_cifar_tpu_torch.models import common

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(8)
    images = torch.randint(0, 256, (64, 32, 32, 3), generator=g,
                           dtype=torch.uint8).cuda()
    labels = torch.randint(0, 10, (64,), generator=g,
                           dtype=torch.int32).cuda()
    kernel_pool = common.max_pool3x3_s1
    results, launches = {}, {}
    try:
        for mode, dtype in (("k4", torch.float32), ("library", torch.float32),
                            ("f64", torch.float64)):
            common.max_pool3x3_s1 = (
                kernel_pool if mode == "k4" else library_pool)
            st, step = _train_state(9, dtype, "GoogLeNet")
            before = _tensors(st.model)
            P.FWD_LAUNCHES = P.BWD_LAUNCHES = 0
            step(st, (images, labels))
            launches[mode] = (P.FWD_LAUNCHES, P.BWD_LAUNCHES)
            results[mode] = _tensors(st.model)
    finally:
        common.max_pool3x3_s1 = kernel_pool
        torch.backends.cudnn.deterministic = False
    fails.check(launches == {"k4": (9, 9), "library": (0, 0), "f64": (0, 0)},
                f"pool_step: K4 launches {launches}")
    ref = results["f64"]
    stats = [k for k in ref if "running_" in k]
    ok_stats, where, excess = _close({k: results["k4"][k] for k in stats},
                                     {k: results["library"][k] for k in stats},
                                     1e-5, 1e-7)
    fails.check(ok_stats, f"pool_step: K4 step's running stats off at {where} "
                          f"by {excess:.3g} beyond rtol")

    def worst(a, b):
        errs = {k: (a[k] - b[k]).abs().max().item()
                / max((ref[k] - before[k]).abs().max().item(), 1e-30)
                for k in ref if k not in stats}
        at = max(errs, key=errs.get)
        return errs[at], at

    err_k4, at_k4 = worst(results["k4"], ref)
    err_lib, at_lib = worst(results["library"], ref)
    direct, at_direct = worst(results["k4"], results["library"])
    fails.check(err_k4 <= 2 * err_lib,
                f"pool_step: K4 step off the float64 step by {err_k4:.3g} of "
                f"the update at {at_k4}, the library step by {err_lib:.3g} at "
                f"{at_lib}")
    out = {"batch": 64, "dtype": "fp32", "k4_launches": launches["k4"],
           "stats_worst_excess": excess,
           "k4_vs_f64_worst": err_k4, "k4_at": at_k4,
           "library_vs_f64_worst": err_lib, "library_at": at_lib,
           "k4_vs_library_worst": direct, "k4_vs_library_at": at_direct}
    print("pool_step " + json.dumps(out), flush=True)
    return out


def run_dir(prefix: str) -> str:
    """A fresh directory under the checkout's gitignored ``runs/`` for a
    phase's checkpoints; the phase removes it."""
    runs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs")
    os.makedirs(runs, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=runs)


def phase_train(G, M, K3, P, smi: str, fails: Failures, model="ResNet18",
                train_n=TRAIN_N, test_n=TEST_N, k3_per_forward=6,
                pools_per_forward=0, min_acc=50.0, tag="train", D=None,
                stencils_per_forward=0) -> dict:
    """A training slice through ``Trainer.fit``: K1 once per epoch, K3 in
    every eval forward, K4 (``pools_per_forward`` pool branches) forward
    and backward in every train step and forward in every eval forward,
    K5 (``stencils_per_forward`` sites, counted through ``D``) in every
    eval forward. Then one more epoch dispatched with host syncs made
    errors."""
    from pytorch_cifar_tpu_torch.config import TrainConfig
    from pytorch_cifar_tpu_torch.train.trainer import Trainer

    epochs = 2
    out_dir = run_dir(f"{tag}_")  # the trainer writes its best checkpoint
    cfg = TrainConfig(
        model=model, batch_size=BATCH, amp=True, synthetic_data=True,
        synthetic_train_size=train_n, synthetic_test_size=test_n,
        epochs=epochs, cosine_t_max=2, dma_gather=True, device="cuda",
        output_dir=out_dir,
    )
    t0 = time.perf_counter()
    trainer = Trainer(cfg)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path starts here
    G.LAUNCHES = M.LAUNCHES = K3.LAUNCHES = 0
    P.FWD_LAUNCHES = P.BWD_LAUNCHES = 0
    if D is not None:
        D.LAUNCHES = 0
    best = trainer.fit()
    k1, k2, k3 = G.LAUNCHES, M.LAUNCHES, K3.LAUNCHES  # and ends here
    k5 = 0 if D is None else D.LAUNCHES
    shutil.rmtree(out_dir, ignore_errors=True)
    k4f, k4b = P.FWD_LAUNCHES, P.BWD_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    eval_forwards = epochs * -(-test_n // cfg.eval_batch_size)
    train_steps = epochs * trainer.steps_per_epoch
    fails.check(k1 == epochs, f"{tag}: K1 launched {k1} times in {epochs} "
                              "epochs")
    fails.check(k2 == 0, f"{tag}: K2 launched {k2} times with the hook off")
    fails.check(k3 == k3_per_forward * eval_forwards,
                f"{tag}: K3 launched {k3} times for {eval_forwards} eval "
                f"forwards (want {k3_per_forward} each)")
    fails.check(
        k4f == pools_per_forward * (train_steps + eval_forwards)
        and k4b == pools_per_forward * train_steps,
        f"{tag}: K4 launched {k4f} forward, {k4b} backward for {train_steps} "
        f"steps and {eval_forwards} eval forwards (want {pools_per_forward} "
        "each)")
    fails.check(k5 == stencils_per_forward * eval_forwards,
                f"{tag}: K5 launched {k5} times for {eval_forwards} eval "
                f"forwards (want {stencils_per_forward} each)")
    for h in hist:
        fails.check(h["train"]["count"] == train_n,
                    f"{tag}: epoch {h['epoch']} counted "
                    f"{h['train']['count']} images")
        fails.check(h["eval"]["count"] == test_n,
                    f"{tag}: eval {h['epoch']} counted {h['eval']['count']}")
        fails.check(np.isfinite(h["train_loss"]) and
                    np.isfinite(h["eval_loss"]),
                    f"{tag}: epoch {h['epoch']} loss not finite")
        fails.check(h["train"]["nonfinite"] == 0,
                    f"{tag}: epoch {h['epoch']} had non-finite steps")
    fails.check(len(hist) == epochs and
                hist[1]["train_loss"] < hist[0]["train_loss"],
                f"{tag}: the second epoch's loss is not below the first's")
    fails.check(hist[-1]["eval_acc"] > min_acc,
                f"{tag}: final eval accuracy {hist[-1]['eval_acc']:.2f}%")
    # one more epoch with every host sync an error: the epoch's dispatch
    # must not wait for the device; its totals are fetched after the window
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        totals, _ = trainer.dispatch_epoch(epochs)
        synced = None
    except RuntimeError as e:
        synced = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    fails.check(synced is None, f"{tag}: the epoch synced with the host: "
                                f"{synced}")
    if synced is None:
        fails.check(float(totals["count"]) == train_n,
                    f"{tag}: the sync-checked epoch counted "
                    f"{float(totals['count'])} images")
    out = {
        "card": smi, "model": model, "batch": BATCH, "dtype": "bf16",
        "train_n": train_n, "test_n": test_n,
        "steps_per_epoch": trainer.steps_per_epoch,
        "setup_s": setup_s, "best_acc": best,
        "k1_launches": k1, "k2_launches": k2, "k3_launches": k3,
        "k4_fwd_launches": k4f, "k4_bwd_launches": k4b, "k5_launches": k5,
        "first_epoch_s": hist[0]["epoch_s"],
        "peak_mem_gib": peak / 2**30, "epoch_sync_error": synced,
        "epochs": [{k: h[k] for k in ("epoch", "train_loss", "train_acc",
                                      "eval_loss", "eval_acc", "epoch_s",
                                      "img_per_sec")} for h in hist],
    }
    print(f"{tag} " + json.dumps(out), flush=True)
    return out


def _train_state(seed: int, dtype: torch.dtype, model: str = "ResNet18"):
    """A seeded train state of ``model`` on the card and its step computing
    in ``dtype`` (augmentation on in bf16, the bench's setting; off
    otherwise)."""
    from pytorch_cifar_tpu_torch.models import create_model
    from pytorch_cifar_tpu_torch.train.optim import (
        cosine_epoch_schedule, make_optimizer)
    from pytorch_cifar_tpu_torch.train.state import create_train_state
    from pytorch_cifar_tpu_torch.train.steps import make_train_step

    net = create_model(
        model, generator=torch.Generator().manual_seed(seed)
    ).to("cuda", memory_format=torch.channels_last)
    state = create_train_state(
        net, make_optimizer(net.parameters()),
        cosine_epoch_schedule(0.1, 200, 98), seed=seed, device="cuda",
    )
    step = make_train_step(augment=dtype == torch.bfloat16,
                           compute_dtype=dtype, device="cuda")
    return state, step


def _tensors(model) -> dict:
    return {k: v.detach().float().cpu().clone() for k, v in
            model.state_dict().items() if v.is_floating_point()}


def _close(a: dict, b: dict, rtol: float, atol: float):
    """(all within atol + rtol * |b|, the worst tensor, its worst excess
    of |a - b| over rtol * |b|)."""
    excess = {k: ((a[k] - b[k]).abs() - rtol * b[k].abs()).max().item()
              for k in a}
    where = max(excess, key=excess.get)
    return excess[where] <= atol, where, excess[where]


def phase_bn_bench(M, fails: Failures) -> dict:
    """Stock vs fused BN moments in the ResNet-18 b512 bf16 train step."""
    from pytorch_cifar_tpu_torch.models.common import bn_moments_impl

    steps = 10
    g = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (BATCH, 32, 32, 3), generator=g,
                           dtype=torch.uint8).cuda()
    labels = torch.randint(0, 10, (BATCH,), generator=g,
                           dtype=torch.int32).cuda()
    state, step = _train_state(0, torch.bfloat16)

    def run(fused: bool) -> tuple:
        with bn_moments_impl(M.fused_moments if fused else None):
            for _ in range(3):  # warm, outside the counted window
                step(state, (images, labels))
            torch.cuda.synchronize()
            M.LAUNCHES = 0
            t0 = time.perf_counter()
            for _ in range(steps):
                step(state, (images, labels))
            torch.cuda.synchronize()
            return BATCH * steps / (time.perf_counter() - t0), M.LAUNCHES

    ips = {"stock": [], "fused": []}
    launches = {"stock": 0, "fused": 0}
    for mode in ("stock", "fused", "fused", "stock"):
        rate, n = run(mode == "fused")
        ips[mode].append(rate)
        launches[mode] += n
    fails.check(launches["stock"] == 0,
                f"bn_bench: K2 launched {launches['stock']} times unhooked")
    fails.check(launches["fused"] == 20 * 2 * steps,
                f"bn_bench: K2 launched {launches['fused']} times for "
                f"{2 * steps} hooked forwards (want 20 each)")

    # fp32 from the same start: a stock step, a fused step, and the stock
    # step computed in float64 (fp32 parameters) as the reference. An fp32
    # ResNet-18 step is accurate only to a few percent of its update on its
    # worst tensor (BN's backward subtracts nearly equal terms), so the
    # fused step is held to the stock step's own accuracy: its worst error
    # against the float64 step, in units of each tensor's update, at most
    # twice the stock step's; and its running stats, which depend on the
    # forward alone, within rtol 1e-4, atol 1e-6 of the stock step's.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # stock vs stock: bit-identical
    results = {}
    for mode, dtype in (("stock", torch.float32), ("fused", torch.float32),
                        ("f64", torch.float64)):
        st, st_step = _train_state(7, dtype)
        before = _tensors(st.model)
        with bn_moments_impl(M.fused_moments if mode == "fused" else None):
            st_step(st, (images[:64], labels[:64]))
        results[mode] = _tensors(st.model)
    torch.backends.cudnn.deterministic = False
    ref, stock = results["f64"], results["stock"]
    stats = [k for k in ref if "running_" in k]
    ok_stats, where, excess = _close({k: results["fused"][k] for k in stats},
                                     {k: stock[k] for k in stats}, 1e-4, 1e-6)
    fails.check(ok_stats, f"bn_bench: fp32 fused step's running stats off at "
                          f"{where} by {excess:.3g} beyond rtol")

    def worst_error(mode):
        """(largest error against the float64 step in units of the
        tensor's update, that tensor)."""
        errs = {k: (results[mode][k] - ref[k]).abs().max().item()
                / max((ref[k] - before[k]).abs().max().item(), 1e-30)
                for k in ref if k not in stats}
        at = max(errs, key=errs.get)
        return errs[at], at

    err_stock, at_stock = worst_error("stock")
    err_fused, at_fused = worst_error("fused")
    fails.check(err_fused <= 2 * err_stock,
                f"bn_bench: fp32 fused step off the float64 step by "
                f"{err_fused:.3g} of the update at {at_fused}, the stock step "
                f"by {err_stock:.3g} at {at_stock}")
    out = {"steps": steps, "batch": BATCH, "dtype": "bf16",
           "stock_img_per_sec": ips["stock"], "fused_img_per_sec": ips["fused"],
           "k2_launches": launches["fused"],
           "fp32_stats_worst_excess": excess,
           "fp32_stock_worst_error": err_stock, "fp32_stock_at": at_stock,
           "fp32_fused_worst_error": err_fused, "fp32_fused_at": at_fused}
    print("bn_bench " + json.dumps(out), flush=True)
    return out


def phase_card_vs_cpu(fails: Failures) -> dict:
    """One step on the card and on the CPU from the same weights and batch
    (augment off, TF32 off), within rtol 1e-3, atol 1e-5. In fp32 the
    loss, the counts and the running stats (the forward's work) are held;
    the updated parameters are held in a float64-compute step (fp32
    parameters), because in fp32 the step's gradients move by percents
    with the convolutions' last bits (see ``phase_bn_bench``)."""
    from pytorch_cifar_tpu_torch.models import create_model
    from pytorch_cifar_tpu_torch.train.optim import (
        cosine_epoch_schedule, make_optimizer)
    from pytorch_cifar_tpu_torch.train.state import create_train_state
    from pytorch_cifar_tpu_torch.train.steps import (
        METRIC_KEYS, make_train_step)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(4)
    images = torch.randint(0, 256, (32, 32, 32, 3), generator=g,
                           dtype=torch.uint8)
    labels = torch.randint(0, 10, (32,), generator=g, dtype=torch.int32)
    labels[-3:] = -1  # padded rows are masked on both sides
    after, metrics = {}, {}
    for dtype in (torch.float32, torch.float64):
        for dev in ("cuda", "cpu"):
            model = create_model(
                "ResNet18", generator=torch.Generator().manual_seed(5)
            ).to(dev, memory_format=torch.channels_last)
            state = create_train_state(
                model, make_optimizer(model.parameters()),
                cosine_epoch_schedule(0.1, 200, 98), device=dev,
            )
            step = make_train_step(augment=False, compute_dtype=dtype,
                                   device=dev)
            m = step(state, (images.to(dev), labels.to(dev)))
            after[dtype, dev] = _tensors(model)
            metrics[dtype, dev] = {k: float(m[k]) for k in METRIC_KEYS}
    f32, f64 = torch.float32, torch.float64
    m_ok = all(abs(metrics[f32, "cuda"][k] - metrics[f32, "cpu"][k])
               <= 1e-5 + 1e-3 * abs(metrics[f32, "cpu"][k])
               for k in METRIC_KEYS)
    fails.check(m_ok, f"card vs CPU: fp32 metrics {metrics[f32, 'cuda']} vs "
                      f"{metrics[f32, 'cpu']}")
    stats = [k for k in after[f32, "cpu"] if "running_" in k]
    ok32, where32, worst32 = _close(
        {k: after[f32, "cuda"][k] for k in stats},
        {k: after[f32, "cpu"][k] for k in stats}, 1e-3, 1e-5,
    )
    fails.check(ok32, f"card vs CPU: fp32 running stats off at {where32} by "
                      f"{worst32:.3g} beyond rtol")
    ok64, where64, worst64 = _close(after[f64, "cuda"], after[f64, "cpu"],
                                    1e-3, 1e-5)
    fails.check(ok64, f"card vs CPU: float64-compute step off at {where64} "
                      f"by {worst64:.3g} beyond rtol")
    _, where_p, worst_p = _close(after[f32, "cuda"], after[f32, "cpu"], 1e-3,
                                 1e-5)
    out = {"batch": 32, "fp32_loss_sum": metrics[f32, "cuda"]["loss_sum"],
           "fp32_stats_worst_excess": worst32,
           "f64_worst_excess": worst64, "f64_at": where64,
           "fp32_params_worst_excess_not_held": worst_p, "fp32_at": where_p}
    print("card_vs_cpu " + json.dumps(out), flush=True)
    return out


def phase_simpledla(G, M, K, P, D, smi: str, peaks, fails: Failures) -> dict:
    """The train CLI's default model, SimpleDLA: K3 at its 12 fused sites'
    shapes against the plain version (phase 3's checks; among them the
    16 -> 16 and 16 -> 32 sites at 32x32, whose cout the wgmma tile pads
    to 64), served at buckets 8 and 128 (12 K3 launches a forward), and
    trained through ``Trainer.fit`` at b512 bf16 on a cut split (2 epochs
    of 20 steps, 12 K3 launches a forward in eval, a falling loss)."""
    from pytorch_cifar_tpu_torch.config import TrainConfig

    model = TrainConfig().model
    fails.check(model == "SimpleDLA", f"simpledla: the default model is "
                                      f"{model}")
    sites = fused_sites(model)
    fails.check(sum(s[-1] for s in sites) == 12,
                f"simpledla: {sites} fused sites")
    rows = phase_kernels(K, peaks, fails, sites=sites, tag="site_simpledla",
                         runs=5)
    served = phase_slice(K, smi, fails, model=model, requests=64,
                         buckets=(8, 128),
                         per_forward=[(K, "LAUNCHES", 12),
                                      (P, "FWD_LAUNCHES", 0),
                                      (D, "LAUNCHES", 0)])
    trained = phase_train(G, M, K, P, smi, fails, model=model,
                          train_n=10_240, test_n=2_048, k3_per_forward=12,
                          min_acc=0.0, tag="simpledla_train")
    return {"sites": rows, "slice": served, "train": trained}


# the depthwise slice's served models: (K3, K4 forward, K5) launches a
# forward, as the CPU tests pin them; the other three ShuffleNetV2 widths
# are held at their sites
DEPTHWISE_SERVED = {
    "DLA": (12, 0, 0), "MobileNetV2": (1, 0, 14),
    "EfficientNetB0": (0, 0, 12), "PNASNetA": (1, 18, 18),
    "PNASNetB": (1, 18, 54), "ShuffleNetV2_1": (1, 0, 13),
}
DEPTHWISE_FAMILIES = ("MobileNetV2", "EfficientNetB0", "ShuffleNetV2_0.5",
                      "ShuffleNetV2_1", "ShuffleNetV2_1.5", "ShuffleNetV2_2",
                      "PNASNetA", "PNASNetB")
DEPTHWISE_TRAINED = ("EfficientNetB0", "PNASNetB")
DEPTHWISE_REQUESTS = 64  # per client, 8 clients, each served model
EFFICIENTNET_BNS = 48  # live BNs a forward: the stem, 2 in block 0, 3 x 15


def phase_depthwise(G, M, K, P, D, smi: str, peaks,
                    fails: Failures) -> dict:
    """The depthwise slice (phases 19-23 of the module docstring)."""
    secs, t0 = {}, time.perf_counter()
    # K5 at every distinct (h, w, c, k) of the four families, n = 128
    sites: dict = {}
    for name in DEPTHWISE_FAMILIES:
        for h, w, c, k, per in stencil_sites(name):
            sites.setdefault((h, w, c, k), {})[name] = per
    g = torch.Generator().manual_seed(11)
    sten = []
    for (h, w, c, k), per in sites.items():
        for dname, dt in DTYPES.items():
            row = _stencil_row(D, peaks, fails, g, (128, h, w, c), k, dname,
                               dt, runs=5)
            row["sites_per_forward"] = per
            sten.append(row)
            print("stencil_zoo " + json.dumps(row), flush=True)
    secs["stencil_zoo"] = time.perf_counter() - t0
    # K4 at PNASNet's pool inputs, n = 512 (the train batch)
    t0 = time.perf_counter()
    pools = {name: pool_sites(name) for name in ("PNASNetA", "PNASNetB")}
    pool = []
    for dname, dt in DTYPES.items():
        for name, shapes in pools.items():
            for row in _pool_rows(P, peaks, fails, shapes, dname, dt, g,
                                  tag="pool_zoo"):
                row["model"] = name
                pool.append(row)
    secs["pool_zoo"] = time.perf_counter() - t0
    # K3 at the new stems; DLA's sites are SimpleDLA's, held in its phase
    t0 = time.perf_counter()
    held = {r[1:5] for r in fused_sites("SimpleDLA")}
    stems = {}
    for name in DEPTHWISE_SERVED:
        for r in fused_sites(name):
            if r[1:5] not in held:
                stems.setdefault(r[1:5], r)
    k3_rows = phase_kernels(K, peaks, fails, sites=list(stems.values()),
                            tag="site_zoo", runs=5)
    secs["site_zoo"] = time.perf_counter() - t0
    served = {}
    for name, (k3, k4, k5) in DEPTHWISE_SERVED.items():
        t0 = time.perf_counter()
        served[name] = phase_slice(
            K, smi, fails, model=name, requests=DEPTHWISE_REQUESTS,
            buckets=(8, 128),
            per_forward=[(D, "LAUNCHES", k5), (K, "LAUNCHES", k3),
                         (P, "FWD_LAUNCHES", k4), (P, "BWD_LAUNCHES", 0)])
        secs[f"slice_{name}"] = time.perf_counter() - t0
    trained = {}
    for name in DEPTHWISE_TRAINED:
        t0 = time.perf_counter()
        k3, k4, k5 = DEPTHWISE_SERVED[name]
        trained[name] = phase_train(
            G, M, K, P, smi, fails, model=name, train_n=10_240,
            test_n=2_048, k3_per_forward=k3, pools_per_forward=k4,
            min_acc=0.0, tag=f"{name.lower()}_train", D=D,
            stencils_per_forward=k5)
        secs[f"train_{name}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moments = phase_moments_efficientnet(M, fails)
    secs["moments_efficientnet"] = time.perf_counter() - t0
    print("depthwise_s " + json.dumps(secs), flush=True)
    return {"stencil": sten, "pool": pool, "sites": k3_rows,
            "served": served, "trained": trained, "moments": moments}


def phase_moments_efficientnet(M, fails: Failures) -> dict:
    """One b512 bf16 EfficientNetB0 train step under
    ``bn_moments_impl(fused_moments)``: K2 at each of its 48 live BNs
    (2x2 maps of 1,152 channels among them), every launch's moments held
    against the plain version in float64 (rtol 1e-4, atol 1e-5), a finite
    loss."""
    from pytorch_cifar_tpu_torch.models import common

    state, step = _train_state(12, torch.bfloat16, "EfficientNetB0")
    g = torch.Generator().manual_seed(12)
    images = torch.randint(0, 256, (BATCH, 32, 32, 3), generator=g,
                           dtype=torch.uint8).cuda()
    labels = torch.randint(0, 10, (BATCH,), generator=g,
                           dtype=torch.int32).cuda()
    shapes, worst = [], [0.0]

    def checked(x):
        got = M.fused_moments(x)
        ref = M.fused_moments_reference(x.detach().double())
        for a, b in zip(got, ref):
            d = (a.detach().double() - b).abs()
            worst[0] = max(worst[0], d.max().item())
            fails.check(bool((d <= 1e-5 + 1e-4 * b.abs()).all()),
                        f"moments_efficientnet: K2 at {tuple(x.shape)} off "
                        f"the float64 moments by {d.max().item():.3g}")
        shapes.append(tuple(x.shape[1:]))
        return got

    M.LAUNCHES = 0  # the hooked step starts here
    with common.bn_moments_impl(checked):
        metrics = step(state, (images, labels))
    launches = M.LAUNCHES  # and ends here
    loss = float(metrics["loss_sum"]) / float(metrics["count"])
    fails.check(launches == EFFICIENTNET_BNS == len(shapes),
                f"moments_efficientnet: K2 launched {launches} times for "
                f"{len(shapes)} BNs (want {EFFICIENTNET_BNS})")
    fails.check((2, 2, 1152) in shapes,
                "moments_efficientnet: no BN at 2x2 x 1,152")
    fails.check(np.isfinite(loss) and float(metrics["nonfinite"]) == 0,
                f"moments_efficientnet: loss {loss}")
    out = {"k2_launches": launches, "max_abs_err_vs_f64": worst[0],
           "loss": loss, "shapes": sorted(set(shapes))}
    print("moments_efficientnet " + json.dumps(out), flush=True)
    return out


# the zoo's last families, one served name each: (K3, K4 forward, K5)
# launches a forward, as the CPU tests pin them (tests/_torch_zoo.py
# KERNEL_SITES)
ZOO_REST_SERVED = {
    "VGG16": (13, 0, 0), "PreActResNet18": (5, 0, 0), "SENet18": (6, 0, 0),
    "ResNeXt29_2x64d": (0, 0, 0), "RegNetY_400MF": (1, 0, 0),
    "DenseNet121": (0, 0, 0), "DPN26": (1, 0, 0), "ShuffleNetG2": (0, 0, 13),
}
# their K3 sites: VGG16's nine shapes hold the other three models'
ZOO_REST_FUSED = ("VGG16", "PreActResNet18", "PreActResNet50", "SENet18")
ZOO_REST_STENCILS = ("ShuffleNetG2", "ShuffleNetG3")
ZOO_REST_TRAINED = ("VGG16", "DenseNet121")
# BN moments a DenseNet121 train forward reduces on the shared-stats path:
# the stem's output, 58 new chunks and 3 transition outputs, and 58 bn2
# inputs
DENSENET121_MOMENTS = 120


def phase_zoo_rest(G, M, K, P, D, smi: str, peaks,
                   fails: Failures) -> dict:
    """The last families (phases 24-28 of the module docstring)."""
    secs, t0 = {}, time.perf_counter()
    vgg = fused_sites("VGG16")
    per = {name: {r[1:5]: r[5] for r in fused_sites(name)}
           for name in ZOO_REST_FUSED}
    for name, shapes in per.items():
        fails.check(set(shapes) <= set(per["VGG16"]),
                    f"site_zoo_rest: {name}'s K3 shapes {sorted(shapes)} "
                    "are not all VGG16's")
    k3_rows = phase_kernels(K, peaks, fails, sites=vgg,
                            tag="site_zoo_rest", runs=5)
    for r in k3_rows:
        key = (*r["x"], r["cout"])
        r["sites_per_forward"] = {n: s[key] for n, s in per.items()
                                  if key in s}
    secs["site_zoo_rest"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sites: dict = {}
    for name in ZOO_REST_STENCILS:
        for h, w, c, k, n in stencil_sites(name):
            sites.setdefault((h, w, c, k), {})[name] = n
    g = torch.Generator().manual_seed(15)
    sten = []
    for (h, w, c, k), n in sites.items():
        for dname, dt in DTYPES.items():
            row = _stencil_row(D, peaks, fails, g, (128, h, w, c), k, dname,
                               dt, runs=5)
            row["sites_per_forward"] = n
            sten.append(row)
            print("stencil_zoo_rest " + json.dumps(row), flush=True)
    fails.check(len(sites) == 6, f"stencil_zoo_rest: {len(sites)} shapes")
    secs["stencil_zoo_rest"] = time.perf_counter() - t0
    served = {}
    for name, (k3, k4, k5) in ZOO_REST_SERVED.items():
        t0 = time.perf_counter()
        served[name] = phase_slice(
            K, smi, fails, model=name, requests=DEPTHWISE_REQUESTS,
            buckets=(8, 128),
            per_forward=[(K, "LAUNCHES", k3), (D, "LAUNCHES", k5),
                         (P, "FWD_LAUNCHES", k4), (P, "BWD_LAUNCHES", 0)])
        secs[f"slice_{name}"] = time.perf_counter() - t0
    trained = {}
    for name in ZOO_REST_TRAINED:
        t0 = time.perf_counter()
        k3, k4, k5 = ZOO_REST_SERVED[name]
        trained[name] = phase_train(
            G, M, K, P, smi, fails, model=name, train_n=10_240,
            test_n=2_048, k3_per_forward=k3, pools_per_forward=k4,
            min_acc=0.0, tag=f"{name.lower()}_train", D=D,
            stencils_per_forward=k5)
        secs[f"train_{name}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moments = phase_moments_densenet(M, peaks, fails)
    secs["moments_densenet"] = time.perf_counter() - t0
    print("zoo_rest_s " + json.dumps(secs), flush=True)
    return {"sites": k3_rows, "stencil": sten, "served": served,
            "trained": trained, "moments": moments}


def _bn_calls_on_the_cpu(model: str) -> list:
    """The channel counts of every ``bn_batch_moments`` call that one
    train step of ``model`` (2 images, fp32) makes on the CPU, in order."""
    from pytorch_cifar_tpu_torch.models import common, create_model
    from pytorch_cifar_tpu_torch.ops.bn_stats import fused_moments_reference
    from pytorch_cifar_tpu_torch.train.optim import (
        cosine_epoch_schedule, make_optimizer)
    from pytorch_cifar_tpu_torch.train.state import create_train_state
    from pytorch_cifar_tpu_torch.train.steps import make_train_step

    net = create_model(model, generator=torch.Generator().manual_seed(0))
    net = net.to(memory_format=torch.channels_last)
    state = create_train_state(net, make_optimizer(net.parameters()),
                               cosine_epoch_schedule(0.1, 200, 98),
                               device="cpu")
    calls = []

    def counted(v):
        calls.append(v.shape[-1])
        return fused_moments_reference(v)

    g = torch.Generator().manual_seed(1)
    batch = (torch.randint(0, 256, (2, 32, 32, 3), generator=g,
                           dtype=torch.uint8),
             torch.randint(0, 10, (2,), generator=g, dtype=torch.int32))
    with common.bn_moments_impl(counted):
        make_train_step(augment=False, compute_dtype=torch.float32,
                        device="cpu")(state, batch)
    return calls


def phase_moments_densenet(M, peaks, fails: Failures) -> dict:
    """One b512 bf16 DenseNet121 train step under
    ``bn_moments_impl(fused_moments)`` on the shared-stats path: K2 at
    every chunk moment and every ``bn2`` moment, as many launches as the
    same step makes ``bn_batch_moments`` calls on the CPU, each launch's
    moments within rtol 1e-4, atol 1e-5 of float64, which path (16-byte
    vectors or scalar) each took, and K2's times at the step's shapes
    beside ``torch.batch_norm_stats``; K2 at DenseNetCifar's chunk widths
    (C = 12, its scalar path, and 24). Then, in fp32, the shared-stats
    step's loss against the per-layer step's from the same start (rtol
    1e-5)."""
    from pytorch_cifar_tpu_torch.models import common

    cpu_calls = _bn_calls_on_the_cpu("DenseNet121")
    state, step = _train_state(13, torch.bfloat16, "DenseNet121")
    g = torch.Generator().manual_seed(13)
    images = torch.randint(0, 256, (BATCH, 32, 32, 3), generator=g,
                           dtype=torch.uint8).cuda()
    labels = torch.randint(0, 10, (BATCH,), generator=g,
                           dtype=torch.int32).cuda()
    seen, worst, paths = [], [0.0], {}

    def checked(x):
        got = M.fused_moments(x)
        ref = M.fused_moments_reference(x.detach().double())
        for a, b in zip(got, ref):
            d = (a.detach().double() - b).abs()
            worst[0] = max(worst[0], d.max().item())
            fails.check(bool((d <= 1e-5 + 1e-4 * b.abs()).all()),
                        f"moments_densenet: K2 at {tuple(x.shape)} off "
                        f"the float64 moments by {d.max().item():.3g}")
        c, esize = x.shape[-1], x.element_size()
        vec = c % (16 // esize) == 0 and x.data_ptr() % 16 == 0
        key = f"C={c} {'vector' if vec else 'scalar'}"
        paths[key] = paths.get(key, 0) + 1
        seen.append(tuple(x.shape))
        return got

    M.LAUNCHES = 0  # the hooked step starts here
    with common.bn_moments_impl(checked):
        metrics = step(state, (images, labels))
    launches = M.LAUNCHES  # and ends here
    loss = float(metrics["loss_sum"]) / float(metrics["count"])
    fails.check(launches == len(seen) == len(cpu_calls)
                == DENSENET121_MOMENTS,
                f"moments_densenet: K2 launched {launches} times for "
                f"{len(seen)} moments; the CPU step makes {len(cpu_calls)} "
                f"calls (want {DENSENET121_MOMENTS})")
    fails.check([s[-1] for s in seen] == cpu_calls,
                "moments_densenet: the card's channel counts are not the "
                "CPU step's")
    fails.check(np.isfinite(loss) and float(metrics["nonfinite"]) == 0,
                f"moments_densenet: loss {loss}")
    # K2's time over the step's launches, at each distinct shape
    shapes: dict = {}
    for s in seen:
        shapes[s] = shapes.get(s, 0) + 1
    rows = []
    for s, n in shapes.items():
        x = (torch.randn(s, generator=g) + 0.5).to("cuda", torch.bfloat16)
        x_nchw = x.permute(0, 3, 1, 2)
        b_ms, b_by = bound(x.numel() * 2 + 2 * s[-1] * 4, 3 * x.numel(),
                           peaks, "fp32")
        with torch.no_grad():
            rows.append({
                "x": list(s), "launches": n, "bound_ms": b_ms,
                "bound_by": b_by,
                "ms": time_ms(lambda: M.fused_moments(x), 5, 3),
                "plain_ms": time_ms(lambda: M.fused_moments_reference(x),
                                    5, 3),
                "library_ms": time_ms(
                    lambda: torch.batch_norm_stats(x_nchw, 1e-5), 5, 3)})
    step_k2 = {k: sum(r[k] * r["launches"] for r in rows)
               for k in ("ms", "plain_ms", "library_ms")}
    b_ms, b_by = launches_bound(rows, [r["launches"] for r in rows])
    # DenseNetCifar's chunks: growth 12, not a multiple of 8 bf16 values,
    # so K2 takes its scalar path there (never on this step's path)
    narrow = []
    for c in (12, 24):
        x = (torch.randn(BATCH, 32, 32, c, generator=g) + 0.5).to(
            "cuda", torch.bfloat16)
        err, det = _moments_checks(M, x, f"bf16 {(BATCH, 32, 32, c)}", fails)
        x_nchw = x.permute(0, 3, 1, 2)
        nb_ms, nb_by = bound(x.numel() * 2 + 2 * c * 4, 3 * x.numel(), peaks,
                             "fp32")
        with torch.no_grad():
            narrow.append({
                "x": [BATCH, 32, 32, c], "path": "scalar" if c % 8
                else "vector", "max_abs_err": err, "deterministic": det,
                "bound_ms": nb_ms, "bound_by": nb_by,
                "ms": time_ms(lambda: M.fused_moments(x), 5, 3),
                "library_ms": time_ms(
                    lambda: torch.batch_norm_stats(x_nchw, 1e-5), 5, 3)})
    # fp32, stock moments: the shared-stats step against the per-layer one
    losses = {}
    for shared in (True, False):
        st, step32 = _train_state(14, torch.float32, "DenseNet121")
        st.model.shared_stats = shared
        m32 = step32(st, (images[:128], labels[:128]))
        losses[shared] = float(m32["loss_sum"]) / float(m32["count"])
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    fails.check(rel <= 1e-5, f"moments_densenet: fp32 shared-stats loss "
                             f"{losses[True]!r} vs per-layer "
                             f"{losses[False]!r} (rel {rel:.3g})")
    out = {"k2_launches": launches, "cpu_calls": len(cpu_calls),
           "max_abs_err_vs_f64": worst[0], "loss": loss, "paths": paths,
           "step": {**step_k2, "bound_ms": b_ms, "bound_by": b_by},
           "shapes": rows, "densenet_cifar_chunks": narrow,
           "fp32_shared_loss": losses[True],
           "fp32_per_layer_loss": losses[False], "fp32_rel_diff": rel}
    print("moments_densenet " + json.dumps(out), flush=True)
    return out


def fs_type(path: str) -> str:
    """The filesystem type of the mount holding ``path``
    (``/proc/mounts``)."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt, typ = parts[1], parts[2]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best):
                best, kind = mnt, typ
    return kind


def phase_ckpt(G, K3, smi: str, fails: Failures) -> dict:
    """Checkpoints, preemption and resume, serving and evaluating from a
    checkpoint (phase 17 of the module docstring)."""
    from pytorch_cifar_tpu_torch.compat import snapshot_state
    from pytorch_cifar_tpu_torch.config import TrainConfig
    from pytorch_cifar_tpu_torch.data.cifar10 import synthetic_cifar10
    from pytorch_cifar_tpu_torch.serve import InferenceEngine
    from pytorch_cifar_tpu_torch.train.checkpoint import (
        CKPT_NAME, LAST_NAME, AsyncCheckpointWriter, meta_path,
        restore_checkpoint, save_checkpoint)
    from pytorch_cifar_tpu_torch.train.trainer import Trainer

    train_n, test_n = 10_240, 2_048
    root = run_dir("ckpt_")

    def config(out_dir, **kw):
        return TrainConfig(
            model="ResNet18", batch_size=BATCH, amp=True,
            synthetic_data=True, synthetic_train_size=train_n,
            synthetic_test_size=test_n, epochs=2, cosine_t_max=2,
            dma_gather=True, device="cuda", output_dir=out_dir, **kw)

    try:
        # (a) the uninterrupted run
        run_a = Trainer(config(os.path.join(root, "a")))
        run_a.fit()
        # (b) a run stopped after epoch 0
        b_dir = os.path.join(root, "b")
        run_b = Trainer(config(b_dir))
        run_b.request_stop()
        run_b.fit()
        files_b = sorted(os.listdir(b_dir))
        fails.check(LAST_NAME in files_b and CKPT_NAME in files_b,
                    f"ckpt: the stopped run wrote {files_b}")
        live = snapshot_state(run_b.state).host()
        # (c) resume
        run_c = Trainer(config(b_dir, resume=True))
        back = snapshot_state(run_c.state).host()
        params = dict(run_c.state.model.named_parameters())
        bufs = [run_c.state.optimizer.state[p]["momentum_buffer"]
                for p in params.values()]
        fails.check(
            back.spans == live.spans and back.step == live.step
            and bool(torch.equal(raw_bits(back.flat), raw_bits(live.flat))),
            "ckpt: the restored state is not the stopped run's, bit for bit")
        fails.check(
            all(b.is_cuda and b.stride() == p.stride()
                for b, p in zip(bufs, params.values()))
            and all(p.is_cuda for p in params.values()),
            "ckpt: the restored state is not on the card in its layout")
        fails.check(run_c.start_epoch == 1,
                    f"ckpt: resume starts at epoch {run_c.start_epoch}")
        G.LAUNCHES = K3.LAUNCHES = 0  # the resume path starts here
        run_c.fit()
        k1, k3 = G.LAUNCHES, K3.LAUNCHES  # and ends here
        eval_forwards = -(-test_n // run_c.eval_bs)
        fails.check(k1 == 1, f"ckpt: the resumed epoch launched K1 {k1} "
                             "times")
        fails.check(k3 == 6 * eval_forwards,
                    f"ckpt: the resumed epoch launched K3 {k3} times for "
                    f"{eval_forwards} eval forwards")
        loss_a, loss_c = (run_a.history[1]["train_loss"],
                          run_c.history[0]["train_loss"])
        fails.check(
            len(run_c.history) == 1 and np.isfinite(loss_c)
            and abs(loss_c - loss_a) <= 0.01 * abs(loss_a),
            f"ckpt: the resumed epoch-1 loss {loss_c} is not within 1% of "
            f"the uninterrupted run's {loss_a}")
        fails.check(not os.path.exists(os.path.join(b_dir, LAST_NAME)),
                    "ckpt: last.msgpack outlived the completed run")
        # (d) serve the checkpoint
        te_x = synthetic_cifar10(n_train=train_n, n_test=test_n)[2][:256]
        engine = InferenceEngine.from_checkpoint(
            b_dir, "ResNet18", compute_dtype=torch.bfloat16)
        forwards0 = engine.forward_count
        K3.LAUNCHES = 0  # the serving path starts here
        got = engine.predict(te_x)
        served_k3, forwards = K3.LAUNCHES, engine.forward_count - forwards0
        want = InferenceEngine.from_checkpoint(
            b_dir, "ResNet18", compute_dtype=torch.float32, device="cpu",
            buckets=(256,)).predict(te_x)
        err, top = float(np.max(np.abs(got - want))), float(
            np.max(np.abs(want)))
        fails.check(served_k3 == 6 * forwards and forwards > 0,
                    f"ckpt: serving launched K3 {served_k3} times for "
                    f"{forwards} forwards")
        fails.check(got.shape == (256, 10) and bool(np.isfinite(got).all())
                    and err <= 0.02 * top,
                    f"ckpt: served logits off the CPU by {err:.3g} (max "
                    f"|logit| {top:.3g})")
        # (e) evaluate the best checkpoint
        run_e = Trainer(config(b_dir, evaluate=True))
        K3.LAUNCHES = 0  # the evaluate path starts here
        acc = run_e.fit()
        eval_k3 = K3.LAUNCHES
        with open(meta_path(b_dir, CKPT_NAME)) as f:
            best = json.load(f)["best_acc"]
        fails.check(abs(acc - best) * test_n / 100.0 <= 2.0,
                    f"ckpt: --evaluate gives {acc}%, the sidecar {best}%")
        fails.check(eval_k3 == 6 * eval_forwards,
                    f"ckpt: --evaluate launched K3 {eval_k3} times")
        # timed saves and restores of B's state
        timed = os.path.join(root, "timed")
        writer = AsyncCheckpointWriter()
        stall, commit, restore = [], [], []
        for i in range(3):
            done = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(timed, run_b.state, i, 1.0, writer=writer,
                            on_commit=lambda: done.setdefault(
                                "t", time.perf_counter()))
            t1 = time.perf_counter()
            writer.flush()
            stall.append((t1 - t0) * 1e3)
            commit.append((done["t"] - t1) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore_checkpoint(timed, run_e.state)
            torch.cuda.synchronize()
            restore.append((time.perf_counter() - t0) * 1e3)
        writer.close()
        payload = os.path.getsize(os.path.join(timed, CKPT_NAME))
        out = {
            "card": smi, "model": "ResNet18", "batch": BATCH,
            "dtype": "bf16", "train_n": train_n, "test_n": test_n,
            "output_dir_fs": fs_type(root),
            "payload_bytes": payload,
            "save_stall_ms": stall, "commit_ms": commit,
            "restore_ms": restore,
            "restored_bits_equal": bool(torch.equal(raw_bits(back.flat),
                                                    raw_bits(live.flat))),
            "step": back.step, "resume_start_epoch": run_c.start_epoch,
            "resume_k1_launches": k1, "resume_k3_launches": k3,
            "epoch1_train_loss_uninterrupted": loss_a,
            "epoch1_train_loss_resumed": loss_c,
            "served_forwards": forwards, "served_k3_launches": served_k3,
            "served_bf16_vs_cpu_fp32_max_abs": err, "max_abs_logit": top,
            "evaluate_acc": acc, "sidecar_best_acc": best,
            "evaluate_k3_launches": eval_k3,
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"ckpt card {smi}: payload {payload} B, save stall "
          f"{np.median(stall):.2f} ms, commit {np.median(commit):.2f} ms, "
          f"restore {np.median(restore):.2f} ms (medians of 3; "
          f"{out['output_dir_fs']})", flush=True)
    print("ckpt " + json.dumps(out), flush=True)
    return out


# -- data parallelism -------------------------------------------------------

PARITY_BATCH = 64  # the parity step's global batch
DP_RTOL, DP_ATOL = 1e-4, 1e-5  # the parity step's loss and BN buffers


def _seeded_state(device, seed: int):
    from pytorch_cifar_tpu_torch.models import create_model
    from pytorch_cifar_tpu_torch.train.optim import (
        cosine_epoch_schedule, make_optimizer)
    from pytorch_cifar_tpu_torch.train.state import create_train_state

    net = create_model(
        "ResNet18", generator=torch.Generator().manual_seed(seed)
    ).to(device, memory_format=torch.channels_last)
    return create_train_state(
        net, make_optimizer(net.parameters()),
        cosine_epoch_schedule(0.1, 200, 98), seed=seed, device=device)


def _shard_of(n: int, seed: int, device, axis) -> tuple:
    """This rank's contiguous shard (all of it without ``axis``) of a
    seeded global batch of ``n`` images, 5 trailing rows labelled -1."""
    from pytorch_cifar_tpu_torch.parallel.mesh import rank, world_size

    g = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (n, 32, 32, 3), generator=g,
                           dtype=torch.uint8)
    labels = torch.randint(0, 10, (n,), generator=g, dtype=torch.int32)
    labels[-5:] = -1  # on the last rank only: a ragged shard
    w, r = (world_size(), rank()) if axis else (1, 0)
    rows = slice(r * n // w, (r + 1) * n // w)
    return images[rows].to(device), labels[rows].to(device)


def parity_steps(device, axis) -> dict:
    """One fp32 and one float64-compute step (fp32 parameters, TF32 off,
    augmentation off) of a seeded ResNet-18 on this rank's shard of a
    seeded global batch, under cross-replica BN when ``axis`` is given:
    the fp32 step's metrics, BN buffers and parameters, the float64 step's
    parameters, as CPU tensors."""
    from pytorch_cifar_tpu_torch.train.steps import METRIC_KEYS, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = _shard_of(PARITY_BATCH, 13, device, axis)
    out = {}
    for name, dtype in (("fp32", torch.float32), ("f64", torch.float64)):
        state = _seeded_state(device, 12)
        step = make_train_step(augment=False, compute_dtype=dtype,
                               axis_name=axis, sync_bn=axis is not None,
                               device=device)
        m = step(state, (x, y))
        out[name] = {"metrics": {k: float(m[k]) for k in METRIC_KEYS},
                     "tensors": _tensors(state.model)}
    return out


def k2_step(device, axis, batch: int) -> tuple:
    """One bf16 ResNet-18 step (global batch ``batch``) under cross-replica
    BN with the BN moments through K2: (K2 launches, the step's loss
    sum)."""
    from pytorch_cifar_tpu_torch.models.common import bn_moments_impl
    from pytorch_cifar_tpu_torch.ops import bn_stats as M
    from pytorch_cifar_tpu_torch.train.steps import make_train_step

    state = _seeded_state(device, 14)
    step = make_train_step(compute_dtype=torch.bfloat16, axis_name=axis,
                           sync_bn=True, device=device)
    shard = _shard_of(batch, 15, device, axis)
    with bn_moments_impl(M.fused_moments):
        M.LAUNCHES = 0  # the hooked step starts here
        m = step(state, shard)
        launches = M.LAUNCHES  # and ends here
    return launches, float(m["loss_sum"])


def state_digest(trainer) -> dict:
    """A rank hook: the SHA-256 of the rank's params, BN buffers and
    momentum buffers as raw bits (``compat.snapshot_state``), its step."""
    import hashlib

    from pytorch_cifar_tpu_torch.compat import snapshot_state

    snap = snapshot_state(trainer.state).host()
    return {"digest": hashlib.sha256(snap.flat.numpy().tobytes()).hexdigest(),
            "step": snap.step}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dp_rank_hook(trainer, sync_check: bool, batch: int = BATCH) -> dict:
    """What each rank of a data-parallel run checks after ``fit``, inside
    its process group: the state's digest; over several ranks a format v3
    ``last.msgpack`` of it and the parity steps (rank 0 returns them); the
    K2 step at global batch ``batch``; the time of the step's flat
    all-reduce (gradients and BN running buffers); and, when
    ``sync_check``, one more epoch dispatched with host syncs made
    errors."""
    import torch.distributed as dist

    from pytorch_cifar_tpu_torch.parallel.dp import (
        all_reduce_mean_, bn_running_buffers)
    from pytorch_cifar_tpu_torch.parallel.mesh import DATA_AXIS
    from pytorch_cifar_tpu_torch.train.checkpoint import (
        LAST_NAME, save_checkpoint)

    dev = trainer.device
    out = {**state_digest(trainer), "backend": dist.get_backend(),
           "world": trainer.world, "device": str(dev)}
    if trainer.world > 1:
        save_checkpoint(trainer.ckpt_dir, trainer.state,
                        trainer.history[-1]["epoch"], trainer.best_acc,
                        name=LAST_NAME)
        parity = parity_steps(dev, DATA_AXIS)
        out["parity"] = parity if trainer.rank == 0 else None
    out["k2_launches"], out["k2_loss_sum"] = k2_step(dev, DATA_AXIS, batch)
    model = trainer.state.model
    flat = [p.grad for p in model.parameters() if p.grad is not None] \
        + bn_running_buffers(model)
    out["allreduce_bytes"] = sum(t.numel() * t.element_size() for t in flat)
    reps = 10
    all_reduce_mean_(flat)  # warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        all_reduce_mean_(flat)
    _sync(dev)
    out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3 / reps
    if sync_check and dev.type == "cuda":
        _sync(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            totals, _ = trainer.dispatch_epoch(trainer.config.epochs)
            synced = None
        except RuntimeError as e:
            synced = str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out["sync_error"] = synced
        out["sync_epoch_count"] = (float(totals["count"]) if synced is None
                                   else None)
    return out


def _dp_run_checks(tag: str, ranks: list, train_n: int, test_n: int,
                   fails: Failures, min_acc: float) -> dict:
    """The checks every data-parallel run is held to, from its ranks'
    results: launches per rank, global counts, falling finite losses, the
    same metrics and state on every rank, K2 on the hooked step, and the
    sync-checked epoch where it ran."""
    epochs = 2
    h0 = ranks[0]["history"]
    world = ranks[0]["world"]
    eval_forwards = epochs * -(-test_n // (1000 // world * world))
    for res in ranks:
        r, L, hook = res["rank"], res["launches_by_kernel"], res["hook"]
        fails.check(L["dma_row_gather"] == epochs,
                    f"{tag}: rank {r} launched K1 {L['dma_row_gather']} "
                    f"times in {epochs} epochs")
        fails.check(L["conv3x3_bn_relu"] == 6 * eval_forwards,
                    f"{tag}: rank {r} launched K3 {L['conv3x3_bn_relu']} "
                    f"times for {eval_forwards} eval forwards (want 6 each)")
        fails.check(L["fused_moments"] == 0,
                    f"{tag}: rank {r} launched K2 {L['fused_moments']} "
                    "times with the hook off")
        fails.check(hook["k2_launches"] == 20 and
                    np.isfinite(hook["k2_loss_sum"]),
                    f"{tag}: rank {r}'s sync_bn step launched K2 "
                    f"{hook['k2_launches']} times (want 20), loss sum "
                    f"{hook['k2_loss_sum']}")
        fails.check([h["train"] for h in res["history"]]
                    == [h["train"] for h in h0]
                    and [h["eval"] for h in res["history"]]
                    == [h["eval"] for h in h0],
                    f"{tag}: rank {r}'s metrics differ from rank 0's")
        fails.check(hook["digest"] == ranks[0]["hook"]["digest"],
                    f"{tag}: rank {r}'s state differs from rank 0's")
        if "sync_error" in hook:
            fails.check(hook["sync_error"] is None,
                        f"{tag}: rank {r}'s epoch synced with the host: "
                        f"{hook['sync_error']}")
            fails.check(hook["sync_error"] is not None
                        or hook["sync_epoch_count"] == train_n,
                        f"{tag}: rank {r}'s sync-checked epoch counted "
                        f"{hook['sync_epoch_count']} images")
    for h in h0:
        fails.check(h["train"]["count"] == train_n
                    and h["eval"]["count"] == test_n,
                    f"{tag}: epoch {h['epoch']} counted "
                    f"{h['train']['count']} / {h['eval']['count']} images")
        fails.check(np.isfinite(h["train_loss"]) and
                    h["train"]["nonfinite"] == 0,
                    f"{tag}: epoch {h['epoch']} loss not finite")
    fails.check(len(h0) == epochs
                and h0[1]["train_loss"] < h0[0]["train_loss"],
                f"{tag}: the second epoch's loss is not below the first's")
    fails.check(h0[-1]["eval_acc"] > min_acc,
                f"{tag}: final eval accuracy {h0[-1]['eval_acc']:.2f}%")
    return {
        "backend": ranks[0]["backend"], "world": ranks[0]["world"],
        "devices": [res["device"] for res in ranks],
        "train_n": train_n, "test_n": test_n,
        "launches_per_rank": [res["launches_by_kernel"] for res in ranks],
        "k2_launches_per_rank": [res["hook"]["k2_launches"] for res in ranks],
        "allreduce_bytes": ranks[0]["hook"]["allreduce_bytes"],
        "allreduce_ms": [res["hook"]["allreduce_ms"] for res in ranks],
        "sync_error": ranks[0]["hook"].get("sync_error"),
        "epochs": [{k: h[k] for k in ("epoch", "train_loss", "train_acc",
                                      "eval_loss", "eval_acc", "epoch_s",
                                      "img_per_sec")} for h in h0],
    }


def _parity_checks(tag: str, got: dict, fails: Failures) -> dict:
    """Rank 0's cross-replica BN steps against one process's steps on the
    whole global batch (plain BN), on the card."""
    want = parity_steps("cuda", None)
    metrics_ok = all(
        abs(got["fp32"]["metrics"][k] - want["fp32"]["metrics"][k])
        <= DP_ATOL + DP_RTOL * abs(want["fp32"]["metrics"][k])
        for k in want["fp32"]["metrics"])
    fails.check(metrics_ok, f"{tag} parity: fp32 metrics "
                            f"{got['fp32']['metrics']} vs one process's "
                            f"{want['fp32']['metrics']}")
    stats = [k for k in want["fp32"]["tensors"] if "running_" in k]
    ok32, where32, worst32 = _close(
        {k: got["fp32"]["tensors"][k] for k in stats},
        {k: want["fp32"]["tensors"][k] for k in stats}, DP_RTOL, DP_ATOL)
    fails.check(ok32, f"{tag} parity: fp32 BN buffers off at {where32} by "
                      f"{worst32:.3g} beyond rtol")
    ok64, where64, worst64 = _close(got["f64"]["tensors"],
                                    want["f64"]["tensors"], 1e-3, 1e-5)
    fails.check(ok64, f"{tag} parity: float64-compute step off at "
                      f"{where64} by {worst64:.3g} beyond rtol")
    _, where_p, worst_p = _close(got["fp32"]["tensors"],
                                 want["fp32"]["tensors"], 1e-3, 1e-5)
    return {"fp32_loss_sum": got["fp32"]["metrics"]["loss_sum"],
            "one_process_loss_sum": want["fp32"]["metrics"]["loss_sum"],
            "fp32_stats_worst_excess": worst32, "f64_worst_excess": worst64,
            "f64_at": where64, "fp32_params_worst_excess_not_held": worst_p,
            "fp32_at": where_p}


def phase_dp(G, M, K3, smi: str, fails: Failures) -> dict:
    """Data parallelism through the train CLI (phase 18 of the module
    docstring)."""
    from pytorch_cifar_tpu_torch.tools import dp_runs
    from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
    from pytorch_cifar_tpu_torch.train.launch import free_port

    count = torch.cuda.device_count()
    world = min(count, 4)
    root = run_dir("dp_")
    out = {"card": smi, "visible_cards": count, "runs": []}
    try:
        # (a) NCCL at world = the visible cards (capped at 4)
        nccl_dir = os.path.join(root, "nccl")
        argv = dp_runs.run_argv(nccl_dir, TRAIN_N, TEST_N)
        argv += (["--distributed", "--dist_coord", f"localhost:{free_port()}",
                  "--dist_procs", "1", "--dist_rank", "0"] if world == 1
                 else ["--num_devices", str(world)])
        hook = functools.partial(dp_rank_hook, sync_check=True, batch=BATCH)
        # the data-parallel path starts here (ranks spawned for world > 1
        # start with their own counts at 0)
        G.LAUNCHES = M.LAUNCHES = K3.LAUNCHES = 0
        nccl = train_main(argv, rank_hook=hook)["ranks"]  # and ends here
        out["runs"].append(_dp_run_checks("dp nccl", nccl, TRAIN_N, TEST_N,
                                          fails, min_acc=50.0))
        multi, multi_dir, parity_tag = nccl, nccl_dir, "nccl"
        # (b) on one card, also two gloo ranks on cuda:0
        if count == 1:
            gloo_dir = os.path.join(root, "gloo")
            gloo = dp_runs.gloo_pair(
                dp_runs.run_argv(gloo_dir),
                functools.partial(dp_rank_hook, sync_check=False,
                                  batch=BATCH))
            out["runs"].append(_dp_run_checks(
                "dp gloo", gloo, dp_runs.TRAIN_N, dp_runs.TEST_N, fails,
                min_acc=0.0))
            multi, multi_dir, parity_tag = gloo, gloo_dir, "gloo"
        # (c) parity of the cross-replica BN step at world >= 2
        if multi[0]["world"] > 1:
            out["parity"] = _parity_checks(f"dp {parity_tag}",
                                           multi[0]["hook"]["parity"], fails)
            out["parity"]["world"] = multi[0]["world"]
            out["parity"]["backend"] = multi[0]["backend"]
            # (d) its v3 checkpoint, resumed by one process
            with open(os.path.join(multi_dir, "last.json")) as f:
                meta = json.load(f)
            fails.check(meta.get("format") == 3
                        and len(meta["shards"]) == multi[0]["world"],
                        f"dp: the {parity_tag} run's last.msgpack is not a "
                        f"v3 set of {multi[0]['world']} shards: {meta}")
            resumed = train_main(
                dp_runs.run_argv(multi_dir) + ["--resume", "--num_devices",
                                               "1"],
                rank_hook=state_digest)["ranks"][0]
            fails.check(resumed["hook"] == {
                "digest": multi[0]["hook"]["digest"],
                "step": multi[0]["hook"]["step"]},
                f"dp: the one-process resume of the {parity_tag} run's v3 "
                "checkpoint does not hold its state as raw bits")
            out["resume"] = {"shards": len(meta["shards"]),
                             "bits_equal": resumed["hook"]["digest"]
                             == multi[0]["hook"]["digest"],
                             "step": resumed["hook"]["step"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for run in out["runs"]:
        e1 = run["epochs"][-1]
        print(f"dp card {smi}: {run['backend']} world {run['world']} on "
              f"{run['devices']}: {e1['img_per_sec']:.0f} img/s (epoch 1, "
              f"eval included), flat all-reduce of "
              f"{run['allreduce_bytes']} B: "
              f"{np.median(run['allreduce_ms']):.3f} ms a step", flush=True)
    print("dp " + json.dumps(out), flush=True)
    return out


def zoo_forwards(dw: dict, served=None) -> dict:
    """Per served model with stencil sites (``served``: name -> (K3, K4,
    K5), the depthwise slice's by default): K5's launches in its served run
    and the times of one bucket-128 bf16 forward's launches at their
    shapes."""
    out = {}
    for model, (_, _, k5) in (served or DEPTHWISE_SERVED).items():
        fwd = [r for r in dw["stencil"] if r["dtype"] == "bf16"
               and model in r["sites_per_forward"]]
        if not fwd:
            continue
        per = [r["sites_per_forward"][model] for r in fwd]
        b_ms, b_by = launches_bound(fwd, per)
        out[model] = {
            "launches_per_forward": k5,
            "launches": dw["served"][model]["launches"][
                "depthwise_stencil.LAUNCHES"],
            **{k: sum(r[k] * n for r, n in zip(fwd, per))
               for k in ("ms", "plain_ms", "library_ms")},
            "bound_ms": b_ms, "bound_by": b_by,
        }
    return out


# -- the rest of the trainer: the sentinel, remat, the host loader ---------

CUT_TRAIN, CUT_TEST = 10_240, 2_048  # googlenet_train's cut: 20 steps
CUT_STEPS, CUT_EVAL_FORWARDS = 20, 3  # a step per 512, 1000-image evals
SENTINEL_STEP = 25  # the poisoned global step: epoch 1's sixth
ROLLBACK_STEP = 23  # the rollback run's: epoch 1's fourth
# the guard's cost is measured on ResNet-18 alone: SimpleDLA's (in
# PERF_HISTORY.md) is not measured again, to keep the whole script near
# 700 s
GUARD_MODELS = ("ResNet18",)
REMAT_RUNS = (("ResNet18", 512), ("EfficientNetB0", 128))
# the JAX trainer's names on the host-loader path (its OBSERVABILITY.md)
HOST_METRICS = {
    "counters": {"train.epochs", "train.epoch_s", "train.input_wait_s"},
    "gauges": {"data.prefetch_depth"},
    "histograms": {"train.epoch_ms", "train.step_time_ms",
                   "train.input_wait_ms", "data.host_batch_ms",
                   "data.producer_batch_ms"},
}
HOST_SPANS = {"train/epoch", "train/step", "eval/epoch"}


def _cut_config(out_dir: str, **kw):
    """ResNet-18 at full width, b512 bf16, device data with K1, on the
    cut split for 2 epochs."""
    from pytorch_cifar_tpu_torch.config import TrainConfig

    return TrainConfig(**{**dict(
        model="ResNet18", batch_size=BATCH, amp=True, synthetic_data=True,
        synthetic_train_size=CUT_TRAIN, synthetic_test_size=CUT_TEST,
        epochs=2, cosine_t_max=2, dma_gather=True, device="cuda",
        output_dir=out_dir), **kw})


def zero_launches(mods: dict) -> None:
    """Sets every kernel's launch counter to 0; ``train.launch._launches``
    reads them (a recomputed forward under remat launches K2, when hooked,
    and K4's forward again, and they count it)."""
    for m in ("G", "M", "K", "D"):
        mods[m].LAUNCHES = 0
    mods["P"].FWD_LAUNCHES = mods["P"].BWD_LAUNCHES = 0


def _check_path_launches(tag: str, got: dict, k1: int, k3: int,
                         fails: Failures) -> None:
    want = {name: 0 for name in got}
    want.update(dma_row_gather=k1, conv3x3_bn_relu=k3)
    fails.check(got == want, f"{tag}: launches {got}, want {want}")


def _raw_state(state) -> torch.Tensor:
    """Params, BN stats and momentum buffers as raw bits, on the card."""
    from pytorch_cifar_tpu_torch.compat import snapshot_state

    return snapshot_state(state).flat.view(torch.int32)


def _trees_equal(got, want, path="") -> list:
    """The paths where two payload trees differ (as raw bytes)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return [path]
        return [p for k in want
                for p in _trees_equal(got[k], want[k], f"{path}/{k}")]
    a, b = np.asarray(got), np.asarray(want)
    same = (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())
    return [] if same else [path]


def _epochs(hist) -> list:
    return [{k: h[k] for k in ("epoch", "train_loss", "eval_loss",
                               "eval_acc", "epoch_s", "img_per_sec")}
            | {"nonfinite": h["train"]["nonfinite"]} for h in hist]


def _sync_checked_epoch(trainer, epoch: int):
    """One more epoch dispatched with every host sync an error; its
    totals, or the first line of the sync error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        totals, _ = trainer.dispatch_epoch(epoch)
        return totals, None
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _guard_cost(model: str) -> dict:
    """The guarded and the unguarded b512 bf16 step of ``model`` from one
    state, PERF.md section 5's method (``tools/profile_train.py``): the
    wall per step, the faster of two unprofiled runs of 20 steps each, in
    turns; then 20 steps of each under ``torch.profiler``."""
    from pytorch_cifar_tpu_torch.tools.profile_train import (
        profile_steps, wall_ms)
    from pytorch_cifar_tpu_torch.train.steps import make_train_step

    state, _ = _train_state(0, torch.bfloat16, model)
    g = torch.Generator().manual_seed(21)
    batch = (torch.randint(0, 256, (BATCH, 32, 32, 3), generator=g,
                           dtype=torch.uint8).cuda(),
             torch.randint(0, 10, (BATCH,), generator=g,
                           dtype=torch.int32).cuda())
    steps = {mode: make_train_step(compute_dtype=torch.bfloat16,
                                   skip_nonfinite=mode == "guarded",
                                   device="cuda")
             for mode in ("unguarded", "guarded")}
    walls = {mode: [] for mode in steps}
    for mode in ("unguarded", "guarded", "guarded", "unguarded"):
        walls[mode].append(wall_ms(state, steps[mode], batch)[0])
    out = {}
    for mode, step in steps.items():
        rec = profile_steps(state, step, batch, min(walls[mode]))
        out[mode] = {"wall_ms_runs": walls[mode],
                     **{k: rec[k] for k in ("wall_ms_per_step",
                                            "device_busy_ms_per_step",
                                            "idle_share",
                                            "groups_ms_per_step")}}
    out["guard_wall_ms"] = (out["guarded"]["wall_ms_per_step"]
                            - out["unguarded"]["wall_ms_per_step"])
    out["guard_device_ms"] = (out["guarded"]["device_busy_ms_per_step"]
                              - out["unguarded"]["device_busy_ms_per_step"])
    return out


def phase_sentinel(mods: dict, smi: str, fails: Failures) -> dict:
    """The divergence sentinel on the main path (phase 29 of the module
    docstring)."""
    from pytorch_cifar_tpu_torch import faults
    from pytorch_cifar_tpu_torch.compat import train_tree_from_state
    from pytorch_cifar_tpu_torch.train.checkpoint import (
        read_meta, read_payload_tree, read_verified_payload)
    from pytorch_cifar_tpu_torch.train.launch import _launches
    from pytorch_cifar_tpu_torch.train.steps import make_train_step
    from pytorch_cifar_tpu_torch.train.trainer import Trainer

    out_dir = run_dir("sentinel_")
    out = {"card": smi, "model": "ResNet18", "batch": BATCH,
           "dtype": "bf16", "train_n": CUT_TRAIN, "test_n": CUT_TEST}
    secs, t0 = {}, time.perf_counter()
    try:
        faults.clear()
        faults.inject("nan_loss", SENTINEL_STEP)
        trainer = Trainer(_cut_config(os.path.join(out_dir, "skip")))
        faults.clear()  # the step read it when it was built
        fails.check(trainer.config.sentinel == "skip",
                    f"sentinel: the default policy is "
                    f"{trainer.config.sentinel}")
        torch.cuda.synchronize()
        zero_launches(mods)  # the main path starts here
        trainer.fit()
        launches = _launches()  # and ends here
        _check_path_launches("sentinel", launches, 2,
                             6 * 2 * CUT_EVAL_FORWARDS, fails)
        stats = trainer.fault_stats
        fails.check(stats["bad_step_indices"] == [SENTINEL_STEP]
                    and stats["bad_steps"] == 1,
                    f"sentinel: fault_stats {stats}")
        finite = all(bool(torch.isfinite(p).all())
                     for p in trainer.state.model.parameters())
        fails.check(finite, "sentinel: a parameter is not finite")
        hist = trainer.history
        fails.check([h["train"]["nonfinite"] for h in hist] == [0.0, 1.0],
                    f"sentinel: nonfinite totals "
                    f"{[h['train']['nonfinite'] for h in hist]}")
        fails.check(all(np.isfinite(h["train_loss"]) for h in hist),
                    "sentinel: a loss is not finite")
        out.update(launches=launches, fault_stats=stats,
                   epochs=_epochs(hist))

        # a guarded epoch with every host sync an error
        totals, synced = _sync_checked_epoch(trainer, 2)
        fails.check(synced is None,
                    f"sentinel: the guarded epoch synced: {synced}")
        if synced is None:
            fails.check(float(totals["count"]) == CUT_TRAIN,
                        "sentinel: the sync-checked epoch counted "
                        f"{float(totals['count'])} images")
        out["epoch_sync_error"] = synced

        # the poisoned step alone, from the state the run left
        faults.inject("nan_loss", trainer.state.step)
        step = make_train_step(compute_dtype=torch.bfloat16,
                               skip_nonfinite=True, device="cuda")
        faults.clear()
        before, s0 = _raw_state(trainer.state).clone(), trainer.state.step
        m = step(trainer.state, (trainer.loader.images[:BATCH],
                                 trainer.loader.labels[:BATCH]))
        same = torch.equal(_raw_state(trainer.state), before)
        fails.check(same and trainer.state.step == s0 + 1
                    and float(m["nonfinite"]) == 1.0,
                    f"sentinel: the skipped step changed the state "
                    f"(same bits {same}, step {s0} -> "
                    f"{trainer.state.step}, nonfinite "
                    f"{float(m['nonfinite'])})")
        out["skipped_step_same_bits"] = same
        secs["skip"] = time.perf_counter() - t0

        # rollback with a budget of 1: epoch 1's bad step restores epoch 0
        rb_dir = os.path.join(out_dir, "rollback")
        faults.inject("nan_loss", ROLLBACK_STEP)
        rb = Trainer(_cut_config(rb_dir, sentinel="rollback",
                                 sentinel_budget=1))
        faults.clear()
        rb.fit()
        name = "ckpt-e00000.msgpack"
        want = read_payload_tree(name, read_verified_payload(
            rb_dir, name, read_meta(rb_dir, name)))
        differ = _trees_equal(train_tree_from_state(rb.state), want)
        stats = rb.fault_stats
        fails.check(stats["rollbacks"] == 1
                    and stats["bad_step_indices"] == [ROLLBACK_STEP],
                    f"sentinel: rollback fault_stats {stats}")
        fails.check(not differ, f"sentinel: the rolled-back state differs "
                                f"from the epoch-0 checkpoint at {differ}")
        out["rollback"] = {"fault_stats": stats, "differs_at": differ,
                           "step": rb.state.step}
        secs["rollback"] = time.perf_counter() - t0 - secs["skip"]
    finally:
        faults.clear()
        shutil.rmtree(out_dir, ignore_errors=True)
    out["guard_cost"] = {}
    for model in GUARD_MODELS:
        t1 = time.perf_counter()
        out["guard_cost"][model] = _guard_cost(model)
        secs[f"guard_{model}"] = time.perf_counter() - t1
    out["secs"] = secs
    print("sentinel " + json.dumps(out), flush=True)
    return out


def _remat_pair(model: str, batch: int, mods: dict, fails: Failures) -> dict:
    """One fp32 step of ``model`` from one seeded state with remat off and
    on: the largest gradient difference (held within 1e-5 of each
    tensor's largest gradient), the BN running stats as raw bits, then
    the warm step's ms and its peak memory each way."""
    from pytorch_cifar_tpu_torch.train.launch import _launches
    from pytorch_cifar_tpu_torch.train.steps import make_train_step

    g = torch.Generator().manual_seed(31)
    x = (torch.randint(0, 256, (batch, 32, 32, 3), generator=g,
                       dtype=torch.uint8).cuda(),
         torch.randint(0, 10, (batch,), generator=g,
                       dtype=torch.int32).cuda())
    got, rec = {}, {"model": model, "batch": batch, "dtype": "fp32"}
    for remat in (False, True):
        state, _ = _train_state(11, torch.float32, model)
        step = make_train_step(augment=False, compute_dtype=torch.float32,
                               remat=remat, device="cuda")
        torch.cuda.synchronize()
        zero_launches(mods)
        step(state, x)
        torch.cuda.synchronize()
        launches = _launches()
        got[remat] = (
            {k: p.grad.detach().clone()
             for k, p in state.model.named_parameters()},
            {k: v.detach().clone() for k, v in
             state.model.state_dict().items() if "running_" in k})
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, x)
        torch.cuda.synchronize()
        tag = "on" if remat else "off"
        rec[f"step_ms_{tag}"] = (time.perf_counter() - t0) * 1e3 / 3
        rec[f"peak_mem_gib_{tag}"] = torch.cuda.max_memory_allocated() / 2**30
        rec[f"peak_above_state_gib_{tag}"] = (
            torch.cuda.max_memory_allocated() - base) / 2**30
        rec[f"launches_{tag}"] = launches
    (g_off, s_off), (g_on, s_on) = got[False], got[True]
    worst, at = 0.0, None
    for k, gr in g_off.items():
        rel = ((g_on[k] - gr).abs().max() / gr.abs().max().clamp(
            min=1e-30)).item()
        if rel >= worst:
            worst, at = rel, k
    rec["grad_max_abs_diff"] = max((g_on[k] - v).abs().max().item()
                                   for k, v in g_off.items())
    rec["grad_worst_rel"], rec["grad_worst_at"] = worst, at
    stats_same = all(torch.equal(s_on[k], v) for k, v in s_off.items())
    rec["bn_stats_bit_equal"] = stats_same
    fails.check(worst <= 1e-5, f"remat {model}: gradient {at} off by "
                               f"{worst:.3g} of its largest value")
    fails.check(stats_same, f"remat {model}: BN running stats differ")
    fails.check(rec["launches_on"] == rec["launches_off"],
                f"remat {model}: launches {rec['launches_on']} against "
                f"{rec['launches_off']}")
    return rec


def phase_remat(mods: dict, smi: str, fails: Failures) -> dict:
    """Remat against the plain step (phase 30 of the module docstring),
    with TF32 off and cuDNN's deterministic algorithms."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        out = {"card": smi, "runs": [_remat_pair(m, b, mods, fails)
                                     for m, b in REMAT_RUNS]}
    finally:
        torch.backends.cudnn.deterministic = False
    print("remat " + json.dumps(out), flush=True)
    return out


def loader_hook(trainer) -> dict:
    """A rank hook of the host-loader runs: the SHA-256 of epoch 0's
    first 8 batches (images and labels as the step gets them), and the
    loader's and the input wait's instruments."""
    import hashlib
    import itertools

    sums = []
    for x, y in itertools.islice(trainer.loader.epoch(0), 8):
        sums.append(hashlib.sha256(x.cpu().numpy().tobytes()
                                   + y.cpu().numpy().tobytes()).hexdigest())
    s = trainer.obs.summary()
    return {"sha256": sums,
            **{k: s.get(k) for k in ("data.prefetch_depth.max",
                                     "train.input_wait_ms.p50",
                                     "train.input_wait_s", "train.epoch_s",
                                     "data.producer_batch_ms.p50",
                                     "data.host_batch_ms.p50")}}


def phase_host_loader(mods: dict, smi: str, fails: Failures,
                      device_img_s: float) -> dict:
    """The train CLI on the host loader (phase 31 of the module
    docstring)."""
    from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
    from pytorch_cifar_tpu_torch.train.launch import _launches

    out_dir = run_dir("host_loader_")
    base = ["--model", "ResNet18", "--batch_size", str(BATCH),
            "--synthetic_data", "--synthetic_train_size", str(CUT_TRAIN),
            "--synthetic_test_size", str(CUT_TEST), "--epochs", "2",
            "--cosine_t_max", "2", "--no-device_data"]
    metrics = os.path.join(out_dir, "m.jsonl")
    spans = os.path.join(out_dir, "trace.json")
    runs = {"async_on": ["--metrics_out", metrics, "--trace_out", spans],
            "async_off": ["--async_input", "off"],
            "host_augment": ["--host_augment"]}
    out = {"card": smi, "model": "ResNet18", "batch": BATCH,
           "dtype": "bf16", "train_n": CUT_TRAIN, "test_n": CUT_TEST,
           "device_data_warm_img_per_sec": device_img_s}
    try:
        for tag, extra in runs.items():
            argv = base + extra + ["--output_dir",
                                   os.path.join(out_dir, tag)]
            torch.cuda.synchronize()
            zero_launches(mods)  # the main path starts here
            res = train_main(argv, rank_hook=loader_hook)
            launches = _launches()  # and ends here
            _check_path_launches(f"host_loader {tag}", launches, 0,
                                 6 * 2 * CUT_EVAL_FORWARDS, fails)
            hist = res["history"]
            for h in hist:
                fails.check(h["train"]["count"] == CUT_TRAIN
                            and h["eval"]["count"] == CUT_TEST,
                            f"host_loader {tag}: epoch {h['epoch']} counted "
                            f"{h['train']['count']} / {h['eval']['count']}")
            fails.check(all(np.isfinite(h["train_loss"]) for h in hist)
                        and hist[1]["train_loss"] < hist[0]["train_loss"],
                        f"host_loader {tag}: losses "
                        f"{[h['train_loss'] for h in hist]}")
            hook = res["ranks"][0]["hook"]
            out[tag] = {"launches": launches, "epochs": _epochs(hist),
                        "warm_vs_device_data": hist[1]["img_per_sec"]
                        / device_img_s, **hook}
        fails.check(out["async_on"]["sha256"] == out["async_off"]["sha256"],
                    "host_loader: async on and off gave other batches")
        with open(metrics) as f:
            last = json.loads(f.read().splitlines()[-1])["metrics"]
        missing = {kind: sorted(names - set(last.get(kind, {})))
                   for kind, names in HOST_METRICS.items()}
        fails.check(not any(missing.values()),
                    f"host_loader: --metrics_out lacks {missing}")
        with open(spans) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]}
        fails.check(HOST_SPANS <= names,
                    f"host_loader: --trace_out holds only {sorted(names)}")
        out["metrics_lines"] = True
        out["spans"] = sorted(names)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for tag in runs:
        out[tag].pop("sha256")
    print("host_loader " + json.dumps(out), flush=True)
    return out


# -- serving over the wire: frontends, the event edge, the router ---------

WIRE_NS = (1, 7, 32, 100)  # sent one at a time: each request its own batch
WIRE_ENCODINGS = ("binary", "b64", "list")
WIRE_LOAD = dict(clients=8, requests_per_client=64, images_min=1,
                 images_max=8, seed=0)
ASYNC_CLIENTS, ASYNC_REQUESTS = 64, 16
DRILL_CLIENTS, DRILL_REQUESTS, DRILL_KILL_AFTER = 8, 48, 96
REPLICA_READY = "==> http: serving on "
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def _wire_answer(url: str, x: np.ndarray, encoding: str) -> np.ndarray:
    """Logits of one POST /predict of ``x``: the binary frame (a binary
    answer), JSON with base64 images (a base64 answer) or JSON with nested
    lists (an answer in float lists)."""
    import urllib.request

    from pytorch_cifar_tpu_torch.serve import wire
    from pytorch_cifar_tpu_torch.serve.frontend import decode_logits

    if encoding == "binary":
        body, ctype = wire.encode_request(x), wire.CONTENT_TYPE
    else:
        req = ({"images": x.tolist()} if encoding == "list" else
               {"images": base64.b64encode(x.tobytes()).decode("ascii"),
                "shape": list(x.shape), "encoding": "b64"})
        body, ctype = json.dumps(req).encode(), "application/json"
    r = urllib.request.Request(url + "/predict", data=body,
                               headers={"Content-Type": ctype})
    with urllib.request.urlopen(r, timeout=60) as resp:
        payload = resp.read()
    if encoding == "binary":
        return wire.decode_response(payload)[0]
    return decode_logits(json.loads(payload))


class _Replica:
    """``python -m pytorch_cifar_tpu_torch.serve --model ResNet18
    --http_port 0 --seed 0`` (or ``python -m`` of ``argv``) in a child
    process on the card: its stderr read on a thread (the line starting
    with ``ready`` carries the URL), its one stdout line read after it
    exits."""

    def __init__(self, argv=None, ready: str = REPLICA_READY):
        argv = argv or ["pytorch_cifar_tpu_torch.serve", "--model",
                        "ResNet18", "--http_port", "0", "--seed", "0"]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *argv],
            cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        self._marker = ready
        self.err: list = []
        self.url = None
        self.ready = threading.Event()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stderr:
            self.err.append(line)
            if line.startswith(self._marker):
                self.url = line[len(self._marker):].strip()
                self.ready.set()

    def finish(self, timeout: float) -> tuple:
        """(exit code, stdout lines) once the process has exited; killed
        if it outlives ``timeout``."""
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.stop()
        self._reader.join(timeout=30)
        out = self.proc.stdout.read()
        return self.proc.returncode, out.strip().splitlines()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)


def _hist_delta(before: dict, after: dict) -> dict:
    """The observations a histogram took between two snapshots (min and
    max stay the later snapshot's: they only clamp the estimate)."""
    return {**after, "sum": after["sum"] - before["sum"],
            "count": after["count"] - before["count"],
            "counts": [a - b for a, b in zip(after["counts"],
                                             before["counts"])]}


def _p50(snap: dict) -> float:
    from pytorch_cifar_tpu_torch.obs.metrics import _percentile_from_buckets

    return _percentile_from_buckets(snap, 50.0)


def _load_row(rep: dict, **extra) -> dict:
    return {**{k: rep[k] for k in (
        "clients", "requests", "images", "failed", "rejected", "hedged",
        "elapsed_s", "img_per_sec", "p50_ms", "p95_ms", "p99_ms")}, **extra}


def phase_wire(K, smi: str, fails: Failures) -> dict:
    """Serving over the wire (docstring, phase 32)."""
    from pytorch_cifar_tpu_torch.obs import MetricsRegistry
    from pytorch_cifar_tpu_torch.serve import (
        BatcherBackend,
        EdgeFrontend,
        InferenceEngine,
        MicroBatcher,
        ServingFrontend,
    )

    # the replicas start (torch, CUDA, warmup) while this process works
    replicas = [_Replica(), _Replica()]
    try:
        registry = MetricsRegistry()
        engine = InferenceEngine.from_random(
            "ResNet18", seed=0, buckets=BUCKETS,
            compute_dtype=torch.bfloat16, registry=registry)
        batcher = MicroBatcher(engine, max_wait_ms=2.0, continuous=True,
                               registry=registry)
        backend = BatcherBackend(engine, batcher)
        edges = {"threaded": ServingFrontend(backend).start(),
                 "event": EdgeFrontend(backend).start()}
        try:
            out, xs, want = _wire_edges(K, engine, batcher, registry, edges,
                                        fails)
        finally:
            for fe in edges.values():
                fe.stop()
            batcher.close()
        out["card"] = smi
        out["fleet"] = _wire_fleet(replicas, xs, want, fails)
    finally:
        for r in replicas:
            r.stop()
    print("wire " + json.dumps(out), flush=True)
    return out


def _wire_edges(K, engine, batcher, registry, edges: dict,
                fails: Failures) -> tuple:
    """Phase 32 (1) and (2): one replica in this process, behind both
    edges. Returns the record, the single requests and their answers."""
    from pytorch_cifar_tpu_torch.serve import (
        HttpTarget,
        run_async_load,
        run_load,
    )

    out: dict = {}
    # (1) one request at a time, every encoding, through each edge
    rs = np.random.RandomState(12)
    xs = {n: rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)
          for n in WIRE_NS}
    want = {n: engine.predict(x) for n, x in xs.items()}
    K.LAUNCHES = 0  # the main path starts here
    f0, b0 = engine.forward_count, batcher.stats["batches"]
    bad = [f"n={n} {edge} {enc}" for n, x in xs.items()
           for edge, fe in edges.items() for enc in WIRE_ENCODINGS
           if _wire_answer(fe.url, x, enc).tobytes() != want[n].tobytes()]
    launches = K.LAUNCHES  # the main path ends here
    forwards = engine.forward_count - f0
    batches = batcher.stats["batches"] - b0
    sent = len(WIRE_NS) * len(edges) * len(WIRE_ENCODINGS)
    fails.check(not bad, f"wire: answers differ from engine.predict: {bad}")
    fails.check(batches == forwards == sent,
                f"wire: {sent} requests made {batches} batches and "
                f"{forwards} forwards")
    fails.check(launches == 6 * batches,
                f"wire: {launches} K3 launches for {batches} batches")
    out["single"] = {"requests": sent, "bit_identical": not bad,
                     "batches": batches, "k3_launches": launches}

    # (2) closed-loop load, in turns with the in-process run
    loads: dict = {}

    def hists():
        h = registry.snapshot()["histograms"]
        return {"device": h["serve.device_ms"],
                "queue": h["serve.latency_ms"],
                **{e: fe.registry.snapshot()["histograms"].get(
                    "serve.http_ms") for e, fe in edges.items()}}

    def counted(tag: str, fn) -> None:
        K.LAUNCHES = 0
        b0 = batcher.stats["batches"]
        h0 = hists()
        rep = fn()
        h1 = hists()
        nb = batcher.stats["batches"] - b0
        dev = _hist_delta(h0["device"], h1["device"])
        edge = tag.split("_")[0]
        row = _load_row(
            rep, batches=nb, k3_launches=K.LAUNCHES,
            device_ms_mean=dev["sum"] / max(dev["count"], 1),
            # admission -> result in the batcher, and the frontend's
            # handling of a request (decode, batcher, encode): p50s
            batcher_p50_ms=_p50(_hist_delta(h0["queue"], h1["queue"])),
            handler_p50_ms=(_p50(_hist_delta(h0[edge], h1[edge]))
                            if edge in edges else None))
        fails.check(rep["failed"] == 0,
                    f"wire load {tag}: {rep['failed']} failed")
        want_n = (ASYNC_CLIENTS * ASYNC_REQUESTS if tag == "event_async"
                  else WIRE_LOAD["clients"] * WIRE_LOAD["requests_per_client"])
        fails.check(rep["requests"] == want_n,
                    f"wire load {tag}: {rep['requests']} of {want_n} "
                    "answered")
        fails.check(K.LAUNCHES == 6 * nb,
                    f"wire load {tag}: {K.LAUNCHES} K3 for {nb} batches")
        loads[tag] = row
        print(f"wire load {tag}: {rep['img_per_sec']:.0f} img/s, p50 "
              f"{rep['p50_ms']:.2f} ms, p99 {rep['p99_ms']:.2f} ms",
              flush=True)

    def http_load(url: str, mode: str):
        def run():
            t = HttpTarget(url, wire=mode)
            try:
                return run_load(t, **WIRE_LOAD)
            finally:
                t.close()
        return run

    counted("inproc", lambda: run_load(batcher, **WIRE_LOAD))
    for mode in ("mixed", "binary", "json"):
        for edge, fe in edges.items():
            counted(f"{edge}_{mode}", http_load(fe.url, mode))
    counted("event_async", lambda: run_async_load(
        edges["event"].url, clients=ASYNC_CLIENTS,
        requests_per_client=ASYNC_REQUESTS, wire="mixed", seed=0))
    counted("inproc_again", lambda: run_load(batcher, **WIRE_LOAD))
    inproc = (loads["inproc"]["img_per_sec"]
              + loads["inproc_again"]["img_per_sec"]) / 2
    out["load"] = loads
    out["http_vs_inproc"] = {
        e: loads[f"{e}_mixed"]["img_per_sec"] / inproc for e in edges}
    out["binary_vs_json"] = {
        e: loads[f"{e}_binary"]["img_per_sec"]
        / loads[f"{e}_json"]["img_per_sec"] for e in edges}
    out["async_vs_inproc"] = loads["event_async"]["img_per_sec"] / inproc
    out["load_k3_launches"] = sum(r["k3_launches"] for r in loads.values())
    out["compiles"] = engine.compile_count
    fails.check(engine.compile_count == len(BUCKETS),
                f"wire: compile_count {engine.compile_count}")
    return out, xs, want


def _wire_fleet(replicas, xs: dict, want: dict, fails: Failures) -> dict:
    """Phase 32 (3): two replica processes and the router on the card."""
    from pytorch_cifar_tpu_torch.serve import (
        HttpTarget,
        Router,
        ServingFrontend,
        run_load,
    )

    out: dict = {}
    late = [r for r in replicas if not r.ready.wait(300)]
    if late:
        fails.check(False, "wire: a replica never printed its ready line: "
                    + "".join(late[0].err[-20:]))
        return out
    router = Router([r.url for r in replicas], fail_after=2,
                    probe_s=0.25).start()
    front = ServingFrontend(router).start()
    try:
        # single requests: the replicas, the router (both transports) and
        # this process's engine agree bit for bit
        with Router([r.url for r in replicas], transport="event") as ev:
            bad = []
            for n, x in xs.items():
                got = {f"replica{i}": _wire_answer(r.url, x, "binary")
                       for i, r in enumerate(replicas)}
                got["router"] = router.predict(x)
                got["router_event"] = ev.predict(x)
                bad += [f"n={n} {k}" for k, v in got.items()
                        if v.tobytes() != want[n].tobytes()]
        fails.check(not bad, f"wire fleet: answers differ from this "
                             f"process's engine: {bad}")
        out["bit_identical"] = not bad

        # the router's cost: one image a request, one client, direct to a
        # replica and through the router's frontend
        def one_client(url):
            t = HttpTarget(url, wire="binary")
            try:
                return run_load(t, clients=1, requests_per_client=64,
                                images_max=1, seed=3)
            finally:
                t.close()

        direct, routed = one_client(replicas[1].url), one_client(front.url)
        out["direct_1x1"], out["routed_1x1"] = (_load_row(direct),
                                                _load_row(routed))
        out["router_overhead_p50_ms"] = routed["p50_ms"] - direct["p50_ms"]

        # phase (2)'s load with the server in another process than the
        # clients: one replica directly, then both through the router
        def fleet_load(url):
            t = HttpTarget(url, wire="mixed")
            try:
                rep = run_load(t, **WIRE_LOAD)
            finally:
                t.close()
            fails.check(rep["failed"] == 0,
                        f"wire fleet load {url}: {rep['failed']} failed")
            return _load_row(rep)

        out["replica_mixed"] = fleet_load(replicas[1].url)
        out["router_mixed"] = fleet_load(front.url)

        # the drill: mixed-priority load through the router, replica 0
        # SIGKILLed once DRILL_KILL_AFTER requests went through
        target = HttpTarget(front.url, wire="mixed")
        result: dict = {}
        r0 = router.stats["requests"]
        drill = threading.Thread(target=lambda: result.update(
            rep=run_load(target, clients=DRILL_CLIENTS,
                         requests_per_client=DRILL_REQUESTS,
                         bulk_fraction=0.3, seed=1)))
        drill.start()
        deadline = time.monotonic() + 120
        while (router.stats["requests"] - r0 < DRILL_KILL_AFTER
               and drill.is_alive() and time.monotonic() < deadline):
            time.sleep(0.005)
        replicas[0].proc.kill()
        replicas[0].proc.wait(timeout=60)
        drill.join(timeout=300)
        fails.check(not drill.is_alive(), "wire drill: the load hung")
        rep = result.get("rep", {"requests": 0, "failed": 0})
        issued = DRILL_CLIENTS * DRILL_REQUESTS
        lost = issued - rep["requests"] - rep["failed"]
        fails.check(lost == 0, f"wire drill: {lost} of {issued} requests "
                               "lost (neither answered nor failed)")
        deadline = time.monotonic() + 30
        while (router.stats["evictions"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.05)
        health = router.health()
        fails.check(router.stats["evictions"] == 1
                    and [h["healthy"] for h in health["replicas"]]
                    == [False, True],
                    f"wire drill: evictions {router.stats['evictions']}, "
                    f"health {[h['healthy'] for h in health['replicas']]}")
        after = run_load(target, clients=DRILL_CLIENTS,
                         requests_per_client=32, bulk_fraction=0.3, seed=2)
        target.close()
        fails.check(after["failed"] == 0,
                    f"wire drill: {after['failed']} failed after eviction")
        out["drill"] = _load_row(rep, issued=issued, lost=lost,
                                 bulk_requests=rep.get("bulk_requests"))
        out["after_eviction"] = _load_row(after)
        out["router"] = router.stats
    finally:
        front.stop()
        router.stop()
    # the survivor drains on SIGTERM and prints its JSON line
    replicas[1].proc.send_signal(signal.SIGTERM)
    code, lines = replicas[1].finish(timeout=120)
    rec = json.loads(lines[-1]) if code == 0 and lines else {}
    fails.check(code == 0 and len(lines) == 1,
                f"wire: the survivor exited {code} with {len(lines)} lines: "
                + "".join(replicas[1].err[-20:]))
    k3 = rec.get("launches_by_kernel", {}).get("conv3x3_bn_relu", 0)
    # its warmup (one forward a bucket) and every batch it served, 6 each
    fails.check(k3 > 0 and k3 == 6 * (rec.get("batches", -1)
                                      + rec.get("compiles", 0)),
                f"wire: the survivor launched K3 {k3} times for "
                f"{rec.get('batches')} batches and {rec.get('compiles')} "
                "warmup forwards")
    fails.check(rec.get("failed", 1) == 0,
                f"wire: the survivor answered {rec.get('failed')} errors")
    out["survivor"] = {k: rec.get(k) for k in (
        "requests", "images", "failed", "batches", "compiles",
        "launches_by_kernel", "p50_ms", "p99_ms", "device")}
    out["survivor"]["k3_launches"] = k3
    return out


# -- the checkpoint life cycle (phases 33-35) -----------------------------

# K3 NaN cases: ResNet-18's stem (the mma.sync path in both dtypes), a
# 32x32 site and a 4x4 site (8 whole images a tile on the wgmma path)
K3_NAN_SITES = [s for s in SITES if s[0] in (
    "stem", "layer1.{0,1}.conv1", "layer4.1.conv1")]
K3_NAN_CASES = ("pixel", "weight", "scale", "bias", "negative_zero")
RELOAD_LOAD = dict(clients=8, requests_per_client=64, images_min=1,
                   images_max=8, seed=0)
PIPELINE_READY = "==> pipeline: serving on "
LIFECYCLE_MODEL = "ResNet18"  # served, vetted and trained at full width
CANARY_CLIENTS, CANARY_IDLE_S = 3, 3.0
# teed interactive requests B soaks before its promotion, held to no
# shadow error. B is two epochs past A (golden accuracy about 85% against
# 21%) and changes the argmax of nearly every random image, so the soak's
# argmax-flip term, shared with the unlabeled golden gate, is set to 1.0:
# the labeled golden set's accuracy term judges B, as in JAX's drill
CANARY_SOAK = 64
# the payload path of layer1.0.bn1's running variance: the BN of a fused
# conv3x3+BN+ReLU site
K3_SITE_VAR = ("batch_stats", "BasicBlock_0", "BatchNorm_0", "var")


def _k3_nan_inputs(site, dt, case: str, g):
    """A site's inputs with one NaN planted (``case``): in one input pixel
    of image 1 (a multi-image tile holds images 0 and 2 beside it), one
    weight, one scale or one bias entry; or ``negative_zero``: image 0 all
    zeros and channel 3's scale -1 and bias -0, so the pre-ReLU value
    there is -0."""
    _, h, w, cin, cout, _ = site
    x = torch.randn(8, h, w, cin, generator=g)
    wt = torch.randn(3, 3, cin, cout, generator=g) / (9 * cin) ** 0.5
    scale = torch.rand(cout, generator=g) + 0.5
    bias = 0.1 * torch.randn(cout, generator=g)
    nan = float("nan")
    if case == "pixel":
        x[1, h // 2, w // 2, cin // 2] = nan
    elif case == "weight":
        wt[1, 2, cin // 2, cout // 3] = nan
    elif case == "scale":
        scale[cout // 2] = nan
    elif case == "bias":
        bias[cout - 1] = nan
    else:
        x[0] = 0.0
        scale[3], bias[3] = -1.0, -0.0
    return x.to("cuda", dt), wt.to("cuda", dt), scale.cuda(), bias.cuda()


def phase_k3_nan(K, fails: Failures) -> list:
    """K3 keeps a NaN as the plain version does (phase 33). The plain
    version runs with cuDNN off (an im2col GEMM, TF32 off): cuDNN's fp32
    algorithm at 32x32 x 64 spreads one NaN pixel over its whole image,
    past the 3x3 window JAX's reference and the kernel keep it to; the
    rows record cuDNN's count beside."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(33)
    rows = []
    for site in K3_NAN_SITES:
        name, h, w, cin, cout, _ = site
        for dname, dt in DTYPES.items():
            for case in K3_NAN_CASES:
                x, wt, scale, bias = _k3_nan_inputs(site, dt, case, g)
                out = K.conv3x3_bn_relu(x, wt, scale, bias)
                with torch.backends.cudnn.flags(enabled=False):
                    ref = K.conv3x3_bn_relu_reference(
                        x.float(), wt.float(), scale, bias)
                cudnn = K.conv3x3_bn_relu_reference(x.float(), wt.float(),
                                                    scale, bias)
                torch.cuda.synchronize()
                got = out.float()
                nan_k, nan_p = torch.isnan(got), torch.isnan(ref)
                both = ~nan_k & ~nan_p
                diff = (got - ref).abs()[both]
                rtol, atol = ((1e-4, 1e-4) if dname == "fp32"
                              else (1.6e-2, 1e-2))
                tag = f"K3 NaN {name} {dname} {case}"
                fails.check(torch.equal(nan_k, nan_p),
                            f"{tag}: NaN at {int(nan_k.sum())} positions, "
                            f"the plain version at {int(nan_p.sum())}")
                fails.check(case == "negative_zero" or bool(nan_p.any()),
                            f"{tag}: the plain version has no NaN")
                fails.check(bool((diff <= atol + rtol * ref.abs()[both])
                                 .all()),
                            f"{tag}: finite outputs off the plain version")
                row = {"site": name, "dtype": dname, "case": case,
                       "path": K.plan(h, w, cin, cout, dt).path,
                       "nan_count": int(nan_k.sum()),
                       "cudnn_nan_count": int(torch.isnan(cudnn).sum()),
                       "same_nan_positions": bool(torch.equal(nan_k, nan_p)),
                       "finite_max_abs_err": float(diff.max())
                       if diff.numel() else 0.0}
                if case == "negative_zero":
                    # relu(-0): the kernel's and the plain version's bits
                    # in the output dtype at those positions
                    with torch.backends.cudnn.flags(enabled=False):
                        plain = K.conv3x3_bn_relu_reference(x, wt, scale,
                                                            bias)
                    kb = raw_bits(out[0, :, :, 3].contiguous()).unique()
                    pb = raw_bits(plain[0, :, :, 3].contiguous()).unique()
                    row["relu_of_negative_zero"] = {
                        "kernel_bits": [hex(int(v) & 0xFFFFFFFF)
                                        for v in kb.tolist()],
                        "plain_bits": [hex(int(v) & 0xFFFFFFFF)
                                       for v in pb.tolist()],
                        "same_bits": bool(torch.equal(kb, pb))}
                rows.append(row)
    want = len(K3_NAN_SITES) * len(DTYPES) * len(K3_NAN_CASES)
    paths = {r["path"] for r in rows}
    fails.check(len(rows) == want and {"sync", "wgmma"} <= paths,
                f"K3 NaN: {len(rows)} of {want} cases ran, on the paths "
                f"{sorted(paths)}; both the mma.sync and the wgmma path "
                "must take them")
    print("k3_nan " + json.dumps(rows), flush=True)
    return rows


def _seeded_ckpt(out_dir: str, seed: int, epoch: int, best_acc: float):
    """A seeded ResNet-18 state committed by the port's
    ``save_checkpoint``; returns its directory."""
    from pytorch_cifar_tpu_torch.train.checkpoint import save_checkpoint

    state, _ = _train_state(seed, torch.bfloat16, LIFECYCLE_MODEL)
    save_checkpoint(out_dir, state, epoch, best_acc)
    return out_dir


def _percentiles(lat_ms: list) -> dict:
    from pytorch_cifar_tpu_torch.serve.loadgen import percentile_ms

    return {"n": len(lat_ms), "p50_ms": percentile_ms(lat_ms, 50),
            "p99_ms": percentile_ms(lat_ms, 99)}


def _wait_for(pred, timeout: float, poll: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll)
    return bool(pred())


def phase_reload(K, smi: str, fails: Failures) -> dict:
    """The hot-reload watcher under load (phase 34)."""
    from pytorch_cifar_tpu_torch.obs import MetricsRegistry
    from pytorch_cifar_tpu_torch.serve import (
        BatcherBackend,
        CheckpointWatcher,
        InferenceEngine,
        MicroBatcher,
        run_load,
    )
    from pytorch_cifar_tpu_torch.train.checkpoint import (
        CKPT_NAME, ensure_staging_dir, publish_checkpoint,
        quarantine_checkpoint, read_meta)

    root = run_dir("reload_")
    try:
        a_dir = _seeded_ckpt(os.path.join(root, "a"), 1, 3, 30.0)
        b_dir = _seeded_ckpt(os.path.join(root, "b"), 2, 7, 70.0)
        live = os.path.join(root, "live")
        publish_checkpoint(a_dir, live)
        kw = dict(buckets=BUCKETS, compute_dtype=torch.bfloat16)
        refs = {tag: InferenceEngine.from_checkpoint(d, LIFECYCLE_MODEL, **kw)
                for tag, d in (("a", a_dir), ("b", b_dir))}
        registry = MetricsRegistry()
        engine = InferenceEngine.from_checkpoint(live, LIFECYCLE_MODEL,
                                                 registry=registry, **kw)
        batcher = MicroBatcher(engine, max_wait_ms=2.0, registry=registry)
        watcher = CheckpointWatcher(engine, live, registry=registry)
        backend = BatcherBackend(engine, batcher, watcher=watcher)
        batches = []  # every device batch of the live engine: (in, out)
        forward = engine._forward

        def recording(x):
            out = forward(x)
            batches.append((np.array(x, copy=True), out))
            return out

        spans, swaps = [], []

        class Timed:
            """The batcher's submit surface, each request's submit and
            answer times recorded."""
            obs = registry

            def submit(self, x, **kw):
                t0 = time.perf_counter()
                fut = batcher.submit(x, **kw)
                fut.add_done_callback(
                    lambda f: spans.append((t0, time.perf_counter())))
                return fut

        stop, reports = threading.Event(), []

        def load():  # rounds of run_load until the drill is done
            while True:
                reports.append(run_load(Timed(), **RELOAD_LOAD))
                if stop.is_set():
                    return

        def poll_loop():  # the watcher's poll loop, each swap timed
            while not stop.wait(0.05):
                t0 = time.perf_counter()
                if watcher.poll_once():
                    swaps.append((t0, time.perf_counter()))

        engine._forward = recording
        K.LAUNCHES = 0  # the main path starts here
        f0 = engine.forward_count
        threads = [threading.Thread(target=load),
                   threading.Thread(target=poll_loop)]
        for t in threads:
            t.start()
        try:
            _wait_for(lambda: len(spans) >= 64, 60)
            publish_checkpoint(b_dir, live)  # (a) B: one reload
            _wait_for(lambda: watcher.reloads >= 1, 60)
            health_b = backend.health()
            # (b) torn: A's payload under B's sidecar
            tmp = os.path.join(live, CKPT_NAME + ".torn")
            shutil.copyfile(os.path.join(a_dir, CKPT_NAME), tmp)
            os.replace(tmp, os.path.join(live, CKPT_NAME))
            _wait_for(lambda: watcher.skipped >= 1, 60)
            # (c) quarantined: A's tombstone first, then A's publish
            quarantine_checkpoint(live, CKPT_NAME, "chip_smoke drill",
                                  meta=read_meta(a_dir, CKPT_NAME))
            publish_checkpoint(a_dir, live)
            _wait_for(lambda: watcher.quarantined >= 1, 60)
            health_after = backend.health()
            # (d) a watcher pointed at a staging dir
            staging = ensure_staging_dir(live)
            publish_checkpoint(b_dir, staging)
            sw = CheckpointWatcher(engine, staging, registry=registry)
            staging_swapped = sw.poll_once() or sw.poll_once()
        finally:
            stop.set()
            for t in threads:
                t.join()
            batcher.close()
            del engine._forward
        forwards = engine.forward_count - f0
        launches = K.LAUNCHES  # the main path ends here
        # every device batch ran on A's weights or on B's, never a mix:
        # the same padded batch through each reference engine
        tags = []
        for x, out in batches:
            tags.append(next((t for t, e in refs.items()
                              if np.array_equal(e._forward(x), out)), None))
        failed = sum(r["failed"] for r in reports)
        requests = sum(r["requests"] for r in reports)
        refused = registry.summary().get("serve.reload.refused_staging")
        swap = swaps[0] if swaps else (0.0, 0.0)
        across = [(t1 - t0) * 1e3 for t0, t1 in spans
                  if t0 <= swap[1] and t1 >= swap[0]]
        out = {
            "card": smi, "model": LIFECYCLE_MODEL, "dtype": "bf16",
            "buckets": list(BUCKETS), "load_rounds": len(reports),
            "requests": requests, "failed": failed,
            "batches": len(batches), "forwards": forwards,
            "k3_launches": launches,
            "batches_on_a": tags.count("a"), "batches_on_b": tags.count("b"),
            "batches_on_neither": tags.count(None),
            "reloads": watcher.reloads, "skipped": watcher.skipped,
            "quarantined": watcher.quarantined, "errors": watcher.errors,
            "refused_staging": refused, "staging_swapped": staging_swapped,
            "ckpt_epoch_after_reload": health_b["ckpt_epoch"],
            "ckpt_epoch_at_end": health_after["ckpt_epoch"],
            "compiles": engine.compile_count,
            "swap_ms": [(t1 - t0) * 1e3 for t0, t1 in swaps],
            "across_swap": _percentiles(across),
            "all_requests": _percentiles(
                [(t1 - t0) * 1e3 for t0, t1 in spans]),
        }
        fails.check(failed == 0, f"reload: {failed} failed requests")
        fails.check(not tags.count(None),
                    f"reload: {tags.count(None)} batches equal neither A's "
                    "nor B's bits")
        fails.check(tags.count("a") > 0 and tags.count("b") > 0,
                    f"reload: batches on A {tags.count('a')}, on B "
                    f"{tags.count('b')}")
        fails.check((watcher.reloads, watcher.quarantined, watcher.errors)
                    == (1, 1, 0) and watcher.skipped >= 1,
                    f"reload: watcher reloads/skipped/quarantined/errors "
                    f"{watcher.reloads}/{watcher.skipped}/"
                    f"{watcher.quarantined}/{watcher.errors}")
        fails.check(refused == 1 and not staging_swapped,
                    "reload: the staging dir was not refused")
        fails.check(health_b["ckpt_epoch"] == 7
                    and health_after["ckpt_epoch"] == 7,
                    f"reload: /healthz epochs {health_b['ckpt_epoch']}, "
                    f"{health_after['ckpt_epoch']} (want B's 7)")
        fails.check(engine.compile_count == len(BUCKETS),
                    f"reload: compile_count {engine.compile_count}")
        fails.check(launches == 6 * forwards,
                    f"reload: {launches} K3 launches for {forwards} "
                    "forwards")
        print("reload " + json.dumps(out), flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _dir_digest(path: str) -> str:
    """SHA-256 over the names and bytes of a directory's files (not its
    subdirectories)."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(os.listdir(path)):
        p = os.path.join(path, name)
        if os.path.isfile(p):
            h.update(name.encode())
            with open(p, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


class _DrillLoad:
    """Mixed-priority HTTP clients (30% bulk, U[1, 4] images) until
    stopped; :meth:`pause` returns once no request is in flight, so a
    probe goes alone into its own batch. Rows are (t0, t1, priority)."""

    def __init__(self, url: str, clients: int):
        self.url = url
        self.cond = threading.Condition()
        self.running, self.stopping, self.inflight = True, False, 0
        self.rows, self.failed, self.errors = [], 0, []
        self.threads = [threading.Thread(target=self._client, args=(i,))
                        for i in range(clients)]
        for t in self.threads:
            t.start()

    def _client(self, cid: int) -> None:
        from pytorch_cifar_tpu_torch.serve import HttpTarget

        target = HttpTarget(self.url)
        rs = np.random.RandomState(100 + cid)
        try:
            while True:
                n = int(rs.randint(1, 5))
                x = rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)
                prio = "bulk" if rs.uniform() < 0.3 else "interactive"
                with self.cond:
                    while not self.running and not self.stopping:
                        self.cond.wait()
                    if self.stopping:
                        return
                    self.inflight += 1
                t0 = time.perf_counter()
                try:
                    target.submit(x, priority=prio).result()
                    row = (t0, time.perf_counter(), prio)
                except Exception as e:  # counted: the drill wants none
                    row = None
                    with self.cond:
                        self.failed += 1
                        self.errors.append(repr(e)[:200])
                with self.cond:
                    if row is not None:
                        self.rows.append(row)
                    self.inflight -= 1
                    self.cond.notify_all()
        finally:
            target.close()

    def pause(self) -> None:
        with self.cond:
            self.running = False
            while self.inflight:
                self.cond.wait()

    def resume(self) -> None:
        with self.cond:
            self.running = True
            self.cond.notify_all()

    def stop(self) -> None:
        with self.cond:
            self.stopping = True
            self.cond.notify_all()
        for t in self.threads:
            t.join()

    def latencies(self, windows, priority="interactive") -> list:
        """Latencies (ms) of the requests of ``priority`` answered inside
        any of ``windows`` [(t0, t1), ...]."""
        return [(b - a) * 1e3 for a, b, p in self.rows if p == priority
                and any(w0 <= b <= w1 for w0, w1 in windows)]


class _MemSampler:
    """The card's memory in use (``torch.cuda.mem_get_info``: every
    process's, this one's included) when started and its largest value,
    sampled every 0.1 s, while other processes run. (``nvidia-smi``'s
    per-process list shows one merged entry in the chip's sandbox.)"""

    def __init__(self):
        free, total = torch.cuda.mem_get_info()
        self.before = self.peak = total - free
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(0.1):
            free, total = torch.cuda.mem_get_info()
            self.peak = max(self.peak, total - free)

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join()
        return {"device_used_before_mib": self.before / 2**20,
                "device_used_peak_mib": self.peak / 2**20}


def _train_log_img_per_sec(out_dir: str) -> list:
    """img/s of each epoch from a train CLI's ``train.log``."""
    import re

    with open(os.path.join(out_dir, "train.log")) as f:
        return [float(m.group(1)) for m in re.finditer(
            r"train epoch \d+: .*\((\d+) img/s\)", f.read())]


def _pipeline_argv(live: str, *extra) -> list:
    return ["pytorch_cifar_tpu_torch.tools.pipeline_run", "--ckpt", live,
            "--model", LIFECYCLE_MODEL, "--train-size", str(CUT_TRAIN),
            "--test-size", str(CUT_TEST), "--buckets",
            *map(str, BUCKETS), "--poll_s", "0.2", "--acc_margin", "2.0",
            *extra]


def _pipeline_checks(tag: str, rec: dict, fails: Failures) -> None:
    launches = rec["launches_by_kernel"]["conv3x3_bn_relu"]
    forwards = rec["forwards"]["live"] + rec["forwards"]["canary"]
    fails.check(launches == 6 * forwards,
                f"{tag}: {launches} K3 launches for {forwards} forwards of "
                "the live and the canary engine")
    fails.check(rec["device"] == torch.cuda.get_device_name(0),
                f"{tag}: served on {rec['device']}")


def phase_canary(smi: str, fails: Failures) -> dict:
    """The canary drill and one pipeline run, through the port's launcher
    (phase 35)."""
    from pytorch_cifar_tpu_torch.serve import InferenceEngine
    from pytorch_cifar_tpu_torch.train.checkpoint import (
        CKPT_NAME, ensure_staging_dir, publish_checkpoint, read_meta)
    from pytorch_cifar_tpu_torch.train.trainer import Trainer

    root = run_dir("canary_")
    out: dict = {"card": smi, "model": LIFECYCLE_MODEL, "dtype": "bf16"}
    try:
        # A: 2 epochs; B: A resumed for 2 more, on one cosine schedule
        dir_a, dir_b = os.path.join(root, "a"), os.path.join(root, "b")
        for d, kw in ((dir_a, {}), (dir_b, {"resume": True})):
            if kw:
                shutil.copytree(dir_a, dir_b)
            tr = Trainer(_cut_config(d, epochs=2 if not kw else 4,
                                     cosine_t_max=4, **kw))
            try:
                tr.fit()
            finally:
                tr.close()
        epoch_a = read_meta(dir_a, CKPT_NAME)["epoch"]
        epoch_b = read_meta(dir_b, CKPT_NAME)["epoch"]
        out["epochs"] = {"a": epoch_a, "b": epoch_b}
        fails.check(epoch_b > epoch_a, f"canary: B's best epoch {epoch_b} "
                    f"is not past A's {epoch_a}")
        live = os.path.join(root, "live")
        publish_checkpoint(dir_a, live)
        staging = ensure_staging_dir(live)
        kw = dict(buckets=BUCKETS, compute_dtype=torch.bfloat16)
        local = {t: InferenceEngine.from_checkpoint(d, LIFECYCLE_MODEL, **kw)
                 for t, d in (("a", dir_a), ("b", dir_b))}
        probe = np.random.RandomState(11).randint(
            0, 256, size=(3, 32, 32, 3)).astype(np.uint8)
        want = {t: e.predict(probe) for t, e in local.items()}
        out["bucket_bits"] = _bucket_bits(local["a"])
        del local
        proc = _Replica(_pipeline_argv(
            live, "--epochs", "0", "--golden", "eval",
            "--shadow_fraction", "0.5", "--min_shadow", str(CANARY_SOAK),
            "--max_flip_frac", "1.0"), PIPELINE_READY)
        try:
            out["drill"] = _canary_drill(
                proc, live, staging, dir_b, epoch_a, epoch_b, probe, want,
                fails)
        finally:
            proc.stop()
        # one pipeline-mode run: the trainer child on the same card
        train = ["--epochs", "3", "--batch", str(BATCH), "--lr", "0.05"]
        pipe_dir = os.path.join(root, "pipe")
        mem = _MemSampler()
        run = _Replica(_pipeline_argv(pipe_dir, *train, "--clients", "2"),
                       PIPELINE_READY)
        code, lines = run.finish(timeout=600)
        pipe_mem = mem.stop()
        rec = json.loads(lines[-1]) if lines else {}
        fails.check(code == 0 and len(lines) == 1,
                    f"canary pipeline: exit {code}, {len(lines)} stdout "
                    f"lines: {''.join(run.err[-20:])}")
        fails.check(rec.get("trainer_rc") == 0
                    and rec.get("promotions", 0) >= 1
                    and rec.get("load", {}).get("failed", 1) == 0,
                    f"canary pipeline: trainer_rc {rec.get('trainer_rc')}, "
                    f"promotions {rec.get('promotions')}, load "
                    f"{rec.get('load')}")
        if rec:
            _pipeline_checks("canary pipeline", rec, fails)
        out["pipeline"] = {
            **{k: rec.get(k) for k in (
                "trainer_rc", "promotions", "rejected", "generation",
                "served_epoch", "served_generation", "reloads", "canary_ms",
                "max_memory_allocated_mb", "forwards", "launches_by_kernel",
                "load")},
            "memory": pipe_mem,
            "trainer_img_per_sec": _train_log_img_per_sec(pipe_dir),
        }
        print("canary " + json.dumps(out), flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _bucket_bits(engine) -> dict:
    """Rows that keep their bits when the same images run alone at a
    smaller bucket rather than in one bucket-128 batch: what the shadow
    tee can expect when it compares the canary's forward of one request
    with the live engine's answer from a merged micro-batch."""
    x = np.random.RandomState(12).randint(
        0, 256, size=(128, 32, 32, 3)).astype(np.uint8)
    full = engine.predict(x)
    out = {}
    for n in (1, 4, 8, 32):
        part = engine.predict(x[:n])
        out[f"{n}_vs_128"] = {
            "rows": n,
            "identical_rows": int(np.all(part == full[:n], axis=-1).sum()),
            "argmax_flips": int((part.argmax(-1) != full[:n].argmax(-1))
                                .sum()),
            "max_abs_diff": float(np.abs(part - full[:n]).max())}
    return out


def _canary_drill(proc, live, staging, dir_b, epoch_a, epoch_b, probe,
                  want, fails: Failures) -> dict:
    """Phase 35's serve-only drill against the launcher ``proc``."""
    import urllib.request

    from pytorch_cifar_tpu_torch import faults
    from pytorch_cifar_tpu_torch.serve import HttpTarget
    from pytorch_cifar_tpu_torch.train.checkpoint import (
        CKPT_NAME, publish_checkpoint, quarantine_path, read_meta,
        read_quarantine)

    if not proc.ready.wait(300):
        fails.check(False, "canary: the launcher never served: "
                    + "".join(proc.err[-20:]))
        return {}
    url = proc.url

    def healthz() -> dict:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            return json.load(r)

    probe_target = HttpTarget(url)

    def predict() -> np.ndarray:
        return probe_target.submit(probe).result()

    pre, h0 = predict(), healthz()
    gen0, live0 = h0.get("promotion_generation"), _dir_digest(live)
    fails.check(np.array_equal(pre, want["a"]),
                "canary: the launcher's A bits differ from this process's")
    load = _DrillLoad(url, CANARY_CLIENTS)
    t_idle0 = time.perf_counter()
    time.sleep(CANARY_IDLE_S)
    idle = [(t_idle0, time.perf_counter())]
    scratch = os.path.join(os.path.dirname(live), "scratch")

    def stage(corrupt=None, raw=False) -> None:
        """B into staging, corrupted first in a scratch copy; ``raw``
        copies the pair (payload first) where the verified publish would
        refuse it."""
        shutil.rmtree(scratch, ignore_errors=True)
        publish_checkpoint(dir_b, scratch)
        if corrupt is not None:
            corrupt(scratch)
        if raw:
            for name in (CKPT_NAME, "ckpt.json"):
                tmp = os.path.join(staging, name + ".tmp")
                shutil.copyfile(os.path.join(scratch, name), tmp)
                os.replace(tmp, os.path.join(staging, name))
        else:
            publish_checkpoint(scratch, staging)

    bad = [
        ("nan", lambda d: faults.regress_checkpoint(d, nan=True), False),
        ("bitflip", lambda d: faults.bitflip_file(
            os.path.join(d, CKPT_NAME)), True),
        ("regress", lambda d: faults.regress_checkpoint(d, scale=2.0),
         False),
        ("k3_site_nan", lambda d: faults.nan_leaf(d, K3_SITE_VAR), False),
    ]
    verdicts, vetting = {}, []
    try:
        for tag, corrupt, raw in bad:
            try:
                os.remove(quarantine_path(staging, CKPT_NAME))
            except OSError:
                pass
            t0 = time.perf_counter()
            stage(corrupt, raw)
            landed = _wait_for(lambda: read_quarantine(
                staging, CKPT_NAME) is not None, 120, 0.05)
            vetting.append((t0, time.perf_counter()))
            tomb = read_quarantine(staging, CKPT_NAME) or {}
            load.pause()
            bits_same = bool(np.array_equal(predict(), pre))
            h = healthz()
            load.resume()
            verdicts[tag] = {
                "quarantined": landed, "reason": tomb.get("reason"),
                "vet_s": vetting[-1][1] - t0,
                "fleet_bits_identical": bits_same,
                "live_bytes_unchanged": _dir_digest(live) == live0,
                "served_epoch": h.get("ckpt_epoch"),
                "generation": h.get("promotion_generation")}
            v = verdicts[tag]
            fails.check(landed and bits_same and v["live_bytes_unchanged"]
                        and v["served_epoch"] == epoch_a
                        and v["generation"] == gen0,
                        f"canary {tag}: {v}")
        fails.check("nonfinite" in (verdicts["k3_site_nan"]["reason"] or ""),
                    "canary: the NaN at one K3 site was not quarantined as "
                    f"nonfinite: {verdicts['k3_site_nan']['reason']}")
        t0 = time.perf_counter()
        stage()
        promoted = _wait_for(lambda: (
            healthz().get("promotion_generation") not in (None, gen0)
            and healthz().get("ckpt_epoch") == epoch_b), 120, 0.05)
        vetting.append((t0, time.perf_counter()))
        load.pause()
        post, h_final = predict(), healthz()
        load.resume()
        meta = read_meta(live, CKPT_NAME)
        fails.check(promoted and meta.get("epoch") == epoch_b
                    and (meta.get("promotion") or {}).get("generation") == 1
                    and h_final.get("reloads") == 1,
                    f"canary: B not promoted (healthz {h_final}, live "
                    f"sidecar {meta})")
        fails.check(np.array_equal(post, want["b"]),
                    "canary: /predict after the promotion is not B's bits")
        time.sleep(1.0)
    finally:
        load.stop()
        probe_target.close()
    proc.proc.send_signal(signal.SIGTERM)
    code, lines = proc.finish(timeout=120)
    rec = json.loads(lines[-1]) if lines else {}
    fails.check(code == 0 and rec.get("rejected") == 4
                and rec.get("promotions") == 1,
                f"canary: launcher exit {code}, rejected "
                f"{rec.get('rejected')}, promotions {rec.get('promotions')}")
    fails.check(load.failed == 0,
                f"canary: {load.failed} failed client requests: "
                f"{load.errors[:3]}")
    # B's soak: the launcher's canary status keeps the last candidate's
    # shadow counts after its promotion
    shadow = (rec.get("canary") or {}).get("shadow") or {}
    fails.check(shadow.get("requests", 0) >= CANARY_SOAK
                and shadow.get("errors") == 0,
                f"canary: B's shadow soak {shadow}, wanted at least "
                f"{CANARY_SOAK} requests and no error")
    if rec:
        _pipeline_checks("canary drill", rec, fails)
    return {
        "verdicts": verdicts, "promoted": promoted,
        "final_epoch": h_final.get("ckpt_epoch"),
        "final_generation": h_final.get("promotion_generation"),
        "rejected": rec.get("rejected"), "promotions": rec.get("promotions"),
        "exit_code": code, "requests": len(load.rows),
        "bulk_requests": sum(p == "bulk" for _, _, p in load.rows),
        "failed": load.failed,
        "live_idle": _percentiles(load.latencies(idle)),
        "live_vetting": _percentiles(load.latencies(vetting)),
        # B's golden eval and its shadow soak, staged to promoted
        "live_shadow_soak": _percentiles(load.latencies(vetting[-1:])),
        "shadow": shadow,
        "shadow_ms_p50": (rec.get("canary_ms") or {}).get("shadow_ms.p50"),
        "canary_ms": rec.get("canary_ms"), "forwards": rec.get("forwards"),
        "launches_by_kernel": rec.get("launches_by_kernel"),
        "compiles": rec.get("compiles"),
        "max_memory_allocated_mb": rec.get("max_memory_allocated_mb"),
    }


# the int8 lane and the zoo server (phases 36 and 37)
INT8_LOAD = dict(clients=8, requests_per_client=32, images_min=1,
                 images_max=8)
ZOO_TENANTS = {  # name: (K3, K4, K5) launches a served forward
    "ResNet18": (6, 0, 0), "GoogLeNet": (28, 9, 0), "MobileNet": (1, 0, 9),
    "SimpleDLA": (12, 0, 0)}
ZOO_LOAD = dict(clients=8, requests_per_client=16, images_min=1,
                images_max=8)
MIB = 1 << 20


def _device_ms(fn, runs: int = 10, reps: int = 5) -> float:
    """``time_ms`` with a sleep long enough (about 25 ms) to cover the host's
    issue of ``reps`` calls of a whole forward: the events then bracket
    device work only, where a forward's host issue outlasts its device
    time."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return float(np.median(samples))


def _allocated() -> int:
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _requested() -> int:
    """The bytes the live tensors asked for: ``memory_allocated`` counts
    the allocator's blocks, which may exceed a request by up to 1 MiB
    each, depending on which free block it was carved from."""
    torch.cuda.synchronize()
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def _tree_bytes(folded) -> int:
    """Bytes of every tensor a folded tree holds (the int8 lane's q and s
    included)."""
    from pytorch_cifar_tpu_torch.serve.engine import _tree_map

    total = [0]

    def add(leaf):
        for t in (leaf.values() if isinstance(leaf, dict) else (leaf,)):
            if isinstance(t, torch.Tensor):
                total[0] += t.numel() * t.element_size()
        return leaf

    _tree_map(add, folded)
    return total[0]


def phase_int8(K, smi: str, fails: Failures) -> dict:
    """The int8 lane on ResNet-18 at full width (phase 36)."""
    from pytorch_cifar_tpu_torch.data.augment import normalize
    from pytorch_cifar_tpu_torch.obs import MetricsRegistry
    from pytorch_cifar_tpu_torch.serve import (
        InferenceEngine,
        MicroBatcher,
        run_load,
    )
    from pytorch_cifar_tpu_torch.serve.engine import dequantize_int8

    torch.backends.cudnn.allow_tf32 = False  # as phase 3 sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(36)
    xs = rs.randint(0, 256, size=(5, 32, 32, 3)).astype(np.uint8)
    x7 = rs.randint(0, 256, size=(7, 32, 32, 3)).astype(np.uint8)
    want = InferenceEngine.from_random(
        "ResNet18", seed=0, buckets=(8,), compute_dtype=torch.float32,
        device="cpu", int8=True).predict(xs)
    top = float(np.max(np.abs(want)))
    out = {"card": smi, "model": "ResNet18", "buckets": list(BUCKETS)}
    for dt in DTYPES.values():
        # the library's first-use allocations (its workspaces) land here,
        # not in the engines measured below
        InferenceEngine.from_random("ResNet18", buckets=(8, 128),
                                    compute_dtype=dt).predict(x7)
    for dname, dt in DTYPES.items():
        registry = MetricsRegistry()
        K.LAUNCHES = 0  # the main path starts here
        m0 = _allocated()
        eng = InferenceEngine.from_random(
            "ResNet18", seed=0, buckets=BUCKETS, compute_dtype=dt,
            registry=registry, int8=True)
        int8_bytes = _allocated() - m0
        batcher = MicroBatcher(eng, max_wait_ms=2.0, registry=registry)
        try:
            rep = run_load(batcher, seed=36, **INT8_LOAD)
        finally:
            batcher.close()
        forwards, launches = eng.forward_count, K.LAUNCHES  # ends here
        fails.check(launches == 6 * forwards,
                    f"int8 {dname}: K3 launched {launches} times in "
                    f"{forwards} forwards (want 6 a forward)")
        fails.check(rep["failed"] == 0 and rep["requests"] == 8 * 32,
                    f"int8 {dname}: {rep['failed']} failed of "
                    f"{rep['requests']}")
        # the lane's counters count what reaches the engine: every call
        # and its rows, the batcher's coalesced buckets with their padding
        s = registry.summary()
        int8_calls = s.get("serve.int8_requests", 0)
        int8_rows = s.get("serve.int8_images", 0)
        fails.check(0 < int8_calls <= forwards and int8_rows >= rep["images"],
                    f"int8 {dname}: serve.int8_requests {int8_calls}, "
                    f"serve.int8_images {int8_rows} for {forwards} forwards "
                    f"and {rep['images']} images served")
        got = eng.predict(xs)
        err = float(np.max(np.abs(got - want)))
        fails.check(got.shape == (5, 10) and bool(np.isfinite(got).all()),
                    f"int8 {dname}: logits not finite (5, 10)")
        if dname == "fp32":
            fails.check(bool(np.allclose(got, want, rtol=1e-3, atol=1e-4)),
                        f"int8 fp32: logits off the CPU's by {err:.3g}")
        else:
            fails.check(err <= 0.02 * top,
                        f"int8 bf16: logits off the CPU's by {err:.3g} "
                        f"(max |logit| {top:.3g})")
        padded = eng.predict(x7)
        pad_same = bool(np.array_equal(padded, eng.direct_forward(x7)))
        host = eng.weights_host()
        fails.check(all(v.dtype != np.int8 for v in host.values()),
                    f"int8 {dname}: weights_host is not the float state")
        eng.swap_weights(host)
        swap_same = bool(np.array_equal(eng.predict(x7), padded))
        fails.check(swap_same, f"int8 {dname}: weights_host -> "
                               "swap_weights changed the served bits")
        row = {"forwards": forwards, "k3_launches": launches,
               "int8_requests": int8_calls, "int8_images": int8_rows,
               "max_abs_vs_cpu_int8": err, "max_abs_logit": top,
               "padded_vs_direct_bit_identical": pad_same,
               "swap_round_trip_bit_identical": swap_same,
               "int8_engine_bytes": int8_bytes,
               "int8_folded_bytes": _tree_bytes(eng._weights[1]),
               **{k: rep[k] for k in ("requests", "images", "failed",
                                      "img_per_sec", "p50_ms", "p99_ms")}}
        # beside it: the float engine of the same dtype (printed, not
        # gated): its resident bytes and its bucket-128 device time
        m1 = _allocated()
        flt = InferenceEngine.from_random(
            "ResNet18", seed=0, buckets=BUCKETS, compute_dtype=dt)
        row["float_engine_bytes"] = _allocated() - m1
        row["float_folded_bytes"] = _tree_bytes(flt._weights[1])
        # padding keeps the bits within the lane wherever it keeps them in
        # the float engine of the same dtype (the library's per-shape
        # choices at the sites the kernels do not take are the lane's too)
        row["float_padded_vs_direct_bit_identical"] = flt_same = bool(
            np.array_equal(flt.predict(x7), flt.direct_forward(x7)))
        fails.check(pad_same or not flt_same,
                    f"int8 {dname}: padded != direct at n = 7, where the "
                    "float engine keeps its bits")
        fails.check(pad_same or dname == "fp32",
                    f"int8 {dname}: padded != direct at n = 7")
        xb = torch.from_numpy(
            rs.randint(0, 256, size=(128, 32, 32, 3)).astype(np.uint8)
        ).cuda()
        xn = normalize(xb, *eng._norm[eng.device], dt).permute(0, 3, 1, 2)
        (qm, qf), (fm, ff) = eng._weights, flt._weights
        with torch.inference_mode():
            row["bucket128_int8_ms"] = _device_ms(
                lambda: qm.folded_forward(dequantize_int8(qf, dt), xn))
            row["bucket128_float_ms"] = _device_ms(
                lambda: fm.folded_forward(ff, xn))
            row["dequantize_device_ms"] = _device_ms(
                lambda: dequantize_int8(qf, dt))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                dequantize_int8(qf, dt)
            row["dequantize_host_ms"] = (time.perf_counter() - t0) * 1e3 / 50
            torch.cuda.synchronize()
        out[dname] = row
        del eng, batcher, flt, qm, qf, fm, ff
    print("int8 " + json.dumps(out), flush=True)
    return out


def _counting_engine(forwards: dict, admissions=None, hit_forwards=None):
    """An ``InferenceEngine`` that also counts its device forwards per
    model in ``forwards`` (a zoo drops its engines on eviction, so their
    own counters go with them), those of engines whose weights came from
    the cold-start cache also in ``hit_forwards``, and appends each
    engine's ``(model, compile_count, aot_cache_hits, cold_start_s)`` to
    ``admissions`` once it is built."""
    from pytorch_cifar_tpu_torch.serve import InferenceEngine

    class CountingEngine(InferenceEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if admissions is not None:
                admissions.append((self.model_name, self.compile_count,
                                   self.aot_cache_hits, self.cold_start_s))

        def _forward(self, x):
            y = super()._forward(x)
            with self._count_lock:
                forwards[self.model_name] = forwards.get(
                    self.model_name, 0) + 1
                if hit_forwards is not None and getattr(
                        self, "_from_cache", False):
                    hit_forwards[self.model_name] = hit_forwards.get(
                        self.model_name, 0) + 1
            return y

    return CountingEngine


def _clear_cublas_workspaces() -> None:
    """Free the cuBLAS workspaces PyTorch keeps per (handle, stream): one
    per thread that ran a GEMM."""
    torch.cuda.synchronize()
    getattr(torch._C, "_cuda_clearCublasWorkspaces")()


def _zoo_without_cache(specs, mix, x, fails: Failures) -> dict:
    """The zoo without the cold-start cache, twice: admissions
    from this thread alone (every tenant requested twice in turn), then
    under the 8 clients' load; after each ``close()``, the bytes the live
    tensors still request against those before the zoo, and again once
    the cuBLAS workspaces are freed."""
    from pytorch_cifar_tpu_torch.obs import MetricsRegistry
    from pytorch_cifar_tpu_torch.serve import ModelZooServer, run_load

    out = {}
    for threads in (1, 8):
        gc.collect()
        r_before = _requested()
        registry = MetricsRegistry()
        zoo = ModelZooServer(specs, max_resident=2,
                             compute_dtype=torch.bfloat16,
                             registry=registry)
        try:
            if threads == 1:
                for _ in range(2):
                    for name in ZOO_TENANTS:
                        zoo.predict(x, model=name)
                rep = {}
            else:
                rep = run_load(zoo, seed=37, model_mix=mix, **ZOO_LOAD)
                fails.check(rep["failed"] == 0,
                            f"zoo: without the cache, {rep['failed']} failed")
        finally:
            zoo.close()
        del zoo
        gc.collect()
        held = _requested() - r_before
        _clear_cublas_workspaces()
        s = registry.summary()
        out[f"threads_{threads}"] = {
            **{k: rep[k] for k in ("requests", "failed", "img_per_sec",
                                   "p50_ms", "p99_ms") if k in rep},
            "admission_ms": {k: s.get(f"serve.zoo.admission_ms.{k}")
                             for k in ("count", "p50", "max")},
            "requested_after_close_minus_before": held,
            "requested_after_cublas_clear_minus_before":
                _requested() - r_before,
        }
    return out


def phase_zoo(K, P, D, smi: str, fails: Failures) -> dict:
    """A ModelZooServer of four tenants on the card (phase 37)."""
    from pytorch_cifar_tpu_torch import faults
    from pytorch_cifar_tpu_torch.obs import MetricsRegistry
    from pytorch_cifar_tpu_torch.serve import (
        CanaryBudget,
        GoldenSet,
        HttpTarget,
        InferenceEngine,
        MicroBatcher,
        ModelZooServer,
        ServingFrontend,
        TenantSpec,
        UnknownModel,
        load_cost_priors,
        run_load,
        tenancy,
        zipf_mix,
    )
    from pytorch_cifar_tpu_torch.train.checkpoint import (
        ensure_staging_dir,
        is_quarantined,
    )

    tmp = run_dir("zoo-")
    try:
        live = _seeded_ckpt(os.path.join(tmp, "ResNet18"), 0, 1, 10.0)
        priors = load_cost_priors()
        fails.check(set(ZOO_TENANTS) <= set(priors),
                    f"zoo: the cost priors lack {set(ZOO_TENANTS) - set(priors)}")
        rs = np.random.RandomState(37)
        x = rs.randint(0, 256, size=(5, 32, 32, 3)).astype(np.uint8)

        def dedicated(name, **kw):
            kw = dict(buckets=BUCKETS, compute_dtype=torch.bfloat16, **kw)
            if name == "ResNet18":
                return InferenceEngine.from_checkpoint(live, name, **kw)
            return InferenceEngine.from_random(name, seed=0, **kw)

        want = {}
        for name in ZOO_TENANTS:
            want[name] = dedicated(name).predict(x)
        # the dedicated ResNet-18 under the same load, for its img/s
        reg = MetricsRegistry()
        eng = dedicated("ResNet18", registry=reg)
        batcher = MicroBatcher(eng, max_wait_ms=2.0, registry=reg)
        try:
            solo = run_load(batcher, seed=37, **ZOO_LOAD)
        finally:
            batcher.close()
        del eng, batcher

        specs = [TenantSpec(name, live if name == "ResNet18" else None,
                            buckets=BUCKETS) for name in ZOO_TENANTS]
        mix = zipf_mix(sorted(ZOO_TENANTS), priors=priors)  # zoo.models()
        no_cache = _zoo_without_cache(specs, mix, x, fails)
        registry = MetricsRegistry()
        forwards: dict = {}
        hit_forwards: dict = {}
        admissions: list = []
        m_before_zoo, r_before_zoo = _allocated(), _requested()
        plain_engine = tenancy.InferenceEngine
        counting = _counting_engine(forwards, admissions, hit_forwards)
        tenancy.InferenceEngine = counting
        K.LAUNCHES = P.FWD_LAUNCHES = D.LAUNCHES = 0  # the main path starts
        try:
            t0 = time.perf_counter()
            zoo = ModelZooServer(specs, max_resident=2,
                                 compute_dtype=torch.bfloat16,
                                 registry=registry,
                                 aot_cache_dir=os.path.join(tmp, "aot"))
            build_s = time.perf_counter() - t0
            eager = sorted(zoo.health()["resident"])
            first = {m: registry.summary()[
                f"serve.tenant.{m}.admission_ms.max"] for m in eager}
            rep = run_load(zoo, seed=37, model_mix=mix, **ZOO_LOAD)
        finally:
            tenancy.InferenceEngine = plain_engine
        launches = (K.LAUNCHES, P.FWD_LAUNCHES, D.LAUNCHES)  # ends here
        # every admission after a tenant's first imports the cache
        seen, readmits = set(), []
        for model, compiles, hits, cold_s in admissions:
            if model in seen:
                readmits.append((model, compiles, hits))
            seen.add(model)
        fails.check(bool(readmits) and all(
            c == 0 and h == len(BUCKETS) for _, c, h in readmits),
            f"zoo: re-admissions (model, compiles, hits) {readmits}")
        fails.check(all(hit_forwards.get(m, 0) > 0 for m in ZOO_TENANTS),
                    f"zoo: a tenant ran no forward on imported weights "
                    f"({hit_forwards})")
        per = {m: dict(zip(("k3", "k4", "k5"), v))
               for m, v in ZOO_TENANTS.items()}
        expect = tuple(sum(forwards.get(m, 0) * ZOO_TENANTS[m][i]
                           for m in ZOO_TENANTS) for i in range(3))
        fails.check(launches == expect,
                    f"zoo: (K3, K4, K5) launched {launches}, the tenants' "
                    f"forwards {forwards} give {expect}")
        fails.check(all(forwards.get(m, 0) > 0 for m in ZOO_TENANTS),
                    f"zoo: a tenant ran no forward ({forwards})")
        fails.check(rep["failed"] == 0 and rep["requests"] == 8 * 16,
                    f"zoo: {rep['failed']} failed of {rep['requests']} "
                    "under churn")
        evictions_load = zoo.stats["evictions"]
        fails.check(evictions_load > 0, "zoo: the load evicted nothing")

        # every tenant bit for bit a dedicated engine's (re-admitting)
        same = {}
        for name in ZOO_TENANTS:
            same[name] = bool(np.array_equal(zoo.predict(x, model=name),
                                             want[name]))
            fails.check(same[name], f"zoo: {name} differs from a dedicated "
                                    "engine")
        # memory: {ResNet18, GoogLeNet} resident; MobileNet admitted (the
        # LRU ResNet18 evicted), GoogLeNet touched, ResNet18 re-admitted
        # (MobileNet evicted): the card holds what it held before
        # MobileNet's admission, and ResNet18's bits did not move
        for name in ("ResNet18", "GoogLeNet"):
            zoo.predict(x, model=name)
        # refcounts alone free an evicted engine: no collection runs
        # between the two readings, and one before settles older garbage
        gc.collect()
        gc.disable()
        try:
            m0, r0 = _allocated(), _requested()
            zoo.predict(x, model="MobileNet")
            m_with = _allocated()
            evicted = weakref.ref(zoo._tenants["MobileNet"].engine)
            zoo.predict(x, model="GoogLeNet")
            t0 = time.perf_counter()
            readmit = zoo.predict(x, model="ResNet18")
            readmit_ms = (time.perf_counter() - t0) * 1e3
            m1, r1 = _allocated(), _requested()
            freed = evicted() is None
        finally:
            gc.enable()
        res = sorted(zoo.health()["resident"])
        fails.check(res == ["GoogLeNet", "ResNet18"],
                    f"zoo: resident {res} after the cycle")
        fails.check(freed, "zoo: the evicted MobileNet engine is still alive")
        fails.check(abs(r1 - r0) <= MIB,
                    f"zoo: {r1} bytes requested after MobileNet's eviction, "
                    f"{r0} before its admission")
        readmit_same = bool(np.array_equal(readmit, want["ResNet18"]))
        fails.check(readmit_same, "zoo: ResNet18's bits moved across "
                                  "evict -> re-admit")

        # the hit path, one thread: each tenant re-admitted from the cache
        # in turn (MobileNet evicts the LRU GoogLeNet, GoogLeNet ResNet18,
        # ResNet18 MobileNet), the kernels' counts read around it
        hit_path = {}
        for name in ("MobileNet", "GoogLeNet", "ResNet18"):
            c0 = (K.LAUNCHES, P.FWD_LAUNCHES, D.LAUNCHES)
            a0 = zoo.stats["admissions"]
            got = zoo.predict(x, model=name)
            eng = zoo._tenants[name].engine
            n_k = [a - b for a, b in zip(
                (K.LAUNCHES, P.FWD_LAUNCHES, D.LAUNCHES), c0)]
            hit_path[name] = {
                "admitted": zoo.stats["admissions"] - a0,
                "compiles": eng.compile_count, "hits": eng.aot_cache_hits,
                "forwards": eng.forward_count, "launches_k3_k4_k5": n_k,
                "bits_right": bool(np.array_equal(got, want[name]))}
            del eng
            fails.check(
                hit_path[name]["admitted"] == 1
                and hit_path[name]["compiles"] == 0
                and hit_path[name]["hits"] == len(BUCKETS)
                and n_k == [hit_path[name]["forwards"] * k
                            for k in ZOO_TENANTS[name]]
                and hit_path[name]["bits_right"],
                f"zoo: {name}'s re-admission on the cache {hit_path[name]}")
        hit_launches = [sum(h["launches_k3_k4_k5"][i]
                            for h in hit_path.values()) for i in range(3)]
        fails.check(all(n > 0 for n in hit_launches),
                    f"zoo: (K3, K4, K5) launched {hit_launches} on "
                    "imported weights")

        # the same zoo behind the threaded frontend over wire v2
        front = ServingFrontend(zoo, port=0, registry=registry).start()
        target = HttpTarget(front.url, wire="binary")
        wire_same = {}
        try:
            for name in ZOO_TENANTS:
                wire_same[name] = bool(np.array_equal(
                    target.submit(x, model=name).result(), want[name]))
                fails.check(wire_same[name],
                            f"zoo: wire v2 {name} differs from a dedicated "
                            "engine")
            try:
                target.submit(x, model="NoSuchNet")
                unknown_404 = False
            except UnknownModel:
                unknown_404 = True
            fails.check(unknown_404, "zoo: an unknown model got no 404")
        finally:
            target.close()
            front.stop()

        # a NaN candidate staged to ResNet18 through its own controller
        staging = ensure_staging_dir(live)
        ctl = zoo.enable_canary("ResNet18", staging,
                                golden=GoldenSet.random(64, seed=3),
                                budget=CanaryBudget(max_flip_frac=1.0))
        try:
            _seeded_ckpt(staging, 1, 2, 50.0)
            faults.regress_checkpoint(staging, nan=True)
            verdict = ctl.poll_once()
        finally:
            ctl.stop()
        fails.check(verdict == "quarantined" and is_quarantined(
            staging, "ckpt.msgpack"),
            f"zoo: the NaN candidate was {verdict}")
        after = {name: bool(np.array_equal(zoo.predict(x, model=name),
                                           want[name]))
                 for name in ZOO_TENANTS}
        fails.check(all(after.values()),
                    f"zoo: bits moved after the quarantine: {after}")
        s = registry.summary()
        out = {
            "card": smi, "tenants": list(ZOO_TENANTS), "max_resident": 2,
            "dtype": "bf16", "buckets": list(BUCKETS),
            "cost_priors": {m: priors.get(m) for m in ZOO_TENANTS},
            "mix": mix, "eager_resident": eager, "build_s": build_s,
            "forwards": forwards, "launches_k3_k4_k5": list(launches),
            "per_forward": per,
            **{k: rep[k] for k in ("requests", "images", "failed",
                                   "img_per_sec", "p50_ms", "p99_ms",
                                   "per_model")},
            "evictions_under_load": evictions_load,
            "dedicated_resnet18": {k: solo[k] for k in (
                "requests", "images", "failed", "img_per_sec", "p50_ms",
                "p99_ms")},
            "bit_identical_to_dedicated": same,
            "readmit_bit_identical": readmit_same,
            "readmit_ms": readmit_ms,
            "first_admission_ms": first,
            "admission_ms": {k: s.get(f"serve.zoo.admission_ms.{k}")
                             for k in ("count", "p50", "max")},
            # (model, compiles, aot_cache_hits, cold_start_s) of every
            # engine the zoo built under load, and the forwards they ran
            # on imported weights; the one-thread pass's launches on them
            "admissions": admissions, "hit_path_forwards": hit_forwards,
            "hit_path": hit_path, "hit_path_launches_k3_k4_k5": hit_launches,
            "without_cache": no_cache,
            "memory_before_admission": m0, "memory_with_tenant": m_with,
            "memory_after_eviction": m1,
            "requested_before_admission": r0,
            "requested_after_eviction": r1, "evicted_engine_freed": freed,
            "wire_v2_bit_identical": wire_same, "unknown_404": unknown_404,
            "canary_verdict": verdict, "bits_after_quarantine": after,
            "stats": zoo.stats,
        }
        zoo.close()
        del zoo, ctl
        gc.collect()
        out["memory_after_close_minus_before_zoo"] = (_allocated()
                                                      - m_before_zoo)
        out["requested_after_close_minus_before_zoo"] = (_requested()
                                                         - r_before_zoo)
        _clear_cublas_workspaces()
        out["requested_after_cublas_clear_minus_before_zoo"] = (
            _requested() - r_before_zoo)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("zoo " + json.dumps(out), flush=True)
    return out


# -- the fleet control plane (phases 38-40) --------------------------------

REPLICA_MODULE = "pytorch_cifar_tpu_torch.serve"  # the replicas' CLI
FLEET_BUCKETS = ("1", "8", "32")
FLEET_PROBE = 32  # a probe of max_batch images runs alone in its batch
FLEET_POLICY = ["--deadline_ms", "4000", "--max_wait_ms", "1",
                "--control_interval_s", "0.25"]
# (stage, clients, cap s): each stage runs rounds of FLEET_ROUND_S until
# its fleet event (ramp: the SIGKILLed replica replaced; settle: a
# scale-down) or its cap; a spawn takes the controller ~16 s on the card
FLEET_STAGES = (("baseline", 4, 3.0), ("ramp", 32, 90.0),
                ("settle", 4, 60.0))
FLEET_ROUND_S = 3.0


class _Launcher:
    """``python -m argv`` in a child process (a fleet launcher), its
    stderr lines kept and matched on a thread, its stdout read once it
    exits."""

    def __init__(self, argv):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=REPO_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.err: list = []
        self.cond = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stderr:
            with self.cond:
                self.err.append(line.rstrip("\n"))
                self.cond.notify_all()

    def wait_line(self, pattern: str, timeout: float):
        """The first stderr line matching ``pattern`` (a regex), waiting
        up to ``timeout`` s for it; None if none came (or the child
        exited without it)."""
        rx = re.compile(pattern)
        deadline = time.monotonic() + timeout
        with self.cond:
            while True:
                for line in self.err:
                    m = rx.search(line)
                    if m:
                        return m
                left = deadline - time.monotonic()
                if left <= 0 or (self.proc.poll() is not None
                                 and not self._reader.is_alive()):
                    return None
                self.cond.wait(min(left, 0.5))

    def matches(self, pattern: str) -> list:
        rx = re.compile(pattern)
        with self.cond:
            return [m for m in map(rx.search, self.err) if m]

    def replica_records(self) -> dict:
        """Each drained replica's own JSON record, forwarded by the
        launcher under its ``[replica i]`` prefix."""
        return {int(m.group(1)): json.loads(m.group(2)) for m in
                self.matches(r"^\[replica (\d+)\] (\{.*\})$")}

    def finish(self, timeout: float) -> tuple:
        """(exit code, stdout lines); the child killed past ``timeout``."""
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
        self._reader.join(timeout=30)
        out = self.proc.stdout.read()
        return self.proc.returncode, out.strip().splitlines()

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)

    def tail(self, n: int = 30) -> str:
        with self.cond:
            return "\n".join(self.err[-n:])


def _replica_pids(marker: str) -> set:
    """Live port replica processes (``python -m
    pytorch_cifar_tpu_torch.serve``) whose command line names ``marker``,
    a directory of this phase: what the phase caused, from ``/proc``."""
    pids = set()
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            with open(f"/proc/{d}/stat", "rb") as f:
                stat = f.read()
        except OSError:
            continue  # raced an exit
        zombie = stat[stat.rindex(b")") + 2:stat.rindex(b")") + 3] == b"Z"
        if (not zombie and REPLICA_MODULE.encode() in argv
                and any(marker.encode() in a for a in argv)):
            pids.add(int(d))
    return pids


def _reap_orphans(tag: str, marker: str, fails: Failures,
                  settle_s: float = 20.0) -> list:
    """Every replica this phase caused must be gone once its launchers
    exited (drains settle for up to ``settle_s``). One still alive is a
    failed ``orphan_pids`` check, and is killed, so it holds no card
    memory into later phases. Returns the orphans' pids."""
    deadline = time.monotonic() + settle_s
    while _replica_pids(marker) and time.monotonic() < deadline:
        time.sleep(0.25)
    orphans = sorted(_replica_pids(marker))
    fails.check(not orphans, f"{tag}: orphan_pids {orphans}")
    for pid in orphans:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return orphans


def _healthz(url: str) -> dict:
    """A ``/healthz`` payload, also on a 503 (the body is the payload)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            return json.load(r)
    except urllib.error.HTTPError as e:
        with e:
            return json.loads(e.read().decode("utf-8"))


def _bits(url: str, x: np.ndarray, model=None, wire="binary") -> np.ndarray:
    from pytorch_cifar_tpu_torch.serve import HttpTarget

    t = HttpTarget(url, wire=wire)
    try:
        return t.submit(x, model=model).result()
    finally:
        t.close()


def _stage_row(rep: dict, **extra) -> dict:
    return {**{k: rep[k] for k in ("clients", "requests", "images",
                                   "failed", "hedged", "elapsed_s",
                                   "img_per_sec", "p50_ms", "p99_ms")},
            **extra}


def _rounds_row(reps: list, **extra) -> dict:
    """One stage's load rounds together: sums, img/s over the rounds'
    time, and each round's p50/p99 (percentiles do not add up)."""
    images = sum(r["images"] for r in reps)
    elapsed = sum(r["elapsed_s"] for r in reps)
    return {"clients": reps[0]["clients"] if reps else 0,
            "rounds": len(reps), **{k: sum(r[k] for r in reps) for k in (
                "requests", "images", "failed", "hedged")},
            "elapsed_s": elapsed, "img_per_sec": images / max(elapsed, 1e-9),
            "p50_ms": [r["p50_ms"] for r in reps],
            "p99_ms": [r["p99_ms"] for r in reps], **extra}


def _k3_drained(tag: str, records: dict, fails: Failures,
                per_forward: int = 6) -> dict:
    """K3's launches in each drained replica: 6 a ResNet-18 forward, its
    warmup (a forward a bucket: ``compiles`` on weights it prepared,
    ``aot_cache_hits`` on imported ones) and every batch it served."""
    out = {}
    for idx, rec in sorted(records.items()):
        k3 = rec.get("launches_by_kernel", {}).get("conv3x3_bn_relu", 0)
        warm = rec.get("compiles", 0) + rec.get("aot_cache_hits", 0)
        fwd = rec.get("batches", -1) + warm
        fails.check(k3 > 0 and k3 % per_forward == 0
                    and k3 == per_forward * fwd,
                    f"{tag}: replica {idx} launched K3 {k3} times for "
                    f"{rec.get('batches')} batches and {warm} warmup "
                    "forwards")
        fails.check(rec.get("device") == torch.cuda.get_device_name(0),
                    f"{tag}: replica {idx} served on {rec.get('device')}")
        out[idx] = {"k3_launches": k3, "batches": rec.get("batches"),
                    "compiles": rec.get("compiles"),
                    "aot_cache_hits": rec.get("aot_cache_hits"),
                    "requests": rec.get("requests"),
                    "failed": rec.get("failed")}
    return out


def _fleet_reference(ckpt: str, x: np.ndarray) -> np.ndarray:
    """The logits of an in-process bf16 engine (the replicas' buckets)
    from ``ckpt`` for ``x``: what every replica must answer."""
    from pytorch_cifar_tpu_torch.serve import InferenceEngine

    eng = InferenceEngine.from_checkpoint(
        ckpt, LIFECYCLE_MODEL, buckets=tuple(map(int, FLEET_BUCKETS)),
        compute_dtype=torch.bfloat16)
    try:
        return eng.predict(x)
    finally:
        del eng
        gc.collect()
        torch.cuda.empty_cache()


class _CountSampler:
    """The fleet's healthy replicas over time, from its ``/healthz``."""

    def __init__(self, url: str, every_s: float = 0.25):
        self.url, self.every_s = url, every_s
        self.t0 = time.monotonic()
        self.rows: list = []  # (s, healthy) at each change
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.every_s):
            try:
                n = int(_healthz(self.url).get("healthy_replicas", -1))
            except OSError:
                continue
            if not self.rows or self.rows[-1][1] != n:
                self.rows.append((round(time.monotonic() - self.t0, 2), n))

    def stop(self) -> list:
        self._stop.set()
        self._thread.join(timeout=10)
        return self.rows


# a replica's warm line: buckets warmed on prepared weights, imported
WARM_RX = (r"^\[replica (\d+)\] ==> warm: \d+ buckets warmed on prepared "
           r"weights, \d+ imported from the cold-start cache \(([\d.]+)s")


def _joined(launcher) -> list:
    """``(idx, compiles, generation)`` of every replica a fleet launcher
    reported joining, in the order they joined."""
    return [(int(m.group(1)), int(m.group(2)), m.group(3)) for m in
            launcher.matches(r"^==> fleet: (?:(?!adopt )\S+ )?replica (\d+) "
                             r".*compiles=(\d+) .*gen=(\S+)")]


def _after_first_zero(joined) -> bool:
    """Every replica after the first of its weight set (its generation)
    joined with ``compiles == 0`` (the cold-start cache's entries are per
    weight set), and there is one at all."""
    seen = set()
    ok = bool(joined)
    for _, compiles, gen in joined:
        if gen in seen:
            ok = ok and compiles == 0
        seen.add(gen)
    return ok


def phase_fleet(smi: str, fails: Failures) -> dict:
    """An elastic ResNet-18 fleet under a 4 -> 32 -> 4 client ramp, one
    replica SIGKILLed mid-ramp (phase 38)."""
    from pytorch_cifar_tpu_torch.serve import run_async_load

    tmp = run_dir("fleet-")
    out: dict = {"card": smi, "model": LIFECYCLE_MODEL, "dtype": "bf16",
                 "buckets": list(map(int, FLEET_BUCKETS))}
    fl = sampler = None
    try:
        ckpt = _seeded_ckpt(os.path.join(tmp, "ckpt"), 0, 1, 10.0)
        probe = np.random.RandomState(7).randint(
            0, 256, size=(FLEET_PROBE, 32, 32, 3)).astype(np.uint8)
        want = _fleet_reference(ckpt, probe)
        fl = _Launcher([
            "pytorch_cifar_tpu_torch.tools.fleet_run", "--ckpt", ckpt,
            "--model", LIFECYCLE_MODEL, "--buckets", *FLEET_BUCKETS,
            "--min_replicas", "1", "--max_replicas", "3",
            "--aot_cache", os.path.join(tmp, "aot"),
            "--probe_s", "0.2", *FLEET_POLICY,
            # the up-cooldown outlasts the ramp's last round after the
            # replacement joined: no third spawn (~13 s) into the settle
            "--queue_high", "10", "--queue_low", "3", "--up_after_s", "0.5",
            "--down_after_s", "2", "--up_cooldown_s", "5",
            "--down_cooldown_s", "2"])
        m = fl.wait_line(r"==> fleet: serving on (\S+)", 300)
        if not fails.check(m is not None, "fleet: the fleet never served: "
                           + fl.tail()):
            return out
        url = m.group(1)
        sampler = _CountSampler(url)
        member_rx = (r"==> fleet: (?:replica (\d+) pid=(\d+) url=(\S+)|"
                     r"scale-up replica (\d+) url=(\S+) pid=(\d+))")
        probed: dict = {}

        def probe_members():
            """Every replica that ever served, probed the moment it is
            seen: bit for bit the in-process engine's answer."""
            for mm in fl.matches(member_rx):
                idx = int(mm.group(1) or mm.group(4))
                if idx in probed:
                    continue
                rurl = mm.group(3) or mm.group(5)
                try:
                    probed[idx] = bool(np.array_equal(_bits(rurl, probe),
                                                      want))
                except Exception as e:  # the one SIGKILLed mid-probe
                    probed[idx] = repr(e)[:120]

        def members() -> dict:
            return {int(mm.group(1) or mm.group(4)): int(mm.group(2)
                                                         or mm.group(6))
                    for mm in fl.matches(member_rx)}

        stages, kill = {}, {}
        probe_members()
        prober_stop = threading.Event()

        def prober():
            while not prober_stop.wait(0.5):
                probe_members()

        def replaced() -> bool:
            """The SIGKILLed replica reaped and a replica spawned after
            it, both in rotation."""
            lines = fl.matches(r"==> fleet: (replica 0 died|scale-up)")
            died = [i for i, mm in enumerate(lines)
                    if "died" in mm.group(1)]
            return bool(died) and len(lines) > died[0] + 1 and int(
                _healthz(url).get("healthy_replicas", 0)) >= 2

        until = {"baseline": lambda: True, "ramp": replaced,
                 "settle": lambda: bool(fl.matches(
                     r"==> fleet: scale-down "))}
        prober_t = threading.Thread(target=prober, daemon=True)
        prober_t.start()
        try:
            for stage, clients, cap in FLEET_STAGES:
                reps: list = []
                done = threading.Event()

                def rounds(clients=clients, cap=cap, seed=len(stages)):
                    t_end = time.monotonic() + cap
                    while True:  # at least one round
                        reps.append(run_async_load(
                            url, clients=clients,
                            requests_per_client=10 ** 6, images_max=4,
                            seed=100 * seed + len(reps),
                            duration_s=FLEET_ROUND_S, wire="binary"))
                        if done.is_set() or time.monotonic() >= t_end:
                            return

                load = threading.Thread(target=rounds)
                load.start()
                deadline = time.monotonic() + cap
                while time.monotonic() < deadline:
                    if (stage == "ramp" and not kill and int(
                            _healthz(url).get("healthy_replicas", 0)) >= 2):
                        # the controller scaled up: SIGKILL the seed at
                        # once; requests it holds that began while it
                        # served alone must hedge to the new replica
                        kill = {"idx": 0, "pid": members()[0],
                                "at_s": round(time.monotonic()
                                              - sampler.t0, 2)}
                        os.kill(kill["pid"], signal.SIGKILL)
                    if until[stage]() and (stage != "ramp" or kill):
                        break
                    time.sleep(0.25)
                done.set()
                load.join(timeout=cap + 120)
                row = _rounds_row(reps, healthy_after=int(
                    _healthz(url).get("healthy_replicas", -1)))
                stages[stage] = row
                fails.check(row["failed"] == 0 and row["requests"] > 0,
                            f"fleet: {stage}: {row['failed']} failed of "
                            f"{row['requests']}: " + fl.tail())
        finally:
            prober_stop.set()
            prober_t.join(timeout=60)
        probe_members()
        edge_bits = bool(np.array_equal(_bits(url, probe), want))
        fl.proc.send_signal(signal.SIGTERM)
        code, lines = fl.finish(timeout=180)
        counts = sampler.stop()
        sampler = None
        rec = json.loads(lines[-1]) if code == 0 and lines else {}
        fails.check(code == 0 and len(lines) == 1,
                    f"fleet: fleet_run exited {code} with {len(lines)} "
                    "lines: " + fl.tail())
        peak = max(n for _, n in counts)
        held = counts[0][1] == 1 and stages["baseline"]["healthy_after"] == 1
        fails.check(held, "fleet: did not hold at 1 replica under the "
                          f"baseline: {counts}")
        fails.check(bool(kill), "fleet: never scaled to 2 under the ramp")
        fails.check(rec.get("scale_ups", 0) >= 2
                    and rec.get("scale_downs", 0) >= 1
                    and rec.get("replica_failures", 0) >= 1,
                    f"fleet: scale_ups {rec.get('scale_ups')}, scale_downs "
                    f"{rec.get('scale_downs')}, replica_failures "
                    f"{rec.get('replica_failures')}")
        fails.check(peak >= 2 and counts[-1][1] < peak,
                    f"fleet: the replica count over time {counts}")
        fails.check(len(probed) >= 3 and all(v is True for v in
                                             probed.values()) and edge_bits,
                    f"fleet: bits vs the in-process engine: replicas "
                    f"{probed}, through the router {edge_bits}")
        fails.check(all(rc == 0 for rc in rec.get("replica_rcs",
                                                  {"": 1}).values()),
                    f"fleet: replica exit codes {rec.get('replica_rcs')}")
        drained = _k3_drained("fleet", fl.replica_records(), fails)
        fails.check(len(drained) >= 2 and kill.get("idx") not in drained,
                    f"fleet: drained replica records {sorted(drained)}")
        joined = _joined(fl)
        fails.check(_after_first_zero(joined),
                    f"fleet: replicas joined (idx, compiles, gen) {joined}: "
                    "one after the first of its weight set compiled")
        out.update({
            "stages": stages, "kill": kill, "replica_count": counts,
            "held_at_min_baseline": held, "replica_bits": probed,
            "router_bits": edge_bits,
            "compiles": {i: c for i, c, _ in joined},
            "drain_s": [float(mm.group(1)) for mm in fl.matches(
                r"==> fleet: scale-down .*drain_s=(\S+)")],
            # each replica's own warm-up of its three buckets (with the
            # cache's import), of the controller's spawn (process, torch,
            # CUDA, checkpoint, warm-up)
            "warm_s": {int(mm.group(1)): float(mm.group(2)) for mm in
                       fl.matches(WARM_RX)},
            "drained": drained, "fleet_rc": code,
            **{k: rec.get(k) for k in (
                "scale_ups", "scale_downs", "replica_failures",
                "spawn_ms_p50", "drain_ms_p50", "replicas_final",
                "router")},
        })
    finally:
        if sampler is not None:
            sampler.stop()
        if fl is not None:
            fl.kill()
        out["orphan_pids"] = _reap_orphans("fleet", tmp, fails)
        shutil.rmtree(tmp, ignore_errors=True)
    print("fleet " + json.dumps(out), flush=True)
    return out


def _journal_state(path: str):
    from pytorch_cifar_tpu_torch.serve.journal import (
        FleetJournalState,
        replay_journal,
    )

    return FleetJournalState.from_records(replay_journal(path)[0])


class _Background:
    """Rounds of ``run_async_load`` (4 clients, U[1, 4] images, 30% bulk)
    against ``url`` on a thread until stopped; the rounds' reports."""

    def __init__(self, url: str, round_s: float = 4.0):
        from pytorch_cifar_tpu_torch.serve import run_async_load

        self.reports: list = []
        self._stop = threading.Event()

        def loop():
            n = 0
            while not self._stop.is_set():
                n += 1
                self.reports.append(run_async_load(
                    url, clients=4, requests_per_client=10 ** 6,
                    images_max=4, seed=100 + n, duration_s=round_s,
                    bulk_fraction=0.3, wire="binary"))

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=120)
        r = self.reports
        return {"rounds": len(r),
                "requests": sum(x["requests"] for x in r),
                "failed": sum(x["failed"] for x in r),
                "hedged": sum(x["hedged"] for x in r),
                "p50_ms_max": max((x["p50_ms"] for x in r), default=0.0),
                "p99_ms_max": max((x["p99_ms"] for x in r), default=0.0),
                "img_per_sec_min": min((x["img_per_sec"] for x in r),
                                       default=0.0)}


def phase_rollout(smi: str, fails: Failures) -> dict:
    """The split deployment: this process hosts the edge (router,
    frontend, journal follower); the journaled controller runs as
    ``fleet_run --role controller``, is SIGKILLed mid-rollout, resumed,
    and rolls back a NaN generation (phase 39)."""
    from pytorch_cifar_tpu_torch import faults
    from pytorch_cifar_tpu_torch.obs import MetricsRegistry
    from pytorch_cifar_tpu_torch.serve import (
        JournalFollower,
        Router,
        ServingFrontend,
    )
    from pytorch_cifar_tpu_torch.serve.fleet import live_generation_probe
    from pytorch_cifar_tpu_torch.train.checkpoint import publish_checkpoint

    tmp = run_dir("rollout-")
    out: dict = {"card": smi, "model": LIFECYCLE_MODEL, "dtype": "bf16"}
    live, jpath = os.path.join(tmp, "live"), os.path.join(tmp, "fleet.journal")
    ctls, load = [], None
    router = front = follower = None
    try:
        # generation 1: a seeded ResNet-18; 2: the same, every weight
        # moved by 0.5% of its spread (the golden gate's argmaxes stay); 3: generation 2 with one NaN in a
        # K3 site's BN variance, CRC-valid (the gate must refuse it)
        gens = {1: _seeded_ckpt(os.path.join(tmp, "g1"), 0, 1, 10.0)}
        gens[2] = shutil.copytree(gens[1], os.path.join(tmp, "g2"))
        faults.regress_checkpoint(gens[2], scale=0.005, seed=2)
        gens[3] = shutil.copytree(gens[2], os.path.join(tmp, "g3"))
        faults.nan_leaf(gens[3], K3_SITE_VAR)
        probe = np.random.RandomState(7).randint(
            0, 256, size=(FLEET_PROBE, 32, 32, 3)).astype(np.uint8)
        want = {g: _fleet_reference(gens[g], probe) for g in (1, 2)}
        fails.check(not np.array_equal(want[1], want[2]),
                    "rollout: generations 1 and 2 answer the same bits")
        publish_checkpoint(gens[1], live,
                           extra_meta={"promotion": {"generation": 1}})

        registry = MetricsRegistry()
        router = Router([], allow_empty=True, registry=registry,
                        probe_s=0.2).start()
        front = ServingFrontend(router, registry=registry).start()
        follower = JournalFollower(jpath, router, poll_s=0.2).start()
        url = front.url

        def controller(resume: bool) -> _Launcher:
            ctls.append(_Launcher([
                "pytorch_cifar_tpu_torch.tools.fleet_run", "--ckpt", live,
                "--model", LIFECYCLE_MODEL, "--role", "controller",
                "--fleet_url", url, "--journal", jpath, "--rollouts",
                "--min_replicas", "2", "--max_replicas", "3",
                "--aot_cache", os.path.join(tmp, "aot"),
                "--buckets", *FLEET_BUCKETS, *FLEET_POLICY,
                # the scaling band parked wide open: the only actuations
                # are the rolling deploy's
                "--queue_high", "1000", "--queue_low", "0",
                "--up_after_s", "600", "--down_after_s", "600",
                "--up_cooldown_s", "600", "--down_cooldown_s", "600",
                *(["--resume"] if resume else [])]))
            return ctls[-1]

        def on_gen(gen: int) -> bool:
            reps = _healthz(url).get("replicas", [])
            return len(reps) == 2 and all(
                r.get("healthy") and r.get("generation") == gen
                for r in reps)

        def fleet_on(gen: int) -> tuple:
            """(the edge's two replicas healthy on ``gen``, as its probes
            see them within 30 s; bits of each replica and of the edge
            equal to a generation-``gen`` engine's)."""
            on = _wait_for(lambda: on_gen(gen), 30.0, 0.1)
            reps = _healthz(url).get("replicas", [])
            bits = [np.array_equal(_bits(r["url"], probe), want[gen])
                    for r in reps] + [np.array_equal(_bits(url, probe),
                                                     want[gen])]
            return on, all(bits)

        def live_pids() -> set:
            return {int(i["pid"]) for i in
                    _journal_state(jpath).live_replicas().values()}

        t0 = time.perf_counter()
        c1 = controller(False)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and c1.proc.poll() is None:
            if on_gen(1) and _journal_state(jpath).generation == 1:
                break
            time.sleep(0.25)
        seeded = fleet_on(1)
        out["seed_s"] = time.perf_counter() - t0
        if not fails.check(seeded == (True, True),
                           f"rollout: the seeded fleet (on gen 1, bits) "
                           f"{seeded}: " + c1.tail()):
            return out
        load = _Background(url)

        # generation 2 under load; SIGKILL the controller at its surge
        t0 = time.perf_counter()
        publish_checkpoint(gens[2], live,
                           extra_meta={"promotion": {"generation": 2}})
        surged = c1.wait_line(r"==> fleet: rollout-surge replica", 300)
        killed_mid = surged is not None and not c1.matches(
            r"rollout done gen=2")
        c1.kill()
        fails.check(killed_mid, "rollout: the controller was not killed "
                                "mid-rollout: " + c1.tail())
        time.sleep(1.5)  # headless: the edge keeps serving
        headless = int(_healthz(url).get("healthy_replicas", -1))
        st = _journal_state(jpath)
        in_flight = st.rollout is not None
        pids_at_kill = live_pids()
        fails.check(headless >= 2 and in_flight and len(pids_at_kill) >= 3,
                    f"rollout: headless healthy {headless}, rollout in the "
                    f"journal {in_flight}, journal-live pids {pids_at_kill}")

        c2 = controller(True)
        resumed = c2.wait_line(r"controller resumed from journal", 120)
        done = c2.wait_line(r"==> fleet: rollout done gen=2", 300)
        out["rollout_s"] = time.perf_counter() - t0
        fails.check(resumed is not None and done is not None,
                    "rollout: the resumed controller never finished: "
                    + c2.tail())
        # no double spawn: /proc (this phase's replicas) is the journal
        want_pids = live_pids()
        deadline = time.monotonic() + 20
        while (time.monotonic() < deadline
               and _replica_pids(live) != want_pids):
            time.sleep(0.25)
        proc_pids = _replica_pids(live)
        adopted = [int(m.group(1)) for m in
                   c2.matches(r"==> fleet: adopt replica \d+ pid=(\d+)")]
        fails.check(proc_pids == want_pids
                    and sorted(adopted) == sorted(pids_at_kill),
                    f"rollout: /proc {sorted(proc_pids)}, journal "
                    f"{sorted(want_pids)}, adopted {adopted} of "
                    f"{sorted(pids_at_kill)} live at the kill")
        converted = fleet_on(2)
        fails.check(converted == (True, True),
                    f"rollout: converted to gen 2 (on, bits) {converted}")

        # generation 3 (NaN): refused at surge, .prev restored, rolled back
        t0 = time.perf_counter()
        publish_checkpoint(gens[3], live,
                           extra_meta={"promotion": {"generation": 3}})
        halted = c2.wait_line(r"==> fleet: rollout halt gen=3", 300)
        back = c2.wait_line(r"==> fleet: rollout rolled back to gen=2", 300)
        out["rollback_s"] = time.perf_counter() - t0
        canary = [m.string for m in c2.matches(r"rollout canary failed")]
        live_gen = live_generation_probe(live)()
        after = fleet_on(2)
        fails.check(halted is not None and back is not None
                    and len(canary) == 1 and "non-finite" in canary[0]
                    and live_gen == 2 and after == (True, True),
                    f"rollout: NaN gen 3 halted {halted is not None}, "
                    f"rolled back {back is not None}, canary {canary}, "
                    f"live gen {live_gen}, fleet (on 2, bits) {after}")
        traffic = load.stop()
        load = None
        fails.check(traffic["failed"] == 0 and traffic["requests"] > 0,
                    f"rollout: {traffic['failed']} failed of "
                    f"{traffic['requests']} requests")

        c2.proc.send_signal(signal.SIGTERM)
        code, lines = c2.finish(timeout=180)
        rec = json.loads(lines[-1]) if code == 0 and lines else {}
        fails.check(code == 0 and rec.get("resumed") is True
                    and rec.get("journal_replays") == 1
                    and rec.get("adoptions") == len(pids_at_kill)
                    and rec.get("rollouts") == 1
                    and rec.get("rollbacks") == 1
                    and rec.get("generation") == 2
                    and rec.get("scale_ups") == 0
                    and rec.get("scale_downs") == 0,
                    f"rollout: controller exit {code}, record {rec}: "
                    + c2.tail())
        st = _journal_state(jpath)
        replay = {"rollouts": st.rollouts, "rollbacks": st.rollbacks,
                  "live_replicas": sorted(st.live_replicas()),
                  "spawn_intents": st.spawn_intents,
                  "generation": st.generation}
        fails.check(replay == {"rollouts": 1, "rollbacks": 1,
                               "live_replicas": [], "spawn_intents": {},
                               "generation": 2},
                    f"rollout: the journal replays to {replay}")
        drained = _k3_drained("rollout", c2.replica_records(), fails)
        joined = _joined(ctls[0]) + _joined(c2)
        fails.check(_after_first_zero(joined),
                    f"rollout: replicas joined (idx, compiles, gen) "
                    f"{joined}: one after the first of its weight set "
                    "compiled")
        out.update({
            "joined": joined,
            "killed_mid_rollout": killed_mid,
            "rollout_in_flight_at_kill": in_flight,
            "healthy_while_headless": headless,
            "adopted_pids": adopted, "pids_at_kill": sorted(pids_at_kill),
            "proc_pids_after_resume": sorted(proc_pids),
            "converted_to_gen2": converted, "canary_failed": canary,
            "live_gen_after_rollback": live_gen,
            "fleet_after_rollback": after, "journal_replay": replay,
            "compiles": {int(m.group(1)): int(m.group(2)) for m in
                         ctls[0].matches(r"replica (\d+) .*compiles=(\d+)")
                         + c2.matches(r"replica (\d+) .*compiles=(\d+)")},
            "traffic": traffic, "controller_rc": code,
            "drained": drained,
            **{k: rec.get(k) for k in ("adoptions", "rollouts",
                                       "rollbacks", "journal_replays",
                                       "journal_seq")},
        })
    finally:
        if load is not None:
            load.stop()
        for c in ctls:
            c.kill()
        # every controller is gone: a replica still alive is an orphan,
        # reported before it is killed
        out["orphan_pids"] = _reap_orphans("rollout", live, fails)
        if follower is not None:
            follower.stop()
        if front is not None:
            front.stop()
        if router is not None:
            router.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    print("rollout " + json.dumps(out), flush=True)
    return out


ZOO_FLEET = ("ResNet18", "MobileNet", "GoogLeNet")


def phase_zoo_fleet(smi: str, fails: Failures) -> dict:
    """Two zoo replicas behind ``tools.router_run --models``, one
    SIGKILLed under a zipf mix (phase 40)."""
    from pytorch_cifar_tpu_torch.serve import (
        HttpTarget,
        load_cost_priors,
        run_load,
        zipf_mix,
    )

    tmp = run_dir("zoofleet-")
    out: dict = {"card": smi, "models": list(ZOO_FLEET), "dtype": "bf16",
                 "max_resident": 2}
    rr = None
    try:
        root = os.path.join(tmp, "ckpt")
        _seeded_ckpt(os.path.join(root, "ResNet18"), 0, 1, 10.0)
        rr = _Launcher([
            "pytorch_cifar_tpu_torch.tools.router_run", "--ckpt", root,
            "--models", ",".join(ZOO_FLEET), "--max_resident", "2",
            "--replicas", "2", "--buckets", *FLEET_BUCKETS,
            "--aot_cache", os.path.join(tmp, "aot"),
            "--deadline_ms", "4000", "--probe_s", "0.2",
            "--max_wait_ms", "1"])
        m = rr.wait_line(r"==> router: serving on (\S+)", 300)
        if not fails.check(m is not None, "zoo_fleet: the router never "
                           "served: " + rr.tail()):
            return out
        url = m.group(1)
        reps = {int(mm.group(1)): (int(mm.group(2)), mm.group(3)) for mm in
                rr.matches(r"==> replica (\d+) pid=(\d+) url=(\S+)")}
        # replica 1 joined after replica 0 filled the cache: every tenant
        # it admitted at start imported its weights
        joined = {n: (t.get("compiles"), t.get("aot_cache_hits"))
                  for n, t in _healthz(reps[1][1]).get("tenants",
                                                       {}).items()
                  if t.get("resident")}
        fails.check(bool(joined) and all(
            v == (0, len(FLEET_BUCKETS)) for v in joined.values()),
            f"zoo_fleet: replica 1's tenants at its start (compiles, "
            f"aot_cache_hits) {joined}")
        x = np.random.RandomState(7).randint(
            0, 256, size=(3, 32, 32, 3)).astype(np.uint8)

        def answers(urls) -> dict:
            """Each model's answer from each url over both encodings
            (three models through two resident slots: evict and
            re-admit on every pass)."""
            return {(mdl, u, w): _bits(u, x, model=mdl, wire=w)
                    for mdl in ZOO_FLEET for u in urls
                    for w in ("json", "binary")}

        urls = [reps[0][1], reps[1][1], url]
        passes = [answers(urls), answers(urls)]
        first = {mdl: passes[0][(mdl, url, "binary")] for mdl in ZOO_FLEET}
        same = {mdl: all(np.array_equal(p[(mdl, u, w)], first[mdl])
                         for p in passes for u in urls
                         for w in ("json", "binary"))
                for mdl in ZOO_FLEET}
        fails.check(all(same.values()), f"zoo_fleet: per-model bits "
                                        f"across the fleet {same}")

        mix = zipf_mix(list(ZOO_FLEET), priors=load_cost_priors())

        def load_phase(secs, seed):
            t = HttpTarget(url, wire="mixed")
            try:
                return run_load(t, clients=4, requests_per_client=10 ** 6,
                                images_max=4, seed=seed, duration_s=secs,
                                bulk_fraction=0.3, model_mix=mix)
            finally:
                t.close()

        steady = load_phase(4.0, 1)
        killer = threading.Timer(2.0, os.kill, (reps[0][0], signal.SIGKILL))
        killer.start()
        killed = load_phase(5.0, 2)
        killer.join()
        post = load_phase(3.0, 3)
        stages = {"steady": steady, "kill": killed, "post_evict": post}
        for tag, rep in stages.items():
            fails.check(rep["failed"] == 0 and rep["requests"] > 0,
                        f"zoo_fleet: {tag}: {rep['failed']} failed of "
                        f"{rep['requests']}")
        survivor = _healthz(reps[1][1]).get("tenants", {})
        churned = sorted(n for n, t in survivor.items()
                         if int(t.get("evictions") or 0) >= 1)
        readmitted = {n: t.get("compiles") for n, t in survivor.items()
                      if int(t.get("admissions") or 0) >= 2
                      and t.get("resident")}
        fails.check(all(c == 0 for c in readmitted.values()),
                    f"zoo_fleet: the survivor's re-admitted tenants' "
                    f"compiles {readmitted}")
        unmoved = {mdl: bool(np.array_equal(_bits(url, x, model=mdl),
                                            first[mdl]))
                   for mdl in ZOO_FLEET}
        healthy = int(_healthz(url).get("healthy_replicas", -1))
        fails.check(all(unmoved.values()) and healthy == 1 and churned,
                    f"zoo_fleet: after the kill: bits {unmoved}, healthy "
                    f"{healthy}, churned tenants {churned}")

        rr.proc.send_signal(signal.SIGTERM)
        code, lines = rr.finish(timeout=180)
        rec = json.loads(lines[-1]) if code == 0 and lines else {}
        fails.check(code == 0 and len(lines) == 1
                    and rec.get("router", {}).get("evictions", 0) >= 1
                    and rec.get("replica_rcs", [None, None])[1] == 0,
                    f"zoo_fleet: router_run exited {code}, record {rec}: "
                    + rr.tail())
        drained = rr.replica_records()
        last = drained.get(1, {})
        lk = last.get("launches_by_kernel", {})
        k3, k4, k5 = (lk.get(k, 0) for k in (
            "conv3x3_bn_relu", "max_pool3x3_s1", "depthwise_stencil"))
        # GoogLeNet 28 K3 + 9 K4 a forward, MobileNet 1 K3 + 9 K5,
        # ResNet18 6 K3: the ResNet-18 share of K3 a whole multiple of 6
        rest = k3 - 28 * (k4 // 9) - k5 // 9
        fails.check(0 not in (k3, k4, k5) and k4 % 9 == 0 and k5 % 9 == 0
                    and rest > 0 and rest % 6 == 0
                    and sorted(drained) == [1],
                    f"zoo_fleet: the survivor's launches (K3, K4, K5) "
                    f"({k3}, {k4}, {k5}); drained records {sorted(drained)}")
        out.update({
            "per_model_bit_identical": same, "post_kill_unmoved": unmoved,
            "mix": mix, "churned_tenants": churned,
            "healthy_after": healthy, "router_rc": code,
            "stages": {k: _stage_row(v, per_model=v.get("per_model"))
                       for k, v in stages.items()},
            "survivor_launches": {"k3": k3, "k4": k4, "k5": k5},
            "replica1_tenants_at_start": joined,
            "survivor_compiles": {n: t.get("compiles")
                                  for n, t in survivor.items()},
            "survivor_tenants": {n: {k: t.get(k) for k in (
                "resident", "admissions", "evictions", "compiles",
                "aot_cache_hits")}
                for n, t in survivor.items()},
            "replica_compiles": rec.get("replica_compiles"),
            "router": rec.get("router"),
        })
    finally:
        if rr is not None:
            rr.kill()
        out["orphan_pids"] = _reap_orphans("zoo_fleet", tmp, fails)
        shutil.rmtree(tmp, ignore_errors=True)
    print("zoo_fleet " + json.dumps(out), flush=True)
    return out


# -- the cold-start cache (phase 41) ------------------------------------

COLD_START_TOOL = "pytorch_cifar_tpu_torch.tools.cold_start"
COLD_LANES = {"bf16": "fp", "int8": "int8"}  # the tool's --lanes


def _cold_start_process(argv) -> dict:
    """One fresh replica process of the cold-start tool: its JSON record,
    or ``{"error": ...}``."""
    p = subprocess.run([sys.executable, "-m", COLD_START_TOOL, *argv],
                       cwd=REPO_ROOT, capture_output=True, text=True,
                       timeout=600)
    if p.returncode != 0 or not p.stdout.strip():
        return {"error": f"rc {p.returncode}: {p.stderr[-3000:]}"}
    return json.loads(p.stdout.strip().splitlines()[-1])


def _bucket_digests(engine) -> dict:
    """SHA-256 of each bucket's logits on the tool's fixed inputs
    (``RandomState(16 + bucket)``)."""
    import hashlib

    out = {}
    for b in engine.buckets:
        x = np.random.RandomState(16 + b).randint(
            0, 256, size=(b, 32, 32, 3)).astype(np.uint8)
        out[str(b)] = hashlib.sha256(np.ascontiguousarray(
            engine.predict(x), dtype=np.float32).tobytes()).hexdigest()
    return out


def _tamper_probe(cache: str, bucket: int) -> str:
    """Negate the stored probe logits of the float lane's ``bucket`` entry
    and rewrite its manifest to match: only the probe can refute it.
    Returns its name."""
    from pytorch_cifar_tpu_torch.train.checkpoint import (
        _atomic_write,
        payload_manifest,
    )

    def float_lane(n):
        with open(os.path.join(cache, n + ".json")) as f:
            return json.load(f)["key"]["int8"] is False

    (name,) = [n for n in os.listdir(cache)
               if n.startswith(f"{LIFECYCLE_MODEL}_b{bucket}_")
               and n.endswith(".aotx") and float_lane(n)]
    path = os.path.join(cache, name)
    with open(path, "rb") as f:
        entry = torch.load(io.BytesIO(f.read()), weights_only=False)
    entry["probe_logits"] = -np.asarray(entry["probe_logits"])
    buf = io.BytesIO()
    torch.save(entry, buf)
    payload = buf.getvalue()
    _atomic_write(path, payload)
    with open(path + ".json") as f:
        meta = json.load(f)
    meta["manifest"] = payload_manifest(payload)
    _atomic_write(path + ".json", json.dumps(meta).encode())
    return name


def phase_cold_start(K, smi: str, fails: Failures) -> dict:
    """A replica's cold start split, without and with the cache, in fresh
    processes; a tampered entry refuted (phase 41)."""
    from pytorch_cifar_tpu_torch.serve import InferenceEngine

    tmp = run_dir("cold-")
    out: dict = {"card": smi, "model": LIFECYCLE_MODEL,
                 "buckets": list(BUCKETS)}
    try:
        ckpt = _seeded_ckpt(os.path.join(tmp, "ckpt"), 0, 1, 10.0)
        cache = os.path.join(tmp, "aot")
        argv = ["--model", LIFECYCLE_MODEL, "--ckpt", ckpt,
                "--buckets", *map(str, BUCKETS), "--aot_cache", cache,
                "--lanes", *COLD_LANES.values()]
        runs = {"miss": _cold_start_process(argv),  # prepares, exports
                "hit": _cold_start_process(argv)}  # imports
        out["processes"] = {t: {k: r.get(k) for k in (
            "process_stages", "device", "kernels_built_now", "error")}
            for t, r in runs.items()}
        n = len(BUCKETS)
        for lane, key in COLD_LANES.items():
            if not fails.check(all("error" not in r for r in runs.values()),
                               f"cold_start: {runs['miss'].get('error')} "
                               f"{runs['hit'].get('error')}"):
                break
            miss, hit = (runs[t]["engines"][key] for t in ("miss", "hit"))
            out[lane] = {"miss": miss, "hit": hit}
            counts = {t: (r["compiles"], r["aot_cache_hits"],
                          r["aot_cache_misses"])
                      for t, r in (("miss", miss), ("hit", hit))}
            fails.check(counts == {"miss": (n, 0, n), "hit": (0, n, 0)},
                        f"cold_start {lane}: (compiles, hits, misses) "
                        f"{counts}")
            same = {b: hit["bits"].get(b) == miss["bits"][b]
                    for b in miss["bits"]}
            fails.check(len(same) == n and all(same.values()),
                        f"cold_start {lane}: the hit's bits per bucket "
                        f"{same}")
            # the hit's warm-ups (each bucket's probe) and second forwards,
            # 6 K3 launches each
            k3 = hit["launches_by_kernel"]["conv3x3_bn_relu"]
            fails.check(k3 == 6 * 2 * n,
                        f"cold_start {lane}: K3 launched {k3} times in the "
                        f"hit process, {6 * 2 * n} expected")
            out[lane]["bits_equal"] = same
            out[lane]["hit_k3_launches"] = k3

        # a tampered entry: bucket 8's probe negated, its manifest valid
        name = _tamper_probe(cache, 8)
        kw = dict(buckets=BUCKETS, compute_dtype=torch.bfloat16,
                  aot_cache_dir=cache)
        want = out["bf16"]["miss"].get("bits", {})
        K.LAUNCHES = 0  # the in-process engines' launches start here
        refuted = InferenceEngine.from_checkpoint(ckpt, LIFECYCLE_MODEL,
                                                  **kw)
        with open(os.path.join(cache, name + ".json")) as f:
            poisoned = bool(json.load(f).get("poisoned"))
        bits_refuted = _bucket_digests(refuted)
        c_refuted = (refuted.compile_count, refuted.aot_cache_hits,
                     refuted.aot_cache_misses)
        n = len(BUCKETS)
        fails.check(poisoned and c_refuted == (n, 0, n)
                    and bits_refuted == want,
                    f"cold_start: the tampered entry poisoned {poisoned}, "
                    f"(compiles, hits, misses) {c_refuted}, bits right "
                    f"{bits_refuted == want}")
        # the tombstone stays: bucket 8 a miss, the rest imported
        after = InferenceEngine.from_checkpoint(ckpt, LIFECYCLE_MODEL, **kw)
        with open(os.path.join(cache, name + ".json")) as f:
            still = bool(json.load(f).get("poisoned"))
        bits_after = _bucket_digests(after)
        c_after = (after.compile_count, after.aot_cache_hits,
                   after.aot_cache_misses)
        fails.check(still and c_after == (1, n - 1, 1)
                    and bits_after == want,
                    f"cold_start: after the poisoning, poisoned {still}, "
                    f"(compiles, hits, misses) {c_after}, bits right "
                    f"{bits_after == want}")
        forwards = refuted.forward_count + after.forward_count
        fails.check(K.LAUNCHES == 6 * forwards,
                    f"cold_start: K3 launched {K.LAUNCHES} times in "
                    f"{forwards} in-process forwards")
        out["tampered"] = {
            "entry": name, "poisoned": poisoned,
            "refuted": {"compiles": refuted.compile_count,
                        "hits": refuted.aot_cache_hits,
                        "misses": refuted.aot_cache_misses,
                        "stages": refuted.cold_start_stages},
            "after": {"compiles": after.compile_count,
                      "hits": after.aot_cache_hits,
                      "misses": after.aot_cache_misses,
                      "stages": after.cold_start_stages},
            "bits_right": bits_refuted == want and bits_after == want,
            "k3_launches": K.LAUNCHES, "forwards": forwards}
        del refuted, after
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("cold_start " + json.dumps(out), flush=True)
    return out


# the drill's ResNet-18 runs on the card: fp32 trainer children (the
# drill's --no-amp) on a cut split whose epochs (about 2 s) are long enough
# that a signal sent half a second after the first checkpoint lands inside
# a later epoch; the two drills run side by side on the one card
CHAOS_ARGS = ("--model", "ResNet18", "--train-size", "5120",
              "--test-size", "1024", "--batch", "128")
CHAOS_EPOCHS = {"sigkill": 3, "serve": 2}


def phase_chaos(smi: str, fails: Failures) -> dict:
    """The port's drill on the card at ResNet-18 (phase 42): ``python -m
    pytorch_cifar_tpu_torch.tools.chaos_run`` in ``sigkill`` mode (match
    at 1e-6, the kill inside a later epoch) and, at the same time, in
    ``serve`` mode (match, and K3 6 times a forward in the relaunched
    serving process)."""
    tmp = run_dir("chaos-")
    out: dict = {"card": smi}
    procs = {}
    try:
        for mode, epochs in CHAOS_EPOCHS.items():
            procs[mode] = subprocess.Popen(
                [sys.executable, "-m",
                 "pytorch_cifar_tpu_torch.tools.chaos_run", "--mode", mode,
                 *CHAOS_ARGS, "--epochs", str(epochs),
                 "--out", os.path.join(tmp, mode)],
                cwd=REPO_ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        recs, errs = {}, {}
        for mode, proc in procs.items():
            try:
                so, se = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                so, se = proc.communicate()
            lines = [ln for ln in so.splitlines() if ln.startswith("{")]
            recs[mode] = json.loads(lines[-1]) if lines else {}
            errs[mode] = se.splitlines()
            fails.check(proc.returncode == 0
                        and recs[mode].get("match") is True,
                        f"chaos {mode}: rc {proc.returncode}, record "
                        f"{recs[mode]}, stderr tail " + se[-2000:])

        rec = recs["sigkill"]
        log = os.path.join(tmp, "sigkill", "chaos", "train.log")
        text = open(log).read() if os.path.exists(log) else ""
        resumed = [int(e) for e in re.findall(
            r"resumed from .*: epoch (\d+)", text)]
        last = CHAOS_EPOCHS["sigkill"] - 1
        fails.check(rec.get("tol") == 1e-6
                    and rec.get("rc") == -int(signal.SIGKILL)
                    and len(resumed) == 1 and 0 < resumed[0] < last,
                    f"chaos sigkill: the kill did not land mid-run (rc "
                    f"{rec.get('rc')}, resumed at {resumed}, last epoch "
                    f"{last})")
        out["sigkill"] = {**rec, "resumed_at_epoch": resumed}
        print("chaos_sigkill " + json.dumps(out["sigkill"]), flush=True)

        relaunch = {}
        for line in errs["serve"]:
            if line.startswith("[serve phase 3] "):
                relaunch = json.loads(line[len("[serve phase 3] "):])
        k3 = relaunch.get("launches_by_kernel", {}).get("conv3x3_bn_relu", 0)
        warm = relaunch.get("compiles", 0) + relaunch.get("aot_cache_hits",
                                                          0)
        forwards = relaunch.get("batches", -1) + warm
        fails.check(k3 > 0 and k3 == 6 * forwards,
                    f"chaos serve: the relaunched replica launched K3 {k3} "
                    f"times for {relaunch.get('batches')} batches and "
                    f"{warm} warm-up forwards")
        fails.check(relaunch.get("device") == torch.cuda.get_device_name(0),
                    f"chaos serve: relaunched on {relaunch.get('device')}")
        out["serve"] = {**recs["serve"], "relaunch": {
            "k3_launches": k3, "forwards": forwards,
            "batches": relaunch.get("batches"),
            "requests": relaunch.get("requests"),
            "dtype": relaunch.get("dtype"),
            "img_per_sec": relaunch.get("img_per_sec")}}
        print("chaos_serve " + json.dumps(out["serve"]), flush=True)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


MESH_TIMEOUT_S = 10.0
MESH_NS = (1, 2, 3, 5, 8, 11, 16, 19, 33)  # JAX's sharded-engine sizes
MESH_LOAD = dict(clients=8, images_max=8)
MESH_READY = r"==> http: serving on (\S+)"


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mesh_images(n: int, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


def _within_serving_bound(got: np.ndarray, want: np.ndarray) -> bool:
    """bf16 serving's bound: within 2% of the largest logit."""
    return float(np.max(np.abs(got - want))) <= 0.02 * float(
        np.max(np.abs(want)))


def _mesh_rank_checks(tag: str, recs: list, fails: Failures) -> list:
    """Each rank's exit record: barrier generation 1 and K3 launched 6
    times a forward on each of its devices (warm-ups, barrier probes,
    buckets and ``--verify`` all count)."""
    rows = []
    for rank, rec in enumerate(recs):
        k3 = (rec.get("launches_by_kernel") or {}).get("conv3x3_bn_relu", 0)
        fwd = rec.get("forwards", -1)
        fails.check(k3 > 0 and k3 == 6 * fwd,
                    f"{tag}: rank {rank} launched K3 {k3} times for {fwd} "
                    "forwards (want 6 a forward)")
        gen = (rec.get("mesh") or rec).get("barrier_generation")
        fails.check(gen == 1, f"{tag}: rank {rank} barrier generation {gen}")
        rows.append({"rank": rank, "k3_launches": k3, "forwards": fwd,
                     "compiles": rec.get("compiles"),
                     "aot_cache_hits": rec.get("aot_cache_hits")})
    return rows


def _mesh_ranks(ckpt: str, procs: int, dtype: str) -> list:
    """The ranks of one logical replica of the serving CLI, leader first,
    each with ``--num_devices 0`` (the visible cards shared out)."""
    coord = f"127.0.0.1:{_free_port()}"
    return [_Launcher([
        REPLICA_MODULE, "--ckpt", ckpt, "--model", LIFECYCLE_MODEL,
        "--buckets", *FLEET_BUCKETS, "--http_port", "0", "--dtype", dtype,
        "--num_devices", "0", "--mesh_procs", str(procs),
        "--mesh_rank", str(r), "--mesh_coord", coord,
        "--mesh_timeout_s", str(MESH_TIMEOUT_S)]) for r in range(procs)]


def _one_process(ckpt: str, dtype: str):
    """A one-process replica of the serving CLI on the first card: the
    reference a replica over ranks answers against, with the same
    process-wide library settings (TF32 among them) as its ranks."""
    return _Launcher([
        REPLICA_MODULE, "--ckpt", ckpt, "--model", LIFECYCLE_MODEL,
        "--buckets", *FLEET_BUCKETS, "--http_port", "0", "--dtype", dtype])


def _mesh_pair(ranks: list, single32, fails: Failures) -> dict:
    """The fp32 replica of ``ranks``: its answers bit for bit those of
    ``single32`` (a one-process fp32 replica on the first card), its
    health, then its drain (SIGTERM to the leader) and each rank's
    record."""
    tag = f"mesh pair x{len(ranks)}"
    m = ranks[0].wait_line(MESH_READY, 300)
    r = single32.wait_line(MESH_READY, 300)
    if not fails.check(m is not None and r is not None,
                       f"{tag}: not up: " + ranks[0].tail()
                       + single32.tail()):
        return {}
    url, ref_url = m.group(1), r.group(1)
    same, worst = True, 0.0
    for n in MESH_NS:
        x = _mesh_images(n, seed=100 + n)
        got, want = _bits(url, x), _bits(ref_url, x)
        same = same and got.shape == want.shape and np.array_equal(got, want)
        worst = max(worst, float(np.max(np.abs(got - want))))
    fails.check(same, f"{tag}: fp32 answers differ from the one-process "
                f"replica's (max abs diff {worst})")
    mesh = _healthz(url).get("mesh") or {}
    fails.check(mesh.get("process_count") == len(ranks)
                and mesh.get("barrier_generation") == 1,
                f"{tag}: health mesh block {mesh}")
    ranks[0].proc.send_signal(signal.SIGTERM)
    recs = []
    for r, launcher in enumerate(ranks):
        code, lines = launcher.finish(timeout=120)
        fails.check(code == 0 and bool(lines),
                    f"{tag}: rank {r} exited rc {code}: " + launcher.tail())
        recs.append(json.loads(lines[-1]) if lines else {})
    return {"fp32_bits_identical": same, "max_abs_diff": worst,
            "mesh": mesh, "ranks": _mesh_rank_checks(tag, recs, fails)}


def _mesh_group_engine(ckpt: str, fails: Failures) -> dict:
    """One process over every visible card (``num_devices``): fp32 bit for
    bit a one-card engine's in the same process, bf16 within the serving
    bound of one, K3 6 times a forward on each card."""
    from pytorch_cifar_tpu_torch.ops import conv_bn_relu as K3
    from pytorch_cifar_tpu_torch.serve import InferenceEngine

    cards = torch.cuda.device_count()
    buckets = tuple(map(int, FLEET_BUCKETS))
    out = {"cards": cards}
    for dname, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        group = InferenceEngine.from_checkpoint(
            ckpt, LIFECYCLE_MODEL, buckets=buckets, compute_dtype=dt,
            num_devices=cards)
        one = InferenceEngine.from_checkpoint(
            ckpt, LIFECYCLE_MODEL, buckets=buckets, compute_dtype=dt)
        k3, f0 = 0, group.forward_count
        bits, bound = True, True
        for n in MESH_NS:
            x = _mesh_images(n, seed=200 + n)
            k0 = K3.LAUNCHES  # the group's launches, not the reference's
            got = group.predict(x)
            k3 += K3.LAUNCHES - k0
            want = one.predict(x)
            bits = bits and np.array_equal(got, want)
            bound = bound and _within_serving_bound(got, want)
        fwd = group.forward_count - f0
        fails.check(k3 == 6 * cards * fwd,
                    f"mesh group {dname}: K3 {k3} for {fwd} forwards on "
                    f"{cards} cards")
        fails.check(bits if dt == torch.float32 else bound,
                    f"mesh group {dname}: answers off the one-card engine")
        out[dname] = {"buckets": list(group.buckets),
                      "bits_identical": bits, "within_bound": bound,
                      "k3_launches": k3, "forwards": fwd}
        del group, one
    return out


def _mesh_fleet(ckpt: str, tmp: str, fleet, single, fails: Failures) -> dict:
    """The bf16 fleet of two 2-rank replicas behind ``router_run``
    (``fleet``) beside a one-process replica (``single``): bits, load,
    the follower's SIGKILL, the drain, and each surviving rank's record."""
    from pytorch_cifar_tpu_torch.serve import HttpTarget
    from pytorch_cifar_tpu_torch.serve.loadgen import run_load

    out: dict = {}
    m = single.wait_line(MESH_READY, 300)
    r = fleet.wait_line(r"==> router: serving on (\S+)", 300)
    if not fails.check(m is not None and r is not None,
                       "mesh fleet: not up: " + fleet.tail()
                       + single.tail()):
        return out
    single_url, router_url = m.group(1), r.group(1)
    leaders = {int(g.group(1)): g.group(3) for g in fleet.matches(
        r"^==> replica (\d+) pid=(\d+) url=(\S+)")}
    followers = {int(g.group(1)): int(g.group(2)) for g in fleet.matches(
        r"^==> replica (\d+) follower rank=1 pid=(\d+)")}
    h1 = _healthz(leaders[1])
    fails.check(h1.get("compiles") == 0
                and (h1.get("mesh") or {}).get("barrier_generation") == 1,
                f"mesh fleet: replica 1's leader joined with {h1}")
    x = _mesh_images(19, seed=7)
    answers = [_bits(u, x, wire=w) for u in (leaders[0], leaders[1],
                                             router_url)
               for w in ("binary", "json")]
    alike = all(np.array_equal(answers[0], a) for a in answers[1:])
    fails.check(alike, "mesh fleet: the replicas and the router differ")
    ref = _bits(single_url, x)
    out["bits"] = {
        "replicas_and_router_alike": alike,
        "within_bound_of_one_process": _within_serving_bound(answers[0],
                                                             ref),
        "bits_held_against_one_process": bool(np.array_equal(answers[0],
                                                             ref)),
        "max_abs_diff": float(np.max(np.abs(answers[0] - ref)))}
    fails.check(out["bits"]["within_bound_of_one_process"],
                f"mesh fleet: off the one-process replica {out['bits']}")
    print("mesh_bits " + json.dumps(out["bits"]), flush=True)

    def load(url, seed, **kw):
        target = HttpTarget(url)
        try:
            return run_load(target, seed=seed, **MESH_LOAD, **kw)
        finally:
            target.close()

    out["one_process"] = _stage_row(load(single_url, 1,
                                         requests_per_client=64))
    out["router_steady"] = _stage_row(load(router_url, 2,
                                           requests_per_client=10**6,
                                           duration_s=5.0))
    detection = {"s": None}

    def kill_and_time():
        t0 = time.monotonic()
        os.kill(followers[0], signal.SIGKILL)
        while time.monotonic() < t0 + MESH_TIMEOUT_S + 10.0:
            try:
                _healthz(leaders[0])
                time.sleep(0.1)
            except (OSError, ValueError):
                detection["s"] = time.monotonic() - t0
                return

    killer = threading.Timer(2.0, kill_and_time)
    killer.start()
    # the kill lands 2 s in; the load runs past the watchdog's bound and
    # the router's eviction
    out["router_kill"] = _stage_row(load(
        router_url, 3, requests_per_client=10**6,
        duration_s=4.0 + MESH_TIMEOUT_S))
    killer.join()
    out["detection_s"] = detection["s"]
    fails.check(detection["s"] is not None,
                f"mesh fleet: replica 0's leader still up "
                f"{MESH_TIMEOUT_S + 10.0} s after its follower's SIGKILL")
    for stage in ("one_process", "router_steady", "router_kill"):
        fails.check(out[stage]["failed"] == 0 and out[stage]["requests"] > 0,
                    f"mesh fleet {stage}: {out[stage]}")
    fleet.proc.send_signal(signal.SIGTERM)
    code, lines = fleet.finish(timeout=120)
    rec = json.loads(lines[-1]) if lines else {}
    rcs = [rec.get("replica_rcs"), rec.get("follower_rcs")]
    fails.check(code == 0 and rcs == [[70, 0], [[-int(signal.SIGKILL)], [0]]]
                and rec.get("router", {}).get("evictions", 0) >= 1,
                f"mesh fleet: drained rc {code}, exit codes {rcs}, router "
                f"{rec.get('router')}")
    survivors = [json.loads(g.group(1)) for g in (
        fleet.matches(r"^\[replica 1\] (\{.*\})$")
        + fleet.matches(r"^\[replica 1:r1\] (\{.*\})$"))]
    fails.check(len(survivors) == 2 and all(
        s.get("compiles") == 0 for s in survivors),
        f"mesh fleet: replica 1's ranks {survivors}")
    out["replica1_ranks"] = _mesh_rank_checks("mesh fleet replica 1",
                                              survivors, fails)
    out["router"] = rec.get("router")
    out["replica_rcs"], out["follower_rcs"] = (rec.get("replica_rcs"),
                                               rec.get("follower_rcs"))
    return out


def _dense_timing(fails: Failures) -> dict:
    """``folded_dense`` beside ``F.linear`` (the serving forwards' dense
    layer before it) on the same bf16 inputs at bucket 128: ResNet-18's
    512 -> 10 head and DenseNet121's 1024 -> 10, device ms each."""
    from pytorch_cifar_tpu_torch.models.common import folded_dense

    g = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for model, width in (("ResNet18", 512), ("DenseNet121", 1024)):
        x = torch.randn(128, width, device="cuda", generator=g,
                        dtype=torch.bfloat16)
        w = torch.randn(10, width, device="cuda", generator=g,
                        dtype=torch.bfloat16) / width ** 0.5
        b = torch.randn(10, device="cuda", generator=g, dtype=torch.bfloat16)
        diff = float((folded_dense(x, w, b).float()
                      - F.linear(x, w, b).float()).abs().max())
        rows = torch.equal(folded_dense(x[:8], w, b), folded_dense(x, w, b)[:8])
        fails.check(rows, f"dense {model}: rows change with the batch")
        out[model] = {"folded_dense_ms": _device_ms(lambda: folded_dense(
                          x, w, b)),
                      "linear_ms": _device_ms(lambda: F.linear(x, w, b)),
                      "max_abs_diff": diff, "rows_batch_invariant": rows}
    return out


def phase_mesh(smi: str, fails: Failures, four_card: bool = False) -> dict:
    """Serving over a device group (phase 43; ``--only mesh`` over every
    visible card): see the module docstring."""
    tmp = run_dir("mesh-")
    ckpt = _seeded_ckpt(os.path.join(tmp, "ckpt"), seed=11, epoch=1,
                        best_acc=0.5)
    out: dict = {"card": smi}
    launched = []
    try:
        procs = torch.cuda.device_count() if four_card else 2
        ranks = _mesh_ranks(ckpt, procs, "float32")
        single32 = _one_process(ckpt, "float32")
        launched += [*ranks, single32]
        if not four_card:
            single = _one_process(ckpt, "bfloat16")
            fleet = _Launcher([
                "pytorch_cifar_tpu_torch.tools.router_run", "--ckpt", ckpt,
                "--model", LIFECYCLE_MODEL, "--replicas", "2",
                "--mesh_procs", "2", "--mesh_timeout_s", str(MESH_TIMEOUT_S),
                "--aot_cache", os.path.join(tmp, "aot"),
                "--buckets", *FLEET_BUCKETS, "--deadline_ms", "4000",
                "--probe_s", "0.2", "--max_wait_ms", "1"])
            launched += [single, fleet]
        t0 = time.perf_counter()
        if four_card:
            out["group_engine"] = _mesh_group_engine(ckpt, fails)
            print("mesh_group_engine " + json.dumps(out["group_engine"]),
                  flush=True)
        else:
            out["dense"] = _dense_timing(fails)
            print("mesh_dense " + json.dumps(out["dense"]), flush=True)
        out["pair"] = _mesh_pair(ranks, single32, fails)
        out["stage_s"] = {"pair": time.perf_counter() - t0}
        print("mesh_pair " + json.dumps(out["pair"]), flush=True)
        if not four_card:
            t0 = time.perf_counter()
            out["fleet"] = _mesh_fleet(ckpt, tmp, fleet, single, fails)
            out["stage_s"]["fleet"] = time.perf_counter() - t0
            print("mesh_fleet " + json.dumps(out["fleet"]), flush=True)
    finally:
        t0 = time.perf_counter()
        for launcher in launched:  # a follower ignores it: its leader drains
            if launcher.proc.poll() is None:
                launcher.proc.send_signal(signal.SIGTERM)
        for launcher in launched:
            try:
                launcher.finish(timeout=60)
            except Exception:
                launcher.kill()
        _reap_orphans("mesh", tmp, fails)
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        out.setdefault("stage_s", {})["cleanup"] = time.perf_counter() - t0
        print("mesh_stage_s " + json.dumps(out["stage_s"]), flush=True)
    return out


ELASTIC_ARGS = ("--device", "cuda", "--model", "ResNet18", "--batch_size",
                str(BATCH), "--amp", "--synthetic_data",
                "--synthetic_train_size", str(CUT_TRAIN),
                "--synthetic_test_size", str(CUT_TEST), "--device_data",
                "--log_every", "100000")
ELASTIC_EPOCHS = 4  # (a): the kill lands in epoch 1 or 2, 2-3 left
GROWTH_EPOCHS = 8  # (c): the world-1 generation stops after one epoch
ELASTIC_GRACE_S = 30.0  # ElasticTrainRunner's default grace_s
FIT_START = re.compile(r"^(\S+ \S+):INFO: ==> model ")
TRAIN_LOSS = re.compile(r"train epoch (\d+): loss (\S+)")
RESUMED = re.compile(r"resumed from .*: epoch (\d+)")


def _wait_for(cond, timeout_s: float, poll_s: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(poll_s)
    return True


def _supervise(argv: list, procs: int, scenario=None,
               resume_first: bool = False, timeout_s: float = 600.0):
    """``ElasticTrainRunner(argv, procs)`` over the train CLI, on a thread,
    while ``scenario(runner)`` (the kills and the added host) runs here.
    Returns the run record, each generation's spawn time (wall clock) and
    the rank pids still alive after the run (none, if every child was
    reaped)."""
    from pytorch_cifar_tpu_torch.train.elastic import ElasticTrainRunner

    class Timed(ElasticTrainRunner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.spawned_at, self.spawned_pids = [], []

        def _spawn_generation(self, gen, world):
            self.spawned_at.append(time.time())
            ranks = super()._spawn_generation(gen, world)
            self.spawned_pids += [r.proc.pid for r in ranks]
            return ranks

    env = {k: v for k, v in os.environ.items() if k != "PCT_FAULTS"}
    runner = Timed(argv, procs, env=env, cwd=REPO_ROOT,
                   resume_first=resume_first, grace_s=ELASTIC_GRACE_S)
    record: dict = {}
    th = threading.Thread(
        target=lambda: record.update(runner.run(timeout_s=timeout_s)))
    th.start()
    try:
        if scenario is not None:
            scenario(runner)
    finally:
        th.join(timeout=timeout_s + 4 * ELASTIC_GRACE_S)
    alive = []
    for pid in runner.spawned_pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except OSError:
            pass
    return record, runner, alive


def _fit_starts(text: str) -> list:
    """Wall-clock times of the log's ``==> model`` lines (each
    generation's ``fit`` start), from the file handler's asctime."""
    import datetime

    return [datetime.datetime.strptime(
        m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp()
        for m in map(FIT_START.match, text.splitlines()) if m]


def _elastic_log_checks(tag: str, text: str, record: dict, runner,
                        fails: Failures) -> dict:
    """What every supervised run is held to: the run completed, each
    generation's losses finite, every rank reaped; returns each
    generation's start (spawn to ``fit``) and the losses."""
    fails.check(record.get("completed") is True,
                f"elastic {tag}: the run did not complete: {record}")
    losses = [(int(e), float(v)) for e, v in TRAIN_LOSS.findall(text)]
    fails.check(losses and all(np.isfinite(v) for _, v in losses),
                f"elastic {tag}: losses {losses}")
    # a generation stopped before its fit (a signal in its start) logs
    # no fit line: each fit start goes with the newest spawn before it
    starts = [t - max([s for s in runner.spawned_at if s <= t] or [t])
              for t in _fit_starts(text)]
    return {"losses": losses, "generation_start_s": starts}


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def _last_metrics(path: str) -> dict:
    with open(path) as f:
        return json.loads(f.read().splitlines()[-1])["metrics"]["counters"]


def _elastic_preempt(run: str, fails: Failures) -> dict:
    """(a): one rank on the card, SIGKILLed after its first durable
    checkpoint; the next generation resumes at the saved epoch + 1."""
    metrics = os.path.join(run, "metrics.jsonl")
    argv = [*ELASTIC_ARGS, "--epochs", str(ELASTIC_EPOCHS), "--output_dir",
            run, "--metrics_out", metrics]
    kill: dict = {}

    def scenario(runner):
        if not _wait_for(lambda: os.path.exists(os.path.join(
                run, "ckpt.json")) or runner.generations, 300):
            return
        pids = runner.pids()
        if 0 in pids and not runner.generations:
            os.kill(pids[0], signal.SIGKILL)
            _wait_for(lambda: runner.generations, 120)
            with open(os.path.join(run, "ckpt.json")) as f:
                kill["saved_epoch"] = json.load(f)["epoch"]

    t0 = time.perf_counter()
    record, runner, alive = _supervise(argv, 1, scenario)
    wall = time.perf_counter() - t0
    with open(os.path.join(run, "train.log")) as f:
        text = f.read()
    out = {"wall_s": wall, "record": record,
           **_elastic_log_checks("preempt", text, record, runner, fails)}
    fails.check(not alive, f"elastic preempt: ranks left alive {alive}")
    gens = record.get("generations", [])
    fails.check([(g["world"], g["event"]) for g in gens]
                == [(1, "preempted:rank0:rc-9"), (1, "completed")]
                and record.get("restarts") == 1,
                f"elastic preempt: generations {gens}")
    saved = kill.get("saved_epoch")
    resumed = [int(e) for e in RESUMED.findall(text)]
    counters = _last_metrics(metrics)
    left = ELASTIC_EPOCHS - (saved + 1) if saved is not None else None
    fails.check(saved is not None and resumed == [saved + 1]
                and counters.get("checkpoint.restores") == 1
                and counters.get("train.epochs") == left,
                f"elastic preempt: saved epoch {saved}, resumed at {resumed}, "
                f"the second generation's counters {counters}")
    with open(os.path.join(run, "ckpt.json")) as f:
        best = json.load(f)["best_acc"]
    fails.check(record.get("best_acc") == round(best, 2),
                f"elastic preempt: the record's best_acc "
                f"{record.get('best_acc')}, ckpt.json's {best}")
    out.update(saved_epoch=saved, resumed_at=resumed, epochs_after=left,
               restores=counters.get("checkpoint.restores"))
    return out


def _elastic_cross_topology(run: str, fails: Failures) -> dict:
    """(b): the run's best checkpoint re-cut to a two-shard v3 set, then
    resumed by one elastic rank on the card for one epoch: the resume
    re-cuts it to v2 (``reshard_to_world``)."""
    import hashlib

    from pytorch_cifar_tpu_torch.train.checkpoint import (
        CKPT_NAME,
        committed_shard_count,
        read_meta,
        read_verified_payload,
        reshard_checkpoint,
    )

    reshard_checkpoint(run, CKPT_NAME, 2)
    meta = read_meta(run, CKPT_NAME)
    fails.check(committed_shard_count(run, CKPT_NAME) == 2
                and meta.get("format") == 3,
                f"elastic cross_topology: the re-cut is not a v3 set of 2: "
                f"{meta}")
    saved = int(meta["epoch"])
    sha = hashlib.sha256(read_verified_payload(run, CKPT_NAME)).hexdigest()
    metrics = os.path.join(run, "metrics_b.jsonl")
    spans = os.path.join(run, "trace_b.json")
    argv = [*ELASTIC_ARGS, "--epochs", str(saved + 2), "--output_dir", run,
            "--metrics_out", metrics, "--trace_out", spans]
    t0 = time.perf_counter()
    record, runner, alive = _supervise(argv, 1, resume_first=True)
    wall = time.perf_counter() - t0
    with open(os.path.join(run, "train.log")) as f:
        lines = f.read().splitlines()
    # this run's part of the log: from the resume's line on
    first = max([i for i, ln in enumerate(lines) if RESUMED.search(ln)]
                or [0])
    text = "\n".join(lines[first:])
    resumed = [int(e) for e in RESUMED.findall(text)]
    out = {"wall_s": wall, "record": record,
           **_elastic_log_checks("cross_topology", text, record, runner,
                                 fails)}
    fails.check(not alive, f"elastic cross_topology: ranks left alive "
                f"{alive}")
    counters = _last_metrics(metrics)
    after = read_meta(run, CKPT_NAME)
    fails.check(record.get("restarts") == 0 and resumed == [saved + 1]
                and counters.get("checkpoint.restores") == 1
                and counters.get("checkpoint.reshards") == 1
                and counters.get("train.epochs") == 1,
                f"elastic cross_topology: resumed at {resumed} (saved "
                f"{saved}), counters {counters}, record {record}")
    fails.check(committed_shard_count(run, CKPT_NAME) == 1
                and "shards" not in after,
                f"elastic cross_topology: the layout left is not v2: {after}")
    with open(spans) as f:
        reshard_ms = [e["dur"] / 1e3 for e in json.load(f)["traceEvents"]
                      if e.get("name") == "checkpoint/reshard"]
    fails.check(len(reshard_ms) == 1,
                f"elastic cross_topology: checkpoint/reshard spans "
                f"{reshard_ms}")
    out.update(saved_epoch=saved, resumed_at=resumed,
               payload_bytes=meta["total"]["size"], payload_sha256=sha,
               reshard_ms=reshard_ms, counters={
                   k: counters.get(k) for k in (
                       "checkpoint.restores", "checkpoint.reshards",
                       "train.epochs")})
    return out


def _elastic_growth(run: str, fails: Failures) -> dict:
    """(c), two or more cards: two ranks over NCCL, rank 1 SIGKILLed after
    the first durable checkpoint, the survivor world of one, a host added,
    two ranks again to the end."""
    metrics = os.path.join(run, "metrics.jsonl")
    argv = [*ELASTIC_ARGS, "--epochs", str(GROWTH_EPOCHS), "--output_dir",
            run, "--metrics_out", metrics]
    log = os.path.join(run, "train.log")
    seen: dict = {}

    def scenario(runner):
        if not _wait_for(lambda: os.path.exists(os.path.join(
                run, "ckpt.json")) or runner.generations, 300):
            return
        pids = runner.pids()
        if 1 in pids and not runner.generations:
            t_kill = time.monotonic()
            os.kill(pids[1], signal.SIGKILL)
            _wait_for(lambda: runner.generations, 4 * ELASTIC_GRACE_S)
            seen["left_s"] = time.monotonic() - t_kill
        # the host is added once the survivor world trains (its fit line
        # logged): it stops after that epoch with last.msgpack saved
        if _wait_for(lambda: len(runner.generations) == 1
                     and set(runner.pids()) == {0}
                     and len(_fit_starts(_read(log))) >= 2, 300):
            runner.add_host()

    t0 = time.perf_counter()
    record, runner, alive = _supervise(argv, 2, scenario)
    wall = time.perf_counter() - t0
    with open(os.path.join(run, "train.log")) as f:
        text = f.read()
    out = {"wall_s": wall, "record": record,
           **_elastic_log_checks("growth", text, record, runner, fails)}
    fails.check(not alive, f"elastic growth: ranks left alive {alive}")
    gens = record.get("generations", [])
    events = [g["event"] for g in gens]
    fails.check(len(gens) >= 3 and gens[0]["event"] == "preempted:rank1:rc-9"
                and gens[1] == {"world": 1, "rcs": [0],
                                "event": "scale:1->2"}
                and record.get("final_world") == 2,
                f"elastic growth: generations {gens}")
    # the grown world resumed the world-1 generation's preemption save and
    # re-cut both candidates to two shards
    counters = _last_metrics(metrics)
    fails.check(counters.get("checkpoint.reshards") == 2
                and counters.get("checkpoint.restores") == 1,
                f"elastic growth: the grown world's counters {counters}")
    # the survivor left the dead collective on its own (the rank
    # contract), never by the supervisor's SIGKILL
    survivor_rc = gens[0]["rcs"][0] if gens else None
    backstop = [(i, r) for i, g in enumerate(gens)
                for r, rc in enumerate(g["rcs"])
                if rc == -signal.SIGKILL and (i, r) != (0, 1)]
    fails.check(survivor_rc == 75 and not backstop
                and seen.get("left_s", 1e9) < ELASTIC_GRACE_S,
                f"elastic growth: survivor rc {survivor_rc} after "
                f"{seen.get('left_s')} s, SIGKILLed by the backstop: "
                f"{backstop}")
    with open(os.path.join(run, "ckpt.json")) as f:
        meta = json.load(f)
    fails.check(len(meta.get("shards") or ()) == 2,
                f"elastic growth: the final layout is not two shards: {meta}")
    # which path ended the survivor: its peer watch, or its fit raising
    how = [ln for ln in text.splitlines()
           if "elastic rank lost its world" in ln
           or "elastic rank failed mid-fit" in ln][:1]
    out.update(survivor_rc=survivor_rc, survivor_left_s=seen.get("left_s"),
               survivor_exit=how, final_shards=len(meta.get("shards") or ()),
               resumed_at=[int(e) for e in RESUMED.findall(text)],
               grown_reshards=counters.get("checkpoint.reshards"))
    return out


def phase_elastic(smi: str, fails: Failures, multi_card: bool = False
                  ) -> dict:
    """Elastic training through the train CLI's supervisor (phase 44):
    see the module docstring."""
    tmp = run_dir("elastic-")
    out: dict = {"card": smi}
    t0 = time.perf_counter()
    try:
        if multi_card:
            out["growth"] = _elastic_growth(os.path.join(tmp, "growth"),
                                            fails)
        else:
            run = os.path.join(tmp, "run")
            out["preempt"] = _elastic_preempt(run, fails)
            out["cross_topology"] = _elastic_cross_topology(run, fails)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    print("elastic " + json.dumps(out), flush=True)
    return out


SPATIAL_EVAL_BS = 1000  # TrainConfig's eval batch: 3 eval forwards an epoch


@functools.lru_cache(maxsize=None)
def _eval_kernels(model: str) -> dict:
    """K3, K4 and K5 launches of one folded forward of ``model`` (its
    sites recorded from one image on the CPU): what every rank of a
    spatial group launches, each site on its own slab."""
    return {"k3": sum(s[-1] for s in fused_sites(model)),
            "k4": sum(s[-1] for s in pool_sites(model)),
            "k5": sum(s[-1] for s in stencil_sites(model))}


def _spatial_steps(specs: list, world: int, fails: Failures) -> list:
    """Each spatial step spec against one process's step (phase 45, 1 and
    3): the ranks' states equal, the step within JAX's tolerances, the
    fp32 eval forward's logits within the served fp32 tolerance of one
    process's, every rank's eval forward launching K3, K4 and K5 as many
    times as one process's forward (:func:`_eval_kernels`), and K4
    forward and backward launched on every rank of a step of a model with
    3x3 / stride 1 pools (GoogLeNet, PNASNet)."""
    from pytorch_cifar_tpu_torch.tools import spatial_runs as SR

    ranks = SR.compare_steps(specs, world)
    rows = []
    for i, bad in SR.step_checks(ranks):
        spec = specs[i]
        tag = (f"spatial: {spec['model']} b{spec['batch']} mesh "
               f"{spec['mesh']} augment {spec['augment']} "
               f"{spec['compute']}")
        fails.check(not bad, f"{tag}: {bad}")
        per = [r[i] for r in ranks]
        want = _eval_kernels(spec["model"])
        fails.check(all(p["eval_launches"] == want for p in per),
                    f"{tag}: eval launches {[p['eval_launches'] for p in per]}"
                    f" on the ranks, one forward's {want}")
        if want["k4"] and not spec["library_pools"]:
            fails.check(all(p["k4_launches"][0] > 0 and p["k4_launches"][1]
                            > 0 for p in per),
                        f"{tag}: K4 not launched on every rank: "
                        f"{[p['k4_launches'] for p in per]}")
        c = [p["counts"] for p in per]
        rows.append({
            "model": spec["model"], "mesh": spec["mesh"],
            "batch": spec["batch"], "augment": spec["augment"],
            "compute": spec["compute"],
            "one_process": {k: v for k, v in per[0]["one_process"].items()
                            if k != "logits"},
            "noise": per[0].get("noise"),
            # every rank's ms: each window opens and closes on a fence all
            # ranks leave together, and the slowest is the step's
            "step_ms": [p["step_ms"] for p in per],
            "logits_off": SR.logits_off(per),
            # a rank's exchanges of the compared step: forward (height and
            # width) and backward, and the bytes it sent
            "halo_exchanges": [x["halo_exchanges_h"] + x["halo_exchanges_w"]
                               + x["halo_exchanges_bwd"] for x in c],
            "halo_bytes": [x["halo_bytes"] for x in c],
            "halo_max_rows": max(x["halo_max_rows"] for x in c),
            "bn_reductions": c[0]["bn_reductions"],
            "group_sums": c[0]["group_sums"],
            "eval_launches": [p["eval_launches"] for p in per],
            "k4_launches": [p["k4_launches"] for p in per],
        })
    return rows


SLAB_MESHES = ((1, 2, 1), (1, 4, 1), (1, 2, 2))  # (2, 2, 1) cuts as (1, 2, 1)
# the models whose kernel sites the slab checks take: K3 (fused), K4
# (3x3 / stride 1 pools) and K5 (depthwise stencils)
SLAB_FUSED = ("SimpleDLA", "VGG16")
SLAB_POOLS = ("PNASNetA", "PNASNetB")
SLAB_STENCILS = ("MobileNet", "PNASNetA", "PNASNetB")
SLAB_N5 = 32  # K5's batch on a slab


def _slab_stencils(D, g, fails: Failures) -> list:
    """K5 on the halo-extended slabs (phase 45, 0): every extended shape of
    the stride-1 depthwise sites of :data:`SLAB_STENCILS` (k = 3, 5, 7)
    over :data:`SLAB_MESHES`, bf16 and fp32, at n = :data:`SLAB_N5`, with
    zeros (the image edge's pad value) along a slab's first and last rows
    and columns of the first images, against its plain version at phase
    3's tolerances (``_stencil_row``)."""
    from pytorch_cifar_tpu_torch.tools import spatial_runs as SR

    shapes = sorted({(a, b, c, k) for name in SLAB_STENCILS
                     for h, w, c, k, _ in stencil_sites(name)
                     for m in SLAB_MESHES
                     for a, b in SR.slab_shapes(h, w, m, k)})
    rows = []
    for dname, dt in DTYPES.items():
        rtol, atol = (2e-5, 2e-5) if dname == "fp32" else (2.0 ** -7, 1e-4)
        err = 0.0
        for h, w, c, k in shapes:
            x = torch.randn(SLAB_N5, h, w, c, generator=g).to("cuda", dt)
            x[0, 0] = 0.0
            x[1, -1] = 0.0
            x[2, :, 0] = 0.0
            x[3, :, -1] = 0.0
            wt = (torch.randn(k, k, c, generator=g) / k).to("cuda", dt)
            out = D.depthwise_stencil(x, wt)
            ref = D.depthwise_stencil_reference(x.float(), wt.float())
            diff = (out.float() - ref).abs()
            fails.check(
                bool((diff <= atol + rtol * ref.abs()).all())
                and bool(torch.isfinite(out).all()),
                f"spatial slab K5 {dname} ({SLAB_N5}, {h}, {w}, {c}) k={k}: "
                f"kernel vs plain max abs {diff.max().item():.3g} over "
                "tolerance")
            err = max(err, diff.max().item())
        rows.append({"dtype": dname, "k5_shapes": [list(t) for t in shapes],
                     "k5_max_abs_err": err})
    return rows


def _spatial_slab_kernels(K, P, D, fails: Failures) -> list:
    """K3, K4 and K5 on the halo-extended slabs the spatial path hands them
    (phase 45, 0): every extended shape of ResNet-18's, SimpleDLA's and
    VGG16's fused sites, of GoogLeNet's and PNASNet's 3x3 / stride 1 pools
    over :data:`SLAB_MESHES`, bf16 and fp32. K3 at n = 128 and 3 against
    its plain version at phase_kernels' tolerances; K4's forward, winner
    map and backward (n = 32) bit for bit the plain version's
    (``_pool_checks``), with the pad value of an image edge (zeros for K3,
    -inf for K4) along a slab's first and last rows and columns of the
    first images; K5 as :func:`_slab_stencils`."""
    from pytorch_cifar_tpu_torch.tools import spatial_runs as SR

    # the plain fp32 conv without TF32, as phase 3 runs it (``--only
    # spatial`` runs no phase 3)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(45)
    sites = list(SITES) + [s for name in SLAB_FUSED
                           for s in fused_sites(name)]
    k3_shapes = sorted({(a, b, cin, cout) for m in SLAB_MESHES
                        for _, h, w, cin, cout, _ in sites
                        for a, b in SR.slab_shapes(h, w, m)})
    pools = list(POOL_SHAPES) + [p for name in SLAB_POOLS
                                 for p in pool_sites(name)]
    k4_shapes = sorted({(a, b, c) for m in SLAB_MESHES
                        for h, w, c, _ in pools
                        for a, b in SR.slab_shapes(h, w, m)})
    rows = []
    for dname, dt in DTYPES.items():
        rtol, atol = (1e-4, 1e-4) if dname == "fp32" else (1.6e-2, 1e-2)
        k3_err = 0.0
        for h, w, cin, cout in k3_shapes:
            wt = (torch.randn(3, 3, cin, cout, generator=g)
                  / (9 * cin) ** 0.5).to("cuda", dt)
            scale = (torch.rand(cout, generator=g) + 0.5).cuda()
            bias = (0.1 * torch.randn(cout, generator=g)).cuda()
            for n in (128, 3):
                x = torch.randn(n, h, w, cin, generator=g).to("cuda", dt)
                x[0, 0] = 0.0
                x[1, -1] = 0.0
                x[2, :, 0] = 0.0
                out = K.conv3x3_bn_relu(x, wt, scale, bias)
                ref = K.conv3x3_bn_relu_reference(x.float(), wt.float(),
                                                  scale, bias)
                diff = (out.float() - ref).abs()
                fails.check(
                    bool((diff <= atol + rtol * ref.abs()).all())
                    and bool(torch.isfinite(out).all()),
                    f"spatial slab K3 {dname} ({n}, {h}, {w}, {cin}) -> "
                    f"{cout}: kernel vs plain max abs "
                    f"{diff.max().item():.3g} over tolerance")
                k3_err = max(k3_err, diff.max().item())
        fwd_err = bwd_err = 0.0
        for h, w, c in k4_shapes:
            x = torch.randn(32, h, w, c, generator=g).to("cuda", dt)
            x[0, 0] = float("-inf")
            x[1, -1] = float("-inf")
            x[2, :, 0] = float("-inf")
            x[3, :, -1] = float("-inf")
            cot = torch.randint(0, 9, x.shape, generator=g).to("cuda", dt)
            f, b = _pool_checks(P, x, cot,
                                f"spatial slab {dname} {tuple(x.shape)}",
                                fails)
            fwd_err, bwd_err = max(fwd_err, f), max(bwd_err, b)
        rows.append({"dtype": dname,
                     "k3_shapes": [list(t) for t in k3_shapes],
                     "k3_max_abs_err": k3_err,
                     "k4_shapes": [list(t) for t in k4_shapes],
                     "k4_fwd_max_abs_err": fwd_err,
                     "k4_bwd_max_abs_err": bwd_err})
    for row, k5 in zip(rows, _slab_stencils(D, g, fails)):
        row.update(k5)
    return rows


# the overlapping average pools of the zoo (ShuffleNet's 3 / 2 / 1
# shortcut), whole and on a height slab as ``window_op`` hands it
AVG_POOLS = ((3, 2, 1, (64, 24, 32, 32)), (3, 2, (0, 1), (64, 24, 17, 32)))


def _avg_pool_grads(fails: Failures) -> list:
    """``common._avg_pool2d``'s input gradient on a channels_last CUDA
    tensor against the CPU's float64 one, fp32 and float64, within 1e-6
    of the largest value (phase 45, 0); beside it the plain
    ``F.avg_pool2d`` on the same channels_last tensor, whose backward the
    port routes around (printed, not held)."""
    from pytorch_cifar_tpu_torch.models import common

    g = torch.Generator().manual_seed(46)
    rows = []
    for k, s, pad, shape in AVG_POOLS:
        x0 = torch.randn(*shape, generator=g, dtype=torch.float64)
        g0 = torch.randn(*F.avg_pool2d(x0, k, s, pad).shape, generator=g,
                         dtype=torch.float64)

        def grad(fn, dev, dt):
            x = x0.to(dev, dt).contiguous(
                memory_format=torch.channels_last).requires_grad_(True)
            fn(x, k, s, pad).backward(g0.to(dev, dt))
            return x.grad.double().cpu()

        ref = grad(F.avg_pool2d, "cpu", torch.float64)
        row = {"pool": [k, s, pad], "x": list(shape)}
        for dname, dt in (("fp32", torch.float32), ("f64", torch.float64)):
            for tag, fn in (("port", common._avg_pool2d),
                            ("library", F.avg_pool2d)):
                err = float((grad(fn, "cuda", dt) - ref).abs().max()
                            / ref.abs().max())
                row[f"{tag}_{dname}_rel_err"] = err
            fails.check(row[f"port_{dname}_rel_err"] <= 1e-6,
                        f"avg pool {k}/{s}/{pad} {dname} {shape}: input "
                        f"gradient {row[f'port_{dname}_rel_err']:.3g} off "
                        "the CPU's float64")
        rows.append(row)
    return rows


def _spatial_fit(root: str, four_card: bool, fails: Failures) -> dict:
    """The train CLI's bf16 spatial run (phase 45, 2): a falling loss, K1
    once an epoch and K3 6 times an eval forward on every rank, and the
    checkpoint restored by one process to the run's accuracy (within 2 of
    2,048 images: bf16's kernels tile a slab otherwise than an image)."""
    from pytorch_cifar_tpu_torch.tools import dp_runs
    from pytorch_cifar_tpu_torch.tools import spatial_runs as SR
    from pytorch_cifar_tpu_torch.train.__main__ import main as train_main

    out_dir = os.path.join(root, "fit")
    t0 = time.perf_counter()
    if four_card:
        ranks = train_main(SR.fit_argv(out_dir) + ["--num_devices", "4"])[
            "ranks"]
    else:
        ranks = dp_runs.gloo_pair(SR.fit_argv(out_dir))
    fit_s = time.perf_counter() - t0
    data = len(ranks) // 2
    eval_forwards = 2 * -(-SR.TEST_N // (SPATIAL_EVAL_BS // data * data))
    tag = f"spatial fit ({len(ranks)} ranks)"
    hist = ranks[0]["history"]
    losses = [h["train_loss"] for h in hist]
    fails.check(len(hist) == 2 and all(np.isfinite(losses))
                and losses[1] < losses[0], f"{tag}: losses {losses}")
    fails.check(all(h["train"]["count"] == SR.TRAIN_N
                    and h["eval"]["count"] == SR.TEST_N for h in hist),
                f"{tag}: counts {[(h['train']['count'], h['eval']['count']) for h in hist]}")
    launches = [r["launches_by_kernel"] for r in ranks]
    fails.check(all(L["dma_row_gather"] == 2 for L in launches),
                f"{tag}: K1 launches {launches}")
    fails.check(all(L["conv3x3_bn_relu"] == 6 * eval_forwards
                    for L in launches),
                f"{tag}: K3 launches {launches}, want "
                f"{6 * eval_forwards} a rank")
    keys = ("train", "eval")
    fails.check(all([{k: h[k] for k in keys} for h in r["history"]]
                    == [{k: h[k] for k in keys} for h in hist]
                    for r in ranks), f"{tag}: the ranks' metrics differ")
    t1 = time.perf_counter()
    one = train_main(SR.fit_argv(out_dir, 1, 1)
                     + ["--evaluate", "--num_devices", "1"])
    eval_s = time.perf_counter() - t1
    best = ranks[0]["best_acc"]
    fails.check(abs(one["best_acc"] - best) <= 100.0 * 2 / SR.TEST_N,
                f"{tag}: one process restores {one['best_acc']:.3f}% of "
                f"the run's {best:.3f}%")
    return {"ranks": len(ranks), "backend": ranks[0]["backend"],
            "epochs": [{k: h[k] for k in ("train_loss", "eval_loss",
                                          "eval_acc", "img_per_sec")}
                       for h in hist],
            "launches_per_rank": launches, "best_acc": best,
            "one_process_acc": one["best_acc"], "fit_s": fit_s,
            "eval_s": eval_s}


def phase_spatial(smi: str, fails: Failures, four_card: bool = False
                  ) -> dict:
    """Spatial partitioning (phase 45 of the module docstring): K3 and K4
    on the extended slabs, the step against one process's, then the train
    CLI's bf16 run."""
    from pytorch_cifar_tpu_torch.ops import conv_bn_relu as K
    from pytorch_cifar_tpu_torch.ops import depthwise_stencil as D
    from pytorch_cifar_tpu_torch.ops import max_pool as P
    from pytorch_cifar_tpu_torch.tools import spatial_runs as SR

    t0 = time.perf_counter()
    out: dict = {"card": smi}
    out["slab_kernels"] = _spatial_slab_kernels(K, P, D, fails)
    out["avg_pool_grads"] = _avg_pool_grads(fails)
    out["slab_kernels_s"] = time.perf_counter() - t0
    if four_card:
        specs = [SR.step_spec("ResNet18", m, 512, False)
                 for m in ((1, 4, 1), (1, 2, 2), (2, 2, 1))]
    else:
        specs = [SR.step_spec("ResNet18", (1, 2, 1), 512, False),
                 SR.step_spec("ResNet18", (1, 2, 1), 512, True),
                 SR.step_spec("GoogLeNet", (1, 2, 1), 32, False),
                 SR.step_spec("SimpleDLA", (1, 2, 1), SPATIAL_DLA_BATCH,
                              False, reps=1, compute="float64")]
    out["steps"] = _spatial_steps(specs, 4 if four_card else 2, fails)
    out["steps_s"] = time.perf_counter() - t0
    root = run_dir("spatial_")
    try:
        out["fit"] = _spatial_fit(root, four_card, fails)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    for row in out["slab_kernels"]:
        print(f"spatial card {smi}: slab kernels {row['dtype']}: K3 at "
              f"{len(row['k3_shapes'])} extended shapes, max abs "
              f"{row['k3_max_abs_err']:.3g}; K4 at "
              f"{len(row['k4_shapes'])}, forward {row['k4_fwd_max_abs_err']}"
              f", backward {row['k4_bwd_max_abs_err']}; K5 at "
              f"{len(row['k5_shapes'])}, max abs "
              f"{row['k5_max_abs_err']:.3g}", flush=True)
    for row in out["avg_pool_grads"]:
        print(f"spatial card {smi}: avg pool grads {json.dumps(row)}",
              flush=True)
    _print_steps("spatial", smi, out["steps"])
    print("spatial " + json.dumps(out), flush=True)
    return out


def _print_steps(tag: str, smi: str, rows: list) -> None:
    for row in rows:
        one = row["one_process"]
        ms = row["step_ms"]
        print(f"{tag} card {smi}: {row['model']} b{row['batch']} "
              f"{row['compute']} mesh {row['mesh']} augment "
              f"{row['augment']}: step "
              f"{max(ms):.1f} ms on the slowest rank (ranks "
              f"{min(ms):.1f}-{max(ms):.1f}) against one process's "
              f"{one['step_ms']:.1f} ms; {row['halo_exchanges'][0]} halo "
              f"exchanges a step on rank 0, {row['halo_bytes'][0]} B sent; "
              f"params {one['param_max_abs_diff']:.2e}, BN "
              f"{one['bn_max_abs_diff']:.2e}, loss {one['loss_rel_diff']:.2e}"
              f" off one process; eval logits {row['logits_off']:.3g} of "
              f"the tolerance; eval launches {row['eval_launches'][0]} a "
              f"rank; noise {row['noise']}", flush=True)


# phase 45's SimpleDLA step, in float64 compute: its fp32 step lands
# 5.1e-4-6.0e-4 from its own float64 step at b64-b128 (PERF.md §6), over
# the 5e-4 the comparison holds
SPATIAL_DLA_BATCH = 32
SPATIAL_ZOO_BATCH = 64  # ``--only spatial_zoo``'s steps


def phase_spatial_zoo(smi: str, fails: Failures) -> dict:
    """The model families held under spatial partitioning beside ResNet,
    LeNet and GoogLeNet (``--only spatial_zoo``): one registry name a
    family (``tools/spatial_runs.ZOO``) at full width on the gloo pair on
    one card, height cut in two, as phase 45 (1) runs ResNet-18: the fp32
    eval forward against one process's and one step against one
    process's, every rank's eval forward launching K3, K4 and K5 as one
    process's does."""
    from pytorch_cifar_tpu_torch.tools import spatial_runs as SR

    t0 = time.perf_counter()
    specs = [SR.step_spec(name, (1, 2, 1), SPATIAL_ZOO_BATCH, False,
                          reps=2, compute=compute, noise=True,
                          library_pools=name in SR.LIBRARY_POOLS)
             for name, compute in SR.ZOO.items()]
    out = {"card": smi, "steps": _spatial_steps(specs, 2, fails)}
    out["phase_s"] = time.perf_counter() - t0
    _print_steps("spatial_zoo", smi, out["steps"])
    print("spatial_zoo " + json.dumps(out), flush=True)
    return out


def beside(fn, *a, **kw):
    """Start ``fn(*a, **kw)`` on a thread; returns the function that
    waits for it and returns its result or raises its exception."""
    done: dict = {}

    def run():
        try:
            done["out"] = fn(*a, **kw)
        except BaseException as e:  # handed to the waiting thread
            done["err"] = e

    th = threading.Thread(target=run, name=getattr(fn, "__name__", "phase"))
    th.start()

    def wait():
        th.join()
        if "err" in done:
            raise done["err"]
        return done["out"]

    return wait


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Smoke run of the PyTorch/CUDA port on the card")
    parser.add_argument(
        "--only",
        choices=["dp", "mesh", "elastic", "spatial", "spatial_zoo"],
        help="run the device, build and this phase alone, over every "
             "visible card (the four-card call); prints no kernels or ok "
             "line")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs only "
                 "on the card")
    # the port's modules: absent outside a checkout of the repository
    from pytorch_cifar_tpu_torch.ops import _build
    from pytorch_cifar_tpu_torch.ops import bn_stats as M
    from pytorch_cifar_tpu_torch.ops import conv_bn_relu as K
    from pytorch_cifar_tpu_torch.ops import depthwise_stencil as D
    from pytorch_cifar_tpu_torch.ops import dma_gather as G
    from pytorch_cifar_tpu_torch.ops import max_pool as P

    t_start = time.perf_counter()
    smi = phase_device()
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    fails = Failures()
    phase_build(_build)
    if args.only:
        if args.only == "dp":
            phase_dp(G, M, K, smi, fails)
        elif args.only == "mesh":
            phase_mesh(smi, fails, four_card=True)
        elif args.only == "spatial":
            phase_spatial(smi, fails,
                          four_card=torch.cuda.device_count() >= 4)
        elif args.only == "spatial_zoo":
            phase_spatial_zoo(smi, fails)
        else:
            phase_elastic(smi, fails,
                          multi_card=torch.cuda.device_count() > 1)
        print(f"chip_smoke --only {args.only}: "
              f"{time.perf_counter() - t_start:.1f}s, "
              f"{len(fails)} check(s) failed", flush=True)
        return 1 if fails else 0
    phase_s = {}

    def timed(phase, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[phase] = time.perf_counter() - t0
        return out

    rows = timed("site", phase_kernels, K, peaks, fails)
    k3_nan = timed("k3_nan", phase_k3_nan, K, fails)
    sl = timed("slice", phase_slice, K, smi, fails)
    wr = timed("wire", phase_wire, K, smi, fails)
    k1 = timed("gather", phase_gather, G, peaks, fails)
    k2 = timed("moments", phase_moments, M, peaks, fails)
    tr = timed("train", phase_train, G, M, K, P, smi, fails)
    bb = timed("bn_bench", phase_bn_bench, M, fails)
    timed("card_vs_cpu", phase_card_vs_cpu, fails)
    # the zoo slice: GoogLeNet and MobileNet, kernels K4 and K5
    pool = timed("pool", phase_pool, P, peaks, fails)
    sten = timed("stencil", phase_stencil, D, peaks, fails)
    grows = timed("site_googlenet", phase_kernels, K, peaks, fails,
                  sites=fused_sites("GoogLeNet"), tag="site_googlenet",
                  runs=5)
    timed("slice_googlenet", phase_slice, K, smi, fails, model="GoogLeNet",
          requests=64, per_forward=[
              (P, "FWD_LAUNCHES", 9), (K, "LAUNCHES", 28),
              (P, "BWD_LAUNCHES", 0), (D, "LAUNCHES", 0)])
    zs = timed("slice_mobilenet", phase_slice, K, smi, fails,
               model="MobileNet", requests=64,
               per_forward=[(D, "LAUNCHES", 9), (K, "LAUNCHES", 1),
                            (P, "FWD_LAUNCHES", 0)])
    gt = timed("googlenet_train", phase_train, G, M, K, P, smi, fails,
               model="GoogLeNet", train_n=10_240, test_n=2_048,
               k3_per_forward=28, pools_per_forward=9, min_acc=0.0,
               tag="googlenet_train")
    timed("pool_step", phase_pool_step, P, fails)
    dla = timed("simpledla", phase_simpledla, G, M, K, P, D, smi, peaks,
                fails)
    dw = timed("depthwise", phase_depthwise, G, M, K, P, D, smi, peaks,
               fails)
    zr = timed("zoo_rest", phase_zoo_rest, G, M, K, P, D, smi, peaks, fails)
    # the rest of the trainer: the sentinel, remat and the host loader
    mods = {"G": G, "M": M, "K": K, "P": P, "D": D}
    sen = timed("sentinel", phase_sentinel, mods, smi, fails)
    timed("remat", phase_remat, mods, smi, fails)
    hl = timed("host_loader", phase_host_loader, mods, smi, fails,
               sen["epochs"][1]["img_per_sec"])
    timed("ckpt", phase_ckpt, G, K, smi, fails)
    dp = timed("dp", phase_dp, G, M, K, smi, fails)
    # the checkpoint life cycle: hot reload, the canary and the pipeline
    rl = timed("reload", phase_reload, K, smi, fails)
    can = timed("canary", phase_canary, smi, fails)
    # the int8 lane and the zoo server
    i8 = timed("int8", phase_int8, K, smi, fails)
    zo = timed("zoo", phase_zoo, K, P, D, smi, fails)
    # the fleet control plane, through the port's launchers: an elastic
    # fleet, the split deployment's rolling deploy, and a zoo fleet
    fle = timed("fleet", phase_fleet, smi, fails)
    ro = timed("rollout", phase_rollout, smi, fails)
    zf = timed("zoo_fleet", phase_zoo_fleet, smi, fails)
    # the cold-start cache: fresh replica processes without and with it
    cs = timed("cold_start", phase_cold_start, K, smi, fails)
    # the port's drill: the trainer SIGKILLed and resumed, a serving
    # process hot-reloading, SIGKILLed and relaunched
    ch = timed("chaos", phase_chaos, smi, fails)
    # serving over a device group: two ranks of one replica on the card,
    # then two such replicas behind the router, one follower SIGKILLed
    me = timed("mesh", phase_mesh, smi, fails)
    # elastic training (one rank SIGKILLed and resumed by the supervisor,
    # then a two-shard checkpoint resumed and re-cut by one rank) on a
    # thread, beside spatial partitioning (a gloo pair on the card, height
    # cut in two): both train in child processes and hold no time, and
    # side by side they keep the script inside its time limit
    elastic = beside(timed, "elastic", phase_elastic, smi, fails)
    sp = timed("spatial", phase_spatial, smi, fails)
    elastic()
    print("phase_s " + json.dumps(phase_s), flush=True)
    dp_nccl = dp["runs"][0]

    # K3 over one bucket-128 bf16 forward: its 6 launches at their shapes
    # (and GoogLeNet's 28 beside it)
    def forward(site_rows, model=None):
        """One forward's K3 launches at their shapes: ``model``'s counts
        from a row's ``sites_per_forward``, else its own model's."""
        fwd = [r for r in site_rows if r["dtype"] == "bf16"
               and (model is None or model in r["sites_per_forward"])]
        per = [r["launches_per_forward"] if model is None
               else r["sites_per_forward"][model] for r in fwd]

        def total(key):
            return sum(r[key] * n for r, n in zip(fwd, per))

        b_ms, b_by = launches_bound(fwd, per)
        return {
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": total("library_ms"),
            "earlier_design_ms": total("sync_path_ms"),
        }

    k3 = forward(rows)
    kernels = [{
        "name": "conv3x3_bn_relu",
        "route": "cuda",
        "source": "pytorch_cifar_tpu_torch/ops/csrc/conv_bn_relu.cu",
        "replaces": "pytorch_cifar_tpu/ops/conv_bn_relu.py:54",
        "launches": sl["kernel_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + grows
                           + dla["sites"] + zr["sites"]),
        **{k: k3[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")},
        # the mma.sync path, timed at the same sites in this run, is the
        # design the wgmma path replaced
        "redesigned": "wgmma on a cp.async ring; earlier design: the "
                      "mma.sync path",
        "earlier_design_ms": k3["earlier_design_ms"],
        "googlenet_forward": forward(grows),
        "simpledla_forward": forward(dla["sites"]),
        # one launch a forward at the depthwise families' new stems
        "zoo_stems_max_abs_err": max(
            [r["max_abs_err"] for r in dw["sites"]] or [0.0]),
        "zoo_launches": {m: r["launches"]["conv_bn_relu.LAUNCHES"]
                         for m, r in dw["served"].items()},
        # the last families: VGG16's 13 sites (its conv bias folded, 2x2
        # x 512 among them), PreActResNet18's 5, SENet18's 6, at one
        # bucket-128 bf16 forward each, and each served name's launches
        **{f"{m.lower()}_forward": forward(zr["sites"], m)
           for m in ("VGG16", "PreActResNet18", "SENet18")},
        "zoo_rest_launches": {m: r["launches"]["conv_bn_relu.LAUNCHES"]
                              for m, r in zr["served"].items()},
        "vgg16_train_launches": zr["trained"]["VGG16"]["k3_launches"],
        # per rank, in the data-parallel run's 2 epochs (eval forwards)
        "dp_launches_per_rank": [L["conv3x3_bn_relu"] for L in
                                 dp_nccl["launches_per_rank"]],
        # the eval forwards of the sentinel run and of each host-loader run
        "sentinel_launches": sen["launches"]["conv3x3_bn_relu"],
        "host_loader_launches": {
            tag: hl[tag]["launches"]["conv3x3_bn_relu"]
            for tag in ("async_on", "async_off", "host_augment")},
        # serving over the wire (phase 32), 6 a forward: the single
        # requests through both edges, the load runs, and the surviving
        # replica process (its warmup included)
        "wire_forward": {
            "per_forward": 6,
            "single_requests": wr["single"]["k3_launches"],
            "load_runs": wr["load_k3_launches"],
            "replica": wr["fleet"].get("survivor", {}).get("k3_launches"),
        },
        # NaN planted in a pixel, a weight, a scale or a bias entry (phase
        # 33): NaN at exactly the plain version's positions on every path
        "nan_cases": {
            "cases": len(k3_nan),
            "same_nan_positions": all(r["same_nan_positions"]
                                      for r in k3_nan),
            "paths": sorted({r["path"] for r in k3_nan}),
            "relu_of_negative_zero": {
                f"{r['site']} {r['dtype']}": r["relu_of_negative_zero"]
                for r in k3_nan if r["case"] == "negative_zero"},
        },
        # the live engine under load across a hot reload (phase 34), and
        # each engine of the launcher's process in the canary drill and
        # the pipeline run (phase 35), 6 a forward
        "reload_forward": {"per_forward": 6,
                           "launches": rl["k3_launches"],
                           "forwards": rl["forwards"]},
        "canary_forward": {
            "per_forward": 6,
            **{tag: {"launches": (r.get("launches_by_kernel") or {}).get(
                "conv3x3_bn_relu"), "forwards": r.get("forwards")}
               for tag, r in (("drill", can.get("drill", {})),
                              ("pipeline", can.get("pipeline", {})))}},
        # the int8 lane (phase 36): ResNet-18 under load in each dtype, 6
        # a forward, its weights dequantized into the kernel
        "int8_forward": {"per_forward": 6, **{
            d: {"launches": i8[d]["k3_launches"],
                "forwards": i8[d]["forwards"]} for d in DTYPES}},
        # the zoo (phase 37): every tenant's forwards under churn
        "zoo_forward": {"launches": zo["launches_k3_k4_k5"][0],
                        "forwards": zo["forwards"],
                        "per_forward": {m: v["k3"] for m, v in
                                        zo["per_forward"].items()}},
        # the fleet phases (38-40): each drained replica process's own
        # count, 6 a ResNet-18 forward (warmup and batches), and the zoo
        # fleet's survivor (ResNet18, GoogLeNet and MobileNet tenants)
        "fleet_forward": {
            "per_forward": 6,
            "fleet_replicas": {i: r["k3_launches"] for i, r in
                               fle.get("drained", {}).items()},
            "rollout_replicas": {i: r["k3_launches"] for i, r in
                                 ro.get("drained", {}).items()},
            "zoo_fleet_survivor": zf.get("survivor_launches", {}).get("k3")},
        # the cold-start cache (phase 41): each lane's hit process (4
        # probe warm-ups on imported weights, 4 second forwards), and the
        # in-process engines around a tampered entry; the zoo's one-thread
        # pass of re-admissions on the cache (phase 37), and its tenants'
        # forwards on imported weights under load
        "cold_start_forward": {
            "per_forward": 6,
            "hit_process": {lane: cs.get(lane, {}).get("hit_k3_launches")
                            for lane in COLD_LANES},
            "tampered": cs.get("tampered", {}).get("k3_launches"),
            "zoo_hit_path_launches": zo["hit_path_launches_k3_k4_k5"][0],
            "zoo_hit_path_forwards": zo["hit_path_forwards"]},
        # the drill (phase 42): the relaunched serving process of the
        # serve mode, its warm-ups and batches, 6 a forward
        "chaos_serve_relaunch_launches": {
            "per_forward": 6,
            **{k: ch.get("serve", {}).get("relaunch", {}).get(k)
               for k in ("k3_launches", "forwards")}},
        # serving over a device group (phase 43): each rank's own count,
        # 6 a forward, warm-ups and barrier probes included: the fp32
        # pair's ranks and the surviving replica's
        "mesh_rank_launches": {
            "per_forward": 6,
            "pair": me.get("pair", {}).get("ranks"),
            "fleet_replica1": me.get("fleet", {}).get("replica1_ranks")},
        # spatial partitioning (phase 45): each rank's eval forwards in
        # the gloo pair's fit, 6 a forward on its halo-extended slab
        "spatial_launches_per_rank": [
            L["conv3x3_bn_relu"] for L in sp["fit"]["launches_per_rank"]],
    }, {
        "name": "dma_row_gather",
        "route": "cuda",
        "source": "pytorch_cifar_tpu_torch/ops/csrc/dma_gather.cu",
        "replaces": "pytorch_cifar_tpu/ops/dma_gather.py:110",
        "launches": tr["k1_launches"],
        **{k: k1[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "copy_ms")},
        "dp_launches_per_rank": [L["dma_row_gather"] for L in
                                 dp_nccl["launches_per_rank"]],
        # the sentinel phase's run (2 epochs of the cut split)
        "sentinel_launches": sen["launches"]["dma_row_gather"],
        # the spatial fit's ranks (phase 45): each gathers its data
        # shard's whole rows once an epoch
        "spatial_launches_per_rank": [
            L["dma_row_gather"] for L in sp["fit"]["launches_per_rank"]],
        "redesigned": "one row per warp, each lane's loads of a row issued "
                      "before its stores; the design it replaced (a capped "
                      "grid, each load stored at once) and a cp.async.bulk "
                      "ring tried in its place are not in the tree: PERF.md "
                      "section 6 keeps their times",
    }]
    # K2 over one bf16 ResNet-18 forward: its 20 launches at their shapes
    m16 = [r for r in k2 if r["dtype"] == "bf16" and "ms" in r]
    per2 = [r["launches_per_forward"] for r in m16]
    b_ms, b_by = launches_bound(m16, per2)
    kernels.append({
        "name": "fused_moments",
        "route": "cuda",
        "source": "pytorch_cifar_tpu_torch/ops/csrc/bn_stats.cu",
        "replaces": "pytorch_cifar_tpu/ops/bn_stats.py:79",
        "launches": bb["k2_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k2),
        "ms": sum(r["ms"] * k for r, k in zip(m16, per2)),
        "plain_ms": sum(r["plain_ms"] * k for r, k in zip(m16, per2)),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": sum(r["library_ms"] * k for r, k in zip(m16, per2)),
        "redesigned": "one launch: the last block of a channel tile, found "
                      "by an integer ticket, sums the tile's partials in "
                      "chunk order; warp shuffles, 16 loads a thread in "
                      "flight; the design it replaced (a partial pass and a "
                      "finalize launch) is not in the tree: PERF.md section "
                      "6 keeps its time",
        "kernels_per_call": max(r["kernels_per_call"] for r in k2),
        # one hooked b512 bf16 DenseNet121 step: its 120 launches at their
        # shapes (the chunks' moments and each bn2's), beside
        # batch_norm_stats
        "densenet121_step": {
            "launches": zr["moments"]["k2_launches"],
            "max_abs_err_vs_f64": zr["moments"]["max_abs_err_vs_f64"],
            **zr["moments"]["step"], "paths": zr["moments"]["paths"]},
        # per rank, in the data-parallel run's one sync_bn step
        "dp_launches_per_rank": dp_nccl["k2_launches_per_rank"],
    })
    # K4 over one b512 bf16 GoogLeNet train step: its 9 forwards with the
    # winner map and its 9 backwards, at their shapes
    p16 = [r for r in pool if r["dtype"] == "bf16"]
    per4 = [r["pools_per_forward"] for r in p16]

    def pool_total(key):
        return sum(r[key] * k for r, k in zip(p16, per4))

    for kernel, line, launches, err, ms, plain, lib, redesigned in (
        ("max_pool3x3_s1", 343, gt["k4_fwd_launches"], "fwd_max_abs_err",
         "fwd_map_ms", "plain_fwd_map_ms", "library_fwd_ms",
         "the separable max_h(max_w(x)) over a band staged in shared memory "
         "by cp.async; the design it replaced (nine tap loads per output "
         "through L1/L2) is not in the tree: PERF.md section 6 keeps its "
         "time"),
        ("max_pool3x3_s1_bwd", 316, gt["k4_bwd_launches"], "bwd_max_abs_err",
         "bwd_ms", "plain_bwd_ms", "library_bwd_ms",
         "a band of g and the winner map staged in shared memory by "
         "cp.async with a zero / 255 border, each position summing its nine "
         "windows' selected g in tap order from registers sliding down the "
         "band; the design it replaced (nine map and g loads per output "
         "through L1/L2) is not in the tree: PERF.md section 6 keeps its "
         "time"),
    ):
        kernels.append({
            "name": kernel,
            "route": "cuda",
            "source": "pytorch_cifar_tpu_torch/ops/csrc/max_pool.cu",
            "replaces": f"pytorch_cifar_tpu/ops/max_pool.py:{line}",
            "launches": launches,
            "max_abs_err": max(r[err] for r in pool + dw["pool"]),
            "ms": pool_total(ms),
            "plain_ms": pool_total(plain),
            "bound_ms": pool_total("bound_bwd_ms"),
            "bound_by": "bytes",
            "library_ms": pool_total(lib),
        })
        kernels[-1]["redesigned"] = redesigned
        # the spatial GoogLeNet step's ranks (phase 45), on halo-extended
        # slabs
        kernels[-1]["spatial_step_launches_per_rank"] = [
            k4[0 if kernel == "max_pool3x3_s1" else 1]
            for row in sp["steps"] if row["model"] == "GoogLeNet"
            for k4 in row["k4_launches"]]
        # one b512 bf16 PNASNetB step: its 18 pools each way
        pz = [r for r in dw["pool"] if r["dtype"] == "bf16"
              and r["model"] == "PNASNetB"]
        kernels[-1]["pnasnetb_step"] = {
            "launches": dw["trained"]["PNASNetB"][
                "k4_fwd_launches" if kernel == "max_pool3x3_s1"
                else "k4_bwd_launches"],
            **{key: sum(r[src] * r["pools_per_forward"] for r in pz)
               for key, src in (("ms", ms), ("plain_ms", plain),
                                ("library_ms", lib),
                                ("bound_ms", "bound_bwd_ms"))}}
        if kernel == "max_pool3x3_s1":
            kernels[-1]["no_map_ms"] = pool_total("fwd_ms")
            kernels[-1]["no_map_bound_ms"] = pool_total("bound_fwd_ms")
            # the zoo (phase 37): GoogLeNet's tenant forwards, 9 each
            kernels[-1]["zoo_forward"] = {
                "launches": zo["launches_k3_k4_k5"][1],
                "googlenet_forwards": zo["forwards"].get("GoogLeNet"),
                "per_forward": 9,
                # the one-thread pass of re-admissions on the cache
                "hit_path_launches": zo["hit_path_launches_k3_k4_k5"][1]}
            # the zoo fleet's surviving replica process (phase 40)
            kernels[-1]["zoo_fleet_survivor_launches"] = zf.get(
                "survivor_launches", {}).get("k4")
    # K5 over one bucket-128 bf16 MobileNet forward: its 9 launches
    s16 = [r for r in sten if r["dtype"] == "bf16"]
    per5 = [r["sites_per_forward"] for r in s16]

    def sten_total(key):
        return sum(r[key] * k for r, k in zip(s16, per5))

    b_ms, b_by = launches_bound(s16, per5)
    kernels.append({
        "name": "depthwise_stencil",
        "route": "cuda",
        "source": "pytorch_cifar_tpu_torch/ops/csrc/depthwise_stencil.cu",
        "replaces": "pytorch_cifar_tpu/ops/depthwise_stencil.py:58",
        "launches": zs["launches"]["depthwise_stencil.LAUNCHES"],
        "max_abs_err": max(r["max_abs_err"] for r in sten),
        "ms": sten_total("ms"),
        "plain_ms": sten_total("plain_ms"),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": sten_total("library_ms"),
        "redesigned": "shared-memory halo tile; the design it replaced is "
                      "not in the tree: PERF.md section 6 keeps its time",
        "max_abs_err_zoo": max(r["max_abs_err"] for r in dw["stencil"]
                               + zr["stencil"]),
        # one bucket-128 bf16 forward of each depthwise model at its sites
        "zoo_forwards": {**zoo_forwards(dw), **zoo_forwards(
            {"stencil": zr["stencil"], "served": zr["served"]},
            {m: ZOO_REST_SERVED[m] for m in ("ShuffleNetG2",)})},
        # the zoo server (phase 37): MobileNet's tenant forwards, 9 each
        "zoo_server_forward": {
            "launches": zo["launches_k3_k4_k5"][2],
            "mobilenet_forwards": zo["forwards"].get("MobileNet"),
            "per_forward": 9,
            # the one-thread pass of re-admissions on the cache
            "hit_path_launches": zo["hit_path_launches_k3_k4_k5"][2]},
        # the zoo fleet's surviving replica process (phase 40)
        "zoo_fleet_survivor_launches": zf.get("survivor_launches",
                                              {}).get("k5"),
    })
    print(f"card: {smi}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s", flush=True)
    if fails:
        print(f"chip_smoke: {len(fails)} check(s) failed", file=sys.stderr)
        for msg in fails:
            print(f"  {msg}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name,
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
