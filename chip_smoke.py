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

``python3 chip_smoke.py --only dp`` runs phases 1, 2 and 18 alone, over
every visible card (the four-card call), and prints neither the kernels
nor the ok line.

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
"device": ...}`` line — only when every phase passed. Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

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
    import functools

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
GUARD_MODELS = ("ResNet18", "SimpleDLA")
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Smoke run of the PyTorch/CUDA port on the card")
    parser.add_argument(
        "--only", choices=["dp"],
        help="run the device, build and this phase alone (dp: over every "
             "visible card, the four-card call); prints no kernels or ok "
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
    if args.only == "dp":
        phase_dp(G, M, K, smi, fails)
        print(f"chip_smoke --only dp: {time.perf_counter() - t_start:.1f}s, "
              f"{len(fails)} check(s) failed", flush=True)
        return 1 if fails else 0
    phase_s = {}

    def timed(phase, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[phase] = time.perf_counter() - t0
        return out

    rows = timed("site", phase_kernels, K, peaks, fails)
    sl = timed("slice", phase_slice, K, smi, fails)
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
    })
    print(f"card: {smi}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s", flush=True)
    if fails:
        print(f"chip_smoke: {len(fails)} check(s) failed", file=sys.stderr)
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
