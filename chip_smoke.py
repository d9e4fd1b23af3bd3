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
   version in fp32 on the same bf16-rounded inputs); rows 0..2 of the
   n = 128 output must equal the n = 3 output bit for bit; CUDA-event
   times of the kernel, the plain version and the library yardstick
   (``F.conv2d`` in channels_last + affine + ReLU, never called by the
   port), beside the least time the card could take (``bound``);
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
   252 bytes and on a uint8 base 1 byte off alignment (the byte path);
   times of the kernel, the plain version and ``index_select``, and the
   bound;
6. moments: ``fused_moments`` (K2) at ResNet-18's four BN shapes at
   n = 512 in bf16 and fp32: values against the plain version in float64
   (rtol 1e-4, atol 1e-5), two launches bit-identical, the gradient
   through its ``autograd.Function`` against autograd of the plain version
   (atol 1e-6); times of the kernel, the plain version and
   ``torch.batch_norm_stats``, and the bound;
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
    map; output and gradient equal to ``F.max_pool2d``'s; times of the
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
    step (see :func:`phase_pool_step`).

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
"device": ...}`` line — only when every phase passed. Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# the port's bench helpers: absent outside a checkout of the repository
from pytorch_cifar_tpu_torch.tools._bench import (
    card_line,
    library_pool,
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

# ResNet-18's fused conv3x3+BN+ReLU sites: (name, h, w, cin, cout, launches
# per forward)
SITES = [
    ("stem", 32, 32, 3, 64, 1),
    ("layer1.{0,1}.conv1", 32, 32, 64, 64, 2),
    ("layer2.1.conv1", 16, 16, 128, 128, 1),
    ("layer3.1.conv1", 8, 8, 256, 256, 1),
    ("layer4.1.conv1", 4, 4, 512, 512, 1),
]
BUCKETS = (1, 8, 32, 128)
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
    invariance, and times at n = 128. ``sites`` defaults to ResNet-18's."""
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
            inv = torch.equal(outs[128][:3], outs[3])
            fails.check(inv, f"{site} {dname}: rows 0..2 of n=128 differ "
                             "from the n=3 output")

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
                "ms": time_ms(lambda: K.conv3x3_bn_relu(x, wt, scale, bias),
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
            rows.append(row)
            print(f"{tag} " + json.dumps(row), flush=True)
    return rows


def googlenet_sites() -> list:
    """GoogLeNet's fused conv3x3+BN+ReLU sites, one row per distinct
    (h, w, cin, cout) with the number of launches per forward, read off the
    model's own fold."""
    from pytorch_cifar_tpu_torch.models import create_model

    folded = create_model("GoogLeNet").fold(torch.float32)
    count: dict = {}
    h = 32
    for key, site in [("stem", folded["stem"])] + [
        (None, c) for c in folded["cells"]
    ]:
        if site is None:  # a stage transition halves the map
            h //= 2
            continue
        fused = [site] if key else site["b2"] + site["b3"]
        for f in fused:
            assert f.fused
            shape = (h, h, f.weight.shape[2], f.weight.shape[3])
            count[shape] = count.get(shape, 0) + 1
    return [(f"{hh}x{ww}x{cin}->{cout}", hh, ww, cin, cout, k)
            for (hh, ww, cin, cout), k in count.items()]


def phase_slice(K, smi: str, fails: Failures, model: str = "ResNet18",
                per_forward=None, requests: int = 256) -> dict:
    """Serve ``model`` at full width under ``run_load``. ``per_forward``
    lists (kernel module, its launch counter's name, launches per
    forward); every counter is reset just before the main path and read
    just after."""
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
        model, seed=0, buckets=BUCKETS, compute_dtype=torch.bfloat16,
        registry=registry,
    )
    build_s = time.perf_counter() - t0
    rs = np.random.RandomState(0)
    n_off = BUCKETS[1] - 1  # off-bucket: the padded path really pads
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
    fails.check(forwards > len(BUCKETS),
                f"slice {model}: no request reached the engine")
    fails.check(engine.compile_count == len(BUCKETS),
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
        "model": model, "dtype": "bf16", "buckets": list(BUCKETS),
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
    # byte path: 252-byte float32 rows, and a base 1 byte off alignment
    rows = torch.randn(1000, 7, 9, generator=g).cuda()
    ridx = torch.randint(0, 1000, (3000,), generator=g,
                         dtype=torch.int32).cuda()
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
    row = {
        "images": [TRAIN_N, 32, 32, 3], "idx": EPOCH_ROWS, "exact": ok,
        "max_abs_err": err,
        "ms": time_ms(lambda: G.dma_row_gather(images, idx)),
        "plain_ms": time_ms(lambda: G.dma_row_gather_reference(images, idx)),
        "library_ms": time_ms(lambda: torch.index_select(images, 0, idx)),
        "bound_ms": b_ms, "bound_by": b_by, "mbytes": nbytes / 1e6,
    }
    print("gather " + json.dumps(row), flush=True)
    return row


def phase_moments(M, peaks, fails: Failures) -> list:
    """K2 at ResNet-18's four BN shapes at n = 512, bf16 and fp32: values
    vs float64, determinism, the gradient, and times."""
    g = torch.Generator().manual_seed(2)
    rows = []
    for h, w, c, per_fwd in BN_SHAPES:
        for dname, dt in DTYPES.items():
            x = (torch.randn(BATCH, h, w, c, generator=g) + 0.5).to("cuda", dt)
            m1, s1 = M.fused_moments(x)
            m2, s2 = M.fused_moments(x)
            torch.cuda.synchronize()
            rm, rs = M.fused_moments_reference(x.double())
            err = 0.0
            for got, ref in ((m1, rm), (s1, rs)):
                diff = (got.double() - ref).abs()
                err = max(err, diff.max().item())
                fails.check(bool((diff <= 1e-5 + 1e-4 * ref.abs()).all()),
                            f"K2 {dname} {(BATCH, h, w, c)}: off the float64 "
                            f"moments by {diff.max().item():.3g}")
            det = torch.equal(m1, m2) and torch.equal(s1, s2)
            fails.check(det, f"K2 {dname} {(BATCH, h, w, c)}: two launches "
                             "differ")
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
            fails.check(gerr <= 1e-6, f"K2 {dname} {(BATCH, h, w, c)}: "
                                      f"gradient off by {gerr:.3g}")
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
    return rows


# GoogLeNet's 3x3 / stride 1 pool inputs at batch 512: (h, w, c, pools per
# forward), and a shape that takes the narrow-vector path
POOL_SHAPES = [(32, 32, 192, 1), (32, 32, 256, 1), (16, 16, 480, 1),
               (16, 16, 512, 3), (16, 16, 528, 1), (8, 8, 832, 2)]
POOL_ODD = (3, 5, 5, 130)
# MobileNet's stride-1 depthwise inputs at bucket 128: (n, h, w, c, k, sites
# per forward), then PNASNet's 5x5 / 7x7 shape and a narrow-vector shape
STENCIL_SHAPES = [(128, 32, 32, 32, 3, 1), (128, 16, 16, 128, 3, 1),
                  (128, 8, 8, 256, 3, 1), (128, 4, 4, 512, 3, 5),
                  (128, 2, 2, 1024, 3, 1), (512, 32, 32, 44, 5, 0),
                  (512, 32, 32, 44, 7, 0), (2, 8, 8, 130, 3, 0),
                  (2, 8, 8, 130, 7, 0)]


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


def _pool_checks(P, x, g, what: str, fails: Failures) -> tuple:
    """Kernel against plain version, bit for bit: the forward without and
    with the winner map, the map itself, and the gradient of ``g``. Returns
    the measured largest differences of the forward and of the backward."""
    ref, ridx = P.max_pool3x3_s1_reference(x, True)
    out = P.max_pool3x3_s1(x)  # no gradient asked for: no map
    out_m, idx = P._forward(x, True)
    gi = P._backward(g, idx)
    torch.cuda.synchronize()
    fails.check(same_bits(out, ref) and same_bits(out_m, ref),
                f"K4 {what}: forward differs from the plain version")
    fails.check(torch.equal(idx, ridx),
                f"K4 {what}: winner map differs from the plain version")
    gref = P.max_pool3x3_s1_backward_reference(g, ridx)
    fails.check(same_bits(gi, gref),
                f"K4 {what}: backward differs from the plain version")
    xr = x.detach().requires_grad_()
    (ga,) = torch.autograd.grad(P.max_pool3x3_s1(xr), xr, g)
    fails.check(same_bits(ga, gi),
                f"K4 {what}: autograd's gradient differs from the kernel's")
    return (max(max_abs_diff(out, ref), max_abs_diff(out_m, ref)),
            max(max_abs_diff(gi, gref), max_abs_diff(ga, gref)))


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
        for h, w, c, per_fwd in POOL_SHAPES:
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
            print("pool " + json.dumps(row), flush=True)
            del x, cot, xr, lib, glib, idx, gi
    return rows


def phase_stencil(D, peaks, fails: Failures) -> list:
    """K5 against its plain version at MobileNet's five stride-1 depthwise
    shapes (n = 128, k = 3), PNASNet's (k = 5, 7) and a narrow-vector
    shape, bf16 and fp32. fp32: rtol/atol 2e-5 (the fp32 sums' order);
    bf16: against the fp32 plain version on the same bf16-rounded inputs,
    rtol 2^-7 (one bf16 ulp: half for the rounding, the rest for a
    rounding flipped by the sums' order), atol 1e-4."""
    g = torch.Generator().manual_seed(6)
    rows = []
    for n, h, w, c, k, per_fwd in STENCIL_SHAPES:
        for dname, dt in DTYPES.items():
            x = torch.randn(n, h, w, c, generator=g).to("cuda", dt)
            wt = (torch.randn(k, k, c, generator=g) / k).to("cuda", dt)
            out = D.depthwise_stencil(x, wt)
            torch.cuda.synchronize()
            ref = D.depthwise_stencil_reference(x.float(), wt.float())
            diff = (out.float() - ref).abs()
            rtol, atol = (2e-5, 2e-5) if dname == "fp32" else (2.0 ** -7, 1e-4)
            what = f"K5 {dname} {(n, h, w, c)} k={k}"
            fails.check(bool((diff <= atol + rtol * ref.abs()).all()),
                        f"{what}: off the plain version by "
                        f"{diff.max().item():.3g}")
            fails.check(bool(torch.isfinite(out).all()),
                        f"{what}: non-finite output")
            x_cl = x.permute(0, 3, 1, 2)
            w_cl = wt.permute(2, 0, 1).unsqueeze(1).contiguous()
            s = x.element_size()
            b_ms, b_by = bound(2 * s * x.numel() + wt.numel() * s,
                               2 * k * k * x.numel(), peaks, "fp32")
            row = {
                "x": [n, h, w, c], "k": k, "dtype": dname,
                "sites_per_forward": per_fwd,
                "max_abs_err": diff.max().item(),
                "ms": time_ms(lambda: D.depthwise_stencil(x, wt), 9, 3),
                "plain_ms": time_ms(
                    lambda: D.depthwise_stencil_reference(x, wt), 3, 2),
                "library_ms": time_ms(
                    lambda: F.conv2d(x_cl, w_cl, padding=k // 2, groups=c),
                    9, 3),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            rows.append(row)
            print("stencil " + json.dumps(row), flush=True)
    return rows


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


def phase_train(G, M, K3, P, smi: str, fails: Failures, model="ResNet18",
                train_n=TRAIN_N, test_n=TEST_N, k3_per_forward=6,
                pools_per_forward=0, min_acc=50.0, tag="train") -> dict:
    """A training slice through ``Trainer.fit``: K1 once per epoch, K3 in
    every eval forward, K4 (``pools_per_forward`` pool branches) forward
    and backward in every train step and forward in every eval forward.
    Then one more epoch dispatched with host syncs made errors."""
    from pytorch_cifar_tpu_torch.config import TrainConfig
    from pytorch_cifar_tpu_torch.train.trainer import Trainer

    epochs = 2
    cfg = TrainConfig(
        model=model, batch_size=BATCH, amp=True, synthetic_data=True,
        synthetic_train_size=train_n, synthetic_test_size=test_n,
        epochs=epochs, cosine_t_max=2, dma_gather=True, device="cuda",
    )
    t0 = time.perf_counter()
    trainer = Trainer(cfg)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path starts here
    G.LAUNCHES = M.LAUNCHES = K3.LAUNCHES = 0
    P.FWD_LAUNCHES = P.BWD_LAUNCHES = 0
    best = trainer.fit()
    k1, k2, k3 = G.LAUNCHES, M.LAUNCHES, K3.LAUNCHES  # and ends here
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
        "k4_fwd_launches": k4f, "k4_bwd_launches": k4b,
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
    from pytorch_cifar_tpu_torch.train.steps import METRIC_KEYS, make_train_step

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


def main() -> int:
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
    rows = phase_kernels(K, peaks, fails)
    sl = phase_slice(K, smi, fails)
    k1 = phase_gather(G, peaks, fails)
    k2 = phase_moments(M, peaks, fails)
    tr = phase_train(G, M, K, P, smi, fails)
    bb = phase_bn_bench(M, fails)
    phase_card_vs_cpu(fails)
    # the zoo slice: GoogLeNet and MobileNet, kernels K4 and K5
    pool = phase_pool(P, peaks, fails)
    sten = phase_stencil(D, peaks, fails)
    phase_kernels(K, peaks, fails, sites=googlenet_sites(),
                  tag="site_googlenet", runs=5)
    phase_slice(K, smi, fails, model="GoogLeNet", requests=64, per_forward=[
        (P, "FWD_LAUNCHES", 9), (K, "LAUNCHES", 28), (P, "BWD_LAUNCHES", 0),
        (D, "LAUNCHES", 0)])
    zs = phase_slice(K, smi, fails, model="MobileNet", requests=64,
                     per_forward=[(D, "LAUNCHES", 9), (K, "LAUNCHES", 1),
                                  (P, "FWD_LAUNCHES", 0)])
    gt = phase_train(G, M, K, P, smi, fails, model="GoogLeNet",
                     train_n=10_240, test_n=2_048, k3_per_forward=28,
                     pools_per_forward=9, min_acc=0.0, tag="googlenet_train")
    phase_pool_step(P, fails)

    # K3 over one bucket-128 bf16 forward: its 6 launches at their shapes
    fwd = [r for r in rows if r["dtype"] == "bf16"]
    per = [r["launches_per_forward"] for r in fwd]

    def total(key):
        return sum(r[key] * k for r, k in zip(fwd, per))

    t_bytes = sum(r["mbytes"] * 1e6 * k for r, k in zip(fwd, per)) \
        / peaks["bytes"] * 1e3
    t_ops = sum(r["gflop"] * 1e9 * k for r, k in zip(fwd, per)) \
        / peaks["bf16"] * 1e3
    kernels = [{
        "name": "conv3x3_bn_relu",
        "route": "cuda",
        "source": "pytorch_cifar_tpu_torch/ops/csrc/conv_bn_relu.cu",
        "replaces": "pytorch_cifar_tpu/ops/conv_bn_relu.py:54",
        "launches": sl["kernel_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": total("library_ms"),
    }, {
        "name": "dma_row_gather",
        "route": "cuda",
        "source": "pytorch_cifar_tpu_torch/ops/csrc/dma_gather.cu",
        "replaces": "pytorch_cifar_tpu/ops/dma_gather.py:110",
        "launches": tr["k1_launches"],
        **{k: k1[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")},
    }]
    # K2 over one bf16 ResNet-18 forward: its 20 launches at their shapes
    m16 = [r for r in k2 if r["dtype"] == "bf16"]
    per2 = [r["launches_per_forward"] for r in m16]
    b_ms, b_by = bound(sum(r["mbytes"] * 1e6 * k for r, k in zip(m16, per2)),
                       sum(3 * np.prod(r["x"]) * k for r, k in zip(m16, per2)),
                       peaks, "fp32")
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
    })
    # K4 over one b512 bf16 GoogLeNet train step: its 9 forwards with the
    # winner map and its 9 backwards, at their shapes
    p16 = [r for r in pool if r["dtype"] == "bf16"]
    per4 = [r["pools_per_forward"] for r in p16]

    def pool_total(key):
        return sum(r[key] * k for r, k in zip(p16, per4))

    for kernel, line, launches, err, ms, plain, lib in (
        ("max_pool3x3_s1", 343, gt["k4_fwd_launches"], "fwd_max_abs_err",
         "fwd_map_ms", "plain_fwd_map_ms", "library_fwd_ms"),
        ("max_pool3x3_s1_bwd", 316, gt["k4_bwd_launches"], "bwd_max_abs_err",
         "bwd_ms", "plain_bwd_ms", "library_bwd_ms"),
    ):
        kernels.append({
            "name": kernel,
            "route": "cuda",
            "source": "pytorch_cifar_tpu_torch/ops/csrc/max_pool.cu",
            "replaces": f"pytorch_cifar_tpu/ops/max_pool.py:{line}",
            "launches": launches,
            "max_abs_err": max(r[err] for r in pool),
            "ms": pool_total(ms),
            "plain_ms": pool_total(plain),
            "bound_ms": pool_total("bound_bwd_ms"),
            "bound_by": "bytes",
            "library_ms": pool_total(lib),
        })
    # K5 over one bucket-128 bf16 MobileNet forward: its 9 launches
    s16 = [r for r in sten if r["dtype"] == "bf16"]
    per5 = [r["sites_per_forward"] for r in s16]

    def sten_total(key):
        return sum(r[key] * k for r, k in zip(s16, per5))

    by = {r["bound_by"] for r, k in zip(s16, per5) if k}
    kernels.append({
        "name": "depthwise_stencil",
        "route": "cuda",
        "source": "pytorch_cifar_tpu_torch/ops/csrc/depthwise_stencil.cu",
        "replaces": "pytorch_cifar_tpu/ops/depthwise_stencil.py:58",
        "launches": zs["launches"]["depthwise_stencil.LAUNCHES"],
        "max_abs_err": max(r["max_abs_err"] for r in sten),
        "ms": sten_total("ms"),
        "plain_ms": sten_total("plain_ms"),
        "bound_ms": sten_total("bound_ms"),
        "bound_by": "bytes" if by == {"bytes"} else "operations",
        "library_ms": sten_total("library_ms"),
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
