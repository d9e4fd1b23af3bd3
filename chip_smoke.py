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

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
"device": ...}`` line — only when every phase passed. Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

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


def time_ms(fn, runs: int = 25, reps: int = 5) -> float:
    """Median over ``runs`` of the per-call device time of ``reps``
    back-to-back calls, timed with CUDA events. A sleep kernel queued first
    keeps the stream busy while the host enqueues, so the events bracket
    device work, not launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
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


def phase_kernels(K, peaks, fails: Failures):
    """Per-site rows: correctness at n = 3 and 128 in both dtypes, batch
    invariance, and times at n = 128."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    rows = []
    for site, h, w, cin, cout, per_fwd in SITES:
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
                "ms": time_ms(lambda: K.conv3x3_bn_relu(x, wt, scale, bias)),
                "plain_ms": time_ms(
                    lambda: K.conv3x3_bn_relu_reference(x, wt, scale, bias)
                ),
                "library_ms": time_ms(
                    lambda: torch.relu(F.conv2d(x_cl, w_cl, padding=1) * s4
                                       + b4)
                ),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            }
            rows.append(row)
            print("site " + json.dumps(row), flush=True)
    return rows


def phase_slice(K, smi: str, fails: Failures) -> dict:
    from pytorch_cifar_tpu_torch.obs import MetricsRegistry
    from pytorch_cifar_tpu_torch.serve import (
        InferenceEngine,
        MicroBatcher,
        run_load,
    )

    registry = MetricsRegistry()
    K.LAUNCHES = 0  # the main path starts here
    t0 = time.perf_counter()
    engine = InferenceEngine.from_random(
        "ResNet18", seed=0, buckets=BUCKETS, compute_dtype=torch.bfloat16,
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
            batcher, clients=8, requests_per_client=256, images_max=8,
            seed=0,
        )
    finally:
        batcher.close()
    launches, forwards = K.LAUNCHES, engine.forward_count  # main path ends
    fails.check(
        launches == 6 * forwards,
        f"slice: {launches} kernel launches for {forwards} forwards "
        f"(want 6 per forward)",
    )
    fails.check(forwards > len(BUCKETS), "slice: no request reached the engine")
    fails.check(engine.compile_count == len(BUCKETS),
                f"slice: compile_count {engine.compile_count}")
    fails.check(report["failed"] == 0, f"slice: {report['failed']} failed")
    fails.check(report["requests"] == 8 * 256,
                f"slice: {report['requests']} of {8 * 256} requests answered")

    # the served logits against the same weights on the CPU (plain path)
    xs = rs.randint(0, 256, size=(5, 32, 32, 3)).astype(np.uint8)
    cpu = InferenceEngine.from_random(
        "ResNet18", seed=0, buckets=(8,), compute_dtype=torch.float32,
        device="cpu",
    )
    want = cpu.predict(xs)
    got16 = engine.predict(xs)
    got32 = InferenceEngine.from_random(
        "ResNet18", seed=0, buckets=(8,), compute_dtype=torch.float32,
    ).predict(xs)
    err16 = float(np.max(np.abs(got16 - want)))
    err32 = float(np.max(np.abs(got32 - want)))
    top = float(np.max(np.abs(want)))
    fails.check(
        got16.shape == (5, 10) and bool(np.isfinite(got16).all()),
        "slice: bf16 logits not finite (5, 10)",
    )
    fails.check(err16 <= 0.02 * top,
                f"slice: bf16 logits off the CPU by {err16:.3g} "
                f"(max |logit| {top:.3g})")
    fails.check(
        bool(np.allclose(got32, want, rtol=1e-3, atol=1e-4)),
        f"slice: fp32 logits off the CPU by {err32:.3g}",
    )
    out = {
        "card": smi,
        "model": "ResNet18", "dtype": "bf16", "buckets": list(BUCKETS),
        "engine_build_and_warmup_s": build_s,
        "forwards": forwards, "kernel_launches": launches,
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


def phase_train(G, M, K3, smi: str, fails: Failures) -> dict:
    """The training slice through ``Trainer.fit``; K1 once per epoch. Then
    one more epoch dispatched with host syncs made errors."""
    from pytorch_cifar_tpu_torch.config import TrainConfig
    from pytorch_cifar_tpu_torch.train.trainer import Trainer

    epochs = 2
    cfg = TrainConfig(
        model="ResNet18", batch_size=BATCH, amp=True, synthetic_data=True,
        synthetic_train_size=TRAIN_N, synthetic_test_size=TEST_N,
        epochs=epochs, cosine_t_max=2, dma_gather=True, device="cuda",
    )
    t0 = time.perf_counter()
    trainer = Trainer(cfg)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    G.LAUNCHES = M.LAUNCHES = K3.LAUNCHES = 0  # the main path starts here
    best = trainer.fit()
    k1, k2, k3 = G.LAUNCHES, M.LAUNCHES, K3.LAUNCHES  # and ends here
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    eval_forwards = epochs * -(-TEST_N // cfg.eval_batch_size)
    fails.check(k1 == epochs, f"train: K1 launched {k1} times in {epochs} "
                              "epochs")
    fails.check(k2 == 0, f"train: K2 launched {k2} times with the hook off")
    fails.check(k3 == 6 * eval_forwards,
                f"train: K3 launched {k3} times for {eval_forwards} eval "
                "forwards (want 6 each)")
    for h in hist:
        fails.check(h["train"]["count"] == TRAIN_N,
                    f"train: epoch {h['epoch']} counted "
                    f"{h['train']['count']} images")
        fails.check(h["eval"]["count"] == TEST_N,
                    f"train: eval {h['epoch']} counted {h['eval']['count']}")
        fails.check(np.isfinite(h["train_loss"]) and
                    np.isfinite(h["eval_loss"]),
                    f"train: epoch {h['epoch']} loss not finite")
    fails.check(len(hist) == epochs and
                hist[1]["train_loss"] < hist[0]["train_loss"],
                "train: the second epoch's loss is not below the first's")
    fails.check(hist[-1]["eval_acc"] > 50.0,
                f"train: final eval accuracy {hist[-1]['eval_acc']:.2f}%")
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
    fails.check(synced is None, f"train: the epoch synced with the host: "
                                f"{synced}")
    if synced is None:
        fails.check(float(totals["count"]) == TRAIN_N,
                    "train: the sync-checked epoch counted "
                    f"{float(totals['count'])} images")
    out = {
        "card": smi, "model": "ResNet18", "batch": BATCH, "dtype": "bf16",
        "train_n": TRAIN_N, "test_n": TEST_N,
        "steps_per_epoch": trainer.steps_per_epoch,
        "setup_s": setup_s, "best_acc": best,
        "k1_launches": k1, "k2_launches": k2, "k3_launches": k3,
        "peak_mem_gib": peak / 2**30, "epoch_sync_error": synced,
        "epochs": [{k: h[k] for k in ("epoch", "train_loss", "train_acc",
                                      "eval_loss", "eval_acc", "epoch_s",
                                      "img_per_sec")} for h in hist],
    }
    print("train " + json.dumps(out), flush=True)
    return out


def _train_state(seed: int, dtype: torch.dtype):
    """A seeded ResNet-18 train state on the card and its step computing
    in ``dtype`` (augmentation on in bf16, the bench's setting; off
    otherwise)."""
    from pytorch_cifar_tpu_torch.models import create_model
    from pytorch_cifar_tpu_torch.train.optim import (
        cosine_epoch_schedule, make_optimizer)
    from pytorch_cifar_tpu_torch.train.state import create_train_state
    from pytorch_cifar_tpu_torch.train.steps import make_train_step

    model = create_model(
        "ResNet18", generator=torch.Generator().manual_seed(seed)
    ).to("cuda", memory_format=torch.channels_last)
    state = create_train_state(
        model, make_optimizer(model.parameters()),
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
    from pytorch_cifar_tpu_torch.ops import dma_gather as G

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
    tr = phase_train(G, M, K, smi, fails)
    bb = phase_bn_bench(M, fails)
    phase_card_vs_cpu(fails)

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
