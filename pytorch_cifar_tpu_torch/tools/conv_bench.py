"""The fused conv3x3+BN+ReLU kernel (K3) per site, on the card:

    python -m pytorch_cifar_tpu_torch.tools.conv_bench                  # ResNet-18 and GoogLeNet, n = 128 bf16
    python -m pytorch_cifar_tpu_torch.tools.conv_bench --model ResNet18
    python -m pytorch_cifar_tpu_torch.tools.conv_bench --ptxas          # registers, spills, shared memory

At every distinct fused site of the chosen models (ResNet-18's five,
GoogLeNet's 24, read off the model's fold) it checks the kernel against its
plain version (bf16: rtol 1.6e-2, atol 1e-2 against the fp32 plain version
on the same bf16 inputs) and for batch invariance (rows 0..k of the n-image
output equal the k-image output, k = 1, 3, 8, 32), then times with CUDA
events: the kernel at its plan, the kernel's mma.sync path at the same
site (the design every site ran before the wgmma path), and cuDNN
(``F.conv2d`` on the channels_last view + affine + ReLU, never called by
the port). Each site's line carries its bound (the larger of its bytes
over 3.35 TB/s and its operations over 989 TFLOP/s) and the achieved
TFLOP/s; a last line sums each model's bucket-n forward over its launches.
``--ptxas`` compiles each kernel source once more with ``-Xptxas -v`` and
prints what ptxas reports. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import tempfile

import torch
import torch.nn.functional as F

from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.ops import _build
from pytorch_cifar_tpu_torch.ops import conv_bn_relu as K
from pytorch_cifar_tpu_torch.tools._bench import (
    RESNET18_SITES,
    card_line,
    fused_sites,
    time_ms,
)

HBM_BYTES_PER_S, BF16_FLOP_PER_S = 3.35e12, 989e12  # H100 SXM
INVARIANCE_NS = (1, 3, 8, 32)


def ptxas_report() -> list:
    """What ``nvcc -Xptxas -v`` says of each kernel source: its
    registers, spills and shared memory per kernel, one line each."""
    lines = []
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        for name in _build.ENTRY_POINTS:
            proc = subprocess.run(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                 "-o", f"{tmp}/{name}.so", str(_build.source_path(name))],
                capture_output=True, text=True,
            )
            lines += [f"{name}: {ln.strip()}"
                      for ln in (proc.stdout + proc.stderr).splitlines()
                      if "ptxas" in ln and "bytes stack frame" not in ln]
            if proc.returncode:
                lines.append(f"{name}: nvcc rc {proc.returncode}")
    return lines


def site_row(name, h, w, cin, cout, per_fwd, n, runs, g) -> dict:
    dev = "cuda"
    x = torch.randn(n, h, w, cin, generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn(3, 3, cin, cout, generator=g) / (9 * cin) ** 0.5).to(
        dev, torch.bfloat16)
    scale = (torch.rand(cout, generator=g) + 0.5).to(dev)
    bias = (0.1 * torch.randn(cout, generator=g)).to(dev)
    p = K.plan(h, w, cin, cout)
    out = K.conv3x3_bn_relu(x, wt, scale, bias)
    ref = K.conv3x3_bn_relu_reference(x.float(), wt.float(), scale, bias)
    diff = (out.float() - ref).abs()
    ok = bool((diff <= 1e-2 + 1.6e-2 * ref.abs()).all()) \
        and bool(torch.isfinite(out).all())
    invariant = all(
        torch.equal(out[:k], K.conv3x3_bn_relu(x[:k].contiguous(), wt, scale,
                                               bias))
        for k in INVARIANCE_NS if k < n)
    sync = dataclasses.replace(p, path="sync")
    x_cl = x.permute(0, 3, 1, 2)
    w_cl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    s4 = scale.to(torch.bfloat16).view(1, -1, 1, 1)
    b4 = bias.to(torch.bfloat16).view(1, -1, 1, 1)
    flops = 2 * n * h * w * cin * cout * 9
    nbytes = (x.numel() + wt.numel() + out.numel()) * 2 + 2 * cout * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    ms = time_ms(lambda: K.conv3x3_bn_relu(x, wt, scale, bias), runs)
    row = {
        "site": name, "n": n, "x": [h, w, cin], "cout": cout,
        "launches_per_forward": per_fwd, "plan": dataclasses.asdict(p),
        "max_abs_err": diff.max().item(), "within_tolerance": ok,
        "batch_invariant": invariant,
        "ms": ms,
        "sync_path_ms": time_ms(
            lambda: K.launch(x, wt, scale, bias, sync), runs),
        "library_ms": time_ms(
            lambda: torch.relu(F.conv2d(x_cl, w_cl, padding=1) * s4 + b4),
            runs),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "tflops": flops / ms / 1e9,
    }
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", nargs="+", default=["ResNet18", "GoogLeNet"],
                        choices=["ResNet18", "GoogLeNet", "SimpleDLA"])
    parser.add_argument("--n", type=int, default=128)
    parser.add_argument("--runs", type=int, default=15)
    parser.add_argument("--ptxas", action="store_true")
    args = parser.parse_args(argv)
    resolve_device("cuda")  # a measurement: no card, no run
    card = card_line()
    print(card, flush=True)
    if args.ptxas:
        for line in ptxas_report():
            print("ptxas " + line, flush=True)
    g = torch.Generator().manual_seed(0)
    ok = True
    for model in args.model:
        sites = RESNET18_SITES if model == "ResNet18" else fused_sites(model)
        rows = []
        for site in sites:
            try:
                row = site_row(*site, args.n, args.runs, g)
            except RuntimeError as exc:  # a refused launch: report, go on
                print(f"conv_site_failed {site}: {exc}", flush=True)
                ok = False
                continue
            row["model"] = model
            ok &= row["within_tolerance"] and row["batch_invariant"]
            rows.append(row)
            print("conv_site " + json.dumps(row), flush=True)

        def total(key):
            return sum(r[key] * r["launches_per_forward"] for r in rows)

        flops = sum(2 * args.n * r["x"][0] * r["x"][1] * r["x"][2] * r["cout"]
                    * 9 * r["launches_per_forward"] for r in rows)
        print("conv_forward " + json.dumps({
            "card": card, "model": model, "n": args.n, "dtype": "bf16",
            "launches": sum(r["launches_per_forward"] for r in rows),
            **{k: total(k) for k in ("ms", "sync_path_ms", "library_ms")},
            "bound_ms_sum_of_sites": total("bound_ms"),
            "tflops": flops / total("ms") / 1e9,
        }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
