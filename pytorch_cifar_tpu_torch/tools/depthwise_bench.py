"""The depthwise stencil kernel against the library's grouped conv, on the
card (counterpart of the JAX package's ``tools/depthwise_bench.py``):

    python -m pytorch_cifar_tpu_torch.tools.depthwise_bench        # (512, 32, 32, 44) k = 7 bf16
    python -m pytorch_cifar_tpu_torch.tools.depthwise_bench --n 128 --c 128 --h 16 --k 3

Times the forward of ``ops.depthwise_stencil.depthwise_stencil`` (the
hand-written kernel), its plain PyTorch version and the library yardstick
(``F.conv2d(groups=C)`` on the channels_last view, which the port's eval
path never calls for a stride-1 depthwise site), with CUDA events; checks
the kernel against the plain version in fp32 on the same inputs; prints the
card's name and power limit and one JSON line with the times and the bound
(the larger of (2s * E + K * K * C * s) bytes over 3.35 TB/s and
2 * K * K * E operations over 67 TFLOP/s).
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.ops import depthwise_stencil as D
from pytorch_cifar_tpu_torch.tools._bench import card_line, time_ms

HBM_BYTES_PER_S, FP32_FLOP_PER_S = 3.35e12, 67e12  # H100 SXM


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n", type=int, default=512)
    parser.add_argument("--h", type=int, default=32)
    parser.add_argument("--c", type=int, default=44)
    parser.add_argument("--k", type=int, default=7, choices=D.KERNEL_SIZES)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    args = parser.parse_args(argv)
    device = resolve_device("cuda")  # a measurement: no card, no run
    card = card_line()
    print(card, flush=True)
    dtype = getattr(torch, args.dtype)
    shape = (args.n, args.h, args.h, args.c)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g).to(device, dtype)
    w = torch.randn(args.k, args.k, args.c, generator=g).to(device, dtype)
    x_cl = x.permute(0, 3, 1, 2)
    w_cl = w.permute(2, 0, 1).unsqueeze(1).contiguous()

    def library():
        return F.conv2d(x_cl, w_cl, padding=args.k // 2, groups=args.c)

    out = D.depthwise_stencil(x, w)
    ref = D.depthwise_stencil_reference(x.float(), w.float())
    err = float((out.float() - ref).abs().max())
    # fp32: summation order only; bf16: half an ulp of the largest output
    tol = 2e-5 * float(ref.abs().max()) + 2e-5 if dtype == torch.float32 \
        else float(ref.abs().max()) / 256
    s = x.element_size()
    t_bytes = (2 * s * x.numel() + w.numel() * s) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * args.k * args.k * x.numel() / FP32_FLOP_PER_S * 1e3
    rec = {
        "card": card, "shape": list(shape), "k": args.k, "dtype": args.dtype,
        "max_abs_err_vs_plain_fp32": err, "tolerance": tol,
        "max_abs_diff_vs_library": float(
            (out.float() - library().permute(0, 2, 3, 1).float()).abs().max()),
        "kernel_ms": time_ms(lambda: D.depthwise_stencil(x, w)),
        "plain_ms": time_ms(lambda: D.depthwise_stencil_reference(x, w)),
        "library_ms": time_ms(library),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    print(json.dumps(rec), flush=True)
    return 0 if err <= tol else 1


if __name__ == "__main__":
    raise SystemExit(main())
