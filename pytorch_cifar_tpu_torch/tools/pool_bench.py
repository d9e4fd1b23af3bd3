"""The 3x3 / stride 1 max-pool kernels against the library's pool, on the
card (counterpart of the JAX package's ``tools/pool_bench.py``):

    python -m pytorch_cifar_tpu_torch.tools.pool_bench            # (512, 32, 32, 480) bf16
    python -m pytorch_cifar_tpu_torch.tools.pool_bench --n 512 --c 128 --dtype float32

Times the training cost of one pool, forward with the winner map plus
backward, for ``ops.max_pool.max_pool3x3_s1`` (the hand-written kernels),
its plain PyTorch version and the library yardstick (``F.max_pool2d`` on
the channels_last view and its autograd backward, which the port never
calls for this pool), with CUDA events; checks the kernels' output and
gradient against the plain version bit for bit at the bench shape; prints
the card's name and power limit and one JSON line with the times and the
byte bound ((2s + 1) * E bytes each way over 3.35 TB/s).
"""

from __future__ import annotations

import argparse
import json

import torch

from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.ops import max_pool as P
from pytorch_cifar_tpu_torch.tools._bench import (
    card_line,
    library_pool,
    time_ms,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n", type=int, default=512)
    parser.add_argument("--h", type=int, default=32)
    parser.add_argument("--c", type=int, default=480)
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
    cot = torch.randn(shape, generator=g).to(device, dtype)

    def plain(v):
        out, idx = P.max_pool3x3_s1_reference(v, True)
        return out, P.max_pool3x3_s1_backward_reference(cot, idx)

    def fwd_bwd(pool):
        xr = x.detach().requires_grad_()
        out = pool(xr)
        (gi,) = torch.autograd.grad(out, xr, cot)
        return out, gi

    out, gi = fwd_bwd(P.max_pool3x3_s1)
    ref_out, ref_gi = plain(x)
    exact = torch.equal(out, ref_out) and torch.equal(gi, ref_gi)
    lib_out, lib_gi = fwd_bwd(library_pool)
    elems = x.numel()
    nbytes = 2 * (2 * x.element_size() + 1) * elems
    rec = {
        "card": card, "shape": list(shape), "dtype": args.dtype,
        "kernel_equals_plain": exact,
        "max_abs_grad_diff_vs_library": float(
            (gi.float() - lib_gi.float()).abs().max()),
        "kernel_fwd_bwd_ms": time_ms(lambda: fwd_bwd(P.max_pool3x3_s1)),
        "plain_fwd_bwd_ms": time_ms(lambda: plain(x)),
        "library_fwd_bwd_ms": time_ms(lambda: fwd_bwd(library_pool)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    print(json.dumps(rec), flush=True)
    return 0 if exact else 1


if __name__ == "__main__":
    raise SystemExit(main())
