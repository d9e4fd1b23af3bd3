"""Kernel phases of ``chip_smoke.py`` from several checkouts, in turns, on
one card:

    python -m pytorch_cifar_tpu_torch.tools.phase_ab --phases pool moments \\
        --turns 2 DIR_A DIR_B

Each directory is a checkout of the repository (a ``git archive`` of
another commit, unpacked). Every turn runs, for each directory in the
order given, one fresh process there that builds that checkout's kernels
and runs the named phases of that checkout's own ``chip_smoke.py``
(``pool``: K4; ``moments``: K2; ``gather``: K1; ``stencil``: K5;
``site``: K3 at ResNet-18's sites), so two
designs are timed on one card in turns (A B, then B A on the next turn).
Each output line is prefixed with its directory and turn. Exits non-zero
when no card is there or a phase's checks failed in any run.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# phase -> (the ops module it takes, chip_smoke's function)
PHASES = {"pool": ("max_pool", "phase_pool"),
          "moments": ("bn_stats", "phase_moments"),
          "gather": ("dma_gather", "phase_gather"),
          "stencil": ("depthwise_stencil", "phase_stencil"),
          "site": ("conv_bn_relu", "phase_kernels")}

_CHILD = """
import importlib, sys, torch
import chip_smoke as s
from pytorch_cifar_tpu_torch.ops import _build
if not torch.cuda.is_available():
    sys.exit("phase_ab: CUDA is not available")
_build.build_all()
peaks = s.peaks_for(torch.cuda.get_device_name(0))
fails = s.Failures()
for mod, fn in {phases!r}:
    getattr(s, fn)(importlib.import_module(
        "pytorch_cifar_tpu_torch.ops." + mod), peaks, fails)
sys.exit(1 if fails else 0)
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--phases", nargs="+", required=True,
                        choices=sorted(PHASES))
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("dirs", nargs="+")
    args = parser.parse_args(argv)
    code = _CHILD.format(phases=[PHASES[p] for p in args.phases])
    failed = 0
    for turn in range(args.turns):
        order = args.dirs if turn % 2 == 0 else args.dirs[::-1]
        for d in order:
            proc = subprocess.run(
                [sys.executable, "-c", code], cwd=d, capture_output=True,
                text=True, env={**os.environ, "PYTHONPATH": os.path.abspath(d)},
            )
            for line in (proc.stdout + proc.stderr).splitlines():
                print(f"[{d} turn {turn}] {line}", flush=True)
            failed += proc.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
