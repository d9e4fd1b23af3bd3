"""Phases of ``chip_smoke.py`` from several checkouts, in turns, on one
card:

    python -m pytorch_cifar_tpu_torch.tools.phase_ab --phases pool moments \\
        --turns 2 DIR_A DIR_B
    python -m pytorch_cifar_tpu_torch.tools.phase_ab \\
        --phases chaos zoo_fleet cold_start canary --turns 1 DIR_PARENT
    python -m pytorch_cifar_tpu_torch.tools.phase_ab \\
        --phases chaos+zoo_fleet+cold_start canary --turns 1 DIR_CHANGE

Each directory is a checkout of the repository (a ``git archive`` of
another commit, unpacked). Every turn runs, for each directory in the
order given, one fresh process there that builds that checkout's kernels
and runs the named phases of that checkout's own ``chip_smoke.py``: the
kernel phases (``pool``: K4; ``moments``: K2; ``gather``: K1;
``stencil``: K5; ``site``: K3 at ResNet-18's sites) and the fleet and
drill phases (``chaos``, ``zoo_fleet``, ``cold_start``, ``canary``,
``rollout``, ``fleet``), so two designs are timed on one card in turns
(A B, then B A on the next turn). ``A+B+C`` runs phase A on a thread
beside B and then C, as the script's default run does (``beside``), and
times them together. Each
output line is prefixed with its directory and turn; each phase's
seconds are one line, ``phase_ab PHASE SECONDS``, and a group's together
one more, ``phase_ab A+B+C SECONDS``. Exits non-zero when no
card is there or a phase's checks failed in any run.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# phase -> (the ops module it takes, or None, chip_smoke's function); a
# kernel phase takes (ops module, peaks, fails), the others (smi, fails),
# after the ops module where they take one
PHASES = {"pool": ("max_pool", "phase_pool"),
          "moments": ("bn_stats", "phase_moments"),
          "gather": ("dma_gather", "phase_gather"),
          "stencil": ("depthwise_stencil", "phase_stencil"),
          "site": ("conv_bn_relu", "phase_kernels"),
          "chaos": (None, "phase_chaos"),
          "zoo_fleet": (None, "phase_zoo_fleet"),
          "cold_start": ("conv_bn_relu", "phase_cold_start"),
          "canary": (None, "phase_canary"),
          "rollout": (None, "phase_rollout"),
          "fleet": (None, "phase_fleet")}
KERNEL_PHASES = ("pool", "moments", "gather", "stencil", "site")

_CHILD = """
import importlib, sys, time, torch
import chip_smoke as s
from pytorch_cifar_tpu_torch.ops import _build
if not torch.cuda.is_available():
    sys.exit("phase_ab: CUDA is not available")
_build.build_all()
smi = s.phase_device()
peaks = s.peaks_for(torch.cuda.get_device_name(0))
fails = s.Failures()

def run(name):
    mod, fn = {phases!r}[name]
    a = [importlib.import_module("pytorch_cifar_tpu_torch.ops." + mod)] \\
        if mod else []
    a += [peaks] if name in {kernel!r} else [smi]
    t0 = time.perf_counter()
    getattr(s, fn)(*a, fails)
    print(f"phase_ab {{name}} {{time.perf_counter() - t0:.2f}}", flush=True)

for spec in {specs!r}:
    t0 = time.perf_counter()
    first, *rest = spec.split("+")
    wait = s.beside(run, first) if rest else None
    for name in rest or [first]:
        run(name)
    if wait:
        wait()
    if rest:
        print(f"phase_ab {{spec}} {{time.perf_counter() - t0:.2f}}",
              flush=True)
print(f"phase_ab failed checks {{len(fails)}}", flush=True)
sys.exit(1 if fails else 0)
"""


def _spec(text: str) -> str:
    for name in text.split("+"):
        if name not in PHASES:
            raise argparse.ArgumentTypeError(
                f"{name!r} is not one of {sorted(PHASES)}")
    return text


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--phases", nargs="+", required=True, type=_spec,
                        help=f"each of {sorted(PHASES)}, or A+B")
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("dirs", nargs="+")
    args = parser.parse_args(argv)
    code = _CHILD.format(phases=PHASES, kernel=KERNEL_PHASES,
                         specs=args.phases)
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
