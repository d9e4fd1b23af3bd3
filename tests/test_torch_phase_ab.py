"""``tools/phase_ab.py``: the phases it names, ``A+B`` pairs, and its
child's script on the CPU.

The tool times ``chip_smoke.py``'s phase functions of several checkouts in
turns on the card. Here: every name it maps is a phase function of this
checkout's ``chip_smoke.py``, a pair ``A+B`` is checked name by name, the
script it hands each child compiles, and without a card every run fails.
"""

import argparse
import ast
import os

import pytest
from _torch_threads import torch_threads  # noqa: F401

from pytorch_cifar_tpu_torch.tools import phase_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke_functions() -> set:
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


def test_every_phase_is_a_phase_function_of_chip_smoke():
    have = _smoke_functions()
    assert {fn for _, fn in phase_ab.PHASES.values()} <= have
    assert "beside" in have
    assert set(phase_ab.KERNEL_PHASES) <= set(phase_ab.PHASES)


@pytest.mark.parametrize("spec", ["chaos", "chaos+cold_start", "site",
                                  "canary+rollout+fleet"])
def test_specs_name_phases(spec):
    assert phase_ab._spec(spec) == spec
    code = phase_ab._CHILD.format(phases=phase_ab.PHASES,
                                  kernel=phase_ab.KERNEL_PHASES,
                                  specs=[spec])
    compile(code, "<phase_ab child>", "exec")


@pytest.mark.parametrize("spec", ["nope", "chaos+", "chaos+drill"])
def test_unknown_phases_are_refused(spec):
    with pytest.raises(argparse.ArgumentTypeError):
        phase_ab._spec(spec)


def test_without_a_card_every_run_fails(capsys):
    assert phase_ab.main(["--phases", "chaos+cold_start", "--turns", "1",
                          REPO]) == 1
    assert "CUDA is not available" in capsys.readouterr().out
