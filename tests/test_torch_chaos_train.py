"""The port's drill, trainer modes, end to end on the CPU: the port's train
CLI killed, its preemption save damaged, or one of its steps poisoned,
then resumed and held against an uninterrupted run of the same config.

Each test runs ``python -m pytorch_cifar_tpu_torch.tools.chaos_run
--device cpu`` with ``tests/test_chaos.py``'s flags (LeNet, 3 epochs,
256 / 128 images, batch 64) and asserts what the JAX drill's test asserts
of the same mode, on a record with exactly the JAX drill's keys.

Where the signal lands is not asserted. The JAX trainer's first epoch
compiles, so its signal, sent half a second after the first checkpoint,
lands inside a later epoch; the port compiles nothing, and its 256-image
run usually ends within that half second: the signal then lands after
the run (a SIGTERM in the CLI's teardown, which exits 0; a damaged best
checkpoint, which the resume rewrites from its history copy). So
``sigterm`` and ``corrupt`` with ``truncate`` also run on 4,096 / 512
images (:data:`MID_RUN`), where an epoch takes about a second here and
the signal lands inside a later epoch: the preemption save, its damage
and the fall back past it.
"""

import signal

import pytest

from _torch_chaos import run_chaos

MID_RUN = ("--train-size", "4096", "--test-size", "512")


@pytest.mark.parametrize("sizes", [(), MID_RUN],
                         ids=["test_chaos_sizes", "mid_run"])
def test_sigterm_mid_run_saves_and_resume_matches_reference(tmp_path, sizes):
    rec = run_chaos("sigterm", tmp_path, extra=sizes)
    assert rec["match"] is True
    assert rec["signal"] == int(signal.SIGTERM) and rec["rc"] == 0
    assert rec["finite"] is True
    assert rec["max_abs_diff"] <= rec["tol"] == 1e-6
    assert rec["best_epoch_chaos"] == rec["best_epoch_ref"]
    assert rec["recovery_s"] > 0


def test_sigkill_mid_epoch_resume_matches_reference(tmp_path):
    """JAX ``test_sigkill_mid_epoch_resume_matches_reference``."""
    rec = run_chaos("sigkill", tmp_path)
    assert rec["match"] is True
    assert rec["finite"] is True
    assert rec["max_abs_diff"] <= rec["tol"]
    assert rec["best_acc_chaos"] == pytest.approx(rec["best_acc_ref"])
    assert rec["signal"] == int(signal.SIGKILL)


@pytest.mark.parametrize("corruption, sizes", [
    ("truncate", ()), ("bitflip", ()), ("truncate", MID_RUN)],
    ids=["truncate", "bitflip", "truncate-mid_run"])
def test_damaged_preemption_save_falls_back_and_completes(tmp_path,
                                                         corruption, sizes):
    """JAX ``test_corrupted_preemption_save_falls_back_and_completes``
    (truncate) and ``test_bitflipped_preemption_save_falls_back``."""
    rec = run_chaos("corrupt", tmp_path,
                    extra=("--corruption", corruption, *sizes))
    assert rec["match"] is True
    assert rec["corruption"] == corruption
    assert rec["best_epoch_chaos"] == rec["best_epoch_ref"]
    assert rec["rc"] == 0


def test_nan_injection_under_skip_stays_close_to_reference(tmp_path):
    """JAX ``test_nan_injection_under_skip_stays_close_to_reference``."""
    rec = run_chaos("nan", tmp_path)
    assert rec["match"] is True
    assert rec["finite"] is True
    assert rec["max_abs_diff"] <= rec["tol"] == 0.25
