"""The port's drill, checkpoint side, on the CPU: the ``ckpt`` mode end to
end, the drill's yardstick against the JAX drill's, and the inspection
verdicts on the torn v3 directory the ``ckpt`` mode plants.

- ``compare`` (the final params' largest difference and both runs' best
  epoch and accuracy) of the port's drill and of JAX's
  ``tools/chaos_run.py`` (loaded from its path; it reads the payload with
  flax) give the same dict on the same pair of directories: two the
  port's trainer wrote, a JAX-written one beside a port-written one, and
  a pair with a NaN leaf (``inf``, ``finite: false``).
- JAX's ``tools/ckpt_inspect.py`` and the port's give the same exit code
  on one directory: 1 with a newer 4-shard v3 preemption save whose shard
  2 is truncated, and 0 after the port's trainer resumed past it.
- A resume rewrites a damaged ``ckpt.msgpack`` from its history copy
  (``checkpoint.heal_checkpoint``; the JAX trainer leaves it damaged, and
  its drill's ``corrupt`` mode, when the run ended before the signal,
  damages that file and then compares it): the pair's bytes are the
  commit's again and both inspectors say 0.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch import faults
from pytorch_cifar_tpu_torch.config import TrainConfig
from pytorch_cifar_tpu_torch.tools import chaos_run, ckpt_inspect
from pytorch_cifar_tpu_torch.train import checkpoint as port_ckpt
from pytorch_cifar_tpu_torch.train.trainer import Trainer
from _torch_chaos import REPO, run_chaos
from _torch_ckpt import jax_state
from _torch_threads import THREADS, torch_threads  # noqa: F401


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_CHAOS = _jax_tool("chaos_run")
JAX_CKPT_INSPECT = _jax_tool("ckpt_inspect")
SPLIT = dict(model="LeNet", synthetic_data=True, synthetic_train_size=128,
             synthetic_test_size=64, batch_size=32, epochs=2, amp=False,
             device="cpu")


def _train(out_dir, **kw) -> str:
    trainer = Trainer(TrainConfig(**{**SPLIT, "output_dir": str(out_dir),
                                     **kw}))
    try:
        trainer.fit()
    finally:
        trainer.close()
    return str(out_dir)


def _same_yardstick(a, b) -> dict:
    got, want = chaos_run.compare(a, b), JAX_CHAOS.compare(a, b)
    assert got == want
    return got


def test_ckpt_drill_kill_mid_async_save_and_torn_v3(tmp_path):
    """JAX ``test_ckpt_drill_kill_mid_async_save_and_torn_v3``."""
    rec = run_chaos("ckpt", tmp_path)
    assert rec["match"] is True
    assert rec["killed_rc"] == -9
    assert rec["finite"] is True
    assert rec["max_abs_diff"] <= rec["tol"]
    assert rec["inspect_rc_torn"] == 1  # the torn shard was named
    assert rec["torn_v3_rejected"] is True  # fell back, never restored
    assert rec["inspect_rc_after"] == 0  # the dir is clean again
    assert rec["recovery_s"] > 0


def test_yardstick_on_port_trainer_dirs(tmp_path):
    a = _train(tmp_path / "a", seed=0)
    b = _train(tmp_path / "b", seed=1)
    got = _same_yardstick(a, b)
    assert got["finite"] is True and got["max_abs_diff"] > 0
    assert _same_yardstick(a, a)["max_abs_diff"] == 0.0


def test_yardstick_on_a_jax_written_dir(tmp_path):
    jax_dir = str(tmp_path / "jax")
    jax_ckpt.save_checkpoint(jax_dir, jax_state("LeNet", seed=3), epoch=1,
                             best_acc=42.5)
    port_dir = _train(tmp_path / "port")
    for pair in ((jax_dir, port_dir), (port_dir, jax_dir)):
        got = _same_yardstick(*pair)
        assert got["finite"] is True and got["max_abs_diff"] > 0
    assert _same_yardstick(port_dir, jax_dir)["best_acc_chaos"] == 42.5


def test_yardstick_counts_a_nan_leaf_as_infinite(tmp_path):
    ref = _train(tmp_path / "ref")
    bad = shutil.copytree(ref, str(tmp_path / "bad"))
    faults.nan_leaf(bad, ("params", "Conv_0", "Conv_0", "kernel"), index=5)
    got = _same_yardstick(ref, bad)
    assert got["max_abs_diff"] == float("inf")
    assert got["finite"] is False
    # the NaN is on the chaos side only: ``finite`` reads that side
    assert _same_yardstick(bad, ref)["finite"] is True


def _verdicts(d, capsys) -> tuple:
    """(port, JAX) ``ckpt_inspect`` exit codes on ``d``."""
    codes = []
    for tool in (ckpt_inspect, JAX_CKPT_INSPECT):
        codes.append(tool.main([d]))
        capsys.readouterr()
    return tuple(codes)


def _child(cmd):
    r = subprocess.run(
        cmd, capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": str(THREADS)})
    assert r.returncode == 0, r.stderr[-3000:]
    return r


def test_torn_v3_same_inspect_verdict_as_jax(tmp_path, capsys):
    args = chaos_run.parse_args(
        ["--device", "cpu", "--epochs", "2", "--train-size", "128",
         "--test-size", "64", "--batch", "32"])
    d = str(tmp_path / "run")
    _child(chaos_run.train_cmd(args, d))
    assert _verdicts(d, capsys) == (0, 0)
    # the ckpt mode's phase 2: a newer 4-shard v3 preemption save, one
    # shard truncated under an intact commit marker
    _child([sys.executable, "-c", chaos_run.TORN_V3_HELPER, d, "LeNet",
            "cpu"])
    faults.truncate_file(os.path.join(d, "last.shard00002-of-00004.msgpack"))
    assert _verdicts(d, capsys) == (1, 1)
    r = _child(chaos_run.train_cmd(args, d, resume=True))
    assert "is corrupt" in r.stderr and "falling back" in r.stderr
    assert _verdicts(d, capsys) == (0, 0)


def _pair(d) -> tuple:
    return tuple(open(os.path.join(d, n), "rb").read()
                 for n in ("ckpt.msgpack", "ckpt.json"))


@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_resume_rewrites_a_damaged_best_checkpoint(tmp_path, capsys,
                                                   damage):
    d = _train(tmp_path / "run")
    want = _pair(d)
    getattr(faults, f"{damage}_file")(os.path.join(d, "ckpt.msgpack"))
    assert _verdicts(d, capsys) == (1, 1)
    _train(tmp_path / "run", resume=True)  # nothing left to train
    assert _pair(d) == want
    assert _verdicts(d, capsys) == (0, 0)


def test_heal_checkpoint_leaves_intact_and_sharded_pairs_alone(tmp_path):
    d = _train(tmp_path / "run")
    want = _pair(d)
    assert port_ckpt.heal_checkpoint(d) is None
    assert _pair(d) == want
    _child([sys.executable, "-c", chaos_run.TORN_V3_HELPER, d, "LeNet",
            "cpu"])
    faults.truncate_file(os.path.join(d, "last.shard00002-of-00004.msgpack"))
    assert port_ckpt.heal_checkpoint(d, port_ckpt.LAST_NAME) is None
    # every history copy damaged too: nothing to rewrite from
    for name in [port_ckpt.CKPT_NAME] + port_ckpt.history_names(
            d, port_ckpt.CKPT_NAME):
        faults.truncate_file(os.path.join(d, name))
    assert port_ckpt.heal_checkpoint(d) is None
