"""The port's trainer with checkpoints, on LeNet in fp32 on the CPU
(counterparts of ``tests/test_faults.py`` and ``tests/test_trainer.py``
for the JAX trainer).

- A run stopped after epoch 0 (``request_stop``, or SIGTERM) and resumed
  equals an uninterrupted run bit for bit: the best checkpoint's payload
  and sidecar, the final tensors, momentum buffers and step. Two
  uninterrupted runs are held equal first, so the comparison never rests
  on noise, and the split's accuracy rises after epoch 0, so the resumed
  run writes the best checkpoint itself.
- ``last.msgpack`` goes when a run completes; ``--resume`` with no
  checkpoint raises; a stale ``last`` is not preferred; ``--evaluate``
  takes the best checkpoint and gives its sidecar's accuracy.
- No writer thread outlives ``fit``, on a normal or a failing exit.
- The train CLI writes, resumes and evaluates, and the serving CLI serves
  what it wrote.
"""

import json
import logging
import os
import signal
import threading

import pytest
import torch

from pytorch_cifar_tpu_torch.config import TrainConfig
from pytorch_cifar_tpu_torch.serve.__main__ import main as serve_main
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from pytorch_cifar_tpu_torch.train.checkpoint import (
    CKPT_NAME,
    LAST_NAME,
    meta_path,
    save_checkpoint,
)
from pytorch_cifar_tpu_torch.train.trainer import Trainer
from _torch_ckpt import momentum
from _torch_threads import torch_threads  # noqa: F401

# 24 steps an epoch; eval accuracy rises at every epoch of the three
SPLIT = dict(model="LeNet", synthetic_data=True, synthetic_train_size=768,
             synthetic_test_size=256, batch_size=32, eval_batch_size=256,
             epochs=3, amp=False, lr=0.1, device="cpu")


def _config(out_dir, **kw):
    return TrainConfig(**{**SPLIT, "output_dir": str(out_dir), **kw})


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def _same_state(a, b):
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    mb = momentum(b)
    for k, buf in momentum(a).items():
        assert torch.equal(buf, mb[k]), k
    assert a.step == b.step


def _writer_threads():
    """The live threads named as checkpoint writers are (the JAX package's
    are named so too, and its trainer tests may leave theirs running in
    the same worker process)."""
    return {t for t in threading.enumerate()
            if t.name == "ckpt-writer" and t.is_alive()}


def _no_writer_thread(before):
    """No writer thread but those alive at ``before`` (the test's start)."""
    return not _writer_threads() - before


def test_stopped_and_resumed_run_equals_an_uninterrupted_one(tmp_path):
    before = _writer_threads()
    runs = []
    for i in range(2):
        t = Trainer(_config(tmp_path / f"full{i}"))
        t.fit()
        runs.append(t)
    full = _files(tmp_path / "full0")
    assert full == _files(tmp_path / "full1")
    _same_state(runs[0].state, runs[1].state)
    accs = [h["eval_acc"] for h in runs[0].history]
    assert accs[2] > accs[1] > accs[0]

    stopped = Trainer(_config(tmp_path / "split"))
    stopped.request_stop()
    stopped.fit()
    assert [h["epoch"] for h in stopped.history] == [0]
    assert {LAST_NAME, CKPT_NAME} <= set(os.listdir(tmp_path / "split"))
    resumed = Trainer(_config(tmp_path / "split", resume=True))
    assert (resumed.start_epoch, resumed.best_acc) == (1, accs[0])
    assert resumed.state.step == stopped.state.step
    resumed.fit()
    assert [h["epoch"] for h in resumed.history] == [1, 2]
    split = _files(tmp_path / "split")
    for f in ("ckpt.msgpack", "ckpt.json"):
        assert split[f] == full[f], f
    assert not [f for f in split if f.startswith("last")]
    _same_state(resumed.state, runs[0].state)
    assert _no_writer_thread(before)


def test_sigterm_stops_after_the_epoch_and_saves_last(tmp_path):
    trainer = Trainer(_config(tmp_path, epochs=2))
    before = signal.getsignal(signal.SIGTERM)
    run_epoch = trainer._run_epoch

    def preempted(epoch):
        os.kill(os.getpid(), signal.SIGTERM)  # the handler only sets a flag
        return run_epoch(epoch)

    trainer._run_epoch = preempted
    trainer.fit()
    assert len(trainer.history) == 1
    assert (tmp_path / LAST_NAME).exists()
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("field,value", [("async_save", "maybe"),
                                         ("publish", "nowhere")])
def test_bad_checkpoint_settings_raise(tmp_path, field, value):
    with pytest.raises(ValueError, match=field):
        Trainer(_config(tmp_path, **{field: value}))


def test_resume_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no usable checkpoint"):
        Trainer(_config(tmp_path, resume=True))


def test_stale_last_is_not_preferred(tmp_path):
    base = Trainer(_config(tmp_path / "a", epochs=1))
    base.fit()
    stale = Trainer(_config(tmp_path / "b", epochs=1, seed=3)).state
    save_checkpoint(str(tmp_path / "a"), stale, 0, 5.0, name=LAST_NAME)
    save_checkpoint(str(tmp_path / "a"), base.state, 2, 40.0)
    resumed = Trainer(_config(tmp_path / "a", resume=True))
    assert (resumed.start_epoch, resumed.best_acc) == (3, 40.0)
    _same_state(resumed.state, base.state)


def test_evaluate_takes_the_best_checkpoint(tmp_path):
    run = Trainer(_config(tmp_path, epochs=2))
    run.request_stop()  # keeps last.msgpack beside the best
    run.fit()
    newer = Trainer(_config(tmp_path / "x", epochs=1, seed=5)).state
    save_checkpoint(str(tmp_path), newer, 7, 99.0, name=LAST_NAME)
    ev = Trainer(_config(tmp_path, evaluate=True))
    with open(meta_path(str(tmp_path), CKPT_NAME)) as f:
        best = json.load(f)["best_acc"]
    assert ev.fit() == best
    _same_state(ev.state, run.state)


def test_no_writer_thread_outlives_a_failing_fit(tmp_path):
    before = _writer_threads()
    trainer = Trainer(_config(tmp_path, epochs=3))
    run_epoch = trainer._run_epoch

    def failing(epoch):
        if epoch == 1:
            raise RuntimeError("device lost (injected)")
        return run_epoch(epoch)

    trainer._run_epoch = failing
    with pytest.raises(RuntimeError, match="device lost"):
        trainer.fit()
    assert _no_writer_thread(before)
    # the epoch-0 best is durable all the same
    assert (tmp_path / CKPT_NAME).exists()


def test_sync_and_async_saves_write_the_same_best(tmp_path):
    """Sync saves write every improvement (no throttle, as in the JAX
    trainer); the best checkpoint they leave is the async run's."""
    for mode in ("on", "off"):
        Trainer(_config(tmp_path / mode, async_save=mode)).fit()
    on, off = _files(tmp_path / "on"), _files(tmp_path / "off")
    for f in ("ckpt.msgpack", "ckpt.json"):
        assert on[f] == off[f], f
    assert "ckpt-e00001.msgpack" in off and "ckpt-e00001.msgpack" not in on


def test_checkpoint_every_throttles_disk_writes(tmp_path):
    Trainer(_config(tmp_path / "t")).fit()  # improves at epochs 0, 1, 2
    Trainer(_config(tmp_path / "e", checkpoint_every=0)).fit()
    assert sorted(f for f in os.listdir(tmp_path / "t")
                  if f.endswith(".msgpack")) == [
        "ckpt-e00000.msgpack", "ckpt-e00002.msgpack", "ckpt.msgpack"]
    assert sorted(f for f in os.listdir(tmp_path / "e")
                  if f.endswith(".msgpack")) == [
        "ckpt-e00001.msgpack", "ckpt-e00002.msgpack", "ckpt.msgpack"]


def test_cli_trains_resumes_and_evaluates(tmp_path, caplog, capsys):
    argv = ["--device", "cpu", "--model", "LeNet", "--synthetic_data",
            "--synthetic_train_size", "256", "--synthetic_test_size", "128",
            "--batch_size", "64", "--no-amp", "--output_dir", str(tmp_path)]
    with caplog.at_level(logging.INFO):
        first = train_main(argv + ["--epochs", "1"])
        assert (tmp_path / CKPT_NAME).exists()
        second = train_main(argv + ["--resume", "--epochs", "2"])
        assert "resumed from" in caplog.text
        assert [h["epoch"] for h in first["history"]] == [0]
        assert [h["epoch"] for h in second["history"]] == [1]
        acc = train_main(argv + ["--evaluate"])["best_acc"]
    assert acc == second["best_acc"]
    assert "test accuracy" in capsys.readouterr().out
    assert serve_main(["--device", "cpu", "--model", "LeNet", "--ckpt",
                       str(tmp_path), "--dtype", "float32", "--buckets", "4",
                       "--clients", "1", "--requests", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ckpt_epoch"] == json.loads(
        (tmp_path / "ckpt.json").read_text())["epoch"]
