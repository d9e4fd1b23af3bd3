"""The train CLI's data-parallel launch on the CPU, and what it refuses.

- ``--device cpu --num_devices 2 --model LeNet --synthetic_data`` starts
  two gloo ranks in one launch and trains one epoch: both ranks count
  every image once, report the same global metrics and end with the same
  state as raw bits; the checkpoint is format v3 and each rank has its
  log file.
- A SIGTERM to the launch (once both ranks train) reaches every rank:
  both stop after the same epoch with a v3 ``last.msgpack``, and the
  launch exits 0.
- A rank that fails fails the launch, though the other rank succeeds.
- ``--num_devices 2`` without CUDA and without ``--device cpu`` raises,
  so does ``--num_devices 2`` beside ``--distributed``, and a rendezvous
  that no peer joins raises once its timeout is up: nothing trains alone.
"""

import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pytorch_cifar_tpu_torch.config import parse_config
from pytorch_cifar_tpu_torch.parallel import mesh
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from pytorch_cifar_tpu_torch.train.launch import local_ranks
from _torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
@pytest.fixture(autouse=True)
def one_thread_a_rank(monkeypatch):
    """Spawned ranks run torch on one intra-op thread (the environment
    they inherit), as the test files run theirs on two."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


ARGS = ["--device", "cpu", "--num_devices", "2", "--model", "LeNet",
        "--synthetic_data", "--synthetic_train_size", "256",
        "--synthetic_test_size", "64", "--batch_size", "32", "--no-amp"]


def replica_bits(trainer):
    """A rank hook: the rank's whole train state as raw bits."""
    from pytorch_cifar_tpu_torch.compat import snapshot_state

    return snapshot_state(trainer.state).flat.view(torch.int32).clone()


def fail_on_rank_1(trainer):
    """A rank hook that fails on rank 1 only."""
    if trainer.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return trainer.rank


def test_cli_trains_lenet_on_two_gloo_ranks(tmp_path):
    out = train_main(ARGS + ["--epochs", "1", "--output_dir", str(tmp_path)],
                     rank_hook=replica_bits)
    a, b = out["ranks"]
    assert [(r["rank"], r["world"], r["backend"]) for r in out["ranks"]] == [
        (0, 2, "gloo"), (1, 2, "gloo")]
    assert a["history"][0]["train"] == b["history"][0]["train"]
    assert a["history"][0]["train"]["count"] == 256
    assert a["history"][0]["eval"]["count"] == 64
    assert torch.equal(a["hook"], b["hook"])
    assert set(a["launches_by_kernel"].values()) == {0}  # the CPU
    meta = json.loads((tmp_path / "ckpt.json").read_text())
    assert meta["format"] == 3 and len(meta["shards"]) == 2
    assert {"train.log", "train.rank1.log"} <= set(os.listdir(tmp_path))
    assert "train epoch 0" in Path(tmp_path, "train.log").read_text()


def test_sigterm_to_the_launch_stops_every_rank_after_the_epoch(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_cifar_tpu_torch.train", *ARGS,
         "--epochs", "20", "--output_dir", str(tmp_path)],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ))
    try:
        for line in proc.stderr:  # rank 0's console
            # epoch 0 ran on both ranks, so both handle SIGTERM by now
            if line.startswith("train epoch 0"):
                proc.send_signal(signal.SIGTERM)
                break
        proc.stderr.read()
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    epochs = [Path(tmp_path, log).read_text().count("train epoch")
              for log in ("train.log", "train.rank1.log")]
    assert epochs[0] == epochs[1] and 1 <= epochs[0] < 20, epochs
    meta = json.loads((tmp_path / "last.json").read_text())
    assert meta["format"] == 3 and meta["epoch"] == epochs[0] - 1


def test_a_failing_rank_fails_the_launch(tmp_path):
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails on purpose"):
        train_main(ARGS + ["--epochs", "0", "--output_dir", str(tmp_path)],
                   rank_hook=fail_on_rank_1)


def test_num_devices_without_cuda_or_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("the card is there: --num_devices 2 would train on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--num_devices", "2", "--model", "LeNet",
                    "--synthetic_data"])


def test_num_devices_beside_distributed_raises():
    with pytest.raises(ValueError, match="one rank"):
        local_ranks(parse_config(["--device", "cpu", "--num_devices", "2",
                                  "--distributed"]))


def test_a_rendezvous_no_peer_joins_raises():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with pytest.raises(torch.distributed.DistError):
        mesh.initialize_distributed(f"localhost:{port}", 2, 0, device="cpu",
                                    timeout_s=1)
    assert not mesh.is_distributed() and mesh.world_size() == 1
