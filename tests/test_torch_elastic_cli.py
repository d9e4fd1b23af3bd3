"""Elastic training of the port over gloo on the CPU, at the JAX tests'
sizes (LeNet, 256 / 128 images, batch 64).

- The world-size reshard through the train CLI (JAX
  ``test_elastic_reshard_follows_world_size``): two ranks train and save a
  two-shard v3 checkpoint; an elastic resume in one process re-cuts it to
  v2, one in two ranks back to two shards; the state and the payload keep
  their SHA-256 throughout.
- Preemption and growth under ``ElasticTrainRunner`` (JAX
  ``test_elastic_training_preemption_and_growth``): rank 1 SIGKILLed
  after the first durable checkpoint, the survivor world of one resumed,
  a host added, the run completed at world 2 with a two-shard layout.
- The rank contract: with its peer SIGKILLed mid-fit the survivor exits
  75 (its collective raised); with its peer frozen by SIGSTOP, which a
  gloo collective waits on as an NCCL one waits on a dead peer, the
  survivor's peer watch ends it with 75 within ``PEER_TIMEOUT_S + 2 *
  HEARTBEAT_S``, whichever rank froze (rank 0 holds the rendezvous
  store). Both inside the supervisor's ``grace_s``.
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from pytorch_cifar_tpu_torch.train import checkpoint as ckpt
from pytorch_cifar_tpu_torch.train import elastic
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from pytorch_cifar_tpu_torch.train.launch import free_port
from _torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRACE_S = 30.0  # ElasticTrainRunner's default grace_s

# the JAX test's run, on the CPU
BASE = ["--device", "cpu", "--model", "LeNet", "--synthetic_data",
        "--synthetic_train_size", "256", "--synthetic_test_size", "128",
        "--batch_size", "64", "--no-amp", "--log_every", "100000",
        "--checkpoint_every", "0", "--async_save", "off"]


@pytest.fixture(autouse=True)
def one_thread_a_rank(monkeypatch):
    """Ranks run torch on one intra-op thread (the environment they
    inherit), and no fault is armed in them."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("PCT_FAULTS", raising=False)


def digest(trainer):
    """A rank hook: the SHA-256 of the rank's whole train state as raw
    bits, and its reshard and restore counts."""
    from pytorch_cifar_tpu_torch.compat import snapshot_state

    snap = snapshot_state(trainer.state).host()
    return {"sha": hashlib.sha256(snap.flat.numpy().tobytes()).hexdigest(),
            "reshards": trainer.obs.counter("checkpoint.reshards").value,
            "restores": trainer.obs.counter("checkpoint.restores").value}


def payload_sha(out: str) -> str:
    return hashlib.sha256(
        ckpt.read_verified_payload(out, ckpt.CKPT_NAME)).hexdigest()


def test_elastic_reshard_follows_world_size(tmp_path):
    out = str(tmp_path / "run")
    args = BASE + ["--epochs", "1", "--output_dir", out]
    # two ranks train one epoch and save a v3 checkpoint (2 shards) of
    # their final state
    two = train_main(args + ["--num_devices", "2"], rank_hook=digest)
    state = two["ranks"][0]["hook"]["sha"]
    assert two["ranks"][1]["hook"]["sha"] == state
    assert ckpt.committed_shard_count(out, ckpt.CKPT_NAME) == 2
    payload = payload_sha(out)

    # 2 -> 1: the elastic resume restores the same bits and re-cuts v2
    one = train_main(args + ["--elastic", "--resume"], rank_hook=digest)
    got = one["ranks"][0]["hook"]
    assert (got["sha"], got["reshards"], got["restores"]) == (state, 1, 1)
    assert ckpt.committed_shard_count(out, ckpt.CKPT_NAME) == 1
    assert "shards" not in ckpt.read_meta(out, ckpt.CKPT_NAME)
    # the live set is gone (the rolling history keeps its own copies)
    assert not [f for f in os.listdir(out) if f.startswith("ckpt.shard")]
    assert payload_sha(out) == payload

    # 1 -> 2: the grown world restores the v2 layout and re-cuts it to
    # one shard per rank (rank 0 rewrites; rank 1 only restores)
    back = train_main(args + ["--elastic", "--resume", "--num_devices", "2"],
                      rank_hook=digest)
    assert [r["hook"]["sha"] for r in back["ranks"]] == [state, state]
    assert [r["hook"]["reshards"] for r in back["ranks"]] == [1, 0]
    meta = ckpt.read_meta(out, ckpt.CKPT_NAME)
    assert len(meta["shards"]) == 2
    assert sum(s["size"] for s in meta["shards"]) == meta["total"]["size"]
    assert not os.path.exists(os.path.join(out, ckpt.CKPT_NAME))
    assert payload_sha(out) == payload


def test_elastic_training_preemption_and_growth(tmp_path):
    out = str(tmp_path / "ckpt")
    # more epochs than the JAX test's 6: an epoch here takes a tenth of a
    # second, and rank 1 must still be training when it is killed
    base = BASE + ["--epochs", "20", "--output_dir", out]
    runner = elastic.ElasticTrainRunner(base, 2, grace_s=GRACE_S,
                                        env=dict(os.environ))
    result: dict = {}
    t = threading.Thread(
        target=lambda: result.update(runner.run(timeout_s=300)))
    t.start()
    try:
        # preemption: rank 1 SIGKILLed once the first checkpoint is durable
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not os.path.exists(
                os.path.join(out, "ckpt.json")):
            time.sleep(0.05)
        assert os.path.exists(os.path.join(out, "ckpt.json"))
        pids = runner.pids()
        if 1 in pids:
            os.kill(pids[1], signal.SIGKILL)
        # growth: once the survivor world (rank 0 alone) is up, a host
        # is granted
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if len(runner.generations) >= 1 and set(runner.pids()) == {0}:
                runner.add_host()
                break
            time.sleep(0.05)
    finally:
        t.join(timeout=300)
    assert not t.is_alive()
    assert result["completed"] is True, result
    events = [g["event"] for g in result["generations"]]
    assert events[0].startswith("preempted:rank1:rc-9"), events
    assert result["generations"][0]["rcs"] == [elastic.ELASTIC_RC, -9]
    assert result["generations"][1]["world"] == 1
    assert any(e.startswith("scale:1->2") for e in events), events
    assert result["final_world"] == 2
    assert result["best_acc"] is not None
    # the grown world re-cut the checkpoint on entry and kept saving one
    # shard per rank
    meta = json.loads((tmp_path / "ckpt" / "ckpt.json").read_text())
    assert len(meta["shards"]) == 2


def _ranks(out: str, epochs: int = 40) -> list:
    """Two elastic ranks of one world started by hand, as the supervisor
    starts them; their stderr goes to files beside the logs."""
    coord = f"127.0.0.1:{free_port()}"
    cmd = [sys.executable, "-m", "pytorch_cifar_tpu_torch.train", *BASE,
           "--epochs", str(epochs), "--output_dir", out, "--distributed",
           "--elastic", "--dist_coord", coord, "--dist_procs", "2"]
    os.makedirs(out, exist_ok=True)
    procs = []
    for r in range(2):
        with open(os.path.join(out, f"stderr{r}.txt"), "w") as err:
            procs.append(subprocess.Popen(
                cmd + ["--dist_rank", str(r)], cwd=REPO,
                stdout=subprocess.DEVNULL, stderr=err))
    return procs


def _log(out: str, rank: int) -> str:
    path = os.path.join(out, "train.log" if rank == 0
                        else f"train.rank{rank}.log")
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("signum,victim,line", [
    (signal.SIGKILL, 1, "elastic rank failed mid-fit"),
    (signal.SIGSTOP, 1, "heartbeat silent"),
    (signal.SIGSTOP, 0, "has not answered"),
], ids=["peer_killed", "peer_frozen", "store_host_frozen"])
def test_a_survivor_exits_75_within_grace(tmp_path, signum, victim, line):
    out = str(tmp_path / "run")
    procs = _ranks(out)
    survivor = procs[1 - victim]
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not os.path.exists(
                os.path.join(out, "ckpt.json")):
            assert all(p.poll() is None for p in procs)
            time.sleep(0.05)
        assert os.path.exists(os.path.join(out, "ckpt.json"))
        t0 = time.monotonic()
        os.kill(procs[victim].pid, signum)
        rc = survivor.wait(timeout=GRACE_S)
        left_s = time.monotonic() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    assert rc == elastic.ELASTIC_RC
    assert line in _log(out, 1 - victim)
    if signum == signal.SIGSTOP:
        # the watch's bound, with slack for a loaded machine
        assert left_s < elastic.PEER_TIMEOUT_S + 2 * elastic.HEARTBEAT_S + 5
