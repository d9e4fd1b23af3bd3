"""Sharded (format v3) checkpoints of the port's data-parallel ranks, and
the agreed stop.

- Two gloo ranks restore a checkpoint one process wrote (a resume from 1
  rank to 2), each to the saved state as raw bits, and save it again:
  each rank writes its byte range, rank 0 the commit marker last. The
  files are byte for byte what the JAX package's one-process
  ``save_checkpoint(num_shards=2)`` writes for the same state (shards,
  shard sidecars, marker, history), and so are the port's own one-process
  ``num_shards=2`` files; the unchanged JAX ``read_verified_payload`` and
  ``restore_checkpoint`` read them, and one port process restores them (a
  resume from 2 ranks to 1).
- A SIGTERM to rank 1 alone during epoch 0 of a LeNet run stops both
  ranks after that epoch, with a v3 ``last.msgpack``; the replicas hold
  the same bits, and one process resumes from it at epoch 1 with their
  state.

States are drawn from seeds (``tests/_torch_ckpt.py``); every comparison
is exact.
"""

import json
import os
from pathlib import Path

import jax
import pytest
import torch

from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch.compat import (
    jax_trees_from_state_dict,
    train_tree_from_state,
)
from pytorch_cifar_tpu_torch.config import TrainConfig
from pytorch_cifar_tpu_torch.serialization import to_bytes
from pytorch_cifar_tpu_torch.train import checkpoint as ckpt
from pytorch_cifar_tpu_torch.train.trainer import Trainer
from _torch_ckpt import (
    jax_state,
    momentum,
    port_state,
    random_port_state,
    trees_equal,
)
from _torch_dp import run_job
from _torch_threads import torch_threads  # noqa: F401

EPOCH, BEST = 6, 12.5
SIGTERM_RUN = dict(model="LeNet", synthetic_data=True,
                   synthetic_train_size=256, synthetic_test_size=64,
                   batch_size=32, eval_batch_size=64, epochs=3, amp=False,
                   lr=0.1, device="cpu")


def _files(d):
    return {f: Path(d, f).read_bytes() for f in sorted(os.listdir(d))}


def _raw(t):
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t


def _assert_state(got, state):
    """``got`` (a rank's tensors) equals ``state`` as raw bits."""
    for k, v in state.model.state_dict().items():
        assert torch.equal(_raw(got["sd"][k]), _raw(v)), k
    for k, v in momentum(state).items():
        assert torch.equal(_raw(got["mom"][k]), _raw(v)), k
    assert got["step"] == state.step


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_ckpt")
    src, dst = str(root / "one_rank"), str(root / "two_ranks")
    state = random_port_state("LeNet", seed=3, step=11)
    ckpt.save_checkpoint(src, state, EPOCH, BEST)
    tasks = [
        {"name": "ckpt", "kind": "ckpt", "model": "LeNet", "lr": 0.1,
         "t_max": 4, "spe": 3, "src": src, "dst": dst, "keep_last_n": 1},
        {"name": "sigterm", "kind": "sigterm",
         "config": {**SIGTERM_RUN, "output_dir": str(root / "sigterm")}},
    ]
    ranks = run_job(tasks, str(root / "job"))
    return {"root": root, "src": src, "dst": dst, "state": state,
            "ranks": ranks}


def test_resume_from_one_rank_to_two(job):
    for r, res in enumerate(job["ranks"]):
        got = res["ckpt"]
        assert (got["start"], got["best"]) == (EPOCH + 1, BEST)
        _assert_state(got, job["state"])
        assert (got["path"] is None) == (r == 1)  # rank 0 commits


def test_two_rank_save_is_the_jax_sharded_layout(job, tmp_path):
    """The two ranks' files equal JAX's one-process two-shard save of the
    same state byte for byte, and so do the port's one-process ones."""
    dst = job["dst"]
    meta = json.loads(Path(ckpt.meta_path(dst, ckpt.CKPT_NAME)).read_text())
    assert meta["format"] == 3 and len(meta["shards"]) == 2
    assert not os.path.exists(os.path.join(dst, ckpt.CKPT_NAME))
    js, _, _ = jax_ckpt.restore_checkpoint(
        job["src"], jax_state("LeNet", seed=9, step=0))
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), js, EPOCH, BEST,
                             keep_last_n=1, num_shards=2)
    ckpt.save_checkpoint(str(tmp_path / "port"), job["state"], EPOCH, BEST,
                         keep_last_n=1, num_shards=2)
    want = _files(tmp_path / "jax")
    assert any(".shard00001-of-00002" in f for f in want)
    assert any(f.startswith("ckpt-e00006") for f in want)  # history
    assert _files(dst) == want
    assert _files(tmp_path / "port") == want


def test_jax_reads_the_two_rank_checkpoint(job):
    dst, state = job["dst"], job["state"]
    payload = jax_ckpt.read_verified_payload(dst, ckpt.CKPT_NAME)
    assert payload == to_bytes(train_tree_from_state(state))
    restored, start, best = jax_ckpt.restore_checkpoint(
        dst, jax_state("LeNet", seed=9, step=0))
    assert (start, best, int(restored.step)) == (EPOCH + 1, BEST, 11)
    params, stats = jax_trees_from_state_dict(
        "LeNet", state.model.state_dict(), model=state.model)
    trees_equal(jax.device_get(restored.params), params)
    sd = dict(state.model.state_dict())
    sd.update(momentum(state))
    trace, _ = jax_trees_from_state_dict("LeNet", sd, model=state.model)
    trees_equal(jax.device_get(restored.opt_state[1].trace), trace)


def test_resume_from_two_ranks_to_one(job):
    got = port_state("LeNet")
    _, start, best = ckpt.restore_checkpoint(job["dst"], got)
    assert (start, best) == (EPOCH + 1, BEST)
    res = {"sd": got.model.state_dict(), "mom": momentum(got),
           "step": got.step}
    _assert_state(res, job["state"])


def test_sigterm_to_one_rank_stops_both_after_the_same_epoch(job):
    out = job["root"] / "sigterm"
    a, b = (r["sigterm"] for r in job["ranks"])
    assert a["epochs"] == b["epochs"] == [0]
    assert a["history"][0]["train"] == b["history"][0]["train"]
    assert a["history"][0]["train"]["count"] == 256
    for key in ("sd", "mom"):
        for k in a[key]:
            assert torch.equal(_raw(a[key][k]), _raw(b[key][k])), k
    meta = json.loads(
        Path(ckpt.meta_path(str(out), ckpt.LAST_NAME)).read_text())
    assert meta["format"] == 3 and meta["epoch"] == 0
    assert len(meta["shards"]) == 2
    resumed = Trainer(TrainConfig(**SIGTERM_RUN, output_dir=str(out),
                                  resume=True))
    assert resumed.start_epoch == 1
    res = {"sd": resumed.state.model.state_dict(),
           "mom": momentum(resumed.state), "step": resumed.state.step}
    for key in ("sd", "mom"):
        for k in a[key]:
            assert torch.equal(_raw(res[key][k]), _raw(a[key][k])), k
    assert res["step"] == a["step"] == 8
