"""The port's checkpoint reshard against the JAX package's (JAX
``tests/test_checkpoint.py``'s reshard tests, on checkpoints the port
wrote).

- A v3 save re-cut to one shard is the v2 save of the same state byte for
  byte; a v2 save re-cut to two shards reassembles to the v2 payload; a
  same-layout re-cut is a no-op and a missing publish raises; an M-shard
  save restores for any M; ``reshard_to_world`` re-cuts both resume
  candidates (``checkpoint.reshards`` 2) and skips a corrupt one.
- The port's re-cut of a directory leaves every file, sidecars included,
  byte for byte what the JAX package's re-cut of a copy leaves, both
  directions, and so does ``reshard_to_world``; the payload's SHA-256
  never changes.
- The JAX package's restore reads the port's re-cut directory to the
  port state's own tree (``compat``).
"""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch
from flax.serialization import to_state_dict

from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch import faults
from pytorch_cifar_tpu_torch.compat import (
    snapshot_state,
    train_tree_from_state,
)
from pytorch_cifar_tpu_torch.obs import MetricsRegistry
from pytorch_cifar_tpu_torch.train import checkpoint as ckpt
from pytorch_cifar_tpu_torch.train.checkpoint import (
    CKPT_NAME,
    LAST_NAME,
    restore_checkpoint,
    save_checkpoint,
    shard_name,
)
from _torch_ckpt import (
    host_tree,
    jax_state,
    port_state,
    random_port_state,
    trees_equal,
)
from _torch_threads import torch_threads  # noqa: F401


def _bits(state) -> torch.Tensor:
    return snapshot_state(state).host().flat.view(torch.int32).clone()


def _files(d: str) -> dict:
    """Every file of ``d`` by name, as bytes."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _sha(out: str, name: str = CKPT_NAME) -> str:
    return hashlib.sha256(ckpt.read_verified_payload(out, name)).hexdigest()


def test_reshard_v3_to_v2_bit_identical(tmp_path):
    ps = random_port_state("LeNet", seed=1)
    out = str(tmp_path / "v3")
    save_checkpoint(out, ps, 5, 42.0, num_shards=2)
    save_checkpoint(str(tmp_path / "v2"), ps, 5, 42.0)
    ckpt.reshard_checkpoint(out, num_shards=1)
    assert (_files(out)[CKPT_NAME]
            == _files(str(tmp_path / "v2"))[CKPT_NAME])
    meta = json.loads((tmp_path / "v3" / "ckpt.json").read_text())
    assert "shards" not in meta
    assert meta["epoch"] == 5 and meta["best_acc"] == pytest.approx(42.0)
    assert not [f for f in os.listdir(out) if "shard" in f]
    a, b = port_state("LeNet"), port_state("LeNet")
    _, ep_a, _ = restore_checkpoint(out, a)
    _, ep_b, _ = restore_checkpoint(str(tmp_path / "v2"), b)
    assert ep_a == ep_b == 6
    assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(_bits(a), _bits(ps))


def test_reshard_v2_to_v3_bit_identical(tmp_path):
    ps = random_port_state("LeNet", seed=2)
    out = str(tmp_path)
    save_checkpoint(out, ps, 3, 7.0)
    v2 = _files(out)[CKPT_NAME]
    ckpt.reshard_checkpoint(out, num_shards=2)
    assert ckpt.committed_shard_count(out, CKPT_NAME) == 2
    assert not os.path.exists(os.path.join(out, CKPT_NAME))
    assert ckpt.read_verified_payload(out, CKPT_NAME) == v2
    restored = port_state("LeNet")
    _, epoch, best = restore_checkpoint(out, restored)
    assert epoch == 4 and best == pytest.approx(7.0)
    assert torch.equal(_bits(restored), _bits(ps))


@pytest.mark.parametrize("m", [2, 3, 5])
def test_restore_accepts_any_saved_topology(tmp_path, m):
    ps = random_port_state("LeNet", seed=3)
    out = str(tmp_path)
    save_checkpoint(out, ps, 1, 1.0, num_shards=m)
    restored = port_state("LeNet")
    _, epoch, _ = restore_checkpoint(out, restored)
    assert epoch == 2
    assert torch.equal(_bits(restored), _bits(ps))


def test_reshard_noop_and_missing(tmp_path):
    out = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        ckpt.reshard_checkpoint(out, num_shards=2)
    assert ckpt.committed_shard_count(out, CKPT_NAME) is None
    save_checkpoint(out, random_port_state("LeNet", seed=4), 1, 1.0,
                    num_shards=2)
    before = _files(out)
    reg = MetricsRegistry()
    ckpt.reshard_checkpoint(out, num_shards=2, registry=reg)  # same layout
    assert _files(out) == before
    assert reg.counter("checkpoint.reshards").value == 0


def test_reshard_to_world_recuts_both_resume_candidates(tmp_path):
    ps = random_port_state("LeNet", seed=5)
    out = str(tmp_path)
    save_checkpoint(out, ps, 1, 1.0, num_shards=2)
    save_checkpoint(out, ps, 2, 1.0, name=LAST_NAME, num_shards=2)
    reg = MetricsRegistry()
    ckpt.reshard_to_world(out, registry=reg)
    assert ckpt.committed_shard_count(out, CKPT_NAME) == 1
    assert ckpt.committed_shard_count(out, LAST_NAME) == 1
    assert reg.counter("checkpoint.reshards").value == 2.0
    restored = port_state("LeNet")
    _, epoch, _ = restore_checkpoint(
        out, restored, names=ckpt.newest_checkpoint_order(out))
    assert epoch == 3
    assert torch.equal(_bits(restored), _bits(ps))
    # a corrupt candidate is skipped, and left for restore to judge
    save_checkpoint(out, ps, 4, 1.0, name=LAST_NAME, num_shards=2)
    faults.truncate_file(os.path.join(out, shard_name(LAST_NAME, 1, 2)))
    ckpt.reshard_to_world(out)  # must not raise
    assert ckpt.committed_shard_count(out, LAST_NAME) == 2


@pytest.mark.parametrize("model", ["LeNet", "ResNetTiny"])
@pytest.mark.parametrize("cut", [(2, 1), (1, 2), (3, 2), (2, 3)],
                         ids=["v3-2_v2", "v2_v3-2", "v3-3_v3-2", "v3-2_v3-3"])
def test_reshard_leaves_the_jax_reshards_files(tmp_path, model, cut):
    """One port-written publish (with its rolling history), re-cut by the
    port in one copy and by the JAX package in another: the same file
    names, every file the same bytes, the payload's SHA-256 unchanged."""
    src, to = cut
    ps = random_port_state(model, seed=6)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    for epoch in (1, 2):
        save_checkpoint(port_dir, ps, epoch, 10.0 * epoch, keep_last_n=2,
                        num_shards=src if src > 1 else None)
    sha = _sha(port_dir)
    shutil.copytree(port_dir, jax_dir)
    ckpt.reshard_checkpoint(port_dir, CKPT_NAME, to)
    jax_ckpt.reshard_checkpoint(jax_dir, CKPT_NAME, to)
    assert _files(port_dir) == _files(jax_dir)
    assert ckpt.committed_shard_count(port_dir, CKPT_NAME) == to
    assert _sha(port_dir) == sha


def test_reshard_to_world_leaves_the_jax_files(tmp_path):
    """Both resume candidates, one of them corrupt: the port's
    ``reshard_to_world`` and the JAX package's leave the same files."""
    ps = random_port_state("ResNetTiny", seed=7)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    save_checkpoint(port_dir, ps, 3, 30.0, keep_last_n=2, num_shards=2)
    save_checkpoint(port_dir, ps, 4, 30.0, name=LAST_NAME, keep_last_n=2,
                    num_shards=3)
    shutil.copytree(port_dir, jax_dir)
    ckpt.reshard_to_world(port_dir)
    jax_ckpt.reshard_to_world(jax_dir)
    assert _files(port_dir) == _files(jax_dir)
    assert ckpt.committed_shard_count(port_dir, CKPT_NAME) == 1
    assert ckpt.committed_shard_count(port_dir, LAST_NAME) == 1
    # a torn shard of a newer preemption save: both skip it alike
    for d in (port_dir, jax_dir):
        save_checkpoint(d, ps, 5, 30.0, name=LAST_NAME, num_shards=2)
        faults.truncate_file(os.path.join(d, shard_name(LAST_NAME, 0, 2)))
    ckpt.reshard_to_world(port_dir)
    jax_ckpt.reshard_to_world(jax_dir)
    assert _files(port_dir) == _files(jax_dir)
    assert ckpt.committed_shard_count(port_dir, LAST_NAME) == 2


@pytest.mark.parametrize("model", ["LeNet", "ResNetTiny"])
@pytest.mark.parametrize("to", [1, 2])
def test_jax_restores_the_ports_recut_checkpoint(tmp_path, model, to):
    ps = random_port_state(model, seed=8, step=9)
    out = str(tmp_path)
    save_checkpoint(out, ps, 6, 55.0, num_shards=2 if to == 1 else None)
    ckpt.reshard_checkpoint(out, CKPT_NAME, to)
    restored, epoch, best = jax_ckpt.restore_checkpoint(
        out, jax_state(model, seed=9, step=9))
    assert (epoch, best) == (7, 55.0)
    got = to_state_dict(host_tree(restored))
    trees_equal(got, train_tree_from_state(ps))
    assert np.asarray(got["step"]) == 9
