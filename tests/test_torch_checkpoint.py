"""Checkpoints cross between the JAX package and the port, bit for bit.

- A JAX ``save_checkpoint`` (format v2, and v3 with two shards) restores in
  the port: the model's tensors equal ``compat.state_dict_from_jax`` of the
  JAX trees, the momentum buffers the JAX ``trace`` mapped the same way,
  each in its parameter's memory format, and the step the JAX step.
- GoogLeNet's two ``merged_1x1`` modes write and read one tree; a state
  before its first step writes zero momentum; a ``count`` other than the
  step is refused; the sidecar is the JAX one.

The other direction is ``tests/test_torch_checkpoint_roundtrip.py``.

States are drawn from seeds with numpy (``tests/_torch_ckpt.py``); no
epoch is compiled. Every comparison is exact.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch.compat import (
    load_train_tree,
    state_dict_from_jax,
    train_tree_from_state,
)
from pytorch_cifar_tpu_torch.train import checkpoint as ckpt
from _torch_ckpt import (
    jax_state,
    momentum,
    port_state,
    trees_equal,
)
from _torch_threads import torch_threads  # noqa: F401

MODELS = ["LeNet", "ResNetTiny", "BottleneckTiny", "GoogLeNet", "MobileNet",
          "SimpleDLA"]


@pytest.mark.parametrize("shards", [None, 2], ids=["v2", "v3"])
@pytest.mark.parametrize("name", MODELS)
def test_jax_checkpoint_restores_in_the_port(tmp_path, name, shards):
    js = jax_state(name, seed=1, step=7)
    jax_ckpt.save_checkpoint(str(tmp_path), js, 4, 33.0, num_shards=shards)
    ps = port_state(name)
    _, start, best = ckpt.restore_checkpoint(str(tmp_path), ps)
    assert (start, best, ps.step) == (5, 33.0, 7)
    host = jax.device_get((js.params, js.batch_stats, js.opt_state))
    model = ps.model  # the template: only its keys and shapes are read
    want = state_dict_from_jax(name, host[0], host[1], model=model)
    got = ps.model.state_dict()
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the trace has the params' paths: the same mapping gives the buffers
    want_mom = state_dict_from_jax(name, host[2][1].trace, host[1],
                                   model=model)
    params = dict(ps.model.named_parameters())
    for k, buf in momentum(ps).items():
        np.testing.assert_array_equal(buf.numpy(), want_mom[k], err_msg=k)
        assert buf.stride() == params[k].stride(), k


def test_googlenet_merged_modes_write_one_tree():
    merged, stock = port_state("GoogLeNet", merged_1x1=True), port_state(
        "GoogLeNet", merged_1x1=False)
    stock.model.load_state_dict(merged.model.state_dict())
    trees_equal(train_tree_from_state(stock), train_tree_from_state(merged))
    js = jax_state("GoogLeNet", seed=6, merged_1x1=False)
    for state in (merged, stock):
        load_train_tree(state, jax.device_get(
            {"params": js.params, "batch_stats": js.batch_stats,
             "opt_state": {"0": {}, "1": {"trace": js.opt_state[1].trace},
                           "2": {"count": js.opt_state[2].count}},
             "step": js.step}))
    trees_equal(train_tree_from_state(stock), train_tree_from_state(merged))


def test_a_state_before_its_first_step_writes_zero_momentum(tmp_path):
    ps = port_state("LeNet")
    tree = train_tree_from_state(ps)
    assert tree["step"].dtype == np.int32 and tree["step"].shape == ()
    zeros = jax.tree_util.tree_map(np.zeros_like, tree["params"])
    trees_equal(tree["opt_state"]["1"]["trace"], zeros)
    ckpt.save_checkpoint(str(tmp_path), ps, 0, 0.0)
    restored, _, _ = jax_ckpt.restore_checkpoint(str(tmp_path),
                                                 jax_state("LeNet", seed=8))
    assert int(restored.step) == 0


def test_count_other_than_step_is_refused():
    ps = port_state("LeNet")
    tree = train_tree_from_state(ps)
    tree["opt_state"]["2"]["count"] = np.asarray(3, np.int32)
    with pytest.raises(ValueError, match="count"):
        load_train_tree(ps, tree)


def test_sidecar_is_the_jax_one(tmp_path):
    ps = port_state("LeNet")
    ckpt.save_checkpoint(str(tmp_path), ps, 3, 12.5)
    with open(tmp_path / "ckpt.json") as f:
        meta = json.load(f)
    with open(tmp_path / "ckpt.msgpack", "rb") as f:
        payload = f.read()
    assert meta == {"epoch": 3, "best_acc": 12.5,
                    "manifest": jax_ckpt.payload_manifest(payload)}
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
