"""Port checkpoints read by the JAX package, and JAX -> port -> JAX.

- A port checkpoint restores through the JAX ``restore_checkpoint`` into a
  JAX ``TrainState``: leaves equal to ``compat.jax_trees_from_state_dict``
  of the port's tensors and momentum buffers, an int32 step and count. The
  same directory is read by the JAX engine's ``load_checkpoint_trees`` and
  passes ``tools/ckpt_inspect.py``'s ``inspect_dir``.
- A JAX checkpoint restored in the port and saved again gives the JAX
  payload's and sidecar's bytes back, and the JAX package reads the params,
  BN stats and momentum back unchanged.

States are drawn from seeds (``tests/_torch_ckpt.py``); every comparison
is exact.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest

from pytorch_cifar_tpu.serve.engine import (
    load_checkpoint_trees as jax_load_checkpoint_trees,
)
from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch.compat import jax_trees_from_state_dict
from pytorch_cifar_tpu_torch.train import checkpoint as ckpt
from _torch_ckpt import (
    jax_state,
    momentum,
    port_state,
    random_port_state,
    trees_equal,
)
from _torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["LeNet", "ResNetTiny", "BottleneckTiny", "GoogLeNet", "MobileNet",
          "SimpleDLA"]


def _ckpt_inspect():
    spec = importlib.util.spec_from_file_location(
        "ckpt_inspect", os.path.join(REPO, "tools", "ckpt_inspect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["LeNet", "ResNetTiny", "GoogLeNet",
                                  "MobileNet", "SimpleDLA"])
def test_port_checkpoint_restores_in_jax(tmp_path, name):
    ps = random_port_state(name, seed=2)
    ckpt.save_checkpoint(str(tmp_path), ps, 2, 40.0)
    restored, start, best = jax_ckpt.restore_checkpoint(
        str(tmp_path), jax_state(name, seed=9, step=0))
    assert (start, best) == (3, 40.0)
    assert restored.step.dtype == np.int32 and int(restored.step) == 5
    count = restored.opt_state[2].count
    assert count.dtype == np.int32 and int(count) == 5
    params, stats = jax_trees_from_state_dict(name, ps.model.state_dict(),
                                              model=ps.model)
    trees_equal(jax.device_get(restored.params), params)
    trees_equal(jax.device_get(restored.batch_stats), stats)
    mom_sd = dict(ps.model.state_dict())
    mom_sd.update(momentum(ps))
    trace, _ = jax_trees_from_state_dict(name, mom_sd, model=ps.model)
    trees_equal(jax.device_get(restored.opt_state[1].trace), trace)
    # the JAX engine and the inspector read the same directory
    jp, jst, meta = jax_load_checkpoint_trees(str(tmp_path), name)
    trees_equal(jax.device_get(jp), params)
    trees_equal(jax.device_get(jst), stats)
    assert meta["epoch"] == 2 and meta["manifest"]["format"] == 2
    report = _ckpt_inspect().inspect_dir(str(tmp_path))
    assert report["ok"] and not report["corrupt"], report


@pytest.mark.parametrize("name", MODELS)
def test_jax_port_jax_round_trip_is_byte_identical(tmp_path, name):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    js = jax_state(name, seed=4, step=11)
    jax_ckpt.save_checkpoint(a, js, 6, 12.5)
    ps = port_state(name)
    ckpt.restore_checkpoint(a, ps)
    ckpt.save_checkpoint(b, ps, 6, 12.5)
    for f in ("ckpt.msgpack", "ckpt.json"):
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f
    back, _, _ = jax_ckpt.restore_checkpoint(b, jax_state(name, seed=5))
    trees_equal(jax.device_get(back.params), jax.device_get(js.params))
    trees_equal(jax.device_get(back.batch_stats),
                 jax.device_get(js.batch_stats))
    trees_equal(jax.device_get(back.opt_state[1].trace),
                 jax.device_get(js.opt_state[1].trace))
