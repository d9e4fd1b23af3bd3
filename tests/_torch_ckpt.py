"""Train states of both packages for the port's checkpoint tests.

A JAX state is built without compiling anything: ``jax.eval_shape`` gives
the model's tree, numpy draws its leaves from a seed (params, BN stats and
the momentum ``trace`` alike), and the step and the schedule's ``count``
are set to the same value. A port state is the port model in
channels_last on the CPU with its SGD optimizer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pytorch_cifar_tpu.models import create_model as jax_create_model
from pytorch_cifar_tpu.models.resnet import BasicBlock as JaxBasicBlock
from pytorch_cifar_tpu.models.resnet import Bottleneck as JaxBottleneck
from pytorch_cifar_tpu.models.resnet import ResNet as JaxResNet
from pytorch_cifar_tpu.train import optim as jax_optim
from pytorch_cifar_tpu.train.state import TrainState as JaxTrainState
from pytorch_cifar_tpu_torch.models import MODEL_REGISTRY, create_model
from pytorch_cifar_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
)
from pytorch_cifar_tpu_torch.train import optim
from pytorch_cifar_tpu_torch.train.state import create_train_state

# the small depths the port's tests use, beside registered names
TINY = {
    "ResNetTiny": ((JaxBasicBlock, BasicBlock), (1, 1, 1, 1)),
    "BottleneckTiny": ((JaxBottleneck, Bottleneck), (1, 1, 1, 1)),
}


def jax_model(name, **kw):
    if name in TINY:
        (block, _), depth = TINY[name]
        return JaxResNet(block, depth, **kw)
    return jax_create_model(name, **kw)


def port_model(name, **kw):
    if name in TINY:
        (_, block), depth = TINY[name]
        return ResNet(block, depth)
    if kw:  # GoogLeNet's merged_1x1; the registry takes no options
        return MODEL_REGISTRY[name](**kw)
    return create_model(name)


def _draw(rs, path, s):
    leaf = path[-1].key
    if leaf == "kernel":
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return rs.uniform(-bound, bound, s.shape).astype(np.float32)
    if leaf in ("scale", "var"):
        return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
    return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)


@functools.lru_cache(maxsize=2)
def jax_state(name, seed=0, step=7, **kw):
    """A JAX TrainState of ``name`` with every leaf drawn from ``seed``
    (immutable: the last two built are kept for the next caller)."""
    model = jax_model(name, **kw)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: _draw(rs, p, s), shapes["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, s: _draw(rs, p, s), shapes.get("batch_stats", {}))
    tx = jax_optim.make_optimizer()
    # the chain's state types from an empty tree: tx.init(params) would
    # dispatch one zeros_like per leaf shape
    decay, tr, sched = tx.init({})
    trace = jax.tree_util.tree_map(
        lambda a: (0.01 * rs.standard_normal(a.shape)).astype(np.float32),
        params)
    count = jnp.asarray(step, jnp.int32)
    return JaxTrainState(
        step=count, params=params, batch_stats=stats,
        opt_state=(decay, tr._replace(trace=trace),
                   sched._replace(count=count)),
        apply_fn=model.apply, tx=tx,
    )


def port_state(name, seed=0, **kw):
    """A port train state of ``name`` on the CPU, channels_last, no step
    taken (no momentum buffers yet)."""
    model = port_model(name, **kw)
    model = model.to(memory_format=torch.channels_last)
    return create_train_state(
        model, optim.make_optimizer(model.parameters()),
        optim.cosine_epoch_schedule(0.1, 4, 3), seed=seed, device="cpu",
    )


def random_port_state(name, seed, step=5):
    """A port state with params, BN stats and momentum buffers drawn from
    ``seed`` (each buffer in its parameter's memory format)."""
    ps = port_state(name)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in ps.model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
            ps.optimizer.state[p]["momentum_buffer"] = torch.empty_like(
                p).copy_(torch.randn(p.shape, generator=g))
        for k, b in ps.model.state_dict().items():
            if k.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
            elif k.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g))
    ps.step = step
    return ps


def host_tree(state):
    """A JAX state's payload tree, as ``save_checkpoint`` hands it to
    flax (before ``to_state_dict``)."""
    return jax.device_get({"params": state.params,
                           "batch_stats": state.batch_stats,
                           "opt_state": state.opt_state,
                           "step": state.step})


def momentum(state):
    params = dict(state.model.named_parameters())
    return {k: state.optimizer.state[p]["momentum_buffer"]
            for k, p in params.items()}


def trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            trees_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)
