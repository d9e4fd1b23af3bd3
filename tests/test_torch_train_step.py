"""The port's train step, epoch program and CLI against the JAX package.

Weights are drawn with numpy, mapped into both frameworks
(``compat.state_dict_from_jax``), and both take the same steps on the same
uint8 batch with augmentation off: parameters, BN running stats and the
metric sums must agree in fp32 (rtol 1e-4, atol 1e-5: the frameworks sum
convolutions in other orders), and a bf16 step's loss within 2%. The epoch
program is held on the host permutation stream, which both sides share
bit for bit.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.data.pipeline import DeviceDataset as JaxDeviceDataset
from pytorch_cifar_tpu.models import create_model as jax_create_model
from pytorch_cifar_tpu.models.resnet import BasicBlock as JaxBasicBlock
from pytorch_cifar_tpu.models.resnet import ResNet as JaxResNet
from pytorch_cifar_tpu.train import optim as jax_optim
from pytorch_cifar_tpu.train import state as jax_state
from pytorch_cifar_tpu.train import steps as jax_steps
from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
from pytorch_cifar_tpu_torch.data.pipeline import DeviceDataset
from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.models.resnet import BasicBlock, ResNet
from pytorch_cifar_tpu_torch.train import optim, steps
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from pytorch_cifar_tpu_torch.train.state import create_train_state
from _torch_threads import torch_threads  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
LR, T_MAX, SPE = 0.1, 4, 3


def _jax_model(name, dtype=None):
    if name == "ResNetTiny":
        return JaxResNet(JaxBasicBlock, (1, 1, 1, 1), dtype=dtype)
    return jax_create_model(name, dtype=dtype)


def _port_model(name):
    if name == "ResNetTiny":
        return ResNet(BasicBlock, (1, 1, 1, 1))
    return create_model(name)


def _random_trees(jmodel, seed):
    """(params, batch_stats) as numpy: fan-in-scaled kernels, non-trivial
    biases, BN affine and running stats."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False
    ))
    rs = np.random.RandomState(seed)

    def param(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rs.uniform(-bound, bound, s.shape).astype(np.float32)
        if leaf == "scale":
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    def stat(path, s):
        if path[-1].key == "var":
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(param, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(
        stat, shapes.get("batch_stats", {})
    )
    return params, stats


class Pair:
    """The same weights as a JAX TrainState and a port TrainState."""

    def __init__(self, name, seed, jdtype=None):
        self.name = name
        jmodel = _jax_model(name, jdtype)
        params, stats = _random_trees(jmodel, seed)
        tx = jax_optim.make_optimizer(lr=LR, t_max=T_MAX, steps_per_epoch=SPE)
        st = jax_state.create_train_state(jmodel, jax.random.PRNGKey(0), tx)
        self.jax = st.replace(
            params=jax.tree_util.tree_map(jnp.asarray, params),
            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
            opt_state=tx.init(jax.tree_util.tree_map(jnp.asarray, params)),
        )
        model = _port_model(name)
        model.load_state_dict({
            k: torch.from_numpy(v) for k, v in
            state_dict_from_jax(name, params, stats, model=model).items()
        })
        model = model.to(memory_format=torch.channels_last)
        self.port = create_train_state(
            model, optim.make_optimizer(model.parameters(), lr=LR),
            optim.cosine_epoch_schedule(LR, T_MAX, SPE), device="cpu",
        )

    def jax_state_dict(self):
        return state_dict_from_jax(
            self.name, jax.device_get(self.jax.params),
            jax.device_get(self.jax.batch_stats), model=_port_model(self.name),
        )

    def assert_close(self):
        want = self.jax_state_dict()
        got = self.port.model.state_dict()
        for k, w in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got[k].detach().numpy(), w,
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def _batch(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    y = rs.randint(0, 10, n).astype(np.int32)
    y[-2:] = -1  # padded rows: masked from loss, gradients and metrics
    return x, y


def _assert_metrics(got, want):
    assert set(got) == set(steps.METRIC_KEYS)
    for k in steps.METRIC_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name,n_steps", [("ResNetTiny", 1), ("LeNet", 2)])
def test_train_steps_match_jax_fp32(name, n_steps):
    """Steps from the same weights and batches (LeNet's second through the
    momentum buffer): params, BN running stats and metrics. The BN model
    takes one step: at batch 8 its 4x4 BNs amplify the frameworks'
    different summation orders in the next step's gradients."""
    pair = Pair(name, seed=0)
    jstep = jax.jit(jax_steps.make_train_step(augment=False))
    pstep = steps.make_train_step(augment=False, device="cpu")
    for i in range(n_steps):
        x, y = _batch(8, seed=10 + i)
        pair.jax, jm = jstep(pair.jax, (jnp.asarray(x), jnp.asarray(y)),
                             jax.random.PRNGKey(1))
        pm = pstep(pair.port, (torch.from_numpy(x), torch.from_numpy(y)))
        _assert_metrics(pm, jax.device_get(jm))
    assert pair.port.step == int(pair.jax.step) == n_steps
    pair.assert_close()


def test_train_step_bf16_loss_within_2_percent():
    """The bf16 policy (bf16 compute, fp32 params/BN stats/loss): one step's
    loss within 2% of the JAX bf16 step's; params stay fp32."""
    pair = Pair("ResNetTiny", seed=1, jdtype=jnp.bfloat16)
    x, y = _batch(8, seed=12)
    _, jm = jax.jit(jax_steps.make_train_step(
        augment=False, compute_dtype=jnp.bfloat16
    ))(pair.jax, (jnp.asarray(x), jnp.asarray(y)), jax.random.PRNGKey(1))
    pstep = steps.make_train_step(augment=False, device="cpu",
                                  compute_dtype=torch.bfloat16)
    pm = pstep(pair.port, (torch.from_numpy(x), torch.from_numpy(y)))
    want = float(jm["loss_sum"])
    assert abs(float(pm["loss_sum"]) - want) <= 0.02 * abs(want)
    assert float(pm["count"]) == float(jm["count"]) == 6
    assert all(p.dtype == torch.float32
               for p in pair.port.model.state_dict().values()
               if p.is_floating_point())


def test_train_step_draws_augmentation_per_step():
    """Without an explicit draw the state draws offsets and flips from its
    generator reseeded with (seed, step): the same step draws the same."""
    state = create_train_state(torch.nn.Linear(1, 1), None, None, seed=3,
                               device="cpu")
    a = state.draw_augment(16)
    assert a[0].shape == (16, 2) and a[1].shape == (16,)
    assert int(a[0].min()) >= 0 and int(a[0].max()) <= 8
    b = state.draw_augment(16)
    state.step += 1
    c = state.draw_augment(16)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_epoch_program_matches_jax_on_host_permutation():
    """LeNet, 20 images at batch 8 (3 steps, the last wrap-padded with 4
    rows labelled -1), 2 epochs on the host permutation: the batch sequence
    and label masks exactly, params and metric totals within tolerance.
    The port gathers through dma_row_gather (its plain version on the
    CPU); the JAX side through jnp.take, the same function."""
    n, batch, steps_per_epoch = 20, 8, 3
    rs = np.random.RandomState(3)
    images = rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.int32)
    pair = Pair("LeNet", seed=2)
    jdata = JaxDeviceDataset(images, labels, batch, seed=5)
    pdata = DeviceDataset(images, labels, batch, seed=5, device="cpu")
    jepoch = jax.jit(jax_steps.make_train_epoch(
        jax_steps.make_train_step(augment=False), global_batch=batch,
        n_data=n, num_steps=steps_per_epoch, dma_gather=False,
    ))
    seen = []
    pstep = steps.make_train_step(augment=False, device="cpu")

    def recording_step(state, b):
        seen.append((b[0].clone(), b[1].clone()))
        return pstep(state, b)

    pepoch = steps.make_train_epoch(
        recording_step, global_batch=batch, n_data=n,
        num_steps=steps_per_epoch, dma_gather=True,
    )
    for epoch in range(2):
        perm = np.asarray(jdata.staged_perm(epoch))
        pair.jax, jt = jepoch(pair.jax, jax_steps.zero_metrics(),
                              jdata.images, jdata.labels,
                              jnp.asarray(perm), jax.random.PRNGKey(0))
        pair.port, pt = pepoch(pair.port, steps.zero_metrics(),
                               pdata.images, pdata.labels,
                               pdata.staged_perm(epoch))
        _assert_metrics(pt, jax.device_get(jt))
        assert float(pt["count"]) == n
        for i, (x, y) in enumerate(seen[-steps_per_epoch:]):
            pos = np.arange(i * batch, (i + 1) * batch)
            idx = perm[pos]
            np.testing.assert_array_equal(x.numpy(), images[idx])
            np.testing.assert_array_equal(
                y.numpy(), np.where(pos < n, labels[idx], -1)
            )
    pair.assert_close()


def test_eval_epoch_matches_jax():
    """Eval over a ragged test split (clamped tail labelled -1), ResNet in
    eval mode (its folded serving forward) vs the JAX eval epoch."""
    pair = Pair("ResNetTiny", seed=4)
    images, labels = _batch(10, seed=13)
    labels[-2:] = 3
    want = jax.jit(jax_steps.make_eval_epoch(
        jax_steps.make_eval_step(), global_batch=4, n_data=10, num_steps=3,
    ))(pair.jax, jnp.asarray(images), jnp.asarray(labels))
    got = steps.make_eval_epoch(
        steps.make_eval_step(device="cpu"), global_batch=4, n_data=10,
        num_steps=3,
    )(pair.port, torch.from_numpy(images), torch.from_numpy(labels))
    _assert_metrics(got, jax.device_get(want))
    assert float(got["count"]) == 10


def test_cli_trains_lenet_on_the_cpu(caplog, tmp_path):
    """``python -m pytorch_cifar_tpu_torch.train --device cpu --model LeNet
    --synthetic_data --epochs 2``, in-process: the JAX trainer's log lines
    and metric keys, a falling loss, every image counted once per epoch."""
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--model", "LeNet", "--synthetic_data",
        "--epochs", "2", "--no-amp", "--synthetic_train_size", "500",
        "--synthetic_test_size", "150", "--batch_size", "64",
        "--eval_batch_size", "128", "--lr", "0.05",
        "--output_dir", str(tmp_path),
    ])
    hist = out["history"]
    assert len(hist) == 2
    for h in hist:
        assert set(h["train"]) == set(h["eval"]) == set(
            jax_steps.zero_metrics()
        )
        assert h["train"]["count"] == 500 and h["eval"]["count"] == 150
        assert h["train"]["nonfinite"] == 0
    assert hist[1]["train_loss"] < hist[0]["train_loss"]
    assert out["best_acc"] == max(h["eval_acc"] for h in hist)
    text = caplog.text
    assert "train epoch 1: loss" in text and "eval  epoch 1: loss" in text
    assert "global batch 64 | 8 steps/epoch" in text


_ZEROS = np.zeros((4, 32, 32, 3), np.uint8), np.zeros(4, np.int32)


@pytest.mark.parametrize("build", [
    lambda: DeviceDataset(*_ZEROS, batch_size=2),
    lambda: create_train_state(torch.nn.Linear(1, 1), None, None),
    lambda: steps.make_train_step(),
    lambda: steps.make_eval_step(),
], ids=["DeviceDataset", "create_train_state", "make_train_step",
        "make_eval_step"])
def test_constructors_default_to_cuda(build):
    """Without a ``device`` each constructor of the slice asks for CUDA;
    with no card it raises instead of staging on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


def test_cli_without_cuda_raises_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device cpu"):
        train_main(["--model", "LeNet", "--synthetic_data", "--epochs", "1"])
