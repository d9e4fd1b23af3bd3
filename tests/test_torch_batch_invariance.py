"""A served row's bits do not depend on the micro-batch it joins (CPU).

The serving forwards' dense layer is ``models.common.folded_dense``: an
elementwise product and a sum over the input axis in a fixed order, so a
row's reduction does not change with the rows beside it or the thread
count, where MKL's ``sgemm`` (``F.linear``) picks its blocking by the batch.

- For LeNet, ResNet-18, VGG16 and DenseNet121 at small widths, in fp32, a
  row's logits are bit for bit the same at buckets 2, 4, 8 and 16, at 2 and
  at 8 torch threads, and across the two.
- JAX's LeNet gives the same bits at buckets 4 and 8 too, and the port
  agrees with JAX within rtol 1e-4 on weights carried across by
  ``compat``.
- On the CPU a batch of ONE row is its own class: oneDNN convolves a single
  image with other kernels than a batch of two or more (as XLA:CPU does in
  JAX). The device group's singleton bucket keeps it (JAX's rule); the
  test below shows the class exists, so a change of it is seen.
- The serving CLI's ``--verify`` passes on LeNet on the CPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_cifar_tpu.models import create_model as jax_create_model
from pytorch_cifar_tpu.models.resnet import BasicBlock as JaxBasicBlock
from pytorch_cifar_tpu.models.resnet import ResNet as JaxResNet
from pytorch_cifar_tpu.serve.engine import InferenceEngine as JaxEngine
from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
from pytorch_cifar_tpu_torch.models import create_model, reset_parameters
from pytorch_cifar_tpu_torch.models.common import folded_dense
from pytorch_cifar_tpu_torch.models.densenet import DenseNet
from pytorch_cifar_tpu_torch.models.resnet import BasicBlock, ResNet
from pytorch_cifar_tpu_torch.models.vgg import VGG
from _torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (2, 4, 8, 16)
THREADS = (2, 8)
VGG_NARROW = (8, "M", 16, 16, "M", 24, "M", 32, "M", 32, "M")
MODELS = {
    "LeNet": lambda: create_model("LeNet"),
    "ResNet18": lambda: ResNet(BasicBlock, (1, 1, 1, 1)),
    "VGG16": lambda: VGG(VGG_NARROW),
    "DenseNet121": lambda: DenseNet((2, 3, 2, 2), 4),
}


def _model(name, seed=0):
    """``name`` at a small width, seeded weights and BN statistics."""
    model = MODELS[name]()
    reset_parameters(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model.eval()


def _inputs(n=16, seed=0):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.standard_normal((n, 3, 32, 32)).astype(
        np.float32))
    return x.contiguous(memory_format=torch.channels_last)


def _by_bucket(model, folded, x):
    """Every row's logits computed in batches of each bucket."""
    with torch.inference_mode():
        return {b: torch.cat([model.folded_forward(folded, x[i:i + b])
                              for i in range(0, x.shape[0], b)])
                for b in BUCKETS}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_rows_keep_their_bits_across_buckets_and_threads(name):
    model = _model(name)
    folded = model.fold(torch.float32)
    x = _inputs()
    before = torch.get_num_threads()
    runs = {}
    try:
        for t in THREADS:
            torch.set_num_threads(t)
            runs[t] = _by_bucket(model, folded, x)
    finally:
        torch.set_num_threads(before)
    want = runs[THREADS[0]][BUCKETS[-1]]
    assert torch.isfinite(want).all()
    for t, by_bucket in runs.items():
        for b, got in by_bucket.items():
            assert torch.equal(got, want), (name, t, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_folded_dense_is_the_linear_layer(dtype):
    rs = np.random.RandomState(3)
    for width in (84, 400, 512, 1024, 1):
        x = torch.from_numpy(rs.standard_normal((16, width))).to(dtype)
        w = torch.from_numpy(rs.standard_normal((10, width))
                             / np.sqrt(width)).to(dtype)
        b = torch.from_numpy(rs.standard_normal(10)).to(dtype)
        got = folded_dense(x, w, b)
        assert got.dtype == dtype and got.shape == (16, 10)
        want = x.double() @ w.double().T + b.double()
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        assert torch.allclose(got.double(), want, rtol=tol, atol=tol)
        rows = torch.cat([folded_dense(x[i:i + 1], w, b) for i in range(16)])
        assert torch.equal(rows, got)
        assert torch.allclose(got.float(), F.linear(x, w, b).float(),
                              rtol=tol, atol=tol)


def _jax_lenet(seed=0):
    variables = jax_create_model("LeNet").init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)), train=False)
    return dict(variables["params"]), {}


def _images(n, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


def test_jax_lenet_keeps_bits_at_buckets_4_and_8_and_the_port_agrees():
    from pytorch_cifar_tpu_torch.serve import InferenceEngine

    params, stats = _jax_lenet()
    jeng = JaxEngine("LeNet", params, stats, buckets=(4, 8),
                     compute_dtype=jnp.float32)
    peng = InferenceEngine("LeNet", state_dict_from_jax(
        "LeNet", jax.device_get(params), {}), buckets=(4, 8),
        compute_dtype=torch.float32, device="cpu")
    x = _images(8, seed=5)
    for eng in (jeng, peng):
        eight = eng.predict(x)
        fours = np.concatenate([eng.predict(x[:4]), eng.predict(x[4:])])
        assert np.array_equal(eight, fours), type(eng).__module__
    np.testing.assert_allclose(peng.predict(x), jeng.predict(x), rtol=1e-4,
                               atol=1e-5)


def test_resnet_port_agrees_with_jax_at_every_bucket():
    """ResNet-18 at a small depth, on JAX's weights: within rtol 1e-4 of
    JAX's forward at each bucket."""
    jmodel = JaxResNet(JaxBasicBlock, (1, 1, 1, 1))
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
                            train=False)
    params = jax.device_get(dict(variables["params"]))
    stats = jax.device_get(dict(variables["batch_stats"]))
    port = ResNet(BasicBlock, (1, 1, 1, 1))
    port.load_state_dict({
        k: torch.from_numpy(np.array(v)) for k, v in state_dict_from_jax(
            "ResNet18", params, stats, model=port).items()})
    folded = port.eval().fold(torch.float32)
    nhwc = np.random.RandomState(9).standard_normal(
        (16, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(nhwc),
        train=False))
    x = torch.from_numpy(nhwc).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        for b in BUCKETS:
            got = torch.cat([port.folded_forward(folded, x[i:i + b])
                             for i in range(0, 16, b)]).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_one_row_is_its_own_conv_class_on_the_cpu():
    """oneDNN gives a lone image other bits than the same image in a batch
    of two or more (ROADMAP Queue C, "Recorded, not faults"); the
    difference is rounding-sized."""
    model = _model("ResNet18", seed=4)
    folded = model.fold(torch.float32)
    x = _inputs(8, seed=4)
    with torch.inference_mode():
        pair = torch.cat([model.folded_forward(folded, x[i:i + 2])
                          for i in range(0, 8, 2)])
        ones = torch.cat([model.folded_forward(folded, x[i:i + 1])
                          for i in range(8)])
    assert not torch.equal(ones, pair)
    assert torch.allclose(ones, pair, rtol=1e-5, atol=1e-6)


def test_serving_cli_verify_passes_on_lenet():
    r = subprocess.run(
        [sys.executable, "-m", "pytorch_cifar_tpu_torch.serve", "--device",
         "cpu", "--model", "LeNet", "--dtype", "float32", "--verify",
         "--clients", "1", "--requests", "2"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "==> verify: bucket-padded forward bit-identical to direct " \
        "forward at n=7" in r.stderr
