"""MobileNet end to end on the CPU: its train step and its engine against
the JAX package's (one JAX compile each), the train CLI, and the port's
serving stack and serving CLI. The zoo's path tests are split by family
(``..._dla.py``, ``..._googlenet.py``; helpers in ``tests/_torch_zoo.py``).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.serve.engine import InferenceEngine as JaxEngine
from pytorch_cifar_tpu_torch.serve import InferenceEngine
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (
    check_engine_under_load,
    check_serve_cli,
    images,
    jax_trees,
    train_step_vs_jax,
)


def test_mobilenet_train_step_matches_jax_fp32():
    """One step from the same weights and batch, augmentation off. The
    forward's work is held tightly: the metric sums and the BN running
    statistics within rtol 1e-4. The updated parameters are held at the
    step's own conditioning: BN's backward subtracts nearly equal terms, so
    an fp32 step is accurate only to a few percent of its update on its
    worst tensor (the JAX fp32 step is 12% of an update off a
    float64-compute step here, the port's 6%). The port's fp32 step must be
    no further from the port's float64-compute step, in units of each
    tensor's update, than twice the JAX fp32 step is; the JAX step itself
    within 25% of an update on its worst tensor and, directly against the
    port's fp32 step, within 10% on the median tensor (4.4% here). The
    linear layer sits behind no BN backward and is held directly: its
    update within 1e-3 of the JAX step's (2.5e-4 here)."""
    port, jax_err, direct = train_step_vs_jax("MobileNet")
    errs = {"port": port, "jax": jax_err}
    assert errs["port"] <= 2 * errs["jax"], errs
    assert errs["jax"] <= 0.25, errs  # the same step, not merely some step
    assert np.median(list(direct.values())) <= 0.1, direct
    for k in ("linear.weight", "linear.bias"):
        assert direct[k] <= 1e-3, (k, direct[k])


def test_mobilenet_port_engine_matches_jax_engine_fp32():
    params, stats = jax_trees("MobileNet", seed=1)
    jeng = JaxEngine("MobileNet", params, stats, buckets=(4,),
                     compute_dtype=jnp.float32)
    peng = InferenceEngine.from_jax(
        "MobileNet", params, stats, buckets=(4,),
        compute_dtype=torch.float32, device="cpu",
    )
    x, _ = images(3, seed=11)
    want, got = jeng.predict(x), peng.predict(x)
    assert got.dtype == np.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["MobileNet"])
def test_engine_serves_the_zoo_models_under_load(name):
    check_engine_under_load(name)


@pytest.mark.parametrize("name", ["MobileNet"])
def test_serve_cli_runs_the_zoo_models_on_the_cpu(name, capsys):
    check_serve_cli(name, capsys)


def test_cli_trains_mobilenet_on_the_cpu(caplog, tmp_path):
    """``python -m pytorch_cifar_tpu_torch.train --device cpu --model
    MobileNet --synthetic_data --epochs 2``, in-process: a falling loss and
    every image counted once per epoch."""
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--model", "MobileNet", "--synthetic_data",
        "--epochs", "2", "--no-amp", "--synthetic_train_size", "512",
        "--synthetic_test_size", "60", "--batch_size", "32",
        "--eval_batch_size", "64", "--lr", "0.01",
        "--output_dir", str(tmp_path),
    ])
    hist = out["history"]
    assert len(hist) == 2
    for h in hist:
        assert h["train"]["count"] == 512 and h["eval"]["count"] == 60
        assert h["train"]["nonfinite"] == 0
    assert hist[1]["train_loss"] < hist[0]["train_loss"]
    assert "==> model MobileNet" in caplog.text
