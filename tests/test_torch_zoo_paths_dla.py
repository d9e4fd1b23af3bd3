"""SimpleDLA end to end on the CPU: its train step against the JAX
package's (one JAX compile), the train CLI with no ``--model`` (SimpleDLA
is the default), and the port's serving stack. Helpers in
``tests/_torch_zoo.py``.
"""

import logging

import numpy as np
import pytest

from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import check_engine_under_load, train_step_vs_jax


def test_simpledla_train_step_matches_jax_fp32():
    """SimpleDLA's step as MobileNet's above, at 16 images (the last two
    padded), held at its own conditioning. Measured on the CPU over weight
    seeds 2, 3 and 4: the JAX fp32 step is 10-22% of an update off the
    float64-compute step on its worst tensor, the port's 6-18% (0.58-0.81
    times the JAX step's), the two steps 1.9-2.6% apart on the median
    tensor and 6e-5 to 9e-5 on the linear layer. Held: the port no further
    off than twice the JAX step, the JAX step within 30% of an update, the
    median within 10% and the linear within 1e-3."""
    port, jax_err, direct = train_step_vs_jax("SimpleDLA", n=16, seed=2)
    errs = {"port": port, "jax": jax_err}
    assert errs["port"] <= 2 * errs["jax"], errs
    assert errs["jax"] <= 0.3, errs  # the same step, not merely some step
    assert np.median(list(direct.values())) <= 0.1, direct
    for k in ("linear.weight", "linear.bias"):
        assert direct[k] <= 1e-3, (k, direct[k])


def test_cli_trains_the_default_model_on_the_cpu(caplog, tmp_path):
    """``python -m pytorch_cifar_tpu_torch.train --device cpu
    --synthetic_data --synthetic_train_size 256 --batch_size 32 --epochs 1``
    with no ``--model``, in-process: the default model, SimpleDLA, trains
    (bf16, the default) with every image counted and finite losses."""
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--synthetic_data", "--synthetic_train_size",
        "256", "--synthetic_test_size", "64", "--batch_size", "32",
        "--epochs", "1", "--output_dir", str(tmp_path),
    ])
    (h,) = out["history"]
    assert h["train"]["count"] == 256 and h["eval"]["count"] == 64
    assert h["train"]["nonfinite"] == 0
    assert np.isfinite(h["train_loss"]) and np.isfinite(h["eval_loss"])
    assert "==> model SimpleDLA" in caplog.text


@pytest.mark.parametrize("name", ["SimpleDLA"])
def test_engine_serves_the_zoo_models_under_load(name):
    check_engine_under_load(name)
