"""SENet end to end on the CPU: one float64 train step of SENet at full
width with one block a stage (the JAX class fixes its widths) against the
JAX package's, the train CLI, the serving engine and the serving CLI.
Helpers in ``tests/_torch_zoo.py``.
"""

import logging

import pytest

from pytorch_cifar_tpu.models.senet import SENet as JaxSENet
from pytorch_cifar_tpu_torch.models.senet import SENet
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (
    check_engine_under_load,
    check_serve_cli,
    check_step_f64,
    step_f64_vs_jax,
)


def test_train_step_matches_jax_float64():
    """Four blocks, each with its gate, four images, float64 on both
    sides."""
    port, want = step_f64_vs_jax("SENet18", JaxSENet((1, 1, 1, 1)),
                                 SENet((1, 1, 1, 1)), n=4)
    check_step_f64(port, want, 4)


def test_cli_trains_senet_on_the_cpu(caplog, tmp_path):
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--model", "SENet18", "--synthetic_data",
        "--synthetic_train_size", "32", "--synthetic_test_size", "16",
        "--batch_size", "16", "--eval_batch_size", "16", "--epochs", "1",
        "--no-amp", "--output_dir", str(tmp_path),
    ])
    (h,) = out["history"]
    assert h["train"]["count"] == 32 and h["train"]["nonfinite"] == 0
    assert "==> model SENet18" in caplog.text


@pytest.mark.parametrize("name", ["SENet18"])
def test_engine_serves_the_zoo_models_under_load(name):
    check_engine_under_load(name)


@pytest.mark.parametrize("name", ["SENet18"])
def test_serve_cli_runs_the_zoo_models_on_the_cpu(name, capsys):
    check_serve_cli(name, capsys)
