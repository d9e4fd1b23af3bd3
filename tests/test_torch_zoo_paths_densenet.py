"""DenseNet end to end on the CPU: one float64 train step of a narrow
DenseNet (growth 4, 1 / 2 / 1 / 1 layers a stage, the shared-stats path,
as by default) against the JAX
package's, the train CLI, the serving engine and the serving CLI. Helpers
in ``tests/_torch_zoo.py``.
"""

import logging

import pytest

from pytorch_cifar_tpu.models.densenet import DenseNet as JaxDenseNet
from pytorch_cifar_tpu_torch.models.densenet import DenseNet
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (
    check_engine_under_load,
    check_serve_cli,
    check_step_f64,
    step_f64_vs_jax,
)


def test_train_step_matches_jax_float64():
    """Both packages on the shared-stats path (their default), four
    images, float64 on both sides."""
    port, want = step_f64_vs_jax("DenseNetCifar",
                                 JaxDenseNet((1, 2, 1, 1), 4),
                                 DenseNet((1, 2, 1, 1), 4), n=4)
    check_step_f64(port, want, 4)


def test_cli_trains_densenet_on_the_cpu(caplog, tmp_path):
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--model", "DenseNetCifar", "--synthetic_data",
        "--synthetic_train_size", "32", "--synthetic_test_size", "16",
        "--batch_size", "16", "--eval_batch_size", "16", "--epochs", "1",
        "--no-amp", "--output_dir", str(tmp_path),
    ])
    (h,) = out["history"]
    assert h["train"]["count"] == 32 and h["train"]["nonfinite"] == 0
    assert "==> model DenseNetCifar" in caplog.text


@pytest.mark.parametrize("name", ["DenseNetCifar"])
def test_engine_serves_the_zoo_models_under_load(name):
    check_engine_under_load(name)


@pytest.mark.parametrize("name", ["DenseNet121"])
def test_serve_cli_runs_the_zoo_models_on_the_cpu(name, capsys):
    check_serve_cli(name, capsys)
