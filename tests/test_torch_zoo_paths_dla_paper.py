"""The paper DLA end to end on the CPU: one float64 train step against the
JAX package's, the train CLI and the serving engine. Helpers in
``tests/_torch_zoo.py``.
"""

import logging

import pytest

from pytorch_cifar_tpu.models import create_model as jax_create_model
from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (
    check_engine_under_load,
    check_step_f64,
    step_f64_vs_jax,
)


def test_train_step_matches_jax_float64():
    """Full width (the JAX DLA takes no width), four images (the last
    padded), float64 on both sides: every tree's aggregation, the
    ``prev_root`` blocks included, in the backward too."""
    port, want = step_f64_vs_jax("DLA", jax_create_model("DLA"),
                                 create_model("DLA"), n=4)
    check_step_f64(port, want, 4)


def test_cli_trains_dla_on_the_cpu(caplog, tmp_path):
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--model", "DLA", "--synthetic_data",
        "--synthetic_train_size", "32", "--synthetic_test_size", "16",
        "--batch_size", "16", "--eval_batch_size", "16", "--epochs", "1",
        "--no-amp",
        "--output_dir", str(tmp_path),
    ])
    (h,) = out["history"]
    assert h["train"]["count"] == 32 and h["train"]["nonfinite"] == 0
    assert "==> model DLA" in caplog.text


@pytest.mark.parametrize("name", ["DLA"])
def test_engine_serves_the_zoo_models_under_load(name):
    check_engine_under_load(name)
