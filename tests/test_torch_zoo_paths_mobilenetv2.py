"""MobileNetV2 end to end on the CPU: one float64 train step of a cut
MobileNetV2 against the JAX package's, the train CLI, the serving engine
and the serving CLI. Helpers in ``tests/_torch_zoo.py``.
"""

import logging

import pytest

from pytorch_cifar_tpu.models import mobilenetv2 as jax_mobilenetv2
from pytorch_cifar_tpu_torch.models import mobilenetv2
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (
    check_engine_under_load,
    check_serve_cli,
    check_step_f64,
    step_f64_vs_jax,
)

# five stages cut from the seven, three at stride 2 as in the full plan
# (the 4x4 pool then leaves a 1x1 map): expansion 1 and 6, width changes
# at stride 1 (projected residuals), identity residuals
CUT = ((1, 8, 1, 1), (6, 12, 2, 1), (6, 16, 2, 2), (6, 24, 1, 2),
       (6, 32, 1, 2))


def test_train_step_matches_jax_float64(monkeypatch):
    """Both packages' stage plans cut alike (each reads its plan when a
    model is built), four images, float64 on both sides."""
    monkeypatch.setattr(jax_mobilenetv2, "_CFG", CUT)
    monkeypatch.setattr(mobilenetv2, "CFG", CUT)
    port, want = step_f64_vs_jax("MobileNetV2",
                                 jax_mobilenetv2.MobileNetV2(),
                                 mobilenetv2.MobileNetV2(), n=4)
    check_step_f64(port, want, 4)


def test_cli_trains_mobilenetv2_on_the_cpu(caplog, tmp_path):
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--model", "MobileNetV2", "--synthetic_data",
        "--synthetic_train_size", "32", "--synthetic_test_size", "16",
        "--batch_size", "16", "--eval_batch_size", "16", "--epochs", "1",
        "--no-amp",
        "--output_dir", str(tmp_path),
    ])
    (h,) = out["history"]
    assert h["train"]["count"] == 32 and h["train"]["nonfinite"] == 0
    assert "==> model MobileNetV2" in caplog.text


@pytest.mark.parametrize("name", ["MobileNetV2"])
def test_engine_serves_the_zoo_models_under_load(name):
    check_engine_under_load(name)


@pytest.mark.parametrize("name", ["MobileNetV2"])
def test_serve_cli_runs_the_zoo_models_on_the_cpu(name, capsys):
    check_serve_cli(name, capsys)
