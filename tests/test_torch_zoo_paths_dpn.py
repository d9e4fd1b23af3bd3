"""DPN end to end on the CPU: one float64 train step of a narrow DPN (one
or two blocks a stage, 64-wide grouped convs of 32 groups) against the
JAX package's, the train CLI, the serving engine and the serving CLI.
Helpers in ``tests/_torch_zoo.py``.
"""

import logging

import pytest

from pytorch_cifar_tpu.models.dpn import DPN as JaxDPN
from pytorch_cifar_tpu_torch.models.dpn import DPN
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (
    check_engine_under_load,
    check_serve_cli,
    check_step_f64,
    step_f64_vs_jax,
)

NARROW = {"in_planes": (64, 64, 64, 64), "out_planes": (16, 24, 32, 48),
          "dense_depth": (4, 8, 4, 8), "num_blocks": (1, 2, 1, 1)}


def test_train_step_matches_jax_float64():
    port, want = step_f64_vs_jax("DPN26", JaxDPN(NARROW), DPN(NARROW), n=4)
    check_step_f64(port, want, 4)


def test_cli_trains_dpn_on_the_cpu(caplog, tmp_path):
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--model", "DPN26", "--synthetic_data",
        "--synthetic_train_size", "16", "--synthetic_test_size", "8",
        "--batch_size", "8", "--eval_batch_size", "8", "--epochs", "1",
        "--no-amp", "--output_dir", str(tmp_path),
    ])
    (h,) = out["history"]
    assert h["train"]["count"] == 16 and h["train"]["nonfinite"] == 0
    assert "==> model DPN26" in caplog.text


@pytest.mark.parametrize("name", ["DPN26"])
def test_engine_serves_the_zoo_models_under_load(name):
    check_engine_under_load(name)


@pytest.mark.parametrize("name", ["DPN26"])
def test_serve_cli_runs_the_zoo_models_on_the_cpu(name, capsys):
    check_serve_cli(name, capsys)
