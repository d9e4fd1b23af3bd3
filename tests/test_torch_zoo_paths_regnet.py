"""RegNet end to end on the CPU: one float64 train step of a narrow RegNetY
(one block a stage, widths 8 to 32, group width 8, the SE gate) against
the JAX package's, the train CLI, the serving engine and the serving CLI.
Helpers in ``tests/_torch_zoo.py``.
"""

import logging

import pytest

from pytorch_cifar_tpu.models.regnet import RegNet as JaxRegNet
from pytorch_cifar_tpu_torch.models.regnet import RegNet
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (
    check_engine_under_load,
    check_serve_cli,
    check_step_f64,
    step_f64_vs_jax,
)

# grouped 3x3s of 1, 2 and 4 groups, a stride-1 and two stride-2 width
# changes, the gate in every block
NARROW = {"depths": (1, 1, 1, 1), "widths": (8, 16, 24, 32),
          "strides": (1, 1, 2, 2), "group_width": 8, "bottleneck_ratio": 1,
          "se_ratio": 0.25}


def test_train_step_matches_jax_float64():
    port, want = step_f64_vs_jax("RegNetY_400MF", JaxRegNet(NARROW),
                                 RegNet(NARROW), n=4)
    check_step_f64(port, want, 4)


def test_cli_trains_regnet_on_the_cpu(caplog, tmp_path):
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--model", "RegNetX_200MF", "--synthetic_data",
        "--synthetic_train_size", "32", "--synthetic_test_size", "16",
        "--batch_size", "16", "--eval_batch_size", "16", "--epochs", "1",
        "--no-amp", "--output_dir", str(tmp_path),
    ])
    (h,) = out["history"]
    assert h["train"]["count"] == 32 and h["train"]["nonfinite"] == 0
    assert "==> model RegNetX_200MF" in caplog.text


@pytest.mark.parametrize("name", ["RegNetY_400MF"])
def test_engine_serves_the_zoo_models_under_load(name):
    check_engine_under_load(name)


@pytest.mark.parametrize("name", ["RegNetX_400MF"])
def test_serve_cli_runs_the_zoo_models_on_the_cpu(name, capsys):
    check_serve_cli(name, capsys)
