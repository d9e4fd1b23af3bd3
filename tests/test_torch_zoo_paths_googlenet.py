"""GoogLeNet end to end on the CPU through the port's trainer (every train
step pooling 9 times under autograd), its serving stack and serving CLI;
and the checks that hold for every model: nothing model-specific in the
config and trainer, and the kernel bench tools refusing to time the CPU.
Helpers in ``tests/_torch_zoo.py``.
"""

import numpy as np
import pytest
import torch

from pytorch_cifar_tpu_torch.config import TrainConfig
from pytorch_cifar_tpu_torch.models import common
from pytorch_cifar_tpu_torch.tools import depthwise_bench, pool_bench
from pytorch_cifar_tpu_torch.train.trainer import Trainer
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import check_engine_under_load, check_serve_cli


@pytest.mark.parametrize("name", ["GoogLeNet"])
def test_engine_serves_the_zoo_models_under_load(name):
    check_engine_under_load(name)


@pytest.mark.parametrize("name", ["GoogLeNet"])
def test_serve_cli_runs_the_zoo_models_on_the_cpu(name, capsys):
    check_serve_cli(name, capsys)


def test_trainer_trains_googlenet_through_the_pool_op(monkeypatch, tmp_path):
    """``Trainer.fit`` on GoogLeNet at full width (a tiny synthetic split
    on the CPU): nothing in the trainer is model-specific, and every train
    step pools 9 times under autograd, every eval forward 9 times without."""
    calls = []
    real = common.max_pool3x3_s1
    monkeypatch.setattr(
        common, "max_pool3x3_s1",
        lambda v: calls.append(v.requires_grad) or real(v),
    )
    cfg = TrainConfig(
        model="GoogLeNet", batch_size=8, eval_batch_size=8, amp=False,
        synthetic_data=True, synthetic_train_size=16, synthetic_test_size=8,
        epochs=1, lr=0.01, device="cpu", output_dir=str(tmp_path),
    )
    trainer = Trainer(cfg)
    trainer.fit()
    (h,) = trainer.history
    assert h["train"]["count"] == 16 and h["eval"]["count"] == 8
    assert np.isfinite(h["train_loss"]) and h["train"]["nonfinite"] == 0
    assert calls == [True] * 18 + [False] * 9  # 2 train steps, 1 eval forward


def test_nothing_model_specific_is_left_in_config_and_trainer():
    """Any registered model's name passes the config check; an unknown one
    raises from the registry (``KeyError``), naming what is there."""
    for name in ("GoogLeNet", "MobileNet", "ResNet18", "LeNet", "VGG16"):
        cfg = TrainConfig(model=name, synthetic_data=True, device="cpu")
        assert cfg.model == name
    with pytest.raises(KeyError, match="GoogLeNet.*MobileNet.*VGG16"):
        Trainer(TrainConfig(model="NoSuchNet", synthetic_data=True,
                            synthetic_train_size=8, synthetic_test_size=8,
                            batch_size=8, device="cpu"))


@pytest.mark.parametrize("tool", [pool_bench, depthwise_bench],
                         ids=["pool_bench", "depthwise_bench"])
def test_bench_tools_measure_only_on_a_card(tool):
    """The kernel bench tools print device times: with no card they raise
    before timing anything, they do not time the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])
