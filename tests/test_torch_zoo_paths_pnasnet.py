"""PNASNet end to end on the CPU: one float64 train step of a narrow
PNASNet A and B against the JAX package's, 18 pool forwards and 18 pool
backwards through the K4 op in a train step, ``Trainer.fit`` and the train
CLI, the serving engine and the serving CLI. Helpers in
``tests/_torch_zoo.py``.
"""

import logging

import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.models.pnasnet import CellA as JaxCellA
from pytorch_cifar_tpu.models.pnasnet import CellB as JaxCellB
from pytorch_cifar_tpu.models.pnasnet import PNASNet as JaxPNASNet
from pytorch_cifar_tpu_torch.config import TrainConfig
from pytorch_cifar_tpu_torch.models import common, create_model
from pytorch_cifar_tpu_torch.models.pnasnet import CellA, CellB, PNASNet
from pytorch_cifar_tpu_torch.ops import max_pool as P
from pytorch_cifar_tpu_torch.train import optim, steps
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from pytorch_cifar_tpu_torch.train.state import create_train_state
from pytorch_cifar_tpu_torch.train.trainer import Trainer
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (
    check_engine_under_load,
    check_serve_cli,
    check_step_f64,
    images,
    step_f64_vs_jax,
)


@pytest.mark.parametrize("name,cells", [
    ("PNASNetA", (JaxCellA, CellA)), ("PNASNetB", (JaxCellB, CellB))])
def test_train_step_matches_jax_float64(name, cells):
    """``num_planes`` 8 (the registered 44 and 32 cut), 20 cells at 32x32,
    16x16 and 8x8, four images (the last padded), float64 on both sides,
    held as :func:`~_torch_zoo.check_step_f64` says."""
    port, want = step_f64_vs_jax(name, JaxPNASNet(cells[0], 8),
                                 PNASNet(cells[1], 8), n=4)
    check_step_f64(port, want, 4)


def test_a_train_step_pools_18_times_each_way(monkeypatch):
    """A PNASNetA step at full width: 18 pool forwards with a winner map,
    18 backwards, all through the K4 op (the stride-2 cells' pools take the
    library)."""
    fwd, bwd = [], []
    real_pool, real_bwd = common.max_pool3x3_s1, P._backward
    monkeypatch.setattr(common, "max_pool3x3_s1",
                        lambda v: fwd.append(v.requires_grad)
                        or real_pool(v))
    monkeypatch.setattr(P, "_backward",
                        lambda g, idx: bwd.append(g.shape) or real_bwd(g, idx))
    model = create_model("PNASNetA", generator=torch.Generator().manual_seed(
        0)).to(memory_format=torch.channels_last)
    state = create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=0.01),
        optim.cosine_epoch_schedule(0.01, 4, 3), device="cpu")
    x, y = images(2, seed=4)
    m = steps.make_train_step(device="cpu")(
        state, (torch.from_numpy(x), torch.from_numpy(y)))
    assert float(m["nonfinite"]) == 0
    assert fwd == [True] * 18
    assert sorted(bwd) == sorted([(2, h, h, c) for h, c in
                                  ((32, 44), (16, 88), (8, 176))
                                  for _ in range(6)])


def test_trainer_trains_pnasnetb_through_the_pool_op(monkeypatch, tmp_path):
    """``Trainer.fit`` on PNASNetB at full width: 18 pools under autograd
    a train step, 18 without in an eval forward."""
    calls = []
    real = common.max_pool3x3_s1
    monkeypatch.setattr(common, "max_pool3x3_s1",
                        lambda v: calls.append(v.requires_grad) or real(v))
    cfg = TrainConfig(
        model="PNASNetB", batch_size=8, eval_batch_size=8, amp=False,
        synthetic_data=True, synthetic_train_size=16, synthetic_test_size=8,
        epochs=1, lr=0.01, device="cpu", output_dir=str(tmp_path),
    )
    trainer = Trainer(cfg)
    trainer.fit()
    (h,) = trainer.history
    assert h["train"]["count"] == 16 and h["eval"]["count"] == 8
    assert np.isfinite(h["train_loss"]) and h["train"]["nonfinite"] == 0
    assert calls == [True] * 36 + [False] * 18


def test_cli_trains_pnasneta_on_the_cpu(caplog, tmp_path):
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--model", "PNASNetA", "--synthetic_data",
        "--synthetic_train_size", "32", "--synthetic_test_size", "16",
        "--batch_size", "16", "--eval_batch_size", "16", "--epochs", "1",
        "--no-amp", "--lr", "0.01",
        "--output_dir", str(tmp_path),
    ])
    (h,) = out["history"]
    assert h["train"]["count"] == 32 and h["train"]["nonfinite"] == 0
    assert "==> model PNASNetA" in caplog.text


@pytest.mark.parametrize("name", ["PNASNetB"])
def test_engine_serves_the_zoo_models_under_load(name):
    check_engine_under_load(name)


@pytest.mark.parametrize("name", ["PNASNetA"])
def test_serve_cli_runs_the_zoo_models_on_the_cpu(name, capsys):
    check_serve_cli(name, capsys)
