"""EfficientNetB0 end to end on the CPU: one float64 train step of a
narrow EfficientNet against the JAX package's, both sides drawing the same
drop-connect and dropout masks (the ones the JAX step draws from its own
key); the port's own draw stream; a two-rank data-parallel step (the dead
BN's buffers in the flat all-reduce stay at their initial values);
checkpoints in format v2 byte for byte the JAX package's, each package
restoring the other's; ``Trainer.fit``, the train CLI and the serving
engine. Helpers in ``tests/_torch_zoo.py``, ``tests/_torch_ckpt.py`` and
``tests/_torch_dp.py``.
"""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.models.efficientnet import (
    EfficientNet as JaxEfficientNet,
)
from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch.compat import jax_trees_from_state_dict
from pytorch_cifar_tpu_torch.config import TrainConfig
from pytorch_cifar_tpu_torch.data.pipeline import mix_seed
from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.models.efficientnet import EfficientNet
from pytorch_cifar_tpu_torch.train import checkpoint as ckpt
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from pytorch_cifar_tpu_torch.train.state import MODEL_STREAM
from pytorch_cifar_tpu_torch.train.trainer import Trainer
from _torch_ckpt import (
    jax_state,
    momentum,
    port_state,
    random_port_state,
    trees_equal,
)
from _torch_dp import run_job
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (
    check_engine_under_load,
    check_step_f64,
    images,
    step_f64_vs_jax,
)

NAME = "EfficientNetB0"
# narrow: four stages, two of them with a skip connection (drop-connect)
CUT = {"num_blocks": (1, 2, 1, 2), "expansion": (1, 2, 2, 2),
       "out_channels": (8, 8, 16, 16), "kernel_size": (3, 5, 3, 5),
       "stride": (1, 1, 2, 1), "dropout_rate": 0.2,
       "drop_connect_rate": 0.2}


def test_train_step_matches_jax_with_the_same_masks():
    """Eight images (the last padded), float64 on both sides: the JAX
    step's drop-connect masks (two blocks) and dropout mask replayed in
    the port's step; loss, momentum (gradient + decay, the dead expand
    conv's included), parameters and BN statistics as
    :func:`~_torch_zoo.check_step_f64` holds them."""
    port, want = step_f64_vs_jax(NAME, JaxEfficientNet(CUT),
                                 EfficientNet(CUT), n=8, masks=True)
    check_step_f64(port, want, 8)
    dead = "layers.0.conv1.weight"
    assert np.array_equal(port["sd"]["layers.0.bn1.running_mean"],
                          port["before"]["layers.0.bn1.running_mean"])
    np.testing.assert_allclose(port["trace"][dead],
                               5e-4 * port["before"][dead], rtol=1e-6)


def test_model_draws_depend_on_seed_step_and_shard_alone():
    """The model's masks come from ``(seed, step[, shard])`` alone: two
    states at the same point draw the same bits, another step or shard
    other bits; the seed has bit 31 set, which no augmentation seed has,
    so the two streams never share bits."""
    def draws(seed=0, step=0, shard=None):
        st = port_state("LeNet", seed=seed)
        st.step = step
        fn = st.model_draws(shard)
        return torch.cat([fn((4, 1, 1, 1), 0.5).flatten(),
                          fn((4, 16), 0.8).flatten()])

    assert torch.equal(draws(), draws())
    for other in (draws(step=1), draws(seed=1), draws(shard=1)):
        assert not torch.equal(draws(), other)
    st = port_state("LeNet")
    st.step = 3
    fn = st.model_draws(shard=1)
    seed = mix_seed(mix_seed(0, 3), 1)
    g = torch.Generator().manual_seed(seed | MODEL_STREAM)
    assert torch.equal(fn((64,), 0.5), torch.rand(64, generator=g) < 0.5)
    aug = torch.Generator().manual_seed(seed)  # the augmentation's
    assert not torch.equal(torch.rand(64, generator=aug),
                           torch.rand(64, generator=g.manual_seed(
                               seed | MODEL_STREAM)))
    assert MODEL_STREAM == 2 ** 31 and seed < MODEL_STREAM


def test_two_rank_step_keeps_the_dead_bn_at_its_initial_values(tmp_path):
    """Two gloo ranks take a data-parallel step of EfficientNetB0 at full
    width: the flat all-reduce carries the dead BN's running buffers, which
    stay at 0 and 1 on both ranks while the live ones move, and the
    replicas hold the same bits."""
    sd = create_model(NAME, generator=torch.Generator().manual_seed(0)) \
        .state_dict()
    x, y = images(8, seed=3)
    ranks = run_job([{"name": "s", "kind": "step", "model": NAME, "sd": sd,
                      "lr": 0.1, "t_max": 4, "spe": 3, "sync_bn": False,
                      "compute": "float32", "batches": [(x, y)]}],
                    str(tmp_path))
    a, b = ranks[0]["s"], ranks[1]["s"]
    for r in (a, b):
        assert torch.equal(r["sd"]["layers.0.bn1.running_mean"],
                           torch.zeros(32))
        assert torch.equal(r["sd"]["layers.0.bn1.running_var"],
                           torch.ones(32))
        assert not torch.equal(r["sd"]["layers.1.bn1.running_mean"],
                               sd["layers.1.bn1.running_mean"])
        assert r["metrics"][0]["count"] == 8
    for k in a["sd"]:
        assert torch.equal(a["sd"][k], b["sd"][k]), k


def test_port_checkpoint_is_byte_for_byte_the_jax_one(tmp_path):
    """A JAX state saved by the JAX package (format v2), restored by the
    port and saved again: the payload's and sidecar's bytes equal, dead
    parameters included, and the JAX package reads it back unchanged."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    js = jax_state(NAME, seed=4, step=11)
    jax_ckpt.save_checkpoint(a, js, 6, 12.5)
    ps = port_state(NAME)
    ckpt.restore_checkpoint(a, ps)
    assert ps.step == 11
    ckpt.save_checkpoint(b, ps, 6, 12.5)
    for f in ("ckpt.msgpack", "ckpt.json"):
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f
    back, _, _ = jax_ckpt.restore_checkpoint(b, jax_state(NAME, seed=5))
    trees_equal(jax.device_get(back.params), jax.device_get(js.params))
    trees_equal(jax.device_get(back.opt_state[1].trace),
                jax.device_get(js.opt_state[1].trace))


def test_jax_restores_a_port_checkpoint(tmp_path):
    """A port state with every tensor drawn from a seed, saved by the
    port: the JAX ``restore_checkpoint`` gives its params, BN statistics,
    momentum and step."""
    ps = random_port_state(NAME, seed=2)
    ckpt.save_checkpoint(str(tmp_path), ps, 2, 40.0)
    restored, start, best = jax_ckpt.restore_checkpoint(
        str(tmp_path), jax_state(NAME, seed=9, step=0))
    assert (start, best, int(restored.step)) == (3, 40.0, 5)
    params, stats = jax_trees_from_state_dict(NAME, ps.model.state_dict(),
                                              model=ps.model)
    trees_equal(jax.device_get(restored.params), params)
    trees_equal(jax.device_get(restored.batch_stats), stats)
    mom_sd = dict(ps.model.state_dict())
    mom_sd.update(momentum(ps))
    trace, _ = jax_trees_from_state_dict(NAME, mom_sd, model=ps.model)
    trees_equal(jax.device_get(restored.opt_state[1].trace), trace)


def test_trainer_trains_efficientnet_with_its_masks_live(monkeypatch,
                                                         tmp_path):
    """``Trainer.fit`` at full width on a tiny split: every train step
    draws 9 drop-connect masks (the 9 blocks with a skip connection) and
    one dropout mask through the state's model stream; eval draws none."""
    from pytorch_cifar_tpu_torch.models import common

    shapes = []
    real = common.keep_mask
    monkeypatch.setattr(
        "pytorch_cifar_tpu_torch.models.efficientnet.keep_mask",
        lambda shape, keep: shapes.append(shape) or real(shape, keep))
    cfg = TrainConfig(
        model=NAME, batch_size=8, eval_batch_size=8, amp=False,
        synthetic_data=True, synthetic_train_size=16, synthetic_test_size=8,
        epochs=1, lr=0.01, device="cpu", output_dir=str(tmp_path),
    )
    trainer = Trainer(cfg)
    trainer.fit()
    (h,) = trainer.history
    assert h["train"]["count"] == 16 and h["eval"]["count"] == 8
    assert np.isfinite(h["train_loss"]) and h["train"]["nonfinite"] == 0
    per_step = [(8, 1, 1, 1)] * 9 + [(8, 320)]
    assert shapes == per_step * 2


def test_cli_trains_efficientnet_on_the_cpu(caplog, tmp_path):
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--model", NAME, "--synthetic_data",
        "--synthetic_train_size", "32", "--synthetic_test_size", "16",
        "--batch_size", "16", "--eval_batch_size", "16", "--epochs", "1",
        "--no-amp",
        "--output_dir", str(tmp_path),
    ])
    (h,) = out["history"]
    assert h["train"]["count"] == 32 and h["train"]["nonfinite"] == 0
    assert "==> model EfficientNetB0" in caplog.text


@pytest.mark.parametrize("name", [NAME])
def test_engine_serves_the_zoo_models_under_load(name):
    check_engine_under_load(name)
