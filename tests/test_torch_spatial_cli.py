"""Spatial partitioning through the train CLI and the trainer.

- JAX's ``ValueError``s, message for message: the spatial product must
  divide the world, each factor the 32-pixel image, and ``spatial_w > 1``
  needs the device-resident data plane; the port's trainer raises the
  first in one process, and the CLI refuses a model it does not hold
  (one registered beside the registry's, which it holds whole) with
  ``NotImplementedError`` naming it before a rank starts.
- ``local_slab`` gives each rank the batch and height ranges of JAX's
  spatial sharding for its device, and the host loader's height slabs are
  the rows of the JAX loader's host-augmented global batch.
- LeNet through the train CLI on gloo ranks of the CPU: 2 ranks at
  ``--spatial_devices 2`` (a 5-row map cut 3 / 2), whose checkpoint a
  one-process ``--evaluate`` restores to the run's best accuracy and eval
  loss, and every rank holding the same history; 4 ranks at
  ``--spatial_devices 2 --spatial_w_devices 2``; 2 ranks on the host
  loader's height slabs (``--no-device_data --host_augment``); and the
  CLI's default model, SimpleDLA, on 2 ranks at ``--spatial_devices 2``.
"""

import os
import re

import numpy as np
import pytest

from pytorch_cifar_tpu.parallel.spatial import (
    make_spatial_mesh as jax_mesh,
    spatial_batch_sharding as jax_batch_sharding,
)
from pytorch_cifar_tpu_torch.config import TrainConfig
from pytorch_cifar_tpu_torch.data.pipeline import Dataloader, local_slab
from pytorch_cifar_tpu_torch.models import MODEL_REGISTRY
from pytorch_cifar_tpu_torch.models.resnet import BasicBlock, ResNet
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from pytorch_cifar_tpu_torch.train.trainer import (
    Trainer,
    check_spatial,
    device_data_plane,
)
from _torch_threads import torch_threads  # noqa: F401

LENET = ["--device", "cpu", "--model", "LeNet", "--synthetic_data",
         "--synthetic_train_size", "256", "--synthetic_test_size", "64",
         "--epochs", "1", "--batch_size", "32", "--eval_batch_size", "32",
         "--no-amp"]

CHECKS = {  # case: (TrainConfig fields, world)
    "world": (dict(spatial_devices=3), 8),
    "image": (dict(spatial_devices=3, num_devices=6), 6),
    "device_data": (dict(spatial_w_devices=2, device_data=False), 8),
}


def _jax_message(fields, tmp_path) -> str:
    from pytorch_cifar_tpu.config import TrainConfig as JaxTrainConfig
    from pytorch_cifar_tpu.train.trainer import Trainer as JaxTrainer

    cfg = JaxTrainConfig(model="LeNet", synthetic_data=True, epochs=1,
                         batch_size=32, output_dir=str(tmp_path), **fields)
    with pytest.raises(ValueError) as err:
        JaxTrainer(cfg)
    return str(err.value)


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_value_errors_are_jaxs(case, tmp_path):
    fields, world = CHECKS[case]
    want = _jax_message(fields, tmp_path)
    cfg = TrainConfig(model="LeNet", **fields)
    with pytest.raises(ValueError, match=f"^{re.escape(want)}$"):
        check_spatial(cfg, world, device_data_plane(cfg))


def test_one_process_trainer_refuses_a_spatial_run(tmp_path):
    with pytest.raises(ValueError, match="must divide the device count 1"):
        Trainer(TrainConfig(model="LeNet", synthetic_data=True,
                            spatial_devices=2, device="cpu",
                            output_dir=str(tmp_path)))


def test_cli_refuses_a_model_it_does_not_hold(tmp_path, monkeypatch):
    """Every registry name is held; a model registered beside them (a
    ResNet of one block a stage, as the lifecycle tests register it) is
    refused by name before a rank starts."""
    monkeypatch.setitem(
        MODEL_REGISTRY, "ResNetTiny",
        lambda num_classes=10: ResNet(BasicBlock, (1, 1, 1, 1), num_classes))
    argv = LENET + ["--num_devices", "2", "--spatial_devices", "2",
                    "--output_dir", str(tmp_path)]
    argv[argv.index("LeNet")] = "ResNetTiny"
    with pytest.raises(NotImplementedError, match="ResNetTiny"):
        train_main(argv)


@pytest.mark.parametrize("mesh", [(4, 2, 1), (2, 2, 2), (1, 8, 1)])
def test_local_slab_is_jaxs_device_box(mesh):
    """Rank r's batch and height ranges are the slices JAX's spatial
    sharding gives device r."""
    import jax

    shape = (16, 32, 32, 3)
    index = jax_batch_sharding(jax_mesh(*mesh)).devices_indices_map(shape)
    for r, dev in enumerate(jax.devices()):
        want = tuple((s.start or 0, shape[d] if s.stop is None else s.stop)
                     for d, s in enumerate(index[dev][:2]))
        assert local_slab(shape, r, 8, *mesh[1:]) == want


def test_host_loader_height_slabs_are_the_jax_batch():
    from pytorch_cifar_tpu.data.pipeline import Dataloader as JaxDataloader

    rs = np.random.RandomState(0)
    x = rs.randint(0, 256, (40, 32, 32, 3)).astype(np.uint8)
    y = rs.randint(0, 10, 40).astype(np.int32)
    kw = dict(batch_size=8, drop_last=False, seed=3, host_augment=True)
    want = [(np.asarray(a), np.asarray(b))
            for a, b in JaxDataloader(x, y, **kw).epoch(0)]
    for r in range(4):  # a (2, 2, 1) mesh: rows over 2, height over 2
        ((b0, b1), (h0, h1)) = local_slab((8, 32, 32, 3), r, 4, 2)
        got = list(Dataloader(x, y, device="cpu", shard=r, n_shards=4,
                              spatial=2, async_input=False, **kw).epoch(0))
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx.numpy(), wx[b0:b1, h0:h1])
            np.testing.assert_array_equal(gy.numpy(), wy[b0:b1])
    with pytest.raises(ValueError, match="host_augment"):
        Dataloader(x, y, batch_size=8, shard=0, n_shards=4, spatial=2,
                   device="cpu")


def _eval_loss(trainer):
    """A rank hook: the restored state's eval loss."""
    return trainer.eval_epoch(0)[0]


def _same_history(ranks):
    """Every rank logged the same metrics and best accuracy."""
    keys = ("train", "eval", "train_loss", "eval_loss", "eval_acc")
    for r in ranks[1:]:
        assert [{k: h[k] for k in keys} for h in r["history"]] == [
            {k: h[k] for k in keys} for h in ranks[0]["history"]]
        assert r["best_acc"] == ranks[0]["best_acc"]


def test_lenet_cli_run_is_restored_by_one_process(tmp_path):
    out = str(tmp_path / "run")
    res = train_main(LENET + ["--num_devices", "2", "--spatial_devices",
                              "2", "--output_dir", out])
    ranks = res["ranks"]
    assert [r["world"] for r in ranks] == [2, 2]
    _same_history(ranks)
    h = ranks[0]["history"][0]
    assert h["train"]["count"] == 256 and h["eval"]["count"] == 64
    assert np.isfinite(h["train_loss"])
    assert os.path.exists(os.path.join(out, "ckpt.json"))
    one = train_main(LENET + ["--evaluate", "--output_dir", out],
                     rank_hook=_eval_loss)
    assert one["ranks"][0]["world"] == 1
    assert one["best_acc"] == res["best_acc"] == h["eval_acc"]
    np.testing.assert_allclose(one["ranks"][0]["hook"], h["eval_loss"],
                               rtol=1e-5)


def test_lenet_cli_cuts_height_and_width(tmp_path):
    res = train_main(LENET + ["--num_devices", "4", "--spatial_devices",
                              "2", "--spatial_w_devices", "2",
                              "--output_dir", str(tmp_path)])
    _same_history(res["ranks"])
    h = res["ranks"][0]["history"][0]
    assert h["train"]["count"] == 256 and h["eval"]["count"] == 64
    assert np.isfinite(h["train_loss"]) and 0.0 <= res["best_acc"] <= 100.0


def test_default_model_cli_trains_on_two_ranks(tmp_path):
    """No ``--model``: the CLI's default, SimpleDLA, trains at
    ``--spatial_devices 2`` on two gloo ranks, which log the same
    history."""
    argv = [a for a in LENET if a not in ("--model", "LeNet")]
    for flag, value in (("--synthetic_train_size", "32"),
                        ("--synthetic_test_size", "16"),
                        ("--batch_size", "16"), ("--eval_batch_size", "16")):
        argv[argv.index(flag) + 1] = value
    res = train_main(argv + ["--num_devices", "2", "--spatial_devices", "2",
                             "--output_dir", str(tmp_path)])
    ranks = res["ranks"]
    assert [r["world"] for r in ranks] == [2, 2]
    _same_history(ranks)
    h = ranks[0]["history"][0]
    assert h["train"]["count"] == 32 and h["eval"]["count"] == 16
    assert np.isfinite(h["train_loss"]) and np.isfinite(h["eval_loss"])


def test_lenet_cli_on_host_loader_height_slabs(tmp_path):
    res = train_main(LENET + ["--num_devices", "2", "--spatial_devices",
                              "2", "--no-device_data", "--host_augment",
                              "--output_dir", str(tmp_path)])
    _same_history(res["ranks"])
    h = res["ranks"][0]["history"][0]
    assert h["train"]["count"] == 256 and h["eval"]["count"] == 64
    assert np.isfinite(h["train_loss"])
