"""The training slice's data, loss, optimizer and config against the JAX
package, on the same numpy inputs.

Augmentation draws come from a JAX key exactly as ``augment.py`` draws
them and are handed to both sides; the data plane's host permutation
stream, the synthetic set and the archive readers must give the same
arrays; the masked cross-entropy and three SGD updates under the cosine
schedule are held against the JAX functions and the optax chain.
"""

import collections
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_cifar_tpu.data import augment as jax_augment
from pytorch_cifar_tpu.data import cifar10 as jax_cifar10
from pytorch_cifar_tpu.data.pipeline import DeviceDataset as JaxDeviceDataset
from pytorch_cifar_tpu.train import optim as jax_optim
from pytorch_cifar_tpu.train import steps as jax_steps
from pytorch_cifar_tpu_torch.config import check_ported, parse_config
from pytorch_cifar_tpu_torch.data import augment, cifar10
from pytorch_cifar_tpu_torch.data.pipeline import DeviceDataset
from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.train import optim, steps
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from _torch_threads import torch_threads  # noqa: F401

# -- augmentation --------------------------------------------------------


def _draws(key, n, padding=4):
    """Offsets and flip bits exactly as crop_flip_onehot draws them."""
    kc, kf = jax.random.split(key)
    offs = jax.random.randint(kc, (n, 2), 0, 2 * padding + 1)
    flips = jax.random.bernoulli(kf, 0.5, (n,))
    return (torch.tensor(np.asarray(offs), dtype=torch.long),
            torch.tensor(np.asarray(flips)))


@pytest.mark.parametrize("flip", [True, False])
def test_crop_flip_bit_exact_vs_onehot(flip):
    x = np.random.RandomState(0).randint(0, 256, (16, 32, 32, 3)).astype(
        np.uint8
    )
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_augment.crop_flip_onehot(key, jnp.asarray(x),
                                                   flip=flip))
    offs, flips = _draws(key, 16)
    got = augment.crop_flip(torch.from_numpy(x), offs,
                            flips if flip else None)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize(
    "crop,flip,dtype",
    [(True, True, "fp32"), (True, True, "bf16"), (False, True, "fp32"),
     (False, False, "fp32")],
)
def test_augment_batch_bit_exact(crop, flip, dtype):
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "fp32"
                else (torch.bfloat16, jnp.bfloat16))
    x = np.random.RandomState(1).randint(0, 256, (8, 32, 32, 3)).astype(
        np.uint8
    )
    key = jax.random.PRNGKey(11)
    want = jax_augment.augment_batch(key, jnp.asarray(x), crop=crop,
                                     flip=flip, dtype=jdt)
    offs, flips = _draws(key, 8)
    got = augment.augment_batch(torch.from_numpy(x), offs, flips, crop=crop,
                                flip=flip, dtype=tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32))
    )


def test_random_hflip_matches_jax():
    x = np.random.RandomState(2).randint(0, 256, (6, 4, 5, 3)).astype(
        np.uint8
    )
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_augment.random_hflip(key, jnp.asarray(x)))
    flips = torch.tensor(np.asarray(jax.random.bernoulli(key, 0.5, (6,))))
    got = augment.random_hflip(torch.from_numpy(x), flips)
    np.testing.assert_array_equal(got.numpy(), want)


# -- dataset -------------------------------------------------------------


def test_synthetic_cifar10_same_arrays():
    for a, b in zip(cifar10.synthetic_cifar10(64, 32, seed=3),
                    jax_cifar10.synthetic_cifar10(64, 32, seed=3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _write_archive(root, layout):
    """A small archive in the python-pickle or binary layout."""
    rs = np.random.RandomState(4)
    d = root / ("cifar-10-batches-py" if layout == "py"
                else "cifar-10-batches-bin")
    d.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        x = rs.randint(0, 256, (5, 3072)).astype(np.uint8)
        y = [int(v) for v in rs.randint(0, 10, 5)]
        if layout == "py":
            with open(d / name, "wb") as f:
                pickle.dump({b"data": x, b"labels": y}, f, protocol=2)
        else:
            recs = np.concatenate(
                [np.asarray(y, np.uint8)[:, None], x], axis=1
            )
            (d / f"{name}.bin").write_bytes(recs.tobytes())


@pytest.mark.parametrize("layout", ["py", "bin"])
def test_load_cifar10_reads_the_archive_like_jax(tmp_path, monkeypatch,
                                                 layout):
    monkeypatch.delenv("CIFAR10_PATH", raising=False)
    _write_archive(tmp_path, layout)
    got = cifar10.load_cifar10(str(tmp_path))
    want = jax_cifar10.load_cifar10(str(tmp_path))
    assert got[0].shape == (25, 32, 32, 3) and got[2].shape == (5, 32, 32, 3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_cifar10_refuses_foreign_pickles(tmp_path, monkeypatch):
    monkeypatch.delenv("CIFAR10_PATH", raising=False)
    _write_archive(tmp_path, "py")
    with open(tmp_path / "cifar-10-batches-py" / "test_batch", "wb") as f:
        pickle.dump({b"data": np.zeros((1, 3072), np.uint8),
                     b"labels": [0], b"x": collections.OrderedDict}, f)
    with pytest.raises(pickle.UnpicklingError):
        cifar10.load_cifar10(str(tmp_path))


def test_missing_dataset_raises_not_silent_synthetic(tmp_path, monkeypatch):
    monkeypatch.delenv("CIFAR10_PATH", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="synthetic_data"):
        cifar10.load_cifar10(str(tmp_path))


@pytest.mark.parametrize("n,batch,drop_last", [(20, 8, False), (20, 8, True),
                                               (16, 8, False)])
def test_host_permutation_stream_matches_jax(n, batch, drop_last):
    """device_perm=False: the same extended permutation as the JAX
    DeviceDataset for every epoch (wrap-padded tail included)."""
    rs = np.random.RandomState(5)
    x = rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    y = rs.randint(0, 10, n).astype(np.int32)
    ours = DeviceDataset(x, y, batch, drop_last=drop_last, seed=9,
                         device="cpu")
    theirs = JaxDeviceDataset(x, y, batch, drop_last=drop_last, seed=9)
    assert len(ours) == len(theirs)
    for epoch in range(3):
        perm = ours.staged_perm(epoch)
        assert perm.dtype == torch.int32
        np.testing.assert_array_equal(
            perm.numpy(), np.asarray(theirs.staged_perm(epoch))
        )
        for (xa, ya), (xb, yb) in zip(ours.epoch(epoch), theirs.epoch(epoch)):
            np.testing.assert_array_equal(xa.numpy(), np.asarray(xb))
            np.testing.assert_array_equal(ya.numpy(), np.asarray(yb))


def test_eval_order_is_identity_and_device_perm_is_a_permutation():
    x = np.zeros((20, 32, 32, 3), np.uint8)
    y = np.arange(20, dtype=np.int32)
    ev = DeviceDataset(x, y, 8, shuffle=False, device="cpu")
    np.testing.assert_array_equal(ev.staged_perm(0).numpy(),
                                  np.arange(24) % 20)
    _, labels = list(ev.epoch(0))[-1]
    np.testing.assert_array_equal(labels.numpy(), [16, 17, 18, 19] + [-1] * 4)
    dp = DeviceDataset(x, y, 8, seed=1, device_perm=True, device="cpu")
    p0, p0b, p1 = (dp.staged_perm(e).numpy() for e in (0, 0, 1))
    assert sorted(p0[:20]) == list(range(20))
    np.testing.assert_array_equal(p0[20:], p0[:4])  # wrap rule
    np.testing.assert_array_equal(p0, p0b)  # (seed, epoch)-deterministic
    assert not np.array_equal(p0, p1)


# -- loss and optimizer --------------------------------------------------


def test_cross_entropy_sums_mask_padding():
    rs = np.random.RandomState(6)
    logits = rs.standard_normal((9, 10)).astype(np.float32) * 3
    labels = rs.randint(0, 10, 9).astype(np.int32)
    labels[[2, 7]] = -1
    want = jax_steps.cross_entropy_sums(jnp.asarray(logits),
                                        jnp.asarray(labels))
    got = steps.cross_entropy_sums(torch.from_numpy(logits),
                                   torch.from_numpy(labels))
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-6)
    assert int(got[1]) == int(want[1]) == 7
    jm = jax_steps._metrics(jnp.asarray(logits), jnp.asarray(labels))
    pm = steps._metrics(torch.from_numpy(logits), torch.from_numpy(labels))
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-6)


def test_sgd_cosine_matches_optax_chain():
    """Three updates of coupled-decay momentum SGD with the per-epoch
    cosine (one step per epoch, t_max 3, so the rate changes every update)
    against the JAX package's optax chain, same params and gradients."""
    rs = np.random.RandomState(7)
    params = {k: rs.standard_normal(s).astype(np.float32)
              for k, s in (("w", (4, 3)), ("b", (3,)))}
    grads = [{k: rs.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = jax_optim.make_optimizer(lr=0.1, t_max=3, steps_per_epoch=1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = optim.make_optimizer(tp.values(), lr=0.1)
    schedule = optim.cosine_epoch_schedule(0.1, 3, 1)
    for step, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        optim.set_lr(opt, schedule(step))
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


def test_cosine_schedule_matches_jax():
    js = jax_optim.cosine_epoch_schedule(0.1, 5, 4)
    ps = optim.cosine_epoch_schedule(0.1, 5, 4)
    for step in range(0, 24, 3):
        np.testing.assert_allclose(ps(step), float(js(step)), rtol=1e-6)


# -- config --------------------------------------------------------------


def test_config_flags_keep_the_jax_spellings():
    cfg = parse_config([
        "--model", "LeNet", "--no-dma_gather", "--cosine_t_max", "2",
        "--no-amp", "--batch_size", "64", "--mean", "0.5", "0.5", "0.5",
        "--device", "cpu", "--no-device_perm", "--synthetic_data",
    ])
    assert (cfg.model, cfg.dma_gather, cfg.t_max, cfg.amp) == (
        "LeNet", False, 2, False
    )
    assert cfg.mean == (0.5, 0.5, 0.5) and cfg.batch_size == 64
    assert cfg.device == "cpu" and not cfg.device_perm
    defaults = parse_config([])
    assert defaults.dma_gather and defaults.device_perm and defaults.amp
    assert defaults.device == "cuda" and defaults.t_max == defaults.epochs


@pytest.mark.parametrize("argv", [["--publish", "staging"],
                                  ["--resume", "--publish", "staging"]])
def test_unported_paths_say_so(argv):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        check_ported(parse_config(argv))


@pytest.mark.parametrize("argv", [["--no-device_data", "--num_devices", "2"],
                                  ["--no-device_data"]])
def test_host_loader_paths_are_ported(argv, tmp_path):
    """The host loader trains through the CLI, on one process and as a
    spawned gloo pair: every image once per epoch on every rank's global
    totals, the ranks agreeing, a finite loss."""
    check_ported(parse_config(argv))
    out = train_main(argv + [
        "--device", "cpu", "--model", "LeNet", "--synthetic_data",
        "--epochs", "1", "--no-amp", "--synthetic_train_size", "200",
        "--synthetic_test_size", "60", "--batch_size", "32",
        "--eval_batch_size", "32", "--output_dir", str(tmp_path),
    ])
    assert len(out["ranks"]) == (2 if "--num_devices" in argv else 1)
    for r in out["ranks"]:
        (h,) = r["history"]
        assert h["train"]["count"] == 200 and h["eval"]["count"] == 60
        assert np.isfinite(h["train_loss"])
        assert h["train"] == out["ranks"][0]["history"][0]["train"]


@pytest.mark.parametrize("argv", [["--resume"], ["--evaluate"],
                                  ["--publish", "live"]])
def test_checkpoint_paths_are_ported(argv):
    check_ported(parse_config(argv))


def test_unported_models_say_so():
    """No registry name is left unported: the port's registry is the JAX
    package's, and an unknown name raises ``KeyError`` naming them."""
    from pytorch_cifar_tpu.models import available_models as jax_models
    from pytorch_cifar_tpu_torch.models import available_models

    assert available_models() == jax_models()
    with pytest.raises(KeyError, match="DenseNet121"):
        create_model("NoSuchNet")


def test_unported_step_options_raise():
    """Spatial partitioning is the one step option not ported (remat is:
    ``tests/test_torch_remat.py``)."""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        steps.make_train_epoch(None, 8, 20, 3, batch_sharding=object())
    with pytest.raises(NotImplementedError, match="not ported yet"):
        steps.make_eval_epoch(None, 8, 20, 3, label_sharding=object())
