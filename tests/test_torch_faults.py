"""The port's fault hooks (``faults.py``) against the JAX package's.

- The registry: ``inject``/``get``/``is_active``/``maybe_raise`` with a
  ``times`` budget, and ``PCT_FAULTS`` parsed as the JAX package parses
  it, so one chaos harness arms either package.
- File damage: ``truncate_file``, ``bitflip_file`` and
  ``regress_checkpoint`` (perturbed and NaN-poisoned) leave the same bytes
  as the JAX functions on copies of one checkpoint.
- ``ckpt_regress`` armed during a save publishes the JAX save's bytes for
  the same state (the same seed and draw order); ``ckpt_write_stall``
  sleeps after the payload and before its sidecar.
- ``serve_error`` fails one batch of the micro-batcher and no other.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu import faults as jax_faults
from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch import faults
from pytorch_cifar_tpu_torch.compat import load_train_tree
from pytorch_cifar_tpu_torch.serve import InferenceEngine, MicroBatcher
from pytorch_cifar_tpu_torch.train import checkpoint as ckpt
from _torch_ckpt import jax_state, port_state
from _torch_threads import torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def _both_from_env(monkeypatch, spec):
    """Both registries re-read ``PCT_FAULTS`` = ``spec``."""
    monkeypatch.setenv(faults.ENV_VAR, spec)
    for mod in (faults, jax_faults):
        mod._active.clear()
        monkeypatch.setattr(mod, "_env_loaded", False)


@pytest.mark.parametrize("spec", [
    "nan_loss=3", "serve_error;nan_loss=7", "ckpt_regress, nan_loss=-1",
    "ckpt_write_stall=250;serve_error", "nan_loss=x;;",
])
def test_pct_faults_parses_as_the_jax_package(monkeypatch, spec):
    _both_from_env(monkeypatch, spec)
    assert faults.ENV_VAR == jax_faults.ENV_VAR == "PCT_FAULTS"
    for name in ("nan_loss", "serve_error", "ckpt_regress",
                 "ckpt_write_stall", "absent"):
        assert faults.get(name) == jax_faults.get(name), name
        assert faults.is_active(name) == jax_faults.is_active(name), name
    if faults.get("nan_loss") not in (None, "x"):
        assert faults.nan_loss_step() == jax_faults.nan_loss_step()
    assert faults.ckpt_regress_scale() == jax_faults.ckpt_regress_scale()


def test_registry_budget_and_clear():
    faults.inject("serve_error", times=2)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="injected fault"):
            faults.maybe_raise("serve_error")
    faults.maybe_raise("serve_error")  # the budget is spent
    assert not faults.is_active("serve_error")
    faults.inject("nan_loss", 4)
    faults.inject("ckpt_regress", 50)
    assert (faults.nan_loss_step(), faults.ckpt_regress_scale()) == (4, 0.5)
    faults.clear("nan_loss")
    assert faults.nan_loss_step() is None and faults.is_active("ckpt_regress")
    faults.clear()
    assert faults.ckpt_regress_scale() is None


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """A v2 checkpoint of a JAX-drawn LeNet state, written by the port."""
    d = tmp_path_factory.mktemp("published")
    ps = port_state("LeNet")
    load_train_tree(ps, _payload_tree(jax_state("LeNet", seed=3)))
    ckpt.save_checkpoint(str(d), ps, 2, 40.0)
    return str(d), ps


def _payload_tree(js):
    return jax.device_get(
        {"params": js.params, "batch_stats": js.batch_stats,
         "opt_state": {"0": {}, "1": {"trace": js.opt_state[1].trace},
                       "2": {"count": js.opt_state[2].count}},
         "step": js.step})


def _copies(src, dst_root):
    out = []
    for tag in ("port", "jax"):
        d = os.path.join(dst_root, tag)
        shutil.copytree(src, d)
        out.append(d)
    return out


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "bitflip_at",
                                    "regress", "regress_nan"])
def test_file_damage_is_the_jax_damage(published, tmp_path, damage):
    mine, theirs = _copies(published[0], str(tmp_path))
    for mod, d in ((faults, mine), (jax_faults, theirs)):
        path = os.path.join(d, ckpt.CKPT_NAME)
        if damage == "truncate":
            assert mod.truncate_file(path, 0.3) == int(
                os.path.getsize(os.path.join(published[0], ckpt.CKPT_NAME))
                * 0.3)
        elif damage == "bitflip":
            mod.bitflip_file(path)
        elif damage == "bitflip_at":
            assert mod.bitflip_file(path, offset=17) == 17
        else:
            mod.regress_checkpoint(d, scale=0.5, seed=4,
                                   nan=damage == "regress_nan")
    assert _files(mine) == _files(theirs)
    if damage.startswith("regress"):
        # the manifest was recomputed: the damage is invisible to the CRC
        ckpt.read_verified_payload(mine, ckpt.CKPT_NAME,
                                   ckpt.read_meta(mine, ckpt.CKPT_NAME))


def test_regress_checkpoint_refuses_a_sharded_one(published, tmp_path):
    ckpt.save_checkpoint(str(tmp_path), published[1], 1, 1.0,
                         name=ckpt.LAST_NAME, num_shards=2)
    with pytest.raises(ValueError, match="single-payload"):
        faults.regress_checkpoint(str(tmp_path), name=ckpt.LAST_NAME)


def test_ckpt_regress_publishes_the_jax_bytes(published, tmp_path):
    faults.inject("ckpt_regress", 70)
    jax_faults.inject("ckpt_regress", 70)
    ckpt.save_checkpoint(str(tmp_path / "port"), published[1], 2, 40.0)
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"),
                             jax_state("LeNet", seed=3), 2, 40.0)
    mine = _files(str(tmp_path / "port"))
    assert mine == _files(str(tmp_path / "jax"))
    assert mine[ckpt.CKPT_NAME] != _files(published[0])[ckpt.CKPT_NAME]


def test_ckpt_write_stall_sleeps_between_payload_and_sidecar(
        published, tmp_path, monkeypatch):
    faults.inject("ckpt_write_stall", 250)
    seen = []

    def sleep(s):
        seen.append((s, os.path.exists(tmp_path / ckpt.CKPT_NAME),
                     os.path.exists(tmp_path / "ckpt.json")))

    monkeypatch.setattr(ckpt.time, "sleep", sleep)
    ckpt.save_checkpoint(str(tmp_path), published[1], 2, 40.0)
    assert seen == [(0.25, True, False)]
    with open(tmp_path / "ckpt.json") as f:
        assert json.load(f)["epoch"] == 2


def test_serve_error_fails_one_batch_only():
    engine = InferenceEngine.from_random(
        "LeNet", seed=0, buckets=(1, 4), compute_dtype=torch.float32,
        device="cpu")
    x = np.random.RandomState(0).randint(0, 256, (2, 32, 32, 3)).astype(
        np.uint8)
    want = engine.predict(x)
    faults.inject("serve_error", times=1)
    batcher = MicroBatcher(engine, max_wait_ms=0.0)
    try:
        with pytest.raises(RuntimeError, match="injected fault"):
            batcher.submit(x).result(timeout=30)
        for _ in range(2):
            np.testing.assert_array_equal(
                batcher.submit(x).result(timeout=30), want)
    finally:
        batcher.close()
