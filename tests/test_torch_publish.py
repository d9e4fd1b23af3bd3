"""The port's staging, quarantine and promotion (``train/checkpoint.py``)
against the JAX package's.

- For the same staging dir and ``extra_meta``, the port's and JAX's
  ``publish_checkpoint`` write byte-identical live pairs (a v2 candidate
  and a v3 one reassembled from its shards), the same ``.prev`` rollback
  pair on the next publish, and ``restore_previous_publish`` puts back
  the same bytes.
- A corrupt candidate is refused by both; no rollback pair is a False in
  both.
- Tombstones carry the same fields (``at`` aside), and
  ``is_staging_dir``/``is_quarantined`` agree on a table of cases.
- Cross-package: a JAX-staged publish is promoted by the port's
  controller.
"""

import json
import os

import numpy as np
import pytest

from _torch_ckpt import jax_state
from _torch_lifecycle import JAX, PKGS, PORT, pair_bytes, save
from _torch_threads import torch_threads  # noqa: F401

CKPT = "ckpt.msgpack"
EXTRA = {"promotion": {"generation": 3, "promoted_at": 1234.5,
                       "shadow_requests": 7}}


def _staging(root, shards):
    staging = PORT.ckpt.ensure_staging_dir(str(root))
    from _torch_ckpt import random_port_state

    PORT.ckpt.save_checkpoint(staging, random_port_state("LeNet", 1), 4,
                              41.5, num_shards=shards)
    return staging


@pytest.mark.parametrize("shards", [None, 2])
def test_publish_and_rollback_write_the_same_bytes(tmp_path, shards):
    staging = _staging(tmp_path / "src", shards)
    second = str(tmp_path / "second")
    save(second, 2, 6, 55.0)
    lives = {}
    for pkg in PKGS:
        live = str(tmp_path / pkg.name)
        path = pkg.ckpt.publish_checkpoint(staging, live, extra_meta=EXTRA)
        assert path == os.path.join(live, CKPT)
        lives[pkg.name] = live
    first = pair_bytes(lives["jax"])
    assert pair_bytes(lives["port"]) == first
    meta = json.loads(first[1])
    assert (meta["epoch"], meta["best_acc"]) == (4, 41.5)
    assert meta["promotion"] == EXTRA["promotion"]
    # the next publish keeps the incumbent as the .prev pair
    for pkg in PKGS:
        pkg.ckpt.publish_checkpoint(second, lives[pkg.name])
    prev = PORT.ckpt.prev_publish_name(CKPT)
    assert prev == JAX.ckpt.prev_publish_name(CKPT) == "ckpt.prev.msgpack"
    assert pair_bytes(lives["port"], prev) == pair_bytes(lives["jax"], prev)
    assert pair_bytes(lives["port"], prev) == first
    assert pair_bytes(lives["port"]) == pair_bytes(lives["jax"])
    for pkg in PKGS:
        assert pkg.ckpt.restore_previous_publish(lives[pkg.name]) is True
        assert pair_bytes(lives[pkg.name]) == first


@pytest.mark.parametrize("pkg", PKGS, ids=str)
def test_corrupt_candidate_is_never_published(tmp_path, pkg):
    staging = _staging(tmp_path / "src", None)
    PORT.faults.bitflip_file(os.path.join(staging, CKPT))
    live = str(tmp_path / "live")
    with pytest.raises(pkg.ckpt.CheckpointCorrupt):
        pkg.ckpt.publish_checkpoint(staging, live)
    assert not os.path.exists(os.path.join(live, CKPT))
    assert pkg.ckpt.restore_previous_publish(live) is False
    with pytest.raises(FileNotFoundError):
        pkg.ckpt.publish_checkpoint(str(tmp_path / "nothing"), live)


def test_tombstones_carry_the_same_fields(tmp_path):
    staging = _staging(tmp_path / "src", None)
    tombs = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg.name)
        os.makedirs(d)
        for f in (CKPT, "ckpt.json"):
            with open(os.path.join(staging, f), "rb") as src, \
                    open(os.path.join(d, f), "wb") as dst:
                dst.write(src.read())
        path = pkg.ckpt.quarantine_checkpoint(
            d, CKPT, "canary said no", extra={"generation": 2})
        assert path == os.path.join(d, "ckpt.quarantined.json")
        with open(path) as f:
            tomb = json.load(f)
        assert isinstance(tomb.pop("at"), float)
        tombs[pkg.name] = tomb
        assert pkg.ckpt.read_quarantine(d, CKPT)["reason"] == "canary said no"
    assert tombs["port"] == tombs["jax"]
    assert list(tombs["port"]) == ["reason", "epoch", "best_acc",
                                   "fingerprint", "generation"]
    assert tombs["port"]["fingerprint"]["size"] > 0


def _case(root, kind):
    """A directory in one of the table's states."""
    d = os.path.join(str(root), kind)
    if kind == "staging_named":
        d = os.path.join(d, "staging")
    os.makedirs(d, exist_ok=True)
    if kind == "marker":
        PORT.ckpt.ensure_staging_dir(d)
        d = os.path.join(d, "staging")
    if kind in ("plain", "tomb_current", "tomb_stale", "tomb_no_fp",
                "tomb_v1_sidecar", "tomb_v3"):
        save(d, 0, 1, 10.0)
    if kind == "tomb_v3":
        from _torch_ckpt import random_port_state

        PORT.ckpt.save_checkpoint(d, random_port_state("LeNet", 3), 1, 10.0,
                                  num_shards=2)
    if kind.startswith("tomb"):
        PORT.ckpt.quarantine_checkpoint(d, CKPT, "no")
    if kind == "tomb_stale":
        save(d, 5, 2, 20.0)  # a NEW publish: the old tombstone is inert
    if kind == "tomb_no_fp":
        p = PORT.ckpt.quarantine_path(d, CKPT)
        with open(p) as f:
            t = json.load(f)
        t["fingerprint"] = None
        with open(p, "w") as f:
            json.dump(t, f)
    if kind == "tomb_v1_sidecar":
        mp = PORT.ckpt.meta_path(d, CKPT)
        with open(mp) as f:
            m = json.load(f)
        m.pop("manifest")
        with open(mp, "w") as f:
            json.dump(m, f)
    return d


CASES = ["plain", "marker", "staging_named", "tomb_current", "tomb_stale",
         "tomb_no_fp", "tomb_v1_sidecar", "tomb_v3", "missing_dir"]


def test_staging_and_quarantine_predicates_agree(tmp_path):
    table = {}
    for kind in CASES:
        d = _case(tmp_path, kind) if kind != "missing_dir" else str(
            tmp_path / "nope")
        row = {}
        for pkg in PKGS:
            row[pkg.name] = (
                pkg.ckpt.is_staging_dir(d),
                pkg.ckpt.is_quarantined(d, CKPT),
                pkg.ckpt.publish_fingerprint(
                    PORT.ckpt.read_meta(d, CKPT)),
                pkg.ckpt.staging_dir(d), pkg.ckpt.quarantine_path(d, CKPT),
            )
        assert row["port"] == row["jax"], kind
        table[kind] = row["port"][:2]
    assert table == {
        "plain": (False, False), "marker": (True, False),
        "staging_named": (True, False), "tomb_current": (False, True),
        "tomb_stale": (False, False), "tomb_no_fp": (False, True),
        "tomb_v1_sidecar": (False, True), "tomb_v3": (False, True),
        "missing_dir": (False, False),
    }


def test_jax_staged_publish_is_promoted_by_the_port(tmp_path):
    """A JAX trainer state committed into staging by the JAX package's
    ``save_checkpoint`` is vetted and promoted by the port's controller;
    the promoted payload is the staged one and the port's engine serves
    it as the JAX engine does."""
    from pytorch_cifar_tpu.train.checkpoint import save_checkpoint

    live = str(tmp_path / "live")
    save(live, 0, 0, 5.0)
    staging = JAX.ckpt.ensure_staging_dir(live)
    save_checkpoint(staging, jax_state("LeNet", seed=4), epoch=3,
                    best_acc=33.0)
    ctl = PORT.serve.PromotionController(
        PORT.engine(live), staging, live,
        golden=PORT.serve.GoldenSet.random(16, seed=3),
        budget=PORT.serve.CanaryBudget(max_flip_frac=1.0))
    assert ctl.poll_once() == "promoted"
    meta = PORT.ckpt.read_meta(live, CKPT)
    assert meta["epoch"] == 3 and meta["promotion"]["generation"] == 1
    assert pair_bytes(live)[0] == pair_bytes(staging)[0]
    x = np.random.RandomState(0).randint(
        0, 256, size=(3, 32, 32, 3)).astype(np.uint8)
    np.testing.assert_allclose(PORT.engine(live).predict(x),
                               JAX.engine(live).predict(x),
                               rtol=1e-4, atol=1e-5)
