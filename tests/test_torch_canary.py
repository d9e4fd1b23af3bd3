"""The port's canary promotion controller (``serve/canary.py``) against the
JAX package's, one case per ``tests/test_canary.py`` test.

Each case runs the same scenario through both packages, on the same
checkpoint files (written once by the port's ``save_checkpoint``), with
the same golden images and budget, and holds the port to JAX's outcome:
the same verdicts in the same order, the same tombstone reasons, the same
promotion generation, the same live-dir bytes. Both packages' engines are
fp32 LeNet on the CPU. Beside them: a candidate with a NaN in one BN
variance of a fused conv3x3+BN+ReLU site (ResNetTiny) is quarantined as
"nonfinite" by both packages, and the plain fused op keeps a NaN where
JAX's does.
"""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.ops import conv_bn_relu as jax_k3
from pytorch_cifar_tpu_torch.ops import conv_bn_relu as k3
from _torch_lifecycle import (
    JAX,
    K3_SITE_VAR,
    PKGS,
    PORT,
    images,
    read_bytes,
    register_resnet_tiny,
    save,
)
from _torch_threads import torch_threads  # noqa: F401

CKPT = "ckpt.msgpack"


@pytest.fixture(autouse=True)
def _clean_faults():
    for p in PKGS:
        p.faults.clear()
    yield
    for p in PKGS:
        p.faults.clear()


def _pipeline(pkg, root, seed=0, epoch=1, best_acc=10.0, model="LeNet",
              **ctl_kw):
    """A live dir with an incumbent, its staging dir, and ``pkg``'s
    controller whose canary engine holds the incumbent."""
    live = os.path.join(str(root), pkg.name, "live")
    save(live, seed, epoch, best_acc, model=model)
    staging = pkg.ckpt.ensure_staging_dir(live)
    golden = ctl_kw.pop("golden", None) or pkg.serve.GoldenSet.random(
        16, seed=3)
    budget = pkg.serve.CanaryBudget(**ctl_kw.pop("budget", {
        "max_flip_frac": 1.0}))
    ctl = pkg.serve.PromotionController(
        pkg.engine(live, model=model), staging, live, golden=golden,
        budget=budget, **ctl_kw)
    return live, staging, ctl


def _tomb(pkg, staging):
    t = pkg.ckpt.read_quarantine(staging, CKPT)
    return None if t is None else {k: v for k, v in t.items() if k != "at"}


def _both(scenario, tmp_path, **kw):
    """``scenario(pkg, root)`` for both packages; their outcomes must be
    equal. Returns the port's."""
    out = {p.name: scenario(p, tmp_path, **kw) for p in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


# -- state machine: promote / quarantine ---------------------------------


def test_good_candidate_promotes_with_generation_stamp(tmp_path):
    def scenario(pkg, root):
        live, staging, ctl = _pipeline(pkg, root)
        first = ctl.poll_once()
        save(staging, 7, 2, 20.0)
        verdict = ctl.poll_once()
        with open(pkg.ckpt.meta_path(live, CKPT)) as f:
            meta = json.load(f)
        x = images(3, 0)
        same = bool(np.array_equal(pkg.engine(live).predict(x),
                                   ctl.engine.predict(x)))
        return (first, verdict, ctl.generation, ctl.state, meta["epoch"],
                meta["promotion"]["generation"], same, ctl.poll_once())

    assert _both(scenario, tmp_path) == (
        None, "promoted", 1, "promoted", 2, 1, True, None)


def test_identical_candidate_diffs_exactly_zero(tmp_path):
    def scenario(pkg, root):
        live, staging, ctl = _pipeline(pkg, root, seed=5)
        save(staging, 5, 2, 20.0)
        verdict = ctl.poll_once()
        g = ctl._candidate["golden"]
        return verdict, g["flips"], g["identical_rows"], len(ctl.golden)

    assert _both(scenario, tmp_path) == ("promoted", 0, 16, 16)


def test_nan_candidate_quarantined_and_rolled_back_bit_exact(tmp_path):
    def scenario(pkg, root):
        live, staging, ctl = _pipeline(pkg, root)
        x = images(5, 1)
        pre = ctl.engine.predict(x)
        live_bytes = read_bytes(os.path.join(live, CKPT))
        save(staging, 9, 2, 30.0)
        pkg.faults.regress_checkpoint(staging, nan=True)
        verdict = ctl.poll_once()
        return (verdict, _tomb(pkg, staging),
                pkg.ckpt.is_quarantined(staging, CKPT),
                read_bytes(os.path.join(live, CKPT)) == live_bytes,
                bool(np.array_equal(ctl.engine.predict(x), pre)))

    verdict, tomb, quarantined, live_same, rolled_back = _both(
        scenario, tmp_path)
    assert verdict == "quarantined" and "nonfinite" in tomb["reason"]
    assert quarantined and live_same and rolled_back


def test_regressed_candidate_quarantined_by_flip_budget(tmp_path):
    def scenario(pkg, root):
        live, staging, ctl = _pipeline(pkg, root,
                                       budget={"max_flip_frac": 0.5})
        save(staging, 0, 2, 30.0)
        pkg.faults.regress_checkpoint(staging, scale=2.0)
        return ctl.poll_once(), _tomb(pkg, staging)

    verdict, tomb = _both(scenario, tmp_path)
    assert verdict == "quarantined" and "argmax flipped" in tomb["reason"]


def test_labeled_golden_judges_by_accuracy_not_flips(tmp_path):
    x = images(32, 2)
    b_dir = str(tmp_path / "b")
    save(b_dir, 8, 2, 50.0)
    # golden labels = candidate B's own argmax (from the JAX engine)
    labels = np.argmax(JAX.engine(b_dir).predict(x), axis=-1)

    def scenario(pkg, root):
        live, staging, ctl = _pipeline(
            pkg, root, golden=pkg.serve.GoldenSet(x, labels),
            budget={"max_flip_frac": 0.01, "acc_margin": 1.0})
        pkg.ckpt.publish_checkpoint(b_dir, staging)
        first = ctl.poll_once()  # flips galore, accuracy up
        save(staging, 8, 3, 60.0)
        pkg.faults.regress_checkpoint(staging, scale=2.0)
        return first, ctl.poll_once(), _tomb(pkg, staging)

    first, second, tomb = _both(scenario, tmp_path)
    assert (first, second) == ("promoted", "quarantined")
    assert "accuracy" in tomb["reason"]


def test_corrupt_candidate_quarantined_after_settle_grace(tmp_path):
    def scenario(pkg, root):
        live, staging, ctl = _pipeline(pkg, root)
        save(staging, 4, 2, 20.0)
        pkg.faults.bitflip_file(os.path.join(staging, CKPT))
        polls = (ctl.poll_once(), ctl.poll_once())
        tomb = _tomb(pkg, staging)
        reason = tomb.pop("reason")
        return polls, reason.split(":")[0], tomb

    polls, prefix, _ = _both(scenario, tmp_path)
    assert polls == (None, "quarantined") and prefix == "corrupt candidate"


def test_quarantined_publish_never_retried_new_candidate_is(tmp_path):
    def scenario(pkg, root):
        live, staging, ctl = _pipeline(pkg, root)
        save(staging, 9, 2, 30.0)
        pkg.faults.regress_checkpoint(staging, nan=True)
        first = ctl.poll_once()
        rejected = int(ctl.status()["rejected"])
        again = ctl.poll_once()
        save(staging, 6, 3, 40.0)
        return (first, rejected, again, int(ctl.status()["rejected"]),
                ctl.poll_once(), ctl.generation)

    assert _both(scenario, tmp_path) == (
        "quarantined", 1, None, 1, "promoted", 1)


def test_wrong_model_candidate_quarantined(tmp_path):
    """Another model's checkpoint in staging: quarantined at the swap gate
    by both (the port maps the tree while loading; the refusal and the
    reason's prefix are the same)."""
    def scenario(pkg, root):
        live, staging, ctl = _pipeline(pkg, root)
        save(staging, 0, 2, 20.0, model="ResNetTiny")
        verdict = ctl.poll_once()
        reason = _tomb(pkg, staging)["reason"]
        return verdict, reason.split(":")[0], ctl.state, ctl.generation

    assert _both(scenario, tmp_path) == (
        "quarantined", "wrong-model candidate", "quarantined", 0)


# -- shadow tee -----------------------------------------------------------


def test_shadow_budget_exhaustion_rolls_back(tmp_path):
    def scenario(pkg, root):
        live, staging, ctl = _pipeline(pkg, root, budget={
            "max_flip_frac": 1.0, "min_shadow_requests": 3,
            "max_shadow_flip_frac": 0.2})
        incumbent = pkg.engine(live)
        x = images(4, 5)
        pre = incumbent.predict(x)
        save(staging, 3, 2, 30.0)
        pkg.faults.regress_checkpoint(staging, scale=2.0)
        polls = [ctl.poll_once(), ctl.poll_once()]
        ctl.shadow_fraction = 1.0
        offers = [ctl.offer(x, incumbent.predict(x)) for _ in range(3)]
        drained = ctl.process_shadow_queue()
        polls.append(ctl.poll_once())
        return (polls, offers, drained, _tomb(pkg, staging)["reason"],
                bool(np.array_equal(ctl.engine.predict(x), pre)))

    polls, offers, drained, reason, rolled_back = _both(scenario, tmp_path)
    assert polls == ["shadowing", None, "quarantined"]
    assert offers == [True] * 3 and drained == 3 and rolled_back
    assert "shadow argmax flipped" in reason


def test_shadow_soak_promotes_within_budget(tmp_path):
    def scenario(pkg, root):
        live, staging, ctl = _pipeline(pkg, root, seed=2, budget={
            "max_flip_frac": 1.0, "min_shadow_requests": 2})
        incumbent = pkg.engine(live)
        x = images(3, 6)
        save(staging, 2, 2, 30.0)
        polls = [ctl.poll_once()]
        ctl.shadow_fraction = 1.0
        for _ in range(2):
            ctl.offer(x, incumbent.predict(x))
        drained = ctl.process_shadow_queue()
        polls.append(ctl.poll_once())
        return polls, drained, ctl.status()["shadow"]

    polls, drained, shadow = _both(scenario, tmp_path)
    assert polls == ["shadowing", "promoted"] and drained == 2
    assert shadow == {"requests": 2, "rows": 6, "flip_rows": 0,
                      "identical": 2, "errors": 0}


def test_shadow_tee_never_changes_client_response(tmp_path):
    def scenario(pkg, root):
        live, staging, ctl = _pipeline(pkg, root, shadow_fraction=1.0)
        engine = pkg.engine(live)
        batcher = pkg.serve.MicroBatcher(engine)
        backend = pkg.serve.ShadowBackend(
            pkg.serve.BatcherBackend(engine, batcher), ctl)
        save(staging, 4, 2, 20.0)
        ctl.budget = pkg.serve.CanaryBudget(max_flip_frac=1.0,
                                            min_shadow_requests=10)
        state = ctl.poll_once()
        x = images(3, 7)
        try:
            out = backend.predict(x)
            same = bool(np.array_equal(out, engine.predict(x)))
            first = ctl.process_shadow_queue()

            def boom(images):
                raise RuntimeError("canary replica down")

            ctl.engine.predict = boom
            out2 = backend.predict(x)
            return (state, same, first, bool(np.array_equal(out2, out)),
                    ctl.process_shadow_queue(),
                    ctl.status()["shadow"]["errors"],
                    ctl.offer(x, out, priority="bulk"),
                    backend.health()["canary"]["state"])
        finally:
            batcher.close()

    assert _both(scenario, tmp_path) == (
        "shadowing", True, 1, True, 1, 1, False, "shadowing")


def test_controller_stop_joins_all_threads(tmp_path):
    def scenario(pkg, root):
        live, staging, ctl = _pipeline(pkg, root, shadow_fraction=1.0)
        ctl.budget = pkg.serve.CanaryBudget(max_flip_frac=1.0,
                                            min_shadow_requests=100)
        save(staging, 4, 2, 20.0)
        state = ctl.poll_once()
        before = {t.name for t in threading.enumerate()}
        ctl.start()
        x = images(2, 8)
        inc = ctl.engine.predict(x)
        for _ in range(20):
            ctl.offer(x, inc)
        ctl.stop()
        after = {t.name for t in threading.enumerate()}
        ctl.stop()  # idempotent
        return state, sorted(n for n in after - before
                             if n.startswith("canary-"))

    assert _both(scenario, tmp_path) == ("shadowing", [])


# -- reload watcher: staging + quarantine refusal ------------------------


def test_watcher_refuses_staging_dir(tmp_path):
    def scenario(pkg, root):
        live = os.path.join(str(root), pkg.name)
        save(live, 0, 1, 10.0)
        eng = pkg.engine(live)
        staging = pkg.ckpt.ensure_staging_dir(live)
        save(staging, 7, 2, 20.0)
        watcher = pkg.serve.CheckpointWatcher(eng, staging, poll_s=3600)
        return (pkg.ckpt.is_staging_dir(staging), watcher.poll_once(),
                watcher.poll_once(), eng.version, watcher.reloads)

    assert _both(scenario, tmp_path) == (True, False, False, 0, 0)


def test_watcher_never_loads_quarantined_publish(tmp_path):
    def scenario(pkg, root):
        live = os.path.join(str(root), pkg.name)
        save(live, 0, 1, 10.0)
        eng = pkg.engine(live)
        watcher = pkg.serve.CheckpointWatcher(eng, live, poll_s=3600)
        save(live, 7, 2, 20.0)
        pkg.ckpt.quarantine_checkpoint(live, CKPT, "canary said no")
        out = [watcher.poll_once(), watcher.quarantined, eng.version,
               watcher.poll_once()]
        save(live, 5, 3, 30.0)
        out += [watcher.poll_once(), eng.version,
                watcher.last_meta["epoch"]]
        return out

    assert _both(scenario, tmp_path) == [False, 1, 0, False, True, 1, 3]


# -- trainer staging publish ---------------------------------------------


def test_trainer_staging_publish_routes_all_checkpoints(tmp_path):
    """--publish staging: every checkpoint the port's trainer writes lands
    in output_dir/staging (marker present), the live dir stays empty,
    --resume reads the staged state back, and JAX's unchanged controller
    promotes the port trainer's staged checkpoint."""
    from pytorch_cifar_tpu_torch.config import TrainConfig
    from pytorch_cifar_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(
        model="LeNet", epochs=1, batch_size=64, eval_batch_size=64,
        synthetic_data=True, synthetic_train_size=256,
        synthetic_test_size=128, lr=0.02, amp=False, log_every=1000,
        output_dir=str(tmp_path), publish="staging", device="cpu",
    )
    tr = Trainer(cfg)
    try:
        tr.fit()
    finally:
        tr.close()
    staged = PORT.ckpt.staging_dir(str(tmp_path))
    for pkg in PKGS:
        assert pkg.ckpt.is_staging_dir(staged)
    assert os.path.isfile(os.path.join(staged, CKPT))
    assert not os.path.isfile(os.path.join(str(tmp_path), CKPT))

    tr = Trainer(TrainConfig(**{**cfg.__dict__, "resume": True,
                                "epochs": 2}))
    try:
        assert tr.start_epoch == 1  # resumed from the staged checkpoint
        assert tr.ckpt_dir == staged
    finally:
        tr.close()

    live = str(tmp_path / "jax_live")
    save(live, 0, 0, 5.0)
    ctl = JAX.serve.PromotionController(
        JAX.engine(live), staged, live,
        golden=JAX.serve.GoldenSet.random(16, seed=3),
        budget=JAX.serve.CanaryBudget(max_flip_frac=1.0))
    assert ctl.poll_once() == "promoted"
    with open(JAX.ckpt.meta_path(live, CKPT)) as f:
        assert json.load(f)["promotion"]["generation"] == 1
    assert read_bytes(os.path.join(live, CKPT)) == read_bytes(
        os.path.join(staged, CKPT))


def test_healthz_reports_promotion_generation_after_reload(tmp_path):
    def scenario(pkg, root):
        live, staging, ctl = _pipeline(pkg, root)
        engine = pkg.engine(live)
        batcher = pkg.serve.MicroBatcher(engine)
        watcher = pkg.serve.CheckpointWatcher(engine, live, poll_s=3600)
        backend = pkg.serve.BatcherBackend(engine, batcher, watcher=watcher)
        try:
            before = backend.health()["promotion_generation"]
            save(staging, 7, 2, 20.0)
            out = (before, ctl.poll_once(), watcher.poll_once())
            h = backend.health()
            return out + tuple(h[k] for k in (
                "promotion_generation", "ckpt_epoch", "reloads",
                "reload_skipped", "reload_quarantined"))
        finally:
            batcher.close()

    assert _both(scenario, tmp_path) == (
        None, "promoted", True, 1, 2, 1, 0, 0)


# -- NaN at one fused conv3x3+BN+ReLU site --------------------------------


def test_nan_at_one_k3_site_quarantined_by_both(tmp_path, monkeypatch):
    """A candidate whose only NaN is one element of one fused site's BN
    variance: the NaN channel survives that site's ReLU in both packages,
    spreads through the next conv, and the golden finiteness gate
    quarantines it as "nonfinite"; the canary rolls back bit for bit."""
    register_resnet_tiny(monkeypatch)

    def scenario(pkg, root):
        live, staging, ctl = _pipeline(
            pkg, root, model="ResNetTiny",
            golden=pkg.serve.GoldenSet.random(8, seed=3))
        x = images(4, 9)
        pre = ctl.engine.predict(x)
        save(staging, 1, 2, 30.0, model="ResNetTiny")
        PORT.faults.nan_leaf(staging, K3_SITE_VAR)
        verdict = ctl.poll_once()
        return (verdict, _tomb(pkg, staging)["reason"],
                bool(np.array_equal(ctl.engine.predict(x), pre)))

    verdict, reason, rolled_back = _both(scenario, tmp_path)
    assert verdict == "quarantined" and rolled_back
    assert reason == "nonfinite logits on 8/8 golden rows (budget 0)"


@pytest.mark.parametrize("where", ["pixel", "weight", "scale", "bias",
                                   "negative_zero"])
def test_plain_fused_op_keeps_nan_where_jax_does(where):
    """The port's plain ``conv3x3_bn_relu_reference`` and JAX's
    ``conv3x3_bn_relu_reference`` have NaN at the same positions when one
    input pixel, one weight, one scale or one bias entry is NaN: the
    contract the CUDA kernel is held to on the card. Elsewhere they agree
    at fp32 tolerance. (A -0 before the ReLU: JAX gives +0, torch.relu
    keeps -0; the values are equal.)"""
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w = (rs.standard_normal((3, 3, 16, 24)) / 12).astype(np.float32)
    scale = rs.uniform(0.5, 1.5, 24).astype(np.float32)
    bias = (0.1 * rs.standard_normal(24)).astype(np.float32)
    if where == "pixel":
        x[1, 3, 4, 5] = np.nan
    elif where == "weight":
        w[1, 2, 7, 11] = np.nan
    elif where == "scale":
        scale[3] = np.nan
    elif where == "bias":
        bias[20] = np.nan
    else:  # a zero input and a -0 bias on a negative-scale channel
        x[0, 2:6, 2:6, :] = 0.0
        scale[5], bias[5] = -1.0, -0.0
    want = np.asarray(jax_k3.conv3x3_bn_relu_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias)))
    got = k3.conv3x3_bn_relu_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(bias)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    if where != "negative_zero":
        assert np.isnan(want).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
