"""The rolling deploy's collaborators against the JAX package's:
``HttpGoldenGate`` (its golden images bit for bit, its checks against stub
frontends), ``live_generation_probe`` (a publish of the port's
``publish_checkpoint``) and ``live_rollback`` (the live dir byte for byte
as JAX's ``restore_previous_publish`` leaves a copy of it).
"""

import os

import numpy as np
import pytest

from _torch_fleet import JAX, PORT, SIDES
from _torch_lifecycle import clone_dir, jax_ckpt, save
from _torch_threads import torch_threads  # noqa: F401
from _torch_wire import StubBackend
from pytorch_cifar_tpu_torch.serve import ServingFrontend
from pytorch_cifar_tpu_torch.train import checkpoint as ckpt


@pytest.mark.parametrize("seed,n", [(7, 8), (3, 8), (3, 5)])
def test_golden_images_are_jax_bits(seed, n):
    got = [side.fleet.HttpGoldenGate(n=n, seed=seed).images for side in SIDES]
    assert got[1].dtype == np.uint8 and got[1].shape == (n, 32, 32, 3)
    assert got[1].tobytes() == got[0].tobytes()


class LogitsBackend(StubBackend):
    """Answers ``fn(images)`` as the logits (a stub frontend's backend)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def predict(self, images, deadline_ms=None, priority="interactive"):
        super().predict(images, deadline_ms, priority)
        return self.fn(images).astype(np.float32)


def _argmax_to(col):
    def fn(x):
        out = np.zeros((x.shape[0], 10), np.float32)
        out[:, col] = 1.0
        return out
    return fn


def _nan_rows(rows):
    def fn(x):
        out = _argmax_to(0)(x)
        out[list(rows)] = np.nan
        return out
    return fn


def _flip_first(k):
    def fn(x):
        out = _argmax_to(0)(x)
        out[:k, 0], out[:k, 1] = 0.0, 1.0
        return out
    return fn


@pytest.mark.parametrize("case,fn,with_baseline", [
    ("clean", _argmax_to(0), True),
    ("nan_rows", _nan_rows((1, 4, 6)), True),
    ("all_flipped", _argmax_to(3), True),
    ("six_of_eight_flipped", _flip_first(6), True),
    ("seven_of_eight_flipped", _flip_first(7), True),
    ("flipped_no_baseline", _argmax_to(3), False),
])
def test_gate_check_matches_jax(case, fn, with_baseline):
    """Both packages' gates against the same stub frontends: the baseline
    from an old-generation replica (argmax 0 everywhere), then a candidate
    with NaN rows or flipped argmaxes; the same problems, word for word."""
    old = ServingFrontend(LogitsBackend(_argmax_to(0))).start()
    new = ServingFrontend(LogitsBackend(fn)).start()
    try:
        got = []
        for side in SIDES:
            gate = side.fleet.HttpGoldenGate(n=8, seed=7, timeout_s=30)
            if with_baseline:
                gate.baseline_from(old.url)
            got.append(gate.check(new.url))
    finally:
        old.stop()
        new.stop()
    assert got[0] == got[1]
    want = {
        "clean": [], "flipped_no_baseline": [],
        "six_of_eight_flipped": [],  # 0.75 is the bound, not over it
        "nan_rows": ["3/8 golden rows non-finite"],
        "all_flipped": [
            "golden argmax flip fraction 1.00 > 0.75 vs old generation"],
        "seven_of_eight_flipped": [
            "golden argmax flip fraction 0.88 > 0.75 vs old generation"],
    }[case]
    assert got[1] == want


def _publish(src, live, generation):
    ckpt.publish_checkpoint(
        str(src), str(live),
        extra_meta={"promotion": {"generation": generation}})


def test_generation_probe_reads_the_ports_publish(tmp_path):
    src, live = tmp_path / "src", tmp_path / "live"
    save(src, seed=0, epoch=2, best_acc=0.5)
    probes = [side.fleet.live_generation_probe(str(live)) for side in SIDES]
    assert [p() for p in probes] == [None, None]  # nothing published yet
    for g in (4, 5):
        _publish(src, live, g)
        assert [p() for p in probes] == [g, g]
    # a torn sidecar and an unstamped publish read as None
    side_path = ckpt.meta_path(str(live), "ckpt.msgpack")
    with open(side_path, "w") as f:
        f.write('{"epoch": 2, "promo')
    assert [p() for p in probes] == [None, None]
    ckpt.publish_checkpoint(str(src), str(live))
    assert [p() for p in probes] == [None, None]


def _dir_bytes(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def test_live_rollback_leaves_jax_bytes(tmp_path):
    """Publish generation 1 then 2 (the port keeps gen 1 as the ``.prev``
    pair); the port's rollback hook and JAX's ``restore_previous_publish``
    on a copy leave the two dirs byte for byte equal, on generation 1."""
    a, b, live = tmp_path / "a", tmp_path / "b", tmp_path / "live"
    save(a, seed=0, epoch=2, best_acc=0.5)
    save(b, seed=1, epoch=3, best_acc=0.6)
    _publish(a, live, 1)
    _publish(b, live, 2)
    twin = clone_dir(live, tmp_path / "twin")
    assert PORT.fleet.live_rollback(str(live))() is True
    assert jax_ckpt.restore_previous_publish(twin, "ckpt.msgpack") is True
    assert _dir_bytes(live) == _dir_bytes(twin)
    assert PORT.fleet.live_generation_probe(str(live))() == 1
    with open(a / "ckpt.msgpack", "rb") as f:
        assert _dir_bytes(live)["ckpt.msgpack"] == f.read()
    # no rollback pair: both refuse alike
    empty = tmp_path / "empty"
    _publish(a, empty, 1)
    assert PORT.fleet.live_rollback(str(empty))() is False
    assert JAX.fleet.live_rollback(str(empty))() is False
