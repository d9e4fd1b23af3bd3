"""The port's checkpoint module under damage, and its async writer
(counterparts of ``tests/test_faults.py`` and ``tests/test_checkpoint.py``
for the JAX package).

- A truncated or bit-flipped ``last.msgpack`` falls back to
  ``ckpt.msgpack``; all candidates corrupt raises FileNotFoundError; a v1
  sidecar restores with the "no manifest" warning; ``keep_last_n`` rolls,
  prunes and serves as the fallback; a v3 set without its commit marker is
  invisible and a committed one with a bad shard falls back; a payload
  that does not decode, or is another model's, falls back too.
- The writer: an async save writes the sync bytes; a newer save of one
  name supersedes the queued one; distinct names queue independently; an
  error is re-raised on the next interaction; ``close`` joins the thread.

Port states are LeNet's on the CPU (``tests/_torch_ckpt.py``); restored
tensors are compared bit for bit.
"""

import json
import logging
import os
import threading

import pytest
import torch

from pytorch_cifar_tpu import faults
from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch.obs import MetricsRegistry
from pytorch_cifar_tpu_torch.train import checkpoint as ckpt
from pytorch_cifar_tpu_torch.train.checkpoint import (
    CKPT_NAME,
    LAST_NAME,
    AsyncCheckpointWriter,
    CheckpointCorrupt,
    best_checkpoint_order,
    history_names,
    meta_path,
    newest_checkpoint_order,
    remove_stale_last,
    restore_checkpoint,
    save_checkpoint,
)
from _torch_ckpt import jax_state, momentum, port_state, random_port_state
from _torch_threads import torch_threads  # noqa: F401


def _state_equal(got, want):
    sd_g, sd_w = got.model.state_dict(), want.model.state_dict()
    for k in sd_w:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd_g[k], sd_w[k]), k
    for k, buf in momentum(want).items():
        assert torch.equal(momentum(got)[k], buf), k
    assert got.step == want.step


@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_corrupt_newest_falls_back_to_best_ckpt(tmp_path, damage, caplog):
    out = str(tmp_path)
    best = random_port_state("LeNet", seed=0)
    save_checkpoint(out, best, epoch=5, best_acc=50.0)
    save_checkpoint(out, random_port_state("LeNet", seed=7, step=9),
                    epoch=7, best_acc=55.0, name=LAST_NAME)
    victim = os.path.join(out, LAST_NAME)
    (faults.truncate_file if damage == "truncate" else faults.bitflip_file)(
        victim)
    order = newest_checkpoint_order(out)
    assert order[0] == LAST_NAME  # the damaged file is the preferred one
    reg = MetricsRegistry()
    got = port_state("LeNet")
    with caplog.at_level(logging.WARNING):
        _, start, acc = restore_checkpoint(out, got, names=order,
                                           registry=reg)
    assert (start, acc) == (6, 50.0)
    _state_equal(got, best)
    assert any("corrupt" in r.message for r in caplog.records)
    assert reg.counter("checkpoint.corrupt_candidates").value == 1
    assert reg.counter("checkpoint.fallbacks").value == 1
    assert reg.counter("checkpoint.restores").value == 1


def test_all_candidates_corrupt_raises_filenotfound(tmp_path):
    out = str(tmp_path)
    save_checkpoint(out, random_port_state("LeNet", 1), 1, 1.0)
    save_checkpoint(out, random_port_state("LeNet", 2), 2, 2.0,
                    name=LAST_NAME)
    for name in (CKPT_NAME, LAST_NAME):
        faults.truncate_file(os.path.join(out, name))
    with pytest.raises(FileNotFoundError, match="no usable checkpoint"):
        restore_checkpoint(out, port_state("LeNet"),
                           names=newest_checkpoint_order(out))


def test_v1_checkpoint_without_manifest_restores_with_warning(tmp_path,
                                                              caplog):
    out = str(tmp_path)
    state = random_port_state("LeNet", 3)
    save_checkpoint(out, state, 2, 20.0)
    with open(meta_path(out, CKPT_NAME)) as f:
        meta = json.load(f)
    del meta["manifest"]
    with open(meta_path(out, CKPT_NAME), "w") as f:
        json.dump(meta, f)
    got = port_state("LeNet")
    with caplog.at_level(logging.WARNING):
        _, start, acc = restore_checkpoint(out, got)
    assert (start, acc) == (3, 20.0)
    _state_equal(got, state)
    assert any("no manifest" in r.message for r in caplog.records)


def test_history_rolls_prunes_and_serves_as_fallback(tmp_path):
    out = str(tmp_path)
    states = {e: random_port_state("LeNet", seed=e, step=e) for e in (1, 2, 3)}
    for e in (1, 2, 3):
        save_checkpoint(out, states[e], e, float(e), keep_last_n=2)
    assert history_names(out, CKPT_NAME) == ["ckpt-e00003.msgpack",
                                             "ckpt-e00002.msgpack"]
    assert not os.path.exists(os.path.join(out, "ckpt-e00001.msgpack"))
    assert os.stat(os.path.join(out, CKPT_NAME)).st_ino != os.stat(
        os.path.join(out, "ckpt-e00003.msgpack")).st_ino  # a copy
    faults.bitflip_file(os.path.join(out, CKPT_NAME))
    got = port_state("LeNet")
    _, start, acc = restore_checkpoint(out, got)
    assert (start, acc) == (4, 3.0)
    _state_equal(got, states[3])


def test_v3_without_commit_marker_is_invisible(tmp_path):
    out = str(tmp_path)
    jax_ckpt.save_checkpoint(out, jax_state("LeNet", seed=1), 2, 1.0,
                             num_shards=2)
    assert len([f for f in os.listdir(out) if ".shard" in f]) == 4
    os.remove(meta_path(out, CKPT_NAME))
    with pytest.raises(FileNotFoundError, match="no usable checkpoint"):
        restore_checkpoint(out, port_state("LeNet"))


def test_committed_v3_with_a_bad_shard_falls_back(tmp_path):
    out = str(tmp_path)
    jax_ckpt.save_checkpoint(out, jax_state("LeNet", seed=1), 4, 9.0,
                             num_shards=2)
    last = random_port_state("LeNet", 5)
    save_checkpoint(out, last, 3, 8.0, name=LAST_NAME)
    faults.bitflip_file(os.path.join(
        out, jax_ckpt.shard_name(CKPT_NAME, 1, 2)))
    with pytest.raises(CheckpointCorrupt, match="crc32"):
        ckpt.read_verified_payload(out, CKPT_NAME)
    got = port_state("LeNet")
    _, start, _ = restore_checkpoint(out, got, names=[CKPT_NAME, LAST_NAME])
    assert start == 4
    _state_equal(got, last)


@pytest.mark.parametrize("payload", ["garbage", "another model"])
def test_undecodable_or_foreign_payload_falls_back(tmp_path, payload):
    out = str(tmp_path)
    last = random_port_state("LeNet", 6)
    save_checkpoint(out, last, 1, 3.0, name=LAST_NAME)
    if payload == "garbage":  # a valid manifest over bytes that are no tree
        blob = b"\xc1" * 64
        with open(os.path.join(out, CKPT_NAME), "wb") as f:
            f.write(blob)
        with open(meta_path(out, CKPT_NAME), "w") as f:
            json.dump({"epoch": 2, "best_acc": 4.0,
                       "manifest": ckpt.payload_manifest(blob)}, f)
    else:
        save_checkpoint(out, random_port_state("ResNetTiny", 1), 2, 4.0)
    got = port_state("LeNet")
    _, start, _ = restore_checkpoint(out, got, names=[CKPT_NAME, LAST_NAME])
    assert start == 2
    _state_equal(got, last)


def test_remove_stale_last_removes_its_history_and_shards(tmp_path):
    out = str(tmp_path)
    state = random_port_state("LeNet", 1)
    save_checkpoint(out, state, 1, 1.0, keep_last_n=2)
    for e in (1, 2):
        save_checkpoint(out, state, e, 1.0, name=LAST_NAME, keep_last_n=2)
    with open(os.path.join(out, "last.shard00000-of-00002.msgpack"),
              "wb") as f:
        f.write(b"x")
    remove_stale_last(out)
    assert sorted(os.listdir(out)) == ["ckpt-e00001.json",
                                       "ckpt-e00001.msgpack", "ckpt.json",
                                       "ckpt.msgpack"]


def test_candidate_orders(tmp_path):
    out = str(tmp_path)
    state = random_port_state("LeNet", 1)
    assert newest_checkpoint_order(out) == [LAST_NAME, CKPT_NAME]
    save_checkpoint(out, state, 5, 1.0)
    save_checkpoint(out, state, 3, 1.0, name=LAST_NAME)  # a stale last
    assert newest_checkpoint_order(out) == [CKPT_NAME, LAST_NAME]
    save_checkpoint(out, state, 5, 1.0, name=LAST_NAME)  # a tie: last
    assert newest_checkpoint_order(out) == [LAST_NAME, CKPT_NAME]
    assert best_checkpoint_order(out) == [CKPT_NAME, LAST_NAME]


# -- the async writer ----------------------------------------------------

def test_async_save_bit_identical_to_sync(tmp_path):
    state = random_port_state("LeNet", 4)
    save_checkpoint(str(tmp_path / "sync"), state, 1, 2.0)
    w = AsyncCheckpointWriter()
    save_checkpoint(str(tmp_path / "async"), state, 1, 2.0, writer=w)
    w.close()
    for f in ("ckpt.msgpack", "ckpt.json"):
        assert (tmp_path / "sync" / f).read_bytes() == \
            (tmp_path / "async" / f).read_bytes()


def _stalled_writes(monkeypatch):
    """Make every atomic write wait for the returned event: the writer's
    first job holds the thread while later submissions queue."""
    release = threading.Event()
    real = ckpt._atomic_write

    def stalled(path, data):
        release.wait(timeout=30)
        real(path, data)

    monkeypatch.setattr(ckpt, "_atomic_write", stalled)
    return release


def test_newer_save_supersedes_the_queued_one(tmp_path, monkeypatch):
    reg = MetricsRegistry()
    w = AsyncCheckpointWriter(registry=reg)
    release = _stalled_writes(monkeypatch)
    state = random_port_state("LeNet", 1)
    try:
        for epoch in (1, 2, 3):
            save_checkpoint(str(tmp_path), state, epoch, 1.0, registry=reg,
                            writer=w)
    finally:
        release.set()
        w.close()
    assert json.loads((tmp_path / "ckpt.json").read_text())["epoch"] == 3
    assert reg.counter("checkpoint.superseded_saves").value >= 1
    assert (reg.counter("checkpoint.saves").value
            + reg.counter("checkpoint.superseded_saves").value) == 3
    assert reg.gauge("checkpoint.pending_saves").value == 0


def test_distinct_names_queue_independently(tmp_path, monkeypatch):
    w = AsyncCheckpointWriter()
    release = _stalled_writes(monkeypatch)
    state = random_port_state("LeNet", 1)
    try:
        save_checkpoint(str(tmp_path), state, 3, 1.0, writer=w)
        save_checkpoint(str(tmp_path), state, 4, 2.0, writer=w)
        save_checkpoint(str(tmp_path), state, 4, 2.0, name=LAST_NAME,
                        writer=w)
    finally:
        release.set()
        w.close()
    for name in ("ckpt.json", "last.json"):
        assert json.loads((tmp_path / name).read_text())["epoch"] == 4
    ckpt.read_verified_payload(str(tmp_path), CKPT_NAME)


def test_writer_error_reraised_on_next_interaction(tmp_path, monkeypatch):
    w = AsyncCheckpointWriter()
    state = random_port_state("LeNet", 1)

    def failing(path, data):
        raise RuntimeError("disk full (injected)")

    monkeypatch.setattr(ckpt, "_atomic_write", failing)
    committed = []
    save_checkpoint(str(tmp_path), state, 1, 1.0, writer=w,
                    on_commit=lambda: committed.append(1))
    with pytest.raises(RuntimeError, match="disk full"):
        w.flush()
    monkeypatch.undo()  # the error is consumed; the writer stays usable
    save_checkpoint(str(tmp_path), state, 2, 2.0, writer=w,
                    on_commit=lambda: committed.append(2))
    w.close()
    assert committed == [2]
    assert json.loads((tmp_path / "ckpt.json").read_text())["epoch"] == 2


def test_close_joins_the_thread_and_stall_is_recorded(tmp_path):
    reg = MetricsRegistry()
    w = AsyncCheckpointWriter(registry=reg)
    save_checkpoint(str(tmp_path), random_port_state("LeNet", 1), 1, 1.0,
                    registry=reg, writer=w)
    thread = w._thread  # the JAX trainer's tests may leave theirs running
    w.close()
    assert thread is not None and not thread.is_alive()
    s = reg.summary()
    assert s["checkpoint.writer_ms.count"] == 1.0
    assert s["checkpoint.save_stall_ms.count"] == 1.0
    assert s["checkpoint.saves"] == 1.0
