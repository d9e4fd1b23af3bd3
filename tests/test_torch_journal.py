"""The port's control-plane journal (``serve/journal.py``) against the JAX
package's: the same record stream written by either package gives the
same file bytes and the same :class:`FleetJournalState`; a journal (or a
compacted snapshot) written by either replays in the other; a torn final
record is dropped and a torn middle record raises in both.

Both modules are stdlib only; their clocks are replaced by one counter so
the ``wall`` stamps (and so the bytes) are comparable.
"""

import itertools
import os

import pytest

from pytorch_cifar_tpu.serve import journal as jax_journal
from pytorch_cifar_tpu_torch.serve import journal
from _torch_threads import torch_threads  # noqa: F401

PACKAGES = {"jax": jax_journal, "port": journal}

# every op the reducer knows, in a plausible order
STREAM = [
    ("spawn-intent", {"idx": 0}),
    ("replica-up", {"idx": 0, "url": "http://127.0.0.1:9000", "pid": 11,
                    "generation": 0, "compiles": 4}),
    ("spawn-intent", {"idx": 1}),
    ("spawn-failed", {"idx": 1}),
    ("adopt", {"idx": 2, "url": "http://127.0.0.1:9002", "pid": 13,
               "generation": 0, "compiles": 0}),
    ("policy", {"window": [1, 2, 3], "cooldown_until": 12.5}),
    ("generation", {"generation": 0}),
    ("vet-begin", {"signature": [[1, 2, 3], [4, 5, 6]], "epoch": 3}),
    ("vet-verdict", {"verdict": "quarantined", "reason": "nonfinite",
                     "epoch": 3}),
    ("vet-begin", {"signature": [[7, 8, 9], [1, 1, 1]], "epoch": 4}),
    ("vet-verdict", {"verdict": "promoted", "generation": 1, "epoch": 4}),
    ("rollout-begin", {"from_generation": 0, "to_generation": 1,
                       "n_start": 2}),
    ("rollout-phase", {"phase": "replace"}),
    ("drain-intent", {"idx": 0, "url": "http://127.0.0.1:9000"}),
    ("drain-done", {"idx": 0, "url": "http://127.0.0.1:9000"}),
    ("rollout-done", {"generation": 1}),
    ("rollout-begin", {"from_generation": 1, "to_generation": 2,
                       "n_start": 1}),
    ("rollout-halt", {"reason": "canary gate"}),
    ("rollout-rollback-done", {}),
    ("vet-begin", {"signature": None, "epoch": 5}),
    ("reap", {"idx": 2, "url": "http://127.0.0.1:9002"}),
    ("some-future-op", {"x": 1}),
]


class _Clock:
    def __init__(self):
        self._n = itertools.count()

    def time(self):
        return 1_700_000_000.0 + 0.25 * next(self._n)


@pytest.fixture(autouse=True)
def fixed_clocks(monkeypatch):
    for mod in PACKAGES.values():
        monkeypatch.setattr(mod, "time", _Clock())


def _write(mod, path, stream=STREAM):
    j = mod.ControllerJournal(path)
    for op, fields in stream:
        j.append(op, **fields)
    j.close()


def _state(mod, records) -> dict:
    return vars(mod.FleetJournalState.from_records(records))


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_same_stream_same_bytes_and_state(tmp_path):
    paths = {}
    for name, mod in PACKAGES.items():
        paths[name] = str(tmp_path / name / "journal.jsonl")
        _write(mod, paths[name])
    assert _read(paths["jax"]) == _read(paths["port"])
    (jrec, jtorn), (prec, ptorn) = (
        jax_journal.replay_journal(paths["jax"]),
        journal.replay_journal(paths["port"]),
    )
    assert jrec == prec and not jtorn and not ptorn
    assert len(prec) == len(STREAM)
    want = _state(jax_journal, jrec)
    assert _state(journal, prec) == want
    assert want["promotion_generation"] == 1 and want["rollbacks"] == 1
    assert (journal.FleetJournalState.from_records(prec).summary_records()
            == jax_journal.FleetJournalState.from_records(
                jrec).summary_records())


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_journal_replays_in_either_package(tmp_path, writer, reader):
    """A journal written by one package replays in the other; a reopened
    journal continues its sequence in the other package."""
    path = str(tmp_path / "journal.jsonl")
    _write(PACKAGES[writer], path, STREAM[:9])
    rdr = PACKAGES[reader]
    j = rdr.ControllerJournal(path)
    assert j.seq == 9
    for op, fields in STREAM[9:]:
        j.append(op, **fields)
    j.close()
    records, torn = PACKAGES[writer].replay_journal(path)
    assert not torn and [r["seq"] for r in records] == list(
        range(1, len(STREAM) + 1))
    assert _state(rdr, rdr.replay_journal(path)[0]) == _state(
        jax_journal, records)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_compacted_snapshot_replays_in_either_package(tmp_path, writer,
                                                      reader):
    """``compact`` writes the same snapshot and marker bytes in both
    packages; replay puts the snapshot before the live records."""
    paths = {}
    for name, mod in PACKAGES.items():
        paths[name] = str(tmp_path / name / "journal.jsonl")
        j = mod.ControllerJournal(paths[name])
        for op, fields in STREAM[:12]:
            j.append(op, **fields)
        state = mod.FleetJournalState.from_records(j.records())
        j.compact(state.summary_records())
        for op, fields in STREAM[12:]:
            j.append(op, **fields)
        j.close()
    for suffix in ("", journal.SNAPSHOT_SUFFIX,
                   journal.SNAPSHOT_MARKER_SUFFIX):
        assert _read(paths["jax"] + suffix) == _read(paths["port"] + suffix)
    got, _ = PACKAGES[reader].replay_journal(paths[writer])
    full = jax_journal.FleetJournalState.from_records(
        [{"seq": i + 1, "op": op, **f} for i, (op, f) in enumerate(STREAM)])
    assert _state(PACKAGES[reader], got) == vars(full)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_torn_tail_dropped_torn_middle_raises(tmp_path, writer, reader):
    path = str(tmp_path / "journal.jsonl")
    _write(PACKAGES[writer], path, STREAM[:6])
    raw = _read(path)
    lines = raw.split(b"\n")
    # a crash mid-append: the last record cut short, no newline
    with open(path, "wb") as f:
        f.write(raw[: len(raw) - len(lines[-2]) // 2 - 1])
    rdr = PACKAGES[reader]
    records, torn = rdr.replay_journal(path)
    assert torn and [r["seq"] for r in records] == [1, 2, 3, 4, 5]
    # damage before the tail is corruption, not a torn append
    lines[2] = lines[2][:10] + b"#" + lines[2][11:]
    with open(path, "wb") as f:
        f.write(b"\n".join(lines))
    with pytest.raises(rdr.JournalCorrupt, match="not the final record"):
        rdr.replay_journal(path)
    assert not os.path.exists(path + journal.SNAPSHOT_SUFFIX)
