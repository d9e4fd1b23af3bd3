"""The port's inspection tools (``tools/ckpt_inspect.py``,
``tools/journal_inspect.py``) against the JAX package's on the same files:
the same ``--json`` report, the same text and the same exit code.

Checkpoint dirs written by either package (v2 with history, v3 in shards),
torn, bit-flipped, with a shard missing or orphaned, quarantined (live:
exit 2; staging: exit 0) and beside a cold-start cache; journals whole,
compacted, with a torn tail and corrupt. Beside them, the JAX package's
``tools/trace_summary.py`` folds a trace the port's ``--trace_out``
wrote.
"""

import importlib.util
import json
import os

import pytest
import torch

from pytorch_cifar_tpu.serve import journal as jax_journal
from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch import faults
from pytorch_cifar_tpu_torch.serve import InferenceEngine, journal
from pytorch_cifar_tpu_torch.serve.__main__ import main as serve_main
from pytorch_cifar_tpu_torch.tools import ckpt_inspect, journal_inspect
from pytorch_cifar_tpu_torch.train import checkpoint as port_ckpt
from _torch_ckpt import jax_state, port_state
from _torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_CKPT_INSPECT = _jax_tool("ckpt_inspect")
JAX_JOURNAL_INSPECT = _jax_tool("journal_inspect")
JAX_TRACE_SUMMARY = _jax_tool("trace_summary")


def _both(capsys, port, jax, path):
    """Each tool's (exit code, stdout) in JSON and in text mode; asserts
    the two packages agree and returns the JSON report and the code."""
    got = {}
    for pkg, mod in (("port", port), ("jax", jax)):
        for mode in (["--json"], []):
            rc = mod.main([path, *mode])
            got[pkg, bool(mode)] = (rc, capsys.readouterr().out)
    for mode in (True, False):
        assert got["port", mode] == got["jax", mode], mode
    rc, out = got["port", True]
    return rc, json.loads(out)


def _save(pkg, out_dir, epoch, **kw):
    if pkg == "jax":
        jax_ckpt.save_checkpoint(str(out_dir), jax_state("LeNet", epoch),
                                 epoch, 10.0 * epoch, **kw)
    else:
        port_ckpt.save_checkpoint(str(out_dir), port_state("LeNet", epoch),
                                  epoch, 10.0 * epoch, **kw)
    return str(out_dir)


def _damage(path, kind):
    d = os.path.join(path, "ckpt.msgpack")
    if kind == "torn":
        faults.truncate_file(d)
    elif kind == "bitflip":
        faults.bitflip_file(d)
    elif kind == "shard_missing":
        os.remove(os.path.join(path, "ckpt.shard00001-of-00002.msgpack"))
    elif kind == "orphan_shards":
        os.remove(os.path.join(path, "ckpt.json"))  # the commit marker
    elif kind == "quarantined_live":
        port_ckpt.quarantine_checkpoint(path, "ckpt.msgpack", "canary: nan")
    elif kind == "quarantined_staging":
        assert port_ckpt.is_staging_dir(path)
        port_ckpt.quarantine_checkpoint(path, "ckpt.msgpack", "canary: nan")
    elif kind == "aot_cache":
        InferenceEngine.from_checkpoint(
            path, "LeNet", buckets=(1, 4), compute_dtype=torch.float32,
            device="cpu", aot_cache_dir=path)


CASES = {  # kind: (shards, expected exit code)
    "whole": (None, 0), "torn": (None, 1), "bitflip": (None, 1),
    "v3": (2, 0), "shard_missing": (2, 1), "orphan_shards": (2, 0),
    "quarantined_live": (None, 2), "quarantined_staging": (None, 0),
    "aot_cache": (None, 0),
}


@pytest.mark.parametrize("kind", sorted(CASES))
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_ckpt_inspect_reports_as_jax(tmp_path, capsys, pkg, kind):
    shards, code = CASES[kind]
    path = str(tmp_path / "ckpt")
    if kind == "quarantined_staging":  # a trainer's --publish staging dir
        path = port_ckpt.ensure_staging_dir(str(tmp_path / "live"))
    for epoch in (1, 2, 3):  # a history behind the primary
        _save(pkg, path, epoch, keep_last_n=2, num_shards=shards)
    _damage(path, kind)
    rc, rep = _both(capsys, ckpt_inspect, JAX_CKPT_INSPECT, path)
    assert rc == code, rep
    assert len(rep["checkpoints"]) >= 1
    assert rep["staging"] is (kind == "quarantined_staging")
    assert bool(rep["quarantined"]) is kind.startswith("quarantined")
    if kind == "orphan_shards":
        assert rep["orphan_shards"]
    if kind == "aot_cache":
        assert [e["bucket"] for e in rep["aot_cache"]["entries"]] == [1, 4]


def test_ckpt_inspect_usage_errors_as_jax(tmp_path, capsys):
    missing = str(tmp_path / "nowhere")
    for mod in (ckpt_inspect, JAX_CKPT_INSPECT):
        assert mod.main([missing]) == 2
    assert capsys.readouterr().out == ""


STREAM = [
    ("spawn-intent", {"idx": 0}),
    ("replica-up", {"idx": 0, "url": "http://127.0.0.1:9000", "pid": 11,
                    "generation": 1, "compiles": 3}),
    ("spawn-intent", {"idx": 1}),
    ("replica-up", {"idx": 1, "url": "http://127.0.0.1:9001", "pid": 12,
                    "generation": 1, "compiles": 0}),
    ("generation", {"generation": 1}),
    ("rollout-begin", {"from_generation": 1, "to_generation": 2,
                       "n_start": 2}),
    ("spawn-intent", {"idx": 2}),
    ("drain-intent", {"idx": 0, "url": "http://127.0.0.1:9000"}),
]


def _journal(pkg, path, compact=False):
    mod = jax_journal if pkg == "jax" else journal
    j = mod.ControllerJournal(path)
    for op, fields in STREAM:
        j.append(op, **fields)
    if compact:
        records, _ = mod.replay_journal(path)
        j.compact(records)
        j.append("drain-done", idx=0, url="http://127.0.0.1:9000")
    j.close()


@pytest.mark.parametrize("kind,code", [("whole", 0), ("compacted", 0),
                                       ("torn_tail", 0), ("corrupt", 2)])
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_journal_inspect_reports_as_jax(tmp_path, capsys, pkg, kind, code):
    path = str(tmp_path / "fleet.journal")
    _journal(pkg, path, compact=kind == "compacted")
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    if kind == "torn_tail":
        with open(path, "wb") as f:
            f.write(raw[: len(raw) - len(lines[-2]) // 2 - 1])
    elif kind == "corrupt":
        lines[2] = lines[2][:10] + b"#" + lines[2][11:]
        with open(path, "wb") as f:
            f.write(b"\n".join(lines))
    rc, rep = _both(capsys, journal_inspect, JAX_JOURNAL_INSPECT, path)
    assert rc == code
    assert rep["corrupt"] is (kind == "corrupt")
    if kind != "corrupt":
        assert rep["torn_tail"] is (kind == "torn_tail")
        assert rep["rollout"]["to_generation"] == 2


def test_journal_inspect_missing_journal_as_jax(tmp_path, capsys):
    for mod in (journal_inspect, JAX_JOURNAL_INSPECT):
        assert mod.main([str(tmp_path / "none.journal")]) == 2
    assert capsys.readouterr().out == ""


def test_jax_trace_summary_folds_a_port_trace(tmp_path, capsys):
    trace = str(tmp_path / "trace.json")
    assert serve_main(["--device", "cpu", "--dtype", "float32", "--model",
                       "LeNet", "--buckets", "1", "4", "--clients", "2",
                       "--requests", "2", "--trace_out", trace]) == 0
    capsys.readouterr()
    assert JAX_TRACE_SUMMARY.main([trace, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["spans"]["serve/compile_bucket"]["count"] == 2
    assert rep["spans"]["serve/bucket_forward"]["count"] >= 1
    assert rep["span_events"] > 2
