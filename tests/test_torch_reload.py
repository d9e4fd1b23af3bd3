"""The port's hot-reload watcher (``serve/reload.py``) against the JAX
package's, and the serving CLI's ``--watch``.

- The same sequence of publishes into a live dir (a good one, a torn one
  whose payload was replaced under a stale sidecar, the settled pair, a
  quarantined one, another model's, a newer good one) gives both watchers
  the same return values and counters after every poll, and the same
  ``last_meta``; after each reload the port's fp32 logits equal the JAX
  engine's within rtol 1e-4, atol 1e-5. A watcher on a staging dir refuses
  in both.
- A swap under concurrent predicts: every answer is the old weights' bits
  or the new weights' bits, never a mix, and ``compile_count`` does not
  move.
- ``python -m pytorch_cifar_tpu_torch.serve --ckpt DIR --watch`` reloads a
  new publish while it serves HTTP (``/healthz`` reports it, the JSON line
  counts it); ``--watch`` without ``--ckpt`` is an error.
"""

import json
import os
import shutil
import signal
import threading
import time

import numpy as np

from _torch_lifecycle import PKGS, PORT, Child, images, save
from _torch_threads import torch_threads  # noqa: F401
from _torch_wire import get

CKPT = "ckpt.msgpack"


def _counters(w):
    return (w.reloads, w.skipped, w.quarantined, w.errors,
            w.last_meta.get("epoch"), w.last_version)


def test_watchers_agree_on_a_sequence_of_publishes(tmp_path):
    src = str(tmp_path / "src")
    save(src, 11, 9, 90.0)  # a complete pair whose payload goes in torn
    x = images(5, 2)
    steps = [
        ("nothing new", None),
        ("good", lambda d: save(d, 7, 2, 20.0)),
        ("torn", lambda d: shutil.copyfile(os.path.join(src, CKPT),
                                           os.path.join(d, CKPT))),
        ("still torn", None),
        ("settled", lambda d: shutil.copyfile(
            os.path.join(src, "ckpt.json"), os.path.join(d, "ckpt.json"))),
        ("quarantined", lambda d: (
            save(d, 5, 3, 30.0),
            PORT.ckpt.quarantine_checkpoint(d, CKPT, "canary said no"))),
        ("judged", None),
        ("wrong model", lambda d: save(d, 0, 4, 40.0, model="ResNetTiny")),
        ("remembered", None),
        ("newer good", lambda d: save(d, 3, 5, 50.0)),
    ]
    setups = {}
    for pkg in PKGS:
        live = str(tmp_path / pkg.name)
        save(live, 0, 1, 10.0)
        eng = pkg.engine(live)
        setups[pkg.name] = (live, eng, pkg.serve.CheckpointWatcher(
            eng, live, poll_s=3600), pkg)
    log = []
    for what, act in steps:
        row = {}
        for name, (live, eng, w, _) in setups.items():
            if act is not None:
                act(live)
            row[name] = (w.poll_once(), *_counters(w), eng.version)
        assert row["port"] == row["jax"], what
        log.append((what, row["port"][0]))
        if row["port"][0]:
            np.testing.assert_allclose(
                setups["port"][1].predict(x), setups["jax"][1].predict(x),
                rtol=1e-4, atol=1e-5, err_msg=what)
    assert [w for w, swapped in log if swapped] == [
        "good", "settled", "newer good"]
    w = setups["port"][2]
    assert _counters(w) == (3, 2, 1, 1, 5, 3)
    assert setups["port"][2].last_meta == setups["jax"][2].last_meta
    for live, eng, _, pkg in setups.values():
        staging = pkg.ckpt.ensure_staging_dir(live)
        save(staging, 8, 6, 60.0)
        sw = pkg.serve.CheckpointWatcher(eng, staging, poll_s=3600)
        assert (sw.poll_once(), sw.poll_once(), sw.reloads) == (
            False, False, 0), pkg


def test_swap_under_load_answers_old_or_new_bits(tmp_path):
    """Clients predicting while the watcher swaps get, request by request,
    the old engine's bits or the new engine's bits; the swap warms
    nothing up."""
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    save(a_dir, 0, 1, 10.0)
    save(b_dir, 7, 2, 20.0)
    x = images(3, 4)
    want = {"a": PORT.engine(a_dir).predict(x),
            "b": PORT.engine(b_dir).predict(x)}
    assert not np.array_equal(want["a"], want["b"])
    live = str(tmp_path / "live")
    shutil.copytree(a_dir, live)
    eng = PORT.engine(live)
    compiles = eng.compile_count
    watcher = PORT.serve.CheckpointWatcher(eng, live, poll_s=3600)
    stop = threading.Event()
    seen, bad = [], []
    per_client = [[] for _ in range(3)]

    def client(mine):
        while not stop.is_set():
            out = eng.predict(x)
            tag = next((k for k, v in want.items()
                        if np.array_equal(out, v)), None)
            (seen if tag else bad).append(tag or out)
            mine.append(tag)

    threads = [threading.Thread(target=client, args=(m,))
               for m in per_client]

    def answers(n, timeout=60.0):
        """Wait until ``n`` more answers have come back."""
        deadline, want_n = time.monotonic() + timeout, len(seen) + n
        while len(seen) < want_n and time.monotonic() < deadline:
            time.sleep(0.001)

    for t in threads:
        t.start()
    try:
        answers(6)
        for f in ("ckpt.msgpack", "ckpt.json"):
            shutil.copyfile(os.path.join(b_dir, f), os.path.join(live, f))
        assert watcher.poll_once()
        assert np.array_equal(eng.predict(x), want["b"])
        answers(6)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not bad and "a" in seen and "b" in seen
    # a request that started after the swap never answers with old bits
    for mine in per_client:
        assert mine == sorted(mine), mine
    assert eng.compile_count == compiles and eng.version == 1


def test_serve_cli_watch_reloads_over_http(tmp_path):
    live = str(tmp_path / "live")
    save(live, 0, 1, 10.0)
    rep = Child(["pytorch_cifar_tpu_torch.serve", "--device", "cpu",
                 "--model", "LeNet", "--dtype", "float32", "--buckets", "1",
                 "4", "--ckpt", live, "--watch", "--poll_s", "0.1",
                 "--http_port", "0"], "==> http: serving on ")
    try:
        assert rep.ready.wait(120), "".join(rep.err)
        assert any("==> watching" in ln for ln in rep.err)
        h = json.loads(get(rep.url, "/healthz")[1])
        assert (h["ckpt_epoch"], h["reloads"], h["reload_skipped"],
                h["reload_quarantined"]) == (1, 0, 0, 0)
        save(live, 7, 2, 20.0)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            h = json.loads(get(rep.url, "/healthz")[1])
            if h["ckpt_epoch"] == 2:
                break
            time.sleep(0.05)
        assert h["ckpt_epoch"] == 2 and h["reloads"] == 1
        assert h["engine_version"] == 1 and h["compiles"] == 2
        rep.proc.send_signal(signal.SIGTERM)
        code, lines = rep.finish(120)
    finally:
        if rep.proc.poll() is None:
            rep.proc.kill()
            rep.proc.wait(timeout=30)
    assert code == 0, "".join(rep.err)
    rec = json.loads(lines[-1])
    # a poll between the payload's rename and the sidecar's defers once
    assert rec["reloads"] == 1 and rec["reload_skipped"] in (0, 1)
    assert rec["obs"]["reloads"] == 1.0


def test_serve_cli_watch_needs_ckpt():
    rep = Child(["pytorch_cifar_tpu_torch.serve", "--device", "cpu",
                 "--watch"], "never")
    code, lines = rep.finish(120)
    assert code == 2 and lines == []
    assert "--watch needs --ckpt" in "".join(rep.err)
