"""The port's serving CLI as one HTTP replica, on the CPU:

    python -m pytorch_cifar_tpu_torch.serve --device cpu --model LeNet \\
        --http_port 0 --duration_s ...

prints ``==> http: serving on URL`` on stderr, answers ``/predict`` in
every encoding bit for bit as the same seeded engine does in-process,
answers ``/healthz``, drains on SIGTERM or SIGINT (or when
``--duration_s`` runs out) and prints ONE JSON line whose keys include
those of the JAX ``serve.py``'s ``_serve_http`` report (read from its
source) and the port's ``kernel_launches``, ``launches_by_kernel`` and
``device``. ``--edge event`` serves the same; ``--prom_out``,
``--metrics_out`` and ``--trace_out`` write their files.
"""

import ast
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from pytorch_cifar_tpu_torch.serve import HttpTarget, wire
from _torch_threads import torch_threads  # noqa: F401
from _torch_wire import b64_payload, get, images, lenet_engine, post_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READY = "==> http: serving on "


def _jax_report_keys():
    """The keys of the report ``serve.py``'s ``_serve_http`` returns."""
    with open(os.path.join(REPO, "serve.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "_serve_http")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)][-1]
    return {k.value for k in ret.value.keys}


class Replica:
    """The CLI in a child process; stderr is read by a thread so the
    child never blocks on a full pipe."""

    def __init__(self, *args):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pytorch_cifar_tpu_torch.serve",
             "--device", "cpu", "--model", "LeNet", "--dtype", "float32",
             "--buckets", "1", "4", "--http_port", "0", *args],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        self.err = []
        self.ready = threading.Event()
        self.url = None
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stderr:
            self.err.append(line)
            if line.startswith(READY):
                self.url = line[len(READY):].strip()
                self.ready.set()

    def finish(self, timeout=120):
        """Wait for the exit; returns (returncode, stdout lines). stdout
        holds one line, so the child cannot block on it."""
        try:
            self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=30)
            self._reader.join(timeout=30)
            self.proc.stderr.close()
        with self.proc.stdout:
            out = self.proc.stdout.read()
        return self.proc.returncode, out.strip().splitlines()


@pytest.mark.parametrize("edge,stop", [
    ("threaded", signal.SIGTERM), ("event", signal.SIGINT),
    ("event", None),
])
def test_cli_serves_http_and_drains(tmp_path, edge, stop):
    files = {k: str(tmp_path / f"{k}.out")
             for k in ("prom_out", "metrics_out", "trace_out")}
    flags = [f for k, v in files.items() for f in (f"--{k}", v)]
    rep = Replica("--edge", edge, "--duration_s",
                  "240" if stop is not None else "3", *flags)
    try:
        assert rep.ready.wait(120), "".join(rep.err)
        engine = lenet_engine()  # the replica's weights: LeNet at seed 0
        x = images(3, seed=1)
        want = engine.predict(x)
        for mode in ("json", "binary"):
            t = HttpTarget(rep.url, wire=mode)
            assert np.array_equal(t.submit(x).result(), want), mode
            t.close()
        status, _, body = post_json(rep.url, {"images": x.tolist()})
        assert status == 200
        assert np.array_equal(
            np.asarray(json.loads(body)["logits"], np.float32), want)
        status, _, body = post_json(rep.url, b64_payload(x, priority="bulk"))
        assert status == 200
        status, body = get(rep.url, "/healthz")
        health = json.loads(body)
        assert status == 200 and health["model"] == "LeNet"
        assert health["compiles"] == 2 and health["buckets"] == [1, 4]
        status, _, _ = post_json(rep.url, {"images": "bad"})
        assert status == 400
        if stop is not None:
            rep.proc.send_signal(stop)
        code, lines = rep.finish()
    finally:
        if rep.proc.poll() is None:
            rep.proc.kill()
            rep.proc.wait(timeout=30)
    assert code == 0, "".join(rep.err)
    assert any("==> http: draining" in ln for ln in rep.err)
    assert len(lines) == 1
    rec = json.loads(lines[0])
    missing = (_jax_report_keys() | {"kernel_launches", "launches_by_kernel",
                                     "device"}) - set(rec)
    assert not missing, missing
    assert rec["clients"] == 0 and rec["requests"] == 4  # answered
    assert rec["images"] == 12 and rec["failed"] == 1  # the 400
    assert rec["bulk_requests"] == 1 and rec["obs"]["wire_requests"] == 1
    assert rec["device"] == "cpu" and rec["kernel_launches"] == 0
    assert set(rec["launches_by_kernel"]) == {
        "conv3x3_bn_relu", "max_pool3x3_s1", "depthwise_stencil"}
    with open(files["prom_out"]) as f:
        assert "pct_serve_http_requests 6" in f.read()
    with open(files["metrics_out"]) as f:
        assert json.loads(f.readlines()[-1])["metrics"]["counters"][
            "serve.http_images"] == 12
    with open(files["trace_out"]) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert "serve/batch" in names


def test_cli_load_mode_keeps_its_keys():
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_cifar_tpu_torch.serve",
         "--device", "cpu", "--model", "LeNet", "--dtype", "float32",
         "--buckets", "1", "4", "--clients", "2", "--requests", "3",
         "--deadline_ms", "60000", "--bulk_share", "0.25",
         "--no-continuous", "--no-hedge"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["requests"] == 6 and rec["failed"] == 0
    assert rec["deadline_ms"] == 60000 and rec["clients"] == 2
    assert rec["obs"]["continuous_admitted"] == 0
    for key in ("img_per_sec", "p50_ms", "p99_ms", "kernel_launches",
                "launches_by_kernel", "compiles", "hedged"):
        assert key in rec, key
