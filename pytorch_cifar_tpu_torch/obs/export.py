"""Metrics export: periodic JSONL, end-of-run summary, Prometheus text (a
copy of ``pytorch_cifar_tpu/obs/export.py``).

Three consumers, three shapes:

- a *trajectory* consumer (dashboards, a run's history) wants periodic
  snapshots: :class:`MetricsExporter` appends one JSON line per interval
  to ``--metrics_out`` — append-only JSONL so a crash never corrupts the
  lines already written, and a tail -f follows a live run;
- a *run verdict* consumer (a CLI's end-of-run print) wants one flat
  deterministic dict: ``registry.summary()``;
- a *scrape* consumer (the serving path; Prometheus/node-exporter
  convention) wants the text exposition format: :func:`prometheus_text`.

No exporter thread exists unless a CLI flag asked for one — constructing
registries and instrumenting code paths starts nothing.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Optional

from pytorch_cifar_tpu_torch.obs.metrics import MetricsRegistry


class MetricsExporter:
    """Background thread appending one ``{"ts_s", "seq", "metrics"}`` JSON
    line per ``interval_s`` to ``path``; ``stop()`` writes a final line so
    short runs (shorter than one interval) still export something."""

    def __init__(
        self,
        registry: MetricsRegistry,
        path: str,
        interval_s: float = 10.0,
    ):
        self.registry = registry
        self.path = path
        self.interval_s = float(interval_s)
        self._seq = 0
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        # guards the sequence counter and the thread handle: the export
        # thread and stop()'s final-line write share both
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def _write_line(self) -> None:
        with self._lock:
            seq = self._seq
            self._seq += 1
        line = json.dumps(
            {
                "ts_s": round(time.monotonic() - self._t0, 3),
                "seq": seq,
                "metrics": self.registry.snapshot(),
            }
        )
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._write_line()
            except OSError:
                # a full/unmounted disk must degrade metrics, not the run
                pass

    def start(self) -> "MetricsExporter":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="metrics-exporter", daemon=True
                )
                self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # take the handle under the lock, join outside it (a concurrent
        # start() must not wait a full interval behind the join)
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()
        try:
            self._write_line()  # final snapshot even for sub-interval runs
        except OSError:
            pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def _prom_name(name: str) -> str:
    """Dotted registry names -> Prometheus-legal snake metric names."""
    return re.sub(r"[^a-zA-Z0-9_]", "_", name)


def prometheus_text(snapshot: dict, prefix: str = "pct") -> str:
    """Render a snapshot in the Prometheus text exposition format.

    Counters map to ``counter``, gauges emit value and ``_peak``,
    histograms emit the standard cumulative ``_bucket{le=...}`` series
    plus ``_sum``/``_count``. Deterministic: key-sorted, fixed float
    formatting."""
    lines = []
    for k in sorted(snapshot.get("counters", {})):
        n = f"{prefix}_{_prom_name(k)}"
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {snapshot['counters'][k]:g}")
    for k in sorted(snapshot.get("gauges", {})):
        g = snapshot["gauges"][k]
        n = f"{prefix}_{_prom_name(k)}"
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {g['value']:g}")
        lines.append(f"# TYPE {n}_peak gauge")
        lines.append(f"{n}_peak {g['max']:g}")
    for k in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][k]
        n = f"{prefix}_{_prom_name(k)}"
        lines.append(f"# TYPE {n} histogram")
        cum = 0.0
        for bound, c in zip(h["bounds"], h["counts"]):
            cum += c
            lines.append(f'{n}_bucket{{le="{bound:g}"}} {cum:g}')
        cum += h["counts"][len(h["bounds"])]
        lines.append(f'{n}_bucket{{le="+Inf"}} {cum:g}')
        lines.append(f"{n}_sum {h['sum']:g}")
        lines.append(f"{n}_count {h['count']:g}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, snapshot: dict, prefix: str = "pct") -> None:
    """Atomic dump of :func:`prometheus_text` (tmp+rename: a scraper
    reading mid-write must never see a half file)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(prometheus_text(snapshot, prefix))
    # rewritten every interval: a scraper must never see a half file
    # (rename atomicity), but fsync durability buys nothing a crash would
    # not immediately overwrite
    os.replace(tmp, path)
