"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

A copy of ``pytorch_cifar_tpu/obs/metrics.py`` without its JAX
cross-host merge (``allgather_merged``).

Design constraints (the reasons this is not just a dict of ints):

- **Thread-safe**: the serving path mutates from the batcher worker, the
  submit callers, and the watcher thread at once; the trainer mutates from
  the epoch loop and the async checkpoint writer. Each instrument carries
  its own small lock — an ``inc`` is a lock + float add, cheap against
  anything it ever measures (a train step, a queue wait, a disk write).
- **Snapshots are plain dicts** of floats and lists (JSON-serializable
  as-is), and :func:`merge_snapshots` merges several exactly.
- **Deterministic summaries**: histogram percentiles interpolate inside
  fixed buckets and every emitted dict is key-sorted, so two hosts (or two
  runs) holding equal counts produce byte-identical summaries.

Instances, not a process singleton: each Trainer / MicroBatcher owns its
registry (tests assert exact counts; a shared global would bleed state
between components and test cases), and the CLIs wire one registry through
every component they build when a unified export is wanted.
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence

# default histogram boundaries (upper bounds, ms-friendly): latency-shaped
# work from ~0.1 ms queue waits to minute-long checkpoint writes lands in
# a distinct bucket without per-site tuning. +inf is implicit.
DEFAULT_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)


class Counter:
    """Monotonic float counter. Merge rule: add."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Last-set value plus the max ever set. Merge rule: last wins for
    ``value`` is meaningless across hosts, so merge keeps the max of both
    fields — the cross-host-interesting number for queue depths and
    occupancy is the peak, not one host's last sample."""

    __slots__ = ("_lock", "_value", "_max")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._max = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            if v > self._max:
                self._max = float(v)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += delta
            if self._value > self._max:
                self._max = self._value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def max(self) -> float:
        with self._lock:
            return self._max

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"value": self._value, "max": self._max}


class Histogram:
    """Fixed-bucket histogram: per-bucket counts (non-cumulative), sum,
    count, min, max. Merge rule: counts/sum/count add, min/max extremize —
    so a cross-host merge is exact, not an approximation."""

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count", "_min", "_max")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS):
        bounds = tuple(sorted(float(b) for b in bounds))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self.bounds = bounds
        self._counts = [0.0] * (len(bounds) + 1)  # last = overflow (+inf)
        self._sum = 0.0
        self._count = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        # bisect by hand: bounds are short tuples and this avoids importing
        # bisect under the lock's hot path for nothing
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1.0
            self._sum += v
            self._count += 1.0
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    class _Timer:
        __slots__ = ("_h", "_t0")

        def __init__(self, h: "Histogram"):
            self._h = h

        def __enter__(self):
            import time

            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            import time

            self._h.observe((time.perf_counter() - self._t0) * 1e3)
            return False

    def time_ms(self) -> "_Timer":
        """Context manager observing the wrapped block's wall time in ms."""
        return Histogram._Timer(self)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "bounds": list(self.bounds),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
                "min": self._min if self._count else 0.0,
                "max": self._max if self._count else 0.0,
            }


def _percentile_from_buckets(snap: Dict, pct: float) -> float:
    """Deterministic percentile estimate: linear interpolation inside the
    target bucket, clamped by the observed min/max so tiny samples do not
    report a bucket bound no value ever reached."""
    count = snap["count"]
    if count <= 0:
        return 0.0
    bounds = list(snap["bounds"])
    rank = pct / 100.0 * count
    cum = 0.0
    lo = snap["min"]
    for i, c in enumerate(snap["counts"]):
        if c <= 0:
            continue
        hi = bounds[i] if i < len(bounds) else snap["max"]
        if cum + c >= rank:
            frac = (rank - cum) / c
            est = lo + (hi - lo) * max(0.0, min(1.0, frac))
            return float(min(max(est, snap["min"]), snap["max"]))
        cum += c
        lo = hi
    return float(snap["max"])


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors.

    Names are dotted paths (``train.step_time_ms``, ``serve.queue_depth``);
    OBSERVABILITY.md tables every name the built-in instrumentation emits.
    Re-requesting a name returns the same instrument; requesting an
    existing name as a different kind raises (two subsystems silently
    sharing one name as different types would corrupt both).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, table: Dict, name: str, factory):
        with self._lock:
            inst = table.get(name)
            if inst is None:
                for other in (self._counters, self._gauges, self._histograms):
                    if other is not table and name in other:
                        raise ValueError(
                            f"metric {name!r} already registered as a "
                            "different kind"
                        )
                inst = table[name] = factory()
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(
        self, name: str, bounds: Sequence[float] = DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get(self._histograms, name, lambda: Histogram(bounds))

    def snapshot(self) -> Dict:
        """Plain-dict snapshot: {'counters': {...}, 'gauges': {...},
        'histograms': {...}}, every leaf a float or list of floats."""
        with self._lock:
            c = dict(self._counters)
            g = dict(self._gauges)
            h = dict(self._histograms)
        return {
            "counters": {k: c[k].snapshot() for k in sorted(c)},
            "gauges": {k: g[k].snapshot() for k in sorted(g)},
            "histograms": {k: h[k].snapshot() for k in sorted(h)},
        }

    def summary(self) -> Dict:
        return summarize(self.snapshot())


def merge_snapshots(*snaps: Dict) -> Dict:
    """Merge snapshots by each kind's semantic: counters add, gauges keep
    the max of both fields, histograms add counts/sum/count and extremize
    min/max. Histograms merged under one name must share bucket bounds
    (they do by construction: bounds are part of the instrumented name's
    definition); mismatched bounds raise rather than mis-merge."""
    if not snaps:
        return {"counters": {}, "gauges": {}, "histograms": {}}
    out = {
        "counters": dict(snaps[0].get("counters", {})),
        "gauges": {k: dict(v) for k, v in snaps[0].get("gauges", {}).items()},
        "histograms": {
            k: {**v, "bounds": list(v["bounds"]), "counts": list(v["counts"])}
            for k, v in snaps[0].get("histograms", {}).items()
        },
    }
    for snap in snaps[1:]:
        for k, v in snap.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0.0) + float(v)
        for k, v in snap.get("gauges", {}).items():
            cur = out["gauges"].setdefault(k, {"value": 0.0, "max": 0.0})
            cur["value"] = max(float(cur["value"]), float(v["value"]))
            cur["max"] = max(float(cur["max"]), float(v["max"]))
        for k, v in snap.get("histograms", {}).items():
            cur = out["histograms"].get(k)
            if cur is None:
                out["histograms"][k] = {
                    **v,
                    "bounds": list(v["bounds"]),
                    "counts": list(v["counts"]),
                }
                continue
            if list(cur["bounds"]) != list(v["bounds"]):
                raise ValueError(
                    f"cannot merge histogram {k!r}: bucket bounds differ"
                )
            cur["counts"] = [
                a + b for a, b in zip(cur["counts"], v["counts"])
            ]
            cur["sum"] = cur["sum"] + v["sum"]
            have = cur["count"] > 0
            incoming = v["count"] > 0
            cur["min"] = (
                min(cur["min"], v["min"])
                if have and incoming
                else (v["min"] if incoming else cur["min"])
            )
            cur["max"] = (
                max(cur["max"], v["max"])
                if have and incoming
                else (v["max"] if incoming else cur["max"])
            )
            cur["count"] = cur["count"] + v["count"]
    return out


def summarize(snapshot: Dict) -> Dict:
    """Flat, deterministic (key-sorted) summary of a snapshot: counters as
    values, gauges as value/max, histograms as count/mean/p50/p95/max."""
    out: Dict[str, float] = {}
    for k in sorted(snapshot.get("counters", {})):
        out[k] = snapshot["counters"][k]
    for k in sorted(snapshot.get("gauges", {})):
        g = snapshot["gauges"][k]
        out[f"{k}.value"] = g["value"]
        out[f"{k}.max"] = g["max"]
    for k in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][k]
        n = h["count"]
        out[f"{k}.count"] = n
        out[f"{k}.mean"] = (h["sum"] / n) if n else 0.0
        out[f"{k}.p50"] = _percentile_from_buckets(h, 50.0)
        out[f"{k}.p95"] = _percentile_from_buckets(h, 95.0)
        out[f"{k}.max"] = h["max"]
    return out
