"""Host-side trace spans: Chrome/Perfetto trace-event JSON.

A copy of ``pytorch_cifar_tpu/obs/trace.py`` with the JAX profiler
annotation replaced: ``span("serve/bucket_forward", bucket=b)`` times a
host-side region, records it as a Chrome trace-event "complete" event
(``ph: "X"``), and enters ``torch.profiler.record_function`` so that, inside
a ``torch.profiler`` capture, the span lines up with the CUDA kernels it
launched. Nesting needs no begin/end pairing: viewers reconstruct the stack
from (tid, ts, dur).

A process has at most one installed tracer (module-level, like the stdlib
logging root): instrumentation sites call ``trace.span(...)``
unconditionally, and when nothing is installed they get one shared no-op
context manager — no allocation, no lock, no thread.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import torch


class _NullSpan:
    """Shared no-op context manager: the whole disabled-mode cost."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0", "_rf")

    def __init__(self, tracer: "Tracer", name: str, args):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._rf = None

    def __enter__(self):
        if self._tracer.profiler_annotations:
            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur_us = (time.perf_counter_ns() - self._t0) / 1e3
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._tracer._emit(
            {
                "name": self._name,
                "ph": "X",
                "ts": (self._t0 - self._tracer._epoch_ns) / 1e3,
                "dur": dur_us,
                "pid": self._tracer.pid,
                "tid": threading.get_ident() & 0x7FFFFFFF,
                **({"args": self._args} if self._args else {}),
            }
        )
        return False


class Tracer:
    """Buffered trace-event collector writing ``{"traceEvents": [...]}``.

    ``flush()`` rewrites the whole file each call (atomic tmp+rename like
    the checkpoint writer), so a crashed run still leaves a valid,
    openable trace of everything emitted before the crash. Events buffer
    in memory between flushes — a run emits thousands of spans, not
    millions; per-kernel events stay the profiler's job.
    """

    def __init__(self, path: str, *, profiler_annotations: bool = True):
        self.path = path
        self.pid = os.getpid()
        self.profiler_annotations = profiler_annotations
        self._lock = threading.Lock()
        self._events: list = []
        self._epoch_ns = time.perf_counter_ns()

    def _emit(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker (``ph: "i"``): one-shot occurrences like
        a checkpoint fallback or a sentinel skip."""
        self._emit(
            {
                "name": name,
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3,
                "pid": self.pid,
                "tid": threading.get_ident() & 0x7FFFFFFF,
                **({"args": args} if args else {}),
            }
        )

    def flush(self) -> None:
        with self._lock:
            events = list(self._events)
        payload = json.dumps(
            {"traceEvents": events, "displayTimeUnit": "ms"}
        )
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = self.path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(payload)
        # rename-atomicity for concurrent readers is the contract;
        # durability after a host crash is worthless for a trace dump
        os.replace(tmp, self.path)


_installed: Optional[Tracer] = None


def install(path: str, *, profiler_annotations: bool = True) -> Tracer:
    """Install the process tracer (idempotent per path: reinstalling over
    a different path replaces the tracer after flushing the old one)."""
    global _installed
    if _installed is not None and _installed.path != path:
        _installed.flush()
    if _installed is None or _installed.path != path:
        _installed = Tracer(path, profiler_annotations=profiler_annotations)
    return _installed


def uninstall(flush: bool = True) -> None:
    global _installed
    if _installed is not None and flush:
        _installed.flush()
    _installed = None


def installed() -> Optional[Tracer]:
    return _installed


def span(name: str, **args):
    """A span on the installed tracer, or the shared no-op when none is
    installed. The call sites never branch — this function is the single
    disabled-mode gate."""
    t = _installed
    if t is None:
        return _NULL_SPAN
    return t.span(name, **args)


def instant(name: str, **args) -> None:
    t = _installed
    if t is not None:
        t.instant(name, **args)


def flush() -> None:
    t = _installed
    if t is not None:
        t.flush()
