"""Waiting for SIGTERM/SIGINT in a process that has other threads."""

from __future__ import annotations

import threading
import time

# how long the main thread may block before it runs a pending handler
TICK_S = 0.5


def wait_for_stop(stop: threading.Event, duration_s: float = 0.0) -> None:
    """Block until ``stop`` is set (by a signal handler) or ``duration_s``
    seconds passed (0: no limit), waking at least every ``TICK_S`` seconds.

    Python runs a signal's handler in the main thread, and only when that
    thread runs bytecode. The kernel may hand a process's signal to any of
    its threads (a CUDA or worker thread); an untimed ``stop.wait()`` in
    the main thread is then never interrupted, and the handler never
    runs. A timed wait wakes, runs the pending handler and sees ``stop``."""
    deadline = time.monotonic() + duration_s if duration_s else None
    while True:
        tick = TICK_S
        if deadline is not None:
            tick = min(tick, deadline - time.monotonic())
            if tick <= 0:
                return
        if stop.wait(tick):
            return
