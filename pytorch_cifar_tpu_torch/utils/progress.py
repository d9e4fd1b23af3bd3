"""TTY-safe terminal progress bar with per-step and total wall time (a
copy of ``pytorch_cifar_tpu/utils/progress.py``).

Capability parity with the reference's xlua-style bar (utils.py:52-125)
minus its crash: the reference shells out to ``stty size`` at import time
(utils.py:46-47), which dies in any non-TTY context (CI, piped logs —
SURVEY.md §2.5.10). Here width comes from ``shutil.get_terminal_size`` and
non-TTY streams degrade to periodic plain log lines.
"""

from __future__ import annotations

import shutil
import sys
import time
from typing import Optional

_BAR_FRACTION = 65.0 / 80.0  # bar share of the terminal, like the reference
_last_time: Optional[float] = None
_begin_time: Optional[float] = None


def format_time(seconds: float) -> str:
    """Compact '1D2h3m4s5ms' rendering (parity: utils.py:95-125)."""
    days = int(seconds / 3600 / 24)
    seconds -= days * 3600 * 24
    hours = int(seconds / 3600)
    seconds -= hours * 3600
    minutes = int(seconds / 60)
    seconds -= minutes * 60
    secs = int(seconds)
    millis = int((seconds - secs) * 1000)

    out = ""
    count = 0
    for value, unit in (
        (days, "D"),
        (hours, "h"),
        (minutes, "m"),
        (secs, "s"),
        (millis, "ms"),
    ):
        if value > 0 and count < 2:
            out += f"{value}{unit}"
            count += 1
    return out or "0ms"


def progress_bar(
    current: int, total: int, msg: str = "", stream=None, log_every: int = 50
) -> None:
    """Render step ``current`` of ``total`` (0-based current).

    TTY: in-place bar  [=====>....]  Step: 12ms | Tot: 4s | <msg> 17/391
    non-TTY: one plain line every ``log_every`` steps and on the last step.
    """
    global _last_time, _begin_time
    stream = stream or sys.stdout
    now = time.time()
    if current == 0:
        _begin_time = now
    step_time = now - _last_time if _last_time is not None and current else 0.0
    _last_time = now
    total_time = now - (_begin_time or now)

    tail = f"  Step: {format_time(step_time)} | Tot: {format_time(total_time)}"
    if msg:
        tail += " | " + msg
    counter = f" {current + 1}/{total}"

    if not stream.isatty():
        if current % log_every == 0 or current + 1 >= total:
            stream.write(f"[{current + 1}/{total}]{tail}\n")
            stream.flush()
        return

    cols = shutil.get_terminal_size((80, 24)).columns
    bar_len = max(10, int(cols * _BAR_FRACTION) - 10)
    filled = int(bar_len * (current + 1) / max(total, 1))
    bar = "=" * max(filled - 1, 0) + ">" + "." * (bar_len - filled)
    line = f" [{bar}]{tail}{counter}"
    stream.write("\r" + line[: cols - 1].ljust(cols - 1))
    if current + 1 >= total:
        stream.write("\n")
    stream.flush()
