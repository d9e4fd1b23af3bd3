"""File + console logging, rank-aware under data parallelism (a copy of
``pytorch_cifar_tpu/utils/logging.py``; the reference's ``utils.py:128-141``,
installed at ``main_dist.py:88``)."""

from __future__ import annotations

import logging
import os
from typing import Optional


def set_logger(
    log_path: Optional[str] = None, process_index: int = 0
) -> logging.Logger:
    """Configure the root logger with a console handler and, when
    ``log_path`` is given, a file handler. Idempotent.

    ``process_index``: under data parallelism every rank runs the same
    epoch loop, so an unfiltered console would print every epoch line N times
    interleaved. Non-zero ranks keep their console at WARNING (problems
    still surface, narration does not) while the file handler — callers
    pass a rank-distinct ``log_path`` — records everything, so a per-rank
    post-mortem loses nothing. Re-calling with a different index adjusts
    the existing console handler (idempotency must not freeze the first
    caller's rank).
    """
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    console_level = logging.INFO if process_index == 0 else logging.WARNING

    stream = next(
        (h for h in logger.handlers if type(h) is logging.StreamHandler),
        None,
    )
    if stream is None:
        stream = logging.StreamHandler()
        stream.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(stream)
    stream.setLevel(console_level)

    if log_path:
        log_path = os.path.abspath(log_path)
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        have_file = any(
            isinstance(h, logging.FileHandler)
            and getattr(h, "baseFilename", None) == log_path
            for h in logger.handlers
        )
        if not have_file:
            fh = logging.FileHandler(log_path)
            fh.setFormatter(
                logging.Formatter("%(asctime)s:%(levelname)s: %(message)s")
            )
            logger.addHandler(fh)
    return logger
