"""Launching training: in this process, or as N local ranks of a
data-parallel job (the train CLI's ``--num_devices`` and ``--dist_*``; see
``train/__main__.py``).

:func:`run` trains in this process, alone or as one rank of the job its
config names, and returns this rank's result. :func:`launch` spawns N
local ranks over a free localhost port (NCCL on N cards, gloo on the CPU)
and returns their results; it lives here, not in the CLI's ``__main__``,
because a spawned process imports its target by module name.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import socket
import tempfile
import threading
from typing import Callable, Optional

import torch

from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.config import TrainConfig
from pytorch_cifar_tpu_torch.ops import (
    bn_stats,
    conv_bn_relu,
    depthwise_stencil,
    dma_gather,
    max_pool,
)
from pytorch_cifar_tpu_torch.utils.logging import set_logger

# a rank hook: (Trainer) -> a value torch.save can write
RankHook = Optional[Callable]


def _launches() -> dict:
    """Launch counts of every kernel of the training path. Under
    ``--remat`` the recomputed forward launches K2 (when hooked) and K4's
    forward again, and their counts include it."""
    return {
        "dma_row_gather": dma_gather.LAUNCHES,
        "fused_moments": bn_stats.LAUNCHES,
        "conv3x3_bn_relu": conv_bn_relu.LAUNCHES,
        "max_pool3x3_s1": max_pool.FWD_LAUNCHES,
        "max_pool3x3_s1_bwd": max_pool.BWD_LAUNCHES,
        "depthwise_stencil": depthwise_stencil.LAUNCHES,
    }


def local_ranks(config: TrainConfig) -> int:
    """How many local ranks the launch starts: ``--num_devices``, every
    visible card for 0, one process on the CPU or for a process that
    joins a job itself. Raises where CUDA is asked for and absent."""
    dev = resolve_device(config.device)
    if config.distributed:
        if config.num_devices > 1:
            raise ValueError(
                "--num_devices N > 1 starts N local ranks; a process that "
                "joins a job with --distributed is one rank"
            )
        return 1
    have = torch.cuda.device_count() if dev.type == "cuda" else None
    n = config.num_devices or (have or 1)
    if have is not None and n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return n


def _rank_logging(config: TrainConfig) -> Optional[str]:
    """Rank-aware logs (:func:`~..utils.logging.set_logger`): the console
    at INFO on rank 0 and at WARNING on the others, and each rank's file
    in ``output_dir`` (``train.log`` for rank 0, ``train.rankK.log``).
    Returns the file's path."""
    r = 0
    if config.distributed:
        r = (config.dist_rank if config.dist_coord
             else int(os.environ.get("RANK", "0")))
    path = None
    if config.output_dir:
        path = os.path.abspath(os.path.join(
            config.output_dir, "train.log" if r == 0 else f"train.rank{r}.log"))
    set_logger(path, process_index=r)
    return path


def _close_log_file(path: Optional[str]) -> None:
    root = logging.getLogger()
    for h in list(root.handlers):
        if isinstance(h, logging.FileHandler) and h.baseFilename == path:
            root.removeHandler(h)
            h.close()


def run(config: TrainConfig, rank_hook: RankHook = None,
        stop: Optional[threading.Event] = None) -> dict:
    """Train in this process (alone, or as one rank); returns this rank's
    result: ``rank``, ``world``, ``backend``, ``device``, ``best_acc``,
    ``history``, the kernels' launches over ``fit``
    (``launches_by_kernel``), and what ``rank_hook(trainer)`` returns
    after ``fit``, inside the process group (``hook``). A ``stop`` already
    set when the trainer is built (the CLI's SIGTERM before the epochs)
    stops the run after its first epoch, with ``last.msgpack`` saved."""
    from pytorch_cifar_tpu_torch.train.trainer import Trainer

    log_path = _rank_logging(config)
    try:
        trainer = Trainer(config)
        try:
            if stop is not None and stop.is_set():
                trainer.request_stop()
            before = _launches()
            best = trainer.fit()
            launches = {k: v - before[k] for k, v in _launches().items()}
            out = {
                "rank": trainer.rank, "world": trainer.world,
                "backend": (torch.distributed.get_backend()
                            if trainer.data_parallel else None),
                "device": str(trainer.device), "best_acc": best,
                "history": trainer.history, "launches_by_kernel": launches,
            }
            if rank_hook is not None:
                out["hook"] = rank_hook(trainer)
            return out
        finally:
            trainer.close()
    finally:
        _close_log_file(log_path)


def _rank_entry(r: int, configs, out_dir: str, rank_hook) -> None:
    torch.save(run(configs[r], rank_hook),
               os.path.join(out_dir, f"rank{r}.pt"))


def free_port() -> int:
    """A free TCP port on localhost (for a rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(config: TrainConfig, n: int, rank_hook: RankHook = None,
           stop: Optional[threading.Event] = None) -> list:
    """Start ``n`` local ranks of ``config``'s run (spawned, rendezvous on
    a free localhost port) and return their results in rank order. A rank
    that fails ends the launch: the others are stopped and the failure is
    raised. A SIGTERM here, or a ``stop`` set before the ranks started, is
    passed to every rank."""
    port = free_port()
    configs = [dataclasses.replace(
        config, num_devices=n, distributed=True,
        dist_coord=f"localhost:{port}", dist_procs=n, dist_rank=r)
        for r in range(n)]
    with tempfile.TemporaryDirectory(prefix="train_ranks_") as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_entry, args=(configs, tmp, rank_hook), nprocs=n,
            join=False, start_method="spawn",
        )

        def forward_sigterm(signum, frame):
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()

        old = None
        if threading.current_thread() is threading.main_thread():
            old = signal.signal(signal.SIGTERM, forward_sigterm)
        if stop is not None and stop.is_set():
            forward_sigterm(signal.SIGTERM, None)
        try:
            while not ctx.join(grace_period=5.0):
                pass
        finally:
            if old is not None:
                signal.signal(signal.SIGTERM, old)
        # files this launch's ranks wrote
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
