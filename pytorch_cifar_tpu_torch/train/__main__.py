"""Training CLI of the port, the counterpart of ``train.py``:

    python -m pytorch_cifar_tpu_torch.train --model ResNet18 --batch_size 512
    python -m pytorch_cifar_tpu_torch.train --device cpu --model LeNet \\
        --synthetic_data --epochs 2 --no-amp --output_dir ./checkpoint
    python -m pytorch_cifar_tpu_torch.train ... --resume --epochs 4
    python -m pytorch_cifar_tpu_torch.train ... --evaluate

Flags are the JAX package's (``config.py``) for the ported path, plus
``--device``. Runs on CUDA unless ``--device cpu`` is given. Logs the JAX
trainer's epoch lines to stderr and prints the best test accuracy.
Checkpoints go to ``--output_dir`` in the JAX package's format, so either
trainer resumes the other's run; ``--resume`` continues from the newest
checkpoint there, ``--evaluate`` runs one eval epoch of the best one and
prints its accuracy. SIGTERM stops after the current epoch with the state
saved as ``last.msgpack``; one that lands before the epochs start stops
after the first, and one that lands after the last (the run complete, its
checkpoints on disk) is a no-op: the CLI exits 0. ``--publish staging``
writes every checkpoint into ``<output_dir>/staging`` instead, the canary
pipeline's input (``serve/canary.py``; ``python -m
pytorch_cifar_tpu_torch.tools.pipeline_run`` runs the whole loop).

The host loader, the divergence sentinel, remat and the trainer's
observability:

    python -m pytorch_cifar_tpu_torch.train ... --no-device_data \
        [--host_augment] [--async_input off] [--prefetch 2]
    python -m pytorch_cifar_tpu_torch.train ... --sentinel rollback \
        --sentinel_budget 3
    python -m pytorch_cifar_tpu_torch.train ... --remat
    python -m pytorch_cifar_tpu_torch.train ... --metrics_out m.jsonl \
        --metrics_every_s 10 --trace_out trace.json --log_every 50 --profile

``--sentinel`` (default ``skip``) discards a step whose loss or gradient
norm is not finite; ``rollback`` also restores the newest checkpoint after
``--sentinel_budget`` consecutive bad steps; ``off`` applies it.
``PCT_FAULTS`` arms the fault hooks (``faults.py``).

Data parallelism, one process per device:

    python -m pytorch_cifar_tpu_torch.train --num_devices 4 ...
    python -m pytorch_cifar_tpu_torch.train --device cpu --num_devices 2 \\
        --model LeNet --synthetic_data
    python -m pytorch_cifar_tpu_torch.train --distributed \\
        --dist_coord HOST:PORT --dist_procs N --dist_rank K ...

``--num_devices N`` (0, the default: every visible card; one process on
the CPU) starts N local ranks in one launch, spawned, over a free
localhost port: NCCL on N cards, or gloo under ``--device cpu``. It is
the counterpart of the JAX package's one-process N-device mesh; a
SIGTERM to the launch is passed to every rank, and the launch fails if
any rank fails. ``--distributed`` makes this process one rank of a job
(``--dist_*``, or ``torchrun``'s environment when ``--dist_coord`` is
empty). Rank 0 logs to the console and ``<output_dir>/train.log``, rank
K > 0 to ``train.rankK.log`` and warnings only to the console.

Spatial partitioning (``parallel/spatial.py``):

    python -m pytorch_cifar_tpu_torch.train --num_devices 4 \
        --spatial_devices 2 [--spatial_w_devices 2] --model ResNet18 ...

``--spatial_devices S`` cuts each image's height over S ranks and
``--spatial_w_devices W`` its width over W; the world (``--num_devices``
or the job's) is ``data x S x W`` ranks, and the global batch divides over
the ``data`` axis. Each rank trains on its slab, with halo exchanges at
every conv and pool and BN moments pooled over every rank; the step equals
one process's on the global batch. S and W must divide 32 and their
product the world; W > 1 needs the device-resident data plane. Every
model of the registry is held (the default, SimpleDLA, too); a model
outside it raises ``NotImplementedError``.

Elastic training (``train/elastic.py``):

    python -m pytorch_cifar_tpu_torch.train --elastic_procs 2 ...
    python -m pytorch_cifar_tpu_torch.train --device cpu --elastic_procs 2 \\
        --model LeNet --synthetic_data --epochs 6 --output_dir ./checkpoint

``--elastic_procs N`` makes this process a supervisor, which loads no
torch: it runs N ranks of this command line (``--distributed --elastic``
on a localhost rendezvous, one card each), relaunches the surviving world
with ``--resume`` when a rank dies, and prints one JSON record; the exit
code is 0 when the run completed, else 1. ``--elastic`` marks a rank of
such a run: its resume re-cuts the checkpoint layout to its world, and in
a world of several ranks a ``fit`` that raises, or a peer lost (its
heartbeat silent for ``elastic.PEER_TIMEOUT_S``), exits 75 for the
supervisor.
"""

from __future__ import annotations

import signal
import threading

from pytorch_cifar_tpu_torch.config import parse_config


def main(argv=None, rank_hook=None, stop=None) -> dict:
    """Train; returns the best test accuracy (``fit``'s value, what
    ``train.py`` returns), rank 0's per-epoch history, whose ``train`` and
    ``eval`` entries carry the JAX step's metric totals (``loss_sum``,
    ``correct``, ``count``, ``nonfinite``; global under data
    parallelism), and every rank's result (``train.launch.run``) under
    ``ranks``. ``rank_hook(trainer)`` (a picklable callable, for checks
    and tools) runs on every rank after ``fit``. ``stop`` (an event the
    CLI's SIGTERM handler sets) asks a run whose epochs have not begun to
    stop after the first."""
    config = parse_config(argv)
    if config.elastic_procs > 0:
        # supervisor mode: spawns and supervises N ranks of this command
        # line, before anything here loads torch (it holds no device)
        from pytorch_cifar_tpu_torch.train.elastic import run_supervisor

        raise SystemExit(run_supervisor(config, argv))
    from pytorch_cifar_tpu_torch.train.launch import launch, local_ranks, run

    n = local_ranks(config)
    if not config.distributed:
        # a spatial run that cannot be is refused before a rank starts
        from pytorch_cifar_tpu_torch.train.trainer import (
            check_spatial,
            device_data_plane,
        )

        check_spatial(config, n, device_data_plane(config))
    ranks = (launch(config, n, rank_hook, stop) if n > 1
             else [run(config, rank_hook, stop)])
    best = ranks[0]["best_acc"]
    if ranks[0]["rank"] == 0:
        what = "test accuracy" if config.evaluate else "best test accuracy"
        print(f"{what}: {best:.2f}%")
    return {"best_acc": best, "history": ranks[0]["history"], "ranks": ranks}


if __name__ == "__main__":
    # SIGTERM is a stop request for the CLI's whole life: Trainer.fit
    # installs its own handler for the epochs and puts this one back, so a
    # signal after the run finds it, not the default, and is a no-op
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    main(stop=stop)
    # the run is complete and on disk. The interpreter's teardown (most of
    # a second after torch) puts a Python handler back to the default
    # early on, but leaves an ignored signal ignored
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
