"""Training configuration and CLI parsing of the port: its own copy of
``TrainConfig``/``_add_args``/``parse_config`` from
``pytorch_cifar_tpu/config.py``, with the fields the ported training path
reads, under the same names, defaults and flag spellings (booleans take
``--flag``/``--no-flag``), plus ``--device``.

Flags of paths not ported yet are not here.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class TrainConfig:
    # model (the reference's default; the port raises until it is ported)
    model: str = "SimpleDLA"
    num_classes: int = 10

    # optimization (the reference recipe)
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    epochs: int = 200
    cosine_t_max: Optional[int] = None  # None -> epochs

    # data
    batch_size: int = 128
    eval_batch_size: int = 1000
    # train on every image every epoch: the ragged tail batch is
    # wrap-padded to a static shape with -1 labels masked out
    drop_last: bool = False
    data_dir: str = "./data"
    synthetic_data: bool = False  # run without the CIFAR-10 archive
    synthetic_train_size: int = 2048
    synthetic_test_size: int = 512
    random_crop: bool = True
    random_flip: bool = True
    # crop + flip on the host through the native data plane
    # (native/cifar_native.cpp) instead of on the device; takes the host
    # loader, and the train step normalizes only
    host_augment: bool = False
    # the host loader (data/pipeline.Dataloader, --no-device_data or
    # --host_augment): prefetch is the bounded queue's depth of batches
    # ahead of the consumer; async_input "on" assembles and copies them on
    # a producer thread, "off" inline. Both yield the same batches in the
    # same order.
    prefetch: int = 2
    async_input: str = "on"
    # the dataset lives on the device and each epoch is one gather + steps;
    # --no-device_data takes the host loader and the per-step loop
    device_data: bool = True
    # the epoch gather through kernel K1 (ops/dma_gather.py) on a CUDA
    # device; --no-dma_gather takes the library gather (index_select)
    dma_gather: bool = True
    # draw each epoch's permutation on the device; --no-device_perm uses
    # the host RandomState stream (the JAX package's integers)
    device_perm: bool = True
    mean: Tuple[float, float, float] = (0.4914, 0.4822, 0.4465)
    std: Tuple[float, float, float] = (0.2023, 0.1994, 0.2010)

    # precision: bf16 compute, fp32 params/BN stats/loss
    amp: bool = True
    # recompute the forward during the backward
    # (torch.utils.checkpoint): activation memory for compute
    remat: bool = False

    # parallelism: one process per device, data parallel over the
    # default process group (parallel/). num_devices: local devices the
    # CLI starts one rank each for (0 = every visible card; one process
    # on the CPU)
    num_devices: int = 0
    # join a multi-process job: torch.distributed.init_process_group,
    # NCCL on CUDA, gloo on the CPU. dist_coord "host:port" (rank 0's TCP
    # store) with the world size and this rank; left empty, the group
    # reads torchrun's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK
    distributed: bool = False
    dist_coord: str = ""
    dist_procs: int = 0
    dist_rank: int = 0
    # elastic training (train/elastic.py).
    #   elastic       — THIS RANK runs under an elastic supervisor: on
    #                   resume, rank 0 re-cuts the on-disk checkpoint
    #                   layout to the current world size
    #                   (checkpoint.reshard_to_world — a v3 save by M
    #                   processes restores into any N-world already;
    #                   this keeps the dir's layout canonical), and a
    #                   mid-fit failure in a multi-process world (a peer
    #                   lost: its collective raising, or its heartbeat
    #                   silent for elastic.PEER_TIMEOUT_S) exits with the
    #                   elastic reshape code (75) so the supervisor
    #                   relaunches the surviving world with --resume
    #                   instead of declaring the run dead.
    #   elastic_procs — supervisor mode of the train CLI: spawn this many
    #                   ranks under train.elastic.ElasticTrainRunner,
    #                   which turns a preempted (or added) host into a
    #                   terminate → relaunch-at-new-world-size → resume
    #                   cycle from the last durable checkpoint. 0 = off.
    elastic: bool = False
    elastic_procs: int = 0
    # cross-replica BatchNorm: the ranks' batch moments are averaged so
    # normalization uses global-batch statistics. Default off = the
    # reference's per-replica BN under DDP
    sync_bn: bool = False
    # spatial partitioning (parallel/spatial.py): cut each image's height
    # over this many ranks, with explicit halo exchanges at every conv
    # and pool and BN moments pooled over every rank (global BN, so
    # sync_bn has nothing to add). 1 = pure data parallel (the
    # reference's scope). The world is data x spatial_devices x
    # spatial_w_devices ranks. The vision analogue of sequence/context
    # parallelism
    spatial_devices: int = 1
    # also cut the image's WIDTH over this many ranks: halo exchanges in
    # both directions. Needs the device-resident data plane (the host
    # loader serves batch x height slabs only)
    spatial_w_devices: int = 1

    # checkpoints (the JAX package's format v2, train/checkpoint.py)
    output_dir: str = "./checkpoint"
    # "live" publishes into output_dir; "staging" writes every checkpoint
    # (best, preemption, history) into output_dir/staging, the canary
    # pipeline's input, and resumes from there
    publish: str = "live"
    # "on": a save takes its snapshot on the training thread and commits
    # on a background writer; "off": it commits inline. Both write the
    # same bytes.
    async_save: str = "on"
    # write the best-state snapshot to disk at most once per this many
    # epochs (plus the first improvement and a final flush); 0 = every
    # improvement
    checkpoint_every: int = 25
    # rolling history: copies of each file's last N versions as extra
    # restore candidates; 0 = none
    keep_last_n: int = 2
    resume: bool = False
    evaluate: bool = False  # load the best checkpoint, run eval only

    # divergence sentinel: what a train step whose loss or gradient norm
    # is not finite does. "off": its update is applied (NaN poisons the
    # run); "skip": it is discarded on the device, the step counter still
    # advancing; "rollback": skipped, and after sentinel_budget
    # consecutive bad steps the newest checkpoint is restored
    sentinel: str = "skip"
    sentinel_budget: int = 3

    # observability, off by default: trace_out writes the host spans as
    # Chrome trace-event JSON; metrics_out appends a registry snapshot as
    # JSONL every metrics_every_s seconds and once at exit
    trace_out: str = ""
    metrics_out: str = ""
    metrics_every_s: float = 10.0

    seed: int = 0
    # the per-step loop's progress: metrics fetched every log_every steps
    log_every: int = 50
    # torch.profiler over ~20 steady steps, written under output_dir
    profile: bool = False
    device: str = "cuda"  # "cpu" runs the port on the CPU

    @property
    def t_max(self) -> int:
        return self.cosine_t_max if self.cosine_t_max is not None else self.epochs


def _add_args(parser: argparse.ArgumentParser, cls=TrainConfig) -> None:
    for f in dataclasses.fields(cls):
        name = "--" + f.name
        if isinstance(f.default, bool):
            parser.add_argument(
                name, action=argparse.BooleanOptionalAction, default=f.default
            )
        elif f.name in ("mean", "std"):
            parser.add_argument(
                name, type=float, nargs=3, default=list(f.default)
            )
        elif f.name == "cosine_t_max":
            parser.add_argument(name, type=int, default=None)
        elif f.name == "device":
            parser.add_argument(name, default=f.default, choices=["cuda", "cpu"])
        else:
            parser.add_argument(name, type=type(f.default), default=f.default)


def parse_config(argv=None) -> TrainConfig:
    parser = argparse.ArgumentParser(
        prog="python -m pytorch_cifar_tpu_torch.train",
        description="CIFAR-10 training on PyTorch/CUDA",
    )
    _add_args(parser)
    d = vars(parser.parse_args(argv))
    for key in ("mean", "std"):
        d[key] = tuple(d[key])
    return TrainConfig(**d)
