"""Training configuration and CLI parsing of the port: its own copy of
``TrainConfig``/``_add_args``/``parse_config`` from
``pytorch_cifar_tpu/config.py``, with the fields the ported training path
reads, under the same names, defaults and flag spellings (booleans take
``--flag``/``--no-flag``), plus ``--device``.

Flags of paths not ported yet are not here, with two exceptions parsed
so that asking for them fails with "not ported yet" instead of an unknown
flag: ``--no-device_data`` (the host loader) and ``--publish staging``
(the canary pipeline).
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
    # the dataset lives on the device and each epoch is one gather + steps
    # (the only data plane ported so far)
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
    # cross-replica BatchNorm: the ranks' batch moments are averaged so
    # normalization uses global-batch statistics. Default off = the
    # reference's per-replica BN under DDP
    sync_bn: bool = False

    # checkpoints (the JAX package's format v2, train/checkpoint.py)
    output_dir: str = "./checkpoint"
    # "live" publishes into output_dir; "staging" (the canary pipeline's
    # input) is not ported yet
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

    seed: int = 0
    device: str = "cuda"  # "cpu" runs the port on the CPU

    @property
    def t_max(self) -> int:
        return self.cosine_t_max if self.cosine_t_max is not None else self.epochs


def check_ported(config: TrainConfig) -> None:
    """Raise for what the configuration asks of paths not ported yet."""
    if config.publish == "staging":
        raise NotImplementedError(
            "--publish staging is not ported yet (the canary pipeline comes "
            "with a later slice)"
        )
    if not config.device_data:
        raise NotImplementedError(
            "--no-device_data is not ported yet (the host loader comes "
            "with a later slice)"
        )


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
