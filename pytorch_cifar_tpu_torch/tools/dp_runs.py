"""Short data-parallel training runs on the card, beside one-process runs
of the same configuration, to read how far a data-parallel run's losses
and accuracies lie from one process's against the spread between seeds:

    python -m pytorch_cifar_tpu_torch.tools.dp_runs [--seeds 0 1]

Each run is the train CLI's ResNet-18 at batch 512, bf16, 2 epochs on
``synthetic_cifar10(10240, 2048)`` (20 steps an epoch), device data, K1
gather: one process at each seed; the visible cards as NCCL ranks (one
card: ``--distributed`` with a world of 1); and, on one card, where NCCL
refuses two ranks, a gloo pair on ``cuda:0`` (:func:`gloo_pair`, which
``chip_smoke.py`` also runs) at each seed. Prints one JSON line a run
(per-epoch train loss and accuracy, eval loss and accuracy, img/s) after
the card's name and power limit. Card only.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from pytorch_cifar_tpu_torch.tools._bench import card_line

TRAIN_N, TEST_N = 10_240, 2_048


def run_argv(out_dir: str, train_n: int = TRAIN_N,
             test_n: int = TEST_N) -> list:
    """The train CLI's flags of these runs: ResNet-18 at full width,
    global batch 512, bf16, device data, K1 gather, 2 epochs."""
    return ["--model", "ResNet18", "--batch_size", "512",
            "--synthetic_data", "--synthetic_train_size", str(train_n),
            "--synthetic_test_size", str(test_n), "--epochs", "2",
            "--cosine_t_max", "2", "--dma_gather", "--output_dir", out_dir]


def _gloo_rank(r: int, port: int, argv: list, out_dir: str, hook) -> None:
    import torch.distributed as dist

    from pytorch_cifar_tpu_torch.config import parse_config
    from pytorch_cifar_tpu_torch.train.launch import run

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=r)
    try:
        res = run(parse_config(argv + [
            "--distributed", "--dist_coord", f"localhost:{port}",
            "--dist_procs", "2", "--dist_rank", str(r)]), hook)
        torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))
    finally:
        dist.destroy_process_group()


def gloo_pair(argv: list, rank_hook=None) -> list:
    """Two ranks of the train CLI's run ``argv``, both on ``cuda:0``, in a
    process group made here with the gloo backend, which the ranks' trainers
    join (the trainer itself takes NCCL on CUDA, and NCCL refuses two ranks
    on one card). Returns the ranks' results (``train.launch.run``)."""
    from pytorch_cifar_tpu_torch.train.launch import free_port

    with tempfile.TemporaryDirectory(prefix="gloo_pair_") as tmp:
        torch.multiprocessing.start_processes(
            _gloo_rank, args=(free_port(), argv, tmp, rank_hook), nprocs=2,
            join=True, start_method="spawn")
        # files the two ranks wrote
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]


def _summary(tag: str, ranks: list) -> dict:
    return {"run": tag, "backend": ranks[0]["backend"],
            "world": ranks[0]["world"],
            "epochs": [{k: h[k] for k in ("train_loss", "train_acc",
                                          "eval_loss", "eval_acc",
                                          "img_per_sec")}
                       for h in ranks[0]["history"]]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dp_runs: CUDA is not available; card only")
    from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
    from pytorch_cifar_tpu_torch.train.launch import free_port

    print(card_line(), flush=True)
    count = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="dp_runs_") as root:
        for seed in args.seeds:
            d = os.path.join(root, f"one_{seed}")
            out = train_main(run_argv(d) + ["--seed", str(seed),
                                            "--num_devices", "1"])
            print(json.dumps(_summary(f"one process, seed {seed}",
                                      out["ranks"])), flush=True)
        d = os.path.join(root, "nccl")
        world = ["--num_devices", str(count)] if count > 1 else [
            "--distributed", "--dist_coord", f"localhost:{free_port()}",
            "--dist_procs", "1", "--dist_rank", "0"]
        out = train_main(run_argv(d) + world)
        print(json.dumps(_summary("nccl", out["ranks"])), flush=True)
        if count == 1:
            for seed in args.seeds:
                d = os.path.join(root, f"gloo_{seed}")
                ranks = gloo_pair(run_argv(d) + ["--seed", str(seed)])
                print(json.dumps(_summary(f"gloo pair, seed {seed}",
                                          ranks)), flush=True)


if __name__ == "__main__":
    main()
