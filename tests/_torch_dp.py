"""Two-rank gloo jobs of the port for the data-parallel tests.

:func:`run_job` writes a list of tasks to ``<dir>/job.pt``, starts one
worker process per rank (``python tests/_torch_dp.py RANK WORLD PORT
DIR``) on a free localhost port, as ``tests/test_multihost.py`` starts its
JAX workers, and returns each rank's results, keyed by task name. A worker
imports torch and the port only, joins the gloo group with
``parallel.mesh.initialize_distributed`` and runs every task in order, so
one job pays the workers' start once.

Tasks (``kind``):

- ``step``: ``make_train_step(axis_name=DATA_AXIS)`` steps from the
  given ``state_dict`` in the given compute dtype, each rank on its
  contiguous shard of every global batch (the rows ``shard_map`` gives its
  device); returns the state dict,
  the momentum buffers and each step's metrics;
- ``eval``: the sharded eval epoch's metric totals;
- ``augment``: two augmenting data-parallel steps, recording the draws
  the step asks the state for;
- ``perm``: ``DeviceDataset.staged_perm`` on both permutation streams;
- ``ckpt``: restore a checkpoint written by one process, then save it
  from every rank (format v3);
- ``sigterm``: a LeNet ``Trainer`` run in which rank 1 alone gets a
  SIGTERM during epoch 0.
"""

import os
import signal
import socket
import subprocess
import sys

WORKER = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(WORKER))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_job(tasks, job_dir, world=2, timeout=300):
    """Run ``tasks`` on ``world`` gloo ranks; returns ``[rank results]``."""
    import torch

    os.makedirs(job_dir, exist_ok=True)
    torch.save({"tasks": tasks}, os.path.join(job_dir, "job.pt"))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), str(port), job_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for r in range(world)
    ]
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(os.path.join(job_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# -- the worker -------------------------------------------------------------

def _port_model(name):
    from pytorch_cifar_tpu_torch.models import create_model
    from pytorch_cifar_tpu_torch.models.resnet import BasicBlock, ResNet

    if name == "ResNetTiny":
        return ResNet(BasicBlock, (1, 1, 1, 1))
    return create_model(name)


def _state(t):
    import torch

    from pytorch_cifar_tpu_torch.train import optim
    from pytorch_cifar_tpu_torch.train.state import create_train_state

    model = _port_model(t["model"])
    if "sd" in t:
        model.load_state_dict(t["sd"])
    model = model.to(memory_format=torch.channels_last)
    return create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=t["lr"]),
        optim.cosine_epoch_schedule(t["lr"], t["t_max"], t["spe"]),
        seed=t.get("seed", 0), device="cpu",
    )


def _tensors(state):
    params = dict(state.model.named_parameters())
    return {
        "sd": {k: v.detach().clone()
               for k, v in state.model.state_dict().items()},
        "mom": {k: state.optimizer.state[p]["momentum_buffer"].clone()
                for k, p in params.items() if p in state.optimizer.state},
        "step": state.step,
    }


def _shard(arr, r, w):
    import torch

    n = len(arr) // w
    return torch.from_numpy(arr[r * n:(r + 1) * n])


def task_step(t, job_dir):
    import torch

    from pytorch_cifar_tpu_torch.parallel.mesh import (
        DATA_AXIS, rank, world_size)
    from pytorch_cifar_tpu_torch.train import steps

    state = _state(t)
    step = steps.make_train_step(
        augment=False, axis_name=DATA_AXIS, sync_bn=t["sync_bn"],
        compute_dtype=getattr(torch, t["compute"]), device="cpu")
    r, w = rank(), world_size()
    metrics = []
    for x, y in t["batches"]:
        m = step(state, (_shard(x, r, w), _shard(y, r, w)))
        metrics.append({k: float(v) for k, v in m.items()})
    return {**_tensors(state), "metrics": metrics}


def task_eval(t, job_dir):
    import torch

    from pytorch_cifar_tpu_torch.parallel.mesh import DATA_AXIS, world_size
    from pytorch_cifar_tpu_torch.train import steps

    state = _state(t)
    epoch = steps.make_eval_epoch(
        steps.make_eval_step(axis_name=DATA_AXIS, device="cpu"),
        global_batch=t["global_batch"], n_data=len(t["images"]),
        num_steps=t["num_steps"], axis_name=DATA_AXIS,
        n_shards=world_size(),
    )
    totals = epoch(state, torch.from_numpy(t["images"]),
                   torch.from_numpy(t["labels"]))
    return {k: float(v) for k, v in totals.items()}


def task_augment(t, job_dir):
    from pytorch_cifar_tpu_torch.parallel.mesh import (
        DATA_AXIS, rank, world_size)
    from pytorch_cifar_tpu_torch.train import steps

    state = _state(t)
    draws = []
    draw = state.draw_augment

    def recorded(n, padding=4, shard=None):
        out = draw(n, padding, shard=shard)
        draws.append((state.step, shard, out[0].clone(), out[1].clone()))
        return out

    state.draw_augment = recorded
    step = steps.make_train_step(axis_name=DATA_AXIS, device="cpu")
    r, w = rank(), world_size()
    x, y = t["batch"]
    for _ in range(2):
        step(state, (_shard(x, r, w), _shard(y, r, w)))
    return draws


def task_perm(t, job_dir):
    from pytorch_cifar_tpu_torch.data.pipeline import DeviceDataset

    out = {}
    for device_perm in (False, True):
        ds = DeviceDataset(t["images"], t["labels"], batch_size=t["batch"],
                           seed=t["seed"], device_perm=device_perm,
                           device="cpu")
        out[device_perm] = [ds.staged_perm(e).clone() for e in range(2)]
    return out


def task_ckpt(t, job_dir):
    from pytorch_cifar_tpu_torch.train import checkpoint as ckpt

    state = _state(t)
    _, start, best = ckpt.restore_checkpoint(t["src"], state)
    path = ckpt.save_checkpoint(t["dst"], state, start - 1, best,
                                keep_last_n=t["keep_last_n"])
    return {**_tensors(state), "start": start, "best": best, "path": path}


def task_sigterm(t, job_dir):
    from pytorch_cifar_tpu_torch.config import TrainConfig
    from pytorch_cifar_tpu_torch.parallel.mesh import rank
    from pytorch_cifar_tpu_torch.train.trainer import Trainer

    trainer = Trainer(TrainConfig(**t["config"]))
    if rank() == 1:
        run_epoch = trainer._run_epoch

        def preempted(epoch):
            os.kill(os.getpid(), signal.SIGTERM)  # the handler sets a flag
            return run_epoch(epoch)

        trainer._run_epoch = preempted
    trainer.fit()
    return {"epochs": [h["epoch"] for h in trainer.history],
            "history": trainer.history, **_tensors(trainer.state)}


TASKS = {"step": task_step, "eval": task_eval, "augment": task_augment,
         "perm": task_perm, "ckpt": task_ckpt, "sigterm": task_sigterm}


def _worker(rank, world, port, job_dir):
    import torch
    import torch.distributed as dist

    from pytorch_cifar_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, device="cpu",
                           timeout_s=120)
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    out = {t["name"]: TASKS[t["kind"]](t, job_dir) for t in job["tasks"]}
    torch.save(out, os.path.join(job_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
