"""Gloo jobs of the port for the spatial-partitioning tests.

:func:`run_job` writes a list of tasks to ``<dir>/job.pt``, starts one
worker process per rank (``python tests/_torch_spatial.py RANK WORLD PORT
DIR``) on a free localhost port, as ``tests/_torch_dp.py`` does, and
returns each rank's results keyed by task name. A worker imports torch
and the port only, joins the gloo group and runs every task in order.

Tasks (``kind``), each over a ``(data, spatial, spatial_w)`` mesh of the
job's world:

- ``step``: spatial train steps (``make_train_step(spatial=...)``) from
  the given ``state_dict``, each rank on its data shard's whole images of
  every global batch; returns the state, each step's metrics and the
  spatial counters of the steps; with ``count_moments`` the batch moments
  go through a hook (where kernel K2 plugs in) that records the element
  count of each input it is handed;
- ``eval``: the spatial eval epoch's metric totals (``make_eval_epoch``
  with the spatial shardings);
- ``op``: one layer of ``models.common`` (a conv, a max or average pool,
  a pool over the whole map, a flatten's gather, a folded depthwise
  stencil site, a channel shuffle) on this rank's slab of a given input
  under ``spatial_partition``, and its gradient for a given cotangent;
  returns the slab's box, the output slab and the input gradient's slab;
- ``draws``: the model's masks a spatial train step draws at a given
  step (``steps._model_draws``), for the given shapes in order.
"""

import os
import subprocess
import sys

from _torch_dp import free_port

WORKER = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(WORKER))


def run_job(tasks, job_dir, world, timeout=240):
    """Run ``tasks`` on ``world`` gloo ranks; returns ``[rank results]``."""
    import torch

    os.makedirs(job_dir, exist_ok=True)
    torch.save({"tasks": tasks}, os.path.join(job_dir, "job.pt"))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PCT_FAULTS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), str(port), job_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
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

def _partition(t, image_hw=(32, 32)):
    from pytorch_cifar_tpu_torch.parallel.spatial import (
        SpatialPartition, make_spatial_mesh)

    d, s, w = t["mesh"]
    return SpatialPartition(make_spatial_mesh(d, s, w), image_hw=image_hw)


def _state(t):
    import torch

    from pytorch_cifar_tpu_torch.models import create_model
    from pytorch_cifar_tpu_torch.train import optim
    from pytorch_cifar_tpu_torch.train.state import create_train_state

    model = create_model(t["model"])
    model.load_state_dict(t["sd"])
    model = model.to(memory_format=torch.channels_last)
    return create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=t["lr"]),
        optim.cosine_epoch_schedule(t["lr"], t["t_max"], t["spe"]),
        seed=t.get("seed", 0), device="cpu")


def _rows(arr, part):
    """The data shard's rows of a global batch."""
    import torch

    n = len(arr) // part.mesh.data
    return torch.from_numpy(arr[part.d * n:(part.d + 1) * n])


def task_step(t, job_dir):
    import torch

    from pytorch_cifar_tpu_torch.models import common
    from pytorch_cifar_tpu_torch.parallel import spatial
    from pytorch_cifar_tpu_torch.train import steps

    part = _partition(t)
    state = _state(t)
    step = steps.make_train_step(
        augment=t["augment"], remat=t.get("remat", False), spatial=part,
        compute_dtype=getattr(torch, t.get("compute", "float32")),
        device="cpu")
    spatial.reset_counts()
    metrics, sizes = [], []
    with common.bn_moments_impl(_counted_moments(sizes)
                                if t.get("count_moments") else None):
        for x, y in t["batches"]:
            m = step(state, (_rows(x, part), _rows(y, part)))
            metrics.append({k: float(v) for k, v in m.items()})
    return {"sd": {k: v.detach().clone()
                   for k, v in state.model.state_dict().items()},
            "metrics": metrics, "counts": dict(spatial.COUNTS),
            "coords": (part.d, part.s, part.w), "moment_sizes": sizes}


def _counted_moments(sizes):
    """A batch-moments function (``common.bn_moments_impl``, where kernel
    K2 plugs in) that records the element count of every input it is
    handed in ``sizes``."""
    import torch

    def moments(x):
        sizes.append(x.numel())
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        return xf.mean(dim=(0, 1, 2)), (xf * xf).mean(dim=(0, 1, 2))

    return moments


def task_eval(t, job_dir):
    import torch

    from pytorch_cifar_tpu_torch.parallel.spatial import (
        spatial_batch_sharding, spatial_label_sharding)
    from pytorch_cifar_tpu_torch.train import steps

    part = _partition(t)
    state = _state(t)
    epoch = steps.make_eval_epoch(
        steps.make_eval_step(spatial=part, device="cpu"),
        global_batch=t["global_batch"], n_data=len(t["images"]),
        num_steps=t["num_steps"],
        batch_sharding=spatial_batch_sharding(part),
        label_sharding=spatial_label_sharding(part))
    totals = epoch(state, torch.from_numpy(t["images"]),
                   torch.from_numpy(t["labels"]))
    return {k: float(v) for k, v in totals.items()}


def _layer(t):
    """The layer of ``models.common`` an ``op`` task runs."""
    import torch

    from pytorch_cifar_tpu_torch.models import common
    from pytorch_cifar_tpu_torch.parallel.spatial import gather_slabs

    op = t["op"]
    if op["kind"] == "conv":
        conv = common.Conv2d(op["cin"], op["cout"], op["k"],
                             stride=op["stride"], padding=op["padding"],
                             bias=True)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(op["weight"]))
            conv.bias.copy_(torch.from_numpy(op["bias"]))
        return conv
    if op["kind"] == "max":
        return lambda x: common.max_pool(x, op["k"], op["stride"],
                                         op["padding"])
    if op["kind"] == "avg":
        return lambda x: common.avg_pool(x, op["k"], op["stride"],
                                         op["padding"])
    if op["kind"] == "global":
        return common.global_avg_pool
    if op["kind"] == "gather":
        return gather_slabs
    if op["kind"] == "stencil":
        c, k = op["weight"].shape[0], op["weight"].shape[-1]
        conv = common.Conv2d(c, c, k, padding=k // 2, groups=c, bias=False)
        bn = common.BatchNorm(c).eval()
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(op["weight"]))
            bn.weight.copy_(torch.from_numpy(op["scale"]))
            bn.bias.copy_(torch.from_numpy(op["shift"]))
        site = common.fold_conv_bn(conv, bn, torch.float32, act=common.RELU)
        assert site.stencil
        return lambda x: common.conv_bn(x, site)
    if op["kind"] == "shuffle":
        return lambda x: common.channel_shuffle(x, op["groups"])
    raise ValueError(op["kind"])


def task_op(t, job_dir):
    import torch

    from pytorch_cifar_tpu_torch.parallel import spatial

    x = torch.from_numpy(t["x"])
    part = _partition(t, image_hw=tuple(x.shape[2:]))
    layer = _layer(t)
    (h0, h1), (w0, w1) = part.box(*x.shape[2:])
    # only the data shard's rows: a data axis above 1 cuts the batch
    n = x.shape[0] // part.mesh.data
    rows = slice(part.d * n, (part.d + 1) * n)
    xs = x[rows, :, h0:h1, w0:w1].contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    spatial.reset_counts()
    op = t["op"]
    with spatial.spatial_partition(part):
        y = layer(spatial.mark_input(xs))
        # an output every rank of the group holds whole: a gather, a mean
        # over the map, a pool whose window covers it
        whole = y.dim() == 2 or op["kind"] == "gather" or (
            op["kind"] == "avg" and op["k"] == x.shape[2])
        hw = None if whole else spatial.active().extent_of(y)
    g = torch.from_numpy(t["g"])[rows]
    if whole:
        # its cotangent split over the group, as the train step's loss is
        g = g / (part.mesh.spatial * part.mesh.spatial_w)
    else:
        (o0, o1), (p0, p1) = part.box(*hw)
        g = g[:, :, o0:o1, p0:p1]
    (y * g).sum().backward()
    return {"box": ((h0, h1), (w0, w1)), "rows": (rows.start, rows.stop),
            "y": y.detach().clone(), "gx": xs.grad.clone(),
            "out_box": None if hw is None else part.box(*hw),
            "counts": dict(spatial.COUNTS)}


def task_draws(t, job_dir):
    import torch

    from pytorch_cifar_tpu_torch.models import create_model
    from pytorch_cifar_tpu_torch.train import optim, steps
    from pytorch_cifar_tpu_torch.train.state import create_train_state

    part = _partition(t)
    model = create_model("LeNet")
    state = create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=0.1),
        optim.cosine_epoch_schedule(0.1, 4, 3), seed=t["seed"],
        device="cpu")
    state.step = t["step"]
    draw = steps._model_draws(state, part.d, part)
    return [draw(tuple(shape), keep) for shape, keep in t["draws"]]


TASKS = {"step": task_step, "eval": task_eval, "op": task_op,
         "draws": task_draws}


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
