"""Spatial partitioning on the card: the spatial train step and eval
forward against one process's on the same global batch, and the train CLI
at ``--spatial_devices``.

    python -m pytorch_cifar_tpu_torch.tools.spatial_runs

:func:`compare_steps` runs ranks of one process group (a gloo pair on
``cuda:0`` when the machine has one card: NCCL refuses two ranks on one
card; else one NCCL rank a card). For each spec, every rank builds the
same seeded model, runs the fp32 eval forward (``make_eval_forward``: the
folded forward, K3 at every fused site, on its halo-extended slab) on its
data shard of a seeded global batch, takes one spatial step
(``make_train_step(spatial=)``) on it, then ``reps`` more to time it;
rank 0 then runs the one-process eval forward and step on the whole batch
from the same start and times the step too. TF32 is off in the ranks, so
the two sides differ only by the order of their sums. A spec's step
computes in fp32 or float64 (fp32 parameters either way; the eval forward
is fp32). Each rank reports its logits, its state's SHA-256 (params and
buffers), the compared step's metrics and spatial counters
(``parallel.spatial.COUNTS``: halo exchanges, their rows and bytes), its
eval forward's K3 / K4 / K5 launches, its step's K4 launches and its
step's ms; rank 0 the one-process step's metrics and the largest
differences from it, and with ``noise`` how far one process's step in
the other dtype lands from it. A rank's timing window opens and closes
on an all-reduce that the card finishes before the clock reads
(:func:`_fence`), so every rank of the synchronous step times the same
steps. :data:`ZOO` names one model a family, and its step's dtype, for
``chip_smoke.py --only spatial_zoo``.

:func:`slab_shapes` gives the extended slabs a stride-1 kernel (K3, K4,
K5) runs on over a mesh, for ``chip_smoke.py``'s kernel checks there.

:func:`fit_argv` is the train CLI's spatial run: ResNet-18 at full width,
b512, bf16, device data, K1, 2 epochs on ``synthetic_cifar10(5120,
2048)``. The CLI alone prints each comparison and exits non-zero when one
is out of tolerance (loss rtol 1e-5, params atol 5e-4, BN stats atol
1e-5: JAX's ``tests/test_spatial.py``; the eval logits rtol 1e-3, atol
1e-4). Card only.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from pytorch_cifar_tpu_torch.tools._bench import card_line

TRAIN_N, TEST_N = 5_120, 2_048
LOSS_RTOL, PARAM_ATOL, BN_ATOL = 1e-5, 5e-4, 1e-5
LOGIT_RTOL, LOGIT_ATOL = 1e-3, 1e-4  # fp32 served logits' (PERF.md §2)


def step_spec(model: str, mesh, batch: int, augment: bool,
              reps: int = 3, seed: int = 0, compute: str = "float32",
              noise: bool = False, library_pools: bool = False) -> dict:
    """One comparison: ``model`` at full width over ``mesh``, a global
    batch of ``batch``, its step in ``compute`` (``"float32"`` or
    ``"float64"``: fp32 parameters either way); with ``noise`` rank 0
    also takes the one-process step in the other dtype from the same
    start and reports how far the two land apart (the step's own
    conditioning). ``library_pools``: both sides' steps take their 3x3 /
    stride 1 pools from ``F.max_pool2d`` (on the slab as K4 would run, so
    the seam is the same; K4 takes no float64), the eval forward K4's."""
    return {"model": model, "mesh": tuple(mesh), "batch": batch,
            "augment": augment, "reps": reps, "seed": seed,
            "compute": compute, "noise": noise,
            "library_pools": library_pools}


# one registry name a model family, at full width, and its step's compute
# (``chip_smoke.py --only spatial_zoo``): the families held beside ResNet,
# LeNet and GoogLeNet. float64 where one process's fp32 step at b64 lands
# over half the 5e-4 tolerance from its own float64 step (PERF.md §6): the
# spatial step's distance is then that conditioning, not the cut.
# PNASNetB's fp32 step lands 5.5e-3-2.4e-2 from its float64 one at b32-b256,
# so it steps in float64 with the library's pools (:data:`LIBRARY_POOLS`)
ZOO = {"SimpleDLA": "float64", "DLA": "float64", "VGG16": "float64",
       "PreActResNet18": "float32", "ResNeXt29_2x64d": "float64",
       "RegNetX_200MF": "float64", "RegNetY_400MF": "float64",
       "SENet18": "float32", "DenseNet121": "float32", "DPN26": "float32",
       "MobileNet": "float64", "MobileNetV2": "float64",
       "ShuffleNetG2": "float64", "ShuffleNetV2_1": "float64",
       "PNASNetA": "float32", "PNASNetB": "float64",
       "EfficientNetB0": "float32"}
LIBRARY_POOLS = ("PNASNetB",)


def fit_argv(out_dir: str, spatial: int = 2, spatial_w: int = 1) -> list:
    """The train CLI's flags of a spatial run: ResNet-18 at full width,
    global batch 512, bf16, device data, K1, 2 epochs on the cut split."""
    return ["--model", "ResNet18", "--batch_size", "512", "--synthetic_data",
            "--synthetic_train_size", str(TRAIN_N), "--synthetic_test_size",
            str(TEST_N), "--epochs", "2", "--cosine_t_max", "2",
            "--dma_gather", "--output_dir", out_dir,
            "--spatial_devices", str(spatial),
            "--spatial_w_devices", str(spatial_w)]


def _digest(model) -> str:
    h = hashlib.sha256()
    for t in list(model.parameters()) + list(model.buffers()):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _dtype(spec, other: bool = False):
    name = spec["compute"]
    if other:
        name = "float64" if name == "float32" else "float32"
    return getattr(torch, name)


def _state(spec, device):
    from pytorch_cifar_tpu_torch.models import create_model
    from pytorch_cifar_tpu_torch.train import optim
    from pytorch_cifar_tpu_torch.train.state import create_train_state

    model = create_model(spec["model"], generator=torch.Generator()
                         .manual_seed(spec["seed"]))
    model = model.to(device, memory_format=torch.channels_last)
    return create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=0.1),
        optim.cosine_epoch_schedule(0.1, 2, 20), seed=spec["seed"] + 1,
        device=device)


def _batch(spec, device, rows=slice(None)):
    rs = np.random.RandomState(spec["seed"] + 7)
    n = spec["batch"]
    x = rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    y = rs.randint(0, 10, n).astype(np.int32)
    y[-5:] = -1  # a wrap-padded tail
    return (torch.from_numpy(x[rows]).to(device),
            torch.from_numpy(y[rows]).to(device))


def slab_shapes(h: int, w: int, mesh, k: int = 3) -> list:
    """The distinct ``(rows, cols)`` of the slabs a stride-1 ``k x k``
    kernel (K3 and K4 at 3, K5 at 3, 5 and 7) runs on, over the ranks of
    a ``(data, spatial, spatial_w)`` mesh, for an ``h x w`` map: each cut
    dimension extended by ``k // 2`` rows a side (``spatial.same_op``'s
    halo), of ranks that own an output row."""
    from pytorch_cifar_tpu_torch.parallel.spatial import rows_needed

    def extended(extent, n):
        if n == 1:
            return {extent}
        rows = (rows_needed(k, 1, k // 2, extent, i, n) for i in range(n))
        return {r.need[1] - r.need[0] for r in rows if r.out[0] < r.out[1]}

    _, s, sw = mesh
    return sorted((a, b) for a in extended(h, s) for b in extended(w, sw))


def _fence(device) -> None:
    """An all-reduce over every rank, finished on the card: each rank
    leaves it when the last one has joined."""
    import torch.distributed as dist

    dist.all_reduce(torch.ones(1, device=device))
    torch.cuda.synchronize(device)


def _timed(step, state, batch, reps: int, device,
           collective: bool = True) -> float:
    """The mean wall ms of ``reps`` steps, the window opened and closed by
    :func:`_fence` (the card synchronized alone when not ``collective``)."""
    fence = (lambda: _fence(device)) if collective else (
        lambda: torch.cuda.synchronize(device))
    fence()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(state, batch)
    fence()
    return (time.perf_counter() - t0) * 1e3 / reps


def _sd(model) -> dict:
    return {k: v.detach().float().cpu().clone() for k, v in
            model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _launches() -> tuple:
    """K3, K4 forward, K4 backward and K5 launches so far."""
    from pytorch_cifar_tpu_torch.ops import (
        conv_bn_relu,
        depthwise_stencil,
        max_pool,
    )

    return (conv_bn_relu.LAUNCHES, max_pool.FWD_LAUNCHES,
            max_pool.BWD_LAUNCHES, depthwise_stencil.LAUNCHES)


def _since(before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(_launches(), before))


@contextlib.contextmanager
def _pools(library: bool):
    """Within the block the models' 3x3 / stride 1 pools run
    ``F.max_pool2d`` when ``library`` (a yardstick: K4 takes bf16 and
    fp32), else K4."""
    from pytorch_cifar_tpu_torch.models import common
    from pytorch_cifar_tpu_torch.tools._bench import library_pool

    kernel_pool = common.max_pool3x3_s1
    if library:
        common.max_pool3x3_s1 = library_pool
    try:
        yield
    finally:
        common.max_pool3x3_s1 = kernel_pool


def _noise_step(spec, state, batch, device) -> None:
    """One process's step in the spec's other compute dtype, for the
    step's own conditioning (a float64 step with the library's pools)."""
    from pytorch_cifar_tpu_torch.train.steps import make_train_step

    dtype = _dtype(spec, other=True)
    with _pools(dtype == torch.float64):
        make_train_step(augment=spec["augment"], compute_dtype=dtype,
                        device=device)(state, batch)


def _diffs(got: dict, want: dict) -> dict:
    """The largest differences of two state dicts: parameters (and where),
    BN running stats."""
    diff = {k: (got[k] - want[k]).abs().max().item() for k in want}
    params = [k for k in want if "running" not in k]
    worst = max(params, key=diff.get)
    return {"param_max_abs_diff": diff[worst], "param_worst": worst,
            "bn_max_abs_diff": max(v for k, v in diff.items()
                                   if "running" in k)}


def _run_spec(spec, device) -> dict:
    from pytorch_cifar_tpu_torch.parallel import spatial
    from pytorch_cifar_tpu_torch.parallel.mesh import rank
    from pytorch_cifar_tpu_torch.train.steps import (
        make_eval_forward,
        make_train_step,
    )

    part = spatial.SpatialPartition(spatial.make_spatial_mesh(*spec["mesh"]))
    n = spec["batch"] // part.mesh.data
    state = _state(spec, device)
    step = make_train_step(augment=spec["augment"], spatial=part,
                           compute_dtype=_dtype(spec), device=device)
    batch = _batch(spec, device, slice(part.d * n, (part.d + 1) * n))
    before = _launches()
    logits = make_eval_forward(spatial=part, device=device)(state, batch[0])
    k3, k4f, _, k5 = _since(before)
    out = {"spec": spec, "rank": rank(), "coords": (part.d, part.s, part.w),
           "logits": logits.float().cpu(),
           "eval_launches": {"k3": k3, "k4": k4f, "k5": k5}}
    spatial.reset_counts()
    with _pools(spec["library_pools"]):
        before = _launches()
        m = {k: float(v) for k, v in step(state, batch).items()}
        torch.cuda.synchronize(device)
        _, k4f, k4b, _ = _since(before)
        out.update({"metrics": m, "counts": dict(spatial.COUNTS),
                    "k4_launches": (k4f, k4b),
                    "digest": _digest(state.model)})
        got = _sd(state.model) if rank() == 0 else None
        out["step_ms"] = _timed(step, state, batch, spec["reps"], device)
    del state, step, batch
    torch.cuda.empty_cache()
    if rank() == 0:
        # the one-process forward and step on the whole batch, from the
        # same start
        ref = _state(spec, device)
        whole = _batch(spec, device)
        ref_logits = make_eval_forward(device=device)(ref, whole[0])
        one = make_train_step(augment=spec["augment"],
                              compute_dtype=_dtype(spec), device=device)
        with _pools(spec["library_pools"]):
            rm = {k: float(v) for k, v in one(ref, whole).items()}
            want = _sd(ref.model)
            one_ms = _timed(one, ref, whole, spec["reps"], device,
                            collective=False)
        if spec["noise"]:
            other = _state(spec, device)
            _noise_step(spec, other, whole, device)
            out["noise"] = _diffs(_sd(other.model), want)
            del other
        out["one_process"] = {
            "metrics": rm,
            "logits": ref_logits.float().cpu(),
            "loss_rel_diff": abs(m["loss_sum"] - rm["loss_sum"])
            / abs(rm["loss_sum"]),
            **_diffs(got, want),
            "step_ms": one_ms,
        }
        del ref, one, whole
        torch.cuda.empty_cache()
    return out


def _step_rank(r: int, world: int, port: int, backend: str, specs: list,
               out_dir: str) -> None:
    import torch.distributed as dist

    device = torch.device("cuda", 0 if backend == "gloo" else r)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=r)
    try:
        out = [_run_spec(spec, device) for spec in specs]
        torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))
    finally:
        dist.destroy_process_group()


def compare_steps(specs: list, world: int) -> list:
    """Each spec's results on every rank (``[rank][spec]``): ``world``
    ranks, a gloo pair on ``cuda:0`` on a one-card machine, else one NCCL
    rank a card."""
    from pytorch_cifar_tpu_torch.train.launch import free_port

    backend = "gloo" if torch.cuda.device_count() == 1 else "nccl"
    with tempfile.TemporaryDirectory(prefix="spatial_steps_") as tmp:
        torch.multiprocessing.start_processes(
            _step_rank, args=(world, free_port(), backend, specs, tmp),
            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def logits_off(rows: list) -> float:
    """The largest ``|a - b| / (LOGIT_ATOL + LOGIT_RTOL |b|)`` of the
    spatial eval forward's logits (each data index's, from the first rank
    of its spatial group) against one process's on the whole batch: at
    most 1 within tolerance."""
    want = rows[0]["one_process"]["logits"]
    firsts = sorted((r["coords"][0], r["logits"]) for r in rows
                    if r["coords"][1:] == (0, 0))
    got = torch.cat([lg for _, lg in firsts])
    return float(((got - want).abs()
                  / (LOGIT_ATOL + LOGIT_RTOL * want.abs())).max())


def step_checks(ranks: list) -> list:
    """``(spec index, failures)`` of each spec's comparison: the ranks'
    states equal, the step within JAX's tolerances of one process's, each
    spatial group's ranks' logits equal and within tolerance of one
    process's forward."""
    out = []
    for i, rows in enumerate(zip(*ranks)):
        fails = []
        if len({r["digest"] for r in rows}) != 1:
            fails.append("the ranks' states differ")
        if len({json.dumps(r["metrics"]) for r in rows}) != 1:
            fails.append("the ranks' metrics differ")
        one = rows[0]["one_process"]
        if not (one["loss_rel_diff"] <= LOSS_RTOL
                and one["param_max_abs_diff"] <= PARAM_ATOL
                and one["bn_max_abs_diff"] <= BN_ATOL):
            fails.append("off the one-process step: " + json.dumps(
                {k: v for k, v in one.items() if k != "logits"}))
        if rows[0]["metrics"]["count"] != one["metrics"]["count"]:
            fails.append("counts differ")
        for r in rows:
            first = next(q for q in rows if q["coords"] == (
                r["coords"][0], 0, 0))
            if not torch.equal(r["logits"], first["logits"]):
                fails.append(f"rank {r['rank']}'s eval logits differ from "
                             "its spatial group's first rank's")
        off = logits_off(rows)
        if not off <= 1.0:
            fails.append(f"eval logits {off:.3g}x the tolerance off one "
                         "process's")
        out.append((i, fails))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--spatial", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spatial_runs: CUDA is not available; card only")
    print(card_line(), flush=True)
    specs = [step_spec("ResNet18", (1, args.spatial, 1), 512, False),
             step_spec("ResNet18", (1, args.spatial, 1), 512, True)]
    ranks = compare_steps(specs, args.spatial)
    bad = 0
    for i, fails in step_checks(ranks):
        rows = [r[i] for r in ranks]
        one = {k: v for k, v in rows[0]["one_process"].items()
               if k != "logits"}
        print(json.dumps({"spec": specs[i], "rank0": {
            k: rows[0][k] for k in ("metrics", "counts")},
            "step_ms": [r["step_ms"] for r in rows],
            "logits_off": logits_off(rows), "one_process": one,
            "fails": fails}), flush=True)
        bad += bool(fails)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
