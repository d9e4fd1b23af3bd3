"""The port's spatial train and eval steps on gloo ranks, against the JAX
package's GSPMD spatial steps on its 8-device CPU mesh and against the
port's own one-process step on the global batch.

ResNet18 at batch 16 (two labels -1), weights drawn with numpy and mapped
into both frameworks (``compat.state_dict_from_jax``), one fp32 SGD step
with augmentation off over the ``(data, spatial, spatial_w)`` meshes
(1, 2, 1), (1, 2, 2) and (2, 2, 1), against JAX's ``spatial_train_step``
over the same mesh (``make_spatial_mesh`` on the first devices) and
against the port's one-process step, at JAX's own tolerances
(``tests/test_spatial.py``): the loss within rtol 1e-5, every parameter
within atol 5e-4, every BN running stat within atol 1e-5, on every rank,
which hold the same state. At (1, 2, 1) also a step with augmentation on
(every rank draws the global batch's crops and flips, as one process
does) and one under ``remat``, against the port's one-process step at the
same tolerances; and the eval epoch against JAX's ``spatial_eval_step``
(the loss within rtol 1e-5, the same count correct). The folded eval
forward also at (1, 2, 2) (K3 on height- and width-extended slabs), for
GoogLeNet and for LeNet, each against the port's one-process eval step.

GoogLeNet (its K4 pools on halo-extended slabs, its stage pools and its
8x8 average pool through the same seams) takes one step at batch 4 and
LeNet (a 5-row map cut 3 / 2, its flatten gathered) two, each against the
port's one-process step; LeNet also over 4 ranks (the 5-row map cut
2 / 2 / 1 / 0) and over 8, where the last rank owns no row of any map
after the first conv's input and still takes part in every exchange and
reduction, its train and eval steps each against one process's: GoogLeNet in float64 compute (fp32 parameters),
where an fp32 step at batch 4 is itself no closer than 9e-4 to the
float64 one, so the comparison holds the spatial machinery rather than
fp32 rounding: the loss within rtol 1e-9, the fp32 parameters and
buffers within one rounding of the update (rtol 1e-6, atol 1e-7); LeNet
in fp32 at the tolerances above.

The counters stand in for JAX's HLO test: a ResNet18 step makes one
height exchange (and under W cuts one width exchange) per 3x3 conv
forward and as many backward, no send carries more than one row, the one
reduction over the spatial group is the tail's average pool, and nothing
is gathered.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.parallel.spatial import (
    make_spatial_mesh as jax_mesh,
    put_spatial,
    spatial_eval_step,
    spatial_train_step,
)
from pytorch_cifar_tpu.train import optim as jax_optim
from pytorch_cifar_tpu.train import state as jax_state
from pytorch_cifar_tpu.train import steps as jax_steps
from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.parallel.spatial import shard_range
from pytorch_cifar_tpu_torch.train import optim, steps
from pytorch_cifar_tpu_torch.train.state import create_train_state
from _torch_ckpt import jax_model
from _torch_spatial import run_job
from _torch_spatial_zoo import (
    BN_ATOL,
    F64_LOSS_RTOL,
    F64_STATE_ATOL,
    F64_STATE_RTOL,
    LOSS_RTOL,
    LR,
    PARAM_ATOL,
    SPE,
    T_MAX,
    assert_state as _assert_state,
    batch as _batch,
    ranks_agree as _ranks_agree,
    weights as _weights,
)
from _torch_threads import torch_threads  # noqa: F401
MESHES = {"1x2x1": (1, 2, 1), "1x2x2": (1, 2, 2), "2x2x1": (2, 2, 1)}
# LeNet's taller cuts: over 4 ranks its 5-row map splits 2 / 2 / 1 / 0;
# over 8 the last rank owns no row of any map after the first conv's
# input (28 rows split 4 a rank)
TALL = {"1x4x1": (1, 4, 1), "1x8x1": (1, 8, 1)}
ALL_MESHES = {**MESHES, **TALL}
GLOBAL = 16


SEEDS = {"ResNet18": 1, "GoogLeNet": 2, "LeNet": 3}
STEPS = {  # task: (model, mesh, augment, remat, compute, batch, steps)
    "resnet@1x2x1": ("ResNet18", "1x2x1", False, False, "float32", 16, 1),
    "resnet@1x2x2": ("ResNet18", "1x2x2", False, False, "float32", 16, 1),
    "resnet@2x2x1": ("ResNet18", "2x2x1", False, False, "float32", 16, 1),
    "resnet_augment": ("ResNet18", "1x2x1", True, False, "float32", 16, 1),
    "resnet_remat": ("ResNet18", "1x2x1", False, True, "float32", 16, 1),
    "googlenet": ("GoogLeNet", "1x2x1", False, False, "float64", 4, 1),
    "lenet": ("LeNet", "1x2x1", True, False, "float32", 16, 2),
    "lenet@1x4x1": ("LeNet", "1x4x1", True, False, "float32", 16, 2),
    "lenet@1x8x1": ("LeNet", "1x8x1", True, False, "float32", 16, 2),
}
EVAL_SEED = 9
EVALS = {  # task: (model, mesh, global batch): the folded eval forward
    "eval": ("ResNet18", "1x2x1", GLOBAL),
    "eval_hw": ("ResNet18", "1x2x2", GLOBAL),
    "eval_googlenet": ("GoogLeNet", "1x2x1", 4),
    "eval_lenet": ("LeNet", "1x2x1", GLOBAL),
    "eval_lenet@1x4x1": ("LeNet", "1x4x1", GLOBAL),
    "eval_lenet@1x8x1": ("LeNet", "1x8x1", GLOBAL),
}


def _batches(task):
    _, _, _, _, _, n, k = STEPS[task]
    return [_batch(n, seed=20 + i) for i in range(k)]


def _step_task(task):
    name, mesh, augment, remat, compute, _, _ = STEPS[task]
    return {"name": task, "kind": "step", "model": name,
            "mesh": ALL_MESHES[mesh], "sd": _weights(name, SEEDS[name])[2],
            "batches": _batches(task), "augment": augment, "remat": remat,
            "compute": compute, "lr": LR, "t_max": T_MAX, "spe": SPE,
            "seed": 4}


def _eval_task(task):
    name, mesh, n = EVALS[task]
    images, labels = _batch(n, seed=EVAL_SEED)
    return {"name": task, "kind": "eval", "model": name,
            "mesh": ALL_MESHES[mesh], "sd": _weights(name, SEEDS[name])[2],
            "images": images, "labels": labels, "global_batch": n,
            "num_steps": 1, "lr": LR, "t_max": T_MAX, "spe": SPE}


def _mesh_of(task):
    return EVALS[task][1] if task in EVALS else STEPS[task][1]


def _job(root, world):
    """One job of ``world`` ranks over every task of its meshes: the
    (1, 2, 1) ones on 2 ranks, (1, 8, 1) on 8, the rest on 4."""
    tasks = [_step_task(t) for t in STEPS
             if np.prod(ALL_MESHES[STEPS[t][1]]) == world]
    tasks += [_eval_task(t) for t in EVALS
              if np.prod(ALL_MESHES[EVALS[t][1]]) == world]
    results = run_job(tasks, str(root / f"world{world}"), world)
    return {t["name"]: [r[t["name"]] for r in results] for t in tasks}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _job(tmp_path_factory.mktemp("spatial"), 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _job(tmp_path_factory.mktemp("spatial"), 4)


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return _job(tmp_path_factory.mktemp("spatial"), 8)


@pytest.fixture
def ranks(request):
    """Every rank's results of a task, from the job of its world (each
    job runs once, when a test first asks for one of its tasks)."""
    def get(task):
        n = int(np.prod(ALL_MESHES[_mesh_of(task)]))
        return request.getfixturevalue(f"world{n}")[task]

    return get


@functools.lru_cache(maxsize=None)
def _one_process(task):
    """The port's one-process step(s) on the global batches: the state
    dict and each step's metrics."""
    name, _, augment, remat, compute, _, _ = STEPS[task]
    model = create_model(name)
    model.load_state_dict(_weights(name, SEEDS[name])[2])
    model = model.to(memory_format=torch.channels_last)
    state = create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=LR),
        optim.cosine_epoch_schedule(LR, T_MAX, SPE), seed=4, device="cpu")
    step = steps.make_train_step(augment=augment, remat=remat,
                                 compute_dtype=getattr(torch, compute),
                                 device="cpu")
    metrics = [{k: float(v) for k, v in step(
        state, (torch.from_numpy(x), torch.from_numpy(y))).items()}
        for x, y in _batches(task)]
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            metrics)


@functools.lru_cache(maxsize=None)
def _jax_spatial(mesh_name):
    """JAX's spatial step of ResNet18 over the mesh, from the same
    weights, on the same batch: (params, batch_stats, loss_sum)."""
    d, s, w = MESHES[mesh_name]
    mesh = jax_mesh(data=d, spatial=s, spatial_w=w,
                    devices=jax.devices()[:d * s * w])
    params, stats, _ = _weights("ResNet18", SEEDS["ResNet18"])
    tx = jax_optim.make_optimizer(lr=LR, t_max=T_MAX, steps_per_epoch=SPE)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=tx.init(params), apply_fn=jax_model("ResNet18").apply,
        tx=tx)
    step = spatial_train_step(jax_steps.make_train_step(augment=False),
                              mesh, donate=False)
    (x, y), = _batches(f"resnet@{mesh_name}")
    state, m = step(state, put_spatial(x, y, mesh), jax.random.PRNGKey(0))
    return (jax.device_get(state.params), jax.device_get(state.batch_stats),
            float(m["loss_sum"]))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resnet18_step_matches_jax_spatial_step(ranks, mesh):
    results = ranks(f"resnet@{mesh}")
    _ranks_agree(results)
    params, stats, loss = _jax_spatial(mesh)
    want = state_dict_from_jax("ResNet18", params, stats,
                               model=create_model("ResNet18"))
    _assert_state(results[0]["sd"], want, PARAM_ATOL, BN_ATOL)
    np.testing.assert_allclose(results[0]["metrics"][0]["loss_sum"], loss,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("task", ["resnet@1x2x1", "resnet@1x2x2",
                                  "resnet@2x2x1", "resnet_augment",
                                  "resnet_remat", "lenet", "lenet@1x4x1",
                                  "lenet@1x8x1"])
def test_step_matches_one_process(ranks, task):
    results = ranks(task)
    _ranks_agree(results)
    sd, metrics = _one_process(task)
    _assert_state(results[0]["sd"], sd, PARAM_ATOL, BN_ATOL)
    for got, want in zip(results[0]["metrics"], metrics):
        np.testing.assert_allclose(got["loss_sum"], want["loss_sum"],
                                   rtol=LOSS_RTOL)
        assert got["count"] == want["count"] == 14.0
        assert got["correct"] == want["correct"]


def test_rank_with_no_row_trains_with_its_group(ranks):
    """At (1, 8, 1) LeNet's last rank owns image rows 28-31 and no row of
    the 28-row conv output or any map after it. Its state and metrics are
    its group's; it sent its image rows to the rank above and took their
    gradients back."""
    assert shard_range(32, 7, 8) == (28, 32)
    assert all(shard_range(e, 7, 8)[0] == shard_range(e, 7, 8)[1]
               for e in (28, 14, 10, 5))
    results = ranks("lenet@1x8x1")
    _ranks_agree(results)
    c = results[7]["counts"]
    assert results[7]["coords"] == (0, 7, 0)
    assert c["halo_sends"] > 0 and c["halo_exchanges_h"] > 0
    # LeNet has no BN; one gather a step (its flatten)
    assert c["bn_reductions"] == 0 and c["gathers"] == 2


def test_googlenet_step_matches_one_process_in_float64(ranks):
    """K4's pools (the CPU runs its plain version), the 3 / 2 / 1 stage
    pools and the whole-map average pool on slabs, in float64 compute."""
    results = ranks("googlenet")
    _ranks_agree(results)
    sd, metrics = _one_process("googlenet")
    _assert_state(results[0]["sd"], sd, F64_STATE_ATOL, F64_STATE_ATOL,
                  rtol=F64_STATE_RTOL)
    np.testing.assert_allclose(results[0]["metrics"][0]["loss_sum"],
                               metrics[0]["loss_sum"], rtol=F64_LOSS_RTOL)
    assert results[0]["counts"]["halo_exchanges_h"] > 0


def test_eval_matches_jax_spatial_eval_step(ranks):
    mesh = jax_mesh(data=1, spatial=2, devices=jax.devices()[:2])
    params, stats, _ = _weights("ResNet18", SEEDS["ResNet18"])
    x, y = _batch(GLOBAL, seed=EVAL_SEED)
    state = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=None, apply_fn=jax_model("ResNet18").apply, tx=None)
    m = spatial_eval_step(jax_steps.make_eval_step(), mesh)(
        state, put_spatial(x, y, mesh))
    for got in ranks("eval"):
        np.testing.assert_allclose(got["loss_sum"], float(m["loss_sum"]),
                                   rtol=LOSS_RTOL)
        assert got["correct"] == float(m["correct"])
        assert got["count"] == float(m["count"]) == 14.0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_counters_show_halo_exchanges_and_no_gather(ranks, mesh):
    """JAX's HLO test, read from the counters: ResNet18 has 17 3x3 convs,
    each exchanging its height halo (and its width halo under W cuts) in
    the forward and back in the backward, but the stem's (its input, the
    images, takes no gradient); every send is one boundary row or column;
    one reduction over the spatial group (the 4x4 average pool); 20 BN
    reductions; no gather of an activation."""
    _, s, w = MESHES[mesh]
    for r in ranks(f"resnet@{mesh}"):
        c = r["counts"]
        assert c["halo_exchanges_h"] == 17
        assert c["halo_exchanges_w"] == (17 if w > 1 else 0)
        assert c["halo_exchanges_bwd"] == 16 * (1 + (w > 1))
        assert c["halo_max_rows"] == 1 and c["halo_over_reach"] == 0
        assert c["group_sums"] == 1 and c["bn_reductions"] == 20
        assert c["gathers"] == 0


@pytest.mark.parametrize("task", sorted(EVALS))
def test_eval_matches_one_process(ranks, task):
    """The folded eval forward on slabs (K3 on height- and width-extended
    slabs, GoogLeNet's K4 pools and stage pools, LeNet's gathered flatten)
    against the port's one-process eval step on the whole batch."""
    name, _, n = EVALS[task]
    model = create_model(name)
    model.load_state_dict(_weights(name, SEEDS[name])[2])
    state = create_train_state(
        model.to(memory_format=torch.channels_last),
        optim.make_optimizer(model.parameters(), lr=LR),
        optim.cosine_epoch_schedule(LR, T_MAX, SPE), device="cpu")
    x, y = _batch(n, seed=EVAL_SEED)
    want = steps.make_eval_step(device="cpu")(
        state, (torch.from_numpy(x), torch.from_numpy(y)))
    for got in ranks(task):
        np.testing.assert_allclose(got["loss_sum"], float(want["loss_sum"]),
                                   rtol=LOSS_RTOL)
        assert got["correct"] == float(want["correct"])
        assert got["count"] == float(want["count"]) == n - 2
