"""Spatial partitioning of SimpleDLA (the train CLI's default), DLA, VGG,
PreActResNet, ResNeXt and RegNetX on gloo ranks (helpers:
``tests/_torch_spatial_zoo.py``).

One registry name a family takes one train step over the ``(data, spatial,
spatial_w)`` meshes (1, 2, 1) and (1, 2, 2) against the port's one-process
step on the global batch, in float64 compute (fp32 parameters) at the
float64 tolerances, and its folded eval forward (the K3 sites on
height- and width-extended slabs) against the one-process eval step.

SimpleDLA is also held against the JAX package's GSPMD steps on its CPU
devices, as ``tests/test_torch_spatial.py`` holds ResNet18: one step at
batch 16 with augmentation off over (1, 2, 1) against JAX's
``spatial_train_step`` at JAX's own tolerances (the loss within rtol
1e-5, every parameter within atol 5e-4, every BN running stat within atol
1e-5), both computing in float64 (JAX's on float64 parameters under
``jax.enable_x64``): in fp32 the two steps' 16-channel stem kernels moved
1.6e-3 apart, as two fp32 steps of the port that sum in another order do;
and the fp32 spatial eval against ``spatial_eval_step``. Its Roots
concatenate marked slabs, and its 4x4 average pool is a sum over the
spatial group.

VGG's fifth pool leaves a 1x1 map, which at two ranks a line the second
owns no row of: its slab is empty, and the flatten gathers the map from
the spatial group (``gather_slabs``), as LeNet's does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from _torch_ckpt import jax_model
from _torch_threads import torch_threads  # noqa: F401
import _torch_spatial_zoo as zoo

MODELS = {
    "SimpleDLA": zoo.Case(),
    "DLA": zoo.Case(),
    "VGG11": zoo.Case(),
    "PreActResNet18": zoo.Case(),
    "ResNeXt29_2x64d": zoo.Case(),
    "RegNetX_200MF": zoo.Case(),
}
# SimpleDLA against JAX: float64 compute, augmentation off, batch 16
JAX_CASE = zoo.Case("float64", 16, False)
JAX_STEP, JAX_EVAL = "SimpleDLA_jax@1x2x1", "eval_SimpleDLA_jax@1x2x1"


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tasks = zoo.family_tasks(MODELS)
    tasks.append(zoo.step_task(JAX_STEP, "SimpleDLA", (1, 2, 1), JAX_CASE))
    tasks.append(zoo.eval_task(JAX_EVAL, "SimpleDLA", (1, 2, 1),
                               JAX_CASE.batch))
    return zoo.run_tasks(tasks, tmp_path_factory.mktemp("spatial_zoo"))


@pytest.mark.parametrize("mesh", sorted(zoo.MESHES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_matches_one_process(jobs, name, mesh):
    zoo.check_step(jobs[zoo.step_name(name, mesh)], name, MODELS[name])


@pytest.mark.parametrize("mesh", sorted(zoo.MESHES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_matches_one_process(jobs, name, mesh):
    zoo.check_eval(jobs[zoo.eval_name(name, mesh)], name,
                   MODELS[name].batch)


def _jax_state(name, dtype=jnp.float32):
    params, stats, _ = zoo.weights(name)
    tx = jax_optim.make_optimizer(lr=zoo.LR, t_max=zoo.T_MAX,
                                  steps_per_epoch=zoo.SPE)
    cast = functools.partial(jnp.asarray, dtype=dtype)
    params = jax.tree_util.tree_map(cast, params)
    return jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(cast, stats),
        opt_state=tx.init(params), apply_fn=jax_model(name).apply, tx=tx)


def test_simpledla_step_matches_jax_spatial_step(jobs):
    results = jobs[JAX_STEP]
    zoo.ranks_agree(results)
    x, y = zoo.batch(JAX_CASE.batch, zoo.STEP_SEED)
    with jax.enable_x64(True):
        mesh = jax_mesh(data=1, spatial=2, devices=jax.devices()[:2])
        step = spatial_train_step(
            jax_steps.make_train_step(augment=False,
                                      compute_dtype=jnp.float64),
            mesh, donate=False)
        state, m = step(_jax_state("SimpleDLA", jnp.float64),
                        put_spatial(x, y, mesh), jax.random.PRNGKey(0))
        host = jax.device_get((state.params, state.batch_stats,
                               m["loss_sum"]))
    want = state_dict_from_jax("SimpleDLA", host[0], host[1],
                               model=create_model("SimpleDLA"))
    zoo.assert_state(results[0]["sd"], want, zoo.PARAM_ATOL, zoo.BN_ATOL)
    np.testing.assert_allclose(results[0]["metrics"][0]["loss_sum"],
                               float(host[2]), rtol=zoo.LOSS_RTOL)


def test_simpledla_eval_matches_jax_spatial_eval_step(jobs):
    mesh = jax_mesh(data=1, spatial=2, devices=jax.devices()[:2])
    x, y = zoo.batch(JAX_CASE.batch, zoo.EVAL_SEED)
    m = spatial_eval_step(jax_steps.make_eval_step(), mesh)(
        _jax_state("SimpleDLA"), put_spatial(x, y, mesh))
    for got in jobs[JAX_EVAL]:
        np.testing.assert_allclose(got["loss_sum"], float(m["loss_sum"]),
                                   rtol=zoo.LOSS_RTOL)
        assert got["correct"] == float(m["correct"])
        assert got["count"] == float(m["count"]) == JAX_CASE.batch - 2


def test_simpledla_roots_and_pool_take_the_spatial_paths(jobs):
    """SimpleDLA's 27 3x3 convs each exchange their height halo (its 12
    K3 sites among them, run on the extended slab in eval); its Roots'
    concatenations keep the slabs' marks (a 1x1 conv of an unmarked slab
    would raise); the 4x4 average pool is the one reduction over the
    spatial group; 39 BNs pool their moments once each."""
    for r in jobs[zoo.step_name("SimpleDLA", "1x2x1")]:
        c = r["counts"]
        assert c["halo_exchanges_h"] == 27 and c["halo_exchanges_w"] == 0
        assert c["group_sums"] == 1 and c["bn_reductions"] == 39
        assert c["gathers"] == 0 and c["halo_max_rows"] == 1


@pytest.mark.parametrize("mesh", sorted(zoo.MESHES))
def test_vgg_rank_with_no_row_of_the_last_map(jobs, mesh):
    """The fifth pool's 1x1 map: the second rank of a height line owns no
    row of it (``shard_range(1, 1, 2)`` is empty), yet every rank feeds
    the linear the whole map through one gather a step, of the 512
    float64 values an image, and holds the same state."""
    assert shard_range(1, 0, 2) == (0, 1) and shard_range(1, 1, 2) == (1, 1)
    results = jobs[zoo.step_name("VGG11", mesh)]
    zoo.ranks_agree(results)
    n = MODELS["VGG11"].batch
    for r in results:
        assert r["counts"]["gathers"] == 1
        assert r["counts"]["gather_bytes"] == n * 512 * 8
