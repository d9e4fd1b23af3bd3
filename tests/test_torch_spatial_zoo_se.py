"""Spatial partitioning of SENet, RegNetY, DenseNet and DPN on gloo ranks
(helpers: ``tests/_torch_spatial_zoo.py``).

One registry name a family takes one train step over the ``(data, spatial,
spatial_w)`` meshes (1, 2, 1) and (1, 2, 2) against the port's one-process
step on the global batch, in float64 compute (fp32 parameters) at the
float64 tolerances, and its folded eval forward against the one-process
eval step.

- SENet's and RegNetY's squeeze-excitation gates take the mean over the
  whole map (a sum over the spatial group), never the slab's own mean:
  one reduction per gate, besides the head's pool.
- DenseNet reduces each new chunk's batch moments once (the slab's) and
  every BN pools the concatenation once, by element count. At (1, 8, 1)
  the ranks 4-7 own no row of the last stage's 4x4 maps; their empty
  slabs are never handed to the moments function (where kernel K2 plugs
  in), and the step still matches one process's.
- DPN's dual paths slice and concatenate channels of marked slabs.
"""

import numpy as np
import pytest
import torch

from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.models.common import bn_moments_impl
from pytorch_cifar_tpu_torch.models.densenet import _moments
from pytorch_cifar_tpu_torch.parallel.spatial import shard_range
from _torch_threads import torch_threads  # noqa: F401
import _torch_spatial_zoo as zoo

MODELS = {
    "SENet18": zoo.Case(),
    "RegNetY_400MF": zoo.Case(),
    "DenseNetCifar": zoo.Case(),
    "DPN26": zoo.Case(),
}
# the squeeze-excitation gates a forward runs
SE_GATES = {"SENet18": 8, "RegNetY_400MF": 22}
TALL = "DenseNetCifar@1x8x1"


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tasks = zoo.family_tasks(MODELS)
    tasks.append(zoo.step_task(TALL, "DenseNetCifar", (1, 8, 1),
                               MODELS["DenseNetCifar"], count_moments=True))
    return zoo.run_tasks(tasks, tmp_path_factory.mktemp("spatial_zoo_se"))


@pytest.mark.parametrize("mesh", sorted(zoo.MESHES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_matches_one_process(jobs, name, mesh):
    zoo.check_step(jobs[zoo.step_name(name, mesh)], name, MODELS[name])


@pytest.mark.parametrize("mesh", sorted(zoo.MESHES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_matches_one_process(jobs, name, mesh):
    zoo.check_eval(jobs[zoo.eval_name(name, mesh)], name,
                   MODELS[name].batch)


@pytest.mark.parametrize("name", sorted(SE_GATES))
def test_se_gates_take_the_mean_over_the_whole_map(jobs, name):
    """Each gate's squeeze is one sum over the spatial group (a slab's
    own mean would be a different gate on every rank), and the head's
    pool one more."""
    for mesh in zoo.MESHES:
        for r in jobs[zoo.step_name(name, mesh)]:
            assert r["counts"]["group_sums"] == SE_GATES[name] + 1


def test_densenet_rank_with_empty_slabs_reduces_no_moments(jobs):
    """At (1, 8, 1) the last stage's 4x4 maps cut one row a rank: ranks
    4-7 own none. No rank hands the moments function an empty slab; the
    ranks that own rows hand it every BN's chunks of the stage; every
    rank takes part in every pooled reduction and holds the same state as
    one process's step."""
    assert [shard_range(4, s, 8) for s in (3, 4)] == [(3, 4), (4, 4)]
    results = jobs[TALL]
    zoo.ranks_agree(results)
    sd, want = zoo.one_process_step("DenseNetCifar", MODELS["DenseNetCifar"])
    zoo.assert_state(results[0]["sd"], sd, zoo.F64_STATE_ATOL,
                     zoo.F64_STATE_ATOL, rtol=zoo.F64_STATE_RTOL)
    np.testing.assert_allclose(results[0]["metrics"][0]["loss_sum"],
                               want["loss_sum"], rtol=zoo.F64_LOSS_RTOL)
    sizes = [r["moment_sizes"] for r in results]
    reductions = {r["counts"]["bn_reductions"] for r in results}
    assert len(reductions) == 1
    for s in sizes:
        assert s and min(s) > 0
    # the last stage's reductions: the stack it starts from, then each of
    # its 16 layers' new chunk and bn2 input (the other BNs, the head's
    # too, read the stack's moments)
    assert len(sizes[3]) - len(sizes[4]) == 1 + 2 * 16
    assert all(len(s) == len(sizes[4]) for s in sizes[4:])


def test_densenet_moments_of_an_empty_chunk_launch_nothing():
    """``_moments`` of a chunk of no element is zeros, in the moments'
    dtype, and never reaches the moments function."""
    calls = []

    def hook(x):
        calls.append(x.shape)
        return x.mean(dim=(0, 1, 2)), (x * x).mean(dim=(0, 1, 2))

    empty = torch.zeros((4, 12, 0, 4), dtype=torch.float64)
    with bn_moments_impl(hook):
        m, sq = _moments(empty)
        _moments(torch.ones((4, 12, 2, 4)))
    assert len(calls) == 1
    assert m.dtype == torch.float64 and m.shape == (12,)
    assert not m.any() and not sq.any()
    assert create_model("DenseNetCifar").shared_stats
