"""What the spatial test files share (``tests/test_torch_spatial.py``,
``tests/test_torch_spatial_zoo*.py``).

Each file holds a few model families under spatial partitioning on gloo
ranks (``_torch_spatial.run_job``): one train step and the folded eval
forward of one registry name a family over the ``(data, spatial,
spatial_w)`` meshes (1, 2, 1) and (1, 2, 2), against the port's own
one-process step and eval step on the global batch, every rank holding
the same bits. Weights are drawn with numpy on the JAX model's tree and
mapped by ``compat.state_dict_from_jax`` (:func:`weights`); batches have
two labels -1.

A step in fp32 compute is held at JAX's own tolerances
(``tests/test_spatial.py``): the loss within rtol 1e-5, every parameter
within atol 5e-4, every BN running stat within atol 1e-5. At the CPU
tests' batches an fp32 step of most of the zoo is itself no closer than
1e-3 to another fp32 step that sums in another order (SimpleDLA's
16-channel stems moved 1.4e-3 at batch 16), so those steps compute in
float64 (fp32 parameters), where the comparison holds the spatial
machinery rather than fp32 rounding: the loss within rtol 1e-9, the
parameters and buffers within one rounding of the update (rtol 1e-6, atol
1e-7), as ``tests/test_torch_spatial.py`` holds GoogLeNet.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.train import optim, steps
from pytorch_cifar_tpu_torch.train.state import create_train_state
from _torch_ckpt import jax_model
from _torch_spatial import run_job

LOSS_RTOL, PARAM_ATOL, BN_ATOL = 1e-5, 5e-4, 1e-5
# float64 compute, fp32 parameters and buffers: the loss to float64's
# reach, the state to one fp32 rounding of the update
F64_LOSS_RTOL, F64_STATE_RTOL, F64_STATE_ATOL = 1e-9, 1e-6, 1e-7
LR, T_MAX, SPE = 0.1, 4, 3
MESHES = {"1x2x1": (1, 2, 1), "1x2x2": (1, 2, 2)}
WEIGHT_SEED, STEP_SEED, EVAL_SEED = 1, 20, 9


class Case(NamedTuple):
    """How a model's step is held: its compute dtype, the global batch and
    whether the step augments."""

    compute: str = "float64"
    batch: int = 8
    augment: bool = True


def random_trees(name, seed):
    """(params, batch_stats) of the JAX model as numpy: fan-in-scaled
    kernels, non-trivial biases, BN affine and running stats."""
    jm = jax_model(name)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        key = path[-1].key
        if key == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rs.uniform(-bound, bound, s.shape).astype(np.float32)
        if key in ("scale", "var"):
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(leaf, shapes["params"]),
            jax.tree_util.tree_map_with_path(
                leaf, shapes.get("batch_stats", {})))


@functools.lru_cache(maxsize=None)
def weights(name, seed=WEIGHT_SEED):
    """(JAX params, JAX batch_stats, the port's state dict) of ``name``."""
    params, stats = random_trees(name, seed)
    sd = state_dict_from_jax(name, params, stats, model=create_model(name))
    return params, stats, {k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}


def batch(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    y = rs.randint(0, 10, n).astype(np.int32)
    y[-2:] = -1
    return x, y


def step_name(name, mesh):
    return f"{name}@{mesh}"


def eval_name(name, mesh):
    return f"eval_{name}@{mesh}"


def step_task(task, name, mesh, case, **extra):
    return {"name": task, "kind": "step", "model": name, "mesh": mesh,
            "sd": weights(name)[2],
            "batches": [batch(case.batch, STEP_SEED)],
            "augment": case.augment, "compute": case.compute, "lr": LR,
            "t_max": T_MAX, "spe": SPE, "seed": 4, **extra}


def eval_task(task, name, mesh, n):
    images, labels = batch(n, EVAL_SEED)
    return {"name": task, "kind": "eval", "model": name, "mesh": mesh,
            "sd": weights(name)[2], "images": images, "labels": labels,
            "global_batch": n, "num_steps": 1, "lr": LR, "t_max": T_MAX,
            "spe": SPE}


def family_tasks(models):
    """A step and an eval task of every model over every mesh of
    :data:`MESHES`; ``models``: ``{name: Case}``."""
    tasks = []
    for name, case in models.items():
        for m, mesh in MESHES.items():
            tasks.append(step_task(step_name(name, m), name, mesh, case))
            tasks.append(eval_task(eval_name(name, m), name, mesh,
                                   case.batch))
    return tasks


def run_tasks(tasks, root):
    """Every task on gloo ranks, one job per world size: ``{task: [each
    rank's result]}``."""
    out = {}
    for world in sorted({int(np.prod(t["mesh"])) for t in tasks}):
        mine = [t for t in tasks if int(np.prod(t["mesh"])) == world]
        results = run_job(mine, str(root / f"world{world}"), world)
        out.update({t["name"]: [r[t["name"]] for r in results]
                    for t in mine})
    return out


def _state(name):
    model = create_model(name)
    model.load_state_dict(weights(name)[2])
    model = model.to(memory_format=torch.channels_last)
    return create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=LR),
        optim.cosine_epoch_schedule(LR, T_MAX, SPE), seed=4, device="cpu")


@functools.lru_cache(maxsize=None)
def one_process_step(name, case):
    """The port's one-process step on the global batch: (state dict,
    metrics)."""
    state = _state(name)
    x, y = batch(case.batch, STEP_SEED)
    m = steps.make_train_step(
        augment=case.augment, compute_dtype=getattr(torch, case.compute),
        device="cpu")(state, (torch.from_numpy(x), torch.from_numpy(y)))
    return ({k: v.detach().clone()
             for k, v in state.model.state_dict().items()},
            {k: float(v) for k, v in m.items()})


@functools.lru_cache(maxsize=None)
def one_process_eval(name, n):
    x, y = batch(n, EVAL_SEED)
    m = steps.make_eval_step(device="cpu")(
        _state(name), (torch.from_numpy(x), torch.from_numpy(y)))
    return {k: float(v) for k, v in m.items()}


def assert_state(got, want, param_atol, bn_atol, rtol=0.0):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        atol = bn_atol if "running" in k else param_atol
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(w, np.float64), rtol=rtol,
                                   atol=atol, err_msg=k)


def ranks_agree(results):
    """Every rank holds the same state and metrics, bit for bit."""
    for r in results[1:]:
        assert r["metrics"] == results[0]["metrics"]
        for k, v in results[0]["sd"].items():
            assert torch.equal(r["sd"][k], v), k


def check_step(results, name, case):
    """Every rank's step against the one-process step, at the tolerances
    of the case's compute dtype (the module docstring)."""
    ranks_agree(results)
    sd, want = one_process_step(name, case)
    got = results[0]["metrics"][0]
    if case.compute == "float64":
        assert_state(results[0]["sd"], sd, F64_STATE_ATOL, F64_STATE_ATOL,
                     rtol=F64_STATE_RTOL)
        rtol = F64_LOSS_RTOL
    else:
        assert_state(results[0]["sd"], sd, PARAM_ATOL, BN_ATOL)
        rtol = LOSS_RTOL
    np.testing.assert_allclose(got["loss_sum"], want["loss_sum"], rtol=rtol)
    assert got["count"] == want["count"] == case.batch - 2
    assert got["correct"] == want["correct"]
    assert results[0]["counts"]["halo_exchanges_h"] > 0


def check_eval(results, name, n):
    """Every rank's eval metrics against the one-process eval step's."""
    want = one_process_eval(name, n)
    for got in results:
        np.testing.assert_allclose(got["loss_sum"], want["loss_sum"],
                                   rtol=LOSS_RTOL)
        assert got["correct"] == want["correct"]
        assert got["count"] == want["count"] == n - 2
