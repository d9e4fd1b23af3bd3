"""The port's data-parallel step, eval and data plane on two gloo ranks,
against the JAX package's ``shard_map`` step on a two-device mesh.

Weights are drawn with numpy and mapped into both frameworks
(``compat.state_dict_from_jax``); both take the same steps on the same
uint8 global batch with augmentation off, each port rank on its
contiguous shard (the rows ``shard_map`` gives each device). The port's
fp32 parameters, BN running stats and metric sums agree with the JAX step
within rtol 1e-4, atol 1e-5 (the tolerance of
``tests/test_torch_train_step.py``), on both ranks, which hold the same
state as raw bits. LeNet takes two steps (the second through the momentum
buffer) in fp32 on both sides. ResNetTiny takes one, computed in float64
on both sides (fp32 parameters in the port, ``jax.enable_x64`` in JAX),
because an fp32 step of it is not reproducible at 1e-4: its stem conv's
gradient runs through every BN backward, and at these weights the fp32
step of either framework lies up to 1.9e-4 (1.6% of a 0.012 update) off
the float64 step, on which JAX's float64 step and the port's agree within
2e-8. Each with and without cross-replica BN; a ragged batch puts its -1
labels on one rank only. Cross-replica BN on two ranks is also held
against the port's own one-process step on the whole global batch.

The two ranks run as one job of ``tests/_torch_dp.py`` workers, shared by
the module; the JAX side runs in this process.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.parallel import (
    DATA_AXIS as JAX_AXIS,
    batch_sharding,
    data_parallel_eval_epoch,
    data_parallel_train_step,
    make_mesh,
    replicate,
)
from pytorch_cifar_tpu.train import optim as jax_optim
from pytorch_cifar_tpu.train import state as jax_state
from pytorch_cifar_tpu.train import steps as jax_steps
from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
from pytorch_cifar_tpu_torch.data.pipeline import DeviceDataset, mix_seed
from pytorch_cifar_tpu_torch.train import optim, steps
from pytorch_cifar_tpu_torch.train.state import create_train_state
from _torch_ckpt import jax_model, port_model
from _torch_dp import run_job
from _torch_threads import torch_threads  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
LR, T_MAX, SPE = 0.1, 4, 3
GLOBAL = 16  # 8 rows a rank


def _random_trees(jmodel, seed):
    """(params, batch_stats) as numpy: fan-in-scaled kernels, non-trivial
    biases, BN affine and running stats."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    rs = np.random.RandomState(seed)

    def param(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rs.uniform(-bound, bound, s.shape).astype(np.float32)
        if leaf in ("scale", "var"):
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(param, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(
        param, shapes.get("batch_stats", {}))
    return params, stats


def _batch(n, seed, ragged=False):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    y = rs.randint(0, 10, n).astype(np.int32)
    if ragged:  # a wrap-padded tail: 5 of rank 1's 8 rows, none of rank 0's
        y[-5:] = -1
    else:
        y[-2:] = -1
    return x, y


CASES = {  # name: (model, steps, sync_bn, ragged)
    "lenet": ("LeNet", 2, False, False),
    "lenet_sync": ("LeNet", 2, True, False),
    "tiny": ("ResNetTiny", 1, False, False),
    "tiny_sync": ("ResNetTiny", 1, True, False),
    "tiny_ragged": ("ResNetTiny", 1, False, True),
}


def _compute(name):
    """The compute dtype of ``name``'s steps, in both frameworks (module
    docstring)."""
    return "float64" if name == "ResNetTiny" else "float32"


def _weights(name, seed):
    params, stats = _random_trees(jax_model(name), seed)
    sd = state_dict_from_jax(name, params, stats, model=port_model(name))
    return params, stats, {k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}


def _batches(case):
    _, n_steps, _, ragged = CASES[case]
    return [_batch(GLOBAL, seed=20 + i, ragged=ragged)
            for i in range(n_steps)]


EVAL_N, EVAL_BATCH, EVAL_STEPS = 20, 8, 3  # the last batch clamped


def _eval_data():
    images, labels = _batch(EVAL_N, seed=31)
    labels[-2:] = 3
    return images, labels


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of one job holding every case."""
    tasks = []
    for i, (case, (name, _, sync_bn, _)) in enumerate(CASES.items()):
        tasks.append({"name": case, "kind": "step", "model": name,
                      "sd": _weights(name, seed=i)[2], "sync_bn": sync_bn,
                      "batches": _batches(case), "lr": LR, "t_max": T_MAX,
                      "spe": SPE, "compute": _compute(name)})
    images, labels = _eval_data()
    common = {"model": "ResNetTiny", "lr": LR, "t_max": T_MAX, "spe": SPE}
    tasks += [
        {"name": "eval", "kind": "eval", **common,
         "sd": _weights("ResNetTiny", seed=9)[2], "images": images,
         "labels": labels, "global_batch": EVAL_BATCH,
         "num_steps": EVAL_STEPS},
        {"name": "augment", "kind": "augment", **common, "model": "LeNet",
         "seed": 3, "batch": _batch(GLOBAL, seed=40)},
        {"name": "perm", "kind": "perm", "images": images, "labels": labels,
         "batch": EVAL_BATCH, "seed": 5},
    ]
    return run_job(tasks, str(tmp_path_factory.mktemp("dp_job")))


@functools.lru_cache(maxsize=None)
def _mesh():
    return make_mesh(2)


def _f64(name):
    return _compute(name) == "float64"


@functools.lru_cache(maxsize=None)
def _jax_step(name, sync_bn):
    dtype = jnp.float64 if _f64(name) else jnp.float32
    return data_parallel_train_step(
        jax_steps.make_train_step(augment=False, axis_name=JAX_AXIS,
                                  sync_bn=sync_bn, compute_dtype=dtype),
        _mesh())


@functools.lru_cache(maxsize=None)
def _jax_static(name):
    """The model's ``apply`` and the optimizer, made once: a train state's
    static fields, so every case of a model reuses one compiled step."""
    tx = jax_optim.make_optimizer(lr=LR, t_max=T_MAX, steps_per_epoch=SPE)
    return jax_model(name).apply, tx


def _jax_state(name, params, stats, dtype=None):
    if dtype is None:
        dtype = jnp.float64 if _f64(name) else jnp.float32
    cast = functools.partial(jnp.asarray, dtype=dtype)
    apply_fn, tx = _jax_static(name)
    params = jax.tree_util.tree_map(cast, params)
    return replicate(jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(cast, stats),
        opt_state=tx.init(params), apply_fn=apply_fn, tx=tx,
    ), _mesh())


def _assert_close(got_sd, name, jst):
    want = state_dict_from_jax(
        name, jax.device_get(jst.params), jax.device_get(jst.batch_stats),
        model=port_model(name))
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got_sd[k].double().numpy(), w,
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _assert_metrics(got, want):
    assert set(got) == set(steps.METRIC_KEYS)
    for k in steps.METRIC_KEYS:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _raw(t):
    """A float tensor's bits as int32 (NaN-safe equality); others as is."""
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t


def _same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(_raw(a[k]), _raw(b[k])), k


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_step_matches_the_jax_shard_map_step(ranks, case):
    """Params, BN running stats and metric sums of both ranks against the
    JAX two-device step on the same global batches; the metrics are the
    global batch's (14 valid of 16, 11 on a ragged batch)."""
    name, n_steps, sync_bn, ragged = CASES[case]
    i = list(CASES).index(case)
    params, stats, _ = _weights(name, seed=i)
    with jax.enable_x64(_f64(name)):
        jst = _jax_state(name, params, stats)
        sh = batch_sharding(_mesh())
        for k, (x, y) in enumerate(_batches(case)):
            jst, jm = _jax_step(name, sync_bn)(
                jst, (jax.device_put(x, sh), jax.device_put(y, sh)),
                jax.random.PRNGKey(0))
            jm = jax.device_get(jm)
            for r in ranks:
                _assert_metrics(r[case]["metrics"][k], jm)
                assert r[case]["metrics"][k]["count"] == (11 if ragged
                                                          else 14)
        for r in ranks:
            assert r[case]["step"] == n_steps == int(jst.step)
            _assert_close(r[case]["sd"], name, jst)


@pytest.mark.parametrize("case", list(CASES))
def test_replicas_hold_the_same_bits(ranks, case):
    """Parameters, BN buffers and momentum buffers equal on both ranks as
    raw bits after the steps."""
    a, b = ranks[0][case], ranks[1][case]
    _same_bits(a["sd"], b["sd"])
    _same_bits(a["mom"], b["mom"])
    assert a["mom"] and a["metrics"] == b["metrics"]


def test_sync_bn_two_ranks_match_one_process_on_the_global_batch(ranks):
    """Cross-replica BN over two shards is BN over the whole batch: the
    port's one-process step (no process group) on the global batch."""
    case = "tiny_sync"
    name = CASES[case][0]
    model = port_model(name)
    model.load_state_dict(_weights(name, seed=list(CASES).index(case))[2])
    model = model.to(memory_format=torch.channels_last)
    state = create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=LR),
        optim.cosine_epoch_schedule(LR, T_MAX, SPE), device="cpu")
    step = steps.make_train_step(augment=False, device="cpu",
                                 compute_dtype=torch.float64)
    (x, y), = _batches(case)
    m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    for r in ranks:
        for k in steps.METRIC_KEYS:
            np.testing.assert_allclose(r[case]["metrics"][0][k], float(m[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(r[case]["sd"][k].numpy(), v.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


def test_sharded_eval_epoch_matches_jax(ranks):
    """The eval epoch over a ragged split (the last global batch clamped
    and labelled -1), each rank on its half of every batch, ResNetTiny's
    folded forward: the JAX sharded eval epoch's totals, the same on both
    ranks."""
    images, labels = _eval_data()
    params, stats, _ = _weights("ResNetTiny", seed=9)
    jst = _jax_state("ResNetTiny", params, stats, dtype=jnp.float32)
    want = jax.device_get(data_parallel_eval_epoch(
        jax_steps.make_eval_epoch(
            jax_steps.make_eval_step(axis_name=JAX_AXIS),
            global_batch=EVAL_BATCH, n_data=EVAL_N, num_steps=EVAL_STEPS,
            axis_name=JAX_AXIS, n_shards=2),
        _mesh())(jst, *replicate((jnp.asarray(images), jnp.asarray(labels)),
                                 _mesh())))
    assert ranks[0]["eval"] == ranks[1]["eval"]
    _assert_metrics(ranks[0]["eval"], want)
    assert ranks[0]["eval"]["count"] == EVAL_N


def test_augmentation_draws_differ_between_ranks(ranks):
    """A data-parallel step draws with its rank folded in after the step,
    as the JAX step folds ``axis_index``: the ranks draw apart, each the
    generator reseeded with ``mix_seed(mix_seed(seed, step), rank)``.
    Without a shard the draw is the one-process rule, unchanged."""
    for r, res in enumerate(ranks):
        assert [(s, shard) for s, shard, _, _ in res["augment"]] == [
            (0, r), (1, r)]
        for step_i, _, offsets, flips in res["augment"]:
            g = torch.Generator().manual_seed(
                mix_seed(mix_seed(3, step_i), r))
            assert torch.equal(offsets, torch.randint(0, 9, offsets.shape,
                                                      generator=g))
            assert torch.equal(flips, torch.rand(flips.shape[0],
                                                 generator=g) < 0.5)
    for a, b in zip(ranks[0]["augment"], ranks[1]["augment"]):
        assert not torch.equal(a[2], b[2])
    state = create_train_state(torch.nn.Linear(1, 1), None, None, seed=3,
                               device="cpu")
    state.step = 1
    offsets, flips = state.draw_augment(8)
    g = torch.Generator().manual_seed(mix_seed(3, 1))
    assert torch.equal(offsets, torch.randint(0, 9, (8, 2), generator=g))
    assert torch.equal(flips, torch.rand(8, generator=g) < 0.5)


def test_ranks_share_the_epoch_permutation(ranks):
    """``staged_perm`` depends on (seed, epoch), not on the rank: both
    ranks, and one process, hold the same permutations on both streams."""
    images, labels = _eval_data()
    for device_perm in (False, True):
        want = DeviceDataset(images, labels, batch_size=EVAL_BATCH, seed=5,
                             device_perm=device_perm, device="cpu")
        for e in range(2):
            for r in ranks:
                assert torch.equal(r["perm"][device_perm][e],
                                   want.staged_perm(e))
