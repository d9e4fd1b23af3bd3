"""The divergence sentinel of the port against the JAX package's.

The step half (``make_train_step(skip_nonfinite=True)``): on the CPU in
fp32 a finite guarded step is bit-identical to the unguarded one; a
poisoned step leaves the params, momentum buffers and BN running buffers
as raw bits, with the step counter advanced; a skipped first step leaves
the optimizer as if it never ran, so the next update is optax's ``trace``
from zeros. Over two epochs of the epoch program with ``nan_loss`` at one
step, the port's params and momentum equal the JAX epoch program's (LeNet,
fp32, rtol 1e-4 and atol 1e-5, the step tests' tolerance) and the per-step
slots name the same step.

The policy half (``Trainer``), as ``tests/test_faults.py`` pins the JAX
trainer's: a skip stays finite and close to the clean run; ``nan_loss=5``
at 4 steps an epoch is attributed to global step 5; ``sentinel off``
poisons the params; ``rollback`` after the budget restores the checkpoint
bit for bit; a rollback with no checkpoint logs and goes on; an unknown
policy raises.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu import faults as jax_faults
from pytorch_cifar_tpu.data.pipeline import DeviceDataset as JaxDeviceDataset
from pytorch_cifar_tpu.train import steps as jax_steps
from pytorch_cifar_tpu_torch import faults
from pytorch_cifar_tpu_torch.compat import snapshot_state, state_dict_from_jax
from pytorch_cifar_tpu_torch.config import TrainConfig
from pytorch_cifar_tpu_torch.data.pipeline import DeviceDataset
from pytorch_cifar_tpu_torch.models.common import reset_parameters
from pytorch_cifar_tpu_torch.models.resnet import BasicBlock, ResNet
from pytorch_cifar_tpu_torch.train import optim, steps
from pytorch_cifar_tpu_torch.train.state import create_train_state
from pytorch_cifar_tpu_torch.train.trainer import Trainer
from _torch_ckpt import momentum
from _torch_threads import torch_threads  # noqa: F401
from test_torch_train_step import ATOL, RTOL, Pair, _batch


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def _raw(state) -> torch.Tensor:
    """Params, BN stats and momentum buffers of ``state`` as raw bits."""
    return snapshot_state(state).flat.view(torch.int32).clone()


def _tiny_state(seed):
    """A port-only ResNetTiny state (BN buffers, momentum) from ``seed``."""
    model = ResNet(BasicBlock, (1, 1, 1, 1))
    reset_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(memory_format=torch.channels_last)
    return create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=0.1),
        optim.cosine_epoch_schedule(0.1, 4, 3), device="cpu")


def _step(**kw):
    return steps.make_train_step(augment=False, device="cpu", **kw)


def _batches(n, seed):
    return [tuple(torch.from_numpy(a) for a in _batch(8, seed + i))
            for i in range(n)]


# -- the step half ---------------------------------------------------------


def test_finite_guarded_steps_equal_unguarded_bit_for_bit():
    """ResNetTiny (BN buffers, momentum), three fp32 steps: the guard's
    select picks the new values as raw bits."""
    guarded, plain = _tiny_state(0), _tiny_state(0)
    g, p = _step(skip_nonfinite=True), _step()
    for b in _batches(3, 20):
        mg, mp = g(guarded, b), p(plain, b)
        assert float(mg["nonfinite"]) == float(mp["nonfinite"]) == 0
    assert torch.equal(_raw(guarded), _raw(plain))


def test_poisoned_step_leaves_the_state_as_raw_bits():
    faults.inject("nan_loss", 2)
    state = _tiny_state(1)
    step = _step(skip_nonfinite=True)
    bs = _batches(3, 30)
    step(state, bs[0])
    step(state, bs[1])
    before = _raw(state)
    m = step(state, bs[2])
    assert float(m["nonfinite"]) == 1.0
    assert torch.equal(_raw(state), before)
    assert state.step == 3  # the schedule and the draws stay aligned


def test_skip_at_step_zero_then_the_next_update_is_optax_from_zeros():
    """A poisoned first step leaves the params and momentum as they were
    (momentum zeros); the second update equals the JAX step's from the
    same params with optax's trace from zeros."""
    faults.inject("nan_loss", 0)
    pair = Pair("LeNet", seed=2)
    start = {k: v.clone() for k, v in pair.port.model.state_dict().items()}
    step = _step(skip_nonfinite=True)
    b0, b1 = _batches(2, 40)
    assert float(step(pair.port, b0)["nonfinite"]) == 1.0
    for k, v in pair.port.model.state_dict().items():
        assert torch.equal(v, start[k]), k
    assert all(not buf.any() for buf in momentum(pair.port).values())
    step(pair.port, b1)
    # the JAX step at global step 1 from the same params, trace zeros
    jstep = jax.jit(jax_steps.make_train_step(augment=False))
    js = pair.jax.replace(step=jnp.asarray(1, jnp.int32))
    js, _ = jstep(js, tuple(jnp.asarray(t.numpy()) for t in b1),
                  jax.random.PRNGKey(1))
    pair.jax = js
    pair.assert_close()
    trace = js.opt_state[1].trace
    want = state_dict_from_jax("LeNet", jax.device_get(trace), {},
                               model=pair.port.model)
    got = momentum(pair.port)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_skipped_epoch_matches_the_jax_epoch_program():
    """LeNet, 20 images at batch 8 (3 steps an epoch), 2 epochs on the
    host permutation, ``nan_loss`` at global step 4 on both sides: the
    params and momentum after the epochs, and the per-step slots."""
    n, batch, spe = 20, 8, 3
    rs = np.random.RandomState(3)
    images = rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.int32)
    jax_faults.inject("nan_loss", 4)
    faults.inject("nan_loss", 4)
    pair = Pair("LeNet", seed=2)
    jdata = JaxDeviceDataset(images, labels, batch, seed=5)
    pdata = DeviceDataset(images, labels, batch, seed=5, device="cpu")
    jepoch = jax.jit(jax_steps.make_train_epoch(
        jax_steps.make_train_step(augment=False, skip_nonfinite=True),
        global_batch=batch, n_data=n, num_steps=spe))
    pepoch = steps.make_train_epoch(
        _step(skip_nonfinite=True), global_batch=batch, n_data=n,
        num_steps=spe)
    for epoch in range(2):
        perm = jdata.staged_perm(epoch)
        pair.jax, jt = jepoch(pair.jax, jax_steps.zero_metrics(spe),
                              jdata.images, jdata.labels, perm,
                              jax.random.PRNGKey(0))
        pair.port, pt = pepoch(pair.port, steps.zero_metrics(num_steps=spe),
                               pdata.images, pdata.labels,
                               pdata.staged_perm(epoch))
        np.testing.assert_array_equal(pt["nonfinite_steps"].numpy(),
                                      np.asarray(jt["nonfinite_steps"]))
        assert float(pt["nonfinite"]) == float(jt["nonfinite"])
    assert pt["nonfinite_steps"].tolist() == [0.0, 1.0, 0.0]
    assert pair.port.step == int(pair.jax.step) == 6
    pair.assert_close()
    want = state_dict_from_jax(
        "LeNet", jax.device_get(pair.jax.opt_state[1].trace), {},
        model=pair.port.model)
    got = momentum(pair.port)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# -- the policy half ----------------------------------------------------------


def small_config(out_dir, **kw):
    defaults = dict(
        model="LeNet", epochs=1, batch_size=64, eval_batch_size=64,
        synthetic_data=True, synthetic_train_size=256,
        synthetic_test_size=128, lr=0.02, output_dir=str(out_dir),
        amp=False, log_every=1000, device="cpu",
    )
    defaults.update(kw)
    return TrainConfig(**defaults)


def _params(trainer):
    return [p.detach().clone() for p in trainer.state.model.parameters()]


def test_nan_step_skipped_params_finite_and_close_to_clean(tmp_path):
    clean = Trainer(small_config(tmp_path / "clean"))
    clean.train_epoch(0)
    faults.inject("nan_loss", 2)  # global step 2 of the 4 this epoch
    faulted = Trainer(small_config(tmp_path / "faulted"))
    faulted.train_epoch(0)
    assert faulted.fault_stats["bad_steps"] == 1
    assert faulted.fault_stats["bad_step_indices"] == [2]
    deltas = []
    for a, b in zip(_params(clean), _params(faulted)):
        assert torch.isfinite(b).all()
        deltas.append((a - b).abs().max().item())
    assert max(deltas) < 0.05, f"skip diverged from clean run: {max(deltas)}"
    assert faulted.state.step == clean.state.step


def test_sentinel_reports_per_step_indices(tmp_path):
    faults.inject("nan_loss", 5)  # epoch 1, its step 1 of 4
    tr = Trainer(small_config(tmp_path, epochs=2))
    assert tr.train_epoch_fn is not None  # the device-resident plane
    tr.train_epoch(0)
    assert tr.fault_stats["bad_step_indices"] == []
    tr.train_epoch(1)
    assert tr.fault_stats["bad_steps"] == 1
    assert tr.fault_stats["bad_step_indices"] == [5]
    assert tr.obs.counter("train.sentinel.bad_steps").value == 1.0


def test_nan_without_sentinel_poisons_params(tmp_path):
    faults.inject("nan_loss", 2)
    tr = Trainer(small_config(tmp_path, sentinel="off"))
    tr.train_epoch(0)
    assert any(not torch.isfinite(p).all() for p in _params(tr))
    assert tr.fault_stats["bad_steps"] == 0  # off: nothing counted


def test_rollback_after_budget_restores_checkpoint(tmp_path):
    faults.inject("nan_loss", 4)  # epoch 0 (steps 0-3) clean, step 4 bad
    tr = Trainer(small_config(tmp_path, epochs=2, sentinel="rollback",
                              sentinel_budget=1))
    tr.train_epoch(0)
    saved = _raw(tr.state)
    _, acc = tr.eval_epoch(0)
    assert tr.maybe_checkpoint(0, acc)
    tr.flush_checkpoints()
    tr.train_epoch(1)  # bad step 4 -> budget hit -> rollback to epoch 0
    assert tr.fault_stats["bad_steps"] == 1
    assert tr.fault_stats["rollbacks"] == 1
    assert torch.equal(_raw(tr.state), saved)
    assert tr.state.step == 4  # the checkpoint's step


def test_rollback_without_checkpoint_logs_and_continues(tmp_path, caplog):
    faults.inject("nan_loss", 0)
    tr = Trainer(small_config(tmp_path, sentinel="rollback",
                              sentinel_budget=1))
    with caplog.at_level(logging.WARNING):
        tr.train_epoch(0)  # no checkpoint on disk yet
    assert tr.fault_stats["rollbacks"] == 0
    assert any("no usable checkpoint" in r.message for r in caplog.records)
    assert all(torch.isfinite(p).all() for p in _params(tr))


def test_invalid_sentinel_policy_rejected(tmp_path):
    with pytest.raises(ValueError, match="sentinel"):
        Trainer(small_config(tmp_path, sentinel="explode"))
