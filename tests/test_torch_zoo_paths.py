"""The zoo slice end to end on the CPU: MobileNet's and SimpleDLA's train
steps and MobileNet's engine against the JAX package, and GoogLeNet,
MobileNet and SimpleDLA through the port's trainer, its CLIs and its
serving stack.

One JAX compile each for the MobileNet and SimpleDLA train steps and the
MobileNet engine; no whole-GoogLeNet JAX compile (its models are held in
``tests/test_torch_zoo_models.py``).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.models import create_model as jax_create_model
from pytorch_cifar_tpu.serve.engine import InferenceEngine as JaxEngine
from pytorch_cifar_tpu.train import optim as jax_optim
from pytorch_cifar_tpu.train import state as jax_state
from pytorch_cifar_tpu.train import steps as jax_steps
from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
from pytorch_cifar_tpu_torch.config import TrainConfig
from pytorch_cifar_tpu_torch.models import common, create_model
from pytorch_cifar_tpu_torch.serve import InferenceEngine, MicroBatcher, run_load
from pytorch_cifar_tpu_torch.serve.__main__ import main as serve_main
from pytorch_cifar_tpu_torch.tools import depthwise_bench, pool_bench
from pytorch_cifar_tpu_torch.train import optim, steps
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from pytorch_cifar_tpu_torch.train.state import create_train_state
from pytorch_cifar_tpu_torch.train.trainer import Trainer
from _torch_threads import torch_threads  # noqa: F401

LR, T_MAX, SPE = 0.1, 4, 3


def _jax_trees(name, seed):
    """(params, batch_stats) as numpy: fan-in-scaled kernels, non-trivial
    biases, BN affine and running stats."""
    shapes = jax.eval_shape(lambda: jax_create_model(name).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False
    ))
    rs = np.random.RandomState(seed)

    def param(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rs.uniform(-bound, bound, s.shape).astype(np.float32)
        if leaf == "scale":
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    def stat(path, s):
        if path[-1].key == "var":
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(param, shapes["params"]),
            jax.tree_util.tree_map_with_path(stat, shapes["batch_stats"]))


def _images(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    y = rs.randint(0, 10, n).astype(np.int32)
    return x, y


def _port_state(name, params, stats):
    model = create_model(name)
    model.load_state_dict({
        k: torch.from_numpy(v)
        for k, v in state_dict_from_jax(name, params, stats).items()
    })
    model = model.to(memory_format=torch.channels_last)
    return create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=LR),
        optim.cosine_epoch_schedule(LR, T_MAX, SPE), device="cpu",
    )


def _train_step_vs_jax(name, n=32, seed=0):
    """One fp32 step of ``name`` from the same weights and batch (``n``
    images, the last two padded), augmentation off, in the JAX package and
    in the port, and the port's step in float64 compute as the reference.
    The forward's work is held here: the metric sums and the BN running
    statistics within rtol 1e-4. Returns, per tensor, each step's error in
    units of its update: ``(worst port vs float64, worst JAX vs float64,
    {tensor: port vs JAX})``, for the caller to hold at the model's own
    conditioning."""
    params, stats = _jax_trees(name, seed=seed)
    x, y = _images(n, seed=10)
    y[-2:] = -1  # padded rows: masked from loss, gradients and metrics
    tx = jax_optim.make_optimizer(lr=LR, t_max=T_MAX, steps_per_epoch=SPE)
    jmodel = jax_create_model(name)
    st = jax_state.create_train_state(jmodel, jax.random.PRNGKey(0), tx)
    as_jax = jax.tree_util.tree_map(jnp.asarray, params)
    st = st.replace(params=as_jax, opt_state=tx.init(as_jax),
                    batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    st, jm = jax.jit(jax_steps.make_train_step(augment=False))(
        st, (jnp.asarray(x), jnp.asarray(y)), jax.random.PRNGKey(1)
    )
    want = state_dict_from_jax(name, jax.device_get(st.params),
                               jax.device_get(st.batch_stats))
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    after, metrics = {}, {}
    for dtype in (torch.float32, torch.float64):
        state = _port_state(name, params, stats)
        before = {k: v.detach().clone().numpy()
                  for k, v in state.model.state_dict().items()}
        metrics[dtype] = steps.make_train_step(
            augment=False, device="cpu", compute_dtype=dtype
        )(state, batch)
        after[dtype] = {k: v.detach().numpy()
                        for k, v in state.model.state_dict().items()}
        assert state.step == 1
    pm = metrics[torch.float32]
    for k in steps.METRIC_KEYS:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert float(pm["count"]) == n - 2
    got, ref = after[torch.float32], after[torch.float64]
    errs = {"port": 0.0, "jax": 0.0}
    direct = {}
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running_" in k:
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            continue
        update = max(float(np.abs(ref[k] - before[k]).max()), 1e-30)
        assert update > 1e-30, f"{k} did not move"
        errs["port"] = max(errs["port"],
                           float(np.abs(got[k] - ref[k]).max()) / update)
        errs["jax"] = max(errs["jax"],
                          float(np.abs(w - ref[k]).max()) / update)
        direct[k] = float(np.abs(got[k] - w).max()) / update
    return errs["port"], errs["jax"], direct


def test_mobilenet_train_step_matches_jax_fp32():
    """One step from the same weights and batch, augmentation off. The
    forward's work is held tightly: the metric sums and the BN running
    statistics within rtol 1e-4. The updated parameters are held at the
    step's own conditioning: BN's backward subtracts nearly equal terms, so
    an fp32 step is accurate only to a few percent of its update on its
    worst tensor (the JAX fp32 step is 12% of an update off a
    float64-compute step here, the port's 6%). The port's fp32 step must be
    no further from the port's float64-compute step, in units of each
    tensor's update, than twice the JAX fp32 step is; the JAX step itself
    within 25% of an update on its worst tensor and, directly against the
    port's fp32 step, within 10% on the median tensor (4.4% here). The
    linear layer sits behind no BN backward and is held directly: its
    update within 1e-3 of the JAX step's (2.5e-4 here)."""
    port, jax_err, direct = _train_step_vs_jax("MobileNet")
    errs = {"port": port, "jax": jax_err}
    assert errs["port"] <= 2 * errs["jax"], errs
    assert errs["jax"] <= 0.25, errs  # the same step, not merely some step
    assert np.median(list(direct.values())) <= 0.1, direct
    for k in ("linear.weight", "linear.bias"):
        assert direct[k] <= 1e-3, (k, direct[k])


def test_simpledla_train_step_matches_jax_fp32():
    """SimpleDLA's step as MobileNet's above, at 16 images (the last two
    padded), held at its own conditioning. Measured on the CPU over weight
    seeds 2, 3 and 4: the JAX fp32 step is 10-22% of an update off the
    float64-compute step on its worst tensor, the port's 6-18% (0.58-0.81
    times the JAX step's), the two steps 1.9-2.6% apart on the median
    tensor and 6e-5 to 9e-5 on the linear layer. Held: the port no further
    off than twice the JAX step, the JAX step within 30% of an update, the
    median within 10% and the linear within 1e-3."""
    port, jax_err, direct = _train_step_vs_jax("SimpleDLA", n=16, seed=2)
    errs = {"port": port, "jax": jax_err}
    assert errs["port"] <= 2 * errs["jax"], errs
    assert errs["jax"] <= 0.3, errs  # the same step, not merely some step
    assert np.median(list(direct.values())) <= 0.1, direct
    for k in ("linear.weight", "linear.bias"):
        assert direct[k] <= 1e-3, (k, direct[k])


def test_cli_trains_the_default_model_on_the_cpu(caplog):
    """``python -m pytorch_cifar_tpu_torch.train --device cpu
    --synthetic_data --synthetic_train_size 256 --batch_size 32 --epochs 1``
    with no ``--model``, in-process: the default model, SimpleDLA, trains
    (bf16, the default) with every image counted and finite losses."""
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--synthetic_data", "--synthetic_train_size",
        "256", "--synthetic_test_size", "64", "--batch_size", "32",
        "--epochs", "1",
    ])
    (h,) = out["history"]
    assert h["train"]["count"] == 256 and h["eval"]["count"] == 64
    assert h["train"]["nonfinite"] == 0
    assert np.isfinite(h["train_loss"]) and np.isfinite(h["eval_loss"])
    assert "==> model SimpleDLA" in caplog.text


def test_mobilenet_port_engine_matches_jax_engine_fp32():
    params, stats = _jax_trees("MobileNet", seed=1)
    jeng = JaxEngine("MobileNet", params, stats, buckets=(4,),
                     compute_dtype=jnp.float32)
    peng = InferenceEngine.from_jax(
        "MobileNet", params, stats, buckets=(4,),
        compute_dtype=torch.float32, device="cpu",
    )
    x, _ = _images(3, seed=11)
    want, got = jeng.predict(x), peng.predict(x)
    assert got.dtype == np.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["GoogLeNet", "MobileNet", "SimpleDLA"])
def test_engine_serves_the_zoo_models_under_load(name):
    """Engine, batcher and load generator, model-agnostic: padded buckets
    bit-identical to the direct forward, every request answered, and the
    served logits those of the model's own folded forward."""
    engine = InferenceEngine.from_random(
        name, seed=0, buckets=(1, 4), compute_dtype=torch.float32,
        device="cpu",
    )
    x, _ = _images(3, seed=12)
    padded = engine.predict(x)
    np.testing.assert_array_equal(padded, engine.direct_forward(x))
    model = create_model(name, generator=torch.Generator().manual_seed(0))
    model.eval()
    from pytorch_cifar_tpu_torch.data.augment import (
        CIFAR10_MEAN, CIFAR10_STD, normalize)
    with torch.no_grad():
        xn = normalize(torch.from_numpy(x), torch.tensor(CIFAR10_MEAN),
                       torch.tensor(CIFAR10_STD), torch.float32)
        want = model(xn.permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(padded, want, rtol=1e-5, atol=1e-6)
    batcher = MicroBatcher(engine, max_wait_ms=1.0)
    try:
        report = run_load(batcher, clients=2, requests_per_client=3,
                          images_max=3, seed=0)
    finally:
        batcher.close()
    assert report["failed"] == 0 and report["requests"] == 6
    assert engine.compile_count == 2


@pytest.mark.parametrize("name", ["GoogLeNet", "MobileNet"])
def test_serve_cli_runs_the_zoo_models_on_the_cpu(name, capsys):
    import json

    rc = serve_main([
        "--device", "cpu", "--model", name, "--dtype", "float32",
        "--buckets", "1", "4", "--clients", "2", "--requests", "2",
        "--verify",
    ])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["model"] == name and rec["failed"] == 0
    assert rec["kernel_launches"] == 0  # CPU tensors launch nothing
    assert set(rec["launches_by_kernel"]) == {
        "conv3x3_bn_relu", "max_pool3x3_s1", "depthwise_stencil"
    }


def test_cli_trains_mobilenet_on_the_cpu(caplog):
    """``python -m pytorch_cifar_tpu_torch.train --device cpu --model
    MobileNet --synthetic_data --epochs 2``, in-process: a falling loss and
    every image counted once per epoch."""
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--model", "MobileNet", "--synthetic_data",
        "--epochs", "2", "--no-amp", "--synthetic_train_size", "512",
        "--synthetic_test_size", "60", "--batch_size", "32",
        "--eval_batch_size", "64", "--lr", "0.01",
    ])
    hist = out["history"]
    assert len(hist) == 2
    for h in hist:
        assert h["train"]["count"] == 512 and h["eval"]["count"] == 60
        assert h["train"]["nonfinite"] == 0
    assert hist[1]["train_loss"] < hist[0]["train_loss"]
    assert "==> model MobileNet" in caplog.text


def test_trainer_trains_googlenet_through_the_pool_op(monkeypatch):
    """``Trainer.fit`` on GoogLeNet at full width (a tiny synthetic split
    on the CPU): nothing in the trainer is model-specific, and every train
    step pools 9 times under autograd, every eval forward 9 times without."""
    calls = []
    real = common.max_pool3x3_s1
    monkeypatch.setattr(
        common, "max_pool3x3_s1",
        lambda v: calls.append(v.requires_grad) or real(v),
    )
    cfg = TrainConfig(
        model="GoogLeNet", batch_size=8, eval_batch_size=8, amp=False,
        synthetic_data=True, synthetic_train_size=16, synthetic_test_size=8,
        epochs=1, lr=0.01, device="cpu",
    )
    trainer = Trainer(cfg)
    trainer.fit()
    (h,) = trainer.history
    assert h["train"]["count"] == 16 and h["eval"]["count"] == 8
    assert np.isfinite(h["train_loss"]) and h["train"]["nonfinite"] == 0
    assert calls == [True] * 18 + [False] * 9  # 2 train steps, 1 eval forward


def test_nothing_model_specific_is_left_in_config_and_trainer():
    """Any registered model's name passes the config check; an unported one
    raises from the registry, naming what is there."""
    for name in ("GoogLeNet", "MobileNet", "ResNet18", "LeNet"):
        cfg = TrainConfig(model=name, synthetic_data=True, device="cpu")
        assert cfg.model == name
    with pytest.raises(NotImplementedError, match="GoogLeNet.*MobileNet"):
        Trainer(TrainConfig(model="PNASNetA", synthetic_data=True,
                            synthetic_train_size=8, synthetic_test_size=8,
                            batch_size=8, device="cpu"))


@pytest.mark.parametrize("tool", [pool_bench, depthwise_bench],
                         ids=["pool_bench", "depthwise_bench"])
def test_bench_tools_measure_only_on_a_card(tool):
    """The kernel bench tools print device times: with no card they raise
    before timing anything, they do not time the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])
