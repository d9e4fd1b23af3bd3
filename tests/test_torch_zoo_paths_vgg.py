"""VGG end to end on the CPU: one float64 train step of a narrow VGG
against the JAX package's, the train CLI, the serving engine, the serving
CLI, and a checkpoint written by the JAX package served by the port's
``serve --ckpt`` (the conv biases through the bridge). Helpers in
``tests/_torch_zoo.py``.
"""

import json
import logging

import numpy as np
import pytest

from pytorch_cifar_tpu.models.vgg import VGG as JaxVGG
from pytorch_cifar_tpu.serve.engine import InferenceEngine as JaxEngine
from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch.models.vgg import VGG
from pytorch_cifar_tpu_torch.serve import InferenceEngine
from pytorch_cifar_tpu_torch.serve.__main__ import main as serve_main
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from _torch_ckpt import jax_state
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (
    check_engine_under_load,
    check_serve_cli,
    check_step_f64,
    images,
    step_f64_vs_jax,
)

# five pools to a 1x1 map as in every registered plan, at narrow widths
NARROW = (8, "M", 16, 16, "M", 24, "M", 32, "M", 32, "M")


def test_train_step_matches_jax_float64():
    port, want = step_f64_vs_jax("VGG11", JaxVGG(NARROW), VGG(NARROW), n=4)
    check_step_f64(port, want, 4)


def test_cli_trains_vgg_on_the_cpu(caplog, tmp_path):
    caplog.set_level(logging.INFO)
    out = train_main([
        "--device", "cpu", "--model", "VGG11", "--synthetic_data",
        "--synthetic_train_size", "32", "--synthetic_test_size", "16",
        "--batch_size", "16", "--eval_batch_size", "16", "--epochs", "1",
        "--no-amp", "--output_dir", str(tmp_path),
    ])
    (h,) = out["history"]
    assert h["train"]["count"] == 32 and h["train"]["nonfinite"] == 0
    assert "==> model VGG11" in caplog.text


@pytest.mark.parametrize("name", ["VGG11"])
def test_engine_serves_the_zoo_models_under_load(name):
    check_engine_under_load(name)


@pytest.mark.parametrize("name", ["VGG13"])
def test_serve_cli_runs_the_zoo_models_on_the_cpu(name, capsys):
    check_serve_cli(name, capsys)


def test_serve_cli_serves_a_jax_written_checkpoint(tmp_path, capsys):
    """The JAX package's ``save_checkpoint`` of a VGG11 state; the port's
    engine on it matches the JAX engine in fp32 (rtol 1e-4, atol 1e-5),
    and ``serve --ckpt`` serves it."""
    out = str(tmp_path / "ckpt")
    jax_ckpt.save_checkpoint(out, jax_state("VGG11", seed=4), 3, 55.0)
    x, _ = images(3, seed=6)
    import jax.numpy as jnp
    import torch

    got = InferenceEngine.from_checkpoint(
        out, "VGG11", buckets=(4,), compute_dtype=torch.float32,
        device="cpu").predict(x)
    want = JaxEngine.from_checkpoint(out, "VGG11", buckets=(4,),
                                     compute_dtype=jnp.float32).predict(x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    rc = serve_main(["--device", "cpu", "--model", "VGG11", "--ckpt", out,
                     "--dtype", "float32", "--buckets", "1", "4",
                     "--clients", "2", "--requests", "2"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ckpt_epoch"] == 3 and line["failed"] == 0
    assert line["model"] == "VGG11"
