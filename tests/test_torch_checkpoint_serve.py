"""Serving from a checkpoint: the port's ``InferenceEngine.from_checkpoint``
against the JAX package's on the same files, in fp32 on the CPU (rtol
1e-4, atol 1e-5, the bound ``tests/test_torch_serve.py`` holds fp32 logits
to).

- A trainer's directory written by the port (the best checkpoint first),
  and the ``.msgpack`` file itself; the engine's ``checkpoint_meta`` is the
  JAX engine's.
- A reference-format ``ckpt.pth`` (``{'net', 'acc', 'epoch'}`` with
  ``module.`` prefixes) written with ``torch.save``.
- A corrupt payload raises ``CheckpointCorrupt``, never a fresh model; an
  empty directory raises FileNotFoundError.
- The serving CLI's ``--ckpt`` prints ``ckpt_epoch``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu import faults
from pytorch_cifar_tpu.serve.engine import InferenceEngine as JaxEngine
from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch.serve import InferenceEngine
from pytorch_cifar_tpu_torch.serve.__main__ import main as serve_main
from pytorch_cifar_tpu_torch.train import checkpoint as ckpt
from _torch_ckpt import jax_state, port_state, random_port_state
from _torch_threads import torch_threads  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


def _port_written(tmp_path, name, seed=1, epoch=4):
    """A port checkpoint of fan-in-scaled weights (the JAX draw, restored
    into the port and saved by it)."""
    src, out = str(tmp_path / "src"), str(tmp_path / "ckpt")
    jax_ckpt.save_checkpoint(src, jax_state(name, seed=seed), epoch, 61.5)
    ps = port_state(name)
    ckpt.restore_checkpoint(src, ps)
    ckpt.save_checkpoint(out, ps, epoch, 61.5)
    return out, ps


def _engines(path, name):
    port = InferenceEngine.from_checkpoint(
        path, name, buckets=(4,), compute_dtype=torch.float32, device="cpu")
    ref = JaxEngine.from_checkpoint(path, name, buckets=(4,),
                                    compute_dtype=jnp.float32)
    return port, ref


@pytest.mark.parametrize("name", ["LeNet", "MobileNet", "ResNet18"])
def test_from_checkpoint_matches_the_jax_engine(tmp_path, name):
    out, _ = _port_written(tmp_path, name)
    x = _images(3, seed=2)
    for path in (out, os.path.join(out, ckpt.CKPT_NAME)):
        port, ref = _engines(path, name)
        got, want = port.predict(x), ref.predict(x)
        assert got.dtype == np.float32 and got.shape == (3, 10)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert port.checkpoint_meta == ref.checkpoint_meta
        assert port.checkpoint_meta["epoch"] == 4


def test_reference_pth_matches_the_jax_engine(tmp_path):
    ps = random_port_state("ResNet18", seed=3)
    with torch.no_grad():  # fan-in-scaled, so the logits stay O(1)
        for k, p in ps.model.named_parameters():
            if p.dim() > 1:
                p.mul_(1.0 / np.sqrt(p[0].numel()) / 0.1)
    sd = {f"module.{k}": v.contiguous()
          for k, v in ps.model.state_dict().items()}
    path = str(tmp_path / "ckpt.pth")
    torch.save({"net": sd, "acc": 71.5, "epoch": 9}, path)
    port, ref = _engines(path, "ResNet18")
    x = _images(3, seed=4)
    np.testing.assert_allclose(port.predict(x), ref.predict(x), rtol=RTOL,
                               atol=ATOL)
    assert port.checkpoint_meta == ref.checkpoint_meta == {
        "acc": 71.5, "epoch": 9}


def test_directory_serves_the_best_not_the_newest(tmp_path):
    out, _ = _port_written(tmp_path, "MobileNet")
    ckpt.save_checkpoint(out, random_port_state("MobileNet", seed=8), 9, 10.0,
                         name=ckpt.LAST_NAME)
    x = _images(2)
    from_dir = InferenceEngine.from_checkpoint(
        out, "MobileNet", buckets=(2,), compute_dtype=torch.float32,
        device="cpu")
    from_best = InferenceEngine.from_checkpoint(
        os.path.join(out, ckpt.CKPT_NAME), "MobileNet", buckets=(2,),
        compute_dtype=torch.float32, device="cpu")
    assert np.array_equal(from_dir.predict(x), from_best.predict(x))
    assert from_dir.checkpoint_meta["epoch"] == 4


def test_corrupt_or_missing_checkpoint_raises(tmp_path):
    out, _ = _port_written(tmp_path, "MobileNet")
    faults.bitflip_file(os.path.join(out, ckpt.CKPT_NAME))
    with pytest.raises(ckpt.CheckpointCorrupt):
        InferenceEngine.from_checkpoint(out, "MobileNet", device="cpu")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        InferenceEngine.from_checkpoint(str(tmp_path / "empty"), "MobileNet",
                                        device="cpu")


def test_serve_cli_loads_a_checkpoint(tmp_path, capsys):
    out, _ = _port_written(tmp_path, "LeNet", epoch=6)
    rc = serve_main(["--device", "cpu", "--model", "LeNet", "--ckpt", out,
                     "--dtype", "float32", "--buckets", "1", "4",
                     "--clients", "2", "--requests", "2"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ckpt_epoch"] == 6 and line["failed"] == 0
