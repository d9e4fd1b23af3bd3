"""Both packages' checkpoint life cycle side by side, for the port's
publish, reload, canary and pipeline tests.

A :class:`Pkg` bundles one package's serving names, checkpoint module and
fault helpers, and builds its fp32 engine on the CPU. Checkpoints are
written once with the port's ``save_checkpoint`` (byte for byte the JAX
package's for the same state) from LeNet states drawn from a seed, so both
packages vet and serve the very same files. ``ResNetTiny`` (ResNet with
one BasicBlock a stage, full width) is registered in both registries by
:func:`register_resnet_tiny` for the cases that need a fused
conv3x3+BN+ReLU site.
"""

import os
import shutil
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import torch

from pytorch_cifar_tpu import faults as jax_faults
from pytorch_cifar_tpu import serve as jax_serve
from pytorch_cifar_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from pytorch_cifar_tpu.models.resnet import BasicBlock as JaxBasicBlock
from pytorch_cifar_tpu.models.resnet import ResNet as JaxResNet
from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch import faults, serve
from pytorch_cifar_tpu_torch.models import MODEL_REGISTRY
from pytorch_cifar_tpu_torch.models.resnet import BasicBlock, ResNet
from pytorch_cifar_tpu_torch.train import checkpoint as ckpt
from _torch_ckpt import random_port_state
from _torch_threads import THREADS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the payload path of ResNetTiny's first block's bn1 variance: the BN of
# a fused conv3x3+BN+ReLU site (layer1.0.conv1 + bn1)
K3_SITE_VAR = ("batch_stats", "BasicBlock_0", "BatchNorm_0", "var")


class Pkg:
    def __init__(self, name, serve_mod, ckpt_mod, faults_mod, engine_kw):
        self.name = name
        self.serve = serve_mod
        self.ckpt = ckpt_mod
        self.faults = faults_mod
        self.engine_kw = engine_kw

    def engine(self, ckpt_dir, model="LeNet", buckets=(4, 8)):
        return self.serve.InferenceEngine.from_checkpoint(
            str(ckpt_dir), model, buckets=buckets, **self.engine_kw)

    def __repr__(self):
        return self.name


JAX = Pkg("jax", jax_serve, jax_ckpt, jax_faults,
          {"compute_dtype": jnp.float32})
PORT = Pkg("port", serve, ckpt, faults,
           {"compute_dtype": torch.float32, "device": "cpu"})
PKGS = (JAX, PORT)


def save(out_dir, seed, epoch, best_acc, model="LeNet"):
    """Commit a seeded port state of ``model`` as ``ckpt.msgpack``."""
    ckpt.save_checkpoint(str(out_dir), random_port_state(model, seed),
                         epoch, best_acc)


def images(n, seed):
    return np.random.RandomState(seed).randint(
        0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


def read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def pair_bytes(dirpath, name="ckpt.msgpack") -> tuple:
    """(payload, sidecar) bytes of one checkpoint."""
    return (read_bytes(os.path.join(dirpath, name)),
            read_bytes(ckpt.meta_path(str(dirpath), name)))


def clone_dir(src, dst):
    shutil.copytree(str(src), str(dst))
    return str(dst)


def register_resnet_tiny(monkeypatch):
    """ResNetTiny in both registries for this test."""
    monkeypatch.setitem(
        JAX_REGISTRY, "ResNetTiny",
        lambda num_classes=10, dtype=jnp.float32, **kw: JaxResNet(
            JaxBasicBlock, (1, 1, 1, 1), num_classes=num_classes,
            dtype=dtype))
    monkeypatch.setitem(
        MODEL_REGISTRY, "ResNetTiny",
        lambda num_classes=10: ResNet(BasicBlock, (1, 1, 1, 1), num_classes))


class Child:
    """A CLI of the port in a child process, its stderr read by a thread
    (the child never blocks on a full pipe); ``url`` is set from the first
    stderr line starting with ``ready``. The child and its own children
    (the pipeline's trainer) run torch on two threads, as the test
    processes do (``_torch_threads``), not on every core."""

    def __init__(self, argv, ready):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "OMP_NUM_THREADS": str(THREADS)})
        self.err = []
        self.url = None
        self.ready = threading.Event()
        self._marker = ready
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stderr:
            self.err.append(line)
            if line.startswith(self._marker):
                self.url = line[len(self._marker):].strip()
                self.ready.set()

    def finish(self, timeout):
        """Wait for the exit (killing the child after ``timeout``); returns
        (returncode, stdout lines)."""
        try:
            self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=30)
            self._reader.join(timeout=30)
            self.proc.stderr.close()
        with self.proc.stdout:
            out = self.proc.stdout.read()
        return self.proc.returncode, out.strip().splitlines()
