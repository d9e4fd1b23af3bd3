"""PyTorch/CUDA port of ``pytorch_cifar_tpu``: training and serving the
CIFAR-10 zoo (so far LeNet, ResNet, GoogLeNet, MobileNet, SimpleDLA) on an
NVIDIA H100, with checkpoints in the JAX package's format.

The JAX package beside this one is the reference; this package mirrors its
layout and names (``models/``, ``ops/``, ``serve/``, ...) so each module has
an obvious counterpart, and imports nothing of it. Every TPU kernel on a
ported path is a hand-written Hopper kernel under ``ops/csrc/``, built at
first use — importing the package touches no GPU and builds nothing.

Entry points run on CUDA. A caller that wants the CPU (the tests) says so
with ``device="cpu"``; nothing falls back on its own.
"""

from __future__ import annotations


def resolve_device(device=None) -> "torch.device":
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    absent — a silent CPU fallback would report CPU numbers as the card's.
    (``torch`` is imported here, not with the package: the fleet
    launchers import the package and never touch a device.)"""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) to "
            "run the port on the CPU"
        )
    return dev
