"""The port stands alone: no JAX, and nothing of the JAX package.

An AST scan of every file of ``pytorch_cifar_tpu_torch/`` and of
``chip_smoke.py`` finds no import of ``jax``, ``jaxlib``, ``flax``,
``optax``, ``msgpack`` (the card has none of them: the port writes the
checkpoint codec itself) or ``pytorch_cifar_tpu`` (as opposed to
``pytorch_cifar_tpu_torch``); a fresh interpreter imports every module of
the package and leaves all of them out of ``sys.modules``.
"""

import ast
import os
import subprocess
import sys

import pytest
from _torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "pytorch_cifar_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack",
             "pytorch_cifar_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PACKAGE):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(os.path.relpath(f, REPO) for f in files)


def _port_modules():
    mods = []
    for rel in _port_files():
        if rel == "chip_smoke.py" or rel.endswith("__main__.py"):
            continue
        mod = rel[: -len(".py")].replace(os.sep, ".")
        mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__")
                    else mod)
    return mods


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", None))
            in ("__import__", "import_module")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.args[0].value


@pytest.mark.parametrize("rel", _port_files())
def test_no_jax_import(rel):
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read(), filename=rel)
    bad = [
        m for m in _imported_modules(tree)
        if m and any(m == f or m.startswith(f + ".") for f in FORBIDDEN)
    ]
    assert not bad, f"{rel} imports {bad}"


def test_scan_sees_the_whole_package():
    files = _port_files()
    for must in ("chip_smoke.py",
                 os.path.join("pytorch_cifar_tpu_torch", "serve", "engine.py"),
                 os.path.join("pytorch_cifar_tpu_torch", "ops",
                              "conv_bn_relu.py"),
                 os.path.join("pytorch_cifar_tpu_torch", "ops",
                              "dma_gather.py"),
                 os.path.join("pytorch_cifar_tpu_torch", "ops",
                              "bn_stats.py"),
                 os.path.join("pytorch_cifar_tpu_torch", "train",
                              "trainer.py"),
                 *(os.path.join("pytorch_cifar_tpu_torch", *parts) for parts in
                   (("ops", "max_pool.py"), ("ops", "depthwise_stencil.py"),
                    ("models", "googlenet.py"), ("models", "mobilenet.py"),
                    ("models", "dla_simple.py"), ("models", "dla.py"),
                    ("models", "mobilenetv2.py"),
                    ("models", "efficientnet.py"),
                    ("models", "shufflenetv2.py"), ("models", "pnasnet.py"),
                    ("tools", "pool_bench.py"),
                    ("tools", "depthwise_bench.py"))),
                 os.path.join("pytorch_cifar_tpu_torch", "config.py"),
                 os.path.join("pytorch_cifar_tpu_torch", "serialization.py"),
                 os.path.join("pytorch_cifar_tpu_torch", "train",
                              "checkpoint.py"),
                 os.path.join("pytorch_cifar_tpu_torch", "train",
                              "launch.py"),
                 os.path.join("pytorch_cifar_tpu_torch", "parallel",
                              "mesh.py"),
                 os.path.join("pytorch_cifar_tpu_torch", "parallel",
                              "dp.py"),
                 *(os.path.join("pytorch_cifar_tpu_torch", *parts) for parts in
                   (("faults.py",), ("native", "__init__.py"),
                    ("data", "pipeline.py"), ("obs", "export.py"),
                    ("utils", "logging.py"), ("utils", "progress.py")))):
        assert must in files


def test_importing_the_package_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
