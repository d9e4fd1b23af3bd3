"""The serving CLI's model flags (``--num_classes``, ``--mean``, ``--std``)
and its cold-start cache flag (``--aot_cache``) against the JAX package's
``serve.py``.

The engine the port's flags build (``serve.__main__.build_engine``) serves a
JAX-written checkpoint of a 100-class model with other normalization
constants within rtol 1e-4 in fp32 of the JAX engine built with the same
arguments and no cache. The JSON line carries ``serve.py``'s cache keys
(read from its source), and a second run on the same ``--aot_cache`` warms
every bucket from it.
"""

import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_cifar_tpu.serve import InferenceEngine as JaxEngine
from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch.obs import MetricsRegistry
from pytorch_cifar_tpu_torch.serve.__main__ import (
    build_engine,
    main as serve_main,
    parse_args,
)
from _torch_ckpt import jax_state
from _torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--dtype", "float32", "--buckets", "1", "4"]
MEAN, STD = (0.5, 0.45, 0.4), (0.25, 0.2, 0.3)
FLAGS = ["--num_classes", "100", "--mean", *map(str, MEAN),
         "--std", *map(str, STD)]


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


def _jax_main_keys():
    """The literal keys of the JSON line ``serve.py``'s ``main`` prints."""
    with open(os.path.join(REPO, "serve.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "main")
    outs = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)
            and getattr(n.targets[0], "id", None) == "out"]
    return {k.value for o in outs for k in o.value.keys if k is not None}


def _run(capsys, *argv):
    assert serve_main([*CPU, *argv]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def ckpt100(tmp_path_factory):
    d = tmp_path_factory.mktemp("c100") / "ckpt"
    jax_ckpt.save_checkpoint(str(d), jax_state("LeNet", 4, num_classes=100),
                             epoch=2, best_acc=20.0)
    return str(d)


def test_parse_args_takes_serve_configs_model_flags():
    args = parse_args(["--model", "LeNet", *FLAGS, "--aot_cache", "c"])
    assert args.num_classes == 100 and args.aot_cache == "c"
    assert tuple(args.mean) == MEAN and tuple(args.std) == STD
    d = parse_args([])
    assert (d.num_classes, d.aot_cache) == (10, "")
    assert tuple(d.mean) == (0.4914, 0.4822, 0.4465)
    assert tuple(d.std) == (0.2023, 0.1994, 0.2010)


@pytest.mark.parametrize("cache", [False, True])
def test_flags_engine_matches_the_jax_engine(tmp_path, ckpt100, cache):
    """``--num_classes 100 --mean ... --std ...`` (on a cold and then a
    warm cache too) within rtol 1e-4 of the JAX engine built with the same
    arguments and ``aot_cache_dir=None``."""
    argv = ["--model", "LeNet", "--ckpt", ckpt100, *CPU, *FLAGS]
    if cache:
        argv += ["--aot_cache", str(tmp_path / "aot")]
    args = parse_args(argv)
    engines = [build_engine(args, MetricsRegistry(), "cpu")
               for _ in range(2 if cache else 1)]
    if cache:
        assert engines[-1].aot_cache_hits == 2
    jeng = JaxEngine.from_checkpoint(
        ckpt100, "LeNet", num_classes=100, buckets=(1, 4),
        compute_dtype=jnp.float32, mean=MEAN, std=STD, aot_cache_dir=None)
    x = _images(7, seed=3)
    want = jeng.predict(x)
    assert want.shape == (7, 100)
    for eng in engines:
        np.testing.assert_allclose(eng.predict(x), want, rtol=1e-4,
                                   atol=1e-5)
    # the constants are the engine's own: CIFAR-10's would differ
    cifar = build_engine(parse_args(["--model", "LeNet", "--ckpt", ckpt100,
                                     *CPU, "--num_classes", "100"]),
                         MetricsRegistry(), "cpu")
    assert np.abs(cifar.predict(x) - want).max() > 1e-3


def test_cli_line_carries_the_cache_keys_and_a_warm_run_hits(
        capsys, tmp_path, ckpt100):
    argv = ["--model", "LeNet", "--ckpt", ckpt100, *FLAGS,
            "--aot_cache", str(tmp_path / "aot"), "--clients", "2",
            "--requests", "2", "--request_images_max", "3"]
    cold = _run(capsys, *argv)
    missing = _jax_main_keys() - set(cold)
    # serve.py's keys but those of its cross-host mesh (one process here)
    assert missing <= {"ckpt", "mesh_procs", "mesh"}, missing
    assert (cold["compiles"], cold["aot_cache_hits"],
            cold["aot_cache_misses"]) == (2, 0, 2)
    warm = _run(capsys, *argv)
    assert (warm["compiles"], warm["aot_cache_hits"],
            warm["aot_cache_misses"]) == (0, 2, 0)
    assert warm["failed"] == 0 and warm["ckpt_epoch"] == 2


def test_cli_zoo_takes_num_classes_and_the_cache(capsys, tmp_path, ckpt100):
    """Zoo mode: every tenant at ``--num_classes``, one shared cache; a
    second run's tenants warm from it."""
    root = os.path.dirname(ckpt100)
    os.replace(ckpt100, os.path.join(root, "LeNet"))
    try:
        argv = ["--models", "LeNet", "--ckpt", root, "--num_classes", "100",
                "--aot_cache", str(tmp_path / "aot"), "--clients", "2",
                "--requests", "2"]
        cold = _run(capsys, *argv)
        warm = _run(capsys, *argv)
    finally:
        os.replace(os.path.join(root, "LeNet"), ckpt100)
    assert cold["tenants"]["LeNet"]["compiles"] == 2
    assert warm["tenants"]["LeNet"]["compiles"] == 0
    assert warm["tenants"]["LeNet"]["aot_cache_hits"] == 2
    assert warm["failed"] == 0
