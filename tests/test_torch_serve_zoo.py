"""The serving CLI's zoo mode and a zoo behind the HTTP frontends, on the
CPU.

``python -m pytorch_cifar_tpu_torch.serve --models A,B --max_resident 1
[--int8]`` (run in process) prints ONE JSON line whose keys include the
JAX ``serve.py`` zoo line's (read from its source) and the load report's;
a tenant without ``=dir`` serves ``<--ckpt>/<Name>`` where that exists (a
JAX-written checkpoint here). ``--int8`` serves the int8 lane in both
modes. Behind the threaded frontend and the event edge, a wire-v2 frame
(and a JSON body) naming each tenant gets that tenant's bits, a request
naming no model the default tenant's, and an unknown model a 404;
``/healthz`` lists the models (what the router's model filter reads).
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch.serve import (
    EdgeFrontend,
    HttpTarget,
    InferenceEngine,
    ModelZooServer,
    ServingFrontend,
    TenantSpec,
    UnknownModel,
)
from pytorch_cifar_tpu_torch.serve.__main__ import main as serve_main
from _torch_ckpt import jax_state
from _torch_threads import torch_threads  # noqa: F401
from _torch_wire import get, images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("LeNet", "MobileNet")
CPU = ["--device", "cpu", "--dtype", "float32", "--buckets", "1", "4"]


def _jax_zoo_keys():
    """The literal keys of the JSON line ``serve.py``'s ``_main_zoo``
    prints."""
    with open(os.path.join(REPO, "serve.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "_main_zoo")
    out = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "out")
    return {k.value for k in out.value.keys if k is not None}


def _run(capsys, *argv):
    assert serve_main([*CPU, *argv]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_root")
    jax_ckpt.save_checkpoint(str(root / "LeNet"), jax_state("LeNet", 0),
                             epoch=3, best_acc=10.0)
    return str(root)


def test_cli_zoo_line_has_the_jax_zoo_keys(capsys, ckpt_root):
    rec = _run(capsys, "--models", ",".join(MODELS), "--ckpt", ckpt_root,
               "--clients", "2", "--requests", "3",
               "--request_images_max", "3")
    missing = _jax_zoo_keys() - set(rec)
    assert not missing, missing
    assert rec["model"] == "zoo" and rec["models"] == sorted(MODELS)
    assert rec["default_model"] == MODELS[0]
    assert rec["resident"] == sorted(MODELS) and rec["max_resident"] == 2
    assert rec["failed"] == 0 and rec["requests"] == 6
    assert sum(rec["per_model"].values()) == 6
    assert rec["int8"] is False and rec["platform"] == "cpu"
    for key in ("img_per_sec", "p50_ms", "p99_ms", "kernel_launches",
                "launches_by_kernel"):
        assert key in rec, key
    # <--ckpt>/LeNet exists: served from it; MobileNet from seeded weights
    assert rec["tenants"]["LeNet"]["ckpt_epoch"] == 3
    assert rec["tenants"]["MobileNet"]["ckpt_epoch"] is None
    assert rec["zoo"]["admissions"] == 2
    assert rec["admission_ms_p50"] > 0


def test_cli_zoo_int8_one_resident(capsys, ckpt_root):
    rec = _run(capsys, "--models", "LeNet,MobileNet", "--ckpt", ckpt_root,
               "--max_resident", "1", "--int8", "--clients", "2",
               "--requests", "4", "--request_images_max", "2")
    assert rec["int8"] is True and rec["max_resident"] == 1
    assert len(rec["resident"]) == 1
    assert rec["failed"] == 0 and rec["requests"] == 8
    assert rec["zoo"]["admissions"] >= 1


def test_cli_single_model_int8(capsys):
    rec = _run(capsys, "--model", "LeNet", "--int8", "--clients", "2",
               "--requests", "2")
    assert rec["int8"] is True and rec["model"] == "LeNet"
    assert rec["failed"] == 0 and rec["compiles"] == 2


@pytest.mark.parametrize("edge", [ServingFrontend, EdgeFrontend],
                         ids=["threaded", "event"])
def test_zoo_behind_the_frontend_routes_by_model(edge):
    specs = [TenantSpec(m, buckets=(1, 4), seed=i)
             for i, m in enumerate(MODELS)]
    with ModelZooServer(specs, compute_dtype=torch.float32,
                        device="cpu") as zoo:
        front = edge(zoo, port=0, registry=zoo.obs).start()
        try:
            x = images(3, seed=4)
            for wire in ("binary", "json"):
                target = HttpTarget(front.url, wire=wire)
                try:
                    for i, m in enumerate(MODELS):
                        got = target.submit(x, model=m).result()
                        want = InferenceEngine.from_random(
                            m, seed=i, buckets=(1, 4),
                            compute_dtype=torch.float32,
                            device="cpu").predict(x)
                        assert np.array_equal(got, want), (wire, m)
                    assert np.array_equal(target.submit(x).result(),
                                          zoo.predict(x, model=MODELS[0]))
                    with pytest.raises(UnknownModel):
                        target.submit(x, model="NoSuchNet")
                finally:
                    target.close()
            status, body = get(front.url, "/healthz")
            assert status == 200
            health = json.loads(body)
            assert health["models"] == sorted(MODELS)
            assert health["role"] == "zoo"
            assert zoo.stats["unknown_model"] == 2
        finally:
            front.stop()
