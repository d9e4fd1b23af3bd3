"""The port's fleet launchers as child processes on the CPU (LeNet, fp32):
``python -m pytorch_cifar_tpu_torch.tools.router_run`` (two replicas of
the port's serving CLI behind a router) and ``...tools.fleet_run`` (an
elastic fleet, min 1 / max 2, under its built-in load).

Each launcher's JSON record must carry exactly the keys of the JAX
package's launcher: those of its ``record`` literal, read from
``tools/<name>.py`` by ``ast`` (the JAX launcher spawns ``serve.py``, the
JAX program, so it is read, not run), plus the load report's keys, which
the JAX package's ``run_load`` gives here on a stub target. Every test
reaps every replica of its run from ``/proc`` in a ``finally``
(``_torch_fleet.reap_replicas``) and fails if one was left.
"""

import ast
import concurrent.futures
import json
import os
import re
import signal

import numpy as np

from _torch_fleet import reap_replicas, replica_pids
from _torch_lifecycle import REPO, Child, save
from _torch_threads import torch_threads  # noqa: F401
from _torch_wire import images
from pytorch_cifar_tpu.serve.loadgen import run_load as jax_run_load
from pytorch_cifar_tpu_torch.serve import HttpTarget

LENET = ["--model", "LeNet", "--device", "cpu", "--buckets", "1", "4",
         "--probe_s", "0.2"]


def jax_record_keys(tool: str, func: str) -> set:
    """The constant keys of the ``record = {...}`` literal in ``func`` of
    the JAX package's ``tools/<tool>.py``, with those of the
    ``_controller_record`` dict it unpacks."""
    with open(os.path.join(REPO, "tools", f"{tool}.py")) as f:
        tree = ast.parse(f.read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def dict_keys(node):
        keys = set()
        for k, v in zip(node.keys, node.values):
            if k is not None:
                keys.add(k.value)
            elif (isinstance(v, ast.Call)
                  and getattr(v.func, "id", "") == "_controller_record"):
                ret = [r for r in ast.walk(funcs["_controller_record"])
                       if isinstance(r, ast.Return)][0]
                keys |= dict_keys(ret.value)
        return keys

    for node in ast.walk(funcs[func]):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "record"):
            return dict_keys(node.value)
    raise AssertionError(f"no record literal in tools/{tool}.py:{func}")


class _Done:
    def submit(self, x, priority="interactive", **kw):
        f = concurrent.futures.Future()
        f.set_result(np.zeros((x.shape[0], 10), np.float32))
        return f


def jax_report_keys() -> set:
    return set(jax_run_load(_Done(), clients=1, requests_per_client=2))


def _record(lines):
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def _replica_records(err):
    """The replicas' own JSON records, forwarded on the launcher's stderr
    under their ``[replica i]`` prefix."""
    out = {}
    for line in err:
        m = re.match(r"\[replica (\d+)\] (\{.*\})$", line.strip())
        if m:
            out[int(m.group(1))] = json.loads(m.group(2))
    return out


def test_router_run_two_replicas_answer_alike(tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    save(ckpt_dir, seed=0, epoch=1, best_acc=0.5)
    child = Child(["pytorch_cifar_tpu_torch.tools.router_run",
                   "--ckpt", str(ckpt_dir), "--replicas", "2", *LENET],
                  ready="==> router: serving on ")
    try:
        assert child.ready.wait(50), "".join(child.err[-30:])
        urls = [re.search(r"url=(\S+)", ln).group(1) for ln in child.err
                if re.match(r"==> replica \d+ pid=", ln)]
        assert len(urls) == 2
        assert len(replica_pids(ckpt_dir)) == 2
        targets = [HttpTarget(u, wire="binary") for u in [child.url] + urls]
        try:
            for i in range(16):  # 16 requests, each to all three
                x = images(1 + i % 5, seed=i)
                got = [t.submit(x).result(timeout=30) for t in targets]
                assert got[0].shape == (x.shape[0], 10)
                assert all(g.tobytes() == got[0].tobytes() for g in got[1:])
        finally:
            for t in targets:
                t.close()
        child.proc.send_signal(signal.SIGTERM)
        code, lines = child.finish(timeout=30)
    finally:
        left = reap_replicas(ckpt_dir)
        if child.proc.poll() is None:
            child.proc.kill()
            child.proc.wait(timeout=30)
    assert code == 0, "".join(child.err[-30:])
    assert left == set()
    rec = _record(lines)
    assert set(rec) == jax_record_keys("router_run", "main")
    assert rec["replica_rcs"] == [0, 0] and rec["replica_compiles"] == [2, 2]
    assert rec["router"]["requests"] == 16
    served = _replica_records(child.err)
    assert sorted(served) == [0, 1]
    assert sum(r["requests"] for r in served.values()) == 16 + 2 * 16
    assert all(r["launches_by_kernel"] == {
        "conv3x3_bn_relu": 0, "max_pool3x3_s1": 0, "depthwise_stencil": 0}
        for r in served.values())  # LeNet has no kernel site


def test_fleet_run_scales_up_and_leaves_no_orphan(tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    save(ckpt_dir, seed=0, epoch=1, best_acc=0.5)
    child = Child(["pytorch_cifar_tpu_torch.tools.fleet_run",
                   "--ckpt", str(ckpt_dir), *LENET,
                   "--min_replicas", "1", "--max_replicas", "2",
                   "--aot_cache", str(tmp_path / "aot"),
                   "--clients", "2", "--images_max", "2",
                   "--requests", "100000", "--duration_s", "4",
                   "--queue_high", "0.5",
                   "--queue_low", "0.1", "--up_after_s", "0.2",
                   "--control_interval_s", "0.1"],
                  ready="==> fleet: serving on ")
    try:
        code, lines = child.finish(timeout=55)
    finally:
        left = reap_replicas(ckpt_dir)
    assert code == 0, "".join(child.err[-30:])
    assert left == set()
    rec = _record(lines)
    assert set(rec) == (jax_record_keys("fleet_run", "main")
                        | jax_report_keys())
    assert rec["role"] == "fleet" and rec["failed"] == 0
    assert rec["scale_ups"] == 1 and rec["replicas_final"] == 2
    assert rec["adoptions"] == 1 and rec["replica_failures"] == 0
    assert set(rec["replica_rcs"].values()) == {0}
    assert rec["requests"] > 0 and rec["spawn_ms_p50"] > 0
    ups = [ln for ln in child.err if "==> fleet: scale-up replica 1 " in ln]
    # the seed filled the cold-start cache: the scale-up imports it
    assert len(ups) == 1 and "compiles=0" in ups[0]
    seed_line = [ln for ln in child.err if "==> fleet: replica 0 " in ln]
    assert len(seed_line) == 1 and "compiles=2 aot_hits=0" in seed_line[0]
    assert sorted(_replica_records(child.err)) == [0, 1]
