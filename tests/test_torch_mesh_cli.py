"""Serving over a device group through the port's CLIs, on the CPU.

- The serving CLI refuses ``--mesh_procs`` without ``--mesh_coord`` and
  beside ``--models``, as ``serve.py`` does.
- Two ranks of the serving CLI (``--mesh_procs 2``): the leader serves and
  verifies, the follower prints ``serve.py``'s follower record (its keys,
  read from ``serve.py`` by ``ast``, plus its kernel launches and
  forwards).
- ``router_run --replicas 2 --mesh_procs 2`` on a cold-start cache: the
  record has the JAX launcher's keys, each replica's topology, every
  rank's exit code; the leaders and the router answer bit for bit alike;
  replica 1 joins at ``compiles == 0`` on both ranks.
- The drill's ``--mode mesh`` at the JAX test's sizes
  (``tests/test_chaos.py:173``).
"""

import ast
import json
import os
import re
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

from _torch_chaos import run_chaos
from _torch_fleet import reap_replicas
from _torch_lifecycle import REPO, Child, save
from _torch_threads import THREADS, torch_threads  # noqa: F401
from pytorch_cifar_tpu_torch.serve import HttpTarget
from pytorch_cifar_tpu_torch.serve import __main__ as serve_cli

LENET = ["--model", "LeNet", "--device", "cpu", "--dtype", "float32",
         "--buckets", "1", "4"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_dict_keys(path: str, func: str, holder=None) -> set:
    """The constant keys of the first dict literal in ``func`` of the JAX
    ``path`` that is printed (``json.dumps({...})``) or, with ``holder``,
    assigned to that name."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if holder is None and isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "dumps" and isinstance(
                node.args[0], ast.Dict):
            return {k.value for k in node.args[0].keys}
        if (holder is not None and isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == holder):
            return {k.value for k in node.value.keys if k is not None}
    raise AssertionError(f"no dict literal in {path}:{func}")


@pytest.mark.parametrize("argv, message", [
    (["--mesh_procs", "2"], "needs --mesh_coord"),
    (["--mesh_procs", "2", "--mesh_coord", "127.0.0.1:1", "--models",
      "LeNet,ResNet18"], "mutually exclusive"),
])
def test_cli_refuses_a_mesh_without_a_coordinator_or_beside_a_zoo(
        argv, message):
    with pytest.raises(SystemExit) as e:
        serve_cli.main(["--device", "cpu", *argv])
    assert message in str(e.value.code)


def _rank(rank, port, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_cifar_tpu_torch.serve", *LENET,
         "--clients", "2", "--requests", "3", "--request_images_max", "4",
         "--verify",
         "--mesh_procs", "2", "--mesh_rank", str(rank),
         "--mesh_coord", f"127.0.0.1:{port}", "--mesh_timeout_s", "30",
         *extra],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": str(THREADS)})


def test_two_ranks_serve_and_the_follower_prints_its_record():
    port = _free_port()
    procs = [_rank(r, port) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append((json.loads(out.strip().splitlines()[-1]), err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    (lead, lead_err), (follow, follow_err) = outs
    assert "==> verify: bucket-padded forward bit-identical" in lead_err
    assert "==> mesh: follower 1/2 ready (barrier generation 1)" in follow_err
    assert (lead["n_devices"], lead["mesh_procs"]) == (2, 2)
    assert lead["buckets"] == [2, 4] and lead["failed"] == 0
    assert lead["mesh"]["process_count"] == 2
    assert lead["mesh"]["barrier_generation"] == 1
    want = _jax_dict_keys("serve.py", "_mesh_follower")
    assert set(follow) == want | {"forwards", "kernel_launches",
                                  "launches_by_kernel"}
    assert follow["role"] == "mesh_follower"
    assert (follow["process_index"], follow["process_count"]) == (1, 2)
    assert follow["engine_version"] == lead["engine_version"] == 1
    assert follow["compiles"] == lead["compiles"] == 2
    # warm-ups, barrier probes, the verify batch and every served batch;
    # the leader adds --verify's direct forward
    assert follow["forwards"] == 2 + 2 + 1 + lead["batches"]
    assert lead["forwards"] == follow["forwards"] + 1


def test_router_run_mesh_procs_two_replicas_answer_alike(tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    save(ckpt_dir, seed=0, epoch=1, best_acc=0.5)
    child = Child(["pytorch_cifar_tpu_torch.tools.router_run",
                   "--ckpt", str(ckpt_dir), "--replicas", "2",
                   "--mesh_procs", "2", "--mesh_timeout_s", "20",
                   "--aot_cache", str(tmp_path / "aot"), "--model", "LeNet",
                   "--device", "cpu", "--buckets", "1", "4",
                   "--probe_s", "0.2"],
                  ready="==> router: serving on ")
    try:
        assert child.ready.wait(90), "".join(child.err[-30:])
        urls = [re.search(r"url=(\S+)", ln).group(1) for ln in child.err
                if re.match(r"==> replica \d+ pid=", ln)]
        assert len(urls) == 2
        assert len([ln for ln in child.err if re.match(
            r"==> replica \d+ follower rank=1 pid=", ln)]) == 2
        targets = [HttpTarget(u, wire=w) for u in [child.url] + urls
                   for w in ("binary", "json")]
        try:
            for i in range(6):
                x = np.random.RandomState(i).randint(
                    0, 256, size=(1 + i, 32, 32, 3)).astype(np.uint8)
                got = [t.submit(x).result(timeout=30) for t in targets]
                assert all(g.tobytes() == got[0].tobytes() for g in got[1:])
        finally:
            for t in targets:
                t.close()
        child.proc.send_signal(signal.SIGTERM)
        code, lines = child.finish(timeout=90)
    finally:
        left = reap_replicas(ckpt_dir)
        if child.proc.poll() is None:
            child.proc.kill()
            child.proc.wait(timeout=30)
    assert code == 0, "".join(child.err[-30:])
    assert left == set()
    rec = json.loads(lines[-1])
    assert set(rec) == _jax_dict_keys("tools/router_run.py", "main",
                                      holder="record")
    assert rec["mesh_procs"] == 2
    assert rec["replica_rcs"] == [0, 0] and rec["follower_rcs"] == [[0], [0]]
    assert rec["replica_compiles"] == [2, 0]
    assert rec["replica_aot_hits"] == [0, 2]
    assert [m["process_count"] for m in rec["replica_mesh"]] == [2, 2]
    followers = {int(m.group(1)): json.loads(m.group(2)) for m in (
        re.match(r"\[replica (\d+):r1\] (\{.*\})$", ln.strip())
        for ln in child.err) if m}
    assert sorted(followers) == [0, 1]
    assert [followers[i]["compiles"] for i in (0, 1)] == [2, 0]
    assert all(f["role"] == "mesh_follower" for f in followers.values())


def test_mesh_drill_follower_sigkill_bounded_detection(tmp_path):
    """JAX ``test_mesh_drill_follower_sigkill_bounded_detection``."""
    rec = run_chaos("mesh", tmp_path, extra=("--epochs", "2"))
    assert rec["match"] is True
    assert rec["bit_identical"] is True
    assert rec["warm_replica_compiles"] == 0
    assert rec["mesh_health"]["process_count"] == 2
    assert rec["mesh_health"]["barrier_generation"] == 1
    assert rec["failed"] == 0 and rec["requests"] > 0
    assert 0 < rec["detection_s"] <= rec["mesh_timeout_s"] + 10.0
    assert rec["leader_rc"] == 70
    assert rec["follower_rcs"][0][0] == -9
    assert rec["follower_rcs"][1][0] == 0
    assert rec["evictions"] >= 1 and rec["healthy_after"] == 1
    assert rec["router_rc"] == 0
