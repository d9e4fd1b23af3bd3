"""The port's elastic supervisor against the JAX package's
(``pytorch_cifar_tpu/train/elastic.py``), with no rank started.

- ``strip_owned_flags`` returns JAX's result on the same argvs (the
  ``--flag=value`` forms included); ``ELASTIC_RC`` is 75 in both; the
  runner's defaults and its validation are JAX's.
- The per-generation argv is JAX's: ``--resume`` from generation 1 (or 0
  under ``resume_first``), ``--distributed --elastic --dist_coord
  127.0.0.1:<port> --dist_procs N --dist_rank r`` above world 1,
  ``--elastic`` alone at world 1; only the program differs (``python -m
  pytorch_cifar_tpu_torch.train`` for ``train.py``).
- Over the same sequences of rank exit codes and membership events both
  runners end every generation alike, shrink and grow the world alike,
  and return records with the same keys and values.
- ``--elastic_procs`` in a fresh interpreter supervises without loading
  torch, and exits 0 or 1 by ``completed``.
"""

import json
import subprocess
import sys

import pytest

from pytorch_cifar_tpu.train import elastic as jax_elastic
from pytorch_cifar_tpu_torch.train import elastic

ARGVS = [
    ["--model", "LeNet", "--elastic_procs", "2",
     "--dist_coord", "localhost:1234", "--dist_procs", "2",
     "--dist_rank=1", "--distributed", "--elastic", "--resume",
     "--epochs", "3"],
    ["--elastic_procs=4", "--dist_coord=h:1", "--dist_procs=4",
     "--dist_rank", "3", "--no-distributed", "--no-resume", "--no-elastic",
     "--batch_size", "512"],
    ["--device", "cpu", "--epochs", "6", "--output_dir", "ckpt"],
    ["--dist_rank"],
    [],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_strip_owned_flags_is_jaxs(argv):
    assert elastic.strip_owned_flags(argv) == \
        jax_elastic.strip_owned_flags(argv)


def test_the_first_argv_keeps_model_and_epochs():
    assert elastic.strip_owned_flags(ARGVS[0]) == [
        "--model", "LeNet", "--epochs", "3"]


def test_rank_contract_code_and_runner_defaults():
    assert elastic.ELASTIC_RC == jax_elastic.ELASTIC_RC == 75
    assert elastic._OWNED_FLAGS == jax_elastic._OWNED_FLAGS
    ours = elastic.ElasticTrainRunner(["--epochs", "1"], 2,
                                      resume_first=True, cwd=".")
    theirs = jax_elastic.ElasticTrainRunner(["--epochs", "1"], 2,
                                            resume_first=True, cwd=".")
    for key in ("base_argv", "resume_first", "world", "min_procs",
                "max_restarts", "grace_s", "poll_s", "generations"):
        assert getattr(ours, key) == getattr(theirs, key), key
    assert elastic.ElasticTrainRunner([], 1, min_procs=0).min_procs == 1
    for mod in (elastic, jax_elastic):
        with pytest.raises(ValueError):
            mod.ElasticTrainRunner(["--epochs", "1"], 0)


class _Proc:
    def __init__(self, pid, rc):
        self.pid, self.returncode = pid, rc

    def poll(self):
        return self.returncode

    def send_signal(self, signum):
        raise AssertionError("a rank that has exited gets no signal")


def _fake_ranks(script, spawned):
    """A ``_Rank`` stand-in: generation g's rank r exits at once with
    ``script[g][r]`` (0 past the script); rank 0 of a clean exit prints
    the best accuracy. ``spawned`` collects every command."""

    class FakeRank:
        def __init__(self, rank, cmd, env, cwd):
            gen = sum(1 for r, _ in spawned if r == 0) - (rank != 0)
            spawned.append((rank, cmd))
            rcs = script[gen] if gen < len(script) else []
            rc = rcs[rank] if rank < len(rcs) else 0
            self.rank = rank
            self.proc = _Proc(1000 + len(spawned), rc)
            self.stdout_tail = (["best test accuracy: 12.50%"]
                                if rank == 0 and rc == 0 else [])

        def alive(self):
            return False

        def reap(self, timeout_s):
            return self.proc.returncode

    return FakeRank


def _run(mod, monkeypatch, script, procs, grow=False, **kw):
    spawned = []
    monkeypatch.setattr(mod, "_Rank", _fake_ranks(script, spawned))
    monkeypatch.setattr(mod, "_free_port", lambda: 4321)
    runner = mod.ElasticTrainRunner(["--epochs", "3"], procs, poll_s=0.001,
                                    cwd="/repo", **kw)
    if grow:
        runner.add_host()
    return runner.run(timeout_s=60), spawned


SCRIPTS = {
    "clean": ([[0, 0]], 2, {}),
    "rank1_preempted": ([[75, -9], [0]], 2, {}),
    "rank0_preempted": ([[-9, 75, 75], [0, 0]], 3, {}),
    "two_of_four": ([[-9, 75, -6, 75], [0, 0]], 4, {}),
    "elastic_only": ([[75, 75], [75], [0]], 2, {}),
    "sigterm_survivors": ([[-15, 1], [0]], 2, {}),
    "floored": ([[-9, -9, -9], [75, 0], [0]], 3, {"min_procs": 2}),
    "budget": ([[1, 1]] * 9, 2, {"max_restarts": 3}),
    "grow": ([[0], [0, 0]], 1, {"grow": True}),
    "grow_then_preempted": ([[0, 0], [0, -9, 0], [0, 0]], 2, {"grow": True}),
    "resume_first": ([[0]], 1, {"resume_first": True}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_world_arithmetic_and_record_are_jaxs(monkeypatch, name):
    script, procs, kw = SCRIPTS[name]
    ours, ours_cmds = _run(elastic, monkeypatch, script, procs, **kw)
    theirs, theirs_cmds = _run(jax_elastic, monkeypatch, script, procs, **kw)
    assert list(ours) == list(theirs)
    assert ours == theirs
    # each generation's commands: JAX's argv after the program
    assert len(ours_cmds) == len(theirs_cmds)
    for (r, mine), (r2, jax_cmd) in zip(ours_cmds, theirs_cmds):
        assert r == r2
        assert mine[:3] == [sys.executable, "-m",
                            "pytorch_cifar_tpu_torch.train"]
        assert jax_cmd[1].endswith("train.py")
        assert mine[3:] == jax_cmd[2:]


def test_per_generation_argv(monkeypatch):
    _, cmds = _run(elastic, monkeypatch, [[75, -9], [-9], [0]], 2)
    argvs = [(r, cmd[3:]) for r, cmd in cmds]
    assert argvs == [
        (0, ["--epochs", "3", "--distributed", "--elastic", "--dist_coord",
             "127.0.0.1:4321", "--dist_procs", "2", "--dist_rank", "0"]),
        (1, ["--epochs", "3", "--distributed", "--elastic", "--dist_coord",
             "127.0.0.1:4321", "--dist_procs", "2", "--dist_rank", "1"]),
        (0, ["--epochs", "3", "--resume", "--elastic"]),
        (0, ["--epochs", "3", "--resume", "--elastic"]),
    ]


def test_the_record(monkeypatch):
    rec, _ = _run(elastic, monkeypatch, [[75, -9], [0]], 2)
    assert rec == {
        "harness": "elastic_train", "completed": True, "restarts": 1,
        "final_world": 1, "best_acc": 12.5,
        "generations": [
            {"world": 2, "rcs": [75, -9], "event": "preempted:rank0:rc75"},
            {"world": 1, "rcs": [0], "event": "completed"}]}


SUPERVISE = """
import json, sys
from pytorch_cifar_tpu_torch.train import elastic
seen = {}
def run(self, timeout_s=3600.0):
    seen.update(torch="torch" in sys.modules, argv=self.base_argv,
                world=self.world, resume_first=self.resume_first)
    return {"harness": "elastic_train", "completed": COMPLETED}
elastic.ElasticTrainRunner.run = run
from pytorch_cifar_tpu_torch.train.__main__ import main
try:
    main(["--device", "cpu", "--elastic_procs", "3", "--model", "LeNet",
          "--dist_rank=2", "--resume", "--epochs", "4"])
except SystemExit as e:
    seen["code"] = e.code
seen["torch_after"] = "torch" in sys.modules
print(json.dumps(seen))
"""


@pytest.mark.parametrize("completed,code", [(True, 0), (False, 1)])
def test_elastic_procs_supervises_without_torch(completed, code):
    res = subprocess.run(
        [sys.executable, "-c",
         SUPERVISE.replace("COMPLETED", str(completed))],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert json.loads(lines[0]) == {"harness": "elastic_train",
                                    "completed": completed}
    assert json.loads(lines[-1]) == {
        "torch": False, "torch_after": False, "code": code, "world": 3,
        "resume_first": True,
        "argv": ["--device", "cpu", "--model", "LeNet", "--epochs", "4"]}
