"""The port's drill (``python -m pytorch_cifar_tpu_torch.tools.chaos_run``)
as a child process on the CPU, at the JAX drill tests' sizes, and the keys
of the JAX drill's record for each mode.

:func:`run_chaos` is ``tests/test_chaos.py``'s helper (``:27-50``) with
the port's module and ``--device cpu``; the drill's own children run torch
on two threads, as the test processes do (``_torch_threads``). Every
record it returns has exactly the JAX drill's keys for its mode
(:data:`RECORD_KEYS`; ``tests/test_torch_chaos_cli.py`` holds the pins
against JAX's ``tools/chaos_run.py``).
"""

import json
import os
import subprocess
import sys

from _torch_threads import THREADS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_chaos.py:31-40
SIZES = ("--epochs", "3", "--train-size", "256", "--test-size", "128",
         "--batch", "64")

# the yardstick's keys (JAX tools/chaos_run.py:264-271, ``compare``)
COMPARE_KEYS = {"max_abs_diff", "finite", "best_epoch_ref",
                "best_epoch_chaos", "best_acc_ref", "best_acc_chaos"}
# the trainer modes' record (main, :2801-2814): ``corruption`` for
# corrupt, the interrupted run's ``signal`` and ``rc`` for the signal modes
TRAINER_KEYS = {"harness", "mode", "match", "tol", "reference_s",
                "recovery_s"} | COMPARE_KEYS
RECORD_KEYS = {
    "sigterm": TRAINER_KEYS | {"signal", "rc"},
    "sigkill": TRAINER_KEYS | {"signal", "rc"},
    "corrupt": TRAINER_KEYS | {"corruption", "signal", "rc"},
    "nan": TRAINER_KEYS,
    # serve_drill's return, :439-452
    "serve": {"harness", "mode", "match", "reference_s", "recovery_s",
              "reloads", "hedged", "n_devices", "ckpt_epoch_published",
              "ckpt_epoch_served", "compiles", "killed_rc"},
    # ckpt_drill's return, :2643-2656
    "ckpt": {"harness", "mode", "match", "tol", "reference_s", "recovery_s",
             "killed_rc", "inspect_rc_torn", "inspect_rc_after",
             "torn_v3_rejected"} | COMPARE_KEYS,
    # canary_drill's return, :2505-2522
    "canary": {"harness", "mode", "match", "epoch_incumbent",
               "epoch_candidate", "bad_candidates_contained", "verdicts",
               "promoted", "final_epoch", "final_generation", "rejected",
               "promotions", "requests", "failed", "bulk_requests",
               "pipeline_rc"},
    # edge_drill's return, :1675-1697
    "edge": {"harness", "mode", "match", "transport", "bit_identical",
             "wire", "p99_steady_ms", "p99_loris_ms", "p99_flood_ms",
             "p99_kill_ms", "requests", "loris", "loris_closed_counter",
             "flood", "failed_during_loris", "failed_during_flood",
             "failed_during_kill", "hedged_during_kill", "evictions",
             "router_rc"},
    # mesh_drill's return, :1931-1959
    "mesh": {"harness", "mode", "match", "mesh_procs", "mesh_timeout_s",
             "reference_s", "detection_s", "warm_replica_compiles",
             "mesh_health", "bit_identical", "wire", "requests", "failed",
             "hedged_during_kill", "p99_steady_ms", "p99_post_ms",
             "leader_rc", "follower_rcs", "healthy_after", "evictions",
             "router_hedged", "router_rc"},
}


def run_chaos(mode, tmp_path, extra=(), timeout=420):
    """One drill run; asserts its exit code 0 and its record's keys, and
    returns the record."""
    env = {**os.environ, "OMP_NUM_THREADS": str(THREADS)}
    r = subprocess.run(
        [
            sys.executable, "-m", "pytorch_cifar_tpu_torch.tools.chaos_run",
            "--device", "cpu",
            "--mode", mode,
            *SIZES,
            "--out", str(tmp_path / mode),
            *extra,
        ],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env,
    )
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    lines = [
        ln for ln in r.stdout.splitlines() if ln.strip().startswith("{")
    ]
    assert lines, r.stdout
    rec = json.loads(lines[-1])
    assert rec["harness"] == "chaos_run" and rec["mode"] == mode
    assert set(rec) == RECORD_KEYS[mode], sorted(set(rec) ^ RECORD_KEYS[mode])
    return rec
