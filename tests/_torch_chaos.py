"""The port's drill (``python -m pytorch_cifar_tpu_torch.tools.chaos_run``)
as a child process on the CPU, at the JAX drill tests' sizes, and the keys
of the JAX drill's record for each mode.

:func:`run_chaos` is ``tests/test_chaos.py``'s helper (``:27-50``) with
the port's module and ``--device cpu``; the drill's own children run torch
on two threads, as the test processes do (``_torch_threads``), except the
fleet modes' (:data:`ONE_THREAD_MODES`). Every
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
# the fleet modes' children run torch on one thread: a replica's forward
# of at most 8 images gains nothing from a second, and in the six-worker
# run a two-thread forward waits on whichever thread the host has
# descheduled (LeNet's forward, well under 1 ms alone, at a p95 of 30-40
# ms), which is what broke the router drill's p99 budget there
ONE_THREAD_MODES = {"router", "zoo", "elastic", "rollout"}

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
    # router_drill's return, :1442-1468
    "router": {"harness", "mode", "match", "reference_s", "recovery_s",
               "warm_replica_compiles", "bit_identical", "wire",
               "p99_steady_ms", "p99_kill_ms", "p99_post_ms", "p99_budget_ms",
               "requests", "failed_during_kill", "hedged_during_kill",
               "healthy_after", "evictions", "router_hedged",
               "router_replica_errors", "router_rc"},
    # zoo_drill's return, :2182-2218
    "zoo": {"harness", "mode", "match", "models", "max_resident", "mix",
            "recovery_s", "warm_replica_compiles", "per_model_bit_identical",
            "post_kill_bits_match", "requests", "per_model_requests",
            "failed", "hedged_during_kill", "churned_tenants",
            "readmit_compiles_zero", "survivor_tenants", "healthy_after",
            "evictions", "router_hedged", "router_rc"},
    # elastic_drill's return, :726-756
    "elastic": {"harness", "mode", "match", "min_replicas", "max_replicas",
                "held_at_min_baseline", "scaled_up_under_ramp",
                "bit_identical_all_generations", "replicas_ever_served",
                "scaleup_compiles", "scale_ups", "scale_downs",
                "replica_failures", "stderr_ups", "stderr_downs",
                "stderr_died", "requests", "failed", "hedged_during_ramp",
                "p99_steady_ms", "p99_ramp_ms", "p99_settle_ms",
                "p99_budget_ms", "healthy_after_ramp", "healthy_final",
                "spawn_ms_p50", "drain_ms_p50", "fleet_rc"},
    # rollout_drill's return, :1225-1261
    "rollout": {"harness", "mode", "match", "killed_mid_rollout",
                "rollout_in_flight_at_kill", "healthy_while_headless",
                "resumed", "adoptions", "adoptable_at_kill",
                "no_double_spawn", "surge_survived", "converted_to_gen2",
                "bit_identical_after_rollout", "new_gen_compiles",
                "halted_on_nan_candidate", "rolled_back",
                "canary_failed_lines", "live_gen_after_rollback",
                "fleet_gen2_after_rollback", "bit_identical_after_rollback",
                "rollouts", "rollbacks", "scale_ups", "scale_downs",
                "journal_replays", "journal_seq", "journal_inspect",
                "requests", "failed", "p99_max_ms", "orphan_pids",
                "controller_rc"},
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
    threads = 1 if mode in ONE_THREAD_MODES else THREADS
    env = {**os.environ, "OMP_NUM_THREADS": str(threads)}
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
