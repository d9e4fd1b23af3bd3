"""The port's drill, serving modes, end to end on the CPU: the serving
CLI hot-reloading and SIGKILLed under load (``serve``), the canary
pipeline vetting bad and good candidates under load (``canary``), and the
event-loop edge under a slow-loris trickle, a connection flood and a
replica SIGKILL (``edge``).

Each test runs ``python -m pytorch_cifar_tpu_torch.tools.chaos_run
--device cpu`` with ``tests/test_chaos.py``'s flags for the mode and
asserts what the JAX drill's test asserts, on a record with exactly the
JAX drill's keys.
"""

from _torch_chaos import run_chaos


def test_serve_drill_hot_reload_and_kill(tmp_path):
    """JAX ``test_sharded_serve_drill_hot_reload_and_kill`` on one device
    (serving over a device group is not ported yet)."""
    rec = run_chaos(
        "serve", tmp_path,
        extra=("--serve-devices", "1", "--epochs", "2"),
    )
    assert rec["match"] is True
    assert rec["reloads"] >= 1
    assert rec["n_devices"] == 1
    assert rec["ckpt_epoch_served"] == rec["ckpt_epoch_published"]
    assert rec["killed_rc"] == -9
    assert rec["recovery_s"] > 0
    assert rec["compiles"] == 3  # buckets 1, 4, 8


def test_canary_drill_bad_checkpoints_contained_good_promotes(tmp_path):
    """JAX ``test_canary_drill_bad_checkpoints_contained_good_promotes``,
    at its own sizes (the promotion needs B to be a genuine improvement
    over A)."""
    rec = run_chaos(
        "canary", tmp_path,
        extra=("--train-size", "512", "--test-size", "256"),
    )
    assert rec["match"] is True
    assert rec["bad_candidates_contained"] is True
    assert rec["rejected"] == 3 and rec["promotions"] == 1
    for verdict in rec["verdicts"].values():
        assert verdict["quarantined"] is True
        assert verdict["fleet_bits_identical"] is True
        assert verdict["served_epoch"] == rec["epoch_incumbent"]
    assert rec["promoted"] is True
    assert rec["final_epoch"] == rec["epoch_candidate"]
    assert rec["final_generation"] == 1
    assert rec["failed"] == 0 and rec["requests"] > 0
    assert rec["bulk_requests"] > 0
    assert rec["pipeline_rc"] == 0


def test_edge_drill_loris_flood_and_replica_kill(tmp_path):
    """JAX ``test_edge_drill_loris_flood_and_replica_kill``."""
    rec = run_chaos("edge", tmp_path, extra=("--epochs", "2"))
    assert rec["match"] is True
    assert rec["transport"] == "event"
    assert rec["bit_identical"] is True
    assert rec["requests"] > 0
    assert rec["loris"]["closed_by_server"] == 1
    assert rec["loris"]["sent"] > 0
    assert rec["loris_closed_counter"] >= 1
    assert rec["failed_during_loris"] == 0
    assert rec["flood"]["opened"] >= 200
    assert rec["flood"]["refused"] == 0
    assert rec["failed_during_flood"] == 0
    assert rec["failed_during_kill"] <= max(4, rec["requests"] // 20)
    assert rec["evictions"] >= 1
    assert rec["router_rc"] == 0
