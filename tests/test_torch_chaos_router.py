"""The port's drill, ``--mode router``, end to end on the CPU: two
replicas of the serving CLI behind ``tools.router_run`` on a shared
cold-start cache under mixed-priority, mixed-wire load, replica 0
SIGKILLed mid-load.

It runs ``python -m pytorch_cifar_tpu_torch.tools.chaos_run --device cpu
--mode router`` at ``tests/test_chaos.py``'s sizes and asserts what the
JAX drill's test asserts (``tests/test_chaos.py:153-171``), on a record
with exactly the JAX drill's keys; and that the work dir keeps the
launcher's record and the survivor's own.
"""

import json

from _torch_chaos import run_chaos


def test_router_drill_sigkill_replica_under_load(tmp_path):
    """JAX ``test_router_drill_sigkill_replica_under_load``: the router
    evicts the killed replica and keeps serving, bounded in-flight loss,
    the post-evict p99 within the 2x steady-state budget, no router crash,
    the warm replica joined at compiles 0, and /predict bit for bit
    across both replicas and the router."""
    rec = run_chaos("router", tmp_path, extra=("--epochs", "2"))
    assert rec["match"] is True
    assert rec["warm_replica_compiles"] == 0
    assert rec["bit_identical"] is True
    assert rec["evictions"] >= 1
    assert rec["healthy_after"] == 1
    assert rec["p99_post_ms"] <= rec["p99_budget_ms"]
    assert rec["failed_during_kill"] <= max(4, rec["requests"] // 20)
    assert rec["router_rc"] == 0
    with open(tmp_path / "router" / "router.json") as f:
        kept = json.load(f)
    assert kept["launcher"]["router"]["evictions"] == rec["evictions"]
    # replica 0 died by SIGKILL: only the survivor's record came back
    assert sorted(kept["replicas"]) == ["1"]
    survivor = kept["replicas"]["1"]
    assert survivor["device"] == "cpu" and survivor["compiles"] == 0
    assert survivor["aot_cache_hits"] == 3  # buckets 1, 4, 8
