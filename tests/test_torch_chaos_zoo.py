"""The port's drill, ``--mode zoo``, end to end on the CPU: two zoo
replicas (LeNet from a trained checkpoint, MobileNet and VGG11 on seeded
random weights, ``--max_resident 2``) behind ``tools.router_run --models``
under a zipf per-model mix ranked by the card's cost priors, replica 0
SIGKILLed mid-load.

It runs ``python -m pytorch_cifar_tpu_torch.tools.chaos_run --device cpu
--mode zoo`` at ``tests/test_chaos.py``'s sizes and asserts what the JAX
drill's test asserts (``tests/test_chaos.py:201-226``), on a record with
exactly the JAX drill's keys.
"""

import json

from _torch_chaos import run_chaos


def test_zoo_drill_skewed_load_churn_and_replica_kill(tmp_path):
    """JAX ``test_zoo_drill_skewed_load_churn_and_replica_kill``: per-model
    bits equal across both replicas, the router, both encodings and
    evict/re-admit cycles; no failed request in any phase; re-admitted
    tenants imported from the cache at compiles 0; the corpse evicted and
    a clean drain."""
    rec = run_chaos("zoo", tmp_path, extra=("--epochs", "2"))
    assert rec["match"] is True
    assert rec["models"] == ["LeNet", "MobileNet", "VGG11"]
    assert rec["warm_replica_compiles"] == 0
    assert all(rec["per_model_bit_identical"].values())
    assert rec["post_kill_bits_match"] is True
    assert rec["failed"] == 0 and rec["requests"] > 0
    # the skew was real: the hot model dominated
    hot = max(rec["mix"], key=rec["mix"].get)
    assert rec["per_model_requests"][hot] == max(
        rec["per_model_requests"].values()
    )
    assert rec["churned_tenants"]  # forced eviction churn happened
    assert rec["readmit_compiles_zero"] is True
    assert rec["evictions"] >= 1 and rec["healthy_after"] == 1
    assert rec["router_rc"] == 0
    with open(tmp_path / "zoo" / "zoo.json") as f:
        kept = json.load(f)
    assert sorted(kept["replicas"]) == ["1"]
    assert set(kept["replicas"]["1"]["tenants"]) == set(rec["models"])
