"""The port's drill, ``--mode elastic``, end to end on the CPU: a fleet
under ``tools.fleet_run``'s controller (min 1 / max 3) through a load that
ramps 10x and back, replica 0 SIGKILLed mid-ramp.

It runs ``python -m pytorch_cifar_tpu_torch.tools.chaos_run --device cpu
--mode elastic`` at ``tests/test_chaos.py``'s sizes and asserts what the
JAX drill's test asserts (``tests/test_chaos.py:228-252``), on a record
with exactly the JAX drill's keys.
"""

import json

from _torch_chaos import run_chaos


def test_elastic_drill_ramp_kill_and_shed(tmp_path):
    """JAX ``test_elastic_drill_ramp_kill_and_shed``: the fleet holds at
    min under the baseline, scales up under the ramp with every scale-up
    at compiles 0, replaces the killed replica, sheds back when the ramp
    ends; no failed request, p99 bounded, and every replica that ever
    served bit for bit the first."""
    rec = run_chaos("elastic", tmp_path, extra=("--epochs", "2"))
    assert rec["match"] is True
    assert rec["held_at_min_baseline"] is True
    assert rec["scaled_up_under_ramp"] is True
    assert rec["bit_identical_all_generations"] is True
    assert all(c == "0" for c in rec["scaleup_compiles"])
    assert rec["scale_ups"] >= 2 and rec["scale_downs"] >= 1
    assert rec["replica_failures"] >= 1  # the SIGKILL was seen + reaped
    assert rec["failed"] == 0 and rec["requests"] > 0
    assert rec["p99_settle_ms"] <= rec["p99_budget_ms"]
    assert rec["healthy_final"] >= 1
    assert rec["fleet_rc"] == 0
    with open(tmp_path / "elastic" / "elastic.json") as f:
        kept = json.load(f)
    # every replica but the SIGKILLed seed drained with its record
    assert "0" not in kept["replicas"]
    assert len(kept["replicas"]) == rec["replicas_ever_served"] - 1
    assert set(kept["phase_s"]) == {"baseline", "ramp", "settle", "drain"}
