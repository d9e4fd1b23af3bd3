"""The port's drill, ``--mode rollout``, end to end on the CPU: the edge
(a router following the controller's journal) in the drill's process, the
journaled controller as ``tools.fleet_run --role controller``, SIGKILLed
at its generation-2 surge and resumed, then a NaN generation 3 refused
and rolled back.

It runs ``python -m pytorch_cifar_tpu_torch.tools.chaos_run --device cpu
--mode rollout`` at ``tests/test_chaos.py``'s sizes and asserts what the
JAX drill's test asserts (``tests/test_chaos.py:254-291``), on a record
with exactly the JAX drill's keys, with one difference on purpose: the
new generation's compiles.
"""

from _torch_chaos import run_chaos


def test_rollout_drill_controller_sigkill_resume_and_rollback(tmp_path):
    """JAX ``test_rollout_drill_controller_sigkill_resume_and_rollback``,
    but for ``new_gen_compiles``. JAX's test wants every new-generation
    replica at compiles "0": its cold-start cache holds executables that
    take any weights. The port's cache keeps one prepared weight set per
    checkpoint, so the first replica of a weight set the cache has not
    seen prepares it and compiles its buckets; every replica after the
    first of its generation must join at "0"."""
    rec = run_chaos("rollout", tmp_path, extra=("--epochs", "2"))
    assert rec["match"] is True
    assert rec["killed_mid_rollout"] is True
    assert rec["rollout_in_flight_at_kill"] is True
    assert rec["healthy_while_headless"] >= 2
    assert rec["resumed"] is True
    assert rec["adoptions"] == rec["adoptable_at_kill"] >= 2
    assert rec["no_double_spawn"] is True
    assert rec["converted_to_gen2"] is True
    assert rec["bit_identical_after_rollout"] is True
    # generation 3's surge is refused before it joins: these are
    # generation 2's replicas, its surge first
    assert rec["new_gen_compiles"] and all(
        c == "0" for c in rec["new_gen_compiles"][1:]
    )
    assert rec["halted_on_nan_candidate"] is True
    assert rec["rolled_back"] is True
    assert rec["live_gen_after_rollback"] == 2
    assert rec["bit_identical_after_rollback"] is True
    # a deploy is not a scale event: the ledger stays clean
    assert rec["rollouts"] == 1 and rec["rollbacks"] == 1
    assert rec["scale_ups"] == 0 and rec["scale_downs"] == 0
    assert rec["failed"] == 0 and rec["requests"] > 0
    assert rec["orphan_pids"] == []
    assert rec["controller_rc"] == 0
