"""Elastic fleet launcher: replicas + router + autoscaling controller.

Counterpart of the JAX package's ``tools/fleet_run.py``, in one command:

- spawns ``--replicas`` seed replicas (``python -m
  pytorch_cifar_tpu_torch.serve --http_port 0`` processes, on the card
  unless ``--device cpu``), one at a time; the first one populates the
  shared ``--aot_cache`` so every later replica of its weight set, seed or
  scale-up, joins with ``compile_count == 0``,
- starts a :class:`~pytorch_cifar_tpu_torch.serve.router.Router` + the
  SAME HTTP frontend in front of it (clients cannot tell an elastic fleet
  from a fixed one), and
- hands replica lifecycle authority to a
  :class:`~pytorch_cifar_tpu_torch.serve.fleet.FleetController`: it
  scrapes the fleet's own ``/healthz`` + ``/metrics``, scales up on
  sustained queue/deadline/p99 pressure, scales down only when a drain
  costs nothing, replaces dead replicas to the ``--min_replicas`` floor,
  and never exceeds ``--max_replicas``.

Durable control plane: with ``--journal PATH`` every actuation is
journaled append-durably before it is taken, and ``--resume`` relaunches a
crashed controller from that journal, re-adopting live replicas via
``/healthz`` probes (and the pid guard) instead of respawning them.
``--role controller --fleet_url URL`` runs ONLY the controller against a
data plane owned by a separate edge process (a Router following the same
journal through a
:class:`~pytorch_cifar_tpu_torch.serve.journal.JournalFollower`), so the
controller can die and return without a single dropped request.
``--rollouts`` arms generation-aware rolling deploys: when the live dir's
promotion-generation stamp moves, the controller surges one gated replica
on the new generation, converts the fleet one replica at a time, and halts
+ rolls back fleet-wide (restoring the ``.prev`` publish) on canary
regression.

Then either drives the built-in closed-loop HTTP load generator
(``--clients > 0``) or serves until SIGTERM/SIGINT or ``--duration_s``.
Prints ONE JSON record on stdout under the JAX launcher's keys; progress
and the machine-parseable topology lines go to stderr, and so does each
drained replica's own JSON record, under its ``[replica i]`` prefix:

    ==> fleet: replica 0 pid=123 url=http://127.0.0.1:41001 compiles=3 aot_hits=0 gen=None
    ==> fleet: serving on http://127.0.0.1:41000
    ==> fleet: scale-up replica 2 url=... pid=... compiles=3 gen=1 (load ...)
    ==> fleet: scale-down replica 2 url=... drain_s=0.21
    [replica 2] {"model": "ResNet18", ..., "launches_by_kernel": {...}}
    ==> fleet: rollout begin gen=1 -> gen=2 (n=2)
    ==> fleet: rollout-surge replica 3 url=... pid=... compiles=3 gen=2 (...)
    ==> fleet: rollout done gen=2 (replicas=2)

Usage:
  python -m pytorch_cifar_tpu_torch.tools.fleet_run --ckpt ./checkpoint \\
      --model ResNet18 --min_replicas 1 --max_replicas 3 --aot_cache ./aot
  python -m pytorch_cifar_tpu_torch.tools.fleet_run --ckpt ./checkpoint \\
      --model LeNet --device cpu --aot_cache ./aot --clients 8 --requests 64
  python -m pytorch_cifar_tpu_torch.tools.fleet_run --ckpt ./live \\
      --model ResNet18 --role controller --fleet_url http://127.0.0.1:41000 \\
      --journal fleet.journal --rollouts --aot_cache ./aot

This process never touches a device and never loads torch, but for a
rollback (the checkpoint module restores ``.prev``): replicas own the
card, and each checks that it has one, so without a card no replica
starts (the fleet role exits non-zero; a controller journals each failed
spawn and retries, as JAX's does); nothing falls back to the CPU. It
moves bytes and decisions.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading

from pytorch_cifar_tpu_torch.utils.signals import wait_for_stop


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m pytorch_cifar_tpu_torch.tools.fleet_run",
        description="An elastic fleet: replicas, router and controller.",
    )
    p.add_argument("--ckpt", required=True)
    p.add_argument("--model", default="ResNet18")
    p.add_argument(
        "--replicas", type=int, default=0,
        help="seed replica count (0 = min_replicas)",
    )
    p.add_argument("--min_replicas", type=int, default=1)
    p.add_argument("--max_replicas", type=int, default=3)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument(
        "--port", type=int, default=0,
        help="fleet HTTP port (0 = ephemeral; the URL prints on stderr)",
    )
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 8, 32])
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--deadline_ms", type=float, default=0.0)
    p.add_argument(
        "--aot_cache", required=True,
        help="shared cold-start cache dir: the first replica of a weight "
        "set populates it; every later one (incl. every controller "
        "scale-up) joins with compile_count == 0",
    )
    # policy knobs (serve/fleet.FleetPolicy)
    p.add_argument("--queue_high", type=float, default=8.0)
    p.add_argument("--queue_low", type=float, default=1.0)
    p.add_argument("--p99_high_ms", type=float, default=0.0)
    p.add_argument("--up_after_s", type=float, default=2.0)
    p.add_argument("--down_after_s", type=float, default=10.0)
    p.add_argument("--up_cooldown_s", type=float, default=5.0)
    p.add_argument("--down_cooldown_s", type=float, default=20.0)
    p.add_argument(
        "--control_interval_s", type=float, default=0.5,
        help="controller sweep period (scrape -> evaluate -> actuate)",
    )
    p.add_argument("--probe_s", type=float, default=0.5)
    p.add_argument("--fail_after", type=int, default=2)
    # durable control plane
    p.add_argument(
        "--journal", default="",
        help="controller journal path: every actuation is journaled "
        "append-durably before it is taken (restart safety)",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="recover from --journal: replay it against /healthz probes, "
        "re-adopt live replicas, reap the dead; never double-spawn",
    )
    p.add_argument(
        "--role", choices=("fleet", "controller"), default="fleet",
        help="'fleet' runs router+frontend+controller in one process; "
        "'controller' runs ONLY the journaled controller against a "
        "remote data plane (--fleet_url) whose edge follows the journal",
    )
    p.add_argument(
        "--fleet_url", default="",
        help="the remote edge's URL (--role controller): scraped for "
        "signals and the per-replica fleet view",
    )
    p.add_argument(
        "--rollouts", action="store_true",
        help="arm generation-aware rolling deploys keyed on the live "
        "dir's promotion-generation stamp",
    )
    p.add_argument(
        "--replica_watch", action="store_true",
        help="spawn replicas with --watch (uncoordinated per-replica "
        "hot-reload: the rolling-deploy baseline, not the default)",
    )
    p.add_argument(
        "--watch_poll_s", type=float, default=0.25,
        help="replica watcher poll period (with --replica_watch)",
    )
    # built-in HTTP loadgen (0 clients = serve until SIGTERM/SIGINT)
    p.add_argument("--clients", type=int, default=0)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--images_max", type=int, default=8)
    p.add_argument("--duration_s", type=float, default=0.0)
    p.add_argument("--bulk_fraction", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument(
        "--edge", choices=("threaded", "event"), default="threaded",
        help="I/O layer for the whole fleet: every replica's frontend "
        "(seed and scale-up alike), the router's replica transport, and "
        "the fleet frontend",
    )
    p.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the replicas run (bf16 on the card, fp32 on the CPU)",
    )
    p.add_argument(
        "--replica_devices", type=int, default=1,
        help="devices of each replica's group (the serving CLI's "
        "--num_devices; 0 = every visible card)",
    )
    args = p.parse_args(argv)
    if args.role == "controller" and not args.fleet_url:
        p.error("--role controller requires --fleet_url")
    if args.resume and not args.journal:
        p.error("--resume requires --journal")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    from pytorch_cifar_tpu_torch.obs import MetricsRegistry
    from pytorch_cifar_tpu_torch.serve.fleet import (
        FleetPolicy,
        HttpGoldenGate,
        live_generation_probe,
        live_rollback,
        make_replica_launcher,
    )
    from pytorch_cifar_tpu_torch.serve.journal import ControllerJournal

    policy = FleetPolicy(
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        queue_high=args.queue_high,
        queue_low=args.queue_low,
        p99_high_ms=args.p99_high_ms,
        up_after_s=args.up_after_s,
        down_after_s=args.down_after_s,
        up_cooldown_s=args.up_cooldown_s,
        down_cooldown_s=args.down_cooldown_s,
    )
    extra_args = ["--edge", args.edge]
    if args.replica_watch:
        extra_args += ["--watch", "--poll_s", str(args.watch_poll_s)]
    launcher = make_replica_launcher(
        args.ckpt,
        args.model,
        buckets=tuple(args.buckets),
        deadline_ms=args.deadline_ms,
        max_wait_ms=args.max_wait_ms,
        host=args.host,
        device=args.device,
        aot_cache=args.aot_cache,
        num_devices=args.replica_devices,
        timeout_s=args.timeout,
        extra_args=tuple(extra_args),
    )

    registry = MetricsRegistry()
    journal = (
        ControllerJournal(args.journal, registry=registry)
        if args.journal
        else None
    )
    rollout_kwargs = {}
    if args.rollouts:
        rollout_kwargs = dict(
            generation_probe=live_generation_probe(args.ckpt),
            rollout_gate=HttpGoldenGate(),
            rollback=live_rollback(args.ckpt),
        )

    if args.role == "controller":
        return _run_controller_role(
            args, policy, launcher, registry, journal, rollout_kwargs
        )
    return _run_fleet_role(
        args, policy, launcher, registry, journal, rollout_kwargs
    )


def _run_fleet_role(
    args, policy, launcher, registry, journal, rollout_kwargs
) -> int:
    """Router, frontend and controller in this process, over seed
    replicas it spawns itself."""
    from pytorch_cifar_tpu_torch.serve.edge import EdgeFrontend
    from pytorch_cifar_tpu_torch.serve.fleet import (
        FleetController,
        scrape_fleet,
    )
    from pytorch_cifar_tpu_torch.serve.frontend import ServingFrontend
    from pytorch_cifar_tpu_torch.serve.loadgen import HttpTarget, run_load
    from pytorch_cifar_tpu_torch.serve.router import Router

    # seed fleet, one replica at a time (each warmup has the card alone)
    seeds = []
    router = frontend = controller = None
    report = {}
    try:
        for i in range(max(args.replicas, args.min_replicas)):
            replica = launcher(i)
            replica.generation = replica.health.get("promotion_generation")
            seeds.append(replica)
            print(
                f"==> fleet: replica {i} pid={replica.pid} "
                f"url={replica.url} "
                f"compiles={replica.health.get('compiles')} "
                f"aot_hits={replica.health.get('aot_cache_hits')} "
                f"gen={replica.generation}",
                file=sys.stderr,
            )

        frontend_cls = (
            EdgeFrontend if args.edge == "event" else ServingFrontend
        )
        router = Router(
            [r.url for r in seeds],
            registry=registry,
            probe_s=args.probe_s,
            fail_after=args.fail_after,
            transport=args.edge,
        ).start()
        frontend = frontend_cls(
            router, host=args.host, port=args.port, registry=registry
        ).start()
        print(f"==> fleet: serving on {frontend.url}", file=sys.stderr,
              flush=True)

        controller = FleetController(
            router,
            launcher,
            policy,
            scrape=lambda: scrape_fleet(frontend.url),
            registry=registry,
            interval_s=args.control_interval_s,
            journal=journal,
            **rollout_kwargs,
        )
        for replica in seeds:
            controller.adopt(replica)
        controller.start()
        print(
            f"==> fleet: controller up (min {policy.min_replicas}, max "
            f"{policy.max_replicas}, band {policy.queue_low}-"
            f"{policy.queue_high} queued/replica, up after "
            f"{policy.up_after_s}s, down after {policy.down_after_s}s)",
            file=sys.stderr,
            flush=True,
        )

        if args.clients > 0:
            target = HttpTarget(frontend.url)
            try:
                report = run_load(
                    target,
                    clients=args.clients,
                    requests_per_client=args.requests,
                    images_max=args.images_max,
                    seed=args.seed,
                    duration_s=args.duration_s or None,
                    bulk_fraction=args.bulk_fraction,
                )
            finally:
                target.close()
        else:
            stop = threading.Event()
            signal.signal(signal.SIGTERM, lambda *a: stop.set())
            signal.signal(signal.SIGINT, lambda *a: stop.set())
            wait_for_stop(stop, args.duration_s)
    finally:
        print("==> fleet: draining", file=sys.stderr, flush=True)
        # controller first (no more actuation), then the edge, then the
        # replica tree: every child reaped, no orphan survives this
        # process, on success and on failure alike
        if controller is not None:
            controller.stop(drain_replicas=False)
        if frontend is not None:
            frontend.stop()
        if router is not None:
            router.stop()
        replicas = (
            controller.replicas() if controller is not None
            else {r.url: r for r in seeds}
        )
        replica_rcs = {}
        for url, handle in replicas.items():
            handle.decommission(timeout_s=60.0)
            replica_rcs[url] = handle.proc.returncode

    s = registry.summary()
    record = {
        "harness": "fleet_run",
        "role": "fleet",
        "model": args.model,
        "min_replicas": policy.min_replicas,
        "max_replicas": policy.max_replicas,
        "fleet_url": frontend.url,
        "replicas_final": len(replicas),
        "replica_rcs": replica_rcs,
        "generations": {
            url: getattr(h, "generation", None)
            for url, h in replicas.items()
        },
        **_controller_record(controller, journal),
        "spawn_ms_p50": round(s.get("serve.fleet.spawn_ms.p50", 0.0), 1),
        "drain_ms_p50": round(s.get("serve.fleet.drain_ms.p50", 0.0), 1),
        **{
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in report.items()
        },
        "router": router.stats,
    }
    print(json.dumps(record), flush=True)
    return 0


def _controller_record(controller, journal) -> dict:
    """The controller's share of the JSON record, shared by both roles
    so drills assert the same keys either way."""
    stats = controller.stats
    return {
        "scale_ups": stats["scale_ups"],
        "scale_downs": stats["scale_downs"],
        "replica_failures": stats["replica_failures"],
        "scrape_errors": stats["scrape_errors"],
        "adoptions": stats["adoptions"],
        "rollouts": stats["rollouts"],
        "rollbacks": stats["rollbacks"],
        "journal_replays": stats["journal_replays"],
        "generation": stats["generation"],
        "journal_seq": journal.seq if journal is not None else None,
    }


def _run_controller_role(
    args, policy, launcher, registry, journal, rollout_kwargs
) -> int:
    """The split deployment: ONLY the journaled controller. The data
    plane (Router + frontend) lives in another process that follows the
    same journal for membership
    (:class:`~pytorch_cifar_tpu_torch.serve.journal.JournalFollower`), so
    SIGKILLing this process stops decisions, never traffic, and
    ``--resume`` brings the decisions back."""
    from pytorch_cifar_tpu_torch.serve.fleet import (
        FleetController,
        RemoteFleetPort,
        recover_controller,
        scrape_fleet,
    )

    port = RemoteFleetPort(args.fleet_url)

    def scrape():
        return scrape_fleet(args.fleet_url)

    # a SIGTERM while the fleet seeds must still drain what came up
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    if args.resume:
        controller = recover_controller(
            journal,
            port,
            launcher,
            policy,
            scrape=scrape,
            registry=registry,
            interval_s=args.control_interval_s,
            **rollout_kwargs,
        )
        print(
            f"==> fleet: controller resumed from journal "
            f"(adopted={controller.stats['adoptions']} "
            f"gen={controller.generation})",
            file=sys.stderr,
            flush=True,
        )
    else:
        controller = FleetController(
            port,
            launcher,
            policy,
            scrape=scrape,
            registry=registry,
            interval_s=args.control_interval_s,
            journal=journal,
            **rollout_kwargs,
        )
    try:
        if not args.resume:
            controller.seed(max(args.replicas, args.min_replicas))
        controller.start()
        print(
            f"==> fleet: controller up (min {policy.min_replicas}, max "
            f"{policy.max_replicas}, fleet {args.fleet_url})",
            file=sys.stderr,
            flush=True,
        )
        wait_for_stop(stop, args.duration_s)
    finally:
        print("==> fleet: draining", file=sys.stderr, flush=True)
        replicas = controller.replicas()
        controller.stop(drain_replicas=True)

    record = {
        "harness": "fleet_run",
        "role": "controller",
        "model": args.model,
        "min_replicas": policy.min_replicas,
        "max_replicas": policy.max_replicas,
        "fleet_url": args.fleet_url,
        "replicas_final": len(replicas),
        "generations": {
            url: getattr(h, "generation", None)
            for url, h in replicas.items()
        },
        "resumed": bool(args.resume),
        **_controller_record(controller, journal),
    }
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
