"""Fleet launcher: N replicas of the port's serving CLI behind one router.

Counterpart of the JAX package's ``tools/router_run.py``. The production
topology in one command:

- spawns ``--replicas`` N ``python -m pytorch_cifar_tpu_torch.serve
  --http_port 0`` processes (each its own engine on the card, or on the
  CPU with ``--device cpu``): with ``--aot_cache``, replica 0 FIRST, so
  it fills the shared cold-start cache and every later replica joins with
  ``compile_count == 0``; without it, all at once (each warms its own
  buckets),
- waits for each replica's ``/healthz`` to go green,
- starts a :class:`~pytorch_cifar_tpu_torch.serve.router.Router` (health
  probes, least-loaded dispatch, hedge-to-second-replica, priority-aware
  admission) and binds the SAME HTTP frontend in front of it: clients
  cannot tell the fleet from one replica,
- then either drives the built-in closed-loop HTTP load generator
  (``--clients > 0``) or serves until SIGTERM/SIGINT or ``--duration_s``
  (a drill SIGKILLs a replica out from under the router mid-load).

``--models A,B=dir,...`` makes every replica a multi-tenant zoo
(``--max_resident`` bounds its resident set) and the built-in load draws a
zipf per-model mix from the card's cost priors.

``--replica_devices D`` serves each replica over a group of D devices
(the serving CLI's ``--num_devices``). ``--mesh_procs P`` makes each
replica a LOGICAL one of P processes: the leader rank (which owns the
frontend; the router sees its URL alone), then P - 1 follower ranks, on a
private rendezvous port, every rank with ``--num_devices`` set to
``--replica_devices`` (the replica's devices, shared out among its ranks,
one at least each; 0 = every visible card) and ``--mesh_timeout_s``; a
replica drains leader first.

Prints ONE JSON line on stdout under the JAX launcher's keys (requests,
latency percentiles, router hedge/eviction counters, per-replica compile
counts, ``replica_mesh``: each leader's topology block, None for a
one-process replica; ``follower_rcs``: each replica's followers' exit
codes). Progress and the machine-parseable topology lines go to stderr, and
so does each rank's own JSON record when it exits, under its ``[replica
i]`` (a follower: ``[replica i:rR]``) prefix:

    ==> replica 0 pid=12345 url=http://127.0.0.1:41001 gen=1
    ==> replica 0 follower rank=1 pid=12346
    ==> router: serving on http://127.0.0.1:41000
    [replica 0] {"model": "ResNet18", ..., "launches_by_kernel": {...}}
    [replica 0:r1] {"role": "mesh_follower", ..., "launches_by_kernel": ...}

Usage:
  python -m pytorch_cifar_tpu_torch.tools.router_run --ckpt ./checkpoint \\
      --model ResNet18 --replicas 2 --aot_cache ./aot --clients 8 \\
      --requests 64
  python -m pytorch_cifar_tpu_torch.tools.router_run --ckpt ./checkpoint \\
      --models ResNet18,MobileNet,GoogLeNet --max_resident 2 --replicas 2
  python -m pytorch_cifar_tpu_torch.tools.router_run --ckpt ./checkpoint \\
      --model LeNet --device cpu --deadline_ms 250   # serve until SIGTERM
  python -m pytorch_cifar_tpu_torch.tools.router_run --ckpt ./checkpoint \\
      --model ResNet18 --replicas 2 --mesh_procs 2 --aot_cache ./aot

This process never touches a device and never loads torch (it starts in
well under a second where ``import torch`` alone takes seconds): replicas
own the card, and each checks that it has one, so without a card the
first replica fails to start and the launcher exits non-zero; it never
falls back to the CPU. It moves bytes.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_cifar_tpu_torch.tools.router_run",
        description="N replicas of the serving CLI behind one router.",
    )
    p.add_argument("--ckpt", required=True)
    p.add_argument("--model", default="ResNet18")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument(
        "--port", type=int, default=0,
        help="router HTTP port (0 = ephemeral; the actual URL prints "
        "on stderr)",
    )
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 8, 32])
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument(
        "--deadline_ms", type=float, default=0.0,
        help="per-replica queue-time bound; the router hedges a 504 to "
        "a second replica",
    )
    p.add_argument(
        "--models", default="",
        help="multi-tenant zoo fleet: comma-separated "
        "'Name[=ckpt_dir]' tenant list passed to every replica; the "
        "built-in load then draws a heavy-tailed per-model mix",
    )
    p.add_argument(
        "--max_resident", type=int, default=0,
        help="per-replica resident-tenant bound (0 = all resident); "
        "forces placement churn below the tenant count",
    )
    p.add_argument(
        "--aot_cache", default="",
        help="shared cold-start cache dir: replica 0 populates it, "
        "later replicas cold-start with compile_count == 0",
    )
    p.add_argument(
        "--replica_devices", type=int, default=1,
        help="devices of each replica's group (the serving CLI's "
        "--num_devices; with --mesh_procs, shared out among the ranks; "
        "0 = every visible card)",
    )
    p.add_argument(
        "--mesh_procs", type=int, default=1,
        help="processes per LOGICAL replica: one leader rank (owns the "
        "frontend; the router sees its URL alone) plus N-1 follower "
        "ranks on a private rendezvous port; drained leader first. 1 = "
        "one-process replicas",
    )
    p.add_argument(
        "--mesh_timeout_s", type=float, default=30.0,
        help="dead-peer bound of every rank (the serving CLI's "
        "--mesh_timeout_s): a rank stuck at a collective this long exits "
        "rc 70 and the router evicts the logical replica",
    )
    p.add_argument("--watch", action="store_true")
    p.add_argument("--poll_s", type=float, default=1.0)
    p.add_argument("--probe_s", type=float, default=0.5)
    p.add_argument(
        "--fail_after", type=int, default=2,
        help="consecutive probe/dispatch failures before eviction",
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
        help="I/O layer for the whole stack: replicas' frontends, the "
        "router's replica transport, and the router-process frontend; "
        "answers are bit-identical",
    )
    p.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the replicas run (bf16 on the card, fp32 on the CPU)",
    )
    return p.parse_args(argv)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_replica(args, idx: int):
    """One replica: a serving CLI process, or with ``--mesh_procs`` its
    leader rank and then its followers, on a private rendezvous port."""
    from pytorch_cifar_tpu_torch.serve.fleet import (
        ReplicaProcess,
        replica_command,
    )

    extra = ["--poll_s", str(args.poll_s), "--edge", args.edge]
    if args.models:
        # multi-tenant zoo replicas: every replica hosts the same tenant
        # list; the router dispatches model-aware off each replica's
        # /healthz
        extra += ["--models", args.models,
                  "--max_resident", str(args.max_resident)]
    if args.watch:
        extra.append("--watch")

    def command(num_devices, more=()):
        return replica_command(
            args.ckpt, args.model, buckets=args.buckets,
            deadline_ms=args.deadline_ms, max_wait_ms=args.max_wait_ms,
            host=args.host, device=args.device, aot_cache=args.aot_cache,
            num_devices=num_devices, extra_args=[*extra, *more])

    if args.mesh_procs <= 1:
        return ReplicaProcess(idx, command(args.replica_devices))
    mesh = ["--mesh_procs", str(args.mesh_procs),
            "--mesh_coord", f"127.0.0.1:{_free_port()}",
            "--mesh_timeout_s", str(args.mesh_timeout_s)]
    devices = args.replica_devices
    leader = ReplicaProcess(idx, command(devices,
                                         [*mesh, "--mesh_rank", "0"]))
    for rank in range(1, args.mesh_procs):
        f = ReplicaProcess(f"{idx}:r{rank}", command(
            devices, [*mesh, "--mesh_rank", str(rank)]))
        leader.followers.append(f)
        print(f"==> replica {idx} follower rank={rank} pid={f.pid}",
              file=sys.stderr, flush=True)
    return leader


def shutdown_replicas(replicas, timeout: float) -> list:
    """SIGTERM every live replica (their drain signal) at once, then reap
    each and collect its exit code; a replica a drill SIGKILLed is
    already gone and is reaped all the same."""
    for r in replicas:
        r.terminate()
    codes = []
    for r in replicas:
        r.decommission(timeout_s=timeout)
        codes.append(r.proc.returncode)
    return codes


def main(argv=None) -> int:
    args = parse_args(argv)

    from pytorch_cifar_tpu_torch.obs import MetricsRegistry
    from pytorch_cifar_tpu_torch.serve.edge import EdgeFrontend
    from pytorch_cifar_tpu_torch.serve.frontend import ServingFrontend
    from pytorch_cifar_tpu_torch.serve.loadgen import HttpTarget, run_load
    from pytorch_cifar_tpu_torch.serve.router import Router
    from pytorch_cifar_tpu_torch.utils.signals import wait_for_stop

    frontend_cls = EdgeFrontend if args.edge == "event" else ServingFrontend

    # stage the fleet on a cache: replica 0 alone (it fills the cache),
    # then the rest together (they import it); without one, all at once
    replicas = [spawn_replica(args, i)
                for i in range(1 if args.aot_cache else args.replicas)]
    router = frontend = None
    report = {}
    try:
        try:
            healths = [r.wait_healthy(args.timeout) for r in replicas]
            staged = len(replicas)
            replicas += [spawn_replica(args, i)
                         for i in range(staged, args.replicas)]
            healths += [r.wait_healthy(args.timeout)
                        for r in replicas[staged:]]
        except RuntimeError as e:  # a replica died or never turned healthy
            raise SystemExit(str(e)) from None
        print(
            f"==> replica 0 warm: compiles={healths[0].get('compiles')} "
            f"aot_hits={healths[0].get('aot_cache_hits')}",
            file=sys.stderr,
        )
        for r, h in zip(replicas, healths):
            print(
                f"==> replica {r.idx} pid={r.pid} url={r.url} "
                f"gen={h.get('promotion_generation')}",
                file=sys.stderr,
            )

        registry = MetricsRegistry()
        router = Router(
            [r.url for r in replicas],
            registry=registry,
            probe_s=args.probe_s,
            fail_after=args.fail_after,
            transport=args.edge,
        ).start()
        frontend = frontend_cls(
            router, host=args.host, port=args.port, registry=registry
        ).start()
        print(f"==> router: serving on {frontend.url}", file=sys.stderr,
              flush=True)

        if args.clients > 0:
            model_mix = None
            if args.models:
                from pytorch_cifar_tpu_torch.serve.loadgen import zipf_mix
                from pytorch_cifar_tpu_torch.serve.priors import (
                    load_cost_priors,
                )

                names = [
                    e.split("=", 1)[0].strip()
                    for e in args.models.split(",")
                ]
                model_mix = zipf_mix(names, priors=load_cost_priors())
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
                    model_mix=model_mix,
                )
            finally:
                target.close()
        else:
            stop = threading.Event()
            signal.signal(signal.SIGTERM, lambda *a: stop.set())
            signal.signal(signal.SIGINT, lambda *a: stop.set())
            wait_for_stop(stop, args.duration_s)
    finally:
        print("==> router: draining", file=sys.stderr, flush=True)
        if frontend is not None:
            frontend.stop()
        if router is not None:
            router.stop()
        # every child reaped, on success and on failure alike
        replica_rcs = shutdown_replicas(replicas, timeout=60.0)

    record = {
        "harness": "router_run",
        "replicas": args.replicas,
        "model": args.model,
        "models": args.models,
        "mesh_procs": args.mesh_procs,
        "router_url": frontend.url,
        "replica_compiles": [h.get("compiles") for h in healths],
        "replica_aot_hits": [h.get("aot_cache_hits") for h in healths],
        "replica_cold_start_s": [h.get("cold_start_s") for h in healths],
        "replica_mesh": [h.get("mesh") for h in healths],
        "replica_generations": [
            h.get("promotion_generation") for h in healths
        ],
        "replica_rcs": replica_rcs,
        "follower_rcs": [[f.proc.returncode for f in r.followers]
                         for r in replicas],
        **{
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in report.items()
        },
        "router": router.stats,
    }
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
