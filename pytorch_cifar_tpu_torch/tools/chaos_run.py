"""The port's drill: kill, corrupt or poison a real training run of the
port, then prove that it recovers; and the serving, checkpoint, canary and
edge drills.

Counterpart of the JAX package's ``tools/chaos_run.py``, on the port's own
CLIs, each a child process: ``python -m pytorch_cifar_tpu_torch.train``,
``...serve``, ``...tools.pipeline_run``, ``...tools.router_run`` and
``...tools.ckpt_inspect``. Each mode prints ONE JSON line under the JAX
drill's keys for that mode, with its verdict under ``match``, and exits 0
only when ``match`` is true:

  sigterm  preemption: SIGTERM mid-run -> the trainer finishes the epoch,
           writes last.msgpack and exits 0; --resume completes the run.
           The final params and metadata must match an uninterrupted
           reference run.
  sigkill  crash: SIGKILL mid-run (no goodbye write); --resume restores
           the newest usable checkpoint and re-runs the lost epochs to the
           reference's final state.
  corrupt  torn write: as sigterm, but the preemption save and its history
           are truncated (--corruption truncate) or bit-flipped (bitflip)
           before the relaunch; the verified restore must fall back to the
           best checkpoint and still complete.
  nan      divergence: PCT_FAULTS=nan_loss=K poisons one step under
           --sentinel skip; the run must end finite, within 0.25 of the
           reference's params.
  serve    a serving process with --watch must hot-reload a newly
           published checkpoint under load; a second one is SIGKILLed
           under load, and the relaunch must serve the new best
           checkpoint with its compile count pinned.
  ckpt     a SIGKILL inside a stalled async commit (PCT_FAULTS=
           ckpt_write_stall, a save every improvement) and --resume to the
           reference result; then a newer 4-shard v3 preemption save with
           a truncated shard is planted: ckpt_inspect must flag it, the
           resume must fall back past it, and the result must still match.
  canary   serve-only pipeline_run under mixed-priority HTTP load: NaN,
           bit-flipped and regressed candidates staged one after another
           are each quarantined with the fleet's bits, epoch and
           generation unmoved; then a genuinely better B promotes, with no
           failed request across the drill.
  edge     router_run --edge event with 2 replicas under open-loop mixed-
           wire load: a slow-loris trickle closed by the read deadline, a
           256-socket flood absorbed, a replica SIGKILLed with bounded
           loss and evicted, and a SIGTERM drain that exits 0.
  mesh     router_run --replicas 2 --mesh_procs 2 under mixed-wire load:
           every answer bit for bit a one-process replica's; one
           follower rank SIGKILLed, its leader exits rc 70 within
           --mesh_timeout_s, the router evicts the logical replica with no
           failed request, and replica 1 joined at compiles == 0 on the
           shared cold-start cache.

The JAX drill's router, zoo, elastic and rollout modes are the port's
``chip_smoke.py`` phases wire, zoo_fleet, fleet and rollout.
``--serve-devices N`` serves ``--mode serve`` over a group of N devices
(on the CPU, N logical shards).

Usage:
  python -m pytorch_cifar_tpu_torch.tools.chaos_run --device cpu \\
      --mode sigkill
  python -m pytorch_cifar_tpu_torch.tools.chaos_run --device cpu \\
      --mode corrupt --corruption bitflip
  python -m pytorch_cifar_tpu_torch.tools.chaos_run --mode serve \\
      --model ResNet18 --epochs 2

The children run on the card unless ``--device cpu`` is given, which is
passed to every child; without a card the first child fails and so does
the drill. The children's sizes are the JAX drill's defaults (LeNet); on
the card give ``--model ResNet18`` and sizes at which a signal lands
inside a later epoch.

This process loads no torch and holds no device: it reads checkpoints
through ``serialization.py``, damages them through ``faults.py``,
publishes through ``train/checkpoint.py``'s staging helpers and drives
HTTP through ``serve/loadgen.py``. Only the children hold a CUDA context.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODES = ("sigterm", "sigkill", "corrupt", "nan", "serve", "ckpt", "canary",
         "edge", "mesh")


def module_cmd(module: str, *argv) -> list:
    """``python -m pytorch_cifar_tpu_torch.<module> argv...``."""
    return [sys.executable, "-m", f"pytorch_cifar_tpu_torch.{module}",
            *map(str, argv)]


def train_cmd(args, out_dir: str, resume: bool = False, extra=()):
    """The trainer child: one process (``--num_devices 1``: the CLI's
    default of every visible card would spawn ranks a signal to the
    launcher does not reach), fp32, the synthetic split."""
    cmd = module_cmd(
        "train",
        "--model", args.model,
        "--synthetic_data",
        "--synthetic_train_size", args.train_size,
        "--synthetic_test_size", args.test_size,
        "--batch_size", args.batch,
        "--epochs", args.epochs,
        "--lr", args.lr,
        "--no-amp",
        "--output_dir", out_dir,
        "--log_every", 1000000,
        "--seed", args.seed,
        "--sentinel", args.sentinel,
        "--device", args.device,
        "--num_devices", 1,
    )
    if resume:
        cmd.append("--resume")
    cmd.extend(extra)
    return cmd


def child_env(extra=None):
    env = dict(os.environ)
    env.update(extra or {})
    return env


def run_to_completion(cmd, env, timeout) -> float:
    t0 = time.monotonic()
    r = subprocess.run(
        cmd, env=env, capture_output=True, text=True, timeout=timeout,
        cwd=REPO,
    )
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-2000:] + "\n" + r.stderr[-4000:] + "\n")
        raise SystemExit(f"child failed rc={r.returncode}: {cmd}")
    return time.monotonic() - t0


def wait_for_checkpoint(out_dir: str, proc, timeout: float) -> None:
    """Block until the run has published its first best checkpoint (both
    payload and sidecar): the precondition for a recoverable kill."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            _, err = proc.communicate()
            raise SystemExit(
                f"training exited rc={proc.returncode} before its first "
                f"checkpoint:\n{err[-4000:]}"
            )
        if all(
            os.path.isfile(os.path.join(out_dir, n))
            for n in ("ckpt.msgpack", "ckpt.json")
        ):
            return
        time.sleep(0.2)
    proc.kill()
    proc.communicate()
    raise SystemExit("timed out waiting for the first checkpoint")


def interrupt_run(args, out_dir: str, sig, env=None, extra=()) -> int:
    """Launch training, let it publish a checkpoint, then signal it
    mid-run. Returns the child's exit code."""
    proc = subprocess.Popen(
        train_cmd(args, out_dir, extra=extra),
        env=env or child_env(),
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        cwd=REPO,
    )
    wait_for_checkpoint(out_dir, proc, args.timeout)
    time.sleep(args.kill_delay_s)  # land inside a later epoch, not the save
    if proc.poll() is None:
        proc.send_signal(sig)
    try:
        proc.communicate(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SystemExit(f"child ignored signal {sig}")
    return proc.returncode


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    else:
        out.append(np.asarray(tree))
    return out


def load_params(out_dir: str):
    """The best checkpoint's param leaves in sorted-key order, read by the
    port's msgpack codec."""
    from pytorch_cifar_tpu_torch.serialization import msgpack_restore

    with open(os.path.join(out_dir, "ckpt.msgpack"), "rb") as f:
        tree = msgpack_restore(f.read())
    return _leaves(tree["params"], [])


def load_meta(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "ckpt.json")) as f:
        return json.load(f)


def compare(dir_a: str, dir_b: str) -> dict:
    """The yardstick: the largest absolute difference of the two runs'
    best params (a NaN counts as infinite), whether ``dir_b``'s are
    finite, and both runs' best epoch and accuracy."""
    a, b = load_params(dir_a), load_params(dir_b)
    assert len(a) == len(b), (len(a), len(b))
    max_diff = 0.0
    finite = True
    for x, y in zip(a, b):
        finite &= bool(np.isfinite(y).all())
        d = np.abs(x.astype(np.float64) - y.astype(np.float64))
        # NaN anywhere counts as infinite divergence: Python's max() would
        # silently keep the old value (nan comparisons are False)
        d = np.where(np.isnan(d), np.inf, d)
        max_diff = max(max_diff, float(np.max(d)))
    ma, mb = load_meta(dir_a), load_meta(dir_b)
    return {
        "max_abs_diff": max_diff,
        "finite": finite,
        "best_epoch_ref": ma.get("epoch"),
        "best_epoch_chaos": mb.get("epoch"),
        "best_acc_ref": ma.get("best_acc"),
        "best_acc_chaos": mb.get("best_acc"),
    }


def _rounded(cmp: dict) -> dict:
    return {k: (round(v, 8) if isinstance(v, float) else v)
            for k, v in cmp.items()}


def _publish_checkpoint(src_dir: str, dst_dir: str) -> None:
    """Publish src_dir's best checkpoint into dst_dir the way the trainer
    does: payload first, then sidecar, each via tmp+rename, so a watcher
    polling dst_dir can never read a torn pair."""
    for name in ("ckpt.msgpack", "ckpt.json"):
        src = os.path.join(src_dir, name)
        dst = os.path.join(dst_dir, name)
        tmp = dst + f".tmp.{os.getpid()}"
        shutil.copyfile(src, tmp)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, dst)


def _serve_record(stdout: str):
    """The single JSON line the serving CLI prints on stdout (None if
    absent)."""
    rec = None
    for ln in stdout.splitlines():
        s = ln.strip()
        if s.startswith("{"):
            try:
                cand = json.loads(s)
            except ValueError:
                continue
            if isinstance(cand, dict) and "img_per_sec" in cand:
                rec = cand
    return rec


def _last_record(stdout: str, what: str) -> dict:
    """The last JSON line of a launcher's stdout."""
    rec = None
    for ln in stdout.splitlines():
        if ln.strip().startswith("{"):
            try:
                rec = json.loads(ln)
            except ValueError:
                continue
    if rec is None:
        raise SystemExit(f"{what} printed no JSON record")
    return rec


def _wait_for_stderr(proc, needle: str, timeout: float) -> str:
    """Consume proc.stderr lines until one contains ``needle``; returns
    everything read. Raises SystemExit on EOF/timeout (the child died or
    wedged before reaching the awaited phase)."""
    deadline = time.monotonic() + timeout
    seen = []
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            if proc.poll() is not None:
                raise SystemExit(
                    f"child exited rc={proc.returncode} before "
                    f"{needle!r}:\n" + "".join(seen)[-3000:]
                )
            time.sleep(0.05)
            continue
        seen.append(line)
        if needle in line:
            return "".join(seen)
    proc.kill()
    raise SystemExit(f"timed out waiting for {needle!r} on the child's "
                     "stderr")


def _drain_stderr(proc, name: str) -> threading.Thread:
    """Forward the rest of a child's stderr to ours, on a thread."""
    t = threading.Thread(
        target=lambda: [sys.stderr.write(ln) for ln in proc.stderr],
        name=name, daemon=True,
    )
    t.start()
    return t


def serve_drill(args, work: str) -> dict:
    """The serving drill (module docstring): hot reload under load, then
    SIGKILL under load, then a relaunch onto the new checkpoint. Each
    serving process's record is forwarded on stderr as ``[serve phase N]
    {...}``."""
    # the serving children's dtype is the fleet replicas' (bf16 on the
    # card, fp32 on the CPU)
    from pytorch_cifar_tpu_torch.serve.fleet import REPLICA_DTYPE

    dir_a = os.path.join(work, "ckpt_a")
    dir_b = os.path.join(work, "ckpt_b")
    serve_dir = os.path.join(work, "serving")
    os.makedirs(serve_dir, exist_ok=True)
    env = child_env()

    def serve_cmd(watch: bool, clients: int, requests: int,
                  duration_s: float = 0.0):
        cmd = module_cmd(
            "serve",
            "--ckpt", serve_dir,
            "--model", args.model,
            "--buckets", 1, 4, 8,
            "--clients", clients,
            "--requests", requests,
            "--poll_s", 0.2,
            "--device", args.device,
            "--dtype", REPLICA_DTYPE[args.device],
            "--num_devices", args.serve_devices,
        )
        if duration_s:
            cmd += ["--duration_s", str(duration_s)]
        if watch:
            cmd.append("--watch")
        return cmd

    # two distinct checkpoints: A is served first, B is published into
    # the watched dir mid-load (different seed -> different weights)
    print(f"==> [serve] training checkpoint A -> {dir_a}", file=sys.stderr)
    run_to_completion(train_cmd(args, dir_a), env, args.timeout)
    args_b = argparse.Namespace(**{**vars(args), "seed": args.seed + 1})
    print(f"==> [serve] training checkpoint B -> {dir_b}", file=sys.stderr)
    run_to_completion(train_cmd(args_b, dir_b), env, args.timeout)
    epoch_b = load_meta(dir_b)["epoch"]
    _publish_checkpoint(dir_a, serve_dir)

    # phase 1: hot reload under load; the watcher must pick up B while
    # the clients hammer the engine, without a failed request
    print("==> [serve] phase 1: hot-reload under load", file=sys.stderr)
    proc = subprocess.Popen(
        serve_cmd(watch=True, clients=4, requests=10**6, duration_s=8.0),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO,
    )
    t1 = time.monotonic()
    _wait_for_stderr(proc, "watching", args.timeout)
    time.sleep(0.5)  # load is now running against checkpoint A
    _publish_checkpoint(dir_b, serve_dir)
    try:
        out, err = proc.communicate(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SystemExit("phase-1 serve run did not finish")
    phase1_s = time.monotonic() - t1
    rec1 = _serve_record(out)
    if proc.returncode != 0 or rec1 is None:
        sys.stderr.write(err[-4000:])
        raise SystemExit(f"phase-1 serve run failed rc={proc.returncode}")
    print(f"[serve phase 1] {json.dumps(rec1)}", file=sys.stderr)

    # phase 2: a serving process dies hard under load; the drill only
    # requires that this never corrupts the watched dir
    print("==> [serve] phase 2: SIGKILL under load", file=sys.stderr)
    proc = subprocess.Popen(
        serve_cmd(watch=True, clients=2, requests=10**6, duration_s=60.0),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO,
    )
    _wait_for_stderr(proc, "watching", args.timeout)
    time.sleep(args.kill_delay_s)
    proc.send_signal(signal.SIGKILL)
    proc.communicate(timeout=args.timeout)
    killed_rc = proc.returncode

    # phase 3: recovery; a fresh server must come up on the new best
    # checkpoint (B), its compile count pinned
    print("==> [serve] phase 3: relaunch + verify", file=sys.stderr)
    t0 = time.monotonic()
    r = subprocess.run(
        serve_cmd(watch=False, clients=2, requests=4),
        env=env, capture_output=True, text=True, timeout=args.timeout,
        cwd=REPO,
    )
    recovery_s = time.monotonic() - t0
    rec3 = _serve_record(r.stdout)
    if r.returncode != 0 or rec3 is None:
        sys.stderr.write(r.stderr[-4000:])
        raise SystemExit(f"phase-3 serve run failed rc={r.returncode}")
    print(f"[serve phase 3] {json.dumps(rec3)}", file=sys.stderr)

    ok = (
        rec1["reloads"] >= 1
        and rec1["failed"] == 0
        and rec1["requests"] > 0
        and rec1["n_devices"] == args.serve_devices
        and killed_rc == -int(signal.SIGKILL)
        and rec3["ckpt_epoch"] == epoch_b
        and rec3["n_devices"] == args.serve_devices
        and rec3["compiles"] == len(rec3["buckets"])
        and rec3["requests"] > 0
    )
    return {
        "harness": "chaos_run",
        "mode": "serve",
        "match": ok,
        "reference_s": round(phase1_s, 2),
        "recovery_s": round(recovery_s, 2),
        "reloads": rec1["reloads"],
        "hedged": rec1["hedged"],
        "n_devices": rec3["n_devices"],
        "ckpt_epoch_published": epoch_b,
        "ckpt_epoch_served": rec3["ckpt_epoch"],
        "compiles": rec3["compiles"],
        "killed_rc": killed_rc,
    }


def edge_drill(args, work: str) -> dict:
    """The event-loop edge drill: the two resource-exhaustion attacks the
    edge's protections exist for (a slow-loris trickle and a hold-open
    connection flood) and a replica SIGKILL, against an ``--edge event``
    fleet under open-loop mixed-wire load (32 logical connections, one
    thread).

    Phases:
      0. fleet up: router_run --edge event spawns 2 replicas; /predict
         bits probed across replica 0, replica 1 and the router, each in
         JSON and binary.
      1. steady: async load -> p99_steady, zero failures.
      2. slow-loris: one header byte per 0.5 s at the router's edge while
         the load runs; the per-connection read deadline (10 s) must
         close the attacker mid-trickle, and the foreground must not
         drop a request.
      3. conn-flood: 256 hold-open sockets against the same edge under
         load, absorbed on the loop thread, foreground failed == 0.
      4. kill: SIGKILL replica 0 mid-load -> bounded loss, eviction.
      5. drain: SIGTERM to router_run must exit 0 with its JSON record.
    """
    import urllib.request

    from pytorch_cifar_tpu_torch import faults
    from pytorch_cifar_tpu_torch.serve.loadgen import (
        HttpTarget,
        run_async_load,
    )

    ckpt_dir = os.path.join(work, "ckpt")
    print(f"==> [edge] training checkpoint -> {ckpt_dir}", file=sys.stderr)
    run_to_completion(train_cmd(args, ckpt_dir), child_env(), args.timeout)

    cmd = module_cmd(
        "tools.router_run",
        "--ckpt", ckpt_dir,
        "--model", args.model,
        "--replicas", 2,
        "--buckets", 1, 4, 8,
        "--aot_cache", os.path.join(work, "aot"),
        "--deadline_ms", 2000,
        "--probe_s", 0.2,
        "--max_wait_ms", 1,
        "--edge", "event",
        "--device", args.device,
    )
    print("==> [edge] fleet up (--edge event)", file=sys.stderr)
    proc = subprocess.Popen(
        cmd, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO,
    )

    replica_re = re.compile(r"==> replica (\d+) pid=(\d+) url=(\S+)")
    router_re = re.compile(r"==> router: serving on (\S+)")
    replicas = {}
    router_url = None
    deadline = time.monotonic() + args.timeout
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            if proc.poll() is not None:
                raise SystemExit(
                    f"router_run exited rc={proc.returncode} before the "
                    "router came up"
                )
            time.sleep(0.05)
            continue
        sys.stderr.write(line)
        m = replica_re.search(line)
        if m:
            replicas[int(m.group(1))] = (int(m.group(2)), m.group(3))
        m = router_re.search(line)
        if m:
            router_url = m.group(1)
            break
    if router_url is None or len(replicas) != 2:
        proc.kill()
        raise SystemExit("timed out waiting for the fleet topology")
    drain_t = _drain_stderr(proc, "edge-stderr-drain")

    host, port = router_url.split("//", 1)[1].split(":")
    port = int(port)

    def edge_counter(name: str) -> float:
        """One pct_serve_edge_* counter off the live /metrics page."""
        with urllib.request.urlopen(router_url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        for ln in text.splitlines():
            if ln.startswith(name + " "):
                return float(ln.rsplit(" ", 1)[-1])
        return 0.0

    # the same bits across the fleet and across encodings: the replicas'
    # frontends, the router's EdgePool transport and the router's own
    # event frontend must all return byte-equal logits
    probe = np.random.RandomState(7).randint(
        0, 256, size=(3, 32, 32, 3)
    ).astype(np.uint8)
    outs = [
        HttpTarget(u, wire=w).submit(probe).result()
        for u in (replicas[0][1], replicas[1][1], router_url)
        for w in ("json", "binary")
    ]
    bit_identical = all(np.array_equal(outs[0], o) for o in outs[1:])

    def load_phase(tag, duration_s, seed):
        rep = run_async_load(
            router_url,
            clients=32,
            requests_per_client=10**6,
            images_max=4,
            wire="mixed",
            seed=seed,
            duration_s=duration_s,
            bulk_fraction=0.3,
        )
        print(
            f"==> [edge] {tag}: {rep['requests']} reqs "
            f"p99={rep['p99_ms']:.1f}ms hedged={rep['hedged']} "
            f"failed={rep['failed']}", file=sys.stderr,
        )
        return rep

    print("==> [edge] phase 1: steady state (32 async clients)",
          file=sys.stderr)
    steady = load_phase("steady", 5.0, seed=1)

    print("==> [edge] phase 2: slow-loris under load", file=sys.stderr)
    loris_result = {}

    def loris():
        # the edge's read deadline is 10 s: trickle past it and the edge
        # must reset us mid-trickle
        loris_result.update(faults.slow_loris(
            host, port, duration_s=14.0, interval_s=0.5,
        ))

    loris_t = threading.Thread(target=loris, name="slow-loris")
    loris_t.start()
    loris_fg = load_phase("loris-foreground", 15.0, seed=2)
    loris_t.join(timeout=30)
    loris_closed = edge_counter("pct_serve_edge_loris_closed")

    print("==> [edge] phase 3: conn-flood under load", file=sys.stderr)
    flood_result = {}

    def flood():
        flood_result.update(faults.conn_flood(
            host, port, connections=256, hold_s=2.0,
        ))

    flood_t = threading.Thread(target=flood, name="conn-flood")
    flood_t.start()
    flood_fg = load_phase("flood-foreground", 5.0, seed=3)
    flood_t.join(timeout=30)

    print("==> [edge] phase 4: SIGKILL replica 0 under load",
          file=sys.stderr)
    kill_at = threading.Timer(
        2.0, os.kill, (replicas[0][0], signal.SIGKILL)
    )
    kill_at.start()
    killed = load_phase("kill", 6.0, seed=4)
    kill_at.join()

    print("==> [edge] phase 5: drain", file=sys.stderr)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=args.timeout)
    drain_t.join(timeout=10)
    rec_run = _last_record(out, "router_run")

    # the verdict: both attacks bounded (attacker closed by the server,
    # zero foreground failures while each ran), bounded loss during the
    # kill window only, eviction happened, clean drain
    loss_bound = killed["failed"] <= max(4, killed["requests"] // 20)
    ok = (
        proc.returncode == 0
        and bit_identical
        and steady["requests"] > 0
        and steady["failed"] == 0
        and loris_result.get("closed_by_server") == 1
        and loris_closed >= 1
        and loris_fg["failed"] == 0
        and flood_result.get("opened", 0) >= 200
        and flood_result.get("refused", 0) == 0
        and flood_fg["failed"] == 0
        and killed["requests"] > 0
        and loss_bound
        and rec_run["router"]["evictions"] >= 1
    )
    return {
        "harness": "chaos_run",
        "mode": "edge",
        "match": ok,
        "transport": rec_run["router"].get("transport"),
        "bit_identical": bit_identical,
        "wire": "mixed",
        "p99_steady_ms": round(steady["p99_ms"], 2),
        "p99_loris_ms": round(loris_fg["p99_ms"], 2),
        "p99_flood_ms": round(flood_fg["p99_ms"], 2),
        "p99_kill_ms": round(killed["p99_ms"], 2),
        "requests": steady["requests"] + loris_fg["requests"]
        + flood_fg["requests"] + killed["requests"],
        "loris": loris_result,
        "loris_closed_counter": loris_closed,
        "flood": flood_result,
        "failed_during_loris": loris_fg["failed"],
        "failed_during_flood": flood_fg["failed"],
        "failed_during_kill": killed["failed"],
        "hedged_during_kill": killed["hedged"],
        "evictions": rec_run["router"]["evictions"],
        "router_rc": proc.returncode,
    }


def mesh_drill(args, work: str) -> dict:
    """The multi-process replica drill: SIGKILL one FOLLOWER rank of a
    live 2-process replica under load.

    Phases:
      0. fleet up: router_run --replicas 2 --mesh_procs 2 (each logical
         replica a leader and a follower rank; on the CPU two logical
         shards a rank, on the card the visible cards shared out) on a
         shared cold-start cache, so replica 1 joins with compiles == 0
         on every rank; and one one-process serving CLI as the bit
         reference.
      1. bits: one payload in both wire encodings to replica 0's leader,
         replica 1's leader, the reference and the router, all byte-equal.
      2. steady state: closed-loop mixed-wire load on the router.
      3. kill: replica 0's follower SIGKILLed mid-load. Its leader must
         exit rc 70 within --mesh_timeout_s (never hang); the router must
         evict the logical replica and hedge its requests: no failed
         request.
      4. load on the survivor, then a SIGTERM drain: router_run exits 0;
         the exit codes say who died of what (leader 70, follower -9,
         replica 1 clean).
    """
    import urllib.request

    from pytorch_cifar_tpu_torch.serve.fleet import REPLICA_DTYPE
    from pytorch_cifar_tpu_torch.serve.loadgen import HttpTarget, run_load

    peer_timeout_rc = 70  # serve/mesh_replica.PEER_TIMEOUT_RC (no torch)
    ckpt_dir = os.path.join(work, "ckpt")
    print(f"==> [mesh] training checkpoint -> {ckpt_dir}", file=sys.stderr)
    run_to_completion(train_cmd(args, ckpt_dir), child_env(), args.timeout)

    mesh_timeout_s = 6.0
    cmd = module_cmd(
        "tools.router_run",
        "--ckpt", ckpt_dir,
        "--model", args.model,
        "--replicas", 2,
        "--mesh_procs", 2,
        "--mesh_timeout_s", mesh_timeout_s,
        # two logical shards a rank on the CPU (JAX's drill forces two
        # CPU devices a rank); on the card every visible card, shared out
        "--replica_devices", 4 if args.device == "cpu" else 0,
        "--buckets", 1, 4, 8,
        "--aot_cache", os.path.join(work, "aot"),
        "--deadline_ms", 2000,
        "--probe_s", 0.2,
        "--max_wait_ms", 1,
        "--device", args.device,
    )
    print("==> [mesh] fleet up (2 logical replicas x 2 processes)",
          file=sys.stderr)
    proc = subprocess.Popen(
        cmd, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO,
    )
    leader_re = re.compile(r"==> replica (\d+) pid=(\d+) url=(\S+)")
    follower_re = re.compile(r"==> replica (\d+) follower rank=(\d+) "
                             r"pid=(\d+)")
    router_re = re.compile(r"==> router: serving on (\S+)")
    leaders, followers = {}, {}
    router_url = None
    deadline = time.monotonic() + args.timeout
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            if proc.poll() is not None:
                raise SystemExit(
                    f"router_run exited rc={proc.returncode} before the "
                    "router came up")
            time.sleep(0.05)
            continue
        sys.stderr.write(line)
        m = leader_re.search(line)
        if m:
            leaders[int(m.group(1))] = (int(m.group(2)), m.group(3))
        m = follower_re.search(line)
        if m:
            followers[int(m.group(1))] = int(m.group(3))
        m = router_re.search(line)
        if m:
            router_url = m.group(1)
            break
    if router_url is None or len(leaders) != 2 or len(followers) != 2:
        proc.kill()
        raise SystemExit("timed out waiting for the mesh fleet topology")
    drain_t = _drain_stderr(proc, "mesh-stderr-drain")

    # the one-process bit reference
    ref = subprocess.Popen(
        module_cmd("serve", "--ckpt", ckpt_dir, "--model", args.model,
                   "--buckets", 1, 4, 8, "--http_port", 0,
                   "--device", args.device,
                   "--dtype", REPLICA_DTYPE[args.device]),
        env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO,
    )
    seen = _wait_for_stderr(ref, "==> http: serving on", args.timeout)
    ref_url = re.search(r"==> http: serving on (\S+)", seen).group(1)
    ref_drain = _drain_stderr(ref, "mesh-ref-stderr-drain")

    def healthz(url):
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            return json.load(r)

    h1 = healthz(leaders[1][1])
    warm_compiles = int(h1.get("compiles", -1))
    mesh_block = h1.get("mesh") or {}

    probe = np.random.RandomState(7).randint(
        0, 256, size=(3, 32, 32, 3)).astype(np.uint8)
    outs = []
    for u in (leaders[0][1], leaders[1][1], ref_url, router_url):
        for w in ("json", "binary"):
            t = HttpTarget(u, wire=w)
            try:
                outs.append(t.submit(probe).result(timeout=60))
            finally:
                t.close()
    bit_identical = all(np.array_equal(outs[0], o) for o in outs[1:])

    def load_phase(tag, duration_s, seed):
        target = HttpTarget(router_url, wire="mixed")
        try:
            rep = run_load(
                target, clients=4, requests_per_client=10**6,
                images_max=4, seed=seed, duration_s=duration_s,
                # all interactive: a bulk 429 reaches its client by
                # design, and the bar here is no client-visible error
                bulk_fraction=0.0,
            )
        finally:
            target.close()
        print(f"==> [mesh] {tag}: {rep['requests']} reqs "
              f"p99={rep['p99_ms']:.1f}ms hedged={rep['hedged']} "
              f"failed={rep['failed']}", file=sys.stderr)
        return rep

    print("==> [mesh] phase 1: steady state", file=sys.stderr)
    steady = load_phase("steady", 5.0, seed=1)

    print(f"==> [mesh] phase 2: SIGKILL replica 0 follower "
          f"(pid {followers[0]}) under load", file=sys.stderr)
    # the leader's watchdog (or its collective's timeout) must turn the
    # dead peer into a process exit within the bound: timed by a poller
    # that starts with the SIGKILL, beside the load
    detection = {"s": None}

    def kill_and_time_detection():
        t0 = time.monotonic()
        os.kill(followers[0], signal.SIGKILL)
        deadline_d = t0 + mesh_timeout_s + 10.0
        while time.monotonic() < deadline_d:
            try:
                healthz(leaders[0][1])
                time.sleep(0.25)
            except (OSError, ValueError):
                detection["s"] = time.monotonic() - t0
                return

    kill_at = threading.Timer(2.0, kill_and_time_detection)
    kill_at.start()
    killed = load_phase("kill", 4.0 + 2.0 * mesh_timeout_s, seed=2)
    kill_at.join()
    detection_s = detection["s"]

    print("==> [mesh] phase 3: post-evict steady state", file=sys.stderr)
    post = load_phase("post-evict", 5.0, seed=3)
    healthy_after = int(healthz(router_url).get("healthy_replicas", -1))

    print("==> [mesh] phase 4: drain", file=sys.stderr)
    proc.send_signal(signal.SIGTERM)
    ref.send_signal(signal.SIGTERM)
    # stdout only: each stderr is read to its end by its drain thread
    out = proc.stdout.read()
    proc.wait(timeout=args.timeout)
    drain_t.join(timeout=10)
    ref.stdout.read()
    ref.wait(timeout=60)
    ref_drain.join(timeout=10)
    rec_run = _last_record(out, "router_run")

    leader_rc = rec_run["replica_rcs"][0]
    follower_rcs = rec_run["follower_rcs"]
    ok = (
        proc.returncode == 0
        and warm_compiles == 0
        and mesh_block.get("process_count") == 2
        and mesh_block.get("barrier_generation") == 1
        and bit_identical
        and steady["requests"] > 0
        and killed["requests"] > 0
        and post["requests"] > 0
        and steady["failed"] == 0
        and killed["failed"] == 0
        and post["failed"] == 0
        and detection_s is not None
        and leader_rc == peer_timeout_rc
        and follower_rcs[0][0] == -int(signal.SIGKILL)
        and rec_run["replica_rcs"][1] == 0
        and follower_rcs[1][0] == 0
        and healthy_after == 1
        and rec_run["router"]["evictions"] >= 1
    )
    return {
        "harness": "chaos_run",
        "mode": "mesh",
        "match": ok,
        "mesh_procs": 2,
        "mesh_timeout_s": mesh_timeout_s,
        "reference_s": round(steady["elapsed_s"], 2),
        "detection_s": round(detection_s, 2) if detection_s else None,
        "warm_replica_compiles": warm_compiles,
        "mesh_health": mesh_block,
        "bit_identical": bit_identical,
        "wire": "mixed",
        "requests": steady["requests"] + killed["requests"]
        + post["requests"],
        "failed": steady["failed"] + killed["failed"] + post["failed"],
        "hedged_during_kill": killed["hedged"],
        "p99_steady_ms": round(steady["p99_ms"], 2),
        "p99_post_ms": round(post["p99_ms"], 2),
        "leader_rc": leader_rc,
        "follower_rcs": follower_rcs,
        "healthy_after": healthy_after,
        "evictions": rec_run["router"]["evictions"],
        "router_hedged": rec_run["router"]["hedged"],
        "router_rc": proc.returncode,
    }


def canary_drill(args, work: str) -> dict:
    """The promotion-pipeline drill.

    Phases:
      0. train checkpoint A (epochs=E) and B (epochs=E+3, same seed and
         cosine horizon: the same trajectory continued, so B's best_acc
         >= A's); publish A into the live dir; start ``pipeline_run
         --epochs 0`` (serve + canary, empty staging) and record the
         fleet's pre-drill /predict bits.
      1-3. under sustained mixed-priority load, stage a NaN'd B, a
         bit-flipped B and a weight-regressed B: each must be quarantined
         in canary (tombstone down, /predict bits as in phase 0, served
         epoch and promotion generation unchanged).
      4. stage the real B: it must promote (the live sidecar carries B's
         epoch and the next generation, the watcher hot-loads it, and
         /predict switches to B's answers).
      5. drain (SIGTERM): pipeline_run must exit 0 with rejected == 3,
         promotions == 1, and no failed client request.
    """
    import urllib.request

    from pytorch_cifar_tpu_torch import faults
    from pytorch_cifar_tpu_torch.serve.loadgen import HttpTarget
    from pytorch_cifar_tpu_torch.train.checkpoint import (
        ensure_staging_dir,
        publish_checkpoint,
        quarantine_path,
        read_quarantine,
    )

    dir_a = os.path.join(work, "ckpt_a")
    dir_b = os.path.join(work, "ckpt_b")
    live = os.path.join(work, "pipeline")
    os.makedirs(live, exist_ok=True)
    staging = ensure_staging_dir(live)

    # B must be a genuine improvement over A or the promotion phase
    # proves nothing: both runs share one cosine schedule (t_max), so A
    # is an exact prefix of B's trajectory and B's extra epochs can only
    # find a better best; the default lr is raised to leave accuracy
    # headroom at these sizes (0.02 barely moves off chance)
    t_max = args.epochs + 3
    args_a = argparse.Namespace(
        **{**vars(args), "lr": 0.05 if args.lr == 0.02 else args.lr}
    )
    args_b = argparse.Namespace(
        **{**vars(args_a), "epochs": args.epochs + 3}
    )
    extra = ("--cosine_t_max", str(t_max))
    print(f"==> [canary] training checkpoint A -> {dir_a}", file=sys.stderr)
    run_to_completion(
        train_cmd(args_a, dir_a, extra=extra), child_env(), args.timeout
    )
    print(
        f"==> [canary] training checkpoint B (+3 epochs) -> {dir_b}",
        file=sys.stderr,
    )
    run_to_completion(
        train_cmd(args_b, dir_b, extra=extra), child_env(), args.timeout
    )
    epoch_a = load_meta(dir_a)["epoch"]
    epoch_b = load_meta(dir_b)["epoch"]
    if epoch_b <= epoch_a or compare(dir_a, dir_b)["max_abs_diff"] == 0.0:
        raise SystemExit(
            f"checkpoint B (best epoch {epoch_b}) is not a genuine "
            f"improvement over A (best epoch {epoch_a}); rerun with "
            "--epochs/--lr that leave accuracy headroom"
        )
    publish_checkpoint(dir_a, live)

    print("==> [canary] pipeline up (serve-only)", file=sys.stderr)
    proc = subprocess.Popen(
        module_cmd(
            "tools.pipeline_run",
            "--ckpt", live,
            "--model", args.model,
            "--epochs", 0,
            "--train-size", args.train_size,
            "--test-size", args.test_size,
            "--buckets", 1, 4, 8,
            "--poll_s", 0.2,
            "--golden", "eval",
            "--shadow_fraction", 0.5,
            "--acc_margin", 2.0,
            "--device", args.device,
        ),
        env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO,
    )
    out_err = _wait_for_stderr(proc, "pipeline: serving on", args.timeout)
    url = re.search(r"pipeline: serving on (\S+)", out_err).group(1)
    drain_t = _drain_stderr(proc, "pipeline-stderr-drain")

    def healthz():
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            return json.load(r)

    probe = np.random.RandomState(11).randint(
        0, 256, size=(3, 32, 32, 3)
    ).astype(np.uint8)

    def predict_bits():
        return HttpTarget(url).submit(probe).result()

    pre = predict_bits()
    h0 = healthz()
    gen0 = h0.get("promotion_generation")

    # sustained mixed-priority load for the whole drill (a failure in
    # `failed` is client-visible: the drill demands zero)
    stop_load = threading.Event()
    load_counts = {"requests": 0, "failed": 0, "bulk": 0}
    load_lock = threading.Lock()

    def load_client(cid):
        target = HttpTarget(url)
        rs = np.random.RandomState(100 + cid)
        while not stop_load.is_set():
            n = int(rs.randint(1, 5))
            x = rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)
            bulk = rs.uniform() < 0.3
            with load_lock:
                load_counts["bulk"] += 1 if bulk else 0
            try:
                target.submit(
                    x, priority="bulk" if bulk else "interactive"
                ).result()
                with load_lock:
                    load_counts["requests"] += 1
            except Exception:
                if not stop_load.is_set():
                    with load_lock:
                        load_counts["failed"] += 1
        target.close()

    load_threads = [
        threading.Thread(target=load_client, args=(i,), daemon=True)
        for i in range(3)
    ]
    for t in load_threads:
        t.start()

    def bitflip(d):
        faults.bitflip_file(os.path.join(d, "ckpt.msgpack"))

    def stage(corrupt=None):
        """Publish B's checkpoint into staging, corrupted first in a
        scratch copy when asked (the corruption must land before the
        staging commit: the canary polls continuously)."""
        scratch = os.path.join(work, "scratch")
        shutil.rmtree(scratch, ignore_errors=True)
        os.makedirs(scratch)
        publish_checkpoint(dir_b, scratch)
        if corrupt is not None:
            corrupt(scratch)
        if corrupt is bitflip:
            # a bit-flipped payload no longer matches its manifest, so the
            # verified promote path cannot move it: publish raw (payload
            # first, sidecar last), exactly what a buggy writer would do
            for name in ("ckpt.msgpack", "ckpt.json"):
                src, dst = (
                    os.path.join(scratch, name), os.path.join(staging, name)
                )
                tmp = dst + ".tmp"
                shutil.copyfile(src, tmp)
                with open(tmp, "rb") as f:
                    os.fsync(f.fileno())
                os.replace(tmp, dst)
        else:
            publish_checkpoint(scratch, staging)

    def wait_for_tombstone(tag, timeout=60.0):
        deadline = time.monotonic() + timeout
        path = quarantine_path(staging, "ckpt.msgpack")
        while time.monotonic() < deadline:
            # the drill deleted the previous phase's tombstone, so any
            # tombstone here is this phase's verdict
            tomb = read_quarantine(staging, "ckpt.msgpack")
            if tomb is not None:
                return tomb
            if proc.poll() is not None:
                raise SystemExit(
                    f"pipeline_run died (rc={proc.returncode}) during "
                    f"{tag}"
                )
            time.sleep(0.2)
        raise SystemExit(f"timed out waiting for {tag} quarantine ({path})")

    verdicts = {}
    phases = [
        ("nan", lambda d: faults.regress_checkpoint(d, nan=True)),
        ("bitflip", bitflip),
        ("regress", lambda d: faults.regress_checkpoint(d, scale=2.0)),
    ]
    for tag, corrupt in phases:
        # clear the previous tombstone so "a tombstone exists" is
        # unambiguous evidence for this phase
        try:
            os.remove(quarantine_path(staging, "ckpt.msgpack"))
        except OSError:
            pass
        print(f"==> [canary] staging {tag} candidate", file=sys.stderr)
        stage(corrupt)
        tomb = wait_for_tombstone(tag)
        h = healthz()
        bits_ok = bool(np.array_equal(predict_bits(), pre))
        verdicts[tag] = {
            "quarantined": True,
            "reason": tomb.get("reason"),
            "fleet_bits_identical": bits_ok,
            "served_epoch": h.get("ckpt_epoch"),
            "generation": h.get("promotion_generation"),
        }
        print(
            f"==> [canary] {tag}: quarantined ({tomb.get('reason')!r}), "
            f"fleet bits identical={bits_ok}", file=sys.stderr,
        )

    print("==> [canary] staging the GOOD candidate (B)", file=sys.stderr)
    stage()
    deadline = time.monotonic() + 60.0
    promoted = False
    while time.monotonic() < deadline:
        h = healthz()
        # promotion evidence: the generation stamp appears and the
        # watcher hot-loaded B (the healthz epoch tracks the live sidecar)
        if (
            h.get("promotion_generation") not in (None, gen0)
            and h.get("ckpt_epoch") == epoch_b
        ):
            promoted = True
            break
        if proc.poll() is not None:
            raise SystemExit(
                f"pipeline_run died (rc={proc.returncode}) before the "
                "good candidate promoted"
            )
        time.sleep(0.2)
    post = predict_bits()
    h_final = healthz()

    print("==> [canary] draining", file=sys.stderr)
    stop_load.set()
    for t in load_threads:
        t.join(timeout=30)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=args.timeout)
    drain_t.join(timeout=10)
    rec_run = _last_record(out, "pipeline_run")

    bad_contained = all(
        v["quarantined"]
        and v["fleet_bits_identical"]
        and v["served_epoch"] == epoch_a
        and v["generation"] == gen0
        for v in verdicts.values()
    )
    ok = (
        proc.returncode == 0
        and bad_contained
        and promoted
        and h_final.get("ckpt_epoch") == epoch_b
        and h_final.get("promotion_generation") not in (None, gen0)
        and not np.array_equal(post, pre)  # B's weights actually serve
        and rec_run["rejected"] == 3
        and rec_run["promotions"] == 1
        and load_counts["requests"] > 0
        and load_counts["failed"] == 0
        and load_counts["bulk"] > 0
    )
    return {
        "harness": "chaos_run",
        "mode": "canary",
        "match": ok,
        "epoch_incumbent": epoch_a,
        "epoch_candidate": epoch_b,
        "bad_candidates_contained": bad_contained,
        "verdicts": verdicts,
        "promoted": promoted,
        "final_epoch": h_final.get("ckpt_epoch"),
        "final_generation": h_final.get("promotion_generation"),
        "rejected": rec_run["rejected"],
        "promotions": rec_run["promotions"],
        "requests": load_counts["requests"],
        "failed": load_counts["failed"],
        "bulk_requests": load_counts["bulk"],
        "pipeline_rc": proc.returncode,
    }


# the torn-v3 helper child of the ckpt drill: a fresh state of the model,
# saved as a 4-shard v3 preemption save at epoch 9 (argv: dir, model,
# device)
TORN_V3_HELPER = """\
import sys
import torch
from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.train.checkpoint import LAST_NAME, save_checkpoint
from pytorch_cifar_tpu_torch.train.optim import (
    cosine_epoch_schedule, make_optimizer)
from pytorch_cifar_tpu_torch.train.state import create_train_state
out_dir, model_name, device = sys.argv[1:4]
dev = resolve_device(device)
model = create_model(
    model_name, generator=torch.Generator().manual_seed(99)).to(dev)
state = create_train_state(
    model, make_optimizer(model.parameters(), lr=0.1),
    cosine_epoch_schedule(0.1, 3, 4), seed=99, device=dev)
save_checkpoint(out_dir, state, epoch=9, best_acc=99.0, name=LAST_NAME,
                num_shards=4)
"""


def _inspect(ckpt_dir: str) -> int:
    """``ckpt_inspect``'s verdict for ``ckpt_dir`` (its exit code)."""
    r = subprocess.run(
        module_cmd("tools.ckpt_inspect", ckpt_dir),
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    sys.stderr.write(r.stdout[-1500:])
    return r.returncode


def ckpt_drill(args, work: str) -> dict:
    """The checkpoint drill:

    1. SIGKILL mid-async-save: ``ckpt_write_stall`` stalls every commit
       between the payload and its sidecar, and the run saves on every
       improvement (``--checkpoint_every 0``), so the kill lands inside
       the torn-pair window with high probability; ``--resume`` must
       restore the newest complete checkpoint and re-run the lost epochs
       to the reference result.
    2. Torn v3 mid-shard-write: a newer sharded preemption save is
       published and one shard truncated (the deterministic equivalent
       of a kill mid-shard-write with the commit marker already down);
       ``ckpt_inspect`` must flag it, the resume must fall back past it
       (never restoring torn v3 bytes), and the final state must still
       match the reference run.
    """
    from pytorch_cifar_tpu_torch import faults

    dir_ref = os.path.join(work, "reference")
    dir_chaos = os.path.join(work, "chaos")

    print(f"==> [ckpt] reference run -> {dir_ref}", file=sys.stderr)
    ref_s = run_to_completion(
        train_cmd(args, dir_ref), child_env(), args.timeout
    )

    # phase 1: SIGKILL mid-async-save (stalled commit window)
    print(
        f"==> [ckpt] stalled-writer run -> {dir_chaos} "
        "(save every epoch, commits stalled)", file=sys.stderr,
    )
    killed_rc = interrupt_run(
        args, dir_chaos, signal.SIGKILL,
        env=child_env({"PCT_FAULTS": "ckpt_write_stall=800"}),
        extra=("--checkpoint_every", "0"),
    )
    print(f"==> [ckpt] resuming {dir_chaos}", file=sys.stderr)
    t0 = time.monotonic()
    run_to_completion(
        train_cmd(args, dir_chaos, resume=True), child_env(), args.timeout
    )
    recovery_s = time.monotonic() - t0

    # phase 2: torn v3, a newer sharded preemption save with a truncated
    # shard (commit marker intact, so only manifest verification can
    # reject it); the resume order prefers it by epoch
    r = subprocess.run(
        [sys.executable, "-c", TORN_V3_HELPER, dir_chaos, args.model,
         args.device],
        env=child_env(), capture_output=True, text=True,
        timeout=args.timeout, cwd=REPO,
    )
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-3000:])
        raise SystemExit("torn-v3 helper failed")
    victim = os.path.join(dir_chaos, "last.shard00002-of-00004.msgpack")
    faults.truncate_file(victim)
    print(f"==> [ckpt] truncated {victim}", file=sys.stderr)
    inspect_rc_torn = _inspect(dir_chaos)  # must flag the torn shard

    print("==> [ckpt] resuming past the torn v3 save", file=sys.stderr)
    rr = subprocess.run(
        train_cmd(args, dir_chaos, resume=True),
        env=child_env(), capture_output=True, text=True,
        timeout=args.timeout, cwd=REPO,
    )
    if rr.returncode != 0:
        sys.stderr.write(rr.stdout[-2000:] + "\n" + rr.stderr[-4000:])
        raise SystemExit(f"torn-v3 resume failed rc={rr.returncode}")
    torn_rejected = (
        "is corrupt" in rr.stderr and "falling back" in rr.stderr
    )
    inspect_rc_after = _inspect(dir_chaos)  # stale last removed; clean

    cmp = compare(dir_ref, dir_chaos)
    tol = args.tol if args.tol is not None else 1e-6
    ok = (
        cmp["finite"]
        and cmp["max_abs_diff"] <= tol
        and cmp["best_epoch_ref"] == cmp["best_epoch_chaos"]
        and killed_rc == -int(signal.SIGKILL)
        and inspect_rc_torn == 1
        and torn_rejected
        and inspect_rc_after == 0
    )
    return {
        "harness": "chaos_run",
        "mode": "ckpt",
        "match": ok,
        "tol": tol,
        "reference_s": round(ref_s, 2),
        "recovery_s": round(recovery_s, 2),
        "killed_rc": killed_rc,
        "inspect_rc_torn": inspect_rc_torn,
        "inspect_rc_after": inspect_rc_after,
        "torn_v3_rejected": torn_rejected,
        **_rounded(cmp),
    }


def trainer_drill(args, work: str, tol: float) -> dict:
    """The trainer modes (sigterm, sigkill, corrupt, nan): a reference
    run, the chaos run (signalled, or its preemption save damaged, or a
    step poisoned), its resume, and the yardstick."""
    from pytorch_cifar_tpu_torch import faults

    dir_ref = os.path.join(work, "reference")
    dir_chaos = os.path.join(work, "chaos")

    print(f"==> [{args.mode}] reference run -> {dir_ref}", file=sys.stderr)
    ref_s = run_to_completion(
        train_cmd(args, dir_ref), child_env(), args.timeout
    )

    interrupted = None
    if args.mode == "nan":
        print(
            f"==> [{args.mode}] faulted run (nan_loss={args.nan_step}, "
            f"sentinel={args.sentinel}) -> {dir_chaos}", file=sys.stderr,
        )
        recovery_s = run_to_completion(
            train_cmd(args, dir_chaos),
            child_env({"PCT_FAULTS": f"nan_loss={args.nan_step}"}),
            args.timeout,
        )
    else:
        sig = signal.SIGKILL if args.mode == "sigkill" else signal.SIGTERM
        print(
            f"==> [{args.mode}] interrupted run -> {dir_chaos}",
            file=sys.stderr,
        )
        rc = interrupt_run(args, dir_chaos, sig)
        interrupted = {"signal": int(sig), "rc": rc}
        if args.mode in ("sigterm", "corrupt") and rc != 0:
            raise SystemExit(f"SIGTERM run did not exit cleanly (rc={rc})")
        if args.mode == "corrupt":
            # damage the preemption save and its rolling-history copies so
            # the restore must fall all the way back to ckpt.msgpack; when
            # the run completed before the signal landed there is no
            # last.msgpack: damage the best checkpoint's primary instead
            # and let its history serve the fallback
            victims = glob.glob(os.path.join(dir_chaos, "last*.msgpack"))
            if not victims:
                victims = [os.path.join(dir_chaos, "ckpt.msgpack")]
            for victim in victims:
                if args.corruption == "truncate":
                    faults.truncate_file(victim)
                else:
                    faults.bitflip_file(victim)
                print(
                    f"==> [{args.mode}] {args.corruption}d {victim}",
                    file=sys.stderr,
                )
        print(f"==> [{args.mode}] resuming {dir_chaos}", file=sys.stderr)
        recovery_s = run_to_completion(
            train_cmd(args, dir_chaos, resume=True), child_env(),
            args.timeout,
        )

    cmp = compare(dir_ref, dir_chaos)
    ok = (
        cmp["finite"]
        and cmp["max_abs_diff"] <= tol
        and cmp["best_epoch_ref"] == cmp["best_epoch_chaos"]
        and abs(cmp["best_acc_ref"] - cmp["best_acc_chaos"])
        <= (2.0 if args.mode == "nan" else 1e-6)
    )
    record = {
        "harness": "chaos_run",
        "mode": args.mode,
        "match": ok,
        "tol": tol,
        "reference_s": round(ref_s, 2),
        "recovery_s": round(recovery_s, 2),
        **_rounded(cmp),
    }
    if args.mode == "corrupt":
        record["corruption"] = args.corruption
    if interrupted:
        record.update(interrupted)
    return record


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_cifar_tpu_torch.tools.chaos_run",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--mode", choices=MODES, default="sigterm")
    p.add_argument(
        "--serve-devices", type=int, default=1, dest="serve_devices",
        help="devices of the --mode serve engine's group (the serving "
        "CLI's --num_devices; on the CPU, logical shards)",
    )
    p.add_argument(
        "--corruption", choices=("truncate", "bitflip"), default="truncate",
        help="how --mode corrupt damages the preemption save",
    )
    p.add_argument("--model", default="LeNet")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--train-size", type=int, default=512, dest="train_size")
    p.add_argument("--test-size", type=int, default=256, dest="test_size")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sentinel", default="skip")
    p.add_argument(
        "--nan-step", type=int, default=2, dest="nan_step",
        help="global step the nan mode poisons (PCT_FAULTS=nan_loss=K)",
    )
    p.add_argument(
        "--kill-delay-s", type=float, default=0.5, dest="kill_delay_s",
        help="seconds past the first checkpoint before the signal lands",
    )
    p.add_argument(
        "--tol", type=float, default=None,
        help="max |param diff| vs the reference run (default: 1e-6 for "
        "the kill and corrupt modes, the same deterministic trajectory "
        "re-run, and 0.25 for nan, where one update is legitimately "
        "skipped)",
    )
    p.add_argument("--timeout", type=float, default=900)
    p.add_argument(
        "--out", default=None,
        help="work dir (default: a fresh temp dir, removed on success)",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device of every child process")
    args = p.parse_args(argv)
    if args.serve_devices < 1:
        p.error(f"--serve-devices {args.serve_devices}: need 1 or more")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    tol = args.tol if args.tol is not None else (
        0.25 if args.mode == "nan" else 1e-6
    )
    work = args.out or tempfile.mkdtemp(prefix=f"chaos_{args.mode}_")
    drills = {"serve": serve_drill, "ckpt": ckpt_drill,
              "canary": canary_drill, "edge": edge_drill,
              "mesh": mesh_drill}
    if args.mode in drills:
        record = drills[args.mode](args, work)
    else:
        record = trainer_drill(args, work, tol)
    print(json.dumps(record))
    if record["match"] and not args.out:
        shutil.rmtree(work, ignore_errors=True)
    elif not record["match"]:
        print(f"==> artifacts kept in {work}", file=sys.stderr)
    return 0 if record["match"] else 1


if __name__ == "__main__":
    sys.exit(main())
