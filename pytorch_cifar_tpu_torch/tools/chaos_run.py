"""The port's drill: kill, corrupt or poison a real training run of the
port, then prove that it recovers; and the serving, checkpoint, canary,
edge and fleet drills.

Counterpart of the JAX package's ``tools/chaos_run.py``, on the port's own
CLIs, each a child process: ``python -m pytorch_cifar_tpu_torch.train``,
``...serve``, ``...tools.pipeline_run``, ``...tools.router_run``,
``...tools.fleet_run``, ``...tools.ckpt_inspect`` and
``...tools.journal_inspect``. Each mode prints ONE JSON line under the JAX
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
  router   router_run with 2 replicas on a shared cold-start cache under
           mixed-priority mixed-wire load, replica 0 SIGKILLed: replica 1
           joined at compiles == 0, every answer bit for bit across the
           replicas, the router and both encodings, bounded loss, the
           corpse evicted, the post-evict p99 within 2x the steady one
           (+25 ms), and a drain that exits 0.
  canary   serve-only pipeline_run under mixed-priority HTTP load: NaN,
           bit-flipped and regressed candidates staged one after another
           are each quarantined with the fleet's bits, epoch and
           generation unmoved; then a genuinely better B promotes, with no
           failed request across the drill.
  zoo      router_run --models LeNet=<trained>,MobileNet,VGG11
           --max_resident 2 with 2 replicas under a zipf per-model mix,
           replica 0 SIGKILLed: each model's answers bit for bit across
           the replicas, the router, both encodings and evict/re-admit
           cycles, no failed request, re-admissions from the cache at
           compiles == 0, and a drain that exits 0.
  mesh     router_run --replicas 2 --mesh_procs 2 under mixed-wire load:
           every answer bit for bit a one-process replica's; one
           follower rank SIGKILLed, its leader exits rc 70 within
           --mesh_timeout_s, the router evicts the logical replica with no
           failed request, and replica 1 joined at compiles == 0 on the
           shared cold-start cache.
  elastic  fleet_run (min 1 / max 3) under a load that ramps 10x and back,
           replica 0 SIGKILLed mid-ramp: the controller scales up (every
           scale-up at compiles == 0), replaces the corpse and scales back
           down, with no failed request, p99 bounded and every replica
           that ever served bit for bit the first.
  edge     router_run --edge event with 2 replicas under open-loop mixed-
           wire load: a slow-loris trickle closed by the read deadline, a
           256-socket flood absorbed, a replica SIGKILLed with bounded
           loss and evicted, and a SIGTERM drain that exits 0.
  rollout  this process hosts the edge (a router following the
           controller's journal) while fleet_run --role controller runs
           the fleet: generation 2 is published under load, the
           controller SIGKILLed at its surge, the edge serves headless, a
           --resume relaunch adopts every journal-live replica (none
           spawned twice: /proc is the ground truth) and finishes the
           deploy; a CRC-valid NaN generation 3 is refused at surge and
           rolled back fleet-wide; journal_inspect replays the whole life
           cycle. A new generation's replicas join at compiles == 0 after
           the first of their weight set: the port's cold-start cache
           keeps one prepared weight set per checkpoint, where JAX's
           holds executables for any weights.

``--serve-devices N`` serves ``--mode serve`` over a group of N devices
(on the CPU, N logical shards). The router, zoo, elastic and rollout modes
keep each launcher's JSON record and each drained replica's own in
``<work>/<mode>.json``.

Usage:
  python -m pytorch_cifar_tpu_torch.tools.chaos_run --device cpu \\
      --mode sigkill
  python -m pytorch_cifar_tpu_torch.tools.chaos_run --device cpu \\
      --mode corrupt --corruption bitflip
  python -m pytorch_cifar_tpu_torch.tools.chaos_run --device cpu \\
      --mode rollout --epochs 2
  python -m pytorch_cifar_tpu_torch.tools.chaos_run --mode serve \\
      --model ResNet18 --epochs 2

The children run on the card unless ``--device cpu`` is given, which is
passed to every child; without a card the first child fails and so does
the drill. The children's sizes are the JAX drill's defaults (LeNet); on
the card give ``--model ResNet18`` and sizes at which a signal lands
inside a later epoch (the zoo mode's trained tenant is LeNet).

This process loads no torch and holds no device: it reads checkpoints
through ``serialization.py``, damages them through ``faults.py``,
publishes through ``train/checkpoint.py``'s staging helpers, drives HTTP
through ``serve/loadgen.py`` and, in the rollout mode, hosts the edge from
``serve/router.py``, ``frontend.py`` and ``journal.py``. Only the children
hold a CUDA context.
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
MODES = ("sigterm", "sigkill", "corrupt", "nan", "serve", "ckpt", "router",
         "canary", "zoo", "mesh", "elastic", "edge", "rollout")


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


def start_child(cmd, env) -> tuple:
    """Start ``cmd``; ``finish_child`` waits for it. Children that do not
    depend on each other (a reference run beside the chaos run, two
    checkpoints) run side by side. A thread drains the child's pipes and
    notes when it exited, so its seconds are its own whenever it is
    waited for."""
    proc = subprocess.Popen(
        cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO,
    )
    box = {"t0": time.monotonic()}

    def drain():
        box["out"], box["err"] = proc.communicate()
        box["t1"] = time.monotonic()

    t = threading.Thread(target=drain, name="child-drain", daemon=True)
    t.start()
    return proc, t, box


def finish_child(started: tuple, timeout) -> float:
    """Wait for a child ``start_child`` started; its seconds from start to
    exit. Exits the drill when it fails or outlives ``timeout``."""
    proc, t, box = started
    t.join(timeout)
    if t.is_alive():
        proc.kill()
        t.join()
        raise SystemExit(f"child timed out: {proc.args}")
    if proc.returncode != 0:
        sys.stderr.write(box["out"][-2000:] + "\n" + box["err"][-4000:]
                         + "\n")
        raise SystemExit(f"child failed rc={proc.returncode}: {proc.args}")
    return box["t1"] - box["t0"]


def run_to_completion(cmd, env, timeout) -> float:
    return finish_child(start_child(cmd, env), timeout)


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


def _drain_stderr(proc, name: str, keep=None) -> threading.Thread:
    """Forward the rest of a child's stderr to ours, on a thread; each
    line also goes into the list ``keep`` when one is given."""

    def run():
        for ln in proc.stderr:
            sys.stderr.write(ln)
            if keep is not None:
                keep.append(ln)

    t = threading.Thread(target=run, name=name, daemon=True)
    t.start()
    return t


REPLICA_RE = re.compile(r"==> replica (\d+) pid=(\d+) url=(\S+)")
ROUTER_RE = re.compile(r"==> router: serving on (\S+)")
# a drained replica's own JSON record, forwarded by its launcher
RECORD_RE = re.compile(r"^\[replica (\S+)\] (\{.*\})$")


def train_checkpoint(args, tag: str, ckpt_dir: str) -> None:
    print(f"==> [{tag}] training checkpoint -> {ckpt_dir}", file=sys.stderr)
    run_to_completion(train_cmd(args, ckpt_dir), child_env(), args.timeout)


def _spawn(cmd):
    return subprocess.Popen(
        cmd, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO,
    )


def _fleet_topology(proc, timeout: float, on_line=None) -> tuple:
    """Read ``router_run``'s stderr (forwarded to ours) up to the
    router's line: ``({idx: (pid, url)}, router_url)``. ``on_line(line)``
    sees every line before it."""
    replicas = {}
    deadline = time.monotonic() + timeout
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
        if on_line is not None:
            on_line(line)
        m = REPLICA_RE.search(line)
        if m:
            replicas[int(m.group(1))] = (int(m.group(2)), m.group(3))
        m = ROUTER_RE.search(line)
        if m:
            return replicas, m.group(1)
    proc.kill()
    raise SystemExit("timed out waiting for the fleet topology")


def _healthz(url: str) -> dict:
    """A ``/healthz`` payload, also on a 503 mid-transition (the body is
    still the health payload)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            return json.load(r)
    except urllib.error.HTTPError as e:
        with e:
            return json.loads(e.read().decode("utf-8"))


def _bits(url: str, x, wire: str = "json", model=None):
    from pytorch_cifar_tpu_torch.serve.loadgen import HttpTarget

    target = HttpTarget(url, wire=wire)
    try:
        return target.submit(x, model=model).result()
    finally:
        target.close()


def _load_phase(mode: str, tag: str, url: str, clients: int,
                duration_s: float, seed: int, wire: str = "json",
                **load_kw) -> dict:
    """``run_load``'s closed-loop clients on ``url`` for ``duration_s``
    (1-4 images a request), logged as one line."""
    from pytorch_cifar_tpu_torch.serve.loadgen import HttpTarget, run_load

    target = HttpTarget(url, wire=wire)
    try:
        rep = run_load(
            target, clients=clients, requests_per_client=10**6,
            images_max=4, seed=seed, duration_s=duration_s, **load_kw,
        )
    finally:
        target.close()
    mix = f" per_model={rep['per_model']}" if "per_model" in rep else ""
    print(
        f"==> [{mode}] {tag}: {rep['requests']} reqs{mix} "
        f"p99={rep['p99_ms']:.1f}ms "
        f"hedged={rep['hedged']} failed={rep['failed']}", file=sys.stderr,
    )
    return rep


def _keep_records(work: str, mode: str, launcher: dict, lines,
                  **extra) -> None:
    """Write the launcher's JSON record and each drained replica's own
    (``[replica i] {...}`` on its stderr) to ``<work>/<mode>.json``."""
    replicas = {}
    for ln in lines:
        m = RECORD_RE.match(ln.strip())
        if m:
            replicas[m.group(1)] = json.loads(m.group(2))
    with open(os.path.join(work, f"{mode}.json"), "w") as f:
        json.dump({"launcher": launcher, "replicas": replicas, **extra}, f)


def _serve_pids(marker: str) -> set:
    """Live port replica processes (an argument ``pytorch_cifar_tpu_torch.
    serve``) whose command line names ``marker``: the ground truth, from
    ``/proc``. A zombie's command line is empty, so it is not counted."""
    from pytorch_cifar_tpu_torch.serve.fleet import REPLICA_MODULE

    pids = set()
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue  # raced an exit
        if (REPLICA_MODULE.encode() in argv
                and any(marker.encode() in a for a in argv)):
            pids.add(int(d))
    return pids


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

    # two distinct checkpoints, trained side by side: A is served first,
    # B is published into the watched dir mid-load (different seed ->
    # different weights)
    print(f"==> [serve] training checkpoints A -> {dir_a}, B -> {dir_b}",
          file=sys.stderr)
    args_b = argparse.Namespace(**{**vars(args), "seed": args.seed + 1})
    runs = [start_child(train_cmd(a, d), env)
            for a, d in ((args, dir_a), (args_b, dir_b))]
    for run in runs:
        finish_child(run, args.timeout)
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
    from pytorch_cifar_tpu_torch.serve.loadgen import run_async_load

    ckpt_dir = os.path.join(work, "ckpt")
    train_checkpoint(args, "edge", ckpt_dir)

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
    proc = _spawn(cmd)
    replicas, router_url = _fleet_topology(proc, args.timeout)
    if len(replicas) != 2:
        proc.kill()
        raise SystemExit(f"router_run came up with replicas {replicas}")
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
        _bits(u, probe, wire=w)
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
    from pytorch_cifar_tpu_torch.serve.loadgen import HttpTarget

    peer_timeout_rc = 70  # serve/mesh_replica.PEER_TIMEOUT_RC (no torch)
    ckpt_dir = os.path.join(work, "ckpt")
    train_checkpoint(args, "mesh", ckpt_dir)

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
    proc = _spawn(cmd)
    follower_re = re.compile(r"==> replica (\d+) follower rank=(\d+) "
                             r"pid=(\d+)")
    followers = {}

    def on_line(line):
        m = follower_re.search(line)
        if m:
            followers[int(m.group(1))] = int(m.group(3))

    leaders, router_url = _fleet_topology(proc, args.timeout, on_line)
    if len(leaders) != 2 or len(followers) != 2:
        proc.kill()
        raise SystemExit("timed out waiting for the mesh fleet topology")
    drain_t = _drain_stderr(proc, "mesh-stderr-drain")

    # the one-process bit reference
    ref = _spawn(
        module_cmd("serve", "--ckpt", ckpt_dir, "--model", args.model,
                   "--buckets", 1, 4, 8, "--http_port", 0,
                   "--device", args.device,
                   "--dtype", REPLICA_DTYPE[args.device]))
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
        # all interactive: a bulk 429 reaches its client by design, and
        # the bar here is no client-visible error
        return _load_phase("mesh", tag, router_url, 4, duration_s, seed,
                           wire="mixed", bulk_fraction=0.0)

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


def router_drill(args, work: str) -> dict:
    """The fleet drill: SIGKILL one of two replicas under sustained
    mixed-priority, mixed-wire HTTP load; the router must evict, reroute
    and hold the latency and error bounds.

    Phases:
      0. fleet up: router_run spawns 2 replicas on a shared cold-start
         cache (replica 1 must join with compiles == 0) and the router's
         frontend; /predict bits probed across replica 0, replica 1 and
         the router, each in JSON and binary.
      1. steady state: closed-loop load -> p99_steady.
      2. kill: the same load with replica 0 SIGKILLed mid-phase -> loss
         bounded (every request answered, hedged or failed with an error)
         and the corpse evicted.
      3. post-evict: the same load on the survivor -> p99_post within
         max(2 x p99_steady, p99_steady + 25 ms).
      4. drain: SIGTERM to router_run must exit 0 with its eviction
         counters in its JSON record.
    The launcher's record and the drained replica's own go to
    ``<work>/router.json``.
    """
    ckpt_dir = os.path.join(work, "ckpt")
    train_checkpoint(args, "router", ckpt_dir)

    print("==> [router] fleet up", file=sys.stderr)
    proc = _spawn(module_cmd(
        "tools.router_run",
        "--ckpt", ckpt_dir,
        "--model", args.model,
        "--replicas", 2,
        "--buckets", 1, 4, 8,
        "--aot_cache", os.path.join(work, "aot"),
        "--deadline_ms", 2000,
        "--probe_s", 0.2,
        "--max_wait_ms", 1,
        "--device", args.device,
    ))
    replicas, router_url = _fleet_topology(proc, args.timeout)
    if len(replicas) != 2:
        proc.kill()
        raise SystemExit(f"router_run came up with replicas {replicas}")
    lines = []
    drain_t = _drain_stderr(proc, "router-stderr-drain", lines)

    # replica 1 imported replica 0's cold-start cache entries
    warm_compiles = int(_healthz(replicas[1][1]).get("compiles", -1))
    probe = np.random.RandomState(7).randint(
        0, 256, size=(3, 32, 32, 3)
    ).astype(np.uint8)
    outs = [
        _bits(u, probe, wire=w)
        for u in (replicas[0][1], replicas[1][1], router_url)
        for w in ("json", "binary")
    ]
    bit_identical = all(np.array_equal(outs[0], o) for o in outs[1:])

    def load_phase(tag, duration_s, seed):
        return _load_phase("router", tag, router_url, 4, duration_s, seed,
                           wire="mixed", bulk_fraction=0.3)

    print("==> [router] phase 1: steady state", file=sys.stderr)
    steady = load_phase("steady", 5.0, seed=1)

    print("==> [router] phase 2: SIGKILL replica 0 under load",
          file=sys.stderr)
    kill_at = threading.Timer(
        2.0, os.kill, (replicas[0][0], signal.SIGKILL)
    )
    kill_at.start()
    t_kill = time.monotonic()
    killed = load_phase("kill", 6.0, seed=2)
    kill_at.join()
    kill_recovery_s = time.monotonic() - t_kill

    print("==> [router] phase 3: post-evict steady state", file=sys.stderr)
    post = load_phase("post-evict", 5.0, seed=3)
    healthy_after = int(_healthz(router_url).get("healthy_replicas", -1))

    print("==> [router] phase 4: drain", file=sys.stderr)
    proc.send_signal(signal.SIGTERM)
    out = proc.stdout.read()
    proc.wait(timeout=args.timeout)
    drain_t.join(timeout=10)
    rec_run = _last_record(out, "router_run")
    _keep_records(work, "router", rec_run, lines)

    p99_budget_ms = max(2.0 * steady["p99_ms"], steady["p99_ms"] + 25.0)
    loss_bound = killed["failed"] <= max(4, killed["requests"] // 20)
    ok = (
        proc.returncode == 0
        and warm_compiles == 0
        and bit_identical
        and steady["requests"] > 0
        and killed["requests"] > 0
        and post["requests"] > 0
        and steady["failed"] == 0
        and loss_bound
        and post["failed"] == 0
        and post["p99_ms"] <= p99_budget_ms
        and healthy_after == 1
        and rec_run["router"]["evictions"] >= 1
    )
    return {
        "harness": "chaos_run",
        "mode": "router",
        "match": ok,
        "reference_s": round(steady["elapsed_s"], 2),
        "recovery_s": round(kill_recovery_s, 2),
        "warm_replica_compiles": warm_compiles,
        "bit_identical": bit_identical,
        "wire": "mixed",
        "p99_steady_ms": round(steady["p99_ms"], 2),
        "p99_kill_ms": round(killed["p99_ms"], 2),
        "p99_post_ms": round(post["p99_ms"], 2),
        "p99_budget_ms": round(p99_budget_ms, 2),
        "requests": steady["requests"] + killed["requests"]
        + post["requests"],
        "failed_during_kill": killed["failed"],
        "hedged_during_kill": killed["hedged"],
        "healthy_after": healthy_after,
        "evictions": rec_run["router"]["evictions"],
        "router_hedged": rec_run["router"]["hedged"],
        "router_replica_errors": rec_run["router"]["replica_errors"],
        "router_rc": proc.returncode,
    }


ZOO_MODELS = ["LeNet", "MobileNet", "VGG11"]


def zoo_drill(args, work: str) -> dict:
    """The multi-tenant zoo drill: a 2-replica zoo fleet (LeNet from a
    trained checkpoint, MobileNet and VGG11 on seeded random weights, the
    same in every replica) with ``max_resident`` 2, so the third tenant
    forces eviction churn, under a zipf per-model mix ranked by the card's
    cost priors, replica 0 SIGKILLed mid-load.

    Phases:
      0. fleet up: router_run --models spawns 2 zoo replicas behind the
         model-aware router on a shared cold-start cache (replica 1's
         resident tenants join with compiles == 0).
      1. per-model bits: the same payload to replica 0, replica 1 and the
         router over both encodings, for every model (three models
         through two resident slots: the probe itself churns).
      2. steady, kill, post-evict: closed-loop mixed-priority mixed-wire
         clients drawing the mix; replica 0 SIGKILLed mid-phase; no failed
         request in any phase, the corpse evicted.
      3. survivor audit: every resident tenant evicted and re-admitted
         imported from the cache (compiles == 0, aot_cache_hits > 0), and
         the router's per-model answers still phase 1's bits.
      4. drain: SIGTERM to router_run exits 0.
    The launcher's record and the survivor's own go to ``<work>/zoo.json``.
    """
    from pytorch_cifar_tpu_torch.serve.loadgen import zipf_mix
    from pytorch_cifar_tpu_torch.serve.priors import load_cost_priors

    ckpt_dir = os.path.join(work, "ckpt_lenet")
    train_checkpoint(args, "zoo", ckpt_dir)

    print("==> [zoo] fleet up", file=sys.stderr)
    proc = _spawn(module_cmd(
        "tools.router_run",
        "--ckpt", os.path.join(work, "nonexistent"),
        "--models", f"LeNet={ckpt_dir},MobileNet,VGG11",
        "--max_resident", 2,
        "--replicas", 2,
        "--buckets", 1, 4,
        "--aot_cache", os.path.join(work, "aot"),
        "--deadline_ms", 4000,
        "--probe_s", 0.2,
        "--max_wait_ms", 1,
        "--device", args.device,
    ))
    replicas, router_url = _fleet_topology(proc, args.timeout)
    if len(replicas) != 2:
        proc.kill()
        raise SystemExit(f"router_run came up with replicas {replicas}")
    lines = []
    drain_t = _drain_stderr(proc, "zoo-stderr-drain", lines)

    h1 = _healthz(replicas[1][1])
    warm_compiles = sum(
        int(t.get("compiles") or 0)
        for t in h1.get("tenants", {}).values()
        if t.get("resident")
    )

    probe = np.random.RandomState(7).randint(
        0, 256, size=(3, 32, 32, 3)
    ).astype(np.uint8)
    pre_bits = {}
    per_model_identical = {}
    for model in ZOO_MODELS:
        outs = [
            _bits(u, probe, wire=w, model=model)
            for u in (replicas[0][1], replicas[1][1], router_url)
            for w in ("json", "binary")
        ]
        per_model_identical[model] = all(
            np.array_equal(outs[0], o) for o in outs[1:]
        )
        pre_bits[model] = outs[0]
    bit_identical = all(per_model_identical.values())

    mix = zipf_mix(ZOO_MODELS, priors=load_cost_priors())

    def load_phase(tag, duration_s, seed):
        return _load_phase("zoo", tag, router_url, 4, duration_s, seed,
                           wire="mixed", bulk_fraction=0.3, model_mix=mix)

    print("==> [zoo] phase 2: steady state", file=sys.stderr)
    steady = load_phase("steady", 5.0, seed=1)

    print("==> [zoo] phase 3: SIGKILL replica 0 under load",
          file=sys.stderr)
    kill_at = threading.Timer(
        2.0, os.kill, (replicas[0][0], signal.SIGKILL)
    )
    kill_at.start()
    t_kill = time.monotonic()
    killed = load_phase("kill", 6.0, seed=2)
    kill_at.join()
    kill_recovery_s = time.monotonic() - t_kill

    print("==> [zoo] phase 4: post-evict survivor audit", file=sys.stderr)
    post = load_phase("post-evict", 4.0, seed=3)
    tenants = _healthz(replicas[1][1]).get("tenants", {})
    churned = [
        n for n, t in tenants.items() if int(t.get("evictions") or 0) >= 1
    ]
    readmits_clean = all(
        int(t.get("compiles") or 0) == 0
        and int(t.get("aot_cache_hits") or 0) > 0
        for n, t in tenants.items()
        if t.get("resident") and int(t.get("evictions") or 0) >= 1
    )
    post_bits_ok = all(
        np.array_equal(_bits(router_url, probe, model=m), pre_bits[m])
        for m in ZOO_MODELS
    )
    healthy_after = int(_healthz(router_url).get("healthy_replicas", -1))

    print("==> [zoo] phase 5: drain", file=sys.stderr)
    proc.send_signal(signal.SIGTERM)
    out = proc.stdout.read()
    proc.wait(timeout=args.timeout)
    drain_t.join(timeout=10)
    rec_run = _last_record(out, "router_run")
    _keep_records(work, "zoo", rec_run, lines)

    total_failed = steady["failed"] + killed["failed"] + post["failed"]
    ok = (
        proc.returncode == 0
        and warm_compiles == 0
        and bit_identical
        and post_bits_ok
        and steady["requests"] > 0
        and killed["requests"] > 0
        and post["requests"] > 0
        and total_failed == 0
        and len(churned) >= 1
        and readmits_clean
        and healthy_after == 1
        and rec_run["router"]["evictions"] >= 1
    )
    return {
        "harness": "chaos_run",
        "mode": "zoo",
        "match": ok,
        "models": ZOO_MODELS,
        "max_resident": 2,
        "mix": {m: round(w, 4) for m, w in mix.items()},
        "recovery_s": round(kill_recovery_s, 2),
        "warm_replica_compiles": warm_compiles,
        "per_model_bit_identical": per_model_identical,
        "post_kill_bits_match": post_bits_ok,
        "requests": steady["requests"] + killed["requests"]
        + post["requests"],
        "per_model_requests": {
            m: steady["per_model"][m] + killed["per_model"][m]
            + post["per_model"][m]
            for m in ZOO_MODELS
        },
        "failed": total_failed,
        "hedged_during_kill": killed["hedged"],
        "churned_tenants": churned,
        "readmit_compiles_zero": readmits_clean,
        "survivor_tenants": {
            n: {
                "resident": t.get("resident"),
                "admissions": t.get("admissions"),
                "evictions": t.get("evictions"),
                "compiles": t.get("compiles"),
                "aot_cache_hits": t.get("aot_cache_hits"),
            }
            for n, t in tenants.items()
        },
        "healthy_after": healthy_after,
        "evictions": rec_run["router"]["evictions"],
        "router_hedged": rec_run["router"]["hedged"],
        "router_rc": proc.returncode,
    }


def elastic_drill(args, work: str) -> dict:
    """The autoscaling drill: a fleet under ``fleet_run``'s controller
    (min 1 / max 3 replicas) serves a load that ramps 10x and back while
    replica 0 is SIGKILLed mid-ramp.

    Phases:
      0. fleet up: fleet_run with an aggressive band (up after 0.5 s of
         pressure), replica 0 filling the shared cold-start cache. A
         stderr watcher tracks every membership line (seed, scale-up,
         scale-down, died) so that every replica that ever serves is
         probed for its bits the moment it appears.
      1. baseline: 1 closed-loop client -> p99_steady; the fleet must hold
         at 1 replica.
      2. ramp 10x: 10 clients for 35 s. The controller must scale up (each
         scale-up joining with compiles == 0); once the fleet is >= 2,
         replica 0 is SIGKILLed mid-load: the router hedges the in-flight
         loss (no failed request), the controller reaps the corpse and
         refills.
      3. ramp back: 1 client for 20 s; the controller must scale down.
      4. drain: SIGTERM to fleet_run exits 0 with the scale ledger in its
         JSON record; every child reaped.
    The launcher's record and each drained replica's own go to
    ``<work>/elastic.json``, with each phase's seconds.
    """
    ckpt_dir = os.path.join(work, "ckpt")
    train_checkpoint(args, "elastic", ckpt_dir)

    print("==> [elastic] fleet up (min 1, max 3)", file=sys.stderr)
    proc = _spawn(module_cmd(
        "tools.fleet_run",
        "--ckpt", ckpt_dir,
        "--model", args.model,
        "--min_replicas", 1,
        "--max_replicas", 3,
        "--buckets", 1, 4, 8,
        "--aot_cache", os.path.join(work, "aot"),
        "--deadline_ms", 4000,
        "--max_wait_ms", 1,
        "--probe_s", 0.2,
        "--control_interval_s", 0.25,
        "--queue_high", 3,
        "--queue_low", 2,
        "--up_after_s", 0.5,
        "--down_after_s", 2,
        "--up_cooldown_s", 1.5,
        "--down_cooldown_s", 2,
        "--device", args.device,
    ))
    seed_re = re.compile(
        r"==> fleet: replica (\d+) pid=(\d+) url=(\S+) compiles=(\S+)"
    )
    up_re = re.compile(
        r"==> fleet: scale-up replica (\d+) url=(\S+) pid=(\d+) "
        r"compiles=(\S+)"
    )
    down_re = re.compile(r"==> fleet: scale-down replica (\d+) url=(\S+)")
    died_re = re.compile(r"==> fleet: replica (\d+) died; removed")
    fleet_re = re.compile(r"==> fleet: serving on (\S+)")

    # every replica that ever served, fed by the stderr watcher
    state_lock = threading.Lock()
    members = {}  # idx -> {"url", "pid", "compiles"}
    events = {"ups": 0, "downs": 0, "died": 0}
    fleet_url_box = {}
    fleet_ready = threading.Event()
    lines = []

    def watch_stderr():
        for line in proc.stderr:
            sys.stderr.write(line)
            lines.append(line)
            m = seed_re.search(line)
            if m:
                with state_lock:
                    members[int(m.group(1))] = {
                        "url": m.group(3), "pid": int(m.group(2)),
                        "compiles": m.group(4),
                    }
            m = up_re.search(line)
            if m:
                with state_lock:
                    members[int(m.group(1))] = {
                        "url": m.group(2), "pid": int(m.group(3)),
                        "compiles": m.group(4),
                    }
                    events["ups"] += 1
            if down_re.search(line):
                with state_lock:
                    events["downs"] += 1
            if died_re.search(line):
                with state_lock:
                    events["died"] += 1
            m = fleet_re.search(line)
            if m:
                fleet_url_box["url"] = m.group(1)
                fleet_ready.set()

    watcher = threading.Thread(
        target=watch_stderr, name="fleet-stderr-watch", daemon=True
    )
    watcher.start()
    if not fleet_ready.wait(args.timeout):
        proc.kill()
        raise SystemExit("timed out waiting for the fleet frontend")
    fleet_url = fleet_url_box["url"]

    # every replica generation must answer these bytes for this probe
    probe = np.random.RandomState(7).randint(
        0, 256, size=(3, 32, 32, 3)
    ).astype(np.uint8)
    ref_bits = _bits(fleet_url, probe)
    probed = set()
    identity = {"ok": True}

    def probe_new_members():
        with state_lock:
            todo = {
                i: m["url"] for i, m in members.items() if i not in probed
            }
        for i, url in todo.items():
            try:
                bits = _bits(url, probe)
            except Exception as e:  # a member may die mid-probe (the kill)
                print(
                    f"==> [elastic] probe of replica {i} failed ({e}); "
                    "skipping (already dead)", file=sys.stderr,
                )
                probed.add(i)
                continue
            if not np.array_equal(bits, ref_bits):
                identity["ok"] = False
            probed.add(i)
            print(
                f"==> [elastic] replica {i} bits "
                f"{'match' if identity['ok'] else 'DIVERGE'}",
                file=sys.stderr,
            )

    probe_new_members()  # the seed replica
    phase_s = {}

    def load_phase(tag, clients, duration_s, seed):
        t0 = time.monotonic()
        rep = _load_phase("elastic", tag, fleet_url, clients, duration_s,
                          seed)
        phase_s[tag] = round(time.monotonic() - t0, 2)
        return rep

    print("==> [elastic] phase 1: baseline (1 client)", file=sys.stderr)
    steady = load_phase("baseline", 1, 5.0, seed=1)
    held_at_min = int(_healthz(fleet_url).get("healthy_replicas", -1)) == 1

    print("==> [elastic] phase 2: 10x ramp + SIGKILL", file=sys.stderr)
    ramp_result = {}
    ramp_t = threading.Thread(
        target=lambda: ramp_result.update(
            load_phase("ramp", 10, 35.0, seed=2)
        ),
        name="ramp-load",
    )
    ramp_t.start()
    scaled_up = False
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        if int(_healthz(fleet_url).get("healthy_replicas", 0)) >= 2:
            scaled_up = True
            break
        time.sleep(0.25)
    probe_new_members()  # the scale-up replicas
    kill_pid = None
    if scaled_up:
        with state_lock:
            kill_pid = members[0]["pid"]  # the seed replica
        print(
            f"==> [elastic] SIGKILL replica 0 (pid {kill_pid}) "
            "under ramp load", file=sys.stderr,
        )
        os.kill(kill_pid, signal.SIGKILL)
    ramp_t.join()
    probe_new_members()  # a replacement spawned after the kill
    ramp = ramp_result
    healthy_after_ramp = int(
        _healthz(fleet_url).get("healthy_replicas", -1))

    print("==> [elastic] phase 3: ramp back (1 client)", file=sys.stderr)
    settle = load_phase("settle", 1, 20.0, seed=3)
    probe_new_members()
    healthy_final = int(_healthz(fleet_url).get("healthy_replicas", -1))

    print("==> [elastic] phase 4: drain", file=sys.stderr)
    t0 = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    out = proc.stdout.read()
    proc.wait(timeout=args.timeout)
    watcher.join(timeout=10)
    phase_s["drain"] = round(time.monotonic() - t0, 2)
    rec_run = _last_record(out, "fleet_run")
    _keep_records(work, "elastic", rec_run, lines, phase_s=phase_s)

    with state_lock:
        ledger = dict(members)
        ups, downs, died = events["ups"], events["downs"], events["died"]
    scaleup_compiles = [
        m["compiles"] for i, m in ledger.items() if i >= 1
    ]
    p99_budget_ms = max(2.0 * steady["p99_ms"], steady["p99_ms"] + 25.0)
    total_failed = steady["failed"] + ramp["failed"] + settle["failed"]
    ok = (
        proc.returncode == 0
        and held_at_min
        and scaled_up
        and kill_pid is not None
        and identity["ok"]
        and steady["requests"] > 0
        and ramp["requests"] > 0
        and settle["requests"] > 0
        and total_failed == 0
        # the ramp bounded by the request deadline, the settled fleet by
        # the steady state's budget
        and ramp["p99_ms"] <= 4000.0
        and settle["p99_ms"] <= p99_budget_ms
        and all(c == "0" for c in scaleup_compiles)
        and rec_run["scale_ups"] >= 2  # ramp growth + post-kill refill
        and rec_run["scale_downs"] >= 1  # the ramp-back shed
        and rec_run["replica_failures"] >= 1  # the SIGKILL was seen
        and healthy_final >= 1
        and all(
            rc in (0, None) for rc in rec_run["replica_rcs"].values()
        )
    )
    return {
        "harness": "chaos_run",
        "mode": "elastic",
        "match": ok,
        "min_replicas": 1,
        "max_replicas": 3,
        "held_at_min_baseline": held_at_min,
        "scaled_up_under_ramp": scaled_up,
        "bit_identical_all_generations": identity["ok"],
        "replicas_ever_served": len(ledger),
        "scaleup_compiles": scaleup_compiles,
        "scale_ups": rec_run["scale_ups"],
        "scale_downs": rec_run["scale_downs"],
        "replica_failures": rec_run["replica_failures"],
        "stderr_ups": ups,
        "stderr_downs": downs,
        "stderr_died": died,
        "requests": steady["requests"] + ramp["requests"]
        + settle["requests"],
        "failed": total_failed,
        "hedged_during_ramp": ramp["hedged"],
        "p99_steady_ms": round(steady["p99_ms"], 2),
        "p99_ramp_ms": round(ramp["p99_ms"], 2),
        "p99_settle_ms": round(settle["p99_ms"], 2),
        "p99_budget_ms": round(p99_budget_ms, 2),
        "healthy_after_ramp": healthy_after_ramp,
        "healthy_final": healthy_final,
        "spawn_ms_p50": rec_run["spawn_ms_p50"],
        "drain_ms_p50": rec_run["drain_ms_p50"],
        "fleet_rc": proc.returncode,
    }


def _after_first_zero(joined) -> bool:
    """Every replica after the first of its weight set (its generation)
    joined with compiles "0": the port's cold-start cache keeps one
    prepared weight set per checkpoint, so the first replica of a new one
    prepares it and compiles its buckets. ``joined``: (generation,
    compiles) in join order; and there is one at all."""
    seen = set()
    ok = bool(joined)
    for gen, compiles in joined:
        if gen in seen:
            ok = ok and compiles == "0"
        seen.add(gen)
    return ok


def _nan_candidate(src: str, dst: str) -> None:
    """``src``'s best checkpoint with every float leaf NaN, written with a
    valid manifest into ``dst``: a semantic regression the checkpoint
    layer cannot catch, only the rollout gate's golden batch."""
    from pytorch_cifar_tpu_torch.serialization import (
        msgpack_restore,
        to_bytes,
    )
    from pytorch_cifar_tpu_torch.train.checkpoint import payload_manifest

    with open(os.path.join(src, "ckpt.msgpack"), "rb") as f:
        tree = msgpack_restore(f.read())

    def poison(t):
        if isinstance(t, dict):
            return {k: poison(v) for k, v in t.items()}
        a = np.asarray(t)
        if np.issubdtype(a.dtype, np.floating):
            return np.full_like(a, np.nan)
        return a

    payload = to_bytes(poison(tree))
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(dst, "ckpt.msgpack"), "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    meta = dict(load_meta(src))
    meta["manifest"] = payload_manifest(payload)
    with open(os.path.join(dst, "ckpt.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())


def rollout_drill(args, work: str) -> dict:
    """The durable-control-plane drill. The deployment is split: this
    process hosts the edge (a ``Router(allow_empty=True)`` and its HTTP
    frontend, membership from a ``JournalFollower`` on the controller's
    journal) while the journaled controller runs as ``fleet_run --role
    controller``. Killing the controller stops decisions, never traffic.

    Phases:
      0. generation 1 published; controller #1 seeds 2 replicas through
         the journaled spawn path and the follower puts them behind the
         edge. Reference /predict bits taken; mixed load starts and runs
         through every later phase.
      1. generation 2 published under load: the controller begins a
         rolling deploy and surges one gated replica; the moment the surge
         line prints, the controller is SIGKILLed, mid-rollout.
      2. the edge serves headless. Controller #2 relaunches with
         ``--resume``: it replays the journal against /healthz and pid
         probes, adopts every journal-live replica (never spawning one of
         them again: /proc is the ground truth) and finishes the
         conversion: the fleet on gen 2, no failed request, /predict bit
         for bit the reference on every replica.
      3. a CRC-valid generation 3 with NaN weights is published: the gate
         must refuse it at surge, halt, restore the ``.prev`` publish pair
         and roll back fleet-wide to the gen-2 bits.
      4. SIGTERM drains the fleet; ``journal_inspect`` must replay the
         journal to the whole life cycle: 1 rollout, 1 rollback, no live
         replica, no orphan replica process.

    One gate is the port's own: a new generation's replicas join at
    compiles "0" after the first of their weight set. The port's
    cold-start cache keeps one prepared weight set per checkpoint, so the
    first replica of a generation whose weights the cache has not seen
    prepares them and compiles its buckets (JAX's cache holds executables
    that take any weights, so JAX's gate wants "0" from every one). The
    record keeps JAX's key, ``new_gen_compiles``. The launcher's record
    and each drained replica's own go to ``<work>/rollout.json``.
    """
    from pytorch_cifar_tpu_torch.obs import MetricsRegistry
    from pytorch_cifar_tpu_torch.serve.fleet import live_generation_probe
    from pytorch_cifar_tpu_torch.serve.frontend import ServingFrontend
    from pytorch_cifar_tpu_torch.serve.journal import (
        FleetJournalState,
        JournalFollower,
        replay_journal,
    )
    from pytorch_cifar_tpu_torch.serve.loadgen import HttpTarget, run_load
    from pytorch_cifar_tpu_torch.serve.router import Router
    from pytorch_cifar_tpu_torch.train.checkpoint import publish_checkpoint

    src = os.path.join(work, "ckpt")
    live = os.path.join(work, "live")
    jpath = os.path.join(work, "fleet.journal")
    train_checkpoint(args, "rollout", src)
    publish_checkpoint(src, live, extra_meta={"promotion": {"generation": 1}})

    # the data plane outlives the controller: membership follows the
    # journal, not the controller's word
    registry = MetricsRegistry()
    router = Router(
        [], allow_empty=True, registry=registry, probe_s=0.2
    ).start()
    frontend = ServingFrontend(router, registry=registry).start()
    follower = JournalFollower(jpath, router, poll_s=0.2).start()
    fleet_url = frontend.url
    print(
        f"==> [rollout] edge serving on {fleet_url} "
        "(membership follows the journal)", file=sys.stderr,
    )

    def controller_cmd(resume: bool):
        cmd = module_cmd(
            "tools.fleet_run",
            "--ckpt", live,
            "--model", args.model,
            "--role", "controller",
            "--fleet_url", fleet_url,
            "--journal", jpath,
            "--rollouts",
            "--min_replicas", 2,
            "--max_replicas", 3,
            "--buckets", 1, 4, 8,
            "--aot_cache", os.path.join(work, "aot"),
            "--deadline_ms", 4000,
            "--max_wait_ms", 1,
            "--control_interval_s", 0.25,
            # the scaling band parked wide open: the only actuations this
            # drill may observe are the rolling deploy's
            "--queue_high", 1000, "--queue_low", 0,
            "--up_after_s", 600, "--down_after_s", 600,
            "--up_cooldown_s", 600, "--down_cooldown_s", 600,
            "--device", args.device,
        )
        if resume:
            cmd.append("--resume")
        return cmd

    state_lock = threading.Lock()
    members = {}  # idx -> {"url", "pid", "compiles", "gen", "tag"}
    counts = {"canary_failed": 0}
    lines = []
    ev = {
        name: threading.Event()
        for name in ("surge", "done", "halt", "rolled_back", "resumed")
    }
    seed_re = re.compile(
        r"==> fleet: replica (\d+) pid=(\d+) url=(\S+) compiles=(\S+) "
        r"aot_hits=\S+ gen=(\S+)"
    )
    roll_re = re.compile(
        r"==> fleet: (rollout-surge|rollout-up|rollback-up|scale-up) "
        r"replica (\d+) url=(\S+) pid=(\d+) compiles=(\S+) gen=(\S+)"
    )

    def watch(proc):
        def run():
            for line in proc.stderr:
                sys.stderr.write(line)
                lines.append(line)
                m = seed_re.search(line)
                if m:
                    with state_lock:
                        members[int(m.group(1))] = {
                            "url": m.group(3), "pid": int(m.group(2)),
                            "compiles": m.group(4), "gen": m.group(5),
                            "tag": "seed",
                        }
                m = roll_re.search(line)
                if m:
                    with state_lock:
                        members[int(m.group(2))] = {
                            "url": m.group(3), "pid": int(m.group(4)),
                            "compiles": m.group(5), "gen": m.group(6),
                            "tag": m.group(1),
                        }
                if "rollout-surge replica" in line:
                    ev["surge"].set()
                if "rollout done gen=2" in line:
                    ev["done"].set()
                if "rollout halt gen=3" in line:
                    ev["halt"].set()
                if "rollout rolled back to gen=2" in line:
                    ev["rolled_back"].set()
                if "controller resumed from journal" in line:
                    ev["resumed"].set()
                if "rollout canary failed" in line:
                    with state_lock:
                        counts["canary_failed"] += 1

        t = threading.Thread(
            target=run, name="controller-stderr-watch", daemon=True
        )
        t.start()
        return t

    def journal_state():
        return FleetJournalState.from_records(replay_journal(jpath)[0])

    def teardown(*procs):
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        follower.stop()
        frontend.stop()
        router.stop()

    # -- phase 0: controller #1 seeds the gen-1 fleet ---------------------
    print(
        "==> [rollout] controller #1 up (seeding 2 replicas on gen 1)",
        file=sys.stderr,
    )
    ctl = _spawn(controller_cmd(resume=False))
    watch(ctl)
    deadline = time.monotonic() + args.timeout
    while time.monotonic() < deadline:
        if ctl.poll() is not None:
            teardown(ctl)
            raise SystemExit(
                f"controller #1 exited rc={ctl.returncode} before the "
                "fleet seeded"
            )
        if (
            int(_healthz(fleet_url).get("healthy_replicas", 0)) >= 2
            and journal_state().generation == 1
        ):
            break
        time.sleep(0.25)
    else:
        teardown(ctl)
        raise SystemExit("timed out waiting for the seeded gen-1 fleet")

    probe = np.random.RandomState(7).randint(
        0, 256, size=(3, 32, 32, 3)
    ).astype(np.uint8)
    ref_bits = _bits(fleet_url, probe)

    # mixed load through every phase, the headless window included
    reports = []
    load_stop = threading.Event()

    def load_loop():
        n = 0
        while not load_stop.is_set():
            n += 1
            target = HttpTarget(fleet_url)
            try:
                reports.append(run_load(
                    target, clients=2, requests_per_client=10**6,
                    images_max=4, seed=100 + n, duration_s=4.0,
                ))
            finally:
                target.close()

    load_t = threading.Thread(target=load_loop, name="rollout-load")
    load_t.start()

    # -- phase 1: publish gen 2, SIGKILL the controller at the surge ------
    print("==> [rollout] publishing generation 2 under load",
          file=sys.stderr)
    publish_checkpoint(src, live, extra_meta={"promotion": {"generation": 2}})
    if not ev["surge"].wait(args.timeout):
        load_stop.set()
        load_t.join()
        teardown(ctl)
        raise SystemExit("timed out waiting for the rollout surge")
    killed_mid_rollout = not ev["done"].is_set()
    print(
        f"==> [rollout] SIGKILL controller #1 (pid {ctl.pid}) at the "
        "surge, mid-rollout", file=sys.stderr,
    )
    ctl.kill()
    ctl.wait()

    # -- phase 2: the edge serves on; --resume finishes the deploy --------
    time.sleep(1.5)  # a headless window: traffic keeps flowing
    healthy_while_dead = int(_healthz(fleet_url).get("healthy_replicas", -1))
    st = journal_state()
    rollout_in_flight = st.rollout is not None
    pids_before_resume = {
        int(info["pid"]) for info in st.live_replicas().values()
    }
    with state_lock:
        surge_urls = {
            m["url"] for m in members.values()
            if m["tag"] == "rollout-surge"
        }

    print("==> [rollout] relaunching the controller with --resume",
          file=sys.stderr)
    ctl2 = _spawn(controller_cmd(resume=True))
    watch(ctl2)
    if not ev["resumed"].wait(60) or not ev["done"].wait(args.timeout):
        load_stop.set()
        load_t.join()
        teardown(ctl2)
        raise SystemExit("resumed controller never finished the rollout")

    # no double spawn: /proc == the journal's live view (drains of the
    # old generation may still be settling: poll)
    journal_live = journal_state().live_replicas()
    want_pids = {int(i["pid"]) for i in journal_live.values()}
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline and _serve_pids(live) != want_pids:
        time.sleep(0.5)
    proc_pids = _serve_pids(live)
    no_double_spawn = proc_pids == want_pids
    surge_survived = surge_urls and surge_urls <= set(journal_live)

    h = _healthz(fleet_url)
    fleet_entries = h.get("replicas", [])
    converted = (
        len(fleet_entries) == 2
        and all(r.get("generation") == 2 for r in fleet_entries)
    )
    identity_ok = all(
        np.array_equal(_bits(r["url"], probe), ref_bits)
        for r in fleet_entries
    ) and np.array_equal(_bits(fleet_url, probe), ref_bits)
    print(
        f"==> [rollout] fleet converted={converted} "
        f"bits={'match' if identity_ok else 'DIVERGE'} "
        f"pids={sorted(proc_pids)}", file=sys.stderr,
    )

    # -- phase 3: a NaN gen-3 candidate must halt + roll back -------------
    print("==> [rollout] publishing NaN generation 3 (gate must refuse)",
          file=sys.stderr)
    nan_dir = os.path.join(work, "nan3")
    _nan_candidate(src, nan_dir)
    publish_checkpoint(
        nan_dir, live, extra_meta={"promotion": {"generation": 3}}
    )
    halted = ev["halt"].wait(args.timeout)
    rolled_back = halted and ev["rolled_back"].wait(args.timeout)
    live_gen_after = live_generation_probe(live)()
    h = _healthz(fleet_url)
    still_gen2 = (
        int(h.get("healthy_replicas", -1)) == 2
        and all(r.get("generation") == 2 for r in h.get("replicas", []))
    )
    bits_after_rollback = np.array_equal(_bits(fleet_url, probe), ref_bits)

    # -- phase 4: drain; the journal replays the whole life cycle ---------
    load_stop.set()
    load_t.join()
    print("==> [rollout] drain", file=sys.stderr)
    ctl2.send_signal(signal.SIGTERM)
    out = ctl2.stdout.read()
    ctl2.wait(timeout=args.timeout)
    try:
        rec_run = _last_record(out, "fleet_run")
    except SystemExit:
        teardown(ctl2)
        raise
    _keep_records(work, "rollout", rec_run, lines)
    ji = subprocess.run(
        module_cmd("tools.journal_inspect", jpath, "--json"),
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    inspect_rec = (
        json.loads(ji.stdout) if ji.returncode == 0 else {"corrupt": True}
    )
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline and _serve_pids(live):
        time.sleep(0.5)
    orphans = _serve_pids(live)
    follower.stop()
    frontend.stop()
    router.stop()

    with state_lock:
        ledger = dict(members)
        canary_failed = counts["canary_failed"]
    new_gen = [
        (m["gen"], m["compiles"]) for m in ledger.values()
        if m["tag"] in ("rollout-surge", "rollout-up")
    ]
    new_gen_compiles = [c for _, c in new_gen]
    total_requests = sum(r["requests"] for r in reports)
    total_failed = sum(r["failed"] for r in reports)
    p99_max = max((r["p99_ms"] for r in reports), default=0.0)

    ok = (
        ctl2.returncode == 0
        and killed_mid_rollout
        and rollout_in_flight  # the journal knew, at the kill instant
        and healthy_while_dead >= 2  # the edge served on, headless
        and ev["resumed"].is_set()
        and ev["done"].is_set()
        and halted
        and rolled_back
        and canary_failed >= 1
        and rec_run["resumed"] is True
        and rec_run["journal_replays"] == 1
        # adopt every journal-live replica, spawn none of them again
        and rec_run["adoptions"] == len(pids_before_resume)
        and rec_run["adoptions"] >= 2
        and no_double_spawn
        and surge_survived  # the adopted surge replica finished the job
        and converted
        and identity_ok
        and _after_first_zero(new_gen)  # the port's gate (docstring)
        and rec_run["rollouts"] == 1
        and rec_run["rollbacks"] == 1
        and rec_run["generation"] == 2
        # a deploy is not a scale event
        and rec_run["scale_ups"] == 0
        and rec_run["scale_downs"] == 0
        and live_gen_after == 2  # the .prev pair came back fleet-wide
        and still_gen2
        and bits_after_rollback
        and total_requests > 0
        and total_failed == 0  # no failed request, in any phase
        and not inspect_rec.get("corrupt", True)
        and inspect_rec.get("rollouts") == 1
        and inspect_rec.get("rollbacks") == 1
        and inspect_rec.get("live_replicas") == []
        and inspect_rec.get("spawn_intents") == {}
        and orphans == set()
    )
    return {
        "harness": "chaos_run",
        "mode": "rollout",
        "match": ok,
        "killed_mid_rollout": killed_mid_rollout,
        "rollout_in_flight_at_kill": rollout_in_flight,
        "healthy_while_headless": healthy_while_dead,
        "resumed": ev["resumed"].is_set(),
        "adoptions": rec_run["adoptions"],
        "adoptable_at_kill": len(pids_before_resume),
        "no_double_spawn": no_double_spawn,
        "surge_survived": bool(surge_survived),
        "converted_to_gen2": converted,
        "bit_identical_after_rollout": identity_ok,
        "new_gen_compiles": new_gen_compiles,
        "halted_on_nan_candidate": halted,
        "rolled_back": rolled_back,
        "canary_failed_lines": canary_failed,
        "live_gen_after_rollback": live_gen_after,
        "fleet_gen2_after_rollback": still_gen2,
        "bit_identical_after_rollback": bits_after_rollback,
        "rollouts": rec_run["rollouts"],
        "rollbacks": rec_run["rollbacks"],
        "scale_ups": rec_run["scale_ups"],
        "scale_downs": rec_run["scale_downs"],
        "journal_replays": rec_run["journal_replays"],
        "journal_seq": rec_run["journal_seq"],
        "journal_inspect": {
            k: inspect_rec.get(k)
            for k in ("records", "rollouts", "rollbacks", "torn_tail")
        },
        "requests": total_requests,
        "failed": total_failed,
        "p99_max_ms": round(p99_max, 2),
        "orphan_pids": sorted(orphans),
        "controller_rc": ctl2.returncode,
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
    run, beside it the chaos run (signalled, or its preemption save
    damaged, or a step poisoned) and its resume, and the yardstick."""
    from pytorch_cifar_tpu_torch import faults

    dir_ref = os.path.join(work, "reference")
    dir_chaos = os.path.join(work, "chaos")

    print(f"==> [{args.mode}] reference run -> {dir_ref}", file=sys.stderr)
    reference = start_child(train_cmd(args, dir_ref), child_env())

    try:
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
    except BaseException:
        reference[0].kill()  # the chaos side failed: no orphan
        raise
    ref_s = finish_child(reference, args.timeout)

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
              "router": router_drill, "canary": canary_drill,
              "zoo": zoo_drill, "mesh": mesh_drill,
              "elastic": elastic_drill, "edge": edge_drill,
              "rollout": rollout_drill}
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
