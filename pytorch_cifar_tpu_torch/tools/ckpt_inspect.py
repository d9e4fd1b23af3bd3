"""Inspect and verify a checkpoint directory (formats v1/v2/v3).

The port's counterpart of the JAX package's ``tools/ckpt_inspect.py``: the
same report, keys, text and exit codes on the same directory (the two
packages write the same checkpoint bytes).

Lists every checkpoint candidate (primary + rolling history), its format,
epoch, and — for sharded v3 publishes — every shard with its manifest
verdict. Verifies what a restore would verify: v2 payloads against their
sidecar manifest, v3 shards against the commit marker's per-shard CRC32/
size entries plus the whole-payload manifest. Orphan shards (a torn
publish whose commit marker never landed — invisible to restore by
construction) are reported as warnings, not corruption.

Canary-pipeline awareness (``serve/canary.py``): quarantine
tombstones (``<stem>.quarantined.json``) are surfaced per checkpoint, the
report says whether the dir is a STAGING dir (marker file / name), and
live sidecars show their promotion generation. A quarantined checkpoint
inside a staging dir is routine evidence (the canary did its job); the
same tombstone in a dir being used as LIVE means a rejected checkpoint is
one watcher poll away from serving — that is an operator error, reported
with exit code 2.

Exit codes: 0 = every committed checkpoint verifies; 1 = corruption found
(a restore would have to fall back past it); 2 = usage/IO error, or a
QUARANTINED checkpoint in a non-staging (live) dir.

Usage:
  python -m pytorch_cifar_tpu_torch.tools.ckpt_inspect ./checkpoint
  python -m pytorch_cifar_tpu_torch.tools.ckpt_inspect ./checkpoint --json

Stdlib + checkpoint-module only: it touches no device, so it is safe to
point at a live training run's output dir (reads are racy against a
publish in flight — re-run, like the reload watcher re-polls).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import zlib


def _load_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _verify_bytes(path, manifest):
    """problems list for one payload/shard file vs its manifest entry."""
    problems = []
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        return None, [f"{os.path.basename(path)}: missing ({e.strerror})"]
    if manifest:
        if len(blob) != int(manifest.get("size", -1)):
            problems.append(
                f"{os.path.basename(path)}: {len(blob)} bytes, manifest "
                f"says {manifest.get('size')} (truncated/torn)"
            )
        crc = zlib.crc32(blob) & 0xFFFFFFFF
        if crc != int(manifest.get("crc32", -1)):
            problems.append(
                f"{os.path.basename(path)}: crc32 {crc:#010x} != manifest "
                f"{int(manifest.get('crc32', -1)):#010x} (bit corruption)"
            )
    return blob, problems


def inspect_candidate(ckpt_dir, name):
    """One checkpoint candidate -> report dict (see module docstring)."""
    from pytorch_cifar_tpu_torch.train.checkpoint import (
        is_quarantined,
        meta_path,
        read_quarantine,
    )

    meta = _load_json(meta_path(ckpt_dir, name)) or {}
    payload_path = os.path.join(ckpt_dir, name)
    shards = meta.get("shards")
    promo = (meta.get("promotion") or {}) if isinstance(meta, dict) else {}
    rep = {
        "name": name,
        "epoch": meta.get("epoch"),
        "best_acc": meta.get("best_acc"),
        "promotion_generation": promo.get("generation"),
        "quarantined": None,
        "problems": [],
        "shards": [],
    }
    # quarantine tombstone (canary verdict): active only when its
    # fingerprint matches the CURRENT publish — a stale tombstone from an
    # earlier rejected candidate is reported as inert
    tomb = read_quarantine(ckpt_dir, name)
    if tomb is not None:
        rep["quarantined"] = {
            "active": is_quarantined(ckpt_dir, name, meta),
            "reason": tomb.get("reason"),
            "epoch": tomb.get("epoch"),
        }
    if shards:
        rep["format"] = 3
        # v3 publish topology: one shard per saving process, so the
        # shard count IS the process span of the mesh that wrote it —
        # the offline half of the topology diagnosis (/healthz's `mesh`
        # block is the serving-time half)
        rep["saved_process_count"] = len(shards)
        parts = []
        for s in shards:
            blob, probs = _verify_bytes(
                os.path.join(ckpt_dir, s["name"]),
                {"size": s.get("size"), "crc32": s.get("crc32")},
            )
            rep["shards"].append(
                {"name": s["name"], "ok": not probs, "size": s.get("size")}
            )
            rep["problems"].extend(probs)
            if blob is not None:
                parts.append(blob)
        if not rep["problems"]:
            total = meta.get("total") or {}
            payload = b"".join(parts)
            if total and (
                len(payload) != int(total.get("size", -1))
                or (zlib.crc32(payload) & 0xFFFFFFFF)
                != int(total.get("crc32", -1))
            ):
                rep["problems"].append(
                    f"{name}: reassembled payload fails the whole-payload "
                    "manifest (shard set inconsistent)"
                )
    elif meta.get("manifest"):
        rep["format"] = 2
        _, probs = _verify_bytes(payload_path, meta["manifest"])
        rep["problems"].extend(probs)
    else:
        rep["format"] = 1
        if not os.path.isfile(payload_path):
            rep["problems"].append(f"{name}: payload missing")
        else:
            rep["problems"].append(
                f"{name}: no manifest (format v1) — restorable but "
                "unverifiable; re-save to upgrade"
            )
    rep["ok"] = not rep["problems"] or rep["format"] == 1
    return rep


def inspect_aot_cache(ckpt_dir):
    """Cache entries in this dir (``*.aotx`` + sidecar; the JAX package's
    bucket programs or the port's per-bucket entries, whose shared weight
    sets sit in ``weights/``, out of this listing), grouped by (model,
    bucket, process span) with the ranks that exported one. A
    multi-process group missing some rank's entry is HALF-POPULATED: the
    trace a half-joined JAX mesh replica leaves behind (a port replica is
    one process, so its entries never are)."""
    groups = {}
    poisoned = []
    for p in sorted(glob.glob(os.path.join(ckpt_dir, "*.aotx.json"))):
        meta = _load_json(p) or {}
        key = meta.get("key") or {}
        name = os.path.basename(p)[: -len(".json")]
        if meta.get("poisoned"):
            poisoned.append(name)
        gk = (
            str(key.get("model")),
            int(key.get("bucket", -1)),
            int(key.get("process_count", 1)),
        )
        g = groups.setdefault(
            gk,
            {
                "model": gk[0],
                "bucket": gk[1],
                "process_count": gk[2],
                "processes_present": set(),
                "devices_per_process": None,
            },
        )
        g["processes_present"].add(int(key.get("process_index", 0)))
        n_dev = len(key.get("devices") or [])
        if n_dev and gk[2]:
            g["devices_per_process"] = n_dev // gk[2] or n_dev
    out = []
    for g in groups.values():
        present = sorted(g["processes_present"])
        out.append(
            {
                **g,
                "processes_present": present,
                "half_populated": (
                    g["process_count"] > 1
                    and len(present) < g["process_count"]
                ),
            }
        )
    out.sort(key=lambda g: (g["model"], g["bucket"], g["process_count"]))
    return {
        "entries": out,
        "poisoned": poisoned,
        "half_populated": [
            f"{g['model']} bucket {g['bucket']}"
            for g in out
            if g["half_populated"]
        ],
    }


def inspect_dir(ckpt_dir):
    from pytorch_cifar_tpu_torch.train.checkpoint import (
        history_names,
        is_staging_dir,
    )

    # candidates: every non-shard sidecar, plus manifest-less v1 payloads
    names = set()
    for p in glob.glob(os.path.join(ckpt_dir, "*.json")):
        base = os.path.basename(p)
        if (
            ".shard" in base
            or base.endswith(".aotx.json")
            or base.endswith(".quarantined.json")
        ):
            continue
        names.add(os.path.splitext(base)[0] + ".msgpack")
    for p in glob.glob(os.path.join(ckpt_dir, "*.msgpack")):
        base = os.path.basename(p)
        if ".shard" not in base:
            names.add(base)

    reports = [inspect_candidate(ckpt_dir, n) for n in sorted(names)]

    # orphan shards: shard files no commit marker references — the trace
    # of a torn publish (harmless: restore can never see them)
    referenced = set()
    for r in reports:
        referenced.update(s["name"] for s in r["shards"])
    orphans = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(ckpt_dir, "*.shard*-of-*.msgpack"))
        if os.path.basename(p) not in referenced
    )
    # history listing sanity ride-along: names history_names knows about
    primaries = sorted(
        n for n in names if "-e" not in os.path.splitext(n)[0]
    )
    history = {
        n: history_names(ckpt_dir, n) for n in primaries
    }
    corrupt = [r["name"] for r in reports if not r["ok"]]
    aot = inspect_aot_cache(ckpt_dir)
    staging = is_staging_dir(ckpt_dir)
    quarantined = [
        r["name"]
        for r in reports
        if (r.get("quarantined") or {}).get("active")
    ]
    return {
        "dir": ckpt_dir,
        "staging": staging,
        "checkpoints": reports,
        "orphan_shards": orphans,
        "history": history,
        "corrupt": corrupt,
        # cache entries: per-(model, bucket, process-span) groups with
        # the ranks present (inspect_aot_cache)
        "aot_cache": aot,
        "quarantined": quarantined,
        # a rejected checkpoint sitting in a LIVE dir is one watcher poll
        # from serving: the operator error this tool exists to catch
        "quarantined_as_live": bool(quarantined) and not staging,
        "ok": not corrupt,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ckpt_dir", help="checkpoint directory to inspect")
    ap.add_argument(
        "--json", action="store_true", help="machine-readable report"
    )
    args = ap.parse_args(argv)
    if not os.path.isdir(args.ckpt_dir):
        print(f"error: {args.ckpt_dir!r} is not a directory", file=sys.stderr)
        return 2
    report = inspect_dir(args.ckpt_dir)
    if args.json:
        print(json.dumps(report))
    else:
        if report["staging"]:
            print("STAGING dir (canary pipeline input — never serve "
                  "directly)")
        for r in report["checkpoints"]:
            status = "OK" if r["ok"] else "CORRUPT"
            extra = (
                f" ({len(r['shards'])} shards — saved by a "
                f"{r['saved_process_count']}-process mesh)"
                if r["shards"]
                else ""
            )
            if r.get("promotion_generation") is not None:
                extra += f" [promotion gen {r['promotion_generation']}]"
            print(
                f"{r['name']}: format v{r['format']}, epoch "
                f"{r['epoch']}{extra} — {status}"
            )
            for p in r["problems"]:
                print(f"  ! {p}")
            q = r.get("quarantined")
            if q:
                kind = "QUARANTINED" if q["active"] else (
                    "stale tombstone (older rejected publish)"
                )
                print(f"  ! {kind}: {q.get('reason')}")
        for o in report["orphan_shards"]:
            print(f"orphan shard (torn publish, invisible to restore): {o}")
        for g in report["aot_cache"]["entries"]:
            span = (
                f"{len(g['processes_present'])}/{g['process_count']} "
                f"processes"
                if g["process_count"] > 1
                else "single-process"
            )
            note = (
                " — HALF-POPULATED (a rank never exported: half-joined "
                "mesh replica trace; next launch compiles everywhere)"
                if g["half_populated"]
                else ""
            )
            print(
                f"aot cache: {g['model']} bucket {g['bucket']} "
                f"[{span}]{note}"
            )
        for p in report["aot_cache"]["poisoned"]:
            print(f"aot cache: {p} POISONED (probe-refuted; see sidecar)")
        if report["quarantined_as_live"]:
            print(
                "verdict: QUARANTINED-AS-LIVE — a rejected checkpoint "
                "sits in a non-staging dir "
                f"({', '.join(report['quarantined'])})"
            )
        else:
            print("verdict:", "OK" if report["ok"] else "CORRUPT")
    if report["quarantined_as_live"]:
        return 2
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
