"""Inspect and verify a controller journal (serve/journal.py).

The port's counterpart of the JAX package's ``tools/journal_inspect.py``:
the same report, keys, text and exit codes on the same journal (the two
packages write the same journal bytes).

Replays the journal exactly the way ``fleet_run.py --resume`` would —
snapshot first (if its commit marker verifies), then the live records —
and prints what a relaunched controller would believe: the live replica
set it would try to re-adopt (idx/pid/url/generation/draining), the
fleet generation, any rolling deploy in flight (target generation +
phase), pending spawn intents (the torn-spawn window), and the vetting
pipeline's last durable verdict state.

A TORN final line (the append that was racing the crash) is reported
but is NOT corruption — replay tolerates it by construction. Damage
anywhere else (CRC mismatch, truncation mid-file, a sequence number
that runs backwards) means the journal cannot be trusted and is
reported as CORRUPT.

Exit codes: 0 = replayable (torn tail included); 2 = corrupt journal or
usage/IO error — the same "do not trust this state" severity as
ckpt_inspect's live-quarantine verdict.

Usage:
  python -m pytorch_cifar_tpu_torch.tools.journal_inspect fleet.journal
  python -m pytorch_cifar_tpu_torch.tools.journal_inspect fleet.journal --json

Stdlib + journal-module only: it loads no torch and touches no device, so
it is safe to point at a LIVE controller's journal (reads race the writer; a
torn tail just means you caught an append mid-flight — re-run).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from pytorch_cifar_tpu_torch.serve.journal import (
    SNAPSHOT_MARKER_SUFFIX,
    FleetJournalState,
    JournalCorrupt,
    replay_journal,
)


def inspect_journal(path: str) -> dict:
    """Replay ``path`` -> report dict (raises JournalCorrupt/OSError)."""
    if not os.path.exists(path) and not os.path.exists(
        path + SNAPSHOT_MARKER_SUFFIX
    ):
        # replay treats a missing journal as first-boot-empty; for an
        # INSPECTOR that silence would hide a typo'd path
        raise OSError(f"no journal at {path}")
    records, torn = replay_journal(path)
    state = FleetJournalState.from_records(records)
    last_seq = max(
        (int(r.get("seq", 0)) for r in records), default=0
    )
    return {
        "path": path,
        "corrupt": False,
        "records": len(records),
        "last_seq": last_seq,
        "torn_tail": bool(torn),
        "compacted": os.path.exists(path + SNAPSHOT_MARKER_SUFFIX),
        "generation": state.generation,
        "promotion_generation": state.promotion_generation,
        "replicas": {
            url: dict(info) for url, info in sorted(state.replicas.items())
        },
        "live_replicas": sorted(state.live_replicas().keys()),
        "spawn_intents": {
            str(k): v for k, v in sorted(state.spawn_intents.items())
        },
        "rollout": state.rollout,
        "rollouts": state.rollouts,
        "rollbacks": state.rollbacks,
        "vetting": state.vetting,
        "policy_state": state.policy_state,
    }


def _print_human(report: dict) -> None:
    print(f"journal: {report['path']}")
    verdict = "REPLAYABLE"
    if report["torn_tail"]:
        verdict += " (torn final line — the append racing the crash)"
    print(
        f"  verdict: {verdict}  records={report['records']} "
        f"last_seq={report['last_seq']} "
        f"compacted={'yes' if report['compacted'] else 'no'}"
    )
    print(
        f"  generation: fleet={report['generation']} "
        f"promotion={report['promotion_generation']}"
    )
    ro = report["rollout"]
    if ro:
        print(
            f"  rollout IN FLIGHT: gen {ro.get('from_generation')} -> "
            f"{ro.get('to_generation')} phase={ro.get('phase')} "
            f"n_start={ro.get('n_start')}"
        )
    print(
        f"  deploys: rollouts={report['rollouts']} "
        f"rollbacks={report['rollbacks']}"
    )
    if report["replicas"]:
        print("  replicas a resumed controller would probe:")
        for url, info in report["replicas"].items():
            state = "DRAINING" if info.get("draining") else "live"
            print(
                f"    [{info.get('idx')}] {url} pid={info.get('pid')} "
                f"gen={info.get('generation')} "
                f"compiles={info.get('compiles')} {state}"
            )
    else:
        print("  replicas: none recorded")
    if report["spawn_intents"]:
        print(
            "  PENDING spawn intents (journaled, never came up — the "
            "torn-spawn window): idx "
            + ", ".join(report["spawn_intents"])
        )
    if report["vetting"]:
        print(f"  vetting in flight: {report['vetting']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0], prog="journal_inspect"
    )
    ap.add_argument("journal", help="controller journal path")
    ap.add_argument(
        "--json", action="store_true",
        help="emit ONE machine-readable JSON line instead of the table",
    )
    args = ap.parse_args(argv)
    try:
        report = inspect_journal(args.journal)
    except JournalCorrupt as e:
        report = {"path": args.journal, "corrupt": True, "error": str(e)}
        if args.json:
            print(json.dumps(report, sort_keys=True))
        else:
            print(f"journal: {args.journal}")
            print(f"  verdict: CORRUPT — {e}")
            print(
                "  a resumed controller would refuse this journal; "
                "recover membership from /healthz + /proc instead"
            )
        return 2
    except OSError as e:
        print(f"journal_inspect: cannot read {args.journal}: {e}",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        _print_human(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
