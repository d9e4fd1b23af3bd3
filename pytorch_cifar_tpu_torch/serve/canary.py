"""Canary promotion pipeline: no unvetted checkpoint reaches the fleet.

Counterpart of ``pytorch_cifar_tpu/serve/canary.py``: the same state
machine, budget terms, metric names (``canary.*``) and tombstone reasons.

- The trainer publishes into a **staging** dir (``--publish staging``;
  ``train/checkpoint.py``) that no serving watcher loads
  (``serve/reload.py`` refuses staging dirs).
- A **canary engine**, a full :class:`InferenceEngine` holding its own copy
  of the weights, loads each staged candidate and shadows a slice of live
  traffic: :class:`ShadowBackend` (one replica) or the router's
  ``attach_shadow`` tees each answered interactive request to it, off the
  client's path, so clients keep their bits and deadlines whatever the
  candidate does.
- The :class:`PromotionController` vets the candidate **exactly, not
  statistically**: the canary's logits for a weight set equal the fleet's
  bit for bit (the same model, dtype, bucket and card), so "how many golden
  rows changed answer" is a count. Against a :class:`CanaryBudget` it
  either **promotes** (``publish_checkpoint`` into the live dir, payload
  first and sidecar last, the promotion generation stamped into the
  sidecar) or **rolls the canary back and quarantines** the candidate (a
  tombstone sidecar and ``canary.rejected``; the fleet never saw a byte of
  it).

State machine, one candidate at a time, driven by ``poll_once``::

    staging ──load+golden ok──> shadowing ──shadow budget ok──> promoted
       │  └─corrupt / wrong-model / golden fail──> quarantined     │
       │                   └──shadow budget blown──> quarantined   │
       └──────────────<─────(next staged publish)─────<────────────┘

Budget terms (each an exact count):

- ``max_nonfinite``: golden rows allowed a non-finite logit (a NaN'd
  checkpoint fails here: the file itself is committed and CRC-clean);
- ``acc_margin``: with labeled golden data, how many accuracy points the
  candidate may trail the incumbent;
- ``max_flip_frac``: the fraction of golden rows whose argmax may differ
  from the incumbent's, the gate for unlabeled golden data only (with
  labels the flips are recorded as diagnostics: an improving candidate
  flips answers freely);
- ``min_shadow_requests`` / ``max_shadow_errors`` /
  ``max_shadow_flip_frac``: the live-traffic soak before promotion (0 =
  golden-only).

A CRC-corrupt candidate never reaches vetting: the verified load rejects
it and the controller quarantines it after one poll of grace. Rollback
swaps the incumbent's ``state_dict`` (``weights_host``) back in, so the
canary's post-rollback outputs are the pre-candidate bits.

``tools/pipeline_run.py`` (``python -m
pytorch_cifar_tpu_torch.tools.pipeline_run``) wires the loop into one
process.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from pytorch_cifar_tpu_torch.obs import MetricsRegistry, trace
from pytorch_cifar_tpu_torch.serve.engine import load_checkpoint_trees
from pytorch_cifar_tpu_torch.serve.journal import FleetJournalState
from pytorch_cifar_tpu_torch.train.checkpoint import (
    CKPT_NAME,
    CheckpointCorrupt,
    is_quarantined,
    meta_path,
    publish_checkpoint,
    quarantine_checkpoint,
    read_meta,
)

log = logging.getLogger(__name__)

# canary replica states (module docstring); the gauge encodes this order
STAGING = "staging"
SHADOWING = "shadowing"
PROMOTED = "promoted"
QUARANTINED = "quarantined"
_STATE_IDS = {STAGING: 0, SHADOWING: 1, PROMOTED: 2, QUARANTINED: 3}


class GoldenSet:
    """The deterministic vetting batches every candidate answers before
    it may touch live traffic. ``labels`` are optional: with them the
    budget's accuracy gate applies (the principled regression check);
    without them the exact flip-count gate still does."""

    def __init__(self, images, labels=None):
        self.images = np.ascontiguousarray(np.asarray(images, np.uint8))
        if self.images.ndim != 4:
            raise ValueError(
                f"golden images must be (n, h, w, c), got "
                f"{self.images.shape}"
            )
        self.labels = None if labels is None else np.asarray(labels)
        if self.labels is not None and len(self.labels) != len(self.images):
            raise ValueError("golden labels/images length mismatch")

    def __len__(self) -> int:
        return int(self.images.shape[0])

    @classmethod
    def synthetic_eval(
        cls, n_train: int = 2048, n_test: int = 512, seed: int = 0,
        limit: int = 256,
    ) -> "GoldenSet":
        """The synthetic CIFAR eval split a ``--synthetic_data`` trainer
        evaluates on (``data.cifar10.synthetic_cifar10`` is
        (sizes, seed)-deterministic), capped at ``limit`` rows, so the
        golden accuracy gate measures what the trainer's best-checkpoint
        gate optimizes."""
        from pytorch_cifar_tpu_torch.data.cifar10 import synthetic_cifar10

        _, _, x, y = synthetic_cifar10(
            n_train=n_train, n_test=n_test, seed=seed
        )
        return cls(x[:limit], y[:limit])

    @classmethod
    def labeled_eval(
        cls, data_dir: str = "./data", *, limit: int = 256, seed: int = 0,
    ) -> "GoldenSet":
        """The real labeled CIFAR-10 test split as golden data, so the
        accuracy gate judges labeled accuracy. Falls back loudly to the
        synthetic eval split when the archive is absent (the gate's
        semantics are the same; only the labels' provenance differs)."""
        from pytorch_cifar_tpu_torch.data.cifar10 import (
            _find_dataset,
            load_cifar10,
            synthetic_cifar10,
        )

        if _find_dataset(data_dir) is None:
            log.warning(
                "labeled_eval: CIFAR-10 not found under %r; golden "
                "accuracy gates run on the SYNTHETIC eval split (same "
                "exact-count semantics, synthetic labels)", data_dir,
            )
            _, _, x, y = synthetic_cifar10(seed=seed)
        else:
            _, _, x, y = load_cifar10(data_dir, synthetic_ok=True)
        return cls(x[:limit], y[:limit])

    @classmethod
    def random(
        cls, n: int = 64, seed: int = 0, image_shape=(32, 32, 3)
    ) -> "GoldenSet":
        """Unlabeled random batches: the finiteness + exact-flip gates
        only (bench and tests)."""
        rs = np.random.RandomState(seed)
        return cls(rs.randint(0, 256, size=(n, *image_shape)).astype(np.uint8))


class CanaryBudget:
    """Sentinel-style promotion budget (module docstring). Every term is
    an exact count over golden/shadowed rows, so a verdict is
    reproducible — rerunning the same candidate against the same
    incumbent yields the same decision, bit for bit."""

    def __init__(
        self,
        *,
        max_nonfinite: int = 0,
        max_flip_frac: float = 0.5,
        acc_margin: float = 1.0,
        min_shadow_requests: int = 0,
        max_shadow_errors: int = 0,
        max_shadow_flip_frac: Optional[float] = None,
    ):
        self.max_nonfinite = int(max_nonfinite)
        self.max_flip_frac = float(max_flip_frac)
        self.acc_margin = float(acc_margin)
        self.min_shadow_requests = int(min_shadow_requests)
        self.max_shadow_errors = int(max_shadow_errors)
        self.max_shadow_flip_frac = (
            float(max_shadow_flip_frac)
            if max_shadow_flip_frac is not None
            else float(max_flip_frac)
        )


class PromotionController:
    """The canary replica's state machine (module docstring).

    ``canary_engine`` must hold the INCUMBENT weights at construction
    (build it from the live dir) — they are snapshotted as the rollback
    target and their golden logits become the exact comparison baseline.
    ``poll_once`` drives one step deterministically (tests and bench);
    ``start``/``stop`` run it on a poll thread plus a shadow worker, both
    joined on stop (no thread leak). Every cross-thread attribute is
    mutated only under ``self._cond``.

    ``journal`` (a :class:`~pytorch_cifar_tpu_torch.serve.journal.ControllerJournal`)
    makes the vetting durable: ``vet-begin`` is appended before the
    candidate swap, the verdict before the publish or quarantine, and a
    relaunched controller resumes its generation from the journal."""

    def __init__(
        self,
        canary_engine,
        staging_dir: str,
        live_dir: str,
        *,
        golden: GoldenSet,
        budget: Optional[CanaryBudget] = None,
        name: str = CKPT_NAME,
        poll_s: float = 0.5,
        shadow_fraction: float = 0.25,
        shadow_queue: int = 64,
        registry: Optional[MetricsRegistry] = None,
        journal=None,
    ):
        self.engine = canary_engine
        self.staging_dir = staging_dir
        self.live_dir = live_dir
        # durable control plane: in-flight vetting + the generation
        # counter survive a controller restart via the shared journal
        # (serve/journal.py) — vet-begin is appended before the candidate
        # swap, the verdict before the publish/quarantine actuation
        self.journal = journal
        self.golden = golden
        self.budget = budget if budget is not None else CanaryBudget()
        self.name = name
        self.poll_s = float(poll_s)
        self.shadow_fraction = float(shadow_fraction)
        self.shadow_queue = int(shadow_queue)
        self.obs = registry if registry is not None else MetricsRegistry()
        self._c_candidates = self.obs.counter("canary.candidates")
        self._c_promotions = self.obs.counter("canary.promotions")
        self._c_rejected = self.obs.counter("canary.rejected")
        self._c_shadow_requests = self.obs.counter("canary.shadow_requests")
        self._c_shadow_rows = self.obs.counter("canary.shadow_rows")
        self._c_shadow_flips = self.obs.counter("canary.shadow_flip_rows")
        self._c_shadow_identical = self.obs.counter("canary.shadow_identical")
        self._c_shadow_errors = self.obs.counter("canary.shadow_errors")
        self._c_shadow_dropped = self.obs.counter("canary.shadow_dropped")
        self._h_promote = self.obs.histogram("canary.promote_ms")
        self._h_golden = self.obs.histogram("canary.golden_ms")
        self._h_shadow = self.obs.histogram("canary.shadow_ms")
        self._g_generation = self.obs.gauge("canary.generation")
        self._g_state = self.obs.gauge("canary.state")
        self._g_shadow_remaining = self.obs.gauge(
            "canary.shadow_budget_remaining"
        )
        # ONE condition over every cross-thread field below: the poll
        # thread, the shadow worker, offer() callers (frontend handler
        # threads), and status() readers all take it
        self._cond = threading.Condition()
        self.state = STAGING
        self.generation = 0
        if journal is not None:
            # restart-safety: resume the generation counter from the
            # journal's vetting ledger so a relaunched controller never
            # re-issues an already-served generation number
            replayed = FleetJournalState.from_records(journal.records())
            if replayed.promotion_generation is not None:
                self.generation = int(replayed.promotion_generation)
        self.last_rejected: Optional[dict] = None
        self._seen_sig = None
        self._corrupt_sig = None
        self._candidate: Optional[dict] = None
        self._candidate_sig = None
        # monotonically bumped on every verdict: shadow samples carry the
        # token they were offered under, so a result computed against a
        # retired candidate can never pollute the next one's accounting
        self._token = 0
        self._offers = 0
        self._queue: deque = deque()
        self._shadow = self._zero_shadow()
        self._stop = threading.Event()
        self._stopping = False
        self._poll_thread: Optional[threading.Thread] = None
        self._shadow_thread: Optional[threading.Thread] = None
        # incumbent snapshot: rollback target + exact golden baseline
        self._incumbent = canary_engine.weights_host()
        base = self._golden_eval()
        self._incumbent_logits = base["logits"]
        self._incumbent_argmax = base["argmax"]
        self._incumbent_acc = base["acc"]
        self._g_state.set(_STATE_IDS[STAGING])

    @staticmethod
    def _zero_shadow() -> dict:
        return {
            "requests": 0, "rows": 0, "flip_rows": 0, "identical": 0,
            "errors": 0,
        }

    # -- staging signature (same scheme as the reload watcher) ----------

    def _journal(self, op: str, **fields) -> None:
        """Durably append one vetting record BEFORE the actuation it
        describes (no-op without a journal — the pre-durable behavior)."""
        if self.journal is not None:
            # ControllerJournal.append takes its own lock and fsyncs: not
            # under self._cond, which would hold the vetting lock across
            # disk I/O
            self.journal.append(op, **fields)

    def _signature(self):
        def stat_of(path):
            try:
                st = os.stat(path)
            except OSError:
                return None
            return (st.st_ino, st.st_mtime_ns, st.st_size)

        payload = stat_of(os.path.join(self.staging_dir, self.name))
        sidecar = stat_of(meta_path(self.staging_dir, self.name))
        if payload is None and sidecar is None:
            return None
        return (payload, sidecar)

    def pending_candidate(self) -> bool:
        """True while a staged publish still awaits a verdict — what a
        pipeline driver polls before declaring the run quiesced."""
        sig = self._signature()
        with self._cond:
            return self.state == SHADOWING or (
                sig is not None and sig != self._seen_sig
            )

    # -- golden vetting (exact) -----------------------------------------

    def _golden_eval(self) -> dict:
        """Exact golden verdict for whatever weights the canary engine
        currently serves: logits, per-row argmax, non-finite row count,
        and (with labels) exact accuracy."""
        t0 = time.perf_counter()
        logits = np.asarray(self.engine.predict(self.golden.images))
        ms = (time.perf_counter() - t0) * 1e3
        self._h_golden.observe(ms)
        am = np.argmax(logits, axis=-1)
        finite_rows = np.isfinite(logits).all(axis=-1)
        acc = None
        if self.golden.labels is not None:
            acc = 100.0 * float(np.mean(am == self.golden.labels))
        return {
            "logits": logits,
            "argmax": am,
            "nonfinite": int(np.sum(~finite_rows)),
            "acc": acc,
            "ms": ms,
        }

    def _golden_failures(self, verdict: dict) -> list:
        """Budget verdict for one candidate's golden eval; also annotates
        ``verdict`` with the exact diff counts vs the incumbent."""
        b = self.budget
        n = len(self.golden)
        with self._cond:
            inc_am = self._incumbent_argmax
            inc_logits = self._incumbent_logits
            inc_acc = self._incumbent_acc
        flips = int(np.sum(verdict["argmax"] != inc_am))
        verdict["flips"] = flips
        verdict["flip_frac"] = flips / max(1, n)
        # the exact-diff measure bit-identity buys us: rows whose logits
        # are IDENTICAL to the incumbent's (same weights -> n identical)
        verdict["identical_rows"] = int(
            np.sum(np.all(verdict["logits"] == inc_logits, axis=-1))
        )
        fails = []
        if verdict["nonfinite"] > b.max_nonfinite:
            fails.append(
                f"nonfinite logits on {verdict['nonfinite']}/{n} golden "
                f"rows (budget {b.max_nonfinite})"
            )
        labeled = verdict["acc"] is not None and inc_acc is not None
        if labeled:
            # the principled regression gate: exact accuracy vs the
            # incumbent on the SAME rows. Flips stay diagnostics here —
            # an early-training candidate flips most answers while
            # accuracy climbs (module docstring).
            if verdict["acc"] < inc_acc - b.acc_margin:
                fails.append(
                    f"golden accuracy {verdict['acc']:.2f}% regressed "
                    f"past incumbent {inc_acc:.2f}% - {b.acc_margin:.2f} "
                    "margin"
                )
        elif verdict["flip_frac"] > b.max_flip_frac:
            fails.append(
                f"golden argmax flipped on {flips}/{n} rows "
                f"({verdict['flip_frac']:.2f} > budget {b.max_flip_frac})"
            )
        return fails

    # -- the state machine ----------------------------------------------

    def poll_once(self) -> Optional[str]:
        """Drive the state machine one step. Returns the state entered on
        a transition (``shadowing``/``promoted``/``quarantined``), None
        when nothing changed. Split out so tests and bench drive the
        pipeline without timing dependence."""
        with self._cond:
            shadowing = self.state == SHADOWING
        if shadowing:
            return self._check_shadow_budget()
        sig = self._signature()
        if sig is None:
            return None
        with self._cond:
            if sig == self._seen_sig:
                return None
        meta = read_meta(self.staging_dir, self.name)
        if is_quarantined(self.staging_dir, self.name, meta):
            with self._cond:
                self._seen_sig = sig  # already judged: never re-vetted
            return None
        wrong_model = None
        state_dict = None
        try:
            state_dict, meta = load_checkpoint_trees(
                os.path.join(self.staging_dir, self.name),
                self.engine.model_name,
                num_classes=self.engine.num_classes,
            )
        except (KeyError, ValueError) as e:
            # verified, but another model's tree: the port maps the tree
            # while loading, so this is where the JAX engine's swap-time
            # aval check fails; it is judged at the swap gate below
            wrong_model = e
        except (FileNotFoundError, CheckpointCorrupt) as e:
            # one-poll grace: a publish racing this read looks corrupt
            # until its sidecar rename lands (new payload, old manifest).
            # Only the SAME signature failing again — a settled pair that
            # still does not verify — is a genuinely corrupt candidate.
            with self._cond:
                settled = self._corrupt_sig == sig
                self._corrupt_sig = sig
            if not settled:
                return None
            with self._cond:
                self._seen_sig = sig
            self._c_candidates.inc()
            return self._reject(f"corrupt candidate: {e}", meta)
        if self._signature() != sig:
            return None  # republished mid-read; the next poll settles it
        with self._cond:
            self._corrupt_sig = None
        self._c_candidates.inc()
        # in-flight vetting is journaled BEFORE the candidate touches the
        # canary engine: a controller relaunched mid-vet knows exactly
        # which candidate was on the bench (durable control plane)
        self._journal(
            "vet-begin",
            signature=list(sig) if sig is not None else None,
            epoch=meta.get("epoch"),
        )
        try:
            if wrong_model is not None:
                raise ValueError(
                    f"refusing weight swap: {wrong_model}"
                ) from wrong_model
            self.engine.swap_weights(state_dict)
        except ValueError as e:
            with self._cond:
                self._seen_sig = sig
            return self._reject(f"wrong-model candidate: {e}", meta)
        with self._cond:
            self._seen_sig = sig
            self._candidate_sig = sig
            self._candidate = {"meta": meta, "state_dict": state_dict}
            self._shadow = self._zero_shadow()
            self._token += 1
            self.state = SHADOWING
        self._g_state.set(_STATE_IDS[SHADOWING])
        self._g_shadow_remaining.set(self.budget.min_shadow_requests)
        trace.instant(
            "canary/candidate", epoch=meta.get("epoch"),
            best_acc=meta.get("best_acc"),
        )
        verdict = self._golden_eval()
        failures = self._golden_failures(verdict)
        with self._cond:
            if self._candidate is not None:
                self._candidate["golden"] = verdict
        if failures:
            return self._reject("; ".join(failures), meta)
        if self.budget.min_shadow_requests <= 0:
            return self._promote(meta)
        log.info(
            "canary shadowing candidate epoch %s (golden: %d/%d flips, "
            "acc %s): needs %d shadow requests",
            meta.get("epoch"), verdict["flips"], len(self.golden),
            f"{verdict['acc']:.2f}%" if verdict["acc"] is not None else "n/a",
            self.budget.min_shadow_requests,
        )
        return SHADOWING

    def _check_shadow_budget(self) -> Optional[str]:
        b = self.budget
        with self._cond:
            s = dict(self._shadow)
            meta = (self._candidate or {}).get("meta", {})
        if s["errors"] > b.max_shadow_errors:
            return self._reject(
                f"shadow errors {s['errors']} > budget "
                f"{b.max_shadow_errors}", meta,
            )
        if s["requests"] < b.min_shadow_requests:
            return None
        frac = s["flip_rows"] / max(1, s["rows"])
        if frac > b.max_shadow_flip_frac:
            return self._reject(
                f"shadow argmax flipped on {s['flip_rows']}/{s['rows']} "
                f"rows ({frac:.2f} > budget {b.max_shadow_flip_frac})",
                meta,
            )
        return self._promote(meta)

    def _promote(self, meta: dict) -> Optional[str]:
        t0 = time.perf_counter()
        sig = self._signature()
        abandoned = False
        with self._cond:
            if sig != self._candidate_sig:
                # the trainer republished staging AFTER this candidate
                # was vetted: promoting now would publish unvetted bytes.
                # Abandon; the next poll evaluates the new publish.
                log.warning(
                    "staging republished mid-vetting; abandoning the "
                    "vetted candidate (epoch %s) for the newer one",
                    meta.get("epoch"),
                )
                self.state = STAGING
                self._token += 1
                abandoned = True
            else:
                gen = self.generation + 1
                shadow_requests = self._shadow["requests"]
        if abandoned:
            self._journal(
                "vet-verdict", verdict="abandoned", epoch=meta.get("epoch")
            )
            return None
        # the verdict is durable BEFORE the publish actuation: a relaunch
        # between them resumes the generation counter at `gen`, never
        # re-issuing it to a different candidate
        self._journal(
            "vet-verdict",
            verdict="promoted",
            generation=gen,
            epoch=meta.get("epoch"),
        )
        path = publish_checkpoint(
            self.staging_dir, self.live_dir, name=self.name,
            extra_meta={
                "promotion": {
                    "generation": gen,
                    "promoted_at": time.time(),
                    "shadow_requests": shadow_requests,
                }
            },
        )
        ms = (time.perf_counter() - t0) * 1e3
        with self._cond:
            self.generation = gen
            self.state = PROMOTED
            cand = self._candidate or {}
            verdict = cand.get("golden")
            # the candidate IS the incumbent now: its weight trees become
            # the rollback target, its golden logits the exact baseline
            if "state_dict" in cand:
                self._incumbent = cand["state_dict"]
            if verdict is not None:
                self._incumbent_logits = verdict["logits"]
                self._incumbent_argmax = verdict["argmax"]
                self._incumbent_acc = verdict["acc"]
            self._token += 1
        self._c_promotions.inc()
        self._h_promote.observe(ms)
        self._g_generation.set(gen)
        self._g_state.set(_STATE_IDS[PROMOTED])
        trace.instant(
            "canary/promoted", generation=gen, epoch=meta.get("epoch"),
            promote_ms=round(ms, 3),
        )
        log.info(
            "canary PROMOTED epoch %s -> %s (generation %d, %.1f ms, "
            "%d shadow requests)",
            meta.get("epoch"), path, gen, ms, shadow_requests,
        )
        return PROMOTED

    def _reject(self, reason: str, meta: dict) -> str:
        self._journal(
            "vet-verdict",
            verdict="quarantined",
            reason=reason,
            epoch=meta.get("epoch"),
        )
        quarantine_checkpoint(
            self.staging_dir, self.name, reason, meta=meta,
            extra={"generation": self.generation},
        )
        with self._cond:
            inc = self._incumbent
            self.state = QUARANTINED
            self.last_rejected = {
                "reason": reason, "epoch": meta.get("epoch"),
            }
            self._token += 1
        # exact rollback: the canary swaps the incumbent's state_dict back
        # in; its post-rollback outputs are the pre-candidate bits (same
        # weights, same fold, same kernels)
        self.engine.swap_weights(inc)
        self._c_rejected.inc()
        self._g_state.set(_STATE_IDS[QUARANTINED])
        trace.instant(
            "canary/quarantined", reason=reason, epoch=meta.get("epoch"),
        )
        log.warning(
            "canary QUARANTINED candidate epoch %s: %s (tombstone in %s; "
            "the fleet never served it)",
            meta.get("epoch"), reason, self.staging_dir,
        )
        return QUARANTINED

    # -- shadow tee ------------------------------------------------------

    def offer(self, images, incumbent_logits, priority="interactive") -> bool:
        """Tee one answered live request toward the canary — fire and
        forget. Only interactive traffic is sampled (the tee models
        user-facing risk; bulk rows add volume, not signal), at
        ``shadow_fraction`` via a deterministic counter, into a bounded
        queue (full = drop + count). Never raises, never blocks the
        caller beyond one lock+append — the client's response is already
        sealed in ``incumbent_logits``."""
        try:
            if priority != "interactive" or self.shadow_fraction <= 0:
                return False
            with self._cond:
                if self.state != SHADOWING:
                    return False
                self._offers += 1
                take = int(self._offers * self.shadow_fraction) > int(
                    (self._offers - 1) * self.shadow_fraction
                )
                if not take:
                    return False
                if len(self._queue) >= self.shadow_queue:
                    dropped = True
                else:
                    dropped = False
                    self._queue.append(
                        (
                            self._token,
                            np.array(images, dtype=np.uint8, copy=True),
                            np.array(
                                incumbent_logits, dtype=np.float32,
                                copy=True,
                            ),
                        )
                    )
                    self._cond.notify_all()
            if dropped:
                self._c_shadow_dropped.inc()
            return not dropped
        except Exception:
            # the tee must never become the client's problem
            log.exception("canary shadow offer failed")
            return False

    def _process_shadow(self, item) -> None:
        token, x, inc_logits = item
        t0 = time.perf_counter()
        try:
            out = np.asarray(self.engine.predict(x))
        except Exception as e:
            with self._cond:
                if token == self._token and self.state == SHADOWING:
                    self._shadow["errors"] += 1
            self._c_shadow_errors.inc()
            log.warning("canary shadow predict failed: %s", e)
            return
        ms = (time.perf_counter() - t0) * 1e3
        flips = int(
            np.sum(np.argmax(out, axis=-1) != np.argmax(inc_logits, axis=-1))
        )
        identical = bool(np.array_equal(out, inc_logits))
        with self._cond:
            if token != self._token or self.state != SHADOWING:
                return  # verdict already reached: stale sample
            s = self._shadow
            s["requests"] += 1
            s["rows"] += int(x.shape[0])
            s["flip_rows"] += flips
            s["identical"] += 1 if identical else 0
            remaining = max(
                0, self.budget.min_shadow_requests - s["requests"]
            )
        self._c_shadow_requests.inc()
        self._c_shadow_rows.inc(int(x.shape[0]))
        self._c_shadow_flips.inc(flips)
        if identical:
            self._c_shadow_identical.inc()
        self._h_shadow.observe(ms)
        self._g_shadow_remaining.set(remaining)

    def process_shadow_queue(self) -> int:
        """Drain the shadow queue on the calling thread; returns how many
        samples were processed. Tests drive the tee deterministically
        through this — the background worker uses the same per-item
        path."""
        n = 0
        while True:
            with self._cond:
                if not self._queue:
                    return n
                item = self._queue.popleft()
            self._process_shadow(item)
            n += 1

    # -- status / lifecycle ---------------------------------------------

    def status(self) -> dict:
        """The canary block ``/healthz`` serves (frontend + router)."""
        with self._cond:
            cand_meta = (self._candidate or {}).get("meta", {})
            out = {
                "state": self.state,
                "generation": self.generation,
                "candidate_epoch": cand_meta.get("epoch"),
                "candidate_best_acc": cand_meta.get("best_acc"),
                "shadow": dict(self._shadow),
                "last_rejected": (
                    dict(self.last_rejected)
                    if self.last_rejected is not None
                    else None
                ),
            }
        out["promotions"] = int(self._c_promotions.value)
        out["rejected"] = int(self._c_rejected.value)
        out["shadow_fraction"] = self.shadow_fraction
        return out

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:
                log.exception("canary poll failed; retrying next poll")

    def _shadow_run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._cond.wait()
                if self._stopping:
                    return  # undrained shadow samples are advisory only
                item = self._queue.popleft()
            self._process_shadow(item)

    def start(self) -> "PromotionController":
        with self._cond:
            self._stopping = False
            if self._poll_thread is None or not self._poll_thread.is_alive():
                self._stop.clear()
                self._poll_thread = threading.Thread(
                    target=self._run, name="canary-poll", daemon=True
                )
                self._poll_thread.start()
            if (
                self._shadow_thread is None
                or not self._shadow_thread.is_alive()
            ):
                self._shadow_thread = threading.Thread(
                    target=self._shadow_run, name="canary-shadow",
                    daemon=True,
                )
                self._shadow_thread.start()
        return self

    def stop(self) -> None:
        """Stop and JOIN both threads (poll + shadow worker); idempotent.
        After stop() returns, no controller thread exists."""
        self._stop.set()
        # take the handles under the lock, join OUTSIDE it (the worker
        # needs the condition to observe _stopping)
        with self._cond:
            self._stopping = True
            t1 = self._poll_thread
            t2 = self._shadow_thread
            self._poll_thread = None
            self._shadow_thread = None
            self._cond.notify_all()
        if t1 is not None:
            t1.join()
        if t2 is not None:
            t2.join()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class ShadowBackend:
    """Single-replica tee: serve through ``backend`` unchanged, offer
    each answered request to the canary controller, and merge the canary
    block into ``/healthz``. The client path gains one lock+append —
    never a canary compute, never a canary error (offer() swallows its
    own failures). The router-side equivalent is
    :meth:`Router.attach_shadow`."""

    def __init__(self, backend, controller: PromotionController):
        self.backend = backend
        self.controller = controller

    def predict(
        self,
        images,
        deadline_ms: Optional[float] = None,
        priority: str = "interactive",
    ):
        out = self.backend.predict(
            images, deadline_ms=deadline_ms, priority=priority
        )
        self.controller.offer(images, out, priority=priority)
        return out

    @property
    def engine_version(self) -> int:
        return int(getattr(self.backend, "engine_version", 0))

    def health(self) -> dict:
        out = dict(self.backend.health())
        out["canary"] = self.controller.status()
        return out
