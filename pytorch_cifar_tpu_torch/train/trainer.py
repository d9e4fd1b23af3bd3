"""Trainer of the port: ``Trainer(config).fit()``, on one device or as one
rank of a data-parallel job (counterpart of
``pytorch_cifar_tpu/train/trainer.py``).

Two data planes:

- **device-resident** (the default): each epoch is one train epoch program
  (``steps.make_train_epoch``: the epoch's rows gathered at once, through
  kernel K1 on CUDA when ``config.dma_gather`` is set), then one eval epoch
  over the static test set, then ONE fetch of both epochs' metric totals
  and the per-step non-finite slots: the only host sync of the epoch;
- **the host loader** (``--no-device_data``, or ``--host_augment``, which
  crops and flips on the host through ``native/`` and builds the step with
  ``augment=False``): ``data.pipeline.Dataloader`` feeds the per-step loop,
  which fetches the running totals every ``log_every`` steps (10 Hz on a
  TTY) for the progress bar; eval runs ``eval_batches`` through the eval
  step.

The log lines, the best-accuracy gate and the returned value are the JAX
trainer's.

**Divergence sentinel** (``config.sentinel``, default ``skip`` as in
JAX): the step discards a non-finite update on the device
(``skip_nonfinite``); the policy half here reads each epoch's totals:
``train.sentinel.bad_steps``, the global steps named by the per-step slots
(``fault_stats``), a ``train/sentinel_skip`` trace instant and a log line;
under ``rollback``, once ``sentinel_budget`` consecutive bad steps
accumulate, the newest checkpoint is restored (``_rollback``). ``remat``
recomputes the forward in the backward.

**Observability**: the registry ``self.obs`` (the JAX trainer's metric
names: ``train.epochs``, ``train.epoch_s``, ``train.epoch_ms``,
``train.step_time_ms``, ``train.input_wait_ms``, ``train.input_wait_s``,
``train.sentinel.*``, the loader's ``data.*``, the checkpoints'
``checkpoint.*``); ``--metrics_out`` appends its snapshots as JSONL,
``--trace_out`` writes the host spans (``train/epoch``, ``train/step``,
``train/dispatch``, ``train/fetch``, ``eval/epoch``, ``checkpoint/*``) as
Chrome trace JSON, ``--profile`` runs ``torch.profiler`` over ~20 steady
steps and writes its trace under ``output_dir/profile``.

Checkpoints are the JAX package's format v2 (``train/checkpoint.py``), in
``config.output_dir`` (under ``publish="staging"`` in its ``staging/``
subdirectory, the canary pipeline's input, which resume reads too):

- the gate snapshots the best state on the device at every improvement (a
  clone, no sync) and writes ``ckpt.msgpack`` at most once per
  ``checkpoint_every`` epochs, on a background writer under ``async_save
  on``; ``flush_checkpoints`` makes the newest best durable before ``fit``
  returns;
- ``request_stop`` (SIGTERM, in the main thread) ends the run after the
  current epoch with the exact state saved as ``last.msgpack``; a run
  that completes removes a stale one;
- ``resume`` restores the newest of the two (their history behind them),
  ``evaluate`` the best, onto the trainer's device, with the step, the
  next epoch and ``best_acc``. The epoch permutation depends on (seed,
  epoch) and the augmentation draws on (seed, step), so a resumed run
  takes the steps an uninterrupted one would.
  A ``ckpt.msgpack`` that fails its manifest is rewritten from its
  newest history copy that verifies (``heal_checkpoint``), so the run's
  best checkpoint is whole again even when no later epoch improves on it
  (the JAX trainer leaves the damaged file in place).

Data parallelism (``config.distributed``, or a process group the caller
made): the trainer joins the default process group
(``parallel.mesh.initialize_distributed`` from ``dist_coord``,
``dist_procs``, ``dist_rank``), trains on ``cuda:<local rank>`` (or the
CPU), starts from rank 0's weights, and runs the data-parallel steps over
``DATA_AXIS``: each rank steps on its shard of every global batch, and
every rank holds the same state and the same global metrics, so every
rank takes the same sentinel decision and restores the same file. The
batch sizes are rounded down to a multiple of the world, with the JAX
trainer's warning. Checkpoints are format v3, each rank writing its shard,
inline (``async_save on`` is ignored, with the JAX trainer's note); a stop
requested on any rank stops every rank after the same epoch
(``_agreed_stop``). ``close`` leaves the process group the trainer made.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import sys
import threading
import time
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.compat import snapshot_state
from pytorch_cifar_tpu_torch.config import TrainConfig
from pytorch_cifar_tpu_torch.data.cifar10 import load_cifar10, synthetic_cifar10
from pytorch_cifar_tpu_torch.data.pipeline import (
    Dataloader,
    DeviceDataset,
    eval_batches,
    local_slab,
)
from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.obs import MetricsExporter, MetricsRegistry, trace
from pytorch_cifar_tpu_torch.parallel.dp import broadcast_module_
from pytorch_cifar_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    any_rank,
    initialize_distributed,
    is_distributed,
    is_primary,
    rank,
    rank_device,
    world_size,
)
from pytorch_cifar_tpu_torch.train.checkpoint import (
    CKPT_NAME,
    LAST_NAME,
    AsyncCheckpointWriter,
    best_checkpoint_order,
    ensure_staging_dir,
    heal_checkpoint,
    newest_checkpoint_order,
    remove_stale_last,
    restore_checkpoint,
    save_checkpoint,
)
from pytorch_cifar_tpu_torch.train.optim import (
    cosine_epoch_schedule,
    make_optimizer,
)
from pytorch_cifar_tpu_torch.train.state import create_train_state
from pytorch_cifar_tpu_torch.train.steps import (
    METRIC_KEYS,
    Metrics,
    add_metrics,
    make_eval_epoch,
    make_eval_step,
    make_train_epoch,
    make_train_step,
    zero_metrics,
)
from pytorch_cifar_tpu_torch.utils.progress import progress_bar

log = logging.getLogger(__name__)

PROFILE_STEPS = 20  # the per-step loop's profiled window


def _to_host(*totals: Metrics) -> List[Dict]:
    """Each metric-totals dict on the host, all of them in one
    device-to-host copy; a ``nonfinite_steps`` vector comes back as a
    list."""
    parts = []
    for t in totals:
        parts.append(torch.stack([t[k] for k in METRIC_KEYS]))
        if "nonfinite_steps" in t:
            parts.append(t["nonfinite_steps"])
    flat = torch.cat(parts).tolist()
    out, i = [], 0
    for t in totals:
        m = dict(zip(METRIC_KEYS, flat[i:i + len(METRIC_KEYS)]))
        i += len(METRIC_KEYS)
        if "nonfinite_steps" in t:
            n = t["nonfinite_steps"].numel()
            m["nonfinite_steps"], i = flat[i:i + n], i + n
        out.append(m)
    return out


class Trainer:
    def __init__(self, config: TrainConfig):
        if config.async_save not in ("on", "off"):
            raise ValueError(
                f"async_save must be on/off, got {config.async_save!r}"
            )
        if config.publish not in ("live", "staging"):
            raise ValueError(
                f"publish must be live/staging, got {config.publish!r}"
            )
        if config.async_input not in ("on", "off"):
            raise ValueError(
                f"async_input must be on/off, got {config.async_input!r}"
            )
        if config.sentinel not in ("off", "skip", "rollback"):
            raise ValueError(
                f"sentinel must be off/skip/rollback, got {config.sentinel!r}"
            )
        self.config = config
        self._owns_group = config.distributed and initialize_distributed(
            config.dist_coord or None, config.dist_procs or None,
            config.dist_rank if config.dist_coord else None,
            device=config.device,
        )
        self.data_parallel = is_distributed()
        self.world, self.rank = world_size(), rank()
        if config.num_devices > 1 and config.num_devices != self.world:
            raise ValueError(
                f"num_devices={config.num_devices} but the process group "
                f"has {self.world} ranks: the train CLI starts one process "
                "per device"
            )
        if self.data_parallel:
            self.device = rank_device(config.device)
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
        else:
            self.device = resolve_device(config.device)
        # each Trainer its own registry (tests assert exact counts); the
        # exporter thread and the tracer exist only when flags ask
        self.obs = MetricsRegistry()
        self._exporter = None
        if config.trace_out:
            trace.install(config.trace_out)

        # -- data ------------------------------------------------------
        if config.synthetic_data:
            tr_x, tr_y, te_x, te_y = synthetic_cifar10(
                n_train=config.synthetic_train_size,
                n_test=config.synthetic_test_size,
            )
        else:
            tr_x, tr_y, te_x, te_y = load_cifar10(
                config.data_dir, synthetic_ok=False
            )
        n_dev = self.world
        if config.batch_size % n_dev:
            # parity with main_dist.py:112-115's divisibility warning
            log.warning("batch_size %d not divisible by %d devices; "
                        "rounding down", config.batch_size, n_dev)
        self.global_batch = max(config.batch_size // n_dev, 1) * n_dev
        self.eval_bs = max(config.eval_batch_size // n_dev, 1) * n_dev
        # where augmentation runs: the host (native data plane) or the
        # step; host augmentation takes the host loader
        host_aug = config.host_augment and config.random_crop
        self.device_data = config.device_data and not host_aug
        if self.device_data:
            self.loader = DeviceDataset(
                tr_x, tr_y, batch_size=self.global_batch, shuffle=True,
                drop_last=config.drop_last, seed=config.seed,
                device_perm=config.device_perm, device=self.device,
            )
            self.eval_loader = DeviceDataset(
                te_x, te_y, batch_size=self.eval_bs, shuffle=False,
                device=self.device,
            )
        else:
            self.loader = Dataloader(
                tr_x, tr_y, batch_size=self.global_batch, shuffle=True,
                drop_last=config.drop_last, seed=config.seed,
                shard=self.rank, n_shards=self.world,
                prefetch=config.prefetch,
                async_input=config.async_input == "on",
                host_augment=host_aug, augment_flip=config.random_flip,
                registry=self.obs, device=self.device,
            )
            self.eval_loader = None
        self.test_images, self.test_labels = te_x, te_y
        self.steps_per_epoch = len(self.loader)

        # -- model/optimizer/state ------------------------------------
        model = create_model(
            config.model, num_classes=config.num_classes,
            generator=torch.Generator().manual_seed(config.seed),
        ).to(self.device, memory_format=torch.channels_last)
        if self.data_parallel:
            broadcast_module_(model)  # every rank starts from rank 0's
        optimizer = make_optimizer(
            model.parameters(), lr=config.lr, momentum=config.momentum,
            weight_decay=config.weight_decay,
        )
        schedule = cosine_epoch_schedule(
            config.lr, config.t_max, self.steps_per_epoch
        )
        # the augmentation stream is seeded apart from the init, as the
        # JAX trainer's step key is PRNGKey(seed + 1)
        self.state = create_train_state(
            model, optimizer, schedule, seed=config.seed + 1,
            device=self.device,
        )

        # -- steps and epoch programs ---------------------------------
        compute = torch.bfloat16 if config.amp else torch.float32
        # cross-replica BN over one process is local BN: the same math
        axis = DATA_AXIS if self.data_parallel else None
        self.train_step = make_train_step(
            augment=not host_aug, crop=config.random_crop,
            flip=config.random_flip, mean=config.mean, std=config.std,
            compute_dtype=compute, axis_name=axis,
            sync_bn=config.sync_bn and axis is not None,
            remat=config.remat, skip_nonfinite=config.sentinel != "off",
            device=self.device,
        )
        self.eval_step = make_eval_step(
            mean=config.mean, std=config.std, compute_dtype=compute,
            axis_name=axis, device=self.device,
        )
        self.train_epoch_fn = self.eval_epoch_fn = None
        if self.device_data:
            self.train_epoch_fn = make_train_epoch(
                self.train_step, global_batch=self.global_batch,
                n_data=tr_x.shape[0], num_steps=self.steps_per_epoch,
                axis_name=axis, n_shards=self.world,
                dma_gather=config.dma_gather,
            )
            n_eval = te_x.shape[0]
            self.eval_epoch_fn = make_eval_epoch(
                self.eval_step, global_batch=self.eval_bs, n_data=n_eval,
                num_steps=max(-(-n_eval // self.eval_bs), 1),
                axis_name=axis, n_shards=self.world,
            )
        self.start_epoch = 0
        self.best_acc = 0.0
        self.history: List[dict] = []

        # -- checkpoints ----------------------------------------------
        # under --publish staging every checkpoint (best, preemption,
        # history, shards) lands in output_dir/staging, and resume reads
        # it there: the trainer never depends on what the canary promoted
        self.ckpt_dir = (
            ensure_staging_dir(config.output_dir)
            if config.publish == "staging"
            else config.output_dir
        )
        if config.resume or config.evaluate:
            # resume wants the newest state (a stale last.msgpack must not
            # roll training back); eval wants the best params
            names = (best_checkpoint_order(self.ckpt_dir) if config.evaluate
                     else newest_checkpoint_order(self.ckpt_dir))
            _, self.start_epoch, self.best_acc = restore_checkpoint(
                self.ckpt_dir, self.state, names=names, registry=self.obs
            )
            log.info("resumed from %s: epoch %d, best_acc %.2f",
                     self.ckpt_dir, self.start_epoch, self.best_acc)
            # a damaged best checkpoint is rewritten from its history copy
            # (the restore fell back past it): the run's best stays whole
            # for its readers even when no later epoch improves on it
            healed = (heal_checkpoint(self.ckpt_dir, CKPT_NAME)
                      if config.resume and is_primary() else None)
            if healed:
                log.warning("best checkpoint %s was damaged: rewritten from "
                            "its history copy %s", CKPT_NAME, healed)
        self._stop_requested = False
        self._snapshot = None  # (device StateSnapshot, epoch, best_acc)
        # several processes commit every save inline: each rank's writer
        # would supersede queued saves by its own timing, and the ranks
        # could publish different epochs (save_checkpoint's rule)
        self._ckpt_writer = (
            AsyncCheckpointWriter(registry=self.obs)
            if config.async_save == "on" and self.world == 1 else None)
        if config.async_save == "on" and self._ckpt_writer is None:
            log.info("--async_save on ignored under %d processes: sharded "
                     "saves commit inline so every rank publishes the same "
                     "epoch sequence", self.world)
        # _submitted_epoch (this thread only): newest epoch handed to
        # save_checkpoint, for throttling. _written_epoch (under
        # _ckpt_lock; the writer thread's on_commit advances it): newest
        # epoch durably on disk, so a failed background commit is
        # re-submitted by flush_checkpoints, never assumed written.
        self._ckpt_lock = threading.Lock()
        self._submitted_epoch = None
        self._written_epoch = None
        # divergence-sentinel policy state: consecutive non-finite steps;
        # the totals live in self.obs, the global steps skipped here
        self._consec_bad = 0
        self._bad_step_indices: List[int] = []
        self._profile_dir = None  # set by fit for the profiled epoch

    @property
    def fault_stats(self) -> dict:
        """The sentinel's totals, a view over ``self.obs``
        (``train.sentinel.bad_steps``, ``train.sentinel.rollbacks``), and
        the global step of every skipped update the epoch programs
        attributed (``bad_step_indices``)."""
        return {
            "bad_steps": int(
                self.obs.counter("train.sentinel.bad_steps").value),
            "rollbacks": int(
                self.obs.counter("train.sentinel.rollbacks").value),
            "bad_step_indices": list(self._bad_step_indices),
        }

    # -- divergence sentinel (policy half; the step half is the step's
    # skip_nonfinite) ---------------------------------------------------

    def _apply_sentinel(self, epoch: int, m: dict) -> None:
        """React to the epoch's non-finite step count (``m["nonfinite"]``,
        host floats; ``m["nonfinite_steps"]``, the epoch program's 0/1
        slots, when it has them). Under ``skip`` the step already
        discarded the bad updates: count and log. Under ``rollback``, once
        ``sentinel_budget`` consecutive bad steps accumulate, restore the
        newest checkpoint: a skipped update cannot repair a bad basin."""
        if self.config.sentinel == "off":
            return
        bad = int(round(float(m.get("nonfinite", 0.0))))
        if bad <= 0:
            self._consec_bad = 0
            return
        self._consec_bad += bad
        self.obs.counter("train.sentinel.bad_steps").inc(bad)
        mask = m.get("nonfinite_steps")
        bad_steps: List[int] = []
        if mask is not None:
            base = epoch * self.steps_per_epoch
            bad_steps = [base + i for i, v in enumerate(mask) if v > 0]
            self._bad_step_indices.extend(bad_steps)
            trace.instant("train/sentinel_skip", epoch=epoch,
                          steps=bad_steps)
        log.warning(
            "divergence sentinel: %d non-finite step(s) in epoch %d "
            "skipped%s (%d consecutive, policy %s)",
            bad, epoch,
            f" at global step(s) {bad_steps}" if bad_steps else "",
            self._consec_bad, self.config.sentinel,
        )
        if (self.config.sentinel == "rollback"
                and self._consec_bad >= self.config.sentinel_budget):
            self._rollback(epoch)

    def _rollback(self, epoch: int) -> None:
        """Restore the newest on-disk checkpoint over the live state
        (params, momentum, BN, step), or log that there is none and go
        on. Every rank holds the same totals, so every rank gets here and
        restores rank 0's choice."""
        if self._ckpt_writer is not None:
            # the newest save may still be queued: restore what is newest
            # on disk
            self._ckpt_writer.flush()
        try:
            restore_checkpoint(
                self.ckpt_dir, self.state,
                names=newest_checkpoint_order(self.ckpt_dir),
                registry=self.obs,
            )
        except FileNotFoundError:
            log.warning(
                "sentinel rollback requested at epoch %d but no usable "
                "checkpoint exists; continuing with skipped updates", epoch
            )
            self._consec_bad = 0
            return
        self._consec_bad = 0
        self.obs.counter("train.sentinel.rollbacks").inc()
        trace.instant("train/sentinel_rollback", epoch=epoch)
        log.warning(
            "divergence sentinel: rolled back to the last checkpoint "
            "after %d consecutive non-finite steps (epoch %d)",
            self.config.sentinel_budget, epoch,
        )

    def _dispatch_train(self, epoch: int) -> Metrics:
        """Queue one train epoch program; its totals, with the per-step
        ``nonfinite_steps``, stay on the device."""
        with trace.span("train/dispatch", epoch=epoch):
            self.state, totals = self.train_epoch_fn(
                self.state,
                zero_metrics(self.device, num_steps=self.steps_per_epoch),
                self.loader.images, self.loader.labels,
                self.loader.staged_perm(epoch),
            )
        return totals

    def dispatch_epoch(self, epoch: int) -> Tuple[Metrics, Metrics]:
        """Queue one train and one eval epoch of the device-resident plane
        and return their metric totals, still on the device. Nothing here
        waits for the device."""
        totals = self._dispatch_train(epoch)
        ev = self.eval_epoch_fn(
            self.state, self.eval_loader.images, self.eval_loader.labels
        )
        return totals, ev

    def _run_epoch(self, epoch: int) -> Tuple[Dict, Dict[str, float]]:
        """Dispatch one train and one eval epoch; fetch both totals and the
        per-step slots in one device-to-host copy (the epoch's one
        sync)."""
        totals, ev = self.dispatch_epoch(epoch)
        with trace.span("train/fetch", epoch=epoch):
            train_m, eval_m = _to_host(totals, ev)
        return train_m, eval_m

    def _timed_batches(self, iterable):
        """Iterate ``iterable`` measuring the wait for each batch
        (``train.input_wait_ms``, ``train.input_wait_s``): when it rivals
        the step time, the input pipeline bounds the run."""
        wait_hist = self.obs.histogram("train.input_wait_ms")
        wait_total = self.obs.counter("train.input_wait_s")
        it = iter(iterable)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            dt = time.perf_counter() - t0
            wait_hist.observe(dt * 1e3)
            wait_total.inc(dt)
            yield batch

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def _export_profile(self, prof, epoch: int) -> None:
        os.makedirs(self._profile_dir, exist_ok=True)
        path = os.path.join(self._profile_dir, f"epoch{epoch}.trace.json")
        prof.export_chrome_trace(path)
        log.info("profile of epoch %d written to %s", epoch, path)

    def _train_steps(self, epoch: int) -> Dict[str, float]:
        """One epoch of the per-step loop over the host loader; returns
        its metric totals. The running totals stay on the device and are
        fetched (a sync) every ``log_every`` steps, at the last step, and
        at most at 10 Hz on a TTY, for the progress bar; the first
        ``PROFILE_STEPS`` steps of the profiled epoch run under
        ``torch.profiler``, with no fetch inside the window."""
        nb = self.steps_per_epoch
        totals = zero_metrics(self.device)
        trace_end = min(PROFILE_STEPS, nb) if self._profile_dir else 0
        prof = None
        tty = sys.stdout.isatty()
        last_sync = 0.0
        m = {k: 0.0 for k in METRIC_KEYS}
        with trace.span("train/epoch", epoch=epoch, path="step_loop"):
            for i, batch in enumerate(
                self._timed_batches(self.loader.epoch(epoch))
            ):
                if trace_end and i == 0:
                    prof = self._profiler()
                    prof.__enter__()
                with trace.span("train/step", step=i):
                    # times the dispatch: the device runs behind
                    totals = add_metrics(totals,
                                         self.train_step(self.state, batch))
                if trace_end and i + 1 == trace_end:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    prof.__exit__(None, None, None)
                    self._export_profile(prof, epoch)
                    trace_end = 0
                if trace_end:
                    continue
                now = time.time() if tty else 0.0
                if (i % self.config.log_every == 0 or i + 1 == nb
                        or (tty and now - last_sync >= 0.1)):
                    last_sync = now
                    (m,) = _to_host(totals)
                    if is_primary():
                        progress_bar(i, nb, self._bar_text(m),
                                     log_every=self.config.log_every)
        return m

    @staticmethod
    def _bar_text(m) -> str:
        count = max(m["count"], 1)
        return "Loss: %.3f | Acc: %.3f%% (%d/%d)" % (
            m["loss_sum"] / count, 100.0 * m["correct"] / count,
            int(m["correct"]), int(m["count"]))

    def _eval_steps(self) -> Dict[str, float]:
        """The host path's eval: ``eval_batches`` of the test set, this
        rank's slab of each, through the eval step; the totals stay on the
        device until one fetch."""
        totals = zero_metrics(self.device)
        (r0, r1), _ = local_slab((self.eval_bs,), self.rank, self.world)
        for x, y in eval_batches(self.test_images, self.test_labels,
                                 self.eval_bs):
            batch = (torch.from_numpy(x[r0:r1]).to(self.device),
                     torch.from_numpy(y[r0:r1]).to(self.device))
            totals = add_metrics(totals, self.eval_step(self.state, batch))
        return _to_host(totals)[0]

    def _epoch(self, epoch: int) -> Tuple[Dict, Dict[str, float]]:
        """One train epoch and one eval epoch on this trainer's data
        plane; their totals on the host."""
        if self.device_data:
            return self._run_epoch(epoch)
        train_m = self._train_steps(epoch)
        with trace.span("eval/epoch", epoch=epoch):
            return train_m, self._eval_steps()

    def train_epoch(self, epoch: int) -> Tuple[float, float]:
        """One train epoch alone, logged; returns (loss, accuracy), as the
        JAX trainer's ``train_epoch`` does."""
        log.info("\nEpoch: %d", epoch)
        t0 = time.perf_counter()
        if self.device_data:
            with trace.span("train/epoch", epoch=epoch,
                            path="epoch_compiled"):
                totals = self._dispatch_train(epoch)
                with trace.span("train/fetch", epoch=epoch):
                    (m,) = _to_host(totals)
        else:
            m = self._train_steps(epoch)
        return self._log_train_totals(epoch, m, time.perf_counter() - t0)

    def eval_epoch(self, epoch: int) -> Tuple[float, float]:
        """One eval epoch of the current state, logged; returns (loss,
        accuracy)."""
        with trace.span("eval/epoch", epoch=epoch):
            if self.device_data:
                (m,) = _to_host(self.eval_epoch_fn(
                    self.state, self.eval_loader.images,
                    self.eval_loader.labels))
            else:
                m = self._eval_steps()
        return self._log_eval_totals(epoch, m)

    def _record_epoch_timing(self, dt: float, nb: int) -> None:
        """One epoch's wall into the registry: ``train.epochs``,
        ``train.epoch_s`` (the total the input-wait share divides by),
        ``train.epoch_ms`` and ``train.step_time_ms`` (the epoch's mean)."""
        self.obs.counter("train.epochs").inc()
        self.obs.counter("train.epoch_s").inc(dt)
        self.obs.histogram("train.epoch_ms").observe(dt * 1e3)
        self.obs.histogram("train.step_time_ms").observe(
            dt * 1e3 / max(nb, 1))

    def _log_train_totals(self, epoch, m, dt) -> Tuple[float, float]:
        self._apply_sentinel(epoch, m)
        self._record_epoch_timing(dt, self.steps_per_epoch)
        count = max(m["count"], 1)
        loss, acc = m["loss_sum"] / count, 100.0 * m["correct"] / count
        if self.device_data and is_primary():
            # the per-step loop drew its bar as it went
            nb = self.steps_per_epoch
            progress_bar(nb - 1, nb, self._bar_text(m),
                         log_every=self.config.log_every)
        log.info(
            "train epoch %d: loss %.4f acc %.2f%% (%.0f img/s)",
            epoch, loss, acc, m["count"] / max(dt, 1e-9),
        )
        return loss, acc

    def _log_eval_totals(self, epoch, m) -> Tuple[float, float]:
        count = max(m["count"], 1)
        loss, acc = m["loss_sum"] / count, 100.0 * m["correct"] / count
        log.info("eval  epoch %d: loss %.4f acc %.2f%%", epoch, loss, acc)
        return loss, acc

    def maybe_checkpoint(self, epoch: int, acc: float) -> bool:
        """The best-accuracy gate. Every improvement snapshots the state
        on the device (a clone, no sync); disk writes are throttled to
        ``checkpoint_every`` epochs and, under ``async_save on``, commit on
        the background writer after one device-to-host copy here."""
        if acc <= self.best_acc:
            return False
        self.best_acc = acc
        log.info("Saving.. (best acc %.2f%%)", acc)
        if self._ckpt_writer is None:
            save_checkpoint(
                self.ckpt_dir, self.state, epoch, self.best_acc,
                keep_last_n=self.config.keep_last_n, registry=self.obs,
            )
            return True
        self._snapshot = (snapshot_state(self.state), epoch, self.best_acc)
        self._write_snapshot_async()
        return True

    def _mark_epoch_written(self, epoch: int) -> None:
        with self._ckpt_lock:
            self._written_epoch = epoch

    def _epoch_written(self):
        with self._ckpt_lock:
            return self._written_epoch

    def _submit_snapshot(self, snap) -> None:
        epoch = snap[1]
        save_checkpoint(
            self.ckpt_dir, snap[0], epoch, snap[2],
            keep_last_n=self.config.keep_last_n, registry=self.obs,
            writer=self._ckpt_writer,
            on_commit=lambda: self._mark_epoch_written(epoch),
        )
        self._submitted_epoch = epoch

    def _write_snapshot_async(self) -> None:
        """Hand the best snapshot to the writer unless a write went out
        fewer than ``checkpoint_every`` epochs ago."""
        snap = self._snapshot
        if snap is None or snap[1] == self._submitted_epoch:
            return
        every = self.config.checkpoint_every
        if (self._submitted_epoch is not None and every > 0
                and snap[1] - self._submitted_epoch < every):
            log.info(
                "checkpoint write throttled (epoch %d; last saved best is "
                "epoch %d, next write at epoch >= %d) — a crash before then "
                "resumes from the on-disk state",
                snap[1], self._submitted_epoch, self._submitted_epoch + every,
            )
            return
        self._submit_snapshot(snap)

    def flush_checkpoints(self) -> None:
        """Block until the newest best snapshot is durably on disk. A
        failed background write is re-raised here; a snapshot whose
        earlier commit failed (its error already raised once) is written
        again rather than assumed on disk."""
        snap = self._snapshot
        if snap is not None and snap[1] != self._submitted_epoch:
            self._submit_snapshot(snap)
        if self._ckpt_writer is not None:
            try:
                self._ckpt_writer.flush()
            except BaseException:
                self._submitted_epoch = self._epoch_written()
                raise
        if snap is not None and snap[1] != self._epoch_written():
            self._submitted_epoch = self._epoch_written()
            self._submit_snapshot(snap)
            if self._ckpt_writer is not None:
                self._ckpt_writer.flush()

    def request_stop(self) -> None:
        """Ask ``fit`` to stop after the current epoch and write
        ``last.msgpack``."""
        self._stop_requested = True

    def _agreed_stop(self) -> bool:
        """The stop flag agreed by every rank (an all-reduce MAX): SIGTERM
        can reach the ranks at different epoch boundaries, and a rank that
        stops alone strands the others in a collective."""
        return any_rank(self._stop_requested)

    def close(self) -> None:
        """Stop the exporter, flush and remove the tracer this trainer
        installed, and leave the process group if this trainer made it."""
        self._close_obs()
        if self.config.trace_out:
            trace.uninstall()
        if self._owns_group:
            dist.destroy_process_group()
            self._owns_group = False

    def _close_obs(self) -> None:
        """Stop the metrics exporter (it writes a final line) and flush the
        trace file: a stopped or crashed run still leaves both."""
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None
        if self.config.trace_out:
            trace.flush()

    def evaluate(self) -> float:
        """One eval epoch of the restored state (``--evaluate``); returns
        its accuracy."""
        _, acc = self.eval_epoch(max(self.start_epoch - 1, 0))
        return acc

    def fit(self) -> float:
        cfg = self.config
        log.info(
            "==> model %s | %d devices | global batch %d | %d steps/epoch",
            cfg.model, self.world, self.global_batch, self.steps_per_epoch,
        )
        if cfg.metrics_out and self._exporter is None:
            # one file per rank: the ranks hold distinct registries
            path = (cfg.metrics_out if self.rank == 0
                    else f"{cfg.metrics_out}.rank{self.rank}")
            self._exporter = MetricsExporter(
                self.obs, path, interval_s=cfg.metrics_every_s).start()
        if cfg.evaluate:
            try:
                return self.evaluate()
            finally:
                self._close_obs()
        # the profiled epoch: the second (steady, past the cold first
        # calls), or the only one
        profile_epoch = min(self.start_epoch + 1, cfg.epochs - 1)
        # SIGTERM: finish the epoch, save last.msgpack, return (handlers
        # attach only in the main thread)
        old_handler = None
        if threading.current_thread() is threading.main_thread():
            old_handler = signal.signal(
                signal.SIGTERM, lambda s, f: self.request_stop()
            )
        last_mark = time.perf_counter()
        try:
            for epoch in range(self.start_epoch, cfg.epochs):
                log.info("\nEpoch: %d", epoch)
                profiled = (cfg.profile and epoch == profile_epoch
                            and is_primary())
                self._profile_dir = (os.path.join(cfg.output_dir, "profile")
                                     if profiled else None)
                # the device-resident epoch is profiled whole, the
                # per-step loop over its first PROFILE_STEPS steps
                prof = (self._profiler() if profiled and self.device_data
                        else contextlib.nullcontext())
                with prof:
                    train_m, eval_m = self._epoch(epoch)
                if profiled and self.device_data:
                    self._export_profile(prof, epoch)
                self._profile_dir = None
                now = time.perf_counter()
                dt, last_mark = now - last_mark, now
                train_loss, train_acc = self._log_train_totals(
                    epoch, train_m, dt)
                eval_loss, eval_acc = self._log_eval_totals(epoch, eval_m)
                self.maybe_checkpoint(epoch, eval_acc)
                train_m = {k: train_m[k] for k in METRIC_KEYS}
                self.history.append({
                    "epoch": epoch, "train": train_m, "eval": eval_m,
                    "train_loss": train_loss, "train_acc": train_acc,
                    "eval_loss": eval_loss, "eval_acc": eval_acc,
                    "epoch_s": dt,
                    "img_per_sec": train_m["count"] / max(dt, 1e-9),
                })
                if self._agreed_stop():
                    log.info("stop requested: saving preemption checkpoint "
                             "at epoch %d", epoch)
                    save_checkpoint(
                        self.ckpt_dir, self.state, epoch, self.best_acc,
                        name=LAST_NAME, keep_last_n=cfg.keep_last_n,
                        registry=self.obs, writer=self._ckpt_writer,
                    )
                    break
            else:
                if is_primary():
                    remove_stale_last(self.ckpt_dir)
        finally:
            # the newest best must be on disk before fit returns; the
            # writer is joined and the exporter stopped on every exit path
            try:
                self.flush_checkpoints()
            finally:
                if self._ckpt_writer is not None:
                    self._ckpt_writer.close()
                self._close_obs()
                if old_handler is not None:
                    signal.signal(signal.SIGTERM, old_handler)
        return self.best_acc
