"""Trainer of the port: ``Trainer(config).fit()`` over the
device-resident data plane, on one device or as one rank of a
data-parallel job (counterpart of ``pytorch_cifar_tpu/train/trainer.py``).

Each epoch is one train epoch program (``steps.make_train_epoch``: the
epoch's rows gathered at once, through kernel K1 on CUDA when
``config.dma_gather`` is set), then one eval epoch over the static test
set, then ONE fetch of both epochs' metric totals: the only host sync of
the epoch. The log lines, the best-accuracy gate and the returned value
are the JAX trainer's.

Checkpoints are the JAX package's format v2 (``train/checkpoint.py``), in
``config.output_dir``:

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

Data parallelism (``config.distributed``, or a process group the caller
made): the trainer joins the default process group
(``parallel.mesh.initialize_distributed`` from ``dist_coord``,
``dist_procs``, ``dist_rank``), trains on ``cuda:<local rank>`` (or the
CPU), starts from rank 0's weights, and runs the data-parallel epoch
programs over ``DATA_AXIS``: each rank gathers and steps on its shard of
every global batch, and every rank holds the same state and the same
global metrics. The batch sizes are rounded down to a multiple of the
world, with the JAX trainer's warning. Checkpoints are format v3, each
rank writing its shard, inline (``async_save on`` is ignored, with the
JAX trainer's note); a stop requested on any rank stops every rank after
the same epoch (``_agreed_stop``). ``close`` leaves the process group the
trainer made.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.compat import snapshot_state
from pytorch_cifar_tpu_torch.config import TrainConfig, check_ported
from pytorch_cifar_tpu_torch.data.cifar10 import load_cifar10, synthetic_cifar10
from pytorch_cifar_tpu_torch.data.pipeline import DeviceDataset
from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.obs import MetricsRegistry
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
    LAST_NAME,
    AsyncCheckpointWriter,
    best_checkpoint_order,
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
    make_eval_epoch,
    make_eval_step,
    make_train_epoch,
    make_train_step,
    zero_metrics,
)

log = logging.getLogger(__name__)


class Trainer:
    def __init__(self, config: TrainConfig):
        check_ported(config)
        if config.async_save not in ("on", "off"):
            raise ValueError(
                f"async_save must be on/off, got {config.async_save!r}"
            )
        if config.publish != "live":
            raise ValueError(
                f"publish must be live/staging, got {config.publish!r}"
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
        self.obs = MetricsRegistry()

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
        self.loader = DeviceDataset(
            tr_x, tr_y, batch_size=self.global_batch, shuffle=True,
            drop_last=config.drop_last, seed=config.seed,
            device_perm=config.device_perm, device=self.device,
        )
        self.steps_per_epoch = len(self.loader)
        self.eval_bs = max(config.eval_batch_size // n_dev, 1) * n_dev
        self.eval_loader = DeviceDataset(
            te_x, te_y, batch_size=self.eval_bs, shuffle=False,
            device=self.device,
        )

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

        # -- epoch programs -------------------------------------------
        compute = torch.bfloat16 if config.amp else torch.float32
        # cross-replica BN over one process is local BN: the same math
        axis = DATA_AXIS if self.data_parallel else None
        self.train_epoch_fn = make_train_epoch(
            make_train_step(
                crop=config.random_crop, flip=config.random_flip,
                mean=config.mean, std=config.std, compute_dtype=compute,
                axis_name=axis, sync_bn=config.sync_bn and axis is not None,
                device=self.device,
            ),
            global_batch=self.global_batch,
            n_data=tr_x.shape[0],
            num_steps=self.steps_per_epoch,
            axis_name=axis,
            n_shards=self.world,
            dma_gather=config.dma_gather,
        )
        n_eval = te_x.shape[0]
        self.eval_epoch_fn = make_eval_epoch(
            make_eval_step(mean=config.mean, std=config.std,
                           compute_dtype=compute, axis_name=axis,
                           device=self.device),
            global_batch=self.eval_bs,
            n_data=n_eval,
            num_steps=max(-(-n_eval // self.eval_bs), 1),
            axis_name=axis,
            n_shards=self.world,
        )
        self.start_epoch = 0
        self.best_acc = 0.0
        self.history: List[dict] = []

        # -- checkpoints ----------------------------------------------
        self.ckpt_dir = config.output_dir
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

    def dispatch_epoch(self, epoch: int) -> Tuple[Metrics, Metrics]:
        """Queue one train and one eval epoch on the device and return
        their metric totals, still on the device. Nothing here waits for
        the device."""
        perm = self.loader.staged_perm(epoch)
        self.state, totals = self.train_epoch_fn(
            self.state, zero_metrics(self.device), self.loader.images,
            self.loader.labels, perm,
        )
        ev = self.eval_epoch_fn(
            self.state, self.eval_loader.images, self.eval_loader.labels
        )
        return totals, ev

    def _run_epoch(self, epoch: int) -> Tuple[Dict[str, float], Dict[str, float]]:
        """Dispatch one train and one eval epoch; fetch both totals in one
        device-to-host copy."""
        totals, ev = self.dispatch_epoch(epoch)
        both = torch.stack(
            [totals[k] for k in METRIC_KEYS] + [ev[k] for k in METRIC_KEYS]
        ).tolist()  # the one sync of the epoch
        k = len(METRIC_KEYS)
        return dict(zip(METRIC_KEYS, both[:k])), dict(zip(METRIC_KEYS, both[k:]))

    def _log_train_totals(self, epoch, m, dt) -> Tuple[float, float]:
        count = max(m["count"], 1)
        loss, acc = m["loss_sum"] / count, 100.0 * m["correct"] / count
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
        """Leave the process group if this trainer made it."""
        if self._owns_group:
            dist.destroy_process_group()
            self._owns_group = False

    def evaluate(self) -> float:
        """One eval epoch of the restored state (``--evaluate``); returns
        its accuracy."""
        ev = self.eval_epoch_fn(
            self.state, self.eval_loader.images, self.eval_loader.labels
        )
        m = dict(zip(METRIC_KEYS,
                     torch.stack([ev[k] for k in METRIC_KEYS]).tolist()))
        _, acc = self._log_eval_totals(max(self.start_epoch - 1, 0), m)
        return acc

    def fit(self) -> float:
        cfg = self.config
        log.info(
            "==> model %s | %d devices | global batch %d | %d steps/epoch",
            cfg.model, self.world, self.global_batch, self.steps_per_epoch,
        )
        if cfg.evaluate:
            return self.evaluate()
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
                train_m, eval_m = self._run_epoch(epoch)
                now = time.perf_counter()
                dt, last_mark = now - last_mark, now
                train_loss, train_acc = self._log_train_totals(
                    epoch, train_m, dt)
                eval_loss, eval_acc = self._log_eval_totals(epoch, eval_m)
                self.maybe_checkpoint(epoch, eval_acc)
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
            # writer is joined on every exit path
            try:
                self.flush_checkpoints()
            finally:
                if self._ckpt_writer is not None:
                    self._ckpt_writer.close()
                if old_handler is not None:
                    signal.signal(signal.SIGTERM, old_handler)
        return self.best_acc
