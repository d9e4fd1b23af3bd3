"""Trainer of the port: ``Trainer(config).fit()`` on one device over the
device-resident data plane (counterpart of
``pytorch_cifar_tpu/train/trainer.py``).

Each epoch is one train epoch program (``steps.make_train_epoch``: the
epoch's rows gathered at once, through kernel K1 on CUDA when
``config.dma_gather`` is set), then one eval epoch over the static test
set, then ONE fetch of both epochs' metric totals: the only host sync of
the epoch. The log lines, the best-accuracy gate and the returned value
are the JAX trainer's. No checkpoint is written yet (a later slice): the
gate records ``best_acc`` and logs it.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Tuple

import torch

from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.config import TrainConfig, check_ported
from pytorch_cifar_tpu_torch.data.cifar10 import load_cifar10, synthetic_cifar10
from pytorch_cifar_tpu_torch.data.pipeline import DeviceDataset
from pytorch_cifar_tpu_torch.models import create_model
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
        self.config = config
        self.device = resolve_device(config.device)

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
        self.global_batch = config.batch_size
        self.loader = DeviceDataset(
            tr_x, tr_y, batch_size=self.global_batch, shuffle=True,
            drop_last=config.drop_last, seed=config.seed,
            device_perm=config.device_perm, device=self.device,
        )
        self.steps_per_epoch = len(self.loader)
        self.eval_bs = config.eval_batch_size
        self.eval_loader = DeviceDataset(
            te_x, te_y, batch_size=self.eval_bs, shuffle=False,
            device=self.device,
        )

        # -- model/optimizer/state ------------------------------------
        model = create_model(
            config.model, num_classes=config.num_classes,
            generator=torch.Generator().manual_seed(config.seed),
        ).to(self.device, memory_format=torch.channels_last)
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
        self.train_epoch_fn = make_train_epoch(
            make_train_step(
                crop=config.random_crop, flip=config.random_flip,
                mean=config.mean, std=config.std, compute_dtype=compute,
                device=self.device,
            ),
            global_batch=self.global_batch,
            n_data=tr_x.shape[0],
            num_steps=self.steps_per_epoch,
            dma_gather=config.dma_gather,
        )
        n_eval = te_x.shape[0]
        self.eval_epoch_fn = make_eval_epoch(
            make_eval_step(mean=config.mean, std=config.std,
                           compute_dtype=compute, device=self.device),
            global_batch=self.eval_bs,
            n_data=n_eval,
            num_steps=max(-(-n_eval // self.eval_bs), 1),
        )
        self.best_acc = 0.0
        self.history: List[dict] = []

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
        """The best-accuracy gate. Checkpoint writing is not ported yet:
        the gate records ``best_acc`` and logs."""
        if acc > self.best_acc:
            self.best_acc = acc
            log.info("Saving.. (best acc %.2f%%)", acc)
            return True
        return False

    def fit(self) -> float:
        cfg = self.config
        log.info(
            "==> model %s | %d devices | global batch %d | %d steps/epoch",
            cfg.model, 1, self.global_batch, self.steps_per_epoch,
        )
        last_mark = time.perf_counter()
        for epoch in range(cfg.epochs):
            log.info("\nEpoch: %d", epoch)
            train_m, eval_m = self._run_epoch(epoch)
            now = time.perf_counter()
            dt, last_mark = now - last_mark, now
            train_loss, train_acc = self._log_train_totals(epoch, train_m, dt)
            eval_loss, eval_acc = self._log_eval_totals(epoch, eval_m)
            self.maybe_checkpoint(epoch, eval_acc)
            self.history.append({
                "epoch": epoch, "train": train_m, "eval": eval_m,
                "train_loss": train_loss, "train_acc": train_acc,
                "eval_loss": eval_loss, "eval_acc": eval_acc,
                "epoch_s": dt, "img_per_sec": train_m["count"] / max(dt, 1e-9),
            })
        return self.best_acc
