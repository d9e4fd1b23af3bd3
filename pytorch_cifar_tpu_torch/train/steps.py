"""Train and eval steps, and the whole-epoch programs (counterpart of
``pytorch_cifar_tpu/train/steps.py``).

A train step is augmentation (on the device), forward, the masked
cross-entropy, backward and the SGD update, with the step's metrics left
on the device. The forward draws its own random masks (EfficientNet's)
from the state's model generator, seeded apart from the augmentation's.
The epoch program gathers the whole epoch's rows in one pass (kernel K1
on a CUDA tensor when ``dma_gather`` is on), labels the
wrap-padded tail -1, runs the steps on contiguous slices and sums their
metrics on the device: nothing inside an epoch waits for the host, and the
one sync is the caller's fetch of the totals.

Data parallelism (``axis_name`` = ``parallel.mesh.DATA_AXIS``): each rank
of the default process group runs the step on its shard of the global
batch, as one shard of the JAX package's ``shard_map`` step does. The
loss is the global-count mean (its psum of the valid count rides the
metrics' one all-reduce, made before the backward), the gradients and,
unless ``sync_bn``, the BN running buffers are averaged through one flat
all-reduce before the update, and the non-finite verdict and the metrics
are global. The epoch programs gather and evaluate only the rank's rows.

Not ported yet: spatial partitioning (``batch_sharding``), ``remat``, the
divergence sentinel's ``skip_nonfinite`` and the fault-injection hook. The
constructors raise ``NotImplementedError`` when asked for any of them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.data.augment import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    augment_batch,
    normalize,
)
from pytorch_cifar_tpu_torch.models.common import (
    stochastic_draws,
    sync_batchnorm,
)
from pytorch_cifar_tpu_torch.ops.dma_gather import dma_row_gather
from pytorch_cifar_tpu_torch.parallel.dp import (
    all_reduce_mean_,
    all_reduce_sum_,
    bn_running_buffers,
    shard_positions,
)
from pytorch_cifar_tpu_torch.parallel.mesh import (
    is_distributed,
    rank,
    world_size,
)
from pytorch_cifar_tpu_torch.train.optim import set_lr
from pytorch_cifar_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]
METRIC_KEYS = ("loss_sum", "correct", "count", "nonfinite")


def _device_stats(mean, std, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mean`` and ``std`` as fp32 tensors on the step's device, made once
    when the step is built: a host tuple would cost a blocking host-to-device
    copy in every step."""
    dev = resolve_device(device)
    return (torch.tensor(mean, dtype=torch.float32, device=dev),
            torch.tensor(std, dtype=torch.float32, device=dev))


def _not_ported(**requested) -> None:
    asked = sorted(k for k, v in requested.items() if v)
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)} not ported yet (no spatial partitioning, "
            "no remat, no sentinel)"
        )


def cross_entropy_sums(
    logits: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of CE over valid rows, valid count), in fp32 (at least);
    labels < 0 are padding and contribute nothing."""
    valid = labels >= 0
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    losses = F.cross_entropy(lf, labels.clamp(min=0).long(), reduction="none")
    return torch.where(valid, losses, 0.0).sum(), valid.sum()


def _metrics(logits: torch.Tensor, labels: torch.Tensor) -> Metrics:
    valid = labels >= 0
    correct = ((logits.argmax(dim=-1) == labels) & valid).sum()
    loss_sum, n_valid = cross_entropy_sums(logits, labels)
    return {
        "loss_sum": loss_sum.float(),
        "correct": correct.float(),
        "count": n_valid.float(),
        "nonfinite": (~torch.isfinite(loss_sum)).float(),
    }


def zero_metrics(device="cpu") -> Metrics:
    """Initial running metric sums (fp32 scalars on ``device``)."""
    return {k: torch.zeros((), device=device) for k in METRIC_KEYS}


def add_metrics(totals: Metrics, metrics: Metrics) -> Metrics:
    return {k: totals[k] + metrics[k] for k in METRIC_KEYS}


def _psum_metrics(metrics: Metrics) -> Metrics:
    """The metrics summed over the ranks, in one all-reduce."""
    both = all_reduce_sum_(torch.stack([metrics[k] for k in METRIC_KEYS]))
    return dict(zip(METRIC_KEYS, both.unbind()))


def _check_axis(axis_name: Optional[str]) -> None:
    if axis_name is not None and not is_distributed():
        raise ValueError(
            f"axis_name={axis_name!r} needs the job's process group "
            "(parallel.mesh.initialize_distributed)"
        )


def _check_shards(axis_name: Optional[str], n_shards: int) -> None:
    _check_axis(axis_name)
    if axis_name is None and n_shards > 1:
        raise ValueError("n_shards > 1 needs a data-parallel axis_name")
    if axis_name is not None and n_shards != world_size():
        raise ValueError(
            f"n_shards={n_shards} must equal the process group's "
            f"{world_size()} ranks"
        )


def make_train_step(
    augment: bool = True,
    crop: bool = True,
    flip: bool = True,
    mean: Sequence[float] = CIFAR10_MEAN,
    std: Sequence[float] = CIFAR10_STD,
    compute_dtype: torch.dtype = torch.float32,
    axis_name: Optional[str] = None,
    remat: bool = False,
    sync_bn: bool = False,
    skip_nonfinite: bool = False,
    device=None,
) -> Callable:
    """Returns ``step(state, batch=(uint8 NHWC images, labels)) ->
    metrics``: one SGD update of ``state`` in place, with the crop offsets
    and flip bits the state draws for its step. The batch lies on
    ``device`` (CUDA unless the caller names another).

    With ``axis_name`` the batch is this rank's shard of the global batch
    and the update is the global one (see the module docstring); the
    augmentation draw folds in the rank. ``sync_bn`` (which needs
    ``axis_name``) normalizes every BN with the global batch's moments."""
    if sync_bn and axis_name is None:
        raise ValueError("sync_bn requires a data-parallel axis_name")
    _not_ported(remat=remat, skip_nonfinite=skip_nonfinite)
    _check_axis(axis_name)
    mean, std = _device_stats(mean, std, device)

    def step(state: TrainState, batch) -> Metrics:
        images, labels = batch
        shard = None if axis_name is None else rank()
        if augment:
            offsets, flips = state.draw_augment(images.shape[0], shard=shard)
            x = augment_batch(images, offsets, flips, crop=crop, flip=flip,
                              mean=mean, std=std, dtype=compute_dtype)
        else:
            x = normalize(images, mean, std, dtype=compute_dtype)
        model = state.model
        model.train()
        with sync_batchnorm(axis_name if sync_bn else None), \
                stochastic_draws(state.model_draws(shard)):
            logits = model(x.permute(0, 3, 1, 2))  # NCHW view, channels_last
        loss_sum, n_valid = cross_entropy_sums(logits, labels)
        if axis_name is None:
            loss = loss_sum / n_valid.clamp(min=1)
        else:
            # the global-batch mean (JAX steps.py:148-160): shards of a
            # wrap-padded batch hold different valid counts, so the local
            # sum is scaled by world / global count, and the mean of the
            # ranks' gradients is the global batch's
            metrics = _psum_metrics(_metrics(logits.detach(), labels))
            loss = loss_sum * world_size() / metrics["count"].clamp(min=1)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                # a parameter the forward never reads (EfficientNet's dead
                # expand conv) has a zero gradient in the JAX step, so
                # decay and momentum move it there: give it one here too
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if axis_name is None:
            metrics = _metrics(logits.detach(), labels)
            bad = ~torch.isfinite(loss.detach())
        else:
            # one flat all-reduce: the gradients, and the running stats
            # the forward updated from this shard (sync_bn's are equal)
            all_reduce_mean_(
                grads + ([] if sync_bn else bn_running_buffers(model)))
            # a rank's non-finite loss shows in the summed metrics
            bad = metrics["nonfinite"] > 0
        bad = bad | ~torch.isfinite(torch.nn.utils.get_total_norm(grads))
        metrics["nonfinite"] = torch.maximum(
            (metrics["nonfinite"] > 0).float(), bad.float()
        )
        set_lr(state.optimizer, state.schedule(state.step))
        state.optimizer.step()
        state.step += 1
        return metrics

    return step


def make_train_epoch(
    step: Callable,
    global_batch: int,
    n_data: int,
    num_steps: int,
    axis_name: Optional[str] = None,
    n_shards: int = 1,
    batch_sharding=None,
    label_sharding=None,
    dma_gather: bool = False,
) -> Callable:
    """``epoch_fn(state, totals, images, labels, perm) -> (state, totals)``:
    one epoch of ``num_steps`` steps over the device-resident dataset.

    The rows of the whole epoch are gathered once, in visit order, from the
    extended permutation ``perm``: by :func:`~..ops.dma_gather.dma_row_gather`
    (kernel K1 on a CUDA tensor) when ``dma_gather`` is set, else by the
    library gather ``torch.index_select``. Positions >= ``n_data`` (the
    wrap-padded tail) get label -1. Step i takes rows
    ``[i * global_batch, (i + 1) * global_batch)``; with ``axis_name``
    (over ``n_shards`` ranks, every rank holding the same ``perm``) this
    rank gathers only its shard's ``global_batch / n_shards`` of them."""
    _not_ported(batch_sharding=batch_sharding is not None,
                label_sharding=label_sharding is not None)
    _check_shards(axis_name, n_shards)
    shard_batch = global_batch // n_shards
    total = num_steps * shard_batch

    def epoch_fn(state, totals, images, labels, perm):
        if axis_name is None:
            idx = perm[:total]
            pos = torch.arange(total, device=idx.device)
        else:
            pos = shard_positions(num_steps, global_batch, rank(), n_shards,
                                  perm.device)
            idx = perm[pos]
        if dma_gather:
            x_all = dma_row_gather(images, idx)
        else:
            x_all = torch.index_select(images, 0, idx)
        y_all = torch.where(
            pos < n_data, torch.index_select(labels, 0, idx), -1
        )
        for i in range(num_steps):
            rows = slice(i * shard_batch, (i + 1) * shard_batch)
            metrics = step(state, (x_all[rows], y_all[rows]))
            totals = add_metrics(totals, metrics)
        return state, totals

    return epoch_fn


def make_eval_step(
    mean: Sequence[float] = CIFAR10_MEAN,
    std: Sequence[float] = CIFAR10_STD,
    compute_dtype: torch.dtype = torch.float32,
    axis_name: Optional[str] = None,
    device=None,
) -> Callable:
    """Returns ``step(state, batch) -> metrics``, the model in eval mode
    (a ResNet folds its BNs and runs the serving forward). Labels < 0 are
    padding; the batch lies on ``device`` (CUDA unless the caller names
    another). With ``axis_name`` the batch is this rank's shard and the
    metrics are summed over the ranks."""
    _check_axis(axis_name)
    mean, std = _device_stats(mean, std, device)

    @torch.no_grad()
    def step(state: TrainState, batch) -> Metrics:
        images, labels = batch
        x = normalize(images, mean, std, dtype=compute_dtype)
        state.model.eval()
        logits = state.model(x.permute(0, 3, 1, 2))
        metrics = _metrics(logits, labels)
        return metrics if axis_name is None else _psum_metrics(metrics)

    return step


def make_eval_epoch(
    step: Callable,
    global_batch: int,
    n_data: int,
    num_steps: int,
    axis_name: Optional[str] = None,
    n_shards: int = 1,
    batch_sharding=None,
    label_sharding=None,
) -> Callable:
    """``epoch_fn(state, images, labels) -> totals`` over the static test
    set: batch i is rows ``[i * B, (i + 1) * B)``, with positions >=
    ``n_data`` clamped to the last row and labelled -1. With ``axis_name``
    this rank takes its shard's ``B / n_shards`` rows of each batch."""
    _not_ported(batch_sharding=batch_sharding is not None,
                label_sharding=label_sharding is not None)
    _check_shards(axis_name, n_shards)
    shard_batch = global_batch // n_shards

    def epoch_fn(state, images, labels):
        totals = zero_metrics(images.device)
        shard = 0 if axis_name is None else rank()
        for i in range(num_steps):
            start = i * global_batch + shard * shard_batch
            pos = torch.arange(start, start + shard_batch,
                               device=images.device)
            safe = pos.clamp(max=n_data - 1)
            x = torch.index_select(images, 0, safe)
            y = torch.where(
                pos < n_data, torch.index_select(labels, 0, safe), -1
            )
            totals = add_metrics(totals, step(state, (x, y)))
        return totals

    return epoch_fn
