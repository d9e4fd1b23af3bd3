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

The divergence sentinel's step half (``skip_nonfinite``): a step whose
loss or gradient norm is not finite leaves the params, the momentum
buffers and the BN running buffers as they were before it, bit for bit,
selected on the device with no host sync; the step counter still
advances. The fault hook ``nan_loss`` (``faults.py``) poisons one step's
loss. ``remat`` recomputes the forward in the backward.

Not ported yet: spatial partitioning (``batch_sharding``); the
constructors raise ``NotImplementedError`` when asked for it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pytorch_cifar_tpu_torch import faults, resolve_device
from pytorch_cifar_tpu_torch.data.augment import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    augment_batch,
    normalize,
)
from pytorch_cifar_tpu_torch.models.common import (
    recompute_context,
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
            f"{', '.join(asked)} not ported yet (no spatial partitioning)"
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


def zero_metrics(device="cpu", num_steps: int = 0) -> Metrics:
    """Initial running metric sums (fp32 scalars on ``device``).
    ``num_steps > 0`` adds ``nonfinite_steps``, one 0/1 slot per step of
    an epoch program: which steps the sentinel skipped, not only how
    many."""
    m = {k: torch.zeros((), device=device) for k in METRIC_KEYS}
    if num_steps > 0:
        m["nonfinite_steps"] = torch.zeros((num_steps,), device=device)
    return m


def add_metrics(totals: Metrics, metrics: Metrics) -> Metrics:
    """The running sums plus one step's metrics; a ``nonfinite_steps``
    vector is carried over as it is."""
    out = {k: totals[k] + metrics[k] for k in METRIC_KEYS}
    if "nonfinite_steps" in totals:
        out["nonfinite_steps"] = totals["nonfinite_steps"]
    return out


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


def _momentum_buffers(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Every parameter's SGD momentum buffer, zeros where torch has not
    made one yet: optax's ``trace`` starts from zeros (torch's first step
    takes the gradient as the buffer, the same values), and a skipped
    first step must leave a buffer to restore."""
    bufs = []
    for group in optimizer.param_groups:
        if not group["momentum"]:
            continue
        for p in group["params"]:
            st = optimizer.state[p]
            if st.get("momentum_buffer") is None:
                st["momentum_buffer"] = torch.zeros_like(p)
            bufs.append(st["momentum_buffer"])
    return bufs


def _flat_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as a 1-D view in memory order (contiguous or
    channels_last)."""
    if t.is_contiguous():
        return t.view(-1)
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return t.permute(0, 2, 3, 1).reshape(-1)
    raise ValueError(f"a {tuple(t.shape)} tensor with strides {t.stride()} "
                     "has no flat view")


class _UpdateGuard:
    """The sentinel's select. :meth:`save` copies the tensors a step
    changes (params, momentum buffers, BN running buffers) into one flat
    buffer per dtype before the forward mutates any of them;
    :meth:`keep_unless` gathers their new values into a second flat
    buffer after the update, selects ``where(bad, saved, new)`` there and
    copies the result back. ``torch.where`` picks the saved value whatever
    the new one holds (a blend would turn ``NaN * 0`` into NaN), and the
    new one bit for bit, so a finite step is the unguarded step. The two
    buffers persist (rebuilt when the tensors change, as after a restore),
    and every gather and scatter is one ``_foreach_copy_`` over flat
    views: three multi-tensor launches and one select a step per dtype."""

    def __init__(self):
        self._key = None
        self._groups: list = []

    def save(self, tensors: List[torch.Tensor]) -> None:
        key = tuple(map(id, tensors))
        if key != self._key:
            # the views keep their tensors alive, so no id is reused
            # while the key holds it
            by_dtype: Dict[torch.dtype, list] = {}
            for t in tensors:
                by_dtype.setdefault(t.dtype, []).append(_flat_view(t))
            self._groups = []
            for views in by_dtype.values():
                sizes = [v.numel() for v in views]
                saved = views[0].new_empty(sum(sizes))
                new = torch.empty_like(saved)
                self._groups.append((views, saved, list(saved.split(sizes)),
                                     new, list(new.split(sizes))))
            self._key = key
        with torch.no_grad():
            for views, _, saved_parts, _, _ in self._groups:
                torch._foreach_copy_(saved_parts, views)

    def keep_unless(self, bad: torch.Tensor) -> None:
        with torch.no_grad():
            for views, saved, _, new, new_parts in self._groups:
                torch._foreach_copy_(new_parts, views)
                torch.where(bad, saved, new, out=new)
                torch._foreach_copy_(views, new_parts)


def _train_forward(state: TrainState, x: torch.Tensor, shard, sync_axis,
                   remat: bool) -> torch.Tensor:
    """The model's train forward on NCHW ``x``: its draws from this
    step's model stream, its BNs pooled over ``sync_axis``. Under
    ``remat`` it runs in ``torch.utils.checkpoint``: its activations are
    recomputed in the backward, where the function reseeds the draws
    (EfficientNet's masks replay), pools the moments again in the same
    order on every rank, and :func:`recompute_context` restores the BN
    moments implementation and keeps the running stats from a second
    update. The kernels' autograd Functions (K2, K4) launch again there:
    their counters count the recompute."""
    model = state.model

    def run(x):
        with sync_batchnorm(sync_axis), \
                stochastic_draws(state.model_draws(shard)):
            return model(x)

    if not remat:
        return run(x)
    replay = recompute_context()
    return checkpoint(
        run, x, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), replay()),
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
    ``axis_name``) normalizes every BN with the global batch's moments.

    ``skip_nonfinite`` is the sentinel's step half (see the module
    docstring); the verdict stays on the device. Under ``axis_name`` it is
    the ranks' one verdict: each rank's local loss (the injected NaN
    included) rides the flat all-reduce of the gradients, and the summed
    metrics and the averaged gradients' norm join it, so every rank takes
    the same decision. ``remat`` recomputes the forward in the backward
    (``torch.utils.checkpoint``). An armed ``nan_loss`` fault
    (``faults.nan_loss_step``, read once here) multiplies the loss by NaN
    at that global step, or at every step when negative."""
    if sync_bn and axis_name is None:
        raise ValueError("sync_bn requires a data-parallel axis_name")
    _check_axis(axis_name)
    mean, std = _device_stats(mean, std, device)
    nan_step = faults.nan_loss_step()
    guard = _UpdateGuard() if skip_nonfinite else None

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
        params = list(model.parameters())
        momentum = _momentum_buffers(state.optimizer)
        bn_bufs = bn_running_buffers(model)
        if guard is not None:
            # before the forward, which updates the BN running buffers
            guard.save(params + momentum + bn_bufs)
        logits = _train_forward(state, x.permute(0, 3, 1, 2), shard,
                                axis_name if sync_bn else None, remat)
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
        if nan_step is not None and (nan_step < 0 or state.step == nan_step):
            # multiplied in, so the NaN reaches every gradient as a real
            # blow-up would
            loss = loss * float("nan")
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in params:
            if p.grad is None:
                # a parameter the forward never reads (EfficientNet's dead
                # expand conv) has a zero gradient in the JAX step, so
                # decay and momentum move it as there: give it one here too
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        local_bad = ~torch.isfinite(loss.detach())
        if axis_name is None:
            metrics = _metrics(logits.detach(), labels)
            bad = local_bad
        else:
            # one flat all-reduce: the gradients, the running stats the
            # forward updated from this shard (sync_bn's are equal), and
            # the local verdict (its mean is > 0 when any rank's is set)
            flag = local_bad.to(grads[0].dtype).reshape(1)
            all_reduce_mean_(grads + ([] if sync_bn else bn_bufs) + [flag])
            bad = (flag[0] > 0) | (metrics["nonfinite"] > 0)
        bad = bad | ~torch.isfinite(torch.nn.utils.get_total_norm(grads))
        metrics["nonfinite"] = torch.maximum(
            (metrics["nonfinite"] > 0).float(), bad.float()
        )
        set_lr(state.optimizer, state.schedule(state.step))
        state.optimizer.step()
        if guard is not None:
            guard.keep_unless(bad)
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
    rank gathers only its shard's ``global_batch / n_shards`` of them.
    When ``totals`` holds ``nonfinite_steps`` (:func:`zero_metrics` with
    ``num_steps``), slot i takes step i's 0/1 verdict on the device."""
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
            if "nonfinite_steps" in totals:
                totals["nonfinite_steps"][i] = metrics["nonfinite"]
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
