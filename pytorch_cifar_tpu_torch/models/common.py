"""Shared building blocks for the port's models.

Counterpart of ``pytorch_cifar_tpu/models/common.py``. The layers subclass
PyTorch's own, so ``state_dict()`` keeps the reference layout:
``nn.Conv2d``/``nn.Linear`` default init *is* the init the JAX package
re-derives (U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases),
and :func:`reset_parameters` redraws it from an explicit
``torch.Generator``.

The bf16 policy is the JAX package's (``config.amp``): fp32 parameters, BN
statistics and loss, compute in the input's dtype. :class:`Conv2d` and
:class:`Linear` cast their fp32 weights to the input's dtype at each call
(explicit casts, not ``torch.autocast``, whose op lists would round at
other places than the JAX model does). :class:`BatchNorm` is the JAX
``BatchNorm``'s train-mode semantics, with its moments computed by
:func:`bn_batch_moments` (pluggable through :func:`bn_moments_impl`).

Activations are NCHW-logical tensors in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` is a zero-copy NHWC view for the NHWC kernels:
the fused conv3x3+BN+ReLU (eval), the 3x3 / stride 1 max pool (train and
eval) and the depthwise stencil (eval).

The models' random draws (EfficientNet's drop-connect and dropout) come
from the draw function the train step sets with :func:`stochastic_draws`,
never from the global RNG; :func:`keep_mask` asks it, and
:func:`drop_connect` applies a mask it is given.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch import nn

from pytorch_cifar_tpu_torch.ops.conv_bn_relu import conv3x3_bn_relu
from pytorch_cifar_tpu_torch.ops.depthwise_stencil import (
    KERNEL_SIZES,
    depthwise_stencil,
)
from pytorch_cifar_tpu_torch.ops.max_pool import max_pool3x3_s1

BN_EPS = 1e-5
RELU, SWISH = "relu", "swish"  # the activations a folded site applies


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype: the fp32 weight (and
    bias) is cast to ``x.dtype`` at each call, as the JAX ``Conv`` casts
    its fp32 params to the module dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` computing in the input's dtype (see :class:`Conv2d`)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def folded_dense(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """``x @ w.T + b`` of a folded forward, with each row's reduction order
    fixed by construction: the products ``x[r, i] * w[o, i]`` in fp32
    (exact for bf16 factors), zero-padded to a power of two along ``i`` and
    summed by halving (``p[:h] + p[h:]`` until one column is left), then
    the bias, then the cast back to ``x.dtype``. Every step is elementwise,
    so a row's bits depend on neither the rows beside it, the thread count
    nor the device, where a GEMM (``F.linear``: MKL's ``sgemm`` on the CPU)
    picks its blocking by the batch. Serving only: training keeps
    :class:`Linear`."""
    p = x.float().unsqueeze(1) * w.float().unsqueeze(0)
    width = p.shape[-1]
    padded = 1 << max(width - 1, 0).bit_length()
    if padded != width:
        p = F.pad(p, (0, padded - width))
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return (p[..., 0] + b.float()).to(x.dtype)


# the batch extent of an fp32 folded forward's library convs on the card
FP32_CONV_ROWS = 8


def folded_conv2d(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, stride: int = 1,
                  padding: int = 0, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` of a folded forward. On the card in fp32 it runs on
    chunks of exactly :data:`FP32_CONV_ROWS` rows (the last one zero-padded,
    the padding dropped after): cuDNN picks its fp32 algorithm by the batch
    (TF32 or not), so a row's bits would depend on the micro-batch it
    joins, and an fp32 device group owes every row the one-card engine's
    bits. Every other case is one call: bf16 serving is held to 2% of the
    largest logit (whether its bits hold across a group is measured, not
    owed), and oneDNN keeps an fp32 row's bits at every batch of two rows
    or more (one row is its own kernel class, as in JAX: the device
    group's singleton bucket keeps it)."""
    if not (x.is_cuda and x.dtype == torch.float32):
        return F.conv2d(x, w, b, stride=stride, padding=padding,
                        groups=groups)
    n, rows = x.shape[0], FP32_CONV_ROWS
    pad = -n % rows
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    # every chunk in one layout: cuDNN picks by the layout too
    x = x.contiguous(memory_format=torch.channels_last)
    y = torch.cat([
        F.conv2d(c, w, b, stride=stride, padding=padding, groups=groups)
        for c in x.split(rows)])
    return y[:n]


def swish(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, written as the JAX EfficientNet writes it."""
    return x * torch.sigmoid(x)


def activate(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """``act`` (None, :data:`RELU` or :data:`SWISH`) applied to ``x``."""
    if act is None:
        return x
    if act == RELU:
        return torch.relu(x)
    if act == SWISH:
        return swish(x)
    raise ValueError(f"unknown activation {act!r}")


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """ShuffleNet's channel shuffle of an NCHW activation: C -> (g, C/g)
    -> transposed -> C, the reference's view/permute (JAX
    ``models/common.py:508``). Computed on the NHWC view, so a
    channels_last input gives a channels_last output (one copy)."""
    n, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(n, h, w, groups, c // groups)
    return y.transpose(3, 4).reshape(n, h, w, c).permute(0, 3, 1, 2)


# The models' random draws: fn(shape, keep) -> bool mask, True with
# probability ``keep``. The train step sets it (TrainState.model_draws);
# a train-mode forward that draws without one raises.
_STOCHASTIC: contextvars.ContextVar = contextvars.ContextVar(
    "stochastic_draws", default=None
)


@contextlib.contextmanager
def stochastic_draws(fn: Optional[Callable]):
    """Within the block, :func:`keep_mask` draws with ``fn(shape, keep)``
    (the JAX model's ``"stochastic"`` rng stream)."""
    token = _STOCHASTIC.set(fn)
    try:
        yield
    finally:
        _STOCHASTIC.reset(token)


def keep_mask(shape: Tuple[int, ...], keep: float) -> torch.Tensor:
    """A bool mask of ``shape``, True with probability ``keep``, from the
    draw function :func:`stochastic_draws` set."""
    fn = _STOCHASTIC.get()
    if fn is None:
        raise RuntimeError(
            "a train-mode forward draws random masks: run it under "
            "models.common.stochastic_draws (the train step does)"
        )
    return fn(tuple(shape), keep)


def drop_connect(x: torch.Tensor, mask: torch.Tensor,
                 rate: float) -> torch.Tensor:
    """``where(mask, x / (1 - rate), 0)`` in ``x``'s dtype: with a
    per-sample ``mask`` ``(n, 1, 1, 1)`` stochastic depth (JAX
    ``efficientnet.py:38``), with an elementwise one flax ``nn.Dropout``'s
    arithmetic."""
    keep = 1.0 - rate
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


# Pluggable batch-moments implementation: fn(x_nhwc) -> (E[x], E[x^2]) in
# fp32 over N, H, W. None -> the inline twin reduce of bn_batch_moments.
# ops.bn_stats.fused_moments (kernel K2) plugs in here.
_BN_MOMENTS_IMPL: contextvars.ContextVar = contextvars.ContextVar(
    "bn_moments_impl", default=None
)


@contextlib.contextmanager
def bn_moments_impl(fn: Optional[Callable]):
    """Within the block, every :class:`BatchNorm` in train mode computes
    its batch moments with ``fn`` (given the NHWC view of its input)."""
    token = _BN_MOMENTS_IMPL.set(fn)
    try:
        yield
    finally:
        _BN_MOMENTS_IMPL.reset(token)


# Set while ``torch.utils.checkpoint`` recomputes a train forward in the
# backward: the forward already updated the running stats once.
_RUNNING_FROZEN: contextvars.ContextVar = contextvars.ContextVar(
    "bn_running_frozen", default=False
)


def recompute_context() -> Callable[[], contextlib.AbstractContextManager]:
    """A factory of the context in which ``torch.utils.checkpoint``
    recomputes a train forward (its ``context_fn``'s second half). The
    recompute runs in the backward, outside the step's context managers
    (on CUDA on autograd's device thread, which sees none of this
    thread's context variables): the factory captures the
    :func:`bn_moments_impl` current now, and within the context
    :class:`BatchNorm` leaves its running stats alone."""
    impl = _BN_MOMENTS_IMPL.get()

    @contextlib.contextmanager
    def replay():
        tokens = _BN_MOMENTS_IMPL.set(impl), _RUNNING_FROZEN.set(True)
        try:
            yield
        finally:
            _RUNNING_FROZEN.reset(tokens[1])
            _BN_MOMENTS_IMPL.reset(tokens[0])

    return replay


def bn_batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel batch ``(E[x], E[x^2])`` of an NCHW activation, in fp32
    (at least: f64 stays f64), honouring a :func:`bn_moments_impl`
    override, which is handed the NHWC view ``x.permute(0, 2, 3, 1)``."""
    impl = _BN_MOMENTS_IMPL.get()
    if impl is not None:
        return impl(x.permute(0, 2, 3, 1))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    return xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))


# Cross-replica BatchNorm: the data-parallel axis whose ranks pool their
# batch moments, or None (each rank normalizes its own shard, the
# reference's BN under DDP). torch has one group, the default process
# group; the axis names it.
_SYNC_BN_AXIS: contextvars.ContextVar = contextvars.ContextVar(
    "sync_bn_axis", default=None
)


@contextlib.contextmanager
def sync_batchnorm(axis_name: Optional[str]):
    """Within the block, every :class:`BatchNorm` in train mode averages
    its batch moments ``(E[x], E[x^2])`` over the ranks of ``axis_name``
    (the default process group), so it normalizes with the global batch's
    statistics (JAX ``models/common.py:44-66``). ``None`` leaves BN
    local."""
    token = _SYNC_BN_AXIS.set(axis_name)
    try:
        yield
    finally:
        _SYNC_BN_AXIS.reset(token)


def _sync_moments(mean: torch.Tensor, sq: torch.Tensor):
    """``(E[x], E[x^2])`` averaged over the ranks in one all-reduce of the
    stacked 2C values; its backward all-reduces the cotangents (the
    transpose of the JAX ``pmean``). Returns them with the world size."""
    world = dist.get_world_size()
    both = dist_fn.all_reduce(torch.cat([mean, sq])) / world
    c = mean.shape[0]
    return both[:c], both[c:], world


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with the JAX package's ``BatchNorm`` semantics (torch-exact
    ``BatchNorm2d``): eps 1e-5, momentum 0.1 (new = 0.9 old + 0.1 batch).

    Train mode normalizes with the one-pass biased variance
    ``max(E[x^2] - E[x]^2, 0)`` and updates the running var with the
    unbiased one (n / (n - 1)); the running stats are fp32 and updated in
    place, except while a recompute (:func:`recompute_context`) replays
    the forward. Under :func:`sync_batchnorm` the moments are the ranks'
    mean and n counts the global batch. The normalization is one per-channel
    FMA ``x * mul + add`` whose scalars are computed in fp32 and applied
    in ``x``'s dtype. Eval mode
    applies the same fold to the running stats. ``num_batches_tracked``
    stays in the ``state_dict`` (reference layout) and is not advanced:
    only ``momentum=None`` reads it."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=0.1)

    def forward(self, x, moments=None):
        """``moments``: optional precomputed fp32 ``(E[x], E[x^2])``, used
        in train mode instead of reducing ``x`` here (autograd flows
        through them)."""
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean, sq = bn_batch_moments(x) if moments is None else moments
            world = 1
            if _SYNC_BN_AXIS.get() is not None:
                mean, sq, world = _sync_moments(mean, sq)
            var = torch.clamp(sq - mean * mean, min=0.0)
            if not _RUNNING_FROZEN.get():
                self._update_running(mean, var, x.numel() // x.shape[1]
                                     * world)  # the global count
        mul = self.weight * torch.rsqrt(var + self.eps)
        add = self.bias - mean * mul
        shape = (1, -1, 1, 1)
        return x * mul.to(x.dtype).view(shape) + add.to(x.dtype).view(shape)

    @torch.no_grad()
    def _update_running(self, mean, var, n: int) -> None:
        unbiased = var * (n / max(n - 1, 1))
        m = self.momentum
        self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1.0 - m) * self.running_var + m * unbiased)


def conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False,
         groups: int = 1) -> Conv2d:
    """Conv with torch ``padding=k//2`` (the zoo's 1x1 and 3x3): bias-free
    unless asked (GoogLeNet's convs keep theirs), depthwise with
    ``groups=cin``."""
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias,
                  groups=groups)


def batchnorm(c: int) -> BatchNorm:
    return BatchNorm(c)


@torch.no_grad()
def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """PyTorch-default init drawn from ``generator``: conv/linear weight and
    bias U(-b, b) with b = 1/sqrt(fan_in); BN scale 1, bias 0, running
    stats (0, 1)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def fold_bn(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BN as a per-channel affine, exactly as the JAX model folds
    it: ``mul = scale * rsqrt(var + eps)``, ``add = bias - mean * mul``, in
    fp32 (the caller applies it in the compute dtype)."""
    mul = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    add = bn.bias.float() - bn.running_mean.float() * mul
    return mul, add


@dataclass(frozen=True)
class FoldedConvBN:
    """One eval-mode conv -> BN [-> activation] site with the BN (and the
    conv's bias) folded, its weights already in the layout and dtype the
    forward consumes; ``act`` is None, :data:`RELU` or :data:`SWISH`.
    Three kinds of site:

    - ``fused`` (dense 3x3, stride 1, followed by ReLU) runs the NHWC
      kernel ``conv3x3_bn_relu``: ``weight`` is HWIO in the compute dtype,
      ``mul``/``add`` fp32 ``(c,)``.
    - ``stencil`` (depthwise k x k with k in 3, 5, 7, stride 1, SAME) runs
      the NHWC kernel ``depthwise_stencil``: ``weight`` is ``(k, k, c)`` in
      the compute dtype; the affine and the activation follow in the
      compute dtype, which is where the JAX model rounds.
    - every other site runs ``F.conv2d(groups=groups)``: ``weight`` is OIHW
      channels_last in the compute dtype.

    Outside fused sites ``mul``/``add`` are ``(1, c, 1, 1)`` in the compute
    dtype, or both None for a conv with no BN after it (a pre-activation
    block's last conv, DenseNet's 3x3), which is no fused site."""

    weight: torch.Tensor
    mul: Optional[torch.Tensor]
    add: Optional[torch.Tensor]
    stride: int
    padding: int
    act: Optional[str]
    fused: bool
    groups: int = 1
    stencil: bool = False


@torch.no_grad()
def fold_conv_bn(
    conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d], dtype: torch.dtype,
    act: Optional[str] = None,
) -> FoldedConvBN:
    """Fold one site for ``dtype`` compute (once per weight set), ``act``
    after it. A conv bias goes into the affine: ``bn((x * w) + b) = (x * w)
    * mul + (bn.bias + (b - running_mean) * mul)``. Only a ReLU site can be
    fused (the kernel applies ReLU); a depthwise conv with a channel
    multiplier (``out != in``) is no stencil site. ``bn=None`` is a
    bias-free conv with nothing after it: no affine, no fused site."""
    if bn is None:
        if conv.bias is not None or act is not None:
            raise ValueError("a conv with no BN takes no bias or activation")
        mul = add = None
    else:
        mul, add = fold_bn(bn)
        if conv.bias is not None:
            add = add + conv.bias.float() * mul
    stride, padding, groups = conv.stride[0], conv.padding[0], conv.groups
    k = conv.kernel_size[0]
    same = conv.kernel_size == (k, k) and padding == k // 2 and stride == 1
    fused = act == RELU and groups == 1 and k == 3 and same
    stencil = (
        groups > 1 and groups == conv.in_channels == conv.out_channels
        and k in KERNEL_SIZES and same
    )
    if fused:
        weight = conv.weight.permute(2, 3, 1, 0).to(dtype).contiguous()
    else:
        if stencil:  # (c, 1, k, k) -> (k, k, c)
            weight = conv.weight[:, 0].permute(1, 2, 0).to(dtype).contiguous()
        else:
            weight = conv.weight.to(dtype).contiguous(
                memory_format=torch.channels_last
            )
        if mul is not None:
            mul = mul.to(dtype).view(1, -1, 1, 1)
            add = add.to(dtype).view(1, -1, 1, 1)
    return FoldedConvBN(weight, mul, add, stride, padding, act, fused,
                        groups, stencil)


def conv_bn(x: torch.Tensor, f: FoldedConvBN) -> torch.Tensor:
    """Apply one folded site to a channels_last activation. Fused and
    stencil sites go through their kernel's wrapper (the Hopper kernel on a
    CUDA tensor, its plain version on a CPU one)."""
    if f.fused:
        y = conv3x3_bn_relu(x.permute(0, 2, 3, 1), f.weight, f.mul, f.add)
        return y.permute(0, 3, 1, 2)
    if f.stencil:
        # a conv of a channel slice (ShuffleNetV2) need not come out dense
        x = x.contiguous(memory_format=torch.channels_last)
        y = depthwise_stencil(x.permute(0, 2, 3, 1), f.weight)
        y = y.permute(0, 3, 1, 2)
    else:
        y = folded_conv2d(x, f.weight, stride=f.stride, padding=f.padding,
                          groups=f.groups)
    if f.mul is None:
        return y
    return activate(y * f.mul + f.add, f.act)


@torch.no_grad()
def fold_affine(bn: nn.BatchNorm2d, dtype: torch.dtype) -> Tuple[
        torch.Tensor, torch.Tensor]:
    """An eval-mode BN with no conv before it to fold into (a
    pre-activation block's first BN, DenseNet's BNs over the stack): its
    ``(mul, add)``, ``(1, c, 1, 1)`` in the compute dtype."""
    mul, add = fold_bn(bn)
    return mul.to(dtype).view(1, -1, 1, 1), add.to(dtype).view(1, -1, 1, 1)


def affine_relu(x: torch.Tensor, f: Tuple[torch.Tensor, torch.Tensor]
                ) -> torch.Tensor:
    """``relu(x * mul + add)`` of a :func:`fold_affine` result, in ``x``'s
    dtype (where the JAX BN rounds)."""
    return torch.relu(x * f[0] + f[1])


def se_gate(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Squeeze-excitation on an NCHW activation (SENet, RegNetY): the
    global mean, a 1x1 conv with bias, ReLU, a 1x1 conv with bias, sigmoid,
    and ``x`` times the gate, all in ``x``'s dtype (the weights are cast to
    it, as the JAX model computes the gate in the compute dtype)."""
    dt = x.dtype
    w = x.mean(dim=(2, 3), keepdim=True)
    w = torch.relu(F.conv2d(w, w1.to(dt), b1.to(dt)))
    return x * torch.sigmoid(F.conv2d(w, w2.to(dt), b2.to(dt)))


def max_pool(x: torch.Tensor, window: int, stride: Optional[int] = None,
             padding: int = 0) -> torch.Tensor:
    """Max pool of a channels_last NCHW activation (``stride`` defaults to
    ``window``, as in the JAX ``max_pool``). The 3 / 1 / 1 pool of the
    Inception cells and of PNASNet's stride-1 cells goes through
    ``ops.max_pool.max_pool3x3_s1`` (forward and backward kernels on a CUDA
    tensor); every other pool, such as GoogLeNet's 3 / 2 / 1 stage
    transitions and PNASNet's stride-2 cells, through ``F.max_pool2d``."""
    stride = stride or window
    if (window, stride, padding) == (3, 1, 1):
        x = x.contiguous(memory_format=torch.channels_last)
        return max_pool3x3_s1(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    return F.max_pool2d(x, window, stride, padding)


def avg_pool(x: torch.Tensor, window: int, stride: Optional[int] = None,
             padding: int = 0) -> torch.Tensor:
    """Average pool (``stride`` defaults to ``window``); padding counts in
    the divisor (``count_include_pad``, flax's ``avg_pool`` default, as
    ShuffleNet's 3 / 2 / 1 shortcut pool needs)."""
    return F.avg_pool2d(x, window, stride or window, padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """``adaptive_avg_pool2d(1)`` + flatten of an NCHW activation: ``(n,
    c)``."""
    return x.mean(dim=(2, 3))


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
