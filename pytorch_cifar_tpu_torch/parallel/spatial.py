"""Spatial partitioning: each image's height, and optionally its width,
cut over ranks (counterpart of ``pytorch_cifar_tpu/parallel/spatial.py``).

The JAX package lays a ``(data, spatial[, spatial_w])`` mesh over its
devices and lets GSPMD derive every collective of a global-semantics
step. Here each rank is one process and the collectives are explicit:

- the mesh (:func:`make_spatial_mesh`) maps a rank to its coordinate
  ``(d, s, w)``, row-major over ``(data, spatial, spatial_w)`` as JAX
  orders its devices; the ranks of one data index form its *spatial
  group*, which holds the slabs of the same images;
- every tensor of a height (width) extent ``n`` is cut over the ``S``
  (``W``) ranks of a line by one rule, :func:`shard_range`: shard ``i``
  owns rows ``[i * ceil(n / S), (i + 1) * ceil(n / S))`` clipped to ``n``
  (GSPMD's), so a rank may own fewer rows than another, or none;
- a window op (a conv or a pool of kernel ``k``, stride, padding) owns the
  output rows of that rule over its output extent and needs the input rows
  :func:`rows_needed` gives; :func:`halo_extend` fetches the rows other
  ranks own from them (point-to-point: NCCL card to card, gloo through
  the host) and pads the rows outside the image with the op's own value;
  its backward sends each fetched row's gradient back to its owner, which
  adds it in. The height is exchanged first, then the width of the
  height-extended slab, so a window's corner rows come right;
- batch moments are pooled over every rank, weighted by each rank's
  element count (``models.common.BatchNorm``), and a pool whose window
  covers the whole map is a sum over the spatial group
  (:func:`group_sum`, whose backward is again a sum);
- a flatten that needs the whole map (LeNet's) gathers it from the spatial
  group (:func:`gather_slabs`); its backward sums the gradient over the
  group and keeps the rank's own rows (the transpose of the gather).

Under :func:`spatial_partition` the layers of ``models.common`` take these
paths; outside it nothing here runs and every layer keeps its bits. The
train step (``train/steps.py``) gives each rank's loss the share
``D / count`` of its data shard's summed loss, so the ranks' losses add up
to ``world`` times the global mean and one mean all-reduce of the
gradients over the world gives the global batch's gradient.

The global extent of a slab is not in its shape (3 rows of a 5-row map
and 3 rows of a 6-row map look alike), so it travels with the tensor: the
step marks the model's input with the image's extent (:func:`mark_input`),
each window op marks its output with the extent it computed, and within
the partition a torch function mode copies the mark from an op's input to
its output when the two have the same local height and width (an
activation, a BN, a sum, a concatenation of channels). Every rank runs the
same ops, so every rank reads the same extent; a slab with no mark, or
whose mark does not cut to its shape on this rank, raises.

:data:`COUNTS` counts the exchanges, their rows and bytes, the pooled
reductions and the gathers of this process (forward and backward), for the
tests and ``chip_smoke.py``; :func:`reset_counts` zeroes it.

As in JAX, the use is inputs that do not fit one card: on 32x32 CIFAR the
halos and the pooled moments take about what the cut saves.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from pytorch_cifar_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    collective_device,
    rank,
    world_size,
)

SPATIAL_AXIS = "spatial"
SPATIAL_W_AXIS = "spatial_w"

# the models whose every layer takes the spatial paths: every registry
# name, and the classes they build
HELD_MODELS = (
    "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152", "LeNet",
    "GoogLeNet", "SimpleDLA", "DLA", "VGG11", "VGG13", "VGG16", "VGG19",
    "PreActResNet18", "PreActResNet34", "PreActResNet50", "PreActResNet101",
    "PreActResNet152", "ResNeXt29_2x64d", "ResNeXt29_4x64d",
    "ResNeXt29_8x64d", "ResNeXt29_32x4d", "RegNetX_200MF", "RegNetX_400MF",
    "RegNetY_400MF", "SENet18", "DenseNet121", "DenseNet161", "DenseNet169",
    "DenseNet201", "DenseNetCifar", "DPN26", "DPN92", "MobileNet",
    "MobileNetV2", "ShuffleNetG2", "ShuffleNetG3", "ShuffleNetV2_0.5",
    "ShuffleNetV2_1", "ShuffleNetV2_1.5", "ShuffleNetV2_2", "PNASNetA",
    "PNASNetB", "EfficientNetB0",
)
_HELD_CLASSES = (
    "ResNet", "LeNet", "GoogLeNet", "SimpleDLA", "DLA", "VGG",
    "PreActResNet", "ResNeXt", "RegNet", "SENet", "DenseNet", "DPN",
    "MobileNet", "MobileNetV2", "ShuffleNet", "ShuffleNetV2", "PNASNet",
    "EfficientNet",
)


def check_model(model) -> None:
    """Raise ``NotImplementedError`` naming the model (a registry name or
    an ``nn.Module``) unless it is held under spatial partitioning."""
    name = model if isinstance(model, str) else type(model).__name__
    if name not in (HELD_MODELS if isinstance(model, str)
                    else _HELD_CLASSES):
        raise NotImplementedError(
            f"spatial partitioning of {name} is not ported yet; it holds "
            f"{', '.join(HELD_MODELS)}"
        )


# -- the mesh -------------------------------------------------------------


@dataclass(frozen=True)
class SpatialMesh:
    """``data x spatial x spatial_w`` ranks, row-major (JAX's device
    order): rank ``(d * spatial + s) * spatial_w + w``."""

    data: int
    spatial: int
    spatial_w: int = 1

    @property
    def size(self) -> int:
        return self.data * self.spatial * self.spatial_w

    @property
    def shape(self) -> Dict[str, int]:
        """The axes and their sizes, as JAX's ``mesh.shape`` (the width
        axis only when it is cut)."""
        out = {DATA_AXIS: self.data, SPATIAL_AXIS: self.spatial}
        if self.spatial_w > 1:
            out[SPATIAL_W_AXIS] = self.spatial_w
        return out

    def coords(self, r: int) -> Tuple[int, int, int]:
        if not 0 <= r < self.size:
            raise ValueError(f"rank {r} is outside the {self.data}x"
                             f"{self.spatial}x{self.spatial_w} mesh")
        d, rest = divmod(r, self.spatial * self.spatial_w)
        s, w = divmod(rest, self.spatial_w)
        return d, s, w

    def rank_of(self, d: int, s: int, w: int) -> int:
        return (d * self.spatial + s) * self.spatial_w + w


def make_spatial_mesh(data: int = 0, spatial: int = 1, spatial_w: int = 1,
                      world: Optional[int] = None) -> SpatialMesh:
    """The ``(data x spatial [x spatial_w])`` mesh over ``world`` ranks
    (the process group's when None); ``data=0`` means ``world / (spatial
    * spatial_w)``. JAX's ``ValueError`` when the spatial product does not
    divide the world or the mesh exceeds it."""
    n = world_size() if world is None else world
    sp = spatial * spatial_w
    if spatial < 1 or spatial_w < 1 or n % sp:
        raise ValueError(
            f"spatial={spatial} x spatial_w={spatial_w} must divide "
            f"device count {n}"
        )
    if not data:
        data = n // sp
    if data * sp > n:
        raise ValueError(
            f"{data}x{spatial}x{spatial_w} mesh exceeds {n} devices"
        )
    return SpatialMesh(data, spatial, spatial_w)


# -- the row rule ---------------------------------------------------------


def shard_range(extent: int, shard: int, n_shards: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of an ``extent`` that shard ``shard`` of
    ``n_shards`` owns: ``ceil(extent / n_shards)`` a shard, the last ones
    short or empty (GSPMD's rule)."""
    per = -(-extent // n_shards)
    lo = min(shard * per, extent)
    return lo, min(lo + per, extent)


class Rows(NamedTuple):
    """One rank's part of a window op (kernel ``k``, ``stride``,
    ``padding`` on both sides) along one dimension: the output rows it
    owns (``out``, of ``out_extent``), the input rows it owns (``own``, of
    ``extent``), and the input rows its outputs read (``need``: may start
    below 0 or end past ``extent``, where the op's padding lies; empty
    when ``out`` is)."""

    out: Tuple[int, int]
    own: Tuple[int, int]
    need: Tuple[int, int]
    extent: int
    out_extent: int
    k: int
    stride: int
    padding: int


def rows_needed(k: int, stride: int, padding: int, extent: int, shard: int,
                n_shards: int) -> Rows:
    """The rows shard ``shard`` of ``n_shards`` owns and reads for a window
    of ``k`` at ``stride`` with ``padding`` on both sides, over an input of
    ``extent`` rows (pure: no process group)."""
    out_extent = (extent + 2 * padding - k) // stride + 1
    o_lo, o_hi = shard_range(out_extent, shard, n_shards)
    if o_lo < o_hi:
        need = (o_lo * stride - padding, (o_hi - 1) * stride - padding + k)
    else:
        need = (0, 0)
    return Rows((o_lo, o_hi), shard_range(extent, shard, n_shards), need,
                extent, out_extent, k, stride, padding)


@functools.lru_cache(maxsize=None)
def exchange_plan(k: int, stride: int, padding: int, extent: int,
                  n_shards: int) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """``plan[i][j]``: the global input rows shard ``i`` sends shard ``j``
    of the op (its own rows that ``j``'s outputs read), an empty range for
    none and on the diagonal."""
    rows = [rows_needed(k, stride, padding, extent, j, n_shards)
            for j in range(n_shards)]
    plan = []
    for i in range(n_shards):
        lo_i, hi_i = rows[i].own
        line = []
        for j in range(n_shards):
            a, b = rows[j].need
            lo, hi = max(lo_i, a, 0), min(hi_i, b, extent)
            line.append((lo, hi) if i != j and lo < hi else (lo_i, lo_i))
        plan.append(tuple(line))
    return tuple(plan)


# -- counters ---------------------------------------------------------------

COUNTS: Dict[str, int] = {}
_COUNT_KEYS = (
    "halo_exchanges_h", "halo_exchanges_w", "halo_exchanges_bwd",
    "halo_sends", "halo_rows", "halo_bytes", "halo_max_rows",
    "halo_over_reach", "group_sums", "bn_reductions", "gathers",
    "gather_bytes",
)
_count_lock = threading.Lock()


def reset_counts() -> None:
    """Every counter of :data:`COUNTS` to 0."""
    with _count_lock:
        COUNTS.clear()
        COUNTS.update({k: 0 for k in _COUNT_KEYS})


reset_counts()


def _count(**inc) -> None:
    with _count_lock:
        for k, v in inc.items():
            if k == "halo_max_rows":
                COUNTS[k] = max(COUNTS[k], v)
            else:
                COUNTS[k] += v


# -- the partition: groups and neighbours ------------------------------------


class SpatialPartition:
    """This rank's place in a spatial mesh over the default process group:
    its coordinate, its spatial group (the ranks of its data index, made
    here: every rank calls this in the same order) and its height and
    width lines (global ranks). ``image_hw`` is the models' input
    extent."""

    def __init__(self, mesh: SpatialMesh,
                 image_hw: Tuple[int, int] = (32, 32)):
        if mesh.size != world_size():
            raise ValueError(f"a {mesh.data}x{mesh.spatial}x{mesh.spatial_w} "
                             f"mesh needs {mesh.size} ranks, the process "
                             f"group has {world_size()}")
        self.mesh = mesh
        self.rank = rank()
        self.d, self.s, self.w = mesh.coords(self.rank)
        self.image_hw = tuple(image_hw)
        self.group = None
        for d in range(mesh.data):
            members = [mesh.rank_of(d, s, w) for s in range(mesh.spatial)
                       for w in range(mesh.spatial_w)]
            g = dist.new_group(members)
            if d == self.d:
                self.group = g
        # one collective of every rank on the default group before its first
        # point-to-point exchange, which some ranks may sit out (NCCL makes
        # the group's communicator in its first call, all ranks taking part)
        dist.all_reduce(torch.zeros(1, device=collective_device()))
        self.h_line = [mesh.rank_of(self.d, s, self.w)
                       for s in range(mesh.spatial)]
        self.w_line = [mesh.rank_of(self.d, self.s, w)
                       for w in range(mesh.spatial_w)]
        # the pooled metrics count each image once: only the spatial
        # group's first rank contributes
        self.counts_metrics = self.s == 0 and self.w == 0

    def box(self, h: int, w: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """This rank's rows and columns of an ``h x w`` map."""
        return (shard_range(h, self.s, self.mesh.spatial),
                shard_range(w, self.w, self.mesh.spatial_w))

    def cut(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slab of an NHWC batch of whole images (the image
        extents): rows and columns sliced. A batch already cut (fewer
        rows or columns than the image) is returned as it is."""
        (h0, h1), (w0, w1) = self.box(*self.image_hw)
        if x.shape[1] == self.image_hw[0]:
            x = x[:, h0:h1]
        if x.shape[2] == self.image_hw[1]:
            x = x[:, :, w0:w1]
        return x


@dataclass(frozen=True)
class SpatialSharding:
    """The counterpart of JAX's ``spatial_batch_sharding`` (images: batch
    over ``data``, height over ``spatial``, width over ``spatial_w``) and
    ``spatial_label_sharding`` (labels: batch over ``data``): the epoch
    programs gather the rows of data index :attr:`shard` of
    :attr:`n_shards`, images and labels alike, and the spatial step cuts
    the images' slab."""

    part: SpatialPartition

    @property
    def shard(self) -> int:
        return self.part.d

    @property
    def n_shards(self) -> int:
        return self.part.mesh.data


def spatial_batch_sharding(part: SpatialPartition) -> SpatialSharding:
    return SpatialSharding(part)


def spatial_label_sharding(part: SpatialPartition) -> SpatialSharding:
    return SpatialSharding(part)


# -- the context -------------------------------------------------------------


# the attribute that carries a slab's global (H, W)
_EXTENT = "_spatial_extent"


def _marked(t) -> Optional[Tuple[int, int]]:
    return t.__dict__.get(_EXTENT) if isinstance(t, torch.Tensor) else None


def mark(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Mark NCHW slab ``x`` with its map's global ``(H, W)``; returns
    ``x``."""
    setattr(x, _EXTENT, (int(hw[0]), int(hw[1])))
    return x


def mark_input(x: torch.Tensor) -> torch.Tensor:
    """Mark the model's NCHW input, this rank's slab of the images, with
    the image's extent under the active partition (else return ``x`` as
    it is). The step calls it inside the forward, where a ``remat``
    recompute calls it again."""
    act = _ACTIVE.get()
    return x if act is None else mark(x, act.part.image_hw)


class _CarryExtent(TorchFunctionMode):
    """Within a partition, each 4-d output of an op (its result, or the
    tensors of a tuple it returns: a split) that has no mark takes the
    mark of the op's first marked input with the same local height and
    width (top-level arguments and the tensors of a list argument)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (list, tuple)) else (out,)):
            if (isinstance(o, torch.Tensor) and o.dim() == 4
                    and _EXTENT not in o.__dict__):
                e = _source_extent(o.shape[2:], args)
                if e is not None:
                    setattr(o, _EXTENT, e)
        return out


def _source_extent(hw, args) -> Optional[Tuple[int, int]]:
    for a in args:
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            e = _marked(t)
            if e is not None and t.dim() == 4 and t.shape[2:] == hw:
                return e
    return None


@dataclass
class _Active:
    part: SpatialPartition

    def extent_of(self, x: torch.Tensor) -> Tuple[int, int]:
        """The global ``(H, W)`` of NCHW slab ``x``: its mark, checked
        against the box it cuts to on this rank."""
        hw = _marked(x)
        if hw is None:
            raise RuntimeError(
                f"spatial partitioning: a {tuple(x.shape)} slab carries no "
                "global extent (no window op or marked input made it)")
        (h0, h1), (w0, w1) = self.part.box(*hw)
        if (h1 - h0, w1 - w0) != tuple(x.shape[2:]):
            raise RuntimeError(
                f"spatial partitioning: a {tuple(x.shape)} slab is marked "
                f"{hw}, which cuts to {h1 - h0}x{w1 - w0} on rank "
                f"{self.part.rank}")
        return hw


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "spatial_partition", default=None
)


@contextlib.contextmanager
def spatial_partition(part: Optional[SpatialPartition]):
    """Within the block the layers of ``models.common`` run on this
    rank's slab of ``part`` (None: off), and slabs carry their extents
    (:class:`_CarryExtent`). The train step enters it inside its forward
    (as ``sync_batchnorm``), where ``--remat``'s recompute, on autograd's
    thread, enters it again."""
    if part is None:
        token = _ACTIVE.set(None)
        try:
            yield
        finally:
            _ACTIVE.reset(token)
        return
    token = _ACTIVE.set(_Active(part))
    try:
        with _CarryExtent():
            yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[_Active]:
    """The partition the current forward runs under, or None."""
    return _ACTIVE.get()


# -- point-to-point exchange ------------------------------------------------


def _exchange(sends: List[Tuple[int, torch.Tensor]],
              recvs: List[Tuple[int, torch.Tensor]]) -> None:
    """Post every send and receive (global peers) and wait for them. Under
    NCCL the tensors go card to card; gloo takes no CUDA tensor in
    point-to-point, so CUDA rows go through the host there."""
    if not sends and not recvs:
        return
    staged = dist.get_backend() != "nccl" and any(
        t.is_cuda for _, t in sends + recvs)
    if staged:
        send_t = [(p, t.cpu()) for p, t in sends]
        recv_t = [(p, torch.empty(t.shape, dtype=t.dtype)) for p, t in recvs]
    else:
        send_t, recv_t = sends, recvs
    ops = [dist.P2POp(dist.isend, t, p) for p, t in send_t]
    ops += [dist.P2POp(dist.irecv, t, p) for p, t in recv_t]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        for (_, dst), (_, src) in zip(recvs, recv_t):
            dst.copy_(src)


def _trade(t: torch.Tensor, t_lo: int, give, take, line: List[int],
           dim: int, reach: Optional[int]) -> list:
    """Send each rank ``line[j]`` the global rows ``give[j]`` of ``t``
    (whose first row along ``dim`` is global row ``t_lo``) and receive the
    rows ``take[j]`` from it; returns ``[(first global row, rows)]`` of
    what came in. Counted in :data:`COUNTS` (a forward when ``reach`` is
    given: the most rows one send of the op should carry)."""
    sends, recvs = [], []
    for peer, (g_lo, g_hi), (k_lo, k_hi) in zip(line, give, take):
        if g_lo < g_hi:
            sends.append((peer, t.narrow(dim, g_lo - t_lo,
                                         g_hi - g_lo).contiguous()))
        if k_lo < k_hi:
            shape = list(t.shape)
            shape[dim] = k_hi - k_lo
            recvs.append((peer, t.new_empty(shape), k_lo))
    _exchange(sends, [(p, r) for p, r, _ in recvs])
    if sends or recvs:
        rows = [r.shape[dim] for _, r in sends]
        inc = {"halo_sends": len(sends), "halo_rows": sum(rows),
               "halo_bytes": sum(r.numel() * r.element_size()
                                 for _, r in sends),
               "halo_max_rows": max(rows, default=0)}
        if reach is None:
            inc["halo_exchanges_bwd"] = 1
        else:
            inc["halo_exchanges_h" if dim == 2 else "halo_exchanges_w"] = 1
            inc["halo_over_reach"] = sum(r > reach for r in rows)
        _count(**inc)
    return [(k_lo, r) for _, r, k_lo in recvs]


class _HaloExtend(torch.autograd.Function):
    """``x`` (this rank's rows ``rows.own`` along ``dim``) extended to the
    rows ``rows.need``: rows other ranks of ``line`` own are fetched from
    them, rows outside ``[0, extent)`` are ``pad_value``. The backward is
    the transpose: each fetched row's gradient goes back to its owner,
    which adds it to its own."""

    @staticmethod
    def forward(ctx, x, dim, rows, line, index, pad_value):
        (lo, hi), (a, b) = rows.own, rows.need
        plan = exchange_plan(rows.k, rows.stride, rows.padding, rows.extent,
                             len(line))
        ctx.dim, ctx.rows, ctx.line, ctx.index, ctx.plan = (
            dim, rows, line, index, plan)
        shape = list(x.shape)
        shape[dim] = b - a
        # channels_last, the models' layout and the NHWC kernels' input
        out = torch.empty(shape, dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
        pad_lo, pad_hi = max(0, -a), max(0, b - rows.extent)
        if pad_lo:
            out.narrow(dim, 0, pad_lo).fill_(pad_value)
        if pad_hi:
            out.narrow(dim, b - a - pad_hi, pad_hi).fill_(pad_value)
        mine_lo, mine_hi = max(lo, a), min(hi, b)
        if mine_lo < mine_hi:
            out.narrow(dim, mine_lo - a, mine_hi - mine_lo).copy_(
                x.narrow(dim, mine_lo - lo, mine_hi - mine_lo))
        got = _trade(x, lo, plan[index], [p[index] for p in plan], line,
                     dim, max(rows.k - 1, 1))
        for at, t in got:
            out.narrow(dim, at - a, t.shape[dim]).copy_(t)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dim, rows, plan, index = ctx.dim, ctx.rows, ctx.plan, ctx.index
        (lo, hi), (a, b) = rows.own, rows.need
        shape = list(g.shape)
        shape[dim] = hi - lo
        gx = g.new_zeros(shape)
        mine_lo, mine_hi = max(lo, a), min(hi, b)
        if mine_lo < mine_hi:
            gx.narrow(dim, mine_lo - lo, mine_hi - mine_lo).copy_(
                g.narrow(dim, mine_lo - a, mine_hi - mine_lo))
        # what this rank received goes back to its sender; what it sent
        # comes back and is added to the rows it came from
        got = _trade(g, a, [p[index] for p in plan], plan[index], ctx.line,
                     dim, None)
        for at, t in got:
            gx.narrow(dim, at - lo, t.shape[dim]).add_(t)
        return gx, None, None, None, None, None


def halo_extend(x: torch.Tensor, dim: int, rows: Rows, line: List[int],
                index: int, pad_value: float = 0.0) -> torch.Tensor:
    """``x`` (NCHW, this rank's rows ``rows.own`` of dimension ``dim``)
    extended to the rows ``rows.need`` over the ranks of ``line`` (global
    ranks; ``index`` is this rank's place in it); rows outside the image
    are ``pad_value``. Every rank of the line calls it for the same op, in
    the same order. Differentiable (see :class:`_HaloExtend`)."""
    return _HaloExtend.apply(x, dim, rows, line, index, pad_value)


def _connected_empty(shape, dtype, *tensors) -> torch.Tensor:
    """Zeros of ``shape`` (an output this rank owns no row of) that hang
    off ``tensors`` in the autograd graph, so the backward still reaches
    this rank's exchanges and reductions."""
    out = torch.zeros(shape, dtype=dtype, device=tensors[0].device)
    for t in tensors:
        if t is not None and t.requires_grad:
            out = out + (t.sum() * 0).to(dtype)
    return out.contiguous(memory_format=torch.channels_last)


def _lines(part: SpatialPartition):
    """(dim, shards, this rank's index, line) of each cut dimension."""
    m = part.mesh
    out = []
    if m.spatial > 1:
        out.append((2, m.spatial, part.s, part.h_line))
    if m.spatial_w > 1:
        out.append((3, m.spatial_w, part.w, part.w_line))
    return out


def _local(rows: Rows, n_shards: int, index: int) -> bool:
    """Whether this rank's outputs read only rows it owns and no other
    rank reads one of its rows (a 1x1 conv, a strided one on an even
    split): then a slice of its slab is the op's input, with no exchange
    and no copy."""
    plan = exchange_plan(rows.k, rows.stride, rows.padding, rows.extent,
                         n_shards)
    (a, b), (lo, hi) = rows.need, rows.own
    moves = any(plan[index][j][0] < plan[index][j][1]
                or plan[j][index][0] < plan[j][index][1]
                for j in range(n_shards))
    return not moves and lo <= a < b <= hi


def window_op(x: torch.Tensor, k: Tuple[int, int], stride: Tuple[int, int],
              padding: Tuple[int, int], fn: Callable, out_channels: int,
              pad_value: float = 0.0, params=()) -> torch.Tensor:
    """A window op on this rank's slab of NCHW ``x``: each cut dimension
    extended to the rows this rank's outputs read, then ``fn(x_ext,
    (pad_h, pad_w))`` with no padding along a cut dimension (it lies in
    the extension, as ``pad_value``). ``params`` (the op's weights) stay
    in the graph of an output this rank owns no row of."""
    act = _ACTIVE.get()
    part = act.part
    extent = act.extent_of(x)
    pads = list(padding)
    out_hw = [(extent[i] + 2 * padding[i] - k[i]) // stride[i] + 1
              for i in range(2)]
    out_shape = [x.shape[0], out_channels, *out_hw]
    for dim, n, index, line in _lines(part):
        i = dim - 2
        rows = rows_needed(k[i], stride[i], padding[i], extent[i], index, n)
        if _local(rows, n, index):
            x = x.narrow(dim, rows.need[0] - rows.own[0],
                         rows.need[1] - rows.need[0])
        else:
            x = halo_extend(x, dim, rows, line, index, pad_value)
        pads[i] = 0
        out_shape[dim] = rows.out[1] - rows.out[0]
    if 0 in out_shape[2:]:
        y = _connected_empty(out_shape, x.dtype, x, *params)
    else:
        y = fn(x, tuple(pads))
    return mark(y, out_hw)


def same_op(x: torch.Tensor, k: int, fn: Callable, out_channels: int,
            pad_value: float = 0.0, params=()) -> torch.Tensor:
    """A stride-1 ``k x k`` op that applies its own SAME padding (a
    kernel: K3, K4) on this rank's slab: each cut dimension extended
    by ``k // 2`` rows a side (``pad_value`` outside the image), ``fn``
    run on the extended slab, and the rows its own padding touched cropped
    off."""
    act = _ACTIVE.get()
    part = act.part
    extent = act.extent_of(x)
    p = k // 2
    crops = []
    out_shape = [x.shape[0], out_channels, *x.shape[2:]]
    for dim, n, index, line in _lines(part):
        rows = rows_needed(k, 1, p, extent[dim - 2], index, n)
        x = halo_extend(x, dim, rows, line, index, pad_value)
        crops.append((dim, rows.out[1] - rows.out[0]))
    if 0 in out_shape[2:]:
        y = _connected_empty(out_shape, x.dtype, x, *params)
    else:
        y = fn(x.contiguous(memory_format=torch.channels_last))
        for dim, n in crops:
            y = y.narrow(dim, p, n)
    return mark(y, extent)


def group_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over this rank's spatial group (a partial sum of a
    map made whole); its backward sums the gradient over the group, the
    transpose."""
    part = _ACTIVE.get().part
    _count(group_sums=1)
    return dist_fn.all_reduce(x, group=part.group)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of NCHW ``x`` over its whole map, ``(n, c)`` in ``x``'s
    dtype, on every rank of the spatial group: the slab's sum in fp32 at
    least (an average pool accumulates in fp32 too), summed over the
    group."""
    h, w = _ACTIVE.get().extent_of(x)
    acc = x.to(torch.promote_types(x.dtype, torch.float32))
    return (group_sum(acc.sum(dim=(2, 3))) / (h * w)).to(x.dtype)


def covers_map(x: torch.Tensor, window: int, padding: int) -> bool:
    """Whether a ``window`` pool with ``padding`` covers all of ``x``'s
    map (one output, a reduction over the spatial group)."""
    h, w = _ACTIVE.get().extent_of(x)
    return padding == 0 and window == h == w


def gather_slabs(x: torch.Tensor) -> torch.Tensor:
    """The whole map of NCHW ``x`` on every rank of its spatial group (for
    a flatten that reads all of it), or ``x`` itself outside a partition.
    Each slab is placed in zeros at its box and the group sums them; the
    backward sums the gradient over the group and keeps this rank's box
    (the transpose of the gather)."""
    act = _ACTIVE.get()
    if act is None:
        return x
    h, w = act.extent_of(x)
    (h0, h1), (w0, w1) = act.part.box(h, w)
    full = F.pad(x, (w0, w - w1, h0, h - h1))
    _count(gathers=1, gather_bytes=full.numel() * full.element_size())
    return dist_fn.all_reduce(full, group=act.part.group)


def pool_moments(x: torch.Tensor, moments):
    """BN's ``(E[x], E[x^2])`` over the global batch from this slab's
    ``moments`` (its own ``(mean, sq)``; None for a slab of no element):
    each weighted by the slab's element count and summed over every rank
    in one all-reduce (its backward again a sum), divided by the global
    count. Returns them with the global count (every data shard holds
    ``x.shape[0]`` images)."""
    act = _ACTIVE.get()
    h, w = act.extent_of(x)
    n_local = x.shape[0] * x.shape[2] * x.shape[3]
    n_total = x.shape[0] * act.part.mesh.data * h * w
    if n_local == 0:
        # no mean to weight: the sums are zeros, kept in the graph
        s1 = s2 = x.to(torch.promote_types(x.dtype, torch.float32)).sum(
            dim=(0, 2, 3))
    else:
        s1, s2 = (m * n_local for m in moments)
    _count(bn_reductions=1)
    both = dist_fn.all_reduce(torch.cat([s1, s2])) / n_total
    c = x.shape[1]
    return both[:c], both[c:], n_total
