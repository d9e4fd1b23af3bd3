"""The correspondence between the JAX package's trees and the port's
``state_dict``, used both ways, and the checkpoint payload's train tree.

The JAX trees arrive as nested dicts of numpy arrays (no JAX needed here).
Each model's correspondence is one table (:func:`correspondence`): for
each JAX leaf, its collection (``params`` or ``batch_stats``), its path,
the port key and the transform between them (:data:`CONV`, the HWIO <->
OIHW transpose; :data:`DENSE`, the ``(in, out)`` <-> ``(out, in)``
transpose; a :data:`LINEAR_FLATTEN` permutation; or :data:`IDENTITY`).
:func:`state_dict_from_jax` reads it one way, :func:`jax_trees_from_state_dict`
the other, and :func:`train_tree_from_state` / :func:`load_train_tree` build
and read the whole checkpoint payload (params, BN stats, the optimizer's
momentum through the params' table, the step). Paths, in the JAX ResNet's
forward order:

- ``Conv_0/Conv_0/kernel`` (HWIO) -> ``conv1.weight`` (OIHW);
- ``BatchNorm_0/{scale,bias}`` and ``batch_stats`` ``{mean,var}`` ->
  ``bn1.{weight,bias,running_mean,running_var}``;
- ``BasicBlock_k`` (numbered across all stages in forward order):
  ``Conv_0/BatchNorm_0`` -> ``conv1/bn1``, ``Conv_1/BatchNorm_1`` ->
  ``conv2/bn2``, ``Conv_2/BatchNorm_2`` -> ``shortcut.0/.1``;
- ``Bottleneck_k``: ``Conv_0..2`` -> ``conv1..3``, ``Conv_3/BatchNorm_3``
  -> the shortcut;
- ``Dense_0/Dense_0/kernel`` transposed -> ``linear.weight``.

The JAX LeNet: ``Conv_0``/``Conv_1`` -> ``conv1``/``conv2`` (with bias),
``Dense_0..2`` -> ``fc1..fc3``. ``fc1`` takes a flattened feature map, whose
order is NHWC in the JAX model and NCHW in the reference, so its columns
are permuted by :data:`LINEAR_FLATTEN` (the port's copy of the JAX
``compat.LINEAR_FLATTEN``).

The JAX GoogLeNet: ``Conv_0``/``BatchNorm_0`` -> ``pre_layers.0/.1``;
``Inception_{0..8}`` -> the cells ``a3`` .. ``b5`` in forward order, each
with ``Conv_{0..6}``/``BatchNorm_{0..6}`` in the stock call order (y1; y2:
1, 2; y3: 3, 4, 5; y4: 6, the same in both merged modes) -> ``b1.0/.1``,
``b2.0/.1``, ``b2.3/.4``, ``b3.0/.1``, ``b3.3/.4``, ``b3.6/.7``,
``b4.1/.2``; every conv with its bias. The JAX MobileNet:
``Conv_0``/``BatchNorm_0`` -> ``conv1``/``bn1``;
``DepthwiseSeparable_{0..12}`` ``Conv_{0,1}``/``BatchNorm_{0,1}`` ->
``layers.{i}.conv{1,2}``/``bn{1,2}``, the depthwise kernels ``(3, 3, 1, C)``
-> ``(C, 1, 3, 3)`` by the same HWIO -> OIHW transpose. Both heads pool to
1x1 maps, so their linears need no :data:`LINEAR_FLATTEN` entry.

The JAX SimpleDLA: ``Conv_{0..2}``/``BatchNorm_{0..2}`` -> the stems
``base``, ``layer1``, ``layer2`` (``.0``/``.1``); ``Tree_{0..3}`` ->
``layer3`` .. ``layer6``. A level-1 tree holds ``BasicBlock_{0,1}`` (the
ResNet block's sites) -> ``left_tree``/``right_tree``, a level-2 tree
``Tree_{0,1}`` -> the same; each tree's ``Root_0`` ``Conv_0``/``BatchNorm_0``
-> ``root.conv``/``root.bn``. Its 4x4 pool leaves a 1x1 map, so its linear
needs no :data:`LINEAR_FLATTEN` entry either. The paper's DLA has the same
stems; its level-1 trees hold ``BasicBlock_{0,1}`` -> ``left_node``/
``right_node``, its level-2 trees ``BasicBlock_0`` -> ``prev_root``,
``Tree_0`` -> ``level_1``, ``BasicBlock_{1,2}`` -> ``left_node``/
``right_node``, and every tree ``Root_0`` -> ``root``.

The other depthwise families, each numbered in the JAX model's call order:
MobileNetV2 ``Conv_0``/``BatchNorm_0`` -> ``conv1``/``bn1``,
``InvertedResidual_k`` ``Conv_{0..2}`` -> ``layers.k.conv{1..3}`` and
``Conv_3`` -> ``layers.k.shortcut.0`` (each with its ``BatchNorm_j``), the
head's ``Conv_1`` -> ``conv2``; ShuffleNetV2 ``DownBlock_{0..2}``
``Conv_{0..4}`` -> the stage's ``layer{s}.0.conv{1..5}``,
``BasicBlock_k`` ``Conv_{0..2}`` -> the k-th basic block's
``conv{1..3}``, the head's ``Conv_1`` -> ``conv2``; PNASNet ``CellA_k`` /
``CellB_k`` (the 20 cells in order) ``SepConv_j`` ``Conv_0``/
``BatchNorm_0`` -> ``sep_conv{j+1}.conv1``/``bn1``, a stride-2 cell's
``Conv_0`` -> ``conv1`` (the pool's 1x1) and a CellB's last ``Conv_j`` ->
``conv2`` (the reduce); EfficientNet ``MBConv_k`` ``Conv_{0..2}`` ->
``layers.k.conv{1..3}`` (``Conv_0``/``BatchNorm_0`` also at expand ratio
1, where both are dead) and ``SE_0`` ``Conv_{0,1}`` (with bias, no BN) ->
``layers.k.se.se{1,2}``. Every one of them pools to a 1x1 map before its
linear: no :data:`LINEAR_FLATTEN` entry.

``num_batches_tracked`` is zero (torch reads it only under
``momentum=None``). The result equals what the JAX package's
``compat.export_torch_state_dict`` produces with the port model's
``state_dict()`` as its template; for SimpleDLA, with that template's keys
in the JAX model's call order (each tree's root after its children). The
export pairs same-shape modules first-fit in the template's order, so with
the roots first it would hand a root's BN another block's tensors; this
module maps every tree by name.

The train tree is the JAX ``save_checkpoint`` payload:
``{"batch_stats", "opt_state": {"0": {} (add_decayed_weights), "1":
{"trace": <the params' paths>}, "2": {"count"}}, "params", "step"}``, every
map's keys sorted as ``jax.device_get`` leaves them, ``count`` and
``step`` int32 0-d arrays. The momentum buffers go through the params'
entries of the table. One torch has not made yet (before the first step)
is written as zeros: torch's next update from a zero buffer, ``0.9 * 0 +
g``, is optax's ``trace`` from its zero init. ``num_batches_tracked`` is
dropped on write and set to 0 on read.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.models.densenet import DenseNet
from pytorch_cifar_tpu_torch.models.dla import DLA
from pytorch_cifar_tpu_torch.models.dla_simple import SimpleDLA, Tree
from pytorch_cifar_tpu_torch.models.dpn import DPN
from pytorch_cifar_tpu_torch.models.efficientnet import EfficientNet
from pytorch_cifar_tpu_torch.models.googlenet import CELLS, GoogLeNet
from pytorch_cifar_tpu_torch.models.lenet import LeNet
from pytorch_cifar_tpu_torch.models.mobilenet import MobileNet
from pytorch_cifar_tpu_torch.models.mobilenetv2 import MobileNetV2
from pytorch_cifar_tpu_torch.models.pnasnet import PNASNet
from pytorch_cifar_tpu_torch.models.preact_resnet import (
    PreActBottleneck,
    PreActResNet,
)
from pytorch_cifar_tpu_torch.models.regnet import RegNet
from pytorch_cifar_tpu_torch.models.resnet import BasicBlock
from pytorch_cifar_tpu_torch.models.resnext import ResNeXt
from pytorch_cifar_tpu_torch.models.senet import SENet
from pytorch_cifar_tpu_torch.models.shufflenet import ShuffleNet
from pytorch_cifar_tpu_torch.models.shufflenetv2 import (
    DownBlock,
    ShuffleNetV2,
)
from pytorch_cifar_tpu_torch.models.vgg import VGG

# linears whose input is a flattened feature map: linear index -> (c, h, w)
LINEAR_FLATTEN: Dict[str, Dict[int, Tuple[int, int, int]]] = {
    "LeNet": {0: (16, 5, 5)}
}

IDENTITY = "identity"
CONV = "conv"  # JAX HWIO <-> port OIHW
DENSE = "dense"  # JAX (in, out) <-> port (out, in)
# a linear over a flattened map: DENSE, plus its columns from the JAX
# model's NHWC flatten order to the port's NCHW order
Flatten = Tuple[str, Tuple[int, int, int]]
Transform = Union[str, Flatten]


class Entry(NamedTuple):
    """One leaf of the correspondence."""

    collection: str  # "params" or "batch_stats"
    path: Tuple[str, ...]  # inside the collection's tree
    key: str  # the port's state_dict key
    transform: Transform


def _to_port(arr: np.ndarray, transform: Transform) -> np.ndarray:
    if transform == CONV:
        return np.transpose(arr, (3, 2, 0, 1))
    if transform == DENSE:
        return arr.T
    if transform != IDENTITY:
        c, h, w = transform[1]
        out = arr.T  # (out, in), in in NHWC order
        return (out.reshape(-1, h, w, c).transpose(0, 3, 1, 2)
                .reshape(out.shape[0], -1))
    return arr


def _to_jax(arr: np.ndarray, transform: Transform) -> np.ndarray:
    if transform == CONV:
        return np.transpose(arr, (2, 3, 1, 0))
    if transform == DENSE:
        return arr.T
    if transform != IDENTITY:
        c, h, w = transform[1]
        return (arr.reshape(-1, c, h, w).transpose(0, 2, 3, 1)
                .reshape(arr.shape[0], -1).T)
    return arr


def _conv(model: nn.Module, out: List[Entry], key: str,
          node: Tuple[str, ...]) -> None:
    """A conv (with its bias where the port's has one): the JAX
    ``node/Conv_0`` kernel (and bias)."""
    node = node + ("Conv_0",)
    out.append(Entry("params", node + ("kernel",), f"{key}.weight", CONV))
    if model.get_submodule(key).bias is not None:
        out.append(Entry("params", node + ("bias",), f"{key}.bias",
                         IDENTITY))


def _site(model: nn.Module, out: List[Entry], conv: str, bn: str,
          base: Tuple[str, ...], j: int) -> None:
    """A conv and its BN: the JAX ``Conv_j``/``BatchNorm_j`` under
    ``base``."""
    _conv(model, out, conv, base + (f"Conv_{j}",))
    _bn(out, bn, base + (f"BatchNorm_{j}",))


def _bn(out: List[Entry], bn: str, b: Tuple[str, ...]) -> None:
    """A BN: the JAX ``BatchNorm_j`` node ``b``."""
    out += [
        Entry("params", b + ("scale",), f"{bn}.weight", IDENTITY),
        Entry("params", b + ("bias",), f"{bn}.bias", IDENTITY),
        Entry("batch_stats", b + ("mean",), f"{bn}.running_mean", IDENTITY),
        Entry("batch_stats", b + ("var",), f"{bn}.running_var", IDENTITY),
    ]


def _dense(out: List[Entry], key: str, node: Tuple[str, ...],
           transform: Transform = DENSE) -> None:
    out.append(Entry("params", node + ("kernel",), f"{key}.weight",
                     transform))
    out.append(Entry("params", node + ("bias",), f"{key}.bias", IDENTITY))


def _lenet(model: LeNet, out: List[Entry]) -> None:
    for i in range(2):
        _conv(model, out, f"conv{i + 1}", (f"Conv_{i}",))
    flatten = LINEAR_FLATTEN["LeNet"]
    for i in range(3):
        _dense(out, f"fc{i + 1}", (f"Dense_{i}", "Dense_0"),
               ("flatten", flatten[i]) if i in flatten else DENSE)


def _googlenet(model: GoogLeNet, out: List[Entry]) -> None:
    _site(model, out, "pre_layers.0", "pre_layers.1", (), 0)
    cells = [cell[0] for cell in CELLS if cell is not None]
    sites = ("b1.0", "b2.0", "b2.3", "b3.0", "b3.3", "b3.6", "b4.1")
    for k, cell in enumerate(cells):
        for j, site in enumerate(sites):
            branch, i = site.split(".")
            _site(model, out, f"{cell}.{site}",
                  f"{cell}.{branch}.{int(i) + 1}", (f"Inception_{k}",), j)


def _mobilenet(model: MobileNet, out: List[Entry]) -> None:
    _site(model, out, "conv1", "bn1", (), 0)
    for k in range(len(model.layers)):
        for j in range(2):
            _site(model, out, f"layers.{k}.conv{j + 1}",
                  f"layers.{k}.bn{j + 1}", (f"DepthwiseSeparable_{k}",), j)


def _block(model, out, prefix, blk, base, nconv=2) -> None:
    for j in range(nconv):
        _site(model, out, f"{prefix}.conv{j + 1}", f"{prefix}.bn{j + 1}",
              base, j)
    if len(blk.shortcut):
        _site(model, out, f"{prefix}.shortcut.0", f"{prefix}.shortcut.1",
              base, nconv)


def _dla(model: SimpleDLA, out: List[Entry]) -> None:
    """SimpleDLA's stems and trees, by name (the linear is the caller's)."""
    for j, stem in enumerate(("base", "layer1", "layer2")):
        _site(model, out, f"{stem}.0", f"{stem}.1", (), j)

    def tree(prefix, t, base):
        kind = "Tree" if isinstance(t.left_tree, Tree) else "BasicBlock"
        for k, side in enumerate(("left_tree", "right_tree")):
            child, where = getattr(t, side), base + (f"{kind}_{k}",)
            if kind == "Tree":
                tree(f"{prefix}.{side}", child, where)
            else:
                _block(model, out, f"{prefix}.{side}", child, where)
        _site(model, out, f"{prefix}.root.conv", f"{prefix}.root.bn",
              base + ("Root_0",), 0)

    for k, t in enumerate(model.trees()):
        tree(f"layer{k + 3}", t, (f"Tree_{k}",))


def _paper_dla(model: DLA, out: List[Entry]) -> None:
    """The paper DLA's stems and trees, by name."""
    for j, stem in enumerate(("base", "layer1", "layer2")):
        _site(model, out, f"{stem}.0", f"{stem}.1", (), j)

    def tree(prefix, t, base):
        children = ([("prev_root", t.prev_root)] if t.level > 1 else []) \
            + [(f"level_{i}", sub) for i, sub in
               zip(reversed(range(1, t.level)), t.subtrees())] \
            + [("left_node", t.left_node), ("right_node", t.right_node)]
        k = 0
        for name, child in children:
            if name.startswith("level_"):
                tree(f"{prefix}.{name}", child, base + ("Tree_0",))
            else:
                _block(model, out, f"{prefix}.{name}", child,
                       base + (f"BasicBlock_{k}",))
                k += 1
        _site(model, out, f"{prefix}.root.conv", f"{prefix}.root.bn",
              base + ("Root_0",), 0)

    for k, t in enumerate(model.trees()):
        tree(f"layer{k + 3}", t, (f"Tree_{k}",))


def _mobilenetv2(model: MobileNetV2, out: List[Entry]) -> None:
    _site(model, out, "conv1", "bn1", (), 0)
    for k, blk in enumerate(model.layers):
        p, base = f"layers.{k}", (f"InvertedResidual_{k}",)
        for j in range(3):
            _site(model, out, f"{p}.conv{j + 1}", f"{p}.bn{j + 1}", base, j)
        if len(blk.shortcut):
            _site(model, out, f"{p}.shortcut.0", f"{p}.shortcut.1", base, 3)
    _site(model, out, "conv2", "bn2", (), 1)


def _shufflenetv2(model: ShuffleNetV2, out: List[Entry]) -> None:
    _site(model, out, "conv1", "bn1", (), 0)
    counts = {"DownBlock": 0, "BasicBlock": 0}
    for s in range(1, 4):
        for i, blk in enumerate(getattr(model, f"layer{s}")):
            kind = "DownBlock" if isinstance(blk, DownBlock) else "BasicBlock"
            base = (f"{kind}_{counts[kind]}",)
            counts[kind] += 1
            for j in range(5 if kind == "DownBlock" else 3):
                _site(model, out, f"layer{s}.{i}.conv{j + 1}",
                      f"layer{s}.{i}.bn{j + 1}", base, j)
    _site(model, out, "conv2", "bn2", (), 1)


def _pnasnet(model: PNASNet, out: List[Entry]) -> None:
    _site(model, out, "conv1", "bn1", (), 0)
    kind = model.cell_type.__name__
    prefixes = [f"layer1.{i}" for i in range(len(model.layer1))] + [
        "layer2"] + [f"layer3.{i}" for i in range(len(model.layer3))] + [
        "layer4"] + [f"layer5.{i}" for i in range(len(model.layer5))]
    for k, (p, cell) in enumerate(zip(prefixes, model.cells())):
        base = (f"{kind}_{k}",)
        seps = [n for n in ("sep_conv1", "sep_conv2", "sep_conv3")
                if hasattr(cell, n)]
        for j, sep in enumerate(seps):
            _site(model, out, f"{p}.{sep}.conv1", f"{p}.{sep}.bn1",
                  base + (f"SepConv_{j}",), 0)
        j = 0
        for c, b in (("conv1", "bn1"), ("conv2", "bn2")):
            if hasattr(cell, c):
                _site(model, out, f"{p}.{c}", f"{p}.{b}", base, j)
                j += 1


def _efficientnet(model: EfficientNet, out: List[Entry]) -> None:
    _site(model, out, "conv1", "bn1", (), 0)
    for k in range(len(model.layers)):
        p, base = f"layers.{k}", (f"MBConv_{k}",)
        for j in range(3):
            _site(model, out, f"{p}.conv{j + 1}", f"{p}.bn{j + 1}", base, j)
        for j in range(2):
            _conv(model, out, f"{p}.se.se{j + 1}", base + ("SE_0",
                                                          f"Conv_{j}"))


def _resnet(model: nn.Module, out: List[Entry]) -> None:
    _site(model, out, "conv1", "bn1", (), 0)
    blocks = model.blocks()
    kind = "BasicBlock" if isinstance(blocks[0], BasicBlock) else "Bottleneck"
    k = 0
    for li in range(1, 5):
        for bi, block in enumerate(getattr(model, f"layer{li}")):
            _block(model, out, f"layer{li}.{bi}", block, (f"{kind}_{k}",),
                   2 if kind == "BasicBlock" else 3)
            k += 1


def _layers(model: nn.Module, n: int):
    """``(prefix, block)`` of ``layer1`` .. ``layer{n}`` in order."""
    return [(f"layer{i}.{j}", b) for i in range(1, n + 1)
            for j, b in enumerate(getattr(model, f"layer{i}"))]


def _vgg(model: VGG, out: List[Entry]) -> None:
    convs = [i for i, m in enumerate(model.features)
             if isinstance(m, nn.Conv2d)]
    for j, i in enumerate(convs):  # each conv's BN follows it
        _site(model, out, f"features.{i}", f"features.{i + 1}", (), j)


def _preact(model: nn.Module, out: List[Entry]) -> None:
    """PreActResNet and SENet: a block's BNs in order, its convs in the
    JAX call order (the shortcut first, off the pre-activated input; then
    ``conv1``.., then SENet's gate ``fc1``/``fc2``)."""
    if isinstance(model, SENet):
        _site(model, out, "conv1", "bn1", (), 0)
        kind, gate = "SEPreActBlock", ["fc1", "fc2"]
    else:
        _conv(model, out, "conv1", ("Conv_0",))
        kind, gate = type(model.layer1[0]).__name__, []
    n = 3 if isinstance(model.layer1[0], PreActBottleneck) else 2
    for k, (p, blk) in enumerate(_layers(model, 4)):
        base = (f"{kind}_{k}",)
        for j in range(n):
            _bn(out, f"{p}.bn{j + 1}", base + (f"BatchNorm_{j}",))
        convs = (["shortcut.0"] if len(blk.shortcut) else []) + [
            f"conv{j + 1}" for j in range(n)] + gate
        for j, c in enumerate(convs):
            _conv(model, out, f"{p}.{c}", base + (f"Conv_{j}",))


def _bottlenecks(model: nn.Module, out: List[Entry], kind: str,
                 stages: int) -> None:
    """ResNeXt, DPN and ShuffleNet: the stem's conv and BN, then each
    block's ``conv1..3``/``bn1..3`` and a shortcut's conv and BN as the JAX
    ``{kind}_k`` ``Conv_j``/``BatchNorm_j``."""
    _site(model, out, "conv1", "bn1", (), 0)
    for k, (p, blk) in enumerate(_layers(model, stages)):
        base = (f"{kind}_{k}",)
        for j in range(3):
            _site(model, out, f"{p}.conv{j + 1}", f"{p}.bn{j + 1}", base, j)
        if len(getattr(blk, "shortcut", ())):  # ShuffleNet's has none
            _site(model, out, f"{p}.shortcut.0", f"{p}.shortcut.1", base, 3)


def _regnet(model: RegNet, out: List[Entry]) -> None:
    _site(model, out, "conv1", "bn1", (), 0)
    for k, (p, blk) in enumerate(_layers(model, 4)):
        base = (f"RegNetBlock_{k}",)
        for j in range(3):
            _site(model, out, f"{p}.conv{j + 1}", f"{p}.bn{j + 1}", base, j)
        if blk.with_se:
            for j in range(2):
                _conv(model, out, f"{p}.se.se{j + 1}",
                      base + ("SE_0", f"Conv_{j}"))
        if len(blk.shortcut):
            _site(model, out, f"{p}.shortcut.0", f"{p}.shortcut.1", base, 3)


def _densenet(model: DenseNet, out: List[Entry]) -> None:
    _conv(model, out, "conv1", ("Conv_0",))
    k = 0
    for s in range(model.stages):
        for i in range(len(getattr(model, f"dense{s + 1}"))):
            p, base = f"dense{s + 1}.{i}", (f"DenseLayer_{k}",)
            for j in range(2):
                _site(model, out, f"{p}.conv{j + 1}", f"{p}.bn{j + 1}",
                      base, j)
            k += 1
        if s < model.stages - 1:
            _site(model, out, f"trans{s + 1}.conv", f"trans{s + 1}.bn",
                  (f"Transition_{s}",), 0)
    _bn(out, "bn", ("BatchNorm_0",))


def correspondence(model: nn.Module) -> List[Entry]:
    """The port model's table: one entry per JAX leaf, in the port's
    forward order."""
    out: List[Entry] = []
    if isinstance(model, LeNet):
        _lenet(model, out)
        return out
    if isinstance(model, GoogLeNet):
        _googlenet(model, out)
    elif isinstance(model, MobileNet):
        _mobilenet(model, out)
    elif isinstance(model, SimpleDLA):
        _dla(model, out)
    elif isinstance(model, DLA):
        _paper_dla(model, out)
    elif isinstance(model, MobileNetV2):
        _mobilenetv2(model, out)
    elif isinstance(model, ShuffleNetV2):
        _shufflenetv2(model, out)
    elif isinstance(model, PNASNet):
        _pnasnet(model, out)
    elif isinstance(model, EfficientNet):
        _efficientnet(model, out)
    elif isinstance(model, VGG):
        _vgg(model, out)
    elif isinstance(model, (PreActResNet, SENet)):
        _preact(model, out)
    elif isinstance(model, ResNeXt):
        _bottlenecks(model, out, "ResNeXtBlock", 3)
    elif isinstance(model, DPN):
        _bottlenecks(model, out, "DualPathBlock", 4)
    elif isinstance(model, ShuffleNet):
        _bottlenecks(model, out, "ShuffleBottleneck", 3)
    elif isinstance(model, RegNet):
        _regnet(model, out)
    elif isinstance(model, DenseNet):
        _densenet(model, out)
    else:
        _resnet(model, out)
    head = "classifier" if isinstance(model, VGG) else "linear"
    _dense(out, head, ("Dense_0", "Dense_0"))
    return out


def _at(tree: Mapping, path: Tuple[str, ...]):
    node = tree
    for i, k in enumerate(path):
        if not isinstance(node, Mapping) or k not in node:
            raise KeyError(f"JAX tree has no {'/'.join(path[:i + 1])}")
        node = node[k]
    return node


def _leaf_count(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_leaf_count(v) for v in tree.values())
    return 1


def _nested(leaves: Dict[Tuple[str, ...], np.ndarray]) -> dict:
    """Nested dicts of ``leaves`` with every map's keys sorted, the order
    ``jax.device_get`` leaves a JAX state's trees in."""
    root: dict = {}
    for path, v in leaves.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v

    def ordered(node):
        if not isinstance(node, dict):
            return node
        return {k: ordered(node[k]) for k in sorted(node)}

    return ordered(root)


def _model(name: str, model: Optional[nn.Module], num_classes: int = 10):
    return create_model(name, num_classes=num_classes) if model is None \
        else model


def state_dict_from_jax(
    name: str,
    params: Mapping,
    batch_stats: Mapping,
    num_classes: int = 10,
    model: Optional[nn.Module] = None,
) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` for the JAX ``name`` model's trees, as
    numpy arrays in the port's key order. ``model`` is the port model to
    fill (default: a fresh ``create_model(name)``; pass one for an
    unregistered depth such as ``ResNet(BasicBlock, (1, 1, 1, 1))``).
    Raises on any missing, extra or misshapen tensor."""
    model = _model(name, model, num_classes)
    table = correspondence(model)
    trees = {"params": params, "batch_stats": batch_stats}
    out = {e.key: _to_port(np.asarray(_at(trees[e.collection], e.path)),
                           e.transform) for e in table}
    if _leaf_count(params) + _leaf_count(batch_stats) != len(table):
        raise ValueError(f"JAX tree has leaves that {name} does not")
    for key in model.state_dict():
        if key.endswith("num_batches_tracked"):
            out[key] = np.zeros((), np.int64)
    return _checked(name, model.state_dict(), out)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def jax_trees_from_state_dict(
    name: str,
    state_dict: Mapping,
    model: Optional[nn.Module] = None,
    num_classes: int = 10,
) -> Tuple[dict, dict]:
    """``(params, batch_stats)``: the JAX ``name`` model's trees (nested
    dicts of C-contiguous fp32 numpy arrays, keys sorted) for the port's
    ``state_dict``. Raises on a missing or extra key or a misshapen
    tensor; ``num_batches_tracked`` is dropped."""
    model = _model(name, model, num_classes)
    table = correspondence(model)
    template = model.state_dict()
    keys = {k for k in state_dict if not k.endswith("num_batches_tracked")}
    want = {e.key for e in table}
    if keys != want:
        raise ValueError(
            f"key mismatch vs {name}: missing {sorted(want - keys)}, extra "
            f"{sorted(keys - want)}"
        )
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for e in table:
        v = _host(state_dict[e.key])
        if tuple(v.shape) != tuple(template[e.key].shape):
            raise ValueError(f"{e.key}: shape {v.shape}, {name} needs "
                             f"{tuple(template[e.key].shape)}")
        trees[e.collection][e.path] = np.ascontiguousarray(
            _to_jax(v, e.transform), dtype=np.float32)
    return _nested(trees["params"]), _nested(trees["batch_stats"])


def _checked(
    name: str, template: Mapping, out: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """``out`` in the template's key order and dtypes, after checking that
    it has exactly the template's keys and shapes."""
    if set(out) != set(template):
        raise ValueError(
            f"key mismatch vs {name}: missing {sorted(set(template) - set(out))}"
            f", extra {sorted(set(out) - set(template))}"
        )
    result: Dict[str, np.ndarray] = {}
    for key, ref in template.items():
        val = out[key]
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(
                f"{key}: JAX tree gives shape {val.shape}, {name} needs "
                f"{tuple(ref.shape)}"
            )
        dtype = np.int64 if key.endswith("num_batches_tracked") else np.float32
        # astype keeps a 0-d array 0-d (ascontiguousarray makes it 1-d)
        result[key] = val.astype(dtype, order="C", copy=False)
    return result


# -- the checkpoint payload ----------------------------------------------

class StateSnapshot(NamedTuple):
    """A train state's arrays in one fp32 buffer: the state dict's
    (``"sd"``) and the momentum buffers' (``"mom"``) tensors in the port's
    layout (logical NCHW order, whatever their memory format), each at
    ``spans[(kind, key)] = (offset, shape)``; a momentum buffer torch has
    not made yet has no span."""

    table: List[Entry]
    flat: torch.Tensor
    spans: Dict[Tuple[str, str], Tuple[int, Tuple[int, ...]]]
    step: int

    def host(self) -> "StateSnapshot":
        """This snapshot with its buffer on the host: one copy from a
        device, the only wait for it (none on the CPU)."""
        return self._replace(flat=self.flat.cpu())

    def array(self, kind: str, key: str) -> Optional[np.ndarray]:
        if (kind, key) not in self.spans:
            return None
        off, shape = self.spans[(kind, key)]
        n = int(np.prod(shape, dtype=np.int64))
        return self.flat.numpy()[off:off + n].reshape(shape)


def snapshot_state(state) -> StateSnapshot:
    """A copy of ``state``'s params, BN stats and momentum buffers on their
    own device, queued with no host sync (the trainer's best snapshot,
    and the first half of every save)."""
    table = correspondence(state.model)
    live = state.model.state_dict()
    params = dict(state.model.named_parameters())
    spans, parts, off = {}, [], 0
    for kind, key, t in (
        [("sd", e.key, live[e.key]) for e in table]
        + [("mom", e.key, state.optimizer.state.get(params[e.key], {})
            .get("momentum_buffer")) for e in table
           if e.collection == "params"]
    ):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"{key} is {t.dtype}; checkpoints hold fp32")
        spans[(kind, key)] = (off, tuple(t.shape))
        parts.append(t.detach().reshape(-1))
        off += t.numel()
    flat = torch.cat(parts) if parts else torch.zeros(0)
    return StateSnapshot(table, flat, spans, int(state.step))


def train_tree_from_snapshot(snap: StateSnapshot) -> dict:
    """The JAX checkpoint payload tree of a snapshot, copied to the host
    first if it is on a device: numpy views of its buffer, transposed
    lazily (the codec writes them out in C order)."""
    snap = snap.host()
    leaves: Dict[str, Dict[Tuple[str, ...], np.ndarray]] = {
        "params": {}, "batch_stats": {}, "trace": {}}
    for e in snap.table:
        v = _to_jax(snap.array("sd", e.key), e.transform)
        leaves[e.collection][e.path] = v
        if e.collection == "params":
            mom = snap.array("mom", e.key)
            leaves["trace"][e.path] = (
                np.zeros(v.shape, np.float32) if mom is None
                else _to_jax(mom, e.transform))
    step = np.asarray(snap.step, np.int32)
    return {
        "batch_stats": _nested(leaves["batch_stats"]),
        "opt_state": {
            "0": {},  # add_decayed_weights: EmptyState
            "1": {"trace": _nested(leaves["trace"])},
            "2": {"count": step.copy()},
        },
        "params": _nested(leaves["params"]),
        "step": step,
    }


def train_tree_from_state(state) -> dict:
    """The JAX ``save_checkpoint`` payload tree of the port's train state
    (see the module docstring)."""
    return train_tree_from_snapshot(snapshot_state(state))


class TrainArrays(NamedTuple):
    """A payload tree read against a port model: its ``state_dict`` and
    its momentum buffers (by parameter name) as numpy, and the step."""

    state_dict: Dict[str, np.ndarray]
    momentum: Dict[str, np.ndarray]
    step: int


def _int0(tree: Mapping, key: str, what: str) -> int:
    v = tree.get(key) if isinstance(tree, Mapping) else None
    if (not isinstance(v, np.ndarray) or v.shape != ()
            or v.dtype.kind not in "iu"):
        raise ValueError(f"{what} is not an integer 0-d array")
    return int(v)


def train_arrays(model: nn.Module, tree: Mapping,
                 name: str = "the model") -> TrainArrays:
    """Check a payload tree against ``model`` and map it to the port's
    layout, touching no tensor of the model. Raises ValueError (or
    KeyError) on any missing, extra or misshapen leaf, and when
    ``opt_state/2/count`` differs from ``step``."""
    if not isinstance(tree, Mapping) or set(tree) != {
            "batch_stats", "opt_state", "params", "step"}:
        raise ValueError("payload is not a train state tree (params, "
                         "batch_stats, opt_state, step)")
    opt = tree["opt_state"]
    if (not isinstance(opt, Mapping) or set(opt) != {"0", "1", "2"}
            or opt["0"] != {} or not isinstance(opt["1"], Mapping)
            or set(opt["1"]) != {"trace"}):
        raise ValueError("opt_state is not the optimizer chain's "
                         "(add_decayed_weights, trace, scale_by_schedule)")
    step = _int0(tree, "step", "step")
    if _int0(opt["2"], "count", "opt_state/2/count") != step:
        raise ValueError(f"opt_state/2/count {int(opt['2']['count'])} != "
                         f"step {step}")
    sd = state_dict_from_jax(name, tree["params"], tree["batch_stats"],
                             model=model)
    table = correspondence(model)
    trace = opt["1"]["trace"]
    momentum = {e.key: np.ascontiguousarray(
        _to_port(np.asarray(_at(trace, e.path)), e.transform), np.float32)
        for e in table if e.collection == "params"}
    if _leaf_count(trace) != len(momentum):
        raise ValueError(f"momentum tree has leaves that {name} does not")
    for key, v in momentum.items():
        if v.shape != sd[key].shape:
            raise ValueError(f"momentum of {key}: shape {v.shape}, "
                             f"{name} needs {sd[key].shape}")
    return TrainArrays(sd, momentum, step)


def apply_train_arrays(state, arrays: TrainArrays) -> None:
    """Load checked arrays into ``state`` in place, on its device: the
    model's tensors keep their memory format, each momentum buffer takes
    its parameter's (``empty_like``), ``num_batches_tracked`` is 0."""
    params = dict(state.model.named_parameters())
    with torch.no_grad():
        live = state.model.state_dict()
        for key, v in arrays.state_dict.items():
            live[key].copy_(torch.from_numpy(v))
        for key, v in arrays.momentum.items():
            p = params[key]
            state.optimizer.state[p]["momentum_buffer"] = (
                torch.empty_like(p).copy_(torch.from_numpy(v)))
    state.step = arrays.step


def load_train_tree(state, tree: Mapping) -> None:
    """Read a JAX checkpoint payload tree into the port's ``state``."""
    apply_train_arrays(state, train_arrays(state.model, tree))


def normalize_state_dict(obj: Mapping) -> Tuple[Mapping, dict]:
    """Unwrap the reference's ``{'net': sd, 'acc', 'epoch'}`` envelope and
    strip DataParallel's ``module.`` prefixes (the port's copy of the JAX
    ``compat.normalize_state_dict``). Returns ``(state_dict, meta)``."""
    meta: dict = {}
    sd = obj
    if "net" in obj and isinstance(obj["net"], Mapping):
        sd = obj["net"]
        if "acc" in obj:
            meta["acc"] = float(obj["acc"])
        if "epoch" in obj:
            meta["epoch"] = int(obj["epoch"])
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}, meta
