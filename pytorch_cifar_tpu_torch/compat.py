"""Weights from the JAX package's trees into the port's ``state_dict``.

The JAX ResNet's flax trees arrive as nested dicts of numpy arrays (no JAX
needed here). Paths, in the JAX model's forward order:

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
needs no :data:`LINEAR_FLATTEN` entry either.

``num_batches_tracked`` is zero (torch reads it only under
``momentum=None``). The result equals what the JAX package's
``compat.export_torch_state_dict`` produces with the port model's
``state_dict()`` as its template; for SimpleDLA, with that template's keys
in the JAX model's call order (each tree's root after its children). The
export pairs same-shape modules first-fit in the template's order, so with
the roots first it would hand a root's BN another block's tensors; this
module maps every tree by name.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
from torch import nn

from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.models.dla_simple import SimpleDLA, Tree
from pytorch_cifar_tpu_torch.models.googlenet import CELLS, GoogLeNet
from pytorch_cifar_tpu_torch.models.lenet import LeNet
from pytorch_cifar_tpu_torch.models.mobilenet import MobileNet
from pytorch_cifar_tpu_torch.models.resnet import BasicBlock

# linears whose input is a flattened feature map: linear index -> (c, h, w)
LINEAR_FLATTEN: Dict[str, Dict[int, Tuple[int, int, int]]] = {
    "LeNet": {0: (16, 5, 5)}
}


def _lenet_from_jax(params: Mapping, out: Dict[str, np.ndarray]) -> None:
    for i in range(2):
        node = params[f"Conv_{i}"]["Conv_0"]
        out[f"conv{i + 1}.weight"] = np.transpose(
            np.asarray(node["kernel"]), (3, 2, 0, 1)
        )
        out[f"conv{i + 1}.bias"] = np.asarray(node["bias"])
    flatten = LINEAR_FLATTEN["LeNet"]
    for i in range(3):
        node = params[f"Dense_{i}"]["Dense_0"]
        w = np.asarray(node["kernel"]).T  # (out, in), in in NHWC order
        if i in flatten:
            c, h, wd = flatten[i]
            w = (
                w.reshape(-1, h, wd, c)
                .transpose(0, 3, 1, 2)
                .reshape(w.shape[0], -1)
            )
        out[f"fc{i + 1}.weight"] = w
        out[f"fc{i + 1}.bias"] = np.asarray(node["bias"])


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
    if model is None:
        model = create_model(name, num_classes=num_classes)
    template = model.state_dict()
    out: Dict[str, np.ndarray] = {}
    if isinstance(model, LeNet):
        _lenet_from_jax(params, out)
        return _checked(name, template, out)

    def put_conv(prefix, node):
        out[f"{prefix}.weight"] = np.transpose(
            np.asarray(node["Conv_0"]["kernel"]), (3, 2, 0, 1)
        )
        if "bias" in node["Conv_0"]:
            out[f"{prefix}.bias"] = np.asarray(node["Conv_0"]["bias"])

    def put_bn(prefix, p, s):
        out[f"{prefix}.weight"] = np.asarray(p["scale"])
        out[f"{prefix}.bias"] = np.asarray(p["bias"])
        out[f"{prefix}.running_mean"] = np.asarray(s["mean"])
        out[f"{prefix}.running_var"] = np.asarray(s["var"])
        out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)

    def put_site(conv_prefix, bn_prefix, p, s, j):
        put_conv(conv_prefix, p[f"Conv_{j}"])
        put_bn(bn_prefix, p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"])

    def put_linear():
        dense = params["Dense_0"]["Dense_0"]
        out["linear.weight"] = np.asarray(dense["kernel"]).T
        out["linear.bias"] = np.asarray(dense["bias"])

    if isinstance(model, GoogLeNet):
        put_site("pre_layers.0", "pre_layers.1", params, batch_stats, 0)
        cells = [cell[0] for cell in CELLS if cell is not None]
        sites = ("b1.0", "b2.0", "b2.3", "b3.0", "b3.3", "b3.6", "b4.1")
        for k, cell in enumerate(cells):
            p, st = params[f"Inception_{k}"], batch_stats[f"Inception_{k}"]
            for j, site in enumerate(sites):
                branch, i = site.split(".")
                put_site(f"{cell}.{site}", f"{cell}.{branch}.{int(i) + 1}",
                         p, st, j)
        put_linear()
        return _checked(name, template, out)
    if isinstance(model, MobileNet):
        put_site("conv1", "bn1", params, batch_stats, 0)
        for k in range(len(model.layers)):
            p = params[f"DepthwiseSeparable_{k}"]
            st = batch_stats[f"DepthwiseSeparable_{k}"]
            for j in range(2):
                put_site(f"layers.{k}.conv{j + 1}", f"layers.{k}.bn{j + 1}",
                         p, st, j)
        put_linear()
        return _checked(name, template, out)

    if isinstance(model, SimpleDLA):
        _dla_from_jax(model, params, batch_stats, put_site)
        put_linear()
        got = sum(1 for k in out if not k.endswith("num_batches_tracked"))
        if _leaf_count(params) + _leaf_count(batch_stats) != got:
            raise ValueError(f"JAX tree has leaves that {name} does not")
        return _checked(name, template, out)

    put_site("conv1", "bn1", params, batch_stats, 0)
    blocks = model.blocks()
    kind = "BasicBlock" if isinstance(blocks[0], BasicBlock) else "Bottleneck"
    nconv = 2 if kind == "BasicBlock" else 3
    k = 0
    for li in range(1, 5):
        for bi, block in enumerate(getattr(model, f"layer{li}")):
            bp, bs = params[f"{kind}_{k}"], batch_stats[f"{kind}_{k}"]
            prefix = f"layer{li}.{bi}"
            for j in range(nconv):
                put_site(f"{prefix}.conv{j + 1}", f"{prefix}.bn{j + 1}",
                         bp, bs, j)
            if len(block.shortcut):
                put_site(f"{prefix}.shortcut.0", f"{prefix}.shortcut.1",
                         bp, bs, nconv)
            k += 1
    put_linear()
    if k != sum(1 for key in params if key.startswith(kind)):
        raise ValueError(f"JAX tree has another number of {kind}s than {name}")
    return _checked(name, template, out)


def _leaf_count(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_leaf_count(v) for v in tree.values())
    return 1


def _dla_from_jax(model: SimpleDLA, params: Mapping, stats: Mapping,
                  put_site) -> None:
    """SimpleDLA's stems and trees (the linear is the caller's)."""
    for j, stem in enumerate(("base", "layer1", "layer2")):
        put_site(f"{stem}.0", f"{stem}.1", params, stats, j)

    def block(prefix, blk, p, s):
        for j in range(2):
            put_site(f"{prefix}.conv{j + 1}", f"{prefix}.bn{j + 1}", p, s, j)
        if len(blk.shortcut):
            put_site(f"{prefix}.shortcut.0", f"{prefix}.shortcut.1", p, s, 2)

    def tree(prefix, t, p, s):
        kind = "Tree" if isinstance(t.left_tree, Tree) else "BasicBlock"
        for k, side in enumerate(("left_tree", "right_tree")):
            child = getattr(t, side)
            walk = tree if kind == "Tree" else block
            walk(f"{prefix}.{side}", child, p[f"{kind}_{k}"], s[f"{kind}_{k}"])
        put_site(f"{prefix}.root.conv", f"{prefix}.root.bn", p["Root_0"],
                 s["Root_0"], 0)

    for k, t in enumerate(model.trees()):
        tree(f"layer{k + 3}", t, params[f"Tree_{k}"], stats[f"Tree_{k}"])


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
        result[key] = np.ascontiguousarray(val.astype(dtype, copy=False))
    return result
