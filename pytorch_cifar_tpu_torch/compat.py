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

``num_batches_tracked`` is zero (torch reads it only under
``momentum=None``). The result equals what the JAX package's
``compat.export_torch_state_dict`` produces with the port model's
``state_dict()`` as its template.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
from torch import nn

from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.models.lenet import LeNet
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

    def put_bn(prefix, p, s):
        out[f"{prefix}.weight"] = np.asarray(p["scale"])
        out[f"{prefix}.bias"] = np.asarray(p["bias"])
        out[f"{prefix}.running_mean"] = np.asarray(s["mean"])
        out[f"{prefix}.running_var"] = np.asarray(s["var"])
        out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)

    put_conv("conv1", params["Conv_0"])
    put_bn("bn1", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    blocks = model.blocks()
    kind = "BasicBlock" if isinstance(blocks[0], BasicBlock) else "Bottleneck"
    nconv = 2 if kind == "BasicBlock" else 3
    k = 0
    for li in range(1, 5):
        for bi, block in enumerate(getattr(model, f"layer{li}")):
            bp, bs = params[f"{kind}_{k}"], batch_stats[f"{kind}_{k}"]
            prefix = f"layer{li}.{bi}"
            for j in range(nconv):
                put_conv(f"{prefix}.conv{j + 1}", bp[f"Conv_{j}"])
                put_bn(f"{prefix}.bn{j + 1}", bp[f"BatchNorm_{j}"],
                       bs[f"BatchNorm_{j}"])
            if len(block.shortcut):
                put_conv(f"{prefix}.shortcut.0", bp[f"Conv_{nconv}"])
                put_bn(f"{prefix}.shortcut.1", bp[f"BatchNorm_{nconv}"],
                       bs[f"BatchNorm_{nconv}"])
            k += 1
    dense = params["Dense_0"]["Dense_0"]
    out["linear.weight"] = np.asarray(dense["kernel"]).T
    out["linear.bias"] = np.asarray(dense["bias"])
    if k != sum(1 for key in params if key.startswith(kind)):
        raise ValueError(f"JAX tree has another number of {kind}s than {name}")
    return _checked(name, template, out)


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
