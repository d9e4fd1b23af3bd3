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

``num_batches_tracked`` is zero (torch reads it only under
``momentum=None``). The result equals what the JAX package's
``compat.export_torch_state_dict`` produces with the port model's
``state_dict()`` as its template.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.models.resnet import BasicBlock


def state_dict_from_jax(
    name: str,
    params: Mapping,
    batch_stats: Mapping,
    num_classes: int = 10,
) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` for the JAX ``name`` model's trees, as
    numpy arrays in the port's key order. Raises on any missing, extra or
    misshapen tensor."""
    model = create_model(name, num_classes=num_classes)
    template = model.state_dict()
    out: Dict[str, np.ndarray] = {}

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
