"""The int8 lane's folded-tree check, shared by
``tests/test_torch_int8_zoo.py`` and ``test_torch_int8_zoo_rest.py`` (the
44 registry names split in two files, each well inside a minute).

An int8 engine's folded tree must hold every weight as an int8 ``q`` with
its scale ``s`` in the compute dtype, and no float tensor with more than
one non-unit axis (what is left are the per-channel vectors: the folded
BN affine, biases and the scales); its model keeps no storage.
"""

import torch

from pytorch_cifar_tpu_torch.models import MODEL_REGISTRY
from pytorch_cifar_tpu_torch.serve import InferenceEngine
from pytorch_cifar_tpu_torch.serve.engine import _is_qleaf, _tree_map

NAMES = sorted(MODEL_REGISTRY)


def _non_unit_axes(t):
    return sum(d > 1 for d in t.shape)


def check_folded_tree_holds_no_float_weight(name):
    eng = InferenceEngine.from_random(
        name, buckets=(1,), compute_dtype=torch.bfloat16, device="cpu",
        int8=True)
    model, folded = eng._weights
    assert all(p.is_meta for p in model.parameters())
    qleaves, floats = [], []

    def visit(leaf):
        if _is_qleaf(leaf):
            qleaves.append(leaf)
        elif isinstance(leaf, torch.Tensor):
            floats.append(leaf)
        return leaf

    _tree_map(visit, folded)
    assert qleaves
    for leaf in qleaves:
        assert leaf["q"].dtype == torch.int8
        assert leaf["s"].dtype == torch.bfloat16
        assert _non_unit_axes(leaf["s"]) <= 1
        assert leaf["s"].ndim == leaf["q"].ndim
    for t in floats:
        assert _non_unit_axes(t) <= 1, (name, tuple(t.shape), t.dtype)
