"""The port's DenseNet121/161/169/201 and DenseNetCifar against the JAX
package's, on the same seeded weights: registry entries, parameter
counts, ``state_dict`` order, the mapping against the JAX export and back
as raw bits, eval logits in fp32 and bf16, its kernel sites per forward
(none), and the shared-stats path: on and off give the same outputs,
gradients and running statistics in float64, and its moments go through
``bn_batch_moments`` (the K2 hook) once per new chunk. Helpers in
``tests/_torch_zoo.py``.
"""

import numpy as np
import pytest
import torch

from pytorch_cifar_tpu_torch.models import (
    available_models,
    common,
    count_params,
    create_model,
)
from pytorch_cifar_tpu_torch.models.densenet import DenseNet
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (  # noqa: F401
    check_bf16_error,
    check_checkpoint_round_trip,
    check_eval_fp32,
    check_export,
    check_kernel_sites,
    check_refuses_a_leaf_off,
    check_registry_is_the_jax_registry,
    check_round_trip,
    kernel_sites,
    reference_keys,
    trees,
)

COUNTS = {"DenseNet121": 6_956_298, "DenseNet161": 26_482_378,
          "DenseNet169": 12_493_322, "DenseNet201": 18_104_330,
          "DenseNetCifar": 1_000_618}
NAMES = list(COUNTS)
NARROW = ((2, 3, 2, 2), 4)  # blocks a stage, growth


@pytest.mark.parametrize("name,count", list(COUNTS.items()))
def test_golden_param_counts(name, count):
    assert count_params(create_model(name)) == count


@pytest.mark.parametrize("name", NAMES)
def test_registered_as_in_the_jax_registry(name):
    assert name in available_models()
    check_registry_is_the_jax_registry()


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_keys_in_reference_order(name):
    assert list(create_model(name).state_dict()) == reference_keys(name)


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_from_jax_matches_export(name, trees):
    check_export(name, trees)


@pytest.mark.parametrize("name", ["DenseNet121"])
def test_state_dict_round_trips_as_raw_bits(name, trees):
    check_round_trip(name, trees)


@pytest.mark.parametrize("name", ["DenseNetCifar"])
def test_jax_checkpoint_round_trips_byte_identical(name, tmp_path):
    check_checkpoint_round_trip(name, tmp_path)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_tree_with_a_leaf_off(edit, trees):
    check_refuses_a_leaf_off("DenseNetCifar", edit, trees)


@pytest.mark.parametrize("name", ["DenseNetCifar"])
def test_eval_logits_match_jax_fp32(name, trees):
    """The JAX forward compiled (op by op it takes ~45 s at 58 layers)."""
    check_eval_fp32(name, trees, jit=True)


@pytest.mark.parametrize("name", ["DenseNetCifar"])
def test_bf16_error_no_worse_than_jax(name, trees):
    """Both JAX forwards compiled, as in the JAX package's engine."""
    check_bf16_error(name, trees, jit=True)


@pytest.mark.parametrize("name,fused,pools,stencils", kernel_sites(*NAMES))
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)


def _train_forward(shared, x, cot, seed=7):
    """A train-mode float64 forward and backward of the narrow DenseNet:
    the logits, every gradient and every running statistic after it."""
    model = DenseNet(*NARROW, shared_stats=shared)
    common.reset_parameters(model, torch.Generator().manual_seed(seed))
    model = model.double().train()
    out = model(x)
    (out * cot).sum().backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running_" in k}
    return out.detach(), grads, stats


def test_shared_stats_on_and_off_agree_in_float64():
    """Per-channel moments of a concatenation are its chunks' moments: the
    two paths' logits, gradients and running statistics within 1e-10
    relative (of each tensor's largest value)."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(4, 3, 32, 32, generator=g, dtype=torch.float64)
    cot = torch.randn(4, 10, generator=g, dtype=torch.float64)
    on, off = _train_forward(True, x, cot), _train_forward(False, x, cot)
    for a, b in zip(on[1:], off[1:]):
        assert a.keys() == b.keys()
    pairs = [("logits", on[0], off[0])] + [
        (k, on[i][k], off[i][k]) for i in (1, 2) for k in on[i]]
    for k, a, b in pairs:
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-10 * scale, err_msg=k)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_layer"])
def test_moments_go_through_the_k2_hook(shared):
    """Under ``bn_moments_impl`` the shared path reduces the stem output,
    each layer's new chunk (``growth`` channels), each transition's output
    and each ``bn2`` input once; the per-layer path reduces every BN's
    whole input. Both make 2 L + 4 calls for L layers."""
    model = DenseNet(*NARROW, shared_stats=shared).train()
    seen = []

    def impl(v):
        seen.append(v.shape[-1])
        vf = v.float()
        return vf.mean(dim=(0, 1, 2)), (vf * vf).mean(dim=(0, 1, 2))

    with common.bn_moments_impl(impl):
        model(torch.randn(2, 3, 32, 32))
    layers = sum(NARROW[0])
    assert len(seen) == 2 * layers + 4
    growth = NARROW[1]
    if shared:
        assert seen.count(growth) == layers  # one per new chunk
        assert seen.count(4 * growth) == layers  # the bn2 inputs
    else:
        assert seen.count(growth) == 0
