"""The port's ShuffleNetG2 and G3 against the JAX package's, on the same
seeded weights: registry entries, parameter counts (with the integer
``mid``), ``state_dict`` order, the mapping against the JAX export and
back as raw bits, eval logits in fp32 and bf16, its kernel sites per
forward (13 stencils at 50 / 100 / 200 and 60 / 120 / 240 channels, BN and
ReLU after; the stride-2 depthwise convs and the grouped 1x1s stay on the
library), and the shortcut's 3 / 2 / 1 average pool against the JAX one.
Helpers in ``tests/_torch_zoo.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.models.common import avg_pool as jax_avg_pool
from pytorch_cifar_tpu_torch.models import (
    available_models,
    common,
    count_params,
    create_model,
)
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (  # noqa: F401
    check_bf16_error,
    check_eval_fp32,
    check_export,
    check_kernel_sites,
    check_refuses_a_leaf_off,
    check_registry_is_the_jax_registry,
    check_round_trip,
    folded_sites,
    kernel_sites,
    reference_keys,
    trees,
)

COUNTS = {"ShuffleNetG2": 887_582, "ShuffleNetG3": 862_768}
NAMES = list(COUNTS)


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


@pytest.mark.parametrize("name", ["ShuffleNetG3"])
def test_state_dict_round_trips_as_raw_bits(name, trees):
    check_round_trip(name, trees)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_tree_with_a_leaf_off(edit, trees):
    check_refuses_a_leaf_off("ShuffleNetG2", edit, trees)


@pytest.mark.parametrize("name", NAMES)
def test_eval_logits_match_jax_fp32(name, trees):
    """The JAX forward compiled: op by op, compiling each op first takes
    most of the test on the CPU."""
    check_eval_fp32(name, trees, jit=True)


@pytest.mark.parametrize("name", ["ShuffleNetG2"])
def test_bf16_error_no_worse_than_jax(name, trees):
    """The JAX forwards compiled, as the JAX package's engine runs them."""
    check_bf16_error(name, trees, jit=True)


@pytest.mark.parametrize("name,fused,pools,stencils", kernel_sites(*NAMES))
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)


@pytest.mark.parametrize("name,widths", [("ShuffleNetG2", {50, 100, 200}),
                                         ("ShuffleNetG3", {60, 120, 240})])
def test_stencils_run_on_each_stages_mid_width(name, widths):
    sites = list(folded_sites(create_model(name).fold(torch.float32)))
    sten = [s for s in sites if s.stencil]
    assert {s.weight.shape[2] for s in sten} == widths
    assert all(s.act == "relu" for s in sten)
    strided = [s for s in sites if s.groups > 1 and s.stride == 2
               and s.weight.shape[1] == 1]
    assert len(strided) == 3  # each stage's first block, on the library


@pytest.mark.parametrize("shape", [(2, 32, 32, 24), (2, 8, 8, 200),
                                   (1, 5, 7, 3)])
def test_shortcut_pool_counts_the_padding_as_jax_does(shape):
    """``avg_pool(x, 3, 2, 1)``: the padded cells count in the divisor
    (PyTorch's and flax's default), so the corners average 4 values over
    9; against the JAX pool, fp32."""
    x = np.random.RandomState(sum(shape)).standard_normal(shape).astype(
        np.float32)
    want = np.asarray(jax_avg_pool(jnp.asarray(x), 3, stride=2, padding=1))
    got = common.avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, 1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)
