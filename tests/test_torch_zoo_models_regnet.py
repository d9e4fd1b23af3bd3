"""The port's RegNetX_200MF, RegNetX_400MF and RegNetY_400MF against the
JAX package's, on the same seeded weights: registry entries, parameter
counts, ``state_dict`` order (the Y blocks' ``se.se1``/``se.se2`` with
their biases), the mapping against the JAX export and back as raw bits,
eval logits in fp32 and bf16, its kernel sites per forward (the 3x3 stem;
the grouped 3x3s stay ``F.conv2d``), the SE width from the block's input,
and the shared SE gate and global pool against the JAX ones. Helpers in
``tests/_torch_zoo.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.models.common import (
    global_avg_pool as jax_global_avg_pool,
)
from pytorch_cifar_tpu.models.regnet import SE as JaxSE
from pytorch_cifar_tpu_torch.models import (
    available_models,
    common,
    count_params,
    create_model,
)
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
    random_trees,
    reference_keys,
    trees,
)

COUNTS = {"RegNetX_200MF": 2_321_946, "RegNetX_400MF": 4_779_338,
          "RegNetY_400MF": 5_714_362}
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


@pytest.mark.parametrize("name", ["RegNetY_400MF"])
def test_state_dict_round_trips_as_raw_bits(name, trees):
    check_round_trip(name, trees)


@pytest.mark.parametrize("name", ["RegNetY_400MF"])
def test_jax_checkpoint_round_trips_byte_identical(name, tmp_path):
    check_checkpoint_round_trip(name, tmp_path)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_tree_with_a_leaf_off(edit, trees):
    check_refuses_a_leaf_off("RegNetY_400MF", edit, trees)


@pytest.mark.parametrize("name,he", [("RegNetX_200MF", True),
                                     ("RegNetY_400MF", False)])
def test_eval_logits_match_jax_fp32(name, he, trees):
    """RegNetY_400MF (the gates) on 1 / sqrt(fan_in) kernels: on He
    kernels its logits grow to ~2,800 and each package's fp32 forward is
    off its float64 forward by more than rtol 1e-4 allows (JAX by 1.84,
    the port by 0.52, on the CPU)."""
    check_eval_fp32(name, trees, he, jit=True)


@pytest.mark.parametrize("name", ["RegNetX_200MF"])
def test_bf16_error_no_worse_than_jax(name, trees):
    """The JAX forwards compiled, as the JAX package's engine runs them."""
    check_bf16_error(name, trees, jit=True)


@pytest.mark.parametrize("name,fused,pools,stencils", kernel_sites(*NAMES))
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)


def test_se_width_derives_from_the_block_input():
    """``round(w_in * 0.25)``: the first block of each stage takes the
    previous stage's width, the others their own."""
    model = create_model("RegNetY_400MF")
    w_in = 64
    for i, w in enumerate((32, 64, 160, 384)):
        for j, blk in enumerate(getattr(model, f"layer{i + 1}")):
            assert blk.se.se1.out_channels == round(w_in * 0.25)
            assert blk.se.se1.in_channels == w and blk.se.se2.bias is not None
            w_in = w
        assert j == (1, 2, 7, 12)[i] - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_se_gate_and_global_pool_match_jax(dtype):
    """:func:`common.se_gate` against the JAX RegNet ``SE`` on the same
    weights, and :func:`common.global_avg_pool` against the JAX one: fp32
    within rtol 1e-6, bf16 within one bf16 ulp of the output's scale."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rs = np.random.RandomState(3)
    x = rs.standard_normal((2, 4, 4, 24)).astype(np.float32)
    se = JaxSE(6, dtype=jdt)
    shapes = jax.eval_shape(lambda: se.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    params, _ = random_trees({"params": shapes["params"],
                              "batch_stats": {}}, 4)
    want = np.asarray(se.apply({"params": params},
                               jnp.asarray(x).astype(jdt)).astype(
        jnp.float32))
    w = [torch.from_numpy(np.ascontiguousarray(np.transpose(
        params[f"Conv_{j}"]["Conv_0"]["kernel"], (3, 2, 0, 1))))
        for j in range(2)]
    b = [torch.from_numpy(params[f"Conv_{j}"]["Conv_0"]["bias"])
         for j in range(2)]
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
    got = common.se_gate(xt, w[0], b[0], w[1], b[1])
    assert got.dtype == dtype
    got = got.float().permute(0, 2, 3, 1).numpy()
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())
    pooled = common.global_avg_pool(xt).float().numpy()
    jpooled = np.asarray(jax_global_avg_pool(jnp.asarray(x).astype(jdt))
                         .astype(jnp.float32))
    np.testing.assert_allclose(pooled, jpooled, rtol=tol, atol=tol)
