"""The port's SENet18 against the JAX package's, on the same seeded
weights: registry entry, parameter count, ``state_dict`` order (the
reference's ``fc1``/``fc2`` gate convs, with their biases), the mapping
against the JAX export and back as raw bits, eval logits in fp32 and bf16,
its kernel sites per forward (the stem and the 5 stride-1 ``conv1``s), and
the gate against the JAX block's. Helpers in ``tests/_torch_zoo.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.models.senet import SEPreActBlock as JaxBlock
from pytorch_cifar_tpu_torch.models import (
    available_models,
    count_params,
    create_model,
)
from pytorch_cifar_tpu_torch.models.senet import PreActBlock, _block_forward
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (  # noqa: F401
    check_bf16_error,
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

COUNTS = {"SENet18": 11_260_354}
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


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_round_trips_as_raw_bits(name, trees):
    check_round_trip(name, trees)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_tree_with_a_leaf_off(edit, trees):
    check_refuses_a_leaf_off("SENet18", edit, trees)


@pytest.mark.parametrize("name", NAMES)
def test_eval_logits_match_jax_fp32(name, trees):
    """The JAX forward compiled: op by op, compiling each op first takes
    most of the test on the CPU."""
    check_eval_fp32(name, trees, jit=True)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_error_no_worse_than_jax(name, trees):
    """The JAX forwards compiled, as the JAX package's engine runs them."""
    check_bf16_error(name, trees, jit=True)


@pytest.mark.parametrize("name,fused,pools,stencils", kernel_sites(*NAMES))
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)


@pytest.mark.parametrize("stride,cin", [(1, 32), (2, 16)])
def test_a_folded_block_matches_the_jax_block(stride, cin):
    """One block (identity and projected shortcut) in eval mode, folded,
    against the JAX block on the same weights: fp32, rtol 1e-5."""
    planes = 32
    jblock = JaxBlock(planes, stride)
    x = np.random.RandomState(stride).standard_normal(
        (2, 8, 8, cin)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jblock.init(
        jax.random.PRNGKey(0), jnp.asarray(x), False))
    params, stats = random_trees(shapes, 50 + stride)
    want = np.asarray(jblock.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), False))
    block = PreActBlock(cin, planes, stride)
    sd = {}
    convs = (["shortcut.0"] if stride != 1 or cin != planes else []) + [
        "conv1", "conv2", "fc1", "fc2"]
    for j, c in enumerate(convs):
        node = params[f"Conv_{j}"]["Conv_0"]
        sd[f"{c}.weight"] = np.transpose(node["kernel"], (3, 2, 0, 1))
        if "bias" in node:
            sd[f"{c}.bias"] = node["bias"]
    for j, bn in enumerate(("bn1", "bn2")):
        sd[f"{bn}.weight"] = params[f"BatchNorm_{j}"]["scale"]
        sd[f"{bn}.bias"] = params[f"BatchNorm_{j}"]["bias"]
        sd[f"{bn}.running_mean"] = stats[f"BatchNorm_{j}"]["mean"]
        sd[f"{bn}.running_var"] = stats[f"BatchNorm_{j}"]["var"]
        sd[f"{bn}.num_batches_tracked"] = np.zeros((), np.int64)
    block.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = _block_forward(block.eval().fold(torch.float32), xt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
