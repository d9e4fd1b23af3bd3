"""The port's DPN26 and DPN92 against the JAX package's, on the same
seeded weights: registry entries, parameter counts, ``state_dict`` order,
the mapping against the JAX export and back as raw bits, eval logits in
fp32 and bf16, its kernel sites per forward (the 3x3 stem; the grouped
3x3s, 32 groups, stay ``F.conv2d``), and the dual-path join's widths.
Helpers in ``tests/_torch_zoo.py``.
"""

import pytest
import torch

from pytorch_cifar_tpu_torch.models import (
    available_models,
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

COUNTS = {"DPN26": 11_574_842, "DPN92": 34_236_634}
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


@pytest.mark.parametrize("name", ["DPN92"])
def test_state_dict_round_trips_as_raw_bits(name, trees):
    check_round_trip(name, trees)


@pytest.mark.parametrize("edit", ["missing", "extra", "extra stats"])
def test_state_dict_from_jax_refuses_a_tree_with_a_leaf_off(edit, trees):
    check_refuses_a_leaf_off("DPN26", edit, trees)


@pytest.mark.parametrize("name", ["DPN26"])
def test_eval_logits_match_jax_fp32(name, trees):
    """The JAX forward compiled: op by op, compiling each op first takes
    most of the test on the CPU."""
    check_eval_fp32(name, trees, jit=True)


@pytest.mark.parametrize("name", ["DPN26"])
def test_bf16_error_no_worse_than_jax(name, trees):
    """The JAX forwards compiled, as the JAX package's engine runs them."""
    check_bf16_error(name, trees, jit=True)


@pytest.mark.parametrize("name,fused,pools,stencils", kernel_sites(*NAMES))
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)


@pytest.mark.parametrize("name", NAMES)
def test_each_block_grows_the_dense_path(name):
    """A block's output is ``out_planes + (i + 2) * dense_depth`` channels
    after its stage's i-th block (the residual path keeps ``out_planes``,
    the dense path grows by ``dense_depth`` each block and the first
    block's projection brings two), and every grouped conv has 32 groups."""
    model = create_model(name).eval()
    widths = []
    for b in model.blocks():
        b.register_forward_hook(lambda m, i, o: widths.append(o.shape[1]))
    with torch.no_grad():
        model.train()(torch.randn(2, 3, 32, 32))
    want = [o + (i + 2) * d for o, n, d in zip(
        (256, 512, 1024, 2048), model_blocks(name), (16, 32, 24, 128))
        for i in range(n)]
    assert widths == want
    grouped = [s for s in folded_sites(model.fold(torch.float32))
               if s.groups > 1]
    assert grouped and all(s.groups == 32 for s in grouped)


def model_blocks(name):
    return {"DPN26": (2, 2, 2, 2), "DPN92": (3, 4, 20, 3)}[name]
