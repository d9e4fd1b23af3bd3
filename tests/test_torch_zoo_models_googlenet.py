"""GoogLeNet's forwards in the port against the JAX package's, on the same
seeded weights: eval logits in fp32 (rtol 1e-4) and bf16 (2% of the
largest logit, and no further off the fp32 logits than 1.5 times the JAX
bf16 forward), its kernel sites per forward (28 fused, 9 pools), and the
train forward's 9 pools under autograd. Helpers in ``tests/_torch_zoo.py``.
"""

import pytest
import torch

from pytorch_cifar_tpu_torch.models import common, create_model
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import (  # noqa: F401
    check_bf16_error,
    check_eval_bf16,
    check_eval_fp32,
    check_kernel_sites,
    trees,
)


@pytest.mark.parametrize("name", ["GoogLeNet"])
def test_eval_logits_match_jax_fp32(name, trees):
    check_eval_fp32(name, trees)


@pytest.mark.parametrize("name,he", [("GoogLeNet", True)])
def test_eval_logits_match_jax_bf16(name, he, trees):
    check_eval_bf16(name, he, trees)


@pytest.mark.parametrize("name", ["GoogLeNet"])
def test_bf16_error_no_worse_than_jax(name, trees):
    check_bf16_error(name, trees)


@pytest.mark.parametrize("name,fused,pools,stencils",
                         [("GoogLeNet", 28, 9, 0)])
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    check_kernel_sites(name, fused, pools, stencils, monkeypatch)


def test_googlenet_train_forward_pools_nine_times_with_a_backward(monkeypatch):
    """Train mode: the 9 pool branches go through the op under autograd
    (winner map, backward), the stage transitions do not."""
    calls = []
    real = common.max_pool3x3_s1
    monkeypatch.setattr(
        common, "max_pool3x3_s1",
        lambda v: calls.append(v.requires_grad) or real(v),
    )
    model = create_model(
        "GoogLeNet", generator=torch.Generator().manual_seed(0)
    ).train()
    out = model(torch.randn(2, 3, 32, 32))
    assert calls == [True] * 9
    out.sum().backward()
    assert all(p.grad is not None for p in model.parameters())
