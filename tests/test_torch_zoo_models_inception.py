"""One Inception cell at narrow widths in the port against the JAX
package's (eval and train, both ``merged_1x1`` modes: outputs, running
statistics and the input gradient within rtol 1e-4), the merged and stock
cells on one ``state_dict``, the cell's fold, and the folds of
``models.common`` (a biased conv, depthwise and grouped sites, the average
pool's stride). Helpers in ``tests/_torch_zoo.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from pytorch_cifar_tpu_torch.models import common
from pytorch_cifar_tpu_torch.models.googlenet import Inception
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import CELL_SITES, CIN, WIDTHS, cell_input, cell_pair


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "stock"])
def test_inception_eval_matches_jax(merged):
    jcell, params, stats, cell = cell_pair(merged)
    x, _ = cell_input()
    want = np.asarray(jcell.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), False
    ))
    cell.eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last
    )
    with torch.no_grad():
        got = cell(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "stock"])
def test_inception_train_matches_jax(merged):
    """Train mode: output, running statistics and the input gradient."""
    jcell, params, stats, cell = cell_pair(merged)
    x, cot = cell_input()
    variables = {"params": params, "batch_stats": stats}

    def f(v):
        out, upd = jcell.apply(variables, v, True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    (_, (want, new_stats)), want_gx = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x)
    )
    cell.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last
    ).requires_grad_()
    out = cell(xt)
    (gx,) = torch.autograd.grad(
        out, xt, torch.from_numpy(cot).permute(0, 3, 1, 2)
    )
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_gx), rtol=1e-4, atol=1e-5)
    sd = cell.state_dict()
    for j, site in enumerate(CELL_SITES):
        branch, i = site.split(".")
        for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(
                sd[f"{branch}.{int(i) + 1}.{key}"].numpy(),
                np.asarray(new_stats[f"BatchNorm_{j}"][leaf]),
                rtol=1e-4, atol=1e-6, err_msg=f"{site} {leaf}",
            )


def test_inception_merged_equals_unmerged_on_one_state_dict():
    """Both modes share one ``state_dict`` and compute the same values:
    each conv channel is its own dot product, BN statistics are per
    channel."""
    _, _, _, merged = cell_pair(True)
    stock = Inception(CIN, *WIDTHS, merged_1x1=False)
    stock.load_state_dict(merged.state_dict())
    assert list(stock.state_dict()) == list(merged.state_dict())
    x, cot = cell_input(seed=43)
    res = []
    for cell in (merged, stock):
        cell.train()
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        out = cell(xt)
        (gx,) = torch.autograd.grad(
            out, xt, torch.from_numpy(cot).permute(0, 3, 1, 2)
        )
        res.append((out.detach(), gx, cell.state_dict()))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(res[0][1], res[1][1], rtol=1e-5, atol=1e-6)
    for k, v in res[0][2].items():
        torch.testing.assert_close(v, res[1][2][k], rtol=1e-5, atol=1e-7)


def test_inception_fold_matches_its_eval_modules():
    """The folded cell (merged heads, bias folded, slices copied dense)
    against the cell's own modules in eval mode."""
    from pytorch_cifar_tpu_torch.models.googlenet import _cell_forward

    _, _, _, cell = cell_pair(True, seed=44)
    cell.eval()
    x = torch.randn(3, CIN, 8, 8).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = cell(x)
        got = _cell_forward(cell.fold(torch.float32), x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# -- the folds ------------------------------------------------------------

@pytest.mark.parametrize("k,relu", [(1, True), (3, True), (3, False)])
def test_fold_conv_bn_carries_the_conv_bias(k, relu):
    """A biased conv -> BN [-> ReLU] in eval mode against its fold: the
    bias must reach the affine (``add = bn.bias + (b - mean) * mul``)."""
    g = torch.Generator().manual_seed(k)
    conv = common.conv(6, 10, k, bias=True)
    bn = common.batchnorm(10)
    common.reset_parameters(nn.Sequential(conv, bn), g)
    with torch.no_grad():
        conv.bias.uniform_(-2.0, 2.0, generator=g)  # far from negligible
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(generator=g)
        bn.running_mean.normal_(generator=g)
        bn.running_var.uniform_(0.5, 1.5, generator=g)
    bn.eval()
    x = torch.randn(2, 6, 5, 5, generator=g).contiguous(
        memory_format=torch.channels_last
    )
    with torch.no_grad():
        want = bn(conv(x))
        want = torch.relu(want) if relu else want
        f = common.fold_conv_bn(conv, bn, torch.float32,
                                act="relu" if relu else None)
        got = common.conv_bn(x, f)
    assert f.fused == (k == 3 and relu)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,stride,stencil",
                         [(3, 1, True), (3, 2, False), (5, 1, True),
                          (7, 1, True)])
def test_fold_conv_bn_depthwise_sites(k, stride, stencil):
    """A depthwise conv -> BN -> ReLU against its fold: stride 1 goes
    through the stencil op with a ``(k, k, c)`` weight, stride 2 through a
    grouped ``F.conv2d``; neither computes a dense conv."""
    g = torch.Generator().manual_seed(10 * k + stride)
    conv = common.conv(12, 12, k, stride, groups=12)
    bn = common.batchnorm(12)
    common.reset_parameters(nn.Sequential(conv, bn), g)
    with torch.no_grad():
        bn.running_mean.normal_(generator=g)
        bn.running_var.uniform_(0.5, 1.5, generator=g)
    bn.eval()
    x = torch.randn(2, 12, 8, 8, generator=g).contiguous(
        memory_format=torch.channels_last
    )
    f = common.fold_conv_bn(conv, bn, torch.float32, act="relu")
    assert (f.stencil, f.fused, f.groups) == (stencil, False, 12)
    assert f.weight.shape == ((k, k, 12) if stencil else (12, 1, k, k))
    with torch.no_grad():
        want = torch.relu(bn(conv(x)))
        got = common.conv_bn(x, f)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fold_conv_bn_grouped_but_not_depthwise_stays_on_conv2d():
    conv = common.conv(8, 16, 3, groups=4)
    f = common.fold_conv_bn(conv, common.batchnorm(16).eval(), torch.float32,
                            act="relu")
    assert (f.stencil, f.fused, f.groups) == (False, False, 4)
    x = torch.randn(1, 8, 4, 4)
    with torch.no_grad():
        torch.testing.assert_close(
            common.conv_bn(x, f),
            torch.relu(F.conv2d(x, conv.weight, padding=1, groups=4)
                       / (1 + 1e-5) ** 0.5),
            rtol=1e-5, atol=1e-6,
        )


def test_avg_pool_takes_a_stride():
    x = torch.randn(1, 2, 9, 9)
    assert torch.equal(common.avg_pool(x, 8, stride=1), F.avg_pool2d(x, 8, 1))
    assert torch.equal(common.avg_pool(x, 2), F.avg_pool2d(x, 2))
