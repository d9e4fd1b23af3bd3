"""The port's GoogLeNet and MobileNet against the JAX package's, on the
same weights.

Weights, BN statistics and inputs come from numpy seeds; the JAX trees are
mapped into the port by ``compat.state_dict_from_jax``, which must agree
with the JAX package's own ``compat.export_torch_state_dict``. The JAX
models run eagerly (no whole-model compile): GoogLeNet is slow to compile
on the CPU. Tolerances: fp32 rtol 1e-4 (the frameworks sum convolutions in
other orders), bf16 2% of the largest logit (they round at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from pytorch_cifar_tpu import compat as jax_compat
from pytorch_cifar_tpu.models import create_model as jax_create_model
from pytorch_cifar_tpu.models.googlenet import Inception as JaxInception
from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
from pytorch_cifar_tpu_torch.models import (
    NOT_PORTED,
    available_models,
    common,
    count_params,
    create_model,
)
from pytorch_cifar_tpu_torch.models.googlenet import CELLS, Inception
from pytorch_cifar_tpu_torch.models.mobilenet import CFG

ZOO = ["GoogLeNet", "MobileNet"]
BN_LEAVES = ("weight", "bias", "running_mean", "running_var",
             "num_batches_tracked")
# the port's Inception sites in the JAX cell's Conv_j/BatchNorm_j order
CELL_SITES = ("b1.0", "b2.0", "b2.3", "b3.0", "b3.3", "b3.6", "b4.1")


def random_trees(shapes, seed, he=True):
    """(params, batch_stats) as numpy for a flax ``init`` shape tree:
    non-trivial biases, BN affine and stats. Conv kernels are He-uniform
    (bound sqrt(6 / fan_in)), which keeps the activations' scale through
    the ReLUs, so the logits are O(1-10) as a trained network's are;
    ``he=False`` draws them with bound 1 / sqrt(fan_in), under which the
    signal shrinks with depth until the logits are the last bias."""
    rs = np.random.RandomState(seed)

    def param(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = np.prod(s.shape[:-1])
            he_conv = he and len(s.shape) == 4
            bound = np.sqrt((6.0 if he_conv else 1.0) / fan_in)
            return rs.uniform(-bound, bound, s.shape).astype(np.float32)
        if leaf == "scale":
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    def stat(path, s):
        if path[-1].key == "var":
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(param, shapes["params"]),
            jax.tree_util.tree_map_with_path(stat, shapes["batch_stats"]))


@pytest.fixture(scope="module")
def trees():
    cache = {}

    def get(name, he=True):
        if (name, he) not in cache:
            model = jax_create_model(name)
            shapes = jax.eval_shape(lambda: model.init(
                jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False
            ))
            cache[name, he] = random_trees(shapes, 20 + ZOO.index(name), he)
        return cache[name, he]

    return get


def _bn(prefix):
    return [f"{prefix}.{leaf}" for leaf in BN_LEAVES]


def reference_keys(name):
    """state_dict keys in the reference's definition order."""
    if name == "MobileNet":
        keys = ["conv1.weight", *_bn("bn1")]
        for i in range(len(CFG)):
            p = f"layers.{i}"
            keys += [f"{p}.conv1.weight", *_bn(f"{p}.bn1"),
                     f"{p}.conv2.weight", *_bn(f"{p}.bn2")]
        return keys + ["linear.weight", "linear.bias"]
    keys = ["pre_layers.0.weight", "pre_layers.0.bias", *_bn("pre_layers.1")]
    for cell in ("a3", "b3", "a4", "b4", "c4", "d4", "e4", "a5", "b5"):
        for site in CELL_SITES:
            branch, i = site.split(".")
            keys += [f"{cell}.{site}.weight", f"{cell}.{site}.bias",
                     *_bn(f"{cell}.{branch}.{int(i) + 1}")]
    return keys + ["linear.weight", "linear.bias"]


@pytest.mark.parametrize("name,count",
                         [("GoogLeNet", 6_166_250), ("MobileNet", 3_217_226)])
def test_golden_param_counts(name, count):
    assert count_params(create_model(name)) == count


@pytest.mark.parametrize("name", ZOO)
def test_registered_and_no_longer_listed_as_unported(name):
    assert name in available_models() and name not in NOT_PORTED
    with pytest.raises(NotImplementedError, match="not ported yet"):
        create_model("PNASNetA")


@pytest.mark.parametrize("name", ZOO)
def test_state_dict_keys_in_reference_order(name):
    assert list(create_model(name).state_dict()) == reference_keys(name)


def test_cells_follow_the_jax_plan():
    from pytorch_cifar_tpu.models.googlenet import _CELLS as JAX_CELLS
    from pytorch_cifar_tpu.models.mobilenet import _CFG as JAX_CFG

    assert tuple(c if c is None else c[1] for c in CELLS) == JAX_CELLS
    assert CFG == JAX_CFG


@pytest.mark.parametrize("name", ZOO)
def test_state_dict_from_jax_matches_export(name, trees):
    params, stats = trees(name)
    template = {
        k: v.numpy() for k, v in create_model(name).state_dict().items()
    }
    want = jax_compat.export_torch_state_dict(
        name, params, stats, template_sd=template
    )
    got = state_dict_from_jax(name, params, stats)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_state_dict_from_jax_refuses_another_models_tree(trees):
    params, stats = trees("MobileNet")
    with pytest.raises((KeyError, ValueError)):
        state_dict_from_jax("GoogLeNet", params, stats)


def _port(name, params, stats):
    model = create_model(name)
    model.load_state_dict({
        k: torch.from_numpy(v)
        for k, v in state_dict_from_jax(name, params, stats).items()
    })
    return model.eval()


def _logits(name, params, stats, x, dtype):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmodel = jax_create_model(
        name, dtype=None if dtype == torch.float32 else jnp.bfloat16
    )
    want = np.asarray(
        jmodel.apply(
            {"params": params, "batch_stats": stats},
            jnp.asarray(x).astype(jdtype), train=False,
        ).astype(jnp.float32)
    )
    with torch.no_grad():
        xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
        got = _port(name, params, stats)(xt).float().numpy()
    return got, want


@pytest.mark.parametrize("name", ZOO)
def test_eval_logits_match_jax_fp32(name, trees):
    params, stats = trees(name)
    x = np.random.RandomState(30).standard_normal((2, 32, 32, 3)).astype(
        np.float32
    )
    got, want = _logits(name, params, stats, x, torch.float32)
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _bf16_case(name, trees, he):
    params, stats = trees(name, he)
    x = np.random.RandomState(31).standard_normal((2, 32, 32, 3)).astype(
        np.float32
    )
    got, want = _logits(name, params, stats, x, torch.bfloat16)
    assert np.all(np.isfinite(got))
    return got, want, params, stats, x


@pytest.mark.parametrize("name,he", [("GoogLeNet", True), ("MobileNet", False)])
def test_eval_logits_match_jax_bf16(name, he, trees):
    """The two bf16 forwards within 2% of the largest logit of each other.
    Each carries rounding noise of its own against the fp32 logits, and at
    these depths it is of the bound's size (JAX bf16 against JAX fp32, He
    kernels, three seeds: GoogLeNet 1.6-1.7%, MobileNet 1.3-2.4%), so the
    bound is held where the noise leaves room for it: GoogLeNet on He
    kernels (on 1 / sqrt(fan_in) kernels its logits shrink to 0.3, where
    one bf16 ulp alone is 0.7% of the largest), MobileNet on
    1 / sqrt(fan_in) kernels. :func:`test_bf16_error_no_worse_than_jax`
    holds both at He kernels against the fp32 logits."""
    got, want, *_ = _bf16_case(name, trees, he)
    assert np.max(np.abs(got - want)) <= 0.02 * np.max(np.abs(want))


@pytest.mark.parametrize("name", ZOO)
def test_bf16_error_no_worse_than_jax(name, trees):
    """On He kernels, against the fp32 logits: the port's bf16 forward is
    no further off than 1.5 times the JAX bf16 forward's own error (on the
    CPU it is closer: its fused sites sum and apply BN in fp32 and round
    once)."""
    got, want, params, stats, x = _bf16_case(name, trees, True)
    _, ref = _logits(name, params, stats, x, torch.float32)
    assert np.max(np.abs(got - ref)) <= 1.5 * np.max(np.abs(want - ref))


def folded_sites(folded):
    """Every ``FoldedConvBN`` of a model's ``fold()`` result (nested dicts
    and lists), in forward order."""
    if isinstance(folded, common.FoldedConvBN):
        yield folded
    elif isinstance(folded, dict):
        for v in folded.values():
            yield from folded_sites(v)
    elif isinstance(folded, (list, tuple)):
        for v in folded:
            yield from folded_sites(v)


@pytest.mark.parametrize("name,fused,pools,stencils",
                         [("GoogLeNet", 28, 9, 0), ("MobileNet", 1, 0, 9)])
def test_kernel_sites_per_forward(name, fused, pools, stencils, monkeypatch):
    """GoogLeNet: the stem and each cell's three 3x3 convs are fused sites
    (1 + 9 * 3) and each cell pools once; MobileNet: the stem is fused and
    the 9 stride-1 depthwise convs are stencil sites (the 4 stride-2 ones
    are not). Counted in the fold and in a forward's calls."""
    model = create_model(name).eval()
    sites = list(folded_sites(model.fold(torch.float32)))
    assert sum(s.fused for s in sites) == fused
    assert sum(s.stencil for s in sites) == stencils
    for s in sites:
        if s.fused:
            assert s.weight.shape[:2] == (3, 3) and s.stride == 1 and s.relu
        if s.stencil:
            assert s.weight.shape[:2] == (3, 3) and s.stride == 1
            assert s.weight.shape[2] == s.groups
        else:
            assert s.groups == 1 or s.stride == 2
    calls = {"fused": 0, "pool": 0, "stencil": 0}
    for key, fn in (("fused", "conv3x3_bn_relu"), ("pool", "max_pool3x3_s1"),
                    ("stencil", "depthwise_stencil")):
        real = getattr(common, fn)

        def counted(*a, _real=real, _key=key):
            calls[_key] += 1
            return _real(*a)

        monkeypatch.setattr(common, fn, counted)
    with torch.no_grad():
        model(torch.randn(1, 3, 32, 32))
    assert calls == {"fused": fused, "pool": pools, "stencil": stencils}


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


# -- one Inception cell at narrow widths ---------------------------------

WIDTHS = (8, 8, 16, 4, 8, 8)
CIN = 12


def _cell_pair(merged, seed=40):
    """A JAX cell's trees and the port cell loaded with them."""
    jcell = JaxInception(*WIDTHS, merged_1x1=merged)
    shapes = jax.eval_shape(lambda: jcell.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, CIN)), False
    ))
    params, stats = random_trees(shapes, seed)
    cell = Inception(CIN, *WIDTHS, merged_1x1=merged)
    sd = {}
    for j, site in enumerate(CELL_SITES):
        branch, i = site.split(".")
        node = params[f"Conv_{j}"]["Conv_0"]
        sd[f"{site}.weight"] = np.transpose(node["kernel"], (3, 2, 0, 1))
        sd[f"{site}.bias"] = node["bias"]
        bn = f"{branch}.{int(i) + 1}"
        sd[f"{bn}.weight"] = params[f"BatchNorm_{j}"]["scale"]
        sd[f"{bn}.bias"] = params[f"BatchNorm_{j}"]["bias"]
        sd[f"{bn}.running_mean"] = stats[f"BatchNorm_{j}"]["mean"]
        sd[f"{bn}.running_var"] = stats[f"BatchNorm_{j}"]["var"]
        sd[f"{bn}.num_batches_tracked"] = np.zeros((), np.int64)
    assert set(sd) == set(cell.state_dict())
    cell.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()})
    return jcell, params, stats, cell


def _cell_input(seed=41):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((4, 8, 8, CIN)).astype(np.float32)
    cot = rs.standard_normal((4, 8, 8, sum(WIDTHS) - 8 - 4)).astype(np.float32)
    return x, cot


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "stock"])
def test_inception_eval_matches_jax(merged):
    jcell, params, stats, cell = _cell_pair(merged)
    x, _ = _cell_input()
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
    jcell, params, stats, cell = _cell_pair(merged)
    x, cot = _cell_input()
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
    _, _, _, merged = _cell_pair(True)
    stock = Inception(CIN, *WIDTHS, merged_1x1=False)
    stock.load_state_dict(merged.state_dict())
    assert list(stock.state_dict()) == list(merged.state_dict())
    x, cot = _cell_input(seed=43)
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

    _, _, _, cell = _cell_pair(True, seed=44)
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
        f = common.fold_conv_bn(conv, bn, torch.float32, relu=relu)
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
    f = common.fold_conv_bn(conv, bn, torch.float32, relu=True)
    assert (f.stencil, f.fused, f.groups) == (stencil, False, 12)
    assert f.weight.shape == ((k, k, 12) if stencil else (12, 1, k, k))
    with torch.no_grad():
        want = torch.relu(bn(conv(x)))
        got = common.conv_bn(x, f)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fold_conv_bn_grouped_but_not_depthwise_stays_on_conv2d():
    conv = common.conv(8, 16, 3, groups=4)
    f = common.fold_conv_bn(conv, common.batchnorm(16).eval(), torch.float32,
                            relu=True)
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
