"""The port's ResNets against the JAX package's, on the same weights.

Weights, BN statistics and inputs come from numpy seeds; the JAX trees are
mapped into the port by ``compat.state_dict_from_jax``, which must agree
with the JAX package's own ``compat.export_torch_state_dict``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu import compat as jax_compat
from pytorch_cifar_tpu.models import create_model as jax_create_model
from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
from pytorch_cifar_tpu_torch.models import count_params, create_model
from pytorch_cifar_tpu_torch.models.common import FoldedConvBN
from _torch_threads import torch_threads  # noqa: F401


def random_jax_trees(name, seed=0):
    """(params, batch_stats) of the JAX ``name`` model as numpy, drawn from
    ``seed``: fan-in-scaled kernels, non-trivial BN affine and stats."""
    model = jax_create_model(name)
    shapes = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False
        )
    )
    rs = np.random.RandomState(seed)

    def param(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rs.uniform(-bound, bound, s.shape).astype(np.float32)
        if leaf == "scale":
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    def stat(path, s):
        if path[-1].key == "var":
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(param, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(stat, shapes["batch_stats"])
    return params, stats


def reference_keys(num_blocks, bottleneck):
    """state_dict keys in the reference's definition order."""
    def bn(p):
        return [f"{p}.{k}" for k in ("weight", "bias", "running_mean",
                                     "running_var", "num_batches_tracked")]

    keys = ["conv1.weight", *bn("bn1")]
    in_planes, expansion = 64, 4 if bottleneck else 1
    for li, (planes, stride, n) in enumerate(
        zip((64, 128, 256, 512), (1, 2, 2, 2), num_blocks), start=1
    ):
        for i in range(n):
            p = f"layer{li}.{i}"
            for j in range(1, 4 if bottleneck else 3):
                keys += [f"{p}.conv{j}.weight", *bn(f"{p}.bn{j}")]
            s = stride if i == 0 else 1
            if s != 1 or in_planes != expansion * planes:
                keys += [f"{p}.shortcut.0.weight", *bn(f"{p}.shortcut.1")]
            in_planes = expansion * planes
    return keys + ["linear.weight", "linear.bias"]


@pytest.fixture(scope="module")
def trees():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = random_jax_trees(name, seed=len(cache))
        return cache[name]

    return get


@pytest.mark.parametrize(
    "name,count",
    [("ResNet18", 11_173_962), ("ResNet50", 23_520_842),
     ("ResNet152", 58_156_618)],
)
def test_golden_param_counts(name, count):
    assert count_params(create_model(name)) == count


@pytest.mark.parametrize(
    "name,num_blocks,bottleneck",
    [("ResNet18", (2, 2, 2, 2), False), ("ResNet34", (3, 4, 6, 3), False),
     ("ResNet50", (3, 4, 6, 3), True)],
)
def test_state_dict_keys_in_reference_order(name, num_blocks, bottleneck):
    assert list(create_model(name).state_dict()) == reference_keys(
        num_blocks, bottleneck
    )


@pytest.mark.parametrize("name", ["ResNet18", "ResNet50"])
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


def _logits(name, params, stats, x, dtype):
    jmodel = jax_create_model(
        name, dtype=None if dtype == torch.float32 else jnp.bfloat16
    )
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(
        jmodel.apply(
            {"params": params, "batch_stats": stats},
            jnp.asarray(x).astype(jdtype), train=False,
        ).astype(jnp.float32)
    )
    model = create_model(name)
    model.load_state_dict(
        {k: torch.from_numpy(v)
         for k, v in state_dict_from_jax(name, params, stats).items()}
    )
    model.eval()
    with torch.no_grad():
        xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
        got = model(xt).float().numpy()
    return got, want


@pytest.mark.parametrize("name,n", [("ResNet18", 4), ("ResNet50", 2)])
def test_eval_logits_match_jax_fp32(name, n, trees):
    params, stats = trees(name)
    x = np.random.RandomState(10).standard_normal((n, 32, 32, 3)).astype(
        np.float32
    )
    got, want = _logits(name, params, stats, x, torch.float32)
    assert got.shape == (n, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,n", [("ResNet18", 4), ("ResNet50", 2)])
def test_eval_logits_match_jax_bf16(name, n, trees):
    params, stats = trees(name)
    x = np.random.RandomState(11).standard_normal((n, 32, 32, 3)).astype(
        np.float32
    )
    got, want = _logits(name, params, stats, x, torch.bfloat16)
    assert np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) <= 0.02 * np.max(np.abs(want))


@pytest.mark.parametrize("name,fused", [("ResNet18", 6), ("ResNet50", 14)])
def test_fused_sites_per_forward(name, fused):
    """Every stride-1 3x3 conv->BN->ReLU and nothing else is a fused site:
    ResNet-18's stem + its 5 stride-1 BasicBlock conv1s; ResNet-50's stem +
    its 13 stride-1 Bottleneck conv2s (every block but the stride-2 first
    blocks of layer2..4)."""
    folded = create_model(name).fold(torch.float32)
    sites = [folded["stem"]] + [
        s for b in folded["blocks"]
        for s in b["convs"] + ([b["shortcut"]] if b["shortcut"] else [])
    ]
    assert all(isinstance(s, FoldedConvBN) for s in sites)
    assert sum(s.fused for s in sites) == fused
    for s in sites:
        if s.fused:
            assert s.weight.shape[:2] == (3, 3) and s.stride == 1
            assert s.act == "relu"


def test_seeded_init_is_deterministic_pytorch_default():
    """``create_model(generator=)`` draws PyTorch's default init from the
    generator alone: same seed, same weights; conv/linear weights inside
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)); BN at scale 1, bias 0, stats
    (0, 1)."""
    def sd(seed):
        return create_model(
            "ResNet18", generator=torch.Generator().manual_seed(seed)
        ).state_dict()

    a, b, c = sd(0), sd(0), sd(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    for k, v in a.items():
        if k.endswith(".weight") and v.dim() in (2, 4):
            bound = 1.0 / np.sqrt(v[0].numel())
            assert float(v.abs().max()) <= bound, k
            assert float(v.abs().max()) > 0.9 * bound, k
    assert torch.equal(a["bn1.weight"], torch.ones(64))
    assert torch.equal(a["bn1.running_var"], torch.ones(64))
    assert torch.equal(a["layer4.1.bn2.bias"], torch.zeros(512))
