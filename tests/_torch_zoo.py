"""Shared pieces of the zoo's test files (``tests/test_torch_zoo_*.py``):
seeded JAX trees and inputs, the reference's ``state_dict`` key order, the
JAX call order of the DLA trees, of PNASNet's stride-2 B cells and of the
pre-activation blocks' shortcuts, the JAX and port forwards and train steps
they compare, the registry checks, and one narrow Inception cell of both
packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.models import create_model as jax_create_model
from pytorch_cifar_tpu.models.googlenet import Inception as JaxInception
from pytorch_cifar_tpu.train import optim as jax_optim
from pytorch_cifar_tpu.train import state as jax_state
from pytorch_cifar_tpu.train import steps as jax_steps
from pytorch_cifar_tpu_torch.compat import state_dict_from_jax
from pytorch_cifar_tpu_torch.models import common, create_model
from pytorch_cifar_tpu_torch.models.dla_simple import STEMS, TREES
from pytorch_cifar_tpu_torch.models.googlenet import Inception
from pytorch_cifar_tpu_torch.models.mobilenet import CFG
from pytorch_cifar_tpu_torch.train import optim, steps
from pytorch_cifar_tpu_torch.train.state import create_train_state


ZOO = ["GoogLeNet", "MobileNet", "SimpleDLA", "DLA", "MobileNetV2",
       "EfficientNetB0", "PNASNetA", "PNASNetB", "ShuffleNetV2_0.5",
       "ShuffleNetV2_1", "ShuffleNetV2_1.5", "ShuffleNetV2_2"]
# the plain and residual families, the last 26 names ported
REST = ["VGG11", "VGG13", "VGG16", "VGG19", "PreActResNet18",
        "PreActResNet34", "PreActResNet50", "PreActResNet101",
        "PreActResNet152", "SENet18", "ResNeXt29_2x64d", "ResNeXt29_4x64d",
        "ResNeXt29_8x64d", "ResNeXt29_32x4d", "RegNetX_200MF",
        "RegNetX_400MF", "RegNetY_400MF", "DenseNet121", "DenseNet161",
        "DenseNet169", "DenseNet201", "DenseNetCifar", "DPN26", "DPN92",
        "ShuffleNetG2", "ShuffleNetG3"]


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
            cache[name, he] = random_trees(shapes,
                                           20 + (ZOO + REST).index(name), he)
        return cache[name, he]

    return get


def bn_keys(prefix):
    return [f"{prefix}.{leaf}" for leaf in BN_LEAVES]


def block_keys(p, shortcut):
    keys = [f"{p}.conv1.weight", *bn_keys(f"{p}.bn1"), f"{p}.conv2.weight",
            *bn_keys(f"{p}.bn2")]
    if shortcut:
        keys += [f"{p}.shortcut.0.weight", *bn_keys(f"{p}.shortcut.1")]
    return keys


def tree_keys(p, level, shortcut):
    """A reference Tree: its root first, then the left and right
    children; only the left child's first block can change width or
    stride."""
    keys = [f"{p}.root.conv.weight", *bn_keys(f"{p}.root.bn")]
    if level == 1:
        return keys + block_keys(f"{p}.left_tree", shortcut) \
            + block_keys(f"{p}.right_tree", False)
    return keys + tree_keys(f"{p}.left_tree", level - 1, shortcut) \
        + tree_keys(f"{p}.right_tree", level - 1, False)


def paper_tree_keys(p, level, shortcut):
    """A reference paper-DLA Tree: its root, then (level 2) ``level_1`` and
    ``prev_root``, then the left and right nodes."""
    keys = [f"{p}.root.conv.weight", *bn_keys(f"{p}.root.bn")]
    if level == 1:
        return keys + block_keys(f"{p}.left_node", shortcut) \
            + block_keys(f"{p}.right_node", False)
    return keys + paper_tree_keys(f"{p}.level_1", 1, shortcut) \
        + block_keys(f"{p}.prev_root", shortcut) \
        + block_keys(f"{p}.left_node", False) \
        + block_keys(f"{p}.right_node", False)


def convbn_keys(p, conv="conv1", bn="bn1"):
    return [f"{p}.{conv}.weight", *bn_keys(f"{p}.{bn}")]


def _zoo_keys(name):
    """The depthwise families' reference keys."""
    from pytorch_cifar_tpu_torch.models import efficientnet as E
    from pytorch_cifar_tpu_torch.models import mobilenetv2 as M2
    from pytorch_cifar_tpu_torch.models import shufflenetv2 as S2

    keys = ["conv1.weight", *bn_keys("bn1")]
    if name == "MobileNetV2":
        cin, i = 32, 0
        for _, cout, n, stride in M2.CFG:
            for s in [stride] + [1] * (n - 1):
                p = f"layers.{i}"
                for j in (1, 2, 3):
                    keys += convbn_keys(p, f"conv{j}", f"bn{j}")
                if s == 1 and cin != cout:
                    keys += [f"{p}.shortcut.0.weight",
                             *bn_keys(f"{p}.shortcut.1")]
                cin, i = cout, i + 1
        keys += ["conv2.weight", *bn_keys("bn2")]
    elif name == "EfficientNetB0":
        for i in range(sum(E.B0["num_blocks"])):
            p = f"layers.{i}"
            keys += convbn_keys(p) + convbn_keys(p, "conv2", "bn2")
            keys += [f"{p}.se.se1.weight", f"{p}.se.se1.bias",
                     f"{p}.se.se2.weight", f"{p}.se.se2.bias"]
            keys += convbn_keys(p, "conv3", "bn3")
    elif name.startswith("ShuffleNetV2"):
        size = float(name.split("_")[1])
        _, blocks = S2.CONFIGS[int(size) if size.is_integer() else size]
        for s, n in enumerate(blocks):
            for j in range(1, 6):
                keys += convbn_keys(f"layer{s + 1}.0", f"conv{j}", f"bn{j}")
            for i in range(1, n + 1):
                for j in range(1, 4):
                    keys += convbn_keys(f"layer{s + 1}.{i}", f"conv{j}",
                                        f"bn{j}")
        keys += ["conv2.weight", *bn_keys("bn2")]
    else:  # PNASNet
        cells = [f"layer1.{i}" for i in range(6)] + ["layer2"] + [
            f"layer3.{i}" for i in range(6)] + ["layer4"] + [
            f"layer5.{i}" for i in range(6)]
        for p in cells:
            seps = 1 if name == "PNASNetA" else 3
            for j in range(1, seps + 1):
                keys += convbn_keys(f"{p}.sep_conv{j}")
            if "." not in p:  # a stride-2 cell
                keys += convbn_keys(p)
            if name == "PNASNetB":
                keys += convbn_keys(p, "conv2", "bn2")
    return keys + ["linear.weight", "linear.bias"]


def _sc(p, bn=True):
    """A projection shortcut's keys: its conv (and its BN)."""
    return [f"{p}.shortcut.0.weight"] + (bn_keys(f"{p}.shortcut.1") if bn
                                         else [])


def _rest_keys(name):
    """The plain and residual families' reference keys, from the JAX
    models' plans (kuangliu/pytorch-cifar's definition order)."""
    from pytorch_cifar_tpu.models.vgg import CFG as VGG_CFG

    jmodel = jax_create_model(name)
    if name.startswith("VGG"):
        keys, i = [], 0
        for item in VGG_CFG[name]:
            if item == "M":
                i += 1
                continue
            keys += [f"features.{i}.weight", f"features.{i}.bias",
                     *bn_keys(f"features.{i + 1}")]
            i += 3  # conv, BN, ReLU
        return keys + ["classifier.weight", "classifier.bias"]
    if name.startswith(("PreActResNet", "SENet")):
        se = name.startswith("SENet")
        keys = ["conv1.weight"] + (bn_keys("bn1") if se else [])
        deep = not se and jmodel.block.expansion == 4
        cin, n = 64, 3 if deep else 2
        for li, (planes, stride) in enumerate(zip((64, 128, 256, 512),
                                                  (1, 2, 2, 2))):
            for b in range(jmodel.num_blocks[li]):
                p, s_ = f"layer{li + 1}.{b}", stride if b == 0 else 1
                cout = planes * (4 if deep else 1)
                for j in range(1, n + 1):
                    keys += bn_keys(f"{p}.bn{j}") + [f"{p}.conv{j}.weight"]
                if s_ != 1 or cin != cout:
                    keys += _sc(p, bn=False)
                if se:
                    keys += [f"{p}.fc1.weight", f"{p}.fc1.bias",
                             f"{p}.fc2.weight", f"{p}.fc2.bias"]
                cin = cout
        return keys + ["linear.weight", "linear.bias"]
    keys = ["conv1.weight"] + ([] if name.startswith("DenseNet")
                               else bn_keys("bn1"))

    def convs(p, n=3):
        return [k for j in range(1, n + 1)
                for k in convbn_keys(p, f"conv{j}", f"bn{j}")]

    if name.startswith("ResNeXt"):
        card, width = jmodel.cardinality, jmodel.bottleneck_width
        cin = 64
        for s, n in enumerate(jmodel.num_blocks):
            for b in range(n):
                p, cout = f"layer{s + 1}.{b}", 2 * card * width
                stride = 2 if b == 0 and s > 0 else 1
                keys += convs(p) + (_sc(p) if stride != 1 or cin != cout
                                    else [])
                cin = cout
            width *= 2
    elif name.startswith("RegNet"):
        cfg, cin = jmodel.cfg, 64
        for s, (depth, w) in enumerate(zip(cfg["depths"], cfg["widths"])):
            for b in range(depth):
                p = f"layer{s + 1}.{b}"
                keys += convs(p, 2)
                if cfg["se_ratio"] > 0:
                    keys += [f"{p}.se.se1.weight", f"{p}.se.se1.bias",
                             f"{p}.se.se2.weight", f"{p}.se.se2.bias"]
                keys += convbn_keys(p, "conv3", "bn3")
                stride = cfg["strides"][s] if b == 0 else 1
                keys += _sc(p) if stride != 1 or cin != w else []
                cin = w
    elif name.startswith("DenseNet"):
        for s, n in enumerate(jmodel.nblocks):
            for b in range(n):
                p = f"dense{s + 1}.{b}"
                keys += [*bn_keys(f"{p}.bn1"), f"{p}.conv1.weight",
                         *bn_keys(f"{p}.bn2"), f"{p}.conv2.weight"]
            if s < 3:
                keys += [*bn_keys(f"trans{s + 1}.bn"),
                         f"trans{s + 1}.conv.weight"]
        keys += bn_keys("bn")
    elif name.startswith("DPN"):
        for s, n in enumerate(jmodel.cfg["num_blocks"]):
            for b in range(n):
                p = f"layer{s + 1}.{b}"
                keys += convs(p) + (_sc(p) if b == 0 else [])
    else:  # ShuffleNet: no parameters in the shortcut
        for s, n in enumerate(jmodel.cfg["num_blocks"]):
            keys += [k for b in range(n) for k in convs(f"layer{s + 1}.{b}")]
    return keys + ["linear.weight", "linear.bias"]


def reference_keys(name):
    """state_dict keys in the reference's definition order."""
    if name in REST:
        return _rest_keys(name)
    if name in ZOO[3:]:
        if name == "DLA":
            keys = []
            for stem in ("base", "layer1", "layer2"):
                keys += [f"{stem}.0.weight", *bn_keys(f"{stem}.1")]
            cin = STEMS[-1]
            for k, (cout, level, stride) in enumerate(TREES):
                keys += paper_tree_keys(f"layer{k + 3}", level,
                                        stride != 1 or cin != cout)
                cin = cout
            return keys + ["linear.weight", "linear.bias"]
        return _zoo_keys(name)
    if name == "SimpleDLA":
        keys = []
        for stem in ("base", "layer1", "layer2"):
            keys += [f"{stem}.0.weight", *bn_keys(f"{stem}.1")]
        cin = STEMS[-1]
        for k, (cout, level, stride) in enumerate(TREES):
            keys += tree_keys(f"layer{k + 3}", level,
                               stride != 1 or cin != cout)
            cin = cout
        return keys + ["linear.weight", "linear.bias"]
    if name == "MobileNet":
        keys = ["conv1.weight", *bn_keys("bn1")]
        for i in range(len(CFG)):
            p = f"layers.{i}"
            keys += [f"{p}.conv1.weight", *bn_keys(f"{p}.bn1"),
                     f"{p}.conv2.weight", *bn_keys(f"{p}.bn2")]
        return keys + ["linear.weight", "linear.bias"]
    keys = ["pre_layers.0.weight", "pre_layers.0.bias", *bn_keys("pre_layers.1")]
    for cell in ("a3", "b3", "a4", "b4", "c4", "d4", "e4", "a5", "b5"):
        for site in CELL_SITES:
            branch, i = site.split(".")
            keys += [f"{cell}.{site}.weight", f"{cell}.{site}.bias",
                     *bn_keys(f"{cell}.{branch}.{int(i) + 1}")]
    return keys + ["linear.weight", "linear.bias"]


def _move_before(keys, moved, anchor):
    """``keys`` with those starting with ``moved`` placed just before the
    first starting with ``anchor``."""
    mk = [k for k in keys if k.startswith(moved)]
    rest = [k for k in keys if not k.startswith(moved)]
    i = next(i for i, k in enumerate(rest) if k.startswith(anchor))
    return rest[:i] + mk + rest[i:]


def jax_call_order(keys):
    """``keys`` in the order the JAX model calls their modules, where it
    differs from the reference's definition order: each DLA Tree's root
    after its children, a paper-DLA tree's ``prev_root`` before its
    ``level_1``, a stride-2 PNASNet B cell's pool 1x1 (``conv1``/``bn1``)
    before its ``sep_conv3``, a pre-activation block's projection (a lone
    conv, off the activated input) before its ``conv1``. The JAX export
    pairs modules of one shape first-fit in the template's order, so in the
    reference's order it would hand, say, a root's BN the first block's, or
    PreActResNet50's first shortcut the block's ``conv3`` (both 64 -> 256
    1x1); in this order every pair is the named one. Other models' keys
    come back as they are."""
    keys = _roots_last(keys)
    for k in list(keys):
        if k.endswith(".shortcut.0.weight"):
            block = k[:-len("shortcut.0.weight")]
            if block + "shortcut.1.weight" not in keys:
                keys = _move_before(keys, block + "shortcut.",
                                    block + "conv1.")
        if k.endswith(".prev_root.conv1.weight"):
            tree = k[:-len("prev_root.conv1.weight")]
            keys = _move_before(keys, tree + "prev_root.", tree + "level_1.")
        if k.endswith(".sep_conv3.conv1.weight") and "." not in k[:-len(
                ".sep_conv3.conv1.weight")]:
            cell = k[:-len("sep_conv3.conv1.weight")]
            keys = _move_before(keys, (cell + "conv1.", cell + "bn1."),
                                cell + "sep_conv3.")
    return keys


def _roots_last(keys):
    out, roots = [], []  # roots: a stack of (tree prefix, its root keys)
    for k in keys:
        while roots and not k.startswith(roots[-1][0]):
            out += roots.pop()[1]
        if ".root." in k:
            prefix = k.split(".root.")[0] + "."
            if not roots or roots[-1][0] != prefix:
                roots.append((prefix, []))
            roots[-1][1].append(k)
        else:
            out.append(k)
    while roots:
        out += roots.pop()[1]
    return out


def nested_copy(tree):
    return {k: nested_copy(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def port_model_from_jax(name, params, stats):
    model = create_model(name)
    model.load_state_dict({
        k: torch.from_numpy(v)
        for k, v in state_dict_from_jax(name, params, stats).items()
    })
    return model.eval()


def logits(name, params, stats, x, dtype, jit=False):
    """The port's and the JAX model's eval logits of ``x`` in ``dtype``.
    The JAX forward runs eagerly unless ``jit`` (one compiled program: a
    deep model's eager forward compiles every op of each new shape, ~45 s
    for DenseNetCifar on the CPU)."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmodel = jax_create_model(
        name, dtype=None if dtype == torch.float32 else jnp.bfloat16
    )
    apply = functools.partial(jmodel.apply, train=False)
    want = np.asarray(
        (jax.jit(apply) if jit else apply)(
            {"params": params, "batch_stats": stats},
            jnp.asarray(x).astype(jdtype),
        ).astype(jnp.float32)
    )
    with torch.no_grad():
        xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
        got = port_model_from_jax(name, params, stats)(xt).float().numpy()
    return got, want


def bf16_case(name, trees, he, jit=False):
    params, stats = trees(name, he)
    x = np.random.RandomState(31).standard_normal((2, 32, 32, 3)).astype(
        np.float32
    )
    got, want = logits(name, params, stats, x, torch.bfloat16, jit)
    assert np.all(np.isfinite(got))
    return got, want, params, stats, x


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


WIDTHS = (8, 8, 16, 4, 8, 8)


CIN = 12


def cell_pair(merged, seed=40):
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


def cell_input(seed=41):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((4, 8, 8, CIN)).astype(np.float32)
    cot = rs.standard_normal((4, 8, 8, sum(WIDTHS) - 8 - 4)).astype(np.float32)
    return x, cot


LR, T_MAX, SPE = 0.1, 4, 3


def fan_in_trees(jmodel, seed):
    """(params, batch_stats) as numpy for the JAX model ``jmodel`` (a
    narrow variant too): fan-in-scaled kernels, non-trivial biases, BN
    affine and running stats."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False
    ))
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        key = path[-1].key
        if key == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rs.uniform(-bound, bound, s.shape).astype(np.float32)
        if key in ("scale", "var"):
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(leaf, shapes["params"]),
            jax.tree_util.tree_map_with_path(leaf, shapes["batch_stats"]))


def jax_trees(name, seed):
    """:func:`fan_in_trees` of the registered JAX ``name``."""
    return fan_in_trees(jax_create_model(name), seed)


def images(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    y = rs.randint(0, 10, n).astype(np.int32)
    return x, y


def port_state_from_jax(name, params, stats):
    model = create_model(name)
    model.load_state_dict({
        k: torch.from_numpy(v)
        for k, v in state_dict_from_jax(name, params, stats).items()
    })
    model = model.to(memory_format=torch.channels_last)
    return create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=LR),
        optim.cosine_epoch_schedule(LR, T_MAX, SPE), device="cpu",
    )


def train_step_vs_jax(name, n=32, seed=0):
    """One fp32 step of ``name`` from the same weights and batch (``n``
    images, the last two padded), augmentation off, in the JAX package and
    in the port, and the port's step in float64 compute as the reference.
    The forward's work is held here: the metric sums and the BN running
    statistics within rtol 1e-4. Returns, per tensor, each step's error in
    units of its update: ``(worst port vs float64, worst JAX vs float64,
    {tensor: port vs JAX})``, for the caller to hold at the model's own
    conditioning."""
    params, stats = jax_trees(name, seed=seed)
    x, y = images(n, seed=10)
    y[-2:] = -1  # padded rows: masked from loss, gradients and metrics
    tx = jax_optim.make_optimizer(lr=LR, t_max=T_MAX, steps_per_epoch=SPE)
    jmodel = jax_create_model(name)
    st = jax_state.create_train_state(jmodel, jax.random.PRNGKey(0), tx)
    as_jax = jax.tree_util.tree_map(jnp.asarray, params)
    st = st.replace(params=as_jax, opt_state=tx.init(as_jax),
                    batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    st, jm = jax.jit(jax_steps.make_train_step(augment=False))(
        st, (jnp.asarray(x), jnp.asarray(y)), jax.random.PRNGKey(1)
    )
    want = state_dict_from_jax(name, jax.device_get(st.params),
                               jax.device_get(st.batch_stats))
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    after, metrics = {}, {}
    for dtype in (torch.float32, torch.float64):
        state = port_state_from_jax(name, params, stats)
        before = {k: v.detach().clone().numpy()
                  for k, v in state.model.state_dict().items()}
        metrics[dtype] = steps.make_train_step(
            augment=False, device="cpu", compute_dtype=dtype
        )(state, batch)
        after[dtype] = {k: v.detach().numpy()
                        for k, v in state.model.state_dict().items()}
        assert state.step == 1
    pm = metrics[torch.float32]
    for k in steps.METRIC_KEYS:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert float(pm["count"]) == n - 2
    got, ref = after[torch.float32], after[torch.float64]
    errs = {"port": 0.0, "jax": 0.0}
    direct = {}
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running_" in k:
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            continue
        update = max(float(np.abs(ref[k] - before[k]).max()), 1e-30)
        assert update > 1e-30, f"{k} did not move"
        errs["port"] = max(errs["port"],
                           float(np.abs(got[k] - ref[k]).max()) / update)
        errs["jax"] = max(errs["jax"],
                          float(np.abs(w - ref[k]).max()) / update)
        direct[k] = float(np.abs(got[k] - w).max()) / update
    return errs["port"], errs["jax"], direct


def step_f64_vs_jax(name, jmodel, pmodel, n=4, seed=0, masks=False):
    """One step of the same weights and batch (``n`` images, the last one
    padded), augmentation off, computed in float64 on both sides: the JAX
    step on float64 parameters (``jax.enable_x64``), the port's on its fp32
    parameters with ``compute_dtype=torch.float64``. ``jmodel``/``pmodel``
    are the two packages' models of ``name`` (a narrow variant is fine).

    The JAX step runs eagerly, never as one compiled program: compiled on
    XLA:CPU, the JAX float64 step of a narrow PNASNetB moved its own loss
    by 3.3e-7 relative and its stem gradient by 0.4% against the eager
    step, which the port's step matches to 1e-7.

    With ``masks`` every mask the JAX step draws (``jax.random.bernoulli``:
    EfficientNet's drop-connect masks, then its dropout mask, from the
    step's own key) is recorded; the port's step draws exactly those, in
    the same order, through its model draw hook.

    Returns ``(port, jax)``, each ``{"metrics", "sd" (state dict after the
    step), "trace" (momentum: gradient + weight decay, in the port's
    layout), "before"}`` as numpy."""
    params, stats = fan_in_trees(jmodel, seed)
    x, y = images(n, seed=10)
    y[-1] = -1  # a padded row: masked from loss, gradients and metrics
    tx = jax_optim.make_optimizer(lr=LR, t_max=T_MAX, steps_per_epoch=SPE)
    drawn = []
    with jax.enable_x64(True):
        cast = functools.partial(jnp.asarray, dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(cast, params)
        st = jax_state.TrainState(
            step=jnp.zeros((), jnp.int32), params=p64,
            batch_stats=jax.tree_util.tree_map(cast, stats),
            opt_state=tx.init(p64), apply_fn=jmodel.apply, tx=tx)
        fn = jax_steps.make_train_step(augment=False,
                                       compute_dtype=jnp.float64)
        real = jax.random.bernoulli
        if masks:
            def record(key, p=0.5, shape=None, *a, **kw):
                m = real(key, p, shape, *a, **kw)
                drawn.append((float(p), np.asarray(m)))
                return m

            jax.random.bernoulli = record
        try:
            st, jm = fn(st, (jnp.asarray(x), jnp.asarray(y)),
                        jax.random.PRNGKey(1))
        finally:
            jax.random.bernoulli = real
        host = jax.device_get((st.params, st.batch_stats,
                               st.opt_state[1].trace, jm))
    jax_out = {
        "metrics": {k: float(v) for k, v in host[3].items()},
        "sd": state_dict_from_jax(name, host[0], host[1], model=pmodel),
        "trace": state_dict_from_jax(name, host[2], host[1], model=pmodel),
    }
    assert not masks or drawn, "the JAX step drew no mask"
    pmodel.load_state_dict({
        k: torch.from_numpy(v)
        for k, v in state_dict_from_jax(name, params, stats,
                                        model=pmodel).items()
    })
    pmodel = pmodel.to(memory_format=torch.channels_last)
    state = create_train_state(
        pmodel, optim.make_optimizer(pmodel.parameters(), lr=LR),
        optim.cosine_epoch_schedule(LR, T_MAX, SPE), device="cpu",
    )
    if masks:
        queue = list(drawn)

        def replay(shape, keep):
            p, m = queue.pop(0)
            assert (p, m.shape) == (keep, shape), (p, m.shape, keep, shape)
            return torch.from_numpy(np.array(m))

        state.model_draws = lambda shard=None: replay
    before = {k: v.detach().clone().numpy()
              for k, v in pmodel.state_dict().items()}
    pm = steps.make_train_step(augment=False, device="cpu",
                               compute_dtype=torch.float64)(
        state, (torch.from_numpy(x), torch.from_numpy(y)))
    assert not masks or not queue, f"{len(queue)} masks left undrawn"
    params_by_key = dict(pmodel.named_parameters())
    port_out = {
        "metrics": {k: float(v) for k, v in pm.items()},
        "sd": {k: v.detach().numpy() for k, v in
               pmodel.state_dict().items()},
        "trace": {k: state.optimizer.state[p]["momentum_buffer"].numpy()
                  for k, p in params_by_key.items()},
        "before": before,
    }
    jax_out["before"] = before
    return port_out, jax_out


def check_step_f64(port, jax_out, n):
    """The port's float64-compute step against the JAX float64 step:
    metric sums within rtol 1e-6; the momentum (gradient + weight decay),
    the updated parameters and the BN running statistics within rtol
    1e-5, atol 1e-6 of the tensor's largest value. Both steps compute in
    float64; the port keeps fp32 parameters, gradients, statistics and
    momentum, and the comparison reads the JAX tensors rounded to fp32, so
    each side carries fp32 rounding (6e-8 relative) and nothing more."""
    for k in steps.METRIC_KEYS:
        np.testing.assert_allclose(port["metrics"][k], jax_out["metrics"][k],
                                   rtol=1e-6, err_msg=k)
    assert port["metrics"]["count"] == n - 1
    moved = 0
    for kind in ("trace", "sd"):
        for k, got in port[kind].items():
            if k.endswith("num_batches_tracked"):
                continue
            w = jax_out[kind][k]
            tol = 1e-6 * float(np.abs(w).max())
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=tol,
                                       err_msg=f"{kind} {k}")
            moved += kind == "sd" and not np.array_equal(
                w, port["before"][k])
    assert moved > 0


# -- checks the family files share ---------------------------------------

def check_round_trip(name, trees):
    """JAX trees -> the port's state dict -> JAX trees, as raw bits."""
    from pytorch_cifar_tpu_torch.compat import jax_trees_from_state_dict

    params, stats = trees(name)
    sd = state_dict_from_jax(name, params, stats)
    back = jax_trees_from_state_dict(name, sd)
    for got, want in zip(back, (params, stats)):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (path, g), (_, w) in zip(flat_got, flat_want):
            assert g.dtype == w.dtype == np.float32, path
            np.testing.assert_array_equal(g.view(np.uint32),
                                          w.view(np.uint32), err_msg=path)


def _nested_bn_node(tree):
    """The first node below the top that holds a ``BatchNorm_j``."""
    for k in sorted(tree):
        v = tree[k]
        if not isinstance(v, dict):
            continue
        if any(c.startswith("BatchNorm") for c in v):
            return v, k
        found = _nested_bn_node(v)
        if found:
            return found
    return None


def check_refuses_a_leaf_off(name, edit, trees):
    """A tree with a BN leaf missing, an extra conv or extra statistics in
    a nested block (at the top of a flat tree, VGG's) is refused."""
    params, stats = trees(name)
    params, stats = nested_copy(params), nested_copy(stats)
    node, _ = _nested_bn_node(params) or (params, None)
    bn = next(k for k in sorted(node) if k.startswith("BatchNorm"))
    if edit == "missing":
        del node[bn]["scale"]
    elif edit == "extra":
        node["Conv_99"] = {"Conv_0": {"kernel": np.zeros((1, 1, 4, 4),
                                                         np.float32)}}
    else:
        snode, _ = _nested_bn_node(stats) or (stats, None)
        snode["BatchNorm_99"] = {"mean": np.zeros(4, np.float32)}
    with pytest.raises((KeyError, ValueError)):
        state_dict_from_jax(name, params, stats)

def _traced_init(create):
    """``create`` (a JAX ``create_model``) whose models' ``init`` runs
    under ``jax.eval_shape``: the JAX export records its model's call order
    through ``init``, and a traced ``init`` calls the modules in the same
    order (the recording interceptor runs at trace time) without running
    the model op by op (a minute for the zoo's deep models on the CPU)."""
    def make(*args, **kwargs):
        model = create(*args, **kwargs)
        init = model.init
        object.__setattr__(model, "init", lambda rng, x, **kw: jax.eval_shape(
            lambda r, v: init(r, v, **kw), rng, x))
        return model

    return make


def check_export(name, trees):
    """Key for key, the JAX package's export with the port's own template
    in the JAX model's call order; in the reference's key order."""
    from pytorch_cifar_tpu import compat as jax_compat
    from pytorch_cifar_tpu import models as jax_models

    params, stats = trees(name)
    template = {
        k: v.numpy() for k, v in create_model(name).state_dict().items()
    }
    real = jax_models.create_model
    jax_models.create_model = _traced_init(real)
    try:
        want = jax_compat.export_torch_state_dict(
            name, params, stats,
            template_sd={k: template[k] for k in jax_call_order(template)},
        )
    finally:
        jax_models.create_model = real
    got = state_dict_from_jax(name, params, stats)
    assert list(got) == list(template)
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def check_eval_fp32(name, trees, he=True, jit=False):
    params, stats = trees(name, he)
    x = np.random.RandomState(30).standard_normal((2, 32, 32, 3)).astype(
        np.float32
    )
    got, want = logits(name, params, stats, x, torch.float32, jit)
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def check_eval_bf16(name, he, trees):
    """The two bf16 forwards within 2% of the largest logit of each other.
    Each carries rounding noise of its own against the fp32 logits, and at
    these depths it is of the bound's size (JAX bf16 against JAX fp32, He
    kernels, three seeds: GoogLeNet 1.6-1.7%, MobileNet 1.3-2.4%), so the
    bound is held where the noise leaves room for it: GoogLeNet on He
    kernels (on 1 / sqrt(fan_in) kernels its logits shrink to 0.3, where
    one bf16 ulp alone is 0.7% of the largest), MobileNet on
    1 / sqrt(fan_in) kernels. :func:`check_bf16_error` holds both at He
    kernels against the fp32 logits."""
    got, want, *_ = bf16_case(name, trees, he)
    assert np.max(np.abs(got - want)) <= 0.02 * np.max(np.abs(want))


def check_bf16_error(name, trees, jit=False):
    """On He kernels, against the fp32 logits: the port's bf16 forward is
    no further off than 1.5 times the JAX bf16 forward's own error (on the
    CPU it is closer: its fused sites sum and apply BN in fp32 and round
    once). ``jit``: both JAX forwards compiled (see :func:`logits`)."""
    got, want, params, stats, x = bf16_case(name, trees, True, jit)
    _, ref = logits(name, params, stats, x, torch.float32, jit)
    assert np.max(np.abs(got - ref)) <= 1.5 * np.max(np.abs(want - ref))


# the zoo's models' (K3, K4 forward, K5) launches a folded forward, as
# the code gives them; chip_smoke.py's DEPTHWISE_SERVED and ZOO_REST_SERVED
# hold the same on the card. VGG: every conv; PreActResNet: each stride-1
# conv followed by a BN (a basic block's conv1, a bottleneck's conv2) and,
# in the bottleneck models, the stem with the first block's bn1; SENet,
# RegNet, DPN: the 3x3 stem (SENet also its stride-1 conv1s); ShuffleNet:
# the 13 stride-1 depthwise convs
KERNEL_SITES = {
    "DLA": (12, 0, 0), "MobileNetV2": (1, 0, 14),
    "EfficientNetB0": (0, 0, 12), "ShuffleNetV2_0.5": (1, 0, 13),
    "ShuffleNetV2_1": (1, 0, 13), "ShuffleNetV2_1.5": (1, 0, 13),
    "ShuffleNetV2_2": (1, 0, 13), "PNASNetA": (1, 18, 18),
    "PNASNetB": (1, 18, 54),
    "VGG11": (8, 0, 0), "VGG13": (10, 0, 0), "VGG16": (13, 0, 0),
    "VGG19": (16, 0, 0), "PreActResNet18": (5, 0, 0),
    "PreActResNet34": (13, 0, 0), "PreActResNet50": (14, 0, 0),
    "PreActResNet101": (31, 0, 0), "PreActResNet152": (48, 0, 0),
    "SENet18": (6, 0, 0), "ResNeXt29_2x64d": (0, 0, 0),
    "ResNeXt29_4x64d": (0, 0, 0), "ResNeXt29_8x64d": (0, 0, 0),
    "ResNeXt29_32x4d": (0, 0, 0), "RegNetX_200MF": (1, 0, 0),
    "RegNetX_400MF": (1, 0, 0), "RegNetY_400MF": (1, 0, 0),
    "DenseNet121": (0, 0, 0), "DenseNet161": (0, 0, 0),
    "DenseNet169": (0, 0, 0), "DenseNet201": (0, 0, 0),
    "DenseNetCifar": (0, 0, 0), "DPN26": (1, 0, 0), "DPN92": (1, 0, 0),
    "ShuffleNetG2": (0, 0, 13), "ShuffleNetG3": (0, 0, 13),
}


def kernel_sites(*names):
    """``(name, fused, pools, stencils)`` rows of :data:`KERNEL_SITES`,
    for ``test_kernel_sites_per_forward``'s parameters."""
    return [(n, *KERNEL_SITES[n]) for n in names]


def check_kernel_sites(name, fused, pools, stencils, monkeypatch):
    """GoogLeNet: the stem and each cell's three 3x3 convs are fused sites
    (1 + 9 * 3) and each cell pools once; MobileNet: the stem is fused and
    the 9 stride-1 depthwise convs are stencil sites (the 4 stride-2 ones
    are not); SimpleDLA and DLA: their three stems and the conv1 of each
    block that runs at stride 1 (9 of 12; 9 of 14). The other families'
    counts are in :data:`KERNEL_SITES`. Counted in the fold and in a
    forward's calls. A stencil site is depthwise (``groups == in == out``),
    k in 3, 5, 7, stride 1, and every such conv is one; a grouped conv that
    is not depthwise (ResNeXt's, RegNet's, DPN's 3x3s, ShuffleNet's 1x1s)
    and a depthwise conv at stride 2 stay ``F.conv2d`` sites."""
    model = create_model(name).eval()
    sites = list(folded_sites(model.fold(torch.float32)))
    assert sum(s.fused for s in sites) == fused
    assert sum(s.stencil for s in sites) == stencils
    for s in sites:
        if s.fused:
            assert s.weight.shape[:2] == (3, 3) and s.stride == 1
            assert s.act == "relu" and s.groups == 1
        elif s.stencil:
            k = s.weight.shape[0]
            assert s.weight.shape[1] == k and k in (3, 5, 7)
            assert s.stride == 1 and s.weight.shape[2] == s.groups
        else:  # OIHW: depthwise is (groups, 1, k, k)
            o, i, k, _ = s.weight.shape
            depthwise = s.groups == o and i == 1 and s.groups > 1
            assert not (depthwise and k in (3, 5, 7) and s.stride == 1)
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


def check_registry_is_the_jax_registry():
    """The port's registry holds exactly the JAX registry's 44 names, and
    an unknown name raises ``KeyError`` naming what the port has."""
    from pytorch_cifar_tpu.models import available_models as jax_models
    from pytorch_cifar_tpu_torch import models

    assert models.available_models() == jax_models()
    assert len(models.available_models()) == 44
    assert not hasattr(models, "NOT_PORTED")
    with pytest.raises(KeyError, match="NoSuchNet.*VGG16"):
        create_model("NoSuchNet")


def check_checkpoint_round_trip(name, tmp_path):
    """A JAX checkpoint (params, BN stats, momentum) restored by the port
    through the family's table and saved again gives the JAX payload's and
    sidecar's bytes back."""
    import os

    from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
    from pytorch_cifar_tpu_torch.train import checkpoint as ckpt
    from _torch_ckpt import jax_state, port_state

    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(a, jax_state(name, seed=4, step=11), 6, 12.5)
    ps = port_state(name)
    ckpt.restore_checkpoint(a, ps)
    ckpt.save_checkpoint(b, ps, 6, 12.5)
    for f in ("ckpt.msgpack", "ckpt.json"):
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def check_engine_under_load(name):
    """Engine, batcher and load generator, model-agnostic: padded buckets
    bit-identical to the direct forward, every request answered, and the
    served logits those of the model's own folded forward."""
    from pytorch_cifar_tpu_torch.data.augment import (
        CIFAR10_MEAN, CIFAR10_STD, normalize)
    from pytorch_cifar_tpu_torch.serve import (
        InferenceEngine, MicroBatcher, run_load)

    engine = InferenceEngine.from_random(
        name, seed=0, buckets=(1, 4), compute_dtype=torch.float32,
        device="cpu",
    )
    x, _ = images(3, seed=12)
    padded = engine.predict(x)
    np.testing.assert_array_equal(padded, engine.direct_forward(x))
    model = create_model(name, generator=torch.Generator().manual_seed(0))
    model.eval()
    with torch.no_grad():
        xn = normalize(torch.from_numpy(x), torch.tensor(CIFAR10_MEAN),
                       torch.tensor(CIFAR10_STD), torch.float32)
        want = model(xn.permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(padded, want, rtol=1e-5, atol=1e-6)
    batcher = MicroBatcher(engine, max_wait_ms=1.0)
    try:
        report = run_load(batcher, clients=2, requests_per_client=3,
                          images_max=3, seed=0)
    finally:
        batcher.close()
    assert report["failed"] == 0 and report["requests"] == 6
    assert engine.compile_count == 2


def check_serve_cli(name, capsys):
    import json

    from pytorch_cifar_tpu_torch.serve.__main__ import main as serve_main

    rc = serve_main([
        "--device", "cpu", "--model", name, "--dtype", "float32",
        "--buckets", "1", "4", "--clients", "2", "--requests", "2",
        "--verify",
    ])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["model"] == name and rec["failed"] == 0
    assert rec["kernel_launches"] == 0  # CPU tensors launch nothing
    assert set(rec["launches_by_kernel"]) == {
        "conv3x3_bn_relu", "max_pool3x3_s1", "depthwise_stencil"
    }
