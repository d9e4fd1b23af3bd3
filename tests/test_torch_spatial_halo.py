"""The row rule and the halo exchange of ``parallel/spatial.py``.

The rule is a pure function (no process group): every shard's output rows
and the input rows they read, over extents 32 / 16 / 8 / 4 / 5 (ResNet-18's
maps and LeNet's last) cut over 1, 2, 4 and 8 shards, shards with no row
and shards starting at an odd row under stride 2 among them. The mesh is
held against JAX's device order. A slab's global extent travels as a
mark, from the marked input through the ops between window ops (an
activation, a sum, a split, a concatenation); a slab with no mark, or
whose mark does not cut to its shape, raises (no process group either).

Then every windowed layer of ``models.common`` (convs of k 1 / 3 / 5 at
stride 1 / 2 and padding 0 / 1 / 2, max pools through ``F.max_pool2d`` and
through the K4 seam, average pools, a pool and a mean over the whole map,
LeNet's gather for its flatten) runs on gloo ranks, each on its slab of
one input under ``spatial_partition``, height cut over 2 and 4 ranks and
height x width over 2 x 2, on 11- and 12-pixel maps (uneven slabs, a rank
with no output row) and on a 3-row map over 4 ranks (a rank with no input
row). The slabs' outputs and input gradients, put together, equal the
unsharded layer's on the CPU within rtol 1e-5, atol 1e-6 in fp32. The
cotangent of an output every rank of a spatial group holds whole (a
gather, a mean over the map) is split evenly over the group, as the train
step's loss is.
"""

import functools

import numpy as np
import pytest
import torch

from pytorch_cifar_tpu_torch.parallel import spatial
from pytorch_cifar_tpu_torch.parallel.spatial import (
    SpatialMesh,
    SpatialPartition,
    exchange_plan,
    make_spatial_mesh,
    rows_needed,
    shard_range,
)
from _torch_spatial import run_job
from _torch_threads import torch_threads  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
EXTENTS = (32, 16, 8, 4, 5)
SHARDS = (1, 2, 4, 8)
WINDOWS = {  # name: (k, stride, padding)
    "k1s1": (1, 1, 0), "k1s2": (1, 2, 0), "k3s1p1": (3, 1, 1),
    "k3s2p1": (3, 2, 1), "k5s1p2": (5, 1, 2), "k5s1p0": (5, 1, 0),
    "k2s2": (2, 2, 0), "k3s1p0": (3, 1, 0),
}


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("extent", EXTENTS)
def test_shard_range_cuts_in_order(extent, n):
    """The shards own disjoint rows in order, ``ceil(extent / n)`` each
    until the rows run out; the rest own none."""
    ranges = [shard_range(extent, i, n) for i in range(n)]
    per = -(-extent // n)
    at = 0
    for lo, hi in ranges:
        assert lo == min(at, extent) and hi - lo == min(per, extent - lo)
        at = hi
    assert at == extent
    empty = sum(lo == hi for lo, hi in ranges)
    assert empty == n - -(-extent // per)


@pytest.mark.parametrize("extent,window", [
    (e, w) for e in EXTENTS for w in sorted(WINDOWS)
    if e + 2 * WINDOWS[w][2] >= WINDOWS[w][0]])  # the window fits the map
def test_rows_needed_reads_each_window(extent, window):
    """Each shard's input rows span exactly the windows of the outputs it
    owns (padding below 0 and past the extent included), and the plan's
    sends fill the rest of them from their owners, in order."""
    k, stride, padding = WINDOWS[window]
    for n in SHARDS:
        plan = exchange_plan(k, stride, padding, extent, n)
        outs = []
        for j in range(n):
            r = rows_needed(k, stride, padding, extent, j, n)
            assert r.own == shard_range(extent, j, n)
            assert r.out == shard_range(r.out_extent, j, n)
            outs.append(r.out)
            if r.out[0] == r.out[1]:
                assert r.need == (0, 0)
                continue
            read = [o * stride - padding + t for o in range(*r.out)
                    for t in range(k)]
            assert r.need == (min(read), max(read) + 1)
            # the rows inside the image come from their owners, in order
            a, b = max(r.need[0], 0), min(r.need[1], extent)
            got = []
            for i in range(n):
                lo, hi = (max(r.own[0], a), min(r.own[1], b)) if i == j \
                    else plan[i][j]
                got.extend(range(lo, hi))
            assert got == list(range(a, b))
        assert outs[-1][1] == r.out_extent


def test_odd_start_under_stride_two_reads_from_the_next_ranks():
    """ResNet's stride-2 3x3 conv on an 8-row map over 8 ranks (layer 3 to
    layer 4 at ``spatial_devices=8``): rank 1 owns output row 1, which
    reads input rows 1-3, two of them from ranks 2 and 3; ranks 4-7 own no
    output row but still send theirs."""
    r = rows_needed(3, 2, 1, 8, 1, 8)
    assert (r.out, r.own, r.need) == ((1, 2), (1, 2), (1, 4))
    plan = exchange_plan(3, 2, 1, 8, 8)
    assert plan[2][1] == (2, 3) and plan[3][1] == (3, 4)
    assert plan[4][2] == (4, 5) and plan[5][2] == (5, 6)
    for j in range(4, 8):
        assert rows_needed(3, 2, 1, 8, j, 8).out == (4, 4)


def test_lenet_five_rows_split_three_and_two():
    """LeNet's 10-row map pooled 2 / 2 over two ranks: 3 output rows and 2,
    rank 0 reading row 5 from rank 1."""
    r0, r1 = (rows_needed(2, 2, 0, 10, j, 2) for j in range(2))
    assert (r0.out, r1.out) == ((0, 3), (3, 5))
    assert (r0.need, r1.need) == ((0, 6), (6, 10))
    assert exchange_plan(2, 2, 0, 10, 2)[1][0] == (5, 6)


def _lone_partition(s, spatial_n, image_hw=(32, 32)):
    """Shard ``s`` of a ``(1, spatial_n, 1)`` mesh with no process group
    (the extent marks need none)."""
    part = object.__new__(SpatialPartition)
    part.mesh = SpatialMesh(1, spatial_n, 1)
    part.rank, part.d, part.s, part.w = s, 0, s, 0
    part.image_hw = image_hw
    return part


def test_extent_marks_follow_the_ops_between_window_ops():
    """The input's mark reaches an activation, a sum, a BN-style scale, a
    split's parts and a concatenation of channels; a slice of other rows
    takes none."""
    import torch.nn.functional as F

    part = _lone_partition(1, 4)  # image rows 8-15 of 32
    with spatial.spatial_partition(part):
        x = spatial.mark_input(torch.randn(2, 6, 8, 32))
        act = spatial.active()
        y = F.relu(x) * torch.ones(1, 6, 1, 1) + x
        a, b = y.split([2, 4], dim=1)
        z = torch.cat([b, a], dim=1)
        for t in (y, a, b, z):
            assert act.extent_of(t) == (32, 32)
        with pytest.raises(RuntimeError, match="carries no global extent"):
            act.extent_of(x[:, :, :5])
    assert getattr(x.relu(), "_spatial_extent", None) is None  # off


@pytest.mark.parametrize("s,n,extent,rows", [
    (0, 2, (5, 5), 2),   # 5 rows cut 3 / 2: shard 0 holds 3, not 2
    (3, 4, (5, 5), 1),   # shard 3 of a 5-row map holds none
    (7, 8, (28, 28), 4),  # shard 7 of 28 rows holds none
])
def test_a_mark_that_does_not_cut_to_the_slab_raises(s, n, extent, rows):
    """A slab whose mark cuts to another shape on this rank raises, so no
    rank computes an exchange plan from another rank's extent."""
    part = _lone_partition(s, n)
    with spatial.spatial_partition(part):
        x = spatial.mark(torch.zeros(1, 1, rows, extent[1]), extent)
        with pytest.raises(RuntimeError, match="which cuts to"):
            spatial.active().extent_of(x)


@pytest.mark.parametrize("hw,mesh,want", [
    ((32, 32), (1, 2, 1), [(18, 32)]),
    ((4, 4), (2, 2, 1), [(4, 4)]),
    ((16, 16), (1, 2, 2), [(10, 10)]),
    ((32, 32), (1, 4, 1), [(10, 32)]),
    ((4, 4), (1, 4, 1), [(3, 4)]),
    ((5, 5), (1, 4, 1), [(3, 5), (4, 5)]),  # 2 / 2 / 1 / 0 rows
])
def test_slab_shapes_are_the_kernels_extended_slabs(hw, mesh, want):
    """The shapes ``chip_smoke.py`` holds K3 and K4 at on the card: a row
    a side along each cut dimension, of the ranks that own an output."""
    from pytorch_cifar_tpu_torch.tools.spatial_runs import slab_shapes

    assert slab_shapes(*hw, mesh) == want


def test_logits_off_reads_each_data_index_once():
    """The spatial logits are put together from the first rank of each
    spatial group, in data order, and read against one process's in
    units of the tolerance."""
    from pytorch_cifar_tpu_torch.tools.spatial_runs import logits_off

    want = torch.tensor([[1.0, -2.0], [0.5, 3.0]])
    rows = [{"coords": (d, s, 0), "logits": want[d:d + 1].clone()}
            for d in (0, 1) for s in (0, 1)]
    rows[0]["one_process"] = {"logits": want}
    assert logits_off(rows) == 0.0
    rows[2]["logits"] = torch.tensor([[0.5, 3.0 + 2.2e-3]])
    assert 0.5 < logits_off(rows) < 1.0
    rows[3]["logits"] = torch.zeros(1, 2)  # not a first rank: not read
    assert logits_off(rows) < 1.0


def test_mesh_matches_jax_device_order():
    """Rank ``(d * S + s) * W + w`` is the device at ``[d, s, w]`` of JAX's
    ``make_spatial_mesh``, and both raise on a world the product does not
    divide."""
    import jax

    from pytorch_cifar_tpu.parallel.spatial import (
        make_spatial_mesh as jax_mesh,
    )

    for shape in ((2, 2, 2), (4, 2, 1), (1, 4, 2)):
        jm = jax_mesh(*shape)
        pm = make_spatial_mesh(*shape, world=8)
        assert pm.shape == dict(jm.shape)
        ids = np.vectorize(lambda dev: dev.id)(jm.devices).reshape(shape)
        for r in range(8):
            assert ids[pm.coords(r)] == jax.devices()[r].id == r
    with pytest.raises(ValueError, match="must divide device count 8"):
        make_spatial_mesh(spatial=3, world=8)
    with pytest.raises(ValueError, match="must divide device count 8"):
        jax_mesh(spatial=3)
    with pytest.raises(ValueError, match="exceeds 8 devices"):
        make_spatial_mesh(data=4, spatial=4, world=8)


# -- the layers on gloo ranks -----------------------------------------------

OPS = {  # name: (op, input size)
    "conv_k1s1": ({"kind": "conv", "k": 1, "stride": 1, "padding": 0}, 12),
    "conv_k1s2": ({"kind": "conv", "k": 1, "stride": 2, "padding": 0}, 12),
    "conv_k3s1p1": ({"kind": "conv", "k": 3, "stride": 1, "padding": 1}, 11),
    "conv_k3s2p1": ({"kind": "conv", "k": 3, "stride": 2, "padding": 1}, 12),
    "conv_k3s2p1_odd": ({"kind": "conv", "k": 3, "stride": 2,
                         "padding": 1}, 11),
    "conv_k5s1p2": ({"kind": "conv", "k": 5, "stride": 1, "padding": 2}, 12),
    "conv_k5s1p0": ({"kind": "conv", "k": 5, "stride": 1, "padding": 0}, 12),
    "conv_k5s2p2": ({"kind": "conv", "k": 5, "stride": 2, "padding": 2}, 11),
    "conv_k3s1p1_tiny": ({"kind": "conv", "k": 3, "stride": 1,
                          "padding": 1}, 3),
    "max_k2s2": ({"kind": "max", "k": 2, "stride": 2, "padding": 0}, 10),
    "max_k3s2p1": ({"kind": "max", "k": 3, "stride": 2, "padding": 1}, 11),
    "max_k3s1p1": ({"kind": "max", "k": 3, "stride": 1, "padding": 1}, 11),
    "avg_k2s2": ({"kind": "avg", "k": 2, "stride": 2, "padding": 0}, 12),
    "avg_k3s2p1": ({"kind": "avg", "k": 3, "stride": 2, "padding": 1}, 11),
    "avg_whole_map": ({"kind": "avg", "k": 12, "stride": 1,
                       "padding": 0}, 12),
    "global_mean": ({"kind": "global"}, 11),
    "gather": ({"kind": "gather"}, 5),
}
MESHES = {"h2": (1, 2, 1), "h4": (1, 4, 1), "h2w2": (1, 2, 2)}
CIN, COUT, BATCH = 3, 4, 2


def _case(name):
    """The op, its input and its cotangent, drawn from the case's name."""
    op, size = OPS[name]
    rs = np.random.RandomState(sum(map(ord, name)))
    op = dict(op)
    if op["kind"] == "conv":
        k = op["k"]
        op.update(cin=CIN, cout=COUT,
                  weight=rs.standard_normal((COUT, CIN, k, k)).astype(
                      np.float32) * 0.3,
                  bias=rs.standard_normal(COUT).astype(np.float32))
    x = rs.standard_normal((BATCH, CIN, size, size)).astype(np.float32)
    if op["kind"] == "max":
        x[0, 0, :, 1] = x[0, 0, :, 2]  # ties: the first in the window wins
    y = _reference(op, torch.from_numpy(x))[0]
    g = rs.standard_normal(tuple(y.shape)).astype(np.float32)
    return op, x, g


def _layer(op):
    import torch.nn.functional as F

    if op["kind"] == "conv":
        w, b = torch.from_numpy(op["weight"]), torch.from_numpy(op["bias"])
        return lambda x: F.conv2d(x, w, b, op["stride"], op["padding"])
    if op["kind"] == "max":
        return lambda x: F.max_pool2d(x, op["k"], op["stride"],
                                      op["padding"])
    if op["kind"] == "avg":
        return lambda x: F.avg_pool2d(x, op["k"], op["stride"],
                                      op["padding"])
    if op["kind"] == "global":
        return lambda x: x.mean(dim=(2, 3))
    return lambda x: x


def _reference(op, x):
    """The unsharded layer's output and input gradient (for a cotangent
    of ones until the case draws its own)."""
    x = x.clone().requires_grad_(True)
    y = _layer(op)(x)
    return y, x


@functools.lru_cache(maxsize=None)
def _cases():
    return {name: _case(name) for name in OPS}


def _tasks(meshes):
    return [{"name": f"{name}@{m}", "kind": "op", "mesh": MESHES[m],
             "op": _cases()[name][0], "x": _cases()[name][1],
             "g": _cases()[name][2]}
            for m in meshes for name in OPS]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results on every rank: one job of 2 ranks, one of 4."""
    root = tmp_path_factory.mktemp("halo")
    two = run_job(_tasks(["h2"]), str(root / "two"), world=2)
    four = run_job(_tasks(["h4", "h2w2"]), str(root / "four"), world=4)
    return {"h2": two, "h4": four, "h2w2": four}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(OPS))
def test_slabs_equal_the_unsharded_layer(ranks, name, mesh):
    op, x, g = _cases()[name]
    y_ref, xr = _reference(op, torch.from_numpy(x))
    (y_ref * torch.from_numpy(g)).sum().backward()
    results = [r[f"{name}@{mesh}"] for r in ranks[mesh]]
    gx = torch.zeros_like(xr)
    whole = y_ref.dim() == 2 or op["kind"] == "gather" or (
        op["kind"] == "avg" and op["k"] == x.shape[2])
    y = torch.full_like(y_ref, float("nan"))
    for res in results:
        (h0, h1), (w0, w1) = res["box"]
        gx[:, :, h0:h1, w0:w1] = res["gx"]
        if whole:
            # every rank holds the whole output
            np.testing.assert_allclose(res["y"].reshape(y_ref.shape),
                                       y_ref.detach(), RTOL, ATOL)
            continue
        (o0, o1), (p0, p1) = res["out_box"]
        y[:, :, o0:o1, p0:p1] = res["y"]
    if not whole:
        np.testing.assert_allclose(y, y_ref.detach(), RTOL, ATOL)
    np.testing.assert_allclose(gx, xr.grad, RTOL, ATOL)
    counts = [res["counts"] for res in results]
    if op["kind"] in ("conv", "max", "avg") and not whole:
        # windows that overlap cross the slabs' edges: rows moved. Where
        # the map and the output split evenly over the line, no send carries
        # more rows than the op's reach (an uneven output shifts whole rows
        # between ranks)
        if op["k"] > op["stride"] and x.shape[2] > 3:
            assert sum(c["halo_sends"] for c in counts) > 0
        line = max(MESHES[mesh][1:])
        if not (x.shape[2] % line or y_ref.shape[2] % line):
            assert all(c["halo_over_reach"] == 0 for c in counts)
    if op["kind"] == "gather":
        assert all(c["gathers"] == 1 for c in counts)
