"""Spatial partitioning of the depthwise families (MobileNet, MobileNetV2,
ShuffleNet, ShuffleNetV2), PNASNet and EfficientNet on gloo ranks
(helpers: ``tests/_torch_spatial_zoo.py``).

One registry name a family takes one train step over the ``(data, spatial,
spatial_w)`` meshes (1, 2, 1) and (1, 2, 2) against the port's one-process
step on the global batch, in float64 compute (fp32 parameters) at the
float64 tolerances, augmentation on, and its folded eval forward against
the one-process eval step: there every stride-1 depthwise site runs the
depthwise stencil (kernel K5; its plain version on the CPU) on the slab
extended by ``k // 2`` rows a side and cropped after
(``common.conv_bn`` through ``spatial.same_op``), PNASNet's stride-1
cells pool through K4 the same way.

- The stencil site alone, against one process's on the whole map, output
  and input gradient: k = 7 on a 4x4 map over 2 ranks (a 3-row halo, wider
  than a rank's 2 rows) and over 4 (one row a rank: rows come from ranks
  up to 3 away), k = 5 on a 2x2 map cut in height and width, k = 3 on a
  2x2 map over 4 ranks, two of which own no row.
- ``channel_shuffle`` keeps its input's extent through its NHWC and 5-d
  steps (else the next window op would raise).
- EfficientNet's drop-connect and dropout masks are the global batch's
  draws, cut to each data shard's rows: the same on every rank of a
  spatial group, and at (2, 2, 1) the one-process step's masks.
"""

import numpy as np
import pytest
import torch

from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.train import optim, steps
from pytorch_cifar_tpu_torch.train.state import create_train_state
from _torch_spatial import _layer
from _torch_threads import torch_threads  # noqa: F401
import _torch_spatial_zoo as zoo

MODELS = {
    "MobileNet": zoo.Case(),
    "MobileNetV2": zoo.Case(),
    "ShuffleNetG2": zoo.Case(),
    "ShuffleNetV2_1": zoo.Case(),
    "PNASNetA": zoo.Case(),
    "PNASNetB": zoo.Case(),
    "EfficientNetB0": zoo.Case(),
}


def _stencil(k, c, hw, seed):
    rs = np.random.RandomState(seed)
    return {"kind": "stencil",
            "weight": rs.uniform(-0.5, 0.5, (c, 1, k, k)).astype(np.float32),
            "scale": rs.uniform(0.5, 1.5, c).astype(np.float32),
            "shift": (0.1 * rs.standard_normal(c)).astype(np.float32)}, hw


OPS = {  # task: (op, input map (h, w), mesh)
    "stencil7@1x2x1": (*_stencil(7, 8, (4, 4), 30), (1, 2, 1)),
    "stencil7@1x4x1": (*_stencil(7, 8, (4, 4), 31), (1, 4, 1)),
    "stencil5@1x2x2": (*_stencil(5, 8, (2, 2), 32), (1, 2, 2)),
    "stencil3@1x4x1": (*_stencil(3, 8, (2, 2), 33), (1, 4, 1)),
    "shuffle@1x2x2": ({"kind": "shuffle", "groups": 2}, (8, 8), (1, 2, 2)),
}
# EfficientNetB0's draws a step: 14 drop-connect masks (n, 1, 1, 1), then
# the head's dropout mask (n, 320)
DRAW_SHAPES = [((4, 1, 1, 1), 0.9)] * 14 + [((4, 320), 0.8)]
DRAWS = "draws@2x2x1"


def _op_task(name):
    op, (h, w), mesh = OPS[name]
    rs = np.random.RandomState(40)
    c = op["weight"].shape[0] if op["kind"] == "stencil" else 12
    return {"name": name, "kind": "op", "op": op, "mesh": mesh,
            "x": rs.standard_normal((4, c, h, w)).astype(np.float32),
            "g": rs.standard_normal((4, c, h, w)).astype(np.float32)}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tasks = zoo.family_tasks(MODELS)
    tasks += [_op_task(name) for name in OPS]
    tasks.append({"name": DRAWS, "kind": "draws", "mesh": (2, 2, 1),
                  "seed": 4, "step": 3,
                  "draws": [((s[0] // 2, *s[1:]), keep)
                            for s, keep in DRAW_SHAPES]})
    return zoo.run_tasks(tasks,
                         tmp_path_factory.mktemp("spatial_zoo_depthwise"))


@pytest.mark.parametrize("mesh", sorted(zoo.MESHES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_matches_one_process(jobs, name, mesh):
    zoo.check_step(jobs[zoo.step_name(name, mesh)], name, MODELS[name])


@pytest.mark.parametrize("mesh", sorted(zoo.MESHES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_matches_one_process(jobs, name, mesh):
    zoo.check_eval(jobs[zoo.eval_name(name, mesh)], name,
                   MODELS[name].batch)


@pytest.mark.parametrize("task", sorted(OPS))
def test_op_on_slabs_matches_one_process(jobs, task):
    """Each rank's output slab and input-gradient slab are its box of the
    one-process op's on the whole map."""
    t = _op_task(task)
    x = torch.from_numpy(t["x"]).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    y = _layer(t)(x)
    (y * torch.from_numpy(t["g"])).sum().backward()
    for r in jobs[task]:
        (h0, h1), (w0, w1) = r["box"]
        (o0, o1), (p0, p1) = r["out_box"]
        np.testing.assert_allclose(r["y"].detach().numpy(),
                                   y.detach()[:, :, o0:o1, p0:p1].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["gx"].numpy(),
                                   x.grad[:, :, h0:h1, w0:w1].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_stencil_halo_wider_than_a_rank(jobs):
    """k = 7's 3-row halo: over 4 ranks of a 4-row map each rank takes rows
    from ranks up to 3 away (sends of one row each), and over 2 ranks a
    send carries both of a rank's rows; no send carries more than the
    op reads."""
    for task, most in (("stencil7@1x2x1", 2), ("stencil7@1x4x1", 1)):
        for r in jobs[task]:
            c = r["counts"]
            assert c["halo_max_rows"] == most and c["halo_over_reach"] == 0
    # rank 0 of the 4: rows 1, 2 and 3 come from ranks 1, 2 and 3
    assert jobs["stencil7@1x4x1"][0]["counts"]["halo_exchanges_h"] == 1
    assert [r["y"].shape[2] for r in jobs["stencil3@1x4x1"]] == [1, 1, 0, 0]


def test_pnasnet_sends_its_widest_halo(jobs):
    """PNASNet's k = 7 separable convs read 3 rows a side: the widest send
    of a step carries 3 rows, none more."""
    for mesh in zoo.MESHES:
        for r in jobs[zoo.step_name("PNASNetA", mesh)]:
            assert r["counts"]["halo_max_rows"] == 3
            assert r["counts"]["halo_over_reach"] == 0


def test_efficientnet_masks_equal_over_a_spatial_group(jobs):
    """At (2, 2, 1) the two ranks of each data index draw the same masks,
    and the data indices' masks are the rows of the one-process step's
    draws for the global batch."""
    results = jobs[DRAWS]
    model = create_model("LeNet")
    state = create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=0.1),
        optim.cosine_epoch_schedule(0.1, 4, 3), seed=4, device="cpu")
    state.step = 3
    draw = steps._model_draws(state, None, None)
    want = [draw(shape, keep) for shape, keep in DRAW_SHAPES]
    for r in (0, 2):
        for a, b in zip(results[r], results[r + 1]):
            assert torch.equal(a, b)
    for i, w in enumerate(want):
        got = torch.cat([results[0][i], results[2][i]])
        assert torch.equal(got, w)
        assert 0 < int(w.sum()) < w.numel() or w.numel() < 8
