"""The schedule of the port's one-launch BN-moments kernel (K2), on the CPU.

The kernel runs only on the card (``chip_smoke.py``'s moments phase); what
makes it deterministic is its schedule: blocks reduce chunks of rows in an
order fixed by the shape, each draws an integer ticket for its channel
tile, and whichever block draws the last one sums the tile's partials in
chunk order and resets the counter. That schedule is simulated here in
torch, with the chunking and constants read from ``csrc/bn_stats.cu``,
and held to two things: the same bits for every order in which the blocks
finish, and the plain version's moments within the limits
``chip_smoke.py`` holds the kernel to (rtol 1e-4, atol 1e-5 against
float64). The simulation's fp32 sums follow the kernel's order; its
``fmaf`` is a float64 product and sum rounded once, so it shows the
schedule, not the card's last bits.
"""

import re

import numpy as np
import pytest
import torch

from pytorch_cifar_tpu_torch.ops import _build
from pytorch_cifar_tpu_torch.ops import bn_stats
from _torch_threads import torch_threads  # noqa: F401

SRC = (_build.CSRC / "bn_stats.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


THREADS = _const("kThreads")
WARPS = THREADS // 32
TARGET_BLOCKS = _const("kTargetBlocks")
MIN_ROWS_PER_THREAD = _const("kMinRowsPerThread")


def moments_plan(rows: int, c: int, vec: int, elem: int):
    """``fused_moments_plan``'s chunking: (rows_per_block, chunks, tiles)
    and the thread layout (V, TX)."""
    ct = 64 if vec else 32
    tx = ct // (16 // elem) if vec else 32
    tiles = -(-c // ct)
    want = max(1, TARGET_BLOCKS // tiles)
    rpb = max(-(-rows // want), (THREADS // tx) * MIN_ROWS_PER_THREAD)
    rpb = -(-rpb // 32) * 32
    return rpb, -(-rows // rpb), tiles, ct // tx, tx


def _fma(f, b):
    return (f.double() * f.double() + b.double()).float()


def _block_partial(x, k, y, rpb, v, tx):
    """One block's (2, CT) partial: each thread (tx, ty) walks rows r0 + ty,
    r0 + ty + TY, ... of its V channels from +0; the row-threads of a warp
    meet by xor shuffles (offsets TX, 2 TX, ...), the warps in order."""
    rows, c = x.shape
    ty_n, ct = THREADS // tx, tx * v
    chunk = x[k * rpb:min((k + 1) * rpb, rows), y * ct:(y + 1) * ct]
    chunk = torch.nn.functional.pad(
        chunk, (0, ct - chunk.shape[1], 0, -chunk.shape[0] % ty_n))
    steps = chunk.view(-1, ty_n, ct)  # zero rows add +0 to a sum that is +0
    a = torch.zeros(ty_n, ct)
    b = torch.zeros(ty_n, ct)
    for s in steps:
        a, b = a + s, _fma(s, b)
    per_warp = 32 // tx
    out = []
    for acc in (a, b):
        warps = acc.view(WARPS, per_warp, ct)
        off = 1
        while off < per_warp:  # lane ^ (off * TX): row-thread i ^ off
            idx = torch.arange(per_warp) ^ off
            warps = warps + warps[:, idx]
            off *= 2
        s = warps[0, 0]
        for w in range(1, WARPS):
            s = s + warps[w, 0]
        out.append(s)
    return torch.stack(out)


def simulate(x: torch.Tensor, vec: int, elem: int, finish_order,
             tickets: torch.Tensor) -> torch.Tensor:
    """One launch: blocks finish in ``finish_order`` (a permutation of the
    (chunk, tile) blocks); each writes its partial and draws a ticket, and
    the block that draws its tile's last one sums that tile's partials —
    only those written so far — in chunk order over P = 256 / (2 CT)
    strided parts, divides by rows and resets the counter."""
    rows, c = x.shape
    rpb, chunks, tiles, v, tx = moments_plan(rows, c, vec, elem)
    ct = tx * v
    parts = THREADS // (2 * ct)
    partial = torch.full((chunks, 2, tiles * ct), float("nan"))
    out = torch.full((2, tiles * ct), float("nan"))
    for k, y in finish_order:
        partial[k, :, y * ct:(y + 1) * ct] = _block_partial(x, k, y, rpb, v,
                                                            tx)
        tickets[y] += 1
        if tickets[y] != chunks:
            continue
        fin = torch.zeros(parts, 2, ct)
        for p in range(parts):
            for kk in range(p, chunks, parts):
                fin[p] = fin[p] + partial[kk, :, y * ct:(y + 1) * ct]
        t = fin[0]
        for p in range(1, parts):
            t = t + fin[p]
        out[:, y * ct:(y + 1) * ct] = t / rows
        tickets[y] = 0
    return out[:, :c]


CASES = [  # (n, h, w, c, dtype, vec)
    (16, 8, 8, 64, torch.bfloat16, 1),  # 4 chunks of one tile
    (4, 8, 8, 130, torch.float32, 0),   # the scalar path, 5 tiles
    (2, 16, 16, 72, torch.bfloat16, 1),  # a ragged last chunk and tile
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(
    map(str, c[:4])) + ("-bf16" if c[4] == torch.bfloat16 else "-fp32"))
def test_every_finishing_order_gives_the_same_bits(case):
    """Five orders of the blocks' finishing (in grid order, reversed and
    three shuffles): identical bits, the counters back at 0 after each
    launch, and the plain version's moments within rtol 1e-4, atol 1e-5
    of float64."""
    n, h, w, c, dtype, vec = case
    rs = np.random.RandomState(c)
    x = torch.from_numpy((rs.randn(n * h * w, c) + 0.5).astype(np.float32))
    x = x.to(dtype).float()  # the kernel reads the bf16 values
    elem = torch.tensor([], dtype=dtype).element_size()
    _, chunks, tiles, _, _ = moments_plan(n * h * w, c, vec, elem)
    assert chunks > 1
    blocks = [(k, y) for y in range(tiles) for k in range(chunks)]
    orders = [blocks, blocks[::-1]] + [
        [blocks[i] for i in rs.permutation(len(blocks))] for _ in range(3)]
    tickets = torch.zeros(tiles, dtype=torch.int64)
    results = [simulate(x, vec, elem, order, tickets) for order in orders]
    assert (tickets == 0).all()
    for r in results[1:]:
        assert torch.equal(r.view(torch.int32), results[0].view(torch.int32))
    mean, sq = bn_stats.fused_moments_reference(
        x.double().view(n, h, w, c))
    for got, want in zip(results[0], (mean, sq)):
        torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("h,c", [(32, 64), (16, 128), (8, 256), (4, 512)])
@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "fp32"])
def test_plan_at_resnet18_shapes(h, c, elem):
    """At ResNet-18's four BN shapes at n = 512: the chunks cover every
    row once, each thread walks at least ``kMinRowsPerThread`` rows, and
    the grid is about two blocks an SM (264), one launch's worth."""
    rows = 512 * h * h
    rpb, chunks, tiles, v, tx = moments_plan(rows, c, 1, elem)
    assert rpb % 32 == 0 and (chunks - 1) * rpb < rows <= chunks * rpb
    assert rpb // (THREADS // tx) >= MIN_ROWS_PER_THREAD
    assert tiles * tx * v >= c and 128 <= chunks * tiles <= 2 * TARGET_BLOCKS
    assert v == 16 // elem


def test_source_is_one_launch_without_float_atomics():
    """The kernel's source launches one kernel, takes its tickets with an
    integer atomicAdd, resets them, and adds no float atomically."""
    assert len(re.findall(r"<<<", SRC)) == 1
    assert "atomicAdd(&tickets[blockIdx.y], 1)" in SRC
    assert "tickets[blockIdx.y] = 0;" in SRC
    assert not re.search(r"atomicAdd\((?!&tickets)", SRC)
    assert "moments_finalize" not in SRC
