"""The host-side plans of the port's 3x3 max-pool kernels (K4, forward and
backward), and the rules those kernels compute, on the CPU.

The kernels run only on the card (``chip_smoke.py``,
``tools/pool_bench.py``); what decides their tiles is plain Python that
these tests reach: every output is written once, every plan fits the
shared memory of the blocks an SM it is built for, and the source builds
what the plans assume. The forward's separable ``max_h(max_w(x))`` and the
backward's banded gather (a 255 / zero border, fp32 sums in tap order, a
selected +0 for an unmatched tap) are written here in torch with the
kernels' band split and held bit for bit against the plain versions on the
inputs where they could slip: ties, +-0, NaNs and infinities, -inf windows
and values on band edges.
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_cifar_tpu_torch.ops import _build
from pytorch_cifar_tpu_torch.ops import max_pool as P
from pytorch_cifar_tpu_torch.tools._bench import POOL_ODD, POOL_SHAPES
from _torch_threads import torch_threads  # noqa: F401

SM_SMEM = 233_472  # 228 KB: one H100 SM's shared memory
BLOCK_RESERVED = 1_024  # what the card keeps of it for each block
SM_THREADS = 2_048
NEG_INF = float("-inf")
NAN = float("nan")


def _widths(c: int, elem: int) -> list:
    """Every vector width (elements) ``vector_width`` can pick for C."""
    return [v for v in (16 // elem, 8 // elem, 4 // elem, 2 // elem)
            if v >= 1 and c % v == 0]


# -- K4 forward: the plan ------------------------------------------------


def _pool_cover(n, h, w, c, vec, p):
    """How often each output (image, row, column, channel vector) is
    written, as both kernels map blocks (blockIdx.x = (image group, band,
    channel chunk), the chunk fastest) and threads (channel vector,
    column, image), each thread walking down its band."""
    cvt = c // vec
    count = np.zeros((n, h, w, cvt), np.int64)
    bands, chunks = -(-h // p.rows), -(-cvt // p.ccv)
    t = np.arange(p.threads)
    v, col, im = t % p.ccv, (t // p.ccv) % w, t // (p.ccv * w)
    for b in range(-(-n // p.ib) * bands * chunks):
        cv0, tile = (b % chunks) * p.ccv, b // chunks
        img0, oy0 = (tile // bands) * p.ib, (tile % bands) * p.rows
        img, cv = img0 + im, cv0 + v
        live = (im < p.ib) & (img < n) & (cv < cvt)
        for y in range(oy0, min(oy0 + p.rows, h)):
            np.add.at(count, (img[live], y, col[live], cv[live]), 1)
    return count


_COVER = [(5, h, w, c) for h, w, c, _ in POOL_SHAPES] + [POOL_ODD,
                                                         (3, 2, 2, 64)]


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", _COVER, ids=lambda s: "x".join(map(str, s)))
def test_pool_plan_writes_every_output_once(shape, elem):
    """At GoogLeNet's six pool maps (5 images: a ragged image group), the
    odd (3, 5, 5, 130) and a 2x2 map, at every vector width the wrapper
    can pick for C, each output element is written by exactly one thread
    of one block."""
    n, h, w, c = shape
    for vec in _widths(c, elem):
        p = P.plan(h, w, c, elem, vec)
        assert p.threads == p.ib * w * p.ccv <= P.MAX_THREADS
        assert p.ib == 1 or p.rows == h
        assert p.smem == p.ib * (p.rows + 2) * (w + 2) * p.ccv * vec * elem
        assert (_pool_cover(n, h, w, c, vec, p) == 1).all(), (vec, p)


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", _COVER, ids=lambda s: "x".join(map(str, s)))
def test_pool_backward_plan_writes_every_input_gradient_once(shape, elem):
    """The backward's plan, at the forward's shapes and at every vector
    width: each element of the input gradient is written by exactly one
    thread of one block, and its tile stages g and the map (``elem + 1``
    bytes a channel) with their halo rows and border."""
    n, h, w, c = shape
    for vec in _widths(c, elem):
        p = P.plan(h, w, c, elem, vec, backward=True)
        assert p.threads == p.ib * w * p.ccv <= P.MAX_THREADS
        assert p.ib == 1 or p.rows == h
        assert p.smem == (p.ib * (p.rows + 2) * (w + 2) * p.ccv * vec
                          * (elem + 1))
        assert (_pool_cover(n, h, w, c, vec, p) == 1).all(), (vec, p)


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "fp32"])
def test_pool_backward_plans_fit_the_blocks_an_sm_they_are_built_for(elem):
    """The backward's tiles hold g and the map within ``TILE_BYTES``, as
    the forward's hold x: ``BLOCKS_PER_SM`` blocks share one SM; its 32x32
    maps run in bands, its 8x8 maps whole, in the forward's channel
    chunks."""
    for h, w, c, _ in POOL_SHAPES:
        p = P.plan(h, w, c, elem, 16 // elem, backward=True)
        f = P.plan(h, w, c, elem, 16 // elem)
        assert p.smem <= P.TILE_BYTES, (h, w, c, p)
        assert p.ccv == f.ccv and p.threads <= P.MAX_THREADS
        assert p.rows < h or h < 32, (h, p)
    assert P.plan(8, 8, 832, elem, 16 // elem, backward=True).ib >= 2


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "fp32"])
def test_pool_plans_fit_the_blocks_an_sm_they_are_built_for(elem):
    """A tile holds at most ``TILE_BYTES``, so ``BLOCKS_PER_SM`` blocks
    share one SM's shared memory and threads; GoogLeNet's 32x32 maps run
    in bands (with their halo rows), its 16x16 and 8x8 maps whole."""
    assert P.BLOCKS_PER_SM * (P.TILE_BYTES + BLOCK_RESERVED) <= SM_SMEM
    assert P.BLOCKS_PER_SM * P.MAX_THREADS <= SM_THREADS
    for h, w, c, _ in POOL_SHAPES:
        p = P.plan(h, w, c, elem, 16 // elem)
        assert p.smem <= P.TILE_BYTES, (h, w, c, p)
        assert p.ccv * 16 <= P.CHUNK_BYTES
        assert (c * elem // 16) % p.ccv == 0  # equal chunks tile C
        assert (p.rows < h) == (h == 32), (h, p)
    assert P.plan(32, 32, 192, elem, 16 // elem).rows == 8
    assert P.plan(8, 8, 832, elem, 16 // elem).ib == 3


def test_pool_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="wide"):
        P.plan(4, P.MAX_THREADS + 1, 8, 2, 8)
    with pytest.raises(ValueError):
        P.plan(4, 4, 6, 4, 4)  # c not a multiple of vec


def test_pool_source_builds_what_the_plans_assume():
    """Both kernels' tiles are run-time arguments, so what the source
    builds is the rest: the vector widths the wrapper can pick (16, 8, 4
    and 2 bytes), the forward with and without the map, the backward, the
    plans' constants, and the tile bytes each entry checks: ``elem`` a
    channel forward, ``elem + 1`` backward."""
    src = (_build.CSRC / "max_pool.cu").read_text()
    widths = {v * e for e in (2, 4) for c in (480, 130, 33)
              for v in _widths(c, e)}
    assert widths == {16, 8, 4, 2}
    assert {int(b) for b in re.findall(r"case (\d+): return f\(", src)} \
        | {2} == widths
    assert "if constexpr (sizeof(S) == 2) return f(" in src
    assert "launch_fwd<IO, V, true>" in src and "launch_fwd<IO, V, false>" in src
    assert "max_pool_bwd_kernel<IO, V>" in src
    assert re.search(r"ccv, smem, sizeof\(S\), &blocks\);", src)  # forward
    assert re.search(r"ccv, smem, sizeof\(S\) \+ 1, &blocks\);", src)
    for name, value in (("kMaxThreads", P.MAX_THREADS),
                        ("kSmemOptIn", P.SMEM_OPT_IN)):
        assert re.search(rf"constexpr int {name} = {value};", src), name


# -- K4 forward: the separable rule with the kernel's band split ---------


def _take(best, tap, cur, cur_tap):
    """One step of either pass: ``cur`` takes over where it is greater or
    a NaN."""
    take = (cur > best) | torch.isnan(cur)
    return torch.where(take, cur, best), torch.where(take, cur_tap, tap)


def _separable(x: torch.Tensor, rows: int):
    """The forward kernel's two passes in torch, band by band: a band's
    block stages input rows oy0 - 1 .. oy0 + rows and columns -1 .. w,
    -inf where they lie outside the map; the w-pass of each staged row
    starts from its left tap and takes the middle and right ones; the
    h-pass of each output row starts from the row above and takes the row
    itself and the one below, naming tap 3 * row + column."""
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    win = torch.empty(x.shape, dtype=torch.uint8)
    xp = F.pad(x, (0, 0, 1, 1, 1, rows + 1), value=NEG_INF)
    for oy0 in range(0, h, rows):
        tile = xp[:, oy0:oy0 + rows + 2]  # input rows oy0 - 1 ..
        zero = torch.zeros(tile[:, :, :w].shape, dtype=torch.uint8)
        rb, rc = tile[:, :, 0:w], zero
        rb, rc = _take(rb, rc, tile[:, :, 1:w + 1], zero + 1)
        rb, rc = _take(rb, rc, tile[:, :, 2:w + 2], zero + 2)
        for k in range(min(rows, h - oy0)):
            best, tap = rb[:, k], rc[:, k]
            best, tap = _take(best, tap, rb[:, k + 1], rc[:, k + 1] + 3)
            best, tap = _take(best, tap, rb[:, k + 2], rc[:, k + 2] + 6)
            out[:, oy0 + k], win[:, oy0 + k] = best, tap
    return out, win


def _raw(a: torch.Tensor) -> torch.Tensor:
    return a.view(torch.int16 if a.element_size() == 2 else torch.int32)


def _edge_input(kind: str, shape, e: int, dtype) -> torch.Tensor:
    """A seeded input of one kind; ``e`` is the first band edge (output
    rows e - 1 | e belong to two blocks)."""
    rs = np.random.RandomState(3)
    n, h, w, c = shape
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    if kind == "ties":  # few distinct values: ties everywhere
        x = torch.from_numpy(rs.randint(0, 3, size=shape).astype(np.float32))
    elif kind == "signed zeros":
        x = torch.from_numpy(np.where(rs.rand(*shape) < 0.5, 0.0, -0.0)
                             .astype(np.float32))
        x[:, e - 1, 5] = -1.0  # a window of -0 and +0 beside a real minimum
    elif kind == "two NaNs a window":
        x[0, e - 1, 3] = NAN
        x[0, e, 4] = NAN
        x[1, e, 10:12] = NAN
        x[2, 0, 0, 1] = NAN
        x[2, 1, 1, 1] = NAN
    elif kind == "-inf borders":
        for border in (np.s_[:2], np.s_[-2:]):
            x[:, border] = NEG_INF
            x[:, :, border] = NEG_INF
        x[1] = NEG_INF  # a whole -inf map
    elif kind == "band edges":  # each window's maximum in a halo row
        x[:, e - 1] = 50.0 + torch.from_numpy(rs.rand(n, w, c)
                                              .astype(np.float32))
        x[:, e] = 50.0 + torch.from_numpy(rs.rand(n, w, c)
                                          .astype(np.float32))
        x[:, e - 1, ::2] = x[:, e, ::2]  # ties across the edge
        x[:, 2 * e - 1] = NEG_INF
        x[:, 2 * e] = NEG_INF
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("kind", ["random", "ties", "signed zeros",
                                  "two NaNs a window", "-inf borders",
                                  "band edges"])
def test_separable_bands_reproduce_the_plain_version_bit_for_bit(kind, dtype):
    """At the kernel's plan for a 32x32x64 map (bands of 8 rows), the
    separable rule gives the plain version's output bits and winner map
    exactly: the first maximum in row-major tap order, the last NaN, +-0
    as they come, tap 0 for an all -inf window, and the same answer at a
    band's edge as inside it."""
    shape = (3, 32, 32, 64)
    elem = torch.tensor([], dtype=dtype).element_size()
    p = P.plan(*shape[1:], elem, 16 // elem)
    assert p.rows == 8 and p.ib == 1  # bands, with their halo rows
    x = _edge_input(kind, shape, p.rows, dtype)
    ref, ridx = P.max_pool3x3_s1_reference(x, True)
    out, win = _separable(x, p.rows)
    assert torch.equal(_raw(out), _raw(ref))
    assert torch.equal(win, ridx)


def test_separable_rule_picks_the_last_nan_and_the_first_maximum():
    """The two rules the passes must share, on one window: of two NaNs
    the later tap wins; of equal maxima the earlier tap does."""
    x = torch.zeros(1, 3, 3, 2)
    x[0, 0, 2, 0] = NAN  # tap 2
    x[0, 2, 0, 0] = NAN  # tap 6: wins
    x[0, 0, 1, 1] = 7.0  # tap 1: wins
    x[0, 1, 2, 1] = 7.0  # tap 5
    out, win = _separable(x, 3)
    assert win[0, 1, 1].tolist() == [6, 1]
    assert torch.isnan(out[0, 1, 1, 0]) and out[0, 1, 1, 1] == 7.0
    assert torch.equal(win, P.max_pool3x3_s1_reference(x, True)[1])


# -- K4 backward: the banded gather with the kernel's border and sums -----


def _wide_bits(g: torch.Tensor) -> torch.Tensor:
    """g's values as fp32 bits, int32: a bf16 widened by shifting its 16
    bits up, as the kernel widens it."""
    if g.dtype == torch.bfloat16:
        return g.view(torch.int16).to(torch.int32) << 16
    return g.view(torch.int32)


def _banded_backward(g: torch.Tensor, idx: torch.Tensor, rows: int):
    """The backward kernel's rule in torch, band by band: a band's block
    stages the g and map rows of windows oy0 - 1 .. oy0 + rows and columns
    -1 .. w, with g 0 and map 255 (no tap) outside the map; input row oy0 +
    k sums tap t = 3 dy + dx from the window at tile row k + 2 - dy, column
    x + 1 - dx, for t = 0..8 in order, in fp32 from +0, each tap adding the
    bits of g masked by (map == t): +0 where the map names another tap.
    One rounding to g's type at the end."""
    n, h, w, c = g.shape
    pad = (0, 0, 1, 1, 1, rows + 1)
    gp = F.pad(_wide_bits(g), pad)
    ip = F.pad(idx.to(torch.int32), pad, value=255)
    out = torch.empty_like(g)
    for oy0 in range(0, h, rows):
        tg, ti = gp[:, oy0:oy0 + rows + 2], ip[:, oy0:oy0 + rows + 2]
        for k in range(min(rows, h - oy0)):
            acc = torch.zeros((n, w, c), dtype=torch.float32)
            for t in range(9):
                dy, dx = divmod(t, 3)
                r, cols = k + 2 - dy, slice(2 - dx, 2 - dx + w)
                mask = -(ti[:, r, cols] == t).to(torch.int32)  # 0 or ~0
                acc = acc + (tg[:, r, cols] & mask).view(torch.float32)
            out[:, oy0 + k] = acc.to(g.dtype)
    return out


def _bwd_case(kind: str, shape, e: int, dtype):
    """(g, map) of one kind; ``e`` is the backward plan's first band edge.
    The map is the plain forward's on a seeded x, so every window routes
    its g to its winner."""
    rs = np.random.RandomState(5)
    n, h, w, c = shape
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    if kind == "signed zeros":
        g = torch.from_numpy(np.where(rs.rand(*shape) < 0.5, 0.0, -0.0)
                             .astype(np.float32))
        g[0] = -0.0  # a whole image of -0 cotangents
    elif kind == "NaN and inf cotangents":
        # every window's g reaches one position; a NaN, an inf or a -inf
        # must not reach the other eight around it
        for v, frac in ((NAN, 0.02), (float("inf"), 0.02),
                        (float("-inf"), 0.02)):
            g[torch.from_numpy(rs.rand(*shape) < frac)] = v
    elif kind == "-inf windows at borders":
        for border in (np.s_[:2], np.s_[-2:]):
            x[:, border] = NEG_INF
            x[:, :, border] = NEG_INF
        x[1] = NEG_INF  # a whole -inf map: corner windows keep tap 0
        g[:, 0] = NAN  # dropped with the halo winners, not spread
    elif kind == "band edges":
        x[:, e - 1] = 50.0 + torch.from_numpy(rs.rand(n, w, c)
                                              .astype(np.float32))
        x[:, e, ::2] = x[:, e - 1, ::2]  # ties across the edge
        g[:, e - 1:e + 1] = 1e30  # sums that round at the edge
        g[:, e + 1] = -1e30
    x, g = x.to(dtype), g.to(dtype)
    return g, P.max_pool3x3_s1_reference(x, True)[1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("kind", ["random", "signed zeros",
                                  "NaN and inf cotangents",
                                  "-inf windows at borders", "band edges"])
def test_banded_backward_reproduces_the_plain_version_bit_for_bit(kind,
                                                                  dtype):
    """At the backward plan for a 32x32x64 map (bands with halo rows), the
    kernel's rule gives the plain version's bits exactly: -0 cotangents
    sum to +0 as the plain version's do, a NaN or an infinity reaches only
    the position its window routes it to (an unmatched tap adds +0, not g
    times 0), a window whose winner is tap 0 in the halo drops its g, and
    a band's edge rows sum as rows inside it do."""
    shape = (3, 32, 32, 64)
    elem = torch.tensor([], dtype=dtype).element_size()
    p = P.plan(*shape[1:], elem, 16 // elem, backward=True)
    assert p.ib == 1 and p.rows < 32  # bands, with their halo rows
    g, idx = _bwd_case(kind, shape, p.rows, dtype)
    want = P.max_pool3x3_s1_backward_reference(g, idx)
    got = _banded_backward(g, idx, p.rows)
    assert torch.equal(_raw(got), _raw(want))
    if kind == "NaN and inf cotangents":
        assert torch.isnan(want).any() and not torch.isnan(want).all()


def test_multiplying_by_the_mask_would_spread_a_nan():
    """Why the kernel selects: g * (map == t) puts NaN = NaN * 0 into all
    eight positions around a NaN cotangent that are not its window's
    winner; the select leaves them finite."""
    x = torch.arange(9.0).view(1, 3, 3, 1)  # the window at (1, 1) picks 8
    idx = P.max_pool3x3_s1_reference(x, True)[1]
    g = torch.zeros(1, 3, 3, 1)
    g[0, 1, 1, 0] = NAN
    got = _banded_backward(g, idx, 3)
    assert torch.isnan(got).sum() == 1 and torch.isnan(got[0, 2, 2, 0])
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))
    ip = F.pad(idx, (0, 0, 1, 1, 1, 1), value=255)
    times = sum(gp[:, 2 - t // 3:5 - t // 3, 2 - t % 3:5 - t % 3]
                * (ip[:, 2 - t // 3:5 - t // 3, 2 - t % 3:5 - t % 3] == t)
                for t in range(9))
    assert torch.isnan(times).sum() > 1
