"""The host-side plans of the port's conv3x3+BN+ReLU (K3) and depthwise
stencil (K5) kernels, on the CPU.

The kernels themselves run only on the card (``chip_smoke.py``,
``tools/conv_bench.py``, ``tools/depthwise_bench.py``); what decides their
tiles is plain Python that these tests reach: every site of the model zoo
gets a plan within one block's shared memory, the tiles cover every output
once, an image's place in its tile does not depend on the batch, and what
no path takes raises.
"""

import re

import pytest
import torch

from pytorch_cifar_tpu_torch.ops import _build
from pytorch_cifar_tpu_torch.ops import conv_bn_relu as K
from pytorch_cifar_tpu_torch.ops import depthwise_stencil as D
from pytorch_cifar_tpu_torch.tools._bench import (
    RESNET18_SITES,
    STENCIL_SHAPES,
    fused_sites,
)
from _torch_threads import torch_threads  # noqa: F401

SMEM_LIMIT = 232_448  # 227 KB: the most one block may ask for on an H100
MOBILENET_STEM = ("mobilenet.stem", 32, 32, 3, 32, 1)
K3_SITES = RESNET18_SITES + [MOBILENET_STEM]


def _zoo_sites():
    return K3_SITES + fused_sites("GoogLeNet") + fused_sites("SimpleDLA")


def _widest_vec(c: int, elem: int) -> int:
    v = 16 // elem
    while c % v:
        v //= 2
    return v


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_every_zoo_site_gets_a_plan_within_shared_memory(dtype):
    sites = _zoo_sites()
    assert len(sites) == len(K3_SITES) + 24 + 8  # GoogLeNet, SimpleDLA
    for name, h, w, cin, cout, _ in sites:
        p = K.plan(h, w, cin, cout, dtype)
        assert 0 < p.smem <= SMEM_LIMIT, (name, p)
        if p.path == "wgmma":
            assert p.smem == K.wgmma_smem(p.bn,
                                          p.ib * (p.th + 2) * (w + 2))


def test_bf16_sites_take_wgmma_but_the_stems():
    for name, h, w, cin, cout, _ in _zoo_sites():
        p = K.plan(h, w, cin, cout)
        stem = cin == 3
        assert p.path == ("sync" if stem else "wgmma"), (name, p)
        assert K.plan(h, w, cin, cout, torch.float32).path == "sync"


def test_small_maps_fill_the_m_tile_with_whole_images():
    """At every ResNet-18, GoogLeNet and SimpleDLA wgmma site the M tile
    has at least 64 real rows; maps of 64 pixels or fewer take several
    whole images."""
    for name, h, w, cin, cout, _ in _zoo_sites():
        p = K.plan(h, w, cin, cout)
        if p.path != "wgmma":
            continue
        rows = p.ib * p.th * w
        assert 64 <= rows <= K.WG_M, (name, p)
        assert p.ib == 1 or p.th == h
        if h * w <= 64:
            assert p.ib * h * w == K.WG_M and p.bn == 64
        assert p.bn in (64, 128)
    assert K.plan(4, 4, 512, 512).ib == 8
    assert K.plan(8, 8, 256, 256).ib == 2
    assert K.plan(2, 2, 1024, 1024).ib == 32


def test_n_tile_pads_cout_no_wider_than_needed():
    """BN = 128 only where it pads cout no wider than BN = 64 does."""
    for cout, bn in ((96, 128), (128, 128), (192, 64), (208, 128),
                     (256, 128), (288, 64), (320, 64), (64, 64)):
        assert K.plan(16, 16, 64, cout).bn == bn, cout
    assert K.plan(8, 8, 256, 256).bn == 64  # small maps: more blocks
    assert K.plan(4, 4, 512, 512).blocks_per_sm == 1
    assert K.plan(8, 8, 256, 256).blocks_per_sm == 2


def test_plans_fit_the_blocks_an_sm_their_kernel_is_built_for():
    """BN = 64 tiles keep their ring within half an SM's shared memory, so
    two blocks share it; BN = 128 tiles, and maps too small to give every
    SM two blocks, take one."""
    for name, h, w, cin, cout, _ in _zoo_sites():
        p = K.plan(h, w, cin, cout)
        if p.path != "wgmma":
            continue
        if p.blocks_per_sm == 2:
            assert p.smem <= K.SMEM_TWO_BLOCKS and p.bn == 64, (name, p)
        else:
            assert p.bn == 128 or h * w <= 16, (name, p)


def test_the_source_builds_the_tiles_the_zoo_plans_choose():
    """Each wgmma instantiation costs build time on every run: the source
    builds the (bn, blocks an SM) tiles that the zoo's sites take, and no
    other."""
    src = (_build.CSRC / "conv_bn_relu.cu").read_text()
    built = {(int(bn), int(mb))
             for bn, mb in re.findall(r"WG_CASE\((\d+), (\d+)\)", src)}
    chosen = {(p.bn, p.blocks_per_sm)
              for p in (K.plan(*site[1:5]) for site in _zoo_sites())
              if p.path == "wgmma"}
    assert built == chosen == {(64, 2), (64, 1), (128, 1)}


def _k3_tiles(n, h, w, p):
    """(image, row) -> (block, place in the block's M tile), as the kernel
    maps blocks: blockIdx.x = (image group, row band)."""
    bands = -(-h // p.th)
    where = {}
    for b in range(-(-n // p.ib) * bands):
        img0, oy0 = (b // bands) * p.ib, (b % bands) * p.th
        for m in range(p.ib * p.th * w):
            img = img0 + m // (p.th * w)
            oy = oy0 + (m % (p.th * w)) // w
            if img < n and oy < h:
                key = (img, oy, m % w)
                assert key not in where
                where[key] = (b, m)
    return where


@pytest.mark.parametrize("shape", [(32, 32, 64, 64), (16, 16, 128, 128),
                                   (8, 8, 256, 256), (4, 4, 512, 512),
                                   (2, 2, 1024, 1024), (6, 6, 16, 24),
                                   (24, 24, 16, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k3_tiles_cover_every_output_once_whatever_the_batch(shape):
    """Every output pixel is in exactly one block, and an image's place in
    its block's M tile is the same at every batch size: batch invariance
    needs nothing more, since the plan never looks at n."""
    h, w, cin, cout = shape
    p = K.plan(h, w, cin, cout)
    full = _k3_tiles(128, h, w, p)
    assert len(full) == 128 * h * w
    for n in (1, 3, 8, 32):
        part = _k3_tiles(n, h, w, p)
        assert len(part) == n * h * w
        assert all(full[key][1] == m for key, (_, m) in part.items())


def test_k3_refuses_what_no_path_takes():
    with pytest.raises(ValueError, match="wide"):
        K.plan(4, 129, 64, 64)  # wgmma: 128 pixels a block
    with pytest.raises(ValueError, match="wide"):
        K.plan(4, 65, 64, 64, torch.float32)  # sync: 64 pixels a block
    with pytest.raises(ValueError, match="wide"):
        K.plan(4, 65, 3, 64)  # a stem wider than 64


def test_k3_wgmma_path_needs_16_byte_aligned_bases():
    """The wgmma path copies 16 bytes at a time: a view at an offset that
    is not a multiple of 16 bytes is refused, not misread."""
    base = torch.zeros(64, dtype=torch.bfloat16)
    K.require_aligned(base, base[8:])
    for off in (1, 4):
        with pytest.raises(ValueError, match="16-byte"):
            K.require_aligned(base, base[off:])


def _stencil_shapes():
    out = []
    for n, h, w, c, k, _ in STENCIL_SHAPES:
        for elem in (2, 4):
            out.append((h, w, c, k, elem, _widest_vec(c, elem)))
    return out


def test_every_stencil_shape_gets_a_plan_within_shared_memory():
    shapes = _stencil_shapes()
    assert len(shapes) == 2 * len(STENCIL_SHAPES)
    for h, w, c, k, elem, vec in shapes:
        p = D.plan(h, w, c, k, elem, vec)
        assert 0 < p.smem <= SMEM_LIMIT
        assert 1 <= p.threads <= D.MAX_THREADS
        assert p.ccv * vec * elem <= max(D.CHUNK_BYTES, vec * elem)
        assert p.xruns * D.RUN >= w > (p.xruns - 1) * D.RUN
        assert p.tr <= p.th <= h and (p.ib == 1 or p.th == h)


def test_stencil_small_maps_take_several_images_a_block():
    """MobileNet's 4x4x512 and 2x2x1024 sites: a bucket-128 launch is 256
    full blocks, not thousands of near-empty ones."""
    for h, c in ((4, 512), (2, 1024)):
        p = D.plan(h, h, c, 3, 2, 8)
        blocks = -(-128 // p.ib) * -(-(c // 8) // p.ccv)
        assert p.ib > 1 and p.threads == D.MAX_THREADS
        assert blocks == 256


def test_stencil_channel_chunks_are_balanced():
    """C = 44 in fp32 (11 vectors of 4) splits 6 + 5, not 8 + 3."""
    p = D.plan(32, 32, 44, 7, 4, 4)
    assert p.ccv == 6
    for h, w, c, k, elem, vec in _stencil_shapes():
        p = D.plan(h, w, c, k, elem, vec)
        cvt = c // vec
        chunks = -(-cvt // p.ccv)
        assert cvt - (chunks - 1) * p.ccv > 0  # no empty last chunk


def _stencil_tiles(n, h, w, c, vec, p):
    """(image, row, column, channel vector) -> (block, chunk), as the kernel
    maps blocks (blockIdx.x = (image group, row band), blockIdx.y = channel
    chunk) and threads (channel vector, run of columns, row, image) onto
    outputs; asserts that no output is written twice."""
    bands = -(-h // p.th)
    cvt = c // vec
    where = {}
    for b in range(-(-n // p.ib) * bands):
        img0, oy0 = (b // bands) * p.ib, (b % bands) * p.th
        for ch in range(-(-cvt // p.ccv)):
            for t in range(p.threads):
                cv, r = ch * p.ccv + t % p.ccv, t // p.ccv
                x0, r = (r % p.xruns) * D.RUN, r // p.xruns
                im = r // p.tr
                if im >= p.ib or img0 + im >= n or cv >= cvt:
                    continue
                for ty in range(r % p.tr, min(p.th, h - oy0), p.tr):
                    for x in range(x0, min(x0 + D.RUN, w)):
                        key = (img0 + im, oy0 + ty, x, cv)
                        assert key not in where
                        where[key] = (b, ch)
    return where


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(3, 4, 4, 16, 3), (5, 2, 2, 8, 3),
                                   (2, 8, 8, 6, 7), (2, 13, 6, 5, 5),
                                   (1, 16, 16, 8, 3), (2, 4, 4, 44, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_stencil_tiles_cover_every_output_once(shape, elem):
    """Every output (pixel, channel vector) is written by exactly one
    thread of one block, for ragged maps, channel counts and image groups."""
    n, h, w, c, k = shape
    vec = _widest_vec(c, elem)
    p = D.plan(h, w, c, k, elem, vec)
    assert len(_stencil_tiles(n, h, w, c, vec, p)) == n * h * w * (c // vec)


def test_stencil_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="wide"):
        D.plan(4, 4 * D.MAX_THREADS + 1, 8, 3, 4, 4)
    with pytest.raises(ValueError):
        D.plan(4, 4, 8, 4, 4, 4)  # k = 4
    with pytest.raises(ValueError):
        D.plan(4, 4, 6, 3, 4, 4)  # c not a multiple of vec


@pytest.mark.parametrize("name", ["conv_bn_relu", "depthwise_stencil",
                                  "dma_gather", "max_pool"])
def test_entry_points_match_the_sources(name):
    """Each C entry point takes as many arguments as ``ENTRY_POINTS``
    declares for it, so ctypes passes every plan field."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for fn, argtypes in _build.ENTRY_POINTS[name].items():
        m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src)
        assert m, fn
        assert len(m.group(1).split(",")) == len(argtypes), fn


def test_profile_tools_file_every_k3_kernel_as_k3():
    """The profile tools find K3 by the substring ``conv3x3_bn_relu`` in
    a kernel's name; every kernel of its source carries it, so no path's
    time is filed with the library's convolutions."""
    from pytorch_cifar_tpu_torch.tools.profile_forward import group_of

    src = (_build.CSRC / "conv_bn_relu.cu").read_text()
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\)\)?)?"
                       r"\s+(\w+)\(", src)
    assert len(names) == 2
    for name in names:
        assert group_of(f"void ns::{name}<64, 4>(args)") \
            == "fused_conv3x3_bn_relu"
