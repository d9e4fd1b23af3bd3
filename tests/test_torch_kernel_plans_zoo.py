"""The K3, K4 and K5 plans at the zoo's sites, on the CPU.

Every stride-1 depthwise site of MobileNetV2, EfficientNetB0, the four
ShuffleNetV2 widths, PNASNet A and B and ShuffleNet G2/G3 gets a K5 plan
within one block's shared memory, in bf16 and fp32, at the widest vector
its channel count allows (ShuffleNetV2's 58, PNASNetA's 44 and ShuffleNet
G2's 50 take the narrow ones); each PNASNet pool input gets a K4 forward
and backward plan; every fused site of VGG, PreActResNet, SENet, RegNet
and DPN (2x2 maps of 512 channels among them) gets a K3 plan. The sites
are recorded from one folded forward of each model
(``tools._bench.fused_sites`` / ``stencil_sites`` / ``pool_sites``, which
``chip_smoke.py`` uses too).
"""

import pytest
import torch

from pytorch_cifar_tpu_torch.ops import conv_bn_relu as K
from pytorch_cifar_tpu_torch.ops import depthwise_stencil as D
from pytorch_cifar_tpu_torch.ops import max_pool as P
from pytorch_cifar_tpu_torch.tools._bench import (
    fused_sites,
    pool_sites,
    stencil_sites,
)
from _torch_threads import torch_threads  # noqa: F401
from _torch_zoo import KERNEL_SITES, REST

SMEM_LIMIT = 232_448  # 227 KB: the most one block may ask for on an H100
# the models with depthwise stencil sites
STENCIL_MODELS = [n for n, (_, _, k5) in KERNEL_SITES.items() if k5]


def _widest_vec(c: int, elem: int) -> int:
    v = 16 // elem
    while c % v:
        v //= 2
    return v


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("name", STENCIL_MODELS)
def test_every_stencil_site_gets_a_plan_within_shared_memory(name, elem):
    for h, w, c, k, _ in stencil_sites(name):
        vec = _widest_vec(c, elem)
        p = D.plan(h, w, c, k, elem, vec)
        assert p.smem <= SMEM_LIMIT and 0 < p.threads <= D.MAX_THREADS
        assert p.th <= h and p.ccv * vec * elem <= D.CHUNK_BYTES or \
            p.ccv == 1, (h, w, c, k, p)


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_every_pnasnet_pool_gets_a_plan(elem, backward):
    shapes = pool_sites("PNASNetA") + pool_sites("PNASNetB")
    assert {s[2] for s in shapes} == {44, 88, 176, 32, 64, 128}
    for h, w, c, _ in shapes:
        p = P.plan(h, w, c, elem, _widest_vec(c, elem), backward=backward)
        assert p.smem <= SMEM_LIMIT and 0 < p.threads <= P.MAX_THREADS


# the last families' models with fused sites
FUSED_MODELS = [n for n in REST if KERNEL_SITES[n][0]]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("name", FUSED_MODELS)
def test_every_fused_site_gets_a_plan_within_shared_memory(name, dtype):
    """The wgmma path at bf16 sites with cin and cout multiples of 8, the
    mma.sync path at the stems and in fp32; at 2x2 one tile holds 32
    whole images."""
    sites = fused_sites(name)
    assert sum(s[-1] for s in sites) == KERNEL_SITES[name][0]
    for site, h, w, cin, cout, _ in sites:
        p = K.plan(h, w, cin, cout, dtype)
        assert 0 < p.smem <= SMEM_LIMIT, (site, p)
        wide = dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0
        assert p.path == ("wgmma" if wide else "sync"), (site, p)
        if p.path == "wgmma":
            assert p.ib * p.th * w <= K.WG_M
            if (h, w) == (2, 2):
                assert (p.ib, p.th) == (32, 2)
