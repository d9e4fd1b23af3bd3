"""``remat`` (``make_train_step(remat=True)``, ``--remat``) on the CPU.

The forward runs under ``torch.utils.checkpoint`` and is recomputed in
the backward. One fp32 step from the same state with and without it:
the gradients, the parameters after the update and the BN running stats
are equal bit for bit (the recompute does the same arithmetic in the
same order on the CPU), so the running stats were updated once.
EfficientNet (a narrow cut with drop-connect on two blocks and dropout)
shows its draws replayed: a mask drawn anew in the recompute would move
the gradients. The K2 hook (``bn_moments_impl``, its plain version on the
CPU) is carried into the recompute by ``recompute_context``, which the
backward on CUDA runs on autograd's own thread.
"""

import threading

import numpy as np
import pytest
import torch

from pytorch_cifar_tpu_torch.models import common
from pytorch_cifar_tpu_torch.models.common import (
    bn_moments_impl,
    recompute_context,
    reset_parameters,
)
from pytorch_cifar_tpu_torch.models.efficientnet import EfficientNet
from pytorch_cifar_tpu_torch.models.resnet import BasicBlock, ResNet
from pytorch_cifar_tpu_torch.ops.bn_stats import fused_moments
from pytorch_cifar_tpu_torch.train import optim, steps
from pytorch_cifar_tpu_torch.train.state import create_train_state
from _torch_threads import torch_threads  # noqa: F401

# narrow: four stages, two of them with drop-connect (as the EfficientNet
# step tests cut it)
CUT = {"num_blocks": (1, 2, 1, 2), "expansion": (1, 2, 2, 2),
       "out_channels": (8, 8, 16, 16), "kernel_size": (3, 5, 3, 5),
       "stride": (1, 1, 2, 1), "dropout_rate": 0.2,
       "drop_connect_rate": 0.2}
MODELS = {
    "ResNetTiny": lambda: ResNet(BasicBlock, (1, 1, 1, 1)),
    "EfficientNet": lambda: EfficientNet(CUT),
}


def _state(name, seed=0):
    model = MODELS[name]()
    reset_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(memory_format=torch.channels_last)
    return create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=0.1),
        optim.cosine_epoch_schedule(0.1, 4, 3), seed=seed, device="cpu")


def _batch(n=8, seed=1):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randint(0, 256, (n, 32, 32, 3))
                             .astype(np.uint8)),
            torch.from_numpy(rs.randint(0, 10, n).astype(np.int32)))


def _after_step(name, remat, moments=None):
    state = _state(name)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = steps.make_train_step(augment=False, remat=remat, device="cpu")
    with bn_moments_impl(moments):
        step(state, _batch())
    grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
    return start, grads, state.model.state_dict()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_step_equals_the_plain_step_bit_for_bit(name):
    start, g_plain, sd_plain = _after_step(name, remat=False)
    _, g_remat, sd_remat = _after_step(name, remat=True)
    for k, g in g_plain.items():
        assert torch.equal(g_remat[k], g), k
    for k, v in sd_plain.items():
        assert torch.equal(sd_remat[k], v), k
    moved = [k for k in sd_plain if k.endswith("running_mean")
             and not torch.equal(sd_plain[k], start[k])]
    assert moved  # the forward updated them, and the recompute did not


def test_remat_under_the_moments_hook():
    _, g_plain, sd_plain = _after_step("ResNetTiny", False, fused_moments)
    _, g_remat, sd_remat = _after_step("ResNetTiny", True, fused_moments)
    for k, g in g_plain.items():
        assert torch.equal(g_remat[k], g), k
    for k, v in sd_plain.items():
        assert torch.equal(sd_remat[k], v), k


def test_recompute_context_carries_the_hook_to_another_thread():
    """The recompute may run on a thread that sees none of the step's
    context variables: the factory captured the impl, and the context
    freezes the running stats there."""
    with bn_moments_impl(fused_moments):
        replay = recompute_context()
    seen = {}

    def recompute():
        seen["outside"] = common._BN_MOMENTS_IMPL.get()
        with replay():
            seen["impl"] = common._BN_MOMENTS_IMPL.get()
            seen["frozen"] = common._RUNNING_FROZEN.get()
        seen["after"] = common._RUNNING_FROZEN.get()

    t = threading.Thread(target=recompute)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen == {"outside": None, "impl": fused_moments, "frozen": True,
                    "after": False}
