"""The sentinel and remat under data parallelism: one job of two gloo ranks
(``tests/_torch_dp.py``), rank 1 alone armed with ``PCT_FAULTS=nan_loss=5``
through its environment.

- ``sentinel``: six guarded ResNetTiny steps. Both ranks call step 5
  bad (rank 0's loss is finite: the verdict rides the flat all-reduce),
  both leave their state as it was before step 5, as raw bits, and the
  two ranks hold the same bits after every step.
- ``rollback``: a LeNet ``Trainer`` at 4 steps an epoch with
  ``sentinel="rollback"``, budget 1: both ranks skip step 5 and restore
  the epoch-0 checkpoint (format v3, a shard from each rank), and end
  holding its state, which one process restores from the files.
- ``remat``: a ``sync_bn`` step with ``remat`` against one without, from
  the same state: the recompute repeats the moments' all-reduce in the
  same order on both ranks; gradients and BN running stats bit for bit
  (CPU, fp32), the running stats updated once.
"""

import os

import numpy as np
import pytest
import torch

from pytorch_cifar_tpu_torch.models.common import reset_parameters
from pytorch_cifar_tpu_torch.models.resnet import BasicBlock, ResNet
from pytorch_cifar_tpu_torch.train.checkpoint import restore_checkpoint
from _torch_ckpt import momentum, port_state
from _torch_dp import run_job
from _torch_threads import torch_threads  # noqa: F401

BAD_STEP = 5


def _batches(n, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8),
             rs.randint(0, 10, 8).astype(np.int32)) for _ in range(n)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    model = ResNet(BasicBlock, (1, 1, 1, 1))
    reset_parameters(model, torch.Generator().manual_seed(3))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    base = {"model": "ResNetTiny", "sd": sd, "lr": 0.1, "t_max": 4,
            "spe": 3}
    job_dir = str(tmp_path_factory.mktemp("dp_sentinel"))
    tasks = [  # remat disarms the faults: it runs last
        {**base, "name": "sentinel", "kind": "sentinel",
         "batches": _batches(6, 7)},
        {"name": "rollback", "kind": "rollback", "config": dict(
            model="LeNet", synthetic_data=True, synthetic_train_size=256,
            synthetic_test_size=64, batch_size=64, eval_batch_size=64,
            epochs=2, amp=False, lr=0.02, device="cpu",
            sentinel="rollback", sentinel_budget=1,
            output_dir=os.path.join(job_dir, "rollback"))},
        {**base, "name": "remat", "kind": "remat",
         "batch": _batches(1, 8)[0]},
    ]
    return job_dir, run_job(
        tasks, job_dir, rank_env={1: {"PCT_FAULTS": f"nan_loss={BAD_STEP}"}})


def test_both_ranks_skip_the_step_one_rank_poisoned(ranks):
    got = [r["sentinel"] for r in ranks[1]]
    for g in got:
        assert g["nonfinite"] == [0.0] * BAD_STEP + [1.0]
        assert torch.equal(g["after"][BAD_STEP].view(torch.int32),
                           g["before"][BAD_STEP].view(torch.int32))
        assert not torch.equal(g["after"][0], g["before"][0])
        assert g["step"] == BAD_STEP + 1
    for a, b in zip(got[0]["after"], got[1]["after"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_sync_bn_remat_step_equals_the_plain_step(ranks):
    ranks = ranks[1]
    for r in ranks:
        plain, remat = r["remat"][False], r["remat"][True]
        for k, g in plain["grads"].items():
            assert torch.equal(remat["grads"][k], g), k
        for k, v in plain["sd"].items():
            assert torch.equal(remat["sd"][k], v), k
    # the running stats moved once, and alike on both ranks
    sd0 = ranks[0]["remat"][True]["sd"]
    sd1 = ranks[1]["remat"][True]["sd"]
    start = ResNet(BasicBlock, (1, 1, 1, 1))
    reset_parameters(start, torch.Generator().manual_seed(3))
    for k, v in start.state_dict().items():
        if k.endswith("running_mean"):
            assert not torch.equal(sd0[k], v), k
            assert torch.equal(sd0[k], sd1[k]), k


def test_both_ranks_roll_back_to_the_epoch_zero_checkpoint(ranks):
    job_dir, results = ranks
    got = [r["rollback"] for r in results]
    for g in got:
        assert g["fault_stats"] == {"bad_steps": 1, "rollbacks": 1,
                                    "bad_step_indices": [BAD_STEP]}
        assert g["step"] == 4  # the checkpoint's
    state = port_state("LeNet")
    restore_checkpoint(os.path.join(job_dir, "rollback"), state,
                       names=["ckpt-e00000.msgpack"])
    want = state.model.state_dict()
    for g in got:
        for k, v in want.items():
            assert torch.equal(g["sd"][k], v), k
        for k, buf in momentum(state).items():
            assert torch.equal(g["mom"][k], buf), k
