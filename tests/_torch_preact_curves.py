"""The loss curves of both packages' train steps on the card's sweep
protocol, at a batch the CPU can run:

    python tests/_torch_preact_curves.py --model PreActResNet34 --batch 64 \\
        --steps 40

The protocol of ``pytorch_cifar_tpu_torch.tools.zoo_bench``: one
``torch.Generator(0)`` draws four random-label batches, then the model's
PyTorch-default init; lr 0.1 (cosine over 200 epochs of 98 steps),
momentum 0.9, weight decay 5e-4, the batches reused in turn. Here in fp32
with augmentation off (the two packages draw their crops and flips from
different streams), the same init exported to JAX through
``compat.jax_trees_from_state_dict``. Each step prints both losses and the
largest relative difference of the parameters after it; one JSON line at
the end carries both curves.
"""

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pytorch_cifar_tpu.models import create_model as jax_create_model  # noqa: E402
from pytorch_cifar_tpu.train import optim as jax_optim  # noqa: E402
from pytorch_cifar_tpu.train import state as jax_state  # noqa: E402
from pytorch_cifar_tpu.train import steps as jax_steps  # noqa: E402
from pytorch_cifar_tpu_torch.compat import (  # noqa: E402
    jax_trees_from_state_dict,
    state_dict_from_jax,
)
from pytorch_cifar_tpu_torch.models import create_model  # noqa: E402
from pytorch_cifar_tpu_torch.train import optim, steps  # noqa: E402
from pytorch_cifar_tpu_torch.train.state import create_train_state  # noqa: E402

LR, T_MAX, SPE = 0.1, 200, 98


def curves(name: str, batch: int, n_steps: int, log=print) -> dict:
    g = torch.Generator().manual_seed(0)
    batches = [
        (torch.randint(0, 256, (batch, 32, 32, 3), generator=g,
                       dtype=torch.uint8),
         torch.randint(0, 10, (batch,), generator=g, dtype=torch.int32))
        for _ in range(4)
    ]
    model = create_model(name, generator=g)
    # copies: the trees view the model's tensors, which the port's step
    # updates in place, and the JAX arrays made from them may view them too
    params, stats = jax.tree_util.tree_map(
        np.array, jax_trees_from_state_dict(name, model.state_dict(),
                                            model=model))
    model = model.to(memory_format=torch.channels_last)
    state = create_train_state(
        model, optim.make_optimizer(model.parameters(), lr=LR),
        optim.cosine_epoch_schedule(LR, T_MAX, SPE), device="cpu")
    port_step = steps.make_train_step(augment=False, device="cpu")

    tx = jax_optim.make_optimizer(lr=LR, t_max=T_MAX, steps_per_epoch=SPE)
    jmodel = jax_create_model(name)
    st = jax_state.create_train_state(jmodel, jax.random.PRNGKey(0), tx)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    st = st.replace(params=p, opt_state=tx.init(p),
                    batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    jax_step = jax.jit(jax_steps.make_train_step(augment=False))

    out = {"model": name, "batch": batch, "port": [], "jax": [],
           "param_rel_diff": []}
    for i in range(n_steps):
        x, y = batches[i % len(batches)]
        pm = port_step(state, (x, y))
        st, jm = jax_step(st, (jnp.asarray(x.numpy()),
                               jnp.asarray(y.numpy())),
                          jax.random.PRNGKey(1))
        lp = float(pm["loss_sum"]) / float(pm["count"])
        lj = float(jm["loss_sum"]) / float(jm["count"])
        want = state_dict_from_jax(name, jax.device_get(st.params),
                                   jax.device_get(st.batch_stats),
                                   model=model)
        got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
        rel = 0.0
        for k, w in want.items():
            if k.endswith("num_batches_tracked") or "running_" in k:
                continue
            scale = max(float(np.abs(w).max()), 1e-30)
            rel = max(rel, float(np.abs(got[k] - w).max()) / scale)
        out["port"].append(lp)
        out["jax"].append(lj)
        out["param_rel_diff"].append(rel)
        log(f"step {i + 1}: port loss {lp:.6g}, jax loss {lj:.6g}, "
            f"params rel diff {rel:.3g}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="PreActResNet34")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    out = curves(args.model, args.batch, args.steps,
                 log=lambda s: print(s, file=sys.stderr, flush=True))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
