"""Training CLI of the port, the counterpart of ``train.py``:

    python -m pytorch_cifar_tpu_torch.train --model ResNet18 --batch_size 512
    python -m pytorch_cifar_tpu_torch.train --device cpu --model LeNet \\
        --synthetic_data --epochs 2 --no-amp --output_dir ./checkpoint
    python -m pytorch_cifar_tpu_torch.train ... --resume --epochs 4
    python -m pytorch_cifar_tpu_torch.train ... --evaluate

Flags are the JAX package's (``config.py``) for the ported path, plus
``--device``. Runs on CUDA unless ``--device cpu`` is given. Logs the JAX
trainer's epoch lines to stderr and prints the best test accuracy.
Checkpoints go to ``--output_dir`` in the JAX package's format, so either
trainer resumes the other's run; ``--resume`` continues from the newest
checkpoint there, ``--evaluate`` runs one eval epoch of the best one and
prints its accuracy. SIGTERM stops after the current epoch with the state
saved as ``last.msgpack``.
"""

from __future__ import annotations

import logging
import sys

from pytorch_cifar_tpu_torch.config import parse_config


def main(argv=None) -> dict:
    """Train; returns the best test accuracy (``fit``'s value, what
    ``train.py`` returns) and the per-epoch history, whose ``train`` and
    ``eval`` entries carry the JAX step's metric totals (``loss_sum``,
    ``correct``, ``count``, ``nonfinite``)."""
    config = parse_config(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(message)s",
                            stream=sys.stderr)
    from pytorch_cifar_tpu_torch.train.trainer import Trainer

    trainer = Trainer(config)
    best = trainer.fit()
    what = "test accuracy" if config.evaluate else "best test accuracy"
    print(f"{what}: {best:.2f}%")
    return {"best_acc": best, "history": trainer.history}


if __name__ == "__main__":
    main()
