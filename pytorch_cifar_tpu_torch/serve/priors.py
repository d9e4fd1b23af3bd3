"""The zoo's per-model cost priors: train img/s per model from the card's
sweep (``tools/zoo_bench.py --all`` writes ``tools/zoo_sweep_h100.json``).

They seed the zoo's LRU clock and placement order
(:class:`~pytorch_cifar_tpu_torch.serve.tenancy.ModelZooServer`) and rank
a zipf traffic mix (:func:`~pytorch_cifar_tpu_torch.serve.loadgen.zipf_mix`).
No torch here: the launchers and the drill's own process draw their mix
without loading it.
"""

from __future__ import annotations

import json
import os
from typing import Dict

COST_PRIORS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tools", "zoo_sweep_h100.json",
)


def load_cost_priors(path: str = COST_PRIORS_PATH) -> Dict[str, float]:
    """Per-model img/s priors from the zoo sweep (``results.<model>.
    images_per_sec``). Missing/unreadable file -> {} — priors only seed
    the LRU clock and placement order; real traffic overrides them."""
    try:
        with open(path) as f:
            sweep = json.load(f)
        return {
            name: float(entry["images_per_sec"])
            for name, entry in sweep.get("results", {}).items()
            if isinstance(entry, dict) and "images_per_sec" in entry
        }
    except (OSError, ValueError, TypeError):
        return {}
