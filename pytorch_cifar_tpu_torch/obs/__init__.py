"""Observability of the port: metrics registry and trace spans (copies of
the JAX package's ``obs.metrics`` and ``obs.trace``)."""

from pytorch_cifar_tpu_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    merge_snapshots,
    summarize,
)
from pytorch_cifar_tpu_torch.obs import trace  # noqa: F401
