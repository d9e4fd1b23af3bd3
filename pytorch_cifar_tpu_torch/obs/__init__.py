"""Observability of the port: metrics registry, trace spans and the
exporters (copies of the JAX package's ``obs.metrics``, ``obs.trace`` and
``obs.export``)."""

from pytorch_cifar_tpu_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    merge_snapshots,
    summarize,
)
from pytorch_cifar_tpu_torch.obs import trace  # noqa: F401
from pytorch_cifar_tpu_torch.obs.export import (  # noqa: F401
    MetricsExporter,
    prometheus_text,
    write_prometheus,
)
