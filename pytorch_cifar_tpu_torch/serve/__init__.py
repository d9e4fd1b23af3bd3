"""Serving stack of the port: engine, micro-batcher, closed-loop load."""

from pytorch_cifar_tpu_torch.serve.batcher import (  # noqa: F401
    BatcherClosed,
    DeadlineExceeded,
    MicroBatcher,
    QueueFull,
)
from pytorch_cifar_tpu_torch.serve.engine import InferenceEngine  # noqa: F401
from pytorch_cifar_tpu_torch.serve.loadgen import (  # noqa: F401
    percentile_ms,
    run_load,
)
