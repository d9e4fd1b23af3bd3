"""Host utilities of the port: the rank-aware logger and the progress bar
(copies of ``pytorch_cifar_tpu/utils``)."""

from pytorch_cifar_tpu_torch.utils.logging import set_logger  # noqa: F401
from pytorch_cifar_tpu_torch.utils.progress import (  # noqa: F401
    format_time,
    progress_bar,
)
