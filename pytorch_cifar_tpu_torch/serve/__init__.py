"""Serving stack of the port: engine, micro-batcher, load generators, and
the wire: the PCTW frame (:mod:`~pytorch_cifar_tpu_torch.serve.wire`), the
threaded HTTP frontend (:mod:`~pytorch_cifar_tpu_torch.serve.frontend`),
the event-loop edge and its connection pool
(:mod:`~pytorch_cifar_tpu_torch.serve.edge`) and the multi-replica router
(:mod:`~pytorch_cifar_tpu_torch.serve.router`); and the checkpoint life
cycle: the hot-reload watcher
(:mod:`~pytorch_cifar_tpu_torch.serve.reload`), the canary promotion
controller and shadow tee (:mod:`~pytorch_cifar_tpu_torch.serve.canary`)
and its journal (:mod:`~pytorch_cifar_tpu_torch.serve.journal`); and the
multi-tenant zoo server (:mod:`~pytorch_cifar_tpu_torch.serve.tenancy`)
with the engine's int8 lane."""

from pytorch_cifar_tpu_torch.serve.batcher import (  # noqa: F401
    PRIORITIES,
    BatcherClosed,
    DeadlineExceeded,
    MicroBatcher,
    QueueFull,
)
from pytorch_cifar_tpu_torch.serve.canary import (  # noqa: F401
    CanaryBudget,
    GoldenSet,
    PromotionController,
    ShadowBackend,
)
from pytorch_cifar_tpu_torch.serve.engine import (  # noqa: F401
    InferenceEngine,
    load_checkpoint_trees,
)
from pytorch_cifar_tpu_torch.serve.edge import (  # noqa: F401
    EdgeFrontend,
    EdgePool,
)
from pytorch_cifar_tpu_torch.serve.frontend import (  # noqa: F401
    BatcherBackend,
    ServingFrontend,
)
from pytorch_cifar_tpu_torch.serve.loadgen import (  # noqa: F401
    HttpTarget,
    percentile_ms,
    run_async_load,
    run_load,
    zipf_mix,
)
from pytorch_cifar_tpu_torch.serve.journal import (  # noqa: F401
    ControllerJournal,
    FleetJournalState,
    JournalCorrupt,
    replay_journal,
)
from pytorch_cifar_tpu_torch.serve.reload import CheckpointWatcher  # noqa: F401
from pytorch_cifar_tpu_torch.serve.router import Router  # noqa: F401
from pytorch_cifar_tpu_torch.serve.tenancy import (  # noqa: F401
    ModelZooServer,
    TenantSpec,
    UnknownModel,
    load_cost_priors,
)
from pytorch_cifar_tpu_torch.serve import wire  # noqa: F401
