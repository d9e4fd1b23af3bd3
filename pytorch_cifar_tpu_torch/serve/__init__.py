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
with the engine's int8 lane; and the fleet control plane
(:mod:`~pytorch_cifar_tpu_torch.serve.fleet`): the autoscaling, journaled,
restart-safe :class:`FleetController` with its rolling deploys, and the
:class:`JournalFollower` that keeps a remote edge's router on the
journal's membership; and serving over a device group: the engine's
``num_devices`` and the multi-process replica
(:mod:`~pytorch_cifar_tpu_torch.serve.mesh_replica`), whose
:class:`MeshReplica` presents ranks of one engine to the router as one
replica.

The names below are imported on first use (PEP 562), not with the
package: the fleet launchers (``tools/router_run.py``,
``tools/fleet_run.py``) import the router, frontends, journal and
controller, never a device, and so start without loading torch (most of
a replica's start on the card)."""

import importlib

# exported name -> the submodule that defines it
_EXPORTS = {
    "batcher": (
        "PRIORITIES", "BatcherClosed", "DeadlineExceeded", "MicroBatcher",
        "QueueFull", "UnknownModel",
    ),
    "canary": (
        "CanaryBudget", "GoldenSet", "PromotionController", "ShadowBackend",
    ),
    "engine": ("InferenceEngine", "load_checkpoint_trees"),
    "edge": ("EdgeFrontend", "EdgePool"),
    "fleet": (
        "FleetController", "FleetPolicy", "FleetSignals", "HttpGoldenGate",
        "ScalingEvaluator", "recover_controller",
    ),
    "frontend": ("BatcherBackend", "ServingFrontend"),
    "mesh_replica": (
        "PEER_TIMEOUT_RC", "MeshReplica", "MeshReplicaClosed",
        "MeshReplicaError",
    ),
    "loadgen": (
        "HttpTarget", "percentile_ms", "run_async_load", "run_load",
        "zipf_mix",
    ),
    "journal": (
        "ControllerJournal", "FleetJournalState", "JournalCorrupt",
        "JournalFollower", "replay_journal",
    ),
    "priors": ("load_cost_priors",),
    "reload": ("CheckpointWatcher",),
    "router": ("Router",),
    "tenancy": ("ModelZooServer", "TenantSpec"),
}
_HOME = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_HOME) + ["wire"]


def __getattr__(name: str):
    if name in _HOME:
        module = importlib.import_module(f"{__name__}.{_HOME[name]}")
        value = getattr(module, name)
        globals()[name] = value
        return value
    if name in _EXPORTS or name == "wire":  # a submodule, as before
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
