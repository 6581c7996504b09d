"""The serving tier of the port: the single server and the fleet.

Tenants register datasets once, then submit many preservation analyses;
the scheduler (:mod:`~netrep_tpu_torch.serve.scheduler`) packs concurrent
requests into shared union-bucket dispatches
(:mod:`~netrep_tpu_torch.serve.packer`, also the engine behind
:func:`~netrep_tpu_torch.models.grid.grid_preservation`) on warm pooled
engines (:mod:`~netrep_tpu_torch.serve.pool`), with admission control,
weighted round-robin fairness, deadlines, brownout, idempotency keys, a
write-ahead journal (:mod:`~netrep_tpu_torch.serve.journal`), fault
isolation and a telemetry/Prometheus ops surface. Served results give
each request's own ``module_preservation()`` numbers.

Surface::

    from netrep_tpu_torch.serve import (
        InProcessClient, PreservationServer, ServeConfig,
    )

The daemon (:mod:`~netrep_tpu_torch.serve.server`) speaks one JSON op a
line over a unix socket (:class:`SocketClient`); it starts with ``python
-m netrep_tpu_torch serve --socket PATH`` (on the card; ``--device cpu``
on the CPU), and ``serve --fleet N`` runs N replica daemons behind a
coordinator (:func:`~netrep_tpu_torch.serve.fleet.fleet_daemon`).

The fleet (:mod:`~netrep_tpu_torch.serve.fleet`): in-process replicas
behind a :class:`FleetCoordinator` — consistent-hash routing on dataset
digests (:class:`HashRing`), journal shipping, replica-kill failover,
fleet-wide admission, planned departures (retire, eviction handoff) under
the replica lifecycle machine (:mod:`~netrep_tpu_torch.serve.lifecycle`)
and an :class:`Autoscaler`::

    from netrep_tpu_torch.serve import build_inprocess_fleet

    fleet = build_inprocess_fleet(2, "fleet_dir")   # on the card
"""

from .client import InProcessClient, ServeRejected, SocketClient, retry_delay
from .fleet import (
    AutoscaleConfig, Autoscaler, DaemonReplica, FleetConfig,
    FleetCoordinator, HashRing, InProcessReplica, ReplicaLost,
    build_inprocess_fleet, dispatch_fleet_op, fleet_daemon,
    inprocess_spawner, spawn_replica_daemon,
)
from .journal import JournalShipper, RequestJournal
from .lifecycle import IllegalTransition, ReplicaLifecycle
from .packer import (
    GridPackedEngine, PackedEngine, PackMonitor, RequestPlan, assign_bases,
    run_pack,
)
from .pool import ProgramPool
from .scheduler import (
    PreservationServer, QueueFull, Request, ServeConfig, ServeError,
)

__all__ = [
    "PreservationServer",
    "ServeConfig",
    "ServeError",
    "QueueFull",
    "ServeRejected",
    "Request",
    "RequestJournal",
    "JournalShipper",
    "InProcessClient",
    "SocketClient",
    "ProgramPool",
    "GridPackedEngine",
    "PackedEngine",
    "PackMonitor",
    "RequestPlan",
    "assign_bases",
    "run_pack",
    "retry_delay",
    "ReplicaLost",
    "FleetConfig",
    "FleetCoordinator",
    "HashRing",
    "InProcessReplica",
    "DaemonReplica",
    "spawn_replica_daemon",
    "fleet_daemon",
    "build_inprocess_fleet",
    "inprocess_spawner",
    "dispatch_fleet_op",
    "Autoscaler",
    "AutoscaleConfig",
    "ReplicaLifecycle",
    "IllegalTransition",
]
