"""The serving tier of the port. Only the cross-request packer is here so
far (:mod:`netrep_tpu_torch.serve.packer`, the engine behind
:func:`~netrep_tpu_torch.models.grid.grid_preservation`); the scheduler,
server and fleet are ROADMAP.md Queue 1 items 15.3 and 16b."""

from .packer import (
    GridPackedEngine, PackedEngine, PackMonitor, RequestPlan, assign_bases,
    run_pack,
)

__all__ = [
    "GridPackedEngine", "PackedEngine", "PackMonitor", "RequestPlan",
    "assign_bases", "run_pack",
]
