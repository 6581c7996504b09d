"""A ``(perm, row)`` grid of devices, driven by one process or several.

The port of ``netrep_tpu/parallel/mesh.py``'s :func:`make_mesh`. The JAX
package is single-controller: one process, a ``jax.sharding.Mesh`` of
devices, and ``shard_map`` over it. Its counterpart here is one process
that drives a grid of ``torch.device``\\ s and places each shard's tensors
on its device itself (:mod:`netrep_tpu_torch.parallel.sharded`).

Axes, as in the JAX package:

- ``perm`` — permutations split over shards (data parallelism);
- ``row`` — the n×n matrices split by rows; a module gather then sums
  each row block's share (the psum) or streams the blocks around a ring
  (:func:`netrep_tpu_torch.ops.fused_stats.ring_gather_all`).

A device may repeat in the grid: ``make_mesh(1, 4, devices=[cuda:0] * 4)``
is four row shards on one card, ``devices=[torch.device("cpu")] * 8`` the
counterpart of the JAX tests' virtual 8-device CPU mesh. Shards that share
a device run one after another there and share its memory.

After :func:`~netrep_tpu_torch.parallel.distributed.initialize` has
joined several processes, :func:`make_mesh` builds the global mesh: each
process names its own devices and holds whole perm rows, laid out in
process order, so the ``perm`` axis spans the processes and the ``row``
axis stays inside one (``Mesh.ranks`` says which process drives each
position). A process runs only its own positions' shards.

The elastic helpers of the fault ladder — :func:`mesh_spec`,
:func:`mesh_from_spec` and :func:`shrink_mesh` — are the JAX package's,
over this grid, for a mesh of one process.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import config
from . import distributed

PERM_AXIS = "perm"
ROW_AXIS = "row"


def _normalize(device) -> torch.device:
    """A ``torch.device`` with its index filled in (``"cuda"`` means the
    current card), so equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ``(perm, row)`` grid of ``torch.device``\\ s: ``devices`` is the
    object array of shape ``(n_perm_shards, n_row_shards)``, ``shape`` maps
    each axis name to its size (as ``jax.sharding.Mesh.shape``).
    ``ranks``, of the same shape, names the process that drives each
    position (default: this process everywhere); at another process's
    position ``devices`` holds the device of the same local index here."""

    def __init__(self, devices: np.ndarray, axis_names=(PERM_AXIS, ROW_AXIS),
                 ranks: np.ndarray | None = None):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(
                f"a mesh needs a non-empty 2-D grid of devices, got shape "
                f"{devices.shape}"
            )
        grid = np.empty(devices.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = _normalize(devices[pos])
        types = {d.type for d in grid.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh mixes device types {sorted(types)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.rank = distributed.process_index()
        self.ranks = (np.full(grid.shape, self.rank, dtype=np.int64)
                      if ranks is None else np.asarray(ranks, np.int64))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices[0, 0].type

    @property
    def spans_processes(self) -> bool:
        """Whether other processes drive some of the mesh's positions."""
        return bool((self.ranks != self.rank).any())

    def is_local(self, p: int, r: int) -> bool:
        """Whether this process drives position ``(p, r)``."""
        return int(self.ranks[p, r]) == self.rank

    def perm_row(self, p: int) -> "Mesh":
        """The ``(1, n_row_shards)`` mesh of perm shard ``p``: the devices
        that hold its row blocks."""
        return Mesh(self.devices[p: p + 1], self.axis_names,
                    self.ranks[p: p + 1])


def resolve_device(mesh: Mesh | None, device) -> torch.device:
    """Where a run's unsharded operands live: ``device`` (None means the
    card), or with a mesh its first device this process drives — after
    checking that the mesh lies on the kind of device the caller named, so
    a mesh of cards never runs on the CPU and a CPU mesh runs only when
    asked for."""
    dev = config.resolve_device(device)
    if mesh is None:
        return dev
    if mesh.device_type != dev.type:
        raise ValueError(
            f"the mesh's devices are {mesh.device_type!r} devices but "
            f"device={device!r}; name the device type the mesh is built on"
        )
    p, r = np.argwhere(mesh.ranks == mesh.rank)[0]
    return mesh.devices[p, r]


def make_mesh(n_perm_shards: int | None = None, n_row_shards: int = 1,
              devices=None) -> Mesh:
    """Build a ``(perm, row)`` mesh over ``devices`` (None means every
    visible card, and raises without one, as every entry point of the port
    does). Defaults to all devices on the permutation axis. Devices are laid
    out perm-major, as in the JAX package: perm shard p holds ``devices[p *
    n_row_shards: (p + 1) * n_row_shards]``. A mesh smaller than the device
    list takes its first devices; one larger raises.

    In a process group (:mod:`~netrep_tpu_torch.parallel.distributed`)
    ``devices`` are this process's, every process names as many, and the
    mesh lays the processes' devices out in process order: the shapes
    count all of them, each process takes an equal share of the positions
    (its first devices), and a share holds whole perm rows, so the row
    axis never spans processes."""
    if devices is None:
        config.resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    world = distributed.process_count()
    if world > 1:
        counts = distributed.all_gather_object(len(devices))
        if len(set(counts)) != 1:
            raise ValueError(f"processes name different device counts "
                             f"{counts}; a mesh needs as many in each")
    n = len(devices) * world
    if n_perm_shards is None:
        if n % n_row_shards:
            raise ValueError(
                f"{n} devices not divisible by n_row_shards={n_row_shards}"
            )
        n_perm_shards = n // n_row_shards
    need = n_perm_shards * n_row_shards
    if need > n:
        raise ValueError(
            f"mesh {n_perm_shards}×{n_row_shards} needs {need} devices, "
            f"have {n}"
        )
    share = need // world
    if world > 1 and (need % world or share % n_row_shards):
        raise ValueError(
            f"mesh {n_perm_shards}×{n_row_shards} over {world} processes: "
            "each process must hold an equal number of whole perm rows"
        )
    grid = np.empty(need, dtype=object)
    grid[:] = [devices[i % share] for i in range(need)]
    ranks = np.arange(need) // share
    return Mesh(grid.reshape(n_perm_shards, n_row_shards),
                ranks=ranks.reshape(n_perm_shards, n_row_shards))


def mesh_spec(mesh: Mesh | None):
    """``(devices, n_perm_shards, n_row_shards)`` of a mesh, or None — the
    record the elastic ladder keeps of the original capacity, so the
    grow-back rung can rebuild it after the superseded :class:`Mesh` and
    the engine tensors placed over it are gone."""
    if mesh is None:
        return None
    return (
        tuple(mesh.devices.flat),
        int(mesh.shape.get(PERM_AXIS, mesh.devices.size)),
        int(mesh.shape.get(ROW_AXIS, 1)),
    )


def mesh_from_spec(spec) -> Mesh | None:
    """Rebuild a mesh from :func:`mesh_spec` — the grow-back rung."""
    if spec is None:
        return None
    devices, n_perm, n_row = spec
    return make_mesh(
        n_perm_shards=n_perm, n_row_shards=n_row, devices=list(devices)
    )


def shrink_mesh(devices, like: Mesh) -> Mesh:
    """A ``(perm, row)`` mesh over the surviving devices (the shrink rung),
    keeping as much of ``like``'s row sharding as still divides the
    survivor count: the row axis gets the largest common divisor of
    (survivors, old row size), and the rest rides the permutation axis."""
    n = len(devices)
    if n < 1:
        raise ValueError("shrink_mesh needs at least one surviving device")
    old_row = int(like.shape.get(ROW_AXIS, 1))
    row = max(
        f for f in range(1, old_row + 1) if n % f == 0 and old_row % f == 0
    )
    return make_mesh(
        n_perm_shards=n // row, n_row_shards=row, devices=list(devices)
    )

