"""A ``(perm, row)`` grid of devices for one process.

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

The elastic helpers ``mesh_spec``, ``mesh_from_spec`` and ``shrink_mesh``
belong to the fault ladder and are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import config

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
    each axis name to its size (as ``jax.sharding.Mesh.shape``)."""

    def __init__(self, devices: np.ndarray, axis_names=(PERM_AXIS, ROW_AXIS)):
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

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices[0, 0].type

    def perm_row(self, p: int) -> "Mesh":
        """The ``(1, n_row_shards)`` mesh of perm shard ``p``: the devices
        that hold its row blocks."""
        return Mesh(self.devices[p: p + 1], self.axis_names)


def resolve_device(mesh: Mesh | None, device) -> torch.device:
    """Where a run's unsharded operands live: ``device`` (None means the
    card), or with a mesh its first device — after checking that the mesh
    lies on the kind of device the caller named, so a mesh of cards never
    runs on the CPU and a CPU mesh runs only when asked for."""
    dev = config.resolve_device(device)
    if mesh is None:
        return dev
    if mesh.device_type != dev.type:
        raise ValueError(
            f"the mesh's devices are {mesh.device_type!r} devices but "
            f"device={device!r}; name the device type the mesh is built on"
        )
    return mesh.devices[0, 0]


def make_mesh(n_perm_shards: int | None = None, n_row_shards: int = 1,
              devices=None) -> Mesh:
    """Build a ``(perm, row)`` mesh over ``devices`` (None means every
    visible card, and raises without one, as every entry point of the port
    does). Defaults to all devices on the permutation axis. Devices are laid
    out perm-major, as in the JAX package: perm shard p holds ``devices[p *
    n_row_shards: (p + 1) * n_row_shards]``. A mesh smaller than the device
    list takes its first devices; one larger raises."""
    if devices is None:
        config.resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
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
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(n_perm_shards, n_row_shards))
