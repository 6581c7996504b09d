"""The frozen cost count of the null's statistics, and the table of peaks.

A copy of the counting rule of ``netrep_tpu_torch/utils/costmodel.py`` at
commit 53bdfe689d3220fe33f3e7b7699923adc36ce31a (``_cell_flops``,
``_cell_bytes``, ``_chunk_bytes``, ``PEAK_TABLE``), kept here so that a
kernel's roofline reads the same work whatever implements it. Per
(module, permutation) cell, ``m`` the module's size, ``s`` the samples,
``p`` the power steps, ``w`` the storage width: bytes are each needed input
entry once (the ``m(m-1)/2`` distinct off-diagonal entries of each stored
symmetric test matrix, ``m`` data rows, ``m`` int32 indices) and the outputs
once (7 float32 values; or, counting, the tallies once a chunk); operations
``15·m(m-1)`` for the topology, ``12·s·m`` for the data and contributions,
and the power iteration the cheaper way. Once a chunk each module's float32
discovery properties are read.
"""

from __future__ import annotations

#: ``(float32 FLOP/s outside the tensor cores, HBM bytes/s)`` by the
#: lowercase card name: NVIDIA H100 data sheet, SXM part, at 700 W
PEAKS = {"nvidia h100 80gb hbm3": (67e12, 3.35e12)}


def cell_flops(m: int, s: int, p: int) -> int:
    lo, hi = min(m, s), max(m, s)
    return 15 * m * (m - 1) + 12 * s * m + min(4 * p * s * m,
                                               lo * lo * hi + 2 * lo * lo * p)


def cell_bytes(m: int, s: int, n_mats: int, width: int, counting: bool) -> int:
    b = n_mats * (m * (m - 1) // 2) * width + m * s * width + 4 * m
    return b if counting else b + 7 * 4


def chunk_bytes(m: int, counting: bool) -> int:
    b = (2 * m * m + 4 * m) * 4
    return b + 2 * 3 * 7 * 4 + 7 * 4 if counting else b


def per_perm(shape: dict, counting: bool) -> tuple[float, float]:
    """``(operations, bytes)`` of one permutation over every module."""
    s, p = shape["samples"], shape["power_iters"]
    flops = sum(cell_flops(m, s, p) for m in shape["sizes"])
    nbytes = sum(cell_bytes(m, s, shape["n_mats"], shape["width"], counting)
                 + chunk_bytes(m, counting) / shape["chunk"]
                 for m in shape["sizes"])
    return float(flops), float(nbytes)


def least_seconds(shape: dict, counting: bool, perms: float,
                  card: str) -> float | None:
    """The least time the card could take for ``perms`` permutations: the
    larger of operations over peak FLOP/s and bytes over peak bytes/s; None
    for a card the table does not hold."""
    peak = PEAKS.get(card.strip().lower())
    if peak is None:
        return None
    flops, nbytes = per_perm(shape, counting)
    return perms * max(flops / peak[0], nbytes / peak[1])
