"""``TiledNetwork`` — the data-only network spec whose correlation and
adjacency values exist only as on-demand tiles.

The port's copy of ``netrep_tpu/atlas/tiles.py`` (host numpy, the same
operations in the same order, so every array here equals the JAX
package's bit for bit). At atlas scale (100,000+ genes) a dense ``n × n``
float32 correlation and adjacency pair is ~80 GB, while the data it derives
from is ``O(n·samples)``. This module holds that derivation as a spec:
centered data columns plus the soft-threshold ``beta`` (the WGCNA
construction, :func:`netrep_tpu_torch.ops.stats.derived_net`), and computes
any (I, J) tile of the correlation (``zᵀ[:, I] z[:, J]/(s-1)``) or
adjacency (``|r|**β`` et al.) on demand.

Two value planes, one spec:

- **host reference plane** (:meth:`TiledNetwork.corr_tile`): float64, in
  ``np.corrcoef``'s operation order (centered variables-as-rows layout,
  product, multiply by the reciprocal of ``s-1``, divide by the stddevs,
  clip), with its degenerate-input semantics: a zero-variance column gives
  0/0 = NaN across its whole row and column, where ``np.corrcoef`` puts
  them;
- **device plane** (:meth:`TiledNetwork.z32` + the builder's tile
  products, :mod:`netrep_tpu_torch.atlas.builder`): float32 standardized
  columns.

:meth:`TiledNetwork.from_data` rejects zero-variance columns up front with
an informative error; ``allow_degenerate=True`` keeps them for callers
pinning the NaN propagation itself.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .modules import normalize_beta_static


def _normalize_beta(beta) -> tuple[float, str]:
    b, kind = normalize_beta_static(beta)
    if not b > 0:
        raise ValueError(f"soft-threshold power must be > 0, got {b!r}")
    return b, kind


def derived_net_np(r: np.ndarray, beta) -> np.ndarray:
    """Host (numpy) twin of :func:`netrep_tpu_torch.ops.stats.derived_net`:
    the soft-threshold adjacency of a correlation tile."""
    b, kind = _normalize_beta(beta)
    if kind == "signed":
        return np.clip((1.0 + r) * 0.5, 0.0, None) ** b
    if kind == "signed-hybrid":
        return np.clip(r, 0.0, None) ** b
    return np.abs(r) ** b


@dataclasses.dataclass(frozen=True)
class TiledNetwork:
    """Data-only network spec: centered data columns + soft-threshold β.

    ``xc`` is the (n, s) float64 CENTERED data in ``np.cov``'s
    variables-as-rows layout; ``stddev`` the per-column ddof-1 standard
    deviations. Build with :meth:`from_data`.
    """

    xc: np.ndarray                 # (n, s) float64 centered columns
    stddev: np.ndarray             # (n,) float64 ddof-1 sd (0 = degenerate)
    beta: tuple                    # normalized (β, kind)
    node_names: list[str] | None = None

    @property
    def n(self) -> int:
        return self.xc.shape[0]

    @property
    def n_samples(self) -> int:
        return self.xc.shape[1]

    @classmethod
    def from_data(cls, data, beta, names: Sequence[str] | None = None,
                  allow_degenerate: bool = False) -> "TiledNetwork":
        """Validate and standardize a (n_samples, n) data matrix into a
        tile spec. Refuses non-2-D or non-finite data, fewer than 2
        samples, and, unless ``allow_degenerate``, zero-variance columns,
        whose correlations are NaN (``np.corrcoef`` semantics)."""
        arr = np.asarray(data, dtype=np.float64)
        if arr.ndim != 2:
            raise ValueError(
                f"data must be a 2-dimensional (n_samples, n_nodes) "
                f"matrix, got {arr.ndim} dimension(s)"
            )
        if arr.shape[0] < 2:
            raise ValueError(
                f"data needs at least 2 samples to correlate, got "
                f"{arr.shape[0]}"
            )
        if not np.isfinite(arr).all():
            raise ValueError(
                "data contains non-finite values (NA/NaN/Inf are not "
                "allowed)"
            )
        beta_n = _normalize_beta(beta)
        s, n = arr.shape
        X = np.ascontiguousarray(arr.T)              # (n, s) cov layout
        X = X - np.average(X, axis=1)[:, None]
        rcp = np.true_divide(1, s - 1)
        # stddev from block diagonals: the dot products corrcoef's
        # diag(cov) takes, block by block
        d = np.empty(n)
        edge = 4096
        for j0 in range(0, n, edge):
            blk = X[j0: j0 + edge]
            d[j0: j0 + edge] = np.einsum("is,is->i", blk, blk) * rcp
        stddev = np.sqrt(d)
        if not allow_degenerate and (stddev == 0).any():
            bad = np.flatnonzero(stddev == 0)
            raise ValueError(
                f"data has {bad.size} zero-variance (constant) column(s), "
                f"e.g. positions {bad[:3].tolist()}: their correlations "
                "are NaN (np.corrcoef semantics) and the preservation "
                "statistics are undefined — drop or jitter these nodes, "
                "exactly as the dense surface's non-finite-correlation "
                "check would demand"
            )
        if names is not None:
            names = [str(nm) for nm in names]
            if len(names) != n:
                raise ValueError(
                    f"names has {len(names)} entries but data has {n} "
                    "columns"
                )
            if len(set(names)) != n:
                raise ValueError("duplicate node names")
        return cls(xc=X, stddev=stddev, beta=beta_n,
                   node_names=list(names) if names is not None else None)

    # -- host reference plane (float64, corrcoef op order) -----------------

    def corr_tile(self, I, J) -> np.ndarray:
        """The (I, J) correlation tile in ``np.corrcoef``'s operation order,
        NaN propagation from zero-variance columns included. ``I``/``J``
        are index arrays or slices."""
        rcp = np.true_divide(1, self.n_samples - 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            c = (self.xc[I] @ self.xc[J].T) * rcp
            c /= self.stddev[I][:, None]
            c /= self.stddev[J][None, :]
        np.clip(c, -1, 1, out=c)
        return c

    def adjacency_tile(self, I, J) -> np.ndarray:
        """The (I, J) soft-threshold adjacency tile ``derived_net(r, β)``
        (diagonal untouched: consumers mask self-pairs)."""
        return derived_net_np(self.corr_tile(I, J), self.beta)

    # -- device plane ------------------------------------------------------

    def z32(self) -> np.ndarray:
        """(n, s) float32 standardized columns for the tile products:
        ``z[i]·z[j] = r_ij`` (each column scaled by ``1/(sd·√(s-1))``).
        Degenerate columns (sd 0) become all-zero."""
        with np.errstate(divide="ignore", invalid="ignore"):
            z = self.xc / (self.stddev * np.sqrt(self.n_samples - 1))[:, None]
        return np.nan_to_num(z, nan=0.0, posinf=0.0, neginf=0.0).astype(
            np.float32
        )

    def spec_digest(self) -> str:
        """Content identity of this spec: the data's sample digest and the
        derivation (β, kind), equal to the JAX package's for the same data
        (:func:`netrep_tpu_torch.utils.checkpoint.content_digest`), so a
        checkpoint never mixes two derivations of the same data."""
        from ..utils.checkpoint import content_digest

        b, kind = self.beta
        return f"{content_digest([self.xc])}|beta:{b:g}|{kind}"

    # -- column-moment cache (exact tile screening) ------------------------

    def column_moments(self, segments: int = 8) -> np.ndarray:
        """Per-column sample-segment norms of the device plane: the
        ``(n, P)`` float64 matrix ``A`` with ``A[j, p] = ‖z_j over sample
        segment p‖`` of the :meth:`z32` columns (``Σ_p A[j, p]² = 1`` for
        non-degenerate columns). By Cauchy–Schwarz per segment,

            ``|r_ij| = |Σ_p z_i⁽ᵖ⁾·z_j⁽ᵖ⁾| ≤ Σ_p A[i, p]·A[j, p]``

        — the bound every screening decision derives from. Computed once
        per (spec, P) and memoized on the instance, in row chunks.
        """
        P = max(1, min(int(segments), self.n_samples))
        cache = self.__dict__.get("_moment_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_moment_cache", cache)
        if P not in cache:
            s = self.n_samples
            starts = (np.arange(P, dtype=np.int64) * s) // P
            z = self.z32()
            A = np.empty((self.n, P), dtype=np.float64)
            blk = 1 << 16
            for i0 in range(0, self.n, blk):
                zz = z[i0: i0 + blk].astype(np.float64)
                A[i0: i0 + blk] = np.add.reduceat(zz * zz, starts, axis=1)
            np.sqrt(A, out=A)
            cache[P] = A
        return cache[P]


# -- screening bound tables -------------------------------------------------


def tile_norm_maxima(A: np.ndarray, edge: int, n_tiles: int) -> np.ndarray:
    """Per-tile segment-norm maxima: ``M[t, p] = max_{j in tile t} A[j, p]``
    for ``n_tiles`` column tiles of ``edge`` genes (tiles past the real
    columns are all-zero). ``min(1, M_I · M_J)`` bounds every ``|r_ij|`` in
    the (I, J) tile."""
    n, P = A.shape
    M = np.zeros((n_tiles, P), dtype=np.float64)
    full = min(n // edge, n_tiles)
    if full:
        M[:full] = A[: full * edge].reshape(full, edge, P).max(axis=1)
    if full < n_tiles and full * edge < n:
        M[full] = A[full * edge:].max(axis=0)
    return M


def supertile_maxima(M: np.ndarray, factor: int) -> np.ndarray:
    """Maxima over groups of ``factor`` consecutive tiles: the super-tile
    bound table of the two-resolution screen. A super-tile bound dominates
    every member tile's bound, so pruning at the coarse level is exact."""
    T, P = M.shape
    G = -(-T // factor)
    MS = np.zeros((G, P), dtype=np.float64)
    for g in range(G):
        MS[g] = M[g * factor: (g + 1) * factor].max(axis=0)
    return MS
