"""Masked statistics of the seven NetRep preservation statistics, in torch.

A port of ``netrep_tpu/ops/stats.py`` with the same semantics, formula for
formula: module-size variability is handled by pad-to-bucket plus a
``(..., m)`` validity mask, and padded entries contribute zero to every
mean, correlation, Gram matrix and power-iteration step. Every function
takes leading batch axes. These are the plain versions the CPU runs and the
fused-statistics kernel is held against; the observed pass also runs them
on the card with the exact ``eigh`` summary.

The TPU-only ``_mxu`` gather variants are not ported: a direct index gather
is exact on every device here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .oracle import N_STATS, STAT_NAMES  # noqa: F401  (canonical order)

_EPS = 1e-30


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=dim, keepdim=True)


# ---------------------------------------------------------------------------
# Masked building blocks
# ---------------------------------------------------------------------------

def masked_mean(x, w, dim=None) -> torch.Tensor:
    """Mean of ``x`` over entries where ``w`` (0/1 weights) is set."""
    w = _f32(w)
    x = _f32(x) * w
    if dim is None:
        return x.sum() / torch.clamp(w.sum(), min=_EPS)
    return x.sum(dim) / torch.clamp(w.sum(dim), min=_EPS)


def masked_pearson(x, y, w) -> torch.Tensor:
    """Pearson correlation of ``x`` and ``y`` over the masked entries of the
    last axis; NaN when either side is degenerate. Two passes: means first,
    then centred products."""
    w = _f32(w)
    x = _f32(x) * w
    y = _f32(y) * w
    n = torch.clamp(w.sum(-1), min=_EPS)
    mx = x.sum(-1) / n
    my = y.sum(-1) / n
    xc = (x - mx[..., None]) * w
    yc = (y - my[..., None]) * w
    cov = (xc * yc).sum(-1)
    vx = (xc * xc).sum(-1)
    vy = (yc * yc).sum(-1)
    denom = torch.sqrt(vx) * torch.sqrt(vy)
    return torch.where(
        denom > 0, cov / torch.clamp(denom, min=_EPS),
        torch.full_like(cov, float("nan")),
    )


def offdiag_mask(w) -> torch.Tensor:
    """(m, m) pair mask: both endpoints valid, diagonal excluded."""
    w = _f32(w)
    pair = w[..., :, None] * w[..., None, :]
    m = w.shape[-1]
    return pair * (1.0 - torch.eye(m, dtype=torch.float32, device=w.device))


def standardize_masked(data, w) -> torch.Tensor:
    """Column-standardize ``data`` (..., n_samples, m): mean 0, sd 1
    (ddof=1) per valid column; invalid or zero-variance columns become
    all-zero."""
    w = _f32(w)
    data = _f32(data) * w[..., None, :]
    ns = data.shape[-2]
    mu = data.mean(-2, keepdim=True)
    xc = data - mu
    var = (xc * xc).sum(-2, keepdim=True) / max(ns - 1, 1)
    sd = torch.sqrt(var)
    z = torch.where(sd > 0, xc / torch.clamp(sd, min=_EPS),
                    torch.zeros_like(xc))
    return z * w[..., None, :]


def weighted_degree_masked(net, w) -> torch.Tensor:
    """Within-module weighted degree over valid nodes, diagonal excluded."""
    return (_f32(net) * offdiag_mask(w)).sum(-1)


def summary_profile_masked(zdata, w, n_iter: int = 60,
                           method: str = "power") -> torch.Tensor:
    """Summary profile of a standardized masked module data slice
    ``(..., n_samples, m)``: its top left singular vector, sign-anchored to
    correlate positively with the module's mean node profile.

    ``method='power'`` runs ``n_iter`` masked power steps on the node-space
    Gram matrix ``G = Z^T Z``; ``method='eigh'`` takes the exact symmetric
    eigendecomposition. Returns the unit-norm ``(..., n_samples)`` profile.
    """
    w = _f32(w)
    gram = zdata.transpose(-1, -2) @ zdata
    if method == "eigh":
        _vals, vecs = torch.linalg.eigh(gram)
        v = vecs[..., :, -1] * w
    elif method == "power":
        batch = torch.broadcast_shapes(gram.shape[:-2], w.shape[:-1])
        v = w.expand(batch + w.shape[-1:])
        v = v / torch.clamp(_norm(v), min=_EPS)
        for _ in range(n_iter):
            v = (gram @ v[..., None])[..., 0] * w
            v = v / torch.clamp(_norm(v), min=_EPS)
    else:
        raise ValueError(f"unknown summary method: {method!r}")

    prof = (zdata @ v[..., None])[..., 0]
    prof = prof / torch.clamp(_norm(prof), min=_EPS)
    anchor = zdata.sum(-1)  # ∝ mean node profile over valid nodes
    sign = torch.sign((prof * anchor).sum(-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return prof * sign


def node_contribution_masked(zdata, prof, w) -> torch.Tensor:
    """Pearson correlation of each valid node's standardized data with the
    summary profile (normalized dot products: columns of ``zdata`` are
    mean-zero)."""
    p = prof - prof.mean(-1, keepdim=True)
    num = (zdata * p[..., :, None]).sum(-2)
    xn = torch.linalg.vector_norm(zdata, dim=-2)
    pn = _norm(p)
    denom = xn * pn
    nc = torch.where(denom > 0, num / torch.clamp(denom, min=_EPS),
                     torch.zeros_like(num))
    return nc * _f32(w)


# ---------------------------------------------------------------------------
# Discovery-side fixed properties
# ---------------------------------------------------------------------------

class DiscProps(NamedTuple):
    """Padded per-module discovery-side properties held fixed across the
    permutation null, padded to the bucket capacity ``m`` and masked by
    ``mask``. ``contrib``/``sign_contrib`` are all-zero in the data-less
    variant."""

    corr: torch.Tensor          # (..., m, m)
    sign_corr: torch.Tensor     # (..., m, m)
    degree: torch.Tensor        # (..., m)
    contrib: torch.Tensor       # (..., m)
    sign_contrib: torch.Tensor  # (..., m)
    mask: torch.Tensor          # (..., m) 0/1


def make_disc_props(corr, net, data, mask,
                    summary_method: str = "eigh") -> DiscProps:
    """Build :class:`DiscProps` from padded discovery submatrices; ``data``
    (..., n_samples, m) may be None (data-less variant)."""
    corr = _f32(corr)
    net = _f32(net)
    mask = _f32(mask)
    pair = offdiag_mask(mask)
    corr = corr * pair
    degree = (net * pair).sum(-1)
    if data is not None:
        z = standardize_masked(data, mask)
        prof = summary_profile_masked(z, mask, method=summary_method)
        contrib = node_contribution_masked(z, prof, mask)
    else:
        contrib = torch.zeros_like(degree)
    return DiscProps(
        corr=corr,
        sign_corr=torch.sign(corr),
        degree=degree,
        contrib=contrib,
        sign_contrib=torch.sign(contrib),
        mask=mask,
    )


# ---------------------------------------------------------------------------
# The seven statistics on gathered (padded) test submatrices
# ---------------------------------------------------------------------------

def stats_from_parts(disc: DiscProps, avg_weight, test_degree, test_corr,
                     test_zdata, n_iter: int = 60,
                     summary_method: str = "power") -> torch.Tensor:
    """Assemble the seven statistics from precomputed topology parts.
    ``test_corr`` must already be multiplied by the off-diagonal pair mask;
    statistics whose inputs are absent (None) come back NaN."""
    w = disc.mask
    pair = offdiag_mask(w)
    npair = torch.clamp(pair.sum((-1, -2)), min=_EPS)
    nanlike = torch.full_like(_f32(avg_weight), float("nan"))

    def flat(a):
        return a.reshape(*a.shape[:-2], -1)

    if test_corr is not None:
        cor_cor = masked_pearson(flat(disc.corr), flat(test_corr), flat(pair))
    else:
        cor_cor = nanlike

    cor_degree = masked_pearson(disc.degree, test_degree, w)

    if test_zdata is not None:
        prof = summary_profile_masked(test_zdata, w, n_iter=n_iter,
                                      method=summary_method)
        nc = node_contribution_masked(test_zdata, prof, w)
        coherence = masked_mean(nc * nc, w, dim=-1)
        cor_contrib = masked_pearson(disc.contrib, nc, w)
        avg_cor = (
            (disc.sign_corr * test_corr).sum((-1, -2)) / npair
            if test_corr is not None else nanlike
        )
        avg_contrib = masked_mean(disc.sign_contrib * nc, w, dim=-1)
    else:
        coherence = cor_contrib = avg_cor = avg_contrib = nanlike

    parts = [avg_weight, coherence, cor_cor, cor_degree, cor_contrib,
             avg_cor, avg_contrib]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def module_stats_masked(disc: DiscProps, test_corr, test_net, test_zdata,
                        n_iter: int = 60,
                        summary_method: str = "power") -> torch.Tensor:
    """The seven statistics for one (batched) padded test node set, as
    ``(..., 7)`` in :data:`STAT_NAMES` order; data statistics are NaN when
    ``test_zdata`` is None."""
    w = disc.mask
    pair = offdiag_mask(w)
    test_corr = _f32(test_corr) * pair
    test_net = _f32(test_net) * pair
    npair = torch.clamp(pair.sum((-1, -2)), min=_EPS)
    avg_weight = test_net.sum((-1, -2)) / npair
    test_degree = test_net.sum(-1)
    return stats_from_parts(
        disc, avg_weight, test_degree, test_corr, test_zdata,
        n_iter=n_iter, summary_method=summary_method,
    )


def gather_zdata(test_dataT, idx, mask) -> torch.Tensor:
    """Per-module data columns out of the TRANSPOSED ``(n, n_samples)`` data
    matrix, standardized: ``(..., n_samples, m)`` for ``idx`` ``(..., m)``."""
    sub_d = test_dataT[idx.long()]                    # (..., m, n_samples)
    return standardize_masked(sub_d.transpose(-1, -2), mask)


#: soft-threshold constructions :func:`derived_net` can apply (the three
#: WGCNA adjacency types)
DERIVED_NET_KINDS = ("unsigned", "signed", "signed-hybrid")


def normalize_net_beta(net_beta) -> tuple[float, str]:
    """Resolve a bare power β (meaning unsigned) or a ``(β, kind)`` pair
    into ``(float, kind)``."""
    if isinstance(net_beta, tuple):
        if len(net_beta) != 2:
            raise ValueError(
                "network_from_correlation must be a power β or a "
                f"(β, kind) pair, got a {len(net_beta)}-tuple: {net_beta!r}"
            )
        beta, kind = net_beta
    else:
        beta, kind = net_beta, "unsigned"
    if kind not in DERIVED_NET_KINDS:
        raise ValueError(
            f"derived-network kind must be one of {DERIVED_NET_KINDS}, "
            f"got {kind!r}"
        )
    try:
        return float(beta), kind
    except (TypeError, ValueError):
        raise ValueError(
            "network_from_correlation power must be numeric, got "
            f"{beta!r}"
        ) from None


def derived_net(sub_corr, net_beta) -> torch.Tensor:
    """Soft-threshold network submatrix derived from the gathered
    correlation: ``|corr|**β`` (unsigned), ``((1+corr)/2)**β`` (signed) or
    ``max(corr, 0)**β`` (signed hybrid)."""
    beta, kind = normalize_net_beta(net_beta)
    if kind == "signed":
        return torch.clamp((1.0 + sub_corr) * 0.5, min=0.0) ** beta
    if kind == "signed-hybrid":
        return torch.clamp(sub_corr, min=0.0) ** beta
    return torch.abs(sub_corr) ** beta


def gather_submatrix(M, idx) -> torch.Tensor:
    """``M[idx[..., a], idx[..., b]]`` as ``(..., m, m)`` — the exact index
    gather."""
    idx = idx.long()
    return M[idx[..., :, None], idx[..., None, :]]


def gather_and_stats(disc: DiscProps, idx, test_corr, test_net, test_dataT,
                     n_iter: int = 60, summary_method: str = "power",
                     net_beta=None) -> torch.Tensor:
    """Gather a module's test submatrices by index and compute the seven
    statistics. ``idx`` ``(..., m)`` may carry any in-range value at padded
    positions (the mask zeroes their influence); ``test_net`` None derives
    the network from the gathered correlation with ``net_beta``."""
    sub_corr = gather_submatrix(test_corr, idx)
    sub_net = (
        derived_net(sub_corr, net_beta) if test_net is None
        else gather_submatrix(test_net, idx)
    )
    zdata = (
        gather_zdata(test_dataT, idx, disc.mask)
        if test_dataT is not None else None
    )
    return module_stats_masked(
        disc, sub_corr, sub_net, zdata, n_iter=n_iter,
        summary_method=summary_method,
    )
