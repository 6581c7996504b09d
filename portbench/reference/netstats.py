"""The seven NetRep preservation statistics in plain PyTorch, batched over
permutations, in float64 (the reference) or in TF32 (the control).

The definitions are those of NetRep's ``modulePreservation`` (Ritchie et
al., Cell Systems 2016), in the order ``STAT_NAMES``:

- ``avg.weight``: mean off-diagonal weight of the test network submatrix;
- ``coherence``: mean squared node contribution;
- ``cor.cor``: Pearson correlation of the off-diagonal discovery and test
  correlation entries;
- ``cor.degree``: Pearson correlation of the within-module weighted
  degrees (row sums, diagonal excluded);
- ``cor.contrib``: Pearson correlation of the node contributions;
- ``avg.cor``: mean of ``sign(discovery corr) * test corr`` off the
  diagonal;
- ``avg.contrib``: mean of ``sign(discovery contribution) * test
  contribution``.

A module's data slice is column-standardized (ddof 1, a constant column
becomes 0); its summary profile is the top left singular vector of that
slice, signed to agree with the slice's row sums; a node's contribution is
its Pearson correlation with the profile. The profile comes either exactly
(``eigh`` of the Gram matrix: the observed pass and the discovery side) or
by ``n_iter`` power steps on the Gram matrix from the uniform vector (the
null, as the configuration states). A degenerate Pearson correlation is NaN.

Two statistics take the sign of a discovery value (``avg.cor`` of the
correlation, ``avg.contrib`` of the contribution). Where that value lies
within ``SIGN_TOL`` of zero its sign is a matter of rounding, so the
reference gives those two statistics as an interval: ``module_stats``
returns each value with a half-width, zero for the other five statistics
and wherever no discovery value is that close to zero.

``Precision('tf32')`` is the control: float32 elements, and every matrix
product's operands rounded to TF32 (10 mantissa bits, to nearest even)
before a float32 product, as a tensor core takes them, on any device.
"""

from __future__ import annotations

import dataclasses

import torch

STAT_NAMES = ("avg.weight", "coherence", "cor.cor", "cor.degree",
              "cor.contrib", "avg.cor", "avg.contrib")
_EPS = 1e-30
#: a discovery value this close to zero has no sign the float32 port and
#: the float64 reference must agree on: above the widest gap between the
#: two on any value the benchmark's runs have read (5.5e-5)
SIGN_TOL = 1e-4


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    i = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    """``'float64'`` (the reference) or ``'tf32'`` (the control)."""

    name: str = "float64"

    def __post_init__(self):
        if self.name not in ("float64", "tf32"):
            raise ValueError(f"precision must be float64 or tf32, got {self.name!r}")

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.name == "float64" else torch.float32

    def cast(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            a, b = _tf32_round(a), _tf32_round(b)
        return a @ b


def _norm(x, dim=-1):
    return torch.linalg.vector_norm(x, dim=dim, keepdim=True)


def standardize(data: torch.Tensor) -> torch.Tensor:
    """Columns of ``(..., s, m)`` to mean 0, sd 1 (ddof 1); constant → 0."""
    xc = data - data.mean(-2, keepdim=True)
    sd = torch.sqrt((xc * xc).sum(-2, keepdim=True) / max(data.shape[-2] - 1, 1))
    return torch.where(sd > 0, xc / torch.clamp(sd, min=_EPS), torch.zeros_like(xc))


def pearson(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pearson correlation over the last axis; NaN where degenerate."""
    xc = x - x.mean(-1, keepdim=True)
    yc = y - y.mean(-1, keepdim=True)
    den = torch.sqrt((xc * xc).sum(-1)) * torch.sqrt((yc * yc).sum(-1))
    cov = (xc * yc).sum(-1)
    return torch.where(den > 0, cov / torch.clamp(den, min=_EPS),
                       torch.full_like(cov, float("nan")))


def summary_profile(z: torch.Tensor, prec: Precision, method: str,
                    n_iter: int) -> torch.Tensor:
    """Unit summary profile ``(..., s)`` of a standardized slice."""
    gram = prec.mm(z.transpose(-1, -2), z)
    if method == "eigh":
        v = torch.linalg.eigh(gram)[1][..., :, -1]
    elif method == "power":
        v = torch.full(z.shape[:-2] + z.shape[-1:], 1.0, dtype=z.dtype,
                       device=z.device)
        v = v / _norm(v)
        for _ in range(n_iter):
            v = prec.mm(gram, v[..., None])[..., 0]
            v = v / torch.clamp(_norm(v), min=_EPS)
    else:
        raise ValueError(f"unknown summary method {method!r}")
    prof = prec.mm(z, v[..., None])[..., 0]
    prof = prof / torch.clamp(_norm(prof), min=_EPS)
    sign = torch.sign((prof * z.sum(-1)).sum(-1, keepdim=True))
    return prof * torch.where(sign == 0, torch.ones_like(sign), sign)


def contributions(z: torch.Tensor, prof: torch.Tensor, prec: Precision):
    """Pearson correlation of each column of ``z`` with ``prof``."""
    p = prof - prof.mean(-1, keepdim=True)
    num = prec.mm(z.transpose(-1, -2), p[..., None])[..., 0]
    den = torch.linalg.vector_norm(z, dim=-2) * _norm(p)
    return torch.where(den > 0, num / torch.clamp(den, min=_EPS),
                       torch.zeros_like(num))


def degree(net: torch.Tensor) -> torch.Tensor:
    return net.sum(-1) - torch.diagonal(net, dim1=-2, dim2=-1)


@dataclasses.dataclass
class Discovery:
    """A module's fixed discovery side: off-diagonal correlation entries,
    their signs, degrees, contributions and their signs."""

    corr_off: torch.Tensor
    degree: torch.Tensor
    contrib: torch.Tensor


def discovery(corr, net, data, prec: Precision) -> Discovery:
    corr, net, data = prec.cast(corr), prec.cast(net), prec.cast(data)
    m = corr.shape[-1]
    off = ~torch.eye(m, dtype=torch.bool, device=corr.device)
    z = standardize(data)
    prof = summary_profile(z, prec, "eigh", 0)
    return Discovery(corr[off], degree(net), contributions(z, prof, prec))


def _signed_mean(disc_vals: torch.Tensor, vals: torch.Tensor):
    """``mean(sign(disc_vals) * vals)`` over the last axis, and the
    half-width the terms whose discovery value is within ``SIGN_TOL`` of
    zero may move it by."""
    unsure = disc_vals.abs() < SIGN_TOL
    sign = torch.where(unsure, torch.zeros_like(disc_vals), torch.sign(disc_vals))
    half = torch.where(unsure, vals.abs(), torch.zeros_like(vals)).mean(-1)
    return (sign * vals).mean(-1), half


def module_stats(disc: Discovery, corr, net, data, prec: Precision,
                 method: str, n_iter: int):
    """The seven statistics ``(B, 7)`` of ``B`` test node sets of one
    module, given their ``(B, m, m)`` correlation and network submatrices
    and ``(B, s, m)`` data slices, and each value's half-width ``(B, 7)``."""
    m = corr.shape[-1]
    off = ~torch.eye(m, dtype=torch.bool, device=corr.device)
    t_off = corr[:, off]
    z = standardize(data)
    nc = contributions(z, summary_profile(z, prec, method, n_iter), prec)
    avg_cor, half_cor = _signed_mean(disc.corr_off.expand_as(t_off), t_off)
    avg_contrib, half_contrib = _signed_mean(disc.contrib.expand_as(nc), nc)
    vals = torch.stack([
        (net.sum((-1, -2)) - torch.diagonal(net, dim1=-2, dim2=-1).sum(-1))
        / (m * (m - 1)),
        (nc * nc).mean(-1),
        pearson(disc.corr_off.expand_as(t_off), t_off),
        pearson(disc.degree.expand(net.shape[0], m), degree(net)),
        pearson(disc.contrib.expand_as(nc), nc),
        avg_cor,
        avg_contrib,
    ], dim=-1)
    half = torch.zeros_like(vals)
    half[:, 5], half[:, 6] = half_cor, half_contrib
    return vals, half
