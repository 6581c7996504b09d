"""Exact permutation p-values and permutation-count planning.

A copy of the parts of ``netrep_tpu/ops/pvalues.py`` the dense main path
uses: the Phipson & Smyth (2010) estimator (``statmod::permp``) over
exceedance counts, for a materialized null (:func:`permutation_pvalues`) or
for streamed tallies (:func:`counts_pvalues`) — one shared estimator, so the
two result modes give identical p-values for identical counts — plus the
permutation-space size and :func:`required_perms`. Host-side numpy/scipy;
the counts themselves come from the device.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import integrate as _integrate
from scipy import stats as _sstats

#: Above this many total possible permutations, permp switches from the exact
#: finite sum to the integral approximation (mirrors statmod's auto rule).
_EXACT_LIMIT = 10_000


def permp(
    x: np.ndarray,
    nperm: int,
    total_nperm: float | None = None,
    method: str = "auto",
) -> np.ndarray:
    """Phipson–Smyth exact permutation p-value.

    Parameters
    ----------
    x : array of exceedance counts — the number of null statistics at least
        as extreme as the observed statistic.
    nperm : number of random permutations actually drawn.
    total_nperm : size of the full permutation space (may be ``None``/inf for
        effectively infinite spaces).
    method : ``'exact'`` — average the binomial CDF over the attainable true
        p-values ``v/total_nperm``; ``'approximate'`` — the integral-corrected
        ``(x+1)/(nperm+1)``; ``'auto'`` — exact when the space is small.

    Notes
    -----
    With ``B ~ Binomial(nperm, p_true)`` and ``p_true`` uniform on
    ``{1/mt, ..., mt/mt}``, the exact estimator is
    ``mean_v P(B <= x | p_true = v/mt)``. Its large-``mt`` limit is
    ``(x+1)/(nperm+1)`` because ``∫_0^1 F(x; n, u) du = (x+1)/(n+1)``; the
    approximate method subtracts the midpoint-rule boundary correction
    ``∫_0^{1/(2 mt)} F(x; n, u) du``.

    Fidelity vs ``statmod::permp`` (re-verification debt, SURVEY.md §7
    "Exact p-values"; the reference mount is empty and no R is installed, so
    statmod itself cannot be executed here):

    - The *exact* method is the estimator as published (Phipson & Smyth
      2010, eq. 2) — ``tests/test_pvalues.py`` pins it against an
      independent exact-rational-arithmetic oracle, so any disagreement
      with statmod could only come from statmod deviating from its own
      paper.
    - The *approximate* method evaluates the same boundary-correction
      integral statmod computes (statmod uses 128-point Gauss–Legendre;
      here adaptive quadrature — agreement to quadrature tolerance,
      ~1e-10, far below the estimator's own Monte-Carlo error).
    - The ``'auto'`` rule (exact iff ``total_nperm <= 10_000``) mirrors
      statmod's documented switch; flagged for re-verification against the
      source if a reference mount ever appears.
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    x = np.clip(x, 0, nperm)
    biased = (x + 1.0) / (nperm + 1.0)

    if total_nperm is None or not np.isfinite(total_nperm):
        return biased

    mt = float(total_nperm)
    if method == "auto":
        method = "exact" if mt <= _EXACT_LIMIT else "approximate"

    if method == "exact":
        probs = np.arange(1, int(mt) + 1, dtype=np.float64) / mt
        return _sstats.binom.cdf(x[:, None], nperm, probs[None, :]).mean(axis=1)
    if method == "approximate":
        out = np.empty_like(biased)
        for i, xi in enumerate(x):
            corr, _err = _integrate.quad(
                lambda u: _sstats.binom.cdf(xi, nperm, u), 0.0, 0.5 / mt
            )
            out[i] = biased[i] - corr
        return np.clip(out, 1.0 / mt if mt > 0 else 0.0, 1.0)
    raise ValueError(f"unknown permp method: {method!r}")


def exceedance_counts(
    observed: np.ndarray,
    nulls: np.ndarray,
    alternative: str = "greater",
) -> tuple[np.ndarray, np.ndarray]:
    """Count null draws at least as extreme as the observed value.

    Parameters
    ----------
    observed : (...,) observed statistics.
    nulls : (nperm, ...) null draws (NaN entries are ignored and excluded
        from the effective permutation count).
    alternative : 'greater' | 'less' | 'two.sided'.

    Returns
    -------
    (counts, effective_nperm) — for ``two.sided`` the counts are returned for
    both tails as the *minimum* tail count; callers double the resulting
    p-value (capped at 1), matching the standard two-sided permutation rule.

    Convention note (documented deviation candidate, SURVEY.md §7): the
    reference's R layer was not observable (empty mount), so its two-sided
    rule could not be read. ``min-tail × 2, capped at 1`` is the standard
    permutation convention and is what this layer implements; statmod's own
    ``twosided=`` flag instead expects callers to count exceedances of
    ``|statistic|``, which is only equivalent for symmetric nulls. If the
    reference is ever re-verified to use the |statistic| convention, change
    ONLY this function.
    """
    valid = ~np.isnan(nulls)
    eff = valid.sum(axis=0)
    if alternative == "greater":
        cnt = np.nansum(nulls >= observed[None], axis=0)
    elif alternative == "less":
        cnt = np.nansum(nulls <= observed[None], axis=0)
    elif alternative == "two.sided":
        hi = np.nansum(nulls >= observed[None], axis=0)
        lo = np.nansum(nulls <= observed[None], axis=0)
        cnt = np.minimum(hi, lo)
    else:
        raise ValueError(f"unknown alternative: {alternative!r}")
    return cnt, eff


def _grouped_permp(counts, eff, total_nperm) -> np.ndarray:
    """Vectorized :func:`permp` over a (counts, effective-nperm) cell grid:
    cells are grouped by effective permutation count (usually one group —
    NaN-free nulls) instead of calling per cell. Zero-draw cells stay NaN.
    Shared by the null-array and streamed-counts p-value paths so the
    estimator cannot drift between them."""
    flat_c = np.asarray(counts, dtype=np.float64).reshape(-1)
    flat_n = np.asarray(eff, dtype=np.int64).reshape(-1)
    p = np.full(flat_c.shape, np.nan)
    for n in np.unique(flat_n):
        sel = flat_n == n
        if n > 0:
            p[sel] = permp(flat_c[sel], int(n), total_nperm)
    return p.reshape(np.asarray(counts).shape)


def permutation_pvalues(
    observed: np.ndarray,
    nulls: np.ndarray,
    alternative: str = "greater",
    total_nperm: float | None = None,
) -> np.ndarray:
    """Per-statistic permutation p-values from observed values and the null
    array — the reference's post-null R-side aggregation (SURVEY.md §3.1).

    NaN observed statistics (e.g. data-less variant) yield NaN p-values.
    """
    observed = np.asarray(observed, dtype=np.float64)
    counts, eff = exceedance_counts(observed, nulls, alternative)
    p = _grouped_permp(counts, eff, total_nperm)
    if alternative == "two.sided":
        p = np.minimum(2.0 * p, 1.0)
    p[np.isnan(observed)] = np.nan
    return p


def tail_counts(
    observed: np.ndarray, nulls: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Both-tail exceedance tallies + per-cell valid draw counts of a
    materialized null array — the lift from null space into the streaming
    executor's count space (``(hi, lo, eff)``, each shaped like one null
    row). Pins streaming/materialized parity in tests: a streamed run's
    device tallies must equal this function applied to the same key's
    materialized null."""
    observed = np.asarray(observed, dtype=np.float64)
    nulls = np.asarray(nulls)
    with np.errstate(invalid="ignore"):
        hi = (nulls >= observed[None]).sum(axis=0)
        lo = (nulls <= observed[None]).sum(axis=0)
    eff = (~np.isnan(nulls)).sum(axis=0)
    return (hi.astype(np.int64), lo.astype(np.int64), eff.astype(np.int64))


def counts_pvalues(
    observed: np.ndarray,
    hi: np.ndarray,
    lo: np.ndarray,
    eff: np.ndarray,
    alternative: str = "greater",
    total_nperm: float | None = None,
) -> np.ndarray:
    """Exact Phipson–Smyth p-values straight from streamed exceedance
    tallies (``store_nulls=False``): ``hi``/``lo`` are the per-(module,
    statistic) counts of null draws at least / at most as extreme as the
    observed value and ``eff`` the per-cell valid (non-NaN) draw counts —
    exactly what :func:`tail_counts` computes from a materialized null, so
    the two result modes produce identical p-values for identical counts
    (the estimator itself is the shared :func:`_grouped_permp`). The tail
    convention matches :func:`exceedance_counts` (two-sided: min tail,
    doubled, capped at 1); NaN observed statistics yield NaN p-values."""
    observed = np.asarray(observed, dtype=np.float64)
    hi = np.asarray(hi)
    lo = np.asarray(lo)
    if alternative == "greater":
        cnt = hi
    elif alternative == "less":
        cnt = lo
    elif alternative == "two.sided":
        cnt = np.minimum(hi, lo)
    else:
        raise ValueError(f"unknown alternative: {alternative!r}")
    p = _grouped_permp(cnt, eff, total_nperm)
    if alternative == "two.sided":
        p = np.minimum(2.0 * p, 1.0)
    p[np.isnan(observed)] = np.nan
    return p


def log_total_permutations(pool_size: int, module_sizes) -> float:
    """Natural log of the number of *ordered* disjoint node-set assignments —
    the size of the permutation space sampled by the engine: the falling
    factorial ``pool! / (pool - Σm)!`` (node order within a module matters
    because statistics pair nodes positionally with discovery properties)."""
    take = int(np.sum(module_sizes))
    if take > pool_size:
        return float("inf")
    return float(
        math.lgamma(pool_size + 1) - math.lgamma(pool_size - take + 1)
    )


def total_permutations(pool_size: int, module_sizes) -> float:
    """Size of the permutation space (inf if it overflows float range)."""
    lg = log_total_permutations(pool_size, module_sizes)
    return math.exp(lg) if lg < 700 else float("inf")


def required_perms(alpha: float = 0.05, n_tests: int = 1, alternative: str = "greater") -> int:
    """Smallest number of permutations whose minimum achievable p-value
    (``1/(nperm+1)``, or ``2/(nperm+1)`` two-sided) clears ``alpha`` after
    Bonferroni adjustment across ``n_tests`` module×statistic tests
    (SURVEY.md §3.4)."""
    if not 0 < alpha < 1:
        raise ValueError("alpha must be in (0, 1)")
    thresh = alpha / max(n_tests, 1)
    tails = 2.0 if alternative == "two.sided" else 1.0
    return int(math.ceil(tails / thresh)) - 1
