"""Exact permutation p-values and permutation-count planning.

A copy of the parts of ``netrep_tpu/ops/pvalues.py`` the dense main path
uses: the Phipson & Smyth (2010) estimator (``statmod::permp``) over
exceedance counts, for a materialized null (:func:`permutation_pvalues`) or
for streamed tallies (:func:`counts_pvalues`) — one shared estimator, so the
two result modes give identical p-values for identical counts — the lift of
a null into count space (:func:`tail_counts`, which ``combine_analyses``
pools with), :func:`effective_nperm` and :func:`sequential_pvalues`, the
generalized-Pareto tail p-values (:func:`gpd_tail_pvalues`, Knijnenburg et
al. 2009), plus the permutation-space size and :func:`required_perms`.
Host-side numpy/scipy; the counts themselves come from the device.
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


def effective_nperm(nulls: np.ndarray) -> np.ndarray:
    """Per-module permutation counts actually present in a null array —
    rows where *any* statistic is finite count (an adaptive run NaNs the
    whole (module, :) row past retirement; a data-less run NaNs only the
    data statistics, which must still count as drawn permutations).

    ``nulls`` is ``(nperm, n_modules, n_stats)``; returns ``(n_modules,)``.
    """
    return np.asarray(
        (~np.isnan(nulls)).any(axis=-1).sum(axis=0), dtype=np.int64
    )


def sequential_pvalues(
    observed: np.ndarray,
    nulls: np.ndarray,
    alternative: str = "greater",
    total_nperm: float | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Sequential (early-stopped) permutation p-values: a null whose
    modules stopped at different permutation counts leaves each retired
    module's rows NaN past its stop. :func:`permutation_pvalues` already
    groups cells by their count of valid draws, so the estimator is
    Phipson–Smyth at each module's own count; this adds the per-module
    counts. Returns ``(p_values, n_perm_used)``, the latter
    ``(n_modules,)``."""
    nulls = np.asarray(nulls)
    return (
        permutation_pvalues(observed, nulls, alternative, total_nperm),
        effective_nperm(nulls),
    )


# --- Generalized-Pareto tail sharpening (Knijnenburg et al. 2009) ----------

#: Number of top-order statistics the GPD tail fit starts from — the
#: standard 250-exceedance rule of Knijnenburg et al. 2009 ("Fewer
#: permutations, more accurate P-values", §Methods).
_GPD_START_EXCEED = 250
#: Step the exceedance count is reduced by each time the A–D gate rejects.
_GPD_STEP = 10
#: Floor below which the fit is abandoned as untrustworthy.
_GPD_MIN_EXCEED = 30
#: With at least this many null draws beyond the observed value the exact
#: Phipson–Smyth estimator already resolves the cell; the tail fit is
#: reserved for the far tail it cannot reach (Knijnenburg's x < 10 rule).
_GPD_ECDF_COUNT = 10

# Choulakian & Stephens (2001, "Goodness-of-fit tests for the generalized
# Pareto distribution") case-3 upper-tail critical points of the
# Anderson–Darling A² at α = 0.05, both parameters estimated, indexed by
# the GPD shape ξ (= -k in their parametrization). Linearly interpolated
# in ξ and clamped at the table ends. The gate is a coarse accept/refuse
# screen for extrapolation safety, not a calibrated hypothesis test.
_AD_XI = np.array([-0.9, -0.5, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5])
_AD_CRIT = np.array(
    [0.771, 0.830, 0.903, 0.935, 0.974, 1.020, 1.074, 1.140, 1.221, 1.321]
)


def _gpd_ad_stat(exc: np.ndarray, xi: float, scale: float) -> float:
    """Anderson–Darling A² of exceedances against a fitted GPD(ξ, σ)."""
    z = _sstats.genpareto.cdf(np.sort(exc), xi, loc=0.0, scale=scale)
    z = np.clip(z, 1e-12, 1.0 - 1e-12)
    n = z.size
    i = np.arange(1, n + 1, dtype=np.float64)
    return float(
        -n - np.mean((2.0 * i - 1.0) * (np.log(z) + np.log1p(-z[::-1])))
    )


def _gpd_cell(y: np.ndarray, obs: float) -> tuple[float, bool]:
    """GPD tail p-value for one cell: ``y`` ascending-sorted valid null
    draws, ``obs`` the observed statistic (upper tail). Returns
    ``(p_tail, tail_ok)`` — NaN/False whenever the exact estimator is
    already adequate, the observed value is not in the fitted tail, or the
    Anderson–Darling gate refuses every candidate fit."""
    n = y.size
    if n < 2 * _GPD_MIN_EXCEED or not np.isfinite(obs):
        return np.nan, False
    if int((y >= obs).sum()) >= _GPD_ECDF_COUNT:
        return np.nan, False
    n_exc = min(_GPD_START_EXCEED, n // 4)
    while n_exc >= _GPD_MIN_EXCEED:
        t = 0.5 * (y[n - n_exc - 1] + y[n - n_exc])
        exc = y[n - n_exc:] - t
        if obs > t and exc[-1] > 0.0:
            try:
                xi, _loc, scale = _sstats.genpareto.fit(exc, floc=0.0)
            # netrep: allow(exception-taxonomy) — MLE on a pathological tail may fail inside scipy; a failed fit only rejects this threshold candidate (the search steps down, p_tail stays NaN), never a wrong p-value
            except Exception:
                xi, scale = np.nan, 0.0
            if np.isfinite(xi) and np.isfinite(scale) and scale > 0.0:
                a2 = _gpd_ad_stat(exc, xi, scale)
                if np.isfinite(a2) and a2 <= float(
                    np.interp(xi, _AD_XI, _AD_CRIT)
                ):
                    sf = float(
                        _sstats.genpareto.sf(obs - t, xi, loc=0.0, scale=scale)
                    )
                    return (n_exc / n) * sf, True
        n_exc -= _GPD_STEP
    return np.nan, False


def gpd_tail_pvalues(
    observed: np.ndarray,
    nulls: np.ndarray,
    alternative: str = "greater",
    nulls_exact: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Generalized-Pareto tail p-values (Knijnenburg et al. 2009) beside the
    exact permutation estimator.

    For cells whose observed statistic lands beyond (nearly) every null draw
    the exact Phipson–Smyth p saturates at ~1/(nperm+1); fitting a GPD to
    the null tail (threshold at the 250th largest draw, reduced by 10 while
    an Anderson–Darling goodness-of-fit gate rejects) extrapolates far
    smaller p-values from the same draws:
    ``p_tail = (n_exc / n) * SF_GPD(obs - t)``.

    Parameters
    ----------
    observed : (...,) observed statistics.
    nulls : (nperm, ...) null draws (NaN entries ignored, as in
        :func:`exceedance_counts`).
    alternative : 'greater' | 'less' | 'two.sided' (min tail doubled,
        capped at 1 — the convention of :func:`permutation_pvalues`).
    nulls_exact : pass False when the null VALUES came through the bf16
        screened fast-pass (decided permutations keep their
        bf16-rounded statistics). The call then refuses: the GPD fit
        reads the extreme draws themselves, and bf16 quantization
        (8-bit significand) collapses the tail onto a handful of
        plateaus — the threshold excess distribution degenerates and the
        Anderson–Darling gate no longer measures what it gates. Exact
        counts-based p-values are unaffected; rerun with
        ``null_precision='f32'`` for a tail-fittable null array.

    Returns
    -------
    ``(p_tail, tail_ok)`` shaped like ``observed``. ``tail_ok`` is True
    only where a gated fit produced the value; everywhere else ``p_tail``
    is NaN — callers must fall back to the exact estimator there. The fit
    is only attempted where fewer than 10 null draws reach the observed
    value (the exact estimator already resolves denser cells).
    """
    if not nulls_exact:
        raise ValueError(
            "gpd_tail_pvalues refuses bf16-screened null values "
            "(nulls_exact=False): the screened fast-pass stores decided "
            "permutations' bf16-rounded statistics, whose quantized tail "
            "plateaus break the GPD threshold-excess fit. The exact "
            "p_values (exceedance counts) are unaffected — use them, or "
            "rerun with EngineConfig(null_precision='f32') to materialize "
            "a tail-fittable f32 null array"
        )
    observed = np.asarray(observed, dtype=np.float64)
    nulls = np.asarray(nulls, dtype=np.float64)
    if alternative not in ("greater", "less", "two.sided"):
        raise ValueError(f"unknown alternative: {alternative!r}")
    flat_obs = observed.reshape(-1)
    flat_null = nulls.reshape(nulls.shape[0], -1)
    p = np.full(flat_obs.shape, np.nan)
    ok = np.zeros(flat_obs.shape, dtype=bool)
    for j in range(flat_obs.size):
        o = flat_obs[j]
        if not np.isfinite(o):
            continue
        col = flat_null[:, j]
        col = np.sort(col[~np.isnan(col)])
        if col.size == 0:
            continue
        if alternative == "greater":
            p[j], ok[j] = _gpd_cell(col, o)
        elif alternative == "less":
            p[j], ok[j] = _gpd_cell(np.sort(-col), -o)
        else:  # two.sided: fit the minority tail, double, cap at 1
            if int((col >= o).sum()) <= int((col <= o).sum()):
                pj, okj = _gpd_cell(col, o)
            else:
                pj, okj = _gpd_cell(np.sort(-col), -o)
            p[j], ok[j] = (min(2.0 * pj, 1.0) if okj else np.nan), okj
    return p.reshape(observed.shape), ok.reshape(observed.shape)


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
