"""Sequential early-stopping for the permutation null (Besag & Clifford
1991, *Sequential Monte Carlo p-values*; Phipson & Smyth 2010 §4).

A copy of ``netrep_tpu/ops/sequential.py`` (host numpy/scipy): a
:class:`StopMonitor` folds each chunk's per-(module, statistic)
exceedance counts into running tallies and retires modules whose decision
at ``alpha`` is settled for every computable statistic; the engine then
re-buckets the remaining modules so later chunks shrink
(:meth:`netrep_tpu_torch.parallel.engine.PermutationEngine.rebucket`).
A retired module's p-value is ``permp(c, n_used)`` at its own
permutation count (:func:`netrep_tpu_torch.ops.pvalues.sequential_pvalues`).
Decisions are taken only at chunk boundaries, so they depend only on
(seed, chunk size) and survive checkpoint/resume exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_ALTERNATIVES = ("greater", "less", "two.sided")


@dataclasses.dataclass(frozen=True)
class StopRule:
    """Stopping-rule knobs for :class:`StopMonitor`.

    Attributes
    ----------
    h : Besag–Clifford exceedance budget: a (module, statistic) cell is
        decided once its exceedance count reaches ``h`` — the sequential
        estimator ``(c+1)/(n+1)`` then has coefficient of variation
        ≲ 1/sqrt(h) and, for any ``n_used >= h/alpha``, can no longer fall
        below ``alpha``. 16 bounds the relative resampling error at ~25%,
        ample for accept/reject at alpha=0.05 (the estimate itself is ≥
        17/(n+1), decided far above alpha whenever the rule can fire).
    alpha : decision threshold the CP rule settles against (the per-test
        significance level the caller will read the p-values at).
    confidence : coverage of the Clopper–Pearson interval used by the
        "decided at alpha" rule. 0.999 keeps the per-cell risk of retiring
        on the wrong side of alpha at 1e-3 — small against the Monte-Carlo
        error a fixed-n run carries anyway.
    min_perms : never retire a module before this many permutations, so
        every module's null gets a floor sample even when the rules fire
        instantly (and so tiny-alpha CP decisions aren't made from a
        handful of draws).
    """

    h: int = 16
    alpha: float = 0.05
    confidence: float = 0.999
    min_perms: int = 128

    def __post_init__(self):
        if self.h < 1:
            raise ValueError(f"h must be >= 1, got {self.h}")
        if not 0 < self.alpha < 1:
            raise ValueError(f"alpha must be in (0, 1), got {self.alpha}")
        if not 0.5 <= self.confidence < 1:
            raise ValueError(
                f"confidence must be in [0.5, 1), got {self.confidence}"
            )
        if self.min_perms < 1:
            raise ValueError(
                f"min_perms must be >= 1, got {self.min_perms}"
            )


def _cp_bounds(c: np.ndarray, n: int, delta: float):
    """Two-sided Clopper–Pearson ``1 - delta`` interval for a binomial
    proportion with ``c`` successes of ``n`` — vectorized in ``c``."""
    from scipy import stats as _sstats

    c = np.asarray(c, dtype=np.float64)
    lo = np.where(c > 0, _sstats.beta.ppf(delta / 2, c, n - c + 1), 0.0)
    hi = np.where(c < n, _sstats.beta.ppf(1 - delta / 2, c + 1, n - c), 1.0)
    return lo, hi


class StopMonitor:
    """Host-side running tallies + retirement decisions for an adaptive
    permutation run.

    Parameters
    ----------
    observed : (n_modules, n_cells) observed statistics. Callers with extra
        axes flatten them into the cell axis (the multi-test engine folds
        its T datasets in as ``(K, T*7)``); NaN cells (data-less variant)
        are never computable and do not block retirement.
    alternative : 'greater' | 'less' | 'two.sided' — must match the tail
        convention the final p-values will use
        (:func:`netrep_tpu_torch.ops.pvalues.exceedance_counts`). Two-sided
        tallies keep BOTH tails (min-of-sums ≠ sum-of-mins across chunks).
    rule : :class:`StopRule`.
    """

    def __init__(self, observed: np.ndarray, alternative: str, rule: StopRule):
        if alternative not in _ALTERNATIVES:
            raise ValueError(
                f"alternative must be one of {_ALTERNATIVES}, "
                f"got {alternative!r}"
            )
        self.observed = np.atleast_2d(np.asarray(observed, dtype=np.float64))
        self.alternative = alternative
        self.rule = rule
        k, s = self.observed.shape
        self.hi = np.zeros((k, s), dtype=np.int64)   # nulls >= observed
        self.lo = np.zeros((k, s), dtype=np.int64)   # nulls <= observed
        #: per-cell valid (non-NaN) draw counts — tracked only by the
        #: streaming (store_nulls=False) adaptive path, which has no null
        #: array to recover them from; None on materialized runs
        self.eff: np.ndarray | None = None
        self.n_used = np.zeros(k, dtype=np.int64)
        self.active = np.ones(k, dtype=bool)
        #: total permutation indices folded so far — always a whole number
        #: of chunks. May lag the loop's `completed` counter by one chunk
        #: when an interrupt lands between the null write and the fold; the
        #: adaptive loop re-folds the gap from the null array on resume so
        #: the two can never diverge across a checkpoint.
        self.folded = 0
        self._nan_cells = np.isnan(self.observed)
        #: warm-start pseudo-counts from a PRIOR run of the same cell
        #: (:meth:`seed_priors`) — consulted ONLY by the decision rules;
        #: reported tallies/p-values stay fresh-draw-only
        self.prior_hi: np.ndarray | None = None
        self.prior_lo: np.ndarray | None = None
        self.prior_n: np.ndarray | None = None

    # -- state ------------------------------------------------------------

    @property
    def n_modules(self) -> int:
        return self.observed.shape[0]

    def active_positions(self) -> np.ndarray:
        """Global module positions still drawing permutations (sorted)."""
        return np.flatnonzero(self.active)

    def any_active(self) -> bool:
        return bool(self.active.any())

    def seed_priors(
        self, hi: np.ndarray, lo: np.ndarray, n_used: np.ndarray
    ) -> None:
        """Seed the DECISION rules with per-cell tallies from a prior run
        of the same cell — the incremental re-analysis warm start: when a
        dataset's content changed only incrementally, the prior run's
        exceedance proportions are an informative sample of the
        same-side-of-alpha question, so pooling them into the
        Besag–Clifford ``h`` rule and the Clopper–Pearson decided-at-alpha
        interval lets stable cells retire after ``min_perms`` fresh draws
        (hundreds of permutations) instead of re-earning the full budget.

        Semantics:

        - priors enter ``_decided`` ONLY — reported tallies (``hi``/
          ``lo``/``eff``), ``n_used``, and the Phipson–Smyth p-values are
          computed from FRESH draws exclusively, so a warm-started
          result's numbers are exact estimators at its realized stopping
          point;
        - the ``min_perms`` floor applies to fresh draws, so every
          warm-started cell still sees a floor sample of the NEW data
          before any decision can fire;
        - priors ride :meth:`state_arrays`/:meth:`restore_state`
          (``seq_prior_*`` keys), so an interrupted warm-started run
          resumes with identical decisions.

        Must be called before any fold (priors folded mid-run would make
        decisions depend on call order)."""
        if self.folded:
            raise ValueError(
                "seed_priors must be called before any chunk is folded"
            )
        hi = np.asarray(hi, dtype=np.int64)
        lo = np.asarray(lo, dtype=np.int64)
        n_used = np.asarray(n_used, dtype=np.int64).ravel()
        if hi.shape != self.hi.shape or lo.shape != self.lo.shape:
            raise ValueError(
                f"prior tallies have shapes {hi.shape}/{lo.shape}, "
                f"expected {self.hi.shape}"
            )
        if n_used.shape != self.n_used.shape:
            raise ValueError(
                f"prior n_used has shape {n_used.shape}, expected "
                f"{self.n_used.shape}"
            )
        if (hi < 0).any() or (lo < 0).any() or (n_used < 0).any():
            raise ValueError("prior tallies must be non-negative")
        self.prior_hi, self.prior_lo, self.prior_n = hi, lo, n_used

    def counts(self) -> np.ndarray:
        """(n_modules, n_cells) tail-resolved exceedance counts — the same
        convention as :func:`~netrep_tpu_torch.ops.pvalues.exceedance_counts`
        (min tail for two-sided; callers double the p there)."""
        if self.alternative == "greater":
            return self.hi
        if self.alternative == "less":
            return self.lo
        return np.minimum(self.hi, self.lo)

    def state_arrays(self) -> dict[str, np.ndarray]:
        """Checkpointable tallies + retired set (restored by
        :meth:`restore_state`); keys are the checkpoint extras namespace."""
        out = {
            "seq_hi": self.hi,
            "seq_lo": self.lo,
            "seq_n_used": self.n_used,
            "seq_active": self.active,
            "seq_folded": np.int64(self.folded),
        }
        if self.eff is not None:
            out["seq_eff"] = self.eff
        if self.prior_n is not None:
            out["seq_prior_hi"] = self.prior_hi
            out["seq_prior_lo"] = self.prior_lo
            out["seq_prior_n"] = self.prior_n
        return out

    def restore_state(self, extras: dict) -> None:
        """Restore tallies + retired set from checkpoint extras; shape
        mismatches mean the checkpoint belongs to a different problem."""
        try:
            hi, lo = extras["seq_hi"], extras["seq_lo"]
            n_used, active = extras["seq_n_used"], extras["seq_active"]
            folded = extras["seq_folded"]
        except KeyError:
            raise ValueError(
                "checkpoint has no sequential-stopping state (it was "
                "written by a non-adaptive run); resume it with "
                "adaptive=False or delete it"
            ) from None
        if hi.shape != self.hi.shape or active.shape != self.active.shape:
            raise ValueError(
                "checkpoint sequential-stopping state has a different "
                "module/statistic shape; refusing to resume"
            )
        self.hi = np.asarray(hi, dtype=np.int64)
        self.lo = np.asarray(lo, dtype=np.int64)
        self.n_used = np.asarray(n_used, dtype=np.int64)
        self.active = np.asarray(active, dtype=bool)
        self.folded = int(folded)
        self.eff = (
            np.asarray(extras["seq_eff"], dtype=np.int64)
            if "seq_eff" in extras else None
        )
        # warm-start priors ride the checkpoint (additive keys): a resumed
        # warm-started run must decide exactly as the uninterrupted run —
        # restored BEFORE the self-heal below, which consults them
        if "seq_prior_n" in extras:
            self.prior_hi = np.asarray(extras["seq_prior_hi"],
                                       dtype=np.int64)
            self.prior_lo = np.asarray(extras["seq_prior_lo"],
                                       dtype=np.int64)
            self.prior_n = np.asarray(extras["seq_prior_n"],
                                      dtype=np.int64)
        # self-heal: decisions are a pure function of the tallies, so
        # retire anything already decided — covers an interrupt that
        # landed between a fold and its retirement flags
        pos = self.active_positions()
        if pos.size:
            self.active[pos[self._decided(pos)]] = False

    # -- updates ----------------------------------------------------------

    def update(self, vals: np.ndarray, take: int) -> np.ndarray:
        """Fold one chunk's null values for the currently-active modules
        into the tallies and retire freshly-decided modules.

        Parameters
        ----------
        vals : (take, n_active, n_cells) null statistics, module axis in
            :meth:`active_positions` order.
        take : permutations in this chunk.

        Returns
        -------
        Global positions of modules retired by this chunk (possibly empty).
        Decisions depend only on the tallies, so they are identical for an
        interrupted+resumed run evaluating the same chunks.
        """
        pos = self.active_positions()
        vals = np.asarray(vals, dtype=np.float64)
        if vals.shape[:2] != (take, pos.size):
            raise ValueError(
                f"chunk values have shape {vals.shape}, expected "
                f"({take}, {pos.size}, n_cells)"
            )
        obs = self.observed[pos]
        # NaN null entries compare False on both tails — they contribute
        # nothing, matching exceedance_counts' NaN handling. Stage the new
        # tallies and commit them in one statement at the end: a
        # KeyboardInterrupt mid-update must not leave one tail folded and
        # the other not (resume re-folds by `folded`, so a torn commit
        # would double-count; restore_state re-derives the retirement
        # flags, which may lag this commit harmlessly).
        with np.errstate(invalid="ignore"):
            hi, lo = self.hi.copy(), self.lo.copy()
            hi[pos] += (vals >= obs[None]).sum(axis=0)
            lo[pos] += (vals <= obs[None]).sum(axis=0)
        n_used = self.n_used.copy()
        n_used[pos] += int(take)
        self.hi, self.lo, self.n_used, self.folded = (
            hi, lo, n_used, self.folded + int(take)
        )
        newly = pos[self._decided(pos)]
        self.active[newly] = False
        return newly

    def update_counts(
        self, hi: np.ndarray, lo: np.ndarray, take: int,
        eff: np.ndarray | None = None,
    ) -> np.ndarray:
        """Fold one chunk's *device-computed* per-(module, statistic)
        exceedance tallies for the currently-active modules — the
        streaming-mode (``store_nulls=False``) twin of :meth:`update`:
        the engine already counted ``null >= observed`` / ``null <=
        observed`` inside the chunk dispatch, so no host-side null slice
        exists to re-tally; transfers shrink from O(chunk·modules·cells)
        raw nulls to O(modules·cells) counts per chunk.

        Parameters
        ----------
        hi, lo : (n_active, n_cells) integer exceedance counts for this
            chunk, module axis in :meth:`active_positions` order. Device
            comparisons are f32-vs-f32 on exactly the values the
            materialized path widens to f64, so the folded tallies are
            identical to :meth:`update` on the same chunk — decisions
            cannot diverge between the two modes.
        take : permutations in this chunk.
        eff : optional (n_active, n_cells) valid (non-NaN) draw counts;
            when given they accumulate in :attr:`eff` — the streaming
            path's replacement for reading per-cell validity off the null
            array at p-value time. Folded in the same single-statement
            commit as the tallies, so a Ctrl-C can never tear the two
            apart (the checkpoint stays resume-exact).

        Returns
        -------
        Global positions of modules retired by this chunk, as
        :meth:`update`.
        """
        pos = self.active_positions()
        hi = np.asarray(hi, dtype=np.int64)
        lo = np.asarray(lo, dtype=np.int64)
        want = (pos.size, self.observed.shape[1])
        if hi.shape != want or lo.shape != want:
            raise ValueError(
                f"chunk counts have shapes {hi.shape}/{lo.shape}, expected "
                f"{want}"
            )
        # same torn-commit discipline as update(): stage, then commit in
        # one statement
        new_hi, new_lo = self.hi.copy(), self.lo.copy()
        new_hi[pos] += hi
        new_lo[pos] += lo
        n_used = self.n_used.copy()
        n_used[pos] += int(take)
        new_eff = self.eff
        if eff is not None:
            new_eff = (
                self.eff if self.eff is not None else np.zeros_like(self.hi)
            ).copy()
            new_eff[pos] += np.asarray(eff, dtype=np.int64)
        self.hi, self.lo, self.n_used, self.eff, self.folded = (
            new_hi, new_lo, n_used, new_eff, self.folded + int(take)
        )
        newly = pos[self._decided(pos)]
        self.active[newly] = False
        return newly

    def force_retire(self, positions=None) -> np.ndarray:
        """Administratively retire modules (LOCAL positions; default: every
        still-active module) regardless of their statistical state — the
        serving layer's per-request retirement view: a packed
        request whose permutation budget (or latency SLO) is spent leaves
        the shared dispatch through the same retirement path a
        Besag–Clifford decision takes, so the engine's re-bucketing needs
        no second exit mechanism. Tallies and ``n_used`` are left as
        folded — the sequential Phipson–Smyth p-values at the retirement
        point stay exact. Returns the positions actually retired (already-
        retired ones are skipped)."""
        pos = (
            self.active_positions() if positions is None
            else np.asarray(positions, dtype=np.int64).ravel()
        )
        pos = pos[self.active[pos]]
        self.active[pos] = False
        return pos

    def _decided(self, pos: np.ndarray) -> np.ndarray:
        """Per-module decision mask for the modules at ``pos``: every
        computable cell is settled by the Besag–Clifford ``h`` rule or the
        CP decided-at-alpha rule, and the floor sample is met."""
        rule = self.rule
        out = np.zeros(pos.size, dtype=bool)
        for j, p in enumerate(pos):
            n = int(self.n_used[p])
            # the min_perms floor is on FRESH draws: a warm-started cell
            # still samples the new data before any decision can fire
            if n < rule.min_perms:
                continue
            # warm-start priors (seed_priors) pool into the DECISION
            # counts only — fresh tallies/p-values are reported unchanged
            if self.prior_n is not None:
                hi_c = self.hi[p] + self.prior_hi[p]
                lo_c = self.lo[p] + self.prior_lo[p]
                n = n + int(self.prior_n[p])
            else:
                hi_c, lo_c = self.hi[p], self.lo[p]
            if self.alternative == "greater":
                c, thresh = hi_c, rule.alpha
            elif self.alternative == "less":
                c, thresh = lo_c, rule.alpha
            else:
                # two-sided p is min-tail doubled: the decision boundary on
                # the min-tail proportion is alpha/2
                c, thresh = np.minimum(hi_c, lo_c), rule.alpha / 2
            by_h = c >= rule.h
            cp_lo, cp_hi = _cp_bounds(c, n, 1.0 - rule.confidence)
            by_cp = (cp_lo > thresh) | (cp_hi < thresh)
            out[j] = bool(np.all(by_h | by_cp | self._nan_cells[p]))
        return out

    def total_evaluated(self) -> int:
        """Σ per-module permutations drawn — the adaptive work metric the
        bench row reports against ``n_modules * n_perm``."""
        return int(self.n_used.sum())
