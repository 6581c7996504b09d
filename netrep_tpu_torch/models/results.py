"""Result objects of the port's ``module_preservation``.

A copy of ``netrep_tpu/models/results.py`` without the generalized-Pareto
tail: :class:`PreservationResult` (with ``save``/``load`` in the same
``.npz`` format, version 1, so either package reads the other's files,
fixed-n and sequential, and the accessors ``stat_names``, ``max_pvalue``,
``preserved_modules``, ``to_frame`` and ``module_n_perm``),
:func:`combine_analyses`, :func:`results_table` and
:func:`shape_results`, with the same error texts. The tail fit comes with
the screened null (ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import warnings
from collections import Counter

import numpy as np

try:
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None

from ..ops import pvalues as pv
from ..ops.oracle import STAT_NAMES
from ..utils.checkpoint import atomic_savez

#: result fields of the JAX package's files that this port cannot carry
#: yet, with the ROADMAP.md Queue 1 item that brings them
_TAIL = "item 13 (screened null and GPD tail)"


def _refuse_unported(path: str, meta: dict, files) -> None:
    """Raise a ``ValueError`` naming the field and its item when a file
    holds what this port's results cannot represent: inexact (screened)
    null values or GPD tail p-values. Loading such a file would drop them
    without a word."""
    if not meta.get("nulls_exact", True):
        raise ValueError(
            f"{path}: nulls_exact=False (a screened null) is not ported yet: "
            f"ROADMAP.md Queue 1 {_TAIL}"
        )
    for name in ("p_tail", "tail_ok"):
        if name in files:
            raise ValueError(
                f"{path}: the {name} array is not ported yet: ROADMAP.md "
                f"Queue 1 {_TAIL}"
            )


@dataclasses.dataclass
class PreservationResult:
    """Result for one (discovery, test) dataset pair.

    ``p_values`` are Phipson–Smyth exact permutation p-values (never zero);
    ``alternative='two.sided'`` uses min-tail × 2 capped at 1. A streaming
    run (``store_nulls=False``) carries the exceedance tallies
    ``counts_hi``/``counts_lo``/``counts_eff`` and ``nulls=None``. An
    adaptive run has ``p_type='sequential'`` and each module's
    permutation count in ``n_perm_used`` (its null rows are NaN past it);
    a fixed run ``p_type='fixed'`` and ``n_perm_used=None``.
    ``profile`` holds the run's per-phase seconds (not persisted).
    """

    discovery: str
    test: str
    module_labels: list[str]
    observed: np.ndarray          # (n_modules, 7)
    nulls: np.ndarray | None      # (n_perm, n_modules, 7); None if streamed
    p_values: np.ndarray          # (n_modules, 7)
    n_vars_present: np.ndarray    # (n_modules,)
    prop_vars_present: np.ndarray
    total_size: np.ndarray
    alternative: str
    n_perm: int                   # permutations requested
    completed: int                # permutations actually completed
    profile: dict | None = None
    total_space: float | None = None
    counts_hi: np.ndarray | None = None
    counts_lo: np.ndarray | None = None
    counts_eff: np.ndarray | None = None
    n_perm_used: np.ndarray | None = None  # (n_modules,) adaptive runs
    p_type: str = "fixed"         # 'fixed' or 'sequential'

    @property
    def stat_names(self) -> tuple[str, ...]:
        return STAT_NAMES

    def observed_frame(self):
        return pd.DataFrame(self.observed, index=self.module_labels,
                            columns=STAT_NAMES)

    def p_frame(self):
        return pd.DataFrame(self.p_values, index=self.module_labels,
                            columns=STAT_NAMES)

    def __repr__(self) -> str:
        lines = [
            f"Module preservation: discovery={self.discovery!r} "
            f"test={self.test!r} ({self.completed}/{self.n_perm} permutations,"
            f" alternative={self.alternative!r})"
        ]
        if pd is not None:
            lines.append("p-values:")
            lines.append(
                self.p_frame().to_string(float_format=lambda v: f"{v:.4g}")
            )
        return "\n".join(lines)

    def max_pvalue(self) -> np.ndarray:
        """Per-module worst-case p-value across the seven statistics — the
        conventional module-level preservation call (a module is preserved
        when *all* statistics are significant)."""
        with warnings.catch_warnings():
            # an all-NaN row (data-less run: no computable statistics) is a
            # legitimate input; nanmax's RuntimeWarning for it is noise here
            warnings.simplefilter("ignore", category=RuntimeWarning)
            return np.nanmax(self.p_values, axis=1)

    def preserved_modules(
        self, alpha: float = 0.05, adjust: str = "bonferroni"
    ) -> list[str]:
        """Module labels meeting the conventional preservation call: every
        computed statistic significant at ``alpha``, Bonferroni-adjusted for
        the number of modules tested (``adjust='none'`` skips adjustment).
        Modules with no computable statistics (all-NaN row) never qualify."""
        if adjust == "bonferroni":
            thresh = alpha / max(len(self.module_labels), 1)
        elif adjust == "none":
            thresh = alpha
        else:
            raise ValueError(
                f"adjust must be 'bonferroni' or 'none', got {adjust!r}"
            )
        mx = self.max_pvalue()
        return [
            lab
            for lab, p in zip(self.module_labels, mx)
            if np.isfinite(p) and p < thresh
        ]

    def to_frame(self):
        """Long-format (tidy) table of this pair's results: one row per
        module × statistic with observed value, p-value, and the overlap
        bookkeeping."""
        if pd is None:  # pragma: no cover - pandas is an extra
            raise ImportError("to_frame requires pandas")
        k, t = len(self.module_labels), len(STAT_NAMES)
        return pd.DataFrame({
            "discovery": self.discovery,
            "test": self.test,
            "module": np.repeat(self.module_labels, t),
            "statistic": list(STAT_NAMES) * k,
            "observed": self.observed.reshape(-1),
            "p_value": self.p_values.reshape(-1),
            "n_vars_present": np.repeat(self.n_vars_present, t),
            "prop_vars_present": np.repeat(self.prop_vars_present, t),
            "total_size": np.repeat(self.total_size, t),
            "n_perm_used": np.repeat(self.module_n_perm(), t),
        })

    def module_n_perm(self) -> np.ndarray:
        """(n_modules,) permutations backing each module's p-values:
        ``n_perm_used`` for adaptive runs, ``completed`` for every module of
        a fixed run."""
        if self.n_perm_used is not None:
            return np.asarray(self.n_perm_used, dtype=np.int64)
        return np.full(len(self.module_labels), int(self.completed),
                       dtype=np.int64)

    _SAVE_VERSION = 1

    def save(self, path: str) -> None:
        """Persist the result as a single ``.npz`` (atomic write)."""
        meta = {
            "discovery": self.discovery,
            "test": self.test,
            "module_labels": list(self.module_labels),
            "alternative": self.alternative,
            "n_perm": int(self.n_perm),
            "completed": int(self.completed),
            # inf as the string "inf": strict JSON has no Infinity token
            "total_space": (
                None if self.total_space is None
                else "inf" if np.isinf(self.total_space)
                else float(self.total_space)
            ),
            "p_type": self.p_type,
            "store_nulls": self.nulls is not None,
            "nulls_exact": True,
        }
        extra = {
            name: np.asarray(getattr(self, name))
            for name in ("n_perm_used", "counts_hi", "counts_lo",
                         "counts_eff")
            if getattr(self, name) is not None
        }
        atomic_savez(
            path,
            **extra,
            result_version=np.int64(self._SAVE_VERSION),
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            observed=self.observed,
            nulls=(
                self.nulls if self.nulls is not None
                else np.zeros((0,) + self.observed.shape)
            ),
            p_values=self.p_values,
            n_vars_present=self.n_vars_present,
            prop_vars_present=self.prop_vars_present,
            total_size=self.total_size,
        )

    @classmethod
    def load(cls, path: str) -> "PreservationResult":
        """Load a result saved by :meth:`save`, or one the JAX package
        saved (fixed-n or sequential). A screened or GPD-tail file raises
        ``ValueError`` naming the field and the item that will carry it."""
        with np.load(path) as z:
            if "result_version" not in z.files:
                raise ValueError(
                    f"{path} is not a PreservationResult file (no "
                    "result_version marker)"
                )
            version = int(z["result_version"])
            if version != cls._SAVE_VERSION:
                raise ValueError(
                    f"unsupported result-file version {version!r} in {path} "
                    f"(this build reads version {cls._SAVE_VERSION})"
                )
            meta = json.loads(bytes(z["meta"]).decode())
            _refuse_unported(path, meta, z.files)
            ts = meta.get("total_space")
            return cls(
                discovery=meta["discovery"],
                test=meta["test"],
                module_labels=[str(lab) for lab in meta["module_labels"]],
                observed=z["observed"],
                nulls=z["nulls"] if meta.get("store_nulls", True) else None,
                counts_hi=z["counts_hi"] if "counts_hi" in z.files else None,
                counts_lo=z["counts_lo"] if "counts_lo" in z.files else None,
                counts_eff=(
                    z["counts_eff"] if "counts_eff" in z.files else None
                ),
                p_values=z["p_values"],
                n_vars_present=z["n_vars_present"],
                prop_vars_present=z["prop_vars_present"],
                total_size=z["total_size"],
                alternative=meta["alternative"],
                n_perm=meta["n_perm"],
                completed=meta["completed"],
                total_space=None if ts is None else float(ts),
                n_perm_used=(
                    z["n_perm_used"] if "n_perm_used" in z.files else None
                ),
                p_type=meta.get("p_type", "fixed"),
            )


def combine_analyses(*analyses, allow_duplicate_nulls: bool = False):
    """Merge ``module_preservation`` results whose permutations were
    computed separately (NetRep's ``combineAnalyses``): split a large
    ``n_perm`` across sessions or cards with different seeds, then pool
    the nulls and recompute the exact Phipson–Smyth p-values over the
    combined permutation count.

    Takes two or more :class:`PreservationResult` objects for the same
    (discovery, test) pair, or two or more nested ``{discovery: {test:
    result}}`` dicts (as ``simplify=False`` returns), merged key by key.
    Each input contributes its *completed* permutations only. The runs
    must agree on everything except the nulls — module labels,
    alternative, dataset names, observed statistics, node counts — or the
    call raises ``ValueError``.

    Identical null rows across inputs (the same seed run twice) would
    double-count correlated permutations; a content hash detects them and
    the call raises unless ``allow_duplicate_nulls``.

    Streaming results (``store_nulls=False``) combine too: when any input
    lacks a null array, every input is lifted into count space
    (:func:`~netrep_tpu_torch.ops.pvalues.tail_counts`), the tallies are
    summed and the p-values recomputed from them — the numbers pooling the
    null arrays would give. The combined result carries counts but no
    nulls, and the duplicate check cannot run on it.

    The inputs are this port's results. A fixed-n result the JAX package
    saved is one after :meth:`PreservationResult.load` and combines like
    any other; the JAX package's result objects themselves raise
    ``TypeError``.
    """
    if len(analyses) < 2:
        raise ValueError("combine_analyses needs at least two results")
    if all(isinstance(a, dict) for a in analyses):
        keysets = [set(a) for a in analyses]
        if any(ks != keysets[0] for ks in keysets[1:]):
            level = "discovery" if isinstance(
                next(iter(analyses[0].values()), None), dict
            ) else "test"
            raise ValueError(
                f"nested results disagree on {level} datasets: "
                f"{sorted(map(sorted, keysets))}"
            )
        return {
            d: combine_analyses(
                *(a[d] for a in analyses),
                allow_duplicate_nulls=allow_duplicate_nulls,
            )
            for d in analyses[0]
        }
    if all(isinstance(a, PreservationResult) for a in analyses):
        return _combine_pair_results(analyses, allow_duplicate_nulls)
    if any(type(a).__name__ == "PreservationResult"
           and not isinstance(a, PreservationResult) for a in analyses):
        raise TypeError(
            "combine_analyses takes this port's PreservationResult objects; "
            "save a JAX package result and read it back with "
            "netrep_tpu_torch.models.results.PreservationResult.load"
        )
    raise TypeError(
        "combine_analyses takes all PreservationResult objects or all "
        f"nested dicts, got {[type(a).__name__ for a in analyses]}"
    )


def _combine_pair_results(results, allow_duplicate_nulls):
    first = results[0]
    for r in results[1:]:
        if (r.discovery, r.test) != (first.discovery, first.test):
            raise ValueError(
                f"results are for different dataset pairs: "
                f"({first.discovery!r}, {first.test!r}) vs "
                f"({r.discovery!r}, {r.test!r})"
            )
        if list(r.module_labels) != list(first.module_labels):
            raise ValueError("results have different module labels")
        if r.alternative != first.alternative:
            raise ValueError(
                f"results use different alternatives: "
                f"{first.alternative!r} vs {r.alternative!r}"
            )
        if not np.array_equal(r.n_vars_present, first.n_vars_present) or \
           not np.array_equal(r.total_size, first.total_size):
            raise ValueError("results have different node-overlap counts")
        # observed is deterministic given the inputs, so any drift beyond
        # numeric noise means the analyses ran on different data
        if not np.allclose(
            r.observed, first.observed, rtol=1e-4, atol=1e-5, equal_nan=True
        ):
            raise ValueError(
                "observed statistics differ between results — these are not "
                "runs of the same analysis"
            )

    spaces = [r.total_space for r in results if r.total_space is not None]
    total_space = spaces[0] if spaces else None
    for s in spaces[1:]:
        same = (s == total_space) or (
            np.isfinite(s) and np.isfinite(total_space)
            and np.isclose(s, total_space, rtol=1e-9)
        )
        if not same:
            raise ValueError(
                f"results record different permutation-space sizes "
                f"({total_space!r} vs {s!r})"
            )

    if any(r.nulls is None for r in results):
        return _combine_count_results(results, total_space)

    blocks = [np.asarray(r.nulls[: r.completed]) for r in results]
    if not allow_duplicate_nulls:
        _refuse_duplicate_nulls(blocks, total_space)

    nulls = np.concatenate(blocks, axis=0)
    # pooled with a sequential input, per-module counts stay ragged (each
    # block brings its own NaN tail); they are recounted from the pooled
    # array, whose p-values permutation_pvalues already groups by count
    any_seq = _any_sequential(results)
    return PreservationResult(
        discovery=first.discovery,
        test=first.test,
        module_labels=list(first.module_labels),
        observed=first.observed,
        nulls=nulls,
        p_values=pv.permutation_pvalues(
            first.observed, nulls, first.alternative, total_nperm=total_space
        ),
        n_vars_present=first.n_vars_present,
        prop_vars_present=first.prop_vars_present,
        total_size=first.total_size,
        alternative=first.alternative,
        n_perm=int(sum(r.n_perm for r in results)),
        completed=int(nulls.shape[0]),
        total_space=total_space,
        n_perm_used=pv.effective_nperm(nulls) if any_seq else None,
        p_type="sequential" if any_seq else "fixed",
    )


def _any_sequential(results) -> bool:
    return any(r.p_type == "sequential" or r.n_perm_used is not None
               for r in results)


def _refuse_duplicate_nulls(blocks, total_space) -> None:
    """Raise when more byte-identical null rows are shared between inputs
    than independent draws from a space of ``total_space`` would give (a
    seed run twice, or an interrupted run's prefix); warn on a single
    chance collision."""
    # all-NaN rows carry no draw identity, so they never count
    per_block = [
        Counter(
            hashlib.sha256(np.ascontiguousarray(row)).digest()
            for row in block
            if not np.isnan(row).all()
        )
        for block in blocks
    ]
    total = Counter()
    for c in per_block:
        total.update(c)
    # colliding pairs across different inputs: all identical pairs minus
    # the within-block ones
    cross_pairs = sum(t * (t - 1) // 2 for t in total.values()) - sum(
        v * (v - 1) // 2 for c in per_block for v in c.values()
    )
    if not cross_pairs:
        return
    sizes = [b.shape[0] for b in blocks]
    n_pairs = (sum(sizes) ** 2 - sum(s * s for s in sizes)) / 2
    if (total_space is not None and np.isfinite(total_space)
            and total_space > 0):
        expected = n_pairs / total_space
        threshold = expected + 4.0 * np.sqrt(expected) + 0.5
    else:
        # space size unknown or infinite: a duplicated seed replicates
        # ~100% of the smaller block, so tolerate up to 5% of it
        expected = 0.0
        threshold = 0.05 * min(s for s in sizes if s) + 0.5
    if (cross_pairs > threshold and cross_pairs == 1
            and min(s for s in sizes if s) > 1):
        # one colliding pair in a large space is far more often a chance
        # collision than a duplicated seed; with a 1-row block, one
        # collision IS its full duplication and raises below
        warnings.warn(
            "one byte-identical null row shared between inputs "
            f"(~{expected:.2g} expected by chance); keeping the "
            "merge — a duplicated seed would replicate many rows",
            stacklevel=4,
        )
    elif cross_pairs > threshold:
        raise ValueError(
            f"{cross_pairs} byte-identical null row pair(s) shared "
            f"between inputs (~{expected:.2f} expected by chance "
            "for this permutation space) — the same seed run "
            "twice?; pooling correlated permutations biases "
            "p-values. Pass allow_duplicate_nulls=True to "
            "override."
        )


def _combine_count_results(results, total_space):
    """Pool results in count space — the merge path when any input is a
    streaming (``store_nulls=False``) result: per-cell exceedance tallies
    and valid-draw counts are additive across independent runs, and the
    Phipson–Smyth estimator over the pooled counts equals the estimator
    over the pooled null arrays (it only ever reads counts)."""
    first = results[0]
    parts = []
    for r in results:
        if r.counts_hi is not None:
            parts.append((
                np.asarray(r.counts_hi, dtype=np.int64),
                np.asarray(r.counts_lo, dtype=np.int64),
                np.asarray(r.counts_eff, dtype=np.int64),
            ))
        elif r.nulls is not None:
            parts.append(pv.tail_counts(r.observed, r.nulls[: r.completed]))
        else:
            raise ValueError(
                f"result ({r.discovery!r}, {r.test!r}) carries neither a "
                "null array nor exceedance counts; it cannot be combined"
            )
    hi = sum(p[0] for p in parts)
    lo = sum(p[1] for p in parts)
    eff = sum(p[2] for p in parts)
    any_seq = _any_sequential(results)
    return PreservationResult(
        discovery=first.discovery,
        test=first.test,
        module_labels=list(first.module_labels),
        observed=first.observed,
        nulls=None,
        counts_hi=hi,
        counts_lo=lo,
        counts_eff=eff,
        p_values=pv.counts_pvalues(
            first.observed, hi, lo, eff, first.alternative,
            total_nperm=total_space,
        ),
        n_vars_present=first.n_vars_present,
        prop_vars_present=first.prop_vars_present,
        total_size=first.total_size,
        alternative=first.alternative,
        n_perm=int(sum(r.n_perm for r in results)),
        completed=int(sum(r.completed for r in results)),
        total_space=total_space,
        n_perm_used=(sum(r.module_n_perm() for r in results) if any_seq
                     else None),
        p_type="sequential" if any_seq else "fixed",
    )


def results_table(results):
    """One tidy table across every (discovery, test) pair — accepts a single
    :class:`PreservationResult`, a ``{test: result}`` dict, or the full
    ``{discovery: {test: result}}`` nesting from ``simplify=False``.
    Concatenates each pair's :meth:`PreservationResult.to_frame`."""
    if isinstance(results, PreservationResult):
        return results.to_frame()
    if isinstance(results, dict):
        frames = []
        for v in results.values():
            inner = v.values() if isinstance(v, dict) else [v]
            for r in inner:
                if not isinstance(r, PreservationResult):
                    raise TypeError(
                        f"expected PreservationResult values, got {type(r).__name__}"
                    )
                frames.append(r.to_frame())
        if not frames:
            raise ValueError("no results to tabulate")
        return pd.concat(frames, ignore_index=True)
    raise TypeError(
        "results_table takes a PreservationResult or the nested dict "
        f"module_preservation returns, got {type(results).__name__}"
    )


def shape_results(results: dict[str, dict[str, PreservationResult]],
                  simplify: bool):
    """``simplify=True`` collapses single-discovery/single-test nesting."""
    if not simplify:
        return results
    if len(results) == 1:
        inner = next(iter(results.values()))
        if len(inner) == 1:
            return next(iter(inner.values()))
        return inner
    return results
