"""Result objects of the port's ``module_preservation``.

A copy of the dense-path parts of ``netrep_tpu/models/results.py``:
:class:`PreservationResult` (with ``save``/``load`` in the same ``.npz``
format, version 1, so either package reads the other's files) and
:func:`shape_results`. ``combine_analyses``, the tidy-table helpers and the
generalized-Pareto tail fit belong to later slices.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np

try:
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None

from ..ops.oracle import STAT_NAMES


def _atomic_savez(path: str, **arrays) -> None:
    """Write a compressed ``.npz`` through a temporary file in the target
    directory and ``os.replace``, so an interrupt never leaves a torn
    file."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


#: result fields of the JAX package's files that this port cannot carry
#: yet, with the ROADMAP.md Queue 1 item that brings each
_SEQUENTIAL = "item 8 (adaptive nulls)"
_TAIL = "item 13 (screened null and GPD tail)"


def _refuse_unported(path: str, meta: dict, files) -> None:
    """Raise a ``ValueError`` naming the field and its item when a file
    holds what a fixed-n result of this port cannot represent: a
    sequential p-value type or per-module permutation counts, inexact
    (screened) null values, or GPD tail p-values. Loading such a file as
    fixed-n would drop them without a word."""
    p_type = meta.get("p_type", "fixed")
    if p_type != "fixed":
        raise ValueError(
            f"{path}: p_type={p_type!r} is not ported yet (this port loads "
            f"fixed-n results only): ROADMAP.md Queue 1 {_SEQUENTIAL}"
        )
    if not meta.get("nulls_exact", True):
        raise ValueError(
            f"{path}: nulls_exact=False (a screened null) is not ported yet: "
            f"ROADMAP.md Queue 1 {_TAIL}"
        )
    for name, item in (("n_perm_used", _SEQUENTIAL), ("p_tail", _TAIL),
                       ("tail_ok", _TAIL)):
        if name in files:
            raise ValueError(
                f"{path}: the {name} array is not ported yet: ROADMAP.md "
                f"Queue 1 {item}"
            )


@dataclasses.dataclass
class PreservationResult:
    """Result for one (discovery, test) dataset pair.

    ``p_values`` are Phipson–Smyth exact permutation p-values (never zero);
    ``alternative='two.sided'`` uses min-tail × 2 capped at 1. A streaming
    run (``store_nulls=False``) carries the exceedance tallies
    ``counts_hi``/``counts_lo``/``counts_eff`` and ``nulls=None``.
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
            "p_type": "fixed",
            "store_nulls": self.nulls is not None,
            "nulls_exact": True,
        }
        extra = {
            name: np.asarray(getattr(self, name))
            for name in ("counts_hi", "counts_lo", "counts_eff")
            if getattr(self, name) is not None
        }
        _atomic_savez(
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
        """Load a result saved by :meth:`save`, or a fixed-n result the JAX
        package saved. A sequential, screened or GPD-tail file raises
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
