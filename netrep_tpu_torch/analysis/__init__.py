"""The port's static analysis: the invariant linter.

The port of ``netrep_tpu/analysis/``. The contracts that make
exact reproducibility hold — the ``fold_in(key, i)`` RNG discipline of
:mod:`netrep_tpu_torch.random`, the fault-taxonomy line that bugs never
silently retry, the pinned telemetry event schema, the ``x_``
checkpoint-extras namespace and the run key's identity, lock discipline
across thread seams, and the port's own rules (no JAX imports, TF32 off,
no device fallback) — are encoded as AST rules
(:mod:`netrep_tpu_torch.analysis.rules`) and enforced by a walker with
inline, reasoned, counted suppressions
(:mod:`netrep_tpu_torch.analysis.linter`).

Run it: ``python -m netrep_tpu_torch lint [--json] [--rule NAME]
[paths...]`` (exit 2 on findings). ``tests/test_torch_lint.py`` asserts
the port lints clean, so every new violation must be fixed or justified
in the same commit that introduces it.
"""

from .linter import (  # noqa: F401
    LINT_SCHEMA, LintReport, lint_paths, lint_source,
)
from .rules import Finding, Module, default_rules  # noqa: F401

__all__ = [
    "LINT_SCHEMA",
    "LintReport",
    "Finding",
    "Module",
    "default_rules",
    "lint_paths",
    "lint_source",
]
