"""The comparison that decides ``correct``: the port's answers against the
reference's, each number beside its limit.

What a call answers: its observed statistics ``(K, 7)``, its p-values
``(K, 7)`` and, when it keeps them, its null values ``(n_perm, K, 7)``. A
run compares, once its window has closed, every call's observed values; in
calls that keep their null, a sample of permutations drawn from the run's
seed (the first and the last among them); and in one call drawn from the
seed, the p-values of a sample of modules (the largest among them), which
the reference recounts over every permutation of that call. The numbers:

- ``observed_gap``: the widest absolute gap of an observed statistic;
- ``null_gap``: the widest absolute gap of a sampled null value;
- ``count_gap``: in permutations, how far the count a call's p-value
  stands for (``p (eff + 1) - 1``) lies outside the reference's band.

A NaN on one side only is an infinite gap. A value the reference gives as
an interval (``netstats.module_stats``) is compared by its distance outside
that interval. The band of a count runs from the permutations surely at
least as extreme as the observed value to those possibly so: a null value
within ``TIE`` of the observed one, or whose interval reaches it, may count
either way. A sparse module can need it: where most of its discovery
degrees are 0, ``cor.degree`` takes one value, exactly, for every
permutation whose one edge joins two such nodes, and rounding alone
decides whether that tie counts. Pool positions are node
positions (both datasets hold the same nodes in the same order), and module
``k`` takes positions ``[off_k, off_k + m_k)`` of each drawn permutation,
modules in label order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from . import threefry
from .netstats import Precision, module_stats

#: elements of one batch of gathered ``(B, m, m)`` submatrices
_BATCH_ELEMS = 1 << 24
#: permutations drawn at once
_DRAW_BATCH = 1024
#: null values this close to the observed one may count either way:
#: ten times the widest gap between the port's and the reference's copy of
#: one exact tie (1.2e-7, a cor.degree on a graph of uniformly drawn edges)
TIE = 1e-6


@dataclasses.dataclass
class CallAnswer:
    """What one call answered: ``null_rows(index)`` gives the null values of
    the permutations ``index`` ``(len, K, 7)``, or None when the call kept
    no null."""

    seed: int
    n_perm: int
    observed: np.ndarray
    p_values: np.ndarray
    null_rows: Callable[[np.ndarray], np.ndarray | None]


def observed(problem, prec: Precision):
    """The observed statistics ``(K, 7)`` (exact summary profiles) and
    their half-widths."""
    vals, half = [], []
    for k, idx in enumerate(problem.modules):
        disc = problem.discovery(k, prec)
        t = torch.as_tensor(idx, device=problem.device)[None]
        v, h = module_stats(disc, *problem.test_parts(t, prec), prec, "eigh", 0)
        vals.append(v[0])
        half.append(h[0])
    return (torch.stack(vals).double().cpu().numpy(),
            torch.stack(half).double().cpu().numpy())


def _module_batches(problem, k, perms, off):
    m = problem.modules[k].size
    step = max(1, _BATCH_ELEMS // (m * m))
    for a in range(0, perms.shape[0], step):
        yield a, perms[a:a + step, off[k]:off[k] + m]


def null_rows(problem, seed: int, index, prec: Precision, modules=None):
    """Null values ``(len(index), K, 7)`` of permutations ``index`` of the
    call seeded ``seed`` and their half-widths (NaN in modules not asked
    for)."""
    index = np.asarray(index, dtype=np.int64)
    K = len(problem.modules)
    ks = range(K) if modules is None else modules
    vals = np.full((index.size, K, 7), np.nan)
    half = np.zeros((index.size, K, 7))
    off = np.concatenate([[0], np.cumsum([m.size for m in problem.modules])])
    discs = {k: problem.discovery(k, prec) for k in ks}
    for a in range(0, index.size, _DRAW_BATCH):
        perms = threefry.draw(seed, index[a:a + _DRAW_BATCH], problem.n_pool,
                              problem.device)
        for k in ks:
            for b, idx in _module_batches(problem, k, perms, off):
                v, h = module_stats(discs[k], *problem.test_parts(idx, prec),
                                    prec, problem.method, problem.n_iter)
                rows = slice(a + b, a + b + idx.shape[0])
                vals[rows, k] = v.double().cpu().numpy()
                half[rows, k] = h.double().cpu().numpy()
    return vals, half


def recount(problem, seed: int, n_perm: int, obs, modules, prec: Precision) -> dict:
    """Over all ``n_perm`` permutations of the call seeded ``seed``, for
    ``modules`` (zero elsewhere): the counts at least as extreme as ``obs``
    (``hi``), the band of such counts (``surely``, ``possibly``) and the
    valid draws (``eff``), each ``(K, 7)``."""
    o, oh = obs
    K = len(problem.modules)
    out = {k: np.zeros((K, 7), dtype=np.int64) for k in ("hi", "surely", "possibly", "eff")}
    for a in range(0, n_perm, _DRAW_BATCH * 4):
        v, h = null_rows(problem, seed, np.arange(a, min(n_perm, a + _DRAW_BATCH * 4)),
                         prec, modules)
        with np.errstate(invalid="ignore"):
            out["hi"] += (v >= o[None]).sum(0)
            out["surely"] += (v - h >= o[None] + oh[None] + TIE).sum(0)
            out["possibly"] += (v + h >= o[None] - oh[None] - TIE).sum(0)
        out["eff"] += (~np.isnan(v)).sum(0)
    return out


def p_values(hi, eff, obs) -> np.ndarray:
    """Phipson–Smyth p-values ``(hi + 1) / (eff + 1)`` (the limit of
    ``statmod::permp`` over a permutation space far larger than the draws,
    as every space here is); NaN where the observed value is or no draw
    was valid."""
    with np.errstate(invalid="ignore", divide="ignore"):
        p = (hi + 1.0) / (eff + 1.0)
    p[(eff == 0) | np.isnan(obs)] = np.nan
    return p


def _gap(got, want, half=0.0) -> float:
    """The widest distance of ``got`` outside ``want ± half``; infinite
    where one side only is NaN."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if (np.isnan(got) != np.isnan(want)).any():
        return float("inf")
    fin = ~np.isnan(want)
    over = np.abs(got - want) - np.broadcast_to(half, want.shape)
    return float(np.maximum(over[fin], 0.0).max(initial=0.0))


@dataclasses.dataclass(frozen=True)
class Plan:
    """What a run checks, drawn from its seed: for each call the sampled
    permutations, the call whose p-values are recounted, and the modules
    recounted."""

    perms: tuple
    count_call: int
    count_modules: tuple


def plan(seed: int, calls: list[CallAnswer], sizes, perms_per_call: int,
         count_modules: int) -> Plan:
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EED])
    perms = []
    for c in calls:
        pick = rng.choice(c.n_perm, size=min(perms_per_call, c.n_perm), replace=False)
        perms.append(tuple(sorted({0, c.n_perm - 1, *pick.tolist()})))
    count_call = int(rng.integers(len(calls)))
    K = len(sizes)
    mods = rng.choice(K, size=min(count_modules, K), replace=False).tolist()
    mods = sorted({int(np.argmax(sizes)), *mods})
    return Plan(tuple(perms), count_call, tuple(mods))


def reference_answers(problem, calls: list[CallAnswer], p: Plan,
                      prec: Precision) -> dict:
    """The reference's side of every compared number."""
    obs = observed(problem, prec)
    c = calls[p.count_call]
    return {
        "observed": obs,
        "nulls": [null_rows(problem, call.seed, idx, prec)
                  for call, idx in zip(calls, p.perms)],
        "counts": recount(problem, c.seed, c.n_perm, obs, p.count_modules, prec),
    }


def compare(calls: list[CallAnswer], ref: dict, p: Plan) -> dict:
    """``{name: reading}`` of the port's answers against the reference's."""
    out = {"observed_gap": max(_gap(c.observed, *ref["observed"]) for c in calls)}
    null = []
    for call, idx, want in zip(calls, p.perms, ref["nulls"]):
        got = call.null_rows(np.asarray(idx))
        if got is not None:
            null.append(_gap(got, *want))
    if null:
        out["null_gap"] = max(null)
    c, cnt = calls[p.count_call], ref["counts"]
    mods = list(p.count_modules)
    p_ref = p_values(cnt["hi"], cnt["eff"], ref["observed"][0])[mods]
    p_got = c.p_values[mods]
    if (np.isnan(p_got) != np.isnan(p_ref)).any():
        out["count_gap"] = float("inf")
    else:
        fin = ~np.isnan(p_ref)
        got = p_got * (cnt["eff"][mods] + 1.0) - 1.0
        below = cnt["surely"][mods] - got
        above = got - cnt["possibly"][mods]
        # a count is a whole number of permutations: round off p's rounding
        out["count_gap"] = round(float(np.maximum(np.maximum(below, above)[fin], 0.0)
                                       .max(initial=0.0)), 6)
    return out


def control_answers(problem, calls: list[CallAnswer], p: Plan,
                    prec: Precision) -> list[CallAnswer]:
    """The control in the program's place: each call answered by the
    reference in ``prec``, the precision below the configuration's (TF32
    for float32 with TF32 off), on the same seeds, samples and modules."""
    obs = observed(problem, prec)
    out = []
    for i, c in enumerate(calls):
        if i == p.count_call:
            cnt = recount(problem, c.seed, c.n_perm, obs, p.count_modules, prec)
            pv = p_values(cnt["hi"], cnt["eff"], obs[0])
        else:
            pv = np.full_like(obs[0], np.nan)
        keeps = c.null_rows(np.asarray([0])) is not None
        out.append(CallAnswer(
            c.seed, c.n_perm, obs[0], pv,
            (lambda idx, s=c.seed: null_rows(problem, s, idx, prec)[0]) if keeps
            else (lambda idx: None)))
    return out
