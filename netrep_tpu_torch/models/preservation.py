"""``module_preservation`` — the port's main entry point: validate inputs,
loop over (discovery, test) dataset pairs, run the permutation engine, and
turn its null into exact Phipson–Smyth p-values and result objects.

The port of the dense path of ``netrep_tpu/models/preservation.py``, with
the same argument names and defaults and the same seeding contract (same
seed ⇒ the same permutations, counts and p-values as the JAX package),
including ``vmap_tests`` (one discovery against several test cohorts on a
shared permutation draw, :mod:`netrep_tpu_torch.parallel.multitest`) and
``mesh`` (the null split over a grid of devices, with the test matrices
replicated or split by rows, :mod:`netrep_tpu_torch.parallel.mesh`). Runs
on the card unless ``device="cpu"`` is passed.

Device memory: the input checks stream each matrix to the device in
float64 tiles and leave it there as float32
(:func:`~netrep_tpu_torch.models.dataset.build_datasets`), after which the
datasets hand their matrices to the engines pair by pair
(:func:`~netrep_tpu_torch.models.dataset.place`). While a pair's null runs
the device holds only what that pair's engine reads — the test
correlation, the test network unless ``network_from_correlation`` derives
it, the test data — and no discovery matrix; a matrix a later pair needs
waits in pinned host memory as float32.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import time
from typing import Callable

import numpy as np
import torch

from ..ops import pvalues as pv
from ..parallel import mesh as tmesh
from ..parallel.engine import (
    ModuleSpec, PermutationEngine, build_discovery, check_derived_network,
)
from ..parallel.multitest import MultiTestEngine
from ..utils import checkpoint as ckpt
from ..utils.config import EngineConfig
from . import dataset as ds
from .results import PreservationResult, shape_results

logger = logging.getLogger("netrep_tpu_torch")

#: arguments of the JAX entry point that belong to later slices of the
#: port, with the ROADMAP.md Queue 1 item that brings each
_LATER = {
    "telemetry": (None, "item 16 (device-touching utils and CLI)"),
    "fault_policy": (None, "item 16 (device-touching utils and CLI)"),
    "n_threads": (None, "item 16 (device-touching utils and CLI)"),
    "profile": (None, "item 16 (device-touching utils and CLI)"),
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _overlap_setup(disc_ds, test_ds, assignments, modules, background_label,
                   null):
    """Kept modules, specs, pool and overlap bookkeeping for one
    (discovery, test) pair."""
    labels, specs, counts = ds.module_overlap(
        disc_ds, test_ds, assignments, modules, background_label
    )
    dropped = [lab for lab, _di, ti in specs if len(ti) < 2]
    if dropped:
        logger.warning(
            "discovery %r → test %r: dropping module(s) %s with <2 nodes "
            "present in the test dataset", disc_ds.name, test_ds.name, dropped,
        )
    kept = [(lab, di, ti) for lab, di, ti in specs if len(ti) >= 2]
    if not kept:
        raise ValueError(
            f"no module of discovery {disc_ds.name!r} has ≥2 nodes present "
            f"in test {test_ds.name!r}; nothing to test"
        )
    labels = [lab for lab, _, _ in kept]
    mod_specs = [ModuleSpec(lab, di, ti) for lab, di, ti in kept]

    tpos = test_ds.index_of()
    if null == "overlap":
        pool = np.asarray(
            [tpos[nm] for nm in disc_ds.node_names if nm in tpos],
            dtype=np.int32,
        )
    else:
        pool = np.arange(test_ds.n_nodes, dtype=np.int32)
    return labels, mod_specs, counts, pool


def _make_result(d_name, t_name, labels, counts, observed, nulls, completed,
                 np_this, alternative, total_space, profile=None, stream=None,
                 p_type="fixed"):
    hi = lo = eff = n_perm_used = None
    if stream is not None:
        # streaming run: exact Phipson–Smyth from the device-tallied
        # exceedance counts — identical to the materialized p-values
        p_values = pv.counts_pvalues(
            observed, stream.hi, stream.lo, stream.eff, alternative,
            total_nperm=total_space,
        )
        hi, lo, eff = stream.hi, stream.lo, stream.eff
        if p_type == "sequential":
            n_perm_used = np.asarray(stream.n_perm_used)
    elif p_type == "sequential":
        # adaptive run: retired modules' rows are NaN past retirement —
        # Phipson–Smyth at each module's own count
        p_values, n_perm_used = pv.sequential_pvalues(
            observed, nulls[:completed], alternative, total_nperm=total_space
        )
    else:
        p_values = pv.permutation_pvalues(
            observed, nulls[:completed], alternative, total_nperm=total_space
        )
    n_present = np.array([counts[lab][0] for lab in labels])
    tot = np.array([counts[lab][1] for lab in labels])
    return PreservationResult(
        discovery=d_name,
        test=t_name,
        module_labels=labels,
        observed=observed,
        nulls=nulls,
        counts_hi=hi,
        counts_lo=lo,
        counts_eff=eff,
        p_values=p_values,
        n_vars_present=n_present,
        prop_vars_present=n_present / tot,
        total_size=tot,
        alternative=alternative,
        n_perm=np_this,
        completed=completed,
        profile=profile,
        total_space=total_space,
        n_perm_used=n_perm_used,
        p_type=p_type,
    )


def _checkpoint_path(checkpoint_dir, d_name, t_name) -> str | None:
    """``<dir>/null_<discovery>__<test>.npz``, the JAX package's name (a
    multi-test group's tests joined by ``+``), unsafe characters as
    ``_``."""
    if checkpoint_dir is None:
        return None

    def safe(s):
        return re.sub(r"[^A-Za-z0-9_.-]", "_", str(s))

    return os.path.join(checkpoint_dir,
                        f"null_{safe(d_name)}__{safe(t_name)}.npz")


def module_preservation(
    network,
    data=None,
    correlation=None,
    module_assignments=None,
    modules=None,
    background_label: str = "0",
    discovery=None,
    test=None,
    self_preservation: bool = False,
    n_perm: int | None = None,
    null: str = "overlap",
    alternative: str = "greater",
    simplify: bool = True,
    seed: int = 0,
    config: EngineConfig | None = None,
    progress: Callable[[int, int], None] | None = None,
    store_nulls: bool = True,
    device=None,
    backend: str = "torch",
    adaptive: bool = False,
    mesh=None,
    vmap_tests: bool = False,
    checkpoint_dir: str | None = None,
    telemetry=None,
    fault_policy=None,
    data_only=None,
    verbose: bool = False,
    n_threads: int | None = None,
    profile=None,
    checkpoint_every: int = 8192,
    adaptive_rule=None,
    adaptive_priors=None,
):
    """Permutation test of network module preservation across datasets.

    Arguments follow ``netrep_tpu.module_preservation``; its dense path is
    what this port runs:

    - ``seed`` — same seed ⇒ the same permutations as the JAX package, so
      the same counts and p-values (up to ties a rounding difference of the
      statistics can move);
    - ``store_nulls`` — ``False`` keeps only on-device exceedance tallies
      (``result.nulls`` is None, ``counts_hi/lo/eff`` are set); the
      p-values are the same;
    - ``device`` — None means ``"cuda"``, and raises without a card; pass
      ``"cpu"`` to run the plain versions of the kernels on the CPU;
    - ``progress`` — callback ``(done, total)`` per chunk (materialized) or
      superchunk (streaming);
    - ``vmap_tests`` — a discovery dataset with several test datasets that
      share one node universe and agree on data presence runs them in one
      multi-test engine on one shared permutation draw; each pair's result
      is the one its own run gives with the same seed. Otherwise the pairs
      run one after another, with a warning. With a ``mesh`` it raises
      ``NotImplementedError`` for a group of several cohorts (the
      multi-test engine on a mesh is a later slice);
    - ``mesh`` — optional :class:`~netrep_tpu_torch.parallel.mesh.Mesh`
      (:func:`~netrep_tpu_torch.parallel.mesh.make_mesh`); permutation
      chunks are split across the mesh's ``perm`` axis, and with
      ``config.matrix_sharding='row'`` the n×n matrices are split by rows
      over its row axis, with module gathers assembled from the row
      blocks. Same seed ⇒ the same permutations, counts and p-values at
      every mesh shape. A mesh of cards needs ``device`` None or
      ``"cuda"``; a CPU mesh needs ``device="cpu"``.

    ``result.profile`` holds the seconds of each phase: ``input_s`` (input
    checks, shared by every pair), ``engine_s`` (the pair's discovery side,
    built for every pair before the first null, then its test matrices put
    on the device and its engine built), ``observed_s``, ``null_s`` and
    ``perms_per_s`` (shared by the pairs of one multi-test run).

    Device memory: every pair's discovery side is built first; then, while
    a pair's null runs, the device holds only what that pair's engine
    reads. A test matrix that a later pair needs waits in pinned host
    memory as float32 meanwhile, and goes back to the device for that
    pair; both copies run on a side stream, beside the null.

    - ``verbose`` — logs one line per (discovery, test) pair before its null
      and one after it, through the ``netrep_tpu_torch`` logger at INFO.
    - ``checkpoint_dir`` — each pair's partial null (or, streaming, its
      tallies) is saved to ``<dir>/null_<discovery>__<test>.npz`` every
      ``checkpoint_every`` permutations, on an interrupt and at the end;
      the same call again resumes exactly. The file, its key data and its
      fingerprint are the JAX package's: either package resumes the
      other's checkpoint of the same inputs, modules and seed. A
      ``KeyboardInterrupt`` ends the run after the pair it lands in, whose
      result covers the permutations completed.
    - ``adaptive`` — sequential early stopping (Besag & Clifford 1991,
      :mod:`netrep_tpu_torch.ops.sequential`): ``n_perm`` becomes a
      ceiling and a module whose decision at the rule's alpha is settled
      stops drawing permutations and drops out of later chunks;
      p-values are Phipson–Smyth at each module's own count
      (``p_type='sequential'``, ``result.n_perm_used``). Both null modes;
      the same seed gives the JAX package's retirements, counts and
      p-values. ``adaptive_rule`` is a
      :class:`~netrep_tpu_torch.ops.sequential.StopRule`;
      ``adaptive_priors`` a ``(counts_hi, counts_lo, n_perm_used)``
      triple of a prior run of the one pair, seeded into the rule's
      decisions only (needs ``adaptive=True``, ``store_nulls=True`` and
      one pair).

    - ``data_only`` — the atlas module plane: a soft-threshold power β
      (or ``(β, kind)``) and ``network=None, correlation=None``; each
      dataset is only its data (:func:`~netrep_tpu_torch.models.dataset.
      build_data_only_datasets`), and every submatrix derives from
      gathered data rows (``zᵀz/(s-1)``, then the construction), so no
      ``n × n`` matrix exists on the device. It runs every null mode and
      mesh above; ``vmap_tests`` pairs run one by one, with the warning.
      The same seed gives the JAX package's permutations, counts and
      p-values (:func:`netrep_tpu_torch.models.atlas_api.
      module_preservation` is the same call with β 2.0 by default).

    ``telemetry``, ``fault_policy``, ``n_threads``,
    ``profile`` and ``backend='native'`` belong to later slices: any value
    but the JAX package's default raises ``NotImplementedError`` naming
    the item.

    Returns ``{discovery: {test: PreservationResult}}``, collapsed by
    ``simplify``.
    """
    given = dict(telemetry=telemetry, fault_policy=fault_policy,
                 n_threads=n_threads, profile=profile)
    for name, (default, item) in _LATER.items():
        if given[name] is not default:
            raise NotImplementedError(
                f"{name}= is not ported yet: ROADMAP.md Queue 1 {item}"
            )
    if backend == "native":
        raise NotImplementedError(
            "backend='native' (the threaded C++ tier) is not ported yet: "
            "ROADMAP.md Queue 1 item 16"
        )
    if backend != "torch":
        raise ValueError(f"backend must be 'torch', got {backend!r}")
    if null not in ("overlap", "all"):
        raise ValueError(f"null must be 'overlap' or 'all', got {null!r}")
    if alternative not in ("greater", "less", "two.sided"):
        raise ValueError(
            "alternative must be one of 'greater', 'less', 'two.sided', "
            f"got {alternative!r}"
        )
    if data_only is not None:
        config = _data_only_config(network, data, correlation, data_only,
                                   config)
    dev = tmesh.resolve_device(mesh, device)
    config = config or EngineConfig()

    t0 = time.perf_counter()
    datasets = (
        ds.build_data_only_datasets(data, device=dev)
        if data_only is not None
        else ds.build_datasets(network, data=data, correlation=correlation,
                               device=dev)
    )
    _sync(dev)
    input_s = time.perf_counter() - t0
    pairs = ds.resolve_pairs(datasets, discovery, test, self_preservation)
    if adaptive_priors is not None:
        if not adaptive:
            raise ValueError(
                "adaptive_priors seeds the sequential stop monitor; it "
                "requires adaptive=True"
            )
        if not store_nulls:
            raise ValueError(
                "adaptive_priors requires the default backend='torch' with "
                "store_nulls=True (the materialized adaptive path)"
            )
        if len(pairs) != 1:
            raise ValueError(
                "adaptive_priors carries ONE cell's prior tallies; got "
                f"{len(pairs)} (discovery, test) pairs — warm-start each "
                "pair separately (grid_preservation does this per cell)"
            )
    # the checkpoint identity samples the inputs as the user gave them
    sources = (None if checkpoint_dir is None
               else ds.input_sources(network, data, correlation))
    disc_names = sorted({d for d, _ in pairs}, key=list(datasets).index)
    assign = ds.normalize_module_assignments(
        module_assignments, datasets, disc_names
    )

    def auto_n_perm(labels, with_data):
        # Bonferroni across all module×statistic tests: 7 statistics with
        # data, 3 topology-only without; floor of 1000
        n_stats_eff = 7 if with_data else 3
        return max(1000, pv.required_perms(0.05,
                                           n_tests=len(labels) * n_stats_eff))

    by_disc: dict[str, list[str]] = {}
    for d_name, t_name in pairs:
        by_disc.setdefault(d_name, []).append(t_name)

    # every group's discovery side first, while every dataset is still on
    # the device (one multi-test engine for a group of cohorts, or one
    # engine a pair): after it no discovery matrix is read again
    plan = []
    for d_name, t_names in by_disc.items():
        disc_ds = datasets[d_name]
        can_vmap = (
            vmap_tests
            and len(t_names) > 1
            # data-only pairs run one by one: the multi-test engine stacks
            # the cohorts' matrices, which data-only datasets do not hold
            and data_only is None
            and all(datasets[t].node_names == datasets[t_names[0]].node_names
                    for t in t_names)
            and len({datasets[t].data is not None for t in t_names}) == 1
        )
        if can_vmap and mesh is not None:
            raise NotImplementedError(
                "vmap_tests=True with a mesh is not ported yet: ROADMAP.md "
                "Queue 1 item 14 (the multi-test engine on a mesh); run the "
                "cohorts without vmap_tests or without a mesh"
            )
        if vmap_tests and not can_vmap and len(t_names) > 1:
            logger.warning(
                "vmap_tests requested but unavailable (requires the default "
                "backend='torch' and materialized matrices; test datasets %s "
                "must share a node universe and agree on data presence); "
                "falling back to sequential pairs", t_names,
            )
        for group in ([t_names] if can_vmap else [[t] for t in t_names]):
            test_ds = datasets[group[0]]
            with_data = disc_ds.data is not None and test_ds.data is not None
            setup = _overlap_setup(disc_ds, test_ds, assign[d_name], modules,
                                   background_label, null)
            t1 = time.perf_counter()
            buckets = build_discovery(
                disc_ds.correlation, disc_ds.network,
                disc_ds.data if with_data else None, setup[1], setup[3],
                config, dev, mesh,
            )
            _sync(dev)
            fields = {"correlation", "network"} | ({"data"} if with_data
                                                    else set())
            plan.append((d_name, group, with_data, setup, buckets, fields,
                         time.perf_counter() - t1,
                         _identity(sources, d_name, group, with_data)))
    del sources

    results: dict[str, dict[str, PreservationResult]] = {}
    for gi, (d_name, group, with_data, (labels, mod_specs, counts, pool),
             buckets, fields, disc_s, digests) in enumerate(plan):
        # the group's test matrices on the device; those of a later group
        # wait on the host; the rest (every discovery-only matrix) go
        later: dict[str, set] = {}
        for _d, g, _w, _s, _b, f, *_ in plan[gi + 1:]:
            for t in g:
                later.setdefault(t, set()).update(f)
        multi = len(group) > 1
        np_this = n_perm if n_perm is not None else auto_n_perm(labels,
                                                                with_data)
        t1 = time.perf_counter()
        ds.place(datasets, {t: fields for t in group}, later, dev)
        tests = [datasets[t] for t in group]
        if config.network_from_correlation is not None and data_only is None:
            for i, t in enumerate(tests):
                check_derived_network(t.correlation, t.network,
                                      config.network_from_correlation,
                                      f"test[{i}]" if multi else "test")
        parts = (pool, buckets, len(mod_specs), config, dev)
        if multi:
            engine = MultiTestEngine.from_parts(
                [t.correlation for t in tests], [t.network for t in tests],
                [t.data.T for t in tests] if with_data else None, *parts,
                modules=mod_specs, digest=digests[0],
                test_digest=digests[1],
            )
        else:
            engine = PermutationEngine.from_parts(
                tests[0].correlation, tests[0].network,
                tests[0].data.T if with_data else None, *parts, mesh=mesh,
                modules=mod_specs, digest=digests[0],
            )
        # the engine holds what its null reads; the datasets let go of the
        # rest (a matrix of a later group waits on the host)
        ds.place(datasets, {}, later, dev)
        _sync(dev)
        t2 = time.perf_counter()
        observed = engine.observed()
        t3 = time.perf_counter()
        if verbose:
            logger.info(
                "discovery %r → test(s) %s: %d modules, %d permutations, "
                "null=%r", d_name, group, len(labels), np_this, null,
            )
        run = dict(key=seed, progress=progress,
                   checkpoint_path=_checkpoint_path(checkpoint_dir, d_name,
                                                    "+".join(group)),
                   checkpoint_every=checkpoint_every)
        nulls = stream = None
        if adaptive:
            run.update(alternative=alternative, rule=adaptive_rule)
            if store_nulls:
                if adaptive_priors is not None:
                    run["priors"] = adaptive_priors
                nulls, completed, finished = engine.run_null_adaptive(
                    np_this, observed, **run)
            else:
                stream = engine.run_null_adaptive_streaming(
                    np_this, observed, **run)
                completed, finished = stream.completed, stream.finished
        else:
            if store_nulls:
                nulls, completed = engine.run_null(np_this, **run)
            else:
                stream = engine.run_null_streaming(np_this, observed, **run)
                completed = stream.completed
            finished = completed >= np_this
        t4 = time.perf_counter()
        del engine
        times = dict(
            input_s=input_s, engine_s=disc_s + t2 - t1, observed_s=t3 - t2,
            null_s=t4 - t3, perms_per_s=completed / max(t4 - t3, 1e-12),
        )
        if verbose:
            logger.info(
                "discovery %r → test(s) %s: %d permutations in %.3f s",
                d_name, group, completed, times["null_s"],
            )
        total_space = pv.total_permutations(pool.size,
                                            [m.size for m in mod_specs])
        for ti, t_name in enumerate(group):
            def pick(a):
                # a multi-test run carries the cohort axis first
                return a[ti] if multi and a is not None else a

            results.setdefault(d_name, {})[t_name] = _make_result(
                d_name, t_name, labels, counts, pick(observed),
                pick(nulls), completed, np_this, alternative,
                total_space, profile=times,
                stream=stream if stream is None or not multi
                else dataclasses.replace(stream, hi=stream.hi[ti],
                                         lo=stream.lo[ti],
                                         eff=stream.eff[ti]),
                p_type="sequential" if adaptive else "fixed",
            )
        if not finished:
            # Ctrl-C ends the whole run; the pairs done so far return
            logger.warning(
                "interrupted after %d/%d permutations; p-values use the "
                "completed subset; stopping remaining pairs",
                completed, np_this,
            )
            break
    return shape_results(results, simplify)


def _data_only_config(network, data, correlation, data_only,
                      config: EngineConfig | None) -> EngineConfig:
    """The JAX package's argument rules of ``data_only``, with its texts;
    returns ``config`` with ``network_from_correlation`` set to the
    derivation spec."""
    if network is not None or correlation is not None:
        raise ValueError(
            "data_only derives the correlation and network from data "
            "— drop the network/correlation arguments (or drop "
            "data_only to run on materialized matrices)"
        )
    if data is None:
        raise ValueError("data_only runs need data")
    cfg0 = config or EngineConfig()
    if (cfg0.network_from_correlation is not None
            and cfg0.network_from_correlation != data_only):
        raise ValueError(
            "config.network_from_correlation "
            f"({cfg0.network_from_correlation!r}) disagrees with "
            f"data_only ({data_only!r}); pass the derivation spec once"
        )
    return dataclasses.replace(cfg0, network_from_correlation=(
        tuple(data_only) if isinstance(data_only, list) else data_only))


def _identity(sources, d_name, group, with_data):
    """``(digest, test_digest)`` of a pair's (or a multi-test group's)
    checkpoint identity from the user's inputs, as the JAX package digests
    its float64 datasets: the engine's six inputs, or the discovery side
    and the stacked test side (``(None, None)`` without checkpoints)."""
    if sources is None:
        return None, None
    d = sources[d_name]
    tests = [sources[t] for t in group]
    if len(group) == 1:
        t = tests[0]
        return ckpt.content_digest(
            [d["correlation"], d["network"], d["data"], t["correlation"],
             t["network"], t["data"]], dtype="float64"), None
    return (
        ckpt.content_digest([d["correlation"], d["network"],
                             d["data"] if with_data else None, None, None,
                             None], dtype="float64"),
        ckpt.content_digest(
            [ckpt.Stack([t["correlation"] for t in tests]),
             ckpt.Stack([t["network"] for t in tests])]
            + ([t["data"] for t in tests] if with_data else []),
            dtype="float64"),
    )
