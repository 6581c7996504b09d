"""All-pairs preservation: the D×D grid of (discovery, test) cells as one
job.

The port of ``netrep_tpu/models/grid.py``. One (discovery, test) pair is
the unit of ``module_preservation``; a consortium asks the D·(D−1)
question — is every module of every cohort preserved in every other
cohort? — and asks it again whenever one cohort changes.
:func:`grid_preservation` runs that grid while keeping each cell's
p-values, counts and permutation counts those of the solo
:func:`~netrep_tpu_torch.models.preservation.module_preservation` call
with the same seed and config:

- **column packing** — the cells of one test dataset (a grid column) that
  share a permutation pool run as one
  :class:`~netrep_tpu_torch.serve.packer.GridPackedEngine`: shared bucket
  dispatches through the port's kernels, per-request discovery props,
  request-local slice offsets, per-request key groups;
- **discovery dedup** — one :class:`~netrep_tpu_torch.parallel.engine.
  ObservedCache` spans the grid, so the cells of one grid row compute
  their discovery props once (hits emit ``grid_dedup_hit``);
- **grid checkpoint** — with ``grid_dir``, a digest-keyed JSON manifest
  of per-cell results (each a :class:`~netrep_tpu_torch.models.results.
  PreservationResult` ``.npz``, readable by the JAX package) plus per-pack
  chunk checkpoints under ``ckpt/``: an interrupted grid resumes, and a
  finished cell is never recomputed;
- **interrupts** — a ``KeyboardInterrupt`` in a pack ends the grid after
  it: the finished cells are returned and written to the manifest, the
  interrupted pack's cells are left out and its checkpoint kept, so the
  same call resumes it (the JAX package records the pack's partial cells
  as finished and deletes the checkpoint; ROADMAP.md Queue 3). Any other
  error propagates after the pack's failure-save, as there;
- **incremental re-analysis** — when a dataset's content digest changes,
  only its row and column recompute, and each recomputed adaptive cell's
  stop monitor is seeded with the stored run's tallies (``grid_warmstart_
  seeded``); reported numbers stay fresh-draw-only.

Device memory: the input checks leave every column's dataset on the
device, as in ``module_preservation``; a row whose dataset is no column
keeps its host source, and only its buckets' blocks reach the device
(:func:`~netrep_tpu_torch.models.dataset.gather_block`). The grid keeps
there what a later pack reads and
lets go of the rest after each pack's engine is built (the engine holds
its test matrices and the props it built from its sources): no matrix
makes a round trip through host memory, so a grid's peak is its input
phase's, and while a pack's null runs the device holds its test matrices,
the props and the matrices of the packs still to run.

A manifest names its config by a hash of ``repr(EngineConfig)``, and the
two packages' configs print differently, so a manifest does not cross
packages; the cell files do.

``fleet=`` routes each cell through a serving fleet
(:class:`~netrep_tpu_torch.serve.fleet.FleetCoordinator`) instead of
running it here: every grid dataset registers once (broadcast to the
replicas), and each cell runs on the replica the hash ring places its
(discovery, test) digests on, under the serve path's own equality with
the solo call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import re
import time

import numpy as np

from ..ops import pvalues as pv
from ..parallel.engine import ObservedCache
from ..utils import checkpoint as ckpt
from ..utils import telemetry as tm
from ..utils.config import EngineConfig, resolve_device
from . import dataset as ds
from .preservation import _overlap_setup, _sync
from .results import PreservationResult

logger = logging.getLogger("netrep_tpu_torch")

MANIFEST_NAME = "grid_manifest.json"
_MANIFEST_VERSION = 1


@dataclasses.dataclass
class GridResult:
    """The grid's results and its accounting.

    ``results[discovery][test]`` is the cell's
    :class:`~netrep_tpu_torch.models.results.PreservationResult`.
    ``stats``: ``cells_total``, ``cells_computed``, ``cells_reused``,
    ``cells_warmstarted``, ``perms_evaluated`` (fresh permutations ×
    modules folded), ``packs``, the observed cache's ``dedup`` counters
    and ``wall_s``. ``profile``: the seconds of the input checks
    (``input_s``) and, per pack, of its engine build and of its observed
    pass and null (``packs``: ``column``, ``cells``, ``engine_s``,
    ``run_s``)."""

    results: dict
    stats: dict
    manifest_path: str | None = None
    profile: dict | None = None

    def cell(self, discovery, test) -> PreservationResult:
        return self.results[str(discovery)][str(test)]

    def __getitem__(self, key):
        return self.results[str(key)]

    def cells(self):
        for d, row in self.results.items():
            for t, res in row.items():
                yield d, t, res


def _cfg_id(config: EngineConfig) -> str:
    return hashlib.blake2b(repr(config).encode(), digest_size=8).hexdigest()


def _pool_sig(pool: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(pool, dtype=np.int64),
                           digest_size=8).hexdigest()


def _cell_key(d: str, t: str) -> str:
    return f"{d}→{t}"


def _safe(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", str(name))


def _auto_n_perm(labels, with_data: bool) -> int:
    # module_preservation's Bonferroni rule, per cell
    n_stats_eff = 7 if with_data else 3
    return max(1000, pv.required_perms(0.05,
                                       n_tests=len(labels) * n_stats_eff))


def _result_from_pack(res: dict, d: str, t: str) -> PreservationResult:
    """A ``run_pack`` result dict as the solo call's result (no null kept:
    the grid stores counts)."""
    n_used = res.get("n_perm_used")
    return PreservationResult(
        n_perm_used=None if n_used is None else np.asarray(n_used),
        p_type=str(res["p_type"]),
        discovery=d,
        test=t,
        module_labels=[str(lab) for lab in res["module_labels"]],
        observed=np.asarray(res["observed"]),
        nulls=None,
        counts_hi=np.asarray(res["counts_hi"]),
        counts_lo=np.asarray(res["counts_lo"]),
        counts_eff=np.asarray(res["counts_eff"]),
        p_values=np.asarray(res["p_values"]),
        n_vars_present=np.asarray(res["n_vars_present"]),
        prop_vars_present=np.asarray(res["prop_vars_present"]),
        total_size=np.asarray(res["total_size"]),
        alternative=str(res["alternative"]),
        n_perm=int(res["n_perm"]),
        completed=int(res["completed"]),
        total_space=res["total_space"],
    )


def _cell_perms(res: PreservationResult) -> int:
    """Fresh permutation work of one cell: per-module counts when
    adaptive, completed × modules when fixed."""
    if res.n_perm_used is not None:
        return int(np.asarray(res.n_perm_used, dtype=np.int64).sum())
    return int(res.completed) * len(res.module_labels)


def _priors_from(prev: PreservationResult, labels) -> tuple | None:
    """Warm-start tallies from a prior run of the cell; None when they
    cannot seed this run (module set changed, fixed-n prior, no counts)."""
    if prev.p_type != "sequential" or prev.n_perm_used is None:
        return None
    if prev.counts_hi is None or prev.counts_lo is None:
        return None
    if [str(lab) for lab in prev.module_labels] != [str(lab)
                                                     for lab in labels]:
        return None
    return (np.asarray(prev.counts_hi, dtype=np.int64),
            np.asarray(prev.counts_lo, dtype=np.int64),
            np.asarray(prev.n_perm_used, dtype=np.int64))


def _load_manifest(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    if m.get("version") != _MANIFEST_VERSION:
        return None
    return m


def _write_manifest(path: str, manifest: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _columns(network, datasets, module_assignments) -> set | None:
    """The grid's test sides (its columns) from the inputs' names alone,
    for ``build_datasets``' ``on_device``: a row whose dataset is no
    column keeps its host source. None (every dataset narrowed) where the
    checks after the input phase raise anyway."""
    if not isinstance(module_assignments, dict):
        return None
    names = (list(ds._normalize_collection(network)) if datasets is None
             else [str(n) for n in datasets])
    rows = [n for n in names if n in module_assignments]
    return {t for d in rows for t in names if t != d}


def grid_preservation(
    network=None,
    data=None,
    correlation=None,
    module_assignments=None,
    modules=None,
    background_label: str = "0",
    datasets=None,
    n_perm: int | None = None,
    null: str = "overlap",
    alternative: str = "greater",
    seed: int = 0,
    config: EngineConfig | None = None,
    adaptive: bool = False,
    adaptive_rule=None,
    grid_dir: str | None = None,
    fleet=None,
    fleet_tenant: str = "grid",
    telemetry=None,
    verbose: bool = False,
    checkpoint_every: int = 8192,
    device=None,
) -> GridResult:
    """Run the all-pairs preservation grid (module docstring).

    Inputs follow ``module_preservation``'s dict-keyed surface:
    ``network`` / ``correlation`` / ``data`` map dataset names to
    matrices, and ``module_assignments`` maps each DISCOVERY dataset's
    name to its node→module mapping. Every assigned dataset is a grid row,
    every dataset a column, and the cells are the ordered pairs (row,
    column) with row ≠ column; ``datasets`` narrows the grid to a subset
    of names.

    - ``grid_dir`` — the digest-keyed manifest, one
      ``cell_<d>__<t>.npz`` per finished cell and ``ckpt/`` pack
      checkpoints. The same call into the same directory resumes: cells
      whose dataset digests and parameters still match load with zero
      permutations; a changed dataset recomputes its row and column, and
      with ``adaptive=True`` each of those cells' monitor is seeded with
      the stored run's tallies.
    - ``adaptive`` / ``adaptive_rule`` / ``n_perm`` / ``null`` /
      ``alternative`` / ``seed`` / ``config`` — per cell, as the solo
      call reads them (every cell shares the seed).
    - ``telemetry`` — as in ``module_preservation``; the grid adds
      ``grid_start``/``grid_end``, ``grid_cell_start``/``grid_cell_done``,
      ``grid_dedup_hit`` and ``grid_warmstart_seeded`` events
      (:func:`~netrep_tpu_torch.utils.telemetry.grid_summary`).
    - ``device`` — None means ``"cuda"`` (raises without a card); pass
      ``"cpu"`` to run the kernels' plain versions on the CPU.
    - ``fleet`` — a :class:`~netrep_tpu_torch.serve.fleet.
      FleetCoordinator` (e.g. :func:`~netrep_tpu_torch.serve.fleet.
      build_inprocess_fleet`): cells route to replicas by the
      content-digest hash ring instead of running here, each as one
      request of tenant ``fleet_tenant``. The replicas' ``ServeConfig``
      must carry the same ``EngineConfig`` (and ``null``) for the cells to
      equal the local grid's. Manifest reuse still applies; warm-start
      priors and the cross-cell observed cache are local features.
    """
    if null not in ("overlap", "all"):
        raise ValueError(f"null must be 'overlap' or 'all', got {null!r}")
    if alternative not in ("greater", "less", "two.sided"):
        raise ValueError(
            "alternative must be one of 'greater', 'less', 'two.sided', "
            f"got {alternative!r}"
        )
    config = config or EngineConfig()
    if config.network_from_correlation is not None:
        raise ValueError(
            "grid_preservation v1 runs on materialized matrices; "
            "data-only (derived-network) grids run cell-by-cell via "
            "module_preservation"
        )
    dev = resolve_device(device)
    # the null precision pinned once, as module_preservation pins it
    config = dataclasses.replace(
        config, null_precision=config.resolved_null_precision(dev.type))
    t_in = time.perf_counter()
    built = ds.build_datasets(
        network, data=data, correlation=correlation, device=dev,
        on_device=_columns(network, datasets, module_assignments))
    _sync(dev)
    profile = {"input_s": time.perf_counter() - t_in, "packs": []}
    names = list(built) if datasets is None else [str(n) for n in datasets]
    for n in names:
        if n not in built:
            raise ValueError(f"datasets names unknown dataset {n!r}")
    if not isinstance(module_assignments, dict) or not module_assignments:
        raise ValueError(
            "grid_preservation needs module_assignments as a dict keyed "
            "by discovery dataset name (each value the node→module "
            "mapping)"
        )
    rows = [n for n in names if n in module_assignments]
    if not rows:
        raise ValueError(
            "no grid dataset carries module assignments; nothing to test"
        )
    assign = ds.normalize_module_assignments(
        {k: module_assignments[k] for k in rows}, built, rows)
    cells = [(d, t) for d in rows for t in names if t != d]
    if not cells:
        raise ValueError("the grid needs at least two datasets")

    # the user's inputs digested as the JAX package digests its float64
    # datasets
    sources = ds.input_sources(network, data, correlation)
    digests = {
        n: ckpt.content_digest([sources[n][f] for f in ds.FIELDS],
                               dtype="float64")
        for n in names
    }
    params = {
        "null": null, "alternative": alternative, "seed": int(seed),
        "adaptive": bool(adaptive), "cfg": _cfg_id(config),
        "n_perm": None if n_perm is None else int(n_perm),
        "rule": repr(adaptive_rule) if adaptive_rule is not None else None,
    }

    manifest_path = manifest = None
    prior_cells: dict[str, dict] = {}
    if grid_dir is not None:
        os.makedirs(os.path.join(grid_dir, "ckpt"), exist_ok=True)
        manifest_path = os.path.join(grid_dir, MANIFEST_NAME)
        manifest = _load_manifest(manifest_path)
        if manifest is not None and manifest.get("params") == params:
            prior_cells = dict(manifest.get("cells", {}))
        manifest = {"version": _MANIFEST_VERSION, "params": params,
                    "datasets": dict(digests), "cells": {}}

    tel, tel_owned = tm.resolve_arg(telemetry)
    with contextlib.ExitStack() as stack:
        grid_sid = None
        if tel is not None:
            if tel_owned:
                stack.callback(tel.close)
            stack.enter_context(tel.activate())
            grid_sid = tel.begin_span(
                "grid_start", datasets=len(names), rows=len(rows),
                cells=len(cells), adaptive=bool(adaptive),
                fleet=fleet is not None,
                resumable=grid_dir is not None)
        t0 = time.perf_counter()
        cache = ObservedCache()
        stats = {"cells_total": len(cells), "cells_computed": 0,
                 "cells_reused": 0, "cells_warmstarted": 0,
                 "perms_evaluated": 0, "packs": 0}
        results = _run_grid(
            built, names, rows, cells, assign, modules, background_label,
            null, alternative, n_perm, seed, config, adaptive, adaptive_rule,
            grid_dir, manifest, prior_cells, digests, tel, cache, stats,
            verbose, checkpoint_every, dev, profile["packs"], fleet,
            fleet_tenant, sources)
        if manifest_path is not None:
            _write_manifest(manifest_path, manifest)
        stats["dedup"] = cache.stats()
        stats["wall_s"] = time.perf_counter() - t0
        if tel is not None:
            tel.end_span(grid_sid, "grid_end",
                         cells_computed=stats["cells_computed"],
                         cells_reused=stats["cells_reused"],
                         cells_warmstarted=stats["cells_warmstarted"],
                         perms_evaluated=stats["perms_evaluated"],
                         s=stats["wall_s"])
        return GridResult(results=results, stats=stats,
                          manifest_path=manifest_path, profile=profile)


def _run_grid(built, names, rows, cells, assign, modules, background_label,
              null, alternative, n_perm, seed, config, adaptive,
              adaptive_rule, grid_dir, manifest, prior_cells, digests, tel,
              cache, stats, verbose, checkpoint_every, dev, pack_times,
              fleet, fleet_tenant, sources):
    """The grid's body: every cell's plan, the cells the manifest still
    holds, then the rest column-packed (or fleet-routed), each result
    saved as it lands."""
    from ..serve.packer import (
        GridPackedEngine, RequestPlan, assign_bases, run_pack,
    )

    def cell_path(d, t):
        if grid_dir is None:
            return None
        return os.path.join(grid_dir, f"cell_{_safe(d)}__{_safe(t)}.npz")

    plans: dict[tuple[str, str], dict] = {}
    for d, t in cells:
        labels, specs, counts, pool = _overlap_setup(
            built[d], built[t], assign[d], modules, background_label, null)
        with_data = built[d].data is not None and built[t].data is not None
        plans[(d, t)] = {
            "labels": labels, "specs": specs, "counts": counts,
            "pool": pool, "with_data": with_data,
            "n_perm": (int(n_perm) if n_perm is not None
                       else _auto_n_perm(labels, with_data)),
        }

    # -- manifest reuse and warm-start priors ------------------------------
    results: dict[str, dict] = {d: {} for d in rows}
    todo: list[tuple[str, str]] = []
    priors: dict[tuple[str, str], tuple] = {}
    for d, t in cells:
        key = _cell_key(d, t)
        ent = prior_cells.get(key)
        path = cell_path(d, t)
        fresh = (
            ent is not None and path is not None
            and ent.get("disc_digest") == digests[d]
            and ent.get("test_digest") == digests[t]
            and int(ent.get("n_perm", -1)) == plans[(d, t)]["n_perm"]
            and os.path.exists(ent.get("path") or path)
        )
        if fresh:
            try:
                res = PreservationResult.load(ent.get("path") or path)
            except (OSError, ValueError):
                fresh = False
            else:
                results[d][t] = res
                stats["cells_reused"] += 1
                manifest["cells"][key] = dict(ent)
                if tel is not None:
                    tel.emit("grid_cell_done", discovery=str(d),
                             test=str(t), source="manifest", perms=0)
        if not fresh:
            todo.append((d, t))
            if adaptive and ent is not None:
                stored = ent.get("path") or path
                if stored and os.path.exists(stored):
                    try:
                        prev = PreservationResult.load(stored)
                    except (OSError, ValueError):
                        prev = None
                    p = (None if prev is None
                         else _priors_from(prev, plans[(d, t)]["labels"]))
                    if p is not None:
                        priors[(d, t)] = p

    def finish_cell(d, t, res: PreservationResult):
        results[d][t] = res
        stats["cells_computed"] += 1
        perms = _cell_perms(res)
        stats["perms_evaluated"] += perms
        path = cell_path(d, t)
        if path is not None:
            res.save(path)
            manifest["cells"][_cell_key(d, t)] = {
                "discovery": str(d), "test": str(t),
                "disc_digest": digests[d], "test_digest": digests[t],
                "n_perm": int(plans[(d, t)]["n_perm"]),
                "completed": int(res.completed),
                "p_type": res.p_type, "path": path,
                "warmstarted": (d, t) in priors,
            }
        if tel is not None:
            tel.emit("grid_cell_done", discovery=str(d), test=str(t),
                     source="computed", perms=int(perms),
                     warmstarted=(d, t) in priors)

    if fleet is not None:
        if todo:
            _run_fleet(fleet, fleet_tenant, sources, assign, todo, plans,
                       alternative, seed, adaptive, adaptive_rule, tel,
                       finish_cell, verbose)
        return results

    # -- column packs: (test, pool signature, data presence) --------------
    groups: dict[tuple, list[tuple[str, str]]] = {}
    for t in names:
        for d, tt in todo:
            if tt == t:
                p = plans[(d, t)]
                groups.setdefault((t, _pool_sig(p["pool"]), p["with_data"]),
                                  []).append((d, t))

    def fields(with_data):
        return {"correlation", "network"} | ({"data"} if with_data
                                             else set())

    order = list(groups.items())
    for gi, ((t, _psig, with_data), members) in enumerate(order):
        # what the later packs read: their tests and their sources
        later: dict[str, set] = {}
        for (t2, _s2, wd2), mem2 in order[gi + 1:]:
            for name in [t2] + [d for d, _ in mem2]:
                later.setdefault(name, set()).update(fields(wd2))
        req_plans = [
            RequestPlan(
                labels=plans[(d, t)]["labels"], specs=plans[(d, t)]["specs"],
                counts=plans[(d, t)]["counts"], pool=plans[(d, t)]["pool"],
                n_perm=plans[(d, t)]["n_perm"], seed=int(seed),
                alternative=alternative, adaptive=bool(adaptive),
                rule=adaptive_rule, priors=priors.get((d, t)))
            for d, _t in members
        ]
        assign_bases(req_plans)
        t0 = time.perf_counter()
        now = {n: set(f) for n, f in later.items()}
        for n in [t] + [d for d, _ in members]:
            now.setdefault(n, set()).update(fields(with_data))
        ds.place(built, now, {}, dev)
        srcs = [(built[d].correlation, built[d].network,
                 built[d].data if with_data else None) for d, _ in members]
        tds = built[t]
        engine = GridPackedEngine(
            srcs, tds.correlation, tds.network,
            tds.data if with_data else None,
            [p.specs for p in req_plans], req_plans[0].pool,
            config=config, device=dev, observed_cache=cache)
        del srcs, tds
        # the engine holds what its null reads; the datasets keep what a
        # later pack reads and let go of the rest
        ds.place(built, later, {}, dev)
        _sync(dev)
        t1 = time.perf_counter()
        ck = None
        if grid_dir is not None:
            h = hashlib.blake2b(digest_size=8)
            for (d, _t), p in zip(members, req_plans):
                h.update(f"{d}|{t}|{p.seed}|{p.n_perm}|".encode())
                h.update(p.signature().encode())
            ck = os.path.join(grid_dir, "ckpt",
                              f"pack_{_safe(t)}_{h.hexdigest()}.npz")
        if verbose:
            logger.info("grid column %r: %d cell(s) packed (%s)", t,
                        len(members), ", ".join(d for d, _ in members))
        for d, _t in members:
            if tel is not None:
                tel.emit("grid_cell_start", discovery=str(d), test=str(t),
                         pack_size=len(members),
                         n_modules=len(plans[(d, t)]["labels"]),
                         warmstarted=(d, t) in priors)
            if (d, t) in priors:
                stats["cells_warmstarted"] += 1
                if tel is not None:
                    tel.emit("grid_warmstart_seeded", discovery=str(d),
                             test=str(t),
                             prior_perms=int(priors[(d, t)][2].sum()))
        stats["packs"] += 1
        pack_res = run_pack(engine, req_plans, telemetry=tel,
                            checkpoint_path=ck,
                            checkpoint_every=checkpoint_every)
        engine.release()
        del engine
        _sync(dev)
        pack_times.append({"column": str(t), "cells": len(members),
                           "engine_s": t1 - t0,
                           "run_s": time.perf_counter() - t1})
        if not all(r["finished"] for r in pack_res):
            # Ctrl-C ends the grid, as it ends module_preservation: the
            # pack's cells stay out of the results and the manifest, and
            # its checkpoint stays for the same call to resume
            logger.warning(
                "grid interrupted in column %r; its cells resume from the "
                "pack checkpoint%s", t,
                "" if ck is not None else " (none: no grid_dir)")
            break
        if ck is not None:
            # the pack finished: its chunk checkpoint is spent
            with contextlib.suppress(OSError):
                os.unlink(ck)
        for (d, _t), res in zip(members, pack_res):
            finish_cell(d, t, _result_from_pack(res, d, t))
    return results


def _run_fleet(fleet, tenant, sources, assign, todo, plans, alternative,
               seed, adaptive, adaptive_rule, tel, finish_cell, verbose):
    """Fleet-spread execution: register every grid dataset once (the
    coordinator broadcasts and records the content digests it routes on),
    then route each cell to the replica the hash ring places it on. The
    registrations are the user's inputs as the grid digested them, so a
    replica's digest is the grid's (and the JAX package's); cells sharing
    a replica and a test dataset may pack there."""
    needed = sorted({d for d, _ in todo} | {t for _, t in todo})
    for n in needed:
        fleet.register_dataset(
            tenant, n, network=sources[n]["network"],
            correlation=sources[n]["correlation"],
            data=sources[n]["data"], assignments=assign.get(n),
        )
    for d, t in todo:
        if tel is not None:
            tel.emit("grid_cell_start", discovery=str(d), test=str(t),
                     pack_size=1, fleet=True,
                     n_modules=len(plans[(d, t)]["labels"]))
        if verbose:
            rep = fleet.route(tenant, d, t)
            logger.info("grid cell %r→%r routed to replica %s", d, t,
                        getattr(rep, "rid", "?"))
        res = fleet.analyze(
            tenant, d, t, n_perm=plans[(d, t)]["n_perm"], seed=int(seed),
            alternative=alternative, adaptive=bool(adaptive),
            rule=adaptive_rule,
        )
        finish_cell(d, t, _result_from_pack(res, d, t))
