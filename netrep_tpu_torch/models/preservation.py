"""``module_preservation`` — the port's main entry point: validate inputs,
loop over (discovery, test) dataset pairs, run the permutation engine, and
turn its null into exact Phipson–Smyth p-values and result objects.

The port of the dense path of ``netrep_tpu/models/preservation.py``, with
the same argument names and defaults and the same seeding contract (same
seed ⇒ the same permutations, counts and p-values as the JAX package). Runs
on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np
import torch

from ..ops import pvalues as pv
from ..parallel.engine import ModuleSpec, PermutationEngine
from ..utils.config import EngineConfig, resolve_device
from . import dataset as ds
from .results import PreservationResult, shape_results

logger = logging.getLogger("netrep_tpu_torch")

#: arguments of the JAX entry point that belong to later slices of the
#: port, with the ROADMAP.md Queue 1 item that brings each
_LATER = {
    "adaptive": (False, "item 8 (adaptive nulls)"),
    "mesh": (None, "item 14 (mesh and sharding)"),
    "vmap_tests": (False, "item 10 (multi-test engine / vmap_tests)"),
    "checkpoint_dir": (None, "item 7 (checkpoint/resume)"),
    "telemetry": (None, "item 16 (device-touching utils and CLI)"),
    "fault_policy": (None, "item 16 (device-touching utils and CLI)"),
    "data_only": (None, "item 12 (data-only atlas plane)"),
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
                 np_this, alternative, total_space, profile=None, stream=None):
    hi = lo = eff = None
    if stream is not None:
        # streaming run: exact Phipson–Smyth from the device-tallied
        # exceedance counts — identical to the materialized p-values
        p_values = pv.counts_pvalues(
            observed, stream.hi, stream.lo, stream.eff, alternative,
            total_nperm=total_space,
        )
        hi, lo, eff = stream.hi, stream.lo, stream.eff
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
    )


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
      superchunk (streaming).

    ``result.profile`` holds the seconds of each phase: ``input_s`` (input
    checks, shared by every pair), ``engine_s``, ``observed_s``, ``null_s``
    and ``perms_per_s``.

    ``adaptive``, ``mesh``, ``vmap_tests``, ``checkpoint_dir``,
    ``telemetry``, ``fault_policy``, ``data_only`` and ``backend='native'``
    belong to later slices and raise ``NotImplementedError``.

    Returns ``{discovery: {test: PreservationResult}}``, collapsed by
    ``simplify``.
    """
    given = dict(adaptive=adaptive, mesh=mesh, vmap_tests=vmap_tests,
                 checkpoint_dir=checkpoint_dir, telemetry=telemetry,
                 fault_policy=fault_policy, data_only=data_only)
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
    dev = resolve_device(device)
    config = config or EngineConfig()

    t0 = time.perf_counter()
    datasets = ds.build_datasets(network, data=data, correlation=correlation,
                                 device=dev)
    input_s = time.perf_counter() - t0
    pairs = ds.resolve_pairs(datasets, discovery, test, self_preservation)
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

    results: dict[str, dict[str, PreservationResult]] = {}
    for d_name, t_name in pairs:
        disc_ds, test_ds = datasets[d_name], datasets[t_name]
        labels, mod_specs, counts, pool = _overlap_setup(
            disc_ds, test_ds, assign[d_name], modules, background_label, null
        )
        with_data = disc_ds.data is not None and test_ds.data is not None
        np_this = n_perm if n_perm is not None else auto_n_perm(labels,
                                                                with_data)
        t1 = time.perf_counter()
        engine = PermutationEngine(
            disc_ds.correlation, disc_ds.network, disc_ds.data,
            test_ds.correlation, test_ds.network, test_ds.data,
            mod_specs, pool, config=config, device=dev,
        )
        _sync(dev)
        t2 = time.perf_counter()
        observed = engine.observed()
        t3 = time.perf_counter()
        if store_nulls:
            nulls, completed = engine.run_null(np_this, key=seed,
                                               progress=progress)
            stream = None
        else:
            stream = engine.run_null_streaming(np_this, observed, key=seed,
                                               progress=progress)
            nulls, completed = None, stream.completed
        t4 = time.perf_counter()
        profile = dict(
            input_s=input_s, engine_s=t2 - t1, observed_s=t3 - t2,
            null_s=t4 - t3, perms_per_s=completed / max(t4 - t3, 1e-12),
        )
        total_space = pv.total_permutations(pool.size,
                                            [m.size for m in mod_specs])
        results.setdefault(d_name, {})[t_name] = _make_result(
            d_name, t_name, labels, counts, observed, nulls, completed,
            np_this, alternative, total_space, profile=profile, stream=stream,
        )
    return shape_results(results, simplify)
