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
it, the test data, in ``config.dtype`` (bfloat16 halves them; the engine
narrows them from the float32 datasets, which then let go) — and no
discovery matrix; a matrix a later pair needs waits in pinned host memory
as float32.

``config.null_precision`` is pinned once per analysis, as in the JAX
package: ``'auto'`` gives ``'f32'`` on the card and the CPU, and an
explicit ``'bf16_rescue'`` runs the screened null
(:mod:`netrep_tpu_torch.parallel.screened`, ``stat_mode='xla'``), whose
results carry ``nulls_exact=False`` when they store the null.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import re
import shutil
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from ..ops import pvalues as pv
from ..ops import stats as tstats
from ..parallel import distributed
from ..parallel import mesh as tmesh
from ..parallel.engine import (
    ModuleSpec, PermutationEngine, build_discovery, check_derived_network,
)
from ..parallel.multitest import MultiTestEngine
from ..utils import backend as be
from ..utils import checkpoint as ckpt
from ..utils import faults as flt
from ..utils import telemetry as tm
from ..utils.config import EngineConfig
from ..utils.profiling import (
    PairTimer, device_trace, null_annotation, resolve_profile_dir,
)
from ..utils.progress import resolve_progress
from . import dataset as ds
from .results import PreservationResult, shape_results

logger = logging.getLogger("netrep_tpu_torch")


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
                 p_type="fixed", nulls_exact=True):
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
        nulls_exact=nulls_exact,
    )


def _nulls_exact(engine, observed, nulls) -> bool:
    """Whether a pair's stored null holds exact float32 values: False after
    the screened null, whose decided rows keep bf16-rounded values (its
    counts and p-values are exact all the same), so that the GPD tail fit
    refuses it. A streaming run stores no values: True."""
    if nulls is None:
        return True
    resolve = getattr(engine, "_resolve_null_precision", None)
    return resolve is None or resolve(observed) != "bf16_rescue"


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
      run one after another, with a warning. With a ``mesh`` every cohort
      is split over it as a single test would be, on the shared draw
      (row-sharded: the composed statistics, ``stat_mode='fused'``
      raises);
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
    ``perms_per_s`` (shared by the pairs of one multi-test run); after a
    screened null also ``rescue`` (``total``, ``rescued``, ``dispatches``,
    ``fraction``: the permutations screened and re-run in float32).

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

    - ``profile`` — ``True`` captures a ``torch.profiler`` trace (CPU and
      CUDA activity) of the run into ``./netrep_profile``, a string names
      the directory (:mod:`netrep_tpu_torch.utils.profiling`; the null is
      marked with the ``netrep_null`` annotation, so
      ``trace_time_split(dir, NULL_SPAN)`` gives its device busy and idle
      share); either also adds per-pair timings to ``result.profile``
      (``trace_dir``, ``chunk_ms``, ``compile_chunk_ms`` — the first
      chunk, the kernels' build or load included —, ``steady_chunk_ms``,
      ``perms_per_sec``).
    - ``telemetry`` — ``True`` appends structured events (run, pair and
      observed spans, per-chunk and per-superchunk dispatch and transfer
      counters, checkpoint saves and resumes, adaptive retirements, every
      fault-ladder decision, stall-watchdog alerts) to
      ``./netrep_telemetry.jsonl``; a string names the JSONL path; a
      :class:`~netrep_tpu_torch.utils.telemetry.Telemetry` is used as it
      is. The bus is ambient while the call runs, a stall watchdog is
      armed per null run, and ``result.profile`` gains ``telemetry`` and
      ``telemetry_run`` pointers. Read the file back with
      :func:`~netrep_tpu_torch.utils.telemetry.aggregate_file`. The JAX
      package's event schema, so either package's reader reads it.
    - ``fault_policy`` — ``True`` or a
      :class:`~netrep_tpu_torch.utils.config.FaultPolicy` runs every null
      chunk under the fault ladder (:mod:`netrep_tpu_torch.utils.faults`):
      transient failures re-dispatch with backoff (exact: chunk *i* draws
      the same keys), hung dispatches are abandoned after an emergency
      checkpoint, and a device loss shrinks the mesh onto the survivors
      (growing back when capacity returns). With no survivor the
      device-loss error is raised after the failure-save, unless the
      caller asked for the final CPU rung with ``FaultPolicy(
      degrade_to_cpu=True)``: the engine is then rebuilt with
      ``device="cpu"`` from the host inputs and the null resumes from the
      checkpoint — announced by a warning, a ``degraded_to_cpu`` event and
      ``result.profile["degraded"]`` (``reason``, ``at_perm``, ``freed``);
      the rest of the analysis then runs on the CPU, since the card is
      gone. Transient retries or hang abandonments run out raise after
      the failure-save; they never take the CPU rung. Saves ride a
      background writer; without a ``checkpoint_dir`` a run-scoped
      temporary directory holds them and is removed when the call ends. A
      plan (``FaultPolicy(plan=...)`` or the ``NETREP_FAULT_PLAN``
      environment variable, which also turns on a default policy, one
      without the CPU rung) injects faults. With a policy each chunk waits
      for its kernels inside the retry scope; ``None`` (the default)
      leaves the loops as they are.

    - ``backend`` — ``'torch'`` (the default: the engines above, on
      ``device``) or ``'native'``: the threaded C++ host tier
      (:mod:`netrep_tpu_torch.native`), the JAX package's
      ``backend='native'`` — the same nulls, counts and p-values as that
      tier for the same seed, bit for bit. It runs on the host and needs
      no card: ``device`` must be None or ``"cpu"`` (a CUDA device raises
      ``ValueError``), the inputs are checked on the CPU and held as
      float64 host arrays (a float64 C-contiguous input is adopted without
      a copy), and it refuses ``adaptive=True``, ``store_nulls=False`` and
      ``data_only`` with the JAX package's texts; ``mesh`` is ignored and
      ``vmap_tests`` runs the pairs one by one, as there.
    - ``n_threads`` — the native tier's thread count (None: every core);
      accepted and ignored by ``backend='torch'``, as the JAX package
      ignores it on its default backend.

    Returns ``{discovery: {test: PreservationResult}}``, collapsed by
    ``simplify``.
    """
    if null not in ("overlap", "all"):
        raise ValueError(f"null must be 'overlap' or 'all', got {null!r}")
    if alternative not in ("greater", "less", "two.sided"):
        raise ValueError(
            "alternative must be one of 'greater', 'less', 'two.sided', "
            f"got {alternative!r}"
        )
    if backend not in ("torch", "native"):
        raise ValueError(
            f"backend must be 'torch' or 'native', got {backend!r}")
    native = backend == "native"
    if adaptive and native:
        raise ValueError(
            "adaptive=True requires backend='torch' (the native C++ tier has "
            "no retirement re-bucketing); run it fixed-n or switch backends"
        )
    if not store_nulls and native:
        raise ValueError(
            "store_nulls=False requires backend='torch' (the streaming "
            "tallies are folded on device inside the scan-fused dispatch); "
            "run the native backend with store_nulls=True"
        )
    if data_only is not None:
        config = _data_only_config(network, data, correlation, data_only,
                                   config, backend)
    if native:
        # the host tier the caller asked for by name: no card, no mesh
        dev, mesh = _native_device(device), None
    else:
        dev = tmesh.resolve_device(mesh, device)
    config = config or EngineConfig()
    # pin the null precision once for the whole analysis, as the JAX
    # package does; 'auto' gives the screen only on a TPU, so here it is
    # 'f32' on either device, and an explicit 'bf16_rescue' stays
    config = dataclasses.replace(
        config, null_precision=config.resolved_null_precision(dev.type))
    ft = flt.resolve_runtime(fault_policy)

    t0 = time.perf_counter()
    datasets = (
        ds.build_data_only_datasets(data, device=dev)
        if data_only is not None
        else ds.build_datasets(
            network, data=data, correlation=correlation, device=dev,
            host64=native,
            # a dataset no pair reads as a test side keeps its host source
            on_device=ds.tested_names(network, discovery, test,
                                      self_preservation))
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
        if native or not store_nulls:
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
    # the checkpoint identity samples the inputs as the user gave them; the
    # fault ladder rebuilds its engines from them
    sources = (None if checkpoint_dir is None and ft is None
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

    trace_dir = resolve_profile_dir(profile)
    tel, tel_owned = tm.resolve_arg(telemetry)
    with contextlib.ExitStack() as stack:
        if ft is not None and checkpoint_dir is None:
            # the failure-saves and the ladder's resumes need checkpoints
            # even when the caller asked for none: a run-scoped directory,
            # removed when the call ends
            checkpoint_dir = tempfile.mkdtemp(prefix="netrep_ckpt_")
            stack.callback(shutil.rmtree, checkpoint_dir, ignore_errors=True)
        stack.enter_context(device_trace(trace_dir))
        run_sid = None
        if tel is not None:
            if tel_owned:
                stack.callback(tel.close)
            # ambient for every layer below (loops, checkpoints and
            # backend); the run span is the root of the trace tree
            stack.enter_context(tel.activate())
            run_sid = tel.begin_span(
                "run_start", pairs=len(pairs), null=null,
                alternative=alternative, adaptive=bool(adaptive),
                store_nulls=bool(store_nulls), backend=backend,
                seed=int(seed), fault_policy=ft is not None)
        results = _run_groups(
            by_disc, datasets, assign, modules, background_label, null,
            alternative, n_perm, auto_n_perm, config, mesh, vmap_tests,
            data_only, dev, seed, progress, verbose, store_nulls, adaptive,
            adaptive_rule, adaptive_priors, checkpoint_dir,
            checkpoint_every, sources, input_s, tel, ft, trace_dir,
            native, n_threads)
        if tel is not None:
            tel.end_span(run_sid, "run_end",
                         pairs_done=sum(len(v) for v in results.values()))
        return shape_results(results, simplify)


def _run_groups(by_disc, datasets, assign, modules, background_label, null,
                alternative, n_perm, auto_n_perm, config, mesh, vmap_tests,
                data_only, dev, seed, progress, verbose, store_nulls,
                adaptive, adaptive_rule, adaptive_priors, checkpoint_dir,
                checkpoint_every, sources, input_s, tel, ft, trace_dir,
                native=False, n_threads=None):
    """The pair loop of :func:`module_preservation`: every group's
    discovery side first, then each group's engine, observed statistics
    and null (under the fault ladder when ``ft`` is set). Returns
    ``{discovery: {test: PreservationResult}}``.

    ``native`` runs each pair on the native tier (:class:`~netrep_tpu_torch.
    native.NativePermutationEngine`) with ``n_threads`` threads, from the
    host float64 datasets: no discovery side is built ahead, no matrix
    moves, and pairs never share an engine."""
    # every group's discovery side first, while every dataset is still
    # where the input checks left it (one multi-test engine for a group of
    # cohorts, or one engine a pair; a discovery-only dataset's blocks are
    # gathered on the host): after it no discovery matrix is read again
    plan = []
    for d_name, t_names in by_disc.items():
        disc_ds = datasets[d_name]
        can_vmap = (
            vmap_tests
            and not native
            and len(t_names) > 1
            # data-only pairs run one by one: the multi-test engine stacks
            # the cohorts' matrices, which data-only datasets do not hold
            and data_only is None
            and all(datasets[t].node_names == datasets[t_names[0]].node_names
                    for t in t_names)
            and len({datasets[t].data is not None for t in t_names}) == 1
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
            buckets = None if native else build_discovery(
                disc_ds.correlation, disc_ds.network,
                disc_ds.data if with_data else None, setup[1], setup[3],
                config, dev, mesh,
            )
            _sync(dev)
            fields = {"correlation", "network"} | ({"data"} if with_data
                                                    else set())
            plan.append(_Group(
                d_name, group, with_data, setup, buckets, fields,
                time.perf_counter() - t1,
                _identity(sources, d_name, group, with_data),
                # the ladder's rebuilds read the discovery side from the
                # host: a lost card's copy is gone
                None if ft is None or native else _host_buckets(buckets)))
    results: dict[str, dict[str, PreservationResult]] = {}
    #: the ladder's CPU rung, once taken: the rest of the analysis runs
    #: on the CPU, and every later result carries the same mark
    on_cpu = None
    for gi, g in enumerate(plan):
        d_name, group = g.d_name, g.group
        labels, mod_specs, counts, pool = g.setup
        later: dict[str, set] = {}
        for h in plan[gi + 1:]:
            for t in h.group:
                later.setdefault(t, set()).update(h.fields)
        multi = len(group) > 1
        np_this = n_perm if n_perm is not None else auto_n_perm(labels,
                                                                g.with_data)
        test_name = "+".join(map(str, group))
        t_pair0 = t1 = time.perf_counter()
        pair_sid = None
        if tel is not None:
            pair_sid = tel.begin_span(
                "pair_start", discovery=str(d_name), test=test_name,
                vmapped=multi, n_modules=len(labels), n_perm=int(np_this))

        def build_engine(m, at_dev, g=g, multi=multi):
            """The group's engine over mesh ``m`` on ``at_dev`` from the
            host inputs and the host copy of the discovery side — the
            ladder's rebuild (the native tier's from its host datasets)."""
            if native:
                return _native_engine(datasets, g, config, n_threads)
            cfg = config
            if m is None and cfg.matrix_sharding == "row":
                cfg = dataclasses.replace(cfg, matrix_sharding="replicated")
            tests = [sources[t] for t in g.group]
            if at_dev.type == "cpu" and any(
                    isinstance(a, torch.Tensor) and a.is_cuda
                    for t in tests for a in t.values()):
                raise RuntimeError(
                    "the CPU rung rebuilds the engine from the inputs on the "
                    "host, but they were given as CUDA tensors")

            def dT(t):
                return t["data"].T if g.with_data else None

            parts = (g.setup[3], g.host_buckets, len(g.setup[1]), cfg,
                     at_dev)
            if multi:
                return MultiTestEngine.from_parts(
                    [t["correlation"] for t in tests],
                    [t["network"] for t in tests],
                    [dT(t) for t in tests] if g.with_data else None, *parts,
                    modules=g.setup[1], digest=g.digests[0],
                    test_digest=g.digests[1], mesh=m)
            return PermutationEngine.from_parts(
                tests[0]["correlation"], tests[0]["network"], dT(tests[0]),
                *parts, mesh=m, modules=g.setup[1], digest=g.digests[0])

        if native or on_cpu is not None:
            engine = build_engine(None, torch.device("cpu"))
        else:
            ds.place(datasets, {t: g.fields for t in group}, later, dev)
            tests = [datasets[t] for t in group]
            if (config.network_from_correlation is not None
                    and data_only is None):
                for i, t in enumerate(tests):
                    check_derived_network(t.correlation, t.network,
                                          config.network_from_correlation,
                                          f"test[{i}]" if multi else "test")
            parts = (pool, g.buckets, len(mod_specs), config, dev)
            if multi:
                engine = MultiTestEngine.from_parts(
                    [t.correlation for t in tests], [t.network for t in tests],
                    [t.data.T for t in tests] if g.with_data else None,
                    *parts, modules=mod_specs, digest=g.digests[0],
                    test_digest=g.digests[1], mesh=mesh,
                )
            else:
                engine = PermutationEngine.from_parts(
                    tests[0].correlation, tests[0].network,
                    tests[0].data.T if g.with_data else None, *parts,
                    mesh=mesh, modules=mod_specs, digest=g.digests[0],
                )
            del tests
            # the engine holds what its null reads; the datasets let go of
            # the rest (a matrix of a later group waits on the host)
            ds.place(datasets, {}, later, dev)
            _sync(dev)
        t2 = time.perf_counter()
        timer = PairTimer(trace_dir) if trace_dir is not None else None
        with (tel.span("observed", discovery=str(d_name), test=test_name,
                       n_modules=len(labels))
              if tel is not None else contextlib.nullcontext()):
            observed = engine.observed()
        t3 = time.perf_counter()
        if timer is not None:
            timer.observed_s = t3 - t2
        if verbose:
            logger.info(
                "discovery %r → test(s) %s: %d modules, %d permutations, "
                "null=%r", d_name, group, len(labels), np_this, null,
            )
        prog = resolve_progress(progress, verbose)
        if timer is not None:
            prog = timer.wrap_progress(prog)
        run = dict(key=seed, progress=prog,
                   checkpoint_path=_checkpoint_path(checkpoint_dir, d_name,
                                                    test_name),
                   checkpoint_every=checkpoint_every, fault_policy=ft)
        if adaptive:
            run.update(alternative=alternative, rule=adaptive_rule)
            if store_nulls and adaptive_priors is not None:
                run["priors"] = adaptive_priors

        def null_of(eng):
            """One null of the group on ``eng``: ``(nulls, stream,
            completed, finished)``."""
            if adaptive and store_nulls:
                nulls, completed, finished = eng.run_null_adaptive(
                    np_this, observed, **run)
                return nulls, None, completed, finished
            if adaptive:
                stream = eng.run_null_adaptive_streaming(np_this, observed,
                                                         **run)
                return None, stream, stream.completed, stream.finished
            if store_nulls:
                nulls, completed = eng.run_null(np_this, observed=observed,
                                                **run)
                return nulls, None, completed, completed >= np_this
            stream = eng.run_null_streaming(np_this, observed, **run)
            return None, stream, stream.completed, stream.completed >= np_this

        with null_annotation():
            (nulls, stream, completed, finished), engine, degraded = (
                _run_guarded(null_of, engine, build_engine, ft, mesh,
                             run["checkpoint_path"], d_name, test_name))
        on_cpu = degraded or on_cpu
        t4 = time.perf_counter()
        exact = _nulls_exact(engine, observed, nulls)
        rescue = getattr(engine, "last_rescue", None)
        del engine
        times = dict(
            input_s=input_s, engine_s=g.disc_s + t2 - t1, observed_s=t3 - t2,
            null_s=t4 - t3, perms_per_s=completed / max(t4 - t3, 1e-12),
        )
        if rescue is not None:
            times["rescue"] = dict(total=rescue.total,
                                   rescued=rescue.rescued,
                                   dispatches=rescue.dispatches,
                                   fraction=rescue.fraction())
        if timer is not None:
            for k, v in timer.finish_null(completed).items():
                times.setdefault(k, v)
        if on_cpu is not None:
            times["degraded"] = on_cpu
        if tel is not None and tel.path is not None:
            times.setdefault("telemetry", tel.path)
            times.setdefault("telemetry_run", tel.run_id)
        if tel is not None:
            tel.end_span(pair_sid, "pair_end", discovery=str(d_name),
                         test=test_name, s=time.perf_counter() - t_pair0,
                         completed=int(completed),
                         interrupted=not finished)
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
                nulls_exact=exact,
            )
        if not finished:
            # Ctrl-C ends the whole run; the pairs done so far return
            logger.warning(
                "interrupted after %d/%d permutations; p-values use the "
                "completed subset; stopping remaining pairs",
                completed, np_this,
            )
            break
    return results


@dataclasses.dataclass
class _Group:
    """One (discovery, test group) of the analysis: the overlap setup,
    the discovery buckets on the device (and on the host under a fault
    policy), the fields its tests read, the discovery side's seconds and
    the checkpoint digests."""

    d_name: str
    group: list
    with_data: bool
    setup: tuple
    buckets: list
    fields: set
    disc_s: float
    digests: tuple
    host_buckets: list | None


def _host_buckets(buckets) -> list[dict]:
    """The discovery buckets with their properties copied to the host."""
    return [dict(b, disc=tstats.DiscProps(*(a.cpu() for a in b["disc"])))
            for b in buckets]


def _run_guarded(null_of, engine, build_engine, ft, mesh, ck, d_name,
                 t_name):
    """``null_of(engine)`` under the elastic recovery ladder (the JAX
    package's ``run_pair_null_guarded``). Without a policy it is one call.
    On a device-loss-class failure — whose loop already failure-saved
    every completed permutation to ``ck`` — the ladder climbs down one
    rung at a time:

    1. *shrink*: survivors remain
       (:func:`~netrep_tpu_torch.utils.backend.enumerate_survivors`) —
       release the engine, rebuild it over a smaller mesh
       (:func:`~netrep_tpu_torch.parallel.mesh.shrink_mesh`) and resume;
    2. *grow back*: the loop raised :class:`~netrep_tpu_torch.utils.
       faults.CapacityRestoredError` at a chunk boundary — rebuild the
       original mesh and resume;
    3. *CPU*, the final rung, only under ``degrade_to_cpu=True`` and when
       no device survives (or the rebuild budget is spent): announce it,
       release the engine, rebuild it with ``device="cpu"`` from the host
       inputs and resume — no CUDA tensor is touched. Without it the
       device-loss error re-raises past the failure-save.

    Every resume equals the unfaulted run: keys depend only on (seed,
    index), the checkpoint fingerprint does not depend on the mesh, and
    the shared injector never re-fires a consumed fault.

    On a mesh that spans processes no rung rebuilds the mesh: nothing
    tells the other processes to rebuild with this one, and a rebuild
    starts with a collective they would not enter. The faulted rank
    raises :class:`~netrep_tpu_torch.utils.faults.CrossProcessRungError`
    (the rung it would take, its rank, process 0's checkpoint) after the
    loop's failure-save; its peers' next collective raises
    :class:`~netrep_tpu_torch.utils.faults.PeerLostError` and
    failure-saves too, and a fresh launch of every process resumes from
    process 0's checkpoint. A retry of a failure raised before the
    chunk's collective runs as in one process; an abandoned dispatch
    raises ``CrossProcessRungError`` (rung ``'abandon'``) from the loop
    (:meth:`~netrep_tpu_torch.utils.faults.FaultRuntime.run_dispatch`).
    Returns
    ``(null_of's result, the engine that produced it, degraded)`` with
    ``degraded`` None, or after the CPU rung ``{"reason", "at_perm",
    "freed"}``."""
    if ft is None:
        return null_of(engine), engine, None
    cur_mesh = mesh
    full_spec = tmesh.mesh_spec(mesh)

    def rebuild(new_mesh):
        nonlocal engine, cur_mesh
        # the superseded engine lets go of the card before the new one
        # allocates
        engine.release()
        engine = build_engine(new_mesh, engine.device if new_mesh is None
                              else new_mesh.devices[0, 0])
        cur_mesh = new_mesh
        ft.mesh_rebuilds += 1

    while True:
        try:
            return null_of(engine), engine, None
        except flt.CapacityRestoredError:
            have = set(cur_mesh.devices.flat) if cur_mesh is not None else set()
            restored = [d for d in full_spec[0] if d not in have]
            grown = tmesh.mesh_from_spec(full_spec)
            be.announce_mesh_grown(list(grown.devices.flat), restored,
                                   discovery=str(d_name), test=str(t_name))
            rebuild(grown)
            ft.mesh_shrunk = False
        except flt.DeviceLostError as e:
            reason = getattr(e, "reason", "device_lost")
            cause = e.__cause__ if e.__cause__ is not None else e
            survivors, lost = be.enumerate_survivors(cur_mesh, e)
            survivors = distributed.filter_addressable(survivors)
            shrink = (bool(survivors)
                      and ft.mesh_rebuilds < ft.policy.max_mesh_rebuilds)
            if cur_mesh is not None and cur_mesh.spans_processes:
                rung = ("shrink" if shrink else
                        "cpu" if ft.policy.degrade_to_cpu else "none")
                raise flt.CrossProcessRungError(
                    rung, distributed.process_index(),
                    distributed.process_count(), ck, cause) from e
            if ck is None:  # no checkpoint, nothing to resume from
                raise
            if shrink:
                be.announce_mesh_shrunk(
                    reason, survivors, lost, discovery=str(d_name),
                    test=str(t_name), error=type(cause).__name__)
                rebuild(tmesh.shrink_mesh(survivors, like=cur_mesh))
                ft.mesh_shrunk = True
                continue
            if not ft.policy.degrade_to_cpu:
                raise cause
            freed = lost or (list(cur_mesh.devices.flat)
                             if cur_mesh is not None else [engine.device])
            be.degrade_to_cpu(reason, discovery=str(d_name),
                              test=str(t_name), error=type(cause).__name__,
                              freed=be.device_inventory(freed))
            loaded = ckpt.load_null_checkpoint(ck)
            degraded = dict(
                reason=reason, freed=be.device_inventory(freed),
                at_perm=0 if loaded is None else int(loaded["completed"]))
            engine.release()
            engine = build_engine(None, torch.device("cpu"))
            # the fingerprint does not depend on the device; the scope is
            # the JAX package's belt (a key or seed mismatch still refuses)
            with ckpt.accept_degraded_fingerprint(reason):
                return null_of(engine), engine, degraded


def _native_device(device) -> torch.device:
    """The native tier's device: the host, for ``device`` None or
    ``"cpu"``; anything else raises ``ValueError`` (the tier runs no
    kernel, and the caller named it)."""
    if device is None or torch.device(device).type == "cpu":
        return torch.device("cpu")
    raise ValueError(
        "backend='native' is the threaded C++ host tier: device must be "
        f"None or 'cpu', got {device!r}; use backend='torch' on a card")


def _native_engine(datasets, g, config, n_threads):
    """Group ``g``'s :class:`~netrep_tpu_torch.native.
    NativePermutationEngine` from its host float64 datasets: the arrays
    the JAX package hands its native engine, in the same dtype."""
    from ..native import NativePermutationEngine

    d, t = datasets[g.d_name], datasets[g.group[0]]
    _labels, specs, _counts, pool = g.setup
    return NativePermutationEngine(
        d.correlation, d.network, d.data, t.correlation, t.network, t.data,
        specs, pool, config=config, n_threads=n_threads or 0)


def _data_only_config(network, data, correlation, data_only,
                      config: EngineConfig | None,
                      backend: str = "torch") -> EngineConfig:
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
    if backend != "torch":
        raise ValueError(
            "data_only requires backend='torch' (the native C++ tier "
            "slices materialized host matrices)"
        )
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
