"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``netrep_tpu_torch/csrc`` with nvcc
(one process per source, started together), holds each kernel against its
plain PyTorch version on the card and times both (and, where one PyTorch
call computes the same function, that call) at the main path's shapes,
and splits the fused-statistics kernel's time bucket by bucket
(``kernel_split``: full, ``n_iter=0``, ``tdT=None``). ``asymmetry`` holds
the fused kernel to its plain version on test matrices as asymmetric as
the datasets accept, in the tier that reads one triangle and the one that
reads whole rows. The gather kernel (every bucket of a chunk in one
launch) is held bit-equal to its plain version in each way it reads a row
(``gather_vs_plain``) and timed (``gather_times``: per chunk and matrix,
one launch and one launch per bucket, four row blocks written in place,
the ring's local part, the bound and the sector floor of a scattered
design, the staged/in-place crossover). ``ring_trace`` splits one chunk
of the ring path (local gather, ring steps, adds and fills, composed
statistics). ``input_phase`` runs the input checks alone on the main
path's host float64 inputs (each dataset alone and both together: seconds,
peak device memory against the float32 matrices returned, which it bounds
by 0.5 GiB more, and their checksums), and ``host_copies`` times the ways
one host matrix can reach the card. Then it drives the
public entry point
``netrep_tpu_torch.models.preservation.module_preservation`` at the
north-star width — 20,000 genes, 50 planted modules of 30–200 nodes, 128
samples per dataset, 1,000 permutations — along each of its paths, every
launch count set to 0 just before a path and read just after:

- ``main_path``: the fused-statistics null, materialized and streaming;
- ``native``: ``backend='native'``, the threaded C++ host tier, on the
  same host inputs and seed with no device named — one thread on 16
  permutations, every core on 128 (``native_phase``): its observed
  statistics within ``tolerance_for('cuda')`` of the card's fused ones,
  the two nulls equal on their common prefix, and its rates beside the
  card's fused materialized rate, with the host's CPU model and cores;
- ``autotune`` (after ``native``): the measured autotune store
  (``autotune_phase``) on a fresh temporary store: the main path's fused
  streaming null at 4,096 permutations with an explicit superchunk of 1,
  2, 4, 8, 16 and 32 (``--autotune``: each twice, in alternated order),
  then a default run that must resolve to the setting with the best
  median rate, counts and p-values bit-equal across every run; then the
  ``--atlas-build`` 100,000-gene top-k 16 build at tile edges 1,024 and
  2,048 and screened with super-tile factors 8 and 16 (``--autotune``:
  also edge 512 and factor 4), and a default build of each kind that
  must resolve to the best, with how many selected edges differ from
  the 1,024-edge build's;
- ``composed_path``: ``stat_mode='xla', gather_mode='fused'`` (the gather
  kernel, one launch per chunk and matrix, then the composed statistics),
  both null modes;
- ``derived_network``: ``network_from_correlation=2.0``, through the
  fused-statistics kernel in its derived-network mode and through the
  composed null;
- ``row_sharded``: ``mesh=make_mesh(1, 4, devices=[cuda:0] * 4)`` with
  ``matrix_sharding='row'`` — four row shards on the one card: the ring
  path (the ring-shift kernel moves the 5,000-row blocks, the gather
  kernel writes each block's rows in place, one launch per step, shard and
  matrix) materialized, streaming and with a derived network, and the psum
  path (``stat_mode='xla'``, one launch per block and matrix), streaming;
- ``perm_mesh``: the fused-statistics null on ``make_mesh(2, 1,
  devices=[cuda:0] * 2)``, streaming;
- ``multi_card``: the ring path on a 1×2 mesh over two cards, where the
  machine has two (otherwise a line that says it did not run);
- ``multi_test``: ``vmap_tests=True`` against two test cohorts on one
  shared permutation draw, materialized (fused statistics) and streaming
  (composed);
- ``multi_test_mesh``: the same two cohorts with ``vmap_tests=True`` on
  meshes (``multi_test_mesh_phase``): on ``make_mesh(2, 1, devices=[cuda:0]
  * 2)`` fused materialized and streaming and composed materialized, on
  ``make_mesh(1, 4, devices=[cuda:0] * 4)`` with
  ``matrix_sharding='row'`` the psum gather, streaming, an adaptive run
  (ceiling 10,000) on 2×1 beside the same run unsplit, and a 2×1 run
  interrupted after three chunks and resumed unsplit: counts, p-values and
  ``n_perm_used`` equal to the unsplit runs', fused nulls bit for bit,
  composed within 1e-4, every launch count exact (the fused kernel once
  per chunk, bucket, shard and cohort; the gather once per chunk, shard,
  matrix and cohort, on the row mesh once per row block, matrix and
  cohort), null seconds and held GiB beside the unsplit runs';
- ``installed``: the port as a user installs it (``installed_start``,
  ``installed_check``): a wheel of the checkout built offline and
  installed with ``pip install --target`` into a temporary directory
  outside the checkout (the phase fails where the wheel does not build
  or install), then a fresh process with only that
  directory on its path and its working directory outside the checkout
  calls ``netrep_tpu_torch.api.module_preservation`` on the main path's
  cohorts at full width: ``fused_stats.cu`` is compiled from the
  installed source into the installed copy's default kernel-library store
  (``source`` ``jit``), the fused kernel launches as often as in
  ``main_path``'s materialized run, and the null equals that run's bit
  for bit (counts, p-values and module sets equal); ``network_properties``
  and ``required_perms`` equal this process's, ``plot_module`` raises the
  ``plot`` extra's ``ImportError`` where matplotlib is absent, every other
  block of ``docs/vignette_torch.md`` runs with ``DEVICE = "cuda"``, and
  ``jax`` never loads; the wheel's size and entries, the child's import,
  ``nvcc``, input, null and wall seconds, and where the store landed;
- ``multi_process``: two processes on the card joined over ``gloo`` on
  127.0.0.1 (``multi_process_phase``): a 2×1 perm mesh across them runs
  the fused null materialized and streaming (10,000 genes, the first two
  cohorts), the sparse null of Config E at full width with data, and the
  screened null (``null_precision='bf16_rescue'``) materialized and
  streaming at 20,000 genes, every permutation rescued and, with
  observed values that let the screen decide some, mixed; each rank's
  nulls, counts, p-values and rescue counters equal the single-process
  2×1 run's bit for bit, each rank launches the fused and the gather
  kernel for its own shard and its own rescue dispatches exactly (the
  sparse path none); then the fault drill in two more processes
  (started beside the first two, idle until those are done): a partial
  device loss in rank 1 ends both with their errors
  (``CrossProcessRungError``, ``PeerLostError``) within the group's
  timeout, and the first pair, launched apart from them, resumes from
  process 0's checkpoint to the unbroken run bit for bit;
  each path's null seconds per rank beside the single process's, each
  process's start-up seconds, the allgather seconds and bytes;
- ``sequential_tests``: the same two cohorts without ``vmap_tests``, one
  pair after another (a matrix a later pair needs waits on the host
  meanwhile), with each pair's phase seconds and the time of one matrix's
  round trip to the host;
- ``surface``: ``network_properties`` on five modules against a float64
  numpy computation of the same formulas on the host slices,
  ``combine_analyses`` of two 500-permutation runs (seeds 1 and 2)
  materialized and streaming with equal combined p-values, and one
  matrix's round trip through pinned host memory;
- ``wide_samples``: the same widths with 1,000-sample cohorts, a shape
  whose module data slices no block's shared memory holds: the kernel
  against its plain version in every bucket, then a streaming null of
  1,000 permutations;
- ``genome_scale``: two 50,000-gene datasets handed over as host float32
  arrays, a streaming null of 200 permutations: its input seconds and
  peak, and the memory held during the null (where the host has less
  than about 45 GB free, a line that says it did not run);
- ``adaptive`` (after ``multi_card``): ``adaptive=True`` at a ceiling of
  10,000 permutations, fused materialized and streaming and composed
  materialized, each fused kernel held to one launch per chunk and bucket
  still active; the two fused modes equal in ``n_perm_used``, counts and
  p-values, every module's rows equal the fixed 1,000-permutation run's
  at the same indices (fused: bit for bit; composed: within 1e-4, its
  batched products round by batch count); beside them a fixed
  10,000-permutation streaming null and an adaptive run under a
  Bonferroni-level stop rule, with each run's ``preserved_modules()`` and
  null seconds; then ``rebucketed_kernels``: the fused values, counts and
  gather kernels on buckets ``rebucket`` row-filtered, against their
  plain versions and the full bucket's values;
- ``checkpoint``: fixed materialized, fixed streaming and adaptive
  materialized runs interrupted by a ``progress`` callback raising
  ``KeyboardInterrupt`` after three chunks (a checkpoint every chunk),
  resumed by the same call and held equal to their uninterrupted runs,
  and a 256-permutation null written on the 1×4 ring mesh and resumed
  unsplit; each file's size and a save's and a load's seconds;
- ``bf16_storage`` (after ``sequential_tests``): the main, composed,
  derived, ring, psum, perm-mesh and multi-test calls again with
  ``EngineConfig(dtype='bfloat16')``, each beside its float32 run (null
  seconds, held GiB, the p-values that differ);
- ``screened``: ``null_precision='bf16_rescue'`` materialized, streaming,
  adaptive (ceiling 10,000) and on the perm mesh, counts, p-values and
  retirements equal to the float32 composed runs', the rescued rows
  those runs' rows; then the GPD tail fit on the fused null;
- ``fault_ladder`` (after ``checkpoint``): the fault ladder at the same
  width (``fault_ladder_phase``): injected transient failures and a hung
  dispatch on the fused streaming null, a partial device loss and the
  capacity's return on a 2×1 perm mesh (shrink to 1×1, grow back), a
  total loss taking the CPU rung for the last chunk (or raising after the
  failure-save), a transient failure on the composed null — each held
  to the unfaulted run, with its recovery events and exact launch
  counts; the background checkpoint writer, a policy's and telemetry's
  cost per chunk (alternated against neither), and ``profile=``'s
  device busy and idle share of the null with its top five operations;
  the CUDA runtime's own error texts classified by the taxonomy;
- ``grid`` (after ``surface``): ``grid_preservation`` on the three
  cohorts, each a grid row (the planted modules) and a column — six cells
  in three column packs (``grid_phase``): fixed and adaptive grids under
  fused statistics and ``stat_mode='xla'``, every cell equal to its solo
  call in p-values, counts and ``n_perm_used``, the launches exact (one
  per chunk and union bucket still active, or two gathers a chunk), the
  pack's null values beside the solo nulls; the grid resumed from its
  manifest (no permutation), one cohort changed (its row and column
  recomputed, warm-started, equal to the solo calls given the priors),
  and a grid interrupted in its second pack and resumed;
- ``serve`` (after ``grid``): the single server
  (``netrep_tpu_torch.serve``) on the same cohorts (``serve_phase``):
  six requests submitted at once into server A (fused statistics; two
  tenants of weights 2 and 1; a pack of four with module subsets, a
  ``'two.sided'`` and an adaptive request at a 10,000 ceiling, two
  multi-test requests) and four into server B (``stat_mode='xla'``,
  ``cross_pair_packing``: a cross-pair pack and a pack of two), each held
  to its solo call (p-values, counts, ``n_perm_used``; the pack's null
  rows bit-equal under fused statistics), each pack's launches exact, a
  second round of pool hits only; then a ``crash`` plan mid-pack on a
  journaled 4,000-gene fixture and a recovering boot bit-identical to an
  uncrashed server, and the daemon over a unix socket (a subprocess on
  ``serve_daemon``) answering as the server in process;
- ``fleet`` (after ``serve``): the serving fleet in process
  (``fleet_phase``): ``grid_preservation(fleet=)`` on the three cohorts
  across two replicas (each cell equal to the in-process grid's, a
  second round of pool hits on the same replicas), then a journaled
  fleet on the generator's fixture (``FLEET_FIXTURE``; 10,000 genes in
  the whole script, 20,000 in ``--fleet``): a crash plan mid-pack on the
  pair's home and failover to the peer (each request equal to its solo call,
  fused null rows bit-equal, the resumed pack's launches exact, zero
  permutations recomputed, the dead replica's pool given back), the
  autoscaler spawning a third replica, an eviction handoff held the same
  way, and scale to zero; the card after ``close()``; the failover
  leaves the departed replica's diagnostic bundle under the fleet
  directory;
- ``roofline`` (after ``composed_path``): the main path again with
  ``telemetry=`` on, fused (materialized, streaming), composed and fused
  in bfloat16 storage, 4,096 permutations each (``roofline_phase``): each
  run's ``roofline`` event — the cost model's bytes and operations per
  permutation, speed of light, achieved rate, utilisation, which must lie
  in (0, 1] — fused and composed costing the same, every family's span
  sums equal to its ``null_run_end`` totals, a perf-ledger entry with a
  ``roofline`` block for each run; then ``flightrec_ab``: the fused
  streaming and the composed materialized null with the flight recorder
  on, off, off, on, each null's seconds, results bit-equal
  (``flightrec_ab_phase``); then ``selftest``:
  ``selftest(device="cuda")`` on both shapes against the float64 oracle;
- ``forensics`` (after ``fleet``): a journaled server's ``dump`` op
  (the bundle's files, a non-empty flight ring, the three kernel
  libraries named, the journal's redacted tail) and a checkpoint refused
  for another seed firing ``checkpoint_refused``;
- ``startup`` (right after the build, while this process holds little
  host memory; in the whole script beside ``fleet_daemon``,
  ``multi_process`` and the ``installed`` child, each driven from its own
  thread or process, so their seconds are those of a shared host): where
  a fresh process's start goes
  (``startup_phase``): a replica daemon's boot cold (an empty
  kernel-library store, ``nvcc`` runs) and warm, split by its ready line
  into the interpreter, the imports, the CUDA context, each library's
  build or load with its ``source``, the journal and the rest; ``warmup
  --measure`` on ``FLEET_FIXTURE`` (the main path's widths in
  ``--startup``, 10,000 genes in the whole script) cold and warm, each
  beside the daemon of its temperature
  (``first_run_s``, ``compile_span_s``, ``source`` ``jit`` then
  ``aot``); ``warmup``'s first chunk of each engine in a fresh process;
- ``cli``: the CLI's ``chaos`` on the card, then its ``selftest --json``,
  ``telemetry``, ``roofline --check``, ``perf --check`` and ``version``
  on the files two telemetry-on nulls wrote (``cli_phase``), each
  exiting 0;
- ``fleet_daemon``: ``serve --fleet 2`` — a coordinator over two replica
  daemon processes on the card (``fleet_daemon_phase``): ``FLEET_FIXTURE``
  registered through its socket, a replica SIGKILLed mid-pack,
  failed over and respawned as ``.g1``, each replica's boot and
  fused-kernel launches, the whole card's used memory around the spawn
  (in the whole script with the other fresh processes' memory in it),
  the coordinator without a CUDA context, and the drain to exit 0; after
  ``fleet``,
  ``fleet_daemon_check`` holds every result bit-equal to the same
  request through the in-process fleet;

and checks each against the others: equal p-values where the same
statistics run, nulls within 1e-4 where the arithmetic differs, and every
gather and ring-step launch count equal to what the path should make.
Before the paths, beside the float32 kernels, ``bf16_vs_plain`` and
``bf16_kernel_times`` hold each kernel's bfloat16 instantiation to its
plain version (gather and ring bit for bit) and time it;
``genome_scale`` runs both storage types, ``data_only`` a screened run
too. Inputs are
generated from a fixed seed (data with numpy on the host, correlation and
network on the card) and handed to the entry point as host numpy arrays, as
a user holds them, so its input phase includes the copy to the card.

``lint`` runs ``python -m netrep_tpu_torch lint --json`` on the checkout
in the background from the script's start (read before the main path),
and requires exit 0 with no finding.

Every mode starts from a fresh, empty autotune store
(``NETREP_AUTOTUNE_STORE``, :func:`fresh_autotune_store`). Prints one JSON
object per phase, the whole run's seconds (``total``),
then the ``{"kernels": [...]}`` summary,
the card's ``name, power.limit`` line, and as its last line
``{"ok": true, "device": {...}}``. Any failed phase raises and the script
exits non-zero; without a CUDA device it exits non-zero before printing
anything.

    python3 chip_smoke.py --sequential-tests

runs only the inputs and the ``sequential_tests`` call, and

    python3 chip_smoke.py --kernels

only the fused-statistics kernel's split and chunk times and the ring
step's times, and

    python3 chip_smoke.py --gather

only one chunk's gather per matrix and the ring's assembly, by whichever
gather design the checkout has, the ring trace and (redesigned gather) the
crossover, and

    python3 chip_smoke.py --inputs

only ``input_phase``, and

    python3 chip_smoke.py --genome-scale

only ``genome_scale`` (an out-of-memory error is printed as its result),
and

    python3 chip_smoke.py --p-values

only the p-values and counts of the main path, the composed null, the
derived network, the row-sharded ring and psum paths, the perm mesh and
two cohorts, and

    python3 chip_smoke.py --bf16
    python3 chip_smoke.py --screened

only the bfloat16 phases (kernels, every storage path beside its float32
run, ``genome_scale``) or the screened ones (with the float32 composed
runs they equal, the GPD tail, ``data_only``), and

    python3 chip_smoke.py --faults

only ``fault_ladder``, its unfaulted references run first, and

    python3 chip_smoke.py --grid

only ``grid``, and

    python3 chip_smoke.py --serve

only ``serve``, and

    python3 chip_smoke.py --fleet

only ``fleet``, and

    python3 chip_smoke.py --tooling

only the fused-statistics rows' bounds by the cost model
(``kernel_bounds``), ``roofline``, ``flightrec_ab``, ``selftest`` and
``forensics``, and

    python3 chip_smoke.py --startup

only ``startup``, ``cli`` and ``fleet_daemon`` (its references from one
in-process server on the same fixture), and

    python3 chip_smoke.py --native

only ``lint``, the main path's fused materialized run and ``native``, and

    python3 chip_smoke.py --autotune

only ``autotune``, and

    python3 chip_smoke.py --multi-test-mesh
    python3 chip_smoke.py --multi-process

only the unsplit ``multi_test`` runs and ``multi_test_mesh``, or only
``multi_process``, and

    python3 chip_smoke.py --installed

only the main path's fused materialized run and ``installed``, and

    python3 chip_smoke.py --screened-mesh

only the 2×1 screened streaming null of one process, a warm-up run and
four timed ones (``screened_mesh``), and

    python3 chip_smoke.py --memory

only where the datasets' matrices live and the card's peaks (the main
path, the 1×4 ring and psum, ``network_properties``, the server, the
in-process fleet, ``genome_scale``), and

    python3 chip_smoke.py --large-modules

only the main path's width with modules of 1,000 to 4,000 genes, the
discovery on the host against the same call with it on the card
(``engine_s``, bit-equal results), and one 4,000-gene block gathered on
the host and on the card.
Each mode runs
through the ``netrep_tpu_torch`` beside the script: copied into another checkout,
it measures that checkout's version on the same inputs.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import threading
import time


#: the script's start on the host clock: each phase line says how far in
#: it ended (``at_s``), so a phase's cost reads off two lines
T_START = time.perf_counter()


#: one line at a time: the whole script drives some phases from threads
_EMIT_LOCK = threading.Lock()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    line = json.dumps(obj, allow_nan=False)
    with _EMIT_LOCK:
        print(line, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


GENES, SAMPLES, MODULES, SIZES = 20_000, 128, 50, (30, 200)
N_PERM, SEED, BETA = 1000, 2026, 2.0
#: permutations of each request of the serve and fleet memory reads
SERVE_MEM_PERM = 256
#: the --large-modules mode: modules of these many genes at the main
#: path's width, its permutations and its calls (each placement)
LARGE_MODULES, LARGE_PERM, LARGE_CALLS = (1000, 2000, 3000, 4000), 128, 4
#: the wide_samples phase: cohorts of this many samples at the same widths
WIDE_SAMPLES, WIDE_PERM = 1000, 1000
#: the genome_scale phase: two datasets of this many genes, streaming
GENOME_GENES, GENOME_PERM = 50_000, 200
#: the surface phase: permutations of each run that combine_analyses pools
SURFACE_PERM = 500
#: the adaptive phase's ceiling: the north star's depth
ADAPTIVE_PERM = 10_000
#: the checkpoint phase: chunks before the interrupt; permutations of the
#: ring-mesh run resumed unsplit
STOP_AFTER, RING_CKPT_PERM = 3, 256
#: kernel vs plain: the kernel sums in its own fixed order and may iterate
#: on the other Gram matrix (csrc/fused_stats.cu); the plain version forms
#: the node-space Gram matrix — float32 rounding apart, ~1e-5 at most
TOL = 1e-4
#: H100 SXM peaks, the cost model's row (``netrep_tpu_torch.utils.
#: costmodel.PEAK_TABLE``, NVIDIA's data sheet): HBM bytes/s and f32
#: FLOP/s outside the tensor cores (the kernels do scalar f32 arithmetic);
#: set by :func:`load_peaks` before any mode runs
H100 = "nvidia h100 80gb hbm3"
HBM_BPS = F32_FLOPS = None
#: NVLink between two H100 SXM cards, each way (NVIDIA data sheet)
NVLINK_BPS = 450e9
SECTOR = 32


def make_cohorts(np, samples=SAMPLES, genes=GENES):
    """Host data ``(samples, genes)`` float32 of the discovery, the test
    and a second test cohort, with the module sizes and node labels, from
    SEED: MODULES planted modules of SIZES nodes, the first half preserved
    in both tests with the discovery loadings."""
    rng = np.random.default_rng(SEED)
    sizes = rng.integers(SIZES[0], SIZES[1] + 1, size=MODULES)
    xd = rng.standard_normal((samples, genes)).astype(np.float32)
    xt = rng.standard_normal((samples, genes)).astype(np.float32)
    labels = np.full(genes, "0", dtype=object)
    order = rng.permutation(genes)
    loads = []
    at = 0
    for k, sz in enumerate(sizes):
        nodes = order[at: at + sz]
        at += sz
        load = rng.uniform(0.6, 2.2, size=sz).astype(np.float32)
        loads.append(load)
        xd[:, nodes] += rng.standard_normal((samples, 1)).astype(np.float32) * load
        if k < MODULES // 2:  # the first half is preserved in the test set
            xt[:, nodes] += (rng.standard_normal((samples, 1))
                             .astype(np.float32) * load)
        labels[nodes] = str(k + 1)
    # the second test cohort continues the seed stream
    x2 = rng.standard_normal((samples, genes)).astype(np.float32)
    at = 0
    for k, sz in enumerate(sizes):
        nodes = order[at: at + sz]
        at += sz
        if k < MODULES // 2:
            x2[:, nodes] += (rng.standard_normal((samples, 1))
                             .astype(np.float32) * loads[k])
    return sizes, labels, (xd, xt, x2)


def mats(torch, x, dev):
    """``(data, correlation, network)`` of one cohort on ``dev`` in
    float64: the genes' Pearson correlation and ``|corr| ** BETA``."""
    t = torch.as_tensor(x, device=dev, dtype=torch.float64)
    z = (t - t.mean(0)) / t.std(0)
    c = (z.T @ z) / (x.shape[0] - 1)
    c = (c + c.T) * 0.5
    c.fill_diagonal_(1.0)
    c.clamp_(-1.0, 1.0)
    return t, c, c.abs() ** BETA


def make_timer(torch):
    """``timed(fn, reps=5)``: mean ms of ``fn()`` over ``reps`` runs after one
    warm-up, by CUDA events."""
    def timed(fn, reps=5):
        fn()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps
    return timed


def make_engine(np, labels, disc, test, cfg, dev, mesh=None):
    """The engine of one (discovery, test) pair, each side ``(data,
    correlation, network)``, over every planted module."""
    from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine

    mods = sorted(set(labels) - {"0"}, key=int)
    specs = [ModuleSpec(k, np.flatnonzero(labels == k),
                        np.flatnonzero(labels == k)) for k in mods]
    (dd, dc, dn), (td, tc, tn) = disc, test
    return PermutationEngine(dc, dn, dd, tc, tn, td, specs,
                             np.arange(len(labels)), config=cfg, device=dev,
                             mesh=mesh)


def first_chunk(torch, np, labels, disc, test, cfg, dev):
    """The engine of one (discovery, test) pair, each side ``(data,
    correlation, network)`` on the card, and the first chunk of its null:
    ``(engine, chunk, obs)``, ``chunk`` a list of ``(bucket, idx)`` and
    ``obs`` each bucket's observed statistics as float32 on the card."""
    from netrep_tpu_torch import random as trandom

    engine = make_engine(np, labels, disc, test, cfg, dev)
    perm = trandom.permutation(
        trandom.perm_keys(trandom.key(SEED, device=dev), 0, cfg.chunk_size),
        engine._pool_dev,
    )
    chunk = [(b, engine._bucket_idx(perm, b)) for b in engine.buckets]
    observed = engine.observed()
    obs = [torch.as_tensor(observed[b.module_pos], dtype=torch.float32,
                           device=dev)
           for b in engine.buckets]
    return engine, chunk, obs


def kernel_split(fs, engine, chunk, n_iter, timed, card):
    """Where the fused-statistics kernel's time goes, bucket by bucket, read
    through arguments its wrapper takes: the full kernel, the kernel with
    no power iteration (``n_iter=0``) and the topology alone (``tdT=None``).
    The differences are the power iteration and the rest of the data phase
    (the data rows, the profile and the node contributions)."""
    tc, tn, tdT = engine._test_corr, engine._test_net, engine._test_dataT
    rows = []
    for b, idx in chunk:
        def run(td, it):
            return lambda: fs.fused_stats_values(tc, tn, td, b.disc, idx,
                                                 n_iter=it)
        rows.append({"cap": b.cap, "modules": len(b.module_pos),
                     "batch": int(idx.shape[0]),
                     "full_ms": timed(run(tdT, n_iter)),
                     "n_iter0_ms": timed(run(tdT, 0)),
                     "topology_ms": timed(run(None, n_iter))})
    total = {k: sum(r[k] for r in rows)
             for k in ("full_ms", "n_iter0_ms", "topology_ms")}
    total["power_iteration_ms"] = total["full_ms"] - total["n_iter0_ms"]
    total["data_rest_ms"] = total["n_iter0_ms"] - total["topology_ms"]
    emit({"phase": "kernel_split", "n_iter": n_iter,
          "samples": int(tdT.shape[-1]), "per_bucket": rows, "total": total,
          "card": card})
    return rows, total


def ring_times(torch, fs, M, timed, card):
    """One ring step's launch on a ``GENES / 4``-row block of ``M``, beside
    its plain version and ``copy_`` into a fresh block of the same kind as
    the kernel's (``torch.empty_like``) and into one reused block."""
    R = 4
    rows_per = GENES // R
    ring = [M[r0: r0 + rows_per] for r0 in range(0, GENES, rows_per)]
    dst = torch.empty_like(ring[0])
    block_bytes = ring[0].numel() * ring[0].element_size()
    p1 = timed(lambda: fs.ring_shift_collective(ring))
    k1 = timed(lambda: fs.ring_shift_dma(ring))
    l1 = timed(lambda: [torch.empty_like(b).copy_(b) for b in ring])
    l2 = timed(lambda: [torch.empty_like(b).copy_(b) for b in ring])
    k2 = timed(lambda: fs.ring_shift_dma(ring))
    p2 = timed(lambda: fs.ring_shift_collective(ring))
    t = {"ms": (k1 + k2) / 2 / R, "plain_ms": (p1 + p2) / 2 / R,
         "library_ms": (l1 + l2) / 2 / R,
         "library_reused_dst_ms": timed(lambda: [dst.copy_(b)
                                                 for b in ring]) / R,
         "bound_ms": 1e3 * 2 * block_bytes / HBM_BPS,
         "nvlink_bound_ms": 1e3 * block_bytes / NVLINK_BPS}
    emit({"phase": "ring_times", "unit": f"one launch: a {rows_per} x "
          f"{GENES} {str(M.dtype)[6:]} block copied on one card",
          "bytes": 2 * block_bytes,
          "times_ms": t, "bound_by": "bytes",
          "library_call": "torch.empty_like(src).copy_(src), a fresh block "
                          "as the kernel's wrapper allocates (a yardstick, "
                          "never called by the port); library_reused_dst_ms: "
                          "dst.copy_(src) into one reused block",
          "plain_note": "the plain version rotates the block list; on one "
                        "card it moves no bytes",
          "order": "plain, kernel, library, library, kernel, plain",
          "card": card})
    return t


def fused_work(fs, costmodel, engine, chunk, cfg, elem=4):
    """The sector floor of one chunk of the fused-statistics kernel, test
    matrices and data stored in ``elem`` bytes (4 float32, 2 bfloat16):
    ``(sector_bytes, kernel_flops, per_bucket)`` — what a scattered design
    pays, not the bound (:func:`fused_bound` is the bound, by the cost
    model's rule). Per cell one 32-byte sector per distinct scattered
    correlation and stored-network entry (the matrices are symmetric:
    m(m-1)/2 pairs; a bfloat16 entry costs its sector too), the module's
    data rows, its indices and its 7 outputs; per bucket its float32
    discovery properties. ``kernel_flops`` is the kernel's own operation
    count (its Gram matrix and power iteration); a bucket's
    ``sector_bound_ms`` sets its sector bytes beside its operations by the
    cost model's count."""
    bytes_, flops_kernel = 0.0, 0.0
    per_bucket = []
    view = copy.copy(engine)
    for b, idx in chunk:
        m = b.disc.mask.sum(-1).double()
        K, cap, B = len(b.module_pos), b.cap, idx.shape[0]
        cell_bytes = (m * (m - 1) / 2 * SECTOR * 2 + m * SAMPLES * elem
                      + cap * 4 + 7 * 4)
        bb = B * float(cell_bytes.sum()) + K * cap * cap * 4 * 2 + K * cap * 16
        view.buckets = [b]
        ff = B * costmodel.resolve_engine_cost(view).flops_per_perm
        # the kernel's own count: the Gram matrix of the smaller side (upper
        # triangle), its n_iter products, and the streamed passes
        f_, r_ = m.clamp(max=SAMPLES), m.clamp(min=SAMPLES)
        fk = B * float((15 * m * (m - 1) + f_ * f_ * r_
                        + 2 * f_ * f_ * cfg.power_iters
                        + 12 * SAMPLES * m).sum())
        bytes_ += bb
        flops_kernel += fk
        per_bucket.append({"cap": cap, "modules": K, "batch": B,
                           "tier": fs.kernel_tier(cap, SAMPLES, True, elem),
                           "pair_cache": fs.kernel_pair_cache(
                               cap, SAMPLES, True, elem),
                           "sector_bound_ms": 1e3 * max(bb / HBM_BPS,
                                                        ff / F32_FLOPS),
                           "kernel_ops_ms": 1e3 * fk / F32_FLOPS})
    return bytes_, flops_kernel, per_bucket


def load_peaks() -> None:
    """Read the H100 row of the cost model's peak table into ``F32_FLOPS``
    and ``HBM_BPS``: one table for the port's roofline and this script's
    bounds."""
    global HBM_BPS, F32_FLOPS
    from netrep_tpu_torch.utils.costmodel import PEAK_TABLE

    F32_FLOPS, HBM_BPS = PEAK_TABLE[H100]


def fused_bound(costmodel, engine, counting, dtype="float32"):
    """Bytes, operations and least time of one chunk of the fused-statistics
    kernel by the cost model's count (``resolve_engine_cost``: each needed
    input byte once at the storage width, each output once, the operations
    of the seven statistics), at ``engine``'s buckets and chunk in storage
    type ``dtype``. The same count the roofline phase's ``roofline`` events
    carry, so the kernel table and the run-time gauges agree."""
    view = copy.copy(engine)
    view.config = dataclasses.replace(engine.config, dtype=dtype)
    cost = costmodel.resolve_engine_cost(view, counting)
    C = engine.effective_chunk()
    b, f = cost.bytes_per_perm * C, cost.flops_per_perm * C
    t_b, t_o = 1e3 * b / HBM_BPS, 1e3 * f / F32_FLOPS
    return {"family": cost.family, "bytes": b, "flops": f, "bytes_ms": t_b,
            "ops_ms": t_o, "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def storages(torch, objs, device_type="cuda") -> dict:
    """``{(device, data pointer): bytes}`` of the distinct tensor storages
    on ``device_type`` reachable from ``objs`` (attributes, lists, tuples,
    dicts, dataclasses): what a set of engines or registrations holds,
    each storage once, read the same way in any checkout of the port."""
    seen, found = set(), {}
    stack = list(objs)
    while stack:
        obj = stack.pop()
        if id(obj) in seen or obj is None:
            continue
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            if obj.device.type == device_type:
                st = obj.untyped_storage()
                found[(str(obj.device), st.data_ptr())] = st.nbytes()
        elif isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
        elif hasattr(obj, "__dict__") and not isinstance(obj, type):
            stack.extend(vars(obj).values())
    return found


def gib_of(found: dict) -> float:
    return sum(found.values()) / 2**30


def spy_datasets(torch):
    """``(on_card, undo)``: for every dataset ``build_datasets`` returns
    from now on, ``on_card[name]`` is the bytes of the CUDA tensors its
    matrices are when the input phase hands it over (:func:`card_bytes`;
    a later ``place`` may release them)."""
    from netrep_tpu_torch.models import dataset as tds

    real = tds.build_datasets
    on_card = {}

    def spy(*a, **k):
        out = real(*a, **k)
        on_card.update({n: card_bytes(torch, d) for n, d in out.items()})
        return out

    tds.build_datasets = spy
    return on_card, lambda: setattr(tds, "build_datasets", real)


def card_bytes(torch, d) -> int:
    """Bytes of the CUDA tensors a dataset's matrices are (0: none of its
    matrices is on the card)."""
    return sum(t.numel() * t.element_size()
               for t in (d.correlation, d.network, d.data)
               if isinstance(t, torch.Tensor) and t.is_cuda)


def same(torch, got, want):
    """Bit-equal, NaN positions compared apart; bfloat16 outputs as their
    16-bit words."""
    if got.dtype == torch.bfloat16 or want.dtype == torch.bfloat16:
        return got.dtype == want.dtype and torch.equal(
            got.contiguous().view(torch.int16),
            want.contiguous().view(torch.int16))
    nan = torch.isnan(got)
    return torch.equal(nan, torch.isnan(want)) and torch.equal(
        torch.where(nan, 0.0, got), torch.where(nan, 0.0, want))


def abs_err(torch, got, want):
    """Largest |got - want| off the NaN positions (which ``same``
    compares)."""
    nan = torch.isnan(got) | torch.isnan(want)
    return (torch.where(nan, 0.0, got)
            - torch.where(nan, 0.0, want)).abs().max().item()


def gather_bound(torch, chunk, n, blocks, elem=4):
    """Bytes of one chunk's gather from one n x n matrix by the rule of
    the guide: each needed entry read once at ``elem`` bytes (the storage
    type's: 4 float32, 2 bfloat16) (the distinct (row,
    column) pairs of every instance's slots, counted on the card), each
    output entry written once, the indices read once per launch over
    ``blocks`` row blocks; beside it the sector floor of a scattered
    design: one 32-byte sector per real entry (m^2 per module: padded slots
    read node 0, which stays in L2), as PRs 3-5 bounded the gather."""
    seen = torch.zeros(n * n, dtype=torch.bool, device=chunk[0][1].device)
    real = written = idx_bytes = 0
    for b, idx in chunk:
        ix = idx.long()
        seen[(ix[..., :, None] * n + ix[..., None, :]).reshape(-1)] = True
        real += idx.shape[0] * float((b.disc.mask.sum(-1).double() ** 2)
                                     .sum())
        written += idx.numel() * idx.shape[-1]
        idx_bytes += idx.numel() * 4
    distinct = int(seen.sum())
    del seen
    return {"distinct_entries": distinct, "real_entries": real,
            "written_entries": written,
            "bytes": elem * (distinct + written) + blocks * idx_bytes,
            "sector_floor_bytes": SECTOR * real + blocks * (elem * written
                                                            + idx_bytes)}


def gather_vs_plain(torch, fg, chunk, tc32, dev, batch):
    """The redesigned gather kernel against its plain version on the card,
    bit for bit (``tc32`` float32 or bfloat16 storage: the outputs keep its
    type), with sentinel slots and a NaN planted in a row the slots
    read: every bucket of the chunk in one launch, with the crossover left
    to the kernel (``batch`` 8: few output rows per source row, read in
    place; the full chunk: rows staged) and forced each way; into NaN
    buffers over four row blocks (``out=``), which must leave the
    replicated gather; the single-bucket entries; a hot row; and a (64,
    60,000) row block, wider than any block's shared memory."""
    err = 0.0
    checked = 0

    def check(got, want, what):
        nonlocal err, checked
        for g, w in zip(got, want):
            err = max(err, abs_err(torch, g, w))
            if not same(torch, g, w):
                raise RuntimeError(f"gather kernel != plain ({what})")
            checked += 1

    def with_sentinels(idx):
        idx = idx.clone()
        idx[..., 0, 1] = -1
        idx[..., -1, 2] = GENES + 5
        return idx

    i0 = chunk[0][1]
    r_nan, c_nan = int(i0[0, 0, 0]), int(i0[0, 0, 1])
    m_nan = tc32.clone()
    m_nan[r_nan, c_nan] = float("nan")
    rows_per = GENES // 4
    nan_seen = 0
    saved = fg.STAGE_DIV
    for ix in ([idx[:batch].contiguous() for _, idx in chunk],
               [with_sentinels(idx[:batch]) for _, idx in chunk]):
        for M in (tc32, m_nan):
            want = fg.gather_submatrix_fused_many_plain(M, ix)
            try:
                for div in (saved, 0, 1 << 20):
                    fg.STAGE_DIV = div
                    check(fg.gather_submatrix_fused_many(M, ix), want,
                          f"batch {batch}, STAGE_DIV {div}")
            finally:
                fg.STAGE_DIV = saved
            nan_seen += sum(int(torch.isnan(w).any()) for w in want)
            out = [torch.full(w.shape, float("nan"), device=dev,
                              dtype=w.dtype) for w in want]
            for r0 in range(0, GENES, rows_per):
                fg.gather_submatrix_fused_many(M[r0: r0 + rows_per], ix, r0,
                                               out=out)
            check(out, want, f"out= over row blocks, batch {batch}")
            check([fg.gather_submatrix_fused(M, ix[-1])], want[-1:],
                  "single bucket")
            blk = M[rows_per: 2 * rows_per]
            check([fg.gather_submatrix_fused_local(blk, ix[0], rows_per)],
                  [fg.gather_submatrix_fused_local_plain(blk, ix[0],
                                                         rows_per)],
                  "local entry")
    hot = [idx[:batch].clone() for _, idx in chunk]
    for ix in hot:
        ix[..., 1:] = 17   # nearly every slot reads one row
    check(fg.gather_submatrix_fused_many(tc32, hot),
          fg.gather_submatrix_fused_many_plain(tc32, hot), "hot row")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wide = torch.randn((64, 60_000), device=dev, generator=gen).to(
        tc32.dtype)
    wide[3, 11] = float("nan")
    wix = torch.randint(0, 60_000, (batch, 48), device=dev,
                        generator=gen, dtype=torch.int32)
    wix[:, :24] = torch.randint(600, 664, (batch, 24), device=dev,
                                generator=gen, dtype=torch.int32)
    wix[:, 0], wix[:, 1] = 603, 11
    wix[0, 5] = -1
    check([fg.gather_submatrix_fused_local(wide, wix, 600)],
          [fg.gather_submatrix_fused_local_plain(wide, wix, 600)],
          "(64, 60000) row block")
    torch.cuda.synchronize()
    if nan_seen == 0:
        raise RuntimeError("the planted NaN reached no gathered block")
    return err, checked


def gather_times(torch, fg, fs, chunk, tc32, timed, dev):
    """One chunk's gather from one matrix, by whichever gather the
    ``netrep_tpu_torch`` beside this script has: the redesigned kernel
    (every bucket in one launch; the ring's local part in place, one
    launch per step and shard) or the first kernel (one launch per bucket;
    the ring's local part one launch per step, shard and bucket, summed
    by ``add_``). Also the whole ring assembly of the chunk for the one
    matrix (``ring_gather_all``, its three ring steps included)."""
    C = chunk[0][1].shape[0]
    R, rows_per = 4, GENES // 4
    idx_list = [idx for _, idx in chunk]
    shard = [[i[j * C // R: (j + 1) * C // R] for i in idx_list]
             for j in range(R)]
    ring = [tc32[r0: r0 + rows_per] for r0 in range(0, GENES, rows_per)]
    many = getattr(fg, "gather_submatrix_fused_many", None)
    if many is not None:
        def replicated():
            return many(tc32, idx_list)

        outs = [[torch.empty(i.shape + i.shape[-1:], device=dev)
                 for i in shard[j]] for j in range(R)]

        def ring_local():
            for t in range(R):
                for j in range(R):
                    r0 = ((j - t) % R) * rows_per
                    many(ring[r0 // rows_per], shard[j], r0, out=outs[j])
    else:
        def replicated():
            return [fg.gather_submatrix_fused(tc32, i) for i in idx_list]

        def ring_local():
            acc = [[None] * len(idx_list) for _ in range(R)]
            for t in range(R):
                for j in range(R):
                    r0 = ((j - t) % R) * rows_per
                    for bi, i in enumerate(shard[j]):
                        part = fg.gather_submatrix_fused_local(
                            ring[r0 // rows_per], i, r0)
                        acc[j][bi] = (part if acc[j][bi] is None
                                      else acc[j][bi].add_(part))
    r1, l1 = timed(replicated), timed(ring_local)
    l2, r2 = timed(ring_local), timed(replicated)
    return {"design": "per_chunk" if many is not None else "per_bucket",
            "replicated_ms": (r1 + r2) / 2, "replicated_runs_ms": [r1, r2],
            "replicated_launches": 1 if many is not None else len(idx_list),
            "ring_local_ms": (l1 + l2) / 2, "ring_local_runs_ms": [l1, l2],
            "ring_local_launches": R * R * (1 if many is not None
                                            else len(idx_list)),
            "ring_assembly_ms": timed(lambda: fs.ring_gather_all(
                [ring], shard, rows_per), reps=3)}


def gather_crossover(torch, fg, chunk, tc32, timed):
    """The redesigned kernel with every row read in place (``STAGE_DIV``
    0) and every row staged (``1 << 20``) at chunks of 4 to 128
    permutations: the mean demand per source row (output entries over rows
    and 32-byte sectors) at which staging starts to pay."""
    rows = []
    saved = fg.STAGE_DIV
    try:
        for batch in (4, 8, 16, 32, 64, 128):
            ix = [idx[:batch].contiguous() for _, idx in chunk]
            row = {"batch": batch, "demand_per_row_sectors": sum(
                i.numel() * i.shape[-1] for i in ix) / GENES / (GENES / 8)}
            for name, div in (("in_place_ms", 0), ("staged_ms", 1 << 20),
                              ("default_ms", saved)):
                fg.STAGE_DIV = div
                row[name] = timed(lambda: fg.gather_submatrix_fused_many(
                    tc32, ix))
            rows.append(row)
    finally:
        fg.STAGE_DIV = saved
    return {"stage_div": saved, "rows": rows}


def ring_trace(torch, np, engine, card, tree):
    """One chunk of the row-sharded ring path (``engine`` on a 1 x 4 mesh
    of one card), split into the local gather launches, the ring steps,
    the rest of the assembly (adds, fills and copies; ``torch.empty``
    allocates without a kernel) and the composed statistics: device time
    by kernel name from ``torch.profiler``, and each part by CUDA events.
    Works on any tree whose engine has the ring path."""
    from torch.profiler import ProfilerActivity, profile

    from netrep_tpu_torch import random as trandom
    from netrep_tpu_torch.ops import fused_stats as fs

    plan = engine._shard_plan()
    keys = trandom.perm_keys(trandom.key(SEED, device=engine.device), 0,
                             engine.effective_chunk())
    rows_per = engine._rows_c[0][0].shape[0]
    idx = []
    for _p, _r, sl, eng in plan:
        perm = trandom.permutation(
            trandom.ThreefryKey(keys.words[sl]).to(eng.device), eng._pool_dev)
        idx.append([eng._bucket_idx(perm, b) for b in eng.buckets])
    mats = [engine._rows_c[0]] + (
        [] if engine._rows_n is None else [engine._rows_n[0]])
    devices = list(engine.mesh.devices[0])

    def assemble():
        return fs.ring_gather_all(mats, idx, rows_per, devices=devices)

    def stats(subs):
        return [eng._stats(b, ix, sc, sn)
                for j, (*_, eng) in enumerate(plan)
                for b, ix, sc, sn in zip(
                    eng.buckets, idx[j], subs[j][0],
                    subs[j][1] if len(mats) > 1 else [None] * len(idx[j]))]

    def device_ms(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if "cuda" not in str(getattr(e, "device_type", "")).lower():
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us:
                out[e.key] = out.get(e.key, 0.0) + us / 1e3
        return out

    timed = make_timer(torch)
    subs = assemble()
    events = {"assembly_ms": timed(assemble, reps=3),
              "stats_ms": timed(lambda: stats(subs), reps=3),
              "chunk_ms": timed(lambda: engine._ring_values(keys), reps=3)}
    asm = device_ms(assemble)
    st = device_ms(lambda: stats(subs))
    parts = {"local_gather_ms": 0.0, "ring_step_ms": 0.0,
             "add_fill_copy_ms": 0.0}
    for name, ms in asm.items():
        key = ("local_gather_ms" if "fused_gather" in name
               else "ring_step_ms" if "ring_shift" in name
               else "add_fill_copy_ms")
        parts[key] += ms
    parts["composed_stats_ms"] = sum(st.values())
    top = sorted(asm.items(), key=lambda kv: -kv[1])[:6]
    emit({"phase": "ring_trace", "tree": tree,
          "unit": f"one chunk of {engine.effective_chunk()} permutations, "
                  f"{len(mats)} matrices, mesh 1x{len(devices)} on one card",
          "profiler_ms": parts,
          "profiler_saw_device_time": bool(asm) and bool(st),
          "assembly_kernels_ms": dict(top), "cuda_events_ms": events,
          "card": card})
    return parts, events


def asymmetry(torch, np, fs, tstats, engine, chunk, obs, disc, cfg, dev,
              card):
    """The fused kernel against its plain version on test matrices as
    asymmetric as the datasets accept: each off-diagonal pair's triangles
    differ by 9e-6 of its value (inside ``np.allclose(a, a.T, rtol=1e-5,
    atol=1e-8)``, checked here). In each tier: the main path's buckets
    (caps 32-224: the shared-memory cache holds the module, each pair is
    read once from the upper triangle) and a bucket of cap 256 (no cache:
    whole rows, both triangles), values and counts."""
    tdT = engine._test_dataT

    def asym(c, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        sign = torch.randint(0, 2, c.shape, device=dev, generator=gen,
                             dtype=torch.int8) * 2 - 1
        sign = torch.triu(sign, 1)
        out = c * (1 + 4.5e-6 * (sign - sign.T).to(c.dtype))
        ok = bool(((out - out.T).abs() <= 1e-8 + 1e-5 * out.T.abs()).all())
        if not ok or torch.equal(out, out.T):
            raise RuntimeError("asymmetric case outside the datasets' "
                               "tolerance, or symmetric")
        return out

    tc, tn = asym(engine._test_corr, 1), asym(engine._test_net, 2)
    dd, dc, dn = disc
    nodes = torch.arange(256, device=dev)[None] * 37 % GENES
    dc32, dn32, dd32 = dc.float(), dn.float(), dd.float()
    wide = tstats.make_disc_props(
        tstats.gather_submatrix(dc32, nodes), tstats.gather_submatrix(
            dn32, nodes), dd32[:, nodes].permute(1, 0, 2),
        torch.ones((1, 256), device=dev))
    del dc32, dn32, dd32
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wide_idx = torch.stack([torch.randperm(GENES, device=dev, generator=gen)
                            [:256] for _ in range(8)])[:, None].to(torch.int32)
    wide_obs = torch.zeros((1, 7), device=dev)
    cases = {"cached": [(b.disc, idx[:8].contiguous(), ob)
                        for (b, idx), ob in zip(chunk, obs)],
             "whole_row": [(wide, wide_idx, wide_obs)]}
    out = {}
    for tier, cells in cases.items():
        err = {"values": 0.0, "counts": 0.0}
        for dprops, idx, ob in cells:
            want = fs.fused_stats_values_plain(tc, tn, tdT, dprops, idx,
                                               n_iter=cfg.power_iters)
            got = {"values": fs.fused_stats_values(
                tc, tn, tdT, dprops, idx, n_iter=cfg.power_iters),
                "counts": fs.fused_stats_counts(
                    tc, tn, tdT, dprops, idx,
                    torch.ones(idx.shape[0], dtype=torch.int32, device=dev),
                    ob, n_iter=cfg.power_iters)[0]}
            torch.cuda.synchronize()
            for mode, g in got.items():
                if not torch.equal(torch.isnan(g), torch.isnan(want)):
                    raise RuntimeError(f"asymmetry {tier} {mode}: NaN "
                                       "pattern differs")
                err[mode] = max(err[mode], torch.nan_to_num(
                    (g - want).abs(), nan=0.0).max().item())
        out[tier] = err
    worst = max(e for t in out.values() for e in t.values())
    emit({"phase": "asymmetry", "relative_asymmetry": 9e-6,
          "datasets_tolerance": {"rtol": 1e-5, "atol": 1e-8},
          "batch": 8, "max_abs_err": out, "tolerance": TOL,
          "tiers": {"cached": [b.cap for b, _ in chunk], "whole_row": [256]},
          "card": card})
    if worst > TOL:
        raise RuntimeError(f"asymmetric inputs: kernel disagrees with plain "
                           f"by {worst}")
    return out


def mats32(torch, x, dev):
    """``(correlation, network)`` of one cohort on ``dev`` in float32 (the
    genome-scale phase, where a float64 matrix would not leave room):
    the genes' Pearson correlation, made exactly symmetric, and
    ``|corr| ** BETA``."""
    t = torch.as_tensor(x, device=dev)
    z = (t - t.mean(0)) / t.std(0)
    c = (z.T @ z) / (x.shape[0] - 1)
    c = (c + c.T) * 0.5
    c.fill_diagonal_(1.0)
    c.clamp_(-1.0, 1.0)
    return c, c.abs() ** BETA


def checksum(torch, t, rows=1024):
    """sha256 (first 16 hex digits) of a tensor's bytes, copied to the
    host a block of rows at a time."""
    h = hashlib.sha256()
    for r in range(0, t.shape[0], rows):
        h.update(t[r: r + rows].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def input_phase(torch, np, hosts, card, bound=True):
    """``build_datasets`` alone on host float64 inputs at the main path's
    width: each dataset alone, then both together as ``module_preservation``
    calls it, each with its seconds (synchronised) and the peak device
    memory of the call from a reset just before it, against the float32
    matrices it returns; and the checksums of those matrices, to hold two
    versions to the same narrowing. With ``bound``, fails when the peak of
    the two-dataset call exceeds what it returns by more than 0.5 GiB."""
    from netrep_tpu_torch.models.dataset import build_datasets

    def one(names):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = build_datasets(
            {k: hosts[k][2] for k in names},
            data={k: hosts[k][0] for k in names},
            correlation={k: hosts[k][1] for k in names}, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        held = sum(getattr(d, f).numel() * getattr(d, f).element_size()
                   for d in out.values()
                   for f in ("correlation", "network", "data"))
        return out, {"input_s": secs, "peak_gib": peak / 2**30,
                     "outputs_gib": held / 2**30,
                     "peak_above_outputs_gib": (peak - held) / 2**30}

    alone = {}
    for name in hosts:
        out, alone[name] = one([name])
        del out
    out, both = one(list(hosts))
    sums = {name: {f: checksum(torch, getattr(d, f))
                   for f in ("correlation", "network", "data")}
            for name, d in out.items()}
    dtypes = sorted({str(getattr(d, f).dtype) for d in out.values()
                     for f in ("correlation", "network", "data")})
    del out
    torch.cuda.empty_cache()
    emit({"phase": "input_phase", "genes": GENES, "samples": SAMPLES,
          "input_dtype": str(next(iter(hosts.values()))[1].dtype),
          "bytes": sum(m.nbytes for h in hosts.values() for m in h),
          "datasets_alone": alone, "both": both, "output_dtypes": dtypes,
          "checksums": sums, "card": card})
    if bound and both["peak_above_outputs_gib"] > 0.5:
        raise RuntimeError(f"input phase: peak {both['peak_gib']} GiB is "
                           "more than 0.5 GiB above its float32 outputs")
    return both


def _cudart(torch):
    """The CUDA runtime library torch loaded, through ctypes, for
    ``cudaMemcpy2DAsync`` (torch exposes no strided host-to-card copy)."""
    import ctypes

    major = (torch.version.cuda or "12").split(".")[0]
    for name in (f"libcudart.so.{major}", "/usr/local/cuda/lib64/libcudart.so"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        raise OSError("no libcudart found")
    lib.cudaMemcpy2DAsync.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p]
    lib.cudaMemcpy2DAsync.restype = ctypes.c_int
    return lib


def host_copies(torch, np, m, card, side=2048):
    """How one host float64 ``GENES``² matrix can reach the card, each
    route timed alone (host clock, synchronised): the whole matrix from
    pageable memory (the parent's route); its tiles copied into one pinned
    buffer by torch's threaded ``copy_`` (all intra-op threads, then one);
    a pinned tile copied to the card as many times; and the user's array
    page-locked in place (``cudaHostRegister``) with each tile moved by
    one strided ``cudaMemcpy2DAsync``."""
    dev = torch.device("cuda")
    n = m.shape[0]
    src = torch.from_numpy(m)
    tiles = [(slice(i, min(n, i + side)), slice(j, min(n, j + side)))
             for i in range(0, n, side) for j in range(0, n, side)]
    gb = m.nbytes / 1e9
    out = {"gb": gb, "tile": side, "tiles": len(tiles),
           "threads": torch.get_num_threads()}

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return {"s": secs, "gb_per_s": gb / secs}

    def whole():
        out.setdefault("_keep", []).append(src.to(dev))

    out["pageable_whole"] = clock(whole)
    out.pop("_keep")
    torch.cuda.empty_cache()
    pin = torch.empty((side, side), dtype=torch.float64, pin_memory=True)

    def fill():
        for r, c in tiles:
            v = src[r, c]
            pin[: v.shape[0], : v.shape[1]].copy_(v)

    out["pinned_fill"] = clock(fill)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out["pinned_fill_one_thread"] = clock(fill)
    finally:
        torch.set_num_threads(threads)
    dst = torch.empty((side, side), dtype=torch.float64, device=dev)
    out["pinned_to_card"] = clock(lambda: [dst.copy_(pin, non_blocking=True)
                                           for _ in tiles])
    try:
        lib = _cudart(torch)
        rt = torch.cuda.cudart()
        t0 = time.perf_counter()
        err = int(rt.cudaHostRegister(m.ctypes.data, m.nbytes, 0))
        reg_s = time.perf_counter() - t0
        if err:
            raise RuntimeError(f"cudaHostRegister: error {err}")
        try:
            stream = torch.cuda.current_stream().cuda_stream

            def dma():
                for r, c in tiles:
                    h, w = r.stop - r.start, c.stop - c.start
                    e = lib.cudaMemcpy2DAsync(
                        dst.data_ptr(), side * 8,
                        m.ctypes.data + (r.start * n + c.start) * 8, n * 8,
                        w * 8, h, 1, stream)
                    if e:
                        raise RuntimeError(f"cudaMemcpy2DAsync: error {e}")

            out["registered_2d"] = {**clock(dma), "register_s": reg_s}
            r, c = tiles[-1]
            h, w = r.stop - r.start, c.stop - c.start
            if not torch.equal(dst[:h, :w].cpu(), src[r, c]):
                raise RuntimeError("strided copy of the last tile differs")
        finally:
            rt.cudaHostUnregister(m.ctypes.data)
    except (OSError, RuntimeError, AttributeError) as e:
        out["registered_2d"] = {"measured": False, "why": str(e)}
    del dst, pin
    torch.cuda.empty_cache()
    emit({"phase": "host_copies", **out, "card": card})


def round_trip(torch, m):
    """One float32 matrix on the card to the host and back as the datasets
    move a later pair's matrix (``place``: pinned, on a side stream, where
    the checkout has it; pageable before), each way timed to the end of
    its copy; fails unless it comes back equal."""
    from netrep_tpu_torch.models import dataset as tds

    pinned = hasattr(tds, "to_host")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if pinned:
        host, done = tds.to_host(m)
        if done is not None:
            done.synchronize()
    else:
        host = m.cpu()
    t1 = time.perf_counter()
    back = (tds.to_device(host, m.device, done) if pinned
            else host.to(m.device))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not torch.equal(back, m):
        raise RuntimeError("a matrix's round trip to the host changed it")
    return {"route": "pinned" if pinned else "pageable",
            "gib": m.numel() * m.element_size() / 2**30,
            "to_host": t1 - t0, "to_card": t2 - t1}


def genome_scale(torch, np, card, strict=True):
    """Two GENOME_GENES-gene datasets (data SAMPLES × GENOME_GENES, MODULES
    planted modules), handed to ``module_preservation`` as host float32
    arrays, streaming, GENOME_PERM permutations, once with float32 storage
    and once with ``dtype='bfloat16'``: ``input_s``, the peak of the input
    phase, the memory held during the null, the p-values that differ
    between the two. Needs about 45 GB of host memory; where
    ``MemAvailable`` is short of it, prints why it did not run. With
    ``strict=False`` (a version that may not fit) an out-of-memory error is
    reported as the result instead of raised. Returns the float32
    result."""
    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.utils.config import EngineConfig

    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    need = 4 * GENOME_GENES**2 * 4 * 1.1
    if avail < need:
        emit({"phase": "genome_scale", "run": False,
              "why": f"MemAvailable {avail / 1e9:.1f} GB < {need / 1e9:.1f} "
                     "GB of host memory for four float32 matrices",
              "card": card})
        return None
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _sizes, labels, (xd, xt, _x2) = make_cohorts(np, genes=GENOME_GENES)
    host = {}
    for name, x in (("disc", xd), ("test", xt)):
        c, n = mats32(torch, x, dev)
        host[name] = (x, c.cpu().numpy(), n.cpu().numpy())
        del c, n
        torch.cuda.empty_cache()
    made_s = time.perf_counter() - t0
    out = {}
    for dtype in ("float32", "bfloat16"):
        tops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held, before_null = [], []

        def progress(done, total):
            if not before_null:
                before_null.append(torch.cuda.max_memory_allocated())
            held.append(torch.cuda.memory_allocated())

        report = {"phase": "genome_scale", "run": True, "dtype": dtype,
                  "genes": GENOME_GENES, "samples": SAMPLES,
                  "modules": MODULES, "n_perm": GENOME_PERM,
                  "store_nulls": False, "input_dtype": "float32",
                  "host_bytes": sum(m.nbytes for h in host.values()
                                    for m in h),
                  "make_inputs_s": made_s}
        t0 = time.perf_counter()
        try:
            res = module_preservation(
                network={k: h[2] for k, h in host.items()},
                data={k: h[0] for k, h in host.items()},
                correlation={k: h[1] for k, h in host.items()},
                module_assignments=list(labels), discovery="disc",
                test="test", n_perm=GENOME_PERM, seed=SEED,
                store_nulls=False, device="cuda", progress=progress,
                config=EngineConfig(dtype=dtype))
        except torch.cuda.OutOfMemoryError as e:
            if strict:
                raise
            emit({**report, "completed": False,
                  "error": f"{type(e).__name__}: {str(e).splitlines()[0]}",
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "card": card})
            torch.cuda.empty_cache()
            continue
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in tops.kernels()}
        if launches["fused_stats_counts"] == 0:
            raise RuntimeError("genome_scale launched no fused_stats_counts "
                               "kernel")
        if res.observed.shape != (MODULES, 7) or not np.isfinite(
                res.observed).all():
            raise RuntimeError("genome_scale: observed statistics are not "
                               "finite (MODULES, 7)")
        if not ((res.p_values > 0) & (res.p_values <= 1)).all():
            raise RuntimeError("genome_scale: p-values outside (0, 1]")
        if res.completed != GENOME_PERM:
            raise RuntimeError(f"genome_scale: completed {res.completed}")
        prof = res.profile
        extra = {} if dtype == "float32" or "float32" not in out else {
            "p_vs_float32": p_diff(np, res.p_values,
                                   out["float32"].p_values)}
        emit({**report, "completed": True, "wall_s": wall,
              **{k: prof[k] for k in ("input_s", "engine_s", "observed_s",
                                      "null_s", "perms_per_s")},
              "input_peak_gib": before_null[0] / 2**30,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "null_held_gib": max(held) / 2**30, "launches": launches,
              "modules_preserved": int((res.p_values.max(axis=1)
                                        < 0.05 / MODULES).sum()),
              **extra, "card": card})
        out[dtype] = res
        torch.cuda.empty_cache()
    del host
    return out.get("float32")


#: the sparse phase (Config E, bench.py's bench_e): nodes, random
#: neighbours per node, modules and their size range, permutations; the
#: reduced card-vs-CPU run's nodes, modules, size range and permutations
SPARSE_NODES, SPARSE_K, SPARSE_MODULES, SPARSE_SIZES = 50_000, 30, 30, (50,
                                                                       500)
SPARSE_PERM, SPARSE_ITERS = 1000, 40
SPARSE_SMALL = (2000, 8, (20, 150), 200)
#: the data_only phase (the atlas shape, bench.py's bench_atlas): genes,
#: modules and their size range, planted factor, β, adaptive ceiling; the
#: acceptance pin's genes and modules
ATLAS_GENES, ATLAS_MODULES, ATLAS_SIZES = 100_000, 50, (30, 200)
ATLAS_FACTOR, ATLAS_PERM, ATLAS_SMALL = 1.1, 10_000, (400, 4)


def no_kernel(tops, phase) -> dict:
    """The launch counts since the last reset; no kernel of the port runs
    on the sparse and data-only paths (no Pallas kernel runs on the JAX
    package's), so any launch means the path went astray."""
    launches = {fn.__name__: fn.launches for fn in tops.kernels()}
    if any(launches.values()):
        raise RuntimeError(f"{phase} launched a kernel: {launches}")
    return launches


#: sparse_problem's results by arguments: the multi_process and sparse
#: phases draw Config E's full-width inputs once between them
_SPARSE_MADE: dict = {}


def sparse_problem(np, n, k, samples, modules, sizes, plant=0.0, seed=0):
    """Config E's inputs as ``bench.py``'s ``bench_e`` draws them from
    ``default_rng(seed)``: ``k`` random neighbours per node, weights uniform
    in [0.05, 1), symmetrized by ``from_coo``; data ``samples × n``;
    ``modules`` contiguous modules of log-uniform size. ``plant`` adds a
    shared factor of that scale to each module's data (0: pure noise, as
    the bench). Also a precomputed sparse correlation on the graph's edge
    pattern: each edge's Pearson correlation of the data. Drawn once per
    arguments in a process (the callers only read them)."""
    args = (n, k, samples, modules, tuple(sizes), plant, seed)
    if args not in _SPARSE_MADE:
        _SPARSE_MADE[args] = _draw_sparse_problem(np, *args)
    return _SPARSE_MADE[args]


def _draw_sparse_problem(np, n, k, samples, modules, sizes, plant, seed):
    """:func:`sparse_problem`'s draw."""
    from netrep_tpu_torch.ops.sparse import SparseAdjacency

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = rng.integers(0, n, size=n * k)
    vals = rng.uniform(0.05, 1.0, size=n * k).astype(np.float32)
    adj = SparseAdjacency.from_coo(rows, cols, vals, n)
    data = rng.standard_normal((samples, n)).astype(np.float32)
    lo, hi = sizes
    msz = np.exp(rng.uniform(np.log(lo), np.log(hi), size=modules)).astype(
        int)
    labels = np.full(n, "0", dtype=object)
    pos = 0
    for i, sz in enumerate(msz):
        if plant:
            data[:, pos:pos + sz] += plant * rng.standard_normal(
                samples).astype(np.float32)[:, None]
        labels[pos:pos + sz] = str(i + 1)
        pos += sz
    z = (data - data.mean(0)) / data.std(0, ddof=1)
    wgt = np.zeros(adj.wgt.shape, np.float32)
    for r0 in range(0, n, 4096):
        nb = adj.nbr[r0:r0 + 4096]
        real = nb < n
        prod = np.einsum("si,sij->ij", z[:, r0:r0 + nb.shape[0]],
                         z[:, np.where(real, nb, 0)])
        wgt[r0:r0 + nb.shape[0]] = np.where(real, prod / (samples - 1), 0)
    corr = SparseAdjacency.from_arrays(adj.nbr, wgt, n)
    return adj, data, corr, labels, msz


def chunk_trace(torch, engine) -> dict:
    """Where one null chunk of ``engine`` (its first keys) spends its time:
    the chunk's ms by CUDA events, and the device time of its kernels from
    ``torch.profiler``, by kernel; their ratio is the device's busy share
    (the rest is the host issuing the chunk's small ops)."""
    from torch.profiler import ProfilerActivity, profile

    from netrep_tpu_torch import random as trandom

    keys = trandom.perm_keys(trandom.key(SEED, device=engine.device), 0,
                             engine.effective_chunk())
    chunk_ms = make_timer(torch)(lambda: engine._chunk(keys), reps=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine._chunk(keys)
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            ops[e.key] = ops.get(e.key, 0.0) + us / 1e3
    device_ms = sum(ops.values())
    return {"unit": f"one chunk of {engine.effective_chunk()} permutations",
            "chunk_ms": chunk_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / chunk_ms,
            "kernels": len(ops), "profiler_saw_device_time": bool(ops),
            "top_kernels_ms": dict(sorted(ops.items(),
                                          key=lambda kv: -kv[1])[:8])}


def tallies_of(pv, res):
    """``(hi, lo, eff)`` of a result: a streaming run's tallies, or the
    tail counts of its null."""
    if res.nulls is None:
        return res.counts_hi, res.counts_lo, res.counts_eff
    return pv.tail_counts(res.observed, res.nulls)


def card_vs_cpu(np, pv, run, what):
    """``run(device)`` on the card and on the CPU: equal p-values and
    tail counts, values within TOL; returns the largest deviations."""
    card, cpu = run("cuda"), run("cpu")
    if not np.array_equal(np.isnan(card.nulls), np.isnan(cpu.nulls)):
        raise RuntimeError(f"{what}: NaN patterns of card and CPU differ")
    obs_err = float(np.nanmax(np.abs(card.observed - cpu.observed)))
    null_err = float(np.nanmax(np.abs(card.nulls - cpu.nulls)))
    same = all(np.array_equal(a, b) for a, b in zip(tallies_of(pv, card),
                                                   tallies_of(pv, cpu)))
    if obs_err > TOL or null_err > TOL or not same or not np.array_equal(
            card.p_values, cpu.p_values, equal_nan=True):
        raise RuntimeError(f"{what}: card and CPU disagree (observed "
                           f"{obs_err}, null {null_err}, counts equal "
                           f"{same})")
    return {"max_abs_observed": obs_err, "max_abs_null": null_err,
            "counts_equal": True, "p_values_equal": True}


def sparse_phase(torch, np, card) -> dict:
    """Config E at full width through ``sparse_module_preservation``: a
    SPARSE_NODES-node kNN graph, data SAMPLES × SPARSE_NODES, SPARSE_MODULES
    modules, SPARSE_PERM permutations, chunk 128, SPARSE_ITERS power
    iterations; with data (7 statistics) and with a precomputed sparse
    correlation and no data (4), after a 128-permutation warm-up call.
    Inputs are host numpy. Checks: the first
    chunk's index sets on the card equal the CPU's (two sort rounds at
    this pool); a reduced run (SPARSE_SMALL: nodes, modules, sizes,
    permutations; planted modules, so no null value lies within rounding
    of an observed one) on the card gives the CPU's counts and p-values,
    values within TOL. Returns the launch counts of each run (all 0)."""
    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch import random as trandom
    from netrep_tpu_torch.models.sparse_api import sparse_module_preservation
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.parallel.engine import ModuleSpec, _take_blocks
    from netrep_tpu_torch.parallel.sparse import SparsePermutationEngine
    from netrep_tpu_torch.utils.config import EngineConfig

    t0 = time.perf_counter()
    adj, data, corr, labels, msz = sparse_problem(
        np, SPARSE_NODES, SPARSE_K, SAMPLES, SPARSE_MODULES, SPARSE_SIZES)
    made_s = time.perf_counter() - t0
    cfg = EngineConfig(chunk_size=128, power_iters=SPARSE_ITERS)
    runs, launches = {}, {}
    # the statistics each input mode defines, and those NaN for a module
    # without an edge inside it, as in the JAX package: cor.degree (its
    # degrees are all 0) and, where the correlation lies on the edges,
    # cor.cor — the random graph leaves a small module a few such
    modes = (("with_data", dict(discovery_data=data, test_data=data),
              [0, 1, 2, 3, 4, 5, 6], [3]),
             ("correlation_no_data", dict(discovery_correlation=corr,
                                          test_correlation=corr),
              [0, 2, 3, 5], [2, 3]))
    # warm-up: the first call in the process pays the libraries' set-up
    t1 = time.perf_counter()
    sparse_module_preservation(adj, adj, labels, n_perm=128, seed=SEED,
                               config=cfg, **modes[0][1])
    warm_s = time.perf_counter() - t1
    for name, extra, defined, edge_nan in modes:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tops.reset_launches()
        t1 = time.perf_counter()
        res = sparse_module_preservation(
            adj, adj, labels, n_perm=SPARSE_PERM, seed=SEED, config=cfg,
            **extra)
        wall = time.perf_counter() - t1
        launches[name] = no_kernel(tops, f"sparse {name}")
        obs = res.observed
        undefined = [j for j in range(7) if j not in defined]
        always = [j for j in defined if j not in edge_nan]
        edgeless = obs[:, 0] == 0
        if (obs.shape != (SPARSE_MODULES, 7)
                or not np.isnan(obs[:, undefined]).all()
                or not np.isfinite(obs[:, always]).all()
                or not np.isfinite(obs[~edgeless][:, edge_nan]).all()):
            raise RuntimeError(f"sparse {name}: observed statistics "
                               f"{obs.tolist()}")
        p = res.p_values[np.isfinite(obs)]
        if res.completed != SPARSE_PERM or not ((p > 0) & (p <= 1)).all():
            raise RuntimeError(f"sparse {name}: completed {res.completed}")
        runs[name] = {"wall_s": wall, **res.profile,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "statistics_defined": defined,
                      "modules_without_an_inner_edge": int(edgeless.sum()),
                      "launches": launches[name]}
    # the first chunk's index sets: card vs CPU
    specs = [ModuleSpec(str(i + 1), np.arange(a, a + s), np.arange(a, a + s))
             for i, (a, s) in enumerate(zip(np.cumsum(np.r_[0, msz[:-1]]),
                                            msz))]
    pool = np.arange(SPARSE_NODES, dtype=np.int32)
    tops.reset_launches()
    trace = {
        "with_data": chunk_trace(torch, SparsePermutationEngine(
            adj, data, adj, data, specs, pool, config=cfg)),
        "correlation_no_data": chunk_trace(torch, SparsePermutationEngine(
            adj, None, adj, None, specs, pool, config=cfg, disc_corr=corr,
            test_corr=corr)),
    }
    no_kernel(tops, "sparse chunk_trace")
    draws = {}
    for dev in ("cuda", "cpu"):
        eng = SparsePermutationEngine(adj, None, adj, None, specs, pool,
                                      config=cfg, device=dev)
        perm = trandom.permutation(trandom.perm_keys(
            trandom.key(SEED, dev), 0, 128), eng._pool_dev)
        draws[dev] = [_take_blocks(perm, b.take).cpu().numpy()
                      for b in eng.buckets]
    if not all(np.array_equal(a, b) for a, b in zip(draws["cuda"],
                                                   draws["cpu"])):
        raise RuntimeError("sparse: the card's first chunk of index sets "
                           "differs from the CPU's")
    # a reduced run: card vs CPU
    n, mods, sizes, n_perm = SPARSE_SMALL
    s_adj, s_data, s_corr, s_labels, _ = sparse_problem(
        np, n, SPARSE_K, SAMPLES, mods, sizes, plant=ATLAS_FACTOR, seed=1)
    small = {}
    for name, extra in (("with_data", dict(discovery_data=s_data,
                                           test_data=s_data)),
                        ("correlation_no_data", dict(
                            discovery_correlation=s_corr,
                            test_correlation=s_corr))):
        small[name] = card_vs_cpu(np, pv, lambda dev: sparse_module_preservation(
            s_adj, s_adj, s_labels, n_perm=n_perm, seed=SEED, config=cfg,
            device=dev, **extra), f"sparse reduced {name}")
    emit({"phase": "sparse", "nodes": SPARSE_NODES, "k_drawn": SPARSE_K,
          "nnz": adj.nnz, "k_padded": adj.k, "samples": SAMPLES,
          "modules": SPARSE_MODULES, "module_sizes": [int(v) for v in msz],
          "n_perm": SPARSE_PERM, "chunk": 128, "power_iters": SPARSE_ITERS,
          "make_inputs_s": made_s, "warm_up_s": warm_s, "runs": runs,
          "chunk_trace": trace, "first_chunk_index_sets_equal_cpu": True,
          "reduced_vs_cpu": {"nodes": n, "modules": mods, "n_perm": n_perm,
                             "tolerance": TOL, **small},
          "card": card})
    torch.cuda.empty_cache()
    return launches


def atlas_inputs(np, genes, modules, sizes, samples=SAMPLES, seed=0):
    """The atlas shape as ``bench.py``'s ``bench_atlas`` draws it from
    ``default_rng(seed)``: ``modules`` contiguous modules of log-uniform
    size, two datasets of ``samples × genes`` standard normal data with a
    planted factor ``ATLAS_FACTOR · N(0, 1)`` per module. Returns the
    datasets and the per-position labels."""
    rng = np.random.default_rng(seed)
    lo, hi = sizes
    msz = np.exp(rng.uniform(np.log(lo), np.log(hi), size=modules)).astype(
        int)
    starts = np.cumsum(np.r_[0, msz[:-1]])

    def planted():
        x = rng.standard_normal((samples, genes)).astype(np.float32)
        for a, s in zip(starts, msz):
            x[:, a:a + s] += ATLAS_FACTOR * rng.standard_normal(
                samples).astype(np.float32)[:, None]
        return x

    labels = np.full(genes, "0", dtype=object)
    for i, (a, s) in enumerate(zip(starts, msz)):
        labels[a:a + s] = str(i + 1)
    return planted(), planted(), list(labels), msz


def largest_allocation(torch, fn):
    """``(fn(), bytes)``: the largest single device allocation made while
    ``fn`` runs, from the caching allocator's recorded history."""
    torch.cuda.memory._record_memory_history(context=None, stacks="python",
                                             max_entries=2_000_000)
    try:
        out = fn()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    sizes = [e["size"] for trace in snap["device_traces"] for e in trace
             if e["action"] == "alloc"]
    return out, max(sizes)


def data_only_phase(torch, np, card) -> dict:
    """The atlas shape at full width through ``atlas_module_preservation``:
    ATLAS_GENES genes, ATLAS_MODULES planted modules, SAMPLES samples,
    β = BETA, chunk 128, SPARSE_ITERS power iterations; N_PERM permutations
    materialized and streaming, and adaptive streaming at a ceiling of
    ATLAS_PERM, and the screened null (``null_precision='bf16_rescue'``)
    materialized, equal to the float32 run in counts and p-values, its
    rescued rows that run's rows. Reports each run's seconds, permutations
    per second, peak
    device GiB, and the largest device allocation of a 256-permutation
    materialized call (recorded apart: the history slows allocation).
    Checks: every peak below 8 GiB, far below one float32
    ATLAS_GENES² matrix, and no allocation that large; at ATLAS_SMALL
    (genes, modules) the data-only run on the card gives the counts and
    p-values of the dense path on the derived matrices
    (``dense_reference_stats``) on the card. Returns the launch counts."""
    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.atlas.modules import dense_reference_stats
    from netrep_tpu_torch.models.atlas_api import atlas_module_preservation
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine
    from netrep_tpu_torch.utils.config import EngineConfig

    t0 = time.perf_counter()
    xd, xt, labels, msz = atlas_inputs(np, ATLAS_GENES, ATLAS_MODULES,
                                       ATLAS_SIZES)
    made_s = time.perf_counter() - t0
    nn_bytes = 4 * ATLAS_GENES ** 2
    cfg = EngineConfig(chunk_size=128, power_iters=SPARSE_ITERS)
    kw = dict(data={"disc": xd, "test": xt}, module_assignments=labels,
              discovery="disc", test="test", data_only=BETA, seed=SEED,
              config=cfg)
    runs, launches, results = {}, {}, {}
    # the allocator's history slows every allocation, so it is recorded
    # apart from the timed calls, over two chunks of the same shapes; it
    # also pays the first call's set-up of the libraries
    tops.reset_launches()
    t1 = time.perf_counter()
    _r, biggest = largest_allocation(
        torch, lambda: atlas_module_preservation(**kw, n_perm=256))
    warm_s = time.perf_counter() - t1
    no_kernel(tops, "data_only largest allocation")
    if biggest >= nn_bytes:
        raise RuntimeError(f"data_only: an allocation of {biggest} bytes")
    screened = dataclasses.replace(cfg, null_precision="bf16_rescue")
    for name, extra in (("materialized", dict(n_perm=N_PERM)),
                        ("streaming", dict(n_perm=N_PERM, store_nulls=False)),
                        ("adaptive_streaming", dict(
                            n_perm=ATLAS_PERM, adaptive=True,
                            store_nulls=False)),
                        ("screened_materialized", dict(
                            n_perm=N_PERM, config=screened))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tops.reset_launches()
        t1 = time.perf_counter()
        res = atlas_module_preservation(**{**kw, **extra})
        wall = time.perf_counter() - t1
        launches[name] = no_kernel(tops, f"data_only {name}")
        peak = torch.cuda.max_memory_allocated()
        if res.observed.shape != (ATLAS_MODULES, 7) or not np.isfinite(
                res.observed).all():
            raise RuntimeError(f"data_only {name}: observed statistics are "
                               "not finite (ATLAS_MODULES, 7)")
        if not ((res.p_values > 0) & (res.p_values <= 1)).all():
            raise RuntimeError(f"data_only {name}: p-values outside (0, 1]")
        if peak >= 8 * 2**30:
            raise RuntimeError(f"data_only {name}: peak {peak} bytes")
        runs[name] = {"wall_s": wall, **{k: res.profile[k] for k in (
            "input_s", "engine_s", "observed_s", "null_s", "perms_per_s")},
            "completed": int(res.completed), "peak_gib": peak / 2**30,
            "launches": launches[name]}
        if res.n_perm_used is not None:
            runs[name]["n_perm_used_sum"] = int(res.n_perm_used.sum())
            runs[name]["n_perm_used_max"] = int(res.n_perm_used.max())
        if "rescue" in res.profile:
            # the screen against the float32 run of the same call: counts
            # and p-values equal, the rescued rows its rows exactly
            ref = results["materialized"]
            equal = int(np.all(res.nulls == ref.nulls, axis=(1, 2)).sum())
            if not (np.array_equal(res.p_values, ref.p_values) and all(
                    np.array_equal(a, b) for a, b in zip(
                        tallies_of(pv, res), tallies_of(pv, ref)))
                    and equal == res.profile["rescue"]["rescued"]):
                raise RuntimeError("data_only screened: counts, p-values or "
                                   "rescued rows differ from the float32 "
                                   "run's")
            runs[name].update(rescue=res.profile["rescue"],
                              rows_equal_f32=equal,
                              f32_null_s=ref.profile["null_s"])
        results[name] = res
    specs = [ModuleSpec(str(i + 1), np.arange(a, a + s), np.arange(a, a + s))
             for i, (a, s) in enumerate(zip(np.cumsum(np.r_[0, msz[:-1]]),
                                            msz))]
    trace = chunk_trace(torch, PermutationEngine(
        None, None, xd, None, None, xt, specs,
        np.arange(ATLAS_GENES, dtype=np.int32),
        config=dataclasses.replace(cfg, network_from_correlation=BETA)))
    no_kernel(tops, "data_only chunk_trace")
    mat, stream = results["materialized"], results["streaming"]
    if not (np.array_equal(mat.p_values, stream.p_values) and all(
            np.array_equal(a, b) for a, b in zip(
                tallies_of(pv, mat), (stream.counts_hi, stream.counts_lo,
                                      stream.counts_eff)))):
        raise RuntimeError("data_only: streaming tallies differ from the "
                           "materialized null's")
    # the acceptance pin: data-only = the dense path on derived matrices
    genes, mods = ATLAS_SMALL
    sd, st, s_labels, _ = atlas_inputs(np, genes, mods, (20, 60), seed=1)
    (rdc, rdn), (rtc, rtn) = dense_reference_stats(sd, st, None, BETA)
    pin = dict(data={"d": sd, "t": st}, module_assignments=s_labels,
               discovery="d", test="t", n_perm=N_PERM, seed=SEED)
    a = atlas_module_preservation(**pin, data_only=BETA, config=cfg)
    b = module_preservation(
        network={"d": rdn, "t": rtn}, correlation={"d": rdc, "t": rtc},
        **pin, config=EngineConfig(chunk_size=128, power_iters=SPARSE_ITERS,
                                   stat_mode="xla"))
    pin_err = float(np.abs(a.nulls - b.nulls).max())
    if not (np.array_equal(a.p_values, b.p_values) and all(
            np.array_equal(x, y) for x, y in zip(tallies_of(pv, a),
                                                 tallies_of(pv, b)))
            and pin_err <= TOL):
        raise RuntimeError(f"data_only at {genes} genes differs from the "
                           f"dense path on the derived matrices ({pin_err})")
    emit({"phase": "data_only", "genes": ATLAS_GENES, "samples": SAMPLES,
          "modules": ATLAS_MODULES, "module_sizes": [int(v) for v in msz],
          "beta": BETA, "n_perm": N_PERM, "adaptive_ceiling": ATLAS_PERM,
          "chunk": 128, "power_iters": SPARSE_ITERS,
          "make_inputs_s": made_s, "float32_nxn_gib": nn_bytes / 2**30,
          "largest_allocation_bytes": int(biggest),
          "largest_allocation_call_s": warm_s, "runs": runs,
          "chunk_trace": trace, "streaming_equals_materialized": True,
          "dense_pin": {"genes": genes, "modules": mods, "n_perm": N_PERM,
                        "p_values_equal": True, "counts_equal": True,
                        "max_abs_null": pin_err},
          "card": card})
    torch.cuda.empty_cache()
    return launches


#: the atlas_build phase (the tile network builder). The screening pair is
#: ``bench.py``'s ``bench_atlas_screen`` shape: genes, samples, sample
#: groups (= screen segments), tile edge, top-k; then the headline row's
#: genes, τ, the grouped τ pair's genes (one tile per sample group) and the
#: dense check's genes
BUILD_GENES, BUILD_SAMPLES, BUILD_GROUPS, BUILD_EDGE, BUILD_K = (
    100_000, 64, 16, 1024, 16)
BUILD_HEADLINE, BUILD_TAU, BUILD_TAU_GENES, BUILD_DENSE = (
    1_000_000, 0.3, 16_384, 4096)
#: the whole script's cut of the τ pairs and of the autotune phase's tile
#: sweep: half the genes (a quarter of the tiles); ``--atlas-build`` and
#: ``--autotune`` keep the widths above
WHOLE_TAU_GENES, WHOLE_TAU_PLANTED, WHOLE_SWEEP_GENES = 8192, 50_000, 50_000
#: a selected r against the host float64 correlation, and the card's
#: against the CPU's: float32 dot products of 64–128 terms err by ~1e-7
BUILD_TOL = 1e-6


def grouped_support(np, genes, samples, groups, seed=0):
    """``bench.py``'s ``_grouped_support_data``: each gene expressed
    (zero-mean within its block) in one sample block, genes sorted by
    block, over a small everywhere-noise floor; float32."""
    rng = np.random.default_rng(seed)
    x = 0.01 * rng.standard_normal((samples, genes)).astype(np.float32)
    gsz, ssz = genes // groups, samples // groups
    for g in range(groups):
        c0, c1 = g * gsz, (g + 1) * gsz if g < groups - 1 else genes
        r0, r1 = g * ssz, (g + 1) * ssz if g < groups - 1 else samples
        blk = rng.standard_normal((r1 - r0, c1 - c0))
        fac = rng.standard_normal(r1 - r0)
        blk += 1.5 * fac[:, None] * (rng.random(c1 - c0) < 0.5)
        x[r0:r1, c0:c1] += (blk - blk.mean(axis=0)).astype(np.float32)
    return x


def same_build(np, a, b) -> bool:
    """Two builds' outputs equal bit for bit."""
    return a.selected_edges == b.selected_edges and all(
        np.array_equal(getattr(getattr(a, g), f), getattr(getattr(b, g), f))
        for g in ("adjacency", "correlation") for f in ("nbr", "wgt"))


def emitted(np, path):
    """``(rows, cols, r)`` in the order a pass emitted them: its final
    checkpoint's COO extras."""
    with np.load(path) as z:
        return z["x_atlas_rows"], z["x_atlas_cols"], z["x_atlas_corr"]


def compare_edges(np, got, want, ref, what, tau=None):
    """Two emitted edge lists held to each other and to the float64
    correlation ``ref``: each r of ``got`` within BUILD_TOL of ``ref``, and
    the lists equal, or different only where values tie to rounding:
    top-k, the emitted sequences of reference |r| equal within BUILD_TOL
    (so only near-equal entries swapped); τ, each edge in one list only
    with a reference |r| within BUILD_TOL of τ. Returns the counts."""
    (gr, gc, gv), (wr, wc, _wv) = got, want
    err = float(np.abs(gv - ref[gr, gc]).max()) if gr.size else 0.0
    if err > BUILD_TOL:
        raise RuntimeError(f"{what}: r off the float64 correlation by {err}")
    swapped = 0
    if not (np.array_equal(gr, wr) and np.array_equal(gc, wc)):
        if tau is None:
            if not np.array_equal(gr, wr):
                raise RuntimeError(f"{what}: rows hold other edge counts")
            gap = float(np.abs(np.abs(ref[gr, gc])
                               - np.abs(ref[wr, wc])).max())
            swapped = int((gc != wc).sum())
        else:
            n = ref.shape[0]
            diff = np.setxor1d(gr * n + gc, wr * n + wc)
            gap = float(np.abs(np.abs(ref.reshape(-1)[diff]) - tau).max())
            swapped = int(diff.size)
        if not gap <= BUILD_TOL:
            raise RuntimeError(f"{what}: the edges differ beyond near-ties "
                               f"({gap})")
    return {"max_abs_r_vs_float64": err, "edges_equal": swapped == 0,
            "near_tie_differences": swapped}


class BuildClock:
    """Splits a build's seconds, while a ``with`` block runs, into the
    builder's dispatches (each tile strip's products, masks and selection
    with the copies to the host, synchronised: device-bound time), the
    final assembly (``SparseAdjacency.from_coo``, host) and the rest (host:
    moments, screening bounds, merges, decoding), by wrapping those
    functions."""

    def __init__(self, torch, tbuilder):
        self.torch, self.tb = torch, tbuilder
        self.s = {"dispatch": 0.0, "assembly": 0.0}

    def _wrap(self, fn, part):
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.torch.cuda.synchronize()
            self.s[part] += time.perf_counter() - t0
            return out
        return timed

    def __enter__(self):
        tb, adj = self.tb, self.tb.SparseAdjacency
        self.saved = (tb._Tiles.strip, tb._Tiles.degree_parts, tb._topk,
                      tb._tau_select, adj.__dict__["from_coo"])
        tb._Tiles.strip = self._wrap(tb._Tiles.strip, "dispatch")
        tb._Tiles.degree_parts = self._wrap(tb._Tiles.degree_parts,
                                            "dispatch")
        tb._topk = self._wrap(tb._topk, "dispatch")
        tb._tau_select = self._wrap(tb._tau_select, "dispatch")
        adj.from_coo = classmethod(self._wrap(
            adj.__dict__["from_coo"].__func__, "assembly"))
        return self

    def __exit__(self, *exc):
        tb = self.tb
        (tb._Tiles.strip, tb._Tiles.degree_parts, tb._topk, tb._tau_select,
         tb.SparseAdjacency.from_coo) = self.saved


def atlas_build_phase(torch, np, card, headline=False) -> dict:
    """The tile network builder on the card
    (``netrep_tpu_torch.atlas.build_sparse_network``), every build after a
    reset of the launch counts and of the peak memory:

    1. dense check at BUILD_DENSE genes (grouped-support data): top-k and
       τ builds against the host float64 ``corr_tile`` reference and
       against the port's ``device="cpu"`` build — edges and emit order
       equal up to near-ties, r within BUILD_TOL; also the warm-up;
    2. the screening pair (``bench_atlas_screen``): BUILD_GENES genes,
       top-k BUILD_K, ``degree=False``, unscreened then screened, equal bit
       for bit; the unscreened pass's bound (2·n_pad²·s FLOP at
       F32_FLOPS, its strips written and read at HBM_BPS) and its share;
    3. τ pairs, equal bit for bit: BUILD_TAU_GENES grouped genes (one
       tile per sample group, so screening skips), and ATLAS_GENES of the
       atlas shape's planted data (128 samples: the grouped data would keep
       ~4.7e8 edges at τ = 0.3, 4 samples per group); without
       ``headline`` (the whole script) WHOLE_TAU_GENES grouped genes and
       the first WHOLE_TAU_PLANTED planted ones;
    4. with ``headline`` (``--atlas-build`` only: ~140 s), the headline
       row: BUILD_HEADLINE grouped genes, screened top-k;
    5. the bridge (``bench_atlas``): ATLAS_GENES genes, ATLAS_MODULES
       planted modules, top-k BUILD_K with degrees, then
       ``sparse_module_preservation`` on the graph with N_PERM
       permutations — finite (ATLAS_MODULES, 7) observed statistics.

    Each build reports seconds, genes/s, peak GiB, its tile tallies and
    its seconds split (:class:`BuildClock`). No kernel of the port
    launches (``no_kernel``); returns the launch counts."""
    import os

    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.atlas import TiledNetwork, build_sparse_network
    from netrep_tpu_torch.atlas import builder as tbuilder
    from netrep_tpu_torch.models.sparse_api import sparse_module_preservation
    from netrep_tpu_torch.utils.config import EngineConfig

    ckdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "atlas_build")
    os.makedirs(ckdir, exist_ok=True)
    launches, runs = {}, {}

    def run(label, tn, **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tops.reset_launches()
        with BuildClock(torch, tbuilder) as clock:
            t0 = time.perf_counter()
            b = build_sparse_network(tn, **kw)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
        parts = clock.s
        launches[label] = no_kernel(tops, f"atlas_build {label}")
        runs[label] = {
            "genes": tn.n, "samples": tn.n_samples, "seconds": s,
            "genes_per_s": tn.n / s,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "dispatch_s": parts["dispatch"],
            "assembly_s": parts["assembly"],
            "host_loop_s": s - parts["dispatch"] - parts["assembly"],
            "tile_edge": b.tile_edge, "supertile": b.supertile,
            "tiles_total": b.tiles_total,
            "tiles_dispatched": b.tiles_dispatched,
            "tiles_skipped": b.tiles_skipped,
            "skipped_share": b.tiles_skipped / b.tiles_total,
            "strip_bytes_moved": b.strip_bytes_moved,
            "strip_bytes_full": b.strip_bytes_full,
            "selected_edges": b.selected_edges,
            "launches": launches[label]}
        return b

    # 1. dense check, card and CPU against host float64
    x = grouped_support(np, BUILD_DENSE, BUILD_SAMPLES, BUILD_GROUPS, seed=1)
    tn = TiledNetwork.from_data(x, BETA)
    ref = tn.corr_tile(slice(None), slice(None))
    np.fill_diagonal(ref, 0.0)
    a = np.abs(ref)
    np.fill_diagonal(a, -1.0)
    top = np.argsort(-a, axis=1, kind="stable")[:, :BUILD_K]
    want_topk = (np.repeat(np.arange(BUILD_DENSE), BUILD_K), top.reshape(-1),
                 ref[np.arange(BUILD_DENSE)[:, None], top].reshape(-1))
    sel = a >= BUILD_TAU
    want_tau = (*np.nonzero(sel), ref[sel])
    dense = {}
    for rule, kw, want in (("topk", dict(top_k=BUILD_K), want_topk),
                           ("tau", dict(tau=BUILD_TAU), want_tau)):
        got = {}
        for dev in ("cuda", "cpu"):
            path = os.path.join(ckdir, f"dense_{rule}_{dev}.npz")
            if os.path.exists(path):
                os.remove(path)
            kwd = dict(kw, checkpoint_path=path, checkpoint_every=1,
                       device=dev)
            if dev == "cuda":
                run(f"dense {rule}", tn, **kwd)
            else:
                build_sparse_network(tn, **kwd)
            got[dev] = emitted(np, path)
        tau = BUILD_TAU if rule == "tau" else None
        dense[rule] = {
            "vs_float64": compare_edges(np, got["cuda"], want, ref,
                                        f"dense {rule} card", tau),
            "cpu_vs_float64": compare_edges(np, got["cpu"], want, ref,
                                            f"dense {rule} cpu", tau),
            "card_vs_cpu": compare_edges(np, got["cuda"], got["cpu"], ref,
                                         f"dense {rule} card vs cpu", tau),
            "card_vs_cpu_max_abs_r": float(np.abs(
                got["cuda"][2] - got["cpu"][2]).max())
            if np.array_equal(got["cuda"][1], got["cpu"][1]) else None}
    del x, tn, ref, a, sel, want_topk, want_tau

    # 2. the screening pair at BUILD_GENES
    pair = dict(top_k=BUILD_K, tile_edge=BUILD_EDGE, degree=False,
                screen_segments=BUILD_GROUPS)
    t0 = time.perf_counter()
    x = grouped_support(np, BUILD_GENES, BUILD_SAMPLES, BUILD_GROUPS)
    tn = TiledNetwork.from_data(x, BETA)
    made_s = time.perf_counter() - t0
    un = run("topk unscreened", tn, **pair)
    sc = run("topk screened", tn, screen=True, **pair)
    if not same_build(np, un, sc):
        raise RuntimeError("atlas_build: the screened top-k pass differs "
                           "from the unscreened one")
    n_pad = -(-BUILD_GENES // un.tile_edge) * un.tile_edge
    flop_ms = 2 * n_pad ** 2 * BUILD_SAMPLES / F32_FLOPS * 1e3
    byte_ms = 2 * 4 * n_pad * n_pad / HBM_BPS * 1e3
    bound = {"n_pad": n_pad, "flop_ms": flop_ms, "strip_bytes_ms": byte_ms,
             "bound_ms": max(flop_ms, byte_ms),
             "bound_by": "operations" if flop_ms > byte_ms else "bytes",
             "share_of_bound": max(flop_ms, byte_ms) / (
                 runs["topk unscreened"]["seconds"] * 1e3)}
    del x, tn, un, sc

    # 3. τ pairs: grouped (screening skips) and the planted atlas data
    xd, xt, labels, msz = atlas_inputs(np, ATLAS_GENES, ATLAS_MODULES,
                                       ATLAS_SIZES)
    planted = TiledNetwork.from_data(xd, BETA)
    tau_genes = BUILD_TAU_GENES if headline else WHOLE_TAU_GENES
    for label, tn in (
            ("grouped", TiledNetwork.from_data(grouped_support(
                np, tau_genes, BUILD_SAMPLES, BUILD_GROUPS), BETA)),
            ("planted", planted if headline else TiledNetwork.from_data(
                np.ascontiguousarray(xd[:, :WHOLE_TAU_PLANTED]), BETA))):
        kw = dict(tau=BUILD_TAU, tile_edge=BUILD_EDGE, degree=False,
                  screen_segments=BUILD_GROUPS)
        un = run(f"tau {label} unscreened", tn, **kw)
        sc = run(f"tau {label} screened", tn, screen=True, **kw)
        if not same_build(np, un, sc):
            raise RuntimeError(f"atlas_build: the screened τ pass ({label}) "
                               "differs from the unscreened one")
        del un, sc

    # 4. the headline row
    headline_made_s = None
    if headline:
        t0 = time.perf_counter()
        tn = TiledNetwork.from_data(grouped_support(
            np, BUILD_HEADLINE, BUILD_SAMPLES, BUILD_GROUPS), BETA)
        headline_made_s = time.perf_counter() - t0
        run("headline topk screened", tn, screen=True, **pair)
        del tn

    # 5. the bridge to the sparse engine
    build = run("bridge topk degree", planted, top_k=BUILD_K)
    if not (build.degree is not None and np.isfinite(build.degree).all()):
        raise RuntimeError("atlas_build: the bridge's degrees")
    cfg = EngineConfig(chunk_size=128, power_iters=SPARSE_ITERS)
    kw = dict(discovery_data=xd, test_data=xt, seed=SEED, config=cfg)
    sparse_module_preservation(build.adjacency, build.adjacency, labels,
                               n_perm=128, **kw)      # warm-up
    tops.reset_launches()
    t0 = time.perf_counter()
    res = sparse_module_preservation(build.adjacency, build.adjacency,
                                     labels, n_perm=N_PERM, **kw)
    wall = time.perf_counter() - t0
    launches["bridge sparse_module_preservation"] = no_kernel(
        tops, "atlas_build bridge sparse_module_preservation")
    if res.observed.shape != (ATLAS_MODULES, 7) or not np.isfinite(
            res.observed).all() or res.completed != N_PERM:
        raise RuntimeError("atlas_build bridge: observed statistics are not "
                           f"finite ({ATLAS_MODULES}, 7)")
    emit({"phase": "atlas_build", "beta": BETA, "top_k": BUILD_K,
          "tau": BUILD_TAU, "screen_segments": BUILD_GROUPS,
          "tolerance": BUILD_TOL, "make_inputs_s": made_s,
          "headline_make_inputs_s": headline_made_s,
          "dense_check": {"genes": BUILD_DENSE, **dense},
          "screened_equals_unscreened": True,
          "unscreened_topk_bound": bound, "runs": runs,
          "bridge": {"genes": ATLAS_GENES, "modules": ATLAS_MODULES,
                     "module_sizes": [int(v) for v in msz],
                     "nnz": build.adjacency.nnz, "k_padded": build.adjacency.k,
                     "n_perm": N_PERM, "wall_s": wall, **res.profile,
                     "observed_finite": True,
                     "launches": launches[
                         "bridge sparse_module_preservation"]},
          "card": card})
    torch.cuda.empty_cache()
    return launches


#: the autotune phase: the main path's streaming null at this many
#: permutations (32 chunks of 128), each superchunk twice in alternated
#: order, then the atlas tile pass's edges and super-tile factors
AUTOTUNE_PERM = 4096
AUTOTUNE_SUPERCHUNKS = (1, 2, 4, 8, 16, 32)
AUTOTUNE_EDGES = (512, 1024, 2048)
AUTOTUNE_SUPERTILES = (4, 8, 16)
#: the whole script's shorter sweep (``--autotune`` runs the one above):
#: the edges and super-tile factors without 512 and 4, which ran 49–53%
#: and 11–20% below the best in every earlier sweep (PERF.md §5)
WHOLE_EDGES, WHOLE_SUPERTILES = (1024, 2048), (8, 16)


def best_median(entries: dict):
    """``(setting, median)`` of the best median rate among ``{setting:
    [rate, ...]}`` — the store's rule, recomputed here from its file."""
    med = {int(k): sorted(v)[len(v) // 2] for k, v in entries.items() if v}
    best = max(med, key=med.get)
    return best, med[best]


def autotune_phase(torch, np, tops, module_preservation, kw, card,
                   full: bool = True) -> None:
    """``autotune``: the measured autotune store
    (``netrep_tpu_torch.utils.autotune``) on a fresh temporary store.

    (a) The main path's fused streaming null, ``AUTOTUNE_PERM``
    permutations, with an explicit superchunk of each of
    ``AUTOTUNE_SUPERCHUNKS`` (``full``: each twice with the order
    alternated; the whole script runs one pass, and (b) over WHOLE_EDGES
    and WHOLE_SUPERTILES, to keep its time); then a
    default run, which must resolve (its ``autotune_hit`` event) to the
    setting with the best median rate in the store's file. Counts and
    p-values of every run equal each other bit for bit, and each run
    launches the fused counts kernel. Superchunk 32 is one superchunk of
    the 32 chunks: no steady interval, so nothing is recorded for it.

    (b) The ``--atlas-build`` screening pair's build (``BUILD_GENES``
    grouped genes, the whole script WHOLE_SWEEP_GENES; top-k ``BUILD_K``,
    no degrees) at each tile edge of
    ``AUTOTUNE_EDGES``, and screened at edge 1,024 with each super-tile
    factor of ``AUTOTUNE_SUPERTILES``; then a default build of each kind,
    which must resolve to the best. The screened builds equal the
    1,024-edge build bit for bit; the phase prints how many edges of each
    build's graph are not in the 1,024-edge build's graph and the other
    way round. No kernel of the port launches."""
    import shutil
    import tempfile

    from netrep_tpu_torch.atlas import TiledNetwork, build_sparse_network
    from netrep_tpu_torch.utils import autotune
    from netrep_tpu_torch.utils import telemetry as tm
    from netrep_tpu_torch.utils.config import EngineConfig

    os.makedirs(build_dir(), exist_ok=True)
    top = tempfile.mkdtemp(prefix="autotune_", dir=build_dir())
    before = os.environ.get(autotune.STORE_ENV)
    os.environ[autotune.STORE_ENV] = os.path.join(top, "store")
    t_phase = time.perf_counter()
    try:
        # ---- (a) the streaming null's superchunk --------------------------
        order = AUTOTUNE_SUPERCHUNKS + (AUTOTUNE_SUPERCHUNKS[::-1]
                                        if full else ())
        runs, ref = [], None

        def stream(config, telemetry=None):
            tops.reset_launches()
            t0 = time.perf_counter()
            res = module_preservation(**{**kw, "n_perm": AUTOTUNE_PERM},
                                      store_nulls=False, config=config,
                                      telemetry=telemetry)
            wall = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in tops.kernels()}
            if launches["fused_stats_counts"] == 0:
                raise RuntimeError("autotune: the streaming null launched "
                                   "no fused_stats_counts kernel")
            nonlocal ref
            got = (res.p_values, res.counts_hi, res.counts_lo,
                   res.counts_eff)
            if ref is None:
                ref = got
            elif not all(np.array_equal(a, b) for a, b in zip(got, ref)):
                raise RuntimeError("autotune: counts or p-values differ "
                                   f"with superchunk {config.superchunk}")
            if res.completed != AUTOTUNE_PERM:
                raise RuntimeError(f"autotune: completed {res.completed}")
            return res, wall, launches["fused_stats_counts"]

        for k in order:
            res, wall, n_launch = stream(EngineConfig(superchunk=k))
            runs.append({"superchunk": k, "null_s": res.profile["null_s"],
                         "perms_per_s": res.profile["perms_per_s"],
                         "wall_s": wall, "launches": n_launch})
        path = autotune.default_path(kw["device"])
        with open(path) as f:
            entries = json.load(f)["entries"]
        if len(entries) != 1:
            raise RuntimeError(f"autotune: {len(entries)} keys after one "
                               f"problem shape's sweep: {sorted(entries)}")
        (key, samples), = entries.items()
        want, want_med = best_median(samples)
        events = os.path.join(top, "default.jsonl")
        res, wall, n_launch = stream(EngineConfig(), telemetry=events)
        hits = [e["data"] for e in tm.read_events(events)
                if e["ev"] in ("autotune_hit", "autotune_miss")]
        starts = [e["data"]["superchunk"] for e in tm.read_events(events)
                  if e["ev"] == "null_run_start"]
        if ([h.get("setting") for h in hits] != [want]
                or starts != [want]):
            raise RuntimeError(f"autotune: the default run resolved "
                               f"{hits} / {starts}, the best median is "
                               f"{want}")
        null = {"key": key, "n_perm": AUTOTUNE_PERM,
                "chunk": EngineConfig().chunk_size, "runs": runs,
                "recorded_perms_per_s": {int(k): v for k, v in
                                         sorted(samples.items(),
                                                key=lambda kv: int(kv[0]))},
                "best_median": {"superchunk": want,
                                "perms_per_s": want_med},
                "default": {"resolved": want,
                            "null_s": res.profile["null_s"],
                            "perms_per_s": res.profile["perms_per_s"],
                            "wall_s": wall, "launches": n_launch},
                "counts_and_p_values_bit_equal": True}
        del res, ref

        # ---- (b) the atlas tile pass's edge and super-tile factor ---------
        genes = BUILD_GENES if full else WHOLE_SWEEP_GENES
        x = grouped_support(np, genes, BUILD_SAMPLES, BUILD_GROUPS)
        tn = TiledNetwork.from_data(x, BETA)
        del x
        pair = dict(top_k=BUILD_K, degree=False,
                    screen_segments=BUILD_GROUPS)
        builds, edges = {}, {}

        def build(label, **kw2):
            tops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = build_sparse_network(tn, device=kw["device"], **pair, **kw2)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            no_kernel(tops, f"autotune {label}")
            # the graph's edges (i, j), i < j, as one int64 each
            nbr = b.adjacency.nbr.astype(np.int64)
            rows = np.broadcast_to(np.arange(tn.n)[:, None], nbr.shape)
            keep = nbr < rows
            edges[label] = nbr[keep] * tn.n + rows[keep]
            builds[label] = {"tile_edge": b.tile_edge,
                             "supertile": b.supertile, "seconds": s,
                             "genes_per_s": tn.n / s,
                             "tiles_dispatched": b.tiles_dispatched,
                             "tiles_skipped": b.tiles_skipped,
                             "selected_edges": b.selected_edges}
            return b

        base = {e: build(f"edge {e}", tile_edge=e)
                for e in (AUTOTUNE_EDGES if full else WHOLE_EDGES)}
        for st in AUTOTUNE_SUPERTILES if full else WHOLE_SUPERTILES:
            b = build(f"screened supertile {st}", tile_edge=1024,
                      screen=True, supertile=st)
            if not same_build(np, b, base[1024]):
                raise RuntimeError(f"autotune: the screened build (super-"
                                   f"tile {st}) differs from the unscreened")
        with open(path) as f:
            entries = json.load(f)["entries"]
        resolved = {}
        for label, screen, field in (("default", False, "tile_edge"),
                                     ("default screened", True,
                                      "supertile")):
            kind = "atlas-screen" if screen else "atlas-tiles"
            (k_, samples), = [(k, v) for k, v in entries.items()
                              if f"|{kind}|" in k
                              and k.endswith("topk")]
            want, want_med = best_median(samples)
            b = build(label, screen=screen)
            if getattr(b, field) != want:
                raise RuntimeError(f"autotune: the {label} build resolved "
                                   f"{field} {getattr(b, field)}, the best "
                                   f"median is {want}")
            if b.tile_edge in base and not same_build(np, b,
                                                      base[b.tile_edge]):
                raise RuntimeError(f"autotune: the {label} build differs "
                                   "from the explicit build at its edge")
            resolved[label] = {"key": k_, field: want,
                               "rows_per_s_median": want_med,
                               "recorded_rows_per_s": samples}
        ref_edges = edges["edge 1024"]
        for label, e in edges.items():
            builds[label]["edges_not_in_1024"] = int(
                np.setdiff1d(e, ref_edges).size)
            builds[label]["edges_of_1024_not_in"] = int(
                np.setdiff1d(ref_edges, e).size)
        del tn, base, b, edges, ref_edges
        torch.cuda.empty_cache()
    finally:
        if before is None:
            os.environ.pop(autotune.STORE_ENV, None)
        else:
            os.environ[autotune.STORE_ENV] = before
        shutil.rmtree(top, ignore_errors=True)
    emit({"phase": "autotune", "null": null,
          "atlas": {"genes": genes, "samples": BUILD_SAMPLES,
                    "top_k": BUILD_K, "builds": builds,
                    "resolved": resolved},
          "s": time.perf_counter() - t_phase, "card": card})


#: the fault_ladder phase: the hang's timeout (well above a warm chunk,
#: which takes milliseconds at the main path's width), and the CUDA
#: runtime's error codes whose texts the taxonomy classifies, with the
#: class each must get (cudaError_t values of the CUDA runtime API)
HANG_TIMEOUT_S = 2.0
#: the fault_ladder phase's depth: rounds of the policy/telemetry
#: alternation, and chunks of the profiled null (3 and 40 before the
#: whole script had to fit its limit)
FAULT_ROUNDS, PROFILE_CHUNKS = 2, 24
CUDA_CODES = {2: "fatal", 46: "device_lost", 100: "device_lost",
              214: "device_lost", 220: "device_lost", 700: "fatal",
              710: "fatal", 715: "fatal", 716: "fatal", 719: "fatal"}


def cuda_vocabulary(torch) -> dict:
    """The CUDA runtime's and NVML's own texts of the errors the fault
    taxonomy names, each classified as ``RuntimeError("CUDA error:
    <text>")`` (how torch raises them); fails unless each gets its class.
    NVML's "GPU is lost" is read where libnvidia-ml loads."""
    import ctypes

    from netrep_tpu_torch.utils.faults import classify_error

    rt = _cudart(torch)
    rt.cudaGetErrorString.restype = ctypes.c_char_p
    rt.cudaGetErrorString.argtypes = [ctypes.c_int]
    texts = {}
    for code, want in CUDA_CODES.items():
        text = rt.cudaGetErrorString(code).decode()
        got = classify_error(RuntimeError(f"CUDA error: {text}"))
        if got != want:
            raise RuntimeError(f"cudaError {code} {text!r} classifies as "
                               f"{got}, expected {want}")
        texts[code] = {"text": text, "class": got}
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
        nvml.nvmlErrorString.restype = ctypes.c_char_p
        nvml.nvmlErrorString.argtypes = [ctypes.c_int]
        text = nvml.nvmlErrorString(15).decode()  # NVML_ERROR_GPU_IS_LOST
        got = classify_error(RuntimeError(text))
        if got != "device_lost":
            raise RuntimeError(f"NVML {text!r} classifies as {got}")
        texts["nvml_15"] = {"text": text, "class": got}
    except OSError:
        texts["nvml_15"] = None
    return texts


def alternate(torch, runs: dict, rounds: int = 1) -> dict:
    """Seconds of each zero-argument run, the runs alternated in mirrored
    order (A B ... B A) ``rounds`` times over, so that a drift of the
    host's clock falls on every run alike: ``{name: [s, ...]}``."""
    names = list(runs)
    order = (names + names[::-1]) * rounds
    out = {n: [] for n in names}
    for n in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[n]()
        torch.cuda.synchronize()
        out[n].append(time.perf_counter() - t0)
    return out


def fault_ladder_phase(torch, np, drive, labels, disc, test, refs, card,
                       dev) -> dict:
    """The fault ladder at the main path's width, each faulted call held to
    the unfaulted run of the same call (``refs``: the fused materialized,
    fused streaming and composed streaming runs; None computes them):

    1. fused streaming (superchunks of one chunk), plan
       ``"transient@256x2;hang@512"``: counts and p-values bit for bit;
       three ``retry_attempt`` (two transient failures, one after the
       abandoned hang) and one ``chunk_abandoned``; the fused kernel
       launched exactly as unfaulted (8 chunks × B buckets — an injected
       fault fires before its dispatch launches anything);
    2. fused materialized on ``make_mesh(2, 1)`` over the one card, plan
       ``"device_lost_partial@384;capacity_restored@640"``: the mesh
       shrinks to 1×1 and grows back (``mesh_shrunk``, ``mesh_grown``),
       the null bit for bit; launches (3·2 + 3 + 2·2)·B — three 2-shard
       chunks before the loss, three 1×1 chunks to the grow-back
       boundary, two 2-shard chunks after;
    3. fused materialized, plan ``"device_lost@896"``: with
       ``degrade_to_cpu=True`` the last chunk runs on the CPU through the
       plain version (its permutations the card's, its rows within TOL of
       the card's, the rows before bit for bit, ``degraded_to_cpu`` and
       ``result.profile["degraded"]``; 7·B launches on the card); with
       ``degrade_to_cpu=False`` the loss raises after the failure-save and
       the same call resumes on the card to the unfaulted run;
    4. composed streaming (the gather kernel), plan ``"transient@128"``:
       counts bit for bit, 2 gather launches per chunk;
    5. the background writer: one engine's materialized null with a
       checkpoint every chunk, saved synchronously, through the writer,
       and without checkpoints (alternated); and a run interrupted after
       three chunks under the writer, resumed to the unfaulted run;
    6. the per-chunk cost of a policy (its synchronisation in the retry
       scope) and of telemetry, alternated against neither on the same
       engine, and the telemetry file read back through
       ``aggregate_file``;
    7. ``profile=`` on the fused streaming call (PROFILE_CHUNKS chunks of
       permutations in superchunks of one chunk, so the null has a steady
       window), twice,
       each beside the same call unprofiled: the null's device busy and
       idle share (median and spread) and its top five operations by
       device time, the profiled and unprofiled null seconds, and counts
       equal across the four calls.

    Returns the launches by path."""
    import os
    import shutil
    import tempfile

    from netrep_tpu_torch import random as trandom
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.utils import faults as flt
    from netrep_tpu_torch.utils import profiling as prof
    from netrep_tpu_torch.utils.config import EngineConfig, FaultPolicy
    from netrep_tpu_torch.utils.telemetry import Telemetry, aggregate_file

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    top = tempfile.mkdtemp(prefix="faults_", dir=root)
    cfg = EngineConfig()
    C = cfg.chunk_size
    chunks = -(-N_PERM // C)
    many = "gather_submatrix_fused_many"
    composed_cfg = EngineConfig(stat_mode="xla", gather_mode="fused")
    emit({"phase": "fault_vocabulary", "cuda": cuda_vocabulary(torch),
          "card": card})
    if refs.get("fused") is None:
        refs["fused"] = drive("fault_ref", ["fused_stats_values"],
                              config=cfg)[0]
    if refs.get("stream") is None:
        refs["stream"] = drive("fault_ref", ["fused_stats_counts"],
                               config=cfg, store_nulls=False)[0]
    if refs.get("composed_stream") is None:
        refs["composed_stream"] = drive("fault_ref", [many], config=
                                        composed_cfg, store_nulls=False)[0]

    def bus():
        # in memory; the watchdog thread off, so no timing adds an event
        return Telemetry(watchdog_poll_s=0)

    def counted(b):
        return {k[:-6]: int(v) for k, v in b.metrics.counters.items()
                if k.endswith(".count")}

    def same_counts(res, ref):
        return (np.array_equal(res.p_values, ref.p_values) and all(
            np.array_equal(getattr(res, f), getattr(ref, f))
            for f in ("counts_hi", "counts_lo", "counts_eff")))

    launches, report = {}, {}
    t_phase = time.perf_counter()
    try:
        # the timing engine: its bucket count derives the launch counts
        eng_cfg = EngineConfig(superchunk=1)
        engine = make_engine(np, labels, disc, test, eng_cfg, dev)
        B = len(engine.buckets)

        # ---- 1. transient and hang on the fused streaming null --------
        b = bus()
        res, used, _ = drive(
            "fault_ladder", ["fused_stats_counts"],
            {"fused_stats_counts": chunks * B}, config=eng_cfg,
            store_nulls=False, telemetry=b,
            fault_policy=FaultPolicy(plan="transient@256x2;hang@512",
                                     hang_timeout_s=HANG_TIMEOUT_S))
        ev = counted(b)
        want = {"fault_injected": 3, "retry_attempt": 3,
                "chunk_abandoned": 1}
        if not same_counts(res, refs["stream"]) or any(
                ev.get(k, 0) != n for k, n in want.items()):
            raise RuntimeError(f"fault_ladder transient+hang: counts or "
                               f"events differ ({ev})")
        launches["transient_hang"] = used
        report["transient_hang"] = {
            "events": {k: ev.get(k, 0) for k in want},
            "counts_equal_unfaulted": True, "buckets": B,
            "launches": used["fused_stats_counts"],
            "null_s": res.profile["null_s"],
            "unfaulted_null_s": refs["stream"].profile["null_s"]}

        # ---- 2. shrink and grow back on a 2x1 perm mesh ---------------
        b = bus()
        mesh = make_mesh(2, 1, devices=[dev] * 2)
        res, used, _ = drive(
            "fault_ladder", ["fused_stats_values"],
            {"fused_stats_values": (3 * 2 + 3 + 2 * 2) * B}, config=cfg,
            mesh=mesh, telemetry=b, fault_policy=FaultPolicy(
                plan="device_lost_partial@384;capacity_restored@640"))
        ev = counted(b)
        unsplit = bool(np.array_equal(res.nulls, refs["fused"].nulls))
        if not unsplit:
            ref = drive("fault_ref", ["fused_stats_values"], config=cfg,
                        mesh=mesh)[0]
            if not np.array_equal(res.nulls, ref.nulls):
                raise RuntimeError("fault_ladder shrink/grow: the null "
                                   "differs from the unfaulted mesh run")
        if (ev.get("mesh_shrunk") != 1 or ev.get("mesh_grown") != 1
                or not np.array_equal(res.p_values,
                                      refs["fused"].p_values)):
            raise RuntimeError(f"fault_ladder shrink/grow: {ev}")
        launches["shrink_grow"] = used
        report["shrink_grow"] = {
            "events": {k: ev.get(k, 0) for k in (
                "device_lost", "mesh_shrunk", "mesh_grown",
                "checkpoint_async_flush")},
            "nulls_equal_unsplit_run": unsplit, "buckets": B,
            "launches": used["fused_stats_values"],
            "null_s": res.profile["null_s"]}

        # ---- 3. a total loss: the CPU rung, or an error after the save -
        b = bus()
        res, used, _ = drive(
            "fault_ladder", ["fused_stats_values"],
            {"fused_stats_values": 7 * B}, config=cfg, telemetry=b,
            fault_policy=FaultPolicy(plan="device_lost@896",
                                     degrade_to_cpu=True))
        ref = refs["fused"]
        deg = res.profile.get("degraded")
        key = trandom.key(SEED, device=dev)
        pool = torch.arange(GENES, dtype=torch.int32)
        cpu_perm = trandom.permutation(trandom.perm_keys(
            trandom.key(SEED, device="cpu"), 896, N_PERM - 896), pool)
        card_perm = trandom.permutation(
            trandom.perm_keys(key, 896, N_PERM - 896), pool.to(dev)).cpu()
        cpu_err = float(np.nanmax(np.abs(res.nulls[896:] - ref.nulls[896:])))
        if (deg is None or deg["at_perm"] != 896
                or counted(b).get("degraded_to_cpu") != 1
                or not torch.equal(cpu_perm, card_perm)
                or not np.array_equal(res.nulls[:896], ref.nulls[:896])
                or cpu_err > TOL):
            raise RuntimeError(f"fault_ladder CPU rung: {deg}, "
                               f"{counted(b)}, rows err {cpu_err}")
        hi, lo, _eff = pv.tail_counts(res.observed, res.nulls)
        report["cpu_rung"] = {
            "degraded": deg, "index_sets_equal": True,
            "rows_before_bit_equal": True, "cpu_rows_max_abs_err": cpu_err,
            "tolerance": TOL,
            "p_values_differing": int((res.p_values != ref.p_values).sum()),
            "counts_hi_sum": int(hi.sum()), "counts_lo_sum": int(lo.sum()),
            "launches": used["fused_stats_values"],
            "null_s": res.profile["null_s"]}
        launches["cpu_rung"] = used
        d = os.path.join(top, "raise")
        try:
            drive("fault_ladder", ["fused_stats_values"], config=cfg,
                  checkpoint_dir=d, fault_policy=FaultPolicy(
                      plan="device_lost@896", degrade_to_cpu=False))
            raise RuntimeError("fault_ladder: degrade_to_cpu=False "
                               "returned instead of raising")
        except flt.InjectedDeviceLost as e:
            raised = type(e).__name__
        res, used, _ = drive("fault_ladder", ["fused_stats_values"],
                             {"fused_stats_values": B}, config=cfg,
                             checkpoint_dir=d)
        if not np.array_equal(res.nulls, ref.nulls):
            raise RuntimeError("fault_ladder: the resumed run differs")
        report["no_cpu_rung"] = {"raised": raised,
                                 "resumed_equal_unfaulted": True,
                                 "resumed_launches":
                                     used["fused_stats_values"]}

        # ---- 4. a transient fault on the composed (gather) null -------
        res, used, _ = drive(
            "fault_ladder", [many], {many: chunks * 2}, config=composed_cfg,
            store_nulls=False, fault_policy=FaultPolicy(plan="transient@128"))
        if not same_counts(res, refs["composed_stream"]):
            raise RuntimeError("fault_ladder composed: counts differ")
        launches["composed_transient"] = used
        report["composed_transient"] = {"counts_equal_unfaulted": True,
                                        "launches": used[many]}

        # ---- 5. the background writer, a checkpoint every chunk -------
        path = os.path.join(top, "w.npz")

        def saving(policy):
            def go():
                if os.path.exists(path):
                    os.unlink(path)
                engine.run_null(N_PERM, key=SEED, checkpoint_path=path,
                                checkpoint_every=C, fault_policy=policy)
            return go

        secs = alternate(torch, {
            "none": lambda: engine.run_null(N_PERM, key=SEED),
            "sync": saving(FaultPolicy(async_checkpoint=False)),
            "async": saving(FaultPolicy()),
        })
        mean = {k: float(np.mean(v)) for k, v in secs.items()}
        stop = []

        def interrupt(done, total):
            stop.append(done)
            if len(stop) == 3:
                raise KeyboardInterrupt

        d = os.path.join(top, "resume")
        part, _u, _ = drive("fault_ladder", ["fused_stats_values"],
                            completed=3 * C, config=cfg, checkpoint_dir=d,
                            checkpoint_every=C, progress=interrupt,
                            fault_policy=FaultPolicy())
        res, _u, _ = drive("fault_ladder", ["fused_stats_values"],
                           config=cfg, checkpoint_dir=d, checkpoint_every=C,
                           fault_policy=FaultPolicy())
        if not np.array_equal(res.nulls, refs["fused"].nulls):
            raise RuntimeError("fault_ladder: the writer's checkpoint "
                               "resumed to another null")
        report["async_writer"] = {
            "null_s": secs, "mean_s": mean,
            "save_cost_s": {"sync": mean["sync"] - mean["none"],
                            "async": mean["async"] - mean["none"]},
            "hidden_share": (1 - (mean["async"] - mean["none"])
                             / (mean["sync"] - mean["none"])
                             if mean["sync"] > mean["none"] else None),
            "saves_per_run": chunks, "interrupted_at": int(part.completed),
            "resumed_equal_unfaulted": True}

        # ---- 6. per-chunk cost of a policy and of telemetry -----------
        observed = engine.observed()
        tel_path = os.path.join(top, "run.jsonl")
        def streaming(**kw):
            return lambda: engine.run_null_streaming(N_PERM, observed,
                                                     key=SEED, **kw)

        secs = alternate(torch, {
            "off": streaming(),
            "policy": streaming(fault_policy=FaultPolicy()),
            "telemetry": streaming(telemetry=Telemetry(
                tel_path, watchdog_poll_s=0)),
            # both, the watchdog thread off: the escalation is not wired
            "policy_telemetry": streaming(
                fault_policy=FaultPolicy(),
                telemetry=Telemetry(watchdog_poll_s=0)),
            # both at the default poll: every dispatch runs on a worker
            # thread the watchdog's escalation can walk away from
            "policy_telemetry_watchdog": streaming(
                fault_policy=FaultPolicy(), telemetry=Telemetry()),
        }, rounds=FAULT_ROUNDS)
        mean = {k: float(np.mean(v)) for k, v in secs.items()}
        reg = aggregate_file(tel_path)
        # what telemetry does a chunk, each part alone: the memory gauges,
        # one flushed JSONL event, and a span push
        probe = prof.make_memory_probe(dev)
        parts_bus = Telemetry(os.path.join(top, "parts.jsonl"),
                              watchdog_poll_s=0)

        def each_ms(fn, n=200):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t0) / n * 1e3

        def span():
            with parts_bus.pushed(parts_bus.new_span_id()):
                pass

        parts_ms = {
            "memory_gauges": each_ms(probe) if probe is not None else None,
            "emit": each_ms(lambda: parts_bus.emit(
                "chunk", done=1, total=1, take=1, s=0.1, dispatches=2,
                host_bytes=1, transfer_s=0.1)),
            "span": each_ms(span),
        }
        parts_bus.close()
        report["overheads"] = {
            "mode": "fused streaming, superchunk 1", "chunks": chunks,
            "null_s": secs, "mean_s": mean,
            "per_chunk_ms": {k: (mean[k] - mean["off"]) / chunks * 1e3
                             for k in ("policy", "telemetry",
                                       "policy_telemetry",
                                       "policy_telemetry_watchdog")},
            "telemetry_counters": {k: v for k, v in reg.counters.items()
                                   if k.startswith(("superchunk.",
                                                    "dispatch.",
                                                    "compile_span."))},
            "telemetry_events": reg.n_events,
            "telemetry_parts_ms": parts_ms}
        del engine
        torch.cuda.empty_cache()

        # ---- 7. profile=: the null's device busy and idle share -------
        # a null long enough for a steady window (superchunks of one
        # chunk), profiled twice, each beside the same call unprofiled
        # (P U P U); the counts of all four agree
        n_prof = PROFILE_CHUNKS * C
        want = {"fused_stats_counts": PROFILE_CHUNKS * B}
        runs, plain_s, first = [], [], None
        for i in range(2):
            trace = os.path.join(top, f"profile{i}")
            res, used, _ = drive("fault_ladder", ["fused_stats_counts"],
                                 want, completed=n_prof, n_perm=n_prof,
                                 config=eng_cfg, store_nulls=False,
                                 profile=trace)
            plain, _u, _ = drive("fault_ladder", ["fused_stats_counts"],
                                 want, completed=n_prof, n_perm=n_prof,
                                 config=eng_cfg, store_nulls=False)
            first = first or plain
            if not (same_counts(res, first) and same_counts(plain, first)):
                raise RuntimeError("fault_ladder profile: counts differ")
            rows, split = prof.summarize_trace(trace, top=5, split=True,
                                               span=prof.NULL_SPAN)
            runs.append({
                "null_split": split,
                "whole_call_split": prof.trace_time_split(trace),
                "null_top5": [{"op": n, "ms": ms, "percent": pc}
                              for n, ms, pc in rows],
                "null_s": res.profile["null_s"],
                "steady_chunk_ms": res.profile["steady_chunk_ms"],
                "compile_chunk_ms": res.profile["compile_chunk_ms"]})
            plain_s.append(plain.profile["null_s"])
            shutil.rmtree(trace, ignore_errors=True)
        idle = [r["null_split"]["idle_frac"] for r in runs]
        report["profile"] = {
            "mode": "fused streaming, superchunk 1", "n_perm": n_prof,
            "runs": runs, "idle_frac": idle,
            "idle_frac_median": float(np.median(idle)),
            "idle_frac_spread": float(max(idle) - min(idle)),
            "null_s_profiled": [r["null_s"] for r in runs],
            "null_s_unprofiled": plain_s,
            "launches": used["fused_stats_counts"]}
        launches["profile"] = used
    finally:
        shutil.rmtree(top, ignore_errors=True)
    emit({"phase": "fault_ladder_check", **report,
          "phase_s": time.perf_counter() - t_phase, "card": card})
    return launches


def faults_only() -> int:
    """``--faults``: the fault_ladder phase alone, its references computed
    on the way, through the ``netrep_tpu_torch`` beside this script."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "card": card, "torch": torch.__version__})
    _build.build(list(_build.SOURCES))
    _sizes, labels, (xd, xt, _x2) = make_cohorts(np)
    disc, test = [[m.cpu().numpy() for m in mats(torch, x, dev)]
                  for x in (xd, xt)]
    torch.cuda.empty_cache()
    kw = dict(network={"disc": disc[2], "test": test[2]},
              data={"disc": disc[0], "test": test[0]},
              correlation={"disc": disc[1], "test": test[1]},
              module_assignments=list(labels), discovery="disc",
              test="test", n_perm=N_PERM, seed=SEED, device="cuda")
    drive = make_drive(torch, np, tops, module_preservation, kw, card)
    fault_ladder_phase(torch, np, drive, labels, disc, test, {}, card, dev)
    print(card_line(), flush=True)
    return 0


def pr9_only(phase) -> int:
    """``--sparse`` / ``--data-only`` / ``--atlas-build``: that phase
    alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    card = card_line()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "card": card, "torch": torch.__version__})
    phase(torch, np, card)
    return 0


def _host_props(np, net, dat):
    """The network properties of one module from its host float64
    submatrix and data slice, by the formulas of the JAX package's numpy
    oracle: normalized weighted degree, average edge weight, summary
    profile (first left singular vector of the standardized slice, signed
    to the mean profile), node contribution and coherence."""
    deg = net.sum(axis=1) - np.diag(net)
    m = net.shape[0]
    mu = dat.mean(axis=0, keepdims=True)
    sd = dat.std(axis=0, ddof=1, keepdims=True)
    z = (dat - mu) / np.where(sd > 0, sd, np.inf)
    u = np.linalg.svd(z, full_matrices=False)[0][:, 0]
    prof = -u if np.dot(u, z.mean(axis=1)) < 0 else u
    p = prof - prof.mean()
    denom = np.linalg.norm(p) * np.linalg.norm(z, axis=0)
    nc = np.where(denom == 0, 0.0, (z.T @ p) / np.where(denom == 0, 1,
                                                         denom))
    return {"degree": deg / np.abs(deg).max(),
            "avg_weight": (net.sum() - np.trace(net)) / (m * (m - 1)),
            "summary": prof, "contribution": nc,
            "coherence": float(np.mean(nc**2))}


def surface(torch, np, kw, labels, card):
    """The exported surface on the card at the main path's width:
    ``network_properties`` on five modules held within TOL of a float64
    numpy computation of the same formulas on the host slices;
    ``combine_analyses`` of two SURFACE_PERM-permutation runs (seeds 1, 2)
    materialized and streaming, the combined p-values equal across the
    modes; and one matrix's round trip through pinned host memory."""
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.models.properties import network_properties
    from netrep_tpu_torch.models.results import combine_analyses

    mods = sorted(set(labels) - {"0"}, key=int)[:5]
    pair = {f: {k: kw[f][k] for k in ("disc", "test")}
            for f in ("network", "data", "correlation")}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    on_card, undo = spy_datasets(torch)
    try:
        t0 = time.perf_counter()
        props = network_properties(
            **pair, module_assignments=list(labels), discovery="disc",
            test="test", modules=mods, device="cuda")
        props_s = time.perf_counter() - t0
    finally:
        undo()
    props_peak = torch.cuda.max_memory_allocated() / 2**30
    # only module blocks are read: no dataset's n×n lands on the card
    if any(on_card.values()):
        raise RuntimeError(f"network_properties: bytes on the card after "
                           f"the input phase {on_card}")
    tn, td = kw["network"]["test"], kw["data"]["test"]
    worst = {}
    for lab in mods:
        ti = np.flatnonzero(labels == lab)
        want = _host_props(np, tn[np.ix_(ti, ti)].astype(np.float64),
                           td[:, ti].astype(np.float64))
        got = props[lab]
        for key, w in want.items():
            err = float(np.max(np.abs(np.asarray(got[key]) - w)))
            worst[key] = max(worst.get(key, 0.0), err)
    if max(worst.values()) > TOL:
        raise RuntimeError(f"network_properties differs from the host "
                           f"float64 computation: {worst}")
    call = dict(pair, module_assignments=list(labels), discovery="disc")
    runs = {}
    t0 = time.perf_counter()
    for store in (True, False):
        for seed in (1, 2):
            runs[store, seed] = module_preservation(
                **call, test="test", n_perm=SURFACE_PERM, seed=seed,
                store_nulls=store, device="cuda")
    runs_s = time.perf_counter() - t0
    comb = {store: combine_analyses(runs[store, 1], runs[store, 2])
            for store in (True, False)}
    mixed = combine_analyses(runs[True, 1], runs[False, 2])
    for c in (comb[False], mixed):
        if not np.array_equal(c.p_values, comb[True].p_values):
            raise RuntimeError("combined p-values differ between the "
                               "materialized and streaming runs")
    if comb[True].completed != 2 * SURFACE_PERM:
        raise RuntimeError(f"combined {comb[True].completed} permutations")
    m = torch.as_tensor(kw["correlation"]["test"], device="cuda",
                        dtype=torch.float32)
    trip = round_trip(torch, m)
    del m
    torch.cuda.empty_cache()
    emit({"phase": "surface", "modules": mods,
          "network_properties": {"seconds": props_s,
                                 "max_abs_vs_host_float64": worst,
                                 "tolerance": TOL, "peak_gib": props_peak,
                                 "card_gib_after_input": 0.0},
          "combine_analyses": {"n_perm_each": SURFACE_PERM,
                               "seeds": [1, 2], "runs_s": runs_s,
                               "completed": comb[True].completed,
                               "p_values_equal_materialized_streaming":
                               True, "p_values_equal_mixed": True,
                               "min_p": float(comb[True].p_values.min())},
          "round_trip": trip, "card": card})


def sequential_tests(torch, np, module_preservation, ops, kw, config, card,
                     dev):
    """One discovery against the two test cohorts without ``vmap_tests``:
    the pairs run one after another. A matrix that a later pair needs
    waits on the host (float32) while a pair's null runs, so each pair's
    ``engine_s`` carries the host copies that pair makes. Also times that
    round trip for one ``GENES``² float32 matrix (``round_trip``). Returns
    the results by test name."""
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = []
    t0 = time.perf_counter()
    res = module_preservation(
        **{**kw, "test": ["test", "test2"]}, config=config,
        vmap_tests=False, progress=lambda done, total: held.append(
            torch.cuda.memory_allocated()))
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.kernels()}
    for name, r in res.items():
        if r.observed.shape != (MODULES, 7) or not np.isfinite(
                r.observed).all():
            raise RuntimeError(f"sequential_tests {name}: observed "
                               "statistics are not finite (MODULES, 7)")
        if r.completed != N_PERM:
            raise RuntimeError(f"sequential_tests {name}: completed "
                               f"{r.completed} of {N_PERM}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    m = torch.as_tensor(kw["correlation"]["test"], device=dev,
                        dtype=torch.float32)
    trip = round_trip(torch, m)
    del m
    torch.cuda.empty_cache()
    emit({"phase": "sequential_tests", "tests": list(res), "n_perm": N_PERM,
          "vmap_tests": False, "wall_s": wall,
          "input_s": next(iter(res.values())).profile["input_s"],
          "pairs": {name: {k: r.profile[k] for k in
                           ("engine_s", "observed_s", "null_s")}
                    for name, r in res.items()},
          "launches": launches, "peak_gib": peak,
          "null_held_gib": max(held) / 2**30,
          "matrix_round_trip_s": trip,
          "card": card})
    return res


def active_after_chunks(np, n_used, chunk):
    """Modules still drawing after each chunk of an adaptive run: a module
    retires only at a chunk boundary, so its count is a multiple of the
    chunk (or the ceiling)."""
    deepest = int(n_used.max())
    return [int((n_used > k).sum()) for k in range(chunk, deepest + chunk,
                                                    chunk)]


def adaptive_launches(np, n_used, caps, chunk):
    """Launches of the fused-statistics kernel an adaptive run makes: one
    per chunk and bucket still holding an active module."""
    n_used, caps = np.asarray(n_used), np.asarray(caps)
    return int(sum(len(set(caps[n_used > k]))
                   for k in range(0, int(n_used.max()), chunk)))


def batch_count_probe(torch, tstats, disc, sub_c, sub_n, zd, k, n_iter):
    """Whether each kind of operation the composed statistics run, and
    each of the seven statistics, gives the first ``k`` modules the same
    bits in a batch of ``k`` modules as in the whole bucket's batch: the
    bucket's discovery props ``disc``, gathered submatrices ``sub_c``,
    ``sub_n`` ``(C, K, cap, cap)`` and standardized data ``zd`` ``(C, K,
    s, cap)``."""
    from netrep_tpu_torch.ops.oracle import STAT_NAMES

    head = tstats.DiscProps(*(a[:k] for a in disc))
    part = tstats.module_stats_masked(head, sub_c[:, :k], sub_n[:, :k],
                                      zd[:, :k], n_iter=n_iter)
    whole = tstats.module_stats_masked(disc, sub_c, sub_n, zd,
                                       n_iter=n_iter)[:, :k]
    stats = {f"statistic {name}": same(torch, part[..., i], whole[..., i])
             for i, name in enumerate(STAT_NAMES)}
    dc = disc.corr
    ops = {
        "matmul": lambda a, z, d: torch.matmul(a, a),
        "matvec": lambda a, z, d: (a @ a[..., :1])[..., 0],
        "matvec_contiguous": lambda a, z, d: (
            a @ a[..., 0].contiguous()[..., None])[..., 0],
        "discovery_flat_sum": lambda a, z, d: d.reshape(
            d.shape[0], -1).sum(-1)[None],
        "sum_last_axis": lambda a, z, d: a.sum(-1),
        "sum_last_two_axes": lambda a, z, d: a.sum((-1, -2)),
        "sum_sample_axis": lambda a, z, d: z.sum(-2),
        "vector_norm_sample_axis": lambda a, z, d: torch.linalg.vector_norm(
            z, dim=-2),
        "vector_norm_last_axis": lambda a, z, d: torch.linalg.vector_norm(
            a, dim=-1),
        "data_gram": lambda a, z, d: z.transpose(-1, -2) @ z,
        "mean_sample_axis": lambda a, z, d: z.mean(-2),
    }
    return {**stats, **{name: same(torch, f(sub_c[:, :k], zd[:, :k], dc[:k]),
                                   f(sub_c, zd, dc)[:, :k])
                        for name, f in ops.items()}}


def rebucketed_kernels(torch, np, fs, fg, pv, engine, subsets, cfg, dev):
    """The fused values and counts kernels and the gather kernel on buckets
    that ``rebucket`` row-filtered, at the main path's shapes: each against
    its plain version (statistics within TOL, tallies equal to the tail
    counts of the kernel's own values, gather bit for bit), and each
    surviving cell's values equal to the full bucket's bit for bit (one
    block per cell). The composed statistics are held within TOL of the
    full bucket's, with :func:`batch_count_probe` of each bucket beside."""
    from netrep_tpu_torch import random as trandom
    from netrep_tpu_torch.ops import stats as tstats

    perm = trandom.permutation(
        trandom.perm_keys(trandom.key(SEED, device=dev), 0, cfg.chunk_size),
        engine._pool_dev)
    tc, tn, tdT = engine._test_corr, engine._test_net, engine._test_dataT

    def values(b, idx):
        return fs.fused_stats_values(tc, tn, tdT, b.disc, idx,
                                     n_iter=cfg.power_iters)

    def composed(b, idx):
        sub_c, sub_n = (fg.gather_submatrix_fused_many(M, [idx])[0]
                        for M in (tc, tn))
        return engine._stats(b, idx, sub_c, sub_n), (sub_c, sub_n)

    full, full_comp, probe = {}, {}, {}
    for b in engine.buckets:
        idx = engine._bucket_idx(perm, b)
        out, (comp, (sub_c, sub_n)) = values(b, idx), composed(b, idx)
        for i, m in enumerate(b.module_pos):
            full[m], full_comp[m] = out[:, i], comp[:, i]
        if len(b.module_pos) > 1:
            zd = tstats.gather_zdata(tdT, idx, b.disc.mask)
            probe[b.cap] = batch_count_probe(
                torch, tstats, b.disc, sub_c, sub_n, zd,
                len(b.module_pos) // 2, cfg.power_iters)
    comp_bit, comp_err = True, 0.0
    err = {"fused_stats_values": 0.0, "fused_stats_counts": 0.0}
    checked = 0
    for subset in subsets:
        engine.rebucket(subset)
        idx_list = [engine._bucket_idx(perm, b) for b in engine.buckets]
        for b, idx in zip(engine.buckets, idx_list):
            got = values(b, idx)
            want = fs.fused_stats_values_plain(tc, tn, tdT, b.disc, idx,
                                               n_iter=cfg.power_iters)
            err["fused_stats_values"] = max(err["fused_stats_values"],
                                            abs_err(torch, got, want))
            comp, _ = composed(b, idx)
            for i, m in enumerate(b.module_pos):
                if not same(torch, got[:, i], full[m]):
                    raise RuntimeError(f"module {m}: values on the "
                                       "re-bucketed bucket differ from the "
                                       "full bucket's")
                comp_bit &= same(torch, comp[:, i], full_comp[m])
                comp_err = max(comp_err, abs_err(torch, comp[:, i],
                                                 full_comp[m]))
            obs = got[0].contiguous()
            pvalid = torch.ones(idx.shape[0], dtype=torch.int32, device=dev)
            pvalid[-3:] = 0
            got_c = fs.fused_stats_counts(tc, tn, tdT, b.disc, idx, pvalid,
                                          obs, n_iter=cfg.power_iters)
            want_c = fs.fused_stats_counts_plain(tc, tn, tdT, b.disc, idx,
                                                 pvalid, obs,
                                                 n_iter=cfg.power_iters)
            err["fused_stats_counts"] = max(err["fused_stats_counts"],
                                            abs_err(torch, got_c[0],
                                                    want_c[0]))
            vals = got_c[0].cpu().numpy()[:-3]
            for t, want_t in zip(got_c[1:], pv.tail_counts(
                    obs.cpu().numpy(), vals)):
                if not np.array_equal(t.cpu().numpy(), want_t):
                    raise RuntimeError("re-bucketed counts kernel's tallies "
                                       "differ from its own values'")
            checked += 2
        for M in (tc, tn):
            got = fg.gather_submatrix_fused_many(M, idx_list)
            want = fg.gather_submatrix_fused_many_plain(M, idx_list)
            for g, w in zip(got, want):
                if not same(torch, g, w):
                    raise RuntimeError("gather kernel != plain on a "
                                       "re-bucketed chunk")
                checked += 1
    engine.rebucket(range(engine.n_modules))
    if max(err.values()) > TOL or comp_err > TOL:
        raise RuntimeError(f"kernel disagrees with plain on re-bucketed "
                           f"buckets: {err}, composed {comp_err}")
    return err, checked, {"composed_rows_bit_equal": bool(comp_bit),
                          "composed_max_abs": comp_err,
                          "ops_differing_across_batch_counts": {
                              f"cap {cap}": [k for k, v in ops.items()
                                             if not v]
                              for cap, ops in probe.items()}}


def adaptive_phase(torch, np, fs, fg, pv, drive, cfg, composed_cfg, labels,
                   fused_run, composed_run, disc, test, card, dev):
    """``adaptive=True`` at the main path's widths and a ceiling of
    ADAPTIVE_PERM: fused materialized and streaming, composed
    materialized, and a fixed ADAPTIVE_PERM streaming null beside them;
    then the kernels on re-bucketed buckets against their plain versions.
    Fails unless the two fused modes agree exactly, every module's rows
    equal the fixed main-path run's at the same indices (fused: bit for
    bit; composed: within TOL of the fixed composed run's), each fused
    kernel launched once per chunk and bucket still active, and the
    kernels match their plain versions on re-bucketed buckets. Returns
    ``(the fused materialized result, launches by path, the kernels'
    largest deviation from plain on re-bucketed buckets, the composed
    materialized result)``."""
    from netrep_tpu_torch.ops.sequential import StopRule
    from netrep_tpu_torch.utils.config import EngineConfig

    C = cfg.chunk_size
    ad = dict(adaptive=True, n_perm=ADAPTIVE_PERM, completed=None)
    many = "gather_submatrix_fused_many"
    out, launches, caps = {}, {}, None
    for name, config, store, kernel in (
            ("fused_materialized", cfg, True, "fused_stats_values"),
            ("fused_streaming", cfg, False, "fused_stats_counts"),
            ("composed_materialized", composed_cfg, True, many)):
        res, used, _ = drive("adaptive", [kernel], config=config,
                             store_nulls=store, **ad)
        n_used = np.asarray(res.n_perm_used)
        if caps is None:
            caps = [cfg.rounded_cap(int(s)) for s in res.n_vars_present]
        want = (2 * -(-res.completed // C) if kernel == many
                else adaptive_launches(np, n_used, caps, C))
        if res.p_type != "sequential" or used[kernel] != want:
            raise RuntimeError(f"adaptive {name}: {used[kernel]} launches of "
                               f"{kernel}, expected {want} (one per chunk "
                               "and active bucket)")
        out[name] = res
        launches[("adaptive", name)] = used
        emit({"phase": "adaptive_run", "run": name,
              "completed": int(res.completed),
              "n_perm_used_sum": int(n_used.sum()),
              "n_perm_used_ceiling": MODULES * ADAPTIVE_PERM,
              "active_after_chunk": active_after_chunks(np, n_used, C),
              "null_s": res.profile["null_s"],
              "s_per_module_permutation": res.profile["null_s"]
              / float(n_used.sum()),
              "launches": {k: v for k, v in used.items() if v},
              "expected_launches": {kernel: want}, "card": card})
    mat, stream = out["fused_materialized"], out["fused_streaming"]
    hi, lo, eff = pv.tail_counts(mat.observed, mat.nulls[: mat.completed])
    if not (np.array_equal(mat.n_perm_used, stream.n_perm_used)
            and mat.completed == stream.completed
            and np.array_equal(mat.p_values, stream.p_values)
            and np.array_equal(hi, stream.counts_hi)
            and np.array_equal(lo, stream.counts_lo)
            and np.array_equal(eff, stream.counts_eff)):
        raise RuntimeError("adaptive materialized and streaming runs differ "
                           "in n_perm_used, counts or p-values")
    rows = {}
    for name, fixed in (("fused_materialized", fused_run),
                        ("composed_materialized", composed_run)):
        res, bit, err = out[name], True, 0.0
        for m, k in enumerate(np.asarray(res.n_perm_used)):
            k = min(int(k), N_PERM)
            a, b = res.nulls[:k, m], fixed.nulls[:k, m]
            bit &= bool(np.array_equal(a, b))
            err = max(err, float(np.abs(a - b).max()))
            if not np.isnan(res.nulls[int(res.n_perm_used[m]):, m]).all():
                raise RuntimeError(f"{name}: module {m} has rows past its "
                                   "retirement")
        if (name.startswith("fused") and not bit) or err > TOL:
            raise RuntimeError(f"adaptive {name}: rows differ from the fixed "
                               f"run's at the same indices (max {err})")
        rows[name] = {"bit_equal": bit, "max_abs": err}
    fixed, used, _ = drive("adaptive_fixed", ["fused_stats_counts"],
                           completed=ADAPTIVE_PERM, config=cfg,
                           store_nulls=False, n_perm=ADAPTIVE_PERM)
    launches[("adaptive", "fixed_streaming")] = used
    # the default rule decides each cell at alpha = 0.05; preserved_modules
    # calls at 0.05 / MODULES (Bonferroni): a rule at that level decides
    # as the call does
    bonf, used, _ = drive(
        "adaptive", ["fused_stats_counts"], config=cfg, store_nulls=False,
        adaptive_rule=StopRule(alpha=0.05 / MODULES), **ad)
    launches[("adaptive", "bonferroni_streaming")] = used
    a_pres, f_pres = mat.preserved_modules(), fixed.preserved_modules()
    b_pres = bonf.preserved_modules()
    emit({"phase": "adaptive_check", "modes_equal": True,
          "rows_vs_fixed_1000": rows,
          "fixed_streaming": {"completed": int(fixed.completed),
                              "null_s": fixed.profile["null_s"],
                              "s_per_module_permutation":
                                  fixed.profile["null_s"]
                                  / float(MODULES * ADAPTIVE_PERM)},
          "adaptive_null_s": {k: r.profile["null_s"] for k, r in out.items()},
          "preserved_adaptive": a_pres, "preserved_fixed": f_pres,
          "decisions_differ": sorted(set(a_pres) ^ set(f_pres)),
          "bonferroni_rule": {
              "alpha": 0.05 / MODULES, "completed": int(bonf.completed),
              "n_perm_used_sum": int(np.sum(bonf.n_perm_used)),
              "active_after_chunk": active_after_chunks(
                  np, np.asarray(bonf.n_perm_used), C),
              "null_s": bonf.profile["null_s"], "preserved": b_pres,
              "decisions_differ_fixed": sorted(set(b_pres) ^ set(f_pres))},
          "card": card})
    # ---- the kernels on re-bucketed buckets at the main path's shapes ----
    engine = make_engine(np, labels, disc, test, EngineConfig(), dev)
    n_used = np.asarray(mat.n_perm_used)
    subsets = [np.flatnonzero(n_used > C), np.arange(0, MODULES, 2)]
    subsets = [sub for sub in subsets if sub.size]
    err, checked, composed = rebucketed_kernels(torch, np, fs, fg, pv,
                                                engine, subsets, cfg, dev)
    emit({"phase": "rebucketed_kernels", "tolerance": TOL,
          "max_abs_err": err, "outputs_checked": checked,
          "composed_vs_full_bucket": composed,
          "subset_sizes": [int(sub.size) for sub in subsets],
          "values_equal_full_bucket": True, "gather_bit_equal": True})
    del engine
    torch.cuda.empty_cache()
    return mat, launches, err, out["composed_materialized"]


def checkpoint_phase(np, pv, drive, cfg, ring_cfg, row_mesh, many, fused_run,
                     stream_run, adaptive_run, card):
    """Main-path runs interrupted by a ``progress`` callback that raises
    ``KeyboardInterrupt`` after STOP_AFTER chunks (a checkpoint every
    chunk), then resumed by the same call: fixed materialized, fixed
    streaming (superchunks of one chunk) and adaptive materialized, each
    equal to its uninterrupted run (nulls bit for bit, counts and
    p-values); and a RING_CKPT_PERM null written on the 1×4 ring mesh,
    resumed unsplit. Prints a save's and a load's seconds and the file's
    size. Returns the launches by path."""
    import os
    import shutil
    import tempfile

    from netrep_tpu_torch.utils import checkpoint as tck
    from netrep_tpu_torch.utils.config import EngineConfig

    C = cfg.chunk_size
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    top = tempfile.mkdtemp(prefix="checkpoints_", dir=root)

    def stop_after(n):
        calls = []

        def progress(done, total):
            calls.append(done)
            if len(calls) == n:
                raise KeyboardInterrupt
        return progress

    launches, report = {}, {}
    try:
        for name, call, kernel, ref in (
                ("fixed_materialized", dict(config=cfg), "fused_stats_values",
                 fused_run),
                ("fixed_streaming", dict(config=EngineConfig(superchunk=1),
                                         store_nulls=False),
                 "fused_stats_counts", stream_run),
                ("adaptive_materialized", dict(config=cfg, adaptive=True,
                                               n_perm=ADAPTIVE_PERM),
                 "fused_stats_values", adaptive_run)):
            d = os.path.join(top, name)
            call = dict(call, checkpoint_dir=d, checkpoint_every=C)
            part, used_p, _ = drive("checkpoint", [kernel],
                                    completed=STOP_AFTER * C,
                                    progress=stop_after(STOP_AFTER), **call)
            res, used, _ = drive("checkpoint", [kernel], completed=None,
                                 **call)
            launches[("checkpoint", name)] = used
            ok = (res.completed == ref.completed
                  and np.array_equal(res.p_values, ref.p_values))
            if ref.nulls is not None:
                ok &= bool(np.array_equal(res.nulls, ref.nulls,
                                          equal_nan=True))
            else:
                ok &= all(np.array_equal(getattr(res, f), getattr(ref, f))
                          for f in ("counts_hi", "counts_lo", "counts_eff"))
            if ref.n_perm_used is not None:
                ok &= bool(np.array_equal(res.n_perm_used, ref.n_perm_used))
            if not ok:
                raise RuntimeError(f"checkpoint {name}: the resumed run "
                                   "differs from the uninterrupted one")
            report[name] = {"interrupted_at": int(part.completed),
                            "resumed_to": int(res.completed),
                            "launches_before": used_p[kernel],
                            "launches_after": used[kernel],
                            "null_s_resumed": res.profile["null_s"]}
        # each file: a load, a save, its size
        files = {}
        for name in ("fixed_materialized", "fixed_streaming",
                     "adaptive_materialized"):
            path = os.path.join(top, name, "null_disc__test.npz")
            t0 = time.perf_counter()
            loaded = tck.load_null_checkpoint(path)
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            tck.save_null_checkpoint(os.path.join(top, "again.npz"),
                                     loaded["nulls"], loaded["completed"],
                                     loaded["key_data"],
                                     loaded["fingerprint"],
                                     extra=loaded["extras"])
            files[name] = {"bytes": os.path.getsize(path),
                           "save_s": time.perf_counter() - t0,
                           "load_s": load_s,
                           "null_shape": list(loaded["nulls"].shape)}
        # written on the ring mesh, resumed unsplit
        d = os.path.join(top, "ring")
        ring = dict(checkpoint_dir=d, checkpoint_every=C,
                    n_perm=RING_CKPT_PERM)
        part, used_r, _ = drive("checkpoint", ["ring_shift_dma", many],
                                completed=C, config=ring_cfg, mesh=row_mesh,
                                progress=stop_after(1), **ring)
        res, used, _ = drive("checkpoint", ["fused_stats_values"],
                             completed=RING_CKPT_PERM, config=cfg, **ring)
        launches[("checkpoint", "ring_written")] = used_r
        launches[("checkpoint", "ring_resumed")] = used
        unsplit_p = pv.permutation_pvalues(
            res.observed, fused_run.nulls[:RING_CKPT_PERM], res.alternative,
            total_nperm=res.total_space)
        if not (np.array_equal(res.nulls[:C], part.nulls[:C])
                and np.array_equal(res.nulls[C:],
                                   fused_run.nulls[C:RING_CKPT_PERM])
                and np.array_equal(res.p_values, unsplit_p)):
            raise RuntimeError("checkpoint written on the ring mesh: the "
                               "unsplit resume differs")
        report["ring_to_unsplit"] = {
            "interrupted_at": int(part.completed),
            "resumed_to": int(res.completed),
            "p_values_equal_unsplit": True}
    finally:
        shutil.rmtree(top, ignore_errors=True)
    emit({"phase": "checkpoint_check", "runs": report,
          "resumed_equal_uninterrupted": True,
          "checkpoint_every": C, "files": files, "card": card})
    return launches


def sequential_only() -> int:
    """``--sequential-tests``: only the inputs and the sequential-tests
    call, through the ``netrep_tpu_torch`` that lies beside this script
    (another checkout's, to compare two versions on one card)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.utils.config import EngineConfig

    dev = torch.device("cuda")
    card = card_line()
    _sizes, labels, (xd, xt, x2) = make_cohorts(np)
    # as main() hands them over: float64, the second test float32
    host = [[m.to(dtype).cpu().numpy() for m in mats(torch, x, dev)]
            for x, dtype in ((xd, torch.float64), (xt, torch.float64),
                             (x2, torch.float32))]
    torch.cuda.empty_cache()
    names = ("disc", "test", "test2")
    kw = dict(
        network={k: h[2] for k, h in zip(names, host)},
        data={k: h[0] for k, h in zip(names, host)},
        correlation={k: h[1] for k, h in zip(names, host)},
        module_assignments=list(labels), discovery="disc",
        n_perm=N_PERM, seed=SEED, device="cuda",
    )
    sequential_tests(torch, np, module_preservation, tops, kw,
                     EngineConfig(), card, dev)
    print(card_line(), flush=True)
    return 0


def wide_samples(torch, np, fs, ops, module_preservation, cfg, card, dev):
    """The north-star widths with cohorts of WIDE_SAMPLES samples, a shape
    whose data slices no block's shared memory holds: the fused-statistics
    kernel against its plain version on one chunk in every bucket, then a
    streaming ``module_preservation`` of WIDE_PERM permutations through
    it."""
    _sizes, labels, (xd, xt, _x2) = make_cohorts(np, WIDE_SAMPLES)
    disc, test = mats(torch, xd, dev), mats(torch, xt, dev)
    engine, chunk, _obs = first_chunk(torch, np, labels, disc, test, cfg, dev)
    tc, tn, tdT = engine._test_corr, engine._test_net, engine._test_dataT
    buckets = []
    for b, idx in chunk:
        got = fs.fused_stats_values(tc, tn, tdT, b.disc, idx,
                                    n_iter=cfg.power_iters)
        want = fs.fused_stats_values_plain(tc, tn, tdT, b.disc, idx,
                                           n_iter=cfg.power_iters)
        torch.cuda.synchronize()
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise RuntimeError(f"wide_samples: NaN pattern differs (cap "
                               f"{b.cap})")
        err = torch.nan_to_num((got - want).abs(), nan=0.0).max().item()
        buckets.append({"cap": b.cap, "modules": len(b.module_pos),
                        "tier": fs.kernel_tier(b.cap, WIDE_SAMPLES, True),
                        "max_abs_err": err})
    del engine, chunk, _obs, tc, tn, tdT, got, want
    worst = max(r["max_abs_err"] for r in buckets)
    if worst > TOL:
        raise RuntimeError(f"wide_samples: kernel disagrees with plain by "
                           f"{worst}")
    # handed over as host float32, as a user might hold them
    host = [[m.to(torch.float32).cpu().numpy() for m in side]
            for side in (disc, test)]
    del disc, test
    torch.cuda.empty_cache()
    names = ("disc", "test")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = []
    t0 = time.perf_counter()
    res = module_preservation(
        network={k: h[2] for k, h in zip(names, host)},
        data={k: h[0] for k, h in zip(names, host)},
        correlation={k: h[1] for k, h in zip(names, host)},
        module_assignments=list(labels), discovery="disc", test="test",
        n_perm=WIDE_PERM, seed=SEED, device="cuda", config=cfg,
        store_nulls=False, progress=lambda done, total: held.append(
            torch.cuda.memory_allocated()))
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.kernels()}
    if launches["fused_stats_counts"] == 0:
        raise RuntimeError("wide_samples launched no fused_stats_counts "
                           "kernel")
    if res.observed.shape != (MODULES, 7) or not np.isfinite(
            res.observed).all():
        raise RuntimeError("wide_samples: observed statistics are not "
                           "finite (MODULES, 7)")
    if not ((res.p_values > 0) & (res.p_values <= 1)).all():
        raise RuntimeError("wide_samples: p-values outside (0, 1]")
    if res.completed != WIDE_PERM:
        raise RuntimeError(f"wide_samples: completed {res.completed}")
    prof = res.profile
    emit({"phase": "wide_samples", "samples": WIDE_SAMPLES, "genes": GENES,
          "modules": MODULES, "n_perm": WIDE_PERM, "store_nulls": False,
          "kernel_vs_plain": buckets, "tolerance": TOL, "wall_s": wall,
          **{k: prof[k] for k in ("input_s", "engine_s", "observed_s",
                                  "null_s", "perms_per_s")},
          "launches": launches,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "null_held_gib": max(held) / 2**30,
          "modules_preserved": int((res.p_values.max(axis=1)
                                    < 0.05 / MODULES).sum()),
          "card": card})
    return res


def inputs_only() -> int:
    """``--inputs``: only ``input_phase`` on the main path's host float64
    inputs, through the ``netrep_tpu_torch`` beside this script (another
    checkout's, to compare two versions on one card)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    dev = torch.device("cuda")
    card = card_line()
    _sizes, _labels, (xd, xt, _x2) = make_cohorts(np)
    hosts = {name: tuple(m.cpu().numpy() for m in mats(torch, x, dev))
             for name, x in (("disc", xd), ("test", xt))}
    torch.cuda.empty_cache()
    input_phase(torch, np, hosts, card, bound=False)
    print(card_line(), flush=True)
    return 0


def genome_only() -> int:
    """``--genome-scale``: only ``genome_scale``, through the
    ``netrep_tpu_torch`` beside this script; an out-of-memory error of
    that version is printed as its result."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    genome_scale(torch, np, card_line(), strict=False)
    print(card_line(), flush=True)
    return 0


def p_values_only() -> int:
    """``--p-values``: the p-values and exceedance counts of the main path
    (both null modes), the derived network, the row-sharded ring, the perm
    mesh and two cohorts with ``vmap_tests``, on float32 host inputs,
    through the ``netrep_tpu_torch`` beside this script (another
    checkout's, to hold two versions to the same answers on one card)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.utils.config import EngineConfig

    dev = torch.device("cuda")
    card = card_line()
    _sizes, labels, cohorts = make_cohorts(np)
    host = [[m.to(torch.float32).cpu().numpy() for m in mats(torch, x, dev)]
            for x in cohorts]
    torch.cuda.empty_cache()
    names = ("disc", "test", "test2")
    base = dict(network={k: h[2] for k, h in zip(names, host)},
                data={k: h[0] for k, h in zip(names, host)},
                correlation={k: h[1] for k, h in zip(names, host)},
                module_assignments=list(labels), discovery="disc",
                n_perm=N_PERM, seed=SEED, device="cuda")
    runs = {
        "main_path/materialized": dict(config=EngineConfig()),
        "main_path/streaming": dict(config=EngineConfig(), store_nulls=False),
        "derived_network": dict(config=EngineConfig(
            network_from_correlation=BETA)),
        "composed/materialized": dict(config=EngineConfig(stat_mode="xla")),
        "composed/streaming": dict(config=EngineConfig(stat_mode="xla"),
                                   store_nulls=False),
        "row_sharded/ring": dict(config=EngineConfig(matrix_sharding="row"),
                                 mesh=make_mesh(1, 4, devices=[dev] * 4)),
        "row_sharded/psum": dict(config=EngineConfig(matrix_sharding="row",
                                                     stat_mode="xla"),
                                 store_nulls=False,
                                 mesh=make_mesh(1, 4, devices=[dev] * 4)),
        "perm_mesh": dict(config=EngineConfig(), store_nulls=False,
                          mesh=make_mesh(2, 1, devices=[dev] * 2)),
        "multi_test": dict(config=EngineConfig(), test=["test", "test2"],
                           vmap_tests=True),
    }
    for name, kw in runs.items():
        res = module_preservation(**{"test": "test", **base, **kw})
        out = {}
        for cohort, r in (res.items() if isinstance(res, dict)
                          else [("test", res)]):
            hi, lo, _eff = ((r.counts_hi, r.counts_lo, r.counts_eff)
                            if r.nulls is None
                            else pv.tail_counts(r.observed, r.nulls))
            out[cohort] = {"p_values": r.p_values.tolist(),
                           "hi": np.asarray(hi).tolist(),
                           "lo": np.asarray(lo).tolist(),
                           "null_s": r.profile["null_s"]}
        emit({"phase": "p_values", "run": name, "cohorts": out,
              "card": card})
    print(card_line(), flush=True)
    return 0


def gather_only() -> int:
    """``--gather``: one chunk's gather from one matrix and the ring's
    assembly (``gather_times``), the ring trace and, where the redesigned
    kernel is, its staged/in-place crossover, through the
    ``netrep_tpu_torch`` beside this script (another checkout's, to
    compare two versions on one card)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from netrep_tpu_torch.ops import fused_gather as fg
    from netrep_tpu_torch.ops import fused_stats as fs
    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.utils.config import EngineConfig

    dev = torch.device("cuda")
    card = card_line()
    cfg = EngineConfig()
    _sizes, labels, (xd, xt, _x2) = make_cohorts(np)
    disc, test = mats(torch, xd, dev), mats(torch, xt, dev)
    engine, chunk, _obs = first_chunk(torch, np, labels, disc, test, cfg, dev)
    tc32 = engine._test_corr
    timed = make_timer(torch)
    tree = "per_chunk" if hasattr(fg, "gather_submatrix_fused_many") \
        else "per_bucket"
    emit({"phase": "gather_ab", "tree": tree, "unit": "one chunk of "
          f"{cfg.chunk_size} permutations x {MODULES} modules, one matrix",
          "times_ms": gather_times(torch, fg, fs, chunk, tc32, timed, dev),
          "crossover": (gather_crossover(torch, fg, chunk, tc32, timed)
                        if tree == "per_chunk" else None),
          "card": card})
    del engine, chunk, _obs, tc32
    torch.cuda.empty_cache()
    ring_engine = make_engine(np, labels, disc, test,
                              EngineConfig(matrix_sharding="row"), dev,
                              mesh=make_mesh(1, 4, devices=[dev] * 4))
    ring_trace(torch, np, ring_engine, card, tree)
    print(card_line(), flush=True)
    return 0


def kernels_only() -> int:
    """``--kernels``: the fused-statistics kernel's split and its time per
    chunk (both entries), and the ring step's times, at the main path's
    shapes, through the ``netrep_tpu_torch`` beside this script (another
    checkout's, to compare two versions on one card)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from netrep_tpu_torch.ops import fused_stats as fs
    from netrep_tpu_torch.utils.config import EngineConfig

    dev = torch.device("cuda")
    card = card_line()
    cfg = EngineConfig()
    _sizes, labels, (xd, xt, _x2) = make_cohorts(np)
    engine, chunk, obs = first_chunk(torch, np, labels, mats(torch, xd, dev),
                                     mats(torch, xt, dev), cfg, dev)
    torch.cuda.empty_cache()
    timed = make_timer(torch)
    kernel_split(fs, engine, chunk, cfg.power_iters, timed, card)
    tc, tn, tdT = engine._test_corr, engine._test_net, engine._test_dataT
    pvalid = torch.ones(cfg.chunk_size, dtype=torch.int32, device=dev)
    emit({"phase": "kernel_times", "unit": "one chunk of "
          f"{cfg.chunk_size} permutations x {MODULES} modules",
          "times_ms": {
              "fused_stats_values": timed(lambda: [
                  fs.fused_stats_values(tc, tn, tdT, b.disc, idx,
                                        n_iter=cfg.power_iters)
                  for b, idx in chunk]),
              "fused_stats_counts": timed(lambda: [
                  fs.fused_stats_counts(tc, tn, tdT, b.disc, idx, pvalid, ob,
                                        n_iter=cfg.power_iters)
                  for (b, idx), ob in zip(chunk, obs)])},
          "card": card})
    ring_times(torch, fs, tc, timed, card)
    print(card_line(), flush=True)
    return 0


def bf16_kernels(torch, np, fs, fg, pv, engine, chunk, obs, cfg, timed,
                 f32_ms, card, dev):
    """The three kernels' bfloat16 instantiations at the main path's shapes,
    on the engine's float32 test matrices and data narrowed to bfloat16:
    fused statistics (values and counts, batches 8 and the chunk) within
    TOL of their plain version on the same bfloat16 tensors, counts the
    tail counts of their own values; the gather (``gather_vs_plain``: every
    way it reads a row, ``out=`` over row blocks, the single-bucket and
    local entries, a row wider than shared memory) and the ring step (both
    matrices' 5,000-row blocks around the ring, a block whose byte count
    leaves a tail, one that starts 2 bytes past a 16-byte boundary) bit for
    bit. Then each one's time (plain, kernel, kernel, plain), its bound at
    bfloat16 bytes, the library call's time and, from ``f32_ms``, the
    float32 time of the same call. Returns per kernel ``{max_abs_err, ms,
    plain_ms, bound_ms, bound_by, library_ms, f32_ms}``."""
    st = torch.bfloat16
    tc, tn, td = (engine._test_corr.to(st), engine._test_net.to(st),
                  engine._test_dataT.to(st))
    C = cfg.chunk_size

    def run(mode, impl, batch):
        outs = []
        for (b, idx), ob in zip(chunk, obs):
            ix = idx[:batch].contiguous()
            if mode == "values":
                fn = (fs.fused_stats_values if impl == "kernel"
                      else fs.fused_stats_values_plain)
                outs.append(fn(tc, tn, td, b.disc, ix,
                               n_iter=cfg.power_iters))
            else:
                fn = (fs.fused_stats_counts if impl == "kernel"
                      else fs.fused_stats_counts_plain)
                pvalid = torch.ones(ix.shape[0], dtype=torch.int32,
                                    device=dev)
                pvalid[-3:] = 0
                outs.append(fn(tc, tn, td, b.disc, ix, pvalid, ob,
                               n_iter=cfg.power_iters))
        return outs

    err = {"fused_stats_values": 0.0, "fused_stats_counts": 0.0}
    for batch in (8, C):
        for mode in ("values", "counts"):
            got, want = run(mode, "kernel", batch), run(mode, "plain", batch)
            torch.cuda.synchronize()
            for (b, _), g, w, ob in zip(chunk, got, want, obs):
                gv, wv = (g, w) if mode == "values" else (g[0], w[0])
                if not torch.equal(torch.isnan(gv), torch.isnan(wv)):
                    raise RuntimeError(f"bf16 {mode}: NaN pattern differs "
                                       f"(cap {b.cap})")
                name = f"fused_stats_{mode}"
                err[name] = max(err[name], torch.nan_to_num(
                    (gv - wv).abs(), nan=0.0).max().item())
                if mode == "counts":
                    keep = np.ones(batch, bool)
                    keep[-3:] = False
                    for t, want_t in zip(g[1:], pv.tail_counts(
                            ob.cpu().numpy(), gv.cpu().numpy()[keep])):
                        if not np.array_equal(t.cpu().numpy(), want_t):
                            raise RuntimeError("bf16 kernel tallies differ "
                                               "from its own values' counts")
    if max(err.values()) > TOL:
        raise RuntimeError(f"bf16 fused kernel disagrees with plain: {err}")
    g_err = 0.0
    for batch in (8, C):
        g_err = max(g_err, gather_vs_plain(torch, fg, chunk, tc, dev,
                                           batch)[0])
    rows_per = GENES // 4
    for M in (tc, tn):
        ring = [M[r0: r0 + rows_per] for r0 in range(0, GENES, rows_per)]
        for _step in range(3):
            got = fs.ring_shift_dma(ring)
            for g, w in zip(got, fs.ring_shift_collective(ring)):
                if not same(torch, g, w) or g.data_ptr() == w.data_ptr():
                    raise RuntimeError("bf16 ring shift kernel != plain")
            ring = got
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flat = torch.randn(4999 * 20001 + 9, device=dev, generator=gen).to(st)
    for ring in ([flat[:4999 * 20001].view(4999, 20001), flat[9:17]],
                 [flat[1:1 + 4999 * 20001].view(4999, 20001), flat[3:10]]):
        for g, w in zip(fs.ring_shift_dma(ring),
                        fs.ring_shift_collective(ring)):
            if not same(torch, g, w):
                raise RuntimeError("bf16 ring shift kernel != plain (tail "
                                   "or 2-byte aligned block)")
    torch.cuda.synchronize()
    del flat, ring, got
    emit({"phase": "bf16_vs_plain", "tolerance": TOL,
          "fused_max_abs_err": err, "fused_batches": [8, C],
          "gather_bit_equal": True, "ring_bit_equal": True,
          "ring_blocks": [rows_per, GENES], "ring_odd_block": [4999, 20001],
          "ring_2byte_aligned_block": True, "card": card})

    def interleaved(plain, kernel):
        p1, k1 = timed(plain), timed(kernel)
        k2, p2 = timed(kernel), timed(plain)
        return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}

    from netrep_tpu_torch.utils import costmodel

    out = {}
    b16, _k, per_bucket = fused_work(fs, costmodel, engine, chunk, cfg,
                                     elem=2)
    model = {mode: fused_bound(costmodel, engine, mode == "counts",
                               "bfloat16") for mode in ("values", "counts")}
    for mode in ("values", "counts"):
        name = f"fused_stats_{mode}"
        out[name] = {**interleaved(lambda: run(mode, "plain", C),
                                   lambda: run(mode, "kernel", C)),
                     "max_abs_err": err[name],
                     "bound_ms": model[mode]["bound_ms"],
                     "bound_by": model[mode]["bound_by"],
                     "sector_floor_ms": 1e3 * b16 / HBM_BPS,
                     "library_ms": None}
    idx_list = [idx for _, idx in chunk]
    long_idx = [i.long() for i in idx_list]
    bufs = [torch.empty(i.shape + i.shape[-1:], device=dev, dtype=st)
            for i in idx_list]
    blocks = [(r0, tc[r0: r0 + rows_per])
              for r0 in range(0, GENES, rows_per)]

    def row_blocks(fn):
        return lambda: [fn(blk, idx_list, r0, out=bufs) for r0, blk in blocks]

    for name, plain, kernel, nb, lib in (
            ("gather_submatrix_fused_many",
             lambda: fg.gather_submatrix_fused_many_plain(tc, idx_list),
             lambda: fg.gather_submatrix_fused_many(tc, idx_list), 1,
             lambda: [tc[i[..., :, None], i[..., None, :]]
                      for i in long_idx]),
            ("gather_submatrix_fused_many(out=)",
             row_blocks(fg.gather_submatrix_fused_many_plain),
             row_blocks(fg.gather_submatrix_fused_many), 4, None)):
        gb = gather_bound(torch, chunk, GENES, nb, elem=2)
        out[name] = {**interleaved(plain, kernel), "max_abs_err": g_err,
                     "bound_ms": 1e3 * gb["bytes"] / HBM_BPS,
                     "sector_floor_ms": 1e3 * gb["sector_floor_bytes"]
                     / HBM_BPS, "bound_by": "bytes",
                     "library_ms": None if lib is None else timed(lib)}
    r = ring_times(torch, fs, tc, timed, card)
    out["ring_shift_dma"] = {**{k: r[k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "library_ms")},
                             "max_abs_err": 0.0, "bound_by": "bytes"}
    for name, row in out.items():
        row["f32_ms"] = f32_ms[name]
    emit({"phase": "bf16_kernel_times", "unit": f"one chunk of {C} "
          f"permutations x {MODULES} modules (gather: one matrix; ring: one "
          f"launch on a {rows_per} x {GENES} block)", "times_ms": out,
          "per_bucket": per_bucket, "model": model,
          "sector_floor_bytes": b16,
          "library_calls": {"gather": "M[idx[..., :, None], idx[..., None, "
                                      ":]] per bucket on bfloat16 M",
                            "ring": "torch.empty_like(src).copy_(src) on a "
                                    "bfloat16 block"},
          "card": card})
    return out


def p_diff(np, a, b, limit=20) -> dict:
    """Where two p-value arrays differ: the count, the largest |a - b| and
    the first ``limit`` cells as ``[module, statistic, a, b]``."""
    cells = np.argwhere(a != b)
    return {"differ": int(len(cells)),
            "max_abs": float(np.abs(a - b).max()) if len(cells) else 0.0,
            "cells": [[int(m), int(k), float(a[m, k]), float(b[m, k])]
                      for m, k in cells[:limit]]}


#: launches of the single-bucket gather entries on every path: none
SINGLE = {"gather_submatrix_fused": 0, "gather_submatrix_fused_local": 0}
MANY = "gather_submatrix_fused_many"


def discovery_props(torch, np, kw, labels, dev, card) -> None:
    """The main path's discovery buckets built twice at full width:
    ``build_buckets`` on the host source (its blocks gathered and
    narrowed on the host) and on the same matrices narrowed to float32 on
    the card (gathered there); every ``DiscProps`` tensor ``torch.equal``,
    stored and derived network. Seconds of each build."""
    from netrep_tpu_torch.parallel.engine import ModuleSpec, build_buckets
    from netrep_tpu_torch.utils.config import EngineConfig

    labels = np.asarray(labels, dtype=object)
    specs = [ModuleSpec(k, np.flatnonzero(labels == k),
                        np.flatnonzero(labels == k))
             for k in sorted(set(labels) - {"0"}, key=int)]
    pool = np.arange(len(labels), dtype=np.int32)
    host = [kw[f]["disc"] for f in ("correlation", "network", "data")]
    on_card = [torch.as_tensor(h, device=dev, dtype=torch.float32)
               for h in host]
    report = {}
    for name, cfg in (("stored", EngineConfig()),
                      ("derived", EngineConfig(
                          network_from_correlation=BETA))):
        got = {}
        for where, mats_ in (("host", host), ("card", on_card)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[where] = build_buckets(*mats_, specs, pool, cfg, dev)
            torch.cuda.synchronize()
            report[f"{name}_{where}_s"] = time.perf_counter() - t0
        pairs = [(x, y) for a, b in zip(got["host"], got["card"])
                 for x, y in zip(a["disc"], b["disc"])]
        if len(got["host"]) != len(got["card"]) or not all(
                torch.equal(x, y) for x, y in pairs):
            raise RuntimeError(f"discovery props ({name} network) from the "
                               "host source differ from the card's")
        report[f"{name}_buckets"] = len(got["host"])
    del on_card
    torch.cuda.empty_cache()
    emit({"phase": "discovery_props", "bit_equal": True, **report,
          "card": card})


def discovery_twins(torch, np, tops, module_preservation, kw, paths,
                    card) -> None:
    """Each path of ``paths`` (label → its result, launches and call)
    called again with the discovery dataset handed over as float32 CUDA
    tensors, so it is narrowed and gathered on the card (the other
    placement): observed values, p-values and nulls (materialized) or
    tallies (streaming) bit-equal, and every launch count equal (the
    discovery blocks are gathered by indexing wherever they lie)."""
    on_card = {f: dict(kw[f], disc=torch.as_tensor(
        kw[f]["disc"], device="cuda", dtype=torch.float32))
        for f in ("network", "data", "correlation")}
    report = {}
    for name, (res, used, call) in paths.items():
        tops.reset_launches()
        twin = module_preservation(**{**kw, **on_card, **call})
        got = {fn.__name__: fn.launches for fn in tops.kernels()}
        if got != used:
            raise RuntimeError(f"discovery twin {name}: launches {got}, "
                               f"expected {used}")
        pairs = (list(zip(res.values(), twin.values()))
                 if isinstance(res, dict) else [(res, twin)])
        for a, b in pairs:
            same_ = (np.array_equal(a.observed, b.observed)
                     and np.array_equal(a.p_values, b.p_values)
                     and (np.array_equal(a.nulls, b.nulls, equal_nan=True)
                          if a.nulls is not None else all(
                              np.array_equal(getattr(a, f), getattr(b, f))
                              for f in ("counts_hi", "counts_lo",
                                        "counts_eff"))))
            if not same_:
                raise RuntimeError(f"discovery twin {name}: the result "
                                   "differs from the host discovery's")
        one = next(iter(res.values())) if isinstance(res, dict) else res
        two = next(iter(twin.values())) if isinstance(twin, dict) else twin
        report[name] = {"engine_s": one.profile["engine_s"],
                        "twin_engine_s": two.profile["engine_s"],
                        "gather_launches": used[MANY]}
    del on_card
    torch.cuda.empty_cache()
    emit({"phase": "discovery_twins", "bit_equal": True, "paths": report,
          "card": card})


def row_launches(chunks, R, mats, ring):
    """Gather launches of a row-sharded call of ``chunks`` chunks on R row
    shards: per chunk, one per step, shard and matrix on the ring (one per
    block and matrix, psum); the observed pass one per block and matrix;
    none for the discovery build, whose blocks are gathered by indexing
    wherever the discovery matrices lie. Ring steps: R - 1 per chunk,
    each one launch per block and matrix."""
    per_chunk = R * R * mats if ring else R * mats
    out = {MANY: chunks * per_chunk + R * mats, **SINGLE}
    if ring:
        out["ring_shift_dma"] = chunks * (R - 1) * R * mats
    return out


def storage_paths(cfg, dtype, row_mesh, perm_mesh, chunks):
    """The main path's calls with ``cfg``'s storage in ``dtype``, by label:
    ``(needs, expect, call)`` — the kernels that must launch, exact launch
    counts and the call's arguments (single-test calls name ``test``)."""
    def st(**kw):
        return dataclasses.replace(cfg, dtype=dtype, **kw)

    R = row_mesh.shape["row"]
    composed = st(stat_mode="xla", gather_mode="fused")
    one = dict(test="test")
    return {
        "main/materialized": (["fused_stats_values"], {}, dict(
            config=st(), **one)),
        "main/streaming": (["fused_stats_counts"], {}, dict(
            config=st(), store_nulls=False, **one)),
        "composed/materialized": ([MANY], {MANY: chunks * 2, **SINGLE},
                                  dict(config=composed, **one)),
        "composed/streaming": ([MANY], {MANY: chunks * 2, **SINGLE}, dict(
            config=composed, store_nulls=False, **one)),
        "derived/fused": (["fused_stats_values"], {MANY: 0, **SINGLE}, dict(
            config=st(network_from_correlation=BETA), **one)),
        "derived/composed": ([MANY], {MANY: chunks, **SINGLE}, dict(
            config=st(network_from_correlation=BETA, stat_mode="xla"),
            **one)),
        "ring/materialized": (["ring_shift_dma", MANY],
                              row_launches(chunks, R, 2, True),
                              dict(config=st(matrix_sharding="row"),
                                   mesh=row_mesh, **one)),
        "psum/streaming": ([MANY], row_launches(chunks, R, 2, False), dict(
            config=st(matrix_sharding="row", stat_mode="xla"),
            store_nulls=False, mesh=row_mesh, **one)),
        "perm_mesh/streaming": (["fused_stats_counts"], {}, dict(
            config=st(), store_nulls=False, mesh=perm_mesh, **one)),
        "multi_test/materialized": (["fused_stats_values"], {}, dict(
            config=st(), vmap_tests=True)),
    }


def bf16_phase(np, pv, drive, paths, f32_ref, card, one_test):
    """The main path's calls again with ``EngineConfig(dtype='bfloat16')``:
    ``paths`` as :func:`storage_paths` gives them in bfloat16, ``f32_ref``
    each label's float32 run of the same call (``(result, memory)``),
    ``one_test`` the data arguments of a single-test call (the discovery
    and the one test dataset). Checks, as the float32 runs are checked:
    materialized and streaming runs of one path equal in p-values and
    tallies; the ring, psum and perm-mesh runs and the multi-test run's
    first cohort equal the bfloat16 main path in p-values; nulls within
    TOL of it where the composed statistics run. Reports each run's null
    seconds and held GiB beside the float32 run's, and the p-values that
    differ from the float32 run's (they may: the inputs differ). Returns
    ``{label: (result, launches)}``."""
    out = {}
    report = {}
    for label, (needs, expect, call) in paths.items():
        if call.get("test") == "test":
            call = {**one_test, **call}
        res, used, mem = drive("bf16_storage", needs, expect, **call)
        out[label] = (res, used)
        ref, ref_mem = f32_ref[label]
        one = res["test"] if isinstance(res, dict) else res
        one32 = ref["test"] if isinstance(ref, dict) else ref
        report[label] = {
            "null_s": one.profile["null_s"], "f32_null_s":
                one32.profile["null_s"],
            "null_held_gib": mem["null_held_gib"],
            "f32_null_held_gib": ref_mem["null_held_gib"],
            "peak_gib": mem["peak_gib"], "f32_peak_gib": ref_mem["peak_gib"],
            "p_vs_f32": p_diff(np, one.p_values, one32.p_values)}
    main = out["main/materialized"][0]
    for a, b in (("main/materialized", "main/streaming"),
                 ("composed/materialized", "composed/streaming")):
        ra, rb = out[a][0], out[b][0]
        if not np.array_equal(ra.p_values, rb.p_values):
            raise RuntimeError(f"bf16 {a} and {b}: p-values differ")
        check_tallies(np, pv, ra, rb)
    errs = {}
    for label in ("ring/materialized", "psum/streaming",
                  "perm_mesh/streaming", "multi_test/materialized"):
        res = out[label][0]
        one = res["test"] if isinstance(res, dict) else res
        if not np.array_equal(one.p_values, main.p_values):
            raise RuntimeError(f"bf16 {label}: p-values differ from the "
                               "bf16 main path's")
    for label in ("composed/materialized", "ring/materialized"):
        errs[label] = nulls_err(np, out[label][0].nulls, main.nulls)
        if errs[label] > TOL:
            raise RuntimeError(f"bf16 {label}: null differs from the bf16 "
                               f"main path's by {errs[label]}")
    emit({"phase": "bf16_storage_check", "runs": report,
          "max_abs_null_vs_bf16_main": errs, "tolerance": TOL,
          "p_values_equal_bf16_main": ["main/streaming", "ring/materialized",
                                       "psum/streaming",
                                       "perm_mesh/streaming",
                                       "multi_test/materialized"],
          "card": card})
    return out


def screened_phase(np, pv, drive, composed, composed_adaptive, fused_run,
                   perm_mesh, many, card):
    """``EngineConfig(stat_mode='xla', null_precision='bf16_rescue')`` at
    the main path's widths: materialized and streaming against the float32
    composed runs ``composed[store]`` (counts and p-values equal; the
    materialized null's rows equal the float32 rows exactly where the
    screen rescued them, so the count of equal rows is the rescued count),
    adaptive at a ceiling of ADAPTIVE_PERM against ``composed_adaptive``
    (retirements, counts and p-values equal) and on the 2×1 perm mesh
    (tallies equal). Reports each run's rescued fraction and null seconds
    beside the float32 composed null's; on the perm mesh each shard
    rescues its own rows, so ``rescue.dispatches`` counts one per shard
    and chunk with a rescue (16 there, where a rescue of the whole chunk
    counted 8 before the per-shard rescue). Then the GPD tail fit on the
    float32 main-path null (``fused_run.tail_pvalues``): seconds, fitted
    cells. Returns the launches by run."""
    from netrep_tpu_torch.utils.config import EngineConfig

    cfg = EngineConfig(stat_mode="xla", null_precision="bf16_rescue")
    runs, launches, report = {}, {}, {}
    for label, ref, call in (
            ("materialized", composed[True], dict(store_nulls=True)),
            ("streaming", composed[False], dict(store_nulls=False)),
            ("adaptive", composed_adaptive, dict(
                adaptive=True, n_perm=ADAPTIVE_PERM, completed=None)),
            ("perm_mesh", composed[False], dict(store_nulls=False,
                                                mesh=perm_mesh))):
        res, used, mem = drive("screened", [many], config=cfg, **call)
        rescue = res.profile["rescue"]
        if not np.array_equal(res.p_values, ref.p_values):
            raise RuntimeError(f"screened {label}: p-values differ from the "
                               "float32 composed run's")
        mine, theirs = tallies_of(pv, res), tallies_of(pv, ref)
        if not all(np.array_equal(a, b) for a, b in zip(mine, theirs)):
            raise RuntimeError(f"screened {label}: counts differ from the "
                               "float32 composed run's")
        row = {"rescue": rescue, "null_s": res.profile["null_s"],
               "f32_null_s": ref.profile["null_s"],
               "null_held_gib": mem["null_held_gib"],
               "nulls_exact": res.nulls_exact, "counts_equal": True,
               "p_values_equal": True}
        if res.nulls is not None:
            if res.nulls_exact:
                raise RuntimeError("a screened null is marked exact")
            k = res.completed if label == "materialized" else min(
                res.completed, ref.completed)
            equal = int(np.all((res.nulls[:k] == ref.nulls[:k])
                               | (np.isnan(res.nulls[:k])
                                  & np.isnan(ref.nulls[:k])), axis=(1, 2))
                        .sum())
            row["rows_equal_f32"] = equal
            if label == "materialized" and equal != rescue["rescued"]:
                raise RuntimeError(f"screened: {equal} rows equal the "
                                   f"float32 rows, {rescue['rescued']} were "
                                   "rescued")
        if label == "adaptive":
            if not (np.array_equal(res.n_perm_used, ref.n_perm_used)
                    and res.completed == ref.completed):
                raise RuntimeError("screened adaptive: retirements differ "
                                   "from the float32 composed run's")
            row["n_perm_used_sum"] = int(np.sum(res.n_perm_used))
            row["retirements_equal"] = True
        runs[label] = res
        launches[label] = used
        report[label] = row
    t0 = time.perf_counter()
    p_tail, ok = fused_run.tail_pvalues()
    tail_s = time.perf_counter() - t0
    screened = runs["materialized"]
    try:
        screened.tail_pvalues()
    except ValueError:
        refused = True
    else:
        raise RuntimeError("tail_pvalues accepted a screened null")
    emit({"phase": "screened_check", "runs": report,
          "gpd_tail": {"seconds": tail_s, "cells": int(p_tail.size),
                       "fitted": int(ok.sum()),
                       "min_p_tail": float(np.nanmin(p_tail))
                       if ok.any() else None,
                       "n_perm": int(fused_run.completed),
                       "screened_refused": refused},
          "card": card})
    return launches



#: the grid phase: the seed of the changed cohort's new noise
GRID_CHANGE_SEED = SEED + 1


def expect_launches(phase, got, want):
    """Fails unless every kernel count in ``want`` is met exactly."""
    for name, n in want.items():
        if got[name] != n:
            raise RuntimeError(f"{phase}: {got[name]} launches of {name}, "
                               f"expected {n}")


def grid_phase(torch, np, tops, kw, labels, card, dev, n_perm=N_PERM,
               ceiling=ADAPTIVE_PERM) -> dict:
    """The all-pairs grid (``grid_preservation``) on the three cohorts of
    ``kw`` (``disc``, ``test``, ``test2`` as host float32 arrays), every
    one a grid row with the planted modules and a column: six cells, three
    column packs of two.

    1. A fixed grid of ``n_perm`` permutations and an adaptive grid at a
       ``ceiling``, under the default config (fused statistics) and under
       ``stat_mode='xla'`` (the gather kernel); every cell held to its solo
       ``module_preservation`` call with the same config and seed (equal
       p-values, counts and ``n_perm_used``; observed statistics: bit for
       bit or the largest deviation), each grid's launches to one per
       chunk and union bucket still active (fused) or two per chunk
       (gather), and its wall time beside the six solo calls'. Then the
       pack's null values beside the solo nulls, bit for bit or the
       largest deviation (a ``GridPackedEngine`` of one column and the
       solo engines, ``n_perm`` permutations).
    2. The adaptive fused grid again into its ``grid_dir``: every cell
       reused, no permutation, no launch.
    3. Cohort ``test2`` changed (new noise from GRID_CHANGE_SEED):
       exactly its row and column recompute, warm-started, each cell equal
       to the solo call given the stored cell's tallies as
       ``adaptive_priors``.
    4. The adaptive fused grid into a fresh directory, interrupted by a
       ``KeyboardInterrupt`` in its second pack, then the same call: the
       first run returns the first pack's cells and keeps the second's
       checkpoint, the second equals the uninterrupted grid.

    Per run: wall seconds, ``perms_evaluated``, packs, dedup hits and
    misses, launches against the expected count, chunks per pack, the
    most device memory held at a chunk boundary and the peak. Returns
    each run's launches by key."""
    import os
    import shutil
    import tempfile

    from netrep_tpu_torch.models.grid import grid_preservation
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.ops.sequential import StopRule
    from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine
    from netrep_tpu_torch.serve import packer
    from netrep_tpu_torch.utils.config import EngineConfig
    from netrep_tpu_torch.utils.telemetry import read_events

    names = ("disc", "test", "test2")
    fields = ("network", "data", "correlation")
    inputs = {f: {n: kw[f][n] for n in names} for f in fields}
    assign = {n: list(labels) for n in names}
    fused_cfg = EngineConfig()
    gather_cfg = EngineConfig(stat_mode="xla")
    chunk = fused_cfg.chunk_size
    mods = sorted(set(labels) - {"0"}, key=int)
    sizes = np.array([int((np.asarray(labels) == k).sum()) for k in mods])
    caps = np.array([fused_cfg.rounded_cap(int(s)) for s in sizes])
    out: dict = {}
    real_update = packer.PackMonitor.update
    chunks_log: list = []
    held: list = []

    def logged_update(self, vals, take):
        # a measurement hook only: the chunk's pack and the memory held
        chunks_log.append(self)
        if dev.type == "cuda":
            held.append(torch.cuda.memory_allocated())
        return real_update(self, vals, take)

    def per_pack(log):
        seen = []
        for m in log:
            if not seen or seen[-1][0] is not m:
                seen.append([m, 0])
            seen[-1][1] += 1
        return [n for _m, n in seen]

    def run(label, cfg, adaptive, grid_dir=None, data=None, stop_at=None):
        events = os.path.join(root, f"{label}.jsonl")
        call = dict(data or inputs, module_assignments=assign,
                    n_perm=ceiling if adaptive else n_perm, seed=SEED,
                    config=cfg, adaptive=adaptive, grid_dir=grid_dir,
                    device=dev, telemetry=events)
        tops.reset_launches()
        chunks_log.clear()
        held.clear()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        update = logged_update
        if stop_at is not None:
            def update(self, vals, take):
                if len(chunks_log) + 1 == stop_at:
                    raise KeyboardInterrupt
                return logged_update(self, vals, take)
        packer.PackMonitor.update = update
        try:
            t0 = time.perf_counter()
            g = grid_preservation(**call)
            wall = time.perf_counter() - t0
        finally:
            packer.PackMonitor.update = real_update
        launches = {fn.__name__: fn.launches for fn in tops.kernels()}
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if dev.type == "cuda" else None)
        rec = {"phase": "grid", "run": label,
               "stat_mode": cfg.resolved_stat_mode(),
               "adaptive": adaptive, "wall_s": wall,
               "perms_evaluated": g.stats["perms_evaluated"],
               "packs": g.stats["packs"],
               "cells": {k: g.stats[k] for k in (
                   "cells_total", "cells_computed", "cells_reused",
                   "cells_warmstarted")},
               "dedup": g.stats["dedup"], "launches": launches,
               "input_s": g.profile["input_s"],
               "pack_s": g.profile["packs"],
               "null_s": [e["data"]["s"] for e in read_events(events)
                          if e["ev"] == "null_run_end"],
               "dispatch_s": sum(e["data"]["s"] for e in read_events(events)
                                 if e["ev"] == "dispatch"),
               "chunks_per_pack": per_pack(chunks_log),
               "null_held_gib": max(held, default=0) / 2**30,
               "peak_gib": peak, "card": card}
        chunks_log.clear()
        return g, launches, rec

    def expected(g, cfg, computed=None):
        """Launches the union buckets of the ``computed`` cells (default:
        all) should make: per pack, one fused launch per chunk and bucket
        holding an active module, or two gather launches (correlation,
        network) per chunk."""
        fused = gather = 0
        for t in names:
            cells = [g.cell(d, t) for d in names if d != t
                     and t in g.results.get(d, {})
                     and (computed is None or (d, t) in computed)]
            if not cells:
                continue
            used = np.concatenate([
                np.full(len(c.module_labels), c.completed)
                if c.n_perm_used is None else np.asarray(c.n_perm_used)
                for c in cells])
            cc = np.concatenate([
                [cfg.rounded_cap(int(s)) for s in c.n_vars_present]
                for c in cells])
            n_chunks = -(-int(used.max()) // chunk)
            if cfg.stat_mode == "xla":
                gather += 2 * n_chunks
            else:
                fused += adaptive_launches(np, used, cc, chunk)
        return {"fused_stats_values": fused,
                "gather_submatrix_fused_many": gather,
                "fused_stats_counts": 0}

    def solo(d, t, cfg, adaptive, data=None, priors=None):
        src = data or inputs
        call = {f: {n: src[f][n] for n in (d, t)} for f in fields}
        extra = {}
        if priors is not None:
            extra["adaptive_priors"] = priors
        tops.reset_launches()
        t0 = time.perf_counter()
        res = module_preservation(
            **call, module_assignments=assign[d], discovery=d, test=t,
            n_perm=ceiling if adaptive else n_perm, seed=SEED, config=cfg,
            adaptive=adaptive, device=dev, **extra)
        wall = time.perf_counter() - t0
        return res, wall, {fn.__name__: fn.launches for fn in tops.kernels()}

    def same_as_solo(what, cell, ref):
        hi, lo, eff = pv.tail_counts(ref.observed, ref.nulls[:ref.completed])
        ok = (np.array_equal(cell.p_values, ref.p_values)
              and np.array_equal(cell.counts_hi, hi)
              and np.array_equal(cell.counts_lo, lo)
              and np.array_equal(cell.counts_eff, eff)
              and (ref.n_perm_used is None
                   or np.array_equal(cell.n_perm_used, ref.n_perm_used)))
        if not ok:
            raise RuntimeError(f"grid cell {what} differs from its solo "
                               "call in p-values, counts or n_perm_used")
        dev_obs = float(np.abs(cell.observed - ref.observed).max())
        if dev_obs > TOL:
            raise RuntimeError(f"grid cell {what}: observed {dev_obs}")
        return dev_obs

    def same_cell(what, c, w):
        if not (np.array_equal(c.p_values, w.p_values)
                and np.array_equal(c.counts_hi, w.counts_hi)
                and np.array_equal(c.counts_lo, w.counts_lo)
                and np.array_equal(c.observed, w.observed)
                and (w.n_perm_used is None or np.array_equal(
                    c.n_perm_used, w.n_perm_used))):
            raise RuntimeError(f"{what} differs")

    def same_cells(what, got, want):
        for d, t, w in want.cells():
            same_cell(f"{what}: cell {d}->{t}", got.cell(d, t), w)

    root = tempfile.mkdtemp(prefix="netrep_grid_")
    try:
        grids, recs = {}, {}
        for cfg, mode in ((fused_cfg, "fused"), (gather_cfg, "xla")):
            for adaptive in (False, True):
                label = f"{'adaptive' if adaptive else 'fixed'}_{mode}"
                gdir = (os.path.join(root, "main")
                        if (mode, adaptive) == ("fused", True) else None)
                # the six solo calls first, after one uncounted call
                # that pays the config's first-use costs
                solo("disc", "test", cfg, adaptive)
                refs, solo_s, solo_launches = {}, 0.0, {}
                for d in names:
                    for t in names:
                        if d == t:
                            continue
                        refs[(d, t)], wall, used = solo(d, t, cfg, adaptive)
                        solo_s += wall
                        for k, v in used.items():
                            solo_launches[k] = solo_launches.get(k, 0) + v
                g, launches, rec = run(label, cfg, adaptive, gdir)
                want = expected(g, cfg)
                expect_launches(f"grid {label}", launches, want)
                devs = {f"{d}->{t}": same_as_solo(f"{label} {d}->{t}", cell,
                                                  refs[(d, t)])
                        for d, t, cell in g.cells()}
                del refs
                rec.update(expected_launches=want,
                           solo_wall_s_sum=solo_s,
                           solo_launches_sum=solo_launches,
                           observed_max_abs_vs_solo=max(devs.values()),
                           observed_bit_equal_vs_solo=all(
                               v == 0.0 for v in devs.values()),
                           cells_equal_solo=True)
                emit(rec)
                out[("grid", label)] = launches
                grids[label], recs[label] = g, rec

        # the pack's null values beside the solo engines' (one column)
        specs = [ModuleSpec(k, np.flatnonzero(np.asarray(labels) == k),
                            np.flatnonzero(np.asarray(labels) == k))
                 for k in mods]
        pool = np.arange(len(labels))

        def src(n):
            return (inputs["correlation"][n], inputs["network"][n],
                    inputs["data"][n])

        values = {}
        for cfg, mode in ((fused_cfg, "fused"), (gather_cfg, "xla")):
            eng = packer.GridPackedEngine(
                [src("disc"), src("test2")], *src("test"), [specs, specs],
                pool, config=cfg, device=dev)
            nulls, _ = eng.run_null(n_perm, key=[SEED, SEED])
            eng.release()
            del eng
            devs = []
            for r, d in enumerate(("disc", "test2")):
                e = PermutationEngine(*src(d), *src("test"), specs, pool,
                                      config=cfg, device=dev)
                ref, _ = e.run_null(n_perm, key=SEED)
                e.release()
                part = nulls[:, r * len(specs):(r + 1) * len(specs)]
                devs.append(nulls_err(np, part, ref))
            values[mode] = {"null_max_abs_vs_solo": max(devs),
                            "null_bit_equal_vs_solo": max(devs) == 0.0}
        emit({"phase": "grid_values", "n_perm": n_perm, "column": "test",
              "cells": ["disc->test", "test2->test"], **values,
              "card": card})

        # every cell again from the manifest
        g, launches, rec = run("resumed", fused_cfg, True,
                               os.path.join(root, "main"))
        if (g.stats["cells_reused"] != 6 or g.stats["perms_evaluated"]
                or g.stats["packs"] or any(launches.values())):
            raise RuntimeError(f"resumed grid recomputed: {g.stats}")
        same_cells("resumed grid", g, grids["adaptive_fused"])
        emit(rec)

        # one cohort changed: its row and column recompute, warm-started
        changed = {f: dict(inputs[f]) for f in fields}
        x2 = inputs["data"]["test2"]
        rng = np.random.default_rng(GRID_CHANGE_SEED)
        x2 = (x2 + 0.5 * rng.standard_normal(x2.shape)).astype(np.float32)
        changed["data"]["test2"], changed["correlation"]["test2"], \
            changed["network"]["test2"] = (
                m.to(torch.float32).cpu().numpy()
                for m in mats(torch, x2, dev))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        prev = grids["adaptive_fused"]
        g, launches, rec = run("changed_cohort", fused_cfg, True,
                               os.path.join(root, "main"), data=changed)
        touched = {(d, t) for d, t, _ in g.cells() if "test2" in (d, t)}
        if (g.stats["cells_computed"], g.stats["cells_reused"],
                g.stats["cells_warmstarted"]) != (4, 2, 4):
            raise RuntimeError(f"changed cohort: {g.stats}")
        devs = {}
        for d, t, cell in g.cells():
            if (d, t) not in touched:
                same_cell(f"untouched cell {d}->{t}", cell, prev.cell(d, t))
                continue
            p = prev.cell(d, t)
            priors = (np.asarray(p.counts_hi, np.int64),
                      np.asarray(p.counts_lo, np.int64),
                      np.asarray(p.n_perm_used, np.int64))
            ref, _w, _u = solo(d, t, fused_cfg, True, data=changed,
                               priors=priors)
            devs[f"{d}->{t}"] = same_as_solo(f"warm {d}->{t}", cell, ref)
        rec.update(recomputed=sorted(f"{d}->{t}" for d, t in touched),
                   warm_cells_equal_solo_with_priors=True,
                   observed_max_abs_vs_solo=max(devs.values()),
                   expected_launches=expected(g, fused_cfg, touched))
        expect_launches("grid changed_cohort", launches,
                        rec["expected_launches"])
        emit(rec)
        out[("grid", "changed_cohort")] = launches

        # interrupted in its second pack, then resumed
        first = grids["adaptive_fused"]
        first_pack = recs["adaptive_fused"]["chunks_per_pack"][0]
        gdir = os.path.join(root, "interrupted")
        part, _l, rec = run("interrupted", fused_cfg, True, gdir,
                            stop_at=first_pack + 1)
        kept = os.listdir(os.path.join(gdir, "ckpt"))
        n_part = sum(1 for _ in part.cells())
        if n_part != 2 or len(kept) != 1:
            raise RuntimeError(f"interrupted grid: {n_part} cells, "
                               f"checkpoints {kept}")
        emit(dict(rec, cells_returned=n_part, checkpoints_kept=len(kept)))
        g, launches, rec = run("interrupted_resumed", fused_cfg, True, gdir)
        same_cells("resumed interrupted grid", g, first)
        if g.stats["cells_reused"] != 2 or os.listdir(
                os.path.join(gdir, "ckpt")):
            raise RuntimeError(f"interrupted grid resumed: {g.stats}")
        emit(dict(rec, equal_uninterrupted=True))
        out[("grid", "interrupted_resumed")] = launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def grid_only() -> int:
    """``--grid``: the grid phase alone, on the three cohorts."""
    setup = mode_setup()
    if setup is None:
        return 1
    torch, np, dev, card = setup
    from netrep_tpu_torch import ops as tops

    _sizes, labels, cohorts = make_cohorts(np)
    kw = host_kw(torch, np, dev, cohorts, labels)
    grid_phase(torch, np, tops, kw, labels, card, dev)
    print(card_line(), flush=True)
    return 0


#: the serve phase: the crash/recover and daemon drills' fixture (genes,
#: modules, samples; ``make_mixed_pair`` by parameters), their depth, the
#: crash point and checkpoint cadence, and the batching window
SERVE_FIXTURE = dict(genes=4000, modules=10, n_samples=32, seed=11)
SERVE_DRILL_PERM, SERVE_CRASH_AT, SERVE_CKPT_EVERY = 2048, 640, 256
SERVE_WINDOW_S = 1.0


def serve_daemon_start(chunk: int) -> tuple:
    """The serve phase's daemon (drill 3) started in a fresh directory:
    ``(process, spawn wall clock, directory)``; it boots while drills 1
    and 2 run. Its socket's path is relative to that directory (a unix
    socket's path is bounded, a temporary directory's is not)."""
    import tempfile

    root = tempfile.mkdtemp(prefix="netrep_serve_daemon_")
    code = (
        "import sys\n"
        f"sys.path.insert(0, {here()!r})\n"
        "from netrep_tpu_torch.serve.server import daemon_args, "
        "serve_daemon\n"
        f"sys.exit(serve_daemon(daemon_args(socket='serve.sock', "
        f"chunk={chunk}, journal={os.path.join(root, 'd.jsonl')!r})))\n")
    t_spawn = time.time()
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, t_spawn, root


def serve_phase(torch, np, tops, kw, labels, card, dev) -> dict:
    """:func:`serve_drills` with drill 3's daemon started first, so that
    its boot overlaps drills 1 and 2; the daemon never outlives the
    phase."""
    import shutil

    daemon = serve_daemon_start(128)
    proc, _t, root = daemon
    try:
        return serve_drills(torch, np, tops, kw, labels, card, dev, daemon)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(root, ignore_errors=True)


def serve_drills(torch, np, tops, kw, labels, card, dev, daemon) -> dict:
    """The single server (``netrep_tpu_torch.serve``) on the three cohorts
    of ``kw`` (host float32), in three drills:

    1. **In process, at full width.** Server A (fused statistics, pairwise
       packing; tenants ``acme`` weight 2 and ``beta`` weight 1, the
       cohorts registered in memory) takes six requests submitted at once
       under a batching window: a pack of four on (disc, test) — two
       module subsets of 25, the whole set ``'two.sided'``, an adaptive
       request at a 10,000 ceiling, across both tenants — and two
       multi-test requests ``test=[test, test2]`` (all modules, a
       subset). Server B (``stat_mode='xla'``,
       ``cross_pair_packing=True``, packs of two) takes a cross-pair pack
       (disc→test2 and test→test2) and a pack of two on (disc, test). Each served result is held to its solo
       ``module_preservation`` call on the card (equal p-values, counts
       and ``n_perm_used``; the pack's null rows, read by a measurement
       hook on ``run_null_monitored``, bit-equal under fused statistics
       and within TOL composed), each pack's launches to one fused launch
       per chunk and active union bucket (times the cohorts of a
       multi-test pack) or two gathers a chunk. Each server runs its
       requests twice: the second round builds nothing (pool hits only).
       Per round: wall, latency p50/max (first request apart), packs,
       pool hits/misses, GiB held by the pool, by the registered datasets
       and at peak, requests/s.
    2. **Crash and recover** on a journaled server with a fixture
       registered by parameters (SERVE_FIXTURE): a ``crash`` plan at
       SERVE_CRASH_AT kills the worker mid-pack; a fresh server with
       ``recover=True`` completes every request bit-identical to an
       uncrashed server, resumed from the pack's checkpoint (no more than
       one checkpoint interval recomputed).
    3. **The daemon over a socket**: ``daemon``, from
       :func:`serve_daemon_start`, a subprocess on
       ``serve_daemon(daemon_args(...))`` (its ``ready_s`` from the spawn to
       its ready line's own clock); ``ping``, ``register_fixture``,
       two ``analyze`` bit-equal to the same requests in process,
       ``metrics``, ``stats``, ``shutdown`` with its ``drained`` line and
       exit code 0.

    Returns each round's launches by key."""
    import os
    import shutil
    import tempfile

    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.parallel.engine import PermutationEngine
    from netrep_tpu_torch.parallel.multitest import MultiTestEngine
    from netrep_tpu_torch.serve import (
        InProcessClient, PreservationServer, ServeConfig, SocketClient,
        packer,
    )
    from netrep_tpu_torch.utils.config import EngineConfig, FaultPolicy
    from netrep_tpu_torch.utils.telemetry import read_events

    labels = list(labels)
    mods = sorted(set(labels) - {"0"}, key=int)
    half = len(mods) // 2
    fused_cfg = EngineConfig(chunk_size=128)
    xla_cfg = EngineConfig(chunk_size=128, stat_mode="xla")
    chunk = fused_cfg.chunk_size
    fields = ("network", "correlation", "data")
    out: dict = {}

    # measurement hook: each pack's null, monitor and launches
    log: list = []
    real = {PermutationEngine: PermutationEngine.run_null_monitored,
            MultiTestEngine: MultiTestEngine.run_null_monitored}

    def hooked(cls):
        def run(self, n_perm, key, monitor, *a, **k):
            if not isinstance(monitor, packer.PackMonitor):
                return real[cls](self, n_perm, key, monitor, *a, **k)
            before = {fn.__name__: fn.launches for fn in tops.kernels()}
            res = real[cls](self, n_perm, key, monitor, *a, **k)
            log.append(dict(
                multi=cls is MultiTestEngine, nulls=res[0],
                plans=monitor.plans,
                launches={fn.__name__: fn.launches - before[fn.__name__]
                          for fn in tops.kernels()}))
            return res
        return run

    def solo(d, t, cfg, **call):
        tests = t if isinstance(t, list) else [t]
        res = module_preservation(
            **{f: {n: kw[f][n] for n in [d] + tests} for f in fields},
            module_assignments=labels, discovery=d, test=t, config=cfg,
            simplify=False, device=dev, **call)
        return res[d]

    def held_to_solo(what, res, ref, nulls, plan, cfg):
        """p-values, counts, n_perm_used equal; the pack's null rows of
        this request against the solo null; returns the largest row
        deviation."""
        hi, lo, eff = pv.tail_counts(ref.observed, ref.nulls[:ref.completed])
        # an adaptive member's ``completed`` is its pack's depth (capped at
        # its n_perm), its solo run's the deepest module's (ROADMAP.md
        # Queue 3); the p-values read n_perm_used
        diff = {f: int(np.sum(np.asarray(res[k]) != np.asarray(v)))
                for f, k, v in (("p", "p_values", ref.p_values),
                                ("hi", "counts_hi", hi),
                                ("lo", "counts_lo", lo),
                                ("eff", "counts_eff", eff))}
        if ref.n_perm_used is None:
            diff["completed"] = int(res["completed"] != ref.completed)
        else:
            diff["n_used"] = int(np.sum(np.asarray(res["n_perm_used"])
                                        != ref.n_perm_used))
        if any(diff.values()):
            raise RuntimeError(
                f"serve {what}: differs from its solo call: {diff}, "
                f"observed max dev "
                f"{float(np.abs(res['observed'] - ref.observed).max())}")
        used = (np.full(len(ref.module_labels), ref.completed)
                if ref.n_perm_used is None else ref.n_perm_used)
        err = 0.0
        for k, u in enumerate(used):
            a = nulls[:u, plan.base + k]
            b = ref.nulls[:u, k]
            err = max(err, nulls_err(np, a, b))
        if err > (0.0 if cfg.stat_mode != "xla" else TOL):
            raise RuntimeError(f"serve {what}: null rows differ from the "
                               f"solo null by {err}")
        obs_err = float(np.abs(np.asarray(res["observed"])
                               - ref.observed).max())
        if obs_err > TOL:
            raise RuntimeError(f"serve {what}: observed {obs_err}")
        return err, obs_err

    def expected(entry, results, cfg):
        """Launches of one pack: per chunk, one fused launch per union
        bucket holding an active module (times the cohorts of a
        multi-test pack), or two gathers while any module is active."""
        used, caps = [], []
        for p in entry["plans"]:
            r = results[p.seed]
            u = r["n_perm_used"] if not entry["multi"] else None
            used += (list(u) if u is not None else [r["completed"]] * p.k)
            caps += [cfg.rounded_cap(int(s)) for s in p.sizes]
        used = np.asarray(used)
        if cfg.stat_mode == "xla":
            return {"gather_submatrix_fused_many":
                    2 * -(-int(used.max()) // chunk),
                    "fused_stats_values": 0, "fused_stats_counts": 0}
        cohorts = len(results[entry["plans"][0].seed]["tests"]) \
            if entry["multi"] else 1
        return {"fused_stats_values":
                cohorts * adaptive_launches(np, used, caps, chunk),
                "gather_submatrix_fused_many": 0, "fused_stats_counts": 0}

    def serve_rounds(name, cfg, tenants, registrations, requests, refs,
                     max_pack=4, **server_kw):
        """Register, then run ``requests`` (label, tenant, d, t, call)
        twice, submitted at once in this order; each round's results held
        to ``refs``. The packable requests come first and fill whole
        packs, so one batching window covers their submission (a submit
        builds its plan on the host: ``submit_s``)."""
        root = tempfile.mkdtemp(prefix="netrep_serve_")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        srv = PreservationServer(ServeConfig(
            engine=cfg, max_pack=max_pack, pool_size=8, slo_s=600.0,
            pack_window_s=SERVE_WINDOW_S,
            telemetry=os.path.join(root, "tel.jsonl"), **server_kw))
        client = InProcessClient(srv)
        try:
            t0 = time.perf_counter()
            for tenant, weight in tenants:
                client.register_tenant(tenant, weight)
            for tenant, d, assigned in registrations:
                client.register_dataset(
                    tenant, d, network=kw["network"][d],
                    correlation=kw["correlation"][d], data=kw["data"][d],
                    assignments=labels if assigned else None)
            register_s = time.perf_counter() - t0
            rounds = []
            for rnd in (1, 2):
                log.clear()
                tops.reset_launches()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                st0 = srv.stats()
                t0 = time.perf_counter()
                handles = [(lab, client.submit(tenant, d, t, **call))
                           for lab, tenant, d, t, call in requests]
                submit_s = time.perf_counter() - t0
                results = {lab: client.result(h, timeout=1200)
                           for lab, h in handles}
                wall = time.perf_counter() - t0
                st = srv.stats()
                launches = {fn.__name__: fn.launches for fn in tops.kernels()}
                packs = {}
                for lab, r in results.items():
                    packs.setdefault(r["pack_id"], []).append(lab)
                by_seeds = {frozenset(p.seed for p in e["plans"]): e
                            for e in log}
                pack_rec, errs = [], {}
                for pid, labs in sorted(packs.items()):
                    seeds = {results[lab]["seed"]: results[lab]
                             for lab in labs}
                    entry = by_seeds[frozenset(seeds)]
                    want = expected(entry, seeds, cfg)
                    expect_launches(f"serve {name} round {rnd} {pid}",
                                    entry["launches"], want)
                    pack_rec.append({"pack": pid, "requests": labs,
                                     "launches": entry["launches"],
                                     "expected": want})
                    for lab in labs:
                        res, ref = results[lab], refs[lab]
                        if entry["multi"]:
                            errs[lab] = max(
                                held_to_solo(
                                    f"{name} {lab} {t['test']}",
                                    dict(t, completed=res["completed"]),
                                    ref[t["test"]], entry["nulls"][ti],
                                    entry["plans"][0], cfg)
                                for ti, t in enumerate(res["tests"]))
                        else:
                            plan = next(p for p in entry["plans"]
                                        if p.seed == res["seed"])
                            errs[lab] = held_to_solo(
                                f"{name} {lab}", res, ref, entry["nulls"],
                                plan, cfg)
                lat = sorted(r["latency_s"] for r in results.values())
                hits = [r["pool_hit"] for r in results.values()]
                if rnd == 2 and (not all(hits) or st["pool"]["misses"]
                                 != st0["pool"]["misses"]):
                    raise RuntimeError(f"serve {name} round 2 built an "
                                       f"engine: {st['pool']}")
                rec = {
                    "phase": "serve", "server": name, "round": rnd,
                    "stat_mode": cfg.resolved_stat_mode(),
                    "requests": len(results), "wall_s": wall,
                    "submit_s": submit_s,
                    "latency_p50_s": float(np.median(lat)),
                    "latency_max_s": lat[-1],
                    "latency_first_s": min(lat), "requests_per_s":
                        len(results) / wall,
                    "packs": st["packs"] - st0["packs"], "pack_detail":
                        pack_rec,
                    "pool_hits": st["pool"]["hits"] - st0["pool"]["hits"],
                    "pool_misses": (st["pool"]["misses"]
                                    - st0["pool"]["misses"]),
                    "pool_held_gib": st["pool"]["held_gib"],
                    "pool_engines_gib_each": [
                        gib_of(storages(torch, [e]))
                        for e in list(srv.pool._lru.values())],
                    "datasets_gib": st["datasets_gib"],
                    "registrations_pinned_gib": gib_of(storages(
                        torch, [t.datasets for t in srv._tenants.values()],
                        "cpu")),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "register_s": register_s if rnd == 1 else None,
                    "launches": launches,
                    "null_max_abs_vs_solo": max(e[0] for e in
                                                errs.values()),
                    "null_bit_equal_vs_solo": all(
                        e[0] == 0.0 for e in errs.values()),
                    "observed_max_abs_vs_solo": max(e[1] for e in
                                                    errs.values()),
                    "equal_solo": True, "card": card}
                emit(rec)
                out[("serve", f"{name}_round{rnd}")] = launches
                rounds.append(rec)
        finally:
            srv.close()
            shutil.rmtree(root, ignore_errors=True)
            torch.cuda.empty_cache()
        # close() released the pool: the card holds what it held before
        torch.cuda.synchronize()
        left = (torch.cuda.memory_allocated() - before) / 2**30
        emit({"phase": "serve_release", "server": name,
              "pool_held_gib_before_close": rounds[-1]["pool_held_gib"],
              "allocated_gib_after_close_vs_before": left, "card": card})
        if left > 0.25:
            raise RuntimeError(f"serve {name}: {left:.3f} GiB still "
                               "allocated after close()")
        return rounds

    PermutationEngine.run_null_monitored = hooked(PermutationEngine)
    MultiTestEngine.run_null_monitored = hooked(MultiTestEngine)
    try:
        a_requests = [
            ("subset_lo", "acme", "disc", "test",
             dict(modules=mods[:half], n_perm=N_PERM, seed=101)),
            ("all_two_sided", "acme", "disc", "test",
             dict(n_perm=N_PERM, seed=102, alternative="two.sided")),
            ("subset_hi", "beta", "disc", "test",
             dict(modules=mods[half:], n_perm=N_PERM, seed=103)),
            ("adaptive", "acme", "disc", "test",
             dict(n_perm=ADAPTIVE_PERM, seed=104, adaptive=True)),
            ("multi_test", "acme", "disc", ["test", "test2"],
             dict(n_perm=N_PERM, seed=105)),
            ("multi_test_lo", "acme", "disc", ["test", "test2"],
             dict(modules=mods[:half], n_perm=N_PERM, seed=106)),
        ]
        refs = {}
        t0 = time.perf_counter()
        for lab, _ten, d, t, call in a_requests:
            ref = solo(d, t, fused_cfg, **call)
            refs[lab] = ref if isinstance(t, list) else ref[t]
        solo_a = time.perf_counter() - t0
        rounds_a = serve_rounds(
            "A", fused_cfg, [("acme", 2), ("beta", 1)],
            [("acme", "disc", True), ("acme", "test", False),
             ("acme", "test2", False), ("beta", "disc", True),
             ("beta", "test", False)], a_requests, refs)
        b_requests = [
            ("xpair_disc", "acme", "disc", "test2",
             dict(n_perm=N_PERM, seed=201)),
            ("xpair_test", "acme", "test", "test2",
             dict(n_perm=N_PERM, seed=202)),
            ("xla_1", "acme", "disc", "test", dict(n_perm=N_PERM, seed=203)),
            ("xla_2", "acme", "disc", "test",
             dict(modules=mods[:half], n_perm=N_PERM, seed=204)),
        ]
        t0 = time.perf_counter()
        for lab, _ten, d, t, call in b_requests:
            refs[lab] = solo(d, t, xla_cfg, **call)[t]
        solo_b = time.perf_counter() - t0
        rounds_b = serve_rounds(
            "B", xla_cfg, [("acme", 1)],
            [("acme", "disc", True), ("acme", "test", True),
             ("acme", "test2", False)], b_requests, refs,
            max_pack=2, cross_pair_packing=True)
    finally:
        for cls, fn in real.items():
            cls.run_null_monitored = fn
    emit({"phase": "serve_vs_solo", "solo_s_server_A": solo_a,
          "solo_s_server_B": solo_b,
          "served_wall_s": {f"{r['server']}{r['round']}": r["wall_s"]
                            for r in rounds_a + rounds_b},
          "card": card})
    del refs

    # ---- crash and recover on a journaled fixture ----------------------
    root = tempfile.mkdtemp(prefix="netrep_serve_drill_")
    try:
        cfg = EngineConfig(chunk_size=chunk)
        jpath = os.path.join(root, "journal.jsonl")
        drill = [("k1", dict(n_perm=SERVE_DRILL_PERM, seed=1)),
                 ("k2", dict(n_perm=SERVE_DRILL_PERM, seed=2)),
                 ("k3", dict(n_perm=SERVE_DRILL_PERM, seed=3,
                             adaptive=True))]

        def drill_server(tag, start=True, **k):
            return PreservationServer(ServeConfig(
                engine=cfg, checkpoint_every=SERVE_CKPT_EVERY,
                telemetry=os.path.join(root, f"{tag}.jsonl"), **k),
                start=start)

        t0 = time.perf_counter()
        srv = drill_server("crash", start=False, journal=jpath,
                           fault_policy=FaultPolicy(
                               plan=f"crash@{SERVE_CRASH_AT}",
                               backoff_base_s=0.0, backoff_jitter=0.0))
        fx = srv.register_fixture("acme", "fx", **SERVE_FIXTURE)
        hs = [srv.submit("acme", fx["discovery"], fx["test"],
                         idempotency_key=k, **c) for k, c in drill]
        srv.start()
        srv._worker.join(timeout=600)
        if srv._worker.is_alive() or any(h.done.is_set() for h in hs):
            raise RuntimeError("serve crash drill: the crash plan did not "
                               "stop the worker mid-pack")
        srv.tel.close()
        srv.journal.close()
        crash_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec_srv = drill_server("recover", journal=jpath, recover=True)
        try:
            got = {k: rec_srv.analyze("acme", fx["discovery"], fx["test"],
                                      idempotency_key=k, timeout=1200, **c)
                   for k, c in drill}
        finally:
            rec_srv.close()
        recover_s = time.perf_counter() - t0
        ref_srv = drill_server("reference", start=False)
        ref_srv.register_fixture("acme", "fx", **SERVE_FIXTURE)
        hs = {k: ref_srv.submit("acme", fx["discovery"], fx["test"], **c)
              for k, c in drill}
        ref_srv.start()
        try:
            want = {k: ref_srv.wait(h, timeout=1200) for k, h in hs.items()}
        finally:
            ref_srv.close()
        for k, _c in drill:
            g, w = got[k], want[k]
            if not all(np.array_equal(g[f], w[f]) for f in (
                    "observed", "p_values", "counts_hi", "counts_lo",
                    "counts_eff")) or g["completed"] != w["completed"] or (
                    w["n_perm_used"] is not None and not np.array_equal(
                        g["n_perm_used"], w["n_perm_used"])):
                raise RuntimeError(f"serve recovery: {k} differs from the "
                                   "uncrashed server")
        ev = list(read_events(os.path.join(root, "recover.jsonl")))
        resumed = [e["data"]["completed"] for e in ev
                   if e["ev"] == "checkpoint_resumed"]
        # the crash fires at the dispatch of the chunk holding its point
        crashed = SERVE_CRASH_AT // chunk * chunk
        if not resumed or not 0 <= crashed - resumed[0] <= SERVE_CKPT_EVERY:
            raise RuntimeError(f"serve recovery resumed at {resumed}")
        emit({"phase": "serve_recovery", "fixture": SERVE_FIXTURE,
              "n_perm": SERVE_DRILL_PERM, "crash_at": SERVE_CRASH_AT,
              "checkpoint_every": SERVE_CKPT_EVERY,
              "crashed_at_dispatch": crashed, "resumed_at": resumed[0],
              "recomputed_perms": crashed - resumed[0],
              "requeued": [e["data"]["requeued"] for e in ev
                           if e["ev"] == "journal_replayed"][0],
              "bit_equal_uncrashed": True, "crash_s": crash_s,
              "recover_s": recover_s, "card": card})

        # ---- the daemon over a unix socket ---------------------------
        proc, t_spawn, droot = daemon
        here = os.getcwd()
        os.chdir(droot)
        try:
            ready = json.loads(proc.stdout.readline() or "{}")
            if ready.get("serve") != "ready":
                raise RuntimeError(f"serve daemon did not start: "
                                   f"{proc.stderr.read()[-2000:]}")
            start_s = ready["boot"]["ready_t"] - t_spawn
            client = SocketClient("serve.sock", timeout=1200)
            pong = client.ping()
            dfx = client.register_fixture("acme", "fx", **SERVE_FIXTURE)
            t0 = time.perf_counter()
            wire = [client.analyze("acme", dfx["discovery"], dfx["test"],
                                   **c) for _k, c in drill[1:]]
            wire_s = time.perf_counter() - t0
            metrics = client.metrics()
            dstats = client.stats()
            bye = client.shutdown()
            client.close()
            dout, derr = proc.communicate(timeout=600)
        finally:
            os.chdir(here)
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        drained = json.loads(dout.strip().splitlines()[-1])
        if (proc.returncode != 0 or drained.get("serve") != "drained"
                or drained["requests_done"] != 2 or not pong["pong"]
                or bye != {"ok": True, "draining": True}
                or 'outcome="done"} 2' not in metrics):
            raise RuntimeError(f"serve daemon drill failed: rc "
                               f"{proc.returncode}, {drained}, "
                               f"{derr[-2000:]}")
        inproc = drill_server("inproc")
        try:
            inproc.register_fixture("acme", "fx", **SERVE_FIXTURE)
            local = [inproc.analyze("acme", dfx["discovery"], dfx["test"],
                                    timeout=1200, **c) for _k, c in drill[1:]]
        finally:
            inproc.close()
        for g, w in zip(wire, local):
            if not all(np.array_equal(g[f], w[f]) for f in (
                    "observed", "p_values", "counts_hi", "counts_lo",
                    "counts_eff")):
                raise RuntimeError("serve daemon: a wire result differs "
                                   "from the same request in process")
        emit({"phase": "serve_daemon", "fixture": SERVE_FIXTURE,
              "ready_s": start_s, "analyze_s": wire_s,
              "wire_equal_in_process": True, "drained": drained,
              "daemon_packs": dstats["packs"],
              "daemon_pool": dstats["pool"], "exit_code": proc.returncode,
              "card": card})
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


#: the fleet phase's journaled drills: a 20,000-gene fixture registered by
#: parameters (a journaled inline registration of a 20,000-gene cohort
#: would write gigabytes of JSON a matrix), the crash point (chunk 5 of
#: 8) and the checkpoint cadence (two chunks)
FLEET_FIXTURE = dict(genes=GENES, modules=MODULES, n_samples=SAMPLES,
                     seed=SEED)
FLEET_CRASH_AT, FLEET_CKPT_EVERY = 640, 256
#: the whole script cuts that fixture's scale to this many genes (the
#: ``--fleet`` and ``--startup`` modes keep GENES): its generation, once
#: in each replica and each fresh process of the ``startup``,
#: ``fleet_daemon`` and ``fleet`` drills, is most of their time, and the
#: whole run must stay well inside its time limit
WHOLE_FIXTURE_GENES = 10_000


def fleet_phase(torch, np, tops, kw, labels, card, dev,
                results_b=None) -> dict:
    """The serving fleet (``netrep_tpu_torch.serve.fleet``) on one card: two
    fleets of two in-process replicas, chunk 128, ``N_PERM``
    permutations a request.

    1. **Fleet A** (journaling off) on the three cohorts of ``kw``:
       ``grid_preservation(fleet=)`` registers them on both replicas and
       routes each of the six cells to its replica by the hash ring;
       every cell equals the in-process grid's (p-values, counts,
       ``completed``; observed within TOL), each cell's launches one per
       chunk and union bucket. Routing: each pair's replica served it, and
       a second round of the six requests is pool hits only, equal to the
       first.
    2. **Fleet B** (journaled) on a 20,000-gene fixture registered by
       parameters. A first request leaves a warm engine on the pair's
       home. **Failover**: a crash plan at FLEET_CRASH_AT kills the home's
       worker in the next pack (two requests, a checkpoint every two
       chunks); ``kill_replica`` ships its journal to the peer and gives
       back the dead replica's pool (the warm engine); the peer resumes
       the pack at the crashed boundary: each request equals its solo
       call (p-values, counts; the pack's fused null rows bit-equal), the
       peer's launches (chunks after the boundary) × union buckets, no
       permutation recomputed. **Autoscaling**: ``Autoscaler.tick`` on an
       injected clock restores the floor of two with a third replica
       (which adopts the registrations from the survivor's shipped
       journal), then holds its cooldown. **Eviction**: two more requests
       on the pair's home, the same crash, then ``evict_notice``: the
       handoff, held the same way, and no failover event. **Scale
       down**: the floor lowered to zero, past the idle period the
       autoscaler retires the last replica (scale to zero).

    Emits each drill's wall seconds, ``failover_done.s`` and the handoff's
    seconds, permutations recomputed, launches per replica, pinned GiB per
    replica, and the card's GiB after failover and after ``close()``.
    Returns launches by key; fleet B's results by seed go into ``results_b``
    (the ``fleet_daemon`` phase's references)."""
    results_b = {} if results_b is None else results_b
    import os
    import shutil
    import tempfile
    import threading

    from netrep_tpu_torch.models.grid import grid_preservation
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.parallel.engine import PermutationEngine
    from netrep_tpu_torch.serve import (
        AutoscaleConfig, Autoscaler, FleetConfig, ServeConfig,
        build_inprocess_fleet, inprocess_spawner, packer,
    )
    from netrep_tpu_torch.utils.config import EngineConfig, FaultPolicy
    from netrep_tpu_torch.utils.telemetry import read_events

    cfg = EngineConfig(chunk_size=128)
    chunk = cfg.chunk_size
    names = ("disc", "test", "test2")
    cells = [(d, t) for d in names for t in names if d != t]
    out: dict = {}
    root = tempfile.mkdtemp(prefix="netrep_fleet_")
    fleets: list = []

    # measurement hook: each pack's replica, null, plans and launches
    log: list = []
    real = PermutationEngine.run_null_monitored

    def launch_counts():
        return {fn.__name__: fn.launches for fn in tops.kernels()}

    def who():
        t = threading.current_thread()
        for f in fleets:
            for rid, rep in list(f._replicas.items()):
                if rep.server._worker is t:
                    return rid
        return t.name

    def hooked(self, n_perm, key, monitor, *a, **k):
        if not isinstance(monitor, packer.PackMonitor):
            return real(self, n_perm, key, monitor, *a, **k)
        before = launch_counts()
        entry = dict(rid=who(), plans=monitor.plans, crashed=True)
        try:
            res = real(self, n_perm, key, monitor, *a, **k)
            entry.update(crashed=False, nulls=res[0])
            return res
        finally:
            after = launch_counts()
            entry["launches"] = {n: after[n] - before[n] for n in after}
            log.append(entry)

    def per_replica(entries):
        tally: dict = {}
        for e in entries:
            row = tally.setdefault(e["rid"], {n: 0 for n in e["launches"]})
            for n, v in e["launches"].items():
                row[n] += v
        return tally

    def buckets(plans):
        return len({cfg.rounded_cap(int(s)) for p in plans for s in p.sizes})

    def allocated():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() / 2**30

    def pinned(fleet):
        return {rid: rep.stats()["datasets_gib"]
                for rid, rep in sorted(fleet.live_replicas().items())}

    def process_gib(fleet):
        """The live replicas' registrations (host) and pooled engines
        (card), each storage counted once across the process."""
        reps = list(fleet.live_replicas().values())
        return {"pinned_gib_process": gib_of(storages(torch, [
                    t.datasets for r in reps
                    for t in r.server._tenants.values()], "cpu")),
                "pool_gib_process": gib_of(storages(torch, [
                    list(r.server.pool._lru.values()) for r in reps]))}

    def same_counts(what, got, want):
        diff = {f: int(np.sum(np.asarray(got[f]) != np.asarray(want[f])))
                for f in ("p_values", "counts_hi", "counts_lo",
                          "counts_eff")}
        if any(diff.values()) or got["completed"] != want["completed"]:
            raise RuntimeError(f"fleet {what}: differs: {diff}")
        return float(np.abs(np.asarray(got["observed"])
                            - np.asarray(want["observed"])).max())

    PermutationEngine.run_null_monitored = hooked
    try:
        # ---- fleet A: the grid and routing on the three cohorts ---------
        base = allocated()

        def config_a(rid, _journal, _ckpt):
            return ServeConfig(engine=cfg, fleet_label=rid, slo_s=600.0,
                               telemetry=os.path.join(root, f"a_{rid}.jsonl"))

        fleet = build_inprocess_fleet(
            2, os.path.join(root, "a"), make_config=config_a,
            fleet_config=FleetConfig(
                heartbeat_s=3600.0,
                telemetry=os.path.join(root, "coord_a.jsonl")))
        fleets.append(fleet)
        grid_kw = dict(network=kw["network"], data=kw["data"],
                       correlation=kw["correlation"],
                       module_assignments={n: list(labels) for n in names},
                       n_perm=N_PERM, seed=SEED, config=cfg, device=dev)
        try:
            log.clear()
            tops.reset_launches()
            t0 = time.perf_counter()
            g = grid_preservation(fleet=fleet, **grid_kw)
            grid_s = time.perf_counter() - t0
            grid_log = list(log)
            pinned_a = pinned(fleet)
            t0 = time.perf_counter()
            local = grid_preservation(**grid_kw)
            local_s = time.perf_counter() - t0
            obs_err = 0.0
            for d, t in cells:
                a, b = g.cell(d, t), local.cell(d, t)
                obs_err = max(obs_err, same_counts(
                    f"grid cell {d}->{t}", vars(a), vars(b)))
            if obs_err > TOL:
                raise RuntimeError(f"fleet grid: observed {obs_err}")
            routes = {f"{d}->{t}": fleet.route("grid", d, t).rid
                      for d, t in cells}
            for e in grid_log:
                want = {"fused_stats_values":
                        -(-N_PERM // chunk) * buckets(e["plans"])}
                expect_launches("fleet grid cell", e["launches"], want)
            if len(grid_log) != len(cells):
                raise RuntimeError(f"fleet grid ran {len(grid_log)} packs")
            out[("fleet", "grid")] = {
                n: sum(e["launches"][n] for e in grid_log)
                for n in grid_log[0]["launches"]}
            served = {rid: row["done"] for rid, row in
                      fleet.stats()["replicas"].items()}
            if any(n != list(routes.values()).count(rid)
                   for rid, n in served.items()):
                raise RuntimeError(f"fleet routes {routes} vs {served}")
            # round 2: the same six requests, pool hits on the same replicas
            log.clear()
            tops.reset_launches()
            t0 = time.perf_counter()
            again = {}
            for d, t in cells:
                again[(d, t)] = fleet.analyze(
                    "grid", d, t, n_perm=N_PERM, seed=SEED, timeout=1200)
            round2_s = time.perf_counter() - t0
            for (d, t), res in again.items():
                same_counts(f"round 2 {d}->{t}", res, vars(g.cell(d, t)))
                if not res["pool_hit"]:
                    raise RuntimeError(f"fleet round 2 {d}->{t} built an "
                                       "engine")
            if [e["rid"] for e in log] != [routes[f"{d}->{t}"]
                                           for d, t in cells]:
                raise RuntimeError("fleet round 2 left its pairs' replicas")
            out[("fleet", "round2")] = launch_counts()
            stats_a = fleet.stats()
            emit({"phase": "fleet", "drill": "grid_and_routing",
                  "replicas": 2, "journal": False, "grid_wall_s": grid_s,
                  "in_process_grid_wall_s": local_s,
                  "grid_equal_in_process": True,
                  "observed_max_abs_vs_in_process": obs_err,
                  "routes": routes, "round2_wall_s": round2_s,
                  "round2_pool_hits": len(again),
                  "launches_grid_per_replica": per_replica(grid_log),
                  "launches_round2_per_replica": per_replica(log),
                  "pool_held_gib": {rid: rep.stats()["pool"]["held_gib"]
                                    for rid, rep in
                                    fleet.live_replicas().items()},
                  "pinned_gib_per_replica": pinned_a,
                  **process_gib(fleet),
                  "packs": {rid: row["packs"] for rid, row in
                            stats_a["replicas"].items()},
                  "card": card})
        finally:
            fleet.close()
        left_a = allocated() - base
        emit({"phase": "fleet_release", "fleet": "A",
              "allocated_gib_after_close_vs_before": left_a, "card": card})
        if left_a > 0.1:
            raise RuntimeError(f"fleet A: {left_a:.3f} GiB still allocated "
                               "after close()")
        del g, local, again
        torch.cuda.empty_cache()

        # ---- fleet B: autoscale, failover, eviction on a fixture --------
        base = allocated()
        fdir = os.path.join(root, "b")

        def config_b(rid, journal, ckpt):
            return ServeConfig(
                engine=cfg, journal=journal, checkpoint_dir=ckpt,
                checkpoint_every=FLEET_CKPT_EVERY, fleet_label=rid,
                max_pack=2, pack_window_s=1.0, slo_s=600.0,
                telemetry=os.path.join(root, f"b_{rid}.jsonl"))

        coord_tel = os.path.join(root, "coord_b.jsonl")
        fleet = build_inprocess_fleet(
            2, fdir, make_config=config_b, start_servers=False,
            fleet_config=FleetConfig(heartbeat_s=3600.0,
                                     telemetry=coord_tel))
        fleets.append(fleet)
        crash = FaultPolicy(plan=f"crash@{FLEET_CRASH_AT}",
                            backoff_base_s=0.0, backoff_jitter=0.0)
        crashed_at = FLEET_CRASH_AT // chunk * chunk
        try:
            t0 = time.perf_counter()
            fx = fleet.register_fixture("acme", "fx", **FLEET_FIXTURE)
            register_s = time.perf_counter() - t0
            d_name, t_name = fx["discovery"], fx["test"]
            any_rep = next(iter(fleet.live_replicas().values()))
            dsets = {n: any_rep.server._dataset("acme", n)
                     for n in (d_name, t_name)}
            solo_kw = dict(
                network={n: x.ds.network for n, x in dsets.items()},
                correlation={n: x.ds.correlation for n, x in dsets.items()},
                data={n: x.ds.data for n, x in dsets.items()},
                module_assignments=dsets[d_name].assignments,
                discovery=d_name, test=t_name, config=cfg, simplify=False,
                device=dev, n_perm=N_PERM)

            def drill_refs(seeds):
                return {s: module_preservation(seed=s, **solo_kw)[
                    d_name][t_name] for s in seeds}

            def resumed_pack(what, rid, refs, results, events_path):
                """The peer's resumed pack against the solo calls."""
                entries = [e for e in log if e["rid"] == rid
                           and not e["crashed"]]
                if len(entries) != 1:
                    raise RuntimeError(f"fleet {what}: {len(entries)} packs "
                                       f"on the peer")
                e = entries[0]
                # the checkpoint resumes since the peer's adoption
                events = list(read_events(events_path))
                last = max(i for i, x in enumerate(events)
                           if x["ev"] == "journal_replayed")
                resumed = [x["data"]["completed"] for x in events[last:]
                           if x["ev"] == "checkpoint_resumed"]
                if resumed != [crashed_at]:
                    raise RuntimeError(f"fleet {what}: resumed at {resumed},"
                                       f" crashed at {crashed_at}")
                want = {"fused_stats_values":
                        -(-(N_PERM - crashed_at) // chunk)
                        * buckets(e["plans"])}
                expect_launches(f"fleet {what} peer", e["launches"], want)
                err = obs = 0.0
                for p in e["plans"]:
                    ref, res = refs[p.seed], results[p.seed]
                    hi, lo, eff = pv.tail_counts(ref.observed, ref.nulls)
                    obs = max(obs, same_counts(
                        f"{what} seed {p.seed}", res, dict(
                            p_values=ref.p_values, counts_hi=hi,
                            counts_lo=lo, counts_eff=eff,
                            completed=ref.completed,
                            observed=ref.observed)))
                    err = max(err, nulls_err(
                        np, e["nulls"][:N_PERM, p.base:p.base + p.k],
                        ref.nulls[:N_PERM]))
                if err > 0.0 or obs > TOL:
                    raise RuntimeError(f"fleet {what}: null rows {err}, "
                                       f"observed {obs} from solo")
                return e, resumed[0], want

            pinned_b = pinned(fleet)
            # the pair's home holds a warm engine (a pack of one) before
            # the drill; the peer's worker starts once the card is read
            # after the failover
            home = fleet.route("acme", d_name, t_name)
            home.server.start()
            results_b[300] = fleet.analyze("acme", d_name, t_name,
                                           n_perm=N_PERM, seed=300,
                                           timeout=1200)
            home.arm_fault_plan(crash)
            fo_seeds = (301, 302)
            # failover: the home dies mid-pack, the peer resumes the pack
            log.clear()
            tops.reset_launches()
            t0 = time.perf_counter()
            for s in fo_seeds:
                home.server.submit("acme", d_name, t_name, n_perm=N_PERM,
                                   seed=s, idempotency_key=f"fo{s}")
            home.server._worker.join(timeout=1200)
            if home.server._worker.is_alive():
                raise RuntimeError("fleet failover: the crash plan did not "
                                   "stop the worker")
            held_dead = home.stats()["pool"]["held_gib"]
            if held_dead <= 0 and dev.type == "cuda":
                raise RuntimeError("fleet failover: the home held no warm "
                                   "engine")
            before_kill = allocated()
            fleet.kill_replica(home.rid)
            after_failover = allocated()
            peer_rid = [x["data"]["peer"] for x in read_events(coord_tel)
                        if x["ev"] == "failover_done"][0]
            fleet.live_replicas()[peer_rid].server.start()
            got = {s: fleet.analyze("acme", d_name, t_name, n_perm=N_PERM,
                                    seed=s, idempotency_key=f"fo{s}",
                                    timeout=1200) for s in fo_seeds}
            failover_wall = time.perf_counter() - t0
            results_b.update(got)
            refs = drill_refs(fo_seeds)
            entry, resumed_at, want = resumed_pack(
                "failover", peer_rid, refs, got,
                os.path.join(root, f"b_{peer_rid}.jsonl"))
            fo_done = [x["data"] for x in read_events(coord_tel)
                       if x["ev"] == "failover_done"][0]
            if fo_done["requeued"] != len(fo_seeds):
                raise RuntimeError(f"fleet failover: {fo_done}")
            out[("fleet", "failover_peer")] = entry["launches"]
            # the departed replica's diagnostic bundle, under the fleet
            # directory
            fo_bundle = check_bundle(os.path.join(
                fdir, "bundles",
                f"netrep-bundle-replica_failover-{home.rid}"), journal=True)
            emit({"phase": "fleet", "drill": "failover",
                  "fixture": FLEET_FIXTURE, "n_perm": N_PERM,
                  "crash_at": FLEET_CRASH_AT,
                  "checkpoint_every": FLEET_CKPT_EVERY,
                  "register_fixture_s_two_replicas": register_s,
                  "dead": home.rid, "peer": peer_rid,
                  "failover_done_s": fo_done["s"],
                  "requeued": fo_done["requeued"],
                  "crashed_at_dispatch": crashed_at,
                  "resumed_at": resumed_at,
                  "recomputed_perms": crashed_at - resumed_at,
                  "peer_launches": entry["launches"],
                  "peer_launches_expected": want,
                  "launches_per_replica": per_replica(log),
                  "equal_solo": True, "null_bit_equal_vs_solo": True,
                  "dead_pool_held_gib": held_dead,
                  "bundle": {k: fo_bundle[k] for k in ("ring", "libraries",
                                                       "journal_tail")},
                  "allocated_gib_before_kill": before_kill - base,
                  "allocated_gib_after_failover": after_failover - base,
                  "drill_wall_s": failover_wall, "card": card})
            if before_kill - after_failover < 0.9 * held_dead:
                raise RuntimeError("fleet failover: the dead replica's pool "
                                   "stayed on the card")
            # the autoscaler restores the floor: a third replica, which
            # adopts the registrations from the survivor's shipped journal
            clk = {"t": 0.0}
            scaler = Autoscaler(
                fleet, inprocess_spawner(fdir, make_config=config_b),
                AutoscaleConfig(min_replicas=2, max_replicas=3,
                                scale_down_idle_s=10.0, cooldown_s=2.0),
                clock=lambda: clk["t"], start=False)
            t0 = time.perf_counter()
            ticks = [scaler.tick(now=0.0)]
            spawn_s = time.perf_counter() - t0
            clk["t"] = 1.0
            ticks.append(scaler.tick(now=1.0))
            if ticks != ["up", None] or len(fleet.live_replicas()) != 2:
                raise RuntimeError(f"fleet autoscale up: {ticks}")
            spawned = [x["data"] for x in read_events(coord_tel)
                       if x["ev"] == "autoscale_up"]
            pinned_b.update(pinned(fleet))
            # eviction: the pair's new home crashes mid-pack, then leaves
            home = fleet.route("acme", d_name, t_name)
            home.arm_fault_plan(crash)
            ev_seeds = (303, 304)
            log.clear()
            tops.reset_launches()
            t0 = time.perf_counter()
            for s in ev_seeds:
                home.server.submit("acme", d_name, t_name, n_perm=N_PERM,
                                   seed=s, idempotency_key=f"ev{s}")
            home.server._worker.join(timeout=1200)
            if home.server._worker.is_alive():
                raise RuntimeError("fleet eviction: the crash plan did not "
                                   "stop the worker")
            receipt = fleet.evict_notice(home.rid, grace_s=30.0)
            got = {s: fleet.analyze("acme", d_name, t_name, n_perm=N_PERM,
                                    seed=s, idempotency_key=f"ev{s}",
                                    timeout=1200) for s in ev_seeds}
            evict_wall = time.perf_counter() - t0
            results_b.update(got)
            refs = drill_refs(ev_seeds)
            entry, resumed_at, want = resumed_pack(
                "eviction", receipt["peer"], refs, got,
                os.path.join(root, f"b_{receipt['peer']}.jsonl"))
            names_b = {x["ev"] for x in read_events(coord_tel)}
            if (receipt["requeued"] != len(ev_seeds)
                    or "evict_handoff_done" not in names_b
                    or sum(x["ev"] == "failover_done"
                           for x in read_events(coord_tel)) != 1):
                raise RuntimeError(f"fleet eviction: {receipt}")
            out[("fleet", "evict_peer")] = entry["launches"]
            emit({"phase": "fleet", "drill": "eviction",
                  "autoscale_up": {"ticks": ticks, "spawn_s": spawn_s,
                                   "spawned": spawned},
                  "pinned_gib_per_replica": pinned_b,
                  **process_gib(fleet),
                  "evicted": home.rid, "peer": receipt["peer"],
                  "handoff_s": receipt["s"],
                  "requeued": receipt["requeued"],
                  "crashed_at_dispatch": crashed_at,
                  "resumed_at": resumed_at,
                  "recomputed_perms": crashed_at - resumed_at,
                  "peer_launches": entry["launches"],
                  "peer_launches_expected": want,
                  "launches_per_replica": per_replica(log),
                  "equal_solo": True, "null_bit_equal_vs_solo": True,
                  "drill_wall_s": evict_wall, "card": card})
            # scale down: the floor lowered to zero, past the idle period
            scaler.config = dataclasses.replace(scaler.config,
                                                min_replicas=0)
            downs = []
            for now in (20.0, 21.0, 23.0):
                clk["t"] = now
                downs.append(scaler.tick(now=now))
            if downs != ["down", None, None] or fleet.live_replicas():
                raise RuntimeError(f"fleet scale down: {downs}")
            emit({"phase": "fleet", "drill": "scale_down",
                  "ticks": downs, "last_journal": bool(fleet.last_journal),
                  "states": {rid: row["state"] for rid, row in
                             fleet.stats()["replicas"].items()},
                  "card": card})
        finally:
            fleet.close()
        left_b = allocated() - base
        emit({"phase": "fleet_release", "fleet": "B",
              "allocated_gib_after_failover": after_failover - base,
              "allocated_gib_after_close_vs_before": left_b, "card": card})
        if left_b > 0.1:
            raise RuntimeError(f"fleet B: {left_b:.3f} GiB still allocated "
                               "after close()")
    finally:
        PermutationEngine.run_null_monitored = real
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def fleet_only() -> int:
    """``--fleet``: the fleet phase alone, on the three cohorts."""
    setup = mode_setup()
    if setup is None:
        return 1
    torch, np, dev, card = setup
    from netrep_tpu_torch import ops as tops

    _sizes, labels, cohorts = make_cohorts(np)
    kw = host_kw(torch, np, dev, cohorts, labels)
    fleet_phase(torch, np, tops, kw, labels, card, dev)
    print(card_line(), flush=True)
    return 0


def serve_only() -> int:
    """``--serve``: the serve phase alone, on the three cohorts."""
    setup = mode_setup()
    if setup is None:
        return 1
    torch, np, dev, card = setup
    from netrep_tpu_torch import ops as tops

    _sizes, labels, cohorts = make_cohorts(np)
    kw = host_kw(torch, np, dev, cohorts, labels)
    serve_phase(torch, np, tops, kw, labels, card, dev)
    print(card_line(), flush=True)
    return 0


#: the multi_process phase: the drill fixture's genes (the first two
#: cohorts of ``make_cohorts``), and each pair of ranks' time limit; the
#: fault drill's group timeout and rank 1's plan (a partial device loss
#: in the fourth chunk of 128)
MP_GENES, MP_TIMEOUT_S = 10_000, 300
MP_GROUP_TIMEOUT_S, MP_FAULT_PLAN = 30.0, "device_lost_partial@400"
#: the screened null's configuration there (the composed statistics)
MP_SCREEN = dict(stat_mode="xla", null_precision="bf16_rescue")


def multi_test_mesh_phase(np, pv, drive, cfg, composed_cfg, multi, ref_mem,
                          launches, chunks, card, dev, twin=None) -> dict:
    """``vmap_tests=True`` against the two cohorts on meshes of the one
    card, each held to the unsplit ``multi_test`` runs ``multi`` (``True``:
    fused materialized, its memory ``ref_mem``; ``False``: composed
    streaming), whose launches are ``launches``: fused materialized and streaming and composed
    materialized on 2×1, the psum gather (``matrix_sharding='row'``,
    ``stat_mode='auto'``, which the multi-test engine resolves to the
    composed statistics) streaming on 1×4, an adaptive run on 2×1 beside
    the same run unsplit, and a 2×1 run interrupted after STOP_AFTER
    chunks and resumed unsplit. Launch counts exact: B buckets (from the
    fixture's module sizes), T = 2 cohorts, P perm shards, R row blocks,
    two stored matrices. ``twin`` (given: :func:`discovery_twins` over
    the caller's inputs) holds the 1×4 psum run to the same call with the
    discovery dataset on the card. Returns the launches by path."""
    import os
    import shutil
    import tempfile

    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.utils.config import EngineConfig

    many = "gather_submatrix_fused_many"
    T, C = 2, cfg.chunk_size
    ref_mat, ref_stream = multi[True], multi[False]
    caps = [cfg.rounded_cap(int(s)) for s in ref_mat["test"].n_vars_present]
    B = len(set(caps))
    unsplit_fused = launches[("multi", True)]["fused_stats_values"]
    if unsplit_fused != chunks * B * T:
        raise RuntimeError(f"multi_test: {unsplit_fused} fused launches, "
                           f"expected {chunks} chunks x {B} buckets x {T}")
    perm2 = make_mesh(2, 1, devices=[dev] * 2)
    row4 = make_mesh(1, 4, devices=[dev] * 4)
    zero = {"fused_stats_values": 0, "fused_stats_counts": 0,
            "ring_shift_dma": 0}

    def same(what, got, want, nulls="bits"):
        for t in ("test", "test2"):
            a, b = got[t], want[t]
            if not np.array_equal(a.p_values, b.p_values):
                raise RuntimeError(f"multi_test_mesh {what}: {t} p-values "
                                   "differ from the unsplit run's")
            if (a.n_perm_used is not None or b.n_perm_used is not None) \
                    and not np.array_equal(a.n_perm_used, b.n_perm_used):
                raise RuntimeError(f"multi_test_mesh {what}: {t} "
                                   "n_perm_used differs")
            if nulls == "bits" and a.nulls is not None and not \
                    np.array_equal(a.nulls, b.nulls, equal_nan=True):
                raise RuntimeError(f"multi_test_mesh {what}: {t} null "
                                   "differs from the unsplit run's")

    def counts_of(res, t):
        if res[t].nulls is not None:
            return pv.tail_counts(res[t].observed, res[t].nulls)
        return res[t].counts_hi, res[t].counts_lo, res[t].counts_eff

    def same_counts(what, got, want):
        for t in ("test", "test2"):
            if not all(np.array_equal(a, b) for a, b in
                       zip(counts_of(got, t), counts_of(want, t))):
                raise RuntimeError(f"multi_test_mesh {what}: {t} counts "
                                   "differ from the unsplit run's")

    mt = dict(vmap_tests=True)
    out, used_by, report = {}, {}, {}
    runs = (
        ("perm2x1 fused materialized", perm2, cfg, True, "fused_stats_values",
         {"fused_stats_values": chunks * B * 2 * T, many: 0}),
        ("perm2x1 fused streaming", perm2, cfg, False, "fused_stats_counts",
         {"fused_stats_counts": chunks * B * 2 * T, many: 0}),
        ("perm2x1 composed materialized", perm2, composed_cfg, True, many,
         {many: chunks * 2 * T * 2, **zero}),
        # per chunk one launch per block, matrix and cohort; each cohort's
        # observed pass one per block and matrix (the host discovery's
        # blocks are gathered on the host: no launch)
        ("row1x4 psum streaming", row4, EngineConfig(matrix_sharding="row"),
         False, many, {many: 4 * 2 * (chunks * T + T), **zero}))
    for name, mesh, config, store, kernel, expect in runs:
        res, used, mem = drive("multi_test_mesh", [kernel], expect,
                               config=config, store_nulls=store, mesh=mesh,
                               **mt)
        out[name], used_by[name] = res, used
        report[name] = {"null_s": res["test"].profile["null_s"],
                        "held_gib": mem["null_held_gib"],
                        "peak_gib": mem["peak_gib"],
                        "launches": {kernel: used[kernel]}}
    same("perm2x1 fused materialized", out["perm2x1 fused materialized"],
         ref_mat)
    same_counts("perm2x1 fused materialized",
                out["perm2x1 fused materialized"], ref_mat)
    same("perm2x1 fused streaming", out["perm2x1 fused streaming"], ref_mat)
    same_counts("perm2x1 fused streaming", out["perm2x1 fused streaming"],
                ref_mat)
    comp = out["perm2x1 composed materialized"]
    same("perm2x1 composed materialized", comp, ref_stream, nulls=None)
    same_counts("perm2x1 composed materialized", comp, ref_stream)
    comp_err = max(nulls_err(np, comp[t].nulls, ref_mat[t].nulls)
                   for t in ("test", "test2"))
    if comp_err > TOL:
        raise RuntimeError(f"multi_test_mesh composed null differs from "
                           f"the unsplit fused null by {comp_err}")
    same("row1x4 psum streaming", out["row1x4 psum streaming"], ref_stream)
    if twin is not None:
        twin({"multi_test_mesh/row1x4_psum": (
            out["row1x4 psum streaming"], used_by["row1x4 psum streaming"],
            dict(config=EngineConfig(matrix_sharding="row"),
                 store_nulls=False, mesh=row4, **mt))})
    same_counts("row1x4 psum streaming", out["row1x4 psum streaming"],
                ref_stream)
    # adaptive: the 2x1 run against the same run unsplit
    ad = dict(adaptive=True, n_perm=ADAPTIVE_PERM, completed=None, **mt)
    ad_ref, used_ref, mem_ref = drive("multi_test_mesh", [
        "fused_stats_values"], config=cfg, **ad)
    ad_mesh, used_ad, mem_ad = drive("multi_test_mesh", [
        "fused_stats_values"], config=cfg, mesh=perm2, **ad)
    same("perm2x1 adaptive", ad_mesh, ad_ref)
    n_used = np.asarray(ad_mesh["test"].n_perm_used)
    want = adaptive_launches(np, n_used, caps, C) * T
    if used_ref["fused_stats_values"] != want or \
            used_ad["fused_stats_values"] != 2 * want:
        raise RuntimeError(
            f"multi_test_mesh adaptive: {used_ref['fused_stats_values']} / "
            f"{used_ad['fused_stats_values']} fused launches unsplit / "
            f"2x1, expected {want} / {2 * want}")
    used_by["perm2x1 adaptive"] = used_ad
    for name, res, mem, used in (("unsplit adaptive", ad_ref, mem_ref,
                                  used_ref),
                                 ("perm2x1 adaptive", ad_mesh, mem_ad,
                                  used_ad)):
        report[name] = {"null_s": res["test"].profile["null_s"],
                        "held_gib": mem["null_held_gib"],
                        "peak_gib": mem["peak_gib"],
                        "sum_n_perm_used": int(sum(
                            np.asarray(res[t].n_perm_used).sum()
                            for t in ("test", "test2"))),
                        "launches": {"fused_stats_values":
                                     used["fused_stats_values"]}}
    # written on 2x1, resumed unsplit
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    top = tempfile.mkdtemp(prefix="multi_test_mesh_", dir=root)
    try:
        calls = []

        def stop(done, total):
            calls.append(done)
            if len(calls) == STOP_AFTER:
                raise KeyboardInterrupt

        ck = dict(checkpoint_dir=top, checkpoint_every=C, **mt)
        part, used_w, _ = drive(
            "multi_test_mesh", ["fused_stats_values"], completed=None,
            config=cfg, mesh=perm2, progress=stop, **ck)
        res, used_r, _ = drive("multi_test_mesh", ["fused_stats_values"],
                               config=cfg, **ck)
    finally:
        shutil.rmtree(top, ignore_errors=True)
    at = int(part["test"].completed)
    if not 0 < at < N_PERM:
        raise RuntimeError(f"multi_test_mesh: the interrupted run stopped "
                           f"at {at}")
    same("checkpoint 2x1 -> unsplit", res, ref_mat)
    left = -(-(N_PERM - at) // C)
    if used_r["fused_stats_values"] != left * B * T:
        raise RuntimeError(f"multi_test_mesh resume: "
                           f"{used_r['fused_stats_values']} fused launches, "
                           f"expected {left} chunks x {B} x {T}")
    used_by["checkpoint written on 2x1"] = used_w
    used_by["checkpoint resumed unsplit"] = used_r
    ref_report = {"unsplit fused materialized": {
        "null_s": ref_mat["test"].profile["null_s"],
        "held_gib": ref_mem["null_held_gib"],
        "peak_gib": ref_mem["peak_gib"]},
        "unsplit composed streaming": {
            "null_s": ref_stream["test"].profile["null_s"]}}
    emit({"phase": "multi_test_mesh_check", "cohorts": T, "buckets": B,
          "chunks": chunks, "meshes": {"perm": perm2.shape,
                                       "row": row4.shape},
          "runs": report, "unsplit": ref_report,
          "fused_nulls_bit_equal": True, "composed_max_abs_null": comp_err,
          "tolerance": TOL, "counts_p_n_perm_used_equal": True,
          "checkpoint": {"interrupted_at": at, "resumed_to": int(
              res["test"].completed), "launches_after": used_r[
              "fused_stats_values"]},
          "card": card})
    return used_by


def mp_inputs(np, host, labels) -> dict:
    """``module_preservation``'s data arguments of the multi_process
    phase: the discovery and the test cohort, host float32."""
    (dd, dc, dn), (td, tc, tn) = host
    return dict(network={"disc": dn, "test": tn},
                data={"disc": dd, "test": td},
                correlation={"disc": dc, "test": tc},
                module_assignments=list(labels), discovery="disc",
                test="test", n_perm=N_PERM, seed=SEED, device="cuda")


MP_FILES = ("dd", "dc", "dn", "td", "tc", "tn")
#: the sparse run's inputs, handed to the ranks as .npy files
MP_SPARSE_FILES = ("sp_nbr", "sp_wgt", "sp_data", "sp_labels")


def mp_sparse_call(np, sparse_module_preservation, got: dict, mesh):
    """The multi_process phase's sparse run: Config E at full width with
    data (``SPARSE_NODES`` nodes, ``SPARSE_PERM`` permutations, chunk 128,
    ``SPARSE_ITERS`` power iterations) on ``mesh``, from the arrays
    ``got`` (``MP_SPARSE_FILES``)."""
    from netrep_tpu_torch.ops.sparse import SparseAdjacency
    from netrep_tpu_torch.utils.config import EngineConfig

    adj = SparseAdjacency.from_arrays(got["sp_nbr"], got["sp_wgt"],
                                      SPARSE_NODES)
    return sparse_module_preservation(
        adj, adj, got["sp_labels"], discovery_data=got["sp_data"],
        test_data=got["sp_data"], n_perm=SPARSE_PERM, seed=SEED,
        config=EngineConfig(chunk_size=128, power_iters=SPARSE_ITERS),
        mesh=mesh)


def mp_screened_kw(torch, np, dev) -> dict:
    """The screened runs' data arguments: the discovery and the test
    cohort at the north star's GENES, host float32, from SEED (each rank
    builds them itself)."""
    _sizes, labels, (xd, xt, _x2) = make_cohorts(np)
    kw = host_kw(torch, np, dev, (xd, xt), labels)
    kw["test"] = "test"
    return kw


class RescueSpy:
    """Counts the screened null's rescue dispatches in this process: each
    calls ``screened.take_keys`` once (the materialized rescue through the
    collective chunk, the streaming one per shard this process drives).
    ``n`` since the last :meth:`reset`; :meth:`close` unwraps."""

    def __init__(self):
        from netrep_tpu_torch.parallel import screened

        self.mod, self.orig, self.n = screened, screened.take_keys, 0
        screened.take_keys = self._take

    def _take(self, *args, **kwargs):
        self.n += 1
        return self.orig(*args, **kwargs)

    def reset(self) -> None:
        self.n = 0

    def close(self) -> None:
        self.mod.take_keys = self.orig


def mp_mixed_engine(np, kw20, dev, mesh):
    """The engine of the mixed screened runs: ``kw20``'s discovery and
    test cohorts under ``MP_SCREEN`` on ``mesh``."""
    from netrep_tpu_torch.utils.config import EngineConfig

    def side(name):
        return tuple(kw20[f][name] for f in ("data", "correlation",
                                             "network"))

    return make_engine(np, np.asarray(kw20["module_assignments"]),
                       side("disc"), side("test"), EngineConfig(**MP_SCREEN),
                       dev, mesh)


def mp_mixed_observed(np, engine, ref):
    """Observed values of the mixed screened runs: NaN (a cell that never
    tallies and is never rescued) but for the first module's first
    statistic, set one cushion above the median of that cell's float32
    null (from ``ref``, the all-rescued screened null, whose rows are the
    float32 run's): about half the permutations land inside its band and
    are rescued, the rest are decided."""
    from netrep_tpu_torch.parallel import screened as scr

    mine = [str(m.label) for m in engine.modules]
    first = min(mine, key=int)
    col = ref.nulls[:, list(map(str, ref.module_labels)).index(first), 0]
    mid = float(np.nanmedian(col))
    obs = np.full((engine.n_modules, 7), np.nan)
    obs[mine.index(first), 0] = mid + float(scr.null_cushions(
        np.array([[mid]]), engine._screen_amplitude())[0, 0])
    return obs


def mp_wait(paths, what: str) -> None:
    """Wait until every file of ``paths`` exists (another process's
    signal), at most MP_TIMEOUT_S."""
    deadline = time.time() + MP_TIMEOUT_S
    while not all(os.path.exists(p) for p in paths):
        if time.time() > deadline:
            raise RuntimeError(f"multi_process: no {what} within "
                               f"{MP_TIMEOUT_S} s")
        time.sleep(0.05)


def mp_worker(rank: int, port: int, top: str, job: str = "main") -> int:
    """One rank of the multi_process phase, in a fresh interpreter: joins
    the two-process ``gloo`` group on 127.0.0.1:``port`` and runs on a 2×1
    perm mesh across the two processes (its own perm row on ``cuda:0``).

    Job ``main``: once ``top/go`` exists, the fused null materialized and
    streaming from the 10,000-gene inputs in ``top``, the sparse run from
    its files there,
    then the screened null materialized and streaming on the 20,000-gene
    cohorts it builds from SEED, and the mixed screened runs
    (``mp_mixed_engine``, the observed values ``top/mixed_obs.npy``), the
    rescue dispatches of each screened run counted (``RescueSpy``);
    then, once ``top/fault_done`` exists, the
    drill's ``resume``: the fused materialized null under a fault policy
    resuming from the checkpoint in ``top/ckpt<rank>``. Job ``fault``
    (its group's timeout MP_GROUP_TIMEOUT_S; rank 1 is given
    MP_FAULT_PLAN): once both ranks of ``main`` saved their results, the
    same drill call, whose error is recorded, not raised. Writes each
    job's results to ``top/<job>_rank<rank>.npz`` and its timings to
    ``.json``."""
    t0 = time.time()
    import numpy as np
    import torch

    t_torch = time.time()
    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.models.sparse_api import sparse_module_preservation
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.parallel import distributed
    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.utils.config import (
        EngineConfig, FaultPolicy, resolve_device,
    )
    from netrep_tpu_torch.utils.telemetry import Telemetry

    t_imports = time.time()
    info = distributed.initialize(
        f"127.0.0.1:{port}", 2, rank, timeout_s=(
            MP_GROUP_TIMEOUT_S if job == "fault"
            else distributed.DEFAULT_TIMEOUT_S))
    t_joined = time.time()
    if job == "fault":  # the card stays the main job's until it is done
        mp_wait([os.path.join(top, f"main_rank{r}.json") for r in (0, 1)],
                "main results")
    host = [np.load(os.path.join(top, f"{k}.npy")) for k in MP_FILES]
    labels = np.load(os.path.join(top, "labels.npy"), allow_pickle=True)
    kw = mp_inputs(np, (host[:3], host[3:]), labels)
    del host
    if job == "main":  # the card stays the parent's until its references
        mp_wait([os.path.join(top, "go")], "the parent's references")
    t_go = time.time()
    dev = resolve_device(None)  # the card
    mesh = make_mesh(2, 1, devices=[dev])
    bus = Telemetry(watchdog_poll_s=0)
    events = []
    bus.subscribe(lambda r: events.append(r) if r["ev"] in (
        "allgather", "compile_span", "null_run_start") else None)
    out, timing = {}, {"rank": rank, "info": info, "t_start": t0,
                       "import_torch_s": t_torch - t0,
                       "imports_s": t_imports - t_torch,
                       "join_s": t_joined - t_imports,
                       "t_joined": t_joined, "waited_s": t_go - t_joined,
                       "ranks": mesh.ranks.tolist()}

    spy = RescueSpy()

    def measured(name, call):
        tops.reset_launches()
        events.clear()
        spy.reset()
        t1 = time.perf_counter()
        try:
            return call()
        finally:
            torch.cuda.synchronize()
            gathers = [r["data"] for r in events if r["ev"] == "allgather"]
            timing[name] = {
                "wall_s": time.perf_counter() - t1,
                "rescue_dispatches_own": spy.n,
                "launches": {fn.__name__: fn.launches
                             for fn in tops.kernels()},
                "allgathers": len(gathers),
                "allgather_s": sum(g["s"] for g in gathers),
                "allgather_bytes": sum(g["bytes"] for g in gathers),
                "start_perm": [r["data"]["start_perm"] for r in events
                               if r["ev"] == "null_run_start"],
                "source": [r["data"].get("source") for r in events
                           if r["ev"] == "compile_span"]}

    def save(name):
        np.savez(os.path.join(top, f"{name}_rank{rank}.npz"), **out)
        with open(os.path.join(top, f"{name}_rank{rank}.json"), "w") as f:
            json.dump(timing, f)
        out.clear()

    def drill(name):
        t1 = time.time()
        try:
            res = measured(name, lambda: module_preservation(
                **kw, store_nulls=True, config=EngineConfig(), mesh=mesh,
                checkpoint_dir=os.path.join(top, f"ckpt{rank}"),
                checkpoint_every=128,
                fault_policy=FaultPolicy(backoff_base_s=0.0)))
            timing[name]["null_s"] = res.profile["null_s"]
            out["nulls"], out["p"] = res.nulls, res.p_values
        # netrep: allow(exception-taxonomy) — the drill records each rank's error for the parent to check
        except Exception as e:
            timing[name].update(
                error=type(e).__name__, message=str(e)[:600],
                rung=getattr(e, "rung", None), error_s=time.time() - t1,
                t_error=time.time())
        save(name)

    with bus.activate():
        if job == "fault":
            drill("fault")
        else:
            for store in (True, False):
                mode = "materialized" if store else "streaming"
                res = measured(mode, lambda: module_preservation(
                    **kw, store_nulls=store, config=EngineConfig(),
                    mesh=mesh))
                timing[mode]["null_s"] = res.profile["null_s"]
                out[f"{mode}_p"] = res.p_values
                if store:
                    out["nulls"] = res.nulls
                else:
                    out["counts"] = np.stack([res.counts_hi, res.counts_lo,
                                              res.counts_eff])
            sp = {k: np.load(os.path.join(top, f"{k}.npy"),
                             allow_pickle=True) for k in MP_SPARSE_FILES}
            res = measured("sparse", lambda: mp_sparse_call(
                np, sparse_module_preservation, sp, mesh))
            timing["sparse"]["null_s"] = res.profile["null_s"]
            out["sparse_nulls"], out["sparse_p"] = res.nulls, res.p_values
            del sp, res
            t1 = time.perf_counter()
            kw20 = mp_screened_kw(torch, np, dev)
            timing["screened_inputs_s"] = time.perf_counter() - t1
            for store in (True, False):
                mode = f"screened_{'materialized' if store else 'streaming'}"
                res = measured(mode, lambda: module_preservation(
                    **kw20, store_nulls=store,
                    config=EngineConfig(**MP_SCREEN), mesh=mesh))
                timing[mode]["null_s"] = res.profile["null_s"]
                timing[mode]["rescue"] = res.profile["rescue"]
                out[f"{mode}_p"] = res.p_values
                out[f"{mode}_counts"] = np.stack(tallies_of(pv, res))
                if store:
                    out["screened_nulls"] = res.nulls
            eng = mp_mixed_engine(np, kw20, dev, mesh)
            obs = np.load(os.path.join(top, "mixed_obs.npy"))
            out["mixed_nulls"] = measured(
                "mixed_materialized",
                lambda: eng.run_null(N_PERM, key=SEED, observed=obs))[0]
            timing["mixed_materialized"]["rescue"] = dict(
                vars(eng.last_rescue))
            sc = measured("mixed_streaming", lambda: eng.run_null_streaming(
                N_PERM, obs, key=SEED))
            out["mixed_counts"] = np.stack([sc.hi, sc.lo, sc.eff])
            timing["mixed_streaming"]["rescue"] = dict(vars(eng.last_rescue))
            eng.release()
            del kw20, res, eng
            save("main")
            mp_wait([os.path.join(top, "fault_done")], "fault drill")
            drill("resume")
    distributed.shutdown()
    return 0


def mp_spawn(top: str, job: str, rank1_env=None) -> tuple[list, float]:
    """``mp_worker`` of ``job`` started as ranks 0 and 1 on a free port
    (``rank1_env``: more environment for rank 1): the processes and the
    spawn time."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t_spawn = time.time()
    return [subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {here()!r}); import chip_smoke; "
         f"sys.exit(chip_smoke.mp_worker({rank}, {port}, {top!r}, "
         f"{job!r}))"],
        cwd=here(), env=cli_env(**(rank1_env or {}) if rank else {}),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)], t_spawn


def mp_collect(np, top: str, procs, t_spawn: float, jobs) -> tuple:
    """Wait for a pair from :func:`mp_spawn` (MP_TIMEOUT_S from its
    spawn), kill what is left, fail unless both exited 0. Returns
    ``({job: [(npz dict, timings) of rank 0, of rank 1]}, wall seconds)``,
    each timing with ``startup_s`` (spawn to joined)."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(
                1.0, MP_TIMEOUT_S - (time.time() - t_spawn))))
    finally:
        mp_kill(procs)
    wall = time.time() - t_spawn
    for rank, (p, (_o, err)) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"multi_process {jobs[0]} rank {rank} exited "
                               f"{p.returncode}: {err[-2000:]}")
    got = {}
    for job in jobs:
        got[job] = []
        for rank in (0, 1):
            arrays = dict(np.load(os.path.join(top, f"{job}_rank{rank}.npz")))
            with open(os.path.join(top, f"{job}_rank{rank}.json")) as f:
                timing = json.load(f)
            timing["startup_s"] = timing["t_joined"] - t_spawn
            got[job].append((arrays, timing))
    return got, wall


def mp_kill(procs) -> None:
    """Kill and reap the processes of ``procs`` still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def mp_equal(np, what: str, pairs) -> None:
    """Fails unless every ``(got, want)`` array pair is equal bit for
    bit."""
    for name, got, want in pairs:
        if not np.array_equal(got, want, equal_nan=True):
            raise RuntimeError(f"multi_process {what}: {name} differs from "
                               "the single-process 2x1 run's")


def multi_process_phase(torch, np, module_preservation, card, dev,
                        kw20=None) -> dict:
    """Two processes on the card, joined over ``gloo`` on 127.0.0.1, a 2×1
    perm mesh across them (``mp_worker``), against the same calls on a
    2×1 mesh in this process, bit for bit on every rank:

    - the fused null at MP_GENES, materialized and streaming (null,
      counts, p-values; the fused kernel once per chunk and bucket of the
      rank's own shard, one allgather a chunk);
    - the sparse null of Config E at full width with data (null,
      p-values; no kernel; one allgather a chunk);
    - the screened null at GENES (``kw20``, built here when None),
      materialized and streaming (null, counts, p-values, the rescue's
      ``total`` and ``rescued``), every permutation rescued; and the
      mixed screened runs (``mp_mixed_observed``: some permutations
      decided, the others rescued), materialized and streaming (null,
      counts, the rescue's ``total``, ``rescued`` and ``dispatches``);
      in each, the gather kernel once per chunk and matrix of the rank's
      own shard plus once per matrix and rescue dispatch the rank made
      (``RescueSpy``): materialized the collective rescue's dispatches,
      as many as this process's, streaming its own shard's, the ranks'
      together this process's;
    - the fault drill (``mp_fault_check``) in two more processes, started
      with the first two so their start-up overlaps the first pair's
      work, which they wait out before they touch the card: the fused
      materialized null at MP_GENES under a policy with a checkpoint,
      rank 1 given MP_FAULT_PLAN; then the first pair, launched apart
      from the faulted one, resumes from process 0's checkpoint to the
      unbroken 2×1 null and p-values, launching the fused kernel for the
      remaining chunks only.

    Both pairs start before this process computes its references, so
    their start-up overlaps that work; the first pair touches the card
    once the references are done (``top/go``). Prints each path's null
    seconds per rank beside this process's, the allgather seconds and
    bytes, each process's start-up seconds and the phase's. Returns the
    launches by path."""
    import shutil
    import tempfile

    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.sparse_api import sparse_module_preservation
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.utils import checkpoint as ckpt
    from netrep_tpu_torch.utils.config import EngineConfig

    t_phase = time.perf_counter()
    cfg = EngineConfig()
    sizes, labels, (xd, xt, _x2) = make_cohorts(np, genes=MP_GENES)
    host = [[m.to(torch.float32).cpu().numpy() for m in mats(torch, x, dev)]
            for x in (xd, xt)]
    torch.cuda.empty_cache()
    kw = mp_inputs(np, host, labels)
    perm2 = make_mesh(2, 1, devices=[dev] * 2)

    def launched(call):
        tops.reset_launches()
        res = call()
        torch.cuda.synchronize()
        return res, {fn.__name__: fn.launches for fn in tops.kernels()}

    adj, sp_data, _corr, sp_labels, _msz = sparse_problem(
        np, SPARSE_NODES, SPARSE_K, SAMPLES, SPARSE_MODULES, SPARSE_SIZES)
    sp = dict(sp_nbr=adj.nbr, sp_wgt=adj.wgt, sp_data=sp_data,
              sp_labels=sp_labels.astype(str))
    many = "gather_submatrix_fused_many"
    root = os.path.join(here(), "build")
    os.makedirs(root, exist_ok=True)
    top = tempfile.mkdtemp(prefix="multi_process_", dir=root)
    pairs = []
    try:
        for k, a in zip(MP_FILES, host[0] + host[1]):
            np.save(os.path.join(top, f"{k}.npy"), a)
        np.save(os.path.join(top, "labels.npy"), labels)
        for k, a in sp.items():
            np.save(os.path.join(top, f"{k}.npy"), a)
        del host
        # the ranks start (imports, the group, the files) while this
        # process computes the references; they touch the card only once
        # ``top/go`` exists
        pairs = [mp_spawn(top, "main"),
                 mp_spawn(top, "fault",
                          rank1_env={"NETREP_FAULT_PLAN": MP_FAULT_PLAN})]
        ref = {store: module_preservation(**kw, store_nulls=store,
                                          config=cfg, mesh=perm2)
               for store in (True, False)}
        caps = [cfg.rounded_cap(int(s)) for s in ref[True].n_vars_present]
        B, chunks = len(set(caps)), -(-N_PERM // cfg.chunk_size)
        ref_sp, sp_used = launched(lambda: mp_sparse_call(
            np, sparse_module_preservation, sp, perm2))
        if any(sp_used.values()):
            raise RuntimeError(f"multi_process sparse launched {sp_used}")
        del sp
        if kw20 is None:
            kw20 = mp_screened_kw(torch, np, dev)
        ref_scr, scr_used = {}, {}
        for store in (True, False):
            ref_scr[store], scr_used[store] = launched(
                lambda: module_preservation(**kw20, store_nulls=store,
                                            config=EngineConfig(**MP_SCREEN),
                                            mesh=perm2))
        eng = mp_mixed_engine(np, kw20, dev, perm2)
        mixed_obs = mp_mixed_observed(np, eng, ref_scr[True])
        ref_mix, mix_used, mix_rescue, mix_s = {}, {}, {}, {}
        for store in (True, False):
            t1 = time.perf_counter()
            ref_mix[store], mix_used[store] = launched(
                lambda: eng.run_null(N_PERM, key=SEED, observed=mixed_obs)[0]
                if store else eng.run_null_streaming(N_PERM, mixed_obs,
                                                     key=SEED))
            mix_s[store] = time.perf_counter() - t1
            mix_rescue[store] = dict(vars(eng.last_rescue))
            r = mix_rescue[store]
            # the materialized total counts every row of a padded last chunk
            if not 0 < r["rescued"] < r["total"] or r["total"] < N_PERM:
                raise RuntimeError(f"multi_process mixed screened: rescued "
                                   f"{r}, not some of the permutations")
        eng.release()
        del eng
        n_mats = 1 + (kw20.get("network") is not None)
        np.save(os.path.join(top, "mixed_obs.npy"), mixed_obs)
        open(os.path.join(top, "go"), "w").close()
        faulted, wall_f = mp_collect(np, top, *pairs[1], ["fault"])
        drill = mp_fault_check(np, ckpt, top, faulted["fault"], wall_f)
        open(os.path.join(top, "fault_done"), "w").close()
        got, wall = mp_collect(np, top, *pairs[0], ["main", "resume"])
    finally:
        for procs, _t in pairs:
            mp_kill(procs)
        shutil.rmtree(top, ignore_errors=True)
    report = []
    sp_chunks = -(-SPARSE_PERM // 128)
    at = drill["checkpoint_completed"]
    for rank, ((g, timing), (g_r, t_r)) in enumerate(zip(got["main"],
                                                        got["resume"])):
        mp_equal(np, f"rank {rank}", (
            ("null", g["nulls"], ref[True].nulls),
            ("materialized p-values", g["materialized_p"],
             ref[True].p_values),
            ("streaming p-values", g["streaming_p"], ref[False].p_values),
            ("counts", g["counts"], np.stack(tallies_of(pv, ref[False]))),
            ("sparse null", g["sparse_nulls"], ref_sp.nulls),
            ("sparse p-values", g["sparse_p"], ref_sp.p_values),
            ("resumed null", g_r["nulls"], ref[True].nulls),
            ("resumed p-values", g_r["p"], ref[True].p_values)))
        for store in (True, False):
            mode = f"screened_{'materialized' if store else 'streaming'}"
            want = ref_scr[store]
            mp_equal(np, f"rank {rank} {mode}", (
                ("p-values", g[f"{mode}_p"], want.p_values),
                ("counts", g[f"{mode}_counts"],
                 np.stack(tallies_of(pv, want))),
                *((("null", g["screened_nulls"], want.nulls),)
                  if store else ()),
                ("rescue total, rescued",
                 [timing[mode]["rescue"][k] for k in ("total", "rescued")],
                 [want.profile["rescue"][k] for k in ("total",
                                                      "rescued")])))
        mp_equal(np, f"rank {rank} mixed screened", (
            ("null", g["mixed_nulls"], ref_mix[True]),
            ("counts", g["mixed_counts"], np.stack(
                [ref_mix[False].hi, ref_mix[False].lo, ref_mix[False].eff])),
            *((f"{mode} rescue", list(timing[f"mixed_{mode}"]["rescue"]
                                      .values()),
               list(mix_rescue[store].values()))
              for mode, store in (("materialized", True),
                                  ("streaming", False)))))
        for mode, kernel, n_chunks in (
                ("materialized", "fused_stats_values", chunks),
                ("streaming", "fused_stats_counts", chunks),
                ("resume", "fused_stats_values", chunks - at // 128)):
            n = (t_r if mode == "resume" else timing)[mode]["launches"][kernel]
            if n != n_chunks * B:
                raise RuntimeError(
                    f"multi_process rank {rank} {mode}: {n} launches of "
                    f"{kernel}, expected {n_chunks} chunks x {B} buckets "
                    "(its own shard)")
        if t_r["resume"]["start_perm"] != [at]:
            raise RuntimeError(f"multi_process rank {rank}: resumed at "
                               f"{t_r['resume']['start_perm']}, not {at}")
        for mode, n_chunks in (("materialized", chunks),
                               ("sparse", sp_chunks)):
            if timing[mode]["allgathers"] != n_chunks:
                raise RuntimeError(
                    f"multi_process rank {rank} {mode}: "
                    f"{timing[mode]['allgathers']} allgathers, "
                    f"expected {n_chunks}")
        if any(timing["sparse"]["launches"].values()):
            raise RuntimeError(f"multi_process rank {rank} sparse "
                               f"launched {timing['sparse']['launches']}")
        for mode, disp in (
                ("screened_materialized",
                 ref_scr[True].profile["rescue"]["dispatches"]),
                ("screened_streaming", None),
                ("mixed_materialized", mix_rescue[True]["dispatches"]),
                ("mixed_streaming", None)):
            n, own = (timing[mode]["launches"][many],
                      timing[mode]["rescue_dispatches_own"])
            if n != (chunks + own) * n_mats or disp not in (None, own):
                raise RuntimeError(
                    f"multi_process rank {rank} {mode}: {n} gather "
                    f"launches, expected ({chunks} chunks + {own} rescue "
                    f"dispatches of its own) x {n_mats} matrices; this "
                    f"process's collective rescue made {disp}")
        timing["resume"] = t_r["resume"]
        report.append(timing)
    for mode, used, disp in (
            ("screened_streaming", scr_used[False][many],
             ref_scr[False].profile["rescue"]["dispatches"]),
            ("mixed_streaming", mix_used[False][many],
             mix_rescue[False]["dispatches"])):
        both = sum(t[mode]["launches"][many] for t in report)
        own = [t[mode]["rescue_dispatches_own"] for t in report]
        if both != used or sum(own) != disp:
            raise RuntimeError(
                f"multi_process {mode}: the ranks launched the gather "
                f"{both} times and rescued {own}, this process {used} "
                f"and {disp} (one per shard and chunk with a rescue)")
    drill.update(resume_null_s=[t["resume"]["null_s"] for t in report],
                 resumed_equal_unbroken=True)

    def per_rank(key):
        return [{k: t[key][k] for k in (
            *(("null_s",) if "null_s" in t[key] else ()), "wall_s",
            "launches", "allgathers", "allgather_s", "allgather_bytes",
            *(("rescue", "rescue_dispatches_own") if "rescue" in t[key]
              else ()))}
            for t in report]

    single = {"materialized": ref[True], "streaming": ref[False],
              "sparse": ref_sp, "screened_materialized": ref_scr[True],
              "screened_streaming": ref_scr[False]}
    emit({"phase": "multi_process", "processes": 2, "backend": "gloo",
          "genes": MP_GENES, "screened_genes": GENES,
          "sparse_nodes": SPARSE_NODES, "mesh": perm2.shape, "buckets": B,
          "chunks": chunks, "equal_single_process": True,
          "single_process_null_s": {k: r.profile["null_s"]
                                    for k, r in single.items()},
          "single_process_launches": {
              "sparse": sp_used, "screened_materialized": scr_used[True],
              "screened_streaming": scr_used[False]},
          "single_process_rescue": {
              k: ref_scr[s].profile["rescue"] for k, s in (
                  ("materialized", True), ("streaming", False))},
          "mixed_observed": "NaN but one cell, one cushion above its "
                            "float32 null's median",
          "single_process_mixed": {
              k: {"wall_s": mix_s[s], "rescue": mix_rescue[s],
                  "launches": mix_used[s]}
              for k, s in (("materialized", True), ("streaming", False))},
          "ranks": [{k: t[k] for k in (
              "rank", "startup_s", "import_torch_s", "imports_s", "join_s",
              "materialized", "streaming", "screened_inputs_s", "ranks")}
              for t in report],
          "per_rank": {k: per_rank(k) for k in (
              "sparse", "screened_materialized", "screened_streaming",
              "mixed_materialized", "mixed_streaming", "resume")},
          "fault_drill": drill, "wall_s": wall,
          "phase_s": time.perf_counter() - t_phase, "card": card})
    used = {("multi_process", f"rank{t['rank']}", mode): t[mode]["launches"]
            for t in report for mode in (
                "materialized", "streaming", "sparse",
                "screened_materialized", "screened_streaming",
                "mixed_materialized", "mixed_streaming", "resume")}
    used.update({("multi_process", f"rank{r}", "fault"): launches
                 for r, launches in enumerate(drill.pop("launches"))})
    return used


def mp_fault_check(np, ckpt, top: str, ranks, wall: float) -> dict:
    """The fault pair's outcome (see ``multi_process_phase``): rank 1
    must raise ``CrossProcessRungError`` (the shrink rung), rank 0
    ``PeerLostError``, each within the group's timeout of the other and
    of its call's start, and process 0's checkpoint, alone, must hold the
    chunks before the fault. Returns the report, with each rank's
    launches under ``launches``."""
    (_g0, t0), (_g1, t1) = ranks
    f0, f1 = t0["fault"], t1["fault"]
    if f1.get("error") != "CrossProcessRungError" or f1.get("rung") != \
            "shrink" or f0.get("error") != "PeerLostError":
        raise RuntimeError(f"multi_process fault drill: rank 0 {f0}, "
                           f"rank 1 {f1}")
    gap = abs(f0["t_error"] - f1["t_error"])
    if gap > MP_GROUP_TIMEOUT_S or max(f0["error_s"], f1["error_s"]) > \
            MP_GROUP_TIMEOUT_S:
        raise RuntimeError(f"multi_process fault drill: errors {gap} s "
                           "apart, or a rank waited past the group's "
                           "timeout")
    at = int(MP_FAULT_PLAN.rsplit("@", 1)[1]) // 128 * 128
    name, other = (os.listdir(d) if os.path.isdir(d) else [] for d in (
        os.path.join(top, "ckpt0"), os.path.join(top, "ckpt1")))
    if len(name) != 1 or other:
        raise RuntimeError(f"multi_process fault drill: checkpoint files "
                           f"{name}, {other}")
    saved = int(ckpt.load_null_checkpoint(os.path.join(
        top, "ckpt0", name[0]))["completed"])
    if saved != at:
        raise RuntimeError(f"multi_process fault drill: process 0's "
                           f"checkpoint holds {saved}, expected {at}")
    return {"plan_rank1": MP_FAULT_PLAN,
            "group_timeout_s": MP_GROUP_TIMEOUT_S,
            "errors": [{k: f.get(k) for k in ("error", "rung", "error_s",
                                              "message")} for f in (f0, f1)],
            "errors_apart_s": gap, "checkpoint_completed": saved,
            "fault_startup_s": [t0["startup_s"], t1["startup_s"]],
            "fault_waited_s": [t0["waited_s"], t1["waited_s"]],
            "fault_wall_s": wall,
            "launches": [t0["fault"]["launches"], t1["fault"]["launches"]]}


def multi_test_mesh_only() -> int:
    """``--multi-test-mesh``: the unsplit ``multi_test`` runs (fused
    materialized, composed streaming) on the three cohorts, then
    ``multi_test_mesh``."""
    ready = mode_setup()
    if ready is None:
        return 1
    torch, np, dev, card = ready
    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.utils.config import EngineConfig

    _sizes, labels, cohorts = make_cohorts(np)
    kw = host_kw(torch, np, dev, cohorts, labels)
    drive = make_drive(torch, np, tops, module_preservation, kw, card)
    cfg = EngineConfig()
    composed_cfg = EngineConfig(stat_mode="xla", gather_mode="fused")
    chunks = -(-N_PERM // cfg.chunk_size)
    many = "gather_submatrix_fused_many"
    multi, launches = {}, {}
    multi[True], launches[("multi", True)], mem = drive(
        "multi_test", ["fused_stats_values"], config=cfg, vmap_tests=True)
    multi[False], launches[("multi", False)], _ = drive(
        "multi_test", [many], {many: chunks * 2 * 2}, config=composed_cfg,
        vmap_tests=True, store_nulls=False)
    multi_test_mesh_phase(np, pv, drive, cfg, composed_cfg, multi, mem,
                          launches, chunks, card, dev)
    print(card_line(), flush=True)
    return 0


def multi_process_only() -> int:
    """``--multi-process``: ``multi_process`` alone."""
    ready = mode_setup()
    if ready is None:
        return 1
    torch, np, dev, card = ready
    from netrep_tpu_torch.models.preservation import module_preservation

    multi_process_phase(torch, np, module_preservation, card, dev)
    print(card_line(), flush=True)
    return 0


def make_drive(torch, np, tops, module_preservation, kw, card):
    """``drive(phase, needs, expect=None, completed=N_PERM, **call)``:
    one ``module_preservation`` call on ``kw`` (read at call time) with
    ``call``'s arguments over them; see its docstring."""

    def drive(phase, needs, expect=None, completed=N_PERM, **call):
        """One ``module_preservation`` call with every launch count at 0
        just before it; fails unless each kernel in ``needs`` launched,
        each count in ``expect`` (name: launches) is met exactly and the
        result completed ``completed`` permutations (None: not checked,
        as for an adaptive run). A ``progress`` in ``call`` is called
        after the memory reads. Returns ``(result, launches, memory)``:
        the peak device GiB of the call, the most held at a progress call
        of its null, and the null's own peak (from its first progress call
        on)."""
        expect = expect or {}
        n_perm = call.get("n_perm", N_PERM)
        user_progress = call.pop("progress", None)
        tops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held, before_null = [], []

        def progress(done, total):
            # the peak up to the first progress call is the input phase's;
            # from there to the end, the null's (its first chunk excepted)
            if not before_null:
                before_null.append(torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
            held.append(torch.cuda.memory_allocated())
            if user_progress is not None:
                user_progress(done, total)

        t0 = time.perf_counter()
        res = module_preservation(**{**kw, **call}, progress=progress)
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in tops.kernels()}
        for name in needs:
            if launches[name] == 0:
                raise RuntimeError(f"{phase} launched no {name} kernel")
        for name, n in expect.items():
            if launches[name] != n:
                raise RuntimeError(f"{phase}: {launches[name]} launches of "
                                   f"{name}, expected {n}")
        for r in (res.values() if isinstance(res, dict) else [res]):
            if r.observed.shape != (MODULES, 7) or not np.isfinite(
                    r.observed).all():
                raise RuntimeError("observed statistics are not finite "
                                   f"(MODULES, 7): {r.observed.shape}")
            if not ((r.p_values > 0) & (r.p_values <= 1)).all():
                raise RuntimeError("p-values outside (0, 1]")
            if completed is not None and r.completed != completed:
                raise RuntimeError(f"completed {r.completed} of {completed}")
            if r.nulls is not None and r.nulls.shape != (n_perm, MODULES, 7):
                raise RuntimeError(f"null shape {r.nulls.shape}")
        prof = (next(iter(res.values())) if isinstance(res, dict)
                else res).profile
        store = call.get("store_nulls", True)
        null_peak = torch.cuda.max_memory_allocated()
        memory = {"peak_gib": max(before_null + [null_peak]) / 2**30,
                  "null_held_gib": max(held) / 2**30,
                  "null_peak_gib": null_peak / 2**30}
        emit({"phase": phase, "store_nulls": store,
              "stat_mode": call["config"].stat_mode,
              "dtype": call["config"].dtype,
              "null_precision": call["config"].null_precision,
              "rescue": prof.get("rescue"), "n_perm": n_perm,
              "adaptive": call.get("adaptive", False),
              "completed": int(res.completed) if not isinstance(res, dict)
              else None,
              "mesh": None if call.get("mesh") is None
              else call["mesh"].shape,
              "wall_s": wall, "input_s": prof["input_s"],
              "engine_s": prof["engine_s"], "observed_s": prof["observed_s"],
              "null_s": prof["null_s"], "perms_per_s": prof["perms_per_s"],
              "launches": launches, "expected_launches": expect, **memory,
              "card": card})
        return res, launches, memory

    return drive


def check_tallies(np, pv, a, b):
    """Fails unless the streaming result ``b``'s tallies are the tail
    counts of the materialized result ``a``'s null."""
    hi, lo, eff = pv.tail_counts(a.observed, a.nulls)
    if not (np.array_equal(hi, b.counts_hi)
            and np.array_equal(lo, b.counts_lo)
            and np.array_equal(eff, b.counts_eff)):
        raise RuntimeError("streaming tallies differ from the tail "
                           "counts of the materialized null")


def nulls_err(np, a, b):
    """Largest |a - b| of two nulls whose NaN patterns must agree."""
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        raise RuntimeError("NaN pattern of two nulls differs")
    return float(np.nanmax(np.abs(a - b)))


def kernel_ms(torch, fs, fg, engine, chunk, obs, cfg, timed) -> dict:
    """The five kernel entries' times on the engine's own storage at the
    main path's shapes (one chunk; gather: one matrix; ring: one launch on
    a GENES / 4-row block), by name."""
    tc, tn, td = engine._test_corr, engine._test_net, engine._test_dataT
    dev = tc.device
    pvalid = torch.ones(cfg.chunk_size, dtype=torch.int32, device=dev)
    idx_list = [idx for _, idx in chunk]
    rows_per = GENES // 4
    bufs = [torch.empty(i.shape + i.shape[-1:], device=dev, dtype=tc.dtype)
            for i in idx_list]
    ring = [tc[r0: r0 + rows_per] for r0 in range(0, GENES, rows_per)]
    return {
        "fused_stats_values": timed(lambda: [
            fs.fused_stats_values(tc, tn, td, b.disc, idx,
                                  n_iter=cfg.power_iters)
            for b, idx in chunk]),
        "fused_stats_counts": timed(lambda: [
            fs.fused_stats_counts(tc, tn, td, b.disc, idx, pvalid, ob,
                                  n_iter=cfg.power_iters)
            for (b, idx), ob in zip(chunk, obs)]),
        "gather_submatrix_fused_many": timed(
            lambda: fg.gather_submatrix_fused_many(tc, idx_list)),
        "gather_submatrix_fused_many(out=)": timed(lambda: [
            fg.gather_submatrix_fused_many(blk, idx_list, r, out=bufs)
            for r, blk in zip(range(0, GENES, rows_per), ring)]),
        "ring_shift_dma": timed(lambda: fs.ring_shift_dma(ring)) / len(ring),
    }


def mode_setup():
    """Shared start of ``--bf16`` and ``--screened``: ``(torch, np, dev,
    card)`` with every kernel built (all nvcc runs at once), or None
    without a card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return None
    import numpy as np

    from netrep_tpu_torch.ops import _build

    card = card_line()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "card": card, "torch": torch.__version__})
    t0 = time.perf_counter()
    _build.build(list(_build.SOURCES))
    emit({"phase": "build", "total_s": time.perf_counter() - t0})
    return torch, np, torch.device("cuda"), card


def host_kw(torch, np, dev, cohorts, labels):
    """``module_preservation``'s data arguments for the discovery and the
    test cohorts (``disc``, ``test``, ``test2``, as many as ``cohorts``
    holds) as host float32 arrays, ``test=["test", "test2"]``
    (single-test calls name ``test="test"``)."""
    names = ("disc", "test", "test2")
    host = [[m.to(torch.float32).cpu().numpy() for m in mats(torch, x, dev)]
            for x in cohorts]
    torch.cuda.empty_cache()
    return dict(network={k: h[2] for k, h in zip(names, host)},
                data={k: h[0] for k, h in zip(names, host)},
                correlation={k: h[1] for k, h in zip(names, host)},
                module_assignments=list(labels), discovery="disc",
                test=["test", "test2"], n_perm=N_PERM, seed=SEED,
                device="cuda")


def bf16_only() -> int:
    """``--bf16``: the three kernels' bfloat16 instantiations against their
    plain versions, timed beside their float32 instantiations; then every
    storage path of the main call run in float32 and in bfloat16
    (``bf16_phase``); then ``genome_scale`` in both types."""
    setup = mode_setup()
    if setup is None:
        return 1
    torch, np, dev, card = setup
    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.ops import fused_gather as fg
    from netrep_tpu_torch.ops import fused_stats as fs
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.utils.config import EngineConfig

    cfg = EngineConfig()
    _sizes, labels, cohorts = make_cohorts(np)
    engine, chunk, obs = first_chunk(torch, np, labels,
                                     mats(torch, cohorts[0], dev),
                                     mats(torch, cohorts[1], dev), cfg, dev)
    timed = make_timer(torch)
    f32_ms = kernel_ms(torch, fs, fg, engine, chunk, obs, cfg, timed)
    bf16_kernels(torch, np, fs, fg, pv, engine, chunk, obs, cfg, timed,
                 f32_ms, card, dev)
    del engine, chunk, obs
    torch.cuda.empty_cache()
    kw = host_kw(torch, np, dev, cohorts, labels)
    drive = make_drive(torch, np, tops, module_preservation, kw, card)
    row_mesh = make_mesh(1, 4, devices=[dev] * 4)
    perm_mesh = make_mesh(2, 1, devices=[dev] * 2)
    chunks = -(-N_PERM // cfg.chunk_size)
    one_test = {k: {n: v for n, v in kw[k].items() if n != "test2"}
                for k in ("network", "data", "correlation")}
    f32_ref = {}
    for label, (needs, expect, call) in storage_paths(
            cfg, "float32", row_mesh, perm_mesh, chunks).items():
        if call.get("test") == "test":
            call = {**one_test, **call}
        res, _used, mem = drive("f32_storage", needs, expect, **call)
        f32_ref[label] = (res, mem)
    bf16_phase(np, pv, drive, storage_paths(cfg, "bfloat16", row_mesh,
                                            perm_mesh, chunks), f32_ref, card,
               one_test)
    del f32_ref, kw
    torch.cuda.empty_cache()
    genome_scale(torch, np, card)
    print(card_line(), flush=True)
    return 0


def screened_only() -> int:
    """``--screened``: the float32 composed null (materialized, streaming,
    adaptive at ADAPTIVE_PERM) and the fused main path, then
    ``screened_phase`` against them (the GPD tail fit on the fused null
    included), then ``data_only_phase`` with its screened run."""
    setup = mode_setup()
    if setup is None:
        return 1
    torch, np, dev, card = setup
    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.utils.config import EngineConfig

    _sizes, labels, cohorts = make_cohorts(np)
    # the discovery and one test cohort
    kw = dict(host_kw(torch, np, dev, cohorts[:2], labels), test="test")
    drive = make_drive(torch, np, tops, module_preservation, kw, card)
    composed_cfg = EngineConfig(stat_mode="xla", gather_mode="fused")
    chunks = -(-N_PERM // composed_cfg.chunk_size)
    comp = {store: drive("composed_path", [MANY], {MANY: chunks * 2,
                                                   **SINGLE},
                         config=composed_cfg, store_nulls=store)[0]
            for store in (True, False)}
    adaptive = drive("adaptive", [MANY], config=composed_cfg, adaptive=True,
                     n_perm=ADAPTIVE_PERM, completed=None)[0]
    fused = drive("main_path", ["fused_stats_values"],
                  config=EngineConfig())[0]
    screened_phase(np, pv, drive, comp, adaptive, fused,
                   make_mesh(2, 1, devices=[dev] * 2), MANY, card)
    del kw, comp, adaptive, fused
    torch.cuda.empty_cache()
    data_only_phase(torch, np, card)
    print(card_line(), flush=True)
    return 0


#: the 2×1 screened streaming null's timed runs (after one warm-up run)
SCREENED_MESH_RUNS = 4


def screened_mesh_only() -> int:
    """``--screened-mesh``: the screened streaming null of
    ``screened_phase`` on the 2×1 perm mesh of one process (the composed
    statistics, every permutation rescued), a warm-up run and
    SCREENED_MESH_RUNS timed ones: each run's null seconds and rescue
    counters, their mean and median. The same script run from two
    checkouts, alternately in one call, compares their per-shard rescue
    on one card."""
    setup = mode_setup()
    if setup is None:
        return 1
    torch, np, dev, card = setup
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.utils.config import EngineConfig

    _sizes, labels, cohorts = make_cohorts(np)
    kw = dict(host_kw(torch, np, dev, cohorts[:2], labels), test="test")
    mesh = make_mesh(2, 1, devices=[dev] * 2)
    runs = []
    for _ in range(SCREENED_MESH_RUNS + 1):
        res = module_preservation(**kw, store_nulls=False, mesh=mesh,
                                  config=EngineConfig(**MP_SCREEN))
        runs.append({"null_s": res.profile["null_s"],
                     "rescue": res.profile["rescue"]})
    null_s = [r["null_s"] for r in runs[1:]]
    emit({"phase": "screened_mesh", "genes": GENES, "n_perm": N_PERM,
          "mesh": mesh.shape, "warmup": runs[0], "runs": runs[1:],
          "mean_null_s": sum(null_s) / len(null_s),
          "median_null_s": float(np.median(null_s)), "card": card})
    print(card_line(), flush=True)
    return 0


#: the roofline phase: permutations of each run — 32 chunks of 128, so the
#: streaming run's superchunks of 8 chunks give four marks, three steady
#: intervals
ROOF_PERM = 4096
#: the bundle a ``dump`` or a departure writes: the JAX package's files
#: less its AOT section, plus the kernel libraries
BUNDLE_FILES = {"flight_ring.jsonl", "manifest.json", "env.json",
                "autotune.json",
                "kernels.json", "perf_ledger_tail.jsonl",
                "journal_tail.jsonl", "stacks.txt", "roofline.json"}


def build_dir() -> str:
    """``build/`` beside this script: the ignored directory a phase's
    files go to (removed when the phase ends)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def fresh_autotune_store() -> None:
    """Point the autotune store (``NETREP_AUTOTUNE_STORE``; this process
    and every process it starts) at a fresh directory under
    :func:`build_dir`, removed at exit: every run of the script starts
    from an empty store, whatever an earlier run left in the checkout."""
    import atexit
    import shutil
    import tempfile

    import torch

    if not torch.cuda.is_available():
        return
    os.makedirs(build_dir(), exist_ok=True)
    top = tempfile.mkdtemp(prefix="autotune_store_", dir=build_dir())
    os.environ["NETREP_AUTOTUNE_STORE"] = top
    atexit.register(shutil.rmtree, top, True)


def roofline_phase(np, drive, cfg, composed_cfg, card) -> dict:
    """``roofline``: the main path with ``telemetry=`` on, fused
    (materialized and streaming), composed and fused in bfloat16 storage,
    ``ROOF_PERM`` permutations each, with ``NETREP_PERF_LEDGER`` naming a
    ledger. Per run: the ``roofline`` event's per-permutation bytes and
    operations, speed of light, achieved rate (the steady rate of chunks 1
    to last) and utilisation. Fails unless 0 < utilisation <= 1 in every
    run, the fused and composed runs cost equal bytes and operations, every
    family's span sums equal its ``null_run_end`` totals, and the ledger
    holds an entry with a ``roofline`` block for each run."""
    import shutil
    import tempfile

    from netrep_tpu_torch.utils import costmodel, perfledger
    from netrep_tpu_torch.utils import telemetry as tm

    os.makedirs(build_dir(), exist_ok=True)
    top = tempfile.mkdtemp(prefix="roofline_", dir=build_dir())
    ledger = os.path.join(top, "ledger.jsonl")
    before = os.environ.get(perfledger.LEDGER_ENV)
    os.environ[perfledger.LEDGER_ENV] = ledger
    runs, used_all = {}, {}
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    try:
        for name, config, store, kernel in (
                ("fused/materialized", cfg, True, "fused_stats_values"),
                ("fused/streaming", cfg, False, "fused_stats_counts"),
                ("composed/materialized", composed_cfg, True,
                 "gather_submatrix_fused_many"),
                ("fused_bf16/materialized", bf16, True,
                 "fused_stats_values")):
            path = os.path.join(top, name.replace("/", "_") + ".jsonl")
            t0 = time.perf_counter()
            res, used, _mem = drive("roofline", [kernel], n_perm=ROOF_PERM,
                                    completed=ROOF_PERM, config=config,
                                    store_nulls=store, telemetry=path)
            wall = time.perf_counter() - t0
            events = list(tm.read_events(path))
            folded = costmodel.fold_roofline_events(events)
            roof = [e["data"] for e in events if e["ev"] == "roofline"]
            if len(roof) != 1:
                raise RuntimeError(f"roofline {name}: {len(roof)} roofline "
                                   "events")
            r = roof[0]
            util = r["utilisation"]
            if not (isinstance(util, float) and 0 < util <= 1):
                raise RuntimeError(f"roofline {name}: utilisation {util!r} "
                                   "outside (0, 1]")
            fam = folded["families"]
            tot = folded["run_totals"]
            if set(fam) != set(tot) or any(
                    (fam[f]["flops"], fam[f]["bytes_hbm"])
                    != (tot[f]["flops"], tot[f]["bytes_hbm"]) for f in tot):
                raise RuntimeError(f"roofline {name}: span sums differ from "
                                   f"the null_run_end totals: {fam} {tot}")
            t_b = r["bytes_per_perm"] / r["peak_bw"]
            t_o = r["flops_per_perm"] / r["peak_flops"]
            runs[name] = {
                "family": r["family"], "device_kind": r["device_kind"],
                "bytes_per_perm": r["bytes_per_perm"],
                "flops_per_perm": r["flops_per_perm"],
                "sol_pps": r["sol_pps"], "achieved_pps": r["achieved_pps"],
                "utilisation": util,
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "null_s": res.profile.get("null_s"), "wall_s": wall,
                "span_sums_equal_run_totals": True,
                "render": costmodel.render_roofline(folded).splitlines()}
            used_all[name] = used
        f, c = runs["fused/materialized"], runs["composed/materialized"]
        if (f["bytes_per_perm"], f["flops_per_perm"]) != (
                c["bytes_per_perm"], c["flops_per_perm"]):
            raise RuntimeError(f"roofline: fused and composed costs differ: "
                               f"{f} {c}")
        entries = [e for e in perfledger.read_entries(ledger)
                   if isinstance(e.get("roofline"), dict)]
        if len(entries) != len(runs):
            raise RuntimeError(f"roofline: {len(entries)} ledger entries "
                               f"with a roofline block, {len(runs)} runs")
        ok, verdict = perfledger.check_roofline(ledger)
        note = costmodel.last_run_note()
    finally:
        if before is None:
            os.environ.pop(perfledger.LEDGER_ENV, None)
        else:
            os.environ[perfledger.LEDGER_ENV] = before
        shutil.rmtree(top, ignore_errors=True)
    emit({"phase": "roofline", "n_perm": ROOF_PERM, "runs": runs,
          "fused_equals_composed_cost": True,
          "peaks": costmodel.device_peaks(runs["fused/materialized"][
              "device_kind"]),
          "ledger_entries": len(entries),
          "ledger_fingerprints": sorted({e["fingerprint"] for e in entries}),
          "check_roofline": {"ok": ok, "verdict": verdict.splitlines()},
          "note_family": (note or {}).get("family"), "card": card})
    return {("roofline", k): v for k, v in used_all.items()}


def flightrec_ab_phase(np, drive, cfg, composed_cfg, card) -> None:
    """``flightrec_ab``: the flight recorder's cost on the main path. The
    fused streaming and the composed materialized null (one run of each
    kernel and mode), ``N_PERM`` permutations with ``telemetry=`` off,
    each run with the recorder on, off, off, on
    (``flightrec.install``/``uninstall``): every null's
    seconds, the means per arm and their ratio, and the host cost of one
    event through the flight bus times each run's events. Fails unless
    the ring took entries in the recorder-on runs and every run's
    p-values and null (or tallies) equal the first run's bit for bit."""
    from netrep_tpu_torch.utils import flightrec

    def outputs(res, store):
        return [res.p_values] + ([res.nulls] if store else [
            res.counts_hi, res.counts_lo, res.counts_eff])

    runs = {}
    try:
        for name, config, store, kernel in (
                ("fused/streaming", cfg, False, "fused_stats_counts"),
                ("composed/materialized", composed_cfg, True,
                 "gather_submatrix_fused_many")):
            null_s, ring, first = {"on": [], "off": []}, [], None
            for arm in ("on", "off", "off", "on"):
                if arm == "on":
                    if flightrec.install() is None:
                        raise RuntimeError("flightrec_ab: NETREP_FLIGHTREC "
                                           "turned the recorder off")
                    flightrec.recorder().clear()
                else:
                    flightrec.uninstall()
                res, _used, _mem = drive("flightrec_ab", [kernel],
                                         config=config, store_nulls=store)
                null_s[arm].append(res.profile["null_s"])
                if arm == "on":
                    ring.append(flightrec.recorder().stats()["entries"])
                got = outputs(res, store)
                if first is None:
                    first = got
                elif not all(np.array_equal(a, b, equal_nan=True)
                             for a, b in zip(first, got)):
                    raise RuntimeError(f"flightrec_ab {name}: results with "
                                       "the recorder on and off differ")
            if min(ring) <= 0:
                raise RuntimeError(f"flightrec_ab {name}: the ring took no "
                                   "entries with the recorder on")
            on, off = (sum(null_s[a]) / 2 for a in ("on", "off"))
            runs[name] = {"null_s": null_s, "mean_on_s": on,
                          "mean_off_s": off, "on_over_off": on / off,
                          "ring_entries": ring}
    finally:
        flightrec.install()
    # the recorder's own cost: one event of a chunk's fields through the
    # flight bus (record, ring, detector scan), on this host
    bus, n = flightrec.bus(), 2000
    sid = bus.new_span_id()
    t0 = time.perf_counter()
    for i in range(n):
        bus.emit("flightrec_probe", done=i, total=n, take=128, s=0.01,
                 dispatches=2, host_bytes=179200, transfer_s=0.001,
                 span=sid, parent=None)
    emit_us = 1e6 * (time.perf_counter() - t0) / n
    flightrec.recorder().clear()
    emit({"phase": "flightrec_ab", "n_perm": N_PERM,
          "order": "on, off, off, on (telemetry off)", "runs": runs,
          "results_bit_equal": True, "emit_us": emit_us,
          "recorder_s_per_null": {k: emit_us * 1e-6 * v["ring_entries"][0]
                                  for k, v in runs.items()},
          "card": card})


def selftest_phase(card) -> dict:
    """``selftest``: ``selftest(device="cuda")`` on both shapes — the
    observed pass (composed statistics, gather kernel) and one permutation
    rebuilt from the draw contract against the float64 oracle, streaming
    tallies against materialized counts bit for bit, the fused-statistics
    kernel against the composed path; raises on a deviation >= 1e-4."""
    from netrep_tpu_torch.utils.selftest import selftest

    out = selftest(device="cuda", verbose=False)
    if not (out["observed_max_abs_dev"] < TOL
            and out["null_reconstruction_max_abs_dev"] < TOL
            and out["shape_nodes"] == [96, 192]):
        raise RuntimeError(f"selftest: {out}")
    emit({"phase": "selftest", **out, "card": card})
    return out


def check_bundle(path, journal=False) -> dict:
    """A diagnostic bundle's files (:data:`BUNDLE_FILES`), a non-empty
    flight ring and the three kernel libraries named; with ``journal`` a
    non-empty, redacted journal tail. Returns what it read."""
    have = set(os.listdir(path))
    if have != BUNDLE_FILES:
        raise RuntimeError(f"bundle {path}: files {sorted(have)}")
    with open(os.path.join(path, "manifest.json")) as f:
        ring = json.load(f)["ring"]
    with open(os.path.join(path, "kernels.json")) as f:
        libs = json.load(f)["libraries"]
    with open(os.path.join(path, "env.json")) as f:
        env = json.load(f)["torch"]
    with open(os.path.join(path, "journal_tail.jsonl")) as f:
        tail = [json.loads(line) for line in f if line.strip()]
    if ring.get("entries", 0) < 1:
        raise RuntimeError(f"bundle {path}: empty flight ring {ring}")
    if sorted(libs) != ["fused_gather", "fused_stats", "ring_shift"]:
        raise RuntimeError(f"bundle {path}: kernel libraries {sorted(libs)}")
    if journal and not tail:
        raise RuntimeError(f"bundle {path}: empty journal tail")
    return {"files": sorted(have), "ring": ring,
            "libraries": {n: {"lib": os.path.basename(v["lib"]),
                              "exists": v["exists"], "loaded": v["loaded"],
                              "build_s": v["build_s"]}
                          for n, v in libs.items()},
            "torch": env, "journal_tail": len(tail)}


def forensics_phase(np, module_preservation, card) -> None:
    """``forensics``: a journaled server on the card (a 2,000-gene fixture,
    one request) answers the ``dump`` op with a bundle (:func:`check_bundle`:
    its files, a non-empty flight ring, the three kernel libraries, the
    journal's redacted tail); then a checkpoint written with one seed is
    refused for another, and the ``checkpoint_refused`` detector fires on
    the run's bus and in the flight ring."""
    import shutil
    import tempfile
    import threading

    from netrep_tpu_torch.data import make_example_pair, pair_frames
    from netrep_tpu_torch.serve import PreservationServer, ServeConfig
    from netrep_tpu_torch.serve.server import dispatch_op
    from netrep_tpu_torch.utils import flightrec
    from netrep_tpu_torch.utils import telemetry as tm
    from netrep_tpu_torch.utils.config import EngineConfig

    os.makedirs(build_dir(), exist_ok=True)
    top = tempfile.mkdtemp(prefix="forensics_", dir=build_dir())
    try:
        srv = PreservationServer(ServeConfig(
            engine=EngineConfig(), journal=os.path.join(top, "journal.jsonl"),
            telemetry=os.path.join(top, "server.jsonl")))
        try:
            srv.register_fixture("acme", "fx", genes=2000, modules=10,
                                 n_samples=64, seed=7)
            res = srv.analyze("acme", "fx_d", "fx_t", n_perm=1024, seed=1,
                              timeout=600)
            t0 = time.perf_counter()
            resp = dispatch_op(srv, {"op": "dump", "reason": "chip",
                                     "dest": os.path.join(top, "bundle")},
                               threading.Event())
            dump_s = time.perf_counter() - t0
            stats = srv.stats()
        finally:
            srv.close()
        if not resp.get("ok"):
            raise RuntimeError(f"dump op: {resp}")
        bundle = check_bundle(resp["bundle"], journal=True)

        pair = make_example_pair(np.random.default_rng(3))
        d, t = pair_frames(pair)
        kw = dict(network={"d": d["network"], "t": t["network"]},
                  data={"d": d["data"], "t": t["data"]},
                  correlation={"d": d["correlation"], "t": t["correlation"]},
                  module_assignments=pair["labels"], n_perm=256, seed=4,
                  checkpoint_dir=os.path.join(top, "ck"))
        module_preservation(**kw)
        bus = os.path.join(top, "refused.jsonl")
        try:
            module_preservation(**{**kw, "seed": 5}, telemetry=bus)
        except ValueError as e:
            refused = str(e)
        else:
            raise RuntimeError("a checkpoint of another seed was resumed")
        fired = [e["data"] for e in tm.read_events(bus)
                 if e["ev"] == "anomaly_detected"]
        in_ring = [e["data"] for e in flightrec.recorder().snapshot()
                   if e["ev"] == "anomaly_detected"
                   and e["data"].get("detector") == "checkpoint_refused"]
        if ([a["detector"] for a in fired] != ["checkpoint_refused"]
                or fired[0]["why"] != "prng_key_mismatch" or not in_ring):
            raise RuntimeError(f"checkpoint_refused: bus {fired}, ring "
                               f"{in_ring}")
    finally:
        shutil.rmtree(top, ignore_errors=True)
    emit({"phase": "forensics", "dump": {"s": dump_s, **bundle},
          "served_p_min": float(np.min(res["p_values"])),
          "server_utilisation": stats["utilisation"],
          "checkpoint_refused": {"why": fired[0]["why"],
                                 "error": refused[:120], "in_ring": True},
          "card": card})


def tooling_only() -> int:
    """``--tooling``: this slice's phases alone — the kernel table's rows
    1-2 bound by the cost model beside the sector floor, ``roofline``,
    ``flightrec_ab``, ``selftest`` and ``forensics`` — at the main path's
    width."""
    ready = mode_setup()
    if ready is None:
        return 1
    torch, np, dev, card = ready
    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.ops import fused_stats as fs
    from netrep_tpu_torch.utils import costmodel
    from netrep_tpu_torch.utils.config import EngineConfig

    cfg = EngineConfig()
    _sizes, labels, (xd, xt, _x2) = make_cohorts(np)
    disc, test = mats(torch, xd, dev), mats(torch, xt, dev)
    engine, chunk, _obs = first_chunk(torch, np, labels, disc, test, cfg, dev)
    sector_bytes, flops_kernel, _pb = fused_work(fs, costmodel, engine, chunk,
                                                 cfg)
    emit({"phase": "kernel_bounds", "unit": f"one chunk of "
          f"{cfg.chunk_size} permutations x {MODULES} modules",
          "model": {f"{mode}/{dt}": fused_bound(costmodel, engine,
                                                mode == "counts", dt)
                    for mode in ("values", "counts")
                    for dt in ("float32", "bfloat16")},
          "sector_floor_ms": 1e3 * sector_bytes / HBM_BPS,
          "kernel_ops_ms": 1e3 * flops_kernel / F32_FLOPS, "card": card})
    del engine, chunk, _obs
    host = [[m.cpu().numpy() for m in ms] for ms in (disc, test)]
    del disc, test
    torch.cuda.empty_cache()
    kw = dict(network={"disc": host[0][2], "test": host[1][2]},
              data={"disc": host[0][0], "test": host[1][0]},
              correlation={"disc": host[0][1], "test": host[1][1]},
              module_assignments=list(labels), discovery="disc",
              test="test", n_perm=N_PERM, seed=SEED, device="cuda")
    drive = make_drive(torch, np, tops, module_preservation, kw, card)
    composed_cfg = EngineConfig(stat_mode="xla", gather_mode="fused")
    roofline_phase(np, drive, cfg, composed_cfg, card)
    flightrec_ab_phase(np, drive, cfg, composed_cfg, card)
    selftest_phase(card)
    forensics_phase(np, module_preservation, card)
    print(card_line(), flush=True)
    return 0


#: the startup phase: a fresh process's first null at the main path's
#: widths by the fixture generator (``FLEET_FIXTURE``), chunk 128, this
#: many permutations
STARTUP_PERM = 1024
#: the fleet_daemon phase's requests: the in-process fleet's seeds (fleet
#: phase): 300 before the drill, 301-302 killed mid-pack, 303-304 after
#: the respawn
DAEMON_SEEDS = (300, 301, 302, 303, 304)
FIELDS = ("p_values", "counts_hi", "counts_lo", "counts_eff")


def here() -> str:
    return os.path.dirname(os.path.abspath(__file__))


def cli_env(**extra) -> dict:
    """The environment of a ``python -m netrep_tpu_torch`` child: the
    checkout beside this script first on ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here(), env.get("PYTHONPATH")) if p)
    env.pop("NETREP_FAULT_PLAN", None)
    env.update(extra)
    return env


def start_cli(*argv, cwd=None, **env) -> tuple:
    """``python -m netrep_tpu_torch ARGV`` started: ``(process, start
    time)`` for :func:`wait_cli`."""
    return subprocess.Popen(
        [sys.executable, "-m", "netrep_tpu_torch", *argv], cwd=cwd or here(),
        env=cli_env(**env), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True), time.perf_counter()


def wait_cli(started, timeout=900) -> tuple:
    """``(returncode, stdout, stderr, wall seconds)`` of a process from
    :func:`start_cli`, killed at ``timeout``."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, out, err, time.perf_counter() - t0


def run_cli(*argv, cwd=None, timeout=900, **env) -> tuple:
    """``python -m netrep_tpu_torch ARGV``: ``(returncode, stdout, stderr,
    wall seconds)``."""
    return wait_cli(start_cli(*argv, cwd=cwd, **env), timeout)


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def boot_split(boot: dict, t_spawn: float) -> dict:
    """A daemon's ready-line ``boot`` block as the split of its start:
    the interpreter (spawn to the CLI's import), the imports, the CUDA
    context, the kernel libraries, the journal, and the rest up to the
    ready line."""
    parts = {"interpreter_s": boot["t_main"] - t_spawn}
    for k in ("import_torch_s", "import_utils_s", "import_serve_s",
              "context_s", "libraries_s", "journal_s"):
        parts[k] = boot.get(k, 0.0)
    total = boot["ready_t"] - t_spawn
    parts["rest_s"] = total - sum(parts.values())
    parts["ready_s"] = total
    parts["libraries"] = boot.get("libraries", {})
    return parts


def daemon_boot(cwd: str, store: str) -> dict:
    """One fresh daemon on the card as a fleet replica would start
    (``serve --fleet-label r0``: every kernel library built or loaded at
    boot) with ``NETREP_AOT_STORE=store``, shut down once ready; its boot
    split."""
    t_spawn = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "netrep_tpu_torch", "serve", "--socket",
         "s.sock", "--journal", "j.jsonl", "--fleet-label", "r0"],
        cwd=cwd, env=cli_env(NETREP_AOT_STORE=store),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline() or "{}")
        if ready.get("serve") != "ready":
            raise RuntimeError(f"startup: the daemon did not start: "
                               f"{proc.stderr.read()[-3000:]}")
        from netrep_tpu_torch.serve.client import SocketClient

        # the absolute path: another thread may hold this process's
        # working directory (the whole script's fleet_daemon)
        c = SocketClient(os.path.join(cwd, "s.sock"), timeout=120)
        c.shutdown()
        c.close()
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"startup: daemon exit {proc.returncode}: "
                           f"{err[-3000:]}")
    return boot_split(ready["boot"], t_spawn)


def startup_phase(card, first_launch=True) -> dict:
    """``startup``: where a fresh process's start goes, on the card.

    - **daemon**: a replica daemon's boot (``serve --fleet-label``), cold
      (an empty ``NETREP_AOT_STORE``: ``nvcc`` builds every library) and
      warm (the same store: every library loaded), split by its ready
      line into the interpreter's start, ``import torch``, the port's
      ``utils`` (flight recorder, TF32 off), the serving modules, the CUDA
      context, each library's build or load (its ``source``), the journal
      and the rest up to the ready line;
    - **first_null**: ``warmup --measure`` at the main path's widths
      (``FLEET_FIXTURE``, chunk 128, ``STARTUP_PERM`` permutations) in a
      fresh process, cold (another empty store) and warm: ``first_run_s``,
      ``compile_span_s``, ``source``, permutations/s, the process's wall
      (each started beside the daemon of the same temperature: two
      processes at a time);
    - **first_launch** (``--startup``; the whole script leaves it out for
      time): ``warmup`` on the warm store at the default shape: each
      engine's first chunk in a fresh process, with its launches.

    Fails unless the cold daemon's libraries are all ``jit`` and the warm
    one's all ``aot``, and the first null's source is ``jit`` cold and
    ``aot`` warm."""
    import shutil
    import tempfile

    os.makedirs(build_dir(), exist_ok=True)
    top = tempfile.mkdtemp(prefix="st_", dir=build_dir())
    out = {}
    try:
        daemon_store = os.path.join(top, "store_d")
        measure_store = os.path.join(top, "store_m")
        boots, firsts, measured = {}, {}, {}
        g = FLEET_FIXTURE
        for temp in ("cold", "warm"):
            measured[temp] = start_cli(
                "warmup", "--measure", "--json", "--genes", str(g["genes"]),
                "--modules", str(g["modules"]), "--samples",
                str(g["n_samples"]), "--fixture-seed", str(g["seed"]),
                "--chunk", "128", "--n-perm", str(STARTUP_PERM), "--store",
                measure_store)
            cwd = os.path.join(top, temp)
            os.makedirs(cwd)
            try:
                boots[temp] = daemon_boot(cwd, daemon_store)
            finally:
                measured[temp] = wait_cli(measured[temp])
            srcs = {v["source"] for v in boots[temp]["libraries"].values()}
            want = "jit" if temp == "cold" else "aot"
            if srcs != {want} or len(boots[temp]["libraries"]) != 3:
                raise RuntimeError(f"startup: {temp} daemon's libraries "
                                   f"{boots[temp]['libraries']}")
        out["daemon"] = boots
        emit({"phase": "startup", "part": "daemon", **boots, "card": card})
        for temp in ("cold", "warm"):
            rc, so, se, wall = measured[temp]
            if rc != 0:
                raise RuntimeError(f"startup: warmup --measure ({temp}) exit "
                                   f"{rc}: {se[-3000:]}")
            firsts[temp] = {**last_json(so), "process_wall_s": wall}
            want = "jit" if temp == "cold" else "aot"
            if (firsts[temp]["source"] != want
                    or firsts[temp]["completed"] != STARTUP_PERM):
                raise RuntimeError(f"startup: first null ({temp}): "
                                   f"{firsts[temp]}")
        out["first_null"] = firsts
        emit({"phase": "startup", "part": "first_null", **firsts,
              "card": card})
        if not first_launch:
            return out
        # every library is in the daemons' store: the first chunk of each
        # engine in a fresh process loads them all
        rc, so, se, wall = run_cli("warmup", "--json", "--store",
                                   daemon_store)
        if rc != 0:
            raise RuntimeError(f"startup: warmup exit {rc}: {se[-3000:]}")
        rep = last_json(so)
        acquired = rep["store"]["acquired"]
        if sorted(acquired) != sorted(f"{n}:aot" for n in
                                      ("fused_stats", "fused_gather",
                                       "ring_shift")):
            raise RuntimeError(f"startup: warmup acquired {acquired}")
        out["first_launch"] = {"shape": {k: rep["shapes"][0][k] for k in
                                         ("genes", "modules", "samples")},
                               "chunk": rep["chunk"],
                               "serve": rep["shapes"][0]["serve"],
                               "direct": rep["shapes"][0]["direct"],
                               "acquired": acquired, "warmup_s": rep["s"],
                               "process_wall_s": wall}
        emit({"phase": "startup", "part": "first_launch",
              **out["first_launch"], "card": card})
    finally:
        shutil.rmtree(top, ignore_errors=True)
    return out


def cli_phase(np, card) -> dict:
    """``cli``: the port's command line on the card, through its ``main``
    in this process (``startup`` and ``fleet_daemon`` start ``python -m
    netrep_tpu_torch`` processes): ``chaos --json`` (the elastic drill on
    a logical four-shard permutation mesh on the card, with
    ``--telemetry``); two streaming nulls with ``telemetry=`` and
    ``NETREP_PERF_LEDGER`` on (a 4,000-gene fixture, 2,048 permutations,
    chunk 128); then ``selftest --json``, ``telemetry`` (plain and
    ``--prom`` on a null's log, ``--recovery`` on the drill's),
    ``roofline --check``, ``perf --check`` and ``version``. Each must exit
    0."""
    import contextlib
    import io
    import shutil
    import tempfile

    from netrep_tpu_torch import __main__ as tcli
    from netrep_tpu_torch.data import make_mixed_pair
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.utils import perfledger
    from netrep_tpu_torch.utils.config import EngineConfig

    os.makedirs(build_dir(), exist_ok=True)
    top = tempfile.mkdtemp(prefix="cli_", dir=build_dir())
    chaos_tel = os.path.join(top, "chaos.jsonl")
    ledger = os.path.join(top, "ledger.jsonl")
    runs = [os.path.join(top, f"run{i}.jsonl") for i in (1, 2)]
    out = {}
    before = os.environ.get(perfledger.LEDGER_ENV)
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = tcli.main(["chaos", "--json", "--telemetry", chaos_tel])
        row = last_json(buf.getvalue()) if rc == 0 else {}
        if rc != 0 or not (row.get("ok") and row.get("bit_identical")):
            raise RuntimeError(f"cli: chaos exit {rc}: "
                               f"{buf.getvalue()[-2000:]}")
        out["chaos"] = {"rc": rc, "s": time.perf_counter() - t0, **row}
        mixed = make_mixed_pair(4000, 10, n_samples=64, seed=SEED)
        (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
        labels = np.zeros(dn.shape[0], dtype=int)
        for lab, idx in mixed["specs"]:
            labels[idx] = int(lab)
        os.environ[perfledger.LEDGER_ENV] = ledger
        for path in runs:
            module_preservation(
                network={"d": dn, "t": tn}, correlation={"d": dc, "t": tc},
                data={"d": dd, "t": td},
                module_assignments=[str(x) for x in labels], discovery="d",
                test="t", n_perm=2048, seed=SEED, store_nulls=False,
                config=EngineConfig(chunk_size=128), telemetry=path)
        for argv in (["selftest", "--json"], ["telemetry", runs[0]],
                     ["telemetry", runs[0], "--prom"],
                     ["telemetry", chaos_tel, "--recovery"],
                     ["roofline", runs[1], "--ledger", ledger, "--check"],
                     ["perf", ledger, "--check"], ["version"]):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = tcli.main(argv)
            text = buf.getvalue()
            if rc != 0 or not text.strip():
                raise RuntimeError(f"cli: {argv} exit {rc}: {text[-2000:]}")
            key = " ".join(os.path.basename(a) for a in argv)
            out[key] = {"rc": rc, "s": time.perf_counter() - t0,
                        "lines": len(text.splitlines())}
            if argv[-1] == "--recovery" and "mesh_shrunk" not in text:
                raise RuntimeError("cli: the chaos drill never shrank its "
                                   "mesh")
            if argv[0] == "selftest":
                row = last_json(text)
                if not row["ok"] or row["device"] == "cpu":
                    raise RuntimeError(f"cli: selftest {row}")
                out[key]["observed_max_abs_dev"] = row[
                    "observed_max_abs_dev"]
        out["ledger_fingerprints"] = sorted(
            {e["fingerprint"] for e in perfledger.read_entries(ledger)})
    finally:
        if before is None:
            os.environ.pop(perfledger.LEDGER_ENV, None)
        else:
            os.environ[perfledger.LEDGER_ENV] = before
        shutil.rmtree(top, ignore_errors=True)
    emit({"phase": "cli", **out, "card": card})
    return out


def inprocess_refs(torch) -> dict:
    """The ``DAEMON_SEEDS`` requests through one in-process server on the
    card at the fleet's configuration (``--fleet`` alone, without the
    fleet phase's results)."""
    from netrep_tpu_torch.serve import PreservationServer, ServeConfig
    from netrep_tpu_torch.utils.config import EngineConfig

    srv = PreservationServer(ServeConfig(engine=EngineConfig(chunk_size=128),
                                         journal=None))
    try:
        fx = srv.register_fixture("acme", "fx", **FLEET_FIXTURE)
        return {s: srv.analyze("acme", fx["discovery"], fx["test"],
                               n_perm=N_PERM, seed=s, timeout=1200)
                for s in DAEMON_SEEDS}
    finally:
        srv.close()
        torch.cuda.empty_cache()


def daemon_results_check(np, got, refs, card) -> None:
    """``fleet_daemon_check``: every daemon-fleet result's p-values and
    ``counts_hi/lo/eff`` bit-equal to the same request through the
    in-process fleet (``refs``, by seed)."""
    for s in DAEMON_SEEDS:
        for f in FIELDS:
            if not np.array_equal(np.asarray(got[s][f]),
                                  np.asarray(refs[s][f])):
                raise RuntimeError(f"fleet_daemon: seed {s} {f} differs "
                                   f"from the in-process fleet")
    emit({"phase": "fleet_daemon_check", "seeds": list(DAEMON_SEEDS),
          "fields": list(FIELDS), "equal_in_process_fleet": True,
          "card": card})


def fleet_daemon_phase(torch, np, card, refs=None) -> dict:
    """``fleet_daemon``: ``python -m netrep_tpu_torch serve --fleet 2`` on
    the card — a coordinator over two replica daemon processes, chunk 128,
    a checkpoint every 256 permutations, on the 20,000-gene
    ``FLEET_FIXTURE`` registered through the coordinator's socket.

    1. Spawn: the coordinator's ready line (both replicas up), each
       replica's boot split and its libraries' source, the whole card's
       used memory before the spawn, with the two contexts, after the
       registration and after the first request (``whole_card_used_gib``:
       ``torch.cuda.mem_get_info``, so in the whole script, where this
       phase runs beside the start-up drills, ``multi_process`` and the
       installed child, it counts their memory too; the card does not
       name a container's processes, so nothing narrower can be read),
       and the coordinator without a CUDA context.
    2. Seed 300 served; seeds 301 and 302 submitted together, and the
       replica daemon with work in flight SIGKILLed mid-pack (the ``chaos
       --fleet`` drill): the coordinator fails its shipped journal over to
       the peer, the clients' retries under their keys finish there, and
       the victim respawns as its generation ``.g1`` (adopting the
       registrations); then seeds 303 and 304.
    3. The fused kernel's launches in each replica process (the victim's
       read just before the kill); ``failover_done.s``, the respawn's
       seconds; the coordinator drains to exit 0. With ``refs`` (by seed)
       every result is held to them here (:func:`daemon_results_check`);
       the whole script runs this phase before its host arrays fill the
       machine's memory and holds the results to the fleet phase's later.

    Returns the results by seed."""
    import contextlib
    import shutil
    import signal
    import tempfile
    import threading

    from netrep_tpu_torch.serve.client import SocketClient
    from netrep_tpu_torch.utils.telemetry import read_events

    os.makedirs(build_dir(), exist_ok=True)
    top = tempfile.mkdtemp(prefix="fd_", dir=build_dir())
    old = os.getcwd()
    os.chdir(top)   # a unix socket's path is bounded: relative paths
    proc = None
    out: dict = {}
    gib = 2 ** 30

    def card_used():
        free, total = torch.cuda.mem_get_info()
        return (total - free) / gib

    def launches_of(sock):
        c = SocketClient(sock, timeout=60)
        try:
            return c.stats()["kernel_launches"]
        finally:
            c.close()

    try:
        used0 = card_used()
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "netrep_tpu_torch", "serve", "--fleet",
             "2", "--socket", "f.sock", "--fleet-dir", "fl", "--chunk",
             "128", "--checkpoint-every", "256", "--heartbeat-s", "0.25",
             "--telemetry", "coord.jsonl"],
            env=cli_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True)
        ready = json.loads(proc.stdout.readline() or "{}")
        if ready.get("serve") != "ready":
            raise RuntimeError(f"fleet_daemon: no ready line: "
                               f"{proc.stderr.read()[-3000:]}")
        spawn_s = time.perf_counter() - t0
        used_ready = card_used()
        replicas = {rid: {"ready_s": b["ready_t"] - b["spawned_t"],
                          "split": boot_split(b, b["spawned_t"]),
                          "sources": {n: v["source"] for n, v in
                                      b.get("libraries", {}).items()}}
                    for rid, b in ready["boot"].items()}
        c = SocketClient("f.sock", timeout=1200)
        st = c.stats()
        if st["coordinator"]["cuda_initialized"]:
            raise RuntimeError("fleet_daemon: the coordinator holds a CUDA "
                               "context")
        t0 = time.perf_counter()
        fx = c.register_fixture("acme", "fx", **FLEET_FIXTURE)
        register_s = time.perf_counter() - t0
        used_registered = card_used()
        d_name, t_name = fx["discovery"], fx["test"]
        got = {}
        t0 = time.perf_counter()
        got[300] = c.analyze("acme", d_name, t_name, n_perm=N_PERM,
                             seed=300, idempotency_key="d300")
        first_s = time.perf_counter() - t0
        used_engine = card_used()
        lock = threading.Lock()
        errors = []

        def worker(s):
            w = SocketClient("f.sock", timeout=1200)
            try:
                r = w.analyze("acme", d_name, t_name, n_perm=N_PERM, seed=s,
                              idempotency_key=f"d{s}", retries=8)
                with lock:
                    got[s] = r
            # netrep: allow(exception-taxonomy) — a failed request is the drill's failure, raised below
            except Exception as e:
                errors.append(f"seed {s}: {type(e).__name__}: {e}")
            finally:
                w.close()

        threads = [threading.Thread(target=worker, args=(s,), daemon=True)
                   for s in (301, 302)]
        t_drill = time.perf_counter()
        for t in threads:
            t.start()
        victim = None
        deadline = time.monotonic() + 600
        while victim is None and time.monotonic() < deadline:
            for rid, row in sorted(c.stats()["replicas"].items()):
                if row.get("alive") and row.get("inflight") and row.get("pid"):
                    victim = (rid, int(row["pid"]))
                    break
            if victim is None:
                time.sleep(0.01)
        if victim is None:
            raise RuntimeError("fleet_daemon: no replica took the work")
        launches = {victim[0]: launches_of(ready["replicas"][victim[0]])}
        os.kill(victim[1], signal.SIGKILL)
        t_kill = time.perf_counter()
        for t in threads:
            t.join(timeout=1200)
        drill_s = time.perf_counter() - t_drill
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"fleet_daemon: the drill's requests: "
                               f"{errors}")
        respawned = None
        while respawned is None and time.monotonic() < deadline:
            rows = c.stats()["replicas"]
            gens = [r for r, row in rows.items()
                    if r.startswith(victim[0] + ".g") and row.get("alive")]
            if gens:
                respawned = sorted(gens)[-1]
            else:
                time.sleep(0.05)
        if respawned != f"{victim[0]}.g1":
            raise RuntimeError(f"fleet_daemon: respawn {respawned}")
        respawn_s = time.perf_counter() - t_kill
        g1_sock = os.path.join("fl", victim[0], "serve.g1.sock")
        with open(os.path.join("fl", victim[0], "serve.g1.out")) as f:
            g1_boot = json.loads(f.readline())["boot"]
        for s in (303, 304):
            got[s] = c.analyze("acme", d_name, t_name, n_perm=N_PERM, seed=s,
                               idempotency_key=f"d{s}")
        st = c.stats()
        done = {}
        for rid, row in st["replicas"].items():
            if row["alive"]:
                sock = (g1_sock if rid == respawned
                        else ready["replicas"][rid])
                launches[rid] = launches_of(sock)
                done[rid] = row["done"]
        coordinator = st["coordinator"]
        if coordinator["cuda_initialized"]:
            raise RuntimeError("fleet_daemon: the coordinator made a CUDA "
                               "context")
        c.shutdown()
        c.close()
        rc = proc.wait(timeout=600)
        drained = last_json(proc.stdout.read())
        if rc != 0 or drained.get("serve") != "fleet_drained":
            raise RuntimeError(f"fleet_daemon: exit {rc}, {drained}, "
                               f"{proc.stderr.read()[-3000:]}")
        events = list(read_events("coord.jsonl"))
        fo = [e["data"] for e in events if e["ev"] == "failover_done"]
        order = [e["ev"] for e in events if e["ev"] in (
            "replica_lost", "failover_start", "failover_done",
            "ring_rebalanced")]
        i = order.index("replica_lost")
        if len(fo) != 1 or order[i:i + 4] != [
                "replica_lost", "failover_start", "failover_done",
                "ring_rebalanced"]:
            raise RuntimeError(f"fleet_daemon: failover events {order}")
        fused = {rid: sum(v for k, v in row.items()
                          if k.startswith("fused_stats"))
                 for rid, row in launches.items()}
        if not all(fused[rid] for rid, n in done.items() if n):
            raise RuntimeError(f"fleet_daemon: launches {launches}")
        out = {"fixture": FLEET_FIXTURE, "n_perm": N_PERM,
               "spawn_s": spawn_s, "replicas": replicas,
               "whole_card_used_gib": {
                   "before": used0, "two_contexts": used_ready,
                   "registered": used_registered,
                   "after_first_request": used_engine},
               "coordinator_cuda_initialized": False,
               "register_s_two_replicas": register_s,
               "first_request_s": first_s, "killed": victim[0],
               "drill_s": drill_s, "failover_done_s": fo[0]["s"],
               "requeued": fo[0]["requeued"], "respawned": respawned,
               "respawn_s": respawn_s,
               "respawn_boot": {k: v for k, v in g1_boot.items()
                                if k.endswith("_s")},
               "respawn_main_to_ready_s": g1_boot["ready_t"]
               - g1_boot["t_main"],
               "respawn_sources": {n: v["source"] for n, v in
                                   g1_boot.get("libraries", {}).items()},
               "kernel_launches": launches,
               "fused_launches_per_replica": fused,
               "requests_done_per_live_replica": done,
               "seeds": list(DAEMON_SEEDS), "exit_code": rc,
               "drained": drained}
    finally:
        os.chdir(old)
        if proc is not None:
            # the coordinator and every replica daemon it started share
            # its session: none outlives the phase, even on a failure
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
        shutil.rmtree(top, ignore_errors=True)
    emit({"phase": "fleet_daemon", **out, "card": card})
    if refs is not None:
        daemon_results_check(np, got, refs, card)
    return got


#: the native phase: permutations of the C++ host tier at one thread and
#: at every core of the card's host, on the main path's inputs (few, to
#: keep the whole script's time: each call's input checks take 12–15 s
#: on the card's host, these nulls 4–5 s)
NATIVE_PERM_1, NATIVE_PERM_ALL = 16, 128


def host_cpu() -> dict:
    """The host's CPU as ``/proc/cpuinfo`` names its first core (model
    name, vendor, family and model numbers, whether it has AVX2 and
    AVX-512) and its cores: the machine's and this process's."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                k, _, v = line.partition(":")
                info[k.strip()] = v.strip()
    except OSError:
        pass
    flags = info.get("flags", "").split()
    return {"model": info.get("model name"),
            "vendor": info.get("vendor_id"),
            "family": info.get("cpu family"),
            "model_number": info.get("model"),
            "avx2": "avx2" in flags, "avx512f": "avx512f" in flags,
            "cores": os.cpu_count(),
            "usable_cores": len(os.sched_getaffinity(0))}


def native_phase(np, module_preservation, kw, fused_run, card) -> dict:
    """``module_preservation(backend='native')`` on the main path's host
    float64 inputs (adopted without a copy, checked on the CPU): at one
    thread on NATIVE_PERM_1 permutations and at every usable core on
    NATIVE_PERM_ALL, with no device named (the tier needs no card). The
    native observed statistics are held to the card's fused ones
    (``fused_run``, the main path's materialized run) within
    ``tolerance_for('cuda')``, the two native nulls equal on their common
    prefix (the counter-based stream does not depend on the thread count),
    and the rates set beside the card's fused materialized rate on the
    same inputs and seed. Where a native entry is farther than that from
    the card's, the float64 oracle (``ops/oracle.py``, numpy's SVD on the
    module's host slices) decides: the card must lie within the tolerance
    of the oracle and the native tier beyond it there — its power
    iteration stops at 512 steps, as the JAX package's copy does — and
    each such entry is listed."""
    import gc

    from netrep_tpu_torch.native import build as nbuild
    from netrep_tpu_torch.ops import oracle
    from netrep_tpu_torch.utils.selftest import tolerance_for

    tol = tolerance_for("cuda")
    cpu = host_cpu()
    labels = np.asarray(kw["module_assignments"])
    (dc, dn, dd), (tc, tn, td) = [
        [kw[f][side] for f in ("correlation", "network", "data")]
        for side in ("disc", "test")]
    want = []
    for m in fused_run.module_labels:
        i = np.flatnonzero(labels == m)
        dp = oracle.DiscoveryProps(dc[np.ix_(i, i)], dn[np.ix_(i, i)],
                                   dd[:, i])
        want.append(oracle.module_stats(dp, tc[np.ix_(i, i)],
                                        tn[np.ix_(i, i)], td[:, i]))
    want = np.stack(want)
    card_vs_oracle = float(np.abs(fused_run.observed - want).max())
    if card_vs_oracle > tol:
        raise RuntimeError(f"the card's observed statistics differ from the "
                           f"float64 oracle by {card_vs_oracle} > {tol}")
    base = {k: kw[k] for k in ("network", "data", "correlation",
                               "module_assignments", "discovery", "test",
                               "seed")}
    runs, res = {}, {}
    t_phase = time.perf_counter()
    for label, n_threads, n_perm in (
            ("1_thread", 1, NATIVE_PERM_1),
            ("all_threads", cpu["usable_cores"], NATIVE_PERM_ALL)):
        t0 = time.perf_counter()
        r = module_preservation(**base, n_perm=n_perm, backend="native",
                                n_threads=n_threads)
        wall = time.perf_counter() - t0
        if r.observed.shape != (MODULES, 7) or not np.isfinite(
                r.observed).all():
            raise RuntimeError(f"native {label}: observed statistics not "
                               f"finite (MODULES, 7): {r.observed.shape}")
        if r.completed != n_perm or r.nulls.shape != (n_perm, MODULES, 7):
            raise RuntimeError(f"native {label}: completed {r.completed} "
                               f"of {n_perm}, null {r.nulls.shape}")
        if not ((r.p_values > 0) & (r.p_values <= 1)).all():
            raise RuntimeError(f"native {label}: p-values outside (0, 1]")
        dev_card = np.abs(r.observed - fused_run.observed)
        dev_oracle = np.abs(r.observed - want)
        beyond = [
            {"module": fused_run.module_labels[k], "stat": int(j),
             "native": float(r.observed[k, j]),
             "card": float(fused_run.observed[k, j]),
             "oracle": float(want[k, j])}
            for k, j in zip(*np.nonzero(dev_card > tol))]
        if (dev_oracle[dev_card > tol] <= tol).any():
            raise RuntimeError(f"native {label}: observed statistics differ "
                               f"from the card's beyond {tol} where the "
                               f"native tier agrees with the oracle: "
                               f"{beyond}")
        res[label] = r
        runs[label] = {"n_threads": n_threads, "n_perm": n_perm,
                       "wall_s": wall, "input_s": r.profile["input_s"],
                       "engine_s": r.profile["engine_s"],
                       "observed_s": r.profile["observed_s"],
                       "null_s": r.profile["null_s"],
                       "perms_per_s": r.profile["perms_per_s"],
                       "observed_max_abs_err_vs_card": float(dev_card.max()),
                       "observed_max_abs_err_vs_oracle": float(
                           dev_oracle.max()),
                       "beyond_tolerance_of_card": beyond}
    one, every = res["1_thread"].nulls, res["all_threads"].nulls
    if not np.array_equal(one, every[:len(one)], equal_nan=True):
        raise RuntimeError("native nulls differ between 1 thread and "
                           "every core on their common prefix")
    card_pps = fused_run.profile["perms_per_s"]
    native_pps = runs["all_threads"]["perms_per_s"]
    lib = nbuild.library_path()
    emit({"phase": "native", "genes": GENES, "modules": MODULES,
          "samples": SAMPLES, "seed": SEED, "host_cpu": cpu,
          "library": lib.name, "march": nbuild.march() or None,
          "runs": runs, "nulls_equal_on_prefix": True,
          "observed_tolerance": tol,
          "card_observed_max_abs_err_vs_oracle": card_vs_oracle,
          "card_fused_materialized": {
              "n_perm": int(fused_run.completed), "perms_per_s": card_pps,
              "null_s": fused_run.profile["null_s"]},
          "card_speedup_vs_1_thread": card_pps
          / runs["1_thread"]["perms_per_s"],
          "card_speedup_vs_all_threads": card_pps / native_pps,
          "s": time.perf_counter() - t_phase, "card": card})
    del res, one, every, r
    gc.collect()
    return runs


def lint_start() -> tuple:
    """``python -m netrep_tpu_torch lint --json`` started in the
    background (it needs no card): ``(process, start time)`` for
    :func:`lint_check`."""
    return subprocess.Popen(
        [sys.executable, "-m", "netrep_tpu_torch", "lint", "--json"],
        cwd=here(), env=cli_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), time.perf_counter()


def lint_check(card, started=None) -> dict:
    """``python -m netrep_tpu_torch lint --json`` on the checkout beside
    this script (or the run :func:`lint_start` began): exit 0, no
    finding, every suppression with its reason."""
    if started is None:
        rc, out, err, wall = run_cli("lint", "--json", timeout=300)
    else:
        proc, t0 = started
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        rc, wall = proc.returncode, time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"lint exited {rc}:\n{out[-2000:]}{err[-2000:]}")
    row = last_json(out)
    if (row.get("lint_v") != 1 or row.get("ok") is not True
            or row.get("findings")
            or not all(s["reason"].strip() for s in row["suppressions"])):
        raise RuntimeError(f"lint: unexpected report {row}")
    emit({"phase": "lint", "rc": rc, "files": row["files"],
          "rules": row["rules"], "suppressed": len(row["suppressed"]),
          "stale": len(row["stale_suppressions"]), "s": wall, "card": card})
    return row


#: the installed child's five network_properties modules
INSTALLED_PROP_MODULES = 5
#: the installed child: a fresh interpreter that reaches the port only
#: through the installed copy (``sys.argv[1]``) from a working directory
#: outside the checkout (``sys.argv[2]``, which holds the inputs the parent
#: wrote). ``mats`` (this script's, with BETA) is inserted before the body.
INSTALLED_HEAD = r'''
import json
import os
import sys
import time

T0 = time.perf_counter()
import numpy as np
import torch

import netrep_tpu_torch.api as nt

SITE, RUN = sys.argv[1], sys.argv[2]
nt.module_preservation  # the entry point's modules load here, in IMPORT_S
from netrep_tpu_torch import ops as tops
from netrep_tpu_torch.ops import _build

IMPORT_S = time.perf_counter() - T0
'''
INSTALLED_BODY = r'''

def under(path, top):
    return os.path.realpath(path).startswith(os.path.realpath(top) + os.sep)


def main():
    out = {"api_file": nt.__file__, "import_s": IMPORT_S,
           "cwd": os.getcwd()}
    if not under(nt.__file__, SITE):
        raise SystemExit(f"netrep_tpu_torch.api from {nt.__file__}, not "
                         f"from the install {SITE}")
    spec = json.load(open(os.path.join(RUN, "inputs.json")))
    arrays = np.load(os.path.join(RUN, "inputs.npz"))
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    (dd, dc, dn), (td, tc, tn) = [
        [m.cpu().numpy() for m in mats(torch, arrays[k], dev)]
        for k in ("xd", "xt")]
    torch.cuda.empty_cache()
    out["host_inputs_s"] = time.perf_counter() - t0
    pair = dict(network={"disc": dn, "test": tn},
                data={"disc": dd, "test": td},
                correlation={"disc": dc, "test": tc},
                module_assignments=spec["labels"], discovery="disc",
                test="test")
    tops.reset_launches()
    t0 = time.perf_counter()
    res = nt.module_preservation(**pair, n_perm=spec["n_perm"],
                                 seed=spec["seed"], device="cuda")
    out["call_s"] = time.perf_counter() - t0
    out["launches"] = {fn.__name__: fn.launches for fn in tops.kernels()}
    out["profile"] = {k: res.profile[k] for k in (
        "input_s", "engine_s", "observed_s", "null_s", "perms_per_s")}
    info = _build.BUILD_INFO["fused_stats"]
    out["fused_stats"] = {"source": info["source"], "lib": info["lib"],
                          "nvcc_s": info["seconds"]}
    out["module_labels"] = list(res.module_labels)
    out["preserved"] = list(res.preserved_modules())
    out["completed"] = int(res.completed)
    t0 = time.perf_counter()
    props = nt.network_properties(**pair, modules=spec["prop_modules"],
                                  device="cuda")
    out["props_s"] = time.perf_counter() - t0
    keep = {f"props/{m}/{k}": np.asarray(props[m][k], dtype=np.float64)
            for m in spec["prop_modules"] for k in spec["prop_keys"]}
    out["required_perms"] = [nt.required_perms(a, n_tests=n)
                             for a, n in spec["required_perms"]]
    np.savez(os.path.join(RUN, "result.npz"), nulls=res.nulls,
             observed=res.observed, p_values=res.p_values, **keep)
    del pair, res, props, dd, dc, dn, td, tc, tn
    torch.cuda.empty_cache()
    try:
        nt.plot_module
        out["plot_module"] = "resolved"
    except ImportError as e:
        out["plot_module"] = f"ImportError: {e}"
    import importlib.util
    mpl = importlib.util.find_spec("matplotlib") is not None
    ns = {"DEVICE": "cuda"}
    ran, skipped = 0, []
    t0 = time.perf_counter()
    for i, block in enumerate(spec["vignette"]):
        if not mpl and ("matplotlib" in block or "plot_" in block):
            skipped.append(i + 1)
            continue
        exec(compile(block, f"vignette_torch block {i + 1}", "exec"), ns)
        ran += 1
    out["vignette"] = {"blocks": len(spec["vignette"]), "ran": ran,
                       "skipped_plot_blocks": skipped, "matplotlib": mpl,
                       "s": time.perf_counter() - t0,
                       "result_completed": int(ns["result"].completed),
                       "r2_completed": int(ns["r2"].completed),
                       "selftest_ok": bool(ns["report"]["ok"])}
    out["libraries"] = {n: {"source": v["source"], "lib": v["lib"]}
                        for n, v in _build.BUILD_INFO.items()}
    out["jax_loaded"] = "jax" in sys.modules
    out["netrep_tpu_loaded"] = "netrep_tpu" in sys.modules
    out["wall_s"] = time.perf_counter() - T0
    print(json.dumps(out), flush=True)


main()
'''


def wheel_files(top: str) -> list:
    """The files a wheel of the checkout at ``top`` carries, as the
    packaging settings name them: every ``.py`` of ``netrep_tpu*`` and the
    package data (``csrc/*.cu``, ``native/*.cpp``), relative to ``top``."""
    out = []
    for pkg in ("netrep_tpu", "netrep_tpu_torch"):
        for root, dirs, files in os.walk(os.path.join(top, pkg)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                if f.endswith((".py", ".cu", ".cpp")):
                    out.append(os.path.relpath(os.path.join(root, f), top))
    return sorted(out)


def installed_start(np, xd, xt, labels) -> dict:
    """The ``installed`` phase's first half, host work only: a wheel of
    the checkout beside this script built offline (``pip wheel --no-deps
    --no-build-isolation --no-index`` on a copy of the files it packages,
    so nothing is written into the checkout) and installed with ``pip
    install --no-deps --no-index --target`` into a fresh directory outside
    the checkout (a wheel that does not build or install fails the
    phase, with pip's own error); the main path's data
    arrays and labels written beside it; then the child started: a fresh
    interpreter with ``PYTHONPATH`` naming only the install, its working
    directory outside the checkout, no kernel-library or autotune store
    named (so both land in the install's default). Returns the state
    :func:`installed_check` waits on."""
    import shutil
    import tempfile
    import zipfile

    t0 = time.perf_counter()
    top = tempfile.mkdtemp(prefix="netrep_installed_")
    src, whl, site, run = (os.path.join(top, d) for d in
                           ("src", "wheel", "site", "run"))
    files = wheel_files(here())
    for rel in files + ["pyproject.toml", "README.md"]:
        os.makedirs(os.path.dirname(os.path.join(src, rel)), exist_ok=True)
        shutil.copy2(os.path.join(here(), rel), os.path.join(src, rel))
    pip = [sys.executable, "-m", "pip"]
    env = dict(os.environ, PIP_NO_INDEX="1", PIP_DISABLE_PIP_VERSION_CHECK="1")
    built = subprocess.run(
        pip + ["wheel", "--no-deps", "--no-build-isolation", "--no-index",
               "-w", whl, src],
        capture_output=True, text=True, env=env, timeout=300)
    wheels = sorted(os.listdir(whl)) if os.path.isdir(whl) else []
    if built.returncode != 0 or len(wheels) != 1:
        raise RuntimeError(f"installed: pip wheel exit {built.returncode}, "
                           f"wheels {wheels}: "
                           f"{(built.stderr or built.stdout)[-3000:]}")
    path = os.path.join(whl, wheels[0])
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
    missing = [f for f in files if f not in names]
    if missing:
        raise RuntimeError(f"installed: the wheel lacks {missing[:10]}")
    inst = subprocess.run(
        pip + ["install", "--no-deps", "--no-index", "--target", site, path],
        capture_output=True, text=True, env=env, timeout=300)
    if inst.returncode != 0:
        raise RuntimeError(f"installed: pip install exit "
                           f"{inst.returncode}: {inst.stderr[-3000:]}")
    state = {"top": top, "site": site, "run": run, "files": len(files),
             "wheel": wheels[0], "wheel_bytes": os.path.getsize(path),
             "wheel_entries": len(names),
             "port_entries": sum(n.startswith("netrep_tpu_torch/")
                                 for n in names)}
    shutil.rmtree(src, ignore_errors=True)
    os.makedirs(run)
    mods = sorted(set(labels) - {"0"}, key=int)[:INSTALLED_PROP_MODULES]
    spec = {"labels": [str(v) for v in labels], "n_perm": N_PERM,
            "seed": SEED, "prop_modules": mods,
            "prop_keys": ["degree", "summary", "contribution", "coherence",
                          "avg_weight"],
            "required_perms": [[0.05, 1], [0.05, MODULES * 7],
                               [0.01, MODULES * 7]],
            "vignette": vignette_blocks()}
    with open(os.path.join(run, "inputs.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(run, "inputs.npz"), xd=xd, xt=xt)
    import inspect

    with open(os.path.join(run, "child.py"), "w") as f:
        f.write(INSTALLED_HEAD + f"\nBETA = {BETA!r}\n\n\n"
                + inspect.getsource(mats) + INSTALLED_BODY)
    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("PYTHONPATH", "NETREP_AOT_STORE",
                              "NETREP_AUTOTUNE_STORE", "NETREP_FAULT_PLAN")}
    child_env["PYTHONPATH"] = site
    state["setup_s"] = time.perf_counter() - t0
    state["proc"] = subprocess.Popen(
        [sys.executable, os.path.join(run, "child.py"), site, run], cwd=run,
        env=child_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return state


def vignette_blocks() -> list:
    """The ``python`` blocks of ``docs/vignette_torch.md``, in order."""
    with open(os.path.join(here(), "docs", "vignette_torch.md")) as f:
        return re.findall(r"```python\n(.*?)```", f.read(), flags=re.S)


def installed_check(np, state, fused_run, kw, launches, card) -> dict:
    """The ``installed`` phase's second half: wait for the child, then
    hold it to this process. Fails unless the child imported the port from
    the install, built ``fused_stats.cu`` there (``source`` ``jit``, the
    library under the install, its file name — the source's and flags'
    digest — the checkout's, the installed source byte-equal to the
    checkout's) and launched the fused-statistics kernel as often as the
    main path's materialized run (``launches``); unless its module sets,
    counts and p-values equal ``fused_run``'s (the main path's call on the
    same inputs in this process) and its null equals it bit for bit (the
    same kernel and chunking on the same card); unless its
    ``network_properties`` and ``required_perms`` equal this process's;
    unless ``plot_module`` raised the ``plot`` extra's ``ImportError``
    where matplotlib is absent and every other block of the walkthrough
    ran; and unless ``jax`` never loaded. Prints the largest differences
    either way."""
    import hashlib
    import shutil

    from netrep_tpu_torch.models.properties import network_properties
    from netrep_tpu_torch.ops import _build
    from netrep_tpu_torch.ops import pvalues as pv

    proc, site, run = state["proc"], state["site"], state["run"]
    try:
        try:
            so, se = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"installed: the child exited "
                               f"{proc.returncode}: {se[-4000:]}")
        got = last_json(so)
        res = np.load(os.path.join(run, "result.npz"))
        lib = got["fused_stats"]["lib"]
        inst_src = os.path.join(site, "netrep_tpu_torch", "csrc",
                                "fused_stats.cu")
        digest = {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
                  for p in (inst_src, str(_build.CSRC / "fused_stats.cu"))}
        store = os.path.join(site, "build", "netrep_tpu_torch")
        nulls_equal = bool(np.array_equal(res["nulls"], fused_run.nulls,
                                          equal_nan=True))
        diff = {
            "nulls": nulls_err(np, res["nulls"], fused_run.nulls),
            "observed": float(np.abs(res["observed"]
                                     - fused_run.observed).max()),
            "p_values": float(np.abs(res["p_values"]
                                     - fused_run.p_values).max()),
        }
        counts_equal = all(np.array_equal(a, b) for a, b in zip(
            pv.tail_counts(res["observed"], res["nulls"]),
            pv.tail_counts(fused_run.observed, fused_run.nulls)))
        mods = sorted(set(kw["module_assignments"]) - {"0"},
                      key=int)[:INSTALLED_PROP_MODULES]
        pair = {f: {k: kw[f][k] for k in ("disc", "test")}
                for f in ("network", "data", "correlation")}
        props = network_properties(
            **pair, module_assignments=kw["module_assignments"],
            discovery="disc", test="test", modules=mods, device="cuda")
        props_diff = max(
            float(np.max(np.abs(res[f"props/{m}/{k}"] - np.asarray(
                props[m][k], dtype=np.float64))))
            for m in mods for k in ("degree", "summary", "contribution",
                                    "coherence", "avg_weight"))
        want_perms = [pv.required_perms(a, n_tests=n) for a, n in (
            (0.05, 1), (0.05, MODULES * 7), (0.01, MODULES * 7))]
        vig = got["vignette"]
        plot_ok = (vig["matplotlib"] and got["plot_module"] == "resolved") or (
            not vig["matplotlib"]
            and "pip install netrep-tpu[plot]" in got["plot_module"])
        row = {
            "phase": "installed",
            "wheel": state["wheel"], "wheel_bytes": state["wheel_bytes"],
            "wheel_entries": state["wheel_entries"],
            "port_entries": state["port_entries"],
            "setup_s": state["setup_s"],
            "child": {k: got[k] for k in (
                "import_s", "host_inputs_s", "call_s", "props_s",
                "wall_s", "profile", "launches",
                "completed", "api_file", "cwd", "plot_module",
                "vignette", "libraries", "jax_loaded")},
            "nvcc_s": got["fused_stats"]["nvcc_s"],
            "fused_stats": got["fused_stats"], "store": store,
            "source_sha256_equal": len(set(digest.values())) == 1,
            "library_name_equal": os.path.basename(lib)
            == _build.library_path("fused_stats").name,
            "nulls_bit_equal": nulls_equal, "counts_equal": counts_equal,
            "max_abs_diff_vs_in_process": diff,
            "props_max_abs_diff": props_diff,
            "required_perms": got["required_perms"],
            "genes": GENES, "modules": MODULES, "samples": SAMPLES,
            "n_perm": N_PERM, "seed": SEED, "card": card}
        emit(row)
        fails = []
        if not (got["api_file"].startswith(site + os.sep)
                and got["cwd"].startswith(state["top"])):
            fails.append("the child did not run the installed copy")
        if got["fused_stats"]["source"] != "jit" or not lib.startswith(
                store + os.sep):
            fails.append(f"fused_stats acquired {got['fused_stats']}")
        if not (row["source_sha256_equal"] and row["library_name_equal"]):
            fails.append("the installed source differs from the checkout's")
        want = launches["fused_stats_values"]
        if got["launches"]["fused_stats_values"] != want:
            fails.append(f"{got['launches']} fused launches, main path "
                         f"{want}")
        if not (nulls_equal and counts_equal and np.array_equal(
                res["p_values"], fused_run.p_values)):
            fails.append(f"results differ from the in-process call: {diff}")
        if (got["module_labels"] != list(fused_run.module_labels)
                or got["preserved"] != list(fused_run.preserved_modules())
                or got["completed"] != fused_run.completed):
            fails.append("module sets differ from the in-process call")
        if props_diff != 0.0 or got["required_perms"] != want_perms:
            fails.append(f"network_properties / required_perms differ: "
                         f"{props_diff}, {got['required_perms']} vs "
                         f"{want_perms}")
        if not plot_ok:
            fails.append(f"plot_module: {got['plot_module']}")
        if (vig["ran"] + len(vig["skipped_plot_blocks"]) != vig["blocks"]
                or (vig["matplotlib"] and vig["skipped_plot_blocks"])
                or vig["result_completed"] != 250
                or vig["r2_completed"] != 256 or not vig["selftest_ok"]):
            fails.append(f"the walkthrough: {vig}")
        if got["jax_loaded"] or got["netrep_tpu_loaded"]:
            fails.append("the child loaded jax or the JAX package")
        if fails:
            raise RuntimeError("installed: " + "; ".join(fails))
        return row
    finally:
        shutil.rmtree(state["top"], ignore_errors=True)


def installed_only() -> int:
    """``--installed``: the main path's fused materialized run in this
    process, then the ``installed`` phase on the same inputs."""
    setup = mode_setup()
    if setup is None:
        return 1
    torch, np, dev, card = setup
    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.utils.config import EngineConfig

    _sizes, labels, (xd, xt, _x2) = make_cohorts(np)
    (dd, dc, dn), (td, tc, tn) = [
        [m.cpu().numpy() for m in mats(torch, x, dev)] for x in (xd, xt)]
    torch.cuda.empty_cache()
    kw = dict(network={"disc": dn, "test": tn},
              data={"disc": dd, "test": td},
              correlation={"disc": dc, "test": tc},
              module_assignments=list(labels), discovery="disc",
              test="test", n_perm=N_PERM, seed=SEED, device="cuda")
    drive = make_drive(torch, np, tops, module_preservation, kw, card)
    fused_run, launches, _mem = drive("main_path", ["fused_stats_values"],
                                      config=EngineConfig())
    installed_check(np, installed_start(np, xd, xt, labels), fused_run, kw,
                    launches, card)
    print(card_line(), flush=True)
    return 0


def native_only() -> int:
    """``--native``: the lint check, then the main path's fused
    materialized run on the card and the ``native`` phase on the same
    inputs."""
    setup = mode_setup()
    if setup is None:
        return 1
    torch, np, dev, card = setup
    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.utils.config import EngineConfig

    lint_check(card)
    _sizes, labels, (xd, xt, _x2) = make_cohorts(np)
    (dd, dc, dn), (td, tc, tn) = [
        [m.cpu().numpy() for m in mats(torch, x, dev)] for x in (xd, xt)]
    torch.cuda.empty_cache()
    kw = dict(network={"disc": dn, "test": tn},
              data={"disc": dd, "test": td},
              correlation={"disc": dc, "test": tc},
              module_assignments=list(labels), discovery="disc",
              test="test", n_perm=N_PERM, seed=SEED, device="cuda")
    drive = make_drive(torch, np, tops, module_preservation, kw, card)
    fused_run, _launches, _mem = drive("main_path", ["fused_stats_values"],
                                       config=EngineConfig())
    native_phase(np, module_preservation, kw, fused_run, card)
    print(card_line(), flush=True)
    return 0


def autotune_only() -> int:
    """``--autotune``: the ``autotune`` phase alone, on the main path's
    inputs."""
    ready = mode_setup()
    if ready is None:
        return 1
    torch, np, dev, card = ready
    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation

    _sizes, labels, (xd, xt, _x2) = make_cohorts(np)
    kw = host_kw(torch, np, dev, (xd, xt), labels)
    kw["test"] = "test"
    autotune_phase(torch, np, tops, module_preservation, kw, card)
    print(card_line(), flush=True)
    return 0


def startup_only() -> int:
    """``--startup``: this slice's phases alone — ``startup``, ``cli`` and
    ``fleet_daemon`` (its references from one in-process server)."""
    setup = mode_setup()
    if setup is None:
        return 1
    torch, np, _dev, card = setup
    startup_phase(card)
    cli_phase(np, card)
    t0 = time.perf_counter()
    refs = inprocess_refs(torch)
    emit({"phase": "inprocess_refs", "seeds": list(DAEMON_SEEDS),
          "s": time.perf_counter() - t0, "card": card})
    fleet_daemon_phase(torch, np, card, refs=refs)
    print(card_line(), flush=True)
    return 0


def serve_memory(torch, np, kw, labels, card) -> dict:
    """A server on the card (pool of 8, fused statistics, SERVE_MEM_PERM
    permutations a request) over the three cohorts of ``kw``: three
    requests on (disc, test) with three module sets and one on (disc,
    test2) — four pooled engines, three of them over one test
    registration. The pool's ``held_gib``, the same engines' storages
    counted once and per engine (this script's walk, the same in any
    checkout), the registrations' pinned GiB (each storage once), the
    card's peak over the requests and the card after ``close()``."""
    import shutil
    import tempfile

    from netrep_tpu_torch.serve import (
        InProcessClient, PreservationServer, ServeConfig,
    )
    from netrep_tpu_torch.utils.config import EngineConfig

    mods = sorted(set(labels) - {"0"}, key=int)
    root = tempfile.mkdtemp(prefix="netrep_servemem_")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    srv = PreservationServer(ServeConfig(engine=EngineConfig(), pool_size=8,
                                         slo_s=600.0))
    client = InProcessClient(srv)
    try:
        for name in ("disc", "test", "test2"):
            client.register_dataset(
                "acme", name, network=kw["network"][name],
                correlation=kw["correlation"][name], data=kw["data"][name],
                assignments=labels if name == "disc" else None)
        torch.cuda.synchronize()
        registered = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k = max(1, len(mods) // 5)
        for t, sub in (("test", mods[:k]), ("test", mods[k:3 * k]),
                       ("test", mods), ("test2", mods)):
            client.analyze("acme", "disc", t, modules=sub,
                           n_perm=SERVE_MEM_PERM, seed=7, timeout=1200)
        st = srv.stats()
        engines = list(srv.pool._lru.values())
        rep = {"phase": "memory", "run": "serve",
               "engines": len(engines),
               "pool_held_gib": st["pool"]["held_gib"],
               "engines_gib_distinct": gib_of(storages(torch, engines)),
               "engines_gib_each": [gib_of(storages(torch, [e]))
                                    for e in engines],
               "registrations_gib": st["datasets_gib"],
               "registrations_pinned_gib_distinct": gib_of(storages(
                   torch, [t.datasets for t in srv._tenants.values()],
                   "cpu")),
               "card_after_register_gib": (registered - before) / 2**30,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    finally:
        srv.close()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rep["card_after_close_gib"] = (torch.cuda.memory_allocated()
                                   - before) / 2**30
    emit({**rep, "card": card})
    return rep


def fleet_memory(torch, np, kw, labels, card) -> dict:
    """Two in-process replicas on the card, the three cohorts of ``kw``
    registered on both (each with the modules): the registrations' pinned
    GiB per replica and for the process (each storage once); after the
    six cells of the grid, each on its home, the pools' GiB per replica
    and for the process (six engines, two on each test cohort); the card
    after ``close()``."""
    import shutil
    import tempfile

    from netrep_tpu_torch.serve import (
        FleetConfig, ServeConfig, build_inprocess_fleet,
    )
    from netrep_tpu_torch.utils.config import EngineConfig

    root = tempfile.mkdtemp(prefix="netrep_fleetmem_")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    fleet = build_inprocess_fleet(
        2, root, make_config=lambda rid, _j, _c: ServeConfig(
            engine=EngineConfig(), fleet_label=rid, slo_s=600.0),
        fleet_config=FleetConfig(heartbeat_s=3600.0))
    try:
        names = ("disc", "test", "test2")
        for name in names:
            fleet.register_dataset(
                "acme", name, network=kw["network"][name],
                correlation=kw["correlation"][name], data=kw["data"][name],
                assignments=labels)
        reps = dict(sorted(fleet.live_replicas().items()))

        def pinned(rs):
            return gib_of(storages(torch, [
                t.datasets for r in rs for t in r.server._tenants.values()],
                "cpu"))

        for d in names:
            for t in names:
                if t != d:
                    fleet.analyze("acme", d, t, n_perm=SERVE_MEM_PERM,
                                  seed=7, timeout=1200)

        def pooled(rs):
            return gib_of(storages(torch, [list(r.server.pool._lru.values())
                                           for r in rs]))

        rep = {"phase": "memory", "run": "fleet", "replicas": len(reps),
               "pinned_gib_per_replica": {rid: pinned([r])
                                          for rid, r in reps.items()},
               "pinned_gib_process": pinned(reps.values()),
               "pool_gib_per_replica": {rid: pooled([r])
                                        for rid, r in reps.items()},
               "pool_gib_process": pooled(reps.values()),
               "pool_held_gib": {rid: r.stats()["pool"]["held_gib"]
                                 for rid, r in reps.items()}}
    finally:
        fleet.close()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rep["card_after_close_gib"] = (torch.cuda.memory_allocated()
                                   - before) / 2**30
    emit({**rep, "card": card})
    return rep


def memory_only() -> int:
    """``--memory``: where the datasets' matrices live and what the card
    holds, read the same way through the ``netrep_tpu_torch`` beside this
    script (another checkout's, to hold two versions to each other on one
    card): the main path (both modes) and the 1×4 ring and psum nulls on
    host float64 inputs, each call's peak, launches and the discovery
    dataset's bytes on the card after the input phase;
    ``network_properties`` at the main path's width; ``genome_scale``
    (float32, bfloat16); :func:`serve_memory` and :func:`fleet_memory` on
    the three cohorts (host float32)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.models.properties import network_properties
    from netrep_tpu_torch.ops import _build
    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.utils.config import EngineConfig

    dev = torch.device("cuda")
    card = card_line()
    _build.build(list(_build.SOURCES))
    _sizes, labels, cohorts = make_cohorts(np)
    host = [[m.cpu().numpy() for m in mats(torch, x, dev)]
            for x in cohorts[:2]]
    torch.cuda.empty_cache()
    names = ("disc", "test")
    kw = dict(network={k: h[2] for k, h in zip(names, host)},
              data={k: h[0] for k, h in zip(names, host)},
              correlation={k: h[1] for k, h in zip(names, host)},
              module_assignments=list(labels), discovery="disc",
              test="test", n_perm=N_PERM, seed=SEED, device="cuda")
    row = make_mesh(1, 4, devices=[dev] * 4)
    runs = {
        "main/materialized": dict(config=EngineConfig()),
        "main/streaming": dict(config=EngineConfig(), store_nulls=False),
        "ring/materialized": dict(config=EngineConfig(matrix_sharding="row"),
                                  mesh=row),
        "psum/streaming": dict(config=EngineConfig(matrix_sharding="row",
                                                   stat_mode="xla"),
                               store_nulls=False, mesh=row),
    }
    on_card, undo = spy_datasets(torch)
    try:
        for name, call in runs.items():
            on_card.clear()
            tops.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = module_preservation(**{**kw, **call})
            emit({"phase": "memory", "run": name, "wall_s":
                  time.perf_counter() - t0,
                  **{k: res.profile[k] for k in ("input_s", "engine_s",
                                                 "observed_s", "null_s")},
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "disc_card_gib": on_card["disc"] / 2**30,
                  "test_card_gib": on_card["test"] / 2**30,
                  "launches": {fn.__name__: fn.launches
                               for fn in tops.kernels()},
                  "min_p": float(res.p_values.min()), "card": card})
            del res
        mods = sorted(set(labels) - {"0"}, key=int)[:5]
        on_card.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        network_properties(
            network=kw["network"], data=kw["data"],
            correlation=kw["correlation"],
            module_assignments=list(labels), discovery="disc", test="test",
            modules=mods, device="cuda")
        emit({"phase": "memory", "run": "network_properties",
              "seconds": time.perf_counter() - t0,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "card_gib_after_input": {n: b / 2**30
                                       for n, b in on_card.items()},
              "card": card})
    finally:
        undo()
    # the server and the fleet take host float32 registrations
    kw32 = {f: {n: np.asarray(kw[f][n], dtype=np.float32) for n in names}
            for f in ("network", "data", "correlation")}
    del host, kw
    t2 = [m.to(torch.float32).cpu().numpy()
          for m in mats(torch, cohorts[2], dev)]
    torch.cuda.empty_cache()
    for f, m in zip(("data", "correlation", "network"), t2):
        kw32[f]["test2"] = m
    serve_memory(torch, np, kw32, labels, card)
    fleet_memory(torch, np, kw32, labels, card)
    del kw32, t2
    genome_scale(torch, np, card, strict=False)
    print(card_line(), flush=True)
    return 0


def large_modules_only() -> int:
    """``--large-modules``: the main path's width (GENES genes, SAMPLES
    samples, host float64 inputs) with one module of each size in
    LARGE_MODULES, LARGE_PERM permutations, fused materialized: the call
    with the discovery on the host (its blocks gathered there) and its
    twin with the discovery handed over as float32 CUDA tensors (gathered
    on the card), LARGE_CALLS of each in the order host, card, card,
    host; each call's ``engine_s`` and peak above what the script holds,
    the results bit-equal. Then the largest module's padded block gathered
    from the float64 host matrix by the port (``gather_block``, threads
    over its rows), by torch's advanced indexing on the host, and from
    the narrowed matrix on the card, five times each, bit-equal."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from netrep_tpu_torch.models import dataset as tds
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.ops import _build
    from netrep_tpu_torch.utils.config import EngineConfig

    dev = torch.device("cuda")
    card = card_line()
    _build.build(list(_build.SOURCES))
    _sizes, _labels, cohorts = make_cohorts(np)
    host = [[m.cpu().numpy() for m in mats(torch, x, dev)]
            for x in cohorts[:2]]
    torch.cuda.empty_cache()
    order = np.random.default_rng(SEED).permutation(GENES)
    labels = np.full(GENES, "0", dtype=object)
    at = 0
    for k, size in enumerate(LARGE_MODULES):
        labels[order[at: at + size]] = str(k + 1)
        at += size
    names = ("disc", "test")
    kw = dict(network={k: h[2] for k, h in zip(names, host)},
              data={k: h[0] for k, h in zip(names, host)},
              correlation={k: h[1] for k, h in zip(names, host)},
              module_assignments=list(labels), discovery="disc",
              test="test", n_perm=LARGE_PERM, seed=SEED, device="cuda",
              config=EngineConfig())
    on_card = {f: dict(kw[f], disc=torch.as_tensor(
        kw[f]["disc"], device=dev, dtype=torch.float32))
        for f in ("network", "data", "correlation")}
    runs = {"host": [], "card": []}
    for where in ("host", "card", "card", "host") * (LARGE_CALLS // 2):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = module_preservation(**{**kw, **(on_card if where == "card"
                                              else {})})
        wall = time.perf_counter() - t0
        runs[where].append((res, {
            "wall_s": wall, "engine_s": res.profile["engine_s"],
            "input_s": res.profile["input_s"],
            "null_s": res.profile["null_s"],
            "peak_above_gib": (torch.cuda.max_memory_allocated() - base)
            / 2**30}))
    ref = runs["host"][0][0]
    for where, got in runs.items():
        for res, _ in got:
            if not (np.array_equal(res.observed, ref.observed)
                    and np.array_equal(res.p_values, ref.p_values)
                    and np.array_equal(res.nulls, ref.nulls,
                                       equal_nan=True)):
                raise RuntimeError(f"large_modules: a {where} call differs "
                                   "from the first host call")
    # the largest module's padded block, three ways
    cap = EngineConfig().rounded_cap(LARGE_MODULES[-1])
    idx = np.sort(order[at - LARGE_MODULES[-1]: at])
    idx = np.concatenate([idx, np.full(cap - idx.size, idx[0])])[None]
    src = kw["correlation"]["disc"]
    narrowed = on_card["correlation"]["disc"]
    t_src, i_host = torch.from_numpy(src), torch.as_tensor(idx)
    i_card = i_host.to(dev)
    ways = {
        "port_host": lambda: tds.gather_block(src, idx, dev),
        "torch_index_host": lambda: t_src[
            i_host[..., :, None], i_host[..., None, :]].to(
            torch.float32).to(dev),
        "card": lambda: narrowed[i_card[..., :, None],
                                 i_card[..., None, :]],
    }
    times, blocks = {}, {}
    for name, fn in ways.items():
        times[name] = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blocks[name] = fn()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    if not all(torch.equal(b.view(torch.int32),
                           blocks["card"].view(torch.int32))
               for b in blocks.values()):
        raise RuntimeError("large_modules: the gathered blocks differ")
    emit({"phase": "large_modules", "genes": GENES, "samples": SAMPLES,
          "modules": list(LARGE_MODULES), "n_perm": LARGE_PERM,
          "bit_equal": True,
          "calls": {w: [r for _, r in got] for w, got in runs.items()},
          "engine_s_median": {w: float(np.median([r["engine_s"]
                                                  for _, r in got]))
                              for w, got in runs.items()},
          "block": {"cap": cap, "seconds": times,
                    "median_s": {k: float(np.median(v))
                                 for k, v in times.items()}},
          "gather_threads": tds._GATHER_THREADS, "card": card})
    print(card_line(), flush=True)
    return 0


def main() -> int:
    global FLEET_FIXTURE
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.ops import _build
    from netrep_tpu_torch.ops import fused_gather as fg
    from netrep_tpu_torch.ops import fused_stats as fs
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.ops import stats as tstats
    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.utils import costmodel
    from netrep_tpu_torch.utils.config import EngineConfig

    dev = torch.device("cuda")
    card = card_line()
    cfg = EngineConfig()

    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- build every kernel source of the paths, all nvcc runs at once ---
    t0 = time.perf_counter()
    sources = list(_build.SOURCES)
    _build.build(sources)
    fs._lib()
    fg._lib()
    fs._ring_lib()
    built = {}
    for name in sources:
        info = _build.BUILD_INFO[name]
        built[name] = {
            "source": f"netrep_tpu_torch/csrc/{name}.cu",
            "nvcc_s": info["seconds"], "lib": info["lib"].rsplit("/", 1)[-1],
            "registers": [int(r) for r in
                          re.findall(r"Used (\d+) registers", info["ptxas"])],
            "spill_bytes": [int(x) for x in re.findall(
                r"(\d+) bytes spill stores", info["ptxas"])],
        }
    emit({"phase": "build", "total_s": time.perf_counter() - t0,
          "sources": built})

    # ---- the fresh processes, side by side ------------------------------
    # first, while this process holds little host memory, and each beside
    # the others: the installed port's child on the main path's cohorts
    # (held to main_path below), the start-up drills and the daemon fleet
    # from two threads (its results are held to the in-process fleet's
    # after the fleet phase), and the two-process runs from this thread
    # (their references need this process's card)
    from concurrent.futures import ThreadPoolExecutor

    sizes, labels, (xd, xt, x2) = make_cohorts(np)
    # the invariant linter over the checkout's port (checked before the
    # main path)
    lint = lint_start()
    installed = installed_start(np, xd, xt, labels)
    FLEET_FIXTURE = dict(FLEET_FIXTURE, genes=WHOLE_FIXTURE_GENES)
    with ThreadPoolExecutor(2) as pool:
        started = pool.submit(startup_phase, card, first_launch=False)
        daemon = pool.submit(fleet_daemon_phase, torch, np, card)
        mp_used = multi_process_phase(torch, np, module_preservation, card,
                                      dev)
        started.result()
        daemon_got = daemon.result()
    cli_phase(np, card)

    # ---- inputs at the north-star width, from one seed -------------------
    t0 = time.perf_counter()
    (dd, dc, dn), (td, tc, tn) = mats(torch, xd, dev), mats(torch, xt, dev)
    torch.cuda.synchronize()
    emit({"phase": "inputs", "genes": GENES, "samples": SAMPLES,
          "modules": MODULES, "module_sizes": [int(v) for v in sizes],
          "seconds": time.perf_counter() - t0})

    # ---- the kernels against their plain versions, at the path's shapes --
    engine, chunk, obs = first_chunk(torch, np, labels, (dd, dc, dn),
                                     (td, tc, tn), cfg, dev)
    tc32, tn32, tdT = engine._test_corr, engine._test_net, engine._test_dataT

    def run(values_or_counts, impl, batch):
        outs = []
        for (b, idx), ob in zip(chunk, obs):
            ix = idx[:batch].contiguous()
            if values_or_counts == "values":
                fn = fs.fused_stats_values if impl == "kernel" \
                    else fs.fused_stats_values_plain
                outs.append(fn(tc32, tn32, tdT, b.disc, ix,
                               n_iter=cfg.power_iters))
            else:
                fn = fs.fused_stats_counts if impl == "kernel" \
                    else fs.fused_stats_counts_plain
                pvalid = torch.ones(ix.shape[0], dtype=torch.int32,
                                    device=dev)
                pvalid[-3:] = 0
                outs.append(fn(tc32, tn32, tdT, b.disc, ix, pvalid, ob,
                               n_iter=cfg.power_iters))
        return outs

    max_err = {"fused_stats_values": 0.0, "fused_stats_counts": 0.0}
    checked = 0
    for batch in (8, cfg.chunk_size):
        for mode in ("values", "counts"):
            got, want = run(mode, "kernel", batch), run(mode, "plain", batch)
            torch.cuda.synchronize()
            for (b, _), g, w, ob in zip(chunk, got, want, obs):
                gv = g if mode == "values" else g[0]
                wv = w if mode == "values" else w[0]
                if not torch.equal(torch.isnan(gv), torch.isnan(wv)):
                    raise RuntimeError(f"{mode}: NaN pattern differs "
                                       f"(cap {b.cap})")
                err = torch.nan_to_num((gv - wv).abs(), nan=0.0).max().item()
                name = f"fused_stats_{mode}"
                max_err[name] = max(max_err[name], err)
                if mode == "counts":
                    pvalid = np.ones(batch, bool)
                    pvalid[-3:] = False
                    vals = gv.cpu().numpy()[pvalid]
                    for t, want_t in zip(g[1:], pv.tail_counts(
                            ob.cpu().numpy(), vals)):
                        if not np.array_equal(t.cpu().numpy(), want_t):
                            raise RuntimeError("kernel tallies differ from "
                                               "the tail counts of its "
                                               "own values")
                checked += 1
    if max(max_err.values()) > TOL:
        raise RuntimeError(f"kernel disagrees with plain: {max_err}")
    emit({"phase": "kernel_vs_plain", "tolerance": TOL, "max_abs_err": max_err,
          "batches": [8, cfg.chunk_size], "launches_checked": checked,
          "counts_equal_tail_counts": True})

    # ---- times at the main path's shapes (one chunk: every bucket) -------
    # the bound by the cost model's count; the sector floor beside it
    sector_bytes, flops_kernel, per_bucket = fused_work(fs, costmodel, engine,
                                                        chunk, cfg)
    model = {mode: fused_bound(costmodel, engine, mode == "counts")
             for mode in ("values", "counts")}
    sector_ms = 1e3 * sector_bytes / HBM_BPS

    timed = make_timer(torch)

    def interleaved(plain, kernel):
        """plain, kernel, kernel, plain: drift on the card hits both
        alike."""
        p1, k1 = timed(plain), timed(kernel)
        k2, p2 = timed(kernel), timed(plain)
        return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}

    times = {}
    for mode in ("values", "counts"):
        times[f"fused_stats_{mode}"] = interleaved(
            lambda: run(mode, "plain", cfg.chunk_size),
            lambda: run(mode, "kernel", cfg.chunk_size))
    split_rows, _ = kernel_split(fs, engine, chunk, cfg.power_iters, timed,
                                 card)
    for b_info, row in zip(per_bucket, split_rows):
        b_info["ms"] = row["full_ms"]
    emit({"phase": "kernel_times", "unit": "one chunk of "
          f"{cfg.chunk_size} permutations x {MODULES} modules "
          f"({len(chunk)} launches, one per bucket)",
          "launches_per_chunk": len(chunk), "model": model,
          "peaks": {"flops": F32_FLOPS, "bytes_per_s": HBM_BPS},
          "sector_floor_bytes": sector_bytes, "sector_floor_ms": sector_ms,
          "kernel_flops": flops_kernel,
          "kernel_ops_ms": 1e3 * flops_kernel / F32_FLOPS,
          "times_ms": times, "per_bucket": per_bucket,
          "library_ms": None,
          "library_note": "no single PyTorch call computes the seven "
                          "preservation statistics",
          "card": card})
    # ---- fused statistics on test matrices asymmetric up to the datasets'
    # tolerance, in the cached tier and the whole-row tier
    asym_err = asymmetry(torch, np, fs, tstats, engine, chunk, obs,
                         (dd, dc, dn), cfg, dev, card)

    # ---- the gather kernel against its plain version, at the path's shapes
    # (the composed path's chunk: every bucket in one launch, batches 8 and
    # 128, on the test correlation), sentinels, a NaN, a hot row, row
    # blocks into NaN buffers and a row block wider than shared memory
    g_err, checked = 0.0, 0
    for batch in (8, cfg.chunk_size):
        e, c = gather_vs_plain(torch, fg, chunk, tc32, dev, batch)
        g_err, checked = max(g_err, e), checked + c
    emit({"phase": "gather_vs_plain", "bit_equal": True,
          "batches": [8, cfg.chunk_size], "outputs_checked": checked,
          "stage_div": [fg.STAGE_DIV, 0, 1 << 20], "row_blocks": 4,
          "out_buffers_start_as": "nan", "hot_row": True,
          "wide_block": [64, 60_000], "max_abs_err": g_err})

    # ---- gather times: one chunk, every bucket, one matrix ---------------
    rows_per = GENES // 4
    idx_list = [idx for _, idx in chunk]
    long_idx = [idx.long() for idx in idx_list]
    blocks = [(r0, tc32[r0: r0 + rows_per]) for r0 in range(0, GENES, rows_per)]
    outs = [torch.empty(i.shape + i.shape[-1:], device=dev) for i in idx_list]

    def row_blocks(fn):
        def run():
            for r0, blk in blocks:
                fn(blk, idx_list, r0, out=outs)
        return run

    g_times = {
        "gather_submatrix_fused_many": interleaved(
            lambda: fg.gather_submatrix_fused_many_plain(tc32, idx_list),
            lambda: fg.gather_submatrix_fused_many(tc32, idx_list)),
        "gather_submatrix_fused_many(out=)": interleaved(
            row_blocks(fg.gather_submatrix_fused_many_plain),
            row_blocks(fg.gather_submatrix_fused_many)),
    }
    g_times["gather_submatrix_fused_many"]["library_ms"] = timed(
        lambda: [tc32[i[..., :, None], i[..., None, :]] for i in long_idx])
    g_times["gather_submatrix_fused_many(out=)"]["library_ms"] = None
    g_times["gather_submatrix_fused_many"]["one_bucket_per_launch_ms"] = \
        timed(lambda: [fg.gather_submatrix_fused(tc32, i) for i in idx_list])
    for name, nb in (("gather_submatrix_fused_many", 1),
                     ("gather_submatrix_fused_many(out=)", 4)):
        t = g_times[name]
        t.update(gather_bound(torch, chunk, GENES, nb))
        t["bound_ms"] = 1e3 * t["bytes"] / HBM_BPS
        t["sector_floor_ms"] = 1e3 * t["sector_floor_bytes"] / HBM_BPS
        t["launches_per_chunk"] = nb
    g_ring = gather_times(torch, fg, fs, chunk, tc32, timed, dev)
    emit({"phase": "gather_times", "unit": "one chunk of "
          f"{cfg.chunk_size} permutations x {MODULES} modules, one matrix "
          f"({len(chunk)} buckets in one launch; out=: one launch per row "
          f"block of {rows_per}, written in place)",
          "times_ms": g_times, "bound_by": "bytes", "ring": g_ring,
          "crossover": gather_crossover(torch, fg, chunk, tc32, timed),
          "library_call": "M[idx[..., :, None], idx[..., None, :]] per "
                          "bucket (in-range indices)",
          "library_note": "no single PyTorch call writes only the rows a "
                          "block owns, so the out= entry has none",
          "card": card})
    del outs, long_idx, blocks
    # ---- the ring-shift kernel against its plain version, on the row-
    # sharded path's own blocks: both test matrices split into R = 4 blocks
    # of 5,000 rows, every step of the ring, bit for bit; then a block whose
    # element count is not a multiple of 4 (the tail of the vector loop) and
    # an unaligned one (the scalar loop)
    R = 4
    rows_per = GENES // R
    r_checked, ring_err = 0, 0.0
    for M in (tc32, tn32):
        ring = [M[r0: r0 + rows_per] for r0 in range(0, GENES, rows_per)]
        for _step in range(R - 1):
            got = fs.ring_shift_dma(ring)
            want = fs.ring_shift_collective(ring)
            for g, w in zip(got, want):
                ring_err = max(ring_err, abs_err(torch, g, w))
                if not same(torch, g, w) or g.data_ptr() == w.data_ptr():
                    raise RuntimeError("ring shift kernel != plain")
                r_checked += 1
            ring = got
    gen = torch.Generator(device=dev).manual_seed(SEED)
    odd = [torch.randn((4999, 20001), device=dev, generator=gen)
           for _ in range(2)]
    flat = torch.randn(4999 * 20001 + 1, device=dev, generator=gen)
    unaligned = [flat[1:].view(4999, 20001), odd[0]]
    for ring in (odd, unaligned):
        got = fs.ring_shift_dma(ring)
        for g, w in zip(got, fs.ring_shift_collective(ring)):
            ring_err = max(ring_err, abs_err(torch, g, w))
            if not same(torch, g, w):
                raise RuntimeError("ring shift kernel != plain (odd block)")
            r_checked += 1
    torch.cuda.synchronize()
    # the loop variables still hold tn32 (1.6 GB) and two 400 MB blocks
    del odd, flat, unaligned, ring, got, want, M, g, w
    emit({"phase": "ring_vs_plain", "bit_equal": True,
          "launches_checked": r_checked, "blocks": [rows_per, GENES],
          "odd_block": [4999, 20001], "unaligned_block_checked": True,
          "max_abs_err": ring_err})

    # ---- ring times: one step of the ring (R launches, one per block) ----
    r_times = ring_times(torch, fs, tc32, timed, card)
    # ---- the bfloat16 instantiations: vs plain, times beside float32 ----
    bf16_k = bf16_kernels(
        torch, np, fs, fg, pv, engine, chunk, obs, cfg, timed,
        {**{k: v["ms"] for k, v in times.items()},
         **{k: v["ms"] for k, v in g_times.items()},
         "ring_shift_dma": r_times["ms"]}, card, dev)
    del engine, chunk, obs, tc32, tn32, tdT, idx_list
    torch.cuda.empty_cache()
    lint_check(card, lint)

    # ---- the main path, through the public entry point -------------------
    # a user hands over host arrays: the copy to the card is part of the call
    t0 = time.perf_counter()
    (dd, dc, dn), (td, tc, tn) = [
        [m.cpu().numpy() for m in ms] for ms in ((dd, dc, dn), (td, tc, tn))
    ]
    torch.cuda.empty_cache()
    emit({"phase": "host_inputs", "dtype": str(dc.dtype),
          "bytes": sum(m.nbytes for m in (dd, dc, dn, td, tc, tn)),
          "seconds": time.perf_counter() - t0})
    # ---- the input phase alone: seconds, peak, checksums; host routes ---
    input_phase(torch, np, {"disc": (dd, dc, dn), "test": (td, tc, tn)},
                card)
    host_copies(torch, np, tc, card)
    kw = dict(
        network={"disc": dn, "test": tn},
        data={"disc": dd, "test": td},
        correlation={"disc": dc, "test": tc},
        module_assignments=list(labels), discovery="disc", test="test",
        n_perm=N_PERM, seed=SEED, device="cuda",
    )

    drive = make_drive(torch, np, tops, module_preservation, kw, card)

    def tallies_equal(a, b):
        check_tallies(np, pv, a, b)

    def null_err(a, b):
        return nulls_err(np, a, b)

    runs, launches, memory = {}, {}, {}
    for store in (True, False):
        on_card, undo = spy_datasets(torch)
        try:
            res, launches[store], memory[store] = drive(
                "main_path", ["fused_stats_values" if store
                              else "fused_stats_counts"],
                config=cfg, store_nulls=store)
        finally:
            undo()
        runs[store] = res
        # the discovery dataset is checked on the card but keeps its host
        # source: no n×n of it lands there
        if on_card["disc"] or not on_card["test"]:
            raise RuntimeError(f"main_path: bytes on the card after the "
                               f"input phase {on_card}")
        emit({"phase": "input_checks", "store_nulls": store,
              "seconds": res.profile["input_s"],
              "card_gib_after_input": {n: b / 2**30
                                       for n, b in on_card.items()},
              "peak_gib": memory[store]["peak_gib"]})
    a, b = runs[True], runs[False]
    if not np.array_equal(a.p_values, b.p_values):
        raise RuntimeError("materialized and streaming p-values differ")
    tallies_equal(a, b)
    preserved = (a.p_values.max(axis=1) < 0.05 / MODULES)
    emit({"phase": "main_path_check", "p_values_equal": True,
          "tallies_equal_tail_counts": True,
          "min_p": float(a.p_values.min()),
          "modules_preserved": int(preserved.sum()),
          "planted_preserved": MODULES // 2})
    fused_run = a
    # ---- the discovery props from the host source and from the card -----
    discovery_props(torch, np, kw, labels, dev, card)
    # ---- the same call from the installed wheel in a fresh process -------
    launches[("installed",)] = installed_check(
        np, installed, fused_run, kw, launches[True], card)["child"][
            "launches"]
    # ---- the native C++ host tier on the same inputs and seed -----------
    native_phase(np, module_preservation, kw, fused_run, card)
    # ---- the autotune store: superchunk, tile edge and super-tile sweeps -
    autotune_phase(torch, np, tops, module_preservation, kw, card,
                   full=False)
    #: the float32 run and memory of each call the bf16 phase repeats
    f32_ref = {"main/materialized": (a, memory[True]),
               "main/streaming": (b, memory[False])}

    # ---- composed statistics through the gather kernel: one launch per
    # chunk and matrix, every bucket in it
    composed_cfg = EngineConfig(stat_mode="xla", gather_mode="fused")
    chunks = -(-N_PERM // cfg.chunk_size)
    many, R = "gather_submatrix_fused_many", 4
    single = {"gather_submatrix_fused": 0, "gather_submatrix_fused_local": 0}
    comp = {}
    for store in (True, False):
        comp[store], launches[("composed", store)], memory[
            ("composed", store)] = drive(
            "composed_path", [many], {many: chunks * 2, **single},
            config=composed_cfg, store_nulls=store)
        used = launches[("composed", store)]
        if used["fused_stats_values"] or used["fused_stats_counts"]:
            raise RuntimeError("the composed path launched the "
                               "fused-statistics kernel")
    for store in (True, False):
        f32_ref[f"composed/{'materialized' if store else 'streaming'}"] = (
            comp[store], memory[("composed", store)])
    if not np.array_equal(comp[True].p_values, comp[False].p_values):
        raise RuntimeError("composed path: materialized and streaming "
                           "p-values differ")
    tallies_equal(comp[True], comp[False])
    comp_err = null_err(comp[True].nulls, fused_run.nulls)
    if comp_err > TOL:
        raise RuntimeError(f"composed null differs from the fused-statistics "
                           f"null by {comp_err}")
    emit({"phase": "composed_path_check", "p_values_equal": True,
          "tallies_equal_tail_counts": True,
          "max_abs_null_vs_fused": comp_err, "tolerance": TOL,
          "p_values_equal_fused": bool(np.array_equal(
              comp[True].p_values, fused_run.p_values))})
    # ---- the cost model on the card: each family's utilisation ----------
    launches.update(roofline_phase(np, drive, cfg, composed_cfg, card))
    # ---- the flight recorder's cost on the main path: on, off, off, on
    flightrec_ab_phase(np, drive, cfg, composed_cfg, card)
    # ---- the self-test against the float64 oracle, both shapes ----------
    selftest_phase(card)

    # ---- derived network: no test network stored, through the
    # fused-statistics kernel's derived mode and through the composed null
    der = {}
    for mode, kernel, n_many in (("auto", "fused_stats_values", 0),
                                 ("xla", many, chunks)):
        der[mode], launches[("derived", mode)], memory[mode] = drive(
            "derived_network", [kernel], {many: n_many, **single},
            config=EngineConfig(network_from_correlation=BETA,
                                stat_mode=mode))
    f32_ref["derived/fused"] = (der["auto"], memory["auto"])
    f32_ref["derived/composed"] = (der["xla"], memory["xla"])
    der_err = {mode: null_err(r.nulls, fused_run.nulls)
               for mode, r in der.items()}
    if max(der_err.values()) > TOL:
        raise RuntimeError(f"derived-network null differs from the stored-"
                           f"network null by {der_err}")
    emit({"phase": "derived_network_check", "network_from_correlation": BETA,
          "max_abs_null_vs_stored": der_err, "tolerance": TOL,
          "p_values_equal_stored": {
              mode: bool(np.array_equal(r.p_values, fused_run.p_values))
              for mode, r in der.items()},
          "memory": {"stored": memory[True], "derived": memory["auto"],
                     "derived_composed": memory["xla"]}})

    # ---- the row-sharded null on four row shards of the one card: the
    # ring path (materialized, streaming, derived network) and the psum
    # path (streaming); and the perm mesh over replicated matrices
    def mesh_checks(phase, res, store, same_kernel=False):
        """p-values equal to main_path's; a materialized null within TOL of
        its null; streaming tallies equal to its streaming run's where the
        same kernel computed them."""
        if not np.array_equal(res.p_values, fused_run.p_values):
            raise RuntimeError(f"{phase}: p-values differ from main_path's")
        err = None
        if store:
            err = null_err(res.nulls, fused_run.nulls)
            if err > TOL:
                raise RuntimeError(f"{phase}: null differs from main_path's "
                                   f"by {err}")
        elif same_kernel:
            stream_ref = runs[False]
            if not all(np.array_equal(getattr(res, f),
                                      getattr(stream_ref, f))
                       for f in ("counts_hi", "counts_lo", "counts_eff")):
                raise RuntimeError(f"{phase}: tallies differ from "
                                   "main_path's streaming run")
        return err

    row_mesh = make_mesh(1, R, devices=[dev] * R)
    ring_cfg = EngineConfig(matrix_sharding="row")
    row_runs = {}
    #: the row-sharded paths' runs, launches and calls, held below to the
    #: same call with the discovery dataset on the card (the unsplit
    #: paths' discovery buckets are held bit for bit by discovery_props)
    twins = {}

    def row_expect(mats, ring):
        return row_launches(chunks, R, mats, ring)

    for label, store, config, needs, expect in (
            ("ring", True, ring_cfg, ["ring_shift_dma", many],
             row_expect(2, True)),
            ("ring", False, ring_cfg, ["ring_shift_dma", many],
             row_expect(2, True)),
            ("psum", False, EngineConfig(matrix_sharding="row",
                                         stat_mode="xla"), [many],
             row_expect(2, False)),
            ("ring_derived", True, EngineConfig(
                matrix_sharding="row", network_from_correlation=BETA),
             ["ring_shift_dma", many], row_expect(1, True))):
        res, used, mem = drive("row_sharded", needs, expect, config=config,
                               store_nulls=store, mesh=row_mesh)
        if used["fused_stats_values"] or used["fused_stats_counts"]:
            raise RuntimeError("the row-sharded path launched the "
                               "fused-statistics kernel")
        row_runs[(label, store)] = (used, mem,
                                    mesh_checks(label, res, store))
        launches[("row", label, store)] = used
        twins[f"row_{label}/{'materialized' if store else 'streaming'}"] = (
            res, used, dict(config=config, store_nulls=store, mesh=row_mesh))
        f32_ref[f"{label}/{'materialized' if store else 'streaming'}"] = (
            res, mem)
    emit({"phase": "row_sharded_check", "mesh": row_mesh.shape,
          "p_values_equal_main": True, "tolerance": TOL,
          "max_abs_null_vs_main": {f"{k[0]}/{'mat' if k[1] else 'stream'}":
                                   v[2] for k, v in row_runs.items()},
          "ring_shift_launches": {f"{k[0]}/{'mat' if k[1] else 'stream'}":
                                  v[0]["ring_shift_dma"]
                                  for k, v in row_runs.items()},
          "gather_launches": {f"{k[0]}/{'mat' if k[1] else 'stream'}":
                              v[0][many] for k, v in row_runs.items()}})
    ring_engine = make_engine(np, labels, (dd, dc, dn), (td, tc, tn),
                              ring_cfg, dev, mesh=row_mesh)
    ring_trace(torch, np, ring_engine, card, "per_chunk")
    del ring_engine
    torch.cuda.empty_cache()
    perm_mesh = make_mesh(2, 1, devices=[dev] * 2)
    res, used, mem = drive("perm_mesh", ["fused_stats_counts"], config=cfg,
                           store_nulls=False, mesh=perm_mesh)
    mesh_checks("perm_mesh", res, False, same_kernel=True)
    f32_ref["perm_mesh/streaming"] = (res, mem)
    emit({"phase": "perm_mesh_check", "mesh": perm_mesh.shape,
          "p_values_equal_main": True, "tallies_equal_main": True})
    # ---- the row-sharded paths again with the discovery on the card -----
    discovery_twins(torch, np, tops, module_preservation, kw, twins, card)
    del twins
    if torch.cuda.device_count() >= 2:
        two = make_mesh(1, 2, devices=[torch.device("cuda", 0),
                                       torch.device("cuda", 1)])
        res, used, _ = drive(
            "multi_card", ["ring_shift_dma", many], config=ring_cfg,
            mesh=two)
        err = mesh_checks("multi_card", res, True)
        emit({"phase": "multi_card", "run": True,
              "cards": torch.cuda.device_count(), "mesh": two.shape,
              "p_values_equal_main": True, "max_abs_null_vs_main": err})
    else:
        emit({"phase": "multi_card", "run": False,
              "cards": torch.cuda.device_count()})

    # ---- the adaptive null at the north star's depth ---------------------
    (adaptive_run, launches_ad, rebucket_err,
     composed_adaptive) = adaptive_phase(
        torch, np, fs, fg, pv, drive, cfg, composed_cfg, labels, fused_run,
        comp[True], (dd, dc, dn), (td, tc, tn), card, dev)
    launches.update(launches_ad)
    # ---- interrupted and resumed runs ------------------------------------
    launches.update(checkpoint_phase(
        np, pv, drive, cfg, ring_cfg, row_mesh, many, fused_run, runs[False],
        adaptive_run, card))
    # ---- the fault ladder: every rung at the main path's width -----------
    launches.update({("faults", k): used for k, used in fault_ladder_phase(
        torch, np, drive, labels, (dd, dc, dn), (td, tc, tn),
        {"fused": fused_run, "stream": runs[False],
         "composed_stream": comp[False]}, card, dev).items()})

    # ---- two test cohorts on one shared permutation draw -----------------
    # the second cohort is built in float32 on the host to spare host
    # memory (float64 would be 6.4 GB more)
    t0 = time.perf_counter()
    t2d, t2c, t2n = [m.to(torch.float32).cpu().numpy()
                     for m in mats(torch, x2, dev)]
    torch.cuda.empty_cache()
    emit({"phase": "second_cohort", "dtype": str(t2c.dtype),
          "seconds": time.perf_counter() - t0})
    kw["network"] = dict(kw["network"], test2=t2n)
    kw["data"] = dict(kw["data"], test2=t2d)
    kw["correlation"] = dict(kw["correlation"], test2=t2c)
    kw["test"] = ["test", "test2"]
    multi = {}
    multi[True], launches[("multi", True)], mem = drive(
        "multi_test", ["fused_stats_values"], config=cfg, vmap_tests=True)
    f32_ref["multi_test/materialized"] = (multi[True], mem)
    multi_mem = mem
    multi[False], launches[("multi", False)], _ = drive(
        "multi_test", [many], {many: chunks * 2 * 2, **single},
        config=composed_cfg, vmap_tests=True, store_nulls=False)
    # cohort 1 is the main path's test set: the shared draw gives it the
    # single-test run's permutations, kernel and operands
    if not np.array_equal(multi[True]["test"].p_values, fused_run.p_values):
        raise RuntimeError("multi-test cohort 1 p-values differ from the "
                           "single-test fused run's")
    if not np.array_equal(multi[False]["test"].p_values,
                          comp[False].p_values):
        raise RuntimeError("multi-test streaming cohort 1 p-values differ "
                           "from the single-test composed run's")
    emit({"phase": "multi_test_check", "cohorts": 2,
          "cohort1_p_equal_single_fused": True,
          "cohort1_p_equal_single_composed": True,
          "cohort2_min_p": float(multi[True]["test2"].p_values.min()),
          "cohort2_modules_preserved": int(
              (multi[True]["test2"].p_values.max(axis=1)
               < 0.05 / MODULES).sum())})
    # ---- the two cohorts on meshes of the card, held to the runs above --
    launches.update({("multi_mesh", k): used for k, used in
                     multi_test_mesh_phase(
                         np, pv, drive, cfg, composed_cfg, multi, multi_mem,
                         launches, chunks, card, dev,
                         twin=lambda paths: discovery_twins(
                             torch, np, tops, module_preservation, kw, paths,
                             card)).items()})
    # ---- the same two cohorts one pair after another -------------------
    seq = sequential_tests(torch, np, module_preservation, tops, kw, cfg,
                           card, dev)
    if not np.array_equal(seq["test"].p_values, fused_run.p_values):
        raise RuntimeError("sequential_tests: test p-values differ from "
                           "main_path's")
    if not np.array_equal(seq["test2"].p_values,
                          multi[True]["test2"].p_values):
        raise RuntimeError("sequential_tests: test2 p-values differ from "
                           "multi_test's cohort 2")
    emit({"phase": "sequential_tests_check",
          "test_p_equal_main_path": True,
          "test2_p_equal_multi_test_cohort2": True})
    # ---- bfloat16 storage along the same paths ---------------------------
    # single-test calls hand over the two datasets they test, as the
    # float32 calls did before the second cohort joined ``kw``
    one_test = {k: {n: v for n, v in kw[k].items() if n != "test2"}
                for k in ("network", "data", "correlation")}
    bf16_runs = bf16_phase(np, pv, drive, storage_paths(
        cfg, "bfloat16", row_mesh, perm_mesh, chunks), f32_ref, card,
        one_test)
    launches.update({("bf16", k): used for k, (_r, used) in
                     bf16_runs.items()})
    del bf16_runs
    # ---- the screened null against the float32 composed null -------------
    launches.update({("screened", k): used for k, used in screened_phase(
        np, pv, lambda *a, **c: drive(*a, test="test", **one_test, **c),
        comp, composed_adaptive, fused_run, perm_mesh, many, card).items()})
    # ---- the exported surface: properties, combined runs, round trip ----
    surface(torch, np, kw, labels, card)
    # ---- the all-pairs grid: the three cohorts, six cells ---------------
    launches.update(grid_phase(torch, np, tops, kw, labels, card, dev))
    # ---- the single server: packs, warm pool, recovery, the daemon ------
    launches.update(serve_phase(torch, np, tops, kw, labels, card, dev))
    # ---- the fleet: grid and routing, failover, autoscaling, eviction ---
    results_b = {}
    launches.update(fleet_phase(torch, np, tops, kw, labels, card, dev,
                                results_b))
    daemon_results_check(np, daemon_got, results_b, card)
    # ---- the forensic chain: the dump op's bundle, a refused checkpoint -
    forensics_phase(np, module_preservation, card)
    # ---- two processes on the card over gloo (run at the start) ---------
    launches.update(mp_used)
    del kw, runs, a, b, comp, der, multi, fused_run, res, seq, f32_ref
    del composed_adaptive
    del dd, dc, dn, td, tc, tn, t2d, t2c, t2n
    torch.cuda.empty_cache()

    # ---- 1,000-sample cohorts: every shape the JAX package computes ------
    wide_samples(torch, np, fs, tops, module_preservation, cfg, card, dev)
    torch.cuda.empty_cache()

    # ---- two 50,000-gene datasets from host float32 arrays ---------------
    genome_scale(torch, np, card)

    # ---- Config E (sparse) and the atlas shape (data-only) ---------------
    pr9 = {f"sparse {k}": v for k, v in sparse_phase(torch, np, card).items()}
    pr9.update({f"data_only {k}": v
                for k, v in data_only_phase(torch, np, card).items()})
    # ---- the atlas tile network builder, into the sparse engine ----------
    pr9.update({f"atlas_build {k}": v
                for k, v in atlas_build_phase(torch, np, card).items()})


    # ---- a small reference: the same call on the card and on the CPU -----
    from netrep_tpu_torch.data import make_example_pair, pair_frames

    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    small = dict(network={"d": d["network"], "t": t["network"]},
                 data={"d": d["data"], "t": t["data"]},
                 correlation={"d": d["correlation"], "t": t["correlation"]},
                 module_assignments=pair["labels"], n_perm=400, seed=4)
    vs_cpu = {}
    for label, config in (
            ("fused", None),
            ("composed_eigh", EngineConfig(stat_mode="xla",
                                           summary_method="eigh"))):
        on_card = module_preservation(**small, config=config)
        on_cpu = module_preservation(**small, config=config, device="cpu")
        obs_err = float(np.abs(on_card.observed - on_cpu.observed).max())
        n_err = float(np.nanmax(np.abs(on_card.nulls - on_cpu.nulls)))
        if obs_err > TOL or n_err > TOL or not np.array_equal(
                on_card.p_values, on_cpu.p_values):
            raise RuntimeError(f"card and CPU disagree on the example "
                               f"fixture ({label}): observed {obs_err}, null "
                               f"{n_err}")
        vs_cpu[label] = {"max_abs_observed": obs_err, "max_abs_null": n_err,
                         "p_values_equal": True}
    emit({"phase": "example_vs_cpu", "runs": vs_cpu, "tolerance": TOL})

    stats_src = "netrep_tpu_torch/csrc/fused_stats.cu"
    gather_src = "netrep_tpu_torch/csrc/fused_gather.cu"
    ring_used = launches[("row", "ring", True)]
    rows = [
        {"name": name, "route": "cuda", "source": stats_src,
         "replaces": f"netrep_tpu/ops/fused_stats.py:{line}",
         "launches": launches[store][name], "max_abs_err": max_err[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": model[name.split("_")[-1]]["bound_ms"],
         "bound_by": model[name.split("_")[-1]]["bound_by"],
         "sector_floor_ms": sector_ms, "library_ms": None,
         "path": f"main_path store_nulls={store}"}
        for name, line, store in (("fused_stats_values", 345, True),
                                  ("fused_stats_counts", 363, False))
    ]
    rows += [
        {"name": name, "route": "cuda", "source": gather_src,
         "replaces": f"netrep_tpu/ops/fused_gather.py:{line}",
         "launches": launches[path][many],
         "max_abs_err": g_err, "ms": g_times[name]["ms"],
         "plain_ms": g_times[name]["plain_ms"],
         "bound_ms": g_times[name]["bound_ms"], "bound_by": "bytes",
         "library_ms": g_times[name]["library_ms"],
         "sector_floor_ms": g_times[name]["sector_floor_ms"],
         "path": note}
        for name, line, path, note in (
            ("gather_submatrix_fused_many", 290, ("composed", True),
             "composed_path store_nulls=True"),
            ("gather_submatrix_fused_many(out=)", 319,
             ("row", "ring", True), "row_sharded ring store_nulls=True"))
    ]
    rows.append(
        {"name": "ring_shift_dma", "route": "cuda",
         "source": "netrep_tpu_torch/csrc/ring_shift.cu",
         "replaces": "netrep_tpu/ops/fused_stats.py:414",
         "launches": ring_used["ring_shift_dma"], "max_abs_err": ring_err,
         "ms": r_times["ms"], "plain_ms": r_times["plain_ms"],
         "bound_ms": r_times["bound_ms"], "bound_by": "bytes",
         "library_ms": r_times["library_ms"],
         "path": "row_sharded ring store_nulls=True"})
    # this slice's paths: launches of each kernel on each of them
    new_paths = {
        "adaptive fused materialized": ("adaptive", "fused_materialized"),
        "adaptive fused streaming": ("adaptive", "fused_streaming"),
        "adaptive composed materialized": ("adaptive",
                                           "composed_materialized"),
        "adaptive fixed streaming": ("adaptive", "fixed_streaming"),
        "adaptive fused streaming, Bonferroni rule": (
            "adaptive", "bonferroni_streaming"),
        "checkpoint fixed materialized (resumed)": (
            "checkpoint", "fixed_materialized"),
        "checkpoint fixed streaming (resumed)": ("checkpoint",
                                                 "fixed_streaming"),
        "checkpoint adaptive materialized (resumed)": (
            "checkpoint", "adaptive_materialized"),
        "checkpoint written on the ring mesh": ("checkpoint",
                                                "ring_written"),
        "checkpoint ring resumed unsplit": ("checkpoint", "ring_resumed"),
        "fault_ladder transient+hang (fused streaming)": (
            "faults", "transient_hang"),
        "fault_ladder shrink/grow (2x1 perm mesh)": ("faults",
                                                     "shrink_grow"),
        "fault_ladder CPU rung (the card's chunks)": ("faults", "cpu_rung"),
        "installed: a fresh process from the wheel": ("installed",),
        "fault_ladder composed streaming transient": (
            "faults", "composed_transient"),
        "fault_ladder profile= (fused streaming)": ("faults", "profile"),
        "grid fixed, fused (3 packs)": ("grid", "fixed_fused"),
        "grid adaptive, fused": ("grid", "adaptive_fused"),
        "grid fixed, xla": ("grid", "fixed_xla"),
        "grid adaptive, xla": ("grid", "adaptive_xla"),
        "grid changed cohort, warm-started": ("grid", "changed_cohort"),
        "grid interrupted, resumed": ("grid", "interrupted_resumed"),
        "serve A round 1 (fused; a pack of 4, two multi-test packs)": (
            "serve", "A_round1"),
        "serve A round 2 (pool hits)": ("serve", "A_round2"),
        "serve B round 1 (xla; a cross-pair pack, a pack of 2)": (
            "serve", "B_round1"),
        "serve B round 2 (pool hits)": ("serve", "B_round2"),
        "fleet grid (six cells on two replicas)": ("fleet", "grid"),
        "fleet round 2 (pool hits)": ("fleet", "round2"),
        "fleet failover, the peer's resumed pack": ("fleet",
                                                    "failover_peer"),
        "fleet eviction, the peer's resumed pack": ("fleet", "evict_peer"),
        **{f"multi_test_mesh {k}": ("multi_mesh", k) for k in (
            "perm2x1 fused materialized", "perm2x1 fused streaming",
            "perm2x1 composed materialized", "row1x4 psum streaming",
            "perm2x1 adaptive", "checkpoint written on 2x1",
            "checkpoint resumed unsplit")},
        **{f"multi_process rank {r} {m}": ("multi_process", f"rank{r}", m)
           for r in (0, 1) for m in (
               "materialized", "streaming", "sparse",
               "screened_materialized", "screened_streaming", "fault",
               "resume")},
    }
    ring_paths = {"checkpoint written on the ring mesh",
                  "multi_test_mesh row1x4 psum streaming"}
    for row in rows:
        # the gather's one counter serves both entries: the row-sharded
        # paths' launches (the ring's local part, the psum's blocks) are
        # the out= entry's, every other path's the plain one's
        name, local = row["name"].split("(")[0], "(out=)" in row["name"]
        by_path = {p: launches[k][name] for p, k in new_paths.items()
                   if launches[k][name] and (
                       name != "gather_submatrix_fused_many"
                       or (p in ring_paths) == local)}
        row["launches_by_path"] = by_path
        row["path"] += "".join(f"; {p}" for p in by_path)
        # the sparse and data-only paths run no kernel (checked as they ran)
        row["launches_sparse_data_only"] = {p: counts[name]
                                            for p, counts in pr9.items()}
    rows[0]["rebucketed_max_abs_err"] = rebucket_err["fused_stats_values"]
    rows[1]["rebucketed_max_abs_err"] = rebucket_err["fused_stats_counts"]
    rows[2]["rebucketed_bit_equal"] = True
    rows[2]["launches_screened"] = {k: launches[("screened", k)][many]
                                    for k in ("materialized", "streaming",
                                              "adaptive", "perm_mesh")}
    # each kernel again in bfloat16 storage: launches on its bf16 path
    bf16_path = {"fused_stats_values": "main/materialized",
                 "fused_stats_counts": "main/streaming",
                 "gather_submatrix_fused_many": "composed/materialized",
                 "gather_submatrix_fused_many(out=)": "ring/materialized",
                 "ring_shift_dma": "ring/materialized"}
    for row in list(rows):
        name = row["name"]
        row["dtype"] = "float32"
        k, path = bf16_k[name], bf16_path[name]
        rows.append({
            "name": f"{name}[bfloat16]", "route": "cuda",
            "source": row["source"], "replaces": row["replaces"],
            "dtype": "bfloat16",
            "launches": launches[("bf16", path)][name.split("(")[0]],
            **{f: k[f] for f in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "f32_ms", "sector_floor_ms") if f in k},
            "path": f"bf16_storage {path}"})
    emit({"phase": "total", "seconds": time.perf_counter() - T_START})
    emit({"kernels": rows})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    modes = {"--sequential-tests": sequential_only, "--kernels": kernels_only,
             "--p-values": p_values_only, "--gather": gather_only,
             "--inputs": inputs_only, "--genome-scale": genome_only,
             "--sparse": lambda: pr9_only(sparse_phase),
             "--data-only": lambda: pr9_only(data_only_phase),
             "--atlas-build": lambda: pr9_only(
                 lambda *a: atlas_build_phase(*a, headline=True)),
             "--bf16": bf16_only, "--screened": screened_only,
             "--screened-mesh": screened_mesh_only,
             "--faults": faults_only, "--grid": grid_only,
             "--serve": serve_only, "--fleet": fleet_only,
             "--tooling": tooling_only, "--startup": startup_only,
             "--native": native_only, "--autotune": autotune_only,
             "--multi-test-mesh": multi_test_mesh_only,
             "--multi-process": multi_process_only,
             "--installed": installed_only, "--memory": memory_only,
             "--large-modules": large_modules_only}
    args = sys.argv[1:]
    if len(args) > 1 or (args and args[0] not in modes):
        sys.exit(f"usage: {sys.argv[0]} [{' | '.join(modes)}]")
    load_peaks()
    fresh_autotune_store()
    sys.exit(modes[args[0]]() if args else main())
