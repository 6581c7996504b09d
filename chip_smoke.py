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

and checks each against the others: equal p-values where the same
statistics run, nulls within 1e-4 where the arithmetic differs, and every
gather and ring-step launch count equal to what the path should make. Inputs are
generated from a fixed seed (data with numpy on the host, correlation and
network on the card) and handed to the entry point as host numpy arrays, as
a user holds them, so its input phase includes the copy to the card.

Prints one JSON object per phase, then the ``{"kernels": [...]}`` summary,
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
two cohorts. Each mode runs through the ``netrep_tpu_torch`` beside the
script: copied into another checkout, it measures that checkout's version
on the same inputs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
import subprocess
import sys
import time


def emit(obj: dict) -> None:
    print(json.dumps(obj, allow_nan=False), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


GENES, SAMPLES, MODULES, SIZES = 20_000, 128, 50, (30, 200)
N_PERM, SEED, BETA = 1000, 2026, 2.0
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
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside
#: the tensor cores (the kernel does scalar f32 arithmetic)
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
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
    block_bytes = ring[0].numel() * 4
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
          f"{GENES} float32 block copied on one card", "bytes": 2 * block_bytes,
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


def same(torch, got, want):
    """Bit-equal, NaN positions compared apart."""
    nan = torch.isnan(got)
    return torch.equal(nan, torch.isnan(want)) and torch.equal(
        torch.where(nan, 0.0, got), torch.where(nan, 0.0, want))


def abs_err(torch, got, want):
    """Largest |got - want| off the NaN positions (which ``same``
    compares)."""
    nan = torch.isnan(got) | torch.isnan(want)
    return (torch.where(nan, 0.0, got)
            - torch.where(nan, 0.0, want)).abs().max().item()


def gather_bound(torch, chunk, n, blocks):
    """Bytes of one chunk's gather from one n x n matrix by the rule of
    the guide: each needed entry read once at 4 bytes (the distinct (row,
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
            "bytes": 4 * distinct + 4 * written + blocks * idx_bytes,
            "sector_floor_bytes": SECTOR * real + blocks * (4 * written
                                                            + idx_bytes)}


def gather_vs_plain(torch, fg, chunk, tc32, dev, batch):
    """The redesigned gather kernel against its plain version on the card,
    bit for bit, with sentinel slots and a NaN planted in a row the slots
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
            out = [torch.full(w.shape, float("nan"), device=dev)
                   for w in want]
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
    wide = torch.randn((64, 60_000), device=dev, generator=gen)
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
    arrays, streaming, GENOME_PERM permutations: ``input_s``, the peak of
    the input phase, the memory held during the null. Needs about 45 GB of
    host memory; where ``MemAvailable`` is short of it, prints why it did
    not run. With ``strict=False`` (a version that may not fit) an
    out-of-memory error is reported as the result instead of raised."""
    from netrep_tpu_torch import ops as tops
    from netrep_tpu_torch.models.preservation import module_preservation

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
    tops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held, before_null = [], []

    def progress(done, total):
        if not before_null:
            before_null.append(torch.cuda.max_memory_allocated())
        held.append(torch.cuda.memory_allocated())

    report = {"phase": "genome_scale", "run": True, "genes": GENOME_GENES,
              "samples": SAMPLES, "modules": MODULES, "n_perm": GENOME_PERM,
              "store_nulls": False, "input_dtype": "float32",
              "host_bytes": sum(m.nbytes for h in host.values() for m in h),
              "make_inputs_s": made_s}
    t0 = time.perf_counter()
    try:
        res = module_preservation(
            network={k: h[2] for k, h in host.items()},
            data={k: h[0] for k, h in host.items()},
            correlation={k: h[1] for k, h in host.items()},
            module_assignments=list(labels), discovery="disc", test="test",
            n_perm=GENOME_PERM, seed=SEED, store_nulls=False,
            device="cuda", progress=progress)
    except torch.cuda.OutOfMemoryError as e:
        if strict:
            raise
        emit({**report, "completed": False,
              "error": f"{type(e).__name__}: {str(e).splitlines()[0]}",
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "card": card})
        del host
        torch.cuda.empty_cache()
        return None
    wall = time.perf_counter() - t0
    del host
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
    emit({**report, "completed": True, "wall_s": wall,
          **{k: prof[k] for k in ("input_s", "engine_s", "observed_s",
                                  "null_s", "perms_per_s")},
          "input_peak_gib": before_null[0] / 2**30,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "null_held_gib": max(held) / 2**30, "launches": launches,
          "modules_preserved": int((res.p_values.max(axis=1)
                                    < 0.05 / MODULES).sum()),
          "card": card})
    torch.cuda.empty_cache()
    return res


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


def sparse_problem(np, n, k, samples, modules, sizes, plant=0.0, seed=0):
    """Config E's inputs as ``bench.py``'s ``bench_e`` draws them from
    ``default_rng(seed)``: ``k`` random neighbours per node, weights uniform
    in [0.05, 1), symmetrized by ``from_coo``; data ``samples × n``;
    ``modules`` contiguous modules of log-uniform size. ``plant`` adds a
    shared factor of that scale to each module's data (0: pure noise, as
    the bench). Also a precomputed sparse correlation on the graph's edge
    pattern: each edge's Pearson correlation of the data."""
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
    ATLAS_PERM. Reports each run's seconds, permutations per second, peak
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
    for name, extra in (("materialized", dict(n_perm=N_PERM)),
                        ("streaming", dict(n_perm=N_PERM, store_nulls=False)),
                        ("adaptive_streaming", dict(
                            n_perm=ATLAS_PERM, adaptive=True,
                            store_nulls=False))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tops.reset_launches()
        t1 = time.perf_counter()
        res = atlas_module_preservation(**kw, **extra)
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


def pr9_only(phase) -> int:
    """``--sparse`` / ``--data-only``: that phase alone."""
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
    t0 = time.perf_counter()
    props = network_properties(
        **pair, module_assignments=list(labels), discovery="disc",
        test="test", modules=mods, device="cuda")
    props_s = time.perf_counter() - t0
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
                                 "tolerance": TOL},
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
    largest deviation from plain on re-bucketed buckets)``."""
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
    return mat, launches, err


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


def main() -> int:
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

    # ---- inputs at the north-star width, from one seed -------------------
    t0 = time.perf_counter()
    sizes, labels, (xd, xt, x2) = make_cohorts(np)
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
    bytes_, flops, flops_kernel = 0.0, 0.0, 0.0
    per_bucket = []
    for b, idx in chunk:
        m = b.disc.mask.sum(-1).double()
        K, cap, B = len(b.module_pos), b.cap, idx.shape[0]
        # per cell: one sector per distinct scattered correlation and
        # stored-network entry (the matrices are symmetric: m(m-1)/2 pairs),
        # the module's data rows, its indices and its 7 outputs
        cell_bytes = (m * (m - 1) / 2 * SECTOR * 2 + m * SAMPLES * 4
                      + cap * 4 + 7 * 4)
        bb = B * float(cell_bytes.sum()) + K * cap * cap * 4 * 2 + K * cap * 16
        ff = B * float((15 * m * (m - 1)
                        + (4 * cfg.power_iters + 12) * SAMPLES * m).sum())
        # the kernel's own count: the Gram matrix of the smaller side (upper
        # triangle), its n_iter products, and the streamed passes
        f_, r_ = m.clamp(max=SAMPLES), m.clamp(min=SAMPLES)
        fk = B * float((15 * m * (m - 1) + f_ * f_ * r_
                        + 2 * f_ * f_ * cfg.power_iters
                        + 12 * SAMPLES * m).sum())
        bytes_ += bb
        flops += ff
        flops_kernel += fk
        per_bucket.append({"cap": cap, "modules": K, "batch": B,
                           "tier": fs.kernel_tier(cap, SAMPLES, True),
                           "bound_ms": 1e3 * max(bb / HBM_BPS,
                                                 ff / F32_FLOPS),
                           "kernel_ops_ms": 1e3 * fk / F32_FLOPS})
    t_bytes, t_ops = 1e3 * bytes_ / HBM_BPS, 1e3 * flops / F32_FLOPS
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"

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
          "launches_per_chunk": len(chunk), "bytes": bytes_, "flops": flops,
          "bytes_ms": t_bytes, "ops_ms": t_ops, "bound_ms": bound_ms,
          "kernel_flops": flops_kernel,
          "kernel_ops_ms": 1e3 * flops_kernel / F32_FLOPS,
          "bound_by": bound_by, "times_ms": times, "per_bucket": per_bucket,
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
    del engine, chunk, obs, tc32, tn32, tdT, idx_list
    torch.cuda.empty_cache()

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
              "stat_mode": call["config"].stat_mode, "n_perm": n_perm,
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

    def tallies_equal(a, b):
        hi, lo, eff = pv.tail_counts(a.observed, a.nulls)
        if not (np.array_equal(hi, b.counts_hi)
                and np.array_equal(lo, b.counts_lo)
                and np.array_equal(eff, b.counts_eff)):
            raise RuntimeError("streaming tallies differ from the tail "
                               "counts of the materialized null")

    def null_err(a, b):
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise RuntimeError("NaN pattern of two nulls differs")
        return float(np.nanmax(np.abs(a - b)))

    runs, launches, memory = {}, {}, {}
    for store in (True, False):
        res, launches[store], memory[store] = drive(
            "main_path", ["fused_stats_values" if store
                          else "fused_stats_counts"],
            config=cfg, store_nulls=store)
        runs[store] = res
        emit({"phase": "input_checks", "store_nulls": store,
              "seconds": res.profile["input_s"]})
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

    # ---- derived network: no test network stored, through the
    # fused-statistics kernel's derived mode and through the composed null
    der = {}
    for mode, kernel, n_many in (("auto", "fused_stats_values", 0),
                                 ("xla", many, chunks)):
        der[mode], launches[("derived", mode)], memory[mode] = drive(
            "derived_network", [kernel], {many: n_many, **single},
            config=EngineConfig(network_from_correlation=BETA,
                                stat_mode=mode))
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

    def row_expect(mats, ring):
        """Gather launches of a row-sharded call: per chunk, one per step,
        shard and matrix on the ring (one per block and matrix, psum);
        the discovery build and the observed pass one per block and matrix
        each. Ring steps: R - 1 per chunk, each one launch per block and
        matrix."""
        per_chunk = R * R * mats if ring else R * mats
        out = {many: chunks * per_chunk + 2 * R * mats, **single}
        if ring:
            out["ring_shift_dma"] = chunks * (R - 1) * R * mats
        return out

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
    res, used, _ = drive("perm_mesh", ["fused_stats_counts"], config=cfg,
                         store_nulls=False, mesh=perm_mesh)
    mesh_checks("perm_mesh", res, False, same_kernel=True)
    emit({"phase": "perm_mesh_check", "mesh": perm_mesh.shape,
          "p_values_equal_main": True, "tallies_equal_main": True})
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
    adaptive_run, launches_ad, rebucket_err = adaptive_phase(
        torch, np, fs, fg, pv, drive, cfg, composed_cfg, labels, fused_run,
        comp[True], (dd, dc, dn), (td, tc, tn), card, dev)
    launches.update(launches_ad)
    # ---- interrupted and resumed runs ------------------------------------
    launches.update(checkpoint_phase(
        np, pv, drive, cfg, ring_cfg, row_mesh, many, fused_run, runs[False],
        adaptive_run, card))

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
    multi[True], launches[("multi", True)], _ = drive(
        "multi_test", ["fused_stats_values"], config=cfg, vmap_tests=True)
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
    # ---- the exported surface: properties, combined runs, round trip ----
    surface(torch, np, kw, labels, card)
    del kw, runs, a, b, comp, der, multi, fused_run, res, seq
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
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
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
    }
    ring_paths = {"checkpoint written on the ring mesh"}
    for row in rows:
        # the gather's one counter serves both entries: the ring path's
        # launches are the out= entry's, every other path's the plain one's
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
             "--data-only": lambda: pr9_only(data_only_phase)}
    args = sys.argv[1:]
    if len(args) > 1 or (args and args[0] not in modes):
        sys.exit(f"usage: {sys.argv[0]} [{' | '.join(modes)}]")
    sys.exit(modes[args[0]]() if args else main())
