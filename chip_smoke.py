"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``netrep_tpu_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card, times both
at the main path's shapes, then drives the public entry point
``netrep_tpu_torch.models.preservation.module_preservation`` at the
north-star width — 20,000 genes, 50 planted modules of 30–200 nodes, 128
samples per dataset, 1,000 permutations — once with the materialized null
and once streaming, and checks that both went through the kernels and gave
the same p-values. Inputs are generated from a fixed seed (data with numpy
on the host, correlation and network on the card) and handed to the entry
point as host float64 numpy arrays, as a user holds them, so its input
phase includes the copy to the card.

Prints one JSON object per phase, then the ``{"kernels": [...]}`` summary,
the card's ``name, power.limit`` line, and as its last line
``{"ok": true, "device": {...}}``. Any failed phase raises and the script
exits non-zero; without a CUDA device it exits non-zero before printing
anything.
"""

from __future__ import annotations

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from netrep_tpu_torch import random as trandom
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.ops import _build
    from netrep_tpu_torch.ops import fused_stats as fs
    from netrep_tpu_torch.ops import pvalues as pv
    from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine
    from netrep_tpu_torch.utils.config import EngineConfig

    GENES, SAMPLES, MODULES, SIZES = 20_000, 128, 50, (30, 200)
    N_PERM, SEED, BETA = 1000, 2026, 2.0
    #: kernel vs plain: the kernel's power iteration runs as Z^T (Z v) and
    #: sums in its own fixed order (csrc/fused_stats.cu); the plain version
    #: forms the Gram matrix — float32 rounding apart, ~1e-5 at most
    TOL = 1e-4
    #: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside
    #: the tensor cores (the kernel does scalar f32 arithmetic)
    HBM_BPS, F32_FLOPS = 3.35e12, 67e12
    SECTOR = 32
    dev = torch.device("cuda")
    card = card_line()
    cfg = EngineConfig()

    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- build every kernel source of the path, all nvcc runs at once ----
    t0 = time.perf_counter()
    _build.build(["fused_stats"])
    lib = fs._lib()
    info = _build.BUILD_INFO["fused_stats"]
    regs = re.findall(r"Used (\d+) registers", info["ptxas"])
    spills = re.findall(r"(\d+) bytes spill stores", info["ptxas"])
    for cap, s, hd in ((224, 128, 1), (32, 0, 0), (96, 40, 1)):
        if lib.fused_stats_smem_bytes(cap, s, hd) != fs.resolve_smem_bytes(
                cap, s, bool(hd)):
            raise RuntimeError("shared-memory layout of the kernel and its "
                               "Python guard disagree")
    emit({"phase": "build", "source": "netrep_tpu_torch/csrc/fused_stats.cu",
          "nvcc_s": info["seconds"], "total_s": time.perf_counter() - t0,
          "lib": info["lib"].rsplit("/", 1)[-1],
          "registers": [int(r) for r in regs],
          "spill_bytes": [int(x) for x in spills]})

    # ---- inputs at the north-star width, from one seed -------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    sizes = rng.integers(SIZES[0], SIZES[1] + 1, size=MODULES)
    xd = rng.standard_normal((SAMPLES, GENES)).astype(np.float32)
    xt = rng.standard_normal((SAMPLES, GENES)).astype(np.float32)
    labels = np.full(GENES, "0", dtype=object)
    order = rng.permutation(GENES)
    at = 0
    for k, sz in enumerate(sizes):
        nodes = order[at: at + sz]
        at += sz
        load = rng.uniform(0.6, 2.2, size=sz).astype(np.float32)
        xd[:, nodes] += rng.standard_normal((SAMPLES, 1)).astype(np.float32) * load
        if k < MODULES // 2:  # the first half is preserved in the test set
            xt[:, nodes] += (rng.standard_normal((SAMPLES, 1))
                             .astype(np.float32) * load)
        labels[nodes] = str(k + 1)

    def mats(x):
        t = torch.as_tensor(x, device=dev, dtype=torch.float64)
        z = (t - t.mean(0)) / t.std(0)
        c = (z.T @ z) / (SAMPLES - 1)
        c = (c + c.T) * 0.5
        c.fill_diagonal_(1.0)
        c.clamp_(-1.0, 1.0)
        return t, c, c.abs() ** BETA

    (dd, dc, dn), (td, tc, tn) = mats(xd), mats(xt)
    torch.cuda.synchronize()
    emit({"phase": "inputs", "genes": GENES, "samples": SAMPLES,
          "modules": MODULES, "module_sizes": [int(v) for v in sizes],
          "seconds": time.perf_counter() - t0})

    # ---- the kernels against their plain versions, at the path's shapes --
    specs = [ModuleSpec(str(k + 1), np.flatnonzero(labels == str(k + 1)),
                        np.flatnonzero(labels == str(k + 1)))
             for k in range(MODULES)]
    engine = PermutationEngine(dc, dn, dd, tc, tn, td, specs,
                               np.arange(GENES), config=cfg, device=dev)
    tc32, tn32, tdT = engine._test_corr, engine._test_net, engine._test_dataT
    perm = trandom.permutation(
        trandom.perm_keys(trandom.key(SEED, device=dev), 0, cfg.chunk_size),
        engine._pool_dev,
    )
    chunk = [(b, engine._bucket_idx(perm, b)) for b in engine.buckets]
    observed = engine.observed()
    obs = [torch.as_tensor(observed[b.module_pos], dtype=torch.float32,
                           device=dev)
           for b in engine.buckets]

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
    bytes_, flops = 0.0, 0.0
    per_bucket = []
    for b, idx in chunk:
        m = b.disc.mask.sum(-1).double()
        K, cap, B = len(b.module_pos), b.cap, idx.shape[0]
        # per cell: one sector per scattered correlation and stored-network
        # entry, the module's data rows, its indices and its 7 outputs
        cell_bytes = (m * (m - 1) * SECTOR * 2 + m * SAMPLES * 4 + cap * 4
                      + 7 * 4)
        bb = B * float(cell_bytes.sum()) + K * cap * cap * 4 * 2 + K * cap * 16
        ff = B * float((15 * m * (m - 1)
                        + (4 * cfg.power_iters + 12) * SAMPLES * m).sum())
        bytes_ += bb
        flops += ff
        per_bucket.append({"cap": cap, "modules": K, "batch": B,
                           "bound_ms": 1e3 * max(bb / HBM_BPS,
                                                 ff / F32_FLOPS)})
    t_bytes, t_ops = 1e3 * bytes_ / HBM_BPS, 1e3 * flops / F32_FLOPS
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"

    def timed(mode, impl, reps=5):
        run(mode, impl, cfg.chunk_size)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            run(mode, impl, cfg.chunk_size)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    times = {}
    for mode in ("values", "counts"):
        # plain, kernel, kernel, plain: drift on the card hits both alike
        p1, k1 = timed(mode, "plain"), timed(mode, "kernel")
        k2, p2 = timed(mode, "kernel"), timed(mode, "plain")
        times[f"fused_stats_{mode}"] = {"ms": (k1 + k2) / 2,
                                        "plain_ms": (p1 + p2) / 2}
    for b_info, (b, idx) in zip(per_bucket, chunk):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            fs.fused_stats_values(tc32, tn32, tdT, b.disc, idx,
                                  n_iter=cfg.power_iters)
        e1.record()
        torch.cuda.synchronize()
        b_info["ms"] = e0.elapsed_time(e1) / 5
    emit({"phase": "kernel_times", "unit": "one chunk of "
          f"{cfg.chunk_size} permutations x {MODULES} modules "
          f"({len(chunk)} launches, one per bucket)",
          "launches_per_chunk": len(chunk), "bytes": bytes_, "flops": flops,
          "bytes_ms": t_bytes, "ops_ms": t_ops, "bound_ms": bound_ms,
          "bound_by": bound_by, "times_ms": times, "per_bucket": per_bucket,
          "library_ms": None,
          "library_note": "no single PyTorch call computes the seven "
                          "preservation statistics",
          "card": card})
    del engine, chunk, perm, obs, tc32, tn32, tdT
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
    kw = dict(
        network={"disc": dn, "test": tn},
        data={"disc": dd, "test": td},
        correlation={"disc": dc, "test": tc},
        module_assignments=list(labels), discovery="disc", test="test",
        n_perm=N_PERM, seed=SEED, config=cfg, device="cuda",
    )
    runs, launches = {}, {}
    for store in (True, False):
        fs.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = module_preservation(**kw, store_nulls=store)
        wall = time.perf_counter() - t0
        launches[store] = {fn.__name__: fn.launches for fn in fs.KERNELS}
        runs[store] = res
        used = "fused_stats_values" if store else "fused_stats_counts"
        if launches[store][used] == 0:
            raise RuntimeError(f"main path (store_nulls={store}) launched "
                               f"no {used} kernel")
        if res.observed.shape != (MODULES, 7) or not np.isfinite(
                res.observed).all():
            raise RuntimeError("observed statistics are not finite "
                               f"(MODULES, 7): {res.observed.shape}")
        if not ((res.p_values > 0) & (res.p_values <= 1)).all():
            raise RuntimeError("p-values outside (0, 1]")
        if res.completed != N_PERM:
            raise RuntimeError(f"completed {res.completed} of {N_PERM}")
        prof = res.profile
        emit({"phase": "input_checks", "store_nulls": store,
              "seconds": prof["input_s"]})
        emit({"phase": "main_path", "store_nulls": store, "n_perm": N_PERM,
              "wall_s": wall, "input_s": prof["input_s"],
              "engine_s": prof["engine_s"], "observed_s": prof["observed_s"],
              "null_s": prof["null_s"], "perms_per_s": prof["perms_per_s"],
              "launches": launches[store],
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "card": card})
    a, b = runs[True], runs[False]
    if not np.array_equal(a.p_values, b.p_values):
        raise RuntimeError("materialized and streaming p-values differ")
    hi, lo, eff = pv.tail_counts(a.observed, a.nulls)
    if not (np.array_equal(hi, b.counts_hi) and np.array_equal(lo, b.counts_lo)
            and np.array_equal(eff, b.counts_eff)):
        raise RuntimeError("streaming tallies differ from the tail counts of "
                           "the materialized null")
    preserved = (a.p_values.max(axis=1) < 0.05 / MODULES)
    emit({"phase": "main_path_check", "p_values_equal": True,
          "tallies_equal_tail_counts": True,
          "min_p": float(a.p_values.min()),
          "modules_preserved": int(preserved.sum()),
          "planted_preserved": MODULES // 2})
    del kw, runs, a, b, dd, dc, dn, td, tc, tn
    torch.cuda.empty_cache()

    # ---- a small reference: the same call on the card and on the CPU -----
    from netrep_tpu_torch.data import make_example_pair, pair_frames

    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    small = dict(network={"d": d["network"], "t": t["network"]},
                 data={"d": d["data"], "t": t["data"]},
                 correlation={"d": d["correlation"], "t": t["correlation"]},
                 module_assignments=pair["labels"], n_perm=400, seed=4)
    on_card = module_preservation(**small)
    on_cpu = module_preservation(**small, device="cpu")
    obs_err = float(np.abs(on_card.observed - on_cpu.observed).max())
    null_err = float(np.nanmax(np.abs(on_card.nulls - on_cpu.nulls)))
    if obs_err > TOL or null_err > TOL or not np.array_equal(
            on_card.p_values, on_cpu.p_values):
        raise RuntimeError(f"card and CPU disagree on the example fixture: "
                           f"observed {obs_err}, null {null_err}")
    emit({"phase": "example_vs_cpu", "max_abs_observed": obs_err,
          "max_abs_null": null_err, "p_values_equal": True,
          "tolerance": TOL})

    src = "netrep_tpu_torch/csrc/fused_stats.cu"
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": f"netrep_tpu/ops/fused_stats.py:{line}",
         "launches": launches[store][name], "max_abs_err": max_err[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        for name, line, store in (("fused_stats_values", 345, True),
                                  ("fused_stats_counts", 363, False))
    ]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
