"""``python -m netrep_tpu_torch warmup``: a shape made ready before its
first request.

The port of ``netrep_tpu/warmup.py``. A fresh process of the port pays,
on its first null, for ``nvcc`` (each kernel library compiled into the
store, :mod:`netrep_tpu_torch.utils.aot`) or for loading the libraries,
for the CUDA modules' first launch and for the engine's build. Warming a
shape here means:

- building every kernel library into the store (on the card), so no later
  process sharing the store runs ``nvcc`` (a replica daemon, a respawn, a
  CLI run: ``source: aot``);
- building that shape's serve-path engine (the packed engine a replica's
  first request for the fixture builds) and its direct engine (what
  ``module_preservation`` builds);
- running one chunk through each, so that their kernels are built and
  launched.

``--measure`` is the proof half: in a fresh process it builds the
serve-path engine for the shape, runs one null under a private telemetry
bus and reports ``first_run_s``, ``compile_span_s``, ``source`` and
``perms_per_sec`` under the JAX package's names.

Shapes come from the serve plane's fixture generator
(``register_fixture``), so warming ``--genes/--modules/--samples`` warms
what a fixture-driven replica serves.
"""

from __future__ import annotations

import json
import os
import tempfile
import time


def _fixture(genes: int, modules: int, samples: int, seed: int):
    """The serve plane's fixture: the generator and module assignment of
    ``PreservationServer.register_fixture``."""
    from .data import make_mixed_pair

    mixed = make_mixed_pair(genes, modules, n_samples=samples, seed=seed)
    (_dd, _dc, dn), _t = mixed["discovery"], mixed["test"]
    assign = {f"node_{i}": "0" for i in range(dn.shape[0])}
    for lab, idx in mixed["specs"]:
        for i in idx:
            assign[f"node_{i}"] = str(lab)
    return mixed, assign


def _serve_engine(genes: int, modules: int, samples: int, seed: int,
                  chunk: int, n_perm: int | None, device=None):
    """The packed engine a serve replica's first request for this fixture
    builds (a solo pack), derived through the scheduler's own
    registration, plan and engine construction; returns it with the
    plan's ``n_perm``."""
    from .serve.scheduler import PreservationServer, ServeConfig
    from .utils.config import EngineConfig

    srv = PreservationServer(
        ServeConfig(engine=EngineConfig(chunk_size=chunk, autotune=False),
                    journal=None, preload=False, device=device),
        start=False,
    )
    try:
        names = srv.register_fixture("warmup", genes=genes, modules=modules,
                                     n_samples=samples, seed=seed)
        d = srv._dataset("warmup", names["discovery"])
        t = srv._dataset("warmup", names["test"])
        plan = srv._build_plan(d, t, None, n_perm=n_perm, seed=0,
                               alternative="greater", adaptive=False,
                               rule=None)
        plan.base = 0
        return srv._pack_engine(d, t, [plan]), plan.n_perm
    finally:
        srv.close(drain=False)


def _direct_engine(genes: int, modules: int, samples: int, seed: int,
                   chunk: int, device=None):
    """The engine a direct ``module_preservation`` call for this fixture
    builds: the same overlap setup, constructor and config defaults."""
    from .models import dataset as ds
    from .models.preservation import _overlap_setup
    from .parallel.engine import PermutationEngine
    from .utils.config import EngineConfig

    mixed, assign = _fixture(genes, modules, samples, seed)
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    built = ds.build_datasets(
        network={"d": dn, "t": tn}, correlation={"d": dc, "t": tc},
        data={"d": dd, "t": td}, device=device, on_device={"t"},
    )
    norm = ds.normalize_module_assignments(assign, built, ["d"])["d"]
    _labels, specs, _counts, pool = _overlap_setup(
        built["d"], built["t"], norm, None, "0", "overlap")
    return PermutationEngine(
        built["d"].correlation, built["d"].network, built["d"].data,
        built["t"].correlation, built["t"].network, built["t"].data,
        specs, pool, config=EngineConfig(chunk_size=chunk, autotune=False),
        device=device,
    )


def parse_grid(spec: str | None, genes: int, modules: int,
               samples: int) -> list[tuple[int, int, int]]:
    """``--grid "300:6:24,600:10:24"`` → shape triples; None → the single
    shape from the scalar flags."""
    if not spec:
        return [(genes, modules, samples)]
    out = []
    for part in spec.split(","):
        g, m, s = (int(x) for x in part.strip().split(":"))
        out.append((g, m, s))
    return out


def _warm(build, key, chunk: int) -> dict:
    """Build one engine, run one chunk through it: the seconds of each and
    the kernel launches the chunk made."""
    from . import ops

    t0 = time.perf_counter()
    eng = build()
    engine_s = time.perf_counter() - t0
    before = {fn.__name__: fn.launches for fn in ops.kernels()}
    t0 = time.perf_counter()
    try:
        eng.run_null(chunk, key=key)
        chunk_s = time.perf_counter() - t0
    finally:
        eng.release()
    return {"engine_s": round(engine_s, 4), "chunk_s": round(chunk_s, 4),
            "launches": {fn.__name__: fn.launches - before[fn.__name__]
                         for fn in ops.kernels()}}


def warmup_grid(shapes, chunk: int, n_perm: int | None,
                fixture_seed: int = 7, target: str = "both",
                telemetry=None, device=None) -> dict:
    """Warm every shape: every kernel library built into the store (on the
    card), then per shape and target the engine built and one chunk run.
    Returns the per-shape, per-target report with the store's stats (its
    ``acquired`` list: each library's ``jit`` or ``aot``). Wrapped in a
    ``warmup_start``/``warmup_end`` span when a telemetry bus is active."""
    from .ops import _build
    from .utils import aot
    from .utils import telemetry as tm
    from .utils.config import resolve_device

    dev = resolve_device(device)
    tel, owned = tm.resolve_arg(telemetry)
    sid = None
    if tel is not None:
        sid = tel.begin_span("warmup_start", shapes=len(shapes),
                             chunk=int(chunk), target=target)
    t0 = time.perf_counter()
    report: dict = {"shapes": [], "chunk": int(chunk), "target": target}
    try:
        if dev.type == "cuda":
            _build.load_all()
        for genes, modules, samples in shapes:
            row: dict = {"genes": genes, "modules": modules,
                         "samples": samples}
            if target in ("serve", "both"):
                row["serve"] = _warm(lambda: _serve_engine(
                    genes, modules, samples, fixture_seed, chunk, n_perm,
                    dev.type)[0], [0], chunk)
            if target in ("direct", "both"):
                row["direct"] = _warm(lambda: _direct_engine(
                    genes, modules, samples, fixture_seed, chunk, dev.type),
                    0, chunk)
            report["shapes"].append(row)
    finally:
        report["s"] = round(time.perf_counter() - t0, 3)
        report["store"] = aot.stats()
        if tel is not None:
            tel.end_span(sid, "warmup_end", s=report["s"],
                         shapes=len(report["shapes"]))
            if owned:
                tel.close()
    return report


def measure_first_run(genes: int, modules: int, samples: int,
                      fixture_seed: int, chunk: int, n_perm: int,
                      device=None) -> dict:
    """The warm-start measurement: build the serve-path engine for this
    shape IN THIS PROCESS (run it fresh for an honest cold or warm number),
    run one fixed-n null under a private telemetry bus, and report the
    run's ``compile_span`` estimate, its ``source`` and the wall and
    throughput of the first run."""
    from .utils import telemetry as tm

    eng, _ = _serve_engine(genes, modules, samples, fixture_seed, chunk,
                           n_perm, device)
    fd, tel_path = tempfile.mkstemp(suffix=".jsonl", prefix="netrep_warmup_")
    os.close(fd)
    try:
        tel, _owned = tm.resolve_arg(tel_path)
        t0 = time.perf_counter()
        try:
            _nulls, completed = eng.run_null(n_perm, key=[0], telemetry=tel)
        finally:
            tel.close()
        wall = time.perf_counter() - t0
        compile_s, source = None, None
        with open(tel_path, encoding="utf-8") as f:
            for line in f:
                if '"compile_span"' not in line:
                    continue
                e = json.loads(line)
                if e.get("ev") == "compile_span":
                    compile_s = float(e["data"].get("s", 0.0))
                    source = e["data"].get("source")
        return {
            "genes": int(genes), "modules": int(modules),
            "samples": int(samples), "chunk": int(chunk),
            "n_perm": int(n_perm), "completed": int(completed),
            "first_run_s": round(wall, 3),
            "compile_span_s": (round(compile_s, 4)
                               if compile_s is not None else None),
            "source": source,
            "perms_per_sec": round(completed / wall, 2) if wall > 0 else 0,
        }
    finally:
        eng.release()
        try:
            os.unlink(tel_path)
        except OSError:
            pass


def main_warmup(args) -> int:
    """CLI entry (from ``__main__``): warm the grid, or ``--measure`` the
    first run for the shape."""
    from .utils import aot

    if args.store:
        os.environ[aot.STORE_ENV] = args.store
    device = getattr(args, "device", None)
    if args.measure:
        out = measure_first_run(args.genes, args.modules, args.samples,
                                args.fixture_seed, args.chunk,
                                args.n_perm or 256, device)
        print(json.dumps(out) if args.json else (
            f"first run {out['first_run_s']}s, compile_span "
            f"{out['compile_span_s']}s (source: {out['source']}), "
            f"{out['perms_per_sec']} perms/s"))
        return 0
    shapes = parse_grid(args.grid, args.genes, args.modules, args.samples)
    report = warmup_grid(shapes, args.chunk, args.n_perm,
                         fixture_seed=args.fixture_seed, target=args.target,
                         telemetry=args.telemetry, device=device)
    if args.json:
        print(json.dumps(report))
    else:
        for row in report["shapes"]:
            for tgt in ("serve", "direct"):
                if tgt in row:
                    r = row[tgt]
                    print(f"{row['genes']}g/{row['modules']}m/"
                          f"{row['samples']}s [{tgt}]: engine "
                          f"{r['engine_s']}s, one chunk {r['chunk_s']}s, "
                          f"launches {r['launches']}")
        st = report["store"]
        print(f"warmup done in {report['s']}s: {st['entries']} libraries "
              f"({st['bytes']} bytes) in {st['path']}, "
              f"{st['builds']} built this run")
    return 0
