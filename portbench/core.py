"""The harness: finds a cell's files by name, drives its window, reads its
metrics, decides ``correct`` and assembles the result line.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json`` (its ``kind`` names ``problems/<kind>.py``);
- ``traffic/<mix>.json`` (its ``driver`` names ``drivers/<driver>.py``);
- ``metrics/<metric>.py``, whose ``read(view)`` returns a number or None;
- ``limits/<workload>.json``, the limit of each number ``correct`` compares.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import numpy as np

from .reference import check
from .reference.netstats import Precision
from .trace import CLOSE, OPEN, Tracer

HERE = Path(__file__).resolve().parent
#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "netrep_tpu")
#: a traced run traces this many seconds of calls after its window: 0, the
#: one call that follows it. Reading a trace costs ~4 s a traced second (the
#: draw's many small kernels), so a whole window's would take a run past its
#: limit, and on the sparse path a trace of two calls lost its window's
#: first marker
TRACE_SECONDS = 0.0


class ForbiddenImport(RuntimeError):
    """A run loaded JAX or the JAX package."""


def forbidden_loaded() -> list[str]:
    """Forbidden modules in ``sys.modules``, by whole top-level name."""
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(root: Path, workload: str) -> dict:
    """Everything one cell names: its entry, configuration, mix, limits,
    problem module, driver module, and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cell = by_name(bench["workloads"], workload, "workload")
    cfg = load_json(root / by_name(bench["configs"], cell["config"], "config")["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    shown = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in shown else [])]
    return {
        "cell": cell, "config": cfg, "traffic": traffic, "end_to_end": e2e,
        "per_layer": layer, "limits": load_json(HERE / "limits" / f"{workload}.json"),
        "problem": importlib.import_module(f"portbench.problems.{cfg['kind']}"),
        "driver": importlib.import_module(f"portbench.drivers.{traffic['driver']}"),
    }


def load_metric(name: str):
    """``metrics/<name>.py`` as a module (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def judge(readings: dict, limits: dict) -> dict:
    """Each compared number beside its limit; an infinite gap (a NaN on one
    side only) is written as 1e300, so the line stays strict JSON."""
    return {k: {"value": readings[k] if np.isfinite(readings[k]) else 1e300,
                "limit": limits[k]} for k in sorted(readings)}


def control_precision(cfg: dict) -> Precision:
    """The control: the reference in the nearest precision below the one
    the configuration states (TF32 for float32 storage with TF32 off)."""
    if cfg["storage"] == "float32" and not cfg["tf32"]:
        return Precision("tf32")
    raise ValueError(f"no control for storage {cfg['storage']!r} with tf32={cfg['tf32']}")


def verify(session, calls: list, seed: int, sample: dict, control=None):
    """The compared numbers of a run's finished calls, the port's answers
    against the reference's; with a ``control`` precision, also the
    control's (the reference in that precision in the port's place) on the
    same samples. ``sample`` is the mix's ``check``."""
    answers = [session.answer(c) for c in calls]
    sizes = [m.size for m in session.modules]
    plan = check.plan(seed, answers, sizes, sample["perms_per_call"], sample["modules"])
    problem = session.reference()
    try:
        ref = check.reference_answers(problem, answers, plan, Precision("float64"))
        readings = check.compare(answers, ref, plan)
        ctrl = (check.compare(check.control_answers(problem, answers, plan, control),
                              ref, plan)
                if control is not None else None)
        return readings, ctrl
    finally:
        problem.release()


def _device(torch, dev, chips: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": chips}


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_process: float, clock=time.perf_counter,
             adjust=None, control: bool = False) -> dict:
    """One run of one cell; returns the result line's object (``checks``
    last). The window runs untraced; with ``trace``, one more call runs
    under the profiler after it, and the device metrics come from that. Raises :class:`ForbiddenImport` when a
    forbidden module was loaded. ``adjust(files)`` may change the cell's
    files before the run (the tests shrink a cell to run it on the CPU).
    ``control`` adds the control's readings under ``control`` (calibration
    only)."""
    import torch

    f = cell_files(root, workload)
    if adjust is not None:
        adjust(f)
    cfg, traffic = f["config"], f["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t_inputs = clock()
    session = f["problem"].Session(cfg, seed, dev)
    t_warm = clock()
    session.call(-1, traffic["warm_perms"], traffic["options"])
    if cuda:
        torch.cuda.synchronize(dev)
    t_warm_end = clock()

    def call(i):
        return session.call(i, traffic["n_perm"], traffic["options"])

    def on_open():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def on_close():
        return torch.cuda.max_memory_allocated(dev) if cuda else None

    window = f["driver"].drive(call, seconds, clock, on_open, on_close)
    summary, traced, trace_seconds = None, [], None
    if trace:
        tracer = Tracer(cuda)
        tracer.start()
        traced = f["driver"].drive(call, TRACE_SECONDS, clock,
                                   lambda: tracer.mark(OPEN),
                                   lambda: tracer.mark(CLOSE),
                                   first=len(window.calls)).calls
        summary = tracer.stop_and_read()
        trace_seconds = tracer.seconds
    found = forbidden_loaded()
    if found:
        raise ForbiddenImport(f"forbidden modules loaded: {found}")
    every = window.calls + traced
    done = [c for c in every if "error" not in c]
    for c in every:
        if "error" in c:
            print(f"call {c['index']} failed:\n{c['error']}", file=sys.stderr)

    metrics = {}
    if not trace:
        e2e = f["driver"].end_to_end(window)
        e2e["setup_s"] = window.start - t_process
        e2e["peak_gib"] = (window.peak_bytes or 0) / 2**30
        for m in f["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        view = types.SimpleNamespace(
            calls=[c for c in window.calls if "error" not in c],
            trace=summary, traffic=traffic, config=cfg,
            cost_shape=session.cost_shape(), card=_device(torch, dev, 1)["kind"])
        for m in f["per_layer"]:
            value = load_metric(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_verify = clock()
    readings, ctrl = (verify(session, done, seed, traffic["check"],
                             control_precision(cfg) if control else None)
                      if done else ({}, None))
    timing = {"setup_s": window.start - t_process, "before_inputs_s": t_inputs - t_process,
              "inputs_s": t_warm - t_inputs, "warm_s": t_warm_end - t_warm,
              "window_s": window.seconds, "calls": len(window.calls),
              "traced_calls": len(traced),
              "each_call_s": [c["t1"] - c["t0"] for c in every],
              **{f"each_{k}": [c.get("profile", {}).get(k) for c in every]
                 for k in ("input_s", "engine_s", "observed_s", "null_s")},
              "verify_s": clock() - t_verify, "trace_s": trace_seconds,
              "trace_bounded_by": summary and summary["bounded_by"]}
    checks = judge(readings, f["limits"])
    failed = sum("error" in c for c in every)
    correct = (bool(done) and failed == 0
               and set(readings) == set(f["limits"])
               and all(v["value"] <= v["limit"] for v in checks.values()))
    found = forbidden_loaded()
    if found:
        raise ForbiddenImport(f"forbidden modules loaded: {found}")
    device_info = _device(torch, dev, int(f["cell"]["chips"]))
    device_info["memory_peak_bytes"] = window.peak_bytes
    out = {"correct": correct, "attempted": len(every), "failed": failed,
           "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        out["breakdown"] = summary["breakdown"]
    out["timing"] = timing
    if ctrl is not None:
        out["control"] = ctrl
    out["checks"] = checks
    return out
