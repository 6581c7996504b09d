"""The traced window: ``torch.profiler`` around the benchmark's own window,
and the reading of its Chrome trace.

The interval arithmetic (device events clipped to the window, their union
as the busy time) is a copy of ``trace_time_split`` in
``netrep_tpu_torch/utils/profiling.py`` at commit
53bdfe689d3220fe33f3e7b7699923adc36ce31a.

On a card only the card's activity is traced (kernels, copies, and the CUDA
runtime calls that launched them): recording every host-side operation as
well costs ~90 us of post-processing per operation, which the sparse path's
millions of small operations turn into minutes. The window is then bounded
by two marker kernels (``torch.cuda._sleep``) launched as it opens and
closes, when the card is idle; where the trace lost one (a traced sparse
call records ~10^6 kernels), by its first and last device operation. On the CPU (the tests) host operations are
traced and two marker annotations bound the window.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time

OPEN, CLOSE = "portbench.window.open", "portbench.window.close"
#: the name of ``torch.cuda._sleep``'s kernel, the card's window markers
SPIN = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def op_name(name: str) -> str:
    """A device operation's name without ``void`` and its argument list."""
    return re.sub(r"^void ", "", str(name)).split("(", 1)[0][:120]


def union(iv) -> float:
    total, end = 0.0, None
    for a, b in sorted(iv):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(iv, w0: float, w1: float) -> list[tuple[float, float]]:
    """The stretches of ``[w0, w1]`` that no interval of ``iv`` covers."""
    out, at = [], w0
    for a, b in sorted(iv):
        if a > at:
            out.append((at, min(a, w1)))
        at = max(at, b)
        if at >= w1:
            break
    if at < w1:
        out.append((at, w1))
    return [(a, b) for a, b in out if b > a]


def _host_label(host: list, starts: list, t: float) -> str:
    """What the host was doing at ``t``: the innermost of the host events
    starting just before it that holds it, or ``python`` outside every
    recorded operation."""
    best = None
    i = bisect.bisect_right(starts, t)
    for e in host[max(0, i - 16):i]:
        a = e["ts"]
        if a <= t <= a + e["dur"] and (best is None or e["dur"] < best["dur"]):
            best = e
    return "python" if best is None else f"{best.get('cat')}:{best.get('name')}"[:120]


def summarize(events: list[dict]) -> dict | None:
    """The window's device numbers from a trace's complete events: None
    when the markers are missing. Times in seconds."""
    marks = {e.get("name"): float(e["ts"]) for e in events
             if e.get("name") in (OPEN, CLOSE) and e.get("cat") != "gpu_user_annotation"}
    spins = sorted((e for e in events if e.get("cat") == "kernel"
                    and SPIN in str(e.get("name"))), key=lambda e: float(e["ts"]))
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if OPEN in marks and CLOSE in marks:
        w0, w1, bounded = marks[OPEN], marks[CLOSE], "markers"
    elif len(spins) == 2:
        w0, w1 = float(spins[0]["ts"]), float(spins[1]["ts"]) + float(spins[1]["dur"])
        bounded = "markers"
    elif device:
        # a marker the trace lost: the window is the traced call's first to
        # last recorded device operation
        w0 = min(float(e["ts"]) for e in device)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in device)
        bounded = "events"
    else:
        return None
    if w1 <= w0:
        return None
    busy, kernels = [], {}
    for e in device:
        if SPIN in str(e.get("name")):
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        lo, hi = max(a, w0), min(b, w1)
        if hi <= lo:
            continue
        busy.append((lo, hi))
        k = kernels.setdefault(op_name(e.get("name", "?")),
                               {"seconds": 0.0, "launches": 0, "blocks": 0})
        k["seconds"] += (hi - lo) * 1e-6
        k["launches"] += 1
        grid = (e.get("args") or {}).get("grid")
        if isinstance(grid, list) and grid:
            n = 1
            for g in grid:
                n *= int(g)
            k["blocks"] += n
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and w0 <= float(e["ts"]) <= w1),
                  key=lambda e: float(e["ts"]))
    for e in host:
        e["ts"], e["dur"] = float(e["ts"]), float(e["dur"])
    starts = [e["ts"] for e in host]
    idle: dict[str, float] = {}
    for a, b in gaps(busy, w0, w1):
        lab = _host_label(host, starts, 0.5 * (a + b))
        idle[lab] = idle.get(lab, 0.0) + (b - a) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "bounded_by": bounded,
        "busy_s": union(busy) * 1e-6,
        "device_events": len(busy),
        "kernels": kernels,
        "breakdown": {
            "device_ops": sorted(([n, k["seconds"]] for n, k in kernels.items()),
                                 key=lambda r: -r[1])[:10],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                key=lambda r: -r[1])[:10],
        },
    }


def read_trace(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    events = raw.get("traceEvents", []) if isinstance(raw, dict) else raw
    return [e for e in events if isinstance(e, dict) and e.get("ph") == "X" and "dur" in e]


class Tracer:
    """``torch.profiler`` on the card (or, without one, on the host), its
    trace written under ``TMPDIR``; ``mark(name)`` marks the window's ends.
    ``seconds`` records what reading the trace cost."""

    def __init__(self, cuda: bool):
        import torch

        act = torch.profiler.ProfilerActivity
        self._torch, self._cuda = torch, cuda
        self._prof = torch.profiler.profile(activities=[act.CUDA if cuda else act.CPU])
        self.dir = tempfile.mkdtemp(prefix="portbench-trace-")
        self.seconds = {}

    def start(self):
        self._prof.start()

    def mark(self, name: str):
        if self._cuda:
            self._torch.cuda.synchronize()
            self._torch.cuda._sleep(1000)
            self._torch.cuda.synchronize()
        else:
            with self._torch.profiler.record_function(name):
                pass

    def stop_and_read(self) -> dict | None:
        clock = time.perf_counter
        t0 = clock()
        self._prof.stop()
        path = os.path.join(self.dir, "trace.json")
        t1 = clock()
        self._prof.export_chrome_trace(path)
        t2 = clock()
        try:
            events = read_trace(path)
            t3 = clock()
            return summarize(events)
        finally:
            self.seconds = {"stop": t1 - t0, "save": t2 - t1, "read": t3 - t2,
                            "summarize": clock() - t3}
            os.remove(path)
            os.rmdir(self.dir)
