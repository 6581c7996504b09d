"""Profiling hooks: the port of ``netrep_tpu/utils/profiling.py``.

- ``profile=`` on :func:`netrep_tpu_torch.models.preservation.
  module_preservation` captures a ``torch.profiler`` trace (CPU and, on a
  card, CUDA activity) of the run into a directory as a Chrome trace
  (``trace_<pid>_<n>.json``, readable in Perfetto or
  ``chrome://tracing``), plus per-pair wall-clock and per-chunk timings
  attached to each result as ``result.profile``.
- :func:`summarize_trace` ranks the device operations of the captured
  trace by device time, and :func:`trace_time_split` splits it into
  kernel and transfer time and measures the device's busy and idle
  share — over the whole trace or over the null alone
  (``module_preservation`` marks each pair's null with the
  :data:`NULL_SPAN` annotation while a trace is recording).
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import logging
import os
import re
import time
from typing import Callable

import torch

logger = logging.getLogger("netrep_tpu_torch")

#: the ``record_function`` name that marks a permutation null in a trace
NULL_SPAN = "netrep_null"


@dataclasses.dataclass
class NullProfile:
    """Dispatch and transfer accounting for one null run: the loops count
    every chunk or superchunk they dispatch and every byte they bring to
    the host, so the streaming loop's "one host read per superchunk" is a
    measured row. ``superchunks`` holds one record per streaming
    superchunk."""

    #: dispatches issued (a chunk's key derivation and its body count two,
    #: as in the JAX package)
    dispatches: int = 0
    #: bytes moved device → host (null chunks or streamed tallies)
    host_bytes: int = 0
    #: per-superchunk records: {"dispatches", "host_bytes", "perms"}
    superchunks: list = dataclasses.field(default_factory=list)
    #: modelled operations (fed by the null loops with the integers their
    #: chunk and superchunk events carry, so per-family span sums equal
    #: these totals exactly; telemetry-on runs only)
    flops: int = 0
    #: modelled device-memory bytes (the same contract)
    cost_bytes: int = 0
    #: per-family rollup: {family: {"flops", "bytes_hbm", "perms"}}
    families: dict = dataclasses.field(default_factory=dict)

    def record_dispatch(self, n: int = 1) -> None:
        self.dispatches += int(n)

    def record_transfer(self, nbytes: int) -> None:
        self.host_bytes += int(nbytes)

    def record_superchunk(self, dispatches: int, host_bytes: int,
                          perms: int) -> None:
        self.superchunks.append({
            "dispatches": int(dispatches),
            "host_bytes": int(host_bytes),
            "perms": int(perms),
        })

    def record_cost(self, flops: int, bytes_hbm: int, family: str,
                    perms: int) -> None:
        """Fold one chunk's or superchunk's modelled cost (the integers its
        telemetry event carries) into the run totals and the per-family
        rollup (:mod:`netrep_tpu_torch.utils.costmodel`)."""
        self.flops += int(flops)
        self.cost_bytes += int(bytes_hbm)
        fam = self.families.setdefault(
            str(family), {"flops": 0, "bytes_hbm": 0, "perms": 0})
        fam["flops"] += int(flops)
        fam["bytes_hbm"] += int(bytes_hbm)
        fam["perms"] += int(perms)

    def as_dict(self) -> dict:
        out = {
            "dispatches": self.dispatches,
            "host_bytes": self.host_bytes,
            "superchunks": list(self.superchunks),
        }
        if self.families:
            # additive: the cost keys appear only on runs that priced
            # their chunks
            out["flops"] = self.flops
            out["bytes_hbm"] = self.cost_bytes
            out["families"] = {k: dict(v) for k, v in self.families.items()}
        return out


#: traces written by this process (file names stay unique per call)
_TRACE_SEQ = [0]
#: :func:`device_trace` blocks recording now
_ACTIVE_TRACES = [0]


def tracing_active() -> bool:
    """Whether a :func:`device_trace` is recording in this process — the
    loops annotate the null only then."""
    return _ACTIVE_TRACES[0] > 0


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """``torch.profiler`` over the block, CUDA activity included when a
    card is present, exported as a Chrome trace into ``trace_dir``.
    Profiling only observes: a profiler that cannot start or export warns
    and the run goes on (its timings are still collected)."""
    if trace_dir is None:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    # netrep: allow(exception-taxonomy) — profiling is observability: a backend that cannot trace must not fail the run (timings still collect)
    except Exception as e:
        logger.warning("profiler trace failed (%s: %s); timings are still "
                       "collected", type(e).__name__, e)
        yield
        return
    _ACTIVE_TRACES[0] += 1
    try:
        yield
    finally:
        _ACTIVE_TRACES[0] -= 1
        try:
            prof.__exit__(None, None, None)
            _TRACE_SEQ[0] += 1
            prof.export_chrome_trace(os.path.join(
                trace_dir, f"trace_{os.getpid()}_{_TRACE_SEQ[0]}.json"))
        # netrep: allow(exception-taxonomy) — profiling is observability: a trace that cannot be exported must not fail the run (timings still collect)
        except Exception as e:
            logger.warning("profiler trace export failed (%s: %s)",
                           type(e).__name__, e)


def null_annotation():
    """``record_function(NULL_SPAN)`` while a trace records, else a no-op:
    the window :func:`trace_time_split` measures the null's idle share
    over."""
    if not tracing_active():
        return contextlib.nullcontext()
    return torch.profiler.record_function(NULL_SPAN)


class PairTimer:
    """Collects per-pair wall-clock and per-chunk durations.

    The chunk timer piggybacks on the engine's ``progress`` callback — the
    loop calls it once per completed chunk (or superchunk), so inter-call
    deltas are chunk wall times.
    """

    def __init__(self, trace_dir: str | None):
        self.trace_dir = trace_dir
        self.chunk_s: list[float] = []
        self.observed_s: float | None = None
        self.null_s: float | None = None
        self._t0: float | None = None
        self._null_start: float | None = None

    def time_observed(self, fn: Callable):
        t0 = time.perf_counter()
        out = fn()
        self.observed_s = time.perf_counter() - t0
        return out

    def wrap_progress(self, progress: Callable | None) -> Callable:
        self._t0 = self._null_start = time.perf_counter()

        def cb(done, total):
            now = time.perf_counter()
            self.chunk_s.append(now - self._t0)
            self._t0 = now
            if progress is not None:
                progress(done, total)

        return cb

    def finish_null(self, completed: int) -> dict:
        # wrap_progress may never have run (a failed null): null_s stays
        # unmeasured rather than crashing on the unset start mark
        if self._null_start is not None:
            self.null_s = time.perf_counter() - self._null_start
        return self.as_dict(completed)

    def as_dict(self, completed: int) -> dict:
        """The ``result.profile`` payload."""
        chunks = self.chunk_s
        return {
            "trace_dir": self.trace_dir,
            "observed_s": self.observed_s,
            "null_s": self.null_s,
            "completed": completed,
            "perms_per_sec": (
                completed / self.null_s if self.null_s else None
            ),
            "chunk_ms": [s * 1e3 for s in chunks],
            # the first chunk's time includes the kernels' build or load
            "compile_chunk_ms": chunks[0] * 1e3 if chunks else None,
            "steady_chunk_ms": (
                sorted(chunks[1:])[len(chunks[1:]) // 2] * 1e3
                if len(chunks) > 1 else None
            ),
        }


def make_memory_probe(device=None):
    """Per-chunk device-memory gauge factory: a zero-argument callable
    giving ``mem_bytes_in_use`` and ``mem_peak_bytes`` of ``device``
    (None: the current card) — what ``torch.cuda.memory_allocated`` and
    ``max_memory_allocated`` report — or None without a card. Decided once
    per run. Both come from one ``memory_stats_as_nested_dict`` read
    (0.026 ms on an NVIDIA H100 80GB HBM3 at 700 W, ``chip_smoke.py``'s
    ``fault_ladder`` phase), not from two flat calls that would each
    flatten the allocator's whole statistics dict."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None

    def probe():
        st = torch.cuda.memory_stats_as_nested_dict(dev)
        alloc = st.get("allocated_bytes", {}).get("all", {})
        return {
            "mem_bytes_in_use": int(alloc.get("current", 0)),
            "mem_peak_bytes": int(alloc.get("peak", 0)),
        }

    return probe


def resolve_profile_dir(profile) -> str | None:
    """``profile=`` argument → trace directory (None = profiling off)."""
    if profile is None or profile is False:
        return None
    if profile is True:
        return os.path.join(os.getcwd(), "netrep_profile")
    return str(profile)


#: categories of device activity in a ``torch.profiler`` Chrome trace
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: operation names that move data (copies and fills), the "transfer" side
_TRANSFER_OPS = re.compile(r"memcpy|memset|copy", re.IGNORECASE)


def _trace_events(trace_dir: str) -> list[dict]:
    """The complete (``"ph": "X"``) events of the newest Chrome trace in
    ``trace_dir``, or [] when there is none or it does not parse."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        return []
    try:
        with open(paths[-1], encoding="utf-8") as f:
            raw = json.load(f)
    except (OSError, ValueError) as e:
        logger.warning("cannot read trace %r (%s: %s); per-operation "
                       "tables will be empty", paths[-1], type(e).__name__, e)
        return []
    events = raw.get("traceEvents", []) if isinstance(raw, dict) else raw
    return [e for e in events
            if isinstance(e, dict) and e.get("ph") == "X" and "dur" in e]


def _op_name(name: str) -> str:
    """A device operation's name without its argument list."""
    name = re.sub(r"^void ", "", str(name))
    return name.split("(", 1)[0][:120]


def _windows(events: list[dict], span: str | None) -> list[tuple]:
    """The ``[start, end)`` intervals (µs) a measurement covers: every
    occurrence of the ``span`` annotation, or the extent of the whole
    trace."""
    if span is not None:
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in events if e.get("name") == span
                      and e.get("cat") != "gpu_user_annotation")
    if not events:
        return []
    return [(min(float(e["ts"]) for e in events),
             max(float(e["ts"]) + float(e["dur"]) for e in events))]


def _clip(iv: list[tuple], windows: list[tuple]) -> list[tuple]:
    out = []
    for a, b in iv:
        for w0, w1 in windows:
            lo, hi = max(a, w0), min(b, w1)
            if hi > lo:
                out.append((lo, hi))
    return out


def _union_us(iv: list[tuple]) -> float:
    total, end = 0.0, None
    for a, b in sorted(iv):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _device_op_durations(trace_dir: str, span: str | None = None
                         ) -> dict[str, float]:
    """Per-operation total device time (ns) of the newest trace in
    ``trace_dir`` — kernels, copies and fills — within the ``span``
    annotation's windows when one is named. Empty for a trace without
    device activity (a CPU run)."""
    events = _trace_events(trace_dir)
    wins = _windows(events, span) if span is not None else None
    per_op: dict[str, float] = {}
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))]
        if wins is not None:
            iv = _clip(iv, wins)
        us = sum(b - a for a, b in iv)
        if us > 0:
            name = _op_name(e.get("name", "?"))
            per_op[name] = per_op.get(name, 0.0) + us * 1e3
    return per_op


def trace_time_split(trace_dir: str, span: str | None = None) -> dict:
    """Split a captured trace's device time into kernel and transfer
    (copy and fill) time, and measure how busy the device was: ``busy_ms`` is the
    union of the device intervals (concurrent work counted once),
    ``window_ms`` the measured window — every occurrence of the ``span``
    annotation (:data:`NULL_SPAN` for the null), else the whole trace —
    and ``busy_frac`` / ``idle_frac`` their ratio and its complement.
    All zeros on a trace without device activity."""
    events = _trace_events(trace_dir)
    wins = _windows(events, span)
    split = {"kernel_ms": 0.0, "transfer_ms": 0.0}
    busy = []
    for e in events:
        cat = e.get("cat")
        if cat not in _DEVICE_CATS:
            continue
        iv = _clip([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))],
                   wins)
        busy += iv
        moves = cat != "kernel" or _TRANSFER_OPS.search(str(e.get("name")))
        split["transfer_ms" if moves else "kernel_ms"] += sum(
            b - a for a, b in iv) / 1e3
    total = sum(split.values())
    window = sum(b - a for a, b in wins) / 1e3
    busy_ms = _union_us(busy) / 1e3
    split.update(
        total_ms=total,
        transfer_frac=(split["transfer_ms"] / total) if total else 0.0,
        busy_ms=busy_ms, window_ms=window,
        busy_frac=(busy_ms / window) if window else 0.0,
        idle_frac=(1.0 - busy_ms / window) if window else 0.0,
    )
    return split


def summarize_trace(trace_dir: str, top: int = 20, split: bool = False,
                    span: str | None = None):
    """The captured trace's device operations ranked by device time:
    ``[(op_name, total_ms, percent), ...]`` (empty for a trace without
    device activity), within the ``span`` annotation's windows when one
    is named. With ``split=True`` returns ``(rows, split_dict)``, the
    second :func:`trace_time_split`'s."""
    per_op = _device_op_durations(trace_dir, span)
    total = sum(per_op.values())
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    rows = [
        (name, ns / 1e6, (ns / total * 100.0) if total else 0.0)
        for name, ns in ranked
    ]
    if split:
        return rows, trace_time_split(trace_dir, span)
    return rows
