"""Run telemetry: a structured event bus and a metrics registry.

The port of ``netrep_tpu/utils/telemetry.py``: the same event schema
(version :data:`SCHEMA_VERSION`, one JSON object per line with exactly the
keys of :data:`EVENT_KEYS`), the same event-name registries, the same
folding rule (:meth:`MetricsRegistry.fold`) and the same span model, so a
JSONL written by either package reads through the other's aggregator.

- :class:`Telemetry` — a run-scoped bus with a crash-safe append-only
  JSONL sink (one flushed line per event) and an in-memory
  :class:`MetricsRegistry` folded from the same events.
- :class:`StallWatchdog` — a monotonic-clock heartbeat armed per null run;
  when no chunk lands within ``factor`` × the measured steady chunk time it
  emits ``stall_suspected`` and warns once, and with a fault policy it
  escalates to the fault ladder's abandon (warn → act).
- ambient activation (:meth:`Telemetry.activate` / :func:`current`) so
  leaf modules (checkpoint, backend) emit without a handle.
- the offline readers :func:`read_events`, :func:`aggregate_file`,
  :func:`format_event`, :func:`render_recovery`, the all-pairs grid's
  :func:`grid_summary` and :func:`render_grid`, and the single server's
  :func:`tenant_summary` and :func:`render_tenants`, and the serving
  fleet's :func:`replica_summary` and :func:`render_replicas`.

Spans ride ``data`` as additive fields: ``data["span"]`` names the span
(a run-unique deterministic id ``s<n>``) and ``data["parent"]`` its
enclosing span, attached automatically from the ambient span stack.

Telemetry is off by default; a disabled run pays one ``None`` check per
run and its results are bit-identical — telemetry only ever observes.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
import uuid
from typing import Callable, Iterable, Iterator

logger = logging.getLogger("netrep_tpu_torch")

#: version of the event line shape; bump when keys or their meaning change
SCHEMA_VERSION = 1

#: exact top-level keys of every event line, in serialization order
EVENT_KEYS = ("v", "t", "m", "run", "ev", "data")

#: numeric data fields that accumulate (counters); every other numeric
#: field is a gauge (last value wins) unless it times something (``s`` /
#: ``*_s`` suffix → histogram). One rule, shared by the live registry and
#: the offline aggregator, so the two views cannot drift.
_SUM_FIELDS = frozenset({
    "dispatches", "host_bytes", "perms", "take", "bytes", "n_retired",
    "bytes_to_host",
})

#: The event-name registries, the JAX package's names one for one: the
#: schema the offline readers and dashboards key on. The port emits the
#: recovery, engine and span names, the grid names (from
#: :func:`~netrep_tpu_torch.models.grid.grid_preservation`) and the
#: serving names (from :mod:`netrep_tpu_torch.serve.scheduler`); the
#: fleet and forensic names belong to slices not ported yet and are kept
#: so one registry reads both packages' files.

#: recovery-path events: every decision of the fault ladder and the stall
#: watchdog (:func:`render_recovery` draws them as a timeline)
RECOVERY_EVENTS = (
    "fault_injected", "retry_attempt", "chunk_abandoned", "stall_suspected",
    "stall_recovered", "device_lost", "mesh_shrunk", "mesh_grown",
    "degraded_to_cpu", "checkpoint_async_flush",
    "fingerprint_degraded_accept", "backend_fallback",
    "distributed_autodetect_failed",
)

#: serving-path events (per-request lifecycle, each with a ``tenant``)
SERVE_EVENTS = (
    "request_received", "request_packed", "request_done",
    "request_rejected", "request_expired", "request_deduped",
    "serve_brownout_enter", "serve_brownout_exit", "journal_replayed",
    "request_malformed", "request_requeued", "request_cost",
)

#: fleet-serving events (replica lifecycle, each with a ``replica``)
FLEET_EVENTS = (
    "replica_joined", "replica_lost", "journal_shipped", "failover_start",
    "failover_done", "ring_rebalanced", "replica_state", "autoscale_up",
    "autoscale_down", "scale_to_zero", "spawn_on_demand", "evict_notice",
    "evict_handoff_done",
)

#: latency histogram bucket upper bounds (seconds) of the serving series;
#: a final +Inf bucket is implicit
LATENCY_BUCKETS_S = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0,
)

#: attributed-cost histogram bucket upper bounds (device seconds)
COST_BUCKETS_S = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0,
)


class BucketHistogram:
    """Fixed-boundary cumulative-style histogram (the Prometheus shape):
    per-bucket counts over pinned upper bounds plus a +Inf overflow
    bucket, with count/sum and a quantile estimator — the p50/p99 the
    serve plane's ops surface reports without storing every sample.

    Quantiles interpolate linearly inside the winning bucket (0 as the
    lower edge of the first), the standard Prometheus
    ``histogram_quantile`` convention — an estimate bounded by the pinned
    boundaries, not an exact order statistic."""

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("bucket boundaries must be ascending")
        self.counts = [0] * (len(self.buckets) + 1)   # +Inf last
        self.n = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.n += 1
        self.total += v
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q: float) -> float | None:
        """Estimated q-quantile (0..1), or None for an empty histogram.
        The +Inf bucket degrades to the last finite boundary — a bounded
        answer beats an unbounded guess on an ops dashboard."""
        if self.n == 0:
            return None
        rank = q * self.n
        cum = 0
        for i, c in enumerate(self.counts):
            prev = cum
            cum += c
            if cum >= rank and c:
                if i >= len(self.buckets):
                    return self.buckets[-1] if self.buckets else 0.0
                lo = self.buckets[i - 1] if i else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * ((rank - prev) / c)
        return self.buckets[-1] if self.buckets else 0.0

    def prom_lines(self, name: str, labels: str = "") -> list[str]:
        """Prometheus histogram exposition lines (cumulative ``le``
        buckets + ``_count``/``_sum``); ``labels`` is the pre-rendered
        inner label list (e.g. ``tenant="a"``)."""
        sep = "," if labels else ""
        out = []
        cum = 0
        for b, c in zip(self.buckets, self.counts):
            cum += c
            out.append(
                f'{name}_bucket{{{labels}{sep}le="{b:g}"}} {cum}'
            )
        out.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {self.n}')
        out.append(f"{name}_count{{{labels}}} {self.n}")
        out.append(f"{name}_sum{{{labels}}} {self.total:g}")
        return out

    def state(self) -> dict:
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "n": self.n, "sum": self.total}


#: null-loop progress, autotune, checkpoint and atlas tile events
ENGINE_EVENTS = (
    "allgather", "aot_export", "aot_load", "aot_store_miss", "autotune_hit",
    "autotune_miss", "autotune_record", "backend_probe", "checkpoint_saved",
    "checkpoint_resumed", "chunk", "compile_span", "dispatch",
    "distributed_init", "module_retired", "null_pass_end",
    "rescue_dispatch", "roofline", "superchunk", "tail_fit",
    "tail_trim_skipped", "tile", "tile_screen",
)

#: span begin/end events: the node names of the trace tree
SPAN_EVENTS = (
    "null_run_start", "null_run_end", "observed", "pack", "pair_start",
    "pair_end", "run_start", "run_end", "serve_start", "serve_end",
    "tile_pass_start", "tile_pass_end", "warmup_start", "warmup_end",
)

#: all-pairs grid events
GRID_EVENTS = (
    "grid_start", "grid_end", "grid_cell_start", "grid_cell_done",
    "grid_dedup_hit", "grid_warmstart_seeded",
)

#: incident-forensics events (detectors, flight recorder, bundles)
FORENSIC_EVENTS = (
    "anomaly_detected", "flightrec_dump", "bundle_written",
)

#: every registry above, nothing else
KNOWN_EVENTS = frozenset(
    ENGINE_EVENTS + RECOVERY_EVENTS + SERVE_EVENTS + FLEET_EVENTS
    + SPAN_EVENTS + GRID_EVENTS + FORENSIC_EVENTS
)


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


class MetricsRegistry:
    """Counters / gauges / histogram summaries folded from an event
    stream. ``histograms`` keeps ``[n, total, min, max]`` per name —
    enough for mean/extremes without unbounded storage."""

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, list[float]] = {}
        self.n_events = 0
        self.runs: set[str] = set()
        self.t_first: float | None = None
        self.t_last: float | None = None

    # -- folding -----------------------------------------------------------

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, v: float) -> None:
        self.gauges[name] = v

    def observe(self, name: str, v: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            self.histograms[name] = [1, float(v), float(v), float(v)]
        else:
            h[0] += 1
            h[1] += float(v)
            h[2] = min(h[2], float(v))
            h[3] = max(h[3], float(v))

    def fold(self, ev: str, data: dict, t: float | None = None,
             run: str | None = None) -> None:
        """THE aggregation rule: event count → ``<ev>.count`` counter;
        numeric fields → ``<ev>.<field>`` histogram (``s``/``*_s``),
        counter (:data:`_SUM_FIELDS`), or gauge (everything else)."""
        self.n_events += 1
        if run:
            self.runs.add(run)
        if t is not None:
            self.t_first = t if self.t_first is None else self.t_first
            self.t_last = t
        self.count(f"{ev}.count")
        for k, v in data.items():
            if not _is_number(v):
                continue
            name = f"{ev}.{k}"
            if k == "s" or k.endswith("_s"):
                self.observe(name, v)
            elif k in _SUM_FIELDS:
                self.count(name, v)
            else:
                self.gauge(name, v)

    # -- views -------------------------------------------------------------

    def as_dict(self) -> dict:
        return {
            "n_events": self.n_events,
            "runs": sorted(self.runs),
            "span_s": (
                self.t_last - self.t_first
                if self.t_first is not None else None
            ),
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {
                k: {"n": h[0], "total": h[1], "min": h[2], "max": h[3],
                    "mean": h[1] / h[0]}
                for k, h in self.histograms.items()
            },
        }

    def render_summary(self) -> str:
        """Human summary table of the aggregated run(s)."""
        out = []
        span = (
            f", span {self.t_last - self.t_first:.1f}s"
            if self.t_first is not None else ""
        )
        runs = ", ".join(sorted(self.runs)) or "-"
        out.append(f"telemetry: {self.n_events} events, run(s) {runs}{span}")
        rec = {
            ev: self.counters[f"{ev}.count"]
            for ev in RECOVERY_EVENTS if f"{ev}.count" in self.counters
        }
        if rec:
            # surface the recovery story first: a run that retried/degraded
            # its way to completion should say so before the raw counters
            out.append("recovery:")
            w = max(len(k) for k in rec)
            for k in RECOVERY_EVENTS:
                if k in rec:
                    out.append(f"  {k:<{w}}  {rec[k]:g}")
        if self.counters:
            out.append("counters:")
            w = max(len(k) for k in self.counters)
            for k in sorted(self.counters):
                v = self.counters[k]
                out.append(f"  {k:<{w}}  {v:g}")
        if self.gauges:
            out.append("gauges:")
            w = max(len(k) for k in self.gauges)
            for k in sorted(self.gauges):
                out.append(f"  {k:<{w}}  {self.gauges[k]:g}")
        if self.histograms:
            out.append("timings:")
            w = max(len(k) for k in self.histograms)
            out.append(
                f"  {'':<{w}}  {'n':>6} {'total_s':>10} {'mean_s':>10} "
                f"{'min_s':>10} {'max_s':>10}"
            )
            for k in sorted(self.histograms):
                n, tot, lo, hi = self.histograms[k]
                out.append(
                    f"  {k:<{w}}  {n:>6} {tot:>10.3f} {tot / n:>10.3f} "
                    f"{lo:>10.3f} {hi:>10.3f}"
                )
        return "\n".join(out)

    def render_prometheus(self, prefix: str = "netrep") -> str:
        """Prometheus text exposition of the registry — the scrape surface
        of a metrics scraper."""

        def san(name: str) -> str:
            return "".join(
                c if c.isalnum() or c == "_" else "_" for c in name
            )

        lines = []
        for k in sorted(self.counters):
            n = f"{prefix}_{san(k)}_total"
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {self.counters[k]:g}")
        for k in sorted(self.gauges):
            n = f"{prefix}_{san(k)}"
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {self.gauges[k]:g}")
        for k in sorted(self.histograms):
            cnt, tot, lo, hi = self.histograms[k]
            n = f"{prefix}_{san(k)}"
            lines.append(f"# TYPE {n} summary")
            lines.append(f"{n}_count {cnt:g}")
            lines.append(f"{n}_sum {tot:g}")
            lines.append(f"{n}_min {lo:g}")
            lines.append(f"{n}_max {hi:g}")
        return "\n".join(lines) + ("\n" if lines else "")


class Telemetry:
    """Run-scoped event bus: JSONL sink + live :class:`MetricsRegistry`.

    Parameters
    ----------
    path : JSONL sink path (append-only; parent dirs created), or None for
        an in-memory-only bus (registry still folds — used by tests and
        short-lived tooling).
    run_id : identity stamped on every event; defaults to a fresh 8-hex id.
    clock / wall : injectable monotonic / wall clocks (fake-clock tests).
    stall_factor / watchdog_poll_s : defaults the null loops hand to the
        :class:`StallWatchdog` they arm per run.

    Thread-safe: the watchdog thread and the main loop share the sink and
    registry under one lock. Emit failures (full disk, revoked path) warn
    once and disable the sink — telemetry must never turn a working run
    into a failing one.
    """

    def __init__(
        self,
        path: str | os.PathLike | None = None,
        run_id: str | None = None,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
        stall_factor: float = 10.0,
        watchdog_poll_s: float = 5.0,
    ):
        self.path = os.fspath(path) if path is not None else None
        self.run_id = run_id or uuid.uuid4().hex[:8]
        self.clock = clock
        self.wall = wall
        self.stall_factor = float(stall_factor)
        self.watchdog_poll_s = float(watchdog_poll_s)
        self.metrics = MetricsRegistry()
        self._lock = threading.Lock()
        self._subscribers: list[Callable[[dict], None]] = []
        self._fh = None
        self._sink_dead = False
        # hierarchical spans: deterministic per-bus id counter +
        # the ambient span stack leaf events auto-parent against. The stack
        # is shared across threads on purpose — the watchdog thread's
        # stall events belong to whatever span the loop thread has open.
        self._span_seq = 0
        self._span_stack: list[str] = []
        self._span_t0: dict[str, float] = {}
        if self.path is not None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")

    # -- bus ---------------------------------------------------------------

    def subscribe(self, fn: Callable[[dict], None]) -> None:
        """Register an in-process observer called with each event dict."""
        self._subscribers.append(fn)

    def emit(self, ev: str, **data) -> dict:
        """Append one event to the sink (flushed — crash loses at most the
        in-flight line), fold it into the registry, notify subscribers.

        When the caller passes neither ``span`` nor ``parent`` and a span
        is open on the ambient stack, ``data["parent"]`` is attached
        automatically — point events always land under the span that was
        live when they fired (acceptance: every chunk/dispatch/retry event
        owned by exactly one parent span)."""
        if "span" not in data and "parent" not in data:
            parent = self.current_span()
            if parent is not None:
                data["parent"] = parent
        record = {
            "v": SCHEMA_VERSION,
            "t": self.wall(),
            "m": self.clock(),
            "run": self.run_id,
            "ev": str(ev),
            "data": data,
        }
        with self._lock:
            self.metrics.fold(record["ev"], data, t=record["t"],
                              run=self.run_id)
            if self._fh is not None and not self._sink_dead:
                try:
                    self._fh.write(
                        json.dumps(record, default=_json_default) + "\n"
                    )
                    self._fh.flush()
                except (OSError, ValueError):
                    self._sink_dead = True
                    logger.warning(
                        "telemetry sink %r failed; further events are "
                        "registry-only", self.path,
                    )
        for fn in self._subscribers:
            try:
                fn(record)
            # netrep: allow(exception-taxonomy) — telemetry only observes: a raising subscriber is logged, the run continues bit-identically
            except Exception:  # observers must never break the run
                logger.warning("telemetry subscriber raised", exc_info=True)
        hook = _FLIGHT_OBSERVER
        if hook is not None:
            try:
                hook(self, record)
            # netrep: allow(exception-taxonomy) — the flight recorder only observes: a ring/detector bug must never break the run it records
            except Exception:
                logger.warning("flight observer raised", exc_info=True)
        return record

    # -- hierarchical spans ------------------------------------------------

    def new_span_id(self) -> str:
        """Allocate a run-unique, deterministic span id (``s<n>``): a
        counter, not a UUID, so the same run produces the same tree —
        pinned by the fault-harness determinism test."""
        with self._lock:
            self._span_seq += 1
            return f"s{self._span_seq}"

    def current_span(self) -> str | None:
        """Innermost open span id, or None outside any span."""
        with self._lock:
            return self._span_stack[-1] if self._span_stack else None

    def _push_span(self, span_id: str) -> None:
        with self._lock:
            self._span_stack.append(span_id)

    def _pop_span(self, span_id: str) -> None:
        with self._lock:
            for i in range(len(self._span_stack) - 1, -1, -1):
                if self._span_stack[i] == span_id:
                    del self._span_stack[i]
                    break

    @contextlib.contextmanager
    def pushed(self, span_id: str):
        """Make an externally allocated span id the ambient parent for the
        block — how a chunk dispatch adopts its chunk's span so retry /
        fault / stall events emitted inside nest under that chunk."""
        self._push_span(span_id)
        try:
            yield span_id
        finally:
            self._pop_span(span_id)

    @contextlib.contextmanager
    def span(self, ev: str, **data):
        """Timed span: measures the block's duration on the monotonic
        clock and emits ``ev`` with an ``s`` field on exit (also on error,
        with ``error`` naming the exception type). The single closing
        event carries the span's id and parent, and events emitted inside
        the block auto-parent to it."""
        sid = self.new_span_id()
        parent = self.current_span()
        if parent is not None:
            data.setdefault("parent", parent)
        self._push_span(sid)
        t0 = self.clock()
        try:
            yield self
        except BaseException as e:
            self._pop_span(sid)
            self.emit(ev, s=self.clock() - t0, span=sid,
                      error=type(e).__name__, **data)
            raise
        else:
            self._pop_span(sid)
            self.emit(ev, s=self.clock() - t0, span=sid, **data)

    def begin_span(self, ev: str, **data) -> str:
        """Open a span whose begin and end are *separate events* (the loop
        shape: ``null_run_start`` … ``null_run_end``): emits ``ev`` now
        carrying the new span id (+ parent), pushes the id on the ambient
        stack, and returns it for :meth:`end_span`."""
        sid = self.new_span_id()
        parent = self.current_span()
        if parent is not None:
            data.setdefault("parent", parent)
        self.emit(ev, span=sid, **data)
        with self._lock:
            self._span_stack.append(sid)
            self._span_t0[sid] = self.clock()
        return sid

    def end_span(self, span_id: str, ev: str, **data) -> dict:
        """Close a :meth:`begin_span` span: pops it and emits the closing
        ``ev`` with the same span id. ``s`` defaults to the span's measured
        duration on this bus's clock; callers with their own timing (the
        null loops use ``perf_counter``) pass ``s=`` explicitly."""
        self._pop_span(span_id)
        with self._lock:
            t0 = self._span_t0.pop(span_id, None)
        if "s" not in data and t0 is not None:
            data["s"] = self.clock() - t0
        return self.emit(ev, span=span_id, **data)

    # -- ambient activation ------------------------------------------------

    @contextlib.contextmanager
    def activate(self):
        """Make this bus the ambient telemetry (:func:`current`) for the
        dynamic extent — how leaf modules (checkpoint/backend/
        distributed) emit without signature threading."""
        _ACTIVE.append(self)
        try:
            yield self
        finally:
            _ACTIVE.remove(self)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def _json_default(v):
    """Tolerant serialization: numpy scalars/arrays ride events as plain
    JSON numbers/lists without this module importing numpy."""
    for attr in ("item",):  # numpy scalar
        if hasattr(v, attr) and not hasattr(v, "__len__"):
            return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return str(v)


#: ambient telemetry stack (innermost active bus wins)
_ACTIVE: list[Telemetry] = []

#: process-wide flight-recorder observer: called as
#: ``hook(bus, record)`` with every event emitted on ANY bus — outside
#: the bus lock, after subscribers, exception-suppressed. One slot, not a
#: list: the flight recorder is a singleton plane, and a single slot
#: keeps the disabled path a None check.
_FLIGHT_OBSERVER = None


def set_flight_observer(fn) -> None:
    """Install (or clear, with None) the process-wide flight observer —
    the seam a flight recorder captures through."""
    global _FLIGHT_OBSERVER
    _FLIGHT_OBSERVER = fn


def current() -> Telemetry | None:
    """The ambient :class:`Telemetry`, or None when telemetry is off."""
    return _ACTIVE[-1] if _ACTIVE else None


def resolve(explicit: Telemetry | None) -> Telemetry | None:
    """Explicit handle if given, else the ambient bus — resolved ONCE per
    run by the null loops, so the disabled hot path pays one check."""
    return explicit if explicit is not None else current()


#: default sink when ``telemetry=True`` is passed to the public API
DEFAULT_SINK = "netrep_telemetry.jsonl"


def resolve_arg(arg) -> tuple[Telemetry | None, bool]:
    """``telemetry=`` public-API argument → ``(bus, owned)``: None/False =
    off; True = the default sink in the CWD; a path = JSONL there; an
    existing :class:`Telemetry` passes through un-owned (the caller closes
    it). ``owned`` tells the API layer to close the bus it created."""
    if arg is None or arg is False:
        return None, False
    if isinstance(arg, Telemetry):
        return arg, False
    if arg is True:
        return Telemetry(os.path.join(os.getcwd(), DEFAULT_SINK)), True
    return Telemetry(arg), True


# ---------------------------------------------------------------------------
# Stall watchdog
# ---------------------------------------------------------------------------


class StallWatchdog:
    """Monotonic-clock heartbeat for one null run.

    The null loops :meth:`beat` once per landed chunk; the watchdog
    measures the steady-state chunk time (median inter-beat interval,
    FIRST interval excluded — it absorbs the kernels' build or load) and,
    when no chunk lands within ``factor``× that time, emits one
    ``stall_suspected`` event and warns once via the ``netrep_tpu_torch``
    logger. A loop thread blocked in a synchronisation on a hung kernel
    cannot notice — but this daemon thread can.

    ``poll_interval <= 0`` disables the thread; :meth:`poll` can then be
    driven manually (fake-clock tests). Until ``min_intervals`` steady
    intervals are measured the watchdog stays silent — it never guesses a
    baseline.

    A chunk landing after a fired stall emits ``stall_recovered`` (with
    the stalled-for duration) and RE-ARMS the warning, so a second stall
    in the same run warns again instead of staying silent after a
    one-shot warning.

    Warn → act escalation: with ``action`` set, a stall that
    outlasts ``action_factor`` × the steady chunk time invokes
    ``action()`` ONCE per stall episode from the watchdog thread — the
    fault runtime uses this to checkpoint completed work and abandon the
    hung dispatch (the loop thread is blocked inside it and cannot act).
    """

    def __init__(
        self,
        telemetry: Telemetry,
        factor: float = 10.0,
        min_intervals: int = 2,
        poll_interval: float = 5.0,
        clock: Callable[[], float] | None = None,
        action: Callable[[], None] | None = None,
        action_factor: float | None = None,
    ):
        self.telemetry = telemetry
        self.factor = float(factor)
        self.min_intervals = int(min_intervals)
        self.poll_interval = float(poll_interval)
        self.clock = clock if clock is not None else telemetry.clock
        self.action = action
        self.action_factor = (
            float(action_factor) if action_factor is not None else None
        )
        self._lock = threading.Lock()
        self._last: float | None = None
        self._beats = 0
        self._intervals: list[float] = []
        self._fired = False
        self._warned = False
        self._acted = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def arm(self) -> None:
        """Start the heartbeat clock (call when the run's first dispatch
        is issued)."""
        with self._lock:
            self._last = self.clock()

    def beat(self) -> None:
        """One chunk landed: record the interval and reset the stall. A
        beat that ends a fired stall episode emits ``stall_recovered``
        and re-arms the one-per-episode warning and action."""
        now = self.clock()
        with self._lock:
            stalled_s = (
                now - self._last
                if self._fired and self._last is not None else None
            )
            if (self._last is not None and self._beats >= 1
                    and stalled_s is None):
                # the interval ending at beat 1 absorbed the first chunk's
                # compile — steady state starts at beat 2. An interval
                # that ends a FIRED stall episode is excluded too: folding
                # the stalled duration into the median silently inflates
                # steady_s, and a second comparable stall then never
                # crosses factor × steady — the re-armed warning and
                # action would go quiet exactly when they matter.
                self._intervals.append(now - self._last)
            self._beats += 1
            beats = self._beats
            self._last = now
            self._fired = False
            self._warned = False
            self._acted = False
        if stalled_s is not None:
            self.telemetry.emit(
                "stall_recovered", stalled_s=stalled_s, chunks_done=beats,
            )
            logger.warning(
                "backend recovered: a chunk landed after a %.1fs stall; "
                "the run continues", stalled_s,
            )

    def steady_s(self) -> float | None:
        """Median steady-state chunk time, or None before enough beats."""
        with self._lock:
            iv = list(self._intervals)
        if len(iv) < self.min_intervals:
            return None
        return sorted(iv)[len(iv) // 2]

    def poll(self) -> bool:
        """Check the heartbeat; emit/warn when stalled, escalate to the
        ``action`` when the stall outlasts ``action_factor`` × steady.
        Returns whether a stall was (newly) flagged."""
        steady = self.steady_s()
        act = None
        with self._lock:
            if self._last is None or steady is None:
                return False
            elapsed = self.clock() - self._last
            if elapsed <= self.factor * steady:
                return False
            newly = not self._fired
            self._fired = True
            warn = not self._warned
            self._warned = True
            beats = self._beats
            if (self.action is not None and self.action_factor is not None
                    and elapsed > self.action_factor * steady
                    and not self._acted):
                self._acted = True
                act = self.action
        if newly:
            self.telemetry.emit(
                "stall_suspected", elapsed_s=elapsed, steady_chunk_s=steady,
                factor=self.factor, chunks_done=beats,
            )
        if warn:
            logger.warning(
                "no chunk completed in %.1fs (> %.0fx the %.2fs "
                "steady-state chunk time) — the backend may be stalled "
                "(a hung kernel or a lost card?); the run will continue if it "
                "recovers",
                elapsed, self.factor, steady,
            )
        if act is not None:
            # the JAX package also routes this verdict through its
            # detector registry (ROADMAP.md Queue 1 item 16b)
            try:
                act()
            # netrep: allow(exception-taxonomy) — escalation action is best-effort; the watchdog must keep polling for the next stall
            except Exception:  # the action must never kill the watchdog
                logger.warning("stall watchdog action raised", exc_info=True)
        return newly

    # -- thread ------------------------------------------------------------

    def start(self) -> None:
        if self.poll_interval <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="netrep-stall-watchdog", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.poll()
            # netrep: allow(exception-taxonomy) — observer thread: a poll bug must degrade to a warning, never kill the monitored run
            except Exception:  # pragma: no cover - must never kill the run
                logger.warning("stall watchdog poll raised", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        self.arm()
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def arm_watchdog(
    telemetry: Telemetry | None,
    action: Callable[[], None] | None = None,
    action_factor: float | None = None,
) -> StallWatchdog | None:
    """Per-null-run watchdog construction shared by the loops: None when
    telemetry is off (the disabled hot path stays a ``None`` check).
    ``action``/``action_factor`` wire the fault runtime's warn→act
    escalation when a fault policy is active."""
    if telemetry is None:
        return None
    wd = StallWatchdog(
        telemetry, factor=telemetry.stall_factor,
        poll_interval=telemetry.watchdog_poll_s,
        action=action, action_factor=action_factor,
    )
    wd.arm()
    wd.start()
    return wd


# ---------------------------------------------------------------------------
# Offline aggregation
# ---------------------------------------------------------------------------


def is_event(row: dict) -> bool:
    """Whether a parsed JSON object is a telemetry event line, so mixed
    logs split cleanly."""
    return (
        isinstance(row, dict)
        and row.get("v") == SCHEMA_VERSION
        and isinstance(row.get("ev"), str)
        and isinstance(row.get("data"), dict)
    )


def read_events(path: str) -> Iterator[dict]:
    """Stream the event lines of a JSONL file, skipping anything that is
    not a schema-matching event (the sink may share a file with other
    JSONL rows — bench metric lines, watcher headers)."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if is_event(row):
                yield row


def aggregate_events(events: Iterable[dict]) -> MetricsRegistry:
    """Fold an event stream into a fresh registry — by construction the
    same numbers the emitting process's live registry held."""
    reg = MetricsRegistry()
    for e in events:
        reg.fold(e["ev"], e["data"], t=e.get("t"), run=e.get("run"))
    return reg


def aggregate_file(path: str) -> MetricsRegistry:
    """Aggregate a telemetry JSONL into a registry (offline report)."""
    return aggregate_events(read_events(path))


def tenant_summary(events: Iterable[dict]) -> dict[str, dict]:
    """Per-tenant aggregation of the serving events (:data:`SERVE_EVENTS`):
    request counts per outcome, latency stats from ``request_done.s``,
    permutations served and the attributed cost of ``request_cost`` — the
    offline twin of the server's live per-tenant counters, derived from
    the same event stream so the two views cannot disagree."""
    out: dict[str, dict] = {}
    for e in events:
        ev = e.get("ev")
        if ev not in SERVE_EVENTS:
            continue
        data = e.get("data", {})
        tenant = data.get("tenant")
        if tenant is None:
            continue
        row = out.setdefault(str(tenant), {
            "received": 0, "packed": 0, "done": 0, "failed": 0,
            "rejected": 0, "expired": 0, "deduped": 0, "perms": 0,
            "latency": [0, 0.0, float("inf"), 0.0],  # n, total, min, max
            "device_s": 0.0, "cost_bytes": 0,
        })
        if ev == "request_cost":
            if _is_number(data.get("device_s")):
                row["device_s"] += float(data["device_s"])
            if _is_number(data.get("bytes_to_host")):
                row["cost_bytes"] += int(data["bytes_to_host"])
        elif ev == "request_received":
            row["received"] += 1
        elif ev == "request_packed":
            row["packed"] += 1
        elif ev == "request_rejected":
            row["rejected"] += 1
        elif ev == "request_expired":
            row["expired"] += 1
        elif ev == "request_deduped":
            row["deduped"] += 1
        elif ev == "request_done":
            if data.get("ok", True):
                row["done"] += 1
            else:
                row["failed"] += 1
            row["perms"] += int(data.get("perms", 0) or 0)
            s = data.get("s")
            if _is_number(s):
                lat = row["latency"]
                lat[0] += 1
                lat[1] += float(s)
                lat[2] = min(lat[2], float(s))
                lat[3] = max(lat[3], float(s))
    return out


def render_tenants(path: str) -> str:
    """Per-tenant serving section of a telemetry report: one row per
    tenant with outcome counts and latency stats. Empty string for logs
    without serving events."""
    rows = tenant_summary(read_events(path))
    if not rows:
        return ""
    out = ["tenants:"]
    w = max(len(t) for t in rows)
    out.append(
        f"  {'':<{w}}  {'recv':>5} {'done':>5} {'fail':>5} {'rej':>5} "
        f"{'exp':>5} {'dedup':>5} {'perms':>8} {'mean_s':>8} {'max_s':>8} "
        f"{'dev_s':>8}"
    )
    for t in sorted(rows):
        r = rows[t]
        n, tot, _lo, hi = r["latency"]
        mean = tot / n if n else float("nan")
        hi = hi if n else float("nan")
        out.append(
            f"  {t:<{w}}  {r['received']:>5} {r['done']:>5} "
            f"{r['failed']:>5} {r['rejected']:>5} {r['expired']:>5} "
            f"{r['deduped']:>5} {r['perms']:>8} "
            f"{mean:>8.3f} {hi:>8.3f} {r['device_s']:>8.3f}"
        )
    return "\n".join(out)


def format_event(e: dict, t0: float | None = None) -> str:
    """One-line human rendering of an event: relative offset, span markers
    (``>`` opens a span, ``<`` closes one with its duration), event name,
    then the data fields."""
    d = e.get("data") or {}
    off = f"+{e['t'] - t0:9.2f}s" if t0 is not None else f"{e['t']:.2f}"
    mark = " "
    if d.get("span") is not None:
        mark = "<" if _is_number(d.get("s")) else ">"
    parts = " ".join(
        f"{k}={v:g}" if _is_number(v) else f"{k}={v}"
        for k, v in d.items() if k not in ("span", "parent")
    )
    return f"{off} {mark} {e['ev']:<24} {parts}"


def render_recovery(path: str) -> str:
    """Chronological timeline of a run's recovery decisions: every
    :data:`RECOVERY_EVENTS` — and, for fleet logs, :data:`FLEET_EVENTS`
    (a replica loss + failover IS a recovery decision; ``failover_done``
    carries the measured failover time as ``s``) — line with its offset
    from the first event in the file, so "what did the run survive, and
    in what order" reads straight off one screen. Empty string when the
    run never recovered from anything."""
    lines = []
    t0 = None
    for e in read_events(path):
        if t0 is None:
            t0 = e["t"]
        if (e["ev"] not in RECOVERY_EVENTS
                and e["ev"] not in FLEET_EVENTS
                and e["ev"] not in FORENSIC_EVENTS):
            continue
        d = dict(e["data"])
        label = ""
        if e["ev"] in FORENSIC_EVENTS:
            # anomaly verdicts read as first-class timeline entries with
            # their detector name up front
            label = f" [detector={d.pop('detector', '-')}]"
        data = " ".join(f"{k}={v}" for k, v in d.items())
        lines.append(f"+{e['t'] - t0:9.2f}s  {e['ev']:<24}{label} {data}")
    return "\n".join(lines)


def replica_summary(events: Iterable[dict]) -> dict[str, dict]:
    """Per-replica aggregation of the fleet events (:data:`FLEET_EVENTS`)
    — the offline twin of the fleet coordinator's live per-replica rows,
    keyed on the ``replica`` label every fleet event carries: joins,
    losses, shipped records/bytes, failovers (count + total measured
    seconds from ``failover_done.s``), noticed evictions (count + total
    handoff seconds from ``evict_handoff_done.s``), and the replica's LAST
    lifecycle state/generation from the ``replica_state`` stream."""
    out: dict[str, dict] = {}
    for e in events:
        ev = e.get("ev")
        if ev not in FLEET_EVENTS:
            continue
        data = e.get("data", {})
        rid = data.get("replica")
        if rid is None:
            continue
        row = out.setdefault(str(rid), {
            "joined": 0, "lost": 0, "shipped_records": 0,
            "shipped_bytes": 0, "failovers": 0, "failover_s": 0.0,
            "evictions": 0, "handoff_s": 0.0, "state": None, "gen": 0,
        })
        if ev == "replica_joined":
            row["joined"] += 1
        elif ev == "replica_lost":
            row["lost"] += 1
        elif ev == "journal_shipped":
            row["shipped_records"] += int(data.get("records", 0) or 0)
            row["shipped_bytes"] += int(data.get("bytes", 0) or 0)
        elif ev == "failover_done":
            row["failovers"] += 1
            if _is_number(data.get("s")):
                row["failover_s"] += float(data["s"])
        elif ev == "evict_notice":
            row["evictions"] += 1
        elif ev == "evict_handoff_done":
            if _is_number(data.get("s")):
                row["handoff_s"] += float(data["s"])
        elif ev == "replica_state":
            row["state"] = data.get("to")
            row["gen"] = int(data.get("gen", 0) or 0)
    return out


def render_replicas(path: str) -> str:
    """Per-replica fleet section of a run report, for logs written by a
    fleet coordinator; empty for logs without fleet events."""
    rows = replica_summary(read_events(path))
    if not rows:
        return ""
    out = ["replicas:"]
    w = max(len(r) for r in rows)
    out.append(
        f"  {'':<{w}}  {'state':>8} {'gen':>3} {'join':>5} {'lost':>5} "
        f"{'ship_rec':>9} {'ship_B':>9} {'failover':>9} {'fo_s':>8} "
        f"{'evict':>5} {'ho_s':>8}"
    )
    for rid in sorted(rows):
        r = rows[rid]
        out.append(
            f"  {rid:<{w}}  {(r['state'] or '-'):>8} {r['gen']:>3} "
            f"{r['joined']:>5} {r['lost']:>5} "
            f"{r['shipped_records']:>9} {r['shipped_bytes']:>9} "
            f"{r['failovers']:>9} {r['failover_s']:>8.3f} "
            f"{r['evictions']:>5} {r['handoff_s']:>8.3f}"
        )
    return "\n".join(out)


def grid_summary(events: Iterable[dict]) -> dict:
    """The all-pairs grid's events (:data:`GRID_EVENTS`) folded per
    DISCOVERY dataset (a grid row shares its discovery side, so dedup and
    warm starts pay off along it), with grid totals: dedup hits, grids and
    their summed wall time from the ``grid_end`` spans. Returns
    ``{"rows": {discovery: {...}}, "grids", "dedup_hits", "wall_s"}``;
    ``rows`` is empty for a log without grid events. The JAX package's
    reader, field for field."""
    rows: dict[str, dict] = {}
    out = {"rows": rows, "grids": 0, "dedup_hits": 0, "wall_s": 0.0}
    for e in events:
        ev = e.get("ev")
        if ev not in GRID_EVENTS:
            continue
        data = e.get("data", {})
        if ev == "grid_dedup_hit":
            out["dedup_hits"] += 1
            continue
        if ev == "grid_end":
            out["grids"] += 1
            if _is_number(data.get("s")):
                out["wall_s"] += float(data["s"])
            continue
        d = data.get("discovery")
        if d is None:
            continue
        row = rows.setdefault(str(d), {
            "started": 0, "computed": 0, "manifest": 0,
            "warmstarted": 0, "perms": 0, "prior_perms": 0,
        })
        if ev == "grid_cell_start":
            row["started"] += 1
        elif ev == "grid_cell_done":
            if data.get("source") == "manifest":
                row["manifest"] += 1
            else:
                row["computed"] += 1
            row["perms"] += int(data.get("perms", 0) or 0)
        elif ev == "grid_warmstart_seeded":
            row["warmstarted"] += 1
            row["prior_perms"] += int(data.get("prior_perms", 0) or 0)
    return out


def render_grid(path: str) -> str:
    """The grid section of a run report: per discovery row, the cells
    computed and answered from the manifest, warm starts and permutations,
    and a totals line with the dedup hits and the grid wall time. Empty
    for a log without grid events."""
    s = grid_summary(read_events(path))
    if not s["rows"] and not s["grids"]:
        return ""
    out = ["grid:",
           f"  grids={s['grids']} dedup_hits={s['dedup_hits']} "
           f"wall_s={s['wall_s']:.3f}"]
    if s["rows"]:
        w = max(len(d) for d in s["rows"])
        out.append(
            f"  {'':<{w}}  {'cells':>5} {'comp':>5} {'manif':>5} "
            f"{'warm':>5} {'perms':>9} {'prior':>9}"
        )
        for d in sorted(s["rows"]):
            r = s["rows"][d]
            out.append(
                f"  {d:<{w}}  {r['started']:>5} {r['computed']:>5} "
                f"{r['manifest']:>5} {r['warmstarted']:>5} "
                f"{r['perms']:>9} {r['prior_perms']:>9}"
            )
    return "\n".join(out)
