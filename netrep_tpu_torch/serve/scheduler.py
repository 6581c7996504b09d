"""The serving core: job queue, scheduler and multi-tenant state.

The port of ``netrep_tpu/serve/scheduler.py``: tenants register datasets
ONCE, then submit many preservation requests against them; the scheduler
packs modules of different queued requests into shared union-bucket
dispatches (:mod:`netrep_tpu_torch.serve.packer`), runs them on warm
pooled engines (:mod:`netrep_tpu_torch.serve.pool`), and returns each
request the numbers its own ``module_preservation()`` call gives (equal
p-values, counts and ``n_perm_used``; on the card the fused-statistics
null rows are bit-equal).

Scheduling policy (the JAX package's):

- **admission control**: a bounded per-tenant queue; a submit over the
  bound is rejected immediately (``request_rejected`` event +
  :class:`QueueFull`) — backpressure, not unbounded latency;
- **weighted round-robin across tenants**: each tenant appears
  ``weight`` times in the scheduling ring, so a heavy tenant cannot
  starve a light one;
- **oldest-deadline-first within a tenant**: requests carry a deadline
  (submit time + ``slo_s`` unless given explicitly); the tenant's most
  urgent request seeds each pack;
- **opportunistic packing**: the seed request's pack key (dataset-pair
  digest + engine-config identity; with ``cross_pair_packing`` the test
  dataset + permutation pool) pulls compatible requests from EVERY
  tenant's queue, up to ``max_pack`` (trimmed to a power of two);
- **SLO mechanism**: each packed request retires at its own ``n_perm``
  ceiling (and by its own stop rule when adaptive) via the engine's
  retirement re-bucketing (:class:`~netrep_tpu_torch.serve.packer.
  PackMonitor`);
- **fault isolation**: every pack runs under the fault ladder
  (``fault_policy``); a failed pack is split and its members re-queued
  solo, so one poisoned request fails alone.

Crash-safe serving: a write-ahead journal (:mod:`netrep_tpu_torch.serve.
journal`; every admission fsynced before it enters the queue, every
completion a terminal record), idempotency keys (a duplicate attaches to
the in-flight request or is answered from the stored result), deadline
enforcement at pack boundaries, brownout load shedding with a
``retry_after_s`` hint, per-pack checkpoints, and journal replay on a
recovering boot (``recover=True``). The ops surface is the telemetry bus
(``serve_start``/``serve_end``, per-request spans, ``request_cost``) and
Prometheus text (:meth:`PreservationServer.metrics_text`).

What the port does its own way:

- ``ServeConfig.device`` (None means ``"cuda"``; without a card the
  server raises ``RuntimeError`` unless given ``device="cpu"``).
- **Registered datasets live on the host**, float32, in pinned memory on
  a card (:func:`~netrep_tpu_torch.models.dataset.to_host`), after the
  input checks ran on the server's device; the servers of one process (a
  fleet's in-process replicas) hold one copy per registration digest
  whose matrices are equal bit for bit (:func:`_share_registration`),
  freed when the last server holding it closes or dies. Registrations grow with every tenant and only the pool is
  bounded, so the card holds only what the pooled engines hold: a pool
  miss gathers the discovery side's blocks on the host and takes the
  test side's device copy, which every pooled engine over that
  registration shares (:func:`~netrep_tpu_torch.serve.pool.
  device_copy`); a pool hit copies nothing. A dataset's digest is the
  JAX package's for the same registration (the inputs sampled as
  float64).
- **Threads**: every pack runs on the scheduler's worker thread (the fault
  ladder's guarded dispatch may add one). The engines need no per-thread
  torch state (no grad mode, no stream set on the caller's thread).
- ``clock`` (a keyword of :class:`PreservationServer`): the clock request
  deadlines are set and checked on, shared with the pack monitor — an
  injectable clock makes deadline behaviour deterministic.
- **A replay skips what it holds**: a journaled registration already
  registered here under the same identity (an inline payload's digest, a
  fixture's parameters) is not checked again — in a fleet every replica
  holds every registration, so a peer adopting a journal re-queues its
  requests without re-reading the datasets.
- ``preload``: after a recovering boot re-registered datasets, one
  background thread builds the pooled engine of up to ``preload_max``
  registered pairs, loads the kernels their statistics launch, and runs
  the observed pass, so the first request finds a warm engine.

Inside a serving fleet (:mod:`~netrep_tpu_torch.serve.fleet`) a server
carries its replica id as ``ServeConfig.fleet_label``: on the card it
builds (or loads from the kernel-library store, :mod:`~netrep_tpu_torch.
utils.aot`) every kernel library at boot, so a spawned or respawned
replica never runs ``nvcc`` on a request's path; its first completed pack
records a cold-start entry to the perf ledger
(:mod:`~netrep_tpu_torch.utils.perfledger`), and the rate estimate falls
back on the ledger's serve history before anything is measured.
``boot`` records the seconds of the boot's library step (each library's
acquisition source) and of its journal open and replay.

``stats()`` carries the roofline ``utilisation`` of the most recent
engine run on the server's own telemetry bus (:func:`~netrep_tpu_torch.
utils.costmodel.last_run_note`; null without a bus), and a tenant whose
SLO burn rate first passes its budget fires the ``slo_burn`` detector
(:mod:`~netrep_tpu_torch.utils.detectors`), latched until the rate falls
back to the budget.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import threading
import time
import uuid
from typing import Callable, Sequence

import numpy as np
import torch

from .. import ops as tops
from ..models import dataset as ds
from ..models.preservation import _overlap_setup
from ..ops import pvalues as pv
from ..utils import costmodel, detectors
from ..utils import telemetry as tm
from ..utils.checkpoint import Stack, content_digest
from ..utils.config import EngineConfig, resolve_device
from ..utils.faults import SimulatedCrash, resolve_runtime
from . import journal as jnl
from .packer import (
    GridPackedEngine, PackedEngine, PackMonitor, RequestPlan, assign_bases,
    run_pack,
)
from .pool import ProgramPool, SharedCopies, device_copy

logger = logging.getLogger("netrep_tpu_torch")


class ServeError(RuntimeError):
    """A request failed (validation, execution, or unknown tenant/dataset)."""


class QueueFull(ServeError):
    """Admission control rejected the request: the tenant's queue is at
    its bound (or the service is in a brownout and shedding load) — back
    off and retry. ``retry_after_s``, when the server can estimate its
    backlog drain time, is the client's hint for WHEN."""

    def __init__(self, msg: str, retry_after_s: float | None = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class ServeConfig:
    """Service knobs (transport-independent).

    ``engine`` is the ONE :class:`EngineConfig` every served run uses —
    pack compatibility requires a shared chunk size and kernel
    configuration, and equality with a direct call requires the caller to
    use the same config. ``device``: None means ``"cuda"``.
    """

    max_queue: int = 64
    max_pack: int = 4
    pool_size: int = 8
    #: batching window: a pack below ``max_pack`` waits up to this long
    #: (or until it is full) for compatible stragglers before dispatching
    #: (0 = dispatch immediately)
    pack_window_s: float = 0.0
    engine: EngineConfig = dataclasses.field(
        default_factory=lambda: EngineConfig(chunk_size=64, autotune=False)
    )
    default_n_perm: int | None = None
    null: str = "overlap"
    background_label: str = "0"
    slo_s: float = 60.0
    fault_policy: object = None
    telemetry: object = None
    #: the device every engine runs on (None means ``"cuda"``)
    device: object = None
    #: write-ahead journal path; None = journaling off (no fsyncs, no
    #: dedup map persistence)
    journal: str | None = None
    #: replay ``journal`` on boot: re-register datasets, load completed
    #: results into the idempotency map, re-queue accepted-but-unfinished
    #: requests in original order
    recover: bool = False
    #: per-pack checkpoint directory; default (None) derives
    #: ``<journal>.ckpt`` when journaling is on, so a crash mid-pack
    #: resumes from the last chunk boundary instead of recomputing
    checkpoint_dir: str | None = None
    #: chunk-boundary checkpoint cadence for packed runs (permutations)
    checkpoint_every: int = 4096
    #: enforce request deadlines (submit + slo_s, or the explicit
    #: ``deadline_s``): expired requests are cancelled at pack boundaries
    #: via retirement re-bucketing (``request_expired``); False keeps the
    #: deadline as a sort key only
    enforce_deadlines: bool = True
    #: brownout admission control: when the estimated backlog drain time
    #: exceeds this, the server sheds new load from the lowest-weight
    #: tenants with a ``retry_after_s`` hint; None disables. Exit at
    #: ``brownout_exit_s`` (default: half of enter — hysteresis)
    brownout_enter_s: float | None = None
    brownout_exit_s: float | None = None
    #: assumed steady-state throughput (perms/s) before the server has
    #: measured its own; without either, brownout stays off
    brownout_rate_pps: float | None = None
    #: optional brownout degradation: cap admitted requests' n_perm at
    #: this while browned out (EXPLICITLY changes results; off by default)
    brownout_nperm_cap: int | None = None
    #: completed requests kept in the in-memory idempotency map (oldest
    #: evicted beyond this; in-flight requests never evict)
    idem_cache: int = 4096
    #: error budget: the tolerated fraction of requests missing their
    #: ``slo_s`` inside the sliding window; burn rate = observed miss
    #: fraction / budget
    slo_budget: float = 0.01
    #: sliding window (seconds) the burn rate is computed over
    slo_window_s: float = 300.0
    #: boot-time warm pool: after a recovering boot re-registered
    #: datasets, one background thread builds the pooled engine of up to
    #: ``preload_max`` registered (discovery, test) pairs, loads their
    #: kernels and runs the observed pass
    preload: bool = True
    preload_max: int = 4
    #: widen the pack key from the (discovery, test) pair to the TEST
    #: dataset + permutation-pool signature: requests testing different
    #: cohorts' modules in the same test cohort share one dispatch stream
    #: (:class:`~netrep_tpu_torch.serve.packer.GridPackedEngine`). Only
    #: single-test dense requests; off by default
    cross_pair_packing: bool = False
    #: replica identity inside a serving fleet (e.g. ``"r0"``). When set,
    #: the server builds every kernel library at boot on the card, and the
    #: replica's FIRST completed pack records its cold-start compile span
    #: to the perf ledger under a fleet-labeled fingerprint
    #: (``serve-fleet-coldstart|<label>|<backend>``). None = stand-alone
    #: server: libraries load at first use, nothing recorded.
    fleet_label: str | None = None


@dataclasses.dataclass
class Request:
    """One queued analyze request (in-process handle; the transports wrap
    it). ``done`` fires when ``result`` or ``error`` is set."""

    id: str
    tenant: str
    discovery: str
    test: object           # str, or list[str] for the multi-test path
    seed: int
    adaptive: bool
    plan: object           # RequestPlan (single) or _MultiPlan
    pack_key: object       # None = never packed (multi-test / solo-only)
    deadline: float
    submitted_m: float
    seq: int
    sid: str | None = None          # telemetry span id
    #: distributed-trace identity: the client-minted (or server-assigned)
    #: trace id + the caller's parent span id — stamped on the request's
    #: telemetry span, journaled with ``accepted``, stable across a
    #: recovering restart
    trace: str | None = None
    trace_parent: str | None = None
    solo_only: bool = False
    #: durable identity in the write-ahead journal: the client-supplied
    #: idempotency key, or an auto-assigned one
    journal_key: str | None = None
    #: set when a bounded drain journaled this request as
    #: ``drain_requeued`` instead of finishing it
    requeued_on_drain: bool = False
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )
    result: dict | None = None
    error: str | None = None


@dataclasses.dataclass
class _MultiPlan:
    """Plan of a multi-test request (one discovery vs T cohorts sharing a
    node universe) — served through the MultiTestEngine T-axis."""

    plan: RequestPlan               # specs/pool/budget (shared across T)
    test_names: list[str]


class _Tenant:
    def __init__(self, name: str, weight: int):
        self.name = name
        self.weight = max(1, int(weight))
        self.datasets: dict[str, _Dataset] = {}
        self.pending: list[Request] = []
        self.counters = {
            "received": 0, "done": 0, "failed": 0, "rejected": 0,
            "expired": 0, "deduped": 0,
        }
        #: request latency over the pinned bucket boundaries — the p50/p99
        #: source of ``top``, ``stats`` and the Prometheus histogram
        self.lat_hist = tm.BucketHistogram(tm.LATENCY_BUCKETS_S)
        #: attributed device-seconds per request, same contract
        self.cost_hist = tm.BucketHistogram(tm.COST_BUCKETS_S)
        #: attributed cost totals folded from each request_cost
        self.cost = {"device_s": 0.0, "transfer_s": 0.0, "perms": 0,
                     "bytes_to_host": 0, "compile_s_amortized": 0.0}
        #: (monotonic_t, missed_slo) per terminal request — the SLO
        #: burn-rate sliding window
        self.slo_marks: list[tuple[float, bool]] = []
        #: the ``slo_burn`` detector fired for the current excursion
        self.burn_flagged = False


class _Dataset:
    def __init__(self, name: str, dataset, assignments, digest: str,
                 beta=None):
        self.name = name
        self.ds = dataset              # models.dataset.Dataset, on the host
        self.assignments = assignments  # normalized {node: label} or None
        self.digest = digest
        #: data-only derivation spec: the soft-threshold β / (β, kind) the
        #: engines derive submatrices with; None = stored matrices
        self.beta = beta

    def tensors(self) -> list:
        return [t for t in (self.ds.correlation, self.ds.network,
                            self.ds.data) if t is not None]


def _distinct_bytes(tensors) -> int:
    """Bytes of the distinct storages of ``tensors`` (a registration that
    two names or two servers hold counts once)."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[(t.device.type, st.data_ptr())] = st.nbytes()
    return sum(seen.values())


def _on_host(dataset) -> None:
    """Move a checked dataset's matrices to the host: pinned memory for a
    card's tensors (the copy awaited, so the card's copies are freed when
    this returns), unchanged for the CPU's."""
    for field in ds.FIELDS:
        t = getattr(dataset, field)
        if t is None or t.device.type != "cuda":
            continue
        host, done = ds.to_host(t)
        done.synchronize()
        setattr(dataset, field, host)


#: the registrations' checked host copies of the process, one per
#: registration digest (:func:`_share_registration`)
HOST_COPIES = SharedCopies()


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits, as integers of its width (``-0.0`` is not ``0.0``)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _same_bits(held, fields) -> bool:
    """Whether host copies ``held`` equal the checked matrices ``fields``
    bit for bit: shapes, types and every element, compared in row blocks
    of about 64 MiB on the fields' device."""
    for h, f in zip(held, fields):
        if (h is None) != (f is None):
            return False
        if h is None:
            continue
        if h.shape != f.shape or h.dtype != f.dtype:
            return False
        rows = max(1, (64 << 20) // max(1, h[0].numel() * h.element_size()))
        for r in range(0, h.shape[0], rows):
            if not torch.equal(_bits(h[r:r + rows].to(f.device)),
                               _bits(f[r:r + rows])):
                return False
    return True


def _share_registration(digest: str, dataset) -> None:
    """Put a checked dataset's matrices on the host (:func:`_on_host`) as
    the process's copy of ``digest``, or set them to the copy that
    another server of the process (a fleet's in-process replica) holds
    for it when that copy equals them bit for bit; the card's checked
    copies are then dropped. The digest only samples the matrices, so a
    copy that differs elsewhere is never shared: the dataset keeps its
    own, and becomes the copy later registrations of ``digest`` meet."""
    fields = [getattr(dataset, f) for f in ds.FIELDS]

    def build():
        _on_host(dataset)
        return tuple(getattr(dataset, f) for f in ds.FIELDS)

    held = HOST_COPIES.get(digest, build,
                           lambda held: _same_bits(held, fields))
    for f, t in zip(ds.FIELDS, held):
        setattr(dataset, f, t)


def registrations_gib() -> float:
    """GiB of the registrations' host copies the process holds, each
    once."""
    return _distinct_bytes(HOST_COPIES.live()) / 2**30


def _registration_identity(engine, discs, test) -> None:
    """A packed engine's checkpoint identity from the registrations' host
    tensors, as an engine built from them digests it: its test operands
    are the shared device copies, whose bfloat16 values a digest would
    sample instead."""
    engine._digest = content_digest(
        [a for d in discs for a in (d.ds.correlation, d.ds.network,
                                    d.ds.data)]
        + [test.ds.correlation, test.ds.network, test.ds.data])


def _load_kernels(engine) -> None:
    """Build or load the kernels an engine on the card launches (the
    fused-statistics kernel, or the gather under ``stat_mode='xla'``)."""
    if engine.device.type != "cuda":
        return
    if engine.stat_mode == "fused":
        from ..ops import fused_stats

        fused_stats._lib()
    else:
        from ..ops import fused_gather

        fused_gather._lib()


class PreservationServer:
    """The in-process serving core — what the unix-socket daemon wraps and
    what :class:`netrep_tpu_torch.serve.client.InProcessClient` drives
    directly. ``clock`` is the clock deadlines are set and checked on
    (default ``time.monotonic``)."""

    def __init__(self, config: ServeConfig | None = None, start: bool = True,
                 clock: Callable[[], float] | None = None):
        self.config = config or ServeConfig()
        self.device = resolve_device(self.config.device)
        self._clock = clock or time.monotonic
        self.tel, self._tel_owned = tm.resolve_arg(self.config.telemetry)
        self._fault = resolve_runtime(self.config.fault_policy)
        self._work = threading.Condition()
        self._tenants: dict[str, _Tenant] = {}
        self._tenant_order: list[str] = []
        self._rr: list[str] = []       # weighted ring (name x weight)
        self._rr_pos = 0
        self._seq = 0
        self._pack_seq = 0
        self._inflight = 0
        self._accepting = True
        self._stop = False
        self._started_m = time.monotonic()
        self.pool = ProgramPool(self.config.pool_size)
        self._engine_cfg_id = repr(self.config.engine)
        #: idempotency map: journal key -> Request (in-flight requests are
        #: attached to; completed ones answer duplicates from their result)
        self._idem: dict[str, Request] = {}
        #: completed keys in retirement order (bounds the map's memory)
        self._idem_done: list[str] = []
        self._replaying = False
        self._adopting = False
        self._fixture_depth = 0
        #: (tenant, prefix) -> the parameters of each fixture registered
        self._fixtures: dict[tuple[str, str], dict] = {}
        self._last_drain_requeued = 0
        #: wall clock of the last accepted or finished request
        self._last_active_m = self._started_m
        self._brownout = False
        self._served_perms = 0.0     # measured steady-state rate inputs
        self._busy_s = 0.0
        #: the perf ledger's serve/run rate, read once (None = nothing)
        self._ledger_rate: float | None = None
        self._ledger_rate_read = False
        self._coldstart_done = False
        #: seconds of the boot's steps (the daemon's ready line carries it)
        self.boot: dict = {}
        if self.config.fleet_label and self.device.type == "cuda":
            self._boot_libraries()
        t0 = time.perf_counter()
        self.journal: jnl.RequestJournal | None = None
        self._ckpt_dir = self.config.checkpoint_dir
        if self.config.journal:
            if self._ckpt_dir is None:
                self._ckpt_dir = self.config.journal + ".ckpt"
            self.journal = jnl.RequestJournal(self.config.journal)
        self._serve_sid = None
        if self.tel is not None:
            self._serve_sid = self.tel.begin_span(
                "serve_start", max_queue=self.config.max_queue,
                max_pack=self.config.max_pack,
                pool_size=self.config.pool_size,
                journal=bool(self.journal),
            )
        self._worker: threading.Thread | None = None
        self._preload_thread: threading.Thread | None = None
        if self.config.recover and self.config.journal:
            self._recover()
        self.boot["journal_s"] = time.perf_counter() - t0
        if self.config.preload:
            self._start_preload()
        if start:
            self.start()

    def _boot_libraries(self) -> None:
        """A fleet replica's boot: every kernel library built (one ``nvcc``
        a source, together, under the store's lock) or loaded from the
        store, each load timed with its source."""
        from ..ops import _build

        t0 = time.perf_counter()
        self.boot["libraries"] = _build.load_all()
        self.boot["libraries_s"] = time.perf_counter() - t0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._worker is not None:
            return
        self._worker = threading.Thread(
            target=self._loop, name="netrep-serve-worker", daemon=True
        )
        self._worker.start()

    def close(self, drain: bool = True, timeout: float | None = None) -> None:
        """Graceful shutdown: stop accepting, optionally finish every
        queued request (the SIGTERM drain protocol), stop the worker,
        release pooled engines, close the telemetry span/bus.

        ``timeout`` bounds the drain: queued work that cannot finish in
        time is NOT dropped silently — with a journal attached its keys
        are recorded as ``drain_requeued`` (they are already
        ``accepted``-but-unfinished, so the next recovering boot picks
        them up) and each local waiter is unblocked with a distinctive
        error naming the journaled restart path."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._work:
            self._accepting = False
            self._work.notify_all()
        if drain and self._worker is not None:
            with self._work:
                while (self._inflight or self._any_pending_locked()):
                    if deadline is not None and time.monotonic() > deadline:
                        break
                    self._work.wait(0.25)
        with self._work:
            self._stop = True
            remainder = [
                r for t in self._tenants.values() for r in t.pending
            ]
            for t in self._tenants.values():
                t.pending.clear()
            self._work.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=10.0)
            self._worker = None
        with self._work:
            pt, self._preload_thread = self._preload_thread, None
        if pt is not None:
            pt.join(timeout=60.0)
        requeued = self._last_drain_requeued = len(remainder)
        if remainder:
            if self.journal is not None:
                self.journal.append(
                    "drain_requeued",
                    keys=[r.journal_key for r in remainder],
                )
            for r in remainder:
                if self.journal is not None:
                    r.requeued_on_drain = True
                    r.error = (
                        "drain timeout: request journaled as requeued-"
                        "on-restart (a recover=True boot completes it)"
                    )
                else:
                    r.error = ("drain timeout: request dropped "
                               "(no journal)")
                r.done.set()
        self.pool.clear()
        self.drop_registrations()
        if self.tel is not None:
            done = sum(t.counters["done"] for t in self._tenants.values())
            fail = sum(t.counters["failed"] for t in self._tenants.values())
            self.tel.end_span(
                self._serve_sid, "serve_end", drained=bool(drain),
                requests_done=done, requests_failed=fail,
                requests_requeued=requeued,
                s=time.monotonic() - self._started_m,
                **self.pool.stats(),
            )
            if self._tel_owned:
                self.tel.close()
        if self.journal is not None:
            self.journal.close()

    def drop_registrations(self) -> None:
        """Let go of every registration's matrices (a closed or dead
        server's): a host copy the process's other servers do not hold is
        freed (:data:`HOST_COPIES`). The names and digests stay."""
        with self._work:
            for ten in self._tenants.values():
                for d in ten.datasets.values():
                    for f in ds.FIELDS:
                        setattr(d.ds, f, None)

    # -- the warm pool at boot ----------------------------------------------

    def _start_preload(self) -> None:
        """Boot-time warm pool: for up to ``preload_max`` registered
        (discovery, test) pairs — a recovering boot or a journal adoption
        just re-registered them — build the pooled engine (the pair
        copied to the device), load the kernels it launches and run its
        observed pass, all inside the pool's builder, on ONE background
        thread. Best-effort: a failure leaves the lazy path intact."""
        with self._work:
            if self._preload_thread is not None:
                return
            pairs = []
            for ten in self._tenants.values():
                discs = [d for d in ten.datasets.values()
                         if d.assignments is not None]
                tests = list(ten.datasets.values())
                for d in discs:
                    for t in tests:
                        if t.name != d.name:
                            pairs.append((d, t))
            pairs = pairs[:max(0, int(self.config.preload_max))]
        if not pairs:
            return

        def warm(engine):
            _load_kernels(engine)
            engine.observed()
            return engine

        def preload(pairs=tuple(pairs), pool=self.pool):
            for d, t in pairs:
                try:
                    plan = self._build_plan(
                        d, t, None, n_perm=self.config.default_n_perm,
                        seed=0, alternative="greater", adaptive=False,
                        rule=None,
                    )
                    plan.base = 0
                    key = self._pool_key("packed", (d.digest, t.digest),
                                         [plan])
                    pool.get(key, lambda: warm(
                        self._pack_engine(d, t, [plan])))
                # netrep: allow(exception-taxonomy) — boot-time warmup is an optimization pass: any failure (unservable pair, out of memory) must leave the lazy path to serve the request as before
                except Exception:
                    logger.debug("warm-pool preload skipped one pair",
                                 exc_info=True)

        t = threading.Thread(target=preload, name="netrep-serve-preload",
                             daemon=True)
        with self._work:
            self._preload_thread = t
        t.start()

    # -- restart recovery ---------------------------------------------------

    def _recover(self) -> None:
        """Replay the write-ahead journal on boot: re-register tenants and
        dataset references, load completed (and terminally failed)
        requests into the idempotency map so duplicates are answered
        without recomputing, and re-queue every accepted-but-unfinished
        request in original ``seq`` order."""
        self._replay_journal(self.config.journal, quiet=True)

    def adopt_journal(self, path: str, *,
                      datasets_only: bool = False) -> dict | None:
        """Replay a FOREIGN journal into this live server (a fleet's
        failover path): re-register its tenants/datasets, load its
        completed results into the idempotency map, and re-queue its
        unfinished requests, each journaled here as a fresh ``accepted``
        record. Admission bounds are bypassed (the work was admitted
        once). ``datasets_only`` replays registrations alone. Returns the
        replay summary, or None when the journal does not exist."""
        return self._replay_journal(path, quiet=False,
                                    datasets_only=datasets_only)

    def _replay_journal(self, path: str, *, quiet: bool,
                        datasets_only: bool = False) -> dict | None:
        """Shared journal-replay core of the recovering boot
        (``quiet=True``: the records already live in our own journal — do
        not re-journal) and :meth:`adopt_journal` (``quiet=False``)."""
        from .protocol import decode_arrays

        if not path or not os.path.exists(path):
            return None
        state = jnl.scan(path)
        self._replaying = quiet
        self._adopting = not quiet
        try:
            for name, weight in state["tenants"].items():
                self.register_tenant(name, weight)
            for rec in state["datasets"]:
                if self._holds(rec):
                    continue
                pl = rec.get("payload") or {}
                if rec.get("form") == "fixture":
                    self.register_fixture(
                        str(rec["tenant"]), str(pl.get("prefix", "fx")),
                        genes=int(pl["genes"]), modules=int(pl["modules"]),
                        n_samples=int(pl["n_samples"]),
                        seed=int(pl["seed"]),
                    )
                else:
                    beta = pl.get("beta")
                    self.register_dataset(
                        str(rec["tenant"]), str(rec["name"]),
                        network=(np.asarray(pl["network"], dtype=np.float64)
                                 if pl.get("network") is not None else None),
                        correlation=(
                            np.asarray(pl["correlation"], dtype=np.float64)
                            if pl.get("correlation") is not None else None),
                        data=(np.asarray(pl["data"], dtype=np.float64)
                              if pl.get("data") is not None else None),
                        assignments=pl.get("assignments"),
                        beta=tuple(beta) if isinstance(beta, list) else beta,
                    )
            for key, rec in ({} if datasets_only
                             else state["results"]).items():
                acc = state["accepted"].get(key) or {}
                req = self._terminal_request(key, rec, acc)
                req.result = decode_arrays(rec.get("result") or {})
                req.done.set()
                self._idem[key] = req
                self._retire_idem(req)
            for key, rec in ({} if datasets_only
                             else state["failed"]).items():
                acc = state["accepted"].get(key) or {}
                req = self._terminal_request(key, rec, acc)
                req.error = str(rec.get("error", "failed before restart"))
                req.done.set()
                self._idem[key] = req
                self._retire_idem(req)
            requeued = 0
            for rec in ([] if datasets_only else state["pending"]):
                params = rec.get("params") or {}
                try:
                    self.submit(
                        str(rec["tenant"]), str(rec["discovery"]),
                        rec["test"],
                        modules=params.get("modules"),
                        n_perm=params.get("n_perm"),
                        seed=int(params.get("seed") or 0),
                        alternative=params.get("alternative", "greater"),
                        adaptive=bool(params.get("adaptive", False)),
                        deadline_s=params.get("deadline_s"),
                        idempotency_key=str(rec.get("key")),
                        # the re-queued run continues the caller's trace
                        trace_ctx=rec.get("trace"),
                    )
                    requeued += 1
                except ServeError as e:
                    # an unreplayable request must not resurrect on every
                    # boot: journal it terminally failed and move on
                    logger.warning("journal replay: request %s failed to "
                                   "re-queue: %s", rec.get("id"), e)
                    if self.journal is not None:
                        self.journal.append(
                            "failed", seq=rec.get("seq"), id=rec.get("id"),
                            key=rec.get("key"), error=f"replay: {e}",
                        )
        finally:
            self._replaying = False
            self._adopting = False
        summary = {
            "tenants": len(state["tenants"]),
            "datasets": len(state["datasets"]),
            "results": 0 if datasets_only else len(state["results"]),
            "failed": 0 if datasets_only else len(state["failed"]),
            "requeued": requeued,
        }
        if self.tel is not None:
            self.tel.emit(
                "journal_replayed", parent=self._serve_sid,
                adopted=not quiet, **summary,
            )
        return summary

    def _holds(self, rec: dict) -> bool:
        """Whether a journaled registration is registered here already
        under the same identity (the digest of an inline payload, the
        parameters of a fixture) — as a fleet's broadcast registers every
        dataset on every replica — so a replay skips checking the same
        data again."""
        pl = rec.get("payload") or {}
        tenant = str(rec.get("tenant"))
        with self._work:
            if rec.get("form") == "fixture":
                return self._fixtures.get(
                    (tenant, str(pl.get("prefix", "fx")))) == pl
            ten = self._tenants.get(tenant)
            held = (None if ten is None
                    else ten.datasets.get(str(rec.get("name"))))
        return (held is not None and rec.get("digest") is not None
                and held.digest == rec["digest"])

    @staticmethod
    def _terminal_request(key: str, rec: dict, acc: dict) -> Request:
        """A done-shaped Request rebuilt from journal records (no plan —
        it never runs again; it only answers duplicate submissions)."""
        params = acc.get("params") or {}
        return Request(
            id=str(rec.get("id") or acc.get("id") or key),
            tenant=str(acc.get("tenant", "")),
            discovery=str(acc.get("discovery", "")),
            test=acc.get("test"),
            seed=int(params.get("seed") or 0),
            adaptive=bool(params.get("adaptive", False)),
            plan=None, pack_key=None, deadline=0.0, submitted_m=0.0,
            seq=int(acc.get("seq") or 0), journal_key=key,
        )

    # -- registration ------------------------------------------------------

    def register_tenant(self, name: str, weight: int = 1) -> None:
        with self._work:
            if name in self._tenants:
                self._tenants[name].weight = max(1, int(weight))
            else:
                self._tenants[name] = _Tenant(name, weight)
                self._tenant_order.append(name)
            self._rr = [
                n for n in self._tenant_order
                for _ in range(self._tenants[n].weight)
            ]
            self._rr_pos %= max(1, len(self._rr))
        if self.journal is not None and not self._replaying:
            self.journal.append("tenant", tenant=name,
                                weight=max(1, int(weight)))

    def register_dataset(self, tenant: str, name: str, *, network=None,
                         correlation=None, data=None, assignments=None,
                         beta=None) -> str:
        """Register one named dataset for ``tenant`` (creating the tenant
        at weight 1 if needed); returns the dataset's content digest —
        the identity the cross-request pack key is built from, so two
        tenants registering identical data can share dispatches.

        Two payload shapes: the dense one (``network`` + ``correlation``
        [+ ``data``]) and the DATA-ONLY one (``data`` + ``beta``, the
        soft-threshold derivation spec, no matrices). The data-only
        digest covers the derivation params (β, kind) beside the data
        content, so two derivations of the same data never share a pack
        or a warm pooled engine. The input checks run on the server's
        device; the checked float32 matrices then wait on the host."""
        if tenant not in self._tenants:
            self.register_tenant(tenant)
        data_only = network is None and correlation is None
        if data_only:
            if beta is None or data is None:
                raise ServeError(
                    "a registration needs either network+correlation "
                    "(dense) or data+beta (data-only atlas payload)"
                )
            from ..ops.stats import normalize_net_beta

            beta = tuple(beta) if isinstance(beta, list) else beta
            b, kind = normalize_net_beta(beta)   # fail fast on a bad spec
            built = ds.build_data_only_datasets({name: data},
                                                device=self.device)
            src = ds.input_sources(None, data={name: data})[name]
            digest = (
                f"{content_digest([src['data']], dtype='float64')}"
                f"|beta:{b:g}|{kind}"
            )
        else:
            if beta is not None:
                raise ServeError(
                    "beta is the data-only derivation spec; a dense "
                    "registration (network+correlation) must not pass it"
                )
            built = ds.build_datasets(
                network={name: network},
                data=None if data is None else {name: data},
                correlation={name: correlation},
                device=self.device,
            )
            src = ds.input_sources(
                {name: network}, None if data is None else {name: data},
                {name: correlation})[name]
            digest = content_digest(
                [src["correlation"], src["network"], src["data"]],
                dtype="float64",
            )
        dataset = built[name]
        norm = None
        if assignments is not None:
            norm = ds.normalize_module_assignments(
                assignments, built, [name]
            )[name]
        _share_registration(digest, dataset)
        with self._work:
            self._tenants[tenant].datasets[name] = _Dataset(
                name, dataset, norm, digest,
                beta=beta if data_only else None,
            )
        if (self.journal is not None and not self._replaying
                and not self._fixture_depth):
            # the durable dataset reference recovery re-registers from:
            # inline payloads journal their (encoded) matrices — the same
            # bytes the wire carried in
            from .protocol import encode_arrays

            self.journal.append(
                "dataset", tenant=tenant, name=name, form="inline",
                digest=digest,
                payload=encode_arrays(dict(
                    network=network, correlation=correlation, data=data,
                    assignments=assignments,
                    beta=list(beta) if isinstance(beta, tuple) else beta,
                )),
            )
        return digest

    def register_fixture(self, tenant: str, prefix: str = "fx", *,
                         genes: int = 120, modules: int = 3,
                         n_samples: int = 16, seed: int = 7) -> dict:
        """Generate and register a deterministic mixed discovery/test pair
        (:func:`netrep_tpu_torch.data.make_mixed_pair`) — the daemon drill
        registers fixtures by PARAMETERS instead of shipping matrices over
        the wire (and journals only the parameters)."""
        from ..data import make_mixed_pair

        mixed = make_mixed_pair(genes, modules, n_samples=n_samples,
                                seed=seed)
        (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
        assign = {f"node_{i}": "0" for i in range(dn.shape[0])}
        for lab, idx in mixed["specs"]:
            for i in idx:
                assign[f"node_{i}"] = str(lab)
        d_name, t_name = f"{prefix}_d", f"{prefix}_t"
        params = dict(prefix=prefix, genes=int(genes), modules=int(modules),
                      n_samples=int(n_samples), seed=int(seed))
        if self.journal is not None and not self._replaying:
            self.journal.append(
                "dataset", tenant=tenant, name=prefix, form="fixture",
                payload=params,
            )
        self._fixture_depth += 1
        try:
            self.register_dataset(tenant, d_name, network=dn,
                                  correlation=dc, data=dd,
                                  assignments=assign)
            self.register_dataset(tenant, t_name, network=tn,
                                  correlation=tc, data=td)
        finally:
            self._fixture_depth -= 1
        with self._work:
            self._fixtures[(tenant, prefix)] = params
        return {"discovery": d_name, "test": t_name,
                "labels": [str(lab) for lab, _ in mixed["specs"]]}

    # -- submission --------------------------------------------------------

    def _dataset(self, tenant: str, name: str) -> _Dataset:
        ten = self._tenants.get(tenant)
        if ten is None:
            raise ServeError(f"unknown tenant {tenant!r}")
        d = ten.datasets.get(name)
        if d is None:
            raise ServeError(
                f"tenant {tenant!r} has no dataset {name!r}; register it "
                "first"
            )
        return d

    def _auto_n_perm(self, labels, with_data: bool) -> int:
        # the library's Bonferroni auto rule (models/preservation.py) —
        # mirrored so a served request defaults exactly like a direct call
        n_stats_eff = 7 if with_data else 3
        return max(1000, pv.required_perms(
            0.05, n_tests=len(labels) * n_stats_eff
        ))

    def _build_plan(self, disc: _Dataset, test: _Dataset, modules,
                    n_perm, seed, alternative, adaptive, rule) -> RequestPlan:
        if disc.assignments is None:
            raise ServeError(
                f"dataset {disc.name!r} was registered without module "
                "assignments and cannot serve as a discovery dataset"
            )
        labels, mod_specs, counts, pool = _overlap_setup(
            disc.ds, test.ds, disc.assignments, modules,
            self.config.background_label, self.config.null,
        )
        with_data = disc.ds.data is not None and test.ds.data is not None
        np_this = (
            int(n_perm) if n_perm is not None
            else self.config.default_n_perm
            or self._auto_n_perm(labels, with_data)
        )
        return RequestPlan(
            labels=labels, specs=mod_specs, counts=counts, pool=pool,
            n_perm=np_this, seed=int(seed), alternative=alternative,
            adaptive=bool(adaptive), rule=rule,
        )

    def _dedup_locked(self, key: str | None) -> Request | None:
        """Idempotency lookup (caller holds the lock): a seen key returns
        the original request — attaching to it while in flight, answering
        from its stored/journaled result after completion — instead of
        ever recomputing."""
        if key is None:
            return None
        req = self._idem.get(key)
        if req is None:
            return None
        state = "completed" if req.done.is_set() else "inflight"
        ten = self._tenants.get(req.tenant)
        if ten is not None:
            ten.counters["deduped"] += 1
        if self.tel is not None:
            self.tel.emit("request_deduped", tenant=req.tenant, key=key,
                          state=state, parent=req.sid)
        return req

    # -- overload / brownout -----------------------------------------------

    def _req_nperm(self, req: Request) -> int:
        p = req.plan
        return int(p.plan.n_perm if isinstance(p, _MultiPlan) else p.n_perm)

    def _rate_pps(self) -> float | None:
        """Steady-state serving throughput estimate (perms/s): the
        configured assumption, else the server's own measured rate, else
        the perf ledger's serve/run history (the median of its last eight
        entries, read once) — None when nothing is known (brownout then
        stays off: no guessing)."""
        if self.config.brownout_rate_pps:
            return float(self.config.brownout_rate_pps)
        if self._busy_s > 0 and self._served_perms > 0:
            return self._served_perms / self._busy_s
        if not self._ledger_rate_read:
            self._ledger_rate_read = True
            from ..utils import perfledger

            self._ledger_rate = perfledger.serve_rate()
        return self._ledger_rate

    def _drain_estimate_locked(self, extra_perms: int = 0) -> float | None:
        rate = self._rate_pps()
        if not rate or rate <= 0:
            return None
        backlog = extra_perms + sum(
            self._req_nperm(r)
            for t in self._tenants.values() for r in t.pending
        )
        return backlog / rate

    def _update_brownout_locked(self, est: float | None) -> bool:
        """Hysteresis state machine around the backlog drain estimate:
        enter past ``brownout_enter_s``, exit below ``brownout_exit_s``
        (default half of enter), one telemetry event per transition."""
        cfg = self.config
        if cfg.brownout_enter_s is None or est is None:
            return self._brownout
        exit_s = (cfg.brownout_exit_s if cfg.brownout_exit_s is not None
                  else cfg.brownout_enter_s / 2.0)
        depth = sum(len(t.pending) for t in self._tenants.values())
        if not self._brownout and est > cfg.brownout_enter_s:
            self._brownout = True
            if self.tel is not None:
                self.tel.emit("serve_brownout_enter",
                              est_drain_s=float(est), queue_depth=depth,
                              parent=self._serve_sid)
        elif self._brownout and est < exit_s:
            self._brownout = False
            if self.tel is not None:
                self.tel.emit("serve_brownout_exit",
                              est_drain_s=float(est), queue_depth=depth,
                              parent=self._serve_sid)
        return self._brownout

    def submit(self, tenant: str, discovery: str, test,
               modules: Sequence | None = None, n_perm: int | None = None,
               seed: int = 0, alternative: str = "greater",
               adaptive: bool = False, rule=None,
               deadline_s: float | None = None,
               idempotency_key: str | None = None,
               trace_ctx: dict | None = None) -> Request:
        """Validate, admit, and enqueue one analyze request; returns the
        request handle (``wait`` for the result). ``test`` may be a list
        of test-dataset names sharing a node universe — the request then
        rides the MultiTestEngine T-axis and returns per-test results.

        ``idempotency_key``: a client-chosen durable identity. A
        duplicate submission with a seen key never recomputes — it
        attaches to the in-flight request or returns the completed
        (journaled) result. With a journal attached, the ``accepted``
        record is fsynced before this method returns.

        ``trace_ctx``: the caller's trace context (``{"trace": <hex id>,
        "parent": <span id|None>}``), journaled with the ``accepted``
        record and stamped on the request's telemetry span; a malformed
        context is replaced by a server-minted one, never an error."""
        if alternative not in ("greater", "less", "two.sided"):
            raise ServeError(f"bad alternative {alternative!r}")
        from .protocol import mint_trace_ctx, normalize_trace_ctx

        tctx = normalize_trace_ctx(trace_ctx) or mint_trace_ctx()
        with self._work:
            dup = self._dedup_locked(idempotency_key)
            if dup is not None:
                return dup
        disc = self._dataset(tenant, discovery)
        multi = isinstance(test, (list, tuple))
        if multi and len(test) == 1:
            test, multi = test[0], False
        if multi:
            tests = [self._dataset(tenant, t) for t in test]
            if disc.beta is not None or any(
                t.beta is not None for t in tests
            ):
                raise ServeError(
                    "multi-test requests need materialized matrices (the "
                    "vmap_tests contract stacks the T cohorts); data-only "
                    "datasets are served pairwise"
                )
            names0 = tests[0].ds.node_names
            if any(t.ds.node_names != names0 for t in tests[1:]):
                raise ServeError(
                    "multi-test requests need test datasets with an "
                    "identical node universe (the vmap_tests contract)"
                )
            if len({t.ds.data is not None for t in tests}) != 1:
                raise ServeError(
                    "multi-test requests need test datasets agreeing on "
                    "data presence"
                )
            plan = _MultiPlan(
                plan=self._build_plan(disc, tests[0], modules, n_perm,
                                      seed, alternative, adaptive, rule),
                test_names=[t.name for t in tests],
            )
            pack_key = None   # a multi-test request is its own pack
        else:
            tds = self._dataset(tenant, test)
            if (disc.beta is None) != (tds.beta is None):
                raise ServeError(
                    "cannot mix a data-only dataset with a dense one in "
                    "one request: both sides must carry matrices, or both "
                    "data+beta"
                )
            if disc.beta is not None and disc.beta != tds.beta:
                raise ServeError(
                    f"discovery and test were registered with different "
                    f"derivation specs ({disc.beta!r} vs {tds.beta!r}); "
                    "re-register one side"
                )
            plan = self._build_plan(disc, tds, modules, n_perm, seed,
                                    alternative, adaptive, rule)
            if (self.config.cross_pair_packing and disc.beta is None
                    and tds.beta is None):
                # the grid identity: shared test matrices + byte-equal
                # permutation pool + agreeing data presence; discovery
                # matrices drop out (GridPackedEngine builds each
                # request's props from its own source)
                pool_sig = hashlib.blake2b(
                    np.ascontiguousarray(plan.pool, dtype=np.int64),
                    digest_size=8,
                ).hexdigest()
                pack_key = ("xpair", tds.digest, pool_sig,
                            disc.ds.data is not None, self.config.null,
                            self._engine_cfg_id)
            else:
                pack_key = (disc.digest, tds.digest, self.config.null,
                            self._engine_cfg_id)
        now = time.monotonic()
        with self._work:
            # authoritative dedup under the lock (a concurrent duplicate
            # may have landed while the plan was being built)
            dup = self._dedup_locked(idempotency_key)
            if dup is not None:
                return dup
            ten = self._tenants[tenant]
            if not self._accepting:
                ten.counters["rejected"] += 1
                if self.tel is not None:
                    self.tel.emit("request_rejected", tenant=tenant,
                                  reason="draining")
                raise ServeError("server is draining; not accepting work")
            plan_np = int(plan.plan.n_perm if multi else plan.n_perm)
            est = self._drain_estimate_locked(extra_perms=plan_np)
            brown = self._update_brownout_locked(est)
            retry_after = round(est, 3) if est is not None else None
            if brown and not (self._replaying or self._adopting):
                # predictable shedding: the NEWEST request of the
                # lowest-weight tenants is refused first
                min_w = min(t.weight for t in self._tenants.values())
                if ten.weight <= min_w:
                    ten.counters["rejected"] += 1
                    if self.tel is not None:
                        self.tel.emit(
                            "request_rejected", tenant=tenant,
                            reason="brownout",
                            queue_depth=len(ten.pending),
                            retry_after_s=retry_after,
                        )
                    raise QueueFull(
                        f"service is browned out (estimated backlog "
                        f"drain {est:.1f}s); retry later",
                        retry_after_s=retry_after,
                    )
            if (len(ten.pending) >= self.config.max_queue
                    and not (self._replaying or self._adopting)):
                # (replayed requests were admitted once and re-queue past
                # the bound by design)
                ten.counters["rejected"] += 1
                if self.tel is not None:
                    self.tel.emit(
                        "request_rejected", tenant=tenant,
                        reason="queue_full",
                        queue_depth=len(ten.pending),
                        retry_after_s=retry_after,
                    )
                raise QueueFull(
                    f"tenant {tenant!r} queue is full "
                    f"({self.config.max_queue}); retry later",
                    retry_after_s=retry_after,
                )
            if (brown and self.config.brownout_nperm_cap is not None
                    and not (self._replaying or self._adopting)):
                cap = int(self.config.brownout_nperm_cap)
                if multi:
                    plan.plan.n_perm = min(plan.plan.n_perm, cap)
                else:
                    plan.n_perm = min(plan.n_perm, cap)
            self._seq += 1
            jkey = idempotency_key or f"auto-{uuid.uuid4().hex[:12]}"
            if self.journal is not None and not self._replaying:
                # the write-ahead promise, fsynced BEFORE admission
                self.journal.append(
                    "accepted", seq=self._seq, id=f"r{self._seq}",
                    key=jkey, tenant=tenant, discovery=discovery,
                    test=list(test) if multi else test,
                    trace=dict(tctx),
                    digests=(
                        [self._dataset(tenant, discovery).digest]
                        + [self._dataset(tenant, t).digest
                           for t in (test if multi else [test])]
                    ),
                    params=dict(
                        modules=(list(modules) if modules is not None
                                 else None),
                        n_perm=(int(n_perm) if n_perm is not None
                                else None),
                        seed=int(seed), alternative=alternative,
                        adaptive=bool(adaptive),
                        deadline_s=(float(deadline_s)
                                    if deadline_s is not None else None),
                    ),
                )
            req = Request(
                id=f"r{self._seq}", tenant=tenant, discovery=discovery,
                test=list(test) if multi else test, seed=int(seed),
                adaptive=bool(adaptive), plan=plan, pack_key=pack_key,
                deadline=self._clock() + (
                    deadline_s if deadline_s is not None
                    else self.config.slo_s
                ),
                submitted_m=now, seq=self._seq, journal_key=jkey,
                trace=tctx["trace"], trace_parent=tctx["parent"],
            )
            self._idem[jkey] = req
            ten.counters["received"] += 1
            self._last_active_m = now
            if self.tel is not None:
                req.sid = self.tel.new_span_id()
                self.tel.emit(
                    "request_received", span=req.sid,
                    parent=self._serve_sid, tenant=tenant,
                    discovery=discovery,
                    test="+".join(req.test) if multi else test,
                    n_perm=int(
                        plan.plan.n_perm if multi else plan.n_perm
                    ),
                    seed=int(seed), adaptive=bool(adaptive),
                    queue_depth=len(ten.pending) + 1,
                    trace=req.trace,
                    **({"trace_parent": req.trace_parent}
                       if req.trace_parent else {}),
                )
            ten.pending.append(req)
            self._work.notify_all()
        return req

    def wait(self, req: Request, timeout: float | None = None) -> dict:
        if not req.done.wait(timeout):
            raise TimeoutError(f"request {req.id} did not finish in time")
        if req.error is not None:
            raise ServeError(f"request {req.id}: {req.error}")
        return req.result

    def analyze(self, tenant: str, discovery: str, test, *,
                timeout: float | None = None, **kw) -> dict:
        """Blocking submit + wait (the one-call client surface)."""
        return self.wait(
            self.submit(tenant, discovery, test, **kw), timeout=timeout
        )

    # -- scheduling --------------------------------------------------------

    def _any_pending_locked(self) -> bool:
        return any(t.pending for t in self._tenants.values())

    def _take_pack_locked(self) -> list[Request] | None:
        """Pick the next batch under the lock: WRR across tenants picks
        the seed tenant, oldest-deadline-first picks its seed request, and
        the seed's pack key pulls compatible requests from every tenant's
        queue (seed tenant first) up to ``max_pack``."""
        if not self._rr or not self._any_pending_locked():
            return None
        n = len(self._rr)
        ten = None
        for step in range(n):
            cand = self._tenants[self._rr[(self._rr_pos + step) % n]]
            if cand.pending:
                ten = cand
                self._rr_pos = (self._rr_pos + step + 1) % n
                break
        if ten is None:
            return None
        seed_req = min(ten.pending, key=lambda r: (r.deadline, r.seq))
        ten.pending.remove(seed_req)
        batch = [seed_req]
        self._fill_pack_locked(batch, ten.name)
        return batch

    def _fill_pack_locked(self, batch: list[Request],
                          seed_tenant: str) -> None:
        """Pull compatible requests from every tenant's queue (seed tenant
        first) into ``batch``, up to ``max_pack``."""
        seed_req = batch[0]
        if (seed_req.pack_key is None or seed_req.solo_only
                or self.config.max_pack <= 1):
            return
        order = [seed_tenant] + [
            t for t in self._tenant_order if t != seed_tenant
        ]
        for name in order:
            if len(batch) >= self.config.max_pack:
                break
            t = self._tenants[name]
            matches = sorted(
                (r for r in t.pending
                 if r.pack_key == seed_req.pack_key and not r.solo_only),
                key=lambda r: (r.deadline, r.seq),
            )
            for r in matches:
                if len(batch) >= self.config.max_pack:
                    break
                t.pending.remove(r)
                batch.append(r)

    def _trim_pack_locked(self, batch: list[Request]) -> None:
        """Canonicalize the pack size to the largest power of two that
        fits, re-queueing the tail (original deadlines kept — they seed
        the very next pack): the warm pool keys on the pack's structure,
        so powers of two bound the compositions steady traffic meets."""
        if len(batch) < 2:
            return
        size = 1
        while size * 2 <= len(batch):
            size *= 2
        for r in batch[size:]:
            self._tenants[r.tenant].pending.append(r)
        del batch[size:]

    def _window_locked(self, batch: list[Request]) -> None:
        """Batching window (caller holds the lock): let compatible
        arrivals join the pack for up to ``pack_window_s`` of wall time,
        or until it is full. Every submit notifies the condition, so each
        wake-up pulls what arrived and waits out the rest of the window
        (the JAX package's single wait ends at the first arrival)."""
        end = time.monotonic() + self.config.pack_window_s
        while True:
            self._fill_pack_locked(batch, batch[0].tenant)
            left = end - time.monotonic()
            if (len(batch) >= self.config.max_pack or left <= 0
                    or self._stop):
                return
            self._work.wait(left)

    def _loop(self) -> None:
        while True:
            with self._work:
                batch = self._take_pack_locked()
                while batch is None and not self._stop:
                    self._work.wait(0.25)
                    batch = self._take_pack_locked()
                if batch is None:
                    return
                if (self.config.pack_window_s > 0
                        and len(batch) < self.config.max_pack
                        and batch[0].pack_key is not None
                        and not batch[0].solo_only):
                    self._window_locked(batch)
                self._trim_pack_locked(batch)
                self._inflight = len(batch)
            try:
                self._execute(batch)
            except SimulatedCrash:
                # the in-process stand-in for a killed process: the worker
                # dies HERE — waiters stay blocked, queued work stays
                # queued; only the journal and the pack checkpoints
                # survive, for the next recovering boot
                return
            # netrep: allow(exception-taxonomy) — the worker outlives any batch failure; the error is logged and delivered to every waiter below
            except Exception:   # defensive: the worker must never die
                logger.warning(
                    "serve worker: unhandled batch failure", exc_info=True
                )
                for r in batch:
                    if not r.done.is_set():
                        r.error = r.error or "internal server error"
                        r.done.set()
            finally:
                with self._work:
                    self._inflight = 0
                    self._work.notify_all()

    # -- execution ---------------------------------------------------------

    def _finish(self, req: Request, result: dict | None, error: str | None,
                pack_id: str, pack_size: int, pool_hit: bool) -> None:
        ten = self._tenants[req.tenant]
        now = time.monotonic()
        if error is None:
            req.result = dict(
                result,
                request_id=req.id, tenant=req.tenant,
                discovery=req.discovery, test=req.test,
                trace=req.trace,
                latency_s=now - req.submitted_m,
                pack_id=pack_id, pack_size=pack_size, pool_hit=pool_hit,
            )
            ten.counters["done"] += 1
            latency = now - req.submitted_m
            with self._work:
                self._last_active_m = now
                ten.lat_hist.observe(latency)
                self._slo_mark_locked(ten, now, latency > self.config.slo_s)
            self._account_cost(req, result.get("cost"))
        else:
            req.error = error
            ten.counters["failed"] += 1
            with self._work:
                self._last_active_m = now
                self._slo_mark_locked(ten, now, True)
        if self.journal is not None and req.journal_key is not None:
            from .protocol import encode_arrays

            if error is None:
                enc = encode_arrays(req.result)
                self.journal.append(
                    "done", seq=req.seq, id=req.id, key=req.journal_key,
                    tenant=req.tenant, digest=jnl.result_digest(enc),
                    result=enc,
                )
            else:
                self.journal.append(
                    "failed", seq=req.seq, id=req.id, key=req.journal_key,
                    tenant=req.tenant, error=error,
                )
        if self.tel is not None:
            data = dict(
                tenant=req.tenant, s=now - req.submitted_m,
                pack=pack_id, pack_size=pack_size, ok=error is None,
            )
            if error is None:
                data["perms"] = int(result.get("completed", 0))
            else:
                data["error"] = error
            self.tel.emit("request_done", span=req.sid, **data)
        self._retire_idem(req)
        req.done.set()

    def _slo_mark_locked(self, ten: _Tenant, now: float,
                         missed: bool) -> None:
        """Record one terminal request in the tenant's SLO sliding window
        (caller holds the lock) and trim marks older than the window."""
        ten.slo_marks.append((now, bool(missed)))
        horizon = now - self.config.slo_window_s
        while ten.slo_marks and ten.slo_marks[0][0] < horizon:
            ten.slo_marks.pop(0)
        # the slo_burn anomaly, latched per excursion: the first mark that
        # takes the tenant past its error budget fires the detector, and a
        # rate back at or under budget re-arms it
        burn = self._burn_rate_locked(ten, now)
        if missed and burn > 1.0 and not ten.burn_flagged:
            ten.burn_flagged = True
            detectors.fire("slo_burn", telemetry=self.tel,
                           tenant=ten.name, burn_rate=round(burn, 4),
                           window_s=self.config.slo_window_s,
                           budget=self.config.slo_budget)
        elif burn <= 1.0:
            ten.burn_flagged = False

    def _burn_rate_locked(self, ten: _Tenant, now: float) -> float:
        """SLO burn rate: miss fraction over the sliding window divided
        by the error budget (1.0 = consuming the budget exactly at the
        sustainable rate; 0 with no terminal requests in the window)."""
        horizon = now - self.config.slo_window_s
        marks = [m for t, m in ten.slo_marks if t >= horizon]
        if not marks:
            return 0.0
        frac = sum(marks) / len(marks)
        return frac / max(self.config.slo_budget, 1e-9)

    def _account_cost(self, req: Request, cost: dict | None) -> None:
        """Fold one request's attributed cost into its tenant's rollups
        and emit the ``request_cost`` event under the request's span."""
        if cost is None:
            return
        ten = self._tenants[req.tenant]
        with self._work:
            for k in ("device_s", "transfer_s", "compile_s_amortized"):
                ten.cost[k] += float(cost.get(k, 0.0))
            for k in ("perms", "bytes_to_host"):
                ten.cost[k] += int(cost.get(k, 0))
            ten.cost_hist.observe(float(cost.get("device_s", 0.0)))
        if self.tel is not None:
            self.tel.emit(
                "request_cost", parent=req.sid, tenant=req.tenant,
                trace=req.trace, pack_weight=int(cost.get("weight", 0)),
                device_s=float(cost.get("device_s", 0.0)),
                transfer_s=float(cost.get("transfer_s", 0.0)),
                perms=int(cost.get("perms", 0)),
                bytes_to_host=int(cost.get("bytes_to_host", 0)),
                compile_s_amortized=float(
                    cost.get("compile_s_amortized", 0.0)
                ),
            )

    def _retire_idem(self, req: Request) -> None:
        """Bound the idempotency map: terminal requests stay answerable
        up to ``idem_cache`` of them; beyond that the oldest evict (a
        duplicate of an evicted key recomputes to the same result)."""
        if req.journal_key is None:
            return
        with self._work:
            self._idem_done.append(req.journal_key)
            while len(self._idem_done) > self.config.idem_cache:
                old = self._idem_done.pop(0)
                stale = self._idem.get(old)
                if stale is not None and stale.done.is_set():
                    del self._idem[old]

    def _expire(self, req: Request, miss_s: float, folded: int,
                cost: dict | None = None) -> None:
        """Cancel a deadline-missed request: the ``expired`` counter, a
        terminal ``failed`` journal record (a deadline miss must not
        resurrect on a recovering boot), the ``request_expired`` event
        with the miss, and the waiter's error. ``cost`` is the share of
        the pack the request consumed before cancellation."""
        ten = self._tenants[req.tenant]
        ten.counters["expired"] += 1
        with self._work:
            self._slo_mark_locked(ten, time.monotonic(), True)
        self._account_cost(req, cost)
        error = (f"deadline exceeded by {miss_s:.2f}s "
                 f"(cancelled after {int(folded)} permutations)")
        req.error = error
        if self.journal is not None and req.journal_key is not None:
            self.journal.append(
                "failed", seq=req.seq, id=req.id, key=req.journal_key,
                tenant=req.tenant, error=error,
            )
        if self.tel is not None:
            self.tel.emit(
                "request_expired", span=req.sid, tenant=req.tenant,
                miss_s=float(miss_s), folded=int(folded),
                s=time.monotonic() - req.submitted_m,
            )
        self._retire_idem(req)
        req.done.set()

    def _account_pack_locked(self, wall_s: float, perms: int) -> None:
        """Fold one pack's measured throughput into the brownout rate
        estimate and re-evaluate the brownout state."""
        with self._work:
            self._busy_s += float(wall_s)
            self._served_perms += int(perms)
            self._update_brownout_locked(self._drain_estimate_locked())

    def _pack_ckpt_path(self, batch: list[Request], plans) -> str | None:
        """Deterministic per-pack checkpoint path (None when
        checkpointing is off), keyed on the members' durable identities."""
        if self._ckpt_dir is None:
            return None
        if any(r.journal_key is None for r in batch):
            return None
        os.makedirs(self._ckpt_dir, exist_ok=True)
        return jnl.pack_checkpoint_path(
            self._ckpt_dir, self._engine_cfg_id,
            [(r.journal_key, p.seed, p.n_perm, p.signature())
             for r, p in zip(batch, plans)],
        )

    def _requeue_solo(self, batch: list[Request]) -> None:
        """A failed pack is split: every member re-queues solo-only (front
        of its tenant's queue, original deadline), so one poisoned
        request fails alone on its retry."""
        with self._work:
            for r in batch:
                r.solo_only = True
                self._tenants[r.tenant].pending.append(r)
            self._work.notify_all()
        if self.tel is not None:
            for r in batch:
                self.tel.emit("request_requeued", tenant=r.tenant,
                              reason="pack_failed", parent=r.sid)

    def _execute(self, batch: list[Request]) -> None:
        if self.config.enforce_deadlines:
            # already-expired requests are cancelled before any dispatch
            # (mid-pack expiry is the monitor's chunk-boundary sweep)
            now = self._clock()
            live = []
            for r in batch:
                if r.deadline is not None and now > r.deadline:
                    self._expire(r, now - r.deadline, folded=0)
                else:
                    live.append(r)
            batch = live
            if not batch:
                return
        with self._work:
            self._pack_seq += 1
            pack_id = f"p{self._pack_seq}"
        multi = isinstance(batch[0].plan, _MultiPlan)
        # canonical member order → stable pool signatures across packs
        if not multi:
            batch = sorted(batch, key=lambda r: (r.plan.signature(), r.seq))
        tel_cm = self.tel.activate() if self.tel is not None else None
        if tel_cm is not None:
            tel_cm.__enter__()
        try:
            if multi:
                self._execute_multi(batch[0], pack_id)
            else:
                self._execute_pack(batch, pack_id)
        # netrep: allow(exception-taxonomy) — serving fault boundary: the error becomes each waiter's error result (packs retry solo first); crashes (BaseException) still unwind
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            if len(batch) > 1:
                self._requeue_solo(batch)
            else:
                self._finish(batch[0], None, err, pack_id, len(batch),
                             False)
        finally:
            if tel_cm is not None:
                tel_cm.__exit__(None, None, None)

    def _maybe_record_coldstart(self, results, wall_s: float,
                                perms_done: int) -> None:
        """Fleet cold-start baseline: a fleet replica's FIRST completed
        pack records its compile span to the perf ledger under a
        fleet-labeled fingerprint. Written only when ``NETREP_PERF_LEDGER``
        names a ledger, like every ledger writer; stand-alone servers (no
        ``fleet_label``) record nothing."""
        if not self.config.fleet_label or self._coldstart_done:
            return
        self._coldstart_done = True
        from ..utils import perfledger

        if not os.environ.get(perfledger.LEDGER_ENV):
            return
        compile_s = None
        for res in results:
            cost = res.get("cost")
            if cost and cost.get("pack_totals"):
                compile_s = float(
                    cost["pack_totals"].get("compile_s_amortized", 0.0)
                )
                break
        backend = self.device.type
        label = self.config.fleet_label
        perfledger.append_entry(perfledger.make_entry(
            f"serve-fleet-coldstart|{label}|{backend}",
            perms_done / wall_s if wall_s > 0 else 0.0,
            "serve", backend=backend, mode="fleet-coldstart",
            compile_s=compile_s, n_perm=perms_done,
            metric=f"serve-fleet coldstart {label}",
        ))

    def _pool_key(self, kind: str, digests: tuple, plans) -> tuple:
        return (kind, digests, self._engine_cfg_id,
                tuple(p.signature() for p in plans))

    def _emit_pool(self, hit: bool, pack_id: str, n: int) -> None:
        if self.tel is not None:
            self.tel.emit(
                "serve_pool_hit" if hit else "serve_pool_miss",
                pack=pack_id, n_requests=n, **self.pool.stats(),
            )

    def _pack_engine(self, disc: _Dataset, test: _Dataset, plans):
        """Build the packed engine for one (discovery, test) pair — the
        warm-pool builder shared by pack execution and the boot-time
        preload, so preloaded engines are EXACTLY the ones the first
        request would build."""
        cfg = self.config.engine
        if disc.beta is not None:
            # data-only pack: the engine derives every submatrix from the
            # data columns with the registered spec
            cfg = dataclasses.replace(
                cfg, network_from_correlation=disc.beta
            )
        engine = PackedEngine(
            disc.ds.correlation, disc.ds.network, disc.ds.data,
            *self._test_copies(test, cfg),
            [p.specs for p in plans], plans[0].pool,
            config=cfg, device=self.device,
        )
        _registration_identity(engine, [disc], test)
        return engine

    def _test_copies(self, test: _Dataset, cfg: EngineConfig) -> tuple:
        """The test registration's device copy in ``cfg``'s storage type,
        shared by every pooled engine over it (:func:`~netrep_tpu_torch.
        serve.pool.device_copy`)."""
        return device_copy(test.ds, cfg.torch_dtype, self.device)

    def _grid_pack_engine(self, discs, test: _Dataset, plans):
        """Cross-pair pack builder: one discovery source per request,
        shared test matrices — the grid-column engine. Only dense members
        reach here (the cross-pair key excludes beta registrations)."""
        engine = GridPackedEngine(
            [(d.ds.correlation, d.ds.network, d.ds.data) for d in discs],
            *self._test_copies(test, self.config.engine),
            [p.specs for p in plans], plans[0].pool,
            config=self.config.engine, device=self.device,
        )
        _registration_identity(engine, discs, test)
        return engine

    def _execute_pack(self, batch: list[Request], pack_id: str) -> None:
        plans = [r.plan for r in batch]
        assign_bases(plans)
        discs = [self._dataset(r.tenant, r.discovery) for r in batch]
        disc = discs[0]
        test = self._dataset(batch[0].tenant, batch[0].test)
        if any(d.digest != disc.digest for d in discs[1:]):
            # cross-pair pack: members share the test dataset and pool but
            # carry per-request discovery matrices
            key = self._pool_key(
                "gridpacked",
                (tuple(d.digest for d in discs), test.digest), plans,
            )
            engine, hit = self.pool.get(
                key, lambda: self._grid_pack_engine(discs, test, plans)
            )
        else:
            key = self._pool_key("packed", (disc.digest, test.digest),
                                 plans)
            engine, hit = self.pool.get(
                key, lambda: self._pack_engine(disc, test, plans)
            )
        self._emit_pool(hit, pack_id, len(batch))
        if self.tel is not None:
            for r in batch:
                self.tel.emit(
                    "request_packed", parent=r.sid, tenant=r.tenant,
                    pack=pack_id, n_requests=len(batch), pool_hit=hit,
                    queued_s=time.monotonic() - r.submitted_m,
                )
        for r, p in zip(batch, plans):
            p.deadline = (r.deadline if self.config.enforce_deadlines
                          else None)
        ckpt_path = self._pack_ckpt_path(batch, plans)
        kw = dict(
            telemetry=self.tel, fault_policy=self._fault,
            checkpoint_path=ckpt_path,
            checkpoint_every=self.config.checkpoint_every,
            clock=self._clock,
        )
        t0 = time.perf_counter()
        try:
            if self.tel is not None:
                with self.tel.span("pack", pack=pack_id,
                                   n_requests=len(batch),
                                   tenants=sorted({r.tenant
                                                   for r in batch})):
                    results = run_pack(engine, plans, **kw)
            else:
                results = run_pack(engine, plans, **kw)
        except BaseException:
            # a failed run may leave the engine's device state suspect —
            # drop it from the warm pool before the error propagates (the
            # pack checkpoint, if any, stays for the solo retries); a
            # crash unwinding mid-pack leaves it just as suspect
            self.pool.discard(key)
            raise
        if ckpt_path is not None:
            # the pack completed: its checkpoint is spent
            try:
                os.unlink(ckpt_path)
            except OSError:
                pass
        wall_s = time.perf_counter() - t0
        perms_done = sum(int(res.get("completed", 0)) for res in results
                         if not res.get("expired"))
        self._account_pack_locked(wall_s, perms_done)
        self._maybe_record_coldstart(results, wall_s, perms_done)
        for r, res in zip(batch, results):
            if res.get("expired"):
                self._expire(r, res["deadline_miss_s"],
                             res.get("completed", 0),
                             cost=res.get("cost"))
            else:
                self._finish(r, res, None, pack_id, len(batch), hit)

    def _execute_multi(self, req: Request, pack_id: str) -> None:
        from ..parallel.multitest import MultiTestEngine

        mp: _MultiPlan = req.plan
        plan = mp.plan
        plan.base = 0
        disc = self._dataset(req.tenant, req.discovery)
        tests = [self._dataset(req.tenant, t) for t in mp.test_names]
        key = self._pool_key(
            "multi", (disc.digest,) + tuple(t.digest for t in tests),
            [plan],
        )

        def build():
            with_data = (disc.ds.data is not None
                         and tests[0].ds.data is not None)
            copies = [self._test_copies(t, self.config.engine)
                      for t in tests]
            engine = MultiTestEngine(
                disc.ds.correlation, disc.ds.network, disc.ds.data,
                [c[0] for c in copies], [c[1] for c in copies],
                [c[2] for c in copies] if with_data else None,
                plan.specs, plan.pool, config=self.config.engine,
                device=self.device,
            )
            # the checkpoint identity digests the registrations as given
            engine._test_digest = content_digest(
                [Stack([t.ds.correlation for t in tests]),
                 Stack([t.ds.network for t in tests])]
                + ([t.ds.data for t in tests] if with_data else []))
            return engine

        engine, hit = self.pool.get(key, build)
        self._emit_pool(hit, pack_id, 1)
        if self.tel is not None:
            self.tel.emit(
                "request_packed", parent=req.sid, tenant=req.tenant,
                pack=pack_id, n_requests=1, pool_hit=hit, taxis=len(tests),
                queued_s=time.monotonic() - req.submitted_m,
            )
        T = len(tests)
        plan.deadline = (req.deadline if self.config.enforce_deadlines
                         else None)
        t0 = time.perf_counter()
        try:
            observed = np.asarray(engine.observed(), dtype=np.float64)
            # fold the T axis into the monitor's cell axis — a module
            # retires only when settled in every cohort
            obs_cells = np.moveaxis(observed, 0, 1).reshape(plan.k, -1)
            monitor = PackMonitor([plan], obs_cells, clock=self._clock)
            if self.tel is not None:
                monitor.enable_cost_tracking()
            nulls, completed, finished = engine.run_null_monitored(
                plan.n_perm, plan.seed, monitor, telemetry=self.tel,
                fault_policy=self._fault,
            )
        except BaseException:
            self.pool.discard(key)
            raise
        self._account_pack_locked(
            time.perf_counter() - t0,
            0 if 0 in monitor.expired else min(int(completed), plan.n_perm),
        )
        mcosts = monitor.request_costs()
        mcost = (dict(mcosts["members"][0],
                      pack_totals=dict(mcosts["totals"]))
                 if mcosts is not None else None)
        if 0 in monitor.expired:
            # the T-axis request missed its deadline mid-run (it is its
            # own pack, so there are no survivors)
            self._expire(req, monitor.expired[0],
                         min(int(monitor.folded), plan.n_perm),
                         cost=mcost)
            return
        total_space = pv.total_permutations(plan.pool.size, plan.sizes)
        per_test = []
        for ti in range(T):
            obs_t = observed[ti]
            nulls_t = nulls[ti][: plan.n_perm]
            if plan.adaptive:
                p_values, n_used = pv.sequential_pvalues(
                    obs_t, nulls_t, plan.alternative,
                    total_nperm=total_space,
                )
            else:
                p_values = pv.permutation_pvalues(
                    obs_t, nulls_t, plan.alternative,
                    total_nperm=total_space,
                )
                n_used = None
            hi, lo, eff = pv.tail_counts(obs_t, nulls_t)
            per_test.append({
                "test": mp.test_names[ti],
                "observed": obs_t, "p_values": p_values,
                "counts_hi": hi, "counts_lo": lo, "counts_eff": eff,
                "n_perm_used": n_used,
            })
        result = {
            **({"cost": mcost} if mcost is not None else {}),
            "module_labels": list(plan.labels),
            "tests": per_test,
            "n_perm": int(plan.n_perm),
            "completed": min(int(completed), plan.n_perm),
            "p_type": "sequential" if plan.adaptive else "fixed",
            "alternative": plan.alternative,
            "seed": int(plan.seed),
            "total_space": total_space,
            "finished": bool(finished),
        }
        self._finish(req, result, None, pack_id, 1, hit)

    # -- ops surface -------------------------------------------------------

    def stats(self) -> dict:
        """Queue, pool and tenant counters: the JAX package's keys, the
        roofline ``utilisation`` of the most recent engine run on this
        server's telemetry bus among them (null without a bus, before a
        run, and on a device without a peak-table row), with the pool's
        ``held_gib`` and the host GiB of the registered datasets
        (``datasets_gib``)."""
        note = (costmodel.last_run_note(bus=self.tel)
                if self.tel is not None else None)
        now = time.monotonic()
        uptime = now - self._started_m
        with self._work:
            return {
                "tenants": {
                    n: {
                        "weight": t.weight,
                        "queue_depth": len(t.pending),
                        **t.counters,
                        "p50_s": t.lat_hist.quantile(0.50),
                        "p99_s": t.lat_hist.quantile(0.99),
                        "latency_hist": t.lat_hist.state(),
                        "cost": dict(t.cost),
                        "device_s_per_s": (
                            t.cost["device_s"] / uptime if uptime > 0
                            else 0.0
                        ),
                        "burn_rate": self._burn_rate_locked(t, now),
                    }
                    for n, t in self._tenants.items()
                },
                "inflight": self._inflight,
                "accepting": self._accepting,
                "brownout": self._brownout,
                "backlog_perms": sum(
                    self._req_nperm(r)
                    for t in self._tenants.values() for r in t.pending
                ),
                "rate_pps": self._rate_pps(),
                "idle_s": (
                    0.0 if (self._inflight or self._any_pending_locked())
                    else max(0.0, now - self._last_active_m)
                ),
                "utilisation": (note or {}).get("utilisation"),
                "fleet_label": self.config.fleet_label,
                "journal": self.config.journal,
                "pool": self.pool.stats(),
                "datasets_gib": _distinct_bytes(
                    x for t in self._tenants.values()
                    for d in t.datasets.values() for x in d.tensors())
                / 2**30,
                "device": str(self.device),
                "packs": self._pack_seq,
                # this process's kernel launches (a daemon's are its own)
                "kernel_launches": {fn.__name__: fn.launches
                                    for fn in tops.kernels()},
                "uptime_s": uptime,
                "slo_s": self.config.slo_s,
                "slo_budget": self.config.slo_budget,
                "slo_window_s": self.config.slo_window_s,
            }

    def metrics_text(self) -> str:
        """Prometheus text exposition: the telemetry registry (when a bus
        is attached) plus per-tenant labeled serving series, with the JAX
        package's series names and labels."""
        parts = []
        if self.tel is not None:
            parts.append(self.tel.metrics.render_prometheus())
        lines = []
        st = self.stats()
        lines.append("# TYPE netrep_serve_requests_total counter")
        for name, t in sorted(st["tenants"].items()):
            for outcome in ("received", "done", "failed", "rejected",
                            "expired", "deduped"):
                lines.append(
                    f'netrep_serve_requests_total{{tenant="{name}",'
                    f'outcome="{outcome}"}} {t[outcome]}'
                )
        lines.append("# TYPE netrep_serve_brownout gauge")
        lines.append(f'netrep_serve_brownout {int(st["brownout"])}')
        lines.append("# TYPE netrep_serve_queue_depth gauge")
        for name, t in sorted(st["tenants"].items()):
            lines.append(
                f'netrep_serve_queue_depth{{tenant="{name}"}} '
                f'{t["queue_depth"]}'
            )
        lines.append("# TYPE netrep_serve_pool_hits_total counter")
        lines.append(f'netrep_serve_pool_hits_total {st["pool"]["hits"]}')
        lines.append("# TYPE netrep_serve_pool_misses_total counter")
        lines.append(
            f'netrep_serve_pool_misses_total {st["pool"]["misses"]}'
        )
        lines.append("# TYPE netrep_serve_packs_total counter")
        lines.append(f'netrep_serve_packs_total {st["packs"]}')
        with self._work:
            tenants = [(n, self._tenants[n]) for n in sorted(self._tenants)]
            now = time.monotonic()
            lines.append("# TYPE netrep_serve_latency_seconds histogram")
            for name, t in tenants:
                lines.extend(t.lat_hist.prom_lines(
                    "netrep_serve_latency_seconds", f'tenant="{name}"'
                ))
            lines.append(
                "# TYPE netrep_serve_request_device_seconds histogram"
            )
            for name, t in tenants:
                lines.extend(t.cost_hist.prom_lines(
                    "netrep_serve_request_device_seconds",
                    f'tenant="{name}"'
                ))
            for metric, key, kind in (
                ("netrep_serve_attributed_device_seconds_total",
                 "device_s", "counter"),
                ("netrep_serve_attributed_perms_total", "perms",
                 "counter"),
                ("netrep_serve_attributed_bytes_to_host_total",
                 "bytes_to_host", "counter"),
            ):
                lines.append(f"# TYPE {metric} {kind}")
                for name, t in tenants:
                    lines.append(
                        f'{metric}{{tenant="{name}"}} {t.cost[key]:g}'
                    )
            lines.append("# TYPE netrep_serve_slo_burn_rate gauge")
            for name, t in tenants:
                lines.append(
                    f'netrep_serve_slo_burn_rate{{tenant="{name}"}} '
                    f"{self._burn_rate_locked(t, now):g}"
                )
        parts.append("\n".join(lines) + "\n")
        return "".join(parts)
