"""The fault ladder around every null loop of the port.

The port of ``netrep_tpu/utils/faults.py``: the same policy, plan
language, error taxonomy, event names and texts. The per-permutation keys
are ``fold_in(key, i)``, so re-dispatching chunk *i* draws identical
permutations and a resumed run equals an uninterrupted one; the ladder
turns that into recovery, one rung at a time:

1. **Retry with backoff** — a dispatch failure classified *transient*
   (:func:`classify_error`) is re-dispatched after exponential backoff
   with deterministic jitter, up to ``FaultPolicy.max_retries`` times.
2. **Abandon a hung dispatch** — with ``hang_timeout_s`` set (or the
   stall watchdog's warn→act escalation wired), dispatches run on a
   worker thread; a dispatch that neither returns nor errors is
   *abandoned* (``chunk_abandoned``), completed work is checkpointed and
   the chunk re-dispatched. More than ``max_abandons`` abandonments
   raise past the failure-save: a card that keeps hanging is not lost,
   so the work stays on it.
3. **Shrink the mesh** — a device-loss-class failure that left
   *survivors* (:func:`netrep_tpu_torch.utils.backend.
   enumerate_survivors`) rebuilds a smaller mesh from them and resumes
   from the checkpoint on it.
4. **Grow the mesh back** — when capacity returns (the injected
   ``capacity_restored`` plan kind, or :meth:`FaultRuntime.request_grow`),
   the loop raises :class:`CapacityRestoredError` at the next
   chunk/superchunk boundary, after committing and checkpointing, and the
   API layer rebuilds the original mesh and resumes.
5. **Degrade to the CPU** — the final rung, only under a policy with
   ``degrade_to_cpu=True`` (off by default in the port) and only when a
   device-loss-class failure left no device: :class:`DeviceLostError`
   propagates past the loop's failure-save, and
   ``models/preservation.py`` announces the rung
   (:func:`netrep_tpu_torch.utils.backend.degrade_to_cpu`), rebuilds the
   engine with ``device="cpu"`` from the host inputs and resumes from the
   checkpoint — touching no CUDA tensor, since a card that raised a
   sticky error has no usable context left.

**On the card.** A chunk's kernel launches return before the kernels
run, so a failure would surface at the next host copy, outside the
retry envelope. With a policy active the guarded call therefore records
a CUDA event on the stream of every device its outputs lie on and waits
for it (:func:`_block_ready`); without a policy the loops do not
synchronise and pay one ``None`` check per run. A dispatch run on the
abandon worker thread runs on the caller's current device and stream
(both are per thread in CUDA).

**Across processes.** On a mesh that spans processes
(:mod:`netrep_tpu_torch.parallel.distributed`) a chunk's dispatch ends in
a collective. A retry of a failure raised before the collective runs as
in one process: the re-dispatched chunk reaches the collective late, and
the peers wait for it there. An abandonment does not re-dispatch: the
walked-away thread may still enter the collective, and a second one
beside it, in this process alone, would no longer match the peers'
collectives. Neither does a rung that rebuilds the mesh. The rank raises
:class:`CrossProcessRungError` (rung ``'abandon'``, or the rebuild it
would take) after the failure-save, its peers' next collective raises
:class:`PeerLostError` (never retried) and failure-saves too, or a peer
waiting past its own ``hang_timeout_s`` abandons in turn, and a fresh
launch of every process resumes from process 0's checkpoint. The JAX
package shrinks its global mesh instead.

:func:`classify_error` keeps the JAX package's markers and adds the CUDA
vocabulary of a lost card (an uncorrectable ECC error, a card fallen off
the bus, every device busy or unavailable) as ``device_lost``. A kernel
fault is a bug: an illegal memory access, an unspecified launch failure,
a device-side assert or ``torch.cuda.OutOfMemoryError`` stay ``fatal``
and are never retried.

**Fault injection.** Plans are compact strings — ``"transient@128"``
(fail the dispatch covering permutation 128 once), ``"transient@128x3"``
(three successive attempts), ``"device_lost@64"``,
``"device_lost_partial@64"`` (half the mesh's devices die; survivors
remain), ``"capacity_restored@96"``, ``"hang@192"``, ``"interrupt@96"``,
``"fatal@32"``, ``"crash@64"`` (a :class:`SimulatedCrash`, a
``BaseException`` that unwinds past every recovery handler while the
failure-saves still run), ``"sigkill@64"`` (the process kills itself) —
joined with ``;``, set through ``FaultPolicy(plan=...)`` or the
``NETREP_FAULT_PLAN`` environment variable (which also activates a
default policy). Injection state lives on the :class:`FaultRuntime`,
which survives engine rebuilds within one call, so an injected device
loss fires once, not again on the resumed run.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable

import torch

from .config import FaultPolicy

logger = logging.getLogger("netrep_tpu_torch")

__all__ = [
    "FaultPolicy",
    "FaultRuntime",
    "FaultInjector",
    "FaultSpec",
    "CapacityRestoredError",
    "DeviceLostError",
    "PeerLostError",
    "CrossProcessRungError",
    "SimulatedCrash",
    "DispatchAbandonedError",
    "InjectedTransientError",
    "InjectedDeviceLost",
    "InjectedPartialDeviceLost",
    "InjectedFatalError",
    "classify_error",
    "parse_plan",
    "backoff_delay",
    "resolve_runtime",
]

#: env var holding a fault plan; when set it also ACTIVATES a default
#: FaultPolicy for runs that passed fault_policy=None (bench/CI injection)
PLAN_ENV = "NETREP_FAULT_PLAN"


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------


class InjectedTransientError(RuntimeError):
    """Injected stand-in for a retryable failure (a deadline, a dropped
    connection) — classified ``transient``."""


class InjectedDeviceLost(RuntimeError):
    """Injected stand-in for a lost/preempted device — classified
    ``device_lost``."""


class InjectedPartialDeviceLost(InjectedDeviceLost):
    """Injected PARTIAL device loss: some of the mesh's devices die but
    survivors remain — the mesh-shrink rung's stand-in. ``n_lost`` is the
    number of lost devices, or None for "half the current mesh" (the
    deterministic drill default;
    :func:`netrep_tpu_torch.utils.backend.enumerate_survivors` resolves it
    against the actual mesh)."""

    def __init__(self, msg: str, n_lost: int | None = None):
        super().__init__(msg)
        self.n_lost = n_lost


class CapacityRestoredError(Exception):
    """Control-flow signal, not a failure: lost device capacity is back,
    and the null loop should stop at the next chunk/superchunk boundary —
    after committing and checkpointing — so the API layer can rebuild the
    engine over the restored mesh and resume. Raised only by
    :meth:`FaultRuntime.check_grow` on runs that have a checkpoint to
    resume from."""


class InjectedFatalError(RuntimeError):
    """Injected stand-in for a genuine bug-class failure — never retried."""


class SimulatedCrash(BaseException):
    """In-process stand-in for a ``SIGKILL`` (plan kind ``crash``): a
    *BaseException* so it unwinds past every ``except Exception`` recovery
    handler — the loops' failure-save hooks still fire (modeling the
    periodic checkpoint that existed at kill time), but nothing retries,
    degrades, or reports; the thread that hit it is simply gone. The
    serving tier-1 kill→recover drill uses it because a test process
    cannot SIGKILL itself (the real signal rides the ``sigkill`` kind in
    the ``chaos --serve`` subprocess drill)."""


class DispatchAbandonedError(RuntimeError):
    """A hung dispatch was abandoned (timeout or watchdog escalation);
    classified ``transient`` so the normal retry ladder re-dispatches —
    except on a mesh that spans processes, where it becomes
    :class:`CrossProcessRungError`."""


class DeviceLostError(RuntimeError):
    """Raised to the API layer on a device-loss-class failure
    (``reason='device_lost'``), the error that caused it as its
    ``__cause__``: the ladder shrinks the mesh onto the survivors, or
    with none left takes the CPU rung under ``degrade_to_cpu=True`` and
    re-raises the cause otherwise. The loop's failure-save hook has
    already checkpointed every completed permutation when this
    propagates. Transient retries or abandonments run out on a live card
    raise their own errors, never this one (the JAX package hands those
    to the CPU rung too)."""

    def __init__(self, msg: str, reason: str = "device_lost"):
        super().__init__(msg)
        self.reason = reason


class PeerLostError(RuntimeError):
    """A collective of a process group failed: a peer process left, died
    or faulted outside the collective, or the group's timeout ran out.
    Classified ``fatal`` whatever its cause's text says: the group is
    broken, so a retry would only fail again or wait out another timeout.
    The loop's failure-save runs before it reaches the caller."""


class CrossProcessRungError(RuntimeError):
    """A device-loss-class failure or an abandoned dispatch on a mesh that
    spans processes. Every rung past a retry rebuilds the mesh (shrink,
    grow back, CPU), and no rank rebuilds a mesh across processes alone;
    an abandonment would re-dispatch beside a collective that may still
    be entered. So the rank raises this after the failure-save instead:
    ``rung`` names the rung the ladder would take (``'abandon'``,
    ``'shrink'``, ``'cpu'`` or ``'none'``), ``rank`` this process and
    ``checkpoint`` the file process 0 wrote (None without one). A fresh
    launch of every process resumes from it. The peers' next collective
    raises :class:`PeerLostError`. Classified ``fatal``: no layer above
    retries or degrades it either."""

    def __init__(self, rung: str, rank: int, world: int, checkpoint,
                 cause: BaseException):
        event = "dispatch abandoned" if rung == "abandon" else "device lost"
        what = ("no rung is left (no surviving device, degrade_to_cpu="
                "False)" if rung == "none" else
                "the fault ladder's abandon rung would re-dispatch the "
                "chunk while the abandoned dispatch may still enter its "
                "collective" if rung == "abandon" else
                f"the fault ladder's {rung} rung would rebuild the mesh")
        resume = (
            "Process 0 wrote every completed permutation to this call's "
            f"checkpoint ({checkpoint!r} as this rank names it); launch "
            "every process again with the same call to resume from it."
            if checkpoint is not None else
            "No checkpoint was asked for, so a new launch starts over.")
        super().__init__(
            f"rank {rank} of {world}: {event} ({type(cause).__name__}: "
            f"{cause}); {what}, and this mesh spans {world} processes, "
            f"whose collectives no rank changes alone. {resume}")
        self.rung, self.rank, self.checkpoint = rung, rank, checkpoint


#: lowercase substrings of ``"TypeName: message"`` that mark a failure as
#: retryable — the transport vocabulary of the JAX package's markers
_TRANSIENT_MARKERS = (
    "deadline exceeded",
    "deadline_exceeded",
    "unavailable",
    "connection reset",
    "connection refused",
    "connection closed",
    "broken pipe",
    "socket closed",
    "stream removed",
    "transport closed",
    "too many pings",
    "recvmsg",
    "temporarily",
)

#: markers of a lost/preempted device — not retryable in place; the
#: ladder (emergency checkpoint → shrink or CPU → resume) applies. The
#: JAX package's markers, then the CUDA runtime's, driver's and NVML's
#: words for a lost card.
_DEVICE_LOSS_MARKERS = (
    "device lost",
    "lost device",
    "device is lost",
    "device failure",
    "device disconnected",
    "chip has been lost",
    "preempted",
    "halted",
    "uncorrectable ecc error",
    "fallen off the bus",
    "busy or unavailable",
    "gpu is lost",
    "no cuda-capable device is detected",
    "uncorrectable nvlink error",
)

#: CUDA errors of a faulty kernel (or a full card): a bug, never retried
#: and never taken for a lost card, even where their text would match a
#: marker above
_CUDA_FATAL_MARKERS = (
    "illegal memory access",
    "unspecified launch failure",
    "device-side assert",
    "misaligned address",
    "illegal instruction",
    "out of memory",
)


def _is_oom(exc: BaseException) -> bool:
    oom = getattr(getattr(torch, "cuda", None), "OutOfMemoryError", None)
    return oom is not None and isinstance(exc, oom)


def classify_error(exc: BaseException) -> str:
    """``'transient'`` (retry in place), ``'device_lost'`` (degradation
    ladder), or ``'fatal'`` (propagate — the default, so genuine bugs are
    never silently retried). Classification keys on exception type first
    (injected faults, connection errors, ``torch.cuda.OutOfMemoryError``),
    then on the lowercased ``"TypeName: message"`` text, because CUDA
    failures surface as generic ``RuntimeError``\\ s (``"CUDA error:
    ..."``) with the runtime's message."""
    if isinstance(exc, (PeerLostError, CrossProcessRungError)):
        return "fatal"
    if isinstance(exc, (InjectedTransientError, DispatchAbandonedError)):
        return "transient"
    if isinstance(exc, InjectedDeviceLost):
        return "device_lost"
    if isinstance(exc, InjectedFatalError) or _is_oom(exc):
        return "fatal"
    text = f"{type(exc).__name__}: {exc}".lower()
    if any(m in text for m in _CUDA_FATAL_MARKERS):
        return "fatal"
    if any(m in text for m in _DEVICE_LOSS_MARKERS):
        return "device_lost"
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return "transient"
    if any(m in text for m in _TRANSIENT_MARKERS):
        return "transient"
    return "fatal"


# ---------------------------------------------------------------------------
# Fault plans (deterministic injection harness)
# ---------------------------------------------------------------------------

_KINDS = ("transient", "device_lost", "device_lost_partial",
          "capacity_restored", "fatal", "hang", "interrupt", "crash",
          "sigkill")

_RAISERS = {
    "transient": lambda spec: InjectedTransientError(
        f"injected transient fault at permutation {spec.at_perm}"
    ),
    "device_lost": lambda spec: InjectedDeviceLost(
        f"injected device loss at permutation {spec.at_perm}"
    ),
    "device_lost_partial": lambda spec: InjectedPartialDeviceLost(
        f"injected partial device loss at permutation {spec.at_perm}"
    ),
    "fatal": lambda spec: InjectedFatalError(
        f"injected fatal fault at permutation {spec.at_perm}"
    ),
}


@dataclass(frozen=True)
class FaultSpec:
    """One planned fault: raise ``kind`` on the dispatch whose permutation
    range ``[start, start+take)`` covers ``at_perm``, ``times`` successive
    attempts in a row."""

    kind: str
    at_perm: int
    times: int = 1


def parse_plan(spec) -> tuple[FaultSpec, ...]:
    """Parse a plan — a spec string (``"kind@perm[xN]"`` entries joined by
    ``;`` or ``,``), an iterable of :class:`FaultSpec`, or None/"" (empty
    plan). Raises ``ValueError`` on malformed entries so a typo'd CI env
    var fails loudly instead of silently injecting nothing."""
    if not spec:
        return ()
    if not isinstance(spec, str):
        out = tuple(spec)
        for s in out:
            if not isinstance(s, FaultSpec):
                raise ValueError(f"not a FaultSpec: {s!r}")
        return out
    out = []
    for entry in spec.replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        try:
            kind, at = entry.split("@", 1)
            times = 1
            if "x" in at:
                at, times_s = at.split("x", 1)
                times = int(times_s)
            fs = FaultSpec(kind.strip(), int(at), times)
        except ValueError as e:
            raise ValueError(
                f"malformed fault-plan entry {entry!r} (want "
                f"'kind@perm' or 'kind@permxN'): {e}"
            ) from None
        if fs.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {fs.kind!r} in plan entry {entry!r}; "
                f"one of {_KINDS}"
            )
        if fs.at_perm < 0 or fs.times < 1:
            raise ValueError(f"bad fault-plan entry {entry!r}")
        out.append(fs)
    return tuple(out)


class FaultInjector:
    """Stateful consumer of a fault plan: :meth:`poll` returns the next
    unconsumed spec covering the dispatch's permutation range (and
    decrements its remaining count), or None. State is per-injector, so a
    runtime shared across an engine rebuild (CPU degradation) never
    re-fires a consumed fault on the resumed dispatches."""

    def __init__(self, specs: tuple[FaultSpec, ...]):
        self.specs = tuple(specs)
        self._remaining = [s.times for s in self.specs]

    def poll(self, start: int, take: int) -> FaultSpec | None:
        for i, s in enumerate(self.specs):
            if self._remaining[i] > 0 and start <= s.at_perm < start + take:
                self._remaining[i] -= 1
                return s
        return None

    @property
    def pending(self) -> int:
        return sum(self._remaining)


# ---------------------------------------------------------------------------
# Retry / abandon / degradation runtime
# ---------------------------------------------------------------------------


def backoff_delay(policy: FaultPolicy, start: int, attempt: int) -> float:
    """Exponential backoff with *deterministic* jitter: the jitter factor
    hashes ``(start, attempt)``, so a rerun of the same faulted run sleeps
    the same schedule (no hidden RNG state, reproducible bench traces)."""
    d = min(
        policy.backoff_max_s,
        policy.backoff_base_s * policy.backoff_factor ** (attempt - 1),
    )
    if policy.backoff_jitter:
        h = int.from_bytes(
            hashlib.blake2b(
                f"{start}:{attempt}".encode(), digest_size=8
            ).digest(),
            "big",
        )
        d *= 1.0 + policy.backoff_jitter * (h / float(2 ** 64) * 2.0 - 1.0)
    return max(0.0, d)


def _cuda_devices(outs, found: dict) -> dict:
    """The CUDA devices of every tensor in a nested output (tensors,
    lists, tuples, dicts, dataclass-like objects with ``__dict__``)."""
    if isinstance(outs, torch.Tensor):
        if outs.is_cuda:
            found[outs.device] = None
    elif isinstance(outs, dict):
        for v in outs.values():
            _cuda_devices(v, found)
    elif isinstance(outs, (list, tuple)):
        for v in outs:
            _cuda_devices(v, found)
    return found


def _block_ready(outs):
    """Wait, inside the retry scope, until the kernels that produce
    ``outs`` have run: a CUDA event recorded on the current stream of each
    device the outputs lie on, then ``synchronize()``. Kernel launches are
    asynchronous, so without this a failure would surface at the next
    chunk's host copy, outside the per-chunk retry envelope. CPU outputs
    are ready already."""
    for dev in _cuda_devices(outs, {}):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
    return outs


class FaultRuntime:
    """One run's (or one ``module_preservation`` call's) fault-tolerance
    state: the policy, the injector, and the abandon machinery. The null
    loops accept it (or a :class:`FaultPolicy`/True) via ``fault_policy=``
    and wrap every chunk dispatch in :meth:`run_dispatch`."""

    #: worker-thread completion poll period (abandonable dispatches)
    _poll_s = 0.02

    def __init__(self, policy: FaultPolicy,
                 sleep: Callable[[float], None] = time.sleep):
        self.policy = policy
        spec = policy.plan if policy.plan else os.environ.get(PLAN_ENV)
        specs = parse_plan(spec)
        self.injector = FaultInjector(specs) if specs else None
        if (any(s.kind == "hang" for s in specs)
                and policy.hang_timeout_s is None):
            raise ValueError(
                "a 'hang' fault plan needs fault_policy.hang_timeout_s so "
                "the abandoned dispatch can be detected deterministically"
            )
        self._sleep = sleep
        self._abandon = threading.Event()
        self._abandons = 0
        self._wd_wired = False
        # -- elastic mesh state, shared across engine rebuilds ------------
        #: the API layer set this after a mesh-shrink rebuild; check_grow
        #: only ever fires while it is True (growing a never-shrunk mesh
        #: is meaningless, so a stray capacity signal is consumed silently)
        self.mesh_shrunk = False
        #: elastic rebuilds (shrink + grow) performed so far this run —
        #: the API layer caps it at policy.max_mesh_rebuilds
        self.mesh_rebuilds = 0
        self._grow = threading.Event()
        #: ``(rank, world, checkpoint)`` while a null loop on a mesh that
        #: spans processes holds this runtime (the loop sets it at its
        #: start, None otherwise): an abandonment there is terminal
        self.across = None

    # -- elastic capacity signal -------------------------------------------

    def request_grow(self) -> None:
        """Signal that lost device capacity is back. Thread-safe — an
        external capacity monitor may call it at any time; the injected
        ``capacity_restored`` plan kind routes through it too. The loop
        acts at its next chunk boundary (:meth:`check_grow`)."""
        self._grow.set()

    def check_grow(self) -> None:
        """Called by the null loops at each chunk/superchunk boundary
        (committed state only, checkpoint writable): raise
        :class:`CapacityRestoredError` when a grow signal is pending AND
        the mesh was previously shrunk. A signal with nothing to grow
        back to is consumed silently — capacity news on a healthy mesh
        is not actionable."""
        if not self._grow.is_set():
            return
        self._grow.clear()
        if not self.mesh_shrunk:
            return
        raise CapacityRestoredError(
            "device capacity restored; rebuild the mesh at this chunk "
            "boundary and resume from checkpoint"
        )

    # -- watchdog escalation (warn → act) ----------------------------------

    def watchdog_escalation(self, rescue: Callable[[], None] | None):
        """``(action, action_factor)`` for
        :func:`netrep_tpu_torch.utils.telemetry.arm_watchdog`: when a stall
        outlasts ``stall_action_factor`` × the steady chunk time, the
        watchdog THREAD checkpoints completed work (``rescue``) and flags
        the in-flight dispatch for abandonment — the loop thread is
        blocked inside the dispatch and cannot act itself. ``(None,
        None)`` when the policy keeps the watchdog warn-only."""
        if not self.policy.watchdog_action:
            return None, None
        self._wd_wired = True

        def action():
            try:
                if rescue is not None:
                    rescue()
            # netrep: allow(exception-taxonomy) — best-effort emergency checkpoint; the watchdog still abandons the hung dispatch either way
            except Exception:
                logger.warning(
                    "emergency checkpoint from the stall watchdog failed",
                    exc_info=True,
                )
            self._abandon.set()

        return action, self.policy.stall_action_factor

    # -- dispatch wrapper ---------------------------------------------------

    def run_dispatch(
        self,
        call: Callable[[], object],
        *,
        start: int,
        take: int,
        telemetry=None,
        rescue: Callable[[], None] | None = None,
        label: str = "chunk",
    ):
        """Evaluate ``call()`` (blocked until ready) under the recovery
        ladder. ``start``/``take`` name the dispatch's permutation range —
        the retry identity (re-dispatch regenerates the same ``fold_in``
        keys) and the injection coordinate. ``rescue()`` checkpoints
        completed work before an abandonment. A failed attempt leaves no
        loop state to restore: the streaming loops fold each attempt into
        fresh tallies (the JAX package's ``reset()`` rebuilds its donated
        tally carry instead). Raises :class:`DeviceLostError` for the
        degradation ladder, :class:`CrossProcessRungError` for an
        abandonment while :attr:`across` is set, re-raises fatal errors,
        and passes ``KeyboardInterrupt``
        through untouched (the loops' clean-interrupt contract)."""
        pol = self.policy
        attempt = 0
        while True:
            hang = False
            err = None
            fault = (
                self.injector.poll(start, take)
                if self.injector is not None else None
            )
            if fault is not None and fault.kind == "capacity_restored":
                # not a failure: set the grow signal (acted on by the loop
                # at the NEXT chunk boundary, after this dispatch commits)
                # and keep dispatching; a second spec may cover this range
                if telemetry is not None:
                    telemetry.emit(
                        "fault_injected", kind=fault.kind,
                        at_perm=int(fault.at_perm), start=int(start),
                        take=int(take), label=label,
                    )
                logger.warning(
                    "capacity restored (injected) at permutation %d; the "
                    "mesh grows back at the next %s boundary",
                    fault.at_perm, label,
                )
                self.request_grow()
                fault = (
                    self.injector.poll(start, take)
                    if self.injector is not None else None
                )
            if fault is not None:
                if telemetry is not None:
                    telemetry.emit(
                        "fault_injected", kind=fault.kind,
                        at_perm=int(fault.at_perm), start=int(start),
                        take=int(take), label=label,
                    )
                logger.warning(
                    "fault injected: %s at permutation %d (%s dispatch "
                    "at %d)", fault.kind, fault.at_perm, label, start,
                )
                if fault.kind == "interrupt":
                    raise KeyboardInterrupt
                if fault.kind == "sigkill":
                    # the real thing, for the chaos --serve subprocess
                    # drill: the process dies HERE, mid-pack, with no
                    # cleanup — recovery must come from the journal and
                    # the periodic checkpoints alone
                    import signal as _signal

                    os.kill(os.getpid(), _signal.SIGKILL)
                if fault.kind == "crash":
                    # in-process SIGKILL stand-in (BaseException): the
                    # loops' failure-save hooks run, nothing else does
                    raise SimulatedCrash(
                        f"injected crash at permutation {fault.at_perm}"
                    )
                if fault.kind == "hang":
                    hang = True
                else:
                    err = _RAISERS[fault.kind](fault)
            try:
                if err is not None:
                    raise err
                # an injected hang waits on an event that only its own
                # abandonment sets, so the walked-away thread ends too
                release = threading.Event() if hang else None
                target = (
                    release.wait if hang
                    else (lambda: _block_ready(call()))
                )
                if hang or pol.hang_timeout_s is not None or self._wd_wired:
                    return self._call_abandonable(
                        target, telemetry=telemetry, start=start, take=take,
                        rescue=rescue, label=label,
                        on_abandon=None if release is None else release.set,
                    )
                return target()
            except KeyboardInterrupt:
                raise
            except Exception as e:
                kind = classify_error(e)
                if kind == "device_lost":
                    if telemetry is not None:
                        telemetry.emit(
                            "device_lost", start=int(start), take=int(take),
                            error=type(e).__name__, label=label,
                        )
                    logger.warning(
                        "device-loss-class failure during %s dispatch at "
                        "permutation %d: %s: %s", label, start,
                        type(e).__name__, e,
                    )
                    raise DeviceLostError(
                        f"device lost during {label} dispatch at "
                        f"permutation {start}; completed work is "
                        "checkpointed — shrink onto the survivors (or "
                        "degrade to CPU) and resume"
                    ) from e
                if kind != "transient":
                    raise
                if (isinstance(e, DispatchAbandonedError)
                        and self.across is not None):
                    # the walked-away thread may still enter the chunk's
                    # collective: no second dispatch beside it
                    raise CrossProcessRungError("abandon", *self.across,
                                                e) from e
                if attempt >= pol.max_retries:
                    # retries exhausted: the last transient error
                    # propagates past the loop's failure-save; the card
                    # answered, so the work does not move off it
                    raise
                attempt += 1
                delay = backoff_delay(pol, start, attempt)
                if telemetry is not None:
                    telemetry.emit(
                        "retry_attempt", start=int(start), take=int(take),
                        attempt=attempt, max_retries=pol.max_retries,
                        delay_s=float(delay), error=type(e).__name__,
                        label=label,
                    )
                logger.warning(
                    "transient %s during %s dispatch at permutation %d; "
                    "retry %d/%d in %.2gs", type(e).__name__, label, start,
                    attempt, pol.max_retries, delay,
                )
                if delay > 0:
                    self._sleep(delay)

    def _call_abandonable(self, target, *, telemetry, start, take, rescue,
                          label, on_abandon=None):
        """Run ``target`` on a daemon worker thread so a hung dispatch (a
        kernel that never ends, a synchronisation that never returns) can
        be walked away from: on ``hang_timeout_s`` elapsing or the
        watchdog's abandon flag, emit ``chunk_abandoned``, checkpoint
        completed work, and raise :class:`DispatchAbandonedError`
        (transient → the retry ladder re-dispatches). A really hung thread
        is leaked deliberately — it is blocked in native code and cannot
        be interrupted; a later completion is discarded. ``on_abandon``
        releases an injected hang's thread."""
        box: dict = {}
        done = threading.Event()
        # CUDA's current device and stream are per thread: the worker runs
        # the dispatch on the caller's
        stream = (torch.cuda.current_stream()
                  if torch.cuda.is_initialized() else None)

        def worker():
            try:
                if stream is not None:
                    torch.cuda.set_device(stream.device)
                    with torch.cuda.stream(stream):
                        box["out"] = target()
                else:
                    box["out"] = target()
            # netrep: allow(exception-taxonomy) — not swallowed: captured verbatim (BaseException included) and re-raised on the loop thread by the done.wait consumer
            except BaseException as e:  # delivered to the loop thread below
                box["err"] = e
            finally:
                done.set()

        self._abandon.clear()
        t0 = time.monotonic()
        threading.Thread(
            target=worker, name="netrep-ft-dispatch", daemon=True
        ).start()
        deadline = self.policy.hang_timeout_s
        while not done.wait(self._poll_s):
            waited = time.monotonic() - t0
            timed_out = deadline is not None and waited > deadline
            if not (self._abandon.is_set() or timed_out):
                continue
            by = "watchdog" if self._abandon.is_set() else "timeout"
            if on_abandon is not None:
                on_abandon()
            self._abandons += 1
            if telemetry is not None:
                telemetry.emit(
                    "chunk_abandoned", start=int(start), take=int(take),
                    waited_s=float(waited), by=by,
                    abandons=self._abandons, label=label,
                )
            logger.warning(
                "abandoning hung %s dispatch at permutation %d after "
                "%.2gs (%s); completed work is checkpointed and the "
                "chunk will be re-dispatched", label, start, waited, by,
            )
            if by == "timeout" and rescue is not None:
                # the watchdog path already checkpointed from its thread
                try:
                    rescue()
                # netrep: allow(exception-taxonomy) — best-effort emergency checkpoint; the abandon raises DispatchAbandonedError regardless
                except Exception:
                    logger.warning(
                        "emergency checkpoint on abandon failed",
                        exc_info=True,
                    )
            if self._abandons > self.policy.max_abandons:
                # repeated hangs: stop spinning and raise past the
                # failure-save (the card is slow or stuck, not lost, so
                # the work does not move off it)
                raise RuntimeError(
                    f"{label} dispatch abandoned {self._abandons} times "
                    f"(max_abandons={self.policy.max_abandons}); backend "
                    "presumed dead"
                )
            raise DispatchAbandonedError(
                f"{label} dispatch at permutation {start} abandoned "
                f"after {waited:.2g}s ({by})"
            )
        if "err" in box:
            raise box["err"]
        return box["out"]


def resolve_runtime(arg) -> FaultRuntime | None:
    """``fault_policy=`` argument → runtime: None/False = off (unless
    ``NETREP_FAULT_PLAN`` is set, which activates a default policy so CI
    and bench can inject faults into any run — the port's default, so
    without the CPU rung); True = default policy; a
    :class:`FaultPolicy` builds a fresh runtime; an existing
    :class:`FaultRuntime` passes through — how ``module_preservation``
    shares one injector across a mid-run engine rebuild."""
    if isinstance(arg, FaultRuntime):
        return arg
    if arg is None or arg is False:
        if not os.environ.get(PLAN_ENV):
            return None
        return FaultRuntime(FaultPolicy())
    if arg is True:
        return FaultRuntime(FaultPolicy())
    if isinstance(arg, FaultPolicy):
        return FaultRuntime(arg)
    raise TypeError(
        "fault_policy must be None/False, True, a FaultPolicy, or a "
        f"FaultRuntime; got {type(arg).__name__}"
    )
