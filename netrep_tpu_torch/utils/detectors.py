"""Pinned anomaly-detector registry.

The port of ``netrep_tpu/utils/detectors.py``. Each signal here is
computed somewhere else — the stall watchdog's warn→act escalation, the
fault ladder's ``device_lost`` and ``degraded_to_cpu``, SLO burn past its
budget, brownout, replica failover and eviction, a refused checkpoint —
and was only logged. A firing detector emits ONE ``anomaly_detected``
event (carrying ``detector=<name>``), warns through the package logger
and, when ``NETREP_BUNDLE_DIR`` names a directory, collects a diagnostic
bundle (:mod:`netrep_tpu_torch.utils.bundle`), rate-limited per detector
so that a storm of anomalies cannot fill a disk.

Two paths feed :func:`fire`:

- **event-mapped** (:data:`EVENT_DETECTORS`): anomalies that already are
  telemetry events are picked up by :func:`scan`, which the flight
  observer calls with every emitted record;
- **site-fired**: the stall escalation (``utils/telemetry.py``), the
  checkpoint refusals (``utils/checkpoint.py``), the SLO burn
  (``serve/scheduler.py``), the CLI's ledger gates (``perf --check`` →
  ``perf_drift``, ``roofline --check`` → ``roofline_drift``,
  ``__main__.py``) and the kernel-library store's quarantine
  (``aot_refused``, ``utils/aot.py``) call :func:`fire` where they decide.

``anomaly_detected`` is emitted on the bus that carried (or observed) the
signal, so a user run's JSONL tells its own anomaly story; the flight
ring sees it either way. ``DETECTORS`` is pinned: bundles and tests key
on these names, as on the JAX package's.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from . import telemetry as tm

logger = logging.getLogger("netrep_tpu_torch")

#: the complete pinned catalogue of anomaly detectors
DETECTORS = (
    "stall_escalation",    # watchdog warn→act: hung dispatch abandoned
    "device_lost",         # fault ladder: a device died
    "degraded_to_cpu",     # fault ladder: run continued on the CPU
    "slo_burn",            # serve: tenant burn rate exceeded its budget
    "brownout",            # serve: scheduler entered brownout shedding
    "replica_failover",    # fleet: unnoticed replica loss → failover
    "replica_evicted",     # fleet: noticed eviction → handoff
    "perf_drift",          # ledger check: throughput regressed
    "roofline_drift",      # ledger check: utilisation regressed
    "checkpoint_refused",  # checkpoint: resume refused (identity mismatch)
    "aot_refused",         # AOT store: entry quarantined as unusable
)

#: telemetry event name → detector, for anomalies that already ride the
#: bus as events (the scan path)
EVENT_DETECTORS = {
    "device_lost": "device_lost",
    "degraded_to_cpu": "degraded_to_cpu",
    "serve_brownout_enter": "brownout",
    "replica_lost": "replica_failover",
    "evict_notice": "replica_evicted",
}

#: auto-bundle opt-in: when set, a firing detector collects a diagnostic
#: bundle under this directory (rate-limited per detector)
BUNDLE_DIR_ENV = "NETREP_BUNDLE_DIR"

#: minimum seconds between auto-collected bundles of the SAME detector —
#: a storm (a retry loop of device losses) yields one bundle, not one per
#: event
COOLDOWN_S = 60.0

_lock = threading.Lock()
_last_bundle: dict[str, float] = {}


def scan(bus, record: dict) -> None:
    """Event-mapped detection: called by the flight observer with every
    record emitted on any bus. Forensic events are ignored (a detector
    never re-triggers off its own output); everything else is matched
    against :data:`EVENT_DETECTORS`."""
    ev = record.get("ev")
    if ev in tm.FORENSIC_EVENTS:
        return
    name = EVENT_DETECTORS.get(ev)
    if name is None:
        return
    data = record.get("data") or {}
    info = {
        k: v for k, v in data.items()
        if k not in ("span", "parent")
        and isinstance(v, (str, int, float, bool))
    }
    fire(name, telemetry=bus, **info)


def fire(name: str, telemetry=None, **data) -> str | None:
    """Fire one pinned detector: emit ``anomaly_detected`` (on the given
    bus, else the ambient one), warn through the package logger, and
    collect a diagnostic bundle when ``NETREP_BUNDLE_DIR`` is set. Returns
    the bundle's path when one was written, else None."""
    if name not in DETECTORS:
        raise ValueError(f"unknown detector {name!r}; pinned: {DETECTORS}")
    tel = tm.resolve(telemetry)
    if tel is not None:
        tel.emit("anomaly_detected", detector=name, **data)
    logger.warning(
        "anomaly detected [%s]%s", name,
        (": " + " ".join(f"{k}={v}" for k, v in sorted(data.items()))
         if data else ""),
    )
    return maybe_bundle(name, telemetry=tel)


def maybe_bundle(name: str, telemetry=None,
                 clock=time.monotonic) -> str | None:
    """Collect a bundle for detector ``name`` if enabled and out of
    cooldown. Best-effort: a failed collection warns, never raises."""
    root = os.environ.get(BUNDLE_DIR_ENV)
    if not root:
        return None
    now = clock()
    with _lock:
        last = _last_bundle.get(name)
        if last is not None and now - last < COOLDOWN_S:
            return None
        _last_bundle[name] = now
    from . import bundle

    try:
        return bundle.collect(
            os.path.join(root, f"netrep-bundle-{name}"),
            reason=name, telemetry=telemetry,
        )
    # netrep: allow(exception-taxonomy) — collection is best-effort forensics; a bundle failure must never turn an anomaly into a crash
    except Exception:
        logger.warning("diagnostic bundle collection for %r failed",
                       name, exc_info=True)
        return None


def reset() -> None:
    """Forget the per-detector cooldown state (tests)."""
    with _lock:
        _last_bundle.clear()
