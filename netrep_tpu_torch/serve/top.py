"""Live ops dashboard of a server or a serving fleet.

The port of ``netrep_tpu/serve/top.py``. A refresh-loop view over the
daemon's ``stats`` op: per-tenant queue depth, p50/p99 latency from the
pinned-bucket histograms, attributed device-seconds (total and per
wall-second), SLO burn rate, and the server-level brownout/inflight/pack
state; for a fleet coordinator's stats, one row per replica (liveness,
lifecycle state and generation, backlog, rate, packs). Everything is
derived from a ``stats()`` dict alone, so :func:`snapshot` runs against an
in-process server or fleet without a socket; the frame equals the JAX
package's on the same stats. The replica table keeps the JAX package's
``util`` column, which reads ``-`` here: the roofline gauge is ROADMAP.md
Queue 1 item 16b.
"""

from __future__ import annotations

import json
import sys
import time

#: tenant-table columns: (header, width, stats-row key, format)
_COLUMNS = (
    ("tenant", 10, "tenant", "s"),
    ("q", 4, "queue_depth", "d"),
    ("done", 6, "done", "d"),
    ("fail", 5, "failed", "d"),
    ("exp", 4, "expired", "d"),
    ("p50_ms", 8, "p50_ms", ".1f"),
    ("p99_ms", 8, "p99_ms", ".1f"),
    ("dev_s", 8, "device_s", ".3f"),
    ("dev_s/s", 8, "device_s_per_s", ".4f"),
    ("burn", 6, "burn_rate", ".2f"),
)


def snapshot(stats: dict) -> dict:
    """Shape the server's ``stats()`` dict into the dashboard snapshot:
    one row per tenant plus the server-level header fields (the ``--json``
    payload of the JAX package's ``top``)."""
    rows = []
    for name in sorted(stats.get("tenants", {})):
        t = stats["tenants"][name]
        cost = t.get("cost") or {}
        p50 = t.get("p50_s")
        p99 = t.get("p99_s")
        rows.append({
            "tenant": name,
            "queue_depth": int(t.get("queue_depth", 0)),
            "done": int(t.get("done", 0)),
            "failed": int(t.get("failed", 0)),
            "expired": int(t.get("expired", 0)),
            "deduped": int(t.get("deduped", 0)),
            "p50_ms": 1000.0 * p50 if p50 is not None else None,
            "p99_ms": 1000.0 * p99 if p99 is not None else None,
            "device_s": float(cost.get("device_s", 0.0)),
            "device_s_per_s": float(t.get("device_s_per_s", 0.0)),
            "perms": int(cost.get("perms", 0)),
            "bytes_to_host": int(cost.get("bytes_to_host", 0)),
            "burn_rate": float(t.get("burn_rate", 0.0)),
        })
    snap = {
        "tenants": rows,
        "brownout": bool(stats.get("brownout", False)),
        "accepting": bool(stats.get("accepting", True)),
        "inflight": int(stats.get("inflight", 0)),
        "packs": int(stats.get("packs", 0)),
        "uptime_s": float(stats.get("uptime_s", 0.0)),
        "slo_s": stats.get("slo_s"),
        "slo_budget": stats.get("slo_budget"),
    }
    # a fleet coordinator's stats: one row per replica, rendered as its
    # own table section
    if stats.get("replicas"):
        snap["fleet"] = True
        snap["replicas"] = [
            {
                "replica": rid,
                "alive": bool(r.get("alive", False)),
                "state": r.get("state"),
                "gen": int(r.get("gen", 0) or 0),
                "idle_s": r.get("idle_s"),
                "queue_depth": int(r.get("queue_depth", 0) or 0),
                "backlog_perms": int(r.get("backlog_perms", 0) or 0),
                "rate_pps": r.get("rate_pps"),
                "utilisation": r.get("utilisation"),
                "packs": int(r.get("packs", 0) or 0),
                "done": int(r.get("done", 0) or 0),
                "brownout": bool(r.get("brownout", False)),
            }
            for rid, r in sorted(stats["replicas"].items())
        ]
    return snap


def render_tenant_table(rows: list[dict]) -> str:
    """The tenant table: one row per tenant over the :data:`_COLUMNS`
    schema; missing quantiles (no completed requests yet) render as
    ``-``."""
    out = []
    out.append("  ".join(
        f"{h:>{w}}" if fmt != "s" else f"{h:<{w}}"
        for h, w, _k, fmt in _COLUMNS
    ))
    for r in rows:
        cells = []
        for _h, w, k, fmt in _COLUMNS:
            v = r.get(k)
            if fmt == "s":
                cells.append(f"{str(v):<{w}}")
            elif v is None:
                cells.append(f"{'-':>{w}}")
            else:
                cells.append(f"{v:>{w}{fmt}}")
        out.append("  ".join(cells))
    return "\n".join(out)


#: per-replica table columns of a fleet's dashboard
_REPLICA_COLUMNS = (
    ("replica", 10, "replica", "s"),
    ("up", 4, "up", "s"),
    # the lifecycle state (spawning/ready/draining/dead) and generation
    ("state", 9, "state", "s"),
    ("gen", 4, "gen", "d"),
    ("q", 4, "queue_depth", "d"),
    ("backlog", 8, "backlog_perms", "d"),
    ("rate/s", 9, "rate_pps", ".1f"),
    # the roofline gauge: `-` until it is ported (ROADMAP.md item 16b)
    ("util", 5, "utilisation", ".2f"),
    ("packs", 6, "packs", "d"),
    ("done", 6, "done", "d"),
)


def render_replica_table(rows: list[dict]) -> str:
    """The fleet's per-replica section: one row per replica over the
    :data:`_REPLICA_COLUMNS` schema (``up`` collapses alive/brownout into
    ``yes``/``brn``/``DEAD``)."""
    out = []
    out.append("  ".join(
        f"{h:>{w}}" if fmt != "s" else f"{h:<{w}}"
        for h, w, _k, fmt in _REPLICA_COLUMNS
    ))
    for r in rows:
        state = ("DEAD" if not r.get("alive")
                 else "brn" if r.get("brownout") else "yes")
        cells = []
        for _h, w, k, fmt in _REPLICA_COLUMNS:
            v = state if k == "up" else r.get(k)
            if fmt == "s":
                cells.append(f"{str(v if v is not None else '-'):<{w}}")
            elif v is None:
                cells.append(f"{'-':>{w}}")
            else:
                cells.append(f"{v:>{w}{fmt}}")
        out.append("  ".join(cells))
    return "\n".join(out)


def render(snap: dict) -> str:
    """One dashboard frame."""
    state = []
    state.append("BROWNOUT" if snap["brownout"] else "ok")
    if not snap["accepting"]:
        state.append("draining")
    head = (
        f"netrep serve{' fleet' if snap.get('fleet') else ''} · "
        f"up {snap['uptime_s']:.0f}s · "
        f"inflight {snap['inflight']} · packs {snap['packs']} · "
        f"state {'/'.join(state)}"
    )
    if snap.get("slo_s") is not None:
        head += (f" · slo {snap['slo_s']:g}s "
                 f"(budget {snap.get('slo_budget', 0):g})")
    parts = [head]
    if snap.get("replicas"):
        parts.append(render_replica_table(snap["replicas"]))
    if snap["tenants"]:
        parts.append(render_tenant_table(snap["tenants"]))
    elif not snap.get("replicas"):
        parts.append("(no tenants registered)")
    return "\n".join(parts)


def run_top(args) -> int:
    """Fetch the daemon's ``stats`` op over ``args.socket``, render (or
    dump JSON with ``args.json``), loop every ``args.interval`` seconds
    unless ``args.once``. Speaks only the wire."""
    from .client import SocketClient

    try:
        client = SocketClient(args.socket, timeout=args.timeout)
    except OSError as e:
        print(f"cannot connect to serve daemon at {args.socket!r}: {e}",
              file=sys.stderr)
        return 1
    try:
        while True:
            snap = snapshot(client.stats())
            if args.json:
                print(json.dumps(snap), flush=True)
            else:
                if not args.once:
                    # ANSI clear + home — the refresh-loop dashboard
                    sys.stdout.write("\x1b[2J\x1b[H")
                print(render(snap), flush=True)
            if args.once:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        try:
            client.close()
        except OSError:
            pass
