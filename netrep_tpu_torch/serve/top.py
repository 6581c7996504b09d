"""Live ops dashboard of the single server.

The port of ``netrep_tpu/serve/top.py`` without the fleet's replica table
(ROADMAP.md Queue 1 item 15.4). A refresh-loop view over the daemon's
``stats`` op: per-tenant queue depth, p50/p99 latency from the
pinned-bucket histograms, attributed device-seconds (total and per
wall-second), SLO burn rate, and the server-level brownout/inflight/pack
state. Everything is derived from ``PreservationServer.stats()`` alone, so
:func:`snapshot` runs against an in-process server without a socket; the
frame equals the JAX package's on the same stats.
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
    return {
        "tenants": rows,
        "brownout": bool(stats.get("brownout", False)),
        "accepting": bool(stats.get("accepting", True)),
        "inflight": int(stats.get("inflight", 0)),
        "packs": int(stats.get("packs", 0)),
        "uptime_s": float(stats.get("uptime_s", 0.0)),
        "slo_s": stats.get("slo_s"),
        "slo_budget": stats.get("slo_budget"),
    }


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


def render(snap: dict) -> str:
    """One dashboard frame."""
    state = []
    state.append("BROWNOUT" if snap["brownout"] else "ok")
    if not snap["accepting"]:
        state.append("draining")
    head = (
        f"netrep serve · "
        f"up {snap['uptime_s']:.0f}s · "
        f"inflight {snap['inflight']} · packs {snap['packs']} · "
        f"state {'/'.join(state)}"
    )
    if snap.get("slo_s") is not None:
        head += (f" · slo {snap['slo_s']:g}s "
                 f"(budget {snap.get('slo_budget', 0):g})")
    parts = [head]
    if snap["tenants"]:
        parts.append(render_tenant_table(snap["tenants"]))
    else:
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
