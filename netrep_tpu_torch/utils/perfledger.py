"""Append-only throughput ledger and its regression check.

The port of ``netrep_tpu/utils/perfledger.py`` (standard library only,
copied: the port imports nothing of the JAX package). Every measured run
may append one JSON line — a *throughput fingerprint*: backend,
problem-shape key, mode, perms/s, compile estimate — and :func:`check`
compares the newest entry against the robust median of its *matching*
history (same fingerprint), failing when it regressed beyond the
threshold.

The line format is the JAX package's, so each package reads the other's
ledger (``tests/test_torch_perfledger.py``)::

    {"perf_v": 1, "t": <unix s>, "source": "run"|"bench"|"ingest"|"serve",
     "round": <int|None>, "run": <run id|None>, "fingerprint": <str>,
     "backend": <str>, "mode": <str|None>, "perms_per_sec": <float>,
     "compile_s": <float|None>, "n_perm": <int|None>, "metric": <str|None>}

``backend`` is the port's device type (``"cuda"``/``"cpu"``), never a JAX
backend name; bench fingerprints carry the backend *class*
(:func:`_backend_class`: ``tpu``/``gpu``/``cpu``), so a card's entry never
compares against TPU or CPU history.

Writers in the port: the serving fleet's replicas (the
``serve-fleet-coldstart|<label>|<backend>`` entry of a replica's first
pack, :meth:`~netrep_tpu_torch.serve.scheduler.PreservationServer.
_maybe_record_coldstart`). Readers: the server's and the fleet's rate
fallback (:func:`serve_rate`). :func:`maybe_record_run` is the engine null
loops' hook; the loops do not
call it yet (ROADMAP.md Queue 1 item 16b, with the roofline). Appends are
best-effort (an unwritable ledger warns once and never fails the run),
reads are tolerant (foreign lines are skipped). :func:`check_roofline`
reads roofline blocks where entries carry them; the port writes none.
"""

from __future__ import annotations

import json
import logging
import os
import time

logger = logging.getLogger("netrep_tpu_torch")

#: entry-line format version (bump deliberately, with the golden test)
ENTRY_VERSION = 1

#: env var naming the ledger path (both packages read it); writers
#: append only when it is set
LEDGER_ENV = "NETREP_PERF_LEDGER"

#: default regression threshold: newest/median < (1 - threshold) fails.
#: 0.4 is the JAX package's threshold: it tolerates host-contention
#: drift while still catching a 2× regression outright.
DEFAULT_THRESHOLD = 0.4

#: how many most-recent matching entries the median is taken over
DEFAULT_WINDOW = 8

_APPEND_WARNED = False


def default_path() -> str:
    """Ledger path resolution shared by the readers and the writers: the
    ``NETREP_PERF_LEDGER`` env var, else ``netrep_perf_ledger.jsonl`` in
    the CWD."""
    return os.environ.get(LEDGER_ENV) or os.path.join(
        os.getcwd(), "netrep_perf_ledger.jsonl"
    )


#: version of the OPTIONAL per-tenant attributed-cost block a ledger
#: entry may carry: ``{"cost_v": 1, "cost": {tenant: {device_s, perms,
#: bytes_to_host}}}`` appended after the pinned base keys. Entries
#: without costs keep the pinned base key order.
COST_VERSION = 1

#: version of the OPTIONAL roofline block a ledger entry may carry
#: (the JAX package writes it; the port reads it): ``{"roofline_v": 1,
#: "roofline": {family, flops_per_perm, bytes_per_perm, flops, bytes_hbm,
#: device_kind, peak_flops, peak_bw, sol_pps, achieved_pps,
#: utilisation}}`` appended after the pinned base keys (and after any
#: ``cost`` block). Entries without it keep the pinned base key order.
ROOFLINE_VERSION = 1


def make_entry(
    fingerprint: str,
    perms_per_sec: float,
    source: str,
    backend: str = "",
    mode: str | None = None,
    compile_s: float | None = None,
    n_perm: int | None = None,
    run_id: str | None = None,
    round_n: int | None = None,
    metric: str | None = None,
    t: float | None = None,
    cost: dict | None = None,
    roofline: dict | None = None,
) -> dict:
    """One ledger line, in pinned key order (golden-shape test); the
    optional ``cost`` rollup appends ``cost_v``/``cost`` and the optional
    ``roofline`` block appends ``roofline_v``/``roofline`` after the base
    keys so measurement-carrying rows extend the schema without
    disturbing it."""
    entry = {
        "perf_v": ENTRY_VERSION,
        "t": float(t) if t is not None else time.time(),
        "source": str(source),
        "round": int(round_n) if round_n is not None else None,
        "run": run_id,
        "fingerprint": str(fingerprint),
        "backend": str(backend),
        "mode": mode,
        "perms_per_sec": round(float(perms_per_sec), 4),
        "compile_s": (
            round(float(compile_s), 4) if compile_s is not None else None
        ),
        "n_perm": int(n_perm) if n_perm is not None else None,
        "metric": metric,
    }
    if cost is not None:
        entry["cost_v"] = COST_VERSION
        entry["cost"] = cost
    if roofline is not None:
        entry["roofline_v"] = ROOFLINE_VERSION
        entry["roofline"] = roofline
    return entry


def append_entry(entry: dict, path: str | None = None) -> bool:
    """Append one entry (flushed line). Best-effort: an unwritable ledger
    warns once per process and returns False — recording a measurement
    must never fail the run that produced it."""
    global _APPEND_WARNED
    path = path or default_path()
    try:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(entry) + "\n")
        return True
    except OSError as e:
        if not _APPEND_WARNED:
            _APPEND_WARNED = True
            logger.warning("perf ledger %r not writable (%s: %s); "
                           "throughput entries are dropped", path,
                           type(e).__name__, e)
        return False


def read_entries(path: str) -> list[dict]:
    """All ledger entries in file order, skipping foreign/corrupt lines
    (the ledger may share a file with bench rows or telemetry events)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if (isinstance(row, dict) and row.get("perf_v") == ENTRY_VERSION
                    and isinstance(row.get("fingerprint"), str)
                    and isinstance(row.get("perms_per_sec"), (int, float))):
                out.append(row)
    return out


def serve_rate(path: str | None = None,
               window: int = DEFAULT_WINDOW) -> float | None:
    """The rate a server (or a fleet, per replica) assumes before it has
    measured its own: the upper median of the last ``window`` ``serve`` and
    ``run`` entries' perms/s — None without such an entry or a ledger."""
    try:
        vals = [float(e["perms_per_sec"])
                for e in read_entries(path or default_path())
                if e.get("source") in ("serve", "run")][-int(window):]
    except OSError:
        return None
    return sorted(vals)[len(vals) // 2] if vals else None


def maybe_record_run(
    fingerprint: str,
    perms_per_sec: float,
    mode: str,
    backend: str,
    compile_s: float | None = None,
    n_perm: int | None = None,
    run_id: str | None = None,
    roofline: dict | None = None,
) -> bool:
    """Engine-loop hook: append a run entry when ``NETREP_PERF_LEDGER``
    names a ledger; silently a no-op otherwise (the env-gated contract —
    telemetry-on runs pay one getenv)."""
    path = os.environ.get(LEDGER_ENV)
    if not path or not perms_per_sec > 0:
        return False
    return append_entry(
        make_entry(fingerprint, perms_per_sec, "run", backend=backend,
                   mode=mode, compile_s=compile_s, n_perm=n_perm,
                   run_id=run_id, roofline=roofline),
        path,
    )


# ---------------------------------------------------------------------------
# bench-row conversion + bench-round file ingestion
# ---------------------------------------------------------------------------


def _backend_class(device: str) -> str:
    d = device.lower()
    if "tpu" in d:
        return "tpu"
    if "cpu" in d:
        return "cpu"
    if "gpu" in d or "cuda" in d:
        return "gpu"
    return device or "unknown"


def bench_fingerprint(row: dict) -> str | None:
    """Grouping identity of a bench metric row: the metric label up to its
    parenthesized config note / fallback suffix, plus backend class,
    chunk, and dtype — so r01's TPU north row and r05's CPU-fallback north
    row form two histories that never compare against each other."""
    metric = row.get("metric")
    if not isinstance(metric, str) or not metric:
        return None
    base = metric.split(" [", 1)[0].split(" (", 1)[0].strip()
    parts = [f"bench|{base}", _backend_class(str(row.get("device", "")))]
    if row.get("chunk") is not None:
        parts.append(f"chunk:{row['chunk']}")
    if row.get("dtype"):
        parts.append(f"dtype:{row['dtype']}")
    return "|".join(parts)


def entry_from_bench_row(row: dict, source: str = "bench",
                         round_n: int | None = None,
                         t: float | None = None,
                         mode: str = "bench") -> dict | None:
    """Bench metric row → ledger entry, or None for rows without a
    throughput number (warning/error/skip rows). ``source``/``mode``
    default to the bench path; the serve load generator passes
    ``source="serve"`` so serving-path rows form their own provenance
    class in the ledger."""
    pps = row.get("perms_per_sec")
    if not isinstance(pps, (int, float)) or not pps > 0:
        return None
    fp = bench_fingerprint(row)
    if fp is None:
        return None
    return make_entry(
        fp, pps, source, backend=_backend_class(str(row.get("device", ""))),
        mode=mode, run_id=row.get("telemetry"),
        metric=str(row.get("metric"))[:160], round_n=round_n, t=t,
        cost=row.get("cost") if isinstance(row.get("cost"), dict) else None,
        roofline=(row.get("roofline")
                  if isinstance(row.get("roofline"), dict) else None),
    )


def ingest_bench_files(paths, ledger_path: str) -> int:
    """Convert bench-round files (the repo's ``BENCH_r0*.json``: ``{"n",
    "cmd", "tail", "parsed"}``) into ledger entries, ordered by round then
    line order —
    every JSON line found in ``tail`` plus the ``parsed`` row, de-duped.
    Returns the number of entries appended."""
    files = []
    for p in paths:
        try:
            with open(p, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            logger.warning("skipping %r: %s", p, e)
            continue
        files.append((doc.get("n") if isinstance(doc, dict) else None,
                      p, doc))
    files.sort(key=lambda x: (x[0] is None, x[0] if x[0] is not None else 0,
                              x[1]))
    n_added = 0
    for round_n, _p, doc in files:
        if not isinstance(doc, dict):
            continue
        rows, seen = [], set()
        for line in str(doc.get("tail", "")).splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(row, dict):
                rows.append(row)
                seen.add(json.dumps(row, sort_keys=True))
        parsed = doc.get("parsed")
        if (isinstance(parsed, dict)
                and json.dumps(parsed, sort_keys=True) not in seen):
            rows.append(parsed)
        for row in rows:
            # synthetic, strictly ordered timestamps: the round files
            # carry no wall time, but check() keys on append order anyway
            entry = entry_from_bench_row(
                row, source="ingest", round_n=round_n,
                t=float(round_n or 0),
            )
            if entry is not None and append_entry(entry, ledger_path):
                n_added += 1
    return n_added


# ---------------------------------------------------------------------------
# trend + regression check
# ---------------------------------------------------------------------------


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def check(path: str, threshold: float = DEFAULT_THRESHOLD,
          window: int = DEFAULT_WINDOW) -> tuple[bool, str]:
    """Compare the ledger's NEWEST entry against the robust median of the
    prior entries sharing its fingerprint (most recent ``window`` of
    them). Returns ``(ok, report)``:

    - no entries → ok (nothing to judge);
    - no matching history → ok, noted (first measurement of this
      fingerprint — a baseline, not a regression);
    - ratio newest/median < 1 - threshold → **not ok**.
    """
    entries = read_entries(path)
    if not entries:
        return True, f"perf ledger {path!r}: no entries"
    newest = entries[-1]
    fp = newest["fingerprint"]
    priors = [e for e in entries[:-1] if e["fingerprint"] == fp]
    priors = priors[-int(window):]
    head = (
        f"newest: {newest['perms_per_sec']:g} perms/s "
        f"[{newest.get('source')}] {fp}"
    )
    if not priors:
        return True, (
            f"{head}\nno prior entries with this fingerprint — recorded "
            "as the baseline"
        )
    med = _median([float(e["perms_per_sec"]) for e in priors])
    ratio = float(newest["perms_per_sec"]) / med if med > 0 else 1.0
    body = (
        f"{head}\nhistory: {len(priors)} matching entr"
        f"{'y' if len(priors) == 1 else 'ies'}, median {med:g} perms/s "
        f"→ ratio {ratio:.3f} (fail below {1.0 - threshold:.2f})"
    )
    if ratio < 1.0 - threshold:
        return False, (
            f"{body}\nPERF REGRESSION: the newest entry is "
            f"{(1.0 - ratio) * 100.0:.0f}% below its history's median"
        )
    return True, f"{body}\nOK"


def _roofline_signal(entry: dict) -> tuple[str, float] | None:
    """The gauged quantity of a roofline-bearing entry: ``("utilisation",
    u)`` when the device's speed of light is known, else
    ``("achieved_pps", pps)`` so CPU mechanism runs (utilisation null —
    never a guess) still form a checkable history. Returns None for
    entries without a roofline block or without a positive signal."""
    rb = entry.get("roofline")
    if not isinstance(rb, dict):
        return None
    util = rb.get("utilisation")
    if isinstance(util, (int, float)) and util > 0:
        return "utilisation", float(util)
    pps = rb.get("achieved_pps")
    if isinstance(pps, (int, float)) and pps > 0:
        return "achieved_pps", float(pps)
    return None


def check_roofline(path: str, threshold: float = DEFAULT_THRESHOLD,
                   window: int = DEFAULT_WINDOW) -> tuple[bool, str]:
    """Speed-of-light drift gate: compare the NEWEST
    roofline-bearing entry's utilisation against the robust median of the
    prior roofline entries sharing its fingerprint (most recent
    ``window``). Same contract shape as :func:`check`:

    - no roofline entries → ok (nothing to judge);
    - no matching history → ok, noted (baseline);
    - newest and priors judged on utilisation when the peak table knows
      the device, on achieved_pps otherwise (CPU/unknown kinds) — priors
      whose signal kind differs from the newest's are skipped, so a CPU
      mechanism row never gates against TPU utilisation history;
    - ratio newest/median < 1 - threshold → **not ok**.
    """
    entries = [e for e in read_entries(path)
               if _roofline_signal(e) is not None]
    if not entries:
        return True, f"perf ledger {path!r}: no roofline entries"
    newest = entries[-1]
    kind, val = _roofline_signal(newest)
    fp = newest["fingerprint"]
    fam = (newest.get("roofline") or {}).get("family")
    priors = []
    for e in entries[:-1]:
        if e["fingerprint"] != fp:
            continue
        k, v = _roofline_signal(e)
        if k == kind:
            priors.append(v)
    priors = priors[-int(window):]
    head = (
        f"newest roofline: {kind}={val:g} "
        f"[family={fam}] {fp}"
    )
    if not priors:
        return True, (
            f"{head}\nno prior roofline entries with this fingerprint — "
            "recorded as the baseline"
        )
    med = _median(priors)
    ratio = val / med if med > 0 else 1.0
    body = (
        f"{head}\nhistory: {len(priors)} matching entr"
        f"{'y' if len(priors) == 1 else 'ies'}, median {kind} {med:g} "
        f"→ ratio {ratio:.3f} (fail below {1.0 - threshold:.2f})"
    )
    if ratio < 1.0 - threshold:
        return False, (
            f"{body}\nROOFLINE REGRESSION: the newest entry's {kind} is "
            f"{(1.0 - ratio) * 100.0:.0f}% below its history's median"
        )
    return True, f"{body}\nOK"


def trend(path: str) -> str:
    """Per-fingerprint trend table of the whole ledger (the no-check
    view): entry count, median, newest, and newest/median ratio."""
    entries = read_entries(path)
    if not entries:
        return f"perf ledger {path!r}: no entries"
    groups: dict[str, list[dict]] = {}
    order: list[str] = []
    for e in entries:
        fp = e["fingerprint"]
        if fp not in groups:
            groups[fp] = []
            order.append(fp)
        groups[fp].append(e)
    lines = [f"perf ledger {path!r}: {len(entries)} entries, "
             f"{len(order)} fingerprint(s)"]
    for fp in order:
        g = groups[fp]
        vals = [float(e["perms_per_sec"]) for e in g]
        med = _median(vals)
        last = vals[-1]
        ratio = last / med if med > 0 else float("nan")
        lines.append(
            f"  {fp}\n    n={len(g)}  median={med:g}  newest={last:g}  "
            f"newest/median={ratio:.3f}"
        )
    return "\n".join(lines)
