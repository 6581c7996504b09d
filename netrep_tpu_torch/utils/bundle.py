"""One-command diagnostic bundles.

The port of ``netrep_tpu/utils/bundle.py``. :func:`collect` writes a
self-contained ``netrep-bundle-<reason>/`` directory — what a
post-incident session reads in place of the process that no longer
exists:

- ``flight_ring.jsonl`` — the flight recorder's ring of recent events
  (:mod:`netrep_tpu_torch.utils.flightrec`);
- ``manifest.json`` — reason, wall time, host, pid, ring stats;
- ``env.json`` — the filtered environment (``NETREP_*`` / ``CUDA_*`` /
  ``TORCH_*`` / ``PYTORCH_*`` keys only, never the whole environ), the
  python version and, in place of the JAX package's jax section, the
  torch and CUDA versions with the card's name and power limit. The card
  is named only when CUDA is already initialized in the process:
  collecting forensics about a lost card must not hang on that card;
- ``kernels.json`` — in place of the JAX package's AOT-store snapshot,
  the port's kernel libraries (:mod:`netrep_tpu_torch.ops._build`): each
  source's path and hash, its library's path and whether it exists, and
  this process's build record (seconds, ptxas's report). Nothing is
  built;
- ``perf_ledger_tail.jsonl`` — the newest perf-ledger entries;
- ``journal_tail.jsonl`` — the newest serve-journal records, content-
  REDACTED: scalar metadata survives, every array or large payload is
  replaced by its digest — a bundle never carries a tenant's matrices
  off the machine;
- ``stacks.txt`` — faulthandler's dump of every thread's stack;
- ``roofline.json`` — the process's last roofline note.

The JAX package's ``autotune.json`` has no counterpart: the autotune store
is not carried over (ROADMAP.md, item 16a). The write is atomic at the
directory level: everything is staged into a ``.tmp-<pid>`` sibling and
renamed into place, so a half-written bundle is never mistaken for a
real one. :func:`render_report` turns a bundle back into a one-screen
triage report.
"""

from __future__ import annotations

import faulthandler
import hashlib
import json
import os
import platform
import subprocess
import sys
import time

from . import flightrec
from . import telemetry as tm

#: bundle layout version, stamped in the manifest
FORMAT_VERSION = 1

#: tail sizes — enough context to triage, bounded so a bundle stays small
JOURNAL_TAIL = 64
LEDGER_TAIL = 50

#: env keys worth shipping (prefix match); everything else stays put
_ENV_PREFIXES = ("NETREP_", "CUDA_", "TORCH_", "PYTORCH_")

#: redaction thresholds: any sequence, any string or mapping beyond these
#: bounds, is digest-only in the journal tail
_REDACT_STR = 256
_REDACT_KEYS = 32


def _best_effort(fn):
    """Run one section builder; a broken source costs exactly that
    section (an ``error`` stub), never the bundle."""
    try:
        return fn()
    # netrep: allow(exception-taxonomy) — bundle sections are best-effort forensics; a broken source must cost one section, not the whole bundle
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def _digest(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()[:16]


def redact(value):
    """Content-redact one journal value: scalars and small mappings pass
    through, every sequence, oversized string or oversized mapping is
    replaced by ``{"redacted", "sha256", "bytes"}`` — the digest still
    lets two bundles be compared for identical payloads without either
    containing one."""
    if isinstance(value, dict):
        if len(value) > _REDACT_KEYS:
            blob = json.dumps(value, sort_keys=True, default=str).encode()
            return {"redacted": "mapping", "keys": len(value),
                    "sha256": _digest(blob), "bytes": len(blob)}
        return {k: redact(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        blob = json.dumps(value, default=str).encode()
        return {"redacted": "sequence", "items": len(value),
                "sha256": _digest(blob), "bytes": len(blob)}
    if isinstance(value, str) and len(value) > _REDACT_STR:
        blob = value.encode("utf-8", errors="replace")
        return {"redacted": "text", "chars": len(value),
                "sha256": _digest(blob), "bytes": len(blob)}
    return value


def _power_limit() -> str:
    """The first card's ``name, power.limit`` as ``nvidia-smi`` gives
    them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=20,
    ).stdout.strip().splitlines()[0]


def _torch_info() -> dict:
    """torch and CUDA versions and, where CUDA is already initialized in
    this process, the cards — without ever initializing it."""
    import torch

    info: dict = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if torch.cuda.is_initialized():
        info["devices"] = [torch.cuda.get_device_name(i)
                           for i in range(torch.cuda.device_count())]
        info["card"] = _best_effort(_power_limit)
    else:
        info["devices"] = "uninitialized (never probed from a bundle)"
    return info


def _env_snapshot() -> dict:
    return {
        "python": sys.version,
        "platform": platform.platform(),
        "env": {
            k: v for k, v in sorted(os.environ.items())
            if k.startswith(_ENV_PREFIXES)
        },
        "torch": _best_effort(_torch_info),
    }


def _kernels_snapshot() -> dict:
    """Each kernel source's library: path, hash, whether it is built, and
    this process's build record — read only, nothing is compiled."""
    from ..ops import _build
    from . import aot

    out = {"build_dir": str(aot.store_dir()), "libraries": {}}
    for name in _build.SOURCES:
        lib = _build.library_path(name)
        src = _build.CSRC / f"{name}.cu"
        info = _build.BUILD_INFO.get(name, {})
        out["libraries"][name] = {
            "source": str(src),
            "source_sha256": hashlib.sha256(src.read_bytes()).hexdigest(),
            "lib": str(lib),
            "exists": lib.exists(),
            "loaded": name in _build._LIBS,
            "build_s": info.get("seconds"),
            "acquired": info.get("source"),
            "ptxas": info.get("ptxas"),
        }
    return out


def _tail_lines(path: str, n: int) -> list[str]:
    with open(path, encoding="utf-8", errors="replace") as f:
        return [ln.rstrip("\n") for ln in f][-n:]


def _write_json(path: str, obj) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, sort_keys=True, default=str)
        f.write("\n")


def _slug(reason: str) -> str:
    return "".join(
        c if c.isalnum() or c in "-_" else "-" for c in str(reason)
    ) or "manual"


def collect(dest: str | None = None, reason: str = "manual",
            telemetry=None, journal: str | None = None) -> str:
    """Collect one diagnostic bundle; returns the final directory path.

    ``dest`` is the wanted directory (``netrep-bundle-<reason>`` in the
    working directory when None); an existing directory gets a
    ``-2``/``-3`` suffix instead of being overwritten. ``journal`` names
    the serve journal to tail (redacted) when the caller has one."""
    reason = _slug(reason)
    if dest is None:
        dest = os.path.join(os.getcwd(), f"netrep-bundle-{reason}")
    dest = os.path.abspath(dest)
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    stage = f"{dest}.tmp-{os.getpid()}"
    if os.path.isdir(stage):
        import shutil

        shutil.rmtree(stage)
    os.makedirs(stage)

    tel = tm.resolve(telemetry)
    rec = flightrec.recorder()
    # the dump mark goes out FIRST, so the drained ring records its own
    # dump: a bundle's ring says why it exists
    if tel is not None:
        tel.emit("flightrec_dump", reason=reason,
                 entries=(rec.stats()["entries"] if rec is not None else 0))
    n_ring = 0
    if rec is not None:
        n_ring = rec.dump_jsonl(os.path.join(stage, "flight_ring.jsonl"))

    _write_json(os.path.join(stage, "manifest.json"), {
        "format": FORMAT_VERSION,
        "reason": reason,
        "t": time.time(),
        "host": platform.node(),
        "pid": os.getpid(),
        "argv": sys.argv,
        "ring": (rec.stats() if rec is not None
                 else {"disabled": True, "entries": 0}),
    })
    _write_json(os.path.join(stage, "env.json"),
                _best_effort(_env_snapshot))
    _write_json(os.path.join(stage, "kernels.json"),
                _best_effort(_kernels_snapshot))

    def _ledger_tail():
        from . import perfledger

        path = perfledger.default_path()
        lines = _tail_lines(path, LEDGER_TAIL) if os.path.exists(path) else []
        with open(os.path.join(stage, "perf_ledger_tail.jsonl"), "w",
                  encoding="utf-8") as f:
            for ln in lines:
                f.write(ln + "\n")
        return {"path": path, "entries": len(lines)}

    _best_effort(_ledger_tail)

    def _journal_tail():
        out = os.path.join(stage, "journal_tail.jsonl")
        lines = (_tail_lines(journal, JOURNAL_TAIL)
                 if journal and os.path.exists(journal) else [])
        with open(out, "w", encoding="utf-8") as f:
            for ln in lines:
                try:
                    rec_ = json.loads(ln)
                except json.JSONDecodeError:
                    continue
                f.write(json.dumps(redact(rec_), default=str) + "\n")
        return {"path": journal, "entries": len(lines)}

    _best_effort(_journal_tail)

    def _stacks():
        with open(os.path.join(stage, "stacks.txt"), "w") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)

    _best_effort(_stacks)

    def _roofline():
        from . import costmodel

        note = costmodel.last_run_note(consume=False)
        _write_json(os.path.join(stage, "roofline.json"),
                    note if note is not None else {"note": None})

    _best_effort(_roofline)

    final = dest
    n = 1
    while os.path.exists(final):
        n += 1
        final = f"{dest}-{n}"
    os.rename(stage, final)
    if tel is not None:
        tel.emit("bundle_written", reason=reason, path=final,
                 ring_entries=n_ring)
    return final


# ---------------------------------------------------------------------------
# triage report
# ---------------------------------------------------------------------------


def _load_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def render_report(path: str) -> str:
    """One-screen triage report of a collected bundle: header, detector
    verdicts, the recovery and forensic timeline, and the per-phase time
    split folded from the flight ring."""
    path = os.path.abspath(path)
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.isfile(manifest_path):
        raise ValueError(f"{path!r} is not a diagnostic bundle "
                         "(no manifest.json)")
    man = _load_json(manifest_path)
    out = [f"netrep diagnostic bundle: {os.path.basename(path)}"]
    when = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                         time.gmtime(man.get("t", 0)))
    out.append(f"  reason={man.get('reason')} written={when} "
               f"host={man.get('host')} pid={man.get('pid')}")
    ring_stats = man.get("ring") or {}
    out.append(f"  ring: {ring_stats.get('entries', 0)} entries "
               f"({ring_stats.get('n_seen', 0)} seen, "
               f"{ring_stats.get('n_evicted', 0)} evicted)")
    env_path = os.path.join(path, "env.json")
    if os.path.isfile(env_path):
        env = _load_json(env_path)
        tv = env.get("torch") or {}
        out.append(f"  python={str(env.get('python', '?')).split()[0]} "
                   f"torch={tv.get('torch', '?')} cuda={tv.get('cuda')} "
                   f"devices={tv.get('devices', '-')}")

    ring_file = os.path.join(path, "flight_ring.jsonl")
    ring = (list(tm.read_events(ring_file))
            if os.path.isfile(ring_file) else [])

    out.append("")
    out.append("detector verdicts:")
    anomalies = [e for e in ring if e["ev"] == "anomaly_detected"]
    if not anomalies:
        out.append("  (no detector fired inside the recorded window)")
    else:
        by_det: dict[str, list[dict]] = {}
        for e in anomalies:
            by_det.setdefault(
                str(e["data"].get("detector", "-")), []
            ).append(e)
        for det in sorted(by_det):
            evs = by_det[det]
            last = evs[-1]["data"]
            detail = " ".join(
                f"{k}={v}" for k, v in last.items()
                if k not in ("detector", "span", "parent")
            )
            out.append(f"  {det:<20} x{len(evs)}  last: {detail}")

    out.append("")
    out.append("timeline (recovery / fleet / forensic events):")
    t0 = ring[0]["t"] if ring else 0.0
    shown = 0
    for e in ring:
        if (e["ev"] not in tm.RECOVERY_EVENTS
                and e["ev"] not in tm.FLEET_EVENTS
                and e["ev"] not in tm.FORENSIC_EVENTS):
            continue
        d = dict(e["data"])
        label = ""
        if e["ev"] in tm.FORENSIC_EVENTS:
            label = f" [detector={d.pop('detector', '-')}]"
        data = " ".join(f"{k}={v}" for k, v in d.items()
                        if k not in ("span", "parent"))
        out.append(f"  +{e['t'] - t0:9.2f}s  {e['ev']:<24}{label} {data}")
        shown += 1
    if not shown:
        out.append("  (none in the recorded window)")

    out.append("")
    out.append("time split (timed phases in the ring):")
    split: dict[str, list[float]] = {}
    for e in ring:
        s = e["data"].get("s")
        if isinstance(s, (int, float)) and not isinstance(s, bool):
            agg = split.setdefault(e["ev"], [0, 0.0])
            agg[0] += 1
            agg[1] += float(s)
    if not split:
        out.append("  (no timed events in the ring)")
    else:
        total = sum(v[1] for v in split.values()) or 1.0
        for ev in sorted(split, key=lambda k: -split[k][1]):
            n, s = split[ev]
            out.append(f"  {ev:<24} {s:8.3f}s over {n:4d} event(s) "
                       f"({100 * s / total:3.0f}%)")
    return "\n".join(out)
