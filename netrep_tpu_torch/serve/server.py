"""The serving daemon: one JSON op per line over a unix socket or stdio.

The port of ``netrep_tpu/serve/server.py``. Transport is deliberately
minimal: a unix-domain socket (or stdin/stdout) speaking one JSON object
per line — no HTTP framework. Each connection is handled on its own
thread; every op gets exactly one JSON response line. The in-process
scheduler (:class:`~netrep_tpu_torch.serve.scheduler.PreservationServer`)
does all the work; this module adds the wire, the ``metrics`` scrape
surface and the drain protocol:

**SIGTERM/SIGINT (or the ``shutdown`` op) → graceful drain**: the listener
stops accepting, every queued and in-flight request finishes (bounded by
``drain_timeout``; past the bound the remainder is journaled as
requeued-on-restart), pooled engines release their device tensors, the
telemetry ``serve_start``/``serve_end`` span closes, and the process
prints a final ``{"serve": "drained", ...}`` line and returns 0.

**Wire hardening**: request lines are read through one bounded reader
(:func:`read_op_line`) — oversized lines, bad JSON, non-object ops and
unknown ops each get a structured error response plus a
``request_malformed`` event, and the connection loop stays alive. A
rejected admission (queue full / brownout) answers ``{"ok": false,
"retryable": true, "retry_after_s": <hint>}``.

**Live forensics**: the ``dump`` op (``{"op": "dump", "dest": DIR,
"reason": R}``, both optional) and ``SIGUSR2`` collect a diagnostic
bundle (:func:`~netrep_tpu_torch.utils.bundle.collect`: the flight ring,
the environment, the kernel libraries, the journal's redacted tail)
without stopping anything; the op answers ``{"ok": true, "bundle":
PATH}``, the signal prints the path on stderr.

Start it with ``python -m netrep_tpu_torch serve --socket PATH`` (on the
card; ``--device cpu`` runs it on the CPU), or in process with
:func:`serve_daemon` on the namespace :func:`daemon_args` builds. The
``ready`` line carries the boot's split (``boot``): the seconds of the
imports the CLI timed, the CUDA context, a fleet replica's kernel
libraries (each with its source, ``jit`` or ``aot``), the journal's open
and replay, and the wall clock of the CLI's start and of the line.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import threading

import numpy as np

from .protocol import encode_arrays
from .scheduler import PreservationServer, QueueFull, ServeConfig, ServeError

#: wire-hardening bound: one request line may not exceed this — an
#: oversized line gets a structured error (+ ``request_malformed``
#: telemetry) and the connection loop stays alive
MAX_LINE_BYTES = 32 * 1024 * 1024

def _malformed(server: PreservationServer, reason: str) -> dict:
    """Structured malformed-request response + its telemetry event; the
    handler loop continues — a bad line never tears down the
    connection."""
    if server.tel is not None:
        server.tel.emit("request_malformed", reason=reason[:200])
    return {"ok": False, "error": f"malformed request: {reason}",
            "malformed": True}


def dispatch_op(server: PreservationServer, op: dict,
                stop: threading.Event) -> dict:
    """Execute one wire op against the in-process server; returns the
    response dict (``ok`` always present). Shared by the socket and stdio
    transports. Never raises: unknown ops, bad payload shapes and even
    unexpected internal errors come back as structured error responses."""
    if not isinstance(op, dict):
        return _malformed(server, f"op must be a JSON object, "
                                  f"got {type(op).__name__}")
    try:
        kind = op.get("op")
        if kind == "ping":
            return {"ok": True, "pong": True}
        if kind == "register_fixture":
            kw = {k: int(op[k]) for k in ("genes", "modules", "n_samples",
                                          "seed") if k in op}
            fixture = server.register_fixture(
                str(op["tenant"]), str(op.get("prefix", "fx")), **kw
            )
            return {"ok": True, "fixture": fixture}
        if kind == "register":
            data = op.get("data")
            network = op.get("network")
            correlation = op.get("correlation")
            beta = op.get("beta")
            if isinstance(beta, list):
                beta = tuple(beta)
            digest = server.register_dataset(
                str(op["tenant"]), str(op["name"]),
                network=None if network is None
                else np.asarray(network, dtype=np.float64),
                correlation=None if correlation is None
                else np.asarray(correlation, dtype=np.float64),
                data=None if data is None
                else np.asarray(data, dtype=np.float64),
                assignments=op.get("assignments"),
                beta=beta,
            )
            return {"ok": True, "digest": digest}
        if kind == "analyze":
            kw = {}
            for k in ("modules", "n_perm", "seed", "alternative",
                      "adaptive", "deadline_s", "idempotency_key",
                      "trace_ctx"):
                if k in op and op[k] is not None:
                    kw[k] = op[k]
            result = server.analyze(
                str(op["tenant"]), str(op["discovery"]), op["test"],
                timeout=float(op.get("timeout", 600.0)), **kw,
            )
            return {"ok": True, "result": encode_arrays(result)}
        if kind == "adopt_journal":
            summary = server.adopt_journal(
                str(op["path"]),
                datasets_only=bool(op.get("datasets_only", False)),
            )
            return {"ok": True, "adopted": summary}
        if kind == "metrics":
            return {"ok": True, "text": server.metrics_text()}
        if kind == "stats":
            return {"ok": True, "stats": server.stats()}
        if kind == "shutdown":
            stop.set()
            return {"ok": True, "draining": True}
        if kind == "evict_notice":
            # the host is going away in grace_s: begin the same bounded
            # drain as SIGTERM now
            stop.set()
            return {"ok": True, "draining": True, "evict": True,
                    "grace_s": float(op.get("grace_s") or 30.0)}
        if kind == "dump":
            # a diagnostic bundle of the running server: flight ring,
            # environment, kernel libraries and the journal's redacted
            # tail, collected without stopping anything
            from ..utils import bundle

            path = bundle.collect(
                dest=(str(op["dest"]) if op.get("dest") else None),
                reason=str(op.get("reason") or "dump"),
                telemetry=server.tel,
                journal=server.config.journal,
            )
            return {"ok": True, "bundle": path}
        return _malformed(server, f"unknown op {kind!r}")
    except QueueFull as e:
        # admission-control rejection: retryable by contract, with the
        # server's backlog-drain hint when it has one
        resp = {"ok": False, "error": f"QueueFull: {e}", "retryable": True}
        if e.retry_after_s is not None:
            resp["retry_after_s"] = float(e.retry_after_s)
        return resp
    except (ServeError, TimeoutError, KeyError, TypeError,
            ValueError) as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}
    # netrep: allow(exception-taxonomy) — wire boundary: one malformed/failed op becomes that client's error line, the daemon keeps serving
    except Exception as e:  # the handler loop must survive anything
        return {"ok": False,
                "error": f"internal error: {type(e).__name__}: {e}"}


def read_op_line(rfile, server: PreservationServer):
    """Read + parse one bounded request line. Returns ``(op, None)`` for
    a parsed op, ``(None, resp)`` for a line that must be answered with a
    structured error (oversized, bad JSON — the loop continues), and
    ``(None, None)`` on EOF."""
    line = rfile.readline(MAX_LINE_BYTES + 1)
    if not line:
        return None, None
    if len(line) > MAX_LINE_BYTES and not line.endswith("\n"):
        # discard the rest of the oversized line so the next one parses
        while True:
            chunk = rfile.readline(MAX_LINE_BYTES)
            if not chunk or chunk.endswith("\n"):
                break
        return None, _malformed(
            server, f"request line exceeds {MAX_LINE_BYTES} bytes"
        )
    line = line.strip()
    if not line:
        return None, {"ok": True, "empty": True}
    try:
        return json.loads(line), None
    except json.JSONDecodeError as e:
        return None, _malformed(server, f"bad JSON: {e}")


def _handle_conn(server: PreservationServer, conn: socket.socket,
                 stop: threading.Event) -> None:
    with conn:
        rfile = conn.makefile("r", encoding="utf-8")
        while True:
            op, resp = read_op_line(rfile, server)
            if op is None and resp is None:
                return
            if resp is not None and resp.get("empty"):
                continue
            if resp is None:
                resp = dispatch_op(server, op, stop)
            try:
                conn.sendall((json.dumps(resp) + "\n").encode("utf-8"))
            except OSError:
                return
            if stop.is_set():
                return


def daemon_args(**kw) -> argparse.Namespace:
    """The namespace :func:`serve_daemon` reads, with the JAX package's
    ``serve`` defaults (socket None = stdio, journal
    ``netrep_serve_journal.jsonl``, chunk 64, drain timeout 120 s),
    ``device`` None (``"cuda"``), no ``fleet_label`` and no ``boot``
    stamps; keywords override them."""
    args = dict(
        socket=None, telemetry=None, max_queue=64, max_pack=4,
        pool_size=8, chunk=64, n_perm=None, drain_timeout=120.0,
        journal="netrep_serve_journal.jsonl", no_journal=False,
        recover=None, checkpoint_dir=None, checkpoint_every=4096,
        brownout_enter_s=None, brownout_exit_s=None, brownout_rate=None,
        device=None, fleet_label=None, boot=None,
    )
    unknown = set(kw) - set(args)
    if unknown:
        raise TypeError(f"unknown daemon arguments {sorted(unknown)}")
    args.update(kw)
    return argparse.Namespace(**args)


def _cuda_context(device) -> float:
    """Create the CUDA context of ``device`` (None means ``"cuda"``) now,
    so the boot's split shows it and a broken card fails the boot; 0.0 on
    the CPU."""
    import time

    import torch

    from ..utils.config import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return 0.0
    t0 = time.perf_counter()
    torch.empty(1, device=dev)
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def serve_daemon(args) -> int:
    """Run the daemon on ``args`` (see :func:`daemon_args` and the module
    docstring) until a drain; returns the process exit code."""
    import time

    from ..utils.config import EngineConfig

    journal = None if args.no_journal else args.journal
    recover = getattr(args, "recover", None)
    if isinstance(recover, str):
        journal = recover      # a journal path given as ``recover``
    if recover and journal is None:
        print("serve: recover needs a journal (give journal=PATH or "
              "recover=JOURNAL instead of no_journal)", file=sys.stderr)
        return 2
    cfg = ServeConfig(
        max_queue=args.max_queue,
        max_pack=args.max_pack,
        pool_size=args.pool_size,
        engine=EngineConfig(chunk_size=args.chunk),
        default_n_perm=args.n_perm,
        telemetry=args.telemetry,
        fault_policy=True if os.environ.get("NETREP_FAULT_PLAN") else None,
        journal=journal,
        recover=bool(recover),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=getattr(args, "checkpoint_every", 4096),
        brownout_enter_s=args.brownout_enter_s,
        brownout_exit_s=args.brownout_exit_s,
        brownout_rate_pps=args.brownout_rate,
        device=getattr(args, "device", None),
        fleet_label=getattr(args, "fleet_label", None),
    )
    boot = dict(getattr(args, "boot", None) or {})
    boot["context_s"] = _cuda_context(cfg.device)
    server = PreservationServer(cfg)
    boot.update(server.boot)
    stop = threading.Event()

    def _drain_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _drain_signal)
    signal.signal(signal.SIGINT, _drain_signal)

    def _dump_signal(signum, frame):
        # `kill -USR2 <pid>`: a diagnostic bundle beside the process, the
        # same collection as the dump op, without touching the serve loop
        from ..utils import bundle

        try:
            path = bundle.collect(reason="sigusr2", telemetry=server.tel,
                                  journal=server.config.journal)
            print(f"SIGUSR2: diagnostic bundle at {path}",
                  file=sys.stderr, flush=True)
        # netrep: allow(exception-taxonomy) — a forensics failure inside a signal handler must never kill a serving daemon
        except Exception as e:
            print(f"SIGUSR2: bundle collection failed: {e}",
                  file=sys.stderr, flush=True)

    signal.signal(signal.SIGUSR2, _dump_signal)

    if args.socket:
        path = args.socket
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        listener.bind(path)
        listener.listen(16)
        listener.settimeout(0.25)
        print(json.dumps({"serve": "ready", "socket": path,
                          "pid": os.getpid(),
                          "boot": {**boot, "ready_t": time.time()}}),
              flush=True)
        try:
            while not stop.is_set():
                try:
                    conn, _ = listener.accept()
                except socket.timeout:
                    continue
                threading.Thread(
                    target=_handle_conn, args=(server, conn, stop),
                    daemon=True,
                ).start()
        finally:
            listener.close()
            try:
                os.unlink(path)
            except OSError:
                pass
    else:
        # stdio mode: one JSON op per stdin line, one response per stdout
        # line; EOF drains
        print(json.dumps({"serve": "ready", "stdio": True,
                          "pid": os.getpid(),
                          "boot": {**boot, "ready_t": time.time()}}),
              flush=True)
        while True:
            op, resp = read_op_line(sys.stdin, server)
            if op is None and resp is None:
                break
            if resp is not None and resp.get("empty"):
                continue
            if resp is None:
                resp = dispatch_op(server, op, stop)
            print(json.dumps(resp), flush=True)
            if stop.is_set():
                break

    # graceful drain: queued + in-flight work finishes (bounded), engines
    # release, the serve span closes — then one final parseable line
    server.close(drain=True, timeout=args.drain_timeout)
    st = server.stats()
    done = sum(t["done"] for t in st["tenants"].values())
    print(json.dumps({"serve": "drained", "requests_done": done,
                      "requests_requeued": server._last_drain_requeued,
                      "packs": st["packs"]}), flush=True)
    return 0
