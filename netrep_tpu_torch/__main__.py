"""The port's command line: ``python -m netrep_tpu_torch <command>``.

The port of ``netrep_tpu/__main__.py``. Commands:

- ``selftest`` (the default) — :func:`netrep_tpu_torch.utils.selftest.
  selftest` against the float64 oracle; exits 1 on a disagreement.
- ``version`` — the port's version.
- ``telemetry <run.jsonl>`` — a telemetry log's summary table (with the
  recovery, time-split, tenant, replica and grid sections its events
  call for), ``--prom``, ``--json``, ``--recovery``, ``--trace OUT``
  (Perfetto JSON, several logs merged) or ``--follow`` (tail the live
  log).
- ``perf [<ledger>]`` — the perf ledger's trend; ``--check`` exits 2 on a
  regression and fires ``perf_drift``; ``--ingest BENCH_r0*.json`` seeds
  it from bench files.
- ``roofline [<run.jsonl>]`` — the per-family achieved-vs-speed-of-light
  table; ``--check`` gates the newest roofline entry's utilisation, exits
  2 on drift and fires ``roofline_drift``.
- ``bundle [<dir>]`` — a diagnostic bundle's triage report, or
  ``--collect`` one.
- ``top --socket PATH`` — the live dashboard of a running daemon.
- ``warmup`` — build every kernel library into the store and warm a
  shape's engines; ``--measure`` reports a fresh process's first run
  (:mod:`netrep_tpu_torch.warmup`).
- ``serve`` — the serving daemon (:mod:`netrep_tpu_torch.serve.server`),
  or with ``--fleet N`` a coordinator over N replica daemons
  (:func:`~netrep_tpu_torch.serve.fleet.fleet_daemon`).
- ``chaos`` — the fault drills: the elastic ladder on a logical
  permutation mesh, ``--serve`` (a daemon killed mid-pack and recovered),
  ``--fleet`` (a replica daemon killed mid-pack, failed over, respawned)
  and ``--fleet --evict`` (a noticed eviction's handoff).
- ``lint [--json] [--rule NAME] [paths...]`` — the invariant linter
  (:mod:`netrep_tpu_torch.analysis`) over the port (or the paths named):
  exits 0 when clean, 2 on findings or an unknown rule.

``selftest``, ``warmup``, ``serve`` and ``chaos`` take ``--device`` and
run on the card unless it says ``cpu``; without a card they exit 1 with
the port's device error. ``telemetry``, ``perf``, ``roofline``,
``bundle``, ``top`` and ``lint`` only read files or sockets and never
touch a device. The JAX CLI's backend resolution (its TPU tunnel) and
persistent XLA cache have no counterpart: the device is named, and the
kernel-library store (:mod:`netrep_tpu_torch.utils.aot`) is the port's
cache.
"""

from __future__ import annotations

import time

#: wall clock of this module's import: the interpreter's start ends here
#: (the serve daemon's boot split begins at it)
_T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _positive(value: str) -> int:
    n = int(value)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def _device_arg(p) -> None:
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the work runs (default: the card; 'cpu' "
                        "only when named)")


def _telemetry_follow(path: str, poll_s: float = 0.25,
                      max_polls: int | None = None) -> int:
    """``telemetry --follow``: tail the live JSONL, rendering each event
    line as it lands (:func:`~netrep_tpu_torch.utils.telemetry.
    format_event`). Ctrl-C exits cleanly and, when the log carried serve
    events, prints the per-tenant table ``top`` renders. ``max_polls``
    bounds the loop for tests."""
    from .utils.telemetry import format_event, is_event, tenant_summary

    events = []
    t0 = None
    polls = 0
    try:
        with open(path, encoding="utf-8") as f:
            while True:
                line = f.readline()
                if not line:
                    polls += 1
                    if max_polls is not None and polls >= max_polls:
                        break
                    time.sleep(poll_s)
                    continue
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn in-flight line: re-read never helps
                if not is_event(e):
                    continue
                if t0 is None:
                    t0 = e["t"]
                events.append(e)
                print(format_event(e, t0), flush=True)
    except KeyboardInterrupt:
        pass
    except OSError as e:
        print(f"cannot follow {path!r}: {e}", file=sys.stderr)
        return 1
    rows = tenant_summary(events)
    if rows:
        from .serve.top import render_tenant_table

        print()
        print(render_tenant_table([
            {"tenant": t, "done": rows[t]["done"], "failed": rows[t]["failed"],
             "expired": rows[t]["expired"], "device_s": rows[t]["device_s"]}
            for t in sorted(rows)]))
    return 0


def _drill_fixture(genes: int, modules: int, n_samples: int, seed: int):
    """The drills' fixture: the serve plane's generator and module
    assignment, as host arrays for ``module_preservation``."""
    from .data import make_mixed_pair

    mixed = make_mixed_pair(genes, modules, n_samples=n_samples, seed=seed)
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    assign = {f"node_{i}": "0" for i in range(dn.shape[0])}
    for lab, idx in mixed["specs"]:
        for i in idx:
            assign[f"node_{i}"] = str(lab)
    return dict(network={"d": dn, "t": tn}, correlation={"d": dc, "t": tc},
                data={"d": dd, "t": td}, module_assignments=assign,
                discovery="d", test="t")


def _chaos(args) -> int:
    """``chaos``: the elastic drill. The fault plan (default: a partial
    device loss at permutation 24, the capacity back at 40) runs into a
    small preservation null on a logical permutation mesh of ``--devices``
    shards (default 4) on one device; the recovered result must equal the
    unfaulted run bit for bit. Prints the recovery timeline; exit 0 when
    the drill passed, 1 when the run failed, did not recover or differs."""
    import os
    import tempfile

    import numpy as np

    from .models.preservation import module_preservation
    from .parallel.mesh import make_mesh
    from .utils.config import EngineConfig, FaultPolicy, resolve_device
    from .utils.telemetry import render_recovery

    plan = args.plan or os.environ.get("NETREP_FAULT_PLAN") or (
        "device_lost_partial@24;capacity_restored@40")
    # the baseline below runs UNFAULTED: the variable would arm it too
    os.environ.pop("NETREP_FAULT_PLAN", None)
    dev = resolve_device(args.device)
    n_dev = args.devices or 4
    kw = dict(**_drill_fixture(120, 3, 16, 7), n_perm=args.n_perm, seed=0,
              config=EngineConfig(chunk_size=16, superchunk=2),
              device=dev.type)
    base = module_preservation(**kw)
    tel_path = args.telemetry
    tmp = None
    if tel_path is None:
        fd, tmp = tempfile.mkstemp(suffix=".jsonl", prefix="netrep_chaos_")
        os.close(fd)
        tel_path = tmp
    try:
        try:
            res = module_preservation(
                **kw, telemetry=tel_path,
                mesh=(make_mesh(n_perm_shards=n_dev, n_row_shards=1,
                                devices=[dev] * n_dev)
                      if n_dev > 1 else None),
                fault_policy=FaultPolicy(plan=plan, backoff_base_s=0.0,
                                         backoff_jitter=0.0))
        except RuntimeError as e:
            # the ladder gave up: the drill failed, loudly
            print(f"chaos drill FAILED: plan={plan!r}: {type(e).__name__}: "
                  f"{e}", file=sys.stderr)
            return 1
        recovered = int(res.completed) == int(args.n_perm)
        identical = (
            np.array_equal(np.asarray(base.p_values),
                           np.asarray(res.p_values))
            and (base.nulls is None or np.array_equal(base.nulls, res.nulls))
        )
        timeline = render_recovery(tel_path)
        summary = {"plan": plan, "devices": n_dev, "n_perm": int(args.n_perm),
                   "recovered": recovered, "bit_identical": identical,
                   "ok": recovered and identical}
        if args.json:
            print(json.dumps(summary))
        else:
            print(f"chaos drill: plan={plan!r} on {n_dev} device(s)")
            if timeline:
                print(timeline)
            print("chaos drill " + ("PASSED" if summary["ok"] else "FAILED")
                  + f": recovered={recovered} bit_identical={identical}")
        return 0 if summary["ok"] else 1
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _baseline(args, reqs) -> dict:
    """The drills' unkilled answers: served equals direct (the serving
    tier's parity contract), so each request's direct call is what an
    undisturbed server gives."""
    import numpy as np

    from .models.preservation import module_preservation
    from .utils.config import EngineConfig

    kw = _drill_fixture(100, 3, 16, 7)
    cfg = EngineConfig(chunk_size=args.chunk)
    return {r["seed"]: np.asarray(module_preservation(
        **kw, n_perm=r["n_perm"], seed=r["seed"], config=cfg,
        device=args.device).p_values) for r in reqs}


def _daemon_cmd(args, *extra) -> list:
    cmd = [sys.executable, "-m", "netrep_tpu_torch", "serve", *extra,
           "--chunk", str(args.chunk), "--checkpoint-every", str(args.chunk)]
    if args.device:
        cmd += ["--device", args.device]
    return cmd


def _chaos_serve(args) -> int:
    """``chaos --serve``: boots the real daemon with a plan-injected
    ``SIGKILL`` mid-pack, lets concurrent journaled requests die with it,
    restarts it recovering, and holds every request's p-values bit-equal
    to direct (unkilled) calls — clients retry under their idempotency
    keys, so nothing recomputes twice and nothing is lost. Exit 0 when the
    drill passed."""
    import os
    import shutil
    import signal
    import subprocess
    import tempfile
    import threading

    import numpy as np

    from .serve.client import SocketClient
    from .serve.fleet import daemon_env

    plan = args.plan or os.environ.get("NETREP_FAULT_PLAN") or "sigkill@24"
    os.environ.pop("NETREP_FAULT_PLAN", None)   # the baseline runs clean
    genes, modules, n_samples, fseed = 100, 3, 16, 7
    reqs = [{"seed": 100 + i, "n_perm": int(args.n_perm)}
            for i in range(args.requests)]
    baseline = _baseline(args, reqs)

    # a unix socket's path is bounded: the drill's files sit in a short
    # directory under the working one
    tmp = tempfile.mkdtemp(prefix="nchaos_", dir=".")
    sock = os.path.join(tmp, "serve.sock")
    journal = os.path.join(tmp, "journal.jsonl")

    def boot(extra_env, recover):
        cmd = _daemon_cmd(args, "--socket", sock, "--journal", journal,
                          *(["--recover"] if recover else []))
        return subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL,
                                env=daemon_env(**extra_env))

    def wait_socket(proc, budget=180.0):
        deadline = time.monotonic() + budget
        while not os.path.exists(sock):
            if time.monotonic() > deadline or proc.poll() is not None:
                return False
            time.sleep(0.1)
        return True

    def drive(results):
        """One thread per request, pinned idempotency keys: the sockets
        die with the daemon; the retry goes to the recovered one."""
        def worker(r):
            c = None
            try:
                c = SocketClient(sock, timeout=600)
                results[r["seed"]] = np.asarray(c.analyze(
                    "drill", "fx_d", "fx_t", n_perm=r["n_perm"],
                    seed=r["seed"], idempotency_key=f"drill-{r['seed']}",
                )["p_values"])
            # netrep: allow(exception-taxonomy) — drill clients: sockets die with the SIGKILLed daemon; the retry against the recovered daemon is the assertion
            except Exception:
                pass  # expected for requests in flight at the kill
            finally:
                if c is not None:
                    try:
                        c.close()
                    except OSError:
                        pass

        threads = [threading.Thread(target=worker, args=(r,), daemon=True)
                   for r in reqs]
        for t in threads:
            t.start()
        return threads

    summary = {"plan": plan, "requests": len(reqs), "n_perm": int(args.n_perm)}
    proc = proc2 = None
    try:
        proc = boot({"NETREP_FAULT_PLAN": plan}, recover=False)
        if not wait_socket(proc):
            print("chaos --serve: daemon never opened its socket",
                  file=sys.stderr)
            return 1
        reg = SocketClient(sock, timeout=600)
        reg.register_fixture("drill", genes=genes, modules=modules,
                             n_samples=n_samples, seed=fseed)
        reg.close()
        results_a: dict = {}
        threads = drive(results_a)
        proc.wait(timeout=600)      # the injected SIGKILL fires mid-pack
        for t in threads:
            t.join(timeout=60)
        summary["killed"] = proc.returncode == -signal.SIGKILL
        summary["done_before_kill"] = len(results_a)
        try:
            os.unlink(sock)         # SIGKILL skipped the daemon's cleanup
        except OSError:
            pass
        proc2 = boot({}, recover=True)
        if not wait_socket(proc2):
            print("chaos --serve: recovered daemon never opened its socket",
                  file=sys.stderr)
            return 1
        results_b: dict = {}
        threads = drive(results_b)
        for t in threads:
            t.join(timeout=600)
        identical = all(
            s in results_b and np.array_equal(results_b[s], baseline[s])
            for s in baseline
        ) and all(np.array_equal(results_a[s], baseline[s])
                  for s in results_a)
        summary["recovered"] = len(results_b) == len(reqs)
        summary["bit_identical"] = bool(identical)
        summary["ok"] = bool(summary["killed"] and summary["recovered"]
                             and identical)
        if args.json:
            print(json.dumps(summary))
        else:
            print(f"serve chaos drill: plan={plan!r}, "
                  f"{len(reqs)} requests @ {args.n_perm} perms")
            print("serve chaos drill "
                  + ("PASSED" if summary["ok"] else "FAILED")
                  + f": killed={summary['killed']} "
                    f"recovered={summary['recovered']} "
                    f"bit_identical={summary['bit_identical']}")
        return 0 if summary["ok"] else 1
    finally:
        for p in (proc, proc2):
            if p is not None and p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _chaos_fleet(args) -> int:
    """``chaos --fleet``: boots the real fleet daemon (coordinator and
    ``--replicas`` replica daemons on ``--device``), drives concurrent
    journaled requests through the coordinator's socket, SIGKILLs a replica
    mid-pack (the first whose stats show work in flight), lets the
    coordinator fail its shipped journal over to the peer, and holds every
    request's p-values bit-equal to direct (unkilled) calls. With
    ``--evict`` an eviction notice runs the handoff instead, which must
    recompute nothing (no failover event). Prints the coordinator's
    recovery timeline (replica_lost → failover_start → failover_done →
    ring_rebalanced); ``--json`` prints the summary, with the respawned
    replica's id. Exit 0 when the drill passed."""
    import os
    import shutil
    import signal
    import subprocess
    import tempfile
    import threading

    import numpy as np

    from .serve.client import SocketClient
    from .serve.fleet import daemon_env
    from .utils.telemetry import render_recovery

    os.environ.pop("NETREP_FAULT_PLAN", None)   # the drill kills by pid
    genes, modules, n_samples, fseed = 100, 3, 16, 7
    reqs = [{"seed": 100 + i, "n_perm": int(args.n_perm)}
            for i in range(args.requests)]
    baseline = _baseline(args, reqs)

    # a unix socket's path is bounded: the drill's files sit in a short
    # directory under the working one
    tmp = tempfile.mkdtemp(prefix="nchaos_", dir=".")
    sock = os.path.join(tmp, "fleet.sock")
    tel = os.path.join(tmp, "fleet_tel.jsonl")
    env = daemon_env()
    proc = subprocess.Popen(
        _daemon_cmd(args, "--fleet", str(args.replicas), "--socket", sock,
                    "--fleet-dir", os.path.join(tmp, "fleet"),
                    "--telemetry", tel, "--heartbeat-s", "0.2"),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env,
        start_new_session=True)
    summary = {"replicas": int(args.replicas), "requests": len(reqs),
               "n_perm": int(args.n_perm)}
    victim = None
    try:
        deadline = time.monotonic() + 300
        while not os.path.exists(sock):
            if time.monotonic() > deadline or proc.poll() is not None:
                print("chaos --fleet: coordinator never opened its socket",
                      file=sys.stderr)
                return 1
            time.sleep(0.1)
        reg = SocketClient(sock, timeout=600)
        reg.register_fixture("drill", genes=genes, modules=modules,
                             n_samples=n_samples, seed=fseed)
        reg.close()

        results = {}
        lock = threading.Lock()

        def worker(r):
            c = None
            try:
                c = SocketClient(sock, timeout=900)
                out = c.analyze("drill", "fx_d", "fx_t", n_perm=r["n_perm"],
                                seed=r["seed"],
                                idempotency_key=f"drill-{r['seed']}",
                                retries=8)
                with lock:
                    results[r["seed"]] = np.asarray(out["p_values"])
            # netrep: allow(exception-taxonomy) — drill clients: a request that dies with the killed replica is re-served via the journal; the parity gate below is the assertion
            except Exception:
                pass
            finally:
                if c is not None:
                    try:
                        c.close()
                    except OSError:
                        pass

        threads = [threading.Thread(target=worker, args=(r,), daemon=True)
                   for r in reqs]
        for t in threads:
            t.start()

        # the victim is picked live: the first replica whose stats show
        # work in flight — mid-pack by construction, not by timing
        stat_c = SocketClient(sock, timeout=60)
        kill_deadline = time.monotonic() + 240
        while victim is None and time.monotonic() < kill_deadline:
            st = stat_c.stats()
            for rid, row in sorted(st.get("replicas", {}).items()):
                if row.get("alive") and row.get("inflight") and row.get("pid"):
                    victim = (rid, int(row["pid"]))
                    break
            if victim is None:
                time.sleep(0.02)
        stat_c.close()
        if args.evict:
            summary["evicted_replica"] = victim[0] if victim else None
            if victim is not None:
                ec = SocketClient(sock, timeout=900)
                receipt = ec.request("evict_notice", replica=victim[0],
                                     grace_s=float(args.grace))
                ec.close()
                summary["handoff"] = {k: receipt.get(k) for k in
                                      ("ok", "peer", "s", "requeued",
                                       "results")}
        else:
            if victim is not None:
                os.kill(victim[1], signal.SIGKILL)
            summary["killed_replica"] = victim[0] if victim else None

        for t in threads:
            t.join(timeout=600)
        identical = all(
            s in results and np.array_equal(results[s], baseline[s])
            for s in baseline
        )
        summary["recovered"] = len(results) == len(reqs)
        summary["bit_identical"] = bool(identical)
        summary["ok"] = bool(victim and summary["recovered"] and identical)
        c = SocketClient(sock, timeout=120)
        if victim is not None and not args.evict:
            # the respawn: the victim's next generation joins the ring
            base = victim[0].split(".", 1)[0]
            respawn_deadline = time.monotonic() + 300
            while time.monotonic() < respawn_deadline:
                gens = [r for r, row in c.stats()["replicas"].items()
                        if r.startswith(base + ".g") and row.get("alive")]
                if gens:
                    summary["respawned"] = sorted(gens)[-1]
                    break
                time.sleep(0.1)
            summary["ok"] = bool(summary["ok"] and summary.get("respawned"))
        c.shutdown()
        c.close()
        proc.wait(timeout=300)
        summary["exit_code"] = proc.returncode
    finally:
        if proc.poll() is None:
            proc.terminate()   # the coordinator drains its replicas
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pass
        # whatever of the fleet's session is left (a replica of a killed
        # coordinator) goes with it
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()

    timeline = ""
    try:
        timeline = render_recovery(tel)
    except OSError:
        pass
    shutil.rmtree(tmp, ignore_errors=True)
    if args.evict:
        # the zero-recompute pin: a NOTICED eviction completes as a handoff
        # without ever entering the failover path
        summary["zero_recompute"] = bool(
            "evict_handoff_done" in timeline
            and "failover_start" not in timeline)
        summary["ok"] = bool(summary["ok"] and summary["zero_recompute"])
    summary["timeline"] = [ln.split("s  ", 1)[1].split()[0]
                           for ln in timeline.splitlines()]
    fo = [ln for ln in timeline.splitlines() if "failover_done" in ln]
    if args.json:
        print(json.dumps(summary))
    else:
        kind = "noticed eviction" if args.evict else "replica-kill"
        print(f"fleet chaos drill ({kind}): {args.replicas} replicas, "
              f"{len(reqs)} requests @ {args.n_perm} perms")
        if timeline:
            print(timeline)
        tail = (f": evicted={summary.get('evicted_replica')} "
                f"zero_recompute={summary.get('zero_recompute')} "
                if args.evict else
                f": killed={summary.get('killed_replica')} "
                f"respawned={summary.get('respawned')} ")
        print("fleet chaos drill " + ("PASSED" if summary["ok"] else "FAILED")
              + tail + f"recovered={summary['recovered']} "
              f"bit_identical={summary['bit_identical']}"
              + (f" ({fo[-1].strip()})" if fo else ""))
    return 0 if summary["ok"] else 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m netrep_tpu_torch")
    sub = ap.add_subparsers(dest="cmd")
    st = sub.add_parser("selftest", help="numerical self-check on a device")
    st.add_argument("--n-perm", type=_positive, default=32)
    st.add_argument("--seed", type=int, default=0)
    st.add_argument("--max-shapes", type=_positive, default=None)
    st.add_argument("--json", action="store_true",
                    help="print the summary dict as one JSON line")
    _device_arg(st)
    sub.add_parser("version", help="print the port's version")
    tl = sub.add_parser(
        "telemetry", help="aggregate a telemetry JSONL into a summary report")
    tl.add_argument("path", nargs="+",
                    help="telemetry event log(s) (JSONL); several files "
                         "merge in the --trace export")
    tl.add_argument("--prom", action="store_true",
                    help="Prometheus text exposition instead of the table")
    tl.add_argument("--json", action="store_true",
                    help="aggregated registry as one JSON line")
    tl.add_argument("--recovery", action="store_true",
                    help="chronological timeline of recovery events")
    tl.add_argument("--trace", metavar="OUT",
                    help="export the span tree as Chrome/Perfetto "
                         "trace-event JSON to OUT")
    tl.add_argument("--follow", action="store_true",
                    help="tail the log live; exits on Ctrl-C with a "
                         "per-tenant table when the log has serve events")
    pf = sub.add_parser(
        "perf", help="per-run throughput ledger: trend / regression check")
    pf.add_argument("ledger", nargs="?", default=None,
                    help="ledger JSONL (default: $NETREP_PERF_LEDGER or "
                         "./netrep_perf_ledger.jsonl)")
    pf.add_argument("--check", action="store_true",
                    help="compare the newest entry against the robust "
                         "median of matching prior entries; exit 2 on "
                         "regression beyond --threshold")
    pf.add_argument("--threshold", type=float, default=None,
                    help="fail when newest/median < 1 - THRESHOLD "
                         "(default 0.4)")
    pf.add_argument("--window", type=int, default=None,
                    help="median over at most this many most-recent "
                         "matching entries (default 8)")
    pf.add_argument("--ingest", nargs="+", metavar="BENCH_JSON",
                    help="append entries converted from BENCH_r0*.json "
                         "files before any other action")
    rf = sub.add_parser(
        "roofline", help="per-family achieved-vs-speed-of-light table and "
                         "the utilisation drift gate")
    rf.add_argument("path", nargs="?", default=None, metavar="RUN_JSONL",
                    help="telemetry run JSONL to fold into the table")
    rf.add_argument("--ledger", default=None, metavar="LEDGER",
                    help="perf ledger for --check (default: "
                         "$NETREP_PERF_LEDGER or ./netrep_perf_ledger.jsonl)")
    rf.add_argument("--check", action="store_true",
                    help="gate the newest roofline-bearing ledger entry's "
                         "utilisation against the robust median of "
                         "matching priors; exit 2 on regression")
    rf.add_argument("--threshold", type=float, default=None,
                    help="fail when newest/median < 1 - THRESHOLD "
                         "(default 0.4)")
    rf.add_argument("--window", type=int, default=None,
                    help="median over at most this many most-recent "
                         "matching entries (default 8)")
    sv = sub.add_parser(
        "serve", help="the serving daemon: tenants register datasets once, "
                      "then submit many analyses, packed into shared "
                      "dispatches on warm engines; SIGTERM drains")
    sv.add_argument("--socket", default=None, metavar="PATH",
                    help="serve line-delimited JSON ops on this unix socket "
                         "(default: stdin/stdout)")
    sv.add_argument("--telemetry", default=None, metavar="PATH",
                    help="append serving telemetry to this JSONL (default: "
                         "$NETREP_TELEMETRY)")
    sv.add_argument("--max-queue", type=_positive, default=64,
                    help="per-tenant queue bound (admission control)")
    sv.add_argument("--max-pack", type=_positive, default=4,
                    help="max requests per shared dispatch pack")
    sv.add_argument("--pool-size", type=int, default=8,
                    help="warm engine pool size (LRU)")
    sv.add_argument("--chunk", type=_positive, default=64,
                    help="EngineConfig.chunk_size for served runs")
    sv.add_argument("--n-perm", type=_positive, default=None,
                    help="default permutation budget for requests that omit "
                         "n_perm (default: the Bonferroni auto rule)")
    sv.add_argument("--drain-timeout", "--drain-timeout-s", type=float,
                    default=120.0, dest="drain_timeout",
                    help="max seconds to finish queued work on SIGTERM or "
                         "shutdown; the rest is journaled as "
                         "requeued-on-restart")
    sv.add_argument("--journal", default="netrep_serve_journal.jsonl",
                    metavar="PATH", help="write-ahead request journal")
    sv.add_argument("--no-journal", action="store_true",
                    help="no journal: no durability, no idempotency "
                         "persistence")
    sv.add_argument("--recover", nargs="?", const=True, default=None,
                    metavar="JOURNAL",
                    help="replay the journal on boot: re-register datasets, "
                         "answer duplicates from journaled results, "
                         "re-queue unfinished requests, resume partial "
                         "packs from their checkpoints")
    sv.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="per-pack checkpoint directory (default: "
                         "<journal>.ckpt when journaling)")
    sv.add_argument("--checkpoint-every", type=_positive, default=4096,
                    help="pack checkpoint cadence in permutations")
    sv.add_argument("--brownout-enter-s", type=float, default=None,
                    help="enter brownout when the estimated backlog drain "
                         "time exceeds this (default: off)")
    sv.add_argument("--brownout-exit-s", type=float, default=None,
                    help="exit brownout below this (default: half of "
                         "--brownout-enter-s)")
    sv.add_argument("--brownout-rate", type=float, default=None,
                    help="assumed perms/s before the server has measured "
                         "its own")
    sv.add_argument("--fleet", type=_positive, default=None, metavar="N",
                    help="run N replica daemons behind a coordinator on "
                         "--socket: hash-ring routing, journal shipping, "
                         "heartbeat failover, fleet-wide brownout, respawn")
    sv.add_argument("--fleet-dir", default=None, metavar="DIR",
                    help="fleet state directory (default: <socket>.fleet)")
    sv.add_argument("--fleet-route", default="proxy",
                    choices=["proxy", "redirect"],
                    help="proxy: the coordinator forwards analyze ops; "
                         "redirect: it answers with the home replica's "
                         "socket and the client re-sends there")
    sv.add_argument("--heartbeat-s", type=float, default=0.25,
                    help="fleet health-loop poll interval")
    sv.add_argument("--ship-interval-s", type=float, default=0.2,
                    help="journal-ship tail interval per replica")
    sv.add_argument("--fleet-brownout-enter-s", type=float, default=None,
                    help="fleet-wide brownout on the aggregate backlog "
                         "drain estimate")
    sv.add_argument("--no-respawn", action="store_true",
                    help="do not respawn a failed replica (the fleet "
                         "shrinks)")
    sv.add_argument("--autoscale", action="store_true",
                    help="[--fleet] run the autoscaler: spawn on backlog, "
                         "retire idle replicas, scale to zero with "
                         "--autoscale-min 0")
    sv.add_argument("--autoscale-min", type=int, default=0, metavar="N",
                    help="[--autoscale] fleet-size floor")
    sv.add_argument("--autoscale-max", type=_positive, default=None,
                    metavar="N",
                    help="[--autoscale] fleet-size ceiling (default: "
                         "max(4, --fleet N))")
    sv.add_argument("--scale-up-drain-s", type=float, default=10.0,
                    help="[--autoscale] spawn above this aggregate drain "
                         "estimate")
    sv.add_argument("--scale-down-idle-s", type=float, default=30.0,
                    help="[--autoscale] retire a replica idle this long")
    sv.add_argument("--fleet-label", default=None, metavar="RID",
                    help="replica identity inside a fleet (set by the "
                         "coordinator): every kernel library built or "
                         "loaded at boot; the first pack's cold start goes "
                         "to the perf ledger")
    _device_arg(sv)
    ch = sub.add_parser(
        "chaos", help="fault drills: recovered results bit-equal to the "
                      "unfaulted ones, with the recovery timeline")
    ch.add_argument("--plan", default=None,
                    help="fault plan (default: $NETREP_FAULT_PLAN, else "
                         "'device_lost_partial@24;capacity_restored@40')")
    ch.add_argument("--devices", type=_positive, default=None,
                    help="shards of the drill's logical permutation mesh "
                         "(default 4)")
    ch.add_argument("--n-perm", type=_positive, default=64)
    ch.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write the drill's event log here (default: a "
                         "temporary file)")
    ch.add_argument("--json", action="store_true",
                    help="print the summary dict as one JSON line")
    ch.add_argument("--serve", action="store_true",
                    help="serving drill: the daemon killed mid-pack by a "
                         "plan, recovered, every request bit-equal")
    ch.add_argument("--fleet", action="store_true",
                    help="fleet drill: a replica daemon SIGKILLed mid-pack, "
                         "failed over to its peer, respawned; every "
                         "request bit-equal")
    ch.add_argument("--replicas", type=_positive, default=2,
                    help="[--fleet] replica daemons in the drill")
    ch.add_argument("--evict", action="store_true",
                    help="[--fleet] an eviction notice instead of SIGKILL: "
                         "the handoff recomputes nothing")
    ch.add_argument("--grace", type=float, default=60.0,
                    help="[--fleet --evict] the notice's grace seconds")
    ch.add_argument("--requests", type=_positive, default=3,
                    help="[--serve/--fleet] concurrent requests")
    ch.add_argument("--chunk", type=_positive, default=16,
                    help="[--serve/--fleet] served EngineConfig.chunk_size")
    _device_arg(ch)
    tp = sub.add_parser(
        "top", help="live ops dashboard over a running serve daemon")
    tp.add_argument("--socket", required=True, metavar="PATH",
                    help="the daemon's unix socket")
    tp.add_argument("--interval", type=float, default=2.0,
                    help="refresh interval in seconds (default 2)")
    tp.add_argument("--once", action="store_true",
                    help="print one frame and exit")
    tp.add_argument("--json", action="store_true",
                    help="emit the snapshot as one JSON line")
    tp.add_argument("--timeout", type=float, default=30.0,
                    help="socket timeout seconds")
    wu = sub.add_parser(
        "warmup", help="build every kernel library into the store and warm "
                       "a shape's serve-path and direct engines (one chunk "
                       "each); --measure reports a fresh process's first "
                       "run")
    wu.add_argument("--genes", type=_positive, default=120)
    wu.add_argument("--modules", type=_positive, default=3)
    wu.add_argument("--samples", type=_positive, default=16)
    wu.add_argument("--fixture-seed", type=int, default=7)
    wu.add_argument("--chunk", type=_positive, default=64,
                    help="EngineConfig.chunk_size")
    wu.add_argument("--n-perm", type=_positive, default=None,
                    help="request budget the serve-path plan assumes")
    wu.add_argument("--grid", default=None, metavar="G:M:S[,G:M:S...]",
                    help="warm several genes:modules:samples shapes")
    wu.add_argument("--target", default="both",
                    choices=["serve", "direct", "both"],
                    help="which engine to warm (default both)")
    wu.add_argument("--measure", action="store_true",
                    help="build the serve-path engine in THIS process, run "
                         "one null, report its compile_span and source")
    wu.add_argument("--store", default=None, metavar="DIR",
                    help="kernel-library store (default: $NETREP_AOT_STORE "
                         "or build/netrep_tpu_torch)")
    wu.add_argument("--telemetry", default=None, metavar="PATH",
                    help="append warmup_start/end spans to this JSONL")
    wu.add_argument("--json", action="store_true",
                    help="print the report as one JSON line")
    _device_arg(wu)
    ln = sub.add_parser(
        "lint",
        help="invariant linter: statically enforce the port's RNG, "
             "exception, telemetry, checkpoint, thread, import, TF32 and "
             "device contracts over netrep_tpu_torch/ (exit 2 on findings; "
             "suppressions are counted, reasons required)")
    ln.add_argument("paths", nargs="*", default=None,
                    help="files or directories to lint (default: the "
                         "netrep_tpu_torch package)")
    ln.add_argument("--json", action="store_true",
                    help="one machine-readable JSON line (lint_v schema)")
    ln.add_argument("--rule", action="append", metavar="NAME",
                    help="run only this rule (repeatable)")
    bu = sub.add_parser(
        "bundle", help="render a diagnostic bundle's triage report, or "
                       "--collect one from this process")
    bu.add_argument("path", nargs="?", default=None,
                    help="bundle directory to render (or the destination "
                         "with --collect)")
    bu.add_argument("--collect", action="store_true",
                    help="collect a bundle now instead of rendering")
    bu.add_argument("--reason", default="manual",
                    help="reason slug stamped on a --collect bundle")
    return ap


def _perf(args) -> int:
    from .utils import perfledger

    ledger = args.ledger or perfledger.default_path()
    if args.ingest:
        n = perfledger.ingest_bench_files(args.ingest, ledger)
        print(f"ingested {n} entr{'y' if n == 1 else 'ies'} into {ledger}")
    if args.check:
        try:
            ok, report = perfledger.check(
                ledger,
                threshold=(args.threshold if args.threshold is not None
                           else perfledger.DEFAULT_THRESHOLD),
                window=(args.window if args.window is not None
                        else perfledger.DEFAULT_WINDOW))
        except OSError as e:
            print(f"cannot read {ledger!r}: {e}", file=sys.stderr)
            return 1
        print(report)
        if not ok:
            # the drift verdict is a pinned anomaly: the flight ring (and
            # an auto-bundle) records why a gate failed
            from .utils import detectors

            detectors.fire("perf_drift", ledger=ledger)
        return 0 if ok else 2
    if not args.ingest:
        try:
            print(perfledger.trend(ledger))
        except OSError as e:
            print(f"cannot read {ledger!r}: {e}", file=sys.stderr)
            return 1
    return 0


def _roofline(args) -> int:
    from .utils import costmodel, perfledger
    from .utils.telemetry import read_events

    if args.path is None and not args.check:
        print("roofline: nothing to do — pass a telemetry run JSONL "
              "and/or --check", file=sys.stderr)
        return 1
    if args.path is not None:
        try:
            folded = costmodel.fold_roofline_events(read_events(args.path))
        except OSError as e:
            print(f"cannot read {args.path!r}: {e}", file=sys.stderr)
            return 1
        print(costmodel.render_roofline(folded))
    if args.check:
        ledger = args.ledger or perfledger.default_path()
        try:
            ok, report = perfledger.check_roofline(
                ledger,
                threshold=(args.threshold if args.threshold is not None
                           else perfledger.DEFAULT_THRESHOLD),
                window=(args.window if args.window is not None
                        else perfledger.DEFAULT_WINDOW))
        except OSError as e:
            print(f"cannot read {ledger!r}: {e}", file=sys.stderr)
            return 1
        print(report)
        if not ok:
            from .utils import detectors

            detectors.fire("roofline_drift", ledger=ledger)
        return 0 if ok else 2
    return 0


def _telemetry(args) -> int:
    from .utils.telemetry import (
        aggregate_file, render_grid, render_recovery, render_replicas,
        render_tenants,
    )

    paths = args.path
    path0 = paths[0]
    if args.trace:
        from .utils.trace import write_perfetto

        try:
            n = write_perfetto(paths, args.trace)
        except OSError as e:
            print(f"cannot read {paths!r}: {e}", file=sys.stderr)
            return 1
        print(f"wrote {n} trace events to {args.trace}"
              + (f" (merged from {len(paths)} files)"
                 if len(paths) > 1 else ""))
        return 0
    if len(paths) > 1:
        print("multiple input files are only merged by --trace; "
              "reporting on the first", file=sys.stderr)
    if args.follow:
        return _telemetry_follow(path0)
    if args.recovery:
        try:
            timeline = render_recovery(path0)
        except OSError as e:
            print(f"cannot read {path0!r}: {e}", file=sys.stderr)
            return 1
        print(timeline if timeline else f"no recovery events in {path0!r}")
        return 0
    try:
        reg = aggregate_file(path0)
    except OSError as e:
        print(f"cannot read {path0!r}: {e}", file=sys.stderr)
        return 1
    if reg.n_events == 0:
        print(f"no telemetry events in {path0!r}", file=sys.stderr)
        return 1
    if args.prom:
        sys.stdout.write(reg.render_prometheus())
    elif args.json:
        print(json.dumps(reg.as_dict()))
    else:
        from .utils.trace import render_time_split

        print(reg.render_summary())
        # each section only where the log has its events: the time split
        # of null runs, the serving tenants, a fleet's replicas, a grid
        for section in (render_time_split(path0), render_tenants(path0),
                        render_replicas(path0), render_grid(path0)):
            if section:
                print()
                print(section)
    return 0


def _bundle(args) -> int:
    from .utils import bundle as fbundle

    if args.collect:
        print(fbundle.collect(dest=args.path, reason=args.reason))
        return 0
    if args.path is None:
        print("bundle: pass a bundle directory to render, or --collect",
              file=sys.stderr)
        return 1
    try:
        print(fbundle.render_report(args.path))
    except (OSError, ValueError) as e:
        print(f"cannot render {args.path!r}: {e}", file=sys.stderr)
        return 1
    return 0


def _serve(args) -> int:
    import os

    if args.telemetry is None:
        args.telemetry = os.environ.get("NETREP_TELEMETRY") or None
    t = time.time()
    from .serve.fleet import fleet_daemon
    from .serve.server import serve_daemon

    args.boot["import_serve_s"] = time.time() - t
    if args.fleet and (args.fleet > 1 or args.autoscale):
        # the coordinator only routes and ships journals: it creates no
        # CUDA context; the replica daemons it spawns run on --device
        return fleet_daemon(args)
    return serve_daemon(args)


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.cmd is None:
        # a bare invocation is the self-test with its own defaults
        args = ap.parse_args(["selftest", *(argv or [])])

    if args.cmd == "lint":
        # device-free: pure AST analysis
        from .analysis.linter import main_lint

        return main_lint(args)
    if args.cmd == "version":
        from .version import __version__

        print(__version__)
        return 0
    if args.cmd == "bundle":
        return _bundle(args)
    if args.cmd == "perf":
        return _perf(args)
    if args.cmd == "roofline":
        return _roofline(args)
    if args.cmd == "telemetry":
        return _telemetry(args)
    if args.cmd == "top":
        from .serve.top import run_top

        return run_top(args)

    # the device commands: the card unless --device cpu, and without a
    # card the port's device error, before any work. The imports are
    # timed for the serve daemon's boot split
    t = time.time()
    import torch  # noqa: F401

    args.boot = {"t_main": _T0, "import_torch_s": time.time() - t}
    t = time.time()
    from .utils.config import resolve_device  # the recorder, TF32 off

    args.boot["import_utils_s"] = time.time() - t

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"{args.cmd}: {e}", file=sys.stderr)
        return 1
    if args.cmd == "warmup":
        from .warmup import main_warmup

        return main_warmup(args)
    if args.cmd == "serve":
        return _serve(args)
    if args.cmd == "chaos":
        if args.fleet:
            return _chaos_fleet(args)
        if args.evict:
            print("chaos --evict is a fleet drill; add --fleet",
                  file=sys.stderr)
            return 2
        if args.serve:
            return _chaos_serve(args)
        return _chaos(args)

    from .utils.selftest import selftest

    try:
        out = selftest(n_perm=args.n_perm, seed=args.seed,
                       verbose=not args.json, max_shapes=args.max_shapes,
                       device=args.device)
    except (RuntimeError, ValueError) as e:
        print(f"selftest FAILED: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
