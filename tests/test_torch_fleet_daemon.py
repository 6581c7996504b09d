"""The daemon fleet of the port (``python -m netrep_tpu_torch serve --fleet
N``) on the CPU: a coordinator process over two replica daemon processes
that inherit its ``--device``. An analysis through the coordinator's
socket gives the JAX package's in-process served result (p-values,
``counts_hi/lo/eff``, ``n_perm_used``); ``chaos --fleet`` kills a replica
mid-pack, fails it over with the JAX drill's event order (replica_lost →
failover_start → failover_done → ring_rebalanced) and respawns it as
generation ``.g1``; under ``route_mode='redirect'`` the coordinator
answers with the home replica's socket and :class:`SocketClient` follows
it under one idempotency key. Unix socket paths are bounded, so every
daemon here runs in a short relative directory of the test's own."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from netrep_tpu.serve import InProcessClient as JClient  # noqa: E402
from netrep_tpu.serve import PreservationServer as JServer  # noqa: E402
from netrep_tpu.serve import ServeConfig as JServeConfig  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch import __main__ as tcli  # noqa: E402
from netrep_tpu_torch.serve import fleet as tfleet  # noqa: E402
from netrep_tpu_torch.serve.client import SocketClient  # noqa: E402
from netrep_tpu_torch.utils import telemetry as tm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = dict(genes=100, modules=3, n_samples=16, seed=7)
FIELDS = ("p_values", "counts_hi", "counts_lo", "counts_eff")


def _wait(path, proc, budget=240.0):
    deadline = time.monotonic() + budget
    while not os.path.exists(path):
        assert proc.poll() is None, proc.stderr.read()[-3000:]
        assert time.monotonic() < deadline, "no socket"
        time.sleep(0.05)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A coordinator and two replica daemons on the CPU, in a short
    directory: ``(ready line, working directory)``."""
    cwd = tmp_path_factory.mktemp("fd")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    env.pop("NETREP_FAULT_PLAN", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "netrep_tpu_torch", "serve", "--fleet", "2",
         "--socket", "f.sock", "--fleet-dir", "fl", "--device", "cpu",
         "--chunk", "16", "--checkpoint-every", "16", "--heartbeat-s", "0.2",
         "--telemetry", "coord.jsonl"],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        _wait(os.path.join(cwd, "f.sock"), proc)
        ready = json.loads(proc.stdout.readline())
        yield ready, cwd
        c = SocketClient(os.path.join(cwd, "f.sock"), timeout=120)
        assert c.shutdown() == {"ok": True, "draining": True}
        c.close()
        assert proc.wait(timeout=180) == 0
        drained = json.loads(proc.stdout.read().strip().splitlines()[-1])
        assert drained == {"serve": "fleet_drained", "replicas": ["r0", "r1"]}
    finally:
        # the coordinator's session holds its replicas: none outlives the
        # module, even on a failure
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def _client(cwd, **kw):
    # a relative path keeps the socket's address short
    here = os.getcwd()
    os.chdir(cwd)
    try:
        return SocketClient("f.sock", **kw)
    finally:
        os.chdir(here)


def test_replicas_inherit_the_coordinators_device(fleet):
    ready, cwd = fleet
    assert ready["serve"] == "ready" and ready["fleet"] == 2
    assert sorted(ready["replicas"]) == ["r0", "r1"]
    for rid, boot in ready["boot"].items():
        # each replica's ready line: its boot split, on the CPU no context
        assert boot["context_s"] == 0.0 and "libraries" not in boot
        assert boot["spawned_t"] <= boot["t_main"] <= boot["ready_t"]
        assert boot["import_torch_s"] > 0
    c = _client(cwd, timeout=60)
    rows = c.stats()["replicas"]
    c.close()
    for rid in ("r0", "r1"):
        with open(f"/proc/{rows[rid]['pid']}/cmdline", "rb") as f:
            argv = f.read().decode().split("\0")
        assert argv[argv.index("--device") + 1] == "cpu"
        assert argv[argv.index("--fleet-label") + 1] == rid
        assert rows[rid]["alive"] and rows[rid]["gen"] == 0


def test_analysis_through_the_coordinator_equals_jax(fleet):
    _ready, cwd = fleet
    c = _client(cwd, timeout=300)
    try:
        fx = c.register_fixture("acme", **FIXTURE)
        got = [c.analyze("acme", fx["discovery"], fx["test"], n_perm=64,
                         seed=s, idempotency_key=f"k{s}") for s in (5, 6)]
        again = c.analyze("acme", fx["discovery"], fx["test"], n_perm=64,
                          seed=5, idempotency_key="k5")
        st = c.stats()
    finally:
        c.close()
    srv = JServer(JServeConfig(engine=JConfig(chunk_size=16, autotune=False),
                               journal=None))
    try:
        jc = JClient(srv)
        jfx = jc.register_fixture("acme", **FIXTURE)
        want = [jc.analyze("acme", jfx["discovery"], jfx["test"], n_perm=64,
                           seed=s) for s in (5, 6)]
    finally:
        srv.close()
    for g, w in zip(got, want):
        for f in FIELDS:
            assert np.array_equal(np.asarray(g[f]), np.asarray(w[f])), f
        assert g["n_perm_used"] == w["n_perm_used"]
        assert g["completed"] == w["completed"] == 64
    # the duplicate answers from the journaled result
    assert np.array_equal(np.asarray(again["p_values"]),
                          np.asarray(got[0]["p_values"]))
    served = {rid: row["done"] for rid, row in st["replicas"].items()}
    assert sum(served.values()) == 2 and 0 in served.values()


def test_chaos_fleet_drill(capsys, tmp_path, monkeypatch):
    # a replica daemon SIGKILLed mid-pack: the journal fails over to its
    # peer, every request bit-equal to its direct call, the victim back as
    # its next generation
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["chaos", "--fleet", "--device", "cpu", "--json",
                      "--requests", "2", "--n-perm", "96"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ok"] and summary["bit_identical"]
    assert summary["recovered"] and summary["exit_code"] == 0
    killed = summary["killed_replica"]
    assert summary["respawned"] == f"{killed}.g1"
    order = ["replica_lost", "failover_start", "failover_done",
             "ring_rebalanced"]
    seen = [ev for ev in summary["timeline"] if ev in order]
    assert seen[seen.index("replica_lost"):][:4] == order
    assert not [p for p in os.listdir(tmp_path) if p.startswith("nchaos_")]


def _fake_daemon(path, respond, received):
    """A one-op-a-line unix listener answering with ``respond(op)``."""
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(path)
    listener.listen(4)

    def serve():
        while True:
            try:
                conn, _ = listener.accept()
            except OSError:
                return
            with conn:
                f = conn.makefile("r", encoding="utf-8")
                while True:
                    line = f.readline()
                    if not line:
                        break
                    op = json.loads(line)
                    received.append(op)
                    conn.sendall((json.dumps(respond(op)) + "\n").encode())

    threading.Thread(target=serve, daemon=True).start()
    return listener


def test_socket_client_follows_redirect_under_one_key(tmp_path,
                                                      monkeypatch):
    # the coordinator's redirect re-points the client at the replica's
    # socket and re-sends the SAME op at once: same idempotency key, same
    # trace id, no retry attempt spent
    monkeypatch.chdir(tmp_path)
    seen_coord, seen_replica = [], []
    l1 = _fake_daemon("c.sock", lambda op: {
        "ok": False, "retryable": True, "redirect": "r.sock"}, seen_coord)
    l2 = _fake_daemon("r.sock", lambda op: {
        "ok": True, "result": {"p_values": [0.5], "completed": 4}},
        seen_replica)
    try:
        client = SocketClient("c.sock", timeout=30)
        res = client.analyze("a", "d", "t", n_perm=4, seed=1, retries=0)
        assert res["completed"] == 4 and client.path == "r.sock"
        client.close()
    finally:
        l1.close()
        l2.close()
    assert len(seen_coord) == 1 and len(seen_replica) == 1
    assert (seen_replica[0]["idempotency_key"]
            == seen_coord[0]["idempotency_key"])
    assert (seen_replica[0]["trace_ctx"]["trace"]
            == seen_coord[0]["trace_ctx"]["trace"])


class _Stub:
    """A daemon replica handle whose socket is never dialled."""

    def __init__(self, rid):
        self.rid = rid
        self.socket_path = f"fl/{rid}/serve.sock"
        self.journal_path = None
        self.lifecycle = tfleet.ReplicaLifecycle(rid)
        self.dead = threading.Event()
        self.forwarded = []

    def forward(self, op):
        self.forwarded.append(op)
        return {"ok": True, "result": {}}

    def alive(self):
        return True

    def release(self):
        pass

    def adopt_journal(self, path, datasets_only=False):
        return {"requeued": 0, "results": 0}

    def close(self, drain=True, timeout=None):
        pass


@pytest.mark.parametrize("mode", ["proxy", "redirect"])
def test_redirect_route_mode(mode):
    reps = [_Stub("r0"), _Stub("r1")]
    coord = tfleet.FleetCoordinator(reps, tfleet.FleetConfig(), start=False)
    try:
        op = {"op": "analyze", "tenant": "a", "discovery": "d", "test": "t",
              "n_perm": 8}
        resp = tfleet.dispatch_fleet_op(coord, dict(op), threading.Event(),
                                        route_mode=mode)
        home = coord.route("a", "d", "t")
        if mode == "redirect":
            assert resp == {"ok": False, "retryable": True,
                            "redirect": home.socket_path}
            assert not home.forwarded
        else:
            assert resp == {"ok": True, "result": {}}
            assert home.forwarded[0]["idempotency_key"].startswith("f-")
    finally:
        coord.close(drain=False)


def test_respawn_hook_runs_after_failover(tmp_path):
    # the hook the daemon fleet respawns through: called once, outside the
    # lock, after the peer adopted the journal and the bundle was written
    reps = [_Stub("r0"), _Stub("r1")]
    bus_path = str(tmp_path / "coord.jsonl")
    coord = tfleet.FleetCoordinator(reps, tfleet.FleetConfig(
        fleet_dir=str(tmp_path), telemetry=bus_path), start=False)
    calls = []
    coord.on_failover = lambda rid, peer: calls.append((rid, peer, sorted(
        coord.live_replicas())))
    coord.kill_replica("r0")
    coord.close(drain=False)
    assert calls == [("r0", "r1", ["r1"])]
    evs = [e["ev"] for e in tm.read_events(bus_path)]
    assert "failover_done" in evs and "replica_lost" in evs


def test_fleet_needs_a_socket_and_a_journal(capsys):
    args = tcli.build_parser().parse_args(
        ["serve", "--fleet", "2", "--device", "cpu"])
    assert tfleet.fleet_daemon(args) == 2
    assert "needs --socket" in capsys.readouterr().err
    args = tcli.build_parser().parse_args(
        ["serve", "--fleet", "2", "--socket", "x.sock", "--no-journal",
         "--device", "cpu"])
    assert tfleet.fleet_daemon(args) == 2
    assert "requires journaling" in capsys.readouterr().err
