"""The port's serving wire (``netrep_tpu_torch.serve.server``,
``client``, ``protocol``, ``top``) against the JAX package's, on the CPU.

Held: the same op lines give the JAX daemon's responses — malformed,
oversized and unknown ops each get their structured error and the loop
stays alive, a full queue answers retryable with ``retry_after_s``,
registrations answer the same digests and analyses the same p-values and
counts; ``dump`` answers a structured error naming ROADMAP.md Queue 1
item 16b; ``retry_delay`` and the array codec equal the JAX package's; a
client retry lands on one computation. Then the daemon itself, started as
a subprocess on ``serve_daemon(daemon_args(...))`` (the port has no CLI
yet): over a unix socket ``ping``, ``register_fixture``, two ``analyze``
equal to the same requests served in process, ``metrics``, ``stats``,
``top``'s ``--once --json`` frame, and ``shutdown`` with its ``drained``
line and exit code 0; over stdio the same loop, drained at EOF. Nothing
waits on a timer: the test reads the daemon's ``ready`` line and joins
the process."""

import argparse
import io
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from netrep_tpu import serve as jserve  # noqa: E402
from netrep_tpu.data import make_mixed_pair  # noqa: E402
from netrep_tpu.serve import client as jclient  # noqa: E402
from netrep_tpu.serve import protocol as jproto  # noqa: E402
from netrep_tpu.serve import server as jsrv_mod  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch import serve as tserve  # noqa: E402
from netrep_tpu_torch.serve import client as tclient  # noqa: E402
from netrep_tpu_torch.serve import protocol as tproto  # noqa: E402
from netrep_tpu_torch.serve import server as tsrv_mod  # noqa: E402
from netrep_tpu_torch.serve import top as ttop  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = EngineConfig(chunk_size=16)
JCFG = JConfig(chunk_size=16, autotune=False)
FIXTURE = dict(genes=80, modules=2, n_samples=16, seed=7)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fx():
    mixed = make_mixed_pair(100, 3, n_samples=16, seed=7)
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    assign = {f"node_{i}": "0" for i in range(dn.shape[0])}
    for lab, idx in mixed["specs"]:
        for i in idx:
            assign[f"node_{i}"] = str(lab)
    return dict(dn=dn, dc=dc, dd=dd, tn=tn, tc=tc, td=td, assign=assign)


def servers(tmp_path, **cfg_kw):
    """A JAX and a port server, not started, each with its telemetry."""
    j = jserve.PreservationServer(jserve.ServeConfig(
        engine=JCFG, telemetry=str(tmp_path / "jtel.jsonl"), **cfg_kw),
        start=False)
    t = tserve.PreservationServer(tserve.ServeConfig(
        engine=CFG, telemetry=str(tmp_path / "tel.jsonl"), device="cpu",
        **cfg_kw), start=False)
    return j, t


def read_events(path):
    return [json.loads(line) for line in open(path, encoding="utf-8")]


def run_lines(mod, srv, text):
    """Every response the transport loop gives for ``text``'s lines."""
    lines = io.StringIO(text)
    stop = threading.Event()
    out = []
    while True:
        op, resp = mod.read_op_line(lines, srv)
        if op is None and resp is None:
            return out
        if resp is None:
            resp = mod.dispatch_op(srv, op, stop)
        out.append(resp)


# ---------------------------------------------------------------------------
# the op loop against the JAX daemon's
# ---------------------------------------------------------------------------

def test_malformed_lines_keep_the_loop_alive(tmp_path):
    text = ("not json at all\n"
            "[1, 2, 3]\n"
            '{"op": "launch_missiles"}\n'
            "\n"
            '{"op": "register", "tenant": "a"}\n'
            '{"op": "analyze", "tenant": "ghost", "discovery": "d", '
            '"test": "t"}\n'
            '{"op": "ping"}\n')
    j, t = servers(tmp_path)
    want = run_lines(jsrv_mod, j, text)
    got = run_lines(tsrv_mod, t, text)
    j.close(drain=False)
    t.close(drain=False)
    assert got == want
    assert [r["ok"] for r in got] == [False, False, False, True, False,
                                      False, True]
    assert got[0]["malformed"] and "bad JSON" in got[0]["error"]
    assert got[1]["malformed"] and "unknown op" in got[2]["error"]
    assert got[3] == {"ok": True, "empty": True}
    assert got[4]["error"].startswith("KeyError")
    assert "unknown tenant" in got[5]["error"] and got[6]["pong"]
    ev = read_events(str(tmp_path / "tel.jsonl"))
    assert sum(1 for e in ev if e["ev"] == "request_malformed") == 3


def test_oversized_line_is_rejected_and_drained(tmp_path, monkeypatch):
    monkeypatch.setattr(tsrv_mod, "MAX_LINE_BYTES", 64)
    monkeypatch.setattr(jsrv_mod, "MAX_LINE_BYTES", 64)
    text = ('{"op": "ping", "junk": "' + "x" * 500 + '"}\n'
            '{"op": "ping"}\n')
    j, t = servers(tmp_path)
    want = run_lines(jsrv_mod, j, text)
    got = run_lines(tsrv_mod, t, text)
    j.close(drain=False)
    t.close(drain=False)
    assert got == want
    assert got[0]["malformed"] and "exceeds 64 bytes" in got[0]["error"]
    assert got[1] == {"ok": True, "pong": True}


def test_queue_full_response_is_retryable_with_hint(fx, tmp_path):
    op = {"op": "analyze", "tenant": "a", "discovery": "d", "test": "t",
          "n_perm": 64, "seed": 2}
    out = []
    for srv, mod in zip(servers(tmp_path, max_queue=1,
                                brownout_rate_pps=10.0),
                        (jsrv_mod, tsrv_mod)):
        srv.register_dataset("a", "d", network=fx["dn"],
                             correlation=fx["dc"], data=fx["dd"],
                             assignments=fx["assign"])
        srv.register_dataset("a", "t", network=fx["tn"],
                             correlation=fx["tc"], data=fx["td"])
        srv.submit("a", "d", "t", n_perm=64, seed=1)
        out.append(mod.dispatch_op(srv, op, threading.Event()))
        srv.close(drain=False)
    want, got = out
    assert got == want
    assert got["ok"] is False and got["retryable"] is True
    assert got["retry_after_s"] == pytest.approx(12.8)
    assert "QueueFull" in got["error"]


def test_register_and_analyze_ops_equal_jax(fx, tmp_path):
    """Inline registrations (nested lists, as the wire carries them) give
    the JAX digests; the analyze op's encoded result has the JAX server's
    p-values and counts."""
    reg = [
        {"op": "register", "tenant": "a", "name": "d",
         "network": fx["dn"].tolist(), "correlation": fx["dc"].tolist(),
         "data": fx["dd"].tolist(), "assignments": fx["assign"]},
        {"op": "register", "tenant": "a", "name": "t",
         "network": fx["tn"].tolist(), "correlation": fx["tc"].tolist(),
         "data": fx["td"].tolist()},
        {"op": "register", "tenant": "a", "name": "x",
         "data": fx["dd"].tolist(), "beta": [3.0, "signed"]},
    ]
    analyze = {"op": "analyze", "tenant": "a", "discovery": "d",
               "test": "t", "n_perm": 48, "seed": 5, "adaptive": True,
               "idempotency_key": "K", "timeout": 600}
    out = []
    for srv, mod in zip(servers(tmp_path), (jsrv_mod, tsrv_mod)):
        stop = threading.Event()
        resp = [mod.dispatch_op(srv, op, stop) for op in reg]
        srv.start()
        resp.append(mod.dispatch_op(srv, analyze, stop))
        resp.append(mod.dispatch_op(srv, analyze, stop))   # deduped
        resp.append(mod.dispatch_op(srv, {"op": "shutdown"}, stop))
        assert stop.is_set()
        srv.close()
        out.append(resp)
    want, got = out
    assert [r["digest"] for r in got[:3]] == [r["digest"] for r in want[:3]]
    g, w = (jproto.decode_arrays(r)["result"] for r in (got[3], want[3]))
    for f in ("p_values", "counts_hi", "counts_lo", "counts_eff",
              "n_perm_used"):
        assert np.array_equal(g[f], w[f]), f
    assert np.abs(g["observed"] - w["observed"]).max() <= 1e-4
    assert got[4] == got[3]
    assert got[5] == want[5] == {"ok": True, "draining": True}


def test_dump_and_evict_ops(tmp_path):
    j, t = servers(tmp_path)
    stop = threading.Event()
    resp = tsrv_mod.dispatch_op(t, {"op": "dump"}, stop)
    assert resp == {"ok": False, "error": tsrv_mod.DUMP_UNAVAILABLE}
    assert "ROADMAP.md Queue 1 item 16b" in resp["error"]
    assert not stop.is_set()
    assert tsrv_mod.dispatch_op(t, {"op": "ping"}, stop)["pong"]
    evict = {"op": "evict_notice", "grace_s": 5}
    jstop = threading.Event()
    assert (tsrv_mod.dispatch_op(t, evict, stop)
            == jsrv_mod.dispatch_op(j, evict, jstop))
    assert stop.is_set() and jstop.is_set()
    j.close(drain=False)
    t.close(drain=False)


def test_adopt_journal_op_equals_jax(fx, tmp_path):
    """``adopt_journal`` replays another server's journal: the same
    summary in both packages, the adopted tenant's datasets served."""
    src = str(tmp_path / "peer.jsonl")
    peer = tserve.PreservationServer(tserve.ServeConfig(
        engine=CFG, journal=src, device="cpu"), start=False)
    peer.register_fixture("p", "fx", **FIXTURE)
    peer.close(drain=False)
    op = {"op": "adopt_journal", "path": src, "datasets_only": True}
    j, t = servers(tmp_path)
    want = jsrv_mod.dispatch_op(j, op, threading.Event())
    got = tsrv_mod.dispatch_op(t, op, threading.Event())
    assert got == want
    assert got["adopted"]["datasets"] == 1
    assert (t._dataset("p", "fx_d").digest
            == j._dataset("p", "fx_d").digest)
    j.close(drain=False)
    t.close(drain=False)


# ---------------------------------------------------------------------------
# the codec and the clients
# ---------------------------------------------------------------------------

def test_array_codec_equals_jax():
    payload = {"result": {"observed": np.arange(6.0).reshape(2, 3),
                          "p_values": np.array([0.5, 0.25]),
                          "n_perm_used": None, "seed": np.int64(3),
                          "x": np.float32(0.5),
                          "tests": [{"counts_hi": np.array([1, 2])}]}}
    enc = tproto.encode_arrays(payload)
    assert enc == jproto.encode_arrays(payload)
    json.dumps(enc)
    dec, jdec = tproto.decode_arrays(enc), jproto.decode_arrays(enc)
    r, jr = dec["result"], jdec["result"]
    assert np.array_equal(r["observed"], jr["observed"])
    assert isinstance(r["tests"][0]["counts_hi"], np.ndarray)
    assert r["n_perm_used"] is None and r["seed"] == 3
    assert tproto.ARRAY_KEYS == jproto.ARRAY_KEYS


@pytest.mark.parametrize("token", ["k", "other", "c-0123"])
def test_retry_delay_equals_jax(token):
    for attempt in range(0, 12):
        for kw in ({}, {"jitter": 0.0}, {"base_s": 0.1, "max_s": 1.5},
                   {"factor": 3.0, "jitter": 0.5}):
            assert (tclient.retry_delay(attempt, token, **kw)
                    == jclient.retry_delay(attempt, token, **kw))
    d1, d2, d3 = (tclient.retry_delay(a, token, jitter=0.0)
                  for a in (1, 2, 3))
    assert d1 < d2 < d3 and d2 == 2 * d1
    assert tclient.retry_delay(10, token, max_s=1.5, jitter=0.0) == 1.5


def test_client_retry_attaches_to_one_computation(fx, tmp_path):
    class FlakyAdmission:
        """Server proxy whose analyze rejects the first two attempts."""

        def __init__(self, server):
            self.server = server
            self.keys = []

        def analyze(self, tenant, discovery, test, timeout=None, **kw):
            self.keys.append(kw["idempotency_key"])
            if len(self.keys) <= 2:
                raise tserve.QueueFull("synthetic overload",
                                       retry_after_s=0.01)
            return self.server.analyze(tenant, discovery, test,
                                       timeout=timeout, **kw)

    srv = tserve.PreservationServer(tserve.ServeConfig(
        engine=CFG, device="cpu"))
    srv.register_dataset("a", "d", network=fx["dn"], correlation=fx["dc"],
                         data=fx["dd"], assignments=fx["assign"])
    srv.register_dataset("a", "t", network=fx["tn"], correlation=fx["tc"],
                         data=fx["td"])
    flaky = FlakyAdmission(srv)
    sleeps = []
    try:
        res = tserve.InProcessClient(flaky).analyze(
            "a", "d", "t", n_perm=32, seed=3, retries=3, retry_base_s=0.0,
            sleep=sleeps.append, timeout=600)
        st = srv.stats()
    finally:
        srv.close()
    assert res["completed"] == 32
    assert len(sleeps) == 2 and all(s >= 0.01 for s in sleeps)
    assert len(set(flaky.keys)) == 1 and len(flaky.keys) == 3
    assert st["tenants"]["a"]["received"] == 1
    with pytest.raises(tserve.QueueFull):
        tserve.InProcessClient(FlakyAdmission(srv)).analyze(
            "a", "d", "t", retries=1, sleep=sleeps.append)


# ---------------------------------------------------------------------------
# the daemon in a subprocess
# ---------------------------------------------------------------------------

def _daemon(tmp_path, **kw):
    """A daemon process on ``serve_daemon(daemon_args(**kw))`` on the CPU,
    one torch thread."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "torch.set_num_threads(1)\n"
        "from netrep_tpu_torch.serve.server import daemon_args, "
        "serve_daemon\n"
        f"sys.exit(serve_daemon(daemon_args(**{kw!r})))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _in_process(requests):
    srv = tserve.PreservationServer(tserve.ServeConfig(
        engine=CFG, device="cpu"))
    try:
        fixture = srv.register_fixture("a", "fx", **FIXTURE)
        return fixture, [srv.analyze("a", "fx_d", "fx_t", timeout=600, **kw)
                         for kw in requests]
    finally:
        srv.close()


def test_socket_daemon_end_to_end(tmp_path, monkeypatch):
    # a socket path relative to both processes' directory: a unix socket's
    # path is bounded (108 bytes), a temporary directory's is not
    monkeypatch.chdir(tmp_path)
    sock = "n.sock"
    journal = str(tmp_path / "j.jsonl")
    proc = _daemon(tmp_path, socket=sock, device="cpu", chunk=16,
                   journal=journal, telemetry=str(tmp_path / "tel.jsonl"))
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["serve"] == "ready" and ready["socket"] == sock
        client = tserve.SocketClient(sock, timeout=600)
        assert client.ping() == {"ok": True, "pong": True}
        fixture = client.register_fixture("a", "fx", **FIXTURE)
        requests = [dict(n_perm=48, seed=1),
                    dict(n_perm=64, seed=2, adaptive=True)]
        got = [client.analyze("a", fixture["discovery"], fixture["test"],
                              **kw) for kw in requests]
        text = client.metrics()
        st = client.stats()
        top = io.StringIO()
        stdout, sys.stdout = sys.stdout, top
        try:
            rc = ttop.run_top(argparse.Namespace(
                socket=sock, timeout=60.0, json=True, once=True,
                interval=0.0))
        finally:
            sys.stdout = stdout
        assert client.shutdown() == {"ok": True, "draining": True}
        client.close()
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    drained = json.loads(out.strip().splitlines()[-1])
    assert drained == {"serve": "drained", "requests_done": 2,
                       "requests_requeued": 0, "packs": 2}
    want_fixture, want = _in_process(requests)
    assert fixture == want_fixture
    for g, w in zip(got, want):
        for f in ("observed", "p_values", "counts_hi", "counts_lo",
                  "counts_eff"):
            assert np.array_equal(g[f], w[f]), f
        assert g["completed"] == w["completed"]
    assert np.array_equal(got[1]["n_perm_used"], want[1]["n_perm_used"])
    assert 'netrep_serve_requests_total{tenant="a",outcome="done"} 2' in text
    assert st["tenants"]["a"]["done"] == 2 and st["packs"] == 2
    assert st["journal"] == journal and st["device"] == "cpu"
    assert rc == 0
    frame = json.loads(top.getvalue())
    assert frame["tenants"][0]["tenant"] == "a"
    assert frame["tenants"][0]["done"] == 2
    # the journal holds the fixture by its parameters, not its matrices
    kinds = [json.loads(line)["kind"] for line in open(journal)]
    assert kinds.count("dataset") == 1 and kinds.count("done") == 2
    assert not os.path.exists(sock)


def test_stdio_daemon_drains_at_eof(tmp_path):
    proc = _daemon(tmp_path, device="cpu", chunk=16, no_journal=True)
    lines = "\n".join([
        '{"op": "ping"}', "not json", '{"op": "dump"}',
        json.dumps({"op": "register_fixture", "tenant": "a", **FIXTURE}),
        '{"op": "stats"}',
    ]) + "\n"
    out, err = proc.communicate(lines, timeout=300)
    assert proc.returncode == 0, err
    resp = [json.loads(line) for line in out.strip().splitlines()]
    assert resp[0]["serve"] == "ready" and resp[0]["stdio"] is True
    assert resp[1] == {"ok": True, "pong": True}
    assert resp[2]["malformed"] and resp[3]["error"] == \
        tsrv_mod.DUMP_UNAVAILABLE
    assert resp[4]["fixture"]["discovery"] == "fx_d"
    assert resp[5]["stats"]["journal"] is None
    assert resp[6] == {"serve": "drained", "requests_done": 0,
                       "requests_requeued": 0, "packs": 0}


def test_daemon_arguments():
    args = tsrv_mod.daemon_args(socket="/x", chunk=16)
    assert args.socket == "/x" and args.chunk == 16
    assert args.journal == "netrep_serve_journal.jsonl"
    assert args.drain_timeout == 120.0 and args.device is None
    with pytest.raises(TypeError, match="unknown daemon arguments"):
        tsrv_mod.daemon_args(fleet=2)
    # recover without a journal is refused before anything starts
    assert tsrv_mod.serve_daemon(tsrv_mod.daemon_args(
        no_journal=True, recover=True, device="cpu")) == 2
