"""Crash-safe serving in the port (``netrep_tpu_torch.serve``) against the
JAX package's, on the CPU.

Held: the journal's round trip and torn final line (``scan`` of the port
equal to the JAX package's on the same file, ``result_digest`` and
``pack_checkpoint_path`` equal); the shipper's copy and acked offset
equal to the JAX shipper's; the ``accepted`` record on disk before
``submit`` returns; idempotency after completion and in flight; a
``crash`` plan mid-pack, then a fresh server with ``recover=True``: every
result bit-identical to an uncrashed server's, the pack resumed from its
checkpoint, the trace id on both generations' spans and the costs
conserved; completed results served from the journal with no pack;
deadlines in the queue and mid-pack on an injected clock (the survivor
equal to its solo call); brownout enter, shed and exit in the JAX
package's order; a bounded drain that journals its remainder, completed
by the next recovering boot.

Journals cross packages: a JAX server's journal (a finished request, a
pack killed mid-run by a ``crash`` plan, a queued request) replays in the
port's server — the finished request answered from the JAX result, the
others recomputed to the JAX server's p-values and counts — and a port
server's journal replays in the JAX server. Pack checkpoints do not
cross: their path hashes ``repr(EngineConfig)``, which differs between
the packages, so the other package recomputes the pack from its first
permutation (ROADMAP.md Queue 3).

No test sleeps or races a timer: the crashed worker is joined, queues are
filled before the worker starts, and deadlines run on a clock that
advances one second per reading."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from netrep_tpu import serve as jserve  # noqa: E402
from netrep_tpu.data import make_mixed_pair  # noqa: E402
from netrep_tpu.serve import journal as jjnl  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu.utils.config import FaultPolicy as JPolicy  # noqa: E402
from netrep_tpu_torch import serve as tserve  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402
from netrep_tpu_torch.serve import journal as tjnl  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402
from netrep_tpu_torch.utils.config import FaultPolicy  # noqa: E402

CFG = EngineConfig(chunk_size=16)
JCFG = JConfig(chunk_size=16, autotune=False)
JAX_TOL = 1e-4
SUBMITS = [
    ("k1", dict(n_perm=64, seed=3)),
    ("k2", dict(n_perm=64, seed=5)),
    ("k3", dict(n_perm=32, seed=11, adaptive=True)),
]


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


class StepClock:
    """A clock that advances one second per reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def port_server(tmp_path, *, start=True, tel="tel", clock=None, **cfg_kw):
    cfg_kw.setdefault("engine", CFG)
    cfg_kw.setdefault("telemetry", str(tmp_path / f"{tel}.jsonl"))
    return tserve.PreservationServer(
        tserve.ServeConfig(device="cpu", **cfg_kw), start=start,
        clock=clock)


def jax_server(tmp_path, *, start=True, tel="jtel", **cfg_kw):
    cfg_kw.setdefault("engine", JCFG)
    cfg_kw.setdefault("telemetry", str(tmp_path / f"{tel}.jsonl"))
    return jserve.PreservationServer(jserve.ServeConfig(**cfg_kw),
                                     start=start)


def register(srv, fx, tenants=("a",)):
    for t in tenants:
        srv.register_dataset(t, "d", network=fx["dn"], correlation=fx["dc"],
                             data=fx["dd"], assignments=fx["assign"])
        srv.register_dataset(t, "t", network=fx["tn"], correlation=fx["tc"],
                             data=fx["td"])


def read_events(path):
    return [json.loads(line) for line in open(path, encoding="utf-8")]


def solo(fx, **kw):
    return module_preservation(
        network={"d": fx["dn"], "t": fx["tn"]},
        correlation={"d": fx["dc"], "t": fx["tc"]},
        data={"d": fx["dd"], "t": fx["td"]},
        module_assignments=fx["assign"], discovery="d", test="t",
        config=CFG, simplify=False, device="cpu", **kw)["d"]["t"]


def assert_bits(got, want):
    """Equal bit for bit: observed, p-values, counts, n_perm_used."""
    for f in ("observed", "p_values", "counts_hi", "counts_lo",
              "counts_eff"):
        assert np.array_equal(np.asarray(got[f]), np.asarray(want[f])), f
    assert got["completed"] == want["completed"]
    if want["n_perm_used"] is None:
        assert got["n_perm_used"] is None
    else:
        assert np.array_equal(got["n_perm_used"], want["n_perm_used"])


def assert_counts(got, want):
    """Across packages: equal p-values, counts and n_perm_used; observed
    within the Queue 3 bound."""
    for f in ("p_values", "counts_hi", "counts_lo", "counts_eff"):
        assert np.array_equal(np.asarray(got[f]), np.asarray(want[f])), f
    assert got["completed"] == want["completed"]
    if want.get("n_perm_used") is None:
        assert got.get("n_perm_used") is None
    else:
        assert np.array_equal(got["n_perm_used"], want["n_perm_used"])
    assert np.abs(np.asarray(got["observed"], dtype=np.float64)
                  - np.asarray(want["observed"])).max() <= JAX_TOL


def uncrashed(fx, tmp_path, server, tag):
    """The SUBMITS through a fresh server of either package, queued before
    its worker starts: ``{key: result}``."""
    srv = server(tmp_path, start=False, tel=tag)
    register(srv, fx)
    hs = {k: srv.submit("a", "d", "t", idempotency_key=k, **kw)
          for k, kw in SUBMITS}
    srv.start()
    try:
        return {k: srv.wait(h, timeout=600) for k, h in hs.items()}
    finally:
        srv.close()


def crash(fx, tmp_path, server, jpath, policy, tag, submits=SUBMITS):
    """A journaled server of either package whose worker dies under a
    ``crash`` plan mid-pack; its journal and telemetry are closed, the
    crashed requests are left unfinished."""
    srv = server(tmp_path, start=False, tel=tag, journal=jpath,
                 checkpoint_every=16,
                 fault_policy=policy(plan="crash@24", backoff_base_s=0.0,
                                     backoff_jitter=0.0))
    register(srv, fx)
    handles = [srv.submit("a", "d", "t", idempotency_key=k, **kw)
               for k, kw in submits]
    srv.start()
    srv._worker.join(timeout=300)
    assert not srv._worker.is_alive(), "injected crash never fired"
    assert not any(h.done.is_set() for h in handles)
    srv.tel.close()
    srv.journal.close()
    return handles


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

def test_journal_round_trip_and_torn_final_line(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = tjnl.RequestJournal(path)
    j.append("tenant", tenant="a", weight=2)
    j.append("accepted", seq=1, id="r1", key="k1", tenant="a",
             discovery="d", test="t", params={"n_perm": 64, "seed": 3})
    j.append("accepted", seq=2, id="r2", key="k2", tenant="a",
             discovery="d", test="t", params={"n_perm": 32, "seed": 5})
    j.append("done", seq=1, id="r1", key="k1", tenant="a", digest="abc",
             result={"p_values": [0.1, 0.2]})
    j.append("drain_requeued", keys=["k2"])
    j.close()
    with pytest.raises(OSError, match="closed"):
        j.append("tenant", tenant="b")
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"jv": 1, "kind": "done", "seq": 2, "key": "k2", "trunc')
    state = tjnl.scan(path)
    assert state == jjnl.scan(path)
    assert state["tenants"] == {"a": 2}
    assert list(state["results"]) == ["k1"]
    assert [r["key"] for r in state["pending"]] == ["k2"]
    assert state["n_accepted"] == 2 and state["n_drain_requeued"] == 1
    res = {"p_values": np.array([0.5, 0.25]), "n": np.int64(3)}
    assert tjnl.result_digest(res) == jjnl.result_digest(res)
    members = [("k2", 5, 32, "ab"), ("k1", 3, 64, "cd")]
    assert (tjnl.pack_checkpoint_path("/ck", "cfg", members)
            == jjnl.pack_checkpoint_path("/ck", "cfg", members))


def test_journal_shipper_equals_jax(tmp_path):
    """Complete lines only, the acked offset persisted beside the copy,
    resumed by a new shipper: the same copy and offsets as the JAX
    shipper's on the same source."""
    src = tmp_path / "src.jsonl"
    src.write_text('{"jv": 1, "kind": "tenant", "tenant": "a"}\n'
                   '{"jv": 1, "kind": "acc')
    out = {}
    for name, mod in (("port", tjnl), ("jax", jjnl)):
        dest = str(tmp_path / name / "copy.jsonl")
        sh = mod.JournalShipper(str(src), dest)
        first = sh.flush()
        with open(src, "a") as f:
            f.write('epted", "key": "k"}\n')
        sh2 = mod.JournalShipper(str(src), dest)   # resumes the offset
        second = sh2.flush()
        sh2.start()
        sh2.stop()
        out[name] = (first, second, sh2.acked_offset,
                     open(dest).read(), open(dest + ".offset").read())
        with open(src) as f:
            whole = f.read()
        with open(src, "w") as f:   # the next package ships the same file
            f.write(whole[: whole.index("\n") + 1] + '{"jv": 1, "kind": "acc')
    assert out["port"] == out["jax"]
    assert out["port"][3].count("\n") == 2
    assert tjnl.JournalShipper(str(tmp_path / "none"),
                               str(tmp_path / "c2.jsonl")).flush() == 0


def test_accepted_is_durable_before_submit_returns(fx, tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    srv = port_server(tmp_path, start=False, journal=jpath)
    register(srv, fx)
    srv.submit("a", "d", "t", n_perm=32, seed=1, idempotency_key="k1")
    state = tjnl.scan(jpath)
    assert [r["key"] for r in state["pending"]] == ["k1"]
    rec = state["pending"][0]
    assert rec["tenant"] == "a" and rec["params"]["n_perm"] == 32
    assert rec["params"]["seed"] == 1 and len(rec["digests"]) == 2
    assert rec["digests"] == [srv._dataset("a", n).digest for n in "dt"]
    srv.close(drain=False)


# ---------------------------------------------------------------------------
# idempotency
# ---------------------------------------------------------------------------

def test_dedup_after_completion_never_recomputes(fx, tmp_path):
    srv = port_server(tmp_path, journal=str(tmp_path / "j"))
    register(srv, fx)
    try:
        r1 = srv.analyze("a", "d", "t", n_perm=32, seed=3,
                         idempotency_key="K", timeout=600)
        packs = srv.stats()["packs"]
        r2 = srv.analyze("a", "d", "t", n_perm=32, seed=3,
                         idempotency_key="K", timeout=600)
        st = srv.stats()
    finally:
        srv.close()
    assert r2 is r1 and st["packs"] == packs
    assert st["tenants"]["a"]["deduped"] == 1
    dedup = [e for e in read_events(str(tmp_path / "tel.jsonl"))
             if e["ev"] == "request_deduped"]
    assert dedup[0]["data"]["state"] == "completed"
    assert dedup[0]["data"]["key"] == "K"


def test_dedup_attaches_to_inflight_request(fx, tmp_path):
    srv = port_server(tmp_path, start=False)
    register(srv, fx)
    h1 = srv.submit("a", "d", "t", n_perm=32, seed=3, idempotency_key="K")
    h2 = srv.submit("a", "d", "t", n_perm=32, seed=3, idempotency_key="K")
    assert h2 is h1
    srv.start()
    try:
        res = srv.wait(h1, timeout=600)
    finally:
        srv.close()
    assert res["completed"] == 32
    dedup = [e for e in read_events(str(tmp_path / "tel.jsonl"))
             if e["ev"] == "request_deduped"]
    assert dedup and dedup[0]["data"]["state"] == "inflight"


# ---------------------------------------------------------------------------
# kill -> recover
# ---------------------------------------------------------------------------

def test_kill_recover_is_bit_identical(fx, tmp_path):
    """A crash plan mid-pack, then a recovering boot: every journaled
    request completes bit-identical to an uncrashed server, the partial
    pack resumed from its checkpoint."""
    jpath = str(tmp_path / "j.jsonl")
    crash(fx, tmp_path, port_server, jpath, FaultPolicy, "tel_crash")
    srv2 = port_server(tmp_path, journal=jpath, recover=True,
                       checkpoint_every=16, tel="tel_rec")
    try:
        got = {k: srv2.analyze("a", "d", "t", idempotency_key=k,
                               timeout=600, **kw) for k, kw in SUBMITS}
    finally:
        srv2.close()
    want = uncrashed(fx, tmp_path, port_server, "tel_ref")
    for k, _kw in SUBMITS:
        assert_bits(got[k], want[k])
    ev = read_events(str(tmp_path / "tel_rec.jsonl"))
    replay = [e for e in ev if e["ev"] == "journal_replayed"]
    assert replay and replay[0]["data"]["requeued"] == 3
    resumed = [e for e in ev if e["ev"] == "checkpoint_resumed"]
    assert resumed and resumed[0]["data"]["completed"] >= 16
    # the recomputed permutations: at most one checkpoint interval
    assert 24 - resumed[0]["data"]["completed"] <= 16
    assert solo(fx, n_perm=64, seed=3).p_values.tolist() == \
        got["k1"]["p_values"].tolist()


def test_kill_recover_trace_continuity_and_cost_conservation(fx, tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    ctx = {"trace": "ab" * 16, "parent": "client-span-9"}
    submits = [("k1", dict(n_perm=64, seed=3, trace_ctx=ctx)),
               ("k2", dict(n_perm=64, seed=5))]
    crash(fx, tmp_path, port_server, jpath, FaultPolicy, "tel_gen1",
          submits)
    srv2 = port_server(tmp_path, journal=jpath, recover=True,
                       checkpoint_every=16, tel="tel_gen2")
    try:
        res = {k: srv2.analyze("a", "d", "t", idempotency_key=k,
                               timeout=600,
                               **{a: v for a, v in kw.items()
                                  if a != "trace_ctx"})
               for k, kw in submits}
    finally:
        srv2.close()
    assert res["k1"]["trace"] == ctx["trace"]
    costs = [res[k]["cost"] for k, _ in submits]
    totals = costs[0]["pack_totals"]
    for f in ("device_s", "transfer_s", "perms", "bytes_to_host",
              "compile_s_amortized"):
        assert costs[0][f] + costs[1][f] == totals[f], f
    for gen in ("tel_gen1", "tel_gen2"):
        recv = [e["data"] for e in read_events(str(tmp_path / f"{gen}.jsonl"))
                if e["ev"] == "request_received"]
        assert ctx["trace"] in {d.get("trace") for d in recv}, gen


def test_recovery_serves_completed_requests_from_journal(fx, tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    srv = port_server(tmp_path, journal=jpath)
    register(srv, fx)
    try:
        r1 = srv.analyze("a", "d", "t", n_perm=32, seed=3,
                         idempotency_key="K", timeout=600)
    finally:
        srv.close(drain=True)
    # the worker never starts: nothing may need computing
    srv2 = port_server(tmp_path, journal=jpath, recover=True, start=False,
                       tel="tel_rec")
    try:
        r2 = srv2.analyze("a", "d", "t", n_perm=32, seed=3,
                          idempotency_key="K", timeout=5)
        st = srv2.stats()
    finally:
        srv2.close(drain=False)
    assert_bits(r2, r1)
    assert st["packs"] == 0
    ev = read_events(str(tmp_path / "tel_rec.jsonl"))
    assert [e["data"]["results"] for e in ev
            if e["ev"] == "journal_replayed"] == [1]


def test_journal_off_is_plain_serving(fx, tmp_path):
    srv = port_server(tmp_path)
    register(srv, fx)
    try:
        res = srv.analyze("a", "d", "t", n_perm=32, seed=3, timeout=600)
        assert srv.journal is None and srv._ckpt_dir is None
    finally:
        srv.close()
    assert np.array_equal(res["p_values"], solo(fx, n_perm=32,
                                                seed=3).p_values)
    assert not list(tmp_path.glob("*.ckpt"))


# ---------------------------------------------------------------------------
# journals across packages
# ---------------------------------------------------------------------------

def test_jax_journal_replays_in_the_port(fx, tmp_path):
    """A JAX server finishes k0, crashes mid-pack on k1/k2 and leaves k3
    queued; the port's recovering boot answers k0 from the JAX result and
    recomputes the rest (the JAX pack checkpoint is not its own) to the
    JAX server's p-values and counts."""
    jpath = str(tmp_path / "j.jsonl")
    jsrv = jax_server(tmp_path, journal=jpath, tel="jtel0")
    register(jsrv, fx)
    r0 = jsrv.analyze("a", "d", "t", n_perm=32, seed=1,
                      idempotency_key="k0", timeout=600)
    jsrv.close()
    crash(fx, tmp_path, jax_server, jpath, JPolicy, "jtel_crash")
    assert os.listdir(jpath + ".ckpt")          # the JAX pack checkpoint
    want = uncrashed(fx, tmp_path, jax_server, "jtel_ref")
    srv = port_server(tmp_path, journal=jpath, recover=True,
                      checkpoint_every=16, tel="tel_rec")
    try:
        got0 = srv.analyze("a", "d", "t", n_perm=32, seed=1,
                           idempotency_key="k0", timeout=600)
        got = {k: srv.analyze("a", "d", "t", idempotency_key=k,
                              timeout=600, **kw) for k, kw in SUBMITS}
        st = srv.stats()
    finally:
        srv.close()
    assert_bits(got0, {**r0, "n_perm_used": None})
    assert st["tenants"]["a"]["deduped"] == 4
    for k, _kw in SUBMITS:
        assert_counts(got[k], want[k])
    ev = read_events(str(tmp_path / "tel_rec.jsonl"))
    assert [e["data"]["requeued"] for e in ev
            if e["ev"] == "journal_replayed"] == [3]
    assert not any(e["ev"] == "checkpoint_resumed" for e in ev)


def test_port_journal_replays_in_jax(fx, tmp_path):
    """The reverse: a port server finishes k1 and a second port boot
    leaves k2/k3 queued at a bounded drain; the JAX server's recovering
    boot answers k1 from the port's result and computes k2/k3 to the
    port's p-values and counts."""
    jpath = str(tmp_path / "j.jsonl")
    srv = port_server(tmp_path, journal=jpath)
    register(srv, fx)
    done = srv.analyze("a", "d", "t", idempotency_key="k1", timeout=600,
                       **SUBMITS[0][1])
    srv.close()
    srv = port_server(tmp_path, journal=jpath, recover=True, start=False,
                      tel="tel_b")
    for k, kw in SUBMITS[1:]:
        srv.submit("a", "d", "t", idempotency_key=k, **kw)
    srv.close(drain=False)
    assert [r["key"] for r in tjnl.scan(jpath)["pending"]] == ["k2", "k3"]
    want = uncrashed(fx, tmp_path, port_server, "tel_ref")
    jsrv = jax_server(tmp_path, journal=jpath, recover=True, tel="jtel")
    try:
        got = {k: jsrv.analyze("a", "d", "t", idempotency_key=k,
                               timeout=600, **kw) for k, kw in SUBMITS}
    finally:
        jsrv.close()
    assert_bits(got["k1"], done)
    for k, _kw in SUBMITS[1:]:
        assert_counts(want[k], got[k])


# ---------------------------------------------------------------------------
# deadlines on an injected clock
# ---------------------------------------------------------------------------

def test_deadline_expiry_mid_pack_with_survivor_parity(fx, tmp_path):
    srv = port_server(tmp_path, start=False, clock=StepClock())
    register(srv, fx)
    h_ok = srv.submit("a", "d", "t", n_perm=48, seed=3, deadline_s=1e9)
    h_exp = srv.submit("a", "d", "t", n_perm=20000, seed=5, deadline_s=4)
    srv.start()
    try:
        r_ok = srv.wait(h_ok, timeout=600)
        with pytest.raises(tserve.ServeError, match="deadline exceeded"):
            srv.wait(h_exp, timeout=600)
        st = srv.stats()
    finally:
        srv.close()
    assert r_ok["pack_size"] == 2
    ref = solo(fx, n_perm=48, seed=3)
    assert np.array_equal(r_ok["p_values"], ref.p_values)
    assert np.abs(r_ok["observed"] - ref.observed).max() <= 1e-6
    assert st["tenants"]["a"]["expired"] == 1
    exp = [e["data"] for e in read_events(str(tmp_path / "tel.jsonl"))
           if e["ev"] == "request_expired"]
    assert len(exp) == 1
    assert exp[0]["miss_s"] > 0 and 0 < exp[0]["folded"] < 20000


def test_deadline_expired_in_queue_is_cancelled_before_dispatch(fx,
                                                                tmp_path):
    srv = port_server(tmp_path, start=False, clock=StepClock())
    register(srv, fx)
    h = srv.submit("a", "d", "t", n_perm=32, seed=3, deadline_s=0.0)
    srv.start()
    with pytest.raises(tserve.ServeError, match="deadline exceeded"):
        srv.wait(h, timeout=600)
    srv.close()
    ev = read_events(str(tmp_path / "tel.jsonl"))
    exp = [e for e in ev if e["ev"] == "request_expired"]
    assert exp and exp[0]["data"]["folded"] == 0
    assert not any(e["ev"] == "request_packed" for e in ev)


def test_enforce_deadlines_off_keeps_the_sort_key_only(fx, tmp_path):
    srv = port_server(tmp_path, enforce_deadlines=False, clock=StepClock())
    register(srv, fx)
    try:
        res = srv.analyze("a", "d", "t", n_perm=32, seed=3, deadline_s=0.0,
                          timeout=600)
    finally:
        srv.close()
    assert res["completed"] == 32


# ---------------------------------------------------------------------------
# brownout and the bounded drain
# ---------------------------------------------------------------------------

def test_brownout_enter_shed_exit_equals_jax(fx, tmp_path):
    def run(server, tag):
        srv = server(tmp_path, start=False, tel=tag, brownout_enter_s=1.0,
                     brownout_rate_pps=10.0)
        srv.register_tenant("hi", weight=2)
        srv.register_tenant("lo", weight=1)
        register(srv, fx, ("hi", "lo"))
        h1 = srv.submit("hi", "d", "t", n_perm=64, seed=1)
        browned = srv.stats()["brownout"]
        with pytest.raises(Exception) as exc:
            srv.submit("lo", "d", "t", n_perm=64, seed=2)
        h2 = srv.submit("hi", "d", "t", n_perm=64, seed=3)
        srv.start()
        try:
            res = [srv.wait(h, timeout=600) for h in (h1, h2)]
            st = srv.stats()
        finally:
            srv.close()
        ev = read_events(str(tmp_path / f"{tag}.jsonl"))
        return (browned, type(exc.value).__name__, str(exc.value),
                exc.value.retry_after_s, st["brownout"],
                st["tenants"]["lo"]["rejected"],
                [e["ev"] for e in ev if e["ev"].startswith("serve_brownout")],
                [e["data"]["reason"] for e in ev
                 if e["ev"] == "request_rejected"]), res

    want, wres = run(jax_server, "jtel")
    got, gres = run(port_server, "tel")
    assert got == want
    assert got[0] is True and got[3] > 0 and got[4] is False
    assert got[6] == ["serve_brownout_enter", "serve_brownout_exit"]
    for g, w in zip(gres, wres):
        assert_counts(g, w)


def test_brownout_off_by_default(fx, tmp_path):
    srv = port_server(tmp_path, start=False)
    register(srv, fx)
    for i in range(4):
        srv.submit("a", "d", "t", n_perm=64, seed=i)
    assert srv.stats()["brownout"] is False
    srv.close(drain=False)


def test_drain_timeout_journals_remainder_for_restart(fx, tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    srv = port_server(tmp_path, start=False, journal=jpath)
    register(srv, fx)
    h = srv.submit("a", "d", "t", n_perm=32, seed=3, idempotency_key="K")
    srv.close(drain=True, timeout=0.05)   # no worker: nothing drains
    assert srv._last_drain_requeued == 1 and h.requeued_on_drain
    with pytest.raises(tserve.ServeError, match="journaled as requeued"):
        srv.wait(h, timeout=1)
    state = tjnl.scan(jpath)
    assert [r["key"] for r in state["pending"]] == ["K"]
    assert state["n_drain_requeued"] == 1
    srv2 = port_server(tmp_path, journal=jpath, recover=True, tel="tel2")
    try:
        res = srv2.analyze("a", "d", "t", n_perm=32, seed=3,
                           idempotency_key="K", timeout=600)
    finally:
        srv2.close()
    assert np.array_equal(res["p_values"], solo(fx, n_perm=32,
                                                seed=3).p_values)
    hi, _lo, _eff = tpv.tail_counts(*(lambda r: (r.observed,
                                                 r.nulls[:r.completed]))(
        solo(fx, n_perm=32, seed=3)))
    assert np.array_equal(res["counts_hi"], hi)


def test_preload_warms_the_pool_after_recovery(fx, tmp_path):
    """A recovering boot builds the pooled engine of its registered pair
    before any request (the kernels load on a card), so the first
    request of the full module set is a pool hit."""
    jpath = str(tmp_path / "j.jsonl")
    srv = port_server(tmp_path, journal=jpath)
    register(srv, fx)
    srv.close()
    srv2 = port_server(tmp_path, journal=jpath, recover=True, tel="tel2",
                       default_n_perm=32)
    try:
        srv2._preload_thread.join(timeout=300)
        assert srv2.stats()["pool"]["size"] == 1
        res = srv2.analyze("a", "d", "t", seed=4, timeout=600)
    finally:
        srv2.close()
    assert res["pool_hit"] is True and res["completed"] == 32
    assert np.array_equal(res["p_values"], solo(fx, n_perm=32,
                                                seed=4).p_values)
