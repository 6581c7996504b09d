"""The port's serving fleet (``netrep_tpu_torch.serve.fleet``) against the
JAX package's, on the CPU, and against the port's own solo calls.

Held: the hash ring's routes and successors equal the JAX ring's for the
same members and keys (and its leave/join stability); the lifecycle's
legal-move table equals ``netrep_tpu.serve.lifecycle.LEGAL_TRANSITIONS``;
the same dataset pair routes to the same replica id in both packages'
fleets; every fleet-served request has the p-values, counts and
``n_perm_used`` of the JAX fleet's result and of the port's solo call —
through replica-kill failover (the peer adopts the shipped journal, three
requests re-queued without registering the peer's datasets again, the
pack resumed at the crashed boundary, the dead replica's pool released),
the eviction handoff (no failover events, zero
recomputed) and scale to zero; dedup across failover never recomputes;
fleet-wide admission sheds from the aggregate estimate, with the rate from
the config or the perf ledger; the autoscaler's up/down/cooldown
decisions under ``tick(now=)``; ``dispatch_fleet_op``; ``stats()``, the
``top`` replica table and the ``replica_summary``/``render_replicas``
readers equal the JAX package's on the same stats and event files.

No test orders work by sleeping: servers are built with
``start_servers=False`` so queues fill before a worker starts, a
``crash`` plan kills a worker mid-pack and the test joins it, and
``kill_replica`` detects the death at once (the health loop's heartbeat is
an hour, except where the loop itself is under test). The fixture is
``tests/test_serve_fleet.py``'s: ``make_mixed_pair(100, 3, n_samples=16,
seed=7)``, chunk 16, a checkpoint every 16 permutations."""

import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from netrep_tpu import serve as jserve  # noqa: E402
from netrep_tpu.data import make_mixed_pair  # noqa: E402
from netrep_tpu.serve import fleet as jfleet  # noqa: E402
from netrep_tpu.serve import lifecycle as jlc  # noqa: E402
from netrep_tpu.serve import top as jtop  # noqa: E402
from netrep_tpu.utils import telemetry as jtm  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch import serve as tserve  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402
from netrep_tpu_torch.serve import fleet as tfleet  # noqa: E402
from netrep_tpu_torch.serve import journal as tjnl  # noqa: E402
from netrep_tpu_torch.serve import lifecycle as tlc  # noqa: E402
from netrep_tpu_torch.serve import top as ttop  # noqa: E402
from netrep_tpu_torch.serve.protocol import decode_arrays  # noqa: E402
from netrep_tpu_torch.utils import perfledger as tpl  # noqa: E402
from netrep_tpu_torch.utils import telemetry as ttm  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402
from netrep_tpu_torch.utils.config import FaultPolicy  # noqa: E402

CFG = EngineConfig(chunk_size=16)
JCFG = JConfig(chunk_size=16, autotune=False)
#: observed statistics: JAX vs port (ROADMAP.md Queue 3); served vs solo
#: exactly
JAX_TOL = 1e-4
SUBMITS = [
    ("k1", dict(n_perm=64, seed=3)),
    ("k2", dict(n_perm=64, seed=5)),
    ("k3", dict(n_perm=32, seed=11, adaptive=True)),
]
CRASH = dict(plan="crash@24", backoff_base_s=0.0, backoff_jitter=0.0)
HOUR = 3600.0


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


def read_events(path):
    return [json.loads(line) for line in open(path, encoding="utf-8")]


def port_config(tmp_path, prefix=""):
    """The per-replica ``make_config`` of the port's fleets (and of the
    autoscaler's spawner): journaled, the shared checkpoint directory,
    ``fleet_label``, on the CPU."""
    def mk(rid, jpath, ckpt):
        return tserve.ServeConfig(
            engine=CFG, journal=jpath, checkpoint_dir=ckpt,
            checkpoint_every=16, fleet_label=rid, device="cpu",
            telemetry=str(tmp_path / f"{prefix}{rid}_tel.jsonl"))
    return mk


def register(fleet, fx):
    fleet.register_dataset("a", "d", network=fx["dn"], correlation=fx["dc"],
                           data=fx["dd"], assignments=fx["assign"])
    fleet.register_dataset("a", "t", network=fx["tn"], correlation=fx["tc"],
                           data=fx["td"])


def port_fleet(fx, tmp_path, n=2, *, heartbeat_s=HOUR, start_servers=True,
               fleet_kw=None):
    fleet = tserve.build_inprocess_fleet(
        n, str(tmp_path / "fleet"), make_config=port_config(tmp_path),
        fleet_config=tserve.FleetConfig(
            telemetry=str(tmp_path / "coord.jsonl"),
            heartbeat_s=heartbeat_s, **(fleet_kw or {})),
        start_servers=start_servers)
    register(fleet, fx)
    return fleet


def jax_fleet(fx, tmp_path, n=2, *, start_servers=True, fleet_kw=None):
    def mk(rid, jpath, ckpt):
        return jserve.ServeConfig(engine=JCFG, journal=jpath,
                                  checkpoint_dir=ckpt, checkpoint_every=16,
                                  fleet_label=rid)

    fleet = jserve.build_inprocess_fleet(
        n, str(tmp_path / "jfleet"), make_config=mk,
        fleet_config=jserve.FleetConfig(
            telemetry=str(tmp_path / "jcoord.jsonl"), heartbeat_s=HOUR,
            **(fleet_kw or {})),
        start_servers=start_servers)
    register(fleet, fx)
    return fleet


def solo(fx, **kw):
    return module_preservation(
        network={"d": fx["dn"], "t": fx["tn"]},
        correlation={"d": fx["dc"], "t": fx["tc"]},
        data={"d": fx["dd"], "t": fx["td"]},
        module_assignments=fx["assign"], discovery="d", test="t",
        config=CFG, simplify=False, device="cpu", **kw)["d"]["t"]


def assert_jax(got, want):
    """Against the JAX fleet's result: equal p-values, counts and
    permutation counts; observed within the Queue 3 bound."""
    for f in ("p_values", "counts_hi", "counts_lo", "counts_eff"):
        assert np.array_equal(np.asarray(got[f]), np.asarray(want[f])), f
    assert got["completed"] == want["completed"]
    if want["n_perm_used"] is None:
        assert got["n_perm_used"] is None
    else:
        assert np.array_equal(got["n_perm_used"], want["n_perm_used"])
    assert np.abs(np.asarray(got["observed"], dtype=np.float64)
                  - np.asarray(want["observed"])).max() <= JAX_TOL


def assert_solo(got, ref):
    """Against the port's solo ``module_preservation`` call, bit for
    bit."""
    assert np.array_equal(got["p_values"], ref.p_values)
    hi, lo, eff = tpv.tail_counts(ref.observed, ref.nulls[:ref.completed])
    assert np.array_equal(got["counts_hi"], hi)
    assert np.array_equal(got["counts_lo"], lo)
    assert np.array_equal(got["counts_eff"], eff)
    if ref.n_perm_used is None:
        assert got["n_perm_used"] is None
    else:
        assert np.array_equal(got["n_perm_used"], ref.n_perm_used)
    assert np.array_equal(got["observed"], ref.observed)


@pytest.fixture(scope="module")
def jax_ref(fx, tmp_path_factory):
    """The SUBMITS through an undisturbed two-replica JAX fleet, queued on
    the home replica before its worker starts: ``(home rid, {key:
    result})``."""
    tmp = tmp_path_factory.mktemp("jax_ref")
    fleet = jax_fleet(fx, tmp, start_servers=False)
    try:
        home = fleet.route("a", "d", "t")
        hs = {k: home.server.submit("a", "d", "t", idempotency_key=k, **kw)
              for k, kw in SUBMITS}
        home.server.start()
        return home.rid, {k: home.server.wait(h, timeout=600)
                          for k, h in hs.items()}
    finally:
        fleet.close()


@pytest.fixture(scope="module")
def solos(fx):
    return {k: solo(fx, **kw) for k, kw in SUBMITS}


# ---------------------------------------------------------------------------
# the ring and the lifecycle table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vnodes", (8, 64))
@pytest.mark.parametrize("members", (("r0", "r1"), ("r0", "r1", "r2"),
                                     ("r3", "r10", "r2.g1", "r7")))
def test_hash_ring_equals_jax(vnodes, members):
    """Routes and successors equal the JAX ring's for the same members
    and keys; a leave moves only the leaver's keys and a re-join restores
    the placement exactly."""
    ring, jring = tfleet.HashRing(vnodes), jfleet.HashRing(vnodes)
    for rid in members:
        ring.add(rid)
        jring.add(rid)
    keys = [f"digest-{i}" for i in range(1000)] + ["a|b", "", "x" * 300]
    before = {k: ring.route(k) for k in keys}
    assert before == {k: jring.route(k) for k in keys}
    assert set(before.values()) == set(members)
    for rid in members:
        assert ring.successor(rid) == jring.successor(rid)
        assert ring.successor(rid) != rid
    leaver = members[1]
    ring.remove(leaver)
    jring.remove(leaver)
    after = {k: ring.route(k) for k in keys}
    assert after == {k: jring.route(k) for k in keys}
    for k in keys:
        if before[k] != leaver:
            assert after[k] == before[k]
    ring.add(leaver)
    assert {k: ring.route(k) for k in keys} == before
    assert ring.members() == set(members)
    assert tfleet.HashRing().route("k") is None
    assert tfleet.HashRing().successor("r0") is None


def test_lifecycle_table_equals_jax(tmp_path):
    """The legal-move table equals the JAX package's exactly; every other
    ordered pair raises and leaves the state; ``dead → spawning`` bumps the
    generation; each transition emits one ``replica_state`` event."""
    assert tlc.STATES == jlc.STATES
    assert tlc.LEGAL_TRANSITIONS == jlc.LEGAL_TRANSITIONS
    assert len(tlc.LEGAL_TRANSITIONS) == 6
    for prev in tlc.STATES:
        for to in tlc.STATES:
            cycle = tlc.ReplicaLifecycle("rX")
            cycle._state = prev
            if (prev, to) in tlc.LEGAL_TRANSITIONS:
                assert cycle.transition(to, reason="pin") == to
                assert cycle.state == to
            else:
                with pytest.raises(tlc.IllegalTransition):
                    cycle.transition(to, reason="pin")
                assert cycle.state == prev
    with pytest.raises(tlc.IllegalTransition):
        tlc.ReplicaLifecycle("rX").transition("zombie")

    tel = ttm.Telemetry(str(tmp_path / "tel.jsonl"))
    cycle = tlc.ReplicaLifecycle("r9", telemetry=tel)
    cycle.transition("ready", reason="join")
    cycle.transition("dead", reason="lost")
    cycle.transition("spawning", reason="respawn")
    assert cycle.generation == 1
    tel.close()
    ev = [e for e in read_events(str(tmp_path / "tel.jsonl"))
          if e["ev"] == "replica_state"]
    assert [(e["data"]["prev"], e["data"]["to"], e["data"]["gen"],
             e["data"]["reason"], e["data"]["replica"]) for e in ev] == [
        ("spawning", "ready", 0, "join", "r9"),
        ("ready", "dead", 0, "lost", "r9"),
        ("dead", "spawning", 1, "respawn", "r9"),
    ]


# ---------------------------------------------------------------------------
# routing and equality, undisturbed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", [k for k, _ in SUBMITS])
def test_fleet_routes_as_jax_and_serves_equal(fx, tmp_path, jax_ref, solos,
                                              key):
    """The same pair lands on the same replica id as in the JAX fleet (the
    ring hashes the JAX-equal content digests); the served result equals
    the JAX fleet's and the solo call's; a repeat is a pool hit on the
    same replica; ``top`` renders the fleet's stats as the JAX package
    does."""
    kw = dict(SUBMITS)[key]
    fleet = port_fleet(fx, tmp_path)
    try:
        home = fleet.route("a", "d", "t")
        assert home is fleet.route("a", "d", "t")
        assert home.rid == jax_ref[0]
        res =fleet.analyze("a", "d", "t", timeout=600, **kw)
        again = fleet.analyze("a", "d", "t", timeout=600, **kw)
        st = fleet.stats()
    finally:
        fleet.close()
    assert_jax(res, jax_ref[1][key])
    assert_solo(res, solos[key])
    assert again["pool_hit"] and not res["pool_hit"]
    assert np.array_equal(again["p_values"], res["p_values"])
    served_on = [rid for rid, row in st["replicas"].items() if row["packs"]]
    assert served_on == [home.rid]
    assert st["replicas"][home.rid]["done"] == 2
    assert all("utilisation" not in row for row in st["replicas"].values())
    assert ttop.snapshot(st) == jtop.snapshot(st)
    assert ttop.render(ttop.snapshot(st)) == jtop.render(jtop.snapshot(st))
    assert "r0" in ttop.render(ttop.snapshot(st))


def test_route_keys_equal_jax_for_every_pair(fx, tmp_path):
    """Both directions and a multi-test key route to the same replica id
    in both packages' fleets (three replicas)."""
    fleet = port_fleet(fx, tmp_path, n=3, start_servers=False)
    jf = jax_fleet(fx, tmp_path, n=3, start_servers=False)
    try:
        for d, t in (("d", "t"), ("t", "d"), ("d", ["t", "t"])):
            assert fleet._route_key("a", d, t) == jf._route_key("a", d, t)
            assert fleet.route("a", d, t).rid == jf.route("a", d, t).rid
    finally:
        fleet.close(drain=False)
        jf.close(drain=False)


# ---------------------------------------------------------------------------
# replica-kill failover
# ---------------------------------------------------------------------------

def test_replica_kill_failover_bit_parity(fx, tmp_path, jax_ref, solos):
    """A crash plan kills the home replica's worker mid-pack (the three
    requests queued before it started); ``kill_replica`` fails its shipped
    journal over to the peer, which re-queues all three and resumes the
    pack at the crashed boundary from the SHARED checkpoint directory.
    Every request equals the JAX fleet's and the solo call; a client that
    was waiting through ``dispatch_fleet_op`` re-routes under its key; the
    dead replica's pool is given back."""
    fleet = port_fleet(fx, tmp_path, start_servers=False)
    try:
        home = fleet.route("a", "d", "t")
        peer = [r for rid, r in fleet.live_replicas().items()
                if rid != home.rid][0]
        home.arm_fault_plan(FaultPolicy(**CRASH))
        for k, kw in SUBMITS:
            home.server.submit("a", "d", "t", idempotency_key=k, **kw)
        home.server.start()
        home.server._worker.join(timeout=300)
        assert not home.server._worker.is_alive(), "crash never fired"
        wire = {}
        waiter = threading.Thread(target=lambda: wire.update(
            tfleet.dispatch_fleet_op(fleet, {
                "op": "analyze", "tenant": "a", "discovery": "d",
                "test": "t", "idempotency_key": "k1", "timeout": 600,
                **SUBMITS[0][1]}, threading.Event())), daemon=True)
        waiter.start()
        fleet.kill_replica(home.rid)
        assert home.server.pool.stats()["size"] == 0
        assert not home.alive() and home.dead.is_set()
        peer.server.start()
        got = {k: fleet.analyze("a", "d", "t", idempotency_key=k,
                                timeout=600, **kw) for k, kw in SUBMITS}
        waiter.join(timeout=600)
        assert not waiter.is_alive()
        st = fleet.stats()
    finally:
        fleet.close()
    for k, _kw in SUBMITS:
        assert_jax(got[k], jax_ref[1][k])
        assert_solo(got[k], solos[k])
    assert wire["ok"], wire
    assert np.array_equal(decode_arrays(wire["result"])["p_values"],
                          got["k1"]["p_values"])
    row = st["replicas"][home.rid]
    assert row == {"alive": False, "state": "dead", "gen": 0}
    assert st["replicas"][peer.rid]["done"] == 3
    assert st["ring"] == [peer.rid]

    coord = str(tmp_path / "coord.jsonl")
    ev = read_events(coord)
    fo = [e for e in ev if e["ev"] in
          ("replica_lost", "failover_start", "failover_done",
           "ring_rebalanced") and e["data"].get("reason") != "join"]
    assert [e["ev"] for e in fo] == [
        "replica_lost", "failover_start", "failover_done",
        "ring_rebalanced"]
    done = fo[2]["data"]
    assert done["replica"] == home.rid and done["peer"] == peer.rid
    assert done["s"] > 0 and done["requeued"] == 3
    pe = read_events(str(tmp_path / f"{peer.rid}_tel.jsonl"))
    replay = [e["data"] for e in pe if e["ev"] == "journal_replayed"]
    assert replay[0]["adopted"] is True and replay[0]["requeued"] == 3
    assert replay[0]["datasets"] == 2
    # the peer held both datasets (the broadcast registered them): the
    # adoption re-queued the requests without registering them again
    assert [r["name"] for r in tjnl.read_records(peer.journal_path)
            if r["kind"] == "dataset"] == ["d", "t"]
    # the crash fires at the dispatch of the chunk holding permutation 24:
    # the failure-save wrote that chunk's boundary
    resumed = [e["data"]["completed"] for e in pe
               if e["ev"] == "checkpoint_resumed"]
    assert resumed == [16]
    # the offline readers equal the JAX package's on the same file
    assert ttm.render_recovery(coord) == jtm.render_recovery(coord)
    assert ttm.replica_summary(read_events(coord)) == \
        jtm.replica_summary(read_events(coord))
    section = ttm.render_replicas(coord)
    assert section == jtm.render_replicas(coord)
    assert home.rid in section and "failover" in section
    summary = ttm.replica_summary(read_events(coord))
    assert summary[home.rid]["failovers"] == 1
    assert summary[home.rid]["state"] == "dead"


def test_dedup_across_failover_never_recomputes(fx, tmp_path):
    """A request completed before its replica died answers from the
    shipped journal on the peer: same numbers, no pack on the peer. The
    health loop (a short heartbeat here) detects the closed server."""
    fleet = port_fleet(fx, tmp_path, heartbeat_s=0.05)
    try:
        home = fleet.route("a", "d", "t")
        peer_rid = [r for r in fleet.live_replicas() if r != home.rid][0]
        r1 = fleet.analyze("a", "d", "t", n_perm=32, seed=3,
                           idempotency_key="K", timeout=600)
        home.server.close(drain=True)
        assert fleet.await_failover(home.rid, timeout=60)
        r2 = fleet.analyze("a", "d", "t", n_perm=32, seed=3,
                           idempotency_key="K", timeout=60)
        st = fleet.stats()
    finally:
        fleet.close()
    for f in ("p_values", "counts_hi", "counts_lo", "counts_eff",
              "observed"):
        assert np.array_equal(np.asarray(r1[f]), np.asarray(r2[f])), f
    assert st["replicas"][peer_rid]["packs"] == 0
    assert st["tenants"]["a"]["deduped"] >= 1


# ---------------------------------------------------------------------------
# fleet-wide admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate_from", ("config", "ledger"))
def test_fleet_admission_sheds_from_aggregate_estimate(
        fx, tmp_path, monkeypatch, rate_from):
    """The shed decision reads the AGGREGATE backlog over the summed
    rates — configured, or the perf ledger's serve history (the median of
    its last eight serve/run entries) — and answers with the drain-time
    hint; the JAX fleet estimates the same."""
    ledger = str(tmp_path / "ledger.jsonl")
    monkeypatch.setenv(tpl.LEDGER_ENV, ledger)
    kw = dict(brownout_enter_s=1.0)
    if rate_from == "config":
        kw["rate_pps"] = 10.0
    else:
        for pps, source in ((99.0, "bench"), (8.0, "serve"), (10.0, "run"),
                            (12.0, "serve")):
            tpl.append_entry(tpl.make_entry("fp", pps, source,
                                            backend="cpu", t=0.0), ledger)
    fleet = port_fleet(fx, tmp_path, start_servers=False, fleet_kw=kw)
    jf = jax_fleet(fx, tmp_path, start_servers=False, fleet_kw=kw)
    try:
        for f in (fleet, jf):
            home = f.route("a", "d", "t")
            for i in range(2):
                home.server.submit("a", "d", "t", n_perm=64, seed=i)
        est = fleet.drain_estimate()
        assert est == pytest.approx(128 / 20.0)
        assert jf.drain_estimate() == pytest.approx(est)
        with fleet._lock:
            assert fleet._fallback_rate_locked() == 10.0
        with pytest.raises(tserve.QueueFull) as exc:
            fleet.analyze("a", "d", "t", n_perm=64, seed=9, timeout=5)
        assert exc.value.retry_after_s == pytest.approx(
            (128 + 64) / 20.0, abs=1e-3)
        if rate_from == "ledger":
            assert all(r["rate_pps"] == 10.0
                       for r in fleet.stats()["replicas"].values())
    finally:
        fleet.close(drain=False)
        jf.close(drain=False)
    ev = read_events(str(tmp_path / "coord.jsonl"))
    enter = [e["data"] for e in ev if e["ev"] == "serve_brownout_enter"]
    assert enter and enter[0]["fleet"] is True
    assert enter[0]["est_drain_s"] > 1.0


# ---------------------------------------------------------------------------
# autoscaling, scale to zero, eviction
# ---------------------------------------------------------------------------

def test_autoscaler_up_down_cooldown_under_injected_clock(fx, tmp_path):
    """Tick by tick on an injected clock (workers never start): backlog
    above the drain threshold scales up to ``max_replicas`` with the
    cooldown between actions; an idle fleet retires one replica a
    cooldown window, newest first, down to zero, leaving
    ``last_journal``."""
    fleet = port_fleet(fx, tmp_path, n=1, start_servers=False,
                       fleet_kw=dict(rate_pps=10.0))
    clk = {"t": 0.0}
    spawn = tserve.inprocess_spawner(str(tmp_path / "fleet"),
                                     make_config=port_config(tmp_path),
                                     start_servers=False)
    scaler = tserve.Autoscaler(
        fleet, spawn,
        tserve.AutoscaleConfig(scale_up_drain_s=10.0, scale_down_idle_s=10.0,
                               min_replicas=0, max_replicas=3,
                               cooldown_s=2.0),
        clock=lambda: clk["t"], start=False)
    assert fleet.autoscaler is scaler
    try:
        home = fleet.route("a", "d", "t")
        assert home.rid == "r0"
        for i in range(3):
            home.server.submit("a", "d", "t", n_perm=256, seed=i)
        # 768 queued permutations / 10 per s = 76.8 s: scale up
        assert scaler.tick(now=0.0) == "up"
        assert sorted(fleet.live_replicas()) == ["r0", "r1"]
        # the newcomer adopted the registrations before it joined
        assert set(fleet.live_replicas()["r1"].server._tenants["a"]
                   .datasets) == {"d", "t"}
        assert scaler.tick(now=1.0) is None          # cooldown
        clk["t"] = 3.0
        assert scaler.tick(now=3.0) == "up"
        assert sorted(fleet.live_replicas()) == ["r0", "r1", "r2"]
        clk["t"] = 6.0
        assert scaler.tick(now=6.0) is None          # at max_replicas
        with home.server._work:
            for t in home.server._tenants.values():
                t.pending.clear()
        clk["t"] = 7.0
        assert scaler.tick(now=7.0) is None          # idle periods begin
        for now, left in ((17.0, ["r0", "r1"]), (20.0, ["r0"]),
                          (23.0, [])):
            clk["t"] = now
            assert scaler.tick(now=now) == "down"
            assert sorted(fleet.live_replicas()) == left
            if now == 17.0:
                clk["t"] = 18.0
                assert scaler.tick(now=18.0) is None   # cooldown again
        assert fleet.last_journal and os.path.exists(fleet.last_journal)
        st = fleet.stats()
    finally:
        fleet.close(drain=False)
    assert all(row["alive"] is False and row["state"] == "dead"
               for row in st["replicas"].values())
    ev = read_events(str(tmp_path / "coord.jsonl"))
    ups = [e["data"] for e in ev if e["ev"] == "autoscale_up"]
    downs = [e["data"] for e in ev if e["ev"] == "autoscale_down"]
    assert [u["replica"] for u in ups] == ["r1", "r2"]
    assert all(u["reason"] == "backlog" and u["est_drain_s"] > 10.0
               for u in ups)
    assert [d["replica"] for d in downs] == ["r2", "r1", "r0"]
    assert [d["replicas"] for d in downs] == [2, 1, 0]
    zero = [e["data"] for e in ev if e["ev"] == "scale_to_zero"]
    assert len(zero) == 1 and zero[0]["journal"] == fleet.last_journal
    assert [(e["data"]["prev"], e["data"]["to"], e["data"]["reason"])
            for e in ev if e["ev"] == "replica_state"
            and e["data"]["replica"] == "r2"] == [
        ("spawning", "ready", "join"), ("ready", "draining", "retire"),
        ("draining", "dead", "drained")]


def test_scale_to_zero_round_trip_equal(fx, tmp_path, jax_ref, solos):
    """Retire the last replica, then submit against the EMPTY fleet: the
    autoscaler spawns on demand, the newcomer adopts the last drained
    replica's journal copy, a duplicate answers from it with no pack, and
    a fresh key computes the JAX fleet's and its solo call's numbers."""
    fleet = port_fleet(fx, tmp_path, n=1)
    spawn = tserve.inprocess_spawner(str(tmp_path / "fleet"),
                                     make_config=port_config(tmp_path))
    tserve.Autoscaler(fleet, spawn,
                      tserve.AutoscaleConfig(min_replicas=0, max_replicas=2,
                                             cooldown_s=0.0), start=False)
    k, kw = SUBMITS[0]
    try:
        r1 = fleet.analyze("a", "d", "t", idempotency_key=k, timeout=600,
                           **kw)
        out = fleet.retire_replica("r0")
        assert out["replica"] == "r0" and out["peer"] is None
        assert fleet.live_replicas() == {}
        r2 = fleet.analyze("a", "d", "t", idempotency_key=k, timeout=600,
                           **kw)
        st = fleet.stats()
        k3, kw3 = SUBMITS[2]
        fresh = fleet.analyze("a", "d", "t", idempotency_key=k3,
                              timeout=600, **kw3)
    finally:
        fleet.close()
    assert_solo(r1, solos[k])
    assert_jax(r1, jax_ref[1][k])
    for f in ("p_values", "counts_hi", "counts_lo", "counts_eff"):
        assert np.array_equal(np.asarray(r1[f]), np.asarray(r2[f])), f
    assert sorted(st["replicas"]) == ["r0", "r1"]
    assert st["replicas"]["r0"]["state"] == "dead"
    assert st["replicas"]["r1"]["alive"] and st["replicas"]["r1"]["packs"] == 0
    assert_solo(fresh, solos[k3])
    assert_jax(fresh, jax_ref[1][k3])
    ev = read_events(str(tmp_path / "coord.jsonl"))
    names = [e["ev"] for e in ev]
    assert "scale_to_zero" in names and "replica_lost" not in names
    sod = [e["data"] for e in ev if e["ev"] == "spawn_on_demand"]
    assert sod[0]["replica"] == "r1" and sod[0]["reason"] == "empty_fleet"


def test_evict_notice_mid_pack_handoff_zero_recompute(fx, tmp_path, jax_ref,
                                                      solos):
    """A crash plan stops the home replica mid-pack, then its eviction
    notice lands: ring removal, a bounded drain (grace 0: the queued
    request is journaled requeued), the tail pre-shipped, the peer
    adopts. All three requests equal the JAX fleet's and the solo call;
    the pack resumes at the crashed boundary; no failover event."""
    fleet = port_fleet(fx, tmp_path, start_servers=False)
    try:
        home = fleet.route("a", "d", "t")
        peer = [r for rid, r in fleet.live_replicas().items()
                if rid != home.rid][0]
        home.arm_fault_plan(FaultPolicy(**CRASH))
        for k, kw in SUBMITS:
            home.server.submit("a", "d", "t", idempotency_key=k, **kw)
        home.server.start()
        home.server._worker.join(timeout=300)
        assert not home.server._worker.is_alive(), "crash never fired"
        out = fleet.evict_notice(home.rid, grace_s=0.0)
        peer.server.start()
        got = {k: fleet.analyze("a", "d", "t", idempotency_key=k,
                                timeout=600, **kw) for k, kw in SUBMITS}
        st = fleet.stats()
    finally:
        fleet.close()
    assert out["replica"] == home.rid and out["peer"] == peer.rid
    assert out["s"] > 0 and out["requeued"] == 3 and out["results"] == 0
    for k, _kw in SUBMITS:
        assert_jax(got[k], jax_ref[1][k])
        assert_solo(got[k], solos[k])
    assert st["replicas"][home.rid]["state"] == "dead"
    assert st["replicas"][peer.rid]["done"] == 3
    coord = str(tmp_path / "coord.jsonl")
    ev = read_events(coord)
    names = [e["ev"] for e in ev]
    assert not {"replica_lost", "failover_start", "failover_done"} \
        & set(names)
    done = [e["data"] for e in ev if e["ev"] == "evict_handoff_done"]
    assert done[0]["peer"] == peer.rid and done[0]["requeued"] == 3
    assert [(e["data"]["to"], e["data"]["reason"]) for e in ev
            if e["ev"] == "replica_state"
            and e["data"]["replica"] == home.rid][-2:] == [
        ("draining", "evict"), ("dead", "drained")]
    pe = read_events(str(tmp_path / f"{peer.rid}_tel.jsonl"))
    assert [e["data"]["completed"] for e in pe
            if e["ev"] == "checkpoint_resumed"] == [16]
    assert ttm.render_replicas(coord) == jtm.render_replicas(coord)
    assert ttm.render_recovery(coord) == jtm.render_recovery(coord)
    assert "evict" in ttm.render_replicas(coord)


# ---------------------------------------------------------------------------
# the op vocabulary
# ---------------------------------------------------------------------------

def test_dispatch_fleet_op(fx, tmp_path, solos):
    """The fleet's op vocabulary in process: ``ping``/``stats``/
    ``metrics``, a broadcast ``register`` whose digest the ring routes on
    (the JAX fleet's digest), a proxied ``analyze`` equal to the solo
    call, ``evict_notice`` with its receipt, malformed and unknown ops
    answered as the JAX coordinator answers them, ``shutdown``."""
    fleet = tserve.build_inprocess_fleet(
        2, str(tmp_path / "fleet"), make_config=port_config(tmp_path),
        fleet_config=tserve.FleetConfig(heartbeat_s=HOUR))
    jf = jax_fleet(fx, tmp_path, start_servers=False)
    stop = threading.Event()
    try:
        op = tfleet.dispatch_fleet_op
        assert op(fleet, {"op": "ping"}, stop) == jfleet.dispatch_fleet_op(
            jf, {"op": "ping"}, stop)
        for bad in (["not", "a", "dict"], {"op": "frobnicate"}):
            assert op(fleet, bad, stop) == jfleet.dispatch_fleet_op(
                jf, bad, stop)
        for name, mats, assign in (
                ("d", ("dn", "dc", "dd"), fx["assign"]),
                ("t", ("tn", "tc", "td"), None)):
            resp = op(fleet, {
                "op": "register", "tenant": "a", "name": name,
                "network": fx[mats[0]].tolist(),
                "correlation": fx[mats[1]].tolist(),
                "data": fx[mats[2]].tolist(), "assignments": assign}, stop)
            assert resp["ok"] and resp["digest"] == jf._digests[("a", name)]
            assert fleet._digests[("a", name)] == resp["digest"]
        assert all(set(r.server._tenants["a"].datasets) == {"d", "t"}
                   for r in fleet.live_replicas().values())
        k, kw = SUBMITS[0]
        resp = op(fleet, {"op": "analyze", "tenant": "a", "discovery": "d",
                          "test": "t", "idempotency_key": k, **kw}, stop)
        assert resp["ok"], resp
        assert_solo(decode_arrays(resp["result"]), solos[k])
        home = fleet.route("a", "d", "t").rid
        st = op(fleet, {"op": "stats"}, stop)["stats"]
        assert st["fleet"] and st["replicas"][home]["done"] == 1
        text = op(fleet, {"op": "metrics"}, stop)["text"]
        assert "# fleet replica r0" in text and "# fleet replica r1" in text
        assert op(fleet, {"op": "evict_notice", "replica": "r9"},
                  stop)["ok"] is False
        ev = op(fleet, {"op": "evict_notice", "replica": home,
                        "grace_s": 5}, stop)
        assert ev["ok"] and ev["evicted"] == home and ev["results"] == 1
        # the duplicate answers on the survivor from the adopted journal
        again = op(fleet, {"op": "analyze", "tenant": "a", "discovery": "d",
                           "test": "t", "idempotency_key": k, **kw}, stop)
        assert again["ok"]
        assert again["result"]["p_values"] == resp["result"]["p_values"]
        assert fleet.route("a", "d", "t").rid != home
        assert op(fleet, {"op": "shutdown"}, stop) == {"ok": True,
                                                       "draining": True}
        assert stop.is_set()
    finally:
        fleet.close()
        jf.close(drain=False)


def test_stats_and_replica_table_equal_jax(fx, tmp_path):
    """``stats()`` rows carry the JAX package's keys less ``utilisation``;
    the replica table, ``snapshot`` and ``render`` equal the JAX
    package's on the same stats (the ``util`` column reads ``-``)."""
    fleet = port_fleet(fx, tmp_path, n=3, start_servers=False)
    jf = jax_fleet(fx, tmp_path, n=3, start_servers=False)
    try:
        for f in (fleet, jf):
            f.route("a", "d", "t").server.submit("a", "d", "t", n_perm=32,
                                                 seed=1)
        st, jst = fleet.stats(), jf.stats()
        fleet.kill_replica("r2")
        st_dead = fleet.stats()
    finally:
        fleet.close(drain=False)
        jf.close(drain=False)
    assert set(st) == set(jst)
    for rid, row in st["replicas"].items():
        assert set(row) == set(jst["replicas"][rid]) - {"utilisation"}
        assert row["backlog_perms"] == jst["replicas"][rid]["backlog_perms"]
        assert row["queue_depth"] == jst["replicas"][rid]["queue_depth"]
    assert st["ring"] == jst["ring"] == ["r0", "r1", "r2"]
    assert st_dead["replicas"]["r2"] == {"alive": False, "state": "dead",
                                         "gen": 0}
    for s in (st, st_dead, jst):
        snap = ttop.snapshot(s)
        assert snap == jtop.snapshot(s)
        assert ttop.render(snap) == jtop.render(snap)
        assert ttop.render_replica_table(snap["replicas"]) == \
            jtop.render_replica_table(snap["replicas"])
    frame = ttop.render(ttop.snapshot(st_dead))
    assert "netrep serve fleet" in frame and "DEAD" in frame
