"""The port's single server (``netrep_tpu_torch.serve``) against the JAX
package's on the same request streams, on the CPU, and against the port's
own solo calls.

Every request stream runs through the JAX ``PreservationServer`` and the
port's (``device="cpu"``) with the same fixture, engine chunk and seeds.
Held, per served result: the p-values, ``counts_hi/lo/eff``,
``n_perm_used``, ``completed``, module labels and pack composition equal
the JAX server's and the port's solo ``module_preservation`` call's
(fixed, adaptive, three requests sharing one pack, two tenants in one
pack, a cross-pair pack, a multi-test request, a data-only pair); observed
statistics within the Queue 3 bound of ROADMAP.md against JAX (1e-4) and
equal to the solo call's. Also: dataset digests equal across the packages; admission
(``QueueFull`` with ``retry_after_s``), the weighted round-robin order,
drain; a transient fault that recovers and a failed pack isolated per
request; cost conservation and trace contexts; ``metrics_text()`` series
names and labels; ``top.snapshot``/``render`` and
``tenant_summary``/``render_tenants`` equal to the JAX package's on the
same stats and event files. No test synchronises by sleeping: queues are
filled with ``start=False`` before the worker starts.

The fixture is ``tests/test_serve.py``'s: ``make_mixed_pair(100, 3,
n_samples=16, seed=7)``, chunk 16."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import netrep_tpu  # noqa: E402
from netrep_tpu import serve as jserve  # noqa: E402
from netrep_tpu.data import make_mixed_pair  # noqa: E402
from netrep_tpu.serve import protocol as jproto  # noqa: E402
from netrep_tpu.serve import top as jtop  # noqa: E402
from netrep_tpu.utils import telemetry as jtm  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu.utils.config import FaultPolicy as JPolicy  # noqa: E402
from netrep_tpu_torch import serve as tserve  # noqa: E402
from netrep_tpu_torch.models.atlas_api import (  # noqa: E402
    atlas_module_preservation,
)
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402
from netrep_tpu_torch.serve import pool as tpool  # noqa: E402
from netrep_tpu_torch.serve import protocol as tproto  # noqa: E402
from netrep_tpu_torch.serve import top as ttop  # noqa: E402
from netrep_tpu_torch.utils import telemetry as ttm  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402
from netrep_tpu_torch.utils.config import FaultPolicy  # noqa: E402

CFG = EngineConfig(chunk_size=16)
#: observed statistics: JAX vs port (ROADMAP.md Queue 3); pack vs solo
#: exactly (each request's rows are observed as its solo bucket)
JAX_TOL, SOLO_TOL = 1e-4, 0.0
COST_FIELDS = ("device_s", "transfer_s", "perms", "bytes_to_host",
               "compile_s_amortized")

JAX = dict(name="jax", Server=jserve.PreservationServer,
           Config=jserve.ServeConfig, Client=jserve.InProcessClient,
           QueueFull=jserve.QueueFull, ServeError=jserve.ServeError,
           engine=JConfig(chunk_size=16, autotune=False), extra={},
           Policy=JPolicy)
PORT = dict(name="port", Server=tserve.PreservationServer,
            Config=tserve.ServeConfig, Client=tserve.InProcessClient,
            QueueFull=tserve.QueueFull, ServeError=tserve.ServeError,
            engine=CFG, extra={"device": "cpu"}, Policy=FaultPolicy)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(seed):
    mixed = make_mixed_pair(100, 3, n_samples=16, seed=seed)
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    assign = {f"node_{i}": "0" for i in range(dn.shape[0])}
    for lab, idx in mixed["specs"]:
        for i in idx:
            assign[f"node_{i}"] = str(lab)
    return (dd, dc, dn), (td, tc, tn), assign


@pytest.fixture(scope="module")
def fx():
    (dd, dc, dn), (td, tc, tn), assign = _pair(7)
    return dict(dn=dn, dc=dc, dd=dd, tn=tn, tc=tc, td=td, assign=assign)


def make_server(pkg, fx, tmp_path, *, tenants=("a",), start=True,
                tel=True, **cfg_kw):
    cfg_kw.setdefault("engine", pkg["engine"])
    if tel:
        cfg_kw.setdefault("telemetry",
                          str(tmp_path / f"{pkg['name']}_tel.jsonl"))
    srv = pkg["Server"](pkg["Config"](**cfg_kw, **pkg["extra"]),
                        start=start)
    client = pkg["Client"](srv)
    for t in tenants:
        register(client, t, fx)
    return srv, client


def register(client, tenant, fx):
    client.register_dataset(tenant, "d", network=fx["dn"],
                            correlation=fx["dc"], data=fx["dd"],
                            assignments=fx["assign"])
    client.register_dataset(tenant, "t", network=fx["tn"],
                            correlation=fx["tc"], data=fx["td"])


def read_events(path):
    return [json.loads(line) for line in open(path, encoding="utf-8")]


def solo(fx, **kw):
    return module_preservation(
        network={"d": fx["dn"], "t": fx["tn"]},
        correlation={"d": fx["dc"], "t": fx["tc"]},
        data={"d": fx["dd"], "t": fx["td"]},
        module_assignments=fx["assign"], discovery="d", test="t",
        config=CFG, simplify=False, device="cpu", **kw)["d"]["t"]


def assert_same(got, want, tol):
    """Served result ``got`` against ``want`` (the JAX server's result
    dict): equal p-values, counts, permutation counts and labels."""
    for f in ("p_values", "counts_hi", "counts_lo", "counts_eff"):
        assert np.array_equal(np.asarray(got[f]), np.asarray(want[f])), f
    for f in ("completed", "n_perm", "p_type", "module_labels",
              "alternative", "seed", "total_space"):
        assert got[f] == want[f], f
    if want["n_perm_used"] is None:
        assert got["n_perm_used"] is None
    else:
        assert np.array_equal(got["n_perm_used"], want["n_perm_used"])
    assert np.abs(np.asarray(got["observed"])
                  - np.asarray(want["observed"])).max() <= tol


def assert_solo(got, ref):
    """Served result against the port's solo ``module_preservation``."""
    assert np.array_equal(got["p_values"], ref.p_values)
    hi, lo, eff = tpv.tail_counts(ref.observed, ref.nulls[:ref.completed])
    assert np.array_equal(got["counts_hi"], hi)
    assert np.array_equal(got["counts_lo"], lo)
    assert np.array_equal(got["counts_eff"], eff)
    if ref.n_perm_used is None:
        assert got["n_perm_used"] is None
    else:
        assert np.array_equal(got["n_perm_used"], ref.n_perm_used)
    assert got["module_labels"] == list(ref.module_labels)
    assert np.abs(got["observed"] - ref.observed).max() <= SOLO_TOL


def both(fn):
    """``fn(pkg)`` for the JAX package, then the port: ``(jax, port)``."""
    return fn(JAX), fn(PORT)


# ---------------------------------------------------------------------------
# served == JAX served == the port's solo call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alternative", ["greater", "two.sided"])
def test_served_fixed_matches_jax_and_solo(fx, tmp_path, alternative):
    def run(pkg):
        srv, client = make_server(pkg, fx, tmp_path)
        try:
            return client.analyze("a", "d", "t", n_perm=64, seed=3,
                                  alternative=alternative, timeout=600)
        finally:
            srv.close()

    want, got = both(run)
    assert_same(got, want, JAX_TOL)
    assert_solo(got, solo(fx, n_perm=64, seed=3, alternative=alternative))
    assert got["p_type"] == "fixed" and got["completed"] == 64
    assert got["pack_size"] == want["pack_size"] == 1


def test_served_adaptive_matches_jax_and_solo(fx, tmp_path):
    def run(pkg):
        srv, client = make_server(pkg, fx, tmp_path)
        try:
            return client.analyze("a", "d", "t", n_perm=96, seed=5,
                                  adaptive=True, timeout=600)
        finally:
            srv.close()

    want, got = both(run)
    assert_same(got, want, JAX_TOL)
    assert_solo(got, solo(fx, n_perm=96, seed=5, adaptive=True))
    assert got["p_type"] == "sequential"


REQUESTS = (dict(n_perm=64, seed=3), dict(n_perm=32, seed=11),
            dict(n_perm=64, seed=5, adaptive=True))


@pytest.mark.parametrize("stat_mode", ["auto", "xla"])
def test_concurrent_requests_share_one_pack(fx, tmp_path, stat_mode):
    """Three queued requests (seeds, budgets, one adaptive) run as a pack
    of two and a pack of one (powers of two) in both packages, each
    result equal to the JAX server's and to its solo call."""
    def run(pkg):
        engine = pkg["engine"]
        if pkg is PORT:
            engine = EngineConfig(chunk_size=16, stat_mode=stat_mode)
        srv, client = make_server(pkg, fx, tmp_path, start=False,
                                  engine=engine)
        hs = [client.submit("a", "d", "t", **kw) for kw in REQUESTS]
        srv.start()
        try:
            return [client.result(h, timeout=600) for h in hs]
        finally:
            srv.close()

    want, got = both(run)
    assert sorted(r["pack_size"] for r in got) == [1, 2, 2]
    assert [r["pack_id"] for r in got] == [r["pack_id"] for r in want]
    cfg = EngineConfig(chunk_size=16, stat_mode=stat_mode)
    for kw, g, w in zip(REQUESTS, got, want):
        assert_same(g, w, JAX_TOL)
        ref = module_preservation(
            network={"d": fx["dn"], "t": fx["tn"]},
            correlation={"d": fx["dc"], "t": fx["tc"]},
            data={"d": fx["dd"], "t": fx["td"]},
            module_assignments=fx["assign"], discovery="d", test="t",
            config=cfg, simplify=False, device="cpu", **kw)["d"]["t"]
        assert_solo(g, ref)


def test_batching_window_fills_the_pack(fx, tmp_path):
    """With the worker running, requests arriving one after another join
    the waiting pack until it is full: the window is waited out (or ends
    full), not ended by the first arrival."""
    srv, client = make_server(PORT, fx, tmp_path, pack_window_s=600.0,
                              max_pack=4)
    try:
        hs = [client.submit("a", "d", "t", n_perm=32, seed=s)
              for s in range(4)]
        res = [client.result(h, timeout=600) for h in hs]
    finally:
        srv.close()
    assert [r["pack_size"] for r in res] == [4] * 4
    assert len({r["pack_id"] for r in res}) == 1
    for r, s in zip(res, range(4)):
        assert_solo(r, solo(fx, n_perm=32, seed=s))


def test_cross_tenant_packing(fx, tmp_path):
    def run(pkg):
        srv, client = make_server(pkg, fx, tmp_path, tenants=("a", "b"),
                                  start=False)
        ha = client.submit("a", "d", "t", n_perm=32, seed=1)
        hb = client.submit("b", "d", "t", n_perm=32, seed=2)
        srv.start()
        try:
            return [client.result(h, timeout=600) for h in (ha, hb)]
        finally:
            srv.close()

    want, got = both(run)
    assert got[0]["pack_id"] == got[1]["pack_id"]
    assert got[0]["pack_size"] == 2
    for g, w, seed in zip(got, want, (1, 2)):
        assert_same(g, w, JAX_TOL)
        assert_solo(g, solo(fx, n_perm=32, seed=seed))
    packed = [e for e in read_events(str(tmp_path / "port_tel.jsonl"))
              if e["ev"] == "request_packed"]
    assert {e["data"]["tenant"] for e in packed} == {"a", "b"}
    assert len({e["data"]["pack"] for e in packed}) == 1


def test_cross_pair_packing(fx, tmp_path):
    """Two discovery cohorts tested in one test cohort share one grid
    pack under ``cross_pair_packing``; each result equals the JAX
    server's and its solo call."""
    (d2, c2, n2), _t, assign2 = _pair(9)

    def run(pkg):
        srv, client = make_server(pkg, fx, tmp_path, start=False,
                                  cross_pair_packing=True)
        client.register_dataset("a", "d2", network=n2, correlation=c2,
                                data=d2, assignments=assign2)
        ha = client.submit("a", "d", "t", n_perm=48, seed=4)
        hb = client.submit("a", "d2", "t", n_perm=32, seed=6)
        srv.start()
        try:
            return [client.result(h, timeout=600) for h in (ha, hb)]
        finally:
            srv.close()

    want, got = both(run)
    assert got[0]["pack_id"] == got[1]["pack_id"]
    assert got[0]["pack_size"] == want[0]["pack_size"] == 2
    for g, w in zip(got, want):
        assert_same(g, w, JAX_TOL)
    assert_solo(got[0], solo(fx, n_perm=48, seed=4))
    ref = module_preservation(
        network={"d2": n2, "t": fx["tn"]},
        correlation={"d2": c2, "t": fx["tc"]},
        data={"d2": d2, "t": fx["td"]}, module_assignments=assign2,
        discovery="d2", test="t", n_perm=32, seed=6, config=CFG,
        simplify=False, device="cpu")["d2"]["t"]
    assert_solo(got[1], ref)


def test_multi_test_request_matches_jax_and_vmap_tests(fx, tmp_path):
    _d, (t2d, t2c, t2n), _a = _pair(9)

    def run(pkg):
        srv, client = make_server(pkg, fx, tmp_path)
        client.register_dataset("a", "t2", network=t2n, correlation=t2c,
                                data=t2d)
        try:
            return client.analyze("a", "d", ["t", "t2"], n_perm=48,
                                  seed=4, timeout=600)
        finally:
            srv.close()

    want, got = both(run)
    ref = module_preservation(
        network={"d": fx["dn"], "t": fx["tn"], "t2": t2n},
        correlation={"d": fx["dc"], "t": fx["tc"], "t2": t2c},
        data={"d": fx["dd"], "t": fx["td"], "t2": t2d},
        module_assignments=fx["assign"], discovery="d", test=["t", "t2"],
        n_perm=48, seed=4, config=CFG, vmap_tests=True, simplify=False,
        device="cpu")
    assert [t["test"] for t in got["tests"]] == ["t", "t2"]
    assert got["completed"] == want["completed"] == 48
    for g, w in zip(got["tests"], want["tests"]):
        for f in ("p_values", "counts_hi", "counts_lo", "counts_eff"):
            assert np.array_equal(g[f], w[f]), f
        assert np.abs(g["observed"] - w["observed"]).max() <= JAX_TOL
        r = ref["d"][g["test"]]
        assert np.array_equal(g["p_values"], r.p_values)
        hi, lo, eff = tpv.tail_counts(r.observed, r.nulls[:r.completed])
        assert np.array_equal(g["counts_hi"], hi)
        assert np.array_equal(g["counts_lo"], lo)
        assert np.abs(g["observed"] - r.observed).max() <= SOLO_TOL


def test_data_only_register_and_analyze(fx, tmp_path):
    """The data-only payload (data + beta): digests carry the derivation
    params and equal the JAX package's; the served result equals the JAX
    server's and the port's ``atlas_module_preservation``."""
    def run(pkg):
        srv, client = make_server(pkg, fx, tmp_path, tenants=())
        try:
            d1 = client.register_dataset("a", "d", data=fx["dd"], beta=2.0,
                                         assignments=fx["assign"])
            d2 = client.register_dataset("a", "t", data=fx["td"], beta=2.0)
            d3 = client.register_dataset("a", "d3", data=fx["dd"],
                                         beta=(3.0, "signed"),
                                         assignments=fx["assign"])
            res = client.analyze("a", "d", "t", n_perm=64, seed=3,
                                 timeout=600)
        finally:
            srv.close()
        return (d1, d2, d3), res

    (wd, want), (gd, got) = both(run)
    assert gd == wd
    assert gd[0].endswith("|beta:2|unsigned")
    assert gd[2].endswith("|beta:3|signed")
    assert gd[0].split("|")[0] == gd[2].split("|")[0]
    assert_same(got, want, JAX_TOL)
    ref = atlas_module_preservation(
        {"d": fx["dd"], "t": fx["td"]},
        module_assignments={"d": fx["assign"]}, data_only=2.0,
        discovery="d", test="t", n_perm=64, seed=3, config=CFG,
        device="cpu")
    assert np.array_equal(got["p_values"], ref.p_values)
    hi, lo, _eff = tpv.tail_counts(ref.observed, ref.nulls[:ref.completed])
    assert np.array_equal(got["counts_hi"], hi)
    assert np.array_equal(got["counts_lo"], lo)


def test_dataset_digests_equal_jax(fx, tmp_path):
    """The same registrations (dense with and without data, a fixture)
    give the same content digests in both packages."""
    def run(pkg):
        srv, client = make_server(pkg, fx, tmp_path, tenants=(),
                                  start=False)
        try:
            out = [
                client.register_dataset(
                    "a", "d", network=fx["dn"], correlation=fx["dc"],
                    data=fx["dd"], assignments=fx["assign"]),
                client.register_dataset(
                    "a", "t", network=fx["tn"].astype(np.float64),
                    correlation=fx["tc"].astype(np.float64)),
            ]
            client.register_fixture("b", "fx", genes=60, modules=2,
                                    n_samples=12, seed=5)
            out += [srv._dataset("b", n).digest for n in ("fx_d", "fx_t")]
            return out
        finally:
            srv.close(drain=False)

    want, got = both(run)
    assert got == want
    assert len(set(got)) == 4


# ---------------------------------------------------------------------------
# the warm pool
# ---------------------------------------------------------------------------

def test_warm_pool_second_request_builds_nothing(fx, tmp_path, monkeypatch):
    built = []
    real = tserve.PackedEngine.__init__

    def counting(self, *a, **kw):
        built.append(1)
        real(self, *a, **kw)

    monkeypatch.setattr(tserve.PackedEngine, "__init__", counting)
    srv, client = make_server(PORT, fx, tmp_path)
    try:
        r1 = client.analyze("a", "d", "t", n_perm=48, seed=1, timeout=600)
        r2 = client.analyze("a", "d", "t", n_perm=48, seed=2, timeout=600)
        st = srv.stats()
    finally:
        srv.close()
    assert r1["pool_hit"] is False and r2["pool_hit"] is True
    assert len(built) == 1
    assert {k: st["pool"][k] for k in ("size", "hits", "misses")} == {
        "size": 1, "hits": 1, "misses": 1}
    # the datasets wait on the host, float32: two 100-node pairs + data
    assert st["datasets_gib"] == pytest.approx(
        2 * (2 * 100 * 100 + 16 * 100) * 4 / 2**30)
    names = {e["ev"] for e in read_events(str(tmp_path / "port_tel.jsonl"))}
    assert {"serve_pool_miss", "serve_pool_hit"} <= names


class _Engine:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def release(self):
        self.log.append(self.name)


def test_pool_lru_releases_on_evict_discard_and_clear():
    log = []
    pool = tpool.ProgramPool(max_size=2)
    for k in ("a", "b", "c"):
        pool.get(k, lambda k=k: _Engine(log, k))
    assert log == ["a"] and len(pool) == 2
    eng, hit = pool.get("b", lambda: _Engine(log, "b2"))
    assert hit and eng.name == "b"
    pool.discard("c")
    assert log == ["a", "c"]
    pool.get("d", lambda: _Engine(log, "d"))
    pool.clear()
    assert sorted(log) == ["a", "b", "c", "d"] and len(pool) == 0
    st = pool.stats()
    assert (st["hits"], st["misses"], st["evictions"]) == (1, 4, 1)
    assert st["held_gib"] == 0.0
    # a disabled pool builds every time and keeps nothing
    off = tpool.ProgramPool(max_size=0)
    off.get("x", lambda: _Engine(log, "x"))
    off.get("x", lambda: _Engine(log, "x"))
    assert off.stats()["misses"] == 2 and len(off) == 0


def test_pool_held_bytes_counts_card_tensors_once():
    class Holder:
        pass

    h = Holder()
    t = torch.zeros(8)
    h.a, h.b, h.nested = t, t, {"x": [t[:2]]}
    assert tpool.held_bytes(h) == 0      # host tensors are not card memory


# ---------------------------------------------------------------------------
# admission, fairness, drain
# ---------------------------------------------------------------------------

def test_admission_control_rejects_with_retry_hint(fx, tmp_path):
    def run(pkg):
        srv, client = make_server(pkg, fx, tmp_path, start=False,
                                  max_queue=2, brownout_rate_pps=10.0)
        client.submit("a", "d", "t", n_perm=32, seed=1)
        client.submit("a", "d", "t", n_perm=32, seed=2)
        with pytest.raises(pkg["QueueFull"]) as exc:
            client.submit("a", "d", "t", n_perm=32, seed=3)
        srv.close(drain=False)
        ev = [e for e in read_events(str(tmp_path /
                                         f"{pkg['name']}_tel.jsonl"))
              if e["ev"] == "request_rejected"]
        return str(exc.value), exc.value.retry_after_s, ev[0]["data"]

    want, got = both(run)
    assert got == want
    assert got[1] == pytest.approx(9.6)
    assert got[2]["reason"] == "queue_full" and got[2]["tenant"] == "a"


def test_weighted_round_robin_order(fx, tmp_path):
    def run(pkg):
        srv, client = make_server(pkg, fx, tmp_path, tenants=(),
                                  start=False, max_pack=1)
        client.register_tenant("a", weight=2)
        client.register_tenant("b", weight=1)
        for t in ("a", "b"):
            register(client, t, fx)
        hs = [client.submit("a", "d", "t", n_perm=32, seed=i)
              for i in range(4)]
        hs += [client.submit("b", "d", "t", n_perm=32, seed=100 + i)
               for i in range(2)]
        srv.start()
        try:
            res = [client.result(h, timeout=600) for h in hs]
        finally:
            srv.close()
        ev = read_events(str(tmp_path / f"{pkg['name']}_tel.jsonl"))
        return res, [e["data"]["tenant"] for e in ev
                     if e["ev"] == "request_packed"]

    (wres, worder), (gres, gorder) = both(run)
    assert gorder == worder == ["a", "a", "b", "a", "a", "b"]
    for g, w in zip(gres, wres):
        assert_same(g, w, JAX_TOL)


def test_graceful_drain_finishes_queued_work(fx, tmp_path):
    srv, client = make_server(PORT, fx, tmp_path, start=False)
    h1 = client.submit("a", "d", "t", n_perm=32, seed=1)
    h2 = client.submit("a", "d", "t", n_perm=32, seed=2)
    srv.start()
    srv.close(drain=True)
    assert client.result(h1, timeout=1)["completed"] == 32
    assert client.result(h2, timeout=1)["completed"] == 32
    end = [e for e in read_events(str(tmp_path / "port_tel.jsonl"))
           if e["ev"] == "serve_end"]
    assert end and end[0]["data"]["drained"] is True
    assert end[0]["data"]["requests_done"] == 2
    with pytest.raises(tserve.ServeError, match="draining"):
        client.submit("a", "d", "t", n_perm=32, seed=3)


# ---------------------------------------------------------------------------
# the fault ladder around shared dispatches
# ---------------------------------------------------------------------------

def test_transient_fault_in_pack_recovers(fx, tmp_path):
    def run(pkg):
        srv, client = make_server(
            pkg, fx, tmp_path,
            fault_policy=pkg["Policy"](plan="transient@8",
                                       backoff_base_s=0.0,
                                       backoff_jitter=0.0))
        try:
            res = client.analyze("a", "d", "t", n_perm=64, seed=3,
                                 timeout=600)
        finally:
            srv.close()
        names = [e["ev"] for e in read_events(
            str(tmp_path / f"{pkg['name']}_tel.jsonl"))]
        return res, [n for n in names if n in ("fault_injected",
                                               "retry_attempt")]

    (want, wev), (got, gev) = both(run)
    assert_same(got, want, JAX_TOL)
    assert_solo(got, solo(fx, n_perm=64, seed=3))
    assert gev == wev == ["fault_injected", "retry_attempt"]


def test_failed_pack_is_isolated_per_request(fx, tmp_path):
    """A fatal fault in a shared pack: the pack splits, each member fails
    alone on its solo retry, the server keeps serving — as in the JAX
    package."""
    def run(pkg):
        srv, client = make_server(
            pkg, fx, tmp_path, tenants=("a", "b"), start=False,
            fault_policy=pkg["Policy"](plan="fatal@8x3",
                                       backoff_base_s=0.0,
                                       backoff_jitter=0.0))
        ha = client.submit("a", "d", "t", n_perm=32, seed=1)
        hb = client.submit("b", "d", "t", n_perm=32, seed=2)
        srv.start()
        errors = []
        for h in (ha, hb):
            with pytest.raises(pkg["ServeError"]) as exc:
                client.result(h, timeout=600)
            errors.append(str(exc.value).split(":")[1].strip())
        res = client.analyze("b", "d", "t", n_perm=32, seed=9, timeout=600)
        st = srv.stats()
        srv.close()
        requeued = sum(1 for e in read_events(
            str(tmp_path / f"{pkg['name']}_tel.jsonl"))
            if e["ev"] == "request_requeued")
        return errors, res, st, requeued

    (werr, wres, wst, wrq), (gerr, gres, gst, grq) = both(run)
    assert gerr == werr
    assert_same(gres, wres, JAX_TOL)
    assert_solo(gres, solo(fx, n_perm=32, seed=9))
    for t, want in (("a", (0, 1)), ("b", (1, 1))):
        got = (gst["tenants"][t]["done"], gst["tenants"][t]["failed"])
        assert got == want == (wst["tenants"][t]["done"],
                               wst["tenants"][t]["failed"])
    assert grq == wrq == 2


# ---------------------------------------------------------------------------
# costs, trace contexts, the ops surface
# ---------------------------------------------------------------------------

def test_pack_costs_conserve_exactly(fx, tmp_path):
    srv, client = make_server(PORT, fx, tmp_path, start=False)
    hs = [client.submit("a", "d", "t", n_perm=n, seed=s)
          for n, s in ((64, 3), (32, 5))]
    srv.start()
    try:
        res = [client.result(h, timeout=600) for h in hs]
    finally:
        srv.close()
    assert res[0]["pack_id"] == res[1]["pack_id"]
    costs = [r["cost"] for r in res]
    totals = costs[0]["pack_totals"]
    assert costs[1]["pack_totals"] == totals
    for f in COST_FIELDS:
        assert costs[0][f] + costs[1][f] == totals[f], f
    assert costs[0]["perms"] + costs[1]["perms"] > 0
    ev = [e for e in read_events(str(tmp_path / "port_tel.jsonl"))
          if e["ev"] == "request_cost"]
    assert len(ev) == 2


class StepClock:
    """A clock that advances one second per reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def test_adaptive_and_expired_member_costs_conserve(fx, tmp_path):
    """A pack of a fixed, an adaptive and a deadline-cancelled member (on
    an injected clock): the cancelled member's share is attributed and
    the three shares sum exactly to the pack totals."""
    srv = tserve.PreservationServer(tserve.ServeConfig(
        engine=CFG, device="cpu", telemetry=str(tmp_path / "tel.jsonl")),
        start=False, clock=StepClock())
    register(tserve.InProcessClient(srv), "a", fx)
    hs = [srv.submit("a", "d", "t", n_perm=64, seed=3, deadline_s=1e9),
          srv.submit("a", "d", "t", n_perm=96, seed=5, adaptive=True,
                     deadline_s=1e9),
          srv.submit("a", "d", "t", n_perm=20000, seed=7, deadline_s=4),
          srv.submit("a", "d", "t", n_perm=32, seed=9, deadline_s=1e9)]
    srv.start()
    try:
        done = [srv.wait(h, timeout=600) for h in hs[:2]]
        with pytest.raises(tserve.ServeError, match="deadline exceeded"):
            srv.wait(hs[2], timeout=600)
        done.append(srv.wait(hs[3], timeout=600))
        st = srv.stats()
    finally:
        srv.close()
    costs = [e["data"] for e in read_events(str(tmp_path / "tel.jsonl"))
             if e["ev"] == "request_cost"]
    assert len(costs) == 4 and done[0]["pack_size"] == 4
    totals = done[0]["cost"]["pack_totals"]
    assert all(d["cost"]["pack_totals"] == totals for d in done)
    for f in ("device_s", "transfer_s", "perms", "bytes_to_host",
              "compile_s_amortized"):
        acc = 0      # in member order, as the totals are (not sum(): it
        for c in costs:  # compensates float rounding)
            acc += c[f]
        assert acc == totals[f], f
    assert st["tenants"]["a"]["expired"] == 1
    assert st["tenants"]["a"]["cost"]["perms"] == totals["perms"]
    assert_solo(done[0], solo(fx, n_perm=64, seed=3))
    assert_solo(done[1], solo(fx, n_perm=96, seed=5, adaptive=True))


def test_cost_off_without_telemetry(fx, tmp_path):
    srv, client = make_server(PORT, fx, tmp_path, tel=False)
    try:
        res = client.analyze("a", "d", "t", n_perm=32, seed=3, timeout=600)
    finally:
        srv.close()
    assert "cost" not in res


TRACE_CASES = [
    {"trace": "ab" * 16, "parent": "s1"}, {"trace": "ab" * 16},
    {"trace": "XYZ"}, {"trace": "abc"}, {"trace": "ab" * 40},
    {"trace": "ab" * 16, "parent": 5}, None, "ab" * 16, [1],
]


@pytest.mark.parametrize("ctx", TRACE_CASES)
def test_trace_ctx_normalization_equals_jax(ctx):
    assert (tproto.normalize_trace_ctx(ctx)
            == jproto.normalize_trace_ctx(ctx))
    minted = tproto.mint_trace_ctx("p")
    assert tproto.TRACE_ID_RE.match(minted["trace"])
    assert minted["parent"] == "p"


def test_client_trace_rides_the_request_and_the_journal(fx, tmp_path):
    ctx = {"trace": "cd" * 16, "parent": "client-span"}
    jpath = str(tmp_path / "j.jsonl")
    srv, client = make_server(PORT, fx, tmp_path, journal=jpath)
    try:
        res = client.analyze("a", "d", "t", n_perm=32, seed=3,
                             trace_ctx=ctx, timeout=600)
        bad = client.analyze("a", "d", "t", n_perm=32, seed=4,
                             trace_ctx={"trace": "not hex!"}, timeout=600)
    finally:
        srv.close()
    assert res["trace"] == ctx["trace"]
    assert tproto.TRACE_ID_RE.match(bad["trace"])   # server-minted
    recv = [e["data"] for e in read_events(str(tmp_path / "port_tel.jsonl"))
            if e["ev"] == "request_received"]
    assert recv[0]["trace"] == ctx["trace"]
    assert recv[0]["trace_parent"] == "client-span"
    from netrep_tpu_torch.serve import journal as tjnl

    acc = tjnl.scan(jpath)["accepted"]
    assert [a["trace"] for a in acc.values()][0] == ctx


def test_slo_burn_rate_counts_misses(fx, tmp_path):
    """``slo_s=0``: every request misses; burn = 1 / budget."""
    srv, client = make_server(PORT, fx, tmp_path, slo_s=0.0,
                              slo_budget=0.5, enforce_deadlines=False)
    try:
        client.analyze("a", "d", "t", n_perm=32, seed=3, timeout=600)
        st = srv.stats()
    finally:
        srv.close()
    assert st["tenants"]["a"]["burn_rate"] == pytest.approx(2.0)


def _series(text):
    """``{series name and labels: value}`` of the server's own serving
    block (after the telemetry registry's lines)."""
    out = {}
    block = text[text.index("# TYPE netrep_serve_requests_total"):]
    for line in block.splitlines():
        if not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            out[key] = val
    return out


def test_metrics_text_series_equal_jax(fx, tmp_path):
    """The serving series of ``metrics_text()``: the JAX package's names
    and labels; the counts (requests, packs, pool, attributed
    permutations, histogram counts) equal after the same stream."""
    def run(pkg):
        srv, client = make_server(pkg, fx, tmp_path, tenants=("a", "b"),
                                  start=False)
        hs = [client.submit("a", "d", "t", n_perm=32, seed=1),
              client.submit("b", "d", "t", n_perm=32, seed=2)]
        srv.start()
        try:
            for h in hs:
                client.result(h, timeout=600)
            client.analyze("a", "d", "t", n_perm=32, seed=1, timeout=600)
            return srv.metrics_text()
        finally:
            srv.close()

    want_text, got_text = both(run)
    want, got = _series(want_text), _series(got_text)
    assert got.keys() == want.keys()
    timed = ("netrep_serve_latency_seconds",
             "netrep_serve_request_device_seconds",
             "netrep_serve_attributed_device_seconds_total")
    for k in got:
        if k.startswith(timed) and not k.split("{")[0].endswith("_count"):
            continue
        assert got[k] == want[k], k
    assert got['netrep_serve_requests_total{tenant="a",outcome="done"}'] \
        == "2"
    assert got['netrep_serve_attributed_perms_total{tenant="a"}'] == "64"
    assert got["netrep_serve_packs_total"] == "2"
    # the engine-run registry rides the same exposition
    assert "netrep_chunk_count_total" in got_text


def test_top_and_tenant_readers_equal_jax(fx, tmp_path):
    """``snapshot``/``render``/``render_tenant_table`` of the port's live
    stats equal the JAX package's on the same stats; ``tenant_summary``
    and ``render_tenants`` equal the JAX package's on the port's event
    file."""
    srv, client = make_server(PORT, fx, tmp_path, tenants=("a", "b"))
    try:
        client.analyze("a", "d", "t", n_perm=32, seed=3, timeout=600)
        client.analyze("b", "d", "t", n_perm=32, seed=5, timeout=600)
        with pytest.raises(tserve.QueueFull):
            srv.config.max_queue = 0
            client.submit("b", "d", "t", n_perm=32, seed=6)
        st = srv.stats()
    finally:
        srv.close()
    snap = ttop.snapshot(st)
    assert snap == jtop.snapshot(st)
    json.dumps(snap)
    assert ttop.render(snap) == jtop.render(snap)
    rows = {r["tenant"]: r for r in snap["tenants"]}
    assert rows["a"]["done"] == rows["b"]["done"] == 1
    assert rows["a"]["p50_ms"] is not None and rows["a"]["device_s"] > 0
    assert (ttop.render_tenant_table([{"tenant": "x"}])
            == jtop.render_tenant_table([{"tenant": "x"}]))
    path = str(tmp_path / "port_tel.jsonl")
    got = ttm.tenant_summary(ttm.read_events(path))
    assert got == jtm.tenant_summary(jtm.read_events(path))
    assert got["b"]["rejected"] == 1 and got["a"]["perms"] == 32
    assert ttm.render_tenants(path) == jtm.render_tenants(path)
    assert ttop.render(ttop.snapshot({"tenants": {}})) == jtop.render(
        jtop.snapshot({"tenants": {}}))


# ---------------------------------------------------------------------------
# validation and the device rule
# ---------------------------------------------------------------------------

def test_data_only_register_validation_equals_jax(fx, tmp_path):
    def run(pkg):
        srv, client = make_server(pkg, fx, tmp_path, tenants=(),
                                  start=False)
        errors = []
        try:
            for call in (
                lambda: client.register_dataset("a", "d", data=fx["dd"]),
                lambda: client.register_dataset(
                    "a", "d", network=fx["dn"], correlation=fx["dc"],
                    beta=2.0),
            ):
                with pytest.raises(pkg["ServeError"]) as exc:
                    call()
                errors.append(str(exc.value))
            client.register_dataset("a", "d", data=fx["dd"], beta=2.0,
                                    assignments=fx["assign"])
            client.register_dataset("a", "dense_t", network=fx["tn"],
                                    correlation=fx["tc"], data=fx["td"])
            client.register_dataset("a", "t", data=fx["td"], beta=3.0)
            for args in (("a", "d", "dense_t"), ("a", "d", "t"),
                         ("ghost", "d", "t"), ("a", "d", "nope"),
                         ("a", "dense_t", "d")):
                with pytest.raises(pkg["ServeError"]) as exc:
                    client.submit(*args, n_perm=16)
                errors.append(str(exc.value))
        finally:
            srv.close(drain=False)
        return errors

    want, got = both(run)
    assert got == want
    assert "cannot mix" in got[2] and "different derivation" in got[3]
    assert "unknown tenant" in got[4] and "no dataset" in got[5]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the default device is the card where one exists")
def test_default_device_needs_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.PreservationServer(tserve.ServeConfig(), start=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.PreservationServer()


def test_exports():
    names = {"PreservationServer", "ServeConfig", "ServeError", "QueueFull",
             "Request", "ProgramPool", "RequestJournal", "JournalShipper",
             "InProcessClient", "SocketClient", "ServeRejected",
             "retry_delay", "PackedEngine", "GridPackedEngine",
             "PackMonitor", "RequestPlan", "assign_bases", "run_pack"}
    assert names <= set(tserve.__all__)
    assert all(hasattr(tserve, n) for n in names)
    # the port's engine default: the JAX package's chunk, no autotune
    assert tserve.ServeConfig().engine == EngineConfig(chunk_size=64)
    assert netrep_tpu.serve.ServeConfig().engine.chunk_size == 64
