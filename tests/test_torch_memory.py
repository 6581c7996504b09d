"""Where the port keeps each dataset matrix, on the CPU.

Held: (a) no ``n × n`` matrix of a dataset that no pair reads as a test
side reaches the port's transfer points (the input checks' narrowing,
``models/dataset.py::to_device``, ``parallel/engine.py::_as_f32``) in
``module_preservation`` (fixed, streaming, ``vmap_tests``, a 1×4
row-sharded mesh), ``network_properties`` or a packed engine: the
discovery side's blocks are gathered where it lies; (b) such a run
equals the JAX package's (module sets, counts and p-values equal, nulls
within ROADMAP Queue 3's tolerance: 99.9% within 1e-5, all within 1e-4);
(c) bucket properties gathered from a float64 host source equal, bit for
bit, those of the same matrix narrowed first; (d) two pooled engines over
one test registration hold the same storages, the pool counts them once,
and evicting one leaves the other's results as they were; (e) two
in-process replicas hold one host copy of a registration, and killing one
leaves its peer's copy and results intact."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import netrep_tpu  # noqa: E402
from netrep_tpu.data import make_example_pair, make_mixed_pair  # noqa: E402
from netrep_tpu.data import pair_frames  # noqa: E402
from netrep_tpu_torch import serve as tserve  # noqa: E402
from netrep_tpu_torch.models import dataset as ds  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.models.properties import network_properties  # noqa: E402
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402
from netrep_tpu_torch.parallel import engine as teng  # noqa: E402
from netrep_tpu_torch.parallel.engine import ModuleSpec, build_buckets  # noqa: E402
from netrep_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from netrep_tpu_torch.serve import pool as tpool  # noqa: E402
from netrep_tpu_torch.serve.packer import PackedEngine  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402
from netrep_tpu_torch.utils.config import FaultPolicy  # noqa: E402

N_PERM = 200
SEED = 11
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def autotune_store_module(tmp_path_factory):
    """The autotune store in a directory of this module's own while its
    module-scoped fixtures run: no test writes the default store."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NETREP_AUTOTUNE_STORE",
                  str(tmp_path_factory.mktemp("autotune")))
        yield


@pytest.fixture(autouse=True)
def autotune_store(tmp_path_factory, monkeypatch):
    """Each test its own autotune store, outside its ``tmp_path``: a
    setting another test measured never moves this one's superchunk,
    progress calls, events or checkpoint cadence."""
    monkeypatch.setenv("NETREP_AUTOTUNE_STORE",
                       str(tmp_path_factory.mktemp("autotune")))


@pytest.fixture(scope="module")
def pair():
    return make_example_pair(np.random.default_rng(3))


@pytest.fixture(scope="module")
def frames(pair):
    d, t = pair_frames(pair)
    # a second test cohort over the same nodes, for vmap_tests
    t2 = {k: v.copy() for k, v in t.items()}
    t2["data"] = t2["data"] + np.random.default_rng(5).normal(
        0.0, 0.3, t2["data"].shape)
    c = np.corrcoef(t2["data"].to_numpy(), rowvar=False)
    t2["correlation"].loc[:, :] = c
    t2["network"].loc[:, :] = np.abs(c) ** 6
    return dict(
        network={"d": d["network"], "t": t["network"], "t2": t2["network"]},
        data={"d": d["data"], "t": t["data"], "t2": t2["data"]},
        correlation={"d": d["correlation"], "t": t["correlation"],
                     "t2": t2["correlation"]},
        module_assignments=pair["labels"], discovery="d",
    )


class Spy:
    """Records every ``n × n`` matrix that reaches the transfer points:
    the input checks' narrowing onto the device, ``to_device`` and
    ``_as_f32``."""

    def __init__(self, monkeypatch):
        self.seen = []
        check = ds._check_square_symmetric

        def narrowed(*a, **kw):
            out, top = check(*a, **kw)
            if out is not None:
                self.seen.append(("narrowed", out))
            return out, top

        monkeypatch.setattr(ds, "_check_square_symmetric", narrowed)
        for mod, name in ((ds, "to_device"), (teng, "_as_f32")):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name),
                                                      name))

    def _wrap(self, fn, name):
        @functools.wraps(fn)
        def spied(a, *rest, **kw):
            if np.ndim(a) == 2 and np.shape(a)[0] == np.shape(a)[1]:
                self.seen.append((name, a))
            return fn(a, *rest, **kw)
        return spied

    def matching(self, mats):
        """The recorded matrices equal to one of ``mats`` (float64 host
        arrays) narrowed to float32."""
        want = [torch.as_tensor(np.asarray(m, dtype=np.float64)).float()
                for m in mats]
        hits = []
        for where, a in self.seen:
            got = torch.as_tensor(np.asarray(a)) if not isinstance(
                a, torch.Tensor) else a
            if any(got.shape == w.shape and torch.equal(
                    got.detach().cpu().float(), w) for w in want):
                hits.append(where)
        return hits


def _disc(frames):
    return [frames["correlation"]["d"], frames["network"]["d"]]


@pytest.mark.parametrize("case", ["fixed", "streaming", "vmap_tests",
                                  "row_sharded_1x4"])
def test_discovery_matrices_never_reach_the_device(frames, monkeypatch,
                                                   case):
    """(a) ``module_preservation``: the discovery dataset is checked but
    never narrowed onto the device or copied there whole; every run still
    completes with finite observed statistics."""
    kw = dict(test="t", n_perm=64, seed=SEED)
    if case == "streaming":
        kw["store_nulls"] = False
    elif case == "vmap_tests":
        kw.update(test=["t", "t2"], vmap_tests=True)
    elif case == "row_sharded_1x4":
        kw.update(mesh=make_mesh(1, 4, devices=[CPU] * 4),
                  config=EngineConfig(matrix_sharding="row",
                                      stat_mode="xla"))
    spy = Spy(monkeypatch)
    res = module_preservation(**frames, **kw, device="cpu")
    assert spy.matching(_disc(frames)) == []
    # the test sides still go through the checks' narrowing
    assert spy.matching([frames["correlation"]["t"]])
    for r in (res.values() if isinstance(res, dict) else [res]):
        assert np.isfinite(r.observed).all() and r.completed == 64


def test_network_properties_reads_module_blocks_only(frames, monkeypatch):
    """(a) ``network_properties`` narrows no dataset onto the device: it
    reads module submatrices, gathered where the inputs lie."""
    spy = Spy(monkeypatch)
    props = network_properties(
        **{k: {n: frames[k][n] for n in ("d", "t")}
           for k in ("network", "data", "correlation")},
        module_assignments=frames["module_assignments"], discovery="d",
        test="t", device="cpu")
    assert spy.seen == []
    assert all(np.isfinite(p["degree"]).all() for p in props.values())


def test_packed_engine_gathers_the_discovery_side_on_the_host(frames,
                                                              monkeypatch):
    """(a) A packed engine over two requests (the serving tier's) built
    from host discovery matrices copies none of them to the device."""
    from netrep_tpu_torch.models.preservation import _overlap_setup

    two = {k: {n: frames[k][n] for n in ("d", "t")}
           for k in ("network", "data", "correlation")}
    built = ds.build_datasets(**two, device="cpu")
    norm = ds.normalize_module_assignments(
        frames["module_assignments"], built, ["d"])["d"]
    _labels, specs, _counts, pool = _overlap_setup(
        built["d"], built["t"], norm, None, "0", "overlap")
    host = [two[k]["d"].to_numpy() for k in ("correlation", "network",
                                              "data")]
    spy = Spy(monkeypatch)
    eng = PackedEngine(*host, built["t"].correlation, built["t"].network,
                       built["t"].data, [specs[:2], specs[2:]], pool,
                       config=EngineConfig(chunk_size=16), device="cpu")
    assert spy.matching(host[:2]) == []
    assert np.isfinite(eng.observed()).all()


def test_host_discovery_equals_jax(frames):
    """(b) With the discovery side on the host, the run equals the JAX
    package's: module sets, counts and p-values exactly, nulls within the
    Queue 3 tolerance."""
    kw = {**frames, "test": "t", "n_perm": N_PERM, "seed": SEED}
    rt = module_preservation(**kw, device="cpu")
    rj = netrep_tpu.module_preservation(**kw)
    assert rt.module_labels == rj.module_labels
    np.testing.assert_array_equal(rt.p_values, rj.p_values)
    for a, b in zip(tpv.tail_counts(rt.observed, rt.nulls),
                    tpv.tail_counts(rj.observed, rj.nulls)):
        np.testing.assert_array_equal(a, b)
    err = np.abs(rt.nulls - rj.nulls)
    assert np.nanmax(err) <= 1e-4
    assert np.mean(err[np.isfinite(err)] <= 1e-5) >= 0.999
    np.testing.assert_allclose(rt.observed, rj.observed, rtol=0, atol=1e-5)


def test_host_gathered_props_equal_the_narrowed_matrix(pair):
    """(c) ``build_buckets`` on a float64 host source and on the same
    matrices narrowed first (float32 tensors) give equal ``DiscProps``,
    bit for bit, with data and with a derived network."""
    d = pair["discovery"]
    names = list(d["names"])
    labels = [pair["labels"][n] for n in names]
    mods = [ModuleSpec(lab, np.flatnonzero(np.asarray(labels) == lab)
                       .astype(np.int32),
                       np.flatnonzero(np.asarray(labels) == lab)
                       .astype(np.int32))
            for lab in sorted(set(labels) - {"0"})]
    pool = np.arange(len(names), dtype=np.int32)
    for cfg in (EngineConfig(), EngineConfig(network_from_correlation=6)):
        host = build_buckets(d["correlation"], d["network"], d["data"],
                             mods, pool, cfg, CPU)
        narrowed = build_buckets(
            *(torch.as_tensor(np.asarray(d[k], np.float64)).float()
              for k in ("correlation", "network", "data")),
            mods, pool, cfg, CPU)
        assert len(host) == len(narrowed)
        for a, b in zip(host, narrowed):
            assert a["cap"] == b["cap"]
            for x, y in zip(a["disc"], b["disc"]):
                assert x.dtype == y.dtype == torch.float32
                assert torch.equal(x, y)


@pytest.fixture(scope="module")
def fx():
    mixed = make_mixed_pair(100, 3, n_samples=16, seed=7)
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    assign = {f"node_{i}": "0" for i in range(dn.shape[0])}
    labels = []
    for lab, idx in mixed["specs"]:
        labels.append(str(lab))
        for i in idx:
            assign[f"node_{i}"] = str(lab)
    return dict(dn=dn, dc=dc, dd=dd, tn=tn, tc=tc, td=td, assign=assign,
                labels=labels)


def _register(client, fx):
    client.register_dataset("a", "d", network=fx["dn"], correlation=fx["dc"],
                            data=fx["dd"], assignments=fx["assign"])
    client.register_dataset("a", "t", network=fx["tn"], correlation=fx["tc"],
                            data=fx["td"])


def test_pooled_engines_share_one_test_copy(fx, monkeypatch):
    """(d) Two pooled bfloat16 engines over one test registration hold the
    same storages of its bfloat16 copy, the pool counts them once, and
    evicting one leaves the other's results unchanged."""
    # count host storages as the pool counts a card's
    monkeypatch.setattr(tpool, "held_storages", functools.partial(
        _storages_on, "cpu"))
    srv = tserve.PreservationServer(tserve.ServeConfig(
        engine=EngineConfig(chunk_size=16, dtype="bfloat16"), device="cpu",
        pool_size=2))
    client = tserve.InProcessClient(srv)
    try:
        _register(client, fx)
        a, b = fx["labels"][:2], fx["labels"][1:]
        ra = client.analyze("a", "d", "t", modules=a, n_perm=48, seed=1,
                            timeout=600)
        client.analyze("a", "d", "t", modules=b, n_perm=48, seed=2,
                       timeout=600)
        engines = list(srv.pool._lru.values())
        assert len(engines) == 2
        ptrs = [(e._test_corr.untyped_storage().data_ptr(),
                 e._test_net.untyped_storage().data_ptr(),
                 e._test_dataT.untyped_storage().data_ptr())
                for e in engines]
        assert ptrs[0] == ptrs[1]
        assert engines[0]._test_corr.dtype == torch.bfloat16
        one = tpool.held_bytes(engines[0])
        both = sum(tpool.held_bytes(e) for e in engines)
        assert srv.stats()["pool"]["held_gib"] * 2**30 < both
        assert srv.stats()["pool"]["held_gib"] * 2**30 >= one
        # evict the engine of ``b``; ``a`` hits its pooled engine and
        # gives the same answer
        srv.pool.discard(next(k for k, e in srv.pool._lru.items()
                              if e is engines[1]))
        again = client.analyze("a", "d", "t", modules=a, n_perm=48, seed=1,
                               timeout=600)
    finally:
        srv.close()
    assert again["pool_hit"]
    for f in ("p_values", "counts_hi", "counts_lo", "observed"):
        np.testing.assert_array_equal(np.asarray(again[f]),
                                      np.asarray(ra[f]))


def _storages_on(device_type, engine):
    seen = {}
    stack, ids = [engine], set()
    while stack:
        obj = stack.pop()
        if id(obj) in ids:
            continue
        ids.add(id(obj))
        if isinstance(obj, torch.Tensor):
            if obj.device.type == device_type:
                st = obj.untyped_storage()
                seen[(obj.device.index, st.data_ptr())] = st.nbytes()
        elif isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
        elif hasattr(obj, "__dict__") and not isinstance(obj, type):
            stack.extend(vars(obj).values())
    return seen


def test_inprocess_replicas_share_one_registration_copy(fx, tmp_path):
    """(e) Two in-process replicas hold one host copy of each
    registration; a crash plan kills the home replica's worker mid-pack,
    ``kill_replica`` fails it over, and the peer's copy and results are
    intact (the peer resumes the crashed request and answers as a solo
    run of it)."""
    def mk(rid, jpath, ckpt):
        return tserve.ServeConfig(
            engine=EngineConfig(chunk_size=16), journal=jpath,
            checkpoint_dir=ckpt, checkpoint_every=16, fleet_label=rid,
            device="cpu")

    kw = dict(n_perm=64, seed=3)
    solo = module_preservation(
        network={"d": fx["dn"], "t": fx["tn"]},
        correlation={"d": fx["dc"], "t": fx["tc"]},
        data={"d": fx["dd"], "t": fx["td"]}, module_assignments=fx["assign"],
        discovery="d", test="t", config=EngineConfig(chunk_size=16),
        device="cpu", **kw)
    fleet = tserve.build_inprocess_fleet(
        2, str(tmp_path / "fleet"), make_config=mk,
        fleet_config=tserve.FleetConfig(heartbeat_s=3600.0),
        start_servers=False)
    try:
        _register(fleet, fx)
        reps = fleet.live_replicas()
        assert len(reps) == 2
        for name in ("d", "t"):
            held = [rep.server._dataset("a", name).ds for rep in
                    reps.values()]
            for f in ds.FIELDS:
                assert (getattr(held[0], f).untyped_storage().data_ptr()
                        == getattr(held[1], f).untyped_storage().data_ptr())
        one = tserve.scheduler.registrations_gib()
        assert one == pytest.approx(
            2 * (2 * 100 * 100 + 16 * 100) * 4 / 2**30)
        home = fleet.route("a", "d", "t")
        peer = next(r for rid, r in reps.items() if rid != home.rid)
        kept = {f: getattr(peer.server._dataset("a", "t").ds, f).clone()
                for f in ds.FIELDS}
        home.arm_fault_plan(FaultPolicy(plan="crash@24",
                                        backoff_base_s=0.0,
                                        backoff_jitter=0.0))
        home.server.submit("a", "d", "t", idempotency_key="k", **kw)
        home.server.start()
        home.server._worker.join(timeout=300)
        assert not home.server._worker.is_alive(), "crash never fired"
        fleet.kill_replica(home.rid)
        assert home.server._dataset("a", "t").ds.correlation is None
        # the dead replica let go; the peer's copy is the process's
        left = peer.server._dataset("a", "t").ds
        for f in ds.FIELDS:
            assert torch.equal(getattr(left, f), kept[f])
        assert tserve.scheduler.registrations_gib() == pytest.approx(one)
        peer.server.start()
        got = fleet.analyze("a", "d", "t", idempotency_key="k",
                            timeout=600, **kw)
    finally:
        fleet.close()
    np.testing.assert_array_equal(np.asarray(got["p_values"]),
                                  solo.p_values)
    np.testing.assert_array_equal(np.asarray(got["observed"]),
                                  solo.observed)
    assert tserve.scheduler.registrations_gib() == 0.0


@pytest.mark.parametrize("store_nulls", (True, False))
def test_host_discovery_equals_discovery_as_a_test_side(frames,
                                                        store_nulls):
    """Bit for bit: the same call with the discovery dataset also a test
    side (narrowed, its blocks gathered from the narrowed matrix) gives
    the same observed values, nulls or counts and p-values."""
    kw = {**frames, "n_perm": 64, "seed": SEED, "store_nulls": store_nulls,
          "device": "cpu"}
    host = module_preservation(**kw, test="t")
    both = module_preservation(**kw, test=["t", "d"],
                               self_preservation=True)["t"]
    np.testing.assert_array_equal(host.observed, both.observed)
    np.testing.assert_array_equal(host.p_values, both.p_values)
    if store_nulls:
        np.testing.assert_array_equal(host.nulls, both.nulls)
    else:
        for f in ("counts_hi", "counts_lo", "counts_eff"):
            np.testing.assert_array_equal(getattr(host, f),
                                          getattr(both, f))


def _checked(fx, name):
    prefix = "d" if name == "d" else "t"
    return ds.build_datasets(
        network={name: fx[prefix + "n"]}, correlation={name: fx[prefix + "c"]},
        data={name: fx[prefix + "d"]}, device="cpu")[name]


def _race(fn, n_threads=16):
    """``fn()`` from ``n_threads`` threads released together, with a
    short switch interval; returns every result."""
    import sys
    import threading

    got, start = [None] * n_threads, threading.Barrier(n_threads)

    def one(i):
        start.wait(timeout=60)
        got[i] = fn()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return got


def test_device_copies_hand_one_copy_to_racing_engines(fx):
    """Sixteen threads asking at once for one registration's bfloat16
    copy all get the same storages (a lost update would build two)."""
    t = _checked(fx, "t")
    got = _race(lambda: tpool.device_copy(t, torch.bfloat16, CPU))
    ptrs = {tuple(x.untyped_storage().data_ptr() for x in g) for g in got}
    assert len(ptrs) == 1
    assert got[0][0].dtype == torch.bfloat16
    assert torch.equal(got[0][0], t.correlation.to(torch.bfloat16))
    assert torch.equal(got[0][2], t.data.to(torch.bfloat16))


def test_host_copies_keep_one_copy_for_racing_registrations(fx):
    """Sixteen servers registering one digest at once end up holding one
    host copy, equal to each registration's own checked matrices."""
    def register():
        d = _checked(fx, "t")
        tserve.scheduler._share_registration("race-host", d)
        return d

    got = _race(register)
    ptrs = {tuple(getattr(d, f).untyped_storage().data_ptr()
                  for f in ds.FIELDS) for d in got}
    assert len(ptrs) == 1
    want = _checked(fx, "t")
    for f in ds.FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want, f))


def _colliding(fx):
    """The test cohort's matrices and a copy that differs from them only
    at two entries the registration digest does not sample (``[i, j]`` and
    ``[j, i]`` for two odd nodes of one module: at 100 × 100 the digest
    samples the even flat positions below 8,192), and that module's
    label."""
    lab, idx = next((str(lab), [i for i in idx if i % 2])
                    for lab, idx in make_mixed_pair(
                        100, 3, n_samples=16, seed=7)["specs"]
                    if sum(i % 2 for i in idx) >= 2)
    i, j = idx[:2]
    tc, tn = fx["tc"].copy(), fx["tn"].copy()
    tc[i, j] = tc[j, i] = -0.5 * fx["tc"][i, j] - 0.25
    tn[i, j] = tn[j, i] = abs(tc[i, j]) ** 6
    digest = [tserve.scheduler.content_digest([c, n, fx["td"]],
                                              dtype="float64")
              for c, n in ((fx["tc"], fx["tn"]), (tc, tn))]
    assert digest[0] == digest[1]
    assert not np.array_equal(tc, fx["tc"])
    return dict(tc=tc, tn=tn, td=fx["td"]), lab


def test_host_copies_never_share_a_copy_that_differs(fx):
    """Two registrations whose digests collide but whose matrices differ
    outside the digest's sample each keep their own host copy; a third
    equal to the second shares the second's."""
    other, _lab = _colliding(fx)
    share = tserve.scheduler._share_registration
    first = _checked(fx, "t")
    share("collide", first)
    mats = []
    for _ in range(2):
        d = ds.build_datasets(
            network={"t": other["tn"]}, correlation={"t": other["tc"]},
            data={"t": other["td"]}, device="cpu")["t"]
        mats.append({f: getattr(d, f).clone() for f in ds.FIELDS})
        share("collide", d)
        mats[-1]["held"] = d
    second, third = mats[0]["held"], mats[1]["held"]
    assert (second.correlation.untyped_storage().data_ptr()
            != first.correlation.untyped_storage().data_ptr())
    assert third.correlation is second.correlation
    for f in ds.FIELDS:
        assert torch.equal(getattr(second, f), mats[0][f])
        assert torch.equal(getattr(first, f), getattr(_checked(fx, "t"), f))
    assert not torch.equal(second.correlation, first.correlation)


def test_server_keeps_colliding_registrations_apart(fx):
    """A server holding two registrations whose digests collide (they
    differ only outside the digest's sample) answers each from its own
    matrices: the second's request equals a server's that holds it alone,
    while a pooled bfloat16 engine over the first holds the first's
    device copy."""
    other, lab = _colliding(fx)
    first_mod = next(x for x in fx["labels"] if x != lab)

    def serve(regs, requests):
        srv = tserve.PreservationServer(tserve.ServeConfig(
            engine=EngineConfig(chunk_size=16, dtype="bfloat16"),
            device="cpu", pool_size=2))
        client = tserve.InProcessClient(srv)
        try:
            client.register_dataset("a", "d", network=fx["dn"],
                                    correlation=fx["dc"], data=fx["dd"],
                                    assignments=fx["assign"])
            for name, m in regs:
                client.register_dataset("a", name, network=m["tn"],
                                        correlation=m["tc"], data=m["td"])
            return [client.analyze("a", "d", name, modules=mods, n_perm=48,
                                   seed=4, timeout=600)
                    for name, mods in requests]
        finally:
            srv.close()

    alone = serve([("t2", other)], [("t2", [lab])])[0]
    first = serve([("t", fx)], [("t", [lab])])[0]
    assert not np.array_equal(np.asarray(alone["observed"]),
                              np.asarray(first["observed"]))
    both = serve([("t", fx), ("t2", other)],
                 [("t", [first_mod]), ("t2", [lab])])[1]
    for f in ("observed", "p_values", "counts_hi", "counts_lo"):
        np.testing.assert_array_equal(np.asarray(both[f]),
                                      np.asarray(alone[f]))
