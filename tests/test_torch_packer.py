"""The port's cross-request packer (``netrep_tpu_torch.serve.packer``)
against the JAX package's on the same seeded inputs, on the CPU.

Held exactly: the grouped permutation keys, the grouped draw and the
grouped index blocks (bit for bit); per request of a pack — fixed and
adaptive, every alternative, one shared discovery source or one per
request, with data or data-only — the p-values, ``counts_hi/lo/eff``,
``n_perm_used``, ``completed`` and ``total_space`` of the JAX pack, and
those of the port's own solo ``module_preservation`` call (fused and
composed statistics); deadlines on a fake clock; cost members summing to
the pack totals bit for bit; an interrupted pack resumed to the
uninterrupted one; every refusal's text. Observed statistics are held to
the documented tolerance of the two packages' composed statistics
(ROADMAP.md Queue 3: within 1e-4; here they agree to ~3e-6).

The fixture is ``tests/test_grid.py``'s: three cohorts of 30 nodes and 40
samples."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from netrep_tpu.ops.sequential import StopRule as JRule  # noqa: E402
from netrep_tpu.parallel import engine as jeng  # noqa: E402
from netrep_tpu.serve import packer as jpk  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch import random as trandom  # noqa: E402
from netrep_tpu_torch.models import dataset as tds  # noqa: E402
from netrep_tpu_torch.models.preservation import (  # noqa: E402
    _overlap_setup, module_preservation,
)
from netrep_tpu_torch.ops.sequential import StopRule  # noqa: E402
from netrep_tpu_torch.parallel import engine as teng  # noqa: E402
from netrep_tpu_torch.serve import packer as tpk  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

N, S = 30, 40
NAMES = ["a", "b", "c"]
CHUNK = 16
CPU = torch.device("cpu")
OBS_TOL = 1e-4
#: the requests of a pack: assignments (node i -> label), seed, n_perm,
#: adaptive — different module sets, seeds, budgets and kinds
REQUESTS = [
    (lambda i: str(1 + i % 3) if i % 3 < 2 else "0", 7, 48, False),
    (lambda i: str(1 + i % 4), 11, 64, True),
    (lambda i: "1" if i < 12 else "0", 3, 32, False),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mk(seed):
    r = np.random.default_rng(seed)
    data = r.normal(size=(S, N))
    corr = np.corrcoef(data, rowvar=False)
    return np.abs(corr) ** 2, corr, data


@pytest.fixture(scope="module")
def cohorts():
    network, correlation, data = {}, {}, {}
    for i, n in enumerate(NAMES):
        network[n], correlation[n], data[n] = _mk(100 + i)
    built = tds.build_datasets(network, data=data, correlation=correlation,
                               device="cpu")
    return network, correlation, data, built


def _assign(fn):
    return {f"node_{i}": fn(i) for i in range(N)}


def _plans(built, d, t, requests=REQUESTS, alternative="greater",
           deadlines=None):
    """Each request's plan in both packages, from the port's overlap
    setup."""
    tp, jp = [], []
    for r, (fn, seed, n_perm, adaptive) in enumerate(requests):
        labels, specs, counts, pool = _overlap_setup(
            built[d], built[t], _assign(fn), None, "0", "all")
        kw = dict(labels=labels, counts=counts, pool=pool, n_perm=n_perm,
                  seed=seed, alternative=alternative, adaptive=adaptive,
                  deadline=None if deadlines is None else deadlines[r])
        tp.append(tpk.RequestPlan(specs=specs, rule=StopRule(min_perms=8),
                                  **kw))
        jp.append(jpk.RequestPlan(
            specs=[jeng.ModuleSpec(m.label, m.disc_idx, m.test_idx)
                   for m in specs], rule=JRule(min_perms=8), **kw))
    tpk.assign_bases(tp)
    jpk.assign_bases(jp)
    return tp, jp


def _mats(network, correlation, data, name, with_data=True):
    return (correlation[name], network[name],
            data[name] if with_data else None)


def _port_engine(cohorts, tp, d="a", t="c", cfg=None):
    network, correlation, data, _ = cohorts
    return tpk.PackedEngine(*_mats(network, correlation, data, d),
                            *_mats(network, correlation, data, t),
                            [p.specs for p in tp], tp[0].pool,
                            config=cfg or EngineConfig(chunk_size=CHUNK),
                            device="cpu")


def _engines(cohorts, tp, jp, d="a", t="c", cfg=None, jcfg=None):
    network, correlation, data, _ = cohorts
    dm, tm_ = (_mats(network, correlation, data, n) for n in (d, t))
    te = _port_engine(cohorts, tp, d, t, cfg)
    je = jpk.PackedEngine(*dm, *tm_, [p.specs for p in jp], jp[0].pool,
                          config=jcfg or JConfig(chunk_size=CHUNK,
                                                 autotune=False))
    return te, je


def assert_same_request(got, want, what=""):
    assert got.keys() == want.keys(), what
    if "expired" in want:
        assert got["expired"] and got["completed"] == want["completed"]
        return
    for f in ("p_values", "counts_hi", "counts_lo", "counts_eff",
              "n_vars_present", "total_size"):
        assert np.array_equal(got[f], want[f]), (what, f)
    for f in ("n_perm", "completed", "p_type", "alternative", "seed",
              "total_space", "finished", "module_labels"):
        assert got[f] == want[f], (what, f)
    if want["n_perm_used"] is None:
        assert got["n_perm_used"] is None
    else:
        assert np.array_equal(got["n_perm_used"], want["n_perm_used"]), what
    assert np.abs(np.asarray(got["observed"])
                  - np.asarray(want["observed"])).max() <= OBS_TOL, what


# ---------------------------------------------------------------------------
# Grouped keys, draws and index blocks: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("start", [0, 37])
def test_grouped_keys_equal_jax(groups, start):
    import jax

    seeds = [5, 2**31 + 9, 0][:groups]
    jkeys = jax.numpy.stack([jax.random.key(s) for s in seeds])
    want = np.asarray(jax.random.key_data(
        jeng._perm_keys_grouped_jit(jkeys, start, 12)))
    root = trandom.ThreefryKey(torch.stack(
        [trandom.key(s, device="cpu").words for s in seeds]))
    got = trandom.perm_keys(root, start, 12)
    assert got.shape == (12, groups)
    assert np.array_equal(got.data(), want)
    # a scalar root keeps the ungrouped layout
    assert trandom.perm_keys(trandom.key(5, device="cpu"), start,
                             12).shape == (12,)


def test_grouped_draw_and_blocks_equal_jax():
    import jax

    seeds, P = [7, 11, 3], 30
    pool = np.arange(P, dtype=np.int32)
    slices = [(0, 10), (10, 10), (0, 8), (8, 8), (16, 7), (0, 12)]
    groups = [0, 0, 1, 1, 1, 2]
    cap = 16
    jkeys = jax.numpy.stack([jax.random.key(s) for s in seeds])
    keys = jeng._perm_keys_grouped_jit(jkeys, 5, 6)
    want_perm, want_idx = [], []
    for row in keys:
        perms = jax.vmap(lambda k: jax.random.permutation(k, pool))(row)
        want_perm.append(np.asarray(perms))
        want_idx.append(np.asarray(
            jeng._idx_blocks_grouped(perms, cap, slices, groups)))
    root = trandom.ThreefryKey(torch.stack(
        [trandom.key(s, device="cpu").words for s in seeds]))
    perms = trandom.permutation(trandom.perm_keys(root, 5, 6),
                                torch.as_tensor(pool))
    assert np.array_equal(perms.numpy(), np.stack(want_perm))
    got = teng._idx_blocks_grouped(perms, cap, slices, groups)
    assert got.shape == (6, len(slices), cap)
    assert np.array_equal(got.numpy(), np.stack(want_idx))


# ---------------------------------------------------------------------------
# Packs against the JAX package and against the port's solo calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alternative", ["greater", "less", "two.sided"])
def test_pack_matches_jax(cohorts, alternative):
    tp, jp = _plans(cohorts[3], "a", "c", alternative=alternative)
    te, je = _engines(cohorts, tp, jp)
    got = tpk.run_pack(te, tp)
    want = jpk.run_pack(je, jp)
    for r, (g, w) in enumerate(zip(got, want)):
        assert_same_request(g, w, r)
    # the ceilings: each request stops at its own budget
    assert [g["completed"] for g in got] == [48, 64, 32]


@pytest.mark.parametrize("stat_mode", ["fused", "xla"])
def test_pack_equals_solo_calls(cohorts, stat_mode):
    """Each request of a port pack gives its own module_preservation
    call's p-values, counts and permutation counts."""
    network, correlation, data, built = cohorts
    tp, _ = _plans(built, "a", "c")
    cfg = EngineConfig(chunk_size=CHUNK, stat_mode=stat_mode)
    te = _port_engine(cohorts, tp, cfg=cfg)
    assert te.stat_mode == stat_mode
    got = tpk.run_pack(te, tp)
    for (fn, seed, n_perm, adaptive), g in zip(REQUESTS, got):
        solo = module_preservation(
            network, data=data, correlation=correlation,
            module_assignments=_assign(fn), discovery="a", test="c",
            n_perm=n_perm, null="all", seed=seed, config=cfg,
            adaptive=adaptive, adaptive_rule=StopRule(min_perms=8),
            simplify=False, device="cpu")["a"]["c"]
        assert np.array_equal(g["p_values"], solo.p_values)
        hi, lo, eff = (np.asarray(x) for x in
                       (g["counts_hi"], g["counts_lo"], g["counts_eff"]))
        from netrep_tpu_torch.ops import pvalues as tpv

        assert all(np.array_equal(a, b) for a, b in zip(
            (hi, lo, eff), tpv.tail_counts(solo.observed,
                                           solo.nulls[:solo.completed])))
        assert g["completed"] == solo.completed
        if adaptive:
            assert np.array_equal(g["n_perm_used"], solo.n_perm_used)
        # each request's rows of a union bucket are observed as one batch
        # of their own, the solo engine's bucket
        assert np.array_equal(g["observed"], solo.observed)


@pytest.mark.parametrize("config", [dict(), dict(network_from_correlation=2.0)],
                         ids=["stored", "derived"])
def test_pack_props_are_the_solo_engines(cohorts, config):
    """A shared-discovery pack builds each request's segment of a union
    bucket as that request's solo engine builds its bucket: every
    module's discovery props equal its solo engine's bit for bit (the
    kernels then compute each cell from the solo operands)."""
    network, correlation, data, built = cohorts
    if config:
        network = {n: np.abs(correlation[n]) ** 2 for n in correlation}
    tp, _ = _plans(built, "a", "c")
    cfg = EngineConfig(chunk_size=CHUNK, **config)
    te = tpk.PackedEngine(*_mats(network, correlation, data, "a"),
                          *_mats(network, correlation, data, "c"),
                          [p.specs for p in tp], tp[0].pool, config=cfg,
                          device="cpu")
    for g, p in enumerate(tp):
        solo = teng.PermutationEngine(
            *_mats(network, correlation, data, "a"),
            *_mats(network, correlation, data, "c"), p.specs, p.pool,
            config=cfg, device="cpu")
        rows = {}
        for b in solo.buckets:
            for r, k in enumerate(b.module_pos):
                rows[int(k)] = [x[r] for x in b.disc]
        for b in te.buckets:
            for r, pos in enumerate(b.module_pos):
                k = int(pos) - p.base
                if 0 <= k < p.k:
                    for got, want in zip((x[r] for x in b.disc), rows[k]):
                        assert torch.equal(got, want), (g, k)


def test_grid_pack_matches_jax(cohorts):
    """One test cohort, one discovery source per request (a grid
    column)."""
    network, correlation, data, built = cohorts
    reqs = [REQUESTS[0], REQUESTS[1]]
    tp, _ = _plans(built, "a", "c", reqs)
    tp_b, _ = _plans(built, "b", "c", reqs)
    tp = [tp[0], tp_b[1]]
    _, jp = _plans(built, "a", "c", reqs)
    _, jp_b = _plans(built, "b", "c", reqs)
    jp = [jp[0], jp_b[1]]
    tpk.assign_bases(tp)
    jpk.assign_bases(jp)
    srcs = [_mats(network, correlation, data, n) for n in ("a", "b")]
    test = _mats(network, correlation, data, "c")
    cache = teng.ObservedCache()
    te = tpk.GridPackedEngine(srcs, *test, [p.specs for p in tp], tp[0].pool,
                              config=EngineConfig(chunk_size=CHUNK),
                              device="cpu", observed_cache=cache)
    jcache = jeng.ObservedCache()
    je = jpk.GridPackedEngine(srcs, *test, [p.specs for p in jp], jp[0].pool,
                              config=JConfig(chunk_size=CHUNK,
                                             autotune=False),
                              observed_cache=jcache)
    for r, (g, w) in enumerate(zip(tpk.run_pack(te, tp),
                                   jpk.run_pack(je, jp))):
        assert_same_request(g, w, r)
    assert cache.stats() == jcache.stats()
    # the engine keeps no discovery matrix
    assert te._disc_sources is None


def test_data_only_pack_matches_jax(cohorts):
    network, correlation, data, built = cohorts
    tp, jp = _plans(built, "a", "c", REQUESTS[:2])
    te = tpk.PackedEngine(None, None, data["a"], None, None, data["c"],
                          [p.specs for p in tp], tp[0].pool,
                          config=EngineConfig(chunk_size=CHUNK,
                                              network_from_correlation=2.0),
                          device="cpu")
    je = jpk.PackedEngine(None, None, data["a"], None, None, data["c"],
                          [p.specs for p in jp], jp[0].pool,
                          config=JConfig(chunk_size=CHUNK, autotune=False,
                                         network_from_correlation=2.0))
    assert te.data_only
    for r, (g, w) in enumerate(zip(tpk.run_pack(te, tp),
                                   jpk.run_pack(je, jp))):
        assert_same_request(g, w, r)


# ---------------------------------------------------------------------------
# The monitor: deadlines, costs, checkpoints
# ---------------------------------------------------------------------------

class FakeClock:
    """Advances one second a reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_deadlines_on_a_fake_clock(cohorts):
    """Request 1 expires at the second chunk boundary (its survivors leave
    the dispatch); the others run on as in the JAX pack."""
    deadlines = [None, 1.5, None]
    tp, jp = _plans(cohorts[3], "a", "c", deadlines=deadlines)
    te, je = _engines(cohorts, tp, jp)
    got = tpk.run_pack(te, tp, clock=FakeClock())
    want = jpk.run_pack(je, jp, clock=FakeClock())
    assert got[1]["expired"] and got[1]["deadline_miss_s"] == 0.5
    assert got[1]["deadline_miss_s"] == want[1]["deadline_miss_s"]
    for r, (g, w) in enumerate(zip(got, want)):
        assert_same_request(g, w, r)


def test_costs_sum_exactly_to_the_pack_totals(cohorts, tmp_path):
    from netrep_tpu_torch.utils.telemetry import Telemetry

    tp, _ = _plans(cohorts[3], "a", "c")
    te = _port_engine(cohorts, tp)
    tel = Telemetry(str(tmp_path / "run.jsonl"), watchdog_poll_s=0)
    try:
        got = tpk.run_pack(te, tp, telemetry=tel)
    finally:
        tel.close()
    totals = got[0]["cost"]["pack_totals"]
    for f in tpk.PackMonitor.COST_FIELDS:
        s = type(totals[f])(0)
        for g in got:
            s += g["cost"][f]
        assert s == totals[f], f
    # the integer shares: live modules × permutations of each chunk
    assert [g["cost"]["perms"] for g in got] == [48, 64, 32]
    assert totals["device_s"] > 0


def test_monitor_state_and_interrupted_pack_resume(cohorts, tmp_path,
                                                   monkeypatch):
    """An interrupt after two chunks keeps a checkpoint (the pack
    monitor's state in its extras, the JAX package's keys); the same pack
    resumes to the uninterrupted result."""
    tp, jp = _plans(cohorts[3], "a", "c")
    te = _port_engine(cohorts, tp)
    full = tpk.run_pack(te, tp)
    mon = tpk.PackMonitor(tp, np.zeros((sum(p.k for p in tp), 7)))
    jmon = jpk.PackMonitor(jp, np.zeros((sum(p.k for p in jp), 7)))
    assert sorted(mon.state_arrays()) == sorted(jmon.state_arrays())

    ck = str(tmp_path / "pack.npz")
    real = tpk.PackMonitor.update
    calls = []

    def interrupted(self, vals, take):
        calls.append(take)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return real(self, vals, take)

    monkeypatch.setattr(tpk.PackMonitor, "update", interrupted)
    part = tpk.run_pack(te, tp, checkpoint_path=ck, checkpoint_every=1)
    monkeypatch.setattr(tpk.PackMonitor, "update", real)
    assert not part[0]["finished"]
    assert part[1]["completed"] == 3 * CHUNK
    resumed = tpk.run_pack(te, tp, checkpoint_path=ck, checkpoint_every=1)
    for r, (g, w) in enumerate(zip(resumed, full)):
        assert_same_request(g, w, r)
    with pytest.raises(ValueError, match="no pack-monitor state"):
        mon.restore_state({})


# ---------------------------------------------------------------------------
# Refusals: the JAX package's texts
# ---------------------------------------------------------------------------

def _error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e), str(e)
    raise AssertionError("no refusal")


REFUSALS = ["row", "mesh", "gather_fused", "oversubscribed", "empty",
            "sources", "materialized", "presence", "keys"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_match_jax(cohorts, case):
    from netrep_tpu.parallel.mesh import make_mesh as jmesh

    from netrep_tpu_torch.parallel.mesh import make_mesh

    network, correlation, data, built = cohorts
    tp, jp = _plans(built, "a", "c")
    dm = _mats(network, correlation, data, "a")
    tmat = _mats(network, correlation, data, "c")

    def packed(pk, plans, cfg, **kw):
        return lambda: pk.PackedEngine(*dm, *tmat, [p.specs for p in plans],
                                       plans[0].pool, config=cfg, **kw)

    def grid(pk, plans, cfg, srcs, test=tmat, n=None, **kw):
        return lambda: pk.GridPackedEngine(
            srcs, *test, [p.specs for p in plans][:n], plans[0].pool,
            config=cfg, **kw)

    tc, jc = EngineConfig(chunk_size=CHUNK), JConfig(chunk_size=CHUNK,
                                                      autotune=False)
    big = [m for p in tp for m in p.specs]
    jbig = [m for p in jp for m in p.specs]
    nodata = (dm[0], dm[1], None)
    port, jax_ = {
        "row": (packed(tpk, tp, EngineConfig(matrix_sharding="row")),
                packed(jpk, jp, JConfig(matrix_sharding="row",
                                        autotune=False))),
        "mesh": (packed(tpk, tp, tc, mesh=make_mesh(
                     1, 1, devices=[CPU]), device="cpu"),
                 packed(jpk, jp, jc, mesh=jmesh(1, 1))),
        "gather_fused": (packed(tpk, tp, EngineConfig(gather_mode="fused"),
                                device="cpu"),
                         packed(jpk, jp, JConfig(gather_mode="fused",
                                                 autotune=False))),
        "oversubscribed": (
            lambda: tpk.PackedEngine(*dm, *tmat, [tp[0].specs, big],
                                     tp[0].pool, config=tc, device="cpu"),
            lambda: jpk.PackedEngine(*dm, *tmat, [jp[0].specs, jbig],
                                     jp[0].pool, config=jc)),
        "empty": (lambda: tpk.PackedEngine(*dm, *tmat, [[], []], tp[0].pool,
                                           config=tc, device="cpu"),
                  lambda: jpk.PackedEngine(*dm, *tmat, [[], []], jp[0].pool,
                                           config=jc)),
        "sources": (grid(tpk, tp, tc, [dm], device="cpu"),
                    grid(jpk, jp, jc, [dm])),
        "materialized": (grid(tpk, tp, tc, [(None, None, dm[2])] * 3,
                              device="cpu"),
                         grid(jpk, jp, jc, [(None, None, dm[2])] * 3)),
        "presence": (grid(tpk, tp, tc, [dm, nodata, dm], device="cpu"),
                     grid(jpk, jp, jc, [dm, nodata, dm])),
        "keys": (lambda: _port_engine(cohorts, tp).run_null(8, [1, 2]),
                 lambda: packed(jpk, jp, jc)().run_null(8, [1, 2])),
    }[case]
    assert _error(port) == _error(jax_)
