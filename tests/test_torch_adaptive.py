"""The port's adaptive (sequential early-stopping) nulls against the JAX
package's on the same inputs and seed.

The stop monitor is a host copy (``netrep_tpu_torch.ops.sequential``) and
is held EXACTLY to the JAX package's on the same count sequences. The
engines — single-test and multi-test, materialized and streaming — give
the JAX package's ``completed``, per-module ``n_perm_used``, counts and
p-values exactly on the mixed fixture (``make_mixed_pair(320, 6,
n_samples=40, seed=7)``, chunk 64, the JAX test's config); null values
agree within ``tests/test_torch_engine.py``'s documented tolerance
(1e-5 for at least 99.9% of them, all within 1e-4). Within the port, an
active module's re-bucketed rows equal the fixed run's rows at the same
indices within 1e-6 (on the CPU they are in fact equal; on the card each
(permutation, module) cell is one block of the kernel, whatever the
bucket's size), a resumed adaptive run equals the uninterrupted one, and
``module_preservation(adaptive=True)`` gives the JAX package's results,
``save``/``load`` and ``combine_analyses`` included.

Not held: bit-identity across re-bucketing in the JAX package's own
CPU runs (its float32 batches round differently by shape), nor
"adaptive decisions equal the fixed run's" on the toy fixture, where a
borderline module is decided differently by a sequential rule."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

import netrep_tpu  # noqa: E402
from netrep_tpu.data import make_mixed_pair, pair_frames  # noqa: E402
from netrep_tpu.models.results import PreservationResult as JResult  # noqa: E402
from netrep_tpu.ops import pvalues as jpv  # noqa: E402
from netrep_tpu.ops import sequential as jseq  # noqa: E402
from netrep_tpu.parallel.engine import ModuleSpec as JSpec  # noqa: E402
from netrep_tpu.parallel.engine import PermutationEngine as JEngine  # noqa: E402
from netrep_tpu.parallel.multitest import MultiTestEngine as JMulti  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.models.results import (  # noqa: E402
    PreservationResult, combine_analyses,
)
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402
from netrep_tpu_torch.ops import sequential as tseq  # noqa: E402
from netrep_tpu_torch.parallel.engine import ModuleSpec  # noqa: E402
from netrep_tpu_torch.parallel.engine import PermutationEngine  # noqa: E402
from netrep_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from netrep_tpu_torch.parallel.multitest import MultiTestEngine  # noqa: E402
from netrep_tpu_torch.utils import checkpoint as tck  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

N_PERM = 1200
CFG = dict(chunk_size=64, summary_method="eigh")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: beside other test
    processes, torch's per-core thread pool only contends for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mixed():
    return make_mixed_pair(320, 6, n_samples=40, seed=7)


def _mats(mixed):
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    return dc, dn, dd, tc, tn, td


def _port(mixed, mesh=None, **cfg):
    return PermutationEngine(
        *_mats(mixed), [ModuleSpec(lab, i, i) for lab, i in mixed["specs"]],
        mixed["pool"], config=EngineConfig(**{**CFG, **cfg}), device="cpu",
        mesh=mesh)


def _jax(mixed):
    return JEngine(*_mats(mixed),
                   [JSpec(lab, i, i) for lab, i in mixed["specs"]],
                   mixed["pool"], config=JConfig(**CFG, autotune=False))


def assert_null_close(got, want):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    diff = np.abs(got - want)[~np.isnan(want)]
    assert diff.max() <= 1e-4, diff.max()
    assert np.mean(diff <= 1e-5) >= 0.999


@pytest.fixture(scope="module")
def runs(mixed):
    """The JAX package's adaptive runs (both modes) and the port's, each on
    its own engine and observed statistics, plus the port's fixed run."""
    je, te = _jax(mixed), _port(mixed)
    obs_j, obs_t = np.asarray(je.observed()), te.observed()
    nj, dj, fj = je.run_null_adaptive(N_PERM, obs_j, key=0)
    nt, dt, ft = te.run_null_adaptive(N_PERM, obs_t, key=0)
    nulls_f, done_f = te.run_null(N_PERM, key=0)
    return dict(
        obs_j=obs_j, obs_t=obs_t, jax=(np.asarray(nj), dj, fj),
        port=(nt, dt, ft), fixed=(nulls_f, done_f),
        jax_stream=je.run_null_adaptive_streaming(N_PERM, obs_j, key=0),
        port_stream=te.run_null_adaptive_streaming(N_PERM, obs_t, key=0),
    )


# ---------------------------------------------------------------------------
# The stop monitor: a host copy, held exactly
# ---------------------------------------------------------------------------

def _monitor_pair(obs, alternative, rule):
    return (tseq.StopMonitor(obs, alternative, tseq.StopRule(**rule)),
            jseq.StopMonitor(obs, alternative, jseq.StopRule(**rule)))


def _same_state(t, j):
    for a, b in zip(sorted(t.state_arrays().items()),
                    sorted(j.state_arrays().items())):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("alternative", ("greater", "less", "two.sided"))
@pytest.mark.parametrize("fold", ("update", "update_counts"))
def test_stop_monitor_equals_jax(alternative, fold):
    """Random null chunks (NaN cells and a NaN observed cell included),
    folded chunk by chunk into both monitors: the same retirements, tallies
    and state after every chunk, and across a state round trip."""
    rng = np.random.default_rng(4)
    obs = rng.normal(0, 1, (9, 7))
    obs[:3] += 3.0
    obs[3:6] -= 3.0
    obs[8, 2] = np.nan
    rule = dict(h=6, alpha=0.05, confidence=0.99, min_perms=32)
    t, j = _monitor_pair(obs, alternative, rule)
    for step in range(12):
        pos = t.active_positions()
        np.testing.assert_array_equal(pos, j.active_positions())
        if not pos.size:
            break
        vals = rng.normal(0, 1, (16, pos.size, 7))
        vals[rng.random(vals.shape) < 0.01] = np.nan
        if fold == "update":
            got, want = t.update(vals, 16), j.update(vals, 16)
        else:
            o = obs[pos][None]
            with np.errstate(invalid="ignore"):
                hi, lo = (vals >= o).sum(0), (vals <= o).sum(0)
            eff = (~np.isnan(vals)).sum(0)
            got = t.update_counts(hi, lo, 16, eff=eff)
            want = j.update_counts(hi, lo, 16, eff=eff)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t.counts(), j.counts())
        _same_state(t, j)
        assert t.total_evaluated() == j.total_evaluated()
    t2, j2 = _monitor_pair(obs, alternative, rule)
    t2.restore_state(j.state_arrays())
    j2.restore_state(t.state_arrays())
    _same_state(t2, j2)


def test_stop_monitor_priors_and_errors_equal_jax():
    obs = np.zeros((3, 7))
    rule = dict(h=4, min_perms=8)
    t, j = _monitor_pair(obs, "greater", rule)
    prior = (np.full((3, 7), 40), np.zeros((3, 7), int), np.full(3, 50))
    t.seed_priors(*prior)
    j.seed_priors(*prior)
    vals = np.full((8, 3, 7), -1.0)
    np.testing.assert_array_equal(t.update(vals, 8), j.update(vals, 8))
    _same_state(t, j)

    def text(fn):
        with pytest.raises(ValueError) as err:
            fn()
        return str(err.value)

    for kw in (dict(h=0), dict(alpha=1.5), dict(confidence=0.2),
               dict(min_perms=0)):
        assert text(lambda: tseq.StopRule(**kw)) == text(
            lambda: jseq.StopRule(**kw))
    assert text(lambda: tseq.StopMonitor(obs, "sideways", tseq.StopRule())) \
        == text(lambda: jseq.StopMonitor(obs, "sideways", jseq.StopRule()))
    for m in (t, j):
        assert "before any chunk" in text(lambda: m.seed_priors(*prior))
    assert text(lambda: tseq.StopMonitor(obs, "greater", tseq.StopRule())
                .restore_state({})) == text(
        lambda: jseq.StopMonitor(obs, "greater", jseq.StopRule())
        .restore_state({}))


# ---------------------------------------------------------------------------
# Engines against the JAX package
# ---------------------------------------------------------------------------

def test_adaptive_materialized_equals_jax(runs):
    (nj, dj, fj), (nt, dt, ft) = runs["jax"], runs["port"]
    assert fj and ft and dt == dj
    np.testing.assert_array_equal(tpv.effective_nperm(nt[:dt]),
                                  jpv.effective_nperm(nj[:dj]))
    assert_null_close(nt, nj)
    for a, b in zip(tpv.tail_counts(runs["obs_t"], nt[:dt]),
                    jpv.tail_counts(runs["obs_j"], nj[:dj])):
        np.testing.assert_array_equal(a, b)
    pt, ut = tpv.sequential_pvalues(runs["obs_t"], nt[:dt])
    pj, uj = jpv.sequential_pvalues(runs["obs_j"], nj[:dj])
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ut, uj)
    # the fixture retires modules early: this is a real adaptive run
    assert ut.sum() * 2 < N_PERM * ut.size


def test_adaptive_streaming_equals_jax_and_materialized(runs):
    st, sj = runs["port_stream"], runs["jax_stream"]
    assert st.finished and sj.finished
    assert st.completed == sj.completed == runs["port"][1]
    for f in ("hi", "lo", "eff", "n_perm_used"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f))
    nt, dt, _ = runs["port"]
    np.testing.assert_array_equal(st.n_perm_used,
                                  tpv.effective_nperm(nt[:dt]))
    for a, b in zip((st.hi, st.lo, st.eff),
                    tpv.tail_counts(runs["obs_t"], nt[:dt])):
        np.testing.assert_array_equal(a, b)


def test_rebucketed_rows_equal_fixed_run(runs):
    """An active module's rows equal the port's fixed run's at the same
    permutation indices across every re-bucketing, NaN past retirement."""
    nt, dt, _ = runs["port"]
    nulls_f, _ = runs["fixed"]
    for m, k in enumerate(tpv.effective_nperm(nt[:dt])):
        np.testing.assert_allclose(nt[:k, m], nulls_f[:k, m], rtol=0,
                                   atol=1e-6)
        assert np.isnan(nt[k:, m]).all()


@pytest.mark.parametrize("kind", ("perm2x1", "row1x4"))
def test_adaptive_on_a_mesh_equals_unsplit(mixed, runs, kind):
    """Retirement re-buckets the shard views too: on a mesh the run retires
    the same modules at the same counts as the unsplit engine."""
    mesh, cfg = ((make_mesh(2, 1, devices=[CPU] * 2), {}) if kind == "perm2x1"
                 else (make_mesh(1, 4, devices=[CPU] * 4),
                       {"matrix_sharding": "row", "summary_method": "power"}))
    eng = _port(mixed, mesh=mesh, **cfg)
    ref = runs["port"] if kind == "perm2x1" else _port(
        mixed, summary_method="power").run_null_adaptive(
        N_PERM, runs["obs_t"], key=0)
    nulls, done, fin = eng.run_null_adaptive(N_PERM, runs["obs_t"], key=0)
    assert fin and done == ref[1]
    np.testing.assert_array_equal(tpv.effective_nperm(nulls[:done]),
                                  tpv.effective_nperm(ref[0][:done]))
    assert_null_close(nulls, ref[0])
    assert sum(len(b.module_pos) for b in eng.buckets) == eng.n_modules


def test_rebucket_validation_and_restore(mixed):
    eng = _port(mixed)
    full = [(b.cap, list(b.module_pos)) for b in eng.buckets]
    with pytest.raises(ValueError, match="at least one"):
        eng.rebucket([])
    with pytest.raises(ValueError, match="unknown module positions"):
        eng.rebucket([99])
    eng.rebucket([0, 4])
    assert sorted(p for b in eng.buckets for p in b.module_pos) == [0, 4]
    for b in eng.buckets:
        assert b.take.shape[0] == b.obs_idx.shape[0] == len(b.module_pos)
        assert b.disc.mask.shape[0] == len(b.module_pos)
    eng.rebucket(range(eng.n_modules))
    assert [(b.cap, list(b.module_pos)) for b in eng.buckets] == full


# ---------------------------------------------------------------------------
# Checkpoints of the adaptive loops
# ---------------------------------------------------------------------------

def _stop_after(n):
    calls = []

    def progress(done, total):
        calls.append(done)
        if len(calls) == n:
            raise KeyboardInterrupt

    return progress


@pytest.mark.parametrize("store_nulls", (True, False))
def test_adaptive_resume_equals_uninterrupted(mixed, runs, tmp_path,
                                              store_nulls):
    path = str(tmp_path / "adaptive.npz")
    obs = runs["obs_t"]

    def run(**kw):
        eng = _port(mixed)
        if store_nulls:
            return eng.run_null_adaptive(N_PERM, obs, key=0, **kw)
        s = eng.run_null_adaptive_streaming(N_PERM, obs, key=0, **kw)
        return s, s.completed, s.finished

    part = run(progress=_stop_after(3), checkpoint_path=path,
               checkpoint_every=64)
    assert not part[2] and part[1] == 192
    got = run(checkpoint_path=path, checkpoint_every=64)
    assert got[2] and got[1] == runs["port"][1]
    if store_nulls:
        np.testing.assert_array_equal(got[0], runs["port"][0])
    else:
        want = runs["port_stream"]
        for f in ("hi", "lo", "eff", "n_perm_used"):
            np.testing.assert_array_equal(getattr(got[0], f),
                                          getattr(want, f))


def test_adaptive_resume_folds_the_written_gap(mixed, runs, tmp_path):
    """A checkpoint whose null holds a chunk the monitor has not folded
    (an interrupt between the write and the fold) is folded on resume, so
    the run decides as an uninterrupted one."""
    obs = runs["obs_t"]
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    for path, n in ((a, 1), (b, 2)):
        _port(mixed).run_null_adaptive(N_PERM, obs, key=0,
                                       progress=_stop_after(n),
                                       checkpoint_path=path)
    ca, cb = tck.load_null_checkpoint(a), tck.load_null_checkpoint(b)
    assert (ca["completed"], cb["completed"]) == (64, 128)
    gap = str(tmp_path / "gap.npz")
    tck.save_null_checkpoint(gap, cb["nulls"], 128, cb["key_data"],
                             cb["fingerprint"], extra=ca["extras"])
    nulls, done, fin = _port(mixed).run_null_adaptive(
        N_PERM, obs, key=0, checkpoint_path=gap)
    assert fin and done == runs["port"][1]
    np.testing.assert_array_equal(nulls, runs["port"][0])


def test_adaptive_refuses_fixed_run_checkpoint(mixed, runs, tmp_path):
    path = str(tmp_path / "fixed.npz")
    _port(mixed).run_null(128, key=3, checkpoint_path=path)
    with pytest.raises(ValueError, match="non-adaptive"):
        _port(mixed).run_null_adaptive(N_PERM, runs["obs_t"], key=3,
                                       checkpoint_path=path)
    spath = str(tmp_path / "fixed_stream.npz")
    _port(mixed).run_null_streaming(128, runs["obs_t"], key=3,
                                    checkpoint_path=spath)
    with pytest.raises(ValueError, match="non-adaptive"):
        _port(mixed).run_null_adaptive_streaming(
            N_PERM, runs["obs_t"], key=3, checkpoint_path=spath)


def test_adaptive_resumes_a_jax_checkpoint(mixed, runs, tmp_path):
    """The JAX package's adaptive checkpoint (monitor state in the extras)
    resumes in the port to the same retirements and p-values."""
    path = str(tmp_path / "jax.npz")
    _jax(mixed).run_null_adaptive(N_PERM, runs["obs_j"], key=0,
                                  progress=_stop_after(3),
                                  checkpoint_path=path)
    nulls, done, fin = _port(mixed).run_null_adaptive(
        N_PERM, runs["obs_j"], key=0, checkpoint_path=path)
    nj, dj, _ = runs["jax"]
    assert fin and done == dj
    np.testing.assert_array_equal(
        tpv.sequential_pvalues(runs["obs_j"], nulls[:done])[0],
        jpv.sequential_pvalues(runs["obs_j"], nj[:dj])[0])


# ---------------------------------------------------------------------------
# The multi-test engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cohorts():
    mixed = make_mixed_pair(200, 4, n_samples=36, seed=5)
    (dd, dc, dn) = mixed["discovery"]
    (td, tc, tn) = mixed["test"]
    (td2, tc2, tn2) = make_mixed_pair(200, 4, n_samples=36, seed=6)["test"]
    return dict(disc=(dc, dn, dd), corrs=[tc, tc2], nets=[tn, tn2],
                datas=[td, td2], specs=mixed["specs"], pool=mixed["pool"])


@pytest.mark.parametrize("store_nulls", (True, False))
def test_multitest_adaptive_equals_jax(cohorts, store_nulls):
    c = cohorts
    port = MultiTestEngine(*c["disc"], c["corrs"], c["nets"], c["datas"],
                           [ModuleSpec(lab, i, i) for lab, i in c["specs"]],
                           c["pool"], EngineConfig(**CFG), device="cpu")
    jax_e = JMulti(*c["disc"], np.stack(c["corrs"]), np.stack(c["nets"]),
                   c["datas"], [JSpec(lab, i, i) for lab, i in c["specs"]],
                   c["pool"], config=JConfig(**CFG, autotune=False))
    obs_t, obs_j = port.observed(), np.asarray(jax_e.observed())
    if store_nulls:
        nt, dt, ft = port.run_null_adaptive(600, obs_t, key=0)
        nj, dj, fj = jax_e.run_null_adaptive(600, obs_j, key=0)
        nj = np.asarray(nj)
        assert ft and fj and dt == dj
        assert_null_close(nt, nj)
        for ti in range(2):
            pt, ut = tpv.sequential_pvalues(obs_t[ti], nt[ti, :dt])
            pj, uj = jpv.sequential_pvalues(obs_j[ti], nj[ti, :dj])
            np.testing.assert_array_equal(pt, pj)
            np.testing.assert_array_equal(ut, uj)
        assert ut.sum() < 600 * ut.size
        return
    st = port.run_null_adaptive_streaming(600, obs_t, key=0)
    sj = jax_e.run_null_adaptive_streaming(600, obs_j, key=0)
    assert st.finished and st.completed == sj.completed
    for f in ("hi", "lo", "eff", "n_perm_used"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f))
    assert st.hi.shape == (2, 4, 7)


# ---------------------------------------------------------------------------
# module_preservation(adaptive=True) and the sequential result surface
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames(toy_pair_module):
    d, t = pair_frames(toy_pair_module)
    return dict(
        network={"disc": d["network"], "test": t["network"]},
        data={"disc": d["data"], "test": t["data"]},
        correlation={"disc": d["correlation"], "test": t["correlation"]},
        module_assignments=dict(toy_pair_module["labels"]),
        discovery="disc", test="test", n_perm=600, seed=11,
    )


def _both(frames, **kw):
    kw = {**frames, **kw}
    return (module_preservation(**kw, config=EngineConfig(chunk_size=64),
                                device="cpu"),
            netrep_tpu.module_preservation(
                **kw, config=JConfig(chunk_size=64, autotune=False)))


@pytest.mark.parametrize("store_nulls", (True, False))
def test_module_preservation_adaptive_equals_jax(frames, store_nulls):
    rt, rj = _both(frames, adaptive=True, store_nulls=store_nulls)
    assert rt.p_type == rj.p_type == "sequential"
    np.testing.assert_array_equal(rt.n_perm_used, rj.n_perm_used)
    np.testing.assert_array_equal(rt.p_values, rj.p_values)
    assert rt.completed == rj.completed
    assert rt.preserved_modules() == rj.preserved_modules()
    np.testing.assert_array_equal(rt.module_n_perm(), rt.n_perm_used)
    frame = rt.to_frame()
    np.testing.assert_array_equal(frame["n_perm_used"].to_numpy(),
                                  np.repeat(rt.n_perm_used, 7))
    if store_nulls:
        assert_null_close(rt.nulls, np.asarray(rj.nulls))
    else:
        for f in ("counts_hi", "counts_lo", "counts_eff"):
            np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f))


def test_adaptive_rule_and_priors_equal_jax(frames):
    rule = dict(h=8, min_perms=64)
    kw = dict(frames, adaptive=True)
    rt = module_preservation(**kw, adaptive_rule=tseq.StopRule(**rule),
                             config=EngineConfig(chunk_size=64), device="cpu")
    rj = netrep_tpu.module_preservation(
        **kw, adaptive_rule=jseq.StopRule(**rule),
        config=JConfig(chunk_size=64, autotune=False))
    np.testing.assert_array_equal(rt.n_perm_used, rj.n_perm_used)
    np.testing.assert_array_equal(rt.p_values, rj.p_values)
    hi, lo, _eff = tpv.tail_counts(rt.observed, rt.nulls)
    wt, wj = _both(frames, adaptive=True, seed=3,
                   adaptive_priors=(hi, lo, rt.n_perm_used))
    np.testing.assert_array_equal(wt.n_perm_used, wj.n_perm_used)
    np.testing.assert_array_equal(wt.p_values, wj.p_values)


@pytest.mark.parametrize("case", ("not_adaptive", "streaming", "two_pairs"))
def test_adaptive_priors_errors_equal_jax(frames, case):
    prior = (np.zeros((3, 7)), np.zeros((3, 7)), np.full(3, 10))
    kw = dict(frames, n_perm=64, adaptive=case != "not_adaptive",
              adaptive_priors=prior)
    if case == "streaming":
        kw["store_nulls"] = False
    if case == "two_pairs":
        kw["test"] = ["test", "disc"]
        kw["discovery"] = ["disc", "test"]

    with pytest.raises(ValueError) as jerr:
        netrep_tpu.module_preservation(**kw)
    with pytest.raises(ValueError) as terr:
        module_preservation(**kw, device="cpu")
    # the port's default backend is 'torch' where the JAX package's is 'jax'
    assert str(terr.value) == str(jerr.value).replace("'jax'", "'torch'")


def test_sequential_save_load_combine(frames, tmp_path):
    """A sequential result round-trips through ``save``/``load`` and pools
    with ``combine_analyses`` (per-module counts summed); a JAX-written
    sequential file loads to the same fields."""
    rt, rj = _both(frames, adaptive=True)
    path = str(tmp_path / "seq.npz")
    rt.save(path)
    back = PreservationResult.load(path)
    assert back.p_type == "sequential"
    np.testing.assert_array_equal(back.n_perm_used, rt.n_perm_used)
    np.testing.assert_array_equal(back.nulls, rt.nulls)
    assert JResult.load(path).p_type == "sequential"
    jpath = str(tmp_path / "jax_seq.npz")
    rj.save(jpath)
    jback = PreservationResult.load(jpath)
    assert jback.p_type == "sequential"
    np.testing.assert_array_equal(jback.n_perm_used, rj.n_perm_used)
    np.testing.assert_array_equal(jback.p_values, rj.p_values)

    other_t, other_j = _both(frames, adaptive=True, seed=12)
    comb = combine_analyses(rt, other_t)
    assert comb.p_type == "sequential"
    np.testing.assert_array_equal(comb.n_perm_used,
                                  rt.n_perm_used + other_t.n_perm_used)
    np.testing.assert_array_equal(comb.n_perm_used,
                                  tpv.effective_nperm(comb.nulls))
    from netrep_tpu.models.results import combine_analyses as jcombine

    jcomb = jcombine(rj, other_j)
    np.testing.assert_array_equal(comb.p_values, jcomb.p_values)
    np.testing.assert_array_equal(comb.n_perm_used, jcomb.n_perm_used)
    # a streaming sequential result pools in count space
    st, _ = _both(frames, adaptive=True, store_nulls=False, seed=12)
    mixed_comb = combine_analyses(rt, st)
    assert mixed_comb.nulls is None and mixed_comb.p_type == "sequential"
    np.testing.assert_array_equal(mixed_comb.n_perm_used,
                                  rt.n_perm_used + st.n_perm_used)


def test_vmap_tests_adaptive_equals_jax(cohorts):
    """``module_preservation(vmap_tests=True, adaptive=True)``: one shared
    draw for both cohorts, a module retiring only when decided in both —
    streaming, each pair's ``n_perm_used``, counts and p-values equal the
    JAX package's; materialized (which the JAX package's entry point
    cannot run: it passes ``priors=`` to its multi-test engine, ROADMAP.md
    Queue 3) equal to the streaming run."""
    c = cohorts
    labels = np.zeros(200, dtype=int)
    for k, (_lab, idx) in enumerate(c["specs"]):
        labels[idx] = k + 1
    kw = dict(network={"d": c["disc"][1], "t1": c["nets"][0],
                       "t2": c["nets"][1]},
              correlation={"d": c["disc"][0], "t1": c["corrs"][0],
                           "t2": c["corrs"][1]},
              data={"d": c["disc"][2], "t1": c["datas"][0],
                    "t2": c["datas"][1]},
              module_assignments=labels, discovery="d", test=["t1", "t2"],
              vmap_tests=True, adaptive=True, n_perm=600, seed=4)
    rt = module_preservation(**kw, store_nulls=False, device="cpu",
                             config=EngineConfig(chunk_size=64))
    rj = netrep_tpu.module_preservation(
        **kw, store_nulls=False, config=JConfig(chunk_size=64,
                                                autotune=False))
    rm = module_preservation(**kw, device="cpu",
                             config=EngineConfig(chunk_size=64))
    for t in ("t1", "t2"):
        assert rt[t].p_type == rj[t].p_type == rm[t].p_type == "sequential"
        for r in (rj[t], rm[t]):
            np.testing.assert_array_equal(rt[t].n_perm_used, r.n_perm_used)
            np.testing.assert_array_equal(rt[t].p_values, r.p_values)
        for f in ("counts_hi", "counts_lo", "counts_eff"):
            np.testing.assert_array_equal(getattr(rt[t], f),
                                          getattr(rj[t], f))
    np.testing.assert_array_equal(rt["t1"].n_perm_used, rt["t2"].n_perm_used)
