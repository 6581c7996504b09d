"""The port's screened null (``null_precision='bf16_rescue'``) and
generalized-Pareto tail p-values against the JAX package on the same numpy
inputs, ``device="cpu"`` (the mirror of ``tests/test_screened_null.py``).

What must hold, exactly (no tolerance): the screened run's counts,
p-values and adaptive retirements equal the port's float32 run's and the
JAX package's screened run's; its rescued rows equal the float32 rows bit
for bit and its decided rows equal a float32 run on bf16-rounded test
operands; the cushion, ambiguity, worklist and tally helpers equal the JAX
package's on the same arrays; ``gpd_tail_pvalues`` equals the JAX
function bit for bit; result files cross packages with every field. Two
regimes, as in the JAX tests: the engine's observed statistics (most
permutations land in the cushion band and are rescued) and observed +
1.0 (most are decided in the fast pass, a few rescued: the cushion scales
with the data's amplitude, 6.2 here, so the JAX tests' +0.5 leaves most
permutations in the band).

One tolerance, not exact: GPD tail p-values end to end. The fit is a
continuous function of the null values, and the two packages' nulls differ
by up to 7.5e-6 (the documented engine tolerance), so on
``make_example_pair(default_rng(3))`` at 200 permutations, seeds 0–5,
``p_tail`` differs by up to 4.29e-4 relative (seed 2). The end-to-end test
holds it within 2e-3 relative (a margin of 4.7×), with ``tail_ok``, the NaN
pattern, the zeros and the permutation p-values equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.stats as st  # noqa: E402

import netrep_tpu  # noqa: E402
from netrep_tpu.data import make_mixed_pair  # noqa: E402
from netrep_tpu.models.results import PreservationResult as JResult  # noqa: E402
from netrep_tpu.ops import pvalues as jpv  # noqa: E402
from netrep_tpu.parallel import screened as jscr  # noqa: E402
from netrep_tpu.parallel.engine import ModuleSpec as JSpec  # noqa: E402
from netrep_tpu.parallel.engine import PermutationEngine as JEngine  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch.data import make_example_pair, pair_frames  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.models.results import PreservationResult  # noqa: E402
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402
from netrep_tpu_torch.parallel import screened as scr  # noqa: E402
from netrep_tpu_torch.parallel.engine import (  # noqa: E402
    ModuleSpec, PermutationEngine, build_discovery,
)
from netrep_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from netrep_tpu_torch.parallel.multitest import MultiTestEngine  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

N_PERM = 96      # chunk 32: three chunks
CHUNK = 32
CPU = torch.device("cpu")
F32 = EngineConfig(chunk_size=CHUNK, stat_mode="xla", superchunk=2)
SCREEN = dataclasses.replace(F32, null_precision="bf16_rescue")
JSCREEN = JConfig(chunk_size=CHUNK, superchunk=2, autotune=False,
                  null_precision="bf16_rescue")


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
    m = make_mixed_pair(320, 6, n_samples=40, seed=7)
    (dd, dc, dn), (td, tc, tn) = m["discovery"], m["test"]
    return dict(mats=(dc, dn, dd, tc, tn, td), specs=m["specs"],
                pool=m["pool"])


def _engine(mixed, config=F32, mesh=None, mats=None):
    specs = [ModuleSpec(lab, idx, idx) for lab, idx in mixed["specs"]]
    return PermutationEngine(*(mats or mixed["mats"]), specs, mixed["pool"],
                             config=config, device="cpu", mesh=mesh)


def _jengine(mixed, config=JSCREEN):
    specs = [JSpec(lab, idx, idx) for lab, idx in mixed["specs"]]
    return JEngine(*mixed["mats"], specs, mixed["pool"], config=config)


@pytest.fixture(scope="module")
def ref(mixed):
    """The port's float32 run, the reference of every screened run."""
    eng = _engine(mixed)
    observed = eng.observed()
    nulls, done = eng.run_null(N_PERM, key=0)
    assert done == N_PERM
    return dict(observed=observed, nulls=nulls)


REGIMES = {"rescue": 0.0, "decided": 1.0}


def _assert_counts(obs, got, want):
    for a, b in zip(tpv.tail_counts(obs, got), tpv.tail_counts(obs, want)):
        np.testing.assert_array_equal(a, b)


# --- materialized ------------------------------------------------------------

@pytest.mark.parametrize("regime", list(REGIMES))
def test_materialized_counts_equal_f32_and_jax(mixed, ref, regime):
    obs = ref["observed"] + REGIMES[regime]
    eng = _engine(mixed, SCREEN)
    nulls, done = eng.run_null(N_PERM, key=0, observed=obs)
    assert done == N_PERM
    _assert_counts(obs, nulls, ref["nulls"])
    np.testing.assert_array_equal(
        tpv.permutation_pvalues(obs, nulls),
        tpv.permutation_pvalues(obs, ref["nulls"]))
    state = eng.last_rescue
    assert state.total == N_PERM and state.dispatches >= 1
    if regime == "rescue":
        assert state.rescued > N_PERM // 2
        jn, _ = _jengine(mixed).run_null(N_PERM, key=0, observed=obs)
        _assert_counts(obs, nulls, np.asarray(jn))
        np.testing.assert_array_equal(
            tpv.permutation_pvalues(obs, nulls),
            jpv.permutation_pvalues(obs, np.asarray(jn)))
    else:
        assert state.rescued < N_PERM // 2
        assert not np.array_equal(nulls, ref["nulls"])  # rows decided


@pytest.mark.parametrize("regime", list(REGIMES))
def test_rescued_rows_are_f32_rows_and_decided_rows_are_rounded(
        mixed, ref, regime):
    """Each stored row is either the float32 run's row (rescued) or the row
    of a float32 run whose test operands were rounded through bfloat16
    beforehand (decided): rounding the gathered blocks equals gathering
    the rounded matrices, bit for bit."""
    obs = ref["observed"] + REGIMES[regime]
    eng = _engine(mixed, SCREEN)
    nulls, _ = eng.run_null(N_PERM, key=0, observed=obs)
    (dc, dn, dd, tc, tn, td) = mixed["mats"]
    specs = [ModuleSpec(lab, idx, idx) for lab, idx in mixed["specs"]]
    buckets = build_discovery(dc, dn, dd, specs, mixed["pool"], F32, CPU)

    def rounded(a):
        return scr.bf16_round(torch.as_tensor(a))

    low = PermutationEngine.from_parts(
        rounded(tc), rounded(tn), rounded(td).T, mixed["pool"], buckets,
        len(specs), F32, device="cpu")
    low_nulls, _ = low.run_null(N_PERM, key=0)
    obs_b, cush_b = eng._screened_obs_cush(obs)
    outs = [torch.as_tensor(low_nulls[:, b.module_pos], dtype=torch.float32)
            for b in eng.buckets]
    amb = scr.ambiguous_perms(outs, obs_b, cush_b).numpy()
    assert amb.sum() == eng.last_rescue.rescued > 0
    np.testing.assert_array_equal(nulls[amb], ref["nulls"][amb])
    np.testing.assert_array_equal(nulls[~amb], low_nulls[~amb])


# --- streaming, adaptive, mesh -----------------------------------------------

@pytest.mark.parametrize("regime", list(REGIMES))
def test_streaming_tallies_equal_f32(mixed, ref, regime):
    obs = ref["observed"] + REGIMES[regime]
    sc = _engine(mixed, SCREEN).run_null_streaming(N_PERM, obs, key=0)
    assert sc.completed == N_PERM
    for got, want in zip((sc.hi, sc.lo, sc.eff),
                         tpv.tail_counts(obs, ref["nulls"])):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["materialized", "streaming"])
def test_adaptive_retirements_equal_f32(mixed, ref, mode):
    obs = ref["observed"]
    f32, scrn = _engine(mixed), _engine(mixed, SCREEN)
    if mode == "materialized":
        fn, fd, ff = f32.run_null_adaptive(320, obs, key=3)
        sn, sd, sf = scrn.run_null_adaptive(320, obs, key=3)
        assert (sd, sf) == (fd, ff)
        np.testing.assert_array_equal(np.isnan(sn), np.isnan(fn))
        _assert_counts(obs, sn, fn)
        np.testing.assert_array_equal(tpv.effective_nperm(sn),
                                      tpv.effective_nperm(fn))
    else:
        a = f32.run_null_adaptive_streaming(320, obs, key=3)
        b = scrn.run_null_adaptive_streaming(320, obs, key=3)
        assert b.completed == a.completed
        for x, y in zip((b.hi, b.lo, b.eff, b.n_perm_used),
                        (a.hi, a.lo, a.eff, a.n_perm_used)):
            np.testing.assert_array_equal(x, y)
    assert scrn.last_rescue.total > 0
    assert len(scrn.buckets) == len(f32.buckets)  # full strength on exit


def test_perm_mesh_counts_equal_f32(mixed, ref):
    obs = ref["observed"]
    mesh = make_mesh(2, 1, devices=[CPU] * 2)
    eng = _engine(mixed, SCREEN, mesh=mesh)
    nulls, done = eng.run_null(N_PERM, key=0, observed=obs)
    assert done == N_PERM
    _assert_counts(obs, nulls, ref["nulls"])
    sc = _engine(mixed, SCREEN, mesh=mesh).run_null_streaming(N_PERM, obs,
                                                             key=0)
    for got, want in zip((sc.hi, sc.lo, sc.eff),
                         tpv.tail_counts(obs, ref["nulls"])):
        np.testing.assert_array_equal(got, want)


# --- checkpoints -------------------------------------------------------------

def _interrupt_after(n):
    seen = []

    def cb(done, total):
        seen.append(done)
        if len(seen) == n:
            raise KeyboardInterrupt

    return cb


def test_streaming_checkpoint_resumes_in_the_port(mixed, ref, tmp_path):
    obs = ref["observed"]
    ck = str(tmp_path / "screened.npz")
    part = _engine(mixed, SCREEN).run_null_streaming(
        N_PERM, obs, key=0, progress=_interrupt_after(1),
        checkpoint_path=ck, checkpoint_every=CHUNK)
    assert 0 < part.completed < N_PERM
    with pytest.raises(ValueError, match="different problem"):
        _engine(mixed).run_null_streaming(N_PERM, obs, key=0,
                                          checkpoint_path=ck)
    eng = _engine(mixed, SCREEN)
    fin = eng.run_null_streaming(N_PERM, obs, key=0, checkpoint_path=ck)
    assert fin.completed == N_PERM
    for got, want in zip((fin.hi, fin.lo, fin.eff),
                         tpv.tail_counts(obs, ref["nulls"])):
        np.testing.assert_array_equal(got, want)
    # the rescue tally rides the checkpoint: the whole run's screen
    assert eng.last_rescue.total == N_PERM


def test_materialized_checkpoint_resumes_with_its_rescue_tally(mixed, ref,
                                                              tmp_path):
    obs = ref["observed"]
    ck = str(tmp_path / "screened_mat.npz")
    part, done = _engine(mixed, SCREEN).run_null(
        N_PERM, key=0, observed=obs, progress=_interrupt_after(1),
        checkpoint_path=ck, checkpoint_every=CHUNK)
    assert 0 < done < N_PERM
    eng = _engine(mixed, SCREEN)
    nulls, done = eng.run_null(N_PERM, key=0, observed=obs,
                               checkpoint_path=ck)
    # the tally rides the checkpoint: without it the resumed run would
    # count only its own 64; the chunk screened ahead of the interrupt
    # (the loop dispatches one ahead) is counted again
    assert done == N_PERM and eng.last_rescue.total >= N_PERM
    _assert_counts(obs, nulls, ref["nulls"])
    whole, _ = _engine(mixed, SCREEN).run_null(N_PERM, key=0, observed=obs)
    np.testing.assert_array_equal(nulls, whole)


def test_jax_written_screened_checkpoint_resumes_in_the_port(mixed, ref,
                                                            tmp_path):
    obs = ref["observed"]
    ck = str(tmp_path / "jax_screened.npz")
    part = _jengine(mixed).run_null_streaming(
        N_PERM, obs, key=0, progress=_interrupt_after(1),
        checkpoint_path=ck, checkpoint_every=CHUNK)
    assert 0 < part.completed < N_PERM
    eng = _engine(mixed, SCREEN)
    fin = eng.run_null_streaming(N_PERM, obs, key=0, checkpoint_path=ck)
    assert fin.completed == N_PERM
    for got, want in zip((fin.hi, fin.lo, fin.eff),
                         tpv.tail_counts(obs, ref["nulls"])):
        np.testing.assert_array_equal(got, want)
    assert eng.last_rescue.total == N_PERM


# --- refusals and the resolution ladder --------------------------------------

def _same_error(port_call, jax_call, exc=ValueError):
    with pytest.raises(exc) as et:
        port_call()
    with pytest.raises(exc) as ej:
        jax_call()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("case", ["stat_fused", "gather_fused", "row"])
def test_init_refusals_are_jax_texts(mixed, case):
    kw = dict(null_precision="bf16_rescue")
    tkw, jkw, mesh, jmesh = {}, {}, None, None
    if case == "stat_fused":
        tkw = jkw = dict(stat_mode="fused")
    elif case == "gather_fused":
        tkw = dict(stat_mode="xla", gather_mode="fused")
        jkw = dict(gather_mode="fused")
    else:
        from netrep_tpu.parallel import mesh as jmeshmod

        tkw = jkw = dict(matrix_sharding="row")
        tkw = dict(tkw, stat_mode="xla")
        mesh = make_mesh(1, 2, devices=[CPU] * 2)
        jmesh = jmeshmod.make_mesh(n_row_shards=2)
    _same_error(
        lambda: _engine(mixed, EngineConfig(**kw, **tkw), mesh=mesh),
        lambda: JEngine(*mixed["mats"],
                        [JSpec(lab, i, i) for lab, i in mixed["specs"]],
                        mixed["pool"], mesh=jmesh,
                        config=JConfig(**kw, **jkw, autotune=False)))


def test_multitest_and_run_null_refusals(mixed):
    (dc, dn, dd, tc, tn, td) = mixed["mats"]
    specs = [ModuleSpec(lab, idx, idx) for lab, idx in mixed["specs"]]
    with pytest.raises(ValueError, match="multi-test engine"):
        MultiTestEngine(dc, dn, dd, [tc, tc], [tn, tn], [td, td], specs,
                        mixed["pool"], config=SCREEN, device="cpu")
    _same_error(lambda: _engine(mixed, SCREEN).run_null(8, key=0),
                lambda: _jengine(mixed)._resolve_null_precision(None))


def test_resolution_ladder(mixed, ref):
    obs = ref["observed"]
    assert F32.resolved_null_precision("tpu") == "bf16_rescue"
    for platform in ("cuda", "cpu"):
        assert F32.resolved_null_precision(platform) == "f32"
        assert SCREEN.resolved_null_precision(platform) == "bf16_rescue"
    eng = _engine(mixed, SCREEN)
    assert eng._resolve_null_precision(obs) == "bf16_rescue"
    assert eng._resolve_null_precision(np.zeros((3, 7))) == "f32"
    assert _engine(mixed)._resolve_null_precision(None) == "f32"
    with pytest.raises(ValueError, match="null_precision must be"):
        EngineConfig(null_precision="bf16")
    with pytest.raises(ValueError) as et:
        EngineConfig(null_precision="bf16")
    with pytest.raises(ValueError) as ej:
        JConfig(null_precision="bf16")
    assert str(et.value) == str(ej.value)


# --- the helpers against the JAX package's -----------------------------------

def test_helpers_equal_jax(monkeypatch):
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((4, 7)) * 3
    obs[1, 2] = np.nan
    for amp in (0.5, 2.0, 20.0):
        np.testing.assert_array_equal(scr.null_cushions(obs, amp),
                                      jscr.null_cushions(obs, amp))
    for raw in ("", "8", "-1", "x"):
        monkeypatch.setenv("NETREP_NULL_MARGIN_SCALE", raw)
        assert scr.resolve_margin_scale() == jscr.resolve_margin_scale()
    monkeypatch.delenv("NETREP_NULL_MARGIN_SCALE")
    cush = scr.null_cushions(obs, 2.0)
    outs = (obs[None] + rng.standard_normal((9, 4, 7)) * 0.05).astype(
        np.float32)
    outs[2, 0, 0] = np.nan
    ob32 = obs.astype(np.float32)
    got = scr.ambiguous_perms([torch.as_tensor(outs)], [torch.as_tensor(ob32)],
                              [torch.as_tensor(cush)]).numpy()
    want = np.asarray(jscr.ambiguous_perms(
        [jnp.asarray(outs)], [jnp.asarray(ob32)], [jnp.asarray(cush)]))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        scr.ambiguous_cells(torch.as_tensor(outs), torch.as_tensor(ob32),
                            torch.as_tensor(cush)).numpy(),
        np.asarray(jscr.ambiguous_cells(jnp.asarray(outs), jnp.asarray(ob32),
                                        jnp.asarray(cush))))
    idx = np.array([3, 9])
    np.testing.assert_array_equal(scr.pad_worklist(idx, 8),
                                  np.asarray(jscr.pad_worklist(idx, 8)))
    for a, b in zip(scr.host_tail_counts(outs, obs),
                    jscr.host_tail_counts(outs, obs)):
        np.testing.assert_array_equal(a, b)
    x = (rng.standard_normal((64, 64)) * 4).astype(np.float32)
    np.testing.assert_array_equal(
        scr.bf16_round(torch.as_tensor(x)).numpy(),
        np.asarray(jscr.bf16_round(jnp.asarray(x))))
    assert scr.SCREEN_FP == jscr.SCREEN_FP
    assert (scr.BF16_UNIT, scr.DEFAULT_MARGIN_SCALE, scr.CUSHION_FLOOR) == (
        jscr.BF16_UNIT, jscr.DEFAULT_MARGIN_SCALE, jscr.CUSHION_FLOOR)


def test_rescue_state_round_trip():
    s = scr.RescueState()
    s.total, s.rescued, s.dispatches = 640, 17, 3
    extras = s.state_arrays()
    j = jscr.RescueState()
    j.restore_state(extras)
    back = scr.RescueState()
    back.restore_state(j.state_arrays())
    assert (back.total, back.rescued, back.dispatches) == (640, 17, 3)
    assert back.fraction() == pytest.approx(17 / 640)
    assert scr.RescueState().fraction() == 0.0


def test_take_keys_are_the_fold_in_keys():
    from netrep_tpu_torch import random as trandom

    root = trandom.key(5, device="cpu")
    keys = trandom.perm_keys(root, 64, 32)
    idx = np.array([3, 0, 31, 3])
    got = scr.take_keys(keys, idx)
    want = trandom.fold_in(root, torch.as_tensor(64 + idx))
    assert torch.equal(got.words, want.words)


# --- the GPD tail ------------------------------------------------------------

def _gpd_cases():
    rng = np.random.default_rng(7)
    heavy = np.abs(np.random.default_rng(1).standard_cauchy(10_000))
    m = float(heavy.max())
    order = np.argsort(heavy)
    heavy[order[-400:]] = (m * np.array([2.0, 2.5, 3.0]))[
        np.random.default_rng(1).integers(0, 3, 400)]
    gp = st.genpareto.rvs(0.1, size=(10_000, 1), random_state=rng)
    expo = np.random.default_rng(0).exponential(size=(10_000, 1))
    mixed = np.random.default_rng(2).standard_normal((2000, 3, 7))
    obs_mixed = np.random.default_rng(3).standard_normal((3, 7)) * 3
    obs_mixed[0, 0] = np.nan
    mixed[:50, 1, 1] = np.nan
    return {
        "gpd_far_tail": (np.array([60.0]), gp, "greater"),
        "exponential": (np.array([18.0]), expo, "greater"),
        "ad_gate_refuses": (np.array([10.0 * m]), heavy[:, None], "greater"),
        "grid_less": (obs_mixed, mixed, "less"),
        "grid_two_sided": (obs_mixed, mixed, "two.sided"),
    }


@pytest.mark.parametrize("case", list(_gpd_cases()))
def test_gpd_tail_pvalues_equal_jax(case):
    obs, nulls, alt = _gpd_cases()[case]
    p, ok = tpv.gpd_tail_pvalues(obs, nulls, alt)
    pj, okj = jpv.gpd_tail_pvalues(obs, nulls, alt)
    np.testing.assert_array_equal(ok, okj)
    np.testing.assert_array_equal(p, pj)
    if case in ("gpd_far_tail", "exponential"):
        assert ok.all()
    if case == "ad_gate_refuses":
        assert not ok.any() and np.isnan(p).all()


def test_gpd_refusals_are_jax_texts():
    obs, nulls, _ = _gpd_cases()["exponential"]
    _same_error(lambda: tpv.gpd_tail_pvalues(obs, nulls, nulls_exact=False),
                lambda: jpv.gpd_tail_pvalues(obs, nulls, nulls_exact=False))
    _same_error(lambda: tpv.gpd_tail_pvalues(obs, nulls, "both"),
                lambda: jpv.gpd_tail_pvalues(obs, nulls, "both"))


# --- end to end: module_preservation, results --------------------------------

@pytest.fixture(scope="module")
def frames():
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    return dict(
        network={"d": d["network"], "t": t["network"]},
        data={"d": d["data"], "t": t["data"]},
        correlation={"d": d["correlation"], "t": t["correlation"]},
        module_assignments=pair["labels"], discovery="d", test="t",
    )


@pytest.fixture(scope="module")
def screened_results(frames):
    kw = dict(frames, n_perm=64, seed=5, device="cpu")
    f32 = module_preservation(**kw, config=F32)
    scr_res = module_preservation(**kw, config=SCREEN)
    return f32, scr_res


def test_module_preservation_screened_equals_f32(screened_results):
    f32, res = screened_results
    np.testing.assert_array_equal(res.p_values, f32.p_values)
    assert f32.nulls_exact and not res.nulls_exact
    _assert_counts(res.observed, res.nulls, f32.nulls)


def test_tail_pvalues_refusals_are_jax_texts(screened_results, frames):
    f32, res = screened_results
    jres = JResult(**{f.name: getattr(res, f.name)
                      for f in dataclasses.fields(JResult)
                      if hasattr(res, f.name)})
    _same_error(res.tail_pvalues, jres.tail_pvalues)
    no_null = dataclasses.replace(f32, nulls=None)
    jno = dataclasses.replace(jres, nulls=None, nulls_exact=True)
    _same_error(no_null.tail_pvalues, jno.tail_pvalues)
    p, ok = f32.tail_pvalues()
    pj, okj = jpv.gpd_tail_pvalues(f32.observed, f32.nulls[: f32.completed],
                                   f32.alternative)
    np.testing.assert_array_equal(p, pj)
    np.testing.assert_array_equal(ok, okj)
    frame = f32.to_frame()
    np.testing.assert_array_equal(frame["p_tail"].to_numpy(), p.reshape(-1))
    np.testing.assert_array_equal(frame["tail_ok"].to_numpy(),
                                  ok.reshape(-1))


def test_data_only_screened_equals_f32():
    """The data-only plane's screened null (the composed statistics of
    rounded data rows) against its float32 run: p-values equal, the
    stored null not exact."""
    from netrep_tpu_torch.models.atlas_api import atlas_module_preservation

    m = make_mixed_pair(200, 4, n_samples=24, seed=7)
    assign = {f"node_{i}": "0" for i in range(200)}
    for lab, idx in m["specs"]:
        for i in idx:
            assign[f"node_{i}"] = str(lab)
    kw = dict(module_assignments={"d": assign}, discovery="d", test="t",
              n_perm=N_PERM, seed=1, device="cpu", data_only=2.0)
    data = {"d": m["discovery"][0], "t": m["test"][0]}
    f32 = atlas_module_preservation(data, config=EngineConfig(
        chunk_size=CHUNK), **kw)
    res = atlas_module_preservation(data, config=EngineConfig(
        chunk_size=CHUNK, null_precision="bf16_rescue"), **kw)
    np.testing.assert_array_equal(res.p_values, f32.p_values)
    _assert_counts(res.observed, res.nulls, f32.nulls)
    assert not res.nulls_exact and res.profile["rescue"]["total"] == N_PERM


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_save_load_tail_and_screened_cross_packages(screened_results,
                                                    tmp_path, direction):
    f32, res = screened_results
    tail = dataclasses.replace(f32)
    tail.tail_pvalues()
    for r in (tail, res):
        path = str(tmp_path / f"{direction}_{r.nulls_exact}.npz")
        if direction == "port_to_jax":
            r.save(path)
            back = JResult.load(path)
        else:
            jr = JResult(**{f.name: getattr(r, f.name)
                            for f in dataclasses.fields(JResult)
                            if hasattr(r, f.name)})
            jr.save(path)
            back = PreservationResult.load(path)
        assert back.nulls_exact == r.nulls_exact
        for name in ("observed", "nulls", "p_values", "p_tail", "tail_ok"):
            a, b = getattr(back, name), getattr(r, name)
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


#: GPD tail p-values end to end, relative: 4.29e-4 measured (module
#: docstring), held with a margin of 4.7×
TAIL_RTOL = 2e-3


@pytest.mark.parametrize("seed", range(6))
def test_tail_pvalues_end_to_end_within_tolerance(frames, seed):
    """Each package's own 200-permutation null, then ``tail_pvalues()``:
    ``tail_ok``, NaN pattern, zeros and permutation p-values equal,
    ``p_tail`` within ``TAIL_RTOL`` relative."""
    kw = dict(frames, n_perm=200, seed=seed)
    res = module_preservation(**kw, config=EngineConfig(chunk_size=CHUNK),
                              device="cpu")
    jres = netrep_tpu.module_preservation(
        **kw, config=JConfig(chunk_size=CHUNK, autotune=False))
    np.testing.assert_array_equal(res.p_values, jres.p_values)
    p, ok = res.tail_pvalues()
    pj, okj = jres.tail_pvalues()
    np.testing.assert_array_equal(ok, okj)
    np.testing.assert_array_equal(np.isnan(p), np.isnan(pj))
    np.testing.assert_array_equal(p == 0, pj == 0)
    np.testing.assert_allclose(p, pj, rtol=TAIL_RTOL, atol=0)
