"""The port's result surface against the JAX package's on the same inputs
and seeds: ``combine_analyses`` (materialized, streaming, mixed, nested
dicts, disagreeing inputs, duplicate nulls, a JAX-written file),
``results_table`` and ``to_frame``, ``max_pvalue``,
``preserved_modules``, ``module_n_perm``, ``stat_names``,
``effective_nperm``, ``sequential_pvalues`` and ``load_example``.

Counts, p-values, decisions and messages must be EQUAL; observed values
agree within ``ATOL`` (both float32, different summation orders)."""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

import netrep_tpu  # noqa: E402
from netrep_tpu.data import load_example as j_load_example  # noqa: E402
from netrep_tpu.data import make_example_pair, pair_frames  # noqa: E402
from netrep_tpu.models import results as jres  # noqa: E402
from netrep_tpu.ops import pvalues as jpv  # noqa: E402
from netrep_tpu_torch.data import load_example  # noqa: E402
from netrep_tpu_torch.models import results as tres  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402

ATOL = 1e-5
N_PERM = 64


@pytest.fixture(scope="module")
def frames():
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    return dict(
        network={"d": d["network"], "t": t["network"]},
        data={"d": d["data"], "t": t["data"]},
        correlation={"d": d["correlation"], "t": t["correlation"]},
        module_assignments=pair["labels"], discovery="d", test="t",
        n_perm=N_PERM,
    )


@pytest.fixture(scope="module")
def runs(frames):
    """{(package, seed, store_nulls): result} for seeds 1 and 2."""
    out = {}
    for seed in (1, 2):
        for store in (True, False):
            out["t", seed, store] = module_preservation(
                **frames, seed=seed, store_nulls=store, device="cpu")
            out["j", seed, store] = netrep_tpu.module_preservation(
                **frames, seed=seed, store_nulls=store)
    return out


def _same(t, j):
    """A port result equals a JAX one: counts, p-values, bookkeeping."""
    assert t.module_labels == j.module_labels
    np.testing.assert_allclose(t.observed, j.observed, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(t.p_values, j.p_values)
    assert (t.completed, t.n_perm, t.total_space) == (
        j.completed, j.n_perm, j.total_space)
    assert (t.nulls is None) == (j.nulls is None)
    th = ((t.counts_hi, t.counts_lo, t.counts_eff) if t.nulls is None
          else tpv.tail_counts(t.observed, t.nulls))
    jh = ((j.counts_hi, j.counts_lo, j.counts_eff) if j.nulls is None
          else jpv.tail_counts(j.observed, j.nulls))
    for a, b in zip(th, jh):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stores", [(True, True), (False, False),
                                    (True, False), (False, True)],
                         ids=["materialized", "streaming", "mixed",
                              "mixed_reversed"])
def test_combine_equals_jax(runs, stores):
    t = tres.combine_analyses(runs["t", 1, stores[0]],
                              runs["t", 2, stores[1]])
    j = jres.combine_analyses(runs["j", 1, stores[0]],
                              runs["j", 2, stores[1]])
    assert isinstance(t, tres.PreservationResult)
    assert t.completed == 2 * N_PERM
    _same(t, j)
    if all(stores):
        np.testing.assert_array_equal(
            t.nulls[:N_PERM], runs["t", 1, True].nulls)


def test_combine_streaming_equals_materialized(runs):
    # pooled counts give the p-values pooling the nulls gives
    mat = tres.combine_analyses(runs["t", 1, True], runs["t", 2, True])
    stream = tres.combine_analyses(runs["t", 1, False], runs["t", 2, False])
    np.testing.assert_array_equal(mat.p_values, stream.p_values)


def test_combine_three_way_and_interrupted(runs):
    a, b = runs["t", 1, True], runs["t", 2, True]
    ja, jb = runs["j", 1, True], runs["j", 2, True]
    short = dataclasses.replace(b, completed=20)
    jshort = dataclasses.replace(jb, completed=20)
    _same(tres.combine_analyses(a, short), jres.combine_analyses(ja, jshort))
    s3 = tres.combine_analyses(a, short, runs["t", 2, False])
    j3 = jres.combine_analyses(ja, jshort, runs["j", 2, False])
    _same(s3, j3)
    assert s3.completed == 2 * N_PERM + 20
    # fully interrupted runs share nothing and do not trip the detector
    e = tres.combine_analyses(dataclasses.replace(a, completed=0),
                              dataclasses.replace(b, completed=0), a)
    assert e.completed == N_PERM


def test_combine_nested_dicts(frames, runs):
    t = [module_preservation(**frames, seed=s, simplify=False, device="cpu")
         for s in (1, 2)]
    j = [netrep_tpu.module_preservation(**frames, seed=s, simplify=False)
         for s in (1, 2)]
    tc, jc = tres.combine_analyses(*t), jres.combine_analyses(*j)
    assert set(tc) == {"d"} and set(tc["d"]) == {"t"}
    _same(tc["d"]["t"], jc["d"]["t"])
    with pytest.raises(ValueError) as te:
        tres.combine_analyses(t[0], {"other": t[1]["d"]})
    with pytest.raises(ValueError) as je:
        jres.combine_analyses(j[0], {"other": j[1]["d"]})
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as te:
        tres.combine_analyses(t[0]["d"], {"u": t[1]["d"]["t"]})
    with pytest.raises(ValueError) as je:
        jres.combine_analyses(j[0]["d"], {"u": j[1]["d"]["t"]})
    assert str(te.value) == str(je.value) and "test datasets" in str(te.value)


def _disagreements():
    return {
        "one_input": lambda r: (r,),
        "pair": lambda r: (r, dataclasses.replace(r, test="other")),
        "alternative": lambda r: (r, dataclasses.replace(r,
                                                         alternative="less")),
        "observed": lambda r: (r, dataclasses.replace(
            r, observed=r.observed + 0.5)),
        "labels": lambda r: (r, dataclasses.replace(
            r, module_labels=list(r.module_labels)[::-1])),
        "overlap": lambda r: (r, dataclasses.replace(
            r, n_vars_present=r.n_vars_present + 1)),
        "space": lambda r: (r, dataclasses.replace(r, total_space=123.0)),
        "neither": lambda r: (r, dataclasses.replace(
            r, nulls=None, counts_hi=None, counts_lo=None, counts_eff=None)),
    }


@pytest.mark.parametrize("case", list(_disagreements()))
def test_disagreeing_inputs_raise_as_jax(runs, case):
    make = _disagreements()[case]
    with pytest.raises(ValueError) as te:
        tres.combine_analyses(*make(runs["t", 1, True]))
    with pytest.raises(ValueError) as je:
        jres.combine_analyses(*make(runs["j", 1, True]))
    assert str(te.value) == str(je.value)


def test_type_mix_raises_as_jax(runs):
    with pytest.raises(TypeError) as te:
        tres.combine_analyses(runs["t", 1, True], {"d": {"t": 1}})
    with pytest.raises(TypeError) as je:
        jres.combine_analyses(runs["j", 1, True], {"d": {"t": 1}})
    assert str(te.value) == str(je.value)


def test_space_defers_to_recorded(runs):
    a, b = runs["t", 1, True], runs["t", 2, True]
    c = tres.combine_analyses(a, dataclasses.replace(b, total_space=None))
    assert c.total_space == a.total_space


def test_same_seed_rejected_as_jax(frames, runs):
    t = [runs["t", 1, True], module_preservation(**frames, seed=1,
                                                 device="cpu")]
    j = [runs["j", 1, True], netrep_tpu.module_preservation(**frames,
                                                            seed=1)]
    for tt, jj in ((t, j), ([t[0], dataclasses.replace(t[1], completed=10)],
                            [j[0], dataclasses.replace(j[1], completed=10)])):
        with pytest.raises(ValueError) as te:
            tres.combine_analyses(*tt)
        with pytest.raises(ValueError) as je:
            jres.combine_analyses(*jj)
        assert str(te.value) == str(je.value)
        assert "identical null" in str(te.value)
    c = tres.combine_analyses(*t, allow_duplicate_nulls=True)
    _same(c, jres.combine_analyses(*j, allow_duplicate_nulls=True))


def _fake(mod, rows, total_space, observed):
    n = rows.shape[0]
    return mod.PreservationResult(
        discovery="d", test="t", module_labels=["1"], observed=observed,
        nulls=rows, p_values=np.zeros((1, 7)),
        n_vars_present=np.array([5]), prop_vars_present=np.array([1.0]),
        total_size=np.array([5]), alternative="greater", n_perm=n,
        completed=n, total_space=total_space)


@pytest.mark.parametrize("space,shared", [
    (2520.0, [3, 40, 77]), (None, [5, 60]), (1e12, [9]),
    (2520.0, "all"), (None, "all"),
], ids=["small_space_chance", "unknown_space_chance", "one_collision",
        "small_space_duplicate", "unknown_space_duplicate"])
def test_duplicate_detector_as_jax(space, shared):
    rng1, rng2 = np.random.default_rng(1), np.random.default_rng(2)
    a_rows = rng1.standard_normal((120, 1, 7))
    b_rows = rng2.standard_normal((120, 1, 7))
    if shared == "all":
        b_rows = a_rows.copy()
    else:
        b_rows[shared] = a_rows[[10, 20, 30][: len(shared)]]
    obs = np.random.default_rng(0).standard_normal((1, 7))
    outcome = {}
    for name, mod in (("t", tres), ("j", jres)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            try:
                c = mod.combine_analyses(_fake(mod, a_rows, space, obs),
                                         _fake(mod, b_rows, space, obs))
                outcome[name] = ("ok", c.completed, c.p_values.tolist(),
                                 [str(x.message) for x in w])
            except ValueError as e:
                outcome[name] = ("raised", str(e))
    assert outcome["t"] == outcome["j"]
    assert outcome["t"][0] == ("raised" if shared == "all" else "ok")


def test_jax_written_result_combines_after_load(frames, runs, tmp_path):
    """A fixed-n result the JAX package saved combines once the port's
    ``load`` has read it; the JAX object itself is refused."""
    path = str(tmp_path / "jax_seed1.npz")
    runs["j", 1, True].save(path)
    loaded = tres.PreservationResult.load(path)
    c = tres.combine_analyses(loaded, runs["t", 2, True])
    _same(c, jres.combine_analyses(runs["j", 1, True], runs["j", 2, True]))
    with pytest.raises(TypeError, match="PreservationResult.load"):
        tres.combine_analyses(runs["j", 1, True], runs["t", 2, True])


@pytest.mark.parametrize("store", [True, False])
def test_to_frame_and_results_table_equal_jax(runs, store):
    t, j = runs["t", 1, store], runs["j", 1, store]
    tf, jf = t.to_frame(), j.to_frame()
    assert list(tf.columns) == list(jf.columns)
    np.testing.assert_allclose(tf.pop("observed"), jf.pop("observed"),
                               rtol=0, atol=ATOL)
    pd.testing.assert_frame_equal(tf, jf)
    nested = {"d": {"t": t, "t2": runs["t", 2, store]}}
    jnested = {"d": {"t": j, "t2": runs["j", 2, store]}}
    tt, jt = tres.results_table(nested), jres.results_table(jnested)
    np.testing.assert_allclose(tt.pop("observed"), jt.pop("observed"),
                               rtol=0, atol=ATOL)
    pd.testing.assert_frame_equal(tt, jt)
    assert tres.results_table(t).equals(t.to_frame())
    assert tres.results_table({"t": t}).equals(t.to_frame())


@pytest.mark.parametrize("bad", [[1], {"d": {"t": 42}}, {}],
                         ids=["list", "value", "empty"])
def test_results_table_errors_as_jax(bad):
    errs = []
    for mod in (tres, jres):
        with pytest.raises((TypeError, ValueError)) as e:
            mod.results_table(bad)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]


def _pvalue_result(mod):
    return mod.PreservationResult(
        discovery="d", test="t", module_labels=["a", "b", "c", "d"],
        observed=np.ones((4, 7)), nulls=np.zeros((10, 4, 7)),
        p_values=np.array([[0.001] * 7, [0.001] * 6 + [0.2], [np.nan] * 7,
                           [0.001] * 6 + [0.02]]),
        n_vars_present=np.array([5] * 4), prop_vars_present=np.ones(4),
        total_size=np.array([5] * 4), alternative="greater", n_perm=10,
        completed=10)


@pytest.mark.parametrize("kw", [{}, {"adjust": "none"},
                                {"alpha": 0.7, "adjust": "none"},
                                {"alpha": 0.01}])
def test_preserved_modules_and_max_pvalue_as_jax(kw):
    t, j = _pvalue_result(tres), _pvalue_result(jres)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the all-NaN row stays silent
        assert t.preserved_modules(**kw) == j.preserved_modules(**kw)
        np.testing.assert_array_equal(t.max_pvalue(), j.max_pvalue())
    with pytest.raises(ValueError) as te:
        t.preserved_modules(adjust="fdr")
    with pytest.raises(ValueError) as je:
        j.preserved_modules(adjust="fdr")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("store", [True, False])
def test_accessors_equal_jax(runs, store):
    t, j = runs["t", 2, store], runs["j", 2, store]
    assert t.stat_names == j.stat_names
    np.testing.assert_array_equal(t.module_n_perm(), j.module_n_perm())
    assert t.module_n_perm().dtype == np.int64
    np.testing.assert_array_equal(t.max_pvalue(), j.max_pvalue())
    assert t.preserved_modules() == j.preserved_modules()


@pytest.mark.parametrize("alternative", ["greater", "less", "two.sided"])
def test_effective_nperm_and_sequential_pvalues_equal_jax(alternative):
    rng = np.random.default_rng(11)
    nulls = rng.standard_normal((200, 5, 7))
    nulls[150:, 1] = np.nan        # a module retired at 150
    nulls[90:, 3] = np.nan         # and one at 90
    nulls[:, 2, 3:] = np.nan       # data statistics missing: still drawn
    obs = rng.standard_normal((5, 7))
    np.testing.assert_array_equal(tpv.effective_nperm(nulls),
                                  jpv.effective_nperm(nulls))
    for space in (None, 5000.0):
        tp, tn = tpv.sequential_pvalues(obs, nulls, alternative, space)
        jp, jn = jpv.sequential_pvalues(obs, nulls, alternative, space)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tn, jn)
        assert list(tn) == [200, 150, 200, 90, 200]


@pytest.mark.parametrize("seed", [42, 5, 0])
def test_load_example_bit_equal(seed):
    t, j = load_example(seed), j_load_example(seed)
    assert list(t) == list(j)
    for k in t:
        if isinstance(j[k], np.ndarray):
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])
        else:
            assert t[k] == j[k]
