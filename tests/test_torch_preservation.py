"""The port's ``module_preservation`` (``device="cpu"``) against
``netrep_tpu.module_preservation`` on the same inputs and seed.

P-values and exceedance counts must be EQUAL (same permutations, statistics
far from ties at these sizes); observed values agree within 1e-5 (both
float32, exact ``eigh``, different summation orders). Input errors carry
the same messages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

import netrep_tpu  # noqa: E402
from netrep_tpu.data import make_example_pair, pair_frames  # noqa: E402
from netrep_tpu.models.results import PreservationResult as JResult  # noqa: E402
from netrep_tpu_torch.data import make_example_pair as t_make_example_pair  # noqa: E402
from netrep_tpu_torch.data import make_mixed_pair as t_make_mixed_pair  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.models.results import PreservationResult  # noqa: E402

ATOL = 1e-5
N_PERM = 160


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


def _both(frames, **kw):
    kw = {**frames, "n_perm": N_PERM, **kw}
    return (module_preservation(**kw, device="cpu"),
            netrep_tpu.module_preservation(**kw))


def _assert_same(rt, rj):
    assert rt.module_labels == rj.module_labels
    np.testing.assert_allclose(rt.observed, rj.observed, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(rt.p_values, rj.p_values)
    np.testing.assert_array_equal(rt.n_vars_present, rj.n_vars_present)
    np.testing.assert_array_equal(rt.prop_vars_present, rj.prop_vars_present)
    np.testing.assert_array_equal(rt.total_size, rj.total_size)
    assert rt.total_space == rj.total_space
    assert rt.completed == rj.completed == N_PERM


@pytest.mark.parametrize("seed", (0, 7))
@pytest.mark.parametrize("store_nulls", (True, False))
def test_pvalues_and_counts_equal_jax(frames, seed, store_nulls):
    rt, rj = _both(frames, seed=seed, store_nulls=store_nulls)
    _assert_same(rt, rj)
    if store_nulls:
        assert rt.nulls.shape == rj.nulls.shape
        from netrep_tpu.ops.pvalues import tail_counts

        for a, b in zip(tail_counts(rt.observed, rt.nulls),
                        tail_counts(rj.observed, rj.nulls)):
            np.testing.assert_array_equal(a, b)
    else:
        assert rt.nulls is None
        for name in ("counts_hi", "counts_lo", "counts_eff"):
            np.testing.assert_array_equal(getattr(rt, name),
                                          getattr(rj, name))
    assert set(rt.profile) >= {"input_s", "engine_s", "observed_s",
                               "null_s", "perms_per_s"}


@pytest.mark.parametrize("kw", [
    dict(alternative="two.sided"),
    dict(alternative="less", null="all"),
    dict(modules=["2", "1"]),
], ids=("two_sided", "less_all", "modules"))
def test_options_match_jax(frames, kw):
    _assert_same(*_both(frames, seed=3, **kw))


def test_data_less_run_matches_jax(frames):
    rt, rj = _both({**frames, "data": None}, seed=1)
    _assert_same(rt, rj)
    assert np.isnan(rt.p_values[:, [1, 4, 5, 6]]).all()


def test_result_roundtrip(frames, tmp_path):
    for store in (True, False):
        res = module_preservation(**frames, n_perm=40, seed=2,
                                  store_nulls=store, device="cpu")
        path = str(tmp_path / f"r{int(store)}.npz")
        res.save(path)
        back = PreservationResult.load(path)
        for name in ("observed", "p_values", "n_vars_present", "total_size"):
            np.testing.assert_array_equal(getattr(back, name),
                                          getattr(res, name))
        assert back.module_labels == res.module_labels
        assert (back.nulls is None) == (not store)
        if store:
            np.testing.assert_array_equal(back.nulls, res.nulls)
        else:
            np.testing.assert_array_equal(back.counts_hi, res.counts_hi)
        # the JAX package reads the port's files (same format, version 1)
        theirs = JResult.load(path)
        np.testing.assert_array_equal(theirs.p_values, res.p_values)


def test_progress_and_simplify(frames):
    seen = []
    res = module_preservation(**frames, n_perm=300, seed=0, device="cpu",
                              progress=lambda d, t: seen.append(d),
                              simplify=False)
    assert seen == [128, 256, 300]
    assert list(res) == ["d"] and list(res["d"]) == ["t"]


def _bad_inputs(frames):
    net = frames["network"]["d"].copy()
    asym = net.copy()
    asym.iloc[0, 1] += 0.5
    nonfinite = net.copy()
    nonfinite.iloc[2, 2] = np.nan
    corr_big = frames["correlation"]["d"] * 1.5
    return {
        "asymmetric": dict(network={**frames["network"], "d": asym}),
        "non_finite": dict(network={**frames["network"], "d": nonfinite}),
        "corr_range": dict(correlation={**frames["correlation"],
                                        "d": corr_big}),
        "no_corr": dict(correlation=None),
        "bad_discovery": dict(discovery="zz"),
        "short_assign": dict(module_assignments=["1", "2"]),
        "unknown_module": dict(modules=["42"]),
        "bad_null": dict(null="none"),
        "bad_alternative": dict(alternative="up"),
        "square": dict(network={**frames["network"],
                                "d": net.iloc[:, :-1]}),
    }


@pytest.mark.parametrize("case", (
    "asymmetric", "non_finite", "corr_range", "no_corr", "bad_discovery",
    "short_assign", "unknown_module", "bad_null", "bad_alternative",
    "square",
))
def test_input_errors_match_jax(frames, case):
    kw = {**frames, "n_perm": 10, **_bad_inputs(frames)[case]}
    with pytest.raises(ValueError) as jerr:
        netrep_tpu.module_preservation(**kw)
    with pytest.raises(ValueError) as terr:
        module_preservation(**kw, device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("arg,value", [
    ("adaptive", True), ("mesh", object()), ("vmap_tests", True),
    ("checkpoint_dir", "x"), ("telemetry", True), ("fault_policy", True),
    ("data_only", 2.0), ("backend", "native"),
])
def test_later_slice_arguments_raise(frames, arg, value):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        module_preservation(**frames, n_perm=10, device="cpu",
                            **{arg: value})


def test_fixtures_are_copies():
    a = make_example_pair(np.random.default_rng(5))
    b = t_make_example_pair(np.random.default_rng(5))
    for side in ("discovery", "test"):
        for key in ("data", "correlation", "network"):
            np.testing.assert_array_equal(a[side][key], b[side][key])
    assert a["labels"] == b["labels"]
    from netrep_tpu.data import make_mixed_pair

    m1, m2 = make_mixed_pair(200, 3, seed=4), t_make_mixed_pair(200, 3, seed=4)
    for x, y in zip(m1["test"], m2["test"]):
        np.testing.assert_array_equal(x, y)


def test_numpy_inputs_match_jax():
    mixed = t_make_mixed_pair(300, 5, n_samples=30, seed=2)
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    labels = np.zeros(300, dtype=object)
    labels[:] = "0"
    for lab, idx in mixed["specs"]:
        labels[idx] = lab
    kw = dict(network={"a": dn, "b": tn}, data={"a": dd, "b": td},
              correlation={"a": dc, "b": tc}, module_assignments=list(labels),
              n_perm=N_PERM, seed=5)
    rt = module_preservation(**kw, device="cpu")
    rj = netrep_tpu.module_preservation(**kw)
    _assert_same(rt, rj)
