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


@pytest.mark.parametrize("options", [
    dict(stat_mode="xla"),
    dict(stat_mode="xla", summary_method="eigh"),
    dict(network_from_correlation=2.0),
    dict(network_from_correlation=2.0, stat_mode="xla"),
], ids=("composed", "composed_eigh", "derived", "derived_composed"))
@pytest.mark.parametrize("store_nulls", (True, False))
def test_engine_options_match_jax(frames, options, store_nulls):
    from netrep_tpu.utils.config import EngineConfig as JConfig
    from netrep_tpu_torch.utils.config import EngineConfig

    kw = {**frames, "n_perm": N_PERM, "seed": 2, "store_nulls": store_nulls}
    rt = module_preservation(**kw, config=EngineConfig(**options),
                             device="cpu")
    rj = netrep_tpu.module_preservation(
        **kw, config=JConfig(autotune=False, **options))
    _assert_same(rt, rj)
    if not store_nulls:
        for name in ("counts_hi", "counts_lo", "counts_eff"):
            np.testing.assert_array_equal(getattr(rt, name),
                                          getattr(rj, name))


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


#: keywords a later slice brought: they now behave as the JAX package's
PORTED = {"adaptive", "checkpoint_dir", "checkpoint_every", "adaptive_rule",
          "adaptive_priors", "data_only"}


def _as_jax_does(frames, tmp_path, arg, value):
    """A keyword the port has since ported gives the JAX package's result,
    or raises its ``ValueError`` with the same text."""
    def call(fn, sub, **extra):
        kw = {**frames, "n_perm": 10, arg: value, **extra}
        if arg == "checkpoint_dir":
            kw[arg] = str(tmp_path / sub / value)
        try:
            return fn(**kw), None
        except ValueError as e:
            return None, str(e)

    rt, terr = call(module_preservation, "port", device="cpu")
    rj, jerr = call(netrep_tpu.module_preservation, "jax")
    assert terr == jerr
    if rt is not None:
        assert rt.p_type == rj.p_type
        np.testing.assert_array_equal(rt.p_values, rj.p_values)


@pytest.mark.parametrize("arg,value", [
    ("adaptive", True),
    ("checkpoint_dir", "x"), ("telemetry", True), ("fault_policy", True),
    ("data_only", 2.0), ("backend", "native"),
    ("n_threads", 4), ("profile", True), ("checkpoint_every", 100),
    ("adaptive_rule", "bayes"), ("adaptive_priors", np.ones((1, 7, 3))),
])
def test_later_slice_arguments_raise(frames, tmp_path, arg, value):
    """The keywords of later slices raise ``NotImplementedError``; those
    ported since (checkpoints, adaptive nulls, the data-only plane) behave
    as the JAX package's."""
    if arg in PORTED:
        _as_jax_does(frames, tmp_path, arg, value)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        module_preservation(**frames, n_perm=10, device="cpu",
                            **{arg: value})


@pytest.mark.parametrize("arg,value,item", [
    ("n_threads", 4, 16), ("profile", "trace_dir", 16),
    ("checkpoint_every", 1024, 7), ("adaptive_rule", "bayes", 8),
    ("adaptive_priors", np.ones((1, 7, 3)), 8),
])
def test_jax_only_keywords_name_their_item(frames, tmp_path, arg, value,
                                           item):
    """The six keywords the port's signature once lacked (a TypeError) raise
    the item that brings them, and only at a value other than the JAX
    package's default; those whose item is done behave as the JAX
    package's."""
    if arg in PORTED:
        _as_jax_does(frames, tmp_path, arg, value)
        return
    with pytest.raises(NotImplementedError,
                       match=f"{arg}= .*ROADMAP.md Queue 1 item {item} "):
        module_preservation(**frames, n_perm=10, device="cpu",
                            **{arg: value})


def test_jax_defaults_of_later_keywords_run(frames, caplog):
    defaults = dict(n_threads=None, profile=None, checkpoint_every=8192,
                    adaptive_rule=None, adaptive_priors=None)
    plain = module_preservation(**frames, n_perm=40, seed=3, device="cpu")
    with caplog.at_level("INFO", logger="netrep_tpu_torch"):
        quiet = module_preservation(**frames, n_perm=40, seed=3,
                                    device="cpu", verbose=False, **defaults)
        assert not caplog.records
        loud = module_preservation(**frames, n_perm=40, seed=3,
                                   device="cpu", verbose=True, **defaults)
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 2 and "'d'" in lines[0] and "40 permutations" in \
        lines[1], lines
    for res in (quiet, loud):
        np.testing.assert_array_equal(res.p_values, plain.p_values)


def _jax_written(frames, tmp_path, kind):
    """A result the JAX package saved, of each kind it writes."""
    import dataclasses

    res = netrep_tpu.module_preservation(**frames, n_perm=40, seed=2)
    if kind == "sequential":
        res = dataclasses.replace(res, p_type="sequential",
                                  n_perm_used=np.full(len(res.module_labels),
                                                      40))
    elif kind == "n_perm_used":
        res = dataclasses.replace(res, n_perm_used=np.full(
            len(res.module_labels), 40))
    elif kind == "gpd_tail":
        res.tail_pvalues()
    elif kind == "screened":
        res = dataclasses.replace(res, nulls_exact=False)
    path = str(tmp_path / f"{kind}.npz")
    res.save(path)
    return res, path


@pytest.mark.parametrize("kind,field,item", [
    ("sequential", "p_type='sequential'", 8),
    ("n_perm_used", "n_perm_used", 8),
    ("gpd_tail", "p_tail", 13),
    ("screened", "nulls_exact=False", 13),
])
def test_load_refuses_what_the_port_cannot_carry(frames, tmp_path, kind,
                                                 field, item):
    """A screened or GPD-tail file raises naming its item (13); the
    sequential fields came with item 8 and now load as written."""
    res, path = _jax_written(frames, tmp_path, kind)
    if item == 8:
        back = PreservationResult.load(path)
        assert back.p_type == res.p_type
        np.testing.assert_array_equal(back.n_perm_used, res.n_perm_used)
        np.testing.assert_array_equal(back.module_n_perm(),
                                      res.module_n_perm())
        return
    with pytest.raises(ValueError, match=f"{field}.*ROADMAP.md Queue 1 "
                                         f"item {item} "):
        PreservationResult.load(path)


def test_load_reads_a_jax_written_fixed_result(frames, tmp_path):
    res, path = _jax_written(frames, tmp_path, "fixed")
    back = PreservationResult.load(path)
    for name in ("observed", "nulls", "p_values", "n_vars_present"):
        np.testing.assert_array_equal(getattr(back, name), getattr(res, name))
    assert back.completed == res.completed == 40


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


@pytest.mark.parametrize("store_nulls", (True, False))
def test_thousand_samples_match_jax(store_nulls):
    """A 1,000-sample test cohort: the fused path (``stat_mode='auto'``)
    computes it, with the JAX package's p-values and counts. The port's
    first kernel refused the 40-node module's bucket (cap 64) at this
    sample count on both devices."""
    pair = make_example_pair(np.random.default_rng(3), n_samples_test=1000,
                             module_sizes=(40, 12, 10, 8))
    d, t = pair_frames(pair)
    kw = dict(network={"d": d["network"], "t": t["network"]},
              data={"d": d["data"], "t": t["data"]},
              correlation={"d": d["correlation"], "t": t["correlation"]},
              module_assignments=pair["labels"], n_perm=40, seed=1,
              store_nulls=store_nulls)
    rt = module_preservation(**kw, device="cpu")
    rj = netrep_tpu.module_preservation(**kw)
    np.testing.assert_allclose(rt.observed, rj.observed, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(rt.p_values, rj.p_values)
    if store_nulls:
        from netrep_tpu.ops.pvalues import tail_counts

        for a, b in zip(tail_counts(rt.observed, rt.nulls),
                        tail_counts(rj.observed, rj.nulls)):
            np.testing.assert_array_equal(a, b)
    else:
        for name in ("counts_hi", "counts_lo", "counts_eff"):
            np.testing.assert_array_equal(getattr(rt, name),
                                          getattr(rj, name))
