"""The port's data-only module plane (``module_preservation(data_only=…)``,
``netrep_tpu_torch.models.atlas_api``, the engine's data-only mode)
against the JAX package's on the same inputs and seed, ``device="cpu"``.

Tolerances, as the port's engine tests state them: observed values within
1e-5; null values 99.9% within 1e-5 and all within 1e-4 (float32 sums in
other orders, the null's power iteration undamped on null-like modules);
permutations, exceedance counts, p-values, adaptive retirements and
``n_perm_used`` exactly equal. Error texts equal the JAX package's."""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

import netrep_tpu  # noqa: E402
from netrep_tpu.atlas.modules import dense_reference_stats as j_dense_ref  # noqa: E402
from netrep_tpu.data import make_mixed_pair  # noqa: E402
from netrep_tpu.ops import pvalues as jpv  # noqa: E402
from netrep_tpu.parallel.engine import ModuleSpec as JSpec  # noqa: E402
from netrep_tpu.parallel.engine import PermutationEngine as JEngine  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch import atlas as tatlas  # noqa: E402
from netrep_tpu_torch.atlas.modules import dense_reference_stats  # noqa: E402
from netrep_tpu_torch.models.atlas_api import atlas_module_preservation  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.parallel.engine import ModuleSpec  # noqa: E402
from netrep_tpu_torch.parallel.engine import PermutationEngine  # noqa: E402
from netrep_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

ATOL = 1e-5
NULL_ATOL = 1e-4
BETA = 2.0
N_PERM = 192   # chunk 32: six chunks
CFG = dict(chunk_size=32, power_iters=40)
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
def pair():
    """The JAX package's data-only fixture (``tests/test_atlas.py``): 220
    nodes, four planted modules, 24 samples."""
    mixed = make_mixed_pair(220, 4, n_samples=24, seed=7)
    (dd, _dc, dn), (td, _tc, _tn) = mixed["discovery"], mixed["test"]
    assign = {f"node_{i}": "0" for i in range(dn.shape[0])}
    for lab, idx in mixed["specs"]:
        for i in idx:
            assign[f"node_{i}"] = str(lab)
    return dict(dd=dd, td=td, assign=assign, specs=mixed["specs"],
                pool=mixed["pool"])


def _kw(pair, **kw):
    return dict(module_assignments={"d": pair["assign"]}, data_only=BETA,
                discovery="d", test="t", seed=1, n_perm=N_PERM, **kw)


def _both(pair, **kw):
    """The port's and the JAX package's ``atlas_module_preservation`` of
    the same call."""
    data = {"d": pair["dd"], "t": pair["td"]}
    kw = _kw(pair, **kw)
    rt = atlas_module_preservation(data, config=EngineConfig(**CFG),
                                   device="cpu", **kw)
    rj = netrep_tpu.atlas_module_preservation(
        data, config=JConfig(**CFG, autotune=False), **kw)
    return rt, rj


def assert_null_close(got, want):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    diff = np.abs(got - want)[~np.isnan(want)]
    assert diff.max() <= NULL_ATOL, diff.max()
    assert np.mean(diff <= ATOL) >= 0.999, np.sort(diff)[-10:]


def _assert_same(rt, rj):
    assert rt.module_labels == rj.module_labels
    np.testing.assert_allclose(rt.observed, rj.observed, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(rt.p_values, rj.p_values)
    assert rt.completed == rj.completed
    assert rt.total_space == rj.total_space
    np.testing.assert_array_equal(rt.n_vars_present, rj.n_vars_present)
    if rj.nulls is not None:
        assert_null_close(rt.nulls, rj.nulls)
        for a, b in zip(jpv.tail_counts(rt.observed, rt.nulls),
                        jpv.tail_counts(rj.observed, rj.nulls)):
            np.testing.assert_array_equal(a, b)
    else:
        assert rt.nulls is None
        for f in ("counts_hi", "counts_lo", "counts_eff"):
            np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f))


@pytest.mark.parametrize("kind", (BETA, (3.0, "signed")))
def test_materialized_equals_jax(pair, kind):
    data = {"d": pair["dd"], "t": pair["td"]}
    kw = {**_kw(pair), "data_only": kind}
    rt = atlas_module_preservation(data, config=EngineConfig(**CFG),
                                   device="cpu", **kw)
    rj = netrep_tpu.atlas_module_preservation(
        data, config=JConfig(**CFG, autotune=False), **kw)
    _assert_same(rt, rj)
    assert rt.nulls.shape == (N_PERM, 4, 7)
    assert np.isfinite(rt.observed).all()


def test_streaming_equals_jax(pair):
    rt, rj = _both(pair, store_nulls=False)
    _assert_same(rt, rj)
    base, _ = _both(pair)
    np.testing.assert_array_equal(rt.p_values, base.p_values)


@pytest.mark.parametrize("store_nulls", (True, False))
def test_adaptive_equals_jax(pair, store_nulls):
    rt, rj = _both(pair, adaptive=True, store_nulls=store_nulls)
    assert rt.p_type == rj.p_type == "sequential"
    np.testing.assert_array_equal(rt.n_perm_used, rj.n_perm_used)
    np.testing.assert_array_equal(rt.p_values, rj.p_values)
    assert rt.completed == rj.completed
    if store_nulls:
        assert_null_close(rt.nulls[:rt.completed], rj.nulls[:rj.completed])


def test_perm_mesh_equals_jax(pair):
    rt, rj = _both(pair)
    meshed = atlas_module_preservation(
        {"d": pair["dd"], "t": pair["td"]}, config=EngineConfig(**CFG),
        device="cpu", mesh=make_mesh(2, 1, devices=[CPU] * 2), **_kw(pair))
    np.testing.assert_array_equal(meshed.nulls, rt.nulls)
    _assert_same(meshed, rj)


def test_self_preservation_equals_jax(pair):
    data = {"d": pair["dd"], "t": pair["td"]}
    kw = {**_kw(pair), "test": ["d", "t"], "self_preservation": True,
          "n_perm": 64}
    rt = atlas_module_preservation(data, config=EngineConfig(**CFG),
                                   device="cpu", **kw)
    rj = netrep_tpu.atlas_module_preservation(
        data, config=JConfig(**CFG, autotune=False), **kw)
    assert set(rt) == set(rj) == {"d", "t"}
    for t in ("d", "t"):
        _assert_same(rt[t], rj[t])


def test_vmap_tests_falls_back_pair_by_pair(pair, caplog):
    rng = np.random.default_rng(5)
    t2 = pair["td"] + 0.5 * rng.standard_normal(pair["td"].shape)
    data = {"d": pair["dd"], "t": pair["td"], "t2": t2}
    kw = {**_kw(pair), "test": ["t", "t2"], "vmap_tests": True, "n_perm": 64}
    with caplog.at_level(logging.WARNING):
        rt = atlas_module_preservation(data, config=EngineConfig(**CFG),
                                       device="cpu", **kw)
        rj = netrep_tpu.atlas_module_preservation(
            data, config=JConfig(**CFG, autotune=False), **kw)
    warned = [r for r in caplog.records
              if "vmap_tests requested but unavailable" in r.getMessage()]
    assert {r.name for r in warned} == {"netrep_tpu", "netrep_tpu_torch"}
    for t in ("t", "t2"):
        _assert_same(rt[t], rj[t])
        alone = atlas_module_preservation(
            {"d": pair["dd"], t: data[t]}, config=EngineConfig(**CFG),
            device="cpu", **{**kw, "test": t, "vmap_tests": False})
        np.testing.assert_array_equal(alone.nulls, rt[t].nulls)


def _stop_after(n):
    calls = []

    def progress(done, total):
        calls.append(done)
        if len(calls) == n:
            raise KeyboardInterrupt

    return progress


@pytest.mark.parametrize("writer", ("port", "jax", "port_alone"))
@pytest.mark.parametrize("store_nulls", (True, False))
def test_checkpoint_resume(pair, tmp_path, writer, store_nulls):
    """A data-only run interrupted after two chunks (a checkpoint every
    chunk) resumes in the port: across packages to the port's
    uninterrupted counts and p-values (the file, key data and fingerprint
    are the JAX package's), within the port bit for bit."""
    data = {"d": pair["dd"], "t": pair["td"]}
    kw = dict(_kw(pair), store_nulls=store_nulls, checkpoint_every=32,
              config=EngineConfig(**CFG, superchunk=1))
    ckdir = str(tmp_path / "ck")
    if writer == "jax":
        part = netrep_tpu.atlas_module_preservation(
            data, **{**kw, "config": JConfig(**CFG, superchunk=1,
                                             autotune=False)},
            checkpoint_dir=ckdir, progress=_stop_after(2))
    else:
        part = atlas_module_preservation(data, **kw, device="cpu",
                                         checkpoint_dir=ckdir,
                                         progress=_stop_after(2))
    assert part.completed == 64
    resumed = atlas_module_preservation(data, **kw, device="cpu",
                                        checkpoint_dir=ckdir)
    whole = atlas_module_preservation(data, **kw, device="cpu")
    assert resumed.completed == whole.completed == N_PERM
    np.testing.assert_array_equal(resumed.p_values, whole.p_values)
    if store_nulls:
        if writer == "port_alone":
            np.testing.assert_array_equal(resumed.nulls, whole.nulls)
        else:
            np.testing.assert_array_equal(resumed.nulls[64:],
                                          whole.nulls[64:])
            np.testing.assert_array_equal(resumed.nulls[:64],
                                          part.nulls[:64])
    else:
        for f in ("counts_hi", "counts_lo", "counts_eff"):
            np.testing.assert_array_equal(getattr(resumed, f),
                                          getattr(whole, f))


def test_jax_resumes_port_checkpoint(pair, tmp_path):
    data = {"d": pair["dd"], "t": pair["td"]}
    kw = dict(_kw(pair), checkpoint_every=32)
    ckdir = str(tmp_path / "ck")
    part = atlas_module_preservation(data, **kw, device="cpu",
                                     config=EngineConfig(**CFG),
                                     checkpoint_dir=ckdir,
                                     progress=_stop_after(2))
    assert part.completed == 64
    jcfg = JConfig(**CFG, autotune=False)
    resumed = netrep_tpu.atlas_module_preservation(
        data, **kw, config=jcfg, checkpoint_dir=ckdir)
    whole = netrep_tpu.atlas_module_preservation(data, **kw, config=jcfg)
    np.testing.assert_array_equal(resumed.p_values, whole.p_values)
    np.testing.assert_array_equal(resumed.nulls[:64], part.nulls[:64])


def test_acceptance_pin_dense_path_on_derived_matrices(pair):
    """At small n the data-only run reproduces the dense path on the same
    derivation materialized (the JAX package's acceptance pin): counts and
    p-values equal, values within the tolerance."""
    data = {"d": pair["dd"], "t": pair["td"]}
    res = atlas_module_preservation(data, config=EngineConfig(**CFG),
                                    device="cpu", **_kw(pair))
    (rdc, rdn), (rtc, rtn) = dense_reference_stats(
        pair["dd"], pair["td"], None, BETA)
    ref = module_preservation(
        network={"d": rdn, "t": rtn}, correlation={"d": rdc, "t": rtc},
        data=data, module_assignments={"d": pair["assign"]}, discovery="d",
        test="t", n_perm=N_PERM, seed=1, device="cpu",
        config=EngineConfig(**CFG, stat_mode="xla"))
    np.testing.assert_allclose(res.observed, ref.observed, atol=ATOL)
    assert_null_close(res.nulls, ref.nulls)
    for a, b in zip(jpv.tail_counts(res.observed, res.nulls),
                    jpv.tail_counts(ref.observed, ref.nulls)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res.p_values, ref.p_values)


def test_dense_reference_stats_equal_jax(pair):
    got = dense_reference_stats(pair["dd"], pair["td"], None, BETA)
    want = j_dense_ref(pair["dd"], pair["td"], None, BETA)
    for (gc, gn), (wc, wn) in zip(got, want):
        np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-6)
        np.testing.assert_allclose(gn, wn, rtol=0, atol=1e-6)


def test_engine_data_only_equals_jax(pair):
    """The engines alone: observed, the materialized null and the
    adaptive null with re-bucketing."""
    specs = pair["specs"]
    te = PermutationEngine(None, None, pair["dd"], None, None, pair["td"],
                           [ModuleSpec(lab, i, i) for lab, i in specs],
                           pair["pool"], device="cpu",
                           config=EngineConfig(**CFG,
                                               network_from_correlation=BETA))
    je = JEngine(None, None, pair["dd"], None, None, pair["td"],
                 [JSpec(lab, i, i) for lab, i in specs], pair["pool"],
                 config=JConfig(**CFG, network_from_correlation=BETA,
                                autotune=False))
    assert te.data_only and te.stat_mode == "xla"
    assert te._test_corr is None and te._test_net is None
    obs_t, obs_j = te.observed(), np.asarray(je.observed())
    np.testing.assert_allclose(obs_t, obs_j, rtol=0, atol=ATOL)
    nt, dt = te.run_null(96, key=4)
    nj, dj = je.run_null(96, key=4)
    assert dt == dj == 96
    assert_null_close(nt, np.asarray(nj))
    at, ct, _ = te.run_null_adaptive(256, obs_j, key=4)
    aj, cj, _ = je.run_null_adaptive(256, obs_j, key=4)
    assert ct == cj
    np.testing.assert_array_equal(jpv.effective_nperm(at[:ct]),
                                  jpv.effective_nperm(np.asarray(aj)[:cj]))


def _texts(port_call, jax_call):
    with pytest.raises(ValueError) as et:
        port_call()
    with pytest.raises(ValueError) as ej:
        jax_call()
    assert str(et.value) == str(ej.value)
    return str(et.value)


@pytest.mark.parametrize("case", ("no_spec", "no_data", "row", "gather_fused",
                                  "stat_fused"))
def test_engine_guards_equal_jax(pair, case):
    dd, td = pair["dd"], pair["td"]
    cfg = dict(no_spec={}, no_data={"network_from_correlation": BETA},
               row={"network_from_correlation": BETA,
                    "matrix_sharding": "row"},
               gather_fused={"network_from_correlation": BETA,
                             "gather_mode": "fused"},
               stat_fused={"network_from_correlation": BETA,
                           "stat_mode": "fused"})[case]
    data = (None, None) if case == "no_data" else (dd, td)
    specs = pair["specs"]
    _texts(
        lambda: PermutationEngine(
            None, None, data[0], None, None, data[1],
            [ModuleSpec(lab, i, i) for lab, i in specs], pair["pool"],
            config=EngineConfig(**cfg), device="cpu"),
        lambda: JEngine(
            None, None, data[0], None, None, data[1],
            [JSpec(lab, i, i) for lab, i in specs], pair["pool"],
            config=JConfig(**cfg, autotune=False)))


@pytest.mark.parametrize("case", ("network_given", "no_data",
                                  "spec_disagrees", "zero_variance",
                                  "non_finite", "one_sample", "three_d",
                                  "duplicate_names", "empty"))
def test_argument_and_input_errors_equal_jax(pair, case):
    dd, td = pair["dd"], pair["td"]
    kw = dict(module_assignments={"d": pair["assign"]}, data_only=BETA,
              n_perm=8)
    data = {"d": dd, "t": td}
    if case == "network_given":
        kw["network"] = {"d": np.eye(3)}
    elif case == "no_data":
        data = None
    elif case == "spec_disagrees":
        kw["config"] = "spec"
    elif case == "zero_variance":
        bad = dd.copy()
        bad[:, [7, 9]] = 1.25
        data = {"d": bad, "t": td}
    elif case == "non_finite":
        bad = dd.copy()
        bad[3, 3] = np.nan
        data = {"d": bad, "t": td}
    elif case == "one_sample":
        data = {"d": dd[:1], "t": td}
    elif case == "three_d":
        data = {"d": dd[None], "t": td}
    elif case == "duplicate_names":
        cols = [f"g{i % 100}" for i in range(dd.shape[1])]
        data = {"d": pd.DataFrame(dd, columns=cols), "t": td}
    elif case == "empty":
        data = {}

    def args(config_cls, **extra):
        k = dict(kw, data=data)
        if k.get("config") == "spec":
            k["config"] = config_cls(network_from_correlation=3.0, **extra)
        k.setdefault("network", None)
        return k

    _texts(lambda: module_preservation(**args(EngineConfig), device="cpu"),
           lambda: netrep_tpu.module_preservation(
               **args(JConfig, autotune=False)))


def test_atlas_exports_only_what_is_ported():
    assert set(tatlas.__all__) == {
        "data_only_gather_and_stats", "dense_reference_stats",
        "make_disc_props_data_only", "normalize_beta_static"}
    assert tatlas.normalize_beta_static([2.0, "signed"]) == (2.0, "signed")
    assert tatlas.normalize_beta_static(3) == (3.0, "unsigned")


def test_data_only_datasets_hold_no_matrix(pair):
    from netrep_tpu_torch.models.dataset import build_data_only_datasets

    got = build_data_only_datasets({"d": pair["dd"]}, device="cpu")["d"]
    assert got.correlation is None and got.network is None
    assert got.data.dtype == torch.float32
    assert got.data.shape == pair["dd"].shape
    np.testing.assert_array_equal(got.data.numpy(),
                                  pair["dd"].astype(np.float32))
    assert got.node_names[:2] == ["node_0", "node_1"]
