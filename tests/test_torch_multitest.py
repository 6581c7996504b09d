"""The port's multi-test engine (one discovery against T test cohorts on a
shared permutation draw) against the JAX package's ``MultiTestEngine``,
with the discovery side carried across as numpy state
(``netrep_tpu_torch.state.multitest_state_from_numpy``), and
``module_preservation(vmap_tests=True)`` against
``netrep_tpu.module_preservation`` on the same inputs.

Tolerances, as in ``tests/test_torch_engine.py``: observed values (exact
``eigh``) 1e-5 absolute; null values 1e-5 for at least 99.9% of them and
all within 1e-4 (``tolerance_for('cuda')``); permutations, counts and
p-values exact on these fixtures. Within the port, cohort t's null equals
the single-test engine's on cohort t bit for bit (same operands, same
operations). JAX runs with ``gather_mode='fused'`` go through the Pallas
interpreter, so they stay at chunk 8 and ≤ 64 permutations."""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import netrep_tpu  # noqa: E402
from netrep_tpu.data import make_mixed_pair  # noqa: E402
from netrep_tpu.ops import pvalues as jpv  # noqa: E402
from netrep_tpu.parallel.engine import ModuleSpec as JSpec  # noqa: E402
from netrep_tpu.parallel.multitest import MultiTestEngine as JMulti  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402
from netrep_tpu_torch.parallel.engine import ModuleSpec  # noqa: E402
from netrep_tpu_torch.parallel.multitest import MultiTestEngine  # noqa: E402
from netrep_tpu_torch.state import (  # noqa: E402
    DISC_FIELDS, engine_state_from_numpy, multitest_state_from_numpy,
)
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

ATOL = 1e-5
NULL_ATOL = 1e-4
N_GENES, N_MODULES = 200, 4
SEED = 5


def _cohorts(ragged: bool):
    """Discovery and specs of one mixed pair, plus two test cohorts on the
    same 200 genes (the second from another seed; fewer samples when
    ``ragged``)."""
    a = make_mixed_pair(N_GENES, N_MODULES, n_samples=30, seed=3)
    b = make_mixed_pair(N_GENES, N_MODULES, n_samples=22 if ragged else 30,
                        seed=4)
    (dd, dc, dn) = a["discovery"]
    tests = [a["test"], b["test"]]
    specs = [(lab, idx, idx) for lab, idx in a["specs"]]
    return (dc, dn, dd), tests, specs, a["pool"]


def _state(je: JMulti, seed: int) -> dict:
    base = je._base
    td = je._td
    return dict(
        pool=np.asarray(base.pool),
        test_corrs=np.asarray(je._tc),
        test_nets=None if je._tn is None else np.asarray(je._tn),
        test_dataTs=None if td is None else [np.asarray(x) for x in td],
        n_modules=base.n_modules,
        key_data=np.asarray(jax.random.key_data(jax.random.key(seed))),
        buckets=[
            dict(cap=b.cap, module_pos=np.asarray(b.module_pos),
                 slices=np.asarray(b.slices), obs_idx=np.asarray(b.obs_idx),
                 **{f: np.asarray(getattr(b.disc, f)) for f in DISC_FIELDS})
            for b in base.buckets
        ],
    )


def assert_null_close(got, want):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    diff = np.abs(got - want)
    diff = diff[~np.isnan(diff)]
    assert diff.max() <= NULL_ATOL, diff.max()
    assert np.mean(diff <= ATOL) >= 0.999, np.sort(diff)[-10:]


@pytest.mark.parametrize("case,stat_mode,gather_mode", [
    ("uniform", "auto", "auto"),
    ("ragged", "auto", "auto"),
    ("no_data", "auto", "auto"),
    ("uniform", "xla", "fused"),
    ("ragged", "xla", "direct"),
])
def test_multitest_matches_jax(case, stat_mode, gather_mode):
    (dc, dn, dd), tests, specs, pool = _cohorts(case == "ragged")
    with_data = case != "no_data"
    n, chunk = (64, 8) if gather_mode == "fused" else (100, 32)
    kw = dict(chunk_size=chunk, stat_mode=stat_mode, gather_mode=gather_mode)
    je = JMulti(dc, dn, dd, np.stack([t[1] for t in tests]),
                np.stack([t[2] for t in tests]),
                [t[0] for t in tests] if with_data else None,
                [JSpec(*s) for s in specs], pool,
                config=JConfig(autotune=False, **kw))
    te, key = multitest_state_from_numpy(_state(je, SEED), EngineConfig(**kw),
                                         device="cpu")
    assert te.T == 2 and te.stat_mode == ("xla" if stat_mode == "xla"
                                          else "fused")
    observed = je.observed()
    np.testing.assert_allclose(te.observed(), observed, rtol=0, atol=ATOL)
    nulls_j, _ = je.run_null(n, key=SEED)
    nulls_j = np.asarray(nulls_j)
    nulls_t, done = te.run_null(n, key=key)
    assert nulls_t.shape == (2, n, N_MODULES, 7) and done == n
    assert_null_close(nulls_t, nulls_j)
    sc = te.run_null_streaming(n, observed, key=SEED)
    assert sc.hi.shape == (2, N_MODULES, 7) and sc.completed == n
    for t in range(2):
        want = tpv.tail_counts(observed[t], nulls_t[t])
        jwant = jpv.tail_counts(observed[t], nulls_j[t])
        for got, w, j in zip((sc.hi[t], sc.lo[t], sc.eff[t]), want, jwant):
            np.testing.assert_array_equal(got, w)
            np.testing.assert_array_equal(got, j)
    # cohort t of the shared draw is the single-test engine's null on it
    single, _ = engine_state_from_numpy(
        dict(_state(je, SEED), test_corr=np.asarray(je._tc)[1],
             test_net=np.asarray(je._tn)[1],
             test_dataT=None if not with_data else np.asarray(je._td[1])),
        EngineConfig(**kw), device="cpu")
    np.testing.assert_array_equal(single.run_null(n, key=key)[0], nulls_t[1])


def test_multitest_built_from_matrices_derived_network():
    (dc, dn, dd), tests, specs, pool = _cohorts(False)
    cfg = EngineConfig(chunk_size=32, network_from_correlation=2.0)
    te = MultiTestEngine(dc, dn, dd, [t[1] for t in tests],
                         [t[2] for t in tests], [t[0] for t in tests],
                         [ModuleSpec(*s) for s in specs], pool, config=cfg,
                         device="cpu")
    assert all(c._test_net is None for c in te.cohorts)
    je = JMulti(dc, dn, dd, np.stack([t[1] for t in tests]),
                np.stack([t[2] for t in tests]), [t[0] for t in tests],
                [JSpec(*s) for s in specs], pool,
                config=JConfig(chunk_size=32, autotune=False,
                               network_from_correlation=2.0))
    np.testing.assert_allclose(te.observed(), je.observed(), rtol=0,
                               atol=ATOL)
    assert_null_close(te.run_null(64, key=SEED)[0],
                      np.asarray(je.run_null(64, key=SEED)[0]))
    bad = [t[2] for t in tests]
    bad[1] = np.abs(tests[1][1]) ** 3
    with pytest.raises(ValueError, match=r"supplied test\[1\] network"):
        MultiTestEngine(dc, dn, dd, [t[1] for t in tests], bad, None,
                        [ModuleSpec(*s) for s in specs], pool, config=cfg,
                        device="cpu")


def _inputs():
    (dc, dn, dd), tests, specs, _pool = _cohorts(False)
    labels = np.full(N_GENES, "0", dtype=object)
    for lab, idx, _ in specs:
        labels[idx] = lab
    names = ("disc", "t1", "t2")
    mats = [(dd, dc, dn)] + list(tests)
    return dict(
        network={nm: m[2] for nm, m in zip(names, mats)},
        data={nm: m[0] for nm, m in zip(names, mats)},
        correlation={nm: m[1] for nm, m in zip(names, mats)},
        module_assignments=list(labels), discovery="disc",
        test=["t1", "t2"], n_perm=120, seed=SEED,
    )


@pytest.mark.parametrize("store_nulls", (True, False))
def test_module_preservation_vmap_tests_matches_jax(store_nulls):
    kw = dict(_inputs(), store_nulls=store_nulls, vmap_tests=True)
    rt = module_preservation(**kw, device="cpu")
    rj = netrep_tpu.module_preservation(**kw)
    seq = module_preservation(**dict(kw, vmap_tests=False), device="cpu")
    for t in ("t1", "t2"):
        a, b, c = rt[t], rj[t], seq[t]
        assert a.module_labels == b.module_labels
        np.testing.assert_allclose(a.observed, b.observed, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(a.p_values, b.p_values)
        # a shared draw gives each pair its own stand-alone result
        np.testing.assert_array_equal(a.p_values, c.p_values)
        np.testing.assert_array_equal(a.observed, c.observed)
        if store_nulls:
            assert a.nulls.shape == (120, N_MODULES, 7)
            np.testing.assert_array_equal(a.nulls, c.nulls)
        else:
            for name in ("counts_hi", "counts_lo", "counts_eff"):
                np.testing.assert_array_equal(getattr(a, name),
                                              getattr(b, name))
    assert rt["t1"].profile is rt["t2"].profile


def test_vmap_tests_falls_back_with_a_warning(caplog):
    kw = _inputs()
    # t2 has no data while t1 has: the cohorts disagree on data presence
    kw["data"] = {k: v for k, v in kw["data"].items() if k != "t2"}
    kw["n_perm"] = 40
    with caplog.at_level(logging.WARNING, logger="netrep_tpu_torch"):
        res = module_preservation(**kw, vmap_tests=True, device="cpu")
    assert "vmap_tests requested but unavailable" in caplog.text
    seq = module_preservation(**kw, device="cpu")
    for t in ("t1", "t2"):
        np.testing.assert_array_equal(res[t].p_values, seq[t].p_values)
    assert np.isnan(res["t2"].p_values[:, 1]).all()
