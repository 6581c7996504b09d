"""The port's permutation engine against the JAX package's
``PermutationEngine``, with the discovery side carried across as numpy state
(``netrep_tpu_torch.state.engine_state_from_numpy``) so both nulls see
identical operands.

Tolerances. Both engines compute in float32, the port's null through the
plain version of the fused-statistics kernel, the JAX engine through its
XLA composition, so sums run in different orders (~1e-7 relative).

- Observed values (exact ``eigh``): 1e-5 absolute.
- Null values: 1e-5 absolute for at least 99.9% of them, and all within
  1e-4, the JAX package's exact-float32 tier (``tolerance_for('cuda')``,
  ``netrep_tpu/utils/selftest.py``). The null's 60-step power iteration
  does not converge in direction on null-like modules, whose top
  eigenvalues nearly tie, so a rounding difference made at one step is not
  damped by the later ones; node-contribution statistics of small modules
  then differ by up to ~2e-5 (cor.contrib of a 10-node module, measured on
  the example fixture).
- Permutations, counts and p-values: exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from netrep_tpu.data import make_example_pair, make_mixed_pair  # noqa: E402
from netrep_tpu.models import dataset as jds  # noqa: E402
from netrep_tpu.models.preservation import _overlap_setup  # noqa: E402
from netrep_tpu.ops import pvalues as jpv  # noqa: E402
from netrep_tpu.parallel.engine import ModuleSpec as JSpec  # noqa: E402
from netrep_tpu.parallel.engine import PermutationEngine as JEngine  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402
from netrep_tpu_torch.parallel.engine import ModuleSpec  # noqa: E402
from netrep_tpu_torch.parallel.engine import PermutationEngine  # noqa: E402
from netrep_tpu_torch.state import DISC_FIELDS, engine_state_from_numpy  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

ATOL = 1e-5
NULL_ATOL = 1e-4
N_PERM = 150   # chunk 64: a partial tail chunk in every run
SEED = 11


def _jax_state(e: JEngine, seed: int) -> dict:
    return dict(
        pool=np.asarray(e.pool),
        test_corr=np.asarray(e._test_corr),
        test_net=np.asarray(e._test_net),
        test_dataT=(None if e._test_dataT is None
                    else np.asarray(e._test_dataT)),
        n_modules=e.n_modules,
        key_data=np.asarray(jax.random.key_data(jax.random.key(seed))),
        buckets=[
            dict(cap=b.cap, module_pos=np.asarray(b.module_pos),
                 slices=np.asarray(b.slices), obs_idx=np.asarray(b.obs_idx),
                 **{f: np.asarray(getattr(b.disc, f)) for f in DISC_FIELDS})
            for b in e.buckets
        ],
    )


def _example_inputs():
    pair = make_example_pair(np.random.default_rng(3))
    datasets = jds.build_datasets(
        {"d": pair["discovery"]["network"], "t": pair["test"]["network"]},
        data={"d": pair["discovery"]["data"], "t": pair["test"]["data"]},
        correlation={"d": pair["discovery"]["correlation"],
                     "t": pair["test"]["correlation"]},
    )
    for nm, side in (("d", "discovery"), ("t", "test")):
        datasets[nm].node_names = list(pair[side]["names"])
    _labels, specs, _counts, pool = _overlap_setup(
        datasets["d"], datasets["t"], pair["labels"], None, "0", "overlap"
    )
    d, t = datasets["d"], datasets["t"]
    mats = (d.correlation, d.network, d.data, t.correlation, t.network,
            t.data)
    return mats, [(s.label, s.disc_idx, s.test_idx) for s in specs], pool


def _mixed_inputs():
    mixed = make_mixed_pair(320, 6, n_samples=32, seed=7)
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    specs = [(lab, idx, idx) for lab, idx in mixed["specs"]]
    return (dc, dn, dd, tc, tn, td), specs, mixed["pool"]


@pytest.fixture(scope="module", params=("example", "mixed"))
def engines(request):
    mats, specs, pool = (
        _example_inputs() if request.param == "example" else _mixed_inputs()
    )
    je = JEngine(*mats, [JSpec(*s) for s in specs], pool,
                 config=JConfig(chunk_size=64, autotune=False))
    te, key = engine_state_from_numpy(
        _jax_state(je, SEED), EngineConfig(chunk_size=64), device="cpu"
    )
    observed = je.observed()
    nulls_j, done_j = je.run_null(N_PERM, key=SEED)
    return dict(name=request.param, mats=mats, specs=specs, pool=pool,
                je=je, te=te, key=key,
                observed=observed, nulls_j=np.asarray(nulls_j),
                done_j=done_j)


def test_state_carries_buckets(engines):
    je, te = engines["je"], engines["te"]
    assert [b.cap for b in te.buckets] == [b.cap for b in je.buckets]
    assert [b.slices for b in te.buckets] == [list(b.slices)
                                              for b in je.buckets]
    if engines["name"] == "example":
        assert len({b.cap for b in te.buckets}) >= 2  # multi-bucket coverage
    np.testing.assert_array_equal(engines["key"].data(),
                                  jax.random.key_data(jax.random.key(SEED)))


def test_observed_matches(engines):
    got = engines["te"].observed()
    np.testing.assert_allclose(got, engines["observed"], rtol=0, atol=ATOL)


def assert_null_close(got, want):
    diff = np.abs(got - want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    diff = diff[~np.isnan(diff)]
    assert diff.max() <= NULL_ATOL, diff.max()
    assert np.mean(diff <= ATOL) >= 0.999, np.sort(diff)[-10:]


def test_null_matches(engines):
    nulls, done = engines["te"].run_null(N_PERM, key=engines["key"])
    assert done == engines["done_j"] == N_PERM
    assert_null_close(nulls, engines["nulls_j"])
    # integer seed and carried-over root key name the same stream
    again, _ = engines["te"].run_null(70, key=SEED)
    np.testing.assert_array_equal(again, nulls[:70])


def test_streaming_tallies_equal_own_materialized(engines):
    te = engines["te"]
    observed = te.observed()
    nulls, _ = te.run_null(N_PERM, key=SEED)
    seen = []
    sc = te.run_null_streaming(N_PERM, observed, key=SEED,
                               progress=lambda d, t: seen.append((d, t)))
    assert sc.completed == N_PERM and seen[-1] == (N_PERM, N_PERM)
    for got, want in zip((sc.hi, sc.lo, sc.eff),
                         tpv.tail_counts(observed, nulls)):
        np.testing.assert_array_equal(got, want)
    # a superchunk of 1 chunk (a host read per chunk) gives the same counts
    te1, _ = engine_state_from_numpy(
        _jax_state(engines["je"], SEED),
        EngineConfig(chunk_size=64, superchunk=1),
        device="cpu",
    )
    sc1 = te1.run_null_streaming(N_PERM, observed, key=SEED)
    np.testing.assert_array_equal(sc1.hi, sc.hi)
    np.testing.assert_array_equal(sc1.eff, sc.eff)


def test_counts_match_jax_streaming(engines):
    je, te = engines["je"], engines["te"]
    observed = engines["observed"]
    sj = je.run_null_streaming(N_PERM, observed, key=SEED)
    st = te.run_null_streaming(N_PERM, observed, key=SEED)
    for a, b in zip((st.hi, st.lo, st.eff), (sj.hi, sj.lo, sj.eff)):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(
        tpv.counts_pvalues(observed, st.hi, st.lo, st.eff),
        jpv.counts_pvalues(observed, sj.hi, sj.lo, sj.eff),
    )


def test_chunking_and_batching_do_not_change_the_null(engines):
    te = engines["te"]
    base, _ = te.run_null(N_PERM, key=SEED)
    other, _ = engine_state_from_numpy(
        _jax_state(engines["je"], SEED),
        EngineConfig(chunk_size=50), device="cpu",
    )
    nulls, _ = other.run_null(N_PERM, key=SEED)
    np.testing.assert_allclose(nulls, base, rtol=0, atol=1e-6)


def test_engine_built_from_matrices_matches(engines):
    mats, specs, pool = engines["mats"], engines["specs"], engines["pool"]
    te = PermutationEngine(*mats, [ModuleSpec(*s) for s in specs], pool,
                           config=EngineConfig(chunk_size=64), device="cpu")
    np.testing.assert_allclose(te.observed(), engines["observed"], rtol=0,
                               atol=ATOL)
    nulls, _ = te.run_null(40, key=SEED)
    assert_null_close(nulls, engines["nulls_j"][:40])


def test_engine_input_errors():
    mats, specs, pool = _mixed_inputs()
    one = [("x", np.array([3]), np.array([3]))]
    with pytest.raises(ValueError, match="fewer than 2 nodes"):
        PermutationEngine(*mats, [ModuleSpec(*s) for s in one], pool,
                          device="cpu")
    with pytest.raises(ValueError, match="exceed the null"):
        PermutationEngine(*mats, [ModuleSpec(*s) for s in specs],
                          pool[:20], device="cpu")
