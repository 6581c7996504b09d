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
- Permutations, counts and p-values: exact.

The composed-statistics null (``stat_mode='xla'``, either ``gather_mode``
of the JAX engine — the port runs the same gather for every value — and
either ``summary_method``) and the derived network
(``network_from_correlation``) are held to the same tolerances against the
JAX engine with the same config. JAX runs with ``gather_mode='fused'`` go
through the Pallas interpreter, so they stay at chunk 8 and ≤ 64
permutations."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from netrep_tpu.data import make_example_pair, make_mixed_pair  # noqa: E402
from netrep_tpu.models import dataset as jds  # noqa: E402
from netrep_tpu.models.preservation import _overlap_setup  # noqa: E402
from netrep_tpu.ops import pvalues as jpv  # noqa: E402
from netrep_tpu.ops import stats as J  # noqa: E402
from netrep_tpu.parallel.engine import ModuleSpec as JSpec  # noqa: E402
from netrep_tpu.parallel.engine import PermutationEngine as JEngine  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch import random as trandom  # noqa: E402
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402
from netrep_tpu_torch.ops import stats as T  # noqa: E402
from netrep_tpu_torch.ops.stats import normalize_net_beta  # noqa: E402
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
        test_net=None if e._test_net is None else np.asarray(e._test_net),
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


# ---------------------------------------------------------------------------
# Composed statistics, derived networks, config errors
# ---------------------------------------------------------------------------

def _pair(engines, jcfg: JConfig, tcfg: EngineConfig, mats=None):
    je = JEngine(*(mats or engines["mats"]),
                 [JSpec(*s) for s in engines["specs"]], engines["pool"],
                 config=jcfg)
    te, key = engine_state_from_numpy(_jax_state(je, SEED), tcfg,
                                      device="cpu")
    return je, te, key


def _assert_counts_equal_jax(te, nulls_t, nulls_j, observed, n):
    sc = te.run_null_streaming(n, observed, key=SEED)
    want = tpv.tail_counts(observed, nulls_t)
    for got, w, j in zip((sc.hi, sc.lo, sc.eff), want,
                         jpv.tail_counts(observed, nulls_j)):
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, j)


@pytest.mark.parametrize("gather_mode,summary", [
    ("direct", "power"), ("fused", "power"), ("direct", "eigh"),
    ("fused", "eigh"),
])
def test_composed_null_matches_jax(engines, gather_mode, summary):
    n, chunk = (64, 8) if gather_mode == "fused" else (N_PERM, 64)
    kw = dict(chunk_size=chunk, stat_mode="xla", gather_mode=gather_mode,
              summary_method=summary)
    je, te, key = _pair(engines, JConfig(autotune=False, **kw),
                        EngineConfig(**kw))
    assert te.stat_mode == "xla"
    nulls_j, _ = je.run_null(n, key=SEED)
    nulls_j = np.asarray(nulls_j)
    nulls_t, done = te.run_null(n, key=key)
    assert done == n
    assert_null_close(nulls_t, nulls_j)
    _assert_counts_equal_jax(te, nulls_t, nulls_j, engines["observed"], n)


def _derived_mats(mats, net_beta):
    """The fixture with both networks rebuilt as ``net_beta``'s
    construction of the correlations (in float64, as a user builds it)."""
    beta, kind = normalize_net_beta(net_beta)

    def construct(c):
        c = np.asarray(c, dtype=np.float64)
        return ((1.0 + c) / 2.0) ** beta if kind == "signed" \
            else np.abs(c) ** beta

    dc, _dn, dd, tc, _tn, td = mats
    return dc, construct(dc), dd, tc, construct(tc), td


@pytest.mark.parametrize("net_beta", [2.0, (3.0, "signed")], ids=str)
def test_derived_network_matches_jax(engines, net_beta):
    mats = _derived_mats(engines["mats"], net_beta)
    kw = dict(chunk_size=64, network_from_correlation=net_beta)
    je, te, key = _pair(engines, JConfig(autotune=False, **kw),
                        EngineConfig(**kw), mats=mats)
    assert je._test_net is None and te._test_net is None
    observed = je.observed()
    np.testing.assert_allclose(te.observed(), observed, rtol=0, atol=ATOL)
    nulls_j, _ = je.run_null(N_PERM, key=SEED)
    nulls_j = np.asarray(nulls_j)
    # the fused-statistics path runs the kernel's derived mode
    nulls_t, _ = te.run_null(N_PERM, key=key)
    assert_null_close(nulls_t, nulls_j)
    _assert_counts_equal_jax(te, nulls_t, nulls_j, observed, N_PERM)
    # the composed path derives from the gathered correlation
    composed, _ = engine_state_from_numpy(
        _jax_state(je, SEED), EngineConfig(stat_mode="xla", **kw),
        device="cpu")
    assert_null_close(composed.run_null(N_PERM, key=key)[0], nulls_j)
    # an engine built from the matrices checks them and keeps no network
    built = PermutationEngine(*mats,
                              [ModuleSpec(*s) for s in engines["specs"]],
                              engines["pool"], config=EngineConfig(**kw),
                              device="cpu")
    assert built._test_net is None
    np.testing.assert_allclose(built.observed(), observed, rtol=0, atol=ATOL)


@pytest.mark.parametrize("side", ["discovery", "test"])
def test_mismatched_derived_network_raises_jax_text(engines, side):
    dc, dn, dd, tc, tn, td = engines["mats"]
    if side == "discovery":
        dn = np.abs(np.asarray(dc, np.float64)) ** 3
    else:
        tn = np.abs(np.asarray(tc, np.float64)) ** 3
    mats = (dc, dn, dd, tc, tn, td)
    specs, pool = engines["specs"], engines["pool"]
    with pytest.raises(ValueError) as jerr:
        JEngine(*mats, [JSpec(*s) for s in specs], pool,
                config=JConfig(network_from_correlation=2.0, autotune=False))
    with pytest.raises(ValueError) as terr:
        PermutationEngine(*mats, [ModuleSpec(*s) for s in specs], pool,
                          config=EngineConfig(network_from_correlation=2.0),
                          device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert f"supplied {side} network" in str(terr.value)


@pytest.mark.parametrize("kw,err", [
    (dict(stat_mode="fusd"), ValueError),
    (dict(stat_mode="fused", summary_method="eigh"), ValueError),
    (dict(gather_mode="mxu"), NotImplementedError),
    (dict(gather_mode="dirct"), ValueError),
    (dict(network_from_correlation=(2.0, "bogus")), ValueError),
], ids=("stat_typo", "fused_eigh", "mxu", "gather_typo", "net_kind"))
def test_config_errors(kw, err):
    with pytest.raises(err) as terr:
        EngineConfig(**kw)
    if err is NotImplementedError:
        assert "ROADMAP.md" in str(terr.value)
        return
    # the options the JAX package validates at construction carry its text
    if "gather_mode" not in kw:
        with pytest.raises(ValueError) as jerr:
            JConfig(**kw)
        assert str(terr.value) == str(jerr.value)


def test_resolved_modes():
    assert EngineConfig().resolved_stat_mode() == "fused"
    assert EngineConfig(summary_method="eigh").resolved_stat_mode() == "xla"
    assert EngineConfig(stat_mode="xla").resolved_stat_mode() == "xla"
    # the JAX package's gather values are accepted and all run the same
    # gather (the kernel's wrapper)
    for mode in ("auto", "direct", "fused"):
        assert EngineConfig(gather_mode=mode).gather_mode == mode


def _sample_space_profile(z, w, n_iter):
    """The fused-statistics kernel's order for a bucket with fewer samples
    than nodes (``csrc/fused_stats.cu``, sample tier), written in torch:
    the power iteration on the sample-space Gram matrix ``Z Z^T`` of the
    ``(..., s, m)`` slice, started from the anchor ``Z w`` (the sum of the
    valid node profiles) and normalised every step; the profile is its
    direction, sign-anchored as in ``summary_profile_masked``."""
    gram = z @ z.transpose(-1, -2)
    anchor = (z * w[..., None, :]).sum(-1)
    u = anchor
    for _ in range(n_iter):
        u = (gram @ u[..., None])[..., 0]
        u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True),
                            min=1e-30)
    prof = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True),
                           min=1e-30)
    sign = torch.sign((prof * anchor).sum(-1, keepdim=True))
    return prof * torch.where(sign == 0, torch.ones_like(sign), sign)


def test_sample_space_iteration_matches_jax(engines):
    """The kernel's reordered iteration, held to the JAX package's
    node-space ``summary_profile_masked`` on the null's own modules (the
    first N_PERM permutations of SEED, which include the non-converging
    ones of the example fixture): profiles and node contributions within
    NULL_ATOL."""
    te, key = engines["te"], engines["key"]
    perm = trandom.permutation(trandom.perm_keys(key, 0, N_PERM),
                               te._pool_dev)
    for b in te.buckets:
        w = b.disc.mask
        z = T.gather_zdata(te._test_dataT, te._bucket_idx(perm, b), w)
        got = _sample_space_profile(z, w, 60)
        zj, wj = jnp.asarray(z.numpy()), jnp.asarray(w.numpy())
        want = J.summary_profile_masked(zj, wj, n_iter=60)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=NULL_ATOL)
        nc = T.node_contribution_masked(z, got, w).numpy()
        nc_j = np.asarray(J.node_contribution_masked(zj, want, wj))
        np.testing.assert_allclose(nc, nc_j, rtol=0, atol=NULL_ATOL)
