"""The port's sparse path (Config E: ``SparseAdjacency``,
``sparse_module_preservation``, ``sparse_network_properties``,
``plot_module_sparse``, the sparse engine and its statistics) against the
JAX package's on the same inputs and seed, ``device="cpu"``. Graphs go
from one package to the other with ``SparseAdjacency.from_arrays``.

Tolerances, as the port's engine tests state them: observed values within
1e-5; null values 99.9% within 1e-5 and all within 1e-4; the adjacency
arrays, permutation index sets, exceedance counts and p-values exactly
equal; error texts equal. Checkpoints: the port identifies a sparse
problem by its inputs (the JAX engine digests its device arrays, whose
``eigh`` values the port matches only to rounding), so a resumed port run
equals the uninterrupted one bit for bit and a file of the other package
is refused with the fingerprint-mismatch text."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")
sp = pytest.importorskip("scipy.sparse")

import jax.numpy as jnp  # noqa: E402

import netrep_tpu  # noqa: E402
from netrep_tpu.ops import pvalues as jpv  # noqa: E402
from netrep_tpu.ops import sparse as JS  # noqa: E402
from netrep_tpu.ops.sparse import SparseAdjacency as JAdj  # noqa: E402
from netrep_tpu.parallel.engine import ModuleSpec as JSpec  # noqa: E402
from netrep_tpu.parallel.sparse import SparsePermutationEngine as JEngine  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch import random as trandom  # noqa: E402
from netrep_tpu_torch.models.sparse_api import (  # noqa: E402
    sparse_module_preservation, sparse_network_properties,
)
from netrep_tpu_torch.ops import sparse as TS  # noqa: E402
from netrep_tpu_torch.ops.sparse import SparseAdjacency  # noqa: E402
from netrep_tpu_torch.parallel.engine import ModuleSpec  # noqa: E402
from netrep_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from netrep_tpu_torch.parallel.sparse import SparsePermutationEngine  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

ATOL = 1e-5
NULL_ATOL = 1e-4
N_PERM = 160   # chunk 32: five chunks
CPU = torch.device("cpu")
SIZES = (30, 9, 45, 20)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: beside other test
    processes, torch's per-core thread pool only contends for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port(adj: JAdj) -> SparseAdjacency:
    return SparseAdjacency.from_arrays(adj.nbr, adj.wgt, adj.n)


def _knn(rng, n, k):
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, n * k)
    vals = rng.uniform(0.05, 1.0, n * k)
    return rows, cols, vals


def _corr_graph(x, adj: JAdj) -> JAdj:
    """A precomputed sparse correlation on the adjacency's edge pattern."""
    c = np.corrcoef(x, rowvar=False)
    rows, cols = np.nonzero(adj.to_dense())
    return JAdj.from_coo(rows, cols, c[rows, cols], adj.n)


@pytest.fixture(scope="module")
def problem():
    """A 300-node kNN-style pair (k = 6 random neighbours, symmetrized) with
    planted modules in both datasets' data (20 and 16 samples) and
    precomputed sparse correlations on the graphs' edge patterns."""
    rng = np.random.default_rng(0)
    n = 300

    def side(s):
        adj = JAdj.from_coo(*_knn(rng, n, 6), n)
        x = rng.standard_normal((s, n))
        pos = 0
        for sz in SIZES:
            x[:, pos:pos + sz] += 1.2 * rng.standard_normal(s)[:, None]
            pos += sz
        return adj, x, _corr_graph(x, adj)

    d_adj, d_x, d_c = side(20)
    t_adj, t_x, t_c = side(16)
    labels = np.full(n, "0", dtype=object)
    pos = 0
    for i, sz in enumerate(SIZES):
        labels[pos:pos + sz] = str(i + 1)
        pos += sz
    return dict(d_adj=d_adj, d_x=d_x, d_c=d_c, t_adj=t_adj, t_x=t_x,
                t_c=t_c, labels=labels, n=n)


def assert_null_close(got, want):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if not ok.any():
        return
    diff = np.abs(got - want)[ok]
    assert diff.max() <= NULL_ATOL, diff.max()
    assert np.mean(diff <= ATOL) >= 0.999, np.sort(diff)[-10:]


def _assert_same(rt, rj):
    assert rt.module_labels == rj.module_labels
    assert np.array_equal(np.isnan(rt.observed), np.isnan(rj.observed))
    np.testing.assert_allclose(rt.observed, rj.observed, rtol=0, atol=ATOL)
    assert_null_close(rt.nulls, np.asarray(rj.nulls))
    for a, b in zip(jpv.tail_counts(rt.observed, rt.nulls),
                    jpv.tail_counts(rj.observed, np.asarray(rj.nulls))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rt.p_values, rj.p_values)
    assert rt.completed == rj.completed
    assert rt.total_space == rj.total_space
    np.testing.assert_array_equal(rt.n_vars_present, rj.n_vars_present)
    np.testing.assert_array_equal(rt.total_size, rj.total_size)
    assert (rt.discovery, rt.test) == (rj.discovery, rj.test)


def _inputs(p, mode):
    """The JAX package's keyword arguments for one input mode."""
    kw = dict(discovery_network=p["d_adj"], test_network=p["t_adj"],
              module_assignments=p["labels"])
    if mode in ("data", "data_and_corr"):
        kw.update(discovery_data=p["d_x"], test_data=p["t_x"])
    if mode in ("corr", "data_and_corr"):
        kw.update(discovery_correlation=p["d_c"], test_correlation=p["t_c"])
    return kw


def _to_port(kw):
    return {k: _port(v) if isinstance(v, JAdj) else v for k, v in kw.items()}


def _both(p, mode="data", chunk=32, **kw):
    base = dict(_inputs(p, mode), n_perm=N_PERM, seed=3, **kw)
    rt = sparse_module_preservation(
        **_to_port(base), config=EngineConfig(chunk_size=chunk),
        device="cpu")
    rj = netrep_tpu.sparse_module_preservation(
        **base, config=JConfig(chunk_size=chunk, autotune=False))
    return rt, rj


# --- the adjacency -----------------------------------------------------------

def _coo_cases():
    rng = np.random.default_rng(2)
    return {
        "knn": (*_knn(rng, 40, 5), 40),
        "reciprocal_conflict": ([0, 1, 2, 3], [1, 0, 3, 2],
                                [0.5, 0.9, 0.2, 0.4], 6),
        "same_direction_duplicates": ([0, 0, 4], [1, 1, 2],
                                      [0.1, 0.7, 0.3], 6),
        "self_loops_and_zeros": ([3, 4, 1], [3, 5, 2], [9.0, 0.0, 0.5], 6),
        "empty": ([], [], [], 4),
    }


@pytest.mark.parametrize("case", list(_coo_cases()))
@pytest.mark.parametrize("symmetrize", (True, False))
def test_from_coo_arrays_equal_jax(case, symmetrize):
    rows, cols, vals, n = _coo_cases()[case]
    got = SparseAdjacency.from_coo(rows, cols, vals, n, symmetrize=symmetrize)
    want = JAdj.from_coo(rows, cols, vals, n, symmetrize=symmetrize)
    assert got.nbr.dtype == np.int32 and got.wgt.dtype == np.float32
    np.testing.assert_array_equal(got.nbr, want.nbr)
    np.testing.assert_array_equal(got.wgt, want.wgt)
    assert (got.n, got.k, got.nnz) == (want.n, want.k, want.nnz)
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())


def test_from_dense_arrays_equal_jax():
    rng = np.random.default_rng(4)
    m = rng.uniform(-1, 1, (30, 30)) * (rng.random((30, 30)) < 0.2)
    m = m + m.T
    for tol in (0.0, 0.3):
        got, want = SparseAdjacency.from_dense(m, tol), JAdj.from_dense(m, tol)
        np.testing.assert_array_equal(got.nbr, want.nbr)
        np.testing.assert_array_equal(got.wgt, want.wgt)
    for bad in (np.ones((3, 4)), np.triu(m)):
        with pytest.raises(ValueError) as et:
            SparseAdjacency.from_dense(bad)
        with pytest.raises(ValueError) as ej:
            JAdj.from_dense(bad)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("fmt", ("csr", "csc", "coo"))
@pytest.mark.parametrize("symmetrize", (True, False))
def test_from_scipy_arrays_equal_jax(fmt, symmetrize):
    rng = np.random.default_rng(2)
    n = 30
    dense = np.zeros((n, n))
    for i in range(n):
        nb = rng.choice([j for j in range(n) if j != i], 4, replace=False)
        dense[i, nb] = rng.uniform(0.1, 1.0, 4)   # a directed kNN graph
    mat = getattr(sp, f"{fmt}_matrix")(dense)
    got = SparseAdjacency.from_scipy(mat, symmetrize=symmetrize)
    want = JAdj.from_scipy(mat, symmetrize=symmetrize)
    np.testing.assert_array_equal(got.nbr, want.nbr)
    np.testing.assert_array_equal(got.wgt, want.wgt)


def test_from_scipy_sums_duplicates_and_refuses_as_jax():
    m = sp.coo_matrix((np.array([1.0, 2.0]), (np.array([0, 0]),
                                              np.array([1, 1]))), shape=(3, 3))
    got, want = SparseAdjacency.from_scipy(m), JAdj.from_scipy(m)
    np.testing.assert_array_equal(got.wgt, want.wgt)
    assert got.to_dense()[0, 1] == 3.0
    for bad, err in ((np.eye(3), TypeError),
                     (sp.csr_matrix(np.ones((3, 5))), ValueError)):
        with pytest.raises(err) as et:
            SparseAdjacency.from_scipy(bad)
        with pytest.raises(err) as ej:
            JAdj.from_scipy(bad)
        assert str(et.value) == str(ej.value)


def test_from_coo_refuses_as_jax():
    for args in (([0], [99], [1.0], 12), ([0, 1], [1], [1.0], 12)):
        with pytest.raises(ValueError) as et:
            SparseAdjacency.from_coo(*args)
        with pytest.raises(ValueError) as ej:
            JAdj.from_coo(*args)
        assert str(et.value) == str(ej.value)


def test_from_arrays_carries_jax_arrays_and_checks_them(problem):
    adj = problem["d_adj"]
    got = _port(adj)
    np.testing.assert_array_equal(got.nbr, adj.nbr)
    np.testing.assert_array_equal(got.wgt, adj.wgt)
    assert got.nbr is not adj.nbr
    n = adj.n
    wrong_pad = adj.wgt.copy()
    wrong_pad[adj.nbr == n] = 0.5
    bad = adj.nbr.copy()
    bad[0, 0] = n + 1
    for nbr, wgt, nn, match in (
            (adj.nbr[:, :2], adj.wgt, n, "must both be"),
            (adj.nbr, adj.wgt, n + 1, "must both be"),
            (adj.nbr.astype(np.int64), adj.wgt, n, "int32"),
            (adj.nbr, adj.wgt.astype(np.float64), n, "float32"),
            (bad, adj.wgt, n, "out of range"),
            (adj.nbr, wrong_pad, n, "weight 0")):
        if match == "weight 0" and not (adj.nbr == n).any():
            continue
        with pytest.raises(ValueError, match=match):
            SparseAdjacency.from_arrays(nbr, wgt, nn)


# --- the statistics on gathered rows -------------------------------------------

@pytest.mark.parametrize("with_data", (True, False))
@pytest.mark.parametrize("with_corr", (True, False))
def test_disc_props_and_stats_equal_jax(problem, with_data, with_corr):
    """One bucket's discovery properties (``eigh``) and a batch of null
    statistics, batched over (permutation, module) against the JAX
    package's ``vmap`` of its one-module functions."""
    import jax

    p = problem
    rng = np.random.default_rng(9)
    cap, K, C = 64, 3, 5
    sizes = (45, 30, 33)
    mask = np.zeros((K, cap), np.float32)
    didx = np.zeros((K, cap), np.int32)
    for k, sz in enumerate(sizes):
        mask[k, :sz] = 1
        didx[k, :sz] = rng.choice(p["n"], sz, replace=False)
    idx = np.stack([rng.permutation(p["n"])[:K * cap].reshape(K, cap)
                    for _ in range(C)]).astype(np.int32)
    adj, cg = p["d_adj"], p["d_c"]
    x = p["d_x"] if with_data else None
    corr = (cg.nbr, cg.wgt) if with_corr else (None, None)

    jd = JS.make_disc_props_sparse(
        jnp.asarray(adj.nbr), jnp.asarray(adj.wgt),
        None if x is None else jnp.asarray(x, jnp.float32),
        jnp.asarray(didx), jnp.asarray(mask),
        *(None if a is None else jnp.asarray(a) for a in corr))
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    td = TS.make_disc_props_sparse(
        t(adj.nbr), t(adj.wgt),
        None if x is None else torch.as_tensor(x.T, dtype=torch.float32),
        t(didx), t(mask), *(t(a) for a in corr))
    for f in td._fields:
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    # the null statistics on the JAX package's discovery properties
    disc = type(td)(*(torch.as_tensor(np.array(a)) for a in jd))
    one = lambda d, i: JS.sparse_gather_and_stats(  # noqa: E731
        d, i, jnp.asarray(adj.nbr), jnp.asarray(adj.wgt),
        None if x is None else jnp.asarray(x, jnp.float32),
        *(None if a is None else jnp.asarray(a) for a in corr))
    want = jax.vmap(jax.vmap(one, in_axes=(0, 0)), in_axes=(None, 0))(
        jd, jnp.asarray(idx))
    got = TS.sparse_gather_and_stats(
        disc, t(idx), t(adj.nbr), t(adj.wgt),
        None if x is None else torch.as_tensor(x.T, dtype=torch.float32),
        *(t(a) for a in corr))
    want = np.asarray(want)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert_null_close(got.numpy().astype(np.float64),
                      want.astype(np.float64))


def test_topology_and_scatter_equal_jax(problem):
    """Topology within float32 rounding (the degree sums over the padded
    neighbour slots in another order); the scattered correlation
    submatrix, where each entry is written once, exactly."""
    p = problem
    rng = np.random.default_rng(1)
    cg = p["t_c"]
    for m in (9, 33):
        idx = rng.choice(p["n"], m, replace=False).astype(np.int32)
        w = np.ones(m, np.float32)
        w[-2:] = 0
        for a in (p["t_adj"], cg):
            jrows = (jnp.asarray(a.nbr[idx]), jnp.asarray(a.wgt[idx]),
                     jnp.asarray(idx), jnp.asarray(w))
            trows = tuple(torch.as_tensor(np.array(v)) for v in jrows)
            ja, jdeg = JS.sparse_module_topology(*jrows)
            ta, tdeg = TS.sparse_module_topology(*trows)
            np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
            np.testing.assert_allclose(tdeg.numpy(), np.asarray(jdeg),
                                       rtol=1e-6, atol=0)
            np.testing.assert_array_equal(
                TS.scatter_corr_submatrix(*trows).numpy(),
                np.asarray(JS.scatter_corr_submatrix(*jrows)))


# --- the engine and the entry point ---------------------------------------------

@pytest.mark.parametrize("mode", ("data", "corr", "neither", "data_and_corr"))
def test_preservation_equals_jax(problem, mode):
    rt, rj = _both(problem, mode)
    _assert_same(rt, rj)
    finite = {"data": 7, "data_and_corr": 7, "corr": 4, "neither": 2}[mode]
    assert np.isfinite(rt.observed).all(axis=0).sum() == finite


@pytest.mark.parametrize("kw", [
    dict(null="all"),
    dict(alternative="two.sided", modules=["3", "1"]),
    dict(alternative="less", discovery="A", test="B"),
], ids=("null_all", "two_sided_subset", "less_named"))
def test_options_equal_jax(problem, kw):
    rt, rj = _both(problem, **kw)
    _assert_same(rt, rj)


def test_misaligned_names_equal_jax(problem):
    """Test nodes named in another order, some missing: the overlap, pool
    and module index sets follow the names."""
    p = problem
    rng = np.random.default_rng(6)
    d_names = [f"c{i}" for i in range(p["n"])]
    keep = np.sort(rng.choice(p["n"], 260, replace=False))
    order = rng.permutation(keep)
    t_adj = JAdj.from_dense(p["t_adj"].to_dense()[np.ix_(order, order)])
    t_names = [d_names[i] for i in order]
    base = dict(discovery_network=p["d_adj"], test_network=t_adj,
                module_assignments=dict(zip(d_names, p["labels"])),
                discovery_data=p["d_x"], test_data=p["t_x"][:, order],
                discovery_names=d_names, test_names=t_names, n_perm=N_PERM,
                seed=5)
    rt = sparse_module_preservation(**_to_port(base), device="cpu",
                                    config=EngineConfig(chunk_size=32))
    rj = netrep_tpu.sparse_module_preservation(
        **base, config=JConfig(chunk_size=32, autotune=False))
    _assert_same(rt, rj)
    assert (rt.n_vars_present < rt.total_size).any()


def test_chunk_size_and_mesh_independence(problem):
    """The same key gives the same null at another chunk size and on a 2×1
    perm mesh; the index sets of a chunk equal the JAX package's."""
    p = problem
    kw = _to_port(dict(_inputs(p, "data"), n_perm=N_PERM, seed=3))
    a = sparse_module_preservation(**kw, config=EngineConfig(chunk_size=8),
                                   device="cpu")
    b = sparse_module_preservation(**kw, config=EngineConfig(chunk_size=32),
                                   device="cpu")
    c = sparse_module_preservation(**kw, config=EngineConfig(chunk_size=32),
                                   device="cpu", mesh=make_mesh(
                                       2, 1, devices=[CPU] * 2))
    assert_null_close(a.nulls, b.nulls)
    np.testing.assert_array_equal(b.nulls, c.nulls)
    for r in (a, c):
        np.testing.assert_array_equal(r.p_values, b.p_values)


def test_cap_granularity_invariance(problem):
    """Padding is inert: a module above 32 nodes buckets into other
    capacities at granularity 8 and 32, with the same null; the JAX
    package's run agrees."""
    p = problem
    specs = [ModuleSpec(str(i + 1), np.arange(a, a + sz), np.arange(a, a + sz))
             for i, (a, sz) in enumerate(((0, 30), (30, 9), (39, 45)))]
    pool = np.arange(p["n"], dtype=np.int32)
    args = (_port(p["d_adj"]), p["d_x"], _port(p["t_adj"]), p["t_x"], specs,
            pool)
    e32 = SparsePermutationEngine(*args, config=EngineConfig(chunk_size=16),
                                  device="cpu")
    e8 = SparsePermutationEngine(
        *args, config=EngineConfig(chunk_size=16, cap_granularity=8),
        device="cpu")
    assert {b.cap for b in e32.buckets} != {b.cap for b in e8.buckets}
    n32, _ = e32.run_null(48, key=13)
    n8, _ = e8.run_null(48, key=13)
    assert_null_close(n8, n32)
    je = JEngine(p["d_adj"], p["d_x"], p["t_adj"], p["t_x"],
                 [JSpec(s.label, s.disc_idx, s.test_idx) for s in specs],
                 pool, config=JConfig(chunk_size=16, cap_granularity=8,
                                      autotune=False))
    nj, _ = je.run_null(48, key=13)
    assert_null_close(n8, np.asarray(nj))


def test_permutation_index_sets_equal_jax(problem):
    """The first chunk's per-bucket module index sets (node-0 padded)
    equal the JAX package's draw."""
    import jax

    p = problem
    engine = SparsePermutationEngine(
        _port(p["d_adj"]), None, _port(p["t_adj"]), None,
        [ModuleSpec(str(i + 1), np.arange(a, a + sz), np.arange(a, a + sz))
         for i, (a, sz) in enumerate(((0, 30), (30, 9), (39, 45)))],
        np.arange(p["n"], dtype=np.int32), device="cpu")
    keys = trandom.perm_keys(trandom.key(7, device="cpu"), 0, 16)
    perm = trandom.permutation(keys, engine._pool_dev)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(
        jnp.arange(16))
    jperm = np.asarray(jax.vmap(lambda k: jax.random.permutation(
        k, jnp.arange(p["n"], dtype=jnp.int32)))(jkeys))
    np.testing.assert_array_equal(perm.numpy(), jperm)
    from netrep_tpu_torch.parallel.engine import _take_blocks

    for b in engine.buckets:
        got = _take_blocks(perm, b.take).numpy()
        for k, (off, size) in enumerate(b.slices):
            np.testing.assert_array_equal(got[:, k, :size],
                                          jperm[:, off:off + size])
            assert (got[:, k, size:] == 0).all()


def test_n_perm_default_counts_finite_statistics(problem, monkeypatch):
    """``n_perm=None``: at least 1,000, Bonferroni over 7, 4 or 2 finite
    statistics, as the JAX package sets it."""
    from netrep_tpu_torch.parallel import sparse as tsp

    seen = []
    monkeypatch.setattr(tsp.SparsePermutationEngine, "run_null",
                        lambda self, n, **kw: (seen.append(n) or (
                            np.full((n, self.n_modules, 7), np.nan), 0)))
    for mode, k in (("data", 7), ("corr", 4), ("neither", 2)):
        sparse_module_preservation(**_to_port(_inputs(problem, mode)),
                                   modules=["1", "2"], device="cpu")
        assert seen[-1] == max(1000, jpv.required_perms(0.05, n_tests=2 * k))


def _err(port_call, jax_call, err=ValueError):
    with pytest.raises(err) as et:
        port_call()
    with pytest.raises(err) as ej:
        jax_call()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("case", (
    "dense_network", "bad_null", "bad_alternative", "data_shape",
    "one_names", "node_count", "names_length", "missing_assignment",
    "unknown_module", "one_correlation", "correlation_size", "no_module",
    "labels_length"))
def test_validation_texts_equal_jax(problem, case):
    p = problem
    d_names = [f"c{i}" for i in range(p["n"])]
    small = JAdj.from_coo([0], [1], [0.5], p["n"] - 4)
    base = dict(discovery_network=p["d_adj"], test_network=p["t_adj"],
                module_assignments=p["labels"], n_perm=8)
    err = ValueError
    if case == "dense_network":
        base["discovery_network"] = p["d_adj"].to_dense()
        err = TypeError
    elif case == "bad_null":
        base["null"] = "some"
    elif case == "bad_alternative":
        base["alternative"] = "both"
    elif case == "data_shape":
        base.update(discovery_data=p["d_x"][:, :5], test_data=p["t_x"])
    elif case == "one_names":
        base["discovery_names"] = d_names
    elif case == "node_count":
        base["test_network"] = small
    elif case == "names_length":
        base.update(discovery_names=["a"], test_names=d_names)
    elif case == "missing_assignment":
        base.update(module_assignments={"c0": "1"}, discovery_names=d_names,
                    test_names=d_names)
    elif case == "unknown_module":
        base["modules"] = ["zebra"]
    elif case == "one_correlation":
        base["discovery_correlation"] = p["d_c"]
    elif case == "correlation_size":
        base.update(discovery_correlation=p["d_c"], test_correlation=small)
    elif case == "no_module":
        base["module_assignments"] = np.where(
            np.arange(p["n"]) == 0, "1", "0").astype(object)
    elif case == "labels_length":
        base["module_assignments"] = p["labels"][:-1]
    _err(lambda: sparse_module_preservation(**_to_port(base), device="cpu"),
         lambda: netrep_tpu.sparse_module_preservation(**base), err)


def test_engine_refusals_equal_jax(problem):
    p = problem
    pool = np.arange(p["n"], dtype=np.int32)
    spec = [("1", np.arange(5), np.arange(5))]
    cases = [
        (dict(config_kw={"matrix_sharding": "row"}), NotImplementedError),
        (dict(specs=[("1", np.arange(1), np.arange(1))]), ValueError),
        (dict(pool=pool[:3]), ValueError),
    ]
    for case, err in cases:
        cfg = case.get("config_kw", {})
        specs = case.get("specs", spec)
        pl = case.get("pool", pool)
        _err(lambda: SparsePermutationEngine(
                 _port(p["d_adj"]), None, _port(p["t_adj"]), None,
                 [ModuleSpec(*s) for s in specs], pl,
                 config=EngineConfig(**cfg), device="cpu"),
             lambda: JEngine(p["d_adj"], None, p["t_adj"], None,
                             [JSpec(*s) for s in specs], pl,
                             config=JConfig(**cfg, autotune=False)), err)


def _stop_after(n):
    calls = []

    def progress(done, total):
        calls.append(done)
        if len(calls) == n:
            raise KeyboardInterrupt

    return progress


def test_checkpoint_resume_within_port(problem, tmp_path):
    kw = _to_port(dict(_inputs(problem, "data"), n_perm=N_PERM, seed=3))
    path = str(tmp_path / "sparse.npz")
    cfg = EngineConfig(chunk_size=32)
    part = sparse_module_preservation(**kw, config=cfg, device="cpu",
                                      checkpoint_path=path,
                                      checkpoint_every=32,
                                      progress=_stop_after(2))
    assert part.completed == 64
    resumed = sparse_module_preservation(**kw, config=cfg, device="cpu",
                                         checkpoint_path=path)
    whole = sparse_module_preservation(**kw, config=cfg, device="cpu")
    assert resumed.completed == N_PERM
    np.testing.assert_array_equal(resumed.nulls, whole.nulls)
    np.testing.assert_array_equal(resumed.p_values, whole.p_values)
    # a finished checkpoint resumes to the same result again
    again = sparse_module_preservation(**kw, config=cfg, device="cpu",
                                       checkpoint_path=path)
    np.testing.assert_array_equal(again.nulls, whole.nulls)


@pytest.mark.parametrize("writer", ("jax", "port"))
def test_checkpoint_of_the_other_package_is_refused(problem, tmp_path,
                                                    writer):
    base = dict(_inputs(problem, "data"), n_perm=64, seed=3)
    path = str(tmp_path / "sparse.npz")

    def port():
        return sparse_module_preservation(
            **_to_port(base), config=EngineConfig(chunk_size=32),
            device="cpu", checkpoint_path=path)

    def jax_():
        return netrep_tpu.sparse_module_preservation(
            **base, config=JConfig(chunk_size=32, autotune=False),
            checkpoint_path=path)

    first, second = (jax_, port) if writer == "jax" else (port, jax_)
    first()
    with pytest.raises(ValueError, match="written for a different problem"):
        second()


@pytest.mark.parametrize("with_data", (True, False))
def test_network_properties_equal_jax(problem, with_data):
    p = problem
    labels = p["labels"].copy()
    labels[299] = "solo"          # a singleton module is reported
    kw = dict(network=p["d_adj"], module_assignments=labels,
              data=p["d_x"] if with_data else None)
    got = sparse_network_properties(**_to_port(kw), device="cpu")
    want = netrep_tpu.sparse_network_properties(**kw)
    assert list(got) == list(want)
    for lab in got:
        g, w = got[lab], want[lab]
        assert g["node_names"] == w["node_names"]
        np.testing.assert_allclose(g["degree"], w["degree"], atol=1e-12)
        np.testing.assert_allclose(g["avg_weight"], w["avg_weight"],
                                   atol=1e-12, equal_nan=True)
        if with_data:
            for f in ("summary", "contribution", "coherence"):
                np.testing.assert_allclose(g[f], w[f], atol=1e-9)
        else:
            assert g["summary"] is None and np.isnan(g["coherence"])
    assert np.isnan(got["solo"]["avg_weight"])


@pytest.mark.parametrize("case", ("dense", "names", "missing", "unknown",
                                  "background", "data_shape"))
def test_network_properties_texts_equal_jax(problem, case):
    p = problem
    kw = dict(network=p["d_adj"], module_assignments=p["labels"])
    err = ValueError
    if case == "dense":
        kw["network"] = p["d_adj"].to_dense()
        err = TypeError
    elif case == "names":
        kw["names"] = ["a"]
    elif case == "missing":
        kw["module_assignments"] = None
    elif case == "unknown":
        kw["modules"] = ["zebra"]
    elif case == "background":
        kw["module_assignments"] = np.full(p["n"], "0", dtype=object)
    elif case == "data_shape":
        kw["data"] = p["d_x"][:, :3]
    _err(lambda: sparse_network_properties(**_to_port(kw), device="cpu"),
         lambda: netrep_tpu.sparse_network_properties(**kw), err)


@pytest.mark.parametrize("with_corr", (True, False))
def test_plot_module_sparse_draws_the_jax_panels(problem, with_corr):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from netrep_tpu import plot as jplot
    from netrep_tpu_torch import plot as tplot

    p = problem
    kw = dict(network=p["d_adj"], data=p["d_x"],
              correlation=p["d_c"] if with_corr else None,
              module_assignments=p["labels"], modules=["2", "4"])
    tfig, taxes = tplot.plot_module_sparse(**_to_port(kw), device="cpu")
    jfig, jaxes = jplot.plot_module_sparse(**kw)
    assert set(taxes) == set(jaxes)
    for panel in ("data", "correlation", "network"):
        np.testing.assert_allclose(
            np.asarray(taxes[panel].images[0].get_array()),
            np.asarray(jaxes[panel].images[0].get_array()), atol=ATOL)
    plt.close(tfig)
    plt.close(jfig)
    _err(lambda: tplot.plot_module_sparse(
             **_to_port(dict(kw, data=None, correlation=None))),
         lambda: jplot.plot_module_sparse(
             **dict(kw, data=None, correlation=None)))
    _err(lambda: tplot.plot_module_sparse(**_to_port(kw), max_nodes=5),
         lambda: jplot.plot_module_sparse(**kw, max_nodes=5))
