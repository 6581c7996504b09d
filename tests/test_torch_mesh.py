"""The port's mesh, row-sharded and perm-mesh nulls against the JAX
package's on the same numpy inputs, on the CPU: a port mesh repeats the
CPU device (``make_mesh(..., devices=[cpu] * k)``), the JAX side runs on
its virtual 8-device CPU mesh (``tests/conftest.py``).

Tolerances, as in ``tests/test_torch_engine.py``: observed values 1e-5
absolute; null values 1e-5 for at least 99.9% of them and all within 1e-4
(``tolerance_for('cuda')``); permutations, counts and p-values EQUAL. A
wrong (perm, row) key split would still give plausible nulls, so counts
are held equal, never close. The JAX ring path runs its gather through
the Pallas interpreter, so these stay at the JAX tests' small sizes
(``make_mixed_pair(160, 3, n_samples=24, seed=5)``, chunk 32, 80
permutations).

Also here: the datasets' device memory — while a null runs, nothing the
call keeps alive holds a discovery matrix, nor the test network in
derived-network mode."""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import netrep_tpu  # noqa: E402
from netrep_tpu.data import make_example_pair, make_mixed_pair, pair_frames  # noqa: E402
from netrep_tpu.ops import pvalues as jpv  # noqa: E402
from netrep_tpu.parallel import mesh as jmesh  # noqa: E402
from netrep_tpu.parallel import sharded as jsharded  # noqa: E402
from netrep_tpu.parallel.engine import ModuleSpec as JSpec  # noqa: E402
from netrep_tpu.parallel.engine import PermutationEngine as JEngine  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.ops import fused_gather as tgather  # noqa: E402
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402
from netrep_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from netrep_tpu_torch.parallel import sharded as tsharded  # noqa: E402
from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine  # noqa: E402
from netrep_tpu_torch.state import engine_state_from_numpy  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

from test_engine import _make_setup  # noqa: E402
from test_torch_engine import ATOL, _jax_state, assert_null_close  # noqa: E402

CPU = torch.device("cpu")
N_PERM, SEED = 80, 0
KNOBS = dict(chunk_size=32, summary_method="power", power_iters=12,
             superchunk=2)


def cpu_mesh(p, r):
    return tmesh.make_mesh(p, r, devices=[CPU] * (p * r))


@pytest.fixture(scope="module")
def mixed():
    return make_mixed_pair(160, 3, n_samples=24, seed=5)


def _jax_engine(mixed, mesh=None, **kw):
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    specs = [JSpec(lab, idx, idx) for lab, idx in mixed["specs"]]
    return JEngine(dc, dn, dd, tc, tn, td, specs, mixed["pool"],
                   config=JConfig(autotune=False, **KNOBS, **kw), mesh=mesh)


@pytest.fixture(scope="module")
def base(mixed):
    """A JAX replicated engine: the discovery side every port engine here
    is built from, and the observed statistics (exact ``eigh``, whatever
    the null's path)."""
    je = _jax_engine(mixed)
    return dict(je=je, observed=np.asarray(je.observed()),
                state=_jax_state(je, SEED))


def _port(base, mesh, **kw):
    te, _key = engine_state_from_numpy(base["state"],
                                       EngineConfig(**KNOBS, **kw),
                                       device="cpu", mesh=mesh)
    return te


def _assert_counts(sc, want):
    for got, w in zip((sc.hi, sc.lo, sc.eff), want):
        np.testing.assert_array_equal(got, np.asarray(w))


# ---------------------------------------------------------------------------
# mesh construction, row blocks, sharded gathers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    dict(), dict(n_row_shards=4), dict(n_perm_shards=2, n_row_shards=2),
    dict(n_perm_shards=3), dict(n_row_shards=3),
    dict(n_perm_shards=5, n_row_shards=4),
], ids=str)
def test_make_mesh_matches_jax(args):
    try:
        want = jmesh.make_mesh(**args)
    except ValueError as err:
        with pytest.raises(ValueError) as terr:
            tmesh.make_mesh(**args, devices=[CPU] * len(jax.devices()))
        assert str(terr.value) == str(err)
        return
    got = tmesh.make_mesh(**args, devices=[CPU] * len(jax.devices()))
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape


def test_mesh_devices_and_errors(monkeypatch):
    m = tmesh.make_mesh(1, 4, devices=[CPU] * 4)
    assert m.device_type == "cpu" and m.perm_row(0).shape == {"perm": 1,
                                                               "row": 4}
    with pytest.raises(ValueError, match="non-empty"):
        tmesh.make_mesh(0, 1, devices=[CPU])
    with pytest.raises(ValueError, match="mixes device types"):
        tmesh.make_mesh(1, 2, devices=[CPU, torch.device("cuda", 0)])
    # devices=None means every visible card: none here, so it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.make_mesh()


def test_pad_and_shard_rows(rng):
    m = rng.standard_normal((10, 10)).astype(np.float32)
    got = tsharded.pad_square_to_multiple(torch.as_tensor(m), 4)
    np.testing.assert_array_equal(got.numpy(),
                                  jsharded.pad_square_to_multiple(m, 4))
    t = torch.as_tensor(m)
    assert tsharded.pad_square_to_multiple(t, 5) is t
    mesh = cpu_mesh(2, 2)
    blocks = tsharded.shard_rows(got, mesh)
    # one device: the blocks are views of the matrix, shared by perm shards
    for p in range(2):
        for r in range(2):
            assert blocks[p][r].data_ptr() == got[r * 6:].data_ptr()
            np.testing.assert_array_equal(blocks[p][r], got[r * 6: r * 6 + 6])
    # a matrix laid out column-major (as a DataFrame's values may be) gives
    # contiguous row blocks: the kernels read rows
    assert all(b.is_contiguous() for b in tsharded.shard_rows(got.T, mesh)[0])
    with pytest.raises(ValueError) as terr:
        tsharded.shard_rows(t, cpu_mesh(1, 4))
    with pytest.raises(ValueError) as jerr:
        jsharded.shard_rows(m, jmesh.make_mesh(1, 4))
    assert str(terr.value) == str(jerr.value)


def test_chunk_shards_order():
    mesh = cpu_mesh(2, 3)
    ring = tsharded.chunk_shards(mesh, 30, ring=True)
    assert [(p, r) for p, r, _ in ring] == [(p, r) for p in range(2)
                                            for r in range(3)]
    # shard (p, r) owns slice p * R + r: the shards tile the chunk in order
    assert [sl.start for *_, sl in ring] == list(range(0, 30, 5))
    perm = tsharded.chunk_shards(mesh, 30, ring=False)
    assert [(p, r, sl.start, sl.stop) for p, r, sl in perm] == [
        (0, 0, 0, 15), (1, 0, 15, 30)]


@pytest.mark.parametrize("n", [64, 66])
def test_sharded_gather_matches_dense_and_jax(rng, n):
    m_sz, mesh = 9, cpu_mesh(2, 4)
    mats = [rng.standard_normal((n, n)).astype(np.float32) for _ in range(2)]
    idx = rng.choice(n, size=(4, 5, m_sz), replace=True).astype(np.int32)
    blocks = [tsharded.shard_rows(tsharded.pad_square_to_multiple(
        torch.as_tensor(a), 4), mesh) for a in mats]
    it = torch.as_tensor(idx)
    (sub_c,), (sub_n,) = tsharded.make_sharded_gatherer(mesh)(*blocks, [it])
    for got, a in ((sub_c, mats[0]), (sub_n, mats[1])):
        want = tgather.gather_submatrix_fused_plain(torch.as_tensor(a), it)
        assert torch.equal(got, want)
    # against the JAX psum gatherer on its 2x4 mesh
    jm = jmesh.make_mesh(n_perm_shards=2, n_row_shards=4)
    jmats = [jsharded.shard_rows(jax.numpy.asarray(
        jsharded.pad_square_to_multiple(a, 4)), jm) for a in mats]
    jc, jn = jax.jit(lambda i: jsharded.make_sharded_gatherer(jm)(
        *jmats, i))(jax.numpy.asarray(idx))
    np.testing.assert_array_equal(sub_c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(sub_n.numpy(), np.asarray(jn))
    # derived-network dispatch: the correlation alone, the network from it
    (c2,), (n2,) = tsharded.gather_corr_net(
        tsharded.make_sharded_gatherer(mesh), blocks[0], None, [it], 2.0)
    assert torch.equal(c2, sub_c) and torch.equal(n2, c2.abs() ** 2)


def test_mesh_axis_and_device_checks():
    # a port mesh's axes are ('perm', 'row'): 'perm' is the one perm axis
    assert EngineConfig(mesh_axis="perm").mesh_axis == "perm"
    with pytest.raises(ValueError, match="mesh_axis must be 'perm'"):
        EngineConfig(mesh_axis="row")
    mesh = cpu_mesh(2, 2)
    assert tmesh.resolve_device(mesh, "cpu") == mesh.devices[0, 0]
    assert tmesh.resolve_device(None, "cpu") == CPU
    # a mesh of cards never runs on the CPU
    cards = tmesh.make_mesh(1, 2, devices=[torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError, match="mesh's devices"):
        tmesh.resolve_device(cards, "cpu")


# ---------------------------------------------------------------------------
# engines on a mesh against the JAX package's
# ---------------------------------------------------------------------------

def test_ring_engine_matches_jax(mixed, base):
    """Mesh 2×2, ``matrix_sharding='row'``, fused statistics: both packages
    take the ring path (the chunk split over perm × row)."""
    observed = base["observed"]
    je = _jax_engine(mixed, jmesh.make_mesh(2, 2), matrix_sharding="row",
                     stat_mode="fused")
    assert je._stat_fused_ring()
    nulls_j = np.asarray(je.run_null(N_PERM, key=SEED)[0])
    sj = je.run_null_streaming(N_PERM, observed, key=SEED)
    te = _port(base, cpu_mesh(2, 2), matrix_sharding="row")
    assert te._stat_fused_ring() and te._test_corr is None
    assert te.effective_chunk() == je.effective_chunk() == 32
    np.testing.assert_allclose(te.observed(), observed, rtol=0, atol=ATOL)
    nulls_t, done = te.run_null(N_PERM, key=SEED)
    assert done == N_PERM
    assert_null_close(nulls_t, nulls_j)
    st = te.run_null_streaming(N_PERM, observed, key=SEED)
    _assert_counts(st, (sj.hi, sj.lo, sj.eff))
    _assert_counts(st, tpv.tail_counts(observed, nulls_t))


def test_psum_engine_matches_jax():
    """Mesh 2×4, ``stat_mode='xla'`` (the psum path), with the setup of
    ``tests/test_sharding.py::test_row_sharded_engine_matches_replicated``
    (``eigh`` summary, chunk 8, 16 permutations, key 21), built from the
    matrices on both sides."""
    d, t, modules, pool = _make_setup(make_example_pair(
        np.random.default_rng(42)))
    mats = (d["correlation"], d["network"], d["data"], t["correlation"],
            t["network"], t["data"])
    kw = dict(chunk_size=8, summary_method="eigh", matrix_sharding="row")
    je = JEngine(*mats, modules, pool, config=JConfig(autotune=False, **kw),
                 mesh=jmesh.make_mesh(n_perm_shards=2, n_row_shards=4))
    te = PermutationEngine(
        *mats, [ModuleSpec(m.label, m.disc_idx, m.test_idx) for m in modules],
        pool, config=EngineConfig(**kw), device="cpu", mesh=cpu_mesh(2, 4))
    assert te.stat_mode == "xla" and not te._stat_fused_ring()
    observed = np.asarray(je.observed())
    np.testing.assert_allclose(te.observed(), observed, rtol=0, atol=ATOL)
    nulls_j = np.asarray(je.run_null(16, key=21)[0])
    nulls_t, done = te.run_null(16, key=21)
    assert done == 16
    assert_null_close(nulls_t, nulls_j)
    st = te.run_null_streaming(16, observed, key=21)
    _assert_counts(st, jpv.tail_counts(observed, nulls_j))


def test_padded_ring_mesh(mixed, base):
    """Mesh 2×3 over 160 genes: the matrices pad to 162 rows; the padded
    rows and columns are never read as nodes. Against the JAX ring engine
    on the same mesh shape."""
    observed = base["observed"]
    je = _jax_engine(mixed, jmesh.make_mesh(2, 3), matrix_sharding="row",
                     stat_mode="fused")
    nulls_j = np.asarray(je.run_null(N_PERM, key=SEED)[0])
    te = _port(base, cpu_mesh(2, 3), matrix_sharding="row")
    assert te._rows_c[0][0].shape == (54, 162)
    assert te.effective_chunk() == 30
    nulls_t, _ = te.run_null(N_PERM, key=SEED)
    assert_null_close(nulls_t, nulls_j)
    st = te.run_null_streaming(N_PERM, observed, key=SEED)
    _assert_counts(st, jpv.tail_counts(observed, nulls_j))


def test_perm_mesh_matches_jax(mixed, base):
    """Mesh 4×1 over replicated matrices, fused statistics (the setup of
    ``tests/test_fused_stats.py::test_perm_mesh_parity``)."""
    observed = base["observed"]
    je = _jax_engine(mixed, jmesh.make_mesh(n_perm_shards=4),
                     stat_mode="fused")
    sj = je.run_null_streaming(N_PERM, observed, key=SEED)
    te = _port(base, cpu_mesh(4, 1))
    assert not te.row_sharded and te.stat_mode == "fused"
    st = te.run_null_streaming(N_PERM, observed, key=SEED)
    _assert_counts(st, (sj.hi, sj.lo, sj.eff))
    nulls_t, _ = te.run_null(N_PERM, key=SEED)
    _assert_counts(st, tpv.tail_counts(observed, nulls_t))
    # the same seed gives the same null without a mesh
    plain = _port(base, None)
    np.testing.assert_array_equal(nulls_t, plain.run_null(N_PERM,
                                                          key=SEED)[0])


def test_derived_network_on_the_row_paths(mixed, base):
    """``network_from_correlation`` on the ring and psum paths: no network
    is stored, and both agree with the JAX ring engine in derived mode."""
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    dn, tn = np.abs(dc) ** 2.0, np.abs(tc) ** 2.0
    derived = dict(mixed, discovery=(dd, dc, dn), test=(td, tc, tn))
    je = _jax_engine(derived, jmesh.make_mesh(2, 2), matrix_sharding="row",
                     network_from_correlation=2.0, stat_mode="fused")
    observed = np.asarray(je.observed())
    nulls_j = np.asarray(je.run_null(N_PERM, key=SEED)[0])
    specs = [ModuleSpec(lab, idx, idx) for lab, idx in mixed["specs"]]
    for stat_mode in ("fused", "xla"):
        te = PermutationEngine(
            dc, dn, dd, tc, tn, td, specs, mixed["pool"],
            config=EngineConfig(**KNOBS, matrix_sharding="row",
                                network_from_correlation=2.0,
                                stat_mode=stat_mode),
            device="cpu", mesh=cpu_mesh(2, 2))
        assert te._rows_n is None and te._test_net is None
        np.testing.assert_allclose(te.observed(), observed, rtol=0,
                                   atol=ATOL)
        nulls_t, _ = te.run_null(N_PERM, key=SEED)
        assert_null_close(nulls_t, nulls_j)
        st = te.run_null_streaming(N_PERM, observed, key=SEED)
        _assert_counts(st, jpv.tail_counts(observed, nulls_j))


def test_engine_mesh_errors(mixed, base):
    with pytest.raises(ValueError) as terr:
        _port(base, None, matrix_sharding="row")
    with pytest.raises(ValueError) as jerr:
        _jax_engine(mixed, matrix_sharding="row")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as terr:
        _port(base, cpu_mesh(1, 2), matrix_sharding="rows")
    with pytest.raises(ValueError) as jerr:
        _jax_engine(mixed, jmesh.make_mesh(1, 2), matrix_sharding="rows")
    assert str(terr.value) == str(jerr.value)
    # a mesh of cards never runs on the CPU
    cards = tmesh.make_mesh(1, 1, devices=[torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="mesh's devices"):
        _port(base, cards)


# ---------------------------------------------------------------------------
# module_preservation(mesh=...) and the datasets' device memory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames():
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    return dict(
        network={"d": d["network"], "t": t["network"]},
        data={"d": d["data"], "t": t["data"]},
        correlation={"d": d["correlation"], "t": t["correlation"]},
        module_assignments=pair["labels"], discovery="d", test="t",
        n_perm=96, seed=7,
    )


@pytest.mark.parametrize("sharding,stat_mode,store", [
    ("row", "fused", True), ("row", "xla", False),
    ("replicated", "auto", False),
], ids=("ring", "psum", "perm"))
def test_module_preservation_mesh_equals_jax(frames, sharding, stat_mode,
                                             store):
    # 'auto' is the port's fused null and the JAX package's composed one on
    # the CPU: same seed, so the same p-values
    shape = (2, 1) if sharding == "replicated" else (1, 2)
    rj = netrep_tpu.module_preservation(
        **frames, store_nulls=store,
        config=JConfig(matrix_sharding=sharding, stat_mode=stat_mode,
                       autotune=False),
        mesh=jmesh.make_mesh(*shape))
    rt = module_preservation(
        **frames, store_nulls=store, device="cpu", mesh=cpu_mesh(*shape),
        config=EngineConfig(matrix_sharding=sharding, stat_mode=stat_mode))
    np.testing.assert_allclose(rt.observed, rj.observed, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(rt.p_values, rj.p_values)
    assert rt.completed == rj.completed == 96


def test_mesh_with_vmap_tests_raises(frames):
    """``vmap_tests=True`` with a mesh runs the multi-test engine over it
    (the JAX package's p-values, each cohort's as its single-test run's);
    only an explicit ``stat_mode='fused'`` on row-sharded matrices raises,
    with the JAX package's text."""
    kw = dict(frames)
    for key in ("network", "data", "correlation"):
        kw[key] = dict(kw[key], t2=kw[key]["t"])
    kw["test"] = ["t", "t2"]
    rt = module_preservation(**kw, device="cpu", vmap_tests=True,
                             mesh=cpu_mesh(2, 1))
    rj = netrep_tpu.module_preservation(
        **kw, vmap_tests=True, config=JConfig(autotune=False),
        mesh=jmesh.make_mesh(2, 1))
    single = module_preservation(**frames, device="cpu")
    for t in ("t", "t2"):
        np.testing.assert_allclose(rt[t].observed, rj[t].observed, rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(rt[t].p_values, rj[t].p_values)
        np.testing.assert_array_equal(rt[t].nulls, single.nulls)
    row = dict(matrix_sharding="row", stat_mode="fused")
    with pytest.raises(ValueError) as want:
        netrep_tpu.module_preservation(
            **kw, vmap_tests=True, config=JConfig(autotune=False, **row),
            mesh=jmesh.make_mesh(1, 2))
    with pytest.raises(ValueError) as got:
        module_preservation(**kw, device="cpu", vmap_tests=True,
                            config=EngineConfig(**row), mesh=cpu_mesh(1, 2))
    assert str(got.value) == str(want.value)
    # the raised errors' tracebacks hold the calls' frames in reference
    # cycles: collect them, so no later test finds their tensors alive
    del want, got
    gc.collect()


def _live_equal(target: torch.Tensor, mine) -> int:
    """How many live tensors anywhere in the process, besides the test's
    own (``mine``), equal ``target``."""
    skip = {id(t) for t in mine}
    return sum(
        1 for o in gc.get_objects()
        if type(o) is torch.Tensor and id(o) not in skip
        and o.shape == target.shape and o.dtype == target.dtype
        and torch.equal(o, target)
    )


@pytest.mark.parametrize("options", [
    dict(), dict(network_from_correlation=2.0),
    dict(matrix_sharding="row", network_from_correlation=2.0),
], ids=("stored", "derived", "derived_ring"))
def test_null_holds_no_discovery_matrix(options):
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair["discovery"], pair["test"]
    if "network_from_correlation" in options:
        for side in (d, t):
            side["network"] = np.abs(side["correlation"]) ** 2.0
    f32 = {f"{nm}_{k}": torch.as_tensor(np.asarray(side[k], np.float32))
           for nm, side in (("d", d), ("t", t))
           for k in ("correlation", "network")}
    seen = []

    def progress(done, total):
        seen.append({k: _live_equal(v, f32.values())
                     for k, v in f32.items()})

    mesh = cpu_mesh(1, 2) if "matrix_sharding" in options else None
    fd, ft = pair_frames(pair)
    module_preservation(
        {"d": fd["network"], "t": ft["network"]},
        data={"d": fd["data"], "t": ft["data"]},
        correlation={"d": fd["correlation"], "t": ft["correlation"]},
        module_assignments=pair["labels"], n_perm=64, device="cpu",
        progress=progress, config=EngineConfig(chunk_size=32, **options),
        mesh=mesh)
    assert len(seen) == 2
    for live in seen:
        assert live["d_correlation"] == 0 and live["d_network"] == 0
        derived = "network_from_correlation" in options
        assert live["t_network"] == (0 if derived else 1)
        # the test correlation is held once: whole, or as the base of its
        # row-block views (the same storage, no second copy)
        assert live["t_correlation"] == 1


def test_later_test_waits_on_the_host():
    """One discovery, two tests, no ``vmap_tests``: while a pair's null
    runs, no discovery matrix is alive, the pair's own test matrices are
    held by its engine, the other test's correlation only while a later
    pair needs it."""
    pair = make_example_pair(np.random.default_rng(3))
    other = make_example_pair(np.random.default_rng(4))
    fd, ft = pair_frames(pair)
    _, f2 = pair_frames(other)
    f32 = {k: torch.as_tensor(np.asarray(f["correlation"], np.float32))
           for k, f in (("d", fd), ("t", ft), ("t2", f2))}
    seen = []

    def progress(done, total):
        seen.append({k: _live_equal(v, f32.values())
                     for k, v in f32.items()})

    res = module_preservation(
        {"d": fd["network"], "t": ft["network"], "t2": f2["network"]},
        data={"d": fd["data"], "t": ft["data"], "t2": f2["data"]},
        correlation={"d": fd["correlation"], "t": ft["correlation"],
                     "t2": f2["correlation"]},
        module_assignments=pair["labels"], discovery="d", test=["t", "t2"],
        n_perm=64, device="cpu", progress=progress,
        config=EngineConfig(chunk_size=32))
    assert seen == [{"d": 0, "t": 1, "t2": 1}] * 2 + [
        {"d": 0, "t": 0, "t2": 1}] * 2
    # each pair's p-values are those of its own call
    for name in ("t", "t2"):
        f = {"d": fd, "t": ft, "t2": f2}
        alone = module_preservation(
            {k: f[k]["network"] for k in ("d", name)},
            data={k: f[k]["data"] for k in ("d", name)},
            correlation={k: f[k]["correlation"] for k in ("d", name)},
            module_assignments=pair["labels"], discovery="d", test=name,
            n_perm=64, device="cpu", config=EngineConfig(chunk_size=32))
        np.testing.assert_array_equal(res[name].p_values, alone.p_values)
