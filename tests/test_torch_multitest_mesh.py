"""The port's multi-test engine on a mesh (``vmap_tests=True`` with
``mesh=``) against the JAX package's on the same numpy inputs, on the CPU:
the port's meshes repeat the CPU device (``make_mesh(p, r, devices=[cpu] *
(p * r))``), the JAX package runs on its virtual 8-device CPU mesh
(``tests/conftest.py``). The cases mirror ``tests/test_sharding.py``'s
multi-test ones: a perm mesh (2×1) over replicated matrices, row-sharded
matrices on 1×4 and 2×4 (the psum gather), the fixed materialized,
streaming and adaptive loops, a checkpoint resumed across mesh shapes, a
derived network, ragged sample counts and the error texts.

Tolerances, as in ``tests/test_torch_engine.py``: observed values 1e-5
absolute; null values 1e-5 for at least 99.9% of them and all within 1e-4
(ROADMAP.md Queue 3); module sets, counts, p-values and ``n_perm_used``
EQUAL. Within the port a mesh changes nothing: every cohort's null on a
mesh equals the unsplit multi-test run's bit for bit.

Fixture: ``make_example_pair(default_rng(3))`` (80 test nodes, four
planted modules) with a second test cohort from ``default_rng(4)`` in the
first cohort's node order (``ragged``: with 28 samples instead of 35),
chunk 32, 96 permutations (adaptive: a ceiling of 384), seed 7.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

import netrep_tpu  # noqa: E402
from netrep_tpu.data import make_example_pair, pair_frames  # noqa: E402
from netrep_tpu.parallel import mesh as jmesh  # noqa: E402
from netrep_tpu.parallel.engine import ModuleSpec as JSpec  # noqa: E402
from netrep_tpu.parallel.multitest import MultiTestEngine as JMulti  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch import random as trandom  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from netrep_tpu_torch.parallel.engine import ModuleSpec  # noqa: E402
from netrep_tpu_torch.parallel.multitest import MultiTestEngine  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

from test_torch_engine import ATOL, assert_null_close  # noqa: E402

CPU = torch.device("cpu")
N_PERM, CEILING, SEED, CHUNK = 96, 384, 7, 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: beside other test
    processes, torch's per-core pool only contends for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cpu_mesh(p, r):
    return tmesh.make_mesh(p, r, devices=[CPU] * (p * r))


def _cohorts(ragged: bool):
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    kw = {} if not ragged else dict(n_samples_test=28)
    _d2, t2 = pair_frames(make_example_pair(np.random.default_rng(4), **kw))
    idx = t["network"].index
    t2 = {"network": t2["network"].loc[idx, idx],
          "correlation": t2["correlation"].loc[idx, idx],
          "data": t2["data"][idx]}
    return pair["labels"], d, t, t2


def _frames(ragged=False, derived=False) -> dict:
    labels, d, t, t2 = _cohorts(ragged)
    sets = {"d": d, "t": t, "t2": t2}
    if derived:
        sets = {k: dict(v, network=np.abs(v["correlation"]) ** 2.0)
                for k, v in sets.items()}
    return dict(
        network={k: v["network"] for k, v in sets.items()},
        correlation={k: v["correlation"] for k, v in sets.items()},
        data={k: v["data"] for k, v in sets.items()},
        module_assignments=labels, discovery="d", test=["t", "t2"],
        vmap_tests=True, n_perm=N_PERM, seed=SEED)


FRAMES = _frames()

#: mesh shape and sharding of each case
MESHES = {"perm2x1": ((2, 1), "replicated"), "row1x4": ((1, 4), "row"),
          "row2x4": ((2, 4), "row")}
#: the loops
LOOPS = {"fixed": dict(store_nulls=True),
         "stream": dict(store_nulls=False),
         "adaptive": dict(adaptive=True, n_perm=CEILING),
         "adaptive_stream": dict(adaptive=True, store_nulls=False,
                                 n_perm=CEILING)}


def _jax(frames, shape=None, sharding="replicated", **kw):
    return netrep_tpu.module_preservation(
        **{**frames, **kw},
        config=JConfig(chunk_size=CHUNK, autotune=False,
                       matrix_sharding=sharding),
        mesh=None if shape is None else jmesh.make_mesh(*shape))


def _port(frames, shape=None, sharding="replicated", config=None, **kw):
    return module_preservation(
        **{**frames, **kw}, device="cpu",
        config=config or EngineConfig(chunk_size=CHUNK,
                                      matrix_sharding=sharding),
        mesh=None if shape is None else cpu_mesh(*shape))


def assert_same_result(rt, rj):
    """The port's two-cohort result against the JAX package's."""
    assert rt.keys() == rj.keys() == {"t", "t2"}
    for name in rt:
        a, b = rt[name], rj[name]
        assert a.module_labels == b.module_labels
        assert a.completed == b.completed
        np.testing.assert_allclose(a.observed, b.observed, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(a.p_values, b.p_values)
        if a.n_perm_used is not None or b.n_perm_used is not None:
            np.testing.assert_array_equal(a.n_perm_used, b.n_perm_used)
        for f in ("counts_hi", "counts_lo", "counts_eff"):
            if getattr(b, f) is not None:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        if b.nulls is not None:
            assert_null_close(a.nulls, b.nulls)


def assert_bit_equal(got, want):
    for name in want:
        for f in ("p_values", "nulls", "counts_hi", "counts_lo",
                  "counts_eff", "n_perm_used", "observed"):
            np.testing.assert_array_equal(getattr(got[name], f),
                                          getattr(want[name], f))


_UNSPLIT: dict = {}


def unsplit(loop: str):
    """The port's unsplit two-cohort run of ``loop``."""
    if loop not in _UNSPLIT:
        _UNSPLIT[loop] = _port(FRAMES, **LOOPS[loop])
    return _UNSPLIT[loop]


@pytest.mark.parametrize("loop", LOOPS)
@pytest.mark.parametrize("case", MESHES)
def test_vmap_tests_mesh_matches_jax(case, loop):
    shape, sharding = MESHES[case]
    rt = _port(FRAMES, shape, sharding, **LOOPS[loop])
    if loop == "adaptive":
        # the JAX package's module_preservation passes priors= to its
        # multi-test adaptive null, which takes none (ROADMAP.md Queue 3,
        # reference side): its engines are held against the port's
        _adaptive_engines_match(shape, sharding)
    else:
        assert_same_result(rt, _jax(FRAMES, shape, sharding,
                                    **LOOPS[loop]))
    # a mesh changes nothing in the port: the unsplit run, bit for bit
    assert_bit_equal(rt, unsplit(loop))
    if loop.startswith("adaptive"):
        assert rt["t"].n_perm_used.min() < CEILING


def _adaptive_engines_match(shape, sharding):
    """The materialized adaptive null of both packages' multi-test engines
    on a mesh of ``shape``: the same retirements (``completed``, the NaN
    pattern, so ``n_perm_used``), the values within the null tolerance."""
    je, te = _engines(
        FRAMES, shape,
        JConfig(chunk_size=CHUNK, autotune=False, matrix_sharding=sharding),
        EngineConfig(chunk_size=CHUNK, matrix_sharding=sharding))
    obs = np.asarray(je.observed())
    nj, cj, fj = je.run_null_adaptive(CEILING, obs, key=SEED)
    nt, ct, ft = te.run_null_adaptive(CEILING, obs, key=SEED)
    assert (ct, ft) == (cj, fj) and np.isnan(nt).any()  # one retired
    assert_null_close(nt, np.asarray(nj))


def _interrupted(pkg, ckdir, shape, sharding):
    """A two-cohort run stopped by its progress callback after two
    chunks, its checkpoint in ``ckdir``."""
    calls = []

    def stop(done, total):
        calls.append(done)
        if len(calls) == 2:
            raise KeyboardInterrupt

    run = _port if pkg == "port" else _jax
    res = run(FRAMES, shape, sharding, progress=stop,
              checkpoint_dir=str(ckdir), checkpoint_every=CHUNK)
    assert 0 < res["t"].completed < N_PERM
    return res


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("resume", [None, "row1x4", "row2x4"],
                         ids=["unsplit", "row1x4", "row2x4"])
def test_checkpoint_resumes_across_mesh_shapes(tmp_path, writer, resume):
    """Checkpointed on 2×1 (by either package), resumed unsplit or on a row
    mesh: the uninterrupted run, bit for bit; the fingerprint does not
    depend on the mesh."""
    _interrupted(writer, tmp_path, (2, 1), "replicated")
    shape, sharding = (None, "replicated") if resume is None else \
        MESHES[resume]
    got = _port(FRAMES, shape, sharding, checkpoint_dir=str(tmp_path))
    assert got["t"].completed == N_PERM
    want = unsplit("fixed")
    for name in want:
        np.testing.assert_array_equal(got[name].p_values,
                                      want[name].p_values)
        if writer == "port":
            np.testing.assert_array_equal(got[name].nulls, want[name].nulls)
        else:
            # the JAX package's rows up to its interrupt, the port's after
            assert_null_close(got[name].nulls, want[name].nulls)


def _engines(frames, shape, jcfg, tcfg):
    """The JAX and the port multi-test engines of ``frames`` on a mesh of
    ``shape``, from the same numpy matrices (test nodes in the discovery
    order of the overlap, as ``tests/test_sharding.py`` builds them)."""
    d = {k: np.asarray(frames[k]["d"]) for k in ("network", "correlation",
                                                 "data")}
    names = list(frames["network"]["t"].index)
    disc_names = list(frames["network"]["d"].index)
    tests = [{k: (np.asarray(frames[k][t].loc[names, names]) if k != "data"
                  else np.asarray(frames[k][t][names]))
              for k in ("network", "correlation", "data")}
             for t in ("t", "t2")]
    pos = {nm: i for i, nm in enumerate(names)}
    labels = frames["module_assignments"]
    specs = []
    for lab in sorted({v for v in labels.values() if v != "0"}):
        members = [nm for nm in disc_names if labels.get(nm) == lab
                   and nm in pos]
        specs.append((lab, np.asarray([disc_names.index(nm)
                                       for nm in members]),
                      np.asarray([pos[nm] for nm in members])))
    pool = np.arange(len(names))
    args = (d["correlation"], d["network"], d["data"],
            [t["correlation"] for t in tests], [t["network"] for t in tests],
            [t["data"] for t in tests])
    je = JMulti(args[0], args[1], args[2], np.stack(args[3]),
                np.stack(args[4]), list(args[5]),
                [JSpec(*s) for s in specs], pool, config=jcfg,
                mesh=jmesh.make_mesh(*shape))
    te = MultiTestEngine(*args, [ModuleSpec(*s) for s in specs], pool,
                         config=tcfg, device="cpu", mesh=cpu_mesh(*shape))
    return je, te


@pytest.mark.parametrize("case", ["ragged", "derived", "derived_ragged"])
@pytest.mark.parametrize("mesh", ["perm2x1", "row2x4"])
def test_ragged_and_derived_on_mesh(case, mesh):
    shape, sharding = MESHES[mesh]
    frames = _frames(ragged="ragged" in case, derived="derived" in case)
    beta = 2.0 if "derived" in case else None
    je, te = _engines(
        frames, shape,
        JConfig(chunk_size=CHUNK, autotune=False, matrix_sharding=sharding,
                network_from_correlation=beta),
        EngineConfig(chunk_size=CHUNK, matrix_sharding=sharding,
                     network_from_correlation=beta))
    assert te.mesh.shape == dict(zip(("perm", "row"), shape))
    if beta is not None:
        assert all(c._test_net is None and c._rows_n is None
                   for c in te.cohorts)
    obs = np.asarray(je.observed())
    np.testing.assert_allclose(te.observed(), obs, rtol=0, atol=ATOL)
    nulls_t, done = te.run_null(N_PERM, key=SEED)
    assert done == N_PERM and nulls_t.shape[0] == 2
    assert_null_close(nulls_t, np.asarray(je.run_null(N_PERM, key=SEED)[0]))


def test_error_texts():
    labels_frames = _frames()
    row = dict(matrix_sharding="row", stat_mode="fused")
    with pytest.raises(ValueError) as want:
        _engines(labels_frames, (2, 4),
                 JConfig(chunk_size=CHUNK, autotune=False, **row),
                 EngineConfig(chunk_size=CHUNK))
    with pytest.raises(ValueError) as got:
        _engines(labels_frames, (1, 2),
                 JConfig(chunk_size=CHUNK, autotune=False),
                 EngineConfig(chunk_size=CHUNK, **row))
    assert str(got.value) == str(want.value)
    # 'auto' on row-sharded matrices is the composed statistics, and no
    # cohort takes the ring: the chunk rounds over the perm axis only
    _je, te = _engines(labels_frames, (2, 4),
                       JConfig(chunk_size=CHUNK, autotune=False),
                       EngineConfig(chunk_size=30, matrix_sharding="row"))
    assert te.stat_mode == "xla" and te.effective_chunk() == 30
    assert not any(c._stat_fused_ring() for c in te.cohorts)
    for shape in ((2, 1), (1, 4)):
        cfg = dict(null_precision="bf16_rescue", stat_mode="xla",
                   matrix_sharding="row" if shape[1] > 1 else "replicated")
        with pytest.raises(ValueError) as want:
            _engines(labels_frames, shape,
                     JConfig(chunk_size=CHUNK, autotune=False, **cfg),
                     EngineConfig(chunk_size=CHUNK))
        with pytest.raises(ValueError) as got:
            _port(labels_frames, shape,
                  config=EngineConfig(chunk_size=CHUNK, **cfg))
        assert str(got.value) == str(want.value)


def test_one_draw_per_shard_and_rebucket_drops_views(monkeypatch):
    """Each perm shard draws its slice of the keys once for every cohort
    (never once per cohort), and ``rebucket`` drops every cohort's shard
    views with its buckets, so a chunk after it computes only the
    survivors."""
    frames = _frames()
    _je, te = _engines(frames, (2, 1),
                       JConfig(chunk_size=CHUNK, autotune=False),
                       EngineConfig(chunk_size=CHUNK))
    draws = []
    real = trandom.permutation

    def counted(keys, pool):
        draws.append(keys.words.shape[0])
        return real(keys, pool)

    monkeypatch.setattr(trandom, "permutation", counted)
    keys = trandom.perm_keys(trandom.key(SEED, device=CPU), 0, CHUNK)
    full = te._chunk(keys)
    assert draws == [CHUNK // 2, CHUNK // 2]  # one draw per shard, T = 2
    assert all(o.shape[:2] == (2, CHUNK) for o in full)
    assert all(c._shards is not None for c in te.cohorts)
    te.rebucket([0, 2])
    assert all(c._shards is None for c in te.cohorts)
    draws.clear()
    part = te._chunk(keys)
    assert draws == [CHUNK // 2, CHUNK // 2]
    kept = {p for b in te.buckets for p in b.module_pos}
    assert kept == {0, 2}
    for _sl, views in te._plans():
        assert all({p for b in v.buckets for p in b.module_pos} == kept
                   for v in views)
    # each survivor's values are the full chunk's
    at = {p: (i, j) for i, fb in enumerate(te.cohorts[0]._buckets_full)
          for j, p in enumerate(fb.module_pos)}
    for b, o in zip(te.buckets, part):
        for k, p in enumerate(b.module_pos):
            i, j = at[p]
            np.testing.assert_array_equal(o[:, :, k].numpy(),
                                          full[i][:, :, j].numpy())
