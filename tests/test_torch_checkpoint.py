"""Checkpoint/resume of the port's nulls (``netrep_tpu_torch.utils.
checkpoint``) against the JAX package's on the same inputs and seed.

A resumed run equals the uninterrupted one: nulls bit for bit, tallies,
counts and p-values equal — in both null modes, from a checkpoint written
on a 2×1 perm mesh or a 1×4 row mesh into the unsplit engine, and through
``module_preservation(checkpoint_dir=...)``. The refusals carry the JAX
package's texts. The two packages share the file format, the key data and
the fingerprint (the cross-package choice is to resume): a checkpoint the
JAX package wrote, interrupted by a ``progress`` callback that raises
``KeyboardInterrupt``, resumes in the port to the JAX package's
uninterrupted counts and p-values, and the reverse. Values of the two
packages differ by float32 rounding (``tests/test_torch_engine.py``), so
across packages only counts and p-values are held exactly."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import netrep_tpu  # noqa: E402
from netrep_tpu.data import make_mixed_pair, pair_frames  # noqa: E402
from netrep_tpu.ops import pvalues as jpv  # noqa: E402
from netrep_tpu.parallel.engine import ModuleSpec as JSpec  # noqa: E402
from netrep_tpu.parallel.engine import PermutationEngine as JEngine  # noqa: E402
from netrep_tpu.parallel.multitest import MultiTestEngine as JMulti  # noqa: E402
from netrep_tpu.utils import checkpoint as jck  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.parallel.engine import ModuleSpec  # noqa: E402
from netrep_tpu_torch.parallel.engine import PermutationEngine  # noqa: E402
from netrep_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from netrep_tpu_torch.parallel.multitest import MultiTestEngine  # noqa: E402
from netrep_tpu_torch.utils import checkpoint as tck  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

N_PERM = 300  # chunk 64: a partial tail chunk
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
def mixed():
    return make_mixed_pair(320, 6, n_samples=40, seed=7)


def _mats(mixed):
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    return dc, dn, dd, tc, tn, td


def _port(mixed, mesh=None, **cfg):
    cfg = {"chunk_size": 64, **cfg}
    return PermutationEngine(
        *_mats(mixed), [ModuleSpec(lab, i, i) for lab, i in mixed["specs"]],
        mixed["pool"], config=EngineConfig(**cfg), device="cpu", mesh=mesh)


def _jax(mixed, **cfg):
    cfg = {"chunk_size": 64, "autotune": False, **cfg}
    return JEngine(*_mats(mixed),
                   [JSpec(lab, i, i) for lab, i in mixed["specs"]],
                   mixed["pool"], config=JConfig(**cfg))


def _stop_after(n):
    """A progress callback that raises ``KeyboardInterrupt`` at its n-th
    call (after the n-th chunk or superchunk)."""
    calls = []

    def progress(done, total):
        calls.append(done)
        if len(calls) == n:
            raise KeyboardInterrupt

    return progress


def _run(engine, mode, observed, **kw):
    """``(nulls or None, (hi, lo, eff), completed)`` of a fixed run."""
    if mode == "materialized":
        nulls, done = engine.run_null(N_PERM, **kw)
        return nulls, jpv.tail_counts(observed, nulls[:done]), done
    s = engine.run_null_streaming(N_PERM, observed, **kw)
    return None, (s.hi, s.lo, s.eff), s.completed


def _assert_same(got, want):
    if want[0] is not None:
        np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


MESHES = {
    "unsplit": lambda: (None, {}),
    "perm2x1": lambda: (make_mesh(2, 1, devices=[CPU] * 2), {}),
    "row1x4": lambda: (make_mesh(1, 4, devices=[CPU] * 4),
                       {"matrix_sharding": "row"}),
}


@pytest.mark.parametrize("written_on", list(MESHES))
@pytest.mark.parametrize("mode", ("materialized", "streaming"))
def test_exact_resume(mixed, tmp_path, mode, written_on):
    """Interrupted after the second chunk (streaming: superchunks of one
    chunk) on ``written_on``, resumed on the unsplit engine: equal to the
    uninterrupted unsplit run. The fingerprint does not depend on the
    mesh."""
    ref = _port(mixed, superchunk=1)
    observed = ref.observed()
    want = _run(ref, mode, observed, key=5)
    path = str(tmp_path / "null.npz")
    mesh, cfg = MESHES[written_on]()
    part = _run(_port(mixed, mesh=mesh, superchunk=1, **cfg), mode, observed,
                key=5, progress=_stop_after(2), checkpoint_path=path,
                checkpoint_every=64)
    assert part[2] == 128
    saved = tck.load_null_checkpoint(path)
    assert saved["completed"] == 128
    got = _run(_port(mixed, superchunk=1), mode, observed, key=5,
               checkpoint_path=path, checkpoint_every=64)
    _assert_same(got, want)
    assert tck.load_null_checkpoint(path)["completed"] == N_PERM


@pytest.mark.parametrize("resumed_on", ("perm2x1", "row1x4"))
def test_unsplit_checkpoint_resumes_on_a_mesh(mixed, tmp_path, resumed_on):
    """The reverse direction: written unsplit, resumed on a mesh — the
    rows before the interrupt kept bit for bit, the counts of the whole
    null equal the unsplit run's."""
    ref = _port(mixed)
    observed = ref.observed()
    want = _run(ref, "materialized", observed, key=5)
    path = str(tmp_path / "null.npz")
    part = _run(_port(mixed), "materialized", observed, key=5,
                progress=_stop_after(2), checkpoint_path=path)
    mesh, cfg = MESHES[resumed_on]()
    got = _run(_port(mixed, mesh=mesh, **cfg), "materialized", observed,
               key=5, checkpoint_path=path)
    assert got[2] == N_PERM
    np.testing.assert_array_equal(got[0][:128], part[0][:128])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)


def test_completed_checkpoint_short_circuits(mixed, tmp_path, monkeypatch):
    path = str(tmp_path / "null.npz")
    a, _ = _port(mixed).run_null(N_PERM, key=0, checkpoint_path=path)
    eng = _port(mixed)

    def boom(keys):
        raise AssertionError("a finished checkpoint must not recompute")

    monkeypatch.setattr(eng, "_chunk", boom)
    b, done = eng.run_null(N_PERM, key=0, checkpoint_path=path)
    assert done == N_PERM
    np.testing.assert_array_equal(a, b)
    small, done = eng.run_null(100, key=0, checkpoint_path=path)
    assert small.shape[0] == done == 100
    np.testing.assert_array_equal(small, a[:100])


def test_error_saves_completed_chunks(mixed, tmp_path):
    """An exception other than an interrupt saves what completed before it
    propagates; the resumed run equals the uninterrupted one."""
    path = str(tmp_path / "null.npz")
    calls = []

    def fail(done, total):
        calls.append(done)
        if len(calls) == 3:
            raise RuntimeError("lost the card")

    with pytest.raises(RuntimeError, match="lost the card"):
        _port(mixed).run_null(N_PERM, key=2, progress=fail,
                              checkpoint_path=path, checkpoint_every=8192)
    assert tck.load_null_checkpoint(path)["completed"] == 192
    got, _ = _port(mixed).run_null(N_PERM, key=2, checkpoint_path=path)
    want, _ = _port(mixed).run_null(N_PERM, key=2)
    np.testing.assert_array_equal(got, want)


def _refusal(run, path):
    with pytest.raises(ValueError) as err:
        run(path)
    return str(err.value)


@pytest.mark.parametrize("case", ("wrong_seed", "wrong_problem",
                                  "stream_into_materialized",
                                  "materialized_into_stream",
                                  "foreign_npz", "old_version"))
def test_refusal_texts_equal_jax(mixed, tmp_path, case):
    """Each package refuses the same checkpoint with the same text."""
    path = str(tmp_path / "ckpt.npz")
    observed = _port(mixed).observed()
    if case == "foreign_npz":
        np.savez(path, result_version=np.int64(1))
    elif case == "old_version":
        np.savez(path, version=np.int64(3))
    elif case == "stream_into_materialized":
        _port(mixed).run_null_streaming(64, observed, key=3,
                                        checkpoint_path=path)
    else:
        _port(mixed).run_null(64, key=3, checkpoint_path=path)

    sizes = {"wrong_problem": [(lab, i[:-1]) for lab, i in mixed["specs"]]}

    def engines():
        specs = sizes.get(case, mixed["specs"])
        key = 4 if case == "wrong_seed" else 3
        t = PermutationEngine(*_mats(mixed),
                              [ModuleSpec(lab, i, i) for lab, i in specs],
                              mixed["pool"], EngineConfig(chunk_size=64),
                              device="cpu")
        j = JEngine(*_mats(mixed), [JSpec(lab, i, i) for lab, i in specs],
                    mixed["pool"], JConfig(chunk_size=64, autotune=False))
        return t, j, key

    t, j, key = engines()
    if case == "materialized_into_stream":
        got = _refusal(lambda p: t.run_null_streaming(
            128, observed, key=key, checkpoint_path=p), path)
        want = _refusal(lambda p: j.run_null_streaming(
            128, observed, key=key, checkpoint_path=p), path)
    else:
        got = _refusal(lambda p: t.run_null(128, key=key,
                                            checkpoint_path=p), path)
        want = _refusal(lambda p: j.run_null(128, key=key,
                                             checkpoint_path=p), path)
    assert got == want
    expect = {"wrong_seed": "different PRNG key",
              "wrong_problem": "different problem",
              "stream_into_materialized": "different problem",
              "materialized_into_stream": "no streaming tallies",
              "foreign_npz": "not a null checkpoint",
              "old_version": "format version 3"}[case]
    assert expect in got


def test_from_parts_engine_without_identity_refuses(mixed, tmp_path):
    from netrep_tpu_torch.state import engine_state_from_numpy

    e = _port(mixed)
    state = dict(
        pool=e.pool, test_corr=e._test_corr.numpy(),
        test_net=e._test_net.numpy(), test_dataT=e._test_dataT.numpy(),
        n_modules=e.n_modules, key_data=np.zeros(2, np.uint32),
        buckets=[dict(cap=b.cap, module_pos=b.module_pos, slices=b.slices,
                      obs_idx=b.obs_idx.numpy(),
                      **{f: getattr(b.disc, f).numpy()
                         for f in b.disc._fields})
                 for b in e.buckets])
    bare, _key = engine_state_from_numpy(state, EngineConfig(chunk_size=64),
                                         device="cpu")
    with pytest.raises(ValueError, match="no checkpoint identity"):
        bare.run_null(64, checkpoint_path=str(tmp_path / "x.npz"))
    assert not os.path.exists(tmp_path / "x.npz")


# ---------------------------------------------------------------------------
# Across packages: the same file, key data and fingerprint
# ---------------------------------------------------------------------------

def test_fingerprint_equals_jax(mixed):
    t, j = _port(mixed), _jax(mixed)
    np.testing.assert_array_equal(tck.engine_fingerprint(t),
                                  jck.engine_fingerprint(j))
    # tensors are digested where they lie, as float32 like JAX arrays
    mats = [torch.as_tensor(m) for m in _mats(mixed)]
    assert tck.content_digest(mats) == jck.content_digest(
        [np.asarray(m) for m in _mats(mixed)])


@pytest.mark.parametrize("direction", ("jax_to_port", "port_to_jax"))
@pytest.mark.parametrize("mode", ("materialized", "streaming"))
def test_cross_package_resume(mixed, tmp_path, mode, direction):
    """One package writes a checkpoint, interrupted after two chunks; the
    other resumes it to the counts and p-values of the resuming package's
    own uninterrupted run (values of the two packages differ only by
    float32 rounding; the rows written before the interrupt are kept)."""
    path = str(tmp_path / "null.npz")
    writer, reader = ((_jax(mixed, superchunk=1), _port(mixed, superchunk=1))
                      if direction == "jax_to_port" else
                      (_port(mixed, superchunk=1), _jax(mixed, superchunk=1)))
    observed = np.asarray(_jax(mixed).observed())
    part = _run(writer, mode, observed, key=9, progress=_stop_after(2),
                checkpoint_path=path, checkpoint_every=64)
    assert part[2] == 128
    got = _run(reader, mode, observed, key=9, checkpoint_path=path)
    want = _run(reader, mode, observed, key=9)
    assert got[2] == want[2] == N_PERM
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    if mode == "materialized":
        np.testing.assert_array_equal(np.asarray(got[0])[:128],
                                      np.asarray(part[0])[:128])
        np.testing.assert_array_equal(np.asarray(got[0])[128:],
                                      np.asarray(want[0])[128:])
        np.testing.assert_array_equal(
            jpv.permutation_pvalues(observed, np.asarray(got[0])),
            jpv.permutation_pvalues(observed, np.asarray(want[0])))


def _cohorts():
    a = make_mixed_pair(200, 4, n_samples=30, seed=3)
    b = make_mixed_pair(200, 4, n_samples=22, seed=4)
    (dd, dc, dn) = a["discovery"]
    tests = [a["test"], b["test"]]
    return ((dc, dn, dd), [t[1] for t in tests], [t[2] for t in tests],
            [t[0] for t in tests], a["specs"], a["pool"])


@pytest.mark.parametrize("mode", ("materialized", "streaming"))
def test_multitest_resume_across_packages(tmp_path, mode):
    """The multi-test engine's checkpoint (permutation axis second, the
    test side in the fingerprint) written by the JAX package resumes in
    the port to the port's uninterrupted tallies; the fingerprints are
    equal."""
    disc, corrs, nets, datas, specs, pool = _cohorts()
    port = MultiTestEngine(*disc, corrs, nets, datas,
                           [ModuleSpec(lab, i, i) for lab, i in specs], pool,
                           EngineConfig(chunk_size=64, superchunk=1),
                           device="cpu")
    jax_e = JMulti(*disc, np.stack(corrs), np.stack(nets), datas,
                   [JSpec(lab, i, i) for lab, i in specs], pool,
                   config=JConfig(chunk_size=64, superchunk=1,
                                  autotune=False))
    np.testing.assert_array_equal(
        tck.engine_fingerprint(port), jck.engine_fingerprint(jax_e._base))
    assert port._fingerprint_extra() == jax_e._fingerprint_extra()
    observed = np.asarray(jax_e.observed())
    path = str(tmp_path / "multi.npz")

    def run(e, **kw):
        if mode == "materialized":
            nulls, done = e.run_null(N_PERM, key=1, **kw)
            nulls = np.asarray(nulls)
            return [jpv.tail_counts(observed[t], nulls[t, :done])
                    for t in range(2)], done
        s = e.run_null_streaming(N_PERM, observed, key=1, **kw)
        return [(s.hi[t], s.lo[t], s.eff[t]) for t in range(2)], s.completed

    _, done = run(jax_e, progress=_stop_after(2), checkpoint_path=path,
                  checkpoint_every=64)
    assert done == 128
    got, done = run(port, checkpoint_path=path)
    want, _ = run(port)
    assert done == N_PERM
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# module_preservation(checkpoint_dir=...)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames(toy_pair_module):
    d, t = pair_frames(toy_pair_module)
    return dict(
        network={"disc": d["network"], "test": t["network"]},
        data={"disc": d["data"], "test": t["data"]},
        correlation={"disc": d["correlation"], "test": t["correlation"]},
        module_assignments=dict(toy_pair_module["labels"]),
        discovery="disc", test="test", n_perm=320, seed=11,
    )


@pytest.mark.parametrize("store_nulls", (True, False))
def test_checkpoint_dir_resumes_interrupted_run(frames, tmp_path,
                                                store_nulls):
    """A run interrupted after two chunks returns its partial result and
    leaves ``null_disc__test.npz``; the same call again finishes it, equal
    to an uninterrupted run."""
    kw = dict(frames, device="cpu", store_nulls=store_nulls,
              config=EngineConfig(chunk_size=64, superchunk=1),
              checkpoint_dir=str(tmp_path), checkpoint_every=64)
    part = module_preservation(**kw, progress=_stop_after(2))
    assert part.completed == 128
    assert os.listdir(tmp_path) == ["null_disc__test.npz"]
    done = module_preservation(**kw)
    want = module_preservation(**{k: v for k, v in kw.items()
                                  if k not in ("checkpoint_dir",
                                               "checkpoint_every")})
    assert done.completed == want.completed == 320
    np.testing.assert_array_equal(done.p_values, want.p_values)
    if store_nulls:
        np.testing.assert_array_equal(done.nulls, want.nulls)
    else:
        for f in ("counts_hi", "counts_lo", "counts_eff"):
            np.testing.assert_array_equal(getattr(done, f), getattr(want, f))


def test_checkpoint_dir_resumes_a_jax_checkpoint(frames, tmp_path):
    """``module_preservation`` of either package resumes the other's
    checkpoint of the same call: the identity samples the user's inputs as
    the JAX package samples its float64 datasets."""
    kw = dict(frames, checkpoint_dir=str(tmp_path), checkpoint_every=64)
    cfg = dict(chunk_size=64)
    part = netrep_tpu.module_preservation(
        **kw, config=JConfig(autotune=False, **cfg),
        progress=_stop_after(2))
    assert part.completed == 128
    got = module_preservation(**kw, config=EngineConfig(**cfg), device="cpu")
    want = netrep_tpu.module_preservation(
        **frames, config=JConfig(autotune=False, **cfg))
    assert got.completed == 320
    np.testing.assert_array_equal(got.p_values, want.p_values)
    np.testing.assert_array_equal(got.nulls[:128], part.nulls[:128])


@pytest.mark.parametrize("writer", ("port", "jax"))
def test_vmap_tests_checkpoint_dir(tmp_path, writer):
    """A multi-test group saves to ``null_<d>__<t1>_<t2>.npz`` (the JAX
    package's name); the port resumes its own or the JAX package's
    checkpoint of the same call to the uninterrupted run's p-values (and,
    its own, nulls bit for bit)."""
    disc, corrs, nets, datas, specs, pool = _cohorts()
    labels = np.zeros(200, dtype=int)
    for k, (_lab, idx) in enumerate(specs):
        labels[idx] = k + 1
    kw = dict(network={"d": disc[1], "t1": nets[0], "t2": nets[1]},
              correlation={"d": disc[0], "t1": corrs[0], "t2": corrs[1]},
              data={"d": disc[2], "t1": datas[0], "t2": datas[1]},
              module_assignments=labels, discovery="d", test=["t1", "t2"],
              vmap_tests=True, n_perm=200, seed=2,
              checkpoint_dir=str(tmp_path), checkpoint_every=64)
    port = dict(device="cpu", config=EngineConfig(chunk_size=64))
    if writer == "port":
        part = module_preservation(**kw, **port, progress=_stop_after(1))
    else:
        part = netrep_tpu.module_preservation(
            **kw, config=JConfig(chunk_size=64, autotune=False),
            progress=_stop_after(1))
    assert part["t1"].completed == 64
    assert os.listdir(tmp_path) == ["null_d__t1_t2.npz"]
    done = module_preservation(**kw, **port)
    want = module_preservation(**{k: v for k, v in kw.items()
                                  if k != "checkpoint_dir"}, **port)
    for t in ("t1", "t2"):
        assert done[t].completed == 200
        np.testing.assert_array_equal(done[t].p_values, want[t].p_values)
        np.testing.assert_array_equal(done[t].nulls[:64],
                                      np.asarray(part[t].nulls)[:64])
        if writer == "port":
            np.testing.assert_array_equal(done[t].nulls, want[t].nulls)
