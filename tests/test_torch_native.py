"""The port's native C++ tier (``netrep_tpu_torch/native``) against the JAX
package's (``netrep_tpu/native``) on the same numpy inputs.

Both compile their own copy of ``netstats.cpp``; the counter-based RNG
(``splitmix64(seed ^ f(p))`` seeding one ``mt19937_64`` per permutation)
is the same, so observed statistics, nulls, counts and p-values must be
EQUAL, bit for bit (``np.array_equal``), at any thread count and chunking,
and native checkpoints cross packages both ways. The port's library lands
in its kernel-library store (``NETREP_AOT_STORE``), never in a package
directory; no compiler and no library raises.
"""

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import netrep_tpu  # noqa: E402
from netrep_tpu import native as jnative  # noqa: E402
from netrep_tpu.data import make_example_pair, pair_frames  # noqa: E402
from netrep_tpu.parallel.engine import ModuleSpec as JSpec  # noqa: E402
from netrep_tpu_torch import native as tnative  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.native import build as tbuild  # noqa: E402
from netrep_tpu_torch.ops import oracle  # noqa: E402
from netrep_tpu_torch.ops import pvalues as pv  # noqa: E402
from netrep_tpu_torch.parallel.engine import ModuleSpec  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if not tnative.available():  # pragma: no cover - g++ is in the image
    pytest.skip("no C++ toolchain available", allow_module_level=True)


def _problem(rng, n_disc=40, n_test=36, s_d=30, s_t=24,
             module_sizes=(8, 6, 5), with_data=True):
    """``tests/test_native.py``'s fixture: planted modules in a prefix."""
    def build(n, s):
        x = rng.standard_normal((s, n))
        pos = 0
        for sz in module_sizes:
            latent = rng.standard_normal(s)
            x[:, pos:pos + sz] = latent[:, None] + 0.6 * x[:, pos:pos + sz]
            pos += sz
        c = np.corrcoef(x, rowvar=False)
        return x, c, np.abs(c) ** 2

    d_data, d_corr, d_net = build(n_disc, s_d)
    t_data, t_corr, t_net = build(n_test, s_t)
    specs, pos = [], 0
    for k, sz in enumerate(module_sizes):
        idx = np.arange(pos, pos + sz, dtype=np.int32)
        specs.append((str(k + 1), idx, idx))
        pos += sz
    pool = np.arange(n_test, dtype=np.int32)
    if not with_data:
        d_data = t_data = None
    return (d_corr, d_net, d_data), (t_corr, t_net, t_data), specs, pool


def _example():
    """``make_example_pair`` as one (discovery, test) problem: each planted
    module's nodes present in the (shuffled) test dataset, aligned by
    name; the pool is every test node."""
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair["discovery"], pair["test"]
    dpos = {nm: i for i, nm in enumerate(d["names"])}
    tpos = {nm: i for i, nm in enumerate(t["names"])}
    specs = []
    for k in sorted(set(pair["labels"].values()) - {"0"}, key=int):
        names = [nm for nm, lab in pair["labels"].items()
                 if lab == k and nm in tpos]
        specs.append((k, np.asarray([dpos[nm] for nm in names], np.int32),
                      np.asarray([tpos[nm] for nm in names], np.int32)))
    pool = np.arange(len(t["names"]), dtype=np.int32)
    return ((d["correlation"], d["network"], d["data"]),
            (t["correlation"], t["network"], t["data"]), specs, pool)


def _cores(disc, test, specs, pool):
    """The port's and the JAX package's NativeCore on the same arrays."""
    return (tnative.NativeCore(*disc, *test,
                               [ModuleSpec(*s) for s in specs], pool),
            jnative.NativeCore(*disc, *test, [JSpec(*s) for s in specs],
                               pool))


def _engines(disc, test, specs, pool, **kw):
    return (tnative.NativePermutationEngine(
                *disc, *test, [ModuleSpec(*s) for s in specs], pool, **kw),
            jnative.NativePermutationEngine(
                *disc, *test, [JSpec(*s) for s in specs], pool, **kw))


@pytest.fixture(params=["data", "no_data", "example_pair"])
def problem(request, rng):
    if request.param == "example_pair":
        return _example()
    return _problem(rng, with_data=request.param == "data")


def test_observed_and_null_equal_jax(problem):
    port, jax_core = _cores(*problem)
    got = port.observed()
    np.testing.assert_array_equal(got, jax_core.observed())
    a, done_a = port.null(40, seed=11, n_threads=2)
    b, done_b = jax_core.null(40, seed=11, n_threads=2)
    assert done_a == done_b == 40
    np.testing.assert_array_equal(a, b)
    # the port's float64 oracle agrees with its own native observed pass
    disc, test, specs, _pool = problem
    for k, (_lab, di, ti) in enumerate(specs):
        dp = oracle.DiscoveryProps(
            disc[0][np.ix_(di, di)], disc[1][np.ix_(di, di)],
            disc[2][:, di] if disc[2] is not None else None)
        want = oracle.module_stats(
            dp, test[0][np.ix_(ti, ti)], test[1][np.ix_(ti, ti)],
            test[2][:, ti] if test[2] is not None else None)
        np.testing.assert_allclose(got[k], want, rtol=1e-9, atol=1e-9)


def test_threads_and_chunking_equal(rng):
    port, jax_core = _cores(*_problem(rng))
    one, _ = port.null(48, seed=7, n_threads=1)
    eight, _ = port.null(48, seed=7, n_threads=8)
    np.testing.assert_array_equal(one, eight)
    c1, _ = port.null(20, seed=7, perm_offset=0)
    c2, _ = port.null(28, seed=7, perm_offset=20)
    np.testing.assert_array_equal(np.concatenate([c1, c2]), one)
    jax_one, _ = jax_core.null(48, seed=7, n_threads=3)
    np.testing.assert_array_equal(one, jax_one)
    other, _ = port.null(48, seed=8)
    assert not np.array_equal(one, other)


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


@pytest.mark.parametrize("null", ("overlap", "all"))
@pytest.mark.parametrize("alternative", ("greater", "less", "two.sided"))
def test_module_preservation_equals_jax(frames, alternative, null):
    kw = dict(frames, n_perm=150, seed=5, alternative=alternative,
              null=null, backend="native", n_threads=4)
    rt = module_preservation(**kw, device="cpu")
    rj = netrep_tpu.module_preservation(**kw)
    assert rt.module_labels == rj.module_labels
    assert rt.completed == rj.completed == 150
    assert rt.total_space == rj.total_space
    np.testing.assert_array_equal(rt.observed, rj.observed)
    np.testing.assert_array_equal(rt.nulls, rj.nulls)
    np.testing.assert_array_equal(rt.p_values, rj.p_values)
    for a, b in zip(pv.tail_counts(rt.observed, rt.nulls),
                    pv.tail_counts(rj.observed, rj.nulls)):
        np.testing.assert_array_equal(a, b)


def test_no_device_means_the_host(frames, monkeypatch):
    # the host tier needs no card: device=None runs it on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = module_preservation(**frames, n_perm=32, backend="native")
    ref = netrep_tpu.module_preservation(**frames, n_perm=32,
                                         backend="native")
    np.testing.assert_array_equal(res.p_values, ref.p_values)


@pytest.mark.parametrize("writer", ("port", "jax"))
def test_checkpoints_cross_packages(rng, tmp_path, writer):
    problem = _problem(rng)
    port, jax_eng = _engines(*problem)
    full, done = port.run_null(96, key=5)
    assert done == 96
    first, then = (port, jax_eng) if writer == "port" else (jax_eng, port)
    path = str(tmp_path / "null.npz")
    first.chunk = then.chunk = 64
    _, done_a = first.run_null(64, key=5, checkpoint_path=path,
                               checkpoint_every=32)
    assert done_a == 64
    resumed, done_b = then.run_null(96, key=5, checkpoint_path=path,
                                    checkpoint_every=32)
    assert done_b == 96
    np.testing.assert_array_equal(resumed, full)
    # the identity is the JAX package's: (engine kind, seed) and the
    # fingerprint of the same arrays
    with np.load(path) as z:
        np.testing.assert_array_equal(
            z["key_data"], np.asarray([0x6E61746976, 5], np.uint64))


def test_checkpoint_of_the_card_engine_is_refused(rng, tmp_path):
    # a Threefry null never splices into the native stream
    problem = _problem(rng)
    port, _ = _engines(*problem)
    path = str(tmp_path / "null.npz")
    port.run_null(64, key=5, checkpoint_path=path)
    other, _ = _engines(*problem)
    with pytest.raises(ValueError):
        other.run_null(96, key=6, checkpoint_path=path)


@pytest.mark.parametrize("seed", (-7, 2**64 - 5, 2**63 + 11))
def test_seeds_equal_jax(rng, seed):
    port, jax_eng = _engines(*_problem(rng))
    a, _ = port.run_null(32, key=seed)
    b, _ = jax_eng.run_null(32, key=seed)
    np.testing.assert_array_equal(a, b)
    masked, _ = port.run_null(32, key=seed & 0xFFFFFFFFFFFFFFFF)
    np.testing.assert_array_equal(a, masked)
    kd = port.key_data(port.prepare_key(seed))
    assert kd.dtype == np.uint64
    np.testing.assert_array_equal(kd, jax_eng.key_data(
        jax_eng.prepare_key(seed)))


def test_non_integer_key_raises_the_jax_text(rng):
    port, jax_eng = _engines(*_problem(rng))
    with pytest.raises(TypeError) as terr:
        port.run_null(8, key=1.5)
    with pytest.raises(TypeError) as jerr:
        jax_eng.run_null(8, key=1.5)
    assert str(terr.value) == str(jerr.value)
    assert "integer seed" in str(terr.value)


def test_zero_copy_adoption(rng):
    disc, test, specs, pool = _problem(rng)
    t_corr = np.ascontiguousarray(test[0], dtype=np.float64)
    eng, _ = _engines(disc, (t_corr, test[1], test[2]), specs, pool)
    assert eng.core.test_corr is t_corr  # same object, no copy
    f32 = np.asarray(test[0], dtype=np.float32)
    eng2, _ = _engines(disc, (f32, test[1], test[2]), specs, pool)
    assert eng2.core.test_corr is not f32
    assert eng2.core.test_corr.dtype == np.float64


def test_module_preservation_adopts_host_float64(frames, monkeypatch):
    # the datasets hold the caller's float64 memory; no matrix is copied
    seen = []
    real = tnative.NativePermutationEngine

    def spy(*a, **kw):
        eng = real(*a, **kw)
        seen.append(eng)
        return eng

    monkeypatch.setattr(tnative, "NativePermutationEngine", spy)
    tc = np.ascontiguousarray(frames["correlation"]["t"].to_numpy())
    kw = dict(frames, correlation={**frames["correlation"], "t": tc})
    module_preservation(**kw, n_perm=16, backend="native", device="cpu")
    assert np.shares_memory(seen[0].core.test_corr, tc)


@pytest.mark.parametrize("case", ("adaptive", "store_nulls", "data_only",
                                  "bf16_rescue"))
def test_refusals_carry_the_jax_texts(frames, case):
    kw = dict(frames, n_perm=16, backend="native")
    kw.update({
        "adaptive": dict(adaptive=True),
        "store_nulls": dict(store_nulls=False),
        "data_only": dict(data_only=2.0, network=None, correlation=None),
        "bf16_rescue": {},
    }[case])
    tkw, jkw = dict(kw), dict(kw)
    if case == "bf16_rescue":
        tkw["config"] = EngineConfig(null_precision="bf16_rescue")
        from netrep_tpu.utils.config import EngineConfig as JConfig

        jkw["config"] = JConfig(null_precision="bf16_rescue")
    with pytest.raises(ValueError) as terr:
        module_preservation(**tkw, device="cpu")
    with pytest.raises(ValueError) as jerr:
        netrep_tpu.module_preservation(**jkw)
    assert str(terr.value) == str(jerr.value).replace("'jax'", "'torch'")


@pytest.mark.parametrize("device", ("cuda", "cuda:0"))
def test_a_card_device_is_refused(frames, device):
    with pytest.raises(ValueError, match="host tier"):
        module_preservation(**frames, n_perm=16, backend="native",
                            device=device)


def _package_libraries():
    return set(glob.glob(os.path.join(ROOT, "netrep_tpu_torch", "**",
                                      "*.so"), recursive=True))


def test_library_lands_in_the_store(tmp_path, monkeypatch):
    store = tmp_path / "store"
    monkeypatch.setenv("NETREP_AOT_STORE", str(store))
    jax_before = set(glob.glob(os.path.join(ROOT, "netrep_tpu", "native",
                                            "*.so")))
    before = _package_libraries()
    path, source = tbuild.ensure_built()
    assert source == "jit" and path.parent == store and path.exists()
    meta = json.loads(path.with_suffix(".json").read_text())
    assert meta["name"] == "netstats" and meta["env"].startswith("cxx:")
    assert "-O3" in meta["env"] and f"march:{tbuild.march() or '-'}" in \
        meta["env"]
    assert tbuild.ensure_built() == (path, "aot")
    assert _package_libraries() == before
    assert set(glob.glob(os.path.join(ROOT, "netrep_tpu", "native",
                                      "*.so"))) == jax_before


def test_a_stored_library_loads_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setenv("NETREP_AOT_STORE", str(tmp_path / "store"))
    path, _ = tbuild.ensure_built()
    # the compiler is part of the cache key: keep the name, lose the binary
    monkeypatch.setattr(tbuild, "cxx", lambda: "g++")
    monkeypatch.setattr(tbuild.aot, "cxx_release", lambda cxx: None)
    assert tbuild.ensure_built() == (path, "aot")


def test_no_compiler_and_no_library_raises(frames, tmp_path, monkeypatch):
    monkeypatch.setenv("NETREP_AOT_STORE", str(tmp_path / "empty"))
    monkeypatch.setenv("NETREP_CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="does not run"):
        tbuild.ensure_built()
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="does not run"):
        module_preservation(**frames, n_perm=16, backend="native",
                            device="cpu")
    assert not (tmp_path / "empty").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "empty").iterdir())


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\n[ \"$1\" = --version ] && echo fake 1.0 "
                    "&& exit 0\necho 'error: no thanks' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("NETREP_AOT_STORE", str(tmp_path / "store"))
    monkeypatch.setenv("NETREP_CXX", str(fake))
    with pytest.raises(RuntimeError, match="no thanks"):
        tbuild.ensure_built()
    assert not list((tmp_path / "store").glob("*.so"))


def test_unloadable_library_is_quarantined_and_rebuilt(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("NETREP_AOT_STORE", str(tmp_path / "store"))
    path, _ = tbuild.ensure_built()
    path.write_bytes(b"not an ELF file")
    monkeypatch.setattr(tnative, "_lib", None)
    lib = tnative.load_library()
    assert lib.nr_abi_version() == 1
    assert path.with_name(path.name + ".bad").exists()
    assert path.exists()
