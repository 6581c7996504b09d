"""The port's kernel-library store (``netrep_tpu_torch/utils/aot.py``,
``ops/_build.py``), driven by a fake ``nvcc`` on this CPU machine: the
fake compiler copies a shared library the interpreter itself loads, counts
its runs and answers ``--version``. The store keys a library by its source
and flags and records its environment in a sidecar; a library of another
environment is rebuilt, an unloadable one quarantined and rebuilt, a
failed rebuild raises; the LRU bound holds; concurrent builds compile
once; the runs' ``compile_span.source`` and ledger fingerprints carry the
acquisition's ``jit`` / ``aot`` / ``memo``."""

import json
import os
import stat
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from netrep_tpu_torch.ops import _build  # noqa: E402
from netrep_tpu_torch.parallel import engine as tengine  # noqa: E402
from netrep_tpu_torch.utils import aot  # noqa: E402
from netrep_tpu_torch.utils import telemetry as tm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = """#!{python}
import os, shutil, sys, time
args = sys.argv[1:]
if args == ["--version"]:
    print("Cuda compilation tools, " + os.environ["FAKE_NVCC_RELEASE"])
    sys.exit(0)
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(args[-1] + "\\n")
time.sleep(float(os.environ.get("FAKE_NVCC_SLEEP", "0")))
if os.environ.get("FAKE_NVCC_FAIL"):
    print("error: fake failure")
    sys.exit(1)
out = args[args.index("-o") + 1]
if os.environ.get("FAKE_NVCC_GARBAGE"):
    with open(out, "wb") as f:
        f.write(b"not a library")
else:
    shutil.copy(os.environ["FAKE_NVCC_LIB"], out)
print("ptxas info    : Used 32 registers")
"""


def _loadable_library() -> str:
    import _ctypes

    return _ctypes.__file__


@pytest.fixture
def store(tmp_path, monkeypatch):
    """A fresh store under ``tmp_path`` and a fake ``nvcc`` first on PATH;
    the process's library memo and acquisition log start empty."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setenv("FAKE_NVCC_LIB", _loadable_library())
    monkeypatch.setenv("FAKE_NVCC_RELEASE", "release 12.8, V12.8.93")
    monkeypatch.setenv(aot.STORE_ENV, str(tmp_path / "store"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    monkeypatch.setattr(aot, "ACQUIRED", [])
    monkeypatch.setattr(aot, "_NVCC_RELEASE", {})
    monkeypatch.setattr(aot, "_WARNED", set())
    monkeypatch.setattr(aot, "COUNTS", dict.fromkeys(aot.COUNTS, 0))

    def runs():
        return (log.read_text().splitlines() if log.exists() else [])

    return types.SimpleNamespace(path=tmp_path / "store", runs=runs,
                                 tmp=tmp_path)


def _events(path, ev):
    return [e["data"] for e in tm.read_events(str(path)) if e["ev"] == ev]


def _fresh_process():
    """What a new process starts with: no library loaded."""
    _build._LIBS.clear()
    _build.BUILD_INFO.clear()


def test_library_lands_in_the_store_with_its_environment(store):
    _build.load("ring_shift")
    lib = _build.library_path("ring_shift")
    assert lib.parent == store.path and lib.exists()
    meta = json.loads(lib.with_suffix(".json").read_text())
    env = aot.env_signature(_build._nvcc())
    assert meta["env"] == env and meta["name"] == "ring_shift"
    assert "release 12.8" in env and f"torch_cuda:{torch.version.cuda}" in env
    assert env.endswith("card:none")   # no card on this machine
    assert len(store.runs()) == 1 and aot.ACQUIRED == [("ring_shift", "jit")]
    # a second process loads it without compiling
    _fresh_process()
    _build.load("ring_shift")
    assert len(store.runs()) == 1
    assert aot.ACQUIRED[-1] == ("ring_shift", "aot")


@pytest.mark.parametrize("part", ["nvcc", "torch_cuda", "capability",
                                  "card_name"])
def test_another_environment_rebuilds(store, monkeypatch, part):
    # each part of the signature changes it, and a library built under the
    # old one is rebuilt in place, never loaded
    _build.load("ring_shift")
    before = aot.env_signature(_build._nvcc())
    if part == "nvcc":
        monkeypatch.setenv("FAKE_NVCC_RELEASE", "release 12.9, V12.9.41")
        monkeypatch.setattr(aot, "_NVCC_RELEASE", {})
    elif part == "torch_cuda":
        monkeypatch.setattr(torch.version, "cuda", "99.1")
    else:
        cap, name = (9, 0), "NVIDIA H100 80GB HBM3"
        if part == "capability":
            cap = (8, 0)
        else:
            name = "NVIDIA H200"
        monkeypatch.setattr(aot, "card_signature",
                            lambda: f"sm_{cap[0]}{cap[1]}:{name}")
        if part == "card_name":
            # the other card first, so the change is the name alone
            monkeypatch.setattr(aot, "card_signature",
                                lambda: "sm_90:NVIDIA H100 80GB HBM3")
            _fresh_process()
            _build.load("ring_shift")
            before = aot.env_signature(_build._nvcc())
            monkeypatch.setattr(aot, "card_signature",
                                lambda: f"sm_{cap[0]}{cap[1]}:{name}")
    after = aot.env_signature(_build._nvcc())
    assert after != before
    n = len(store.runs())
    bus_path = store.tmp / "bus.jsonl"
    bus = tm.Telemetry(str(bus_path))
    _fresh_process()
    with bus.activate():
        _build.load("ring_shift")
    bus.close()
    assert len(store.runs()) == n + 1
    assert aot.ACQUIRED[-1] == ("ring_shift", "jit")
    lib = _build.library_path("ring_shift")
    assert json.loads(lib.with_suffix(".json").read_text())["env"] == after
    misses = _events(bus_path, "aot_store_miss")
    assert [m["reason"] for m in misses] == ["env-mismatch"]


def test_library_without_a_sidecar_is_rebuilt(store):
    _build.load("ring_shift")
    lib = _build.library_path("ring_shift")
    lib.with_suffix(".json").unlink()
    _fresh_process()
    _build.load("ring_shift")
    assert len(store.runs()) == 2 and lib.with_suffix(".json").exists()


def test_corrupt_library_is_quarantined_and_rebuilt(store):
    # built, not loaded: the loader caches a path it has opened once
    _build.build(["fused_gather"])
    lib = _build.library_path("fused_gather")
    lib.write_bytes(b"\x7fELF torn")
    bus_path = store.tmp / "bus.jsonl"
    bus = tm.Telemetry(str(bus_path))
    _fresh_process()
    with bus.activate():
        got = _build.load("fused_gather")
    bus.close()
    assert got is not None and len(store.runs()) == 2
    assert lib.with_suffix(".json").exists()   # the rebuild's sidecar
    # renamed aside, then removed by the rebuild's size-bound pass, which
    # takes quarantined files first
    assert aot.COUNTS["removed"] == 2         # the .so.bad and .json.bad
    assert not list(store.path.glob("*.bad"))
    assert [m["reason"] for m in _events(bus_path, "aot_store_miss")] == [
        "corrupt"]
    anomalies = _events(bus_path, "anomaly_detected")
    assert [a["detector"] for a in anomalies] == ["aot_refused"]
    assert anomalies[0]["path"] == str(lib)
    assert aot.COUNTS["quarantined"] == 1
    assert aot.ACQUIRED[-1] == ("fused_gather", "jit")


def test_a_rebuild_that_does_not_load_raises(store, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_GARBAGE", "1")
    with pytest.raises(RuntimeError, match="does not load"):
        _build.load("ring_shift")
    assert "ring_shift" not in _build._LIBS


def test_a_failed_build_raises(store, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="nvcc failed for ring_shift.cu"):
        _build.load("ring_shift")
    assert not _build.library_path("ring_shift").exists()


def test_build_starts_every_source_together(store):
    _build.build(_build.SOURCES)
    assert sorted(os.path.basename(p) for p in store.runs()) == sorted(
        f"{n}.cu" for n in _build.SOURCES)
    assert {_build.BUILD_INFO[n]["source"] for n in _build.SOURCES} == {"jit"}
    assert "Used 32 registers" in _build.BUILD_INFO["fused_stats"]["ptxas"]
    _build.build(_build.SOURCES)   # all present: nothing compiles
    assert len(store.runs()) == 3


def test_lru_bound_holds(store, monkeypatch):
    size = os.path.getsize(_loadable_library())
    store.path.mkdir(parents=True)
    old = []
    for i in range(4):
        p = store.path / f"libfused_stats_{i:016x}.so"
        p.write_bytes(b"x" * size)
        p.with_suffix(".json").write_text("{}")
        os.utime(p, (1000 + i, 1000 + i))
        old.append(p)
    (store.path / "libring_shift_0000000000000000.so.bad").write_bytes(b"x")
    # room for three libraries: the new one and the two most recent old
    monkeypatch.setenv(aot.MAX_MB_ENV, str(3.5 * size / 2 ** 20))
    _build.load("ring_shift")
    left = sorted(p.name for p in store.path.glob("*.so"))
    assert _build.library_path("ring_shift").name in left
    assert left == sorted([_build.library_path("ring_shift").name,
                           old[2].name, old[3].name])
    assert not old[0].with_suffix(".json").exists()
    assert not list(store.path.glob("*.bad"))
    assert aot.stats()["entries"] == 3


def test_the_bound_never_removes_a_loaded_library(store, monkeypatch):
    _build.load("ring_shift")
    monkeypatch.setenv(aot.MAX_MB_ENV, "0")
    _build.load("fused_gather")
    assert _build.library_path("ring_shift").exists()
    assert _build.library_path("fused_gather").exists()


def test_concurrent_builds_compile_once(store, monkeypatch):
    # two processes boot together on a cold store: the build lock makes
    # the second wait and load what the first built
    monkeypatch.setenv("FAKE_NVCC_SLEEP", "1.5")
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "from netrep_tpu_torch.ops import _build\n"
            "_build.load('ring_shift')\n"
            "print(_build.BUILD_INFO['ring_shift']['source'])\n")
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert sorted(o.strip() for o, _e in outs) == ["aot", "jit"]
    assert len(store.runs()) == 1


def _finish(tmp_path, name):
    """One run's end through the engine loops' accounting, with a bus and
    the perf ledger on; returns (compile_span source, ledger fingerprint)."""
    path = tmp_path / f"{name}.jsonl"
    bus = tm.Telemetry(str(path))
    engine = types.SimpleNamespace(_lib_mark=aot.mark())
    yield engine
    tengine._finish_run(bus, None, [(16, 1.0), (48, 2.0)], 0.0, 0,
                        "streaming", "cpu|fused|caps:32x3|chunk:16", 48,
                        device="cpu", engine=engine)
    bus.close()
    span = _events(path, "compile_span")[0]
    assert span["key"] == "cpu|fused|caps:32x3|chunk:16"
    yield span["source"]


def test_compile_span_source_jit_then_aot_then_memo(store, tmp_path,
                                                    monkeypatch):
    ledger = tmp_path / "ledger.jsonl"
    monkeypatch.setenv("NETREP_PERF_LEDGER", str(ledger))
    got = []
    for step in ("jit", "aot", "memo"):
        run = _finish(tmp_path, step)
        next(run)                     # the engine is built
        if step == "aot":
            _fresh_process()          # a new process, the store warm
        if step != "memo":
            _build.load("fused_stats")
        got.append(next(run))
    assert got == ["jit", "aot", "memo"]
    fps = [json.loads(line)["fingerprint"]
           for line in ledger.read_text().splitlines()]
    assert fps == [f"cpu|fused|caps:32x3|chunk:16|src:{s}"
                   for s in ("jit", "aot", "memo")]


def test_cpu_runs_acquire_nothing(tmp_path, monkeypatch):
    # a CPU run launches no kernel: its compile_span says memo, and the
    # ledger keeps the suffix
    from netrep_tpu_torch.data import make_example_pair, pair_frames
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.utils.config import EngineConfig

    ledger = tmp_path / "ledger.jsonl"
    monkeypatch.setenv("NETREP_PERF_LEDGER", str(ledger))
    import numpy as np

    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    path = tmp_path / "run.jsonl"
    module_preservation(
        network={"d": d["network"], "t": t["network"]},
        correlation={"d": d["correlation"], "t": t["correlation"]},
        module_assignments=pair["labels"], n_perm=64, device="cpu",
        config=EngineConfig(chunk_size=16), telemetry=str(path))
    assert [s["source"] for s in _events(path, "compile_span")] == ["memo"]
    fp = json.loads(ledger.read_text().splitlines()[-1])["fingerprint"]
    assert fp.endswith("|src:memo") and fp.startswith("cpu|")


def test_a_run_counts_only_acquisitions_since_its_engine(tmp_path,
                                                        monkeypatch):
    # module_preservation's engines are built from parts: an acquisition
    # earlier in the process (here another library's build) is not theirs
    from netrep_tpu_torch.data import make_example_pair, pair_frames
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.utils.config import EngineConfig
    import numpy as np

    monkeypatch.setattr(aot, "ACQUIRED", list(aot.ACQUIRED))
    monkeypatch.setattr(aot, "COUNTS", dict(aot.COUNTS))
    aot.record("netstats", "jit")
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    path = tmp_path / "run.jsonl"
    module_preservation(
        network={"d": d["network"], "t": t["network"]},
        correlation={"d": d["correlation"], "t": t["correlation"]},
        module_assignments=pair["labels"], n_perm=64, device="cpu",
        config=EngineConfig(chunk_size=16), telemetry=str(path))
    assert [s["source"] for s in _events(path, "compile_span")] == ["memo"]


def test_the_bundle_names_the_store_without_touching_a_card(store):
    from netrep_tpu_torch.utils import bundle

    _build.load("ring_shift")
    snap = bundle._kernels_snapshot()
    assert snap["build_dir"] == str(store.path)
    row = snap["libraries"]["ring_shift"]
    assert row["exists"] and row["loaded"] and row["acquired"] == "jit"
    assert not torch.cuda.is_initialized()
