"""The port's fault ladder (``netrep_tpu_torch.utils.faults``, the
``fault_policy=`` of ``module_preservation`` and ``build_sparse_network``)
against the JAX package's, on the CPU.

Fixture: ``make_example_pair(default_rng(3))`` as frames (the parity
fixture of ``tests/test_torch_preservation.py``), chunk 32, superchunk 2,
160 permutations, seed 5; the two-cohort ``vmap_tests`` call adds the
test side of ``make_example_pair(default_rng(4))`` in the first pair's
node order. Every fault kind runs on the fixed materialized, streaming,
adaptive (both null modes) and two-cohort loops, the same plan string in
both packages, and each case checks that

- p-values, exceedance counts, ``n_perm_used`` and ``completed`` equal the
  JAX package's, and the stored null is within the documented 1e-4 of it
  (ROADMAP.md Queue 3);
- the ordered list of recovery events (``RECOVERY_EVENTS``) equals the JAX
  run's;
- the result equals the port's unfaulted run bit for bit (a resumed or
  retried chunk draws the same ``fold_in`` keys);
- no thread of the ladder (dispatch worker, checkpoint writer, watchdog)
  is left alive.

A hang is walked away from through the runtime's abandon flag 0.2 s after
it is injected (the watchdog escalation's path), under a 60 s
``hang_timeout_s`` that no healthy dispatch reaches — the JAX package's
first dispatch includes its compile, which can take seconds under load;
the timeout's own path is held by ``test_abandoned_hang_thread_ends`` and
by the card's run.

The shrink and grow-back rungs run on an 8-device mesh: the JAX tests'
virtual CPU mesh (``tests/conftest.py``) and the port's ``devices=[cpu] *
8``, the two-cohort case on the multi-test engine over the same mesh,
held to the JAX ladder's shrink and grow-back.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

import netrep_tpu  # noqa: E402
from netrep_tpu.data import make_example_pair, pair_frames  # noqa: E402
from netrep_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from netrep_tpu.utils import checkpoint as jckpt  # noqa: E402
from netrep_tpu.utils import faults as jflt  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu.utils.config import FaultPolicy as JPolicy  # noqa: E402
from netrep_tpu.utils.telemetry import Telemetry as JBus  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.parallel import distributed  # noqa: E402
from netrep_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from netrep_tpu_torch.utils import backend as be  # noqa: E402
from netrep_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from netrep_tpu_torch.utils import faults as flt  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig, FaultPolicy  # noqa: E402
from netrep_tpu_torch.utils.telemetry import (  # noqa: E402
    RECOVERY_EVENTS, Telemetry,
)

N_PERM = 160
SEED = 5
NULL_TOL = 1e-4
HANG_S = 60.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: beside other test
    processes, torch's per-core pool only contends for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _frames():
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    _d2, t2 = pair_frames(make_example_pair(np.random.default_rng(4)))
    idx = t["network"].index
    t2 = {"network": t2["network"].loc[idx, idx],
          "correlation": t2["correlation"].loc[idx, idx],
          "data": t2["data"][idx]}
    return pair["labels"], d, t, t2


LABELS, D, T1, T2 = _frames()


def inputs(target: str) -> dict:
    multi = target.startswith("vmap")
    names = ("d", "t", "t2") if multi else ("d", "t")
    sets = dict(zip(names, (D, T1, T2)))
    return dict(
        network={k: v["network"] for k, v in sets.items()},
        correlation={k: v["correlation"] for k, v in sets.items()},
        data={k: v["data"] for k, v in sets.items()},
        module_assignments=LABELS, discovery="d",
        test=["t", "t2"] if multi else "t", vmap_tests=multi,
        n_perm=N_PERM, seed=SEED,
    )


#: the loops a plan runs on
TARGETS = {
    "fixed": dict(store_nulls=True),
    "stream": dict(store_nulls=False),
    "adaptive": dict(adaptive=True),
    "adaptive_stream": dict(adaptive=True, store_nulls=False),
    "vmap": dict(store_nulls=True),
    "vmap_stream": dict(store_nulls=False),
}

#: fault kinds: plan string and policy fields (the CPU rung is asked for
#: by name: the port's default leaves it off, the JAX package's has it on)
KINDS = {
    "transient": dict(plan="transient@40"),
    "transient_exhausted": dict(plan="transient@72x4", max_retries=3,
                                degrade_to_cpu=True),
    "hang": dict(plan="hang@72", hang_timeout_s=HANG_S),
    "device_lost": dict(plan="device_lost@72", degrade_to_cpu=True),
    "device_lost_raises": dict(plan="device_lost@72", degrade_to_cpu=False),
    "partial_and_restored": dict(
        plan="device_lost_partial@40;capacity_restored@104",
        degrade_to_cpu=True),
    "fatal": dict(plan="fatal@72"),
    "interrupt": dict(plan="interrupt@72"),
    "crash": dict(plan="crash@72"),
}

#: the JAX package's fields where its ladder differs: it hands retries run
#: out on a live device to its CPU rung, which the port never does — the
#: port raises the last transient error past the failure-save, as the JAX
#: package does without the rung
JAX_FIELDS = {"transient_exhausted": dict(degrade_to_cpu=False)}

#: kinds that end the call with an error after the failure-save
RAISING = ("fatal", "crash", "device_lost_raises", "transient_exhausted")


def _ladder_threads():
    """The port's live ladder threads (the JAX package deliberately
    leaks its abandoned hang threads, so its own are not counted)."""
    return [t for t in threading.enumerate()
            if t.name.startswith("netrep-") and t.is_alive()
            and getattr(getattr(t, "_target", None), "__module__",
                        "").startswith("netrep_tpu_torch")]


def assert_no_threads_left():
    deadline = time.monotonic() + 3.0
    while _ladder_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not _ladder_threads(), _ladder_threads()


def run(pkg: str, target: str, kind: str | None, tmp_path, mesh=False):
    """One call of ``pkg``'s ``module_preservation``: ``(result or None,
    raised error or None, recovery event names)``. The watchdog thread is
    off (``watchdog_poll_s=0``) so that no timing decides an event."""
    bus = (JBus if pkg == "jax" else Telemetry)(watchdog_poll_s=0)
    names = []
    bus.subscribe(lambda r: names.append(r["ev"]))
    kw = dict(inputs(target), **TARGETS[target], telemetry=bus)
    if kind is not None:
        fields = dict(KINDS[kind], **(JAX_FIELDS.get(kind, {})
                                      if pkg == "jax" else {}))
        pol = (JPolicy if pkg == "jax" else FaultPolicy)(
            backoff_base_s=0.0, **fields)
        rt = (jflt if pkg == "jax" else flt).FaultRuntime(pol)
        if kind == "hang":
            # the injected hang is walked away from through the runtime's
            # abandon flag (the watchdog's escalation), 0.2 s after it
            # starts; the long hang_timeout_s never walks away from a
            # healthy dispatch, the JAX package's compiling one included
            def abandon_soon(rec):
                if (rec["ev"] == "fault_injected"
                        and rec["data"].get("kind") == "hang"):
                    threading.Timer(0.2, rt._abandon.set).start()

            bus.subscribe(abandon_soon)
        kw["fault_policy"] = rt
        kw["checkpoint_dir"] = str(tmp_path / pkg)
    if pkg == "jax":
        fn = netrep_tpu.module_preservation
        kw["config"] = JConfig(chunk_size=32, superchunk=2, autotune=False)
        if mesh:
            kw["mesh"] = jmake_mesh(8, 1)
    else:
        fn = module_preservation
        kw.update(config=EngineConfig(chunk_size=32, superchunk=2),
                  device="cpu")
        if mesh:
            kw["mesh"] = tmesh.make_mesh(8, 1,
                                         devices=[torch.device("cpu")] * 8)
    res = err = None
    try:
        res = fn(**kw)
    except BaseException as e:  # the kinds that end the call
        err = e
    return res, err, [n for n in names if n in RECOVERY_EVENTS]


def per_test(res):
    """``{test: result}`` of a (possibly simplified) result."""
    if isinstance(res, dict):
        return res
    return {"t": res}


def assert_same(rt, rj, base):
    """The port's faulted result against the JAX package's and against the
    port's unfaulted one."""
    rt, rj, base = per_test(rt), per_test(rj), per_test(base)
    assert rt.keys() == rj.keys() == base.keys()
    for name in rt:
        a, b, c = rt[name], rj[name], base[name]
        assert a.completed == b.completed
        np.testing.assert_array_equal(a.p_values, b.p_values)
        if a.n_perm_used is not None or b.n_perm_used is not None:
            np.testing.assert_array_equal(a.n_perm_used, b.n_perm_used)
        for f in ("counts_hi", "counts_lo", "counts_eff"):
            if getattr(b, f) is not None:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        if b.nulls is not None:
            np.testing.assert_allclose(a.nulls, b.nulls, rtol=0,
                                       atol=NULL_TOL)
        # bit for bit against the unfaulted port run
        assert a.completed == c.completed
        np.testing.assert_array_equal(a.p_values, c.p_values)
        for f in ("nulls", "counts_hi", "counts_lo", "counts_eff",
                  "n_perm_used"):
            np.testing.assert_array_equal(getattr(a, f), getattr(c, f))


_BASE: dict = {}


def baseline(target: str, tmp_path):
    """The port's unfaulted run of ``target``."""
    if target not in _BASE:
        _BASE[target] = run("port", target, None, tmp_path)[0]
    return _BASE[target]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("target", TARGETS)
def test_fault_kind_matches_jax(target, kind, tmp_path):
    base = baseline(target, tmp_path)
    mesh = kind == "partial_and_restored"
    rt, et, evt = run("port", target, kind, tmp_path, mesh=mesh)
    rj, ej, evj = run("jax", target, kind, tmp_path, mesh=mesh)
    assert_no_threads_left()
    assert evt == evj
    if kind in RAISING:
        assert rt is None and rj is None
        assert type(et).__name__ == type(ej).__name__
        assert str(et) == str(ej)
        # the failure-save kept what completed before the fault
        name = "null_d__t_t2.npz" if target.startswith("vmap") else \
            "null_d__t.npz"
        saved = ckpt.load_null_checkpoint(str(tmp_path / "port" / name))
        jsaved = jckpt.load_null_checkpoint(str(tmp_path / "jax" / name))
        assert saved["completed"] == jsaved["completed"] > 0
        if kind in ("device_lost_raises", "transient_exhausted"):
            # the same call without the fault resumes to the unfaulted run
            resumed, err, _ = run("port", target, None, tmp_path)
            assert err is None
            assert_same(resumed, run("jax", target, None, tmp_path)[0],
                        base)
        return
    assert et is None and ej is None, (et, ej)
    if kind == "interrupt":
        for a, b in zip(per_test(rt).values(), per_test(rj).values()):
            assert a.completed == b.completed < N_PERM
            np.testing.assert_array_equal(a.p_values, b.p_values)
        return
    assert_same(rt, rj, base)
    first = next(iter(per_test(rt).values()))
    if kind == "device_lost":
        deg = first.profile["degraded"]
        # the permutations committed before the loss (a streaming null's
        # first superchunk commits nothing before it lands)
        assert 0 <= deg["at_perm"] < N_PERM and "degraded_to_cpu" in evt
        assert deg["reason"] == "device_lost"
    else:
        assert "degraded" not in first.profile
    if mesh:
        assert evt.count("mesh_shrunk") == evt.count("mesh_grown") == 1


def test_policy_on_unfaulted_is_bit_identical(tmp_path):
    """A policy with no plan changes nothing: every chunk is waited on in
    the retry scope and saves go through the writer, and the result is
    the unfaulted run's."""
    for target in ("fixed", "stream"):
        kw = dict(inputs(target), **TARGETS[target], device="cpu",
                  config=EngineConfig(chunk_size=32, superchunk=2))
        plain = module_preservation(**kw)
        on = module_preservation(**kw, fault_policy=FaultPolicy())
        assert_same(on, plain, plain)
        assert "degraded" not in on.profile
    assert_no_threads_left()


def test_pairs_after_the_cpu_rung_stay_on_the_cpu():
    """After the CPU rung the rest of the analysis runs on the CPU (the JAX
    package switches its platform): a second pair, run one after the
    other, carries the same mark, and both equal the unfaulted runs and
    the JAX package's."""
    kw = dict(inputs("vmap"), vmap_tests=False)
    plan = "device_lost@72"
    plain = module_preservation(**kw, device="cpu",
                                config=EngineConfig(chunk_size=32))
    got = module_preservation(
        **kw, device="cpu", config=EngineConfig(chunk_size=32),
        fault_policy=FaultPolicy(plan=plan, backoff_base_s=0.0,
                                 degrade_to_cpu=True))
    jx = netrep_tpu.module_preservation(
        **kw, config=JConfig(chunk_size=32, autotune=False),
        fault_policy=JPolicy(plan=plan, backoff_base_s=0.0))
    for t in ("t", "t2"):
        assert got[t].profile["degraded"]["at_perm"] == 64
        np.testing.assert_array_equal(got[t].nulls, plain[t].nulls)
        np.testing.assert_array_equal(got[t].p_values, jx[t].p_values)
    assert_no_threads_left()


def test_env_plan_activates_a_default_policy(monkeypatch, tmp_path):
    monkeypatch.setenv(flt.PLAN_ENV, "transient@40")
    bus = Telemetry(watchdog_poll_s=0)
    kw = dict(inputs("fixed"), device="cpu",
              config=EngineConfig(chunk_size=32))
    res = module_preservation(**kw, telemetry=bus, checkpoint_dir=str(
        tmp_path))
    assert bus.metrics.counters["retry_attempt.count"] == 1
    # the variable turns on a policy, never the CPU rung
    assert flt.resolve_runtime(None).policy.degrade_to_cpu is False
    monkeypatch.delenv(flt.PLAN_ENV)
    np.testing.assert_array_equal(res.p_values,
                                  module_preservation(**kw).p_values)


def test_no_card_still_raises_with_a_policy():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module_preservation(**inputs("fixed"), fault_policy=FaultPolicy())


def test_emergency_directory_is_removed(tmp_path, monkeypatch):
    """Without a checkpoint_dir the policy's run-scoped directory holds the
    saves and is gone when the call ends, the CPU rung included."""
    import os
    import tempfile

    made = []
    orig = tempfile.mkdtemp

    def spy(*a, **k):
        made.append(orig(*a, **k))
        return made[-1]

    monkeypatch.setattr(tempfile, "mkdtemp", spy)
    res = module_preservation(
        **inputs("fixed"), device="cpu", config=EngineConfig(chunk_size=32),
        fault_policy=FaultPolicy(plan="device_lost@72", backoff_base_s=0.0,
                                 degrade_to_cpu=True))
    assert res.profile["degraded"]["at_perm"] == 64
    assert made and not any(os.path.exists(d) for d in made)


# ---------------------------------------------------------------------------
# the taxonomy, plans and backoff against the JAX package's
# ---------------------------------------------------------------------------

PLANS = (
    "", "transient@128", "transient@128x3", "device_lost@64;hang@3",
    "device_lost_partial@64, capacity_restored@96", "fatal@0",
    "interrupt@5;crash@6;sigkill@7", " transient@1 ; ",
)
BAD_PLANS = ("bogus@3", "transient", "transient@x", "transient@-1",
             "transient@3x0", "hang@3x")


@pytest.mark.parametrize("spec", PLANS)
def test_parse_plan_equals_jax(spec):
    got = [(s.kind, s.at_perm, s.times) for s in flt.parse_plan(spec)]
    want = [(s.kind, s.at_perm, s.times) for s in jflt.parse_plan(spec)]
    assert got == want


@pytest.mark.parametrize("spec", BAD_PLANS)
def test_bad_plans_raise_the_jax_text(spec):
    with pytest.raises(ValueError) as et:
        flt.parse_plan(spec)
    with pytest.raises(ValueError) as ej:
        jflt.parse_plan(spec)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("fields", (
    {}, dict(backoff_jitter=0.0), dict(backoff_base_s=1.5,
                                       backoff_factor=3.0, backoff_max_s=4.0),
    dict(backoff_jitter=0.9),
))
def test_backoff_delay_equals_jax(fields):
    pt, pj = FaultPolicy(**fields), JPolicy(**fields)
    for start in (0, 7, 128, 99999):
        for attempt in range(1, 6):
            assert flt.backoff_delay(pt, start, attempt) == \
                jflt.backoff_delay(pj, start, attempt)


#: errors both taxonomies read alike
ERRORS = (
    jflt.InjectedTransientError("x"), jflt.InjectedDeviceLost("x"),
    jflt.InjectedFatalError("x"), ConnectionResetError("peer"),
    TimeoutError("slow"), RuntimeError("DEADLINE_EXCEEDED: rpc"),
    RuntimeError("Socket closed"), RuntimeError("TPU device lost"),
    RuntimeError("the job was preempted"), ValueError("shape mismatch"),
    RuntimeError("UNAVAILABLE: connection refused"),
    KeyError("nope"), RuntimeError("chip has been lost"),
    OSError("resource temporarily unavailable"),
)


def _port_twin(e):
    """The port's class of an injected JAX error, else the error."""
    name = type(e).__name__
    return getattr(flt, name)(str(e)) if hasattr(flt, name) else e


@pytest.mark.parametrize("err", ERRORS, ids=lambda e: f"{type(e).__name__}")
def test_classify_error_equals_jax(err):
    assert flt.classify_error(_port_twin(err)) == jflt.classify_error(err)


@pytest.mark.parametrize("text,kind", (
    ("CUDA error: uncorrectable ECC error encountered", "device_lost"),
    ("GPU has fallen off the bus", "device_lost"),
    ("CUDA error: all CUDA-capable devices are busy or unavailable",
     "device_lost"),
    ("CUDA-capable device(s) is/are busy or unavailable", "device_lost"),
    ("NVML: GPU is lost", "device_lost"),
    ("no CUDA-capable device is detected", "device_lost"),
    ("CUDA error: an illegal memory access was encountered", "fatal"),
    ("CUDA error: unspecified launch failure", "fatal"),
    ("CUDA error: device-side assert triggered", "fatal"),
    ("CUDA error: misaligned address", "fatal"),
    ("CUDA out of memory. Tried to allocate 2.00 GiB", "fatal"),
))
def test_cuda_vocabulary(text, kind):
    """The port's own markers: a lost card climbs the ladder, a kernel
    fault or a full card is a bug and is never retried (even a text that
    also holds a transient or device-loss word)."""
    assert flt.classify_error(RuntimeError(text)) == kind


def test_out_of_memory_type_is_fatal():
    assert flt.classify_error(
        torch.cuda.OutOfMemoryError("CUDA out of memory")) == "fatal"
    # "halted" is a device-loss marker, but an assert stays a bug
    assert flt.classify_error(RuntimeError(
        "device-side assert triggered; kernel halted")) == "fatal"


@pytest.mark.parametrize("fields", (
    dict(max_retries=-1), dict(max_abandons=-1), dict(max_mesh_rebuilds=-1),
    dict(backoff_base_s=-1.0), dict(backoff_max_s=-1.0),
    dict(backoff_factor=0.5), dict(backoff_jitter=1.0),
    dict(hang_timeout_s=0.0), dict(stall_action_factor=0.0),
))
def test_policy_validation_equals_jax(fields):
    with pytest.raises(ValueError) as et:
        FaultPolicy(**fields)
    with pytest.raises(ValueError) as ej:
        JPolicy(**fields)
    assert str(et.value) == str(ej.value)


def test_policy_defaults_equal_jax():
    """Every default is the JAX package's but the CPU rung's, which the
    port leaves to a caller who asks for it."""
    import dataclasses

    port, jax_ = dataclasses.asdict(FaultPolicy()), dataclasses.asdict(
        JPolicy())
    assert port.pop("degrade_to_cpu") is False
    assert jax_.pop("degrade_to_cpu") is True
    assert port == jax_


def test_resolve_runtime_rules():
    assert flt.resolve_runtime(None) is None
    assert flt.resolve_runtime(False) is None
    rt = flt.resolve_runtime(True)
    assert isinstance(rt, flt.FaultRuntime)
    assert flt.resolve_runtime(rt) is rt
    with pytest.raises(TypeError, match="fault_policy must be"):
        flt.resolve_runtime("yes")
    with pytest.raises(ValueError, match="hang_timeout_s"):
        flt.FaultRuntime(FaultPolicy(plan="hang@0"))


def test_injector_fires_once_across_a_rebuild():
    rt = flt.FaultRuntime(FaultPolicy(plan="device_lost@10",
                                      backoff_base_s=0.0))
    with pytest.raises(flt.DeviceLostError):
        rt.run_dispatch(lambda: 1, start=0, take=32)
    assert rt.run_dispatch(lambda: 2, start=0, take=32) == 2


def test_abandoned_hang_thread_ends():
    rt = flt.FaultRuntime(FaultPolicy(plan="hang@0", hang_timeout_s=0.05,
                                      backoff_base_s=0.0))
    assert rt.run_dispatch(lambda: 7, start=0, take=4) == 7
    assert_no_threads_left()


def test_worker_runs_the_dispatch_on_the_callers_stream():
    """With CUDA initialised the worker thread adopts the caller's
    current device and stream (both per thread in CUDA); on the CPU the
    dispatch runs as it is."""
    rt = flt.FaultRuntime(FaultPolicy(hang_timeout_s=5.0))
    seen = []
    rt.run_dispatch(lambda: seen.append(threading.current_thread().name),
                    start=0, take=1)
    assert seen == ["netrep-ft-dispatch"]


def test_block_ready_finds_every_cuda_device():
    assert flt._cuda_devices([torch.zeros(2), {"a": (torch.ones(1),)}],
                             {}) == {}
    if torch.cuda.is_available():
        t = torch.zeros(2, device="cuda")
        assert list(flt._cuda_devices([t, [t]], {})) == [t.device]


def test_escalation_is_wired_only_with_a_watchdog_thread():
    """A run whose watchdog thread is off (``watchdog_poll_s=0``) keeps its
    dispatches on the loop thread: nothing could fire the escalation."""
    from netrep_tpu_torch.parallel.engine import _arm

    for poll, wired in ((0.0, False), (5.0, True)):
        rt = flt.FaultRuntime(FaultPolicy())
        wd = _arm(Telemetry(watchdog_poll_s=poll), rt, None)
        wd.stop()
        assert rt._wd_wired is wired
    assert_no_threads_left()


@pytest.mark.parametrize("plan,fields,err", (
    ("transient@0x4", dict(max_retries=3), flt.InjectedTransientError),
    ("hang@0", dict(hang_timeout_s=0.05, max_abandons=0), RuntimeError),
), ids=("retries", "abandons"))
def test_run_out_ladder_raises_and_never_degrades(plan, fields, err):
    """Retries or abandonments run out on a live device raise their own
    error, never the device-loss error the CPU rung takes, even when the
    caller asked for the rung."""
    rt = flt.FaultRuntime(FaultPolicy(plan=plan, backoff_base_s=0.0,
                                      degrade_to_cpu=True, **fields))
    with pytest.raises(err) as got:
        rt.run_dispatch(lambda: 7, start=0, take=4)
    assert not isinstance(got.value, flt.DeviceLostError)
    assert_no_threads_left()


def _stream_engines(case: str):
    """A small port engine of ``case`` on the CPU and its observed
    statistics."""
    from netrep_tpu.data import make_mixed_pair
    from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine
    from netrep_tpu_torch.parallel.multitest import MultiTestEngine

    mixed = make_mixed_pair(160, 4, n_samples=24, seed=7)
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    specs = [ModuleSpec(lab, idx, idx) for lab, idx in mixed["specs"]]
    cfg = dict(chunk_size=16, superchunk=2)
    if case == "multitest":
        eng = MultiTestEngine(dc, dn, dd, [tc, tc], [tn, tn], [td, td],
                              specs, mixed["pool"],
                              config=EngineConfig(**cfg), device="cpu")
    else:
        if case == "screened":
            cfg.update(stat_mode="xla", null_precision="bf16_rescue")
        mesh = (tmesh.make_mesh(2, 1, devices=[torch.device("cpu")] * 2)
                if case == "mesh" else None)
        eng = PermutationEngine(dc, dn, dd, tc, tn, td, specs,
                                mixed["pool"], config=EngineConfig(**cfg),
                                device="cpu", mesh=mesh)
    return eng, eng.observed()


def _run_stream(eng, observed, case, policy=None):
    run = (eng.run_null_adaptive_streaming if case == "adaptive"
           else eng.run_null_streaming)
    return run(96, observed, key=SEED, fault_policy=policy)


@pytest.mark.parametrize(
    "case", ("plain", "mesh", "screened", "adaptive", "multitest"))
def test_slow_abandoned_dispatch_counts_once(case):
    """A dispatch that is only slow is abandoned at ``hang_timeout_s`` and
    finishes during its retry: its late folds land in tallies nobody
    reads, so the counts (and the screened run's rescue counters) equal
    the unfaulted run's."""
    eng, observed = _stream_engines(case)
    want = _run_stream(eng, observed, case)
    want_rescue = (None if case != "screened"
                   else vars(eng.last_rescue).copy())
    parts = "_stream_parts" if case == "multitest" else "_count_parts"
    orig = getattr(eng, parts)
    gate, late_done, calls = threading.Event(), threading.Event(), []

    def slow(count):
        def wrapped(keys, valid, acc):
            calls.append(threading.current_thread().name)
            if len(calls) == 1:
                # the first dispatch stalls past the timeout, then folds
                # while its retry is running
                gate.wait(30)
                out = count(keys, valid, acc)
                late_done.set()
                return out
            if len(calls) == 2:
                gate.set()
                late_done.wait(30)
            return count(keys, valid, acc)

        return wrapped

    def patched(*a):
        count, pull, tallies = orig(*a)
        return slow(count), pull, tallies

    setattr(eng, parts, patched)
    bus = Telemetry(watchdog_poll_s=0)
    names = []
    bus.subscribe(lambda r: names.append(r["ev"]))
    got = _run_stream(eng, observed, case, flt.FaultRuntime(FaultPolicy(
        hang_timeout_s=1.0, backoff_base_s=0.0)))
    del bus
    assert late_done.is_set()
    for f in ("hi", "lo", "eff", "n_perm_used"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.completed == want.completed
    if want_rescue is not None:
        assert vars(eng.last_rescue) == want_rescue
    assert_no_threads_left()


# ---------------------------------------------------------------------------
# the elastic helpers against the JAX package's
# ---------------------------------------------------------------------------

def test_mesh_spec_round_trip_and_shrink():
    cpu = [torch.device("cpu")] * 8
    m = tmesh.make_mesh(2, 4, devices=cpu)
    spec = tmesh.mesh_spec(m)
    assert spec[1:] == (2, 4)
    assert tmesh.mesh_from_spec(spec).shape == m.shape
    assert tmesh.mesh_spec(None) is None and tmesh.mesh_from_spec(None) is None
    from netrep_tpu.parallel import mesh as jmesh
    import jax

    jm = jmesh.make_mesh(2, 4)
    for n in (1, 2, 3, 4, 6, 8):
        got = tmesh.shrink_mesh(cpu[:n], like=m).shape
        want = jmesh.shrink_mesh(list(jax.devices())[:n], like=jm).shape
        assert dict(got) == dict(want), n
    with pytest.raises(ValueError, match="at least one surviving"):
        tmesh.shrink_mesh([], like=m)
    assert distributed.filter_addressable(cpu) == cpu


def test_enumerate_survivors_and_inventory():
    m = tmesh.make_mesh(4, 1, devices=[torch.device("cpu")] * 4)
    e = flt.DeviceLostError("x")
    e.__cause__ = flt.InjectedPartialDeviceLost("y")
    surv, lost = be.enumerate_survivors(m, e)
    assert len(surv) == len(lost) == 2
    assert be.enumerate_survivors(m, flt.DeviceLostError("z")) == (
        [], list(m.devices.flat))
    assert be.enumerate_survivors(None) == ([], [])
    assert be.device_inventory([torch.device("cpu"),
                                torch.device("cuda", 1)]) == [
        "cpu:0", "cuda:1"]


def test_announcements_emit_the_jax_events(caplog):
    bus = Telemetry()
    with bus.activate(), caplog.at_level("WARNING",
                                         logger="netrep_tpu_torch"):
        be.announce_mesh_shrunk("device_lost", [1], [2, 3], discovery="d")
        be.announce_mesh_grown([1, 2, 3], [2, 3])
        be.degrade_to_cpu("device_lost", freed=["cuda:0"])
    c = bus.metrics.counters
    assert (c["mesh_shrunk.count"], c["mesh_grown.count"],
            c["degraded_to_cpu.count"]) == (1, 1, 1)
    assert "degrading to the CPU" in caplog.text


# ---------------------------------------------------------------------------
# the background checkpoint writer
# ---------------------------------------------------------------------------

def _ckpt_args():
    rng = np.random.default_rng(0)
    return dict(nulls=rng.standard_normal((64, 5, 7)), completed=40,
                key_data=np.array([0, 5], np.uint32),
                fingerprint=np.frombuffer(b"fp|x", np.uint8),
                extra={"stream_hi": np.arange(35).reshape(5, 7)})


def test_async_writer_writes_the_synchronous_bytes(tmp_path):
    a = _ckpt_args()
    ckpt.save_null_checkpoint(str(tmp_path / "sync.npz"), **a)
    w = ckpt.AsyncCheckpointWriter()
    live = a["nulls"]
    ckpt.save_null_checkpoint(str(tmp_path / "async.npz"), **a, writer=w)
    live[:] = 0.0  # the loop overwrites its buffer: the save holds a copy
    w.close()
    assert (tmp_path / "sync.npz").read_bytes() == \
        (tmp_path / "async.npz").read_bytes()
    assert not w.submit(lambda: None)  # closed: saves are synchronous
    assert_no_threads_left()


def test_async_writer_file_resumes_in_jax(tmp_path):
    a = _ckpt_args()
    w = ckpt.AsyncCheckpointWriter()
    ckpt.save_null_checkpoint(str(tmp_path / "c.npz"), **a, writer=w)
    w.flush()
    loaded = jckpt.load_null_checkpoint(str(tmp_path / "c.npz"))
    nulls, start = jckpt.validate_resume(loaded, 64, a["key_data"],
                                         a["fingerprint"],
                                         str(tmp_path / "c.npz"))
    assert start == 40
    np.testing.assert_array_equal(nulls, _ckpt_args()["nulls"])
    w.close()


def test_async_writer_latest_wins_and_emits_its_flush(tmp_path):
    bus = Telemetry()
    w = ckpt.AsyncCheckpointWriter(bus)
    gate = threading.Event()
    w.submit(gate.wait)  # holds the thread while two more queue
    while not w._busy:
        time.sleep(0.001)
    w.submit(lambda: None)
    w.submit(lambda: None)
    gate.set()
    w.close()
    assert bus.metrics.counters["checkpoint_async_flush.count"] == 1
    assert bus.metrics.gauges["checkpoint_async_flush.superseded"] == 1


def test_degraded_scope_accepts_a_fingerprint_but_never_a_key(tmp_path):
    a = _ckpt_args()
    path = str(tmp_path / "c.npz")
    ckpt.save_null_checkpoint(path, **a)
    loaded = ckpt.load_null_checkpoint(path)
    other = np.frombuffer(b"other", np.uint8)
    with pytest.raises(ValueError, match="different problem"):
        ckpt.validate_identity(loaded, a["key_data"], other, path)
    bus = Telemetry()
    with bus.activate(), ckpt.accept_degraded_fingerprint("device_lost"):
        ckpt.validate_identity(loaded, a["key_data"], other, path)
        with pytest.raises(ValueError, match="PRNG key"):
            ckpt.validate_identity(loaded, np.array([1, 1], np.uint32),
                                   other, path)
    c = bus.metrics.counters
    assert c["fingerprint_degraded_accept.count"] == 2
    assert c["checkpoint_resumed.count"] == 1


# ---------------------------------------------------------------------------
# the atlas builder under a plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("screen", (False, True), ids=("plain", "screened"))
@pytest.mark.parametrize("plan", ("transient@1", "transient@2x2"))
def test_builder_under_a_plan_equals_jax(plan, screen):
    from netrep_tpu.atlas import TiledNetwork as JTiled
    from netrep_tpu.atlas import build_sparse_network as jbuild
    from netrep_tpu_torch.atlas import TiledNetwork, build_sparse_network

    x = np.random.default_rng(3).standard_normal((20, 300))
    for k in range(4):
        x[:, k * 22:(k + 1) * 22] += 1.2 * x[:, [k]]
    kw = dict(top_k=5, tile_edge=64, screen=screen)
    bt, bj = Telemetry(watchdog_poll_s=0), JBus(watchdog_poll_s=0)
    pt = build_sparse_network(
        TiledNetwork.from_data(x, 2.0), device="cpu", telemetry=bt,
        fault_policy=FaultPolicy(plan=plan, backoff_base_s=0.0), **kw)
    jx = jbuild(JTiled.from_data(x, 2.0), config=JConfig(autotune=False),
                telemetry=bj,
                fault_policy=JPolicy(plan=plan, backoff_base_s=0.0), **kw)
    plain = build_sparse_network(TiledNetwork.from_data(x, 2.0),
                                 device="cpu", **kw)
    for f in ("adjacency", "correlation"):
        assert np.array_equal(getattr(pt, f).nbr, getattr(jx, f).nbr)
        assert np.array_equal(getattr(pt, f).nbr, getattr(plain, f).nbr)
        assert np.array_equal(getattr(pt, f).wgt, getattr(plain, f).wgt)
    for ev in ("fault_injected", "retry_attempt"):
        assert bt.metrics.counters[f"{ev}.count"] == \
            bj.metrics.counters[f"{ev}.count"]


def test_builder_device_loss_raises_after_the_save(tmp_path):
    from netrep_tpu_torch.atlas import TiledNetwork, build_sparse_network

    x = np.random.default_rng(3).standard_normal((20, 300))
    ck = str(tmp_path / "atlas.npz")
    net = TiledNetwork.from_data(x, 2.0)
    with pytest.raises(flt.DeviceLostError):
        build_sparse_network(net, top_k=5, tile_edge=64, device="cpu",
                             checkpoint_path=ck,
                             fault_policy=FaultPolicy(plan="device_lost@3"))
    assert ckpt.load_null_checkpoint(ck)["completed"] == 3
    resumed = build_sparse_network(net, top_k=5, tile_edge=64, device="cpu",
                                   checkpoint_path=ck)
    plain = build_sparse_network(net, top_k=5, tile_edge=64, device="cpu")
    assert np.array_equal(resumed.adjacency.nbr, plain.adjacency.nbr)
