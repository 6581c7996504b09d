"""The port's perf ledger (``netrep_tpu_torch.utils.perfledger``) against
the JAX package's, on the CPU, and the two ledger hooks of the port's
server.

Held: a ledger written by either package reads through the other's
``read_entries`` to the same entries (foreign and corrupt lines skipped
alike); ``check``, ``trend`` and ``check_roofline`` give the JAX module's
verdict and text on the same file; bench-row fingerprints, conversion and
the ingestion of the repo's ``BENCH_r0*.json`` give the JAX module's
entries; ``maybe_record_run`` writes only under ``NETREP_PERF_LEDGER``.
The server's rate falls back on the ledger's serve history (the JAX
server's estimate on the same file) only before anything is configured or
measured, and a fleet-labeled server records ONE cold-start entry
(``serve-fleet-coldstart|<label>|cpu``, the device type as its backend)
while a stand-alone server records none."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from netrep_tpu import serve as jserve  # noqa: E402
from netrep_tpu.data import make_mixed_pair  # noqa: E402
from netrep_tpu.utils import perfledger as jpl  # noqa: E402
from netrep_tpu_torch import serve as tserve  # noqa: E402
from netrep_tpu_torch.utils import perfledger as tpl  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_FILES = [os.path.join(REPO, f"BENCH_r0{i}.json") for i in range(1, 6)]
FP = "cuda|direct|caps:16x3|chunk:128"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fx():
    mixed = make_mixed_pair(100, 3, n_samples=16, seed=7)
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    assign = {f"node_{i}": "0" for i in range(dn.shape[0])}
    for lab, idx in mixed["specs"]:
        for i in idx:
            assign[f"node_{i}"] = str(lab)
    return dict(dn=dn, dc=dc, dd=dd, tn=tn, tc=tc, td=td, assign=assign)


def _write(pl, path, values, fp=FP, **kw):
    for i, v in enumerate(values):
        pl.append_entry(pl.make_entry(fp, v, "run", backend="cuda",
                                      mode="materialized", t=float(i),
                                      **kw), path)


def _foreign(path):
    with open(path, "a", encoding="utf-8") as f:
        f.write("# comment\n")
        f.write(json.dumps({"metric": "bench row", "value": 1}) + "\n")
        f.write(json.dumps({"v": 1, "ev": "chunk", "data": {}}) + "\n")
        f.write("{broken json\n")


# ---------------------------------------------------------------------------
# ledgers cross packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ("jax", "port"))
def test_ledger_crosses_packages(tmp_path, writer):
    """Each package reads the other's ledger to the same entries; the
    entry shape (key order, rounding, optional blocks) is the JAX
    module's."""
    path = str(tmp_path / "led.jsonl")
    pl = jpl if writer == "jax" else tpl
    _foreign(path)
    _write(pl, path, (100.123456789, 90.0))
    pl.append_entry(pl.make_entry(
        "fp2", 5.5, "serve", backend="cpu", compile_s=1.23456, n_perm=64,
        run_id="r", round_n=3, metric="m", t=7.0,
        cost={"a": {"device_s": 1.0, "perms": 64, "bytes_to_host": 8}},
        roofline={"family": "fused", "utilisation": 0.5}), path)
    _foreign(path)
    got, want = tpl.read_entries(path), jpl.read_entries(path)
    assert got == want and len(got) == 3
    assert list(got[0]) == list(jpl.make_entry("x", 1.0, "run", t=0.0))
    assert got[0]["perms_per_sec"] == 100.1235
    assert list(got[2])[-4:] == ["cost_v", "cost", "roofline_v", "roofline"]
    for kw in (dict(), dict(compile_s=2.0, n_perm=8, round_n=1, t=3.0)):
        assert tpl.make_entry("f", 2.0, "bench", **kw | {"t": 1.0}) == \
            jpl.make_entry("f", 2.0, "bench", **kw | {"t": 1.0})


@pytest.mark.parametrize("values,fps", [
    ((), ()),
    ((100.0,), ()),
    ((100.0, 110.0, 90.0, 105.0), ()),
    ((100.0, 110.0, 90.0, 105.0, 40.0), ()),
    ((100.0, 110.0, 90.0, 105.0), (("tpu|other", 5.0),)),
    ((100.0, 101.0), (("gpu|x", 3.0), ("gpu|x", 1.0))),
])
@pytest.mark.parametrize("threshold", (0.4, 0.7))
def test_check_and_trend_equal_jax(tmp_path, values, fps, threshold):
    """``check`` (verdict and report) and ``trend`` equal the JAX
    module's on the same file, across baselines, matching histories,
    regressions and foreign fingerprints."""
    path = str(tmp_path / "led.jsonl")
    open(path, "w").close()
    _write(tpl, path, values)
    for fp, v in fps:
        _write(jpl, path, (v,), fp=fp)
    assert tpl.check(path, threshold=threshold) == \
        jpl.check(path, threshold=threshold)
    assert tpl.check(path, window=2) == jpl.check(path, window=2)
    assert tpl.trend(path) == jpl.trend(path)
    ok, rep = tpl.check(path, threshold=threshold)
    if values and values[-1] == 40.0 and threshold == 0.4:
        assert not ok and "PERF REGRESSION" in rep


def test_check_roofline_equal_jax(tmp_path):
    """The roofline gate reads what the JAX package writes: the same
    verdicts on utilisation and on achieved_pps histories."""
    path = str(tmp_path / "led.jsonl")
    open(path, "w").close()
    assert tpl.check_roofline(path) == jpl.check_roofline(path)
    for i, u in enumerate((0.5, 0.52, 0.48, 0.2)):
        jpl.append_entry(jpl.make_entry(
            FP, 100.0, "run", t=float(i),
            roofline={"family": "fused", "utilisation": u}), path)
        assert tpl.check_roofline(path) == jpl.check_roofline(path)
    jpl.append_entry(jpl.make_entry(
        FP, 100.0, "run", t=9.0,
        roofline={"family": "fused", "utilisation": None,
                  "achieved_pps": 50.0}), path)
    assert tpl.check_roofline(path) == jpl.check_roofline(path)
    ok, rep = tpl.check_roofline(path)
    assert ok and "achieved_pps" in rep


def test_bench_rows_and_ingest_equal_jax(tmp_path):
    """Bench fingerprints keep backend classes apart (a card's row never
    shares a history with a TPU or CPU row); conversion and the ingestion
    of the repo's bench-round files give the JAX module's entries."""
    rows = [
        {"metric": "wall-clock (north-star)", "device": "TPU_0(process=0)",
         "chunk": 256, "dtype": "float32", "perms_per_sec": 120.0},
        {"metric": "wall-clock [CPU fallback]", "device": "TFRT_CPU_0",
         "chunk": 256, "dtype": "float32", "perms_per_sec": 10.0},
        {"metric": "wall-clock", "device": "cuda:0", "chunk": 128,
         "perms_per_sec": 5000.0, "cost": {"a": {"perms": 1}}},
        {"metric": "wall-clock", "device": "NVIDIA H100 80GB HBM3 gpu",
         "perms_per_sec": 5000.0},
        {"metric": "x", "warning": "w"},
        {"metric": "", "perms_per_sec": 1.0},
    ]
    for row in rows:
        assert tpl.bench_fingerprint(row) == jpl.bench_fingerprint(row)
        assert tpl.entry_from_bench_row(row, t=1.0) == \
            jpl.entry_from_bench_row(row, t=1.0)
    classes = {tpl.bench_fingerprint(r).split("|")[2] for r in rows[:4]}
    assert classes == {"tpu", "cpu", "gpu"}
    for dev in ("cuda", "cpu", "TPU v4", "gpu:0", "", "weird"):
        assert tpl._backend_class(dev) == jpl._backend_class(dev)
    got, want = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    n = tpl.ingest_bench_files(BENCH_FILES, got)
    assert n == jpl.ingest_bench_files(BENCH_FILES, want) and n >= 4
    assert tpl.read_entries(got) == jpl.read_entries(want)
    assert tpl.check(got) == jpl.check(want)


def test_maybe_record_run_env_gated(tmp_path, monkeypatch):
    monkeypatch.delenv(tpl.LEDGER_ENV, raising=False)
    assert not tpl.maybe_record_run("fp", 10.0, "materialized", "cuda")
    path = str(tmp_path / "led.jsonl")
    monkeypatch.setenv(tpl.LEDGER_ENV, path)
    assert tpl.default_path() == path == jpl.default_path()
    assert tpl.maybe_record_run("fp", 10.0, "materialized", "cuda",
                                compile_s=0.5, n_perm=64, run_id="r1")
    assert not tpl.maybe_record_run("fp", 0.0, "materialized", "cuda")
    (row,) = jpl.read_entries(path)
    assert row["source"] == "run" and row["backend"] == "cuda"
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    assert tpl.append_entry(row, str(blocker / "led.jsonl")) is False


# ---------------------------------------------------------------------------
# the server's ledger hooks
# ---------------------------------------------------------------------------

def _servers(fx, tmp_path, **kw):
    port = tserve.PreservationServer(tserve.ServeConfig(
        engine=EngineConfig(chunk_size=16), device="cpu", **kw),
        start=False)
    jax = jserve.PreservationServer(jserve.ServeConfig(**kw), start=False)
    for srv in (port, jax):
        srv.register_dataset("a", "d", network=fx["dn"],
                             correlation=fx["dc"], data=fx["dd"],
                             assignments=fx["assign"])
        srv.register_dataset("a", "t", network=fx["tn"],
                             correlation=fx["tc"], data=fx["td"])
    return port, jax


@pytest.mark.parametrize("history", ("none", "serve", "eleven"))
def test_server_rate_falls_back_on_the_ledger(fx, tmp_path, monkeypatch,
                                              history):
    """Before a rate is configured or measured the server reads the
    ledger's serve/run entries (the median of the last eight; bench rows
    ignored) — the JAX server's estimate on the same file; a configured
    rate comes first."""
    path = str(tmp_path / "led.jsonl")
    monkeypatch.setenv(tpl.LEDGER_ENV, path)
    if history == "serve":
        for pps, src in ((999.0, "bench"), (30.0, "serve"), (10.0, "run"),
                         (20.0, "serve")):
            jpl.append_entry(jpl.make_entry("fp", pps, src, t=0.0), path)
    elif history == "eleven":
        for i in range(11):
            tpl.append_entry(tpl.make_entry("fp", float(i + 1), "serve",
                                            t=float(i)), path)
    port, jax = _servers(fx, tmp_path)
    configured, _ = _servers(fx, tmp_path, brownout_rate_pps=3.0)
    try:
        for srv in (port, jax):
            srv.submit("a", "d", "t", n_perm=64, seed=1)
        got, want = port.stats(), jax.stats()
        assert got["rate_pps"] == want["rate_pps"]
        assert got["rate_pps"] == {"none": None, "serve": 20.0,
                                   "eleven": 8.0}[history]
        assert tpl.serve_rate() == got["rate_pps"]
        assert configured.stats()["rate_pps"] == 3.0
        if history != "none":
            assert port._drain_estimate_locked() == pytest.approx(
                64 / got["rate_pps"])
    finally:
        for srv in (port, jax, configured):
            srv.close(drain=False)


@pytest.mark.parametrize("label", ("r0", None))
def test_coldstart_entry_only_with_fleet_label(fx, tmp_path, monkeypatch,
                                               label):
    """A fleet-labeled server's FIRST completed pack records one
    ``serve-fleet-coldstart|<label>|cpu`` entry (compile span — the pack's
    cost, tracked under telemetry — perms/s, the JAX entry's fields); the
    second pack records nothing; without
    ``fleet_label`` nothing is recorded; without the ledger variable no
    file is written."""
    path = str(tmp_path / "led.jsonl")
    monkeypatch.setenv(tpl.LEDGER_ENV, path)
    srv = tserve.PreservationServer(tserve.ServeConfig(
        engine=EngineConfig(chunk_size=16), device="cpu",
        fleet_label=label, telemetry=str(tmp_path / "tel.jsonl")))
    for name, mats, assign in (("d", ("dn", "dc", "dd"), fx["assign"]),
                               ("t", ("tn", "tc", "td"), None)):
        srv.register_dataset("a", name, network=fx[mats[0]],
                             correlation=fx[mats[1]], data=fx[mats[2]],
                             assignments=assign)
    try:
        srv.analyze("a", "d", "t", n_perm=32, seed=3, timeout=600)
        srv.analyze("a", "d", "t", n_perm=32, seed=4, timeout=600)
        assert srv.stats()["fleet_label"] == label
    finally:
        srv.close()
    entries = jpl.read_entries(path) if os.path.exists(path) else []
    cold = [e for e in entries
            if e["fingerprint"].startswith("serve-fleet-coldstart|")]
    if label is None:
        assert cold == []
        return
    (e,) = cold
    assert e["fingerprint"] == "serve-fleet-coldstart|r0|cpu"
    assert e["backend"] == "cpu" and e["source"] == "serve"
    assert e["mode"] == "fleet-coldstart" and e["n_perm"] == 32
    assert e["compile_s"] is not None and e["compile_s"] >= 0
    assert e["perms_per_sec"] > 0
    assert e["metric"] == "serve-fleet coldstart r0"
    assert list(e) == list(jpl.make_entry("x", 1.0, "serve", t=0.0))
    monkeypatch.delenv(tpl.LEDGER_ENV)
    os.unlink(path)
    srv = tserve.PreservationServer(tserve.ServeConfig(
        engine=EngineConfig(chunk_size=16), device="cpu",
        fleet_label=label))
    srv.register_dataset("a", "d", network=fx["dn"], correlation=fx["dc"],
                         data=fx["dd"], assignments=fx["assign"])
    srv.register_dataset("a", "t", network=fx["tn"], correlation=fx["tc"],
                         data=fx["td"])
    try:
        srv.analyze("a", "d", "t", n_perm=32, seed=3, timeout=600)
    finally:
        srv.close()
    assert not os.path.exists(path)
