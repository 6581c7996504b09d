"""Every cell's files are found by name, and every metric file reads."""

import json

import pytest

from portbench import core

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    f = core.cell_files(ROOT, workload)
    assert f["cell"]["name"] == workload
    assert f["config"]["kind"] in ("dense", "knn")
    assert hasattr(f["problem"], "Session") and hasattr(f["driver"], "drive")
    assert {m["name"] for m in f["end_to_end"]} >= {"setup_s", "peak_gib"}
    assert f["per_layer"], "every cell reports a per-layer metric"
    assert set(f["limits"]) >= {"observed_gap", "count_gap"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_file_found_by_name(metric):
    assert callable(core.load_metric(metric).read)


def test_unknown_names_refused():
    with pytest.raises(KeyError):
        core.cell_files(ROOT, "no.such.cell")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()


def test_config_key_not_applied_is_refused():
    from portbench.problems import common, dense

    cfg = core.load_json(ROOT / "portbench" / "configs" / "dense-20k.json")
    common.check_keys(cfg, dense.KEYS)
    with pytest.raises(ValueError, match="not applied"):
        common.check_keys(dict(cfg, cohorts=3), dense.KEYS)
    with pytest.raises(ValueError, match="missing"):
        common.check_keys({k: v for k, v in cfg.items() if k != "tf32"}, dense.KEYS)
    with pytest.raises(TypeError):
        common.engine_config(dict(cfg, engine={"no_such_knob": 1}))


def test_engine_and_cost_follow_the_config(isolated):
    from portbench.problems import dense

    from .conftest import shrink

    f = core.cell_files(ROOT, "dense20k.null100k")
    shrink(f)
    cfg = dict(f["config"], storage="bfloat16",
               engine=dict(f["config"]["engine"], network_from_correlation=2.0))
    s = dense.Session(cfg, 5, "cpu")
    assert s.engine.dtype == "bfloat16" and s.engine.network_from_correlation == 2.0
    shape = s.cost_shape()
    assert shape["width"] == 2 and shape["n_mats"] == 1 and shape["chunk"] == 32
    with pytest.raises(ValueError):
        core.control_precision(cfg)


def test_mix_options_reach_the_entry(isolated, monkeypatch):
    from netrep_tpu_torch.models import preservation

    from .conftest import run_small

    seen = []
    entry = preservation.module_preservation

    def spy(*a, **kw):
        seen.append(kw.get("store_nulls"))
        return entry(*a, **kw)

    monkeypatch.setattr(preservation, "module_preservation", spy)
    out = run_small("dense20k.null100k", 9)
    assert out["correct"] and seen and set(seen) == {False}


def test_traced_run_reads_phases_from_untraced_calls(isolated):
    from .conftest import run_small

    out = run_small("dense20k.null100k", 11, trace=True)
    t = out["timing"]
    assert out["correct"] and t["traced_calls"] == 1
    window = t["each_input_s"][:t["calls"]]
    assert out["metrics"]["input_s"]["value"] == pytest.approx(sum(window) / len(window))
    assert {"engine_s", "observed_s", "null_s.deep"} <= set(out["metrics"])
    assert out["attempted"] == t["calls"] + t["traced_calls"]
