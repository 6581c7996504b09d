"""``python -m netrep_tpu_torch warmup`` against the JAX package's
``warmup``: the same shape grammar, the same report keys (a shape's
serve-path and direct engines built and run one chunk, the store's stats),
the same ``--measure`` keys; on the CPU no kernel library is built and the
first run's source is ``memo``."""

import json

import pytest

torch = pytest.importorskip("torch")

from netrep_tpu import warmup as jwarmup  # noqa: E402
from netrep_tpu.utils import aot as jaot  # noqa: E402
from netrep_tpu_torch import __main__ as tcli  # noqa: E402
from netrep_tpu_torch import warmup as twarmup  # noqa: E402
from netrep_tpu_torch.utils import aot  # noqa: E402


@pytest.mark.parametrize("spec", [None, "", "300:6:24", "300:6:24,600:10:24",
                                  " 120:3:16 , 80:2:12"])
def test_parse_grid_equals_jax(spec):
    assert (twarmup.parse_grid(spec, 120, 3, 16)
            == jwarmup.parse_grid(spec, 120, 3, 16))


def test_parse_grid_refuses_what_jax_refuses():
    for bad in ("300:6", "a:b:c"):
        with pytest.raises(ValueError):
            jwarmup.parse_grid(bad, 1, 1, 1)
        with pytest.raises(ValueError):
            twarmup.parse_grid(bad, 1, 1, 1)


@pytest.fixture(scope="module")
def jax_reports(tmp_path_factory):
    """The JAX package's warmup report and first-run measurement on the
    default shape, against a store of their own."""
    store = tmp_path_factory.mktemp("jaot")
    mp = pytest.MonkeyPatch()
    mp.setenv(jaot.STORE_ENV, str(store))
    jaot.reset_store()
    try:
        grid = jwarmup.warmup_grid([(120, 3, 16)], 64, None)
        measure = jwarmup.measure_first_run(120, 3, 16, 7, 64, 256)
    finally:
        mp.undo()
        jaot.reset_store()
    return grid, measure


def test_warmup_report_has_the_jax_keys(capsys, tmp_path, monkeypatch,
                                        jax_reports):
    monkeypatch.setenv(aot.STORE_ENV, str(tmp_path / "store"))
    assert tcli.main(["warmup", "--device", "cpu", "--json"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want, _ = jax_reports
    assert set(report) == set(want)
    assert [set(r) for r in report["shapes"]] == [
        set(r) for r in want["shapes"]]
    row = report["shapes"][0]
    assert (row["genes"], row["modules"], row["samples"]) == (120, 3, 16)
    for target in ("serve", "direct"):
        # on the CPU a chunk launches no kernel
        assert row[target]["chunk_s"] > 0
        assert set(row[target]["launches"].values()) == {0}
    assert report["store"]["path"] == str(tmp_path / "store")
    assert report["store"]["builds"] == 0 and report["store"]["entries"] == 0


def test_measure_has_the_jax_keys(capsys, jax_reports):
    assert tcli.main(["warmup", "--device", "cpu", "--measure", "--json",
                      "--n-perm", "128"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _, want = jax_reports
    assert set(out) == set(want)
    assert out["completed"] == out["n_perm"] == 128
    assert out["source"] == "memo" and out["compile_span_s"] is not None
    assert out["perms_per_sec"] > 0


def test_warmup_grid_and_targets(tmp_path):
    rep = twarmup.warmup_grid([(80, 2, 12), (100, 3, 12)], 32, 64,
                              target="direct", device="cpu",
                              telemetry=str(tmp_path / "w.jsonl"))
    assert [(r["genes"], "serve" in r, "direct" in r)
            for r in rep["shapes"]] == [(80, False, True), (100, False, True)]
    evs = [json.loads(line)["ev"] for line in open(tmp_path / "w.jsonl")]
    assert evs[0] == "warmup_start" and evs[-1] == "warmup_end"


def test_warmup_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twarmup.warmup_grid([(120, 3, 16)], 64, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twarmup.measure_first_run(120, 3, 16, 7, 64, 128)
