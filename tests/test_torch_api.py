"""The port's package-level surface (``netrep_tpu_torch.api``) against the
JAX package's (``netrep_tpu/__init__.py``): the same ``__all__`` in the same
order, every name the port's own object, the plot suite lazy and outside
``__all__``, an import that loads neither ``jax`` nor ``matplotlib`` (nor
``torch``), and ``module_preservation`` through the surface equal to the JAX
package's on the example pair: module sets, counts and p-values exactly,
nulls within ROADMAP Queue 3's documented tolerance (99.9% of values within
1e-5, all within 1e-4)."""

import importlib
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pandas")

import netrep_tpu  # noqa: E402
import netrep_tpu_torch.api as nt  # noqa: E402
from netrep_tpu.data import make_example_pair, pair_frames  # noqa: E402
from netrep_tpu.ops import pvalues as jpv  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: where each name lives in the port
HOME = {
    "STAT_NAMES": "ops.oracle", "TOPOLOGY_STATS": "ops.oracle",
    "module_preservation": "models.preservation",
    "grid_preservation": "models.grid", "GridResult": "models.grid",
    "network_properties": "models.properties",
    "properties_table": "models.properties",
    "required_perms": "ops.pvalues", "permp": "ops.pvalues",
    "load_example": "data", "make_example_pair": "data",
    "PreservationResult": "models.results",
    "combine_analyses": "models.results", "results_table": "models.results",
    "SparseAdjacency": "ops.sparse",
    "sparse_module_preservation": "models.sparse_api",
    "sparse_network_properties": "models.sparse_api",
    "TiledNetwork": "atlas.tiles", "build_sparse_network": "atlas.builder",
    "atlas_module_preservation": "models.atlas_api",
    "summarize_trace": "utils.profiling", "make_mesh": "parallel.mesh",
    "selftest": "utils.selftest", "FaultPolicy": "utils.config",
}
PLOTS = ("plot_module", "plot_data", "plot_correlation", "plot_network",
         "plot_summary", "plot_contribution", "plot_degree",
         "plot_module_sparse")


@pytest.fixture(autouse=True)
def autotune_store(tmp_path_factory, monkeypatch):
    """Each test its own autotune store: nothing writes the default one."""
    monkeypatch.setenv("NETREP_AUTOTUNE_STORE",
                       str(tmp_path_factory.mktemp("autotune")))


def test_all_equals_the_jax_package():
    assert nt.__all__ == netrep_tpu.__all__
    assert len(nt.__all__) == 24
    assert set(HOME) == set(nt.__all__)


def test_version_is_the_ports():
    from netrep_tpu_torch import version

    assert nt.__version__ == version.__version__ == netrep_tpu.__version__


@pytest.mark.parametrize("name", sorted(HOME))
def test_name_resolves_to_the_ports_object(name):
    got = getattr(nt, name)
    mod = importlib.import_module(f"netrep_tpu_torch.{HOME[name]}")
    attr = "module_preservation" if name == "atlas_module_preservation" \
        else name
    assert got is getattr(mod, attr)
    if inspect.isfunction(got) or inspect.isclass(got):
        assert got.__module__ == f"netrep_tpu_torch.{HOME[name]}"
        jax_twin = getattr(netrep_tpu, name)
        assert got is not jax_twin


def test_constants_equal_the_jax_package():
    assert tuple(nt.STAT_NAMES) == tuple(netrep_tpu.STAT_NAMES)
    assert tuple(nt.TOPOLOGY_STATS) == tuple(netrep_tpu.TOPOLOGY_STATS)


@pytest.mark.parametrize("name", PLOTS)
def test_plot_exports_are_lazy_and_outside_all(name, monkeypatch):
    from netrep_tpu_torch import plot

    assert name not in nt.__all__
    assert name not in vars(nt)
    assert getattr(nt, name) is getattr(plot, name)
    assert name not in vars(nt)          # resolved afresh, never cached
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match=r"matplotlib.*pip install "
                                          r"netrep-tpu\[plot\]"):
        getattr(nt, name)


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError):
        nt.no_such_entry_point
    assert not hasattr(nt, "plot_everything")


def test_star_import_needs_no_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    ns: dict = {}
    exec("from netrep_tpu_torch.api import *", ns)
    assert set(nt.__all__) <= set(ns)


def test_fresh_import_loads_no_jax_torch_or_matplotlib():
    code = (
        "import sys, json\n"
        "import netrep_tpu_torch.api as nt\n"
        "first = sorted(m for m in ('jax', 'matplotlib', 'torch', "
        "'netrep_tpu') if m in sys.modules)\n"
        "nt.module_preservation\n"
        "second = sorted(m for m in ('jax', 'matplotlib', 'netrep_tpu', "
        "'netrep_tpu_torch.plot') if m in sys.modules)\n"
        "print(json.dumps([first, second, 'torch' in sys.modules]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    first, second, torch_loaded = __import__("json").loads(
        out.stdout.strip().splitlines()[-1])
    assert first == [] and second == [] and torch_loaded


def test_device_rule_kept():
    """No new default: ``device=None`` still means the card."""
    sig = inspect.signature(nt.module_preservation)
    assert sig.parameters["device"].default is None
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    pair = make_example_pair(np.random.default_rng(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nt.module_preservation(
            network={"d": pair["discovery"]["network"],
                     "t": pair["test"]["network"]},
            module_assignments=pair["labels"], discovery="d", test="t",
            n_perm=8)


@pytest.fixture(scope="module")
def example():
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    return dict(
        network={"d": d["network"], "t": t["network"]},
        data={"d": d["data"], "t": t["data"]},
        correlation={"d": d["correlation"], "t": t["correlation"]},
        module_assignments=pair["labels"], discovery="d", test="t",
        n_perm=200, seed=11)


@pytest.mark.parametrize("store", [True, False],
                         ids=["materialized", "streaming"])
def test_module_preservation_through_the_surface_equals_jax(example, store,
                                                            tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("NETREP_AUTOTUNE_STORE", str(tmp_path / "at"))
    t = nt.module_preservation(**example, store_nulls=store, device="cpu")
    j = netrep_tpu.module_preservation(**example, store_nulls=store)
    assert t.module_labels == j.module_labels
    assert (t.completed, t.n_perm, t.total_space) == (
        j.completed, j.n_perm, j.total_space)
    np.testing.assert_allclose(t.observed, j.observed, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t.p_values, j.p_values)
    assert t.preserved_modules() == j.preserved_modules()
    if store:
        th = jpv.tail_counts(t.observed, t.nulls)
        jh = jpv.tail_counts(j.observed, j.nulls)
        dev = np.abs(t.nulls - j.nulls)
        finite = np.isfinite(dev)
        assert np.array_equal(np.isnan(t.nulls), np.isnan(j.nulls))
        assert dev[finite].max() <= 1e-4
        assert np.mean(dev[finite] <= 1e-5) >= 0.999
    else:
        th = (t.counts_hi, t.counts_lo, t.counts_eff)
        jh = (j.counts_hi, j.counts_lo, j.counts_eff)
    for a, b in zip(th, jh):
        np.testing.assert_array_equal(a, b)


def test_network_properties_and_required_perms_through_the_surface(example):
    kw = {k: example[k] for k in ("network", "data", "correlation",
                                  "module_assignments", "discovery", "test")}
    t = nt.network_properties(**kw, device="cpu")
    j = netrep_tpu.network_properties(**kw)
    assert sorted(t) == sorted(j)
    for mod in t:
        assert t[mod]["node_names"] == list(j[mod]["node_names"])
        np.testing.assert_allclose(t[mod]["coherence"], j[mod]["coherence"],
                                   rtol=0, atol=1e-6)
    for alpha, n in ((0.05, 1), (0.05, 28), (0.01, 350)):
        assert nt.required_perms(alpha, n_tests=n) == \
            netrep_tpu.required_perms(alpha, n_tests=n)
