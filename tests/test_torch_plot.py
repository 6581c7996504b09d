"""The port's plot suite (``device="cpu"``) against the JAX package's:
``ModuleLayout`` orders and arrays equal to the JAX package's ``_prepare``
(orders exactly, values within ``ATOL``), ``node_order`` and
``sample_order`` equal, the same errors, and every ``plot_*`` drawn on the
Agg backend."""

import builtins

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from netrep_tpu import plot as jplot  # noqa: E402
from netrep_tpu.data import load_example  # noqa: E402
from netrep_tpu_torch import plot as tplot  # noqa: E402

ATOL = 1e-5


@pytest.fixture(scope="module")
def ex():
    return load_example(seed=5)


def _inputs(ex, with_data=True):
    def df(m, names):
        return pd.DataFrame(m, index=names, columns=names)

    kw = dict(
        network={"d": df(ex["discovery_network"], ex["discovery_names"]),
                 "t": df(ex["test_network"], ex["test_names"])},
        correlation={"d": df(ex["discovery_correlation"],
                             ex["discovery_names"]),
                     "t": df(ex["test_correlation"], ex["test_names"])},
        module_assignments={"d": {nm: ex["module_labels"].get(nm, "0")
                                  for nm in ex["discovery_names"]}},
    )
    if with_data:
        kw["data"] = {
            "d": pd.DataFrame(ex["discovery_data"],
                              columns=ex["discovery_names"]),
            "t": pd.DataFrame(ex["test_data"], columns=ex["test_names"]),
        }
    return kw


def _close(a, b):
    if b is None:
        assert a is None
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("order_nodes_by", ["discovery", "test", None, "d",
                                            "t"])
@pytest.mark.parametrize("modules", [None, ["2", "1"], ["3"]])
@pytest.mark.parametrize("with_data", [True, False])
def test_layout_equal_jax(ex, order_nodes_by, modules, with_data):
    kw = dict(**_inputs(ex, with_data), discovery="d", test="t",
              modules=modules, order_nodes_by=order_nodes_by)
    t = tplot._prepare(**kw, device="cpu")
    j = jplot._prepare(**kw)
    np.testing.assert_array_equal(t.node_idx, j.node_idx)
    assert t.node_names == j.node_names
    assert t.module_of == j.module_of and t.modules == j.modules
    np.testing.assert_array_equal(t.boundaries, j.boundaries)
    _close(t.degree, j.degree)
    _close(t.contribution, j.contribution)
    _close(t.summary, j.summary)
    if j.sample_order is None:
        assert t.sample_order is None
    else:
        np.testing.assert_array_equal(t.sample_order, j.sample_order)
    ix = np.ix_(j.node_idx, j.node_idx)
    _close(t.correlation, j.target.correlation[ix])
    _close(t.network, j.target.network[ix])
    _close(t.data, None if j.target.data is None
           else j.target.data[:, j.node_idx])
    assert t.target.name == j.target.name == "t"


@pytest.mark.parametrize("stats", ["full", "summary", "none"])
def test_layout_stats_levels_equal_jax(ex, stats):
    kw = dict(**_inputs(ex), discovery="d", test="t", stats=stats)
    t, j = tplot._prepare(**kw, device="cpu"), jplot._prepare(**kw)
    _close(t.contribution, j.contribution)
    _close(t.summary, j.summary)
    assert (t.sample_order is None) == (j.sample_order is None)


@pytest.mark.parametrize("order_nodes_by", ["discovery", "test", None])
def test_node_and_sample_order_equal_jax(ex, order_nodes_by):
    kw = dict(**_inputs(ex), discovery="d", test="t", modules=["1", "2"])
    assert tplot.node_order(**kw, order_nodes_by=order_nodes_by,
                            device="cpu") == \
        jplot.node_order(**kw, order_nodes_by=order_nodes_by)
    t = tplot.sample_order(**kw, device="cpu")
    j = jplot.sample_order(**kw)
    assert list(t) == list(j)
    # unnamed data: indices
    arrays = dict(kw, data={"d": ex["discovery_data"],
                            "t": ex["test_data"]})
    np.testing.assert_array_equal(
        tplot.sample_order(**arrays, device="cpu"),
        jplot.sample_order(**arrays))


@pytest.mark.parametrize("case", [
    dict(order_nodes_by="nope"),
    dict(order_samples_by="d"),
    dict(modules=["9"]),
    dict(discovery="zz"),
], ids=["order_nodes_by", "order_samples_by", "unknown_module",
        "unknown_dataset"])
def test_errors_as_jax(ex, case):
    kw = dict(**_inputs(ex), discovery="d", test="t")
    kw.update(case)
    with pytest.raises(ValueError) as te:
        tplot._prepare(**kw, device="cpu")
    with pytest.raises(ValueError) as je:
        jplot._prepare(**kw)
    assert str(te.value) == str(je.value)


def test_sample_order_without_data_as_jax(ex):
    kw = _inputs(ex, with_data=False)
    with pytest.raises(ValueError) as te:
        tplot.sample_order(kw["network"], None, kw["correlation"],
                           kw["module_assignments"], discovery="d",
                           test="t", device="cpu")
    with pytest.raises(ValueError) as je:
        jplot.sample_order(kw["network"], None, kw["correlation"],
                           kw["module_assignments"], discovery="d", test="t")
    assert str(te.value) == str(je.value)


def test_plot_module_composite(ex, tmp_path):
    fig, axes = tplot.plot_module(**_inputs(ex), discovery="d", test="t",
                                  modules=["1", "2"], device="cpu")
    assert set(axes) == {"data", "summary", "correlation", "network",
                         "contribution", "degree"}
    out = tmp_path / "module.png"
    fig.savefig(out, dpi=60)
    assert out.stat().st_size > 10_000
    plt.close(fig)


def test_plot_module_dataless(ex):
    fig, axes = tplot.plot_module(**_inputs(ex, with_data=False),
                                  discovery="d", test="t", modules=["1"],
                                  device="cpu")
    assert set(axes) == {"correlation", "network", "degree"}
    plt.close(fig)


@pytest.mark.parametrize("name", ["plot_data", "plot_correlation",
                                  "plot_network", "plot_summary",
                                  "plot_contribution", "plot_degree"])
def test_per_panel_functions(ex, name):
    kw = _inputs(ex)
    ax = getattr(tplot, name)(kw["network"], kw["data"], kw["correlation"],
                              kw["module_assignments"], discovery="d",
                              test="t", modules=["1"], device="cpu")
    assert ax.figure is not None and ax.has_data()
    plt.close(ax.figure)


def test_dataless_data_panel_raises_as_jax(ex):
    kw = _inputs(ex, with_data=False)
    with pytest.raises(ValueError) as te:
        tplot.plot_data(kw["network"], None, kw["correlation"],
                        kw["module_assignments"], discovery="d", test="t",
                        device="cpu")
    with pytest.raises(ValueError) as je:
        jplot.plot_data(kw["network"], None, kw["correlation"],
                        kw["module_assignments"], discovery="d", test="t")
    assert str(te.value) == str(je.value)
    plt.close("all")


def test_without_matplotlib(ex, monkeypatch):
    # the layout needs no matplotlib; drawing names the plot extra
    real = builtins.__import__

    def refuse(name, *a, **k):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib here")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", refuse)
    kw = dict(**_inputs(ex), discovery="d", test="t", modules=["1"])
    assert tplot.node_order(**kw, device="cpu")
    with pytest.raises(ImportError, match=r"needs matplotlib .*\[plot\]"):
        tplot.plot_module(**kw, device="cpu")


def test_needs_a_card_unless_cpu(ex, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplot.node_order(**_inputs(ex), discovery="d", test="t")
