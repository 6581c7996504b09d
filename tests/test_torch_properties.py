"""The port's ``network_properties`` and ``properties_table``
(``device="cpu"``) against the JAX package's on the same inputs: values
within ``ATOL`` (the port gathers from its float32 matrices and computes
in float64; the JAX package computes on its float64 matrices), equal
``None``/NaN patterns, node names and nesting."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

import netrep_tpu  # noqa: E402
from netrep_tpu.data import make_example_pair, pair_frames  # noqa: E402
from netrep_tpu_torch.models import properties as tprops  # noqa: E402

ATOL = 1e-5
KEYS = ("degree", "summary", "contribution", "avg_weight", "coherence")


def _frames(n=40, s=25, seed=17):
    """Discovery and test datasets with named nodes: module "3" has no
    node in the test dataset, module "4" one, and the test dataset holds
    a constant data column."""
    rng = np.random.default_rng(seed)
    names = [f"g{i}" for i in range(n)]
    labels = ["1"] * 12 + ["2"] * 10 + ["3"] * 5 + ["4"] * 4 + ["0"] * 9
    gone = set(names[22:27]) | set(names[28:31])  # all of 3, 3 of 4
    tnames = [nm for nm in names if nm not in gone]
    out = {}
    for key, nms in (("d", names), ("t", tnames)):
        x = rng.standard_normal((s, len(nms)))
        x[:, :12] += rng.standard_normal((s, 1)) * 1.5
        if key == "t":
            x[:, 3] = 0.25
        with np.errstate(invalid="ignore", divide="ignore"):
            c = np.nan_to_num(np.corrcoef(x, rowvar=False))
        np.fill_diagonal(c, 1.0)
        out[key] = dict(
            data=pd.DataFrame(x, columns=nms),
            correlation=pd.DataFrame(c, index=nms, columns=nms),
            network=pd.DataFrame(np.abs(c) ** 2, index=nms, columns=nms),
        )
    return dict(
        network={k: v["network"] for k, v in out.items()},
        data={k: v["data"] for k, v in out.items()},
        correlation={k: v["correlation"] for k, v in out.items()},
        module_assignments=dict(zip(names, labels)),
    )


def _assert_props_equal(tp, jp):
    if jp is None:
        assert tp is None
        return
    assert tp["node_names"] == jp["node_names"]
    for key in KEYS:
        a, b = tp[key], jp[key]
        if b is None:
            assert a is None, key
            continue
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b)
        assert a.shape == b.shape, key
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=key)
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=key)


def _assert_nested_equal(t, j, depth):
    if depth == 0:
        _assert_props_equal(t, j)
        return
    assert list(t) == list(j)
    for k in j:
        _assert_nested_equal(t[k], j[k], depth - 1)


@pytest.mark.parametrize("kw,depth", [
    (dict(discovery="d", test="t"), 1),
    (dict(discovery="d"), 1),
    (dict(discovery="d", test=["d", "t"]), 2),
    (dict(discovery="d", test="t", simplify=False), 3),
    (dict(discovery="d", test="t", modules=["4", "1"]), 1),
    (dict(discovery="d", test=["d", "t"], self_preservation=False), 1),
], ids=["pair", "default_test", "two_tests", "nested", "modules",
        "no_self"])
def test_network_properties_equal_jax(kw, depth):
    inputs = _frames()
    t = tprops.network_properties(**inputs, **kw, device="cpu")
    j = netrep_tpu.network_properties(**inputs, **kw)
    _assert_nested_equal(t, j, depth)


def test_absent_and_one_node_modules():
    inputs = _frames()
    t = tprops.network_properties(**inputs, discovery="d", test="t",
                                  device="cpu")
    assert t["3"] is None
    assert len(t["4"]["node_names"]) == 1
    assert np.isnan(t["4"]["avg_weight"])
    assert np.isfinite(t["1"]["coherence"])


def test_data_less_equal_jax():
    inputs = {k: v for k, v in _frames().items() if k != "data"}
    t = tprops.network_properties(**inputs, discovery="d", test="t",
                                  device="cpu")
    j = netrep_tpu.network_properties(**inputs, discovery="d", test="t")
    _assert_nested_equal(t, j, 1)
    assert t["1"]["summary"] is None and np.isnan(t["1"]["coherence"])


def test_example_fixture_equal_jax():
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    kw = dict(network={"d": d["network"], "t": t["network"]},
              data={"d": d["data"], "t": t["data"]},
              correlation={"d": d["correlation"], "t": t["correlation"]},
              module_assignments=pair["labels"], discovery="d")
    _assert_nested_equal(
        tprops.network_properties(**kw, simplify=False, device="cpu"),
        netrep_tpu.network_properties(**kw, simplify=False), 3)


@pytest.mark.parametrize("with_data", [True, False])
def test_properties_table_equal_jax(with_data):
    inputs = _frames()
    if not with_data:
        inputs.pop("data")
    kw = dict(discovery="d", test=["d", "t"])
    t = tprops.properties_table(**inputs, **kw, device="cpu")
    j = netrep_tpu.properties_table(**inputs, **kw)
    assert list(t.columns) == list(j.columns)
    for col in ("discovery", "test", "module", "node"):
        assert t[col].tolist() == j[col].tolist()
    for col in ("degree", "contribution", "avg_weight", "coherence"):
        np.testing.assert_allclose(t[col].to_numpy(), j[col].to_numpy(),
                                   rtol=0, atol=ATOL, err_msg=col)
        np.testing.assert_array_equal(t[col].isna(), j[col].isna())


def test_errors_as_jax():
    inputs = _frames()
    for kw in (dict(discovery="zz"), dict(discovery="d", modules=["9"]),
               dict(discovery="d", test="d", self_preservation=False)):
        with pytest.raises(ValueError) as te:
            tprops.network_properties(**inputs, **kw, device="cpu")
        with pytest.raises(ValueError) as je:
            netrep_tpu.network_properties(**inputs, **kw)
        assert str(te.value) == str(je.value)


def test_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprops.network_properties(**_frames(), discovery="d")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprops.properties_table(**_frames(), discovery="d")


def test_building_blocks_match_formulas():
    # the float64 helpers against the JAX package's oracle formulas
    from netrep_tpu.ops import oracle

    rng = np.random.default_rng(5)
    x = rng.standard_normal((30, 9))
    x[:, 4] = 1.5  # a constant column: standardized to zero
    net = np.abs(np.corrcoef(rng.standard_normal((30, 9)), rowvar=False))
    xt, nt = torch.from_numpy(x), torch.from_numpy(net)
    np.testing.assert_allclose(tprops.standardize(xt).numpy(),
                               oracle.standardize(x), rtol=0, atol=1e-12)
    prof = tprops.summary_profile(xt)
    np.testing.assert_allclose(prof.numpy(), oracle.summary_profile(x),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tprops.node_contribution(xt, prof).numpy(),
                               oracle.node_contribution(x), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tprops.weighted_degree(nt).numpy(),
                               oracle.weighted_degree(net), rtol=0,
                               atol=1e-12)
    assert tprops.avg_edge_weight(nt) == pytest.approx(
        oracle.avg_edge_weight(net), abs=1e-12)
    assert np.isnan(tprops.avg_edge_weight(nt[:1, :1]))
