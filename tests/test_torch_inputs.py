"""The port's input checks (``build_datasets``, ``device="cpu"``) against
the JAX package's on the same inputs: the matrices are walked in tile
pairs (a small tile side is patched in, so tile edges and diagonal tiles
are hit), and every decision and message must equal the JAX package's,
including ``np.allclose``'s asymmetric tolerance at its edges, the order
of the errors, and the range check on the float64 values. The float32
matrices that come out equal the narrowing of the whole float64 matrix
bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

from netrep_tpu.models import dataset as jds  # noqa: E402
from netrep_tpu_torch.models import dataset as tds  # noqa: E402

N = 23
ATOL, RTOL = 1e-8, 1e-5


def _mats(seed=0, n=N, s=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, n))
    c = np.corrcoef(x, rowvar=False)
    np.fill_diagonal(c, 1.0)
    return x, c, np.abs(c) ** 2


def _outcome(fn):
    try:
        return fn(), None
    except ValueError as e:
        return None, str(e)


def _both(network, correlation, data=None, tile=5, monkeypatch=None):
    """(port datasets or None, port error, JAX error) for one input."""
    monkeypatch.setattr(tds, "TILE", tile)
    got, terr = _outcome(lambda: tds.build_datasets(
        network, data=data, correlation=correlation, device="cpu"))
    _, jerr = _outcome(lambda: jds.build_datasets(
        network, data=data, correlation=correlation))
    return got, terr, jerr


def _narrowed(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64)
                            .astype(np.float32))


@pytest.mark.parametrize("tile", [4, 5, 7, N, 64])
def test_tile_walk_bit_equal_to_whole_narrowing(monkeypatch, tile):
    x, c, net = _mats()
    got, terr, jerr = _both({"a": net}, {"a": c}, {"a": x}, tile,
                            monkeypatch)
    assert terr is None and jerr is None
    d = got["a"]
    assert torch.equal(d.network, _narrowed(net))
    assert torch.equal(d.correlation, _narrowed(c))
    assert torch.equal(d.data, _narrowed(x))
    assert d.network.dtype == torch.float32


@pytest.mark.parametrize("kind", ["float32", "fortran", "fortran32",
                                  "readonly", "frame", "tensor", "int",
                                  "list", "strided"])
def test_every_input_kind(monkeypatch, kind):
    x, c, net = _mats(1)
    names = [f"g{i}" for i in range(N)]

    def conv(a):
        if kind == "float32":
            return a.astype(np.float32)
        if kind == "fortran":
            return np.asfortranarray(a)
        if kind == "fortran32":
            return np.asfortranarray(a.astype(np.float32))
        if kind == "readonly":
            a = a.copy()
            a.flags.writeable = False
            return a
        if kind == "frame":
            return pd.DataFrame(a, index=names[: a.shape[0]] if a.shape[0]
                                == N else None, columns=names)
        if kind == "tensor":
            return torch.from_numpy(a.copy())
        if kind == "int":
            return np.round(a * 4).astype(np.int64)
        if kind == "list":
            return a.tolist()
        # a strided view: every other row and column of a larger matrix
        big = np.zeros((2 * a.shape[0], 2 * a.shape[1]))
        big[::2, ::2] = a
        return big[::2, ::2]

    if kind == "int":  # an integer correlation must stay in [-1, 1]
        c = np.eye(N)
    got, terr, jerr = _both({"a": conv(net)}, {"a": conv(c)},
                            {"a": conv(x)}, 5, monkeypatch)
    assert terr == jerr
    if jerr is None:
        want = jds.build_datasets({"a": conv(net)}, data={"a": conv(x)},
                                  correlation={"a": conv(c)})["a"]
        d = got["a"]
        assert torch.equal(d.network, _narrowed(want.network))
        assert torch.equal(d.correlation, _narrowed(want.correlation))
        assert torch.equal(d.data, _narrowed(want.data))
        assert d.node_names == want.node_names


def _place(m, i, j, hi):
    """``m`` with ``m[i, j] = hi`` and ``m[j, i] = 1`` (a unit entry and
    its mirror)."""
    m = m.copy()
    m[i, j], m[j, i] = hi, 1.0
    return m


#: np.isclose(1 + d, 1) holds while d <= ATOL + RTOL; its mirror,
#: isclose(1, 1 + d), while d <= ATOL + RTOL * (1 + d)
EDGE = ATOL + RTOL
CASES = {
    "below_both": (EDGE * (1 - 1e-6), None),
    "above_both": (EDGE / (1 - RTOL) * (1 + 1e-6), "not symmetric"),
    # fails at (i, j) only: the entry's own mirror passes
    "one_orientation": (EDGE * (1 + 1e-6), "not symmetric"),
}


@pytest.mark.parametrize("where", [(2, 17), (17, 2), (1, 3), (3, 1)],
                         ids=["upper", "lower", "diag_tile_upper",
                              "diag_tile_lower"])
@pytest.mark.parametrize("case", list(CASES))
def test_symmetry_tolerance_edges(monkeypatch, case, where):
    _x, c, net = _mats(2)
    delta, expect = CASES[case]
    bad = _place(net, *where, 1.0 + delta)
    got, terr, jerr = _both({"a": bad}, {"a": c}, None, 5, monkeypatch)
    assert jerr == (None if expect is None else
                    "network for dataset 'a' is not symmetric")
    assert terr == jerr


def test_one_orientation_case_is_one_sided():
    # the "one_orientation" entry really passes in one direction and
    # fails in the other under numpy's own isclose
    hi = 1.0 + CASES["one_orientation"][0]
    assert not np.isclose(hi, 1.0, rtol=RTOL, atol=ATOL)
    assert np.isclose(1.0, hi, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_non_finite_wins_over_asymmetry(monkeypatch, bad):
    # the asymmetry lies in the first tile pair, the non-finite entry in
    # the last: the JAX package reports the non-finite one
    _x, c, net = _mats(3)
    m = _place(net, 0, 1, 1.5)
    m[N - 1, N - 2] = bad
    got, terr, jerr = _both({"a": m}, {"a": c}, None, 5, monkeypatch)
    assert jerr == ("network for dataset 'a' contains non-finite values "
                    "(NA/NaN/Inf are not allowed)")
    assert terr == jerr


@pytest.mark.parametrize("offset,fails", [(-1e-9, False), (1e-9, True),
                                          (1e-3, True)])
def test_correlation_range_edge(monkeypatch, offset, fails):
    _x, c, net = _mats(4)
    top = 1 + 1e-6 + offset
    c = c.copy()
    c[5, 12] = c[12, 5] = top
    got, terr, jerr = _both({"a": net}, {"a": c}, None, 5, monkeypatch)
    assert jerr == ("correlation for dataset 'a' has entries outside "
                    "[-1, 1]" if fails else None)
    assert terr == jerr
    if not fails:  # checked on the float64 value, narrowed after
        assert got["a"].correlation[5, 12].item() == np.float32(top)


def _error_cases():
    x, c, net = _mats(5)
    asym = _place(net, 4, 9, 2.0)
    nonfin = c.copy()
    nonfin[7, 7] = np.nan
    return {
        "network_first": dict(network=asym, correlation=nonfin),
        "corr_asym_before_range": dict(network=net,
                                       correlation=_place(c, 3, 8, 1.5)),
        "corr_non_square": dict(network=net, correlation=c[:, :-1]),
        "net_non_square": dict(network=net[:-1], correlation=c),
        "size": dict(network=net, correlation=c[:-2, :-2]),
        "data_non_finite": dict(network=net, correlation=c,
                                data=np.where(x > 2, np.inf, x)),
        "data_columns": dict(network=net, correlation=c, data=x[:, :-1]),
        "ndim": dict(network=net[0], correlation=c),
        "data_ndim": dict(network=net, correlation=c, data=x[0]),
    }


@pytest.mark.parametrize("case", list(_error_cases()))
def test_error_order_matches_jax(monkeypatch, case):
    kw = _error_cases()[case]
    got, terr, jerr = _both(
        {"a": kw["network"]}, {"a": kw["correlation"]},
        None if "data" not in kw else {"a": kw["data"]}, 5, monkeypatch)
    assert jerr is not None
    assert terr == jerr


def test_two_datasets_and_names(monkeypatch):
    x, c, net = _mats(6)
    names = [f"g{i}" for i in range(N)]
    frame = pd.DataFrame(net, index=names, columns=names)
    got, terr, jerr = _both({"a": frame, "b": net.astype(np.float32)},
                            {"a": c, "b": c}, {"b": x}, 6, monkeypatch)
    assert terr is None and jerr is None
    assert got["a"].node_names == names and got["a"].data is None
    assert got["b"].node_names == [f"node_{i}" for i in range(N)]
    assert torch.equal(got["b"].network, _narrowed(net.astype(np.float32)))


def test_place_keeps_cpu_tensors():
    x, c, net = _mats(7)
    got = tds.build_datasets({"a": net, "b": net}, data={"a": x},
                             correlation={"a": c, "b": c}, device="cpu")
    keep = got["a"].network
    tds.place(got, {"a": {"network"}}, {"b": {"correlation"}},
              torch.device("cpu"))
    assert got["a"].network is keep
    assert got["a"].correlation is None and got["a"].data is None
    assert got["b"].correlation is not None and got["b"].network is None
    assert tds.to_host(keep) == (keep, None)
