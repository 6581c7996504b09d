"""Every ported statistic against its ``netrep_tpu.ops.stats`` counterpart
on the same numpy inputs.

Tolerance: 1e-5 absolute. Both sides compute in float32; the two
frameworks sum in different orders, which moves results by a few ULPs
(~1e-7 relative), and the power iteration and LAPACK ``eigh`` (used on both
sides) pass that through unamplified. Two-node modules are excluded from
value parity: their node contributions are equal in exact arithmetic, so
``cor.contrib`` is 0/0 and rounding alone picks ±1 or NaN (their NaN
pattern is checked instead)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from netrep_tpu.ops import stats as J  # noqa: E402
from netrep_tpu_torch.ops import stats as T  # noqa: E402

ATOL = 1e-5
N, S, CAP, K, B = 60, 12, 16, 3, 4
SIZES = (16, 11, 5)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=atol, equal_nan=True)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((S, N)).astype(np.float32)
    tc = np.corrcoef(x, rowvar=False).astype(np.float32)
    mask = np.zeros((K, CAP), np.float32)
    didx = np.zeros((K, CAP), np.int32)
    for k, sz in enumerate(SIZES):
        mask[k, :sz] = 1
        didx[k, :sz] = rng.choice(N, sz, replace=False)
    return dict(
        x=x, tc=tc, tn=(np.abs(tc) ** 2).astype(np.float32), mask=mask,
        didx=didx, idx=rng.integers(0, N, size=(B, K, CAP)).astype(np.int32),
        data=np.stack([x[:, d] for d in didx]),        # (K, S, CAP)
        v=rng.standard_normal((K, CAP)).astype(np.float32),
    )


def _disc(inp, with_data, side):
    lib = J if side == "jax" else T
    arr = jnp.asarray if side == "jax" else torch.as_tensor
    sub = np.stack([inp["tc"][d[:, None], d[None, :]] for d in inp["didx"]])
    return lib.make_disc_props(
        arr(sub), lib.derived_net(arr(sub), 2.0),
        arr(inp["data"]) if with_data else None, arr(inp["mask"]),
    )


def test_masked_mean_and_pearson(inputs):
    w, v = inputs["mask"], inputs["v"]
    y = v[::-1].copy()
    close(T.masked_mean(torch.as_tensor(v), torch.as_tensor(w), dim=-1),
          J.masked_mean(v, w, axis=-1))
    close(T.masked_pearson(torch.as_tensor(v), torch.as_tensor(y),
                           torch.as_tensor(w)),
          J.masked_pearson(v, y, w))
    # degenerate side: constant x -> NaN on both
    const = np.ones_like(v)
    got = T.masked_pearson(torch.as_tensor(const), torch.as_tensor(y),
                           torch.as_tensor(w))
    assert torch.isnan(got).all()
    assert np.isnan(np.asarray(J.masked_pearson(const, y, w))).all()


def test_offdiag_standardize_degree(inputs):
    w = inputs["mask"]
    close(T.offdiag_mask(torch.as_tensor(w)), J.offdiag_mask(w), atol=0)
    data = inputs["data"].copy()
    data[1, :, 2] = 3.0  # a zero-variance column becomes all-zero
    z = T.standardize_masked(torch.as_tensor(data), torch.as_tensor(w))
    close(z, J.standardize_masked(data, w))
    assert float(z[1, :, 2].abs().max()) == 0.0
    net = np.stack([inputs["tn"][d[:, None], d[None, :]]
                    for d in inputs["didx"]])
    close(T.weighted_degree_masked(torch.as_tensor(net), torch.as_tensor(w)),
          J.weighted_degree_masked(net, w))


@pytest.mark.parametrize("method", ("power", "eigh"))
def test_summary_profile_and_contribution(inputs, method):
    w = inputs["mask"]
    zj = J.standardize_masked(inputs["data"], w)
    zt = T.standardize_masked(torch.as_tensor(inputs["data"]),
                              torch.as_tensor(w))
    pj = J.summary_profile_masked(zj, w, n_iter=25, method=method)
    pt = T.summary_profile_masked(zt, torch.as_tensor(w), n_iter=25,
                                  method=method)
    close(pt, pj)
    close(T.node_contribution_masked(zt, pt, torch.as_tensor(w)),
          J.node_contribution_masked(zj, pj, w))
    with pytest.raises(ValueError, match="unknown summary method"):
        T.summary_profile_masked(zt, torch.as_tensor(w), method="svd")


@pytest.mark.parametrize("with_data", (True, False))
def test_make_disc_props(inputs, with_data):
    dj, dt = _disc(inputs, with_data, "jax"), _disc(inputs, with_data, "torch")
    assert dt._fields == dj._fields
    for a, b in zip(dt, dj):
        close(a, b)
    if not with_data:
        assert float(dt.contrib.abs().max()) == 0.0


@pytest.mark.parametrize("net", ("stored", "derived"))
@pytest.mark.parametrize("with_data", (True, False))
@pytest.mark.parametrize("method", ("power", "eigh"))
def test_gather_and_stats(inputs, net, with_data, method):
    dj, dt = _disc(inputs, True, "jax"), _disc(inputs, True, "torch")
    tn = inputs["tn"] if net == "stored" else None
    beta = None if net == "stored" else 2.0
    tdT = inputs["x"].T.copy() if with_data else None

    def one(d, i):
        return J.gather_and_stats(
            d, i, jnp.asarray(inputs["tc"]),
            None if tn is None else jnp.asarray(tn),
            None if tdT is None else jnp.asarray(tdT),
            n_iter=30, summary_method=method, net_beta=beta,
        )

    want = np.asarray(
        jax.vmap(jax.vmap(one), in_axes=(None, 0))(dj, inputs["idx"])
    )
    got = T.gather_and_stats(
        dt, torch.as_tensor(inputs["idx"]), torch.as_tensor(inputs["tc"]),
        None if tn is None else torch.as_tensor(tn),
        None if tdT is None else torch.as_tensor(tdT),
        n_iter=30, summary_method=method, net_beta=beta,
    ).numpy()
    assert got.shape == (B, K, 7)
    close(got, want)
    if not with_data:
        assert np.isnan(got[..., [1, 4, 5, 6]]).all()
        assert np.isfinite(got[..., [0, 2, 3]]).all()


def test_module_stats_and_parts(inputs):
    dj, dt = _disc(inputs, True, "jax"), _disc(inputs, True, "torch")
    sub_c = np.stack([inputs["tc"][d[:, None], d[None, :]]
                      for d in inputs["didx"]])
    sub_n = np.abs(sub_c) ** 2
    z = J.standardize_masked(inputs["data"], inputs["mask"])
    want = J.module_stats_masked(dj, sub_c, sub_n, z, n_iter=20)
    got = T.module_stats_masked(dt, torch.as_tensor(sub_c),
                                torch.as_tensor(sub_n),
                                torch.as_tensor(np.array(z)), n_iter=20)
    close(got, want)
    # the observed modules against their own discovery side are perfectly
    # preserved: cor.cor == 1 exactly up to rounding
    close(got[:, 2], np.ones(K))
    # data-less parts
    pair = np.asarray(J.offdiag_mask(inputs["mask"]))
    aw = (sub_n * pair).sum((-1, -2)) / pair.sum((-1, -2))
    deg = (sub_n * pair).sum(-1)
    want_p = J.stats_from_parts(dj, aw, deg, sub_c * pair, None)
    got_p = T.stats_from_parts(dt, torch.as_tensor(aw),
                               torch.as_tensor(deg),
                               torch.as_tensor(sub_c * pair), None)
    close(got_p, want_p)


def test_two_node_module_nan_pattern(inputs):
    # a 2-node module: cor.cor and cor.degree compare two equal values
    # (NaN on both sides); cor.contrib is rounding-decided, so only its
    # presence is checked
    rng = np.random.default_rng(3)
    mask = np.zeros((1, 8), np.float32)
    mask[0, :2] = 1
    didx = np.zeros((1, 8), np.int32)
    didx[0, :2] = (3, 9)
    x, tc = inputs["x"], inputs["tc"]
    sub = tc[didx[0][:, None], didx[0][None, :]][None]
    data = x[:, didx[0]][None]
    dj = J.make_disc_props(sub, np.abs(sub) ** 2, data, mask)
    dt = T.make_disc_props(torch.as_tensor(sub),
                           torch.as_tensor(np.abs(sub) ** 2),
                           torch.as_tensor(data), torch.as_tensor(mask))
    idx = rng.integers(0, N, size=(1, 8)).astype(np.int32)
    want = np.asarray(J.gather_and_stats(
        jax.tree_util.tree_map(lambda a: a[0], dj), idx[0], tc,
        inputs["tn"], x.T.copy(), n_iter=10))
    got = T.gather_and_stats(dt, torch.as_tensor(idx), torch.as_tensor(tc),
                             torch.as_tensor(inputs["tn"]),
                             torch.as_tensor(x.T.copy()), n_iter=10)[0]
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got[[2, 3]]), np.isnan(want[[2, 3]]))
    assert np.isnan(got[[2, 3]]).all()
    close(got[[0, 1, 5, 6]], want[[0, 1, 5, 6]])


@pytest.mark.parametrize("kind", ("unsigned", "signed", "signed-hybrid"))
def test_derived_net_kinds(inputs, kind):
    c = inputs["tc"][:10, :10]
    close(T.derived_net(torch.as_tensor(c), (2.5, kind)),
          J.derived_net(jnp.asarray(c), (2.5, kind)))


def test_normalize_net_beta_errors():
    assert T.normalize_net_beta(3) == (3.0, "unsigned")
    assert T.normalize_net_beta((2, "signed")) == (2.0, "signed")
    for bad, msg in (((1, 2, 3), "3-tuple"), ((2, "weird"), "kind"),
                     ("x", "numeric")):
        with pytest.raises(ValueError, match=msg):
            T.normalize_net_beta(bad)


def test_gather_zdata(inputs):
    tdT = inputs["x"].T.copy()
    idx = inputs["idx"][0]
    close(T.gather_zdata(torch.as_tensor(tdT), torch.as_tensor(idx),
                         torch.as_tensor(inputs["mask"])),
          J.gather_zdata(jnp.asarray(tdT), jnp.asarray(idx),
                         jnp.asarray(inputs["mask"])))
