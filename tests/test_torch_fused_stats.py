"""The port's fused-statistics entry points on the CPU (their plain
versions) against the JAX package's Pallas kernel in interpret mode — the
JAX package's own CPU path — on the same numpy inputs.

Tolerance: 1e-5 absolute (float32 sums in different orders; the Pallas
interpreter computes the gram-matrix power iteration, as the plain version
does). The counts are checked EXACTLY against the port's own values."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from netrep_tpu.ops import fused_stats as jfused  # noqa: E402
from netrep_tpu.ops import stats as J  # noqa: E402
from netrep_tpu_torch.ops import fused_stats as tfused  # noqa: E402
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402
from netrep_tpu_torch.ops import stats as T  # noqa: E402

ATOL = 1e-5
N, S, CAP, K, B, N_ITER = 96, 16, 24, 2, 6, 10


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((S, N)).astype(np.float32)
    tc = np.corrcoef(x, rowvar=False).astype(np.float32)
    np.fill_diagonal(tc, 1.0)
    mask = np.zeros((K, CAP), np.float32)
    didx = np.zeros((K, CAP), np.int32)
    for k, sz in enumerate((24, 17)):  # one padded-tail module
        mask[k, :sz] = 1
        didx[k, :sz] = rng.choice(N, sz, replace=False)
    sub = np.stack([tc[d[:, None], d[None, :]] for d in didx])
    data = np.stack([x[:, d] for d in didx])
    dj = J.make_disc_props(sub, J.derived_net(sub, 2.0), data, mask)
    dt = T.make_disc_props(torch.as_tensor(sub),
                           T.derived_net(torch.as_tensor(sub), 2.0),
                           torch.as_tensor(data), torch.as_tensor(mask))
    return dict(
        tc=tc, tn=(np.abs(tc) ** 2).astype(np.float32), tdT=x.T.copy(),
        dj=dj, dt=dt,
        idx=rng.integers(0, N, size=(B, K, CAP)).astype(np.int32),
        obs=(rng.standard_normal((K, 7)) * 0.05).astype(np.float32),
        pvalid=np.array([1] * (B - 2) + [0] * 2, np.int32),
    )


def _operands(case, net, with_data, side):
    arr = jnp.asarray if side == "jax" else torch.as_tensor
    tn = arr(case["tn"]) if net == "stored" else None
    tdT = arr(case["tdT"]) if with_data else None
    return arr(case["tc"]), tn, tdT, (None if net == "stored" else 2.0)


@pytest.mark.parametrize("net", ("stored", "derived"))
@pytest.mark.parametrize("with_data", (True, False))
def test_values_match_pallas_interpret(case, net, with_data):
    tc_j, tn_j, td_j, beta = _operands(case, net, with_data, "jax")
    want = np.asarray(jax.jit(lambda ix: jfused.fused_stats_values(
        tc_j, tn_j, td_j, case["dj"], ix, net_beta=beta, n_iter=N_ITER,
        interpret=True,
    ))(jnp.asarray(case["idx"])))
    tc_t, tn_t, td_t, _ = _operands(case, net, with_data, "torch")
    before = tfused.fused_stats_values.launches
    got = tfused.fused_stats_values(
        tc_t, tn_t, td_t, case["dt"], torch.as_tensor(case["idx"]),
        net_beta=beta, n_iter=N_ITER,
    ).numpy()
    # the CPU route is the plain version: no kernel launch is counted
    assert tfused.fused_stats_values.launches == before
    assert got.shape == (B, K, 7) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, equal_nan=True)
    if not with_data:
        assert np.isnan(got[..., [1, 4, 5, 6]]).all()
        assert np.isfinite(got[..., [0, 2, 3]]).all()


@pytest.mark.parametrize("net", ("stored", "derived"))
def test_counts_match_pallas_and_own_values(case, net):
    tc_j, tn_j, td_j, beta = _operands(case, net, True, "jax")
    jv, jhi, jlo, jeff = jax.jit(lambda ix: jfused.fused_stats_counts(
        tc_j, tn_j, td_j, case["dj"], ix, jnp.asarray(case["pvalid"]),
        jnp.asarray(case["obs"]), net_beta=beta, n_iter=N_ITER,
        interpret=True,
    ))(jnp.asarray(case["idx"]))
    tc_t, tn_t, td_t, _ = _operands(case, net, True, "torch")
    v, hi, lo, eff = tfused.fused_stats_counts(
        tc_t, tn_t, td_t, case["dt"], torch.as_tensor(case["idx"]),
        torch.as_tensor(case["pvalid"]), torch.as_tensor(case["obs"]),
        net_beta=beta, n_iter=N_ITER,
    )
    assert hi.dtype == torch.int32 and hi.shape == (K, 7)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
    # the tallies are the exceedance counts of the port's OWN values over
    # the valid permutations, bit for bit
    vals = v.numpy()[case["pvalid"] > 0]
    want = tpv.tail_counts(case["obs"], vals)
    for got_t, want_t in zip((hi, lo, eff), want):
        np.testing.assert_array_equal(got_t.numpy(), want_t)
    # and, on this fixture, equal to the Pallas kernel's
    for got_t, j in zip((hi, lo, eff), (jhi, jlo, jeff)):
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(j))


def test_values_and_counts_share_values(case):
    tc_t, tn_t, td_t, beta = _operands(case, "stored", True, "torch")
    idx = torch.as_tensor(case["idx"])
    v1 = tfused.fused_stats_values(tc_t, tn_t, td_t, case["dt"], idx,
                                   n_iter=N_ITER)
    v2, *_ = tfused.fused_stats_counts(
        tc_t, tn_t, td_t, case["dt"], idx, torch.as_tensor(case["pvalid"]),
        torch.as_tensor(case["obs"]), n_iter=N_ITER)
    assert torch.equal(v1, v2)


def test_smem_budget_guard(case):
    assert tfused.resolve_smem_bytes(224, 128, True) < tfused.SMEM_LIMIT
    assert tfused.resolve_smem_bytes(224, 2000, False) < tfused.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        tfused.resolve_smem_bytes(224, 300, True)
    # the wrapper refuses the shape on the CPU too: a configuration the
    # card cannot run is never computed anywhere
    tdT = torch.zeros((N, 3000))  # 24 x 3000 floats: 288 KB
    with pytest.raises(ValueError, match="shared memory"):
        tfused.fused_stats_values(
            torch.as_tensor(case["tc"]), None, tdT, case["dt"],
            torch.as_tensor(case["idx"]), net_beta=2.0)


def test_derived_mode_needs_beta(case):
    with pytest.raises(ValueError, match="net_beta"):
        tfused.fused_stats_values(
            torch.as_tensor(case["tc"]), None, None, case["dt"],
            torch.as_tensor(case["idx"]))


def test_unsupported_device_raises(case):
    tc = torch.empty((N, N), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.fused_stats_values(tc, None, None, case["dt"],
                                  torch.as_tensor(case["idx"]), net_beta=2.0)


def test_reset_launches():
    tfused.fused_stats_counts.launches = 5
    tfused.reset_launches()
    assert all(fn.launches == 0 for fn in tfused.KERNELS)
