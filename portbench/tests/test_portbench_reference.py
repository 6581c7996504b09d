"""The reference's pieces: the frozen draw against the port's, the seven
statistics against the port's float64 oracle, the sign intervals and the
tie band of the comparison."""

import numpy as np
import pytest
import torch

from portbench.reference import check, netstats, threefry
from portbench.reference.netstats import Precision


@pytest.mark.parametrize("n", [40, 1700, 20000])
@pytest.mark.parametrize("seed", [0, 2**31 + 5, 4294967295])
def test_frozen_draw_equals_the_port(n, seed):
    from netrep_tpu_torch import random as trandom

    keys = trandom.perm_keys(trandom.key(seed, device="cpu"), 3, 4)
    want = trandom.permutation(keys, torch.arange(n))
    assert torch.equal(threefry.draw(seed, range(3, 7), n, "cpu"), want)


def test_statistics_equal_the_float64_oracle():
    from netrep_tpu_torch.ops import oracle

    rng = np.random.default_rng(3)
    s, m = 24, 17
    x = rng.standard_normal((s, 60))
    x[:, :m] += rng.standard_normal((s, 1))
    c = np.corrcoef(x, rowvar=False)
    net = np.abs(c) ** 2
    d_idx, t_idx = np.arange(m), np.arange(m) + 20
    want = oracle.module_stats_for_indices(c, net, x, c, net, x, [d_idx], [t_idx])[0]
    prec = Precision("float64")
    disc = netstats.discovery(torch.as_tensor(c[np.ix_(d_idx, d_idx)]),
                              torch.as_tensor(net[np.ix_(d_idx, d_idx)]),
                              torch.as_tensor(x[:, d_idx]), prec)
    got, half = netstats.module_stats(
        disc, torch.as_tensor(c[np.ix_(t_idx, t_idx)])[None],
        torch.as_tensor(net[np.ix_(t_idx, t_idx)])[None],
        torch.as_tensor(x[:, t_idx])[None], prec, "eigh", 0)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-12)
    assert not half.any()


def test_signs_within_tolerance_of_zero_widen_to_an_interval():
    disc = torch.tensor([[0.5, -0.3, 0.5 * netstats.SIGN_TOL]], dtype=torch.float64)
    vals = torch.tensor([[0.2, 0.4, -0.6]], dtype=torch.float64)
    mean, half = netstats._signed_mean(disc, vals)
    assert mean.item() == pytest.approx((0.2 - 0.4) / 3)
    assert half.item() == pytest.approx(0.6 / 3)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0], dtype=torch.float32)
    got = netstats._tf32_round(x)
    assert got.tolist() == [1.0, 1.0 + 2**-10, -3.0]


def test_count_band_takes_ties_either_way(monkeypatch):
    obs = (np.array([[0.5] * 7]), np.zeros((1, 7)))
    rows = np.array([0.5, 0.5 + 1e-8, 0.6, 0.4])[:, None, None] * np.ones((1, 1, 7))

    class Fake:
        modules = [np.arange(2)]

    monkeypatch.setattr(check, "null_rows", lambda *a, **k: (rows, np.zeros_like(rows)))
    c = check.recount(Fake(), 1, 4, obs, [0], Precision("float64"))
    assert c["surely"][0, 0] == 1 and c["possibly"][0, 0] == 3 and c["eff"][0, 0] == 4
