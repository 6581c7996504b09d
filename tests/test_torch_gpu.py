"""The port's CUDA kernel on the card: held against its plain version on the
same CUDA tensors. Skips without a card. This file imports nothing of JAX,
so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance kernel vs plain: 1e-4 absolute. The kernel runs the power
iteration as ``v <- Z^T (Z v)`` and sums in its own fixed order; the plain
version forms the Gram matrix (``csrc/fused_stats.cu`` notes).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from netrep_tpu_torch.data import make_example_pair, pair_frames  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.ops import fused_stats as tfused  # noqa: E402
from netrep_tpu_torch.ops import stats as T  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _case(dev, n=400, s=40, cap=64, sizes=(64, 50, 33), B=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, n)).astype(np.float32)
    tc = np.corrcoef(x, rowvar=False).astype(np.float32)
    np.fill_diagonal(tc, 1.0)
    K = len(sizes)
    mask = np.zeros((K, cap), np.float32)
    didx = np.zeros((K, cap), np.int64)
    for k, sz in enumerate(sizes):
        mask[k, :sz] = 1
        didx[k, :sz] = rng.choice(n, sz, replace=False)
    tcd = torch.as_tensor(tc, device=dev)
    xd = torch.as_tensor(x, device=dev)
    di = torch.as_tensor(didx, device=dev)
    sub = T.gather_submatrix(tcd, di)
    disc = T.make_disc_props(sub, sub.abs() ** 2, xd[:, di].permute(1, 0, 2),
                             torch.as_tensor(mask, device=dev))
    return dict(
        tc=tcd, tn=tcd.abs() ** 2, tdT=xd.T.contiguous(), disc=disc,
        idx=torch.as_tensor(rng.integers(0, n, (B, K, cap)).astype(np.int32),
                            device=dev),
        obs=torch.as_tensor((rng.standard_normal((K, 7)) * 0.05)
                            .astype(np.float32), device=dev),
        pvalid=torch.as_tensor(np.r_[np.ones(B - 3), np.zeros(3)]
                               .astype(np.int32), device=dev),
    )


@pytest.mark.parametrize("net", ("stored", "derived"))
@pytest.mark.parametrize("with_data", (True, False))
def test_kernel_matches_plain(cuda, net, with_data):
    c = _case(cuda)
    tn = c["tn"] if net == "stored" else None
    beta = None if net == "stored" else 2.0
    tdT = c["tdT"] if with_data else None
    before = tfused.fused_stats_values.launches
    got = tfused.fused_stats_values(c["tc"], tn, tdT, c["disc"], c["idx"],
                                    net_beta=beta)
    assert tfused.fused_stats_values.launches == before + 1
    want = tfused.fused_stats_values_plain(c["tc"], tn, tdT, c["disc"],
                                           c["idx"], net_beta=beta)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    err = torch.nan_to_num((got - want).abs(), nan=0.0).max().item()
    assert err <= TOL, err


def test_kernel_counts_are_its_own_values(cuda):
    c = _case(cuda)
    v, hi, lo, eff = tfused.fused_stats_counts(
        c["tc"], c["tn"], c["tdT"], c["disc"], c["idx"], c["pvalid"],
        c["obs"])
    sel = (c["pvalid"] > 0)[:, None, None]
    ob = c["obs"][None]
    assert torch.equal(hi, ((v >= ob) & sel).sum(0, dtype=torch.int32))
    assert torch.equal(lo, ((v <= ob) & sel).sum(0, dtype=torch.int32))
    assert torch.equal(eff, ((~torch.isnan(v)) & sel).sum(0,
                                                          dtype=torch.int32))


def test_kernel_wrapper_refuses_bad_operands(cuda):
    c = _case(cuda)
    with pytest.raises(ValueError, match="dtype"):
        tfused.fused_stats_values(c["tc"], c["tn"], c["tdT"], c["disc"],
                                  c["idx"].long())
    with pytest.raises(ValueError, match="contiguous"):
        tfused.fused_stats_values(c["tc"], c["tn"], c["tdT"].T.contiguous().T,
                                  c["disc"], c["idx"])


def test_module_preservation_cuda_matches_cpu(cuda):
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    kw = dict(network={"d": d["network"], "t": t["network"]},
              data={"d": d["data"], "t": t["data"]},
              correlation={"d": d["correlation"], "t": t["correlation"]},
              module_assignments=pair["labels"], n_perm=300, seed=4)
    tfused.reset_launches()
    gpu = module_preservation(**kw)
    assert tfused.fused_stats_values.launches > 0
    cpu = module_preservation(**kw, device="cpu")
    np.testing.assert_allclose(gpu.observed, cpu.observed, rtol=0, atol=TOL)
    np.testing.assert_array_equal(gpu.p_values, cpu.p_values)
