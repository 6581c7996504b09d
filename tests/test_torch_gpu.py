"""The port's CUDA kernels on the card: held against their plain versions on
the same CUDA tensors. Skips without a card. This file imports nothing of
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances, kernel vs plain: fused statistics 1e-4 absolute (the kernel
sums in its own fixed order and, by shape, iterates on the node-space Gram
matrix, the sample-space one, or streams the data rows each step; the
plain version forms the node-space Gram matrix, ``csrc/fused_stats.cu``
notes) — also on test matrices asymmetric up to the datasets' tolerance,
which the kernel's cached tier reads from one triangle; the gather and the
ring shift none — both are copies, so they are bit-equal (in bfloat16
storage too: the gather and the ring compared as 16-bit words, the fused
statistics at the same 1e-4 with counts equal to their own values). The
sparse path
and the data-only plane launch none of the kernels; their card runs are
held to the CPU run of the same call at the same 1e-4, with counts,
p-values and retirements equal.
"""

import collections
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from netrep_tpu_torch.data import make_example_pair, pair_frames  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch import ops as tops  # noqa: E402
from netrep_tpu_torch.ops import fused_gather as tgather  # noqa: E402
from netrep_tpu_torch.ops import fused_stats as tfused  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402
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
    x[:, :30] += rng.standard_normal((s, 1)).astype(np.float32)
    x[:, 1] = 0.25  # a constant data row: its standardized row is zero
    with np.errstate(invalid="ignore"):
        tc = np.corrcoef(x, rowvar=False).astype(np.float32)
    tc = np.nan_to_num(tc)  # the constant row correlates with nothing
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
    idx = rng.integers(0, n, (B, K, cap)).astype(np.int32)
    idx[:, :, :2] = (1, 2)  # every cell holds the constant row
    return dict(
        tc=tcd, tn=tcd.abs() ** 2, tdT=xd.T.contiguous(), disc=disc,
        idx=torch.as_tensor(idx, device=dev), sizes=sizes,
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


#: one shape per way the kernel runs the power iteration, each with modules
#: of 1 and 2 real nodes beside full and padded ones
TIER_CASES = {
    "node_gram": dict(n=400, s=80, cap=64, sizes=(64, 50, 2, 1)),
    "sample_gram": dict(n=400, s=40, cap=64, sizes=(64, 50, 33, 2, 1)),
    "streamed": dict(n=600, s=512, cap=256, sizes=(256, 201, 2, 1), B=6),
}


def _assert_close_to_plain(got, want, sizes):
    """Kernel values within TOL of the plain version's, NaN patterns equal.
    A two-node module's node contributions are equal in exact arithmetic,
    so its cor.contrib is 0/0 and rounding alone picks +-1 or NaN: that
    entry is left out."""
    keep = torch.ones_like(got, dtype=torch.bool)
    for k, sz in enumerate(sizes):
        if sz == 2:
            keep[:, k, 4] = False
    got, want = got[keep], want[keep]
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    err = torch.nan_to_num((got - want).abs(), nan=0.0).max().item()
    assert err <= TOL, err


@pytest.mark.parametrize("n_iter", (60, 0))
@pytest.mark.parametrize("net", ("stored", "derived"))
@pytest.mark.parametrize("tier", tuple(TIER_CASES))
def test_kernel_tiers_match_plain(cuda, tier, net, n_iter):
    c = _case(cuda, **TIER_CASES[tier])
    cap, s = c["idx"].shape[-1], c["tdT"].shape[-1]
    assert tfused.kernel_tier(cap, s, True) == tier
    tn = c["tn"] if net == "stored" else None
    beta = None if net == "stored" else 2.0
    got = tfused.fused_stats_values(c["tc"], tn, c["tdT"], c["disc"],
                                    c["idx"], net_beta=beta, n_iter=n_iter)
    want = tfused.fused_stats_values_plain(c["tc"], tn, c["tdT"], c["disc"],
                                           c["idx"], net_beta=beta,
                                           n_iter=n_iter)
    torch.cuda.synchronize()
    _assert_close_to_plain(got, want, c["sizes"])
    one = list(c["sizes"]).index(1)
    assert torch.isnan(got[:, one, [2, 3]]).all()  # no pair, no degree


@pytest.mark.parametrize("tier", tuple(TIER_CASES))
def test_kernel_counts_are_its_own_values(cuda, tier):
    c = _case(cuda, **TIER_CASES[tier])
    B = c["idx"].shape[0]
    pvalid = torch.ones(B, dtype=torch.int32, device=cuda)
    pvalid[-2:] = 0
    v, hi, lo, eff = tfused.fused_stats_counts(
        c["tc"], c["tn"], c["tdT"], c["disc"], c["idx"], pvalid, c["obs"])
    sel = (pvalid > 0)[:, None, None]
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
    tops.reset_launches()
    gpu = module_preservation(**kw)
    assert tfused.fused_stats_values.launches > 0
    cpu = module_preservation(**kw, device="cpu")
    np.testing.assert_allclose(gpu.observed, cpu.observed, rtol=0, atol=TOL)
    np.testing.assert_array_equal(gpu.p_values, cpu.p_values)


def _gather_case(dev, batch, n=1000, cap=45, seed=1):
    rng = np.random.default_rng(seed)
    M = torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32),
                        device=dev)
    idx = rng.integers(0, n, size=batch + (cap,)).astype(np.int32)
    flat = idx.reshape(-1, cap)
    flat[0, 3], flat[-1, 7], flat[-1, 0] = -1, n, n + 9
    M[int(flat[0, 5]), int(flat[0, 6])] = float("nan")
    return M, torch.as_tensor(idx, device=dev)


def _bit_equal(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


@pytest.mark.parametrize("batch", [(), (3,), (2, 5)], ids=str)
def test_gather_kernel_bit_equal_to_plain(cuda, batch):
    M, idx = _gather_case(cuda, batch)
    before = tgather.gather_submatrix_fused.launches
    got = tgather.gather_submatrix_fused(M, idx)
    assert tgather.gather_submatrix_fused.launches == before + 1
    want = tgather.gather_submatrix_fused_plain(M, idx)
    torch.cuda.synchronize()
    assert got.shape == batch + (45, 45)
    assert _bit_equal(got, want)
    assert torch.isnan(got).any()


def test_gather_local_blocks_sum_to_replicated(cuda):
    M, idx = _gather_case(cuda, (2, 5))
    total = torch.zeros((2, 5, 45, 45), device=cuda)
    for r0 in (0, 300, 600, 900):
        blk = M[r0: r0 + 300]
        part = tgather.gather_submatrix_fused_local(blk, idx, r0)
        assert _bit_equal(
            part, tgather.gather_submatrix_fused_local_plain(blk, idx, r0))
        total += part
    assert _bit_equal(total, tgather.gather_submatrix_fused(M, idx))


def test_gather_refuses_bad_operands(cuda):
    M, idx = _gather_case(cuda, (2,))
    with pytest.raises(ValueError, match="dtype"):
        tgather.gather_submatrix_fused(M.double(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        tgather.gather_submatrix_fused(M.T, idx)


@pytest.mark.parametrize("options,kernel", [
    (dict(stat_mode="xla"), "gather_submatrix_fused_many"),
    (dict(network_from_correlation=2.0), "fused_stats_values"),
], ids=("composed", "derived"))
def test_engine_options_cuda_match_cpu(cuda, options, kernel):
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    kw = dict(network={"d": d["network"], "t": t["network"]},
              data={"d": d["data"], "t": t["data"]},
              correlation={"d": d["correlation"], "t": t["correlation"]},
              module_assignments=pair["labels"], n_perm=300, seed=4,
              config=EngineConfig(**options))
    tops.reset_launches()
    gpu = module_preservation(**kw)
    assert getattr(tgather if "gather" in kernel else tfused,
                   kernel).launches > 0
    cpu = module_preservation(**kw, device="cpu")
    np.testing.assert_allclose(gpu.observed, cpu.observed, rtol=0, atol=TOL)
    np.testing.assert_allclose(gpu.nulls, cpu.nulls, rtol=0, atol=TOL)
    np.testing.assert_array_equal(gpu.p_values, cpu.p_values)


def _ring_blocks(dev, R=4, rows=250, seed=2):
    rng = np.random.default_rng(seed)
    n = R * rows
    M = torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32),
                        device=dev)
    return M, [M[r * rows: (r + 1) * rows] for r in range(R)]


def test_ring_kernel_bit_equal_to_plain(cuda):
    _M, ring = _ring_blocks(cuda)
    flat = torch.randn(49 * 201 + 1, device=cuda)
    small = [torch.randn(shape, device=cuda)
             for shape in ((1, 1), (1, 3), (7,), (3, 5), (129, 7), (2, 1030))]
    for blocks in (ring, [torch.randn((49, 201), device=cuda)],
                   [flat[1:].view(49, 201), torch.randn((49, 201),
                                                        device=cuda)],
                   small, [flat[1:8], flat[3:4]]):
        before = tfused.ring_shift_dma.launches
        got = tfused.ring_shift_dma(blocks)
        assert tfused.ring_shift_dma.launches == before + len(blocks)
        want = tfused.ring_shift_collective(blocks)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.data_ptr() != w.data_ptr() and torch.equal(g, w)


@pytest.mark.parametrize("rows", [250, 300])
def test_ring_gather_all_equals_gather_kernel(cuda, rows):
    # a square matrix of 4 * rows nodes in 4 blocks of ``rows`` rows, with
    # indices over all of its nodes
    M, ring = _ring_blocks(cuda, rows=rows)
    n = M.shape[0]
    rng = np.random.default_rng(3)
    idx = [[torch.as_tensor(rng.integers(0, n, (5, 3, c)).astype(np.int32),
                            device=cuda) for c in (16, 40)] for _ in ring]
    subs = tfused.ring_gather_all([ring], idx, rows)
    for j, ix in enumerate(idx):
        for b, i in enumerate(ix):
            assert _bit_equal(subs[j][0][b],
                              tgather.gather_submatrix_fused(M, i))


@pytest.mark.parametrize("stat_mode", ["auto", "xla"])
def test_row_sharded_cuda_matches_cpu(cuda, stat_mode):
    from netrep_tpu_torch.parallel.mesh import make_mesh

    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    kw = dict(network={"d": d["network"], "t": t["network"]},
              data={"d": d["data"], "t": t["data"]},
              correlation={"d": d["correlation"], "t": t["correlation"]},
              module_assignments=pair["labels"], n_perm=300, seed=4,
              config=EngineConfig(matrix_sharding="row",
                                  stat_mode=stat_mode))
    tops.reset_launches()
    gpu = module_preservation(**kw, mesh=make_mesh(2, 2, devices=[cuda] * 4))
    assert tgather.gather_submatrix_fused_many.launches > 0
    assert (tfused.ring_shift_dma.launches > 0) == (stat_mode == "auto")
    cpu = module_preservation(**kw, device="cpu", mesh=make_mesh(
        2, 2, devices=[torch.device("cpu")] * 4))
    np.testing.assert_allclose(gpu.observed, cpu.observed, rtol=0, atol=TOL)
    np.testing.assert_allclose(gpu.nulls, cpu.nulls, rtol=0, atol=TOL)
    np.testing.assert_array_equal(gpu.p_values, cpu.p_values)


def _many_case(dev, kind, seed=5):
    """Index lists of several buckets over an n x n matrix, for each way
    the gather kernel reads a source row: ``dense`` (many output rows per
    source row), ``hot_row`` (nearly every slot reads row 3, as padded
    slots read gene 0: the row's list is cut into many items) and
    ``sparse`` (a few output rows per source row of a wide matrix). Each
    has padded slots at gene 0, sentinels, duplicates and a NaN in a row
    that is read."""
    rng = np.random.default_rng(seed)
    n, batches = {"dense": (1000, (200, 150, 100)),
                  "hot_row": (1000, (300, 300, 300)),
                  "sparse": (8000, (2, 3, 1))}[kind]
    M = torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32),
                        device=dev)
    idx_list = []
    for G, cap in zip(batches, (32, 45, 64)):
        idx = rng.integers(0, n, size=(G, cap)).astype(np.int32)
        if kind == "hot_row":
            idx[:, 2:] = 3
        idx[:, cap - 5:] = 0                    # padded slots
        idx[0, 1], idx[-1, 2] = -1, n + 4       # sentinels
        idx[0, 3] = idx[0, 4]                   # a duplicate
        idx_list.append(torch.as_tensor(idx, device=dev))
    r, c = int(idx_list[1][0, 5]), int(idx_list[1][0, 6])
    M[r, c] = float("nan")
    return M, idx_list


@pytest.mark.parametrize("stage_div", [0, 3, 1 << 20],
                         ids=("in_place", "default", "staged"))
@pytest.mark.parametrize("kind", ["dense", "hot_row", "sparse"])
def test_many_kernel_bit_equal_to_plain(cuda, monkeypatch, kind, stage_div):
    # STAGE_DIV 0 reads every row in place, 1 << 20 stages every row
    monkeypatch.setattr(tgather, "STAGE_DIV", stage_div)
    M, idx_list = _many_case(cuda, kind)
    before = tgather.gather_submatrix_fused_many.launches
    got = tgather.gather_submatrix_fused_many(M, idx_list)
    assert tgather.gather_submatrix_fused_many.launches == before + 1
    want = tgather.gather_submatrix_fused_many_plain(M, idx_list)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _bit_equal(g, w)
    assert torch.isnan(got[1]).any()
    # the single-bucket entries are the same kernel with one bucket
    assert _bit_equal(tgather.gather_submatrix_fused(M, idx_list[2]), want[2])


@pytest.mark.parametrize("kind", ["dense", "hot_row"])
def test_many_out_row_blocks_assemble_replicated(cuda, kind):
    """One launch per row block into buffers that start as NaN: the
    replicated gather, the rows no block owns zeroed by the block at 0."""
    M, idx_list = _many_case(cuda, kind, seed=6)
    out = [torch.full(ix.shape + ix.shape[-1:], float("nan"), device=cuda)
           for ix in idx_list]
    for r0 in (0, 250, 500, 750):
        tgather.gather_submatrix_fused_many(M[r0: r0 + 250], idx_list, r0,
                                            out=out)
    want = tgather.gather_submatrix_fused_many(M, idx_list)
    torch.cuda.synchronize()
    for o, w in zip(out, want):
        assert _bit_equal(o, w)


def test_many_kernel_rows_wider_than_shared_memory(cuda):
    """A (64, 60,000) row block: no row fits a block's shared memory, so
    every row is read in place — the shape is not refused."""
    rng = np.random.default_rng(8)
    n = 60_000
    block = torch.as_tensor(rng.standard_normal((64, n)).astype(np.float32),
                            device=cuda)
    r0 = 128
    idx = rng.integers(0, n, size=(40, 48)).astype(np.int32)
    idx[:, :20] = rng.integers(r0, r0 + 64, size=(40, 20))
    idx[:, 40:] = r0                             # a hot row of the block
    idx[0, 0], idx[1, 1] = -3, n
    it = torch.as_tensor(idx, device=cuda)
    block[5, int(idx[2, 1])] = float("nan")
    got = tgather.gather_submatrix_fused_local(block, it, r0)
    want = tgather.gather_submatrix_fused_local_plain(block, it, r0)
    out = [torch.full((40, 48, 48), float("nan"), device=cuda)]
    tgather.gather_submatrix_fused_many(block, [it], r0, out=out)
    torch.cuda.synchronize()
    assert _bit_equal(got, want)
    own = ((it >= r0) & (it < r0 + 64))[..., None].expand_as(want)
    assert _bit_equal(torch.where(own, out[0], 0.0),
                      torch.where(own, want, 0.0))
    assert torch.isnan(out[0][~own]).all()      # nothing else is touched


def _asymmetric(c, delta=4.5e-6, seed=11):
    """``c`` times ``1 + delta * S`` with S antisymmetric (+-1): the two
    triangles differ by 2 delta |c| = 9e-6 |c|, just inside the datasets'
    ``np.allclose(a, a.T, rtol=1e-5, atol=1e-8)``."""
    n = c.shape[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    sign = (torch.randint(0, 2, (n, n), generator=g) * 2 - 1).float()
    S = torch.triu(sign, 1)
    S = (S - S.T).to(c.device)
    out = c * (1 + delta * S)
    a = out.cpu().numpy()
    assert np.allclose(a, a.T, rtol=1e-5, atol=1e-8)
    assert not np.array_equal(a, a.T)
    return out


@pytest.mark.parametrize("tier", ["node_gram", "streamed"],
                         ids=("cached", "whole_row"))
def test_one_triangle_read_within_tolerance_on_asymmetry(cuda, tier):
    """The fused kernel reads each unordered pair once, from the upper
    triangle, where its shared-memory cache fits (cap 64 here) and whole
    rows where it does not (cap 256); the plain version reads both
    triangles. On test matrices as asymmetric as the datasets accept, both
    tiers stay within the kernel's tolerance, in values and in counts."""
    c = _case(cuda, **TIER_CASES[tier])
    tc, tn = _asymmetric(c["tc"]), _asymmetric(c["tn"], seed=12)
    got = tfused.fused_stats_values(tc, tn, c["tdT"], c["disc"], c["idx"])
    want = tfused.fused_stats_values_plain(tc, tn, c["tdT"], c["disc"],
                                           c["idx"])
    B = c["idx"].shape[0]
    pvalid = torch.ones(B, dtype=torch.int32, device=cuda)
    v, hi, _lo, _eff = tfused.fused_stats_counts(
        tc, tn, c["tdT"], c["disc"], c["idx"], pvalid, c["obs"])
    torch.cuda.synchronize()
    _assert_close_to_plain(got, want, c["sizes"])
    _assert_close_to_plain(v, want, c["sizes"])
    assert torch.equal(hi, (v >= c["obs"][None]).sum(0, dtype=torch.int32))


def _input_mats(n, seed=21):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((30, n))
    c = np.corrcoef(x, rowvar=False)
    np.fill_diagonal(c, 1.0)
    return x, c, np.abs(c) ** 2


@pytest.mark.parametrize("kind", ["host64", "host32_fortran", "host_readonly",
                                  "card32", "card64"])
@pytest.mark.parametrize("tile", [64, 2048])
def test_tile_walk_on_card_bit_equal(cuda, monkeypatch, kind, tile):
    """The input walk on the card (pinned staging for host inputs, in
    place for card tensors) narrows bit-equal to the CPU walk and to the
    whole matrix's narrowing, at a tile side with edges and one larger
    than the matrix."""
    from netrep_tpu_torch.models import dataset as tds

    monkeypatch.setattr(tds, "TILE", tile)
    x, c, net = _input_mats(1000)

    def conv(a):
        if kind == "host32_fortran":
            return np.asfortranarray(a.astype(np.float32))
        if kind == "host_readonly":
            a = a.copy()
            a.flags.writeable = False
            return a
        if kind.startswith("card"):
            dt = torch.float32 if kind == "card32" else torch.float64
            return torch.as_tensor(a, dtype=dt, device=cuda)
        return a

    got = tds.build_datasets({"a": conv(net)}, data={"a": conv(x)},
                             correlation={"a": conv(c)})["a"]
    cpu = tds.build_datasets({"a": conv(net) if not kind.startswith("card")
                              else conv(net).cpu()},
                             data={"a": conv(x) if not kind.startswith("card")
                                   else conv(x).cpu()},
                             correlation={"a": conv(c) if not kind.startswith(
                                 "card") else conv(c).cpu()},
                             device="cpu")["a"]
    for f in ("network", "correlation", "data"):
        t = getattr(got, f)
        assert t.is_cuda and t.dtype == torch.float32
        assert torch.equal(t.cpu(), getattr(cpu, f)), f
        src = {"network": net, "correlation": c, "data": x}[f]
        if kind == "host32_fortran" or kind == "card32":
            src = src.astype(np.float32)
        assert torch.equal(t.cpu(), torch.from_numpy(
            src.astype(np.float64).astype(np.float32))), f


@pytest.mark.parametrize("fault", ["asymmetric", "one_orientation",
                                   "non_finite_late", "range"])
def test_tile_walk_on_card_decides_as_cpu(cuda, monkeypatch, fault):
    from netrep_tpu_torch.models import dataset as tds

    monkeypatch.setattr(tds, "TILE", 64)
    _x, c, net = _input_mats(300, seed=22)
    net, c = net.copy(), c.copy()
    if fault == "asymmetric":
        net[10, 250] += 1e-3
    elif fault == "one_orientation":
        # fails at (250, 10) only: (1e-8 + 1e-5) * (1 + 1e-6) above 1
        net[250, 10], net[10, 250] = 1.0 + 1.001001e-5, 1.0
    elif fault == "non_finite_late":
        net[0, 1] += 0.5
        net[299, 298] = np.nan
    else:
        c[5, 200] = c[200, 5] = 1 + 2e-6
    errs = []
    for device in (None, "cpu"):
        with pytest.raises(ValueError) as e:
            tds.build_datasets({"a": net}, correlation={"a": c},
                               device=device)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_tile_walk_holds_no_float64_matrix(cuda, monkeypatch):
    """The walk's peak above the float32 matrices it returns is a few
    tiles, not a float64 copy of a matrix."""
    from netrep_tpu_torch.models import dataset as tds

    monkeypatch.setattr(tds, "TILE", 512)
    n = 6000
    _x, c, net = _input_mats(n, seed=23)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = tds.build_datasets({"a": net}, correlation={"a": c})["a"]
    outputs = 2 * n * n * 4
    extra = torch.cuda.max_memory_allocated() - base - outputs
    assert extra <= 16 * 512 * 512 * 8, extra
    assert got.network.shape == (n, n)


def test_place_round_trip_through_pinned_memory(cuda):
    from netrep_tpu_torch.models import dataset as tds

    _x, c, net = _input_mats(800, seed=24)
    ds = tds.build_datasets({"a": net, "b": net}, correlation={"a": c,
                                                               "b": c})
    want = ds["b"].correlation.clone()
    tds.place(ds, {"a": {"correlation"}}, {"b": {"correlation"}}, cuda)
    host = ds["b"].correlation
    assert host.device.type == "cpu" and host.is_pinned()
    assert "correlation" in ds["b"].copies
    tds.place(ds, {"b": {"correlation"}}, {}, cuda)
    back = ds["b"].correlation
    assert back.is_cuda and torch.equal(back, want)
    assert ds["a"].correlation is None and not ds["b"].copies


def test_network_properties_cuda_matches_cpu(cuda):
    from netrep_tpu_torch.models.properties import network_properties

    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    kw = dict(network={"d": d["network"], "t": t["network"]},
              data={"d": d["data"], "t": t["data"]},
              correlation={"d": d["correlation"], "t": t["correlation"]},
              module_assignments=pair["labels"], discovery="d",
              test=["d", "t"])
    gpu = network_properties(**kw)
    cpu = network_properties(**kw, device="cpu")
    for test in ("d", "t"):
        for lab, want in cpu[test].items():
            got = gpu[test][lab]
            assert got["node_names"] == want["node_names"]
            for key in ("degree", "summary", "contribution"):
                np.testing.assert_allclose(got[key], want[key], rtol=0,
                                           atol=1e-10)
            for key in ("avg_weight", "coherence"):
                assert got[key] == pytest.approx(want[key], abs=1e-10)


def _example_kw(**extra):
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    return dict(network={"d": d["network"], "t": t["network"]},
                data={"d": d["data"], "t": t["data"]},
                correlation={"d": d["correlation"], "t": t["correlation"]},
                module_assignments=pair["labels"], seed=4, **extra)


@pytest.mark.parametrize("store_nulls", (True, False))
@pytest.mark.parametrize("stat_mode", ("fused", "xla"))
def test_adaptive_cuda_matches_cpu(cuda, store_nulls, stat_mode):
    """The adaptive null on the card, through the kernels on re-bucketed
    buckets, retires the modules the CPU run retires, with its counts and
    p-values."""
    kw = _example_kw(n_perm=2000, adaptive=True, store_nulls=store_nulls,
                     config=EngineConfig(stat_mode=stat_mode))
    tops.reset_launches()
    gpu = module_preservation(**kw)
    launched = {fn.__name__: fn.launches for fn in tops.kernels()}
    kernel = ("gather_submatrix_fused_many" if stat_mode == "xla"
              else "fused_stats_values" if store_nulls
              else "fused_stats_counts")
    assert launched[kernel] > 0, launched
    cpu = module_preservation(**kw, device="cpu")
    assert gpu.p_type == cpu.p_type == "sequential"
    np.testing.assert_array_equal(gpu.n_perm_used, cpu.n_perm_used)
    np.testing.assert_array_equal(gpu.p_values, cpu.p_values)
    assert gpu.n_perm_used.min() < 2000  # a module retired early
    if store_nulls:
        np.testing.assert_allclose(gpu.nulls, cpu.nulls, rtol=0, atol=TOL)


@pytest.mark.parametrize("store_nulls", (True, False))
def test_checkpoint_resume_cuda_matches_cpu(cuda, tmp_path, store_nulls):
    """Interrupted on the card after two chunks, resumed on the card: the
    uninterrupted card run's null bit for bit; the card's checkpoint also
    resumes on the CPU to the CPU run's p-values."""
    kw = _example_kw(n_perm=500, store_nulls=store_nulls,
                     config=EngineConfig(superchunk=1),
                     checkpoint_every=128)
    calls = []

    def stop(done, total):
        calls.append(done)
        if len(calls) == 2:
            raise KeyboardInterrupt

    card_dir, cpu_dir = tmp_path / "card", tmp_path / "cpu"
    part = module_preservation(**kw, checkpoint_dir=str(card_dir),
                               progress=stop)
    assert part.completed == 256
    import shutil

    shutil.copytree(card_dir, cpu_dir)
    resumed = module_preservation(**kw, checkpoint_dir=str(card_dir))
    whole = module_preservation(**kw)
    np.testing.assert_array_equal(resumed.p_values, whole.p_values)
    if store_nulls:
        np.testing.assert_array_equal(resumed.nulls, whole.nulls)
    on_cpu = module_preservation(**kw, checkpoint_dir=str(cpu_dir),
                                 device="cpu")
    cpu = module_preservation(**kw, device="cpu")
    np.testing.assert_array_equal(on_cpu.p_values, cpu.p_values)


@pytest.mark.parametrize("mode", ("values", "counts"))
def test_kernels_on_rebucketed_buckets_match_plain(cuda, mode):
    """The fused kernel on a bucket that ``rebucket`` row-filtered (its
    discovery props and ``take`` by ``index_select``) matches its plain
    version, and each surviving cell equals its value in the full bucket
    bit for bit (one block per cell)."""
    from netrep_tpu_torch import random as trandom
    from netrep_tpu_torch.data import make_mixed_pair
    from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine

    mixed = make_mixed_pair(400, 6, n_samples=40, seed=7)
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    eng = PermutationEngine(dc, dn, dd, tc, tn, td,
                            [ModuleSpec(lab, i, i) for lab, i in
                             mixed["specs"]], mixed["pool"], device=cuda)
    perm = trandom.permutation(trandom.perm_keys(trandom.key(5, cuda), 0, 32),
                               eng._pool_dev)
    full = {p: o[:, i] for b, o in zip(eng.buckets, eng._values(perm))
            for i, p in enumerate(b.module_pos)}
    keep = [p for b in eng.buckets for p in b.module_pos][1::2]
    eng.rebucket(keep)
    for b in eng.buckets:
        idx = eng._bucket_idx(perm, b)
        if mode == "values":
            got = tfused.fused_stats_values(
                eng._test_corr, eng._test_net, eng._test_dataT, b.disc, idx)
            want = tfused.fused_stats_values_plain(
                eng._test_corr, eng._test_net, eng._test_dataT, b.disc, idx)
            for i, p in enumerate(b.module_pos):
                assert _bit_equal(got[:, i], full[p])
        else:
            obs = torch.zeros((len(b.module_pos), 7), device=cuda)
            pvalid = torch.ones(idx.shape[0], dtype=torch.int32, device=cuda)
            got = tfused.fused_stats_counts(
                eng._test_corr, eng._test_net, eng._test_dataT, b.disc, idx,
                pvalid, obs)
            want = tfused.fused_stats_counts_plain(
                eng._test_corr, eng._test_net, eng._test_dataT, b.disc, idx,
                pvalid, obs)
            got, want = got[0], want[0]
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=TOL)


def _sparse_problem(n=2000, k=12, s=32, sizes=(60, 25, 140, 33), seed=0):
    """A kNN-style graph over more than 1,625 nodes (two sort rounds per
    permutation) with planted module data and a precomputed sparse
    correlation on its edge pattern."""
    from netrep_tpu_torch.ops.sparse import SparseAdjacency

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    adj = SparseAdjacency.from_coo(rows, rng.integers(0, n, n * k),
                                   rng.uniform(0.05, 1.0, n * k), n)
    x = rng.standard_normal((s, n))
    labels = np.full(n, "0", dtype=object)
    pos = 0
    for i, sz in enumerate(sizes):
        x[:, pos:pos + sz] += rng.standard_normal(s)[:, None]
        labels[pos:pos + sz] = str(i + 1)
        pos += sz
    z = (x - x.mean(0)) / x.std(0, ddof=1)
    r, c = np.nonzero(adj.nbr < n)
    cols = adj.nbr[r, c]
    corr = SparseAdjacency.from_coo(r, cols, (z[:, r] * z[:, cols]).sum(0)
                                    / (s - 1), n, symmetrize=False)
    return adj, x, corr, labels


@pytest.mark.parametrize("mode", ("data", "corr", "neither"))
def test_sparse_cuda_matches_cpu(cuda, mode):
    """The sparse path on the card gives the CPU's counts and p-values,
    values within the tolerance, and launches no kernel of the port (no
    Pallas kernel runs on the JAX package's sparse path)."""
    from netrep_tpu_torch.ops import pvalues as tpv
    from netrep_tpu_torch.models.sparse_api import sparse_module_preservation

    adj, x, corr, labels = _sparse_problem()
    kw = dict(discovery_network=adj, test_network=adj,
              module_assignments=labels, n_perm=300, seed=2)
    if mode == "data":
        kw.update(discovery_data=x, test_data=x)
    elif mode == "corr":
        kw.update(discovery_correlation=corr, test_correlation=corr)
    tops.reset_launches()
    gpu = sparse_module_preservation(**kw)
    assert all(fn.launches == 0 for fn in tops.kernels())
    cpu = sparse_module_preservation(**kw, device="cpu")
    assert np.array_equal(np.isnan(gpu.nulls), np.isnan(cpu.nulls))
    np.testing.assert_allclose(gpu.observed, cpu.observed, rtol=0, atol=TOL)
    np.testing.assert_allclose(gpu.nulls, cpu.nulls, rtol=0, atol=TOL)
    for a, b in zip(tpv.tail_counts(gpu.observed, gpu.nulls),
                    tpv.tail_counts(cpu.observed, cpu.nulls)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gpu.p_values, cpu.p_values)


@pytest.mark.parametrize("n", (2000, 50_000))
def test_permutation_draw_on_card_equals_cpu(cuda, n):
    """Above 1,625 elements the shuffle takes two stable int64 sorts; the
    card draws the CPU's index sets."""
    from netrep_tpu_torch import random as trandom

    pool = np.arange(n, dtype=np.int32)
    got = trandom.permutation(trandom.perm_keys(trandom.key(3, cuda), 0, 64),
                              torch.as_tensor(pool, device=cuda))
    want = trandom.permutation(
        trandom.perm_keys(trandom.key(3, "cpu"), 0, 64),
        torch.as_tensor(pool))
    assert trandom.shuffle_rounds(n) == 2
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("run", ("materialized", "streaming", "adaptive"))
def test_data_only_cuda_matches_cpu(cuda, run):
    """The data-only plane on the card gives the CPU's counts, p-values
    and retirements, values within the tolerance, no kernel launched."""
    from netrep_tpu_torch.data import make_mixed_pair
    from netrep_tpu_torch.models.atlas_api import atlas_module_preservation

    mixed = make_mixed_pair(600, 6, n_samples=40, seed=7)
    dd, td = mixed["discovery"][0], mixed["test"][0]
    assign = {f"node_{i}": "0" for i in range(dd.shape[1])}
    for lab, idx in mixed["specs"]:
        for i in idx:
            assign[f"node_{i}"] = str(lab)
    kw = dict(module_assignments={"d": assign}, discovery="d", test="t",
              n_perm=1000, seed=1, store_nulls=run != "streaming",
              adaptive=run == "adaptive")
    data = {"d": dd, "t": td}
    tops.reset_launches()
    gpu = atlas_module_preservation(data, **kw)
    assert all(fn.launches == 0 for fn in tops.kernels())
    cpu = atlas_module_preservation(data, **kw, device="cpu")
    np.testing.assert_allclose(gpu.observed, cpu.observed, rtol=0, atol=TOL)
    np.testing.assert_array_equal(gpu.p_values, cpu.p_values)
    if run == "adaptive":
        np.testing.assert_array_equal(gpu.n_perm_used, cpu.n_perm_used)
    if gpu.nulls is not None:
        np.testing.assert_allclose(gpu.nulls, cpu.nulls, rtol=0, atol=TOL)
    else:
        for f in ("counts_hi", "counts_lo", "counts_eff"):
            np.testing.assert_array_equal(getattr(gpu, f), getattr(cpu, f))


# --- bfloat16 storage --------------------------------------------------------

def _bf16_words_equal(a, b):
    assert a.dtype == b.dtype == torch.bfloat16
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("net", ("stored", "derived"))
@pytest.mark.parametrize("tier", tuple(TIER_CASES))
def test_bf16_kernel_matches_plain(cuda, tier, net):
    c = _case(cuda, **TIER_CASES[tier])
    tc, tn, tdT = (c[k].to(torch.bfloat16) for k in ("tc", "tn", "tdT"))
    cap, s = c["idx"].shape[-1], tdT.shape[-1]
    assert tfused.kernel_tier(cap, s, True, 2) == tier
    tn = tn if net == "stored" else None
    beta = None if net == "stored" else 2.0
    before = tfused.fused_stats_values.launches
    got = tfused.fused_stats_values(tc, tn, tdT, c["disc"], c["idx"],
                                    net_beta=beta)
    assert tfused.fused_stats_values.launches == before + 1
    want = tfused.fused_stats_values_plain(tc, tn, tdT, c["disc"], c["idx"],
                                           net_beta=beta)
    torch.cuda.synchronize()
    _assert_close_to_plain(got, want, c["sizes"])
    v, hi, lo, eff = tfused.fused_stats_counts(
        tc, tn, tdT, c["disc"], c["idx"], c["pvalid"][:c["idx"].shape[0]],
        c["obs"], net_beta=beta)
    sel = (c["pvalid"][:c["idx"].shape[0]] > 0)[:, None, None]
    ob = c["obs"][None]
    assert torch.equal(hi, ((v >= ob) & sel).sum(0, dtype=torch.int32))
    assert torch.equal(lo, ((v <= ob) & sel).sum(0, dtype=torch.int32))
    assert torch.equal(eff, ((~torch.isnan(v)) & sel).sum(
        0, dtype=torch.int32))


def test_bf16_pair_cache_counts_the_element_size(cuda):
    # a 256-node bucket's pair cache: 263 KB of float32, 132 KB of bf16
    assert not tfused.kernel_pair_cache(256, 512, True, 4)
    assert tfused.kernel_pair_cache(256, 512, True, 2)
    c = _case(cuda)
    with pytest.raises(ValueError, match="dtype"):
        tfused.fused_stats_values(c["tc"].to(torch.bfloat16), c["tn"],
                                  c["tdT"], c["disc"], c["idx"])


@pytest.mark.parametrize("n", [1000, 1001, 1002],
                         ids=("aligned16", "odd", "aligned4"))
@pytest.mark.parametrize("stage_div", [0, 3, 1 << 20],
                         ids=("in_place", "default", "staged"))
def test_bf16_gather_kernel_bit_equal_to_plain(cuda, monkeypatch, n,
                                               stage_div):
    """Rows of 2,000 bytes (16-byte staging), 2,002 (odd length: every
    other row starts 2-byte aligned, staged element by element) and 2,004
    (4-byte staging); every bucket in one launch, and the row-block
    assembly into bf16 buffers."""
    monkeypatch.setattr(tgather, "STAGE_DIV", stage_div)
    rng = np.random.default_rng(n)
    M = torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32),
                        device=cuda).to(torch.bfloat16)
    M[7, 11] = float("nan")
    idx_list = []
    for G, cap in ((120, 32), (90, 45), (4, 64)):
        idx = rng.integers(0, n, size=(G, cap)).astype(np.int32)
        idx[:, :3] = 7
        idx[:, 3] = 11
        idx[0, 1], idx[-1, 2] = -1, n + 4
        idx_list.append(torch.as_tensor(idx, device=cuda))
    got = tgather.gather_submatrix_fused_many(M, idx_list)
    want = tgather.gather_submatrix_fused_many_plain(M, idx_list)
    out = [torch.full(ix.shape + ix.shape[-1:], float("nan"), device=cuda,
                      dtype=torch.bfloat16) for ix in idx_list]
    rows = -(-n // 3)
    for r0 in range(0, n, rows):
        tgather.gather_submatrix_fused_many(M[r0: r0 + rows], idx_list, r0,
                                            out=out)
    torch.cuda.synchronize()
    for g, o, w in zip(got, out, want):
        assert _bf16_words_equal(g, w) and _bf16_words_equal(o, w)
    assert torch.isnan(got[0]).any()
    one = tgather.gather_submatrix_fused(M, idx_list[1])
    assert _bf16_words_equal(one, want[1])


def test_bf16_ring_kernel_bit_equal_to_plain(cuda):
    """Whole blocks (16-byte copies and a tail of 1-7 values), and views
    that start 2 bytes past a 16-byte boundary (2-byte copies)."""
    flat = torch.randn(49 * 201 + 8, device=cuda).to(torch.bfloat16)
    cases = (
        [torch.randn((250, 1000), device=cuda).to(torch.bfloat16)
         for _ in range(4)],
        [flat[1:1 + 49 * 201].view(49, 201), flat[:7]],
        [torch.randn(shape, device=cuda).to(torch.bfloat16)
         for shape in ((1, 1), (1, 9), (15,), (3, 5), (129, 7), (2, 1030))],
    )
    for blocks in cases:
        before = tfused.ring_shift_dma.launches
        got = tfused.ring_shift_dma(blocks)
        assert tfused.ring_shift_dma.launches == before + len(blocks)
        want = tfused.ring_shift_collective(blocks)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.data_ptr() != w.data_ptr()
            assert _bf16_words_equal(g, w)


# --- the atlas tile network builder (no kernel of the port) ---------------

def _grouped_support(genes, samples, groups, seed):
    """``tests/test_atlas_screen.py``'s grouped-support data."""
    rng = np.random.default_rng(seed)
    x = 0.01 * rng.standard_normal((samples, genes))
    gsz, ssz = genes // groups, samples // groups
    for g in range(groups):
        c0, c1 = g * gsz, (g + 1) * gsz if g < groups - 1 else genes
        r0, r1 = g * ssz, (g + 1) * ssz if g < groups - 1 else samples
        blk = rng.standard_normal((r1 - r0, c1 - c0))
        fac = rng.standard_normal(r1 - r0)
        blk += 1.5 * fac[:, None] * (rng.random(c1 - c0) < 0.5)
        x[r0:r1, c0:c1] += blk - blk.mean(axis=0)
    return x


@pytest.mark.parametrize("rule", ({"top_k": 6}, {"tau": 0.3}),
                         ids=("topk", "tau"))
def test_atlas_build_screened_equals_unscreened_on_card(cuda, rule):
    """Every tile goes through one product shape on the card too, so the
    screened pass equals the unscreened one bit for bit."""
    from netrep_tpu_torch.atlas import TiledNetwork, build_sparse_network

    tn = TiledNetwork.from_data(_grouped_support(512, 40, 8, 11), 2.0)
    tops.reset_launches()
    un = build_sparse_network(tn, tile_edge=64, degree=False, **rule)
    sc = build_sparse_network(tn, tile_edge=64, screen=True, **rule)
    assert sc.tiles_skipped > 0 and un.selected_edges == sc.selected_edges
    for g in ("adjacency", "correlation"):
        assert np.array_equal(getattr(un, g).nbr, getattr(sc, g).nbr)
        assert np.array_equal(getattr(un, g).wgt, getattr(sc, g).wgt)
    assert not any(fn.launches for fn in tops.kernels())


@pytest.mark.parametrize("rule", ({"top_k": 6}, {"tau": 0.3}),
                         ids=("topk", "tau"))
def test_atlas_build_card_equals_cpu(cuda, rule):
    """The card's build against the port's CPU build: the same edges, r
    and weights within 1e-6, degrees within 1e-5."""
    from netrep_tpu_torch.atlas import TiledNetwork, build_sparse_network

    tn = TiledNetwork.from_data(_grouped_support(512, 40, 8, 11), 2.0)
    card = build_sparse_network(tn, tile_edge=64, **rule)
    cpu = build_sparse_network(tn, tile_edge=64, device="cpu", **rule)
    for g in ("adjacency", "correlation"):
        assert np.array_equal(getattr(card, g).nbr, getattr(cpu, g).nbr)
        np.testing.assert_allclose(getattr(card, g).wgt, getattr(cpu, g).wgt,
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(card.degree, cpu.degree, rtol=0, atol=1e-5)


def _fault_kw(**extra):
    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    return dict(network={"d": d["network"], "t": t["network"]},
                data={"d": d["data"], "t": t["data"]},
                correlation={"d": d["correlation"], "t": t["correlation"]},
                module_assignments=pair["labels"], n_perm=320, seed=4,
                config=EngineConfig(chunk_size=32, superchunk=2), **extra)


def _same_result(a, b):
    np.testing.assert_array_equal(a.p_values, b.p_values)
    for f in ("nulls", "counts_hi", "counts_lo", "counts_eff"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("store_nulls", (True, False))
@pytest.mark.parametrize("plan", ("transient@40;transient@200x2",
                                  "device_lost_partial@72"))
def test_fault_plans_equal_the_unfaulted_card_run(cuda, plan, store_nulls):
    """A transient plan re-dispatches, a partial loss shrinks a 2×1 perm
    mesh over the one card: either way the card's result is the unfaulted
    card run's bit for bit, and the fused kernel ran."""
    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.utils.config import FaultPolicy
    from netrep_tpu_torch.utils.telemetry import Telemetry

    mesh = (make_mesh(2, 1, devices=[cuda] * 2)
            if plan.startswith("device_lost") else None)
    kw = _fault_kw(store_nulls=store_nulls, mesh=mesh)
    plain = module_preservation(**kw)
    bus = Telemetry(watchdog_poll_s=0)
    tops.reset_launches()
    got = module_preservation(**kw, telemetry=bus, fault_policy=FaultPolicy(
        plan=plan, backoff_base_s=0.0))
    assert any(fn.launches for fn in tops.kernels())
    _same_result(got, plain)
    c = bus.metrics.counters
    if mesh is None:
        assert c["retry_attempt.count"] == 3
    else:
        assert c["mesh_shrunk.count"] == 1
        assert "degraded" not in got.profile


def test_guarded_dispatch_waits_on_its_chunk(cuda, monkeypatch):
    """A plan-free policy runs every chunk through the guarded dispatch,
    which waits on a CUDA event of the chunk's stream inside the retry
    scope; the result is the policy-free run's bit for bit."""
    from netrep_tpu_torch.utils import faults as flt
    from netrep_tpu_torch.utils.config import FaultPolicy

    kw = _fault_kw()
    plain = module_preservation(**kw)
    waited = []
    real = flt._block_ready

    def spy(outs):
        waited.append(sorted(str(d) for d in flt._cuda_devices(outs, {})))
        return real(outs)

    monkeypatch.setattr(flt, "_block_ready", spy)
    got = module_preservation(**kw, fault_policy=FaultPolicy())
    _same_result(got, plain)
    # one guarded dispatch per chunk, each waiting on the card
    assert len(waited) == 320 // 32
    assert all(w == [str(torch.device("cuda", torch.cuda.current_device()))]
               for w in waited)


@pytest.mark.parametrize("adaptive", (False, True),
                         ids=("stream", "adaptive_stream"))
def test_slow_abandoned_dispatch_counts_once_on_the_card(cuda, adaptive):
    """A streaming dispatch that is only slow is abandoned at
    ``hang_timeout_s`` and its worker launches its kernels on the card
    while the retry runs: the late folds land in tallies nobody reads, so
    the counts equal the unfaulted card run's."""
    import threading

    from netrep_tpu_torch.data import make_mixed_pair
    from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine
    from netrep_tpu_torch.utils import faults as flt
    from netrep_tpu_torch.utils.config import FaultPolicy

    mixed = make_mixed_pair(160, 4, n_samples=24, seed=7)
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    eng = PermutationEngine(
        dc, dn, dd, tc, tn, td,
        [ModuleSpec(lab, idx, idx) for lab, idx in mixed["specs"]],
        mixed["pool"], config=EngineConfig(chunk_size=16, superchunk=2),
        device=cuda)
    observed = eng.observed()
    run = (eng.run_null_adaptive_streaming if adaptive
           else eng.run_null_streaming)
    want = run(96, observed, key=5)
    orig = eng._count_parts
    gate, late_done, calls = threading.Event(), threading.Event(), []

    def patched(*a):
        count, pull, tallies = orig(*a)

        def slow(keys, valid, acc):
            calls.append(1)
            if len(calls) == 1:
                gate.wait(30)
                out = count(keys, valid, acc)
                torch.cuda.synchronize()
                late_done.set()
                return out
            if len(calls) == 2:
                gate.set()
                late_done.wait(30)
            return count(keys, valid, acc)

        return slow, pull, tallies

    eng._count_parts = patched
    tops.reset_launches()
    got = run(96, observed, key=5, fault_policy=flt.FaultRuntime(
        FaultPolicy(hang_timeout_s=1.0, backoff_base_s=0.0)))
    launched = {fn.__name__: fn.launches for fn in tops.kernels()}
    assert late_done.is_set() and launched["fused_stats_counts"] > 0
    for f in ("hi", "lo", "eff", "n_perm_used"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def _grid_cohorts(n=240, s=32, names=("a", "b", "c")):
    rng = np.random.default_rng(11)
    network, correlation, data = {}, {}, {}
    shared = rng.standard_normal((s, 1))
    for name in names:
        x = rng.standard_normal((s, n))
        x[:, :40] += shared * 1.5  # one module preserved everywhere
        c = np.corrcoef(x, rowvar=False)
        network[name], correlation[name], data[name] = np.abs(c) ** 2, c, x
    assign = {name: {f"node_{i}": str(1 + i // 40) if i < 160 else "0"
                     for i in range(n)} for name in names[:2]}
    return network, correlation, data, assign


@pytest.mark.parametrize("stat_mode", ("fused", "xla"))
@pytest.mark.parametrize("adaptive", (False, True),
                         ids=("fixed", "adaptive"))
def test_grid_cells_equal_solo_on_the_card(cuda, stat_mode, adaptive):
    """Every cell of a small grid on the card equals its solo
    ``module_preservation`` call: p-values, counts and ``n_perm_used``
    exactly; the grid's packs go through the fused-statistics kernel
    (``stat_mode='fused'``) or the gather kernel (``'xla'``)."""
    from netrep_tpu_torch.models.grid import grid_preservation
    from netrep_tpu_torch.ops import pvalues as tpv
    from netrep_tpu_torch.ops.sequential import StopRule

    network, correlation, data, assign = _grid_cohorts()
    cfg = EngineConfig(chunk_size=32, stat_mode=stat_mode)
    kw = dict(n_perm=192, null="all", seed=3, config=cfg,
              adaptive=adaptive,
              adaptive_rule=StopRule(min_perms=32) if adaptive else None)
    tops.reset_launches()
    grid = grid_preservation(network, data=data, correlation=correlation,
                             module_assignments=assign, **kw)
    kernel = ("fused_stats_values" if stat_mode == "fused"
              else "gather_submatrix_fused_many")
    launched = {fn.__name__: fn.launches for fn in tops.kernels()}
    assert launched[kernel] > 0
    assert grid.stats["cells_computed"] == 4 and grid.stats["packs"] == 3
    for d, t, cell in grid.cells():
        solo = module_preservation(
            network, data=data, correlation=correlation,
            module_assignments=assign[d], discovery=d, test=t,
            simplify=False, **kw)[d][t]
        np.testing.assert_array_equal(cell.p_values, solo.p_values)
        hi, lo, eff = tpv.tail_counts(solo.observed,
                                      solo.nulls[:solo.completed])
        np.testing.assert_array_equal(cell.counts_hi, hi)
        np.testing.assert_array_equal(cell.counts_lo, lo)
        np.testing.assert_array_equal(cell.counts_eff, eff)
        if adaptive:
            np.testing.assert_array_equal(cell.n_perm_used, solo.n_perm_used)
        assert np.abs(cell.observed - solo.observed).max() <= TOL


def _serve_fixture():
    from netrep_tpu_torch.data import make_mixed_pair

    mixed = make_mixed_pair(400, 4, n_samples=24, seed=7)
    (dd, dc, dn), (td, tc, tn) = mixed["discovery"], mixed["test"]
    assign = {f"node_{i}": "0" for i in range(dn.shape[0])}
    for lab, idx in mixed["specs"]:
        for i in idx:
            assign[f"node_{i}"] = str(lab)
    return dict(network={"d": dn, "t": tn}, correlation={"d": dc, "t": tc},
                data={"d": dd, "t": td}, assign=assign)


@pytest.mark.parametrize("stat_mode", ("fused", "xla"))
def test_served_requests_equal_solo_on_the_card(cuda, stat_mode):
    """The single server on the card (its default device): a pack of two
    and a lone adaptive request each equal their solo call in p-values,
    counts and ``n_perm_used``; the pack launches its stat mode's kernel;
    the datasets wait on the host in pinned memory."""
    from netrep_tpu_torch.ops import pvalues as tpv
    from netrep_tpu_torch.serve import PreservationServer, ServeConfig

    fx = _serve_fixture()
    cfg = EngineConfig(chunk_size=32, stat_mode=stat_mode)
    srv = PreservationServer(ServeConfig(engine=cfg), start=False)
    for name in ("d", "t"):
        srv.register_dataset(
            "a", name, network=fx["network"][name],
            correlation=fx["correlation"][name], data=fx["data"][name],
            assignments=fx["assign"] if name == "d" else None)
    ds = srv._dataset("a", "d").ds
    assert ds.correlation.device.type == "cpu" and ds.correlation.is_pinned()
    reqs = (dict(n_perm=192, seed=3), dict(n_perm=96, seed=4),
            dict(n_perm=256, seed=5, adaptive=True))
    hs = [srv.submit("a", "d", "t", **kw) for kw in reqs]
    tops.reset_launches()
    srv.start()
    try:
        got = [srv.wait(h, timeout=600) for h in hs]
    finally:
        srv.close()
    kernel = ("fused_stats_values" if stat_mode == "fused"
              else "gather_submatrix_fused_many")
    assert {fn.__name__: fn.launches for fn in tops.kernels()}[kernel] > 0
    assert sorted(r["pack_size"] for r in got) == [1, 2, 2]
    for kw, res in zip(reqs, got):
        solo = module_preservation(
            fx["network"], data=fx["data"], correlation=fx["correlation"],
            module_assignments=fx["assign"], discovery="d", test="t",
            config=cfg, simplify=False, **kw)["d"]["t"]
        np.testing.assert_array_equal(res["p_values"], solo.p_values)
        hi, lo, eff = tpv.tail_counts(solo.observed,
                                      solo.nulls[:solo.completed])
        np.testing.assert_array_equal(res["counts_hi"], hi)
        np.testing.assert_array_equal(res["counts_lo"], lo)
        np.testing.assert_array_equal(res["counts_eff"], eff)
        if kw.get("adaptive"):
            np.testing.assert_array_equal(res["n_perm_used"],
                                          solo.n_perm_used)
        assert np.abs(res["observed"] - solo.observed).max() <= TOL


def test_pool_eviction_frees_the_card(cuda):
    """The warm pool's engines hold card memory that ``discard``,
    eviction and ``close()`` give back, and ``held_gib`` reports it; the
    registered datasets wait on the host."""
    from netrep_tpu_torch.serve import PreservationServer, ServeConfig

    fx = _serve_fixture()
    srv = PreservationServer(ServeConfig(engine=EngineConfig(chunk_size=32),
                                         pool_size=1))
    for name in ("d", "t"):
        srv.register_dataset(
            "a", name, network=fx["network"][name],
            correlation=fx["correlation"][name], data=fx["data"][name],
            assignments=fx["assign"] if name == "d" else None)
    d = srv._dataset("a", "t").ds
    assert all(t.device.type == "cpu" and t.is_pinned()
               for t in (d.correlation, d.network, d.data))

    def allocated():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    srv.analyze("a", "d", "t", n_perm=64, seed=1, timeout=600)
    assert srv.stats()["pool"]["held_gib"] > 0
    # another module set evicts the first engine: one engine stays
    srv.analyze("a", "d", "t", n_perm=64, seed=1, modules=["1"],
                timeout=600)
    st = srv.stats()["pool"]
    assert st["evictions"] == 1 and st["size"] == 1
    held = st["held_gib"] * 2**30
    before = allocated()
    srv.pool.discard(next(iter(srv.pool._lru)))
    empty = allocated()
    assert before - empty >= 0.9 * held > 0
    assert srv.stats()["pool"]["held_gib"] == 0.0
    srv.analyze("a", "d", "t", n_perm=64, seed=2, timeout=600)
    assert allocated() > empty
    srv.close()
    assert allocated() == empty


def _card_fleet(root, fx, **cfg_kw):
    """A two-replica in-process fleet on the card (the servers' default
    device), journaled into ``root``, both datasets registered, workers
    not started."""
    from netrep_tpu_torch.serve import (
        FleetConfig, ServeConfig, build_inprocess_fleet,
    )

    def make_config(rid, jpath, ckpt):
        return ServeConfig(engine=EngineConfig(chunk_size=32), journal=jpath,
                           checkpoint_dir=ckpt, checkpoint_every=64,
                           fleet_label=rid,
                           telemetry=os.path.join(root, f"{rid}.jsonl"),
                           **cfg_kw)

    fleet = build_inprocess_fleet(
        2, root, make_config=make_config,
        fleet_config=FleetConfig(heartbeat_s=3600.0), start_servers=False)
    for name in ("d", "t"):
        fleet.register_dataset(
            "a", name, network=fx["network"][name],
            correlation=fx["correlation"][name], data=fx["data"][name],
            assignments=fx["assign"] if name == "d" else None)
    return fleet


def test_fleet_failover_equals_solo_on_the_card(cuda, tmp_path):
    """A crash plan kills the home replica's worker mid-pack on the card;
    ``kill_replica`` fails its journal over to the peer, which resumes the
    pack at the crashed boundary: every request equals its solo call in
    p-values, counts and ``completed``, and the peer's pack launches the
    fused kernel once per union bucket for each chunk after the boundary
    only."""
    import json

    from netrep_tpu_torch.ops import pvalues as tpv
    from netrep_tpu_torch.utils.config import FaultPolicy

    fx = _serve_fixture()
    cfg = EngineConfig(chunk_size=32)
    fleet = _card_fleet(str(tmp_path), fx)
    reqs = {"k1": dict(n_perm=256, seed=3), "k2": dict(n_perm=256, seed=4)}
    try:
        home = fleet.route("a", "d", "t")
        peer = [r for rid, r in fleet.live_replicas().items()
                if rid != home.rid][0]
        home.arm_fault_plan(FaultPolicy(plan="crash@160", backoff_base_s=0.0,
                                        backoff_jitter=0.0))
        for k, kw in reqs.items():
            home.server.submit("a", "d", "t", idempotency_key=k, **kw)
        home.server.start()
        home.server._worker.join(timeout=600)
        assert not home.server._worker.is_alive(), "crash never fired"
        fleet.kill_replica(home.rid)
        tops.reset_launches()
        peer.server.start()
        got = {k: fleet.analyze("a", "d", "t", idempotency_key=k,
                                timeout=600, **kw) for k, kw in reqs.items()}
        launched = tfused.fused_stats_values.launches
    finally:
        fleet.close()
    events = [json.loads(line) for line in
              open(tmp_path / f"{peer.rid}.jsonl", encoding="utf-8")]
    assert [e["data"]["completed"] for e in events
            if e["ev"] == "checkpoint_resumed"] == [160]
    sizes = collections.Counter(v for v in fx["assign"].values() if v != "0")
    buckets = len({cfg.rounded_cap(s) for s in sizes.values()})
    assert launched == (256 - 160) // 32 * buckets
    for k, kw in reqs.items():
        solo = module_preservation(
            fx["network"], data=fx["data"], correlation=fx["correlation"],
            module_assignments=fx["assign"], discovery="d", test="t",
            config=cfg, simplify=False, **kw)["d"]["t"]
        res = got[k]
        np.testing.assert_array_equal(res["p_values"], solo.p_values)
        hi, lo, eff = tpv.tail_counts(solo.observed,
                                      solo.nulls[:solo.completed])
        np.testing.assert_array_equal(res["counts_hi"], hi)
        np.testing.assert_array_equal(res["counts_lo"], lo)
        np.testing.assert_array_equal(res["counts_eff"], eff)
        assert res["completed"] == solo.completed == 256
        assert np.abs(res["observed"] - solo.observed).max() <= TOL


def test_fleet_close_gives_the_card_back(cuda, tmp_path):
    """A dead replica's warm pool leaves the card at failover (its worker
    gone, without draining), and ``close()`` returns the card to within
    0.1 GiB of what it held before the fleet; registered datasets wait in
    pinned host memory on every replica."""
    from netrep_tpu_torch.utils.config import FaultPolicy

    fx = _serve_fixture()

    def allocated():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    before = allocated()
    fleet = _card_fleet(str(tmp_path), fx)
    try:
        for rep in fleet.live_replicas().values():
            d = rep.server._dataset("a", "t").ds
            assert d.correlation.device.type == "cpu"
            assert d.correlation.is_pinned()
            assert rep.stats()["datasets_gib"] > 0
        # the peer's worker waits until the card is read after failover
        home = fleet.route("a", "d", "t")
        peer = [r for rid, r in fleet.live_replicas().items()
                if rid != home.rid][0]
        home.server.start()
        fleet.analyze("a", "d", "t", n_perm=64, seed=1, timeout=600)
        held = home.stats()["pool"]["held_gib"] * 2**30
        assert held > 0
        # a second request crashes the home's worker mid-pack: the crashed
        # pack's engine is discarded, the first one stays pooled
        home.arm_fault_plan(FaultPolicy(plan="crash@32", backoff_base_s=0.0,
                                        backoff_jitter=0.0))
        home.server.submit("a", "d", "t", n_perm=64, seed=2, modules=["1"],
                           idempotency_key="c")
        home.server._worker.join(timeout=600)
        assert not home.server._worker.is_alive(), "crash never fired"
        assert home.server.pool.stats()["size"] == 1
        busy = allocated()
        fleet.kill_replica(home.rid)
        assert home.server.pool.stats()["size"] == 0
        assert busy - allocated() >= 0.9 * held
        peer.server.start()
        res = fleet.analyze("a", "d", "t", n_perm=64, seed=2, modules=["1"],
                            idempotency_key="c", timeout=600)
        assert res["completed"] == 64
        assert allocated() > before
    finally:
        fleet.close()
    assert allocated() - before <= 0.1 * 2**30
