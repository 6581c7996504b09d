"""The port's submatrix-gather entry points on the CPU (their plain versions)
against the JAX package's Pallas gather in interpret mode — the JAX
package's own CPU path — on the same numpy inputs.

Tolerance: none. A gather is a copy, and the Pallas interpreter's one-hot
select over finite float32 values is exact on the CPU, so the two must be
bit-equal, sentinel slots (negative or ``>= n``) included. The local
entry's shares over a split of the rows must sum to the replicated gather
exactly (each entry has one non-zero share)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from netrep_tpu.ops import fused_gather as jgather  # noqa: E402
from netrep_tpu_torch import ops as tops  # noqa: E402
from netrep_tpu_torch.ops import fused_gather as tgather  # noqa: E402
from netrep_tpu_torch.ops import fused_stats as tfused  # noqa: E402

N, CAP = 150, 13            # neither a multiple of the TPU kernel's tiles
BLOCKS = (0, 40, 80, 120)   # row starts of a 4-way split (last block 30)


def _case(batch, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((N, N)).astype(np.float32)
    idx = rng.integers(0, N, size=batch + (CAP,)).astype(np.int32)
    flat = idx.reshape(-1, CAP)
    flat[0, 3] = -1          # sentinels: a negative slot and one past n
    flat[-1, 7] = N
    flat[-1, 0] = N + 9
    return M, idx


def _jax(fn, *args):
    return np.asarray(jax.jit(lambda *a: fn(*a, interpret=True))(*args))


@pytest.mark.parametrize("batch", [(), (3,), (2, 5)], ids=str)
def test_replicated_bit_equal_to_pallas_interpret(batch):
    M, idx = _case(batch)
    want = _jax(jgather.gather_submatrix_fused, jnp.asarray(M),
                jnp.asarray(idx))
    before = tgather.gather_submatrix_fused.launches
    got = tgather.gather_submatrix_fused(torch.as_tensor(M),
                                         torch.as_tensor(idx)).numpy()
    # the CPU route is the plain version: no kernel launch is counted
    assert tgather.gather_submatrix_fused.launches == before
    assert got.shape == batch + (CAP, CAP) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    flat = got.reshape(-1, CAP, CAP)
    assert not flat[0, 3].any() and not flat[0, :, 3].any()
    assert not flat[-1, 7].any() and not flat[-1, :, 0].any()


@pytest.mark.parametrize("batch", [(), (3,), (2, 5)], ids=str)
def test_local_bit_equal_and_sums_to_replicated(batch):
    M, idx = _case(batch, seed=1)
    starts = BLOCKS + (N,)
    total = torch.zeros(batch + (CAP, CAP))
    for r0, r1 in zip(starts[:-1], starts[1:]):
        block = M[r0:r1]
        want = _jax(jgather.gather_submatrix_fused_local, jnp.asarray(block),
                    jnp.asarray(idx), r0)
        got = tgather.gather_submatrix_fused_local(
            torch.as_tensor(block), torch.as_tensor(idx), r0)
        np.testing.assert_array_equal(got.numpy(), want)
        total += got
    full = tgather.gather_submatrix_fused(torch.as_tensor(M),
                                          torch.as_tensor(idx))
    assert torch.equal(total, full)


def test_plain_never_reads_a_sentinel_slot():
    # a NaN in M that only sentinel or un-owned slots could reach stays out
    M, idx = _case((4,), seed=2)
    M[:, 0] = np.nan
    M[0, :] = np.nan
    idx[idx == 0] = 1
    idx[:, 2] = -1
    got = tgather.gather_submatrix_fused(torch.as_tensor(M),
                                         torch.as_tensor(idx))
    assert torch.isfinite(got).all()
    local = tgather.gather_submatrix_fused_local(
        torch.as_tensor(M[40:80]), torch.as_tensor(idx), 40)
    assert torch.isfinite(local).all()


@pytest.mark.parametrize("case", ["bf16", "f64", "3d", "float_idx", "meta"])
def test_bad_operands_raise(case):
    M, idx = _case((2,))
    Mt, it = torch.as_tensor(M), torch.as_tensor(idx)
    bad = {
        "bf16": (Mt.to(torch.bfloat16), it, "dtype"),
        "f64": (Mt.double(), it, "dtype"),
        "3d": (Mt[None], it, "2-D"),
        "float_idx": (Mt, it.float(), "integer"),
        "meta": (torch.empty((N, N), device="meta"), it, "unsupported device"),
    }[case]
    for call in (lambda: tgather.gather_submatrix_fused(*bad[:2]),
                 lambda: tgather.gather_submatrix_fused_local(*bad[:2], 0)):
        with pytest.raises(ValueError, match=bad[2]):
            call()


def test_reset_launches_clears_every_kernel():
    for fn in tops.kernels():
        fn.launches = 3
    assert set(tops.kernels()) == {
        tgather.gather_submatrix_fused, tgather.gather_submatrix_fused_local,
        tgather.gather_submatrix_fused_many,
        tfused.fused_stats_values, tfused.fused_stats_counts,
        tfused.ring_shift_dma}
    tops.reset_launches()
    assert all(fn.launches == 0 for fn in tops.kernels())


CAPS = (5, 13, 32)   # one index tensor per bucket, as a chunk's buckets


def _many_case(seed=3, batch=(4, 3)):
    """Several buckets at once: module slots padded with gene 0 (as the
    engine pads them), duplicate indices, sentinels, and a NaN planted in a
    row that no slot reads. Returns M, the index list and the NaN row."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((N, N)).astype(np.float32)
    nan_row = N - 1
    M[nan_row, 1:] = np.nan
    idx_list = []
    for cap in CAPS:
        idx = rng.integers(0, N - 1, size=batch + (cap,)).astype(np.int32)
        flat = idx.reshape(-1, cap)
        flat[:, cap - cap // 3:] = 0          # padded slots read gene 0
        flat[1, 1] = flat[1, 2]               # a duplicate index
        flat[0, 0], flat[-1, 1] = -1, N + 2   # sentinels
        idx_list.append(idx)
    return M, idx_list, nan_row


def test_many_bit_equal_to_pallas_interpret_per_bucket():
    M, idx_list, _ = _many_case()
    before = tgather.gather_submatrix_fused_many.launches
    got = tgather.gather_submatrix_fused_many(
        torch.as_tensor(M), [torch.as_tensor(i) for i in idx_list])
    assert tgather.gather_submatrix_fused_many.launches == before
    assert len(got) == len(CAPS)
    for g, idx in zip(got, idx_list):
        want = _jax(jgather.gather_submatrix_fused, jnp.asarray(M),
                    jnp.asarray(idx))
        assert g.shape == idx.shape + idx.shape[-1:]
        np.testing.assert_array_equal(g.numpy(), want)
        assert np.isfinite(want).all()   # the NaN row is never read


def _nan_equal(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


@pytest.mark.parametrize("starts", [(0,), (0, 75), BLOCKS], ids=len)
def test_many_out_over_row_blocks_leaves_the_replicated_gather(starts):
    """Launches with ``out=`` over 1, 2 and 4 row blocks, into buffers that
    start as NaN, leave exactly the replicated gather: every entry written
    once, the rows no block owns zeroed by the block at row 0. A NaN in a
    row the slots do read lands where the replicated gather puts it."""
    M, idx_list, nan_row = _many_case(seed=4)
    M[7, 9] = np.nan
    idx_list[1].reshape(-1, 13)[2, :2] = (7, 9)
    Mt = torch.as_tensor(M)
    its = [torch.as_tensor(i) for i in idx_list]
    out = [torch.full(i.shape + i.shape[-1:], float("nan")) for i in its]
    bounds = tuple(starts) + (N,)
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        res = tgather.gather_submatrix_fused_many(Mt[r0:r1], its, r0, out=out)
        assert all(r is o for r, o in zip(res, out))
    for o, it in zip(out, its):
        want = tgather.gather_submatrix_fused_plain(Mt, it)
        assert _nan_equal(o, want)
    assert torch.isnan(out[1]).any()


def test_many_without_out_is_each_blocks_share():
    M, idx_list, _ = _many_case(seed=5)
    its = [torch.as_tensor(i) for i in idx_list]
    for r0, r1 in zip(BLOCKS, BLOCKS[1:] + (N,)):
        block = torch.as_tensor(M[r0:r1])
        got = tgather.gather_submatrix_fused_many(block, its, r0)
        for g, it in zip(got, its):
            assert torch.equal(
                g, tgather.gather_submatrix_fused_local_plain(block, it, r0))


def test_many_checks_its_buffers():
    M, idx_list, _ = _many_case()
    its = [torch.as_tensor(i) for i in idx_list]
    Mt = torch.as_tensor(M)
    with pytest.raises(ValueError, match="buffers"):
        tgather.gather_submatrix_fused_many(Mt, its, out=[])
    bad = [torch.empty(i.shape + i.shape[-1:]) for i in its]
    bad[2] = bad[2][..., :-1]
    with pytest.raises(ValueError, match=r"out\[2\]"):
        tgather.gather_submatrix_fused_many(Mt, its, out=bad)
    assert tgather.gather_submatrix_fused_many(Mt, []) == []


def test_composed_engine_gathers_a_chunk_in_one_call_per_matrix(monkeypatch):
    """``stat_mode='xla'``: each chunk's buckets go to the gather in one
    call per matrix, and the counts equal those of a bucket-by-bucket
    gather (the plain version)."""
    from netrep_tpu_torch.data import make_example_pair, pair_frames
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.parallel import engine as tengine
    from netrep_tpu_torch.utils.config import EngineConfig

    pair = make_example_pair(np.random.default_rng(3))
    d, t = pair_frames(pair)
    kw = dict(network={"d": d["network"], "t": t["network"]},
              data={"d": d["data"], "t": t["data"]},
              correlation={"d": d["correlation"], "t": t["correlation"]},
              module_assignments=pair["labels"], n_perm=200, seed=4,
              device="cpu", store_nulls=False,
              config=EngineConfig(stat_mode="xla", chunk_size=64))
    calls = []
    real = tengine.gather_submatrix_fused_many

    def counted(M, idx_list, *a, **k):
        calls.append(len(idx_list))
        return real(M, idx_list, *a, **k)

    monkeypatch.setattr(tengine, "gather_submatrix_fused_many", counted)
    res = module_preservation(**kw)
    monkeypatch.setattr(tengine, "gather_submatrix_fused_many",
                        lambda M, idx_list: [
                            tgather.gather_submatrix_fused_plain(M, i)
                            for i in idx_list])
    ref = module_preservation(**kw)
    n_buckets = calls[0]
    assert n_buckets > 1 and calls == [n_buckets] * (2 * 4)  # 2 matrices
    for name in ("counts_hi", "counts_lo", "counts_eff", "p_values"):
        np.testing.assert_array_equal(getattr(res, name), getattr(ref, name))
