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
        tfused.fused_stats_values, tfused.fused_stats_counts,
        tfused.ring_shift_dma}
    tops.reset_launches()
    assert all(fn.launches == 0 for fn in tops.kernels())
