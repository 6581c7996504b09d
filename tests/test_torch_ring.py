"""The ring exchange of the row-sharded null, on the CPU: the plain ring
step (:func:`ring_shift_collective`) against the JAX package's
``lax.ppermute`` under ``shard_map`` on the virtual CPU mesh, and
:func:`ring_gather_all` (plain versions of the ring step and the local
gather) against the replicated gather, bit for bit: each entry of the
assembled submatrix receives exactly one nonzero share."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from netrep_tpu.ops import fused_stats as jfused  # noqa: E402
from netrep_tpu.parallel import mesh as jmesh  # noqa: E402
from netrep_tpu.parallel import sharded as jsharded  # noqa: E402
from netrep_tpu_torch.ops import fused_gather as tgather  # noqa: E402
from netrep_tpu_torch.ops import fused_stats as tfused  # noqa: E402
from netrep_tpu_torch.parallel.sharded import pad_square_to_multiple  # noqa: E402


@pytest.mark.parametrize("R", [2, 4])
def test_ring_shift_direction_matches_jax(R):
    rows, n = 3, 5
    x = np.arange(R * rows * n, dtype=np.float32).reshape(R * rows, n)
    mesh = jmesh.make_mesh(1, R)
    step = jsharded._shard_map(
        lambda b: jfused.ring_shift_collective(b, "row", R), mesh=mesh,
        in_specs=P("row", None), out_specs=P("row", None),
        **jsharded._NO_CHECK_KW)
    want = np.asarray(jax.jit(step)(jnp.asarray(x)))
    blocks = list(torch.as_tensor(x).split(rows))
    got = tfused.ring_shift_collective(blocks)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    # shard j's block ends at shard j + 1
    assert got[1] is blocks[0] and got[0] is blocks[R - 1]


def test_ring_shift_dma_on_the_cpu_is_the_plain_step():
    blocks = list(torch.arange(12.0).reshape(4, 3).split(1))
    before = tfused.ring_shift_dma.launches
    got = tfused.ring_shift_dma(blocks)
    assert [g is w for g, w in zip(got, tfused.ring_shift_collective(
        blocks))] == [True] * 4
    assert tfused.ring_shift_dma.launches == before


@pytest.mark.parametrize("R", [2, 3, 4])
def test_ring_gather_all_bit_equal_to_replicated(R):
    rng = np.random.default_rng(R)
    n = 10 * R + 1                      # pads to a multiple of R
    mats = [torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32))
            for _ in range(2)]
    padded = [pad_square_to_multiple(m, R) for m in mats]
    rows_per = padded[0].shape[0] // R
    assert padded[0].shape[0] > n
    rings = [list(p.split(rows_per)) for p in padded]
    idx = []
    for _ in range(R):   # each shard its own index batches, per bucket
        per = []
        for cap in (4, 7):
            ix = rng.integers(0, n, size=(3, 2, cap)).astype(np.int32)
            ix[0, 0, -1] = -1           # sentinel slots
            ix[1, 1, 0] = n + R         # past the padded width
            per.append(torch.as_tensor(ix))
        idx.append(per)
    subs = tfused.ring_gather_all(rings, idx, rows_per)
    for j in range(R):
        for mi, m in enumerate(mats):
            for bi, ix in enumerate(idx[j]):
                want = tgather.gather_submatrix_fused_plain(m, ix)
                assert torch.equal(subs[j][mi][bi], want)


@pytest.mark.parametrize("R", [2, 4])
def test_ring_makes_one_gather_call_per_step_shard_and_matrix(monkeypatch, R):
    """Each step writes every bucket of a shard's chunk in one in-place
    call per matrix (``out=``): R steps x R shards x 2 matrices, and no
    share is added anywhere."""
    from netrep_tpu_torch.ops import fused_gather

    rng = np.random.default_rng(10 + R)
    n = 8 * R
    mats = [torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32))
            for _ in range(2)]
    rings = [list(m.split(n // R)) for m in mats]
    idx = [[torch.as_tensor(rng.integers(-1, n + 1, (3, cap)).astype(
        np.int32)) for cap in (3, 6)] for _ in range(R)]
    calls = []
    real = fused_gather.gather_submatrix_fused_many

    def counted(M, idx_list, row_start=0, out=None):
        assert out is not None and len(out) == len(idx_list) == 2
        calls.append(row_start)
        return real(M, idx_list, row_start, out=out)

    monkeypatch.setattr(fused_gather, "gather_submatrix_fused_many", counted)
    monkeypatch.setattr(torch.Tensor, "add_", None)   # no share is summed
    subs = tfused.ring_gather_all(rings, idx, n // R)
    assert len(calls) == R * R * 2
    assert sorted(calls) == sorted([r * (n // R) for r in range(R)] * R * 2)
    for j in range(R):
        for mi, m in enumerate(mats):
            for bi, ix in enumerate(idx[j]):
                assert torch.equal(subs[j][mi][bi],
                                   tgather.gather_submatrix_fused_plain(m, ix))


def test_psum_gatherer_writes_in_place_bit_equal(monkeypatch):
    """The psum gatherer over one device's row blocks: one in-place call
    per block and matrix for every bucket, equal to the replicated gather
    bit for bit."""
    from netrep_tpu_torch.parallel import mesh as tmesh
    from netrep_tpu_torch.parallel import sharded as tsharded

    R, n = 4, 30
    rng = np.random.default_rng(7)
    mats = [torch.as_tensor(rng.standard_normal((n, n)).astype(np.float32))
            for _ in range(2)]
    mesh = tmesh.make_mesh(1, R, devices=[torch.device("cpu")] * R)
    blocks = [tsharded.shard_rows(pad_square_to_multiple(m, R), mesh)
              for m in mats]
    idx = [torch.as_tensor(rng.integers(-2, n + 3, (2, 5, cap)).astype(
        np.int32)) for cap in (4, 9, 16)]
    calls = []
    real = tsharded.gather_submatrix_fused_many

    def counted(M, idx_list, row_start=0, out=None):
        calls.append(out is not None)
        return real(M, idx_list, row_start, out=out)

    monkeypatch.setattr(tsharded, "gather_submatrix_fused_many", counted)
    sub_c, sub_n = tsharded.make_sharded_gatherer(mesh)(*blocks, idx)
    assert calls == [True] * (R * 2)
    for got, m in ((sub_c, mats[0]), (sub_n, mats[1])):
        for g, ix in zip(got, idx):
            assert torch.equal(g, tgather.gather_submatrix_fused_plain(m, ix))
