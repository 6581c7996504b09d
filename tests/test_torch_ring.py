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
