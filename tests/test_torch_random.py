"""The port's Threefry permutation streams against ``jax.random``: every
permutation index set must be EQUAL to the JAX package's for the same seed
and index — the counts and p-values of the port rest on it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from netrep_tpu.parallel import engine as jengine  # noqa: E402
from netrep_tpu_torch import random as trandom  # noqa: E402
from netrep_tpu_torch.parallel import engine as tengine  # noqa: E402

SEEDS = (0, 1, 7, 12345, 2**31 - 1)


def _jax_perms(seed, pool, start, count):
    k = jax.random.key(seed)
    return np.stack([
        np.asarray(jax.random.permutation(jax.random.fold_in(k, i), pool))
        for i in range(start, start + count)
    ])


def test_reference_uses_the_partitionable_scheme():
    # the port implements only the partitionable Threefry layout of split,
    # fold_in and random_bits; the JAX package must be running under it
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_matches(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(trandom.key(seed, device="cpu").data(), want)


def test_key_data_wraps_like_jax():
    # 32-bit seeds: negative and >32-bit seeds wrap to their low word
    for seed in (-1, -12345, 2**33 + 7):
        want = np.asarray(jax.random.key_data(jax.random.key(seed)))
        np.testing.assert_array_equal(trandom.key(seed, device="cpu").data(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_split_bits_match(seed):
    k = jax.random.key(seed)
    tk = trandom.key(seed, device="cpu")
    data = [0, 1, 5, 2**31, 2**32 - 1]
    want = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(k, d)))
                     for d in data])
    np.testing.assert_array_equal(trandom.fold_in(tk, data).data(), want)
    np.testing.assert_array_equal(
        trandom.split(tk, 3).data(),
        np.asarray(jax.random.key_data(jax.random.split(k, 3))),
    )
    np.testing.assert_array_equal(
        trandom.random_bits(tk, 37).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(k, (37,), jnp.uint32)),
    )


@pytest.mark.parametrize("n", (1, 2, 50, 1625, 1626, 3000))
@pytest.mark.parametrize("seed", (0, 12345))
def test_permutations_equal_jax(seed, n):
    # 1625/1626 straddle the one-round/two-round threshold of the shuffle
    assert trandom.shuffle_rounds(1625) == 1
    assert trandom.shuffle_rounds(1626) == 2
    pool = (np.arange(n, dtype=np.int32) * 3 + 1)[::-1].copy()
    for start in (0, 130):
        got = trandom.permutation(
            trandom.perm_keys(trandom.key(seed, device="cpu"), start, 3),
            torch.as_tensor(pool),
        ).numpy()
        np.testing.assert_array_equal(got, _jax_perms(seed, pool, start, 3))


def test_chunking_does_not_change_permutations():
    pool = torch.arange(200, dtype=torch.int32)
    k = trandom.key(3, device="cpu")
    whole = trandom.permutation(trandom.perm_keys(k, 0, 10), pool)
    parts = torch.cat([
        trandom.permutation(trandom.perm_keys(k, s, 5), pool)
        for s in (0, 5)
    ])
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("cap,slices", [
    (16, ((0, 16), (16, 9), (25, 3))),
    (32, ((4, 20),)),
])
def test_idx_blocks_layout_matches(cap, slices):
    perms = _jax_perms(5, np.arange(60, dtype=np.int32), 0, 4)
    want = np.asarray(jengine._idx_blocks(jnp.asarray(perms), cap, slices))
    got = tengine._idx_blocks(torch.as_tensor(perms), cap, slices).numpy()
    np.testing.assert_array_equal(got, want)


def test_key_data_round_trips():
    # a root key carried over as key data (netrep_tpu_torch.state) draws the
    # same permutations as the integer seed it came from
    pool = torch.arange(90, dtype=torch.int32)
    k = trandom.key(2026, device="cpu")
    back = trandom.ThreefryKey.from_data(k.data(), device="cpu")
    assert torch.equal(back.words, k.words)
    assert torch.equal(trandom.permutation(trandom.perm_keys(back, 7, 4), pool),
                       trandom.permutation(trandom.perm_keys(k, 7, 4), pool))
    with pytest.raises(ValueError, match="2 words"):
        trandom.ThreefryKey.from_data(np.zeros(3, np.uint32), device="cpu")
