"""Threefry-2x32 permutation streams in torch integer arithmetic.

The permutation null's reproducibility contract is "same seed, same
nulls": permutation ``i`` of a run is drawn from ``fold_in(key(seed), i)``
and is independent of chunk size and device. The JAX package draws it with
``jax.random.permutation`` under the partitionable Threefry implementation
(``jax_threefry_partitionable=True``); this module reproduces those bits
exactly, so the port shuffles every permutation into the same index set as
the JAX package for the same seed.

Pieces, each matching its JAX counterpart bit for bit:

- :func:`threefry2x32` — the 20-round Threefry-2x32 block hash;
- :func:`key` — ``jax.random.key(seed)`` (32-bit seeds: ``(0, seed)``);
- :func:`fold_in` — ``threefry_2x32(key, (0, data))``;
- :func:`split` — the partitionable split: hash of the 64-bit iota
  ``(hi, lo)`` pairs;
- :func:`random_bits` — partitionable 32-bit bits: ``hi ^ lo`` of the hash
  of the iota over the output shape;
- :func:`permutation` — the sort-based shuffle: ``ceil(3 ln n / ln(2^32-1))``
  rounds, each a split and a STABLE sort of the array by fresh bits.

Unsigned 32-bit words live in int64 tensors masked to 32 bits, so every
operation runs on CPU and CUDA alike and never wraps a signed type. Keys are
batched: a ``ThreefryKey`` holds ``(..., 2)`` words, and every function maps
over the leading axes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .utils.config import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


@dataclasses.dataclass(frozen=True)
class ThreefryKey:
    """A batch of Threefry keys: ``words`` is an int64 tensor ``(..., 2)``
    holding two unsigned 32-bit words per key (the JAX key data)."""

    words: torch.Tensor

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.words.shape[:-1])

    @property
    def device(self) -> torch.device:
        return self.words.device

    def to(self, device) -> "ThreefryKey":
        return ThreefryKey(self.words.to(device))

    def data(self) -> np.ndarray:
        """The key words as ``uint32`` numpy (``jax.random.key_data``)."""
        return self.words.cpu().numpy().astype(np.uint32)

    @classmethod
    def from_data(cls, data, device=None) -> "ThreefryKey":
        """Key from ``jax.random.key_data``-shaped ``(..., 2)`` uint32 words,
        on ``device`` (None means ``"cuda"``; raises without a card)."""
        arr = np.asarray(data, dtype=np.uint32).astype(np.int64)
        if arr.shape[-1:] != (2,):
            raise ValueError(f"key data must end in 2 words, got {arr.shape}")
        return cls(torch.as_tensor(arr, device=resolve_device(device)))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds on broadcastable int64 word tensors
    holding unsigned 32-bit values; returns the two output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, device=None) -> ThreefryKey:
    """``jax.random.key(seed)`` with 64-bit mode off: the seed is taken as a
    32-bit integer, giving the words ``(0, seed mod 2**32)``. ``device``
    None means ``"cuda"`` (raises without a card)."""
    return ThreefryKey(torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                                    device=resolve_device(device)))


def fold_in(k: ThreefryKey, data) -> ThreefryKey:
    """``jax.random.fold_in`` for every entry of ``data`` (an int tensor or
    sequence, taken mod 2**32): the result has shape ``k.shape +
    data.shape``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _MASK
    w = k.words.reshape(k.shape + (1,) * d.ndim + (2,))
    y0, y1 = threefry2x32(w[..., 0], w[..., 1], torch.zeros_like(d), d)
    return ThreefryKey(torch.stack([y0, y1], dim=-1))


def _iota_hash(k: ThreefryKey, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Hash of the 64-bit iota ``0..n-1`` split into ``(hi, lo)`` words —
    the partitionable scheme's counter layout — under every key of ``k``:
    returns two ``k.shape + (n,)`` tensors."""
    it = torch.arange(n, dtype=torch.int64, device=k.device)
    w = k.words.unsqueeze(-2)
    return threefry2x32(w[..., 0], w[..., 1], it >> 32, it & _MASK)


def split(k: ThreefryKey, num: int = 2) -> ThreefryKey:
    """``jax.random.split(key, num)`` (partitionable): shape ``k.shape +
    (num,)``."""
    b0, b1 = _iota_hash(k, num)
    return ThreefryKey(torch.stack([b0, b1], dim=-1))


def random_bits(k: ThreefryKey, n: int) -> torch.Tensor:
    """32 random bits per entry, ``k.shape + (n,)`` (partitionable
    ``threefry_random_bits`` for a 1-D shape)."""
    b0, b1 = _iota_hash(k, n)
    return b0 ^ b1


def shuffle_rounds(n: int) -> int:
    """Sort rounds of the shuffle for ``n`` elements: one round up to 1625
    elements, two from 1626 (where 32-bit sort keys start to collide too
    often for one round)."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))


def permutation(k: ThreefryKey, x: torch.Tensor) -> torch.Tensor:
    """``jax.random.permutation(key, x)`` for a 1-D ``x`` under every key of
    ``k``: returns ``k.shape + (len(x),)``. Each round splits the key and
    stable-sorts the current order by fresh 32-bit bits drawn per position
    (ties keep their order, as ``lax.sort_key_val`` does)."""
    n = int(x.shape[0])
    order = torch.arange(n, device=x.device).expand(k.shape + (n,))
    for _ in range(shuffle_rounds(n)):
        ks = split(k)
        k = ThreefryKey(ks.words[..., 0, :])
        bits = random_bits(ThreefryKey(ks.words[..., 1, :]), n)
        perm = torch.sort(bits, dim=-1, stable=True).indices
        order = torch.gather(order, -1, perm)
    return x[order]


def perm_keys(k: ThreefryKey, start: int, count: int) -> ThreefryKey:
    """Per-permutation keys ``fold_in(k, i)`` for ``i`` in ``[start,
    start + count)`` — the chunk- and device-independent seeding contract.
    The permutation axis leads: shape ``(count,) + k.shape``. A ``(G,)``
    batch of keys (one per request of a pack) gives the JAX package's
    grouped keys (``_perm_keys_grouped_jit``): row i holds every group's
    ``fold_in(key_g, start + i)``, so each request draws the permutations
    of its own run."""
    out = fold_in(k, torch.arange(start, start + count, dtype=torch.int64,
                                  device=k.device))
    if not k.shape:
        return out
    return ThreefryKey(out.words.movedim(len(k.shape), 0).contiguous())
