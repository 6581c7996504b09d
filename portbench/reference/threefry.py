"""The permutation draw, re-derived: Threefry-2x32 keys and the sort-based
shuffle, so the reference rebuilds permutation ``i`` of a call from the
call's seed alone.

Frozen copy of the draw in ``netrep_tpu_torch/random.py`` at commit
53bdfe689d3220fe33f3e7b7699923adc36ce31a (itself bit-equal to
``jax.random.permutation`` under partitionable Threefry): ``key(seed)`` is
``(0, seed mod 2**32)``, permutation ``i`` is drawn from ``fold_in(key, i)``,
and each of ``ceil(3 ln n / ln(2**32 - 1))`` rounds splits the key and
stable-sorts the order by fresh 32-bit words. Unsigned words live in int64
tensors masked to 32 bits.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """20-round Threefry-2x32 on broadcastable int64 word tensors."""
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


def perm_keys(seed: int, index: torch.Tensor) -> torch.Tensor:
    """``fold_in(key(seed), i)`` for every ``i`` of ``index``: ``(len, 2)``
    int64 words, on ``index``'s device."""
    d = index.to(torch.int64) & _MASK
    y0, y1 = threefry2x32(torch.zeros_like(d), torch.full_like(d, int(seed) & _MASK),
                          torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def _iota_hash(words: torch.Tensor, n: int):
    it = torch.arange(n, dtype=torch.int64, device=words.device)
    w = words.unsqueeze(-2)
    return threefry2x32(w[..., 0], w[..., 1], it >> 32, it & _MASK)


def shuffle_rounds(n: int) -> int:
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))


def permutations(words: torch.Tensor, n: int) -> torch.Tensor:
    """The shuffle of ``arange(n)`` under each key of ``words`` ``(B, 2)``:
    ``(B, n)`` int64."""
    order = torch.arange(n, device=words.device).expand(words.shape[0], n)
    for _ in range(shuffle_rounds(n)):
        b0, b1 = _iota_hash(words, 2)           # split into two keys
        sub = torch.stack([b0[..., 1], b1[..., 1]], dim=-1)
        words = torch.stack([b0[..., 0], b1[..., 0]], dim=-1)
        h0, h1 = _iota_hash(sub, n)
        perm = torch.sort(h0 ^ h1, dim=-1, stable=True).indices
        order = torch.gather(order, -1, perm)
    return order


def draw(seed: int, index, n: int, device) -> torch.Tensor:
    """Permutations ``index`` (a sequence or tensor of indices) of the call
    seeded ``seed`` over a pool of ``n`` positions: ``(len(index), n)``."""
    idx = torch.as_tensor(index, dtype=torch.int64, device=device)
    return permutations(perm_keys(seed, idx), n)
