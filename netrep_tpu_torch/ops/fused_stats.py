"""Fused preservation statistics: gather + the seven statistics + tally fold
for a batch of ``(B, K, cap)`` index sets, in one CUDA kernel launch.

The port of ``netrep_tpu/ops/fused_stats.py`` (``fused_stats_values`` and
``fused_stats_counts``, the Pallas mega-kernel). On a CUDA tensor each
wrapper launches ``csrc/fused_stats.cu`` (one thread block per
``(permutation, module)`` cell, design notes in the source) or raises; on a
CPU tensor it runs the plain version beside it, which composes the same
statistics from :mod:`netrep_tpu_torch.ops.stats`. Nothing falls back from
one to the other.

Contracts, as in the JAX package:

- ``fused_stats_counts`` tallies compare the very values it returns:
  ``hi == sum((values >= obs) & pvalid)``, ``lo`` likewise with ``<=``,
  ``eff == sum(~isnan(values) & pvalid)``, bit for bit; NaN compares False;
- ``tn`` None derives the network from the gathered correlation with
  ``net_beta``; ``tdT`` None is the data-less variant (the four data
  statistics are NaN);
- every ``(cap, s)`` computes, on both devices: the kernel streams the
  module's data rows and never needs the data slice in shared memory;
- ``tc`` and ``tn`` are symmetric up to the datasets' tolerance
  (``np.allclose(a, a.T, rtol=1e-5, atol=1e-8)``): the kernel reads each
  unordered pair once where its shared-memory cache fits, and on matrices
  that asymmetric its statistics stay within 1e-4 of the plain version's,
  which reads both triangles (measured in both tiers, csrc note).

Each wrapper counts its kernel launches in a plain integer attribute
(``fused_stats_values.launches``), so a run can show its path went through
the kernel; the plain version and the CPU path never count.

The ring exchange of the row-sharded path lives here too, as in the JAX
module: :func:`ring_shift_dma` (``csrc/ring_shift.cu``, one launch per
block moved), its plain version :func:`ring_shift_collective`, and
:func:`ring_gather_all`, which assembles module submatrices by streaming
the row blocks around the ring. One process drives every shard, so a ring
step is a list of blocks in and a list out. On a CUDA tensor the step is
always the kernel: the JAX package's ``NETREP_RING_DMA`` switch is not
read, because both of its routes compute the same exact copy and its
collective route is the stand-in its CPU tests run; here that stand-in is
the plain version, for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from . import stats as tstats
from ._build import load
from .oracle import N_STATS

_NET_KIND = {"unsigned": 0, "signed": 1, "signed-hybrid": 2}
_SOURCE = "fused_stats"
_RING_SOURCE = "ring_shift"
#: how the kernel runs a bucket's power iteration (``fused_stats_tier``)
TIERS = ("none", "node_gram", "sample_gram", "streamed")


def _net_spec(tn, net_beta) -> tuple[int, float]:
    if tn is not None:
        return -1, 0.0
    if net_beta is None:
        raise ValueError(
            "tn is None (derived-network mode) but net_beta is not set"
        )
    beta, kind = tstats.normalize_net_beta(net_beta)
    return _NET_KIND[kind], beta


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def fused_stats_values_plain(tc, tn, tdT, disc, idx, *, net_beta=None,
                             n_iter: int = 60) -> torch.Tensor:
    """The seven statistics of every ``(b, k)`` cell composed from
    :mod:`~netrep_tpu_torch.ops.stats` (gram-matrix power iteration):
    ``(B, K, 7)`` float32. Out-of-range indices clip like the kernel's."""
    _net_spec(tn, net_beta)
    idx = idx.long().clamp(0, tc.shape[-1] - 1)
    return tstats.gather_and_stats(
        disc, idx, tc, tn, tdT, n_iter=n_iter, summary_method="power",
        net_beta=net_beta,
    )


def fused_stats_counts_plain(tc, tn, tdT, disc, idx, pvalid, obs, *,
                             net_beta=None, n_iter: int = 60):
    """Plain version of :func:`fused_stats_counts`: ``(values, hi, lo,
    eff)`` with int32 ``(K, 7)`` tallies of the returned values."""
    vals = fused_stats_values_plain(tc, tn, tdT, disc, idx,
                                    net_beta=net_beta, n_iter=n_iter)
    sel = (pvalid > 0).reshape(-1, 1, 1)
    ob = obs.to(torch.float32)[None]
    hi = ((vals >= ob) & sel).sum(0, dtype=torch.int32)
    lo = ((vals <= ob) & sel).sum(0, dtype=torch.int32)
    eff = ((~torch.isnan(vals)) & sel).sum(0, dtype=torch.int32)
    return vals, hi, lo, eff


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------

_DECLARED = False


def _lib():
    global _DECLARED
    lib = load(_SOURCE)
    if not _DECLARED:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_stats_launch.argtypes = [p] * 17 + [i] * 7 + [
            ctypes.c_float, i, p,
        ]
        lib.fused_stats_launch.restype = i
        lib.fused_stats_tier.argtypes = [i, i, i]
        lib.fused_stats_tier.restype = i
        lib.fused_stats_error_string.argtypes = [i]
        lib.fused_stats_error_string.restype = ctypes.c_char_p
        _DECLARED = True
    return lib


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _launch(tc, tn, tdT, disc, idx, pvalid, obs, net_beta, n_iter, counts):
    dev = tc.device
    B, K, cap = (int(d) for d in idx.shape)
    n = int(tc.shape[-1])
    s = int(tdT.shape[-1]) if tdT is not None else 0
    kind, beta = _net_spec(tn, net_beta)
    f32, i32 = torch.float32, torch.int32
    ptr = {
        "tc": _check(tc, "tc", f32, (n, n), dev),
        "tn": None if tn is None else _check(tn, "tn", f32, (n, n), dev),
        "tdT": None if tdT is None else _check(tdT, "tdT", f32, (n, s), dev),
        "idx": _check(idx, "idx", i32, (B, K, cap), dev),
    }
    for field in ("corr", "sign_corr"):
        ptr[field] = _check(getattr(disc, field), f"disc.{field}", f32,
                            (K, cap, cap), dev)
    for field in ("degree", "contrib", "sign_contrib", "mask"):
        ptr[field] = _check(getattr(disc, field), f"disc.{field}", f32,
                            (K, cap), dev)
    vals = torch.empty((B, K, N_STATS), dtype=f32, device=dev)
    # per cell: the anchor and the summary profile, s floats each
    ws = None if tdT is None else torch.empty((B * K * 2 * s,), dtype=f32,
                                              device=dev)
    tallies = [None, None, None]
    if counts:
        ptr["pvalid"] = _check(pvalid, "pvalid", i32, (B,), dev)
        ptr["obs"] = _check(obs, "obs", f32, (K, N_STATS), dev)
        tallies = [torch.zeros((K, N_STATS), dtype=i32, device=dev)
                   for _ in range(3)]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_stats_launch(
            ptr["tc"], ptr["tn"], ptr["tdT"], ptr["corr"], ptr["sign_corr"],
            ptr["degree"], ptr["contrib"], ptr["sign_contrib"], ptr["mask"],
            ptr["idx"], ptr.get("pvalid"), ptr.get("obs"), vals.data_ptr(),
            *(None if t is None else t.data_ptr() for t in tallies),
            None if ws is None else ws.data_ptr(), n, s, B, K, cap,
            int(n_iter), kind, float(beta), int(counts), stream,
        )
    if rc != 0:
        msg = lib.fused_stats_error_string(rc).decode()
        raise RuntimeError(f"fused_stats kernel launch failed: {msg} ({rc})")
    return vals, tallies


def _route(tc) -> str:
    """``"plain"`` for CPU tensors, ``"kernel"`` for CUDA ones."""
    if tc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tc.device} for fused_stats")
    return "plain" if tc.device.type == "cpu" else "kernel"


def kernel_tier(cap: int, s: int, has_data: bool) -> str:
    """How the kernel runs the power iteration of a ``cap``-node bucket with
    ``s`` samples (one of :data:`TIERS`): on the node-space Gram matrix
    (``cap <= s``), on the sample-space one (``s < cap``), or streamed from
    the data rows where neither fits in a block's shared memory. Needs the
    built kernel."""
    return TIERS[_lib().fused_stats_tier(cap, s, int(has_data))]


def fused_stats_values(tc, tn, tdT, disc, idx, *, net_beta=None,
                       n_iter: int = 60) -> torch.Tensor:
    """Materialized-mode entry point: the seven statistics of every
    ``(b, k)`` cell of the ``(B, K, cap)`` int32 index batch, as ``(B, K,
    7)`` float32. ``tc``/``tn`` ``(n, n)`` float32, ``tdT`` ``(n, s)``
    float32 (the transposed data), ``disc`` the bucket's ``(K, …)``
    :class:`~netrep_tpu_torch.ops.stats.DiscProps`."""
    if _route(tc) == "plain":
        return fused_stats_values_plain(tc, tn, tdT, disc, idx,
                                        net_beta=net_beta, n_iter=n_iter)
    vals, _ = _launch(tc, tn, tdT, disc, idx, None, None, net_beta, n_iter,
                      counts=False)
    fused_stats_values.launches += 1
    return vals


def fused_stats_counts(tc, tn, tdT, disc, idx, pvalid, obs, *, net_beta=None,
                       n_iter: int = 60):
    """Streaming-mode entry point: as :func:`fused_stats_values`, plus the
    exceedance tallies against ``obs`` ``(K, 7)`` float32, gated per
    permutation by ``pvalid`` ``(B,)`` int32. Returns ``(values, hi, lo,
    eff)`` with int32 ``(K, 7)`` tallies."""
    if _route(tc) == "plain":
        return fused_stats_counts_plain(tc, tn, tdT, disc, idx, pvalid, obs,
                                        net_beta=net_beta, n_iter=n_iter)
    vals, (hi, lo, eff) = _launch(tc, tn, tdT, disc, idx, pvalid, obs,
                                  net_beta, n_iter, counts=True)
    fused_stats_counts.launches += 1
    return vals, hi, lo, eff


# ---------------------------------------------------------------------------
# Ring exchange (row-sharded path)
# ---------------------------------------------------------------------------

def ring_shift_collective(blocks, devices=None) -> list:
    """Plain version of :func:`ring_shift_dma`: rotate the ring's block
    list by one, so that shard j's block ends at shard ``j + 1`` (mod R) —
    what ``lax.ppermute`` with ``perm=[(j, (j + 1) % R)]`` does in the JAX
    package. ``devices[j]`` is shard j's device (default: where each block
    lies); a block already there is not copied."""
    R = len(blocks)
    devices = [b.device for b in blocks] if devices is None else devices
    return [blocks[(j - 1) % R].to(devices[j]) for j in range(R)]


_RING_DECLARED = False
_PEERS: set[tuple[int, int]] = set()


def _ring_lib():
    global _RING_DECLARED
    lib = load(_RING_SOURCE)
    if not _RING_DECLARED:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ring_shift_launch.argtypes = [p, p, ctypes.c_longlong, i, p]
        lib.ring_shift_launch.restype = i
        lib.ring_shift_enable_peer.argtypes = [i, i]
        lib.ring_shift_enable_peer.restype = i
        lib.ring_shift_error_string.argtypes = [i]
        lib.ring_shift_error_string.restype = ctypes.c_char_p
        _RING_DECLARED = True
    return lib


def _enable_peer(lib, src: int, dst: int) -> None:
    """Let card ``src`` store into card ``dst``, once per pair; raise when
    the pair has no peer path (the ring never copies through the host)."""
    if (src, dst) in _PEERS:
        return
    rc = lib.ring_shift_enable_peer(src, dst)
    if rc == -1:
        raise RuntimeError(
            f"cards cuda:{src} and cuda:{dst} cannot reach each other's "
            "memory (cudaDeviceCanAccessPeer is false): a mesh across them "
            "cannot run the row ring"
        )
    if rc != 0:
        msg = lib.ring_shift_error_string(rc).decode()
        raise RuntimeError(f"enabling peer access failed: {msg} ({rc})")
    _PEERS.add((src, dst))


def _ring_launch(src: torch.Tensor, dst_dev: torch.device) -> torch.Tensor:
    """One kernel launch: a copy of ``src`` in a new buffer on ``dst_dev``,
    written by the source card."""
    _check(src, "block", torch.float32, tuple(src.shape), src.device)
    lib = _ring_lib()
    cross = dst_dev != src.device
    if cross:
        _enable_peer(lib, src.device.index, dst_dev.index)
    dst = torch.empty(src.shape, dtype=src.dtype, device=dst_dev)
    s_src = torch.cuda.current_stream(src.device)
    if cross:
        # the source card writes dst only once the destination stream is
        # done with whatever last used that memory
        s_dst = torch.cuda.current_stream(dst_dev)
        ready = torch.cuda.Event()
        ready.record(s_dst)
        s_src.wait_event(ready)
    rc = lib.ring_shift_launch(src.data_ptr(), dst.data_ptr(), src.numel(),
                               src.device.index, s_src.cuda_stream)
    if rc != 0:
        msg = lib.ring_shift_error_string(rc).decode()
        raise RuntimeError(f"ring_shift kernel launch failed: {msg} ({rc})")
    if cross:
        # the counterpart of the send/recv semaphores: the destination card
        # reads the block only after the copy
        sent = torch.cuda.Event()
        sent.record(s_src)
        s_dst.wait_event(sent)
    return dst


def ring_shift_dma(blocks, devices=None) -> list:
    """One ring step: shard j's ``(rows_per, n)`` float32 block copied into
    a new buffer on shard ``j + 1``'s device (mod R) by the hand-written
    kernel, one launch per block, each counted in
    ``ring_shift_dma.launches``; returns the new list, shard by shard.
    ``devices[j]`` is shard j's device (default: where each block lies).
    CPU blocks run the plain version; CUDA blocks launch the kernel or
    raise — across cards without peer access too."""
    R = len(blocks)
    devices = [b.device for b in blocks] if devices is None else [
        torch.device(d) for d in devices]
    types = {b.device.type for b in blocks} | {d.type for d in devices}
    if types == {"cpu"}:
        return ring_shift_collective(blocks, devices)
    if types != {"cuda"}:
        raise ValueError(
            f"ring_shift_dma needs every block and shard on CUDA cards (or "
            f"all on the CPU), got {sorted(types)}"
        )
    out = [None] * R
    for j, blk in enumerate(blocks):
        out[(j + 1) % R] = _ring_launch(blk, devices[(j + 1) % R])
        ring_shift_dma.launches += 1
    return out


def ring_gather_all(mats, idx_lists, rows_per: int, devices=None) -> list:
    """Assemble full ``(..., cap, cap)`` submatrices from row-sharded
    matrices by streaming the row blocks around one ring of R shards (the
    JAX package's ``ring_gather_all``, for every shard of the ring at
    once). Each shard's outputs are allocated once, uninitialized; at step
    t shard j holds the block first owned by shard ``(j - t) mod R`` and
    writes the rows that block owns, for every bucket at once, in place
    (:func:`~netrep_tpu_torch.ops.fused_gather.gather_submatrix_fused_many`
    with ``out=``: one launch per step, shard and matrix; the step holding
    rows from 0 also zeroes the sentinel rows); then the blocks move one
    shard on (:func:`ring_shift_dma`). After R steps every entry has been
    written exactly once, so the assembly is exact — equal to the
    replicated gather bit for bit. Each step's blocks replace the previous
    step's, which are then free.

    ``mats``: one list of R blocks per matrix, block j ``(rows_per, n)``
    holding global rows ``[j * rows_per, (j + 1) * rows_per)`` on shard j
    (the R blocks cover all n rows); ``idx_lists[j]``: shard j's ``(...,
    cap)`` GLOBAL index batch per bucket, on its device; ``devices[j]``:
    shard j's device. Returns ``subs[j][mat][bucket]`` on shard j's
    device."""
    from .fused_gather import gather_submatrix_fused_many

    R = len(idx_lists)
    subs = [[[torch.empty(ix.shape + ix.shape[-1:], dtype=torch.float32,
                          device=ix.device) for ix in idx_lists[j]]
             for _ in mats] for j in range(R)]
    rings = [list(m) for m in mats]
    for t in range(R):
        for j in range(R):
            row_start = ((j - t) % R) * rows_per
            for mi, ring in enumerate(rings):
                gather_submatrix_fused_many(ring[j], idx_lists[j], row_start,
                                            out=subs[j][mi])
        if t < R - 1:
            rings = [ring_shift_dma(ring, devices) for ring in rings]
    return subs


fused_stats_values.launches = 0
fused_stats_counts.launches = 0
ring_shift_dma.launches = 0

#: the wrappers whose ``launches`` attribute counts kernel launches
KERNELS = (fused_stats_values, fused_stats_counts, ring_shift_dma)
