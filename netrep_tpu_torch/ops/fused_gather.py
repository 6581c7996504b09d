"""Batched submatrix gather ``M[idx[..., a], idx[..., b]]`` with sentinel
slots, in one CUDA kernel launch.

The port of ``netrep_tpu/ops/fused_gather.py`` (``gather_submatrix_fused``
and ``gather_submatrix_fused_local``, the Pallas gather). On a CUDA tensor
each wrapper launches ``csrc/fused_gather.cu`` (design notes in the source)
or raises; on a CPU tensor it runs the plain version beside it, a torch
advanced-index gather masked with ``torch.where``. Nothing falls back from
one to the other. Both are exact copies, so the kernel equals its plain
version bit for bit; there is no ``exact`` switch (the JAX package's hi/lo
split undoes the TPU matrix unit's bf16 rounding, which a copy never has).

Contracts, as in the JAX package:

- a slot whose index is negative or ``>= n`` is a sentinel: its output row
  and column are zero;
- the local entry reads only the rows ``row_start <= idx < row_start +
  rows_per`` of a row block; its output is that block's additive share,
  and the sum over the row blocks is the replicated gather.

Each wrapper counts its kernel launches in a plain integer attribute
(``gather_submatrix_fused.launches``); the plain version and the CPU path
never count.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load
from .fused_stats import _check

_SOURCE = "fused_gather"


def _gather_plain(M, idx, row_start: int, own_limit: int) -> torch.Tensor:
    """The gather over a block ``M`` that holds rows ``[row_start, row_start
    + rows_per)``: slot a's row is owned iff ``0 <= idx[a] - row_start <
    rows_per`` and ``idx[a] < own_limit``, column b is valid iff ``0 <=
    idx[b] < n_cols``; every other entry is 0 by select."""
    rows_per, n_cols = M.shape
    col = idx.long()
    rel = col - int(row_start)
    own = (rel >= 0) & (rel < rows_per) & (col < own_limit)
    cvalid = (col >= 0) & (col < n_cols)
    sub = M[torch.where(own, rel, 0)[..., :, None],
            torch.where(cvalid, col, 0)[..., None, :]]
    keep = own[..., :, None] & cvalid[..., None, :]
    return torch.where(keep, sub, torch.zeros((), dtype=M.dtype,
                                              device=M.device))


def gather_submatrix_fused_plain(M, idx) -> torch.Tensor:
    """Plain version of :func:`gather_submatrix_fused`: ``(..., cap,
    cap)`` float32."""
    return _gather_plain(M, idx, 0, M.shape[0])


def gather_submatrix_fused_local_plain(block, idx, row_start) -> torch.Tensor:
    """Plain version of :func:`gather_submatrix_fused_local`."""
    return _gather_plain(block, idx, int(row_start), block.shape[1])


_DECLARED = False


def _lib():
    global _DECLARED
    lib = load(_SOURCE)
    if not _DECLARED:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_gather_launch.argtypes = [p, p, p, i, i, i,
                                            ctypes.c_longlong, i, i, p]
        lib.fused_gather_launch.restype = i
        lib.fused_gather_error_string.argtypes = [i]
        lib.fused_gather_error_string.restype = ctypes.c_char_p
        _DECLARED = True
    return lib


def _route(M, idx) -> str:
    """Checks shared by both devices, then ``"plain"`` for CPU tensors and
    ``"kernel"`` for CUDA ones."""
    if M.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {M.device} for fused_gather")
    if M.dtype != torch.float32:
        raise ValueError(
            f"M has dtype {M.dtype}, expected torch.float32 (bf16 storage "
            "is not ported yet)"
        )
    if M.dim() != 2:
        raise ValueError(f"M must be 2-D, got shape {tuple(M.shape)}")
    if idx.dim() < 1 or idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise ValueError(
            f"idx must be an integer tensor of shape (..., cap), got "
            f"{idx.dtype} {tuple(idx.shape)}"
        )
    if idx.device != M.device:
        raise ValueError(f"idx is on {idx.device}, expected {M.device}")
    return "plain" if M.device.type == "cpu" else "kernel"


def _launch(M, idx, row_start: int, own_limit: int) -> torch.Tensor:
    dev = M.device
    rows_per, n_cols = (int(d) for d in M.shape)
    batch, cap = tuple(idx.shape[:-1]), int(idx.shape[-1])
    flat = idx.reshape(-1, cap).to(torch.int32).contiguous()
    G = int(flat.shape[0])
    m_ptr = _check(M, "M", torch.float32, (rows_per, n_cols), dev)
    out = torch.empty((G, cap, cap), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_gather_launch(m_ptr, flat.data_ptr(), out.data_ptr(),
                                     G, cap, n_cols, int(row_start), rows_per,
                                     int(own_limit), stream)
    if rc != 0:
        msg = lib.fused_gather_error_string(rc).decode()
        raise RuntimeError(f"fused_gather kernel launch failed: {msg} ({rc})")
    return out.reshape(*batch, cap, cap)


def gather_submatrix_fused(M, idx) -> torch.Tensor:
    """Batched gather over a whole ``(n, n)`` float32 matrix:
    ``out[..., a, b] = M[idx[..., a], idx[..., b]]`` for an integer ``idx``
    ``(..., cap)``, sentinel slots (``< 0`` or ``>= n``) giving zero rows
    and columns. Returns float32 ``(..., cap, cap)``."""
    if _route(M, idx) == "plain":
        return gather_submatrix_fused_plain(M, idx)
    out = _launch(M, idx, 0, M.shape[0])
    gather_submatrix_fused.launches += 1
    return out


def gather_submatrix_fused_local(block, idx, row_start) -> torch.Tensor:
    """The gather restricted to one row block ``(rows_per, n)`` that holds
    global rows ``[row_start, row_start + rows_per)``: ``idx`` carries
    GLOBAL indices, rows outside the block are zero, columns are global.
    The sum of the results over all row blocks is
    :func:`gather_submatrix_fused` of the whole matrix."""
    if _route(block, idx) == "plain":
        return gather_submatrix_fused_local_plain(block, idx, row_start)
    out = _launch(block, idx, int(row_start), block.shape[1])
    gather_submatrix_fused_local.launches += 1
    return out


gather_submatrix_fused.launches = 0
gather_submatrix_fused_local.launches = 0

#: the wrappers whose ``launches`` attribute counts kernel launches
KERNELS = (gather_submatrix_fused, gather_submatrix_fused_local)
