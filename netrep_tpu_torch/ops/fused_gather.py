"""Batched submatrix gather ``M[idx[..., a], idx[..., b]]`` with sentinel
slots, for every capacity bucket of a chunk in one CUDA kernel launch.

The port of ``netrep_tpu/ops/fused_gather.py`` (``gather_submatrix_fused``
and ``gather_submatrix_fused_local``, the Pallas gather). On a CUDA tensor
each wrapper launches ``csrc/fused_gather.cu`` (design notes in the source:
it walks ``M`` by source row over all buckets at once) or raises; on a CPU
tensor it runs the plain version beside it, a torch advanced-index gather
masked with ``torch.where``. Nothing falls back from one to the other.
Both are exact copies, so the kernel equals its plain version bit for bit;
there is no ``exact`` switch (the JAX package's hi/lo split undoes the TPU
matrix unit's bf16 rounding, which a copy never has).

Contracts, as in the JAX package:

- a slot whose index is negative or ``>= n`` is a sentinel: its output row
  and column are zero;
- the local entry reads only the rows ``row_start <= idx < row_start +
  rows_per`` of a row block; its output is that block's additive share,
  and the sum over the row blocks is the replicated gather.

:func:`gather_submatrix_fused_many` gathers every bucket of a chunk in one
launch and, with ``out=``, writes only the rows its block owns into the
caller's buffers, so one launch per row block assembles the replicated
gather in place (exact: each entry has one writer).

Each wrapper counts its kernel launches in a plain integer attribute
(``gather_submatrix_fused_many.launches``); the plain version and the CPU
path never count.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load
from .fused_stats import _check

_SOURCE = "fused_gather"
#: a work item stages its source row in shared memory when its demand
#: (output rows x cap entries) covers at least 1/STAGE_DIV of the row's
#: 32-byte sectors (the crossover measured on the card, csrc note)
STAGE_DIV = 3
#: which rows a launch writes (``zero_mode`` in the source): all of them,
#: the un-owned as zeros (a block's share); into ``out=``, the owned rows
#: and, in the ``row_start`` 0 launch, the rows no block owns; or only
#: the owned rows
_ZERO_SHARE, _ZERO_ORPHANS, _ZERO_NONE = 0, 1, 2


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


def gather_submatrix_fused_many_plain(M, idx_list, row_start: int = 0,
                                      out=None) -> list:
    """Plain version of :func:`gather_submatrix_fused_many`: the local
    gather per bucket; with ``out``, only the rows the kernel writes are
    copied in (the rest of each buffer is left as it is)."""
    rows_per, n_cols = M.shape
    res = []
    for i, idx in enumerate(idx_list):
        share = _gather_plain(M, idx, row_start, n_cols)
        if out is None:
            res.append(share)
            continue
        col = idx.long()
        rel = col - row_start
        rows = (rel >= 0) & (rel < rows_per) & (col < n_cols)
        if row_start == 0:
            rows |= (col < 0) | (col >= n_cols)
        out[i].copy_(torch.where(rows[..., None], share, out[i]))
        res.append(out[i])
    return res


_DECLARED = False


def _lib():
    global _DECLARED
    lib = load(_SOURCE)
    if not _DECLARED:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_gather_launch.argtypes = [p, p, i, ll, i, i, ll, i, i, i,
                                            p, p]
        lib.fused_gather_launch.restype = i
        lib.fused_gather_scratch_bytes.argtypes = [i, ll]
        lib.fused_gather_scratch_bytes.restype = ll
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


def _run(M, idx_list, row_start: int, own_limit: int, zero_mode: int,
         out) -> tuple[list, bool]:
    """One kernel launch over every bucket of ``idx_list`` (outputs
    allocated here unless ``out`` holds them); returns ``(outputs,
    launched)`` — nothing is launched when no bucket has a row."""
    dev = M.device
    rows_per, n_cols = (int(d) for d in M.shape)
    m_ptr = _check(M, "M", torch.float32, (rows_per, n_cols), dev)
    outs, keep, table, total = [], [], [], 0
    for i, idx in enumerate(idx_list):
        shape = tuple(idx.shape) + (int(idx.shape[-1]),)
        o = (torch.empty(shape, dtype=torch.float32, device=dev)
             if out is None else out[i])
        outs.append(o)
        cap = shape[-1]
        rows = idx.numel()
        if rows == 0:
            continue
        flat = idx.reshape(-1, cap).to(torch.int32).contiguous()
        keep.append(flat)  # alive until the launch is enqueued
        table += [flat.data_ptr(), o.data_ptr(), cap, total]
        total += rows
    if total == 0:
        return outs, False
    lib = _lib()
    with torch.cuda.device(dev):
        # the table rides an asynchronous copy from pinned memory: the host
        # never waits on the card for it
        tab = torch.tensor(table, dtype=torch.int64).pin_memory().to(
            dev, non_blocking=True)
        scratch = torch.empty(lib.fused_gather_scratch_bytes(rows_per, total),
                              dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_gather_launch(
            m_ptr, tab.data_ptr(), len(keep), total, rows_per, n_cols,
            int(row_start), int(own_limit), zero_mode, STAGE_DIV,
            scratch.data_ptr(), stream)
    if rc != 0:
        msg = lib.fused_gather_error_string(rc).decode()
        raise RuntimeError(f"fused_gather kernel launch failed: {msg} ({rc})")
    return outs, True


def _launch(M, idx, row_start: int, own_limit: int) -> torch.Tensor:
    """One bucket's share (every row written, the un-owned as zeros)."""
    return _run(M, [idx], row_start, own_limit, _ZERO_SHARE, None)[0][0]


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


def gather_submatrix_fused_many(M, idx_list, row_start=0, out=None) -> list:
    """The gather of every bucket of a chunk in one launch: for each
    ``(..., cap_b)`` integer index tensor of ``idx_list``, the ``(...,
    cap_b, cap_b)`` float32 gather from ``M`` ``(rows_per, n)``, a block
    holding global rows ``[row_start, row_start + rows_per)`` (the whole
    matrix when ``row_start`` is 0 and ``M`` is square); columns are global.

    Without ``out`` each result is the block's additive share (rows it does
    not own are zero), as :func:`gather_submatrix_fused_local` gives it
    bucket by bucket. With ``out`` (one float32 contiguous buffer per
    bucket, the results' shapes) the launch writes only the rows this
    block owns — and, when ``row_start`` is 0, the rows no block owns
    (sentinels, ``idx >= n``) as zeros — and leaves the rest untouched:
    one launch per block of a partition of rows ``[0, n)`` fills the
    buffers with the replicated gather, each entry written once. Returns
    the results (``out`` itself when given)."""
    idx_list = list(idx_list)
    if not idx_list:
        return []
    routes = {_route(M, idx) for idx in idx_list}
    if out is not None:
        if len(out) != len(idx_list):
            raise ValueError(f"out has {len(out)} buffers for "
                             f"{len(idx_list)} index tensors")
        for i, (o, idx) in enumerate(zip(out, idx_list)):
            _check(o, f"out[{i}]", torch.float32,
                   tuple(idx.shape) + (int(idx.shape[-1]),), M.device)
    row_start = int(row_start)
    if routes == {"plain"}:
        return gather_submatrix_fused_many_plain(M, idx_list, row_start, out)
    zero = (_ZERO_SHARE if out is None
            else _ZERO_ORPHANS if row_start == 0 else _ZERO_NONE)
    outs, launched = _run(M, idx_list, row_start, M.shape[1], zero, out)
    gather_submatrix_fused_many.launches += int(launched)
    return outs


gather_submatrix_fused.launches = 0
gather_submatrix_fused_local.launches = 0
gather_submatrix_fused_many.launches = 0

#: the wrappers whose ``launches`` attribute counts kernel launches
KERNELS = (gather_submatrix_fused_many, gather_submatrix_fused,
           gather_submatrix_fused_local)
