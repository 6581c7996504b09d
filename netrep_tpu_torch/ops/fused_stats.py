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
- :func:`resolve_smem_bytes` raises, before any launch and on both devices,
  for a shape whose resident data slice would not fit in a block's shared
  memory — a configuration is refused, never computed wrongly.

Each wrapper counts its kernel launches in a plain integer attribute
(``fused_stats_values.launches``), so a run can show its path went through
the kernel; the plain version and the CPU path never count.
"""

from __future__ import annotations

import ctypes

import torch

from . import stats as tstats
from ._build import load
from .oracle import N_STATS

#: dynamic shared memory one H100 block may use (232,448 bytes of 256 KB)
SMEM_LIMIT = 232448
_NT = 256
_NWARP = _NT // 32
_NQ_MAX = 8
_NET_KIND = {"unsigned": 0, "signed": 1, "signed-hybrid": 2}
_SOURCE = "fused_stats"


def resolve_smem_bytes(cap: int, s: int, has_data: bool) -> int:
    """Shared memory one kernel block holds for a ``cap``-node bucket with
    ``s`` samples (the layout of ``csrc/fused_stats.cu``: the standardized
    ``cap x s`` data slice plus per-node and per-sample vectors). Raises
    ``ValueError`` past :data:`SMEM_LIMIT`."""
    s1 = max(s, 1)
    floats = (cap * s if has_data else 0) + 4 * cap + 2 * s1 \
        + _NWARP * _NQ_MAX + _NQ_MAX + N_STATS + 1
    nbytes = 4 * floats + 4 * cap
    if nbytes > SMEM_LIMIT:
        raise ValueError(
            f"fused-statistics block needs {nbytes} bytes of shared memory "
            f"(cap {cap}, {s} samples; limit {SMEM_LIMIT}): the module's "
            "data slice does not fit on one streaming multiprocessor — "
            "reduce cap_granularity padding, split the module, or drop "
            "samples"
        )
    return nbytes


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
        lib.fused_stats_launch.argtypes = [p] * 16 + [i] * 7 + [
            ctypes.c_float, i, p,
        ]
        lib.fused_stats_launch.restype = i
        lib.fused_stats_smem_bytes.argtypes = [i, i, i]
        lib.fused_stats_smem_bytes.restype = ctypes.c_size_t
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
            n, s, B, K, cap, int(n_iter), kind, float(beta), int(counts),
            stream,
        )
    if rc != 0:
        msg = lib.fused_stats_error_string(rc).decode()
        raise RuntimeError(f"fused_stats kernel launch failed: {msg} ({rc})")
    return vals, tallies


def _route(tc, tdT, idx) -> str:
    """``"plain"`` for CPU tensors, ``"kernel"`` for CUDA ones; on both, the
    shared-memory guard runs first."""
    if tc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tc.device} for fused_stats")
    resolve_smem_bytes(int(idx.shape[-1]),
                       0 if tdT is None else int(tdT.shape[-1]),
                       tdT is not None)
    return "plain" if tc.device.type == "cpu" else "kernel"


def fused_stats_values(tc, tn, tdT, disc, idx, *, net_beta=None,
                       n_iter: int = 60) -> torch.Tensor:
    """Materialized-mode entry point: the seven statistics of every
    ``(b, k)`` cell of the ``(B, K, cap)`` int32 index batch, as ``(B, K,
    7)`` float32. ``tc``/``tn`` ``(n, n)`` float32, ``tdT`` ``(n, s)``
    float32 (the transposed data), ``disc`` the bucket's ``(K, …)``
    :class:`~netrep_tpu_torch.ops.stats.DiscProps`."""
    if _route(tc, tdT, idx) == "plain":
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
    if _route(tc, tdT, idx) == "plain":
        return fused_stats_counts_plain(tc, tn, tdT, disc, idx, pvalid, obs,
                                        net_beta=net_beta, n_iter=n_iter)
    vals, (hi, lo, eff) = _launch(tc, tn, tdT, disc, idx, pvalid, obs,
                                  net_beta, n_iter, counts=True)
    fused_stats_counts.launches += 1
    return vals, hi, lo, eff


fused_stats_values.launches = 0
fused_stats_counts.launches = 0

#: the wrappers whose ``launches`` attribute counts kernel launches
KERNELS = (fused_stats_values, fused_stats_counts)
