"""Null-distribution checkpoint/resume.

A copy of ``netrep_tpu/utils/checkpoint.py``'s format and checks: one
``.npz`` with the partial null array, the completion counter, the key
data of the permutation stream and a fingerprint of the problem. The
per-permutation keys are ``fold_in(key, i)``, independent of chunk size
and mesh, so a resumed run equals an uninterrupted one, and the format,
key data and fingerprint are the JAX package's: either package resumes
the other's checkpoint of the same problem and seed.

The telemetry and detector hooks of the JAX module, its background
writer (``AsyncCheckpointWriter``) and its degraded-rebuild acceptance
scope belong to ROADMAP.md Queue 1 item 16 (fault policy, telemetry).
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np
import torch

#: the JAX package's version 4: the fingerprint digests the original
#: inputs, so it does not depend on mesh shape, sharding or padding
_FORMAT_VERSION = 4

#: elements sampled per array by :func:`content_digest`
_SAMPLE = 4096


class Stack:
    """The arrays of ``parts`` stacked on a new first axis, as
    :func:`content_digest` sees ``np.stack(parts)`` — without stacking
    them: only the sampled elements are read, each where its part lies."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.shape = (len(self.parts),) + tuple(self.parts[0].shape)
        self.dtype = self.parts[0].dtype


def _dtype_name(dtype) -> str:
    """numpy's name of a numpy or torch dtype (``torch.float32`` →
    ``float32``)."""
    return str(dtype).replace("torch.", "")


def _take(a, flat_idx: np.ndarray) -> np.ndarray:
    """``a.reshape(-1)[flat_idx]`` as float64 on the host, gathered where
    ``a`` lives: a matrix on the card is never copied whole, and a
    non-contiguous one is never copied at all."""
    if isinstance(a, Stack):
        per = int(np.prod(a.shape[1:]))
        out = np.empty(flat_idx.size)
        which = flat_idx // max(per, 1)
        for i, part in enumerate(a.parts):
            sel = which == i
            if sel.any():
                out[sel] = _take(part, flat_idx[sel] - i * per)
        return out
    coords = np.unravel_index(flat_idx, tuple(a.shape))
    if isinstance(a, torch.Tensor):
        ix = tuple(torch.as_tensor(c, device=a.device) for c in coords)
        return a[ix].to(torch.float64).cpu().numpy()
    return np.asarray(np.asarray(a)[coords], dtype=np.float64)


def content_digest(arrays, dtype: str | None = None) -> str:
    """Cheap content digest of problem matrices, equal to the JAX
    package's for the same arrays: shapes, type names and a strided sample
    of up to 4,096 elements per array (numpy arrays, tensors on any
    device, or a :class:`Stack`). ``dtype`` names every array's type
    instead of its own, for arrays the JAX package would hold widened
    (its datasets hold float64); the sample is hashed as float64 either
    way."""
    h = hashlib.blake2b(digest_size=8)
    for a in arrays:
        if a is None:
            h.update(b"-")
            continue
        shape = tuple(int(s) for s in a.shape)
        h.update(str(shape).encode()
                 + (dtype or _dtype_name(a.dtype)).encode())
        size = int(np.prod(shape))
        step = max(1, size // _SAMPLE)
        idx = np.arange(0, size, step, dtype=np.int64)[:_SAMPLE]
        h.update(_take(a, idx).tobytes())
    return h.hexdigest()


def engine_fingerprint(engine) -> np.ndarray:
    """Structural and sampled-content fingerprint of an engine's problem:
    module labels and sizes, pool, data presence and the content digest
    of its original inputs (``engine.fingerprint_digest()``) — the JAX
    package's fingerprint, byte for byte."""
    parts = [str(_FORMAT_VERSION), str(int(engine.has_data))]
    for m in engine.modules:
        parts.append(f"{m.label}:{m.size}")
    pool = np.asarray(engine.pool)
    parts.append(f"pool:{pool.size}:{int(np.sum(pool)) & 0xFFFFFFFF}")
    parts.append("digest:" + str(engine.fingerprint_digest()))
    return np.frombuffer("|".join(parts).encode(), dtype=np.uint8)


def atomic_savez(path: str, **arrays) -> None:
    """Atomically write a compressed ``.npz``: ``mkstemp`` in the target
    directory and ``os.replace``, so an interrupt or a concurrent writer
    never corrupts an existing file."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_null_checkpoint(path: str, nulls: np.ndarray, completed: int,
                         key_data: np.ndarray, fingerprint: np.ndarray,
                         extra: dict | None = None) -> None:
    """Atomically persist a (possibly partial) null array. ``extra`` maps
    names to arrays of auxiliary loop state (the adaptive loops' monitor
    tallies and retired set, the streaming loops' tallies), stored under
    ``x_``-prefixed keys. The JAX package's optional background writer
    is ROADMAP.md Queue 1 item 16."""
    extras = {f"x_{k}": np.asarray(v) for k, v in (extra or {}).items()}
    _save_sync(path, np.asarray(nulls), completed, key_data, fingerprint,
               extras)


def _save_sync(path, nulls, completed, key_data, fingerprint, extras):
    """The checkpoint write (its telemetry event is item 16)."""
    atomic_savez(
        path,
        version=np.int64(_FORMAT_VERSION),
        nulls=nulls,
        completed=np.int64(completed),
        key_data=np.asarray(key_data),
        fingerprint=fingerprint,
        **extras,
    )


def load_null_checkpoint(path: str) -> dict | None:
    """Load a checkpoint, or ``None`` when the file doesn't exist."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if "version" not in z.files:
            raise ValueError(
                f"{path!r} is not a null checkpoint (no version marker — "
                "saved PreservationResult files and other .npz files cannot "
                "be resumed from)"
            )
        if int(z["version"]) != _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path!r} has format version {int(z['version'])}, "
                f"this build reads version {_FORMAT_VERSION}"
            )
        return {
            "nulls": z["nulls"],
            "completed": int(z["completed"]),
            "key_data": z["key_data"],
            "fingerprint": z["fingerprint"],
            "extras": {k[2:]: z[k] for k in z.files if k.startswith("x_")},
        }


def validate_identity(ckpt: dict, key_data: np.ndarray,
                      fingerprint: np.ndarray, path: str) -> None:
    """Problem and seed identity checks shared by the materialized and
    streaming resume paths; raises the JAX package's ``ValueError`` on a
    mismatch."""
    fp = ckpt["fingerprint"]
    if fp.shape != fingerprint.shape or not np.array_equal(fp, fingerprint):
        raise ValueError(
            f"checkpoint {path!r} was written for a different problem "
            "(module set, sizes, pool, data presence, or store_nulls "
            "mode differ); refusing to resume — delete the file or "
            "point elsewhere"
        )
    kd = np.asarray(ckpt["key_data"])
    if (kd.shape != np.asarray(key_data).shape
            or not np.array_equal(kd, key_data)):
        raise ValueError(
            f"checkpoint {path!r} was written with a different PRNG key/seed; "
            "resuming would splice two different null distributions — use the "
            "original seed or delete the checkpoint"
        )


def validate_resume(ckpt: dict, n_perm: int, key_data: np.ndarray,
                    fingerprint: np.ndarray, path: str, perm_axis: int = 0
                    ) -> tuple[np.ndarray, int]:
    """Check a loaded checkpoint against the current run; returns
    ``(nulls_init, start_perm)``, the null grown (NaN) or cut to
    ``n_perm`` along ``perm_axis``."""
    validate_identity(ckpt, key_data, fingerprint, path)
    nulls = ckpt["nulls"]
    if nulls.shape[perm_axis] < n_perm:
        shape = list(nulls.shape)
        shape[perm_axis] = n_perm
        grown = np.full(shape, np.nan)
        sel = [slice(None)] * nulls.ndim
        sel[perm_axis] = slice(0, nulls.shape[perm_axis])
        grown[tuple(sel)] = nulls
        nulls = grown
    elif nulls.shape[perm_axis] > n_perm:
        sel = [slice(None)] * nulls.ndim
        sel[perm_axis] = slice(0, n_perm)
        nulls = nulls[tuple(sel)].copy()
    completed = min(int(ckpt["completed"]), n_perm)
    return nulls, completed
