"""Warm engine pool of the serving tier.

The port of ``netrep_tpu/serve/pool.py``. Building an engine copies the
test pair to the card, computes every bucket's discovery props and (on the
first use in a process) builds or loads the kernels; a steady stream of
requests of one shape should pay that once. The pool keeps ENGINE
INSTANCES — their device tensors, bucket structure and index layout —
keyed by the pack's structural signature
(:meth:`~netrep_tpu_torch.serve.packer.RequestPlan.signature` per member,
the dataset-pair digests and the engine-config identity), so a repeated
shape hits a warm engine and copies nothing.

Eviction is LRU, with :meth:`~netrep_tpu_torch.parallel.engine.
PermutationEngine.release` on the way out, so a bounded pool never
accumulates device memory: the superseded engine's tensors are dropped
before the next build allocates.

The engines over one registration share its test matrices: the
scheduler takes them from :func:`device_copy`, one device copy per
(registration host copy, storage type, device) in the process, which
lives while an engine holds it (or a view of it) and is freed with the
last.
:meth:`ProgramPool.stats` reports what the pooled engines hold
(``held_gib``): each tensor storage counted once across the pool, as it
was when its engine entered the pool.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import weakref

import torch


def held_storages(engine) -> dict[tuple, int]:
    """``{(device index, data pointer): bytes}`` of the distinct tensor
    storages an engine holds on a CUDA device, found by walking its
    attributes (lists, tuples, dicts and dataclasses included); empty for
    an engine on the CPU."""
    seen_obj: set[int] = set()
    seen_store: dict[tuple, int] = {}
    stack = [engine]
    while stack:
        obj = stack.pop()
        if id(obj) in seen_obj:
            continue
        seen_obj.add(id(obj))
        if isinstance(obj, torch.Tensor):
            if obj.device.type != "cuda":
                continue
            st = obj.untyped_storage()
            seen_store[(obj.device.index, st.data_ptr())] = st.nbytes()
            continue
        if isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            stack.extend(getattr(obj, f.name) for f in dataclasses.fields(obj))
        elif hasattr(obj, "__dict__") and not isinstance(obj, type):
            stack.extend(vars(obj).values())
    return seen_store


def held_bytes(engine) -> int:
    """Bytes of the distinct tensor storages an engine holds on a CUDA
    device (:func:`held_storages`); 0 for an engine on the CPU."""
    return sum(held_storages(engine).values())


class SharedCopies:
    """Tensors that the servers of one process share, one tuple per key:
    :meth:`get` hands out the held tuple while its holders keep every
    tensor of it alive (references are weak, and a view keeps its base)
    and ``fits`` accepts it, and builds a new one otherwise, so a copy is
    freed with its last holder. Module-level instances, because a fleet's
    in-process replicas are servers the process builds apart:
    :data:`DEVICE_COPIES` and the scheduler's ``HOST_COPIES``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._refs: dict = {}

    def get(self, key, build, fits=None) -> tuple:
        """The tuple held for ``key`` (None for a field it lacks) if every
        tensor of it is alive and ``fits(held)`` (when given) is true,
        else ``build()``'s tuple, held for ``key`` from then on. ``fits``
        and ``build`` run under the lock."""
        with self._lock:
            refs = self._refs.get(key, ())
            got = tuple(None if r is None else r() for r in refs)
            if (not refs
                    or any(g is None and r is not None
                           for g, r in zip(got, refs))
                    or (fits is not None and not fits(got))):
                got = tuple(build())
                self._refs[key] = tuple(
                    None if t is None else weakref.ref(t) for t in got)
            # forget the copies nothing holds any more
            for k in [k for k, rs in self._refs.items()
                      if all(r is None or r() is None for r in rs)]:
                del self._refs[k]
        return got

    def live(self) -> list:
        """The tensors held now."""
        with self._lock:
            found = [r() for rs in self._refs.values() for r in rs
                     if r is not None]
        return [t for t in found if t is not None]


#: the device copies of registrations' test matrices that pooled engines
#: share (:func:`device_copy`)
DEVICE_COPIES = SharedCopies()


def device_copy(dataset, dtype: torch.dtype, device: torch.device) -> tuple:
    """``(correlation, network, data)`` of a checked registration
    ``dataset`` (a :class:`~netrep_tpu_torch.models.dataset.Dataset`,
    float32 on the host) on ``device`` in the storage type ``dtype`` (None
    where the dataset has none), shared through :data:`DEVICE_COPIES` by
    every engine built over the same host tensors: one copy per (host
    copy, storage type, device) in the process, freed with the last
    engine that holds it (LRU eviction, ``discard``, a dead replica's pool
    release, ``close()``). Keyed on the host tensors themselves, so the
    copy follows the scheduler's ``HOST_COPIES``, which checks content.
    The data is held transposed and contiguous, as an engine keeps it,
    and handed out as its ``(samples, n)`` view."""
    sources = (dataset.correlation, dataset.network, dataset.data)

    def build():
        copies = [None if t is None else t.to(
            device=device, dtype=torch.float32).to(dtype)
            for t in sources]
        if copies[2] is not None:
            copies[2] = copies[2].T.contiguous()
        # the sources ride along, weakly, so a reused id cannot match
        return (*copies, *sources)

    key = (tuple(id(t) for t in sources), str(dtype), str(device))
    got = DEVICE_COPIES.get(key, build, lambda held: all(
        h is s for h, s in zip(held[3:], sources)))
    return got[0], got[1], None if got[2] is None else got[2].T


class ProgramPool:
    """LRU pool of warm engines. Thread-safe; builders run under the lock
    (the scheduler has one worker, so contention is registration-only)."""

    def __init__(self, max_size: int = 8):
        self.max_size = int(max_size)
        self._lru: "collections.OrderedDict[tuple, object]" = (
            collections.OrderedDict()
        )
        #: per pooled key, the storages its engine held on entry
        self._held: dict[tuple, dict] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._lru)

    def get(self, key, builder):
        """Return ``(engine, hit)`` — the pooled engine for ``key``, or a
        fresh ``builder()`` result (cached unless the pool is disabled
        with ``max_size=0``). Evicts least-recently-used engines above
        ``max_size``, releasing their device tensors first."""
        with self._lock:
            eng = self._lru.pop(key, None)
            hit = eng is not None
            if eng is None:
                self.misses += 1
                eng = builder()
            else:
                self.hits += 1
            if self.max_size > 0:
                if not hit:
                    self._held[key] = held_storages(eng)
                self._lru[key] = eng
                while len(self._lru) > self.max_size:
                    old_key, old = self._lru.popitem(last=False)
                    self.evictions += 1
                    del self._held[old_key]
                    _release(old)
            return eng, hit

    def discard(self, key) -> None:
        """Drop (and release) one pooled engine — the scheduler evicts an
        engine whose run just failed rather than reuse suspect device
        state."""
        with self._lock:
            old = self._lru.pop(key, None)
            self._held.pop(key, None)
        if old is not None:
            _release(old)

    def clear(self) -> None:
        """Release every pooled engine (service drain/shutdown)."""
        with self._lock:
            while self._lru:
                _, old = self._lru.popitem(last=False)
                _release(old)
            self._held.clear()

    def _storages(self) -> dict[tuple, int]:
        """The storages the pooled engines held on entry, each once."""
        with self._lock:
            union: dict[tuple, int] = {}
            for held in self._held.values():
                union.update(held)
            return union

    def stats(self) -> dict:
        """``size``, ``hits``, ``misses``, ``evictions`` (the JAX
        package's keys) and ``held_gib``: the device memory the pooled
        engines held when each entered the pool, a storage two engines
        share (a registration's :func:`device_copy`) counted once."""
        held = sum(self._storages().values()) / 2**30
        with self._lock:
            return {
                "size": len(self._lru),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "held_gib": held,
            }


def _release(engine) -> None:
    rel = getattr(engine, "release", None)
    if rel is not None:
        rel()
