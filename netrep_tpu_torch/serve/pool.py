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
before the next build allocates. At 20,000 genes a pooled engine holds
about 3.3 GiB, so :meth:`ProgramPool.stats` reports what the pooled
engines hold (``held_gib``, counted once per tensor storage when each
engine enters the pool).
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import torch


def held_bytes(engine) -> int:
    """Bytes of the distinct tensor storages an engine holds on a CUDA
    device, found by walking its attributes (lists, tuples, dicts and
    dataclasses included); 0 for an engine on the CPU."""
    seen_obj: set[int] = set()
    seen_store: set[tuple] = set()
    total = 0
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
            key = (obj.device.index, st.data_ptr())
            if key not in seen_store:
                seen_store.add(key)
                total += st.nbytes()
            continue
        if isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            stack.extend(getattr(obj, f.name) for f in dataclasses.fields(obj))
        elif hasattr(obj, "__dict__") and not isinstance(obj, type):
            stack.extend(vars(obj).values())
    return total


class ProgramPool:
    """LRU pool of warm engines. Thread-safe; builders run under the lock
    (the scheduler has one worker, so contention is registration-only)."""

    def __init__(self, max_size: int = 8):
        self.max_size = int(max_size)
        self._lru: "collections.OrderedDict[tuple, object]" = (
            collections.OrderedDict()
        )
        self._held: dict[tuple, int] = {}
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
                    self._held[key] = held_bytes(eng)
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

    def stats(self) -> dict:
        """``size``, ``hits``, ``misses``, ``evictions`` (the JAX
        package's keys) and ``held_gib``: the device memory the pooled
        engines held when each entered the pool."""
        with self._lock:
            return {
                "size": len(self._lru),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "held_gib": sum(self._held.values()) / 2**30,
            }


def _release(engine) -> None:
    rel = getattr(engine, "release", None)
    if rel is not None:
        rel()
