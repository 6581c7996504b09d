"""Engine configuration and device resolution for the port.

:class:`EngineConfig` holds the subset of ``netrep_tpu.utils.config
.EngineConfig`` that the dense main path reads, with the same defaults and
the same bucket-capacity rule, so both packages bucket modules identically.
"""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``. There
    is no fallback — without a card the call raises, and the CPU runs only
    when the caller asks for it by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Tuning knobs of the permutation engine.

    Attributes
    ----------
    chunk_size : permutations drawn and evaluated per chunk; the unit of
        progress reporting and of the host transfer of the materialized
        null.
    summary_method : summary-profile method of the null statistics. Only
        ``'power'`` (the fixed-count power iteration the fused-statistics
        kernel runs) is accepted; the observed pass always uses exact
        ``eigh``.
    power_iters : fixed power-iteration count of the null statistics.
    bucket_rounding, cap_granularity : bucket capacity rule
        (:meth:`rounded_cap`), identical to the JAX package's.
    dtype : storage type of the test matrices; ``'float32'`` only (bf16
        storage is a later slice).
    superchunk : streaming null only: chunks whose tallies accumulate on
        the device between two host reads (and progress calls); None means
        8, the JAX package's fallback.

    A chunk runs as one kernel launch per bucket: a CUDA launch compiles
    nothing per shape, so the JAX package's per-batch scan and its padding
    have no work to do here.
    """

    chunk_size: int = 128
    summary_method: str = "power"
    power_iters: int = 60
    bucket_rounding: int = 8
    cap_granularity: int = 32
    dtype: str = "float32"
    superchunk: int | None = None

    def __post_init__(self):
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size!r}")
        if self.summary_method != "power":
            raise ValueError(
                "the fused-statistics kernel computes coherence with the "
                "fixed-count power iteration; summary_method="
                f"{self.summary_method!r} is not kernel-supported — use "
                "summary_method='power'"
            )
        if self.dtype != "float32":
            raise ValueError(
                f"dtype must be 'float32' in this port, got {self.dtype!r}"
            )
        if self.cap_granularity < 8 or self.cap_granularity % 8:
            raise ValueError(
                "cap_granularity must be a multiple of 8 (sublane "
                f"alignment), >= 8; got {self.cap_granularity!r}"
            )
        if self.superchunk is not None and self.superchunk < 1:
            raise ValueError(
                f"superchunk must be >= 1 or None, got {self.superchunk!r}"
            )

    @property
    def resolved_superchunk(self) -> int:
        return 8 if self.superchunk is None else self.superchunk

    def rounded_cap(self, size: int) -> int:
        """Bucket capacity for a module of ``size`` nodes: powers of two up
        to ``max(32, cap_granularity)``, then multiples of
        ``cap_granularity``."""
        g = self.cap_granularity
        cap = self.bucket_rounding
        while cap < size and cap < max(32, g):
            cap *= 2
        if size <= cap:
            return cap
        return -(-size // g) * g
