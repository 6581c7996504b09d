"""Engine configuration and device resolution for the port.

:class:`EngineConfig` holds the subset of ``netrep_tpu.utils.config
.EngineConfig`` that the port's dense engines read, with the same names,
defaults, error texts and bucket-capacity rule, so both packages bucket
modules identically.
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
    summary_method : summary-profile method of the null statistics:
        ``'power'`` (the fixed-count power iteration the fused-statistics
        kernel runs) or ``'eigh'`` (exact, ``torch.linalg.eigh``; composed
        statistics only). The observed pass always uses ``eigh``.
    power_iters : fixed power-iteration count of the null statistics.
    bucket_rounding, cap_granularity : bucket capacity rule
        (:meth:`rounded_cap`), identical to the JAX package's.
    dtype : storage type of the test matrices; ``'float32'`` only (bf16
        storage is a later slice).
    gather_mode : accepted for parity with the JAX package (``'auto'``,
        ``'direct'`` or ``'fused'``); every value runs the composed null's
        gathers through :mod:`netrep_tpu_torch.ops.fused_gather`, whose
        kernel and plain version are both exact copies. The JAX package's
        ``'mxu'`` (the TPU's one-hot-matmul workaround) is not ported.
    network_from_correlation : soft-threshold power β when the network is
        the WGCNA construction ``|correlation|**β``, or a ``(β, kind)``
        pair with ``kind`` in ``('unsigned', 'signed', 'signed-hybrid')``.
        The engine then stores no n×n network on the device: network
        submatrices derive from the gathered correlation. The supplied
        networks are sample-checked against the construction at engine
        build (a mismatch raises).
    superchunk : streaming null only: chunks whose tallies accumulate on
        the device between two host reads (and progress calls); None means
        8, the JAX package's fallback.
    mesh_axis : name of the permutation axis of a mesh
        (:func:`netrep_tpu_torch.parallel.mesh.make_mesh`), kept under the
        JAX package's name; a port mesh's axes are always ``('perm',
        'row')``, so ``'perm'`` is the one value accepted.
    matrix_sharding : ``'replicated'`` (every perm shard holds the whole
        test matrices) or ``'row'`` (the n×n matrices are split by rows
        over the mesh's row axis; needs a mesh). Checked by the engine, as
        in the JAX package.
    stat_mode : ``'fused'`` runs the null through the fused-statistics
        kernel (:mod:`netrep_tpu_torch.ops.fused_stats`), ``'xla'`` composes
        it per bucket (gather → standardized data slice →
        ``module_stats_masked``, the JAX package's name for that path),
        ``'auto'`` takes ``'fused'`` when ``summary_method='power'`` and
        ``'xla'`` otherwise (:meth:`resolved_stat_mode`).

    A chunk runs as one kernel launch per bucket (and per matrix, for the
    gather): a CUDA launch compiles nothing per shape, so the JAX package's
    per-batch scan and its padding have no work to do here.
    """

    chunk_size: int = 128
    summary_method: str = "power"
    power_iters: int = 60
    bucket_rounding: int = 8
    cap_granularity: int = 32
    dtype: str = "float32"
    gather_mode: str = "auto"
    network_from_correlation: float | tuple | None = None
    superchunk: int | None = None
    stat_mode: str = "auto"
    mesh_axis: str = "perm"
    matrix_sharding: str = "replicated"

    def __post_init__(self):
        if self.network_from_correlation is not None:
            from ..ops.stats import normalize_net_beta

            knob = self.network_from_correlation
            if isinstance(knob, list):
                knob = tuple(knob)
                object.__setattr__(self, "network_from_correlation", knob)
            beta, _kind = normalize_net_beta(knob)
            if not beta > 0:
                raise ValueError(
                    "network_from_correlation power must be > 0, got "
                    f"{beta!r}"
                )
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size!r}")
        if self.summary_method not in ("power", "eigh"):
            raise ValueError(
                "summary_method must be 'power' or 'eigh', got "
                f"{self.summary_method!r}"
            )
        if self.stat_mode not in ("auto", "xla", "fused"):
            raise ValueError(
                f"stat_mode must be 'auto', 'xla', or 'fused', got "
                f"{self.stat_mode!r}"
            )
        if self.stat_mode == "fused" and self.summary_method != "power":
            raise ValueError(
                "stat_mode='fused' computes coherence with the fixed-count "
                "power iteration inside the kernel; summary_method="
                f"{self.summary_method!r} is not kernel-supported — use "
                "summary_method='power' or stat_mode='xla'"
            )
        if self.gather_mode == "mxu":
            raise NotImplementedError(
                "gather_mode='mxu' (the TPU's one-hot-matmul gather) is not "
                "ported: ROADMAP.md Queue 2 lists why; use 'fused' or "
                "'direct'"
            )
        if self.gather_mode not in ("auto", "direct", "fused"):
            raise ValueError(
                f"gather_mode must be 'auto', 'direct', or 'fused', "
                f"got {self.gather_mode!r}"
            )
        if self.mesh_axis != "perm":
            raise ValueError(
                "mesh_axis must be 'perm' (the permutation axis of "
                f"make_mesh's ('perm', 'row') mesh), got {self.mesh_axis!r}"
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

    def resolved_stat_mode(self) -> str:
        """``stat_mode`` with ``'auto'`` resolved: the fused-statistics
        kernel whenever the summary method is the power iteration it runs.
        On the CPU the kernel's plain version is the composition itself, so
        there is no interpreter cost to avoid and the rule does not depend
        on the device."""
        if self.stat_mode == "auto":
            return "fused" if self.summary_method == "power" else "xla"
        return self.stat_mode

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
