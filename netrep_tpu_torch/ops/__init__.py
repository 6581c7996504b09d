"""Statistics, the port's kernels (fused statistics, submatrix gather, ring
shift) and p-values."""

from .. import utils  # noqa: F401  (pins full-float32 matrix products)


def kernels() -> tuple:
    """Every kernel wrapper of the port; each counts its launches in its
    ``launches`` attribute."""
    from .fused_gather import KERNELS as gather
    from .fused_stats import KERNELS as stats

    return stats + gather


def reset_launches() -> None:
    """Zero the launch count of every kernel of the port."""
    for fn in kernels():
        fn.launches = 0
