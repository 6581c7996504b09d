"""The permutation engine of the port."""

from .. import utils  # noqa: F401  (pins full-float32 matrix products)
