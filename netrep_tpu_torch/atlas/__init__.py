"""The atlas plane of the port: data-only preservation at 100,000+ genes
without an ``n × n`` matrix.

- :mod:`~netrep_tpu_torch.atlas.modules` — the data-only ``k × k`` module
  plane the dense permutation engine runs on with ``correlation=None,
  network=None`` (user surface:
  :func:`netrep_tpu_torch.models.atlas_api.module_preservation`).

The tiled construction pass of the JAX package (``TiledNetwork``,
``build_sparse_network``, exact tile screening) is a later slice
(ROADMAP.md Queue 1 item 12b).
"""

from .. import utils  # noqa: F401  (pins full-float32 matrix products)
from .modules import (
    data_only_gather_and_stats, dense_reference_stats,
    make_disc_props_data_only, normalize_beta_static,
)

__all__ = [
    "data_only_gather_and_stats",
    "dense_reference_stats",
    "make_disc_props_data_only",
    "normalize_beta_static",
]
