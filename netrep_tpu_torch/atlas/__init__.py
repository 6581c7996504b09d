"""The atlas plane of the port: data-only preservation at 100,000+ genes
without an ``n × n`` matrix.

- :mod:`~netrep_tpu_torch.atlas.tiles` — :class:`TiledNetwork`, the data +
  soft-threshold-β spec whose correlation and adjacency exist only as
  on-demand tiles;
- :mod:`~netrep_tpu_torch.atlas.builder` — the streaming construction pass
  (tile grid → :class:`~netrep_tpu_torch.ops.sparse.SparseAdjacency` edges
  and degree vectors; checkpointable, mesh-splittable) with exact tile
  screening (``screen=True`` dispatches only tiles whose column-moment
  bound clears the τ cut or the running top-k floor; the output equals the
  unscreened scan's bit for bit). Its output is the input of the Config E
  engine (:func:`netrep_tpu_torch.models.sparse_api
  .sparse_module_preservation`);
- :mod:`~netrep_tpu_torch.atlas.modules` — the data-only ``k × k`` module
  plane the dense permutation engine runs on with ``correlation=None,
  network=None`` (user surface:
  :func:`netrep_tpu_torch.models.atlas_api.module_preservation`).
"""

from .. import utils  # noqa: F401  (pins full-float32 matrix products)
from .builder import AtlasBuild, build_sparse_network
from .modules import (
    data_only_gather_and_stats, dense_reference_stats,
    make_disc_props_data_only, normalize_beta_static,
)
from .tiles import (
    TiledNetwork, derived_net_np, supertile_maxima, tile_norm_maxima,
)

__all__ = [
    "AtlasBuild",
    "TiledNetwork",
    "build_sparse_network",
    "data_only_gather_and_stats",
    "dense_reference_stats",
    "derived_net_np",
    "make_disc_props_data_only",
    "normalize_beta_static",
    "supertile_maxima",
    "tile_norm_maxima",
]
