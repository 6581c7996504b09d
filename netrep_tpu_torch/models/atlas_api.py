"""``module_preservation(data, …, data_only=2.0)`` — the atlas-plane user
surface, the port of ``netrep_tpu/models/atlas_api.py`` (exported by the
JAX package as ``atlas_module_preservation``).

The dense entry point needs ``n × n`` correlation and network matrices
per dataset; at atlas scale (100,000+ genes) they cannot exist. This
surface takes only the data and the soft-threshold spec and runs the same
orchestrator with every ``k × k`` submatrix derived on the device from
gathered data rows (:mod:`netrep_tpu_torch.atlas.modules`).
"""

from __future__ import annotations

from . import preservation as _pres


def module_preservation(data, module_assignments=None, data_only=2.0,
                        **kwargs):
    """Data-only permutation test of module preservation.

    Parameters
    ----------
    data : ``(n_samples, n)`` matrix, list, or dict of them — one per
        dataset, as the dense surface's ``data``. Zero-variance columns
        are refused (their derived correlations are NaN).
    module_assignments, **kwargs : as for
        :func:`netrep_tpu_torch.models.preservation.module_preservation`
        (``discovery``, ``test``, ``n_perm``, ``adaptive``,
        ``store_nulls``, ``config``, ``mesh``, ``checkpoint_dir``,
        ``device`` — None means ``"cuda"`` and raises without a card).
    data_only : the soft-threshold power β of the unsigned WGCNA adjacency
        ``|corr|**β`` (default 2.0), or a ``(β, kind)`` pair with ``kind``
        in ``('unsigned', 'signed', 'signed-hybrid')``.

    Returns the usual ``PreservationResult`` shape.
    """
    return _pres.module_preservation(
        network=None, data=data, correlation=None,
        module_assignments=module_assignments, data_only=data_only,
        **kwargs,
    )


#: the JAX package's exported name of this entry point
atlas_module_preservation = module_preservation
