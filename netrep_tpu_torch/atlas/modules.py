"""Atlas module plane — data-only ``k × k`` submatrices.

The port of ``netrep_tpu/atlas/modules.py``. At atlas scale no ``n × n``
correlation or network can exist, but the seven statistics only read
``k × k`` module submatrices, and with the module's standardized data
columns in hand the correlation submatrix is one matrix product
``zᵀz/(s-1)`` of the gathered ``(s, m)`` slice (exact Pearson, the
sparse path's identity), the network submatrix its soft-threshold
construction (:func:`~netrep_tpu_torch.ops.stats.derived_net`). The
dense :class:`~netrep_tpu_torch.parallel.engine.PermutationEngine` runs
with ``correlation=None, network=None`` on these functions: its data-only
mode.

A zero-variance column standardizes to all-zero here
(:func:`~netrep_tpu_torch.ops.stats.standardize_masked`), so the
statistics stay finite; the data-only datasets refuse such columns up
front (:func:`~netrep_tpu_torch.models.dataset.build_data_only_datasets`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import stats as tstats
from ..ops.sparse import corr_from_zdata


def data_only_gather_and_stats(disc: tstats.DiscProps, idx, test_dataT,
                               net_beta, n_iter: int = 60,
                               summary_method: str = "power"
                               ) -> torch.Tensor:
    """The seven statistics of padded test node sets ``idx`` ``(..., m)``
    from data alone: gather the module's rows of the TRANSPOSED ``(n, s)``
    test data, standardize, and derive both submatrices from the slice —
    correlation ``zᵀz/(s-1)``, network by ``net_beta``. The working set is
    ``O(m·s + m²)`` per instance; leading axes broadcast against the
    ``(K, …)`` discovery properties."""
    w = disc.mask
    zdata = tstats.gather_zdata(test_dataT, idx, w)        # (..., s, m)
    corr = corr_from_zdata(zdata, test_dataT.shape[-1], w)
    net = tstats.derived_net(corr, net_beta)
    return tstats.module_stats_masked(disc, corr, net, zdata, n_iter=n_iter,
                                      summary_method=summary_method)


def make_disc_props_data_only(dataT, idx_pad, mask, net_beta,
                              summary_method: str = "eigh"
                              ) -> tstats.DiscProps:
    """Discovery-side fixed properties of a bucket of modules ``idx_pad``
    ``(K, cap)`` with no stored matrices: the correlation submatrix from
    the gathered slice of the transposed ``(n, s)`` discovery data, the
    network derived from it by ``net_beta``, the data statistics from the
    same slice (exact ``eigh`` summary by default)."""
    w = tstats._f32(mask)
    safe = torch.where(w > 0, idx_pad.long(), 0)
    sub = dataT[safe].transpose(-1, -2)                     # (K, s, cap)
    z = tstats.standardize_masked(sub, w)
    corr = corr_from_zdata(z, dataT.shape[-1], w)
    net = tstats.derived_net(corr, net_beta)
    return tstats.make_disc_props(corr, net, sub, w,
                                  summary_method=summary_method)


def normalize_beta_static(net_beta) -> tuple[float, str]:
    """A ``β`` or ``(β, kind)`` spec (a list, as JSON gives it, too) as
    the ``(float, kind)`` pair."""
    return tstats.normalize_net_beta(
        tuple(net_beta) if isinstance(net_beta, list) else net_beta)


def dense_reference_stats(data_disc, data_test, specs, net_beta):
    """Small-``n`` oracle of the data-only plane: the ``n × n``
    correlation (diagonal 1) and derived network (diagonal 0) of each
    dataset, materialized in float32 on the host — the inputs of a dense
    ``module_preservation`` run that must give the data-only run's
    result. ``specs`` is accepted for the JAX package's signature."""
    beta_kind = normalize_beta_static(net_beta)
    out = []
    for d in (data_disc, data_test):
        d = torch.as_tensor(np.asarray(d, np.float32))
        z = tstats.standardize_masked(d, torch.ones(d.shape[1]))
        corr = torch.clamp(z.T @ z / max(d.shape[0] - 1, 1), -1.0, 1.0)
        corr.fill_diagonal_(1.0)
        net = tstats.derived_net(corr, beta_kind)
        net.fill_diagonal_(0.0)
        out.append((corr.numpy(), net.numpy()))
    return out
