"""``network_properties`` and ``properties_table`` — observed per-module
network properties (NetRep's ``networkProperties``), the port of
``netrep_tpu/models/properties.py``.

Per (discovery, test) pair and module, the module's test network
submatrix and data slice are gathered on the device and the properties
computed there in float64, with the formulas, sign anchor and
zero-variance handling of the JAX package's oracle
(``netrep_tpu/ops/oracle.py``): weighted degree (normalized to the module
maximum), average edge weight, summary profile, node contribution and
coherence. The results come back as numpy arrays in the JAX package's
nesting.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import resolve_device
from . import dataset as ds


def standardize(x: torch.Tensor) -> torch.Tensor:
    """Column-standardize ``x`` (samples × nodes, float64): mean 0, sd 1
    (ddof=1). Zero-variance columns become all zero, not NaN."""
    mu = x.mean(0, keepdim=True)
    d = x - mu
    sd = ((d * d).sum(0, keepdim=True) / (x.shape[0] - 1)).sqrt()
    return d / torch.where(sd > 0, sd, torch.full_like(sd, float("inf")))


def summary_profile(x: torch.Tensor) -> torch.Tensor:
    """Summary profile of a module's data slice (samples × nodes): the
    first left singular vector of the standardized slice, signed to
    correlate positively with the module's mean node profile."""
    z = standardize(x)
    u, _s, _vt = torch.linalg.svd(z, full_matrices=False)
    prof = u[:, 0]
    flip = torch.dot(prof, z.mean(1)) < 0
    return torch.where(flip, -prof, prof)


def node_contribution(x: torch.Tensor, profile: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of each node's data with the summary profile;
    0 where either is constant."""
    z = standardize(x)
    p = profile - profile.mean()
    denom = torch.linalg.vector_norm(p) * torch.linalg.vector_norm(z, dim=0)
    out = (z.T @ p) / denom
    return torch.where(denom == 0, torch.zeros_like(out), out)


def weighted_degree(net: torch.Tensor) -> torch.Tensor:
    """Row sums of a module's network submatrix, diagonal excluded."""
    return net.sum(1) - net.diagonal()


def avg_edge_weight(net: torch.Tensor) -> float:
    """Mean off-diagonal edge weight of a module's network submatrix (NaN
    for a one-node module)."""
    m = net.shape[0]
    if m < 2:
        return float("nan")
    return float((net.sum() - net.trace()) / (m * (m - 1)))


def submatrix(mat: torch.Tensor, idx) -> torch.Tensor:
    """``mat[idx][:, idx]`` as float64, gathered on ``mat``'s device."""
    i = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=mat.device)
    return mat[i[:, None], i[None, :]].to(torch.float64)


def columns(mat: torch.Tensor, idx) -> torch.Tensor:
    """``mat[:, idx]`` as float64, gathered on ``mat``'s device."""
    i = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=mat.device)
    return mat[:, i].to(torch.float64)


def _module_props(tgt: ds.Dataset, ti) -> dict:
    net_sub = submatrix(tgt.network, ti)
    deg = weighted_degree(net_sub)
    dmax = deg.abs().max()
    props = {
        "node_names": [tgt.node_names[i] for i in ti],
        "degree": torch.where(dmax > 0, deg / dmax, deg).cpu().numpy(),
        "avg_weight": avg_edge_weight(net_sub),
        "summary": None,
        "contribution": None,
        "coherence": float("nan"),
    }
    if tgt.data is not None:
        dat = columns(tgt.data, ti)
        prof = summary_profile(dat)
        nc = node_contribution(dat, prof)
        props.update(
            summary=prof.cpu().numpy(),
            contribution=nc.cpu().numpy(),
            coherence=float((nc * nc).mean()),
        )
    return props


def network_properties(
    network,
    data=None,
    correlation=None,
    module_assignments=None,
    modules=None,
    background_label: str = "0",
    discovery=None,
    test=None,
    self_preservation: bool = True,
    simplify: bool = True,
    device=None,
):
    """Observed per-module network properties.

    Arguments follow ``netrep_tpu.network_properties``; ``device`` None
    means ``"cuda"`` (and raises without a card), ``"cpu"`` runs on the
    CPU. Returns ``{discovery: {test: {module: props}}}`` where ``props``
    has:

    - ``summary`` : (n_samples,) summary profile (None when data-less)
    - ``degree`` : (m,) within-module weighted degree, normalized to the
      module maximum
    - ``contribution`` : (m,) node contributions (None when data-less)
    - ``coherence`` : float (NaN when data-less)
    - ``avg_weight`` : float (NaN for a one-node module)
    - ``node_names`` : module node labels present in the dataset

    A module with no node in a dataset is None there. ``simplify=True``
    collapses single-level nesting.
    """
    dev = resolve_device(device)
    datasets = ds.build_datasets(network, data=data, correlation=correlation,
                                 device=dev)
    # networkProperties computes properties in every dataset, including
    # the discovery itself (self pairs allowed)
    pairs = ds.resolve_pairs(datasets, discovery, test, self_preservation)
    disc_names = sorted({d for d, _ in pairs}, key=list(datasets).index)
    assign = ds.normalize_module_assignments(
        module_assignments, datasets, disc_names
    )

    out: dict[str, dict[str, dict[str, dict]]] = {}
    for d_name, t_name in pairs:
        disc_ds, tgt = datasets[d_name], datasets[t_name]
        _labels, specs, _counts = ds.module_overlap(
            disc_ds, tgt, assign[d_name], modules, background_label
        )
        out.setdefault(d_name, {})[t_name] = {
            lab: _module_props(tgt, ti) if len(ti) else None
            for lab, _di, ti in specs
        }

    if simplify:
        if len(out) == 1:
            inner = next(iter(out.values()))
            return next(iter(inner.values())) if len(inner) == 1 else inner
    return out


def properties_table(
    network,
    data=None,
    correlation=None,
    module_assignments=None,
    modules=None,
    background_label: str = "0",
    discovery=None,
    test=None,
    self_preservation: bool = True,
    device=None,
):
    """Tidy node-level export of observed network properties: one row per
    (discovery, test, module, node) with that node's ``degree`` and
    ``contribution`` plus the module-level ``avg_weight``/``coherence``
    repeated on each row. Arguments are :func:`network_properties`'s;
    requires pandas."""
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(
            "properties_table requires pandas — install the frames extra: "
            "pip install netrep-tpu[frames]"
        ) from e

    full = network_properties(
        network, data=data, correlation=correlation,
        module_assignments=module_assignments, modules=modules,
        background_label=background_label, discovery=discovery, test=test,
        self_preservation=self_preservation, simplify=False, device=device,
    )
    rows = []
    for d_name, tests in full.items():
        for t_name, mods in tests.items():
            for lab, props in mods.items():
                if props is None:  # module absent from this dataset
                    continue
                contrib = props["contribution"]
                for i, nm in enumerate(props["node_names"]):
                    rows.append({
                        "discovery": d_name,
                        "test": t_name,
                        "module": lab,
                        "node": nm,
                        "degree": float(props["degree"][i]),
                        "contribution": (
                            float(contrib[i]) if contrib is not None
                            else float("nan")
                        ),
                        "avg_weight": float(props["avg_weight"]),
                        "coherence": float(props["coherence"]),
                    })
    return pd.DataFrame(
        rows, columns=["discovery", "test", "module", "node", "degree",
                       "contribution", "avg_weight", "coherence"],
    )
