"""Dataset containers and input normalization for the port.

A copy of ``netrep_tpu/models/dataset.py`` for dense inputs, with the same
semantics and error messages, except where the checks run: the matrices
go to the run's device anyway, so the symmetry, finiteness and range checks
run there, in float64, with the same comparison as ``np.allclose``
(``|a - b| <= atol + rtol * |b|``, ``rtol=1e-5``, ``atol=1e-8``). At
genome scale the host version of these checks costs minutes; on the card
they cost well under a second. A :class:`Dataset` holds float32 tensors on
the device, which is the precision the engine runs in.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from ..utils.config import resolve_device

try:  # pandas is optional at runtime but used when given
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None

_SYM_TOL = 1e-8
_SYM_RTOL = 1e-5
#: rows compared per step of the symmetry check (bounds its scratch memory)
_SYM_BLOCK = 2048


@dataclasses.dataclass
class Dataset:
    """One dataset's aligned matrices, as float32 tensors on the run's
    device: ``correlation`` and ``network`` ``(n, n)``, ``data``
    ``(n_samples, n)`` or None (data-less variant)."""

    name: str
    correlation: torch.Tensor
    network: torch.Tensor
    data: torch.Tensor | None
    node_names: list[str]
    sample_names: list[str] | None = None

    @property
    def n_nodes(self) -> int:
        return len(self.node_names)

    def index_of(self) -> dict[str, int]:
        return {nm: i for i, nm in enumerate(self.node_names)}


def _as_matrix(x, what: str, dataset: str, device: torch.device):
    """(float64 tensor on ``device``, row_names, col_names) from an ndarray,
    tensor or DataFrame. Float inputs move in their own type and widen on
    the device."""
    rows = cols = None
    if pd is not None and isinstance(x, pd.DataFrame):
        rows = [str(r) for r in x.index]
        cols = [str(c) for c in x.columns]
        t = torch.tensor(x.to_numpy(dtype=np.float64))
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        arr = np.asarray(x)
        if not np.issubdtype(arr.dtype, np.floating):
            arr = np.asarray(x, dtype=np.float64)
        t = torch.as_tensor(arr if arr.flags.writeable else arr.copy())
    if t.ndim != 2:
        raise ValueError(
            f"{what} for dataset {dataset!r} must be a 2-dimensional matrix, "
            f"got {t.ndim} dimension(s)"
        )
    return t.to(device=device).to(torch.float64), rows, cols


def _check_square_symmetric(t: torch.Tensor, what: str, dataset: str):
    if t.shape[0] != t.shape[1]:
        raise ValueError(
            f"{what} for dataset {dataset!r} must be square, got shape "
            f"{tuple(t.shape)}"
        )
    if not bool(torch.isfinite(t).all()):
        raise ValueError(
            f"{what} for dataset {dataset!r} contains non-finite values "
            "(NA/NaN/Inf are not allowed)"
        )
    n = t.shape[0]
    for r0 in range(0, n, _SYM_BLOCK):
        r1 = min(n, r0 + _SYM_BLOCK)
        if not torch.allclose(t[r0:r1], t[:, r0:r1].T, rtol=_SYM_RTOL,
                              atol=_SYM_TOL):
            raise ValueError(
                f"{what} for dataset {dataset!r} is not symmetric"
            )


def _normalize_collection(x) -> dict[str, object]:
    """Turn a single matrix / sequence / mapping into {dataset_name: matrix}."""
    if x is None:
        return {}
    if isinstance(x, Mapping):
        return {str(k): v for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {str(i + 1): v for i, v in enumerate(x)}
    return {"1": x}


def build_datasets(network, data=None, correlation=None,
                   device=None) -> dict[str, Dataset]:
    """Normalize user inputs into named, validated :class:`Dataset` objects
    on ``device`` (None means ``"cuda"``; raises without a card): square,
    symmetric and finite correlation/network, correlation entries in
    [-1, 1], finite data, node-name agreement and equal node counts."""
    device = resolve_device(device)
    nets = _normalize_collection(network)
    if not nets:
        raise ValueError("network must be provided (matrix, list, or dict)")
    datas = _normalize_collection(data)
    corrs = _normalize_collection(correlation)
    if not corrs:
        raise ValueError(
            "correlation must be provided: the preservation statistics "
            "cor.cor and avg.cor are defined on the correlation structure"
        )
    if set(corrs) != set(nets):
        raise ValueError(
            f"correlation datasets {sorted(corrs)} do not match network "
            f"datasets {sorted(nets)}"
        )
    if datas and not set(datas) <= set(nets):
        raise ValueError(
            f"data datasets {sorted(datas)} are not a subset of network "
            f"datasets {sorted(nets)}"
        )

    out: dict[str, Dataset] = {}
    for name, net_raw in nets.items():
        net, _nr, net_names = _as_matrix(net_raw, "network", name, device)
        _check_square_symmetric(net, "network", name)
        corr, _cr, corr_names = _as_matrix(corrs[name], "correlation", name,
                                           device)
        _check_square_symmetric(corr, "correlation", name)
        if float(corr.abs().max()) > 1 + 1e-6:
            raise ValueError(
                f"correlation for dataset {name!r} has entries outside [-1, 1]"
            )
        if corr.shape != net.shape:
            raise ValueError(
                f"correlation and network for dataset {name!r} disagree in "
                f"size: {tuple(corr.shape)} vs {tuple(net.shape)}"
            )

        dat = samp_names = dat_names = None
        if name in datas:
            dat, samp_names, dat_names = _as_matrix(datas[name], "data", name,
                                                    device)
            if not bool(torch.isfinite(dat).all()):
                raise ValueError(
                    f"data for dataset {name!r} contains non-finite values"
                )
            if dat.shape[1] != net.shape[0]:
                raise ValueError(
                    f"data for dataset {name!r} has {dat.shape[1]} nodes "
                    f"(columns) but the network has {net.shape[0]}"
                )

        names = net_names or corr_names or dat_names
        if names is None:
            names = [f"node_{i}" for i in range(net.shape[0])]
        for label, other in (("correlation", corr_names), ("data", dat_names)):
            if other is not None and other != names:
                raise ValueError(
                    f"node names of {label} and network disagree for dataset "
                    f"{name!r}"
                )
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate node names in dataset {name!r}")

        out[name] = Dataset(
            name=name,
            correlation=corr.to(torch.float32),
            network=net.to(torch.float32),
            data=None if dat is None else dat.to(torch.float32),
            node_names=list(names),
            sample_names=samp_names,
        )
    return out


def normalize_module_assignments(
    module_assignments,
    datasets: dict[str, Dataset],
    discovery: Sequence[str],
) -> dict[str, dict[str, str]]:
    """Normalize ``module_assignments`` into {discovery_dataset: {node:
    label}}: a mapping node→label, a sequence aligned with the discovery
    dataset's node order, a pandas Series, or a mapping
    discovery_dataset→(any of the above)."""
    if module_assignments is None:
        raise ValueError("module_assignments must be provided")

    def one(x, dname: str) -> dict[str, str]:
        ds = datasets[dname]
        if pd is not None and isinstance(x, pd.Series):
            x = {str(k): v for k, v in x.items()}
        if isinstance(x, Mapping):
            by_name = {str(k): v for k, v in x.items()}  # tolerate int keys
            miss = set(ds.node_names) - set(by_name)
            if miss:
                raise ValueError(
                    f"module_assignments is missing {len(miss)} node(s) of "
                    f"discovery dataset {dname!r} (e.g. {sorted(miss)[:3]})"
                )
            return {nm: str(by_name[nm]) for nm in ds.node_names}
        seq = list(x)
        if len(seq) != ds.n_nodes:
            raise ValueError(
                f"module_assignments has length {len(seq)} but discovery "
                f"dataset {dname!r} has {ds.n_nodes} nodes"
            )
        return {nm: str(lab) for nm, lab in zip(ds.node_names, seq)}

    if isinstance(module_assignments, Mapping):
        # a mapping keyed entirely by dataset names is a per-discovery dict;
        # anything else is a node→label mapping for the single discovery
        keys = {str(k) for k in module_assignments}
        if keys and keys <= set(datasets):
            missing = set(discovery) - keys
            if missing:
                raise ValueError(
                    f"module_assignments has no entry for discovery "
                    f"dataset(s) {sorted(missing)}"
                )
            return {
                str(k): one(v, str(k))
                for k, v in module_assignments.items()
                if str(k) in set(discovery)
            }
    if len(discovery) > 1:
        raise ValueError(
            "with multiple discovery datasets, module_assignments must be a "
            "dict {discovery_dataset: assignments}"
        )
    return {discovery[0]: one(module_assignments, discovery[0])}


def resolve_pairs(datasets: dict[str, Dataset], discovery, test,
                  self_preservation: bool) -> list[tuple[str, str]]:
    """The (discovery, test) dataset pairs to analyse; self-pairs are
    skipped unless ``self_preservation``."""
    names = list(datasets)

    def pick(x, what):
        if x is None:
            return None
        if isinstance(x, (str, int)):
            x = [x]
        out = []
        for item in x:
            key = str(item)
            if key not in datasets:
                raise ValueError(
                    f"{what} dataset {item!r} not found; available datasets: "
                    f"{names}"
                )
            out.append(key)
        return out

    disc = pick(discovery, "discovery")
    tst = pick(test, "test")
    if disc is None:
        disc = [names[0]]
    if tst is None:
        tst = [n for n in names if n not in disc] or list(disc)

    pairs = [(d, t) for d in disc for t in tst if self_preservation or d != t]
    if not pairs:
        raise ValueError(
            "no (discovery, test) pairs to analyse: discovery == test and "
            "self_preservation=False"
        )
    return pairs


def module_overlap(disc_ds: Dataset, test_ds: Dataset,
                   assignments: dict[str, str], modules: Sequence[str] | None,
                   background_label: str | None = "0"):
    """Per-module aligned (discovery, test) index vectors over the nodes
    present in both datasets, plus overlap bookkeeping. Returns
    ``(module_labels, specs, counts)``: ``specs`` a list of ``(label,
    disc_idx, test_idx)``, ``counts`` label → ``(n_present, total_size)``."""
    tpos = test_ds.index_of()
    all_labels = sorted(
        {v for v in assignments.values() if v != str(background_label)},
        key=lambda s: (len(s), s),
    )
    if modules is not None:
        modules = [str(m) for m in modules]
        unknown = [m for m in modules if m not in set(assignments.values())]
        if unknown:
            raise ValueError(
                f"requested module(s) {unknown} do not exist in the "
                f"module assignments for discovery dataset {disc_ds.name!r}"
            )
        labels = modules
    else:
        labels = all_labels

    specs, counts = [], {}
    for lab in labels:
        disc_idx, test_idx = [], []
        total = 0
        for i, nm in enumerate(disc_ds.node_names):
            if assignments[nm] != lab:
                continue
            total += 1
            j = tpos.get(nm)
            if j is not None:
                disc_idx.append(i)
                test_idx.append(j)
        counts[lab] = (len(disc_idx), total)
        specs.append((lab, np.asarray(disc_idx, np.int32),
                      np.asarray(test_idx, np.int32)))
    return labels, specs, counts
