"""Dataset containers and input normalization for the port.

A copy of ``netrep_tpu/models/dataset.py`` for dense inputs, with the same
semantics, decisions and error messages, except where the checks run. The
JAX package checks float64 matrices on the host; here every n×n matrix is
walked in square tiles of side :data:`TILE`, tile pair ``(I, J)``, ``J ≥
I``, at a time. Each host tile goes to the run's device once, in its own
float type, through pinned staging buffers on a copy stream, two pairs
deep, so the copy of the next pair overlaps the checks of this one. The
pair is widened to float64 there, checked (finite; ``np.allclose(arr,
arr.T, atol=1e-8)`` in both orientations; for a correlation its largest
magnitude), and narrowed into a float32 matrix allocated once. A tensor
already on the device is checked in place, tile by tile. No float64 n×n
matrix exists on the device: the float64 there is a few tiles and their
scratch. A matrix's faults are reported after its walk, in the JAX
package's order (non-finite before asymmetric). The float32 matrices
equal the narrowing of the whole float64 matrix bit for bit.

A :class:`Dataset` comes out of the checks holding float32 tensors on the
device, the precision the engine runs in; :func:`place` then moves each
matrix to where the call next needs it, a later pair's through pinned host
memory. A data-only dataset (:func:`build_data_only_datasets`) holds its
data alone: its correlation and network derive from it on demand.
"""

from __future__ import annotations

import dataclasses
import warnings
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
#: side of the square tiles the input checks walk; the float64 on the
#: device is a few tiles of this side (32 MiB each)
TILE = 2048


#: the matrices a :class:`Dataset` holds
FIELDS = ("correlation", "network", "data")


@dataclasses.dataclass
class Dataset:
    """One dataset's aligned matrices, as float32 tensors: ``correlation``
    and ``network`` ``(n, n)`` (both None for a data-only dataset, whose
    matrices derive from its data and are never materialized), ``data``
    ``(n_samples, n)`` or None (data-less variant). :func:`build_datasets`
    and :func:`build_data_only_datasets` leave them on the run's
    device; :func:`place` may move one to pinned host memory or let it go
    (None). ``copies`` holds, per field, the event of a copy to the host
    still in flight."""

    name: str
    correlation: torch.Tensor | None
    network: torch.Tensor | None
    data: torch.Tensor | None
    node_names: list[str]
    sample_names: list[str] | None = None
    copies: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_nodes(self) -> int:
        return len(self.node_names)

    def index_of(self) -> dict[str, int]:
        return {nm: i for i, nm in enumerate(self.node_names)}


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``'s memory, without a copy where torch can
    view it: any integer, bool or float type of at most 8 bytes in native
    byte order and non-negative strides. Anything else is converted to
    float64 on the host first, as the JAX package converts every input."""
    if (arr.dtype.kind not in "biuf" or arr.dtype.itemsize > 8
            or not arr.dtype.isnative or any(s < 0 for s in arr.strides)):
        arr = np.array(arr, dtype=np.float64)
    with warnings.catch_warnings():
        # a read-only array is only ever read here
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(arr)


def _as_matrix(x, what: str, dataset: str):
    """(tensor, row_names, col_names) from an ndarray, tensor or DataFrame.
    Nothing is widened, copied or moved: a host matrix stays in host
    memory in its own type, a tensor where it lies."""
    rows = cols = None
    if pd is not None and isinstance(x, pd.DataFrame):
        rows = [str(r) for r in x.index]
        cols = [str(c) for c in x.columns]
        t = _host_tensor(x.to_numpy())
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        t = _host_tensor(np.asarray(x))
    if t.ndim != 2:
        raise ValueError(
            f"{what} for dataset {dataset!r} must be a 2-dimensional matrix, "
            f"got {t.ndim} dimension(s)"
        )
    return t, rows, cols


class _Tiles:
    """Float64 tiles of matrices on ``device``.

    A tile of a tensor on ``device`` is a view of it, widened there. A
    tile of a host tensor for a card is copied once into a pinned buffer
    (torch's threaded ``copy_`` of the strided view), moved to the card on
    a copy stream, and widened there; the buffers are allocated once and
    used in two slots, so the host fills one slot while the other slot's
    copy and checks run. A Fortran-ordered source is read through its
    transpose, so each tile copy reads whole rows."""

    def __init__(self, device: torch.device, side: int):
        self.device = device
        self.side = side
        self._slots = None
        self._copy = None
        self._turn = 0

    def _staging(self):
        if self._slots is None:
            nbytes = self.side * self.side * 8
            self._copy = torch.cuda.Stream(self.device)
            self._slots = [
                dict(pin=[torch.empty(nbytes, dtype=torch.uint8,
                                      pin_memory=True) for _ in range(2)],
                     dev=[torch.empty(nbytes, dtype=torch.uint8,
                                      device=self.device) for _ in range(2)],
                     copied=torch.cuda.Event(), used=torch.cuda.Event())
                for _ in range(2)
            ]
        return self._slots

    def walk(self, src: torch.Tensor, items):
        """For each item of ``items`` (a list of ``(rows, cols)`` slice
        pairs) yield ``(item, tiles)``: ``src[rows, cols]`` of each as
        float64 on the device. The tiles are valid until the next item is
        asked for."""
        flip = not src.is_contiguous() and src.T.is_contiguous()
        base = src.T if flip else src

        def view(r, c):
            return base[c, r] if flip else base[r, c]

        staged = src.device.type == "cpu" and self.device.type == "cuda"
        for item in items:
            if not staged:
                tiles = [view(r, c).to(self.device, torch.float64)
                         for r, c in item]
                yield item, [t.T if flip else t for t in tiles]
                continue
            slot = self._staging()[self._turn % 2]
            self._turn += 1
            # the copy that last read this slot's pinned buffers is done
            slot["copied"].synchronize()
            pairs = []
            for k, (r, c) in enumerate(item):
                v = view(r, c)
                nbytes = v.numel() * v.element_size()
                pin = slot["pin"][k][:nbytes].view(v.dtype).view(v.shape)
                pin.copy_(v)
                pairs.append((pin, slot["dev"][k][:nbytes].view(v.dtype)
                              .view(v.shape)))
            cur = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._copy):
                # the checks that last read this slot's device buffers
                self._copy.wait_event(slot["used"])
                for pin, dev in pairs:
                    dev.copy_(pin, non_blocking=True)
                slot["copied"].record(self._copy)
            cur.wait_event(slot["copied"])
            tiles = [dev.to(torch.float64) for _pin, dev in pairs]
            yield item, [t.T if flip else t for t in tiles]
            slot["used"].record(cur)


def _pairs(n: int, side: int):
    """The tile pairs of an n×n matrix: ``[(I, J), (J, I)]`` for ``J > I``
    and ``[(I, I)]`` on the diagonal."""
    cuts = [slice(i, min(n, i + side)) for i in range(0, n, side)]
    for a, r in enumerate(cuts):
        for c in cuts[a:]:
            yield [(r, c)] if r == c else [(r, c), (c, r)]


def _check_square_symmetric(src: torch.Tensor, what: str, dataset: str,
                            tiles: _Tiles):
    """The JAX package's square, finite and ``np.allclose(arr, arr.T,
    atol=1e-8)`` checks, in that order, over tile pairs; returns the
    matrix narrowed to float32 on the device and its largest magnitude
    (float64, for a correlation's range check)."""
    if src.shape[0] != src.shape[1]:
        raise ValueError(
            f"{what} for dataset {dataset!r} must be square, got shape "
            f"{tuple(src.shape)}"
        )
    n = src.shape[0]
    dev = tiles.device
    out = torch.empty((n, n), dtype=torch.float32, device=dev)
    nonfinite = torch.zeros((), dtype=torch.bool, device=dev)
    asym = torch.zeros((), dtype=torch.bool, device=dev)
    top = torch.zeros((), dtype=torch.float64, device=dev)
    for item, got in tiles.walk(src, _pairs(n, tiles.side)):
        # a = M[I, J], bt = M[J, I].T: element (i, j) of the block passes
        # np.isclose(M, M.T) when |a - bt| <= atol + rtol * |bt|, and its
        # mirror when |a - bt| <= atol + rtol * |a|; both are one test
        # against the smaller magnitude (rounding is monotone)
        a = got[0]
        bt = got[1].T if len(got) == 2 else a.T
        nonfinite |= ~torch.isfinite(a).all()
        if len(got) == 2:
            nonfinite |= ~torch.isfinite(bt).all()
        aa, ba = a.abs(), bt.abs()
        top = torch.maximum(top, torch.maximum(aa.amax(), ba.amax()))
        tol = torch.minimum(aa, ba).mul_(_SYM_RTOL).add_(_SYM_TOL)
        del aa, ba
        asym |= torch.gt((a - bt).abs_(), tol).any()
        del tol
        for (r, c), t in zip(item, got):
            out[r, c] = t
    nonfinite, asym, top = (v.item() for v in (nonfinite, asym, top))
    if nonfinite:
        raise ValueError(
            f"{what} for dataset {dataset!r} contains non-finite values "
            "(NA/NaN/Inf are not allowed)"
        )
    if asym:
        raise ValueError(f"{what} for dataset {dataset!r} is not symmetric")
    return out, top


def _check_data(src: torch.Tensor, dataset: str, tiles: _Tiles):
    """The data matrix narrowed to float32 on the device, after the JAX
    package's finiteness check, in blocks of about ``TILE``² entries."""
    s, n = src.shape
    side = tiles.side
    width = max(side, side * side // max(1, min(s, side)))
    items = [[(slice(i, min(s, i + side)), slice(j, min(n, j + width)))]
             for i in range(0, s, side) for j in range(0, n, width)]
    out = torch.empty((s, n), dtype=torch.float32, device=tiles.device)
    nonfinite = torch.zeros((), dtype=torch.bool, device=tiles.device)
    for item, got in tiles.walk(src, items):
        nonfinite |= ~torch.isfinite(got[0]).all()
        out[item[0]] = got[0]
    if nonfinite.item():
        raise ValueError(
            f"data for dataset {dataset!r} contains non-finite values"
        )
    return out


def _normalize_collection(x) -> dict[str, object]:
    """Turn a single matrix / sequence / mapping into {dataset_name: matrix}."""
    if x is None:
        return {}
    if isinstance(x, Mapping):
        return {str(k): v for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {str(i + 1): v for i, v in enumerate(x)}
    return {"1": x}


def input_sources(network, data=None, correlation=None
                  ) -> dict[str, dict[str, object]]:
    """Per dataset and field (:data:`FIELDS`), the user's input as a
    view where it lies (None for absent data): what the checkpoint
    identity samples (:func:`~netrep_tpu_torch.utils.checkpoint.
    content_digest`), as the JAX package digests its datasets' float64
    arrays. Call after :func:`build_datasets` has accepted the inputs."""
    inputs = dict(zip(FIELDS, (_normalize_collection(correlation),
                               _normalize_collection(network),
                               _normalize_collection(data))))
    return {
        name: {f: (None if name not in inputs[f]
                   else _as_matrix(inputs[f][name], f, name)[0])
               for f in FIELDS}
        # data-only inputs have no network: their datasets are the data's
        for name in inputs["network"] or inputs["data"]
    }


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

    tiles = _Tiles(device, TILE)
    out: dict[str, Dataset] = {}
    for name, net_raw in nets.items():
        net_src, _nr, net_names = _as_matrix(net_raw, "network", name)
        net, _ = _check_square_symmetric(net_src, "network", name, tiles)
        corr_src, _cr, corr_names = _as_matrix(corrs[name], "correlation",
                                               name)
        corr, top = _check_square_symmetric(corr_src, "correlation", name,
                                            tiles)
        if top > 1 + 1e-6:
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
            dat_src, samp_names, dat_names = _as_matrix(datas[name], "data",
                                                        name)
            dat = _check_data(dat_src, name, tiles)
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
            correlation=corr,
            network=net,
            data=dat,
            node_names=list(names),
            sample_names=samp_names,
        )
    return out


def _column_sd(src: torch.Tensor) -> np.ndarray:
    """Population standard deviation of each column in float64, as the
    JAX package's ``np.std(data, axis=0)``: by numpy on a host matrix
    (the same arithmetic), where it lies otherwise."""
    if src.device.type == "cpu":
        return np.std(np.asarray(src.numpy(), dtype=np.float64), axis=0)
    return src.to(torch.float64).std(0, correction=0).cpu().numpy()


def build_data_only_datasets(data, device=None) -> dict[str, Dataset]:
    """Normalize DATA-ONLY inputs: each dataset is just an ``(n_samples,
    n)`` data matrix — its correlation and network derive on demand and
    are never materialized, so the dense checks have no object. What can
    be checked is, with the JAX package's texts and order: 2-D, at least
    two samples, finite, no zero-variance (constant) column (its derived
    correlations would be NaN; float64 ``np.std`` on the host for a host
    matrix), no duplicate node names. The data goes to ``device`` (None
    means ``"cuda"``; raises without a card) as float32, in tiles
    (:func:`build_datasets`); nothing ``n × n`` is made."""
    device = resolve_device(device)
    datas = _normalize_collection(data)
    if not datas:
        raise ValueError(
            "data_only runs need data (matrix, list, or dict): the "
            "correlation and network are derived from it"
        )
    tiles = _Tiles(device, TILE)
    out: dict[str, Dataset] = {}
    for name, raw in datas.items():
        src, samp_names, names = _as_matrix(raw, "data", name)
        if src.shape[0] < 2:
            raise ValueError(
                f"data for dataset {name!r} needs at least 2 samples to "
                f"correlate, got {src.shape[0]}"
            )
        dat = _check_data(src, name, tiles)
        sd = _column_sd(src)
        if (sd == 0).any():
            bad = np.flatnonzero(sd == 0)
            raise ValueError(
                f"data for dataset {name!r} has {bad.size} zero-variance "
                f"(constant) column(s), e.g. positions {bad[:3].tolist()}: "
                "their derived correlations are NaN (np.corrcoef "
                "semantics) — drop or jitter these nodes, exactly as the "
                "dense surface's non-finite-correlation check would demand"
            )
        if names is None:
            names = [f"node_{i}" for i in range(dat.shape[1])]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate node names in dataset {name!r}")
        out[name] = Dataset(name=name, correlation=None, network=None,
                            data=dat, node_names=list(names),
                            sample_names=samp_names)
    return out


def to_host(t: torch.Tensor):
    """``(copy, event)``: ``t`` copied into pinned host memory on a side
    stream, after the work queued on ``t``'s stream, without blocking the
    host; ``event`` marks the copy's end (None for a host tensor, returned
    as it is)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    side = torch.cuda.Stream(t.device)
    side.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(side):
        host.copy_(t, non_blocking=True)
    t.record_stream(side)  # the card's copy outlives its last reference
    return host, side.record_event()


def to_device(t: torch.Tensor, device: torch.device, after=None):
    """``t`` on ``device``. A pinned host tensor is copied on a side
    stream, after the event ``after`` (its copy to the host), and the
    current stream waits for that copy, so work queued after this call
    reads the matrix whole; the host does not wait."""
    if device.type != "cuda" or t.device.type == "cuda":
        return t.to(device)
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    if after is not None:
        side.wait_event(after)
    with torch.cuda.stream(side):
        out.copy_(t, non_blocking=True)
    cur.wait_stream(side)
    return out


def place(datasets: dict[str, Dataset], now: Mapping[str, set],
          later: Mapping[str, set], device) -> None:
    """Put each dataset matrix where the call needs it next: the
    ``FIELDS`` named in ``now[name]`` on ``device``, those only in
    ``later[name]`` in pinned host memory (float32, for a later pair;
    both copies run on a side stream and do not block the host), and
    every other one released (set to None). A tensor an engine holds
    stays alive through the engine's own reference; a released one the
    engine does not hold is freed, so while a pair's null runs the device
    holds only what its engine reads."""
    for name, d in datasets.items():
        for field in FIELDS:
            t = getattr(d, field)
            if t is None:
                continue
            if field in now.get(name, ()):
                t = to_device(t, device, d.copies.pop(field, None))
            elif field in later.get(name, ()):
                if t.device.type == "cuda":
                    t, d.copies[field] = to_host(t)
            else:
                t = None
                d.copies.pop(field, None)
            setattr(d, field, t)


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
    """:func:`module_overlap_names` of two datasets."""
    return module_overlap_names(
        disc_ds.node_names, test_ds.node_names, assignments, modules,
        background_label, disc_label=repr(disc_ds.name),
    )


def module_overlap_names(disc_names: Sequence[str],
                         test_names: Sequence[str],
                         assignments: dict[str, str],
                         modules: Sequence[str] | None,
                         background_label: str | None = "0",
                         disc_label: str = "discovery"):
    """Per-module aligned (discovery, test) index vectors over the nodes
    present in both name lists, plus overlap bookkeeping — the core the
    dense and sparse surfaces share. Returns ``(module_labels, specs,
    counts)``: ``specs`` a list of ``(label, disc_idx, test_idx)``,
    ``counts`` label → ``(n_present, total_size)``."""
    tpos = {nm: i for i, nm in enumerate(test_names)}
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
                f"module assignments for discovery dataset {disc_label}"
            )
        labels = modules
    else:
        labels = all_labels

    specs, counts = [], {}
    for lab in labels:
        disc_idx, test_idx = [], []
        total = 0
        for i, nm in enumerate(disc_names):
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
