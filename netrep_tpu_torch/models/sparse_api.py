"""``sparse_module_preservation`` and ``sparse_network_properties`` — the
Config E user surface, the port of ``netrep_tpu/models/sparse_api.py``.

The semantics of :func:`~netrep_tpu_torch.models.preservation.
module_preservation` (overlap resolution, permutation null, exact
p-values, result shaping) on :class:`~netrep_tpu_torch.ops.sparse.
SparseAdjacency` networks, where the dense ``n × n`` matrices of the
dense surface cannot exist. Same arguments, checks, texts and seeding
contract as the JAX package, plus ``device`` (None means ``"cuda"`` and
raises without a card; ``"cpu"`` runs on the CPU).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops import pvalues as pv
from ..ops.sparse import SparseAdjacency
from ..parallel.engine import ModuleSpec
from ..parallel.sparse import SparsePermutationEngine
from ..utils.config import EngineConfig, resolve_device
from .properties import node_contribution, summary_profile
from .results import PreservationResult

logger = logging.getLogger("netrep_tpu_torch")


def _normalize_names(names, n: int) -> list[str]:
    """Positional ``node_{i}`` defaults, stringified, length-checked."""
    if names is None:
        return [f"node_{i}" for i in range(n)]
    names = [str(nm) for nm in names]
    if len(names) != n:
        raise ValueError("names length != network size")
    return names


def _normalize_assignments(labels, names: list[str],
                           what: str = "network") -> dict[str, str]:
    """A node name → label dict or per-position label array as node name
    → str label, every node covered."""
    if labels is None:
        raise ValueError(
            "module_assignments must be provided (node name → label dict or "
            "per-position label array)"
        )
    if isinstance(labels, dict):
        missing = [nm for nm in names if nm not in labels]
        if missing:
            raise ValueError(
                f"module_assignments is missing {len(missing)} {what} "
                f"node(s), e.g. {missing[:3]}"
            )
        return {nm: str(labels[nm]) for nm in names}
    labels = np.asarray(labels)
    if labels.shape[0] != len(names):
        raise ValueError(
            f"module_assignments has {labels.shape[0]} entries but the "
            f"{what} network has {len(names)} nodes"
        )
    return {nm: str(lab) for nm, lab in zip(names, labels)}


def _resolve_modules(labels, disc_names: list[str], test_names: list[str],
                     modules, background_label: str):
    """Name-aligned overlap resolution
    (:func:`~netrep_tpu_torch.models.dataset.module_overlap_names`, the
    dense surface's core) after the sparse surface's assignment
    normalization; modules with fewer than two test nodes are dropped with
    a warning."""
    from .dataset import module_overlap_names

    assignments = _normalize_assignments(labels, disc_names, "discovery")
    _all, raw_specs, counts = module_overlap_names(
        disc_names, test_names, assignments, modules, background_label)
    kept, specs = [], []
    for lab, disc_idx, test_idx in raw_specs:
        if len(test_idx) < 2:
            logger.warning(
                "dropping module %r: %d node(s) present in the test dataset",
                lab, len(test_idx),
            )
            continue
        kept.append(lab)
        specs.append(ModuleSpec(lab, disc_idx, test_idx))
    if not kept:
        raise ValueError(
            "no module has ≥2 nodes present in the test dataset; nothing to "
            "test"
        )
    return kept, specs, counts


def sparse_module_preservation(
    discovery_network: SparseAdjacency,
    test_network: SparseAdjacency,
    module_assignments,
    discovery_data=None,
    test_data=None,
    discovery_correlation: SparseAdjacency | None = None,
    test_correlation: SparseAdjacency | None = None,
    discovery_names: Sequence[str] | None = None,
    test_names: Sequence[str] | None = None,
    modules=None,
    background_label: str = "0",
    discovery: str = "discovery",
    test: str = "test",
    n_perm: int | None = None,
    null: str = "overlap",
    alternative: str = "greater",
    seed: int = 0,
    config: EngineConfig | None = None,
    mesh=None,
    verbose: bool = False,
    progress: Callable[[int, int], None] | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 8192,
    device=None,
) -> PreservationResult:
    """Permutation test of module preservation on sparse networks.

    Arguments follow the JAX package's ``sparse_module_preservation``:

    - ``discovery_network`` / ``test_network`` are :class:`SparseAdjacency`
      objects; the correlation statistics come from
      ``discovery_correlation`` / ``test_correlation`` (PRECOMPUTED sparse
      correlations in the same format, authoritative when given) or else
      from ``*_data`` ``(n_samples, n)`` on the fly. Without data a
      precomputed correlation keeps four statistics finite (avg.weight,
      cor.cor, cor.degree, avg.cor); with neither only avg.weight and
      cor.degree are defined. Absent pairs count as 0, as absent edges.
    - ``discovery_names`` / ``test_names`` align nodes by name; omitted,
      both graphs have the same node count and position ``i`` is the same
      node in both.
    - ``module_assignments``: discovery node name → label, or a
      per-position label array.
    - ``discovery`` / ``test`` are dataset names recorded on the result.
    - ``n_perm`` None: at least 1,000, and enough for a Bonferroni
      threshold over the finite statistics (7 with data, 4 with a
      precomputed correlation only, 2 with neither).
    - ``mesh`` splits each chunk over its ``perm`` axis; ``device`` None
      means ``"cuda"`` (raises without a card).
    - ``checkpoint_path``: the partial null is saved there every
      ``checkpoint_every`` permutations and resumed by the same call; the
      port's sparse checkpoints identify the problem by its inputs, so a
      file of the JAX package is refused (ROADMAP.md Queue 3).

    Returns one :class:`~netrep_tpu_torch.models.results.
    PreservationResult`; ``result.profile`` holds ``engine_s``,
    ``observed_s``, ``null_s`` and ``perms_per_s``.
    """
    if null not in ("overlap", "all"):
        raise ValueError(f"null must be 'overlap' or 'all', got {null!r}")
    if alternative not in ("greater", "less", "two.sided"):
        raise ValueError(
            "alternative must be one of 'greater', 'less', 'two.sided', "
            f"got {alternative!r}"
        )
    if not isinstance(discovery_network, SparseAdjacency) or not isinstance(
            test_network, SparseAdjacency):
        raise TypeError(
            "discovery_network/test_network must be SparseAdjacency (use "
            "SparseAdjacency.from_coo / from_dense; for dense matrices use "
            "module_preservation)"
        )
    for what, d, adj in (("discovery", discovery_data, discovery_network),
                         ("test", test_data, test_network)):
        if d is not None:
            shape = tuple(d.shape) if isinstance(d, torch.Tensor) \
                else np.shape(d)
            if len(shape) != 2 or shape[1] != adj.n:
                raise ValueError(
                    f"{what}_data must be (n_samples, {adj.n}), got {shape}"
                )

    if discovery_names is None or test_names is None:
        if discovery_names is not None or test_names is not None:
            raise ValueError(
                "provide both discovery_names and test_names, or neither"
            )
        if discovery_network.n != test_network.n:
            raise ValueError(
                "without node names the two networks must have the same "
                f"node count (got {discovery_network.n} vs "
                f"{test_network.n}); pass discovery_names/test_names"
            )
        discovery_names = [f"node_{i}" for i in range(discovery_network.n)]
        test_names = list(discovery_names)
    discovery_names = [str(n) for n in discovery_names]
    test_names = [str(n) for n in test_names]
    if len(discovery_names) != discovery_network.n:
        raise ValueError("discovery_names length != discovery network size")
    if len(test_names) != test_network.n:
        raise ValueError("test_names length != test network size")

    labels, specs, counts = _resolve_modules(
        module_assignments, discovery_names, test_names, modules,
        background_label)

    tpos = {nm: i for i, nm in enumerate(test_names)}
    if null == "overlap":
        pool = np.asarray([tpos[nm] for nm in discovery_names if nm in tpos],
                          dtype=np.int32)
    else:
        pool = np.arange(test_network.n, dtype=np.int32)

    with_data = discovery_data is not None and test_data is not None
    with_corr = (discovery_correlation is not None
                 and test_correlation is not None)
    if n_perm is None:
        n_stats_eff = 7 if with_data else (4 if with_corr else 2)
        n_perm = max(1000, pv.required_perms(
            0.05, n_tests=len(labels) * n_stats_eff))

    t0 = time.perf_counter()
    engine = SparsePermutationEngine(
        discovery_network, discovery_data if with_data else None,
        test_network, test_data if with_data else None, specs, pool,
        config=config or EngineConfig(), device=device, mesh=mesh,
        disc_corr=discovery_correlation, test_corr=test_correlation,
    )
    if verbose:
        logger.info("sparse %r → %r: %d modules, %d permutations",
                    discovery, test, len(labels), n_perm)
    t1 = time.perf_counter()
    observed = engine.observed()
    t2 = time.perf_counter()
    nulls, completed = engine.run_null(
        n_perm, key=seed, progress=progress,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
    )
    t3 = time.perf_counter()
    if completed < n_perm:
        logger.warning(
            "interrupted after %d/%d permutations; p-values use the "
            "completed subset", completed, n_perm,
        )
    total_space = pv.total_permutations(pool.size, [m.size for m in specs])
    p_values = pv.permutation_pvalues(observed, nulls[:completed],
                                      alternative, total_nperm=total_space)
    n_present = np.array([counts[lab][0] for lab in labels])
    tot = np.array([counts[lab][1] for lab in labels])
    return PreservationResult(
        discovery=discovery, test=test, module_labels=labels,
        observed=observed, nulls=nulls, p_values=p_values,
        n_vars_present=n_present, prop_vars_present=n_present / tot,
        total_size=tot, alternative=alternative, n_perm=n_perm,
        completed=completed, total_space=total_space,
        profile=dict(engine_s=t1 - t0, observed_s=t2 - t1, null_s=t3 - t2,
                     perms_per_s=completed / max(t3 - t2, 1e-12)),
    )


def sparse_network_properties(network: SparseAdjacency, data=None,
                              module_assignments=None,
                              names: Sequence[str] | None = None,
                              modules=None, background_label: str = "0",
                              device=None) -> dict:
    """Observed per-module properties of one sparse network — the twin of
    :func:`~netrep_tpu_torch.models.properties.network_properties` for a
    dataset whose modules are defined over its own nodes.

    Returns ``{module: props}`` with the dense surface's keys
    (``node_names``, ``degree`` normalized to the module maximum,
    ``avg_weight``, and with ``data`` ``summary``, ``contribution``,
    ``coherence``; None/NaN otherwise). Degree and average edge weight
    come from the neighbour lists (host float64, the denominator all
    ordered pairs ``m·(m-1)``); the data statistics from each module's
    data slice on ``device`` in float64 (None means ``"cuda"``; raises
    without a card). Singleton modules are kept (``avg_weight`` NaN).
    """
    if not isinstance(network, SparseAdjacency):
        raise TypeError("network must be a SparseAdjacency")
    dev = resolve_device(device)
    if data is not None:
        shape = tuple(data.shape) if isinstance(data, torch.Tensor) \
            else np.shape(data)
        if len(shape) != 2 or shape[1] != network.n:
            raise ValueError(
                f"data must be (n_samples, {network.n}), got {shape}"
            )
        data = torch.as_tensor(np.asarray(data) if not isinstance(
            data, torch.Tensor) else data).to(dev)
    names = _normalize_names(names, network.n)
    # singleton modules are KEPT: no test-overlap requirement here
    assignments = _normalize_assignments(module_assignments, names)
    by_label: dict[str, list[int]] = {}
    for i, nm in enumerate(names):
        lab = assignments[nm]
        if lab != str(background_label):
            by_label.setdefault(lab, []).append(i)
    if modules is not None:
        wanted = [str(m) for m in modules]
        unknown = [m for m in wanted if m not in by_label]
        if unknown:
            raise ValueError(
                f"modules {unknown} do not exist in the module assignments"
            )
        by_label = {m: by_label[m] for m in wanted}
    if not by_label:
        raise ValueError("all nodes carry the background label; no modules")

    out = {}
    for lab, node_pos in by_label.items():
        idx = np.asarray(node_pos, dtype=np.int64)
        m = idx.size
        nbr_rows = network.nbr[idx]
        wgt_rows = network.wgt[idx].astype(np.float64)
        member = np.isin(nbr_rows, idx) & (nbr_rows != idx[:, None])
        deg = (wgt_rows * member).sum(axis=1)
        dmax = np.max(np.abs(deg))
        props = {
            "node_names": [names[i] for i in idx],
            "degree": deg / dmax if dmax > 0 else deg,
            "avg_weight": (float(deg.sum() / (m * (m - 1))) if m > 1
                           else float("nan")),
            "summary": None,
            "contribution": None,
            "coherence": float("nan"),
        }
        if data is not None:
            # the slice in float64 where the data lies (in its own type)
            dat = data[:, torch.as_tensor(idx, device=data.device)].to(
                torch.float64)
            prof = summary_profile(dat)
            nc = node_contribution(dat, prof)
            props.update(summary=prof.cpu().numpy(),
                         contribution=nc.cpu().numpy(),
                         coherence=float((nc * nc).mean()))
        out[lab] = props
    return out
