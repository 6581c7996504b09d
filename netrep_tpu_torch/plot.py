"""Module plots — the port of ``netrep_tpu/plot.py`` (NetRep's
``plotModule`` and its panels): ``plot_module`` renders the stacked
composite (data heatmap + summary-profile bars, correlation heatmap,
edge-weight heatmap, node-contribution bars, weighted-degree bars) and
``plot_data`` / ``plot_correlation`` / ``plot_network`` / ``plot_summary``
/ ``plot_contribution`` / ``plot_degree`` render each panel alone;
``node_order`` and ``sample_order`` give the plotting orders.

- nodes are grouped by module and ordered by weighted degree (descending)
  in ``order_nodes_by`` (default: the discovery dataset);
- samples are ordered by the summary profile of the first plotted module
  in the plotted dataset;
- the data/correlation panels use a diverging two-hue map around a neutral
  midpoint, the network panel a single-hue sequential map, bars a single
  neutral hue.

The layout (:func:`_prepare`) goes through the port's datasets on
``device`` (None means the card): the module submatrices and data slices
are gathered there and the degrees, summary profiles and contributions
computed there in float64, as ``network_properties`` does. Only the
plotted submatrices come to the host. The drawing code is the JAX
package's. matplotlib is optional: it is imported when a panel is drawn,
and its absence raises ``ImportError`` naming the ``plot`` extra.
``plot_module_sparse`` draws the composite of a sparse network's modules,
densifying only their subgraph.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from .models import dataset as dsmod
from .models.properties import (
    columns, node_contribution, standardize, submatrix, summary_profile,
    weighted_degree,
)
from .utils.config import resolve_device

__all__ = [
    "plot_module",
    "plot_module_sparse",
    "plot_data",
    "plot_correlation",
    "plot_network",
    "plot_summary",
    "plot_contribution",
    "plot_degree",
    "node_order",
    "sample_order",
]

#: Diverging map (two hues + neutral midpoint) for signed quantities
#: (correlation, standardized expression).
DIVERGING_CMAP = "RdBu_r"
#: Single-hue sequential map for magnitudes (edge weights).
SEQUENTIAL_CMAP = "Purples"
#: Single neutral bar hue (one series per bar panel — no legend needed).
BAR_COLOR = "#5E7CA6"
#: Module separator / annotation ink.
_EDGE_INK = "#444444"


def _mpl():
    """``(matplotlib, pyplot, GridSpec)``, imported at first use."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "netrep_tpu_torch.plot needs matplotlib — install the plot "
            "extra: pip install netrep-tpu[plot]"
        ) from e
    # Headless-safe default: force Agg only on a display-less Linux box,
    # and only when neither pyplot nor an explicit MPLBACKEND has had a say
    if (
        "matplotlib.pyplot" not in sys.modules
        and not os.environ.get("MPLBACKEND")
        and sys.platform.startswith("linux")
        and not os.environ.get("DISPLAY")
        and not os.environ.get("WAYLAND_DISPLAY")
    ):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.ticker  # noqa: F401  (draw_summary's locator)
    from matplotlib.gridspec import GridSpec

    return matplotlib, plt, GridSpec


@dataclasses.dataclass
class ModuleLayout:
    """Resolved plotting layout for one (discovery → target) dataset view.

    Node order is the concatenation of per-module blocks (each internally
    ordered); ``boundaries`` are cumulative block edges for separator lines.
    ``correlation`` and ``network`` are the target's submatrices on the
    plotted nodes and ``data`` its data columns on them (float64, host),
    the only parts of the target that leave the device.
    """

    target: dsmod.Dataset
    modules: list[str]
    node_idx: np.ndarray          # target-dataset indices, plot order
    node_names: list[str]
    module_of: list[str]          # per plotted node
    boundaries: np.ndarray        # cumulative sizes, len = n_modules + 1
    degree: np.ndarray            # per plotted node (within its module)
    contribution: np.ndarray | None
    summary: np.ndarray | None    # (n_samples,) of the summary-order dataset
    sample_order: np.ndarray | None
    correlation: np.ndarray | None = None
    network: np.ndarray | None = None
    data: np.ndarray | None = None


def _degree(net: torch.Tensor, idx) -> np.ndarray:
    return weighted_degree(submatrix(net, idx)).cpu().numpy()


def _prepare(
    network,
    data=None,
    correlation=None,
    module_assignments=None,
    modules=None,
    background_label: str = "0",
    discovery=None,
    test=None,
    order_nodes_by="discovery",
    order_samples_by="test",
    stats: str = "full",
    device=None,
) -> ModuleLayout:
    """Shared input processing for all plot functions: the port's input
    layer, then ``network_properties``-style observed properties on
    ``device``.

    ``stats`` bounds the data statistics computed: ``'full'`` (contribution +
    summary + sample order — the composite plot), ``'summary'`` (summary and
    sample order only), ``'none'`` (pure ordering; the per-module SVDs are
    skipped).
    """
    dev = resolve_device(device)
    datasets = dsmod.build_datasets(network, data=data,
                                    correlation=correlation, device=dev)
    names = list(datasets)
    d_name = str(discovery) if discovery is not None else names[0]
    t_name = (
        str(test)
        if test is not None
        else (names[1] if len(names) > 1 and names[1] != d_name else d_name)
    )
    for nm in (d_name, t_name):
        if nm not in datasets:
            raise ValueError(f"dataset {nm!r} not found; available: {names}")
    assign = dsmod.normalize_module_assignments(
        module_assignments, datasets, [d_name]
    )[d_name]

    disc_ds, tgt = datasets[d_name], datasets[t_name]
    _labels, specs, _counts = dsmod.module_overlap(
        disc_ds, tgt, assign, modules, background_label
    )
    specs = [(lab, di, ti) for lab, di, ti in specs if len(ti) >= 1]
    if not specs:
        raise ValueError(
            f"no nodes of the requested module(s) are present in dataset "
            f"{t_name!r}"
        )

    if order_nodes_by == "discovery":
        order_ds, order_side = disc_ds, 0
    elif order_nodes_by == "test":
        order_ds, order_side = tgt, 1
    elif order_nodes_by is None:
        order_ds = order_side = None
    else:
        key = str(order_nodes_by)
        if key not in datasets:
            raise ValueError(
                f"order_nodes_by must be a dataset name, 'discovery', "
                f"'test', or None; got {order_nodes_by!r}"
            )
        order_ds = datasets[key]
        order_side = None

    node_idx, node_mods, degree = [], [], []
    for lab, di, ti in specs:
        deg_here = _degree(tgt.network, ti)
        if order_ds is None:
            order = np.arange(len(ti))
        else:
            if order_side == 0:
                oidx = di
            elif order_side == 1:
                oidx = ti
            else:  # arbitrary dataset: map by node name, require presence
                opos = order_ds.index_of()
                oidx = np.asarray(
                    [opos.get(tgt.node_names[i], -1) for i in ti],
                    dtype=np.int64,
                )
                if (oidx < 0).any():
                    raise ValueError(
                        f"order_nodes_by dataset {order_ds.name!r} is missing "
                        f"nodes of module {lab!r}"
                    )
            order = np.argsort(-_degree(order_ds.network, oidx),
                               kind="stable")
        ti = np.asarray(ti)
        node_idx.extend(ti[order])
        node_mods.extend([lab] * len(ti))
        degree.extend(deg_here[order])

    node_idx = np.asarray(node_idx, dtype=np.int64)
    sizes = [len(ti) for _lab, _di, ti in specs]
    boundaries = np.concatenate([[0], np.cumsum(sizes)])

    contribution = summary = sample_order = dat = None
    if tgt.data is not None:
        dat = columns(tgt.data, node_idx)
        if stats != "none":
            if stats == "full":
                # per-module contribution in the target dataset
                contribution = np.concatenate([
                    node_contribution(blk, summary_profile(blk)).cpu().numpy()
                    for blk in dat.split(sizes, dim=1)
                ])
            # the summary profile of the *first* plotted module orders the
            # samples (one profile, one order); samples belong to the
            # plotted dataset, so only its own profile can order them
            summary = summary_profile(dat[:, : sizes[0]]).cpu().numpy()
            if order_samples_by is None:
                sample_order = np.arange(dat.shape[0])
            elif order_samples_by == "test" or str(order_samples_by) == t_name:
                sample_order = np.argsort(summary, kind="stable")
            else:
                raise ValueError(
                    f"order_samples_by must be the plotted dataset "
                    f"({t_name!r} / 'test') or None (input order); got "
                    f"{order_samples_by!r} — samples are not shared across "
                    "datasets, so another dataset's summary profile cannot "
                    "order them"
                )
        dat = dat.cpu().numpy()

    return ModuleLayout(
        target=tgt,
        modules=[lab for lab, _di, _ti in specs],
        node_idx=node_idx,
        node_names=[tgt.node_names[i] for i in node_idx],
        module_of=node_mods,
        boundaries=boundaries,
        degree=np.asarray(degree),
        contribution=contribution,
        summary=summary,
        sample_order=sample_order,
        correlation=submatrix(tgt.correlation, node_idx).cpu().numpy(),
        network=submatrix(tgt.network, node_idx).cpu().numpy(),
        data=dat,
    )


def node_order(
    network,
    data=None,
    correlation=None,
    module_assignments=None,
    modules=None,
    background_label: str = "0",
    discovery=None,
    test=None,
    order_nodes_by="discovery",
    device=None,
) -> list[str]:
    """Node names in module-preservation plotting order (NetRep's
    ``nodeOrder()``): per-module blocks, each ordered by weighted degree
    (descending) in the ``order_nodes_by`` dataset ('discovery' — the
    default — 'test', a dataset name, or None for input order). Use it to
    build custom figures with the same layout as :func:`plot_module`."""
    layout = _prepare(
        network, data=data, correlation=correlation,
        module_assignments=module_assignments, modules=modules,
        background_label=background_label, discovery=discovery, test=test,
        order_nodes_by=order_nodes_by, order_samples_by=None,
        stats="none", device=device,
    )
    return list(layout.node_names)


def sample_order(
    network,
    data,
    correlation=None,
    module_assignments=None,
    modules=None,
    background_label: str = "0",
    discovery=None,
    test=None,
    order_samples_by="test",
    device=None,
):
    """Sample labels (or indices, for unnamed data) ordered by the plotted
    module's summary profile (NetRep's ``sampleOrder()``): the row order
    :func:`plot_module`'s data heatmap uses. ``data`` is required; when
    more than one module is selected, the first module's profile defines
    the order, as in :func:`plot_module`."""
    layout = _prepare(
        network, data=data, correlation=correlation,
        module_assignments=module_assignments, modules=modules,
        background_label=background_label, discovery=discovery, test=test,
        # node order cannot affect the sample order (the summary profile is
        # column-permutation-invariant), so skip the degree sorts entirely
        order_nodes_by=None, order_samples_by=order_samples_by,
        stats="summary", device=device,
    )
    if layout.sample_order is None:
        raise ValueError(
            "sample_order requires `data` for the plotted (test) dataset — "
            "the summary profile that orders samples is a data statistic"
        )
    names = layout.target.sample_names
    if names is not None:
        return [names[i] for i in layout.sample_order]
    return np.asarray(layout.sample_order)


# ---------------------------------------------------------------------------
# Panel renderers (each draws into a supplied Axes)
# ---------------------------------------------------------------------------

def _module_separators(ax, layout: ModuleLayout, axis="x"):
    for b in layout.boundaries[1:-1]:
        if axis in ("x", "both"):
            ax.axvline(b - 0.5, color="white", lw=1.6)
            ax.axvline(b - 0.5, color=_EDGE_INK, lw=0.6)
        if axis in ("y", "both"):
            ax.axhline(b - 0.5, color="white", lw=1.6)
            ax.axhline(b - 0.5, color=_EDGE_INK, lw=0.6)


def _module_header(ax, layout: ModuleLayout):
    for k, lab in enumerate(layout.modules):
        lo, hi = layout.boundaries[k], layout.boundaries[k + 1]
        ax.text(
            (lo + hi - 1) / 2.0, 1.02, str(lab), ha="center", va="bottom",
            transform=ax.get_xaxis_transform(), fontsize=9, color=_EDGE_INK,
        )


def _node_ticks(ax, layout: ModuleLayout, show: bool):
    n = layout.node_idx.size
    if show and n <= 60:
        ax.set_xticks(np.arange(n))
        ax.set_xticklabels(layout.node_names, rotation=90, fontsize=6)
    else:
        ax.set_xticks([])


def _bar_panel(ax, values, layout: ModuleLayout, title: str, show_names: bool):
    x = np.arange(values.size)
    ax.bar(x, values, width=0.82, color=BAR_COLOR, edgecolor="none")
    ax.axhline(0.0, color=_EDGE_INK, lw=0.6)
    _module_separators(ax, layout, axis="x")
    ax.set_xlim(-0.5, values.size - 0.5)
    ax.set_ylabel(title, fontsize=8)
    ax.tick_params(labelsize=7)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    _node_ticks(ax, layout, show_names)


def draw_data(ax, layout: ModuleLayout, cmap=DIVERGING_CMAP, show_names=False):
    """Standardized data heatmap: samples (rows, ordered) × nodes (cols)."""
    if layout.data is None:
        raise ValueError(
            f"dataset {layout.target.name!r} has no data matrix; the data "
            "heatmap requires one (data-less variant plots topology panels "
            "only)"
        )
    z = standardize(torch.as_tensor(layout.data)).numpy()
    z = z[layout.sample_order]
    lim = np.nanmax(np.abs(z)) if z.size else np.nan
    if not np.isfinite(lim) or lim == 0:
        lim = 1.0
    im = ax.imshow(
        z, aspect="auto", cmap=cmap, vmin=-lim, vmax=lim,
        interpolation="nearest",
    )
    _module_separators(ax, layout, axis="x")
    ax.set_ylabel("samples", fontsize=8)
    ax.set_yticks([])
    _node_ticks(ax, layout, show_names)
    return im


def draw_correlation(ax, layout: ModuleLayout, cmap=DIVERGING_CMAP, show_names=False):
    """Node × node correlation heatmap on the plot order."""
    sub = layout.correlation
    im = ax.imshow(
        sub, aspect="auto", cmap=cmap, vmin=-1.0, vmax=1.0,
        interpolation="nearest",
    )
    _module_separators(ax, layout, axis="both")
    ax.set_yticks([])
    ax.set_ylabel("correlation", fontsize=8)
    _node_ticks(ax, layout, show_names)
    return im


def draw_network(ax, layout: ModuleLayout, cmap=SEQUENTIAL_CMAP, show_names=False):
    """Node × node edge-weight heatmap (magnitude → sequential map)."""
    sub = layout.network.copy()
    np.fill_diagonal(sub, np.nan)  # self-edges carry no information
    with np.errstate(all="ignore"):
        vmax = np.nanmax(sub) if sub.size > 1 else np.nan
    if not np.isfinite(vmax) or vmax == 0:
        vmax = 1.0
    im = ax.imshow(
        sub, aspect="auto", cmap=cmap, vmin=0.0, vmax=vmax,
        interpolation="nearest",
    )
    _module_separators(ax, layout, axis="both")
    ax.set_yticks([])
    ax.set_ylabel("edge weight", fontsize=8)
    _node_ticks(ax, layout, show_names)
    return im


def draw_summary(ax, layout: ModuleLayout):
    """Horizontal summary-profile bars aligned with the data heatmap rows."""
    if layout.summary is None:
        raise ValueError("summary profile requires a data matrix")
    vals = layout.summary[layout.sample_order]
    y = np.arange(vals.size)
    ax.barh(y, vals, height=0.82, color=BAR_COLOR, edgecolor="none")
    ax.axvline(0.0, color=_EDGE_INK, lw=0.6)
    ax.set_ylim(vals.size - 0.5, -0.5)  # match imshow row direction
    ax.set_yticks([])
    ax.set_xlabel("summary", fontsize=8)
    ax.xaxis.set_major_locator(_mpl()[0].ticker.MaxNLocator(2))
    ax.tick_params(labelsize=7)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)


def draw_contribution(ax, layout: ModuleLayout, show_names=False):
    if layout.contribution is None:
        raise ValueError("node contribution requires a data matrix")
    _bar_panel(ax, layout.contribution, layout, "contribution", show_names)


def draw_degree(ax, layout: ModuleLayout, show_names=False):
    _bar_panel(ax, layout.degree, layout, "weighted degree", show_names)


# ---------------------------------------------------------------------------
# Public per-panel functions (NetRep: plotData / plotCorrelation /
# plotNetwork / plotContribution / plotDegree)
# ---------------------------------------------------------------------------

def _single_panel(draw, colorbar, ax=None, show_node_names=True,
                  stats="full", **kwargs):
    layout = _prepare(stats=stats, **kwargs)
    if ax is None:
        _fig, ax = _mpl()[1].subplots(figsize=(8, 4))
    art = draw(ax, layout, show_names=show_node_names)
    _module_header(ax, layout)
    if colorbar and art is not None:
        ax.figure.colorbar(art, ax=ax, fraction=0.04, pad=0.02)
    return ax


# The per-panel functions share the composite's signature, with explicit
# parameters, as the JAX package's do.
def plot_data(network, data=None, correlation=None, module_assignments=None,
              modules=None, background_label: str = "0", discovery=None,
              test=None, order_nodes_by="discovery", order_samples_by="test",
              show_node_names: bool = True, ax=None, device=None):
    """Standalone data heatmap panel (NetRep ``plotData``)."""
    return _single_panel(
        draw_data, True, ax=ax, show_node_names=show_node_names,
        stats="summary",
        network=network, data=data, correlation=correlation,
        module_assignments=module_assignments, modules=modules,
        background_label=background_label, discovery=discovery, test=test,
        order_nodes_by=order_nodes_by, order_samples_by=order_samples_by,
        device=device,
    )


def plot_correlation(network, data=None, correlation=None,
                     module_assignments=None, modules=None,
                     background_label: str = "0", discovery=None, test=None,
                     order_nodes_by="discovery", order_samples_by="test",
                     show_node_names: bool = True, ax=None, device=None):
    """Standalone correlation heatmap panel (NetRep ``plotCorrelation``)."""
    return _single_panel(
        draw_correlation, True, ax=ax, show_node_names=show_node_names,
        stats="none",
        network=network, data=data, correlation=correlation,
        module_assignments=module_assignments, modules=modules,
        background_label=background_label, discovery=discovery, test=test,
        order_nodes_by=order_nodes_by, order_samples_by=order_samples_by,
        device=device,
    )


def plot_network(network, data=None, correlation=None,
                 module_assignments=None, modules=None,
                 background_label: str = "0", discovery=None, test=None,
                 order_nodes_by="discovery", order_samples_by="test",
                 show_node_names: bool = True, ax=None, device=None):
    """Standalone edge-weight heatmap panel (NetRep ``plotNetwork``)."""
    return _single_panel(
        draw_network, True, ax=ax, show_node_names=show_node_names,
        stats="none",
        network=network, data=data, correlation=correlation,
        module_assignments=module_assignments, modules=modules,
        background_label=background_label, discovery=discovery, test=test,
        order_nodes_by=order_nodes_by, order_samples_by=order_samples_by,
        device=device,
    )


def plot_summary(network, data=None, correlation=None,
                 module_assignments=None, modules=None,
                 background_label: str = "0", discovery=None, test=None,
                 order_nodes_by="discovery", order_samples_by="test",
                 ax=None, device=None):
    """Standalone summary-profile bar panel (per sample)."""
    layout = _prepare(
        network=network, data=data, correlation=correlation,
        module_assignments=module_assignments, modules=modules,
        background_label=background_label, discovery=discovery, test=test,
        order_nodes_by=order_nodes_by, order_samples_by=order_samples_by,
        stats="summary", device=device,
    )
    if ax is None:
        _fig, ax = _mpl()[1].subplots(figsize=(3, 5))
    draw_summary(ax, layout)
    return ax


def plot_contribution(network, data=None, correlation=None,
                      module_assignments=None, modules=None,
                      background_label: str = "0", discovery=None, test=None,
                      order_nodes_by="discovery", order_samples_by="test",
                      show_node_names: bool = True, ax=None, device=None):
    """Standalone node-contribution bar panel (NetRep ``plotContribution``)."""
    return _single_panel(
        draw_contribution, False, ax=ax, show_node_names=show_node_names,
        stats="full",
        network=network, data=data, correlation=correlation,
        module_assignments=module_assignments, modules=modules,
        background_label=background_label, discovery=discovery, test=test,
        order_nodes_by=order_nodes_by, order_samples_by=order_samples_by,
        device=device,
    )


def plot_degree(network, data=None, correlation=None,
                module_assignments=None, modules=None,
                background_label: str = "0", discovery=None, test=None,
                order_nodes_by="discovery", order_samples_by="test",
                show_node_names: bool = True, ax=None, device=None):
    """Standalone weighted-degree bar panel (NetRep ``plotDegree``)."""
    return _single_panel(
        draw_degree, False, ax=ax, show_node_names=show_node_names,
        stats="none",
        network=network, data=data, correlation=correlation,
        module_assignments=module_assignments, modules=modules,
        background_label=background_label, discovery=discovery, test=test,
        order_nodes_by=order_nodes_by, order_samples_by=order_samples_by,
        device=device,
    )


# ---------------------------------------------------------------------------
# The composite (NetRep: plotModule)
# ---------------------------------------------------------------------------

def plot_module(
    network,
    data=None,
    correlation=None,
    module_assignments=None,
    modules=None,
    background_label: str = "0",
    discovery=None,
    test=None,
    order_nodes_by="discovery",
    order_samples_by="test",
    show_node_names: bool | None = None,
    figsize=(9.5, 12),
    fig=None,
    device=None,
):
    """Composite module plot: stacked panels sharing the node axis — data
    heatmap (with summary-profile bars on the left), correlation heatmap,
    edge-weight heatmap, node-contribution bars, weighted-degree bars.
    Data panels are dropped in the data-less variant.

    Returns ``(fig, axes)`` where ``axes`` is a dict keyed by panel name.
    """
    layout = _prepare(
        network=network, data=data, correlation=correlation,
        module_assignments=module_assignments, modules=modules,
        background_label=background_label, discovery=discovery, test=test,
        order_nodes_by=order_nodes_by, order_samples_by=order_samples_by,
        device=device,
    )
    _matplotlib, plt, GridSpec = _mpl()
    has_data = layout.data is not None
    if show_node_names is None:
        show_node_names = layout.node_idx.size <= 60

    rows = (
        ["data", "correlation", "network", "contribution", "degree"]
        if has_data
        else ["correlation", "network", "degree"]
    )
    heights = {"data": 2.2, "correlation": 3.0, "network": 3.0,
               "contribution": 1.0, "degree": 1.0}
    if fig is None:
        fig = plt.figure(figsize=figsize)
    gs = GridSpec(
        len(rows), 3,
        width_ratios=[0.9, 8.0, 0.25],
        height_ratios=[heights[r] for r in rows],
        hspace=0.28, wspace=0.06, figure=fig,
    )

    axes: dict[str, plt.Axes] = {}
    for i, row in enumerate(rows):
        ax = fig.add_subplot(gs[i, 1])
        axes[row] = ax
        last = i == len(rows) - 1
        names_here = show_node_names and last
        if row == "data":
            im = draw_data(ax, layout, show_names=names_here)
            axs = fig.add_subplot(gs[i, 0], sharey=ax)
            draw_summary(axs, layout)
            axes["summary"] = axs
            cax = fig.add_subplot(gs[i, 2])
            fig.colorbar(im, cax=cax)
            cax.tick_params(labelsize=6)
            _module_header(ax, layout)
        elif row == "correlation":
            im = draw_correlation(ax, layout, show_names=names_here)
            cax = fig.add_subplot(gs[i, 2])
            fig.colorbar(im, cax=cax)
            cax.tick_params(labelsize=6)
            if rows[0] == "correlation":
                _module_header(ax, layout)
        elif row == "network":
            im = draw_network(ax, layout, show_names=names_here)
            cax = fig.add_subplot(gs[i, 2])
            fig.colorbar(im, cax=cax)
            cax.tick_params(labelsize=6)
        elif row == "contribution":
            draw_contribution(ax, layout, show_names=names_here)
        elif row == "degree":
            draw_degree(ax, layout, show_names=names_here)

    fig.align_ylabels(list(axes.values()))
    fig.suptitle(
        f"Module preservation view — dataset {layout.target.name!r}",
        fontsize=11, y=0.995,
    )
    return fig, axes


def plot_module_sparse(
    network,
    data=None,
    correlation=None,
    module_assignments=None,
    names=None,
    modules=None,
    background_label: str = "0",
    max_nodes: int = 4000,
    device=None,
    **kw,
):
    """Composite module plot of a SPARSE network (Config E): only the
    requested modules' subgraph is densified — m ≪ n nodes, so the m×m
    panels are cheap where the n×n matrix could never exist — and drawn
    by :func:`plot_module`'s panel stack.

    ``network`` is a :class:`~netrep_tpu_torch.ops.sparse.SparseAdjacency`;
    ``correlation`` an optional sparse correlation in the same format (the
    correlation panel's values when given, else they come from ``data``;
    one of the two is required). ``max_nodes`` guards against densifying a
    huge node set. ``device`` and the remaining keyword arguments go to
    :func:`plot_module`.
    """
    import pandas as pd

    from .models.sparse_api import _normalize_assignments, _normalize_names
    from .ops.sparse import SparseAdjacency

    if not isinstance(network, SparseAdjacency):
        raise TypeError("network must be a SparseAdjacency")
    if data is None and correlation is None:
        raise ValueError(
            "provide data= and/or correlation= (sparse): the correlation "
            "heatmap panel needs one of them"
        )
    if data is not None:
        data = np.asarray(data)
        if data.ndim != 2 or data.shape[1] != network.n:
            raise ValueError(
                f"data must be (n_samples, {network.n}), got "
                f"{getattr(data, 'shape', None)}"
            )
    if correlation is not None and (
            not isinstance(correlation, SparseAdjacency)
            or correlation.n != network.n):
        raise ValueError(
            "correlation must be a SparseAdjacency over the same "
            f"{network.n} nodes"
        )
    names = _normalize_names(names, network.n)
    assignments = _normalize_assignments(module_assignments, names)
    wanted = (
        [str(m) for m in modules] if modules is not None
        else sorted({lab for lab in assignments.values()
                     if lab != str(background_label)})
    )
    keep = [i for i, nm in enumerate(names) if assignments[nm] in wanted]
    if not keep:
        raise ValueError(f"no nodes carry module label(s) {wanted}")
    if len(keep) > max_nodes:
        raise ValueError(
            f"selected modules cover {len(keep)} nodes (> max_nodes="
            f"{max_nodes}); pass a smaller modules= selection"
        )
    idx = np.asarray(keep, dtype=np.int64)
    sub_names = [names[i] for i in idx]
    # global id → local position, -1 elsewhere; width n + 1 so the padded
    # slots' sentinel id n lands on -1
    local_of = np.full(network.n + 1, -1, dtype=np.int64)
    local_of[idx] = np.arange(idx.size)

    def densify(adj, diag):
        nbr = adj.nbr[idx]
        wgt = adj.wgt[idx].astype(np.float64)
        cols = local_of[nbr]
        rows = np.broadcast_to(np.arange(idx.size)[:, None], nbr.shape)
        hit = cols >= 0
        out = np.zeros((idx.size, idx.size))
        out[rows[hit], cols[hit]] = wgt[hit]
        np.fill_diagonal(out, diag)
        return pd.DataFrame(out, index=sub_names, columns=sub_names)

    net_df = densify(network, 1.0)
    if correlation is not None:
        corr_df = densify(correlation, 1.0)
    else:
        corr_df = pd.DataFrame(np.corrcoef(data[:, idx], rowvar=False),
                               index=sub_names, columns=sub_names)
    data_df = (pd.DataFrame(data[:, idx], columns=sub_names)
               if data is not None else None)
    return plot_module(
        network=net_df, data=data_df, correlation=corr_df,
        module_assignments={nm: assignments[nm] for nm in sub_names},
        modules=wanted, background_label=background_label, device=device,
        **kw,
    )
