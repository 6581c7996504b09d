"""The port's package-level surface: ``import netrep_tpu_torch.api as nt``.

The counterpart of ``netrep_tpu/__init__.py``: the same 24 names in
``__all__``, in the same order, each the port's own object, and the plot
suite reachable here too (the reference exports ``plotModule`` and its
panels at package level) but kept out of ``__all__``:

- :func:`module_preservation` — the main entry point (permutation test);
- :func:`grid_preservation` — the all-pairs grid over datasets;
- :func:`network_properties` — observed per-module topological properties;
- :func:`required_perms` — permutations needed for a significance level;
- the sparse (Config E) and atlas surfaces, the mesh, the self-test, the
  trace summary and the fault policy.

It is a module and not the package's ``__init__.py``: the port's top
stays a namespace package, so ``find_packages(include=["netrep_tpu*"])``
(the JAX package's packaging test) never takes the port's subpackages for
the JAX package's. Nothing is imported until a name is first touched:
``import netrep_tpu_torch.api`` loads neither ``torch`` nor
``matplotlib``, and never ``jax``. The entry points keep the port's device
rule: ``device=None`` means the card, and a call without one raises.
"""

from .version import __version__

__all__ = [
    "STAT_NAMES",
    "TOPOLOGY_STATS",
    "module_preservation",
    "grid_preservation",
    "GridResult",
    "network_properties",
    "required_perms",
    "permp",
    "load_example",
    "make_example_pair",
    "PreservationResult",
    "combine_analyses",
    "results_table",
    "SparseAdjacency",
    "sparse_module_preservation",
    "sparse_network_properties",
    "TiledNetwork",
    "build_sparse_network",
    "atlas_module_preservation",
    "summarize_trace",
    "make_mesh",
    "selftest",
    "properties_table",
    "FaultPolicy",
]

#: the plot suite: lazy like everything else and deliberately NOT in
#: ``__all__`` (matplotlib is the optional ``plot`` extra, so a ``from
#: netrep_tpu_torch.api import *`` on a base install must not need it)
_PLOT_EXPORTS = frozenset({
    "plot_module", "plot_data", "plot_correlation", "plot_network",
    "plot_summary", "plot_contribution", "plot_degree",
    "plot_module_sparse",
})

#: name -> (module under ``netrep_tpu_torch``, attribute there)
_WHERE = {
    "STAT_NAMES": ("ops.oracle", "STAT_NAMES"),
    "TOPOLOGY_STATS": ("ops.oracle", "TOPOLOGY_STATS"),
    "module_preservation": ("models.preservation", "module_preservation"),
    "grid_preservation": ("models.grid", "grid_preservation"),
    "GridResult": ("models.grid", "GridResult"),
    "network_properties": ("models.properties", "network_properties"),
    "properties_table": ("models.properties", "properties_table"),
    "required_perms": ("ops.pvalues", "required_perms"),
    "permp": ("ops.pvalues", "permp"),
    "load_example": ("data", "load_example"),
    "make_example_pair": ("data", "make_example_pair"),
    "PreservationResult": ("models.results", "PreservationResult"),
    "combine_analyses": ("models.results", "combine_analyses"),
    "results_table": ("models.results", "results_table"),
    "SparseAdjacency": ("ops.sparse", "SparseAdjacency"),
    "sparse_module_preservation": ("models.sparse_api",
                                   "sparse_module_preservation"),
    "sparse_network_properties": ("models.sparse_api",
                                  "sparse_network_properties"),
    "TiledNetwork": ("atlas", "TiledNetwork"),
    "build_sparse_network": ("atlas", "build_sparse_network"),
    "atlas_module_preservation": ("models.atlas_api", "module_preservation"),
    "summarize_trace": ("utils.profiling", "summarize_trace"),
    "make_mesh": ("parallel.mesh", "make_mesh"),
    "selftest": ("utils.selftest", "selftest"),
    "FaultPolicy": ("utils.config", "FaultPolicy"),
    **{name: ("plot", name) for name in _PLOT_EXPORTS},
}


def __getattr__(name):
    import importlib
    import importlib.util

    if name not in _WHERE:
        raise AttributeError(name)
    module, attr = _WHERE[name]
    if name in _PLOT_EXPORTS and importlib.util.find_spec(
            "matplotlib") is None:
        raise ImportError(
            f"netrep_tpu_torch.api.{name} needs matplotlib — install the "
            "plot extra: pip install netrep-tpu[plot]")
    return getattr(importlib.import_module(f"{__package__}.{module}"), attr)
