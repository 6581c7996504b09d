"""What the per-layer metric files read with: a phase of the port's
``result.profile``, a kernel's roofline share, the device's idle share.
Each returns None when the run holds nothing to read."""

from __future__ import annotations

from . import costcount


def mean_phase(view, key: str):
    """Mean seconds of ``result.profile[key]`` over the window's calls,
    which no profiler slowed: the traced call runs after the window."""
    vals = [c["profile"][key] for c in view.calls if key in c.get("profile", {})]
    return sum(vals) / len(vals) if vals else None


def roofline_share(view, prefix: str, counting: bool):
    """The frozen cost count's least time for the permutations the kernels
    named ``prefix...`` computed in the traced call, over their summed
    device time, in percent. A launch covers ``blocks`` (permutation,
    module) cells, so the window's permutations are ``blocks / modules``.
    Read only in a cell whose null is counted (``counting``) or kept."""
    if view.trace is None or view.cost_shape is None:
        return None
    if bool(view.traffic["options"].get("store_nulls", True)) == counting:
        return None
    hits = [k for n, k in view.trace["kernels"].items() if n.startswith(prefix)]
    seconds = sum(k["seconds"] for k in hits)
    blocks = sum(k["blocks"] for k in hits)
    if seconds <= 0 or blocks <= 0:
        return None
    perms = blocks / len(view.cost_shape["sizes"])
    least = costcount.least_seconds(view.cost_shape, counting, perms, view.card)
    return None if least is None else 100.0 * least / seconds


def idle_share(view):
    """Percent of the traced window in which no kernel or copy ran."""
    t = view.trace
    if t is None or not t["device_events"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
