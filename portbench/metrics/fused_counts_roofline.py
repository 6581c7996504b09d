"""``fused_counts_roofline``: the fused-statistics kernel
(``ops/fused_stats.py``, ``csrc/fused_stats.cu``) counting the null
(``fused_stats_counts``), as a share of its roofline."""

from portbench.readers import roofline_share


def read(view):
    return roofline_share(view, "fused_stats_kernel", counting=True)
