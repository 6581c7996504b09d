"""Canonical statistic order of the port (a copy of the names in
``netrep_tpu/ops/oracle.py``): observed arrays, null arrays and p-value
tables all index their last axis in this order."""

STAT_NAMES = (
    "avg.weight",
    "coherence",
    "cor.cor",
    "cor.degree",
    "cor.contrib",
    "avg.cor",
    "avg.contrib",
)

N_STATS = len(STAT_NAMES)
