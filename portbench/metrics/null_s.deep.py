"""``null_s.deep``: mean seconds of the port's ``result.profile['null_s']``
over the calls of the untraced window, in a cell that reports
``perms_per_s``."""

from portbench.readers import mean_phase


def read(view):
    return mean_phase(view, "null_s")
