"""``input_s``: mean seconds of the port's ``result.profile['input_s']`` over
the window's calls."""

from portbench.readers import mean_phase


def read(view):
    return mean_phase(view, "input_s")
