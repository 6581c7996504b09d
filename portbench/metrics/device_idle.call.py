"""``device_idle.call``: percent of the traced window in which neither a
kernel nor a copy ran on the card."""

from portbench.readers import idle_share


def read(view):
    return idle_share(view)
