"""% of the traced sub-window in which the device ran nothing."""
from benchmark.readers import idle_share_pct


def read(run):
    return idle_share_pct(run)
