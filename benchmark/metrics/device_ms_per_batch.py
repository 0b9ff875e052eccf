"""Device busy ms (union of kernels and copies) a batch, over the traced
sub-window."""
from benchmark.readers import device_ms_per_unit


def read(run):
    return device_ms_per_unit(run)
