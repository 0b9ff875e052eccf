"""Host ms of ``ThroughputPredictor.prep_batch`` (decimate, ink gather,
upload), mean a batch over the window."""
from benchmark.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "prep_batch")
