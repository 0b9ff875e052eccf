"""Host ms the train loop waits for its prefetched batch (the program's
``ps.batch_wait``), mean a step over the window."""
from benchmark.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "ps.batch_wait")
