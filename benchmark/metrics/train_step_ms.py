"""Host ms of one step of ``Trainer.train``'s loop (the program's
``ps.step``), mean over the window."""
from benchmark.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "ps.step")
