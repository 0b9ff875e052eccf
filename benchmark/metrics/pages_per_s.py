"""Pages whose trio the collection yielded in the window, over its seconds."""
from benchmark.readers import rate


def read(run):
    return rate(run, "pages")
