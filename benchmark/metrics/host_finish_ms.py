"""Host ms of ``_download_finish`` (wait for the download, build the trio),
mean a batch over the window."""
from benchmark.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "download_finish")
