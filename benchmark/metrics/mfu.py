"""% of the bf16 peak: batches completed inside the traced sub-window
times the forward's FLOPs a batch (counted on the reference's forward at
the padded shape), over the sub-window's seconds."""
from benchmark.readers import mfu_pct


def read(run):
    return mfu_pct(run, "flop_per_batch", "bfloat16")
