"""% of the TF32 peak: steps launched inside the traced sub-window times
the FLOPs of a step's forward and backward (counted on the reference at the
padded batch shape), over the sub-window's seconds."""
from benchmark import train_arith


def read(run):
    p = run.profile
    if p is None or p.t_stop is None or not p.units or "flop_per_step" not in run.values:
        return None
    return 100.0 * p.units * run.values["flop_per_step"] / p.window_s / train_arith.TF32_PEAK_FLOPS
