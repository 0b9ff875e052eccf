"""% of the dropout kernel's roofline: the least time of the bytes it reads
and writes a step (the program's ``ps.dropout_bytes``, forward and
backward) at the card's memory rate, over the device time of the
``dropout_kernel`` launches a step in the traced sub-window."""
from benchmark import arith


def read(run):
    p = run.profile
    per_step = run.values.get("dropout_bytes_per_step")
    if p is None or p.t_stop is None or not p.units or not per_step:
        return None
    device_s = sum(t for name, t in p.by_op.items() if "dropout_kernel" in name)
    if not device_s:
        return None
    return arith.roofline_share(per_step / arith.HBM_BYTES_PER_S, device_s / p.units)
