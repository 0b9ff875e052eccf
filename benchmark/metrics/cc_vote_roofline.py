"""% of the vote's roofline: its least time (per pixel of the padded batch,
1 bit of ink and 1 byte of class read, 1 byte of voted class written, at
the card's memory rate) over the device time of the kernels launched
inside ``cc_vote_batch``, a call, in the traced sub-window."""
from benchmark import arith


def read(run):
    p = run.profile
    if p is None or not p.by_range.get("cc_vote") or not p.range_calls.get("cc_vote"):
        return None
    measured = p.by_range["cc_vote"] / p.range_calls["cc_vote"]
    least = arith.vote_bytes(run.values["batch"], run.values["pad_shape"]) / arith.HBM_BYTES_PER_S
    return arith.roofline_share(least, measured)
