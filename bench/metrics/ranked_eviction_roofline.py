"""``ranked_eviction``'s share (%) of its HBM roofline: the bytes of the
step's eviction part (``bench/harness/bytes.py``) over the traced calls,
at the card's peak bandwidth, over the kernel's device time in them.
Nothing where the trace holds no such kernel."""

from bench.harness.bytes import roofline_share


def read(ctx):
    t = ctx.trace
    if not t:
        return None
    return roofline_share(t["bytes"]["eviction"],
                          t["family_s"]["ranked_eviction"])
