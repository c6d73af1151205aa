"""The whole step's share (%) of the HBM roofline: the bytes the traced
calls' requests need (probe buckets, hit metadata, eviction samples,
apply; ``bench/harness/bytes.py``), whatever implements them, at the
card's peak bandwidth, over the device's busy time in those calls."""

from bench.harness.bytes import roofline_share


def read(ctx):
    t = ctx.trace
    if not t:
        return None
    return roofline_share(sum(t["bytes"].values()), t["busy_s"])
