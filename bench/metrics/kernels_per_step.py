"""Device kernels a step (a DM step on DM cells) in the traced calls."""


def read(ctx):
    t = ctx.trace
    if not t or not t["steps"] or not t["kernels"]:
        return None
    return t["kernels"] / t["steps"]
