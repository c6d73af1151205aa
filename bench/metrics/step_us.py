"""The step loop's host-clock time a step, in us, over the window's
calls: each call's step wall over its steps.  A pool's step wall is its
segments' ``wall_s`` (each ends in a device sync) and a step one planned
group; a DM cluster's is the whole ``Cluster.execute`` call, its loop of
DM steps (a group on every shard, with its routing)."""


def read(ctx):
    steps = sum(c.get("steps", 0) for c in ctx.calls)
    wall = sum(c.get("step_wall_s", 0.0) for c in ctx.calls)
    return 1e6 * wall / steps if steps else None
