"""The planner's host time a call (``ExecResult.plan_s``), in ms, over the
window's calls of a pool cell."""


def read(ctx):
    plan = [c["plan_s"] for c in ctx.calls if "plan_s" in c]
    return 1e3 * sum(plan) / len(plan) if plan else None
