"""The share (%) of the traced span in which no operation ran on the
device: 1 less the union of the device's intervals over the span's
extent (``device.busy_s`` over ``device.window_s``), from the trace
alone.  The profiler slows the host's side of each traced call, so the
span reads idler than an untraced stretch of the window would."""


def read(ctx):
    t = ctx.trace
    if not t or not t["busy_s"] or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
