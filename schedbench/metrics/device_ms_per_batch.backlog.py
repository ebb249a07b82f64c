"""Milliseconds of device work per bind batch in the traced window: every
CUDA kernel, copy and set the profiler saw, summed."""


def read(ctx):
    t = ctx.trace
    if not t or t["device_s"] <= 0 or ctx.window.batches <= 0:
        return None
    return 1e3 * t["device_s"] / ctx.window.batches
