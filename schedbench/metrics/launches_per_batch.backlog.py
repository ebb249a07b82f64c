"""CUDA kernels per bind batch in the traced window."""


def read(ctx):
    t = ctx.trace
    if not t or t["launches"] <= 0 or ctx.window.batches <= 0:
        return None
    return t["launches"] / ctx.window.batches
