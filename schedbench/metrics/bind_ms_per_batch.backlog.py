"""Milliseconds of a batch's bind call, weighted by its pods: the
Scheduler observes each bound pod's batch bind time in
``binding_duration_seconds`` (its tracer keeps the ``bind`` spans of the
newest 1,024 pods only, too few for a window)."""

HISTOGRAMS = [("binding_duration_seconds", {})]


def read(ctx):
    total, n = ctx.histogram(*HISTOGRAMS[0])
    return 1e3 * total / n if n > 0 else None
