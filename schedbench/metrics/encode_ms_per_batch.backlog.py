"""Mean milliseconds of a batch's encode stage in the window (the
Scheduler's ``scheduling_stage_duration_seconds{stage=encode}``)."""

HISTOGRAMS = [("scheduling_stage_duration_seconds", {"stage": "encode"})]


def read(ctx):
    total, n = ctx.histogram(*HISTOGRAMS[0])
    return 1e3 * total / n if n > 0 else None
