"""Pods bound in the window over the wave batches the Scheduler launched
in it (its counter ``scheduler_wave_batches_total``)."""


def read(ctx):
    n = ctx.counter("scheduler_wave_batches_total")
    return ctx.window.pods / n if n > 0 else None
