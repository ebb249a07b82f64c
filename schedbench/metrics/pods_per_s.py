"""Pods bound over the time they took, on the window of whole wave
batches (``window.py``): every pod of the bind calls after the opening
edge up to the closing one, over the time between the two."""


def read(ctx):
    return ctx.window.pods_per_s
