"""The wave path's device work in the traced window against the least
bytes its batches need (``roofline.wave_batch_bytes``, node columns and
pod rows read once, outputs written once): all the device time of the
window, so a kernel taken off the path leaves this share standing."""

from schedbench import roofline


def read(ctx):
    t = ctx.trace
    if not t or t["device_s"] <= 0 or ctx.window.batches <= 0:
        return None
    pods_per_batch = ctx.window.pods / ctx.window.batches
    need = ctx.window.batches * roofline.wave_batch_bytes(ctx.cfg, pods_per_batch)
    return roofline.share_pct(need, t["device_s"])
