"""K1 (``fit_mask_kernel``, ``csrc/fit_mask.cu``): the least bytes of its
calls in the window at HBM bandwidth, over its profiled device time."""

from schedbench import roofline

KERNEL = "fit_mask_kernel"


def read(ctx):
    t = ctx.trace
    if not t:
        return None
    secs = sum(s for n, s in t["kernel_s"].items() if KERNEL in n)
    n_calls = sum(c for n, c in t["kernel_calls"].items() if KERNEL in n)
    if secs <= 0 or n_calls <= 0:
        return None
    return roofline.share_pct(n_calls * roofline.fit_mask_bytes(ctx.cfg), secs)
