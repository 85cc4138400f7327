"""Reading helpers the per-layer metrics' files share (``metrics/*.py``).
Each returns None where the trace holds nothing for it to read."""

from __future__ import annotations

from . import yardstick as ys


def idle_share(ctx):
    """Per cent of the traced window in which no operation ran on the
    device (kernels, copies and memsets, overlapping ones counted once)."""
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx, mode):
    """Per cent of the dtype's matrix-product peak that the untraced
    window's calls reached: the configuration's matrix-product operations
    a call times the calls over the window's seconds."""
    q = ctx.quantities
    flops = ys.model_flops(ctx.config, q["batch"], mode) * q["calls"]
    return 100.0 * flops / q["window_s"] / ys.peak_flops(ctx.config["dtype"])


def busy_share(ctx, needles):
    """Per cent of the traced window's busy time that the device
    operations named by ``needles`` took, overlapping launches counted
    once; None where the trace holds none."""
    ops = ctx.trace.matching(needles)
    if not ops:
        return None
    busy = ys.union_length([(a, b) for _, a, b in ops])
    return 100.0 * busy / ctx.trace.busy_s


def roofline(ctx, needles, bound_per_call):
    """Per cent of the least time (``bound_per_call`` seconds a call) that
    the device operations named by ``needles`` took in the traced window,
    overlapping launches counted once."""
    ops = ctx.trace.matching(needles)
    if not ops:
        return None
    busy = ys.union_length([(a, b) for _, a, b in ops])
    return 100.0 * bound_per_call * ctx.trace.calls / busy
