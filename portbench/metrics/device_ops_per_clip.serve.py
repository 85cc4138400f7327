"""device_ops_per_clip.serve: device operations (kernels, copies, memsets)
a served clip takes: the traced window's operations over its calls and the
batch (moves clips_per_s)."""


def read(ctx):
    t = ctx.trace
    return len(t.device) / t.calls / ctx.quantities["batch"]
