"""bn_share.train: per cent of the step's device time in the train-mode
BN and ReLU kernel pair (``ops/csrc/bn_relu_train.cu``: its statistics,
finalize and apply launches, forward and backward), found by the name
below, over all device time as ``plain_ops_share.train`` counts it; None
where the trace holds none (a program that runs BN as plain ops). A share,
not a roofline: the pair reads x a second time, often from L2, so a bound
of device-memory bytes could read above 100% (moves train_clips_per_s)."""

NAMES = ("bn_relu_train",)  # every launch of the pair


def read(ctx):
    total = sum(b - a for _, a, b in ctx.trace.device)
    ops = ctx.trace.matching(NAMES)
    if not ops or not total:
        return None
    return 100.0 * sum(b - a for _, a, b in ops) / total
