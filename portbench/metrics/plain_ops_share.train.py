"""plain_ops_share.train: per cent of the step's device time in the
operations PyTorch runs for the modules around the kernels (BN's batch
statistics in training, casts, ReLU, adds, the optimizer): the kernel
classes "reductions", "gather / scatter / index" and "elementwise, copies,
casts" of ``yardstick.CLASSES`` (moves train_clips_per_s)."""

from portbench import yardstick as ys


def read(ctx):
    total = plain = 0.0
    for name, a, b in ctx.trace.device:
        total += b - a
        if ys.classify(name) in ys.PLAIN_OP_CLASSES:
            plain += b - a
    return 100.0 * plain / total
