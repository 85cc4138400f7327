"""mfu.train: per cent of the bf16 matrix-product peak (989 TFLOP/s, H100
SXM at 700 W) that the whole train step reached over the untraced window
(moves train_clips_per_s)."""

from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, "train")
