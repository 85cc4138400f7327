"""idle_share.train: per cent of the traced window in which the device ran
nothing (moves train_clips_per_s)."""

from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
