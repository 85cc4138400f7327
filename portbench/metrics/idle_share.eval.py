"""idle_share.eval: per cent of the traced window in which the device ran
nothing (moves videos_per_s)."""

from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
