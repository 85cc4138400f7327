"""host_wait_share.eval: per cent of the untraced window the evaluator's
loop spent waiting in the feed's ``next()`` for its next batch, by the
host's clock around that call (moves videos_per_s)."""


def read(ctx):
    q = ctx.quantities
    return 100.0 * q["host_wait_s"] / q["window_s"]
