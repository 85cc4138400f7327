"""program_setup_s.serve: seconds of set-up the program itself marks (its
``rubiksnet.setup.*`` spans: the kernel library's load, the executor's
folding and stacking, the first call at each shape), nested ones counted
once, by the host's clock (moves setup_s)."""

from portbench.span_readers import setup_seconds


def read(ctx):
    return setup_seconds()
