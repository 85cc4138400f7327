"""program_setup_s.train: seconds of set-up the program itself marks (its
``rubiksnet.setup.*`` spans: the first train step, the kernel library's
load inside it), nested ones counted once, by the host's clock (moves
setup_s)."""

from portbench.span_readers import setup_seconds


def read(ctx):
    return setup_seconds()
