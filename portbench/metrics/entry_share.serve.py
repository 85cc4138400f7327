"""entry_share.serve: per cent of the traced window's busy time (the
union of every device operation's intervals) taken by the entry blocks'
launches, K3's, K3-AQ's and K3-SE's alike: their tensor-core launches and
the gather pre-pass, the operations named below, overlapping launches
counted once; None where the trace holds none (a program whose entries
run elsewhere or under other names). The SE gate's launch is
``se_gate_share.serve``'s, not this metric's (moves clips_per_s)."""

from portbench.readers import busy_share

NAMES = ("rubiks_entry_",)  # the tensor-core launches and the gather


def read(ctx):
    return busy_share(ctx, NAMES)
