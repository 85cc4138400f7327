"""se_gate_share.serve: per cent of the traced window's busy time (the
union of every device operation's intervals) taken by the SE gate's
launches, K2's and K3's alike, the operations named below, overlapping
launches counted once; None where the trace holds none (a configuration
without SE, or a program whose gate has another name) (moves
clips_per_s)."""

from portbench.readers import busy_share

NAMES = ("se_gate_tc_kernel",)  # the gate launch of K2-SE and K3-SE


def read(ctx):
    return busy_share(ctx, NAMES)
