"""backward_share.train: per cent of the train step's device time spent in
its backward (the group reductions with it): the device seconds of the
program's ``rubiksnet.train.backward`` spans over those of its
``rubiksnet.train.step`` spans, over the steps traced with the device's
activity alone (moves train_clips_per_s)."""

from portbench.span_readers import device_share


def read(ctx):
    return device_share("rubiksnet.train.backward", "rubiksnet.train.step",
                        ctx.traffic["trace_calls"])
