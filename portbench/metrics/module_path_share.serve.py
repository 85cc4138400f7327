"""module_path_share.serve: per cent of the executor's device time spent
in the blocks it runs on the module path: the device seconds of the
program's ``rubiksnet.serve.module`` spans over those of its
``rubiksnet.serve.call`` spans, over the calls traced with the device's
activity alone (moves clips_per_s)."""

from portbench.span_readers import device_share


def read(ctx):
    return device_share("rubiksnet.serve.module", "rubiksnet.serve.call",
                        ctx.traffic["trace_calls"])
