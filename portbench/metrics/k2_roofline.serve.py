"""k2_roofline.serve: per cent of the least time of the stride-1 blocks
(K2's work: ``yardstick.block_work`` at every stride-1 block's shape, with
the attention mix where the configuration has it) that the device
operations named below took (moves clips_per_s)."""

from portbench import yardstick as ys
from portbench.readers import roofline

NAMES = ("rubiks_tc_kernel",)  # K2's bf16 launches


def read(ctx):
    cfg, batch = ctx.config, ctx.quantities["batch"]
    item = ys.ITEMSIZE[cfg["dtype"]]
    aq = cfg["variant"] == "rubiks3d-aq"
    bound = sum(ys.bound_s(ys.block_work(batch, h, c, item, ys.block_rows(cfg),
                                         aq, cfg["use_se"],
                                         cfg["num_frames"]), cfg["dtype"])
                for h, c in ys.stride1_blocks(cfg))
    return roofline(ctx, NAMES, bound)
