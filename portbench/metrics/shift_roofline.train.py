"""shift_roofline.train: per cent of the least time of a step's 3D shifts
(K1's forward, K1-inverse's input gradient and K4's shift gradient at
every block's shift shape: ``yardstick.shift_work`` and
``shift_grad_work``) that the device operations named below took (moves
train_clips_per_s)."""

from portbench import yardstick as ys
from portbench.readers import roofline

NAMES = ("bwd3d_forward", "bwd3d_input_grad", "shift_grad")  # K1, K1-inverse, K4


def read(ctx):
    cfg = ctx.config
    item = ys.ITEMSIZE[cfg["dtype"]]
    bound = 0.0
    for n_in, n_out in ys.shift_shapes(cfg, ctx.quantities["batch"]):
        bound += ys.bound_s(ys.shift_work(n_out, n_in, item, 8), cfg["dtype"])
        bound += ys.bound_s(ys.shift_work(n_in, n_out, item, 8), cfg["dtype"])
        bound += ys.bound_s(ys.shift_grad_work(n_out, n_in, item),
                            cfg["dtype"])
    return roofline(ctx, NAMES, bound)
