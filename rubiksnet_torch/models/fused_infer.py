"""Fused inference executor: the RubiksNet forward with every block that
has one on a fused kernel.

Counterpart of ``rubiksnet_tpu/models/fused_infer.py``, same weights and
same function, different schedule. Routing:

* each run of consecutive stride-1 equal-width blocks -> K2
  (``ops/fused_block.py``), at any H x W: on the card no VMEM limit splits
  them between whole-clip, per-frame and unfused schedules as on the TPU.
  An SE tier passes its gate weights (``se``), the rubiks3d-aq variant its
  attention taps (``aq=True``);
* each stride-2 entry block of the rubiks3d variant -> K3
  (``ops/fused_entry.py``), with ``se`` on an SE tier;
* the entry blocks of rubiks3d-aq, and every rubiks3d-aq block when the
  model quantizes (the 2D shift rounds half away from zero, which has no
  tap form), stay on the module path: their 2D shift runs on K1 in its 2D
  mode;
* the stem conv and the head (bn_last, ReLU, spatial mean, new_fc, mean
  over frames) are plain PyTorch, as they were XLA ops in the JAX package.

On a CPU tensor the kernels' plain versions run instead.
"""

from __future__ import annotations

import torch

from ..nn.backbone import VARIANTS
from ..ops.fused_block import (
    fused_block_run,
    stack_block_params,
    stack_block_params_aq,
    stack_se_params,
)
from ..ops.fused_entry import fused_entry_run, stack_entry_params


class FusedExecutor:
    """Folds and stacks a model's block parameters once, then runs clips.

    The model must be in eval mode, and every shift must lie in its
    ``max_shift`` tap window (checked here, once).
    """

    def __init__(self, model):
        if model.training:
            raise ValueError("FusedExecutor runs inference: call .eval()")
        if model.variant not in VARIANTS:
            raise ValueError(f"unknown variant {model.variant!r}")
        self.model = model
        dtype, k, q = model.dtype, model.max_shift, model.quantize
        aq = model.variant == "rubiks3d-aq"
        self.aq = aq
        # ("block", names, (vt, wm, se)) | ("entry", names, (params, se))
        # | ("module", names, block)
        self.steps = []
        run = []  # (name, block) of the current stride-1 run

        def flush():
            if not run:
                return
            blocks = [b for _, b in run]
            if aq:
                vt, wm = stack_block_params_aq(blocks, dtype, k)
            else:
                vt, wm = stack_block_params(blocks, dtype, k, q)
            se = (stack_se_params(blocks) if blocks[0].se is not None
                  else None)
            self.steps.append(("block", tuple(n for n, _ in run),
                               (vt, wm, se)))
            run.clear()

        # The block plan is the backbone's own block order.
        for name, blk in model.backbone.named_blocks():
            if aq and q:
                flush()
                self.steps.append(("module", (name,), blk))
            elif blk.stride == 1 and blk.in_planes == blk.out_planes:
                run.append((name, blk))
            elif aq:
                flush()
                self.steps.append(("module", (name,), blk))
            elif blk.stride == 2:
                flush()
                se = (stack_se_params([blk])[0] if blk.se is not None
                      else None)
                self.steps.append(("entry", (name,),
                                   (stack_entry_params(blk, dtype, k, q),
                                    se)))
            else:
                raise NotImplementedError(
                    f"{name}: stride {blk.stride} width {blk.in_planes}->"
                    f"{blk.out_planes} has no fused kernel")
        flush()

    @torch.no_grad()
    def __call__(self, video):
        """video (N, T, H, W, 3) -> logits (N, num_classes) in the model's
        compute dtype."""
        model = self.model
        if video.ndim != 5 or video.shape[-1] != 3:
            raise ValueError(
                f"expected (N, T, H, W, 3), got {tuple(video.shape)}")
        x = model.backbone.conv1(video.to(model.dtype))
        for kind, _, params in self.steps:
            if kind == "block":
                x = fused_block_run(x, *params, aq=self.aq,
                                    max_shift=model.max_shift)
            elif kind == "entry":
                x = fused_entry_run(x, *params, max_shift=model.max_shift)
            elif kind == "module":
                x = params(x)
            else:
                raise ValueError(f"unknown step kind {kind!r}")
        return model.head(x)


def fused_infer_apply(model, video):
    """Inference forward equal to ``model(video)``, every block that has
    one on a fused kernel. Stacks the parameters on each call; keep a
    :class:`FusedExecutor` to serve many batches."""
    return FusedExecutor(model)(video)
