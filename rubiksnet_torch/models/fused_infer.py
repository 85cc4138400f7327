"""Fused inference executor: the RubiksNet forward with every block that
has one on a fused kernel.

Counterpart of ``rubiksnet_tpu/models/fused_infer.py``, same weights and
same function, different schedule. Each block's route is decided at the
activation's shape, as the JAX executor decides it (its ``fusable`` and
``entry_fusable``): the structure proposes a kernel, and the kernel's
``*_supported`` check (``ops/fused_block.py``, ``ops/fused_entry.py``:
pure Python from the shape, the dtype and the launch plan) takes the block
or declines it; a declined block runs on the module path. The structure:

* each run of consecutive stride-1 equal-width blocks -> K2
  (``ops/fused_block.py``), at any H x W: on the card no VMEM limit splits
  them between whole-clip, per-frame and unfused schedules as on the TPU.
  An SE tier passes its gate weights (``se``), the rubiks3d-aq variant its
  attention taps (``aq=True``). K2 declines an SE run whose gate does not
  fit a block's shared memory beside its plan (a large ``max_shift``);
* each stride-2 entry block of the rubiks3d variant -> K3
  (``ops/fused_entry.py``), with ``se`` on an SE tier. K3 declines odd H
  or W (an input that is not a multiple of 32: at 56 px the third entry
  sees 7 x 7, at 112 px the last) and an SE plan that does not fit;
* the entry blocks of rubiks3d-aq, and every rubiks3d-aq block when the
  model quantizes (the 2D shift rounds half away from zero, which has no
  tap form), stay on the module path: their 2D shift runs on the 2D shift
  kernel (``ops/shift2d.py``, ``csrc/shift2d.cu``);
* the stem conv and the head (bn_last, ReLU, spatial mean, new_fc, mean
  over frames) are plain PyTorch, as they were XLA ops in the JAX package.

On a CPU tensor the kernels' plain versions run instead, under the same
routes.
"""

from __future__ import annotations

import torch

from ..nn.backbone import VARIANTS
from ..ops.fused_block import (
    SM_COUNT,
    _sm_count,
    fused_block_run,
    fused_block_supported,
    stack_block_params,
    stack_block_params_aq,
    stack_se_params,
)
from ..ops.fused_entry import (
    fused_entry_run,
    fused_entry_supported,
    stack_entry_params,
)


def _half(d: int) -> int:
    """Extent after a stride-2 step (the stem's 3x3 conv with padding 1, a
    stride-2 block's shift and shortcut): ceil(d / 2)."""
    return (d + 1) // 2


class FusedExecutor:
    """Folds and stacks a model's block parameters once, then runs clips.

    The model must be in eval mode, and every shift must lie in its
    ``max_shift`` tap window (checked here, once). ``steps`` is the route
    the structure proposes, ``("block", names, (vt, wm, se))`` |
    ``("entry", names, (params, se))`` | ``("module", names, block)``;
    :meth:`route` is the route taken for an input shape, decided at the
    first call with that shape and cached; :attr:`declined` holds, per
    shape, the steps whose kernel declined it, as ``(kind, names)``.
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
        self.blocks = dict(model.backbone.named_blocks())
        self.steps = []
        self.routes = {}  # (input shape, SMs) -> steps
        self.declined = {}  # (input shape, SMs) -> [(kind, names)]
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
        for name, blk in self.blocks.items():
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

    def route(self, shape, sms=SM_COUNT):
        """The steps that clips of ``shape`` (N, T, H, W, 3) take, on a card
        of ``sms`` multiprocessors (the launch plans depend on it): each
        step of :attr:`steps` whose kernel takes it at the activation's
        shape there, else its blocks one by one on the module path. Every
        block of a K2 run has the run's shape, width and form, so K2 takes
        the whole run or none of it. Cached per (shape, sms), with the
        declined steps in :attr:`declined`."""
        key = (tuple(int(d) for d in shape), int(sms))
        if key in self.routes:
            return self.routes[key]
        model = self.model
        dtype, k, q = model.dtype, model.max_shift, model.quantize
        n, t, h, w, _ = key[0]
        h, w = _half(h), _half(w)  # the stem
        steps, declined = [], []
        for kind, names, params in self.steps:
            first = self.blocks[names[0]]
            shape_in = (n, t, h, w, first.in_planes)
            if kind == "block":
                ok = fused_block_supported(
                    shape_in, k, dtype, aq=self.aq, se=params[2] is not None,
                    quantize=q, sms=sms)
            elif kind == "entry":
                ok = fused_entry_supported(
                    shape_in, first.in_planes, first.out_planes, k, dtype,
                    se=params[1] is not None, quantize=q, sms=sms)
            else:
                ok = True
            if ok:
                steps.append((kind, names, params))
            else:
                steps += [("module", (nm,), self.blocks[nm]) for nm in names]
                declined.append((kind, names))
            if first.stride == 2:
                h, w = _half(h), _half(w)
        self.routes[key], self.declined[key] = steps, declined
        return steps

    @torch.no_grad()
    def __call__(self, video):
        """video (N, T, H, W, 3) -> logits (N, num_classes) in the model's
        compute dtype."""
        model = self.model
        if video.ndim != 5 or video.shape[-1] != 3:
            raise ValueError(
                f"expected (N, T, H, W, 3), got {tuple(video.shape)}")
        sms = (_sm_count(video.device.index) if video.device.type == "cuda"
               else SM_COUNT)
        x = model.backbone.conv1(video.to(model.dtype))
        for kind, _, params in self.route(video.shape, sms):
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
