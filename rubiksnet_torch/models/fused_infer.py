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
  Each block's ``mid`` channels are folded by their taps' first offsets
  (``fold_blocks``), so that the lanes of a warp of K2's gather read
  the same pixels; the block's function is the same.
  An SE tier passes its gate weights (``se``), the rubiks3d-aq variant its
  attention taps (``aq=True``). K2 declines an SE run whose gate does not
  fit a block's shared memory beside its plan (a large ``max_shift``);
* each stride-2 entry block -> K3 (``ops/fused_entry.py``), with ``se`` on
  an SE tier and the attention mix (``aq=True``) for rubiks3d-aq, whose
  entries the JAX executor leaves to XLA. K3 declines odd H or W (an input
  that is not a multiple of 32: at 56 px the third entry sees 7 x 7, at 112
  px the last), an SE plan that does not fit, and the attention mix with
  an SE gate (Small-AQ);
* every rubiks3d-aq block when the model quantizes (the 2D shift rounds
  half away from zero, which has no tap form), and the entries K3
  declines, stay on the module path: a rubiks3d-aq block's 2D shift runs
  there on the 2D shift kernel (``ops/shift2d.py``, ``csrc/shift2d.cu``);
* the stem conv runs on a kernel of its own (``ops/stem.py``,
  ``csrc/stem.cu``) with its weight packed once here; the JAX package left
  it to XLA, and the module path keeps ``F.conv2d``;
* the head (bn_last, ReLU, spatial mean, new_fc, mean over frames) is plain
  PyTorch, as it was XLA ops in the JAX package.

On a CPU tensor the kernels' plain versions run instead, under the same
routes.
"""

from __future__ import annotations

import torch

from ..nn.backbone import VARIANTS
from ..ops.fused_block import (
    SM_COUNT,
    _sm_count,
    fold_blocks,
    fused_block_run,
    fused_block_supported,
    stack_se_params,
)
from ..ops.fused_entry import (
    fused_entry_run,
    fused_entry_supported,
    stack_entry_params,
    stack_entry_params_aq,
)
from ..ops.stem import pack_stem_weight, stem_conv
from ..parallel.mesh import active_model_group, sharded_modules
from ..parallel.temporal import active_time_group
from ..utils.profiling import NULL, setup_span, span

STEP_SPANS = {"block": "rubiksnet.serve.block",
              "entry": "rubiksnet.serve.entry",
              "module": "rubiksnet.serve.module"}


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
        if sharded_modules(model):
            raise ValueError(
                "the fused executor serves an unsharded model: load the "
                "state of parallel.gather_params into one")
        if model.variant not in VARIANTS:
            raise ValueError(f"unknown variant {model.variant!r}")
        self.model = model
        self.calls = 0
        with setup_span("rubiksnet.setup.executor"):
            self._stack(model)

    def _stack(self, model):
        """Pack the stem's weight (:attr:`stem_weight`), fold and stack the
        blocks' parameters into :attr:`steps`."""
        dtype, k, q = model.dtype, model.max_shift, model.quantize
        aq = model.variant == "rubiks3d-aq"
        self.aq = aq
        self.stem_weight = pack_stem_weight(model.backbone.conv1.weight,
                                            dtype)
        self.blocks = dict(model.backbone.named_blocks())
        self.steps = []
        self.routes = {}  # (input shape, SMs) -> steps
        self.declined = {}  # (input shape, SMs) -> [(kind, names)]
        run = []  # (name, block) of the current stride-1 run

        def flush():
            if not run:
                return
            blocks = [b for _, b in run]
            self.steps.append(("block", tuple(n for n, _ in run),
                               fold_blocks(blocks, dtype, k, aq=aq,
                                           quantize=q,
                                           se=blocks[0].se is not None)))
            run.clear()

        # The block plan is the backbone's own block order.
        for name, blk in self.blocks.items():
            if aq and q:
                flush()
                self.steps.append(("module", (name,), blk))
            elif blk.stride == 1 and blk.in_planes == blk.out_planes:
                run.append((name, blk))
            elif blk.stride == 2:
                flush()
                se = (stack_se_params([blk])[0] if blk.se is not None
                      else None)
                params = (stack_entry_params_aq(blk, dtype, k) if aq
                          else stack_entry_params(blk, dtype, k, q))
                self.steps.append(("entry", (name,), (params, se)))
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
                    se=params[1] is not None, aq=self.aq, quantize=q,
                    sms=sms)
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

    def route_for_batches(self, shape, lo, hi, sms=SM_COUNT, step=1):
        """The one route that clips of ``(N,) + shape`` take at every N of
        ``range(lo, hi + 1, step)``, by :meth:`route` at each; raises
        ``ValueError`` naming the first N whose route differs from N =
        ``lo``'s and the steps that change there. For a program traced at
        a symbolic batch, which runs one route at every batch."""
        shape = tuple(int(d) for d in shape)
        if not 1 <= lo <= hi or step < 1:
            raise ValueError(f"no batches in range({lo}, {hi + 1}, {step})")
        first = self.route((lo,) + shape, sms)
        for n in range(lo + step, hi + 1, step):
            if self.route((n,) + shape, sms) == first:
                continue
            was = self.declined[((lo,) + shape, int(sms))]
            now = self.declined[((n,) + shape, int(sms))]
            changes = ", ".join(
                f"{kind} {'+'.join(names)} "
                f"{'declined' if (kind, names) in now else 'taken'}"
                for kind, names, _ in self.steps
                if ((kind, names) in was) != ((kind, names) in now))
            raise ValueError(
                f"the route of clips {shape} changes at batch {n} (from "
                f"batch {lo}): {changes}; one program cannot serve batches "
                f"{lo}..{hi}")
        return first

    @torch.no_grad()
    def __call__(self, video, clips=None):
        """video (N, T, H, W, 3) -> logits (N, num_classes) in the model's
        compute dtype. Eagerly, or traced at a fixed N, the route is
        :meth:`route`'s at N. Traced at a symbolic N, ``clips`` is the
        ``range`` of clip counts N stands for, and the route is
        :meth:`route_for_batches`' over it (which raises where it
        changes).

        Spans (``utils/profiling.py``): ``rubiksnet.serve.call`` (call id
        :attr:`calls`) around ``.stem``, one ``.block`` a K2 run (attribute
        ``blocks``), ``.entry`` a K3 block, ``.module`` a block on the
        module path (each step's attribute ``se``: whether its blocks carry
        the SE gate), and ``.head``, device times on ``.call`` and
        ``.module`` only; the first eager call at each shape and SM count
        inside ``rubiksnet.setup.first_call``."""
        model = self.model
        if active_time_group() is not None:
            raise RuntimeError(
                "the fused executor cannot serve a time-sharded clip: K2 and "
                "K3 run the 3D shift inside their bodies and take no halo; "
                "use parallel.sequence_parallel_eval (the module path)")
        if active_model_group() is not None:
            raise RuntimeError(
                "the fused executor does not run under a model group: K2 "
                "and K3 take whole weights; a sharded model runs the module "
                "path (make_eval_step(model_group=...))")
        if video.ndim != 5 or video.shape[-1] != 3:
            raise ValueError(
                f"expected (N, T, H, W, 3), got {tuple(video.shape)}")
        sms = (_sm_count(video.device.index) if video.device.type == "cuda"
               else SM_COUNT)
        eager = isinstance(video.shape[0], int)
        first = (eager and not torch.compiler.is_compiling() and (
            tuple(video.shape), int(sms)) not in self.routes)
        self.calls += 1
        with (setup_span("rubiksnet.setup.first_call",
                         shape=tuple(video.shape), sms=int(sms))
              if first else NULL), span("rubiksnet.serve.call", video,
                                        call=self.calls):
            if eager:
                steps = self.route(video.shape, sms)
            elif clips is None:
                raise ValueError("a symbolic batch needs clips=range(...), "
                                 "the clip counts it stands for")
            else:
                steps = self.route_for_batches(video.shape[1:], clips.start,
                                               clips.stop - 1, sms,
                                               clips.step)
            # Device times (CUDA events) only on the call and the module
            # path's blocks: an event between two K2 or K3 launches would
            # serialize their programmatic dependent launch under the
            # profiler, and no metric reads those steps' device times.
            with span("rubiksnet.serve.stem"):
                x = stem_conv(video.to(model.dtype), self.stem_weight)
            for kind, names, params in steps:
                if kind not in STEP_SPANS:
                    raise ValueError(f"unknown step kind {kind!r}")
                gate = params.se if kind == "module" else params[-1]
                with span(STEP_SPANS[kind], x if kind == "module" else None,
                          blocks=len(names), se=gate is not None):
                    if kind == "block":
                        x = fused_block_run(x, *params, aq=self.aq,
                                            max_shift=model.max_shift)
                    elif kind == "entry":
                        x = fused_entry_run(x, *params, aq=self.aq,
                                            max_shift=model.max_shift)
                    else:
                        x = params(x)
            with span("rubiksnet.serve.head"):
                return model.head(x)


def fused_infer_apply(model, video):
    """Inference forward equal to ``model(video)``, every block that has
    one on a fused kernel. Stacks the parameters on each call; keep a
    :class:`FusedExecutor` to serve many batches."""
    return FusedExecutor(model)(video)
