"""Train-mode batch norm over the last axis with its ReLU, as one op.

``relu(BN(x))`` of ``nn/backbone.py`` in train mode: the statistics of the
batch in float32 over every axis but the last, biased variance, eps 1e-5,
the running statistics updated as flax's BatchNorm does (``0.9 * running +
0.1 * batch``, the biased variance) and the batch count incremented; the
output in x's dtype. Two forms:

* :func:`bn_train_plain` (then ``torch.relu``): plain PyTorch ops, the form
  BN runs on the CPU, with ``plain=True``, in eval mode and under an active
  data or time group; the CPU tests and ``chip_smoke.py`` hold the kernels
  to it;
* :func:`bn_relu_train`: a ``torch.autograd.Function`` whose forward and
  backward are the kernel pair of ``csrc/bn_relu_train.cu`` (three launches
  each way: per-block partials, their merge, the elementwise pass), for a
  CUDA tensor of float32 or bfloat16. It saves x and the (2, C) statistics
  (mean, rstd) for the backward, nothing in float32 of x's size.

The JAX package has no kernel here: XLA fuses its train-mode BN.
:func:`bn_relu_plan` fixes every launch's shape, and with it every
summation order; the CPU tests emulate the kernels under it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import LaunchCounter
from . import _build
from .fused_block import _sm_count

__all__ = [
    "BACKWARD_LAUNCHES",
    "FIN_SLICES",
    "LAUNCHES",
    "BnReluPlan",
    "bn_relu_plan",
    "bn_relu_train",
    "bn_train_plain",
]

MAX_THREADS = 512  # a block's threads (csrc/bn_relu_train.cu::kMaxThreads)
UNROLL = 4  # rows a thread keeps in flight (kUnroll)
BLOCKS_PER_SM = 2  # blocks of the row-walking launches per SM
FIN_SLICES = 32  # partials a channel merges side by side (kFinSlices)
SMEM_LIMIT = 48 * 1024

LAUNCHES = LaunchCounter("bn_relu_train")
BACKWARD_LAUNCHES = LaunchCounter("bn_relu_train_backward")

_I64, _F32 = ctypes.c_int64, ctypes.c_float


def bn_train_plain(x, weight, bias, running_mean, running_var,
                   num_batches_tracked, eps, var_mean=None):
    """Train-mode BN of x as plain ops: x widened to at least float32,
    ``var_mean(xf, dims) -> (var, mean)`` over every axis but the last
    (``torch.var_mean``, biased, by default; under a group BN passes the
    global statistics), the running statistics and the count updated in
    place, the result in x's dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = tuple(range(x.ndim - 1))
    if var_mean is None:
        var, mean = torch.var_mean(xf, dim=dims, correction=0)
    else:
        var, mean = var_mean(xf, dims)
    with torch.no_grad():
        running_mean.mul_(0.9).add_(mean, alpha=0.1)
        running_var.mul_(0.9).add_(var, alpha=0.1)
        num_batches_tracked += 1
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight)
    return (y + bias).to(x.dtype)


class BnReluPlan(NamedTuple):
    """The launches of one (rows, C) call: ``vec`` channels a thread loads
    at once, ``lanes = C / vec`` threads across a row, ``row_lanes`` rows a
    block walks side by side, ``blocks`` blocks of ``per_block``
    consecutive rows (the last may hold fewer)."""

    vec: int
    lanes: int
    row_lanes: int
    blocks: int
    per_block: int

    @property
    def threads(self) -> int:
        return self.lanes * self.row_lanes

    def smem_bytes(self, c: int) -> int:
        """The row lanes' partials a block merges: two floats a channel."""
        return 2 * self.row_lanes * c * 4


@functools.lru_cache(maxsize=None)
def bn_relu_plan(rows: int, c: int, itemsize: int, sms: int,
                 align: int = 16) -> BnReluPlan:
    """The plan of a (rows, C) tensor of ``itemsize`` bytes an element on
    a card of ``sms`` SMs whose pointers are ``align``-byte aligned: the
    widest load of at most 16 bytes that divides a row and the alignment,
    as many whole row lanes as fit in MAX_THREADS, and BLOCKS_PER_SM blocks
    an SM, each at least UNROLL rows a lane (fewer blocks on a small
    tensor). It depends on the shape, the dtype and the card only, so the
    summation order is fixed. Raises where a row does not fit a block."""
    if rows < 1 or c < 1:
        raise ValueError(f"bn_relu_train needs rows and channels, got "
                         f"({rows}, {c})")
    vec = 16 // itemsize
    while vec > 1 and (c % vec or align % (vec * itemsize)):
        vec //= 2
    lanes = c // vec
    row_lanes = min(MAX_THREADS // lanes, SMEM_LIMIT // (8 * c))
    if row_lanes < 1:
        raise ValueError(f"bn_relu_train takes at most {MAX_THREADS} "
                         f"loads a row, got C={c} at {vec} a load")
    blocks = min(BLOCKS_PER_SM * sms, -(-rows // (row_lanes * UNROLL)))
    per_block = -(-rows // blocks)
    return BnReluPlan(vec, lanes, row_lanes, -(-rows // per_block), per_block)


def _alignment(*pointers) -> int:
    """The largest power of two up to 16 dividing every pointer."""
    at = 16
    for p in pointers:
        while p % at:
            at //= 2
    return at


def _plan_of(x, *pointers):
    c = x.shape[-1]
    return bn_relu_plan(x.numel() // c, c, x.element_size(),
                        _sm_count(x.device.index), _alignment(*pointers))


_P, _I = _build.PTR, _build.INT
_ENTRIES = {  # C entry point: argument types
    "bn_relu_train_forward": (_P,) * 9 + (_I, _I64, _I, _I, _I, _I64, _I,
                                          _F32, _P),
    "bn_relu_train_backward": (_P,) * 9 + (_I, _I64, _I, _I, _I, _I64, _I,
                                           _P),
}


def _call(name, dev, args):
    fn = _build.kernel_function(name, *_ENTRIES[name])
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        _build.check(rc, name)


def _check(x, weight, bias, running_mean, running_var, num_batches_tracked):
    """Raise on what the kernels do not take."""
    code = _build.dtype_code(x.dtype)  # raises for any other dtype
    if x.device.type != "cuda":
        raise ValueError(f"bn_relu_train runs on a CUDA tensor, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("bn_relu_train needs a contiguous x")
    c = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or t.device != x.device or not t.is_contiguous()):
            raise TypeError(f"bn_relu_train takes a contiguous float32 {name}"
                            f" of ({c},) on {x.device}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
    if (num_batches_tracked.dtype != torch.int64
            or num_batches_tracked.device != x.device):
        raise TypeError("bn_relu_train takes an int64 num_batches_tracked "
                        "on x's device")
    return code


class _BnReluTrain(torch.autograd.Function):
    """Forward and backward of relu(BN(x)) in train mode on the kernels.
    One float32 buffer a site holds the statistics (2, C) that the
    backward reads and, after them, the partials of both directions."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var,
                num_batches_tracked, eps):
        code = _check(x, weight, bias, running_mean, running_var,
                      num_batches_tracked)
        c = x.shape[-1]
        xp = x.data_ptr()
        plan = _plan_of(x, xp)
        out = torch.empty_like(x)
        work = torch.empty(2 * c * (1 + plan.blocks), dtype=torch.float32,
                           device=x.device)
        wp = work.data_ptr()
        _call("bn_relu_train_forward", x.device, (
            xp, weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), num_batches_tracked.data_ptr(),
            out.data_ptr(), wp, wp + 8 * c, code, x.numel() // c, c,
            plan.vec, plan.row_lanes, plan.per_block, plan.blocks, eps,
            _build.stream_of(x)))
        LAUNCHES.count += 1
        ctx.save_for_backward(x, weight, bias, work)
        ctx.plan, ctx.code = plan, code
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, work = ctx.saved_tensors
        if dy.dtype != x.dtype:
            raise TypeError(f"bn_relu_train's gradient {dy.dtype} is not x's "
                            f"{x.dtype}")
        dy = dy.contiguous()
        c = x.shape[-1]
        xp, dyp, wp = x.data_ptr(), dy.data_ptr(), work.data_ptr()
        plan = ctx.plan  # the forward's, unless dy is less aligned than x
        if dyp % (plan.vec * x.element_size()):
            plan = _plan_of(x, xp, dyp)
        dx = torch.empty_like(x)
        grads = torch.empty((2, c), dtype=torch.float32, device=x.device)
        gp = grads.data_ptr()
        partial = None  # the forward's partials' room, where it suffices
        if plan.blocks > ctx.plan.blocks:
            partial = torch.empty(2 * plan.blocks * c, dtype=torch.float32,
                                  device=x.device)
        _call("bn_relu_train_backward", x.device, (
            dyp, xp, wp, weight.data_ptr(), bias.data_ptr(), dx.data_ptr(),
            gp, gp + 4 * c, wp + 8 * c if partial is None
            else partial.data_ptr(), ctx.code, x.numel() // c, c, plan.vec,
            plan.row_lanes, plan.per_block, plan.blocks,
            _build.stream_of(x)))
        BACKWARD_LAUNCHES.count += 1
        dweight, dbias = grads.unbind(0)
        return dx, dweight, dbias, None, None, None, None


def bn_relu_train(x, weight, bias, running_mean, running_var,
                  num_batches_tracked, eps):
    """``relu(bn_train_plain(x, ...))`` on the kernel pair, for a CUDA x
    (..., C) of float32 or bfloat16, contiguous, with float32 (C,)
    parameters and running statistics on its device; raises on anything
    else. Updates the running statistics and the count in place, on the
    device. Gradients: dx in x's dtype, dweight and dbias in float32."""
    return _BnReluTrain.apply(x, weight, bias, running_mean, running_var,
                              num_batches_tracked, float(eps))
