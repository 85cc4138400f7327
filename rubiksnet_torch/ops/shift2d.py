"""Learnable fractional 2D shift (RubiksShift2D) with its custom gradient.

Counterpart of ``rubiksnet_tpu/ops/shift2d.py`` on channel-last
(N, H, W, C) input with a (2, C) shift, rows (shift_H, shift_W):

* forward: bilinear per-channel shift, zero fill, strided output grid;
  quantize rounds the coordinate ``base + shift`` half away from zero (not
  the 3D op's rule). On a CUDA tensor it is kernel K1
  (``csrc/shift3d.cu::rubiks_shift3d_fwd``) on the (N, 1, H, W, C) view
  with a zero T row, as the JAX package runs its TPU kernel; counter
  ``shift2d``. Plain form: :func:`shift2d_plain`.
* input gradient: the inverse shift, K1-inverse in the same 2D mode
  (counter ``shift2d_inverse``) / :func:`shift2d_input_grad_plain`.
* raw (2, C) shift gradient: :func:`rubiks_shift_2d_shift_grad`, plain
  PyTorch on every device, as it is an XLA formulation in the JAX package.
  It is not the 3D rule: a remainder within 1e-7 of zero snaps to zero and
  that axis takes a halved central difference, otherwise a forward
  difference; no corrected taps and no t-factor.

:func:`rubiks_shift_2d` ties them into an autograd op whose shift gradient
is unit-normalized per channel (:func:`normalize_shift_grad_2d`).
"""

from __future__ import annotations

import torch

from . import _build
from . import shift_core as core
from .shift3d import _route, shift3d_input_grad_kernel, shift3d_kernel

__all__ = [
    "compute_output_shape_2d",
    "normalize_shift_grad_2d",
    "rubiks_shift_2d",
    "rubiks_shift_2d_forward",
    "rubiks_shift_2d_input_grad",
    "rubiks_shift_2d_shift_grad",
    "shift2d_input_grad_kernel",
    "shift2d_input_grad_plain",
    "shift2d_kernel",
    "shift2d_plain",
    "LAUNCHES",
    "INVERSE_LAUNCHES",
]

_H_AX, _W_AX = 1, 2
ZERO_TOL = 1e-7
_MODE = "half_away"

LAUNCHES = _build.LaunchCounter("shift2d")
INVERSE_LAUNCHES = _build.LaunchCounter("shift2d_inverse")


def _pair(v):
    if isinstance(v, int):
        return (v, v)
    t = tuple(int(u) for u in v)
    if len(t) != 2:
        raise ValueError(f"expected 2 entries, got {v}")
    return t


def compute_output_shape_2d(shape, stride, padding):
    """(N, H, W, C) output shape of the shift."""
    n, h, w, c = shape
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    return (n, core.output_len(h, sh, ph), core.output_len(w, sw, pw), c)


# ------------------------------------------------------------ plain forms


def shift2d_plain(x, shift, stride=(1, 1), padding=(0, 0), quantize=False):
    """The gather form: H, then W 1D shifts in x's dtype."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    shift = shift.to(x.dtype)
    out = core.frac_shift_axis(x, shift[0], _H_AX, sh, ph, quantize, _MODE)
    return core.frac_shift_axis(out, shift[1], _W_AX, sw, pw, quantize, _MODE)


def shift2d_input_grad_plain(og, shift, in_shape, stride=(1, 1),
                             padding=(0, 0), quantize=False):
    """Gradient with respect to x: the inverse shift of og, H then W."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    shift = shift.to(og.dtype)
    g = core.inverse_shift_axis(og, shift[0], _H_AX, sh, ph, in_shape[_H_AX],
                                quantize, _MODE)
    return core.inverse_shift_axis(g, shift[1], _W_AX, sw, pw,
                                   in_shape[_W_AX], quantize, _MODE)


def _axis_taps(x, shift_c, axis, stride, padding, d_out):
    """x gathered at ``o * stride - padding + floor(shift) + {-1, 0, 1}``."""
    base = (torch.arange(d_out, device=x.device) * stride - padding)[:, None]
    idx0 = base + torch.floor(shift_c).to(torch.int64)[None, :]
    return tuple(core.gather_axis_zero(x, idx0 + d, axis) for d in (-1, 0, 1))


def _cexpand(v, ndim):
    return v.reshape((1,) * (ndim - 1) + (-1,))


def _axis_diff(x, shift_c, axis, stride, padding, d_out, is_int):
    """Forward difference (+1 tap minus +0 tap), or where the remainder is
    an integer the halved central difference (+1 minus -1)."""
    g_m1, g_0, g_p1 = _axis_taps(x, shift_c, axis, stride, padding, d_out)
    return torch.where(_cexpand(is_int, x.ndim), 0.5 * (g_p1 - g_m1),
                       g_p1 - g_0)


def _axis_lerp(x, shift_c, axis, stride, padding, d_out, r):
    """The uncorrected lerp with the (snapped) remainder r."""
    _, g_0, g_p1 = _axis_taps(x, shift_c, axis, stride, padding, d_out)
    rb = _cexpand(r, x.ndim)
    return (1 - rb) * g_0 + rb * g_p1


def rubiks_shift_2d_shift_grad(og, x, shift, stride=(1, 1), padding=(0, 0)):
    """Raw (un-normalized) (2, C) gradient with respect to the shift, in x's
    dtype: ``g_H = sum og * Lerp_W(Diff_H(x))``, ``g_W = sum og *
    Diff_W(Lerp_H(x))`` over (N, H, W). Plain PyTorch on every device."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    shift = shift.to(x.dtype)
    ho, wo = og.shape[_H_AX], og.shape[_W_AX]

    def remainder(s):
        r = (s - torch.floor(s)).to(x.dtype)
        is_int = r < ZERO_TOL
        return torch.where(is_int, torch.zeros_like(r), r), is_int

    rh, int_h = remainder(shift[0])
    rw, int_w = remainder(shift[1])
    dh = _axis_diff(x, shift[0], _H_AX, sh, ph, ho, int_h)
    grad_h = _axis_lerp(dh, shift[1], _W_AX, sw, pw, wo, rw)
    lh = _axis_lerp(x, shift[0], _H_AX, sh, ph, ho, rh)
    grad_w = _axis_diff(lh, shift[1], _W_AX, sw, pw, wo, int_w)
    axes = (0, 1, 2)
    return torch.stack([(og * grad_h).sum(axes), (og * grad_w).sum(axes)])


def normalize_shift_grad_2d(shift_grad):
    """Per-channel L2 normalization of a (2, C) shift gradient; a channel of
    zero norm passes through unchanged."""
    mag = torch.sqrt((shift_grad * shift_grad).sum(0))
    safe = torch.where(mag > 0, mag, torch.ones_like(mag))
    return torch.where(mag[None, :] > 0, shift_grad / safe[None, :],
                       shift_grad)


# ---------------------------------------------------------- CUDA kernels


def _shift3(shift):
    """(2, C) -> (3, C) with a zero T row, on the shift's device."""
    return torch.cat([torch.zeros_like(shift[:1]), shift])


def shift2d_kernel(x, shift, stride=(1, 1), padding=(0, 0), quantize=False):
    """Kernel K1 in 2D mode on a CUDA tensor (N, H, W, C): the
    (N, 1, H, W, C) view (no copy of x), a zero T row, half-away
    rounding."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    out = shift3d_kernel(x[:, None], _shift3(shift), (1, sh, sw),
                         (0, ph, pw), quantize, quantize_mode=_MODE,
                         counter=LAUNCHES)
    return out[:, 0]


def shift2d_input_grad_kernel(og, shift, in_shape, stride=(1, 1),
                              padding=(0, 0), quantize=False):
    """Kernel K1-inverse in 2D mode on a CUDA tensor (N, Ho, Wo, C)."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    n, h, w, c = (int(v) for v in in_shape)
    gx = shift3d_input_grad_kernel(
        og[:, None], _shift3(shift), (n, 1, h, w, c), (1, sh, sw),
        (0, ph, pw), quantize, quantize_mode=_MODE, counter=INVERSE_LAUNCHES)
    return gx[:, 0]


# ------------------------------------------------------------ the op


def _check_args(x, shift):
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if tuple(shift.shape) != (2, x.shape[-1]):
        raise ValueError(
            f"shift must be (2, C={x.shape[-1]}), got {tuple(shift.shape)}")


@torch.no_grad()
def rubiks_shift_2d_forward(x, shift, stride=(1, 1), padding=(0, 0),
                            quantize=False):
    """Fractional 2D shift of x (N, H, W, C) by shift (2, C), outside
    autograd. K1 in 2D mode for a CUDA tensor, the gather form for a CPU
    tensor; raises for any other device."""
    _check_args(x, shift)
    if _route(x, plain=False):
        return shift2d_kernel(x.contiguous(), shift, stride, padding,
                              quantize)
    return shift2d_plain(x, shift, stride, padding, quantize)


@torch.no_grad()
def rubiks_shift_2d_input_grad(og, shift, in_shape, stride=(1, 1),
                               padding=(0, 0), quantize=False):
    """Gradient of the forward with respect to x for upstream og. K1-inverse
    in 2D mode for a CUDA tensor, the gather form for a CPU tensor."""
    if _route(og, plain=False):
        return shift2d_input_grad_kernel(og.contiguous(), shift, in_shape,
                                         stride, padding, quantize)
    return shift2d_input_grad_plain(og, shift, in_shape, stride, padding,
                                    quantize)


class _RubiksShift2DFunction(torch.autograd.Function):
    """Forward shift; backward returns the input gradient and the
    (optionally normalized) shift gradient in the shift's dtype."""

    @staticmethod
    def forward(ctx, x, shift, stride, padding, quantize, normalize_grad,
                use_kernels):
        ctx.save_for_backward(x, shift)
        ctx.cfg = (stride, padding, quantize, normalize_grad, use_kernels)
        if use_kernels:
            return shift2d_kernel(x.contiguous(), shift, stride, padding,
                                  quantize)
        return shift2d_plain(x, shift, stride, padding, quantize)

    @staticmethod
    def backward(ctx, og):
        x, shift = ctx.saved_tensors
        stride, padding, quantize, normalize_grad, use_kernels = ctx.cfg
        gx = gs = None
        if ctx.needs_input_grad[0]:
            if use_kernels:
                gx = shift2d_input_grad_kernel(og.contiguous(), shift,
                                               x.shape, stride, padding,
                                               quantize)
            else:
                gx = shift2d_input_grad_plain(og, shift, x.shape, stride,
                                              padding, quantize)
        if ctx.needs_input_grad[1]:
            gs = rubiks_shift_2d_shift_grad(og, x, shift, stride, padding)
            if normalize_grad:
                gs = normalize_shift_grad_2d(gs)
            gs = gs.to(shift.dtype)
        return gx, gs, None, None, None, None, None


def rubiks_shift_2d(x, shift, stride=1, padding=0, normalize_grad=True,
                    quantize=False, plain=False):
    """The 2D shift as an autograd op (the reference's functional signature
    on channel-last input). Forward and input gradient run K1 and
    K1-inverse in 2D mode on a CUDA tensor and the gather forms on a CPU
    tensor or with ``plain=True``; the shift gradient is plain PyTorch."""
    _check_args(x, shift)
    return _RubiksShift2DFunction.apply(
        x, shift, _pair(stride), _pair(padding), bool(quantize),
        bool(normalize_grad), _route(x, plain))
