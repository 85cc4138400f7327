"""Learnable fractional 3D shift (RubiksShift3D) with its custom gradient.

Counterpart of ``rubiksnet_tpu/ops/shift3d.py``. Three functions, each a
CUDA kernel beside its plain gather form:

* forward: K1 ``csrc/shift3d.cu::rubiks_shift3d_fwd`` / :func:`shift3d_plain`;
* input gradient (the inverse shift of the upstream gradient): K1-inverse
  ``csrc/shift3d.cu::rubiks_shift3d_inv`` / :func:`shift3d_input_grad_plain`;
* raw (3, C) shift gradient: K4 ``csrc/shift_grad.cu`` /
  :func:`shift3d_shift_grad_plain`.

:func:`rubiks_shift_3d` ties them into an autograd op whose shift gradient
is unit-normalized per channel (:func:`normalize_shift_grad_3d`): the
reference's rule, which is not the true derivative of the forward. A CUDA
tensor runs the kernels and a CPU tensor the plain forms; ``plain=True``
runs the plain forms on any device.
"""

from __future__ import annotations

import torch

from . import _build
from . import shift_core as core

__all__ = [
    "compute_output_shape_3d",
    "normalize_shift_grad_3d",
    "rubiks_shift_3d",
    "rubiks_shift_3d_forward",
    "shift3d_input_grad_kernel",
    "shift3d_input_grad_plain",
    "shift3d_kernel",
    "shift3d_plain",
    "shift3d_shift_grad_kernel",
    "shift3d_shift_grad_plain",
    "shift_tap_weights",
    "LAUNCHES",
    "INVERSE_LAUNCHES",
    "SHIFT_GRAD_LAUNCHES",
]

# Axis positions in the channel-last video layout (N, T, H, W, C).
_T_AX, _H_AX, _W_AX = 1, 2, 3

LAUNCHES = _build.LaunchCounter("shift3d")
INVERSE_LAUNCHES = _build.LaunchCounter("shift3d_inverse")
SHIFT_GRAD_LAUNCHES = _build.LaunchCounter("shift_grad")


def _triple(v):
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(int(u) for u in v)
    if len(t) != 3:
        raise ValueError(f"expected 3 entries, got {v}")
    return t


def compute_output_shape_3d(shape, stride, padding):
    """(N, T, H, W, C) output shape of the shift."""
    n, t, h, w, c = shape
    st, sh, sw = _triple(stride)
    pt, ph, pw = _triple(padding)
    return (n, core.output_len(t, st, pt), core.output_len(h, sh, ph),
            core.output_len(w, sw, pw), c)


def shift_tap_weights(shift_c: torch.Tensor, dtype: torch.dtype,
                      max_shift: int, quantize: bool) -> torch.Tensor:
    """Per-channel tap weights (2*max_shift + 2, C) of a 1D shift, in dtype.

    Tap j reads offset j - max_shift. The shift is rounded to ``dtype``
    first, as the compute path sees it. Fractional: ``1 - frac`` at
    ``floor(s)`` and ``frac`` at ``floor(s) + 1``; quantize: a one-hot at
    ``floor(s)`` if ``frac < 0.5`` else ``floor(s) + 1``. Counterpart of
    ``rubiksnet_tpu/ops/conv_backend.py::_shift_kernel``.
    """
    shift_c = shift_c.to(dtype)
    k = torch.floor(shift_c)
    r = (shift_c - k).to(dtype)
    ki = k.to(torch.int64)
    j = torch.arange(2 * max_shift + 2, device=shift_c.device)[:, None]
    j = j - max_shift
    if quantize:
        q = torch.where(r < 0.5, ki, ki + 1)
        return (j == q[None, :]).to(dtype)
    w0 = (j == ki[None, :]).to(dtype) * (1 - r)[None, :]
    w1 = (j == (ki + 1)[None, :]).to(dtype) * r[None, :]
    return w0 + w1


# ------------------------------------------------------------ plain forms


def shift3d_plain(x, shift, stride=(1, 1, 1), padding=(0, 0, 0),
                  quantize=False):
    """The gather form: T, then H, then W 1D shifts in x's dtype."""
    st, sh, sw = _triple(stride)
    pt, ph, pw = _triple(padding)
    shift = shift.to(x.dtype)
    out = core.frac_shift_axis(x, shift[0], _T_AX, st, pt, quantize)
    out = core.frac_shift_axis(out, shift[1], _H_AX, sh, ph, quantize)
    return core.frac_shift_axis(out, shift[2], _W_AX, sw, pw, quantize)


def shift3d_input_grad_plain(og, shift, in_shape, stride=(1, 1, 1),
                             padding=(0, 0, 0), quantize=False):
    """Gradient with respect to x: the inverse shift of og, T then H then W,
    in og's dtype. Quantize reads the quantized taps of the negated shift
    (at a remainder of exactly 0.5 that is not the forward's transpose; it
    is the reference's rule)."""
    st, sh, sw = _triple(stride)
    pt, ph, pw = _triple(padding)
    shift = shift.to(og.dtype)
    g = core.inverse_shift_axis(og, shift[0], _T_AX, st, pt,
                                in_shape[_T_AX], quantize)
    g = core.inverse_shift_axis(g, shift[1], _H_AX, sh, ph, in_shape[_H_AX],
                                quantize)
    return core.inverse_shift_axis(g, shift[2], _W_AX, sw, pw,
                                   in_shape[_W_AX], quantize)


def shift3d_shift_grad_plain(og, x, shift, stride=(1, 1, 1),
                             padding=(0, 0, 0)):
    """Raw (un-normalized) (3, C) gradient with respect to the shift, in
    float32 (float64 for float64 inputs).

    With corrected per-axis lerp taps L'_a and differences D_a (the small
    tap moves back one cell at an exact-integer remainder):

        g_T = sum og * L'_W(L'_H(D_T(x)))
        g_H = sum og * L'_W(D_H(L'_T(x)))
        g_W = sum og * D_W(L'_H(L'_T(x)))

    summed over (N, T, H, W). The shift is rounded to x's dtype first;
    x, og and the shift are then taken in at least float32, as the kernel
    does. The formulas ignore quantize, as the reference does.
    """
    st, sh, sw = _triple(stride)
    pt, ph, pw = _triple(padding)
    acc = torch.promote_types(x.dtype, torch.float32)
    shift = shift.to(x.dtype).to(acc)
    x, og = x.to(acc), og.to(acc)
    to, ho, wo = og.shape[_T_AX], og.shape[_H_AX], og.shape[_W_AX]

    def lerp(a, b, r):
        return (1 - r) * a + r * b

    at, bt, rt = core.corrected_taps(x, shift[0], _T_AX, st, pt, to)
    u, v = lerp(at, bt, rt), bt - at  # L'_T(x), D_T(x)
    ah_u, bh_u, rh = core.corrected_taps(u, shift[1], _H_AX, sh, ph, ho)
    lh_u, dh_u = lerp(ah_u, bh_u, rh), bh_u - ah_u
    ah_v, bh_v, _ = core.corrected_taps(v, shift[1], _H_AX, sh, ph, ho)
    lh_v = lerp(ah_v, bh_v, rh)
    aw, bw, rw = core.corrected_taps(lh_v, shift[2], _W_AX, sw, pw, wo)
    grad_t = lerp(aw, bw, rw)
    aw, bw, _ = core.corrected_taps(dh_u, shift[2], _W_AX, sw, pw, wo)
    grad_h = lerp(aw, bw, rw)
    aw, bw, _ = core.corrected_taps(lh_u, shift[2], _W_AX, sw, pw, wo)
    grad_w = bw - aw
    axes = (0, 1, 2, 3)
    return torch.stack([(og * grad_t).sum(axes), (og * grad_h).sum(axes),
                        (og * grad_w).sum(axes)])


def normalize_shift_grad_3d(shift_grad, normalize_t_factor):
    """Per-channel unit normalization of a (3, C) shift gradient.

    The T row is scaled by ``normalize_t_factor`` and each channel's (T, H,
    W) triple is divided by its norm. A negative factor keeps the raw T row
    and zeroes H and W (then normalizes); a channel of zero norm passes
    through unchanged.
    """
    f = float(normalize_t_factor)
    gt, gh, gw = shift_grad[0], shift_grad[1], shift_grad[2]
    if f < 0:
        cur = torch.stack([gt, torch.zeros_like(gh), torch.zeros_like(gw)])
    else:
        cur = torch.stack([gt * f, gh, gw])
    mag = torch.sqrt((cur * cur).sum(0))
    safe = torch.where(mag > 0, mag, torch.ones_like(mag))
    return torch.where(mag[None, :] > 0, cur / safe[None, :], cur)


# ---------------------------------------------------------- CUDA kernels


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name} needs its tensors on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")


def _shift_f32(shift, dtype):
    # The shift is rounded to the compute dtype, as the gather form does.
    return shift.to(dtype).to(torch.float32).contiguous()


def quantize_code(quantize: bool, quantize_mode: str) -> int:
    """The kernels' rounding argument: 0 fractional, 1 ``half_up`` (the 3D
    rule), 2 ``half_away`` (the 2D rule, see shift_core)."""
    if quantize_mode not in core.QUANTIZE_MODES:
        raise ValueError(f"unknown quantize_mode {quantize_mode!r}")
    if not quantize:
        return 0
    return 1 + core.QUANTIZE_MODES.index(quantize_mode)


def shift3d_kernel(x, shift, stride=(1, 1, 1), padding=(0, 0, 0),
                   quantize=False, *, quantize_mode="half_up",
                   counter=None):
    """Kernel K1 on a CUDA tensor: one pass, trilinear weights in f32.
    ``counter`` is the launch counter to add to (default K1's own; the 2D
    shift passes its own)."""
    _check_cuda("shift3d_kernel", x, shift)
    code = _build.dtype_code(x.dtype)
    st, sh, sw = _triple(stride)
    pt, ph, pw = _triple(padding)
    out_shape = compute_output_shape_3d(x.shape, (st, sh, sw), (pt, ph, pw))
    n, t, h, w, c = x.shape
    _, to, ho, wo, _ = out_shape
    s32 = _shift_f32(shift, x.dtype)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    P, I = _build.PTR, _build.INT
    fn = _build.kernel_function("rubiks_shift3d_fwd", P, P, P, *[I] * 16, P)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), s32.data_ptr(), out.data_ptr(), code, n, t, h,
                w, c, to, ho, wo, st, sh, sw, pt, ph, pw,
                quantize_code(quantize, quantize_mode), _build.stream_of(x))
    _build.check(rc, "rubiks_shift3d_fwd")
    (LAUNCHES if counter is None else counter).count += 1
    return out


def shift3d_input_grad_kernel(og, shift, in_shape, stride=(1, 1, 1),
                              padding=(0, 0, 0), quantize=False, *,
                              quantize_mode="half_up", counter=None):
    """Kernel K1-inverse on a CUDA tensor: the input gradient in one pass,
    one thread per input element, stride-gated, weights in f32. ``counter``
    as for :func:`shift3d_kernel`."""
    _check_cuda("shift3d_input_grad_kernel", og, shift)
    code = _build.dtype_code(og.dtype)
    st, sh, sw = _triple(stride)
    pt, ph, pw = _triple(padding)
    in_shape = tuple(int(v) for v in in_shape)
    if compute_output_shape_3d(in_shape, (st, sh, sw),
                               (pt, ph, pw)) != tuple(og.shape):
        raise ValueError(f"og {tuple(og.shape)} is not the output shape of "
                         f"{in_shape} at stride {stride} padding {padding}")
    n, t, h, w, c = in_shape
    _, to, ho, wo, _ = og.shape
    s32 = _shift_f32(shift, og.dtype)
    gx = torch.empty(in_shape, dtype=og.dtype, device=og.device)
    P, I = _build.PTR, _build.INT
    fn = _build.kernel_function("rubiks_shift3d_inv", P, P, P, *[I] * 16, P)
    with torch.cuda.device(og.device):
        rc = fn(og.data_ptr(), s32.data_ptr(), gx.data_ptr(), code, n, t, h,
                w, c, to, ho, wo, st, sh, sw, pt, ph, pw,
                quantize_code(quantize, quantize_mode), _build.stream_of(og))
    _build.check(rc, "rubiks_shift3d_inv")
    (INVERSE_LAUNCHES if counter is None else counter).count += 1
    return gx


def shift_grad_slices(rows: int, c: int, sms: int) -> int:
    """Row slices of K4's first pass: one block per (slice, 32-channel
    tile), about 8 blocks per SM, at least 64 rows a slice. It depends on
    the shape and the card only, so the summation order is fixed."""
    ctiles = -(-c // 32)
    return max(1, min(max(1, 8 * sms // ctiles), -(-rows // 64)))


def shift3d_shift_grad_kernel(og, x, shift, stride=(1, 1, 1),
                              padding=(0, 0, 0)):
    """Kernel K4 on CUDA tensors: the raw (3, C) float32 shift gradient,
    reduced per channel in a fixed order (bit-identical run to run)."""
    _check_cuda("shift3d_shift_grad_kernel", og, x, shift)
    if og.dtype != x.dtype:
        raise TypeError(f"og {og.dtype} and x {x.dtype} differ")
    code = _build.dtype_code(x.dtype)
    st, sh, sw = _triple(stride)
    pt, ph, pw = _triple(padding)
    if compute_output_shape_3d(x.shape, (st, sh, sw),
                               (pt, ph, pw)) != tuple(og.shape):
        raise ValueError(f"og {tuple(og.shape)} is not the output shape of "
                         f"{tuple(x.shape)} at stride {stride}")
    n, t, h, w, c = x.shape
    _, to, ho, wo, _ = og.shape
    s32 = _shift_f32(shift, x.dtype)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    slices = shift_grad_slices(n * to * ho * wo, c, sms)
    partial = torch.empty((slices, 3, c), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((3, c), dtype=torch.float32, device=x.device)
    P, I = _build.PTR, _build.INT
    fn = _build.kernel_function("rubiks_shift_grad", P, P, P, P, P,
                                *[I] * 16, P)
    with torch.cuda.device(x.device):
        rc = fn(og.data_ptr(), x.data_ptr(), s32.data_ptr(),
                partial.data_ptr(), out.data_ptr(), code, n, t, h, w, c, to,
                ho, wo, st, sh, sw, pt, ph, pw, slices, _build.stream_of(x))
    _build.check(rc, "rubiks_shift_grad")
    SHIFT_GRAD_LAUNCHES.count += 1
    return out


# ------------------------------------------------------------ the op


def _route(x, plain):
    """True to run the kernels, False for the plain forms."""
    if x.device.type == "cuda":
        return not plain
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


def _check_args(x, shift):
    if x.ndim != 5:
        raise ValueError(f"x must be (N, T, H, W, C), got {tuple(x.shape)}")
    if tuple(shift.shape) != (3, x.shape[-1]):
        raise ValueError(
            f"shift must be (3, C={x.shape[-1]}), got {tuple(shift.shape)}")


@torch.no_grad()
def rubiks_shift_3d_forward(x, shift, stride=(1, 1, 1), padding=(0, 0, 0),
                            quantize=False):
    """Fractional 3D shift of x (N, T, H, W, C) by shift (3, C), rows
    (shift_T, shift_H, shift_W): trilinear interpolation, zero fill, strided
    output grid, optional quantize (remainder < 0.5 rounds down). Outside
    autograd (the result has no gradient): :func:`rubiks_shift_3d` is the
    op with the reference's gradient.

    Runs K1 for a CUDA tensor and the gather form for a CPU tensor; raises
    for any other device.
    """
    _check_args(x, shift)
    if _route(x, plain=False):
        return shift3d_kernel(x, shift, stride, padding, quantize)
    return shift3d_plain(x, shift, stride, padding, quantize)


class _RubiksShift3DFunction(torch.autograd.Function):
    """Forward shift; backward returns the input gradient and the
    (optionally normalized) shift gradient in the shift's dtype."""

    @staticmethod
    def forward(ctx, x, shift, stride, padding, quantize, normalize_grad,
                normalize_t_factor, use_kernels):
        ctx.save_for_backward(x, shift)
        ctx.cfg = (stride, padding, quantize, normalize_grad,
                   normalize_t_factor, use_kernels)
        if use_kernels:
            return shift3d_kernel(x.contiguous(), shift, stride, padding,
                                  quantize)
        return shift3d_plain(x, shift, stride, padding, quantize)

    @staticmethod
    def backward(ctx, og):
        x, shift = ctx.saved_tensors
        (stride, padding, quantize, normalize_grad, normalize_t_factor,
         use_kernels) = ctx.cfg
        gx = gs = None
        if use_kernels:
            og, x = og.contiguous(), x.contiguous()
        if ctx.needs_input_grad[0]:
            fn = (shift3d_input_grad_kernel if use_kernels
                  else shift3d_input_grad_plain)
            gx = fn(og, shift, x.shape, stride, padding, quantize)
        if ctx.needs_input_grad[1]:
            fn = (shift3d_shift_grad_kernel if use_kernels
                  else shift3d_shift_grad_plain)
            gs = fn(og, x, shift, stride, padding)
            if normalize_grad:
                gs = normalize_shift_grad_3d(gs, normalize_t_factor)
            gs = gs.to(shift.dtype)
        return gx, gs, None, None, None, None, None, None


def rubiks_shift_3d(x, shift, stride=1, padding=0, normalize_grad=True,
                    normalize_t_factor=1.0, quantize=False, plain=False):
    """The shift as an autograd op (the reference's functional signature on
    channel-last input).

    Forward as :func:`rubiks_shift_3d_forward`. Backward: the inverse shift
    of the upstream gradient for x, and for the shift the raw gradient of
    :func:`shift3d_shift_grad_plain`, normalized per channel by
    :func:`normalize_shift_grad_3d` when ``normalize_grad``.
    ``normalize_t_factor`` is a number or ``"auto"`` (T / H of x). Kernels on
    a CUDA tensor, plain forms on a CPU tensor or with ``plain=True``.
    """
    _check_args(x, shift)
    if normalize_t_factor == "auto":
        normalize_t_factor = x.shape[_T_AX] / x.shape[_H_AX]
    elif not isinstance(normalize_t_factor, (int, float)):
        raise TypeError(
            f"normalize_t_factor must be a number or 'auto', got "
            f"{normalize_t_factor!r}")
    return _RubiksShift3DFunction.apply(
        x, shift, _triple(stride), _triple(padding), bool(quantize),
        bool(normalize_grad), float(normalize_t_factor), _route(x, plain))
