"""Learnable fractional 3D shift, forward (RubiksShift3D).

Counterpart of the forward half of ``rubiksnet_tpu/ops/shift3d.py``. The op
:func:`rubiks_shift_3d_forward` runs kernel K1 (``csrc/shift3d.cu``) on a
CUDA tensor and the plain gather form :func:`shift3d_plain` on a CPU tensor.

The backward (input gradient, the normalized shift gradient and its custom
autograd rule) is not ported yet (ROADMAP A6), so the op refuses to run where
autograd would record it: a wrong, un-normalized shift gradient would
otherwise train silently.
"""

from __future__ import annotations

import torch

from . import _build
from . import shift_core as core

__all__ = [
    "compute_output_shape_3d",
    "rubiks_shift_3d_forward",
    "shift3d_plain",
    "shift3d_kernel",
    "shift_tap_weights",
    "LAUNCHES",
]

# Axis positions in the channel-last video layout (N, T, H, W, C).
_T_AX, _H_AX, _W_AX = 1, 2, 3

LAUNCHES = _build.LaunchCounter("shift3d")


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


def shift3d_plain(x, shift, stride=(1, 1, 1), padding=(0, 0, 0),
                  quantize=False):
    """The gather form: T, then H, then W 1D shifts in x's dtype."""
    st, sh, sw = _triple(stride)
    pt, ph, pw = _triple(padding)
    shift = shift.to(x.dtype)
    out = core.frac_shift_axis(x, shift[0], _T_AX, st, pt, quantize)
    out = core.frac_shift_axis(out, shift[1], _H_AX, sh, ph, quantize)
    return core.frac_shift_axis(out, shift[2], _W_AX, sw, pw, quantize)


def shift3d_kernel(x, shift, stride=(1, 1, 1), padding=(0, 0, 0),
                   quantize=False):
    """Kernel K1 on a CUDA tensor: one pass, trilinear weights in f32."""
    if x.device.type != "cuda" or shift.device != x.device:
        raise ValueError(
            f"shift3d_kernel needs x and shift on one CUDA device, got "
            f"{x.device} and {shift.device}")
    if not x.is_contiguous():
        raise ValueError("shift3d_kernel needs a contiguous x")
    code = _build.dtype_code(x.dtype)
    st, sh, sw = _triple(stride)
    pt, ph, pw = _triple(padding)
    out_shape = compute_output_shape_3d(x.shape, (st, sh, sw), (pt, ph, pw))
    n, t, h, w, c = x.shape
    _, to, ho, wo, _ = out_shape
    # The shift is rounded to the compute dtype, as the gather form does.
    s32 = shift.to(x.dtype).to(torch.float32).contiguous()
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    P, I = _build.PTR, _build.INT
    fn = _build.kernel_function("rubiks_shift3d_fwd", P, P, P, *[I] * 16, P)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), s32.data_ptr(), out.data_ptr(), code, n, t, h,
                w, c, to, ho, wo, st, sh, sw, pt, ph, pw, int(bool(quantize)),
                _build.stream_of(x))
    _build.check(rc, "rubiks_shift3d_fwd")
    LAUNCHES.count += 1
    return out


def refuse_autograd(x, shift):
    """Raise where autograd would record the shift: its backward (the
    normalized shift gradient) is not ported yet."""
    if torch.is_grad_enabled() and (x.requires_grad or shift.requires_grad):
        raise NotImplementedError(
            "the RubiksShift3D backward (normalized shift gradient) is not "
            "ported yet (ROADMAP A6); run inference under torch.no_grad()")


def rubiks_shift_3d_forward(x, shift, stride=(1, 1, 1), padding=(0, 0, 0),
                            quantize=False):
    """Fractional 3D shift of x (N, T, H, W, C) by shift (3, C), rows
    (shift_T, shift_H, shift_W): trilinear interpolation, zero fill, strided
    output grid, optional quantize (remainder < 0.5 rounds down).

    Runs K1 for a CUDA tensor and the gather form for a CPU tensor; raises
    for any other device and wherever autograd would record the op.
    """
    if x.ndim != 5:
        raise ValueError(f"x must be (N, T, H, W, C), got {tuple(x.shape)}")
    if tuple(shift.shape) != (3, x.shape[-1]):
        raise ValueError(
            f"shift must be (3, C={x.shape[-1]}), got {tuple(shift.shape)}")
    refuse_autograd(x, shift)
    if x.device.type == "cuda":
        return shift3d_kernel(x, shift, stride, padding, quantize)
    if x.device.type == "cpu":
        return shift3d_plain(x, shift, stride, padding, quantize)
    raise ValueError(f"unsupported device {x.device}")
