"""Per-axis primitives of the RubiksShift ops, in plain PyTorch.

Trilinear interpolation with zero fill outside the tensor is separable: it is
three per-channel 1D fractional shifts, one per axis, on a channel-last
tensor whose last axis is channels. Counterpart of
``rubiksnet_tpu/ops/shift_core.py``.
"""

from __future__ import annotations

import torch


def output_len(n: int, stride: int, padding: int) -> int:
    """Output length along one axis: ``(n + 2p - 1) // s + 1``."""
    if stride <= 0:
        raise ValueError(f"stride must be > 0, got {stride}")
    out = (n + 2 * padding - 1) // stride + 1
    if out < 0:
        raise ValueError(
            f"computed output size is negative: {out} "
            f"(input={n}, stride={stride}, padding={padding})")
    return out


def gather_axis_zero(x: torch.Tensor, idx: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """Gather ``x`` along ``axis`` at per-channel indices ``idx`` (D_out, C),
    with zero for indices outside ``[0, x.shape[axis])``."""
    d_in = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = idx.shape[0]
    shape[-1] = idx.shape[1]
    idx_b = idx.reshape(shape)
    valid = (idx_b >= 0) & (idx_b < d_in)
    out_shape = list(x.shape)
    out_shape[axis] = idx.shape[0]
    safe = idx_b.clamp(0, d_in - 1).expand(out_shape)
    gathered = torch.gather(x, axis, safe)
    return torch.where(valid, gathered, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


QUANTIZE_MODES = ("half_up", "half_away")


def round_half_away(base: torch.Tensor, shift_c: torch.Tensor):
    """``base + shift_c`` rounded half away from zero, as int64 (D, C).

    base: integer coordinates (D, 1); shift_c: (C,), already rounded to the
    compute dtype. The sum is taken in at least float32, so the index grid
    stays exact for a bfloat16 shift (the CUDA kernels do the same).
    """
    acc = torch.promote_types(shift_c.dtype, torch.float32)
    v = base.to(acc) + shift_c.to(acc)[None, :]
    return torch.where(v < 0, torch.trunc(v - 0.5),
                       torch.trunc(v + 0.5)).to(torch.int64)


def _check_mode(quantize_mode: str) -> None:
    if quantize_mode not in QUANTIZE_MODES:
        raise ValueError(f"quantize_mode must be one of {QUANTIZE_MODES}, "
                         f"got {quantize_mode!r}")


def frac_shift_axis(x: torch.Tensor, shift_c: torch.Tensor, axis: int,
                    stride: int, padding: int, quantize: bool,
                    quantize_mode: str = "half_up") -> torch.Tensor:
    """Per-channel 1D fractional shift along ``axis``.

    Output position o reads input position ``o*stride - padding +
    shift_c`` with linear interpolation between the floor and floor+1 taps
    and zero fill. Quantize reads one tap. ``half_up`` (the 3D rule): floor
    when the remainder is below 0.5, else floor+1. ``half_away`` (the 2D
    rule): the coordinate ``base + shift_c`` itself rounded half away from
    zero, so the index grid enters the rounding (the sign matters).
    """
    _check_mode(quantize_mode)
    d_out = output_len(x.shape[axis], stride, padding)
    base = (torch.arange(d_out, device=x.device) * stride - padding)[:, None]
    sf = torch.floor(shift_c)
    small = sf.to(torch.int64)[None, :]
    r = (shift_c - sf).to(x.dtype)
    if quantize:
        if quantize_mode == "half_away":
            return gather_axis_zero(x, round_half_away(base, shift_c), axis)
        q = torch.where(r < 0.5, small, small + 1)
        return gather_axis_zero(x, base + q, axis)
    g0 = gather_axis_zero(x, base + small, axis)
    g1 = gather_axis_zero(x, base + small + 1, axis)
    rb = r.reshape((1,) * (x.ndim - 1) + (-1,))
    return (1 - rb) * g0 + rb * g1


def _strided_tap(og: torch.Tensor, j: torch.Tensor, axis: int,
                 stride: int) -> torch.Tensor:
    """og gathered along ``axis`` at output position ``j // stride`` for raw
    coordinates ``j`` (D_in, C), zero where ``j`` is not a multiple of the
    stride or ``j // stride`` lies outside og."""
    divisible = torch.remainder(j, stride) == 0
    q = torch.where(divisible, torch.div(j, stride, rounding_mode="floor"),
                    torch.full_like(j, -1))
    return gather_axis_zero(og, q, axis)


def inverse_shift_axis(og: torch.Tensor, shift_c: torch.Tensor, axis: int,
                       stride: int, padding: int, d_in: int, quantize: bool,
                       quantize_mode: str = "half_up") -> torch.Tensor:
    """Input gradient of :func:`frac_shift_axis` along ``axis``.

    Input position i pulls from output position ``(i + padding + s') /
    stride`` for the negated shift ``s' = -shift_c``, where that raw
    coordinate is a multiple of the stride, with linear interpolation on
    the remainder of ``s'`` (quantize: one tap; ``half_up`` rounds a
    remainder < 0.5 down, ``half_away`` rounds ``i + padding + s'`` half
    away from zero). Returns og's shape with ``d_in`` along ``axis``.
    """
    _check_mode(quantize_mode)
    offs = (torch.arange(d_in, device=og.device) + padding)[:, None]
    neg = -shift_c
    sf = torch.floor(neg)
    small = sf.to(torch.int64)[None, :]
    r = (neg - sf).to(og.dtype)
    if quantize:
        if quantize_mode == "half_away":
            return _strided_tap(og, round_half_away(offs, neg), axis, stride)
        q = torch.where(r < 0.5, small, small + 1)
        return _strided_tap(og, offs + q, axis, stride)
    g0 = _strided_tap(og, offs + small, axis, stride)
    g1 = _strided_tap(og, offs + small + 1, axis, stride)
    rb = r.reshape((1,) * (og.ndim - 1) + (-1,))
    return (1 - rb) * g0 + rb * g1


def corrected_taps(x: torch.Tensor, shift_c: torch.Tensor, axis: int,
                   stride: int, padding: int, d_out: int):
    """The two corner gathers of the shift gradient along ``axis``.

    The small tap moves back one cell where the remainder is exactly zero
    (a backward difference at integer shifts; 3D rule, no tolerance).
    Returns ``(g_small, g_large, r)``: x gathered at output positions
    ``o * stride - padding`` plus the corrected small and the large offset,
    and the remainder.
    """
    base = (torch.arange(d_out, device=x.device) * stride - padding)[:, None]
    sf = torch.floor(shift_c)
    small = sf.to(torch.int64)
    r = (shift_c - sf).to(x.dtype)
    small_corr = small - (r == 0).to(torch.int64)
    g_small = gather_axis_zero(x, base + small_corr[None, :], axis)
    g_large = gather_axis_zero(x, base + (small + 1)[None, :], axis)
    return g_small, g_large, r
