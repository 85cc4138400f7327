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


def frac_shift_axis(x: torch.Tensor, shift_c: torch.Tensor, axis: int,
                    stride: int, padding: int,
                    quantize: bool) -> torch.Tensor:
    """Per-channel 1D fractional shift along ``axis``.

    Output position o reads input position ``o*stride - padding +
    shift_c`` with linear interpolation between the floor and floor+1 taps
    and zero fill. Quantize reads one tap: floor when the remainder is below
    0.5, else floor+1 (the 3D ``half_up`` rule).
    """
    d_out = output_len(x.shape[axis], stride, padding)
    base = (torch.arange(d_out, device=x.device) * stride - padding)[:, None]
    sf = torch.floor(shift_c)
    small = sf.to(torch.int64)[None, :]
    r = (shift_c - sf).to(x.dtype)
    if quantize:
        q = torch.where(r < 0.5, small, small + 1)
        return gather_axis_zero(x, base + q, axis)
    g0 = gather_axis_zero(x, base + small, axis)
    g1 = gather_axis_zero(x, base + small + 1, axis)
    rb = r.reshape((1,) * (x.ndim - 1) + (-1,))
    return (1 - rb) * g0 + rb * g1
