"""One stride-2 stage-entry RubiksNet block with channel growth, inference
(K3).

    a   = relu(bn1(x))
    out = W3 . [SE] shift3d_s2(relu(bn2(W2 . a))) + Wsc . a[:, :, ::2, ::2]

With ``se`` (the SE tiers) the stride-2 shifted activation is gated per
(clip, frame, channel) by ``sigmoid(relu(mean_hw . fc1) . fc2)``, the mean
taken over the decimated (H/2, W/2) grid. Counterpart of
``rubiksnet_tpu/ops/pallas/fused_entry.py`` (rubiks3d only: the executor
keeps rubiks3d-aq entries on the module path).
:func:`fused_entry_run` launches ``csrc/fused_entry.cu`` for a CUDA tensor
and runs :func:`fused_entry_plain` for a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _build
from .fused_block import (
    KERNEL_MAX_TAPS,
    _bn_fold,
    conv1x1_matrix,
    se_gate,
    se_slices,
    stack_taps,
    tap_shift,
    taps_from_rows,
)

LAUNCHES = _build.LaunchCounter("fused_entry")


@torch.no_grad()
def stack_entry_params(block, dtype, max_shift, quantize=False):
    """Fold one stride-2 RubiksShiftBlock into the kernel's arrays.

    Returns (vt1, vt2, w2, w3, wsc): vt1 (2, Cin) float32 folded bn1; vt2
    (2 + 3*taps_n, mid) float32 folded bn2 then the T, H, W tap weights;
    w2, wsc (Cin, mid) and w3 (mid, mid) in dtype, as (in, out).
    """
    s1, b1 = _bn_fold(block.bn1)
    s2, b2 = _bn_fold(block.bn2)
    taps = stack_taps(block.as3.rubiks3d.shift, dtype, max_shift, quantize)
    vt1 = torch.stack([s1, b1]).float().contiguous()
    vt2 = torch.cat([torch.stack([s2, b2]).float(), taps]).contiguous()
    return (vt1, vt2, conv1x1_matrix(block.conv2, dtype),
            conv1x1_matrix(block.conv3, dtype),
            conv1x1_matrix(block.shortcut, dtype))


def fused_entry_plain(x, params, se=None, *, max_shift):
    """The entry block in plain PyTorch: the stride-2 shift as the
    stride-1 shift sampled at even rows and columns."""
    vt1, vt2, w2, w3, wsc = params
    taps_n = taps_from_rows(vt2.shape[0], 2)
    dt = x.dtype
    a = torch.relu(x.float() * vt1[0] + vt1[1]).to(dt)
    mid = torch.relu((a @ w2).float() * vt2[0] + vt2[1]).to(dt)
    v = tap_shift(mid.float(), vt2[2:2 + 3 * taps_n], max_shift)
    v = v[:, :, ::2, ::2]
    if se is not None:
        v = v * se_gate(v, se)[:, :, None, None, :]
    sc = a[:, :, ::2, ::2] @ wsc
    return ((v.to(dt) @ w3).float() + sc.float()).to(dt)


def _check_args(x, params, se, max_shift):
    vt1, vt2, w2, w3, wsc = params
    if x.ndim != 5:
        raise ValueError(f"x must be (N, T, H, W, C), got {tuple(x.shape)}")
    n, t, h, w, cin = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"fused entry needs even H and W, got {h}x{w}")
    mid = w2.shape[1]
    taps_n = taps_from_rows(vt2.shape[0], 2)
    if taps_n > 2 * max_shift + 2:
        raise ValueError(f"{taps_n} taps exceed max_shift={max_shift}")
    want = {"vt1": (vt1, (2, cin), torch.float32),
            "vt2": (vt2, (2 + 3 * taps_n, mid), torch.float32),
            "w2": (w2, (cin, mid), x.dtype),
            "w3": (w3, (mid, mid), x.dtype),
            "wsc": (wsc, (cin, mid), x.dtype)}
    for name, (arr, shape, dtype) in want.items():
        if tuple(arr.shape) != shape or arr.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{arr.dtype} {tuple(arr.shape)}")
    if se is not None and (se.ndim != 3 or se.shape[:2] != (2, mid)
                           or se.dtype != torch.float32):
        raise ValueError(f"se must be float32 (2, {mid}, Cr), got "
                         f"{se.dtype} {tuple(se.shape)}")
    return taps_n


def fused_entry_kernel(x, params, se=None, *, max_shift):
    """Kernel K3 on CUDA tensors: one C call (two launches, and with ``se``
    two more for the gate)."""
    taps_n = _check_args(x, params, se, max_shift)
    if taps_n > KERNEL_MAX_TAPS:
        raise ValueError(f"the CUDA kernel takes <= {KERNEL_MAX_TAPS} taps")
    for arr in (x, *params) if se is None else (x, *params, se):
        if arr.device != x.device or x.device.type != "cuda":
            raise ValueError("fused_entry_kernel needs x and params on one "
                             f"CUDA device, got {arr.device} and {x.device}")
        if not arr.is_contiguous():
            raise ValueError("fused_entry_kernel needs contiguous arrays")
    vt1, vt2, w2, w3, wsc = params
    code = _build.dtype_code(x.dtype)
    n, t, h, w, cin = x.shape
    cmid = w2.shape[1]
    mid = torch.empty((n, t, h, w, cmid), dtype=x.dtype, device=x.device)
    out = torch.empty((n, t, h // 2, w // 2, cmid), dtype=x.dtype,
                      device=x.device)
    cr = slices = 0
    se_ptr = partial_ptr = gate_ptr = None
    if se is not None:
        cr, slices = se.shape[2], se_slices(h)
        partial = torch.empty((n * t, slices, cmid), dtype=torch.float32,
                              device=x.device)
        gate = torch.empty((n * t, cmid), dtype=torch.float32,
                           device=x.device)
        se_ptr, partial_ptr, gate_ptr = (se.data_ptr(), partial.data_ptr(),
                                         gate.data_ptr())
    P, I = _build.PTR, _build.INT
    fn = _build.kernel_function("rubiks_fused_entry", *[P] * 11, *[I] * 11,
                                P)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), vt1.data_ptr(), vt2.data_ptr(), w2.data_ptr(),
                w3.data_ptr(), wsc.data_ptr(), se_ptr, partial_ptr, gate_ptr,
                mid.data_ptr(), out.data_ptr(), code, n, t, h, w, cin, cmid,
                taps_n, max_shift, cr, slices, _build.stream_of(x))
    _build.check(rc, "rubiks_fused_entry")
    LAUNCHES.count += 1
    return out


def fused_entry_run(x, params, se=None, *, max_shift):
    """Apply one fused stride-2 entry block to x (N, T, H, W, Cin), H and W
    even; returns (N, T, H/2, W/2, mid). params from
    :func:`stack_entry_params`; se: None or (2, mid, Cr) float32, one entry
    of ``fused_block.stack_se_params``. Runs K3 for a CUDA tensor and the
    plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return fused_entry_kernel(x, params, se, max_shift=max_shift)
    if x.device.type == "cpu":
        _check_args(x, params, se, max_shift)
        return fused_entry_plain(x, params, se, max_shift=max_shift)
    raise ValueError(f"unsupported device {x.device}")
