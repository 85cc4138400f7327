"""A run of stride-1 identity-shortcut RubiksNet blocks, inference (K2).

Each block computes

    x <- x + W3 . [SE] shift3d(relu(bn2(W2 . [AQ] relu(bn1(x)))))

with BN folded to scale/bias and the shift given as per-axis tap weights.
``aq=True`` (the rubiks3d-aq variant) mixes the activated input along T with
three per-channel attention taps before W2, and its shift is 2D: the T tap
row is the identity. ``se`` (the SE tiers) gates the shifted activation per
(clip, frame, channel) by ``sigmoid(relu(mean_hw . fc1) . fc2)`` before W3.
Counterpart of ``rubiksnet_tpu/ops/pallas/fused_block.py`` and
``ops/pallas/fused_frames.py`` (the same contract).
:func:`fused_block_run` launches ``csrc/fused_block.cu`` once per block for a
CUDA tensor, and runs :func:`fused_block_plain` for a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .attention_shift import TEMPERATURE, attention_shift_weights
from .shift3d import shift_tap_weights

BN_EPS = 1e-5
KERNEL_MAX_TAPS = 16  # taps per axis the CUDA kernels stage (max_shift <= 7)

LAUNCHES = _build.LaunchCounter("fused_block")


def fold_bn(gamma, beta, mean, var, eps=BN_EPS):
    """Inference batch norm as y = scale * x + bias."""
    scale = gamma / torch.sqrt(var + eps)
    return scale, beta - mean * scale


def check_shift_bound(shift: torch.Tensor, max_shift: int,
                      quantize: bool) -> None:
    """Raise if the tap window [-K, K+1] cannot represent every shift.

    The gather form and K1 take any shift; the tap-weight form of the fused
    kernels holds fractional shifts in [-K, K] and quantized shifts that
    round into [-K, K+1]. Outside that they would read zero silently.
    """
    s = shift.detach().to(torch.float32)
    if quantize:
        f = torch.floor(s)
        q = torch.where(s - f < 0.5, f, f + 1)
        bad = bool(((q < -max_shift) | (q > max_shift + 1)).any())
    else:
        bad = bool(((s < -max_shift) | (s > max_shift)).any())
    if bad:
        raise ValueError(
            f"shift values outside the max_shift={max_shift} tap window "
            f"(quantize={quantize}); build the model with a larger max_shift")


def stack_taps(shift, dtype, max_shift, quantize):
    """(3 * taps_n, C) float32 tap weights of a (3, C) shift.

    Fractional mode drops the tap at offset K+1, identically zero whenever
    |s| <= K. Quantize mode keeps it: a shift in (K+0.5, K+1] rounds onto it.
    """
    check_shift_bound(shift, max_shift, quantize)
    tn = 2 * max_shift + 2 if quantize else 2 * max_shift + 1
    return torch.cat([
        shift_tap_weights(shift[a], dtype, max_shift, quantize)[:tn]
        for a in range(3)
    ]).to(torch.float32)


def _bn_fold(bn):
    return fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var)


def conv1x1_matrix(conv, dtype):
    """A 1x1 conv weight (out, in, 1, 1) as an (in, out) matrix in dtype."""
    w = conv.weight
    return w.reshape(w.shape[0], w.shape[1]).t().to(dtype).contiguous()


@torch.no_grad()
def stack_block_params(blocks, dtype, max_shift, quantize=False):
    """Stack stride-1 RubiksShiftBlock modules into the kernel's arrays.

    Returns vt (B, 4 + 3*taps_n, C) float32 = folded bn1 scale/bias, bn2
    scale/bias, then the T, H, W tap weights; and wm (B, 2, C, C) in dtype =
    conv2 and conv3 as (in, out).
    """
    vts, wms = [], []
    for blk in blocks:
        s1, b1 = _bn_fold(blk.bn1)
        s2, b2 = _bn_fold(blk.bn2)
        taps = stack_taps(blk.as3.rubiks3d.shift, dtype, max_shift, quantize)
        vts.append(torch.cat([torch.stack([s1, b1, s2, b2]).float(), taps]))
        wms.append(torch.stack([conv1x1_matrix(blk.conv2, dtype),
                                conv1x1_matrix(blk.conv3, dtype)]))
    return torch.stack(vts).contiguous(), torch.stack(wms).contiguous()


@torch.no_grad()
def stack_block_params_aq(blocks, dtype, max_shift):
    """Stack stride-1 rubiks3d-aq blocks: vt (B, 4 + 3*taps_n + 3, C) =
    folded BN rows, an identity T tap row block, the H and W taps of the
    (2, C) shift, then the three rows of normalized attention weights; wm
    as :func:`stack_block_params`. Fractional shifts only: the 2D quantize
    rule has no tap form."""
    vts, wms = [], []
    for blk in blocks:
        s1, b1 = _bn_fold(blk.bn1)
        s2, b2 = _bn_fold(blk.bn2)
        shift2d = blk.as3.shift
        shift3 = torch.cat([torch.zeros_like(shift2d[:1]), shift2d])
        taps = stack_taps(shift3, dtype, max_shift, False)
        aw = attention_shift_weights(blk.aq_shift.weight.to(dtype),
                                     TEMPERATURE).float()  # (C, 3)
        vts.append(torch.cat([torch.stack([s1, b1, s2, b2]).float(), taps,
                              aw.t()]))
        wms.append(torch.stack([conv1x1_matrix(blk.conv2_1x1, dtype),
                                conv1x1_matrix(blk.conv3, dtype)]))
    return torch.stack(vts).contiguous(), torch.stack(wms).contiguous()


@torch.no_grad()
def stack_se_params(blocks):
    """(B, 2, C, Cr) float32 SE weights of the blocks: slot 0 = fc1 as
    (C, Cr), slot 1 = fc2 transposed, also (C, Cr)."""
    return torch.stack([
        torch.stack([blk.se.fc[0].weight.t().float(),
                     blk.se.fc[2].weight.float()])
        for blk in blocks]).contiguous()


def se_gate(v, se):
    """The SE gate (N, T, C) float32 of a shifted activation v
    (N, T, H, W, C) float32 for weights se (2, C, Cr): per-frame spatial
    mean, fc1, ReLU, fc2, sigmoid."""
    m = v.mean(dim=(2, 3))
    return torch.sigmoid(torch.relu(m @ se[0]) @ se[1].t())


def taps_from_rows(rows: int, head: int, aq: bool = False) -> int:
    """Taps per axis of a stacked parameter array with ``head`` BN rows
    (and, with ``aq``, three trailing attention rows)."""
    taps_n, rem = divmod(rows - head - (3 if aq else 0), 3)
    if rem or taps_n < 1:
        raise ValueError(f"{rows} rows is not {head} + 3*taps")
    return taps_n


def tap_shift(v: torch.Tensor, taps: torch.Tensor, max_shift: int):
    """Separable tap sum of v (N, T, H, W, C), float32: along T, H and W,
    out[i] = sum_j w[j] * v[i + j - K] with zero fill. taps: (3*tn, C)."""
    tn = taps.shape[0] // 3
    k = max_shift
    out = v
    for a, axis in enumerate((1, 2, 3)):
        d = out.shape[axis]
        pad = [0] * 8  # F.pad order: C, W, H, T (low, high)
        slot = 2 * (4 - axis)
        pad[slot], pad[slot + 1] = k, max(tn - 1 - k, 0)
        vp = F.pad(out, pad)
        w = taps[a * tn:(a + 1) * tn]
        acc = None
        for j in range(tn):
            term = w[j] * vp.narrow(axis, j, d)
            acc = term if acc is None else acc + term
        out = acc
    return out


def fused_block_plain(x, vt, wm, se=None, *, aq=False, max_shift):
    """The B blocks in sequence, in plain PyTorch."""
    taps_n = taps_from_rows(vt.shape[1], 4, aq)
    dt = x.dtype
    for b in range(vt.shape[0]):
        s1, b1, s2, b2 = vt[b, 0], vt[b, 1], vt[b, 2], vt[b, 3]
        a = torch.relu(x.float() * s1 + b1).to(dt)
        if aq:
            w0, w1, w2 = vt[b, 4 + 3 * taps_n:]
            ap = F.pad(a.float(), (0, 0, 0, 0, 0, 0, 1, 1))
            t = a.shape[1]
            a = (w0 * ap[:, 0:t] + w1 * ap[:, 1:t + 1]
                 + w2 * ap[:, 2:t + 2]).to(dt)
        mid = torch.relu((a @ wm[b, 0]).float() * s2 + b2).to(dt)
        v = tap_shift(mid.float(), vt[b, 4:4 + 3 * taps_n], max_shift)
        if se is not None:
            v = v * se_gate(v, se[b])[:, :, None, None, :]
        x = (x.float() + (v.to(dt) @ wm[b, 1]).float()).to(dt)
    return x


def _check_args(x, vt, wm, se, aq, max_shift):
    if x.ndim != 5:
        raise ValueError(f"x must be (N, T, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    nb = vt.shape[0]
    taps_n = taps_from_rows(vt.shape[1], 4, aq)
    rows = 4 + 3 * taps_n + (3 if aq else 0)
    if vt.shape != (nb, rows, c) or vt.dtype != torch.float32:
        raise ValueError(f"vt must be float32 (B, {rows}, {c}), got "
                         f"{vt.dtype} {tuple(vt.shape)}")
    if taps_n > 2 * max_shift + 2:
        raise ValueError(f"{taps_n} taps exceed max_shift={max_shift}")
    if wm.shape != (nb, 2, c, c) or wm.dtype != x.dtype:
        raise ValueError(f"wm must be {x.dtype} ({nb}, 2, {c}, {c}), got "
                         f"{wm.dtype} {tuple(wm.shape)}")
    if se is not None and (se.ndim != 4 or se.shape[:3] != (nb, 2, c)
                           or se.dtype != torch.float32):
        raise ValueError(f"se must be float32 ({nb}, 2, {c}, Cr), got "
                         f"{se.dtype} {tuple(se.shape)}")
    return taps_n


SE_ROWS = 8  # rows of H one block of the SE reduction's first pass sums


def se_slices(h: int) -> int:
    """Row slices per frame of the SE reduction's first pass. It depends on
    the shape only, so the summation order is fixed."""
    return -(-h // SE_ROWS)


def fused_block_kernel(x, vt, wm, se=None, *, aq=False, max_shift):
    """Kernel K2 on CUDA tensors: one C call per block (two launches, and
    with ``se`` two more for the gate)."""
    taps_n = _check_args(x, vt, wm, se, aq, max_shift)
    if taps_n > KERNEL_MAX_TAPS:
        raise ValueError(f"the CUDA kernel takes <= {KERNEL_MAX_TAPS} taps")
    arrays = (x, vt, wm) if se is None else (x, vt, wm, se)
    if x.device.type != "cuda" or any(a.device != x.device for a in arrays):
        raise ValueError("fused_block_kernel needs x, vt, wm, se on one CUDA "
                         f"device, got {[str(a.device) for a in arrays]}")
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("fused_block_kernel needs contiguous x, vt, wm, se")
    code = _build.dtype_code(x.dtype)
    P, I = _build.PTR, _build.INT
    fn = _build.kernel_function("rubiks_fused_block", *[P] * 9, *[I] * 11, P)
    n, t, h, w, c = x.shape
    out = torch.empty_like(x)
    mid = torch.empty_like(x)
    cr = slices = 0
    partial = gate = None
    if se is not None:
        cr, slices = se.shape[3], se_slices(h)
        partial = torch.empty((n * t, slices, c), dtype=torch.float32,
                              device=x.device)
        gate = torch.empty((n * t, c), dtype=torch.float32, device=x.device)
    stream = _build.stream_of(x)
    src = x
    with torch.cuda.device(x.device):
        for b in range(vt.shape[0]):
            # After the first block the run updates `out` in place.
            rc = fn(src.data_ptr(), vt[b].data_ptr(), wm[b, 0].data_ptr(),
                    wm[b, 1].data_ptr(),
                    se[b].data_ptr() if se is not None else None,
                    partial.data_ptr() if se is not None else None,
                    gate.data_ptr() if se is not None else None,
                    mid.data_ptr(), out.data_ptr(), code, n, t, h, w, c,
                    taps_n, max_shift, int(bool(aq)), cr, slices, stream)
            _build.check(rc, "rubiks_fused_block")
            LAUNCHES.count += 1
            src = out
    return out


def fused_block_run(x, vt, wm, se=None, *, aq=False, max_shift):
    """Apply a chain of B fused blocks to x (N, T, H, W, C).

    vt: (B, 4 + 3*taps, C) float32 from :func:`stack_block_params`, or with
    ``aq=True`` (B, 4 + 3*taps + 3, C) from :func:`stack_block_params_aq`
    (``aq`` is never inferred from the row count: both are multiples of 3
    past the head); wm: (B, 2, C, C) in x's dtype; se: None or (B, 2, C, Cr)
    float32 from :func:`stack_se_params`. Runs K2 for a CUDA tensor and the
    plain version for a CPU tensor.
    """
    if x.device.type == "cuda":
        return fused_block_kernel(x, vt, wm, se, aq=aq, max_shift=max_shift)
    if x.device.type == "cpu":
        _check_args(x, vt, wm, se, aq, max_shift)
        return fused_block_plain(x, vt, wm, se, aq=aq, max_shift=max_shift)
    raise ValueError(f"unsupported device {x.device}")
