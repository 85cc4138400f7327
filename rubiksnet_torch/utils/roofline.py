"""The yardstick: the H100's peak rates, the work of one kernel call and of
one whole-model call, and the library calls the shift kernels are timed
beside.

A bound is the least time the card could take for a call: the larger of
the bytes it must move (each input read once, each output written once)
over the memory rate and its operations over the peak rate for their type.
``chip_smoke.py`` bounds each kernel with :func:`shift_work`,
:func:`shift_grad_work`, :func:`block_work`, :func:`entry_work` and
:func:`bound_times_ms`; ``scripts/bench.py`` turns :func:`model_flops` and
:func:`model_bytes` into the whole model's ``mfu`` and HBM share, and
``scripts/shift_microbench.py`` bounds the shift op alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory 3.35 TB/s, bf16 tensor cores 989 TFLOP/s, float32 outside the
# tensor cores 67 TFLOP/s. They assume the card's full 700 W power limit; a
# card set below it runs slower under load, so every share states the
# card's limit beside it. A bound is the larger of bytes / memory rate and
# operations / peak: each input read once, each output written once;
# matrix products of bf16 operands at the tensor-core peak, everything else
# (interpolation weights, bn, relu, sums) at the float32 peak.
HBM_BYTES_PER_S, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
# float64 outside the tensor cores (the same data sheet: 34 TFLOP/s): the
# rate of the device loader's resize, which sums in double.
PEAK_F64 = 34e12
FRAMES = 8  # frames a clip in the per-kernel counts below
FLOPS_PER_CORNER = 4  # weight product and multiply-add per corner read


def peak_flops(dtype) -> float:
    """The matrix-product peak for operands of ``dtype``: the bf16 tensor
    cores, else the float32 rate (the port runs float32 products in full
    float32, TF32 off)."""
    return PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32


# ------------------------------------------------ one kernel call


def shift_work(written, read, itemsize, corners):
    """(bytes, matrix-product operations, other operations) of one shift
    call that writes ``written`` elements from ``read`` elements."""
    return ((written + read) * itemsize, 0,
            written * corners * FLOPS_PER_CORNER)


def shift_grad_work(n_out, n_in, itemsize):
    """K4: og and x read once; about 40 operations per output element (8
    corners, three derivative sums)."""
    return (n_out + n_in) * itemsize, 0, n_out * 40


def block_work(n, h, c, itemsize, rows, aq=False, se=False):
    """One stride-1 block on (n, FRAMES, h, h, c): x read, out written, the
    parameters read; `mid` is the kernel's own intermediate."""
    m = n * FRAMES * h * h
    nbytes = 2 * m * c * itemsize + 2 * c * c * itemsize + rows * c * 4
    if se:
        nbytes += 2 * c * (c // 12) * 4
    other = m * c * (6 + FLOPS_PER_CORNER * (4 if aq else 8)
                     + (6 if aq else 0) + (3 if se else 0))
    return nbytes, 4 * m * c * c, other


def entry_work(n, h, cin, cm, itemsize, rows, se=False):
    """One stride-2 entry block on (n, FRAMES, h, h, cin)."""
    m, mo = n * FRAMES * h * h, n * FRAMES * (h // 2) * (h // 2)
    nbytes = (m * cin + mo * cm + 2 * cin * cm + cm * cm) * itemsize + (
        2 * cin + rows * cm) * 4
    if se:
        nbytes += 2 * cm * (cm // 12) * 4
    other = (m * 2 * (cin + cm) + mo * cm * 8 * FLOPS_PER_CORNER
             + (3 * m * cm if se else 0))
    return nbytes, 2 * m * cin * cm + 2 * mo * (cm + cin) * cm, other


def bound_times_ms(work, dtype):
    """(ms for the bytes, ms for the operations) of one call."""
    nbytes, mm, other = work
    return (1e3 * nbytes / HBM_BYTES_PER_S,
            1e3 * (mm / peak_flops(dtype) + other / PEAK_F32))


def resize_crop_work(sizes, scale_size, crop_size, origins):
    """The device loader's ``resize_crop_u8`` on one batch (``sizes``,
    ``origins`` as ``data.device_loader.resize_crop`` takes them): (bytes,
    float64 operations). Bytes: each output byte written once and, per
    frame, each source byte its crops' taps reach read once (the union of
    their footprints). Operations: per output byte of a resized frame a
    multiply and an add per horizontal tap of each vertical tap, a multiply
    and an add per vertical tap, and the rounding's add, with this batch's
    tap counts; a frame that is not resized is a copy."""
    import numpy as np

    from ..data import device_loader

    sizes, resized, origins, k, _ = device_loader.frame_geometry(
        sizes, scale_size, crop_size, origins)
    nbytes = len(sizes) * k * crop_size * crop_size * 3
    ops, seen = 0, {}
    for (w, h, _), (rw, rh), crops in zip(sizes.tolist(), resized.tolist(),
                                          origins.tolist()):
        key = (w, h, tuple(map(tuple, crops)))
        if key not in seen:
            mask = np.zeros((h, w), bool)
            fops = 0
            for x0, y0 in crops:
                if device_loader.resizes(w, h, scale_size):
                    cx = device_loader.triangle_coeffs(w, rw)
                    cy = device_loader.triangle_coeffs(h, rh)
                    xs = slice(x0, x0 + crop_size)
                    ys = slice(y0, y0 + crop_size)
                    x_lo, x_n = cx.lo[xs], cx.counts[xs]
                    y_lo, y_n = cy.lo[ys], cy.counts[ys]
                    cols = np.zeros(w, bool)
                    rows = np.zeros(h, bool)
                    for lo_, n_, m in ((x_lo, x_n, cols), (y_lo, y_n, rows)):
                        for a_, c_ in zip(lo_.tolist(), n_.tolist()):
                            m[a_:a_ + c_] = True
                    mask |= rows[:, None] & cols[None, :]
                    per_px = (2 * y_n[:, None] * (x_n[None, :] + 1) + 1)
                    fops += int(per_px.sum()) * 3
                else:
                    mask[y0:y0 + crop_size, x0:x0 + crop_size] = True
            seen[key] = (int(mask.sum()) * 3, fops)
        read, fops = seen[key]
        nbytes += read
        ops += fops
    return nbytes, ops


def resize_crop_bound_ms(work):
    """(ms for the bytes, ms for the float64 operations) of
    :func:`resize_crop_work`'s call."""
    nbytes, ops = work
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_F64


# ------------------------------------------------ the whole model


def _layers(model, batch, frames, size):
    """Per layer of the model's forward on a (batch, frames, size, size, 3)
    clip, in order: (input elements, output elements, matrix-product
    multiply-adds, matrix weight elements). The stem is a 3x3 stride-2 pad-1
    conv; a block is conv2 (after the attention shift in rubiks3d-aq), the
    shift at the block's stride, the SE fcs, conv3 and the strided 1x1
    shortcut; the head is new_fc on each frame's pooled features."""
    n = batch * frames
    bb = model.backbone
    stem = bb.conv1.weight
    h = (size - 1) // 2 + 1
    out = [(n * size * size * 3, n * h * h * stem.shape[0],
            n * h * h * stem.numel(), stem.numel())]
    for _, blk in bb.named_blocks():
        w2 = blk.conv2_1x1.weight
        w3 = blk.conv3.weight
        mid, cin, cout = w2.shape[0], w2.shape[1], w3.shape[0]
        ho = (h - 1) // blk.stride + 1
        m, mo = n * h * h, n * ho * ho
        macs = m * cin * mid + mo * mid * cout
        weights = w2.numel() + w3.numel()
        if blk.shortcut is not None:
            macs += mo * cin * cout
            weights += blk.shortcut.weight.numel()
        if blk.se is not None:
            for fc in (blk.se.fc[0], blk.se.fc[2]):
                macs += n * fc.weight.numel()
                weights += fc.weight.numel()
        out.append((m * cin, mo * cout, macs, weights))
        h = ho
    fc = model.new_fc.weight
    out.append((n * h * h * fc.shape[1], batch * fc.shape[0],
                n * fc.numel(), fc.numel()))
    return out


def _check_mode(mode):
    if mode not in ("infer", "train"):
        raise ValueError(f"mode must be 'infer' or 'train', got {mode!r}")


def model_flops(model, batch, frames, size, mode="infer") -> int:
    """Matrix-product operations (2 x multiply-adds) of the model on a
    (batch, frames, size, size, 3) clip: the stem conv, every 1x1 conv (conv2,
    conv3, the strided shortcuts), the SE fcs and the head.

    ``"infer"``: one forward. ``"train"``: one train step: the forward, the
    weight gradient of every layer and the input gradient of every layer
    but the stem (whose input, the clip, takes none), each as many
    operations as the layer's forward. Shifts, the attention shift, BN,
    ReLU, pooling and other elementwise work are not counted: ``mfu`` is a
    share of the matrix-product peak."""
    _check_mode(mode)
    layers = _layers(model, batch, frames, size)
    fwd = 2 * sum(macs for _, _, macs, _ in layers)
    if mode == "infer":
        return fwd
    return 3 * fwd - 2 * layers[0][2]


def model_bytes(model, batch, frames, size, mode="infer") -> int:
    """The least device-memory traffic of the model on a (batch, frames,
    size, size, 3) clip, a route that runs one kernel a layer (the fused
    serving route): each layer (the stem, every block, the head) reads its
    input once and writes its output once, so the clip is read once and
    each block's input and output activations once, in the compute dtype;
    each matrix weight is read once in the compute dtype, every other
    parameter and buffer (BN, shifts, biases, attention weights) once in
    float32.

    ``"train"``: one step: the forward's traffic, then each layer reads its
    output's gradient and its saved input and writes its input's gradient
    (the stem writes none), and each matrix weight is read again and its
    float32 gradient written; the optimizer's update is not counted."""
    _check_mode(mode)
    itemsize = torch.empty((), dtype=model.dtype).element_size()
    layers = _layers(model, batch, frames, size)
    matrix = sum(w for _, _, _, w in layers)
    other = (sum(p.numel() for p in model.parameters())
             + sum(b.numel() for b in model.buffers()
                   if b.is_floating_point()) - matrix)
    acts = sum(i + o for i, o, _, _ in layers)
    fwd = acts * itemsize + matrix * itemsize + other * 4
    if mode == "infer":
        return fwd
    bwd_acts = sum(o + 2 * i for i, o, _, _ in layers) - layers[0][0]
    return fwd + bwd_acts * itemsize + matrix * (itemsize + 4)


# ------------------------------------- library yardsticks (never called by
# the port): the shift as one depthwise convolution over its tap weights,
# the input gradient as the transposed convolution.


def depthwise_weight(shift, dtype, axes):
    """(C, 1, 3, ...) depthwise kernel of a shift with |s| < 1: the outer
    product of the per-axis tap weights at offsets -1, 0, 1."""
    from ..ops.shift3d import shift_tap_weights

    taps = [shift_tap_weights(shift[a], dtype, 1, False)[:3].float()
            for a in axes]
    eq = "tc,hc,wc->cthw" if len(taps) == 3 else "hc,wc->chw"
    return torch.einsum(eq, *taps)[:, None].to(dtype).contiguous()


def library_shift(x, shift, s, inverse=False):
    """A closure running the depthwise (transposed) convolution on the
    channel-first view of channel-last x (no copy), 3D for a (3, C) shift
    on (N, T, H, W, C) and 2D for a (2, C) shift on (N, H, W, C)."""
    three = shift.shape[0] == 3
    w = depthwise_weight(shift, x.dtype, range(shift.shape[0]))
    c = x.shape[-1]
    xp = x.permute(0, 4, 1, 2, 3) if three else x.permute(0, 3, 1, 2)
    stride = (1, s, s) if three else (s, s)
    if not inverse:
        conv = F.conv3d if three else F.conv2d
        return lambda: conv(xp, w, stride=stride, padding=1, groups=c)
    conv = F.conv_transpose3d if three else F.conv_transpose2d
    pad_out = (0, s - 1, s - 1) if three else (s - 1, s - 1)
    return lambda: conv(xp, w, stride=stride, padding=1,
                        output_padding=pad_out, groups=c)


def channel_last(y):
    """A library call's channel-first result as channel-last (a view)."""
    return y.permute(0, 2, 3, 4, 1) if y.ndim == 5 else y.permute(0, 2, 3, 1)
