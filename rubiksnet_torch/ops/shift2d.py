"""Learnable fractional 2D shift (RubiksShift2D) with its custom gradient.

Counterpart of ``rubiksnet_tpu/ops/shift2d.py`` on channel-last
(N, H, W, C) input with a (2, C) shift, rows (shift_H, shift_W):

* forward: bilinear per-channel shift, zero fill, strided output grid;
  quantize rounds the coordinate ``base + shift`` half away from zero (not
  the 3D op's rule). On a CUDA tensor it is one launch of
  ``csrc/shift2d.cu::rubiks_shift2d_fwd`` (:func:`shift2d_kernel`, counter
  ``shift2d``), a kernel of its own: source rows staged in shared memory,
  one channel per thread, planned by :func:`shift2d_plan`. Plain form:
  :func:`shift2d_plain`.
* input gradient: the inverse shift, ``csrc/shift2d.cu::rubiks_shift2d_inv``
  (the same device body; :func:`shift2d_input_grad_kernel`, counter
  ``shift2d_inverse``) / :func:`shift2d_input_grad_plain`.
* raw (2, C) shift gradient: :func:`rubiks_shift_2d_shift_grad`, plain
  PyTorch on every device, as it is an XLA formulation in the JAX package.
  It is not the 3D rule: a remainder within 1e-7 of zero snaps to zero and
  that axis takes a halved central difference, otherwise a forward
  difference; no corrected taps and no t-factor.

:func:`rubiks_shift_2d` ties them into an autograd op whose shift gradient
is unit-normalized per channel (:func:`normalize_shift_grad_2d`).
"""

from __future__ import annotations

import collections
import functools

import torch

from ..utils.profiling import LaunchCounter
from . import _build
from . import shift_core as core
from .shift3d import _route

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
    "shift2d_plan",
    "LAUNCHES",
    "INVERSE_LAUNCHES",
]

_H_AX, _W_AX = 1, 2
ZERO_TOL = 1e-7
_MODE = "half_away"

LAUNCHES = LaunchCounter("shift2d")
INVERSE_LAUNCHES = LaunchCounter("shift2d_inverse")


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
#
# csrc/shift2d.cu holds the arithmetic. Everything else is here, where the
# CPU tests reach it: the per-axis coordinate rule both directions share,
# the source rows a band of destination rows reads, and the plan (route,
# channel group, rows per band, ring depth, shared memory) that the wrappers
# pass to the C entry points.

SMEM_LIMIT = 232448  # bytes of shared memory one block can use on the H100
SMEM_HEAD = 16  # the block's floor range
MAX_THREADS = 512
ROUTES = {16: "vector", 4: "word", 2: "scalar"}

# The plan's knobs (settled by measuring on the card, PERF.md): a block
# stays under SMEM_BUDGET so that two fit an SM; a group has at most
# MAX_GROUP channels; the ring holds at most MAX_RING source rows; bands
# are cut until the grid has about TARGET_BLOCKS blocks but keep at least
# MIN_BAND_ROWS rows; a block has about BLOCK_THREADS threads.
SMEM_BUDGET = 112 * 1024
MAX_GROUP = 512
MAX_RING = 6
TARGET_BLOCKS = 2112
MIN_BAND_ROWS = 2
BLOCK_THREADS = 256

Shift2dPlan = collections.namedtuple(
    "Shift2dPlan", "route copy_bytes group groups rows bands ring cols "
                   "threads smem_bytes")


def axis_rule(stride, padding, inverse):
    """(mul, div, off) of one axis: destination position p of channel c
    reads raw coordinates ``q = p * mul + off + floor(s_c) + {0, 1}`` and
    the source cell ``q // div`` where div divides q. Forward: the shift as
    it is; input gradient (``inverse``): the negated shift."""
    return (1, stride, padding) if inverse else (stride, 1, -padding)


def ring_rows_needed(span, mul, div):
    """Source rows live at once while a block walks down its band, for a
    range ``span = max - min`` of floor(shift) over its channels: the rows
    of destination row r and those row r + 1 adds."""
    return (mul + span + 1) // div + 1


def ring_lookahead(span, mul, div, ring):
    """How many destination rows ahead of the one being computed a ring of
    ``ring`` rows lets the copies run (at least 1 where the block stages:
    ``ring_rows_needed(span, mul, div) <= ring``)."""
    return (ring * div - span - 2) // mul


def band_source_rows(r, f_min, f_max, rule, d_src):
    """Inclusive range (lo, hi) of source rows that destination row r reads
    for floors in [f_min, f_max], clamped to the source; lo > hi: none."""
    mul, div, off = rule
    q_lo = r * mul + off + f_min
    q_hi = r * mul + off + f_max + 1
    return max(-((-q_lo) // div), 0), min(q_hi // div, d_src - 1)


def _ring_pitch(row_bytes):
    """Bytes from one ring row to the next: the row, rounded up to the 16
    bytes of a copy."""
    return (row_bytes + 15) // 16 * 16


def _plan_smem(ring, ws, group, itemsize):
    return SMEM_HEAD + ring * _ring_pitch(ws * group * itemsize)


@functools.lru_cache(maxsize=None)
def _plan(shape, out_shape, stride, itemsize, inverse, copy_limit, knobs):
    budget, max_group, max_ring, target, min_rows, block_threads = knobs
    n, h, w, c = shape
    _, ho, wo, _ = out_shape
    if max(h * w * c, ho * wo * c) >= 2**31:
        raise ValueError(
            f"one frame of {tuple(shape)} -> {tuple(out_shape)} has 2**31 "
            f"elements or more: the 2D shift kernels index a frame in 32 "
            f"bits")
    (hs, ws), (hd, wd) = ((ho, wo), (h, w)) if inverse else ((h, w), (ho, wo))
    mul, div, _ = axis_rule(stride[0], 0, inverse)
    copy_bytes = next(b for b in (16, 4, itemsize)
                      if b <= max(copy_limit, itemsize)
                      and (c * itemsize) % b == 0)
    unit = max(1, copy_bytes // itemsize)
    need = ring_rows_needed(1, mul, div)  # |shift| < 1: floors -1 and 0

    def ring_of(group):
        left = budget - _plan_smem(0, ws, group, itemsize)
        return max(0, min(max_ring,
                          left // _ring_pitch(ws * group * itemsize)))

    max_group = min(max_group, MAX_THREADS)  # one thread per channel
    groups_ok = [g for g in range(unit, min(c, max_group) + 1, unit)
                 if c % g == 0]
    if not groups_ok or (groups_ok[-1] < 32 and c > max_group):
        groups_ok = [min(c, max_group // unit * unit)]  # a ragged last group
    staged = [g for g in groups_ok if ring_of(g) >= need]
    group = staged[-1] if staged else groups_ok[0]
    ring = ring_of(group)
    if ring < need:
        ring = 0  # no room for a ring: every block reads directly
    smem = _plan_smem(ring, ws, group, itemsize)
    groups = -(-c // group)
    bands = max(1, min(-(-target // max(1, n * groups)),
                       hd // min_rows if hd >= min_rows else 1))
    rows = max(1, -(-hd // bands))
    bands = max(1, -(-hd // rows))
    cols = max(1, min(max(wd, 1), round(block_threads / group),
                      MAX_THREADS // group))
    return Shift2dPlan(ROUTES[copy_bytes], copy_bytes, group, groups, rows,
                       bands, ring, cols, group * cols, smem)


def shift2d_plan(shape, out_shape, stride, dtype, inverse=False,
                 copy_limit=16):
    """How the kernel of csrc/shift2d.cu runs the forward x ``shape`` ->
    ``out_shape`` (N, H, W, C) or, with ``inverse``, its input gradient
    og ``out_shape`` -> gx ``shape``. A pure function of its arguments.

    A block takes one frame, one band of ``rows`` destination rows and one
    group of ``group`` channels (``groups`` of them cover C; the last may
    be ragged), as ``cols`` runs of consecutive columns, one channel per
    thread. Source rows are staged in a ring of ``ring`` rows (0: every
    block reads device memory directly; otherwise a block does so only
    where the range of floor(shift) over its channels needs more rows than
    the ring has, :func:`ring_rows_needed`). ``copy_bytes`` is the width of
    a copy between device and shared memory, at most ``copy_limit``: 16
    (route ``vector``) only where a pixel's ``C * itemsize`` bytes are a
    multiple of 16, else 4 (``word``), else 2 (``scalar``).
    """
    knobs = (SMEM_BUDGET, MAX_GROUP, MAX_RING, TARGET_BLOCKS, MIN_BAND_ROWS,
             BLOCK_THREADS)
    return _plan(tuple(int(v) for v in shape),
                 tuple(int(v) for v in out_shape), _pair(stride),
                 dtype.itemsize, bool(inverse),
                 int(copy_limit), knobs)


_ENTRY_ARGS = (_build.PTR, _build.PTR, _build.PTR, *[_build.INT] * 18,
               _build.PTR)
_ENTRIES = ("rubiks_shift2d_fwd", "rubiks_shift2d_inv")
_COUNTERS = (LAUNCHES, INVERSE_LAUNCHES)


@functools.lru_cache(maxsize=None)
def _prepare(inverse, src_shape, in_shape, stride, padding, dtype,
             copy_limit):
    """What one launch needs beyond its pointers, worked out once per
    configuration (the arguments as the caller gave them, hashable): the C
    entry point, the result's shape and the integer arguments (shapes,
    strides, the plan). ``in_shape``: x's shape for the input gradient,
    whose ``src_shape`` is og's."""
    entry = _ENTRIES[inverse]
    stride, padding = _pair(stride), _pair(padding)
    src_shape = tuple(int(v) for v in src_shape)
    if len(src_shape) != 4:
        raise ValueError(f"{entry}: the tensor must be (N, H, W, C), got "
                         f"{src_shape}")
    if inverse:
        shape, out_shape = tuple(int(v) for v in in_shape), src_shape
        if len(shape) != 4 or compute_output_shape_2d(
                shape, stride, padding) != out_shape:
            raise ValueError(
                f"og {out_shape} is not the output shape of {shape} at "
                f"stride {stride} padding {padding}")
    else:
        shape = src_shape
        out_shape = compute_output_shape_2d(shape, stride, padding)
    n, h, w, c = shape
    (sh, sw), (ph, pw) = stride, padding
    if max(h, w) * max(sh, sw) + max(ph, pw, 0) >= 2**30:
        raise ValueError(f"{entry}: extent of {shape} too large")
    plan = shift2d_plan(shape, out_shape, stride, dtype, inverse, copy_limit)
    head = (_build.dtype_code(dtype), n, h, w, c, out_shape[1], out_shape[2],
            sh, sw, ph, pw)
    tail = (plan.copy_bytes, plan.group, plan.rows, plan.ring, plan.cols,
            plan.smem_bytes)
    return (_build.kernel_function(entry, *_ENTRY_ARGS),
            shape if inverse else out_shape, head, tail)


def _launch(inverse, src, shift, in_shape, stride, padding, quantize):
    """Check the tensors, allocate the result and launch one kernel: no
    other device work."""
    if src.ndim != 4 or shift.shape != (2, src.shape[-1]):
        raise ValueError(
            f"{_ENTRIES[inverse]}: shift must be (2, C) for an (N, H, W, C) "
            f"tensor, got {tuple(shift.shape)} for {tuple(src.shape)}")
    if shift.dtype != torch.float32:
        raise TypeError(f"{_ENTRIES[inverse]} takes the float32 shift "
                        f"parameter, got {shift.dtype}")
    if not (src.is_contiguous() and shift.is_contiguous()):
        raise ValueError(f"{_ENTRIES[inverse]} needs contiguous tensors")
    dev = src.device
    if dev.type != "cuda" or shift.device != dev:
        raise ValueError(
            f"{_ENTRIES[inverse]} needs its tensors on one CUDA device, got "
            f"{src.device} and {shift.device}")
    # A copy is no wider than the source is aligned (a view may start
    # anywhere; a fresh result is aligned).
    at = src.data_ptr()
    limit = 16 if at % 16 == 0 else 4 if at % 4 == 0 else 2
    fn, dst_shape, head, tail = _prepare(inverse, src.shape, in_shape, stride,
                                         padding, src.dtype, limit)
    dst = torch.empty(dst_shape, dtype=src.dtype, device=dev)
    args = (at, shift.data_ptr(), dst.data_ptr(), *head, int(quantize), *tail,
            _build.stream_of(src))
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        _build.check(rc, _ENTRIES[inverse])
    _COUNTERS[inverse].count += 1
    return dst


def shift2d_kernel(x, shift, stride=(1, 1), padding=(0, 0), quantize=False):
    """The 2D shift forward on a CUDA tensor (N, H, W, C), contiguous, with
    the float32 (2, C) shift: one launch of ``rubiks_shift2d_fwd``
    (csrc/shift2d.cu), planned by :func:`shift2d_plan`."""
    return _launch(False, x, shift, None, stride, padding, quantize)


def shift2d_input_grad_kernel(og, shift, in_shape, stride=(1, 1),
                              padding=(0, 0), quantize=False):
    """The 2D shift's input gradient on a CUDA tensor og (N, Ho, Wo, C): one
    launch of ``rubiks_shift2d_inv`` (csrc/shift2d.cu)."""
    if not isinstance(in_shape, tuple):  # a hashable key (Size is a tuple)
        in_shape = tuple(in_shape)
    return _launch(True, og, shift, in_shape, stride, padding, quantize)


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
    autograd. The operator ``rubiksnet::shift2d_forward``
    (``ops/library.py``): the kernel of csrc/shift2d.cu for a CUDA tensor,
    the gather form for a CPU tensor; raises for any other device."""
    _check_args(x, shift)
    return torch.ops.rubiksnet.shift2d_forward.default(
        x, shift, _pair(stride), _pair(padding), bool(quantize))


@torch.no_grad()
def rubiks_shift_2d_input_grad(og, shift, in_shape, stride=(1, 1),
                               padding=(0, 0), quantize=False):
    """Gradient of the forward with respect to x for upstream og. The
    kernel of csrc/shift2d.cu for a CUDA tensor, the gather form for a CPU
    tensor."""
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
                plain, reduce_grad):
        ctx.save_for_backward(x, shift)
        ctx.cfg = (stride, padding, quantize, normalize_grad, plain,
                   reduce_grad)
        if plain:
            return shift2d_plain(x, shift, stride, padding, quantize)
        # The operator: the kernel on the card, the plain form on the CPU,
        # one opaque node under torch.export.
        return torch.ops.rubiksnet.shift2d_forward.default(
            x, shift, stride, padding, quantize)

    @staticmethod
    def backward(ctx, og):
        x, shift = ctx.saved_tensors
        stride, padding, quantize, normalize_grad, plain, reduce_grad = (
            ctx.cfg)
        use_kernels = _route(x, plain)
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
            if reduce_grad is not None:
                gs = reduce_grad(gs)
            if normalize_grad:
                gs = normalize_shift_grad_2d(gs)
            gs = gs.to(shift.dtype)
        return gx, gs, None, None, None, None, None, None


def rubiks_shift_2d(x, shift, stride=1, padding=0, normalize_grad=True,
                    quantize=False, plain=False, reduce_grad=None):
    """The 2D shift as an autograd op (the reference's functional signature
    on channel-last input). Forward and input gradient run the kernels of
    csrc/shift2d.cu on a CUDA tensor and the gather forms on a CPU tensor
    or with ``plain=True``; the shift gradient is plain PyTorch.
    ``reduce_grad`` (``parallel.temporal.shift_grad_reduction``) takes the
    raw shift gradient to the one of the whole batch and clip, over the
    ranks of a data or time group, before the normalization."""
    _check_args(x, shift)
    return _RubiksShift2DFunction.apply(
        x, shift, _pair(stride), _pair(padding), bool(quantize),
        bool(normalize_grad), bool(plain), reduce_grad)
