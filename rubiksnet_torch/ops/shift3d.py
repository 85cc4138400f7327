"""Learnable fractional 3D shift (RubiksShift3D) with its custom gradient.

Counterpart of ``rubiksnet_tpu/ops/shift3d.py``. Three functions, each a
CUDA kernel beside its plain gather form:

* forward: K1 ``csrc/shift3d_bwd.cu::rubiks_shift3d_fwd_staged`` /
  :func:`shift3d_plain`;
* input gradient (the inverse shift of the upstream gradient): K1-inverse
  ``csrc/shift3d_bwd.cu::rubiks_shift3d_inv_staged`` /
  :func:`shift3d_input_grad_plain`;
* raw (3, C) shift gradient: K4
  ``csrc/shift3d_bwd.cu::rubiks_shift_grad_staged`` /
  :func:`shift3d_shift_grad_plain`.

The three kernels share one device body (source rows staged in shared
memory, one channel per thread) under the launch plan
:func:`shift3d_bwd_plan`, which takes the direction (``FORWARD``,
``INPUT_GRAD``, ``SHIFT_GRAD``); their first forms (``csrc/shift3d.cu``'s
forward and inverse, ``csrc/shift_grad.cu``) stay callable as
``route="previous"``.

:func:`rubiks_shift_3d` ties them into an autograd op whose shift gradient
is unit-normalized per channel (:func:`normalize_shift_grad_3d`): the
reference's rule, which is not the true derivative of the forward. A CUDA
tensor runs the kernels and a CPU tensor the plain forms; ``plain=True``
runs the plain forms on any device. :func:`rubiks_shift_3d_input_grad` and
:func:`rubiks_shift_3d_shift_grad` are the two gradients as public
functions (the JAX package's signatures less ``backend`` and
``max_shift``), routed by device in the same way.
"""

from __future__ import annotations

import collections
import functools

import torch

from ..utils.profiling import LaunchCounter
from . import _build
from . import shift_core as core

__all__ = [
    "DIRECTIONS",
    "FORWARD",
    "INPUT_GRAD",
    "SHIFT_GRAD",
    "compute_output_shape_3d",
    "normalize_shift_grad_3d",
    "rubiks_shift_3d",
    "rubiks_shift_3d_forward",
    "rubiks_shift_3d_input_grad",
    "rubiks_shift_3d_shift_grad",
    "shift3d_input_grad_kernel",
    "shift3d_input_grad_plain",
    "shift3d_bwd_plan",
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

LAUNCHES = LaunchCounter("shift3d")
INVERSE_LAUNCHES = LaunchCounter("shift3d_inverse")
SHIFT_GRAD_LAUNCHES = LaunchCounter("shift_grad")


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


def _forward_previous(x, shift, stride, padding, quantize):
    """K1's first form (csrc/shift3d.cu): one thread per output element,
    trilinear weights in f32; the shift cast to the dtype and back by two
    device kernels before it."""
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
                w, c, to, ho, wo, st, sh, sw, pt, ph, pw, int(quantize),
                _build.stream_of(x))
    _build.check(rc, "rubiks_shift3d_fwd")
    LAUNCHES.count += 1
    return out


def _input_grad_previous(og, shift, in_shape, stride, padding, quantize):
    """K1-inverse's first form (csrc/shift3d.cu): one thread per input
    element, stride-gated, weights in f32; the shift cast to the dtype and
    back by two device kernels before it."""
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
                w, c, to, ho, wo, st, sh, sw, pt, ph, pw, int(quantize),
                _build.stream_of(og))
    _build.check(rc, "rubiks_shift3d_inv")
    INVERSE_LAUNCHES.count += 1
    return gx


def shift_grad_slices(rows: int, c: int, sms: int) -> int:
    """Row slices of the previous route of K4: one block per (slice,
    32-channel tile), about 8 blocks per SM, at least 64 rows a slice. It
    depends on the shape and the card only, so the summation order is
    fixed."""
    ctiles = -(-c // 32)
    return max(1, min(max(1, 8 * sms // ctiles), -(-rows // 64)))


def _shift_grad_previous(og, x, shift, stride, padding):
    """K4's first form (csrc/shift_grad.cu): per-slice partials and a
    second launch that sums them; the shift cast as for K1-inverse's."""
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
    sms = _sm_count(x.device.index)
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


# ---------------------------------------------- the staged route's kernels
#
# csrc/shift3d_bwd.cu holds the arithmetic of K1, K1-inverse and K4, one
# body in three directions. Everything else is here, where the CPU tests
# reach it: the per-axis coordinate rule, the frames and rows a destination
# frame and band read, and the plan (channel group, rows per band, ring
# frames and rows, column runs, shared memory) that the wrappers pass to
# the C entry points.

FORWARD, INPUT_GRAD, SHIFT_GRAD = "forward", "input_grad", "shift_grad"
DIRECTIONS = (FORWARD, INPUT_GRAD, SHIFT_GRAD)
BWD_ROUTES = ("staged", "previous")
BWD_SMEM_HEAD = 32  # the block's tap ranges
BWD_MAX_THREADS = 384  # csrc/shift3d_bwd.cu's kMaxThreads (launch bound)
SG_RED_BYTES = 12  # per thread: the shift gradient's three sums, reduced

# The plan's knobs (settled by measuring on the card with
# utils/shift3d_bwd_probe.py --sweep, PERF.md): a block stays under
# BWD_SMEM_BUDGET; a group has at most BWD_MAX_GROUP channels; the ring
# holds at most BWD_MAX_RING rows per frame; bands are cut until the grid
# has about BWD_TARGET_BLOCKS blocks but keep at least BWD_MIN_BAND_ROWS
# rows; a block has about BWD_BLOCK_THREADS threads. The ring is sized for
# a tap extent (max hi - min lo over a group's channels) of BWD_EXTENT for
# the forward and the input gradient (shifts in (-1, 1): floors -1 and 0)
# and SG_EXTENT for the shift gradient (its corrected taps add a cell at an
# integer remainder); a group whose taps reach further reads directly. The
# shift gradient stages og's rows too, in a ring of as many rows beside the
# source rows', where that leaves its channel group as wide.
BWD_SMEM_BUDGET = 112 * 1024
BWD_MAX_GROUP = 512
BWD_MAX_RING = 8
BWD_TARGET_BLOCKS = 2112
BWD_MIN_BAND_ROWS = 2
BWD_BLOCK_THREADS = 256
BWD_EXTENT = 2
SG_EXTENT = 3

Shift3dBwdPlan = collections.namedtuple(
    "Shift3dBwdPlan", "copy_bytes group groups rows bands units frames ring "
                      "og_rows cols threads smem_bytes")


def _direction(direction):
    if direction not in DIRECTIONS:
        raise ValueError(f"unknown direction {direction!r}, expected one of "
                         f"{DIRECTIONS}")
    return direction


def bwd_axis_rule(stride, padding, direction):
    """(mul, div, off) of one axis: destination position p of channel c
    reads raw coordinates ``q = p * mul + off + {lo_c, hi_c}`` and the
    source cell ``q // div`` where div divides q. Input gradient:
    destination gx, source og; forward and shift gradient: destination the
    output positions, source x."""
    if _direction(direction) == INPUT_GRAD:
        return (1, stride, padding)
    return (stride, 1, -padding)


def bwd_channel_taps(shift_c, direction, quantize):
    """Per channel of one axis the kernel's (lo, hi, w0, w1), from the shift
    already rounded to the compute dtype (a 1-D tensor): the forward takes
    the shift and the input gradient the negated shift, lo = floor, hi =
    lo + 1, weights (1 - r, r), quantize the one tap floor + (r >= 0.5)
    with weights (1, 0); the shift gradient the corrected taps (lo moves
    back a cell at r == 0), weights (1 - r, r)."""
    direction = _direction(direction)
    s = -shift_c if direction == INPUT_GRAD else shift_c
    f = torch.floor(s)
    r = s - f
    fi = f.to(torch.int64)
    if direction == SHIFT_GRAD:
        return fi - (r == 0).to(torch.int64), fi + 1, 1 - r, r
    lo = fi + ((r >= 0.5) & quantize).to(torch.int64)
    w0 = torch.ones_like(r) if quantize else 1 - r
    w1 = torch.zeros_like(r) if quantize else r
    return lo, lo + 1, w0, w1


def bwd_frames_needed(ext, div):
    """Source frames one destination frame reads for a tap extent ``ext =
    max hi - min lo`` over a group's channels."""
    return ext // div + 1


def bwd_rows_needed(ext, mul, div):
    """Source rows live at once while a block walks down its band: the rows
    of destination row r and those row r + 1 adds."""
    return (mul + ext) // div + 1


def bwd_lookahead(ext, mul, div, ring):
    """How many destination rows ahead of the one being computed a ring of
    ``ring`` rows lets the copies run."""
    return (ring * div - ext - 1) // mul


def bwd_source_range(p, lo_min, hi_max, rule, d_src):
    """Inclusive range (lo, hi) of source cells that destination position p
    reads for taps in [lo_min, hi_max], clamped to the source; lo > hi:
    none."""
    mul, div, off = rule
    q_lo = p * mul + off + lo_min
    q_hi = p * mul + off + hi_max
    return max(-((-q_lo) // div), 0), min(q_hi // div, d_src - 1)


def _ring_pitch(row_bytes):
    return (row_bytes + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def _bwd_plan(shape, out_shape, stride, itemsize, direction, copy_limit,
              knobs):
    (budget, max_group, max_ring, target, min_rows, block_threads, inv_ext,
     sg_ext) = knobs
    n, t, h, w, c = shape
    _, to, ho, wo, _ = out_shape
    if max(t * h * w * c, to * ho * wo * c) >= 2**31:
        raise ValueError(
            f"one clip of {tuple(shape)} -> {tuple(out_shape)} has 2**31 "
            f"elements or more: the 3D shift's staged kernels index a clip "
            f"in 32 bits")
    inverse = direction == INPUT_GRAD
    sg = direction == SHIFT_GRAD
    (ts, hs, ws), (td, hd, wd) = (((to, ho, wo), (t, h, w)) if inverse
                                  else ((t, h, w), (to, ho, wo)))
    mul_t, div_t, _ = bwd_axis_rule(stride[0], 0, direction)
    mul_h, div_h, _ = bwd_axis_rule(stride[1], 0, direction)
    copy_bytes = next(b for b in (16, 4, itemsize)
                      if b <= max(copy_limit, itemsize)
                      and (c * itemsize) % b == 0)
    unit = max(1, copy_bytes // itemsize)
    ext = sg_ext if sg else inv_ext
    frames = bwd_frames_needed(ext, div_t)
    need = bwd_rows_needed(ext, mul_h, div_h)
    red = SG_RED_BYTES if sg else 0
    cap = min(max_group, BWD_MAX_THREADS)

    def cols_of(group):
        return max(1, min(max(wd, 1), round(block_threads / group),
                          BWD_MAX_THREADS // group))

    def choose(og):
        """(group, ring_of) with og's rows staged or not."""
        def ring_of(group):
            left = budget - BWD_SMEM_HEAD - red * group * cols_of(group)
            pitch = max(16, _ring_pitch(ws * group * itemsize))
            og_pitch = _ring_pitch(wd * group * itemsize) if og else 0
            return max(0, min(max_ring, left // (frames * pitch + og_pitch)))

        # The widest group that divides C and whose ring holds the rows it
        # needs; where that is narrower than a warp and C exceeds ``cap``,
        # one of ``cap`` channels that leaves a ragged last group, if it
        # stages.
        divisors = [g for g in range(unit, min(c, cap) + 1, unit)
                    if c % g == 0]
        staged = [g for g in divisors if ring_of(g) >= need]
        ragged = cap // unit * unit
        if c > cap and (not staged or staged[-1] < 32) and ring_of(
                ragged) >= need:
            staged.append(ragged)
        return staged[-1] if staged else (divisors or [ragged])[0], ring_of

    # The shift gradient stages og's rows where that leaves its group as
    # wide (a narrower group pays a row's fixed cost more often).
    group, ring_of = choose(False)
    og_ring = sg and choose(True)[0] >= group
    if og_ring:
        group, ring_of = choose(True)
    ring = ring_of(group)
    if ring < need:
        ring = 0  # no room for a ring: every block reads directly
    cols = cols_of(group)
    og_rows = ring if og_ring else 0
    smem = (BWD_SMEM_HEAD + frames * ring * _ring_pitch(ws * group * itemsize)
            + og_rows * _ring_pitch(wd * group * itemsize)
            + red * group * cols)
    groups = -(-c // group)
    bands = max(1, min(-(-target // max(1, n * td * groups)),
                       hd // min_rows if hd >= min_rows else 1))
    rows = max(1, -(-hd // bands))
    bands = -(-hd // rows)
    return Shift3dBwdPlan(copy_bytes, group, groups, rows, bands,
                          n * td * bands, frames, ring, og_rows, cols,
                          group * cols, smem)


def shift3d_bwd_plan(shape, out_shape, stride, dtype, direction,
                     copy_limit=16):
    """How the kernels of csrc/shift3d_bwd.cu run, for x ``shape`` and the
    output (og) ``out_shape``, (N, T, H, W, C) each: the forward x -> out
    (``FORWARD``), the input gradient og -> gx (``INPUT_GRAD``) or the
    shift gradient of x and og (``SHIFT_GRAD``). A pure function of its
    arguments.

    A block takes one (clip, destination frame, band of ``rows``
    destination rows) unit at a time (``units`` in all) and one group of
    ``group`` channels (``groups`` of them cover C; the last may be
    ragged), as ``cols`` runs of consecutive columns, one channel per
    thread: one block per unit and group. The shift gradient's blocks each
    write a partial, which a second launch sums over the units in a fixed
    order. Source rows are
    staged in a ring of ``frames`` frames x ``ring`` rows (0: every block
    reads device memory directly; otherwise a block does so only where the
    tap range of its channels needs more frames or rows than the ring
    has); the shift gradient's ``og_rows`` (``ring`` or 0) stage og's rows
    beside them. ``copy_bytes`` is the width of a copy between device and
    shared memory, at most ``copy_limit``.
    """
    knobs = (BWD_SMEM_BUDGET, BWD_MAX_GROUP, BWD_MAX_RING, BWD_TARGET_BLOCKS,
             BWD_MIN_BAND_ROWS, BWD_BLOCK_THREADS, BWD_EXTENT, SG_EXTENT)
    return _bwd_plan(tuple(int(v) for v in shape),
                     tuple(int(v) for v in out_shape), _triple(stride),
                     dtype.itemsize, _direction(direction), int(copy_limit),
                     knobs)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


_ENTRIES = {
    FORWARD: ("rubiks_shift3d_fwd_staged",
              (_build.PTR,) * 3 + (_build.INT,) * 23 + (_build.PTR,)),
    INPUT_GRAD: ("rubiks_shift3d_inv_staged",
                 (_build.PTR,) * 3 + (_build.INT,) * 23 + (_build.PTR,)),
    SHIFT_GRAD: ("rubiks_shift_grad_staged",
                 (_build.PTR,) * 5 + (_build.INT,) * 23 + (_build.PTR,)),
}


@functools.lru_cache(maxsize=None)
def _bwd_prepare(direction, og_shape, x_shape, stride, padding, dtype,
                 copy_limit):
    """What one launch needs beyond its pointers, worked out once per
    configuration (the arguments as the caller gave them, hashable): the C
    entry point, the plan, the integer arguments and og's shape (the
    output's). ``og_shape``: og's shape, None for the forward (which makes
    it); ``x_shape``: x's (the input gradient's result)."""
    name, argtypes = _ENTRIES[_direction(direction)]
    stride, padding = _triple(stride), _triple(padding)
    x_shape = tuple(int(v) for v in x_shape)
    if len(x_shape) != 5:
        raise ValueError(f"{name}: x must be (N, T, H, W, C), got {x_shape}")
    out_shape = compute_output_shape_3d(x_shape, stride, padding)
    if og_shape is None:
        og_shape = out_shape
    og_shape = tuple(int(v) for v in og_shape)
    if out_shape != og_shape:
        raise ValueError(f"og {og_shape} is not the output shape of "
                         f"{x_shape} at stride {stride} padding {padding}")
    n, t, h, w, c = x_shape
    if max(t, h, w) * max(stride) + max(max(padding), 0) >= 2**30:
        raise ValueError(f"{name}: extent of {x_shape} too large")
    plan = shift3d_bwd_plan(x_shape, og_shape, stride, dtype, direction,
                            copy_limit)
    shapes = (_build.dtype_code(dtype), n, t, h, w, c, *og_shape[1:4],
              *stride, *padding)
    knobs = (plan.copy_bytes, plan.group, plan.rows, plan.frames, plan.ring,
             plan.cols)
    return (_build.kernel_function(name, *argtypes), plan, shapes, knobs,
            og_shape)


def _check_staged(name, shift, *tensors):
    src = tensors[0]
    if src.ndim != 5 or tuple(shift.shape) != (3, src.shape[-1]):
        raise ValueError(
            f"{name}: shift must be (3, C) for an (N, T, H, W, C) tensor, "
            f"got {tuple(shift.shape)} for {tuple(src.shape)}")
    dev = src.device
    if dev.type != "cuda" or any(v.device != dev for v in (shift, *tensors)):
        raise ValueError(
            f"{name} needs its tensors on one CUDA device, got "
            f"{[str(v.device) for v in (*tensors, shift)]}")
    if shift.dtype != torch.float32:
        raise TypeError(f"{name} takes the float32 shift parameter, got "
                        f"{shift.dtype}")
    if not all(v.is_contiguous() for v in (shift, *tensors)):
        raise ValueError(f"{name} needs contiguous tensors")


def _copy_limit(*tensors):
    """A copy is no wider than the source is aligned (a view may start
    anywhere; a fresh result is aligned)."""
    at = min(v.data_ptr() % 16 or 16 for v in tensors)
    return 16 if at == 16 else 4 if at % 4 == 0 else 2


def _call(fn, dev, args):
    if dev.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def _unknown_route(route):
    return ValueError(f"unknown route {route!r}, expected one of "
                      f"{BWD_ROUTES}")


def shift3d_kernel(x, shift, stride=(1, 1, 1), padding=(0, 0, 0),
                   quantize=False, *, route="staged"):
    """Kernel K1 on a CUDA tensor x (N, T, H, W, C), contiguous, with the
    (3, C) shift: the shifted output. ``route="staged"``: one launch of
    ``rubiks_shift3d_fwd_staged`` (csrc/shift3d_bwd.cu), planned by
    :func:`shift3d_bwd_plan`, and no other device work, where the shift is
    float32 (another dtype is widened first, as for a module cast to
    bfloat16; the kernel rounds it to x's dtype either way);
    ``route="previous"``: the first form (csrc/shift3d.cu), kept to time
    the two in one run."""
    if route == "previous":
        return _forward_previous(x, shift, stride, padding, quantize)
    if route != "staged":
        raise _unknown_route(route)
    name = _ENTRIES[FORWARD][0]
    if shift.dtype != torch.float32:
        shift = shift.float()
    _check_staged(name, shift, x)
    dev = x.device
    fn, plan, shapes, knobs, out_shape = _bwd_prepare(
        FORWARD, None, x.shape, stride, padding, x.dtype, _copy_limit(x))
    out = torch.empty(out_shape, dtype=x.dtype, device=dev)
    rc = _call(fn, dev, (x.data_ptr(), shift.data_ptr(), out.data_ptr(),
                         *shapes, 1 if quantize else 0, *knobs,
                         plan.smem_bytes, _build.stream_of(x)))
    if rc != 0:
        _build.check(rc, name)
    LAUNCHES.count += 1
    return out


def shift3d_input_grad_kernel(og, shift, in_shape, stride=(1, 1, 1),
                              padding=(0, 0, 0), quantize=False, *,
                              route="staged"):
    """Kernel K1-inverse on a CUDA tensor og (N, To, Ho, Wo, C), contiguous,
    with the float32 (3, C) shift: the input gradient of shape ``in_shape``.
    ``route="staged"``: one launch of ``rubiks_shift3d_inv_staged``
    (csrc/shift3d_bwd.cu), planned by :func:`shift3d_bwd_plan`, and no
    other device work; ``route="previous"``: the first form
    (csrc/shift3d.cu), kept to time the two in one run."""
    if route == "previous":
        return _input_grad_previous(og, shift, in_shape, stride, padding,
                                    quantize)
    if route != "staged":
        raise _unknown_route(route)
    name = _ENTRIES[INPUT_GRAD][0]
    _check_staged(name, shift, og)
    dev = og.device
    if not isinstance(in_shape, tuple):  # a hashable key (Size is a tuple)
        in_shape = tuple(in_shape)
    fn, plan, shapes, knobs, _ = _bwd_prepare(
        INPUT_GRAD, og.shape, in_shape, stride, padding, og.dtype,
        _copy_limit(og))
    gx = torch.empty(in_shape, dtype=og.dtype, device=dev)
    rc = _call(fn, dev, (og.data_ptr(), shift.data_ptr(), gx.data_ptr(),
                         *shapes, 1 if quantize else 0, *knobs,
                         plan.smem_bytes, _build.stream_of(og)))
    if rc != 0:
        _build.check(rc, name)
    INVERSE_LAUNCHES.count += 1
    return gx


def shift3d_shift_grad_kernel(og, x, shift, stride=(1, 1, 1),
                              padding=(0, 0, 0), *, route="staged"):
    """Kernel K4 on CUDA tensors: the raw (3, C) float32 shift gradient,
    reduced per channel in a fixed order (bit-identical run to run).
    ``route="staged"``: one call of ``rubiks_shift_grad_staged``
    (csrc/shift3d_bwd.cu), planned by :func:`shift3d_bwd_plan`: two
    launches (the partials, their sum) and no other device work;
    ``route="previous"``: the first form (csrc/shift_grad.cu), the shift
    cast as for K1-inverse's, two launches."""
    if route == "previous":
        return _shift_grad_previous(og, x, shift, stride, padding)
    if route != "staged":
        raise _unknown_route(route)
    name = _ENTRIES[SHIFT_GRAD][0]
    _check_staged(name, shift, x, og)
    if og.dtype != x.dtype:
        raise TypeError(f"og {og.dtype} and x {x.dtype} differ")
    dev = x.device
    fn, plan, shapes, knobs, _ = _bwd_prepare(
        SHIFT_GRAD, og.shape, x.shape, stride, padding, x.dtype,
        _copy_limit(x, og))
    c = x.shape[-1]
    partial = torch.empty((plan.units, 3, c), dtype=torch.float32,
                          device=dev)
    out = torch.empty((3, c), dtype=torch.float32, device=dev)
    rc = _call(fn, dev, (og.data_ptr(), x.data_ptr(), shift.data_ptr(),
                         partial.data_ptr(), out.data_ptr(), *shapes, *knobs,
                         plan.og_rows, plan.smem_bytes, _build.stream_of(x)))
    if rc != 0:
        _build.check(rc, name)
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

    The operator ``rubiksnet::shift3d_forward`` (``ops/library.py``): K1
    for a CUDA tensor and the gather form for a CPU tensor; raises for any
    other device.
    """
    _check_args(x, shift)
    return torch.ops.rubiksnet.shift3d_forward.default(
        x, shift, _triple(stride), _triple(padding), bool(quantize))


@torch.no_grad()
def rubiks_shift_3d_input_grad(og, shift, in_shape, stride=(1, 1, 1),
                               padding=(0, 0, 0), quantize=False):
    """Gradient of the forward with respect to x (of shape ``in_shape``)
    for upstream og: the inverse shift. K1-inverse on its staged route for
    a CUDA tensor (the shift widened to float32 first, as for a module cast
    to bfloat16), the gather form for a CPU tensor; raises for any other
    device."""
    if _route(og, plain=False):
        return shift3d_input_grad_kernel(
            og.contiguous(), shift.float().contiguous(), tuple(in_shape),
            _triple(stride), _triple(padding), bool(quantize))
    return shift3d_input_grad_plain(og, shift, in_shape, stride, padding,
                                    quantize)


@torch.no_grad()
def rubiks_shift_3d_shift_grad(og, x, shift, stride=(1, 1, 1),
                               padding=(0, 0, 0)):
    """Raw (un-normalized) (3, C) gradient with respect to the shift, in
    float32 (float64 for float64 inputs): the formulas of
    :func:`shift3d_shift_grad_plain`. K4 on its staged route for CUDA
    tensors, the plain form for CPU tensors; raises for any other
    device."""
    if _route(x, plain=False):
        return shift3d_shift_grad_kernel(
            og.contiguous(), x.contiguous(), shift.float().contiguous(),
            _triple(stride), _triple(padding))
    return shift3d_shift_grad_plain(og, x, shift, stride, padding)


class _RubiksShift3DFunction(torch.autograd.Function):
    """Forward shift; backward returns the input gradient and the
    (optionally normalized) shift gradient in the shift's dtype."""

    @staticmethod
    def forward(ctx, x, shift, stride, padding, quantize, normalize_grad,
                normalize_t_factor, plain, reduce_grad):
        ctx.save_for_backward(x, shift)
        ctx.cfg = (stride, padding, quantize, normalize_grad,
                   normalize_t_factor, plain, reduce_grad)
        if plain:
            return shift3d_plain(x, shift, stride, padding, quantize)
        # The operator: K1 on the card, the plain form on the CPU, one
        # opaque node under torch.export.
        return torch.ops.rubiksnet.shift3d_forward.default(
            x, shift, stride, padding, quantize)

    @staticmethod
    def backward(ctx, og):
        x, shift = ctx.saved_tensors
        (stride, padding, quantize, normalize_grad, normalize_t_factor,
         plain, reduce_grad) = ctx.cfg
        use_kernels = _route(x, plain)
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
            if reduce_grad is not None:
                gs = reduce_grad(gs)
            if normalize_grad:
                gs = normalize_shift_grad_3d(gs, normalize_t_factor)
            gs = gs.to(shift.dtype)
        return gx, gs, None, None, None, None, None, None, None


def rubiks_shift_3d(x, shift, stride=1, padding=0, normalize_grad=True,
                    normalize_t_factor=1.0, quantize=False, plain=False,
                    reduce_grad=None):
    """The shift as an autograd op (the reference's functional signature on
    channel-last input).

    Forward as :func:`rubiks_shift_3d_forward`. Backward: the inverse shift
    of the upstream gradient for x, and for the shift the raw gradient of
    :func:`shift3d_shift_grad_plain`, normalized per channel by
    :func:`normalize_shift_grad_3d` when ``normalize_grad``.
    ``normalize_t_factor`` is a number or ``"auto"`` (T / H of x). Kernels on
    a CUDA tensor, plain forms on a CPU tensor or with ``plain=True``.
    ``reduce_grad`` (``parallel.temporal.shift_grad_reduction``) takes the
    raw shift gradient to the one of the whole batch, over the ranks of a
    data group and of a time group, before the normalization.
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
        bool(normalize_grad), float(normalize_t_factor), bool(plain),
        reduce_grad)
