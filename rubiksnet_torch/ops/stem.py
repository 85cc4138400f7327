"""The serving stem: the bias-free 3x3 stride-2 pad-1 conv of (N, T, H, W, 3)
frames to (N, T, ceil(H / 2), ceil(W / 2), C), in the input's dtype.

The same function as ``nn.backbone.StemConv`` (which keeps ``F.conv2d`` for
the module path, training and the sharded paths), with its weight packed
once by :func:`pack_stem_weight` into a (32, C) matrix of the compute dtype,
rows in (kh, kw, c) order and zero past the 27 taps. The fused executor
calls it through the operator ``rubiksnet::stem_conv`` (``ops/library.py``):

* on a CUDA tensor, :func:`stem_conv_kernel`: one launch of
  ``csrc/stem.cu::rubiks_stem_conv`` (counter ``stem_conv``), planned by
  :func:`stem_plan`; bfloat16 on the tensor cores, float32 as exact SIMT
  FMAs. It launches or raises;
* on a CPU tensor, :func:`stem_conv_plain`: ``F.conv2d`` on the unpacked
  weight, ``StemConv``'s arithmetic on the same values.

The geometry that the kernel and the CPU tests share is here: a band's
input lines (:func:`band_lines`), a staged line's layout (:data:`LEAD`,
:func:`line_pitch`), a pixel's first tap in a stage (:func:`pixel_base`)
and a tap's offset from it (:func:`tap_offset`).
"""

from __future__ import annotations

import collections
import functools

import torch
import torch.nn.functional as F

from ..utils.profiling import LaunchCounter
from . import _build

__all__ = [
    "LAUNCHES",
    "pack_stem_weight",
    "stem_conv",
    "stem_conv_kernel",
    "stem_conv_plain",
    "stem_output_shape",
    "stem_plan",
    "unpack_stem_weight",
]

LAUNCHES = LaunchCounter("stem_conv")

TAPS, K = 27, 32  # taps of the 3x3x3 window; the GEMM's depth, two k16 steps
LEAD = 8  # values before a staged line's pixel 0 (16 bytes of bf16)
WARPS, STAGES = 4, 2  # csrc/stem.cu's block and its stages
MAX_C = 256
SMEM_LIMIT = 232448  # bytes of shared memory one block can use on the H100
# Output pixels a band: 28 tiles of 16, 7 a warp (4 rows of Wo = 112 at 224
# px). Measured at 224 px (PERF.md, PR 29): bands of 1, 2, 4, 8 and 16 rows
# took 0.443, 0.435, 0.421-0.424, 0.424 and 0.577 ms at batch 64, and 4 rows
# was also the fastest at batch 8.
BAND_PIXELS = 448


def _half(d):
    return (d + 1) // 2


def stem_output_shape(shape, c):
    """(N, T, ceil(H / 2), ceil(W / 2), c) of frames ``shape`` (N, T, H, W,
    3); symbolic sizes pass through."""
    n, t, h, w, _ = shape
    return (n, t, _half(h), _half(w), c)


def pack_stem_weight(weight, dtype):
    """``StemConv``'s weight (C, 3, 3, 3), (out, c, kh, kw), as the kernel's
    (32, C) matrix of ``dtype``: row kh * 9 + kw * 3 + c, zero past 27."""
    c = weight.shape[0]
    w = weight.detach().to(dtype).permute(2, 3, 1, 0).reshape(TAPS, c)
    return torch.cat([w, w.new_zeros(K - TAPS, c)]).contiguous()


def unpack_stem_weight(packed):
    """The inverse of :func:`pack_stem_weight`: (C, 3, 3, 3), contiguous."""
    c = packed.shape[1]
    return packed[:TAPS].reshape(3, 3, 3, c).permute(3, 2, 0, 1).contiguous()


def stem_conv_plain(video, packed):
    """``F.conv2d`` on the unpacked weight, frame by frame (the plain
    version; ``StemConv._conv``'s arithmetic)."""
    n, t, h, w, c = video.shape
    y = F.conv2d(video.reshape(n * t, h, w, c).permute(0, 3, 1, 2),
                 unpack_stem_weight(packed).to(video.dtype), stride=2,
                 padding=1)
    y = y.permute(0, 2, 3, 1)
    return y.reshape(n, t, *y.shape[1:]).contiguous()


# ---------------------------------------------------------- the geometry


def line_pitch(w):
    """Values from one staged line to the next: ``LEAD`` values, the line's
    W pixels of 3 values and a zero pixel after them, rounded up to 8 (16
    bytes). Pixel -1 (values LEAD - 3 .. LEAD - 1) is zero too."""
    return (LEAD + 3 * (w + 1) + 7) // 8 * 8


def band_lines(band, rows, h):
    """The input rows that band ``band`` of ``rows`` output rows stages, in
    order: 2 oh - 1 + kh for its first row oh0 to its last (the last band
    may be short), 2 n + 1 rows for n output rows; a row outside [0, h) is
    staged as zeros."""
    oh0 = band * rows
    nrows = min(rows, _half(h) - oh0)
    return list(range(2 * oh0 - 1, 2 * (oh0 + nrows)))


def pixel_base(q, wo, pitch):
    """Where the first tap (kh = kw = c = 0) of the band's pixel q (its
    rows flattened, Wo a row) lies in the stage: line 2r, value LEAD + 3 (2
    ow - 1)."""
    r, ow = divmod(q, wo)
    return 2 * r * pitch + LEAD - 3 + 6 * ow


def tap_offset(k, pitch):
    """Offset of tap k = kh * 9 + kw * 3 + c from a pixel's first tap: the
    9 taps of a kh are contiguous in a staged line. None past 27 (the
    kernel reads tap 0 there under a zero mask)."""
    return None if k >= TAPS else (k // 9) * pitch + k % 9


# ---------------------------------------------------------- the plan

StemPlan = collections.namedtuple("StemPlan",
                                  "rows bands copy_bytes smem_bytes")


def _weight_stride(c):
    """Values between the weight's rows in shared memory: C rounded up to 8,
    to an odd number of 16-byte pieces (ldmatrix's 8 rows then fall in
    distinct banks)."""
    cpad = (c + 7) // 8 * 8
    return cpad if (cpad // 8) % 2 else cpad + 8


def _smem_bytes(rows, w, c):
    stage = (2 * rows + 1) * line_pitch(w)
    out = (WARPS * 16 * c * 2 + 15) // 16 * 16
    return 2 * (K * _weight_stride(c) + STAGES * stage) + out


@functools.lru_cache(maxsize=None)
def stem_plan(h, w, c, copy_limit=16):
    """How ``csrc/stem.cu`` runs bfloat16 frames of H x W = ``h`` x ``w``
    pixels to C = ``c`` channels. A pure function of its arguments.

    The rule: a band holds about ``BAND_PIXELS`` output pixels (whole rows,
    at least one); a block's shared memory holds the weight, two stages of
    2 rows + 1 lines and the warps' output slices. ``copy_bytes``: the
    widest of 16, 4 and 2 that divides a line's 6 W bytes and is at most
    ``copy_limit`` (the input's alignment). float32 takes no plan but the
    same limits."""
    ho, wo = _half(h), _half(w)
    if c > MAX_C:
        raise ValueError(f"stem_conv takes at most {MAX_C} output channels, "
                         f"got {c}")
    rows = max(1, min(ho, BAND_PIXELS // wo))
    smem = _smem_bytes(rows, w, c)
    if smem > SMEM_LIMIT:
        raise ValueError(f"stem_conv: a line of {w} pixels does not fit a "
                         f"block's shared memory")
    copy = next(b for b in (16, 4, 2) if b <= copy_limit and (6 * w) % b == 0)
    return StemPlan(rows, -(-ho // rows), copy, smem)


# ---------------------------------------------------------- the kernel

_ENTRY_ARGS = (_build.PTR, _build.PTR, _build.PTR, *[_build.INT] * 8,
               _build.PTR)


def _check_args(video, packed):
    if video.ndim != 5 or video.shape[-1] != 3:
        raise ValueError(
            f"stem_conv: expected frames (N, T, H, W, 3), got "
            f"{tuple(video.shape)}")
    if packed.ndim != 2 or packed.shape[0] != K:
        raise ValueError(f"stem_conv: the packed weight must be ({K}, C), "
                         f"got {tuple(packed.shape)}")
    if packed.dtype != video.dtype:
        raise TypeError(f"stem_conv: weight {packed.dtype} for frames "
                        f"{video.dtype}; pack it in the compute dtype")


def stem_conv_kernel(video, packed):
    """The stem on CUDA tensors: frames (N, T, H, W, 3) contiguous, the
    packed weight (32, C) of their dtype (float32 or bfloat16); one launch
    of ``rubiks_stem_conv`` (csrc/stem.cu)."""
    _check_args(video, packed)
    dev = video.device
    if dev.type != "cuda" or packed.device != dev:
        raise ValueError(f"stem_conv_kernel needs its tensors on one CUDA "
                         f"device, got {video.device} and {packed.device}")
    if not (video.is_contiguous() and packed.is_contiguous()):
        raise ValueError("stem_conv_kernel needs contiguous tensors")
    n, t, h, w, _ = video.shape
    c = packed.shape[1]
    at = video.data_ptr()
    plan = stem_plan(h, w, c, 16 if at % 16 == 0 else 4 if at % 4 == 0 else 2)
    y = torch.empty(stem_output_shape(video.shape, c), dtype=video.dtype,
                    device=dev)
    fn = _build.kernel_function("rubiks_stem_conv", *_ENTRY_ARGS)
    args = (at, packed.data_ptr(), y.data_ptr(),
            _build.dtype_code(video.dtype), n * t, h, w, c, plan.rows,
            plan.copy_bytes, plan.smem_bytes, _build.stream_of(video))
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        _build.check(rc, "rubiks_stem_conv")
    LAUNCHES.count += 1
    return y


def stem_conv(video, packed):
    """The stem of frames (N, T, H, W, 3) with the packed weight (32, C):
    the operator ``rubiksnet::stem_conv`` (``ops/library.py``), the kernel
    for a CUDA tensor, :func:`stem_conv_plain` for a CPU tensor."""
    _check_args(video, packed)
    return torch.ops.rubiksnet.stem_conv.default(video, packed)
