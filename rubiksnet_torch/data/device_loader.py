"""Frame decode, resize and crop on the card: nvjpeg and ``resize_crop_u8``.

The counterpart, on the H100's machine, of the native loader
(``csrc/rubiks_loader.cpp``, ``native_loader.py``): that machine has no
libjpeg, but CUDA's nvjpeg. ``csrc/device_loader.cu`` holds the decode (a
batch of JPEG byte strings into one device buffer of interleaved RGB) and
one hand-written kernel, ``resize_crop_u8``: the shorter-side triangle
resize (PIL's BILINEAR, the C++ loader's ``resize_rgb``) and the crop of a
batch of frames, 1 or 3 crops a frame, to uint8 channel-last on the card,
bit for bit the C++ loader's on the same RGB. Its default route is the
staged kernel (:func:`resize_crop_plan`: a block a band of rows of a crop,
the source rows and the horizontal pass in shared memory, a copy route for
frames only cropped; the coefficient tables kept on the card, the batch's
few bytes through reused pinned buffers); ``route="previous"`` keeps the
first kernel callable for timing beside it.

The library is built with ``nvcc`` (``sm_90a``, ``-lnvjpeg``) at first use
into the git-ignored ``rubiksnet_torch/build/``, keyed by a digest of the
source and flags, and loaded with ``ctypes``; it is a library of its own,
apart from the model's kernels, so a machine without nvjpeg still builds
and runs those. A build that fails raises; nothing falls back to PIL.

On a CPU device the entry points run the plain versions (Pillow's decode,
:func:`plain_resize_crop`), as the model's wrappers do; on a CUDA device
they launch or raise.

``python -m rubiksnet_torch.data.device_loader`` prints :func:`probe` as
one JSON line: where nvjpeg's header and library are, its version, and
whether its hardware backend starts on this card.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import glob
import hashlib
import io
import json
import math
import os
import site
import subprocess
import sys
import threading
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops._build import NVCC_FLAGS, _find_nvcc, stream_of
from ..utils.profiling import LaunchCounter, setup_span, span

SOURCE = Path(__file__).resolve().parent / "csrc" / "device_loader.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
# -fmad=false: no multiply-add contraction anywhere in the file (the kernel
# also spells each step with __dmul_rn / __dadd_rn); the C++ loader, built
# by g++ for x86-64, rounds every product and every sum.
LOADER_FLAGS = ("-fmad=false",)

# nvjpeg's backends (nvjpeg.h, nvjpegBackend_t) and status 0.
BACKEND_DEFAULT, BACKEND_GPU_HYBRID, BACKEND_HARDWARE = 0, 2, 3
NVJPEG_STATUS_SUCCESS = 0

# The route of the frames the hardware engines do not take (all of them
# where nvjpegCreateEx refuses the hardware backend, as on the H100's
# machine: NVJPEG_STATUS_ARCH_MISMATCH): GPU_HYBRID (device_loader.cu's
# kFallback), whose batched call decodes Huffman on the GPU from about 100
# frames a batch; the default backend would decode it on the host.
FALLBACK_ROUTE = "gpu_hybrid"

LAUNCHES = LaunchCounter("resize_crop_u8")
# Frames decoded, by route: "hardware" (the JPEG engines),
# FALLBACK_ROUTE, "pillow" (the plain decode, on the CPU).
BACKEND_FRAMES = {}

# nvjpeg's decode against Pillow's (libjpeg-turbo) of the same files: their
# IDCTs and chroma upsampling differ, so not bit for bit. The bound, per
# channel over all pixels compared: mean |diff| and max |diff| in levels.
DECODE_BOUND = {"mean": 1.0, "max": 8}

PTR = ctypes.c_void_p
INT = ctypes.c_int
INT_P = ctypes.POINTER(ctypes.c_int)


def reset_counts() -> None:
    """Set the launch counter and the frames-by-backend counts to 0."""
    LAUNCHES.reset()
    BACKEND_FRAMES.clear()


def decode_diff(got, ref) -> dict:
    """Per channel mean and max |got - ref| over two equal lists of uint8
    arrays (..., 3), and whether both are within ``DECODE_BOUND``."""
    if len(got) != len(ref):
        raise ValueError(f"{len(got)} arrays against {len(ref)}")
    total, worst, count = np.zeros(3), np.zeros(3, np.int64), 0
    for a, b in zip(got, ref):
        if a.shape != b.shape:
            raise ValueError(f"shapes {a.shape} and {b.shape}")
        d = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
        d = d.reshape(-1, 3)
        total += d.sum(0)
        worst = np.maximum(worst, d.max(0))
        count += len(d)
    mean = total / max(count, 1)
    return {"mean_abs_diff": mean.tolist(), "max_abs_diff": worst.tolist(),
            "bound": dict(DECODE_BOUND),
            "within_bound": bool(mean.max() <= DECODE_BOUND["mean"]
                                 and worst.max() <= DECODE_BOUND["max"])}


# ------------------------------------------------------------- the probe


def _cuda_roots():
    roots = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda", *sorted(glob.glob("/usr/local/cuda-*"))]
    try:
        roots.append(str(Path(_find_nvcc()).resolve().parent.parent))
    except RuntimeError:
        pass
    seen = []
    for r in roots:
        if r and os.path.isdir(r) and os.path.realpath(r) not in seen:
            seen.append(os.path.realpath(r))
    return seen


def _site_dirs():
    dirs = list(sys.path)
    try:
        dirs += site.getsitepackages()
    except AttributeError:
        pass
    return [d for d in dict.fromkeys(dirs) if d and os.path.isdir(d)]


def nvjpeg_files():
    """{"headers": [...], "libraries": [...]}: every ``nvjpeg.h`` and
    ``libnvjpeg.so*`` under the CUDA roots (``$CUDA_HOME``,
    ``/usr/local/cuda*``, nvcc's own, each with ``include``, ``lib64`` and
    ``targets/x86_64-linux/{include,lib}``) and under ``nvidia/nvjpeg`` of
    the Python site directories."""
    inc, lib = [], []
    for root in _cuda_roots():
        for d in ("include", "targets/x86_64-linux/include"):
            inc += glob.glob(os.path.join(root, d, "nvjpeg.h"))
        for d in ("lib64", "lib", "targets/x86_64-linux/lib"):
            lib += glob.glob(os.path.join(root, d, "libnvjpeg.so*"))
    for d in _site_dirs():
        base = os.path.join(d, "nvidia", "nvjpeg")
        inc += glob.glob(os.path.join(base, "include", "nvjpeg.h"))
        lib += glob.glob(os.path.join(base, "lib", "libnvjpeg.so*"))
    return {"headers": sorted(dict.fromkeys(inc)),
            "libraries": sorted(dict.fromkeys(lib))}


def _nvjpeg_library(files) -> Optional[str]:
    """The libnvjpeg to link and load: the first with the plain name or a
    major version, else what the loader's search path finds."""
    libs = files["libraries"]
    for lib in libs:
        if lib.endswith(".so"):
            return lib
    if libs:
        return min(libs, key=len)
    return ctypes.util.find_library("nvjpeg")


def toolchain_present() -> bool:
    """Whether this machine has nvcc and nvjpeg (its header or its
    library), without building: the probe that decides for the device
    loader before a build is tried."""
    try:
        _find_nvcc()
    except RuntimeError:
        return False
    files = nvjpeg_files()
    return bool(files["headers"] or _nvjpeg_library(files))


def probe() -> dict:
    """Where nvjpeg is, its version (``nvjpegGetProperty``), and whether
    ``nvjpegCreateEx`` starts its hardware backend and its default one on
    this machine (statuses; 0 is success). Loads libnvjpeg with ctypes
    alone: no build."""
    files = nvjpeg_files()
    out = {"nvcc": None, **files, "library": _nvjpeg_library(files),
           "version": None, "create_hardware": None,
           "create_gpu_hybrid": None, "create_default": None,
           "hardware_engines": None}
    try:
        out["nvcc"] = _find_nvcc()
    except RuntimeError as err:
        out["nvcc_error"] = str(err)
    if out["library"] is None:
        return out
    try:
        lib = ctypes.CDLL(out["library"])
    except OSError as err:
        out["load_error"] = str(err)
        return out
    parts = []
    for prop in range(3):  # MAJOR_VERSION, MINOR_VERSION, PATCH_LEVEL
        v = ctypes.c_int(-1)
        lib.nvjpegGetProperty(prop, ctypes.byref(v))
        parts.append(v.value)
    out["version"] = ".".join(map(str, parts))
    if torch.cuda.is_available():
        torch.cuda.init()
    for key, backend in (("create_hardware", BACKEND_HARDWARE),
                         ("create_gpu_hybrid", BACKEND_GPU_HYBRID),
                         ("create_default", BACKEND_DEFAULT)):
        handle = ctypes.c_void_p()
        status = lib.nvjpegCreateEx(backend, None, None, 0,
                                    ctypes.byref(handle))
        out[key] = status
        if status == NVJPEG_STATUS_SUCCESS:
            if backend == BACKEND_HARDWARE and hasattr(
                    lib, "nvjpegGetHardwareDecoderInfo"):
                engines, cores = ctypes.c_uint(0), ctypes.c_uint(0)
                if lib.nvjpegGetHardwareDecoderInfo(
                        handle, ctypes.byref(engines),
                        ctypes.byref(cores)) == NVJPEG_STATUS_SUCCESS:
                    out["hardware_engines"] = [engines.value, cores.value]
            lib.nvjpegDestroy(handle)
    return out


# ------------------------------------------------------------- the build


def _link_flags():
    """nvcc's include and link flags for nvjpeg: its header's directory,
    and its library's directory as a link path and run path."""
    files = nvjpeg_files()
    if not files["headers"]:
        raise RuntimeError("nvjpeg.h not found (the CUDA roots and the site "
                           "directories): the device loader cannot be built")
    flags = [f"-I{os.path.dirname(files['headers'][0])}"]
    lib = _nvjpeg_library(files)
    if lib is not None and os.path.dirname(lib):
        d = os.path.dirname(lib)
        flags += [f"-L{d}", "-Xlinker", f"-rpath,{d}"]
    return tuple(flags) + ("-lnvjpeg",)


def _digest(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


# C entry -> argument types (csrc/device_loader.cu, extern "C").
_SIGNATURES = {
    "rdl_create": [INT_P, ctypes.POINTER(PTR)],
    "rdl_image_info": [PTR, ctypes.POINTER(ctypes.c_char_p),
                       ctypes.POINTER(ctypes.c_size_t), INT, INT_P, INT_P,
                       INT_P],
    "rdl_decode": [PTR, ctypes.POINTER(ctypes.c_char_p),
                   ctypes.POINTER(ctypes.c_size_t), INT, INT_P,
                   ctypes.POINTER(ctypes.c_longlong), PTR, PTR, INT_P,
                   INT_P],
    "rdl_resize_crop_u8": [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR,
                           PTR],
    "rdl_resize_crop_staged": [PTR, PTR, PTR, INT, INT, INT, INT, INT_P, INT,
                               PTR, PTR],
}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source and flags digest) and load the device loader's
    library, inside the span ``rubiksnet.setup.loader_library`` (attribute
    ``built``: nvcc ran); raises RuntimeError where nvcc or nvjpeg is
    missing or the build fails."""
    with setup_span("rubiksnet.setup.loader_library", built=False) as rec:
        return _load_library(rec)


def _load_library(rec) -> ctypes.CDLL:
    nvcc = _find_nvcc()
    flags = NVCC_FLAGS + LOADER_FLAGS + _link_flags()
    lib_path = BUILD_DIR / f"librubiks_device_loader_{_digest(flags)}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, *LOADER_FLAGS, "-shared", "-o", str(tmp),
             str(SOURCE), *_link_flags()],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building the device loader failed ({proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
        rec.attrs["built"] = True
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        raise RuntimeError(f"loading {lib_path} failed: {e}") from e
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = INT
    lib.rdl_destroy.argtypes = [PTR]
    lib.rdl_destroy.restype = None
    lib.rdl_error_string.argtypes = [INT]
    lib.rdl_error_string.restype = ctypes.c_char_p
    return lib


def _check(code: int, name: str) -> None:
    if code != 0:
        msg = load_library().rdl_error_string(code).decode()
        raise RuntimeError(f"{name}: error {code}: {msg}")


# ------------------------------------------------------------- the decode

ALIGN = 256  # each frame's first byte in the decode buffer


def frame_layout(widths, heights):
    """Where each frame's interleaved RGB starts in a decode buffer (each
    start a multiple of ``ALIGN``), and the buffer's size in bytes."""
    nbytes = np.asarray(widths, np.int64) * np.asarray(heights, np.int64) * 3
    padded = -(-nbytes // ALIGN) * ALIGN
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)
    return starts, int(padded.sum())


def _sizes(widths, heights, starts):
    return np.stack([np.asarray(widths, np.int64),
                     np.asarray(heights, np.int64), starts], axis=1)


def plain_decode(blob: bytes) -> np.ndarray:
    """Pillow's decode of one JPEG byte string, ``convert("RGB")``, no
    resize: (h, w, 3) uint8."""
    from PIL import Image

    with Image.open(io.BytesIO(blob)) as im:
        return np.asarray(im.convert("RGB"))


def pack_frames(frames: Sequence[np.ndarray], device="cpu"):
    """(h, w, 3) uint8 frames -> (rgb, sizes) as :func:`decode_batch` gives
    them: one uint8 buffer on ``device`` and the (n, 3) int64 rows of width,
    height and first byte."""
    widths = [f.shape[1] for f in frames]
    heights = [f.shape[0] for f in frames]
    starts, total = frame_layout(widths, heights)
    buf = np.zeros(total, np.uint8)
    for f, s in zip(frames, starts):
        buf[s:s + f.size] = np.ascontiguousarray(f, np.uint8).reshape(-1)
    return (torch.from_numpy(buf).to(device),
            _sizes(widths, heights, starts))


class Decoder:
    """nvjpeg's state on one card (``rdl_create``: the hardware backend
    where it starts, GPU_HYBRID for the other frames, chroma upsampled by
    interpolation as libjpeg does) and its decode buffer, reused across
    batches and grown to the largest batch seen. One decode at a time (a
    lock): the state is not thread-safe."""

    def __init__(self, device):
        self.lib = load_library()
        self.device = torch.device(device)
        state, hw = PTR(), ctypes.c_int(-1)
        with torch.cuda.device(self.device):
            _check(self.lib.rdl_create(ctypes.byref(hw),
                                       ctypes.byref(state)), "rdl_create")
        self.state = state
        self.hw_status = hw.value  # nvjpegCreateEx(HARDWARE): 0 = started
        self.buffer = None
        self.held = None  # the last batch's byte strings
        self.lock = threading.Lock()

    def __del__(self):
        if getattr(self, "state", None):
            self.lib.rdl_destroy(self.state)

    def _arrays(self, blobs):
        n = len(blobs)
        return ((ctypes.c_char_p * n)(*blobs),
                (ctypes.c_size_t * n)(*map(len, blobs)))

    def image_sizes(self, blobs):
        """(widths, heights) int32 arrays from the frames' headers."""
        n = len(blobs)
        data, lens = self._arrays(blobs)
        w, h = np.empty(n, np.int32), np.empty(n, np.int32)
        failed = ctypes.c_int(-1)
        code = self.lib.rdl_image_info(self.state, data, lens, n, _iptr(w),
                                       _iptr(h), ctypes.byref(failed))
        if code:
            raise IOError(f"frame {failed.value} of the batch is not a JPEG "
                          f"nvjpeg reads: "
                          f"{self.lib.rdl_error_string(code).decode()}")
        return w, h

    def decode(self, blobs, stream=None):
        """(rgb, sizes) of :func:`decode_batch`, on ``stream`` (a raw
        handle; the current stream of the card when None). ``rgb`` is a view
        of the reused buffer: valid until this decoder's next call."""
        blobs = [bytes(b) for b in blobs]
        with self.lock, torch.cuda.device(self.device):
            widths, heights = self.image_sizes(blobs)
            starts, total = frame_layout(widths, heights)
            if self.buffer is None or self.buffer.numel() < total:
                self.buffer = torch.empty(max(total, 1), dtype=torch.uint8,
                                          device=self.device)
            if stream is None:
                stream = stream_of(self.buffer)
            data, lens = self._arrays(blobs)
            hw, rest = ctypes.c_int(0), ctypes.c_int(0)
            _check(self.lib.rdl_decode(
                self.state, data, lens, len(blobs), _iptr(widths),
                starts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                self.buffer.data_ptr(), stream, ctypes.byref(hw),
                ctypes.byref(rest)), "rdl_decode")
            self.held = blobs
        _count("hardware", hw.value)
        _count(FALLBACK_ROUTE, rest.value)
        return self.buffer[:total], _sizes(widths, heights, starts)


def _count(route: str, frames: int) -> None:
    if frames:
        BACKEND_FRAMES[route] = BACKEND_FRAMES.get(route, 0) + frames


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(INT_P)


_DECODERS = {}
_DECODERS_LOCK = threading.Lock()


def decoder_for(device) -> Decoder:
    """The card's :class:`Decoder` (one a device, made at first use)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _DECODERS_LOCK:
        if device not in _DECODERS:
            _DECODERS[device] = Decoder(device)
        return _DECODERS[device]


def decode_batch(blobs: Sequence[bytes], device, stream=None):
    """Decode a batch of JPEG byte strings into one uint8 buffer of
    interleaved RGB on ``device``: -> (rgb, sizes), ``sizes`` the (n, 3)
    int64 rows of width, height and the frame's first byte in ``rgb``. On
    the card through nvjpeg on ``stream`` (a raw handle, else the current
    stream; ``rgb`` is valid until the card's next decode), on the CPU
    through Pillow (:func:`plain_decode`)."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_batch: no decode for device {device}")
    with span("rubiksnet.data.decode", device, frames=len(blobs)):
        if device.type == "cpu":
            _count("pillow", len(blobs))
            return pack_frames([plain_decode(b) for b in blobs])
        return decoder_for(device).decode(blobs, stream)


# ------------------------------------------------- resize and crop: the plan


class Coeffs(NamedTuple):
    """One axis of a resize: each output pixel's first tap, tap count and
    ``ksize`` weights (zero past the count)."""

    lo: np.ndarray
    counts: np.ndarray
    weights: np.ndarray  # (out, ksize) float64
    ksize: int


@functools.lru_cache(maxsize=None)
def triangle_coeffs(in_size: int, out_size: int) -> Coeffs:
    """``triangle_coeffs`` of the C++ loader (rubiks_loader.cpp:87-119)
    step for step in double: Pillow's BILINEAR support scaled by the
    downscale factor, each row normalized by its own sum (summed in tap
    order). Cached by (in, out); do not modify the arrays."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    lo = np.zeros(out_size, np.int32)
    counts = np.zeros(out_size, np.int32)
    weights = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = int(max(center - support + 0.5, 0.0))
        xmax = int(min(center + support + 0.5, float(in_size))) - xmin
        row, ww = [], 0.0
        for x in range(xmax):
            arg = (x + xmin - center + 0.5) * ss
            weight = -arg if arg < 0 else arg
            weight = 1.0 - weight if weight < 1.0 else 0.0
            row.append(weight)
            ww += weight
        if ww != 0.0:
            row = [w / ww for w in row]
        weights[xx, :xmax] = row
        lo[xx], counts[xx] = xmin, xmax
    for a in (lo, counts, weights):
        a.setflags(write=False)
    return Coeffs(lo, counts, weights, ksize)


def resizes(w: int, h: int, scale_size: int) -> bool:
    """Whether the C++ loader resizes a w x h frame (``decode_resized``):
    unless ``scale_size`` is 0 or already its shorter side."""
    return scale_size > 0 and min(w, h) != scale_size


def resized_size(w: int, h: int, scale_size: int):
    """The C++ loader's shorter-side target (``decode_resized``)."""
    if not resizes(w, h, scale_size):
        return w, h
    if w < h:
        return scale_size, int(scale_size * h / w)
    return int(scale_size * w / h), scale_size


def _shape_groups(sizes):
    """The distinct (w, h) rows of ``sizes`` in ``np.unique(axis=0)``'s
    order, and each frame's index among them: one integer key a row, which
    sorts far faster than a row-wise unique of the wrapper's hot path."""
    sizes = np.asarray(sizes, np.int64)
    if len(sizes) == 0:
        return np.zeros((0, 2), np.int64), np.zeros(0, np.intp)
    keys = sizes[:, 0] * (1 << 32) + sizes[:, 1]
    if (keys == keys[0]).all():
        return sizes[:1, :2].copy(), np.zeros(len(sizes), np.intp)
    uniq, inverse = np.unique(keys, return_inverse=True)
    return np.stack([uniq >> 32, uniq & 0xFFFFFFFF], 1), inverse.reshape(-1)


def _origins_array(origins, n):
    """``origins`` as int32 (n, k, 2). A list that repeats the same inner
    object (a video's crops for each of its frames, as the evaluator's
    batches pass them) is converted once per distinct object: ``np.array``
    walks a nested list slowly."""
    if isinstance(origins, np.ndarray) or not n or len(origins) != n:
        return np.array(origins, np.int32).reshape(n, -1, 2)
    ids = np.fromiter(map(id, origins), np.int64, count=n)
    _, first, rows = np.unique(ids, return_index=True, return_inverse=True)
    if len(first) == n:
        return np.array(origins, np.int32).reshape(n, -1, 2)
    distinct = np.array([origins[i] for i in first], np.int32)
    return distinct.reshape(len(first), -1, 2)[rows.reshape(-1)]


def frame_geometry(sizes, scale_size, crop_size, origins, group=None):
    """Checked per-frame geometry: -> (sizes (n, 3) int64, resized (n, 2),
    origins (n, k, 2) int32 with -1 resolved as ``write_crop_u8`` centers,
    k, group)."""
    sizes = np.asarray(sizes, np.int64).reshape(-1, 3)
    n = len(sizes)
    origins = _origins_array(origins, n)
    k = origins.shape[1]
    group = n if group is None else group
    if n and (group < 1 or n % group):
        raise ValueError(f"{n} frames do not split into groups of {group}")
    shapes, inverse = _shape_groups(sizes)
    resized = np.array([resized_size(int(w), int(h), scale_size)
                        for w, h in shapes], np.int64).reshape(-1, 2)
    resized = resized[inverse]
    centred = (resized[:, None, :] - crop_size) // 2
    origins = np.where(origins < 0, centred, origins).astype(np.int32)
    bad = ((origins < 0) | (origins + crop_size > resized[:, None, :])).any(2)
    if bad.any():
        i, c = map(int, np.argwhere(bad)[0])
        rw, rh = resized[i].tolist()
        raise ValueError(
            f"crop {c} of frame {i} at {tuple(origins[i, c].tolist())}, "
            f"{crop_size} px, lies outside its {rw}x{rh} resized frame")
    return sizes, resized, origins, k, group


def _output(out, shape, device):
    if out is None:
        return torch.empty(shape, dtype=torch.uint8, device=device)
    if (tuple(out.shape) != shape or out.dtype != torch.uint8
            or out.device != device or not out.is_contiguous()):
        raise ValueError(f"out: {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}, want {shape} uint8 contiguous on "
                         f"{device}")
    return out


# ----------------------------------------------------- resize and crop: plain


def _axis_pass(x, co: Coeffs, dim: int):
    """One axis of ``resize_rgb`` on float64 ``x`` along ``dim``: a multiply
    and an add a tap, in tap order (no step fused)."""
    lo = torch.from_numpy(co.lo.astype(np.int64)).to(x.device)
    wts = torch.from_numpy(co.weights.copy()).to(x.device)
    last = x.shape[dim] - 1
    shape = [1, 1, 1]
    shape[dim] = -1
    acc = None
    for j in range(co.ksize):
        idx = torch.clamp(lo + j, max=last)
        term = wts[:, j].reshape(shape) * x.index_select(dim, idx)
        acc = term if acc is None else acc + term
    return acc


def plain_resize_crop(rgb, sizes, scale_size, crop_size, origins,
                      group=None, out=None):
    """The plain version of :func:`resize_crop`, on ``rgb``'s device, in
    float64 torch ops: the horizontal pass summed in tap order and rounded
    to float32, the vertical pass summed over those, plus 0.5, truncated and
    clamped; the C++ loader's arithmetic step for step, so bit for bit its
    result and the kernel's. A weight past a row's tap count is 0 and adds
    exactly nothing."""
    sizes, resized, origins, k, group = frame_geometry(
        sizes, scale_size, crop_size, origins, group)
    n = len(sizes)
    out = _output(out, (n * k, crop_size, crop_size, 3), rgb.device)
    for i, (w, h, start) in enumerate(sizes.tolist()):
        img = rgb[start:start + w * h * 3].view(h, w, 3)
        rw, rh = resized[i].tolist()
        if resizes(w, h, scale_size):
            tmp = _axis_pass(img.double(), triangle_coeffs(w, rw), 1)
            tmp = tmp.float().double()
            acc = _axis_pass(tmp, triangle_coeffs(h, rh), 0)
            img = torch.clamp(torch.trunc(acc + 0.5), 0, 255).to(torch.uint8)
        g, f = divmod(i, group)
        for c in range(k):
            x, y = origins[i, c].tolist()
            out[(g * k + c) * group + f] = img[y:y + crop_size,
                                               x:x + crop_size]
    return out


# ------------------------------- resize and crop: the first kernel's tables

MAX_OUTPUT_CROPS = 65535  # both kernels' grids: the output crops along y
FRAME_DESC = np.dtype([
    ("src_off", "<i8"), ("w", "<i4"), ("h", "<i4"), ("rw", "<i4"),
    ("rh", "<i4"), ("cx", "<i4"), ("cy", "<i4"), ("wx", "<i4"),
    ("wy", "<i4"), ("kx", "<i4"), ("ky", "<i4")])  # device_loader.cu


def kernel_tables(sizes, resized, origins, scale_size):
    """The kernel's inputs besides the pixels, as one byte buffer: the
    frames' descriptors (``FRAME_DESC``), their crop origins (int32), the
    (first tap, count) rows of every axis the batch resizes (int32) and
    their weights (float64), each coefficient table once a batch. ->
    (bytes as uint8, the four sections' byte offsets)."""
    n = len(sizes)
    desc = np.zeros(n, FRAME_DESC)
    desc["src_off"] = sizes[:, 2]
    desc["w"], desc["h"] = sizes[:, 0], sizes[:, 1]
    desc["rw"], desc["rh"] = resized[:, 0], resized[:, 1]
    desc["cx"] = desc["cy"] = -1
    taps, weights, where = [], [], {}
    rows = nweights = 0
    shapes, inverse = _shape_groups(sizes)
    for j, (w, h) in enumerate(shapes.tolist()):
        if not resizes(w, h, scale_size):
            continue
        rw, rh = resized_size(w, h, scale_size)
        mask = inverse == j
        for axis, key in (("x", (w, rw)), ("y", (h, rh))):
            if key not in where:
                co = triangle_coeffs(*key)
                where[key] = (rows, nweights, co.ksize)
                taps.append(np.stack([co.lo, co.counts], 1))
                weights.append(co.weights.reshape(-1))
                rows += len(co.lo)
                nweights += co.weights.size
            for field, value in zip("cwk", where[key]):
                desc[field + axis][mask] = value
    parts = [desc.view(np.uint8), origins.astype(np.int32).view(np.uint8)
             .reshape(-1),
             np.concatenate(taps).astype(np.int32).view(np.uint8).reshape(-1)
             if taps else np.zeros(0, np.uint8),
             np.concatenate(weights).view(np.uint8) if weights
             else np.zeros(0, np.uint8)]
    offsets, pos = [], 0
    for p in parts:
        offsets.append(pos)
        pos += -(-p.size // 8) * 8
    buf = np.zeros(max(pos, 8), np.uint8)
    for p, o in zip(parts, offsets):
        buf[o:o + p.size] = p
    return buf, offsets


# ------------------------------------- resize and crop: the staged kernel

ROUTES = ("staged", "previous")  # resize_crop's kernels, the default first

# resize_crop_plan's knobs (read off ``utils/resize_crop_probe.py
# --sweep``): output rows a band of a resized frame, bands a block walks,
# threads a block, output rows and threads a block when the batch only
# crops, and the shared memory a block of a resized frame may take
# (``SMEM_LIMIT`` is the card's).
BAND_ROWS = 16
RUN_BANDS = 7
THREADS = 512
COPY_ROWS = 16
COPY_THREADS = 128
SMEM_BUDGET = 112 * 1024
SMEM_LIMIT = 232448  # device_loader.cu's kMaxSmem
MAX_THREADS = 512  # device_loader.cu's kMaxThreads: the launch bound

STAGED_FRAME = np.dtype([
    ("src_off", "<i8"), ("xt", "<u8"), ("xw", "<u8"), ("yt", "<u8"),
    ("yw", "<u8"), ("w", "<i4"), ("h", "<i4"), ("kx", "<i4"),
    ("ky", "<i4")])  # device_loader.cu's StagedFrame


class ResizeCropPlan(NamedTuple):
    """How ``resize_crop_u8_staged`` runs a batch (``device_loader.cu``'s
    StagedPlan, in its order, then the dynamic shared memory)."""

    rows: int      # output rows a band
    tile: int      # output columns a block (the crop's width, unless split)
    bands: int     # bands down a crop
    tiles: int     # blocks across a crop
    run: int       # bands a block walks, one after the other
    runs: int      # blocks down a crop
    threads: int
    smax: int      # source rows a band's vertical taps reach, at most
    pitch: int     # bytes a staged source row: the 16-byte words of a span
    hp_pitch: int  # floats a row of the horizontal pass
    kx: int        # the most weights a column (row) of the batch has
    ky: int
    off_cw: int    # byte offsets in shared memory: column weights,
    off_rw: int    # row weights, the horizontal pass, the source rows,
    off_hp: int    # the column and the row (first tap, count) pairs
    off_src: int
    off_ct: int
    off_rt: int
    vec: int       # a copied row is stored 16 bytes at a time
    smem: int      # bytes of dynamic shared memory a block


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@functools.lru_cache(maxsize=None)
def axis_span(in_size: int, out_size: int, window: int) -> int:
    """The most source pixels that ``window`` consecutive output pixels of
    the (in, out) resize reach, from the first tap of the first to the last
    tap of the last (both grow with the output pixel)."""
    co = triangle_coeffs(in_size, out_size)
    ends = co.lo.astype(np.int64) + co.counts
    if (np.diff(co.lo) < 0).any() or (np.diff(ends) < 0).any():
        raise ValueError(f"taps of {in_size} -> {out_size} do not grow")
    window = min(window, out_size)
    return int((ends[window - 1:] - co.lo[:out_size - window + 1]).max())


def resize_crop_plan(crop: int, axes=(), aligned: bool = True
                     ) -> ResizeCropPlan:
    """The staged kernel's launch plan for one batch: ``crop`` px crops;
    ``axes`` the batch's resizes, ((w, rw), (h, rh)) a frame shape (empty
    where it only crops); ``aligned``: the output starts on 16 bytes. A
    pure function of its arguments and the knobs.

    A batch that only crops: blocks of ``COPY_THREADS`` threads, each
    ``COPY_ROWS`` rows of a crop, copied 16 bytes at a time where a row is
    a multiple of 16 bytes. Else a block walks a run of ``RUN_BANDS``
    bands of ``rows`` output rows across a ``tile`` of columns; its shared
    memory is sized from the batch's tap counts (the most source rows and
    columns any window of that many output rows and columns reaches,
    :func:`axis_span`; the run's row taps; two buffers of a band's source
    rows); the plan takes the largest ``rows`` up to ``BAND_ROWS`` at the
    crop's full width that fits ``SMEM_BUDGET``, and splits the width into
    tiles (multiples of 4 columns) only where one row does not fit."""
    return _plan(int(crop), tuple(sorted(axes)), bool(aligned),
                 (BAND_ROWS, RUN_BANDS, THREADS, COPY_ROWS, COPY_THREADS,
                  SMEM_BUDGET))


def _layout(rows, tile, kx, ky, smax, pitch):
    """(offsets of the shared-memory arrays, hp_pitch, total bytes) of a
    block whose run covers ``rows`` output rows; ``smax`` staged rows a
    band, in two buffers."""
    hp_pitch = _round_up(tile * 3, 4)
    sizes = (kx * tile * 8, rows * ky * 8, smax * hp_pitch * 4,
             2 * smax * pitch, tile * 8, rows * 8)
    offsets, pos = [], 0
    for s in sizes:
        offsets.append(pos)
        pos += _round_up(s, 16)
    return offsets, hp_pitch, pos


@functools.lru_cache(maxsize=None)
def _plan(crop, axes, aligned, knobs):
    band_rows, run_bands, threads, copy_rows, copy_threads, budget = knobs
    if crop < 1:
        raise ValueError(f"resize_crop_plan: crop {crop}")
    for t in (threads, copy_threads):
        if not 32 <= t <= MAX_THREADS or t % 32:
            raise ValueError(f"resize_crop_plan: {t} threads a block")
    vec = int(aligned and (crop * 3) % 16 == 0)
    if not axes:
        rows = min(copy_rows, crop)
        bands = -(-crop // rows)
        return ResizeCropPlan(rows, crop, bands, 1, 1, bands, copy_threads,
                              *[0] * 11, vec, 0)
    kx = max(triangle_coeffs(*x).ksize for x, _ in axes)
    ky = max(triangle_coeffs(*y).ksize for _, y in axes)
    tile, last = crop, None
    while tile != last:
        last = tile
        for rows in range(min(band_rows, crop), 0, -1):
            bands = -(-crop // rows)
            run = min(run_bands, bands)
            smax = max(axis_span(*y, rows) for _, y in axes)
            span = max(axis_span(*x, tile) for x, _ in axes)
            pitch = _round_up(span * 3 + 15, 16)
            offsets, hp_pitch, smem = _layout(min(run * rows, crop), tile,
                                              kx, ky, smax, pitch)
            if smem <= budget:
                tiles = -(-crop // tile)
                return ResizeCropPlan(
                    rows, tile, bands, tiles, run, -(-bands // run), threads,
                    smax, pitch, hp_pitch, kx, ky, *offsets,
                    int(vec and tiles == 1), smem)
        tile = max(4, _round_up(-(-tile // 2), 4))
    raise ValueError(f"resize_crop_plan: no block of a {crop} px crop fits "
                     f"{budget} bytes of shared memory for resizes {axes}")


class AxisTable(NamedTuple):
    """One (in, out) resize axis on a device: (first tap, count) int32
    pairs and ``ksize`` float64 weights an output pixel."""

    taps: torch.Tensor     # (out, 2) int32
    weights: torch.Tensor  # (out, ksize) float64
    ksize: int


_AXIS_TABLES = {}
_AXIS_LOCK = threading.Lock()
TABLE_UPLOADS = LaunchCounter("coefficient tables")  # uploads, all devices


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def axis_table(device, in_size: int, out_size: int) -> AxisTable:
    """``triangle_coeffs(in_size, out_size)`` on ``device``: uploaded once a
    device and kept (an evaluator sees one or two frame sizes). On the card
    the upload goes through pinned memory and waits for its end, once."""
    device = _device(device)
    key = (device, int(in_size), int(out_size))
    with _AXIS_LOCK:
        if key not in _AXIS_TABLES:
            co = triangle_coeffs(in_size, out_size)
            taps = torch.from_numpy(np.stack([co.lo, co.counts], 1)
                                    .astype(np.int32))
            weights = torch.from_numpy(co.weights.copy())
            if device.type == "cuda":
                taps = taps.pin_memory().to(device)
                weights = weights.pin_memory().to(device)
            _AXIS_TABLES[key] = AxisTable(taps, weights, co.ksize)
            TABLE_UPLOADS.count += 1
        return _AXIS_TABLES[key]


def staged_tables(sizes, resized, origins, scale_size, device):
    """The staged kernel's inputs besides the pixels and the tables, as one
    byte buffer: the frames' descriptors (``STAGED_FRAME``, a resized
    frame's pointing at its :func:`axis_table` pair on ``device``) and their
    crop origins (int32). -> (bytes as uint8, the origins' byte offset, the
    batch's resizes as :func:`resize_crop_plan` takes them)."""
    n = len(sizes)
    desc = np.zeros(n, STAGED_FRAME)
    desc["src_off"] = sizes[:, 2]
    desc["w"], desc["h"] = sizes[:, 0], sizes[:, 1]
    shapes, inverse = _shape_groups(sizes)
    axes = []
    for j, (w, h) in enumerate(shapes.tolist()):
        if not resizes(w, h, scale_size):
            continue
        rw, rh = resized_size(w, h, scale_size)
        tx, ty = axis_table(device, w, rw), axis_table(device, h, rh)
        mask = inverse == j
        for field, value in (("xt", tx.taps.data_ptr()),
                             ("xw", tx.weights.data_ptr()),
                             ("yt", ty.taps.data_ptr()),
                             ("yw", ty.weights.data_ptr()),
                             ("kx", tx.ksize), ("ky", ty.ksize)):
            desc[field][mask] = value
        axes.append(((w, rw), (h, rh)))
    orig = origins.astype(np.int32).reshape(-1).view(np.uint8)
    at = _round_up(desc.nbytes, 16)
    buf = np.zeros(at + orig.size, np.uint8)
    buf[:desc.nbytes] = desc.view(np.uint8)
    buf[at:] = orig
    return buf, at, tuple(axes)


# Pinned host buffers a device, reused in turn: how many calls the host may
# run ahead of the card before it waits for a copy (a timing loop queues
# twenty and more behind a busy stream; a loader, one or two).
PINNED_SLOTS = 32


class _Pinned:
    """A device's ring of pinned buffers for the per-batch bytes, each with
    the event of the last copy that read it."""

    def __init__(self):
        self.slots = [None] * PINNED_SLOTS
        self.turn = 0
        self.lock = threading.Lock()


_PINNED = {}


def to_device(payload: np.ndarray, device) -> torch.Tensor:
    """``payload`` (uint8 host bytes) -> a new uint8 tensor on the card,
    copied with ``non_blocking=True`` on the current stream from the next
    of the device's ``PINNED_SLOTS`` pinned buffers, which is rewritten
    only after the event of its last copy. No pageable copy."""
    device = _device(device)
    with _AXIS_LOCK:
        ring = _PINNED.setdefault(device, _Pinned())
    n = max(payload.size, 1)
    with ring.lock:
        j = ring.turn
        ring.turn = (j + 1) % PINNED_SLOTS
        slot = ring.slots[j]
        if slot is not None:
            slot[1].synchronize()  # the last copy out of it is done
        buf = slot[0] if slot is not None and slot[0].numel() >= n else (
            torch.empty(max(n, 4096), dtype=torch.uint8, pin_memory=True))
        buf.numpy()[:payload.size] = payload
        stream = torch.cuda.current_stream(device)
        out = torch.empty(n, dtype=torch.uint8, device=device)
        out.copy_(buf[:n], non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        ring.slots[j] = (buf, done)
    return out


def resize_crop(rgb, sizes, scale_size, crop_size, origins, group=None,
                out=None, route="staged"):
    """Shorter-side resize to ``scale_size`` and crop of a batch of decoded
    frames (``rgb``, ``sizes`` as :func:`decode_batch` gives them), ``k``
    crops a frame: ``origins`` (n, k, 2) (x, y) in resized coordinates (-1
    centers as the C++ loader does). -> uint8 (n * k, crop, crop, 3), into
    ``out`` when given; frames in groups of ``group`` (default all n), each
    group crop-major: crop 0 of its frames, then crop 1, ... (a group of a
    video's frames gives ``rl_load_frames_mc_u8``'s order). On the card one
    launch of ``resize_crop_u8`` (:func:`resize_crop_launch`): ``route``
    "staged" (the default) or "previous" (the first kernel, a block a row
    of a crop); on the CPU :func:`plain_resize_crop`."""
    if route not in ROUTES:
        raise ValueError(f"resize_crop: route {route!r}, not one of "
                         f"{ROUTES}")
    if rgb.device.type == "cpu":
        with span("rubiksnet.data.resize_crop"):
            return plain_resize_crop(rgb, sizes, scale_size, crop_size,
                                     origins, group, out)
    launch, out = resize_crop_launch(rgb, sizes, scale_size, crop_size,
                                     origins, group, out, route)
    if launch is not None:
        with span("rubiksnet.data.resize_crop", rgb):
            launch()
    return out


def resize_crop_launch(rgb, sizes, scale_size, crop_size, origins,
                       group=None, out=None, route="staged"):
    """:func:`resize_crop`'s work on the card up to its launch: the checks,
    the output, the batch's bytes on the card (the staged route's through
    :func:`staged_tables` and :func:`to_device`, its coefficient tables
    kept per size by :func:`axis_table`, its plan :func:`resize_crop_plan`;
    the previous route's tables built each call, :func:`kernel_tables`). ->
    (launch, out): ``launch()`` launches ``route``'s kernel on this batch
    on the current stream and counts it in ``LAUNCHES`` (None for an empty
    batch). ``resize_crop`` calls it once; a timing that calls it again
    times the kernel without the host's work."""
    if route not in ROUTES:
        raise ValueError(f"resize_crop: route {route!r}, not one of "
                         f"{ROUTES}")
    if rgb.device.type != "cuda":
        raise ValueError(f"resize_crop: no kernel for device {rgb.device}")
    if rgb.dtype != torch.uint8 or rgb.dim() != 1 or not (
            rgb.is_contiguous()):
        raise ValueError("resize_crop: rgb must be a contiguous 1-D uint8 "
                         "buffer")
    with torch.cuda.device(rgb.device):
        with span("rubiksnet.data.geometry", rgb):
            sizes, resized, origins, k, group = frame_geometry(
                sizes, scale_size, crop_size, origins, group)
            n = len(sizes)
            if n and int((sizes[:, 0] * sizes[:, 1] * 3
                          + sizes[:, 2]).max()) > rgb.numel():
                raise ValueError(
                    "resize_crop: a frame lies past the end of rgb")
            if n * k > MAX_OUTPUT_CROPS:
                raise ValueError(f"resize_crop: {n * k} output crops in one "
                                 f"launch, at most {MAX_OUTPUT_CROPS}")
            out = _output(out, (n * k, crop_size, crop_size, 3), rgb.device)
            if n == 0:
                return None, out
            if route == "previous":
                buf, (o_desc, o_orig, o_taps, o_wts) = kernel_tables(
                    sizes, resized, origins, scale_size)
            else:
                buf, o_orig, axes = staged_tables(sizes, resized, origins,
                                                  scale_size, rgb.device)
                plan = resize_crop_plan(crop_size, axes,
                                        out.data_ptr() % 16 == 0)
        with span("rubiksnet.data.copy", rgb):
            tables = to_device(buf, rgb.device)
    lib = load_library()
    base = tables.data_ptr()
    if route == "previous":
        entry = lib.rdl_resize_crop_u8
        args = (rgb.data_ptr(), base + o_desc, base + o_orig, base + o_taps,
                base + o_wts, n, k, group, crop_size, out.data_ptr())
    else:
        entry = lib.rdl_resize_crop_staged
        args = (rgb.data_ptr(), base, base + o_orig, n, k, group, crop_size,
                (ctypes.c_int * len(plan))(*plan), len(plan), out.data_ptr())

    def launch():
        with torch.cuda.device(rgb.device):
            code = entry(*args, stream_of(rgb))
        _check(code, f"resize_crop_u8 ({route})")
        LAUNCHES.count += 1

    launch.keep = (tables, out)  # the pointers in args stay valid
    return launch, out


if __name__ == "__main__":
    print(json.dumps(probe()))
