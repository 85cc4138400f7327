"""ctypes binding of the native frame loader (``csrc/rubiks_loader.cpp``).

Counterpart of ``rubiksnet_tpu/data/native_loader.py``: libjpeg decode, the
shorter-side triangle-filter resize of PIL's BILINEAR, crop and (in the
float32 entries) normalize, the frames of one call decoded in parallel by a
pool of threads and written channel-last.

The library is built with ``g++`` at its first use by the port's one builder
(``ops/_build.py``) into the git-ignored ``rubiksnet_torch/build/``, keyed by a
digest of the source and flags, and loaded with ``ctypes.CDLL``, which releases
the interpreter lock during each call. A build that fails raises; nothing falls
back. ``available()`` says whether it builds here (the evaluator's ``--loader
auto``), ``toolchain_present()`` whether g++ and libjpeg's header and library
are here at all, without building.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..ops import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rubiks_loader.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")
LIBS = ("-ljpeg", "-lpthread")

_INT_P = ctypes.POINTER(ctypes.c_int)
_F32_P = ctypes.POINTER(ctypes.c_float)
_U8_P = ctypes.POINTER(ctypes.c_uint8)
_STR_P = ctypes.POINTER(ctypes.c_char_p)
_I, _L = ctypes.c_int, ctypes.c_long

# C entry -> argument types (csrc/rubiks_loader.cpp, extern "C").
_SIGNATURES = {
    "rl_load_frames": [_STR_P, _I, _I, _INT_P, _INT_P, _I, _I, _F32_P,
                       _F32_P, _F32_P, _L, _I],
    "rl_load_frames_mc": [_STR_P, _I, _I, _INT_P, _INT_P, _I, _I, _I,
                          _F32_P, _F32_P, _F32_P, _L, _L, _I],
    "rl_load_frames_u8": [_STR_P, _I, _I, _INT_P, _INT_P, _I, _I, _U8_P, _L,
                          _I],
    "rl_load_frames_mc_u8": [_STR_P, _I, _I, _INT_P, _INT_P, _I, _I, _I,
                             _U8_P, _L, _L, _I],
    "rl_decode_frame_u8": [ctypes.c_char_p, _I, _I, _I, _I, _I, _U8_P],
}


def _find_cxx() -> Optional[str]:
    return shutil.which("g++")


def toolchain_present() -> bool:
    """Whether this machine has g++, libjpeg's header and libjpeg itself:
    the probe that decides for a loader before any build is tried."""
    cxx = _find_cxx()
    if cxx is None or ctypes.util.find_library("jpeg") is None:
        return False
    proc = subprocess.run(
        [cxx, "-E", "-x", "c++", "-"],
        input="#include <cstdio>\n#include <jpeglib.h>\n",
        capture_output=True, text=True)
    return proc.returncode == 0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source and flags digest, ``ops/_build.py``) and load
    the loader library; raises RuntimeError where g++ or libjpeg is missing
    or the build fails."""
    cxx = _find_cxx()
    if cxx is None:
        raise RuntimeError(
            "g++ not found: the native frame loader cannot be built")
    lib, _ = _build.build_library("rubiks_loader", cxx, [SOURCE],
                                  flags=CXX_FLAGS, link_flags=LIBS)
    return _build.bind(lib, _SIGNATURES)


@functools.lru_cache(maxsize=None)
def available() -> bool:
    """Whether the loader builds and loads on this machine."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _origins(crop_offsets, count: int, what: str):
    """(x, y) int32 arrays of ``count`` crop origins; None = centered."""
    if crop_offsets is None:
        return np.full(count, -1, np.int32), np.full(count, -1, np.int32)
    if len(crop_offsets) != count:
        raise ValueError(f"{len(crop_offsets)} crop offsets for {count} "
                         f"{what}")
    return (np.asarray([o[0] for o in crop_offsets], np.int32),
            np.asarray([o[1] for o in crop_offsets], np.int32))


def _load(paths, scale_size, crop_size, crop_offsets, multicrop, norm,
          num_threads):
    """One call of a batch entry. ``multicrop``: the offsets are per crop
    and each frame is decoded once for all of them (crop-major output);
    otherwise one offset per frame. ``norm``: (mean, std) for float32
    output, None for raw uint8."""
    lib = load_library()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    if multicrop:
        xs, ys = _origins(crop_offsets, len(crop_offsets), "crops")
    else:
        xs, ys = _origins(crop_offsets, n, "frames")
    views = len(xs) if multicrop else 1
    out = np.empty((views * n, crop_size, crop_size, 3),
                   np.uint8 if norm is None else np.float32)
    stride = crop_size * crop_size * 3
    threads = num_threads if num_threads is not None else (os.cpu_count() or 1)
    args = [c_paths, n, scale_size, _ptr(xs, ctypes.c_int),
            _ptr(ys, ctypes.c_int)]
    if multicrop:
        args.append(views)
    args += [crop_size, crop_size]
    if norm is None:
        args.append(_ptr(out, ctypes.c_uint8))
    else:
        mean = np.asarray(norm[0], np.float32)
        std = np.asarray(norm[1], np.float32)
        args += [_ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float),
                 _ptr(out, ctypes.c_float)]
    args.append(stride)
    if multicrop:
        args.append(n * stride)
    args.append(threads)
    name = ("rl_load_frames" + ("_mc" if multicrop else "")
            + ("_u8" if norm is None else ""))
    failures = getattr(lib, name)(*args)
    if failures:
        raise IOError(f"native loader failed on {failures}/{views * n} "
                      f"frame-crops")
    return out


def load_frames(
    paths: Sequence[str],
    scale_size: int,
    crop_size: int,
    mean: Sequence[float],
    std: Sequence[float],
    crop_offsets: Optional[Sequence[tuple]] = None,
    num_threads: Optional[int] = None,
) -> np.ndarray:
    """Decode + resize + crop + normalize a list of frames in parallel.

    Args:
      paths: JPEG file paths (one per output frame).
      scale_size: shorter-side resize target (0 = no resize).
      crop_size: square crop size.
      crop_offsets: per-frame (x, y) crop origins; None = center crop.
    Returns:
      (len(paths), crop_size, crop_size, 3) float32,
      ``((v / 255) - mean) / std``.
    """
    return _load(paths, scale_size, crop_size, crop_offsets, False,
                 (mean, std), num_threads)


def load_frames_multicrop(
    paths: Sequence[str],
    scale_size: int,
    crop_size: int,
    mean: Sequence[float],
    std: Sequence[float],
    crop_offsets: Sequence[tuple],
    num_threads: Optional[int] = None,
) -> np.ndarray:
    """Decode each frame once and emit several crops of it (the 3 crops of
    GroupFullResSample). ``crop_offsets``: (x, y) origins shared by all
    frames, one per crop. Returns (len(crop_offsets) * len(paths), crop,
    crop, 3) float32, crop-major (crop 0's frames, then crop 1's, ...), the
    PIL pipeline's view order."""
    return _load(paths, scale_size, crop_size, crop_offsets, True,
                 (mean, std), num_threads)


def load_frames_u8(
    paths: Sequence[str],
    scale_size: int,
    crop_size: int,
    crop_offsets: Optional[Sequence[tuple]] = None,
    num_threads: Optional[int] = None,
) -> np.ndarray:
    """:func:`load_frames` to raw uint8, normalization left to the device
    (4x fewer host->device bytes than float32). Returns (len(paths),
    crop_size, crop_size, 3) uint8."""
    return _load(paths, scale_size, crop_size, crop_offsets, False, None,
                 num_threads)


def load_frames_multicrop_u8(
    paths: Sequence[str],
    scale_size: int,
    crop_size: int,
    crop_offsets: Sequence[tuple],
    num_threads: Optional[int] = None,
) -> np.ndarray:
    """:func:`load_frames_multicrop` to raw uint8, crop-major."""
    return _load(paths, scale_size, crop_size, crop_offsets, True, None,
                 num_threads)


def decode_frame_u8(
    path: str, scale_size: int, crop_size: int, crop_x: int = -1,
    crop_y: int = -1
) -> np.ndarray:
    """Single-frame decode + resize + crop to uint8 (for parity tests)."""
    lib = load_library()
    out = np.empty((crop_size, crop_size, 3), np.uint8)
    rc = lib.rl_decode_frame_u8(os.fsencode(path), scale_size, crop_x,
                                crop_y, crop_size, crop_size,
                                _ptr(out, ctypes.c_uint8))
    if rc:
        raise IOError(f"failed to decode {path}")
    return out
