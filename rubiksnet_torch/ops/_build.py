"""Build and load the port's native libraries.

One builder, :func:`build_library`, makes all three: the CUDA kernels
(every ``csrc/*.cu``, :func:`load_library`), the device loader
(``data/csrc/device_loader.cu`` with nvjpeg, ``data/device_loader.py``) and
the native frame loader (``data/csrc/rubiks_loader.cpp`` with g++,
``data/native_loader.py``). Each source is compiled by its own process, all
in parallel, and the objects are linked into one shared library with a
plain C interface, cached under ``rubiksnet_torch/build/`` by a digest of
the flags and of every source and header, and loaded with ``ctypes``.
Nothing is compiled at import time: the first use builds. A missing
compiler or a failed build raises, and the failure is not cached.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils.profiling import setup_span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

PTR = ctypes.c_void_p
INT = ctypes.c_int


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or CUDA_HOME): the CUDA kernels of "
            "rubiksnet_torch cannot be built")
    return nvcc


def _compile(compiler: str, sources, flags, link_flags,
             lib_path: Path) -> None:
    """One compiler process per source, all started together, then one
    link into a temporary file beside ``lib_path``, renamed onto it. Every
    object and the temporary file are removed whatever happens."""
    tag = f"{lib_path.name}.{os.getpid()}"
    objs = [lib_path.with_name(f"{tag}.{s.stem}.o") for s in sources]
    tmp = lib_path.with_name(f"{tag}.tmp")
    try:
        procs = [subprocess.Popen(
            [compiler, *flags, "-c", "-o", str(o), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for s, o in zip(sources, objs)]
        failed = []
        for s, p in zip(sources, procs):
            out, err = p.communicate()
            if p.returncode != 0:
                failed.append(f"{s.name} ({p.returncode}):\n{out}\n{err}")
        if failed:
            raise RuntimeError(f"building {lib_path.name} failed: "
                               + "\n".join(failed))
        proc = subprocess.run(
            [compiler, "-shared", "-o", str(tmp), *map(str, objs),
             *link_flags], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"linking {lib_path.name} failed ({proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)


@functools.lru_cache(maxsize=None)
def _open(lib_path: Path) -> ctypes.CDLL:
    try:
        return ctypes.CDLL(str(lib_path))
    except OSError as e:
        raise RuntimeError(f"loading {lib_path} failed: {e}") from e


def build_library(name: str, compiler: str, sources, headers=(), flags=(),
                  link_flags=()) -> tuple[ctypes.CDLL, bool]:
    """The shared library ``lib<name>`` of ``sources``, compiled by
    ``compiler`` (its path) with ``flags`` and linked with ``link_flags``:
    kept in ``BUILD_DIR`` under a digest of both flag lists and of every
    source's and header's name and bytes, built where that file is missing
    and opened once per digest. -> (library, whether the compiler ran).
    Raises RuntimeError with the compiler's output where a build fails,
    leaving nothing in ``BUILD_DIR``."""
    flags, link_flags = tuple(flags), tuple(link_flags)
    h = hashlib.sha256(" ".join(flags + ("--",) + link_flags).encode())
    for path in (*sources, *headers):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    lib_path = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    built = not lib_path.exists()
    if built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _compile(compiler, sources, flags, link_flags, lib_path)
    return _open(lib_path), built


def bind(lib: ctypes.CDLL, signatures, restype=INT) -> ctypes.CDLL:
    """Type ``lib``'s C entry points: ``signatures`` maps each name to its
    argument types, and every one of them returns ``restype``."""
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library, inside
    the span ``rubiksnet.setup.library`` (attribute ``built``: nvcc ran)."""
    with setup_span("rubiksnet.setup.library", built=False) as rec:
        lib, rec.attrs["built"] = build_library(
            "rubiks", _find_nvcc(), sorted(CSRC.glob("*.cu")),
            sorted(CSRC.glob("*.cuh")), NVCC_FLAGS)
        return bind(lib, {"rubiks_error_string": [INT]}, ctypes.c_char_p)


@functools.lru_cache(maxsize=None)
def kernel_function(name: str, *argtypes):
    """The C entry point ``name`` of the kernel library, typed."""
    return getattr(bind(load_library(), {name: argtypes}), name)


def check(code: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = load_library().rubiks_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def dtype_code(dtype) -> int:
    """The kernels' dtype argument: 0 float32, 1 bfloat16."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def stream_of(tensor) -> int:
    """The raw handle of PyTorch's current stream on the tensor's device."""
    import torch

    return torch._C._cuda_getCurrentRawStream(tensor.device.index)
