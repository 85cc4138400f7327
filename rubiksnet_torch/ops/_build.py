"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``), one
process per file, all in parallel, and linked into one shared library with a
plain C interface, cached under
``rubiksnet_torch/build/`` by a hash of the sources and flags, and loaded with
``ctypes``. Nothing is compiled at import time: the first kernel launch
builds. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

PTR = ctypes.c_void_p
INT = ctypes.c_int


class LaunchCounter:
    """How many times a kernel wrapper launched its kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


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


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources, lib_path: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in sources]
    try:
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for s, o in zip(sources, objs)]
        failed = []
        for s, p in zip(sources, procs):
            out, err = p.communicate()
            if p.returncode != 0:
                failed.append(f"{s.name} ({p.returncode}):\n{out}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
                f"{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib_path = BUILD_DIR / f"librubiks_{_digest(sources + headers)}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _compile(_find_nvcc(), sources, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.rubiks_error_string.argtypes = [INT]
    lib.rubiks_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def kernel_function(name: str, *argtypes):
    """The C entry point ``name`` of the kernel library, typed."""
    fn = getattr(load_library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = INT
    return fn


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
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
