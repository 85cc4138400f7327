"""The port's one native builder (``rubiksnet_torch/ops/_build.py``), through
each of the three libraries it makes: the CUDA kernels, the device loader
and the native frame loader.

The compilers are a fake script in ``tmp_path`` that logs its arguments and
writes its ``-o`` file (or fails while a ``fail`` file lies beside it), and
``ctypes.CDLL`` is a fake that counts what it opens, so the cache key, the
temporary-file rule and the loading rule are held on the CPU.
"""

from __future__ import annotations

import ctypes
import shutil
import sys
import types

import pytest

from rubiksnet_torch.data import device_loader, native_loader
from rubiksnet_torch.ops import _build

FAKE_COMPILER = """#!{python}
import pathlib, sys
here = pathlib.Path(__file__).parent
with open(here / "calls.log", "a") as log:
    log.write(" ".join(sys.argv[1:]) + "\\n")
if (here / "fail").exists():
    sys.stderr.write("fake compiler error\\n")
    sys.exit(1)
pathlib.Path(sys.argv[sys.argv.index("-o") + 1]).write_bytes(b"object")
"""


class FakeCDLL:
    opened = []

    def __init__(self, path):
        FakeCDLL.opened.append(path)
        self._path = path

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def _kernels(monkeypatch, src, compiler):
    monkeypatch.setattr(_build, "CSRC", src.parent)
    monkeypatch.setattr(_build, "_find_nvcc", lambda: compiler)
    return _build.load_library, "NVCC_FLAGS", _build, "nvcc not found"


def _device_loader(monkeypatch, src, compiler):
    header = src.parent / "nvjpeg.h"
    header.write_text("// nvjpeg\n")
    monkeypatch.setattr(device_loader, "SOURCE", src)
    monkeypatch.setattr(_build, "_find_nvcc", lambda: compiler)
    monkeypatch.setattr(device_loader, "nvjpeg_files",
                        lambda: {"headers": [str(header)], "libraries": []})
    monkeypatch.setattr(device_loader, "_nvjpeg_library", lambda files: None)
    return (device_loader.load_library, "LOADER_FLAGS", device_loader,
            "nvcc not found")


def _native_loader(monkeypatch, src, compiler):
    monkeypatch.setattr(native_loader, "SOURCE", src)
    monkeypatch.setattr(native_loader, "_find_cxx", lambda: compiler)
    return (native_loader.load_library, "CXX_FLAGS", native_loader,
            "g\\+\\+ not found")


LIBRARIES = {"kernels": (_kernels, "k.cu"),
             "device_loader": (_device_loader, "device_loader.cu"),
             "native_loader": (_native_loader, "rubiks_loader.cpp")}


@pytest.mark.parametrize("check", ["digest", "failure", "no_compiler",
                                   "load_once"])
@pytest.mark.parametrize("library", sorted(LIBRARIES))
def test_the_one_builder(library, check, monkeypatch, tmp_path):
    setup, name = LIBRARIES[library]
    src_dir = tmp_path / "src"
    src_dir.mkdir()
    src = src_dir / name
    src.write_text("int entry() { return 0; }\n")
    (src_dir / "k.cuh").write_text("// a header\n")
    compiler = tmp_path / "cc"
    compiler.write_text(FAKE_COMPILER.format(python=sys.executable))
    compiler.chmod(0o755)
    build = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(ctypes, "CDLL", FakeCDLL)
    FakeCDLL.opened = []
    load, flags_name, flags_module, missing = setup(monkeypatch, src,
                                                    str(compiler))
    log = tmp_path / "calls.log"

    def links():
        text = log.read_text() if log.exists() else ""
        return [ln for ln in text.splitlines() if ln.startswith("-shared")]

    def fresh_load():
        load.cache_clear()
        return load()

    try:
        if check == "digest":
            fresh_load()
            first = set(build.glob("*.so"))
            src.write_bytes(src.read_bytes().replace(b"0", b"1"))
            fresh_load()
            second = set(build.glob("*.so"))
            monkeypatch.setattr(flags_module, flags_name,
                                getattr(flags_module, flags_name) + ("-DX",))
            fresh_load()
            third = set(build.glob("*.so"))
            assert len(first) == 1 and first < second < third
            assert len(third) == 3 and len(links()) == 3
            assert set(build.iterdir()) == third  # no object or temporary
        elif check == "failure":
            (tmp_path / "fail").write_text("")
            with pytest.raises(RuntimeError, match="fake compiler error"):
                fresh_load()
            assert not list(build.iterdir())
            (tmp_path / "fail").unlink()
            calls = len(log.read_text().splitlines())
            load()  # the failure was not cached
            assert len(log.read_text().splitlines()) > calls
            assert len(links()) == 1 and len(list(build.iterdir())) == 1
        elif check == "no_compiler":
            monkeypatch.undo()
            monkeypatch.setattr(_build, "BUILD_DIR", build)
            monkeypatch.setattr(shutil, "which", lambda *a, **k: None)
            monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
            load.cache_clear()
            with pytest.raises(RuntimeError, match=missing):
                load()
            assert not build.exists() or not list(build.iterdir())
        else:
            lib = fresh_load()
            assert fresh_load() is lib
            assert len(links()) == 1 and len(FakeCDLL.opened) == 1
    finally:
        load.cache_clear()


def _entries(library):
    """The C entry points the library's Python side binds by name."""
    from rubiksnet_torch.ops import bn_relu, shift2d, shift3d

    if library == "kernels":
        return ({"rubiks_error_string", "rubiks_fused_block_run",
                 "rubiks_fused_entry", *shift2d._ENTRIES, *bn_relu._ENTRIES}
                | {name for name, _ in shift3d._ENTRIES.values()})
    return {*device_loader._SIGNATURES, "rdl_destroy", "rdl_error_string"}


@pytest.mark.parametrize("library", ["kernels", "device_loader"])
def test_every_bound_entry_point_is_defined(library):
    """Each C entry point the wrappers bind is defined in the library's
    sources, whatever file it lives in (a deleted source must not take one
    that others use with it); nvcc is not here, so by the text."""
    import re

    sources = (sorted(_build.CSRC.glob("*.cu")) if library == "kernels"
               else [device_loader.SOURCE])
    text = "\n".join(p.read_text() for p in sources)
    for name in sorted(_entries(library)):
        assert re.search(rf"^(int|void|const char\*) {name}\(", text,
                         re.MULTILINE), name
