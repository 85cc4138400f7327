"""The serving kernels as PyTorch operators, namespace ``rubiksnet``.

Each operator is defined in a ``torch.library.Library`` with a schema, so
the tracer of ``torch.export`` keeps it as one opaque node and an exported
program calls the kernel at run time instead of the plain version's aten
ops. Its implementations sit on the dispatcher's own keys, so an eager
call pays one dispatch and no Python layer around it:

* CUDA: the kernel wrapper and nothing else (it launches the kernel or
  raises; its launch plan is decided there, from the real tensor, so a
  program exported at a symbolic batch launches at each batch the plan
  that eager code launches at that batch). The wrapper counts the launch;
* CPU: the kernel's plain version;
* fake (tracing, and the meta device): the output's shape and dtype, from
  symbolic sizes; raises for a meta tensor, which has no kernel;
* any other device: the dispatcher finds no kernel and raises.

No autograd kernel: the operators are forwards. Training reaches the
shift operators from the autograd Functions of ``shift3d.py`` and
``shift2d.py``, whose backward runs the gradient kernels.

| operator | kernel on the card | CPU |
| --- | --- | --- |
| ``fused_block_run`` | K2 ``fused_block.py::fused_block_kernel`` | ``fused_block_plain`` |
| ``fused_entry_run`` | K3 ``fused_entry.py::fused_entry_kernel`` (``aq``: K3-AQ) | ``fused_entry_plain`` |
| ``shift3d_forward`` | K1 ``shift3d.py::shift3d_kernel`` (staged) | ``shift3d_plain`` |
| ``shift2d_forward`` | ``shift2d.py::shift2d_kernel`` | ``shift2d_plain`` |
| ``stem_conv`` | ``stem.py::stem_conv_kernel`` | ``stem_conv_plain`` |

The names go into saved programs, so they say what the operator computes
and stay fixed when the Python functions behind them are renamed.
Registered when ``rubiksnet_torch.ops`` is imported; nothing is compiled
then (the kernel library builds at the first CUDA call).
"""

from __future__ import annotations

import torch

from . import fused_block, fused_entry, shift2d, shift3d, stem

NAMESPACE = "rubiksnet"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def _check_device(name, x):
    """The fake implementations' check: a fake tensor carries the device it
    stands for, so tracing for CUDA or the CPU passes, and a meta tensor,
    which has no kernel, raises like any other device."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{NAMESPACE}::{name}: unsupported device "
                         f"{x.device} (CUDA or the CPU)")


def _define(schema, cuda, cpu, fake):
    """Define ``rubiksnet::<schema>`` with its CUDA, CPU and fake
    implementations; returns the operator (its default overload)."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")

    def checked_fake(x, *args):
        _check_device(name, x)
        return fake(x, *args)

    torch.library.register_fake(f"{NAMESPACE}::{name}", checked_fake,
                                lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


# K2: a run of stride-1 fused blocks (ops/fused_block.py).


def _block_cpu(x, vt, wm, se, aq, max_shift):
    fused_block._check_args(x, vt, wm, se, aq, max_shift)
    if vt.shape[0] == 0:  # an operator returns no alias of its input
        return x.clone()
    return fused_block.fused_block_plain(x, vt, wm, se, aq=aq,
                                         max_shift=max_shift)


fused_block_run = _define(
    "fused_block_run(Tensor x, Tensor vt, Tensor wm, Tensor? se, bool aq, "
    "int max_shift) -> Tensor",
    lambda x, vt, wm, se, aq, max_shift: fused_block.fused_block_kernel(
        x, vt, wm, se, aq=aq, max_shift=max_shift),
    _block_cpu,
    lambda x, vt, wm, se, aq, max_shift: torch.empty_like(x))


# K3: a stride-2 fused entry block (ops/fused_entry.py).


def _entry_cpu(x, vt1, vt2, w2, w3, wsc, se, max_shift, aq=False):
    params = (vt1, vt2, w2, w3, wsc)
    fused_entry._check_args(x, params, se, max_shift, aq)
    return fused_entry.fused_entry_plain(x, params, se, max_shift=max_shift,
                                         aq=aq)


def _entry_fake(x, vt1, vt2, w2, w3, wsc, se, max_shift, aq=False):
    n, t, h, w, _ = x.shape
    return x.new_empty((n, t, h // 2, w // 2, w2.shape[1]))


# ``aq`` (the attention mix) came after the first programs were saved: its
# default keeps them loadable. The dispatcher leaves a trailing argument that
# equals its default out of the call, so the implementations default it too.
fused_entry_run = _define(
    "fused_entry_run(Tensor x, Tensor vt1, Tensor vt2, Tensor w2, "
    "Tensor w3, Tensor wsc, Tensor? se, int max_shift, bool aq=False) "
    "-> Tensor",
    lambda x, vt1, vt2, w2, w3, wsc, se, max_shift, aq=False:
        fused_entry.fused_entry_kernel(x, (vt1, vt2, w2, w3, wsc), se,
                                       max_shift=max_shift, aq=aq),
    _entry_cpu,
    _entry_fake)


# K1: the 3D shift's forward (ops/shift3d.py).


shift3d_forward = _define(
    "shift3d_forward(Tensor x, Tensor shift, int[] stride, int[] padding, "
    "bool quantize) -> Tensor",
    lambda x, shift, stride, padding, quantize: shift3d.shift3d_kernel(
        x.contiguous(), shift, tuple(stride), tuple(padding), quantize),
    lambda x, shift, stride, padding, quantize: shift3d.shift3d_plain(
        x, shift, tuple(stride), tuple(padding), quantize),
    lambda x, shift, stride, padding, quantize: x.new_empty(
        shift3d.compute_output_shape_3d(x.shape, stride, padding)))


# The 2D shift's forward (ops/shift2d.py).


shift2d_forward = _define(
    "shift2d_forward(Tensor x, Tensor shift, int[] stride, int[] padding, "
    "bool quantize) -> Tensor",
    lambda x, shift, stride, padding, quantize: shift2d.shift2d_kernel(
        x.contiguous(), shift, tuple(stride), tuple(padding), quantize),
    lambda x, shift, stride, padding, quantize: shift2d.shift2d_plain(
        x, shift, tuple(stride), tuple(padding), quantize),
    lambda x, shift, stride, padding, quantize: x.new_empty(
        shift2d.compute_output_shape_2d(x.shape, stride, padding)))


# The serving stem, the 3x3 stride-2 conv of the frames (ops/stem.py).


def _stem_cpu(x, w):
    stem._check_args(x, w)
    return stem.stem_conv_plain(x, w)


stem_conv = _define(
    "stem_conv(Tensor x, Tensor w) -> Tensor",
    lambda x, w: stem.stem_conv_kernel(x.contiguous(), w.contiguous()),
    _stem_cpu,
    lambda x, w: x.new_empty(stem.stem_output_shape(x.shape, w.shape[1])))
