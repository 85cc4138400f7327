"""Weights across frameworks.

:func:`state_dict_from_jax` turns the JAX package's variables (nested dicts
of arrays, ``params`` and ``batch_stats``) into this package's state dict,
with the reference's torch key names and layouts: the same rules as
``rubiksnet_tpu/models/pretrained.py::export_torch_state_dict``.
:func:`save_pretrained` and :func:`load_pretrained` write and read the
reference's ``.pth.tar`` format, ``{tier, num_classes, num_frames, variant,
model: state_dict}``.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import gather_params
from .rubiksnet import RubiksNet, resolve_device


def _torch_name(name: str) -> str:
    # flax module layerS_B -> torch ModuleList path layerS.B
    if name.startswith("layer") and "_" in name:
        stage, block = name.split("_", 1)
        return f"{stage}.{block}"
    return name


def state_dict_from_jax(params, batch_stats=None):
    """JAX variables -> state dict of float32 CPU tensors.

    Conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in), BN
    scale -> weight, running statistics -> running_mean / running_var (plus
    num_batches_tracked = 0), shifts as they are. A rubiks3d-aq block (one
    with an ``aq_shift`` child) is the reference's Sequential: the attention
    weight becomes ``conv2.0.weight`` and the 1x1 conv ``conv2.1.weight``;
    with ``batch_stats`` the fixed temperature buffer ``conv2.0.T`` = 2 comes
    along. SE weights become ``se.fc.0.weight`` and ``se.fc.2.weight``. Any
    tree shaped like
    ``params`` maps the same way: with ``batch_stats`` None, a JAX gradient
    or momentum tree becomes ``{parameter name: tensor}`` in the layout of
    the port's ``param.grad`` and SGD momentum buffers.
    """
    out = {}

    se_names = {"fc1": "fc.0", "fc2": "fc.2"}

    def emit(tree, prefix):
        aq = "aq_shift" in tree
        for name, v in tree.items():
            if isinstance(v, Mapping):
                if name == "aq_shift":
                    out[prefix + "conv2.0.weight"] = np.asarray(v["weight"])
                    if batch_stats is not None:
                        out[prefix + "conv2.0.T"] = np.asarray(2.0,
                                                               np.float32)
                elif name == "conv2" and aq:
                    emit(v, prefix + "conv2.1.")
                elif prefix.endswith("se."):
                    emit(v, prefix + se_names[name] + ".")
                else:
                    emit(v, prefix + _torch_name(name) + ".")
                continue
            arr = np.asarray(v)
            if name == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
                out[prefix + "weight"] = arr
            elif name == "scale":
                out[prefix + "weight"] = arr
            elif name in ("bias", "shift"):
                out[prefix + name] = arr
            else:
                raise ValueError(f"unexpected leaf {prefix}{name}")

    def emit_stats(tree, prefix):
        for name, v in tree.items():
            if isinstance(v, Mapping):
                emit_stats(v, prefix + _torch_name(name) + ".")
            elif name == "mean":
                out[prefix + "running_mean"] = np.asarray(v)
            elif name == "var":
                out[prefix + "running_var"] = np.asarray(v)
                out[prefix + "num_batches_tracked"] = np.asarray(0, np.int64)
            else:
                raise ValueError(f"unexpected statistic {prefix}{name}")

    emit(params, "")
    emit_stats(batch_stats or {}, "")
    return {k: torch.from_numpy(np.array(v, dtype=np.int64 if v.dtype ==
                                          np.int64 else np.float32))
            for k, v in out.items()}


def max_int_shift(state_dict) -> int:
    """Smallest bound K >= 1 with floor(|s|) < K for every shift parameter:
    the max_shift to build a model with for these weights."""
    bound = 1
    for key, value in state_dict.items():
        if key.endswith(".shift"):
            m = float(torch.as_tensor(value).abs().max())
            bound = max(bound, math.floor(m) + 1)
    return bound


def save_pretrained(model: RubiksNet, path, model_group=None) -> None:
    """Write ``model`` as a reference-format checkpoint (``.pth.tar``):
    ``{tier, num_classes, num_frames, variant, model: state_dict}`` with
    float32 CPU tensors. In a process group only the world's first rank
    writes. A model sharded over ``model_group`` is written whole: every
    rank of the group calls this alike, and the state is gathered over it
    (``parallel.gather_params``)."""
    state = gather_params(model, model_group)
    if dist.is_initialized() and dist.get_rank():
        return
    torch.save({
        "tier": model.tier,
        "num_classes": model.num_classes,
        "num_frames": model.num_frames,
        "variant": model.variant,
        "model": {k: v.detach().cpu() for k, v in state.items()},
    }, path)


def load_pretrained(path, device=None, dtype=torch.float32):
    """A RubiksNet in eval mode from a reference-format checkpoint.

    ``max_shift`` is sized from the checkpoint's shifts
    (:func:`max_int_shift`). ``device=None`` is the CUDA card and raises
    where there is none. The checkpoint must hold every parameter and
    statistic of the model and nothing else, apart from the attention
    shift's constant temperature (``conv2.0.T``), which is ignored.
    """
    device = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = {k: torch.as_tensor(v) for k, v in ckpt["model"].items()
             if not k.endswith("conv2.0.T")}
    model = RubiksNet(ckpt["tier"], int(ckpt["num_classes"]),
                      int(ckpt["num_frames"]), ckpt["variant"],
                      max_shift=max_int_shift(state), dtype=dtype)
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("conv2.0.T")]
    if missing or unexpected:
        raise ValueError(f"checkpoint does not fit the model: missing "
                         f"{missing[:8]}, unexpected {unexpected[:8]}")
    return model.to(device).eval()
