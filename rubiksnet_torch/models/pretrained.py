"""Weights across frameworks.

:func:`state_dict_from_jax` turns the JAX package's variables (nested dicts
of arrays, ``params`` and ``batch_stats``) into this package's state dict,
with the reference's torch key names and layouts: the same rules as
``rubiksnet_tpu/models/pretrained.py::export_torch_state_dict``.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch


def _torch_name(name: str) -> str:
    # flax module layerS_B -> torch ModuleList path layerS.B
    if name.startswith("layer") and "_" in name:
        stage, block = name.split("_", 1)
        return f"{stage}.{block}"
    return name


def state_dict_from_jax(params, batch_stats):
    """JAX variables -> state dict of float32 CPU tensors.

    Conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in), BN
    scale -> weight, running statistics -> running_mean / running_var (plus
    num_batches_tracked = 0), shifts as they are.
    """
    out = {}

    def emit(tree, prefix):
        for name, v in tree.items():
            if isinstance(v, Mapping):
                if name in ("aq_shift", "se"):
                    raise NotImplementedError(
                        f"{prefix}{name}: AQ and SE weights are not ported "
                        "yet (ROADMAP)")
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
    emit_stats(batch_stats, "")
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
