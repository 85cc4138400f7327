"""RubiksNet in PyTorch, with hand-written CUDA kernels for Hopper.

The port of the JAX package ``rubiksnet_tpu`` (the reference it is tested
against). Same layout: channel-last (N, T, H, W, C) activations, (3, C)
shift parameters, and the reference's torch parameter names. Imports torch
only; kernels are built at their first launch (ops/_build.py).
"""

from .models.fused_infer import FusedExecutor, fused_infer_apply
from .models.rubiksnet import RubiksNet, create_rubiksnet, from_ntchw

__all__ = [
    "FusedExecutor",
    "RubiksNet",
    "create_rubiksnet",
    "from_ntchw",
    "fused_infer_apply",
]
