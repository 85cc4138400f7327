"""Model, weights and the fused inference executor of the PyTorch port."""

from .fused_infer import FusedExecutor, fused_infer_apply
from .pretrained import max_int_shift, state_dict_from_jax
from .rubiksnet import TIERS, RubiksNet, create_rubiksnet, from_ntchw

__all__ = [
    "FusedExecutor",
    "RubiksNet",
    "TIERS",
    "create_rubiksnet",
    "from_ntchw",
    "fused_infer_apply",
    "max_int_shift",
    "state_dict_from_jax",
]
