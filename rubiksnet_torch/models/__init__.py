"""Model, weights and the fused inference executor of the PyTorch port."""

from .fused_infer import FusedExecutor, fused_infer_apply
from .pretrained import (
    load_pretrained,
    max_int_shift,
    save_pretrained,
    state_dict_from_jax,
)
from .rubiksnet import (
    INPUT_MEAN,
    INPUT_SIZE,
    INPUT_STD,
    TIERS,
    RubiksNet,
    create_rubiksnet,
    from_ntchw,
)

__all__ = [
    "INPUT_MEAN",
    "INPUT_SIZE",
    "INPUT_STD",
    "FusedExecutor",
    "RubiksNet",
    "TIERS",
    "create_rubiksnet",
    "from_ntchw",
    "fused_infer_apply",
    "load_pretrained",
    "max_int_shift",
    "save_pretrained",
    "state_dict_from_jax",
]
