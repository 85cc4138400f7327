"""Layers and backbone of the PyTorch port."""

from .backbone import BN, RubiksNetBackbone, RubiksShiftBlock
from .layers import (
    AttentionShift,
    Rubiks3DWrap,
    RubiksShift2D,
    RubiksShift3D,
    SELayer,
    create_3d_from_2d,
    group_shift_init,
    init_shift1d_nfold,
    uniform_shift_init,
)

__all__ = [
    "AttentionShift",
    "BN",
    "Rubiks3DWrap",
    "RubiksNetBackbone",
    "RubiksShift2D",
    "RubiksShift3D",
    "RubiksShiftBlock",
    "SELayer",
    "create_3d_from_2d",
    "group_shift_init",
    "init_shift1d_nfold",
    "uniform_shift_init",
]
