"""Layers and backbone of the PyTorch port."""

from .backbone import BN, RubiksNetBackbone, RubiksShiftBlock
from .layers import (
    AttentionShift,
    Rubiks3DWrap,
    RubiksShift2D,
    RubiksShift3D,
    SELayer,
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
    "uniform_shift_init",
]
