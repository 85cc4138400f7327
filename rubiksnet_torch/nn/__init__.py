"""Layers and backbone of the PyTorch port."""

from .backbone import BN, RubiksNetBackbone, RubiksShiftBlock
from .layers import Rubiks3DWrap, RubiksShift3D, uniform_shift_init

__all__ = [
    "BN",
    "Rubiks3DWrap",
    "RubiksNetBackbone",
    "RubiksShift3D",
    "RubiksShiftBlock",
    "uniform_shift_init",
]
