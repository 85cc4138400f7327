"""Shift ops and fused block kernels of the PyTorch port."""

from .fused_block import fused_block_run, stack_block_params
from .fused_entry import fused_entry_run, stack_entry_params
from .shift3d import rubiks_shift_3d_forward, shift_tap_weights

__all__ = [
    "fused_block_run",
    "fused_entry_run",
    "rubiks_shift_3d_forward",
    "shift_tap_weights",
    "stack_block_params",
    "stack_entry_params",
    "launch_counters",
]


def launch_counters():
    """The launch counters of K1 (shift3d), K2 (fused_block) and K3
    (fused_entry), by name."""
    from . import fused_block, fused_entry, shift3d

    return {c.name: c for c in (shift3d.LAUNCHES, fused_block.LAUNCHES,
                                fused_entry.LAUNCHES)}
