"""Shift ops and fused block kernels of the PyTorch port."""

from .attention_shift import attention_shift_weights
from .fused_block import (
    fused_block_run,
    stack_block_params,
    stack_block_params_aq,
    stack_se_params,
)
from .fused_entry import fused_entry_run, stack_entry_params
from .shift2d import (
    normalize_shift_grad_2d,
    rubiks_shift_2d,
    rubiks_shift_2d_forward,
)
from .shift3d import (
    normalize_shift_grad_3d,
    rubiks_shift_3d,
    rubiks_shift_3d_forward,
    shift_tap_weights,
)

__all__ = [
    "attention_shift_weights",
    "fused_block_run",
    "fused_entry_run",
    "normalize_shift_grad_2d",
    "normalize_shift_grad_3d",
    "rubiks_shift_2d",
    "rubiks_shift_2d_forward",
    "rubiks_shift_3d",
    "rubiks_shift_3d_forward",
    "shift_tap_weights",
    "stack_block_params",
    "stack_block_params_aq",
    "stack_entry_params",
    "stack_se_params",
    "launch_counters",
]


def launch_counters():
    """The launch counters of K1 (shift3d), K1-inverse (shift3d_inverse),
    K4 (shift_grad), K2 (fused_block), K3 (fused_entry) and K1 and
    K1-inverse in 2D mode (shift2d, shift2d_inverse), by name."""
    from . import fused_block, fused_entry, shift2d, shift3d

    return {c.name: c for c in (shift3d.LAUNCHES, shift3d.INVERSE_LAUNCHES,
                                shift3d.SHIFT_GRAD_LAUNCHES,
                                fused_block.LAUNCHES, fused_entry.LAUNCHES,
                                shift2d.LAUNCHES, shift2d.INVERSE_LAUNCHES)}
