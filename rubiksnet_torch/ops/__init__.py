"""Shift ops and fused block kernels of the PyTorch port."""

from . import library  # registers the rubiksnet:: operators
from .attention_shift import attention_shift, attention_shift_weights
from .bn_relu import bn_relu_train
from .fused_block import (
    fused_block_run,
    stack_block_params,
    stack_block_params_aq,
    stack_se_params,
)
from .fused_entry import (
    fused_entry_run,
    stack_entry_params,
    stack_entry_params_aq,
)
from .shift2d import (
    compute_output_shape_2d,
    normalize_shift_grad_2d,
    rubiks_shift_2d,
    rubiks_shift_2d_forward,
    rubiks_shift_2d_input_grad,
    rubiks_shift_2d_shift_grad,
)
from .shift3d import (
    compute_output_shape_3d,
    normalize_shift_grad_3d,
    rubiks_shift_3d,
    rubiks_shift_3d_forward,
    rubiks_shift_3d_input_grad,
    rubiks_shift_3d_shift_grad,
    shift_tap_weights,
)

__all__ = [
    "attention_shift",
    "attention_shift_weights",
    "bn_relu_train",
    "compute_output_shape_2d",
    "compute_output_shape_3d",
    "fused_block_run",
    "fused_entry_run",
    "normalize_shift_grad_2d",
    "normalize_shift_grad_3d",
    "rubiks_shift_2d",
    "rubiks_shift_2d_forward",
    "rubiks_shift_2d_input_grad",
    "rubiks_shift_2d_shift_grad",
    "rubiks_shift_3d",
    "rubiks_shift_3d_forward",
    "rubiks_shift_3d_input_grad",
    "rubiks_shift_3d_shift_grad",
    "shift_tap_weights",
    "stack_block_params",
    "stack_block_params_aq",
    "stack_entry_params",
    "stack_entry_params_aq",
    "stack_se_params",
    "launch_counters",
]


def launch_counters():
    """The launch counters of K1 (shift3d), K1-inverse (shift3d_inverse),
    K4 (shift_grad), K2 (fused_block; fused_block_ring: those of its
    launches that ran on two or more operand stages), K3 (fused_entry), K3
    with the attention mix (fused_entry_aq), the SE gate of their
    tensor-core route (se_gate) and the 2D shift's forward and
    input-gradient kernels (shift2d, shift2d_inverse), the train-mode BN
    and ReLU pair's forward and backward (bn_relu_train,
    bn_relu_train_backward) and the serving stem (stem_conv), by name: the
    registry's counters of these kernels (``utils.profiling.counters``)."""
    from . import bn_relu, fused_block, fused_entry, shift2d, shift3d, stem

    return {c.name: c for c in (shift3d.LAUNCHES, shift3d.INVERSE_LAUNCHES,
                                shift3d.SHIFT_GRAD_LAUNCHES,
                                fused_block.LAUNCHES,
                                fused_block.RING_LAUNCHES,
                                fused_entry.LAUNCHES,
                                fused_entry.AQ_LAUNCHES,
                                fused_block.SE_GATE_LAUNCHES,
                                shift2d.LAUNCHES, shift2d.INVERSE_LAUNCHES,
                                bn_relu.LAUNCHES, bn_relu.BACKWARD_LAUNCHES,
                                stem.LAUNCHES)}
