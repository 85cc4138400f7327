"""Port's attention shift (rubiksnet_torch.ops.attention_shift, the AQ
temporal op) against rubiksnet_tpu.ops.attention_shift: the normalized tap
weights and the 3-tap mix along T, and the layer.

Tolerance: float32 rtol/atol 1e-6 (the same arithmetic; softmax and the
standard deviation sum in another order); float64 at 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rubiksnet_torch.nn.layers import AttentionShift
from rubiksnet_torch.ops import attention_shift as tas
from rubiksnet_tpu.ops.attention_shift import attention_shift as jax_op
from rubiksnet_tpu.ops.attention_shift import (
    attention_shift_weights as jax_weights,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("float64", 1e-12)])
def test_weights_match_jax(dtype, tol):
    w = np.random.default_rng(0).uniform(0, 1, (24, 3)).astype(dtype)
    got = tas.attention_shift_weights(torch.from_numpy(w))
    want = jax_weights(jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("frames", [1, 2, 5])
def test_op_matches_jax(frames):
    """Boundary frames read zeros; one frame keeps only the centre tap."""
    rng = np.random.default_rng(frames)
    x = rng.standard_normal((2, frames, 3, 4, 10)).astype(np.float32)
    w = rng.uniform(0, 1, (10, 3)).astype(np.float32)
    got = tas.attention_shift(torch.from_numpy(x), torch.from_numpy(w))
    want = jax_op(jnp.asarray(x), jnp.asarray(w))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_layer_initializes_in_unit_interval_and_differentiates():
    layer = AttentionShift(16, generator=torch.Generator().manual_seed(0))
    w = layer.weight.detach()
    assert w.shape == (16, 3) and 0.0 <= float(w.min()) and float(w.max()) < 1
    assert float(layer.T) == 2.0 and "T" in layer.state_dict()
    assert [n for n, _ in layer.named_parameters()] == ["weight"]
    x = torch.randn(1, 4, 2, 2, 16, requires_grad=True)
    layer(x).square().sum().backward()
    assert layer.weight.grad is not None and x.grad is not None
    clip0 = layer(x)[:, 0]
    taps = tas.attention_shift_weights(w)
    want = taps[:, 1] * x[:, 0] + taps[:, 2] * x[:, 1]
    np.testing.assert_allclose(clip0.detach().numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
