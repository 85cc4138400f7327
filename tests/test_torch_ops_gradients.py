"""The shift op's public gradients (``rubiksnet_torch.ops``) against the JAX
package's gather backend on the same numpy inputs, on the CPU, where the
port routes them to their plain forms; and the port's ``ops.__all__``
against JAX's.

Tolerance: float32, 1e-5 of the largest reference entry. Both sides
compute the same per-axis formulas in float32; the shift gradients sum
the same products in another order (a few hundred terms at these sizes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rubiksnet_torch.ops as tops
import rubiksnet_tpu.ops as jops

torch.set_num_threads(1)

TOL = 1e-5
SHAPE3 = (2, 4, 6, 7, 5)  # (N, T, H, W, C)
SHAPE2 = (3, 6, 7, 5)  # (N, H, W, C)


def _inputs(shape, rows, stride, seed):
    """x, og (at the strided output's shape) and a (rows, C) shift with
    fractional, integer and zero entries, float32."""
    rng = np.random.default_rng(seed)
    out = (tops.compute_output_shape_3d(shape, stride, 0) if len(shape) == 5
           else tops.compute_output_shape_2d(shape, stride, 0))
    x = rng.standard_normal(shape).astype(np.float32)
    og = rng.standard_normal(out).astype(np.float32)
    shift = rng.uniform(-1.8, 1.8, (rows, shape[-1])).astype(np.float32)
    shift[:, 0] = np.round(shift[:, 0])  # an integer shift
    shift[:, 1] = 0.0
    return x, og, shift


def _close(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == np.float32
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= TOL * scale


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("stride", [(1, 1, 1), (1, 2, 2)])
def test_shift_3d_input_grad_matches_jax(stride, quantize):
    x, og, shift = _inputs(SHAPE3, 3, stride, 1)
    got = tops.rubiks_shift_3d_input_grad(
        torch.from_numpy(og), torch.from_numpy(shift), SHAPE3, stride,
        (0, 0, 0), quantize)
    want = jops.rubiks_shift_3d_input_grad(
        jnp.asarray(og), jnp.asarray(shift), SHAPE3, stride, (0, 0, 0),
        quantize, backend="gather")
    _close(got, want)


@pytest.mark.parametrize("stride", [(1, 1, 1), (1, 2, 2)])
def test_shift_3d_shift_grad_matches_jax(stride):
    x, og, shift = _inputs(SHAPE3, 3, stride, 2)
    got = tops.rubiks_shift_3d_shift_grad(
        torch.from_numpy(og), torch.from_numpy(x), torch.from_numpy(shift),
        stride, (0, 0, 0))
    want = jops.rubiks_shift_3d_shift_grad(
        jnp.asarray(og), jnp.asarray(x), jnp.asarray(shift), stride,
        (0, 0, 0), backend="gather")
    assert got.shape == (3, SHAPE3[-1])
    _close(got, want)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
def test_shift_2d_input_grad_matches_jax(stride, quantize):
    x, og, shift = _inputs(SHAPE2, 2, stride, 3)
    got = tops.rubiks_shift_2d_input_grad(
        torch.from_numpy(og), torch.from_numpy(shift), SHAPE2, stride,
        (0, 0), quantize)
    want = jops.rubiks_shift_2d_input_grad(
        jnp.asarray(og), jnp.asarray(shift), SHAPE2, stride, (0, 0),
        quantize, backend="gather")
    _close(got, want)


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
def test_shift_2d_shift_grad_matches_jax(stride):
    x, og, shift = _inputs(SHAPE2, 2, stride, 4)
    got = tops.rubiks_shift_2d_shift_grad(
        torch.from_numpy(og), torch.from_numpy(x), torch.from_numpy(shift),
        stride, (0, 0))
    want = jops.rubiks_shift_2d_shift_grad(
        jnp.asarray(og), jnp.asarray(x), jnp.asarray(shift), stride, (0, 0),
        backend="gather")
    assert got.shape == (2, SHAPE2[-1])
    _close(got, want)


def test_gradients_equal_the_autograd_ops():
    """The public functions are the op's backward: the autograd op's input
    gradient equals the input-gradient function, and its normalized shift
    gradient the normalized shift-gradient function."""
    x, og, shift = _inputs(SHAPE3, 3, (1, 2, 2), 5)
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(shift).requires_grad_()
    tops.rubiks_shift_3d(xt, st, (1, 2, 2)).backward(torch.from_numpy(og))
    gx = tops.rubiks_shift_3d_input_grad(torch.from_numpy(og), st.detach(),
                                         SHAPE3, (1, 2, 2))
    gs = tops.rubiks_shift_3d_shift_grad(torch.from_numpy(og), xt.detach(),
                                         st.detach(), (1, 2, 2))
    assert torch.equal(xt.grad, gx)
    assert torch.equal(st.grad, tops.normalize_shift_grad_3d(gs, 1.0))


def test_gradients_raise_off_cpu_and_cuda():
    og = torch.empty(SHAPE3, device="meta")
    shift = torch.empty((3, SHAPE3[-1]), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.rubiks_shift_3d_input_grad(og, shift, SHAPE3)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.rubiks_shift_3d_shift_grad(og, og, shift)


def test_port_exports_cover_jax():
    assert set(jops.__all__) <= set(tops.__all__)
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name


def test_attention_shift_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal(SHAPE3).astype(np.float32)
    w = rng.uniform(0, 1, (SHAPE3[-1], 3)).astype(np.float32)
    got = tops.attention_shift(torch.from_numpy(x), torch.from_numpy(w))
    _close(got, jops.attention_shift(jnp.asarray(x), jnp.asarray(w)))
