"""Port's 3D shift (rubiksnet_torch.ops.shift3d) vs the JAX gather op and
the loop oracle, on the CPU, where the op runs its plain gather form.

Tolerances: float64 against the oracle and against JAX in x64 at 1e-10
(the same arithmetic in another order); float32 against JAX at 2e-4, the
JAX package's own fused-test tolerance (tests/test_fused_block.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from rubiksnet_torch.ops import shift3d
from rubiksnet_tpu.ops import shift3d as jshift3d
from rubiksnet_tpu.ops.conv_backend import _shift_kernel

torch.set_num_threads(1)

TOL64 = 1e-10
TOL32 = 2e-4


def _shifts(kind, c, rng):
    if kind == "fractional":
        return rng.uniform(-1.8, 1.8, size=(3, c))
    if kind == "integer":
        return rng.integers(-2, 3, size=(3, c)).astype(np.float64)
    if kind == "zero":
        return np.zeros((3, c))
    # half-integers and values next to them: the quantize rounding edges
    edge = np.array([-1.5, -0.5, 0.5, 1.5, 0.49, -0.51, 0.999, -1.0])
    return np.stack([np.resize(edge, c), np.resize(-edge, c),
                     np.resize(edge[::-1], c)])


@pytest.mark.parametrize("stride", [(1, 1, 1), (1, 2, 2)])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("kind", ["fractional", "integer", "zero", "edge"])
def test_plain_shift_matches_oracle_and_jax(stride, quantize, kind):
    rng = np.random.default_rng(7)
    c = 6
    x = rng.standard_normal((2, 4, 5, 7, c))  # (N, T, H, W, C), float64
    s = _shifts(kind, c, rng)
    got = shift3d.rubiks_shift_3d_forward(
        torch.from_numpy(x), torch.from_numpy(s), stride, (0, 0, 0), quantize)
    ref = oracle.shift3d_forward(x.transpose(0, 1, 4, 2, 3), s, stride,
                                 (0, 0, 0), quantize).transpose(0, 1, 3, 4, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL64, atol=TOL64)
    want64 = jshift3d.rubiks_shift_3d_forward(
        jnp.asarray(x), jnp.asarray(s), stride, (0, 0, 0), quantize,
        backend="gather")
    np.testing.assert_allclose(got.numpy(), np.asarray(want64), rtol=TOL64,
                               atol=TOL64)
    x32, s32 = x.astype(np.float32), s.astype(np.float32)
    got32 = shift3d.rubiks_shift_3d_forward(
        torch.from_numpy(x32), torch.from_numpy(s32), stride, (0, 0, 0),
        quantize)
    want32 = jshift3d.rubiks_shift_3d_forward(
        jnp.asarray(x32), jnp.asarray(s32), stride, (0, 0, 0), quantize,
        backend="gather")
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(want32), rtol=TOL32,
                               atol=TOL32)


@pytest.mark.parametrize("shape,stride,padding", [
    ((2, 8, 112, 112, 72), (1, 2, 2), (0, 0, 0)),
    ((1, 3, 7, 9, 4), (2, 2, 2), (1, 1, 1)),
    ((1, 4, 5, 5, 3), 1, 0),
])
def test_output_shape_matches_jax(shape, stride, padding):
    assert shift3d.compute_output_shape_3d(shape, stride, padding) == (
        jshift3d.compute_output_shape_3d(shape, stride, padding))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("max_shift", [1, 2])
def test_tap_weights_match_conv_backend(dtype, quantize, max_shift):
    """shift_tap_weights == conv_backend._shift_kernel, including the bf16
    rounding of the shift before floor and remainder (exact: same ops)."""
    rng = np.random.default_rng(3)
    s = rng.uniform(-max_shift, max_shift, 64).astype(np.float32)
    s[:8] = [0.0, 1.0, -1.0, 0.5, -0.5, 0.999, 0.4999, -0.7]
    got = shift3d.shift_tap_weights(torch.from_numpy(s), getattr(torch, dtype),
                                    max_shift, quantize)
    jd = getattr(jnp, dtype)
    want = _shift_kernel(jnp.asarray(s).astype(jd), jd, max_shift, quantize)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_bf16_shift_rounds_like_jax():
    """In bf16 the op rounds the shift to bf16 first, as the JAX op does;
    the remainder then differs from the f32 one."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 3, 6, 6, 8)).astype(np.float32)
    s = np.full((3, 8), 0.3001, np.float32)
    got = shift3d.rubiks_shift_3d_forward(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(s))
    want = jshift3d.rubiks_shift_3d_forward(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(s), backend="gather")
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_op_refuses_autograd():
    """The autograd op records the shift and returns the normalized shift
    gradient (unit norm per channel) and the input gradient; the bare
    forward records nothing."""
    x = torch.randn(1, 2, 4, 4, 3, dtype=torch.float64)
    s = torch.tensor([[0.3, -0.7, 1.2], [0.5, 0.1, -0.4], [-0.9, 0.6, 0.2]],
                     dtype=torch.float32, requires_grad=True)
    assert shift3d.rubiks_shift_3d_forward(x, s).grad_fn is None
    out = shift3d.rubiks_shift_3d(x.requires_grad_(), s)
    assert out.grad_fn is not None and out.shape == x.shape
    (out * out).sum().backward()
    assert s.grad.dtype == torch.float32 and s.grad.shape == (3, 3)
    np.testing.assert_allclose(s.grad.norm(dim=0).numpy(), 1.0, rtol=1e-6)
    assert x.grad.shape == x.shape and bool(torch.isfinite(x.grad).all())
    with torch.no_grad():
        out = shift3d.rubiks_shift_3d(x, s)
    assert out.grad_fn is None


def test_op_checks_shapes_and_device():
    x = torch.randn(1, 2, 4, 4, 3)
    with pytest.raises(ValueError):
        shift3d.rubiks_shift_3d_forward(x, torch.zeros(3, 4))
    with pytest.raises(ValueError):
        shift3d.rubiks_shift_3d_forward(x[0], torch.zeros(3, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        shift3d.rubiks_shift_3d_forward(x.to("meta"),
                                        torch.zeros(3, 3, device="meta"))
    # The kernel wrapper itself takes CUDA tensors only: no CPU fallback.
    with pytest.raises(ValueError, match="CUDA"):
        shift3d.shift3d_kernel(x, torch.zeros(3, 3))
    assert shift3d.LAUNCHES.count == 0
