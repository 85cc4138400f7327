"""Port's shift gradients (rubiksnet_torch.ops.shift3d) on the CPU, where
they run their plain forms, against the JAX gather ops, the loop oracle and
the Pallas kernels in interpret mode; plus the autograd op.

Tolerances: float64 against the oracle and against JAX in x64 at 1e-10
(the same arithmetic in another order; shift gradients relative to their
largest entry); float32 against JAX at 2e-4, the JAX package's own
tolerance (tests/test_shift_grad_kernel.py). The Pallas shift-gradient
kernel and the port's plain form both sum in float32 from the same inputs,
so they agree to 2e-4 relative for float32 and bfloat16 inputs. The Pallas
inverse shift computes in float32 and rounds once; the port's plain inverse
rounds each axis stage to the dtype: float32 at 1e-5, bfloat16 at relative
L2 1e-2 (8-bit mantissa, a few roundings, as on the card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from rubiksnet_torch.ops import shift3d
from rubiksnet_tpu.ops import shift3d as jshift3d
from rubiksnet_tpu.ops.pallas.shift_grad_kernel import (
    rubiks_shift3d_shift_grad_pallas,
)
from rubiksnet_tpu.ops.pallas.shift_kernel import rubiks_shift3d_pallas

torch.set_num_threads(1)

TOL64 = 1e-10
TOL32 = 2e-4

# The cases of tests/test_shift3d.py.
CASES = [
    dict(stride=(1, 1, 1), padding=(0, 0, 0), quantize=False),
    dict(stride=(1, 2, 2), padding=(0, 0, 0), quantize=False),
    dict(stride=(2, 2, 2), padding=(1, 1, 1), quantize=False),
    dict(stride=(1, 1, 1), padding=(0, 0, 0), quantize=True),
    dict(stride=(1, 2, 2), padding=(0, 1, 0), quantize=True),
]


def _inputs(case, kind, seed, c=6):
    """x (N, T, H, W, C), og of the case's output shape and a (3, C) shift
    in float64; ``integer`` makes every third channel an exact integer."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 5, 7, c))
    s = rng.uniform(-1.5, 1.5, (3, c))
    if kind == "integer":
        s[:, ::3] = np.round(s[:, ::3])
        s[0, 1], s[1, 1], s[2, 1] = 0.0, -1.0, 1.0
    out = shift3d.compute_output_shape_3d(x.shape, case["stride"],
                                          case["padding"])
    return x, rng.standard_normal(out), s


def _ncl(a):  # (N, T, H, W, C) -> the oracle's (N, T, C, H, W)
    return np.transpose(a, (0, 1, 4, 2, 3))


def _cl(a):
    return np.transpose(a, (0, 1, 3, 4, 2))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kind", ["fractional", "integer"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_input_grad_matches_oracle_and_jax(case, kind):
    cfg = CASES[case]
    x, og, s = _inputs(cfg, kind, seed=case)
    args = (cfg["stride"], cfg["padding"], cfg["quantize"])
    got = shift3d.shift3d_input_grad_plain(_t(og), _t(s), x.shape, *args)
    want = _cl(oracle.shift3d_input_grad(_ncl(og), _ncl(x).shape, s, *args))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL64, atol=TOL64)
    j64 = jshift3d.rubiks_shift_3d_input_grad(
        jnp.asarray(og), jnp.asarray(s), x.shape, *args, backend="gather")
    np.testing.assert_allclose(got.numpy(), np.asarray(j64), rtol=TOL64,
                               atol=TOL64)
    og32, s32 = og.astype(np.float32), s.astype(np.float32)
    got32 = shift3d.shift3d_input_grad_plain(_t(og32), _t(s32), x.shape,
                                             *args)
    j32 = jshift3d.rubiks_shift_3d_input_grad(
        jnp.asarray(og32), jnp.asarray(s32), x.shape, *args,
        backend="gather")
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(j32), rtol=TOL32,
                               atol=TOL32)


@pytest.mark.parametrize("kind", ["fractional", "integer"])
@pytest.mark.parametrize("case", range(3))
def test_shift_grad_matches_oracle_and_jax(case, kind):
    cfg = CASES[case]
    x, og, s = _inputs(cfg, kind, seed=10 + case)
    args = (cfg["stride"], cfg["padding"])
    got = shift3d.shift3d_shift_grad_plain(_t(og), _t(x), _t(s), *args)
    assert got.dtype == torch.float64 and got.shape == (3, 6)
    want = oracle.shift3d_shift_grad(_ncl(og), _ncl(x), s, *args)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL64 * scale)
    j64 = jshift3d.rubiks_shift_3d_shift_grad(
        jnp.asarray(og), jnp.asarray(x), jnp.asarray(s), *args,
        backend="gather")
    np.testing.assert_allclose(got.numpy(), np.asarray(j64), rtol=0,
                               atol=TOL64 * scale)
    x32, og32, s32 = (a.astype(np.float32) for a in (x, og, s))
    got32 = shift3d.shift3d_shift_grad_plain(_t(og32), _t(x32), _t(s32),
                                             *args)
    j32 = jshift3d.rubiks_shift_3d_shift_grad(
        jnp.asarray(og32), jnp.asarray(x32), jnp.asarray(s32), *args,
        backend="gather")
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(j32), rtol=TOL32,
                               atol=TOL32 * scale)


def _pallas_inputs(seed, c=16, integer=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 6, 7, c)).astype(np.float32)
    og = rng.standard_normal((2, 4, 6, 7, c)).astype(np.float32)
    s = rng.uniform(-0.95, 0.95, (3, c)).astype(np.float32)
    if integer:
        s[:, ::2] = np.round(s[:, ::2])
    return x, og, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [False, True])
def test_input_grad_matches_pallas_inverse(dtype, quantize):
    _, og, s = _pallas_inputs(20 + quantize)
    jd = getattr(jnp, dtype)
    want = rubiks_shift3d_pallas(jnp.asarray(og).astype(jd), jnp.asarray(s),
                                 1, quantize, inverse=True, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = shift3d.shift3d_input_grad_plain(
        _t(og).to(getattr(torch, dtype)), _t(s), og.shape, quantize=quantize)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel_l2 <= 1e-2, rel_l2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("integer", [False, True])
def test_shift_grad_matches_pallas(dtype, integer):
    x, og, s = _pallas_inputs(30 + integer, integer=integer)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(rubiks_shift3d_shift_grad_pallas(
        jnp.asarray(og).astype(jd), jnp.asarray(x).astype(jd),
        jnp.asarray(s), 1, interpret=True))
    got = shift3d.shift3d_shift_grad_plain(_t(og).to(td), _t(x).to(td),
                                           _t(s))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL32,
                               atol=TOL32 * np.abs(want).max())


@pytest.mark.parametrize("factor", [1.0, 0.5, 8 / 5, -1.0])
def test_normalize_matches_jax_and_oracle(factor):
    rng = np.random.default_rng(4)
    g = rng.standard_normal((3, 7))
    g[:, 3] = 0.0  # zero channel passes through
    g[1:, 5] = 0.0  # only the T row
    got = shift3d.normalize_shift_grad_3d(_t(g), factor).numpy()
    np.testing.assert_allclose(
        got, oracle.normalize_shift_grad_3d(g, factor), rtol=TOL64,
        atol=TOL64)
    np.testing.assert_allclose(
        got, np.asarray(jshift3d.normalize_shift_grad_3d(jnp.asarray(g),
                                                         factor)),
        rtol=TOL64, atol=TOL64)
    norms = np.linalg.norm(got, axis=0)
    np.testing.assert_allclose(np.delete(norms, 3), 1.0, rtol=1e-12)
    assert np.all(got[:, 3] == 0.0)


@pytest.mark.parametrize("case", [0, 1, 3])
def test_autograd_op_gradients(case):
    """The op's x gradient is the plain input gradient; its shift gradient
    is the plain raw gradient normalized (unit norm per channel), and the
    raw one with normalize_grad=False."""
    cfg = CASES[case]
    x, og, s = _inputs(cfg, "fractional", seed=40 + case)
    xt, st = _t(x).requires_grad_(), _t(s).float().requires_grad_()
    out = shift3d.rubiks_shift_3d(xt, st, cfg["stride"], cfg["padding"],
                                  quantize=cfg["quantize"])
    out.backward(_t(og))
    args = (cfg["stride"], cfg["padding"])
    want_x = shift3d.shift3d_input_grad_plain(_t(og), st.detach(), x.shape,
                                              *args, cfg["quantize"])
    np.testing.assert_array_equal(xt.grad.numpy(), want_x.numpy())
    raw = shift3d.shift3d_shift_grad_plain(_t(og), _t(x), st.detach(), *args)
    assert st.grad.dtype == torch.float32
    np.testing.assert_allclose(
        st.grad.numpy(), (raw / raw.norm(dim=0)).float().numpy(), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(st.grad.norm(dim=0).numpy(), 1.0, rtol=1e-6)

    st.grad = None
    out = shift3d.rubiks_shift_3d(xt.detach(), st, cfg["stride"],
                                  cfg["padding"], normalize_grad=False,
                                  quantize=cfg["quantize"])
    out.backward(_t(og))
    np.testing.assert_allclose(st.grad.numpy(), raw.float().numpy(),
                               rtol=1e-6, atol=1e-6 * float(raw.abs().max()))


@pytest.mark.parametrize("stride,padding", [((1, 1, 1), (0, 0, 0)),
                                            ((1, 2, 2), (0, 0, 0)),
                                            ((2, 2, 2), (1, 1, 1))])
def test_autograd_op_gradcheck(stride, padding):
    """Away from integer shifts, the un-normalized gradients are the true
    derivatives of the trilinear shift: torch.autograd.gradcheck in
    float64."""
    rng = np.random.default_rng(50)
    x = _t(rng.standard_normal((1, 3, 5, 4, 3))).requires_grad_()
    s = rng.uniform(-1.4, 1.4, (3, 3))
    frac = s - np.floor(s)
    s = np.where(np.abs(frac - 0.5) > 0.4, np.floor(s) + 0.5, s)
    st = _t(s).requires_grad_()

    def fn(x_, s_):
        return shift3d.rubiks_shift_3d(x_, s_, stride, padding,
                                       normalize_grad=False)

    assert torch.autograd.gradcheck(fn, (x, st), eps=1e-6, atol=1e-6)


def test_op_chooses_route_by_device():
    """No kernel runs on the CPU: the op takes the plain forms, and the
    kernel wrappers refuse CPU tensors."""
    x = torch.randn(1, 2, 4, 4, 3, requires_grad=True)
    s = torch.zeros(3, 3, requires_grad=True)
    shift3d.rubiks_shift_3d(x, s).sum().backward()
    og = torch.ones(1, 2, 4, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        shift3d.shift3d_input_grad_kernel(og, s.detach(), x.shape)
    with pytest.raises(ValueError, match="CUDA"):
        shift3d.shift3d_shift_grad_kernel(og, x.detach(), s.detach())
    assert shift3d.INVERSE_LAUNCHES.count == 0
    assert shift3d.SHIFT_GRAD_LAUNCHES.count == 0
