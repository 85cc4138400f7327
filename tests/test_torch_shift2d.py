"""Port's 2D shift (rubiksnet_torch.ops.shift2d) on the CPU, where it runs
its plain forms, against the JAX gather ops (rubiksnet_tpu.ops.shift2d,
``backend="gather"``), the loop oracle and the Pallas kernel at T = 1 in
interpret mode; plus the autograd op and the layer.

Tolerances: float64 against the oracle and against JAX in x64 at 1e-10 (the
same arithmetic in another order; shift gradients relative to their largest
entry); float32 against JAX at 2e-4, the JAX package's own tolerance
(tests/test_shift2d.py); the Pallas kernel at T = 1 at 1e-5 in float32 (it
sums the 4 corners at once, the plain form shifts one axis at a time)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from rubiksnet_torch.nn.layers import RubiksShift2D
from rubiksnet_torch.ops import shift2d, shift_core
from rubiksnet_tpu.nn.layers import group_shift_init as jax_group_init
from rubiksnet_tpu.ops import shift2d as jshift2d
from rubiksnet_tpu.ops.pallas.shift_kernel import rubiks_shift3d_pallas

torch.set_num_threads(1)

TOL64 = 1e-10
TOL32 = 2e-4

CASES = [
    dict(stride=(1, 1), padding=(0, 0), quantize=False),
    dict(stride=(2, 2), padding=(0, 0), quantize=False),
    dict(stride=(2, 1), padding=(1, 2), quantize=False),
    dict(stride=(1, 1), padding=(0, 0), quantize=True),
    dict(stride=(2, 2), padding=(0, 0), quantize=True),
    dict(stride=(2, 2), padding=(2, 1), quantize=True),
]


def _inputs(case, kind, seed, c=8):
    """x (N, H, W, C), og of the case's output shape and a (2, C) shift in
    float64. ``integer``: every third channel an exact integer, one channel
    zero (the central-difference branch). ``half``: remainders of exactly
    0.5 of both signs, so the half-away rounding meets negative
    coordinates (padding and negative shifts) and exact ties."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, 7, c))
    s = rng.uniform(-1.8, 1.8, (2, c))
    if kind == "integer":
        s[:, ::3] = np.round(s[:, ::3])
        s[:, 1] = 0.0
    elif kind == "half":
        s[0] = np.resize([-1.5, -0.5, 0.5, 1.5, -2.5, 0.49, -0.51, 2.5], c)
        s[1] = np.resize([0.5, -1.5, -0.5, 2.5, 1.5, -0.49, 0.51, -2.5], c)
    out = shift2d.compute_output_shape_2d(x.shape, case["stride"],
                                          case["padding"])
    return x, rng.standard_normal(out), s


def _nchw(a):
    return np.transpose(a, (0, 3, 1, 2))


def _nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kind", ["fractional", "integer", "half"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_forward_matches_oracle_and_jax(case, kind):
    cfg = CASES[case]
    x, _, s = _inputs(cfg, kind, seed=case)
    args = (cfg["stride"], cfg["padding"], cfg["quantize"])
    got = shift2d.rubiks_shift_2d_forward(_t(x), _t(s), *args)
    want = _nhwc(oracle.shift2d_forward(_nchw(x), s, *args))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL64, atol=TOL64)
    j64 = jshift2d.rubiks_shift_2d_forward(jnp.asarray(x), jnp.asarray(s),
                                           *args, backend="gather")
    np.testing.assert_allclose(got.numpy(), np.asarray(j64), rtol=TOL64,
                               atol=TOL64)
    x32, s32 = x.astype(np.float32), s.astype(np.float32)
    got32 = shift2d.shift2d_plain(_t(x32), _t(s32), *args)
    j32 = jshift2d.rubiks_shift_2d_forward(jnp.asarray(x32), jnp.asarray(s32),
                                           *args, backend="gather")
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(j32), rtol=TOL32,
                               atol=TOL32)


@pytest.mark.parametrize("kind", ["fractional", "integer", "half"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_input_grad_matches_oracle_and_jax(case, kind):
    cfg = CASES[case]
    x, og, s = _inputs(cfg, kind, seed=20 + case)
    args = (cfg["stride"], cfg["padding"], cfg["quantize"])
    got = shift2d.rubiks_shift_2d_input_grad(_t(og), _t(s), x.shape, *args)
    want = _nhwc(oracle.shift2d_input_grad(_nchw(og), _nchw(x).shape, s,
                                           *args))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL64, atol=TOL64)
    j64 = jshift2d.rubiks_shift_2d_input_grad(
        jnp.asarray(og), jnp.asarray(s), x.shape, *args, backend="gather")
    np.testing.assert_allclose(got.numpy(), np.asarray(j64), rtol=TOL64,
                               atol=TOL64)
    og32, s32 = og.astype(np.float32), s.astype(np.float32)
    got32 = shift2d.shift2d_input_grad_plain(_t(og32), _t(s32), x.shape,
                                             *args)
    j32 = jshift2d.rubiks_shift_2d_input_grad(
        jnp.asarray(og32), jnp.asarray(s32), x.shape, *args,
        backend="gather")
    np.testing.assert_allclose(got32.numpy(), np.asarray(j32), rtol=TOL32,
                               atol=TOL32)


@pytest.mark.parametrize("kind", ["fractional", "integer"])
@pytest.mark.parametrize("case", range(3))
def test_shift_grad_matches_oracle_and_jax(case, kind):
    """Raw and normalized (2, C) gradients; the integer channels take the
    halved central difference."""
    cfg = CASES[case]
    x, og, s = _inputs(cfg, kind, seed=40 + case)
    args = (cfg["stride"], cfg["padding"])
    got = shift2d.rubiks_shift_2d_shift_grad(_t(og), _t(x), _t(s), *args)
    assert got.dtype == torch.float64 and got.shape == (2, 8)
    want = oracle.shift2d_shift_grad(_nchw(og), _nchw(x), s, *args)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL64 * scale)
    j64 = jshift2d.rubiks_shift_2d_shift_grad(
        jnp.asarray(og), jnp.asarray(x), jnp.asarray(s), *args,
        backend="gather")
    np.testing.assert_allclose(got.numpy(), np.asarray(j64), rtol=0,
                               atol=TOL64 * scale)
    norm = shift2d.normalize_shift_grad_2d(got)
    np.testing.assert_allclose(norm.numpy(),
                               oracle.normalize_shift_grad_2d(want),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(
        norm.numpy(), np.asarray(jshift2d.normalize_shift_grad_2d(j64)),
        rtol=1e-9, atol=1e-9)
    x32, og32, s32 = (a.astype(np.float32) for a in (x, og, s))
    got32 = shift2d.rubiks_shift_2d_shift_grad(_t(og32), _t(x32), _t(s32),
                                               *args)
    j32 = jshift2d.rubiks_shift_2d_shift_grad(
        jnp.asarray(og32), jnp.asarray(x32), jnp.asarray(s32), *args,
        backend="gather")
    np.testing.assert_allclose(got32.numpy(), np.asarray(j32), rtol=0,
                               atol=TOL32 * scale)


def test_normalize_passes_zero_channels_through():
    g = torch.tensor([[3.0, 0.0, -1.0], [4.0, 0.0, 0.0]])
    got = shift2d.normalize_shift_grad_2d(g)
    np.testing.assert_allclose(got.numpy(), [[0.6, 0.0, -1.0],
                                             [0.8, 0.0, 0.0]], rtol=1e-6)


@pytest.mark.parametrize("inverse", [False, True])
def test_matches_pallas_kernel_at_one_frame(inverse):
    """The TPU kernel the 2D shift reaches: the one-pass 3D kernel at T = 1
    with a zero T row (interpret mode), stride 1, fractional."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 8, 8, 128)).astype(np.float32)
    s = rng.uniform(-1.0, 1.0, (2, 128)).astype(np.float32)
    shift3 = jnp.concatenate([jnp.zeros((1, 128), jnp.float32),
                              jnp.asarray(s)])
    want = rubiks_shift3d_pallas(jnp.asarray(x)[:, None], shift3, 1, False,
                                 inverse=inverse, interpret=True)[:, 0]
    if inverse:
        got = shift2d.rubiks_shift_2d_input_grad(_t(x), _t(s), x.shape)
    else:
        got = shift2d.rubiks_shift_2d_forward(_t(x), _t(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_autograd_op_returns_the_reference_gradients(normalize):
    cfg = CASES[1]
    x, og, s = _inputs(cfg, "integer", seed=60)
    xt, st = _t(x).requires_grad_(), _t(s).requires_grad_()
    out = shift2d.rubiks_shift_2d(xt, st, cfg["stride"], cfg["padding"],
                                  normalize_grad=normalize)
    out.backward(_t(og))
    gx = shift2d.shift2d_input_grad_plain(_t(og), _t(s), x.shape,
                                          cfg["stride"], cfg["padding"])
    gs = shift2d.rubiks_shift_2d_shift_grad(_t(og), _t(x), _t(s),
                                            cfg["stride"], cfg["padding"])
    if normalize:
        gs = shift2d.normalize_shift_grad_2d(gs)
        np.testing.assert_allclose(st.grad.norm(dim=0).numpy(), 1.0,
                                   rtol=1e-12)
    assert torch.equal(xt.grad, gx) and torch.equal(st.grad, gs)


def test_input_gradient_passes_gradcheck():
    """The input gradient is the true transpose of the fractional forward
    (float64 gradcheck); the shift gradient is the reference's rule, which
    equals the true derivative away from integer shifts."""
    rng = np.random.default_rng(61)
    x = _t(rng.standard_normal((1, 4, 5, 3))).requires_grad_()
    s = _t(rng.uniform(0.1, 0.9, (2, 3)) + np.array([[0], [-1]])
           ).requires_grad_()
    fn = lambda a, b: shift2d.rubiks_shift_2d(a, b, (2, 1), (1, 0),
                                              normalize_grad=False)
    assert torch.autograd.gradcheck(fn, (x, s), eps=1e-6, atol=1e-6)


def test_wrappers_check_their_arguments():
    x = torch.randn(1, 4, 4, 3)
    with pytest.raises(ValueError, match="N, H, W, C"):
        shift2d.rubiks_shift_2d(x[None], torch.zeros(2, 3))
    with pytest.raises(ValueError, match=r"\(2, C=3\)"):
        shift2d.rubiks_shift_2d_forward(x, torch.zeros(3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        shift2d.shift2d_kernel(x, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        shift2d.rubiks_shift_2d_forward(x.to("meta"),
                                        torch.zeros(2, 3, device="meta"))
    with pytest.raises(ValueError, match="quantize_mode"):
        shift_core.frac_shift_axis(x, torch.zeros(3), 1, 1, 0, True, "up")
    assert shift2d.LAUNCHES.count == 0
    assert shift2d.INVERSE_LAUNCHES.count == 0


@pytest.mark.parametrize("init", ["uniform", "group3"])
def test_layer_folds_frames_and_initializes(init):
    c = 20
    layer = RubiksShift2D(c, stride=2, init_shift=init,
                          generator=torch.Generator().manual_seed(0))
    if init == "group3":
        want = jax_group_init(3)(None, (2, c))
        np.testing.assert_array_equal(layer.shift.detach().numpy(),
                                      np.asarray(want))
    else:
        assert float(layer.shift.detach().abs().max()) <= 1.0
        assert float(layer.shift.detach().abs().min()) > 0.0
    x = torch.randn(2, 3, 6, 6, c)
    out5 = layer(x)
    out4 = layer(x.reshape(6, 6, 6, c))
    assert out5.shape == (2, 3, 3, 3, c)
    assert torch.equal(out5.reshape(6, 3, 3, c), out4)
    with pytest.raises(NotImplementedError, match="init shift"):
        RubiksShift2D(c, init_shift="spiral")
