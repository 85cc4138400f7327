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


# ------------------------------------------- the CUDA kernels' host side
#
# csrc/shift2d.cu cannot run here. What surrounds its arithmetic is Python:
# the plan, the coordinate rule, the halo of a band, the ring's depth and
# the stride parity walk. The emulation below is the kernel's decomposition
# in plain PyTorch, block by block; it equals the plain forms bit for bit
# in float32 (the same products in the same order: rows, then columns).

LARGE_SHIFT_SHAPES = [(112, 72, 1), (56, 72, 1), (28, 144, 1), (14, 288, 1),
                      (7, 576, 1), (112, 72, 2), (56, 144, 2), (28, 288, 2),
                      (14, 576, 2)]
PLAN_CASES = ([(64, h, h, c, s) for h, c, s in LARGE_SHIFT_SHAPES]
              + [(16, 28, 28, c, s) for c in (54, 108, 72, 576)
                 for s in (1, 2)]
              + [(1, 7, 9, 54, 1), (3, 113, 57, 72, 2), (2, 5, 300, 55, 1),
                 (2, 9, 9, 131, 1)])


def _check_plan(plan, src_hw, dst_hw, c, itemsize):
    assert plan.smem_bytes <= shift2d.SMEM_LIMIT == 232448
    assert plan.threads == plan.group * plan.cols <= shift2d.MAX_THREADS
    # The groups cover C exactly once (the last may be ragged).
    covered = [ch for g in range(plan.groups)
               for ch in range(g * plan.group,
                               min((g + 1) * plan.group, c))]
    assert covered == list(range(c))
    assert (plan.groups - 1) * plan.group < c
    # The bands cover the destination rows exactly once.
    assert (plan.bands - 1) * plan.rows < dst_hw[0] <= plan.bands * plan.rows
    assert plan.route == shift2d.ROUTES[plan.copy_bytes]
    if plan.route == "vector":
        assert (c * itemsize) % 16 == 0
    assert (c * itemsize) % plan.copy_bytes == 0
    assert (plan.group * itemsize) % plan.copy_bytes == 0
    assert plan.smem_bytes == 16 + plan.ring * shift2d._ring_pitch(
        src_hw[1] * plan.group * itemsize)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plan_fits_the_card_and_covers_the_tensor(case, dtype, inverse):
    n, h, w, c, s = PLAN_CASES[case]
    shape = (n, h, w, c)
    out = shift2d.compute_output_shape_2d(shape, s, 0)
    plan = shift2d.shift2d_plan(shape, out, s, dtype, inverse)
    src, dst = (out, shape) if inverse else (shape, out)
    _check_plan(plan, src[1:3], dst[1:3], c, dtype.itemsize)
    # Shifts within (-1, 1) must take the staged route.
    mul, div, _ = shift2d.axis_rule(s, 0, inverse)
    assert plan.ring >= shift2d.ring_rows_needed(1, mul, div)
    # A source that is only 4-byte aligned never gets 16-byte copies.
    narrow = shift2d.shift2d_plan(shape, out, s, dtype, inverse, 4)
    assert narrow.copy_bytes <= 4
    _check_plan(narrow, src[1:3], dst[1:3], c, dtype.itemsize)


def test_plan_refuses_a_frame_of_2_to_the_31_elements():
    shape = (1, 1 << 15, 1 << 10, 64)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        shift2d.shift2d_plan(shape, shape, 1, torch.bfloat16)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        shift2d.shift2d_plan(shape, shape, 1, torch.bfloat16, inverse=True)
    ok = (1, (1 << 15) - 1, 1 << 10, 64)
    plan = shift2d.shift2d_plan(ok, ok, 1, torch.bfloat16)
    assert plan.groups * plan.group == 64


def _axis_taps(p, rule, s, d_src, quantize):
    """The kernel's axis_taps at destination position p for channel shifts
    s (already negated for the gradient): (idx0, w0, idx1, w1), idx -1
    where the tap reads nothing."""
    mul, div, off = rule
    base = p * mul + off
    f = torch.floor(s)
    if quantize:
        v = base + s
        j = torch.where(v < 0, torch.trunc(v - 0.5), torch.trunc(v + 0.5))
        taps = [(j.long(), torch.ones_like(s))]
    else:
        r = s - f
        taps = [(base + f.long(), 1 - r), (base + f.long() + 1, r)]
    out = []
    for j, wt in taps:
        ok = (j >= 0) & (j % div == 0) & (j // div < d_src)
        out += [torch.where(ok, j // div, torch.full_like(j, -1)), wt]
    if quantize:
        out += [torch.full_like(out[0], -1), torch.zeros_like(s)]
    return out


def _gather_c(rows, idx):
    """rows (N, D, ..., C) at per-channel first-axis index idx (C,), zero
    where idx is -1."""
    safe = idx.clamp(min=0)
    view = (1, 1) + (1,) * (rows.ndim - 3) + (-1,)
    picked = torch.gather(
        rows, 1, safe.reshape(view).expand(rows.shape[0], 1,
                                           *rows.shape[2:]))[:, 0]
    return torch.where(idx >= 0, picked, torch.zeros((), dtype=rows.dtype))


def _walk_columns(vert, s_w, rule, wd, quantize):
    """The kernel's column pass on vert (N, Ws, C): (N, wd, C). Fractional
    taps at stride 2 of the gradient by parity, at any other stride by the
    walker: q mod div kept with adds; the cell q // div where div divides q
    (weight 1 - r), (q + 1) // div where it divides q + 1 (weight r).
    Quantized taps per element."""
    mul, div, off = rule
    ws = vert.shape[1]
    cols = vert.transpose(0, 1)  # (Ws, N, C): gather along the first axis
    f = torch.floor(s_w)
    a1 = s_w - f
    a0 = 1 - a1
    q = off + f.long()
    d = q // div
    m = q - d * div
    out = []

    def col(i):
        i = torch.where((i >= 0) & (i < ws), i, torch.full_like(i, -1))
        return _gather_c(cols[None], i)[0]

    for w in range(wd):
        if quantize:
            i0, _, _, _ = _axis_taps(w, rule, s_w, ws, True)
            out.append(col(i0))
            continue
        if div == 1:
            out.append(a0 * col(d) + a1 * col(d + 1))
            d = d + mul
            continue
        if div == 2:  # one cell (q + 1) >> 1, weight by q's parity
            qw = w + q
            out.append(torch.where(qw & 1 == 1, a1, a0) * col((qw + 1) >> 1))
            continue
        none = torch.full_like(d, -1)
        g0 = col(torch.where(m == 0, d, none))
        g1 = col(torch.where(m == div - 1, d + 1, none))
        out.append(a0 * g0 + a1 * g1)
        m = m + 1
        d = torch.where(m == div, d + 1, d)
        m = torch.where(m == div, torch.zeros_like(m), m)
    return torch.stack(out, 1)


def _emulate(src, shift, dst_shape, stride, padding, quantize, inverse,
             plan):
    """The kernel's decomposition: per channel group the floor range and
    the route, per band the ring of source rows, per destination row the
    row taps (inside the ring's rows, or the emulation fails), then the
    column walk. Returns (result, set of routes taken)."""
    n, hd, wd, c = dst_shape
    hs, ws = src.shape[1:3]
    rule_h = shift2d.axis_rule(stride[0], padding[0], inverse)
    rule_w = shift2d.axis_rule(stride[1], padding[1], inverse)
    s = -shift if inverse else shift
    dst = torch.full(dst_shape, float("nan"), dtype=src.dtype)
    routes = set()
    for g in range(plan.groups):
        ch = slice(g * plan.group, min((g + 1) * plan.group, c))
        sg = s[:, ch]
        fl = torch.floor(sg[0]).long()
        f_min, f_max = int(fl.min()), int(fl.max())
        staged = plan.ring > 0 and shift2d.ring_rows_needed(
            f_max - f_min, rule_h[0], rule_h[1]) <= plan.ring
        routes.add("staged" if staged else "direct")
        for band in range(plan.bands):
            rows = range(band * plan.rows, min((band + 1) * plan.rows, hd))
            ring = {}  # slot -> source row
            for r in rows:
                i0, w0, i1, w1 = _axis_taps(r, rule_h, sg[0], hs, quantize)
                if staged:
                    ahead = shift2d.ring_lookahead(
                        f_max - f_min, rule_h[0], rule_h[1], plan.ring)
                    assert ahead >= 1
                    lo, hi = shift2d.band_source_rows(r, f_min, f_max,
                                                      rule_h, hs)
                    far = min(r + ahead, rows[-1])
                    nxt = shift2d.band_source_rows(far, f_min, f_max,
                                                   rule_h, hs)[1]
                    for q in range(lo, nxt + 1):  # requested so far
                        ring[q % plan.ring] = q
                    live = set(range(lo, hi + 1))
                    assert len(range(lo, nxt + 1)) <= plan.ring
                    assert live <= set(ring.values())  # none overwritten
                    for idx in (i0, i1):
                        assert set(idx[idx >= 0].tolist()) <= live
                rows_src = src[:, :, :, ch]
                vert = (w0 * _gather_c(rows_src, i0)
                        + w1 * _gather_c(rows_src, i1))
                dst[:, r, :, ch] = _walk_columns(vert, sg[1], rule_w, wd,
                                                 quantize)
    assert not torch.isnan(dst).any()  # every element written once
    return dst, routes


EMU_SHIFTS = {
    "fractional": lambda rng, c: rng.uniform(-1.8, 1.8, (2, c)),
    "integer": lambda rng, c: np.round(rng.uniform(-2.4, 2.4, (2, c))),
    "half": lambda rng, c: np.round(rng.uniform(-2.4, 2.4, (2, c)) * 2) / 2,
    "far": lambda rng, c: rng.uniform(-1, 1, (2, c)) + 12.0 * np.pad(
        [1.0, -1.0], (0, c - 2)),
}


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", sorted(EMU_SHIFTS))
@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_decomposition_equals_the_plain_forms(case, kind, inverse):
    cfg = CASES[case]
    rng = np.random.default_rng(100 + case)
    c = 12
    shape = (2, 9, 7, c)
    out_shape = shift2d.compute_output_shape_2d(shape, cfg["stride"],
                                                cfg["padding"])
    s = _t(EMU_SHIFTS[kind](rng, c).astype(np.float32))
    src_shape, dst_shape = ((out_shape, shape) if inverse
                            else (shape, out_shape))
    src = _t(rng.standard_normal(src_shape).astype(np.float32))
    # Small knobs so that this small tensor has several bands and groups.
    plan = shift2d._plan(shape, out_shape, cfg["stride"], 4, inverse, 16,
                         (4096, 4, 10, 64, 2, 32))
    assert plan.groups == 3 and plan.bands > 1 and plan.ring > 0
    got, routes = _emulate(src, s, dst_shape, cfg["stride"], cfg["padding"],
                           cfg["quantize"], inverse, plan)
    args = (cfg["stride"], cfg["padding"], cfg["quantize"])
    if inverse:
        want = shift2d.shift2d_input_grad_plain(src, s, shape, *args)
    else:
        want = shift2d.shift2d_plain(src, s, *args)
    assert torch.equal(got, want)
    # Shifts of +-12 in the first channel group exceed the ring: that group
    # reads directly, the others stay staged.
    assert routes == ({"staged", "direct"} if kind == "far" else {"staged"})


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("padding", [0, 2])
def test_parity_walk_matches_inverse_shift_axis(stride, padding):
    """One tap per axis survives at stride >= 2: the walker's choice by
    q mod stride against the gather form's two tested taps."""
    rng = np.random.default_rng(stride * 10 + padding)
    c, w_in = 16, 11
    w_out = shift_core.output_len(w_in, stride, padding)
    og = _t(rng.standard_normal((2, w_out, c)).astype(np.float32))
    s = _t(np.concatenate([rng.uniform(-2.6, 2.6, c - 4),
                           [-1.0, 0.0, 2.0, -0.5]]).astype(np.float32))
    rule = shift2d.axis_rule(stride, padding, True)
    got = _walk_columns(og, -s, rule, w_in, False)
    want = shift_core.inverse_shift_axis(og, s, 1, stride, padding, w_in,
                                         False, "half_away")
    assert torch.equal(got, want)
    if stride >= 2:  # never two taps at once
        f = torch.floor(-s).long()
        for w in range(w_in):
            q = w + padding + f
            assert (((q % stride) == 0) & (((q + 1) % stride) == 0)).sum() == 0


def test_kernel_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.randn(2, 4, 4, 6)
    s = torch.zeros(2, 6)
    for fn in (lambda a, b: shift2d.shift2d_kernel(a, b),
               lambda a, b: shift2d.shift2d_input_grad_kernel(a, b, a.shape)):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, s)
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.transpose(1, 2), s)
        with pytest.raises(ValueError, match="contiguous"):
            fn(x, torch.zeros(6, 2).t())
        with pytest.raises(ValueError, match=r"must be \(2, C\)"):
            fn(x, torch.zeros(3, 6))
        with pytest.raises(TypeError, match="float32 shift"):
            fn(x, s.double())
    # The shapes are held against each other once per configuration, where
    # the launch is prepared (after the device check).
    with pytest.raises(ValueError, match="not the output shape"):
        shift2d._prepare(True, (2, 4, 4, 6), (2, 9, 9, 6), 2, 0,
                         torch.float32, 16)
    assert shift2d.LAUNCHES.count == 0
    assert shift2d.INVERSE_LAUNCHES.count == 0
