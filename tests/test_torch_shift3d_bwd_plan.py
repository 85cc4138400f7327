"""The staged route of the 3D shift's kernels
(rubiksnet_torch/ops/csrc/shift3d_bwd.cu: K1, the forward; K1-inverse and
K4, the backward) on the CPU. The kernels run only on the card; what
surrounds them is tested here: the launch plan
(ops/shift3d.py::shift3d_bwd_plan) and the kernels' decomposition in each
direction, emulated in float64 (channel groups, units of a destination
frame and a band of rows, the ring of staged frames and rows with its
direct-read route, the per-axis taps with the carry, the forward's strided
walk, the parity walk and the walker, the in-kernel rounding of the shift,
the shift gradient's window of source columns and its fixed order of
partials) against the plain forms (1e-12) and the JAX package in x64
(1e-10), and against the Pallas kernels in interpret mode (float32, 1e-5
relative to the largest entry): at stride 1 rubiks_shift3d_pallas, at
stride (1, 2, 2) the forward's rubiks_shift_3d_fused. Small shapes; the
wrappers refuse what the kernels do not take."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rubiksnet_torch.ops import shift3d as s3
from rubiksnet_tpu.ops import shift3d as jshift3d
from rubiksnet_tpu.ops.pallas.fused_shift3d import rubiks_shift_3d_fused
from rubiksnet_tpu.ops.pallas.shift_grad_kernel import (
    rubiks_shift3d_shift_grad_pallas,
)
from rubiksnet_tpu.ops.pallas.shift_kernel import rubiks_shift3d_pallas

torch.set_num_threads(1)

FORWARD, INPUT_GRAD, SHIFT_GRAD = s3.FORWARD, s3.INPUT_GRAD, s3.SHIFT_GRAD

TOL_PLAIN = 1e-12
TOL_JAX = 1e-10
H100_SMEM = 232448  # bytes of shared memory a block can have
KERNEL_SOURCE = (Path(s3.__file__).parent / "csrc" / "shift3d_bwd.cu")

# The cases of tests/test_torch_shift_grad.py.
CASES = [
    dict(stride=(1, 1, 1), padding=(0, 0, 0), quantize=False),
    dict(stride=(1, 2, 2), padding=(0, 0, 0), quantize=False),
    dict(stride=(2, 2, 2), padding=(1, 1, 1), quantize=False),
    dict(stride=(1, 1, 1), padding=(0, 0, 0), quantize=True),
    dict(stride=(1, 2, 2), padding=(0, 1, 0), quantize=True),
]
# Shift kinds: fractional; exact integers (the corrected taps); exact
# halves (quantize's ties); "far": +-12 in the first two channels, more
# frames and rows than the ring holds, so their group reads directly.
SHIFTS = {
    "fractional": lambda rng, c: rng.uniform(-1.8, 1.8, (3, c)),
    "integer": lambda rng, c: np.round(rng.uniform(-2.4, 2.4, (3, c))),
    "half": lambda rng, c: np.round(rng.uniform(-2.4, 2.4, (3, c)) * 2) / 2,
    "far": lambda rng, c: rng.uniform(-1, 1, (3, c)) + 12.0 * np.pad(
        [1.0, -1.0], (0, c - 2)),
}
# Small knobs (budget, max group, ring rows, target blocks, min band rows,
# block threads, tap extents the ring is sized for), so that a small tensor
# has several groups and bands, and the ring holds the frames and rows of
# shifts within +-2.5.
SMALL_KNOBS = (8192, 4, 10, 64, 2, 8, 5, 6)

# Large's shift shapes (H, C, stride) and off-model ones, for the plan.
LARGE = [(112, 72, 1), (56, 72, 1), (28, 144, 1), (14, 288, 1), (7, 576, 1),
         (112, 72, 2), (56, 144, 2), (28, 288, 2), (14, 576, 2)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(case, kind, seed, shape=(2, 3, 8, 5, 6)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    og_shape = s3.compute_output_shape_3d(shape, case["stride"],
                                          case["padding"])
    return x, rng.standard_normal(og_shape), SHIFTS[kind](rng, shape[-1])


# ------------------------------------------------ the kernels, emulated


def _cells(p, rule, lo, hi, w0, w1, d_src, drop_zero):
    """The kernel's ``cells``: per channel two (cell, weight, ok)."""
    mul, div, off = rule
    out = []
    for q, wt in ((p * mul + off + lo, w0), (p * mul + off + hi, w1)):
        ok = q >= 0
        if drop_zero:
            ok = ok & (wt != 0)
        if div > 1:
            ok = ok & (q % div == 0)
        j = torch.div(q, div, rounding_mode="floor")
        out.append((torch.where(ok & (j < d_src), j, -1), wt))
    return out


def _gather(src, n, frame, row, col, ch):
    """src[n, frame[c], row[c], col, ch[c]] per channel, zero where any
    index is -1 or the column lies outside."""
    t, h, w = src.shape[1:4]
    ok = (frame >= 0) & (row >= 0) & (col >= 0) & (col < w)
    v = src[n, frame.clamp(0, t - 1), row.clamp(0, h - 1),
            col.clamp(0, w - 1), ch]
    return torch.where(ok, v, torch.zeros((), dtype=src.dtype))


class _Ring:
    """The ring of one unit: slot (frame - f_lo, row mod D) holds a source
    row once requested, and with the plan's og rows slot r mod D of theirs
    destination row r's og; a read checks that its row is there."""

    def __init__(self, plan, rule_h, h_lo, h_hi, hs, r_begin, r_end):
        self.plan, self.rule, self.hs = plan, rule_h, hs
        self.h_lo, self.h_hi = h_lo, h_hi
        self.r_end = r_end
        self.slots, self.og = {}, {}
        self.next = 0
        ext = h_hi - h_lo
        self.ahead = s3.bwd_lookahead(ext, rule_h[0], rule_h[1], plan.ring)
        assert self.ahead >= 1
        self.ahead = min(self.ahead, 8)
        for k in range(self.ahead):
            if r_begin + k < r_end:
                self.request(r_begin + k)

    def request(self, r):
        self.og[r % self.plan.ring] = r
        lo, hi = s3.bwd_source_range(r, self.h_lo, self.h_hi, self.rule,
                                     self.hs)
        self.next = max(self.next, lo)
        while self.next <= hi:
            self.slots[self.next % self.plan.ring] = self.next
            self.next += 1
        assert len(set(self.slots.values())) <= self.plan.ring

    def start_row(self, r):
        if r + self.ahead < self.r_end:
            self.request(r + self.ahead)

    def check(self, rows, r):
        for q in rows[rows >= 0].tolist():
            assert self.slots.get(q % self.plan.ring) == q  # never overwritten
        if self.plan.og_rows:
            assert self.og.get(r % self.plan.ring) == r


def _emulate(src, og, shift, dst_shape, stride, padding, quantize,
             direction, plan, dtype):
    """The kernels' decomposition on float64 tensors. src: x for the
    forward and the shift gradient, og for the input gradient; ``dtype``:
    the compute dtype the kernel rounds the float32 shift to. Returns
    (result, set of routes)."""
    c = shift.shape[1]
    sg = direction == SHIFT_GRAD
    rules = [s3.bwd_axis_rule(stride[a], padding[a], direction)
             for a in range(3)]
    sr = shift.to(dtype).double()  # the kernel's round_to<T>
    taps = [s3.bwd_channel_taps(sr[a], direction, quantize)
            for a in range(3)]
    n_all, ts, hs, ws = src.shape[:4]
    td_all, hd, wd = dst_shape[1:4]
    seg = -(-wd // plan.cols)
    routes = set()
    if not sg:  # one value per destination element, each written once
        result = torch.full(dst_shape, float("nan"), dtype=torch.float64)
    bands = -(-hd // plan.rows)
    units = n_all * td_all * bands
    assert units == plan.units
    partial = torch.full((units, 3, c), float("nan"), dtype=torch.float64)
    for g in range(plan.groups):
        chs = torch.arange(g * plan.group, min((g + 1) * plan.group, c))
        lo_t, hi_t, w0_t, w1_t = (v[chs] for v in taps[0])
        lo_h, hi_h, w0_h, w1_h = (v[chs] for v in taps[1])
        lo_w, hi_w, a0, a1 = (v[chs] for v in taps[2])
        t_lo, t_hi = int(lo_t.min()), int(hi_t.max())
        h_lo, h_hi = int(lo_h.min()), int(hi_h.max())
        staged = plan.ring > 0 and (
            s3.bwd_frames_needed(t_hi - t_lo, rules[0][1]) <= plan.frames
            and s3.bwd_rows_needed(h_hi - h_lo, rules[1][0], rules[1][1])
            <= plan.ring)
        routes.add("staged" if staged else "direct")
        for unit in range(units):  # a block each
            td, rest = unit % td_all, unit // td_all
            n, band = rest // bands, rest % bands
            r_begin = band * plan.rows
            r_end = min(r_begin + plan.rows, hd)
            f_lo, f_hi = s3.bwd_source_range(td, t_lo, t_hi, rules[0], ts)
            tt = _cells(td, rules[0], lo_t, hi_t, w0_t, w1_t, ts, not sg)
            ring = (_Ring(plan, rules[1], h_lo, h_hi, hs, r_begin, r_end)
                    if staged else None)
            sums = torch.zeros((plan.cols, 3, len(chs)), dtype=torch.float64)
            for r in range(r_begin, r_end):
                th = _cells(r, rules[1], lo_h, hi_h, w0_h, w1_h, hs, not sg)
                if ring is not None:
                    ring.start_row(r)
                    for frame, _ in tt:
                        ok = frame >= 0
                        assert bool(((frame[ok] >= f_lo)
                                     & (frame[ok] <= f_hi)).all())
                        assert f_hi - f_lo + 1 <= plan.frames
                    for row, _ in th:
                        ring.check(row, r)
                args = (src, n, tt, th, chs, rules[2], lo_w, hi_w, a0, a1,
                        ws)
                if sg:
                    _shift_grad_row(*args, og[n, td, r][:, chs], seg, sums)
                else:
                    result[n, td, r, :, chs] = _lerp_row(*args, wd).T
            partial[unit, :, chs] = _ordered(sums)
    if sg:
        result = _final_sum(partial)
    return result, routes


def _ordered(terms):
    """0 + terms[0] + terms[1] + ... in that order (terms along the first
    axis of a tensor, or a list of tensors)."""
    acc = torch.zeros_like(terms[0]) if len(terms) else 0.0
    for v in terms:
        acc = acc + v
    return acc


def _final_sum(partial, parts=16):
    """The second launch: the partials summed over the units, each
    output's units split into ``parts`` contiguous ranges summed in order,
    the ranges added in order."""
    units = partial.shape[0]
    zero = torch.zeros_like(partial[0])
    return _ordered([zero + _ordered(partial[k * units // parts:
                                             (k + 1) * units // parts])
                     for k in range(parts)])


def _corners(src, n, tt, th, chs):
    """The four (T tap a, H tap b) corners of a row: a function of a
    source column index (per channel) that gathers all four at once, zero
    where a tap reads nothing, as (4, C_group) in the order 2a + b."""
    frame = torch.stack([tt[a][0] for a in (0, 1) for _ in (0, 1)])
    row = torch.stack([th[b][0] for _ in (0, 1) for b in (0, 1)])
    ok = (frame >= 0) & (row >= 0)
    frame, row = torch.where(ok, frame, -1), torch.where(ok, row, -1)
    return lambda i: _gather(src, n, frame, row, i, chs)


def _lerp_row(src, n, tt, th, chs, rule_w, lo_w, hi_w, a0, a1, ws, wd):
    """One destination row of the forward or the input gradient,
    (C_group, wd)."""
    mul, div, off = rule_w
    corners = _corners(src, n, tt, th, chs)
    wt = torch.stack([tt[a][1] * th[b][1] for a in (0, 1) for b in (0, 1)])

    def col(i):
        return (wt * corners(i)).sum(0)

    base = off + lo_w  # raw coordinate q = w * mul + base
    out = []
    if mul > 1:  # the forward's strided walk: each column its cells q, q + 1
        for w in range(wd):
            q = w * mul + base
            out.append(a1 * col(q + 1) + a0 * col(q))
    elif div == 1:  # cells q and q + 1, carried from column to column
        prev = col(base)
        for w in range(wd):
            nxt = col(w + base + 1)
            out.append(a1 * nxt + a0 * prev)
            prev = nxt
    elif div == 2:  # the parity rule: one cell (q + 1) >> 1
        for w in range(wd):
            q = w + base
            out.append(torch.where(q % 2 == 1, a1, a0) * col((q + 1) // 2))
    else:  # the walker of q mod div
        q = base
        d = torch.div(q, div, rounding_mode="floor")
        m = q - d * div
        for w in range(wd):
            wgt = torch.where(m == 0, a0, torch.where(m == div - 1, a1,
                                                      torch.zeros(())))
            out.append(wgt * col(d + (m == div - 1).long()))
            m = m + 1
            d = torch.where(m == div, d + 1, d)
            m = torch.where(m == div, 0, m)
    return torch.stack(out, 1)


def _shift_grad_row(src, n, tt, th, chs, rule_w, lo_w, hi_w, a0, a1, ws,
                    og_row, seg, sums):
    """Adds one output row's og times the three derivatives to the
    per-thread sums (cols, 3, C_group), each column run in column order."""
    mul, _, off = rule_w
    corners = _corners(src, n, tt, th, chs)
    # Per corner (T tap a, H tap b) its weight in P, Q and L: (3, 4, C).
    weights = torch.stack([
        torch.stack([th[b][1] if a else -th[b][1] for a in (0, 1)
                     for b in (0, 1)]),
        torch.stack([tt[a][1] if b else -tt[a][1] for a in (0, 1)
                     for b in (0, 1)]),
        torch.stack([tt[a][1] * th[b][1] for a in (0, 1) for b in (0, 1)])])

    def col3(i):
        return (weights * corners(i)).sum(1)

    d = hi_w - lo_w  # 1, or 2 at an integer remainder
    wd = og_row.shape[0]
    for ty in range(sums.shape[0]):
        w_begin, w_end = min(ty * seg, wd), min(ty * seg + seg, wd)
        if w_begin >= w_end:
            continue
        i = w_begin * mul + off + lo_w
        if mul == 1:  # a window of three source columns slides along
            c0, c1 = col3(i), col3(i + 1)
        for w in range(w_begin, w_end):
            if mul == 1:
                c2 = col3(i + 2)
                lo, hi = c0, torch.where(d == 2, c2, c1)
                c0, c1 = c1, c2
                i = i + 1
            else:
                lo, hi = col3(i), col3(i + d)
                i = i + mul
            u = og_row[w]
            sums[ty, 0] += u * (a1 * hi[0] + a0 * lo[0])
            sums[ty, 1] += u * (a1 * hi[1] + a0 * lo[1])
            sums[ty, 2] += u * (hi[2] - lo[2])


def _small_plan(x_shape, og_shape, stride, direction, itemsize=8):
    return s3._bwd_plan(tuple(x_shape), tuple(og_shape), tuple(stride),
                        itemsize, direction, 16, SMALL_KNOBS)


def _src_dst(direction, x, og):
    """The source tensor a direction stages and its destination's shape."""
    if direction == INPUT_GRAD:
        return _t(og), x.shape
    return _t(x), og.shape


# Quantize does not enter the shift gradient: it takes cases 0-2.
DIRECTIONS = [(case, direction) for case in range(len(CASES))
              for direction in s3.DIRECTIONS
              if direction != SHIFT_GRAD or not CASES[case]["quantize"]]


@pytest.mark.parametrize("kind", sorted(SHIFTS))
@pytest.mark.parametrize("case,direction", DIRECTIONS)
def test_decomposition_equals_plain_and_jax(case, direction, kind):
    cfg = CASES[case]
    x, og, s = _inputs(cfg, kind, seed=200 + case)
    args = (cfg["stride"], cfg["padding"])
    plan = _small_plan(x.shape, og.shape, cfg["stride"], direction)
    assert plan.groups > 1 and plan.bands > 1 and plan.ring > 0
    s32 = _t(s).float()
    src, dst_shape = _src_dst(direction, x, og)
    got, routes = _emulate(src, _t(og), s32, dst_shape, *args,
                           cfg["quantize"], direction, plan, torch.float32)
    sd = s32.double()
    scale = 1.0
    if direction != SHIFT_GRAD:
        assert not torch.isnan(got).any()  # every element written once
    if direction == INPUT_GRAD:
        want = s3.shift3d_input_grad_plain(_t(og), sd, x.shape, *args,
                                           cfg["quantize"])
        jax_want = jshift3d.rubiks_shift_3d_input_grad(
            jnp.asarray(og), jnp.asarray(sd.numpy()), x.shape, *args,
            cfg["quantize"], backend="gather")
    elif direction == FORWARD:
        want = s3.shift3d_plain(_t(x), sd, *args, cfg["quantize"])
        jax_want = jshift3d.rubiks_shift_3d_forward(
            jnp.asarray(x), jnp.asarray(sd.numpy()), *args, cfg["quantize"],
            backend="gather")
    else:
        want = s3.shift3d_shift_grad_plain(_t(og), _t(x), sd, *args)
        jax_want = jshift3d.rubiks_shift_3d_shift_grad(
            jnp.asarray(og), jnp.asarray(x), jnp.asarray(sd.numpy()), *args,
            backend="gather")
        scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=TOL_PLAIN * scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_want), rtol=0,
                               atol=TOL_JAX * scale)
    # Shifts of +-12 in the first group exceed the ring: that group reads
    # directly, the others stay staged (and so does every group of the
    # other kinds, but for DIRECT_WITHOUT_FAR).
    far = kind == "far" or (case, direction, kind) in DIRECT_WITHOUT_FAR
    assert routes == ({"staged", "direct"} if far else {"staged"})


# Case 4's "half" shifts put -2 and +2.5 on the T axis of one channel group.
# Quantized, the forward rounds the tie +2.5 up to tap 3 (hi 4), so that
# group's taps span cells -2 to 4: 7 frames where SMALL_KNOBS' ring holds 6,
# and it reads directly. The input gradient's taps of the negated shifts
# span -2 to 3 and stay staged. The edge itself:
# test_quantized_ties_at_the_ring_edge.
DIRECT_WITHOUT_FAR = {(4, FORWARD, "half")}


@pytest.mark.parametrize("direction,pair,route", [
    (FORWARD, (-2.0, 2.5), "direct"),
    (FORWARD, (-2.0, 2.4), "staged"),
    (FORWARD, (-1.5, 2.5), "staged"),
    (INPUT_GRAD, (-2.0, 2.5), "staged"),
    (INPUT_GRAD, (-2.5, 2.0), "direct"),
])
def test_quantized_ties_at_the_ring_edge(direction, pair, route):
    """SMALL_KNOBS' ring holds 6 frames, a tap extent of 5. A quantized tie
    rounds up in the direction in which the kernel reads (s for the
    forward, -s for the input gradient): beside an integer -2 in its group
    that tie makes the T taps span 7 frames, and the group reads directly;
    one step inside the edge it stays staged. The other group is staged
    either way, and the result equals the plain form."""
    cfg = CASES[3]  # stride 1, quantized
    x, og, s = _inputs(cfg, "fractional", seed=11)
    s = np.clip(s, -1.0, 1.0)
    s[0, :2] = pair
    s32 = _t(s).float()
    args = (cfg["stride"], cfg["padding"])
    plan = _small_plan(x.shape, og.shape, cfg["stride"], direction)
    assert plan.group >= 2 and plan.groups > 1
    src, dst_shape = _src_dst(direction, x, og)
    got, routes = _emulate(src, _t(og), s32, dst_shape, *args, True,
                           direction, plan, torch.float32)
    assert routes == ({"staged", "direct"} if route == "direct"
                      else {"staged"})
    sd = s32.double()
    if direction == FORWARD:
        want = s3.shift3d_plain(_t(x), sd, *args, True)
    else:
        want = s3.shift3d_input_grad_plain(_t(og), sd, x.shape, *args, True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=TOL_PLAIN)


@pytest.mark.parametrize("direction", s3.DIRECTIONS)
def test_decomposition_rounds_the_shift_to_the_compute_dtype(direction):
    """The kernel takes the float32 parameter and rounds it to the compute
    dtype itself (round to nearest even, as Tensor.to): the emulation with
    a bfloat16 compute dtype equals the plain forms fed the rounded
    shift."""
    cfg = CASES[1]
    x, og, s = _inputs(cfg, "fractional", seed=7)
    s[:, 0] = [0.30078125 + 2**-10, -1.00390625, 2.0 - 2**-9]  # ties, near 1
    s32 = _t(s).float()
    args = (cfg["stride"], cfg["padding"])
    plan = _small_plan(x.shape, og.shape, cfg["stride"], direction)
    src, dst_shape = _src_dst(direction, x, og)
    got, _ = _emulate(src, _t(og), s32, dst_shape, *args, False, direction,
                      plan, torch.bfloat16)
    rounded = s32.to(torch.bfloat16).double()
    assert not torch.equal(rounded, s32.double())
    if direction == INPUT_GRAD:
        want = s3.shift3d_input_grad_plain(_t(og), rounded, x.shape, *args)
    elif direction == FORWARD:
        want = s3.shift3d_plain(_t(x), rounded, *args)
    else:
        want = s3.shift3d_shift_grad_plain(_t(og), _t(x), rounded, *args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=TOL_PLAIN * float(want.abs().max()))


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_emulated_walks_cover_every_stride(stride):
    """The input gradient's column walks (carry at stride 1, parity at 2,
    the walker at 3), the forward's (carry at stride 1, each column's own
    two cells at 2 and 3) and the shift gradient's at a strided W, one row
    of each, against the plain forms with T = H = 1."""
    rng = np.random.default_rng(stride)
    c = 8
    shape = (1, 1, 1, 11, c)
    st, pad = (1, 1, stride), (0, 0, stride - 1)
    og_shape = s3.compute_output_shape_3d(shape, st, pad)
    x, og = rng.standard_normal(shape), rng.standard_normal(og_shape)
    s = np.full((3, c), 0.25)
    s[2] = np.r_[rng.uniform(-2.6, 2.6, c - 4), -1.0, 0.0, 2.0, -0.5]
    for direction in s3.DIRECTIONS:
        plan = _small_plan(shape, og_shape, st, direction)
        src, dst_shape = _src_dst(direction, x, og)
        got, _ = _emulate(src, _t(og), _t(s).float(), dst_shape, st, pad,
                          False, direction, plan, torch.float32)
        sd = _t(s).float().double()
        want = (s3.shift3d_input_grad_plain(_t(og), sd, shape, st, pad)
                if direction == INPUT_GRAD else
                s3.shift3d_plain(_t(x), sd, st, pad)
                if direction == FORWARD else
                s3.shift3d_shift_grad_plain(_t(og), _t(x), sd, st, pad))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=TOL_PLAIN * float(want.abs().max()))


@pytest.mark.parametrize("quantize", [False, True])
def test_decomposition_matches_the_pallas_kernels(quantize):
    """Stride 1, float32: the forward against rubiks_shift3d_pallas, the
    input gradient against rubiks_shift3d_pallas(inverse=True) and the
    shift gradient against rubiks_shift3d_shift_grad_pallas, all in
    interpret mode."""
    rng = np.random.default_rng(30 + quantize)
    x = rng.standard_normal((1, 2, 4, 5, 16)).astype(np.float32)
    og = rng.standard_normal(x.shape).astype(np.float32)
    s = rng.uniform(-0.95, 0.95, (3, 16)).astype(np.float32)
    stride = (1, 1, 1)
    fwd_plan = _small_plan(x.shape, og.shape, stride, FORWARD, 4)
    got, _ = _emulate(_t(x).double(), _t(og).double(), _t(s), og.shape,
                      stride, (0, 0, 0), quantize, FORWARD, fwd_plan,
                      torch.float32)
    want = np.asarray(rubiks_shift3d_pallas(
        jnp.asarray(x), jnp.asarray(s), 1, quantize, inverse=False,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    inv_plan = _small_plan(x.shape, og.shape, stride, INPUT_GRAD, 4)
    got, _ = _emulate(_t(og).double(), _t(og).double(), _t(s), x.shape,
                      stride, (0, 0, 0), quantize, INPUT_GRAD, inv_plan,
                      torch.float32)
    want = np.asarray(rubiks_shift3d_pallas(
        jnp.asarray(og), jnp.asarray(s), 1, quantize, inverse=True,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if quantize:
        return
    s[:, ::4] = np.round(s[:, ::4])  # the corrected taps
    sg_plan = _small_plan(x.shape, og.shape, stride, SHIFT_GRAD, 4)
    got, _ = _emulate(_t(x).double(), _t(og).double(), _t(s), og.shape,
                      stride, (0, 0, 0), False, SHIFT_GRAD, sg_plan,
                      torch.float32)
    want = np.asarray(rubiks_shift3d_shift_grad_pallas(
        jnp.asarray(og), jnp.asarray(x), jnp.asarray(s), 1, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("quantize", [False, True])
def test_forward_matches_the_strided_pallas_kernel(quantize):
    """Stride (1, 2, 2), float32: the forward's decomposition (the strided
    W walk, a destination row reading source rows 2r - 1 .. 2r + 2) against
    rubiks_shift_3d_fused, the Pallas kernel of the strided forward, in
    interpret mode; every fourth shift an exact half (quantize's ties)."""
    rng = np.random.default_rng(40 + quantize)
    x = rng.standard_normal((1, 2, 8, 10, 16)).astype(np.float32)
    s = rng.uniform(-0.95, 0.95, (3, 16)).astype(np.float32)
    s[:, ::4] = np.round(s[:, ::4] * 2) / 2
    stride = (1, 2, 2)
    out_shape = s3.compute_output_shape_3d(x.shape, stride, 0)
    plan = _small_plan(x.shape, out_shape, stride, FORWARD, 4)
    got, _ = _emulate(_t(x).double(), None, _t(s), out_shape, stride,
                      (0, 0, 0), quantize, FORWARD, plan, torch.float32)
    want = np.asarray(rubiks_shift_3d_fused(
        jnp.asarray(x), jnp.asarray(s), stride, (0, 0, 0), quantize, 1))
    assert want.shape == tuple(out_shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("c", [54, 108])
@pytest.mark.parametrize("stride", [(1, 1, 1), (1, 2, 2)])
def test_forward_at_the_tiny_widths_with_far_shifts(stride, c):
    """The forward under the port's own plan (its default knobs) at the
    tiny tier's widths, whose copies are 4 bytes wide in bfloat16: shifts of
    +-9 in every other channel of the first eight take the direct-read
    route, the other groups stay staged; every fourth shift an integer."""
    rng = np.random.default_rng(c + stride[1])
    shape = (1, 3, 10, 9, c)
    x = rng.standard_normal(shape)
    s = rng.uniform(-1.8, 1.8, (3, c))
    s[:, ::4] = np.round(s[:, ::4])
    s[:, :8] = s[:, :8] / 2 + 9.0 * (1 - 2 * (np.arange(8) % 2))
    out_shape = s3.compute_output_shape_3d(shape, stride, 0)
    plan = s3.shift3d_bwd_plan(shape, out_shape, stride, torch.bfloat16,
                               FORWARD)
    assert plan.copy_bytes == 4 and plan.ring > 0
    got, routes = _emulate(_t(x), None, _t(s).float(), out_shape, stride,
                           (0, 0, 0), False, FORWARD, plan, torch.float32)
    assert routes == ({"staged", "direct"} if plan.groups > 1
                      else {"direct"})
    want = s3.shift3d_plain(_t(x), _t(s).float().double(), stride)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=TOL_PLAIN)


# ------------------------------------------------------------ the plan


def _plan_cases():
    for batch in (1, 8, 32):
        for h, c, st in LARGE:
            yield (batch, 8, h, h, c), (1, st, st)
    yield (2, 8, 28, 28, 54), (1, 1, 1)
    yield (2, 8, 14, 14, 108), (1, 2, 2)
    yield (3, 5, 13, 11, 72), (1, 2, 2)
    yield (2, 8, 14, 14, 144), (2, 2, 2)


@pytest.mark.parametrize("direction", s3.DIRECTIONS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_every_element_once_and_fits_the_card(dtype, direction):
    inverse, sg = direction == INPUT_GRAD, direction == SHIFT_GRAD
    for x_shape, stride in _plan_cases():
        og_shape = s3.compute_output_shape_3d(x_shape, stride, (0, 0, 0))
        plan = s3.shift3d_bwd_plan(x_shape, og_shape, stride, dtype,
                                   direction)
        again = s3.shift3d_bwd_plan(list(x_shape), og_shape, list(stride),
                                    dtype, direction)
        assert plan == again  # a pure function of its arguments
        n, td, hd, wd, c = x_shape if inverse else og_shape
        src = og_shape if inverse else x_shape
        item = dtype.itemsize
        # Bands, groups and column runs cover the destination once.
        assert plan.rows * plan.bands >= hd > plan.rows * (plan.bands - 1)
        assert plan.group * plan.groups >= c > plan.group * (plan.groups - 1)
        assert plan.units == n * td * plan.bands
        seg = -(-wd // plan.cols)
        assert seg * plan.cols >= wd
        # The copies divide a pixel's bytes and the group's.
        assert (c * item) % plan.copy_bytes == 0
        assert (plan.group * item) % plan.copy_bytes == 0
        # Shared memory and threads within the H100's.
        assert plan.threads == plan.group * plan.cols <= s3.BWD_MAX_THREADS
        pitch = -(-src[3] * plan.group * item // 16) * 16
        og_pitch = -(-wd * plan.group * item // 16) * 16
        assert plan.og_rows in (0, plan.ring) and not (not sg
                                                       and plan.og_rows)
        assert plan.smem_bytes == (s3.BWD_SMEM_HEAD + plan.frames * plan.ring
                                   * pitch + plan.og_rows * og_pitch
                                   + (12 * plan.threads if sg else 0))
        assert plan.smem_bytes <= min(H100_SMEM, s3.BWD_SMEM_BUDGET)
        # Large's shapes stage (shifts within (-1, 1), integers for K4).
        ext = s3.SG_EXTENT if sg else s3.BWD_EXTENT
        rule_h = s3.bwd_axis_rule(stride[1], 0, direction)
        assert plan.ring >= s3.bwd_rows_needed(ext, rule_h[0], rule_h[1])


def test_plan_thread_cap_is_the_kernels_launch_bound():
    # The plan caps a block at BWD_MAX_THREADS; the kernels are compiled
    # for at most kMaxThreads (their __launch_bounds__) and refuse more.
    found = re.findall(r"constexpr int kMaxThreads = (\d+);",
                       KERNEL_SOURCE.read_text())
    assert found == [str(s3.BWD_MAX_THREADS)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_copy_width_follows_the_alignment_of_every_source(dtype):
    item = dtype.itemsize
    n = 2 * 2 * 4 * 4 * 8
    buf = torch.zeros(n + 16, dtype=dtype)

    def view(offset):  # contiguous, starting ``offset`` elements in
        return buf[offset:offset + n].view(2, 2, 4, 4, 8)

    assert s3._copy_limit(view(0)) == 16
    assert s3._copy_limit(view(0), view(16 // item)) == 16
    assert s3._copy_limit(view(0), view(4 // item)) == 4
    if item == 2:
        assert s3._copy_limit(view(0), view(1)) == 2
        assert s3._copy_limit(view(1), view(0)) == 2
    for limit in (16, 4, item):
        plan = s3.shift3d_bwd_plan((2, 2, 4, 4, 8), (2, 2, 4, 4, 8), 1,
                                   dtype, SHIFT_GRAD, limit)
        assert plan.copy_bytes <= max(limit, item)


def test_shift_grad_copy_width_covers_og(monkeypatch):
    # The shift gradient copies og's rows with the width it copies x's:
    # the wrapper takes the width both allow.
    seen = []

    class Stop(Exception):
        pass

    def prepare(*args):
        seen.append(args[-1])
        raise Stop

    monkeypatch.setattr(s3, "_check_staged", lambda *a: None)
    monkeypatch.setattr(s3, "_bwd_prepare", prepare)
    buf = torch.zeros(2 * 2 * 4 * 4 * 8 + 8, dtype=torch.bfloat16)
    x = buf[:512].view(2, 2, 4, 4, 8)
    og = buf[1:513].view(2, 2, 4, 4, 8)
    s = torch.zeros(3, 8)
    for fn in (lambda: s3.shift3d_shift_grad_kernel(og, x, s),
               lambda: s3.shift3d_input_grad_kernel(og, s, x.shape),
               lambda: s3.shift3d_kernel(og, s)):
        with pytest.raises(Stop):
            fn()
    assert seen == [2, 2, 2]


def test_plan_refuses_a_clip_of_2_to_the_31_elements():
    shape = (1, 8, 1 << 12, 1 << 9, 128)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        s3.shift3d_bwd_plan(shape, shape, 1, torch.bfloat16, INPUT_GRAD)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(1, 2, 4, 4, 6)
    s = torch.zeros(3, 6)
    for fn in (lambda a, b, **kw: s3.shift3d_kernel(a, b, **kw),
               lambda a, b, **kw: s3.shift3d_input_grad_kernel(
                   a, b, a.shape, **kw),
               lambda a, b, **kw: s3.shift3d_shift_grad_kernel(a, a, b,
                                                               **kw)):
        with pytest.raises(ValueError, match="unknown route"):
            fn(x, s, route="fast")
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, s)
        with pytest.raises(ValueError, match=r"must be \(3, C\)"):
            fn(x, torch.zeros(2, 6))
    # The 2D rounding mode (``quantize_mode``) is gone from the 3D shift's
    # kernels, on either route: the port's 2D shift has kernels of its own.
    for route in s3.BWD_ROUTES:
        with pytest.raises(TypeError, match="quantize_mode"):
            s3.shift3d_kernel(x, s, quantize=True, quantize_mode="half_away",
                              route=route)
        with pytest.raises(TypeError, match="quantize_mode"):
            s3.shift3d_input_grad_kernel(x, s, x.shape, quantize=True,
                                         quantize_mode="half_away",
                                         route=route)
    assert not hasattr(s3, "quantize_code")
    # The shapes are held against each other once per configuration, where
    # the launch is prepared (after the device check).
    for direction in s3.DIRECTIONS:
        with pytest.raises(ValueError, match="not the output shape"):
            s3._bwd_prepare(direction, (1, 2, 4, 4, 6), (1, 2, 9, 9, 6),
                            (1, 2, 2), (0, 0, 0), torch.float32, 16)
    with pytest.raises(ValueError, match="unknown direction"):
        s3.shift3d_bwd_plan((1, 2, 4, 4, 6), (1, 2, 4, 4, 6), 1,
                            torch.float32, True)
    assert s3.LAUNCHES.count == 0
    assert s3.INVERSE_LAUNCHES.count == 0
    assert s3.SHIFT_GRAD_LAUNCHES.count == 0
