"""The launch plan of K3's tensor-core kernels
(rubiksnet_torch.ops.fused_entry.fused_entry_plan) and a Python emulation of
the decomposition those kernels use (csrc/fused_entry_tc.cu), held against
the plain version.

The CUDA kernels run only on the card. What can be checked on the CPU is
what surrounds their arithmetic: the plan's numbers (shared memory, column
chunks, routes) for every entry shape of every tier at the served batch
sizes, and the decomposition itself, written out here step by step as the
kernels do it. Launch A: persistent row tiles over the full-resolution rows,
K (Cin) padded to 16 with zeros, column chunks of W2, the bn2/relu store.
Launch B: row tiles over the output rows; an A tile whose columns [0, Cm)
are the stride-2 gather from K2's per-channel tap table (first non-zero tap
offset and two weights per axis, a flag for taps that are not two adjacent
ones), walked in runs of sixteen output rows line by line with two source
columns of four corners each per pixel and predicates for the zero fill at
clip, frame and line borders, the general loop for wide taps, the gate
multiply; whose columns [Cm, Cm + Cin) are the shortcut relu(s1 . x + b1)
at (t, 2h', 2w'); zero past that up to the padded depth; and one resident
W = [W3; Wsc] in column chunks, stored as it comes. Where those chunks are
more than one, a pre-pass gathers the operand rows once into a stage and
launch B's tiles copy them.

Tolerance: the inputs are dyadic (integers, shifts that are multiples of
1/4), so every float32 sum is exact in any order and the emulation must
equal ``fused_entry_plain`` bit for bit. With the SE gate the gated operand
is no longer dyadic and the two sides multiply by W3 in another order:
rtol/atol 1e-5."""

import numpy as np
import pytest
import torch

from rubiksnet_torch.models.rubiksnet import TIERS
from rubiksnet_torch.ops import fused_block as fb
from rubiksnet_torch.ops import fused_entry as fe
from test_torch_fused_block_plan import RUN, kernel_padding, tap_table

torch.set_num_threads(1)

SMS = 132
SIZE, FRAMES = 224, 8


def entry_shapes(width):
    """(input H, Cin, Cm) of a tier's four entry blocks at 224 px."""
    return [(112, width, width), (56, width, 2 * width),
            (28, 2 * width, 4 * width), (14, 4 * width, 8 * width)]


# ------------------------------------------------------------- (a) the plan


@pytest.mark.parametrize("sms", [SMS, 114])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("tier", ["large", "small", "tiny"])
def test_plan_of_every_entry_shape(tier, batch, dtype, sms):
    """Large and Small (width 72) and tiny (54), 8 frames at 224 px, on the
    132 SMs of the H100 SXM and the 114 of the PCIe card."""
    width = TIERS[tier][0]
    for h, cin, cm in entry_shapes(width):
        shape = (batch, FRAMES, h, h, cin)
        p = fe.fused_entry_plan(shape, cm, dtype, sms=sms)
        if dtype == torch.float32:
            assert p == fe.EntryPlan("simt") and p.describe() == "simt"
            continue
        assert p.route == "mma"
        rows = {"a": batch * FRAMES * h * h,
                "b": batch * FRAMES * (h // 2) * (h // 2)}
        # Launch B keeps the gather's table unless a pre-pass gathers.
        depth = {"a": (cin, 0), "b": (cm + cin, 0 if p.g else cm)}
        for name, lp in (("a", p.a), ("b", p.b)):
            k, table = depth[name]
            assert lp.route == "mma" and lp.overlap and lp.grid_x >= 1
            # The plan fits the 232,448 bytes a block can use, and the C
            # side's formula (csrc/fused_entry_tc.cuh::entry_smem_bytes).
            assert lp.smem_bytes <= fb.SMEM_LIMIT == 232448
            assert lp.smem_bytes == fb._mma_smem(
                lp.producers, lp.warps_m, lp.warps_n, cm, k, table)
            assert 32 * (lp.producers + lp.warps_m * lp.warps_n) <= 512
            # The column chunks cover Cm, none is empty.
            n_pad = kernel_padding(cm)[1]
            assert lp.n_tiles * lp.chunk_cols >= n_pad
            assert (lp.n_tiles - 1) * lp.chunk_cols < n_pad
            assert lp.grid_x <= max(1, -(-rows[name] // lp.rows))
            # A launch with column chunks runs in one wave.
            room = sms * fb.blocks_per_sm(
                lp.smem_bytes, lp.producers + lp.warps_m * lp.warps_n)
            assert lp.n_tiles == 1 or lp.grid_x * lp.n_tiles <= room
        # W2 resident whole up to 144 -> 288, in chunks at 288 -> 576;
        # [W3; Wsc] whole up to 72 -> 144, in chunks from 144 -> 288 on.
        assert (p.a.n_tiles == 1) == (cm <= 4 * width)
        if width == 72:
            assert (p.b.n_tiles == 1) == (cm <= 2 * width)
        # The gather pre-pass exactly where launch B's weights are chunked:
        # there every chunk would gather the same rows again.
        assert (p.g is not None) == (p.b.n_tiles > 1)
        if p.g:
            assert p.g.rows % 16 == 0 and 1 <= p.g.grid_x <= sms
            assert p.g.smem_bytes == 8 * 4 * kernel_padding(cm)[0]
            assert len(p.as_ints()) == 16 and p.as_ints()[12:15] == [
                p.g.rows, p.g.grid_x, p.g.smem_bytes]
        # The taps and the gate do not enter the plan.
        assert fe.fused_entry_plan(shape, cm, dtype, sms=sms) is p


# K3's plans at 224 px, 8 frames, 132 SMs, as the port has made them since
# before K2 ran on a ring of stages (K3 shares the rule of
# fused_block._mma_defaults, which K2 no longer takes): per entry block
# (input H, Cin, Cm) of entry_shapes, the 16 numbers of
# fused_entry_plan(...).as_ints() (launch A's producers, warps_m, warps_n,
# n_tiles, grid_x, smem_bytes, launch B's, the gather pre-pass's rows,
# grid_x, smem_bytes, overlap).
K3_PLANS = {
    (54, 1): [
        (0, 4, 1, 1, 528, 20480, 0, 4, 1, 1, 392, 37120, 0, 0, 0, 1),
        (0, 4, 2, 1, 264, 28672, 0, 4, 2, 1, 98, 80640, 0, 0, 0, 1),
        (0, 4, 4, 1, 98, 81664, 12, 2, 2, 2, 49, 146176, 32, 49, 7168, 1),
        (0, 2, 4, 2, 49, 147456, 12, 2, 1, 6, 13, 200448, 32, 13, 13824, 1)],
    (54, 8): [
        (0, 4, 1, 1, 528, 20480, 0, 4, 1, 1, 528, 37120, 0, 0, 0, 1),
        (0, 4, 2, 1, 264, 28672, 0, 8, 2, 1, 132, 104192, 0, 0, 0, 1),
        (0, 4, 4, 1, 132, 81664, 0, 2, 4, 1, 132, 228096, 0, 0, 0, 1),
        (0, 4, 4, 2, 66, 162304, 12, 2, 1, 6, 22, 200448, 32, 98, 13824, 1)],
    (54, 32): [
        (0, 4, 1, 1, 528, 20480, 0, 4, 1, 1, 528, 37120, 0, 0, 0, 1),
        (0, 4, 2, 1, 264, 28672, 0, 8, 2, 1, 132, 104192, 0, 0, 0, 1),
        (0, 4, 4, 1, 132, 81664, 0, 2, 4, 1, 132, 228096, 0, 0, 0, 1),
        (0, 4, 4, 2, 66, 162304, 12, 2, 1, 6, 22, 200448, 32, 132, 13824,
         1)],
    (54, 64): [
        (0, 4, 1, 1, 528, 20480, 0, 4, 1, 1, 528, 37120, 0, 0, 0, 1),
        (0, 4, 2, 1, 264, 28672, 0, 8, 2, 1, 132, 104192, 0, 0, 0, 1),
        (0, 4, 4, 1, 132, 81664, 0, 2, 4, 1, 132, 228096, 0, 0, 0, 1),
        (0, 4, 4, 2, 66, 162304, 12, 2, 1, 6, 22, 200448, 32, 132, 13824,
         1)],
    (72, 1): [
        (0, 4, 1, 1, 528, 25344, 0, 4, 1, 1, 392, 47360, 0, 0, 0, 1),
        (0, 4, 2, 1, 264, 35584, 0, 4, 2, 1, 98, 102400, 0, 0, 0, 1),
        (0, 4, 4, 1, 98, 104704, 12, 2, 2, 2, 49, 187648, 32, 49, 9216, 1),
        (0, 2, 4, 2, 49, 189440, 12, 1, 1, 8, 16, 207872, 32, 13, 18432, 1)],
    (72, 8): [
        (0, 4, 1, 1, 528, 25344, 0, 4, 1, 1, 528, 47360, 0, 0, 0, 1),
        (0, 4, 2, 1, 264, 35584, 0, 8, 2, 1, 132, 132096, 0, 0, 0, 1),
        (0, 4, 4, 1, 132, 104704, 12, 2, 2, 2, 66, 187648, 32, 132, 9216, 1),
        (0, 4, 4, 2, 66, 208384, 12, 1, 1, 8, 16, 207872, 32, 98, 18432, 1)],
    (72, 32): [
        (0, 4, 1, 1, 528, 25344, 0, 4, 1, 1, 528, 47360, 0, 0, 0, 1),
        (0, 4, 2, 1, 264, 35584, 0, 8, 2, 1, 132, 132096, 0, 0, 0, 1),
        (0, 4, 4, 1, 132, 104704, 12, 2, 2, 2, 66, 187648, 32, 132, 9216, 1),
        (0, 4, 4, 2, 66, 208384, 12, 1, 1, 8, 16, 207872, 32, 132, 18432,
         1)],
    (72, 64): [
        (0, 4, 1, 1, 528, 25344, 0, 4, 1, 1, 528, 47360, 0, 0, 0, 1),
        (0, 4, 2, 1, 264, 35584, 0, 8, 2, 1, 132, 132096, 0, 0, 0, 1),
        (0, 4, 4, 1, 132, 104704, 12, 2, 2, 2, 66, 187648, 32, 132, 9216, 1),
        (0, 4, 4, 2, 66, 208384, 12, 1, 1, 8, 16, 207872, 32, 132, 18432,
         1)],
}


@pytest.mark.parametrize("width,batch", sorted(K3_PLANS))
def test_k3_plans_are_unchanged(width, batch):
    """Every entry shape of every tier (tiny: 54; small, medium, large: 72)
    at batch 1, 8, 32 and 64: launch A, launch B and the gather pre-pass
    exactly as the table has them, whatever K2's rule does."""
    got = [tuple(fe.fused_entry_plan((batch, FRAMES, h, h, cin), cm,
                                     torch.bfloat16, sms=SMS).as_ints())
           for h, cin, cm in entry_shapes(width)]
    assert {TIERS[t][0] for t in TIERS} == {54, 72}
    assert got == K3_PLANS[width, batch]


def test_plan_of_large_at_batch_8():
    """The plans the serving path runs, as PERF.md records them."""
    bf = torch.bfloat16

    def launches(h, cin, cm):
        p = fe.fused_entry_plan((8, 8, h, h, cin), cm, bf, sms=SMS)
        return [(lp.producers, lp.warps_m, lp.warps_n, lp.n_tiles)
                for lp in (p.a, p.b)]

    # At most 4 row warps where every warp multiplies (the rule they adjust
    # takes 16 at 112 x 112 x 72).
    assert launches(112, 72, 72) == [(0, 4, 1, 1), (0, 4, 1, 1)]
    lockstep = fb._mma_plan(8 * 8 * 112 * 112, 72, SMS, {})
    assert (lockstep.producers, lockstep.warps_m, lockstep.warps_n) == (
        0, 16, 1)
    assert launches(56, 72, 144) == [(0, 4, 2, 1), (0, 8, 2, 1)]
    # 288 and 576 columns: [W3; Wsc] in chunks, the rows staged by the
    # pre-pass and copied by 12 producer warps; W2 (332 KB) in two chunks
    # of 288 at 576.
    assert launches(28, 144, 288) == [(0, 4, 4, 1), (12, 2, 2, 2)]
    assert launches(14, 288, 576) == [(0, 4, 4, 2), (12, 1, 1, 8)]
    p = fe.fused_entry_plan((8, 8, 14, 14, 288), 576, bf, sms=SMS)
    assert p.g is not None and p.b.grid_x * p.b.n_tiles == 128  # one wave
    assert not fe.fused_entry_plan((8, 8, 56, 56, 72), 144, bf, sms=SMS).g


def test_plan_knobs_and_refusals():
    shape, cm, bf = (8, 8, 28, 28, 144), 288, torch.bfloat16
    p = fe.fused_entry_plan(shape, cm, bf, a_producers=0, a_warps_m=2,
                            a_warps_n=4, b_producers=8, b_warps_m=2,
                            b_warps_n=2, overlap=False)
    assert (p.a.producers, p.a.warps_m, p.a.warps_n) == (0, 2, 4)
    assert (p.b.producers, p.b.rows, p.b.chunk_cols) == (8, 32, 144)
    assert not p.a.overlap and not p.b.overlap and p.as_ints()[-1] == 0
    # Two chunks of 144 columns: the rows come from the pre-pass, no table.
    assert p.g is not None
    assert p.b.smem_bytes == (2 * 32 * fb.tile_row_stride(432) * 2
                              + 432 * fb.tile_row_stride(144) * 2)
    q = fe.fused_entry_plan(shape, cm, bf, b_producers=8, b_warps_m=2,
                            b_warps_n=2, stage=False)
    assert q.g is None and q.b.smem_bytes == p.b.smem_bytes + 8 * 288 * 4
    # The route is the dtype's: bfloat16 always runs the tensor cores, and
    # no ``route`` is taken.
    assert fe.fused_entry_plan(shape, cm, bf).route == "mma"
    assert fe.fused_entry_plan(shape, cm, torch.float32).route == "simt"
    with pytest.raises(ValueError, match="unknown plan knobs"):
        fe.fused_entry_plan(shape, cm, torch.float32, route="mma")
    with pytest.raises(ValueError, match="unknown plan knobs"):
        fe.fused_entry_plan(shape, cm, bf, route="mma")
    with pytest.raises(ValueError, match="unknown plan knobs"):
        fe.fused_entry_plan(shape, cm, bf, warps_m=4)
    with pytest.raises(ValueError, match="unknown plan knobs"):
        fe.fused_entry_plan(shape, cm, bf, c_warps_m=4)
    with pytest.raises(ValueError, match="no tensor-core plan"):
        # [W3; Wsc] at 288 columns (432 x 296 bf16, 256 KB) cannot be
        # resident whole.
        fe.fused_entry_plan(shape, cm, bf, b_warps_m=1, b_warps_n=4)
    with pytest.raises(ValueError, match="H and W even"):
        fe.fused_entry_plan((8, 8, 27, 28, 144), cm, bf)


def test_cuda_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(13)
    params = dyadic_entry(rng, 8, 16, 1, "integer")
    x = torch.zeros((1, 2, 4, 4, 8))
    fe.LAUNCHES.reset()
    with pytest.raises(ValueError, match="CUDA"):
        fe.fused_entry_kernel(x, params, max_shift=1)
    with pytest.raises(ValueError, match="CUDA"):
        fe.fused_entry_kernel(x.bfloat16(), tuple(
            a.bfloat16() if i >= 2 else a for i, a in enumerate(params)),
            max_shift=1)
    assert fe.LAUNCHES.count == 0


# ------------------------------------------------- (b) the decomposition


def output_rows(m0, bm, m_total, dims):
    """Output tile rows clamped to the last row, as (valid, m, frame, t,
    h', w', the full-resolution source row of (frame, 2h', 2w'))."""
    _, t, h, w = dims
    ho, wo = h // 2, w // 2
    m = torch.arange(m0, m0 + bm)
    valid = m < m_total
    mm = torch.where(valid, m, torch.tensor(m_total - 1))
    q = mm // wo
    frame = q // ho
    hh, ww = q % ho, mm % wo
    src = (frame * h + 2 * hh) * w + 2 * ww
    return valid, mm, frame, frame % t, hh, ww, src


def emulate_launch_a(x, mid, vt1, vt2, w2, plan):
    """mid = relu(s2 . (A @ W2) + b2) tile by tile over the full-resolution
    rows; A = relu(s1 . x + b1), K padded to 16 with zeros."""
    m_total, cin = x.shape
    cm = w2.shape[1]
    kp = kernel_padding(cin)[0]
    wp = torch.zeros((kp, plan.n_tiles * plan.chunk_cols))
    wp[:cin, :cm] = w2
    for m0 in range(0, m_total, plan.rows):
        m = torch.arange(m0, m0 + plan.rows)
        valid = m < m_total
        mm = torch.where(valid, m, torch.tensor(m_total - 1))
        a = torch.zeros((plan.rows, kp))
        a[:, :cin] = torch.relu(x[mm] * vt1[0] + vt1[1])
        a[~valid] = 0.
        for j in range(plan.n_tiles):
            n0, n1 = j * plan.chunk_cols, min((j + 1) * plan.chunk_cols, cm)
            acc = a @ wp[:, n0:n1]
            res = torch.relu(acc * vt2[0, n0:n1] + vt2[1, n0:n1])
            mid[mm[valid], n0:n1] = res[valid]


def general_taps_s2(flat, taps, tn, k, dims, c, ch, frame, tt, hh, ww):
    """Channel ch at output (frame, h', w') as the sum over every non-zero
    tap, read around (t, 2h', 2w') (the kernel's gather_taps)."""
    _, t, h, w = dims
    acc = torch.zeros(())
    for jt in range(tn):
        for jh in range(tn):
            for jw in range(tn):
                wgt = (taps[jt, ch] * taps[tn + jh, ch]) * taps[2 * tn + jw,
                                                                 ch]
                ti, hi, wi = tt + jt - k, 2 * hh + jh - k, 2 * ww + jw - k
                if (wgt != 0 and 0 <= ti < t and 0 <= hi < h
                        and 0 <= wi < w):
                    acc = acc + wgt * flat[
                        (((frame - tt + ti) * h + hi) * w + wi) * c + ch]
    return acc


def gather_run_s2(flat, table, dims, c, m_first, nrows):
    """RUN consecutive output rows of every channel as the kernel walks
    them: line by line; per pixel w' the source columns 2w' + ow and
    2w' + ow + 1, each the interpolation along T and H of four corners.
    Returns (RUN, C)."""
    off, wts, _, _ = table
    _, t, h, w = dims
    ho, wo = h // 2, w // 2
    ar = torch.arange(c)
    out = torch.zeros((RUN, c))
    r = 0
    ww, q = m_first % wo, m_first // wo
    hh, frame = q % ho, q // ho
    while r < nrows:
        seg = min(wo - ww, nrows - r)
        tt, hs = frame % t, 2 * hh
        line = ((frame + off[0]) * h + (hs + off[1])) * w * c + ar

        def column(col):
            s = torch.zeros(c)
            for dt in range(2):
                for dh in range(2):
                    ok = ((wts[0, dt] != 0) & (wts[1, dh] != 0)
                          & (tt + off[0] + dt >= 0) & (tt + off[0] + dt < t)
                          & (hs + off[1] + dh >= 0) & (hs + off[1] + dh < h)
                          & (col >= 0) & (col < w))
                    idx = line + col * c + (dt * h + dh) * w * c
                    s = s + (wts[0, dt] * wts[1, dh]) * torch.where(
                        ok, flat[idx.clamp(0, flat.numel() - 1)], 0.)
            return s

        for j in range(seg):
            col = 2 * (ww + j) + off[2]
            out[r + j] = wts[2, 1] * column(col + 1) + wts[2, 0] * column(col)
        r += seg
        ww += seg
        if ww == wo:
            ww, hh = 0, hh + 1
            if hh == ho:
                hh, frame = 0, frame + 1
    return out


def emulate_launch_b(x, mid, out, vt1, vt2, w3, wsc, gate, dims, plan, k,
                     tn):
    """out = ([gate .] shift3d_s2(mid)) @ W3 + relu(s1 . x + b1)[::2, ::2]
    @ Wsc tile by tile over the output rows, one K range of Cm + Cin. With
    the gather pre-pass (``plan.g``) the operand rows are first written to a
    stage in tiles of ``plan.g.rows`` (rows past the last tile's never
    written: NaN here) and launch B's tiles copy them."""
    n, t, h, w = dims
    cin, cm = wsc.shape
    m_total = n * t * (h // 2) * (w // 2)
    kp = kernel_padding(cm + cin)[0]
    taps = vt2[2:2 + 3 * tn]
    table = tap_table(taps, tn, k, h, w, cm)
    wide = table[2]
    flat = mid.reshape(-1)
    wp = torch.zeros((kp, plan.b.n_tiles * plan.b.chunk_cols))
    wp[:cm, :cm] = w3
    wp[cm:cm + cin, :cm] = wsc

    def operand(m0, bm):
        assert bm % RUN == 0
        valid, _, frame, tt, hh, ww, src = output_rows(m0, bm, m_total, dims)
        acc = torch.zeros((bm, cm))
        for r0 in range(0, bm, RUN):
            nrows = max(0, min(RUN, m_total - (m0 + r0)))
            if nrows == 0:
                continue
            acc[r0:r0 + RUN] = gather_run_s2(flat, table, dims, cm, m0 + r0,
                                             nrows)
            for ch in torch.nonzero(wide).flatten().tolist():
                for j in range(r0, r0 + nrows):
                    acc[j, ch] = general_taps_s2(
                        flat, taps, tn, k, dims, cm, ch, int(frame[j]),
                        int(tt[j]), int(hh[j]), int(ww[j]))
        if gate is not None:
            acc = acc * gate[frame]
        a = torch.zeros((bm, kp))
        a[:, :cm] = acc
        a[:, cm:cm + cin] = torch.relu(x[src] * vt1[0] + vt1[1])
        a[~valid] = 0.
        return a

    bm = plan.b.rows
    if plan.g is not None:
        rows = max(-(-m_total // r) * r for r in (plan.g.rows, bm))
        stage = torch.full((rows, kp), float("nan"))
        for m0 in range(0, m_total, plan.g.rows):
            stage[m0:m0 + plan.g.rows] = operand(m0, plan.g.rows)
    for m0 in range(0, m_total, bm):
        valid, mm = output_rows(m0, bm, m_total, dims)[:2]
        a = stage[m0:m0 + bm] if plan.g is not None else operand(m0, bm)
        for j in range(plan.b.n_tiles):
            n0 = j * plan.b.chunk_cols
            n1 = min((j + 1) * plan.b.chunk_cols, cm)
            out[mm[valid], n0:n1] = (a @ wp[:, n0:n1])[valid]


def emulate_entry(x, params, se, k, plan):
    """One entry as rubiks_fused_entry makes it on the tensor-core route:
    launch A, the gate (its own two launches, unchanged: their plain form
    here), launch B."""
    vt1, vt2, w2, w3, wsc = params
    n, t, h, w, cin = x.shape
    cm = w2.shape[1]
    tn = fb.taps_from_rows(vt2.shape[0], 2)
    mid = torch.empty((n * t * h * w, cm))
    emulate_launch_a(x.reshape(-1, cin), mid, vt1, vt2, w2, plan.a)
    gate = None
    if se is not None:
        v = fb.tap_shift(mid.reshape(n, t, h, w, cm), vt2[2:2 + 3 * tn], k)
        gate = fb.se_gate(v[:, :, ::2, ::2], se).reshape(n * t, cm)
    out = torch.empty((n * t * (h // 2) * (w // 2), cm))
    emulate_launch_b(x.reshape(-1, cin), mid, out, vt1, vt2, w3, wsc, gate,
                     (n, t, h, w), plan, k, tn)
    return out.reshape(n, t, h // 2, w // 2, cm)


def dyadic_entry(rng, cin, cm, k, kind, quantize=False):
    """(vt1, vt2, w2, w3, wsc) with values that keep every float32 sum
    exact."""
    vt1 = np.stack([rng.integers(1, 3, cin), rng.integers(-2, 3, cin)])
    head = np.stack([rng.integers(1, 3, cm), rng.integers(-2, 3, cm)])
    if kind == "quarters":
        shift = rng.integers(-4 * k, 4 * k + 1, (3, cm)) / 4.0
    elif kind == "integer":
        shift = rng.integers(-k, k + 1, (3, cm)).astype(np.float64)
    else:  # quantized: anything that rounds into [-K, K+1]
        shift = rng.uniform(-k - 0.45, k + 1.45, (3, cm))
    taps = fb.stack_taps(torch.from_numpy(shift.astype(np.float32)),
                         torch.float32, k, quantize)
    mats = [rng.integers(-1, 2, shape).astype(np.float32)
            for shape in ((cin, cm), (cm, cm), (cin, cm))]
    return (torch.from_numpy(vt1.astype(np.float32)),
            torch.cat([torch.from_numpy(head.astype(np.float32)), taps]),
            *(torch.from_numpy(m) for m in mats))


# (label, (N, T, H, W, Cin), Cm, max_shift, shifts, quantize, knobs)
DECOMPOSITIONS = [
    ("72 -> 72, several tiles", (2, 3, 6, 8, 72), 72, 1, "quarters", False,
     dict(a_warps_m=1, a_warps_n=1, b_warps_m=1, b_warps_n=1)),
    ("growth 24 -> 48, two column chunks", (2, 2, 4, 6, 24), 80, 1,
     "quarters", False, dict(a_warps_m=2, a_warps_n=1, b_warps_m=1,
                             b_warps_n=1)),
    ("widths no multiple of 8", (2, 2, 6, 10, 20), 36, 1, "quarters", False,
     dict(a_warps_m=2, a_warps_n=1, b_warps_m=1, b_warps_n=1)),
    ("integer and zero shifts", (2, 4, 4, 14, 16), 24, 2, "integer", False,
     dict(a_warps_m=2, a_warps_n=1, b_warps_m=2, b_warps_n=1)),
    ("quantized, the tap at K+1 kept", (2, 4, 4, 10, 24), 48, 1, "quantized",
     True, dict(a_warps_m=1, a_warps_n=1, b_warps_m=1, b_warps_n=1)),
    ("max_shift 3", (1, 8, 8, 8, 16), 32, 3, "quarters", False, {}),
    ("lines shorter than a run, odd output extents", (2, 3, 6, 10, 24), 24,
     1, "quarters", False, dict(b_warps_m=1, b_warps_n=1)),
    ("one tile larger than M", (1, 2, 2, 6, 16), 16, 1, "quarters", False,
     dict(a_warps_m=8, a_warps_n=1, b_warps_m=8, b_warps_n=1)),
    ("288 -> 576, column chunks of the plan", (1, 2, 4, 4, 288), 576, 1,
     "quarters", False, {}),
]


@pytest.mark.parametrize("case", DECOMPOSITIONS,
                         ids=[d[0] for d in DECOMPOSITIONS])
def test_decomposition_equals_plain_exactly(case):
    _, shape, cm, k, kind, quantize, knobs = case
    rng = np.random.default_rng(sum(shape) + cm + 7 * k)
    params = dyadic_entry(rng, shape[-1], cm, k, kind, quantize)
    x = torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
    plan = fe.fused_entry_plan(shape, cm, torch.bfloat16, sms=SMS, **knobs)
    if cm == 576:
        assert plan.a.n_tiles > 1 and plan.b.n_tiles > 1
    got = emulate_entry(x, params, None, k, plan)
    ref = fe.fused_entry_plain(x, params, max_shift=k)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("k,cm", [(1, 24), (3, 24), (1, 80)])
def test_decomposition_with_the_gate_and_wide_taps(k, cm):
    """The SE gate multiplies the gathered sum per (frame, channel), not the
    shortcut; taps with three non-zero weights on an axis take the general
    loop (max_shift 3: seven taps an axis); at 80 columns launch B has two
    chunks and the gather pre-pass applies the gate."""
    shape = (2, 3, 6, 8, 16)
    rng = np.random.default_rng(5 + k + cm)
    params = dyadic_entry(rng, 16, cm, k, "quarters")
    tn = 2 * k + 1
    params[1][2:2 + 3 * tn, ::5] = 0.25  # every fifth channel: wide taps
    se = torch.from_numpy(rng.standard_normal((2, cm, 2)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
    plan = fe.fused_entry_plan(shape, cm, torch.bfloat16, sms=SMS,
                               a_warps_m=1, a_warps_n=1, b_warps_m=1,
                               b_warps_n=1)
    assert (plan.g is not None) == (cm > 72)
    got = emulate_entry(x, params, se, k, plan)
    ref = fe.fused_entry_plain(x, params, se, max_shift=k)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    no_gate = emulate_entry(x, params, None, k, plan)
    assert torch.equal(no_gate, fe.fused_entry_plain(x, params, max_shift=k))


def test_gather_stays_inside_each_clip():
    """Frame 0 of the second clip must not read the last frame of the
    first, though the two are neighbours in the flat row index."""
    shape, cm, k = (2, 2, 4, 4, 8), 8, 1
    rng = np.random.default_rng(9)
    params = dyadic_entry(rng, 8, cm, k, "integer")
    x = torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
    plan = fe.fused_entry_plan(shape, cm, torch.bfloat16, sms=SMS,
                               a_warps_m=1, a_warps_n=1, b_warps_m=1,
                               b_warps_n=1)
    both = emulate_entry(x, params, None, k, plan)
    for i in range(2):
        one = emulate_entry(x[i:i + 1].contiguous(), params, None, k, plan)
        assert torch.equal(both[i:i + 1], one)
