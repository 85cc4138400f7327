"""The launch plan of K2's tensor-core kernels
(rubiksnet_torch.ops.fused_block.fused_block_plan) and a Python emulation of
the decomposition those kernels use (csrc/fused_block_tc.cu), held against
the plain version.

The CUDA kernels run only on the card. What can be checked on the CPU is
what surrounds their arithmetic: the plan's numbers (shared memory, column
chunks, padding, routes) for every stride-1 shape of every tier, and the
decomposition itself, written out here step by step as the kernel does it:
persistent row tiles of ``plan.rows`` rows with the rows past M clamped and
dropped, K padded to 16 with zeros, column chunks of ``plan.chunk_cols``,
launch A's attention mix with the clip boundary taken from the row's (n, t),
launch B's per-channel table (first non-zero tap offset and two weights per
axis, a flag for taps that are not two adjacent ones), its gather in runs of
sixteen consecutive rows walked line by line (the interpolation along T and H
carried from a pixel to its right neighbour, predicates for the zero fill at
clip, frame and line borders, the general loop for wide taps), the gate
multiply, the residual add with out aliasing x.

Tolerance: the inputs are dyadic (integers, shifts that are multiples of
1/4, attention rows 1/4, 1/2, 1/4), so every float32 sum is exact in any
order and the emulation must equal ``fused_block_plain`` bit for bit, for
rubiks3d and aq. With the SE gate the gated operand is no longer dyadic and
the two sides multiply by W3 in another order: rtol/atol 1e-5."""

import numpy as np
import pytest
import torch

from rubiksnet_torch.ops import fused_block as fb

torch.set_num_threads(1)

SMS = 132
STAGES = ((112, 1), (56, 1), (28, 2), (14, 4), (7, 8))  # (H, width factor)


# ------------------------------------------------------------- (a) the plan


def kernel_padding(c):
    """(K, N) the kernel pads a width to, with zeros in shared memory: the
    mma depth of 16 and the mma width of 8 (csrc/fused_block_tc.cu)."""
    return -(-c // 16) * 16, -(-c // 8) * 8


def work_items(plan, m):
    """Row tiles x column chunks of a launch."""
    return -(-m // plan.rows) * plan.n_tiles


@pytest.mark.parametrize("sms", [SMS, 114])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("width", [54, 72])
def test_plan_of_every_stride1_shape(width, batch, dtype, sms):
    """Tiers tiny (54) and small/medium/large (72), 8 frames at 224 px, on
    the 132 SMs of the H100 SXM and the 114 of the PCIe card. The plan is the
    same for rubiks3d and aq, any max_shift, with and without the SE gate:
    none of them is an argument."""
    for h, f in STAGES:
        c = width * f
        shape = (batch, 8, h, h, c)
        m = batch * 8 * h * h
        p = fb.fused_block_plan(shape, dtype, sms=sms)
        if dtype == torch.float32:
            # Full-float32 products: the SIMT route, always; the C side
            # tiles it by itself.
            assert p == fb.BlockPlan("simt") and p.describe() == "simt"
            continue
        assert p.route == "mma" and p.overlap and p.grid_x >= 1
        assert p.smem_bytes <= fb.SMEM_LIMIT
        warps = p.producers + p.warps_m * p.warps_n
        assert 32 * warps <= 512
        assert p.rows == p.warps_m * 16 and p.chunk_cols == p.warps_n * 72
        assert p.smem_bytes == fb._mma_smem(p.producers, p.warps_m,
                                            p.warps_n, c)
        # K and N are covered, with less than one tile of zero fill.
        k_pad, n_pad = kernel_padding(c)
        assert 0 <= k_pad - c < 16 and 0 <= n_pad - c < 8
        assert p.n_tiles * p.chunk_cols >= n_pad
        assert (p.n_tiles - 1) * p.chunk_cols < n_pad
        if width == 72:
            # 72 * 2^j: warps of 72 columns divide the width exactly.
            assert (k_pad - c, n_pad) in ((0, c), (8, c))
            assert p.n_tiles * p.chunk_cols == c
        # All of W beside the A tile where it fits, else chunks.
        fits = fb._mma_smem(0, 1, -(-c // 72), c) <= fb.SMEM_LIMIT
        assert ("resident-chunks" in p.describe()) == (p.n_tiles > 1)
        assert fits or p.n_tiles > 1
        # At least half the SMs have work where M allows it, and the grid
        # never exceeds what the SMs hold at once.
        items = work_items(p, m)
        assert 2 * items >= min(sms, -(-m // 16))
        assert p.grid_x * p.n_tiles <= max(
            sms * fb.blocks_per_sm(p.smem_bytes, warps) + p.n_tiles, items)
        # The taps, the attention mix and the gate do not enter the plan: the
        # wrapper asks with the shape and the dtype alone.
        assert fb.fused_block_plan(shape, dtype, sms=sms) is p


def test_plan_splits_columns_for_one_clip_at_7x7x576():
    """M = 392 rows: 7 tiles of 64 would leave 125 SMs idle; W (663 KB in
    bf16) cannot be resident either."""
    p = fb.fused_block_plan((1, 8, 7, 7, 576), torch.bfloat16, sms=SMS)
    assert p.n_tiles >= 4 and "resident-chunks" in p.describe()
    assert work_items(p, 392) >= 4 * -(-392 // 64)
    assert work_items(p, 392) >= 100


def test_plan_holds_all_of_w_up_to_288():
    for c in (72, 144, 288, 54, 108, 216):
        p = fb.fused_block_plan((8, 8, 14, 14, c), torch.bfloat16, sms=SMS)
        assert p.n_tiles == 1 and p.describe().startswith("mma resident ")


def test_plan_knobs_and_refusals():
    shape = (8, 8, 14, 14, 288)
    p = fb.fused_block_plan(shape, torch.bfloat16, producers=0, warps_m=4,
                            warps_n=4)
    assert (p.producers, p.warps_m, p.warps_n, p.rows) == (0, 4, 4, 64)
    assert p.smem_bytes == 64 * 296 * 2 + 288 * 296 * 2 + 8 * 288 * 4
    q = fb.fused_block_plan(shape, torch.bfloat16, producers=8, warps_m=2,
                            warps_n=4)
    assert (q.producers, q.rows, q.chunk_cols) == (8, 32, 288)
    assert q.smem_bytes == 2 * 32 * 296 * 2 + 288 * 296 * 2 + 8 * 288 * 4
    # The route is the dtype's: bfloat16 always runs the tensor cores, and
    # no ``route`` is taken.
    assert fb.fused_block_plan(shape, torch.bfloat16).route == "mma"
    assert fb.fused_block_plan(shape, torch.float32).route == "simt"
    with pytest.raises(ValueError, match="unknown plan knobs"):
        fb.fused_block_plan(shape, torch.float32, route="mma")
    with pytest.raises(ValueError, match="no tensor-core plan"):
        # 17 warps.
        fb.fused_block_plan(shape, torch.bfloat16, producers=1, warps_m=4,
                            warps_n=4)
    with pytest.raises(ValueError, match="no tensor-core plan"):
        # A 256-row tile of 576 channels beside 72 columns of W: 400 KB.
        fb.fused_block_plan((8, 8, 7, 7, 576), torch.bfloat16, warps_m=16,
                            warps_n=1)
    with pytest.raises(ValueError, match="unknown plan knobs"):
        fb.fused_block_plan(shape, torch.bfloat16, warps=4)
    with pytest.raises(ValueError, match="unknown plan knobs"):
        fb.fused_block_plan(shape, torch.bfloat16, route="mma")
    with pytest.raises(ValueError, match="unknown plan knobs"):
        # The taps do not enter the plan.
        fb.fused_block_plan(shape, torch.bfloat16, taps_n=17, max_shift=8)
    with pytest.raises(ValueError, match="shape must be"):
        fb.fused_block_plan(shape[1:], torch.bfloat16)


def test_plan_follows_the_measured_rule():
    """The shapes of Large at batch 8 and 1, as PERF.md records them."""
    bf = torch.bfloat16

    def shape_of(n, h, c):
        p = fb.fused_block_plan((n, 8, h, h, c), bf, sms=SMS)
        return p.producers, p.warps_m, p.warps_n, p.n_tiles

    assert shape_of(8, 112, 72) == (0, 16, 1, 1)
    assert shape_of(8, 56, 72) == (0, 16, 1, 1)
    assert shape_of(8, 28, 144) == (0, 8, 2, 1)
    # 12,544 rows on 132 SMs: two tiles of 48 rows a block, not two of 64.
    assert shape_of(8, 14, 288) == (0, 3, 4, 1)
    assert shape_of(32, 14, 288) == (0, 4, 4, 1)
    assert shape_of(32, 112, 72) == (0, 16, 1, 1)
    assert shape_of(8, 7, 576) == (12, 1, 2, 4)
    # One clip: fewer rows a tile, then column chunks, so that at least half
    # the SMs have work; producers where fewer than 8 warps multiply.
    assert shape_of(1, 56, 72) == (0, 16, 1, 1)
    assert shape_of(1, 28, 144) == (0, 4, 2, 1)
    assert shape_of(1, 14, 288) == (12, 2, 2, 2)
    assert shape_of(1, 7, 576) == (12, 2, 1, 8)


def test_tile_row_stride_is_an_odd_number_of_16_byte_units():
    """The eight rows of an ldmatrix then fall into eight bank groups."""
    for cols in (54, 64, 72, 80, 112, 144, 288, 576, 584):
        rs = fb.tile_row_stride(cols)
        assert rs >= cols + 8 and rs % 8 == 0 and (rs // 8) % 2 == 1
        assert len({(r * rs * 2 // 16) % 8 for r in range(8)}) == 8


# ------------------------------------------------- (b) the decomposition


def tap_table(taps, tn, k, h, w, c):
    """Launch B's per-channel table: per axis the first non-zero tap's
    offset and the weights of that tap and the next; ``wide`` where an axis
    has more than two taps or two that are not adjacent."""
    off = torch.zeros((3, c), dtype=torch.long)
    wts = torch.zeros((3, 2, c))
    wide = torch.zeros(c, dtype=torch.bool)
    for ch in range(c):
        for a in range(3):
            col = taps[a * tn:(a + 1) * tn, ch]
            nz = torch.nonzero(col).flatten().tolist()
            if not nz:
                continue
            lo, hi = nz[0], nz[-1]
            off[a, ch] = lo - k
            wts[a, 0, ch] = col[lo]
            if lo + 1 < tn:
                wts[a, 1, ch] = col[lo + 1]
            wide[ch] |= hi > lo + 1
    delta = ((off[0] * h + off[1]) * w + off[2]) * c + torch.arange(c)
    return off, wts, wide, delta


def rows_of(m0, bm, m_total, dims):
    """Tile rows clamped to the last row, as (valid, m, frame, t, h, w)."""
    _, t, h, w = dims
    m = torch.arange(m0, m0 + bm)
    valid = m < m_total
    mm = torch.where(valid, m, torch.tensor(m_total - 1))
    q = mm // w
    frame = q // h
    return valid, mm, frame, frame % t, q % h, mm % w


def emulate_launch_a(x, mid, vt, w2, dims, plan, aq, tn):
    """mid = relu(s2 . (A @ W2) + b2) tile by tile; A = relu(s1 . x + b1),
    with aq mixed along T by the rows that follow the taps."""
    n, t, h, w = dims
    m_total, c = x.shape
    hw = h * w
    kp = kernel_padding(c)[0]
    s1, b1, s2, b2 = vt[0], vt[1], vt[2], vt[3]
    wp = torch.zeros((kp, plan.n_tiles * plan.chunk_cols))
    wp[:c, :c] = w2
    for m0 in range(0, m_total, plan.rows):
        valid, mm, _, tt, _, _ = rows_of(m0, plan.rows, m_total, dims)
        act = lambda rows: torch.relu(x[rows] * s1 + b1)
        a = torch.zeros((plan.rows, kp))
        if aq:
            aw = vt[4 + 3 * tn:]
            prev, nxt = tt > 0, tt < t - 1
            acc = torch.where(prev[:, None],
                              aw[0] * act(torch.where(prev, mm - hw, mm)), 0.)
            acc = acc + aw[1] * act(mm)
            acc = torch.where(nxt[:, None], acc + aw[2] * act(
                torch.where(nxt, mm + hw, mm)), acc)
            a[:, :c] = acc
        else:
            a[:, :c] = act(mm)
        a[~valid] = 0.
        for j in range(plan.n_tiles):
            n0 = j * plan.chunk_cols
            n1 = min(n0 + plan.chunk_cols, c)
            acc = a @ wp[:, n0:n1]
            res = torch.relu(acc * s2[n0:n1] + b2[n0:n1])
            mid[mm[valid], n0:n1] = res[valid]


RUN = 16  # csrc/fused_block_tc.cu::kTcRun: rows a lane walks per unit


def general_taps(flat, taps, tn, k, dims, c, ch, m):
    """Channel ch at row m as the sum over every non-zero tap (the kernel's
    gather_taps)."""
    _, t, h, w = dims
    ww, q = m % w, m // w
    hh, frame = q % h, q // h
    tt = frame % t
    acc = torch.zeros(())
    for jt in range(tn):
        for jh in range(tn):
            for jw in range(tn):
                wgt = (taps[jt, ch] * taps[tn + jh, ch]) * taps[2 * tn + jw,
                                                                 ch]
                ti, hi, wi = tt + jt - k, hh + jh - k, ww + jw - k
                if (wgt != 0 and 0 <= ti < t and 0 <= hi < h
                        and 0 <= wi < w):
                    acc = acc + wgt * flat[
                        (((frame - tt + ti) * h + hi) * w + wi) * c + ch]
    return acc


def gather_run(flat, table, dims, c, m_first, nrows):
    """RUN consecutive rows of every channel as the kernel walks them: line
    by line; on a line the interpolation along T and H at a source column,
    S(col), is carried from a pixel to its right neighbour, so a pixel reads
    one new column. Returns (RUN, C)."""
    off, wts, _, _ = table
    _, t, h, w = dims
    ar = torch.arange(c)
    out = torch.zeros((RUN, c))
    r = 0
    ww, q = m_first % w, m_first // w
    hh, frame = q % h, q // h
    while r < nrows:
        seg = min(w - ww, nrows - r)
        tt = frame % t
        line = ((frame + off[0]) * h + (hh + off[1])) * w * c + ar

        def column(col):
            s = torch.zeros(c)
            for dt in range(2):
                for dh in range(2):
                    ok = ((wts[0, dt] != 0) & (wts[1, dh] != 0)
                          & (tt + off[0] + dt >= 0) & (tt + off[0] + dt < t)
                          & (hh + off[1] + dh >= 0) & (hh + off[1] + dh < h)
                          & (col >= 0) & (col < w))
                    idx = line + col * c + (dt * h + dh) * w * c
                    s = s + (wts[0, dt] * wts[1, dh]) * torch.where(
                        ok, flat[idx.clamp(0, flat.numel() - 1)], 0.)
            return s

        col = ww + off[2]
        prev = column(col)
        for j in range(seg):
            col = col + 1
            sk = column(col)
            out[r + j] = wts[2, 1] * sk + wts[2, 0] * prev
            prev = sk
        r += seg
        ww += seg
        if ww == w:
            ww, hh = 0, hh + 1
            if hh == h:
                hh, frame = 0, frame + 1
    return out


def emulate_launch_b(x, mid, out, vt, w3, gate, dims, plan, k, tn):
    """out = x + ([gate .] shift3d(mid)) @ W3 tile by tile; ``out`` may be
    ``x`` itself: a tile reads exactly the elements of x it then writes."""
    n, t, h, w = dims
    m_total, c = x.shape
    kp = kernel_padding(c)[0]
    taps = vt[4:4 + 3 * tn]
    table = tap_table(taps, tn, k, h, w, c)
    wide = table[2]
    flat = mid.reshape(-1)
    wp = torch.zeros((kp, plan.n_tiles * plan.chunk_cols))
    wp[:c, :c] = w3
    assert plan.rows % RUN == 0
    for m0 in range(0, m_total, plan.rows):
        valid, mm, frame, _, _, _ = rows_of(m0, plan.rows, m_total, dims)
        acc = torch.zeros((plan.rows, c))
        for r0 in range(0, plan.rows, RUN):
            nrows = max(0, min(RUN, m_total - (m0 + r0)))
            if nrows == 0:
                continue
            acc[r0:r0 + RUN] = gather_run(flat, table, dims, c, m0 + r0,
                                          nrows)
            for ch in torch.nonzero(wide).flatten().tolist():
                for j in range(nrows):
                    acc[r0 + j, ch] = general_taps(flat, taps, tn, k, dims, c,
                                                   ch, m0 + r0 + j)
        if gate is not None:
            acc = acc * gate[frame]
        a = torch.zeros((plan.rows, kp))
        a[:, :c] = acc
        a[~valid] = 0.
        for j in range(plan.n_tiles):
            n0 = j * plan.chunk_cols
            n1 = min(n0 + plan.chunk_cols, c)
            res = x[mm[valid], n0:n1] + (a @ wp[:, n0:n1])[valid]
            out[mm[valid], n0:n1] = res


def emulate_run(x, vt, wm, se, aq, k, plan):
    """A run as rubiks_fused_block_run makes it: block 0 reads x and writes
    out, the later blocks update out in place."""
    n, t, h, w, c = x.shape
    dims = (n, t, h, w)
    tn = fb.taps_from_rows(vt.shape[1], 4, aq)
    out = torch.empty((n * t * h * w, c))
    mid = torch.empty_like(out)
    src = x.reshape(-1, c)
    for b in range(vt.shape[0]):
        emulate_launch_a(src, mid, vt[b], wm[b, 0], dims, plan, aq, tn)
        gate = None
        if se is not None:
            v = fb.tap_shift(mid.reshape(x.shape), vt[b, 4:4 + 3 * tn], k)
            gate = fb.se_gate(v, se[b]).reshape(n * t, c)
        emulate_launch_b(src, mid, out, vt[b], wm[b, 1], gate, dims, plan, k,
                         tn)
        src = out
    return out.reshape(x.shape)


def dyadic_run(rng, c, blocks, k, aq, kind, quantize=False):
    """vt, wm with values that keep every float32 sum exact."""
    tn = 2 * k + 2 if quantize else 2 * k + 1
    vts, wms = [], []
    for _ in range(blocks):
        bn = np.stack([rng.integers(1, 3, c), rng.integers(-2, 3, c),
                       rng.integers(1, 3, c), rng.integers(-2, 3, c)])
        if kind == "quarters":
            shift = rng.integers(-4 * k, 4 * k + 1, (3, c)) / 4.0
        elif kind == "integer":
            shift = rng.integers(-k, k + 1, (3, c)).astype(np.float64)
        else:  # quantized: anything that rounds into [-K, K+1]
            shift = rng.uniform(-k - 0.45, k + 1.45, (3, c))
        if aq:
            shift[0] = 0.0
        taps = fb.stack_taps(torch.from_numpy(shift.astype(np.float32)),
                             torch.float32, k, quantize)
        rows = [torch.from_numpy(bn.astype(np.float32)), taps]
        if aq:
            rows.append(torch.tensor([[0.25], [0.5], [0.25]]).expand(3, c))
        vts.append(torch.cat(rows))
        wms.append(torch.from_numpy(
            rng.integers(-1, 2, (2, c, c)).astype(np.float32)))
    assert vts[0].shape[0] == 4 + 3 * tn + (3 if aq else 0)
    return torch.stack(vts).contiguous(), torch.stack(wms).contiguous()


# (label, (N, T, H, W, C), max_shift, shifts, quantize, blocks, knobs)
DECOMPOSITIONS = [
    ("72 wide, several tiles", (2, 3, 3, 8, 72), 1, "quarters", False, 2,
     dict(warps_m=1, warps_n=1)),
    ("two column chunks, the second 8 wide", (1, 4, 3, 7, 80), 1, "quarters",
     False, 2, dict(warps_m=2, warps_n=1)),
    ("width no multiple of 8", (2, 2, 3, 9, 20), 1, "quarters", False, 2,
     dict(warps_m=2, warps_n=1)),
    ("max_shift 3", (1, 8, 7, 7, 24), 3, "quarters", False, 1,
     dict(warps_m=2, warps_n=1)),
    ("integer and zero shifts", (2, 4, 2, 14, 24), 2, "integer", False, 2,
     dict(warps_m=2, warps_n=1)),
    ("quantized, the tap at K+1 kept", (2, 4, 2, 9, 24), 1, "quantized",
     True, 2, dict(warps_m=1, warps_n=1)),
    ("one tile larger than M", (1, 2, 2, 7, 16), 1, "quarters", False, 3,
     dict(warps_m=8, warps_n=1)),
    ("lines shorter than a run", (2, 3, 5, 4, 24), 1, "quarters", False, 2,
     dict(warps_m=1, warps_n=1)),
]


# The aq form has no quantized taps.
DECOMPOSITION_RUNS = [(d, aq) for d in DECOMPOSITIONS for aq in (False, True)
                      if not (aq and d[4])]


@pytest.mark.parametrize("case,aq", DECOMPOSITION_RUNS, ids=[
    f"{d[0]}{', aq' if aq else ''}" for d, aq in DECOMPOSITION_RUNS])
def test_decomposition_equals_plain_exactly(case, aq):
    _, shape, k, kind, quantize, blocks, knobs = case
    rng = np.random.default_rng(sum(shape) + 7 * k)
    vt, wm = dyadic_run(rng, shape[-1], blocks, k, aq, kind, quantize)
    x = torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
    plan = fb.fused_block_plan(shape, torch.bfloat16, sms=SMS, **knobs)
    assert -(-x[..., 0].numel() // plan.rows) * plan.rows >= x[..., 0].numel()
    got = emulate_run(x, vt, wm, None, aq, k, plan)
    ref = fb.fused_block_plain(x, vt, wm, aq=aq, max_shift=k)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("aq", [False, True])
def test_decomposition_with_the_gate_and_wide_taps(aq):
    """The SE gate multiplies the gathered sum per (frame, channel); taps
    with three non-zero weights on an axis take the general loop."""
    shape, k = (2, 3, 3, 7, 24), 1
    rng = np.random.default_rng(5 + aq)
    vt, wm = dyadic_run(rng, 24, 2, k, aq, "quarters")
    first = 4 + (3 if aq else 0)
    vt[:, first:13, ::5] = 0.25  # every fifth channel: three taps per axis
    se = torch.from_numpy(rng.standard_normal((2, 2, 24, 2)).astype(
        np.float32))
    x = torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
    plan = fb.fused_block_plan(shape, torch.bfloat16, sms=SMS, warps_m=1,
                               warps_n=1)
    got = emulate_run(x, vt, wm, se, aq, k, plan)
    ref = fb.fused_block_plain(x, vt, wm, se, aq=aq, max_shift=k)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    no_gate = emulate_run(x, vt, wm, None, aq, k, plan)
    assert torch.equal(no_gate, fb.fused_block_plain(x, vt, wm, aq=aq,
                                                     max_shift=k))


def test_aq_mix_takes_the_clip_boundary_from_the_row():
    """Frame 0 of the second clip must not read the last frame of the
    first, though the two are neighbours in the flat row index."""
    shape, k = (2, 2, 2, 2, 8), 1
    rng = np.random.default_rng(9)
    vt, wm = dyadic_run(rng, 8, 1, k, True, "integer")
    x = torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
    plan = fb.fused_block_plan(shape, torch.bfloat16, sms=SMS, warps_m=1,
                               warps_n=1)
    both = emulate_run(x, vt, wm, None, True, k, plan)
    for i in range(2):
        one = emulate_run(x[i:i + 1].contiguous(), vt, wm, None, True, k,
                          plan)
        assert torch.equal(both[i:i + 1], one)


def test_launch_b_in_place_equals_out_of_place():
    """out aliasing x: a tile reads the elements of x it writes and nothing
    else of x."""
    shape, k = (1, 3, 2, 8, 80), 1
    rng = np.random.default_rng(11)
    vt, wm = dyadic_run(rng, 80, 1, k, False, "quarters")
    x = torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
    plan = fb.fused_block_plan(shape, torch.bfloat16, sms=SMS, warps_m=1,
                               warps_n=1)
    dims, c = shape[:4], 80
    flat = x.reshape(-1, c)
    mid = torch.empty_like(flat)
    emulate_launch_a(flat, mid, vt[0], wm[0, 0], dims, plan, False, 3)
    apart = torch.empty_like(flat)
    emulate_launch_b(flat, mid, apart, vt[0], wm[0, 1], None, dims, plan, k,
                     3)
    aliased = flat.clone()
    emulate_launch_b(aliased, mid, aliased, vt[0], wm[0, 1], None, dims,
                     plan, k, 3)
    assert torch.equal(aliased, apart)
    assert torch.equal(apart.reshape(shape),
                       fb.fused_block_plain(x, vt, wm, max_shift=k))


def test_cuda_wrapper_still_refuses_cpu_tensors():
    rng = np.random.default_rng(13)
    vt, wm = dyadic_run(rng, 8, 1, 1, False, "integer")
    x = torch.zeros((1, 2, 2, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_block_kernel(x, vt, wm, max_shift=1)
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_block_kernel(x.bfloat16(), vt, wm.bfloat16(), max_shift=1)
    assert fb.LAUNCHES.count == 0
