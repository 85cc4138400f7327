"""The SE gate of K2's and K3's tensor-core route (csrc/tc_se.cuh,
csrc/se_gate_tc.cu), emulated on the CPU step by step as the kernels cut
it, and held against the plain gate and against the JAX package.

The CUDA kernels run only on the card. What the CPU can check is the
decomposition: launch A's row tiles as the real plans cut them
(``fused_block_plan``, ``fused_entry_plan``'s launch A), its per-axis weight
tables (``lo`` entries at the low edge, ``hi`` at the high edge, one
interior entry per parity of the stride), each stored value of ``mid``
times its channel's aH[h] * aW[w], summed per frame the warp's 16 rows
touch, the row warps' sums added in warp order into one partial per (row
tile, frame slot, channel) by the chunk that owns the channel, unwritten
slots left NaN; then the gate launch: per frame the partials of its tiles
in G contiguous ranges of tiles (G = 384 // C), the T taps, fc1 in the 12
warps' channel segments, relu, fc2, sigmoid.

Tolerances: in float64 the emulated gate (and the spatial mean before fc1)
equals ``se_gate(shift(mid))`` to rtol/atol 1e-12: the same terms summed in
another order. A block run and an entry with the emulated gate in float32
(the whole tensor-core decomposition: launch A, the partials, the gate,
launch B) against the Pallas kernels in interpret mode: rtol/atol 2e-4, as
tests/test_torch_fused_block.py and test_torch_fused_entry.py hold the
plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rubiksnet_torch.ops import fused_block as fb
from rubiksnet_torch.ops import fused_entry as fe
from rubiksnet_tpu.ops.pallas import fused_block as jfb
from rubiksnet_tpu.ops.pallas import fused_entry as jfe
from test_torch_fused_block import _option_run, _stack, make_block, \
    torch_block
from test_torch_fused_block_plan import emulate_launch_a as block_launch_a
from test_torch_fused_block_plan import emulate_launch_b as block_launch_b
from test_torch_fused_entry_plan import emulate_launch_a as entry_launch_a
from test_torch_fused_entry_plan import emulate_launch_b as entry_launch_b

torch.set_num_threads(1)

SMS = 132
FRAMES = 8
GATE_THREADS = 384  # csrc/se_gate_tc.cu: 12 warps a block
GATE_WARPS = 12
WARP_ROWS = 16
TOL_F64 = 1e-12
TOL_JAX = 2e-4
BF = torch.bfloat16
# Small (the SE tier) at 224 px: stride-1 (H, C) and entry (H, Cin, Cm).
SMALL_BLOCKS = [(112, 72), (56, 72), (28, 144), (14, 288), (7, 576)]
SMALL_ENTRIES = [(112, 72, 72), (56, 72, 144), (28, 144, 288),
                 (14, 288, 576)]
# Rows x channels an emulation holds at most: at the large batches the
# channels are cut (the row walk, which the plan sets, stays whole).
ELEMENTS = 1_000_000


# ------------------------------------------------ the weight tables


def carried(taps_axis, k, stride, i, d_out):
    """The taps of one axis (taps_n, C) that carry input cell i onto an
    output cell (se_gate.cuh::carried_taps), per channel."""
    a = torch.zeros(taps_axis.shape[1], dtype=taps_axis.dtype)
    for j in range(taps_axis.shape[0]):
        q = i - j + k
        if q >= 0 and q % stride == 0 and q // stride < d_out:
            a = a + taps_axis[j]
    return a


def table_borders(taps_n, k, stride):
    """csrc/tc_se.cuh::tc_se_borders: (lo, hi), the entries of launch A's
    per-axis weight table at the low and the high edge; ``stride`` more
    hold the interior (one per parity)."""
    return max(taps_n - 1 - k, 0), k + stride - 1


def se_smem_bytes(plan, taps_n, k, stride, slots, table):
    """Dynamic shared memory of launch A with the gate's sums, as
    fused_block_tc.cu::tc_launch and fused_entry_tc.cu::entry_launch size
    it: the SE region (tc_se.cuh::tc_se_bytes: two weight tables, the row
    warps' sums) where the gather's table of ``table`` channels would
    start, or the plan's size where that is larger."""
    lo, hi = table_borders(taps_n, k, stride)
    se = (2 * (lo + hi + stride) + plan.warps_m * slots) * plan.chunk_cols * 4
    start = plan.smem_bytes - 32 * (-(-table // 16)) * 16
    return max(plan.smem_bytes, start + se)


def entry_of(i, d, lo, hi, stride):
    """csrc/tc_se.cuh::tc_se_entry."""
    if i < lo:
        return i
    if i >= d - hi:
        return lo + i - (d - hi)
    return lo + hi + (i & 1 if stride == 2 else 0)


def coord_of(e, d, lo, hi, stride):
    """csrc/tc_se.cuh::tc_se_coord: the coordinate entry e is built at."""
    if e < lo:
        return e if e < d else -1
    if e < lo + hi:
        i = d - hi + (e - lo)
        return i if i >= lo else -1
    i = lo + ((e - lo - hi - lo) & (stride - 1))
    return i if i < d - hi else -1


def axis_weights(taps_axis, k, stride, d):
    """(d, C): aH (or aW) of every coordinate, read from the kernel's table
    of lo + hi + stride entries; checked against the direct sum."""
    lo, hi = table_borders(taps_axis.shape[0], k, stride)
    table = torch.zeros((lo + hi + stride, taps_axis.shape[1]),
                        dtype=taps_axis.dtype)
    for e in range(table.shape[0]):
        i = coord_of(e, d, lo, hi, stride)
        if i >= 0:
            assert entry_of(i, d, lo, hi, stride) == e
            table[e] = carried(taps_axis, k, stride, i, d // stride)
    rows = torch.stack([table[entry_of(i, d, lo, hi, stride)]
                        for i in range(d)])
    direct = torch.stack([carried(taps_axis, k, stride, i, d // stride)
                          for i in range(d)])
    assert torch.equal(rows, direct)
    return rows


# -------------------------------------------------- launch A's sums


def emulate_partials(mid, taps, k, stride, plan, dims):
    """The partials (row tiles, slots, C) launch A leaves under ``plan``
    for mid (M, C), rows in (N, T, H, W) order; NaN where it writes
    nothing."""
    n, t, h, w = dims
    m_total, c = mid.shape
    hw, bm, wm = h * w, plan.rows, plan.warps_m
    assert bm == wm * WARP_ROWS
    tn = taps.shape[0] // 3
    a_h = axis_weights(taps[tn:2 * tn], k, stride, h)
    a_w = axis_weights(taps[2 * tn:], k, stride, w)
    tiles, slots, _ = fb.se_partial_shape(plan, (n, t, h, w, c))
    m = torch.arange(m_total)
    frame, tile = m // hw, m // bm
    warp = (m % bm) // WARP_ROWS
    slot = frame - tile * bm // hw
    assert int(slot.min()) >= 0 and int(slot.max()) < slots
    v = mid * a_h[(m // w) % h] * a_w[m % w]
    # Which (tile, warp, slot) a warp writes: every frame its rows touch.
    lo_row = (torch.arange(tiles)[:, None] * bm
              + torch.arange(wm)[None, :] * WARP_ROWS)
    hi_row = torch.clamp(lo_row + WARP_ROWS - 1, max=m_total - 1)
    f0 = torch.arange(tiles) * bm // hw
    f = f0[:, None, None] + torch.arange(slots)[None, None, :]
    touched = ((lo_row < m_total)[:, :, None] & (lo_row[:, :, None] // hw <= f)
               & (f <= hi_row[:, :, None] // hw))
    assert bool(touched.reshape(-1)[(tile * wm + warp) * slots + slot].all())
    red = torch.zeros((tiles * wm * slots, c), dtype=mid.dtype)
    red.index_add_(0, (tile * wm + warp) * slots + slot, v)
    red = red.reshape(tiles, wm, slots, c)
    red[~touched] = float("nan")  # never written by the warp
    # Per (slot, column): the warps touching that frame, in warp order. The
    # column chunks of the plan own disjoint channels and cover them all.
    partial = torch.full((tiles, slots, c), float("nan"), dtype=mid.dtype)
    last = torch.clamp(torch.arange(tiles) * bm + bm, max=m_total) - 1
    written = f[:, 0, :] <= (last // hw)[:, None]
    owner = torch.zeros(c, dtype=torch.long)
    for j in range(plan.n_tiles):
        n0, n1 = j * plan.chunk_cols, min((j + 1) * plan.chunk_cols, c)
        if n0 >= c:
            continue  # the emulation holds fewer channels than the plan
        owner[n0:n1] += 1
        acc = torch.zeros((tiles, slots, n1 - n0), dtype=mid.dtype)
        for wi in range(wm):
            acc = acc + torch.where(touched[:, wi, :, None],
                                    red[:, wi, :, n0:n1], 0.)
        partial[:, :, n0:n1] = torch.where(written[:, :, None], acc,
                                           float("nan"))
    assert torch.equal(owner, torch.ones(c, dtype=torch.long))
    return partial


# ----------------------------------------------------- the gate launch


def emulate_gate(partial, taps_t, se, dims, bm, k, inv_count):
    """se_gate_tc.cu: (frames, C) gate and the spatial mean m before fc1."""
    n, t, h, w = dims
    hw = h * w
    frames = n * t
    c, cr = se.shape[1], se.shape[2]
    g_ranges = GATE_THREADS // c if c < GATE_THREADS else 1
    sums = []
    for fr in range(frames):
        first = fr * hw // bm
        count = ((fr + 1) * hw - 1) // bm - first + 1
        bounds = [first + g * count // g_ranges for g in range(g_ranges + 1)]
        assert bounds[0] == first and bounds[-1] == first + count
        total = torch.zeros(c, dtype=partial.dtype)
        for g in range(g_ranges):  # the ranges in order, tiles in order
            for tile in range(bounds[g], bounds[g + 1]):
                total = total + partial[tile, fr - tile * bm // hw]
        assert bool(torch.isfinite(total).all()), "an unwritten slot was read"
        sums.append(total)
    s = torch.stack(sums).reshape(n, t, c)
    m = torch.zeros((n, t, c), dtype=partial.dtype)
    for jt in range(taps_t.shape[0]):
        for tt in range(t):
            ti = tt + jt - k
            if 0 <= ti < t:
                wt = taps_t[jt]
                m[:, tt] += torch.where(wt != 0, wt * s[:, ti], 0.)
    m = m.reshape(frames, c) * inv_count
    # fc1: warp w takes the channels [w C / 12, (w + 1) C / 12).
    edges = [wi * c // GATE_WARPS for wi in range(GATE_WARPS + 1)]
    assert edges[0] == 0 and edges[-1] == c
    y1 = sum(m[:, edges[wi]:edges[wi + 1]] @ se[0, edges[wi]:edges[wi + 1]]
             for wi in range(GATE_WARPS))
    gate = torch.sigmoid(torch.relu(y1) @ se[1].t())
    return gate, m


# ------------------------------------------------------------ the data


def random_taps(rng, c, k, kind):
    """(3 * taps_n, C) float64 taps of a shift of ``kind``."""
    quantize = kind == "quantize"
    if kind == "integer":
        shift = rng.integers(-k, k + 1, (3, c)).astype(np.float64)
        shift[:, ::3] = 0.0
    elif kind == "quantize":
        shift = rng.uniform(-k - 0.45, k + 1.45, (3, c))
    elif kind == "far":
        shift = np.where(np.arange(c) % 2, 1.0, -1.0) * (
            k - 0.3 * rng.random((3, c)))
    else:
        shift = rng.uniform(-0.95 * k, 0.95 * k, (3, c))
    return fb.stack_taps(torch.from_numpy(shift.astype(np.float32)),
                         torch.float32, k, quantize).double()


def check_gate(dims, c, k, kind, stride, plan, seed):
    """Emulated gate vs se_gate(shift(mid)) in float64, on random mid of
    (N, T, H, W) x c channels (the full-resolution grid at stride 2)."""
    n, t, h, w = dims
    rng = np.random.default_rng(seed)
    mid = torch.from_numpy(rng.random((n * t * h * w, c)))
    taps = random_taps(rng, c, k, kind)
    cr = max(1, c // 12)
    se = torch.from_numpy(rng.standard_normal((2, c, cr)))
    partial = emulate_partials(mid, taps, k, stride, plan, dims)
    ho, wo = h // stride, w // stride
    gate, m = emulate_gate(partial, taps[:taps.shape[0] // 3], se, dims,
                           plan.rows, k, 1.0 / (ho * wo))
    v = fb.tap_shift(mid.reshape(n, t, h, w, c), taps, k)
    v = v[:, :, ::stride, ::stride]
    assert v.shape[2:4] == (ho, wo)
    torch.testing.assert_close(m, v.mean(dim=(2, 3)).reshape(n * t, c),
                               rtol=TOL_F64, atol=TOL_F64)
    torch.testing.assert_close(gate, fb.se_gate(v, se).reshape(n * t, c),
                               rtol=TOL_F64, atol=TOL_F64)


def channels(m_rows, c):
    """The channels an emulation of m_rows rows holds (all, where it can)."""
    return c if m_rows * c <= ELEMENTS else max(1, ELEMENTS // m_rows)


# ------------------------------------------ (a) the plans of every shape


@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("h,c", SMALL_BLOCKS)
def test_k2_gate_under_the_served_plans(h, c, batch):
    shape = (batch, FRAMES, h, h, c)
    plan = fb.fused_block_plan(shape, BF, sms=SMS, gate=(3, 1)).a
    check_gate(shape[:4], channels(batch * FRAMES * h * h, c), 1, "frac", 1,
               plan, seed=h + c + batch)


@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("h,cin,cm", SMALL_ENTRIES)
def test_k3_gate_under_the_served_plans(h, cin, cm, batch):
    plan = fe.fused_entry_plan((batch, FRAMES, h, h, cin), cm, BF,
                               sms=SMS).a
    check_gate((batch, FRAMES, h, h), channels(batch * FRAMES * h * h, cm),
               1, "frac", 2, plan, seed=h + cm + batch)


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_se_scratch_fits_the_served_plans(batch):
    """The partials' shape, and the shared memory of launch A with the SE
    region: under the limit, and the same blocks per SM as without it (the
    plan's grid stays one wave)."""
    runs = [(fb.fused_block_plan((batch, FRAMES, h, h, c), BF, sms=SMS,
                                 gate=(3, 1)).a,
             (batch, FRAMES, h, h, c), 1, c) for h, c in SMALL_BLOCKS]
    runs += [(fe.fused_entry_plan((batch, FRAMES, h, h, cin), cm, BF,
                                  sms=SMS).a, (batch, FRAMES, h, h, cm), 2, 0)
             for h, cin, cm in SMALL_ENTRIES]
    for plan, shape, stride, table in runs:
        m_rows = shape[0] * shape[1] * shape[2] * shape[3]
        tiles, slots, c = fb.se_partial_shape(plan, shape)
        assert tiles == -(-m_rows // plan.rows) and c == shape[4]
        assert slots == 2  # at 224 px a tile never spans three frames
        smem = se_smem_bytes(plan, 3, 1, stride, slots, table)
        assert plan.smem_bytes <= smem <= fb.SMEM_LIMIT
        assert (fb.blocks_per_sm(smem, plan.warps)
                == fb.blocks_per_sm(plan.smem_bytes, plan.warps))


# ---------------------------------------------- (b) off the model's shapes


# (label, (N, T, H, W), C, max_shift, shift kind, knobs of the plan)
K2_CASES = [
    ("7x9, C=54", (2, 3, 7, 9), 54, 1, "frac", {}),
    ("one frame", (3, 1, 7, 7), 24, 1, "frac", dict(warps_m=2, warps_n=1)),
    ("max_shift 3, shifts near +-3", (2, 4, 7, 9), 24, 3, "far",
     dict(warps_m=1, warps_n=1)),
    ("quantized", (2, 3, 6, 5), 24, 1, "quantize", dict(warps_m=2,
                                                        warps_n=1)),
    ("integer and zero shifts", (2, 3, 5, 8), 24, 2, "integer",
     dict(warps_m=4, warps_n=1)),
    ("a tile over three frames", (1, 4, 3, 3), 16, 1, "frac",
     dict(warps_m=1, warps_n=1)),
    ("one-pixel frames", (2, 3, 1, 1), 8, 1, "frac", dict(warps_m=2,
                                                          warps_n=1)),
    ("column chunks, 7x7x576, one clip", (1, 8, 7, 7), 576, 1, "frac", {}),
]
# (label, (N, T, H, W) of mid, Cin, Cm, max_shift, kind, knobs)
K3_CASES = [
    ("6x10, Cin 54 -> 108", (2, 3, 6, 10), 54, 108, 1, "frac", {}),
    ("one frame", (2, 1, 6, 6), 16, 32, 1, "frac", dict(a_warps_m=2)),
    ("max_shift 3, shifts near +-3", (1, 4, 8, 8), 16, 32, 3, "far", {}),
    ("quantized", (2, 3, 6, 4), 24, 48, 1, "quantize",
     dict(a_warps_m=1, a_warps_n=1)),
    ("integer and zero shifts", (2, 3, 4, 6), 16, 24, 2, "integer", {}),
    ("a tile over five frames", (1, 4, 2, 4), 8, 16, 1, "frac",
     dict(a_warps_m=2, a_warps_n=1)),
    ("column chunks, 14x14 288 -> 576, one clip", (1, 8, 14, 14), 288, 576,
     1, "frac", {}),
]


@pytest.mark.parametrize("case", K2_CASES, ids=[c[0] for c in K2_CASES])
def test_k2_gate_off_the_model(case):
    _, dims, c, k, kind, knobs = case
    plan = fb.fused_block_plan((*dims, c), BF, sms=SMS,
                               gate=(fb.kernel_taps(k, kind == "quantize"),
                                     k), **knobs).a
    check_gate(dims, c, k, kind, 1, plan, seed=sum(dims) + c + k)


@pytest.mark.parametrize("case", K3_CASES, ids=[c[0] for c in K3_CASES])
def test_k3_gate_off_the_model(case):
    _, dims, cin, cm, k, kind, knobs = case
    plan = fe.fused_entry_plan((*dims, cin), cm, BF, sms=SMS, **knobs).a
    if cm == 576:
        assert plan.n_tiles > 1
    check_gate(dims, cm, k, kind, 2, plan, seed=sum(dims) + cm + k)


def test_tables_keep_the_borders_only():
    """Per axis lo + hi + stride entries, whatever the extent: K entries at
    each edge (one more at the low edge with the quantized tap at K + 1,
    one more at the high edge at stride 2), the rest one value (a parity's
    at stride 2)."""
    assert table_borders(3, 1, 1) == (1, 1)
    assert table_borders(4, 1, 1) == (2, 1)
    assert table_borders(3, 1, 2) == (1, 2)
    assert table_borders(16, 7, 1) == (8, 7)
    rng = np.random.default_rng(3)
    for stride, d in ((1, 112), (2, 112), (1, 2), (2, 2), (1, 9)):
        taps = random_taps(rng, 5, 1, "frac")
        rows = axis_weights(taps[3:6], 1, stride, d)  # checks each row
        assert rows.shape == (d, 5)


# -------------------------------- (c) against the JAX package, float32


def block_run_with_emulated_gate(x, vt, wm, se, aq, k, plan):
    """A run as rubiks_fused_block_run makes it on the tensor-core route
    with the gate: launch A (test_torch_fused_block_plan's emulation), its
    partials, the gate launch, launch B."""
    n, t, h, w, c = x.shape
    dims = (n, t, h, w)
    tn = fb.taps_from_rows(vt.shape[1], 4, aq)
    out = torch.empty((n * t * h * w, c))
    mid = torch.empty_like(out)
    src = x.reshape(-1, c)
    for b in range(vt.shape[0]):
        block_launch_a(src, mid, vt[b], wm[b, 0], dims, plan.a, aq, tn)
        taps = vt[b, 4:4 + 3 * tn]
        partial = emulate_partials(mid, taps, k, 1, plan.a, dims)
        gate, _ = emulate_gate(partial, taps[:tn], se[b], dims, plan.a.rows,
                               k, 1.0 / (h * w))
        block_launch_b(src, mid, out, vt[b], wm[b, 1], gate, dims, plan.b, k,
                       tn)
        src = out
    return out.reshape(x.shape)


@pytest.mark.parametrize("aq", [False, True])
def test_block_with_the_emulated_gate_matches_jax(aq):
    """Two SE blocks (and aq) at 5 x 6, 16-row tiles that cross frames."""
    c = 24
    rng, blocks, tblocks = _option_run(70 + aq, c, aq, True)
    x = rng.standard_normal((2, 3, 5, 6, c)).astype(np.float32)
    vt, wm, sep = _stack(tblocks, torch.float32, aq, True)
    plan = fb.fused_block_plan(x.shape, BF, sms=SMS, warps_m=1, warps_n=1)
    got = block_run_with_emulated_gate(torch.from_numpy(x), vt, wm, sep, aq,
                                       1, plan)
    params, stats = [p for p, _ in blocks], [s for _, s in blocks]
    stack = jfb.stack_block_params_aq if aq else jfb.stack_block_params
    jvt, jwm = stack(params, stats, jnp.float32, 1)
    kernel = jfb.fused_block_run(jnp.asarray(x), jvt, jwm,
                                 jfb.stack_se_params(params), aq=aq,
                                 max_shift=1, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=TOL_JAX,
                               atol=TOL_JAX)
    plain = fb.fused_block_plain(torch.from_numpy(x), vt, wm, sep, aq=aq,
                                 max_shift=1)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL_JAX,
                               atol=TOL_JAX)


@pytest.mark.parametrize("cin,cm,k", [(12, 24, 1), (24, 48, 2)])
def test_entry_with_the_emulated_gate_matches_jax(cin, cm, k):
    """One SE entry at 8 x 10 -> 4 x 5, launch A in 32-row tiles."""
    rng = np.random.default_rng(cin + cm + k)
    p, s = make_block(rng, cin, cm, k - 0.2, stride=2, se=True)
    x = rng.standard_normal((2, 3, 8, 10, cin)).astype(np.float32)
    blk = torch_block(p, s, cin, cm, stride=2)
    params = fe.stack_entry_params(blk, torch.float32, k)
    se = fb.stack_se_params([blk])[0]
    vt1, vt2, w2, w3, wsc = params
    n, t, h, w, _ = x.shape
    dims = (n, t, h, w)
    plan = fe.fused_entry_plan(x.shape, cm, BF, sms=SMS, a_warps_m=2,
                               a_warps_n=1, b_warps_m=1, b_warps_n=1)
    tn = fb.taps_from_rows(vt2.shape[0], 2)
    mid = torch.empty((n * t * h * w, cm))
    entry_launch_a(torch.from_numpy(x).reshape(-1, cin), mid, vt1, vt2, w2,
                   plan.a)
    taps = vt2[2:2 + 3 * tn]
    partial = emulate_partials(mid, taps, k, 2, plan.a, dims)
    gate, _ = emulate_gate(partial, taps[:tn], se, dims, plan.a.rows, k,
                           1.0 / ((h // 2) * (w // 2)))
    out = torch.empty((n * t * (h // 2) * (w // 2), cm))
    entry_launch_b(torch.from_numpy(x).reshape(-1, cin), mid, out, vt1, vt2,
                   w3, wsc, gate, dims, plan, k, tn)
    got = out.reshape(n, t, h // 2, w // 2, cm).numpy()
    jparams = jfe.stack_entry_params(p, s, jnp.float32, k, False)
    kernel = jfe.fused_entry_run(jnp.asarray(x), jparams,
                                 jfb.stack_se_params([p])[0], max_shift=k,
                                 interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=TOL_JAX,
                               atol=TOL_JAX)
