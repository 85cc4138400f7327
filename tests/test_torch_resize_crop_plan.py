"""The staged ``resize_crop_u8`` (``rubiksnet_torch/data/csrc/
device_loader.cu::resize_crop_u8_staged``) on the CPU, where it cannot run:
its decomposition emulated in numpy from the bytes the wrapper sends
(``staged_tables``), the tables it keeps on the device (``axis_table``) and
its launch plan (``resize_crop_plan``), held bit for bit against
``plain_resize_crop`` (itself bit for bit the C++ loader,
tests/test_torch_device_loader.py).

The emulation walks the blocks as the kernel does: a band of output rows
and a tile of columns of one crop; a resized frame's block stages its taps,
then the aligned 16-byte words that cover each source row's span (the
address's low four bits taken from a chosen base of the buffer), computes
the horizontal pass once per staged row, column and channel, rounded to
float32 and kept as its double, and the vertical pass from those (the
truncation of t >= 0 as the kernel's add rounded toward zero); a frame only
cropped is copied from two aligned words shifted into place, as
``load_shifted`` selects and funnel-shifts them. Every tap read must land
on a staged byte, and every output byte is written exactly once.
``chip_smoke.py`` phase 7 holds the kernel itself to ``plain_resize_crop``
on the card."""

import re

import numpy as np
import pytest
import torch

from rubiksnet_torch.data import device_loader as dl
from rubiksnet_torch.data.native_eval import center_offset, full_res_offsets

torch.set_num_threads(1)

CU = dl.SOURCE.read_text()
UNSTAGED = -1  # a shared-memory byte no copy wrote


def round_byte(acc):
    """``round_byte``: trunc(acc + 0.5) (the add of 2^52 rounded toward
    zero is floor for t >= 0), clamped."""
    t = acc + 0.5
    assert (t >= 0).all()
    return np.clip(np.floor(t), 0, 255).astype(np.int64)


def funnel_r(lo, hi, r):
    return int(((hi << 32 | lo) >> r) & 0xFFFFFFFF)


def load_shifted(mem, addr, base):
    """``load_shifted``: the 16 bytes at ``addr`` from the aligned words
    that cover them; ``mem`` is the buffer padded by 16 bytes a side."""
    a, sh = addr & ~15, addr & 15
    words = mem[a - base + 16:a - base + 48].astype(np.int64)
    w = [int(words[4 * j]) | int(words[4 * j + 1]) << 8
         | int(words[4 * j + 2]) << 16 | int(words[4 * j + 3]) << 24
         for j in range(8)]
    if sh == 0:
        out = w[:4]
    else:
        q, r = sh >> 2, (sh & 3) * 8
        s = [w[i + q] for i in range(5)]
        out = [funnel_r(s[i], s[i + 1], r) for i in range(4)]
    return np.array([(v >> (8 * b)) & 255 for v in out for b in range(4)])


def device_tables():
    """Pointer -> array of every table ``axis_table`` holds on the CPU."""
    out = {}
    for (dev, _, _), t in dl._AXIS_TABLES.items():
        if dev.type == "cpu":
            out[t.taps.data_ptr()] = t.taps.numpy()
            out[t.weights.data_ptr()] = t.weights.numpy()
    return out


def emulate_staged(rgb, sizes, scale, crop, origins, group, base=0,
                   aligned=True):
    """``resize_crop_u8_staged``'s work, block by block; ``base``: the
    address of rgb's first byte (its low four bits set the alignment of
    every row). -> (output, writes per output byte, plan)."""
    sizes, resized, origins, k, group = dl.frame_geometry(
        sizes, scale, crop, origins, group)
    n = len(sizes)
    buf, at, axes = dl.staged_tables(sizes, resized, origins, scale, "cpu")
    plan = dl.resize_crop_plan(crop, axes, aligned)
    desc = buf[:n * dl.STAGED_FRAME.itemsize].view(dl.STAGED_FRAME)
    orig = buf[at:].view(np.int32).reshape(n, k, 2)
    tables = device_tables()
    src = rgb.numpy()
    mem = np.concatenate([np.zeros(16, np.uint8), src,
                          np.zeros(48, np.uint8)])
    rowb = crop * 3
    out = np.full(n * k * crop * rowb, UNSTAGED, np.int64)
    writes = np.zeros(out.size, np.int64)
    for o in range(n * k):
        r = o % (k * group)
        kc, i = r // group, (o // (k * group)) * group + r % group
        d = desc[i]
        w = int(d["w"])
        blocks = [(run, tile) for run in range(plan.runs)
                  for tile in range(plan.tiles)]
        for run, tile in blocks:
            for band in range(run * plan.run,
                              min((run + 1) * plan.run, plan.bands)):
                y0, x0 = band * plan.rows, tile * plan.tile
                rows = min(plan.rows, crop - y0)
                cols = min(plan.tile, crop - x0)
                fx0 = int(orig[i, kc, 0]) + x0
                fy0 = int(orig[i, kc, 1]) + y0
                dst = (o * crop + y0) * rowb + x0 * 3
                at_row = [base + int(d["src_off"]) + ((fy0 + y) * w + fx0) * 3
                          for y in range(rows)]
                if d["xt"] == 0:  # copy
                    if plan.vec:
                        assert cols == crop and rowb % 16 == 0
                        for y in range(rows):
                            for j in range(rowb // 16):
                                at_o = dst + y * rowb + 16 * j
                                out[at_o:at_o + 16] = load_shifted(
                                    mem, at_row[y] + 16 * j, base)
                                writes[at_o:at_o + 16] += 1
                    else:
                        for y in range(rows):
                            a = at_row[y] - base
                            out[dst + y * rowb:dst + y * rowb + cols * 3] = (
                                src[a:a + cols * 3])
                            writes[dst + y * rowb:
                                   dst + y * rowb + cols * 3] += 1
                    continue
                xt, xw = tables[int(d["xt"])], tables[int(d["xw"])]
                yt, yw = tables[int(d["yt"])], tables[int(d["yw"])]
                kx, ky = int(d["kx"]), int(d["ky"])
                assert kx <= plan.kx and ky <= plan.ky
                ct, cw = xt[fx0:fx0 + cols], xw[fx0:fx0 + cols, :kx].T
                rt, rw = yt[fy0:fy0 + rows], yw[fy0:fy0 + rows, :ky]
                c0, c1 = ct[0, 0], ct[-1, 0] + ct[-1, 1]
                r0, r1 = rt[0, 0], rt[-1, 0] + rt[-1, 1]
                assert (ct[:, 0] >= c0).all() and (ct.sum(1) <= c1).all()
                assert (rt[:, 0] >= r0).all() and (rt.sum(1) <= r1).all()
                S, nb = int(r1 - r0), int(c1 - c0) * 3
                assert S <= plan.smax and nb + 15 <= plan.pitch
                # 2. the staged words of each row's span
                sv = np.full((S, plan.pitch), UNSTAGED, np.int64)
                row0 = base + int(d["src_off"]) + (int(r0) * w + int(c0)) * 3
                shs = []
                for sr in range(S):
                    g = row0 + sr * w * 3
                    sh, a = g & 15, g & ~15
                    shs.append(sh)
                    for wd in range(plan.pitch // 16):
                        if wd * 16 < sh + nb:
                            at_m = a + wd * 16 - base + 16
                            sv[sr, wd * 16:wd * 16 + 16] = mem[at_m:at_m + 16]
                # 3. the horizontal pass, once per staged row and column
                hp = np.zeros((S, cols * 3))
                xs = np.arange(cols)
                for sr in range(S):
                    for ch in range(3):
                        h = np.zeros(cols)
                        for b in range(int(ct[:, 1].max())):
                            live = b < ct[:, 1]
                            at_b = shs[sr] + (ct[:, 0] - c0) * 3 + ch + 3 * b
                            px = sv[sr, np.where(live, at_b, 0)]
                            assert (px[live] != UNSTAGED).all()
                            p = cw[b] * px.astype(np.float64)
                            h = np.where(live, p if b == 0 else h + p, h)
                        hp[sr, xs * 3 + ch] = h.astype(np.float32)
                # 4. the vertical pass from those floats
                for y in range(rows):
                    lo, cnt = int(rt[y, 0]), int(rt[y, 1])
                    acc = np.zeros(cols * 3)
                    for a in range(cnt):
                        p = rw[y, a] * hp[lo - r0 + a]
                        acc = p if a == 0 else acc + p
                    at_o = dst + y * rowb
                    out[at_o:at_o + cols * 3] = round_byte(acc)
                    writes[at_o:at_o + cols * 3] += 1
    return (out.reshape(n * k, crop, crop, 3), writes, plan)


def frames_of(shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for w, h in shapes]


def protocol_origins(sizes, scale, crop, crops):
    out = []
    for w, h, _ in sizes.tolist():
        rw, rh = dl.resized_size(w, h, scale)
        out.append(full_res_offsets(rw, rh, crop) if crops == 3
                   else [center_offset(rw, rh, crop)])
    return out


# (id, frame shapes, scale, crop, groups of the batch): the small mixed
# batch of tests/test_torch_device_loader.py (upscales, no resize, ksize 5
# and 7 downscales, both orientations), the evaluator's frames only cropped
# (340x256 at 256), the raw SSv2 frames upscaled 240 -> 256, a ksize-5
# downscale (480x360 -> 341x256), and all three kinds in one batch.
SMALL = [(96, 68), (68, 96), (60, 40), (100, 72), (150, 110), (200, 90),
         (90, 170)]
CASES = [
    ("mixed-small", SMALL, 72, 64, (1, 7)),
    ("copy-340x256", [(340, 256)] * 2, 256, 224, (1, 2)),
    ("up-427x240", [(427, 240)] * 2, 256, 224, (1, 2)),
    ("down-480x360", [(480, 360)], 256, 224, (1,)),
    ("mixed-kinds", [(340, 256), (427, 240), (480, 360)], 256, 224, (1,)),
]


@pytest.mark.parametrize("crops", [1, 3])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_staged_decomposition_equals_plain(case, crops):
    _, shapes, scale, crop, groups = case
    rgb, sizes = dl.pack_frames(frames_of(shapes))
    origins = protocol_origins(sizes, scale, crop, crops)
    for group in groups:
        want = dl.plain_resize_crop(rgb, sizes, scale, crop, origins, group)
        got, writes, _ = emulate_staged(rgb, sizes, scale, crop, origins,
                                        group)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("base,aligned", [(5, True), (11, False)])
def test_unaligned_buffer_and_output(base, aligned):
    """Rows that start anywhere in their 16-byte word (the buffer's first
    byte off 16 bytes), and an output that is not 16-byte aligned (the copy
    then goes byte by byte)."""
    shapes = [(340, 256), (427, 240)]
    rgb, sizes = dl.pack_frames(frames_of(shapes, seed=1))
    origins = protocol_origins(sizes, 256, 224, 3)
    want = dl.plain_resize_crop(rgb, sizes, 256, 224, origins, 1)
    got, writes, plan = emulate_staged(rgb, sizes, 256, 224, origins, 1,
                                       base=base, aligned=aligned)
    assert plan.vec == int(aligned)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want.numpy())


def test_tiles_where_a_band_does_not_fit(monkeypatch):
    """A small shared-memory budget splits the crop's width into tiles
    (multiples of 4 columns, the last ragged): still every byte once."""
    monkeypatch.setattr(dl, "SMEM_BUDGET", 12 * 1024)
    shapes = [(1280, 720), (340, 256)]
    rgb, sizes = dl.pack_frames(frames_of(shapes, seed=2))
    origins = protocol_origins(sizes, 256, 224, 1)
    want = dl.plain_resize_crop(rgb, sizes, 256, 224, origins, 1)
    got, writes, plan = emulate_staged(rgb, sizes, 256, 224, origins, 1)
    assert plan.tiles > 1 and plan.tile % 4 == 0 and plan.vec == 0
    assert plan.smem <= 12 * 1024
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want.numpy())


def test_bit_forms():
    """The kernel's exact forms: 2^52 + v - 2^52 is the byte v; a sum that
    starts at its first product equals one that starts at 0.0 (products of
    non-negative weights and bytes are >= +0)."""
    rng = np.random.RandomState(0)
    p = np.concatenate([[0.0], rng.uniform(0, 255, 1000)])
    np.testing.assert_array_equal(0.0 + p, p)
    assert not np.signbit(0.0 + 0.0)
    two52 = 2.0 ** 52
    v = np.arange(256)
    hi = ((np.uint64(0x43300000) << np.uint64(32))
          | v.astype(np.uint64)).view(np.float64)
    np.testing.assert_array_equal(hi - two52, v.astype(np.float64))


# --------------------------------------------------------------- the plan

# Every (frame, scale, crop) the card's runs give the kernel: phase 7's
# LOADER_FRAMES at scale 256 and crop 224 (alone and all in one batch),
# the evaluator's and the data bench's frames (340x256, 427x240).
LOADER_FRAMES = [(340, 256), (427, 240), (240, 320), (200, 150),
                 (480, 360), (1280, 720)]


def axes_of(shapes, scale):
    return tuple((w, dl.resized_size(w, h, scale)[0]) for w, h in shapes
                 if dl.resizes(w, h, scale)), tuple(
        (h, dl.resized_size(w, h, scale)[1]) for w, h in shapes
        if dl.resizes(w, h, scale))


@pytest.mark.parametrize("shapes", [[s] for s in LOADER_FRAMES]
                         + [LOADER_FRAMES],
                         ids=[f"{w}x{h}" for w, h in LOADER_FRAMES] + ["all"])
def test_plan_fits_and_covers(shapes):
    xs, ys = axes_of(shapes, 256)
    axes = tuple(zip(xs, ys))
    plan = dl.resize_crop_plan(224, axes)
    assert plan.smem <= dl.SMEM_BUDGET <= dl.SMEM_LIMIT
    assert plan.bands * plan.rows >= 224 > (plan.bands - 1) * plan.rows
    assert plan.runs * plan.run >= plan.bands > (plan.runs - 1) * plan.run
    assert plan.tiles * plan.tile >= 224
    assert len(plan) == int(re.search(r"kPlanLen = (\d+);", CU).group(1))
    if not axes:
        assert plan.smem == 0 and plan.vec == 1
        return
    offs = (plan.off_cw, plan.off_rw, plan.off_hp, plan.off_src,
            plan.off_ct, plan.off_rt)
    assert all(v % 16 == 0 for v in offs) and list(offs) == sorted(offs)
    assert plan.pitch % 16 == 0 and plan.hp_pitch % 4 == 0
    # Every window of `rows` output rows and `tile` columns, at every
    # origin, reaches at most smax staged rows and pitch - 15 bytes.
    for (w, rw), (h, rh) in axes:
        for size, out, window, most in ((h, rh, plan.rows, plan.smax),
                                        (w, rw, plan.tile,
                                         (plan.pitch - 15) // 3)):
            co = dl.triangle_coeffs(size, out)
            for start in range(out - window + 1):
                lo = co.lo[start]
                end = co.lo[start + window - 1] + co.counts[start + window - 1]
                assert end - lo <= most


def test_plan_constants_match_the_source():
    assert dl.SMEM_LIMIT == int(re.search(r"kMaxSmem = (\d+);", CU).group(1))
    assert dl.MAX_THREADS == int(
        re.search(r"kMaxThreads = (\d+);", CU).group(1))
    assert dl.STAGED_FRAME.itemsize == int(
        re.search(r"sizeof\(StagedFrame\) == (\d+)", CU).group(1))
    fields = re.search(r"struct StagedPlan \{(.*?)\};", CU, re.S).group(1)
    names = re.findall(r"\w+", re.sub(r"\bint\b", "", fields))
    assert tuple(names) + ("smem",) == dl.ResizeCropPlan._fields


def test_plan_rows_follow_the_knobs(monkeypatch):
    axes = (((427, 455), (240, 256)),)
    assert dl.resize_crop_plan(224, axes).rows == dl.BAND_ROWS
    monkeypatch.setattr(dl, "BAND_ROWS", 8)
    monkeypatch.setattr(dl, "RUN_BANDS", 5)
    monkeypatch.setattr(dl, "THREADS", 256)
    plan = dl.resize_crop_plan(224, axes)
    assert (plan.rows, plan.threads, plan.bands) == (8, 256, 28)
    assert (plan.run, plan.runs) == (5, 6)
    assert dl.resize_crop_plan(224, ()).rows == dl.COPY_ROWS
    monkeypatch.setattr(dl, "THREADS", 1024)
    with pytest.raises(ValueError, match="threads"):
        dl.resize_crop_plan(224, axes)
    monkeypatch.setattr(dl, "THREADS", 256)
    with pytest.raises(ValueError, match="no block"):
        monkeypatch.setattr(dl, "SMEM_BUDGET", 256)
        dl.resize_crop_plan(224, axes)


# ------------------------------------------------------------ the tables


def test_tables_go_to_the_device_once():
    """A second batch of the same sizes uploads nothing; a new size adds
    one table a new axis; the descriptors point at the kept tables."""
    rgb, sizes = dl.pack_frames(frames_of([(427, 240)] * 2, seed=3))
    geo = dl.frame_geometry(sizes, 256, 224, [[(-1, -1)]] * 2)
    dl.staged_tables(geo[0], geo[1], geo[2], 256, "cpu")
    before, keys = dl.TABLE_UPLOADS.count, set(dl._AXIS_TABLES)
    buf, at, axes = dl.staged_tables(geo[0], geo[1], geo[2], 256, "cpu")
    assert dl.TABLE_UPLOADS.count == before and set(dl._AXIS_TABLES) == keys
    assert axes == (((427, 455), (240, 256)),)
    desc = buf[:2 * dl.STAGED_FRAME.itemsize].view(dl.STAGED_FRAME)
    tx = dl.axis_table("cpu", 427, 455)
    assert (desc["xt"] == tx.taps.data_ptr()).all()
    assert (desc["kx"] == tx.ksize).all()
    np.testing.assert_array_equal(tx.weights.numpy(),
                                  dl.triangle_coeffs(427, 455).weights)
    new = next(s for s in range(300, 400)
               if (torch.device("cpu"), s, 256) not in dl._AXIS_TABLES)
    dl.axis_table("cpu", new, 256)
    assert dl.TABLE_UPLOADS.count == before + 1
    assert set(dl._AXIS_TABLES) - keys == {(torch.device("cpu"), new, 256)}


def test_tables_upload_once_under_threads():
    """The loader's prefetch thread and the caller share the cache: many
    threads asking at once for a new size upload it once and get the same
    tables."""
    import sys
    import threading

    new = next(s for s in range(400, 500)
               if (torch.device("cpu"), s, 200) not in dl._AXIS_TABLES)
    before = dl.TABLE_UPLOADS.count
    got, start = [], threading.Barrier(16)

    def ask():
        start.wait(timeout=10)
        for _ in range(20):
            got.append(dl.axis_table("cpu", new, 200))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 320 and all(g is got[0] for g in got)
    assert dl.TABLE_UPLOADS.count == before + 1


def test_a_frame_only_cropped_has_no_tables():
    rgb, sizes = dl.pack_frames(frames_of([(340, 256)], seed=4))
    geo = dl.frame_geometry(sizes, 256, 224, [[(-1, -1)]])
    buf, at, axes = dl.staged_tables(geo[0], geo[1], geo[2], 256, "cpu")
    desc = buf[:dl.STAGED_FRAME.itemsize].view(dl.STAGED_FRAME)
    assert axes == () and desc["xt"][0] == 0 and desc["kx"][0] == 0
    assert buf[at:].view(np.int32).tolist() == [58, 16]
