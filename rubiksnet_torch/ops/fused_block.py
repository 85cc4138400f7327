"""A run of stride-1 identity-shortcut RubiksNet blocks, inference (K2).

Each block computes

    x <- x + W3 . [SE] shift3d(relu(bn2(W2 . [AQ] relu(bn1(x)))))

with BN folded to scale/bias and the shift given as per-axis tap weights.
``aq=True`` (the rubiks3d-aq variant) mixes the activated input along T with
three per-channel attention taps before W2, and its shift is 2D: the T tap
row is the identity. ``se`` (the SE tiers) gates the shifted activation per
(clip, frame, channel) by ``sigmoid(relu(mean_hw . fc1) . fc2)`` before W3.
Counterpart of ``rubiksnet_tpu/ops/pallas/fused_block.py`` and
``ops/pallas/fused_frames.py`` (the same contract).
:func:`fused_block_run` makes one call into ``csrc/fused_block.cu`` per run
for a CUDA tensor (bfloat16: the tensor-core kernels of
``csrc/fused_block_tc.cu`` under :func:`fused_block_plan`, the gate's sums
in launch A and one gate launch, ``csrc/se_gate_tc.cu``; float32: the SIMT
GEMM of ``csrc/common.cuh`` and the two gate launches of
``csrc/se_gate.cuh``), and runs :func:`fused_block_plain` for a CPU tensor.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..utils.profiling import LaunchCounter
from . import _build
from .attention_shift import TEMPERATURE, attention_shift_weights
from .shift3d import shift_tap_weights

BN_EPS = 1e-5
KERNEL_MAX_TAPS = 16  # taps per axis the CUDA kernels stage (max_shift <= 7)

LAUNCHES = LaunchCounter("fused_block")
# The SE gate launch of the tensor-core route (csrc/se_gate_tc.cu), one per
# SE block of K2 and K3.
SE_GATE_LAUNCHES = LaunchCounter("se_gate")


def fold_bn(gamma, beta, mean, var, eps=BN_EPS):
    """Inference batch norm as y = scale * x + bias."""
    scale = gamma / torch.sqrt(var + eps)
    return scale, beta - mean * scale


def check_shift_bound(shift: torch.Tensor, max_shift: int,
                      quantize: bool) -> None:
    """Raise if the tap window [-K, K+1] cannot represent every shift.

    The gather form and K1 take any shift; the tap-weight form of the fused
    kernels holds fractional shifts in [-K, K] and quantized shifts that
    round into [-K, K+1]. Outside that they would read zero silently.
    """
    s = shift.detach().to(torch.float32)
    if quantize:
        f = torch.floor(s)
        q = torch.where(s - f < 0.5, f, f + 1)
        bad = bool(((q < -max_shift) | (q > max_shift + 1)).any())
    else:
        bad = bool(((s < -max_shift) | (s > max_shift)).any())
    if bad:
        raise ValueError(
            f"shift values outside the max_shift={max_shift} tap window "
            f"(quantize={quantize}); build the model with a larger max_shift")


def kernel_taps(max_shift: int, quantize: bool = False) -> int:
    """Taps per axis of the tap-weight form (:func:`stack_taps`)."""
    return 2 * max_shift + 2 if quantize else 2 * max_shift + 1


def stack_taps(shift, dtype, max_shift, quantize):
    """(3 * taps_n, C) float32 tap weights of a (3, C) shift.

    Fractional mode drops the tap at offset K+1, identically zero whenever
    |s| <= K. Quantize mode keeps it: a shift in (K+0.5, K+1] rounds onto it.
    """
    check_shift_bound(shift, max_shift, quantize)
    tn = kernel_taps(max_shift, quantize)
    return torch.cat([
        shift_tap_weights(shift[a], dtype, max_shift, quantize)[:tn]
        for a in range(3)
    ]).to(torch.float32)


def _bn_fold(bn):
    return fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var)


def conv1x1_matrix(conv, dtype):
    """A 1x1 conv weight (out, in, 1, 1) as an (in, out) matrix in dtype."""
    w = conv.weight
    return w.reshape(w.shape[0], w.shape[1]).t().to(dtype).contiguous()


@torch.no_grad()
def stack_block_params(blocks, dtype, max_shift, quantize=False):
    """Stack stride-1 RubiksShiftBlock modules into the kernel's arrays.

    Returns vt (B, 4 + 3*taps_n, C) float32 = folded bn1 scale/bias, bn2
    scale/bias, then the T, H, W tap weights; and wm (B, 2, C, C) in dtype =
    conv2 and conv3 as (in, out).
    """
    vts, wms = [], []
    for blk in blocks:
        s1, b1 = _bn_fold(blk.bn1)
        s2, b2 = _bn_fold(blk.bn2)
        taps = stack_taps(blk.as3.rubiks3d.shift, dtype, max_shift, quantize)
        vts.append(torch.cat([torch.stack([s1, b1, s2, b2]).float(), taps]))
        wms.append(torch.stack([conv1x1_matrix(blk.conv2, dtype),
                                conv1x1_matrix(blk.conv3, dtype)]))
    return torch.stack(vts).contiguous(), torch.stack(wms).contiguous()


@torch.no_grad()
def stack_block_params_aq(blocks, dtype, max_shift):
    """Stack stride-1 rubiks3d-aq blocks: vt (B, 4 + 3*taps_n + 3, C) =
    folded BN rows, an identity T tap row block, the H and W taps of the
    (2, C) shift, then the three rows of normalized attention weights; wm
    as :func:`stack_block_params`. Fractional shifts only: the 2D quantize
    rule has no tap form."""
    vts, wms = [], []
    for blk in blocks:
        s1, b1 = _bn_fold(blk.bn1)
        s2, b2 = _bn_fold(blk.bn2)
        shift2d = blk.as3.shift
        shift3 = torch.cat([torch.zeros_like(shift2d[:1]), shift2d])
        taps = stack_taps(shift3, dtype, max_shift, False)
        aw = attention_shift_weights(blk.aq_shift.weight.to(dtype),
                                     TEMPERATURE).float()  # (C, 3)
        vts.append(torch.cat([torch.stack([s1, b1, s2, b2]).float(), taps,
                              aw.t()]))
        wms.append(torch.stack([conv1x1_matrix(blk.conv2_1x1, dtype),
                                conv1x1_matrix(blk.conv3, dtype)]))
    return torch.stack(vts).contiguous(), torch.stack(wms).contiguous()


@torch.no_grad()
def stack_se_params(blocks):
    """(B, 2, C, Cr) float32 SE weights of the blocks: slot 0 = fc1 as
    (C, Cr), slot 1 = fc2 transposed, also (C, Cr)."""
    return torch.stack([
        torch.stack([blk.se.fc[0].weight.t().float(),
                     blk.se.fc[2].weight.float()])
        for blk in blocks]).contiguous()


def se_gate(v, se):
    """The SE gate (N, T, C) float32 of a shifted activation v
    (N, T, H, W, C) float32 for weights se (2, C, Cr): per-frame spatial
    mean, fc1, ReLU, fc2, sigmoid."""
    m = v.mean(dim=(2, 3))
    return torch.sigmoid(torch.relu(m @ se[0]) @ se[1].t())


def taps_from_rows(rows: int, head: int, aq: bool = False) -> int:
    """Taps per axis of a stacked parameter array with ``head`` BN rows
    (and, with ``aq``, three trailing attention rows)."""
    taps_n, rem = divmod(rows - head - (3 if aq else 0), 3)
    if rem or taps_n < 1:
        raise ValueError(f"{rows} rows is not {head} + 3*taps")
    return taps_n


def tap_shift(v: torch.Tensor, taps: torch.Tensor, max_shift: int):
    """Separable tap sum of v (N, T, H, W, C), float32: along T, H and W,
    out[i] = sum_j w[j] * v[i + j - K] with zero fill. taps: (3*tn, C)."""
    tn = taps.shape[0] // 3
    k = max_shift
    out = v
    for a, axis in enumerate((1, 2, 3)):
        d = out.shape[axis]
        pad = [0] * 8  # F.pad order: C, W, H, T (low, high)
        slot = 2 * (4 - axis)
        pad[slot], pad[slot + 1] = k, max(tn - 1 - k, 0)
        vp = F.pad(out, pad)
        w = taps[a * tn:(a + 1) * tn]
        acc = None
        for j in range(tn):
            term = w[j] * vp.narrow(axis, j, d)
            acc = term if acc is None else acc + term
        out = acc
    return out


def aq_mix(a, aw):
    """The attention mix of the rubiks3d-aq blocks' fused forms: ``w0 *
    a[t-1] + w1 * a[t] + w2 * a[t+1]`` along T of a (N, T, H, W, C), zero
    boundary frames, in float32 and rounded to a's dtype once; aw: the three
    (C,) rows of normalized attention weights."""
    w0, w1, w2 = aw
    ap = F.pad(a.float(), (0, 0, 0, 0, 0, 0, 1, 1))
    t = a.shape[1]
    return (w0 * ap[:, 0:t] + w1 * ap[:, 1:t + 1]
            + w2 * ap[:, 2:t + 2]).to(a.dtype)


def fused_block_plain(x, vt, wm, se=None, *, aq=False, max_shift):
    """The B blocks in sequence, in plain PyTorch."""
    taps_n = taps_from_rows(vt.shape[1], 4, aq)
    dt = x.dtype
    for b in range(vt.shape[0]):
        s1, b1, s2, b2 = vt[b, 0], vt[b, 1], vt[b, 2], vt[b, 3]
        a = torch.relu(x.float() * s1 + b1).to(dt)
        if aq:
            a = aq_mix(a, vt[b, 4 + 3 * taps_n:])
        mid = torch.relu((a @ wm[b, 0]).float() * s2 + b2).to(dt)
        v = tap_shift(mid.float(), vt[b, 4:4 + 3 * taps_n], max_shift)
        if se is not None:
            v = v * se_gate(v, se[b])[:, :, None, None, :]
        x = (x.float() + (v.to(dt) @ wm[b, 1]).float()).to(dt)
    return x


def _check_args(x, vt, wm, se, aq, max_shift):
    if x.ndim != 5:
        raise ValueError(f"x must be (N, T, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    nb = vt.shape[0]
    taps_n = taps_from_rows(vt.shape[1], 4, aq)
    rows = 4 + 3 * taps_n + (3 if aq else 0)
    if vt.shape != (nb, rows, c) or vt.dtype != torch.float32:
        raise ValueError(f"vt must be float32 (B, {rows}, {c}), got "
                         f"{vt.dtype} {tuple(vt.shape)}")
    if taps_n > 2 * max_shift + 2:
        raise ValueError(f"{taps_n} taps exceed max_shift={max_shift}")
    if wm.shape != (nb, 2, c, c) or wm.dtype != x.dtype:
        raise ValueError(f"wm must be {x.dtype} ({nb}, 2, {c}, {c}), got "
                         f"{wm.dtype} {tuple(wm.shape)}")
    if se is not None and (se.ndim != 4 or se.shape[:3] != (nb, 2, c)
                           or se.dtype != torch.float32):
        raise ValueError(f"se must be float32 ({nb}, 2, {c}, Cr), got "
                         f"{se.dtype} {tuple(se.shape)}")
    return taps_n


SE_ROWS = 8  # rows of H one block of the SE reduction's first pass sums


def se_slices(h: int) -> int:
    """Row slices per frame of the SE reduction's first pass (the "simt"
    route). It depends on the shape only, so the summation order is fixed."""
    return -(-h // SE_ROWS)


def se_partial_shape(plan, shape):
    """(row tiles, frame slots, C) of the SE gate's partials on the
    tensor-core route: launch A (under ``plan``, a :class:`BlockPlan`: K2's,
    or K3's ``plan.a``) leaves, per row tile of ``plan.rows`` rows of the
    (N*T*H*W, C) ``mid`` of ``shape`` (N, T, H, W, C), one weighted sum per
    frame the tile can touch and channel (csrc/tc_se.cuh::tc_se_slots). The
    C side sizes and checks the shared memory of the sums."""
    n, t, h, w, c = shape
    hw = h * w
    return (max(1, _ceil_div(n * t * hw, plan.rows)),
            (plan.rows + hw - 2) // hw + 1, c)


# ------------------------------------------------------- the launch plan

SM_COUNT = 132          # streaming multiprocessors of the H100
SMEM_LIMIT = 232448     # bytes of shared memory a block can use
WARP_COLS = 72          # columns a warp owns: 9 mma tiles of 8
WARP_ROWS = 16          # rows a warp owns: one mma tile
MAX_WARPS = 16          # warps per block (512 threads of <= 128 registers)


class NoPlan(ValueError):
    """No launch plan of the kernel fits its limits (warps, shared memory)
    at a shape: the one refusal ``fused_*_supported`` turns into a
    decline. Every other error of a plan is a fault and propagates."""


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def tile_row_stride(cols: int) -> int:
    """Elements from one row of a shared-memory bf16 tile to the next: the
    width rounded up to 8, plus 8 or 16 so that rows lie an odd number of
    16-byte units apart (csrc/fused_block_tc.cuh::tc_row_stride)."""
    rs = _ceil_div(cols, 8) * 8 + 8
    return rs + 8 if (rs // 8) % 2 == 0 else rs


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """How one block of a run is launched (both GEMM launches share it): the
    numbers ``rubiks_fused_block_run`` takes. On the "simt" route the C side
    tiles by itself (csrc/common.cuh::launch_gemm) and the numbers are 0."""

    route: str        # "mma": tensor cores, bf16; "simt": the common.cuh GEMM
    producers: int = 0   # warps that only load the next tile (0: none)
    warps_m: int = 0     # multiplying warps of a block along the rows
    warps_n: int = 0     # and along the columns
    n_tiles: int = 0     # column chunks (grid.y)
    grid_x: int = 0      # persistent blocks along the row tiles
    smem_bytes: int = 0
    overlap: bool = False  # a launch may begin before the one before it ended

    @property
    def rows(self) -> int:
        """Rows of the (N*T*H*W, C) matrix per tile."""
        return self.warps_m * WARP_ROWS

    @property
    def chunk_cols(self) -> int:
        """Columns of W a block holds: all of them when ``n_tiles`` is 1."""
        return self.warps_n * WARP_COLS

    def describe(self) -> str:
        if self.route == "simt":
            return "simt"
        return (f"mma {'resident' if self.n_tiles == 1 else 'resident-chunks'}"
                f" rows {self.rows} warps {self.producers}+{self.warps_m}x"
                f"{self.warps_n} chunks {self.n_tiles}x{self.chunk_cols} grid "
                f"{self.grid_x} smem {self.smem_bytes}")


def _mma_smem(producers: int, warps_m: int, warps_n: int, c: int,
              k: int | None = None, table: int | None = None) -> int:
    """Shared memory of a block: the operand tile (two with producers), its
    columns of W, the gather's table of 8 words a channel. The depth ``k``
    and the table's channels ``table`` are ``c`` unless given (K3's launches:
    csrc/fused_entry_tc.cuh::entry_smem_bytes)."""
    kp = _ceil_div(c if k is None else k, 16) * 16
    kt = kp if table is None else _ceil_div(table, 16) * 16
    return ((2 if producers else 1) * warps_m * WARP_ROWS
            * tile_row_stride(kp) * 2
            + kp * tile_row_stride(warps_n * WARP_COLS) * 2 + 8 * kt * 4)


def _mma_defaults(m: int, c: int, sms: int, k: int | None = None,
                  table: int | None = None) -> dict:
    """The block shape the sweeps of utils/fused_block_probe.py found best
    (PERF.md has the tables), as a rule:

    * ``warps_n``, a power of two, covers the width's 72-column groups
      where W then fits beside two 16-row tiles, else as many as fit: every
      further column chunk redoes the operand tile, gather included;
    * 16 warps that all load, then all multiply (no producers); fewer along
      the rows while the tile does not fit, or where fewer rows per tile
      balance the SMs better;
    * small batches: while the work items (row tiles x column chunks) are
      fewer than half the SMs, fewer rows per tile, down to 32, then
      narrower chunks, then 16 rows;
    * where that leaves fewer than 8 warps, producer warps fill the block up
      to 16: they build the next tile while the others multiply.

    ``k`` and ``table`` as :func:`_mma_smem` takes them (K3's launches).
    """
    smem = functools.partial(_mma_smem, c=c, k=k, table=table)
    groups = _ceil_div(_ceil_div(c, 8), WARP_COLS // 8)
    warps_n = 1
    while (warps_n < groups
           and smem(4, 1, 2 * warps_n) <= SMEM_LIMIT):
        warps_n *= 2
    warps_m = MAX_WARPS // warps_n

    def items():
        return (_ceil_div(m, warps_m * WARP_ROWS)
                * _ceil_div(groups, warps_n))

    while warps_m > 1 and smem(0, warps_m, warps_n) > SMEM_LIMIT:
        warps_m //= 2
    while 2 * items() < sms and warps_m * warps_n > 1:
        if warps_m > 2 or warps_n == 1:
            warps_m //= 2
        else:
            warps_n //= 2
    # Every block has work: among the rows per tile down to half, those that
    # leave the SMs the shortest critical path (row tiles per block x rows),
    # the most warps among equals, if that is an eighth shorter. 12,544 rows
    # on 132 SMs: two tiles of 48 rows, not two of 64.
    grid_x = max(1, sms // _ceil_div(groups, warps_n))
    if _ceil_div(m, warps_m * WARP_ROWS) >= grid_x:
        def path(wm):
            return _ceil_div(_ceil_div(m, wm * WARP_ROWS), grid_x) * wm

        best = min(range(_ceil_div(warps_m, 2), warps_m + 1),
                   key=lambda wm: (path(wm), -wm))
        if 8 * path(best) <= 7 * path(warps_m):  # worth the warps it costs
            warps_m = best
    producers = 0
    if warps_m * warps_n < 8:
        producers = (MAX_WARPS - warps_m * warps_n) // 4 * 4
        while producers and smem(producers, warps_m, warps_n) > SMEM_LIMIT:
            if warps_m > 1:
                warps_m //= 2
            else:
                producers = 0
    return dict(producers=producers, warps_m=warps_m, warps_n=warps_n)


def _mma_plan(m: int, c: int, sms: int, knobs, k: int | None = None,
              table: int | None = None) -> BlockPlan:
    """The tensor-core plan: :func:`_mma_defaults`, with any of ``producers``,
    ``warps_m``, ``warps_n`` pinned by ``knobs`` (a pinned plan has no
    producers unless it pins them too) and ``overlap`` (programmatic
    dependent launch: a launch fetches its weights while the one before it
    still runs) on unless ``knobs`` switch it off; raises for a setting the
    kernel cannot run (:class:`NoPlan`). ``k``, ``table``: as
    :func:`_mma_smem`."""
    knobs = dict(knobs)
    overlap = bool(knobs.pop("overlap", True))
    unknown = set(knobs) - {"producers", "warps_m", "warps_n"}
    if unknown:
        raise ValueError(f"unknown plan knobs {sorted(unknown)}")
    shape = {**_mma_defaults(m, c, sms, k, table),
             **({"producers": 0} if knobs else {}),
             **knobs}
    producers, warps_m = shape["producers"], shape["warps_m"]
    warps_n = shape["warps_n"]
    groups = _ceil_div(_ceil_div(c, 8), WARP_COLS // 8)
    warps = producers + warps_m * warps_n
    smem = _mma_smem(producers, warps_m, warps_n, c, k, table)
    if (min(warps_m, warps_n) < 1 or producers < 0 or warps > MAX_WARPS
            or smem > SMEM_LIMIT or (warps_n > 1 and warps_n >= 2 * groups)):
        raise NoPlan(f"no tensor-core plan for C={c} under {shape}: "
                     f"{warps} warps (at most {MAX_WARPS}), {smem} bytes "
                     f"of shared memory (at most {SMEM_LIMIT})")
    n_split = _ceil_div(groups, warps_n)
    row_tiles = max(1, _ceil_div(m, warps_m * WARP_ROWS))
    return BlockPlan(
        route="mma", producers=producers, warps_m=warps_m, warps_n=warps_n,
        n_tiles=n_split,
        grid_x=min(row_tiles,
                   _ceil_div(sms * blocks_per_sm(smem, warps), n_split)),
        smem_bytes=smem, overlap=overlap)


def blocks_per_sm(smem: int, warps: int) -> int:
    """Blocks an SM holds at once, by shared memory and by registers (128 a
    thread)."""
    return max(1, min(SMEM_LIMIT // (smem + 1024),
                      65536 // (warps * 32 * 128)))


@functools.lru_cache(maxsize=None)
def _plan(shape, dtype, sms, knobs):
    n, t, h, w, c = shape
    if dtype != torch.bfloat16:
        if knobs:
            raise ValueError(f"unknown plan knobs {[k for k, _ in knobs]}: "
                             f"the SIMT route has none")
        return BlockPlan("simt")
    return _mma_plan(n * t * h * w, c, sms, dict(knobs))


def fused_block_plan(shape, dtype, *, sms=SM_COUNT, **knobs) -> BlockPlan:
    """The launch plan of one block of a run on x of ``shape`` (N, T, H, W,
    C): the route, a function of the dtype (tensor-core products for
    bfloat16, SIMT for float32), and, for the tensor cores, whether a block
    holds all of W or a chunk of its columns, the rows per tile, the warps,
    the grid and the shared memory. It depends on the shape and the dtype
    alone: the gather reads directly whatever the taps, and the attention
    mix and the gate ride on the loaders. ``knobs`` pin ``producers``,
    ``warps_m`` or ``warps_n``, or switch ``overlap`` off (the probe's
    sweep); the SIMT route takes none."""
    if len(shape) != 5 or min(shape[1:]) < 1 or shape[0] < 0:
        raise ValueError(f"shape must be (N, T, H, W, C), got {shape}")
    return _plan(tuple(int(d) for d in shape), dtype, int(sms),
                 tuple(sorted(knobs.items())))


def se_smem_fits(plan, shape, k: int, taps_n: int, max_shift: int,
                 stride: int) -> bool:
    """Whether launch A under ``plan`` (a tensor-core :class:`BlockPlan`
    of depth ``k``) holds the SE region beside its tile and W: two per-axis
    weight tables and the row warps' sums of ``shape``'s (N, T, H, W, C)
    ``mid`` (csrc/tc_se.cuh::tc_se_bytes, placed after W as
    csrc/fused_block_tc.cu::tc_launch places it). The port's one statement
    of that rule: the C side checks its own need and refuses a launch past
    a block's shared memory, and chip_smoke.py holds the two together at
    the rule's edge."""
    _, _, h, w, c = shape
    hw = h * w
    slots = (plan.rows + hw - 2) // hw + 1
    lo, hi = max(taps_n - 1 - max_shift, 0), max_shift + stride - 1
    region = ((2 * (lo + hi + stride) + plan.warps_m * slots)
              * plan.warps_n * WARP_COLS * 4)
    t_off = _mma_smem(plan.producers, plan.warps_m, plan.warps_n, c, k=k,
                      table=0)
    return t_off + region <= SMEM_LIMIT


def fused_block_supported(shape, max_shift, dtype, aq=False, se=False, *,
                          quantize=False, sms=SM_COUNT) -> bool:
    """Whether K2 takes a run of blocks on x of ``shape`` (N, T, H, W, C):
    float32 or bfloat16, at most ``KERNEL_MAX_TAPS`` taps per axis, a launch
    plan, and with ``se`` on the tensor cores the gate's shared memory
    beside it. Pure Python from the shape, the dtype and the plan (no
    launch), so the CPU and the card answer alike; the counterpart of
    ``rubiksnet_tpu/ops/pallas/fused_block.py::fused_block_supported``.
    ``quantize``: the rubiks3d quantize mode's extra tap."""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if len(shape) != 5 or min(shape[1:]) < 1 or shape[0] < 0:
        return False
    taps_n = kernel_taps(max_shift, quantize and not aq)
    if taps_n > KERNEL_MAX_TAPS:
        return False
    try:
        plan = fused_block_plan(shape, dtype, sms=sms)
    except NoPlan:
        return False
    if se and plan.route == "mma":
        return se_smem_fits(plan, shape, shape[4], taps_n, max_shift, 1)
    return True


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_block_kernel(x, vt, wm, se=None, *, aq=False, max_shift,
                       scratch=None, **knobs):
    """Kernel K2 on CUDA tensors: one C call per run, which makes two
    launches per block (and with ``se`` one more for the gate on the
    tensor-core route, two on the SIMT route). ``scratch``: None, or a dict
    that receives the run's ``mid``, ``partial`` and ``gate`` (as the last
    block left them), to check the gate on its own. ``knobs``: as
    :func:`fused_block_plan` takes them."""
    taps_n = _check_args(x, vt, wm, se, aq, max_shift)
    if taps_n > KERNEL_MAX_TAPS:
        raise ValueError(f"the CUDA kernel takes <= {KERNEL_MAX_TAPS} taps")
    arrays = (x, vt, wm) if se is None else (x, vt, wm, se)
    if x.device.type != "cuda" or any(a.device != x.device for a in arrays):
        raise ValueError("fused_block_kernel needs x, vt, wm, se on one CUDA "
                         f"device, got {[str(a.device) for a in arrays]}")
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("fused_block_kernel needs contiguous x, vt, wm, se")
    code = _build.dtype_code(x.dtype)
    plan = fused_block_plan(x.shape, x.dtype, sms=_sm_count(x.device.index),
                            **knobs)
    P, I = _build.PTR, _build.INT
    fn = _build.kernel_function("rubiks_fused_block_run", *[P] * 8, *[I] * 19,
                                P)
    n, t, h, w, c = x.shape
    out = torch.empty_like(x)
    mid = torch.empty_like(x)
    cr = slices = 0
    partial = gate = None
    if se is not None:
        cr = se.shape[3]
        if plan.route == "mma":
            partial = torch.empty(se_partial_shape(plan, x.shape),
                                  dtype=torch.float32, device=x.device)
            slices = partial.shape[1]
        else:
            slices = se_slices(h)
            partial = torch.empty((n * t, slices, c), dtype=torch.float32,
                                  device=x.device)
        gate = torch.empty((n * t, c), dtype=torch.float32, device=x.device)
    nb = vt.shape[0]
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), vt.data_ptr(), wm.data_ptr(),
                se.data_ptr() if se is not None else None,
                partial.data_ptr() if se is not None else None,
                gate.data_ptr() if se is not None else None,
                mid.data_ptr(), out.data_ptr(), code, nb, n, t, h, w, c,
                taps_n, max_shift, int(bool(aq)), cr, slices, plan.producers,
                plan.warps_m, plan.warps_n, plan.n_tiles, plan.grid_x,
                plan.smem_bytes, int(plan.overlap), _build.stream_of(x))
    _build.check(rc, "rubiks_fused_block_run")
    LAUNCHES.count += nb
    if se is not None and plan.route == "mma":
        SE_GATE_LAUNCHES.count += nb
    if scratch is not None:
        scratch.update(mid=mid, partial=partial, gate=gate)
    return out if nb else x.clone()


def fused_block_run(x, vt, wm, se=None, *, aq=False, max_shift):
    """Apply a chain of B fused blocks to x (N, T, H, W, C).

    vt: (B, 4 + 3*taps, C) float32 from :func:`stack_block_params`, or with
    ``aq=True`` (B, 4 + 3*taps + 3, C) from :func:`stack_block_params_aq`
    (``aq`` is never inferred from the row count: both are multiples of 3
    past the head); wm: (B, 2, C, C) in x's dtype; se: None or (B, 2, C, Cr)
    float32 from :func:`stack_se_params`. Calls the operator
    ``rubiksnet::fused_block_run`` (``ops/library.py``): K2 for a CUDA
    tensor, the plain version for a CPU tensor.
    """
    return torch.ops.rubiksnet.fused_block_run.default(
        x, vt, wm, se, aq, max_shift)
