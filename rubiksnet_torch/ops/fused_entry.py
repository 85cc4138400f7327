"""One stride-2 stage-entry RubiksNet block with channel growth, inference
(K3).

    a   = relu(bn1(x))
    out = W3 . [SE] shift3d_s2(relu(bn2(W2 . [AQ] a))) + Wsc . a[:, :, ::2, ::2]

With ``se`` (the SE tiers) the stride-2 shifted activation is gated per
(clip, frame, channel) by ``sigmoid(relu(mean_hw . fc1) . fc2)``, the mean
taken over the decimated (H/2, W/2) grid. With ``aq=True`` (the rubiks3d-aq
entries, params from :func:`stack_entry_params_aq`) ``a`` is mixed along T
with three per-channel attention taps before W2, as K2 mixes it, and the
shift is the 2D shift at stride 2: an identity T tap row. The shortcut reads
``a`` unmixed. Counterpart of ``rubiksnet_tpu/ops/pallas/fused_entry.py``;
the AQ form has none there (the JAX executor runs those entries as XLA
compositions). The AQ form takes no SE gate and no quantized shift.
:func:`fused_entry_run` makes one call into ``csrc/fused_entry.cu`` for a
CUDA tensor (bfloat16: the tensor-core kernels of ``csrc/fused_entry_tc.cu``
under :func:`fused_entry_plan`, the gate's sums in launch A and one gate
launch, ``csrc/se_gate_tc.cu``; float32: the SIMT GEMM of
``csrc/common.cuh`` and the gate of ``csrc/se_gate.cuh``), and runs
:func:`fused_entry_plain` for a CPU tensor.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..utils.profiling import LaunchCounter
from . import _build
from .attention_shift import TEMPERATURE, attention_shift_weights
from .fused_block import (
    KERNEL_MAX_TAPS,
    SE_GATE_LAUNCHES,
    SM_COUNT,
    SMEM_LIMIT,
    BlockPlan,
    NoPlan,
    _bn_fold,
    _mma_defaults,
    _mma_plan,
    _mma_smem,
    _sm_count,
    aq_mix,
    blocks_per_sm,
    conv1x1_matrix,
    kernel_taps,
    se_gate,
    se_partial_shape,
    se_slices,
    se_smem_fits,
    stack_taps,
    tap_shift,
    taps_from_rows,
)

LAUNCHES = LaunchCounter("fused_entry")
# K3 with the attention mix (the rubiks3d-aq entries), counted apart.
AQ_LAUNCHES = LaunchCounter("fused_entry_aq")


@torch.no_grad()
def stack_entry_params(block, dtype, max_shift, quantize=False):
    """Fold one stride-2 RubiksShiftBlock into the kernel's arrays.

    Returns (vt1, vt2, w2, w3, wsc): vt1 (2, Cin) float32 folded bn1; vt2
    (2 + 3*taps_n, mid) float32 folded bn2 then the T, H, W tap weights;
    w2, wsc (Cin, mid) and w3 (mid, mid) in dtype, as (in, out).
    """
    s1, b1 = _bn_fold(block.bn1)
    s2, b2 = _bn_fold(block.bn2)
    taps = stack_taps(block.as3.rubiks3d.shift, dtype, max_shift, quantize)
    vt1 = torch.stack([s1, b1]).float().contiguous()
    vt2 = torch.cat([torch.stack([s2, b2]).float(), taps]).contiguous()
    return (vt1, vt2, conv1x1_matrix(block.conv2, dtype),
            conv1x1_matrix(block.conv3, dtype),
            conv1x1_matrix(block.shortcut, dtype))


@torch.no_grad()
def stack_entry_params_aq(block, dtype, max_shift):
    """Fold one stride-2 rubiks3d-aq block: the arrays of
    :func:`stack_entry_params`, with vt1 (5, Cin) = folded bn1 then the three
    rows of normalized attention weights (frames t - 1, t, t + 1), and vt2's
    taps an identity T row, then the H and W taps of the (2, mid) 2D shift.
    Fractional shifts only: the 2D quantize rule has no tap form."""
    s1, b1 = _bn_fold(block.bn1)
    s2, b2 = _bn_fold(block.bn2)
    shift2d = block.as3.shift
    shift3 = torch.cat([torch.zeros_like(shift2d[:1]), shift2d])
    taps = stack_taps(shift3, dtype, max_shift, False)
    aw = attention_shift_weights(block.aq_shift.weight.to(dtype),
                                 TEMPERATURE).float()  # (Cin, 3)
    vt1 = torch.cat([torch.stack([s1, b1]).float(), aw.t()]).contiguous()
    vt2 = torch.cat([torch.stack([s2, b2]).float(), taps]).contiguous()
    return (vt1, vt2, conv1x1_matrix(block.conv2_1x1, dtype),
            conv1x1_matrix(block.conv3, dtype),
            conv1x1_matrix(block.shortcut, dtype))


def fused_entry_plain(x, params, se=None, *, max_shift, aq=False):
    """The entry block in plain PyTorch: the stride-2 shift as the
    stride-1 shift sampled at even rows and columns."""
    vt1, vt2, w2, w3, wsc = params
    taps_n = taps_from_rows(vt2.shape[0], 2)
    dt = x.dtype
    a = torch.relu(x.float() * vt1[0] + vt1[1]).to(dt)
    mixed = aq_mix(a, vt1[2:5]) if aq else a
    mid = torch.relu((mixed @ w2).float() * vt2[0] + vt2[1]).to(dt)
    v = tap_shift(mid.float(), vt2[2:2 + 3 * taps_n], max_shift)
    v = v[:, :, ::2, ::2]
    if se is not None:
        v = v * se_gate(v, se)[:, :, None, None, :]
    sc = a[:, :, ::2, ::2] @ wsc
    return ((v.to(dt) @ w3).float() + sc.float()).to(dt)


def _check_args(x, params, se, max_shift, aq=False):
    vt1, vt2, w2, w3, wsc = params
    if x.ndim != 5:
        raise ValueError(f"x must be (N, T, H, W, C), got {tuple(x.shape)}")
    n, t, h, w, cin = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"fused entry needs even H and W, got {h}x{w}")
    mid = w2.shape[1]
    taps_n = taps_from_rows(vt2.shape[0], 2)
    if taps_n > 2 * max_shift + 2:
        raise ValueError(f"{taps_n} taps exceed max_shift={max_shift}")
    want = {"vt1": (vt1, (5 if aq else 2, cin), torch.float32),
            "vt2": (vt2, (2 + 3 * taps_n, mid), torch.float32),
            "w2": (w2, (cin, mid), x.dtype),
            "w3": (w3, (mid, mid), x.dtype),
            "wsc": (wsc, (cin, mid), x.dtype)}
    for name, (arr, shape, dtype) in want.items():
        if tuple(arr.shape) != shape or arr.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{arr.dtype} {tuple(arr.shape)}")
    if se is not None and (se.ndim != 3 or se.shape[:2] != (2, mid)
                           or se.dtype != torch.float32):
        raise ValueError(f"se must be float32 (2, {mid}, Cr), got "
                         f"{se.dtype} {tuple(se.shape)}")
    if se is not None and aq:
        raise ValueError("K3 takes no SE gate with the attention mix (aq)")
    return taps_n


# ------------------------------------------------------- the launch plan


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """The gather pre-pass of launch B where its weights are held in column
    chunks: every warp of a block gathers, ``rows`` output rows a tile, a
    persistent grid of ``grid_x`` blocks; shared memory holds the table."""

    rows: int
    grid_x: int
    smem_bytes: int

    def describe(self) -> str:
        return (f"gather rows {self.rows} grid {self.grid_x} smem "
                f"{self.smem_bytes}")


@dataclasses.dataclass(frozen=True)
class EntryPlan:
    """How one entry block is launched: the route and, on the tensor cores,
    the plan of launch A (``mid`` over the N*T*H*W input rows, depth Cin)
    and of launch B (``out`` over the N*T*(H/2)*(W/2) output rows, depth
    Cm + Cin), each a :class:`~.fused_block.BlockPlan` of the numbers
    ``rubiks_fused_entry`` takes, and ``g``, the gather pre-pass, where
    launch B's weights need column chunks: then every chunk would gather its
    rows again, so the pre-pass gathers them once into a scratch and launch
    B copies them (and holds no table). On the "simt" route the C side
    tiles by itself."""

    route: str  # "mma": tensor cores, bf16; "simt": the common.cuh GEMM
    a: BlockPlan | None = None
    b: BlockPlan | None = None
    g: GatherPlan | None = None

    def describe(self) -> str:
        if self.route == "simt":
            return "simt"
        text = f"A [{self.a.describe()}] B [{self.b.describe()}]"
        return text + (f" [{self.g.describe()}]" if self.g else "")

    def as_ints(self) -> list:
        """The 16 numbers of ``rubiks_fused_entry``'s plan argument."""
        launches = [(p.producers, p.warps_m, p.warps_n, p.n_tiles, p.grid_x,
                     p.smem_bytes) for p in (self.a, self.b)]
        g = self.g
        return [*launches[0], *launches[1],
                *((g.rows, g.grid_x, g.smem_bytes) if g else (0, 0, 0)),
                int(self.a.overlap)]


KNOBS = ("producers", "warps_m", "warps_n")
GATHER_ROWS = 32  # output rows a tile of the gather pre-pass
STAGE_PRODUCERS = 12  # loading warps of launch B where it copies staged rows


def _rule_a(m, cm, cin, sms):
    """Launch A's block: K2's rule (fused_block._mma_defaults) at its rows,
    depth and width, with at most 4 row warps and no producers: 64-row tiles
    beat 256-row ones at 112 x 112 and 56 x 56 at every batch
    (utils/fused_entry_probe.py --sweep; PERF.md has the numbers)."""
    d = _mma_defaults(m, cm, sms, k=cin, table=0)
    return dict(producers=0, warps_m=min(4, d["warps_m"]),
                warps_n=d["warps_n"])


def _rule_b(m, cm, cin, sms, stage):
    """Launch B's block. Gathering itself (no column chunks): K2's rule,
    with at most 4 row warps where a warp holds all the columns (the same
    sweep at 112 x 112). Copying staged rows: 12 producer warps and 2 row
    warps where they fit, else 1 (the sweep at 28 x 28: 2 x 2 warps with
    producers took 0.026 ms for the 0.036 of 4 x 2 without)."""
    if not stage:
        d = _mma_defaults(m, cm, sms, k=cm + cin, table=cm)
        if d["warps_n"] == 1:
            d = dict(producers=0, warps_m=min(4, d["warps_m"]), warps_n=1)
        return d
    wn = _mma_defaults(m, cm, sms, k=cm + cin, table=0)["warps_n"]
    for wm in (2, 1):
        if _mma_smem(STAGE_PRODUCERS, wm, wn, cm, cm + cin, 0) <= SMEM_LIMIT:
            return dict(producers=STAGE_PRODUCERS, warps_m=wm, warps_n=wn)
    return dict(producers=0, warps_m=1, warps_n=wn)


def _one_wave(plan, sms):
    """A launch with column chunks whose blocks all fit on the SMs at once:
    K2's rule rounds the blocks per chunk up, and at 8 chunks of one block
    an SM that left 136 blocks for 132 SMs, 4 of them a second wave."""
    room = sms * blocks_per_sm(plan.smem_bytes,
                               plan.producers + plan.warps_m * plan.warps_n)
    if plan.n_tiles > 1 and plan.grid_x * plan.n_tiles > room:
        return dataclasses.replace(plan,
                                   grid_x=max(1, room // plan.n_tiles))
    return plan


@functools.lru_cache(maxsize=None)
def _plan(shape, cm, dtype, sms, knobs):
    n, t, h, w, cin = shape
    if dtype != torch.bfloat16:
        if knobs:
            raise ValueError(f"unknown plan knobs {[k for k, _ in knobs]}: "
                             f"the SIMT route has none")
        return EntryPlan("simt")
    knobs = dict(knobs)
    stage = knobs.pop("stage", None)
    both = {"overlap": knobs.pop("overlap")} if "overlap" in knobs else {}
    per = {"a": {}, "b": {}}
    for key, value in knobs.items():
        launch, _, name = key.partition("_")
        if launch not in per or name not in KNOBS:
            raise ValueError(f"unknown plan knobs {[key]}")
        per[launch][name] = value
    m, m_out = n * t * h * w, n * t * (h // 2) * (w // 2)
    if stage is None:
        # Staged where the gathering launch B would need column chunks.
        stage = _mma_plan(m_out, cm, sms, {}, k=cm + cin,
                          table=cm).n_tiles > 1
    a = _mma_plan(m, cm, sms, {**_rule_a(m, cm, cin, sms), **per["a"],
                               **both}, k=cin, table=0)
    b = _mma_plan(m_out, cm, sms,
                  {**_rule_b(m_out, cm, cin, sms, stage), **per["b"], **both},
                  k=cm + cin, table=0 if stage else cm)
    a, b = _one_wave(a, sms), _one_wave(b, sms)
    if not stage:
        return EntryPlan(route="mma", a=a, b=b)
    g = GatherPlan(rows=GATHER_ROWS,
                   grid_x=max(1, min(-(-m_out // GATHER_ROWS), sms)),
                   smem_bytes=32 * (-(-cm // 16) * 16))
    return EntryPlan(route="mma", a=a, b=b, g=g)


def fused_entry_plan(shape, cm, dtype, *, sms=SM_COUNT,
                     **knobs) -> EntryPlan:
    """The launch plan of one entry block on x of ``shape`` (N, T, H, W,
    Cin) growing to ``cm`` channels: the route, a function of the dtype
    (tensor-core products for bfloat16, SIMT for float32), and, for the
    tensor cores, per launch whether a block holds all of W or a chunk of
    its columns, the rows per tile, the warps, the grid and the shared
    memory, by the rule of :func:`~.fused_block.fused_block_plan` at that
    launch's rows, depth and width as :func:`_rule_a`, :func:`_rule_b` and
    :func:`_one_wave` adjust it, and whether launch B's rows are gathered by
    a pre-pass (where its weights need column chunks). It depends on the
    shape and the dtype alone. ``knobs`` pin ``a_producers``, ``a_warps_m``,
    ``a_warps_n`` (launch A) or their ``b_`` forms (launch B), ``stage``
    (the pre-pass on or off), or switch ``overlap`` off for all launches;
    the SIMT route takes none."""
    if (len(shape) != 5 or min(shape[1:]) < 1 or shape[0] < 0
            or shape[2] % 2 or shape[3] % 2 or cm < 1):
        raise ValueError(f"shape must be (N, T, H, W, Cin) with H and W "
                         f"even, and cm >= 1, got {shape}, {cm}")
    return _plan(tuple(int(d) for d in shape), int(cm), dtype, int(sms),
                 tuple(sorted(knobs.items())))


def fused_entry_supported(shape, cin, mid, max_shift, dtype, se=False, *,
                          aq=False, quantize=False, sms=SM_COUNT) -> bool:
    """Whether K3 takes an entry block on x of ``shape`` (N, T, H, W, Cin)
    growing to ``mid`` channels: Cin as the block's, H and W even, float32
    or bfloat16, at most ``KERNEL_MAX_TAPS`` taps per axis, a launch plan,
    and with ``se`` on the tensor cores the gate's shared memory in launch
    A. With ``aq`` (the attention mix) neither ``se`` nor ``quantize``: the
    mix's launch A has no form with the gate's sums, and the 2D quantize
    rule has no tap form. Pure Python from the shape, the dtype and the plan
    (no launch), so the CPU and the card answer alike; the counterpart of
    ``rubiksnet_tpu/ops/pallas/fused_entry.py::fused_entry_supported``."""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if aq and (se or quantize):
        return False
    if len(shape) != 5 or min(shape[1:]) < 1 or shape[0] < 0:
        return False
    _, _, h, w, c = shape
    if c != cin or h % 2 or w % 2:
        return False
    taps_n = kernel_taps(max_shift, quantize)
    if taps_n > KERNEL_MAX_TAPS:
        return False
    try:
        plan = fused_entry_plan(shape, mid, dtype, sms=sms)
    except NoPlan:
        return False
    if se and plan.route == "mma":
        return se_smem_fits(plan.a, shape[:4] + (mid,), cin, taps_n,
                            max_shift, 2)
    return True


def fused_entry_kernel(x, params, se=None, *, max_shift, aq=False,
                       scratch=None, **knobs):
    """Kernel K3 on CUDA tensors: one C call (two launches, three with the
    gather pre-pass, and with ``se`` one more for the gate on the tensor-core
    route, two on the SIMT route). ``aq``: the attention mix in launch A
    (params from :func:`stack_entry_params_aq`; counted by ``AQ_LAUNCHES``, not
    ``LAUNCHES``). ``scratch``: None, or a dict that receives ``mid``,
    ``partial`` and ``gate``, to check the gate on its own. ``knobs``: as
    :func:`fused_entry_plan` takes them."""
    taps_n = _check_args(x, params, se, max_shift, aq)
    if taps_n > KERNEL_MAX_TAPS:
        raise ValueError(f"the CUDA kernel takes <= {KERNEL_MAX_TAPS} taps")
    for arr in (x, *params) if se is None else (x, *params, se):
        if arr.device != x.device or x.device.type != "cuda":
            raise ValueError("fused_entry_kernel needs x and params on one "
                             f"CUDA device, got {arr.device} and {x.device}")
        if not arr.is_contiguous():
            raise ValueError("fused_entry_kernel needs contiguous arrays")
    vt1, vt2, w2, w3, wsc = params
    code = _build.dtype_code(x.dtype)
    n, t, h, w, cin = x.shape
    cmid = w2.shape[1]
    plan = fused_entry_plan(x.shape, cmid, x.dtype,
                            sms=_sm_count(x.device.index), **knobs)
    mid = torch.empty((n, t, h, w, cmid), dtype=x.dtype, device=x.device)
    out = torch.empty((n, t, h // 2, w // 2, cmid), dtype=x.dtype,
                      device=x.device)
    m_out = n * t * (h // 2) * (w // 2)
    cr = slices = 0
    se_ptr = partial_ptr = gate_ptr = partial = gate = None
    if se is not None:
        cr = se.shape[2]
        if plan.route == "mma":
            partial = torch.empty(
                se_partial_shape(plan.a, (n, t, h, w, cmid)),
                dtype=torch.float32, device=x.device)
            slices = partial.shape[1]
        else:
            slices = se_slices(h)
            partial = torch.empty((n * t, slices, cmid), dtype=torch.float32,
                                  device=x.device)
        gate = torch.empty((n * t, cmid), dtype=torch.float32,
                           device=x.device)
        se_ptr, partial_ptr, gate_ptr = (se.data_ptr(), partial.data_ptr(),
                                         gate.data_ptr())
    ints = stage = None
    if plan.route == "mma":
        ints = (_build.INT * 16)(*plan.as_ints())
        if plan.g is not None:
            rows = max(-(-m_out // r) * r for r in (plan.g.rows, plan.b.rows))
            stage = torch.empty((rows, -(-(cmid + cin) // 16) * 16),
                                dtype=x.dtype, device=x.device)
    P, I = _build.PTR, _build.INT
    fn = _build.kernel_function("rubiks_fused_entry", *[P] * 11, *[I] * 12,
                                P, P, P)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), vt1.data_ptr(), vt2.data_ptr(), w2.data_ptr(),
                w3.data_ptr(), wsc.data_ptr(), se_ptr, partial_ptr, gate_ptr,
                mid.data_ptr(), out.data_ptr(), code, n, t, h, w, cin, cmid,
                taps_n, max_shift, cr, slices, int(bool(aq)), ints,
                stage.data_ptr() if stage is not None else None,
                _build.stream_of(x))
    _build.check(rc, "rubiks_fused_entry")
    (AQ_LAUNCHES if aq else LAUNCHES).count += 1
    if se is not None and plan.route == "mma":
        SE_GATE_LAUNCHES.count += 1
    if scratch is not None:
        scratch.update(mid=mid, partial=partial, gate=gate)
    return out


def fused_entry_run(x, params, se=None, *, max_shift, aq=False):
    """Apply one fused stride-2 entry block to x (N, T, H, W, Cin), H and W
    even; returns (N, T, H/2, W/2, mid). params from
    :func:`stack_entry_params`, or with ``aq=True`` from
    :func:`stack_entry_params_aq` (``aq`` is never inferred from vt1's
    rows); se: None or (2, mid, Cr) float32, one entry of
    ``fused_block.stack_se_params`` (not with ``aq``). Calls the operator
    ``rubiksnet::fused_entry_run`` (``ops/library.py``): K3 for a CUDA
    tensor, the plain version for a CPU tensor."""
    return torch.ops.rubiksnet.fused_entry_run.default(
        x, *params, se, max_shift, aq)
