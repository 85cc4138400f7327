"""The benchmark's fixed yardstick: the H100's published peaks, the work of
one kernel call and of one whole-model call counted from a configuration's
widths, the union of device intervals, and the table that sorts kernel
names into classes.

Frozen copies of the port's ``utils/roofline.py`` (``peak_flops``,
``shift_work``, ``shift_grad_work``, ``block_work``, ``model_flops``,
``model_bytes``; ``bound_times_ms`` as ``bound_s``, the larger of its
two), ``utils/benchmark.py::union_length`` and ``utils/profile_step.py``'s
``CLASSES`` and ``classify``. They count from the configuration file, never
from the program's objects, so a change to the program cannot move the
yardstick it is measured with. ``tests/test_portbench_yardstick.py`` holds
them equal to the port's functions for the benchmark's configurations.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the card's full 700 W: device
# memory 3.35 TB/s, bf16 tensor cores 989 TFLOP/s, float32 outside the
# tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
FLOPS_PER_CORNER = 4  # weight product and multiply-add per corner read
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def peak_flops(dtype: str) -> float:
    """The matrix-product peak for operands of ``dtype`` (a name)."""
    return PEAK_BF16 if dtype == "bfloat16" else PEAK_F32


# ------------------------------------------------ one kernel call


def shift_work(written, read, itemsize, corners):
    """(bytes, matrix-product operations, other operations) of one shift
    call that writes ``written`` elements from ``read`` elements."""
    return ((written + read) * itemsize, 0,
            written * corners * FLOPS_PER_CORNER)


def shift_grad_work(n_out, n_in, itemsize):
    """K4: og and x read once; about 40 operations per output element."""
    return (n_out + n_in) * itemsize, 0, n_out * 40


def block_work(n, h, c, itemsize, rows, aq=False, se=False, frames=8):
    """One stride-1 block on (n, frames, h, h, c): x read, out written, the
    parameters read; the block's intermediate stays in the kernel."""
    m = n * frames * h * h
    nbytes = 2 * m * c * itemsize + 2 * c * c * itemsize + rows * c * 4
    if se:
        nbytes += 2 * c * (c // 12) * 4
    other = m * c * (6 + FLOPS_PER_CORNER * (4 if aq else 8)
                     + (6 if aq else 0) + (3 if se else 0))
    return nbytes, 4 * m * c * c, other


def bound_s(work, dtype: str) -> float:
    """The least seconds one call could take: the larger of its bytes over
    the memory rate and its operations over the peaks (matrix products at
    the dtype's peak, the rest at the float32 rate)."""
    nbytes, mm, other = work
    return max(nbytes / HBM_BYTES_PER_S,
               mm / peak_flops(dtype) + other / PEAK_F32)


# ------------------------------------------------ the model's shapes


def blocks(cfg):
    """Every block of the configuration in order: (stage, index, in width,
    out width, stride, input extent H = W) for an input of
    ``cfg["input_size"]`` pixels (the stem halves it)."""
    w = cfg["width"]
    stages = [(w, 1, 1)] + [(w * 2 ** i, r, 2)
                             for i, r in enumerate(cfg["repeats"])]
    h = (cfg["input_size"] - 1) // 2 + 1
    cin, out = w, []
    for s, (planes, repeat, stride) in enumerate(stages):
        for b in range(repeat):
            st = stride if b == 0 else 1
            out.append((s, b, cin, planes, st, h))
            h = (h - 1) // st + 1
            cin = planes
    return out


def block_rows(cfg) -> int:
    """Float32 rows of per-channel parameters a fused block reads: BN's
    folded scale and bias twice, and the taps of three axes over the
    shift window (three more attention taps for rubiks3d-aq)."""
    rows = 4 + 3 * (2 * cfg["max_shift"] + 1)
    return rows + 3 if cfg["variant"] == "rubiks3d-aq" else rows


def stride1_blocks(cfg):
    """(H, C) of every stride-1 equal-width block: the blocks K2 runs."""
    return [(h, cout) for _, _, cin, cout, st, h in blocks(cfg)
            if st == 1 and cin == cout]


def shift_shapes(cfg, batch):
    """(input elements, output elements) of every block's shift on a batch
    of ``batch`` clips, in block order."""
    f = cfg["num_frames"]
    out = []
    for _, _, _, cout, st, h in blocks(cfg):
        ho = (h - 1) // st + 1
        out.append((batch * f * h * h * cout, batch * f * ho * ho * cout))
    return out


def _layers(cfg, batch):
    """Per layer of one forward: (input elements, output elements,
    multiply-adds, matrix weight elements)."""
    n = batch * cfg["num_frames"]
    size, w = cfg["input_size"], cfg["width"]
    h = (size - 1) // 2 + 1
    stem = w * 3 * 3 * 3
    out = [(n * size * size * 3, n * h * h * w, n * h * h * stem, stem)]
    se = cfg.get("use_se", False)
    for _, _, cin, cout, st, h in blocks(cfg):
        mid = cout
        ho = (h - 1) // st + 1
        m, mo = n * h * h, n * ho * ho
        macs = m * cin * mid + mo * mid * cout
        weights = cin * mid + mid * cout
        if st != 1 or cin != cout:
            macs += mo * cin * cout
            weights += cin * cout
        if se:
            for fc in (mid * (mid // 12), (mid // 12) * mid):
                macs += n * fc
                weights += fc
        out.append((m * cin, mo * cout, macs, weights))
    feat = 8 * w
    fc = feat * cfg["num_classes"]
    out.append((n * h * h * feat, batch * cfg["num_classes"], n * fc, fc))
    return out


def _other_params(cfg):
    """Float parameters and buffers that are not matrix weights: BN's four
    vectors, the shifts, the attention weights and their temperature, the
    head's bias."""
    aq = cfg["variant"] == "rubiks3d-aq"
    total = 0
    for _, _, cin, cout, _, _ in blocks(cfg):
        total += 4 * cin + 4 * cout  # bn1, bn2
        total += (2 if aq else 3) * cout  # the shift
        if aq:
            total += 3 * cin + 1  # attention weights and T
    return total + 4 * 8 * cfg["width"] + cfg["num_classes"]


def model_flops(cfg, batch, mode="infer") -> int:
    """Matrix-product operations (2 x multiply-adds) of one forward
    (``"infer"``) or one train step (``"train"``: the forward, every
    layer's weight gradient and every input gradient but the stem's)."""
    layers = _layers(cfg, batch)
    fwd = 2 * sum(macs for _, _, macs, _ in layers)
    if mode == "infer":
        return fwd
    if mode != "train":
        raise ValueError(f"mode must be 'infer' or 'train', got {mode!r}")
    return 3 * fwd - 2 * layers[0][2]


def model_bytes(cfg, batch, mode="infer") -> int:
    """The least device-memory traffic of one forward or train step: each
    layer's input and output once in the compute dtype, each matrix weight
    once in it, every other parameter and buffer once in float32; a train
    step adds each layer's output gradient, saved input and input gradient
    and each matrix weight again with its float32 gradient."""
    item = ITEMSIZE[cfg["dtype"]]
    layers = _layers(cfg, batch)
    matrix = sum(w for _, _, _, w in layers)
    acts = sum(i + o for i, o, _, _ in layers)
    fwd = acts * item + matrix * item + _other_params(cfg) * 4
    if mode == "infer":
        return fwd
    bwd_acts = sum(o + 2 * i for i, o, _, _ in layers) - layers[0][0]
    return fwd + bwd_acts * item + matrix * (item + 4)


# ------------------------------------------------ device intervals


def union_length(spans) -> float:
    """Length of the union of (start, end) intervals (any order)."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    total, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            total += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return total + hi - lo


# (class, substrings of the kernel name), first match wins.
CLASSES = (
    ("2D shift and its input gradient (shift2d_kernel)", ("shift2d_kernel",)),
    ("K1 (bwd3d_forward_kernel; previous route shift3d_fwd_kernel)",
     ("bwd3d_forward", "shift3d_fwd_kernel")),
    ("K1-inverse (bwd3d_input_grad_kernel; previous route "
     "shift3d_inv_kernel)", ("bwd3d_input_grad", "shift3d_inv_kernel")),
    ("K4 (bwd3d_shift_grad_kernel; previous route shift_grad_*)",
     ("shift_grad",)),
    ("SE gate (se_gate_tc_kernel; SIMT route: se_partial, se_gate)",
     ("se_gate_tc_kernel", "se_partial_kernel", "se_gate_kernel")),
    ("K2 bf16 launches (rubiks_tc_kernel)", ("rubiks_tc_kernel",)),
    ("K3 bf16 launches (rubiks_entry_tc_kernel, rubiks_entry_gather_kernel)",
     ("rubiks_entry",)),
    ("float32 K2 and K3 GEMMs (gemm_kernel)", ("rubiks",)),
    ("library GEMMs (1x1 convs, dense)", ("gemm", "cutlass", "xmma", "gemv",
                                          "cublas", "nvjet")),
    ("library convolution (stem)", ("conv", "cudnn", "nchw", "nhwc")),
    ("reductions", ("reduce",)),
    ("gather / scatter / index", ("gather", "scatter", "index")),
    ("elementwise, copies, casts", ("elementwise", "vectorized", "copy",
                                    "Memcpy", "Memset", "fill", "cat")),
)
PLAIN_OP_CLASSES = ("reductions", "gather / scatter / index",
                    "elementwise, copies, casts")


def classify(name: str) -> str:
    for label, needles in CLASSES:
        if any(n in name for n in needles):
            return label
    return "other"
