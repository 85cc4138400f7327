"""RubiksShift layers on channel-last clips (N, T, H, W, C).

Counterpart of ``rubiksnet_tpu/nn/layers.py``: RubiksShift3D and the
Rubiks3DWrap of the rubiks3d variant; RubiksShift2D and AttentionShift of
the rubiks3d-aq variant; SELayer of the SE tiers. The shifts run on the
CUDA kernels for a CUDA tensor; AttentionShift and SELayer are plain torch
ops here, as they are XLA compositions in the JAX package (the fused
inference kernels compute both inside their own bodies).

Inside a ``parallel.time_parallel`` block the 3D shift and the attention
shift route to their halo-exchange forms (``parallel/temporal.py``), as the
JAX layers do under a time-axis ``shard_map``; the shifts' raw gradients
are reduced over the active data and time groups before their
normalization.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_shift import TEMPERATURE, attention_shift
from ..ops.shift2d import rubiks_shift_2d
from ..ops.shift3d import rubiks_shift_3d
from ..parallel.mesh import column_parallel
from ..parallel.temporal import (
    active_time,
    shift_grad_reduction,
    temporal_attention_shift,
    temporal_rubiks_shift_3d,
)


def uniform_shift_init(tensor: torch.Tensor, generator: torch.Generator,
                       scale: float = 1.0) -> torch.Tensor:
    """U(-scale, scale) shift init, in place."""
    with torch.no_grad():
        return tensor.uniform_(-scale, scale, generator=generator)


def group_shift_init(tensor: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """The conv-like grid init of a (2, C) shift, in place: channels walk a
    k x k grid of integer offsets in groups of k*k; the channels past the
    last whole group stay zero."""
    dim, c = tensor.shape
    if dim != 2 or kernel_size <= 1:
        raise ValueError(f"group init needs a (2, C) shift and k > 1, got "
                         f"{tuple(tensor.shape)}, k={kernel_size}")
    k = kernel_size
    r = torch.arange(-(k // 2), k // 2 + 1, dtype=tensor.dtype)
    groups = c // k**2
    alpha = r.repeat(k * groups)
    beta = r.repeat_interleave(k).repeat(groups)
    with torch.no_grad():
        tensor.zero_()
        tensor[0, :alpha.numel()] = alpha
        tensor[1, :beta.numel()] = beta
    return tensor


def _generator(generator):
    """``generator``, or a CPU generator at seed 0 (the JAX package's
    default ``PRNGKey(0)``)."""
    return generator if generator is not None else (
        torch.Generator().manual_seed(0))


def init_shift1d_nfold(shift: torch.Tensor, nfold: int = 8,
                       noise: float = 1e-3,
                       generator: torch.Generator | None = None):
    """The TSM-style init of a (1, C) shift, as a new tensor: the first
    C // nfold channels shift +1, the next C // nfold shift -1, the rest are
    drawn from U(-noise, noise). Counterpart of
    ``rubiksnet_tpu/nn/layers.py::init_shift1d_nfold`` (the reference's
    rubiks3d/layer.py:25-40), with a ``torch.Generator`` (default: seed 0)
    for the PRNG key; raises AssertionError for another row count, as it
    does."""
    dim, channels = shift.shape
    if dim != 1:
        raise AssertionError("only works with rubiks1d")
    group = channels // nfold
    out = shift.detach().clone()
    out[:, :group] = 1.0
    out[:, group:2 * group] = -1.0
    jitter = torch.empty((1, channels - 2 * group), dtype=out.dtype)
    jitter.uniform_(-noise, noise, generator=_generator(generator))
    out[:, 2 * group:] = jitter.to(out.device)
    return out


def create_3d_from_2d(shift_2d: torch.Tensor, init_mode: str = "tsm",
                      generator: torch.Generator | None = None):
    """A (3, C) 3D shift from a (2, C) 2D shift: a new T row on top of the
    2D rows, by ``init_mode``: ``"tsm"`` (C // 8 channels at +1, the next
    C // 8 at -1, the rest 0), ``"tsm-g<STD>"`` (the same folds plus
    N(0, STD) noise, STD 0.01 where it reads 0), ``"uni<MAG>"``
    (U(-1, 1) * MAG, MAG > 0) or ``"none"`` (NaN: a checkpoint must
    overwrite it). Counterpart of
    ``rubiksnet_tpu/nn/layers.py::create_3d_from_2d`` (the reference's
    rubiks3d/layer.py:110-154), with a ``torch.Generator`` (default: seed
    0) for the PRNG key; raises NotImplementedError for another mode, as it
    does."""
    _, c = shift_2d.shape
    fold = c // 8
    dt = shift_2d.dtype
    if init_mode.startswith("tsm-g"):
        stddev = float(init_mode[5:]) or 1e-2
        g = _generator(generator)
        t = torch.cat([
            1.0 + torch.randn(fold, generator=g) * stddev,
            -1.0 + torch.randn(fold, generator=g) * stddev,
            torch.randn(c - 2 * fold, generator=g) * stddev,
        ])
    elif init_mode == "tsm":
        t = torch.cat([torch.ones(fold), -torch.ones(fold),
                       torch.zeros(c - 2 * fold)])
    elif init_mode.startswith("uni"):
        magnitude = float(init_mode[3:])
        if not magnitude > 0:
            raise AssertionError(
                f"uniform random magnitude must > 0: {magnitude}")
        t = torch.empty(c, dtype=dt).uniform_(
            -1, 1, generator=_generator(generator)) * magnitude
    elif init_mode.lower() == "none":
        t = torch.full((c,), float("nan"))
    else:
        raise NotImplementedError(f"unknown init mode {init_mode}")
    return torch.cat([t[None, :].to(dt).to(shift_2d.device),
                      shift_2d.detach()], dim=0)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """Truncated normal (2 std) with variance 1 / fan_in, in place, for a
    dense weight (out, in)."""
    fan_in = weight.shape[1]
    # Std of the unit normal truncated to [-2, 2].
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class RubiksShift3D(nn.Module):
    """Learnable per-channel fractional (T, H, W) shift; parameter ``shift``
    (3, C), rows (T, H, W). Its gradient is the reference's: unit-normalized
    per channel when ``normalize_grad``, the T row scaled by
    ``normalize_t_factor`` (a number or ``"auto"``) first."""

    def __init__(self, num_channels, stride=(1, 1, 1), padding=(0, 0, 0),
                 normalize_grad=True, normalize_t_factor=1.0, quantize=False,
                 *, generator=None):
        super().__init__()
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.normalize_grad = bool(normalize_grad)
        self.normalize_t_factor = normalize_t_factor
        self.quantize = bool(quantize)
        self.shift = nn.Parameter(
            torch.empty((3, num_channels), dtype=torch.float32))
        if generator is not None:
            uniform_shift_init(self.shift, generator)

    def forward(self, x, plain=False):
        """plain=True runs the gather form and its plain gradients on any
        device (the reference route); otherwise K1, K1-inverse and K4 on
        CUDA and the plain forms on the CPU. Under a time group, the
        halo-exchange form (stride (1, s, s) and padding 0 only)."""
        shards = active_time()
        if shards is not None:
            st, sh, sw = self.stride
            if st != 1 or any(self.padding):
                raise ValueError(
                    f"the sequence-parallel shift takes stride (1, s, s) "
                    f"and padding 0, got stride {self.stride} padding "
                    f"{self.padding}")
            return temporal_rubiks_shift_3d(
                x, self.shift, shards.group, (sh, sw), self.normalize_grad,
                self.normalize_t_factor, self.quantize,
                max_shift=shards.max_shift, plain=plain)
        return rubiks_shift_3d(x, self.shift, self.stride, self.padding,
                               self.normalize_grad, self.normalize_t_factor,
                               self.quantize, plain=plain,
                               reduce_grad=shift_grad_reduction())


class Rubiks3DWrap(nn.Module):
    """A 3D shift of stride (1, s, s) and padding 0 standing in for a 2D
    shift inside a block; child named ``rubiks3d`` so the state-dict key is
    ``...as3.rubiks3d.shift``."""

    def __init__(self, num_channels, stride=1, quantize=False, *,
                 generator=None):
        super().__init__()
        self.rubiks3d = RubiksShift3D(
            num_channels, stride=(1, stride, stride), padding=(0, 0, 0),
            quantize=quantize, generator=generator)

    def forward(self, x, plain=False):
        return self.rubiks3d(x, plain=plain)


class RubiksShift2D(nn.Module):
    """Learnable per-channel fractional (H, W) shift; parameter ``shift``
    (2, C), rows (H, W). Takes (N, H, W, C) or (N, T, H, W, C), folding T
    into the batch. ``init_shift`` is ``"uniform"`` (U(-1, 1), drawn from
    ``generator``) or ``"groupK"`` (:func:`group_shift_init` with k = K).
    Its gradient is the reference's 2D rule, unit-normalized per channel
    when ``normalize_grad``."""

    def __init__(self, num_channels, stride=1, padding=0,
                 normalize_grad=True, quantize=False, init_shift="uniform",
                 *, generator=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.normalize_grad = bool(normalize_grad)
        self.quantize = bool(quantize)
        self.init_shift = init_shift
        self.shift = nn.Parameter(
            torch.empty((2, num_channels), dtype=torch.float32))
        if init_shift == "uniform":
            if generator is not None:
                uniform_shift_init(self.shift, generator)
        elif init_shift.startswith("group") and init_shift[5:].isdigit():
            group_shift_init(self.shift, int(init_shift[5:]))
        else:
            raise NotImplementedError(
                f"unrecognized init shift {init_shift!r}")

    def forward(self, x, plain=False):
        """plain=True runs the gather forms on any device; otherwise the
        kernels of csrc/shift2d.cu on CUDA and the gather forms on the CPU."""
        lead = None
        if x.ndim == 5:
            lead = x.shape[:2]
            x = x.reshape((-1,) + tuple(x.shape[2:]))
        out = rubiks_shift_2d(x, self.shift, self.stride, self.padding,
                              self.normalize_grad, self.quantize, plain=plain,
                              reduce_grad=shift_grad_reduction())
        if lead is not None:
            out = out.reshape(tuple(lead) + tuple(out.shape[1:]))
        return out


class AttentionShift(nn.Module):
    """Softmax-attention 3-tap temporal shift on (N, T, H, W, C); parameter
    ``weight`` (C, 3), U[0, 1). The temperature is the fixed constant 2,
    kept as the buffer ``T`` the reference's checkpoints carry."""

    def __init__(self, num_channels, *, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty((num_channels, 3), dtype=torch.float32))
        self.register_buffer("T", torch.tensor(TEMPERATURE))
        if generator is not None:
            with torch.no_grad():
                self.weight.uniform_(0.0, 1.0, generator=generator)

    def forward(self, x):
        if active_time() is not None:
            return temporal_attention_shift(x, self.weight, TEMPERATURE)
        return attention_shift(x, self.weight, TEMPERATURE)


class Dense(nn.Module):
    """Bias-free dense layer, weight (out, in) lecun-normal; under tensor
    parallelism its output rows are sharded as ``nn.backbone.Conv1x1``'s."""

    shard = None  # this rank's output rows, set by parallel.shard_params

    def __init__(self, in_features, out_features, *, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty((out_features, in_features), dtype=torch.float32))
        if generator is not None:
            lecun_normal_(self.weight, generator)

    def forward(self, x):
        if self.shard is not None:
            return column_parallel(
                self.shard, x, lambda v: F.linear(v, self.weight.to(v.dtype)))
        return F.linear(x, self.weight.to(x.dtype))


class SELayer(nn.Module):
    """Squeeze-and-excitation on (N, T, H, W, C): per-frame spatial mean,
    two bias-free dense layers (C -> C // reduction -> C) with a ReLU
    between, sigmoid gate. The dense layers sit at ``fc.0`` and ``fc.2`` as
    in the reference's Sequential."""

    def __init__(self, channels, reduction=12, *, generator=None):
        super().__init__()
        if reduction <= 2:
            raise ValueError(f"SE reduction must be > 2, got {reduction}")
        self.fc = nn.Sequential(
            Dense(channels, channels // reduction, generator=generator),
            nn.ReLU(),
            Dense(channels // reduction, channels, generator=generator),
            nn.Sigmoid())

    def forward(self, x):
        gate = self.fc(x.mean(dim=(2, 3)))  # (N, T, C)
        return x * gate[:, :, None, None, :]
