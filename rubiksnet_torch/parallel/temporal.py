"""Sequence (temporal) parallelism: a clip's T axis sharded over a group.

Counterpart of ``rubiksnet_tpu/parallel/temporal.py``. RubiksShift's
temporal reach is bounded by its tap window, so a clip whose frames are
split over the ranks of a time group needs only a few boundary frames from
each neighbour (a halo) before each 3D shift runs locally. Everything else
in the backbone is per frame (the 1x1 convs, the 2D shift, the SE gate), BN
in eval mode is elementwise, and the TSN consensus becomes a local sum plus
a sum over the group.

Semantics are the unsharded ops': the end shards' halos are zeros, which is
the unsharded kernels' zero fill at the clip's ends; the input gradient of
a halo frame returns to the rank that owns it; the raw (3, C) shift
gradient is summed over the group *before* its per-channel normalization.

Halo width (:func:`halo_width`): ``max_shift + 1`` frames, or
``max_shift + 2`` when the shift quantizes. Under the unsharded contract
``|floor(s)| <= max_shift`` a fractional forward reads T taps up to
``max_shift + 1`` away (a shift in (K, K + 1)), and the shift gradient
(K4) reads ``s - 1`` and ``s + 1`` at an integer shift (its corrected
taps), so a shift of exactly +-K reaches K + 1 too. A quantized shift
rounds onto taps up to K + 1 away (one in (K + 0.5, K + 1], which a
bfloat16 compute dtype may round to exactly K + 1), and K4, which ignores
the quantization, then reads K + 2. With that halo the sharded op equals
the unsharded one over the whole contract and the fused kernels' tap
window.

The exchange is one ``all_reduce`` of a zero buffer in which each rank
writes its first and last frames into its own slot (``parallel/mesh.py``
says why), and its transpose in the backward. The layers route here while
a :func:`time_parallel` block is active; :func:`sequence_parallel_eval`
runs a model's forward so.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..ops import shift3d as s3d
from ..ops.attention_shift import TEMPERATURE, attention_shift
from .mesh import (
    active_data_group,
    active_model_group,
    all_reduce_sum,
    group_rank,
    group_size,
    shard_rows,
)

# The JAX package's name of its time mesh axis. A group has no name here:
# it stays so that code written against ``rubiksnet_tpu.parallel``'s names
# imports unchanged.
TIME_AXIS = "time"


class TimeShards(NamedTuple):
    """The active time group and the model's ``max_shift``, which sets the
    halo's width."""
    group: object
    max_shift: int


_TIME = contextvars.ContextVar("rubiksnet_time_group", default=None)


@contextlib.contextmanager
def time_parallel(group, max_shift: int):
    """Run the block with the clip's T axis sharded over ``group``, the
    halo set by the model's ``max_shift``: the 3D shift and the attention
    shift exchange halos, BN in train mode reduces its statistics over the
    group, the consensus sums over it, and the fused executor refuses to
    run. The counterpart of JAX's time-axis ``shard_map``
    (``active_time_axis``). Raises under an active model group
    (``parallel.model_parallel``)."""
    if group is not None and active_model_group() is not None:
        raise ValueError("a time group and a model group cannot be active "
                         "together")
    token = _TIME.set(TimeShards(group, int(max_shift)))
    try:
        yield group
    finally:
        _TIME.reset(token)


def active_time():
    """The innermost :func:`time_parallel`'s :class:`TimeShards`, else
    None."""
    return _TIME.get()


def active_time_group():
    """The active time group, else None."""
    t = _TIME.get()
    return None if t is None else t.group


def reduction_groups():
    """The groups a train-mode statistic sums over: the active data group
    and time group, each where one is active."""
    return [g for g in (active_data_group(), active_time_group())
            if g is not None]


def halo_width(max_shift: int, quantize: bool = False) -> int:
    """Frames each side of a shard that the 3D shift needs (module
    docstring): ``max_shift + 1``, quantized ``max_shift + 2``."""
    return int(max_shift) + (2 if quantize else 1)


# ------------------------------------------------------------ the exchange


def _check_halo(x, k):
    if x.ndim != 5:
        raise ValueError(f"x must be (N, T, H, W, C), got {tuple(x.shape)}")
    if x.shape[1] < k:
        raise ValueError(
            f"a time shard of {x.shape[1]} frames cannot source a halo of "
            f"{k}; use fewer shards or a smaller max_shift")


def _slot(buf, i, j):
    """Slab ``j`` of rank ``i``'s slot, zeros past either end."""
    if 0 <= i < buf.shape[0]:
        return buf[i, j]
    return buf.new_zeros(buf.shape[2:])


def _exchange(x, k, group):
    """(N, T_loc, ...) -> (N, T_loc + 2k, ...): the previous rank's last k
    frames, x, the next rank's first k (zeros past the ends)."""
    size, r = group_size(group), group_rank(group)
    buf = x.new_zeros((size, 2, x.shape[0], k) + tuple(x.shape[2:]))
    buf[r, 0] = x[:, :k]
    buf[r, 1] = x[:, x.shape[1] - k:]
    dist.all_reduce(buf, group=group)
    return torch.cat([_slot(buf, r - 1, 1), x, _slot(buf, r + 1, 0)], dim=1)


def _return_halo(gh, k, group):
    """The transpose of :func:`_exchange`: (N, T_loc + 2k, ...) gradients
    -> (N, T_loc, ...), each halo row's gradient added to the frame it
    came from on its owner."""
    size, r = group_size(group), group_rank(group)
    t = gh.shape[1] - 2 * k
    buf = gh.new_zeros((size, 2, gh.shape[0], k) + tuple(gh.shape[2:]))
    if r > 0:
        buf[r - 1, 1] = gh[:, :k]  # the previous rank's last frames
    if r < size - 1:
        buf[r + 1, 0] = gh[:, t + k:]  # the next rank's first frames
    dist.all_reduce(buf, group=group)
    gx = gh[:, k:t + k].clone(memory_format=torch.contiguous_format)
    gx[:, :k] += buf[r, 0]
    gx[:, t - k:] += buf[r, 1]
    return gx


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, group):
        ctx.k, ctx.group = k, group
        return _exchange(x, k, group)

    @staticmethod
    def backward(ctx, g):
        return _return_halo(g, ctx.k, ctx.group), None, None


def halo_exchange_time(x, k: int, group=None):
    """Extend a T-sharded block (N, T_loc, H, W, C) with its neighbours'
    boundary frames: (N, T_loc + 2k, H, W, C). Shard i gets shard i-1's
    last k frames and shard i+1's first k; the end shards get zeros.
    Differentiable: a halo frame's gradient returns to its owner. ``group``
    defaults to the active time group; raises where ``T_loc < k``."""
    group = _time_group(group)
    _check_halo(x, k)
    if k == 0:
        return x
    return _HaloExchange.apply(x, int(k), group)


def _time_group(group):
    if group is not None:
        return group
    group = active_time_group()
    if group is None:
        raise ValueError("no time group: pass one or run inside "
                         "time_parallel(group)")
    return group


# ------------------------------------------------------------ the shifts


def reduce_shift_grad(g, time_group=None, data_group=None):
    """A raw shift gradient summed over the time group (each time rank
    holds part of one loss) and averaged over the data group (each data
    rank's loss is a mean over its rows, and the step's loss their mean),
    in place; returns it."""
    if time_group is not None:
        dist.all_reduce(g, group=time_group)
    if data_group is not None:
        dist.all_reduce(g, group=data_group)
        g /= group_size(data_group)
    return g


def shift_grad_reduction():
    """The reduction of a raw shift gradient under the active groups, for
    a shift op to apply in its backward (read here, at the forward: the
    backward may run on another thread), or None without a group."""
    t, d = active_time_group(), active_data_group()
    if t is None and d is None:
        return None
    return functools.partial(reduce_shift_grad, time_group=t, data_group=d)


def temporal_rubiks_shift_3d(x, shift, group=None, stride=1,
                             normalize_grad=True, normalize_t_factor=1.0,
                             quantize=False, *, max_shift, plain=False):
    """``rubiks_shift_3d`` for a clip whose T axis is sharded over
    ``group`` (default: the active time group): ``x`` is this rank's
    (N, T_loc, H, W, C) block, ``shift`` the replicated (3, C) parameter.

    ``stride`` (an int or (sh, sw)) applies to H and W; the temporal
    stride is 1 and the padding 0 (the model's geometry).
    ``normalize_t_factor`` is a number: "auto" (T / H) needs the global T,
    which the caller resolves. The halo is :func:`halo_width` of the
    model's ``max_shift`` and ``quantize``; shifts obey the unsharded
    contract ``|floor(s)| <= max_shift``.

    The halo exchange, then ``rubiks_shift_3d`` on the extended block (K1;
    K1-inverse and K4 in the backward, on a CUDA tensor; the plain forms
    on a CPU tensor or with ``plain=True``), then the halo trimmed. The
    exchange's backward returns the halo rows' input gradients to their
    owners, and the raw shift gradient is summed over the time group (and
    averaged over an active data group) before its normalization, so it
    equals the unsharded op's: add no reduction of it.
    """
    group = _time_group(group)
    s3d._check_args(x, shift)
    if normalize_t_factor == "auto":
        raise ValueError("resolve the 'auto' normalize_t_factor with the "
                         "global T before sharding")
    if isinstance(stride, int):
        stride = (stride, stride)
    sh, sw = (int(s) for s in stride)
    k = halo_width(max_shift, quantize)
    reduce = functools.partial(reduce_shift_grad, time_group=group,
                               data_group=active_data_group())
    y = s3d.rubiks_shift_3d(
        halo_exchange_time(x, k, group), shift, (1, sh, sw), 0,
        normalize_grad, normalize_t_factor, quantize, plain=plain,
        reduce_grad=reduce)
    return y[:, k:y.shape[1] - k].contiguous()


def temporal_attention_shift(x, weight, temperature=TEMPERATURE,
                             group=None):
    """The AQ 3-tap attention shift (``ops/attention_shift.py``) on a
    T-sharded block: a one-frame halo, the tap mix, the trim. The mix
    zero-pads its own window, so the extended block's interior frames see
    their true neighbours and the clip's ends the zeros of the exchange."""
    xh = halo_exchange_time(x, 1, group)
    return attention_shift(xh, weight, temperature)[:, 1:-1]


def time_mean(x):
    """The TSN consensus of per-frame (N, T, K) logits: the mean over T,
    and under a time group the mean over the whole clip (a local sum in at
    least float32, summed over the group, so the result is replicated and
    its gradient that of one loss that every rank computes alike)."""
    t = active_time()
    if t is None:
        return x.mean(dim=1)
    acc = torch.promote_types(x.dtype, torch.float32)
    total = all_reduce_sum(x.sum(dim=1, dtype=acc), t.group,
                           replicated_use=True)
    return (total / (x.shape[1] * group_size(t.group))).to(x.dtype)


# ------------------------------------------------------------ clips, eval


def time_shard_clip(video, group):
    """This rank's frames of a (N, T, ...) clip, contiguous; raises where T
    does not divide over the group."""
    return video[:, shard_rows(video.shape[1], group)].contiguous()


def check_halo_contract(shift_t, k: int, quantize: bool) -> None:
    """Raise if a T shift row reads past a halo of ``k`` frames: a
    fractional shift outside [-k, k], or a quantized one that rounds
    outside it."""
    s = shift_t.detach().to(torch.float32)
    f = torch.floor(s)
    if quantize:
        q = torch.where(s - f < 0.5, f, f + 1)
        bad = bool((q.abs() > k).any())
    else:
        bad = bool(((s < -k) | (s > k)).any())
    if bad:
        raise ValueError(
            f"T shifts reach beyond the halo of {k} frames (quantize="
            f"{quantize}); build the model with a larger max_shift")


def sequence_parallel_eval(model, group):
    """An eval forward with the clip's T axis sharded over ``group``:
    ``fn(video_local) -> logits`` (N, num_classes), replicated on every
    rank, equal to the unsharded ``model(video)`` up to rounding. Shard
    the clip with :func:`time_shard_clip`.

    It takes the module path: K2 and K3 run the 3D shift inside their own
    bodies and cannot take a halo (the fused executor raises under a time
    group). Puts the model in eval mode and checks once that every T
    shift stays inside the halo.
    """
    from ..nn.layers import RubiksShift3D

    model.eval()
    for mod in model.modules():
        if isinstance(mod, RubiksShift3D):
            check_halo_contract(mod.shift[0],
                                halo_width(model.max_shift, mod.quantize),
                                mod.quantize)

    @torch.no_grad()
    def forward(video):
        if model.training:
            raise ValueError("sequence_parallel_eval runs inference: the "
                             "model was put back in train mode")
        with time_parallel(group, model.max_shift):
            return model(video)

    return forward
