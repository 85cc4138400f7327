"""Process groups, collectives and data parallelism on torch.distributed.

Counterpart of ``rubiksnet_tpu/parallel/mesh.py``. JAX runs one process
over a device mesh; the port runs one process per rank, launched by
``torchrun`` or by ``torch.multiprocessing`` with the ``spawn`` start
method, and a process group stands for each mesh axis:

* the data group (``DATA_AXIS``): each rank takes its contiguous rows of
  the global batch (:func:`shard_batch`); in train mode BN reduces its
  statistics over the group, and ``train/steps.py`` wraps the model in
  ``DistributedDataParallel``, so a step on R ranks at local batch B / R
  is the one-process step at batch B;
* the model group (``MODEL_AXIS``, tensor parallelism): the M ranks of a
  row of the (data, model) grid (:func:`create_mesh`) hold the same
  batch rows; each large 1x1 conv, dense layer and the head keeps its
  contiguous slice of output channels (:func:`shard_params`, by JAX's
  rule, :func:`param_partition_spec`), computes them from the replicated
  input and gathers the others' (:func:`gather_channels`); the input's
  gradient, each rank's part of it, is summed over the group
  (:func:`copy_to_model_group`). Everything else is computed alike on
  every rank of the group. A step on a D x M grid is the one-process
  step at the global batch.

``DATA_AXIS`` and ``MODEL_AXIS`` are the JAX package's axis names. A group
has no name here; they stay so that code written against
``rubiksnet_tpu.parallel``'s names imports unchanged.

Backend: NCCL where every rank has a CUDA card of its own, gloo on the CPU
and where ranks share a card (:func:`choose_backend`; fixed by the
arguments, never a fallback taken on failure). PyTorch's backend table
marks only ``broadcast`` and ``all_reduce`` for gloo on CUDA tensors (on
an H100 with torch 2.11 gloo also took the gathers, but its send/recv
wrote from the device pointer and ended the process; PERF.md §6),
so every exchange here is written with those two: a gather is an
``all_reduce`` of a zero buffer in which each rank fills its own slot
(:func:`gather_rows`; adding zeros is exact), and one code path serves
NCCL and gloo. The differentiable sums are this module's own autograd
Functions, with the backward each use needs.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..utils.profiling import LaunchCounter

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = ("nccl", "gloo")

_DATA_GROUP = contextvars.ContextVar("rubiksnet_data_group", default=None)
_MODEL_GROUP = contextvars.ContextVar("rubiksnet_model_group", default=None)

# Calls of the model group's two collectives (the gather of a sharded
# layer's output channels in the forward, the all-reduce of its input
# gradient in the backward), counted where each is issued.
GATHERS = LaunchCounter("gather_channels")
MODEL_REDUCES = LaunchCounter("model_all_reduce")


def choose_backend(device, local_world_size: int = 1) -> str:
    """``"nccl"`` when ``device`` is CUDA and each of the
    ``local_world_size`` ranks on this host has a card of its own, else
    ``"gloo"`` (the CPU, or ranks that share a card)."""
    device = torch.device(device)
    if device.type == "cuda" and (
            local_world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None,
                           device=None,
                           local_rank: int | None = None,
                           log=print) -> bool:
    """Join this process to a process group of ``world_size`` ranks.

    Arguments left out come from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and the
    ``env://`` rendezvous). In a single process (no ``init_method`` and a
    world size of 1) it does nothing and returns False, so code can call it
    unconditionally; it returns True once a group is initialized (also when
    one already was).

    ``backend`` is ``"nccl"`` or ``"gloo"``; None applies
    :func:`choose_backend` to ``device`` (default: the CUDA card where
    there is one, else the CPU) and the ranks per host. On CUDA the rank
    takes card ``local_rank % device_count`` as its current device. Logs
    the backend and why.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    world = int(world_size if world_size is not None
                else env.get("WORLD_SIZE", 1))
    if init_method is None and world == 1:
        return False
    rank = int(rank if rank is not None else env.get("RANK", 0))
    local_rank = int(local_rank if local_rank is not None
                     else env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if backend is None:
        backend = choose_backend(device, local_world)
        why = ("one CUDA card per rank" if backend == "nccl" else
               "CPU tensors" if device.type != "cuda" else
               f"{local_world} ranks share {torch.cuda.device_count()} "
               f"card(s)")
    else:
        why = "asked for"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}, expected one of "
                         f"{BACKENDS}")
    if device.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank)
    log(f"[distributed] rank {rank} of {world}: backend {backend} ({why})")
    return True


class Mesh(NamedTuple):
    """This rank's groups of a (data, model) grid: ``data`` holds the D
    ranks that share its model index (None where D is 1: the axis needs no
    group), ``model`` the M consecutive ranks of its row."""
    data: object
    model: object


def create_mesh(data: int | None = None, model: int = 1):
    """This rank's process groups of a row-major (data, model) grid of the
    world's ranks, the layout of JAX's ``np.array(devices).reshape(data,
    model)``: rank ``d * model + m``. ``data`` None takes world // model;
    ``data * model`` must equal the world size (ValueError otherwise, also
    for ``model > 1`` in a single process).

    ``model == 1`` returns the data group: every rank (None in a single
    process). ``model > 1`` returns a :class:`Mesh` of this rank's data and
    model groups. Every rank must call it alike: it creates every group of
    the grid, in the same order on each rank (``dist.new_group`` is
    collective over the world).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model < 1 or (data is not None and data < 1):
        raise ValueError(f"mesh axes must be positive, got data={data} "
                         f"model={model}")
    if data is None:
        data = max(world // model, 1)
    if data * model != world:
        axes = f"{data} x model axis of {model}" if model > 1 else data
        raise ValueError(f"a data axis of {axes} needs {data * model} "
                         f"ranks, the world has {world}")
    if model == 1:
        return dist.group.WORLD if dist.is_initialized() else None
    rank = dist.get_rank()
    data_group = model_group = None
    for d in range(data):
        g = dist.new_group(list(range(d * model, (d + 1) * model)))
        if rank // model == d:
            model_group = g
    if data > 1:
        for m in range(model):
            g = dist.new_group(list(range(m, world, model)))
            if rank % model == m:
                data_group = g
    return Mesh(data_group, model_group)


def group_size(group) -> int:
    """Ranks in ``group`` (1 for None: a single process)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def rank0_log(log, group):
    """``log`` on the group's first rank, a function that drops its
    arguments on the others (a script's ranks log once)."""
    return log if group_rank(group) == 0 else _quiet


def _quiet(*_args, **_kw):
    pass


def shard_rows(n: int, group) -> slice:
    """This rank's contiguous rows of ``n``; raises where ``n`` does not
    divide by the group's size."""
    size = group_size(group)
    if n % size:
        raise ValueError(f"a batch of {n} rows does not divide over "
                         f"{size} ranks")
    local = n // size
    start = group_rank(group) * local
    return slice(start, start + local)


def shard_batch(batch, group):
    """This rank's contiguous rows of a global batch: a tensor, an array,
    or a tuple, list or dict of them, all with the same leading size."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, group) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, group) for v in batch)
    return batch[shard_rows(batch.shape[0], group)]


@torch.no_grad()
def replicated(module: torch.nn.Module, group) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from the group's first
    rank to the others, in place; returns the module."""
    if group is not None:
        src = dist.get_global_rank(group, 0)
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src, group=group)
    return module


# ------------------------------------------------------------ collectives


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) whose backward sums the cotangents too: each rank's
    input feeds every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumReplicated(torch.autograd.Function):
    """All-reduce (sum) for a result that every rank then uses alike (a
    loss computed on every rank from replicated logits): the cotangent is
    already the whole one, so the backward passes it on unsummed."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group, replicated_use: bool = False):
    """The sum of ``x`` over ``group``, differentiable. The backward sums
    the cotangents over the group, the true gradient where each rank uses
    the result for its own part of the loss (BN's statistics); with
    ``replicated_use`` it passes each rank's cotangent through, the true
    gradient where every rank computes the same loss from the result (the
    consensus over a time group)."""
    if group is None:
        return x
    fn = _SumReplicated if replicated_use else _SumOverGroup
    return fn.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each), concatenated in rank order
    along the first axis, on every rank: an all-reduce of a zero buffer in
    which this rank fills its slot. Not differentiable."""
    if group is None:
        return x
    size = group_size(group)
    buf = x.new_zeros((size,) + tuple(x.shape))
    buf[group_rank(group)] = x
    dist.all_reduce(buf, group=group)
    return buf.reshape((size * x.shape[0],) + tuple(x.shape[1:]))


# ------------------------------------------------------------ the data group


@contextlib.contextmanager
def data_parallel(group):
    """Run the block with ``group`` as the active data group: BN in train
    mode reduces its statistics over it and the shifts' raw gradients are
    averaged over it before their normalization (the layers read it at
    the forward). None is a single process."""
    token = _DATA_GROUP.set(group)
    try:
        yield group
    finally:
        _DATA_GROUP.reset(token)


def active_data_group():
    """The data group of the innermost :func:`data_parallel`, else None."""
    return _DATA_GROUP.get()


# ------------------------------------------------------------ the model group


@contextlib.contextmanager
def model_parallel(group):
    """Run the block with ``group`` as the active model group: each weight
    sharded over it (:func:`shard_params`) computes its own output channels
    and gathers the others'. None is no model group. Raises under an active
    time group: JAX has no mesh with both axes (its time mesh is the 1-D
    mesh of ``sequence_parallel_eval``)."""
    from .temporal import active_time_group

    if group is not None and active_time_group() is not None:
        raise ValueError("a model group and a time group cannot be active "
                         "together")
    token = _MODEL_GROUP.set(group)
    try:
        yield group
    finally:
        _MODEL_GROUP.reset(token)


def active_model_group():
    """The model group of the innermost :func:`model_parallel`, else None."""
    return _MODEL_GROUP.get()


def collective_counters():
    """The model group's collectives counted where they are issued, by
    name: ``gather_channels`` (a sharded layer's forward) and
    ``model_all_reduce`` (its input gradient in the backward)."""
    return {c.name: c for c in (GATHERS, MODEL_REDUCES)}


class Shard(NamedTuple):
    """A weight's part of its output rows: ``full`` rows in all, split over
    ``parts`` ranks as ``torch.tensor_split`` splits them; this rank holds
    part ``index``, the rows :attr:`rows`."""
    full: int
    parts: int
    index: int

    @property
    def rows(self) -> slice:
        base, extra = divmod(self.full, self.parts)
        start = self.index * base + min(self.index, extra)
        return slice(start, start + base + (self.index < extra))


class _CopyToModelGroup(torch.autograd.Function):
    """Identity whose backward sums the cotangents over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        MODEL_REDUCES.count += 1
        return g, None


class _GatherChannels(torch.autograd.Function):
    """The channel shards concatenated over the group; the backward keeps
    this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, y, group, shard):
        ctx.rows = shard.rows
        buf = y.new_zeros(tuple(y.shape[:-1]) + (shard.full,))
        buf[..., ctx.rows] = y
        dist.all_reduce(buf, group=group)
        GATHERS.count += 1
        return buf

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rows], None, None


def copy_to_model_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, its gradient summed over ``group`` in the backward:
    the input of a column-parallel product, where each rank's product gives
    only its own output channels' term of the input gradient."""
    return _CopyToModelGroup.apply(x, group)


def gather_channels(y: torch.Tensor, group, shard: Shard) -> torch.Tensor:
    """Every model rank's channel shard ``y`` (this rank's is ``shard``'s
    rows), concatenated in rank order along the last axis, ``shard.full``
    channels on every rank: an all-reduce of a zero buffer in which each
    rank fills its own channels (its slot's offset and width from
    ``shard``, so uneven shards need no padding). The backward keeps this
    rank's channels of the cotangent, unsummed: everything after the
    gather is computed alike on every rank, so each cotangent is already
    the whole one."""
    return _GatherChannels.apply(y, group, shard)


def column_parallel(shard: Shard, x: torch.Tensor, product) -> torch.Tensor:
    """All output channels of a layer whose weight holds ``shard``'s rows
    (:func:`shard_params`): ``product`` on the replicated input through
    :func:`copy_to_model_group`, gathered over the active model group,
    which must be the group the weight was sharded over."""
    group = active_model_group()
    if group is None or (group_size(group), group_rank(group)) != (
            shard.parts, shard.index):
        raise RuntimeError(
            f"a weight sharded {shard.index} of {shard.parts} runs only "
            f"inside model_parallel(group) of the group it was sharded "
            f"over")
    return gather_channels(product(copy_to_model_group(x, group)), group,
                           shard)


def param_partition_spec(model: torch.nn.Module, model_size: int,
                         min_size_for_tp: int = 1 << 16) -> dict:
    """``{parameter name: 0 or None}`` of an unsharded model over a model
    group of ``model_size`` ranks: 0 shards the weight's output rows (dim 0
    of a (out, in, kh, kw) conv or (out, in) dense weight), None
    replicates it.

    JAX's rule (``rubiksnet_tpu/parallel/mesh.py::param_partition_spec``)
    on the port's names: the weight of a layer whose JAX counterpart is a
    ``kernel`` (the 1x1 convs, the stem, the SE dense layers, ``new_fc``:
    the modules with a ``shard`` attribute) with at least 2 dimensions
    and ``min_size_for_tp`` elements; everything else (BN, the shifts, the
    attention weight, biases) is replicated. One divergence: a weight
    whose output rows do not divide by ``model_size`` stays replicated
    where JAX's ``device_put`` raises (``new_fc`` at 174 classes over 4
    ranks).
    """
    spec = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            large = (pname == "weight" and hasattr(mod, "shard")
                     and p.ndim >= 2 and p.numel() >= min_size_for_tp
                     and p.shape[0] % model_size == 0)
            spec[f"{mname}.{pname}" if mname else pname] = 0 if large else (
                None)
    return spec


def sharded_modules(model: torch.nn.Module):
    """(name, module) of each layer whose weight is sharded."""
    return [(n, m) for n, m in model.named_modules()
            if getattr(m, "shard", None) is not None]


@torch.no_grad()
def shard_params(model: torch.nn.Module, group, spec: dict | None = None):
    """Keep, in place, this rank's contiguous output rows of each weight
    that ``spec`` (default :func:`param_partition_spec` over the group)
    shards, and mark its layer with the :class:`Shard` (the full output
    size, the group's size, this rank's index in it). Every rank builds or
    loads the same full model first, so each shard is an exact slice of
    it. The parameter objects stay (an optimizer built before keeps
    them); returns the model."""
    parts = group_size(group)
    if parts < 2:
        raise ValueError(f"shard_params needs a model group of at least 2 "
                         f"ranks, got {parts}")
    if sharded_modules(model):
        raise ValueError("the model is already sharded")
    spec = param_partition_spec(model, parts) if spec is None else spec
    mods = dict(model.named_modules())
    for name, dim in spec.items():
        if dim is None:
            continue
        mname, _, pname = name.rpartition(".")
        mod = mods.get(mname)
        if dim != 0 or pname != "weight" or not hasattr(mod, "shard"):
            raise ValueError(f"{name}: only the output rows (0) of a conv "
                             f"or dense weight shard, got {dim}")
        shard = Shard(mod.weight.shape[0], parts, group_rank(group))
        mod.weight.data = mod.weight.data[shard.rows].clone()
        mod.shard = shard
    return model


def gather_shard(t: torch.Tensor, shard: Shard, group) -> torch.Tensor:
    """The full (``shard.full``, ...) tensor of every rank's rows ``t``
    over ``group`` (a weight, its gradient or its momentum), on every
    rank. Not differentiable."""
    if group_size(group) != shard.parts:
        raise ValueError(f"a weight sharded over {shard.parts} ranks "
                         f"gathers over a group of {group_size(group)}")
    buf = t.new_zeros((shard.full,) + tuple(t.shape[1:]))
    buf[shard.rows] = t
    dist.all_reduce(buf, group=group)
    return buf


@torch.no_grad()
def gather_params(model: torch.nn.Module, group) -> dict:
    """The full state dict of a model sharded over ``group``, on every rank
    (every rank of the group calls it alike): the inverse of
    :func:`shard_params`. An unsharded model's is its own."""
    state = model.state_dict()
    for name, mod in sharded_modules(model):
        key = f"{name}.weight"
        state[key] = gather_shard(state[key], mod.shard, group)
    return state


def shard_state(model: torch.nn.Module, state: dict) -> dict:
    """A full state dict cut to the rows of each of ``model``'s sharded
    weights (what :func:`gather_params` gathered, or a one-process
    checkpoint), ready for ``model.load_state_dict``."""
    state = dict(state)
    for name, mod in sharded_modules(model):
        key = f"{name}.weight"
        state[key] = state[key][mod.shard.rows]
    return state
