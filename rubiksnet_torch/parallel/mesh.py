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
* the model axis (tensor parallelism) is not ported (ROADMAP A5).

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

import torch
import torch.distributed as dist

# The JAX package's name of its data mesh axis. A group has no name here:
# it stays so that code written against ``rubiksnet_tpu.parallel``'s names
# imports unchanged.
DATA_AXIS = "data"
BACKENDS = ("nccl", "gloo")

_DATA_GROUP = contextvars.ContextVar("rubiksnet_data_group", default=None)


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


def create_mesh(data: int | None = None, model: int = 1):
    """The data group over every rank (None in a single process): the
    counterpart of JAX's (data, model) mesh with ``model=1``. ``data``
    must equal the world size (None takes it); ``model > 1`` raises, as
    tensor parallelism is not ported (ROADMAP A5)."""
    if model != 1:
        raise NotImplementedError(
            "a model axis (tensor parallelism) is not ported: ROADMAP A5")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is not None and data != world:
        raise ValueError(f"a data axis of {data} needs {data} ranks, the "
                         f"world has {world}")
    return dist.group.WORLD if dist.is_initialized() else None


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
