"""Train and eval steps.

Counterpart of ``rubiksnet_tpu/train/steps.py``. PyTorch runs eagerly and
updates in place, so a step is a callable that owns the model and
optimizer instead of a pure function of a train state. A step over a data
group (``parallel.create_mesh``) wraps the model in
``DistributedDataParallel`` and equals the one-process step at the global
batch, as JAX's jitted step over a batch-sharded array does; one over a
model group (tensor parallelism: a model sharded by
``parallel.shard_params``) runs the same rows on every rank of the group,
each computing its own output channels of the sharded layers, and equals
it too; one over a time group runs each rank's frames of the same clips.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.fused_infer import fused_infer_apply
from ..parallel.mesh import (
    data_parallel,
    group_size,
    model_parallel,
    replicated,
    sharded_modules,
)
from ..parallel.temporal import time_parallel
from ..utils.profiling import NULL, setup_span, span
from .optim import param_groups


def cross_entropy(logits, labels):
    """Mean softmax cross entropy of (N, K) logits, computed in float32,
    against (N,) integer labels."""
    return F.cross_entropy(
        logits.to(torch.promote_types(logits.dtype, torch.float32)),
        labels.long())


class TrainStep:
    """``step(video, labels) -> {"loss", "accuracy"}``: one SGD step.

    Runs the model in train mode (batch-statistics BN, running statistics
    updated), backpropagates the cross entropy through the shifts'
    normalized gradients, applies the optimizer (and the scheduler, when
    given), and counts the step in ``self.step``. video is (N, T, H, W, 3),
    labels (N,). The metrics are 0-dim float32 tensors on the model's
    device. ``plain=True`` runs every op as plain PyTorch (the reference
    route the kernels are held to).

    ``data_group``: this rank takes its rows of the global batch; the
    model (``self.model`` stays the bare module, so checkpoints carry no
    ``module.`` prefix) runs wrapped in ``DistributedDataParallel``
    (``self.net``), BN uses the global batch's statistics, and the shifts,
    which DDP leaves alone, average their raw gradients over the group
    before the normalization (``parallel.temporal.reduce_shift_grad``).
    ``time_group``: this rank takes its frames of every clip; the shifts
    exchange halos, the consensus sums over the group, and every other
    gradient, each rank's part of one loss, is summed over it after the
    backward. Either way the metrics are the global batch's, and the
    parameters start from the group's first rank.
    ``model_group``: the model is sharded over it (``parallel.
    shard_params``) and every rank of it takes the same rows; the sharded
    layers gather their output channels and sum their input gradients over
    it, and everything else is computed alike on every rank (DDP and the
    first rank's parameters are the data group's only: a broadcast of the
    parameters over the model group would overwrite each rank's shard).
    The replicated parameters' gradients are then set to the group's first
    rank's (one broadcast of a flat buffer), so the replicas stay
    identical where a kernel's rounding is not deterministic (on an H100
    the stem's cuDNN weight gradient differed between two ranks in
    rounding). A model group and a time group together raise.

    Spans (``utils/profiling.py``): ``rubiksnet.train.step`` (call id the
    step's number) around ``.zero_grad``, ``.forward`` (model and loss),
    ``.backward`` (with the group reductions), ``.optimizer`` (with the
    scheduler) and ``.metrics``; the object's first call inside
    ``rubiksnet.setup.first_step``.
    """

    def __init__(self, model, optimizer, scheduler=None, plain=False,
                 data_group=None, time_group=None, model_group=None):
        if model_group is not None and time_group is not None:
            raise ValueError("a model group and a time group cannot be "
                             "used together")
        self.model, self.optimizer, self.scheduler = model, optimizer, (
            scheduler)
        self.plain = plain
        self.step = 0
        self.called = False
        self.data_group, self.time_group = data_group, time_group
        self.model_group = model_group
        shifts = {id(p) for p in param_groups(model)["shift"]}
        self.net = model
        if data_group is not None:
            self.net = _ddp(model, data_group, shifts)
        if time_group is not None:
            replicated(model, time_group)
            self.summed = [p for p in model.parameters()
                           if id(p) not in shifts]
        if model_group is not None:
            sharded = {id(m.weight) for _, m in sharded_modules(model)}
            self.unsharded = [p for p in model.parameters()
                              if id(p) not in sharded]

    def _groups(self):
        stack = contextlib.ExitStack()
        stack.enter_context(data_parallel(self.data_group))
        stack.enter_context(model_parallel(self.model_group))
        if self.time_group is not None:
            stack.enter_context(time_parallel(self.time_group,
                                              self.model.max_shift))
        return stack

    def __call__(self, video, labels):
        first, self.called = not self.called, True
        with (setup_span("rubiksnet.setup.first_step") if first else NULL), (
                span("rubiksnet.train.step", video, call=self.step)):
            return self._step(video, labels)

    def _step(self, video, labels):
        self.model.train()
        with span("rubiksnet.train.zero_grad", video):
            self.optimizer.zero_grad(set_to_none=True)
        with self._groups():
            with span("rubiksnet.train.forward", video):
                logits = self.net(video, plain=self.plain)
                loss = cross_entropy(logits, labels)
            with span("rubiksnet.train.backward", video):
                loss.backward()
                if self.time_group is not None:
                    for p in self.summed:
                        if p.grad is not None:
                            dist.all_reduce(p.grad, group=self.time_group)
                if self.model_group is not None:
                    _first_rank_grads(self.unsharded, self.model_group)
        with span("rubiksnet.train.optimizer", video):
            self.optimizer.step()
            if self.scheduler is not None:
                self.scheduler.step()
        self.step += 1
        with span("rubiksnet.train.metrics", video), torch.no_grad():
            acc = (logits.argmax(-1) == labels).to(loss.dtype).mean()
            metrics = torch.stack([loss.detach(), acc])
            if self.data_group is not None:
                dist.all_reduce(metrics, group=self.data_group)
                metrics /= group_size(self.data_group)
        return {"loss": metrics[0], "accuracy": metrics[1].float()}


def _first_rank_grads(params, group):
    """The gradients of ``params`` set, in place, to the group's first
    rank's: one broadcast of them flattened into one buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.broadcast(flat, dist.get_global_rank(group, 0), group=group)
    for g, v in zip(grads, torch._utils._unflatten_dense_tensors(flat,
                                                                 grads)):
        g.copy_(v)


def _ddp(model, group, shifts):
    """``model`` in ``DistributedDataParallel`` over ``group``, its
    parameters first broadcast from the group's first rank; the shift
    parameters (ids ``shifts``) are left out of DDP's buckets, since their
    ops reduce their raw gradients before normalizing them, and the
    buffers are not re-broadcast (BN's running statistics come from the
    global batch, alike on every rank)."""
    from torch.nn.parallel import DistributedDataParallel

    replicated(model, group)
    DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
        model, [n for n, p in model.named_parameters() if id(p) in shifts])
    dev = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        process_group=group, broadcast_buffers=False)


def make_train_step(model, optimizer, scheduler=None, plain=False,
                    data_group=None, time_group=None, model_group=None):
    """A :class:`TrainStep` over ``model`` and ``optimizer``, on the ranks
    of ``data_group``, ``time_group`` and ``model_group`` where given."""
    return TrainStep(model, optimizer, scheduler, plain, data_group,
                     time_group, model_group)


def make_eval_step(model, num_crops: int = 1, fused: bool = False,
                   normalize=None, executor=None, model_group=None):
    """``eval_step(video, labels) -> {"logits", "top1", "top5"}``.

    video is (N, crops, T, H, W, 3); the logits are averaged over the crops
    axis (the multi-view consensus). The model runs in eval mode, without
    autograd. ``executor``, a :class:`FusedExecutor` of ``model`` that the
    caller holds (an evaluator builds one for its run), runs each block on
    the fused inference kernels where the kernel takes it at the clip's
    shape (else on the module path), with the parameters it folded and
    stacked once and the route it decided at the first batch of each shape.
    ``fused=True`` without an executor does the same through
    ``fused_infer_apply``, stacking the parameters and deciding the route on
    each call, so a model trained in between is seen as it is. ``normalize=(mean, std)`` takes
    raw uint8 pixels and applies ``(v / 255 - mean) / std`` on the device
    in float32. top1 and top5 are per-clip float32 hits. ``model_group``:
    the model is sharded over it, and the module path runs inside
    ``parallel.model_parallel`` (the fused executor refuses a sharded
    model).
    """
    del num_crops  # the crops axis comes from the video's shape
    if executor is not None and executor.model is not model:
        raise ValueError("the executor runs another model")

    @torch.no_grad()
    def eval_step(video, labels):
        model.eval()
        n, crops = video.shape[0], video.shape[1]
        flat = video.reshape((n * crops,) + tuple(video.shape[2:]))
        if normalize is not None:
            mean = torch.as_tensor(normalize[0], dtype=torch.float32,
                                   device=flat.device)
            std = torch.as_tensor(normalize[1], dtype=torch.float32,
                                  device=flat.device)
            flat = (flat.float() * (1.0 / 255.0) - mean) / std
        if executor is not None:
            logits = executor(flat)
        elif fused:
            logits = fused_infer_apply(model, flat)
        else:
            with model_parallel(model_group):
                logits = model(flat)
        logits = logits.float().reshape(n, crops, -1).mean(dim=1)
        labels = labels.long()
        top1 = logits.argmax(-1) == labels
        k = min(5, logits.shape[-1])
        top5 = (logits.topk(k, dim=-1).indices == labels[:, None]).any(-1)
        return {"logits": logits, "top1": top1.float(),
                "top5": top5.float()}

    return eval_step
