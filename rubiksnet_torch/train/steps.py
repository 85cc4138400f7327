"""Train and eval steps.

Counterpart of ``rubiksnet_tpu/train/steps.py``. PyTorch runs eagerly and
updates in place, so a step is a callable that owns the model and
optimizer instead of a pure function of a train state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.fused_infer import fused_infer_apply


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
    """

    def __init__(self, model, optimizer, scheduler=None, plain=False):
        self.model, self.optimizer, self.scheduler = model, optimizer, (
            scheduler)
        self.plain = plain
        self.step = 0

    def __call__(self, video, labels):
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.model(video, plain=self.plain)
        loss = cross_entropy(logits, labels)
        loss.backward()
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}


def make_train_step(model, optimizer, scheduler=None, plain=False):
    """A :class:`TrainStep` over ``model`` and ``optimizer``."""
    return TrainStep(model, optimizer, scheduler, plain)


def make_eval_step(model, num_crops: int = 1, fused: bool = False,
                   normalize=None, executor=None):
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
    in float32. top1 and top5 are per-clip float32 hits.
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
            logits = model(flat)
        logits = logits.float().reshape(n, crops, -1).mean(dim=1)
        labels = labels.long()
        top1 = logits.argmax(-1) == labels
        k = min(5, logits.shape[-1])
        top5 = (logits.topk(k, dim=-1).indices == labels[:, None]).any(-1)
        return {"logits": logits, "top1": top1.float(),
                "top5": top5.float()}

    return eval_step
