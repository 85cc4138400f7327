"""Ahead-of-time export of the eval forward for serving.

Counterpart of ``rubiksnet_tpu/serving/export.py``: ``torch.export``
traces the multi-view eval forward once into an ``ExportedProgram``, which
:func:`save_exported` writes as one file holding the graph and the weights;
a serving process calls :func:`load_exported` and :func:`run_exported` and
needs no model code, no checkpoint and no tracing.

The kernels stay kernels in the program: K2, K3, K1's forward, the 2D
shift's forward and the fused executor's stem are the operators of
``rubiksnet_torch/ops/library.py`` (``rubiksnet::fused_block_run``,
``fused_entry_run``, ``shift3d_forward``, ``shift2d_forward``,
``stem_conv``), which the tracer keeps as opaque nodes. On the card
each node launches its kernel, under the launch plan the kernel's wrapper
picks from the real input, as eager code does; on the CPU it runs the
kernel's plain version. :func:`load_exported` registers the operators
before it deserializes (a program with operators nobody registered does
not load) and raises if they cannot be registered.

No ``platforms`` argument: an artifact holds its weights on the device the
model was on when it was exported, and runs there (CUDA or the CPU).

The batch is fixed at export by default; ``polymorphic_batch=True``
exports it as the symbol ``n`` in ``[1, max_batch]`` instead. One program
runs one route at every batch it takes, so the fused executor must route
every clip count that range gives alike
(``FusedExecutor.route_for_batches``), or the export raises, naming the
batch where the route changes. ``max_batch`` defaults to 32
(:data:`MAX_BATCH`): the largest batch the port serves on the card (its
serving points are 1, 8 and 32; 32 is the evaluator's 1-clip batch). K2's
and K3's launch plans depend on the batch, and ``chip_smoke.py`` holds
them against their plain versions at every batch of [1, 32] at Large's
shapes (rubiks3d, bf16) before it runs a program of that range; other
models and ranges are checked there only at the batches it serves. The
symbol needs a finite maximum for the route check above.
"""

from __future__ import annotations

import collections
import os
import tempfile
import weakref

import torch

MAX_BATCH = 32
_MODULES = weakref.WeakKeyDictionary()  # ExportedProgram -> its module


class _EvalForward(torch.nn.Module):
    """(N, crops, T, H, W, 3) -> (N, num_classes): flatten to clips, run
    the model or its :class:`~rubiksnet_torch.models.FusedExecutor`, mean
    over the crops. The executor is no module, so only the tensors it reads
    enter the program (as constants); with ``fused=False`` the model's
    parameters and buffers do."""

    def __init__(self, model, fused, clips):
        super().__init__()
        if fused:
            from ..models import FusedExecutor

            self.executor = FusedExecutor(model)
        else:
            self.model = model
        self.fused, self.clips = fused, clips

    def forward(self, video):
        n, crops = video.shape[0], video.shape[1]
        flat = video.reshape((n * crops,) + tuple(video.shape[2:]))
        if self.fused:
            logits = self.executor(flat, self.clips)
        else:
            logits = self.model(flat)
        return logits.reshape(n, crops, -1).mean(dim=1)


def export_eval_fn(model, batch_size: int, num_crops: int = 1,
                   input_size: int = 224, fused: bool = False,
                   dtype=torch.float32, polymorphic_batch: bool = False,
                   max_batch: int = MAX_BATCH):
    """Export the multi-view eval forward as a self-contained program.

    Args:
      model: a RubiksNet in eval mode, on the device the program will run
        on.
      batch_size: clips per call (the example's batch when polymorphic,
        at least 2 there, as the tracer specializes a size of 1).
      num_crops: views per clip; logits are averaged over them inside the
        program.
      input_size: spatial crop size the server will feed.
      fused: route through the FusedExecutor (K2 and K3 operators) instead
        of the module path (K1 or the 2D shift's operators).
      dtype: input dtype the server will feed (the model casts it to its
        own compute dtype).
      polymorphic_batch: export the batch as a symbol in [1, max_batch].
      max_batch: the symbol's maximum (see the module docstring).

    Returns a ``torch.export.ExportedProgram``; write it with
    :func:`save_exported`.
    """
    if model.training:
        raise ValueError("export_eval_fn exports inference: call .eval()")
    device = next(model.parameters()).device
    if polymorphic_batch:
        if max_batch < 2:
            raise ValueError(f"max_batch must be >= 2, got {max_batch}")
        example = min(max(batch_size, 2), max_batch)
        clips = range(num_crops, max_batch * num_crops + 1, num_crops)
        dynamic = ({0: torch.export.Dim("n", min=1, max=max_batch)},)
    else:
        example, clips, dynamic = batch_size, None, None
    video = torch.zeros((example, num_crops, model.num_frames, input_size,
                         input_size, 3), dtype=dtype, device=device)
    with torch.no_grad():
        exported = torch.export.export(_EvalForward(model, fused, clips),
                                       (video,), dynamic_shapes=dynamic)
    if operator_counts(exported)["aten.gather"]:
        raise RuntimeError("the plain shift's gather was traced where a "
                           "rubiksnet:: operator should stand")
    # Else the saved file carries the example video: 38.5 MB of zeros for
    # Large at batch 8.
    exported.example_inputs = None
    return exported


def operator_counts(exported):
    """Calls per operator in a program's graphs, by name without the
    overload (``"rubiksnet.fused_block_run"``, ``"aten.conv2d"``)."""
    counts = collections.Counter()
    for module in exported.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            counts.update(
                str(getattr(node.target, "overloadpacket", node.target))
                for node in module.graph.nodes
                if node.op == "call_function")
    return counts


def save_exported(path: str, exported) -> None:
    """Write an ExportedProgram to ``path`` (atomic: a temporary file of its
    own in the same directory, then ``os.replace``)."""
    # torch.export.save expects the suffix.
    fd, tmp = tempfile.mkstemp(suffix=".pt2", prefix=".export-",
                               dir=os.path.dirname(os.path.abspath(path)))
    os.close(fd)
    try:
        torch.export.save(exported, tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_exported(path: str):
    """Register the ``rubiksnet::`` operators (importing them registers
    them, or raises), then load a program written by
    :func:`save_exported`."""
    from ..ops import library  # registers the operators

    return torch.export.load(path)


def run_exported(exported, video):
    """Run a program on ``video`` (N, crops, T, H, W, 3) without autograd;
    its module is built at the first call and kept for the next."""
    module = _MODULES.get(exported)
    if module is None:
        module = _MODULES[exported] = exported.module()
    with torch.no_grad():
        return module(video)
