"""Serving export of the PyTorch port: ``torch.export`` programs of the
eval forward that run the port's kernels as ``rubiksnet::`` operators."""

from .export import (
    MAX_BATCH,
    export_eval_fn,
    load_exported,
    operator_counts,
    run_exported,
    save_exported,
)

__all__ = [
    "MAX_BATCH",
    "export_eval_fn",
    "load_exported",
    "operator_counts",
    "run_exported",
    "save_exported",
]
