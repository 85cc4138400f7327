"""Measurement and evaluation helpers of the PyTorch port."""

from .benchmark import (
    cuda_busy_ms,
    cuda_call_times_ms,
    cuda_kernel_times,
    cuda_queued_time_ms,
    cuda_time_ms,
    host_call_times_ms,
    nvidia_smi_line,
)
from .metrics import (
    AverageMeter,
    confusion_matrix,
    per_class_accuracy,
    topk_accuracy,
)

__all__ = ["AverageMeter", "confusion_matrix", "cuda_busy_ms",
           "cuda_call_times_ms", "cuda_kernel_times", "cuda_queued_time_ms",
           "cuda_time_ms", "host_call_times_ms", "nvidia_smi_line",
           "per_class_accuracy", "topk_accuracy"]
