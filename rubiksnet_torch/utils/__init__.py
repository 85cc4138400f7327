"""Measurement and evaluation helpers of the PyTorch port."""

from .benchmark import (
    cuda_call_times_ms,
    cuda_kernel_times,
    cuda_queued_time_ms,
    cuda_time_ms,
    nvidia_smi_line,
)
from .metrics import (
    AverageMeter,
    confusion_matrix,
    per_class_accuracy,
    topk_accuracy,
)
from .profiling import ThroughputMeter, Timer, trace

__all__ = ["AverageMeter", "ThroughputMeter", "Timer", "confusion_matrix",
           "cuda_call_times_ms", "cuda_kernel_times", "cuda_queued_time_ms",
           "cuda_time_ms", "nvidia_smi_line", "per_class_accuracy",
           "topk_accuracy", "trace"]
