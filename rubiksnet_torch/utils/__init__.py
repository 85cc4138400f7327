"""Measurement helpers of the PyTorch port."""

from .benchmark import (
    cuda_call_times_ms,
    cuda_kernel_times,
    cuda_queued_time_ms,
    cuda_time_ms,
    nvidia_smi_line,
)

__all__ = ["cuda_call_times_ms", "cuda_kernel_times", "cuda_queued_time_ms",
           "cuda_time_ms", "nvidia_smi_line"]
