"""Data path of the PyTorch port: frame-folder datasets, samplers, the
Group* transforms, the native (C++/libjpeg) loader, the device loader
(nvjpeg and a CUDA resize-and-crop kernel, ``device_loader.py``,
``device_eval.py``), background prefetch, and host batches to the card
(``device.py``). Counterpart of ``rubiksnet_tpu/data``; imports torch,
numpy and PIL, never JAX."""

from . import device_loader, native_loader
from .config import return_dataset
from .dataset import (
    RubiksDataset,
    VideoRecord,
    batch_iterator,
    parse_list_file,
    sample_all_indices,
    sample_dense_indices,
    sample_test_indices,
    sample_train_indices,
    sample_val_indices,
)
from .device import DeviceBatch, device_batches
from .device_eval import DeviceEvalDataset, device_batches_from_files
from .native_eval import NativeEvalDataset
from .prefetch import PrefetchIterator, prefetch
from .transforms import (
    Compose,
    GroupCenterCrop,
    GroupFullResSample,
    GroupMultiScaleCrop,
    GroupNormalize,
    GroupOverSample,
    GroupRandomCrop,
    GroupRandomHorizontalFlip,
    GroupRandomSizedCrop,
    GroupScale,
    IdentityTransform,
    Stack,
    ToClipArray,
)

__all__ = [
    "Compose", "DeviceBatch", "DeviceEvalDataset", "GroupCenterCrop", "GroupFullResSample",
    "GroupMultiScaleCrop", "GroupNormalize", "GroupOverSample",
    "GroupRandomCrop", "GroupRandomHorizontalFlip", "GroupRandomSizedCrop",
    "GroupScale", "IdentityTransform", "NativeEvalDataset",
    "PrefetchIterator", "RubiksDataset", "Stack", "ToClipArray",
    "VideoRecord", "batch_iterator", "device_batches",
    "device_batches_from_files", "device_loader", "native_loader",
    "parse_list_file", "prefetch", "return_dataset", "sample_all_indices",
    "sample_dense_indices", "sample_test_indices", "sample_train_indices",
    "sample_val_indices",
]
