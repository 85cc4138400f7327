"""Dataset registry: path layouts of the supported datasets.

Counterpart of ``rubiksnet_tpu/data/config.py`` (the reference's
dataset/config.py): hard-coded layouts for ucf101, hmdb51, something v1/v2
and kinetics; the class count of the something datasets is the line count
of their category file.
"""

from __future__ import annotations

import os
from typing import Tuple


def return_ucf101(root_path):
    return (
        101,
        "ucf101/label/train.txt",
        "ucf101/label/val.txt",
        os.path.join(root_path, "ucf101/rgb"),
        "img_{:05d}.jpg",
    )


def return_hmdb51(root_path):
    return (
        51,
        "hmdb/label/train.txt",
        "hmdb/label/val.txt",
        os.path.join(root_path, "hmdb/rgb"),
        "img_{:05d}.jpg",
    )


def return_somethingv1(root_path):
    return (
        "somethingv1/label/category.txt",
        "somethingv1/label/train_videofolder.txt",
        "somethingv1/label/val_videofolder.txt",
        os.path.join(root_path, "somethingv1/rgb"),
        "{:05d}.jpg",
    )


def return_somethingv2(root_path):
    return (
        "somethingv2/label/category.txt",
        "somethingv2/label/train_videofolder.txt",
        "somethingv2/label/val_videofolder.txt",
        os.path.join(root_path, "somethingv2/rgb"),
        "{:06d}.jpg",
    )


def return_kinetics(root_path):
    return (
        400,
        "kinetics/labels/train_videofolder.txt",
        "kinetics/labels/val_videofolder.txt",
        os.path.join(root_path, "kinetics/images"),
        "img_{:05d}.jpg",
    )


_REGISTRY = {
    "something": return_somethingv2,
    "somethingv2": return_somethingv2,
    "somethingv1": return_somethingv1,
    "ucf101": return_ucf101,
    "hmdb": return_hmdb51,
    "kinetics": return_kinetics,
}


def return_dataset(dataset: str, root_path: str) -> Tuple[int, str, str, str, str]:
    """-> (n_class, train_list, val_list, data_root, frame-name template).
    Raises ValueError on a name the registry does not hold."""
    if dataset not in _REGISTRY:
        raise ValueError(f"Unknown dataset {dataset}")
    categories, train_list, val_list, root_data, prefix = _REGISTRY[dataset](root_path)
    train_list = os.path.join(root_path, train_list)
    val_list = os.path.join(root_path, val_list)
    if isinstance(categories, str):
        with open(os.path.join(root_path, categories)) as f:
            n_class = len(f.readlines())
    else:
        n_class = categories
    return n_class, train_list, val_list, root_data, prefix
