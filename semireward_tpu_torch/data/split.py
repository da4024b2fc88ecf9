"""Labeled/unlabeled split utilities (copy of ``semireward_tpu/data/split.py``,
numpy only, so both packages give the same splits for the same seed).

Rebuild of reference semilearn/datasets/utils.py:25-153: class-balanced (or
gamma-imbalanced) sampling of labeled indices, remainder as unlabeled,
optional lb-in-ulb inclusion, and index persistence to
``data_statistics/<dataset>/labeled_idx/*.npy`` for reproducibility.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def make_imbalance_data(max_num_labels: int, num_classes: int, gamma: float):
    """reference datasets/utils.py:140-153."""
    mu = np.power(1 / abs(gamma), 1 / (num_classes - 1))
    samples_per_class = []
    for c in range(num_classes):
        if c == (num_classes - 1):
            samples_per_class.append(int(max_num_labels / abs(gamma)))
        else:
            samples_per_class.append(int(max_num_labels * np.power(mu, c)))
    if gamma < 0:
        samples_per_class = samples_per_class[::-1]
    return samples_per_class


def sample_labeled_unlabeled_data(
    target: np.ndarray,
    num_classes: int,
    lb_num_labels: int,
    ulb_num_labels: Optional[int] = None,
    lb_imbalance_ratio: float = 1.0,
    ulb_imbalance_ratio: float = 1.0,
    rng: Optional[np.random.RandomState] = None,
    dump_dir: Optional[str] = None,
    dump_tag: str = "",
    load_exist: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-balanced labeled sampling; remainder (or imbalanced subset) as
    unlabeled. Persisted to .npy like the reference for run-to-run split
    determinism."""
    rng = rng or np.random
    lb_path = ulb_path = None
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
        lb_path = os.path.join(dump_dir, f"lb_{dump_tag}_idx.npy")
        ulb_path = os.path.join(dump_dir, f"ulb_{dump_tag}_idx.npy")
        if load_exist and os.path.exists(lb_path) and os.path.exists(ulb_path):
            return np.load(lb_path), np.load(ulb_path)

    if lb_imbalance_ratio == 1.0:
        assert lb_num_labels % num_classes == 0, (
            "lb_num_labels must be dividable by num_classes in balanced setting")
        lb_per_class = [lb_num_labels // num_classes] * num_classes
    else:
        lb_per_class = make_imbalance_data(lb_num_labels, num_classes,
                                           lb_imbalance_ratio)

    ulb_per_class = None
    if ulb_imbalance_ratio == 1.0:
        if ulb_num_labels is not None:
            assert ulb_num_labels % num_classes == 0
            ulb_per_class = [ulb_num_labels // num_classes] * num_classes
    else:
        assert ulb_num_labels is not None
        ulb_per_class = make_imbalance_data(ulb_num_labels, num_classes,
                                            ulb_imbalance_ratio)

    lb_idx, ulb_idx = [], []
    if num_classes > 1:
        for c in range(num_classes):
            idx = np.where(target == c)[0]
            rng.shuffle(idx)
            lb_idx.extend(idx[: lb_per_class[c]])
            if ulb_per_class is None:
                ulb_idx.extend(idx[lb_per_class[c]:])
            else:
                ulb_idx.extend(idx[lb_per_class[c]: lb_per_class[c] + ulb_per_class[c]])
    else:  # regression: no classes
        idx = np.arange(len(target))
        rng.shuffle(idx)
        lb_idx.extend(idx[: lb_per_class[0]])
        if ulb_per_class is None:
            ulb_idx.extend(idx[lb_per_class[0]:])
        else:
            ulb_idx.extend(idx[lb_per_class[0]: lb_per_class[0] + ulb_per_class[0]])

    lb_idx = np.asarray(lb_idx)
    ulb_idx = np.asarray(ulb_idx)
    if lb_path:
        np.save(lb_path, lb_idx)
        np.save(ulb_path, ulb_idx)
    return lb_idx, ulb_idx


def split_ssl_data(
    data: np.ndarray,
    targets: np.ndarray,
    num_classes: int,
    lb_num_labels: int,
    ulb_num_labels: Optional[int] = None,
    lb_imbalance_ratio: float = 1.0,
    ulb_imbalance_ratio: float = 1.0,
    include_lb_to_ulb: bool = True,
    rng: Optional[np.random.RandomState] = None,
    dump_dir: Optional[str] = None,
    dump_tag: str = "",
):
    """reference datasets/utils.py:25-52."""
    data, targets = np.asarray(data), np.asarray(targets)
    lb_idx, ulb_idx = sample_labeled_unlabeled_data(
        targets, num_classes, lb_num_labels, ulb_num_labels,
        lb_imbalance_ratio, ulb_imbalance_ratio, rng=rng,
        dump_dir=dump_dir, dump_tag=dump_tag, load_exist=False)
    if include_lb_to_ulb:
        ulb_idx = np.concatenate([lb_idx, ulb_idx], axis=0)
    return data[lb_idx], targets[lb_idx], data[ulb_idx], targets[ulb_idx]
