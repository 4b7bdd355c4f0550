"""Non-IID dataset partitioning — Distribution-based label imbalance
(paper §VI-D, implementation of ref [23]): node k samples class c with
probability p_k[c] where p[:, c] ~ Dir_K(alpha). Smaller alpha => more
imbalanced. Numpy copy of the JAX package's module.
"""
from __future__ import annotations

import numpy as np


def dirichlet_class_probs(num_nodes: int, num_classes: int, alpha: float,
                          seed: int = 0) -> np.ndarray:
    """(num_nodes, num_classes) row-normalized class sampling probabilities."""
    rng = np.random.RandomState(seed)
    # Dir over nodes per class, then normalize per node (Li et al. 2021)
    mat = rng.dirichlet([alpha] * num_nodes, size=num_classes).T  # (nodes, classes)
    mat = mat / np.maximum(mat.sum(axis=1, keepdims=True), 1e-9)
    return mat


def iid_class_probs(num_nodes: int, num_classes: int) -> np.ndarray:
    return np.full((num_nodes, num_classes), 1.0 / num_classes)
