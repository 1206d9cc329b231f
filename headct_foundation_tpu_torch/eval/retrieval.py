"""Volume-to-volume retrieval evaluation (mAP).

The port's own copy of the JAX package's ``eval/retrieval.py:20-59`` (the
reference's hemorrhage-subtype retrieval mAP on RSNA / CQ500, BASELINE.md):
every volume is embedded by the frozen encoder's CLS feature, the corpus is
ranked by cosine similarity for each positive query, and the average
precision of retrieving the other volumes of the same label is averaged.

It stays numpy on the host, as the JAX package keeps it (its ``:7-10``):
the evaluation corpora are a few thousand volumes, and their [N, N] score
matrix is one small product.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def cosine_similarity_matrix(embeddings: np.ndarray) -> np.ndarray:
    e = np.asarray(embeddings, dtype=np.float32)
    e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    return e @ e.T


def average_precision(ranked_relevance: np.ndarray) -> float:
    """AP of a ranked binary relevance list (nan when nothing is relevant)."""
    rel = np.asarray(ranked_relevance, dtype=np.float64)
    if rel.sum() == 0:
        return float("nan")
    cum = np.cumsum(rel)
    precision_at_k = cum / (np.arange(len(rel)) + 1)
    return float((precision_at_k * rel).sum() / rel.sum())


def retrieval_map(embeddings: np.ndarray, labels: np.ndarray,
                  query_mask: Optional[np.ndarray] = None) -> float:
    """mAP: each positive volume (within ``query_mask``) queries the rest of
    the corpus; the relevant ones are the other positives of the label."""
    labels = np.asarray(labels).astype(bool)
    sims = cosine_similarity_matrix(embeddings)
    queries = np.nonzero(labels if query_mask is None else labels & query_mask)[0]
    aps = []
    for q in queries:
        order = np.argsort(-sims[q])
        order = order[order != q]  # the query itself is not retrieved
        aps.append(average_precision(labels[order]))
    return float(np.nanmean(aps)) if aps else float("nan")


def retrieval_map_per_class(embeddings: np.ndarray,
                            label_dict: Dict[str, np.ndarray]) -> Dict[str, float]:
    """mAP per label column (``{"IPH": ..., "IVH": ...}``)."""
    return {name: retrieval_map(embeddings, y) for name, y in label_dict.items()}
