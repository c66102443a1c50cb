"""Segment pooling and padded edge scoring (port of
``deepmerge_tpu/ops/segment.py``).

JAX clamps out-of-range gather indices and drops out-of-range scatter
indices; torch faults on both. Every index that may be a pad sentinel is
therefore mapped explicitly here before it is used.
"""

from __future__ import annotations

import torch


def segment_mean(embeddings: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean-pool (N, D) point embeddings into (num_segments, D) by id.

    Segments with no points get a zero embedding. Ids outside
    ``[0, num_segments)`` — ``num_segments`` is the pad id — are dropped.
    Counts accumulate in float32 whatever the embedding dtype.
    """
    ids = segment_ids.long()
    ids = torch.where((ids < 0) | (ids > num_segments), num_segments, ids)
    n, d = embeddings.shape
    sums = torch.zeros((num_segments + 1, d), dtype=embeddings.dtype,
                       device=embeddings.device)
    sums.index_add_(0, ids, embeddings)
    counts = torch.zeros(num_segments + 1, dtype=torch.float32,
                         device=embeddings.device)
    counts.index_add_(0, ids, torch.ones(n, dtype=torch.float32,
                                         device=embeddings.device))
    sums, counts = sums[:num_segments], counts[:num_segments]
    mean = sums.to(torch.float32) / torch.clamp(counts, min=1.0)[:, None]
    return mean.to(sums.dtype)


def clamp_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """JAX's gather clamp: indices into an axis of ``size`` forced into
    ``[0, size-1]``, as int64."""
    return torch.clamp(idx.long(), 0, size - 1)


def edge_distances(region_embeddings: torch.Tensor, edges: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Euclidean distance per RAG edge (the ``simi`` attribute), (E,).

    ``edges`` is (E, 2) region-id pairs; pad rows may point anywhere (their
    ids are clamped like JAX's gather) and, with ``valid``, score +inf.
    """
    r = region_embeddings.shape[0]
    left = region_embeddings[clamp_index(edges[:, 0], r)]
    right = region_embeddings[clamp_index(edges[:, 1], r)]
    d2 = torch.sum((left - right) ** 2, dim=-1)
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    if valid is not None:
        d = torch.where(valid.bool(), d, torch.full_like(d, float("inf")))
    return d


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dense squared Euclidean distance matrix (N, M), clamped at 0."""
    x2 = torch.sum(x * x, dim=1)[:, None]
    y2 = torch.sum(y * y, dim=1)[None, :]
    xy = torch.matmul(x.to(torch.float32), y.to(torch.float32).t())
    return torch.clamp(x2 + y2 - 2.0 * xy, min=0.0)
