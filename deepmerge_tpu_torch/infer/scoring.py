"""RAG edge scoring (port of ``deepmerge_tpu/infer/scoring.py``): mean-pool
each region's point embeddings, then score every edge in padded batches —
the Euclidean distance written back as the ``simi`` edge attribute."""

from __future__ import annotations

import numpy as np
import torch

from deepmerge_tpu_torch.geodata.types import Scene
from deepmerge_tpu_torch.ops.segment import edge_distances, segment_mean


def region_embeddings(point_embeddings, point_region,
                      num_regions: int) -> torch.Tensor:
    """(P, D) point embeddings (numpy, or a tensor on any device) → (R, D)
    float32 mean-pooled region embeddings on the embeddings' device."""
    emb = torch.as_tensor(point_embeddings).to(torch.float32)
    return segment_mean(emb, torch.as_tensor(point_region, device=emb.device),
                        num_regions)


def score_edges(region_emb: torch.Tensor, edges,
                edge_batch: int = 8192) -> np.ndarray:
    """Distance per edge, in padded batches of ``edge_batch``; (E,) float32
    on the host."""
    e = np.asarray(edges, np.int32)
    n = len(e)
    out = np.empty(n, np.float32)
    for start in range(0, n, edge_batch):
        chunk = e[start : start + edge_batch]
        real = len(chunk)
        if real < edge_batch:
            chunk = np.concatenate(
                [chunk, np.zeros((edge_batch - real, 2), np.int32)])
        d = edge_distances(region_emb, torch.from_numpy(chunk).to(
            region_emb.device))
        out[start : start + real] = d[:real].cpu().numpy()
    return out


def score_scene_edges(scene: Scene, point_embeddings,
                      edge_batch: int = 8192) -> np.ndarray:
    """Score every RAG edge of a scene; fills ``scene.rag.simi``."""
    remb = region_embeddings(point_embeddings, scene.regions.point_region,
                             scene.regions.num_regions)
    simi = score_edges(remb, scene.rag.edges, edge_batch)
    scene.rag.simi = simi
    return simi
