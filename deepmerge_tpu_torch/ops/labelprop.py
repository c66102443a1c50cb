"""On-device iterative merge by min-label propagation (port of
``deepmerge_tpu/ops/labelprop.py``).

A round pools the points into cluster embeddings under the current labels,
scores every original RAG edge through its endpoints' clusters, keeps the
edges closer than the threshold, and relabels their connected components by
min-label propagation (scatter-min over edges plus pointer jumping). Rounds
stop when no edge passes or at ``max_rounds``. Labels follow min-member-id
semantics. The JAX package runs this as one compiled program with device
``while_loop``s; here the loops are Python loops whose exit tests read one
scalar from the device per iteration.
"""

from __future__ import annotations

import torch

from deepmerge_tpu_torch.ops.kernels.label_lookup import label_lookup
from deepmerge_tpu_torch.ops.segment import (
    clamp_index,
    edge_distances,
    segment_mean,
)


def _propagate(labels: torch.Tensor, edges: torch.Tensor,
               valid: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Min-label connected components over the ``valid`` edges; stops early
    once a sweep changes nothing (the result equals running all
    ``sweeps``)."""
    a, b = edges[:, 0].long(), edges[:, 1].long()
    big = torch.iinfo(labels.dtype).max
    for _ in range(sweeps):
        m = torch.minimum(labels[a], labels[b])
        upd = torch.where(valid, m, torch.full_like(m, big))
        new = labels.scatter_reduce(0, a, upd, reduce="amin")
        new = new.scatter_reduce(0, b, upd, reduce="amin")
        # pointer jumping: labels follow their own label's label
        new = torch.minimum(new, new[new.long()])
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    return labels


def device_merge(point_embeddings: torch.Tensor, point_region: torch.Tensor,
                 edges: torch.Tensor, edge_valid: torch.Tensor, threshold,
                 num_regions: int, max_rounds: int = 16, sweeps: int = 16):
    """Iterative merge.

    Args:
      point_embeddings: (P, D) float.
      point_region: (P,) region id per point; ``num_regions`` is the pad id
        (such rows join no cluster).
      edges: (E, 2) original RAG edges (pad rows may point anywhere).
      edge_valid: (E,) bool mask of real edges.
      threshold: merge edges with Euclidean distance < threshold.
      num_regions: region count R (possibly a bucket with phantom regions).
      max_rounds: merge round cap.
      sweeps: label-propagation sweeps per round.

    Returns labels (R,) int32 min-member-id cluster labels and rounds (0-d
    int32 tensor).
    """
    dev = point_embeddings.device
    labels = torch.arange(num_regions, dtype=torch.int32, device=dev)
    pr = point_region.long()
    pad_pt = (pr < 0) | (pr >= num_regions)
    pr = clamp_index(pr, num_regions)
    emb = point_embeddings.to(torch.float32)
    ea = clamp_index(edges[:, 0], num_regions)
    eb = clamp_index(edges[:, 1], num_regions)
    valid = edge_valid.bool()
    thr2 = torch.as_tensor(threshold, dtype=torch.float32, device=dev) ** 2
    rounds, changed = 0, True
    while changed and rounds < max_rounds:
        # pad rows keep the pad id through the label gather
        pt_cluster = torch.where(pad_pt, num_regions, labels[pr].long())
        cemb = segment_mean(emb, pt_cluster, num_regions)
        la = labels[ea]
        lb = labels[eb]
        d2 = torch.sum((cemb[la.long()] - cemb[lb.long()]) ** 2, dim=-1)
        passing = valid & (la != lb) & (d2 < thr2)
        labels = _propagate(labels, torch.stack([la, lb], dim=1), passing,
                            sweeps)
        changed = bool(torch.any(passing))
        rounds += int(changed)
    return labels, torch.tensor(rounds, dtype=torch.int32, device=dev)


def device_score_and_merge(point_embeddings: torch.Tensor,
                           point_region: torch.Tensor, edges: torch.Tensor,
                           edge_valid: torch.Tensor, num_regions: int,
                           max_rounds: int = 16, sweeps: int = 16,
                           threshold_quantile: float = 0.5, threshold=None):
    """The scoring+merge tail: region pooling → edge distances (``simi``)
    → threshold (the floor-index ``threshold_quantile`` of the valid
    distances, or the absolute ``threshold``) → ``device_merge``.

    Returns (simi (E,), labels (R,), rounds); pad edge rows score +inf.
    """
    emb = point_embeddings.to(torch.float32)
    remb = segment_mean(emb, point_region, num_regions)
    simi = edge_distances(remb, edges, edge_valid)
    if threshold is None:
        valid_sorted = torch.sort(simi).values
        n_valid = edge_valid.bool().sum().to(torch.int32)
        q = torch.tensor(threshold_quantile, dtype=torch.float32,
                         device=simi.device)
        q_idx = torch.clamp(
            (q * (n_valid - 1).to(torch.float32)).to(torch.int32), 0,
            simi.shape[0] - 1,
        )
        threshold = valid_sorted[q_idx.long()]
    labels, rounds = device_merge(
        emb, point_region, edges, edge_valid, threshold,
        num_regions=num_regions, max_rounds=max_rounds, sweeps=sweeps,
    )
    return simi, labels, rounds


def merged_label_map(labels: torch.Tensor, region_map_hw: torch.Tensor,
                     num_real=None):
    """Dense-relabel cluster labels and expand them to an (H, W) map.

    Dense ids are ordered by smallest member id (as ``np.unique`` would
    give). With ``num_real`` (phantom regions ``num_real..R-1`` of a
    bucketed region axis are singleton clusters sorting after every real
    label) the cluster count covers real clusters only. The sort, cumsum
    and search run over the R labels; the (H, W) expansion is the lookup
    kernel K9 (``ops/kernels/label_lookup``), which reads the int32 map as
    it is.

    Returns (map (H, W) int32, num_clusters 0-d int32 tensor).
    """
    s = torch.sort(labels).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    dense_at_sorted = (torch.cumsum(first, 0) - 1).to(torch.int32)
    dense = dense_at_sorted[torch.searchsorted(s, labels)]
    if num_real is None:
        n_clusters = dense_at_sorted[-1] + 1
    else:
        n_clusters = torch.sum(first & (s < num_real)).to(torch.int32)
    return (label_lookup(dense, region_map_hw.to(torch.int32).contiguous()),
            n_clusters)
