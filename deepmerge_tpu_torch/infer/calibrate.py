"""Merge-threshold calibration on a labeled validation scene (port of
``deepmerge_tpu/infer/calibrate.py``): score the scene once, sweep
candidate thresholds through the device merge, and pick the one whose
merged map agrees best with the ground-truth objects."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from deepmerge_tpu_torch.geodata.types import Scene
from deepmerge_tpu_torch.utils.parity import pair_disagreement
from deepmerge_tpu_torch.infer.merge import padded_edges


@dataclass
class CalibrationResult:
    threshold: float                 # argmin-disagreement threshold
    disagreement: float              # its pair disagreement
    clusters: int                    # cluster count at that threshold
    table: list = field(default_factory=list)  # (thr, clusters, disagreement)

    def __str__(self):
        rows = "\n".join(
            f"  thr={t:6.3f}  clusters={c:5d}  disagreement={d * 100:6.3f}%"
            for t, c, d in self.table
        )
        return (
            f"calibrated threshold {self.threshold:.3f} "
            f"({self.disagreement * 100:.3f}% pair disagreement, "
            f"{self.clusters} clusters)\n{rows}"
        )


def candidate_thresholds(scene: Scene, embeddings, n: int = 15) -> np.ndarray:
    """Sweep grid: ``n`` quantiles of the scored RAG edge distances."""
    from deepmerge_tpu_torch.infer.scoring import score_scene_edges

    d = np.asarray(score_scene_edges(scene, embeddings))
    d = d[np.isfinite(d)]
    if d.size == 0:
        raise ValueError(
            f"scene '{scene.name}' has no finite RAG edge distances to "
            "calibrate on (empty edge list or degenerate embeddings) — "
            "pick a validation scene with adjacent regions"
        )
    qs = np.quantile(d, np.linspace(0.05, 0.95, n))
    return np.unique(np.round(qs, 6))


def calibrate_threshold(scene: Scene, embeddings,
                        region_objects: np.ndarray | None = None,
                        thresholds=None,
                        max_rounds: int = 16) -> CalibrationResult:
    """Pick the merge threshold by agreement on a labeled validation scene.

    ``embeddings`` are the (P, D) point embeddings (numpy, or a tensor on
    the device to merge on); ``region_objects`` the (R,) ground-truth
    object per region (default ``scene.object_of_region``). Returns the
    argmin of the pair disagreement of the merged map against the object
    map; ties go to the larger threshold.
    """
    from deepmerge_tpu_torch.ops.labelprop import device_merge

    if region_objects is None:
        region_objects = scene.object_of_region
    if region_objects is None:
        raise ValueError(
            "calibration needs ground-truth region objects "
            "(scene.object_of_region or the region_objects argument)"
        )
    if thresholds is None:
        thresholds = candidate_thresholds(scene, embeddings)

    # staged once; only the threshold varies between candidates
    emb = torch.as_tensor(embeddings).to(torch.float32)
    dev = emb.device
    edges, valid = padded_edges(scene, 2048)
    pr = torch.as_tensor(scene.regions.point_region, device=dev)
    e_dev = torch.from_numpy(edges).to(dev)
    v_dev = torch.from_numpy(valid).to(dev)

    gt = np.asarray(region_objects)[scene.labels]
    table, best = [], None
    # ascending, so that the larger-threshold tie-break holds for any grid
    for thr in np.sort(np.asarray(thresholds, np.float64)):
        labels, _ = device_merge(emb, pr, e_dev, v_dev, float(thr),
                                 num_regions=scene.regions.num_regions,
                                 max_rounds=max_rounds)
        _, dense = np.unique(labels.cpu().numpy(), return_inverse=True)
        pred = dense.astype(np.int32)[scene.labels]
        dis = float(pair_disagreement(pred, gt))
        n_clusters = int(dense.max()) + 1
        table.append((float(thr), n_clusters, dis))
        if best is None or dis < best[2] - 1e-12:
            best = (float(thr), n_clusters, dis)
        elif dis <= best[2] + 1e-12:
            # an epsilon tie: the larger threshold, the best disagreement
            best = (float(thr), n_clusters, best[2])
    return CalibrationResult(threshold=best[0], disagreement=best[2],
                             clusters=best[1], table=table)
