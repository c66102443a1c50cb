"""Iterative region merge (port of ``deepmerge_tpu/infer/merge.py``).

Two engines give the same partition. The host engine runs rounds of
device pooling + edge scoring, then union-find over the passing edges
(the C++ ``deepmerge_tpu_torch.native.unionfind`` when it is built), a stable
relabel and RAG contraction. The device engine (``merge_scene_device``) is
min-label propagation on the device (``ops/labelprop.device_merge``).
Labels follow min-member-id semantics, densified in order of the smallest
member id.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from deepmerge_tpu_torch.geodata.types import Scene
from deepmerge_tpu_torch.ops.segment import edge_distances, segment_mean
from deepmerge_tpu_torch.utils.device import resolve_device

try:
    from deepmerge_tpu_torch.native import unionfind as _native_uf

    if not _native_uf.available():  # toolchain missing: Python union-find
        _native_uf = None
except Exception:  # pragma: no cover - the native extension is optional
    _native_uf = None


class UnionFind:
    """Path-halving union-find; the smaller root wins a union."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return int(x)

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra < rb:
            self.parent[rb] = ra
        elif rb < ra:
            self.parent[ra] = rb

    def union_edges(self, edges: np.ndarray) -> None:
        for a, b in edges:
            self.union(int(a), int(b))

    def labels(self) -> tuple[np.ndarray, int]:
        """Dense labels 0..k-1 ordered by smallest member id."""
        n = len(self.parent)
        roots = np.fromiter((self.find(i) for i in range(n)), np.int64, n)
        uniq, dense = np.unique(roots, return_inverse=True)
        return dense.astype(np.int32), len(uniq)


def connected_labels(n: int, edges: np.ndarray) -> tuple[np.ndarray, int]:
    """Dense connected-component labels of n nodes under ``edges``."""
    if _native_uf is not None:
        return _native_uf.connected_labels(n, edges)
    uf = UnionFind(n)
    uf.union_edges(edges)
    return uf.labels()


def _round_scores(emb: torch.Tensor, pt_cluster: torch.Tensor,
                  edges: torch.Tensor, num_segments: int) -> torch.Tensor:
    """One merge round's device work: pool the points by cluster, score
    the edges."""
    return edge_distances(segment_mean(emb, pt_cluster, num_segments), edges)


@dataclass
class MergeResult:
    region_to_cluster: np.ndarray          # (R,) final cluster id per region
    num_clusters: int
    rounds: int
    edges_scored: int
    merges_per_round: list[int] = field(default_factory=list)

    def label_map(self, scene: Scene) -> np.ndarray:
        """Merged (H, W) label map: region labels → cluster ids."""
        return self.region_to_cluster[scene.labels]


def _contract(labels: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Edges remapped through ``labels``, self-loops dropped, deduplicated
    as sorted (lo, hi) pairs."""
    remapped = labels[edges]
    remapped = remapped[remapped[:, 0] != remapped[:, 1]]
    lo = np.minimum(remapped[:, 0], remapped[:, 1])
    hi = np.maximum(remapped[:, 0], remapped[:, 1])
    return np.unique(np.stack([lo, hi], 1), axis=0)


class MergeEngine:
    """Round-based merge over a scored RAG; the pooling and scoring of each
    round run on ``device`` (the card unless the caller asks for the CPU;
    without a card that raises)."""

    def __init__(self, threshold: float = 1.0, max_rounds: int = 16,
                 edge_batch: int = 8192,
                 device: torch.device | str = "cuda"):
        self.threshold = threshold
        self.max_rounds = max_rounds
        self.edge_batch = edge_batch
        self.device = resolve_device(device)

    def run(self, point_embeddings, point_region: np.ndarray,
            num_regions: int, edges: np.ndarray) -> MergeResult:
        return self.run_from(point_embeddings, point_region, num_regions,
                             edges)

    def run_from(self, point_embeddings, point_region: np.ndarray,
                 num_regions: int, edges: np.ndarray,
                 initial_labels: np.ndarray | None = None) -> MergeResult:
        """Merge rounds, optionally from an existing partition (dense
        labels)."""
        point_region = np.asarray(point_region, np.int64)
        cur_edges = np.asarray(edges, np.int64)
        if initial_labels is None:
            cur_labels = np.arange(num_regions, dtype=np.int64)
            n_clusters = num_regions
        else:
            cur_labels = np.asarray(initial_labels, np.int64).copy()
            cur_edges = _contract(cur_labels, cur_edges)
            n_clusters = int(cur_labels.max()) + 1
        total_scored, merges, rounds = 0, [], 0
        emb = torch.as_tensor(point_embeddings).to(self.device, torch.float32)

        for rounds in range(1, self.max_rounds + 1):
            if len(cur_edges) == 0:
                rounds -= 1
                break
            # the segment count stays the initial region count (cluster ids
            # are always below it)
            pt_cluster = torch.from_numpy(cur_labels[point_region]).to(
                self.device)
            e = cur_edges
            pad = (-len(e)) % self.edge_batch
            if pad:
                e = np.concatenate([e, np.zeros((pad, 2), e.dtype)])
            d = _round_scores(emb, pt_cluster,
                              torch.from_numpy(e).to(self.device),
                              num_regions)[: len(cur_edges)].cpu().numpy()
            total_scored += len(cur_edges)
            passing = cur_edges[d < self.threshold]
            merges.append(len(passing))
            if len(passing) == 0:
                rounds -= 1
                break
            comp, n_new = connected_labels(n_clusters, passing)
            cur_labels = comp.astype(np.int64)[cur_labels]
            cur_edges = _contract(comp, cur_edges)
            n_clusters = n_new

        return MergeResult(
            region_to_cluster=cur_labels.astype(np.int32),
            num_clusters=n_clusters, rounds=rounds,
            edges_scored=total_scored, merges_per_round=merges,
        )


def merge_scene(scene: Scene, point_embeddings, threshold: float = 1.0,
                max_rounds: int = 16, edge_batch: int = 8192,
                device: torch.device | str = "cuda") -> MergeResult:
    """The host engine over a scene's RAG, scoring on ``device``."""
    engine = MergeEngine(threshold, max_rounds, edge_batch, device)
    return engine.run(point_embeddings, scene.regions.point_region,
                      scene.regions.num_regions, scene.rag.edges)


def padded_edges(scene: Scene, edge_pad: int):
    """The RAG's (E, 2) int32 edges padded to a multiple of ``edge_pad``
    (at least one pad batch when there are none), and the (E,) valid
    mask."""
    edges = np.asarray(scene.rag.edges, np.int32).reshape(-1, 2)
    pad = (-len(edges)) % edge_pad if len(edges) else edge_pad
    valid = np.ones(len(edges), bool)
    if pad:
        edges = np.concatenate([edges, np.zeros((pad, 2), np.int32)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
    return edges, valid


def merge_scene_device(scene: Scene, point_embeddings,
                       threshold: float = 1.0, max_rounds: int = 16,
                       edge_pad: int = 2048) -> MergeResult:
    """The device engine: min-label-propagation rounds on the embeddings'
    device (a numpy array runs on the CPU); same partition as
    ``merge_scene``. ``edges_scored`` counts every sweep over the padded
    valid edges, the last one that merged nothing included."""
    from deepmerge_tpu_torch.ops.labelprop import device_merge

    emb = torch.as_tensor(point_embeddings).to(torch.float32)
    dev = emb.device
    edges, valid = padded_edges(scene, edge_pad)
    labels, rounds = device_merge(
        emb, torch.as_tensor(scene.regions.point_region, device=dev),
        torch.from_numpy(edges).to(dev), torch.from_numpy(valid).to(dev),
        threshold, num_regions=scene.regions.num_regions,
        max_rounds=max_rounds,
    )
    sweeps_run = min(int(rounds) + 1, max_rounds)
    return labels_to_result(labels, rounds,
                            edges_scored=sweeps_run * int(valid.sum()))


def write_label_geotiff(path: str, label_map, geotransform=None) -> None:
    """Write an (H, W) merged label map as a GeoTIFF: ids packed into three
    little-endian uint8 planes (up to 16.7M clusters); decode with
    ``a[..., 0] | a[..., 1] << 8 | a[..., 2] << 16``."""
    from deepmerge_tpu_torch.geodata.geotiff import write_geotiff

    if isinstance(label_map, torch.Tensor):
        label_map = label_map.cpu().numpy()
    lm = np.asarray(label_map).astype(np.uint32)
    packed = np.stack([lm & 0xFF, (lm >> 8) & 0xFF, (lm >> 16) & 0xFF],
                      -1).astype(np.uint8)
    write_geotiff(path, packed, geotransform or (0, 1, 0, 0, 0, -1))


def labels_to_result(labels, rounds, scene: Scene | None = None,
                     edges_scored: int | None = None) -> MergeResult:
    """Densify min-member-id labels into a MergeResult on the host."""
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    uniq, dense = np.unique(np.asarray(labels), return_inverse=True)
    if edges_scored is None:
        edges_scored = int(rounds) * (
            len(scene.rag.edges) if scene is not None else 0)
    return MergeResult(region_to_cluster=dense.astype(np.int32),
                       num_clusters=len(uniq), rounds=int(rounds),
                       edges_scored=edges_scored)
