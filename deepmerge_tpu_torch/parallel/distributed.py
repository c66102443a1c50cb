"""Process-group bring-up and mosaic-scale scene sharding (port of
``deepmerge_tpu/parallel/distributed.py``).

  * ``initialize()`` — ``torch.distributed`` bring-up, one process per
    rank (torchrun's environment, or an explicit coordinator).
  * ``shard_scene_columns`` — split a Scene into S column strips: each strip
    gets the regions whose sample-point centroid falls in it, and the RAG
    edges inside it.
  * ``merge_sharded_approx`` — HOST partition-level simulation (per-strip
    local merges + a global resolution pass). Exact only for monotone
    merging — the name carries the caveat; the exact memory-distributed
    path is ``extract_and_merge_sharded`` / ``distributed_merge``.
  * ``stage_scene_shards``, ``distributed_merge`` and
    ``extract_and_merge_sharded`` — physically disjoint strip tiles, each
    rank embedding only its own points, and merge rounds whose two
    reductions are collectives (``all_reduce`` SUM and MIN).

The JAX package compiles the sharded programs once per shape signature and
keeps them in an LRU; nothing is compiled here, so there is no such cache.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from deepmerge_tpu_torch.config import DataConfig
from deepmerge_tpu_torch.geodata.types import Scene
from deepmerge_tpu_torch.infer.merge import (
    MergeEngine,
    MergeResult,
    connected_labels,
)
from deepmerge_tpu_torch.ops.patches import (
    pad_scene,
    points_inside,
    scene_pad,
    staging_caps,
)
from deepmerge_tpu_torch.ops.segment import clamp_index
from deepmerge_tpu_torch.parallel.mesh import Mesh, all_reduce_, shard_rows


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: torch.device | str = "cuda") -> None:
    """Start the process group: NCCL for a CUDA ``device``, gloo on the
    CPU. ``coordinator`` is ``host:port``; with no arguments the group
    comes from torchrun's environment (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``). A no-op for one process and when a
    group exists; on CUDA the rank's current device becomes
    ``cuda:LOCAL_RANK``."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if num_processes <= 1 or dist.is_initialized():
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        backend="nccl" if cuda else "gloo",
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=num_processes, rank=process_id)


def _strip_of_regions(scene: Scene, n_shards: int) -> np.ndarray:
    """Each region's strip, by the x of its sample-point centroid."""
    r = scene.regions
    cx = np.zeros(r.num_regions)
    counts = np.bincount(r.point_region, minlength=r.num_regions)
    np.add.at(cx, r.point_region, r.points_yx[:, 1].astype(np.float64))
    cx = cx / np.maximum(counts, 1)
    return np.minimum(
        (cx / (scene.image.shape[1] / n_shards)).astype(np.int64),
        n_shards - 1,
    )


@dataclass
class SceneShard:
    regions: np.ndarray          # region ids owned by this shard
    points: np.ndarray           # point indices whose region is owned
    internal_edges: np.ndarray   # (Ei, 2) edges with both ends owned
    strip: int


def shard_scene_columns(scene: Scene, n_shards: int
                        ) -> tuple[list[SceneShard], np.ndarray]:
    """Partition regions into column strips by sample-point centroid x.

    Returns (shards, boundary_edges) where boundary edges cross strips.
    """
    r = scene.regions
    strip_of = _strip_of_regions(scene, n_shards)
    e = scene.rag.edges
    cross = strip_of[e[:, 0]] != strip_of[e[:, 1]]
    boundary = e[cross]
    same = e[~cross]
    same_strip = strip_of[same[:, 0]]
    shards = []
    for s in range(n_shards):
        shards.append(SceneShard(
            regions=np.where(strip_of == s)[0],
            points=np.where(strip_of[r.point_region] == s)[0],
            internal_edges=same[same_strip == s], strip=s))
    return shards, boundary


def merge_sharded_approx(scene: Scene, point_embeddings, n_shards: int,
                         threshold: float = 1.0, max_rounds: int = 16,
                         device: torch.device | str = "cuda") -> MergeResult:
    """HOST simulation: shard-local merges (``MergeEngine`` on ``device``)
    + boundary resolution. APPROX — exact only for monotone merging: every
    shard reads the global embeddings, and local-first merging can leave a
    non-monotone chain in another partition than the global rounds. The
    memory-distributed path is ``extract_and_merge_sharded``."""
    r = scene.regions.num_regions
    shards, _ = shard_scene_columns(scene, n_shards)

    # local merges (each could run on its own rank)
    labels = np.arange(r, dtype=np.int64)
    for shard in shards:
        if len(shard.internal_edges) == 0:
            continue
        local = MergeEngine(threshold, max_rounds, device=device).run(
            point_embeddings, scene.regions.point_region, r,
            shard.internal_edges)
        # fold the local partition into the global labels: each local
        # cluster's representative is its smallest member id
        comp = local.region_to_cluster.astype(np.int64)
        reps = np.full(comp.max() + 1, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(reps, comp, np.arange(r, dtype=np.int64))
        labels = np.minimum(labels, reps[comp])

    # global resolution: union the local partitions, then the global rounds
    # over ALL edges starting from that partition
    pairs = np.stack([np.arange(r, dtype=np.int64), labels], 1)
    comp0, _ = connected_labels(r, pairs)
    return MergeEngine(threshold, max_rounds, device=device).run_from(
        point_embeddings, scene.regions.point_region, r, scene.rag.edges,
        initial_labels=comp0.astype(np.int64))


# ---------------------------------------------------------------------------
# Memory-distributed path: disjoint per-shard pixel tiles (+halo) and an
# EXACT collective merge — no monotonicity assumption.
# ---------------------------------------------------------------------------


@dataclass
class StagedShards:
    """A scene staged as S physically disjoint column-strip shards.

    Every array has leading axis S: rank s reads only row s, its strip's
    pixels (plus halo columns wide enough for every owned point's largest
    window) and its own points.
    """

    tiles: np.ndarray           # (S, Hp, Wp, Cs) uint8, pad_scene layout
    centers: np.ndarray         # (S, Pm, 2) int32 tile-LOCAL yx
    point_region: np.ndarray    # (S, Pm) int32; padding rows = num_regions
    features: np.ndarray        # (S, Pm, 15) float32
    inner: np.ndarray           # (S, Pm) int32
    object_: np.ndarray         # (S, Pm) int32
    edges: np.ndarray           # (S, Em, 2) int32 partition of the RAG
    edge_valid: np.ndarray      # (S, Em) bool
    caps: tuple[int, ...]       # window caps (global, shared)
    num_regions: int


def stage_scene_shards(scene: Scene, cfg: DataConfig,
                       n_shards: int) -> StagedShards:
    """Split a Scene into column-strip shards with real pixel halos.

    Each shard's tile holds only the columns its points can reach (point x
    ± ``scene_pad``), padded to the widest strip, so shard inputs are
    disjoint sub-arrays of the mosaic and every window's content equals
    the whole scene's. A strip with no points gets one column (``xlo, xhi
    = 0, 1``) and sentinel rows only.
    """
    r = scene.regions
    R = r.num_regions
    feats, inner, obj = r.point_meta()

    # global caps (one shape for every shard); warns on clamping
    caps = staging_caps(inner, obj, cfg.patch_sizes, cfg.max_window,
                        scene_name=scene.name)
    c = scene.image.shape[-1]
    halo = scene_pad(caps, c)

    strip_of = _strip_of_regions(scene, n_shards)
    pt_strip = strip_of[r.point_region]
    # edge partition: each edge scored by exactly one shard (min endpoint's)
    e = np.asarray(scene.rag.edges, np.int64)
    e_strip = np.minimum(strip_of[e[:, 0]], strip_of[e[:, 1]])

    pm = max(int(np.max(np.bincount(pt_strip, minlength=n_shards))), 1)
    em = max(int(np.max(np.bincount(e_strip, minlength=n_shards))), 1)

    h, w = scene.image.shape[:2]
    bounds = []
    for s in range(n_shards):
        pts = np.where(pt_strip == s)[0]
        if len(pts):
            xs = r.points_yx[pts, 1].astype(np.int64)
            bounds.append((max(int(xs.min()) - halo, 0),
                           min(int(xs.max()) + halo + 1, w)))
        else:
            bounds.append((0, 1))
    wmax = max(xhi - xlo for xlo, xhi in bounds)

    out = {k: [] for k in ("tiles", "centers", "point_region", "features",
                           "inner", "object_", "edges", "edge_valid")}
    for s, (xlo, xhi) in enumerate(bounds):
        tile = np.zeros((h, wmax, c), scene.image.dtype)
        tile[:, : xhi - xlo] = scene.image[:, xlo:xhi]
        out["tiles"].append(pad_scene(tile, caps))

        pts = np.where(pt_strip == s)[0]
        n = len(pts)
        ctr = np.zeros((pm, 2), np.int32)
        pr = np.full(pm, R, np.int32)          # sentinel: dropped by pooling
        ft = np.zeros((pm, feats.shape[1]), np.float32)
        inn = np.full(pm, 8, np.int32)
        ob = np.full(pm, 16, np.int32)
        if n:
            ctr[:n, 0] = r.points_yx[pts, 0]
            ctr[:n, 1] = r.points_yx[pts, 1] - xlo
            pr[:n] = r.point_region[pts]
            ft[:n] = feats[pts]
            inn[:n] = inner[pts]
            ob[:n] = obj[pts]
        for k, v in (("centers", ctr), ("point_region", pr),
                     ("features", ft), ("inner", inn), ("object_", ob)):
            out[k].append(v)

        es = np.where(e_strip == s)[0]
        ed = np.zeros((em, 2), np.int32)
        ev = np.zeros(em, bool)
        ed[: len(es)] = e[es]
        ev[: len(es)] = True
        out["edges"].append(ed)
        out["edge_valid"].append(ev)

    return StagedShards(**{k: np.stack(v) for k, v in out.items()},
                        caps=caps, num_regions=R)


def _propagate(labels, la, lb, passing, sweeps: int, mesh: Mesh):
    """Min-label propagation whose scatter-min is collective: each sweep's
    partial scatter-min over this rank's edges is combined by ``all_reduce``
    MIN (the global scatter-min), then pointer-jumped. The labels are then
    the same on every rank, so every rank leaves the loop at the same sweep
    once one changes nothing (the result equals running all ``sweeps``)."""
    a, b = la.long(), lb.long()
    big = torch.iinfo(labels.dtype).max
    for _ in range(sweeps):
        cur = torch.minimum(labels[a], labels[b])
        upd = torch.where(passing, cur, torch.full_like(cur, big))
        new = labels.scatter_reduce(0, a, upd, reduce="amin")
        new = new.scatter_reduce(0, b, upd, reduce="amin")
        all_reduce_(new, mesh, dist.ReduceOp.MIN)
        new = torch.minimum(new, new[new.long()])
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    return labels


def _collective_merge_rounds(emb, pr, edges, evalid, threshold,
                             num_regions: int, max_rounds: int, sweeps: int,
                             mesh: Mesh):
    """``ops/labelprop.device_merge``'s round loop with its two reductions
    made collective, over this rank's points and edges.

    Exactness: per round, the cluster embeddings are the ``all_reduce`` SUM
    of every rank's partial segment sums and counts (the global segment
    sum); each edge is scored by exactly one rank against them; each
    sweep's scatter-min is global by ``all_reduce`` MIN. Every round
    therefore gives the single-device labels — monotone or not — up to the
    float32 summation ORDER of the SUM, which can flip a squared distance
    within rounding of ``threshold²``. The returned ``margin`` is the least
    |d² − threshold²| over every live edge of every round (``all_reduce``
    MIN), for ``_warn_knife_edge``.

    The ``changed`` flag is an int32 ``all_reduce`` SUM read on the host
    once a round; as in the JAX package, rounds stop when nothing changed
    or at ``max_rounds``, and only rounds that changed something count.
    Returns (labels (R,) int32, rounds, margin) on every rank.
    """
    dev = emb.device
    R = num_regions
    labels = torch.arange(R, dtype=torch.int32, device=dev)
    pr = pr.long()
    pr_real = pr < R  # padding points carry the R sentinel
    pr_idx = clamp_index(pr, R)
    ea, eb = clamp_index(edges[:, 0], R), clamp_index(edges[:, 1], R)
    evalid = evalid.bool()
    thr2 = torch.as_tensor(threshold, dtype=torch.float32, device=dev) ** 2
    # the sums and the counts travel in one buffer: a column of ones
    embx = torch.cat([emb.to(torch.float32),
                      torch.ones((emb.shape[0], 1), dtype=torch.float32,
                                 device=dev)], dim=1)
    margin = torch.full((1,), float("inf"), dtype=torch.float32, device=dev)
    rounds, changed = 0, True
    while changed and rounds < max_rounds:
        # padding points route to segment R, which pooling drops (a clamped
        # labels[pr] would pollute cluster R-1)
        pt_cluster = torch.where(pr_real, labels[pr_idx].long(), R)
        sums = torch.zeros((R + 1, embx.shape[1]), dtype=torch.float32,
                           device=dev).index_add_(0, pt_cluster, embx)[:R]
        all_reduce_(sums, mesh)
        cemb = sums[:, :-1] / torch.clamp(sums[:, -1], min=1.0)[:, None]
        la, lb = labels[ea], labels[eb]
        d2 = torch.sum((cemb[la.long()] - cemb[lb.long()]) ** 2, dim=-1)
        live = evalid & (la != lb)
        passing = live & (d2 < thr2)
        if live.numel():
            margin = torch.minimum(margin, torch.where(
                live, torch.abs(d2 - thr2),
                torch.full_like(d2, float("inf"))).min().reshape(1))
        labels = _propagate(labels, la, lb, passing, sweeps, mesh)
        flag = torch.any(passing).to(torch.int32).reshape(1)
        all_reduce_(flag, mesh)
        changed = int(flag.item()) > 0
        rounds += int(changed)
    all_reduce_(margin, mesh, dist.ReduceOp.MIN)
    return labels, rounds, float(margin.item())


def distributed_merge(point_embeddings, point_region, num_regions: int,
                      edges, mesh: Mesh, threshold: float,
                      max_rounds: int = 16, sweeps: int = 16,
                      axis: str = "data") -> tuple[np.ndarray, int]:
    """Collective merge over points and edges sharded across the mesh's
    data axis: every rank passes the whole arrays (numpy or tensors),
    padded here as the JAX package pads them, and works on its contiguous
    share of the rows.

    Returns (labels (R,) min-member ids, rounds) on every rank — the
    labels of ``ops/labelprop.device_merge`` (see
    ``_collective_merge_rounds``).
    """
    assert axis == "data", "the merge shards over the data axis"
    S = mesh.shape[axis]
    R = num_regions
    dev = mesh.device
    emb = torch.as_tensor(point_embeddings).to(dev, torch.float32)
    pr = torch.as_tensor(np.asarray(point_region, np.int32)).to(dev)
    p_pad = (-emb.shape[0]) % S
    if p_pad:
        emb = torch.cat([emb, emb.new_zeros((p_pad, emb.shape[1]))])
        pr = torch.cat([pr, pr.new_full((p_pad,), R)])
    e = np.asarray(edges, np.int32).reshape(-1, 2)
    ev = np.ones(len(e), bool)
    e_pad = (-len(e)) % S if len(e) else S
    if e_pad:
        e = np.concatenate([e, np.zeros((e_pad, 2), np.int32)])
        ev = np.concatenate([ev, np.zeros(e_pad, bool)])
    pts, eds = shard_rows(len(pr), mesh), shard_rows(len(e), mesh)
    labels, rounds, margin = _collective_merge_rounds(
        emb[pts], pr[pts], torch.from_numpy(e[eds]).to(dev),
        torch.from_numpy(ev[eds]).to(dev), threshold, R, max_rounds,
        sweeps, mesh)
    _warn_knife_edge(margin, threshold)
    return labels.cpu().numpy(), rounds


def _embed_strip(extractor, staged: StagedShards, s: int, cfg: DataConfig,
                 channels: int) -> torch.Tensor:
    """Embeddings (n, D) float32 of strip ``s``'s n real points, from its own
    tile: its points are checked once on the host against the strip tile
    (tile-local x), so the patch stage runs with ``trusted_origins``. A
    ``w8a8-static`` model without scales is calibrated by rank 0 on the
    first chunk of its strip's rows, and the scales broadcast to every
    rank (the JAX package calibrates on shard 0)."""
    dev = extractor.device
    R = staged.num_regions
    tile = torch.from_numpy(staged.tiles[s]).to(dev)
    pad = scene_pad(staged.caps, channels)
    h, w = (k - 2 * pad for k in staged.tiles.shape[1:3])
    trusted = points_inside(staged.centers[s], h, w)
    n = int((staged.point_region[s] < R).sum())  # real rows come first
    bs = extractor.batch_size

    def inputs(rows):
        return extractor._point_inputs(
            staged.centers[s][rows], staged.inner[s][rows],
            staged.object_[s][rows], staged.features[s][rows], cfg)

    common = (tile, staged.caps, cfg.quantize_uint8, trusted)
    if extractor.needs_calibration:
        first = np.arange(min(bs, staged.centers.shape[1]))
        extractor._maybe_calibrate(*common, *inputs(first))
    chunks = [extractor._embed_local(*common, *inputs(rows))
              for rows in np.array_split(np.arange(n), max(-(-n // bs), 1))
              if len(rows)]
    if not chunks:
        return torch.zeros((0, extractor.model.cfg.out_dim),
                           dtype=torch.float32, device=dev)
    return torch.cat(chunks).to(torch.float32)


def extract_and_merge_sharded(model, scene: Scene, cfg: DataConfig,
                              mesh: Mesh, threshold: float = 1.0,
                              max_rounds: int = 16, sweeps: int = 16,
                              axis: str = "data",
                              extractor=None) -> MergeResult:
    """Memory-distributed extract + merge over the mesh's data axis.

    Every rank stages the strips on the host (``stage_scene_shards``),
    uploads only its own strip's tile, embeds only its own points through
    the extractor's kernels (K1's patch stage, then the model's blocks),
    and joins the collective merge rounds (``_collective_merge_rounds``).
    The only scene-size arrays a rank holds on its device are the (R, D)
    cluster-embedding table and the (R,) labels. ``model`` is a port
    ``S2Former`` (its v4/v5 BatchNorm buffers ride along, replicated) or
    None with ``extractor``, a mesh ``FeatureExtractor`` to reuse. Every
    rank returns the same ``MergeResult``.
    """
    from deepmerge_tpu_torch.infer.extract import FeatureExtractor

    assert axis == "data", "the scene shards over the data axis"
    if extractor is None:
        extractor = FeatureExtractor(model, batch_size=cfg.eval_batch_size,
                                     mesh=mesh)
    staged = stage_scene_shards(scene, cfg, mesh.shape[axis])
    s = mesh.coords[axis]
    emb = _embed_strip(extractor, staged, s, cfg, scene.image.shape[-1])
    n = emb.shape[0]
    dev = extractor.device
    labels, rounds, margin = _collective_merge_rounds(
        emb, torch.from_numpy(staged.point_region[s][:n]).to(dev),
        torch.from_numpy(staged.edges[s]).to(dev),
        torch.from_numpy(staged.edge_valid[s]).to(dev),
        threshold, staged.num_regions, max_rounds, sweeps, mesh)
    _warn_knife_edge(margin, threshold)
    uniq, dense = np.unique(labels.cpu().numpy(), return_inverse=True)
    return MergeResult(
        region_to_cluster=dense.astype(np.int32), num_clusters=len(uniq),
        rounds=rounds, edges_scored=rounds * int(staged.edge_valid.sum()))


def _warn_knife_edge(margin: float, threshold: float,
                     rel_eps: float = 1e-5) -> None:
    """Warn when a merge decision sat within float rounding of threshold².

    The collective SUM adds in another order than one device does, so only
    edges with |d² − thr²| comfortably above float32 rounding are certain
    to decide alike on both paths. ``margin`` is the measured minimum over
    all rounds (``_collective_merge_rounds``).
    """
    thr2 = float(threshold) ** 2
    if np.isfinite(margin) and margin < rel_eps * max(thr2, 1e-30):
        warnings.warn(
            f"distributed merge: an edge decision sat {margin:.3e} from "
            f"threshold²={thr2:.6g} — within f32 reordering noise, so the "
            "partition may differ from the single-device path at this "
            "knife edge",
            stacklevel=3,
        )
