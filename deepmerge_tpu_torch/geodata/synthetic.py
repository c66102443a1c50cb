"""Synthetic scene generator.

Stands in for the shapefile/GeoTIFF inputs the reference assumes exist
(superpixel polygons are produced OUTSIDE the reference repo). Generates:
a Voronoi superpixel label map whose cells are grouped into coarser "ground
objects", a textured image where each object has a distinct spectral
signature, per-region designed features in the reference's attribute order
(``MyUtils1.py:79-114``), sample points with inner/object scale fields, and
the RAG edge list — everything the pipeline and its tests need with zero
geodata dependencies.
"""

from __future__ import annotations

import numpy as np

from deepmerge_tpu_torch.geodata.types import EdgeList, RegionTable, Scene


def _voronoi_labels(h: int, w: int, sites: np.ndarray) -> np.ndarray:
    """Label each pixel with its nearest site (squared Euclidean)."""
    if len(sites) > 512:
        try:  # mosaic-scale scenes: KD-tree nearest-site queries
            from scipy.spatial import cKDTree

            ys, xs = np.mgrid[0:h, 0:w]
            pts = np.stack([ys.ravel(), xs.ravel()], 1).astype(np.float64)
            _, idx = cKDTree(sites).query(pts, workers=-1)
            return idx.reshape(h, w).astype(np.int32)
        except Exception:
            pass
    # brute-force fallback: chunk over BOTH pixel rows and sites in f32 to
    # bound peak memory (a single (H, W, S) f64 block was ~8.6 GB at mosaic
    # scale; f32 squared distances are exact for scenes up to ~2896px)
    sites32 = sites.astype(np.float32)
    xs = np.arange(w, dtype=np.float32)[None, :]
    best = np.zeros((h, w), np.int32)
    ROWS, SITES = 256, 64
    for r0 in range(0, h, ROWS):
        ys = np.arange(r0, min(r0 + ROWS, h), dtype=np.float32)[:, None]
        best_d = np.full((len(ys), w), np.inf, np.float32)
        brow = best[r0 : r0 + len(ys)]
        for start in range(0, len(sites32), SITES):
            chunk = sites32[start : start + SITES]
            d = (ys[..., None] - chunk[None, None, :, 0]) ** 2 + (
                xs[..., None] - chunk[None, None, :, 1]
            ) ** 2
            idx = d.argmin(-1)
            dmin = np.take_along_axis(d, idx[..., None], -1)[..., 0]
            take = dmin < best_d
            brow[take] = (idx + start)[take].astype(np.int32)
            best_d = np.minimum(best_d, dmin)
    return best


def _region_features(image: np.ndarray, labels: np.ndarray, n: int):
    """Per-region designed features (15, reference attribute order)."""
    h, w, c = image.shape
    flat = labels.ravel()
    area = np.bincount(flat, minlength=n).astype(np.float64)
    area = np.maximum(area, 1.0)

    # boundary pixels: label != any 4-neighbor
    boundary = np.zeros_like(labels, bool)
    boundary[:-1] |= labels[:-1] != labels[1:]
    boundary[1:] |= labels[1:] != labels[:-1]
    boundary[:, :-1] |= labels[:, :-1] != labels[:, 1:]
    boundary[:, 1:] |= labels[:, 1:] != labels[:, :-1]
    peri = np.bincount(flat[boundary.ravel()], minlength=n).astype(np.float64)
    peri = np.maximum(peri, 1.0)

    ys, xs = np.mgrid[0:h, 0:w]
    ys, xs = ys.ravel(), xs.ravel()
    y_min = np.full(n, np.inf); np.minimum.at(y_min, flat, ys)
    y_max = np.full(n, -np.inf); np.maximum.at(y_max, flat, ys)
    x_min = np.full(n, np.inf); np.minimum.at(x_min, flat, xs)
    x_max = np.full(n, -np.inf); np.maximum.at(x_max, flat, xs)
    bb_h = np.maximum(y_max - y_min + 1, 1)
    bb_w = np.maximum(x_max - x_min + 1, 1)
    length = np.maximum(bb_h, bb_w)
    width = np.minimum(bb_h, bb_w)

    means, stds = [], []
    for band in range(min(c, 3)):
        v = image[..., band].ravel().astype(np.float64)
        s1 = np.bincount(flat, weights=v, minlength=n)
        s2 = np.bincount(flat, weights=v * v, minlength=n)
        m = s1 / area
        var = np.maximum(s2 / area - m * m, 0.0)
        means.append(m)
        stds.append(np.sqrt(var))
    while len(means) < 3:
        means.append(means[-1]); stds.append(stds[-1])

    smooth = peri / (4.0 * np.sqrt(area))            # smoothness index
    shapeness = length / width                        # elongation
    compact = peri / np.sqrt(area)                    # compactness
    bright = (means[0] + means[1] + means[2]) / 3.0
    border = peri / (2.0 * (bb_h + bb_w))             # border index

    feats = np.stack(
        [area, peri, length, width, smooth,
         stds[0], stds[1], stds[2], means[0], means[1], means[2],
         shapeness, compact, bright, border],
        axis=1,
    ).astype(np.float32)
    return feats, (y_min, y_max, x_min, x_max), area


def _rag_edges(labels: np.ndarray) -> np.ndarray:
    """Unique adjacent label pairs from 4-connectivity."""
    a = labels[:, :-1].ravel(); b = labels[:, 1:].ravel()
    c = labels[:-1].ravel(); d = labels[1:].ravel()
    lo = np.concatenate([np.minimum(a, b), np.minimum(c, d)])
    hi = np.concatenate([np.maximum(a, b), np.maximum(c, d)])
    keep = lo != hi
    pairs = np.unique(np.stack([lo[keep], hi[keep]], 1), axis=0)
    return pairs.astype(np.int32)


def generate_scene(
    h: int = 512,
    w: int = 512,
    n_regions: int = 200,
    n_objects: int = 24,
    channels: int = 3,
    points_per_region: int = 3,
    noise: float = 8.0,
    seed: int = 0,
    name: str = "synthetic",
) -> Scene:
    """Generate a synthetic Scene with ground-truth object grouping.

    NB duplicate random sites (birthday-collision odds grow with
    ``n_regions``/area) produce regions with ZERO pixels and no sample
    points: they keep clamped placeholder features and survive merging as
    singleton labels — the same shape real over-segmentation outputs take
    when a vectorizer emits degenerate polygons. Kept as-is (rather than
    resampling) so scenes are bit-stable per seed across rounds.
    """
    rng = np.random.RandomState(seed)
    sites = np.stack(
        [rng.randint(0, h, n_regions), rng.randint(0, w, n_regions)], 1
    ).astype(np.float64)
    labels = _voronoi_labels(h, w, sites)

    obj_sites = np.stack(
        [rng.randint(0, h, n_objects), rng.randint(0, w, n_objects)], 1
    ).astype(np.float64)
    d = ((sites[:, None, :] - obj_sites[None, :, :]) ** 2).sum(-1)
    object_of_region = d.argmin(1).astype(np.int32)

    # image: per-object color + smooth gradient + noise
    colors = rng.randint(30, 226, (n_objects, channels)).astype(np.float64)
    img = colors[object_of_region][labels]  # (H, W, C)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = (10.0 * yy / h + 10.0 * xx / w)[..., None]
    img = img + grad + rng.randn(h, w, channels) * noise
    image = np.clip(img, 0, 255).astype(np.uint8)

    feats, bbox, area = _region_features(image, labels, n_regions)

    # inner/object adaptive-scale fields: derived from region extent, like the
    # (external) scale-estimation tool the reference assumes ran upstream.
    y_min, y_max, x_min, x_max = bbox
    extent = np.maximum(y_max - y_min, x_max - x_min) + 1
    extent = np.where(np.isfinite(extent), extent, 8.0)  # empty regions
    inner = np.clip(np.sqrt(area).astype(np.int32), 4, 160)
    object_scale = np.clip(extent.astype(np.int32), inner + 2, 224)

    # sample points: random pixels of each region (its Voronoi site is
    # guaranteed interior; jitter extra points around it, clamped in-region)
    pts, owner = [], []
    flat = labels.ravel()
    order = np.argsort(flat, kind="stable")
    region_starts = np.searchsorted(flat[order], np.arange(n_regions))
    region_ends = np.searchsorted(flat[order], np.arange(n_regions) + 1)
    for r in range(n_regions):
        idx = order[region_starts[r] : region_ends[r]]
        if len(idx) == 0:
            continue
        take = rng.choice(idx, size=min(points_per_region, len(idx)), replace=False)
        for t in take:
            pts.append((t // w, t % w))
            owner.append(r)
    points_yx = np.asarray(pts, np.int32)
    point_region = np.asarray(owner, np.int32)

    regions = RegionTable(
        features=feats,
        inner=inner.astype(np.int32),
        object_=object_scale.astype(np.int32),
        points_yx=points_yx,
        point_region=point_region,
    )
    rag = EdgeList(edges=_rag_edges(labels))
    return Scene(
        image=image, labels=labels, regions=regions, rag=rag,
        object_of_region=object_of_region, name=name,
        meta={"seed": seed, "n_objects": n_objects},
    )


def make_training_pairs(scene: Scene):
    """Positive/negative region-id pairs from RAG adjacency + ground truth.

    Mirrors the reference's pair txt files (one line per polygon pair,
    ``GenerateTrainPairData.py``): positives are adjacent regions of the same
    ground object, negatives adjacent regions of different objects.
    """
    obj = scene.object_of_region
    assert obj is not None, "scene lacks ground-truth objects"
    e = scene.rag.edges
    same = obj[e[:, 0]] == obj[e[:, 1]]
    return e[same], e[~same]
